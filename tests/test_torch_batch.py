"""The port's main path on the CPU against the JAX package's.

``BatchAligner(device="cpu")`` runs the port's pipeline with the kernels'
plain PyTorch versions; it is held against the JAX
``BatchAligner(backend="scan")`` and the JAX ``Aligner`` on the same seeded
inputs, and against the EMBOSS-derived cases in tests/data/parity_cases.json.
Tolerance: exact equality of strings, scores and spans.
"""

import json
import os

import numpy as np
import pytest

import smithwaterman_tpu as jswt
from smithwaterman_tpu_torch import (GLOBAL, GLOCAL, LOCAL, Aligner,
                                     BatchAligner, PositionSpecificMatrix,
                                     SubstitutionMatrix)
from smithwaterman_tpu_torch.config import AlignConfig
from smithwaterman_tpu_torch.utils.metrics import StatsCollector

DATA = os.path.join(os.path.dirname(__file__), "data", "parity_cases.json")
with open(DATA) as f:
    CASES = json.load(f)
MODES = {"local": LOCAL, "glocal": GLOCAL, "global": GLOBAL}
LETTERS = np.array(list("ARNDCQEGHILKMFPSTWYV"))


def _pairs(seed, count=20, lmax=110):
    rng = np.random.default_rng(seed)
    out = []
    for k in range(count):
        a = "".join(rng.choice(LETTERS, int(rng.integers(1, lmax))))
        b = "".join(rng.choice(LETTERS, int(rng.integers(1, lmax))))
        if k % 3 == 0 and len(a) > 20:  # a shared motif
            cut = int(rng.integers(0, len(a) - 15))
            b = b[:10] + a[cut:cut + 15] + b[10:]
        out.append((a, b))
    out += [("", "ACDEF"), ("W", ""), ("W", "W"), ("KKKK", "LLLL"),
            ("ACDJU", "ACDXX")]
    return out


def _key(r):
    return (r.aligned1, r.aligned2, r.score, r.start1, r.end1, r.start2,
            r.end2)


@pytest.mark.parametrize("retain_all", [True, False])
@pytest.mark.parametrize("mode", [LOCAL, GLOCAL, GLOBAL])
def test_batch_matches_jax_scan(mode, retain_all):
    pairs = _pairs(100 + mode)
    ours = BatchAligner(mode=mode, device="cpu").align_pairs(pairs,
                                                            retain_all)
    theirs = jswt.BatchAligner(mode=mode, backend="scan").align_pairs(
        pairs, retain_all)
    assert [_key(r) for r in ours] == [_key(r) for r in theirs]


@pytest.mark.parametrize("mode", [LOCAL, GLOCAL, GLOBAL])
def test_score_pairs_matches_jax(mode):
    pairs = _pairs(200 + mode)
    ours = BatchAligner(mode=mode, device="cpu").score_pairs(pairs)
    theirs = jswt.BatchAligner(mode=mode, backend="scan").score_pairs(pairs)
    assert ours.dtype == np.float32
    np.testing.assert_array_equal(ours, theirs)


def test_shuffled_input_order():
    pairs = _pairs(7)
    ba = BatchAligner(mode=GLOCAL, device="cpu")
    base = ba.align_pairs(pairs)
    perm = np.random.default_rng(1).permutation(len(pairs))
    got = ba.align_pairs([pairs[k] for k in perm])
    assert [_key(r) for r in got] == [_key(base[k]) for k in perm]


@pytest.mark.parametrize("mode", [LOCAL, GLOBAL])
def test_empty_sequences_match_jax(mode):
    pairs = [("", ""), ("", "ACD"), ("KLM", ""), ("A", "A")]
    for retain in (True, False):
        ours = BatchAligner(mode=mode, device="cpu").align_pairs(pairs,
                                                                retain)
        theirs = jswt.BatchAligner(mode=mode, backend="scan").align_pairs(
            pairs, retain)
        assert [_key(r) for r in ours] == [_key(r) for r in theirs]


@pytest.mark.parametrize("group", ["dna", "protein", "gap_sensitivity",
                                   "scaled_local"])
def test_parity_cases(group):
    """The EMBOSS-derived expectations, through Aligner and BatchAligner."""
    for case in CASES[group]:
        if case["matrix"] == "mat_5_-4":
            sm = SubstitutionMatrix.match_mismatch(5.0, -4.0)
        else:
            sm = SubstitutionMatrix.blosum62()
            if case["matrix"] == "blosum62_x10":
                sm.table = sm.table * 10.0
        cfg = AlignConfig(mode=MODES[case["mode"]],
                          gap_open=case["gap_open"],
                          gap_extend=case["gap_extend"])
        retain = case.get("retain_all", True)
        single = Aligner(scoring_matrix=sm, config=cfg, device="cpu").align(
            case["seq1"], case["seq2"], retain)
        batch = BatchAligner(scoring_matrix=sm, config=cfg,
                             device="cpu").align_pairs(
            [(case["seq1"], case["seq2"])], retain)[0]
        for r in (single, batch):
            if case["score"] is not None:
                assert r.score == case["score"]
            if case["aligned1"] is not None:
                assert (r.aligned1, r.aligned2) == (case["aligned1"],
                                                    case["aligned2"])


def test_psm_case():
    case = CASES["psm"][0]
    sm = SubstitutionMatrix.blosum62()
    pm = PositionSpecificMatrix()
    s1, s2 = case["seq1"], case["seq2"]
    pm.prepare(s1, s2)
    pm.scores = sm.table[np.ix_(sm.seq_to_index(s1),
                                sm.seq_to_index(s2))].astype(np.float32)
    r = Aligner(scoring_matrix=pm, mode=GLOCAL, device="cpu").align(s1, s2)
    assert (r.score, r.aligned1, r.aligned2) == (
        case["score"], case["aligned1"], case["aligned2"])
    with pytest.raises(ValueError):
        BatchAligner(scoring_matrix=pm, device="cpu").align_pairs([(s1, s2)])


@pytest.mark.parametrize("mode", [LOCAL, GLOCAL, GLOBAL])
def test_aligner_matches_jax(mode):
    a = Aligner(mode=mode, device="cpu")
    j = jswt.Aligner(mode=mode)
    s1, s2 = "HEAGAWGHEEKLMNPQ", "PAWHEAEKLMQQ"
    for args in ((s1, s2, True), (s1, s2, False)):
        assert _key(a.align(*args)) == _key(j.align(*args))
    assert _key(a.align_partial(s1, s2, True, (9, 7))) == \
        _key(j.align_partial(s1, s2, True, (9, 7)))
    assert a.score(s1, s2) == j.score(s1, s2)
    fa = ">q d\nHEAGAW\nGHEE\n"
    assert _key(a.align_fasta(fa, ">t\nPAWHEAE\n")) == \
        _key(j.align_fasta(fa, ">t\nPAWHEAE\n"))


def test_perl_compat_matches_jax():
    pairs = [("heag1awghee", "PAW-HEAE"), ("ACDJUBZ", "acdxxo")]
    ours = BatchAligner(device="cpu", perl_compat=True).align_pairs(pairs)
    theirs = jswt.BatchAligner(backend="scan",
                               perl_compat=True).align_pairs(pairs)
    assert [_key(r) for r in ours] == [_key(r) for r in theirs]
    a = Aligner(device="cpu", perl_compat=True).align(*pairs[0])
    assert _key(a) == _key(ours[0])


def test_pointer_budget_chunks_flushes(monkeypatch):
    """A budget of a few pairs' pointers splits the batch into many
    flushes; a budget below one pair's pointers sends it down the
    long-sequence route; results must not change."""
    pairs = _pairs(11)
    base = BatchAligner(mode=GLOBAL, device="cpu").align_pairs(pairs)
    monkeypatch.setenv("SWTPU_TB_HBM_BYTES", str(3 * 128 * 128))
    got = BatchAligner(mode=GLOBAL, device="cpu").align_pairs(pairs)
    assert [_key(r) for r in got] == [_key(r) for r in base]
    monkeypatch.setenv("SWTPU_TB_HBM_BYTES", str(64 * 64 - 1))
    got = BatchAligner(mode=GLOBAL, device="cpu").align_pairs(pairs)
    assert [_key(r) for r in got] == [_key(r) for r in base]
    # score-only fills keep no pointers: no budget applies
    BatchAligner(mode=GLOBAL, device="cpu").score_pairs(pairs)


def test_default_device_is_the_card(monkeypatch, tmp_path):
    """Without a device the entry points run on the card, and raise
    without one instead of running on the CPU unasked."""
    import torch

    from smithwaterman_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (Aligner, BatchAligner):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            make()
    fa = tmp_path / "a.fas"
    fa.write_text(">a\nHEAGAWGHEE\n")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        cli.main([str(fa), str(fa)])
    assert Aligner(device="cpu").device.type == "cpu"
    assert BatchAligner(device="cpu").device.type == "cpu"


def test_stats_and_phases():
    ba = BatchAligner(mode=LOCAL, device="cpu")
    ba.stats = StatsCollector()
    pairs = _pairs(3, count=6)
    ba.align_pairs(pairs)
    s = ba.stats.summary()
    assert s["pairs"] == sum(1 for a, b in pairs if a and b)
    assert ba.stats.run_seconds > 0
    assert set(ba.phase) == {"call", "bucket", "encode", "table", "pack",
                             "plan", "flush", "dispatch", "fill", "walk",
                             "gather", "copy", "reconstruct"}
    assert set(s["spans"]) == set(ba.phase)
    assert s["counters"]["cells.true"] == sum(len(a) * len(b)
                                              for a, b in pairs)


def test_banded_not_ported():
    """Banded alignment, the last entry point the port once refused, runs
    (here on the CPU) and equals the full DP where the band covers it."""
    a = Aligner(device="cpu")
    r = a.align_banded("HEAGAWGHEE", "PAWHEAE", band=128)
    f = a.align("HEAGAWGHEE", "PAWHEAE")
    assert (r.aligned1, r.aligned2, r.score) == (f.aligned1, f.aligned2,
                                                 f.score)
