"""The port's all-vs-all sweep against the JAX package's.

The eight cases of tests/test_sweep.py run against
``smithwaterman_tpu_torch.sweep`` with ``BatchAligner(device="cpu")``
(results, resume after a crash, the score matrix, process sharding, the
stats report, the automatic bucket ladder), and the port's result files
and score matrices are held against the JAX package's, with and without
the wavefront route.

Tolerance: exact equality of every result row and matrix entry.
"""

import json

import numpy as np
import pytest

import smithwaterman_tpu as jswt
from smithwaterman_tpu import sweep as jsweep
from smithwaterman_tpu_torch import LOCAL, BatchAligner, SeqData
from smithwaterman_tpu_torch.sweep import (IncompleteSweepError, SweepConfig,
                                           load_sweep, score_matrix, sweep)

SEQS = [
    SeqData(f"s{i}", "", s)
    for i, s in enumerate(
        ["HEAGAWGHEE", "PAWHEAE", "HEAGAWGHEF", "WWWPPP", "AWHEA", "GGGGG"]
    )
]


def _engine(**kw):
    return BatchAligner(mode=LOCAL, device="cpu", **kw)


def test_self_sweep_and_matrix(tmp_path):
    out = str(tmp_path / "sweep.jsonl")
    cfg = SweepConfig(chunk_pairs=4, score_only=True)
    n = sweep(SEQS, None, _engine(), out, cfg)
    assert n == -(-len(SEQS) * (len(SEQS) - 1) // 2 // 4)
    mat = score_matrix(SEQS, None, _engine(), out, cfg)
    assert mat.shape == (6, 6)
    assert np.array_equal(mat, mat.T)
    assert mat[0, 1] == _engine().score_pairs([(SEQS[0], SEQS[1])])[0]


def test_resume_skips_done_chunks(tmp_path):
    out = str(tmp_path / "sweep.jsonl")
    cfg = SweepConfig(chunk_pairs=4, score_only=True)
    assert sweep(SEQS, None, _engine(), out, cfg) > 0
    assert sweep(SEQS, None, _engine(), out, cfg) == 0


def test_resume_after_torn_write(tmp_path):
    out = str(tmp_path / "sweep.jsonl")
    cfg = SweepConfig(chunk_pairs=4, score_only=True)
    sweep(SEQS, None, _engine(), out, cfg)
    whole = load_sweep(out)
    lines = open(out).read().splitlines()
    with open(out, "w") as f:  # a crash in the middle of the last write
        f.write("\n".join(lines[:-1]) + "\n" + lines[-1][: len(lines[-1]) // 2])
    assert sweep(SEQS, None, _engine(), out, cfg) == 1
    rows = load_sweep(out)
    assert len(rows) == len(SEQS) * (len(SEQS) - 1) // 2
    assert sorted(map(tuple, rows)) == sorted(map(tuple, whole))


def test_two_set_sweep_with_alignments(tmp_path):
    out = str(tmp_path / "ab.jsonl")
    cfg = SweepConfig(chunk_pairs=3, score_only=False)
    sweep(SEQS[:2], SEQS[2:4], _engine(), out, cfg)
    rows = load_sweep(out)
    assert len(rows) == 4
    assert all(len(r) == 5 for r in rows)
    jout = str(tmp_path / "jab.jsonl")
    jsweep.sweep(SEQS[:2], SEQS[2:4],
                 jswt.BatchAligner(mode=LOCAL, backend="scan"), jout, cfg)
    assert rows == jsweep.load_sweep(jout)


def test_score_matrix_rejects_partial_file(tmp_path):
    out = str(tmp_path / "partial.jsonl")
    cfg = SweepConfig(chunk_pairs=2, process_index=0, process_count=2)
    with pytest.raises(IncompleteSweepError):
        score_matrix(SEQS, None, _engine(), out, cfg)


def test_process_sharding(tmp_path):
    outs = []
    for pid in range(2):
        out = str(tmp_path / f"p{pid}.jsonl")
        cfg = SweepConfig(chunk_pairs=2, process_index=pid, process_count=2)
        sweep(SEQS, None, _engine(), out, cfg)
        outs.append(out)
    chunks0 = {json.loads(ln)["chunk"] for ln in open(outs[0])}
    chunks1 = {json.loads(ln)["chunk"] for ln in open(outs[1])}
    assert chunks0.isdisjoint(chunks1)
    total = len(load_sweep(outs[0])) + len(load_sweep(outs[1]))
    assert total == len(SEQS) * (len(SEQS) - 1) // 2


def test_sweep_stats_option(tmp_path, capsys):
    out = str(tmp_path / "sweep.jsonl")
    cfg = SweepConfig(chunk_pairs=4, score_only=False, stats=True)
    eng = _engine()
    sweep(SEQS, None, eng, out, cfg)
    rep = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert rep["pairs"] == 15
    assert rep["padding_waste"] >= 0.0
    assert eng.stats is not None


def _proteins(count, seed, lo=150, hi=400):
    rng = np.random.default_rng(seed)
    letters = list("ARNDCQEGHILKMFPSTWYV")
    return [SeqData(f"s{i}", "", "".join(rng.choice(
        letters, int(rng.integers(lo, hi))))) for i in range(count)]


def test_sweep_auto_ladder(tmp_path):
    seqs = _proteins(8, 5)
    e1 = _engine()
    sweep(seqs, None, e1, str(tmp_path / "a.jsonl"),
          SweepConfig(chunk_pairs=16, auto_ladder=True, auto_ladder_rungs=4))
    assert len(e1.config.buckets) <= 5
    assert max(len(s.seq) for s in seqs) <= e1.config.buckets[-1]
    sweep(seqs, None, _engine(), str(tmp_path / "b.jsonl"),
          SweepConfig(chunk_pairs=16))
    r1 = sorted(map(tuple, load_sweep(str(tmp_path / "a.jsonl"))))
    r2 = sorted(map(tuple, load_sweep(str(tmp_path / "b.jsonl"))))
    assert r1 == r2


@pytest.mark.parametrize("diag", [False, True])
def test_score_matrix_matches_jax(tmp_path, diag):
    """A self-sweep of 8 proteins, and its resume from half the file."""
    seqs = _proteins(8, 11, 20, 110)
    cfg = SweepConfig(chunk_pairs=7)
    out = str(tmp_path / "m.jsonl")
    mat = score_matrix(seqs, None, _engine(diag_scores=diag), out, cfg)
    want = jsweep.score_matrix(seqs, None,
                               jswt.BatchAligner(mode=LOCAL, backend="scan"),
                               str(tmp_path / "j.jsonl"), cfg)
    np.testing.assert_array_equal(mat, want)
    lines = open(out).read().splitlines()
    with open(out, "w") as f:
        f.write("\n".join(lines[: len(lines) // 2]) + "\n")
    assert sweep(seqs, None, _engine(diag_scores=diag), out, cfg) == \
        len(lines) - len(lines) // 2
    np.testing.assert_array_equal(
        score_matrix(seqs, None, _engine(diag_scores=diag), out, cfg), want)
