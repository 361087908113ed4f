"""The plain reference against EMBOSS's strings and against the program.

The EMBOSS-derived cases of ``tests/data/parity_cases.json`` (DNA and
protein, all three modes) must come out letter for letter; seeded random
pairs must give what the program's CPU path (its kernels' plain
versions) gives, field for field; and the reference in bfloat16, the
control, must not.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

from swbench import check, harness
from swbench.references import gotoh

from conftest import ROOT

CASES = os.path.join(ROOT, "tests", "data", "parity_cases.json")
CONFIGS = os.path.join(ROOT, "swbench", "configs")


def config(name):
    with open(os.path.join(CONFIGS, f"{name}.json")) as f:
        return json.load(f)


def case_config(case):
    if case["matrix"] == "mat_5_-4":
        letters = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
        rows = np.full((26, 26), -4.0)
        np.fill_diagonal(rows, 5.0)
    else:
        mat = config("emboss_water_protein")["matrix"]
        letters, rows = mat["letters"], np.asarray(mat["rows"], float)
        if case["matrix"] == "blosum62_x10":
            rows = rows * 10.0
    return {"matrix": {"letters": letters, "rows": rows},
            "gap_open": case["gap_open"], "gap_extend": case["gap_extend"],
            "mode": case["mode"]}


def core(r):
    """The aligned core of a result printed with every letter retained."""
    a1, a2, _, s1, e1, s2, e2 = r
    if s1 < 0:
        return "", ""
    lo = s1 + s2
    hi = lo + check_steps(r)
    return a1[lo:hi], a2[lo:hi]


def check_steps(r):
    from swbench import roofline

    a1, a2, _, s1, e1, s2, e2 = r
    n = len(a1.replace("-", ""))
    m = len(a2.replace("-", ""))
    return roofline.path_steps(a1, n, m, s1, e1, s2, e2)


def all_cases():
    with open(CASES) as f:
        data = json.load(f)
    return [(g, k, c) for g, cs in data.items() for k, c in enumerate(cs)]


@pytest.mark.parametrize("group,k,case", all_cases(),
                         ids=[f"{g}{k}" for g, k, _ in all_cases()])
def test_reference_matches_emboss_cases(group, k, case):
    # the position-specific case's scores are BLOSUM62's at every position
    r = gotoh.align([(case["seq1"], case["seq2"])], case_config(case))[0]
    if case["score"] is not None:
        assert r[2] == case["score"]
    if case["aligned1"] is not None:
        got = r[:2] if case.get("retain_all", True) else core(r)
        assert got == (case["aligned1"], case["aligned2"])


def record(r):
    return harness.load_module("entries", "batch_aligner").Entry.record(r)


def random_pairs(seed, letters, count=24, lmax=120):
    rng = np.random.default_rng(seed)
    alpha = np.array(list(letters))
    out = []
    for k in range(count):
        a = "".join(rng.choice(alpha, int(rng.integers(1, lmax))))
        b = "".join(rng.choice(alpha, int(rng.integers(1, lmax))))
        if k % 2 and len(a) > 20:  # a shared stretch, so paths are long
            b = b[:7] + a[5:len(a) - 5] + b[7:12]
        out.append((a, b))
    return out


@pytest.mark.parametrize("mode", ["local", "glocal", "global"])
def test_reference_matches_program_cpu(mode):
    import smithwaterman_tpu_torch as swt

    cfg = dict(config("emboss_water_protein"), mode=mode)
    pairs = random_pairs(7, "ARNDCQEGHILKMFPSTWYV")
    want = gotoh.align(pairs, cfg)
    eng = swt.BatchAligner(mode={"local": swt.LOCAL, "glocal": swt.GLOCAL,
                                 "global": swt.GLOBAL}[mode], device="cpu")
    got = [record(r) for r in eng.align_pairs(pairs)]
    assert got == want


def test_reference_matches_program_cpu_dna():
    import smithwaterman_tpu_torch as swt

    cfg = config("emboss_needle_dna")
    pairs = random_pairs(8, "ACGT", count=12, lmax=300)
    want = gotoh.align(pairs, cfg)
    eng = swt.BatchAligner(
        scoring_matrix=swt.SubstitutionMatrix.match_mismatch(5.0, -4.0),
        mode=swt.GLOCAL, device="cpu")
    assert [record(r) for r in eng.align_pairs(pairs)] == want


def test_reference_groups_and_tiles_agree():
    """A pointer budget that cuts the pairs into groups of one, and tiles
    of the walk smaller than a pair, change nothing."""
    cfg = config("emboss_needle_dna")
    pairs = random_pairs(9, "ACGT", count=6, lmax=200)
    whole = gotoh.align(pairs, cfg)
    tile = gotoh.TILE
    try:
        gotoh.TILE = 16
        assert gotoh.align(pairs, cfg, budget=1) == whole
    finally:
        gotoh.TILE = tile


@pytest.mark.parametrize("mode", ["local", "glocal"])
def test_control_in_bfloat16_differs(mode):
    cfg = dict(config("emboss_water_protein"), mode=mode)
    pairs = random_pairs(10, "ARNDCQEGHILKMFPSTWYV", count=12, lmax=400)
    want = gotoh.align(pairs, cfg)
    got = gotoh.align(pairs, cfg, dtype=torch.bfloat16)
    layers = functools.partial(gotoh.layers, cfg)
    assert sum(bool(check.mismatched(layers, g, w))
               for g, w in zip(got, want)) > 0


@pytest.mark.parametrize("mode,fill,walk", [
    ("local", (7.0, 4, 5), (1, 2)),
    ("glocal", (7.0,), (1, 2, 4, 5)),
])
def test_layers_split_a_result(mode, fill, walk):
    r = ("AC-GT", "ACAGT", 7.0, 1, 4, 2, 5)
    assert gotoh.layers({"mode": mode}, r) == {
        "fill": fill, "walk": walk, "rebuild": ("AC-GT", "ACAGT")}
    other = ("AC-GT", "ACAGT", 7.0, 0, 4, 2, 5)  # another start
    assert check.mismatched(functools.partial(gotoh.layers, {"mode": mode}),
                            other, r) == ["walk"]


def test_a_reference_of_scores_alone_compares_the_score():
    """The reference decides what is compared: one that gives the fill
    alone ignores every other field, and a result that lacks a layer the
    reference gives differs there."""
    def scores(r):
        return {"fill": (r[0],)}

    assert check.mismatched(scores, (5.0, "x"), (5.0, "y")) == []
    assert check.mismatched(scores, (4.0,), (5.0,)) == ["fill"]
    assert check.mismatched(lambda r: {} if r == "none" else scores(r),
                            "none", (5.0,)) == ["fill"]

