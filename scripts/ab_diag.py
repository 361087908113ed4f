#!/usr/bin/env python3
"""Time the wavefront score fill K9 of one or more source trees on one card.

Usage, on a machine with an NVIDIA card::

    python3 scripts/ab_diag.py TREE [TREE ...]

Each TREE is a checkout of this repository (for an A/B, a ``git archive``
export of the parent commit and one of the change, given in turns: parent,
change, change, parent).  Each runs in a fresh process that builds that
tree's kernels and prints one JSON line, on ``chip_smoke.py`` phase 12's
inputs (BLOSUM62, go = 10, ge = 0.5, LOCAL):

* 12b, the main path's 3200 protein pairs through
  ``BatchAligner(diag_scores=True).score_pairs``: its warm wall, and the
  chunks it hands ``diag_dp.fill_diag`` (25 chunks, one launch);
* 12c, the first chunk of the 400-protein self-sweep (8192 pairs) that
  ``sweep.score_matrix`` hands the same route;
* n32, n64, n128: narrow flushes of the same route, 3200 peptide pairs
  each (seed 12), each side's length uniform in 8..32, 8..64 and 65..128,
  so every chunk is 32, 64 and 128 columns wide (n32 on a bucket ladder
  that starts at 32, the others on the default one).

At each: K9 through ``fill_diag`` (mean of 5 calls after one to warm up:
the launch with its host layout and copies of the codes) at the tree's
own columns a lane; the launch alone (``kernels.diag_fill`` on inputs
already on the card, mean of 10), at the tree's R and, where the tree
has ``diag_dp.lane_cols``, at every R of ``diag_dp.LANE_COLS``; K1's
score-only fill through ``fill_many`` (mean of 3) and its launch alone
(``fill_dp.launch`` on a device plan, mean of 10); a digest of the best
scores, equal across trees and R, and equal to K1's.  Times are CUDA
events, walls host clocks around a synchronised call; the card's name and
power limit come first.
"""

import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time


class _Captured(Exception):
    pass


def inputs(tree: str):
    """Phase 12's inputs and the narrow flushes on the card from TREE: (cs,
    diag_dp, fill_dp, tab, {"12b": chunks, "12c": chunks, "n32": ...}, the
    12b wall in s, 12b's launches)."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import chip_smoke as cs
    from smithwaterman_tpu_torch import LOCAL, BatchAligner
    from smithwaterman_tpu_torch.config import DEFAULT_BUCKETS, AlignConfig
    from smithwaterman_tpu_torch import sweep as swp
    from smithwaterman_tpu_torch.io.fasta import SeqData
    from smithwaterman_tpu_torch.matrices import SubstitutionMatrix
    from smithwaterman_tpu_torch.ops import diag_dp, fill_dp, kernels

    if not diag_dp.__file__.startswith(tree):
        raise SystemExit(f"imported {diag_dp.__file__}, not {tree}")
    kernels.build()
    kernels.lib()
    dev = torch.device("cuda:0")
    tab = torch.from_numpy(np.asarray(SubstitutionMatrix.blosum62().table,
                                      np.float32)).to(dev)
    real = diag_dp.fill_diag
    seen = []

    def record(table, chunks, **kw):
        seen.append(list(chunks))
        return real(table, chunks, **kw)

    pairs = cs.main_path_pairs()
    eng = BatchAligner(mode=LOCAL, device="cuda", diag_scores=True)
    diag_dp.fill_diag = record
    eng.score_pairs(pairs)                       # cold
    diag_dp.fill_diag = real
    shapes = {"12b": [ch for chunks in seen for ch in chunks]}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.score_pairs(pairs)
    wall = time.perf_counter() - t0

    def first(table, chunks, **kw):
        shapes["12c"] = list(chunks)
        raise _Captured

    rng = np.random.default_rng(cs.SEED + 12)
    letters = np.array(list(cs.LETTERS))
    seqs = [SeqData(f"p{k}", "", "".join(rng.choice(
        letters, int(rng.integers(cs.LMIN, cs.LMAX + 1)))))
        for k in range(cs.SWEEP_SEQS)]
    diag_dp.fill_diag = first
    try:
        with tempfile.TemporaryDirectory() as tmp:
            swp.score_matrix(seqs, None, eng, os.path.join(tmp, "s.jsonl"),
                             swp.SweepConfig(chunk_pairs=cs.SWEEP_CHUNK))
    except _Captured:
        pass
    finally:
        diag_dp.fill_diag = real
    launches = len(seen)
    rng = np.random.default_rng(12)
    for name, lo, hi in (("n32", 8, 32), ("n64", 8, 64), ("n128", 65, 128)):
        def pep(k):
            return SeqData(k, "", "".join(rng.choice(
                letters, int(rng.integers(lo, hi + 1)))))

        narrow = [(pep(f"a{i}"), pep(f"b{i}")) for i in range(cs.PAIRS)]
        cfg = AlignConfig(mode=LOCAL, buckets=(32,) + DEFAULT_BUCKETS
                          if hi <= 32 else DEFAULT_BUCKETS)
        seen.clear()
        diag_dp.fill_diag = record
        try:
            BatchAligner(config=cfg, device="cuda",
                         diag_scores=True).score_pairs(narrow)
        finally:
            diag_dp.fill_diag = real
        shapes[name] = [ch for chunks in seen for ch in chunks]
    return cs, diag_dp, fill_dp, tab, shapes, wall, launches


def launch_alone(diag_dp, kernels, tab, chunks, R, reps=10):
    """K9's launch alone on the chunks' inputs, staged on the card: mean
    ms of ``reps`` launches after one, and the stats."""
    import inspect

    import numpy as np
    import torch

    import chip_smoke as cs

    dev = tab.device
    desc, floats = diag_dp.layout(chunks)
    desc = torch.from_numpy(desc).to(dev)
    c1, c2 = (torch.from_numpy(np.concatenate(
        [getattr(ch, f).ravel() for ch in chunks])).to(dev)
        for f in ("codes1", "codes2"))
    scratch = torch.empty(max(floats, 1), dtype=torch.float32, device=dev)
    stats = torch.empty((desc.shape[0], 8), dtype=torch.float32, device=dev)
    kw = dict(og=-10.0, eg=-0.5)
    if "R" in inspect.signature(kernels.diag_fill).parameters:
        kw["R"] = R
    run = lambda: kernels.diag_fill(  # noqa: E731
        tab, c1, c2, desc, scratch, stats, **kw)
    run()
    ms, _ = cs.timed(run, reps)
    return ms, stats


def k1_alone(fill_dp, tab, chunks, reps=10):
    """K1's score-only launch alone (a device plan and inputs staged on
    the card): mean ms of ``reps`` launches after one, and the stats."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from smithwaterman_tpu_torch import LOCAL

    dev = tab.device
    desc, _, _, carry_floats = fill_dp.layout(chunks)
    desc = torch.from_numpy(desc).to(dev)
    c1, c2 = (torch.from_numpy(np.concatenate(
        [getattr(ch, f).ravel() for ch in chunks])).to(dev)
        for f in ("codes1", "codes2"))
    carry = torch.empty(max(carry_floats, 1), dtype=torch.float32,
                        device=dev)
    stats = torch.empty((desc.shape[0], 8), dtype=torch.float32, device=dev)
    plan = fill_dp.device_plan(chunks, 0, dev)
    run = lambda: fill_dp.launch(  # noqa: E731
        plan, tab, c1, c2, desc, None, carry, stats, traceback=False,
        mode=LOCAL, og=-10.0, eg=-0.5)
    run()
    ms, _ = cs.timed(run, reps)
    return ms, stats


def digest(stats) -> str:
    return hashlib.sha256(stats.cpu().numpy().tobytes()).hexdigest()


def one(tree: str) -> dict:
    import torch

    cs, diag_dp, fill_dp, tab, shapes, wall, launches = inputs(tree)
    from smithwaterman_tpu_torch import LOCAL
    from smithwaterman_tpu_torch.ops import kernels

    kw = dict(og=-10.0, eg=-0.5)
    out = {"tree": tree, "wall_12b_s": wall, "launches_12b": launches}
    for name, chunks in shapes.items():
        out[f"{name}_pairs"] = sum(ch.shape[0] for ch in chunks)
        out[f"{name}_chunks"] = len(chunks)
        out[f"{name}_MP"] = sorted({ch.shape[2] for ch in chunks})
        run = lambda: diag_dp.fill_diag(tab, chunks, **kw)  # noqa: E731
        run()
        out[f"k9_{name}_ms"], got = cs.timed(run, 5)
        out[f"k9_{name}_digest"] = digest(got)
        R0 = diag_dp.SHAPE["R"] if hasattr(diag_dp, "SHAPE") else 1
        out[f"k9_{name}_R"] = R0
        out[f"k9_{name}_launch_ms"], st = launch_alone(diag_dp, kernels,
                                                       tab, chunks, R0)
        if not torch.equal(st, got):
            raise SystemExit(f"K9's launch alone differs at {name}")
        for R in getattr(diag_dp, "LANE_COLS", ()):
            ms, st = launch_alone(diag_dp, kernels, tab, chunks, R)
            if not torch.equal(st, got):
                raise SystemExit(f"K9 at R={R} differs at {name}")
            out[f"k9_{name}_R{R}_launch_ms"] = ms
        k1 = lambda: fill_dp.fill_many(  # noqa: E731
            tab, chunks, mode=LOCAL, score_only=True, **kw)
        k1()
        out[f"k1so_{name}_ms"], filled = cs.timed(k1, 3)
        if not torch.equal(filled.stats, got):
            raise SystemExit(f"K9 differs from K1's score-only fill at {name}")
        out[f"k1so_{name}_launch_ms"], st = k1_alone(fill_dp, tab, chunks)
        if not torch.equal(st, got):
            raise SystemExit(f"K1's launch alone differs at {name}")
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(one(os.path.abspath(sys.argv[2]))), flush=True)
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], stdout=subprocess.PIPE,
                         text=True, check=True).stdout.strip(), flush=True)
    rc = 0
    for tree in sys.argv[1:]:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", tree]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
