#!/usr/bin/env python3
"""Time the banded scores K6, the banded fill K7 and the banded walk K8 of
one or more source trees on one card.

Usage, on a machine with an NVIDIA card::

    python3 scripts/ab_banded.py TREE [TREE ...]

Each TREE is a checkout of this repository (for an A/B, a ``git archive``
export of the parent commit and one of the change, given in turns: parent,
change, change, parent).  Each runs in a fresh process that builds that
tree's kernels and prints one JSON line, on ``chip_smoke.py`` phase 10's
inputs (BLOSUM62, go = 10, ge = 0.5):

* 10a, 8 protein pairs of 12,000 at band 512 (W = 512): K7 (LOCAL, mean
  of 3 launches after one to warm up) and a digest of its pointer bytes
  (rows i <= n) and stats, equal across trees when the fills agree; K8 on
  that band (LOCAL, mean of 3 after one), its steps and a digest of its
  indices, counts and flags; in each mode the wall of one
  ``align_banded_batch`` after one untimed call;
* 10b, one pair of 32,768: K7 and K8 at the verified band's W (LOCAL,
  mean of 3) with their digests, and the warm wall of the verified
  ``Aligner.align_banded(band=1024)``;
* K6 by its launch (``kernels.banded_scores`` into one S, the mean of 20
  launches queued behind a device sleep, so that the host's enqueueing is
  not timed) at 10a, at 10b's verified W, and at two of phase 9's cases
  (its narrow pairs at band 128, all its pairs at band 2048), each with
  its tile plan (where the tree has one) and a digest of S, equal across
  trees when the scores agree.

Times are CUDA events, walls host clocks around a synchronised call; the
card's name and power limit come first.

``python3 scripts/ab_banded.py --plans TREE`` times K6 of one tree at
those four shapes at every tile plan (T rows a tile in 8, 16, 32, 64 and
4 or 8 blocks an SM, ``kernels.scores_plan`` replaced), each checked equal
to the scores at the tree's own plan, and prints one JSON line a shape.
"""

import hashlib
import json
import os
import subprocess
import sys
import time


def inputs(tree: str):
    """Phase 10's inputs on the card from TREE: (cs, banded, codes, table,
    the 32k pair's codes, device)."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import chip_smoke as cs
    from smithwaterman_tpu_torch.matrices import SubstitutionMatrix
    from smithwaterman_tpu_torch.ops import banded, kernels

    if not banded.__file__.startswith(tree):
        raise SystemExit(f"imported {banded.__file__}, not {tree}")
    kernels.build()
    kernels.lib()
    sm = SubstitutionMatrix.blosum62()
    table = np.asarray(sm.table, np.float32)
    rng = np.random.default_rng(cs.SEED)
    pairs = [cs.mutated_pair(cs.BANDED_LEN, rng, cs.LETTERS)
             for _ in range(cs.BANDED_PAIRS)]
    codes = [(sm.seq_to_index(a), sm.seq_to_index(b)) for a, b in pairs]
    s1, s2 = cs.mutated_pair(cs.GIANT_LEN, np.random.default_rng(cs.SEED),
                             cs.LETTERS)
    giant = (s1, s2, sm.seq_to_index(s1), sm.seq_to_index(s2))
    return cs, banded, codes, table, giant, torch.device("cuda:0")


def shapes(banded, codes, table, giant, band_used, dev):
    """The K7 inputs of 10a and of 10b's verified band: {name: (S, n, m,
    packed batch)}."""
    import torch

    out = {}
    for name, pairs, band in (("10a", codes, 512),
                              ("10b", [giant[2:]], band_used)):
        pk = banded.pack(pairs, band, table.shape[0])
        tab = torch.from_numpy(table).to(dev)
        c1, c2, n, m = (torch.from_numpy(a).to(dev)
                        for a in (pk.codes1, pk.codes2, pk.n, pk.m))
        out[name] = (banded.banded_scores(tab, c1, c2, n, m, W=pk.W), n, m,
                     pk)
    return out


def k6_inputs(cs, banded, codes, table, giant, band_used, dev):
    """K6's inputs: {name: (codes1, codes2, n, m, W, table)} at 10a, 10b's
    verified band and two of phase 9's cases."""
    import numpy as np
    import torch

    p9 = cs.phase9_pairs(np.random.default_rng(cs.SEED + 9))
    narrow = [p for p, (n, m) in zip(p9, cs.PHASE9_LENGTHS) if m <= n]
    tab = torch.from_numpy(table).to(dev)
    out = {}
    for name, pairs, band in (("10a", codes, cs.BANDED_BAND),
                              ("10b", [giant[2:]], band_used),
                              ("9_w128", narrow, 128), ("9_w2048", p9, 2048)):
        pk = banded.pack(pairs, band, table.shape[0])
        out[name] = tuple(torch.from_numpy(a).to(dev) for a in (
            pk.codes1, pk.codes2, pk.n, pk.m)) + (pk.W, tab)
    return out


def launch_ms(fn, reps=20) -> float:
    """Mean device time (ms) of ``reps`` calls of ``fn`` launched back to
    back behind a device sleep: the host queues them all before the first
    starts, so its own time per call is not counted."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(5_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def digest(tb, st, n) -> str:
    h = hashlib.sha256(st.cpu().numpy().tobytes())
    for b, x in enumerate(n.tolist()):
        h.update(tb[b, :x].cpu().numpy().tobytes())
    return h.hexdigest()


def one(tree: str) -> dict:
    import torch

    cs, banded, codes, table, giant, dev = inputs(tree)
    from smithwaterman_tpu_torch import GLOBAL, GLOCAL, LOCAL, Aligner

    out = {"tree": tree}
    kw = dict(mode=LOCAL, og=-10.0, eg=-0.5)
    for mode, name in ((LOCAL, "local"), (GLOCAL, "glocal"),
                       (GLOBAL, "global")):
        run = lambda: banded.align_banded_batch(  # noqa: E731
            codes, table, mode=mode, og=-10.0, eg=-0.5, band=cs.BANDED_BAND,
            device=dev)
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run()
        out[f"wall_10a_{name}_s"] = time.perf_counter() - t0
        out[f"scores_10a_{name}"] = [r[2] for r in res]
    al = Aligner(mode=LOCAL, device=dev)
    al.align_banded(giant[0], giant[1], band=cs.GIANT_BAND)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = al.align_banded(giant[0], giant[1], band=cs.GIANT_BAND)
    out["wall_10b_s"] = time.perf_counter() - t0
    out["score_10b"] = r.score
    band_used = banded.align_banded_verified(
        giant[2], giant[3], table, band=cs.GIANT_BAND, device=dev, **kw)[-1]
    out["band_used_10b"] = band_used
    from smithwaterman_tpu_torch.ops import kernels

    for name, (c1, c2, n, m, W, tab) in k6_inputs(
            cs, banded, codes, table, giant, band_used, dev).items():
        S = torch.empty((c1.shape[0], c1.shape[1], W), dtype=torch.float32,
                        device=dev)
        out[f"k6_{name}_ms"] = launch_ms(
            lambda: kernels.banded_scores(tab, c1, c2, n, m, S, W=W))
        out[f"k6_{name}_W"] = W
        if hasattr(kernels, "scores_plan"):
            out[f"k6_{name}_plan"] = kernels.banded_scores(
                tab, c1, c2, n, m, S, W=W)
        torch.cuda.synchronize()
        out[f"k6_{name}_digest"] = hashlib.sha256(
            S.cpu().numpy().tobytes()).hexdigest()
        del S
    for name, (S, n, m, pk) in shapes(banded, codes, table, giant, band_used,
                                      dev).items():
        banded.fill_banded(S, n, m, **kw)
        out[f"k7_{name}_ms"], (tb, st) = cs.timed(
            lambda: banded.fill_banded(S, n, m, **kw), 3)
        out[f"k7_{name}_digest"] = digest(tb, st, pk.n)
        if hasattr(banded, "SHAPES"):
            out[f"k7_{name}_shape"] = dict(banded.SHAPES["K7"])
        start, _ = banded.walk_starts(st.cpu().numpy(), pk, LOCAL)
        off, start = (torch.from_numpy(a).to(dev) for a in (pk.offs, start))
        wk = dict(local=True, L=banded.path_len(pk))
        banded.walk_banded_device(tb, off, start, m, **wk)
        out[f"k8_{name}_ms"], got = cs.timed(
            lambda: banded.walk_banded_device(tb, off, start, m, **wk), 3)
        out[f"k8_{name}_steps"] = int(got[2].sum())
        out[f"k8_{name}_digest"] = hashlib.sha256(b"".join(
            g.cpu().numpy().tobytes() for g in got)).hexdigest()
    return out


def plans(tree: str) -> None:
    import torch

    cs, banded, codes, table, giant, dev = inputs(tree)
    from smithwaterman_tpu_torch import LOCAL
    from smithwaterman_tpu_torch.ops import kernels

    band_used = banded.align_banded_verified(
        giant[2], giant[3], table, band=cs.GIANT_BAND, device=dev,
        mode=LOCAL, og=-10.0, eg=-0.5)[-1]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    own = kernels.scores_plan
    for name, (c1, c2, n, m, W, tab) in k6_inputs(
            cs, banded, codes, table, giant, band_used, dev).items():
        B, NP = c1.shape
        S = torch.empty((B, NP, W), dtype=torch.float32, device=dev)
        out = {"shape": name, "B": B, "NP": NP, "W": W,
               "plan": kernels.banded_scores(tab, c1, c2, n, m, S, W=W)}
        want = S.clone()
        for T in (8, 16, 32, 64):
            for per_sm in (4, 8):
                kernels.scores_plan = (
                    lambda *a, T=T, per_sm=per_sm:
                    (T, min(per_sm * sms, B * -(-NP // T))))
                S.zero_()
                ms = launch_ms(
                    lambda: kernels.banded_scores(tab, c1, c2, n, m, S, W=W))
                if not torch.equal(S, want):
                    raise SystemExit(f"K6 at T={T}, {per_sm} blocks an SM "
                                     f"differs at {name}")
                out[f"T{T}_x{per_sm}_ms"] = ms
        kernels.scores_plan = own
        print(json.dumps(out), flush=True)
        del S, want


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(one(os.path.abspath(sys.argv[2]))), flush=True)
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--plans":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             stdout=subprocess.PIPE, text=True,
                             check=True).stdout.strip(), flush=True)
        plans(os.path.abspath(sys.argv[2]))
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
