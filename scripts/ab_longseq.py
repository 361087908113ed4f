#!/usr/bin/env python3
"""Time the long route's kernels K3 / K4 / K5 of one or more source trees on
one card.

Usage, on a machine with an NVIDIA card::

    python3 scripts/ab_longseq.py TREE [TREE ...]

Each TREE is a checkout of this repository (for an A/B, a ``git archive``
export of the parent commit and one of the change, given in turns: parent,
change, change, parent).  Each runs in a fresh process that builds that
tree's kernels and prints one JSON line, on ``chip_smoke.py`` phase 8's 4
DNA pairs of 70,000 bp a side (match/mismatch 5 / -4, go = 10, ge = 0.5,
C = 256):

* in each mode the wall of one ``BatchAligner.align_pairs`` (the long
  route), after one untimed call, and its peak device memory;
* K3 (LOCAL, mean of 3 launches after one to warm up);
* K4 (GLOBAL): one band alone, and every band of the bucket as the tree's
  route refills them (one launch a band, or one a group where the tree
  has ``fill_bands``);
* K5 (GLOBAL): the whole walk of the mode, group by group as the route
  takes the groups, each group refilled by K4 (untimed) and then walked:
  one K5 launch a band where the tree's ``walk_segments`` takes one band,
  one a group where it takes a group (``sk0``); the K5 time summed, its
  launches, and a digest of the final counts and moves, equal across
  trees when the walks agree;
* K4's largest difference from its plain version on one band.

Times are CUDA events, walls host clocks around a synchronised call; the
card's name and power limit come first.
"""

import hashlib
import inspect
import json
import os
import subprocess
import sys
import time

def one(tree: str) -> dict:
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import chip_smoke as cs
    from smithwaterman_tpu_torch import GLOBAL, GLOCAL, LOCAL, BatchAligner
    from smithwaterman_tpu_torch.matrices import SubstitutionMatrix
    from smithwaterman_tpu_torch.ops import batch, kernels, longseq

    if not longseq.__file__.startswith(tree):
        raise SystemExit(f"imported {longseq.__file__}, not {tree}")
    t0 = time.perf_counter()
    kernels.build()
    kernels.lib()
    out = {"tree": tree, "build_s": time.perf_counter() - t0}
    dev = torch.device("cuda:0")
    rng = np.random.default_rng(cs.SEED)
    pairs = [cs.mutated_pair(cs.DNA_LEN, rng, "ACGT")
             for _ in range(cs.DNA_PAIRS)]
    dna = SubstitutionMatrix.match_mismatch(5.0, -4.0)
    for mode, name in ((LOCAL, "local"), (GLOCAL, "glocal"),
                       (GLOBAL, "global")):
        eng = BatchAligner(scoring_matrix=dna, gap_open=10.0, gap_extend=0.5,
                           mode=mode, device="cuda")
        eng.align_pairs(pairs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = eng.align_pairs(pairs)
        torch.cuda.synchronize()
        out[f"wall_{name}_s"] = time.perf_counter() - t0
        out[f"peak_{name}_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out[f"scores_{name}"] = [r.score for r in res]

    ch = cs.one_chunk(pairs, dna)
    B, NP, MP = ch.shape
    c1, c2, n, m = (torch.from_numpy(a).to(dev) for a in ch)
    tab = torch.from_numpy(np.asarray(dna.table, np.float32)).to(dev)
    C = longseq.DEFAULT_CKPT_ROWS
    args = dict(mode=LOCAL, og=-10.0, eg=-0.5, C=C)
    longseq.fill_checkpointed(tab, c1, c2, n, m, **args)
    out["k3_ms"], (st, _) = cs.timed(
        lambda: longseq.fill_checkpointed(tab, c1, c2, n, m, **args), 3)
    out["k3_stats"] = st.cpu().numpy()[:, :3].tolist()

    args = dict(mode=GLOBAL, og=-10.0, eg=-0.5, C=C)
    st, ck = longseq.fill_checkpointed(tab, c1, c2, n, m, **args)
    nck = longseq.n_ckpts(NP, C)
    bb = longseq.band_bytes(C, MP)
    sk = nck - 2
    band = torch.empty((B, bb), dtype=torch.uint8, device=dev)
    longseq.fill_band(tab, c1, c2, n, m, ck, band, sk=sk, **args)
    out["k4_band_ms"], _ = cs.event_ms(lambda: longseq.fill_band(
        tab, c1, c2, n, m, ck, band, sk=sk, **args))
    rband = torch.zeros_like(band)
    longseq.fill_band_ref(tab, c1, c2, n, m, ck, rband, sk=sk, **args)
    got, want = (longseq.band_view(x, C, MP) for x in (band, rband))
    err = 0.0
    for b in range(B):
        rows = min(max(int(ch.n[b]) - sk * C, 0), C)
        d = got[b, :rows, :int(ch.m[b])].int() - \
            want[b, :rows, :int(ch.m[b])].int()
        err = max(err, float(d.abs().max()))
    out["k4_err"] = err
    if hasattr(longseq, "fill_bands"):
        G = longseq.group_bands(B, NP, MP, batch.tb_budget(), C)
        bands = torch.empty((G, B, bb), dtype=torch.uint8, device=dev)

        def every_band():
            for hi in range(nck - 1, -1, -G):
                lo = max(0, hi - G + 1)
                longseq.fill_bands(tab, c1, c2, n, m, ck, bands[:hi - lo + 1],
                                   sk0=lo, **args)
    else:
        G = 1

        def every_band():
            for s in range(nck - 1, -1, -1):
                longseq.fill_band(tab, c1, c2, n, m, ck, band, sk=s, **args)

    out["k4_bands_a_launch"] = G
    out["k4_all_ms"], _ = cs.event_ms(every_band)
    out["k4_all_bands"] = nck
    # K5: the mode's whole walk, group by group
    L = NP + MP + 2
    walk = longseq.walk_start(st, n, m, GLOBAL)
    cnt = torch.zeros(B, dtype=torch.int32, device=dev)
    mv = torch.zeros((-(-L // 4), B), dtype=torch.uint8, device=dev)
    grouped = "sk0" in inspect.signature(longseq.walk_segments).parameters
    Gw = longseq.group_bands(B, NP, MP, batch.tb_budget(), C)
    bands = torch.empty((Gw, B, bb), dtype=torch.uint8, device=dev)
    before = k5_launches(longseq)
    k5_ms = 0.0
    for hi in range(nck - 1, -1, -Gw):
        lo = max(0, hi - Gw + 1)
        group = bands[:hi - lo + 1]
        if hasattr(longseq, "fill_bands"):
            longseq.fill_bands(tab, c1, c2, n, m, ck, group, sk0=lo, **args)
        else:
            for s in range(hi, lo - 1, -1):
                longseq.fill_band(tab, c1, c2, n, m, ck, group[s - lo],
                                  sk=s, **args)
        kw = dict(C=C, MP=MP, L=L, local=False)
        if grouped:
            ms, _ = cs.event_ms(lambda: longseq.walk_segments(
                group, walk, cnt, mv, sk0=lo, **kw))
        else:
            def per_band():
                for s in range(hi, lo - 1, -1):
                    longseq.walk_segments(group[s - lo], walk, cnt, mv,
                                          sk=s, **kw)
            ms, _ = cs.event_ms(per_band)
        k5_ms += ms
    out["k5_mode_ms"] = k5_ms
    out["k5_launches"] = k5_launches(longseq) - before
    out["k5_bands"] = nck
    out["k5_steps"] = int(cnt.sum())
    out["k5_digest"] = hashlib.sha256(
        cnt.cpu().numpy().tobytes() + mv.cpu().numpy().tobytes()).hexdigest()
    return out


def k5_launches(longseq) -> int:
    """K5's launch count so far: the port's counter registry, or the
    module's own count in a tree from before the registry."""
    if hasattr(longseq, "LAUNCHES"):
        return longseq.LAUNCHES["K5"]
    from smithwaterman_tpu_torch.utils import metrics

    return metrics.counter("launch.K5")


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
