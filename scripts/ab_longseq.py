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

* the wall of one GLOBAL ``BatchAligner.align_pairs`` (the long route),
  after one untimed call, and its peak device memory;
* K3 (LOCAL, mean of 3 launches after one to warm up);
* K4 (GLOBAL): one band alone, and every band of the bucket as the tree's
  route refills them (one launch a band, or one a group where the tree
  has ``fill_bands``);
* K5 on one band;
* each kernel's largest difference from its plain version: K3 on the
  pairs cut to 8,192 bp (the plain fill at 70 kb takes about a minute),
  K4 and K5 on one band at 70 kb.

Times are CUDA events, walls host clocks around a synchronised call; the
card's name and power limit come first.
"""

import json
import os
import subprocess
import sys
import time

CUT = 8192  # K3's comparison with its plain version, bp a side


def one(tree: str) -> dict:
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import chip_smoke as cs
    from smithwaterman_tpu_torch import GLOBAL, LOCAL, BatchAligner
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
    eng = BatchAligner(scoring_matrix=dna, gap_open=10.0, gap_extend=0.5,
                       mode=GLOBAL, device="cuda")
    eng.align_pairs(pairs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = eng.align_pairs(pairs)
    torch.cuda.synchronize()
    out["wall_global_s"] = time.perf_counter() - t0
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["scores"] = [r.score for r in res]

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
    # K3 against its plain version on the pairs cut to CUT bp
    cut = [(a[:CUT], b[:CUT]) for a, b in pairs]
    cc = cs.one_chunk(cut, dna)
    v1, v2, vn, vm = (torch.from_numpy(a).to(dev) for a in cc)
    got = longseq.fill_checkpointed(tab, v1, v2, vn, vm, **args)
    ref = longseq.fill_checkpointed_ref(tab, v1, v2, vn, vm, **args)
    err = float((got[0] - ref[0]).abs().max())
    for b in range(len(cc.n)):
        k, mb = int(cc.n[b]) // C, int(cc.m[b])
        for a, r in zip(got[1], ref[1]):
            if k:
                err = max(err, float((a[b, :k, :mb] - r[b, :k, :mb])
                                     .abs().max()))
    out["k3_err"] = err
    del got, ref

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
    # K5 on band sk, its walk brought down to the band's top
    L = NP + MP + 2
    walk = longseq.walk_start(st, n, m, GLOBAL)
    cnt = torch.zeros(B, dtype=torch.int32, device=dev)
    mv = torch.zeros((-(-L // 4), B), dtype=torch.uint8, device=dev)
    for s in range(nck - 1, sk, -1):
        longseq.fill_band(tab, c1, c2, n, m, ck, rband, sk=s, **args)
        longseq.walk_segments(rband, walk, cnt, mv, sk=s, C=C, MP=MP, L=L,
                              local=False)
    # every_band() may have refilled other bands into `band`
    longseq.fill_band(tab, c1, c2, n, m, ck, band, sk=sk, **args)
    rwalk, rcnt, rmv = walk.clone(), cnt.clone(), mv.clone()
    kw = dict(sk=sk, C=C, MP=MP, L=L, local=False)
    out["k5_ms"], _ = cs.event_ms(lambda: longseq.walk_segments(
        band, walk, cnt, mv, **kw))
    longseq.walk_segments_ref(band, rwalk, rcnt, rmv, **kw)
    out["k5_err"] = max(float((x.long() - y.long()).abs().max())
                        for x, y in ((walk, rwalk), (cnt, rcnt), (mv, rmv)))
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
