#!/usr/bin/env python3
"""Time the striped kernels K12 / K13 of one or more source trees on one card.

Usage, on a machine with an NVIDIA card::

    python3 scripts/ab_striped.py TREE [TREE ...]
    python3 scripts/ab_striped.py --plans TREE

Each TREE is a checkout of this repository (for an A/B, a ``git archive``
export of the parent commit and one of the change, given in turns: parent,
change, change, parent).  Each runs in a fresh process that builds that
tree's kernels and prints one JSON line: on ``chip_smoke.py`` phase 14's
2048 x 65,536 protein pair (LOCAL unless named), K13's fill (mean of 3
launches), K12's fill at D = 4 shards on the card (summed launches), one
GLOBAL band re-fill of 256 rows with pointer bytes (K12 at B = 1), each
with its largest difference from the plain version; then in each mode the
warm wall of ``striped_align`` on one card and, from one more call, its
split: the checkpointed fill, the band re-fills (and their count), the
windows' copies to the host and the host walks.  The split is this
checkout's ``chip_smoke.split``, which wraps the tree's own functions
(the card synchronised around each), so it needs nothing of the tree
beyond what every version has.  Times are CUDA events or host clocks
around a synchronised card; the card's name and power limit come first.
``--plans`` times K13 and K12 of a tree with column tiles (K12 / K13
since they run on many SMs) at phase 14's shapes and at smaller ones
where the launcher picks narrower tiles, at the launcher's tiling and at
forced ones, one JSON line each (see :func:`plans`).
"""

import importlib.util
import json
import os
import subprocess
import sys
import time


def pair(tree: str):
    """Phase 14's pair on the card from TREE: (cs, seq_tiled, kernels, S,
    (nv, mv) numpy, (nt, mt) tensors, device)."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import chip_smoke as cs
    from smithwaterman_tpu_torch.matrices import SubstitutionMatrix
    from smithwaterman_tpu_torch.ops import kernels
    from smithwaterman_tpu_torch.parallel import seq_tiled

    if not seq_tiled.__file__.startswith(tree):
        raise SystemExit(f"imported {seq_tiled.__file__}, not {tree}")
    kernels.build()
    kernels.lib()
    dev = torch.device("cuda:0")
    sm = SubstitutionMatrix.blosum62()
    rng = np.random.default_rng(cs.SEED)
    NP, MP, AT = cs.STRIPED_NP, cs.STRIPED_MP, cs.STRIPED_AT
    ref_codes = rng.integers(0, 20, size=MP)
    ref = "".join(cs.LETTERS[c] for c in ref_codes)
    qry = "".join(cs.LETTERS[c] for c in cs.mutate(
        ref_codes[AT:AT + NP], rng, 20))[:NP]
    q = np.zeros(NP, np.uint8)
    q[:len(qry)] = sm.seq_to_index(qry)
    r = np.asarray(sm.seq_to_index(ref), np.uint8)
    tab = torch.from_numpy(np.asarray(sm.table, np.float32)).to(dev)
    S = tab[torch.from_numpy(q).to(dev).long()[:, None],
            torch.from_numpy(r).to(dev).long()[None, :]][None].contiguous()
    nv, mv = np.array([len(qry)], np.int32), np.array([MP], np.int32)
    nt, mt = (torch.tensor([x], dtype=torch.int32, device=dev)
              for x in (len(qry), MP))
    return cs, seq_tiled, kernels, S, (nv, mv), (nt, mt), dev


def one(tree: str) -> dict:
    import torch

    cs, seq_tiled, kernels, S, (nv, mv), (nt, mt), dev = pair(tree)
    from smithwaterman_tpu_torch import GLOBAL, GLOCAL, LOCAL
    from smithwaterman_tpu_torch.parallel import make_mesh

    NP = cs.STRIPED_NP
    pen = seq_tiled.make_pen(LOCAL, -10.0, -0.5)
    out = {"tree": tree}
    seq_tiled.grid_fill(S, nt, mt, mode=LOCAL, pen=pen)
    out["k13_ms"], res = cs.timed(lambda: seq_tiled.grid_fill(
        S, nt, mt, mode=LOCAL, pen=pen), 3)
    ref13 = [torch.empty_like(a) for a in res[:3]]
    seq_tiled.grid_fill_ref(S, nt, mt, *ref13, None, C=None, mode=LOCAL,
                            pen=pen)
    out["k13_err"] = max(cs.StripedLockstep.diff(a, b)
                         for a, b in zip(res[:3], ref13))
    kw = dict(og=-10.0, eg=-0.5, block_rows=64)
    one_card = make_mesh(devices=[dev])
    with cs.StripedLockstep() as ls:
        seq_tiled.striped_fill(S, nv, mv, mode=LOCAL,
                               mesh=make_mesh(devices=[dev] * 4), **kw)
    out["k12_d4_ms"], out["k12_d4_err"] = ls.ms["K12"], ls.err
    C = 256
    _, ck = seq_tiled.striped_fill_ckpt(S, nv, mv, mode=GLOBAL, ckpt_rows=C,
                                        mesh=one_card, **kw)
    sk = NP // C - 1
    with cs.StripedLockstep() as lb:
        seq_tiled.striped_band_tb(S[:, sk * C:], nv, mv, sk * C,
                                  *(a[:, sk - 1] for a in ck), mode=GLOBAL,
                                  mesh=one_card, **kw)
    out["band_ms"], out["band_err"] = lb.ms["K12"], lb.err
    for mode, name in ((LOCAL, "local"), (GLOCAL, "glocal"),
                       (GLOBAL, "global")):
        seq_tiled.striped_align(S, nv, mv, mode=mode, mesh=one_card, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx, st = seq_tiled.striped_align(S, nv, mv, mode=mode,
                                          mesh=one_card, **kw)
        out[f"align_{name}_s"] = time.perf_counter() - t0
        out[f"align_{name}_columns"] = len(idx[0][0])
        out[f"align_{name}_score"] = float(
            st[0, 0] if mode == LOCAL else st[0, 3:6].max())
        out[f"align_{name}_split"] = split(seq_tiled, lambda: seq_tiled
                                           .striped_align(S, nv, mv,
                                                          mode=mode,
                                                          mesh=one_card,
                                                          **kw))
    return out


def plans(tree: str, rounds: int = 5) -> list:
    """K12 / K13's launch times of a tree with column tiles at the
    launcher's tiling and at forced ones, one row a (shapes, tiling):
    CUDA-event times of the kernels' launches alone (each K12 launch timed
    by itself, summed), every tiling run once to warm it, then ``rounds``
    times in rotated order; the min and median of each, and the shape of
    each kernel's last launch.

    Phase 14's shapes (K13 LOCAL, K12 at D = 4 LOCAL, the GLOBAL band
    re-fill of :func:`one`) take the launcher's tiling and forced (L, E),
    L lanes a thread and E rows a publication.  Smaller shapes, cut from
    phase 14's pair, where the launcher picks L < 16 (K13 at 512 x 2048,
    at 2048 x 32,768 and at 8 pairs of 512 x 4096; K12 at D = 4 on
    512 x 2048, shards of 512 lanes) take the launcher's and each L in
    ``kernels.STRIPED_LANES`` with the launcher's E for it."""
    import statistics

    import numpy as np
    import torch

    cs, seq_tiled, kernels, S, (nv, mv), (nt, mt), dev = pair(tree)
    from smithwaterman_tpu_torch import GLOBAL, LOCAL
    from smithwaterman_tpu_torch.parallel import make_mesh

    kw = dict(og=-10.0, eg=-0.5, block_rows=64)
    one_card = make_mesh(devices=[dev])
    four = make_mesh(devices=[dev] * 4)
    pen = seq_tiled.make_pen(LOCAL, -10.0, -0.5)
    C = 256
    sk = cs.STRIPED_NP // C - 1
    _, ck = seq_tiled.striped_fill_ckpt(S, nv, mv, mode=GLOBAL, ckpt_rows=C,
                                        mesh=one_card, **kw)
    real_plan, real_lanes = kernels.striped_plan, kernels.STRIPED_LANES
    real_block = seq_tiled.block_fill
    k12 = {"ms": 0.0}

    def block(*a, **k):
        ms, _ = cs.event_ms(lambda: real_block(*a, **k))
        k12["ms"] += ms

    def k13(S_, n_, m_):
        return lambda: cs.timed(lambda: seq_tiled.grid_fill(
            S_, n_, m_, mode=LOCAL, pen=pen), 3)[0]

    def k12_ms(fill):
        def f():
            k12["ms"] = 0.0
            fill()
            return k12["ms"]
        return f

    def cut(np_, mp_, b=1):
        Sc = S[:, :np_, :mp_].expand(b, np_, mp_).contiguous()
        nc, mc = np.full(b, np_, np.int32), np.full(b, mp_, np.int32)
        return Sc, nc, mc, torch.from_numpy(nc).to(dev), \
            torch.from_numpy(mc).to(dev)

    s1, s2, s3 = cut(512, 2048), cut(2048, 32768), cut(512, 4096, 8)
    wide = {
        ("K13", "k13_ms"): k13(S, nt, mt),
        ("K12", "k12_d4_ms"): k12_ms(lambda: seq_tiled.striped_fill(
            S, nv, mv, mode=LOCAL, mesh=four, **kw)),
        ("K12", "band_ms"): k12_ms(lambda: seq_tiled.striped_band_tb(
            S[:, sk * C:], nv, mv, sk * C, *(a[:, sk - 1] for a in ck),
            mode=GLOBAL, mesh=one_card, **kw)),
    }
    narrow = {
        ("K13", "k13_512x2048_ms"): k13(s1[0], s1[3], s1[4]),
        ("K13", "k13_2048x32768_ms"): k13(s2[0], s2[3], s2[4]),
        ("K13", "k13_8x512x4096_ms"): k13(s3[0], s3[3], s3[4]),
        ("K12", "k12_d4_512x2048_ms"): k12_ms(lambda: seq_tiled.striped_fill(
            s1[0], s1[1], s1[2], mode=LOCAL, mesh=four, **kw)),
    }

    def use(plan):
        # None: the launcher's; (L, E): forced; L: forced, the rule's E
        kernels.striped_plan = (lambda *a, p=plan: p) \
            if isinstance(plan, tuple) else real_plan
        kernels.STRIPED_LANES = (plan,) if isinstance(plan, int) \
            else real_lanes

    def sweep(cases, grid):
        times = {(g, c): [] for g in grid for c in cases}
        shapes = {}
        for g in grid:
            use(g)
            for c, f in cases.items():
                f()
                shapes[g, c] = dict(seq_tiled.SHAPES[c[0]])
        for r in range(rounds):
            for g in grid[r % len(grid):] + grid[:r % len(grid)]:
                use(g)
                for c, f in cases.items():
                    times[g, c].append(f())
        out = []
        for g in grid:
            row = {"plan": "launcher" if g is None else g}
            for c in cases:
                v = times[g, c]
                row[c[1]] = {"min": min(v), "median": statistics.median(v),
                             "shape": shapes[g, c]}
            out.append(row)
        return out

    seq_tiled.block_fill = block
    try:
        rows = sweep(wide, [None, (16, 1), (16, 2), (16, 4), (16, 8), (8, 1),
                            (8, 2), (8, 4)])
        rows += sweep(narrow, [None] + list(real_lanes))
    finally:
        use(None)
        seq_tiled.block_fill = real_block
    torch.cuda.synchronize()
    return rows


def split(seq_tiled, run) -> dict:
    """This checkout's ``chip_smoke.split`` of one ``run()`` of the tree's
    striped_align: it wraps functions that every tree's striped path has,
    so it splits a parent tree's wall too."""
    here = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_here", here)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke.split(seq_tiled, run)


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
    if len(sys.argv) == 3 and sys.argv[1] == "--plans":
        for row in plans(os.path.abspath(sys.argv[2])):
            print(json.dumps(row), flush=True)
        return 0
    rc = 0
    for tree in sys.argv[1:]:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", tree]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
