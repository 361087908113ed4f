#!/usr/bin/env python3
"""Time the striped kernels K12 / K13 of one or more source trees on one card.

Usage, on a machine with an NVIDIA card::

    python3 scripts/ab_striped.py TREE [TREE ...]

Each TREE is a checkout of this repository (for an A/B, a ``git archive``
export of the parent commit and one of the change, given in turns: parent,
change, change, parent).  Each runs in a fresh process that builds that
tree's kernels and prints one JSON line: on ``chip_smoke.py`` phase 14's
2048 x 65,536 protein pair (LOCAL unless named), K13's fill (mean of 3
launches), K12's fill at D = 4 shards on the card (summed launches), one
GLOBAL band re-fill of 256 rows with pointer bytes (K12 at B = 1), each
with its largest difference from the plain version, and the wall of one
GLOBAL ``striped_align``.  Times are CUDA events; the card's name and
power limit come first.
"""

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
    from smithwaterman_tpu_torch import GLOBAL, LOCAL
    from smithwaterman_tpu_torch.matrices import SubstitutionMatrix
    from smithwaterman_tpu_torch.ops import kernels
    from smithwaterman_tpu_torch.parallel import make_mesh, seq_tiled

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
    t0 = time.perf_counter()
    idx, st = seq_tiled.striped_align(S, nv, mv, mode=GLOBAL, mesh=one_card,
                                      **kw)
    out["align_global_s"] = time.perf_counter() - t0
    out["align_columns"] = len(idx[0][0])
    out["score"] = float(st[0, 3:6].max())
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
