#!/usr/bin/env python3
"""Time the main path's pooled walks K2 and K11 of one or more source trees
on one card.

Usage, on a machine with an NVIDIA card::

    python3 scripts/ab_walk.py [--pairs N] [--shapes T,C;T,C...] TREE ...

Each TREE is a checkout of this repository (for an A/B, a ``git archive``
export of the parent commit and one of the change, given in turns: parent,
change, change, parent).  Each runs in a fresh process that builds that
tree's kernels and prints one JSON line, on ``chip_smoke.py`` phase 5's
inputs (3200 protein pairs, lengths uniform in 150..700, BLOSUM62, go =
10, ge = 0.5, bucketed as ``BatchAligner`` buckets them: 25 chunks, one
flush), in all three modes:

* K2 at phase 5: K1's pointer pool (``fill_dp.fill_many``), then K2 by its
  launch alone (``kernels.walk`` into outputs allocated once, mean of 10
  after one), at the tree's own tiles;
* K11 at phase 12a: K10's pools (``fill_many(runs=True)``), then K11 by its
  launch alone in the same way;
* each kernel over the pair with the longest walk alone (one pair, one
  launch: that walk's chain with no other pair on the card);
* the pairs' start order, in turns (descriptor order, longest n + m
  first, longest first, descriptor order, three rounds): each kernel over
  the fill's descriptor and stats rows as they are and permuted longest n
  + m first (the same walks, started in the other order), digests
  compared after undoing the permutation;
* with ``--shapes``, each kernel at each (T, C) given too (trees whose
  launchers take tiles only);
* with ``--pairs N``, a flush of N pairs drawn the same way instead of
  3200 (for the start order across flush sizes);
* the warm walls of ``BatchAligner.align_pairs`` (phase 5) and of the same
  call with ``SWTPU_TOKEN_WALK=1`` (12a), one call each after a cold one;
* digests of ``cnt`` and ``moves`` (K2) and of ``cnt`` and ``toks`` (K11),
  equal across trees, tiles and orders, the walks' total and longest
  steps.

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


def pairs_of(cs, count):
    """``count`` protein pairs drawn as ``chip_smoke.main_path_pairs`` draws
    its 3200 (the same pairs for 3200)."""
    import numpy as np

    from smithwaterman_tpu_torch.io.fasta import SeqData

    rng = np.random.default_rng(cs.SEED)
    letters = np.array(list(cs.LETTERS))

    def seq(name):
        k = int(rng.integers(cs.LMIN, cs.LMAX + 1))
        return SeqData(name, "", "".join(rng.choice(letters, k)))

    return [(seq(f"a{i}"), seq(f"b{i}")) for i in range(count)]


def inputs(tree: str, count: int):
    """Phase 5's pairs (``count`` of them) and chunks with TREE's package:
    (cs, pairs, chunks, tab)."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import chip_smoke as cs
    from smithwaterman_tpu_torch.batch_aligner import _Bucket
    from smithwaterman_tpu_torch.config import bucket_len
    from smithwaterman_tpu_torch.matrices import SubstitutionMatrix
    from smithwaterman_tpu_torch.ops import device_walk, kernels

    if not device_walk.__file__.startswith(tree):
        raise SystemExit(f"imported {device_walk.__file__}, not {tree}")
    kernels.build()
    kernels.lib()
    sm = SubstitutionMatrix.blosum62()
    pairs = pairs_of(cs, count)
    buckets = {}
    for a, b in pairs:
        key = (bucket_len(len(a.seq)), bucket_len(len(b.seq)))
        bk = buckets.setdefault(key, _Bucket(*key))
        bk.indices.append(len(bk.indices))
        bk.codes1.append(sm.seq_to_index(a.seq))
        bk.codes2.append(sm.seq_to_index(b.seq))
    chunks = [buckets[k].chunk(np.uint8) for k in sorted(buckets)]
    tab = torch.from_numpy(np.asarray(sm.table, np.float32)).to("cuda:0")
    return cs, pairs, chunks, tab


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


def launch_alone(cs, got, mode, L, tokens, shape, reps=10, order=None):
    """K2 (K11 with ``tokens``) by its launch alone over the fill ``got``,
    at tiles ``shape`` (T, C; None for a tree whose launcher takes none),
    the pairs started in ``order`` where the launcher takes one (None:
    descriptor order, 0 .. B - 1): mean ms of ``reps`` launches after
    one, and (cnt, out)."""
    import torch

    from smithwaterman_tpu_torch import LOCAL
    from smithwaterman_tpu_torch.ops import kernels

    B = got.desc.shape[0]
    dev = got.desc.device
    cnt = torch.empty(B, dtype=torch.int32, device=dev)
    out = torch.zeros((L, B) if tokens else (-(-L // 4), B),
                      dtype=torch.uint8, device=dev)
    fn = kernels.walk_tokens if tokens else kernels.walk
    kw = dict(local=mode == LOCAL, L=L)
    if shape is not None:
        kw.update(T=shape[0], C=shape[1])
    if "order" in inspect.signature(fn).parameters:
        kw["order"] = (torch.arange(B, dtype=torch.int32, device=dev)
                       if order is None else order)
    pools = (got.tb, got.run) if tokens else (got.tb,)
    run = lambda: fn(*pools, got.desc, got.stats, cnt, out, **kw)  # noqa
    run()
    ms, _ = cs.timed(run, reps)
    return ms, (cnt, out)


def rows(got, idx):
    """The fill ``got`` over descriptor and stats rows ``idx`` (a walk of
    pair idx[k] in slot k), on the same pools."""
    from smithwaterman_tpu_torch.ops import fill_dp

    return fill_dp.Filled(got.tb, got.stats[idx].contiguous(),
                          got.desc[idx].contiguous(), got.shapes,
                          got.tb_base, got.run)


def alone(cs, got, mode, L, tokens, shape, k):
    """The launch over pair ``k`` alone (its descriptor and stats rows),
    as :func:`launch_alone` times it: ms."""
    return launch_alone(cs, rows(got, [k]), mode, L, tokens, shape)[0]


def by_order(cs, got, mode, L, tokens, shape, want):
    """Each kernel with the pairs started in descriptor order and longest n
    + m first, in turns (d, l, l, d, three rounds): ({"desc": [ms, ...],
    "longest": [...]}); every walk's outputs, put back in descriptor
    order, must equal ``want``'s digest."""
    import torch

    from smithwaterman_tpu_torch.ops.fill_dp import D_M, D_N

    nm = (got.desc[:, D_N] + got.desc[:, D_M]).cpu()
    perm = torch.argsort(-nm, stable=True).to(got.desc.device)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(len(perm), device=perm.device)
    fills = {"desc": got, "longest": rows(got, perm)}
    ms = {"desc": [], "longest": []}
    for _ in range(3):
        for name in ("desc", "longest", "longest", "desc"):
            t, (cnt, out) = launch_alone(cs, fills[name], mode, L, tokens,
                                         shape)
            ms[name].append(t)
            if name == "longest":
                cnt, out = cnt[inv], out[:, inv]
            if digest(cnt, out) != want:
                raise SystemExit(f"walks started in {name} order differ")
    return ms


def one(tree: str, extra, count: int) -> dict:
    import torch

    cs, pairs, chunks, tab = inputs(tree, count)
    from smithwaterman_tpu_torch import GLOBAL, GLOCAL, LOCAL, BatchAligner
    from smithwaterman_tpu_torch.ops import device_walk, fill_dp, kernels

    tiled = "T" in inspect.signature(kernels.walk).parameters
    L = max(device_walk.max_path_len(NP, MP) for _, NP, MP in
            (ch.shape for ch in chunks))
    out = {"tree": tree, "pairs": len(pairs), "chunks": len(chunks), "L": L}
    for mode, mname in ((LOCAL, "local"), (GLOCAL, "glocal"),
                        (GLOBAL, "global")):
        args = dict(mode=mode, og=-10.0, eg=-0.5)
        for tokens, k in ((False, "k2"), (True, "k11")):
            got = fill_dp.fill_many(tab, chunks, runs=tokens, **args)
            shape = (device_walk.TILES[2 if tokens else 1]
                     if tiled else None)
            ms, (cnt, o) = launch_alone(cs, got, mode, L, tokens, shape,
                                        order=getattr(got, "order", None))
            key = f"{k}_{mname}"
            out[f"{key}_ms"] = ms
            out[f"{key}_tiles"] = shape
            out[f"{key}_digest"] = digest(cnt, o)
            out[f"{key}_steps"] = int(cnt.sum())
            out[f"{key}_longest"] = int(cnt.max())
            out[f"{key}_alone_ms"] = alone(cs, got, mode, L, tokens, shape,
                                          int(cnt.argmax()))
            out[f"{key}_by_order_ms"] = by_order(
                cs, got, mode, L, tokens, shape, out[f"{key}_digest"])
            for sh in (extra if tiled else ()):
                ms, res = launch_alone(cs, got, mode, L, tokens, sh)
                if digest(*res) != out[f"{key}_digest"]:
                    raise SystemExit(f"{key} at {sh} differs from the "
                                     "launcher's tiles")
                out[f"{key}_{sh[0]}x{sh[1]}_ms"] = ms
            del got, cnt, o
        for tokens, k in ((False, "wall5"), (True, "wall12a")):
            if tokens:
                os.environ["SWTPU_TOKEN_WALK"] = "1"
            try:
                eng = BatchAligner(mode=mode, device="cuda")
                eng.align_pairs(pairs)                      # cold
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng.align_pairs(pairs)
                out[f"{k}_{mname}_s"] = time.perf_counter() - t0
            finally:
                os.environ.pop("SWTPU_TOKEN_WALK", None)
    return out


def main() -> int:
    args = sys.argv[1:]
    extra, count = [], 3200
    while args[:1] in (["--shapes"], ["--pairs"]):
        if args[0] == "--pairs":
            count = int(args[1])
        else:
            extra = [tuple(int(v) for v in sh.split(","))
                     for sh in args[1].split(";") if sh]
        args = args[2:]
    if len(args) == 2 and args[0] == "--one":
        print(json.dumps(one(os.path.abspath(args[1]), extra, count)),
              flush=True)
        return 0
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], stdout=subprocess.PIPE,
                         text=True, check=True).stdout.strip(), flush=True)
    rc = 0
    opts = ["--pairs", str(count), "--shapes",
            ";".join(",".join(map(str, sh)) for sh in extra)]
    for tree in args:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__)]
                             + opts + ["--one", tree]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
