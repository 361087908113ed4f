#!/usr/bin/env python3
"""Time the main path's fill kernels K1 / K10 (and the walk K2) of one or
more source trees on one card, and check that the trees' pointer and run
bytes agree.

Usage, on a machine with an NVIDIA card::

    python3 scripts/ab_fill.py TREE [TREE ...]

Each TREE is a checkout of this repository (for an A/B, a ``git archive``
export of the parent commit and one of the change, given in turns: parent,
change, change, parent).  Each runs in a fresh process that builds that
tree's kernels and prints one JSON line, on ``chip_smoke.py`` phase 5's
3200 protein pairs (lengths uniform in 150..700, BLOSUM62, go = 10,
ge = 0.5), bucketed as ``BatchAligner`` buckets them, every chunk in one
fill:

* the warm wall of ``BatchAligner.align_pairs`` a mode (median of 3 calls
  after one untimed call);
* K1 a mode (traceback) and K1 score-only (LOCAL), K10 a mode, K2 (LOCAL):
  the mean of 3 back-to-back launches after one to warm up, by the
  kernels' launches alone (inputs uploaded once); K1 (LOCAL) on one
  3685 x 3685 pair;
* in a tree whose K1 takes a stripe depth R (1, 2, 4 or 8 rows a lane)
  and warps a pair (``fill_dp.device_plan``), the launcher's plan a pool
  count; K1 and K10 (LOCAL) with every pair at each R in one warp, and
  whether every R's bytes equal the launcher's choice's; K1 on the
  3685 x 3685 pair at each R with one warp and with a warp a stripe (as
  many as the kernel's registers allow a block); and two mid-size
  flushes, 16 protein pairs of 1500..4000 a side and the first 300 of
  phase 5's pairs: K1 and K10 (LOCAL) as the launcher plans them and
  with every pair at each R and 1, 2, 4, 8, 16 or 32 warps a pair (at
  most a warp a stripe), each equal to the launcher's bytes;
* digests of every pair's pointer bytes and run bytes inside its [:n, :m]
  (through ``Filled.tb_view``, whatever the tree's pool layout), of the
  stats and of K2's moves, so that trees can be compared byte for byte.

The last line (after the trees' lines) says whether every tree's digests
are equal.  Times are CUDA events, walls host clocks around a synchronised
call; the card's name and power limit come first.
"""

import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

REPS = 3


def digest(view, n, m):
    """A position-weighted sum of the (NP, MP, B) bytes ``view`` inside
    each pair's [:n, :m] (n, m int tensors on the card)."""
    import torch

    NP, MP, B = view.shape
    dev = view.device
    i = torch.arange(NP, device=dev)[:, None, None]
    j = torch.arange(MP, device=dev)[None, :, None]
    b = torch.arange(B, device=dev)[None, None, :]
    w = (i * 1000003 + j * 7919 + b * 104729) % 2147483647
    mask = (i < n[None, None, :]) & (j < m[None, None, :])
    return int((view.long() * w * mask).sum())


def short(x) -> str:
    """A short hash of a JSON-able value or an array's bytes."""
    b = x.tobytes() if hasattr(x, "tobytes") else json.dumps(x).encode()
    return hashlib.sha1(b).hexdigest()[:16]


def relauncher(fill_dp, kernels, tab, chunks, got, plan=None, **args):
    """A function that refills ``got`` by K1's (K10's) launches alone, its
    inputs uploaded once: through ``fill_dp.launch``, the launches
    ``fill_many`` makes, on its own plan or on ``plan`` ([(R, NW, order)]);
    in a tree before stripes, one launch over every pair."""
    import numpy as np
    import torch

    dev = tab.device
    codes1, codes2 = (torch.from_numpy(np.concatenate(
        [getattr(ch, f).ravel() for ch in chunks])).to(dev)
        for f in ("codes1", "codes2"))
    carry = torch.empty(fill_dp.layout(chunks)[3], dtype=torch.float32,
                        device=dev)
    kw = dict(traceback=got.tb is not None, run=got.run, **args)
    if not hasattr(fill_dp, "device_plan"):
        return lambda: kernels.fill(tab, codes1, codes2, got.desc, got.tb,
                                    carry, got.stats, **kw)
    pools = 0 if got.tb is None else 1 if got.run is None else 2
    plan = plan or fill_dp.device_plan(chunks, pools, dev)
    return lambda: fill_dp.launch(plan, tab, codes1, codes2, got.desc,
                                  got.tb, carry, got.stats, **kw)


def bucketed(pairs, sm):
    """``pairs`` (two sequences each) as BatchAligner buckets them: one
    uint8 chunk a bucket of ``sm``'s codes."""
    import numpy as np

    from smithwaterman_tpu_torch.batch_aligner import _Bucket
    from smithwaterman_tpu_torch.config import bucket_len

    buckets = {}
    for a, b in pairs:
        key = (bucket_len(len(a)), bucket_len(len(b)))
        bk = buckets.setdefault(key, _Bucket(*key))
        bk.indices.append(len(bk.indices))
        bk.codes1.append(sm.seq_to_index(a))
        bk.codes2.append(sm.seq_to_index(b))
    return [buckets[k].chunk(np.uint8) for k in sorted(buckets)]


def one(tree: str) -> dict:
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import chip_smoke as cs
    from smithwaterman_tpu_torch import GLOBAL, GLOCAL, LOCAL, BatchAligner
    from smithwaterman_tpu_torch.matrices import SubstitutionMatrix
    from smithwaterman_tpu_torch.ops import batch, device_walk, fill_dp
    from smithwaterman_tpu_torch.ops import kernels

    if not fill_dp.__file__.startswith(tree):
        raise SystemExit(f"imported {fill_dp.__file__}, not {tree}")
    t0 = time.perf_counter()
    kernels.build()
    kernels.lib()
    out = {"tree": tree, "build_s": time.perf_counter() - t0}
    dev = torch.device("cuda:0")
    modes = [(LOCAL, "local"), (GLOCAL, "glocal"), (GLOBAL, "global")]
    pairs = cs.main_path_pairs()
    for mode, mname in modes:
        eng = BatchAligner(mode=mode, device="cuda")
        eng.align_pairs(pairs)
        walls = []
        for _ in range(REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.align_pairs(pairs)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        out[f"wall_{mname}_s"] = statistics.median(walls)
        out[f"walls_{mname}_s"] = walls

    sm = SubstitutionMatrix.blosum62()
    chunks = bucketed([(a.seq, b.seq) for a, b in pairs], sm)
    tab = torch.from_numpy(np.asarray(sm.table, np.float32)).to(dev)
    nm = [(torch.from_numpy(ch.n).to(dev), torch.from_numpy(ch.m).to(dev))
          for ch in chunks]
    L = max(device_walk.max_path_len(NP, MP)
            for _, NP, MP in (ch.shape for ch in chunks))
    dig = {}

    def timed_fill(runs=False, score_only=False, cks=chunks, plan=None,
                   **args):
        got = fill_dp.fill_many(tab, cks, runs=runs, score_only=score_only,
                                **args)
        run = relauncher(fill_dp, kernels, tab, cks, got, plan, **args)
        run()
        ms, _ = cs.timed(run, REPS)
        return ms, got

    def every_pair_at(cks, R, NW):
        """One launch of every pair of ``cks`` at R rows a lane, NW warps
        a pair."""
        order = torch.arange(sum(ch.shape[0] for ch in cks),
                             dtype=torch.int32, device=dev)
        return [(R, NW, order)]

    for mode, mname in modes:
        args = dict(mode=mode, og=-10.0, eg=-0.5)
        out[f"k1_{mname}_ms"], got = timed_fill(**args)
        dig[f"tb_{mname}"] = short([digest(got.tb_view(c), *nm[c])
                                    for c in range(len(chunks))])
        dig[f"stats_{mname}"] = short(got.stats.cpu().numpy())
        if mode == LOCAL:
            # the walk order, where the tree's fill makes one
            kw = ({"order": got.order} if getattr(got, "order", None)
                  is not None else {})
            device_walk.walk_packed(got.tb, got.desc, got.stats, mode=mode,
                                    L=L, **kw)
            out["k2_local_ms"], (cnt, mv) = cs.timed(
                lambda: device_walk.walk_packed(got.tb, got.desc, got.stats,
                                                mode=mode, L=L, **kw), 5)
            dig["k2_local"] = short(cnt.cpu().numpy()) + short(
                mv.cpu().numpy())
        del got
        out[f"k10_{mname}_ms"], got = timed_fill(runs=True, **args)
        dig[f"run_{mname}"] = short([digest(got.tb_view(c, got.run), *nm[c])
                                     for c in range(len(chunks))])
        dig[f"tb10_{mname}"] = short([digest(got.tb_view(c), *nm[c])
                                      for c in range(len(chunks))])
        dig[f"stats10_{mname}"] = short(got.stats.cpu().numpy())
        del got
    if hasattr(fill_dp, "device_plan"):
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        # the stripe depth: K1 and K10 (LOCAL) with every pair at one R,
        # one warp a pair, each output equal to the launcher's choice's
        for pools in (0, 1, 2):
            out[f"plan_pools{pools}"] = [
                (R, NW, len(o))
                for R, NW, o in fill_dp.launch_plan(chunks, pools, sms)]
        same = True
        for R in fill_dp.STRIPE_R:
            for runs in (False, True):
                ms, got = timed_fill(runs=runs, mode=LOCAL, og=-10.0,
                                     eg=-0.5,
                                     plan=every_pair_at(chunks, R, 1))
                out[f"k{10 if runs else 1}_local_r{R}_ms"] = ms
                same &= short([digest(got.tb_view(c, got.run), *nm[c])
                               for c in range(len(chunks))]) == \
                    dig["run_local" if runs else "tb_local"]
                del got
        out["every_r_equal"] = same
    out["k1_score_only_local_ms"], got = timed_fill(
        score_only=True, mode=LOCAL, og=-10.0, eg=-0.5)
    dig["stats_score_only_local"] = short(got.stats.cpu().numpy())
    del got

    rng = np.random.default_rng(cs.SEED)
    c1 = rng.integers(0, 20, size=(1, 4096)).astype(np.uint8)
    c2 = rng.integers(0, 20, size=(1, 4096)).astype(np.uint8)
    c2[0, :2000] = c1[0, 100:2100]
    big = batch.Chunk(c1, c2, np.array([cs.LONGEST], np.int32),
                      np.array([cs.LONGEST], np.int32))
    if hasattr(fill_dp, "device_plan"):
        # one pair at each R, one warp and a warp a stripe (as many as the
        # kernel's registers allow a block)
        for R in fill_dp.STRIPE_R:
            for NW in (1, min(32, -(-cs.LONGEST // (32 * R)))):
                out[f"k1_3685_r{R}_w{NW}_ms"], got = timed_fill(
                    cks=[big], plan=every_pair_at([big], R, NW), mode=LOCAL,
                    og=-10.0, eg=-0.5)
                del got
        # mid-size flushes, K1 and K10 (LOCAL): what the launcher picks,
        # and every pair at each R and warps a pair, each equal to the
        # launcher's bytes
        rng = np.random.default_rng(cs.SEED + 7)
        letters = np.array(list("ARNDCQEGHILKMFPSTWYV"))
        mid = {"p16": [("".join(rng.choice(letters, int(rng.integers(
                   1500, 4001)))), "".join(rng.choice(letters, int(
                       rng.integers(1500, 4001))))) for _ in range(16)],
               "p300": [(a.seq, b.seq) for a, b in pairs[:300]]}
        for name, ps in mid.items():
            cks = bucketed(ps, sm)
            mnm = [(torch.from_numpy(ch.n).to(dev),
                    torch.from_numpy(ch.m).to(dev)) for ch in cks]
            longest = max(int(ch.n.max()) for ch in cks)
            for runs in (False, True):
                k = f"{name}_k{10 if runs else 1}"
                out[f"{k}_plan"] = [
                    (R, NW, len(o)) for R, NW, o in
                    fill_dp.launch_plan(cks, 2 if runs else 1, sms)]
                out[f"{k}_ms"], got = timed_fill(
                    cks=cks, runs=runs, mode=LOCAL, og=-10.0, eg=-0.5)
                want = short([digest(got.tb_view(c, got.run), *mnm[c])
                              for c in range(len(cks))])
                del got
                for R in fill_dp.STRIPE_R:
                    S = -(-longest // (32 * R))
                    for NW in sorted({min(w, S) for w in (1, 2, 4, 8, 16,
                                                          32)}):
                        ms, got = timed_fill(
                            cks=cks, runs=runs, mode=LOCAL, og=-10.0,
                            eg=-0.5, plan=every_pair_at(cks, R, NW))
                        out[f"{k}_r{R}_w{NW}_ms"] = ms
                        out[f"{name}_equal"] = out.get(
                            f"{name}_equal", True) and short(
                            [digest(got.tb_view(c, got.run), *mnm[c])
                             for c in range(len(cks))]) == want
                        del got
    out["k1_3685_ms"], got = timed_fill(cks=[big], mode=LOCAL, og=-10.0,
                                        eg=-0.5)
    n1 = torch.tensor([cs.LONGEST], device=dev)
    dig["tb_3685"] = digest(got.tb_view(0), n1, n1)
    dig["stats_3685"] = short(got.stats.cpu().numpy())
    out["digest"] = dig
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
    digests = []
    for tree in sys.argv[1:]:
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--one", tree], stdout=subprocess.PIPE, text=True)
        rc |= p.returncode
        for line in p.stdout.splitlines():
            print(line, flush=True)
            if line.startswith("{"):
                digests.append(json.loads(line)["digest"])
    same = len(digests) == len(sys.argv) - 1 and all(
        d == digests[0] for d in digests)
    print(json.dumps({"trees": len(sys.argv) - 1, "digests_equal": same}),
          flush=True)
    return rc if same else (rc or 1)


if __name__ == "__main__":
    sys.exit(main())
