#!/usr/bin/env python3
"""Time ``BatchAligner.align_pairs`` on each route, flush by flush size, on
one card: the table that sets the occupancy rule (``ops/batch.
occupancy_long``).

Usage, on a machine with an NVIDIA card::

    python3 scripts/ab_route.py [--modes glocal,local]
        [--pairs 1,2,4,8,16,32,64,128] [--lengths 2000,4000,8000,16000,29903]
        [--out ab_route.jsonl]

For each mode, length L and count P, P DNA pairs of L bp a side (a random
sequence against a copy with 1 % substitutions and, every 1000 bp, an
indel of 1..20 paired with one of its length 50 bp on, so every pair
shares one bucket), EMBOSS needle's DNA scoring (+5 / -4, 10.0 / 0.5),
one call of P pairs on each route:

* ``k1``: the ordinary route (K1, K2), the occupancy rule off (the card's
  SM count given to the planner as 0);
* ``long``: the long route (K3, K4, K5) for every bucket
  (``longseq_cells=1``);
* ``rule``: the engine as it stands.

Each route's call runs once untimed, then is timed (host clock around the
call, which returns host results) up to three times while its calls take
under 2 s together.  A line a shape: each route's median and spread of
the wall (ms), Gcells/s (true cells over the median wall), flushes, and
whether the rule's flushes were long; ``equal`` says every route gave
the same strings, scores and spans.  The card's name and power limit
come first.
"""

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

ACGT = "ACGT"


def pair(L: int, rng):
    """A random L-bp sequence and a mutated copy of the same length."""
    a = rng.integers(0, 4, size=L)
    b = a.copy()
    sub = rng.random(L) < 0.01
    b[sub] = rng.integers(0, 4, size=int(sub.sum()))
    b = b.tolist()
    for at in range(1000, L - 100, 1000):
        d = int(rng.integers(1, 21))
        del b[at:at + d]
        b[at + 50:at + 50] = rng.integers(0, 4, size=d).tolist()
    return ("".join(ACGT[c] for c in a), "".join(ACGT[c] for c in b))


def timed_calls(fn):
    fn()
    walls, spent = [], 0.0
    while len(walls) < 3 and (not walls or spent < 2.0):
        t0 = time.perf_counter()
        res = fn()
        walls.append(time.perf_counter() - t0)
        spent += walls[-1]
    return walls, res


def digest(res) -> str:
    h = hashlib.sha256()
    for r in res:
        h.update(repr((r.aligned1, r.aligned2, r.score, r.start1, r.end1,
                       r.start2, r.end2)).encode())
    return h.hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--modes", default="glocal,local")
    ap.add_argument("--pairs", default="1,2,4,8,16,32,64,128")
    ap.add_argument("--lengths", default="2000,4000,8000,16000,29903")
    ap.add_argument("--out", default="ab_route.jsonl")
    args = ap.parse_args()

    import numpy as np
    import torch

    from smithwaterman_tpu_torch import GLOBAL, GLOCAL, LOCAL, BatchAligner
    from smithwaterman_tpu_torch.matrices import SubstitutionMatrix
    from smithwaterman_tpu_torch.ops import batch
    from smithwaterman_tpu_torch.utils import metrics

    if not torch.cuda.is_available():
        raise SystemExit("ab_route.py times the card: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], stdout=subprocess.PIPE,
                         text=True, check=True).stdout.strip(), flush=True)
    print(f"sms {batch.card_sms('cuda')}, rule: pairs * "
          f"{batch.OCCUPANCY_SHARE} <= sms and NP >= {batch.LONG_MIN_ROWS}",
          flush=True)
    modes = {"local": LOCAL, "glocal": GLOCAL, "global": GLOBAL}
    dna = SubstitutionMatrix.match_mismatch(5.0, -4.0)
    card_sms = batch.card_sms
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as out:
        for mname in args.modes.split(","):
            for L in (int(x) for x in args.lengths.split(",")):
                rng = np.random.default_rng(L)
                pool = [pair(L, rng) for _ in range(max(
                    int(x) for x in args.pairs.split(",")))]
                for P in (int(x) for x in args.pairs.split(",")):
                    pairs = pool[:P]
                    cells = sum(len(a) * len(b) for a, b in pairs)
                    row = {"mode": mname, "L": L, "pairs": P}
                    digests = set()
                    for route in ("k1", "long", "rule"):
                        eng = BatchAligner(
                            scoring_matrix=dna, gap_open=10.0,
                            gap_extend=0.5, mode=modes[mname], device="cuda",
                            longseq_cells=1 if route == "long" else None)
                        # a collector traces every call: its flushes and
                        # counts
                        eng.stats = metrics.StatsCollector()
                        if route == "k1":
                            batch.card_sms = lambda device: 0
                        try:
                            walls, res = timed_calls(
                                lambda: eng.align_pairs(pairs))
                        finally:
                            batch.card_sms = card_sms
                        last = metrics.calls()[-1]
                        med = statistics.median(walls)
                        row[route] = {
                            "ms": round(med * 1e3, 3),
                            "min_ms": round(min(walls) * 1e3, 3),
                            "max_ms": round(max(walls) * 1e3, 3),
                            "calls": len(walls),
                            "gcups": round(cells / med / 1e9, 4),
                            "flushes": last.attrs["flushes"],
                        }
                        if route == "rule":
                            row["rule_moved_pairs"] = last.counts.get(
                                "route.long.occupancy", 0)
                        digests.add(digest(res))
                        del eng
                        torch.cuda.empty_cache()
                    row["equal"] = len(digests) == 1
                    row["k1_over_long"] = round(
                        row["k1"]["ms"] / row["long"]["ms"], 4)
                    out.write(json.dumps(row) + "\n")
                    out.flush()
                    print(f"{mname:6s} L={L:6d} P={P:4d}  k1 "
                          f"{row['k1']['ms']:10.2f} ms  long "
                          f"{row['long']['ms']:10.2f} ms  rule "
                          f"{row['rule']['ms']:10.2f} ms  k1/long "
                          f"{row['k1_over_long']:7.3f}  moved "
                          f"{row['rule_moved_pairs']:4d}  equal "
                          f"{row['equal']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
