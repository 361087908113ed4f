#!/usr/bin/env python3
"""The control of ``correct``: the reference, computed in a lower
precision, put in the program's place.

    python3 swbench/control.py --workload <cell> --seeds <n> [<n> ...] \\
        [--dtype bfloat16]

For each seed it makes the cell's batches, draws the pairs a run would
check (every batch sent), works them out with the plain reference in
float32 and again in ``--dtype``, and puts the second in the program's
place: one call a batch, its sampled results held against the first by
the run's own comparison (``check.compare``, ``check.correct``).  It
prints one JSON line a seed: ``correct``, the pairs checked and each
count with its limit.  A sound comparison comes out not correct here.
The benchmark's own runs never run it.
"""

import argparse
import json
import os
import sys
import time


def control(cell: dict, config: dict, spec: dict, seed: int, dtype,
            device: str) -> dict:
    from swbench import check, harness, traffic

    batches = traffic.pool(spec, seed)
    picks = check.sample(batches, spec["check_per_batch"], seed)
    todo = [(b, k) for b in sorted(picks) for k in picks[b]]
    pairs = [batches[b][k] for b, k in todo]
    ref = harness.load_module("references", config["reference"])
    t0 = time.perf_counter()
    want = ref.align(pairs, config, device)
    t1 = time.perf_counter()
    got = dict(zip(todo, ref.align(pairs, config, device, dtype=dtype)))
    t2 = time.perf_counter()
    calls = [harness.Call(b, 0.0, 0.0, {}, len(batches[b]), 0,
                          [got[(b, k)] for k in picks[b]])
             for b in sorted(picks)]
    counts = check.compare(lambda r: ref.layers(config, r), calls,
                           [len(b) for b in batches], picks,
                           dict(zip(todo, want)))
    return {"workload": cell["name"], "seed": seed, "dtype": str(dtype),
            "correct": check.correct(counts), "checked": counts["checked"],
            "reference_s": t1 - t0, "control_s": t2 - t1,
            "checks": {k: {"value": counts[k], "limit": lim}
                       for k, lim in check.LIMITS.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import torch

    from swbench import harness

    if args.device == "cuda" and not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    _, cell, config, spec = harness.load_cell(root, args.workload)
    for seed in args.seeds:
        print(json.dumps(control(cell, config, spec, seed,
                                 getattr(torch, args.dtype), args.device)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
