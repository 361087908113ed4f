#!/usr/bin/env python3
"""Time the PyTorch + CUDA port's main path on one NVIDIA card.

Run from the repository root on a machine with a card:

    python3 scripts/measure_torch.py [--reps 7] [--out measure.json]

The input is ``chip_smoke.py``'s main path (3200 protein pairs, lengths
uniform in 150..700 from ``numpy.random.default_rng(42)``, BLOSUM62,
go = 10, ge = 0.5).  Per mode it records, after one cold call:

* ``walls``: host seconds of ``--reps`` warm ``BatchAligner.align_pairs``
  calls (each ends with the results on the host), their median, and the
  median of each ``BatchAligner.phase`` entry;
* ``score_only``: host seconds of five warm ``score_pairs`` calls;
* ``power``: ``nvidia-smi`` samples of SM clock (MHz) and power draw (W)
  taken while the warm calls ran;
* one more call under ``torch.profiler``: its host wall, the device busy
  seconds (the union of kernel and copy intervals) and the device time of
  the top five device operations.

Plus the warm time of one single-pair ``Aligner.align`` on the card.
Imports nothing of JAX.  Exits non-zero without a card.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402  (the main path's input and the card line)


def _sample_power(stop: threading.Event, out: list) -> None:
    while not stop.is_set():
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits"],
            stdout=subprocess.PIPE, text=True, timeout=30)
        clock, power = (float(v) for v in r.stdout.split(","))
        out.append((clock, power))
        stop.wait(0.1)


def _busy_seconds(prof) -> float:
    """Union of the device intervals of a profiler trace, in seconds."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi <= end:
            continue
        busy += hi - max(lo, end)
        end = hi
    return busy / 1e6


def _top_device(prof, k=5):
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
        if t > 0:
            rows.append((e.key, float(t)))
    return sorted(rows, key=lambda r: -r[1])[:k]


def measure_mode(BatchAligner, mode, pairs, reps):
    import torch

    eng = BatchAligner(mode=mode, device="cuda")
    eng.align_pairs(pairs)  # cold: builds and first use of the shapes
    walls, phases, power = [], [], []
    stop = threading.Event()
    sampler = threading.Thread(target=_sample_power, args=(stop, power))
    sampler.start()
    try:
        for _ in range(reps):
            t0 = time.perf_counter()
            eng.align_pairs(pairs)
            walls.append(time.perf_counter() - t0)
            phases.append(dict(eng.phase))
    finally:
        stop.set()
        sampler.join()
    score_only = []
    for _ in range(5):
        t0 = time.perf_counter()
        eng.score_pairs(pairs)
        score_only.append(time.perf_counter() - t0)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        eng.align_pairs(pairs)
        profiled = time.perf_counter() - t0
    return {
        "walls": walls,
        "median": statistics.median(walls),
        "phase_median": {k: statistics.median(p[k] for p in phases)
                         for k in phases[0]},
        "score_only": score_only,
        "power": {"samples": len(power),
                  "sm_clock_mhz": [c for c, _ in power],
                  "power_w": [w for _, w in power]},
        "profiled_wall_s": profiled,
        "device_busy_s": _busy_seconds(prof),
        "top_device_us": _top_device(prof),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("measure_torch: no CUDA device", file=sys.stderr)
        return 1
    from smithwaterman_tpu_torch import (GLOBAL, GLOCAL, LOCAL, Aligner,
                                         BatchAligner)

    pairs = chip_smoke.main_path_pairs()
    rec = {"card": chip_smoke.card_line(),
           "device": torch.cuda.get_device_name(0),
           "pairs": len(pairs),
           "cells": sum(len(a.seq) * len(b.seq) for a, b in pairs)}
    for mode, name in ((LOCAL, "local"), (GLOCAL, "glocal"),
                       (GLOBAL, "global")):
        rec[name] = measure_mode(BatchAligner, mode, pairs, args.reps)
        print(name, json.dumps(rec[name]), flush=True)
    a, b = pairs[0]
    one = Aligner(device="cuda")
    one.align(a, b)
    singles = []
    for _ in range(5):
        t0 = time.perf_counter()
        one.align(a, b)
        singles.append(time.perf_counter() - t0)
    rec["single_pair"] = {"n": len(a.seq), "m": len(b.seq),
                          "median_s": statistics.median(singles)}
    line = json.dumps(rec)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
