"""Observability: per-batch throughput metrics.

A copy of ``smithwaterman_tpu.utils.metrics`` without its TPU probes: DP
cell-updates/s (GCUPS), aligned pairs/s and padding-waste ratios per
length bucket.  ``BatchAligner.stats`` takes a :class:`StatsCollector`.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Dict


@dataclass
class BucketStat:
    np_pad: int
    mp_pad: int
    pairs: int = 0
    padded_pairs: int = 0
    true_cells: int = 0
    padded_cells: int = 0
    # Per-bucket wall intervals (kept for report parity with the JAX
    # package; the GPU path fills and walks whole flushes, so it leaves
    # them at 0).  Throughput comes from StatsCollector.run_seconds.
    inflight_seconds: float = 0.0
    walk_seconds: float = 0.0

    @property
    def padding_waste(self) -> float:
        return 1.0 - self.true_cells / self.padded_cells if self.padded_cells else 0.0


@dataclass
class StatsCollector:
    buckets: Dict[tuple, BucketStat] = field(default_factory=dict)
    wall_start: float = field(default_factory=time.time)
    # Non-overlapped engine wall: BatchAligner accumulates each call's
    # elapsed time here.  This is the denominator for every throughput
    # number.
    run_seconds: float = 0.0

    def bucket(self, np_pad: int, mp_pad: int) -> BucketStat:
        key = (np_pad, mp_pad)
        if key not in self.buckets:
            self.buckets[key] = BucketStat(np_pad, mp_pad)
        return self.buckets[key]

    # ------------------------------------------------------------------
    @property
    def pairs(self) -> int:
        return sum(b.pairs for b in self.buckets.values())

    @property
    def true_cells(self) -> int:
        return sum(b.true_cells for b in self.buckets.values())

    @property
    def padded_cells(self) -> int:
        return sum(b.padded_cells for b in self.buckets.values())

    @property
    def inflight_seconds(self) -> float:
        return sum(b.inflight_seconds for b in self.buckets.values())

    def summary(self) -> dict:
        wall = time.time() - self.wall_start
        # run_seconds is the honest denominator (engine-busy wall, no
        # overlap double-count); fall back to collector-lifetime wall for
        # consumers that fill BucketStats by hand
        busy = self.run_seconds or wall
        return {
            "pairs": self.pairs,
            "wall_seconds": round(wall, 4),
            "run_seconds": round(self.run_seconds, 4),
            "inflight_seconds": round(self.inflight_seconds, 4),
            "pairs_per_second": round(self.pairs / busy, 2) if busy else 0.0,
            "true_gcups": self.true_cells / busy / 1e9 if busy else 0.0,
            "padded_gcups": self.padded_cells / busy / 1e9 if busy else 0.0,
            "padding_waste": round(
                1.0 - self.true_cells / self.padded_cells, 4
            ) if self.padded_cells else 0.0,
            "buckets": {
                f"{k[0]}x{k[1]}": {
                    "pairs": b.pairs,
                    "padded_pairs": b.padded_pairs,
                    "padding_waste": round(b.padding_waste, 4),
                    "inflight_seconds": round(b.inflight_seconds, 4),
                }
                for k, b in sorted(self.buckets.items())
            },
        }

    def report(self) -> str:
        return json.dumps(self.summary())
