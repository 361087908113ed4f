"""Observability: the program's spans and counters, and per-batch
throughput metrics.

The recorder.  ``BatchAligner`` opens a :func:`call` for every request and
a :func:`span` around each stage of its main path (encode, pack, plan,
table upload, each flush's dispatch, fill, walk, long-route groups, wait,
copy and rebuild); the kernel wrappers :func:`count` their launches, the
cells their launches lay out, the walks' steps and the host-device copies.

* A span always takes two ``time.time_ns()`` reads, and the enclosing
  call adds the span's time to its per-name totals (``Call.totals``, which
  ``BatchAligner.phase`` shows in seconds).  ``time.time_ns()`` is the
  clock ``torch.profiler`` stamps its events with, so the spans and the
  card's kernels of a profiled run share one timeline.
* A counter always adds to the process-wide registry (:func:`counter`).
* While a call is traced, it also keeps each span (name, start, end,
  parent, attributes) and its own counts, and once it ends it goes into a
  log of the last :data:`LOG_CALLS` calls (:func:`calls`).  A call is
  traced when a ``torch.profiler`` is recording as it starts, or when its
  caller asks (``BatchAligner`` does while a :class:`StatsCollector` is
  attached).  Spans are never entered into the profiler itself.

:func:`reset` empties the log and the registry.

The collector: DP cell-updates/s (GCUPS), aligned pairs/s and padding-waste
ratios per length bucket, a copy of ``smithwaterman_tpu.utils.metrics``
without its TPU probes, and the seconds by span name and the counts of the
calls it saw.  ``BatchAligner.stats`` takes a :class:`StatsCollector`.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch.autograd.profiler as _profiler

# calls the log keeps, the newest last
LOG_CALLS = 4096


@dataclass
class Span:
    """One span of a traced call: ``time.time_ns()`` at its start and end,
    ``parent`` the index in ``Call.spans`` of the span it opened in (None
    directly under the call)."""

    name: str
    start: int
    end: int
    parent: Optional[int]
    call: int
    attrs: dict


@dataclass
class Call:
    """One request: its id, ``time.time_ns()`` at its start and end, its
    attributes, the seconds by span name in ns (``totals``, always kept),
    and, when ``traced``, its spans in the order they opened and its
    counts."""

    id: int
    start: int
    attrs: dict
    traced: bool
    end: int = 0
    totals: Dict[str, int] = field(default_factory=dict)
    spans: List[Span] = field(default_factory=list)
    counts: Dict[str, int] = field(default_factory=dict)
    _open: List[int] = field(default_factory=list, repr=False)


_COUNTS: Dict[str, int] = {}
_LOG: deque = deque(maxlen=LOG_CALLS)
_IDS = itertools.count(1)
_local = threading.local()


def _current() -> Optional[Call]:
    stack = getattr(_local, "calls", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def call(trace: bool = False, **attrs):
    """A request: the root of its spans.  Yields the :class:`Call`, whose
    ``attrs`` the caller may add to; traced when ``trace`` or while a
    ``torch.profiler`` records."""
    c = Call(next(_IDS), time.time_ns(), attrs,
             trace or getattr(_profiler, "_is_profiler_enabled", False))
    stack = _local.__dict__.setdefault("calls", [])
    stack.append(c)
    try:
        yield c
    finally:
        stack.pop()
        c.end = time.time_ns()
        c.totals["call"] = c.end - c.start
        if c.traced:
            _LOG.append(c)


@contextlib.contextmanager
def span(name: str, **attrs):
    """A stage of the current call (nothing outside a call), with its
    attributes."""
    c = _current()
    t0 = time.time_ns()
    if c is None:
        yield
        return
    k = None
    if c.traced:
        k = len(c.spans)
        c.spans.append(Span(name, t0, 0, c._open[-1] if c._open else None,
                            c.id, attrs))
        c._open.append(k)
    try:
        yield
    finally:
        t1 = time.time_ns()
        c.totals[name] = c.totals.get(name, 0) + t1 - t0
        if k is not None:
            c.spans[k].end = t1
            c._open.pop()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``, and to the current call's counts
    while it is traced."""
    _COUNTS[name] = _COUNTS.get(name, 0) + n
    c = _current()
    if c is not None and c.traced:
        c.counts[name] = c.counts.get(name, 0) + n


def counter(name: str) -> int:
    """The process-wide count of ``name`` (0 before its first count)."""
    return _COUNTS.get(name, 0)


def calls() -> List[Call]:
    """The traced calls the log holds, oldest first."""
    return list(_LOG)


def reset() -> None:
    """Empty the log and zero every counter."""
    _LOG.clear()
    _COUNTS.clear()


# ---------------------------------------------------------------- collector
@dataclass
class BucketStat:
    np_pad: int
    mp_pad: int
    pairs: int = 0
    padded_pairs: int = 0
    true_cells: int = 0
    padded_cells: int = 0
    # wall seconds of the bucket's pairs where a caller times them apart
    # (the CLI's banded pairs); BatchAligner fills and walks whole flushes
    # and leaves it at 0.  Throughput comes from StatsCollector.run_seconds.
    inflight_seconds: float = 0.0

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
    # seconds by span name and counts of the calls seen (add_call)
    spans: Dict[str, float] = field(default_factory=dict)
    counters: Dict[str, int] = field(default_factory=dict)

    def bucket(self, np_pad: int, mp_pad: int) -> BucketStat:
        key = (np_pad, mp_pad)
        if key not in self.buckets:
            self.buckets[key] = BucketStat(np_pad, mp_pad)
        return self.buckets[key]

    def add_call(self, c: Call) -> None:
        """Add a finished call's span seconds, counts and wall."""
        for k, ns in c.totals.items():
            self.spans[k] = self.spans.get(k, 0.0) + ns * 1e-9
        for k, n in c.counts.items():
            self.counters[k] = self.counters.get(k, 0) + n
        self.run_seconds += (c.end - c.start) * 1e-9

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
            "spans": {k: round(v, 6) for k, v in sorted(self.spans.items())},
            "counters": dict(sorted(self.counters.items())),
        }

    def report(self) -> str:
        return json.dumps(self.summary())
