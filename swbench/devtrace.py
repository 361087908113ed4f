"""What the traced run reads from ``torch.profiler``: device time by
stage, the device's busy share, and the idle gaps by host span.

Device operations are sorted into stages by ``stages/*.json``, each file
naming kernels by their function name as the profiler prints it (``void
fill_kernel<...>(...)`` is ``fill_kernel``).  Every other device operation
(PyTorch's kernels, copies, fills) is in the stage ``other``.  A kernel of
the program's own CUDA sources (``smithwaterman_tpu_torch/csrc/*.cu``)
that no stage file names stops the run: it would otherwise go uncounted.
"""

from __future__ import annotations

import glob
import json
import os
import re
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
SPAN_PREFIX = "swbench."
WINDOW_SPAN = SPAN_PREFIX + "window"
_BASE = re.compile(r"([A-Za-z_]\w*)[<(]")
_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")


def kernel_base(name: str) -> Optional[str]:
    """The function name of a kernel as the profiler prints it, or None
    for a device operation that is not a kernel call (a copy, a fill)."""
    found = _BASE.search(name)
    return found.group(1) if found else None


def load_stages(folder: str = os.path.join(HERE, "stages")
                ) -> Dict[str, str]:
    """Kernel function name -> stage, from every stage file."""
    out: Dict[str, str] = {}
    for path in sorted(glob.glob(os.path.join(folder, "*.json"))):
        with open(path) as f:
            spec = json.load(f)
        for kernel in spec["kernels"]:
            if kernel in out:
                raise ValueError(f"{kernel} is in two stage files")
            out[kernel] = spec["stage"]
    return out


def program_kernels(csrc: str) -> List[str]:
    """The ``__global__`` functions of the program's CUDA sources."""
    names = set()
    for path in glob.glob(os.path.join(csrc, "*.cu")):
        with open(path) as f:
            names.update(_GLOBAL.findall(f.read()))
    return sorted(names)


@dataclass
class DeviceOp:
    name: str
    stage: str
    start: float  # seconds, on the profiler's clock
    end: float


@dataclass
class Span:
    name: str
    start: float
    end: float


@dataclass
class Trace:
    """A traced window: its device operations and host spans."""

    ops: List[DeviceOp]
    spans: List[Span]
    window: Tuple[float, float]
    gaps: List[Tuple[float, float]] = field(default_factory=list)
    busy_s: float = 0.0

    def __post_init__(self):
        w0, w1 = self.window
        busy, end = 0.0, w0
        for op in sorted(self.ops, key=lambda o: o.start):
            lo, hi = max(op.start, w0), min(op.end, w1)
            if hi <= end:
                continue
            lo = max(lo, end)
            if lo > end:
                self.gaps.append((end, lo))
            busy += hi - lo
            end = hi
        if end < w1:
            self.gaps.append((end, w1))
        self.busy_s = busy

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def stage_seconds(self, stage: str) -> float:
        return sum(op.end - op.start for op in self.ops if op.stage == stage)

    def top_ops(self, k: int = 10) -> List[List]:
        """The device operations that took most time, by name."""
        total: Dict[str, float] = defaultdict(float)
        for op in self.ops:
            base = kernel_base(op.name)
            label = (f"{op.stage}:{base}" if op.stage != "other" or base
                     else f"other:{op.name[:60]}")
            total[label] += op.end - op.start
        return [[n, t] for n, t in sorted(total.items(),
                                          key=lambda kv: -kv[1])[:k]]

    def idle_by_span(self, k: int = 10) -> List[List]:
        """Idle device time by the innermost host span open through it
        ("harness" where none is), largest first."""
        marks = sorted([(s.start, 1, i) for i, s in enumerate(self.spans)] +
                       [(s.end, 0, i) for i, s in enumerate(self.spans)])
        segs, stack, prev = [], [], float("-inf")
        for t, opens, i in marks:  # spans nest: a stack of open spans
            if t > prev:
                segs.append((prev, t, stack[-1] if stack else None))
                prev = t
            if opens:
                stack.append(i)
            elif i in stack:
                stack.remove(i)
        segs.append((prev, float("inf"), None))
        total: Dict[str, float] = defaultdict(float)
        j = 0
        for lo, hi in self.gaps:
            while segs[j][1] <= lo:
                j += 1
            for s0, s1, i in segs[j:]:
                if s0 >= hi:
                    break
                label = ("harness" if i is None else
                         self.spans[i].name[len(SPAN_PREFIX):])
                total[label] += min(hi, s1) - max(lo, s0)
        return [[n, t] for n, t in sorted(total.items(),
                                          key=lambda kv: -kv[1])[:k]]


def read(events: Iterable, stages: Dict[str, str],
         known: Iterable[str]) -> Trace:
    """A :class:`Trace` from the profiler's raw events
    (``prof.profiler.kineto_results.events()``: ``name()``,
    ``device_type()``, ``start_ns()``, ``duration_ns()``): device events
    by their device type, host spans by their ``swbench.`` names.  Raises
    ``ValueError`` for a kernel in ``known`` (the program's own) that no
    stage names, or when the window's span is missing."""
    from torch.autograd import DeviceType

    known = set(known)
    ops, spans, window = [], [], None
    for e in events:
        name, kind = e.name(), e.device_type()
        lo = e.start_ns() * 1e-9
        hi = lo + e.duration_ns() * 1e-9
        if name.startswith(SPAN_PREFIX) and kind != DeviceType.CPU:
            continue  # a host span's shadow on the device's timeline
        if kind == DeviceType.CUDA:
            base = kernel_base(name)
            stage = stages.get(base) if base else None
            if stage is None and base in known:
                raise ValueError(f"kernel {base} of the program is in no "
                                 f"stage file (swbench/stages/)")
            ops.append(DeviceOp(name, stage or "other", lo, hi))
        elif name == WINDOW_SPAN:
            window = (lo, hi)
        elif name.startswith(SPAN_PREFIX):
            spans.append(Span(name, lo, hi))
    if window is None:
        raise ValueError(f"the trace has no {WINDOW_SPAN} span")
    ops = [op for op in ops if op.end > window[0] and op.start < window[1]]
    return Trace(ops, spans, window)
