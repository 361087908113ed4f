"""The program's own call records, as a traced run's per-layer readers
select them.

While the profiler records, ``smithwaterman_tpu_torch`` logs each call it
serves (``smithwaterman_tpu_torch.utils.metrics.calls()``): its id, start
and end, its spans (name, start, end, parent, attributes) and its counts
(``launch.K1`` ..., ``cells.true``, ``cells.computed.<K>``,
``walk.steps``, ``copy.h2d`` / ``copy.d2h`` and their bytes).  Their times
are ``time.time_ns()``, the clock the profiler stamps its events with, so
a record is placed against the trace's window and idle gaps directly.
A program without the recorder, or a run that logged nothing, gives
None, and its readers read nothing.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

NS = 1e-9


def window_calls(ctx) -> Optional[List]:
    """The program's call records whose start lies in the traced window
    (the warm-up calls come before it), oldest first; None without a
    trace or without records."""
    if ctx.trace is None:
        return None
    try:
        from smithwaterman_tpu_torch.utils import metrics
    except ImportError:
        return None
    log = getattr(metrics, "calls", None)
    if log is None:
        return None
    w0, w1 = ctx.trace.window
    got = [c for c in log() if w0 <= c.start * NS <= w1]
    return got or None


def span_seconds(call, name: str) -> float:
    """The seconds of a call's spans named ``name``."""
    return sum(s.end - s.start for s in call.spans if s.name == name) * NS


def innermost(call) -> List[Tuple[float, float, str]]:
    """The call's interval cut by the innermost of its spans open through
    each piece, in seconds: ``[(start, end, name)]`` in order, ``call``
    where no span below the call is open.  Spans nest."""
    marks = sorted([(s.start, 1, k) for k, s in enumerate(call.spans)] +
                   [(s.end, 0, k) for k, s in enumerate(call.spans)])
    out, stack, prev = [], [], call.start
    for t, opens, k in marks:
        if t > prev:
            out.append((prev * NS, t * NS,
                        call.spans[stack[-1]].name if stack else "call"))
            prev = t
        if opens:
            stack.append(k)
        elif k in stack:
            stack.remove(k)
    if call.end > prev:
        out.append((prev * NS, call.end * NS, "call"))
    return out


def idle_by_span(calls, gaps) -> Dict[str, float]:
    """The device's idle seconds inside ``calls`` (``gaps``: the trace's
    idle intervals, in order) by the innermost program span open
    through them (``call`` where none below the call is)."""
    ends = [hi for _, hi in gaps]
    total: Dict[str, float] = defaultdict(float)
    for c in calls:
        j = bisect.bisect_right(ends, c.start * NS)
        segs = innermost(c)
        for lo, hi in gaps[j:]:
            if lo >= c.end * NS:
                break
            for s0, s1, name in segs:
                d = min(hi, s1) - max(lo, s0)
                if d > 0:
                    total[name] += d
    return dict(total)
