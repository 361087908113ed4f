"""One run of one cell: set-up, the measured window, the trace, the check.

``run.py`` is the command; this module does the work, so that the
harness's own tests can drive a whole run on the CPU.  Everything that
belongs to one configuration, traffic mix, metric or stage is found by
name: ``configs/<config>.json`` (through ``BENCHMARK.json``),
``traffic/<traffic>.json`` (and the generator it names),
``entries/<entry>.py`` and
``references/<reference>.py`` (named by the configuration),
``metrics/<metric>.py`` and ``stages/*.json``.

The window is a closed loop with one caller: the next call goes out once
the previous call's results are on the host.  It cycles through the
pool's batches and ends at the first call that completes after
``seconds``; rates are the work of every completed call over the time
from the window's start to that call's end.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import threading
import time
import traceback
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from . import check, devtrace, roofline, traffic

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PROGRAM_CSRC = os.path.join(ROOT, "smithwaterman_tpu_torch", "csrc")


def load_module(folder: str, name: str):
    """``<folder>/<name>.py`` of the benchmark, by file (names may hold
    dots and dashes)."""
    path = os.path.join(HERE, folder, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"swbench_{folder}_{name}".replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(root: str, workload: str):
    """(benchmark, cell, configuration, traffic mix) of ``workload``."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"swbench: no workload {workload!r} in "
                         f"BENCHMARK.json ({', '.join(cells)})")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(root, entry["file"])) as f:
        config = json.load(f)
    return bench, cell, config, traffic.load(cell["traffic"])


def metrics_of(bench: dict, workload: str, trace: bool) -> List[dict]:
    """The cell's metrics of the run's kind: end to end untraced, per
    layer traced; a metric with ``workloads`` only in the cells it names."""
    kind = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in kind if workload in m.get("workloads", [workload])]


@dataclass
class Call:
    """One call of the window: its batch, host clock at submit and at
    results, the program's phases, how many results came back (None when
    the call raised) and how many of them were empty, and the results at
    the sampled positions (``check.sample``) in the reference's form
    (``Entry.record``), the rest dropped as a caller would drop them."""

    batch: int
    t0: float
    t1: float
    phase: Dict[str, float]
    returned: Optional[int]
    empty: int = 0
    kept: List = field(default_factory=list)


@dataclass
class Context:
    """What a metric's reader reads (``metrics/<name>.py`` ``read``)."""

    config: dict
    batches: List
    cells: List[int]
    calls: List[Call]
    steps: Optional[Dict[int, int]]  # batch -> its results' walk steps
    t0: float
    t1: float
    setup_s: float
    peak_bytes: Optional[int]
    trace: Optional[devtrace.Trace] = None
    roofline: object = roofline
    notes: Dict[str, str] = field(default_factory=dict)


def say(*parts) -> None:
    print("swbench:", *parts, file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], stdout=subprocess.PIPE,
                         stderr=subprocess.DEVNULL, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"


class PowerSampler:
    """``nvidia-smi`` SM clock and power draw every ``period`` seconds,
    on a thread, while a ``with`` block runs (the traced run only)."""

    def __init__(self, period: float = 0.5):
        self.period, self.samples = period, []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def _loop(self):
        while not self._stop.is_set():
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader,nounits"], stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL, text=True, timeout=30)
            try:
                clock, power = (float(v) for v in
                                out.stdout.splitlines()[0].split(","))
                self.samples.append((clock, power))
            except (ValueError, IndexError):
                pass
            self._stop.wait(self.period)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=60)


class Collections:
    """The garbage collector's passes while a ``with`` block runs: their
    count and seconds by generation."""

    def __init__(self):
        self.count, self.seconds, self.longest = [0] * 3, [0.0] * 3, 0.0
        self._t = 0.0

    def _note(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
            return
        dt, g = time.perf_counter() - self._t, info["generation"]
        self.count[g] += 1
        self.seconds[g] += dt
        self.longest = max(self.longest, dt)

    def __enter__(self):
        gc.callbacks.append(self._note)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._note)

    def __str__(self):
        return ", ".join(f"generation {g}: {n} in {1e3 * t:.3f} ms"
                         for g, (n, t) in enumerate(zip(self.count,
                                                        self.seconds))
                         ) + f"; longest {1e3 * self.longest:.3f} ms"


def window(entry, batches: Sequence, seconds: float,
           picks: Dict[int, List[int]], spans=None):
    """The closed loop: (calls, t0, t1, the traceback of a call that
    raised).  A call's sampled results are kept as plain tuples, one
    object for each distinct result, so that what the window keeps
    neither grows the memory by a copy a call nor gives the garbage
    collector more to scan."""
    import contextlib

    calls: List[Call] = []
    seen: Dict[tuple, tuple] = {}
    span = spans or (lambda name: contextlib.nullcontext())
    error = None
    t0 = t1 = time.perf_counter()
    with span("window"):
        k = 0
        while True:
            b = k % len(batches)
            c0 = time.perf_counter()
            try:
                with span("call"):
                    res = entry(batches[b])
            except Exception:  # the program failed: record it and stop
                error = traceback.format_exc()
                t1 = time.perf_counter()
                calls.append(Call(b, c0, t1, {}, None))
                break
            t1 = time.perf_counter()
            n = len(res)
            kept = []
            for i in picks[b]:
                r = res[i] if i < n else None
                if r is not None:
                    r = entry.record(r)
                    r = seen.setdefault(r, r)
                kept.append(r)
            calls.append(Call(b, c0, t1, entry.phase(), n,
                              sum(r is None for r in res), kept))
            del res
            k += 1
            if t1 - t0 >= seconds:
                break
    return calls, t0, t1, error


def run(bench: dict, cell: dict, config: dict, spec: dict, seed: int,
        seconds: float, trace: bool, device: str = "cuda",
        clock0: Optional[float] = None) -> dict:
    """One run of ``cell``; returns the result line's object."""
    import torch

    clock0 = time.perf_counter() if clock0 is None else clock0
    on_card = device.startswith("cuda")
    marks = [("imports", time.perf_counter())]
    if on_card:
        torch.cuda.init()
        marks.append(("cuda", time.perf_counter()))
    batches = traffic.pool(spec, seed)
    cells = [traffic.cells(b) for b in batches]
    picks = check.sample(batches, spec["check_per_batch"], seed)
    marks.append(("inputs", time.perf_counter()))
    entry = load_module("entries", config["entry"]).Entry(config, device)
    steps: Optional[Dict[int, int]] = {}
    for k, b in enumerate(batches):  # every batch the window sends, once
        res = entry(b)
        got = [0 if r is None else entry.steps(p, entry.record(r))
               for p, r in zip(b, res)]
        if steps is not None and None not in got:
            steps[k] = sum(got)
        else:  # the entry's results hold no path
            steps = None
        del res
        marks.append((f"warm{k}", time.perf_counter()))
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - clock0
    say(f"{cell['name']}: seed {seed}, {len(batches)} batches of "
        f"{len(batches[0])} pairs, cells a batch {cells}; set-up "
        f"{setup_s:.3f} s: " + ", ".join(
            f"{name} {t - prev:.3f}" for (name, t), prev in
            zip(marks, [clock0] + [t for _, t in marks])))

    prof = None
    sampler = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if on_card:
            acts.append(ProfilerActivity.CUDA)
            sampler = PowerSampler().__enter__()
        prof = profile(activities=acts)
        with warnings.catch_warnings():  # one window, one cycle
            warnings.filterwarnings("ignore", "Profiler clears events")
            prof.__enter__()
        with entry.spans(devtrace.SPAN_PREFIX), Collections() as collected:
            calls, t0, t1, error = window(
                entry, batches, seconds, picks,
                lambda name: record_function(devtrace.SPAN_PREFIX + name))
        if on_card:
            torch.cuda.synchronize()
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", "Profiler clears events")
            prof.__exit__(None, None, None)
        if sampler is not None:
            sampler.__exit__()
    else:
        with Collections() as collected:
            calls, t0, t1, error = window(entry, batches, seconds, picks)
    peak = torch.cuda.max_memory_allocated() if on_card else None
    if error:
        say("the program raised in the window:\n" + error)

    ctx = Context(config, batches, cells, calls, steps, t0, t1, setup_s,
                  peak)
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell["chips"],
           "memory_peak_bytes": peak if on_card else 0}
    breakdown = None
    if prof is not None:
        t_read = time.perf_counter()
        ctx.trace = devtrace.read(prof.profiler.kineto_results.events(),
                                  devtrace.load_stages(),
                                  devtrace.program_kernels(PROGRAM_CSRC))
        dev["busy_s"] = ctx.trace.busy_s
        dev["window_s"] = ctx.trace.window_s
        breakdown = {"device_ops": ctx.trace.top_ops(),
                     "idle_gaps": ctx.trace.idle_by_span()}
        say(f"trace read in {time.perf_counter() - t_read:.3f} s: "
            f"{len(ctx.trace.ops)} device operations, busy "
            f"{ctx.trace.busy_s} s of {ctx.trace.window_s} s")
        for stage in sorted({op.stage for op in ctx.trace.ops}):
            say(f"stage {stage}: {ctx.trace.stage_seconds(stage)} s")
    metrics = {}
    for m in metrics_of(bench, cell["name"], trace):
        value = load_module("metrics", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    walls = sorted(c.t1 - c.t0 for c in calls)
    say(f"window {t1 - t0:.6f} s, {len(calls)} calls, call wall median "
        f"{statistics.median(walls) * 1e3:.3f} ms, min "
        f"{walls[0] * 1e3:.3f}, max {walls[-1] * 1e3:.3f} ms")
    if calls and calls[-1].phase:
        means = {k: statistics.fmean(c.phase.get(k, 0.0) for c in calls)
                 for k in calls[-1].phase}
        say("phase means (ms): " + ", ".join(
            f"{k} {1e3 * v:.3f}" for k, v in means.items()))
    slow = [(round(1e3 * (c.t1 - c.t0), 3), round(c.t0 - t0, 3))
            for c in sorted(calls, key=lambda c: c.t0 - c.t1)[:5]]
    say(f"slowest calls (ms, at s): {slow}; garbage collection in the "
        f"window: {collected}")
    if on_card:
        say(f"card {card_line()} (peaks {roofline.PEAK_FLOPS:g} FLOP/s, "
            f"{roofline.PEAK_BYTES:g} B/s at 700 W)")
    if sampler is not None and sampler.samples:
        clk = [c for c, _ in sampler.samples]
        pw = [p for _, p in sampler.samples]
        say(f"power: {len(pw)} samples, SM clock median "
            f"{statistics.median(clk)} MHz, draw median "
            f"{statistics.median(pw)} W, max {max(pw)} W")
    for name, note in ctx.notes.items():
        say(f"{name}: {note}")

    # the program's state goes before the reference runs on the device
    prof = ctx = None
    entry.close()
    del entry
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    used = sorted({c.batch for c in calls if c.returned is not None})
    todo = [(b, k) for b in used for k in picks[b]]
    t_ref = time.perf_counter()
    reference = load_module("references", config["reference"])
    ref = reference.align([batches[b][k] for b, k in todo], config, device)
    say(f"reference: {len(todo)} pairs in "
        f"{time.perf_counter() - t_ref:.3f} s")
    counts = check.compare(lambda r: reference.layers(config, r), calls,
                           [len(b) for b in batches], picks,
                           dict(zip(todo, ref)))
    failed_calls = sum(len(batches[c.batch]) for c in calls
                       if c.returned is None)
    correct = check.correct(counts) and error is None
    result = {
        "correct": correct,
        "attempted": sum(len(batches[c.batch]) for c in calls),
        "failed": failed_calls + counts["missing"],
        "metrics": metrics,
        "device": dev,
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["pairs_checked"] = counts["checked"]
    result["checks"] = {k: {"value": counts[k], "limit": lim}
                        for k, lim in check.LIMITS.items()}
    for k, lim in check.LIMITS.items():
        say(f"check {k} {counts[k]} limit {lim}")
    return result
