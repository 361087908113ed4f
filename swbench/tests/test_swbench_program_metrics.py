"""The readers of the program's own spans and counters (``copyback_ms``,
``host_stall_ms``, ``fill_useful_pct``, ``launches_per_call``) on a
synthetic trace and synthetic call records, and on a traced CPU run."""

import pytest
from torch.autograd import DeviceType

from swbench import devtrace, harness, progtrace

CPU, CUDA = DeviceType.CPU, DeviceType.CUDA
US = 1000  # ns


class Ev:
    """A raw profiler event as ``kineto_results.events()`` gives it."""

    def __init__(self, name, kind, start_us, end_us):
        self._n, self._k = name, kind
        self._s, self._d = start_us * US, (end_us - start_us) * US

    def name(self):
        return self._n

    def device_type(self):
        return self._k

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d


def trace():
    """A window of 1000 us, the device busy 200-500 (a fill) and 560-600
    (the copy back): idle 0-200, 500-560 and 600-1000."""
    return devtrace.read([
        Ev("swbench.window", CPU, 0, 1000),
        Ev("void fill_kernel<unsigned char, 4>(float const*, int)", CUDA,
           200, 500),
        Ev("Memcpy DtoH (Device -> Pageable)", CUDA, 560, 600),
    ], {"fill_kernel": "fill"}, [])


def record(cid, start, end, spans, counts):
    """A call record in the program's form (``utils.metrics.Call``), from
    ``spans`` [(name, start us, end us, parent index, attrs)]."""
    from smithwaterman_tpu_torch.utils import metrics

    c = metrics.Call(cid, start * US, {"pairs": 1}, True, end * US)
    c.spans = [metrics.Span(n, s * US, e * US, p, cid, a)
               for n, s, e, p, a in spans]
    c.counts = dict(counts)
    return c


def calls():
    """A warm-up call before the window and one call of 100-900 us."""
    tree = [
        ("bucket", 100, 190, None, {}),
        ("encode", 100, 150, 0, {}),
        ("plan", 150, 190, 0, {}),
        ("flush", 190, 880, None, {"route": "ordinary"}),
        ("dispatch", 190, 210, 3, {}),
        ("fill", 195, 205, 4, {}),
        ("gather", 500, 610, 3, {}),
        ("wait", 500, 560, 6, {}),
        ("copy", 560, 600, 6, {"bytes": 4096}),
        ("reconstruct", 620, 870, 3, {}),
    ]
    counts = {"launch.K1": 2, "launch.K2": 1, "cells.true": 50,
              "cells.computed.K1": 80, "walk.steps": 9}
    return [record(1, -500, -100, tree[:1], counts),
            record(2, 100, 900, tree, counts)]


@pytest.fixture
def program(monkeypatch):
    from smithwaterman_tpu_torch.utils import metrics

    log = calls()
    monkeypatch.setattr(metrics, "calls", lambda: list(log))
    return log


def context():
    ctx = harness.Context({"mode": "glocal"}, [], [], [], None, 0.0, 1e-3,
                          1.0, None)
    ctx.trace = trace()
    return ctx


def read(name, ctx):
    return harness.load_module("metrics", name).read(ctx)


def test_window_calls_leave_out_the_warm_up(program):
    ctx = context()
    assert [c.id for c in progtrace.window_calls(ctx)] == [2]
    ctx.trace = None
    assert progtrace.window_calls(ctx) is None


def test_innermost_span_cuts_the_call(program):
    segs = progtrace.innermost(program[1])
    assert segs[0] == (pytest.approx(100e-6), pytest.approx(150e-6),
                       "encode")
    assert [name for *_, name in segs] == [
        "encode", "plan", "dispatch", "fill", "dispatch", "flush", "wait",
        "copy", "gather", "flush", "reconstruct", "flush", "call"]
    assert segs[-1][1] == pytest.approx(900e-6)


def test_program_readers(program):
    ctx = context()
    assert read("copyback_ms", ctx) == pytest.approx(0.04)
    assert "4096 bytes a call" in ctx.notes["copyback_ms"]
    assert "0.060 ms" in ctx.notes["copyback_ms"]
    # idle inside the call: 100-200, 500-560, 600-900
    assert read("host_stall_ms", ctx) == pytest.approx(0.46)
    idle = progtrace.idle_by_span(program[1:], ctx.trace.gaps)
    assert idle == {k: pytest.approx(v * 1e-6) for k, v in {
        "encode": 50, "plan": 40, "dispatch": 5, "fill": 5, "wait": 60,
        "gather": 10, "flush": 20, "reconstruct": 250, "call": 20}.items()}
    note = ctx.notes["host_stall_ms"]
    assert note.startswith("idle ms a call by span: reconstruct 0.250")
    assert note.endswith("under a span below call 95.65 %")
    assert read("fill_useful_pct", ctx) == pytest.approx(62.5)
    assert read("launches_per_call", ctx) == pytest.approx(3.0)
    assert ctx.notes["launches_per_call"] == "K1 2.000, K2 1.000"


def test_program_readers_find_nothing_without_records(monkeypatch):
    """No trace, no call in the window, no recorder in the program (as
    before it had one), or no counts of a kind: nothing, and no error."""
    from smithwaterman_tpu_torch.utils import metrics

    names = ("copyback_ms", "host_stall_ms", "fill_useful_pct",
             "launches_per_call")
    monkeypatch.setattr(metrics, "calls", lambda: calls()[:1])
    assert all(read(n, context()) is None for n in names)
    monkeypatch.delattr(metrics, "calls")
    assert all(read(n, context()) is None for n in names)
    quiet = calls()[1:]
    quiet[0].counts = {}
    monkeypatch.setattr(metrics, "calls", lambda: quiet, raising=False)
    ctx = context()
    assert read("fill_useful_pct", ctx) is None
    assert read("launches_per_call", ctx) is None
    assert read("host_stall_ms", ctx) == pytest.approx(0.46)
    ctx.trace = None
    assert all(read(n, ctx) is None for n in names)


def test_traced_cpu_run_reads_the_programs_spans():
    """A whole traced run on the CPU: the program logs its calls and the
    span readers read them; the plain versions launch nothing, so the
    counter readers find nothing."""
    from test_swbench_faults import run

    r = run("needle_genome_30k", trace=True)
    assert r["correct"]
    got = r["metrics"]
    assert {"copyback_ms", "host_stall_ms"} <= set(got)
    assert not {"fill_useful_pct", "launches_per_call"} & set(got)
    assert got["host_stall_ms"]["value"] > 0
