"""The trace reader and every metric's reader, on synthetic inputs."""

import os

import pytest
from torch.autograd import DeviceType

from swbench import devtrace, harness, roofline

from conftest import ROOT

CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


class Ev:
    """A raw profiler event as ``kineto_results.events()`` gives it."""

    def __init__(self, name, kind, start_us, end_us):
        self._n, self._k = name, kind
        self._s = int(start_us * 1000)
        self._d = int((end_us - start_us) * 1000)

    def name(self):
        return self._n

    def device_type(self):
        return self._k

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d


def events():
    """A window of 1000 us: one call (100-900) whose fill_many and
    reconstruct_packed spans hold a fill kernel, a walk kernel, a copy
    and PyTorch's own kernel, with a span's shadow on the device."""
    return [
        Ev("swbench.window", CPU, 0, 1000),
        Ev("swbench.call", CPU, 100, 900),
        Ev("swbench.fill_many", CPU, 150, 200),
        Ev("swbench.reconstruct_packed", CPU, 700, 850),
        Ev("swbench.call", CUDA, 100, 900),
        Ev("void fill_kernel<unsigned char, 4>(float const*, int)", CUDA,
           200, 500),
        Ev("void (anonymous namespace)::walk_kernel<2>(int)", CUDA,
           500, 550),
        Ev("Memcpy DtoH (Device -> Pageable)", CUDA, 560, 600),
        Ev("void at::native::vectorized_elementwise_kernel<4>(int)", CUDA,
           590, 620),
        Ev("aten::copy_", CPU, 560, 600),
        Ev("void fill_kernel<unsigned char, 4>(float const*, int)", CUDA,
           1200, 1300),  # after the window
    ]


STAGES = {"fill_kernel": "fill", "walk_kernel": "walk"}


def test_trace_reading():
    tr = devtrace.read(events(), STAGES, ["fill_kernel", "walk_kernel"])
    assert tr.window_s == pytest.approx(1e-3)
    assert tr.busy_s == pytest.approx(410e-6)
    assert tr.stage_seconds("fill") == pytest.approx(300e-6)
    assert tr.stage_seconds("walk") == pytest.approx(50e-6)
    assert tr.stage_seconds("other") == pytest.approx(70e-6)
    top = tr.top_ops()
    assert top[0] == ["fill:fill_kernel", pytest.approx(300e-6)]
    assert ["walk:walk_kernel", pytest.approx(50e-6)] in top
    idle = dict(tr.idle_by_span())
    # idle: 0-200, 550-560 and 620-1000, cut by the innermost open span
    assert idle["harness"] == pytest.approx(200e-6)   # 0-100, 900-1000
    assert idle["fill_many"] == pytest.approx(50e-6)  # 150-200
    assert idle["call"] == pytest.approx((50 + 10 + 80 + 50) * 1e-6)
    assert idle["reconstruct_packed"] == pytest.approx(150e-6)
    assert sum(idle.values()) == pytest.approx(tr.window_s - tr.busy_s)


def test_unnamed_program_kernel_stops_the_run():
    with pytest.raises(ValueError, match="walk_kernel"):
        devtrace.read(events(), {"fill_kernel": "fill"},
                      ["fill_kernel", "walk_kernel"])
    with pytest.raises(ValueError, match="window"):
        devtrace.read(events()[1:], STAGES, [])


def test_stage_files_name_every_program_kernel():
    stages = devtrace.load_stages()
    known = devtrace.program_kernels(
        os.path.join(ROOT, "smithwaterman_tpu_torch", "csrc"))
    assert len(known) >= 11
    assert set(known) <= set(stages)
    assert stages["fill_kernel"] == "fill"
    assert stages["seg_walk_kernel"] == "walk"


def context(trace=True):
    batches = [[("ACGT", "AGT"), ("AAAA", "AAAA")]]
    calls = [harness.Call(0, 0.0, 0.2, {"bucket": 0.01, "reconstruct": 0.02},
                          2),
             harness.Call(0, 0.2, 0.6, {"bucket": 0.03, "reconstruct": 0.04},
                          2)]
    config = {"mode": "glocal", "matrix": {"letters": "ACGT"}}
    ctx = harness.Context(config, batches, [28], calls, {0: 8}, 0.0,
                          0.6, 7.5, 2_500_000_000)
    if trace:
        ctx.trace = devtrace.read(events(), STAGES, [])
    return ctx


def read(name, ctx):
    return harness.load_module("metrics", name).read(ctx)


def test_end_to_end_readers():
    ctx = context()
    assert read("gcups", ctx) == pytest.approx(56 / 0.6 / 1e9)
    assert read("call_p95_ms", ctx) == pytest.approx(
        (0.2 + 0.95 * (0.4 - 0.2)) * 1e3)
    assert read("peak_mem_gb", ctx) == 2.5
    assert read("setup_s", ctx) == 7.5


def test_per_layer_readers():
    ctx = context()
    assert read("bucket_ms", ctx) == pytest.approx(20.0)
    assert read("rebuild_ms", ctx) == pytest.approx(30.0)
    assert read("device_idle_pct", ctx) == pytest.approx(59.0)
    ops, nbytes = roofline.fill_work(
        "glocal", [(4, 3), (4, 4)] * 2, 4, 2)
    least, _ = roofline.least(ops, nbytes)
    assert read("fill_roofline_pct", ctx) == pytest.approx(
        100 * least / 300e-6)
    steps = 2 * (4 + 4)
    least, _ = roofline.least(*roofline.walk_work(steps))
    assert read("walk_roofline_pct", ctx) == pytest.approx(
        100 * least / 50e-6)


def test_readers_without_a_trace_find_nothing():
    ctx = context(trace=False)
    for name in ("fill_roofline_pct", "walk_roofline_pct",
                 "device_idle_pct"):
        assert read(name, ctx) is None
    ctx.peak_bytes = None
    assert read("peak_mem_gb", ctx) is None
    ctx = context()
    ctx.steps = None  # an entry whose results hold no path
    assert read("walk_roofline_pct", ctx) is None


def test_benchmark_json_follows_the_contract():
    """Every metric has a reader, every per-layer metric's cells report
    the end-to-end metric it moves, and every name keeps to the allowed
    characters."""
    import json
    import re

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"] for w in bench["workloads"]}
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    reports = {c: {m["name"] for m in bench["end_to_end"]
                   if c in m.get("workloads", cells)} for c in cells}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert name.match(m["name"])
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert hasattr(harness.load_module("metrics", m["name"]), "read")
    for m in bench["per_layer"]:
        for c in m["workloads"]:
            assert m["moves"] in reports[c], (m["name"], c)
    for c in cells:
        assert "setup_s" in reports[c] and len(reports[c]) >= 2
    for w in bench["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] == 1
        assert os.path.exists(os.path.join(ROOT, "swbench", "traffic",
                                           w["traffic"] + ".json"))


def test_window_keeps_one_record_a_distinct_result():
    """The window keeps each call's sampled results in the reference's
    form, one object for equal results of different calls, and drops
    the rest."""
    class Res:
        def __init__(self, s):
            self.s = s

    class Entry:
        made = 0

        def __call__(self, batch):
            Entry.made += 1
            return [Res("x" * (3 + k)) for k in range(len(batch))]

        @staticmethod
        def record(r):
            return (r.s + "",)

        def phase(self):
            return {"bucket": 0.0}

    batches = [[("A", "C")] * 4, [("G", "T")] * 3]
    calls, t0, t1, error = harness.window(Entry(), batches, 0.0005,
                                          {0: [1, 3], 1: [0, 5]})
    while len(calls) < 4:  # a window too short for two cycles: again
        calls, t0, t1, error = harness.window(Entry(), batches, 0.01,
                                              {0: [1, 3], 1: [0, 5]})
    assert error is None and t1 >= t0
    assert [c.batch for c in calls[:4]] == [0, 1, 0, 1]
    assert calls[0].kept == [("xxxx",), ("xxxxxx",)]
    assert calls[1].kept == [("xxx",), None]  # past the call's results
    assert calls[2].kept[0] is calls[0].kept[0]
    assert calls[3].kept[0] is calls[1].kept[0]
