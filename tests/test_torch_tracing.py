"""The port's recorder (``smithwaterman_tpu_torch/utils/metrics.py``): the
spans of ``BatchAligner``'s main path, their call id, nesting and totals,
when calls are logged, the clock they share with ``torch.profiler``, the
counters and the cells each fill kernel's launches lay out.  On the CPU;
``tests/test_torch_gpu.py`` holds the spans against a card's launches."""

import numpy as np
import pytest
import torch

from smithwaterman_tpu_torch import GLOBAL, GLOCAL, LOCAL, BatchAligner
from smithwaterman_tpu_torch.ops import batch, diag_dp, fill_dp, longseq
from smithwaterman_tpu_torch.parallel import DataParallel, make_mesh
from smithwaterman_tpu_torch.utils import metrics
from smithwaterman_tpu_torch.utils.metrics import StatsCollector

# each span of the main path and the span it opens in (None: the call)
PARENT = {
    "bucket": None, "encode": "bucket", "table": "bucket", "pack": "bucket",
    "plan": "bucket", "flush": None, "dispatch": "flush",
    "gather": "flush", "reconstruct": "flush", "fill": "dispatch",
    "walk": "dispatch", "long": "dispatch", "ckpt": "long",
    "group": "long", "wait": "gather", "copy": "gather",
}
# the spans under dispatch of each route
ROUTES = {"ordinary": {"fill", "walk"}, "tokens": {"fill", "walk"},
          "scores": {"fill"}, "sharded": {"fill"},
          "long": {"long", "ckpt", "group"}}


def _pairs(seed, count=6, lo=20, hi=90):
    rng = np.random.default_rng(seed)
    letters = np.array(list("ARNDCQEGHILKMFPSTWYV"))
    out = []
    for _ in range(count):
        a = "".join(rng.choice(letters, int(rng.integers(lo, hi))))
        b = "".join(rng.choice(letters, int(rng.integers(lo, hi))))
        out.append((a, b[:5] + a[3:40] + b[5:]))
    return out + [("", "ACD")]


def _engine(route, monkeypatch, mode=GLOCAL):
    if route == "tokens":
        monkeypatch.setenv("SWTPU_TOKEN_WALK", "1")
    if route == "long":
        # a band a group, so that a call walks several groups
        monkeypatch.setattr(longseq, "REFILL_BYTES", 1)
        return BatchAligner(mode=mode, device="cpu", longseq_cells=1)
    if route == "sharded":
        return BatchAligner(mode=mode, device_axis=DataParallel(
            make_mesh(devices=["cpu"] * 2)))
    return BatchAligner(mode=mode, device="cpu")


def _traced_call(route, monkeypatch, pairs, mode=GLOCAL):
    """One call of ``route`` with a collector attached: (engine, the
    call's record, the results)."""
    metrics.reset()
    ba = _engine(route, monkeypatch, mode)
    ba.stats = StatsCollector()
    if route == "scores":
        res = ba.score_pairs(pairs)
    else:
        res = ba.align_pairs(pairs)
    (call,) = metrics.calls()
    return ba, call, res


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_one_call_one_tree(route, monkeypatch):
    """Every span of a call carries its id, opens in the span of the
    layer map above it and lies inside it, and phase's four keys are
    their spans' totals."""
    long = route == "long"
    pairs = _pairs(3, count=2, lo=150, hi=300) if long else _pairs(3)
    ba, call, _ = _traced_call(route, monkeypatch, pairs)
    spans = call.spans
    assert {s.call for s in spans} == {call.id}
    names = {s.name for s in spans}
    assert {"bucket", "encode", "table", "pack", "plan", "flush",
            "dispatch", "gather", "copy", "reconstruct"} <= names
    assert names - set(PARENT) == set()
    assert names & {"fill", "walk", "long", "ckpt", "group"} == ROUTES[route]
    assert "wait" not in names  # the CPU has no stream to wait for
    for s in spans:
        assert call.start <= s.start <= s.end <= call.end, s.name
        up = None if s.parent is None else spans[s.parent]
        assert (up and up.name) == PARENT[s.name], s.name
        if up is not None:
            assert up.start <= s.start and s.end <= up.end, s.name
    flushes = [s for s in spans if s.name == "flush"]
    assert call.attrs == {"pairs": len(pairs), "flushes": len(flushes)}
    assert {s.attrs["route"] for s in flushes} == {route}
    assert sum(s.attrs["pairs"] for s in flushes) == len(pairs) - 1
    assert all(s.attrs["padded_cells"] > 0 for s in flushes)
    assert all((s.attrs["pointer_bytes"] > 0) == (route != "scores")
               for s in flushes)
    for key in ("bucket", "dispatch", "gather", "reconstruct"):
        total = sum(s.end - s.start for s in spans if s.name == key)
        assert ba.phase[key] == pytest.approx(total * 1e-9, abs=1e-12)
    assert ba.phase["call"] == pytest.approx((call.end - call.start) * 1e-9)
    assert ba.stats.summary()["spans"]["bucket"] == pytest.approx(
        ba.phase["bucket"], abs=1e-6)


def test_untraced_calls_are_not_logged():
    """Without a collector or a profiler the log stays empty and no call
    counts, while phase is filled and the registry counts."""
    metrics.reset()
    ba = BatchAligner(mode=LOCAL, device="cpu")
    pairs = _pairs(4)
    ba.align_pairs(pairs)
    assert metrics.calls() == []
    assert ba.phase["bucket"] > 0 and ba.phase["reconstruct"] > 0
    assert ba.phase["encode"] <= ba.phase["bucket"] <= ba.phase["call"]
    assert metrics.counter("cells.true") == sum(len(a) * len(b)
                                                for a, b in pairs)


def test_profiled_call_is_logged_on_the_profilers_clock():
    """Inside a profile the call is logged, its times inside the
    profiler's own stamps of a range opened around it, and none of the
    program's spans is entered into the profiler."""
    from torch.profiler import ProfilerActivity, profile, record_function

    metrics.reset()
    ba = BatchAligner(mode=GLOBAL, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("around"):
            ba.align_pairs(_pairs(5))
    (call,) = metrics.calls()
    events = list(prof.profiler.kineto_results.events())
    (ev,) = [e for e in events if e.name() == "around"]
    assert ev.start_ns() <= call.start < call.end <= (ev.start_ns() +
                                                      ev.duration_ns())
    assert not {e.name() for e in events} & (set(PARENT) | {"call"})
    # a call after the profile is not logged
    ba.align_pairs(_pairs(5))
    assert len(metrics.calls()) == 1


@pytest.mark.parametrize("mode", [LOCAL, GLOBAL])
def test_long_route_logs_its_groups(mode, monkeypatch):
    """A long-route call logs K3's span and a span a band group (one band
    each here, of at most C rows), and counts every pair's n * m."""
    pairs = _pairs(7, count=2, lo=300, hi=520)
    ba, call, res = _traced_call("long", monkeypatch, pairs, mode)
    names = [s.name for s in call.spans]
    assert names.count("ckpt") == names.count("flush") >= 1
    groups = [s for s in call.spans if s.name == "group"]
    assert len(groups) >= 2 * names.count("flush")
    assert max(s.attrs["rows"] for s in groups) == longseq.DEFAULT_CKPT_ROWS
    assert all(s.attrs["bands"] == 1 for s in groups)
    true = sum(len(a) * len(b) for a, b in pairs)
    assert call.counts["cells.true"] == true
    assert call.counts["walk.steps"] > 0
    assert ba.stats.summary()["counters"]["cells.true"] == true
    assert res == BatchAligner(mode=mode, device="cpu").align_pairs(pairs)


def test_reset_and_the_logs_bound():
    metrics.reset()
    for _ in range(metrics.LOG_CALLS + 3):
        with metrics.call(trace=True):
            metrics.count("x")
    log = metrics.calls()
    assert len(log) == metrics.LOG_CALLS
    assert [c.id for c in log] == list(range(log[0].id,
                                             log[0].id + len(log)))
    assert metrics.counter("x") == metrics.LOG_CALLS + 3
    assert log[-1].counts == {"x": 1}
    metrics.reset()
    assert metrics.calls() == [] and metrics.counter("x") == 0


def test_counters_and_spans_outside_and_inside_calls():
    """A count outside any call goes to the registry alone; a span there
    records nothing; an untraced call keeps totals but no spans or
    counts; calls nest, each keeping its own spans."""
    metrics.reset()
    metrics.count("launch.K1", 2)
    with metrics.span("fill", x=1):
        pass
    assert metrics.counter("launch.K1") == 2 and metrics.calls() == []
    with metrics.call() as quiet:
        metrics.count("launch.K1")
        with metrics.span("fill"):
            pass
    assert quiet.spans == [] and quiet.counts == {}
    assert set(quiet.totals) == {"fill", "call"}
    with metrics.call(trace=True, pairs=1) as outer:
        with metrics.span("flush", route="x"):
            with metrics.call(trace=True) as inner:
                with metrics.span("fill"):
                    metrics.count("launch.K2")
            with metrics.span("walk"):
                metrics.count("launch.K2", 3)
    assert metrics.counter("launch.K1") == 3
    assert [(s.name, s.parent) for s in outer.spans] == [("flush", None),
                                                         ("walk", 0)]
    assert [(s.name, s.parent) for s in inner.spans] == [("fill", None)]
    assert outer.counts == {"launch.K2": 3} and inner.counts == {
        "launch.K2": 1}
    assert [c.id for c in metrics.calls()] == [inner.id, outer.id]


def _chunk(n, m, NP, MP):
    n, m = np.asarray(n, np.int32), np.asarray(m, np.int32)
    return batch.Chunk(np.zeros((len(n), NP), np.uint8),
                       np.zeros((len(n), MP), np.uint8), n, m)


def test_computed_cells_of_each_fill_kernel():
    """The cells K1 / K10, K9, K3 and K4 lay out, from the plan alone."""
    ch = _chunk([1, 100, 256], [7, 50, 300], 256, 384)
    # three pairs write one pool: R = 8, stripes of 256 rows
    assert fill_dp.stripe_rows(256, 3, 1) == 8
    assert fill_dp.computed_cells([ch]) == 256 * (7 + 50 + 300)
    # score-only (no pools): the same stripes; K9 rounds the columns
    assert fill_dp.computed_cells([ch], pools=0) == 256 * (7 + 50 + 300)
    small = _chunk([40], [10], 64, 64)
    assert fill_dp.stripe_rows(64, 4, 1) == 2
    assert fill_dp.computed_cells([ch, small]) == (
        256 * (7 + 50 + 300) + 64 * 10)
    assert diag_dp.computed_cells([ch], 2) == (1 * 64 + 100 * 64
                                               + 256 * 320)
    n, m, C = ch.n, ch.m, 64
    k3 = longseq.band_cells(n, m, C)
    assert k3 == C * (1 * 7 + 2 * 50 + 4 * 300)
    # K4 over groups of bands, top first, covers each band once
    groups = [longseq.band_cells(n, m, C, lo, lo + 2) for lo in (2, 0)]
    assert sum(groups) == k3
    assert groups[0] == C * 2 * 300


def test_collector_summary_shows_spans_and_counters():
    st = StatsCollector()
    with metrics.call(trace=True) as c:
        with metrics.span("bucket"):
            metrics.count("launch.K1", 2)
    st.add_call(c)
    st.add_call(c)
    s = st.summary()
    assert s["counters"] == {"launch.K1": 4}
    assert set(s["spans"]) == {"bucket", "call"}
    assert st.run_seconds == pytest.approx(2 * (c.end - c.start) * 1e-9)


def test_flush_pointer_bytes_follow_the_route(monkeypatch):
    """The flush's pointer bytes: the fill's pool (twice over with run
    bytes), the long route's band buffer."""
    pairs = _pairs(9, count=3)
    for route in ("ordinary", "tokens"):
        ba, call, _ = _traced_call(route, monkeypatch, pairs)
        (fl,) = [s for s in call.spans if s.name == "flush"]
        pool = sum(B * NP * fill_dp.row_stride(MP)
                   for B, NP, MP in _buckets(ba, pairs))
        assert fl.attrs["pointer_bytes"] == pool * (2 if route == "tokens"
                                                    else 1)
    ba, call, _ = _traced_call("long", monkeypatch, pairs)
    for fl, shape in zip([s for s in call.spans if s.name == "flush"],
                         _buckets(ba, pairs)):
        assert fl.attrs["pointer_bytes"] == longseq.band_buffer_bytes(*shape)


def _buckets(ba, pairs):
    """The (B, NP, MP) of each bucket of ``pairs``, in flush order."""
    from smithwaterman_tpu_torch.config import bucket_len

    shapes = {}
    for a, b in pairs:
        if a and b:
            key = (bucket_len(len(a), ba.config.buckets),
                   bucket_len(len(b), ba.config.buckets))
            shapes[key] = shapes.get(key, 0) + 1
    return [(B, NP, MP) for (NP, MP), B in sorted(shapes.items())]


def test_uploads_count_only_on_a_card():
    before = [metrics.counter("copy.h2d" + k) for k in ("", "_bytes")]
    t = batch.to_device(np.arange(6, dtype=np.int64), torch.device("cpu"))
    assert t.tolist() == list(range(6))
    assert [metrics.counter("copy.h2d" + k) for k in ("", "_bytes")] == before
