"""Each per-layer metric reader against a synthetic profiler trace: span
attribution by launch, the union of device intervals, events per pair,
rooflines and the breakdown."""
import json

import pytest

from benchmark import harness, peaks, profiling
from benchmark.profiling import DeviceEvent, Trace
from benchmark.work import knn, match, model

DEFAULT = harness.load_json(harness.HERE / "configs" / "deepsir-default.json")
EVAL = harness.load_json(harness.HERE / "traffic" / "eval-b16.json")
FEAT = harness.load_json(harness.HERE / "traffic" / "feat-train-b1.json")
B = EVAL["batch"]


def _trace():
    """One unit [0, 100] us: device_batch [0, 20] launches a copy and a K1
    search; forward_align [20, 90] holds a backbone span [25, 40] (one
    kernel) and launches a K2 search and its key pass; a kernel launched
    after the unit does not count."""
    spans = {"bench.unit": [(0.0, 100.0)], "bench.device_batch": [(0.0, 20.0)],
             "bench.forward_align": [(20.0, 90.0)], "bench.backbone": [(25.0, 40.0)]}
    launches = {1: 1.0, 2: 5.0, 3: 30.0, 4: 50.0, 5: 52.0, 6: 150.0}
    device = [DeviceEvent("Memcpy HtoD (Pageable -> Device)", 10.0, 5.0, 1),
              DeviceEvent("void knn_select::knn_kernel<false, 4>(float const*)", 14.0, 10.0, 2),
              DeviceEvent("void gemm_kernel(float*)", 30.0, 20.0, 3),
              DeviceEvent("void match_core::match_kernel<1, false, true>(float const*)",
                          60.0, 30.0, 4),
              DeviceEvent("match_core::key_low_words(long long*)", 90.0, 10.0, 5),
              DeviceEvent("void late(float*)", 160.0, 10.0, 6)]
    ops = [("aten::copy_", 0.5, 4.0), ("aten::linear", 29.0, 31.0), ("aten::item", 95.0, 99.0)]
    return Trace(device, launches, spans, ops)


def _readings(trace, traffic=EVAL):
    return profiling.readings(trace, traffic["batch"], DEFAULT["model"], DEFAULT["forward"],
                              traffic)


def test_attribution_by_launch():
    t = _trace()
    assert [e.corr for e in t.events_in("bench.unit")] == [1, 2, 3, 4, 5]
    assert [e.corr for e in t.events_in("bench.device_batch")] == [1, 2]
    assert [e.corr for e in t.events_in("bench.backbone")] == [3]
    assert [e.corr for e in t.events_in("bench.forward_align")] == [3, 4, 5]
    assert t.events_in("bench.nothing") == []


def test_window_busy_and_gaps():
    t = _trace()
    # the stretch opens at the units' first device event, not at the first unit's host call
    assert t.window() == (10.0, 100.0)
    busy, gaps = t.busy(0.0, 100.0)
    # copy [10, 15] and K1 [14, 24] overlap: union [10, 24]; then [30, 50], [60, 100]
    assert busy == pytest.approx(14.0 + 20.0 + 40.0)
    assert gaps == [(0.0, 10.0), (24.0, 30.0), (50.0, 60.0)]
    assert t.busy(20.0, 40.0)[0] == pytest.approx(4.0 + 10.0)


def test_readers():
    r = _readings(_trace())
    assert (r.units, r.pairs) == (1, B)
    read = lambda name: harness.reader(name)(r)
    assert read("dispatch_events_per_pair.eval") == pytest.approx(5 / B)
    assert read("pyramid_device_ms_per_pair.eval") == pytest.approx(15e-3 / B)
    assert read("backbone_device_ms_per_pair.eval") == pytest.approx(20e-3 / B)
    assert read("loop_device_ms_per_pair.eval") == pytest.approx((60e-3 - 20e-3) / B)
    assert read("device_idle_pct.eval") == pytest.approx(100.0 * (1 - 74.0 / 90.0))
    b, n = EVAL["batch"], EVAL["points"]
    want = sum(knn.bound_s(*s) for s in knn.pyramid_searches(n, 16, (4, 4, 4, 4), b)) * 2
    assert read("knn_roofline.eval") == pytest.approx(100.0 * want / 10e-6)
    want = match.bound_s(b, n, n, 64, False) * 5
    assert read("match_roofline.eval") == pytest.approx(100.0 * want / 40e-6)
    flops = model.per_pair(DEFAULT["model"], DEFAULT["forward"], EVAL) * B
    assert read("mfu_pct.eval") == pytest.approx(100.0 * flops / 90e-6 / peaks.FP32_GRADE_FLOPS)


def test_readers_find_nothing():
    """A trace without the kernels a reader reads gives no value, never 0."""
    t = _trace()
    t.device = [e for e in t.device if "knn_select" not in e.name and "match_core" not in e.name]
    r = _readings(t)
    assert harness.reader("knn_roofline.eval")(r) is None
    assert harness.reader("match_roofline.eval")(r) is None


def test_train_readers():
    r = _readings(_trace(), FEAT)
    assert (r.units, r.pairs) == (1, 1)
    assert harness.reader("dispatch_events_per_pair.train")(r) == pytest.approx(5.0)
    assert harness.reader("device_idle_pct.train")(r) == pytest.approx(100.0 * (1 - 74.0 / 90.0))
    flops = model.per_pair(DEFAULT["model"], DEFAULT["forward"], FEAT)
    assert harness.reader("mfu_pct.train")(r) == pytest.approx(
        100.0 * flops / 90e-6 / peaks.FP32_GRADE_FLOPS)


@pytest.mark.parametrize("part", ["eval", "train", "align_train"])
def test_the_splits_read_alike(part):
    """The `.eval`, `.train` and `.align_train` metrics of one quantity are
    one reader under three names."""
    for stem, fn in (("device_idle_pct", profiling.idle_pct),
                     ("dispatch_events_per_pair", profiling.events_per_pair),
                     ("mfu_pct", profiling.mfu_pct)):
        assert harness.reader(f"{stem}.{part}") is fn


def test_stretch_opens_on_the_device_and_counts_every_event():
    """With a batch still in flight when the first unit is called, the
    units' stretch opens at their first device event; a device event in the
    stretch that no unit launched (another stream) counts as busy, while the
    spans' device time keeps to the units' own events."""
    spans = {"bench.unit": [(0.0, 100.0)], "bench.forward_align": [(0.0, 100.0)]}
    launches = {9: -50.0, 10: -10.0, 1: 1.0, 2: 2.0}
    device = [DeviceEvent("void before(float*)", 0.0, 30.0, 9),
              DeviceEvent("void unit_a(float*)", 30.0, 30.0, 1),
              DeviceEvent("void side_stream(float*)", 62.0, 4.0, 10),
              DeviceEvent("void unit_b(float*)", 70.0, 20.0, 2)]
    r = _readings(Trace(device, launches, spans, []))
    assert r.window == (30.0, 90.0)
    assert r.busy_us == pytest.approx(30.0 + 4.0 + 20.0)
    assert harness.reader("device_idle_pct.eval")(r) == pytest.approx(10.0)
    assert harness.reader("dispatch_events_per_pair.eval")(r) == pytest.approx(2 / B)
    assert harness.reader("loop_device_ms_per_pair.eval")(r) == pytest.approx(50e-3 / B)


def test_breakdown_labels_idle_time_by_host_activity():
    t = _trace()
    _, gaps = t.busy(0.0, 100.0)
    out = profiling.breakdown(t, 0.0, 100.0, gaps)
    ops = dict(out["device_ops"])
    assert ops["void match_core::match_kernel<1, false, true>"] == pytest.approx(30e-6)
    assert "void late" not in ops
    idle = dict(out["idle_gaps"])
    # the innermost span at each gap's start, and the host operation begun last
    assert idle["bench.device_batch"] == pytest.approx(10e-6)
    assert idle["bench.forward_align / aten::copy_"] == pytest.approx(6e-6)
    assert idle["bench.forward_align / aten::linear"] == pytest.approx(10e-6)
    assert sum(idle.values()) == pytest.approx(26e-6)


@pytest.mark.parametrize("name, want", [
    ("void match_core::match_kernel<1, false, true>(float const*)",
     "void match_core::match_kernel<1, false, true>"),
    ("void at::native::(anonymous namespace)::RowwiseMomentsCUDAKernel<float, float>(long, float)",
     "void at::native::RowwiseMomentsCUDAKernel<float, float>"),
    ("Memcpy HtoD (Pageable -> Device)", "Memcpy HtoD"),
])
def test_short_kernel_names(name, want):
    assert profiling.short(name) == want


def test_chrome_trace_parsing(tmp_path):
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.unit", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "other", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 1, "dur": 3},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 2, "dur": 1,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernel", "ts": 3, "dur": 1,
         "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 10, "dur": 5, "args": {"correlation": 7}},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 16, "dur": 1,
         "args": {"correlation": 8}},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 5},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    t = profiling.parse_chrome_trace(path)
    assert [e.name for e in t.events_in("bench.unit")] == ["k1", "Memset"]
    assert set(t.spans) == {"bench.unit"}
    assert t.host_ops == [("aten::mm", 1.0, 4.0)]


def test_readings_keep_the_units_events_only():
    """A batch dispatched after the last unit, before the profiler stopped,
    is not read: its spans and device events stay out of every metric."""
    t = _trace()
    spans = dict(t.spans, **{"bench.forward_align": [(20.0, 90.0), (140.0, 200.0)]})
    r = _readings(Trace(t.device, t.launches, spans, t.host_ops))
    assert [e.corr for e in r.trace.events_in("bench.forward_align")] == [3, 4, 5]
    assert harness.reader("loop_device_ms_per_pair.eval")(r) == pytest.approx(40e-3 / B)
    assert r.busy_us == pytest.approx(74.0)
