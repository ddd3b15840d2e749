"""The per-layer metrics that read the program's own spans
(`benchmark/program_spans.py`) against synthetic profiler traces: the
parser keeps the spans, each reader gives its hand-computed value and None
where its span is missing, and the spans leave every other reader as it
was."""
import json

import pytest

from benchmark import harness, profiling, program_spans
from benchmark.profiling import DeviceEvent, Trace

DEFAULT = harness.load_json(harness.HERE / "configs" / "deepsir-default.json")
TRAFFIC = {mix: harness.load_json(harness.HERE / "traffic" / f"{mix}.json")
           for mix in ("eval-b16", "feat-train-b1", "align-train-b4")}
BENCH = harness.benchmark()
NEW = [m["name"] for m in BENCH["per_layer"] if m["source"] == "program_span"]
OLD = [m for m in BENCH["per_layer"] if m["source"] != "program_span"]

# One unit [0, 100] us: device_batch [0, 20] (a copy, a K1 search), then
# the forward or the step [20, 90]: a backbone kernel, K2 and its key pass,
# an inlier kernel, a pose kernel, one kernel outside every program span,
# and a kernel launched after the unit.
SPANS = {"bench.unit": [(0.0, 100.0)], "bench.device_batch": [(0.0, 20.0)],
         "bench.forward_align": [(20.0, 90.0)], "bench.train_step": [(0.0, 90.0)],
         "bench.backbone": [(25.0, 40.0)]}
LAUNCHES = {1: 1.0, 2: 5.0, 3: 30.0, 4: 50.0, 5: 52.0, 6: 60.0, 7: 75.0, 8: 85.0, 9: 150.0}
DEVICE = [DeviceEvent("Memcpy HtoD (Pageable -> Device)", 10.0, 5.0, 1),
          DeviceEvent("void knn_select::knn_kernel<false, 4>(float const*)", 14.0, 10.0, 2),
          DeviceEvent("void gemm_kernel(float*)", 30.0, 20.0, 3),
          DeviceEvent("void match_core::match_kernel<1, false, true>(float const*)",
                      60.0, 30.0, 4),
          DeviceEvent("match_core::key_low_words(long long*)", 90.0, 10.0, 5),
          DeviceEvent("void gather(float*)", 100.0, 8.0, 6),
          DeviceEvent("void bmm(float*)", 108.0, 4.0, 7),
          DeviceEvent("void stack(float*)", 112.0, 2.0, 8),
          DeviceEvent("void late(float*)", 160.0, 10.0, 9)]
OPS = [("aten::copy_", 0.5, 4.0), ("aten::linear", 29.0, 31.0), ("aten::item", 95.0, 99.0)]
# the program's spans as the profiler records them: host operations
PROGRAM = [("deepsir.h2d", 0.5, 3.0), ("deepsir.pyramid", 4.0, 19.0),
           ("deepsir.backbone", 24.0, 41.0), ("deepsir.loop.search", 45.0, 55.0),
           ("deepsir.loop.inlier", 56.0, 70.0), ("deepsir.loop.pose", 71.0, 80.0),
           ("deepsir.train.forward", 22.0, 53.0), ("deepsir.train.loss", 54.0, 62.0),
           ("deepsir.train.backward", 62.0, 80.0)]


def trace(program=True, device=DEVICE):
    return Trace(device, LAUNCHES, SPANS, OPS + (PROGRAM if program else []))


def readings(t, mix):
    return profiling.readings(t, TRAFFIC[mix]["batch"], DEFAULT["model"], DEFAULT["forward"],
                              TRAFFIC[mix])


def mix_of(metric):
    return {".eval": "eval-b16", ".train": "feat-train-b1", ".align_train": "align-train-b4"}[
        metric[metric.rindex("."):]]


def test_the_parser_keeps_the_program_spans(tmp_path):
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.unit", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "deepsir.loop.search", "ts": 1, "dur": 5},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 2, "dur": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 2.5, "dur": 1,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 8, "dur": 1,
         "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "k_in", "ts": 10, "dur": 5,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "k_out", "ts": 16, "dur": 2,
         "args": {"correlation": 8}},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    t = profiling.parse_chrome_trace(path)
    assert ("deepsir.loop.search", 1.0, 6.0) in t.host_ops
    r = readings(t, "eval-b16")
    assert [e.name for e in program_spans.events(r, "deepsir.loop.search")] == ["k_in"]
    assert harness.reader("search_device_ms_per_pair.eval")(r) == pytest.approx(
        5e-3 / TRAFFIC["eval-b16"]["batch"])


@pytest.mark.parametrize("metric", [m["name"] for m in OLD])
def test_every_other_reader_reads_as_without_the_spans(metric):
    mix = mix_of(metric)
    with_spans = harness.reader(metric)(readings(trace(True), mix))
    without = harness.reader(metric)(readings(trace(False), mix))
    assert with_spans == without


def test_the_breakdown_keeps_its_device_time():
    """Only the idle gaps' labels may name a program span."""
    out = {}
    for program in (True, False):
        t = trace(program)
        _, gaps = t.busy(0.0, 100.0)
        out[program] = profiling.breakdown(t, 0.0, 100.0, gaps)
    assert out[True]["device_ops"] == out[False]["device_ops"]
    assert sum(v for _, v in out[True]["idle_gaps"]) == pytest.approx(
        sum(v for _, v in out[False]["idle_gaps"]))


@pytest.mark.parametrize("metric, want", [
    ("search_device_ms_per_pair.eval", (30.0 + 10.0) * 1e-3 / 16),
    ("inlier_device_ms_per_pair.eval", 8.0e-3 / 16),
    ("pose_device_ms_per_pair.eval", 4.0e-3 / 16),
    # the feat step is one pair: forward [22, 53] launches 3, 4, 5; loss 6;
    # backward 7
    ("loss_device_ms_per_pair.train", 8.0e-3),
    ("backward_device_ms_per_pair.train", 4.0e-3),
    ("forward_events_per_pair.align_train", 3 / 4),
    ("backward_events_per_pair.align_train", 1 / 4),
])
def test_each_reader_by_hand(metric, want):
    assert metric in NEW
    assert harness.reader(metric)(readings(trace(), mix_of(metric))) == pytest.approx(want)


@pytest.mark.parametrize("metric", NEW)
def test_readers_give_none_without_their_span(metric):
    """A program without the spans (the parent of the change that added
    them) or a span that launched nothing reads None, never 0."""
    mix = mix_of(metric)
    assert harness.reader(metric)(readings(trace(False), mix)) is None
    empty = [e for e in DEVICE if e.corr in (8, 9)]       # outside every program span
    assert harness.reader(metric)(readings(trace(True, empty), mix)) is None


def test_every_new_metric_is_declared_for_program_spans():
    assert len(NEW) == 7
    for m in BENCH["per_layer"]:
        if m["name"] in NEW:
            assert m["workloads"] and m["better"] == "lower"
            assert (harness.HERE / "metrics" / f"{m['name']}.py").is_file()
