"""The label training cell's entries in BENCHMARK.json and its eight
per-layer readers against a synthetic profiler trace: each reader's
hand-computed value, and None where the program has no span to read (the
commit before the spans) or its kernels are missing."""
import pytest

from benchmark import harness, peaks, profiling
from benchmark.profiling import DeviceEvent, Trace
from benchmark.work import knn, segmentation

CELL = "randla-semantickitti.label-train-b3"
BENCH = harness.benchmark()
RANDLA = harness.load_json(harness.HERE / "configs" / "randla-semantickitti.json")
MIX = harness.load_json(harness.HERE / "traffic" / "label-train-b3.json")
B = MIX["batch"]
METRICS = {
    "dispatch_events_per_pair.label_train": ("events/pair", "lower", "device_trace", "entry"),
    "device_idle_pct.label_train": ("%", "lower", "device_trace", "device"),
    "mfu_pct.label_train": ("%", "higher", "device_trace", "whole step"),
    "encoder_device_ms_per_pair.label_train": ("ms", "lower", "program_span",
                                               "backbone and scoring"),
    "decoder_device_ms_per_pair.label_train": ("ms", "lower", "program_span",
                                               "backbone and scoring"),
    "backward_device_ms_per_pair.label_train": ("ms", "lower", "program_span", "backward"),
    "pyramid_device_ms_per_pair.label_train": ("ms", "lower", "program_span", "pyramid"),
    "knn_roofline.label_train": ("%", "higher", "device_trace", "kernels"),
}
PROGRAM_SPANS = [m for m, v in METRICS.items() if v[2] == "program_span"]

# One step [0, 100] us: device_batch's copy [1] and K1 [2], the encoder [3],
# the decoder [4], the head [5], the loss [6], the backward [7], Adam [8];
# a kernel launched after the step [9] does not count.
SPANS = {"bench.unit": [(0.0, 100.0)], "bench.train_step": [(0.0, 100.0)]}
LAUNCHES = {1: 1.0, 2: 5.0, 3: 22.0, 4: 32.0, 5: 42.0, 6: 52.0, 7: 62.0, 8: 90.0, 9: 150.0}
DEVICE = [DeviceEvent("Memcpy HtoD (Pageable -> Device)", 10.0, 2.0, 1),
          DeviceEvent("void knn_select::knn_kernel<false, 4>(float const*)", 12.0, 8.0, 2),
          DeviceEvent("void gather(float*)", 20.0, 10.0, 3),
          DeviceEvent("void gemm(float*)", 30.0, 6.0, 4),
          DeviceEvent("void leaky(float*)", 40.0, 2.0, 5),
          DeviceEvent("void nll(float*)", 45.0, 3.0, 6),
          DeviceEvent("void gemm_backward(float*)", 50.0, 30.0, 7),
          DeviceEvent("void adam(float*)", 90.0, 5.0, 8),
          DeviceEvent("void late(float*)", 160.0, 10.0, 9)]
PROGRAM = [("deepsir.h2d", 0.5, 3.0), ("deepsir.pyramid", 4.0, 19.0),
           ("deepsir.train.forward", 20.0, 48.0), ("deepsir.backbone", 20.5, 47.0),
           ("deepsir.randla.encoder", 21.0, 30.0), ("deepsir.randla.decoder", 31.0, 40.0),
           ("deepsir.randla.head", 41.0, 46.0), ("deepsir.train.loss", 50.0, 55.0),
           ("deepsir.train.backward", 60.0, 80.0), ("deepsir.train.optimizer", 85.0, 95.0)]


def readings(program=True, device=DEVICE):
    t = Trace(device, LAUNCHES, SPANS, PROGRAM if program else [])
    return profiling.readings(t, B, RANDLA["model"], {}, MIX)


def test_the_cell_and_its_entries():
    cell = harness.find_cell(CELL)
    assert cell.chips == 1 and cell.traffic["driver"] == "label_train"
    assert {m["name"] for m in cell.end_to_end} == {"train_pairs_per_s", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == set(METRICS)
    for m in cell.per_layer:
        assert (m["unit"], m["better"], m["source"], m["layer"]) == METRICS[m["name"]]
        assert m["moves"] == "train_pairs_per_s" and m["workloads"] == [CELL]
    config = next(c for c in BENCH["configs"] if c["name"] == "randla-semantickitti")
    assert config["reduced"] == RANDLA["reduced"] == []
    assert set(cell.limits) == {"loss_gap", "grad_gap", "change_gap"}


def test_the_configuration_is_every_field_as_run():
    import dataclasses
    from deepsir_tpu_torch.config import ModelConfig, check_supported
    cfg = harness.model_config(RANDLA["model"])
    assert set(RANDLA["model"]) == {f.name for f in dataclasses.fields(ModelConfig)}
    check_supported(cfg, "label")
    assert (cfg.num_points, cfg.feat_len, cfg.num_knn, cfg.d_out, cfg.sub_sampling_ratio,
            cfg.num_classes, cfg.dropout_rate) == \
        (45056, 3, 16, (16, 64, 128, 256), (4, 4, 4, 4), 19, 0.5)
    assert (cfg.randla_skips, cfg.randla_norm, cfg.fc_norm, cfg.label_head,
            cfg.compute_dtype, cfg.matmul_precision) == \
        ("post", "batch", "batch", "randla", "float32", "highest")


@pytest.mark.parametrize("metric, want", [
    ("dispatch_events_per_pair.label_train", 8 / B),
    # the stretch [10, 95]: busy [10, 20], [20, 36], [40, 42], [45, 48], [50, 80], [90, 95]
    ("device_idle_pct.label_train", 100.0 * (1 - 66.0 / 85.0)),
    ("encoder_device_ms_per_pair.label_train", 10e-3 / B),
    ("decoder_device_ms_per_pair.label_train", 6e-3 / B),
    ("backward_device_ms_per_pair.label_train", 30e-3 / B),
    ("pyramid_device_ms_per_pair.label_train", (2 + 8) * 1e-3 / B),
])
def test_each_reader_by_hand(metric, want):
    assert harness.reader(metric)(readings()) == pytest.approx(want)


def test_mfu_and_roofline_by_hand():
    r = readings()
    flops = segmentation.per_pair(RANDLA["model"], MIX) * B
    assert harness.reader("mfu_pct.label_train")(r) == pytest.approx(
        100.0 * flops / 85e-6 / peaks.FP32_GRADE_FLOPS)
    bound = sum(knn.bound_s(*s) for s in knn.pyramid_searches(45056, 16, (4, 4, 4, 4), B)) * 2
    assert harness.reader("knn_roofline.label_train")(r) == pytest.approx(
        100.0 * bound / 8e-6)


@pytest.mark.parametrize("metric", PROGRAM_SPANS + ["knn_roofline.label_train"])
def test_readers_give_none_without_the_spans(metric):
    assert harness.reader(metric)(readings(program=False)) is None


def test_the_roofline_gives_none_without_its_kernel():
    device = [e for e in DEVICE if "knn_select" not in e.name]
    assert harness.reader("knn_roofline.label_train")(readings(device=device)) is None


def test_the_shared_readers():
    assert harness.reader("device_idle_pct.label_train") is profiling.idle_pct
    assert harness.reader("dispatch_events_per_pair.label_train") is profiling.events_per_pair
