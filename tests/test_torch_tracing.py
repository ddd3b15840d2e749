"""The port's named spans (`deepsir_tpu_torch.utils.profiling.span`) on the
CPU at test widths (256 points, d_out (8, 16)): where they open under a
`torch.profiler` session, that without one `span()` is the shared no-op,
that they change nothing computed, what one costs with no profiler, and
StepTracer's trace of a run that ends inside its window."""
import torch_workers  # noqa: F401  (torch's threads under xdist)
import copy
import json
import time
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deepsir_tpu_torch.config import LossConfig, ModelConfig, RunConfig, TrainConfig
from deepsir_tpu_torch.models.network import ForwardOptions, Network
from deepsir_tpu_torch.training import device_batch, make_optimizer, train_step
from deepsir_tpu_torch.utils import profiling
from deepsir_tpu_torch.utils.params import init_params
from deepsir_tpu_torch.utils.profiling import SPANS, StepTracer, span

MODEL = dict(feat_len=3, num_points=256, num_knn=8, sub_sampling_ratio=(4, 4),
             d_out=(8, 16), out_feat_dim=16, num_train_reg_iter=2, num_reg_iter=3,
             dropout_rate=0.5)
FLAGSHIP = dict(inlier_extra_feats="dist,recip", clip_weight_thresh=0.05,
                mutual_check=True, mutual_check_tol=0.6)
LOSS = dict(thres_radius=0.3, circle_loss_tile=100)
TRAIN = dict(lr=1e-3, lr_decay_epoch=1, lr_decay_ratio=0.5, lr_clip=3e-4)
EVAL_SPANS = {"deepsir.h2d": 2, "deepsir.pyramid": 2, "deepsir.backbone": 1,
              "deepsir.score": 1, "deepsir.descriptor": 1, "deepsir.inlier_cache": 1}
TRAIN_SPANS = ("deepsir.train.forward", "deepsir.train.loss", "deepsir.train.backward",
               "deepsir.train.guard", "deepsir.train.optimizer")


def arrays(b=2, n=256, seed=0):
    """Source clouds and their references under a small rigid motion."""
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(b, n, 3)).astype(np.float32)
    angle = 0.3
    rot = np.array([[np.cos(angle), -np.sin(angle), 0.0], [np.sin(angle), np.cos(angle), 0.0],
                    [0.0, 0.0, 1.0]], np.float32)
    ref = src @ rot.T + np.float32(0.2) + rng.normal(scale=0.01, size=src.shape).astype(
        np.float32)
    gt = np.broadcast_to(np.concatenate([rot, np.full((3, 1), 0.2, np.float32)], 1), (b, 3, 4))
    return {"points_src": src, "points_ref": ref[:, rng.permutation(n)],
            "transform_gt": np.ascontiguousarray(gt)}


def network(pipeline, **options):
    cfg = ModelConfig(**dict(MODEL, **options))
    model = Network(cfg, pipeline)
    model.load_state_dict(init_params(cfg, 0, pipeline))
    return cfg, model


def traced(fn):
    """fn() under a CPU profiler: (its result, the count of each span name)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    names = Counter(e.name for e in prof.events() if e.name.startswith("deepsir."))
    return out, names


@pytest.mark.parametrize("options", [{}, FLAGSHIP], ids=["default", "flagship"])
def test_align_forward_holds_every_eval_span(options):
    cfg, model = network("align", **options)
    opts = ForwardOptions(num_iter=cfg.num_reg_iter)
    _, names = traced(lambda: model.forward_align(device_batch(cfg, arrays(), "cpu"), opts))
    want = dict(EVAL_SPANS, **{n: cfg.num_reg_iter for n in SPANS
                               if n.startswith("deepsir.loop.")})
    # the RandLA spans open in the backbone's forward and in each inlier pass
    want.update({n: 1 + cfg.num_reg_iter for n in SPANS if n.startswith("deepsir.randla.")})
    assert dict(names) == want


@pytest.mark.parametrize("pipeline", ["align", "feat"])
def test_train_step_holds_every_train_span_once(pipeline):
    cfg, model = network(pipeline)
    cfgs = RunConfig(cfg, LossConfig(**LOSS), TrainConfig(**TRAIN), pipeline)
    out, names = traced(lambda: train_step(model, make_optimizer(model), cfgs, arrays(),
                                           torch.Generator().manual_seed(0), 1))
    assert not out["skipped"]
    assert all(names[n] == 1 for n in TRAIN_SPANS), names
    assert names["deepsir.h2d"] == 2 and names["deepsir.pyramid"] == 2
    loop = cfg.num_train_reg_iter if pipeline == "align" else 0
    assert names["deepsir.loop.search"] == loop and names["deepsir.descriptor"] == 1


def test_spans_are_named_once_and_all_reached():
    assert len(set(SPANS)) == len(SPANS)
    assert all(n.startswith("deepsir.") for n in SPANS)
    seen = set()
    for pipeline in ("align", "feat"):
        cfg, model = network(pipeline)
        cfgs = RunConfig(cfg, LossConfig(**LOSS), TrainConfig(**TRAIN), pipeline)
        _, names = traced(lambda: train_step(model, make_optimizer(model), cfgs, arrays(),
                                             torch.Generator().manual_seed(0), 1))
        seen |= set(names)
    assert seen == set(SPANS)


def test_span_is_the_shared_noop_without_a_profiler(monkeypatch):
    """With no profiler running no range is ever built: every span is one
    shared no-op context, and a whole forward and step run through them."""
    def refuse(*args, **kwargs):
        raise AssertionError("a profiler range was built with no profiler running")

    monkeypatch.setattr(profiling, "_RANGE", refuse)
    assert span("deepsir.loop.search") is span("deepsir.train.loss")
    cfg, model = network("align")
    cfgs = RunConfig(cfg, LossConfig(**LOSS), TrainConfig(**TRAIN), "align")
    model.forward_align(device_batch(cfg, arrays(), "cpu"), ForwardOptions(num_iter=2))
    train_step(model, make_optimizer(model), cfgs, arrays(), torch.Generator().manual_seed(0), 1)


def test_a_span_opened_once_a_profiler_runs():
    """span() asks at every entry: the same call site opens a range once a
    profiler has started, and none after it stopped."""
    assert span("deepsir.pyramid") is span("deepsir.pyramid")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("deepsir.pyramid"):
            torch.ones(4).sum()
    assert span("deepsir.pyramid") is span("deepsir.score")
    assert [e.name for e in prof.events()].count("deepsir.pyramid") == 1


@pytest.mark.parametrize("pipeline", ["align", "feat"])
def test_outputs_bit_equal_with_and_without_a_profiler(pipeline):
    """Transforms, losses, grads and the updated parameters, with dropout on,
    are the same bits whether a profiler records the spans or not."""
    cfg, model = network(pipeline, **(FLAGSHIP if pipeline == "align" else {}))
    cfgs = RunConfig(cfg, LossConfig(**LOSS), TrainConfig(**TRAIN), pipeline)

    def run():
        m = copy.deepcopy(model)
        step = train_step(m, make_optimizer(m), cfgs, arrays(), torch.Generator().manual_seed(3),
                          1)
        out = {"loss": step["loss"], **{f"grad {k}": g for k, g in step["grads"].items()},
               **{f"param {k}": p.detach() for k, p in m.named_parameters()}}
        if pipeline == "align":
            out.update(step["losses"])
            with torch.no_grad():
                fwd = m.forward_align(device_batch(cfg, arrays(seed=1), "cpu"),
                                      ForwardOptions(num_iter=cfg.num_reg_iter))
            out.update(transforms=fwd.transforms, logits=fwd.inlier_logits, idx=fwd.pred_idx)
        return out

    plain = run()
    traced_out, names = traced(run)
    assert names["deepsir.train.backward"] == 1
    assert plain.keys() == traced_out.keys()
    for k in plain:
        if plain[k] is None:
            assert traced_out[k] is None, k
        else:
            assert torch.equal(plain[k], traced_out[k]), k


def test_span_costs_little_without_a_profiler():
    """Gated on the profiler's state, a span with no profiler costs a small
    part of an ungated record_function (about 0.4 us against 10-14 us a
    span on the CPU)."""
    def per_entry(make, n=2000):
        best = float("inf")
        for _ in range(5):
            t = time.perf_counter()
            for _ in range(n):
                with make("deepsir.loop.search"):
                    pass
            best = min(best, (time.perf_counter() - t) / n)
        return best

    assert per_entry(span) * 4 < per_entry(torch.profiler.record_function)


def test_step_tracer_trace_holds_the_spans(tmp_path):
    cfg, model = network("align")
    cfgs = RunConfig(cfg, LossConfig(**LOSS), TrainConfig(**TRAIN), "align")
    opt, gen = make_optimizer(model), torch.Generator().manual_seed(0)
    tracer = StepTracer(str(tmp_path), start=1, num_steps=1)
    for step in range(3):
        with tracer.maybe_trace(step):
            train_step(model, opt, cfgs, arrays(seed=step), gen, 1)
    events = json.loads((tmp_path / "trace_steps_1.json").read_text())["traceEvents"]
    names = Counter(e["name"] for e in events
                    if e.get("ph") == "X" and e["name"].startswith("deepsir."))
    assert all(names[n] == 1 for n in TRAIN_SPANS)
    assert names["deepsir.loop.pose"] == cfg.num_train_reg_iter


def test_step_tracer_close_writes_a_run_that_ended_in_its_window(tmp_path):
    tracer = StepTracer(str(tmp_path), start=1, num_steps=5)
    for step in range(3):
        with tracer.maybe_trace(step):
            with span("deepsir.train.loss"):
                torch.ones(8).sum()
    assert not tmp_path.exists() or not any(tmp_path.iterdir())
    tracer.close()
    events = json.loads((tmp_path / "trace_steps_1.json").read_text())["traceEvents"]
    assert sum(e["name"] == "deepsir.train.loss" for e in events if e.get("ph") == "X") == 2
    tracer.close()                              # nothing open: nothing to do
    assert [p.name for p in tmp_path.iterdir()] == ["trace_steps_1.json"]
