"""The training step's CUDA graphs (deepsir_tpu_torch/step_graph.py, driven
by training.train_step).

On the CPU, where no graph can be captured, a stub stands in for
torch.cuda.CUDAGraph: the capture of a feat, an align and a label step at
test widths (256 points) runs the step's real work through `Capture`, so
that the spans' entries and exits become the graphs' boundaries in the
order an eager step's profiler ranges show them, and `replay` reopens that
nesting around each stub launch; where graphs engage and why a step runs
eagerly; what a capture is kept for; the launch counts a capture records
and each replay adds back.

The tests marked `card` run graphed steps against eager ones on the card
(`chip_smoke.graphs_against_eager`, 1024 points) and skip without a GPU:
`python -m pytest --noconftest -p no:cacheprovider -m card
tests/test_torch_step_graph.py`."""
import torch_workers  # noqa: F401  (torch's threads under xdist)
import copy
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from deepsir_tpu_torch import step_graph, training
from deepsir_tpu_torch.config import LossConfig, ModelConfig, RunConfig, TrainConfig
from deepsir_tpu_torch.models.network import Network
from deepsir_tpu_torch.utils import profiling
from deepsir_tpu_torch.utils.params import init_params, trainable_parameters

MODEL = dict(feat_len=3, num_points=256, num_knn=8, sub_sampling_ratio=(4, 4),
             d_out=(8, 16), out_feat_dim=16, num_train_reg_iter=2, num_reg_iter=3,
             dropout_rate=0.5)
LABEL = dict(randla_skips="post", fc_norm="batch", randla_norm="batch", label_head="randla")
OPTIONS = {"align": {}, "feat": {}, "label": LABEL}
LOSS = dict(thres_radius=0.3, circle_loss_tile=100)
TRAIN = dict(lr=1e-3, lr_decay_epoch=1, lr_decay_ratio=0.5, lr_clip=3e-4)


def arrays(b=2, n=256, seed=0, labels=False):
    """Source clouds, their references under a small rigid motion, and with
    `labels` per-point labels 0..19."""
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(b, n, 3)).astype(np.float32)
    angle = 0.3
    rot = np.array([[np.cos(angle), -np.sin(angle), 0.0], [np.sin(angle), np.cos(angle), 0.0],
                    [0.0, 0.0, 1.0]], np.float32)
    ref = src @ rot.T + np.float32(0.2) + rng.normal(scale=0.01, size=src.shape).astype(
        np.float32)
    gt = np.broadcast_to(np.concatenate([rot, np.full((3, 1), 0.2, np.float32)], 1), (b, 3, 4))
    out = {"points_src": src, "points_ref": ref[:, rng.permutation(n)],
           "transform_gt": np.ascontiguousarray(gt)}
    if labels:
        for key in ("labels_src", "labels_ref"):
            out[key] = rng.integers(0, 20, size=(b, n)).astype(np.int32)
    return out


def step_setup(pipeline):
    cfg = ModelConfig(**dict(MODEL, **OPTIONS[pipeline]))
    model = Network(cfg, pipeline)
    model.load_state_dict(init_params(cfg, 0, pipeline))
    cfgs = RunConfig(cfg, LossConfig(**LOSS), TrainConfig(**TRAIN), pipeline)
    return cfgs, model, arrays(labels=pipeline == "label")


class StubGraph:
    """torch.cuda.CUDAGraph's surface, capturing nothing: replays are
    appended to `log`; `empty` makes its capture end with torch's warning
    for a graph with no node."""

    def __init__(self, log=None, empty=False):
        self.log, self.empty = log, empty
        self.generators, self.begun, self.ended = [], None, False

    def register_generator_state(self, generator):
        self.generators.append(generator)

    def capture_begin(self, pool=None, capture_error_mode="global"):
        self.begun = (pool, capture_error_mode)

    def capture_end(self):
        self.ended = True
        if self.empty:
            warnings.warn("The CUDA Graph is empty. This usually means that the graph was "
                          "attempted to be captured on wrong device or stream.")

    def replay(self):
        self.log.append(("replay", self))


class Recorder:
    """A stand-in for the profiler's range: logs its opening and closing."""

    def __init__(self, log, name):
        self.log, self.name = log, name

    def __enter__(self):
        self.log.append(("open", self.name))

    def __exit__(self, *exc):
        self.log.append(("close", self.name))


def eager_boundaries(monkeypatch, model, cfgs, data):
    """The program's ranges of one eager run of the capture body (the step
    from the pyramids through the guard) as a profiler would open them:
    [(name, entering)] in order."""
    inputs = training._static_inputs(data, "cpu")
    for k, x in data.items():
        inputs[k].copy_(torch.from_numpy(x))
    named = tuple(trainable_parameters(model))
    log = []
    with monkeypatch.context() as m:
        m.setattr(profiling, "_profiling", lambda: True)
        m.setattr(profiling, "_RANGE", lambda name: Recorder(log, name))
        done = SimpleNamespace(finish=lambda: None)
        training._captured(model, cfgs, inputs, torch.Generator().manual_seed(0), named, done)
    model.zero_grad(set_to_none=True)
    return [(a[1], a[0] == "open") for a in log]


def captured(model, cfgs, data, generator=None, log=None):
    """The capture body run through a Capture of stub graphs on the CPU:
    (the Capture, its boundaries [(name, entering)] in order, the guard's
    flag)."""
    inputs = training._static_inputs(data, "cpu")
    for k, x in data.items():
        inputs[k].copy_(torch.from_numpy(x))
    named = tuple(trainable_parameters(model))
    model.zero_grad(set_to_none=True)
    seen = []
    cap = step_graph.Capture(lambda: StubGraph(log), pool="pool", generator=generator)
    boundary = cap.boundary

    def record(name, entering):
        if not cap._done:
            seen.append((name, entering))
        boundary(name, entering)

    cap.boundary = record
    with cap:
        ok, _ = training._captured(model, cfgs, inputs, generator, named, cap)
    return cap, seen, ok


def stacks(boundaries):
    """The span names open after each boundary."""
    out, open_ = [], []
    for name, entering in boundaries:
        if entering:
            open_.append(name)
        else:
            assert open_.pop() == name
        out.append(tuple(open_))
    return out


# ------------------------------------------------------------------ segments

@pytest.mark.parametrize("pipeline", ["feat", "align", "label"])
def test_spans_become_segment_boundaries_in_order(monkeypatch, pipeline):
    """Every span entry and exit of the capture body ends one graph and
    begins the next, in the order of the eager step's profiler ranges; each
    graph holds the spans open around its work, and the last ends inside
    the guard's span."""
    cfgs, model, data = step_setup(pipeline)
    want = eager_boundaries(monkeypatch, model, cfgs, data)
    cap, seen, _ = captured(model, cfgs, data)
    # the guard's exit follows the last graph (its host read is eager)
    assert seen + [("deepsir.train.guard", False)] == want
    assert len(cap.segments) == len(seen) + 1
    assert [tuple(n for n, _ in seg.spans) for seg in cap.segments] == [()] + stacks(seen)
    assert cap.segments[-1].spans[-1][0] == "deepsir.train.guard"
    assert {n for n, _ in want} >= {"deepsir.pyramid", "deepsir.train.forward",
                                     "deepsir.train.loss", "deepsir.train.backward"}
    if pipeline == "label":
        assert {"deepsir.randla.encoder", "deepsir.randla.decoder"} <= {n for n, _ in want}
    if pipeline == "align":
        assert ("deepsir.loop.search", True) in want
    assert all(g.graph.ended and g.graph.begun == ("pool", "thread_local")
               for g in cap.segments)


@pytest.mark.parametrize("pipeline", ["feat", "align", "label"])
def test_replay_rebuilds_the_nesting(monkeypatch, pipeline):
    """With a profiler running, a replay opens and closes the ranges in the
    order the capture entered and left the spans, launching each graph
    inside its own; same-named sibling spans stay apart; the last graph's
    spans close only when the replay block ends."""
    cfgs, model, data = step_setup(pipeline)
    log = []
    cap, seen, _ = captured(model, cfgs, data, log=log)
    monkeypatch.setattr(profiling, "_profiling", lambda: True)
    monkeypatch.setattr(profiling, "_RANGE", lambda name: Recorder(log, name))
    with step_graph.replay(cap.segments, counters=()):
        log.append(("read",))
    marks = [(a[1], a[0] == "open") for a in log if a[0] in ("open", "close")]
    assert marks == seen + [("deepsir.train.guard", False)]
    open_, launched = [], []
    for a in log:
        if a[0] == "open":
            open_.append(a[1])
        elif a[0] == "close":
            assert open_.pop() == a[1]
        elif a[0] == "replay":
            launched.append((a[1], tuple(open_)))
    assert launched == [(s.graph, tuple(n for n, _ in s.spans)) for s in cap.segments]
    assert log[-2] == ("read",) and log[-1] == ("close", "deepsir.train.guard")


def test_a_replay_without_a_profiler_opens_no_range(monkeypatch):
    cfgs, model, data = step_setup("feat")
    log = []
    cap, _, _ = captured(model, cfgs, data, log=log)

    def refuse(*args, **kwargs):
        raise AssertionError("a profiler range was built with no profiler running")

    monkeypatch.setattr(profiling, "_RANGE", refuse)
    with step_graph.replay(cap.segments, counters=()):
        pass
    assert len(log) == len(cap.segments)


def test_the_generator_is_registered_with_every_graph():
    cfgs, model, data = step_setup("align")
    gen = torch.Generator().manual_seed(3)
    cap, _, _ = captured(model, cfgs, data, generator=gen)
    assert all(seg.graph.generators == [gen] for seg in cap.segments)


def test_a_capture_cuts_only_its_own_thread_and_only_while_it_runs():
    assert profiling.span("deepsir.pyramid") is profiling._OFF
    cap = step_graph.Capture(StubGraph, counters=())
    with cap:
        assert isinstance(profiling.span("deepsir.pyramid"), profiling._Boundary)
        cap.thread = -1                      # as if another thread asked
        assert profiling.span("deepsir.pyramid") is profiling._OFF
        cap.thread = step_graph.threading.get_ident()
    assert profiling.span("deepsir.pyramid") is profiling._OFF
    with pytest.raises(RuntimeError):
        with profiling.cut_at_spans(cap), profiling.cut_at_spans(cap):
            pass
    assert profiling._capture is None


def test_an_error_inside_a_capture_ends_it_and_uninstalls_the_cut():
    graphs = []

    def new():
        graphs.append(StubGraph())
        return graphs[-1]

    with pytest.raises(ValueError):
        with step_graph.Capture(new, counters=()):
            with profiling.span("deepsir.pyramid"):
                raise ValueError("inside")
    assert profiling._capture is None and all(g.ended for g in graphs)


# -------------------------------------------------------------- engage policy

@pytest.mark.parametrize("case, want", [
    (dict(device="cpu"), "device"),
    (dict(device="cuda", mesh=object()), "mesh"),
    (dict(device="cpu", mesh=object()), "mesh"),
    (dict(device="cuda", anomaly=True), "anomaly"),
    (dict(device="cuda", graphs=False), "asked"),
    (dict(device="cuda"), None),
    (dict(device="cuda", generator=True, registers=False), "generator"),
    (dict(device="cuda", generator=True, registers=True), None),
])
def test_when_graphs_engage(monkeypatch, case, want):
    """Graphs engage on a CUDA device with no mesh and anomaly detection
    off; `graphs=False` is the only other say, and a torch that cannot
    register a generator with a graph runs a step that draws from one
    eagerly."""
    cls = StubGraph if case.get("registers", True) else type("NoRegister", (), {})
    monkeypatch.setattr(torch.cuda, "CUDAGraph", cls)
    gen = torch.Generator() if case.get("generator") else None
    with torch.autograd.set_detect_anomaly(case.get("anomaly", False)):
        got = step_graph.eager_reason(torch.device(case["device"]), case.get("mesh"), gen,
                                      case.get("graphs", True))
    assert got == want
    assert want is None or want in step_graph.REASONS


@pytest.mark.parametrize("anomaly, graphs, reason", [
    (False, True, "device"), (True, True, "anomaly"), (False, False, "asked")])
def test_a_cpu_step_runs_eagerly_and_counts_why(anomaly, graphs, reason):
    cfgs, model, data = step_setup("feat")
    before = dict(training.train_step.eager_steps)
    captures, replays = training.train_step.graph_captures, training.train_step.graph_replays
    with torch.autograd.set_detect_anomaly(anomaly):
        out = training.train_step(model, training.make_optimizer(model), cfgs, data,
                                  torch.Generator().manual_seed(0), 1, graphs=graphs)
    assert not out["skipped"]
    after = training.train_step.eager_steps
    assert after[reason] == before.get(reason, 0) + 1
    assert sum(after.values()) == sum(before.values()) + 1
    assert (training.train_step.graph_captures, training.train_step.graph_replays) == \
        (captures, replays)
    assert model not in step_graph._MODELS


def test_the_graphed_and_eager_steps_return_the_same_keys_on_the_cpu():
    """The eager path through its helpers: the outputs train_step has
    always returned."""
    cfgs, model, data = step_setup("align")
    out = training.train_step(model, training.make_optimizer(model), cfgs, data,
                              torch.Generator().manual_seed(0), 1)
    assert set(out) == {"loss", "invalid", "losses", "pred_idx", "grads", "lr", "skipped"}
    assert set(out["grads"]) == {n for n, _ in trainable_parameters(model)}


# ------------------------------------------------------------------ the cache

@pytest.mark.parametrize("change", ["shape", "keys", "dtype", "batch"])
def test_the_step_key_follows_the_batch(change):
    cfgs, model, data = step_setup("align")
    opt, gen = object(), object()
    base = step_graph.step_key(opt, gen, cfgs, data)
    assert step_graph.step_key(opt, gen, cfgs, arrays(seed=5)) == base   # other values
    other = dict(data)
    if change == "shape":
        other = arrays(b=3)
    elif change == "keys":
        other["mask_src"] = np.ones((2, 256), np.float32)
    elif change == "dtype":
        other["points_src"] = data["points_src"].astype(np.float16)
    else:
        other = {k: torch.from_numpy(v).double() if k == "transform_gt" else v
                 for k, v in data.items()}
    assert step_graph.step_key(opt, gen, cfgs, other) != base


def test_the_step_key_follows_its_objects_and_configs():
    cfgs, model, data = step_setup("align")
    opt, gen = object(), object()
    base = step_graph.step_key(opt, gen, cfgs, data)
    assert step_graph.step_key(object(), gen, cfgs, data) != base
    assert step_graph.step_key(opt, object(), cfgs, data) != base
    loss = cfgs._replace(loss=LossConfig(**dict(LOSS, thres_radius=0.4)))
    assert step_graph.step_key(opt, gen, loss, data) != base
    train = cfgs._replace(train=TrainConfig(lr=5e-4))    # read eagerly: the same capture
    assert step_graph.step_key(opt, gen, train, data) == base


def test_the_step_key_follows_the_tf32_switch(monkeypatch):
    cfgs, _, data = step_setup("feat")
    base = step_graph.step_key(None, None, cfgs, data)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                        not torch.backends.cuda.matmul.allow_tf32)
    assert step_graph.step_key(None, None, cfgs, data) != base


def test_captures_survive_an_in_place_load_but_not_new_storage():
    cfgs, model, _ = step_setup("feat")
    held = step_graph.captures(model)
    held["key"] = step_graph.WARM
    key = step_graph.param_key(model)
    model.load_state_dict(copy.deepcopy(model.state_dict()))
    assert step_graph.param_key(model) == key and step_graph.captures(model) is held
    p = next(model.parameters())
    p.data = p.data.clone()
    assert step_graph.param_key(model) != key
    fresh = step_graph.captures(model)
    assert fresh is not held and fresh == {}
    fresh["key"] = step_graph.WARM
    p.requires_grad_(not p.requires_grad)
    assert step_graph.captures(model) == {}


def test_captures_go_with_their_model():
    cfgs, model, _ = step_setup("feat")
    step_graph.captures(model)["key"] = step_graph.WARM
    assert model in step_graph._MODELS
    n = len(step_graph._MODELS)
    del model
    import gc
    gc.collect()
    assert len(step_graph._MODELS) == n - 1


# --------------------------------------------------------------- the counters

class Counted:
    def __init__(self):
        self.launches = self.launches_lp = 0


def test_counts_recorded_at_capture_are_added_back_at_each_replay():
    """Each graph records what its capture added to each counter; a replay
    adds it back (not the capturing step's own replay, whose calls counted
    already); a graph with no node is dropped, and may count nothing."""
    a, b = Counted(), Counted()
    counters = ((a, "launches"), (a, "launches_lp"), (b, "launches"))
    log = []
    cap = step_graph.Capture(lambda: StubGraph(log), counters=counters)
    with cap:
        a.launches += 2
        with profiling.span("deepsir.pyramid"):
            a.launches_lp += 1
            b.launches += 3
        with profiling.span("deepsir.loop.search"):
            pass
        b.launches += 1
    assert [s.counts for s in cap.segments] == [(2, 0, 0), (0, 1, 3), (0, 0, 0), (0, 0, 0),
                                                 (0, 0, 1)]
    assert (a.launches, a.launches_lp, b.launches) == (2, 1, 4)
    for _ in range(3):
        with step_graph.replay(cap.segments, counters):
            pass
    assert (a.launches, a.launches_lp, b.launches) == (8, 4, 16)
    with step_graph.replay(cap.segments, counters, count=False):
        pass
    assert (a.launches, a.launches_lp, b.launches) == (8, 4, 16)
    assert len(log) == 4 * len(cap.segments)


@pytest.mark.parametrize("counted", [False, True])
def test_an_empty_graph_is_dropped(counted):
    a = Counted()
    made = []

    def new():
        made.append(StubGraph([], empty=len(made) == 1))
        return made[-1]

    cap = step_graph.Capture(new, counters=((a, "launches"),))
    if counted:
        with pytest.raises(RuntimeError, match="empty graph"):
            with cap:
                with profiling.span("deepsir.pyramid"):
                    a.launches += 1
        return
    with cap:
        with profiling.span("deepsir.pyramid"):
            pass
    assert [s.graph for s in cap.segments] == [made[0], made[2]]


def test_kernel_counters_are_the_five_wrappers():
    names = {(fn.__name__, attr) for fn, attr in step_graph.COUNTERS}
    assert names == {("knn_topk", "launches"), ("knn_topk_windowed", "launches"),
                     ("match_argmin", "launches"), ("match_argmin", "launches_lp"),
                     ("match_argmin_bidirectional", "launches"),
                     ("match_argmin_bidirectional", "launches_lp"),
                     ("circle_rows", "launches")}


def test_a_replay_returns_copies_of_the_static_outputs():
    aux = {"loss": torch.ones(()), "losses": {"a": torch.zeros(2)}}
    out = training._map_aux(torch.Tensor.clone, aux)
    aux["loss"].add_(1)
    aux["losses"]["a"].add_(1)
    assert float(out["loss"]) == 1 and float(out["losses"]["a"].sum()) == 0


# ----------------------------------------------------------------- on the card

@pytest.fixture
def card():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("pipeline", ["feat", "align", "label"])
def test_graphed_steps_against_eager_on_card(card, pipeline):
    """Three graphed steps (warm-up, capture, replay) against three eager
    ones from the same weights, batches and generator seed at 1024 points
    (chip_smoke.graphs_against_eager): loss terms, every grad and every
    parameter bit-equal or within 1e-6 of the leaf's scale; a batch with a
    planted NaN skipped by both, Adam's count unchanged; a second batch
    shape captured exactly once; the launch counters as the eager step's."""
    import chip_smoke
    torch.backends.cuda.matmul.allow_tf32 = False
    rec = chip_smoke.graphs_against_eager(torch, card, pipeline)
    assert rec["captures"] == 2 and rec["skipped"] == [True, True]
