"""Label training steps back to back: `training.train_step` on the label
pipeline (both clouds' pyramids, the feature extractor's forward, the
class-weighted cross entropy of each cloud, backward, the skip guard's one
host read, Adam on the whole feature extractor) on host batches drawn in
turn from a pool of distinct batches, with dropout from a seeded generator
on the device.

Each batch holds `batch` pairs of clouds from `inputs.make_pool`'s recipe
and a label per point, drawn from the seed: ids 1..19 in SemanticKITTI's
class frequencies, and `ignored_share` of the points 0 (left out of the
loss). The weights are `inputs.make_weights`' in the reference network's
layout (`reference/randla_net.py`, the port's), with every batch norm's
scale at one.

Set-up builds the model and its optimizer once and drives them through
their first `set_up_steps` steps through the window's own call; the window
goes on with the same objects. The rate, reported under the mix's
`rate_metric`, is the pairs of the steps that ended within the window, over
the window.

Checked after the window (compare.py's training numbers): the losses of the
first three steps, the first gradient's norms (from the Adam state after
one step) and each leaf's change over the three steps, against the plain
reference driven through the same steps from the same weights, batches and
dropout seed. `control` reads the same numbers for the control (the
reference with TF32 on) and for the fault "half of each batch left out";
`benchmark/calibrate_label.py` runs it, `run.py` never does.
"""
from __future__ import annotations

import time
from types import SimpleNamespace
from typing import Dict, List

import numpy as np

from benchmark import compare, harness, inputs, profiling
from benchmark.drivers.train import _first_grad_norm, dropout_seed

PIPELINE = "label"


def label_pool(seed: int, traffic: Dict, feat_len: int) -> List[Dict]:
    """The pool of host batches: `inputs.make_pool`'s clouds with
    `labels_src` and `labels_ref` (batch, points) int32 from a stream of
    the seed's own."""
    from benchmark.reference.randla_net import NUM_PER_CLASS
    b, n = traffic["batch"], traffic["points"]
    pool = inputs.make_pool(seed, traffic["pool"], b, n, feat_len)
    rng = np.random.default_rng([seed & inputs.SEED_MASK, 1])
    freq = NUM_PER_CLASS / NUM_PER_CLASS.sum()
    for arrays in pool:
        for key in ("labels_src", "labels_ref"):
            ids = 1 + rng.choice(len(freq), size=(b, n), p=freq)
            ids[rng.uniform(size=(b, n)) < traffic["ignored_share"]] = 0
            arrays[key] = ids.astype(np.int32)
    return pool


def make_weights(model_cfg: Dict, seed: int, device):
    """`inputs.make_weights` for the reference network's parameters, with
    the batch norms' scales at one (`make_weights` sets GroupNorm's)."""
    import torch
    from benchmark.reference.randla_net import SegmentationNet
    with torch.device("meta"):
        net = SegmentationNet(harness.namespace(model_cfg))
    weights = inputs.make_weights({n: p.shape for n, p in net.state_dict().items()}, seed,
                                  device)
    for name, value in weights.items():
        if name.endswith(".scale"):
            weights[name] = torch.ones_like(value)
    return weights


def run(r) -> harness.Outcome:
    import torch
    from deepsir_tpu_torch import training
    from deepsir_tpu_torch.config import LossConfig, RunConfig, TrainConfig
    from deepsir_tpu_torch.models.network import Network
    from deepsir_tpu_torch.utils.params import trainable_parameters

    traffic, model_cfg = r.cell.traffic, r.cell.config["model"]
    b, pool_n, dev = traffic["batch"], traffic["pool"], r.device
    cfg = harness.model_config(model_cfg)
    cfgs = RunConfig(cfg, LossConfig(**traffic["loss"]), TrainConfig(**traffic["train"]),
                     PIPELINE)
    spe, first = traffic["steps_per_epoch"], traffic["set_up_steps"]

    weights = make_weights(model_cfg, r.seed, dev)
    with torch.device(dev):
        model = Network(cfg, PIPELINE)
    model.load_state_dict(weights, strict=True)
    optimizer = training.make_optimizer(model)
    gen = torch.Generator(device=dev).manual_seed(dropout_seed(r.seed))
    r.log_phase("weights and model")
    pool = label_pool(r.seed, traffic, cfg.feat_len)
    r.log_phase("host batches")
    named = trainable_parameters(model)
    initial = {n: p.detach().clone() for n, p in named}

    def step(k: int, unit: bool = False):
        with harness.span("bench.unit", unit):
            with harness.span("bench.train_step"):
                return training.train_step(model, optimizer, cfgs, pool[k % pool_n], gen, spe)

    prog = {"terms": [], "applied": []}
    for k in range(first):
        out = step(k)
        prog["terms"].append({"total": float(out["loss"])})
        prog["applied"].append(not out["skipped"])
        if k == 0:
            prog["grad_norms"] = {n: _first_grad_norm(optimizer, p) for n, p in named}
    prog["change_norms"] = {n: float((p.detach() - initial[n]).double().norm()) for n, p in named}
    del initial
    harness.sync(dev)
    r.log_phase(f"{first} set-up steps")

    profiler = profiling.Profiler(harness.CACHE / "trace.json") if r.trace else None
    if profiler is not None:
        profiler.warm_up(dev)
    prof_units, prof_first = traffic["profile_steps"], None
    steps_done = failed = attempted = 0
    k = first
    harness.steady()
    t_start = time.perf_counter()
    r.window_started(t_start)
    t_end = t_start + r.seconds
    while time.perf_counter() < t_end:
        if profiler is not None and prof_first is None and \
                time.perf_counter() >= t_start + r.seconds / 2:
            prof_first = attempted
            profiler.start()
        unit = prof_first is not None and prof_first <= attempted < prof_first + prof_units
        attempted += 1
        try:
            out = step(k, unit)
            ok = bool(torch.isfinite(out["loss"]))
        except RuntimeError as exc:
            r.log(f"step {k} raised: {exc!r}")
            ok = False
        failed += not ok
        if time.perf_counter() <= t_end and ok:
            steps_done += 1
        if profiler is not None and prof_first is not None and \
                attempted == prof_first + prof_units:
            profiler.stop()
        k += 1
    memory = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    values = {traffic["rate_metric"]: steps_done * b / r.seconds}
    r.log(f"window {r.seconds} s: {attempted} steps of {b} pairs, {steps_done} ended in it, "
          f"{failed} failed")

    readings = None
    if r.trace:
        readings = profiling.readings(profiler.finish(), b, model_cfg,
                                      r.cell.config.get("forward", {}), traffic)

    del model, optimizer, named
    harness.free(dev)
    harness.tf32(False)
    ref = reference_steps(model_cfg, traffic, weights, pool, r.seed, dev)
    compared = compare.training(prog, ref)
    return harness.Outcome(attempted * b, failed * b, values, compared, memory, readings)


def reference_steps(model_cfg: Dict, traffic: Dict, weights, pool, seed: int, device) -> Dict:
    """The plain reference driven through the set-up steps: the loss of
    each, the first gradient's norms and each leaf's change."""
    import torch
    from benchmark.reference.randla_net import SegmentationNet, Trainer
    with torch.device(device):
        net = SegmentationNet(harness.namespace(model_cfg))
    net.load_state_dict(weights, strict=True)
    trainer = Trainer(net, SimpleNamespace(**traffic["train"]), traffic["steps_per_epoch"])
    start = {n: p.detach().clone() for n, p in zip(trainer.names, trainer.params)}
    gen = torch.Generator(device=device).manual_seed(dropout_seed(seed))
    out = {"terms": [], "applied": []}
    for k in range(traffic["set_up_steps"]):
        res = trainer.step(pool[k % len(pool)], gen)
        out["terms"].append(res["terms"])
        out["applied"].append(res["applied"])
        if k == 0:
            out["grad_norms"] = {n: float(g.double().norm()) for n, g in res["grads"].items()}
    out["change_norms"] = {n: float((p.detach() - start[n]).double().norm())
                           for n, p in zip(trainer.names, trainer.params)}
    return out


def control(cell, seed: int, device, half: bool = False) -> Dict[str, float]:
    """The numbers `compare.training` gives the reference with TF32 on (or,
    with `half`, the fp32 reference on the first half of each batch, the
    loss the mean over the rest) against the fp32 reference."""
    t, model_cfg = cell.traffic, cell.config["model"]
    weights = make_weights(model_cfg, seed, device)
    pool = label_pool(seed, t, model_cfg["feat_len"])
    harness.tf32(False)
    want = reference_steps(model_cfg, t, weights, pool, seed, device)
    if half:
        cut = [{k: v[:t["batch"] // 2] for k, v in arrays.items()} for arrays in pool]
        low = reference_steps(model_cfg, t, weights, cut, seed, device)
    else:
        harness.tf32(True)
        low = reference_steps(model_cfg, t, weights, pool, seed, device)
        harness.tf32(False)
    return compare.training(low, want)
