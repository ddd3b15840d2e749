"""Training steps back to back: `training.train_step` (pyramids, the
pipeline's loss, backward, the skip guard's one host read, Adam on the
pipeline's trained groups) on host batches drawn in turn from a pool of
distinct batches, with dropout from a seeded generator on the device.

Set-up builds the model and its optimizer once and drives them through
their first `set_up_steps` steps on the pool's first batches, through the
window's own call; those steps are the warm-up, and the window goes on with
the same objects. The rate, reported under the mix's `rate_metric`, is the
pairs of the steps that ended within the window, over the window.

Checked after the window (compare.py): the losses of the first three steps,
the first gradient's norms (from the Adam state after one step) and the
parameters' change after three steps (read before the window's first step),
against the reference driven through the same three steps from the same
weights, batches and dropout seed.
"""
from __future__ import annotations

import time

from benchmark import compare, harness, inputs, profiling

BETA1 = 0.9


def run(r) -> harness.Outcome:
    import torch
    from deepsir_tpu_torch import training
    from deepsir_tpu_torch.config import LossConfig, RunConfig, TrainConfig
    from deepsir_tpu_torch.models.network import Network
    from deepsir_tpu_torch.utils.params import trainable_parameters

    traffic, model_cfg = r.cell.traffic, r.cell.config["model"]
    pipeline, b, pool_n = traffic["pipeline"], traffic["batch"], traffic["pool"]
    cfg = harness.model_config(model_cfg)
    cfgs = RunConfig(cfg, LossConfig(**traffic["loss"]), TrainConfig(**traffic["train"]),
                     pipeline)
    spe, dev = traffic["steps_per_epoch"], r.device
    first = traffic["set_up_steps"]

    weights = inputs.make_weights(harness.reference_shapes(model_cfg, pipeline), r.seed, dev)
    with torch.device(dev):
        model = Network(cfg, pipeline)
    model.load_state_dict(weights, strict=True)
    optimizer = training.make_optimizer(model)
    gen = torch.Generator(device=dev).manual_seed(dropout_seed(r.seed))
    r.log_phase("weights and model")
    pool = inputs.make_pool(r.seed, pool_n, b, traffic["points"], cfg.feat_len)
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
        terms = {"total": float(out["loss"])}
        terms.update({key: float(v) for key, v in out.get("losses", {}).items()})
        prog["terms"].append(terms)
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
    prof_units = traffic["profile_steps"]
    prof_first = None
    steps_done, failed, attempted = 0, 0, 0
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
        readings = profiling.readings(profiler.finish(), b, model_cfg, r.cell.config["forward"],
                                      traffic)

    del model, optimizer, named
    harness.free(dev)
    harness.tf32(False)
    ref = reference_steps(model_cfg, traffic, weights, pool, r.seed, dev)
    compared = compare.training(prog, ref)
    return harness.Outcome(attempted * b, failed * b, values, compared, memory, readings)


def dropout_seed(seed: int) -> int:
    return (seed + 1) & inputs.SEED_MASK


def _first_grad_norm(optimizer, p) -> float:
    """The first gradient's norm as the optimizer got it: Adam's first
    moment after one step is (1 - beta1) g."""
    state = optimizer.state.get(p)
    if not state:
        return float("nan")
    return float(state["exp_avg"].double().norm()) / (1.0 - BETA1)


def reference_steps(model_cfg, traffic, weights, pool, seed, device) -> dict:
    """The reference driven through the set-up steps: the terms of each, the
    first gradient's norms and each leaf's change."""
    import torch
    from types import SimpleNamespace
    from benchmark.reference.train import Trainer
    net = harness.reference_network(model_cfg, traffic["pipeline"], weights, device)
    trainer = Trainer(net, SimpleNamespace(**traffic["loss"]), SimpleNamespace(**traffic["train"]),
                      traffic["steps_per_epoch"], model_cfg["num_train_reg_iter"])
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
