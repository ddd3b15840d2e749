"""Align inference in a closed loop: `training.device_batch` then
`Network.forward_align` (no graph) on host batches drawn in turn from a
pool of distinct batches, with `in_flight` batches dispatched before the
oldest one's transforms are read back.

A batch is timed from the host's call of `device_batch` to its transforms
being on the host (a pinned copy and an event). `pairs_per_s` counts the
pairs whose transforms were back within the window, over the time from the
window's start to the last of them coming back (so that the rate does not
move in steps of a whole batch with where the window's end falls);
`pair_latency_p95_ms` is the 95th percentile over every pair of every batch
dispatched in the window (the batches still in flight at its close are
waited for).

Checked after the window (compare.py): `check_batches` pool batches drawn
from the seed, every serving of them: the last serving's pyramids,
backbone output (held by a forward hook on the feature extractor), scores,
correspondences and inlier logits, and every serving's transforms and
`invalid`, against the reference on the same host batch.
"""
from __future__ import annotations

import time
from collections import deque

import numpy as np

from benchmark import compare, harness, inputs, profiling


def _percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def run(r) -> harness.Outcome:
    """`r`: the run (run.py's Run): cell, seed, seconds, trace, device."""
    import torch
    from deepsir_tpu_torch import training
    from deepsir_tpu_torch.models.network import ForwardOptions, Network

    traffic, model_cfg = r.cell.traffic, r.cell.config["model"]
    cfg = harness.model_config(model_cfg)
    opts = ForwardOptions(**r.cell.config["forward"])
    b, pool_n = traffic["batch"], traffic["pool"]
    dev = r.device

    weights = inputs.make_weights(harness.reference_shapes(model_cfg, "align"), r.seed, dev)
    with torch.device(dev):
        model = Network(cfg, "align")
    model.load_state_dict(weights, strict=True)
    r.log_phase("weights and model")
    pool = inputs.make_pool(r.seed, pool_n, b, traffic["points"], cfg.feat_len)
    r.log_phase("host batches")
    checked = set(np.random.default_rng(r.seed).choice(pool_n, traffic["check_batches"],
                                                      replace=False).tolist())
    held = {}                                    # pool index -> the last serving's outputs
    servings = {p: [] for p in checked}          # pool index -> host (transforms, invalid)
    backbone = {}
    model.feat_extractor.register_forward_hook(lambda m, a, out: backbone.__setitem__(0, out))
    hooks = profiling.SpanHooks()
    if r.trace:
        for name in ("feat_extractor", "mlp_feat", "mlp_att", "mlp_proj"):
            hooks.add(getattr(model, name), "bench.backbone")
        hooks.add(model.inlier_model, "bench.inlier")

    def dispatch(p: int, unit: bool):
        """Dispatch pool batch p; returns its record."""
        t_call = time.perf_counter()
        with harness.span("bench.unit", unit):
            with harness.span("bench.device_batch"):
                batch = training.device_batch(cfg, pool[p], device=dev)
            with harness.span("bench.forward_align"):
                out = model.forward_align(batch, opts)
            host_t = torch.empty(out.transforms.shape, pin_memory=dev.type == "cuda")
            host_i = torch.empty(out.invalid.shape, dtype=torch.bool,
                                 pin_memory=dev.type == "cuda")
            host_t.copy_(out.transforms, non_blocking=True)
            host_i.copy_(out.invalid, non_blocking=True)
            done = torch.cuda.Event() if dev.type == "cuda" else None
            if done is not None:
                done.record()
        t_sent = time.perf_counter()
        if p in checked:
            held[p] = (batch, out, backbone[0])
        return {"p": p, "t_call": t_call, "t_sent": t_sent, "t": host_t, "inv": host_i,
                "done": done}

    def retire(rec) -> None:
        if rec["done"] is not None:
            rec["done"].synchronize()
        rec["t_done"] = time.perf_counter()
        t, inv = rec["t"].numpy().copy(), rec["inv"].numpy().copy()
        rec["ok"] = bool(np.isfinite(t).all())
        if rec["p"] in servings:
            servings[rec["p"]].append((t, inv))

    # warm-up: the cell's one shape, twice through the loop's own calls
    for p in range(min(2, pool_n)):
        retire(dispatch(p, False))
    for p in checked:
        servings[p].clear()
    harness.sync(dev)
    r.log_phase("warm-up")

    profiler = profiling.Profiler(harness.CACHE / "trace.json") if r.trace else None
    if profiler is not None:
        profiler.warm_up(dev)
    prof_units = traffic["profile_batches"]
    prof_first = None
    records, inflight = [], deque()
    i = 0
    harness.steady()
    t_start = time.perf_counter()
    r.window_started(t_start)
    t_end = t_start + r.seconds
    while time.perf_counter() < t_end:
        if profiler is not None and prof_first is None and \
                time.perf_counter() >= t_start + r.seconds / 2:
            prof_first = i
            profiler.start()
        unit = prof_first is not None and prof_first <= i < prof_first + prof_units
        try:
            rec = dispatch(i % pool_n, unit)
        except RuntimeError as exc:          # counted as failed pairs
            r.log(f"batch {i} raised: {exc!r}")
            rec = {"p": i % pool_n, "t_call": time.perf_counter(), "failed": True}
        records.append(rec)
        if not rec.get("failed"):
            inflight.append(rec)
        if len(inflight) >= traffic["in_flight"]:
            retire(inflight.popleft())
        if profiler is not None and prof_first is not None and i == prof_first + prof_units:
            profiler.stop()
        i += 1
    while inflight:
        retire(inflight.popleft())
    hooks.remove()
    memory = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    back = [rec["t_done"] for rec in records
            if not rec.get("failed") and rec["t_done"] <= t_end and rec["ok"]]
    done_in_window = len(back) * b
    latencies = [rec["t_done"] - rec["t_call"] for rec in records if not rec.get("failed")]
    failed = sum(b for rec in records if rec.get("failed") or not rec["ok"])
    values = {"pairs_per_s": done_in_window / (max(back) - t_start) if back else 0.0,
              "pair_latency_p95_ms": _percentile(latencies, 95) * 1e3 if latencies else
              float("inf")}
    r.log(f"window {r.seconds} s: {len(records)} batches of {b} dispatched, "
          f"{done_in_window} pairs back in the window, latency p50 "
          f"{_percentile(latencies, 50) * 1e3:.3f} ms p95 {values['pair_latency_p95_ms']:.3f} "
          f"ms over {len(latencies) * b} pairs")
    sent = [rec["t_sent"] - rec["t_call"] for rec in records if not rec.get("failed")]
    r.log("latency ms p90/p99/max " + "/".join(
        f"{_percentile(latencies, q) * 1e3:.3f}" for q in (90, 99, 100))
        + "; host dispatch ms p50/p95/max " + "/".join(
        f"{_percentile(sent, q) * 1e3:.3f}" for q in (50, 95, 100)))

    readings = None
    if r.trace:
        readings = profiling.readings(profiler.finish(), b, model_cfg, r.cell.config["forward"],
                                      traffic)

    # the program's state goes before the reference runs
    prog = {p: _program_side(*held[p], servings[p]) for p in checked if p in held}
    del model, held, backbone
    harness.free(dev)
    compared = check(r, weights, pool, prog, set(checked) - set(prog))
    return harness.Outcome(len(records) * b, failed, values, compared, memory, readings)


def _program_side(batch, out, backbone_out, served):
    feat, logits = backbone_out
    return {"pyramid": compare.pyramid_indices(batch.pyramid_src)
            + compare.pyramid_indices(batch.pyramid_ref),
            "feat": feat, "logits": logits,
            "score": _cat(out.score_src, out.score_ref),
            "pred_idx": out.pred_idx, "inlier_logits": out.inlier_logits,
            "servings": list(served)}


def _cat(a, b):
    import torch
    return torch.cat([a, b], dim=0)


def reference_side(model_cfg, forward, weights, arrays, device):
    """The reference on one host batch, in the form `compare.registration` reads."""
    import torch
    net = harness.reference_network(model_cfg, "align", weights, device)
    src = torch.as_tensor(arrays["points_src"], device=device)
    ref = torch.as_tensor(arrays["points_ref"], device=device)
    with torch.no_grad():
        pyr_src, pyr_ref = net.pyramids(src, ref)
        out = net.forward_align(src, ref, pyr_src, pyr_ref, forward["num_iter"],
                                forward["clip_weight"])
    return {"pyramid": compare.pyramid_indices(pyr_src) + compare.pyramid_indices(pyr_ref),
            "feat": out["feat"], "logits": out["logits"], "score": out["score"],
            "pred_idx": out["pred_idx"], "inlier_logits": out["inlier_logits"],
            "servings": [(out["transforms"].cpu().numpy(), out["invalid"].cpu().numpy())]}


def check(r, weights, pool, prog, missing) -> dict:
    """The numbers of every checked batch, each at its worst."""
    if missing:
        raise RuntimeError(f"checked pool batches {sorted(missing)} were never served")
    harness.tf32(False)
    numbers = []
    for p, side in sorted(prog.items()):
        ref = reference_side(r.cell.config["model"], r.cell.config["forward"], weights, pool[p],
                             r.device)
        numbers.append(compare.registration(side, ref))
        del ref
    return compare.worst(numbers)
