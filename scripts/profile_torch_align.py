"""Where the time goes in the PyTorch port's align inference forward, in
its training step, or in the label and feat pipelines, on one CUDA card.

    python scripts/profile_torch_align.py [--path default] [--batch 1] [--reps 3]
                                          [--out FILE]
    python scripts/profile_torch_align.py --train {parity,default,F} [--reps 3]
                                          [--out FILE]
    python scripts/profile_torch_align.py --stage {label,feat} [--reps 3]
                                          [--out FILE]
    python scripts/profile_torch_align.py --refiners [--reps 3] [--out FILE]

Drives `device_batch` -> `Network.forward_align` at chip_smoke.py's full-width
configuration (18000 points, 5 iterations, seeded random weights) along one of
chip_smoke.py's paths (default, F, F+gate, M, D, flag, R; M's clouds are
curve-sorted on the host, outside the timed steps) and prints:
- host time per step under `torch.cuda.synchronize()`: pyramid build
  (`device_batch`), backbone pass, scoring, the whole forward;
- torch.profiler over one batch: device time by kernel (top 25), the number
  of device events (kernel launches and copies), and the device's busy share
  of the window.
With --train, one `training.train_step` per rep after a warm-up step, as
chip_smoke.py's "train" phase takes them: `parity` resumes the staged align
checkpoint (its run config, dropout 0) on the 1024-point pairs of
tests/data/torch_parity_train.npz (B=2); `default` and `F` train seeded
weights at 18000 points (B=1, dropout 0.5). It prints the host time per step
(median), the peak of `torch.cuda.max_memory_allocated`, and the profile of
one step.
With --stage, the staged regimen's label or feat checkpoint at 18000 points
(B=1) under its run config, as chip_smoke.py's "label" and "feat" phases
run it (feat: circle_loss_tile 1500): the host time per
`training.forward_step` and per `training.train_step` (dropout 0.5 from a
seeded generator; medians after a warm-up), the peak of
`torch.cuda.max_memory_allocated` of each, and the profile of one of each.
With --refiners, the eval harness's refiners alone at 18000 points (B=1) on
the staged align checkpoint's eval step over the first full-width pair of
tests/data/torch_parity_ckpt.npz, as chip_smoke.py's "eval" phase times them
(chip_smoke.refiner_calls): finetune (200 Adam steps), ICP (30 iterations)
and RANSAC (4096 hypotheses): host ms per batch (median after a warm-up),
the peak of `torch.cuda.max_memory_allocated`, and the profile of one call.
With --out, the same numbers are also written there as JSON.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    import chip_smoke
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--path", default="default", choices=list(chip_smoke.PATHS))
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--train", default=None, choices=["parity", *chip_smoke.TRAIN_CASES],
                    help="profile the training step instead of the forward")
    ap.add_argument("--stage", default=None, choices=["label", "feat"],
                    help="profile the label or feat pipeline's forward and training step")
    ap.add_argument("--refiners", action="store_true",
                    help="profile the eval harness's refiners instead of a path")
    ap.add_argument("--out", type=Path, default=None, help="JSON file to write")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_align: no CUDA device", flush=True)
        return 1
    if args.train:
        return profile_train(args, torch.device("cuda", 0))
    if args.refiners:
        return profile_refiners(args, torch.device("cuda", 0))
    if args.stage:
        return profile_stage(args, torch.device("cuda", 0))
    from deepsir_tpu_torch.models.network import ForwardOptions
    from deepsir_tpu_torch.training import device_batch
    from deepsir_tpu_torch.utils.params import init_params, load_network

    dev = torch.device("cuda", 0)
    stride = chip_smoke.PATHS[args.path][1]
    cfg = chip_smoke.path_config(args.path)
    options = {k: v for k, v in vars(cfg).items() if v != getattr(type(cfg), k)}
    model = load_network(cfg, init_params(cfg, seed=0), device=dev)
    opts = ForwardOptions(num_iter=cfg.num_reg_iter, clip_weight=True, refine_stride=stride)
    rng = np.random.default_rng(0)
    morton = cfg.pyramid_order == "morton"
    feeds = [chip_smoke.make_arrays(rng, args.batch, morton, cfg.feat_len, cfg.use_ppf)
             for _ in range(args.reps + 1)]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    steps = {"device_batch": [], "backbone_pair": [], "score_pair": [],
             "forward_align": [], "end_to_end": []}
    with torch.no_grad():
        for i, arrays in enumerate(feeds):
            batch, t_pyr = timed(lambda: device_batch(cfg, arrays, device=dev))
            feats, t_bb = timed(lambda: model.backbone_pair(batch))
            _, t_sc = timed(lambda: model.score_pair(batch, feats[0], feats[2],
                                                     feats[1], feats[3]))
            _, t_fwd = timed(lambda: model.forward_align(batch, opts))
            _, t_e2e = timed(lambda: model.forward_align(
                device_batch(cfg, arrays, device=dev), opts))
            if i == 0:
                continue                                   # warm-up
            for key, t in zip(steps, (t_pyr, t_bb, t_sc, t_fwd, t_e2e)):
                steps[key].append(t)
    step_ms = {k: float(np.median(v)) for k, v in steps.items()}
    for k, v in step_ms.items():
        print(f"{k:>14}: {v:9.3f} ms (median of {args.reps}, path {args.path}, "
              f"B={args.batch})", flush=True)

    arrays = feeds[0]
    prof = profile_window(lambda: model.forward_align(device_batch(cfg, arrays, device=dev),
                                                      opts))
    return report(args, {"path": args.path, "options": options, "refine_stride": stride,
                         "batch": args.batch, "step_ms": step_ms, **prof})


def profile_window(fn):
    """torch.profiler over one call of fn(), ended by a synchronize: the
    window's host time, the device's busy time, its events (kernels and
    copies) and the top 25 kernels by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(evt):
        return getattr(evt, "self_device_time_total", None) or \
            getattr(evt, "self_cuda_time_total", 0.0)

    # device-side events only (kernels, copies): the operator entries on the
    # host carry their kernels' device time too and would count it twice, and
    # a host range's mirror on the device (the optimizer's step) spans kernels
    averages = prof.key_averages()
    host = {e.key for e in averages if e.device_type == DeviceType.CPU}
    kernels = [e for e in averages
               if e.device_type == DeviceType.CUDA and dev_us(e) > 0 and e.key not in host]
    kernels.sort(key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    events = sum(e.count for e in kernels)
    top = [{"name": e.key[:120], "count": e.count, "device_ms": dev_us(e) / 1e3}
           for e in kernels[:25]]
    print(f"profiled window {window_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"({busy_ms / window_ms:.3f} of the window), {events} device events "
          f"(kernels and copies)",
          flush=True)
    for t in top:
        print(f"{t['device_ms']:9.3f} ms {t['count']:6d}x  {t['name']}", flush=True)
    return {"window_ms": window_ms, "device_busy_ms": busy_ms, "device_events": events,
            "top": top}


def report(args, record) -> int:
    """Print the card's name and power limit; write `record` to --out."""
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    if args.out is None:
        return 0
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"device": torch.cuda.get_device_name(0),
                                    "nvidia_smi": smi, **record}, indent=1))
    return 0


def profile_train(args, dev) -> int:
    """ms per training step, peak memory and the profile of one step."""
    import torch
    import chip_smoke
    from deepsir_tpu_torch.training import train_step
    if args.train == "parity":
        fx, arrays, cfgs, model, opt, _ = chip_smoke.parity_training(dev)
        feeds = [arrays] * (args.reps + 2)
        steps_per_epoch = int(fx["steps_per_epoch"])
    else:
        cfgs, model, opt = chip_smoke.seeded_training(dev, args.train)
        rng = np.random.default_rng(0)
        feeds = [chip_smoke.train_arrays(rng, 1) for _ in range(args.reps + 2)]
        steps_per_epoch = 1
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for arrays in feeds[:-1]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train_step(model, opt, cfgs, arrays, gen, steps_per_epoch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if out["skipped"]:
            raise AssertionError(f"train {args.train}: a step was skipped")
    peak = torch.cuda.max_memory_allocated(dev)
    step_ms = float(np.median(times[1:]))
    b, n = feeds[0]["points_src"].shape[:2]
    print(f"train {args.train} {n} points B={b}: {step_ms:.3f} ms per step (median of "
          f"{args.reps} after a warm-up; {[round(t, 3) for t in times]}), peak memory "
          f"{peak / 2**30:.3f} GiB", flush=True)
    prof = profile_window(lambda: train_step(model, opt, cfgs, feeds[-1], gen, steps_per_epoch))
    return report(args, {"train": args.train, "points": int(n), "batch": int(b),
                         "ms_per_step": step_ms, "step_ms": times,
                         "max_memory_allocated": int(peak), **prof})


def _timed_runs(fn, feeds):
    """Host ms of fn(arrays) for each feed, each ended by a synchronize, and
    the peak of max_memory_allocated over them."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    times = []
    for arrays in feeds:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(arrays)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times, torch.cuda.max_memory_allocated()


def profile_stage(args, dev) -> int:
    """ms per forward and per training step of a staged checkpoint, peak
    memory of each and the profile of one of each."""
    import torch
    import chip_smoke
    from deepsir_tpu_torch.models.network import Network
    from deepsir_tpu_torch.training import forward_step, make_optimizer, train_step
    from deepsir_tpu_torch.utils.checkpoint import read_params
    from deepsir_tpu_torch.utils.params import from_jax_params
    cfgs = chip_smoke.stage_config(args.stage, chip_smoke.N_POINTS)
    model = Network(cfgs.model, args.stage)
    model.load_state_dict(from_jax_params(
        read_params(chip_smoke.STAGE_RUNS[args.stage] / "ckpt"), model))
    model.to(dev)
    rng = np.random.default_rng(0)
    feeds = [chip_smoke.stage_arrays(rng, args.stage, cfgs.model.feat_len)
             for _ in range(args.reps + 2)]
    record = {"stage": args.stage, "points": chip_smoke.N_POINTS, "batch": 1,
              "circle_loss_tile": cfgs.loss.circle_loss_tile}
    fwd_ms, fwd_peak = _timed_runs(lambda a: forward_step(model, cfgs.model, a), feeds[:-1])
    print(f"{args.stage} forward: {np.median(fwd_ms[1:]):.3f} ms (median of {args.reps} "
          f"after a warm-up; {[round(t, 3) for t in fwd_ms]}), peak memory "
          f"{fwd_peak / 2**30:.3f} GiB", flush=True)
    record["forward"] = {"ms": float(np.median(fwd_ms[1:])), "all_ms": fwd_ms,
                         "max_memory_allocated": int(fwd_peak),
                         **profile_window(lambda: forward_step(model, cfgs.model, feeds[-1]))}
    opt = make_optimizer(model)
    gen = torch.Generator(device=dev).manual_seed(0)

    def step(arrays):
        if train_step(model, opt, cfgs, arrays, gen, chip_smoke.STAGE_STEPS_PER_EPOCH)["skipped"]:
            raise AssertionError(f"{args.stage}: a step was skipped")
    step_ms, step_peak = _timed_runs(step, feeds[:-1])
    print(f"{args.stage} step: {np.median(step_ms[1:]):.3f} ms (median of {args.reps} after "
          f"a warm-up; {[round(t, 3) for t in step_ms]}), peak memory "
          f"{step_peak / 2**30:.3f} GiB", flush=True)
    record["step"] = {"ms": float(np.median(step_ms[1:])), "all_ms": step_ms,
                      "max_memory_allocated": int(step_peak),
                      **profile_window(lambda: step(feeds[-1]))}
    return report(args, record)


def profile_refiners(args, dev) -> int:
    """ms per batch, peak memory and the profile of each refiner at full width."""
    import torch
    import chip_smoke
    from deepsir_tpu_torch.utils.checkpoint import load_checkpoint
    cfgs = chip_smoke.eval_config(chip_smoke.N_POINTS)
    model = load_checkpoint(cfgs.model, chip_smoke.CKPT_RUN / "ckpt", device=dev)
    arrays = chip_smoke.checkpoint_arrays(dict(np.load(chip_smoke.CKPT_FIXTURE)),
                                          chip_smoke.N_POINTS)
    calls, _ = chip_smoke.refiner_calls(torch, dev, model, cfgs, chip_smoke._split(arrays, 2)[0])
    record = {"points": chip_smoke.N_POINTS, "batch": 1, "refiners": {}}
    for name, fn in calls.items():
        times, peak = _timed_runs(lambda _: fn(), [None] * (args.reps + 1))
        print(f"{name}: {np.median(times[1:]):.3f} ms per batch (median of {args.reps} after "
              f"a warm-up; {[round(t, 3) for t in times]}), peak memory {peak / 2**30:.3f} GiB",
              flush=True)
        record["refiners"][name] = {"ms": float(np.median(times[1:])), "all_ms": times,
                                    "max_memory_allocated": int(peak),
                                    **profile_window(fn)}
    return report(args, record)


if __name__ == "__main__":
    sys.exit(main())
