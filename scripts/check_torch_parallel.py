"""The port's multi-device paths across cards (deepsir_tpu_torch/parallel/),
one process per card, NCCL between them.

    python3 scripts/check_torch_parallel.py [--procs 4] [--points 18000] [--device cuda]

Starts `--procs` processes, each joined to one process group by
`parallel.distributed.initialize_from_env` (the DEEPSIR_* variables) and
bound to its card, and holds each path against the same work on one card:

- the ring and all-gather searches over a (1, P) mesh, P slices of
  n x n x 64 unit descriptors (K2 on each), against K2 over the whole
  reference: near ties only (chip_smoke._search_near_ties), every rank's
  result the same; a reference of P copies of n/P rows gives K2's result
  over one copy (exact ties to the lowest index); times per call;
- over the (P, 1) mesh, `chip_smoke.parallel_steps`, the "parallel"
  phase's check of the sharded train and eval steps of the staged align
  checkpoint, on P pairs and P eval pairs (one per rank) against the plain
  steps on the whole batch on each rank's card, by its exact rules
  (matches equal); host ms per step on P cards and on one;
- over the (P/2, 2) mesh, where the ring matcher splits the reference
  cloud and its fp32 sums meet near ties: the sharded train step (the
  checkpoint under its run config, dropout 0.5 from generators seeded
  alike, its Adam state resumed) on P/2 rigid pairs against `train_step`
  on the whole batch on rank 0's card: matches equal but for near ties of
  iteration 1, loss terms of the iterations whose matches all agree within
  1e-4 relative, and with every iteration held grads within 1e-3 of each
  leaf's scale and params within 1e-6 (the train phase's rules); the
  sharded eval step (P/2 pairs, default and F+gate) against
  `make_eval_step` on rank 0's card: pred_idx equal but for near ties,
  transforms within 1e-3 up to each pair's first differing match
  (chip_smoke.held_iterations);
- the train command, `python -m deepsir_tpu_torch.cli.train --data_parallel
  true`, in P processes and in one, 2 steps of P pairs at 1024 points from
  seeded weights: one run directory each; the trained params of the two
  runs within 1e-5 on at least 99.9% of the entries and within two Adam
  steps (2 lr) on all (Adam's first step turns the grads' rounding near
  its eps into up to lr; atomic adds differ between the runs).

Prints one JSON line per check, the card's name and power limit, and last
{"ok": true, "device": {...}}; any failure raises. `--device cpu` runs the
same on the CPU with gloo (a rehearsal at small `--points`).
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

C = 64                            # descriptor width of the searches
REPS = 5                          # timed runs of each step or search
TIMEOUT = 600                     # seconds for the spawned processes
CLI_POINTS = 1024
EVAL_SETTINGS = ("default", "F+gate")


def log(record: dict) -> None:
    print(json.dumps(record), flush=True)


def rigid_pairs(rng, pairs: int, n: int, feat_len: int) -> dict:
    """Unit-normal source clouds (channels beyond xyz uniform), each with a
    reference that is a rigid motion of it (rotation up to 30 degrees,
    translation up to 1) plus noise 0.02, rows reshuffled."""
    src = rng.normal(size=(pairs, n, feat_len)).astype(np.float32)
    src[..., 3:] = rng.uniform(size=src[..., 3:].shape)
    ref = np.empty_like(src)
    gt = np.empty((pairs, 3, 4), np.float32)
    for b in range(pairs):
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
        ang = np.deg2rad(rng.uniform(0.0, 30.0))
        rot = np.eye(3) + np.sin(ang) * k + (1 - np.cos(ang)) * k @ k
        t = rng.uniform(-1.0, 1.0, size=3) / np.sqrt(3.0)
        moved = src[b].copy()
        moved[:, :3] = src[b, :, :3] @ rot.T + t + rng.normal(scale=0.02, size=(n, 3))
        ref[b] = moved[rng.permutation(n)]
        gt[b] = np.concatenate([rot, t[:, None]], axis=1)
    return {"points_src": src, "points_ref": ref, "transform_gt": gt}


class Rank:
    """One process of the group: its device and the collective helpers."""

    def __init__(self, torch, dev):
        import torch.distributed as dist
        self.torch, self.dev, self.dist = torch, dev, dist
        self.rank, self.world = dist.get_rank(), dist.get_world_size()

    def sync(self):
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize()
        self.dist.barrier()

    def gather(self, t):
        parts = [self.torch.empty_like(t) for _ in range(self.world)]
        self.dist.all_gather(parts, t.contiguous())
        return parts

    def host_ms(self, fn, reps: int = REPS) -> float:
        """Median host ms of fn() on every rank at once, each run fenced by
        a synchronize and a barrier."""
        times = []
        for _ in range(reps):
            self.sync()
            t0 = time.perf_counter()
            fn()
            self.sync()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))


def check_searches(r: Rank, n: int) -> dict:
    import chip_smoke
    from deepsir_tpu_torch.ops.distance import nearest_neighbour_index
    from deepsir_tpu_torch.parallel import (make_mesh, ring_nearest_neighbour_index,
                                            sharded_nearest_neighbour_index)
    torch = r.torch
    mesh = make_mesh(1, r.world)
    gen = torch.Generator().manual_seed(7)
    src, ref = (chip_smoke._unit_descriptors(torch, gen, r.dev, 1, n, C)[0] for _ in range(2))
    base = chip_smoke._unit_descriptors(torch, gen, r.dev, 1, n // r.world, C)[0]
    tiled = base.repeat(r.world, 1)
    whole = nearest_neighbour_index(src[None], ref[None])[0]
    record = {"check": "searches", "mesh": dict(mesh.shape), "shape": [n, n, C]}
    for name, fn in (("ring", ring_nearest_neighbour_index),
                     ("gather", sharded_nearest_neighbour_index)):
        got = fn(src, ref, mesh)
        if not all(torch.equal(g, got) for g in r.gather(got)):
            raise AssertionError(f"{name}: the ranks disagree")
        ties = chip_smoke._search_near_ties(torch, src[None], ref[None], got[None], whole[None])
        dup = fn(src, tiled, mesh)
        if not torch.equal(dup, nearest_neighbour_index(src[None], base[None])[0]):
            raise AssertionError(f"{name}: duplicates not to the lowest index")
        record[name] = {"near_ties": ties, "ms": r.host_ms(lambda: fn(src, ref, mesh))}
    record["k2_whole_ms"] = r.host_ms(lambda: nearest_neighbour_index(src[None], ref[None]))
    return record


def _resumed(dev, cfgs):
    from deepsir_tpu_torch.models.network import Network
    from deepsir_tpu_torch.training import make_optimizer
    from deepsir_tpu_torch.utils.checkpoint import load_train_state
    import chip_smoke
    model = Network(cfgs.model).to(dev)
    opt = make_optimizer(model)
    load_train_state(chip_smoke.CKPT_RUN / "ckpt", model, opt)
    return model, opt


def check_train(r: Rank, n: int) -> dict:
    """The sharded train step over the (P/2, 2) mesh against rank 0's plain
    step on the whole batch (the module docstring's rules)."""
    import chip_smoke
    from deepsir_tpu_torch.config import read_run_config, replace
    from deepsir_tpu_torch.parallel import (make_mesh, make_sharded_train_step,
                                            replicate_state, shard_batch)
    from deepsir_tpu_torch.training import device_batch, train_step
    from deepsir_tpu_torch.utils.params import trainable_parameters
    torch = r.torch
    cfgs = read_run_config(chip_smoke.CKPT_RUN)
    cfgs = cfgs._replace(model=replace(cfgs.model, num_points=n))
    shape = (r.world // 2, 2)
    mesh = make_mesh(*shape)
    arrays = rigid_pairs(np.random.default_rng(4), shape[0], n, cfgs.model.feat_len)
    spe = chip_smoke.STAGE_STEPS_PER_EPOCH
    model, opt = _resumed(r.dev, cfgs)
    replicate_state(mesh, model, opt)
    step = make_sharded_train_step(mesh)
    rows = shard_batch(mesh, arrays)
    got = step(model, opt, cfgs, rows, torch.Generator(r.dev).manual_seed(2), spe)
    # every rank holds one pair; the ranks of a model row hold the same one
    pred = torch.cat(r.gather(got["pred_idx"].contiguous()), dim=1)[:, ::shape[1]]
    record = {"check": "train", "mesh": dict(mesh.shape), "points": n, "pairs": shape[0]}
    if r.rank == 0:
        ref_model, ref_opt = _resumed(r.dev, cfgs)
        fs, fr = chip_smoke._iteration1_descriptors(
            torch, ref_model, device_batch(cfgs.model, arrays, device=r.dev))
        want = train_step(ref_model, ref_opt, cfgs, arrays,
                          torch.Generator(r.dev).manual_seed(2), spe)
        record["iteration1_gap"] = chip_smoke._search_near_ties(
            torch, fs, fr, pred[0], want["pred_idx"][0])
        got_idx, want_idx = pred.cpu().numpy(), want["pred_idx"].cpu().numpy()
        held = chip_smoke._held(got_idx, want_idx)
        record.update(held_iterations=held,
                      rows_differ=(got_idx != want_idx).sum(-1).tolist())
        terms = {k: abs(float(v) - float(want["losses"][k])) / abs(float(want["losses"][k]))
                 for k, v in got["losses"].items() if int(k[k.rfind("_") + 1:]) < held}
        if any(e > 1e-4 for e in terms.values()):
            raise AssertionError(f"train {shape}: loss terms {terms}")
        record["term_rel_err"] = max(terms.values(), default=0.0)
        if held == len(want_idx):
            record["grad_rel_err"] = chip_smoke._grads_agree(got["grads"], want["grads"], 1e-3)
            record["param_err"] = max(
                float((a - b).detach().abs().max()) for (_, a), (_, b)
                in zip(trainable_parameters(model), trainable_parameters(ref_model)))
            if record["param_err"] > 1e-6:
                raise AssertionError(f"train {shape}: params {record['param_err']} apart")
        record["plain_ms_one_card"] = float(np.median([_timed(torch, r.dev, lambda: train_step(
            ref_model, ref_opt, cfgs, arrays, torch.Generator(r.dev).manual_seed(3), spe))
            for _ in range(REPS)]))
    r.sync()
    record["sharded_ms"] = r.host_ms(lambda: step(
        model, opt, cfgs, rows, torch.Generator(r.dev).manual_seed(3), spe))
    return record


def _timed(torch, dev, fn) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def check_eval(r: Rank, n: int, name: str) -> dict:
    """The sharded eval step over the (P/2, 2) mesh (the ring splitting the
    reference cloud) against rank 0's make_eval_step on the whole batch."""
    import chip_smoke
    from deepsir_tpu_torch.config import read_run_config, replace
    from deepsir_tpu_torch.models.network import Network
    from deepsir_tpu_torch.parallel import make_mesh, make_sharded_eval_step, shard_batch
    from deepsir_tpu_torch.training import make_eval_step
    from deepsir_tpu_torch.utils.checkpoint import read_params
    from deepsir_tpu_torch.utils.params import from_jax_params
    torch = r.torch
    base = read_run_config(chip_smoke.CKPT_RUN).model
    cfg = replace(base, num_points=n, **chip_smoke.PATHS[name][0])
    state = from_jax_params(read_params(chip_smoke.CKPT_RUN / "ckpt"),
                            Network(replace(base, num_points=n)))
    extra = dict(np.load(chip_smoke.PRECISION_FIXTURE))["extra_rows"]
    net = chip_smoke._precision_model(cfg, state, extra, r.dev)
    shape = (r.world // 2, 2)
    mesh = make_mesh(*shape)
    arrays = rigid_pairs(np.random.default_rng(6), shape[0], n, cfg.feat_len)
    step = make_sharded_eval_step(net, cfg, mesh)
    rows = shard_batch(mesh, arrays)
    _, out = step(rows)
    record = {"check": f"eval {name}", "mesh": dict(mesh.shape), "points": n,
              "pairs": shape[0]}
    if r.rank == 0:
        plain = make_eval_step(net, cfg)
        _, want = plain(arrays)
        got_idx, want_idx = out.pred_idx.cpu().numpy(), want.pred_idx.cpu().numpy()
        held = chip_smoke.held_iterations(got_idx, want_idx, np.ones(want_idx.shape[:2]))
        err = np.abs(out.transforms.cpu().numpy() - want.transforms.cpu().numpy()).max(axis=(2, 3))
        held_err = max((float(err[:k, b].max()) for b, k in enumerate(held) if k), default=0.0)
        record.update(held_iterations=held.tolist(), held_transform_err=held_err,
                      rows_differ=(got_idx != want_idx).sum(-1).tolist())
        if held_err > 1e-3 or (held < 1).any() or not torch.equal(out.invalid, want.invalid):
            raise AssertionError(f"eval {name}: {record}")
        record["plain_ms_one_card"] = float(np.median(
            [_timed(torch, r.dev, lambda: plain(arrays)) for _ in range(REPS)]))
    r.sync()
    record["sharded_ms"] = r.host_ms(lambda: step(rows))
    return record


def worker(args) -> None:
    import torch
    import chip_smoke
    import deepsir_tpu_torch  # noqa: F401  (the fp32 precision flags)
    from deepsir_tpu_torch.parallel import make_mesh
    from deepsir_tpu_torch.parallel.distributed import initialize_from_env
    if not initialize_from_env(args.device):
        raise RuntimeError("no process group: the DEEPSIR_* variables are not set")
    dev = torch.device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    else:                                         # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.procs))
    r = Rank(torch, dev)
    records = [check_searches(r, args.points)]
    _, steps = chip_smoke.parallel_steps(torch, dev, make_mesh(r.world, 1), args.points,
                                         pairs=r.world)
    records.append({"check": "steps", "mesh": {"data": r.world, "model": 1}, **steps})
    if r.world % 2 == 0:
        records.append(check_train(r, args.points))
        records += [check_eval(r, args.points, name) for name in EVAL_SETTINGS]
    if r.rank == 0:
        for record in records:
            log(record)
    r.sync()
    r.dist.destroy_process_group()


def _env(extra=None):
    env = {k: v for k, v in os.environ.items() if not k.startswith("DEEPSIR_")}
    env.update(PYTHONPATH=str(ROOT), **(extra or {}))
    return env


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _run_all(cmds, envs) -> list:
    """Run the commands at once; their outputs once each has exited 0. The
    first to fail, or TIMEOUT, ends every other (a rank left waiting in a
    collective would wait for good)."""
    with tempfile.TemporaryDirectory() as tmp:
        files = [open(Path(tmp) / f"out{i}.txt", "w+") for i in range(len(cmds))]
        procs = [subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT,
                                  text=True) for cmd, env, f in zip(cmds, envs, files)]
        deadline = time.monotonic() + TIMEOUT
        try:
            while any(p.poll() is None for p in procs):
                if any(p.returncode not in (None, 0) for p in procs) or \
                        time.monotonic() > deadline:
                    break
                time.sleep(0.5)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        outs = []
        for f in files:
            f.seek(0)
            outs.append(f.read())
            f.close()
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"a process exited {p.returncode}:\n{out[-6000:]}")
    return outs


def _group_env(port: int, procs: int, rank: int) -> dict:
    return _env({"DEEPSIR_COORDINATOR": f"localhost:{port}",
                 "DEEPSIR_NUM_PROCESSES": str(procs), "DEEPSIR_PROCESS_ID": str(rank)})


def check_cli(procs: int, device: str) -> dict:
    """The train command in `procs` processes and in one (the module
    docstring's rules)."""
    from deepsir_tpu_torch.config import ModelConfig
    from deepsir_tpu_torch.utils.checkpoint import load_checkpoint
    from deepsir_tpu_torch.utils.params import trainable_parameters
    with tempfile.TemporaryDirectory() as tmp:
        flags = ["--pipeline", "align", "--dataset_type", "Synthetic", "--num_points",
                 str(CLI_POINTS), "-bs", str(procs), "--synthetic_train_size", str(2 * procs),
                 "--synthetic_eval_size", "2", "--max_epochs", "1", "-v", "0",
                 "--num_workers", "2", "--data_parallel", "true", "--device", device]
        module = [sys.executable, "-m", "deepsir_tpu_torch.cli.train"] + flags
        port = _free_port()
        one, many = Path(tmp) / "one", Path(tmp) / "many"
        t0 = time.perf_counter()
        # one process that sees several cards refuses --data_parallel: show it one
        _run_all([module + ["--logdir", str(one)]],
                 [_env({"CUDA_VISIBLE_DEVICES": "0"} if device == "cuda" else {})])
        t1 = time.perf_counter()
        _run_all([module + ["--logdir", str(many)]] * procs,
                 [_group_env(port, procs, i) for i in range(procs)])
        t2 = time.perf_counter()
        runs = [sorted(d.iterdir()) for d in (one, many)]
        if [len(x) for x in runs] != [1, 1]:
            raise AssertionError(f"cli: run directories {runs}")
        cfg = ModelConfig(num_points=CLI_POINTS)
        models = [load_checkpoint(cfg, x[0] / "ckpt", device="cpu") for x in runs]
        diffs = np.concatenate([(a - b).detach().abs().reshape(-1).numpy() for (_, a), (_, b)
                                in zip(trainable_parameters(models[0]),
                                       trainable_parameters(models[1]))])
        close = float((diffs <= 1e-5).mean())
        record = {"check": "cli", "procs": procs, "points": CLI_POINTS, "steps": 2,
                  "share_within_1e-5": close, "max_param_diff": float(diffs.max()),
                  "one_process_s": t1 - t0, "procs_s": t2 - t1}
        lr = 1e-3                                     # the train command's default
        if close < 0.999 or diffs.max() > 2 * lr or not np.isfinite(diffs).all():
            raise AssertionError(f"cli: {record}")
        return record


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=4)
    ap.add_argument("--points", type=int, default=18000)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args)
        return 0
    import torch
    if args.device == "cuda":
        if torch.cuda.device_count() < args.procs:
            raise RuntimeError(f"{args.procs} processes need {args.procs} cards, "
                               f"{torch.cuda.device_count()} visible")
        import chip_smoke
        from deepsir_tpu_torch.ops import _build
        _build.build_all(chip_smoke.KERNEL_SOURCES)   # once, before the processes load it
    port = _free_port()
    cmd = [sys.executable, __file__, "--worker", "--points", str(args.points),
           "--device", args.device, "--procs", str(args.procs)]
    outs = _run_all([cmd] * args.procs, [_group_env(port, args.procs, i)
                                         for i in range(args.procs)])
    for line in outs[0].splitlines():
        if line.startswith("{"):
            print(line, flush=True)
    log(check_cli(args.procs, args.device))
    if args.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60).stdout.strip().splitlines()
        print(smi[0], flush=True)
        kind = torch.cuda.get_device_name(0)
    else:
        kind = "cpu"
    log({"ok": True, "device": {"platform": "gpu" if args.device == "cuda" else "cpu",
                                "kind": kind, "count": args.procs}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
