"""Smoke run of the PyTorch/CUDA port (deepsir_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ with nvcc, holds each kernel
against its plain PyTorch version at the shapes of the align forward and
times it (the KNN kernels K1 and K4 also on exact lattice ties and few-query
searches, and timed with their yardsticks by CUDA-graph replay in turns; the
match kernels K2 and K3 in both operand forms: fp32-grade 3xTF32, which the
fp32 paths run, and bf16 `low_precision`, which the bf16 paths run, each
timed in turns with a PyTorch yardstick), drives the align inference forward (`device_batch` ->
`Network.forward_align`) at full width (18000 points, 5 iterations) with
seeded random weights along eleven paths:
- default: the default configuration (kernels K1, K2), batch 1 and 2;
- F: the round-4 flagship, `dist,recip` inlier channels (K1, K3), batch 1, 2;
- F+gate: F with the relaxed mutual gate (K1, K3), batch 1;
- M: the Morton pyramid, curve-sorted clouds and windowed KNN (K1, K4, K2),
  batch 1 and 2;
- D: the deploy config, 8 inlier and backbone neighbours and a 2-level
  inlier net (K1, K2), batch 1 and 2;
- flag: the `align_flag` run's config.json read by `from_run_config` (K1,
  K3), batch 1;
- R: the default configuration with `refine_stride=4`, a second pyramid
  over the source subset inside the forward (K1, K2), batch 1;
- B16: `compute_dtype="bfloat16"` (K1, K2 in its bf16 form), batch 1 and 2;
- B16F: F under bf16 compute (K1, K3 in its bf16 form), batch 1;
- I16: `inlier_compute_dtype="bfloat16"` (K1, K2 fp32-grade), batch 1;
- PPF: `use_ppf`, feat_len 6 with unit normals (K1, K2), batch 1;
holds the port against the JAX package's outputs stored in
tests/data/torch_parity_small.npz and tests/data/torch_parity_paths.npz;
and runs trained weights: the staged align checkpoint, read by the port's
own msgpack decoder, on the synthetic pairs of
tests/data/torch_parity_ckpt.npz, against JAX's outputs at 1024 points and
against the same forward with every kernel replaced by its plain version at
18000 points; and trains ("train" phase): the staged checkpoint resumed with
its Adam state for two steps on the 1024-point pairs of
tests/data/torch_parity_train.npz against JAX's stored steps, four
full-width steps (18000 points, dropout 0.5) each on the default options
(K1, K2) and F (K1, K3) with seeded weights, one step of each and of the
staged checkpoint at 18000 points against the same step with plain versions
of every kernel, and a checkpoint written and read back; then the label and
feat pipelines ("label" and "feat" phases): the staged regimen's label and
feat checkpoints, read by the port's decoder, against JAX's stored eval
forward and resumed training step at 1024 points
(tests/data/torch_parity_stages.npz), and at 18000 points under their run
configs (feat: circle_loss_tile 1500) the forward (`training.forward_step`)
and a training step against the plain kernels, the forward timed, four
training steps at dropout 0.5 (label: random labels; feat: rigid pairs),
K1 16 times per forward and per step, and a checkpoint round trip; and the
"stages" phase: `utils.checkpoint.partial_restore` label -> feat -> align
on the card with JAX's leaf counts; and the eval harness ("eval" phase):
each refiner on JAX's own inputs against its float64 references and float32
results, the staged align checkpoint on the 8 checkpoint pairs at 1024
points through `device_prefetch` -> `make_eval_step` -> `inference_align`
-> `evaluate_align` -> `save_eval_align` under seven refiner settings
against tests/data/torch_parity_eval.npz (success flags, refined poses,
per-pair metrics, the written CSVs and xlsx sheets), the label and feat
sweeps, and at 18000 points the sweep with every refiner on (seeded weights
and the staged checkpoint; K1 16 per eval step and 30 per ICP batch, K2 5
per eval step), each refiner timed alone with its peak memory, and ICP's 30
K1 searches held against `knn_topk_plain`; and the command lines ("cli" phase):
the test command (`deepsir_tpu_torch.cli.test.main`, in this process so that
its launches count) on the tracked staged eval command (128 synthetic pairs
at 1024 points, the staged align checkpoint) against JAX's test.py in
tests/data/torch_parity_cli.npz, on the tracked finetune and pose-average
commands and the finetune command with ICP instead (16 pairs), and in
--transform_file mode on JAX's stored transforms; the train command
(`cli.train.main`) on the staged align train command for one epoch of 32
pairs with a validation, the test command resuming the checkpoint it wrote,
the label and feat train commands one epoch each; both at 18000 points with
seeded weights; and each once as `python -m` in a process of its own;
and bf16 compute and point-pair features ("precision" phase): the staged
align checkpoint on the checkpoint pairs at 1024 points under B16, B16F
(its inlier input layer widened by the fixture's two seeded rows), I16
and fp32 against JAX's outputs in tests/data/torch_parity_precision.npz
(the discriminating rule: the port's distance from JAX's bf16 output
against JAX's own bf16-to-fp32 gap), one bf16 align step of the
checkpoint against JAX's, B16 and B16F at full width against the same
forward with every kernel replaced by its plain version, a full-width
bf16 align step and a `use_ppf` label step against the plain versions,
and the test command with --compute_dtype bfloat16 on 4 full-width
pairs; and the multi-device paths ("parallel" phase): a process group of
this one process through `parallel.distributed.initialize_from_env`
(NCCL), its (1, 1) mesh, the staged align checkpoint at 18000 points
through `make_sharded_train_step` (B=2, the Adam state resumed and
replicated) against `train_step`, and through `make_sharded_eval_step`
(B=1, default and F+gate) against `make_eval_step`, each timed in turns;
and the ring search's arithmetic over 2 and 4 slices of 18000 x 18000 x 64
descriptors, each rank's walk with `_local_min` (K2) and `_merge` in one
process, against K2 over the whole reference, also on tiled duplicates.
Imports neither JAX nor the JAX package.

Output: one line per phase with its wall time; then a JSON line
{"paths": [...]}, a JSON line {"checkpoint": {...}}, a JSON line
{"train": {...}}, a JSON line {"stages": {...}}, a JSON line
{"eval": {...}} (with the card's name and power limit), a JSON line
{"cli": {...}}, a JSON line {"precision": {...}}, a JSON line
{"parallel": {...}} (with the card's name and power limit), a JSON line
{"kernels": [...]} (K2's and K3's launches by operand form under
"forms"), the card's name and power
limit as nvidia-smi reports them, and last {"ok": true, "device": {...}}.
Any failure raises: the exit code is not 0 and the last line is not
printed. Needs one CUDA card.
"""
from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
from contextlib import contextmanager, nullcontext
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
FIXTURES = (ROOT / "tests" / "data" / "torch_parity_small.npz",
            ROOT / "tests" / "data" / "torch_parity_paths.npz")
CKPT_FIXTURE = ROOT / "tests" / "data" / "torch_parity_ckpt.npz"
CKPT_RUN = ROOT / "logs_r3" / "staged_po" / "260817_191109_align"
FLAG_RUN = ROOT / "logs_r4" / "260819_171529_align_flag"

N_POINTS = 18000          # bench.py's protocol
N_ITERS = 5
CLI_POINTS = 1024        # the tracked staged commands' --num_points
FEAT_LEN = 4
TIMED_REPS = 3
KERNEL_SOURCES = ("knn_topk", "match_argmin", "match_bidir", "knn_windowed")

# published H100 SXM peaks (NVIDIA data sheet, dense, 700 W)
PEAK_FP32_FLOPS = 67e12          # CUDA cores
PEAK_TF32_FLOPS = 495e12         # tensor cores
PEAK_BF16_FLOPS = 989e12         # tensor cores
PEAK_BYTES = 3.35e12
# the match kernels' operand forms: (low_precision flag, tensor-core
# products per multiply-add, their peak)
FORMS = {"fp32x3": (False, 3, PEAK_TF32_FLOPS), "bf16": (True, 1, PEAK_BF16_FLOPS)}

FLAGSHIP = dict(inlier_extra_feats="dist,recip", clip_weight_thresh=0.05)
DEPLOY = dict(inlier_num_knn=8, inlier_num_layers=2, backbone_num_knn=8)   # README
BF16 = dict(compute_dtype="bfloat16")
PPF = dict(use_ppf=True, feat_len=6)
# path -> (ModelConfig options, or the run whose config.json gives them;
# ForwardOptions.refine_stride; launches per batch of K1, K4, K2, K3, all
# forms; launches per batch of K2, K3 in the bf16 form)
PATHS = {
    "default": ({}, 1, (16, 0, 5, 0), (0, 0)),
    "F": (FLAGSHIP, 1, (16, 0, 0, 5), (0, 0)),
    "F+gate": (dict(FLAGSHIP, mutual_check=True, mutual_check_tol=0.6), 1, (16, 0, 0, 5),
               (0, 0)),
    "M": (dict(pyramid_order="morton", knn_window_halo=1), 1, (10, 6, 5, 0), (0, 0)),
    "D": (DEPLOY, 1, (16, 0, 5, 0), (0, 0)),
    "flag": (FLAG_RUN, 1, (16, 0, 0, 5), (0, 0)),
    "R": ({}, 4, (24, 0, 5, 0), (0, 0)),
    "B16": (BF16, 1, (16, 0, 5, 0), (5, 0)),
    "B16F": (dict(FLAGSHIP, **BF16), 1, (16, 0, 0, 5), (0, 5)),
    "I16": (dict(inlier_compute_dtype="bfloat16"), 1, (16, 0, 5, 0), (0, 0)),
    "PPF": (PPF, 1, (16, 0, 5, 0), (0, 0)),
}
RUNS = (("default", 1), ("default", 2), ("F", 1), ("F", 2), ("F+gate", 1),
        ("M", 1), ("M", 2), ("D", 1), ("D", 2), ("flag", 1), ("R", 1),
        ("B16", 1), ("B16", 2), ("B16F", 1), ("I16", 1), ("PPF", 1))
COUNTED = ("knn_topk", "knn_topk_windowed", "match_argmin", "match_argmin_bidirectional")
# the eval harness's refiner settings (EvalConfig fields) held against JAX
EVAL_SETTINGS = {
    "none": {},
    "finetune": {"use_finetune": True},
    "average3": {"pose_average_last": 3},
    "icp": {"use_icp": True},
    "ransac": {"use_ransac": True},
    "all": {"use_finetune": True, "pose_average_last": 3, "use_icp": True, "use_ransac": True},
    "float16": {"transfer_dtype": "float16"},
}
LP_COUNTED = COUNTED[2:]          # these also count their bf16-form launches


def log(msg: str) -> None:
    print(msg, flush=True)


@contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    log(f"[phase] {name} ...")
    yield
    log(f"[phase] {name} done in {time.perf_counter() - t0:.3f} s")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` back-to-back runs, after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _graph(fn, reps: int):
    """A CUDA graph of `reps` calls of fn(), captured after a warm-up call on
    a side stream (which also fills every cache the call keeps)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph


def _replay_ms(graph, reps: int, replays: int = 3) -> float:
    """Mean device time of one call in `replays` replays of a graph of `reps`
    calls: the calls run back to back on the device, with no host launch
    between them."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def _graph_in_turns(kernel, library, reps: int, library_reps: int):
    """Kernel and yardstick, each captured once into a CUDA graph, replayed in
    turns (kernel, library, library, kernel); returns (kernel ms, library ms,
    every run)."""
    gk, gl = _graph(kernel, reps), _graph(library, library_reps)
    k1, l1 = _replay_ms(gk, reps), _replay_ms(gl, library_reps)
    l2, k2 = _replay_ms(gl, library_reps), _replay_ms(gk, reps)
    return (k1 + k2) / 2, (l1 + l2) / 2, {"kernel_runs": [k1, k2], "library_runs": [l1, l2],
                                          "timing": f"CUDA graph replay, {reps} kernel and "
                                                    f"{library_reps} yardstick calls a graph"}


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_FP32_FLOPS):
    """(least time in ms, what bounds it) at the published peaks."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def kernels():
    """The port's kernel wrappers by name; each counts its launches."""
    from deepsir_tpu_torch.ops.cuda_knn import knn_topk, knn_topk_windowed
    from deepsir_tpu_torch.ops.cuda_match import match_argmin, match_argmin_bidirectional
    return dict(zip(COUNTED, (knn_topk, knn_topk_windowed, match_argmin,
                              match_argmin_bidirectional)))


def reset_counts(counted) -> None:
    for fn in counted.values():
        fn.launches = 0
    for key in LP_COUNTED:
        counted[key].launches_lp = 0


def read_counts(counted):
    """(launches per kernel, bf16-form launches per match kernel)."""
    return ({k: fn.launches for k, fn in counted.items()},
            {k: counted[k].launches_lp for k in LP_COUNTED})


def make_arrays(rng, batch: int, morton: bool = False, feat_len: int = FEAT_LEN,
                normals: bool = False):
    """Random pair clouds as bench.py's make_arrays makes them (bench.py:116-133),
    curve-sorted on the host under Morton order; with `normals` channels 3:6
    are random unit vectors (the point-pair features' normals)."""
    from deepsir_tpu_torch.ops.morton import sort_clouds
    n = N_POINTS
    xyz = rng.normal(size=(batch, n, 3)).astype(np.float32) * 10.0
    extra = rng.uniform(size=(batch, n, feat_len - 3)).astype(np.float32)
    pts = np.concatenate([xyz, extra], axis=-1)
    xyz2 = rng.normal(size=(batch, n, 3)).astype(np.float32) * 10.0
    pts2 = np.concatenate(
        [xyz2, rng.uniform(size=(batch, n, feat_len - 3)).astype(np.float32)], axis=-1)
    if normals:
        for cloud in (pts, pts2):
            nrm = rng.normal(size=(batch, n, 3))
            cloud[..., 3:6] = nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)
    if morton:
        pts, pts2 = sort_clouds(pts), sort_clouds(pts2)
    return {"points_src": pts, "points_ref": pts2,
            "transform_gt": np.tile(np.eye(3, 4, dtype=np.float32), (batch, 1, 1))}


def _knn_agree(torch, name, got, want, what="K1"):
    """A KNN kernel and its plain version must give equal indices and equal
    distances."""
    (idx, dist), (pidx, pdist) = got, want
    torch.cuda.synchronize()
    n_bad = int((idx != pidx).sum())
    err = float((dist - pdist).abs().max())
    if n_bad or err != 0.0:
        raise AssertionError(f"{what} {name}: {n_bad} indices differ, max dist diff {err}")
    return n_bad, err


def _timed_shape(name, q, r, k, ms, plain_ms, library_ms, pairs):
    """A kernels-line shape record; `pairs` is the pair distances the call needs."""
    b, nq, d = q.shape
    m = r.shape[1]
    flops = (3.0 * d - 1) * pairs                     # d sub, d mul, d-1 add per pair
    nbytes = 4.0 * b * (nq + m) * d + 12.0 * b * nq * k
    bms, by = bound_ms(flops, nbytes)
    return {"case": name, "shape": f"query {tuple(q.shape)} x ref {tuple(r.shape)}, k={k}",
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bms, "bound_by": by}


def _lattice(torch, gen, dev, b, n, d):
    """Points with integer coordinates in a small grid (6 per axis in 3-D,
    3 per axis in 8-D): every distance is an integer, so many refs tie."""
    cells = 6 if d == 3 else 3
    return torch.randint(0, cells, (b, n, d), generator=gen).float().to(dev)


def check_knn(torch, dev, gen):
    """K1 against knn_topk_plain on the card at every shape the paths launch;
    returns the kernels-line entry."""
    from deepsir_tpu_torch.ops.cuda_knn import knn_topk, knn_topk_plain
    base = torch.randn(1, 700, 3, generator=gen).to(dev)

    def rand(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    # every other instance of the kernel (k up to 32, D up to 8, ragged
    # sizes, exact duplicate points), checked but not timed
    for name, q, r, k in [("k=32 D=5 B=2", rand(2, 1000, 5), rand(2, 1500, 5), 32),
                          ("k=7", rand(1, 777, 3), rand(1, 999, 3), 7),
                          ("k=4 D=8", rand(1, 300, 8), rand(1, 600, 8), 4),
                          ("k=M=3", rand(1, 500, 3), rand(1, 3, 3), 3),
                          ("duplicates k=4", base, torch.cat([base, base], 1), 4)]:
        _knn_agree(torch, name, knn_topk(q, r, k), knn_topk_plain(q, r, k))
    log("K1 agrees with its plain version at k in {3, 4, 7, 32}, D in {3, 5, 8}, "
        "ragged sizes and duplicate points")

    # exact ties and the split sweep: a lattice (integer coordinates, so many
    # refs lie at exactly the k-th distance, across lanes and split warps),
    # and N = 1, 31 and 100 queries against 18000 refs (few queries: the
    # block's warps split the sweep), at k 1, 16, 32, D 3 and 8, B = 2
    for d in (3, 8):
        lat = _lattice(torch, gen, dev, 2, N_POINTS, d)
        big = rand(2, N_POINTS, d)
        few = [(f"lattice self D={d}", lat, lat),
               (f"lattice N=31 D={d}", lat[:, :31].contiguous(), lat)]
        few += [(f"N={nq} D={d}", rand(2, nq, d), big) for nq in (1, 31, 100)]
        for k in (1, 16, 32):
            for name, q, r in few:
                _knn_agree(torch, f"{name} k={k} B=2", knn_topk(q, r, k), knn_topk_plain(q, r, k))
    log(f"K1 agrees with its plain version on a lattice (exact ties at the k-th "
        f"distance) and at N in {{1, 31, 100}} against {N_POINTS} refs, k in {{1, 16, 32}}, "
        f"D in {{3, 8}}, B=2")

    # the drivers' batches: B=8 at the 1024-point pyramid's levels (the train
    # and validation batches of the "cli" phase), every batch slot checked;
    # drawn from a generator of their own, so that the timed shapes below and
    # the later kernels' inputs stay those of the earlier runs
    own = torch.Generator().manual_seed(1)
    pts8 = torch.randn(8, CLI_POINTS, 3, generator=own).mul_(10.0).to(dev)
    n = CLI_POINTS
    for lvl in range(4):
        lp, sub = pts8[:, :n].contiguous(), pts8[:, :n // 4].contiguous()
        _knn_agree(torch, f"level {lvl} self B=8 N={n}", knn_topk(lp, lp, 16),
                   knn_topk_plain(lp, lp, 16))
        _knn_agree(torch, f"level {lvl} upsample B=8 N={n}", knn_topk(lp, sub, 1),
                   knn_topk_plain(lp, sub, 1))
        n //= 4
    log(f"K1 agrees with its plain version at B=8 on the {CLI_POINTS}-point pyramid's "
        f"searches (k 16 self, k 1 upsample, every level)")

    # the pyramid's searches: per level a k=16 self-search and a k=1 search
    # into the next level, at batch 1 and 2
    pts = torch.randn(2, N_POINTS, 3, generator=gen).mul_(10.0).to(dev)
    cases, n = [], N_POINTS
    for lvl in range(4):
        for b in (1, 2):
            lp = pts[:b, :n].contiguous()
            cases.append((f"level {lvl} self B={b}", lp, lp, 16))
            cases.append((f"level {lvl} upsample B={b}", lp, pts[:b, :n // 4].contiguous(), 1))
        n //= 4
    # ICP's search (ops/icp.py, 30 per batch): every moved source point's
    # nearest point of the target cloud, k=1 at full width
    target = torch.randn(1, N_POINTS, 3, generator=own).mul_(10.0).to(dev)
    cases.append(("ICP k=1 B=1", pts[:1].contiguous(), target, 1))
    shapes, err_max = [], 0.0
    for name, q, r, k in cases:
        _, err = _knn_agree(torch, name, knn_topk(q, r, k), knn_topk_plain(q, r, k))
        err_max = max(err_max, err)
        event_ms = cuda_ms(lambda: knn_topk(q, r, k), 5)
        plain_ms = cuda_ms(lambda: knn_topk_plain(q, r, k), 2)

        def library():
            for s in range(0, q.shape[1], 2048):
                torch.topk(torch.cdist(q[:, s:s + 2048], r), k, dim=-1, largest=False)
        ms, library_ms, runs = _graph_in_turns(lambda: knn_topk(q, r, k), library, 50, 2)
        rec = _timed_shape(name, q, r, k, ms, plain_ms, library_ms,
                           q.shape[0] * q.shape[1] * r.shape[1])
        rec.update(runs, event_ms=event_ms)
        shapes.append(rec)
        log(f"K1 {name}: {rec['shape']}: indices equal, max dist diff 0; kernel "
            f"{ms:.4f} ms {runs['kernel_runs']} (graph; events {event_ms:.4f} ms), plain "
            f"{plain_ms:.4f} ms, cdist+topk {library_ms:.4f} ms {runs['library_runs']} "
            f"(graph), bound {rec['bound_ms']:.3g} ms ({rec['bound_by']})")
    main = shapes[0]                                  # level-0 self-search, B=1
    return {"name": "knn_topk (K1)", "route": "cuda",
            "source": "deepsir_tpu_torch/csrc/knn_topk.cu",
            "replaces": "deepsir_tpu/ops/pallas_knn.py:130",
            "core": "deepsir_tpu_torch/csrc/knn_select.cuh",
            "shape": main["shape"], "max_abs_err": err_max, "index_mismatches": 0,
            "ms": main["ms"], "kernel_ms": main["ms"], "event_ms": main["event_ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "timing": main["timing"], "shapes": shapes}


def _near_ties(torch, what, a, b, qry, cand, idx, pidx, low_precision=False):
    """Kernel indices `idx` into `cand` for rows of `qry` may differ from the
    plain version's `pidx` only on near ties: at most 0.1% of rows, each
    within 1e-5 relative of the plain minimum (float64 distances). Under
    `low_precision` the distance is the bf16 form's own,
    |q|^2 + |c|^2 - 2 bf16(q).bf16(c) with the norms from the fp32 inputs, so
    that the rule measures the order of the sums and not bf16 rounding.
    Returns (rows that differ, max abs distance gap, max relative gap)."""
    torch.cuda.synchronize()
    q64, c64 = qry.double(), cand.double()
    if low_precision:
        qb, cb = qry.to(torch.bfloat16).double(), cand.to(torch.bfloat16).double()
        q_sq, c_sq = (q64 * q64).sum(-1), (c64 * c64).sum(-1)

        def dist(i):
            rows = torch.gather(cb, 1, i[..., None].expand(qb.shape))
            return q_sq + torch.gather(c_sq, 1, i) - 2.0 * (qb * rows).sum(-1)
    else:
        def dist(i):
            return ((q64 - torch.gather(c64, 1, i[..., None].expand(q64.shape))) ** 2).sum(-1)
    d_k, d_p = dist(idx), dist(pidx)
    differ = idx != pidx
    gap = (d_k - d_p).abs()
    rows = int(differ.sum())
    rel = float((gap / d_p.abs().clamp_min(1e-12))[differ].max()) if rows else 0.0
    if rel > 1e-5 or rows > 1e-3 * idx.numel():
        raise AssertionError(f"{what} {a}x{b}: {rows} of {idx.numel()} rows differ, "
                             f"worst relative distance gap {rel}")
    return rows, float(gap.max()), rel


def _unit_descriptors(torch, gen, dev, b, n, c):
    x = torch.randn(b, n, c, generator=gen).to(dev)
    return x / x.norm(dim=-1, keepdim=True)


def _in_turns(kernel, library, reps: int, library_reps: int):
    """Kernel and yardstick timed in turns (kernel, library, library, kernel);
    returns (kernel ms, library ms, every run)."""
    k1, l1 = cuda_ms(kernel, reps), cuda_ms(library, library_reps)
    l2, k2 = cuda_ms(library, library_reps), cuda_ms(kernel, reps)
    return (k1 + k2) / 2, (l1 + l2) / 2, {"kernel_runs": [k1, k2], "library_runs": [l1, l2]}


def _rand(torch, gen, dev):
    def rand(*shape):
        return torch.randn(*shape, generator=gen).to(dev)
    return rand


def _match_cases(torch, dev, gen):
    """Planted exact ties (every row of `base` three times, the first 100
    rows of `base` as queries) and the paths' 18000 x 18000 x 64 unit
    descriptors at B = 1, 2: the instances both match kernels take besides
    their ragged ones."""
    base = _rand(torch, gen, dev)(1, 300, 64)
    tripled = torch.cat([base, base.flip(1), base], 1)
    big = [(b, _unit_descriptors(torch, gen, dev, b, N_POINTS, 64),
            _unit_descriptors(torch, gen, dev, b, N_POINTS, 64)) for b in (1, 2)]
    return (base[:, :100].contiguous(), tripled), big


def _form_record(form, shapes, err_max, rows_max, library):
    """The per-form part of a match kernel's kernels-line entry (B=1 at the
    top, every timed shape under `shapes`)."""
    main = shapes[0]
    keys = ("shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "bound_fp32_ms")
    return {"form": form, **{k: main[k] for k in keys}, "kernel_ms": main["ms"],
            "library": library, "max_abs_err": err_max, "rows_differ": rows_max,
            "shapes": shapes}


def _match_entry(name, source, replaces, forms):
    """A match kernel's kernels-line entry: the fp32-grade form, which the
    paths run, at the top level; both forms under `forms`."""
    return {"name": name, "route": "cuda", "source": f"deepsir_tpu_torch/csrc/{source}",
            "core": "deepsir_tpu_torch/csrc/match_core.cuh",
            "replaces": f"deepsir_tpu/ops/{replaces}", **forms["fp32x3"], "forms": forms}


def _timed_match(b, src, ref, kernel, plain, library, products, peak, nbytes, agree):
    """Agreement and times of one form at one 18000 x 18000 shape."""
    n, c = src.shape[1], src.shape[2]
    rows, err = agree()
    plain_ms = cuda_ms(plain, 3)
    ms, library_ms, runs = _in_turns(kernel, library, 10, 3)
    flops = 2.0 * b * n * ref.shape[1] * c
    bms, by = bound_ms(products * flops, nbytes, peak)
    return {"case": f"B={b}", "shape": f"src {tuple(src.shape)} x ref {tuple(ref.shape)}",
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bms,
            "bound_by": by, "bound_fp32_ms": bound_ms(flops, nbytes)[0],
            "rows_differ": rows, "max_abs_err": err, **runs}


def _distances(torch, lp):
    """The yardsticks' distance tile ref_sq - 2 s.r as one fp32 `addmm`; in
    the bf16 form the operands are bf16 (cast once, outside the timed
    loop), and the sums and the tile stay fp32 (`out_dtype`)."""
    def tile(ref_sq, s, r):
        if lp:
            return torch.addmm(ref_sq, s, r.T, alpha=-2.0, out_dtype=torch.float32)
        return torch.addmm(ref_sq, s, r.T, alpha=-2.0)
    return tile


def check_match(torch, dev, gen):
    """K2 in both forms against match_argmin_plain on the card; returns the
    kernels-line entry."""
    from deepsir_tpu_torch.ops.cuda_match import match_argmin, match_argmin_plain
    rand = _rand(torch, gen, dev)
    # ragged sizes and other widths, checked but not timed
    others = [("C=100 B=2", rand(2, 1000, 100), rand(2, 777, 100)),
              ("C=3", rand(1, 300, 3), rand(1, 5000, 3)),
              ("M=1", rand(1, 65, 64), rand(1, 1, 64))]
    # the drivers' B=8 batches at 1024 points (own generator, as in check_knn)
    own = torch.Generator().manual_seed(1)
    others.append((f"B=8 N=M={CLI_POINTS}",
                   *(_unit_descriptors(torch, own, dev, 8, CLI_POINTS, 64) for _ in range(2))))
    (head, tripled), big = _match_cases(torch, dev, gen)
    forms = {}
    for form, (lp, products, peak) in FORMS.items():
        for name, s, r in others:
            _near_ties(torch, f"K2 {form} {name}", s.shape[1], r.shape[1], s, r,
                       match_argmin(s, r, lp), match_argmin_plain(s, r, lp), lp)
        tied = match_argmin(head, tripled, lp)
        if not torch.equal(tied[0], torch.arange(100, device=tied.device)):
            raise AssertionError(f"K2 {form}: planted exact ties did not go to the lowest index")
        log(f"K2 {form} agrees with its plain version at C in {{3, 64, 100}}, ragged N "
            f"and M, M=1, B=8 at {CLI_POINTS} points, and planted ties go to the lowest index")
        library = ("chunked addmm + argmin" if not lp else
                   "chunked bf16 addmm (fp32 sums and output) + argmin")
        tile = _distances(torch, lp)
        shapes, err_max, rows_max = [], 0.0, 0
        for b, src, ref in big:
            n = src.shape[1]
            ref_sq = (ref * ref).sum(-1)
            ys, yr = (src.bfloat16(), ref.bfloat16()) if lp else (src, ref)

            def yardstick():
                for i in range(b):
                    for s0 in range(0, n, 4096):
                        tile(ref_sq[i], ys[i, s0:s0 + 4096], yr[i]).argmin(dim=-1)

            def agree():
                rows, err, _ = _near_ties(torch, f"K2 {form} 18000 x 18000 B={b}", n, n,
                                          src, ref, match_argmin(src, ref, lp),
                                          match_argmin_plain(src, ref, lp), lp)
                return rows, err
            rec = _timed_match(b, src, ref, lambda: match_argmin(src, ref, lp),
                               lambda: match_argmin_plain(src, ref, lp), yardstick,
                               products, peak, 4.0 * b * (2 * n * 64 + n) + 8.0 * b * n, agree)
            shapes.append(rec)
            err_max, rows_max = max(err_max, rec["max_abs_err"]), max(rows_max, rec["rows_differ"])
            log(f"K2 {form} {rec['shape']}: {rec['rows_differ']} rows differ (near ties); "
                f"kernel {rec['ms']:.4f} ms {rec['kernel_runs']}, plain {rec['plain_ms']:.4f} "
                f"ms, {library} {rec['library_ms']:.4f} ms {rec['library_runs']}, bound "
                f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}; fp32 CUDA cores "
                f"{rec['bound_fp32_ms']:.4f} ms)")
        forms[form] = _form_record(form, shapes, err_max, rows_max, library)
    return _match_entry("match_argmin (K2)", "match_argmin.cu", "pallas_match.py:215", forms)


def _bidir_agree(torch, name, src, ref, got, want, lp=False):
    """K3's rows and columns, each by the near-tie rule; returns
    (rows + columns that differ, max abs distance gap)."""
    (idx, ridx), (pidx, pridx) = got, want
    r1, g1, _ = _near_ties(torch, f"K3 rows {name}", src.shape[1], ref.shape[1],
                           src, ref, idx, pidx, lp)
    r2, g2, _ = _near_ties(torch, f"K3 columns {name}", ref.shape[1], src.shape[1],
                           ref, src, ridx, pridx, lp)
    return r1 + r2, max(g1, g2)


def check_bidir(torch, dev, gen):
    """K3 in both forms against match_argmin_bidirectional_plain on the card;
    returns the kernels-line entry."""
    from deepsir_tpu_torch.ops.cuda_match import (match_argmin_bidirectional,
                                                  match_argmin_bidirectional_plain)
    kern, plain = match_argmin_bidirectional, match_argmin_bidirectional_plain
    rand = _rand(torch, gen, dev)
    others = [("ragged N!=M B=2", rand(2, 1000, 64), rand(2, 777, 64)),
              ("C=100", rand(1, 700, 100), rand(1, 1300, 100)),
              ("C=3", rand(1, 300, 3), rand(1, 5000, 3)),
              ("N=1", rand(1, 1, 64), rand(1, 500, 64)),
              ("M=1", rand(1, 65, 64), rand(1, 1, 64))]
    (head, tripled), big = _match_cases(torch, dev, gen)
    forms = {}
    for form, (lp, products, peak) in FORMS.items():
        for name, s, r in others:
            _bidir_agree(torch, f"{form} {name}", s, r, kern(s, r, lp), plain(s, r, lp), lp)
        want = torch.arange(100, device=head.device)
        if not torch.equal(kern(head, tripled, lp)[0][0], want):
            raise AssertionError(f"K3 {form}: planted row ties did not go to the lowest ref index")
        if not torch.equal(kern(tripled, head, lp)[1][0], want):
            raise AssertionError(f"K3 {form}: planted column ties did not go to the lowest "
                                 "src index")
        log(f"K3 {form} agrees with its plain version in both directions at ragged "
            f"N != M, C in {{3, 64, 100}}, N=1, M=1, and planted ties go to the lowest "
            f"index both ways")
        library = ("chunked addmm + argmin both ways" if not lp else
                   "chunked bf16 addmm (fp32 sums and output) + argmin both ways")
        tile = _distances(torch, lp)
        shapes, err_max, rows_max = [], 0.0, 0
        for b, src, ref in big:
            n = src.shape[1]
            ref_sq, src_sq = (ref * ref).sum(-1), (src * src).sum(-1)
            ys, yr = (src.bfloat16(), ref.bfloat16()) if lp else (src, ref)

            def yardstick():
                for i in range(b):
                    col_d = torch.full((n,), float("inf"), device=src.device)
                    col_i = torch.zeros(n, dtype=torch.int64, device=src.device)
                    for s0 in range(0, n, 4096):
                        d = tile(ref_sq[i], ys[i, s0:s0 + 4096], yr[i])
                        d.argmin(dim=-1)
                        cmin, carg = (d + src_sq[i, s0:s0 + 4096, None]).min(dim=0)
                        take = cmin < col_d
                        col_d = torch.where(take, cmin, col_d)
                        col_i = torch.where(take, carg + s0, col_i)

            def agree():
                return _bidir_agree(torch, f"{form} 18000 x 18000 B={b}", src, ref,
                                    kern(src, ref, lp), plain(src, ref, lp), lp)
            rec = _timed_match(b, src, ref, lambda: kern(src, ref, lp),
                               lambda: plain(src, ref, lp), yardstick, products, peak,
                               4.0 * b * 2 * (n * 64 + n) + 16.0 * b * n, agree)
            rec["rows_and_columns_differ"] = rec["rows_differ"]
            shapes.append(rec)
            err_max, rows_max = max(err_max, rec["max_abs_err"]), max(rows_max, rec["rows_differ"])
            log(f"K3 {form} {rec['shape']}: {rec['rows_differ']} rows + columns differ "
                f"(near ties); kernel {rec['ms']:.4f} ms {rec['kernel_runs']}, plain "
                f"{rec['plain_ms']:.4f} ms, {library} {rec['library_ms']:.4f} ms "
                f"{rec['library_runs']}, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}; "
                f"fp32 CUDA cores {rec['bound_fp32_ms']:.4f} ms)")
        forms[form] = _form_record(form, shapes, err_max, rows_max, library)
    return _match_entry("match_argmin_bidirectional (K3)", "match_bidir.cu",
                        "pallas_match.py:147", forms)


def _in_window(torch, name, idx, n, m, halo):
    """Every index K4 returns lies in its query tile's window."""
    from deepsir_tpu_torch.ops.window import TQ, start_rows
    rows, starts = start_rows(n, m, halo)
    lo = torch.tensor(starts, device=idx.device).repeat_interleave(TQ)[:n]
    hi = (lo + rows).clamp(max=m)
    inside = (idx >= lo[None, :, None]) & (idx < hi[None, :, None])
    if not bool(inside.all()):
        raise AssertionError(f"K4 {name}: {int((~inside).sum())} indices outside the window")
    return rows, starts


def check_windowed(torch, dev, gen):
    """K4 against knn_topk_windowed_plain on the card at the Morton pyramid's
    windowed searches; returns the kernels-line entry."""
    from deepsir_tpu_torch.ops.cuda_knn import knn_topk_windowed, knn_topk_windowed_plain
    from deepsir_tpu_torch.ops.morton import sort_clouds
    from deepsir_tpu_torch.ops.window import TQ, windowed
    halo = 1

    def sorted_cloud(b, n, d):
        pts = torch.randn(b, n, d, generator=gen).mul_(10.0).numpy()
        return torch.from_numpy(sort_clouds(pts)).contiguous().to(dev)

    def check(name, q, r, k):
        if not windowed(q.shape[1], r.shape[1], halo):
            raise AssertionError(f"K4 {name}: the shape is not windowed")
        got = knn_topk_windowed(q, r, k, halo)
        _, err = _knn_agree(torch, name, got, knn_topk_windowed_plain(q, r, k, halo), "K4")
        return got, err

    # the level-0 searches of a strided pyramid over curve-sorted clouds
    # (ops/pyramid.py): self k=16, into every 4th point k=1, and level 1's self
    pts = sorted_cloud(2, N_POINTS, 3)
    sub = pts[:, ::4][:, :N_POINTS // 4].contiguous()
    cases = []
    for b in (1, 2):
        cases += [(f"level 0 self B={b}", pts[:b].contiguous(), pts[:b].contiguous(), 16),
                  (f"level 0 upsample B={b}", pts[:b].contiguous(), sub[:b].contiguous(), 1),
                  (f"level 1 self B={b}", sub[:b].contiguous(), sub[:b].contiguous(), 16)]
    other = [("ragged N=3000 k=8", sorted_cloud(1, 3000, 3), None, 8),
             ("D=8 N=3000 k=32 B=2", sorted_cloud(2, 3000, 8), None, 32),
             ("ragged N=2500 into 1900", sorted_cloud(1, 2500, 3), sorted_cloud(1, 1900, 3), 4)]
    for name, q, r, k in other:
        r = q if r is None else r
        (idx, _), _ = check(name, q, r, k)
        _in_window(torch, name, idx, q.shape[1], r.shape[1], halo)
    log("K4 agrees with its plain version (indices equal, distances bit-equal) at "
        "ragged N, D in {3, 8}, k in {4, 8, 32}, and every index lies in its window")
    # exact ties: a curve-sorted lattice at k 1, 16, 32, D 3 and 8, B = 2
    for d in (3, 8):
        lat = _lattice(torch, gen, "cpu", 2, N_POINTS, d).numpy()
        lat = torch.from_numpy(sort_clouds(lat)).contiguous().to(dev)
        for k in (1, 16, 32):
            (idx, _), _ = check(f"lattice D={d} k={k} B=2", lat, lat, k)
            _in_window(torch, f"lattice D={d} k={k}", idx, N_POINTS, N_POINTS, halo)
    log("K4 agrees with its plain version on a curve-sorted lattice (exact ties at "
        "the k-th distance), k in {1, 16, 32}, D in {3, 8}, B=2")

    shapes, err_max = [], 0.0
    for name, q, r, k in cases:
        (idx, _), err = check(name, q, r, k)
        err_max = max(err_max, err)
        n, m = q.shape[1], r.shape[1]
        rows, starts = _in_window(torch, name, idx, n, m, halo)
        event_ms = cuda_ms(lambda: knn_topk_windowed(q, r, k, halo), 10)
        plain_ms = cuda_ms(lambda: knn_topk_windowed_plain(q, r, k, halo), 3)
        # the same windows gathered, one batched cdist and one topk
        b, _, d = q.shape
        t = len(starts)
        col = torch.tensor(starts, device=dev)[:, None] + torch.arange(rows, device=dev)
        pad = torch.zeros((t, rows), device=dev).masked_fill_(col >= m, float("inf"))
        qt = torch.nn.functional.pad(q, (0, 0, 0, t * TQ - n)).reshape(b * t, TQ, d)

        def library():
            win = r[:, col.clamp(max=m - 1)].reshape(b * t, rows, d)
            dm = torch.cdist(qt, win) + pad.repeat(b, 1)[:, None, :]
            torch.topk(dm, k, dim=-1, largest=False)
        ms, library_ms, runs = _graph_in_turns(
            lambda: knn_topk_windowed(q, r, k, halo), library, 50, 10)
        pairs = b * sum(min(TQ, n - i * TQ) * (min(m, s + rows) - s)
                        for i, s in enumerate(starts))
        rec = _timed_shape(name, q, r, k, ms, plain_ms, library_ms, pairs)
        rec.update(runs, event_ms=event_ms, window_rows=rows)
        shapes.append(rec)
        log(f"K4 {name}: {rec['shape']}, window {rows} rows: indices equal, max dist "
            f"diff 0, all in window; kernel {ms:.4f} ms {runs['kernel_runs']} (graph; "
            f"events {event_ms:.4f} ms), plain {plain_ms:.4f} ms, gather+cdist+topk "
            f"{library_ms:.4f} ms {runs['library_runs']} (graph), bound "
            f"{rec['bound_ms']:.3g} ms ({rec['bound_by']})")
    main = shapes[0]
    return {"name": "knn_topk_windowed (K4)", "route": "cuda",
            "source": "deepsir_tpu_torch/csrc/knn_windowed.cu",
            "replaces": "deepsir_tpu/ops/pallas_knn.py:238",
            "core": "deepsir_tpu_torch/csrc/knn_select.cuh",
            "shape": main["shape"], "max_abs_err": err_max, "index_mismatches": 0,
            "ms": main["ms"], "kernel_ms": main["ms"], "event_ms": main["event_ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "timing": main["timing"], "shapes": shapes}


def _pyramid_searches(cfg, n: int):
    """(full, windowed) KNN searches of one cloud's pyramid over n points."""
    from deepsir_tpu_torch.ops.window import windowed
    halo = cfg.knn_window_halo if cfg.pyramid_order == "morton" else 0
    full = win = 0
    for r in cfg.sub_sampling_ratio:
        for nv in (n, n // r):                        # self-search, upsample
            if halo and windowed(n, nv, halo):
                win += 1
            else:
                full += 1
        n //= r
    return full, win


def expected_launches(cfg, refine_stride: int = 1):
    """Launches per batch of each kernel, from the port's window geometry:
    both clouds' pyramids, and with refine_stride > 1 the source subset's."""
    from deepsir_tpu_torch.config import inlier_extras
    full, win = (2 * c for c in _pyramid_searches(cfg, cfg.num_points))
    if refine_stride > 1 and cfg.num_reg_iter > 1:
        sub = _pyramid_searches(cfg, len(range(0, cfg.num_points, refine_stride)))
        full, win = full + sub[0], win + sub[1]
    both = cfg.mutual_check or "recip" in inlier_extras(cfg)
    return dict(zip(COUNTED, (full, win, 0 if both else cfg.num_reg_iter,
                              cfg.num_reg_iter if both else 0)))


def expected_bf16_launches(cfg, refine_stride: int = 1):
    """Launches per batch of K2 and K3 in their bf16 form: all of them under
    bf16 compute, none otherwise."""
    launches = expected_launches(cfg, refine_stride)
    lp = cfg.compute_dtype == "bfloat16"
    return {k: launches[k] if lp else 0 for k in LP_COUNTED}


def path_config(name: str):
    """A path's ModelConfig at full width (N_POINTS points)."""
    from deepsir_tpu_torch.config import ModelConfig, from_run_config, replace
    options = PATHS[name][0]
    if isinstance(options, Path):                     # the params do not depend on N
        return replace(from_run_config(options), num_points=N_POINTS)
    return ModelConfig(**dict(dict(feat_len=FEAT_LEN, num_points=N_POINTS,
                                   num_reg_iter=N_ITERS), **options))


def drive_path(torch, dev, name: str, batch: int, model_cache: dict):
    """device_batch -> forward_align at full width along one path; returns
    the launch counts of that one driven batch (all, and the match kernels'
    bf16-form ones) and the path's record."""
    from deepsir_tpu_torch.models.network import ForwardOptions
    from deepsir_tpu_torch.training import device_batch
    from deepsir_tpu_torch.utils.params import init_params, load_network

    _, stride, per_batch, bf16_per_batch = PATHS[name]
    cfg = path_config(name)
    want, want_lp = expected_launches(cfg, stride), expected_bf16_launches(cfg, stride)
    if tuple(want.values()) != per_batch or tuple(want_lp.values()) != bf16_per_batch:
        raise AssertionError(f"{name}: window geometry gives {want}, bf16 form {want_lp}, "
                             f"expected {per_batch}, {bf16_per_batch}")
    if name not in model_cache:
        model_cache[name] = load_network(cfg, init_params(cfg, seed=0), device=dev)
    model = model_cache[name]
    opts = ForwardOptions(num_iter=cfg.num_reg_iter, clip_weight=True, refine_stride=stride)
    morton = cfg.pyramid_order == "morton"
    rng = np.random.default_rng(0)

    def run(arrays):
        return model.forward_align(device_batch(cfg, arrays, device=dev), opts)

    arrays = make_arrays(rng, batch, morton, cfg.feat_len, cfg.use_ppf)
    counted = kernels()
    reset_counts(counted)
    out = run(arrays)
    torch.cuda.synchronize()
    launches, launches_lp = read_counts(counted)
    if launches != want:
        raise AssertionError(f"{name} B={batch}: launches {launches}, expected {want}")
    if launches_lp != want_lp:                        # bf16 compute: all in bf16 form
        raise AssertionError(f"{name} B={batch}: bf16-form launches {launches_lp}, "
                             f"expected {want_lp}")
    t = out.transforms
    rows = len(range(0, N_POINTS, stride))
    if tuple(out.pred_idx.shape) != (cfg.num_reg_iter - (stride > 1), batch, rows):
        raise AssertionError(f"{name} B={batch}: pred_idx {tuple(out.pred_idx.shape)}")
    if tuple(t.shape) != (cfg.num_reg_iter, batch, 3, 4) or not bool(torch.isfinite(t).all()):
        raise AssertionError(f"{name} B={batch}: transforms {tuple(t.shape)} not finite")
    rot = t[-1, :, :, :3]
    orth = float((rot @ rot.transpose(-1, -2) - torch.eye(3, device=dev)).abs().max())
    if orth > 1e-3:
        raise AssertionError(f"{name} B={batch}: final rotation not orthonormal ({orth})")
    feeds = [make_arrays(rng, batch, morton, cfg.feat_len, cfg.use_ppf)
             for _ in range(TIMED_REPS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for arrays in feeds:
        run(arrays)
    torch.cuda.synchronize()
    per_pair = (time.perf_counter() - t0) / (TIMED_REPS * batch)
    log(f"path {name} B={batch}: {per_pair * 1e3:.3f} ms per pair ({1.0 / per_pair:.3f} "
        f"pairs/s), invalid={out.invalid.tolist()}, launches {launches}, "
        f"rotation orthonormality err {orth:.2e}")
    options = {k: v for k, v in vars(cfg).items() if v != getattr(type(cfg), k)}
    return launches, launches_lp, {"path": name, "batch": batch, "refine_stride": stride,
                                   "ms_per_pair": per_pair * 1e3, "launches": launches,
                                   "launches_bf16": launches_lp, "options": options}


def _pyramid_near_ties(torch, what, got, want, query, cand):
    """Pyramid indices equal the fixture's except on near ties (the JAX
    package ranks by the norm expansion, the port by direct subtraction): at
    most 0.1% of entries differ, each within 1e-5 relative in float64
    distance. got (B, N, K) or (B, N) indices of `cand` (B, M, 3) for the
    rows of `query` (B, N, 3). Returns the number of entries that differ."""
    b, n = got.shape[:2]
    g = got.reshape(b, n, -1)
    w = torch.as_tensor(np.asarray(want, np.int64), device=got.device).reshape(g.shape)
    differ = g != w
    n_bad = int(differ.sum())
    if not n_bad:
        return 0

    def dist(i):
        rows = torch.gather(cand.double(), 1, i.reshape(b, -1, 1).expand(-1, -1, 3))
        return ((rows.reshape(b, n, -1, 3) - query.double()[:, :, None, :]) ** 2).sum(-1)
    d_g, d_w = dist(g), dist(w)
    rel = float(((d_g - d_w).abs() / d_w.clamp_min(1e-12))[differ].max())
    if rel > 1e-5 or n_bad > 1e-3 * got.numel():
        raise AssertionError(f"fixture: {what}: {n_bad} entries differ, worst relative "
                             f"distance gap {rel}")
    return n_bad


def check_fixture(torch, dev, path: Path):
    """The port on the card against the JAX package's stored outputs."""
    from deepsir_tpu_torch.config import from_json
    from deepsir_tpu_torch.models.network import ForwardOptions, Network
    from deepsir_tpu_torch.training import device_batch
    from deepsir_tpu_torch.utils.params import (from_jax_params, load_network,
                                                unflatten_params)
    fx = dict(np.load(path))
    cfg = from_json(str(fx["model_json"]))
    sd = from_jax_params(unflatten_params(fx), Network(cfg))
    model = load_network(cfg, sd, device=dev)
    arrays = {k: fx[k] for k in ("points_src", "points_ref", "transform_gt")}
    counted = kernels()
    reset_counts(counted)
    batch = device_batch(cfg, arrays, device=dev)
    n_ties = 0
    for side, pyr in (("src", batch.pyramid_src), ("ref", batch.pyramid_ref)):
        for lvl, r in enumerate(cfg.sub_sampling_ratio):
            xyz = pyr.xyz[lvl]
            step = r if cfg.pyramid_order == "morton" else 1
            nxt = xyz[:, ::step][:, :xyz.shape[1] // r]
            n_ties += _pyramid_near_ties(torch, f"{side} neigh_idx[{lvl}]", pyr.neigh_idx[lvl],
                                         fx[f"{side}_neigh_idx_{lvl}"], xyz, xyz)
            n_ties += _pyramid_near_ties(torch, f"{side} interp_idx[{lvl}]", pyr.interp_idx[lvl],
                                         fx[f"{side}_interp_idx_{lvl}"], xyz, nxt)
    out = model.forward_align(batch, ForwardOptions(num_iter=cfg.num_reg_iter,
                                                    clip_weight=True))
    torch.cuda.synchronize()
    launches, _ = read_counts(counted)
    if launches != expected_launches(cfg):
        raise AssertionError(f"fixture {path.name}: launches {launches}, "
                             f"expected {expected_launches(cfg)}")
    pred = out.pred_idx.cpu().numpy()
    agree = float((pred[0] == fx["pred_idx"][0]).mean())
    terr = float(np.abs(out.transforms.cpu().numpy() - fx["transforms"]).max())
    if agree < 0.995 or terr > 1e-3:
        raise AssertionError(f"fixture {path.name}: pred_idx agree {agree}, "
                             f"transform err {terr}")
    if not np.array_equal(out.invalid.cpu().numpy(), fx["invalid"]):
        raise AssertionError(f"fixture {path.name}: invalid differs")
    log(f"fixture {path.name}: pyramids equal but for {n_ties} near-tie entries, "
        f"pred_idx iteration 1 agree {agree:.4f}, max transform err {terr:.3g}, "
        f"launches {launches}")


# a pose solve whose weighted covariance has its smallest singular value below
# this share of its largest is ill-conditioned: fp32 rounding alone then
# moves its pose by up to ~1e-3 (tests/test_torch_checkpoint.py)
ILL_CONDITIONED = 0.01


def solve_conditioning(torch, out, xyz0, xyz_ref, cfg, mask=None):
    """(iters, B) smallest over largest singular value of each iteration's
    weighted covariance, in float64, from the forward's own matches, inlier
    logits and poses (clip_weight on, no mutual gate)."""
    from deepsir_tpu_torch.math import se3
    if cfg.mutual_check:
        raise NotImplementedError("solve_conditioning with the mutual gate")
    x0, ref = xyz0.double(), xyz_ref.double()
    ratios = []
    for t in range(out.transforms.shape[0]):
        pose = out.transforms[t - 1].double() if t and not cfg.absolute_pose_solve else None
        src = x0 if pose is None else se3.transform(pose, x0)
        w = torch.sigmoid(out.inlier_logits[t].double())
        if cfg.clip_weight_thresh > 0:
            w = torch.where(w < cfg.clip_weight_thresh, torch.zeros_like(w), w)
        if mask is not None:
            w = w * mask.double()
        w = (w / w.sum(-1, keepdim=True))[..., None]
        tgt = torch.gather(ref, 1, out.pred_idx[t][..., None].expand(-1, -1, 3))
        src_c = src - (src * w).sum(1, keepdim=True)
        tgt_c = tgt - (tgt * w).sum(1, keepdim=True)
        s = torch.linalg.svdvals((src_c * w).transpose(1, 2) @ tgt_c)
        ratios.append(s[:, 2] / s[:, 0])
    return torch.stack(ratios)


def held_iterations(pred_idx, want_idx, conditioning):
    """Per pair, how many leading iterations are held to the reference: those
    before the first whose matches differ from `want_idx` (a flipped match
    changes the solve's input) or whose solve is ill-conditioned. Arrays
    (iters, B, N) and (iters, B) -> (B,) numpy ints."""
    bad = (np.asarray(pred_idx) != np.asarray(want_idx)).any(-1)
    bad |= np.asarray(conditioning) < ILL_CONDITIONED
    return np.where(bad.any(0), bad.argmax(0), bad.shape[0])


def checkpoint_arrays(fx, n: int):
    """The device_batch arrays of the checkpoint fixture's pairs at n points:
    each cloud's raw rows tiled to n, as the data layer pads it, and its
    validity mask."""
    arrays = {"transform_gt": fx[f"n{n}_transform_gt"]}
    for side in ("src", "ref"):
        rows, raw = fx[f"n{n}_{side}_rows"], fx[f"n{n}_{side}_raw"]
        arrays[f"points_{side}"] = np.stack([np.resize(r[:m], (n, r.shape[-1]))
                                             for r, m in zip(rows, raw)])
        arrays[f"mask_{side}"] = (np.arange(n)[None] < raw[:, None]).astype(np.float32)
    return arrays


@contextmanager
def plain_kernels():
    """Every kernel wrapper on the forward's path replaced by its plain
    PyTorch version, which runs on the card's tensors too."""
    from unittest import mock
    from deepsir_tpu_torch.ops import cuda_knn, cuda_match, distance, knn
    with mock.patch.object(knn, "knn_topk", cuda_knn.knn_topk_plain), \
            mock.patch.object(knn, "knn_topk_windowed", cuda_knn.knn_topk_windowed_plain), \
            mock.patch.object(distance, "match_argmin", cuda_match.match_argmin_plain), \
            mock.patch.object(distance, "match_argmin_bidirectional",
                              cuda_match.match_argmin_bidirectional_plain):
        yield


def _exact_pyramid_agrees(torch, what, pyr, ratios):
    """The pyramid's indices against a float64 KNN (ties to the lower index)
    of its own levels; returns the entries that differ (0 to pass)."""
    def exact(q, r, k):
        d = ((q.double()[:, :, None] - r.double()[:, None]) ** 2).sum(-1)
        return torch.sort(d, dim=-1, stable=True)[1][..., :k]
    n_bad = 0
    for lvl, r in enumerate(ratios):
        xyz = pyr.xyz[lvl]
        k = pyr.neigh_idx[lvl].shape[-1]
        n_bad += int((pyr.neigh_idx[lvl] != exact(xyz, xyz, k)).sum())
        n_bad += int((pyr.interp_idx[lvl] != exact(xyz, xyz[:, :xyz.shape[1] // r], 1)[..., 0]).sum())
    if n_bad:
        raise AssertionError(f"checkpoint: {what} pyramid differs from the exact KNN "
                             f"in {n_bad} entries")
    return n_bad


def _gate(what, out, want_idx, want_transforms, want_invalid, conditioning, tol=1e-3):
    """PERF.md section 2's gates: iteration-1 correspondences >= 99.5% equal,
    `invalid` equal, transforms within tol up to each pair's first iteration
    whose matches differ or whose solve is ill-conditioned. Returns the
    record of the comparison."""
    pred = out.pred_idx.cpu().numpy()
    agree = float((pred[0] == want_idx[0]).mean())
    if agree < 0.995:
        raise AssertionError(f"checkpoint {what}: iteration-1 matches agree {agree}")
    if not np.array_equal(out.invalid.cpu().numpy(), want_invalid):
        raise AssertionError(f"checkpoint {what}: invalid differs")
    held = held_iterations(pred, want_idx, conditioning.cpu().numpy())
    err = np.abs(out.transforms.cpu().numpy() - want_transforms).max(axis=(2, 3))
    held_err = max((float(err[:n, b].max()) for b, n in enumerate(held) if n), default=0.0)
    if held_err > tol:
        raise AssertionError(f"checkpoint {what}: transforms differ by {held_err} within the "
                             f"held iterations {held.tolist()}")
    return {"iteration1_agree": agree, "held_iterations": held.tolist(),
            "held_transform_err": held_err, "transform_err": float(err.max()),
            "rows_differ": (pred != want_idx).sum(-1).tolist()}


def check_checkpoint(torch, dev):
    """Trained weights on the card: the staged align checkpoint read with the
    port's own decoder, its run config with `from_run_config`; the pairs of
    the checkpoint fixture at 1024 points against JAX's stored outputs, and
    at 18000 points against the same forward with plain versions for every
    kernel. Returns (launches of the kernel runs, the phase's record)."""
    import hashlib
    from deepsir_tpu_torch.config import from_run_config, replace
    from deepsir_tpu_torch.math import se3
    from deepsir_tpu_torch.models.network import ForwardOptions, Network
    from deepsir_tpu_torch.training import device_batch
    from deepsir_tpu_torch.utils.checkpoint import read_params, resolve
    from deepsir_tpu_torch.utils.params import from_jax_params, load_network

    path = resolve(CKPT_RUN / "ckpt")
    data = path.read_bytes()
    t0 = time.perf_counter()
    params = read_params(path)
    read_s = time.perf_counter() - t0
    leaves = []

    def walk(tree):
        for v in tree.values():
            walk(v) if isinstance(v, dict) else leaves.append(v)
    walk(params)
    n_params = sum(int(a.size) for a in leaves)
    if (len(leaves), n_params) != (340, 2_746_668):
        raise AssertionError(f"checkpoint: {len(leaves)} leaves, {n_params} params")
    run = json.loads((CKPT_RUN / "config.json").read_text())
    cfg = from_run_config(run)
    record = {"file": str(path.relative_to(ROOT)), "bytes": len(data),
              "sha256": hashlib.sha256(data).hexdigest(), "leaves": len(leaves),
              "params": n_params, "decode_s": read_s}
    log(f"checkpoint {record['file']}: {len(data)} bytes, sha256 {record['sha256']}, "
        f"{len(leaves)} leaves, {n_params} params, decoded in {read_s:.3f} s")
    fx = dict(np.load(CKPT_FIXTURE))
    opts = ForwardOptions(num_iter=cfg.num_reg_iter, clip_weight=True)
    thresholds = run["eval"]["rte_thresh"], run["eval"]["rre_thresh"]
    counted = kernels()
    total = dict.fromkeys(COUNTED, 0)
    for n in (1024, 18000):
        cfg_n = replace(cfg, num_points=n)
        model = load_network(cfg_n, from_jax_params(params, Network(cfg_n)), device=dev)
        arrays = checkpoint_arrays(fx, n)
        gt = torch.from_numpy(arrays["transform_gt"]).to(dev)
        reset_counts(counted)
        batch = device_batch(cfg_n, arrays, device=dev)
        out = model.forward_align(batch, opts)
        torch.cuda.synchronize()
        launches, _ = read_counts(counted)
        if launches != expected_launches(cfg_n):
            raise AssertionError(f"checkpoint {n}: launches {launches}, expected "
                                 f"{expected_launches(cfg_n)}")
        for key, value in launches.items():
            total[key] += value
        cond = solve_conditioning(torch, out, out.pt_src, out.pt_ref, cfg_n, batch.mask_src)
        rre, rte = (e.cpu().numpy() for e in se3.pose_error(gt, out.transforms[-1]))
        succ = (rte < thresholds[0]) & (rre < thresholds[1])
        if n == 1024:
            # JAX ran over exact pyramids: so must the card
            for side in ("src", "ref"):
                _exact_pyramid_agrees(torch, side, getattr(batch, f"pyramid_{side}"),
                                      cfg_n.sub_sampling_ratio)
            rec = _gate("1024 points vs JAX", out, fx["ckpt0_pred_idx"].astype(np.int64),
                        fx["ckpt0_transforms"], fx["ckpt0_invalid"], cond)
            want_succ, vs = fx["ckpt0_succ"], "JAX"
        else:
            reset_counts(counted)
            with plain_kernels():
                pbatch = device_batch(cfg_n, arrays, device=dev)
                plain = model.forward_align(pbatch, opts)
            torch.cuda.synchronize()
            if any(read_counts(counted)[0].values()):
                raise AssertionError("checkpoint: the plain run launched a kernel")
            for side in ("src", "ref"):
                for field in ("neigh_idx", "interp_idx"):
                    for a, b in zip(getattr(getattr(batch, f"pyramid_{side}"), field),
                                    getattr(getattr(pbatch, f"pyramid_{side}"), field)):
                        if not torch.equal(a, b):
                            raise AssertionError(f"checkpoint 18000: {side} {field} differs "
                                                 f"from the plain KNN's")
            rec = _gate("18000 points vs plain", out, plain.pred_idx.cpu().numpy(),
                        plain.transforms.cpu().numpy(), plain.invalid.cpu().numpy(), cond)
            prre, prte = (e.cpu().numpy() for e in se3.pose_error(gt, plain.transforms[-1]))
            want_succ, vs = (prte < thresholds[0]) & (prre < thresholds[1]), "plain"
        if not np.array_equal(succ, want_succ):
            raise AssertionError(f"checkpoint {n}: success flags {succ.tolist()}, "
                                 f"{vs} {want_succ.tolist()}")
        rec.update(points=n, pairs=int(gt.shape[0]), against=vs, launches=launches,
                   rre_deg=rre.tolist(), rte=rte.tolist(), success=succ.tolist(),
                   min_conditioning=float(cond.min()))
        record[f"n{n}"] = rec
        log(f"checkpoint {n} points, {rec['pairs']} pairs against {vs}: iteration-1 matches "
            f"agree {rec['iteration1_agree']:.4f}, held iterations {rec['held_iterations']}, "
            f"held transform err {rec['held_transform_err']:.3g} (all {rec['transform_err']:.3g}), "
            f"success {succ.tolist()} equal, RRE {np.round(rre, 3).tolist()} deg, "
            f"launches {launches}")
    return total, record


# ---------------------------------------------------------------- training

TRAIN_FIXTURE = ROOT / "tests" / "data" / "torch_parity_train.npz"
TRAIN_STEPS = 4                   # full-width steps per case: one warm-up, three timed
# full-width training cases: ModelConfig options, launches per step of K1, K4, K2, K3
TRAIN_CASES = {"default": ({}, (16, 0, 2, 0)), "F": (FLAGSHIP, (16, 0, 0, 2))}
TRAIN_THRES_RADIUS = 0.9          # deepsir_tpu/config.py:DataConfig: voxel 0.3 x 3
# a stored leaf above this many entries is summarised (the fixture's size)
SUMMARY_ENTRIES = 4096
N_PROJECTIONS, N_TOP = 16, 256


def _projections(n: int) -> np.ndarray:
    """N_PROJECTIONS seeded unit Gaussian directions in R^n."""
    g = np.random.default_rng(n).standard_normal((N_PROJECTIONS, n))
    return g / np.linalg.norm(g, axis=1, keepdims=True)


def summarize_leaf(arr, max_full: int = SUMMARY_ENTRIES) -> dict:
    """A leaf as the train fixtures store it: whole up to `max_full`
    entries; else its L2 norm, its projections on N_PROJECTIONS seeded unit
    directions and its N_TOP largest-magnitude entries with their flat
    indices."""
    arr = np.asarray(arr, np.float32)
    if arr.size <= max_full:
        return {"full": arr}
    flat = arr.astype(np.float64).ravel()
    top = np.argsort(-np.abs(flat), kind="stable")[:N_TOP]
    return {"norm": np.linalg.norm(flat), "proj": _projections(flat.size) @ flat,
            "top_idx": top.astype(np.int32), "top_val": flat[top].astype(np.float32)}


def leaf_error(got, stored: dict) -> float:
    """`got` against a stored leaf, relative to the leaf's scale: the largest
    entry difference over the leaf's largest magnitude (whole leaves, and
    the stored top entries of summarised ones), and the norm's and the
    projections' differences over the norm."""
    got = np.asarray(got, np.float64)
    if "full" in stored:
        want = stored["full"].astype(np.float64)
        return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))
    flat = got.ravel()
    top_val = stored["top_val"].astype(np.float64)
    norm = float(stored["norm"])
    return max(float(np.abs(flat[stored["top_idx"]] - top_val).max() / np.abs(top_val).max()),
               abs(np.linalg.norm(flat) - norm) / norm,
               float(np.abs(_projections(flat.size) @ flat - stored["proj"]).max() / norm))


def stored_leaves(fx, prefix: str) -> dict:
    """{flax path: {field: array}} of the fixture's entries under `prefix`."""
    leaves: dict = {}
    for key, value in fx.items():
        if key.startswith(prefix + "/"):
            path, field = key[len(prefix) + 1:].rsplit("/", 1)
            leaves.setdefault(path, {})[field] = value
    return leaves


def flax_leaves(tensors) -> dict:
    """{port parameter name: tensor} -> {flax path: numpy array in flax's
    layout}."""
    from deepsir_tpu_torch.utils.params import flax_path
    out = {}
    for name, t in tensors.items():
        path, transpose = flax_path(name)
        arr = t.detach().cpu().numpy()
        out["/".join(path)] = arr.T if transpose else arr
    return out


def _held(pred_idx, want_idx) -> int:
    """Leading iterations whose matches all equal the reference's."""
    same = (np.asarray(pred_idx) == np.asarray(want_idx)).reshape(len(want_idx), -1).all(-1)
    return int(np.argmin(same)) if not same.all() else len(same)


def parity_training(dev):
    """The train fixture, its pairs, and the staged align checkpoint resumed
    on `dev` with its Adam state for training at the fixture's size with
    dropout off: (fixture, arrays, RunConfig, model, optimizer, count)."""
    from deepsir_tpu_torch.config import read_run_config, replace
    from deepsir_tpu_torch.models.network import Network
    from deepsir_tpu_torch.training import make_optimizer
    from deepsir_tpu_torch.utils.checkpoint import load_train_state
    fx = dict(np.load(TRAIN_FIXTURE))
    cfgs = read_run_config(CKPT_RUN)
    cfgs = cfgs._replace(model=replace(cfgs.model, num_points=int(fx["points_src"].shape[1]),
                                       dropout_rate=0.0))
    model = Network(cfgs.model).to(dev)
    opt = make_optimizer(model)
    count = load_train_state(CKPT_RUN / "ckpt", model, opt)
    arrays = {k: fx[k] for k in ("points_src", "points_ref", "transform_gt", "mask_src",
                                 "mask_ref")}
    return fx, arrays, cfgs, model, opt, count


def seeded_training(dev, name: str):
    """A full-width training case of TRAIN_CASES on `dev`: (RunConfig, model
    with seeded weights, its optimizer). The loss reads the DataConfig
    default radius; the schedule, TrainConfig's defaults."""
    from deepsir_tpu_torch.config import LossConfig, ModelConfig, RunConfig, TrainConfig
    from deepsir_tpu_torch.models.network import Network
    from deepsir_tpu_torch.training import make_optimizer
    from deepsir_tpu_torch.utils.params import init_params
    cfg = ModelConfig(feat_len=FEAT_LEN, num_points=N_POINTS, **TRAIN_CASES[name][0])
    cfgs = RunConfig(cfg, LossConfig(thres_radius=TRAIN_THRES_RADIUS), TrainConfig())
    model = Network(cfg)
    model.load_state_dict(init_params(cfg, seed=0))
    model.to(dev)
    return cfgs, model, make_optimizer(model)


def train_parity(torch, dev, terms_rtol=1e-4, leaf_rtol=1e-3):
    """The staged align checkpoint resumed with its Adam state (count 1760)
    and run config (dropout_rate 0), two training steps on the fixture's
    1024-point pairs against the JAX package's stored steps: loss terms
    within `terms_rtol` relative, the inlier grads of step 1 and the inlier
    params after step 2 within `leaf_rtol` of each leaf's scale
    (`leaf_error`), the lr and `skipped` equal; each held only while every
    iteration's matches equal JAX's. Returns (launches, record)."""
    from deepsir_tpu_torch.training import device_batch, train_step
    from deepsir_tpu_torch.utils.params import trainable_parameters
    fx, arrays, cfgs, model, opt, count = parity_training(dev)
    if count != int(fx["count"]):
        raise AssertionError(f"train parity: resumed count {count}, JAX {int(fx['count'])}")
    # JAX ran over exact pyramids: so must the port
    batch = device_batch(cfgs.model, arrays, device=dev)
    for side in ("src", "ref"):
        _exact_pyramid_agrees(torch, f"train {side}", getattr(batch, f"pyramid_{side}"),
                              cfgs.model.sub_sampling_ratio)
    counted = kernels()
    reset_counts(counted)
    gen = torch.Generator(device=dev).manual_seed(0)
    steps, all_held = [], True
    for s in range(int(fx["steps"])):
        out = train_step(model, opt, cfgs, arrays, gen, int(fx["steps_per_epoch"]))
        want_idx = fx[f"step{s}_pred_idx"].astype(np.int64)
        held = _held(out["pred_idx"].cpu().numpy(), want_idx)
        if not all_held:                  # an earlier step left the reference
            held = 0
        all_held &= held == len(want_idx)
        rec = {"loss": float(out["loss"]), "jax_loss": float(fx[f"step{s}_loss"]),
               "lr": out["lr"], "jax_lr": float(fx[f"step{s}_lr"]), "skipped": out["skipped"],
               "held_iterations": held, "rows_differ": int((out["pred_idx"].cpu().numpy()
                                                           != want_idx).sum())}
        if s == 0 and held == 0:
            raise AssertionError("train parity: step 1 iteration-1 matches differ from JAX")
        if out["skipped"] != bool(fx[f"step{s}_skipped"]) or abs(rec["lr"] - rec["jax_lr"]) > 1e-9:
            raise AssertionError(f"train parity step {s + 1}: {rec}")
        errs = {}
        for key, value in out["losses"].items():
            if int(key[key.rfind("_") + 1:]) >= held:
                continue
            want = float(fx[f"step{s}_term/{key}"])
            errs[key] = abs(float(value) - want) / max(abs(want), 1e-12)
        if all_held:
            errs["total"] = abs(rec["loss"] - rec["jax_loss"]) / abs(rec["jax_loss"])
        rec["term_rel_err"] = errs
        if any(e > terms_rtol for e in errs.values()):
            raise AssertionError(f"train parity step {s + 1}: loss terms {errs}")
        if s == 0 and all_held:
            grads = flax_leaves(out["grads"])
            want = stored_leaves(fx, "grad0")
            if set(grads) != set(want):
                raise AssertionError("train parity: grad leaves differ from the fixture's")
            rec["grad_rel_err"] = max(leaf_error(grads[k], want[k]) for k in want)
            if rec["grad_rel_err"] > leaf_rtol:
                raise AssertionError(f"train parity: grads differ by {rec['grad_rel_err']}")
        steps.append(rec)
    record = {"points": int(fx["points_src"].shape[1]), "pairs": int(fx["points_src"].shape[0]),
              "resumed_count": count, "steps": steps, "all_held": bool(all_held)}
    if all_held:
        params = flax_leaves(dict(trainable_parameters(model)))
        want = stored_leaves(fx, f"param{int(fx['steps'])}")
        record["param_rel_err"] = max(leaf_error(params[k], want[k]) for k in want)
        if record["param_rel_err"] > leaf_rtol:
            raise AssertionError(f"train parity: params differ by {record['param_rel_err']}")
    launches, _ = read_counts(counted)
    record["launches"] = launches
    log(f"train parity {record['points']} points, {record['pairs']} pairs, resumed at count "
        f"{count}: " + "; ".join(f"step {i + 1} loss {r['loss']:.6f} (JAX {r['jax_loss']:.6f}), "
                                 f"held {r['held_iterations']} iterations"
                                 for i, r in enumerate(steps))
        + f"; grads {steps[0].get('grad_rel_err')}, params {record.get('param_rel_err')} "
        f"relative; launches {launches}")
    return launches, record


def train_arrays(rng, batch: int, feat_len: int = FEAT_LEN):
    """make_arrays' source clouds, each with a reference that is a known
    rigid motion of it (rotation up to 30 degrees about a random axis,
    translation up to 1) plus Gaussian noise of 0.02, rows reshuffled."""
    arrays = make_arrays(rng, batch, feat_len=feat_len)
    src = arrays["points_src"]
    ref = np.empty_like(src)
    gt = np.empty((batch, 3, 4), np.float32)
    for b in range(batch):
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
        ang = np.deg2rad(rng.uniform(0.0, 30.0))
        rot = np.eye(3) + np.sin(ang) * k + (1 - np.cos(ang)) * k @ k
        t = rng.uniform(-1.0, 1.0, size=3) / np.sqrt(3.0)
        moved = src[b].copy()
        moved[:, :3] = src[b, :, :3] @ rot.T + t + rng.normal(scale=0.02, size=(len(moved), 3))
        ref[b] = moved[rng.permutation(len(moved))]
        gt[b] = np.concatenate([rot, t[:, None]], axis=1)
    return {"points_src": src, "points_ref": ref, "transform_gt": gt}


def _grads_agree(got, want, tol):
    """Largest per-leaf max-abs difference over the leaf's max-abs."""
    err = 0.0
    for name, g in got.items():
        w = want[name]
        err = max(err, float((g - w).abs().max() / w.abs().max().clamp_min(1e-30)))
    if err > tol:
        raise AssertionError(f"train: kernel grads differ from the plain version's by {err}")
    return err


def _iteration1_descriptors(torch, model, batch):
    """The source and reference descriptors of the first registration
    iteration (the source at its input pose), as the forward computes them."""
    with torch.no_grad():
        feat_src, logits_src, feat_ref, logits_ref = model.backbone_pair(batch)
        score_src, score_ref = model.score_pair(batch, feat_src, feat_ref, logits_src,
                                                logits_ref)
        fr = model.aggregate_side(batch.points_ref[..., :3], feat_ref, score_ref)
        fs = model.aggregate_moving(batch.points_src[..., :3], score_src,
                                    model.mlp_feat(feat_src))
    return fs, fr


def _search_near_ties(torch, qry, cand, idx, pidx, low_precision=False):
    """Rows where the kernel's match `idx` into `cand` differs from the plain
    version's `pidx` must be near ties of the search: at most 0.1% of
    rows, and the float64 distances of the two candidates within 1e-5 of
    |q|^2 + |c|^2, the scale of the terms both versions sum in fp32 (a
    descriptor's nearest neighbour may be far closer than that scale, so a
    gap relative to the distance itself measures fp32 rounding wrongly
    there). Under `low_precision` the distance is the bf16 form's own,
    |q|^2 + |c|^2 - 2 bf16(q).bf16(c). Returns the rows, the largest gap and
    the largest gap over the distance."""
    differ = idx != pidx
    rows = int(differ.sum())
    if not rows:
        return {"rows": 0, "max_gap": 0.0, "max_gap_over_distance": 0.0}
    q = qry.double()
    qb = qry.to(torch.bfloat16).double() if low_precision else q

    def dist(i):
        c = torch.gather(cand.double(), 1, i[..., None].expand(q.shape))
        terms = (q * q).sum(-1) + (c * c).sum(-1)
        if not low_precision:
            return ((q - c) ** 2).sum(-1), terms
        cb = torch.gather(cand.to(torch.bfloat16).double(), 1, i[..., None].expand(q.shape))
        return terms - 2.0 * (qb * cb).sum(-1), terms
    (d_k, s_k), (d_p, _) = dist(idx), dist(pidx)
    gap = (d_k - d_p).abs()[differ]
    scale = s_k[differ]
    rec = {"rows": rows, "max_gap": float(gap.max()), "max_gap_over_scale": float((gap / scale).max()),
           "max_gap_over_distance": float((gap / d_p[differ].clamp_min(1e-12)).max())}
    if rows > 1e-3 * idx.numel() or rec["max_gap_over_scale"] > 1e-5:
        raise AssertionError(f"iteration 1: matches differ beyond near ties: {rec}")
    return rec


def _runs_against_plain(torch, model, cfgs, arrays, dev, seed, forward=False):
    """One training forward + backward (`compute_loss`) with the kernels and
    again with every kernel swapped for its plain version, from the same
    params and dropout seed; with `forward`, first the inference
    `forward_pair` under no_grad. Returns a dict per run (kernels, plain):
    "batch", "out", "loss", "aux" and "grads" of the trained leaves."""
    from deepsir_tpu_torch.training import compute_loss, device_batch
    from deepsir_tpu_torch.utils.params import trainable_parameters
    runs = []
    for plain in (False, True):
        gen = torch.Generator(device=dev).manual_seed(seed)
        with plain_kernels() if plain else nullcontext():
            batch = device_batch(cfgs.model, arrays, device=dev)
            out = None
            if forward:
                with torch.no_grad():
                    out = model.forward_pair(batch)
            model.zero_grad(set_to_none=True)
            loss, aux = compute_loss(model, cfgs.loss, batch, gen)
            loss.backward()
        runs.append({"batch": batch, "out": out, "loss": loss.item(), "aux": aux,
                     "grads": {n: p.grad.clone() for n, p in trainable_parameters(model)}})
    model.zero_grad(set_to_none=True)
    return runs


def _step_against_plain(torch, model, cfgs, arrays, dev, seed, require_held):
    """`_runs_against_plain` on the align pipeline. The pyramids must be
    equal, and the first iteration's matches equal but for near ties (the
    search's rule on the step's own descriptors, in the bf16 form's distance
    under bf16 compute); the loss terms of the
    iterations whose matches all agree within 1e-4 relative, and with every
    iteration held the total within 1e-4 and the inlier grads within 1e-3
    of each leaf's scale. `require_held`: fail unless every iteration holds.
    Returns the record."""
    runs = [(r["batch"], r["loss"], {k: v.item() for k, v in r["aux"]["losses"].items()},
             r["aux"]["pred_idx"], r["grads"])
            for r in _runs_against_plain(torch, model, cfgs, arrays, dev, seed)]
    (k_batch, k_loss, k_terms, k_idx, k_grads), (p_batch, p_loss, p_terms, p_idx, p_grads) = runs
    for side in ("src", "ref"):
        for a, b in zip(getattr(k_batch, f"pyramid_{side}").neigh_idx,
                        getattr(p_batch, f"pyramid_{side}").neigh_idx):
            if not torch.equal(a, b):
                raise AssertionError(f"train: the {side} pyramid differs from the plain KNN's")
    gap = _search_near_ties(torch, *_iteration1_descriptors(torch, model, k_batch), k_idx[0],
                            p_idx[0], model.low_precision)
    k_idx, p_idx = k_idx.cpu().numpy(), p_idx.cpu().numpy()
    held = _held(k_idx, p_idx)
    rec = {"loss": k_loss, "plain_loss": p_loss, "held_iterations": held,
           "rows_differ": (k_idx != p_idx).sum(-1).tolist(), "iteration1_gap": gap}
    errs = {k: abs(v - p_terms[k]) / max(abs(p_terms[k]), 1e-12) for k, v in k_terms.items()
            if int(k[k.rfind("_") + 1:]) < held}
    if held == len(p_idx):
        errs["total"] = abs(k_loss - p_loss) / abs(p_loss)
        rec["grad_rel_err"] = _grads_agree(k_grads, p_grads, 1e-3)
    elif require_held:
        raise AssertionError(f"train: matches differ from the plain version's: "
                             f"{rec['rows_differ']}")
    rec["term_rel_err"] = errs
    if any(e > 1e-4 for e in errs.values()):
        raise AssertionError(f"train: kernel loss terms differ from the plain version's: {errs}")
    return rec


def train_trained_against_plain(torch, dev):
    """The staged align checkpoint (its run config, dropout 0.5 from a seeded
    generator) at full width on the checkpoint fixture's two 18000-point
    pairs: one training step with the kernels against the plain versions,
    every iteration held (the checkpoint phase holds its first two
    iterations there)."""
    from deepsir_tpu_torch.config import read_run_config, replace
    from deepsir_tpu_torch.models.network import Network
    from deepsir_tpu_torch.utils.params import from_jax_params
    from deepsir_tpu_torch.utils.checkpoint import read_params
    cfgs = read_run_config(CKPT_RUN)
    cfgs = cfgs._replace(model=replace(cfgs.model, num_points=N_POINTS))
    model = Network(cfgs.model)
    model.load_state_dict(from_jax_params(read_params(CKPT_RUN / "ckpt"), model))
    model.to(dev)
    arrays = checkpoint_arrays(dict(np.load(CKPT_FIXTURE)), N_POINTS)
    rec = _step_against_plain(torch, model, cfgs, arrays, dev, seed=2, require_held=True)
    log(f"train step of the staged checkpoint at {N_POINTS} points, "
        f"{len(arrays['points_src'])} pairs, against plain: {rec}")
    return rec


def timed_steps(torch, dev, what, model, opt, cfgs, feeds, gen, steps_per_epoch, per_step):
    """One `train_step` on each of `feeds`, timed on the host clock around a
    synchronize: each step's launches equal `per_step` (in COUNTED's order),
    each step finite and applied; afterwards the frozen params bit-identical
    and at least 90% of the trained leaves (`trainable_parameters`) changed.
    Returns (launches in all, ms per step, losses, peak bytes allocated)."""
    from deepsir_tpu_torch.training import train_step
    from deepsir_tpu_torch.utils.params import trainable_parameters
    counted = kernels()
    want = dict(zip(COUNTED, per_step))
    trained = {n for n, _ in trainable_parameters(model)}
    before = {k: v.clone() for k, v in model.state_dict().items()}
    total = dict.fromkeys(COUNTED, 0)
    torch.cuda.reset_peak_memory_stats(dev)
    times, losses = [], []
    for arrays in feeds:
        torch.cuda.synchronize()
        reset_counts(counted)
        t0 = time.perf_counter()
        out = train_step(model, opt, cfgs, arrays, gen, steps_per_epoch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        launches, _ = read_counts(counted)
        if launches != want:
            raise AssertionError(f"{what} step: launches {launches}, expected {want}")
        for key, n in launches.items():
            total[key] += n
        if out["skipped"] or not np.isfinite(float(out["loss"])):
            raise AssertionError(f"{what}: step skipped or not finite: {out['loss']}")
        losses.append({"total": float(out["loss"]),
                       **{k: float(v) for k, v in out.get("losses", {}).items()},
                       **({"acc": float(out["acc"])} if "acc" in out else {})})
    peak = torch.cuda.max_memory_allocated(dev)
    changed = 0
    for key, value in model.state_dict().items():
        if key in trained:
            changed += not torch.equal(value, before[key])
        elif not torch.equal(value, before[key]):
            raise AssertionError(f"{what}: frozen parameter {key} changed")
    if changed < 0.9 * len(trained):
        raise AssertionError(f"{what}: {changed} of {len(trained)} trained leaves changed")
    return total, times, losses, peak


def train_full_width(torch, dev, name: str):
    """TRAIN_STEPS training steps at full width (N_POINTS, feat_len 4, B=1,
    2 registration iterations, dropout 0.5 from a seeded CUDA generator,
    seeded weights) along one case through `timed_steps`; then one step
    against its plain version. Returns (launches, record, model, optimizer)."""
    options, per_step = TRAIN_CASES[name]
    cfgs, model, opt = seeded_training(dev, name)
    rng = np.random.default_rng(0)
    feeds = [train_arrays(rng, 1) for _ in range(TRAIN_STEPS)]
    gen = torch.Generator(device=dev).manual_seed(0)
    launches, times, losses, peak = timed_steps(torch, dev, f"train {name}", model, opt, cfgs,
                                                feeds, gen, 1, per_step)
    vs_plain = _step_against_plain(torch, model, cfgs, feeds[0], dev, seed=1,
                                   require_held=False)
    record = {"case": name, "points": N_POINTS, "batch": 1, "steps": TRAIN_STEPS,
              "ms_per_step": float(np.median(times[1:])), "step_ms": times,
              "max_memory_allocated": int(peak), "losses": losses, "launches": launches,
              "vs_plain": vs_plain, "options": options}
    log(f"train {name} at {N_POINTS} points: {record['ms_per_step']:.3f} ms per step (median "
        f"of {TRAIN_STEPS - 1} after a warm-up; {[round(t, 3) for t in times]}), peak "
        f"{peak / 2**30:.3f} GiB, loss {[round(x['total'], 5) for x in losses]}, launches "
        f"{launches}; against plain: {vs_plain}")
    return launches, record, model, opt


def round_trip(torch, model, opt, dev, step: int):
    """`save_checkpoint` of `model` and its Adam state, then `load_train_state`
    into a fresh network and optimizer of the same pipeline: (bytes written,
    whether params, moments and counts read back bit-equal)."""
    import tempfile
    from deepsir_tpu_torch.models.network import Network
    from deepsir_tpu_torch.training import make_optimizer
    from deepsir_tpu_torch.utils.checkpoint import load_train_state, save_checkpoint
    from deepsir_tpu_torch.utils.params import trainable_parameters
    with tempfile.TemporaryDirectory() as tmp:
        path = save_checkpoint(Path(tmp) / f"model_{step}.msgpack", model, opt, step)
        fresh = Network(model.cfg, model.pipeline).to(dev)
        fresh_opt = make_optimizer(fresh)
        stored = load_train_state(path, fresh, fresh_opt)
        size = path.stat().st_size
    equal = stored == step and all(
        torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                          fresh.state_dict().values()))
    for (_, p), (_, q) in zip(trainable_parameters(model), trainable_parameters(fresh)):
        a, b = opt.state[p], fresh_opt.state[q]
        equal &= all(torch.equal(a[k].to(b[k].device), b[k])
                     for k in ("exp_avg", "exp_avg_sq", "step"))
    return size, equal


def check_train(torch, dev):
    """The "train" phase: parity with JAX on trained weights, the full-width
    cases, and a checkpoint round trip. Returns (launches, record)."""
    total = dict.fromkeys(COUNTED, 0)
    launches, record = train_parity(torch, dev)
    record = {"parity": record}
    for key, n in launches.items():
        total[key] += n
    for name in TRAIN_CASES:
        launches, record[name], model, opt = train_full_width(torch, dev, name)
        for key, n in launches.items():
            total[key] += n
    record["trained_vs_plain"] = train_trained_against_plain(torch, dev)
    # round trip of the last case's model and Adam state
    size, equal = round_trip(torch, model, opt, dev, TRAIN_STEPS)
    if not equal:
        raise AssertionError("train: the checkpoint round trip is not bit-equal")
    record["round_trip"] = {"bytes": size, "step": TRAIN_STEPS, "bit_equal": True}
    log(f"train checkpoint round trip: {size} bytes, params, moments and count bit-equal")
    return total, record


# ---------------------------------------------------- label and feat pipelines

STAGE_FIXTURE = ROOT / "tests" / "data" / "torch_parity_stages.npz"
STAGE_RUNS = {"label": ROOT / "logs_r3" / "staged_po" / "260817_185436_label",
              "feat": ROOT / "logs_r3" / "staged_po" / "260817_185849_feat",
              "align": CKPT_RUN}
# (leaves, params) of each stage's checkpoint
STAGE_LEAVES = {"label": (155, 1_330_467), "feat": (185, 1_416_771)}
STAGE_STEPS_PER_EPOCH = 32        # the staged runs: 256 synthetic pairs in batches of 8
FEAT_TILE = 1500                  # circle_loss_tile of the full-width feat step
STAGE_STEPS = 4                   # full-width steps per pipeline: one warm-up, three timed
K1_PER_BATCH = 16                 # both clouds' pyramids, 4 levels


def stage_config(pipeline: str, num_points: int, **model):
    """A staged run's RunConfig through read_run_config, at `num_points` and
    with `model`'s fields replaced; the feat loss streams its columns in
    FEAT_TILE tiles above 1024 points."""
    from deepsir_tpu_torch.config import read_run_config, replace
    cfgs = read_run_config(STAGE_RUNS[pipeline])
    loss = cfgs.loss
    if pipeline == "feat" and num_points > 1024:
        loss = replace(loss, circle_loss_tile=FEAT_TILE)
    return cfgs._replace(model=replace(cfgs.model, num_points=num_points, **model), loss=loss)


def _scaled_err(torch, got, want) -> float:
    """Largest entry difference over the reference's largest magnitude;
    `want` a numpy array or a tensor on any device."""
    want = torch.as_tensor(want).to(got.device).double()
    return float((got.double() - want).abs().max() / want.abs().max().clamp_min(1e-30))


def stage_forward_errors(torch, pipeline, out, fx, arrays, cfgs) -> dict:
    """forward_pair's outputs against the stages fixture's JAX forward:
    each output's error relative to its scale, the loss's relative error and
    the accuracies (label: argmax flips too)."""
    from deepsir_tpu_torch.losses.detdes import det_des_loss
    from deepsir_tpu_torch.losses.semantic import semantic_loss
    dev = out.logits_src.device
    rec = {}
    if pipeline == "label":
        rec["logits"] = max(_scaled_err(torch, out.logits_src, fx["label/logits_src"]),
                            _scaled_err(torch, out.logits_ref, fx["label/logits_ref"]))
        terms = [semantic_loss(getattr(out, f"logits_{s}"),
                               torch.as_tensor(arrays[f"labels_{s}"], device=dev))
                 for s in ("src", "ref")]
        loss, acc = terms[0][0] + terms[1][0], (terms[0][1] + terms[1][1]) / 2
        flips = sum(int((getattr(out, f"logits_{s}").argmax(-1).cpu().numpy()
                         != fx[f"label/logits_{s}"].argmax(-1)).sum()) for s in ("src", "ref"))
        rec["argmax_flips"] = flips
        rec["argmax_flip_share"] = flips / (2 * fx["label/logits_src"][..., 0].size)
    else:
        rec["scores"] = max(_scaled_err(torch, out.score_src, fx["feat/score_src"]),
                            _scaled_err(torch, out.score_ref, fx["feat/score_ref"]))
        stride = out.feat_src.shape[1] // fx["feat/feat_src_rows"].shape[1]
        rec["descriptors"] = max(
            _scaled_err(torch, out.feat_src[:, ::stride], fx["feat/feat_src_rows"]),
            _scaled_err(torch, out.feat_ref[:, ::stride], fx["feat/feat_ref_rows"]))
        loss, acc = det_des_loss(out.feat_src, out.feat_ref, out.xyz_src, out.xyz_ref,
                                 out.score_src, out.score_ref,
                                 torch.as_tensor(arrays["transform_gt"], device=dev), cfgs.loss)
    want = float(fx[f"{pipeline}/loss"])
    rec.update(loss=float(loss), jax_loss=want, loss_rel_err=abs(float(loss) - want) / abs(want),
               acc=float(acc), jax_acc=float(fx[f"{pipeline}/acc"]))
    return rec


def stage_parity(torch, dev, pipeline: str, fwd_tol=1e-5, loss_rtol=1e-5, grad_rtol=1e-4,
                 param_rtol=1e-5):
    """A staged checkpoint (`pipeline` "label" or "feat") against the JAX
    package's stored eval forward and resumed step at 1024 points
    (tests/data/torch_parity_stages.npz, JAX over exact pyramids, which the
    port's must equal): the checkpoint read by the port's decoder; forward
    outputs within `fwd_tol` of each one's scale (label logits: at most
    0.1% of argmax flips), the loss within `loss_rtol` relative, the
    accuracy equal; then the checkpoint resumed with its Adam state at
    dropout 0 for one `train_step`: loss within `loss_rtol`, `skipped`
    and the lr equal, each trained leaf's grad within `grad_rtol` and its
    param after the step within `param_rtol` of the leaf's scale.
    Returns (launches, record)."""
    from deepsir_tpu_torch.models.network import Network
    from deepsir_tpu_torch.training import device_batch, make_optimizer, train_step
    from deepsir_tpu_torch.utils.checkpoint import load_checkpoint, load_train_state
    from deepsir_tpu_torch.utils.params import trainable_parameters
    fx = dict(np.load(STAGE_FIXTURE))
    arrays = {k: fx[k] for k in ("points_src", "points_ref", "transform_gt", "labels_src",
                                 "labels_ref")}
    cfgs = stage_config(pipeline, int(fx["points_src"].shape[1]), dropout_rate=0.0)
    model = load_checkpoint(cfgs.model, STAGE_RUNS[pipeline] / "ckpt", device=dev,
                            pipeline=pipeline)
    counted = kernels()
    reset_counts(counted)
    batch = device_batch(cfgs.model, arrays, device=dev)
    for side in ("src", "ref"):
        _exact_pyramid_agrees(torch, f"{pipeline} {side}", getattr(batch, f"pyramid_{side}"),
                              cfgs.model.sub_sampling_ratio)
    with torch.no_grad():
        out = model.forward_pair(batch)
    rec = stage_forward_errors(torch, pipeline, out, fx, arrays, cfgs)
    worst = max(rec.get(k, 0.0) for k in ("logits", "scores", "descriptors"))
    if (worst > fwd_tol or rec["loss_rel_err"] > loss_rtol or rec["acc"] != rec["jax_acc"]
            or rec.get("argmax_flip_share", 0.0) > 1e-3):
        raise AssertionError(f"{pipeline} parity forward: {rec}")

    model = Network(cfgs.model, pipeline).to(dev)
    opt = make_optimizer(model)
    count = load_train_state(STAGE_RUNS[pipeline] / "ckpt", model, opt)
    if count != int(fx[f"{pipeline}_step/count"]):
        raise AssertionError(f"{pipeline} parity: resumed count {count}")
    step = train_step(model, opt, cfgs, arrays, torch.Generator(device=dev).manual_seed(0),
                      STAGE_STEPS_PER_EPOCH)
    want_loss = float(fx[f"{pipeline}_step/step_loss"])
    srec = {"count": count, "loss": float(step["loss"]), "jax_loss": want_loss,
            "loss_rel_err": abs(float(step["loss"]) - want_loss) / abs(want_loss),
            "lr": step["lr"], "jax_lr": float(fx[f"{pipeline}_step/step_lr"]),
            "skipped": step["skipped"]}
    grads, want = flax_leaves(step["grads"]), stored_leaves(fx, f"{pipeline}_step/grad")
    params = flax_leaves(dict(trainable_parameters(model)))
    want_params = stored_leaves(fx, f"{pipeline}_step/param1")
    if set(grads) != set(want) or set(params) != set(want_params):
        raise AssertionError(f"{pipeline} parity: trained leaves differ from the fixture's")
    srec["grad_rel_err"] = max(leaf_error(grads[k], want[k]) for k in want)
    srec["param_rel_err"] = max(leaf_error(params[k], want_params[k]) for k in want_params)
    if (srec["loss_rel_err"] > loss_rtol or srec["skipped"]
            or srec["skipped"] != bool(fx[f"{pipeline}_step/step_skipped"])
            or abs(srec["lr"] - srec["jax_lr"]) > 1e-9 or srec["grad_rel_err"] > grad_rtol
            or srec["param_rel_err"] > param_rtol):
        raise AssertionError(f"{pipeline} parity step: {srec}")
    rec["step"] = srec
    launches, _ = read_counts(counted)
    rec["launches"] = launches
    log(f"{pipeline} parity {cfgs.model.num_points} points, {len(arrays['points_src'])} pairs: "
        f"forward {json.dumps({k: v for k, v in rec.items() if k != 'step'})}; "
        f"resumed step {json.dumps(srec)}")
    return launches, rec


def stage_arrays(rng, pipeline: str, feat_len: int):
    """One full-width batch: label make_arrays' clouds with random labels
    0..19 (0 ignored); feat train_arrays' rigid pairs."""
    if pipeline == "feat":
        return train_arrays(rng, 1, feat_len)
    arrays = make_arrays(rng, 1, feat_len=feat_len)
    for side in ("src", "ref"):
        arrays[f"labels_{side}"] = rng.integers(0, 20, size=(1, N_POINTS)).astype(np.int32)
    return arrays


def _pyramids_agree(torch, what, batch, plain_batch, ratios) -> int:
    """The kernel's (shuffled-order) pyramids against the plain KNN's: equal
    but for near ties (`_pyramid_near_ties`); returns the differing entries."""
    n_ties = 0
    for side in ("src", "ref"):
        pyr, ppyr = getattr(batch, f"pyramid_{side}"), getattr(plain_batch, f"pyramid_{side}")
        for lvl, r in enumerate(ratios):
            xyz = pyr.xyz[lvl]
            n_ties += _pyramid_near_ties(torch, f"{what} {side} neigh_idx[{lvl}]",
                                         pyr.neigh_idx[lvl], ppyr.neigh_idx[lvl].cpu().numpy(),
                                         xyz, xyz)
            n_ties += _pyramid_near_ties(torch, f"{what} {side} interp_idx[{lvl}]",
                                         pyr.interp_idx[lvl], ppyr.interp_idx[lvl].cpu().numpy(),
                                         xyz, xyz[:, :xyz.shape[1] // r])
    return n_ties


def stage_against_plain(torch, model, cfgs, arrays, dev):
    """The full-width forward and one training forward + backward with the
    kernels and again with every kernel swapped for its plain version (same
    params, same dropout seed): pyramids equal but for near ties; where
    they are equal, the forward outputs within 1e-4 of each one's scale,
    the loss within 1e-4 relative and each trained leaf's grad within 1e-3
    of its scale. Returns the record."""
    k, p = _runs_against_plain(torch, model, cfgs, arrays, dev, seed=3, forward=True)
    (batch, out, loss, grads), (pbatch, pout, ploss, pgrads) = (
        (r["batch"], r["out"], r["loss"], r["grads"]) for r in (k, p))
    rec = {"pyramid_near_ties": _pyramids_agree(torch, model.pipeline, batch, pbatch,
                                                cfgs.model.sub_sampling_ratio),
           "loss": loss, "plain_loss": ploss}
    if rec["pyramid_near_ties"]:
        return rec                        # held only where the pyramids are equal
    fields = ("logits_src", "logits_ref", "feat_src", "feat_ref", "score_src", "score_ref")
    rec["forward_rel_err"] = max(_scaled_err(torch, getattr(out, f), getattr(pout, f))
                                 for f in fields if getattr(out, f) is not None)
    rec["loss_rel_err"] = abs(loss - ploss) / abs(ploss)
    rec["grad_rel_err"] = _grads_agree(grads, pgrads, 1e-3)
    if rec["forward_rel_err"] > 1e-4 or rec["loss_rel_err"] > 1e-4:
        raise AssertionError(f"{model.pipeline}: kernels against plain: {rec}")
    return rec


def stage_full_width(torch, dev, pipeline: str):
    """A staged checkpoint at full width (N_POINTS, B=1) under its run
    config: the forward and a step's grads against the plain kernels;
    forward_step timed (median of 3 after a warm-up); STAGE_STEPS training
    steps at the config's dropout 0.5 from a seeded CUDA generator, each
    finite and applied, frozen params bit-identical, trained ones changed;
    K1 launched K1_PER_BATCH times per forward and per step; a checkpoint
    round trip bit-equal. Returns (launches of the forwards and steps, record)."""
    from deepsir_tpu_torch.models.network import Network
    from deepsir_tpu_torch.training import forward_step, make_optimizer
    from deepsir_tpu_torch.utils.checkpoint import read_params
    from deepsir_tpu_torch.utils.params import from_jax_params
    cfgs = stage_config(pipeline, N_POINTS)
    model = Network(cfgs.model, pipeline)
    model.load_state_dict(from_jax_params(read_params(STAGE_RUNS[pipeline] / "ckpt"), model))
    model.to(dev)
    rng = np.random.default_rng(0)
    feeds = [stage_arrays(rng, pipeline, cfgs.model.feat_len) for _ in range(STAGE_STEPS)]
    vs_plain = stage_against_plain(torch, model, cfgs, feeds[0], dev)

    counted = kernels()
    total = dict.fromkeys(COUNTED, 0)
    model.eval()
    torch.cuda.reset_peak_memory_stats(dev)
    fwd_ms = []
    for arrays in feeds:
        torch.cuda.synchronize()
        reset_counts(counted)
        t0 = time.perf_counter()
        out = forward_step(model, cfgs.model, arrays)
        torch.cuda.synchronize()
        fwd_ms.append((time.perf_counter() - t0) * 1e3)
        launches, _ = read_counts(counted)
        if launches != dict(zip(COUNTED, (K1_PER_BATCH, 0, 0, 0))):
            raise AssertionError(f"{pipeline} forward: launches {launches}")
        for key, n in launches.items():
            total[key] += n
        finite = all(bool(torch.isfinite(t).all()) for t in out if t is not None)
        if not finite:
            raise AssertionError(f"{pipeline} forward: outputs not finite")
    fwd_peak = torch.cuda.max_memory_allocated(dev)
    rows = cfgs.model.num_sub if pipeline == "feat" and cfgs.model.num_sub > 0 else N_POINTS
    if tuple(out.feat_src.shape) != (1, rows, cfgs.model.out_feat_dim) or \
            tuple(out.logits_src.shape) != (1, N_POINTS, cfgs.model.num_classes):
        raise AssertionError(f"{pipeline} forward: shapes {out.feat_src.shape}, "
                             f"{out.logits_src.shape}")

    model.train()
    opt = make_optimizer(model)
    gen = torch.Generator(device=dev).manual_seed(0)
    launches, step_ms, losses, step_peak = timed_steps(
        torch, dev, pipeline, model, opt, cfgs, feeds, gen, STAGE_STEPS_PER_EPOCH,
        (K1_PER_BATCH, 0, 0, 0))
    for key, n in launches.items():
        total[key] += n

    size, equal = round_trip(torch, model, opt, dev, STAGE_STEPS)
    if not equal:
        raise AssertionError(f"{pipeline}: the checkpoint round trip is not bit-equal")
    record = {"points": N_POINTS, "batch": 1, "steps": STAGE_STEPS,
              "ms_per_forward": float(np.median(fwd_ms[1:])), "forward_ms": fwd_ms,
              "ms_per_step": float(np.median(step_ms[1:])), "step_ms": step_ms,
              "forward_max_memory_allocated": int(fwd_peak),
              "step_max_memory_allocated": int(step_peak), "losses": losses,
              "launches": total, "vs_plain": vs_plain,
              "round_trip": {"bytes": size, "bit_equal": True},
              "loss_options": {"circle_loss_tile": cfgs.loss.circle_loss_tile}}
    log(f"{pipeline} at {N_POINTS} points: {record['ms_per_forward']:.3f} ms per forward "
        f"({[round(t, 3) for t in fwd_ms]}), peak {fwd_peak / 2**30:.3f} GiB; "
        f"{record['ms_per_step']:.3f} ms per step ({[round(t, 3) for t in step_ms]}), peak "
        f"{step_peak / 2**30:.3f} GiB; losses {losses}; launches {total}; against plain: "
        f"{vs_plain}; round trip {size} bytes bit-equal")
    return total, record


def check_stage(torch, dev, pipeline: str):
    """The "label" or "feat" phase: the checkpoint's leaves, parity with JAX
    at 1024 points (card gates: forward 1e-4, loss 1e-4, grads and params
    1e-3 of each leaf's scale; K1 16 times in the forward and 16 in the
    step), and the full-width run. Returns (launches of the parity and
    full-width forwards and steps, record)."""
    from deepsir_tpu_torch.utils.checkpoint import read_params
    leaves = []

    def walk(tree):
        for v in tree.values():
            walk(v) if isinstance(v, dict) else leaves.append(v)
    t0 = time.perf_counter()
    walk(read_params(STAGE_RUNS[pipeline] / "ckpt"))
    decode_s = time.perf_counter() - t0
    got = (len(leaves), sum(int(a.size) for a in leaves))
    if got != STAGE_LEAVES[pipeline]:
        raise AssertionError(f"{pipeline} checkpoint: {got} (leaves, params)")
    launches, parity = stage_parity(torch, dev, pipeline, fwd_tol=1e-4, loss_rtol=1e-4,
                                    grad_rtol=1e-3, param_rtol=1e-3)
    if launches != dict(zip(COUNTED, (2 * K1_PER_BATCH, 0, 0, 0))):
        raise AssertionError(f"{pipeline} parity: launches {launches}")
    full_launches, full = stage_full_width(torch, dev, pipeline)
    launches = {k: n + full_launches[k] for k, n in launches.items()}
    return launches, {"checkpoint": {"leaves": got[0], "params": got[1], "decode_s": decode_s},
                      "parity": parity, "full_width": full}


def check_stages(torch, dev):
    """The "stages" phase: the staged chain on the card. A seeded feat
    network takes the label checkpoint's leaves through partial_restore,
    and a seeded align network the feat checkpoint's: the counts JAX's
    partial_restore loads (the stages fixture), every loaded leaf equal to
    the stored one and every other parameter as it was."""
    from deepsir_tpu_torch.config import from_run_config
    from deepsir_tpu_torch.models.network import Network
    from deepsir_tpu_torch.utils.checkpoint import partial_restore, read_params
    from deepsir_tpu_torch.utils.params import from_jax_params, init_params
    fx = dict(np.load(STAGE_FIXTURE))
    record = {}
    for source, into in (("label", "feat"), ("feat", "align")):
        cfg = from_run_config(STAGE_RUNS[into])
        model = Network(cfg, into)
        model.load_state_dict(init_params(cfg, seed=0, pipeline=into))
        model.to(dev)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        loaded = partial_restore(STAGE_RUNS[source] / "ckpt", model)
        want = fx[f"chain/{source}->{into}"]
        if [loaded, len(before)] != want.tolist():
            raise AssertionError(f"stages {source}->{into}: loaded {loaded} of {len(before)}, "
                                 f"JAX {want.tolist()}")
        stored = from_jax_params(read_params(STAGE_RUNS[source] / "ckpt"),
                                 Network(from_run_config(STAGE_RUNS[source]), source))
        for key, value in model.state_dict().items():
            expect = stored[key].to(dev) if key in stored else before[key]
            if not torch.equal(value, expect):
                raise AssertionError(f"stages {source}->{into}: {key} differs")
        record[f"{source}->{into}"] = {"loaded": loaded, "leaves": len(before)}
    log(f"stages on the card: {json.dumps(record)}, as JAX's partial_restore")
    return record


# ---------------------------------------------------------------- eval harness

EVAL_FIXTURE = ROOT / "tests" / "data" / "torch_parity_eval.npz"
EVAL_BATCHES = 2                  # the 8 parity pairs as 2 batches of 4
ICP_LAUNCHES = 30                 # K1 k=1 searches per ICP batch
# the refined poses against JAX's by `pose_gap`, on the pairs that JAX
# registers and whose forward held every iteration: an unregistered pair's
# refiners start 20-40 deg off, where ICP's distance gate and RANSAC's
# inlier counts flip at their borders (1e-3 apart on the CPU)
EVAL_POSE_TOL = 1e-4
# the refiners on JAX's own inputs against JAX's float64 references and
# its float32 results, by `pose_gap`
REFINER_TOL = {"finetune_f64": 1e-5, "icp_f64": 1e-5, "finetune": 1e-5, "icp": 1e-5,
               "ransac": 1e-5}
# per-pair metrics of the same pairs against JAX's: err_t and chamfer_dist
# absolute; err_r_deg absolute, set by the float32 arccos near 0, where a
# change d of the trace moves the angle by up to sqrt(d) rad (1 ulp: 0.02
# deg, 3e-6: 0.1 deg)
EVAL_METRIC_TOL = {"err_t": 1e-4, "chamfer_dist": 1e-4, "err_r_deg": 0.2}


def pose_gap(got, want, radius) -> np.ndarray:
    """Per pair, the larger of the largest rotation-entry difference and the
    largest translation difference in units of the clouds' radius `radius`
    (B,): (B, 3, 4) poses -> (B,). A float32 pose solve over clouds of
    radius r carries translation errors of order r * 1e-6."""
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    return np.maximum(d[..., :3].max(axis=(1, 2)), d[..., 3].max(axis=1) / radius)


def eval_config(n: int, **setting):
    """The staged align run's RunConfig at `n` points with `setting`'s
    EvalConfig fields."""
    from deepsir_tpu_torch.config import read_run_config, replace
    cfgs = read_run_config(CKPT_RUN)
    return cfgs._replace(model=replace(cfgs.model, num_points=n),
                         eval=replace(cfgs.eval, **setting))


def _split(arrays, batches: int):
    """Host batch dicts: `arrays` cut into `batches` equal batches."""
    b = len(arrays["transform_gt"]) // batches
    return [{k: v[i * b:(i + 1) * b] for k, v in arrays.items()} for i in range(batches)]


def _held_pairs(torch, step, batches, want_idx, cfg):
    """The eval step's iterations held to JAX's matches (held_iterations)
    for each pair, the forward run batch by batch as inference_align runs it."""
    from deepsir_tpu_torch.training import device_batch
    held = []
    for arrays, want in zip(batches, np.split(want_idx, len(batches), axis=1)):
        _, out = step(arrays)
        mask = device_batch(cfg, arrays, device=step.device).mask_src
        cond = solve_conditioning(torch, out, out.pt_src, out.pt_ref, cfg, mask)
        held.append(held_iterations(out.pred_idx.cpu().numpy(), want, cond.cpu().numpy()))
    return np.concatenate(held)


def read_artifacts(path: Path, metrics):
    """The CSVs written by save_eval_align must hold `metrics` as `%.8g`
    text, and metrics.xlsx one sheet Iter_i per iteration; returns the sheet
    names."""
    import xml.etree.ElementTree as ET
    import zipfile
    for i, m in enumerate(metrics):
        m = dict(m)
        m["r_rmse"], m["t_rmse"] = np.sqrt(m.pop("r_mse")), np.sqrt(m.pop("t_mse"))
        lines = (path / f"metrics_iter_{i + 1}.csv").read_text().splitlines()
        if lines[0].split(",") != list(m):
            raise AssertionError(f"eval artifacts: header {lines[0]}")
        want = [",".join(f"{float(m[k][r]):.8g}" for k in m) for r in range(len(lines) - 1)]
        if lines[1:] != want or len(want) != len(m["succ"]):
            raise AssertionError(f"eval artifacts: metrics_iter_{i + 1}.csv differs")
    ns = "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}"
    with zipfile.ZipFile(path / "metrics.xlsx") as z:
        book = ET.fromstring(z.read("xl/workbook.xml"))
        names = [s.get("name") for s in book.iter(f"{ns}sheet")]
    if names != [f"Iter_{i + 1}" for i in range(len(metrics))]:
        raise AssertionError(f"eval artifacts: sheets {names}")
    return names


def eval_parity(torch, dev, out_dir: Path):
    """The eval harness with trained weights against JAX at 1024 points: the
    staged align checkpoint on the 8 checkpoint pairs (2 batches of 4)
    through device_prefetch -> make_eval_step -> inference_align ->
    evaluate_align -> save_eval_align under each EVAL_SETTINGS setting,
    held to tests/data/torch_parity_eval.npz: success flags equal for every
    pair; for the pairs that JAX registers and whose forward held every
    iteration (held_iterations), the refined pose within EVAL_POSE_TOL by
    `pose_gap` and the per-pair metrics within EVAL_METRIC_TOL; the written CSVs equal to the
    metrics, the xlsx sheets Iter_1..Iter_6. On the card each setting's
    sweep is a main-path run: K1 16 per eval step (a warm-up and one per
    batch) and 30 per ICP batch, K2 5 per eval step. Returns (launches,
    record)."""
    from deepsir_tpu_torch.evaluation import evaluate_align, inference_align, save_eval_align
    from deepsir_tpu_torch.training import make_eval_step
    from deepsir_tpu_torch.utils.checkpoint import load_checkpoint
    fx = dict(np.load(EVAL_FIXTURE))
    ck = dict(np.load(CKPT_FIXTURE))
    arrays = checkpoint_arrays(ck, 1024)
    cfgs = eval_config(1024)
    model = load_checkpoint(cfgs.model, CKPT_RUN / "ckpt", device=dev)
    step = make_eval_step(model, cfgs.model)
    batches = _split(arrays, EVAL_BATCHES)
    half = [dict(b, **{k: b[k].astype(np.float16).astype(np.float32)
                       for k in ("points_src", "points_ref")}) for b in batches]
    held = {"float32": _held_pairs(torch, step, batches, ck["ckpt0_pred_idx"].astype(np.int64),
                                   cfgs.model),
            "float16": _held_pairs(torch, step, half, fx["eval/pred_idx_f16"].astype(np.int64),
                                   cfgs.model)}
    picks = torch.from_numpy(fx["eval/ransac_picks"].astype(np.int64)).to(dev)
    radius = np.abs(arrays["points_src"][..., :3]).max(axis=(1, 2))
    counted = kernels()
    total = dict.fromkeys(COUNTED, 0)
    record = {"pairs": len(arrays["transform_gt"]), "batches": EVAL_BATCHES,
              "held_iterations": {k: v.tolist() for k, v in held.items()}}
    n_iter = cfgs.model.num_reg_iter
    for name, setting in EVAL_SETTINGS.items():
        cfgs_s = eval_config(1024, **setting)
        reset_counts(counted)
        pred, endpoints = inference_align(batches, step, cfgs_s,
                                          stats_path=str(out_dir / f"{name}_stats.npz"),
                                          ransac_picks=picks)
        launches, _ = read_counts(counted)
        steps = EVAL_BATCHES + 1
        want = dict.fromkeys(COUNTED, 0)
        want.update(knn_topk=16 * steps + ICP_LAUNCHES * EVAL_BATCHES * cfgs_s.eval.use_icp,
                    match_argmin=5 * steps)
        if dev.type == "cuda" and launches != want:
            raise AssertionError(f"eval {name}: launches {launches}, expected {want}")
        for key, value in launches.items():
            total[key] += value
        metrics, summary = evaluate_align(pred, batches, cfgs_s, device=dev)
        save_eval_align(pred, {k: np.concatenate(v) for k, v in endpoints.items()}, metrics,
                        summary, str(out_dir / name))
        sheets = read_artifacts(out_dir / name, metrics)
        if pred.shape != (len(arrays["transform_gt"]), n_iter + 1, 3, 4) or \
                not np.isfinite(pred).all():
            raise AssertionError(f"eval {name}: pred_transforms {pred.shape}")
        ok = ((held["float16" if "transfer_dtype" in setting else "float32"] == n_iter)
              & (fx[f"eval/{name}/succ"] > 0))
        pose_err = pose_gap(pred[:, -1], fx[f"eval/{name}/pose"], radius)
        last = metrics[-1]
        rec = {"pose_gap": pose_err.tolist(), "held": ok.tolist(),
               "held_pose_gap": float(pose_err[ok].max()),
               "succ": last["succ"].tolist(), "launches": launches, "sheets": sheets,
               "stats_s": np.load(out_dir / f"{name}_stats.npz")["stats"][0, :, 3].tolist()}
        for key in EVAL_METRIC_TOL:
            rec[f"{key}_err"] = float(np.abs(last[key] - fx[f"eval/{name}/{key}"])[ok].max())
        record[name] = rec
        log(f"eval parity {name}: {json.dumps(rec)}")
        if not np.array_equal(last["succ"], fx[f"eval/{name}/succ"]):
            raise AssertionError(f"eval {name}: success {last['succ']}, JAX "
                                 f"{fx[f'eval/{name}/succ']}")
        if rec["held_pose_gap"] > EVAL_POSE_TOL or any(
                rec[f"{k}_err"] > tol for k, tol in EVAL_METRIC_TOL.items()):
            raise AssertionError(f"eval {name}: {rec}")
    return total, record


def eval_refiners(torch, dev):
    """Each refiner on the JAX forward's own outputs (the eval fixture):
    finetune and ICP against JAX's float64 references and its float32
    results, RANSAC with JAX's draws against its result, each within
    REFINER_TOL by `pose_gap` (the clouds' radius is ~12). Returns the
    record."""
    from deepsir_tpu_torch.evaluation import ICP_ITERS, finetune_pose
    from deepsir_tpu_torch.ops.gather import gather_points
    from deepsir_tpu_torch.ops.icp import icp
    from deepsir_tpu_torch.ops.ransac import ransac_correspondence
    fx = dict(np.load(EVAL_FIXTURE))
    arrays = checkpoint_arrays(dict(np.load(CKPT_FIXTURE)), 1024)
    cfgs = eval_config(1024)
    dist = cfgs.voxel_size * 2

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(x)).to(device=dev, dtype=dtype)
    src, ref = t(arrays["points_src"][..., :3]), t(arrays["points_ref"][..., :3])
    pose_in = t(fx["eval/transforms"][-1])
    idx = t(fx["eval/pred_idx"].astype(np.int64), torch.int64)
    got = {"finetune": finetune_pose(src, gather_points(ref, idx), pose_in,
                                     torch.sigmoid(t(fx["eval/inlier_logits"])), dist),
           "icp": icp(src, ref, dist, init=pose_in, num_iter=ICP_ITERS)}
    picks = t(fx["eval/ransac_picks"], torch.int64)
    rows = torch.arange(idx.shape[1], device=dev)
    got["ransac"] = torch.stack([ransac_correspondence(s, r, torch.stack([rows, i], -1), dist,
                                                       picks=picks)[0]
                                 for s, r, i in zip(src, ref, idx)])
    got = {k: v.cpu().numpy() for k, v in got.items()}
    radius = np.abs(arrays["points_src"][..., :3]).max(axis=(1, 2))
    rec = {}
    for key, want in (("finetune_f64", fx["eval/finetune_f64"]), ("icp_f64", fx["eval/icp_f64"]),
                      ("finetune", fx["eval/finetune/pose"]), ("icp", fx["eval/icp/pose"]),
                      ("ransac", fx["eval/ransac/pose"])):
        rec[key] = float(pose_gap(got[key.split("_")[0]], want, radius).max())
    log(f"eval refiners on JAX's inputs: {json.dumps(rec)}")
    bad = {k: v for k, v in rec.items() if v > REFINER_TOL[k]}
    if bad:
        vs = ", ".join(f"{k}: {v:.3g} > {REFINER_TOL[k]} "
                       f"({'float64 reference' if k.endswith('f64') else 'JAX float32'})"
                       for k, v in bad.items())
        raise AssertionError(f"eval refiners: {vs}")
    return rec


def eval_sweeps(torch, dev, out_dir: Path):
    """inference_label and inference_feat of the staged label and feat
    checkpoints on the stages fixture's pairs: the label sweep's mIoU,
    per-class IoU and accuracy equal to JAX's, and both sweeps' dump files
    with JAX's names and shapes. Returns (launches, record)."""
    from functools import partial
    from deepsir_tpu_torch.evaluation import inference_feat, inference_label
    from deepsir_tpu_torch.training import forward_step
    from deepsir_tpu_torch.utils.checkpoint import load_checkpoint
    fx = dict(np.load(EVAL_FIXTURE))
    st = dict(np.load(STAGE_FIXTURE))
    arrays = {k: st[k] for k in ("points_src", "points_ref", "transform_gt", "labels_src",
                                 "labels_ref")}
    counted = kernels()
    reset_counts(counted)
    record = {}
    for pipeline in ("label", "feat"):
        cfgs = stage_config(pipeline, int(arrays["points_src"].shape[1]))
        model = load_checkpoint(cfgs.model, STAGE_RUNS[pipeline] / "ckpt", device=dev,
                                pipeline=pipeline)
        fwd = partial(forward_step, model, cfgs.model)
        path = out_dir / pipeline
        if pipeline == "label":
            miou, iou, acc = inference_label([arrays], fwd, str(path))
            record["label"] = {"miou": miou, "acc": acc, "jax_miou": float(fx["label/miou"]),
                               "jax_acc": float(fx["label/acc"])}
            if (miou != float(fx["label/miou"]) or acc != float(fx["label/acc"])
                    or not np.array_equal(iou, fx["label/iou"])):
                raise AssertionError(f"eval label sweep: {record['label']}, iou {iou}")
        else:
            inference_feat([arrays], fwd, str(path))
            record["feat"] = {}
        names = sorted(p.name for p in path.iterdir())
        shapes = [list(np.loadtxt(path / n).shape) for n in names]
        if names != fx[f"{pipeline}/dump_names"].tolist() or \
                shapes != fx[f"{pipeline}/dump_shapes"].tolist():
            raise AssertionError(f"eval {pipeline} dumps {names} {shapes}")
        record[pipeline].update(dumps=names)
    launches, _ = read_counts(counted)
    if dev.type == "cuda" and launches != dict.fromkeys(COUNTED, 0) | {"knn_topk": 2 * 16 * 2}:
        raise AssertionError(f"eval sweeps: launches {launches}")
    log(f"eval sweeps: {json.dumps(record)}")
    return launches, record


EVAL_FEEDS = 2                    # full-width batches per inference sweep (B=1)
REFINER_REPS = 3                  # timed runs of each refiner at full width


def _timed_peak(torch, fn, reps: int):
    """(median ms of `reps` runs of fn() on the host clock, each ending in a
    synchronize; peak max_memory_allocated over them in GiB; fn's last
    result)."""
    times = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(reps):
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), torch.cuda.max_memory_allocated() / 2 ** 30, result


def eval_sweep_full_width(torch, dev, name, model, cfgs, feeds, out_dir: Path):
    """inference_align -> evaluate_align -> save_eval_align at full width
    with every refiner on, as a main-path run: K1 16 per eval step (the
    warm-up and one per batch) and 30 per ICP batch, K2 5 per eval step.
    Returns (launches, record: ms per pair on inference_align's clock, the
    sweep's peak memory, success flags)."""
    from deepsir_tpu_torch.evaluation import evaluate_align, inference_align, save_eval_align
    from deepsir_tpu_torch.training import make_eval_step
    step = make_eval_step(model, cfgs.model)
    counted = kernels()
    reset_counts(counted)
    torch.cuda.reset_peak_memory_stats()
    pred, endpoints = inference_align(feeds, step, cfgs, stats_path=str(out_dir / f"{name}.npz"))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches, _ = read_counts(counted)
    steps = len(feeds) + 1
    want = dict.fromkeys(COUNTED, 0)
    want.update(knn_topk=16 * steps + ICP_LAUNCHES * len(feeds), match_argmin=5 * steps)
    if dev.type == "cuda" and launches != want:
        raise AssertionError(f"eval {name}: launches {launches}, expected {want}")
    if pred.shape != (len(feeds), cfgs.model.num_reg_iter + 1, 3, 4) or \
            not np.isfinite(pred).all():
        raise AssertionError(f"eval {name}: pred_transforms {pred.shape}")
    metrics, summary = evaluate_align(pred, feeds, cfgs, device=dev)
    save_eval_align(pred, {k: np.concatenate(v) for k, v in endpoints.items()}, metrics,
                    summary, str(out_dir / name))
    read_artifacts(out_dir / name, metrics)
    stats = np.load(out_dir / f"{name}.npz")["stats"][0]
    rec = {"pairs": len(feeds), "batch": 1, "ms_per_pair": (stats[:, 3] * 1e3).tolist(),
           "peak_gib": peak, "succ": metrics[-1]["succ"].tolist(),
           "succ_unrefined": metrics[-2]["succ"].tolist(), "launches": launches}
    log(f"eval full width {name}: {json.dumps(rec)}")
    return launches, rec


def icp_against_plain(torch, src, ref, dist, init):
    """ICP at full width with each of its 30 K1 searches held against
    knn_topk_plain on the same inputs (indices equal but for near ties by
    the pyramid rule), and the whole ICP against ICP over knn_topk_plain:
    poses within 1e-4. These are comparison launches, off the main path.
    Returns the record."""
    from unittest import mock
    from deepsir_tpu_torch.evaluation import ICP_ITERS
    from deepsir_tpu_torch.ops import icp as icp_module
    from deepsir_tpu_torch.ops.cuda_knn import knn_topk_plain
    searches, ties = [], 0
    kernel_knn = icp_module.knn

    def checked(query, cand, k):
        nonlocal ties
        got = kernel_knn(query, cand, k)
        want = knn_topk_plain(query, cand, k)
        ties += _pyramid_near_ties(torch, f"ICP search {len(searches)}", got[0],
                                   want[0].cpu().numpy(), query, cand)
        searches.append(1)
        return got

    with mock.patch.object(icp_module, "knn", checked):
        pose = icp_module.icp(src, ref, dist, init=init, num_iter=ICP_ITERS)
    with mock.patch.object(icp_module, "knn", knn_topk_plain):
        plain = icp_module.icp(src, ref, dist, init=init, num_iter=ICP_ITERS)
    err = float((pose - plain).abs().max())
    if len(searches) != ICP_ITERS or err > 1e-4:
        raise AssertionError(f"ICP against plain: {len(searches)} searches, pose err {err}")
    return {"searches": len(searches), "shape": f"{tuple(src.shape)} x {tuple(ref.shape)}, k=1",
            "index_near_ties": ties, "pose_err": err}


def refiner_calls(torch, dev, model, cfgs, pair):
    """Each refiner alone on the eval step's outputs for the host batch
    `pair` (B=1), as pose_optimization calls it: (name -> call, ICP's
    (src, ref, distance, initial pose))."""
    from deepsir_tpu_torch.evaluation import (FINETUNE_STEPS, ICP_ITERS, RANSAC_HYPOTHESES,
                                              finetune_pose)
    from deepsir_tpu_torch.ops.gather import gather_points
    from deepsir_tpu_torch.ops.icp import icp
    from deepsir_tpu_torch.ops.ransac import ransac_correspondence
    from deepsir_tpu_torch.training import make_eval_step
    _, out = make_eval_step(model, cfgs.model)(pair)
    dist = cfgs.voxel_size * 2
    pose = out.transforms[-1]
    src, ref = (torch.from_numpy(np.ascontiguousarray(pair[k][..., :3])).to(dev)
                for k in ("points_src", "points_ref"))
    matched = gather_points(out.pt_ref, out.pred_idx[-1])
    weights = torch.sigmoid(out.inlier_logits[-1])
    idx = out.pred_idx[-1][0]
    corres = torch.stack([torch.arange(idx.shape[0], device=dev), idx], -1)
    gen = torch.Generator(dev).manual_seed(0)
    n = src.shape[1]
    calls = {
        f"finetune ({FINETUNE_STEPS} Adam steps)":
            lambda: finetune_pose(out.pt_src, matched, pose, weights, dist),
        f"icp ({ICP_ITERS} iterations, K1 k=1 {n} x {n})":
            lambda: icp(src, ref, dist, init=pose, num_iter=ICP_ITERS),
        f"ransac ({RANSAC_HYPOTHESES} hypotheses x {n} pairs)":
            lambda: ransac_correspondence(out.pt_src[0], out.pt_ref[0], corres, dist,
                                          generator=gen)[0]}
    return calls, (src, ref, dist, pose)


def eval_full_width(torch, dev, out_dir: Path):
    """The eval harness at full width (18000 points, B=1): the inference
    sweep with every refiner on, over seeded weights on the default path
    (make_arrays clouds) and over the staged checkpoint on the checkpoint
    fixture's 2 full-width pairs; then each refiner alone on the
    checkpoint's first pair, timed (REFINER_REPS runs) with its peak memory;
    and ICP's K1 searches against knn_topk_plain. Returns (launches, record)."""
    from deepsir_tpu_torch.config import EvalConfig, LossConfig, RunConfig, TrainConfig
    from deepsir_tpu_torch.utils.checkpoint import load_checkpoint
    from deepsir_tpu_torch.utils.params import init_params, load_network
    refiners = dict(use_finetune=True, pose_average_last=3, use_icp=True, use_ransac=True)
    total = dict.fromkeys(COUNTED, 0)
    record = {}

    cfg = path_config("default")
    cfgs = RunConfig(cfg, LossConfig(), TrainConfig(), "align", EvalConfig(**refiners))
    rng = np.random.default_rng(0)
    feeds = [make_arrays(rng, 1) for _ in range(EVAL_FEEDS)]
    model = load_network(cfg, init_params(cfg, seed=0), device=dev)
    launches, record["default_seeded"] = eval_sweep_full_width(torch, dev, "default_seeded",
                                                               model, cfgs, feeds, out_dir)
    for key, value in launches.items():
        total[key] += value
    del model

    cfgs = eval_config(N_POINTS, **refiners)
    arrays = checkpoint_arrays(dict(np.load(CKPT_FIXTURE)), N_POINTS)
    model = load_checkpoint(cfgs.model, CKPT_RUN / "ckpt", device=dev)
    launches, record["checkpoint"] = eval_sweep_full_width(torch, dev, "checkpoint", model,
                                                           cfgs, _split(arrays, 2), out_dir)
    for key, value in launches.items():
        total[key] += value

    calls, (src, ref, dist, pose) = refiner_calls(torch, dev, model, cfgs,
                                                  _split(arrays, 2)[0])
    record["refiners"] = {}
    for name, fn in calls.items():
        base = torch.cuda.memory_allocated() / 2 ** 30
        ms, peak, result = _timed_peak(torch, fn, REFINER_REPS)
        if not bool(torch.isfinite(result).all()):
            raise AssertionError(f"eval refiner {name}: not finite")
        record["refiners"][name] = {"ms_per_batch": ms, "peak_gib": peak,
                                    "peak_above_start_gib": peak - base, "batch": 1}
    record["icp_against_plain"] = icp_against_plain(torch, src, ref, dist, pose)
    log(f"eval refiners at full width: {json.dumps(record['refiners'])}; ICP against plain "
        f"{json.dumps(record['icp_against_plain'])}")
    return total, record


# ---------------------------------------------------------------- the command lines

CLI_FIXTURE = ROOT / "tests" / "data" / "torch_parity_cli.npz"
CLI_EVAL_RUN = ROOT / "logs_r3" / "staged_po" / "eval" / "260817_191109_best"
CLI_REFINER_RUN = ROOT / "logs_r4" / "q2_finetune_full" / "260817_191109_best"
CLI_POSEAVG_RUN = ROOT / "logs_r4" / "q2_poseavg_full" / "260817_191109_best"
CLI_EVAL_PAIRS = 128              # the tracked staged eval command's pairs
CLI_REFINER_PAIRS = 16
CLI_RESUME_PAIRS = 8
# the files an align test run writes besides the scores' pickles (the
# tracked runs' names, without compareHead.diff, which needs git)
CLI_ARTIFACTS = sorted(["config.json", "log.txt", "metrics.xlsx", "pred_transforms.npy",
                        "stats.npz", "summary_metrics.json"]
                       + [f"metrics_iter_{i}.csv" for i in range(1, N_ITERS + 2)])


def tracked_command(run: Path) -> list:
    """The flags of the command on line 1 of a tracked run's log.txt."""
    import shlex
    line = (run / "log.txt").read_text().splitlines()[0]
    return shlex.split(line.split("Command: ", 1)[1])[1:]


def refiner_commands(pairs: int = CLI_REFINER_PAIRS) -> dict:
    """setting -> test command flags: the tracked finetune and pose-average
    commands, and the finetune command with ICP in place of the finetune,
    each on `pairs` pairs (a flag given again takes the later value)."""
    finetune = tracked_command(CLI_REFINER_RUN)
    return {name: argv + ["--synthetic_eval_size", str(pairs)] for name, argv in (
        ("finetune", finetune), ("average3", tracked_command(CLI_POSEAVG_RUN)),
        ("icp", finetune + ["--use_finetune", "false", "--use_icp", "true"]))}


def _rooted(argv) -> list:
    """argv with the --resume paths (relative to the repo's root in the
    tracked commands) made absolute."""
    argv = list(argv)
    for i, tok in enumerate(argv[:-1]):
        if tok == "--resume" and not Path(argv[i + 1]).is_absolute():
            argv[i + 1] = str(ROOT / argv[i + 1])
    return argv


def _on(dev, argv) -> list:
    """argv for `dev`: the commands run on the card by default; on the CPU
    they are given --device cpu."""
    return list(argv) + (["--device", "cpu"] if dev.type == "cpu" else [])


def run_cli(dev, what, main, argv, want, want_bf16=None):
    """main(argv) of a command as a main-path run: every launch count set to
    0 just before, read just after and, on the card, held to `want` (K1/K2
    counts; the others 0) and the bf16-form counts to `want_bf16` (none if
    None). Returns (main's result, launches)."""
    counted = kernels()
    reset_counts(counted)
    result = main(_on(dev, argv))
    launches, launches_lp = read_counts(counted)
    expected = dict.fromkeys(COUNTED, 0) | want
    expected_lp = dict.fromkeys(LP_COUNTED, 0) | (want_bf16 or {})
    if dev.type == "cuda" and (launches != expected or launches_lp != expected_lp):
        raise AssertionError(f"cli {what}: launches {launches}, bf16 form {launches_lp}, "
                             f"expected {expected}, {expected_lp}")
    return result, launches


def _eval_launches(pairs: int, icp: bool = False) -> dict:
    """K1 and K2 launches of an align test run of `pairs` pairs at B=1: the
    eval step 16 + 5 per pair and once for the warm-up; ICP 30 per pair."""
    return {"knn_topk": 16 * (pairs + 1) + ICP_LAUNCHES * pairs * icp,
            "match_argmin": 5 * (pairs + 1)}


@contextmanager
def captured_eval_steps():
    """`cli.test`'s eval steps keep each call's AlignOutput and source
    mask (device tensors, read after the run: no sync inside the sweep's
    clock). The first call is the sweep's warm-up."""
    from unittest import mock
    from deepsir_tpu_torch.cli import test as cli_test
    calls, make = [], cli_test.make_eval_step

    def capturing(model, cfg, **kw):
        step = make(model, cfg, **kw)

        def run(arrays):
            transforms, out = step(arrays)
            calls.append((out, arrays.get("mask_src")))
            return transforms, out
        run.device = step.device
        return run

    with mock.patch.object(cli_test, "make_eval_step", capturing):
        yield calls


@contextmanager
def timed_prefetch(module):
    """The module's device_prefetch timed at its consumer: the seconds the
    command waited for each batch (the first includes the loader's start)."""
    from unittest import mock
    waits = []
    real = module.device_prefetch

    def timed(*args, **kw):
        it = real(*args, **kw)
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    return
                waits.append(time.perf_counter() - t0)
                yield item
        finally:
            it.close()

    with mock.patch.object(module, "device_prefetch", timed):
        yield waits


def _port_model_cfg(argv):
    from deepsir_tpu_torch.config import config_from_args, eval_argument_parser
    return config_from_args(eval_argument_parser().parse_args(argv)).model


def _held_outputs(torch, calls, cfg, want_idx):
    """(held iterations per pair, the forward's transforms (iters, B, 3, 4),
    the source clouds' radius per pair) of the captured eval steps after
    the warm-up, against JAX's matches want_idx (iters, B, N)."""
    held, transforms, radius = [], [], []
    for b, (out, mask) in enumerate(calls[1:]):
        cond = solve_conditioning(torch, out, out.pt_src, out.pt_ref, cfg, mask)
        held.append(held_iterations(out.pred_idx.cpu().numpy(), want_idx[:, b:b + 1],
                                    cond.cpu().numpy()))
        transforms.append(out.transforms.cpu().numpy())
        radius.append(float(out.pt_src.abs().max()))
    return np.concatenate(held), np.concatenate(transforms, axis=1), np.asarray(radius)


def _last_metrics(save_path: Path, iteration: int = N_ITERS + 1):
    """The per-pair metrics the test command wrote for `iteration` (1-based)."""
    return np.genfromtxt(save_path / f"metrics_iter_{iteration}.csv", delimiter=",",
                         names=True)


def _artifacts(save_path: Path) -> list:
    names = sorted(p.name for p in save_path.iterdir()
                   if not p.name.startswith("scores_") and p.name != "compareHead.diff")
    if names != CLI_ARTIFACTS:
        raise AssertionError(f"cli artifacts {names}, expected {CLI_ARTIFACTS}")
    return names


def _stats_record(save_path: Path, waits) -> dict:
    stats = np.load(save_path / "stats.npz")["stats"][0]
    return {"succ": float(stats[:, 0].mean()), "rte": float(stats[:, 1].mean()),
            "rre": float(stats[:, 2].mean()), "ms_per_pair": (stats[:, 3] * 1e3).tolist(),
            "ms_per_pair_median": float(np.median(stats[:, 3]) * 1e3),
            "loader_wait_ms": [w * 1e3 for w in waits],
            "loader_wait_ms_mean": float(np.mean(waits) * 1e3)}


def cli_eval(torch, dev, out_dir: Path, pairs: int = CLI_EVAL_PAIRS):
    """`cli.test` on the tracked staged eval command (its first `pairs`
    pairs) against JAX's test.py (tests/data/torch_parity_cli.npz):
    success flags equal on every pair whose forward held every iteration
    (held_iterations), held transforms within 1e-3, the other pairs counted;
    the artifacts of a tracked run. Returns (launches, record, with the
    tracked TPU run's means beside the port's, not gated)."""
    from deepsir_tpu_torch import evaluation
    from deepsir_tpu_torch.cli import test as cli_test
    fx = dict(np.load(CLI_FIXTURE))
    argv = _rooted(tracked_command(CLI_EVAL_RUN)) + [
        "--eval_save_path", str(out_dir), "--synthetic_eval_size", str(pairs)]
    with captured_eval_steps() as calls, timed_prefetch(evaluation) as waits:
        save_path, launches = run_cli(dev, "eval", cli_test.main, argv, _eval_launches(pairs))
    save_path = Path(save_path)
    held, transforms, _ = _held_outputs(torch, calls, _port_model_cfg(argv),
                                        fx["staged/pred_idx"][:, :pairs].astype(np.int64))
    err = np.abs(transforms - fx["staged/transforms"][:, :pairs]).max(axis=(2, 3))
    held_err = max((float(err[:n, b].max()) for b, n in enumerate(held) if n), default=0.0)
    succ = _last_metrics(save_path)["succ"]
    want = fx["staged/metrics/succ"][-1, :pairs]
    full = held == N_ITERS
    differ = np.flatnonzero(full & (succ != want))
    tpu = np.load(CLI_EVAL_RUN / "stats.npz")["stats"][0]
    record = {"pairs": pairs, "held_all_iterations": int(full.sum()),
              "not_held": np.flatnonzero(~full).tolist(), "held_transform_err": held_err,
              "succ_differs_on_held": differ.tolist(),
              "succ_differs_elsewhere": np.flatnonzero(~full & (succ != want)).tolist(),
              "jax_cpu_succ": float(want.mean()), "artifacts": _artifacts(save_path),
              **_stats_record(save_path, waits), "launches": launches,
              "tpu_run_not_gated": {"succ": float(tpu[:, 0].mean()),
                                    "rte": float(tpu[:, 1].mean()),
                                    "rre": float(tpu[:, 2].mean())}}
    log(f"cli test, staged eval command: {json.dumps({k: v for k, v in record.items() if not isinstance(v, list) or len(v) < 20})}")
    if len(differ) or held_err > 1e-3:
        raise AssertionError(f"cli eval: success differs on held pairs {differ.tolist()}, "
                             f"held transforms differ by {held_err}")
    return launches, record


def cli_refiners(torch, dev, out_dir: Path, pairs: int = CLI_REFINER_PAIRS):
    """`cli.test` on each refiner command (refiner_commands, `pairs`
    pairs) against JAX's: success flags equal on every pair, refined poses
    within EVAL_POSE_TOL by `pose_gap` on the pairs JAX registers whose
    forward held every iteration. Returns (launches, record)."""
    from deepsir_tpu_torch import evaluation
    from deepsir_tpu_torch.cli import test as cli_test
    fx = dict(np.load(CLI_FIXTURE))
    total = dict.fromkeys(COUNTED, 0)
    record = {}
    for name, argv in refiner_commands(pairs).items():
        argv = _rooted(argv) + ["--eval_save_path", str(out_dir / name)]
        with captured_eval_steps() as calls, timed_prefetch(evaluation) as waits:
            save_path, launches = run_cli(dev, name, cli_test.main, argv,
                                          _eval_launches(pairs, icp=name == "icp"))
        for key, value in launches.items():
            total[key] += value
        save_path = Path(save_path)
        held, _, radius = _held_outputs(torch, calls, _port_model_cfg(argv),
                                        fx["refiners/pred_idx"][:, :pairs].astype(np.int64))
        pred = np.load(save_path / "pred_transforms.npy")
        gap = pose_gap(pred[:, -1], fx[f"refiners/{name}/pose"][:pairs], radius)
        succ = _last_metrics(save_path)["succ"]
        want = fx[f"refiners/{name}/succ"][:pairs]
        ok = (held == N_ITERS) & (want > 0)
        rec = {"pairs": pairs, "held": ok.tolist(), "pose_gap": gap.tolist(),
               "held_pose_gap": float(gap[ok].max()) if ok.any() else 0.0,
               "succ": float(succ.mean()), "jax_succ": float(want.mean()),
               "artifacts": _artifacts(save_path), **_stats_record(save_path, waits),
               "launches": launches}
        record[name] = rec
        log(f"cli test, {name} command: {json.dumps(rec)}")
        if not np.array_equal(succ, want) or rec["held_pose_gap"] > EVAL_POSE_TOL:
            raise AssertionError(f"cli {name}: success {succ} (JAX {want}), {rec}")
    return total, record


def cli_transform_file(torch, dev, out_dir: Path, pairs: int = CLI_EVAL_PAIRS):
    """`cli.test`'s --transform_file mode on JAX's stored transforms of
    the staged eval command: every iteration's per-pair metrics against
    JAX's evaluate_align, success flags equal, the rest within
    EVAL_METRIC_TOL. Returns (launches, record)."""
    from deepsir_tpu_torch.cli import test as cli_test
    fx = dict(np.load(CLI_FIXTURE))
    path = out_dir / "jax_pred_transforms.npy"
    np.save(path, fx["staged/pred"][:pairs])
    argv = _rooted(tracked_command(CLI_EVAL_RUN)) + [
        "--transform_file", str(path), "--eval_save_path", str(out_dir / "transform_file"),
        "--synthetic_eval_size", str(pairs)]
    save_path, launches = run_cli(dev, "transform_file", cli_test.main, argv, {})
    record = {}
    for i in range(N_ITERS + 1):
        got = _last_metrics(Path(save_path), i + 1)
        want = {k: fx[f"staged/metrics/{k}"][i, :pairs] for k in ("succ", *EVAL_METRIC_TOL)}
        if not np.array_equal(got["succ"], want["succ"]):
            raise AssertionError(f"cli transform_file: iteration {i + 1} success differs")
        for key, tol in EVAL_METRIC_TOL.items():
            err = float(np.abs(got[key] - want[key]).max())
            record[f"{key}_err"] = max(record.get(f"{key}_err", 0.0), err)
            if err > tol:
                raise AssertionError(f"cli transform_file: iteration {i + 1} {key} {err}")
    record.update(pairs=pairs, succ=float(got["succ"].mean()))
    log(f"cli test --transform_file on JAX's transforms: {json.dumps(record)}")
    return launches, record


def _timed_steps():
    """`cli.train`'s train_step with a device fence after each call, the
    list its milliseconds go to, and the first step's inputs (a copy of the
    model before it, the run configs and the batch)."""
    from unittest import mock
    from deepsir_tpu_torch.cli import train as cli_train
    import torch
    times, first, real = [], {}, cli_train.train_step

    def timed(*args, **kw):
        if not first:
            model, _, cfgs, arrays = args[:4]
            first.update(model=copy.deepcopy(model), cfgs=cfgs, arrays=arrays)
        t0 = time.perf_counter()
        aux = real(*args, **kw)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        return aux
    return mock.patch.object(cli_train, "train_step", timed), times, first


def _train_run(torch, dev, what, argv, want):
    """One train command as a main-path run: (run directory, record: ms per
    step, the command's Timer mean, loader wait per batch, peak memory,
    launches). After the run, outside its counts, the first step's batch
    from the model as it was before that step, with the kernels against
    their plain versions (align: `_step_against_plain`; label and feat:
    `stage_against_plain`)."""
    from deepsir_tpu_torch.cli import train as cli_train
    patch, times, first = _timed_steps()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with patch, timed_prefetch(cli_train) as waits:
        run, launches = run_cli(dev, what, cli_train.main, argv, want)
    run = Path(run)
    timer = [line for line in (run / "log.txt").read_text().splitlines()
             if "Training complete" in line][-1]
    scalars = [json.loads(line) for line in (run / "train" / "scalars.jsonl").read_text()
               .splitlines()] if (run / "train" / "scalars.jsonl").exists() else []
    rec = {"ms_per_step": times, "timer": timer.split("(")[-1].rstrip(")"),
           "loader_wait_ms": [w * 1e3 for w in waits],
           "loader_wait_ms_mean": float(np.mean(waits) * 1e3),
           "val_score": [s["value"] for s in scalars if s["tag"] == "val_score"],
           "checkpoints": (run / "ckpt" / "checkpoints.txt").read_text().splitlines(),
           "launches": launches}
    if dev.type == "cuda":
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    if not (run / "ckpt" / "model_best.msgpack").exists() or \
            not all(np.isfinite(rec["val_score"])):
        raise AssertionError(f"cli train {what}: {rec}")
    model, cfgs, arrays = first["model"], first["cfgs"], first["arrays"]
    rec["vs_plain"] = (
        _step_against_plain(torch, model, cfgs, arrays, dev, seed=4, require_held=False)
        if model.pipeline == "align" else stage_against_plain(torch, model, cfgs, arrays, dev))
    log(f"cli train, {what}: {json.dumps(rec)}")
    return run, rec


STAGE_TRAIN_PAIRS = 16            # the label and feat train commands' pairs: 2 steps of 8
VAL_BATCHES = 8                   # the synthetic val split, 64 pairs in batches of 8


def cli_train(torch, dev, out_dir: Path):
    """`cli.train` on the staged align train command (one epoch of 32
    pairs: 4 steps of B=8, one validation, the checkpoint ring), `cli.test`
    resuming the checkpoint it wrote on CLI_RESUME_PAIRS pairs, and
    the label and feat train commands one epoch of STAGE_TRAIN_PAIRS pairs
    each (validation: mIoU, the feat loss). Returns (launches, record)."""
    from deepsir_tpu_torch.cli import test as cli_test
    total = dict.fromkeys(COUNTED, 0)
    record = {}

    def add(launches):
        for key, value in launches.items():
            total[key] += value

    steps = 32 // 8
    argv = _rooted(tracked_command(CKPT_RUN)) + [
        "--logdir", str(out_dir / "align"), "--max_epochs", "1", "--synthetic_train_size", "32",
        "-v", "-1"]
    run, record["align"] = _train_run(torch, dev, "align", argv, {
        "knn_topk": 16 * (steps + VAL_BATCHES), "match_argmin": 2 * steps + 5 * VAL_BATCHES})
    add(record["align"]["launches"])
    if record["align"]["checkpoints"] != [f"model_{steps}.msgpack", f"Best step: {steps}"]:
        raise AssertionError(f"cli train align: checkpoints {record['align']['checkpoints']}")

    argv = _rooted(tracked_command(CLI_EVAL_RUN)) + [
        "--resume", str(run / "ckpt" / "model_best.msgpack"), "--eval_save_path",
        str(out_dir / "resumed"), "--synthetic_eval_size", str(CLI_RESUME_PAIRS)]
    save_path, launches = run_cli(dev, "resumed", cli_test.main, argv,
                                  _eval_launches(CLI_RESUME_PAIRS))
    add(launches)
    pred = np.load(Path(save_path) / "pred_transforms.npy")
    if pred.shape != (CLI_RESUME_PAIRS, N_ITERS + 1, 3, 4) or not np.isfinite(pred).all():
        raise AssertionError(f"cli test resuming the trained checkpoint: {pred.shape}")
    record["resumed"] = {"pairs": CLI_RESUME_PAIRS, "launches": launches,
                         "succ": float(_last_metrics(Path(save_path))["succ"].mean())}

    for pipeline in ("label", "feat"):
        steps = STAGE_TRAIN_PAIRS // 8
        argv = _rooted(tracked_command(STAGE_RUNS[pipeline])) + [
            "--logdir", str(out_dir / pipeline), "--max_epochs", "1",
            "--synthetic_train_size", str(STAGE_TRAIN_PAIRS), "-v", "-1"]
        _, record[pipeline] = _train_run(torch, dev, pipeline, argv,
                                         {"knn_topk": 16 * (steps + VAL_BATCHES)})
        add(record[pipeline]["launches"])
    return total, record


FULL_WIDTH_TEST = ["--pipeline", "align", "--dataset_type", "Synthetic", "--num_points",
                   str(N_POINTS), "--feat_len", str(FEAT_LEN), "--synthetic_eval_size", "4"]
FULL_WIDTH_TRAIN = ["--pipeline", "align", "--dataset_type", "Synthetic", "--num_points",
                    str(N_POINTS), "--feat_len", str(FEAT_LEN), "-bs", "1",
                    "--synthetic_train_size", "4", "--max_epochs", "1", "-v", "0"]


def cli_full_width(torch, dev, out_dir: Path):
    """The commands at full width with seeded weights: `cli.test` on 4
    pairs, without and with ICP, and the train command 4 steps of B=1.
    Returns (launches, record: ms per pair and per step, loader wait per
    batch, peak memory)."""
    from deepsir_tpu_torch import evaluation
    from deepsir_tpu_torch.cli import test as cli_test
    total = dict.fromkeys(COUNTED, 0)
    record = {}
    for name, extra in (("test", []), ("test_icp", ["--use_icp", "true"])):
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        with timed_prefetch(evaluation) as waits:
            save_path, launches = run_cli(
                dev, name, cli_test.main,
                FULL_WIDTH_TEST + extra + ["--eval_save_path", str(out_dir / name)],
                _eval_launches(4, icp=bool(extra)))
        pred = np.load(Path(save_path) / "pred_transforms.npy")
        if pred.shape != (4, N_ITERS + 1, 3, 4) or not np.isfinite(pred).all():
            raise AssertionError(f"cli full width {name}: {pred.shape}")
        record[name] = {**_stats_record(Path(save_path), waits), "launches": launches}
        if dev.type == "cuda":
            record[name]["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"cli full width {name}: {json.dumps(record[name])}")
        for key, value in launches.items():
            total[key] += value
    _, record["train"] = _train_run(torch, dev, "full width", FULL_WIDTH_TRAIN + [
        "--logdir", str(out_dir / "train")], {"knn_topk": 16 * 4, "match_argmin": 2 * 4})
    for key, value in record["train"]["launches"].items():
        total[key] += value
    return total, record


def cli_commands(dev, out_dir: Path) -> dict:
    """Each command once as a module (`python -m`) in a process of its own:
    the test command --dev (4 pairs, 1024 points, seeded weights) and the
    label train command --dev for one step. Returns their wall seconds."""
    out = {}
    for name, argv in (
            ("test", ["--dev", "--pipeline", "align", "--dataset_type", "Synthetic",
                      "--eval_save_path", str(out_dir / "test")]),
            ("train", ["--dev", "--pipeline", "label", "--dataset_type", "Synthetic",
                       "--logdir", str(out_dir / "train"), "--max_epochs", "1", "-bs", "8",
                       "--synthetic_train_size", "8", "-v", "0"])):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", f"deepsir_tpu_torch.cli.{name}",
                              *_on(dev, argv)], cwd=ROOT, capture_output=True, text=True,
                             timeout=600)
        if res.returncode != 0:
            raise AssertionError(f"python -m deepsir_tpu_torch.cli.{name}: rc "
                                 f"{res.returncode}\n{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
        out[name] = time.perf_counter() - t0
    if not (out_dir / "test" / "random_init" / "pred_transforms.npy").exists() or \
            not list((out_dir / "train").glob("logdev/ckpt/model_best.msgpack")):
        raise AssertionError("cli commands: missing outputs")
    log(f"cli commands (python -m): {json.dumps(out)}")
    return out


def check_cli(torch, dev, smi: str):
    """The "cli" phase: cli_eval, cli_refiners, cli_transform_file,
    cli_train, cli_full_width and cli_commands. Returns (main-path
    launches, the phase's record, with the card's name and power limit)."""
    import tempfile
    total = dict.fromkeys(COUNTED, 0)
    record = {"device": smi}
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = Path(tmp)
        for part, fn in (("eval", cli_eval), ("refiners", cli_refiners),
                         ("transform_file", cli_transform_file), ("train", cli_train),
                         ("full_width", cli_full_width)):
            (out_dir / part).mkdir()
            t0 = time.perf_counter()
            launches, record[part] = fn(torch, dev, out_dir / part)
            record[part + "_s"] = time.perf_counter() - t0
            for key, value in launches.items():
                total[key] += value
        (out_dir / "commands").mkdir()
        record["commands_s"] = cli_commands(dev, out_dir / "commands")
    return total, record


def check_eval(torch, dev, smi: str):
    """The "eval" phase: eval_refiners, eval_parity, eval_sweeps and
    eval_full_width. Returns (main-path launches, the phase's record, with
    the card's name and power limit)."""
    import tempfile
    total = dict.fromkeys(COUNTED, 0)
    record = {"device": smi, "refiners_on_jax_inputs": eval_refiners(torch, dev)}
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = Path(tmp)
        for part, fn in (("parity", eval_parity), ("sweeps", eval_sweeps),
                         ("full_width", eval_full_width)):
            (out_dir / part).mkdir()
            launches, record[part] = fn(torch, dev, out_dir / part)
            for key, value in launches.items():
                total[key] += value
    return total, record


# ---------------------------------------------------------------- precision

PRECISION_FIXTURE = ROOT / "tests" / "data" / "torch_parity_precision.npz"
# the staged align checkpoint under each option set, with the run whose JAX
# outputs give its fp32 gap (tests/data/make_torch_parity_fixture.py)
PRECISION_RUNS = {"B16": (BF16, "F32"), "B16F": (dict(FLAGSHIP, **BF16), "F"),
                  "I16": (dict(inlier_compute_dtype="bfloat16"), "F32"), "F32": ({}, None)}
# the discriminating rule's k (tests/test_torch_precision.py): a layer or a
# 2-level net 1/4; the checkpoint's 4 levels spread bf16 rounding flips
# from the last bits of fp32 sums, 3/4 (ROADMAP.md Queue 3)
SHALLOW_K, DEEP_K = 0.25, 0.75
# registered pairs' final poses against JAX's (CPU, card): B16F 0.053,
# 0.017; I16 1.4e-3, 2.7e-3 (JAX's own inlier-bf16 and fp32 poses of those
# pairs are 1.2e-3 to 2.2e-3 apart)
REGISTERED_POSE_TOL = {"B16": 0.1, "B16F": 0.1, "I16": 1e-2}


def discriminating(what, got, want, want_fp32, k) -> dict:
    """The discriminating rule: median |got - want| <= k * median |want -
    want_fp32| (the bf16 reference against its fp32 twin), the gap real.
    Returns both medians."""
    got, want, want_fp32 = (np.asarray(a, np.float64) for a in (got, want, want_fp32))
    err = float(np.median(np.abs(got - want)))
    gap = float(np.median(np.abs(want - want_fp32)))
    if not gap > 0 or err > k * gap:
        raise AssertionError(f"precision {what}: median error {err} against JAX's bf16-fp32 "
                             f"gap {gap} (k = {k})")
    return {"median_err": err, "median_gap": gap, "k": k}


def _precision_model(cfg, state, extra_rows, dev):
    """Network(cfg) with the staged checkpoint's `state`, its inlier input
    layer widened by `extra_rows` for the dist and recip channels."""
    import torch
    from deepsir_tpu_torch.utils.params import load_network
    sd = dict(state)
    if "dist" in cfg.inlier_extra_feats:
        key = "inlier_model.mlp_pre.dense.weight"
        sd[key] = torch.cat([sd[key], torch.from_numpy(extra_rows).T], dim=1)
    return load_network(cfg, sd, device=dev)


def precision_parity(torch, dev):
    """The staged align checkpoint on the checkpoint fixture's 8 pairs at
    1024 points under bf16 compute (B16; B16F on the fixture's widened
    inlier layer), a bf16 inlier net (I16) and fp32, against JAX's outputs
    in tests/data/torch_parity_precision.npz (JAX over exact pyramids, its
    bf16 search through the matcher hook): descriptors, iteration-1 inlier
    logits and the share of differing iteration-1 matches by the
    discriminating rule at DEEP_K; success flags and `invalid` equal;
    transforms within 1e-3 up to each pair's first differing or
    ill-conditioned iteration, registered pairs' final poses within
    REGISTERED_POSE_TOL. I16: descriptors and iteration-1 matches equal to
    the fp32 run's bit for bit, its logits at SHALLOW_K; its matches equal
    JAX's for whole iterations while its bf16 inlier weights move the poses
    (5e-3 on the card within such iterations), so only REGISTERED_POSE_TOL
    holds its transforms. Each run launches
    K1 16 and K2 or K3 5 per batch, in the bf16 form exactly under bf16
    compute. Returns (launches, bf16-form launches, record)."""
    from deepsir_tpu_torch.config import from_run_config, read_run_config, replace
    from deepsir_tpu_torch.math import se3
    from deepsir_tpu_torch.models.network import ForwardOptions, Network
    from deepsir_tpu_torch.training import device_batch
    from deepsir_tpu_torch.utils.checkpoint import read_params
    from deepsir_tpu_torch.utils.params import from_jax_params
    fx = dict(np.load(PRECISION_FIXTURE))
    arrays = checkpoint_arrays(dict(np.load(CKPT_FIXTURE)), 1024)
    base = from_run_config(CKPT_RUN)
    state = from_jax_params(read_params(CKPT_RUN / "ckpt"), Network(base))
    evaluation = read_run_config(CKPT_RUN).eval
    gt = torch.from_numpy(arrays["transform_gt"]).to(dev)
    counted = kernels()
    total, total_lp = dict.fromkeys(COUNTED, 0), dict.fromkeys(LP_COUNTED, 0)
    runs = {}
    for name, (options, _) in PRECISION_RUNS.items():
        cfg = replace(base, **options)
        model = _precision_model(cfg, state, fx["extra_rows"], dev)
        reset_counts(counted)
        batch = device_batch(cfg, arrays, device=dev)
        out = model.forward_align(batch, ForwardOptions(num_iter=cfg.num_reg_iter,
                                                        clip_weight=True))
        launches, launches_lp = read_counts(counted)
        if dev.type == "cuda" and (launches != expected_launches(cfg)
                                   or launches_lp != expected_bf16_launches(cfg)):
            raise AssertionError(f"precision {name}: launches {launches}, bf16 form "
                                 f"{launches_lp}")
        for key in COUNTED:
            total[key] += launches[key]
        for key in LP_COUNTED:
            total_lp[key] += launches_lp[key]
        if name == "B16":             # JAX ran over exact pyramids: so must the port
            for side in ("src", "ref"):
                _exact_pyramid_agrees(torch, side, getattr(batch, f"pyramid_{side}"),
                                      cfg.sub_sampling_ratio)
        rre, rte = (e.cpu().numpy() for e in se3.pose_error(gt, out.transforms[-1]))
        runs[name] = {"out": out, "cfg": cfg, "launches": launches,
                      "desc": _iteration1_descriptors(torch, model, batch),
                      "succ": (rte < evaluation.rte_thresh) & (rre < evaluation.rre_thresh),
                      "cond": solve_conditioning(torch, out, out.pt_src, out.pt_ref, cfg,
                                                 batch.mask_src).cpu().numpy()}
    stride = int(fx["desc_row_stride"])
    record = {}
    for name in ("B16", "B16F", "I16"):
        run, fp32 = runs[name], PRECISION_RUNS[name][1]
        out = run["out"]
        pred = out.pred_idx.cpu().numpy()
        want = fx[f"{name}/pred_idx"].astype(np.int64)
        rec = {"launches": run["launches"]}
        if name == "I16":
            own = runs["F32"]
            if not all(torch.equal(a, b) for a, b in zip(run["desc"], own["desc"])) or \
                    not torch.equal(out.pred_idx[0], own["out"].pred_idx[0]):
                raise AssertionError("precision I16: descriptors or iteration-1 matches "
                                     "differ from the fp32 run's")
            rec["logits1"] = discriminating("I16 logits", out.inlier_logits[0].cpu().numpy(),
                                            fx["I16/logits1"], fx["F32/logits1"], SHALLOW_K)
        else:
            for side, d in zip(("src", "ref"), run["desc"]):
                rec[f"desc_{side}"] = discriminating(
                    f"{name} {side} descriptors", d.cpu().numpy()[:, ::stride],
                    fx[f"B16/desc_{side}"], fx[f"F32/desc_{side}"], DEEP_K)
            rec["logits1"] = discriminating(f"{name} logits", out.inlier_logits[0].cpu().numpy(),
                                            fx[f"{name}/logits1"], fx[f"{fp32}/logits1"], DEEP_K)
            share = float((pred[0] != want[0]).mean())
            gap = float((want[0] != fx[f"{fp32}/pred_idx"][0].astype(np.int64)).mean())
            rec["iteration1_differ"] = {"share": share, "gap": gap}
            if share > DEEP_K * gap:
                raise AssertionError(f"precision {name}: {share} of iteration-1 matches "
                                     f"differ, JAX's bf16-fp32 gap {gap}")
        if not np.array_equal(run["succ"], fx[f"{name}/succ"]) or \
                not np.array_equal(out.invalid.cpu().numpy(), fx[f"{name}/invalid"]):
            raise AssertionError(f"precision {name}: success {run['succ'].tolist()} or "
                                 f"invalid differ from JAX's")
        held = held_iterations(pred, want, run["cond"])
        err = np.abs(out.transforms.cpu().numpy() - fx[f"{name}/transforms"]).max(axis=(2, 3))
        held_err = max((float(err[:n, b].max()) for b, n in enumerate(held) if n), default=0.0)
        final = float(err[-1, run["succ"]].max())
        rec.update(held_iterations=held.tolist(), held_transform_err=held_err,
                   registered_final_err=final, success=run["succ"].tolist())
        if (held_err > 1e-3 and name != "I16") or final > REGISTERED_POSE_TOL[name]:
            raise AssertionError(f"precision {name}: transforms {rec}")
        record[name] = rec
        log(f"precision {name}, 1024 points, 8 pairs against JAX: {json.dumps(rec)}")
    return total, total_lp, record


def precision_step_parity(torch, dev):
    """One align step of the staged checkpoint resumed with its Adam state,
    both compute dtypes bf16, on the train fixture's 2 pairs at 1024 points
    against JAX's bf16 step: the total loss and the share of differing
    iteration-1 matches by the discriminating rule at DEEP_K (against JAX's
    fp32 step), applied, params and Adam moments fp32. Returns the record."""
    from deepsir_tpu_torch.config import replace
    from deepsir_tpu_torch.models.network import Network
    from deepsir_tpu_torch.training import make_optimizer, train_step
    from deepsir_tpu_torch.utils.checkpoint import load_train_state
    fx = dict(np.load(PRECISION_FIXTURE))
    tfx, arrays, cfgs, *_ = parity_training(dev)
    cfgs = cfgs._replace(model=replace(cfgs.model, compute_dtype="bfloat16",
                                       inlier_compute_dtype="bfloat16"))
    model = Network(cfgs.model).to(dev)
    opt = make_optimizer(model)
    load_train_state(CKPT_RUN / "ckpt", model, opt)
    out = train_step(model, opt, cfgs, arrays, torch.Generator(device=dev).manual_seed(0),
                     int(tfx["steps_per_epoch"]))
    loss, want, want32 = (float(v) for v in (out["loss"], fx["step_bf16/loss"],
                                             fx["step_f32/loss"]))
    pred = out["pred_idx"].cpu().numpy()
    w16, w32 = (fx[f"step_{p}/pred_idx"].astype(np.int64) for p in ("bf16", "f32"))
    rec = {"loss": loss, "jax_bf16_loss": want, "jax_fp32_loss": want32,
           "iteration1_differ": float((pred[0] != w16[0]).mean()),
           "jax_iteration1_gap": float((w16[0] != w32[0]).mean()), "skipped": out["skipped"]}
    dtypes = {p.dtype for p in model.parameters()} | {
        v.dtype for st in opt.state.values() for k, v in st.items() if k != "step"}
    if out["skipped"] or abs(loss - want) > DEEP_K * abs(want - want32) or \
            rec["iteration1_differ"] > DEEP_K * rec["jax_iteration1_gap"] or \
            dtypes != {torch.float32}:
        raise AssertionError(f"precision step: {rec}, dtypes {dtypes}")
    log(f"precision step (bf16, 1024 points, 2 pairs) against JAX: {json.dumps(rec)}")
    return rec


def precision_against_plain(torch, dev, name: str):
    """A bf16 path (B16 or B16F) at full width, seeded weights, B=1, with
    the kernels and again with every kernel swapped for its plain version:
    pyramids equal; iteration-1 matches equal but for near ties of the bf16
    form's distance; transforms within 1e-3 up to each pair's first
    iteration whose matches differ; `invalid` equal. Returns the record."""
    from deepsir_tpu_torch.models.network import ForwardOptions
    from deepsir_tpu_torch.training import device_batch
    from deepsir_tpu_torch.utils.params import init_params, load_network
    cfg = path_config(name)
    model = load_network(cfg, init_params(cfg, seed=0), device=dev)
    arrays = make_arrays(np.random.default_rng(5), 1, feat_len=cfg.feat_len)
    opts = ForwardOptions(num_iter=cfg.num_reg_iter, clip_weight=True)
    batch = device_batch(cfg, arrays, device=dev)
    out = model.forward_align(batch, opts)
    with plain_kernels():
        pbatch = device_batch(cfg, arrays, device=dev)
        plain = model.forward_align(pbatch, opts)
    for side in ("src", "ref"):
        for field in ("neigh_idx", "interp_idx"):
            for a, b in zip(getattr(getattr(batch, f"pyramid_{side}"), field),
                            getattr(getattr(pbatch, f"pyramid_{side}"), field)):
                if not torch.equal(a, b):
                    raise AssertionError(f"precision {name}: {side} {field} differs")
    gap = _search_near_ties(torch, *_iteration1_descriptors(torch, model, batch),
                            out.pred_idx[0], plain.pred_idx[0], low_precision=True)
    pred, ppred = out.pred_idx.cpu().numpy(), plain.pred_idx.cpu().numpy()
    held = held_iterations(pred, ppred, np.ones(pred.shape[:2]))
    err = np.abs(out.transforms.cpu().numpy() - plain.transforms.cpu().numpy()).max(axis=(2, 3))
    held_err = max((float(err[:n, b].max()) for b, n in enumerate(held) if n), default=0.0)
    rec = {"iteration1_gap": gap, "held_iterations": held.tolist(),
           "held_transform_err": held_err, "rows_differ": (pred != ppred).sum(-1).tolist()}
    if held_err > 1e-3 or not torch.equal(out.invalid, plain.invalid):
        raise AssertionError(f"precision {name} against plain: {rec}")
    log(f"precision {name} at {N_POINTS} points against plain: {json.dumps(rec)}")
    return rec


def precision_steps_against_plain(torch, dev):
    """One full-width training step against the plain kernels each: align
    with both compute dtypes bf16 (`_step_against_plain`, its iteration-1
    rule in the bf16 form's distance; loss 1e-4, grads 1e-3 while held) and
    label on point-pair features (`stage_against_plain`: forward and loss
    1e-4, grads 1e-3), seeded weights, B=1. Returns the records."""
    from deepsir_tpu_torch.config import LossConfig, ModelConfig, RunConfig, TrainConfig
    from deepsir_tpu_torch.models.network import Network
    from deepsir_tpu_torch.utils.params import init_params
    cfg = ModelConfig(feat_len=FEAT_LEN, num_points=N_POINTS, compute_dtype="bfloat16",
                      inlier_compute_dtype="bfloat16")
    cfgs = RunConfig(cfg, LossConfig(thres_radius=TRAIN_THRES_RADIUS), TrainConfig())
    model = Network(cfg)
    model.load_state_dict(init_params(cfg, seed=0))
    model.to(dev)
    rng = np.random.default_rng(6)
    align = _step_against_plain(torch, model, cfgs, train_arrays(rng, 1), dev, seed=4,
                                require_held=False)
    cfgs = stage_config("label", N_POINTS, **PPF)
    model = Network(cfgs.model, "label")
    model.load_state_dict(init_params(cfgs.model, seed=0, pipeline="label"))
    model.to(dev)
    arrays = make_arrays(rng, 1, feat_len=PPF["feat_len"], normals=True)
    for side in ("src", "ref"):
        arrays[f"labels_{side}"] = rng.integers(0, 20, size=(1, N_POINTS)).astype(np.int32)
    label = stage_against_plain(torch, model, cfgs, arrays, dev)
    if label["pyramid_near_ties"]:
        raise AssertionError(f"precision: the PPF label step's pyramids differ: {label}")
    log(f"precision steps at {N_POINTS} points against plain: align bf16 {json.dumps(align)}; "
        f"label PPF {json.dumps(label)}")
    return {"align_bf16": align, "label_ppf": label}


def precision_cli(torch, dev, out_dir: Path):
    """The test command with --compute_dtype bfloat16 on 4 full-width pairs
    (seeded weights): K1 16 and K2 5 per pair and the warm-up, every K2 in
    the bf16 form. Returns (launches, bf16-form launches, record)."""
    from deepsir_tpu_torch import evaluation
    from deepsir_tpu_torch.cli import test as cli_test
    want = _eval_launches(4)
    with timed_prefetch(evaluation) as waits:
        save_path, launches = run_cli(
            dev, "test bf16", cli_test.main,
            FULL_WIDTH_TEST + ["--compute_dtype", "bfloat16", "--eval_save_path",
                               str(out_dir / "test_bf16")],
            want, want_bf16={"match_argmin": want["match_argmin"]})
    pred = np.load(Path(save_path) / "pred_transforms.npy")
    if pred.shape != (4, N_ITERS + 1, 3, 4) or not np.isfinite(pred).all():
        raise AssertionError(f"precision cli: {pred.shape}")
    config = json.loads((Path(save_path) / "config.json").read_text())
    if config["model"]["compute_dtype"] != "bfloat16":
        raise AssertionError("precision cli: the run's config.json lost compute_dtype")
    record = {**_stats_record(Path(save_path), waits), "launches": launches}
    log(f"precision cli test --compute_dtype bfloat16: {json.dumps(record)}")
    lp = {k: 0 for k in LP_COUNTED} | {"match_argmin": launches["match_argmin"]}
    return launches, lp, record


def check_precision(torch, dev, smi: str):
    """The "precision" phase: precision_parity, precision_step_parity,
    precision_against_plain on B16 and B16F, precision_steps_against_plain
    and precision_cli. Returns (main-path launches, their bf16-form ones,
    the phase's record, with the card's name and power limit)."""
    import tempfile
    total, total_lp, record = precision_parity(torch, dev)
    record = {"device": smi, "parity_1024": record,
              "step_1024": precision_step_parity(torch, dev),
              "against_plain": {name: precision_against_plain(torch, dev, name)
                                for name in ("B16", "B16F")},
              "steps_against_plain": precision_steps_against_plain(torch, dev)}
    with tempfile.TemporaryDirectory() as tmp:
        launches, launches_lp, record["cli"] = precision_cli(torch, dev, Path(tmp))
    for key in COUNTED:
        total[key] += launches[key]
    for key in LP_COUNTED:
        total_lp[key] += launches_lp[key]
    return total, total_lp, record


PARALLEL_PAIRS = 2                # the train step's batch: the checkpoint fixture's first pairs
PARALLEL_SHARDS = (2, 4)          # the ring's ranks, walked in one process
PARALLEL_TILES = 4                # the duplicate case: 4 copies of a quarter of the rows
PARALLEL_REPS = 8                 # timed runs of each step, in turns
PARALLEL_EVAL = ("default", "F+gate")   # PATHS' options, on the staged checkpoint


@contextmanager
def process_group(dev):
    """A process group of this one process through
    `parallel.distributed.initialize_from_env` (NCCL on the card, gloo on
    the CPU), the DEEPSIR_* variables set while it starts; destroyed at the
    end. Yields the backend's name."""
    import os
    import socket
    import torch.distributed as dist
    from deepsir_tpu_torch.parallel.distributed import initialize_from_env
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = {"DEEPSIR_COORDINATOR": f"localhost:{port}", "DEEPSIR_NUM_PROCESSES": "1",
           "DEEPSIR_PROCESS_ID": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        started = initialize_from_env(dev.type)
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key)
            else:
                os.environ[key] = value
    if not started:
        raise AssertionError("parallel: initialize_from_env started no process group")
    try:
        yield str(dist.get_backend())
    finally:
        dist.destroy_process_group()


def ring_walks(torch, src, ref, shards: int):
    """The ring search of `src` over `ref` split into `shards` slices, as
    the ranks of a model axis walk it, in one process: rank r meets slice
    (r - k) % shards at hop k, searches it with `parallel.matching._local_min`
    (K2 on the card) and merges with `_merge`. Returns each rank's result
    (shards x shards K2 launches)."""
    from deepsir_tpu_torch.parallel.matching import _local_min, _merge
    m_local = ref.shape[1] // shards
    slices = [ref[:, k * m_local:(k + 1) * m_local].contiguous() for k in range(shards)]
    out = []
    for me in range(shards):
        best_d = torch.full(src.shape[:-1], float("inf"), device=src.device)
        best_i = torch.zeros(src.shape[:-1], dtype=torch.int64, device=src.device)
        for k in range(shards):
            owner = (me - k) % shards
            d, idx = _local_min(src, slices[owner])
            best_d, best_i = _merge(best_d, best_i, d, idx, owner, m_local)
        out.append(best_i)
    return out


def ring_parity(torch, dev, gen, n: int = N_POINTS, c: int = 64):
    """The ring's arithmetic over 2 and 4 slices of n x n unit descriptors
    (C = c, B = 1): every rank's result the same, and equal to K2 over the
    whole reference but for near ties (`_search_near_ties`); on a reference
    of PARALLEL_TILES copies of its first quarter, every rank's result equal
    to K2 over that quarter (exact ties to the lowest global index). On the
    card each walk is timed against K2 over the whole reference. Returns
    (launches of the checked walks, record)."""
    from deepsir_tpu_torch.ops.distance import nearest_neighbour_index
    src, ref = (_unit_descriptors(torch, gen, dev, 1, n, c) for _ in range(2))
    base = _unit_descriptors(torch, gen, dev, 1, n // PARALLEL_TILES, c)
    tiled = base.repeat(1, PARALLEL_TILES, 1)
    whole, want_tiled = nearest_neighbour_index(src, ref), nearest_neighbour_index(src, base)
    counted = kernels()
    reset_counts(counted)
    walks = {d: (ring_walks(torch, src, ref, d), ring_walks(torch, src, tiled, d))
             for d in PARALLEL_SHARDS}
    launches, _ = read_counts(counted)
    want = dict.fromkeys(COUNTED, 0) | {"match_argmin": 2 * sum(d * d for d in PARALLEL_SHARDS)}
    if dev.type == "cuda" and launches != want:
        raise AssertionError(f"parallel ring: launches {launches}, expected {want}")
    record = {}
    for d, (plain, dup) in walks.items():
        for what, results in (("random", plain), ("tiled", dup)):
            if not all(torch.equal(r, results[0]) for r in results[1:]):
                raise AssertionError(f"parallel ring d={d} {what}: the ranks disagree")
        if not torch.equal(dup[0], want_tiled):
            raise AssertionError(f"parallel ring d={d}: duplicates not to the lowest index")
        rec = {"near_ties": _search_near_ties(torch, src, ref, plain[0], whole)}
        if dev.type == "cuda":
            ring_ms = cuda_ms(lambda: ring_walks(torch, src, ref, d), TIMED_REPS) / d
            rec.update(ms_per_rank=ring_ms, k2_whole_ms=cuda_ms(
                lambda: nearest_neighbour_index(src, ref), TIMED_REPS))
        record[f"d{d}"] = rec
    log(f"parallel ring at {n} x {n} x {c}: {json.dumps(record)}")
    return launches, record


def _timed_turns(torch, first, second, reps: int):
    """Host-clock ms of each of two calls, each ending in a synchronize, in
    turns (first, second, second, first, ...); returns the two medians."""
    times = ([], [])
    for rep in range(reps):
        order = (0, 1) if rep % 2 == 0 else (1, 0)
        for i in order:
            t0 = time.perf_counter()
            (first, second)[i]()
            torch.cuda.synchronize()
            times[i].append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times[0])), float(np.median(times[1]))


def parallel_steps(torch, dev, mesh, n: int = N_POINTS, pairs: int = PARALLEL_PAIRS):
    """The staged align checkpoint at n points (its run config, dropout 0.5
    from seeded generators) through the sharded steps of `mesh`, a mesh
    without a model axis, against the plain steps on the whole batch on
    each rank's card: `make_sharded_train_step` (the state resumed with its
    Adam moments, `replicate_state`, B = `pairs`, the checkpoint fixture's
    pairs in turn) against `training.train_step`: this rank's matches equal
    in every iteration, loss terms within 1e-4 relative, grads within 1e-3
    of each leaf's scale, the params after the step within 1e-6;
    `make_sharded_eval_step` (B = the data axis's size, each PARALLEL_EVAL
    setting) against `make_eval_step` pair by pair (one pair on each rank):
    pred_idx equal, transforms within 1e-6, `invalid` equal. On the card
    each pair of steps is also timed in turns, the plain eval step on the
    whole batch. Returns (launches of the sharded steps, record)."""
    from deepsir_tpu_torch.config import read_run_config, replace
    from deepsir_tpu_torch.models.network import Network
    from deepsir_tpu_torch.parallel import (make_sharded_eval_step, make_sharded_train_step,
                                            replicate_state, shard_batch)
    from deepsir_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS
    from deepsir_tpu_torch.training import make_eval_step, make_optimizer, train_step
    from deepsir_tpu_torch.utils.checkpoint import load_train_state, read_params
    from deepsir_tpu_torch.utils.params import from_jax_params, trainable_parameters
    cuda = dev.type == "cuda"
    cfgs = read_run_config(CKPT_RUN)
    cfgs = cfgs._replace(model=replace(cfgs.model, num_points=n))
    if mesh.shape[MODEL_AXIS] != 1:
        raise ValueError(f"parallel_steps: mesh {dict(mesh.shape)} has a model axis")
    arrays = {k: v[np.arange(pairs) % len(v)]
              for k, v in checkpoint_arrays(dict(np.load(CKPT_FIXTURE)), n).items()}

    def resumed():
        model = Network(cfgs.model).to(dev)
        opt = make_optimizer(model)
        load_train_state(CKPT_RUN / "ckpt", model, opt)
        return model, opt
    (model, opt), (ref_model, ref_opt) = resumed(), resumed()
    replicate_state(mesh, model, opt)
    sharded_train = make_sharded_train_step(mesh)
    counted = kernels()
    total = dict.fromkeys(COUNTED, 0)
    reset_counts(counted)
    got = sharded_train(model, opt, cfgs, shard_batch(mesh, arrays),
                        torch.Generator(dev).manual_seed(2), STAGE_STEPS_PER_EPOCH)
    launches, _ = read_counts(counted)
    if cuda and tuple(launches.values()) != TRAIN_CASES["default"][1]:
        raise AssertionError(f"parallel train step: launches {launches}")
    for key in COUNTED:
        total[key] += launches[key]
    want = train_step(ref_model, ref_opt, cfgs, arrays, torch.Generator(dev).manual_seed(2),
                      STAGE_STEPS_PER_EPOCH)
    want_idx = shard_batch(mesh, {"idx": want["pred_idx"].transpose(0, 1)})["idx"]
    if got["skipped"] or want["skipped"] or not torch.equal(got["pred_idx"],
                                                            want_idx.transpose(0, 1)):
        raise AssertionError("parallel train step: skipped, or matches differ from the plain "
                             "step's")
    terms = {k: abs(float(v) - float(want["losses"][k])) / abs(float(want["losses"][k]))
             for k, v in got["losses"].items()}
    terms["total"] = abs(float(got["loss"]) - float(want["loss"])) / abs(float(want["loss"]))
    if max(terms.values()) > 1e-4:
        raise AssertionError(f"parallel train step: loss terms {terms}")
    grad_err = _grads_agree(got["grads"], want["grads"], 1e-3)
    param_err = max(float((a - b).detach().abs().max()) for (_, a), (_, b)
                    in zip(trainable_parameters(model), trainable_parameters(ref_model)))
    if param_err > 1e-6:
        raise AssertionError(f"parallel train step: params after the step {param_err} apart")
    record = {"train": {"term_rel_err": max(terms.values()), "grad_rel_err": grad_err,
                        "param_err": param_err, "launches": launches}}
    if cuda:
        sharded_ms, plain_ms = _timed_turns(
            torch, lambda: sharded_train(model, opt, cfgs, shard_batch(mesh, arrays),
                                         torch.Generator(dev).manual_seed(3),
                                         STAGE_STEPS_PER_EPOCH),
            lambda: train_step(ref_model, ref_opt, cfgs, arrays,
                               torch.Generator(dev).manual_seed(3), STAGE_STEPS_PER_EPOCH),
            PARALLEL_REPS)
        record["train"].update(sharded_ms=sharded_ms, plain_ms=plain_ms)

    state = from_jax_params(read_params(CKPT_RUN / "ckpt"), Network(cfgs.model))
    extra_rows = dict(np.load(PRECISION_FIXTURE))["extra_rows"]
    eval_batch = {k: v[:mesh.shape[DATA_AXIS]] for k, v in arrays.items()}
    for name in PARALLEL_EVAL:
        options, _, per_step, _ = PATHS[name]
        cfg = replace(cfgs.model, **options)
        net = _precision_model(cfg, state, extra_rows, dev)
        sharded_eval, plain_eval = make_sharded_eval_step(net, cfg, mesh), make_eval_step(net, cfg)
        reset_counts(counted)
        _, out = sharded_eval(shard_batch(mesh, eval_batch))
        launches, _ = read_counts(counted)
        if cuda and tuple(launches.values()) != per_step:
            raise AssertionError(f"parallel eval {name}: launches {launches}")
        for key in COUNTED:
            total[key] += launches[key]
        # the plain step pair by pair, as each rank holds one: the same products
        singles = [plain_eval({k: v[i:i + 1] for k, v in eval_batch.items()})[1]
                   for i in range(mesh.shape[DATA_AXIS])]
        err = float((out.transforms - torch.cat([o.transforms for o in singles], 1)).abs().max())
        rows_differ = int((out.pred_idx != torch.cat([o.pred_idx for o in singles], 1)).sum())
        if (rows_differ or err > 1e-6
                or not torch.equal(out.invalid, torch.cat([o.invalid for o in singles]))):
            raise AssertionError(f"parallel eval {name}: differs from make_eval_step "
                                 f"(transforms {err}, {rows_differ} matches)")
        record[f"eval {name}"] = {"transform_err": err, "launches": launches}
        if cuda:
            sharded_ms, plain_ms = _timed_turns(
                torch, lambda: sharded_eval(shard_batch(mesh, eval_batch)),
                lambda: plain_eval(eval_batch), PARALLEL_REPS)
            record[f"eval {name}"].update(sharded_ms=sharded_ms, plain_ms=plain_ms)
    log(f"parallel steps at {n} points: {json.dumps(record)}")
    return total, record


def check_parallel(torch, dev, smi: str, n: int = N_POINTS, pairs: int = PARALLEL_PAIRS):
    """The "parallel" phase: a one-process group (NCCL on the card), its
    (1, 1) mesh, `parallel_steps` and `ring_parity`. Returns (launches of
    the sharded steps and the checked ring walks, the phase's record, with
    the card's name and power limit)."""
    from deepsir_tpu_torch.parallel import make_mesh
    with process_group(dev) as backend:
        mesh = make_mesh()
        total, steps = parallel_steps(torch, dev, mesh, n, pairs)
    launches, ring = ring_parity(torch, dev, torch.Generator().manual_seed(7), n)
    for key in COUNTED:
        total[key] += launches[key]
    return total, {"device": smi, "backend": backend, "mesh": dict(mesh.shape), **steps,
                   "ring": ring}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is false; nothing was run")
        return 1
    import deepsir_tpu_torch  # noqa: F401  (sets the fp32 precision flags)
    from deepsir_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    with phase("device"):
        kind = torch.cuda.get_device_name(0)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
        smi = smi.splitlines()[0]
        log(f"device {kind}; nvidia-smi: {smi}; torch {torch.__version__}, "
            f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    with phase("build"):
        t0 = time.perf_counter()
        reports = _build.build_all(KERNEL_SOURCES)
        for name, rep in reports.items():
            log(f"--- ptxas {name}\n{rep.strip()}")
        log(f"built {sorted(reports) or 'nothing (cached)'} in {time.perf_counter() - t0:.3f} s")
    gen = torch.Generator().manual_seed(0)
    with phase("K1 knn_topk vs plain"):
        k1 = check_knn(torch, dev, gen)
    with phase("K2 match_argmin vs plain"):
        k2 = check_match(torch, dev, gen)
    with phase("K3 match_argmin_bidirectional vs plain"):
        k3 = check_bidir(torch, dev, gen)
    with phase("K4 knn_topk_windowed vs plain"):
        k4 = check_windowed(torch, dev, gen)
    total, total_lp = dict.fromkeys(COUNTED, 0), dict.fromkeys(LP_COUNTED, 0)
    paths, models = [], {}
    for name, batch in RUNS:
        with phase(f"path {name} B={batch}"):
            launches, launches_lp, record = drive_path(torch, dev, name, batch, models)
            paths.append(record)
            for key, n in launches.items():
                total[key] += n
            for key, n in launches_lp.items():
                total_lp[key] += n
    models.clear()
    for path in FIXTURES:
        with phase(f"JAX fixture parity {path.name}"):
            check_fixture(torch, dev, path)
    with phase("checkpoint"):
        launches, ckpt = check_checkpoint(torch, dev)
        for key, n in launches.items():
            total[key] += n
    with phase("train"):
        launches, train = check_train(torch, dev)
        for key, n in launches.items():
            total[key] += n
    stages = {}
    for pipeline in ("label", "feat"):
        with phase(pipeline):
            launches, stages[pipeline] = check_stage(torch, dev, pipeline)
            for key, n in launches.items():
                total[key] += n
    with phase("stages"):
        stages["chain"] = check_stages(torch, dev)
    with phase("eval"):
        launches, evaluation = check_eval(torch, dev, smi)
        for key, n in launches.items():
            total[key] += n
    with phase("cli"):
        launches, cli = check_cli(torch, dev, smi)
        for key, n in launches.items():
            total[key] += n
    with phase("precision"):
        launches, launches_lp, precision = check_precision(torch, dev, smi)
        for key, n in launches.items():
            total[key] += n
        for key, n in launches_lp.items():
            total_lp[key] += n
    with phase("parallel"):
        launches, parallel = check_parallel(torch, dev, smi)
        for key, n in launches.items():
            total[key] += n
    log(json.dumps({"paths": paths}))
    log(json.dumps({"checkpoint": ckpt}))
    log(json.dumps({"train": train}))
    log(json.dumps({"stages": stages}))
    log(json.dumps({"eval": evaluation}))
    log(json.dumps({"cli": cli}))
    log(json.dumps({"precision": precision}))
    log(json.dumps({"parallel": parallel}))
    for entry, key in zip((k1, k4, k2, k3), COUNTED):
        entry["launches"] = total[key]
    for entry, key in zip((k2, k3), LP_COUNTED):
        entry["forms"]["bf16"]["launches"] = total_lp[key]
        entry["forms"]["fp32x3"]["launches"] = total[key] - total_lp[key]
    log(json.dumps({"kernels": [k1, k2, k3, k4]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
