"""Smoke run of the PyTorch/CUDA port (deepsir_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ with nvcc, holds each kernel
against its plain PyTorch version at the shapes of the align forward, drives
the align inference forward (`device_batch` -> `Network.forward_align`) at
full width (18000 points, 5 iterations) at batch 1 and 2 with seeded random
weights, and holds the port against the JAX package's outputs stored in
tests/data/torch_parity_small.npz. Imports neither JAX nor the JAX package.

Output: one line per phase with its wall time; then a JSON line
{"kernels": [...]}, the card's name and power limit as nvidia-smi reports
them, and last {"ok": true, "device": {...}}. Any failure raises: the exit
code is not 0 and the last line is not printed. Needs one CUDA card.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "tests" / "data" / "torch_parity_small.npz"

N_POINTS = 18000          # bench.py's protocol
N_ITERS = 5
FEAT_LEN = 4
TIMED_REPS = 3

# published H100 SXM peaks (NVIDIA data sheet, dense, 700 W)
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


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


def bound_ms(flops: float, nbytes: float):
    """(least time in ms, what bounds it) at the published peaks."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def make_arrays(rng, batch: int):
    """Random pair clouds as bench.py's make_arrays makes them (bench.py:116-133)."""
    n = N_POINTS
    xyz = rng.normal(size=(batch, n, 3)).astype(np.float32) * 10.0
    extra = rng.uniform(size=(batch, n, 1)).astype(np.float32)
    pts = np.concatenate([xyz, extra], axis=-1)
    xyz2 = rng.normal(size=(batch, n, 3)).astype(np.float32) * 10.0
    pts2 = np.concatenate(
        [xyz2, rng.uniform(size=(batch, n, 1)).astype(np.float32)], axis=-1)
    return {"points_src": pts, "points_ref": pts2,
            "transform_gt": np.tile(np.eye(3, 4, dtype=np.float32), (batch, 1, 1))}


def _knn_agree(torch, name, got, want):
    """K1 and its plain version must give equal indices and equal distances."""
    (idx, dist), (pidx, pdist) = got, want
    torch.cuda.synchronize()
    n_bad = int((idx != pidx).sum())
    err = float((dist - pdist).abs().max())
    if n_bad or err != 0.0:
        raise AssertionError(f"K1 {name}: {n_bad} indices differ, max dist diff {err}")
    return n_bad, err


def check_knn(torch, dev, gen):
    """K1 against knn_topk_plain on the card; returns the kernels-line entry."""
    from deepsir_tpu_torch.ops.cuda_knn import knn_topk, knn_topk_plain
    n, sub = N_POINTS, N_POINTS // 4
    pts = torch.randn(2, n, 3, generator=gen).mul_(10.0).to(dev)
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

    cases = [("self k=16", pts[:1], pts[:1], 16),
             ("upsample k=1", pts[:1], pts[:1, :sub].contiguous(), 1),
             ("batched B=2 k=16", pts, pts, 16)]
    entry = None
    for name, q, r, k in cases:
        n_bad, err = _knn_agree(torch, name, knn_topk(q, r, k), knn_topk_plain(q, r, k))
        ms = cuda_ms(lambda: knn_topk(q, r, k), 5)
        plain_ms = cuda_ms(lambda: knn_topk_plain(q, r, k), 2)

        def library():
            for s in range(0, q.shape[1], 2048):
                torch.topk(torch.cdist(q[:, s:s + 2048], r), k, dim=-1, largest=False)
        library_ms = cuda_ms(library, 2)
        b, nq, d = q.shape
        m = r.shape[1]
        flops = (3.0 * d - 1) * b * nq * m            # d sub, d mul, d-1 add per pair
        nbytes = 4.0 * b * (nq + m) * d + 12.0 * b * nq * k
        bms, by = bound_ms(flops, nbytes)
        log(f"K1 {name}: q{tuple(q.shape)} r{tuple(r.shape)}: indices equal, "
            f"max dist diff 0; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"cdist+topk {library_ms:.4f} ms, bound {bms:.4f} ms ({by})")
        if entry is None:                             # level-0 self-search
            entry = {"name": "knn_topk (K1)", "route": "cuda",
                     "source": "deepsir_tpu_torch/csrc/knn_topk.cu",
                     "replaces": "deepsir_tpu/ops/pallas_knn.py:130",
                     "shape": f"query {tuple(q.shape)} x ref {tuple(r.shape)}, k={k}",
                     "max_abs_err": err, "index_mismatches": n_bad,
                     "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bms, "bound_by": by, "library_ms": library_ms}
    return entry


def _match_agree(torch, name, src, ref, idx, pidx):
    """K2 may differ from its plain version only on near ties: at most 0.1% of
    rows, each within 1e-5 relative of the plain minimum (float64 distances).
    Returns (rows that differ, max abs distance gap, max relative gap)."""
    torch.cuda.synchronize()
    s64, r64 = src.double(), ref.double()

    def dist(i):
        return ((s64 - torch.gather(r64, 1, i[..., None].expand(s64.shape))) ** 2).sum(-1)
    d_k, d_p = dist(idx), dist(pidx)
    differ = idx != pidx
    gap = (d_k - d_p).abs()
    rows = int(differ.sum())
    rel = float((gap / d_p.abs().clamp_min(1e-12))[differ].max()) if rows else 0.0
    if rel > 1e-5 or rows > 1e-3 * idx.numel():
        raise AssertionError(f"K2 {name}: {rows} of {idx.numel()} rows differ, worst "
                             f"relative distance gap {rel}")
    return rows, float(gap.max()), rel


def check_match(torch, dev, gen):
    """K2 against match_argmin_plain on the card; returns the kernels-line entry."""
    from deepsir_tpu_torch.ops.cuda_match import match_argmin, match_argmin_plain
    n, c = N_POINTS, 64
    src = torch.randn(1, n, c, generator=gen).to(dev)
    ref = torch.randn(1, n, c, generator=gen).to(dev)
    src = src / src.norm(dim=-1, keepdim=True)
    ref = ref / ref.norm(dim=-1, keepdim=True)

    def rand(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    # ragged sizes, other widths and planted exact ties, checked but not timed
    for name, s, r in [("C=100 B=2", rand(2, 1000, 100), rand(2, 777, 100)),
                       ("C=3", rand(1, 300, 3), rand(1, 5000, 3)),
                       ("M=1", rand(1, 65, 64), rand(1, 1, 64))]:
        _match_agree(torch, name, s, r, match_argmin(s, r), match_argmin_plain(s, r))
    base = rand(1, 300, 64)
    tied = match_argmin(base[:, :100].contiguous(), torch.cat([base, base.flip(1), base], 1))
    if not torch.equal(tied[0], torch.arange(100, device=dev)):
        raise AssertionError("K2: planted exact ties did not go to the lowest index")
    log("K2 agrees with its plain version at C in {3, 64, 100}, ragged N and M, "
        "M=1, and planted ties go to the lowest index")

    rows, err, rel = _match_agree(torch, "18000 x 18000", src, ref,
                                  match_argmin(src, ref), match_argmin_plain(src, ref))
    share = rows / n
    ms = cuda_ms(lambda: match_argmin(src, ref), 10)
    plain_ms = cuda_ms(lambda: match_argmin_plain(src, ref), 3)
    ref_sq = (ref[0] * ref[0]).sum(-1)

    def library():
        for s in range(0, n, 4096):
            torch.addmm(ref_sq, src[0, s:s + 4096], ref[0].T, alpha=-2.0).argmin(dim=-1)
    library_ms = cuda_ms(library, 3)
    bms, by = bound_ms(2.0 * n * n * c, 4.0 * 2 * n * c + 8.0 * n)
    log(f"K2 src{tuple(src.shape)} ref{tuple(ref.shape)}: {rows} rows differ "
        f"(near ties, worst relative gap {rel:.3g}); kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, addmm+argmin {library_ms:.4f} ms, bound {bms:.4f} ms ({by})")
    return {"name": "match_argmin (K2)", "route": "cuda",
            "source": "deepsir_tpu_torch/csrc/match_argmin.cu",
            "replaces": "deepsir_tpu/ops/pallas_match.py:215",
            "shape": f"src {tuple(src.shape)} x ref {tuple(ref.shape)}",
            "max_abs_err": err, "rows_differ": rows, "agree_share": 1.0 - share,
            "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": library_ms}


def drive_main_path(torch, dev, batch: int):
    """device_batch -> forward_align at full width; returns the launch counts."""
    from deepsir_tpu_torch.config import ModelConfig
    from deepsir_tpu_torch.models.network import ForwardOptions
    from deepsir_tpu_torch.ops.cuda_knn import knn_topk
    from deepsir_tpu_torch.ops.cuda_match import match_argmin
    from deepsir_tpu_torch.training import device_batch
    from deepsir_tpu_torch.utils.params import init_params, load_network

    cfg = ModelConfig(feat_len=FEAT_LEN, num_points=N_POINTS, num_reg_iter=N_ITERS)
    model = load_network(cfg, init_params(cfg, seed=0), device=dev)
    opts = ForwardOptions(num_iter=N_ITERS, clip_weight=True)
    rng = np.random.default_rng(0)

    def run(arrays):
        return model.forward_align(device_batch(cfg, arrays, device=dev), opts)

    arrays = make_arrays(rng, batch)
    knn_topk.launches = 0
    match_argmin.launches = 0
    out = run(arrays)
    torch.cuda.synchronize()
    launches = {"knn_topk": knn_topk.launches, "match_argmin": match_argmin.launches}
    want = {"knn_topk": 2 * 2 * len(cfg.d_out), "match_argmin": N_ITERS}
    if launches != want:
        raise AssertionError(f"B={batch}: launches {launches}, expected {want}")
    t = out.transforms
    if tuple(t.shape) != (N_ITERS, batch, 3, 4) or not bool(torch.isfinite(t).all()):
        raise AssertionError(f"B={batch}: transforms {tuple(t.shape)} not finite")
    rot = t[-1, :, :, :3]
    orth = float((rot @ rot.transpose(-1, -2) - torch.eye(3, device=dev)).abs().max())
    if orth > 1e-3:
        raise AssertionError(f"B={batch}: final rotation not orthonormal ({orth})")
    feeds = [make_arrays(rng, batch) for _ in range(TIMED_REPS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for arrays in feeds:
        run(arrays)
    torch.cuda.synchronize()
    per_pair = (time.perf_counter() - t0) / (TIMED_REPS * batch)
    log(f"main path B={batch}: {per_pair * 1e3:.3f} ms per pair ({1.0 / per_pair:.3f} "
        f"pairs/s), invalid={out.invalid.tolist()}, launches {launches}, "
        f"rotation orthonormality err {orth:.2e}")
    return launches


def check_fixture(torch, dev):
    """The port on the card against the JAX package's stored outputs."""
    from deepsir_tpu_torch.config import from_json
    from deepsir_tpu_torch.models.network import ForwardOptions, Network
    from deepsir_tpu_torch.training import device_batch
    from deepsir_tpu_torch.utils.params import (from_jax_params, load_network,
                                                unflatten_params)
    fx = dict(np.load(FIXTURE))
    cfg = from_json(str(fx["model_json"]))
    sd = from_jax_params(unflatten_params(fx), Network(cfg))
    model = load_network(cfg, sd, device=dev)
    arrays = {k: fx[k] for k in ("points_src", "points_ref", "transform_gt")}
    batch = device_batch(cfg, arrays, device=dev)
    for side, pyr in (("src", batch.pyramid_src), ("ref", batch.pyramid_ref)):
        for lvl in range(len(cfg.d_out)):
            for name, got in (("neigh_idx", pyr.neigh_idx[lvl]),
                              ("interp_idx", pyr.interp_idx[lvl])):
                if not np.array_equal(got.cpu().numpy(), fx[f"{side}_{name}_{lvl}"]):
                    raise AssertionError(f"fixture: {side} {name}[{lvl}] differs")
    out = model.forward_align(batch, ForwardOptions(num_iter=cfg.num_reg_iter,
                                                    clip_weight=True))
    agree = float((out.pred_idx[0].cpu().numpy() == fx["pred_idx"][0]).mean())
    terr = float(np.abs(out.transforms.cpu().numpy() - fx["transforms"]).max())
    if agree < 0.995 or terr > 1e-3:
        raise AssertionError(f"fixture: pred_idx agree {agree}, transform err {terr}")
    if not np.array_equal(out.invalid.cpu().numpy(), fx["invalid"]):
        raise AssertionError("fixture: invalid differs")
    log(f"fixture: pyramids equal, pred_idx iteration 1 agree {agree:.4f}, "
        f"max transform err {terr:.3g}")


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
        reports = _build.build_all(["knn_topk", "match_argmin"])
        for name, rep in reports.items():
            log(f"--- ptxas {name}\n{rep.strip()}")
        log(f"built {sorted(reports) or 'nothing (cached)'} in {time.perf_counter() - t0:.3f} s")
    gen = torch.Generator().manual_seed(0)
    with phase("K1 knn_topk vs plain"):
        k1 = check_knn(torch, dev, gen)
    with phase("K2 match_argmin vs plain"):
        k2 = check_match(torch, dev, gen)
    total = {"knn_topk": 0, "match_argmin": 0}
    for batch in (1, 2):
        with phase(f"main path B={batch}"):
            for key, n in drive_main_path(torch, dev, batch).items():
                total[key] += n
    k1["launches"] = total["knn_topk"]
    k2["launches"] = total["match_argmin"]
    with phase("JAX fixture parity"):
        check_fixture(torch, dev)
    log(json.dumps({"kernels": [k1, k2]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
