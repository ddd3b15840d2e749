"""The feat loss's circle-loss reductions: a fused CUDA kernel and its plain
PyTorch version.

`circle_rows` returns what losses/detdes.py's `circle_loss_tiled`
accumulates from the anchors' and positives' descriptors and points:
`lse_p`, `lse_n` (each anchor's logsumexp of the positive and negative
terms), `furthest`, `closest` (the detector's furthest positive and closest
negative descriptor distance), `has_pos` (any pair in radius), each
(B, N1), and `lse_neg_col` (B, N2), each positive's logsumexp of the
negative terms.

`csrc/circle_loss.cu` replaces no TPU kernel: the JAX package computes this
loss with plain XLA. Its forward computes the same rows without an (N1, N2)
tensor in device memory, summing in float64. Its backward (a
`torch.autograd.Function`) writes d loss / d sq of one column tile of the
plain version at a time (sq the squared descriptor distance, the tile as
`circle_rows_plain` clamps `tile`) and reduces it into both descriptor sets
with the fp32 products and sums autograd runs on the plain version: their
rounding moves the heads' gradients by ~3e-5 of themselves on the feat
step, and the training reference holds the step to the plain version's.
The kernel splits the detector's gradient evenly among a row's exact ties
where the plain version's `torch.maximum` of tiles halves it between tiles;
otherwise the two agree to float rounding. The kernel reads C <= 64
channels (fewer are zero-padded) and `log_scale * neg_margin^2` <= 60 (it
sums the negative terms shifted by that bound).
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from deepsir_tpu_torch.ops import _build
from deepsir_tpu_torch.ops.distance import square_distance

BIG = 1e5
EPS = 1e-12
TILE = 64                  # the kernel's block rows and sweep step (csrc/circle_loss.cu)
CHANNELS = 64              # the kernel's channels; fewer are zero-padded
MAX_SHIFT = 60.0           # exp(-shift) must stay a normal float32
BLOCKS_PER_SM = 16         # two resident a multiprocessor, about eight waves

Rows = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def dist_pc(anc_pc: torch.Tensor, pos_pc: torch.Tensor) -> torch.Tensor:
    """Point distances by direct difference, (..., N1, 3) x (..., N2, 3) -> (..., N1, N2)."""
    return torch.linalg.vector_norm(anc_pc[..., :, None, :] - pos_pc[..., None, :, :], dim=-1)


def dist_feat(anc_feat: torch.Tensor, pos_feat: torch.Tensor) -> torch.Tensor:
    """Descriptor distances by the norm expansion, with EPS under the root."""
    return torch.sqrt(torch.clamp_min(square_distance(anc_feat, pos_feat), 0.0) + EPS)


def largest_divisor(n: int, tile: int) -> int:
    t = max(1, min(tile, n))
    while n % t:
        t -= 1
    return t


def circle_rows_plain(anc_feat: torch.Tensor, pos_feat: torch.Tensor, anc_pc: torch.Tensor,
                      pos_pc: torch.Tensor, thres_radius: float, log_scale: float = 10.0,
                      pos_margin: float = 0.1, neg_margin: float = 1.4, tile: int = 1500) -> Rows:
    """`circle_rows` over column tiles of `tile` positives, clamped to the
    largest divisor of N2 (padded columns would still add exp(0) to the
    excluded entries). Two passes over the tiles: the row min of the zeroed
    point distances, which the positive mask needs whole; then the row
    logsumexps by `logaddexp`, the detector's row max and min and `any`, and
    each tile's column logsumexp."""
    t = largest_divisor(pos_feat.shape[-2], tile)
    tiles = list(zip(torch.split(pos_feat, t, dim=-2), torch.split(pos_pc, t, dim=-2)))

    with torch.no_grad():
        dist_min = torch.full(anc_feat.shape[:-1], float("inf"), device=anc_feat.device)
        for _, pc in tiles:
            d = dist_pc(anc_pc, pc)
            dist_min = torch.minimum(dist_min, torch.amin(d * (d < thres_radius), dim=-1))

    shape = anc_feat.shape[:-1]
    lse_p = torch.full(shape, -float("inf"), device=anc_feat.device)
    lse_n = torch.full(shape, -float("inf"), device=anc_feat.device)
    furthest = torch.full(shape, -float("inf"), device=anc_feat.device)
    closest = torch.full(shape, float("inf"), device=anc_feat.device)
    has_pos = torch.zeros(shape, dtype=torch.bool, device=anc_feat.device)
    cols = []
    for pf, pc in tiles:
        d_pc = dist_pc(anc_pc, pc)
        d_feat = dist_feat(anc_feat, pf)
        false_neg = d_pc < thres_radius
        pos_mask = d_pc == dist_min[..., None]
        neg_mask = ~(pos_mask | false_neg)

        pos = d_feat - BIG * neg_mask
        pos_w = torch.clamp_min(pos - pos_margin, 0.0).detach()
        lse_p = torch.logaddexp(lse_p, torch.logsumexp(
            log_scale * (pos - pos_margin) * pos_w, dim=-1))

        neg = d_feat + BIG * (~neg_mask)
        neg_w = torch.clamp_min(neg_margin - neg, 0.0).detach()
        neg_weighted = log_scale * (neg_margin - neg) * neg_w
        lse_n = torch.logaddexp(lse_n, torch.logsumexp(neg_weighted, dim=-1))
        cols.append(torch.logsumexp(neg_weighted, dim=-2))

        furthest = torch.maximum(furthest, torch.amax(d_feat * pos_mask, dim=-1))
        closest = torch.minimum(closest, torch.amin(d_feat + BIG * pos_mask, dim=-1))
        has_pos = has_pos | torch.any(false_neg, dim=-1)
    return lse_p, lse_n, furthest, closest, has_pos, torch.cat(cols, dim=-1)


def thres_sq(thres_radius: float) -> float:
    """The least float32 x >= 0 whose correctly rounded root reaches the
    float32 radius r: for x >= 0, x < thres_sq(r) exactly when sqrt(x) < r."""
    r = np.float32(thres_radius)
    if not r > 0:
        return 0.0
    zero, inf = np.float32(0.0), np.float32(np.inf)
    x = np.float32(r * r)
    while x > 0 and np.sqrt(np.nextafter(x, zero)) >= r:
        x = np.nextafter(x, zero)
    while np.sqrt(x) < r:
        x = np.nextafter(x, inf)
    return float(x)


def negative_shift(log_scale: float, neg_margin: float) -> float:
    """The largest negative term, log_scale * max(neg_margin, 0)^2 (0 if
    log_scale <= 0): the kernel sums exp(term - shift)."""
    return max(log_scale, 0.0) * max(neg_margin, 0.0) ** 2


def splits(own_tiles: int, other_tiles: int, sms: int) -> Tuple[int, int]:
    """(splits, column tiles a split) of a sweep over `other_tiles` tiles by
    `own_tiles` blocks of rows (batch included): enough blocks for
    BLOCKS_PER_SM on each of `sms` multiprocessors, no split empty."""
    want = max(1, min(other_tiles, math.ceil(BLOCKS_PER_SM * sms / max(1, own_tiles))))
    per = math.ceil(other_tiles / want)
    return math.ceil(other_tiles / per), per


_SMS = {}


def _sms(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SMS[index]


def _fn(name: str, pointers: int, ints: int, floats: int):
    fn = getattr(_build.load("circle_loss"), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * ints
                       + [ctypes.c_float] * floats + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _channels(x: torch.Tensor) -> torch.Tensor:
    """x (B, N, C) as the kernel reads it: CHANNELS channels, contiguous, 16-byte aligned."""
    if x.shape[-1] < CHANNELS:
        x = F.pad(x, (0, CHANNELS - x.shape[-1]))
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _dense(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


class _CircleRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, anc_feat, pos_feat, anc_pc, pos_pc, consts, width):
        b, n1, n2 = anc_feat.shape[0], anc_feat.shape[1], pos_feat.shape[1]
        a, p = _channels(anc_feat), _channels(pos_feat)
        # the squared norms as `dist_feat` sums them (ops.distance.square_distance)
        asq = torch.sum(anc_feat * anc_feat, dim=-1).contiguous()
        psq = torch.sum(pos_feat * pos_feat, dim=-1).contiguous()
        apc, ppc = _dense(anc_pc), _dense(pos_pc)
        dev = a.device
        f32 = dict(dtype=torch.float32, device=dev)
        own_tiles, other_tiles = -(-n1 // TILE), -(-n2 // TILE)
        n_split, per = splits(own_tiles * b, other_tiles, _sms(dev))
        aaux, paux = torch.empty((b, n1, 4), **f32), torch.empty((b, n2, 4), **f32)
        minx, flags = (torch.empty((b, n1), dtype=torch.int32, device=dev) for _ in range(2))
        rowf = torch.empty((5, n_split, b, n1), **f32)
        rowd = torch.empty((2, n_split, b, n1), dtype=torch.float64, device=dev)
        colpart = torch.empty((b, own_tiles, n2), **f32)
        lse_p, lse_n, fur, fur_n, clo, clo_n, dmin = (torch.empty((b, n1), **f32)
                                                      for _ in range(7))
        has = torch.empty((b, n1), dtype=torch.bool, device=dev)
        lse_col = torch.empty((b, n2), **f32)
        fn = _fn("circle_forward_launch", 22, 5, 5)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            status = fn(*(t.data_ptr() for t in (a, p, asq, psq, apc, ppc, aaux, paux, minx,
                                                 flags, rowf,
                                                 rowd, colpart, lse_p, lse_n, fur, fur_n, clo,
                                                 clo_n, dmin, has, lse_col)),
                        b, n1, n2, n_split, per, *consts, stream)
        _build.check(status, "circle_forward_launch")
        circle_rows.launches += 1
        ctx.save_for_backward(a, p, anc_feat, pos_feat, aaux, paux, dmin, lse_p, lse_n, fur,
                              fur_n, clo, clo_n, lse_col)
        ctx.consts, ctx.width = consts, width
        ctx.mark_non_differentiable(has)
        return lse_p, lse_n, fur, clo, has, lse_col

    @staticmethod
    def backward(ctx, g_p, g_n, g_f, g_c, _g_has, g_col):
        saved = ctx.saved_tensors
        a, p, anc_feat, pos_feat = saved[:4]
        b, n1, n2 = a.shape[0], a.shape[1], p.shape[1]
        f32 = dict(dtype=torch.float32, device=a.device)
        grads = [_dense(g.float()) for g in (g_p, g_n, g_f, g_c, g_col)]
        aside, pside = torch.empty((b, n1, 12), **f32), torch.empty((b, n2, 8), **f32)
        prep = _fn("circle_backward_prep", 17, 3, 2)
        tile_fn = _fn("circle_grad_tile", 7, 7, 5)
        width = ctx.width
        tiles, blocks = n2 // width, -(-width // TILE)
        ge = torch.empty((b, n1, width), **f32)
        rowpart = torch.empty((b, n1, tiles * blocks), **f32)
        colpart = torch.empty((b, -(-n1 // TILE), n2), **f32)
        # each tile's products, as autograd computes them for the plain version
        rows = torch.empty((tiles, b, n1, pos_feat.shape[2]), **f32)
        cols = torch.empty((tiles, b, pos_feat.shape[2], width), **f32)
        anc_t = anc_feat.transpose(1, 2)
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream().cuda_stream
            _build.check(prep(*(t.data_ptr() for t in (*saved[4:], *grads, aside, pside)),
                              b, n1, n2, ctx.consts[1], ctx.consts[4], stream),
                         "circle_backward_prep")
            for k in range(tiles):
                c0 = k * width
                _build.check(tile_fn(a.data_ptr(), p.data_ptr(), aside.data_ptr(),
                                     pside.data_ptr(), ge.data_ptr(), rowpart.data_ptr(),
                                     colpart.data_ptr(), b, n1, n2, c0, width, k * blocks,
                                     tiles * blocks, *ctx.consts, stream), "circle_grad_tile")
                torch.bmm(ge, pos_feat[:, c0:c0 + width], out=rows[k])
                torch.bmm(anc_t, ge, out=cols[k])
        # ge = -2 d loss / d sq: d anc = sum_j ge_ij p_j - anc_i sum_j ge_ij, and so for pos
        d_anc = torch.sum(rows, dim=0) - anc_feat * torch.sum(rowpart, dim=-1, keepdim=True)
        d_pos = (cols.permute(1, 0, 3, 2).reshape(pos_feat.shape)
                 - pos_feat * torch.sum(colpart, dim=1)[..., None])
        circle_rows.launches += 1
        return d_anc, d_pos, None, None, None, None


def circle_rows(anc_feat: torch.Tensor, pos_feat: torch.Tensor, anc_pc: torch.Tensor,
                pos_pc: torch.Tensor, thres_radius: float, log_scale: float = 10.0,
                pos_margin: float = 0.1, neg_margin: float = 1.4, tile: int = 1500) -> Rows:
    """(lse_p, lse_n, furthest, closest, has_pos (B, N1), lse_neg_col (B, N2))
    of anchors (B, N1, C) and positives (B, N2, C) with their points
    (B, N1/N2, 3), the positives' in the anchors' frame.

    CPU tensors take `circle_rows_plain`; CUDA tensors launch the kernel,
    differentiable in both descriptor sets, its backward reduced over the
    same column tiles of `tile` positives. One forward call counts one
    launch in `.launches`, its backward another, though each issues several
    device operations.
    """
    tensors = (anc_feat, pos_feat, anc_pc, pos_pc)
    if anc_feat.dim() != 3 or pos_feat.dim() != 3 or anc_pc.shape != anc_feat.shape[:2] + (3,) \
            or pos_pc.shape != pos_feat.shape[:2] + (3,) \
            or anc_feat.shape[0] != pos_feat.shape[0] or anc_feat.shape[2] != pos_feat.shape[2]:
        raise ValueError(f"shapes {[tuple(t.shape) for t in tensors]}")
    if all(t.device.type == "cpu" for t in tensors):
        return circle_rows_plain(anc_feat, pos_feat, anc_pc, pos_pc, thres_radius, log_scale,
                                 pos_margin, neg_margin, tile)
    if any(t.device != anc_feat.device for t in tensors) or anc_feat.device.type != "cuda":
        raise ValueError(f"devices {[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"dtypes {[t.dtype for t in tensors]}: float32 only")
    if not 1 <= anc_feat.shape[2] <= CHANNELS or anc_feat.shape[1] < 1 or pos_feat.shape[1] < 1:
        raise ValueError(f"circle_rows needs 1 <= C <= {CHANNELS} and non-empty clouds; "
                         f"got {[tuple(t.shape) for t in tensors]}")
    shift = negative_shift(log_scale, neg_margin)
    if shift > MAX_SHIFT:
        raise ValueError(f"circle_rows needs log_scale * neg_margin^2 <= {MAX_SHIFT}; "
                         f"got {shift}")
    consts = (thres_sq(thres_radius), float(log_scale), float(pos_margin), float(neg_margin),
              shift)
    return _CircleRows.apply(anc_feat, pos_feat, anc_pc, pos_pc, consts,
                             largest_divisor(pos_feat.shape[1], tile))


circle_rows.launches = 0
