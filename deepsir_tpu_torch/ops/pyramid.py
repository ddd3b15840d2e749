"""The RandLA-Net index pyramid, built on the device (deepsir_tpu/ops/pyramid.py).

Random subsampling keeps the reference's contract: the first N/r points of a
cloud in randomized order are a uniform random sample ("first" sampling).
For curve-sorted clouds (ops/morton.py) every r-th point is the uniform
sample and keeps the curve order ("strided" sampling), so the searches of
every level may be restricted to curve-rank windows (`window_halo`).
Levels are separate tensors with a leading batch dim.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from deepsir_tpu_torch.ops.knn import knn
from deepsir_tpu_torch.utils.profiling import span


class Pyramid(NamedTuple):
    """Per-level index structure for a batch of clouds.

    With L encoder layers and level sizes [N0, N1, ..., NL]:
      xyz[l]:        (B, Nl, 3)      points at level l,   l in 0..L-1
      neigh_idx[l]:  (B, Nl, K)      KNN within level l
      pool_idx[l]:   (B, N{l+1}, K)  neighbourhoods pooled into level l+1
      interp_idx[l]: (B, Nl)         nearest level-(l+1) point of each point
    Indices are int64.
    """
    xyz: Tuple[torch.Tensor, ...]
    neigh_idx: Tuple[torch.Tensor, ...]
    pool_idx: Tuple[torch.Tensor, ...]
    interp_idx: Tuple[torch.Tensor, ...]


def build_pyramid(xyz: torch.Tensor, num_knn: int = 16,
                  ratios: Tuple[int, ...] = (4, 4, 4, 4),
                  sample: str = "first", window_halo: int = 0) -> Pyramid:
    """Build the index pyramid for a batch of clouds (B, N, 3).

    Per level: one num_knn self-search and one 1-NN search from the level's
    points into the next level's points, both passed `window_halo`
    (ops/knn.py). sample is "first" (shuffled clouds) or "strided"
    (curve-sorted clouds).
    """
    if sample not in ("first", "strided"):
        raise NotImplementedError(f"build_pyramid sample={sample!r}")
    xyzs, neighs, pools, interps = [], [], [], []
    pc = xyz.contiguous()
    for r in ratios:
        n_next = pc.shape[-2] // r
        neigh, _ = knn(pc, pc, num_knn, window_halo)        # (B, Nl, K)
        step = r if sample == "strided" else 1
        sub = pc[:, ::step][:, :n_next].contiguous()
        up, _ = knn(pc, sub, 1, window_halo)                # (B, Nl, 1)
        xyzs.append(pc)
        neighs.append(neigh)
        pools.append(neigh[:, ::step][:, :n_next])
        interps.append(up[..., 0])
        pc = sub
    return Pyramid(tuple(xyzs), tuple(neighs), tuple(pools), tuple(interps))


def build_cloud_pyramid(cfg, xyz: torch.Tensor) -> Pyramid:
    """build_pyramid over clouds (B, N, 3) in the point order of `cfg` (a
    ModelConfig): "strided" with the window halo under
    `pyramid_order="morton"`, "first" with no window otherwise."""
    morton = cfg.pyramid_order == "morton"
    with span("deepsir.pyramid"):
        return build_pyramid(xyz, cfg.num_knn, cfg.sub_sampling_ratio,
                             sample="strided" if morton else "first",
                             window_halo=cfg.knn_window_halo if morton else 0)


def slice_neighbours(pyr: Pyramid, k: int) -> Pyramid:
    """Truncate every neighbour list to its k nearest entries (lists are
    ascending). k <= 0 or k >= K returns `pyr` unchanged."""
    if k <= 0 or k >= pyr.neigh_idx[0].shape[-1]:
        return pyr
    return pyr._replace(
        neigh_idx=tuple(n[..., :k] for n in pyr.neigh_idx),
        pool_idx=tuple(p[..., :k] for p in pyr.pool_idx))


def concat_pyramids(a: Pyramid, b: Pyramid) -> Pyramid:
    """Stack two pyramids along the batch dim."""
    return Pyramid(*(tuple(torch.cat([x, y], dim=0) for x, y in zip(fa, fb))
                     for fa, fb in zip(a, b)))
