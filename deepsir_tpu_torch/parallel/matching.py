"""Multi-card correspondence search: the reference cloud split over the
mesh's ``model`` axis (deepsir_tpu/parallel/matching.py).

Each rank of a model-axis row searches its slice of the reference rows and
keeps a running (distance, global index) per source row while the slices
rotate around the row: the registration analog of ring attention. Source
rows meet one reference slice at a time, so no rank holds the whole
N x M distance matrix.

Two strategies:
  * ``sharded_nearest_neighbour_index`` — each rank searches its slice,
    then one `all_gather` of the (d, N) distances and of the global
    indices, and a reduction. Simple; best when the axis is short.
  * ``ring_nearest_neighbour_index`` / ``make_ring_matcher`` — the slices
    rotate by `batch_isend_irecv` (send to the next rank of the row,
    receive from the one before, into a second buffer, while the current
    slice is searched); memory per rank stays O(N + M/d). Best for long
    axes. ``make_ring_matcher`` is the batched form behind
    `Network.matcher`.

Each slice's search is the port's `ops.distance.nearest_neighbour_index`
(kernel K2 on the card, always its fp32-grade form: the JAX ring ignores
`low_precision` and runs precision 'highest'), after which the winner's
distance is recomputed exactly as sum((src - ref[idx])**2) in fp32, so that
every rank compares the same numbers; ties go to the lowest global index,
`argmin`'s first-occurrence convention, and the result is the same on
every rank of the row. The inputs are the full clouds of this rank's rows
of the batch; each rank takes its slice of the reference itself. The
searches carry no gradient.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from deepsir_tpu_torch.ops.distance import nearest_neighbour_index
from deepsir_tpu_torch.ops.gather import gather_points
from deepsir_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh


def _local_min(src: torch.Tensor, ref_shard: torch.Tensor):
    """Each src row's nearest row of one reference slice: src (B, N, C),
    ref_shard (B, Ms, C) -> dist (B, N) fp32, idx (B, N) int64 local to the
    slice."""
    idx = nearest_neighbour_index(src, ref_shard)
    d = torch.sum((src - gather_points(ref_shard, idx)) ** 2, dim=-1)
    return d, idx


def _merge(best_d, best_i, d, idx, owner: int, m_local: int):
    """The running (distance, global index) after meeting slice `owner`:
    the smaller distance, on exact ties the lower global index."""
    gidx = idx + owner * m_local
    take = (d < best_d) | ((d == best_d) & (gidx < best_i))
    return torch.where(take, d, best_d), torch.where(take, gidx, best_i)


def _slice(feat_ref: torch.Tensor, mesh: Mesh, axis: str):
    """(this rank's slice of the reference rows, contiguous, possibly a view
    of feat_ref; the slice's rows)."""
    nshards = mesh.shape[axis]
    m_total = feat_ref.shape[-2]
    if m_total % nshards:
        raise ValueError(f"ref point count {m_total} must divide the '{axis}' axis "
                         f"({nshards} shards); pad the cloud to a multiple")
    m_local = m_total // nshards
    me = mesh.index(axis)
    return feat_ref[..., me * m_local:(me + 1) * m_local, :].contiguous(), m_local


def _exchange(send: torch.Tensor, recv: torch.Tensor, mesh: Mesh, axis: str):
    """Start sending `send` to the next rank of the axis and receiving the
    previous rank's into `recv`; returns the requests."""
    ranks, me = mesh.axis_ranks(axis), mesh.index(axis)
    group = mesh.axis_group(axis)
    ops = [dist.P2POp(dist.isend, send, ranks[(me + 1) % len(ranks)], group),
           dist.P2POp(dist.irecv, recv, ranks[(me - 1) % len(ranks)], group)]
    return dist.batch_isend_irecv(ops)


@torch.no_grad()
def _ring_argmin(src: torch.Tensor, feat_ref: torch.Tensor, mesh: Mesh, axis: str):
    """The ring reduction over the ranks of `axis`: src (B, N, C), feat_ref
    (B, M, C) -> global indices (B, N) int64, the same on every rank."""
    shard, m_local = _slice(feat_ref, mesh, axis)
    nshards, me = mesh.shape[axis], mesh.index(axis)
    best_d = torch.full(src.shape[:-1], float("inf"), dtype=torch.float32, device=src.device)
    best_i = torch.zeros(src.shape[:-1], dtype=torch.int64, device=src.device)
    spare = None
    if nshards > 1:
        # two buffers of our own take turns: a receive never lands in the
        # slice being searched, nor in the caller's memory (_slice's view)
        shard, spare = shard.clone(), torch.empty_like(shard)
    for k in range(nshards):
        reqs = _exchange(shard, spare, mesh, axis) if k < nshards - 1 else []
        d, idx = _local_min(src, shard)
        best_d, best_i = _merge(best_d, best_i, d, idx, (me - k) % nshards, m_local)
        for req in reqs:
            req.wait()
        shard, spare = spare, shard
    return best_i


def make_ring_matcher(mesh: Mesh, axis: str = MODEL_AXIS):
    """A batched matcher that splits the reference cloud over `axis`:
    matcher(feat_src (b, N, C), feat_ref (b, M, C)) -> (b, N) int64, a
    drop-in for ops.distance.nearest_neighbour_index behind
    `Network.matcher`. b is this rank's rows of the batch (its data-axis
    shard); M must divide the axis. The reverse search of the mutual gate
    calls it with the clouds swapped, which splits the source cloud."""
    def matcher(feat_src: torch.Tensor, feat_ref: torch.Tensor) -> torch.Tensor:
        return _ring_argmin(feat_src, feat_ref, mesh, axis)
    return matcher


def ring_nearest_neighbour_index(feat_src: torch.Tensor, feat_ref: torch.Tensor,
                                 mesh: Mesh, axis: str = MODEL_AXIS) -> torch.Tensor:
    """Ring combine: feat_src (N, C), feat_ref (M, C), the same on every
    rank of the axis -> global nearest indices (N,) int64."""
    return _ring_argmin(feat_src[None], feat_ref[None], mesh, axis)[0]


@torch.no_grad()
def sharded_nearest_neighbour_index(feat_src: torch.Tensor, feat_ref: torch.Tensor,
                                    mesh: Mesh, axis: str = MODEL_AXIS) -> torch.Tensor:
    """All-gather combine: feat_src (N, C), feat_ref (M, C), the same on
    every rank of the axis -> global nearest indices (N,) int64."""
    shard, m_local = _slice(feat_ref[None], mesh, axis)
    d, idx = _local_min(feat_src[None], shard)
    gidx = (idx + mesh.index(axis) * m_local)[0]
    nshards = mesh.shape[axis]
    if nshards == 1:
        return gidx
    group = mesh.axis_group(axis)
    d_all = [torch.empty_like(d[0]) for _ in range(nshards)]
    i_all = [torch.empty_like(gidx) for _ in range(nshards)]
    dist.all_gather(d_all, d[0], group=group)                     # (d, N) fp32
    dist.all_gather(i_all, gidx, group=group)                     # (d, N) int64
    win = torch.argmin(torch.stack(d_all), dim=0)                 # first: lowest shard
    return torch.gather(torch.stack(i_all), 0, win[None])[0]
