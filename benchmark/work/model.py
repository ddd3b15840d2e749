"""Model operations of one pair, counted from a configuration's shapes: what
`mfu_pct.*` divides by the time. Whatever implements the work later, the
count stays.

Counted: every Dense product, 2 x rows x in x out, of the backbone, the
aggregation heads and the inlier net (its LocSE branch, which the loop
caches, once; the rest once per iteration); every descriptor search, 2 N M
C; every KNN search of both pyramids, (3 D - 1) N M; in the feat loss, the
descriptor distance product 2 N N C and the point distances, 8 N N, in each
of the circle loss's two passes. A training step adds its backward at twice
the forward of the part the gradient passes through: the inlier net for the
align pipeline, the heads and the descriptor distance product for feat.
Elementwise work outside these (norms, activations, softmax, scores, the
3x3 solves) is not counted.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from benchmark.work import knn as knn_work

HEAD_FEAT = (64, 128, 64)            # mlp_feat's widths after its input
HEAD_ATT = (32, 64, 128, 256, 64)    # mlp_att's, from [xyz; score]
NUM_CLASSES = 19


def level_sizes(points: int, ratios) -> List[int]:
    sizes = [points]
    for r in ratios:
        sizes.append(sizes[-1] // r)
    return sizes


def dense(rows: int, c_in: int, c_out: int) -> float:
    return 2.0 * rows * c_in * c_out


def mlp(rows: int, c_in: int, widths) -> float:
    total = 0.0
    for w in widths:
        total += dense(rows, c_in, w)
        c_in = w
    return total


def randla(cfg: Dict, points: int, feat_len: int, num_classes: int) -> Tuple[float, float]:
    """(all Dense operations, those of the LocSE positional branch) of one
    RandLA pass over one cloud."""
    d, k = list(cfg["d_out"]), cfg["num_knn"]
    n = level_sizes(points, cfg["sub_sampling_ratio"])
    L = len(d)
    total = dense(n[0], feat_len, 8)
    locse = 0.0
    c_in = [8] + [2 * x for x in d[:-1]]
    for i in range(L):
        rows, nk, di, ci = n[i], n[i] * k, d[i], c_in[i]
        pos = dense(nk, 10, di // 2) + dense(nk, di // 2, di // 2)
        locse += pos
        total += (pos + dense(rows, ci, di // 2) + dense(nk, di, di) + dense(rows, di, di // 2)
                  + dense(nk, di, di) + dense(rows, di, di) + dense(rows, di, 2 * di)
                  + dense(rows, ci, 2 * di))
    total += dense(n[L], 2 * d[-1], 2 * d[-1])
    x_ch = 2 * d[-1]
    for j in range(L):
        lvl = L - j - 1
        out = 2 * d[max(L - j - 2, 0)]
        total += dense(n[lvl], 2 * d[lvl] + x_ch, out)
        x_ch = out
    c = cfg["out_feat_dim"]
    total += dense(n[0], x_ch, c) + mlp(n[0], c, (c, 32, num_classes))
    return total, locse


def _extras(cfg: Dict) -> int:
    return len([s for s in cfg["inlier_extra_feats"].split(",") if s.strip()])


def _pyramids(cfg: Dict, points: int) -> float:
    return sum(knn_work.work(*s)[0] for s in knn_work.pyramid_searches(
        points, cfg["num_knn"], cfg["sub_sampling_ratio"], 2))


def align_dense(cfg: Dict, points: int, num_iter: int) -> Tuple[float, float]:
    """(Dense operations of one pair through the align forward at `num_iter`
    iterations, those of the inlier net alone)."""
    c = cfg["out_feat_dim"]
    backbone, _ = randla(cfg, points, cfg["feat_len"], NUM_CLASSES)
    inlier, locse = randla(cfg, points, 6 + _extras(cfg), 1)
    heads_once = mlp(points, c, HEAD_FEAT) * 2 + mlp(points, 4, HEAD_ATT) + mlp(points, c, (c,))
    heads_iter = mlp(points, 4, HEAD_ATT) + mlp(points, c, (c,))
    inlier_fwd = locse + num_iter * (inlier - locse)
    return 2 * backbone + heads_once + num_iter * heads_iter + inlier_fwd, inlier_fwd


def align_pair(cfg: Dict, points: int, num_iter: int, train: bool = False) -> float:
    """Operations of one pair through the align forward (and, with `train`,
    its backward) at `num_iter` iterations."""
    dense_ops, inlier_fwd = align_dense(cfg, points, num_iter)
    search = 2.0 * points * points * cfg["out_feat_dim"]
    fwd = dense_ops + num_iter * search + _pyramids(cfg, points)
    return fwd + (2.0 * inlier_fwd if train else 0.0)


def feat_dense(cfg: Dict, points: int) -> Tuple[float, float]:
    """(Dense operations of one pair through the feat training forward,
    those of the heads alone)."""
    c = cfg["out_feat_dim"]
    backbone, _ = randla(cfg, points, cfg["feat_len"], NUM_CLASSES)
    heads = 2 * (mlp(points, c, HEAD_FEAT) + mlp(points, 4, HEAD_ATT) + mlp(points, c, (c,)))
    return 2 * backbone + heads, heads


def feat_train_pair(cfg: Dict, points: int) -> float:
    """Operations of one pair through the feat training step."""
    dense_ops, heads = feat_dense(cfg, points)
    product = 2.0 * points * points * cfg["out_feat_dim"]
    point_dist = 2 * 8.0 * points * points
    fwd = dense_ops + product + point_dist + _pyramids(cfg, points)
    return fwd + 2.0 * (heads + product)


def per_pair(cfg: Dict, forward: Dict, traffic: Dict) -> float:
    """Operations per pair of a cell's step."""
    points = traffic["points"]
    if traffic["pipeline"] == "feat":
        return feat_train_pair(cfg, points)
    if traffic["driver"] == "train":
        return align_pair(cfg, points, cfg["num_train_reg_iter"], train=True)
    return align_pair(cfg, points, forward["num_iter"])
