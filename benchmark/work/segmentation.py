"""Operations of one pair through a label training step of the published
RandLA-Net (`RandLANet.py::inference`, the port's `label_head="randla"`
with `randla_skips="post"`), counted from a configuration's shapes: what
`mfu_pct.label_train` divides by the time. Whatever implements the work
later, the count stays.

Counted: every Dense product, 2 x rows x in x out, of both clouds' forward
(fc0; in each block the two units on the points, the LocSE units and the
attentive poolings' score products on the neighbour rows, the poolings'
units, mlp2 and the shortcut; `decoder_0`; the decoder's stages, each to
its skip's width; fc1, fc2, fc), and twice that for the backward; every KNN
search of both pyramids, (3 D - 1) N M, once (the searches have no
backward). Elementwise work (norms, activations, softmax, gathers, max
pooling, the loss) is not counted.
"""
from __future__ import annotations

from typing import Dict

from benchmark.work import knn as knn_work
from benchmark.work.model import dense, level_sizes


def randla_net(cfg: Dict, points: int) -> float:
    """Dense operations of one forward of the published network over one cloud."""
    d, k = list(cfg["d_out"]), cfg["num_knn"]
    n = level_sizes(points, cfg["sub_sampling_ratio"])
    total = dense(n[0], cfg["feat_len"], 8)
    c_in = [8] + [2 * x for x in d[:-1]]
    for i, (di, ci) in enumerate(zip(d, c_in)):
        rows, nk = n[i], n[i] * k
        total += (dense(rows, ci, di // 2)                                  # mlp1
                  + dense(nk, 10, di // 2) + dense(nk, di // 2, di // 2)    # LocSE
                  + dense(nk, di, di) + dense(rows, di, di // 2)            # pooling 1
                  + dense(nk, di, di) + dense(rows, di, di)                 # pooling 2
                  + dense(rows, di, 2 * di) + dense(rows, ci, 2 * di))      # mlp2, shortcut
    total += dense(n[len(d)], 2 * d[-1], 2 * d[-1])                         # decoder_0
    x_ch = 2 * d[-1]
    for j in range(len(d)):
        out = 2 * d[max(len(d) - j - 2, 0)]                                 # the skip's width
        total += dense(n[len(d) - j - 1], out + x_ch, out)
        x_ch = out
    return total + dense(n[0], x_ch, 64) + dense(n[0], 64, 32) \
        + dense(n[0], 32, cfg["num_classes"])


def per_pair(cfg: Dict, traffic: Dict) -> float:
    """Operations of one pair (two clouds) through the label training step:
    the forward's Dense products, their backward at twice that, and both
    pyramids' searches."""
    points = traffic["points"]
    searches = sum(knn_work.work(*s)[0] for s in knn_work.pyramid_searches(
        points, cfg["num_knn"], cfg["sub_sampling_ratio"], 2))
    return 3.0 * 2 * randla_net(cfg, points) + searches
