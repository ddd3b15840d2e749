"""The work counters against hand counts and against the Dense products the
reference network runs, counted by hooks, at small shapes."""
import copy

import pytest
import torch

from benchmark import harness, peaks
from benchmark.work import knn, match, model

DEFAULT = harness.load_json(harness.HERE / "configs" / "deepsir-default.json")["model"]
FLAGSHIP = harness.load_json(harness.HERE / "configs" / "deepsir-flagship.json")["model"]


def test_knn_work_by_hand():
    # 4 queries x 5 refs in 3-D, k = 2: 8 operations a pair; 4 bytes a
    # coordinate read, 8 + 4 a neighbour written
    assert knn.work(1, 4, 5, 3, 2) == (160.0, 4 * 9 * 3 + 12 * 4 * 2)
    assert knn.work(2, 4, 5, 3, 2) == (320.0, 2 * (4 * 9 * 3 + 12 * 4 * 2))


def test_pyramid_searches_by_hand():
    assert knn.pyramid_searches(256, 16, (4, 4), 2) == [
        (2, 256, 256, 3, 16), (2, 256, 64, 3, 1), (2, 64, 64, 3, 16), (2, 64, 16, 3, 1)]
    # k is cut to a level smaller than it
    assert knn.pyramid_searches(40, 16, (4, 4), 1)[2] == (1, 10, 10, 3, 10)


def test_match_work_by_hand():
    flops, nbytes = match.work(1, 3, 5, 2, False)
    assert flops == 2 * 3 * 5 * 2
    assert nbytes == 4 * 8 * 3 + 8 * 3
    assert match.work(1, 3, 5, 2, True)[1] == nbytes + 8 * 5
    # 18000 x 18000 x 64 at fp32 grade: the 0.251 ms of the repository's kernel table
    assert match.bound_s(1, 18000, 18000, 64, False) == pytest.approx(0.251e-3, rel=2e-3)
    assert knn.bound_s(1, 18000, 18000, 3, 16) == pytest.approx(0.0387e-3, rel=2e-3)
    assert peaks.FP32_GRADE_FLOPS == peaks.TF32_FLOPS / 3


def _count_dense(net, fn):
    total = [0.0]

    def hook(mod, args, out):
        x = args[0]
        total[0] += 2.0 * x.numel() / x.shape[-1] * mod.in_features * mod.out_features

    handles = [m.register_forward_hook(hook) for m in net.modules()
               if isinstance(m, torch.nn.Linear)]
    fn()
    for h in handles:
        h.remove()
    return total[0]


@pytest.mark.parametrize("cfg", [DEFAULT, FLAGSHIP], ids=["default", "flagship"])
@pytest.mark.parametrize("num_iter", [1, 3])
def test_align_dense_against_the_reference(cfg, num_iter):
    from benchmark import inputs
    from benchmark.reference.network import Network
    points = 512
    net = Network(harness.namespace(cfg), "align")
    arrays = inputs.make_pool(5, 1, 1, points, cfg["feat_len"])[0]
    src, ref = (torch.as_tensor(arrays[k]) for k in ("points_src", "points_ref"))
    with torch.no_grad():
        pyr = net.pyramids(src, ref)
        counted = _count_dense(net, lambda: net.forward_align(src, ref, *pyr, num_iter, True))
    assert model.align_dense(cfg, points, num_iter)[0] == pytest.approx(counted, rel=1e-12)


def test_feat_dense_against_the_reference():
    from benchmark import inputs
    from benchmark.reference.network import Network
    points = 512
    net = Network(harness.namespace(DEFAULT), "feat")
    arrays = inputs.make_pool(6, 1, 1, points, DEFAULT["feat_len"])[0]
    src, ref = (torch.as_tensor(arrays[k]) for k in ("points_src", "points_ref"))
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        pyr = net.pyramids(src, ref)
        counted = _count_dense(net, lambda: net.forward_pair(src, ref, *pyr, gen))
    assert model.feat_dense(DEFAULT, points)[0] == pytest.approx(counted, rel=1e-12)


def test_per_pair_totals():
    # the eval step: 5 descriptor searches of 18000 x 18000 x 64 lead
    per = model.per_pair(DEFAULT, {"num_iter": 5}, {"points": 18000, "pipeline": "align",
                                                     "driver": "eval"})
    assert 5 * 2 * 18000 ** 2 * 64 < per < 300e9
    flag = copy.deepcopy(DEFAULT)
    flag["inlier_extra_feats"] = "dist,recip"
    assert model.per_pair(flag, {"num_iter": 5}, {"points": 18000, "pipeline": "align",
                                                  "driver": "eval"}) > per
    train = model.per_pair(DEFAULT, {}, {"points": 18000, "pipeline": "align",
                                         "driver": "train"})
    assert train < per          # two iterations, the backward of the inlier net only
