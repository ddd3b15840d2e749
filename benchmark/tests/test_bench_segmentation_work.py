"""work/segmentation.py, the count behind `mfu_pct.label_train`: against a
hand count of a two-level network and against the Dense products the
reference runs, counted by hooks."""
import pytest
import torch

from benchmark import harness
from benchmark.work import segmentation

RANDLA = harness.load_json(harness.HERE / "configs" / "randla-semantickitti.json")["model"]
TWO_LEVELS = dict(RANDLA, d_out=[8, 16], sub_sampling_ratio=[4, 4], num_knn=4)


def test_two_levels_by_hand():
    # 64 points, levels of 64, 16 and 4 points, 4 neighbours; 2 x rows x in x out
    fc0 = 2 * 64 * 3 * 8
    block0 = 2 * (64 * 8 * 4 + 256 * 10 * 4 + 256 * 4 * 4 + 256 * 8 * 8 + 64 * 8 * 4
                  + 256 * 8 * 8 + 64 * 8 * 8 + 64 * 8 * 16 + 64 * 8 * 16)
    block1 = 2 * (16 * 16 * 8 + 64 * 10 * 8 + 64 * 8 * 8 + 64 * 16 * 16 + 16 * 16 * 8
                  + 64 * 16 * 16 + 16 * 16 * 16 + 16 * 16 * 32 + 16 * 16 * 32)
    decoder = 2 * (4 * 32 * 32 + 16 * (16 + 32) * 16 + 64 * (16 + 16) * 16)
    head = 2 * (64 * 16 * 64 + 64 * 64 * 32 + 64 * 32 * 19)
    forward = fc0 + block0 + block1 + decoder + head
    assert forward == 848896
    assert segmentation.randla_net(TWO_LEVELS, 64) == forward
    # both clouds: forward and the backward at twice it; the searches, 8
    # operations a distance: 64 x 64 and 64 x 16, then 16 x 16 and 16 x 4
    searches = 8 * 2 * (64 * 64 + 64 * 16 + 16 * 16 + 16 * 4)
    assert segmentation.per_pair(TWO_LEVELS, {"points": 64}) == 3 * 2 * forward + searches


@pytest.mark.parametrize("cfg", [TWO_LEVELS, RANDLA], ids=["two-levels", "published"])
def test_dense_against_the_reference(cfg):
    from benchmark.reference.randla_net import SegmentationNet, build_pyramid
    points = 1024
    net = SegmentationNet(harness.namespace(cfg))
    xyz = torch.randn(1, points, 3, generator=torch.Generator().manual_seed(0))
    counted = [0.0]

    def hook(mod, args, out):
        x = args[0]
        counted[0] += 2.0 * x.numel() / x.shape[-1] * mod.in_features * mod.out_features

    for m in net.modules():
        if isinstance(m, torch.nn.Linear):
            m.register_forward_hook(hook)
    with torch.no_grad():
        net.feat_extractor(xyz, build_pyramid(xyz, cfg["num_knn"], cfg["sub_sampling_ratio"]))
    assert segmentation.randla_net(cfg, points) == pytest.approx(counted[0], rel=1e-12)


def test_the_published_step():
    per = segmentation.per_pair(RANDLA, {"points": 45056})
    forward = segmentation.randla_net(RANDLA, 45056)
    # a cloud's forward is ~14.1 GFLOP; the two pyramids' searches ~43.3,
    # about 4/3 of the two 45056 x 45056 self-searches (8 x 45056^2 each):
    # each level's self-search and upsampling search are a 16th and a 4th of
    # the level above's self-search
    assert 14.0e9 < forward < 14.3e9
    assert per - 6 * forward == pytest.approx(2 * 8 * 45056 ** 2 * 4 / 3, rel=1e-3)
