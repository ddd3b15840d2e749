"""The input recipes and the weights: equal for equal seeds, the rigid
motion as stated."""
import numpy as np
import pytest
import torch

from benchmark import harness, inputs

SEED = 3_000_000_019          # above 2**31, as the driver's are


def test_pool_equal_for_equal_seeds():
    a = inputs.make_pool(SEED, 2, 2, 300, 4)
    b = inputs.make_pool(SEED, 2, 2, 300, 4)
    c = inputs.make_pool(SEED + 1, 2, 2, 300, 4)
    for x, y, z in zip(a, b, c):
        for k in x:
            assert np.array_equal(x[k], y[k])
            assert x[k].dtype == np.float32 and x[k].flags["C_CONTIGUOUS"]
        assert not np.array_equal(x["points_src"], z["points_src"])
    assert a[0]["points_src"].shape == (2, 300, 4) and a[0]["transform_gt"].shape == (2, 3, 4)
    assert not np.array_equal(a[0]["points_src"], a[1]["points_src"])


def test_reference_is_a_noisy_rigid_motion():
    pool = inputs.make_pool(SEED, 1, 3, 2000, 4)[0]
    for src, ref, gt in zip(pool["points_src"], pool["points_ref"], pool["transform_gt"]):
        rot, t = gt[:, :3].astype(np.float64), gt[:, 3].astype(np.float64)
        assert np.allclose(rot @ rot.T, np.eye(3), atol=1e-6) and np.linalg.det(rot) > 0
        assert np.degrees(np.arccos((np.trace(rot) - 1) / 2)) <= 30.0 + 1e-4
        assert np.linalg.norm(t) <= 1.0 + 1e-6
        moved = src[:, :3] @ rot.T + t
        # rows reshuffled: each reference row is a moved source row plus noise
        assert np.allclose(np.sort(ref[:, 3]), np.sort(src[:, 3]))
        order_ref, order_src = np.argsort(ref[:, 3]), np.argsort(src[:, 3])
        noise = ref[order_ref, :3] - moved[order_src]
        assert 0.015 < noise.std() < 0.025 and abs(noise.mean()) < 0.005
        assert not np.array_equal(ref[:, 3], src[:, 3])


def test_weights_equal_for_equal_seeds():
    cfg = harness.find_cell("deepsir-default.eval-b16").config["model"]
    shapes = harness.reference_shapes(cfg, "align")
    a = inputs.make_weights(shapes, SEED, "cpu")
    b = inputs.make_weights(shapes, SEED, "cpu")
    c = inputs.make_weights(shapes, SEED + 1, "cpu")
    assert set(a) == set(shapes)
    for name, shape in shapes.items():
        assert a[name].shape == shape and torch.equal(a[name], b[name])
    w = a["inlier_model.enc.3.mlp2.dense.weight"]
    assert w.std().item() == pytest.approx((2.0 / w.shape[1]) ** 0.5, rel=0.05)
    assert not torch.equal(w, c["inlier_model.enc.3.mlp2.dense.weight"])
    assert torch.all(a["feat_extractor.mlp_pre.norm.weight"] == 1)
    assert torch.all(a["feat_extractor.mlp_pre.dense.bias"] == 0)


def test_weights_fit_the_port():
    """The reference's layout is the port's: the state dict loads strictly."""
    from deepsir_tpu_torch.models.network import Network
    for cell, pipeline in (("deepsir-flagship.eval-b16", "align"),
                           ("deepsir-default.feat-train-b1", "feat")):
        cfg = harness.find_cell(cell).config["model"]
        weights = inputs.make_weights(harness.reference_shapes(cfg, pipeline), SEED, "cpu")
        Network(harness.model_config(cfg), pipeline).load_state_dict(weights, strict=True)
