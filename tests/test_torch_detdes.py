"""The port's feat loss (deepsir_tpu_torch/losses/detdes.py) and its
descriptor distances against the JAX package's, on seeded numpy inputs.

The inputs plant what the reference's quirks act on: exact duplicate
points (distance 0, the only positives of the zero-before-min mask when a
row has an out-of-radius pair), anchors with no in-radius correspondent
(what `overlap_det_mask` drops), and a radius that holds every pair (where
the row min is a real distance). Tiles that do not divide N2 are clamped to
its largest divisor in both packages.

Tolerances: loss values 1e-5 relative; accuracy equal; gradients of
loss_feat + loss_det with respect to both descriptor sets within 1e-5 of
the gradient's largest magnitude; distances 1e-5
relative (1e-5 absolute where a value is near 0)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsir_tpu.config import LossConfig as JaxLossConfig
from deepsir_tpu.losses import detdes as jax_detdes
from deepsir_tpu.ops import distance as jax_distance
from deepsir_tpu_torch.config import LossConfig
from deepsir_tpu_torch.losses import detdes
from deepsir_tpu_torch.ops import distance

N, C = 96, 16
RADIUS = 0.9


def unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def make_inputs(seed, batch=2, dup=8, far=10):
    """Anchors in a 4-unit box; positives a permuted, jittered copy of them
    with `dup` exact duplicates; the last `far` anchors moved out of reach."""
    rng = np.random.default_rng(seed)
    anc_pc = rng.uniform(-2.0, 2.0, size=(batch, N, 3)).astype(np.float32)
    perm = rng.permutation(N)
    pos_pc = (anc_pc[:, perm] + rng.normal(scale=0.15, size=(batch, N, 3))).astype(np.float32)
    for b in range(batch):
        rows = rng.choice(N, size=dup, replace=False)
        pos_pc[b, rows] = anc_pc[b, rng.choice(N - far, size=dup, replace=False)]
    anc_pc[:, N - far:] += 20.0
    anc_feat = unit(rng.normal(size=(batch, N, C)))
    pos_feat = unit(anc_feat[:, perm] + rng.normal(scale=0.6, size=(batch, N, C)))
    score = rng.uniform(0.0, 1.0, size=(batch, N)).astype(np.float32)
    return anc_feat, pos_feat, anc_pc, pos_pc, score


def jax_circle(fn, inputs, **kw):
    """(loss_feat, loss_det, acc) and the gradients of loss_feat + loss_det
    with respect to both descriptor sets."""
    anc_feat, pos_feat, anc_pc, pos_pc, score = map(jnp.asarray, inputs)

    def total(a, p):
        lf, ld, acc = fn(a, p, anc_pc, pos_pc, score, **kw)
        return lf + ld, (lf, ld, acc)
    (_, vals), grads = jax.value_and_grad(total, argnums=(0, 1), has_aux=True)(anc_feat, pos_feat)
    return [float(v) for v in vals], [np.asarray(g) for g in grads]


def port_circle(fn, inputs, **kw):
    anc_feat, pos_feat, anc_pc, pos_pc, score = (torch.from_numpy(x) for x in inputs)
    a = anc_feat.clone().requires_grad_(True)
    p = pos_feat.clone().requires_grad_(True)
    lf, ld, acc = fn(a, p, anc_pc, pos_pc, score, **kw)
    (lf + ld).backward()
    return [lf.item(), ld.item(), acc.item()], [a.grad.numpy(), p.grad.numpy()]


def assert_close(got, want):
    (g_vals, g_grads), (w_vals, w_grads) = got, want
    np.testing.assert_allclose(g_vals[:2], w_vals[:2], rtol=1e-5, atol=1e-7)
    assert g_vals[2] == pytest.approx(w_vals[2], rel=1e-6)      # accuracy: equal counts
    for g, w in zip(g_grads, w_grads):
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()


def test_the_inputs_exercise_the_quirks():
    anc_feat, pos_feat, anc_pc, pos_pc, _ = make_inputs(0)
    d = np.linalg.norm(anc_pc[:, :, None] - pos_pc[:, None], axis=-1)
    assert (d == 0).sum() == 2 * 8                      # exact duplicates
    assert (~(d < RADIUS).any(-1)).sum() >= 2 * 10      # anchors without a positive
    assert ((d < RADIUS).sum(-1) > 1).any()             # several in-radius pairs per row


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_circle_loss_equals_jax(seed, overlap):
    inputs = make_inputs(seed)
    kw = dict(thres_radius=RADIUS, overlap_det_mask=overlap)
    assert_close(port_circle(detdes.circle_loss, inputs, **kw),
                 jax_circle(jax_detdes.circle_loss, inputs, **kw))


@pytest.mark.parametrize("overlap", [False, True])
def test_circle_loss_with_every_pair_in_radius_equals_jax(overlap):
    """No out-of-radius pair: the row min is a real distance, and each
    anchor's nearest positive is its detector positive."""
    inputs = make_inputs(2, far=0)
    kw = dict(thres_radius=100.0, overlap_det_mask=overlap)
    got = port_circle(detdes.circle_loss, inputs, **kw)
    assert_close(got, jax_circle(jax_detdes.circle_loss, inputs, **kw))
    assert got[0][2] > 0.0


@pytest.mark.parametrize("tile,used", [(32, 32), (40, 32), (7, 6), (96, 96), (500, 96)])
@pytest.mark.parametrize("overlap", [False, True])
def test_circle_loss_tiled_equals_jax(tile, used, overlap):
    assert detdes._largest_divisor(N, tile) == used
    inputs = make_inputs(3)
    kw = dict(thres_radius=RADIUS, overlap_det_mask=overlap, tile=tile)
    got = port_circle(detdes.circle_loss_tiled, inputs, **kw)
    assert_close(got, jax_circle(jax_detdes.circle_loss_tiled, inputs, **kw))
    if not overlap:
        # without the mask each element's mean is the materialised form's
        assert_close(got, port_circle(detdes.circle_loss, inputs, thres_radius=RADIUS))


@pytest.mark.parametrize("tile", [0, 32])
@pytest.mark.parametrize("overlap", [False, True])
def test_det_des_loss_equals_jax(tile, overlap):
    feat_ref, feat_src, pt_ref, pt_src, score_ref = make_inputs(4)
    rng = np.random.default_rng(5)
    rot = np.linalg.qr(rng.normal(size=(2, 3, 3)))[0]
    rot *= np.sign(np.linalg.det(rot))[:, None, None]
    gt = np.concatenate([rot, rng.normal(size=(2, 3, 1))], axis=-1).astype(np.float32)
    # the source in its own frame: gt maps it back onto the reference
    pt_src = np.einsum("bji,bnj->bni", rot, pt_src - gt[:, None, :, 3]).astype(np.float32)
    score_src = rng.uniform(size=score_ref.shape).astype(np.float32)
    kw = dict(thres_radius=RADIUS, det_loss_weight=0.7, circle_loss_tile=tile,
              overlap_det_mask=overlap)

    def jax_fn(fs, fr):
        return jax_detdes.det_des_loss(fs, fr, pt_src, pt_ref, score_src, score_ref, gt,
                                       JaxLossConfig(**kw))
    (want, want_acc), want_g = jax.value_and_grad(jax_fn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(feat_src), jnp.asarray(feat_ref))
    fs = torch.tensor(feat_src, requires_grad=True)
    fr = torch.tensor(feat_ref, requires_grad=True)
    got, acc = detdes.det_des_loss(fs, fr, *(torch.from_numpy(x) for x in (
        pt_src, pt_ref, score_src, score_ref, gt)), LossConfig(**kw))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    assert acc.item() == pytest.approx(float(want_acc), rel=1e-6)
    for g, w in zip((fs.grad, fr.grad), want_g):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= 1e-5 * np.abs(np.asarray(w)).max()


def test_det_des_loss_needs_a_radius():
    x = [torch.from_numpy(a) for a in make_inputs(0)]
    with pytest.raises(ValueError, match="thres_radius"):
        detdes.det_des_loss(x[1], x[0], x[3], x[2], x[4], x[4],
                            torch.eye(3, 4).expand(2, 3, 4), LossConfig())


def test_softplus_is_jax_softplus_at_large_arguments():
    x = np.array([-50.0, -1.0, 0.0, 3.0, 19.9, 20.1, 40.0, 90.0], np.float32)
    np.testing.assert_allclose(detdes.softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=1e-6)


@pytest.mark.parametrize("shape", [(2, 40, 50, C), (1, 96, 96, 3), (3, 7, 130, 64)])
def test_square_distance_equals_jax(shape):
    b, n, m, c = shape
    rng = np.random.default_rng(8)
    x = rng.normal(size=(b, n, c)).astype(np.float32)
    y = rng.normal(size=(b, m, c)).astype(np.float32)
    got = distance.square_distance(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert got.shape == (b, n, m)
    np.testing.assert_allclose(
        got, np.asarray(jax_distance.square_distance(jnp.asarray(x), jnp.asarray(y))),
        rtol=1e-5, atol=1e-5)
