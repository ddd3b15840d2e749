"""The port's scan-alignment loss (deepsir_tpu_torch/losses/align.py) against
the JAX package's (deepsir_tpu/losses/align.py), term by term, on the CPU.

Inputs from a seed: 3 iterations, B=2, N=500 source points, poses near a
ground truth, random logits, matches of which about half are true. Cases:
mae and mse distance terms; the pose term; the geometric BCE (pt_ref
given) and the list BCE (padded ground-truth match lists with -1 rows);
`mask_src`; reduction "none". Every term and the total 1e-5 relative
(1e-7 absolute), and their gradients with respect to the transforms and
the logits 1e-4 relative to the largest entry. The pose terms also allow
the rounding of arccos near 1: the fp32 trace of R_gt^T R (about 3) is
summed in another order in each package, and 2 ulps of it (4.8e-7) move
the angle by 2.4e-7 / sin(angle), times the term's weight; this bound is
added to their absolute tolerance and to the total's. A term with no path
to an input gives JAX a zero gradient and torch none. `correspondence_correct`
equal to JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsir_tpu.config import LossConfig as JaxLossConfig
from deepsir_tpu.losses.align import (correspondence_correct as jax_correct,
                                      scan_alignment_loss as jax_loss)
from deepsir_tpu_torch.config import LossConfig
from deepsir_tpu_torch.losses.align import correspondence_correct, scan_alignment_loss

ITERS, B, N, CAP = 3, 2, 500, 400


def rotation(rng, deg):
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    t = np.deg2rad(deg)
    return np.eye(3) + np.sin(t) * k + (1 - np.cos(t)) * k @ k


def inputs(seed=0):
    rng = np.random.default_rng(seed)
    pt_src = rng.normal(size=(B, N, 3)).astype(np.float32)
    gt = np.stack([np.concatenate([rotation(rng, 20), rng.normal(size=(3, 1))], 1)
                   for _ in range(B)]).astype(np.float32)
    moved = pt_src @ gt[:, :, :3].transpose(0, 2, 1) + gt[:, None, :, 3]
    perm = np.stack([rng.permutation(N) for _ in range(B)])
    pt_ref = np.take_along_axis(moved, perm[..., None], 1).astype(np.float32)
    inv = np.argsort(perm, axis=1)                       # src i sits at ref inv[i]
    transforms = np.stack([np.stack([
        np.concatenate([rotation(rng, 5.0 / (i + 1)) @ gt[b, :, :3],
                        gt[b, :, 3:] + rng.normal(scale=0.1, size=(3, 1))], 1)
        for b in range(B)]) for i in range(ITERS)]).astype(np.float32)
    pred = np.where(rng.uniform(size=(ITERS, B, N)) < 0.5, inv[None],
                    rng.integers(0, N, size=(ITERS, B, N)))
    logits = rng.normal(scale=2.0, size=(ITERS, B, N)).astype(np.float32)
    # list of true matches, truncated to CAP and padded with -1 rows
    matches = -np.ones((B, CAP + 50, 2), np.int32)
    for b in range(B):
        keep = rng.permutation(N)[:CAP]
        matches[b, :CAP] = np.stack([keep, inv[b, keep]], 1)
        matches[b] = matches[b, rng.permutation(CAP + 50)]
    mask = (rng.uniform(size=(B, N)) < 0.8).astype(np.float32)
    return dict(transforms=transforms, logits=logits, pred=pred.astype(np.int32),
                pt_src=pt_src, pt_ref=pt_ref, gt=gt, matches=matches, mask=mask)


CASES = {
    "mae+geometric": (dict(), dict(geometric=True)),
    "mse+geometric": (dict(loss_type="mse"), dict(geometric=True)),
    "pose": (dict(wt_pose_loss=0.7, wt_ptDist_loss=0.3), dict(geometric=True)),
    "list-bce": (dict(), dict(geometric=False)),
    "mask_src": (dict(loss_type="mse", wt_pose_loss=0.2), dict(geometric=True, mask=True)),
    "reduction-none": (dict(wt_pose_loss=0.2), dict(geometric=False, reduction="none",
                                                    mask=True)),
    "no-distance": (dict(wt_ptDist_loss=0.0), dict(geometric=True)),
}


def arccos_rounding(x, loss_kw, reduction):
    """Per pose term, the absolute error that 2 ulps of the fp32 trace allow."""
    wt = loss_kw.get("wt_pose_loss", 0.0)
    out = {}
    for i in range(ITERS):
        r = x["gt"][:, :, :3].astype(np.float64).transpose(0, 2, 1) @ x["transforms"][i, :, :, :3]
        angle = np.arccos(np.clip((np.trace(r, axis1=1, axis2=2) - 1) / 2, -1, 1))
        bound = wt * 2.4e-7 / np.sin(angle)
        out[f"poseError_{i}"] = bound.mean() if reduction == "mean" else bound
    out["total"] = sum(out.values()) if out else 0.0
    return out


def run_both(loss_kw, geometric, reduction="mean", mask=False):
    x = inputs()
    cfg_kw = dict(loss_kw, thres_radius=0.3)
    kw = dict(reduction=reduction)

    def jax_terms(transforms, logits):
        return jax_loss(transforms, logits, jnp.asarray(x["pred"]), jnp.asarray(x["pt_src"]),
                        jnp.asarray(x["gt"]), jnp.asarray(x["matches"]),
                        JaxLossConfig(**cfg_kw),
                        pt_ref=jnp.asarray(x["pt_ref"]) if geometric else None,
                        mask_src=jnp.asarray(x["mask"]) if mask else None, **kw)
    want = jax_terms(jnp.asarray(x["transforms"]), jnp.asarray(x["logits"]))
    want_grads = jax.grad(lambda t, lg: jnp.sum(jax_terms(t, lg)["total"]), argnums=(0, 1))(
        jnp.asarray(x["transforms"]), jnp.asarray(x["logits"]))

    t = torch.tensor(x["transforms"], requires_grad=True)
    lg = torch.tensor(x["logits"], requires_grad=True)
    got = scan_alignment_loss(t, lg, torch.tensor(x["pred"]).long(), torch.tensor(x["pt_src"]),
                              torch.tensor(x["gt"]), torch.tensor(x["matches"]),
                              LossConfig(**cfg_kw),
                              pt_ref=torch.tensor(x["pt_ref"]) if geometric else None,
                              mask_src=torch.tensor(x["mask"]) if mask else None, **kw)
    got["total"].sum().backward()
    grads = tuple(torch.zeros_like(v) if v.grad is None else v.grad for v in (t, lg))
    return got, want, grads, want_grads, arccos_rounding(x, loss_kw, reduction)


@pytest.mark.parametrize("name", list(CASES))
def test_every_term_and_its_gradient_equal_jax(name):
    loss_kw, kw = CASES[name]
    got, want, grads, want_grads, rounding = run_both(loss_kw, **kw)
    assert set(got) == set(want)
    for key, value in want.items():
        g = got[key].detach().numpy()
        assert g.shape == np.shape(value), key
        np.testing.assert_allclose(g, np.asarray(value), rtol=1e-5,
                                   atol=1e-7 + np.max(rounding.get(key, 0.0)), err_msg=key)
    for g, w in zip(grads, want_grads):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max()


def test_the_terms_are_present_as_their_weights_say():
    got = run_both(dict(wt_pose_loss=0.5), geometric=True)[0]
    assert set(got) == ({f"mae_{i}" for i in range(ITERS)} | {f"outlier_{i}" for i in range(ITERS)}
                        | {f"poseError_{i}" for i in range(ITERS)} | {"total"})
    got = run_both(dict(wt_inlier_loss=0.0), geometric=True)[0]
    assert set(got) == {f"mae_{i}" for i in range(ITERS)} | {"total"}


def test_correspondence_correct_equals_jax_and_ignores_padding():
    x = inputs(1)
    for i in range(ITERS):
        got = correspondence_correct(torch.tensor(x["pred"][i]), torch.tensor(x["matches"]), N)
        want = jax_correct(jnp.asarray(x["pred"][i]), jnp.asarray(x["matches"]), N)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert 0 < int(got.sum()) < got.numel()
    # all padding: nothing is correct
    none = correspondence_correct(torch.zeros(1, 10, dtype=torch.long),
                                  -torch.ones(1, 5, 2, dtype=torch.int32), 10)
    assert not bool(none.any())
