"""The gradient of the port's 3x3 SVD and weighted Kabsch solve
(deepsir_tpu_torch/ops/svd3.py) against the JAX package's custom VJP and
`jax.grad`, on the CPU.

- `svd3x3`'s backward against `jax.vjp` of deepsir_tpu's `svd3x3` on random
  non-degenerate batches (random orthogonal factors, singular values in
  [0.3, 3] at least 0.1 apart), same cotangents: singular values 1e-5
  relative to the largest, the gradient 1e-5 relative to each matrix's
  largest gradient entry.
- The adjoint itself, on the same residuals and cotangents, against
  deepsir_tpu's `_svd3x3_bwd` on close-gap batches (two singular values
  within 1e-4, where the 1e-10 clamp acts) and rank-deficient ones (a zero
  singular value, whose null vectors the two forwards pick differently, so
  each backward gets the port's residuals): 1e-5 relative.
- `weighted_kabsch`'s gradient with respect to the weights and the target
  points against `jax.grad` of the same scalar function: 1e-4 relative to
  the largest entry (fp32 through the SVD).
- `torch.autograd.gradcheck` in float64 of `svd3x3` and `weighted_kabsch`
  on well-conditioned inputs (eps 1e-6, atol 1e-5, rtol 1e-4).
- The autograd graph holds no Jacobi sweep: the SVD is one node.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsir_tpu.ops import svd3 as jax_svd3
from deepsir_tpu_torch.ops.svd3 import _SVD3x3, svd3x3, weighted_kabsch


def with_singular_values(rng, s):
    """Random orthogonal U, V around the given singular values (n, 3)."""
    n = len(s)
    q1, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    q2, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    return (q1 * s[:, None, :]) @ q2.transpose(0, 2, 1)


def cotangents(rng, n):
    return tuple(rng.normal(size=shape).astype(np.float32)
                 for shape in ((n, 3, 3), (n, 3), (n, 3, 3)))


def assert_rel(got, want, rtol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).reshape(len(want), -1).max(axis=1)
    err = np.abs(got - want).reshape(len(want), -1).max(axis=1)
    assert (err <= rtol * scale).all(), (what, float((err / scale).max()))


def test_svd_backward_equals_jax_vjp_on_random_batches():
    rng = np.random.default_rng(0)
    s3 = rng.uniform(0.3, 1.0, size=64)
    s2 = s3 + rng.uniform(0.1, 1.0, size=64)
    sv = np.stack([s2 + rng.uniform(0.1, 1.0, size=64), s2, s3], axis=1)
    a = with_singular_values(rng, sv).astype(np.float32)
    cot = cotangents(rng, len(a))
    out, vjp = jax.vjp(jax_svd3.svd3x3, jnp.asarray(a))
    (want,) = vjp(tuple(jnp.asarray(c) for c in cot))
    x = torch.tensor(a, requires_grad=True)
    u, s, vt = svd3x3(x)
    assert_rel(s.detach().numpy(), np.asarray(out[1]), 1e-5, "s")
    (got,) = torch.autograd.grad((u, s, vt), x, tuple(torch.tensor(c) for c in cot))
    assert_rel(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("kind", ["close-gap", "rank-deficient"])
def test_svd_adjoint_equals_jax_on_degenerate_batches(kind):
    rng = np.random.default_rng(1)
    n = 64
    s = np.sort(rng.uniform(0.5, 2.0, size=(n, 3)), axis=1)[:, ::-1].copy()
    if kind == "close-gap":
        s[:, 1] = s[:, 0] - rng.uniform(1e-6, 1e-4, size=n)
    else:
        s[:, 2] = 0.0
    a = torch.tensor(with_singular_values(rng, s), dtype=torch.float32, requires_grad=True)
    u, sv, vt = svd3x3(a)
    cot = cotangents(rng, n)
    (got,) = torch.autograd.grad((u, sv, vt), a, tuple(torch.tensor(c) for c in cot))
    (want,) = jax_svd3._svd3x3_bwd(tuple(jnp.asarray(t.detach().numpy()) for t in (u, sv, vt)),
                                   tuple(jnp.asarray(c) for c in cot))
    assert np.isfinite(got.numpy()).all()
    assert_rel(got.numpy(), want, 1e-5, kind)


def kabsch_inputs(rng, b=8, m=200):
    src = rng.normal(size=(b, m, 3)).astype(np.float32)
    ang = rng.uniform(0, 0.5, size=b)
    rot = np.stack([[[np.cos(t), -np.sin(t), 0], [np.sin(t), np.cos(t), 0], [0, 0, 1]]
                    for t in ang]).astype(np.float32)
    tgt = (src @ rot.transpose(0, 2, 1) + rng.normal(scale=0.05, size=src.shape)
           + rng.normal(size=(b, 1, 3))).astype(np.float32)
    w = rng.uniform(0.0, 1.0, size=(b, m)).astype(np.float32)
    c = rng.normal(size=(b, 3, 4)).astype(np.float32)
    return src, tgt, w, c


def test_weighted_kabsch_grads_equal_jax_grad():
    rng = np.random.default_rng(2)
    src, tgt, w, c = kabsch_inputs(rng)

    def jax_f(weights, target):
        t, _ = jax_svd3.weighted_kabsch(jnp.asarray(src), target, weights)
        return jnp.sum(t * c)
    want_w, want_t = jax.grad(jax_f, argnums=(0, 1))(jnp.asarray(w), jnp.asarray(tgt))
    wt = torch.tensor(w, requires_grad=True)
    tt = torch.tensor(tgt, requires_grad=True)
    t, invalid = weighted_kabsch(torch.tensor(src), tt, wt)
    assert not bool(invalid.any())
    (t * torch.tensor(c)).sum().backward()
    assert_rel(wt.grad.numpy(), want_w, 1e-4, "weights")
    assert_rel(tt.grad.numpy(), want_t, 1e-4, "tgt")


def test_svd_gradcheck_float64():
    rng = np.random.default_rng(3)
    s = np.stack([np.array([3.0, 2.0, 1.0]) + rng.uniform(0, 0.2, 3) for _ in range(4)])
    a = torch.tensor(with_singular_values(rng, s), dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(svd3x3, (a,), eps=1e-6, atol=1e-5, rtol=1e-4)


def test_weighted_kabsch_gradcheck_float64():
    rng = np.random.default_rng(4)
    src, tgt, w, _ = kabsch_inputs(rng, b=2, m=12)
    src = torch.tensor(src, dtype=torch.float64)
    tgt = torch.tensor(tgt, dtype=torch.float64, requires_grad=True)
    w = torch.tensor(w + 0.5, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda t, wt: weighted_kabsch(src, t, wt)[0], (tgt, w),
                                    eps=1e-6, atol=1e-5, rtol=1e-4)


def test_the_svd_is_one_node_of_the_graph():
    a = torch.randn(5, 3, 3, requires_grad=True)
    u, s, vt = svd3x3(a)
    assert type(s.grad_fn).__name__ == "_SVD3x3Backward"
    assert s.grad_fn.next_functions[0][0].variable is a
    assert issubclass(_SVD3x3, torch.autograd.Function)
