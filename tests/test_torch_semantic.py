"""The port's semantic loss and mIoU metric (deepsir_tpu_torch/losses/semantic.py)
against the JAX package's, on seeded numpy inputs.

Tolerances: the loss 1e-6 relative, its gradient 1e-5 of the gradient's
largest magnitude; the accuracy, the confusion counts and the metric's
IoUs exact (the IoUs are the same numpy arithmetic on equal counts)."""
import torch_workers  # noqa: F401  (torch's threads under xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsir_tpu.losses import semantic as jax_semantic
from deepsir_tpu_torch.losses import semantic

CASES = [(0, (2, 512)), (1, (1, 1024)), (2, (3, 64)), (3, (2, 2, 100))]


def inputs(seed, shape, all_ignored=False):
    rng = np.random.default_rng(seed)
    logits = rng.normal(scale=2.0, size=shape + (semantic.NUM_CLASSES,)).astype(np.float32)
    labels = rng.integers(0, semantic.NUM_CLASSES + 1, size=shape).astype(np.int32)
    if all_ignored:
        labels[:] = 0
    # make about a third of the predictions right, so accuracy is not ~1/19
    hit = rng.uniform(size=shape) < 0.3
    pred = np.clip(labels - 1, 0, semantic.NUM_CLASSES - 1)
    np.put_along_axis(logits, pred[..., None], np.where(hit, 10.0, 0.0)[..., None]
                      + np.take_along_axis(logits, pred[..., None], -1), -1)
    return logits, labels


def test_constants_equal_jax():
    np.testing.assert_array_equal(semantic.CLASS_WEIGHTS, jax_semantic.CLASS_WEIGHTS)
    assert semantic.LABEL_NAMES == jax_semantic.LABEL_NAMES
    assert semantic.NUM_CLASSES == jax_semantic.NUM_CLASSES == len(semantic.LABEL_NAMES)


@pytest.mark.parametrize("seed,shape", CASES)
def test_semantic_loss_and_grad_equal_jax(seed, shape):
    logits, labels = inputs(seed, shape)
    loss_fn = lambda x: jax_semantic.semantic_loss(x, jnp.asarray(labels))
    want, want_acc = loss_fn(jnp.asarray(logits))
    want_grad = np.asarray(jax.grad(lambda x: loss_fn(x)[0])(jnp.asarray(logits)))
    x = torch.tensor(logits, requires_grad=True)
    got, acc = semantic.semantic_loss(x, torch.from_numpy(labels))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    assert float(acc) == float(want_acc)
    assert 0.2 < float(acc) < 0.6
    scale = np.abs(want_grad).max()
    assert np.abs(x.grad.numpy() - want_grad).max() <= 1e-5 * scale
    # ignored points get no gradient
    assert not x.grad.numpy()[labels == 0].any()


def test_all_ignored_points_give_zero_loss_and_accuracy():
    logits, labels = inputs(4, (2, 32), all_ignored=True)
    got, acc = semantic.semantic_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    want, want_acc = jax_semantic.semantic_loss(jnp.asarray(logits), jnp.asarray(labels))
    assert float(got) == float(want) == 0.0 and float(acc) == float(want_acc) == 0.0


@pytest.mark.parametrize("seed,shape", CASES)
def test_confusion_matrix_counts_equal_jax(seed, shape):
    logits, labels = inputs(seed, shape)
    got = semantic.confusion_matrix(torch.from_numpy(logits), torch.from_numpy(labels))
    want = np.asarray(jax_semantic.confusion_matrix(jnp.asarray(logits), jnp.asarray(labels)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) == int((labels > 0).sum())


def test_semantic_metric_equals_jax_over_batches():
    port, ref = semantic.SemanticMetric(), jax_semantic.SemanticMetric()
    for seed, shape in CASES:
        logits, labels = inputs(seed, shape)
        port.update(semantic.confusion_matrix(torch.from_numpy(logits), torch.from_numpy(labels)))
        ref.update(jax_semantic.confusion_matrix(jnp.asarray(logits), jnp.asarray(labels)))
    np.testing.assert_array_equal(port.cm, ref.cm)
    got, want = port.compute(), ref.compute()
    assert got[0] == want[0] and got[1] == want[1] and got[2] == want[2]
    assert 0.0 < got[0] < 1.0 and len(got[1]) == semantic.NUM_CLASSES
    # compute resets
    assert not port.cm.any()
    assert port.compute() == (0.0, [0.0] * semantic.NUM_CLASSES, 0.0)
