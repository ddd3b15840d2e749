"""The port's reference-checkpoint import (deepsir_tpu_torch/utils/torch_import.py)
against the JAX package's (deepsir_tpu/utils/torch_import.py), on the CPU.

The reference state_dict is synthetic: built here in the reference key
layout that the JAX importer reads (the `_Mapper` prefixes: MLP2D
conv + GroupNorm units, Att_pooling score convs, the FC stacks' Conv1d +
BatchNorm1d triplets with running statistics), with seeded values at the
shapes of a narrow `fc_norm="none"` network (4 levels, d_out (8, 16, 16,
32)), and saved with `torch.save`.

- The imported tree equals JAX's leaf for leaf, bit for bit, for each
  pipeline (both map with the same numpy arithmetic, the BatchNorm folds
  included).
- Loaded into a port `Network` through `import_reference_checkpoint(...,
  model=...)` it equals JAX's import through its `params_template`, and
  the two packages' align forwards at 1024 points over exact (float64 KNN)
  pyramids agree: matches equal, transforms within 1e-5, inlier logits
  within 1e-5 of their scale.
- A missing source key raises KeyError in both; a key left over raises
  (ValueError in the port, AssertionError in JAX); a port network of
  other widths raises ValueError.
"""
import torch_workers  # noqa: F401  (torch's threads under xdist)
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsir_tpu.config import ModelConfig as JaxModelConfig
from deepsir_tpu.models import ForwardOptions as JaxForwardOptions, Network as JaxNetwork
from deepsir_tpu.models.network import PairBatch as JaxPairBatch
from deepsir_tpu.ops.pyramid import Pyramid as JaxPyramid
from deepsir_tpu.utils import torch_import as jax_import
from deepsir_tpu_torch.config import ModelConfig
from deepsir_tpu_torch.models.network import ForwardOptions, Network, PairBatch
from deepsir_tpu_torch.ops.pyramid import Pyramid
from deepsir_tpu_torch.utils import torch_import
from deepsir_tpu_torch.utils.params import to_jax_params

_spec = importlib.util.spec_from_file_location(
    "make_torch_parity_fixture", Path(__file__).parent / "data" / "make_torch_parity_fixture.py")
F = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(F)

N = 1024
RATIOS = (4, 4, 4, 4)
MODEL = dict(feat_len=3, num_points=N, num_knn=16, sub_sampling_ratio=RATIOS,
             d_out=(8, 16, 16, 32), out_feat_dim=16, num_reg_iter=2, fc_norm="none",
             randla_skips="post")


def reference_state(tree, pipeline, seed=0):
    """A reference state_dict in the layout the importers read, with seeded
    values: weights ~ N(0, 1/fan_in), norms' scales near 1, BatchNorm
    running variances in [0.5, 2]."""
    rng = np.random.default_rng(seed)
    sd = {}

    def weight(c_out, c_in, *ones):
        return (rng.normal(size=(c_out, c_in, *ones)) / np.sqrt(c_in)).astype(np.float32)

    def vec(c, around=0.0, spread=0.1):
        return (around + spread * rng.normal(size=c)).astype(np.float32)

    def conv_unit(node, src):
        c_in, c_out = node["Dense_0"]["kernel"].shape
        sd[f"{src}.conv.weight"] = weight(c_out, c_in, 1, 1)
        sd[f"{src}.conv.bias"] = vec(c_out)
        sd[f"{src}.norm.weight"] = vec(c_out, 1.0)
        sd[f"{src}.norm.bias"] = vec(c_out)

    def att_pooling(node, src):
        c_in, c_out = node["Dense_0"]["kernel"].shape
        sd[f"{src}.fc.weight"] = weight(c_out, c_in, 1, 1)
        conv_unit(node["ConvUnit_0"], f"{src}.mlp")

    def mlp_stack(node, src, n_layers):
        for k in range(n_layers):
            c_in, c_out = node[f"ConvUnit_{k}"]["Dense_0"]["kernel"].shape
            sd[f"{src}.{3 * k}.weight"] = weight(c_out, c_in, 1)
            sd[f"{src}.{3 * k}.bias"] = vec(c_out)
            if k < n_layers - 1:
                bn = f"{src}.{3 * k + 1}"
                sd[f"{bn}.weight"], sd[f"{bn}.bias"] = vec(c_out, 1.0), vec(c_out)
                sd[f"{bn}.running_mean"] = vec(c_out, 0.0, 0.5)
                sd[f"{bn}.running_var"] = rng.uniform(0.5, 2.0, c_out).astype(np.float32)
                sd[f"{bn}.num_batches_tracked"] = np.asarray(1000, np.int64)

    def randla(node, src):
        conv_unit(node["mlp_pre"], f"{src}.mlp_pre")
        for i in range(len(RATIOS)):
            enc, s = node[f"enc_{i}"], f"{src}.dilated_res_blocks.{i}"
            for unit in ("mlp1", "mlp2", "mlp_skip"):
                conv_unit(enc[unit], f"{s}.{unit}")
            for unit in ("mlp1", "mlp2"):
                conv_unit(enc["lfa"][unit], f"{s}.lfa.{unit}")
            for pool in ("att_pooling_1", "att_pooling_2"):
                att_pooling(enc["lfa"][pool], f"{s}.lfa.{pool}")
        conv_unit(node["mlp_mid"], f"{src}.mlp_mid")
        for j in range(len(RATIOS)):
            conv_unit(node[f"dec_{j}"], f"{src}.decoder_blocks.{j}")
        c_in, c_out = node["mlp_out"]["kernel"].shape
        sd[f"{src}.mlp_out.weight"] = weight(c_out, c_in, 1, 1)
        mlp_stack(node["fc_label"], f"{src}.fc_label", 3)

    params = tree["params"]
    randla(params["feat_extractor"], "feat_extractor")
    if pipeline != "label":
        for name, n_layers in (("mlp_feat", 3), ("mlp_att", 5), ("mlp_proj", 1)):
            mlp_stack(params[name], name, n_layers)
    if pipeline == "align":
        randla(params["inlier_model"], "inlier_model")
    sd["label_weights"] = rng.uniform(size=19).astype(np.float32)
    return sd


def flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def trees():
    """Each pipeline's params tree in the flax layout, the port's network's
    (`to_jax_params`; the JAX forward below takes the imported tree, so a
    layout JAX's network does not have fails there)."""
    return {p: to_jax_params(Network(ModelConfig(**MODEL), p).state_dict())
            for p in ("align", "feat", "label")}


@pytest.fixture(scope="module")
def checkpoint(trees, tmp_path_factory):
    """The align reference state saved as a reference .pth (a dict with a
    "state_dict" entry, as the reference's checkpoints are)."""
    sd = reference_state(trees["align"], "align")
    path = tmp_path_factory.mktemp("reference") / "align.pth"
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}, "epoch": 7}, path)
    return path, sd


@pytest.mark.parametrize("pipeline", ["align", "feat", "label"])
def test_import_equals_jax_leaf_for_leaf(trees, pipeline):
    sd = reference_state(trees[pipeline], pipeline, seed=1)
    got = flat(torch_import.import_reference_state(sd, pipeline)["params"])
    want = flat(jax_import.import_reference_state(sd, pipeline)["params"])
    assert sorted(got) == sorted(want) == sorted(flat(trees[pipeline]["params"]))
    for key, value in want.items():
        assert got[key].dtype == np.float32
        np.testing.assert_array_equal(got[key], value, err_msg="/".join(key))


def test_load_torch_state_reads_the_saved_checkpoint(checkpoint):
    path, sd = checkpoint
    got = torch_import.load_torch_state(str(path))
    want = jax_import.load_torch_state(str(path))
    assert sorted(got) == sorted(want) == sorted(sd)
    for key, value in sd.items():
        np.testing.assert_array_equal(got[key], value)
        np.testing.assert_array_equal(got[key], want[key])


def _exact_batches(seed):
    """One pair of 1024-point clouds with exact (float64 KNN) pyramids, as
    the port's and JAX's batches."""
    rng = np.random.default_rng(seed)
    pts = {s: rng.normal(size=(1, N, 3)).astype(np.float32) for s in ("src", "ref")}
    gt = np.eye(3, 4, dtype=np.float32)[None]
    pyr = {s: F.exact_pyramid(pts[s], MODEL["num_knn"], RATIOS) for s in ("src", "ref")}

    def port_pyramid(p):
        return Pyramid(*(tuple(torch.from_numpy(np.asarray(a, np.float32 if k == "xyz"
                                                           else np.int64)) for a in field)
                         for k, field in p._asdict().items()))

    def jax_pyramid(p):
        return JaxPyramid(*(tuple(jnp.asarray(np.asarray(a, np.float32 if k == "xyz"
                                                         else np.int32)) for a in field)
                            for k, field in p._asdict().items()))
    port = PairBatch(torch.from_numpy(pts["src"]), torch.from_numpy(pts["ref"]),
                     port_pyramid(pyr["src"]), port_pyramid(pyr["ref"]), torch.from_numpy(gt))
    jbatch = JaxPairBatch(jnp.asarray(pts["src"]), jnp.asarray(pts["ref"]),
                          jax_pyramid(pyr["src"]), jax_pyramid(pyr["ref"]), jnp.asarray(gt))
    return port, jbatch


def test_imported_checkpoint_runs_the_align_forward_as_jax(trees, checkpoint):
    """`import_reference_checkpoint` with the port's fc_norm="none" network
    against JAX's with its params template: the same params, and the align
    forwards over exact pyramids agree (matches equal, transforms 1e-5,
    inlier logits 1e-5 of their scale)."""
    path, _ = checkpoint
    model = Network(ModelConfig(**MODEL))
    state = torch_import.import_reference_checkpoint(str(path), "align", model=model)
    model.load_state_dict(state, strict=True)
    params = jax_import.import_reference_checkpoint(str(path), "align",
                                                    params_template=trees["align"])
    got, want = flat(to_jax_params(state)["params"]), flat(params["params"])
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg="/".join(key))

    batch, jbatch = _exact_batches(2)
    opts = ForwardOptions(num_iter=MODEL["num_reg_iter"], clip_weight=True)
    out = model.eval().forward_align(batch, opts)
    jnet = JaxNetwork(JaxModelConfig(**MODEL), pipeline="align")
    jopts = JaxForwardOptions(num_iter=MODEL["num_reg_iter"], clip_weight=True)
    jout = jax.jit(lambda p, b: jnet.apply(p, b, jopts, train=False)[1])(params, jbatch)
    np.testing.assert_array_equal(out.pred_idx.numpy(), np.asarray(jout.pred_idx))
    np.testing.assert_array_equal(out.invalid.numpy(), np.asarray(jout.invalid))
    np.testing.assert_allclose(out.transforms.detach().numpy(), np.asarray(jout.transforms),
                               rtol=0, atol=1e-5)
    logits = np.asarray(jout.inlier_logits)
    np.testing.assert_allclose(out.inlier_logits.detach().numpy(), logits, rtol=0,
                               atol=1e-5 * np.abs(logits).max())


def test_missing_leftover_and_mismatched_keys_raise(trees, checkpoint, tmp_path):
    path, sd = checkpoint
    missing = {k: v for k, v in sd.items() if k != "mlp_att.3.bias"}
    for importer in (torch_import, jax_import):
        with pytest.raises(KeyError, match="mlp_att.3.bias"):
            importer.import_reference_state(missing, "align")
    extra = dict(sd, **{"mlp_proj.9.weight": np.zeros((4, 4), np.float32)})
    with pytest.raises(ValueError, match="mlp_proj.9.weight"):
        torch_import.import_reference_state(extra, "align")
    with pytest.raises(AssertionError, match="mlp_proj.9.weight"):
        jax_import.import_reference_state(extra, "align")
    # a label checkpoint leaves the align heads' keys over
    with pytest.raises(ValueError, match="unmapped reference keys"):
        torch_import.import_reference_state(sd, "label")
    wider = Network(ModelConfig(**dict(MODEL, out_feat_dim=32)))
    with pytest.raises(ValueError):
        torch_import.import_reference_checkpoint(str(path), "align", model=wider)
