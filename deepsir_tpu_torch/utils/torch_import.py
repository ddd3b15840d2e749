"""Import of a reference-trained PyTorch checkpoint
(deepsir_tpu/utils/torch_import.py).

Maps a reference DeepSIR `state_dict` (the reference repo's
network/model.py and network/RandLANet.py layout) onto the parameters of a
port `Network` built with `fc_norm="none"` and `randla_skips="post"`:
- a 1x1 Conv1d/Conv2d or Linear weight (out, in[, 1[, 1]]) becomes a flax
  Dense kernel (in, out), i.e. the port's Linear weight (out, in);
- the backbone's MLP2D norm is GroupNorm in both: scale and bias map 1:1;
- the FC stacks (fc_label, mlp_feat, mlp_att, mlp_proj) use BatchNorm1d in
  the reference. In eval mode it is a frozen per-channel affine, folded
  into the preceding conv's weight and bias, so the result is exact for
  inference (the reference's own model.eval()), not for resuming training.

In the reference's MLP(channels, do_bn=True), layer k's conv sits at
Sequential index 3k and its BatchNorm at 3k + 1 for every layer but the
last. The tree is built in the JAX package's flax layout and mapped to the
port's state_dict keys through `utils.params`.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from deepsir_tpu_torch.utils.params import from_jax_params, nest_tree

_BN_EPS = 1e-5      # torch BatchNorm1d's default


def load_torch_state(path: str) -> Dict[str, np.ndarray]:
    """A reference .pth as {key: np.ndarray}, loaded on the CPU with
    `weights_only` (no code objects); a checkpoint dict's "state_dict"
    entry if it has one."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    state = payload.get("state_dict", payload)
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v) for k, v in state.items()}


def _dense_kernel(w: np.ndarray) -> np.ndarray:
    w = np.asarray(w)
    while w.ndim > 2:
        if w.shape[-1] != 1:
            raise ValueError(f"not a 1x1 conv: {w.shape}")
        w = w[..., 0]
    return np.ascontiguousarray(w.T)


def _fold_bn(kernel: np.ndarray, bias: np.ndarray, sd, prefix: str
             ) -> Tuple[np.ndarray, np.ndarray]:
    """An eval-mode BatchNorm, y = gamma (x - mean) / sqrt(var + eps) + beta,
    folded into the Dense before it: kernel s and (bias - mean) s + beta
    with s = gamma / sqrt(var + eps)."""
    s = sd[f"{prefix}.weight"] / np.sqrt(sd[f"{prefix}.running_var"] + _BN_EPS)
    return kernel * s[None, :], (bias - sd[f"{prefix}.running_mean"]) * s + sd[f"{prefix}.bias"]


class _Mapper:
    def __init__(self, sd: Dict[str, np.ndarray]):
        self.sd = sd
        self.out: Dict[Tuple[str, ...], np.ndarray] = {}
        self.used = set()

    def _get(self, key: str) -> np.ndarray:
        self.used.add(key)
        return self.sd[key]

    def conv_unit(self, dst: Tuple[str, ...], src: str) -> None:
        """MLP2D, conv + GroupNorm (+ act) -> ConvUnit."""
        self.out[dst + ("Dense_0", "kernel")] = _dense_kernel(self._get(f"{src}.conv.weight"))
        self.out[dst + ("Dense_0", "bias")] = self._get(f"{src}.conv.bias")
        self.out[dst + ("GroupNorm_0", "scale")] = self._get(f"{src}.norm.weight")
        self.out[dst + ("GroupNorm_0", "bias")] = self._get(f"{src}.norm.bias")

    def att_pooling(self, dst: Tuple[str, ...], src: str) -> None:
        """Att_pooling, a score conv without bias + MLP2D."""
        self.out[dst + ("Dense_0", "kernel")] = _dense_kernel(self._get(f"{src}.fc.weight"))
        self.conv_unit(dst + ("ConvUnit_0",), f"{src}.mlp")

    def mlp_stack(self, dst: Tuple[str, ...], src: str, n_layers: int) -> None:
        """The reference's MLP/FC helper: BatchNorm folded into the conv of
        every layer but the last, which has no norm or activation."""
        for k in range(n_layers):
            kern = _dense_kernel(self._get(f"{src}.{3 * k}.weight"))
            bias = self._get(f"{src}.{3 * k}.bias")
            if k < n_layers - 1:
                self.used.update(f"{src}.{3 * k + 1}.{p}" for p in
                                 ("weight", "bias", "running_mean", "running_var",
                                  "num_batches_tracked"))
                kern, bias = _fold_bn(kern, bias, self.sd, f"{src}.{3 * k + 1}")
            unit = dst + (f"ConvUnit_{k}",)
            self.out[unit + ("Dense_0", "kernel")] = kern
            self.out[unit + ("Dense_0", "bias")] = bias

    def randla(self, dst: Tuple[str, ...], src: str, num_layers: int,
               num_label_layers: int = 3) -> None:
        """One RandLA backbone."""
        self.conv_unit(dst + ("mlp_pre",), f"{src}.mlp_pre")
        for i in range(num_layers):
            d, s = dst + (f"enc_{i}",), f"{src}.dilated_res_blocks.{i}"
            for unit in ("mlp1", "mlp2", "mlp_skip"):
                self.conv_unit(d + (unit,), f"{s}.{unit}")
            for unit in ("mlp1", "mlp2"):
                self.conv_unit(d + ("lfa", unit), f"{s}.lfa.{unit}")
            for pool in ("att_pooling_1", "att_pooling_2"):
                self.att_pooling(d + ("lfa", pool), f"{s}.lfa.{pool}")
        self.conv_unit(dst + ("mlp_mid",), f"{src}.mlp_mid")
        for j in range(num_layers):
            self.conv_unit(dst + (f"dec_{j}",), f"{src}.decoder_blocks.{j}")
        self.out[dst + ("mlp_out", "kernel")] = _dense_kernel(self._get(f"{src}.mlp_out.weight"))
        self.mlp_stack(dst + ("fc_label",), f"{src}.fc_label", num_label_layers)


def import_reference_state(sd: Dict[str, np.ndarray], pipeline: str,
                           num_layers: int = 4) -> Dict:
    """A reference state_dict as the JAX package's `{"params": tree}` (float32
    numpy leaves), for a Network built with `fc_norm="none"`.

    A missing source key raises KeyError; a source key left over (other than
    a `num_batches_tracked` or the frozen `label_weights` buffer) raises
    ValueError, so a partial import cannot pass silently.
    """
    m = _Mapper(sd)
    m.randla(("feat_extractor",), "feat_extractor", num_layers)
    if pipeline != "label":
        m.mlp_stack(("mlp_feat",), "mlp_feat", 3)
        m.mlp_stack(("mlp_att",), "mlp_att", 5)
        m.mlp_stack(("mlp_proj",), "mlp_proj", 1)
    if pipeline == "align":
        m.randla(("inlier_model",), "inlier_model", num_layers)
    leftovers = [k for k in sd if k not in m.used
                 and not k.endswith("num_batches_tracked") and k != "label_weights"]
    if leftovers:
        raise ValueError(f"unmapped reference keys: {leftovers[:8]}")
    return {"params": nest_tree({k: np.asarray(v, dtype=np.float32) for k, v in m.out.items()})}


def import_reference_checkpoint(path: str, pipeline: str, model: Optional[torch.nn.Module] = None,
                                num_layers: int = 4):
    """Load and map a reference .pth (`import_reference_state`). Given
    `model`, a port Network built with `fc_norm="none"` (the JAX function's
    `params_template`), the tree is checked against the model's own
    parameters, the same keys and shapes or ValueError, and returned as its
    state_dict; otherwise the `{"params": tree}` is returned."""
    params = import_reference_state(load_torch_state(path), pipeline, num_layers)
    return params if model is None else from_jax_params(params, model)
