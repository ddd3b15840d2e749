"""PyTorch/CUDA port of deepsir_tpu: point-cloud registration on an NVIDIA H100.

The JAX package `deepsir_tpu` beside this one is the reference; this package
mirrors its layout module by module and imports nothing from it (nor JAX,
flax, optax or msgpack). Its hand-written CUDA kernels live in `csrc/` and are
built with plain `nvcc` at first use (`ops/_build.py`).

Precision: fp32 by default. TF32 is switched off for matmuls and cuDNN here,
because reduced-mantissa matmuls wrecked the descriptor correspondence search
on the reference's accelerator. Under the bf16 compute options
(`ModelConfig.compute_dtype`, `inlier_compute_dtype`) a Dense product takes
bf16 operands and sums in fp32, as flax's bf16 `Dense` does: cuBLAS's
reduced-precision reduction of bf16 GEMMs is switched off here too.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
