"""PyTorch/CUDA port of deepsir_tpu: point-cloud registration on an NVIDIA H100.

The JAX package `deepsir_tpu` beside this one is the reference; this package
mirrors its layout module by module and imports nothing from it (nor JAX,
flax, optax or msgpack). Its hand-written CUDA kernels live in `csrc/` and are
built with plain `nvcc` at first use (`ops/_build.py`).

Precision: fp32 throughout. TF32 is switched off for matmuls and cuDNN here,
because reduced-mantissa matmuls wrecked the descriptor correspondence search
on the reference's accelerator.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
