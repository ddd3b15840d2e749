"""The port's command lines, with the JAX package's flags and
--device:

    python -m deepsir_tpu_torch.cli.train <flags>    (train.py's counterpart)
    python -m deepsir_tpu_torch.cli.test <flags>     (test.py's counterpart)
"""
from __future__ import annotations

import torch


def select_device(name: str) -> torch.device:
    """The torch device a command runs on; a CUDA device that is not there
    raises instead of falling back to the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    return device
