"""Multi-process runtime entry point (deepsir_tpu/parallel/distributed.py).

One process runs per card. `initialize_from_env` starts the default
`torch.distributed` process group when the environment asks for it, with
the variables the JAX package reads, so the same training command works on
one card (no variables, nothing happens) and on several (one block of
variables per process):

    DEEPSIR_COORDINATOR=host0:8476 \
    DEEPSIR_NUM_PROCESSES=2 DEEPSIR_PROCESS_ID=0 python -m deepsir_tpu_torch.cli.train ...

The coordinator's address is a `tcp://` rendezvous. Under `torchrun` set
DEEPSIR_DISTRIBUTED=1 instead: the group then starts from the variables
torchrun sets (`env://`: MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK), the
counterpart of JAX's pod autodetection. The process takes card
`process_id % torch.cuda.device_count()` before the group starts. The
backend follows the device: NCCL for CUDA (a CUDA run never drops to gloo;
NCCL that does not start raises), gloo for the CPU.
"""
from __future__ import annotations

import logging
import os

import torch
import torch.distributed as dist

_logger = logging.getLogger(__name__)


def initialize_from_env(device="cuda") -> bool:
    """Start the process group if the environment requests it.

    Returns True when running multi-process (the group is up), False for
    plain single-process runs. Idempotent: with the group up, a second call
    changes nothing.
    """
    coord = os.environ.get("DEEPSIR_COORDINATOR")
    if coord is None and not os.environ.get("DEEPSIR_DISTRIBUTED"):
        return False
    if dist.is_initialized():
        return True
    if coord is not None:
        world = int(os.environ["DEEPSIR_NUM_PROCESSES"])
        rank = int(os.environ["DEEPSIR_PROCESS_ID"])
        init = coord if "://" in coord else f"tcp://{coord}"
    else:
        world, rank, init = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]), "env://"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA process group needs a CUDA device")
        if not dist.is_nccl_available():
            raise RuntimeError("this torch build has no NCCL; a CUDA run does not fall back "
                               "to gloo")
        local = rank % torch.cuda.device_count()
        torch.cuda.set_device(local)
        backend, probe = "nccl", torch.ones(1, device=torch.device("cuda", local))
    elif device.type == "cpu":
        backend, probe = "gloo", torch.ones(1)
    else:
        raise ValueError(f"no process group backend for device {device}")
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank)
    # NCCL starts its communicator at the first collective: start it here,
    # so that a failure raises now
    dist.all_reduce(probe)
    _logger.info("distributed runtime up: process %d/%d, backend %s", rank, world, backend)
    return True
