"""The benchmark of deepsir_tpu_torch, the PyTorch and CUDA port, on NVIDIA
GPUs: `python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` from the repository root (README.md)."""
