"""Run one cell of BENCHMARK.json once and print its result as the last line
of standard output:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the repository root, on a machine with the cell's NVIDIA GPUs. The
run makes the cell's weights and inputs from the seed, warms up, measures
for the given seconds (with `--trace 1` the cell's per-layer metrics from a
profiled stretch of the window instead of its end-to-end metrics), checks
what the window produced against the plain reference, and prints the
numbers compared beside their limits as its last lines on standard error.
It exits with a code other than 0, and prints no result, without the GPUs
the cell asks for, when the port cannot be imported, or when the process
holds JAX or the JAX package once the window has closed.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".bench_cache"
# every build and kernel cache at a fixed path inside the checkout; one
# thread for the host's math
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
os.environ.setdefault("OMP_NUM_THREADS", "1")
if sys.path and Path(sys.path[0]).resolve() == ROOT / "benchmark":
    sys.path[0] = str(ROOT)
else:
    sys.path.insert(0, str(ROOT))


class Run:
    """One run of one cell: what its driver reads, and its clock."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool, device):
        self.cell, self.seed, self.seconds, self.trace, self.device = \
            cell, seed, seconds, trace, device
        self.setup_s = None

    def window_started(self, t: float) -> None:
        self.setup_s = t - T0

    def log_phase(self, what: str) -> None:
        """Set-up's clock so far, on standard error."""
        self.log(f"set-up {time.perf_counter() - T0:.3f} s: {what}")

    @staticmethod
    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)


def _finite(x):
    return x if isinstance(x, (int, bool)) or math.isfinite(x) else str(x)


def main(argv=None, require_gpu: bool = True, cell=None, device=None) -> int:
    """Parse the command line, run the cell, print the result; the return
    value is the exit code. Tests pass `require_gpu=False` with a `cell`
    and a `device` of their own."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch
    from benchmark import harness

    cell = cell or harness.find_cell(args.workload)
    if require_gpu:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            Run.log(f"{cell.name} needs {cell.chips} CUDA device(s); "
                    f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2
        device = torch.device("cuda", 0)
    import deepsir_tpu_torch  # noqa: F401  (sets the port's precision switches)
    torch.set_num_threads(1)
    run = Run(cell, args.seed, args.seconds, bool(args.trace), device)
    if device.type == "cuda":
        torch.cuda.init()
    run.log_phase("torch and the device")
    outcome = harness.driver(cell.traffic["driver"]).run(run)
    found = harness.forbidden_modules()
    if found:
        Run.log(f"the process holds JAX or the JAX package: {found}")
        return 3
    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": cell.chips, "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    out, held = harness.result(cell, outcome, run.setup_s, info, run.trace)
    for c in held:
        out["checks"][c.name] = {"value": _finite(c.value), "limit": c.limit}
    Run.log(f"setup_s {run.setup_s:.3f}; attempted {out['attempted']}, failed {out['failed']}, "
            f"correct {out['correct']}")
    for c in held:
        Run.log(f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
