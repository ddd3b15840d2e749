"""What every run shares: the cell's files found by name, the device, the
checks against their limits, the metrics named in BENCHMARK.json and the
result's last line.

A cell `<config>.<mix>` of BENCHMARK.json reads `configs/<config>.json`
(the model and forward options, as run), `traffic/<mix>.json` (the traffic's
parameters and the name of its driver, `drivers/<driver>.py`) and
`limits/<cell>.json` (the limit of every number compared); a per-layer
metric is the reader `metrics/<metric>.py`. Nothing here lists them.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, NamedTuple, Optional, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / ".bench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "deepsir_tpu")
TUPLE_FIELDS = ("sub_sampling_ratio", "d_out")


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict:
    return load_json(ROOT / "BENCHMARK.json")


class Cell(NamedTuple):
    name: str
    chips: int
    config: Dict             # configs/<config>.json
    traffic: Dict            # traffic/<mix>.json
    limits: Dict[str, float]  # limits/<cell>.json
    end_to_end: List[Dict]   # the end-to-end metrics the cell reports
    per_layer: List[Dict]    # the per-layer metrics the cell reports


def reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, bench: Optional[Dict] = None) -> Cell:
    """The cell `name` of BENCHMARK.json with its files."""
    bench = bench or benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    e2e = [m for m in bench["end_to_end"] if reports(m, name)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return Cell(name, entry["chips"], load_json(HERE / "configs" / f"{entry['config']}.json"),
                load_json(HERE / "traffic" / f"{entry['traffic']}.json"),
                load_json(HERE / "limits" / f"{name}.json"), e2e, layer)


def namespace(model: Dict) -> SimpleNamespace:
    """A configuration's "model" block for the reference."""
    return SimpleNamespace(**model)


def model_config(model: Dict):
    """A configuration's "model" block as the port's ModelConfig."""
    from deepsir_tpu_torch.config import ModelConfig
    return ModelConfig(**{k: tuple(v) if k in TUPLE_FIELDS else v for k, v in model.items()})


def driver(kind: str):
    return importlib.import_module(f"benchmark.drivers.{kind}")


def reader(metric: str):
    """The `read(readings)` function of metrics/<metric>.py."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def reference_shapes(model: Dict, pipeline: str) -> Dict:
    """Parameter name -> shape of the reference network (the port's layout)."""
    import torch
    from benchmark.reference.network import Network, check_supported
    cfg = namespace(model)
    check_supported(cfg)
    with torch.device("meta"):
        net = Network(cfg, pipeline)
    return {n: p.shape for n, p in net.state_dict().items()}


def reference_network(model: Dict, pipeline: str, weights: Dict, device):
    import torch
    from benchmark.reference.network import Network
    with torch.device(device):
        net = Network(namespace(model), pipeline)
    net.load_state_dict(weights, strict=True)
    return net


class Check(NamedTuple):
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit          # NaN fails


def checks(values: Dict[str, float], limits: Dict[str, float]) -> List[Check]:
    """Every number the cell's limits name, beside its limit (a comparison
    may work out more numbers than a cell holds to limits); a limit without
    a number is an error of the cell's files."""
    missing = set(limits) - set(values)
    if missing:
        raise KeyError(f"no number for the limits {sorted(missing)}")
    return [Check(k, float(values[k]), float(limits[k])) for k in sorted(limits)]


def forbidden_modules() -> List[str]:
    """Modules of JAX or of the JAX package this process holds, by whole
    top-level name."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free(device) -> None:
    """Release what the program left in the allocator's cache."""
    import gc
    import torch
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def steady() -> None:
    """Before the window: set-up's objects out of the garbage collector's
    way, so that its passes inside the window stay short."""
    import gc
    gc.collect()
    gc.freeze()


def span(name: str, on: bool = True):
    """A profiler span called `name`, or nothing when `on` is false."""
    import contextlib
    import torch
    return torch.profiler.record_function(name) if on else contextlib.nullcontext()


def tf32(enabled: bool) -> None:
    import torch
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled


class Outcome(NamedTuple):
    """What a driver hands back to the harness."""
    attempted: int
    failed: int
    values: Dict[str, float]          # end-to-end metrics the driver measured
    compared: Dict[str, float]        # the numbers held against the limits
    memory_peak_bytes: int
    readings: Optional[object] = None  # profiling.Readings of a traced run


def result(cell: Cell, outcome: Outcome, setup_s: float, device: Dict, trace: bool) -> Tuple[Dict, List[Check]]:
    """The result's last line as a dict, and the checks."""
    from benchmark import profiling
    held = checks(outcome.compared, cell.limits)
    correct = outcome.failed == 0 and all(c.ok for c in held)
    out = {"correct": correct, "attempted": outcome.attempted, "failed": outcome.failed}
    metrics = {}
    if trace:
        r = outcome.readings
        for m in cell.per_layer:
            value = reader(m["name"])(r)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        lo, hi = r.window
        _, gaps = r.every.busy(lo, hi)
        device = dict(device, busy_s=r.busy_us * 1e-6, window_s=r.window_s)
        out["metrics"], out["device"] = metrics, device
        out["breakdown"] = profiling.breakdown(r.every, lo, hi, gaps)
    else:
        values = dict(outcome.values, setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        out["metrics"], out["device"] = metrics, device
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in held}
    return out, held
