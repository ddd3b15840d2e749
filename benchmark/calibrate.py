"""The readings that the limits of `limits/<cell>.json` are set from, on the
card at the cell's own size, all in one process:

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 [--seconds 4] [--out chiprun_out/calibrate.jsonl]

For each `--seeds` seed, a run of the cell as `run.py` makes it (a short
window at the cell's own load; training cells compare their set-up steps),
which gives the program's numbers. For each `--control-seeds` seed, the
control: the reference put in the program's place and computed with TF32
on (the nearest precision below the configuration's fp32 with TF32 off),
held against the fp32 reference by the same comparison; and, for a training
cell of more than one pair, the fault "half of the batch left out, the mean
taken over the rest", the reference trained on the first half of each
batch. The benchmark's own runs never run these. Each reading is a JSON
line; the last lines give each number's largest program reading and
smallest control and fault readings.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == ROOT / "benchmark":
    sys.path[0] = str(ROOT)


def control_eval(cell, seed, device):
    """The TF32 reference against the fp32 reference on the batches a run of
    this seed checks."""
    import numpy as np
    from benchmark import compare, harness, inputs
    from benchmark.drivers import eval as drv
    t, model_cfg = cell.traffic, cell.config["model"]
    weights = inputs.make_weights(harness.reference_shapes(model_cfg, "align"), seed, device)
    pool = inputs.make_pool(seed, t["pool"], t["batch"], t["points"], model_cfg["feat_len"])
    checked = np.random.default_rng(seed).choice(t["pool"], t["check_batches"], replace=False)
    numbers = []
    for p in sorted(checked.tolist()):
        harness.tf32(True)
        low = drv.reference_side(model_cfg, cell.config["forward"], weights, pool[p], device)
        harness.tf32(False)
        want = drv.reference_side(model_cfg, cell.config["forward"], weights, pool[p], device)
        numbers.append(compare.registration(low, want))
    return compare.worst(numbers)


def control_train(cell, seed, device, half: bool = False):
    """The TF32 reference (or, with `half`, the fp32 reference on the first
    half of each batch) against the fp32 reference through the set-up steps."""
    from benchmark import compare, harness, inputs
    from benchmark.drivers import train as drv
    t, model_cfg = cell.traffic, cell.config["model"]
    weights = inputs.make_weights(harness.reference_shapes(model_cfg, t["pipeline"]), seed, device)
    pool = inputs.make_pool(seed, t["pool"], t["batch"], t["points"], model_cfg["feat_len"])
    harness.tf32(False)
    want = drv.reference_steps(model_cfg, t, weights, pool, seed, device)
    if half:
        cut = [{k: v[:t["batch"] // 2] for k, v in arrays.items()} for arrays in pool]
        low = drv.reference_steps(model_cfg, t, weights, cut, seed, device)
    else:
        harness.tf32(True)
        low = drv.reference_steps(model_cfg, t, weights, pool, seed, device)
        harness.tf32(False)
    return compare.training(low, want)


def main(argv=None, device=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch
    import deepsir_tpu_torch  # noqa: F401
    from benchmark import harness
    from benchmark.run import Run
    cell = harness.find_cell(args.workload)
    device = device or torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    kind = cell.traffic["driver"]
    lines = []

    def emit(side, seed, numbers, **extra):
        line = dict(cell=cell.name, side=side, seed=seed, numbers=numbers, **extra)
        lines.append(line)
        print(json.dumps(line), flush=True)

    for seed in seeds:
        t0 = time.perf_counter()
        run = Run(cell, seed, args.seconds, False, device)
        outcome = harness.driver(kind).run(run)
        emit("program", seed, outcome.compared, failed=outcome.failed,
             seconds=time.perf_counter() - t0)
        harness.free(device)
    for seed in controls:
        t0 = time.perf_counter()
        if kind == "eval":
            emit("control", seed, control_eval(cell, seed, device),
                 seconds=time.perf_counter() - t0)
        else:
            emit("control", seed, control_train(cell, seed, device),
                 seconds=time.perf_counter() - t0)
            if cell.traffic["batch"] > 1:
                emit("fault_half_batch", seed, control_train(cell, seed, device, half=True))
        harness.free(device)
    summary = {}
    for line in lines:
        for k, v in line["numbers"].items():
            s = summary.setdefault(k, {})
            agg = max if line["side"] == "program" else min
            s[line["side"]] = agg(s.get(line["side"], v), v)
    print(json.dumps({"cell": cell.name, "summary": summary}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            for line in lines + [{"cell": cell.name, "summary": summary}]:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
