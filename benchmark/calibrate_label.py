"""The readings that the limits of a label training cell (driver
`label_train`) are set from, on the card at the cell's own size, all in one
process; `calibrate.py`'s lines for the cells it cannot reach:

    python3 benchmark/calibrate_label.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 [--seconds 4] [--out calibrate.jsonl]

For each `--seeds` seed, a run of the cell as `run.py` makes it (a short
window; the set-up steps are compared), which gives the program's numbers.
For each `--control-seeds` seed, the control (the reference with TF32 on,
the nearest precision below the configuration's fp32 with TF32 off) and the
fault "half of each batch left out" (`drivers/label_train.py::control`),
each against the fp32 reference. Each reading is a JSON line; the last
gives each number's largest program reading and smallest control and
fault readings.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == ROOT / "benchmark":
    sys.path[0] = str(ROOT)


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
    from benchmark.drivers import label_train
    from benchmark.run import Run
    cell = harness.find_cell(args.workload)
    if cell.traffic["driver"] != "label_train":
        raise SystemExit(f"{cell.name} is not a label_train cell: use benchmark/calibrate.py")
    device = device or torch.device("cuda", 0)
    lines = []

    def emit(side, seed, numbers, **extra):
        line = dict(cell=cell.name, side=side, seed=seed, numbers=numbers, **extra)
        lines.append(line)
        print(json.dumps(line), flush=True)

    for seed in [int(s) for s in args.seeds.split(",") if s]:
        t0 = time.perf_counter()
        outcome = label_train.run(Run(cell, seed, args.seconds, False, device))
        emit("program", seed, outcome.compared, failed=outcome.failed,
             seconds=time.perf_counter() - t0, memory_peak_bytes=outcome.memory_peak_bytes)
        harness.free(device)
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        t0 = time.perf_counter()
        emit("control", seed, label_train.control(cell, seed, device),
             seconds=time.perf_counter() - t0)
        emit("fault_half_batch", seed, label_train.control(cell, seed, device, half=True))
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
