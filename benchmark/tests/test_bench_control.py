"""The control on the card, at a size a test run holds: the reference put
in the program's place and computed with TF32 on, the nearest precision
below the configurations' fp32 with TF32 off, must fail at least one of
each cell's limits. `benchmark/calibrate.py` reads the same at the cells'
own sizes."""
import pytest

from benchmark import calibrate, harness

SEEDS = (3_000_000_201, 3_000_000_203, 3_000_000_209)


def _small(name):
    cell = harness.find_cell(name)
    t = dict(cell.traffic, points=4096, pool=2, batch=min(2, cell.traffic["batch"]))
    if t["driver"] == "eval":
        t["check_batches"] = 1
    return cell._replace(traffic=t)


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in harness.benchmark()["workloads"]])
@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails(card, name, seed):
    cell = _small(name)
    if cell.traffic["driver"] == "eval":
        numbers = calibrate.control_eval(cell, seed, card)
    else:
        numbers = calibrate.control_train(cell, seed, card)
    failed = [c.name for c in harness.checks(numbers, cell.limits) if not c.ok]
    assert failed, numbers
