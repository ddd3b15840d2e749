"""The label training cell's control and its half-batch fault on the card,
at a size a test run holds, through the harness's own comparison: the
reference computed with TF32 on (the nearest precision below the
configuration's fp32 with TF32 off), and the fp32 reference with half of
each batch left out, each put in the program's place, must fail at least
one of the cell's limits. `benchmark/calibrate_label.py` reads the same at
the cell's own size."""
import pytest

from benchmark import harness
from benchmark.drivers import label_train

CELL = "randla-semantickitti.label-train-b3"
SEEDS = (3_000_000_201, 3_000_000_203, 3_000_000_209)


def _small():
    cell = harness.find_cell(CELL)
    return cell._replace(traffic=dict(cell.traffic, points=4096, pool=2, batch=2))


@pytest.mark.card
@pytest.mark.parametrize("half", [False, True], ids=["tf32", "half_batch"])
@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails(card, seed, half):
    cell = _small()
    numbers = label_train.control(cell, seed, card, half=half)
    failed = [c.name for c in harness.checks(numbers, cell.limits) if not c.ok]
    assert failed, numbers
