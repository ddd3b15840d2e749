"""The label training cell in a whole run on the CPU at a small size, past
the harness's look for a card, with the timed path sound and with it broken
underneath: `correct` must come out true, then false for each fault the
cell can have (Adam's step a no-op, half of each batch left out, the loss
altered by 1%). The limits are the cell's own.

The small size, 2 pairs of 2048 points, reads larger gaps than the cell:
a batch norm's statistics span 66 times fewer rows, and on some seeds one
branch taken differently by float32 rounding (a max-pool choice between two
neighbours within ~1e-6 of each other, a LeakyReLU input near 0) moves a
leaf's first gradient by up to 6e-3 of its norm (2 of 6 seeds at this
size). The seed here, the harness tests' own, reads 1.7e-6. Every fault
moves its number by far more: the gradients by 1%, the change of every
leaf to nothing, the gradient of half a batch."""
import json

import pytest
import torch

from benchmark import harness
import benchmark.run as run_mod

SEED = 3_000_000_113
CELL = "randla-semantickitti.label-train-b3"


@pytest.fixture
def cell():
    c = harness.find_cell(CELL)
    return c._replace(traffic=dict(c.traffic, points=2048, pool=3, batch=2))


def _run(cell, capsys):
    rc = run_mod.main(["--workload", cell.name, "--seed", str(SEED), "--seconds", "1.5",
                       "--trace", "0"], require_gpu=False, cell=cell,
                      device=torch.device("cpu"))
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(out)[-1] == "checks"
    return out


def test_sound(cell, capsys):
    out = _run(cell, capsys)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"train_pairs_per_s", "setup_s"}
    assert out["metrics"]["setup_s"]["value"] > 0


def test_state_unchanged(cell, capsys, monkeypatch):
    """The optimizer's step leaves the parameters and its state as they were."""
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    assert not _run(cell, capsys)["correct"]


def test_half_batch(cell, capsys, monkeypatch):
    """Half of each batch left out, the loss the mean over the rest."""
    from deepsir_tpu_torch import training
    original = training.device_batch

    def half(cfg, arrays, device="cuda"):
        return original(cfg, {k: v[:len(v) // 2] for k, v in arrays.items()}, device)
    monkeypatch.setattr(training, "device_batch", half)
    assert not _run(cell, capsys)["correct"]


def test_answer_altered(cell, capsys, monkeypatch):
    """The loss altered by 1% where it is produced."""
    from deepsir_tpu_torch import training
    original = training.compute_loss

    def altered(*a, **kw):
        loss, aux = original(*a, **kw)
        return loss * 1.01, dict(aux, loss=aux["loss"] * 1.01)
    monkeypatch.setattr(training, "compute_loss", altered)
    assert not _run(cell, capsys)["correct"]
