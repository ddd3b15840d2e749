"""A whole run on the CPU at a small size, past the harness's look for a
card, with the timed path sound and with it broken underneath: `correct`
must come out true, then false for each fault the cell can have. The
limits are the cells' own."""
import json

import pytest
import torch

from benchmark import harness
import benchmark.run as run_mod

SEED = 3_000_000_113


def _small(name, **traffic):
    cell = harness.find_cell(name)
    t = dict(cell.traffic, points=512, pool=2, **traffic)
    if "loss" in t:
        t["loss"] = dict(t["loss"], circle_loss_tile=128)
    if t["driver"] == "eval":
        t.update(check_batches=2, profile_batches=1)
    return cell._replace(traffic=t)


def _run(cell, capsys):
    rc = run_mod.main(["--workload", cell.name, "--seed", str(SEED), "--seconds", "1.5",
                       "--trace", "0"], require_gpu=False, cell=cell,
                      device=torch.device("cpu"))
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(out)[-1] == "checks"
    return out


@pytest.fixture
def eval_cell():
    return _small("deepsir-flagship.eval-b16", batch=2)


def test_eval_sound(eval_cell, capsys):
    out = _run(eval_cell, capsys)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"pairs_per_s", "pair_latency_p95_ms", "setup_s"}


def _patch_forward(monkeypatch, change):
    from deepsir_tpu_torch.models.network import Network
    original = Network.forward_align

    def broken(self, batch, opts, *a, **kw):
        return change(self, original, batch, opts, *a, **kw)

    monkeypatch.setattr(Network, "forward_align", broken)


def test_eval_state_unchanged(eval_cell, capsys, monkeypatch):
    """The loop hands back the pose it started from."""
    def change(self, original, batch, opts, *a, **kw):
        out = original(self, batch, opts, *a, **kw)
        eye = torch.eye(3, 4).expand_as(out.transforms).contiguous()
        return out._replace(transforms=eye)
    _patch_forward(monkeypatch, change)
    assert not _run(eval_cell, capsys)["correct"]


def test_eval_half_batch(eval_cell, capsys, monkeypatch):
    """Half of the batch left out: its pairs get the other half's answers."""
    def change(self, original, batch, opts, *a, **kw):
        out = original(self, batch, opts, *a, **kw)
        h = out.transforms.shape[1] // 2
        t = out.transforms.clone()
        t[:, h:] = t[:, :h]
        return out._replace(transforms=t)
    _patch_forward(monkeypatch, change)
    assert not _run(eval_cell, capsys)["correct"]


def test_eval_answer_altered(eval_cell, capsys, monkeypatch):
    """One pair's last transform moved by 0.05 where it is produced."""
    def change(self, original, batch, opts, *a, **kw):
        out = original(self, batch, opts, *a, **kw)
        t = out.transforms.clone()
        t[-1, 0, 0, 3] += 0.05
        return out._replace(transforms=t)
    _patch_forward(monkeypatch, change)
    assert not _run(eval_cell, capsys)["correct"]


TRAIN_CELLS = ["deepsir-default.feat-train-b1", "deepsir-default.align-train-b4"]


@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_train_sound(name, capsys):
    cell = _small(name, batch=2)
    out = _run(cell, capsys)
    assert out["correct"] and out["failed"] == 0
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(m["value"] > 0 for m in out["metrics"].values())


@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_train_state_unchanged(name, capsys, monkeypatch):
    """The optimizer's step leaves the parameters and its state as they were."""
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    assert not _run(_small(name, batch=2), capsys)["correct"]


def test_train_half_batch(capsys, monkeypatch):
    """Half of the batch left out, the loss the mean over the rest."""
    from deepsir_tpu_torch import training
    original = training.device_batch

    def half(cfg, arrays, device="cuda"):
        return original(cfg, {k: v[:len(v) // 2] for k, v in arrays.items()}, device)
    monkeypatch.setattr(training, "device_batch", half)
    assert not _run(_small("deepsir-default.align-train-b4", batch=2), capsys)["correct"]


@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_train_answer_altered(name, capsys, monkeypatch):
    """The loss altered by 1% where it is produced."""
    from deepsir_tpu_torch import training
    original = training.compute_loss

    def altered(*a, **kw):
        loss, aux = original(*a, **kw)
        return loss * 1.01, dict(aux, loss=aux["loss"] * 1.01)
    monkeypatch.setattr(training, "compute_loss", altered)
    assert not _run(_small(name, batch=2), capsys)["correct"]
