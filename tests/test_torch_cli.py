"""The port's command lines on the CPU (--device cpu) against the JAX package's:

- `cli.test` on the tracked staged eval command, first 4 pairs, held
  to JAX's test.py (tests/data/torch_parity_cli.npz) by
  chip_smoke.cli_eval's rules: success flags equal on every pair whose
  forward held every iteration, held transforms within 1e-3;
- --transform_file on JAX's stored transforms: every iteration's metrics
  against JAX's evaluate_align (success equal; chip_smoke.EVAL_METRIC_TOL);
- the refiner commands on 3 pairs (chip_smoke.cli_refiners: success flags,
  refined poses within chip_smoke.EVAL_POSE_TOL by pose_gap);
- `cli.train --dev` for align (2 steps), label and feat (1 step each):
  its config.json is JAX's prepare_logger's for the same flags, byte for
  byte, and JAX's test.py helpers (create_train_state, CheckPointManager)
  read its checkpoint back bit for bit;
- validation's scores, both as `python -m` modules, the step
  tracer, the summaries' file format and the debug mode.
"""
import torch_workers  # noqa: F401  (torch's threads under xdist)
import json
import os
import shlex
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from flax import serialization
from flax.traverse_util import flatten_dict

import chip_smoke
from deepsir_tpu import config as jax_config
from deepsir_tpu.training import create_train_state
from deepsir_tpu.utils.checkpoint import CheckPointManager as JaxManager
from deepsir_tpu_torch.cli import test as cli_test
from deepsir_tpu_torch.cli import train as cli_train
from deepsir_tpu_torch.utils.checkpoint import read_params

CPU = torch.device("cpu")


def test_test_command_against_jax(tmp_path):
    launches, record = chip_smoke.cli_eval(torch, CPU, tmp_path, pairs=4)
    assert record["held_all_iterations"] >= 3 and not record["succ_differs_on_held"]
    assert record["artifacts"] == chip_smoke.CLI_ARTIFACTS
    assert launches == dict.fromkeys(chip_smoke.COUNTED, 0)     # plain versions on the CPU


def test_transform_file_against_jax(tmp_path):
    _, record = chip_smoke.cli_transform_file(torch, CPU, tmp_path, pairs=16)
    assert record["pairs"] == 16


def test_refiner_commands_against_jax(tmp_path):
    _, record = chip_smoke.cli_refiners(torch, CPU, tmp_path, pairs=3)
    assert set(record) == {"finetune", "average3", "icp"}
    assert all(any(r["held"]) for r in record.values())


def test_derive_save_path():
    def path(*argv):
        cfg = jax_config.config_from_args(jax_config.eval_argument_parser().parse_args(argv))
        return cli_test.derive_save_path(cfg)
    assert path("--resume", "logs/260817_191109_align/ckpt/model_best.msgpack") == \
        "./out/260817_191109_best"
    assert path("--resume", "ckpt/last.msgpack", "--eval_save_path", "e") == "e/last"
    assert path() == "./out/random_init"


TRAIN = {"align": (chip_smoke.CKPT_RUN, "16"), "label": (chip_smoke.STAGE_RUNS["label"], "8"),
         "feat": (chip_smoke.STAGE_RUNS["feat"], "8")}


@pytest.mark.parametrize("pipeline", list(TRAIN))
def test_train_command_dev_run_reads_back_in_jax(tmp_path, pipeline):
    run, pairs = TRAIN[pipeline]
    argv = chip_smoke._rooted(chip_smoke.tracked_command(run)) + [
        "--dev", "--max_epochs", "1", "--synthetic_train_size", pairs, "-v", "0",
        "--logdir", str(tmp_path)]
    log_path = Path(cli_train.main(argv + ["--device", "cpu"]))
    assert log_path == tmp_path / "logdev"
    steps = int(pairs) // 8
    assert (log_path / "ckpt" / "checkpoints.txt").read_text().splitlines() == \
        [f"model_{steps}.msgpack", f"Best step: {steps}"]
    cfg = jax_config.config_from_args(jax_config.train_argument_parser().parse_args(argv))
    assert (log_path / "config.json").read_text() == \
        json.dumps(__import__("dataclasses").asdict(cfg), indent=2, default=str)
    command = (log_path / "log.txt").read_text().split("Command: ", 1)[1].splitlines()[0]
    assert shlex.split(command)[1:] == argv + ["--device", "cpu"]
    # test.py's way in: a TrainState from create_train_state (its tree does
    # not depend on the cloud size) and CheckPointManager.load
    small = jax_config.replace(cfg, model=jax_config.replace(cfg.model, num_points=256))
    rng = np.random.default_rng(0)
    example = {"points_src": rng.normal(size=(1, 256, 3)).astype(np.float32),
               "points_ref": rng.normal(size=(1, 256, 3)).astype(np.float32),
               "transform_gt": np.eye(3, 4, dtype=np.float32)[None]}
    if pipeline == "label":
        example |= {k: np.ones((1, 256), np.int32) for k in ("labels_src", "labels_ref")}
    _, template = create_train_state(small, example, seed=0)
    ckpt = str(log_path / "ckpt" / "model_best.msgpack")
    state, step = JaxManager(str(log_path / "ckpt")).load(ckpt, template)
    assert step == steps
    got = flatten_dict(serialization.to_state_dict(jax.device_get(state.params)))
    want = flatten_dict(read_params(ckpt))
    assert got.keys() == want.keys()
    for key, value in want.items():
        assert np.array_equal(np.asarray(got[key]), value), key


def test_validate_scores(tmp_path):
    """validate() of each pipeline on 4 synthetic pairs: align's success rate
    and its two meshes, label's mIoU, feat's negative loss."""
    import logging
    from deepsir_tpu_torch.config import config_from_args, train_argument_parser
    from deepsir_tpu_torch.data.base import Loader
    from deepsir_tpu_torch.data.synthetic import SyntheticPairs
    from deepsir_tpu_torch.utils.checkpoint import load_checkpoint
    from deepsir_tpu_torch.utils.summary import SummaryWriter
    writer = SummaryWriter(str(tmp_path))
    for pipeline, (run, _) in TRAIN.items():
        argv = chip_smoke._rooted(chip_smoke.tracked_command(run)) + ["-bs", "2"]
        cfg = config_from_args(train_argument_parser().parse_args(argv))
        model = load_checkpoint(cfg.model, run / "ckpt", device="cpu", pipeline=pipeline)
        loader = Loader(SyntheticPairs(cfg, "val", size=4), 2, shuffle=False, drop_last=True)
        score = cli_train.validate(cfg, model, loader, logging.getLogger("val"),
                                   cli_train.make_validate_step(cfg, model), writer=writer,
                                   step=3)
        assert np.isfinite(score)
        if pipeline == "feat":
            assert score < 0
        else:
            assert 0.0 <= score <= 1.0
    meshes = sorted(p.name for p in (tmp_path / "meshes").iterdir())
    assert meshes == ["val_alignment_random_3.npz", "val_alignment_worst_3.npz"]
    mesh = np.load(tmp_path / "meshes" / meshes[0])
    assert mesh["vertices"].shape == (1, 2048, 3) and mesh["colors"].shape == (1, 2048, 3)


def test_both_commands_run_as_modules(tmp_path):
    seconds = chip_smoke.cli_commands(CPU, tmp_path)
    assert set(seconds) == {"test", "train"}


def test_step_tracer_summaries_and_debug_mode(tmp_path, monkeypatch):
    """StepTracer traces exactly its window of steps (DEEPSIR_PROFILE names
    the directory) and writes one Chrome trace; SummaryWriter's JSON lines;
    enable_debug_mode turns on autograd's anomaly detection."""
    from deepsir_tpu_torch.utils.profiling import StepTracer, enable_debug_mode
    from deepsir_tpu_torch.utils.summary import SummaryWriter
    monkeypatch.setenv("DEEPSIR_PROFILE", str(tmp_path / "trace"))
    tracer = StepTracer(start=1, num_steps=2)
    active = []
    for step in range(4):
        with tracer.maybe_trace(step) as on:
            active.append(on)
            torch.ones(8).sum()
    assert active == [False, True, True, False]
    assert [p.name for p in (tmp_path / "trace").iterdir()] == ["trace_steps_1.json"]
    monkeypatch.delenv("DEEPSIR_PROFILE")
    with StepTracer(start=0).maybe_trace(0) as on:
        assert not on
    writer = SummaryWriter(str(tmp_path / "train"))
    writer.add_scalar("losses/mae_0", np.float32(0.5), 3)
    writer.add_scalar("skipped", False, 3)
    lines = (tmp_path / "train" / "scalars.jsonl").read_text().splitlines()
    assert [json.loads(x) for x in lines] == [{"tag": "losses/mae_0", "step": 3, "value": 0.5},
                                             {"tag": "skipped", "step": 3, "value": 0.0}]
    was = torch.is_anomaly_enabled()
    try:
        enable_debug_mode()
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(was)
