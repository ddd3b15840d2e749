"""The commands' flags and the run config in both packages: every `Command:`
line of the tracked runs' log.txt files (114 test, 23 train) parses to the
same resolved config, `dataclasses.asdict` for `dataclasses.asdict` and the
config.json text byte for byte; the dataset-dependent constants, the --dev
clamps, --device, and `read_run_config` reading every data and train key.
The comparisons are exact: both packages parse the same strings."""
import torch_workers  # noqa: F401  (torch's threads under xdist)
import dataclasses
import json
import shlex
import subprocess
from pathlib import Path

import pytest
import torch

from deepsir_tpu import config as jax_config
from deepsir_tpu_torch import config as port_config
from deepsir_tpu_torch.cli import select_device

ROOT = Path(__file__).resolve().parent.parent
LOGS = sorted(p for p in subprocess.run(["git", "ls-files", "logs_*"], cwd=ROOT,
                                        capture_output=True, text=True).stdout.split()
              if p.endswith("log.txt"))
COMMANDS = [(path, line.split("Command: ", 1)[1].strip())
            for path in LOGS for line in (ROOT / path).read_text().splitlines()
            if "Command: " in line]


def _parsed(pkg, argv, train):
    parser = pkg.train_argument_parser() if train else pkg.eval_argument_parser()
    return pkg.config_from_args(parser.parse_args(argv))


def _both(argv, train):
    return _parsed(jax_config, argv, train), _parsed(port_config, argv, train)


def test_the_tracked_commands_are_found():
    assert len(LOGS) == 132
    assert len(COMMANDS) == 137
    progs = [shlex.split(c)[0] for _, c in COMMANDS]
    assert progs.count("test.py") == 114 and progs.count("train.py") == 23


@pytest.mark.parametrize("path,command", COMMANDS, ids=[f"{p}:{i}" for i, (p, _) in
                                                        enumerate(COMMANDS)])
def test_every_tracked_command_resolves_as_in_jax(path, command):
    prog, *argv = shlex.split(command)
    want, got = _both(argv, prog == "train.py")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    # the run's config.json, as prepare_logger writes it
    assert json.dumps(dataclasses.asdict(got), indent=2, default=str) == \
        json.dumps(dataclasses.asdict(want), indent=2, default=str)


@pytest.mark.parametrize("argv", [
    "--dev --dataset_type Synthetic --num_points 4096 --synthetic_train_size 64",
    "--dev --dataset_type Synthetic --num_points 512 --synthetic_eval_size 2 --max_epochs 1",
    "--dataset_type 3DMatch --feat_len 4 --voxel_size 0.3",
    "--dataset_type Oxford --feat_len 4 --voxel_size 0.1 --thres_radius 0.5",
    "--dataset_type KITTI --voxel_size 0.2 --positive_pair_radius_multiplier 2",
    "-bs 4 -v 0 -su 7 -nv 3 --seed 5 --lr 0.01 --data_parallel true --load_model_all",
])
def test_resolution_and_short_flags_match_jax(argv):
    want, got = _both(argv.split(), train=True)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got == port_config.config_from_args(
        port_config.train_argument_parser().parse_args(argv.split())).resolved()


@pytest.mark.parametrize("argv", [
    "--compute_dtype bfloat16",
    "--inlier_compute_dtype bfloat16",
    "--use_ppf true --feat_len 6",
    "--matmul_precision default",
    "--compute_dtype bfloat16 --inlier_compute_dtype bfloat16 --use_ppf true --feat_len 6 "
    "--matmul_precision high --pipeline label",
])
@pytest.mark.parametrize("train", [True, False])
def test_precision_and_ppf_flags_resolve_as_in_jax(argv, train):
    """The bf16, PPF and matmul-precision flags give JAX's config and
    config.json, and a network of every pipeline builds from them."""
    want, got = _both(argv.split(), train)
    assert json.dumps(dataclasses.asdict(got), indent=2, default=str) == \
        json.dumps(dataclasses.asdict(want), indent=2, default=str)
    port_config.check_supported(got.model)
    from deepsir_tpu_torch.models.network import Network
    small = port_config.replace(got.model, d_out=(8, 16), sub_sampling_ratio=(4, 4))
    for pipeline in port_config.PIPELINES:
        Network(small, pipeline)


def test_dev_and_dataset_constants():
    dev = _parsed(port_config, "--dev --num_points 4096 --num_workers 8".split(), True)
    assert (dev.model.num_points, dev.data.synthetic_train_size, dev.data.synthetic_eval_size,
            dev.data.num_workers, dev.train.max_epochs) == (1024, 16, 4, 2, 2)
    tdm = _parsed(port_config, ["--dataset_type", "3DMatch"], False)
    assert (tdm.data.voxel_size, tdm.eval.rte_thresh, tdm.eval.rre_thresh,
            tdm.model.feat_len, tdm.loss.thres_radius) == (0.03, 0.3, 15.0, 3, 0.03 * 3.0)
    ox = _parsed(port_config, ["--dataset_type", "Oxford", "--voxel_size", "0.05"], False)
    assert (ox.data.voxel_size, ox.model.feat_len) == (0.3, 3)


def test_device_flag_is_the_only_flag_added():
    for make in ("train_argument_parser", "eval_argument_parser"):
        jax_flags = {a.dest for a in getattr(jax_config, make)()._actions}
        port_flags = {a.dest for a in getattr(port_config, make)()._actions}
        assert port_flags - jax_flags == {"device"} and jax_flags <= port_flags
    args = port_config.eval_argument_parser().parse_args([])
    assert args.device == "cuda"
    assert "device" not in json.dumps(dataclasses.asdict(port_config.config_from_args(args)))


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        select_device("cuda")
    assert select_device("cpu") == torch.device("cpu")


def test_data_parallel_over_several_cards_raises(monkeypatch, tmp_path):
    from deepsir_tpu_torch.cli import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="2 cards in one process: start one process per "
                                           "card, each with DEEPSIR_COORDINATOR"):
        train.main(["--data_parallel", "true", "--logdir", str(tmp_path)])


@pytest.mark.parametrize("run", ["logs_r3/staged_po/260817_191109_align",
                                 "logs_r3/staged_po/260817_185436_label"])
def test_read_run_config_reads_the_data_and_train_blocks(run):
    stored = json.loads((ROOT / run / "config.json").read_text())
    cfgs = port_config.read_run_config(ROOT / run)
    data = dataclasses.asdict(cfgs.data)      # older runs lack the newer keys
    assert {k: data[k] for k in stored["data"]} == stored["data"]
    train = dataclasses.asdict(cfgs.train)
    assert {k: train[k] for k in stored["train"]} == stored["train"]
    for key in ("dataset_type", "synthetic_train_size", "synthetic_p_keep", "num_workers"):
        assert getattr(cfgs.data, key) == stored["data"][key]
    for key in ("max_epochs", "validate_every", "summary_every", "resume"):
        assert getattr(cfgs.train, key) == stored["train"][key]
    assert cfgs.voxel_size == cfgs.data.voxel_size
