"""The port's eval harness (deepsir_tpu_torch/evaluation.py) against the
JAX package on the CPU: the align sweep `make_eval_step` ->
`inference_align` -> `evaluate_align` -> `save_eval_align` at the widths of
tests/test_evaluation.py with the same params and pairs, its artifacts
compared value for value; the metric sweep of a tracked TPU artifact; and
chip_smoke.py's label and feat sweeps and refiners on JAX's stored outputs.

Tolerances and why:
- refined poses: PIPELINE_GAP by chip_smoke.pose_gap (measured 1.2e-5 with
  ICP on: JAX ranks ICP's neighbours by the norm expansion, the port by
  direct differences; the forwards agree to ~1e-6).
- the metric CSVs of the two sweeps: succ equal; err_t, t_mae, t_rmse
  1e-4 absolute; r_mae, r_rmse 1e-3 deg; chamfer_dist 1e-4 relative and
  1e-5 absolute (a near-registered pair's chamfer is ~5e-3);
  err_r_deg 0.2 deg (the float32 arccos near 0 moves by sqrt(d) rad for a
  trace change d). stats.npz: succ equal, RTE and RRE as err_t, err_r_deg.
- the tracked artifact (the same poses in both): succ, r_mae, t_mae and
  both rmse fields equal; err_t 4.6e-6 relative and chamfer_dist 2.2e-6
  absolute, the bounds JAX's own `test.py --transform_file` met on the CPU
  against the TPU's files. err_r_deg in the cosine it is the arccos of:
  within 5 float32 ulps below 1 (5 * 2^-24). Near 0.1-1 deg an ulp of the
  cosine moves the angle by 6e-4-3e-3 deg; JAX's CPU run lands 4 ulps
  (3.4e-3 deg) from the TPU's, the port 4 ulps (3.7e-3 deg). The
  summary's err_r_deg fields within 3.4e-3 deg.
"""
import torch_workers  # noqa: F401  (torch's threads under xdist)
import csv
import importlib.util
import json
import xml.etree.ElementTree as ET
import zipfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from deepsir_tpu.config import Config, ModelConfig as JaxModelConfig, replace as jax_replace
from deepsir_tpu.data.base import Loader
from deepsir_tpu.data.datasets import get_test_dataset
from deepsir_tpu.data.synthetic import SyntheticPairs
from deepsir_tpu.evaluation import (evaluate_align as jax_evaluate_align,
                                    inference_align as jax_inference_align,
                                    save_eval_align as jax_save_eval_align)
from deepsir_tpu.training import create_train_state, make_eval_step as jax_make_eval_step
from deepsir_tpu_torch.config import (DataConfig, EvalConfig, LossConfig, ModelConfig, RunConfig,
                                      TrainConfig, read_run_config, replace)
from deepsir_tpu_torch.evaluation import evaluate_align, inference_align, save_eval_align
from deepsir_tpu_torch.models.network import Network
from deepsir_tpu_torch.training import make_eval_step
from deepsir_tpu_torch.utils.params import from_jax_params, load_network

_spec = importlib.util.spec_from_file_location(
    "make_torch_parity_fixture",
    Path(__file__).parent / "data" / "make_torch_parity_fixture.py")
F = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(F)

ROOT = Path(__file__).resolve().parent.parent
ARTIFACT = ROOT / "logs_r4/q2_finetune_full/260817_191109_best"
MODEL = dict(feat_len=3, num_points=256, num_knn=8, sub_sampling_ratio=(4, 4), d_out=(8, 16),
             out_feat_dim=16, num_classes=5, num_train_reg_iter=1, num_reg_iter=2)
PIPELINE_GAP = 5e-5
CSV_ATOL = {"err_t": 1e-4, "t_mae": 1e-4, "t_rmse": 1e-4, "r_mae": 1e-3, "r_rmse": 1e-3,
            "err_r_deg": 0.2}


@pytest.fixture(scope="module")
def setup():
    """JAX's config, eval step and params at the test widths, the port's
    model with the same params, and 3 synthetic test pairs as host batches."""
    cfg = Config(pipeline="align", model=JaxModelConfig(**MODEL))
    cfg = jax_replace(cfg, data=jax_replace(cfg.data, max_matches=64))
    batches = list(Loader(SyntheticPairs(cfg, split="test", size=3), batch_size=1,
                          shuffle=False, num_workers=1))
    example = {k: v for k, v in batches[0].items() if isinstance(v, np.ndarray)}
    net, state = create_train_state(cfg, example)
    port_cfg = ModelConfig(**MODEL)
    model = load_network(port_cfg, from_jax_params(jax.device_get(state.params),
                                                   Network(port_cfg)), device="cpu")
    return cfg, jax_make_eval_step(cfg, net), state.params, model, batches


def read_csv(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], np.asarray(rows[1:], dtype=np.float64)


def read_xlsx(path):
    ns = "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}"
    with zipfile.ZipFile(path) as z:
        book = ET.fromstring(z.read("xl/workbook.xml"))
        names = [s.get("name") for s in book.iter(f"{ns}sheet")]
        sheets = []
        for i in range(len(names)):
            sheet = ET.fromstring(z.read(f"xl/worksheets/sheet{i + 1}.xml"))
            rows = list(sheet.iter(f"{ns}row"))
            sheets.append(([t.text for t in rows[0].iter(f"{ns}t")],
                           np.asarray([[float(v.text) for v in r.iter(f"{ns}v")]
                                       for r in rows[1:]])))
    return names, sheets


@pytest.mark.parametrize("name", ["none", "all", "float16"])
def test_align_sweep_against_jax(setup, tmp_path, name):
    cfg, jax_step, params, model, batches = setup
    setting = chip_smoke.EVAL_SETTINGS[name]
    jax_cfg = jax_replace(cfg, eval=jax_replace(cfg.eval, **setting))
    want, want_end = jax_inference_align(batches, jax_step, params, jax_cfg,
                                         stats_path=str(tmp_path / "jax_stats.npz"))
    want_m, want_s = jax_evaluate_align(want, batches, jax_cfg)
    jax_save_eval_align(want, want_end, want_m, want_s, str(tmp_path / "jax"))

    cfgs = RunConfig(ModelConfig(**MODEL), LossConfig(), TrainConfig(), "align",
                     replace(EvalConfig(), **setting),
                     DataConfig(voxel_size=cfg.data.voxel_size))
    n = MODEL["num_points"]
    picks = torch.from_numpy(np.array(jax.random.randint(jax.random.PRNGKey(0), (4096, 3),
                                                         0, n)))
    got, got_end = inference_align(batches, make_eval_step(model, cfgs.model), cfgs,
                                   stats_path=str(tmp_path / "stats.npz"), ransac_picks=picks)
    assert got.shape == want.shape == (3, MODEL["num_reg_iter"] + 1, 3, 4)
    radius = np.concatenate([np.abs(b["points_src"]).max(axis=(1, 2)) for b in batches])
    for i in range(got.shape[1]):
        assert chip_smoke.pose_gap(got[:, i], want[:, i], radius).max() <= PIPELINE_GAP, i
    assert sorted(got_end) == sorted(want_end) == ["scores_ref", "scores_src"]
    np.testing.assert_allclose(np.concatenate(got_end["scores_src"]),
                               np.concatenate(want_end["scores_src"]), atol=1e-5)
    metrics, summary = evaluate_align(got, batches, cfgs, device="cpu")
    assert list(summary) == list(want_s)
    save_eval_align(got, got_end, metrics, summary, str(tmp_path / "port"))

    stats, jax_stats = (np.load(tmp_path / f) for f in ("stats.npz", "jax_stats.npz"))
    assert stats["stats"].shape == jax_stats["stats"].shape == (1, 3, 5)
    assert list(stats["names"]) == list(jax_stats["names"]) == ["Ours"]
    np.testing.assert_array_equal(stats["stats"][0, :, 0], jax_stats["stats"][0, :, 0])
    np.testing.assert_allclose(stats["stats"][0, :, 1], jax_stats["stats"][0, :, 1], atol=1e-4)
    np.testing.assert_allclose(stats["stats"][0, :, 2], jax_stats["stats"][0, :, 2], atol=0.2)

    port, jx = tmp_path / "port", tmp_path / "jax"
    assert sorted(p.name for p in port.iterdir()) == sorted(p.name for p in jx.iterdir())
    np.testing.assert_array_equal(np.load(port / "pred_transforms.npy"), got)
    for i in range(got.shape[1]):
        header, rows = read_csv(port / f"metrics_iter_{i + 1}.csv")
        jax_header, jax_rows = read_csv(jx / f"metrics_iter_{i + 1}.csv")
        assert header == jax_header == ["r_mae", "t_mae", "err_r_deg", "err_t", "succ",
                                        "chamfer_dist", "r_rmse", "t_rmse"]
        col = dict(zip(header, rows.T))
        jax_col = dict(zip(header, jax_rows.T))
        np.testing.assert_array_equal(col["succ"], jax_col["succ"])
        for key, atol in CSV_ATOL.items():
            np.testing.assert_allclose(col[key], jax_col[key], atol=atol, err_msg=key)
        np.testing.assert_allclose(col["chamfer_dist"], jax_col["chamfer_dist"], rtol=1e-4,
                                   atol=1e-5)
    names, sheets = read_xlsx(port / "metrics.xlsx")
    assert names == read_xlsx(jx / "metrics.xlsx")[0] == ["Iter_1", "Iter_2", "Iter_3"]
    for i, (header, values) in enumerate(sheets):
        csv_header, csv_rows = read_csv(port / f"metrics_iter_{i + 1}.csv")
        assert header == csv_header
        np.testing.assert_allclose(values, csv_rows, rtol=1e-6)
    got_json = json.loads((port / "summary_metrics.json").read_text())
    assert got_json == pytest.approx(summary, rel=1e-12)


@pytest.fixture(scope="module")
def artifact_split():
    """The Synthetic test split of the tracked run's config.json (128 pairs
    at 1024 points), built by the JAX data layer as its test.py built it."""
    cfg = F.run_config(str(ARTIFACT.relative_to(ROOT)))
    return list(Loader(get_test_dataset(cfg), 1, shuffle=False, num_workers=4))


def test_metric_sweep_reproduces_a_tracked_artifact(artifact_split, tmp_path):
    pred = np.load(ARTIFACT / "pred_transforms.npy")
    assert pred.shape == (128, 6, 3, 4) and len(artifact_split) == 128
    cfgs = read_run_config(ARTIFACT)
    metrics, summary = evaluate_align(pred, artifact_split, cfgs, device="cpu")
    save_eval_align(pred, {}, metrics, summary, str(tmp_path))
    for i in range(6):
        header, rows = read_csv(tmp_path / f"metrics_iter_{i + 1}.csv")
        want_header, want = read_csv(ARTIFACT / f"metrics_iter_{i + 1}.csv")
        assert header == want_header
        got, want = dict(zip(header, rows.T)), dict(zip(header, want.T))
        for key in ("succ", "r_mae", "t_mae", "r_rmse", "t_rmse"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"iter {i + 1} {key}")
        np.testing.assert_allclose(got["err_t"], want["err_t"], rtol=4.6e-6, atol=0)
        np.testing.assert_allclose(got["chamfer_dist"], want["chamfer_dist"], rtol=0,
                                   atol=2.2e-6)
        cos_gap = np.abs(np.cos(np.deg2rad(got["err_r_deg"]))
                         - np.cos(np.deg2rad(want["err_r_deg"])))
        assert cos_gap.max() <= 5 * 2.0 ** -24, f"iter {i + 1} err_r_deg"
    want_s = json.loads((ARTIFACT / "summary_metrics.json").read_text())
    got_s = json.loads((tmp_path / "summary_metrics.json").read_text())
    assert list(got_s) == list(want_s)
    for key in ("r_rmse", "r_mae", "t_rmse", "t_mae", "succ"):
        assert got_s[key] == pytest.approx(want_s[key], rel=1e-7), key
    for key in ("err_t_mean", "err_t_rmse"):
        assert got_s[key] == pytest.approx(want_s[key], rel=4.6e-6), key
    for key in ("err_r_deg_mean", "err_r_deg_rmse"):
        assert got_s[key] == pytest.approx(want_s[key], rel=0, abs=3.4e-3), key
    assert got_s["chamfer_dist"] == pytest.approx(want_s["chamfer_dist"], rel=0, abs=2.2e-6)


def test_label_and_feat_sweeps_against_jax(tmp_path):
    """chip_smoke.eval_sweeps on the CPU: the staged label and feat
    checkpoints' sweeps against JAX's stored mIoU, accuracy and dumps."""
    _, record = chip_smoke.eval_sweeps(torch, torch.device("cpu"), tmp_path)
    assert record["label"]["miou"] == record["label"]["jax_miou"]


def test_refiners_on_jax_inputs(tmp_path):
    """chip_smoke.eval_refiners on the CPU: each refiner on the trained
    checkpoint's JAX forward, within chip_smoke.REFINER_TOL."""
    record = chip_smoke.eval_refiners(torch, torch.device("cpu"))
    assert set(record) == set(chip_smoke.REFINER_TOL)


def test_eval_fixture_is_small_and_complete():
    fx = np.load(F.OUT_EVAL)
    assert F.OUT_EVAL.stat().st_size < 1 << 20
    for name in chip_smoke.EVAL_SETTINGS:
        assert fx[f"eval/{name}/pose"].shape == (8, 3, 4)
        assert fx[f"eval/{name}/succ"].shape == (8,)
