"""The test command (test.py's counterpart): the test split of a config's
dataset through a checkpoint (or random weights), or a stored transform
file straight to the metric sweep, with test.py's flags and artifacts.

    python -m deepsir_tpu_torch.cli.test --pipeline align --dataset_type Synthetic \
        --resume <run>/ckpt/model_best.msgpack [--device cuda|cpu] ...

align: make_eval_step -> inference_align (the timed sweep, stats.npz) ->
evaluate_align -> save_eval_align (pred_transforms.npy, the per-iteration
CSVs, metrics.xlsx, summary_metrics.json, the score endpoints); feat and
label: inference_feat and inference_label with their dumps. The run
directory (derive_save_path) also holds log.txt and config.json, the JAX
package's for the same flags. Runs on the card unless given --device cpu.
"""
from __future__ import annotations

import functools
import os
import re
import sys
from typing import Optional, Sequence

import numpy as np

from deepsir_tpu_torch.cli import select_device
from deepsir_tpu_torch.config import config_from_args, eval_argument_parser
from deepsir_tpu_torch.data.base import Loader
from deepsir_tpu_torch.data.datasets import get_test_dataset
from deepsir_tpu_torch.evaluation import (evaluate_align, inference_align, inference_feat,
                                          inference_label, save_eval_align)
from deepsir_tpu_torch.models.network import Network
from deepsir_tpu_torch.training import forward_step, make_eval_step
from deepsir_tpu_torch.utils.checkpoint import CheckPointManager
from deepsir_tpu_torch.utils.logging import prepare_logger
from deepsir_tpu_torch.utils.params import init_params

PROG = "deepsir_tpu_torch.cli.test"
BATCH_SIZE = 1       # the inference protocol
NUM_WORKERS = 4


def derive_save_path(cfg) -> str:
    """`<eval_save_path>/<stamp>_<tag>` from a checkpoint named like
    `<yymmdd_hhmmss>.../model_<tag>`, else `<eval_save_path>/<file stem>`,
    or `<eval_save_path>/random_init` without --resume."""
    if cfg.train.resume:
        m = re.search(r"(\d{6}_\d{6}).*model[_-]?(\w*)", cfg.train.resume)
        if m:
            return os.path.join(cfg.eval.eval_save_path, f"{m.group(1)}_{m.group(2)}")
        base = os.path.splitext(os.path.basename(cfg.train.resume))[0]
        return os.path.join(cfg.eval.eval_save_path, base)
    return os.path.join(cfg.eval.eval_save_path, "random_init")


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Run the test command of `argv` (default: the process's arguments);
    returns the run directory."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = eval_argument_parser().parse_args(argv)
    device = select_device(args.device)
    cfg = config_from_args(args)
    cfgs = cfg.run_config()
    save_path = derive_save_path(cfg)
    os.makedirs(save_path, exist_ok=True)
    logger, _ = prepare_logger(cfg, log_path=save_path, argv=[PROG] + argv)

    test_set = get_test_dataset(cfg)
    loader = Loader(test_set, BATCH_SIZE, shuffle=False, num_workers=NUM_WORKERS)
    logger.info("Test set: %d pairs", len(test_set))

    if cfg.eval.transform_file:
        # no model: the stored transforms straight to the metric sweep
        pred = np.load(cfg.eval.transform_file)
        metrics, summary = evaluate_align(pred, loader, cfgs, device=device)
        save_eval_align(pred, {}, metrics, summary, save_path)
        return save_path

    model = Network(cfg.model, cfg.pipeline)
    if cfg.train.resume:
        saver = CheckPointManager(os.path.dirname(cfg.train.resume) or ".")
        step = saver.load(cfg.train.resume, model)
        logger.info("Restored checkpoint at step %d", step)
    else:
        logger.warning("No --resume given: evaluating RANDOM weights")
        model.load_state_dict(init_params(cfg.model, seed=0, pipeline=cfg.pipeline))
    model.to(device).eval()

    if cfg.pipeline == "align":
        eval_step = make_eval_step(model, cfg.model, refine_stride=cfg.model.refine_stride)
        pred, endpoints = inference_align(loader, eval_step, cfgs,
                                          stats_path=os.path.join(save_path, "stats.npz"))
        metrics, summary = evaluate_align(pred, loader, cfgs, device=device)
        save_eval_align(pred, endpoints, metrics, summary, save_path)
    elif cfg.pipeline == "feat":
        inference_feat(loader, functools.partial(forward_step, model, cfg.model), save_path)
    else:
        inference_label(loader, functools.partial(forward_step, model, cfg.model), save_path)
    return save_path


if __name__ == "__main__":
    main()
