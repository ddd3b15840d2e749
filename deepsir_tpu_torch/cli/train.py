"""The train command (train.py's counterpart): a dataset's train split
through the training step of a pipeline, with periodic validation and the
checkpoint ring, with train.py's flags.

    python -m deepsir_tpu_torch.cli.train --pipeline align --dataset_type Synthetic \
        --resume <previous stage>/ckpt [--device cuda|cpu] ...

Weights: seeded (`utils.params.init_params` from --seed), or --resume: the
whole training state with --load_model_all, else every stored leaf that
matches by path and shape (the staged regimen's start from the stage
before). The epoch loop: Loader -> device_prefetch -> training.train_step,
dropout drawn from a torch.Generator on the device seeded from --seed,
the skip counter, the learning rate of `training.lr_at`; every
summary_every steps the summaries (utils/summary.py); validation every
validate_every steps (negative: epochs; 0: never) scores a checkpoint
(align: success rate, label: mIoU, feat: the negative mean loss); the last
step is always saved, as the best when no validation ran. Runs on the card
unless given --device cpu.

Several cards: one process per card, started with the DEEPSIR_* variables
(parallel/distributed.py; `torchrun` with DEEPSIR_DISTRIBUTED=1). With
--data_parallel true and more than one process, the pairs of each batch
are split over the processes (parallel/sharded.py: the state replicated
from the first process, each process training on its rows of the loader's
batch, the step the global batch's); with one process, or without
--data_parallel, every process runs the plain step. Every process reads
the data and validates; only the first writes (the run directory, its
log, summaries and checkpoints), and every process returns its path.
"""
from __future__ import annotations

import functools
import logging
import os
import sys
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from deepsir_tpu_torch.cli import select_device
from deepsir_tpu_torch.config import Config, config_from_args, train_argument_parser
from deepsir_tpu_torch.data.base import Loader
from deepsir_tpu_torch.data.datasets import get_train_datasets
from deepsir_tpu_torch.losses.detdes import det_des_loss
from deepsir_tpu_torch.losses.semantic import SemanticMetric, confusion_matrix
from deepsir_tpu_torch.math import se3_np
from deepsir_tpu_torch.models.network import Network
from deepsir_tpu_torch.parallel import (make_mesh, make_sharded_train_step, replicate_state,
                                        shard_batch)
from deepsir_tpu_torch.parallel.distributed import initialize_from_env
from deepsir_tpu_torch.training import (batch_arrays_only, forward_step, lr_at,
                                        make_eval_step, make_optimizer, train_step)
from deepsir_tpu_torch.utils.checkpoint import (CheckPointManager, load_train_state,
                                                partial_restore)
from deepsir_tpu_torch.utils.logging import prepare_logger, snapshot_source
from deepsir_tpu_torch.utils.metrics import compute_metrics, summarize_metrics
from deepsir_tpu_torch.utils.params import init_params
from deepsir_tpu_torch.utils.prefetch import device_prefetch, to_device
from deepsir_tpu_torch.utils.profiling import StepTracer, enable_debug_mode
from deepsir_tpu_torch.utils.summary import SummaryWriter
from deepsir_tpu_torch.utils.timer import Timer

PROG = "deepsir_tpu_torch.cli.train"


def mesh_summary(writer, step, arrays, pred_transform, tag="val_alignment") -> None:
    """The first pair of a batch as one mesh: the source moved by its
    predicted pose (red) and the reference (green)."""
    src = se3_np.transform(np.asarray(pred_transform)[0], arrays["points_src"][0, :, :3])
    ref = arrays["points_ref"][0, :, :3]
    colors = np.concatenate([np.tile([[255, 0, 0]], (len(src), 1)),
                             np.tile([[0, 255, 0]], (len(ref), 1))])[None]
    writer.add_mesh(tag, vertices=np.concatenate([src, ref])[None], colors=colors,
                    global_step=step)


def _host(arrays):
    return {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
            for k, v in arrays.items()}


def validate(cfg: Config, model: Network, val_loader, logger, val_step,
             writer: Optional[SummaryWriter] = None, step: int = 0) -> float:
    """The validation sweep's score: align the success rate (with the
    meshes of the worst pair by translation error and of a pair picked
    uniformly at random), label the mIoU, feat the negative mean loss."""
    if cfg.pipeline == "align":
        metrics = []
        worst = None                       # (err_t, arrays, transform)
        rand_pick = None
        rng_pick = np.random.default_rng(step)
        seen = 0
        for batch in val_loader:
            arrays = batch_arrays_only(batch)
            transforms, _ = val_step(arrays)
            final = transforms[-1].cpu().numpy()
            m = compute_metrics(arrays["transform_gt"], final, arrays["points_src"],
                                arrays["points_ref"], cfg.train.rte_thresh,
                                cfg.train.rre_thresh, mask_src=arrays.get("mask_src"),
                                mask_ref=arrays.get("mask_ref"), device=val_step.device)
            metrics.append(m)
            i_bad = int(np.argmax(m["err_t"]))
            if worst is None or m["err_t"][i_bad] > worst[0]:
                worst = (float(m["err_t"][i_bad]),
                         {k: v[i_bad:i_bad + 1] for k, v in arrays.items()},
                         final[i_bad:i_bad + 1])
            # reservoir step: a uniform pick without the sweep's length
            bs = len(arrays["transform_gt"])
            j = int(rng_pick.integers(seen + bs))
            if j >= seen:
                i_rand = j - seen
                rand_pick = ({k: v[i_rand:i_rand + 1] for k, v in arrays.items()},
                             final[i_rand:i_rand + 1])
            seen += bs
        summary = summarize_metrics({k: np.concatenate([m[k] for m in metrics])
                                     for k in metrics[0]})
        logger.info("Validation: succ %.3f | err_r %.3f deg | err_t %.3g", summary["succ"],
                    summary["err_r_deg_mean"], summary["err_t_mean"])
        if writer is not None and worst is not None:
            mesh_summary(writer, step, worst[1], worst[2], tag="val_alignment_worst")
            mesh_summary(writer, step, rand_pick[0], rand_pick[1], tag="val_alignment_random")
        return summary["succ"]

    if cfg.pipeline == "label":
        metric = SemanticMetric()
        for batch in val_loader:
            arrays = batch_arrays_only(batch)
            out = val_step(arrays)
            for logits, key in ((out.logits_src, "labels_src"), (out.logits_ref, "labels_ref")):
                labels = torch.as_tensor(arrays[key], device=logits.device)
                metric.update(confusion_matrix(logits, labels))
        miou, _, acc = metric.compute()
        logger.info("Validation: mIoU %.3f | acc %.3f", miou, acc)
        return miou

    losses = []
    for batch in val_loader:
        arrays = batch_arrays_only(batch)
        out = val_step(arrays)
        gt = torch.as_tensor(arrays["transform_gt"], device=out.xyz_src.device)
        loss, _ = det_des_loss(out.feat_src, out.feat_ref, out.xyz_src, out.xyz_ref,
                               out.score_src, out.score_ref, gt, cfg.loss)
        losses.append(float(loss))
    mean_loss = float(np.mean(losses))
    logger.info("Validation: feat loss %.5f", mean_loss)
    return -mean_loss


def make_validate_step(cfg: Config, model: Network):
    """align: the eval step (5 iterations, clip_weight, no refine stride);
    label and feat: the serving forward. Either takes host arrays."""
    if cfg.pipeline == "align":
        return make_eval_step(model, cfg.model)
    return functools.partial(forward_step, model, cfg.model)


def _summaries(writer, cfg, step, steps_per_epoch, aux, val_step, arrays,
               mesh_summaries: bool = True) -> None:
    """The scalars of a step (the loss, the learning rate, each loss term,
    and the step's flags and accuracy) and, for align with
    `mesh_summaries`, the train batch's alignment mesh."""
    writer.add_scalar("loss", float(aux["loss"]), step)
    writer.add_scalar("lr", lr_at(step, cfg.train, steps_per_epoch), step)
    for k, v in aux.get("losses", {}).items():
        writer.add_scalar(f"losses/{k}", float(v), step)
    for k in ("acc", "invalid", "skipped"):
        if k in aux:
            writer.add_scalar(k, float(aux[k]), step)
    if cfg.pipeline == "align" and mesh_summaries:
        transforms, _ = val_step(arrays)
        mesh_summary(writer, step, _host(arrays), transforms[-1].cpu().numpy(),
                     tag="train_alignment")


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Run the train command of `argv` (default: the process's arguments);
    returns the run directory. A process group that this call starts
    (parallel.distributed.initialize_from_env) ends with it."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = train_argument_parser().parse_args(argv)
    # multi-process: join the process group before any device is used
    owned = not dist.is_initialized() and initialize_from_env(args.device)
    try:
        return _train(args, argv)
    finally:
        if owned:
            dist.destroy_process_group()


def _train(args, argv) -> str:
    device = select_device(args.device)
    cfg = config_from_args(args)
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if (cfg.train.data_parallel and world == 1 and device.type == "cuda"
            and torch.cuda.device_count() > 1):
        raise RuntimeError(
            f"--data_parallel with {torch.cuda.device_count()} cards in one process: start "
            "one process per card, each with DEEPSIR_COORDINATOR=<host:port>, "
            "DEEPSIR_NUM_PROCESSES=<processes> and DEEPSIR_PROCESS_ID=<its index> set "
            "(or under torchrun with DEEPSIR_DISTRIBUTED=1)")
    if device.type == "cuda" and world > 1:
        device = torch.device("cuda", torch.cuda.current_device())   # this process's card
    cfgs = cfg.run_config()
    if cfg.debug:
        enable_debug_mode()
    writer = None
    if rank == 0:
        logger, log_path = prepare_logger(cfg, argv=[PROG] + argv)
        snapshot_source(log_path)
        writer = SummaryWriter(os.path.join(log_path, "train"))
    else:
        logger, log_path = logging.getLogger(PROG), None
    if world > 1:
        shared = [log_path]
        dist.broadcast_object_list(shared, src=0)
        log_path = shared[0]

    train_set, val_set = get_train_datasets(cfg)
    # drop_last on both: every batch has the configured size
    train_loader = Loader(train_set, cfg.train.batch_size, shuffle=True, seed=cfg.train.seed,
                          num_workers=cfg.data.num_workers, drop_last=True)
    val_loader = Loader(val_set, cfg.train.batch_size, shuffle=False,
                        num_workers=cfg.data.num_workers, drop_last=True)
    logger.info("Train set: %d samples, val set: %d", len(train_set), len(val_set))
    steps_per_epoch = max(1, len(train_loader))
    # JAX's train.py draws an example batch to initialise its state, which
    # opens the loader's first epoch; the port's batches follow the same
    # streams
    train_loader.epoch += 1

    model = Network(cfg.model, cfg.pipeline)
    model.load_state_dict(init_params(cfg.model, seed=cfg.train.seed, pipeline=cfg.pipeline))
    model.to(device)
    optimizer = make_optimizer(model)
    logger.info("Model built: %d parameters (pipeline=%s)",
                sum(p.numel() for p in model.parameters()), cfg.pipeline)

    saver = None
    if rank == 0:
        saver = CheckPointManager(os.path.join(log_path, "ckpt"),
                                  keep_checkpoint_every_n_hours=1.0)
    step = 0
    if cfg.train.resume:
        if cfg.train.load_model_all:
            step = (saver.load if saver else load_train_state)(cfg.train.resume, model,
                                                               optimizer)
        else:
            loaded = partial_restore(cfg.train.resume, model)
            logger.info("Partial restore: %d parameter arrays loaded", loaded)

    step_fn, transfer = train_step, None
    if cfg.train.data_parallel and world > 1:
        # DP over the pair batch, one process per card (parallel/): state
        # replicated, each process on its rows, the step the global batch's
        mesh = make_mesh()
        if cfg.train.batch_size % mesh.shape["data"]:
            raise ValueError(f"batch_size {cfg.train.batch_size} not divisible by "
                             f"{mesh.shape['data']} data-parallel processes")
        logger.info("Data parallel over mesh %s", dict(mesh.shape))
        replicate_state(mesh, model, optimizer)
        step_fn = make_sharded_train_step(mesh)

        def transfer(arrays):
            return {k: to_device(v, device) for k, v in shard_batch(mesh, arrays).items()}
    val_step = make_validate_step(cfg, model)
    validate_every = cfg.train.validate_every
    if validate_every < 0:                       # negative: epochs
        validate_every = -validate_every * steps_per_epoch

    # seeded alike on every process: the sharded step's dropout draws the
    # global batch's mask and keeps its rows
    generator = torch.Generator(device).manual_seed(cfg.train.seed)
    tracer = StepTracer() if rank == 0 else StepTracer(num_steps=0)
    timer = Timer()
    skipped = 0
    for epoch in range(cfg.train.max_epochs):
        host_batches = (batch_arrays_only(b) for b in train_loader)
        for arrays in device_prefetch(host_batches, transfer=transfer, device=device):
            timer.tic()
            with tracer.maybe_trace(step):
                aux = step_fn(model, optimizer, cfgs, arrays, generator, steps_per_epoch)
                loss = float(aux["loss"])
            timer.toc()
            step += 1
            skipped += int(aux["skipped"])

            if step % 100 == 0:
                logger.info("epoch %d step %d | loss %.5f | %.2fs/step | lr %.2e | skipped %d",
                            epoch, step, loss, timer.avg,
                            lr_at(step, cfg.train, steps_per_epoch), skipped)
            if writer is not None and step % cfg.train.summary_every == 0:
                # the train batch's mesh: one process only (train.py:256)
                _summaries(writer, cfg, step, steps_per_epoch, aux, val_step, arrays,
                           mesh_summaries=world == 1)
            if validate_every > 0 and step % validate_every == 0:
                score = validate(cfg, model, val_loader, logger, val_step, writer=writer,
                                 step=step)
                if saver is not None:
                    writer.add_scalar("val_score", score, step)
                    saver.save(model, optimizer, step, score=score)
        logger.info("Epoch %d done (step %d)", epoch, step)
    tracer.close()                  # a run that ended inside the traced window

    # the final checkpoint; the best when no validation ran, so that the
    # run's ckpt directory always resolves to model_best.msgpack
    if saver is not None:
        saver.save(model, optimizer, step, score=0.0 if saver.best_step is None else -np.inf)
    logger.info("Training complete at step %d (%.4f s per step)", step, timer.avg)
    return log_path


if __name__ == "__main__":
    main()
