"""Vistas pretraining, the ``scripts/main.py`` surface.

Counterpart of ``heatnet_tpu/cli/main.py`` (the reference's
``scripts/main.py``): the same flags plus ``--device``; the experiment JSON
(``experiments/heatnet_conf.json`` unless ``--config``) through
``utils/config.py``; ``get_model("net_" + arch)`` over 3-channel RGB with
the config's activation, dilation, ``input_3x3`` and classes, and
``NormAct(bn_groups=--bn-groups)`` (train-mode BN statistics per batch
group, as ``nn.DataParallel`` takes them per GPU), or with ``--arch pspnet``
PSPNet on the dilated ResNet-50, trained with its channel dropout; Adam with
a poly decay per step, after a global-norm clip when the config's ``clip``
is above 0; cross-entropy with ignore label 13. The chain per step: a
relabelled Vistas tree (``images/``, ``labels/``) → ``VistasDataset``'s
host chain (decode, scale jitter, pad, crop, flip, colour jitter, rotation,
normalisation; ``-j`` threads, the draws in order) → the card → the
supervised step (``train/supervised.py``).

``validate`` runs eval batches of 16 (the ragged tail padded, its labels
13) through the eval step's confusion matrices into ``IoU(14, False, [12,
13])`` and prints ``* mIoU``. Every even epoch writes
``<checkpoint-dir>/checkpoint.pth`` (``{"epoch", "arch", "state_dict",
"best_iou"}``) and, at a new best mIoU, ``checkpoint_best.pth``;
``cli.train_conf --pretraining --pretraining_path`` loads it. ``--resume``
(``auto``: this run's own checkpoint) restores the weights, the epoch and
the best mIoU; ``--evaluate`` validates and returns the mIoU.

Data parallelism (JAX's mesh, :76-85, :137, :171-219): under PyTorch's
launcher (``torchrun --nproc_per_node N``: one process per card, or gloo
processes with ``--device cpu``), ``parallel/mesh.py`` joins the process
group and builds a ``(data, model)`` mesh whose ``data`` size divides the
batch. Every process reads the same global batch and trains on its rows:
the weights start equal (a broadcast from rank 0), the loss is each
process's summed cross-entropy over the whole batch's valid count, the
gradients are summed over ``data``, and train-mode BN statistics span the
whole batch; so a step equals one process's step on the whole batch. The
validation batch rounds up to a multiple of the ``data`` size and the
confusion matrices are summed over it. The first process writes the
checkpoints and the run log (the others log under ``rank<r>/``).
``--world-size``, ``--dist-url`` and ``--dist-backend`` are accepted for the
reference's command lines; the launcher's environment sets the world.
Weights are random from seed 0, dropout masks come from a
``torch.Generator`` seeded 1 (drawn for the whole batch, each process
taking its rows). Runs on the card unless ``--device cpu``.

Usage::

    python -m heatnet_tpu_torch.cli.main --data VISTAS_TRAIN --valdata VISTAS_VAL
    torchrun --nproc_per_node 2 -m heatnet_tpu_torch.cli.main --data ... --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import List, Union

import numpy as np
import torch

from ..data.loaders import VistasDataset, batch_iterator, to_device
from ..device import resolve
from ..eval.iou_eval import IoU
from ..io.checkpoint import (best_iou_tracker, resolve_auto_resume, restore_partial,
                             save_checkpoint)
from ..io.logging import AverageMeter, RunLogger
from ..models import NormAct, ResNeXtSeg, build_network, get_model
from ..parallel.mesh import (data_group, data_parallel, data_size,
                             maybe_initialize_distributed, mesh_for_batch, replicate,
                             shard_batch)
from ..train.optim import create_optimizer, poly_lr
from ..train.state import TrainState, init_model
from ..train.supervised import IGNORE_INDEX, make_eval_step, make_train_step
from ..utils.config import load_config

EVAL_BATCH = 16
DEFAULT_CONFIG = os.path.join(os.path.dirname(__file__), "../../experiments/heatnet_conf.json")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="HeatNet Vistas pretraining (PyTorch/CUDA)")
    parser.add_argument("--data", metavar="DIR", required=True,
                        help="path to (relabelled) training dataset")
    parser.add_argument("--valdata", metavar="DIR", required=True,
                        help="path to validation dataset")
    parser.add_argument("--arch", "-a", metavar="ARCH", default="resnext50")
    parser.add_argument("-j", "--workers", default=4, type=int,
                        metavar="N", help="number of data loading workers")
    parser.add_argument("--print-freq", "-p", default=10, type=int, metavar="N")
    parser.add_argument("--resume", default="", type=str, metavar="PATH")
    parser.add_argument("-e", "--evaluate", dest="evaluate", action="store_true")
    parser.add_argument("--world-size", default=1, type=int,
                        help="accepted for parity; the launcher's WORLD_SIZE sets the world")
    parser.add_argument("--dist-url", default="tcp://localhost:23456", type=str)
    parser.add_argument("--dist-backend", default="gloo", type=str)
    parser.add_argument("--config", default=None, type=str,
                        help="experiment json (default experiments/heatnet_conf.json)")
    # additive knobs (reference hardcodes 768x384 / epochs from config)
    parser.add_argument("--width", default=768, type=int)
    parser.add_argument("--height", default=384, type=int)
    parser.add_argument("--epochs", default=None, type=int)
    parser.add_argument("--batch-size", default=None, type=int)
    parser.add_argument("--checkpoint-dir", default="checkpoints", type=str)
    parser.add_argument("--log-dir", default="runs", type=str)
    parser.add_argument("--max-steps-per-epoch", default=None, type=int,
                        help="debug/smoke cap")
    parser.add_argument("--structure", nargs=4, type=int, default=None,
                        help="override backbone block counts (debug/smoke)")
    parser.add_argument("--bn-groups", default=1, type=int,
                        help="reference-BN mode: train-time BN stats per "
                             "batch/N group (nn.DataParallel over N GPUs; "
                             "the reference trains batch 30 over 4); "
                             "1 = global-batch stats (default)")
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    return parser


@dataclasses.dataclass
class MainRun:
    losses: List[float]         # each step's loss
    step_seconds: List[float]   # each step, H2D to loss, on the host clock
    data_seconds: List[float]   # each step's wait for its batch (host decode and augmentation)
    mious: List[float]          # each validation's mIoU
    checkpoint: str             # the last checkpoint written
    best_iou: float


def build_model(args: argparse.Namespace, conf: dict) -> torch.nn.Module:
    """The network of ``scripts/main.py:111-115`` over 3-channel RGB."""
    net_conf = conf["network"]
    if args.arch == "pspnet":
        return build_network("resnet50", n_classes=net_conf["classes"], in_channels=3)
    model_kw = dict(
        classes=net_conf["classes"], dilation=tuple(net_conf["dilation"]),
        input_channels=3, input_3x3=net_conf.get("input_3x3", True),
        norm_act=NormAct(activation=net_conf["activation"],
                         leaky_slope=net_conf.get("leaky_relu_slope", 0.01),
                         bn_groups=args.bn_groups))
    if args.structure:
        return ResNeXtSeg(structure=tuple(args.structure), **model_kw)
    return get_model("net_" + args.arch, **model_kw)


def create_state(model: torch.nn.Module, opt_conf: dict, total_steps: int) -> TrainState:
    """Adam with ``poly_lr(learning_rate, max_iter=total_steps)`` per step,
    after a global-norm clip when ``clip > 0`` (scripts/main.py:159,232,256)."""
    optimizer, scheduler = create_optimizer(
        {"type": "Adam", "clip": opt_conf.get("clip", 0)}, model.parameters(),
        schedule=poly_lr(opt_conf["learning_rate"], max_iter=total_steps))
    return TrainState(model, optimizer, scheduler)


def main(argv=None) -> Union[MainRun, float]:
    """Train and return a ``MainRun``; with ``--evaluate`` return the mIoU."""
    args = build_parser().parse_args(argv)
    device = resolve(args.device)
    distributed = maybe_initialize_distributed(device)
    rank = torch.distributed.get_rank() if distributed else 0

    conf = load_config(args.config or DEFAULT_CONFIG)
    opt_conf = conf["optimizer"]
    batch_size = args.batch_size or opt_conf["batch_size"]
    mesh = mesh_for_batch(batch_size) if distributed else None
    if mesh is not None and mesh.get_coordinate() is None:
        print(f"rank {rank} idles: the batch of {batch_size} does not use it")
        return MainRun([], [], [], [], "", 0.0)
    d = data_size(mesh)
    logger = RunLogger("segnet", log_dir=args.log_dir if rank == 0
                       else os.path.join(args.log_dir, f"rank{rank}"))
    model = init_model(build_model(args, conf), seed=0, device=device)
    if conf["tpu"]["compute_dtype"] != "bfloat16":
        for m in model.modules():
            if hasattr(m, "compute_dtype"):
                m.compute_dtype = torch.float32
    has_dropout = args.arch == "pspnet"
    epochs = args.epochs or opt_conf["schedule"]["epochs"]

    train_ds = VistasDataset(args.data, width=args.width, height=args.height)
    val_ds = VistasDataset(args.valdata, width=args.width, height=args.height,
                           augment_data=False)
    steps_per_epoch = max(len(train_ds) // batch_size, 1)
    if args.max_steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, args.max_steps_per_epoch)
    state = create_state(model, opt_conf, steps_per_epoch * epochs)

    run = MainRun([], [], [], [], "", 0.0)
    start_epoch = 0
    track_best = best_iou_tracker()
    ckpt_path = os.path.join(args.checkpoint_dir, "checkpoint.pth")
    resume = resolve_auto_resume(args.resume, ckpt_path)
    if resume:
        saved = torch.load(resume, map_location="cpu", weights_only=True)
        restore_partial(model, saved["state_dict"])
        start_epoch = int(saved.get("epoch", 0))
        track_best.state["best"] = float(saved.get("best_iou", 0.0))
        print(f"=> resumed from {resume} (epoch {start_epoch})")
    if mesh is not None:
        replicate(mesh, model)

    train_step = make_train_step(model, mesh=mesh)
    eval_step = make_eval_step(model, num_classes=14)
    eval_bs = -(-EVAL_BATCH // d) * d

    def validate() -> float:
        """mIoU over the validation tree; the ragged tail is padded with
        label 13, whose confusion row ``IoU(..., [12, 13])`` zeroes."""
        metric = IoU(14, False, [12, 13])
        total = None
        for batch in batch_iterator(val_ds, batch_size=eval_bs, shuffle=False,
                                    drop_last=False, workers=args.workers):
            image, label = batch["image"], batch["label"]
            n = image.shape[0]
            if n < eval_bs:
                image = np.concatenate([image, np.zeros((eval_bs - n,) + image.shape[1:],
                                                        image.dtype)])
                label = np.concatenate([label, np.full((eval_bs - n,) + label.shape[1:],
                                                       IGNORE_INDEX, label.dtype)])
            image, label = shard_batch(mesh, (image, label))
            conf_mat = eval_step(state, {"image": to_device(image, device),
                                         "label": to_device(label, device)})
            if mesh is None:
                metric.add_confusion(conf_mat.cpu().numpy())
            else:
                total = conf_mat if total is None else total + conf_mat
        if total is not None:  # the counts of every process's rows
            torch.distributed.all_reduce(total, group=data_group(mesh))
            metric.add_confusion(total.cpu().numpy())
        iou, miou = metric.value()
        print(f" * mIoU {miou:.4f}")
        logger.log({"val_mIoU": miou, **{f"val_IoU_{i}": float(v) for i, v in enumerate(iou)}})
        run.mious.append(miou)
        return miou

    if args.evaluate:
        miou = validate()
        logger.finish()
        return miou

    generator = torch.Generator().manual_seed(1)
    with data_parallel(mesh):  # train-mode BN statistics over the whole batch
        for epoch in range(start_epoch, epochs):
            batch_time, data_time, losses = AverageMeter(), AverageMeter(), AverageMeter()
            end = time.time()
            for i, batch in enumerate(batch_iterator(train_ds, batch_size, shuffle=True,
                                                     seed=epoch, workers=args.workers)):
                if i >= steps_per_epoch:
                    break
                data_time.update(time.time() - end)
                t0 = time.perf_counter()
                n = batch["image"].shape[0]
                dropout = model.draw_dropout(n, generator) if has_dropout else None
                image, label, dropout = shard_batch(mesh, (batch["image"], batch["label"],
                                                           dropout))
                state, metrics = train_step(state, {
                    "image": to_device(image, device),
                    "label": to_device(label, device).long()}, dropout)
                loss = float(metrics["loss"])  # waits for the step
                run.step_seconds.append(time.perf_counter() - t0)
                run.data_seconds.append(data_time.val)
                run.losses.append(loss)
                losses.update(loss, n)
                batch_time.update(time.time() - end)
                end = time.time()
                if i % args.print_freq == 0:
                    print(f"Epoch: [{epoch}][{i}/{steps_per_epoch}]\t"
                          f"Time {batch_time.val:.3f} ({batch_time.avg:.3f})\t"
                          f"Data {data_time.val:.3f} ({data_time.avg:.3f})\t"
                          f"Loss {losses.val:.4f} ({losses.avg:.4f})")
                    logger.log({"epoch": epoch, "loss": losses.avg,
                                "batch_time": batch_time.avg})

            miou = validate()
            if epoch % 2 == 0:
                is_best = track_best(miou)
                if rank == 0:
                    os.makedirs(args.checkpoint_dir, exist_ok=True)
                    run.checkpoint = save_checkpoint(
                        {"epoch": epoch + 1, "arch": args.arch,
                         "state_dict": model.state_dict(),
                         "best_iou": track_best.state["best"]}, ckpt_path, is_best=is_best)
    logger.finish()
    run.best_iou = track_best.state["best"]
    return run

if __name__ == "__main__":
    main()
