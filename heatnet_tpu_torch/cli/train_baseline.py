"""The MFNet harness: train and evaluate the MFNet, RTFNet and SegNet baselines.

Counterpart of ``heatnet_tpu/cli/train_baseline.py`` (the reference's
``models/external_models/{mfnet,rtfnet}/{train.py,test.py}``), with its
flags and defaults and ``--device``:

- the model (``--model_name``) on 9 MFNet classes, random weights from seed
  0, or ``--resume`` (a checkpoint of this CLI, loaded strictly);
- SGD on every parameter, momentum 0.9, weight decay 5e-4 added to the
  gradient before the momentum trace (optax's ``add_decayed_weights`` then
  ``sgd``; the first trace is the gradient, as in ``torch.optim.SGD``), the
  learning rate ``lr_start * lr_decay^(epo - 1)`` set per epoch;
- per epoch, ``MFHarnessTrainDataset`` (native labels, RandomFlip(0.5) and
  RandomCrop(0.1) from ``data/mf_augment.py``, resized back to 640x480,
  /255) in ``batch_iterator`` batches of ``--batch_size`` shuffled by the
  epoch's seed; a float32 train-mode step, ``cross_entropy_ignore`` with
  ``ignore_index=-1``; the loss meter is never reset; a checkpoint
  ``{"epoch", "state_dict"}`` at ``--checkpointname`` (the path as given)
  after each epoch;
- then the ``day`` and ``night`` test splits, or with ``--test`` only
  ``combined``: ``rgb_org`` and ``ir_org`` (the /255 frames) concatenated,
  in fixed batches of 8 whose tail repeats its last frame with labels 9,
  which the confusion matrix drops; ``calculate_result`` of the summed
  matrix prints the overall accuracy and the mean IoU of classes 1-8.

Under PyTorch's launcher the process group is joined first
(``parallel/mesh.py::maybe_initialize_distributed``, :63-75), and with more
than one process the evaluation runs data parallel over a mesh of all of
them (:125-158): the batch rounds up to a multiple of the process count,
each process runs its rows, and the confusion matrices are summed.

The model computes in float32 on the card too (``prepare_for_training(...,
dtype=torch.float32)``); convolutions follow PyTorch's TF32 settings. The
transforms keep their ``RandomState``s across epochs and ``batch_iterator``'s
producer thread decodes up to 2 batches ahead, as in JAX: with
``--max_iters_per_epoch`` below an epoch's batch count, the next epoch's
augmentation draws depend on that thread's timing, in JAX and here.

Usage::

    python -m heatnet_tpu_torch.cli.train_baseline --model_name RTFNet --data_dir MF_TREE
    python -m heatnet_tpu_torch.cli.train_baseline --data_dir MF_TREE --test --resume CK
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.nn as nn

from ..data.loaders import (MFHarnessTrainDataset, MFNetDataset, batch_iterator,
                            prefetch_items, to_device)
from ..data.mf_augment import default_train_augmentations
from ..device import resolve
from ..eval.validate import batched
from ..io.checkpoint import load_state_dict, save_checkpoint
from ..io.logging import AverageMeter, RunLogger
from ..models import MFNet, RTFNet, SegNetBaseline
from ..models.layers import init_params, prepare_for_training
from ..ops.iou import confusion_matrix
from ..parallel.mesh import (create_mesh, data_group, data_size,
                             maybe_initialize_distributed, shard_batch)
from ..train.supervised import cross_entropy_ignore

N_CLASS = 9
EVAL_BATCH = 8
BASELINES = {"MFNet": MFNet, "RTFNet": RTFNet, "SegNet": SegNetBaseline}


def calculate_result(cf: np.ndarray):
    """(overall_acc, per-class acc, per-class IoU) from a confusion matrix
    (rows = GT, cols = pred), exactly util/util.py:14-26."""
    n_class = cf.shape[0]
    conf = np.zeros((n_class, n_class))
    iou = np.zeros(n_class)
    with np.errstate(divide="ignore", invalid="ignore"):
        if cf[:, 0].sum() > 0:
            conf[:, 0] = cf[:, 0] / cf[:, 0].sum()
        for cid in range(1, n_class):
            if cf[:, cid].sum() > 0:
                conf[:, cid] = cf[:, cid] / cf[:, cid].sum()
                iou[cid] = cf[cid, cid] / (
                    cf[cid, 1:].sum() + cf[1:, cid].sum() - cf[cid, cid])
        overall_acc = np.diag(cf[1:, 1:]).sum() / cf[1:, :].sum()
    acc = np.diag(conf)
    return overall_acc, acc, iou


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="MFNet harness (PyTorch/CUDA)")
    p.add_argument('--model_name', default='MFNet',
                   choices=['MFNet', 'RTFNet', 'SegNet'])
    p.add_argument('--data_dir', required=True)
    p.add_argument('--batch_size', type=int, default=8)
    p.add_argument('--epoch_max', type=int, default=100)
    p.add_argument('--epoch_from', type=int, default=1)
    p.add_argument('--lr_start', type=float, default=0.01)
    p.add_argument('--lr_decay', type=float, default=0.95)
    p.add_argument('--test', action='store_true', help='evaluate only')
    p.add_argument('--resume', default='', type=str)
    p.add_argument('--checkpointname', default='baseline_ckpt', type=str)
    p.add_argument('--max_iters_per_epoch', type=int, default=None)
    p.add_argument('--log_dir', default='runs', type=str)
    p.add_argument('--device', default=None, help='cuda (the default) or cpu')
    return p


@dataclasses.dataclass
class BaselineRun:
    losses: List[float] = dataclasses.field(default_factory=list)        # each step's
    step_seconds: List[float] = dataclasses.field(default_factory=list)  # H2D to loss
    confusion: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    overall_acc: Dict[str, float] = dataclasses.field(default_factory=dict)
    miou: Dict[str, float] = dataclasses.field(default_factory=dict)
    eval_frames: Dict[str, int] = dataclasses.field(default_factory=dict)
    eval_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)
    checkpoint: str = ""        # the last checkpoint written
    loss_avg: float = 0.0       # the loss meter at the end (JAX main's return)


def build_model(name: str) -> nn.Module:
    """A baseline of ``BASELINES`` on the harness's 9 classes."""
    return BASELINES[name](n_class=N_CLASS)


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer):
    """``step(image, label)``: the train-mode forward of NHWC float32 frames,
    the ignore-(-1) cross-entropy, backward and one optimizer step; returns
    the loss (on the device)."""
    def step(image: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
        loss = cross_entropy_ignore(model(image), label, ignore_index=-1)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()
    return step


def harness_frames(ds: MFNetDataset) -> Iterator[Dict[str, np.ndarray]]:
    """Each item of an MFNet split as ``image`` (rgb_org and ir_org, the /255
    frames, concatenated: (1, 480, 640, 4)) and its ``label``, decoded ahead
    on threads."""
    for item in prefetch_items(ds):
        yield {"image": np.concatenate([item["rgb_org"], item["ir_org"]], axis=-1),
               "label": item["label"]}


def evaluate(model: nn.Module, data_dir: str, split: str, device: torch.device,
             run: Optional[BaselineRun] = None, logger: Optional[RunLogger] = None,
             mesh=None) -> np.ndarray:
    """The (9, 9) int64 confusion matrix of ``split`` (rows GT), counted on
    the device over eval-mode batches of 8 (with a ``mesh``, this process's
    rows of batches rounded up to its ``data`` size, summed over the
    processes); prints and logs the overall accuracy and mean IoU. ``model``
    returns to train mode."""
    ds = MFNetDataset(data_dir, split=split)
    cf = torch.zeros((N_CLASS, N_CLASS), dtype=torch.long, device=device)
    d = data_size(mesh)
    t0 = time.perf_counter()
    model.eval()
    try:
        with torch.no_grad():
            for batch, _ in batched(harness_frames(ds), -(-EVAL_BATCH // d) * d,
                                    pad_label=N_CLASS):
                image, label = shard_batch(mesh, (batch["image"], batch["label"]))
                pred = model(to_device(image, device)).argmax(dim=-1)
                cf += confusion_matrix(pred, to_device(label, device), N_CLASS)
    finally:
        model.train()
    if d > 1:
        torch.distributed.all_reduce(cf, group=data_group(mesh))
    cf = cf.cpu().numpy()
    overall_acc, _, iou = calculate_result(cf)
    miou = float(np.nanmean(iou[1:]))
    print(f"[{split}] overall_acc {overall_acc:.4f} mIoU {miou:.4f}")
    if logger is not None:
        logger.log({f"{split}_overall_acc": float(overall_acc), f"{split}_mIoU": miou})
    if run is not None:
        run.confusion[split] = cf
        run.overall_acc[split] = float(overall_acc)
        run.miou[split] = miou
        run.eval_frames[split] = len(ds)
        run.eval_seconds[split] = time.perf_counter() - t0
    return cf


def main(argv=None) -> BaselineRun:
    args = build_parser().parse_args(argv)
    device = resolve(args.device)
    # join the launcher's process group before any work (:72-75); eval rides
    # every process (:129-132)
    eval_mesh = None
    if maybe_initialize_distributed(device) and torch.distributed.get_world_size() > 1:
        eval_mesh = create_mesh()
    logger = RunLogger("baseline-" + args.model_name, log_dir=args.log_dir)
    logger.update_config(args)

    model = build_model(args.model_name)
    init_params(model, torch.Generator().manual_seed(0))
    if args.resume:
        model.load_state_dict(load_state_dict(args.resume), strict=True)
    prepare_for_training(model, device, dtype=torch.float32)
    optimizer = torch.optim.SGD(model.parameters(), lr=args.lr_start, momentum=0.9,
                                weight_decay=5e-4)
    run = BaselineRun()

    if args.test:
        evaluate(model, args.data_dir, "combined", device, run, logger, eval_mesh)
        logger.finish()
        return run

    train_ds = MFHarnessTrainDataset(args.data_dir,
                                     transform=default_train_augmentations(seed=0))
    step = make_train_step(model, optimizer)
    loss_meter = AverageMeter()
    for epo in range(args.epoch_from, args.epoch_max + 1):
        lr = args.lr_start * args.lr_decay ** (epo - 1)
        for group in optimizer.param_groups:
            group["lr"] = lr
        for i, raw in enumerate(batch_iterator(train_ds, args.batch_size, seed=epo)):
            if args.max_iters_per_epoch and i >= args.max_iters_per_epoch:
                break
            t0 = time.perf_counter()
            loss = float(step(to_device(raw["image"], device),
                              to_device(raw["label"], device)))
            run.step_seconds.append(time.perf_counter() - t0)
            run.losses.append(loss)
            loss_meter.update(loss)
            logger.log({"epoch": epo, "lr": lr, "loss": loss_meter.avg})
        print(f"epo {epo}/{args.epoch_max} lr {lr:.5f} loss {loss_meter.avg:.4f}")
        run.checkpoint = save_checkpoint({"epoch": epo, "state_dict": model.state_dict()},
                                         args.checkpointname)
    for split in ("day", "night"):
        evaluate(model, args.data_dir, split, device, run, logger, eval_mesh)
    logger.finish()
    run.loss_avg = loss_meter.avg
    return run


if __name__ == "__main__":
    main()
