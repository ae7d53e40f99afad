"""Plain supervised RGB+IR trainer, the ``train_trgb_segnet_plain.py`` surface.

Counterpart of ``heatnet_tpu/cli/train_plain.py:12-118``: early-fusion
ResNeXtSeg (4 input channels), cross-entropy on the day labels only,
Adam(0.5, 0.999) with the CycleGAN linear-decay schedule, one checkpoint per
epoch. The chain per step: a Freiburg PNG training tree or a
heatnet-train-pack-v1 directory (``data/loaders.py::open_freiburg_train``,
``split="train"``) → numpy batches → augmentation on the device → train-mode forward (bf16 activations
on the card) → loss → backward → Adam step → schedule step. It prints the
same ``Current loss`` line per step.

Weights are random from seed 0; ``--resume_partial`` loads the entries of a
PyTorch checkpoint that match in name and shape. Checkpoints are
``torch.save({"epoch", "state_dict"})`` files, ``<checkpointname>.pth``,
which ``cli/inference.py --resume`` loads. Runs on the card unless
``--device cpu``. A tree decodes five PNGs per item on the host; its pack
(``cli/pack_frames.py --train``) serves the same items with no decode.

Usage::

    python -m heatnet_tpu_torch.cli.train_plain --dataroot TREE_OR_PACK --n_epochs 1
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List

import torch

from ..data.loaders import DeviceAugment, batch_iterator, open_freiburg_train
from ..device import resolve
from ..io.checkpoint import load_state_dict, restore_partial, save_checkpoint
from ..io.logging import AverageMeter, RunLogger
from ..models import ResNeXtSeg
from ..train.optim import lambda_linear_decay, with_schedule
from ..train.state import TrainState, init_model
from ..train.supervised import cross_entropy_ignore

CROP = (320, 640)  # the train crop after the 150:850 window (train_plain.py:64)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="HeatNet plain trainer (PyTorch/CUDA)")
    p.add_argument('--epoch', type=int, default=0)
    p.add_argument('--n_epochs', type=int, default=200)
    p.add_argument('--batchSize', type=int, default=2, help='parity alias')
    p.add_argument('--dataroot', type=str, required=True,
                   help='Freiburg PNG training tree or heatnet-train-pack-v1 directory')
    p.add_argument('--lr', type=float, default=0.0002)
    p.add_argument('--decay_epoch', type=int, default=100)
    p.add_argument('--size', type=int, default=256)
    p.add_argument('--input_nc', type=int, default=1)
    p.add_argument('--output_nc', type=int, default=1)
    p.add_argument('--cuda', action='store_true', help='parity no-op')
    p.add_argument('--n_cpu', type=int, default=8)
    p.add_argument('--batch_size', type=int, default=10)
    # additive knobs
    p.add_argument('--structure', nargs=4, type=int, default=[3, 4, 6, 3])
    p.add_argument('--max_iters_per_epoch', type=int, default=None)
    p.add_argument('--resume_partial', type=str, default='',
                   help='PyTorch checkpoint for an initModelPartial-style warm start')
    p.add_argument('--checkpointname', type=str, default='trgb_segnet')
    p.add_argument('--log_dir', type=str, default='runs')
    p.add_argument('--device', default=None, help='cuda (the default) or cpu')
    return p


@dataclasses.dataclass
class TrainRun:
    losses: List[float]         # each step's loss
    step_seconds: List[float]   # each step, augmentation to loss on the host
    checkpoint: str             # the last checkpoint written


def create_state(model: torch.nn.Module, opt: argparse.Namespace,
                 steps_per_epoch: int) -> TrainState:
    """Adam(0.5, 0.999) with the linear-decay schedule of ``opt``."""
    sched = lambda_linear_decay(opt.n_epochs, opt.epoch, opt.decay_epoch,
                                opt.lr, steps_per_epoch)
    optimizer = torch.optim.Adam(model.parameters(), lr=1.0, betas=(0.5, 0.999))
    return TrainState(model, optimizer, with_schedule(optimizer, sched))


def train_step(state: TrainState, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One step on an augmented batch: forward, CE on the day labels (no
    ignore index: -1), backward, Adam and schedule steps. Returns the loss."""
    model = state.model
    model.train()
    seg, _, _ = model(batch["rgb_day"], batch["ir_day"])
    loss = cross_entropy_ignore(seg, batch["label_day"], ignore_index=-1)
    loss.backward()
    state.apply_gradients()
    return loss.detach()


def main(argv=None) -> TrainRun:
    opt = build_parser().parse_args(argv)
    device = resolve(opt.device)
    logger = RunLogger("HotNetConf", log_dir=opt.log_dir)

    model = init_model(ResNeXtSeg(structure=tuple(opt.structure), input_channels=4),
                       seed=0, device=device)
    if opt.resume_partial:
        restore_partial(model, load_state_dict(opt.resume_partial))
    ds = open_freiburg_train(opt.dataroot, split="train")
    augment = DeviceAugment(crop_hw=CROP, device=device)

    steps_per_epoch = max(len(ds) // opt.batch_size, 1)
    if opt.max_iters_per_epoch:
        steps_per_epoch = min(steps_per_epoch, opt.max_iters_per_epoch)
    state = create_state(model, opt, steps_per_epoch)

    meter = AverageMeter()
    run = TrainRun([], [], "")
    generator = torch.Generator().manual_seed(0)
    for epoch in range(opt.epoch, opt.n_epochs):
        for i, raw in enumerate(batch_iterator(ds, opt.batch_size, seed=epoch)):
            if opt.max_iters_per_epoch and i >= opt.max_iters_per_epoch:
                break
            t0 = time.perf_counter()
            loss = float(train_step(state, augment(generator, raw)))
            run.step_seconds.append(time.perf_counter() - t0)
            run.losses.append(loss)
            meter.update(loss)
            print("Current loss: %f " % meter.avg)
            logger.log({"epoch": epoch, "loss": meter.avg})
        run.checkpoint = save_checkpoint(
            {"epoch": epoch + 1, "state_dict": model.state_dict()},
            opt.checkpointname + ".pth")
    logger.finish()
    return run


if __name__ == "__main__":
    main()
