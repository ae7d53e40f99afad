"""IR segmentation + uncertainty pretrainer, the ``train_ir_uncertainty.py`` surface.

Counterpart of ``heatnet_tpu/cli/train_uncertainty.py:13-125`` (the same
flags plus ``--device``): two ``ResNeXtEncoder``s (``--structure``, 1-channel
IR, 12 and 1 classes), a seg decoder and a sigmoid uncertainty decoder,
trained by ``train.uncertainty``'s step under one Adam(0.5, 0.999) with the
CycleGAN linear decay. The chain per step: a Freiburg PNG training tree or
a heatnet-train-pack-v1 directory (``open_freiburg_train``) → numpy batches → ``DeviceAugment`` (320x640 crops on the card)
→ the day IR and labels subsampled ``[:, ::4, ::4]`` to 80x160 → the step.
It prints the meters' ``Segmentation loss``/``Uncertainty Loss`` line per
step and writes ``{"epoch", "state_dict"}`` to ``<checkpointname>.pth``
every epoch (keys ``encoder1.``, ``encoder2.``, ``seg_decoder.``,
``unc_decoder.``).

Weights are random (seeds 0-3); runs on the card unless ``--device cpu``.
Under PyTorch's launcher the process joins the process group before any
device use, as JAX's joins ``jax.distributed`` (:40, :51); like JAX's, it
builds no mesh, so each process trains on the whole batch.

Usage::

    python -m heatnet_tpu_torch.cli.train_uncertainty --dataroot TREE_OR_PACK --n_epochs 1
"""

from __future__ import annotations

import argparse
import time

import torch

from ..data.loaders import DeviceAugment, batch_iterator, open_freiburg_train
from ..device import resolve
from ..io.checkpoint import save_checkpoint
from ..io.logging import AverageMeter, RunLogger
from ..models.segnetsplit import ResNeXtDecoder, ResNeXtEncoder
from ..parallel.mesh import maybe_initialize_distributed
from ..train.optim import lambda_linear_decay
from ..train.state import init_model
from ..train.uncertainty import MODULE_NAMES, create_state, make_uncertainty_step
from .train_plain import CROP, TrainRun

SUBSAMPLE = 4  # the reference's [:, ::4, ::4] (train_ir_uncertainty.py:168-170)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="IR uncertainty pretrainer (PyTorch/CUDA)")
    p.add_argument('--epoch', type=int, default=0)
    p.add_argument('--n_epochs', type=int, default=100)
    p.add_argument('--dataroot', type=str, required=True,
                   help='Freiburg PNG training tree or heatnet-train-pack-v1 directory')
    p.add_argument('--lr', type=float, default=0.0001)
    p.add_argument('--decay_epoch', type=int, default=50)
    p.add_argument('--batch_size', type=int, default=4)
    p.add_argument('--cuda', action='store_true', help='parity no-op')
    p.add_argument('--n_cpu', type=int, default=8)
    # additive knobs
    p.add_argument('--structure', nargs=4, type=int, default=[2, 2, 2, 2])
    p.add_argument('--max_iters_per_epoch', type=int, default=None)
    p.add_argument('--checkpointname', type=str, default='ir_uncertainty')
    p.add_argument('--log_dir', type=str, default='runs')
    p.add_argument('--device', default=None, help='cuda (the default) or cpu')
    return p


def build_modules(structure, device: torch.device) -> dict:
    """The four modules, random weights from seeds 0-3, train mode on ``device``."""
    structure = tuple(structure)
    mods = {"encoder1": ResNeXtEncoder(structure=structure, in_channels=1, classes=12),
            "encoder2": ResNeXtEncoder(structure=structure, in_channels=1, classes=1),
            "seg_decoder": ResNeXtDecoder(out_classes=12),
            "unc_decoder": ResNeXtDecoder(out_classes=1, last_activation="sigmoid")}
    return {k: init_model(mods[k], seed, device) for seed, k in enumerate(MODULE_NAMES)}


def subsample(aug: dict) -> dict:
    """The step's batch: day IR and labels at every 4th pixel."""
    s = SUBSAMPLE
    return {"ir": aug["ir_day"][:, ::s, ::s, :].contiguous(),
            "label": aug["label_day"][:, ::s, ::s].contiguous()}


def main(argv=None) -> TrainRun:
    opt = build_parser().parse_args(argv)
    device = resolve(opt.device)
    maybe_initialize_distributed(device)  # (:51)
    logger = RunLogger("hotnet-uncertainty", log_dir=opt.log_dir)

    mods = build_modules(opt.structure, device)
    ds = open_freiburg_train(opt.dataroot, split="train")
    augment = DeviceAugment(crop_hw=CROP, device=device)
    steps_per_epoch = max(len(ds) // opt.batch_size, 1)
    if opt.max_iters_per_epoch:
        steps_per_epoch = min(steps_per_epoch, opt.max_iters_per_epoch)
    state = create_state(mods, lambda_linear_decay(
        opt.n_epochs, opt.epoch, opt.decay_epoch, opt.lr, steps_per_epoch))
    step = make_uncertainty_step(*(mods[k] for k in MODULE_NAMES))

    seg_meter, unc_meter = AverageMeter(), AverageMeter()
    run = TrainRun([], [], "")
    generator = torch.Generator().manual_seed(7)
    for epoch in range(opt.epoch, opt.n_epochs):
        for i, raw in enumerate(batch_iterator(ds, opt.batch_size, seed=epoch)):
            if opt.max_iters_per_epoch and i >= opt.max_iters_per_epoch:
                break
            t0 = time.perf_counter()
            metrics = step(state, subsample(augment(generator, raw)))
            seg, unc = (float(metrics[k]) for k in ("Segmentation Loss",
                                                    "Uncertainty Loss"))
            run.step_seconds.append(time.perf_counter() - t0)
            run.losses.append(seg + unc)
            seg_meter.update(seg)
            unc_meter.update(unc)
            print("Segmentation loss: %f , Uncertainty Loss: %f"
                  % (seg_meter.avg, unc_meter.avg))
            logger.log({"epoch": epoch, "Uncertainty Loss": unc_meter.avg,
                        "Segmentation Loss": seg_meter.avg})
        run.checkpoint = save_checkpoint(
            {"epoch": epoch + 1, "state_dict": state.model.state_dict()},
            opt.checkpointname + ".pth")
    logger.finish()
    return run


if __name__ == "__main__":
    main()
