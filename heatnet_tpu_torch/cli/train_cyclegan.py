"""CycleGAN day↔night IR translation trainer with joint segmentation.

Counterpart of ``heatnet_tpu/cli/train_cyclegan.py:16-143`` (the
``models/cyclegan/train.py`` flag surface, plus ``--device``): two
``Generator``s, two ``Discriminator``s and a ``ResNeXtSeg`` netSeg
(``--seg_structure``, 1-channel IR input, ``--n_classes``) trained by
``train.cyclegan``'s three steps per batch, Adam(0.5, 0.999) with the
CycleGAN linear decay, fakes replayed through two device buffers of 50.
The chain per step: a KAIST tree → ``KAISTCycleGANDataset`` items →
numpy batches → the card → generator step (netSeg in train mode on real_A
and fake_B) → replay → D_A and D_B steps. It prints one line per step,
keeps the ``loss_G`` and ``loss_D`` meters, and at each epoch's end writes
``<checkpoint_dir>/{netG_A2B,netG_B2A,netD_A,netD_B,netSeg}.pth``, each a
port ``state_dict`` (netSeg's with its BN running statistics), which
``cli.test_cyclegan`` loads. Returns the last step's ``loss_G``.

Weights are random (seeds 0-4); runs on the card unless ``--device cpu``.

Usage::

    python -m heatnet_tpu_torch.cli.train_cyclegan --dataroot KAIST_ROOT --n_epochs 1
"""

from __future__ import annotations

import argparse
import os

import torch

from ..data.loaders import KAISTCycleGANDataset, batch_iterator, to_device
from ..device import resolve
from ..io.checkpoint import save_checkpoint
from ..io.logging import AverageMeter, RunLogger
from ..parallel.mesh import maybe_initialize_distributed
from ..models import ResNeXtSeg
from ..models.cyclegan import Discriminator, Generator
from ..train.cyclegan import (NET_NAMES, CycleGANState, DeviceReplayBuffer,
                              make_cyclegan_steps)
from ..train.optim import lambda_linear_decay
from ..train.state import init_model

REPLAY = 50  # the reference's ReplayBuffer size


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="CycleGAN IR translation trainer (PyTorch/CUDA)")
    p.add_argument('--epoch', type=int, default=0)
    p.add_argument('--n_epochs', type=int, default=200)
    p.add_argument('--batchSize', type=int, default=2)
    p.add_argument('--dataroot', type=str, default='datasets/thermal/KAIST/')
    p.add_argument('--lr', type=float, default=0.0002)
    p.add_argument('--decay_epoch', type=int, default=100)
    p.add_argument('--size', type=int, default=256,
                   help='parity no-op: the loader gives 256x256 frames')
    p.add_argument('--input_nc', type=int, default=1)
    p.add_argument('--output_nc', type=int, default=1)
    p.add_argument('--cuda', action='store_true', help='parity no-op')
    p.add_argument('--n_cpu', type=int, default=8)
    p.add_argument('--n_classes', type=int, default=12)
    # additive knobs
    p.add_argument('--max_iters_per_epoch', type=int, default=None)
    p.add_argument('--n_residual_blocks', type=int, default=9)
    p.add_argument('--seg_structure', nargs=4, type=int, default=[3, 4, 6, 3])
    p.add_argument('--checkpoint_dir', type=str, default='cyclegan_ckpts')
    p.add_argument('--log_dir', type=str, default='runs')
    p.add_argument('--device', default=None, help='cuda (the default) or cpu')
    return p


def build_nets(opt: argparse.Namespace, device: torch.device) -> dict:
    """The five nets, random weights from seeds 0-4, in train mode on ``device``."""
    nets = {
        "netG_A2B": Generator(opt.output_nc, opt.n_residual_blocks, input_nc=opt.input_nc),
        "netG_B2A": Generator(opt.input_nc, opt.n_residual_blocks, input_nc=opt.output_nc),
        "netD_A": Discriminator(opt.input_nc),
        "netD_B": Discriminator(opt.output_nc),
        "netSeg": ResNeXtSeg(structure=tuple(opt.seg_structure),
                             input_channels=opt.input_nc, classes=opt.n_classes),
    }
    return {k: init_model(nets[k], seed, device) for seed, k in enumerate(NET_NAMES)}


def device_batch(batch, device: torch.device) -> dict:
    return {"A": to_device(batch["A"], device), "B": to_device(batch["B"], device),
            "label": to_device(batch["label"], device).long()}


def main(argv=None) -> float:
    opt = build_parser().parse_args(argv)
    device = resolve(opt.device)
    # under a launcher, join its process group before any work (:56-59); each
    # process then trains the same nets, as the JAX trainer's processes do
    maybe_initialize_distributed(device)
    logger = RunLogger("cyclegan", log_dir=opt.log_dir)

    nets = build_nets(opt, device)
    ds = KAISTCycleGANDataset(opt.dataroot)
    steps_per_epoch = max(len(ds) // opt.batchSize, 1)
    if opt.max_iters_per_epoch:
        steps_per_epoch = min(steps_per_epoch, opt.max_iters_per_epoch)
    state = CycleGANState.create(nets, lambda_linear_decay(
        opt.n_epochs, opt.epoch, opt.decay_epoch, opt.lr, steps_per_epoch))
    g_step, d_a_step, d_b_step = make_cyclegan_steps(
        *(nets[k] for k in ("netG_A2B", "netG_B2A", "netD_A", "netD_B", "netSeg")))

    # device buffers, shaped by the first generator output (the loader's size)
    buf_a = buf_b = None
    replay_draws = torch.Generator().manual_seed(opt.epoch)
    meters = {k: AverageMeter() for k in ("loss_G", "loss_D")}
    os.makedirs(opt.checkpoint_dir, exist_ok=True)
    last_g = 0.0
    for epoch in range(opt.epoch, opt.n_epochs):
        for i, raw in enumerate(batch_iterator(ds, opt.batchSize, seed=epoch)):
            if opt.max_iters_per_epoch and i >= opt.max_iters_per_epoch:
                break
            batch = device_batch(raw, device)
            fake_a, fake_b, metrics = g_step(state, batch)
            if buf_a is None:
                buf_a = DeviceReplayBuffer(REPLAY, fake_a.shape[1:], device)
                buf_b = DeviceReplayBuffer(REPLAY, fake_b.shape[1:], device)
            fa = buf_a.push_and_pop(fake_a, replay_draws)
            fb = buf_b.push_and_pop(fake_b, replay_draws)
            loss_d = float(d_a_step(state, batch["A"], fa)) + float(
                d_b_step(state, batch["B"], fb))
            metrics = {k: float(v) for k, v in metrics.items()}
            last_g = metrics["loss_G"]
            meters["loss_G"].update(last_g)
            meters["loss_D"].update(loss_d)
            print(f"epoch {epoch} step {i}: loss_G {last_g:.6f} (avg "
                  f"{meters['loss_G'].avg:.6f}), loss_D {loss_d:.6f} (avg "
                  f"{meters['loss_D'].avg:.6f})", flush=True)
            logger.log({"epoch": epoch, **metrics, "loss_D": loss_d})
        for name in NET_NAMES:
            save_checkpoint(nets[name].state_dict(),
                            os.path.join(opt.checkpoint_dir, name + ".pth"))
    logger.finish()
    return last_g


if __name__ == "__main__":
    main()
