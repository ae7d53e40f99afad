"""CycleGAN test CLI: translations of every KAIST frame, and netSeg on night IR.

Counterpart of ``heatnet_tpu/cli/test_cyclegan.py:13-93`` (``cyclegan/test.py``
and ``test_ir_segmentation.py``; the same flags plus ``--device``): loads
``netG_A2B.pth`` and ``netG_B2A.pth`` from ``--checkpoint_dir`` (as
``cli.train_cyclegan`` writes them) and writes ``<output_dir>/A/<i>.png`` and
``B/<i>.png``, ``0.5·(x + 1)`` of each translation, with ``utils.vis.save_image``.
With ``--run_seg`` it also loads ``netSeg.pth`` and writes
``seg_<i>.png``, the colour-coded argmax of the eval-mode netSeg on real_B:
its grouped convs are the fused kernel's launches (bn3 + relu in the
epilogue). Frames go one at a time (batch 1). Returns the number of frames.

Runs on the card unless ``--device cpu``.

Usage::

    python -m heatnet_tpu_torch.cli.test_cyclegan --dataroot KAIST_ROOT \\
        --checkpoint_dir cyclegan_ckpts --run_seg
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..data.loaders import KAISTCycleGANDataset, to_device
from ..device import resolve
from ..io.checkpoint import load_state_dict
from ..models import ResNeXtSeg
from ..models.cyclegan import Generator
from ..models.layers import prepare_for_inference
from ..utils.vis import color_code_labels, save_image


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="CycleGAN test (PyTorch/CUDA)")
    p.add_argument('--dataroot', required=True)
    p.add_argument('--checkpoint_dir', required=True,
                   help='dir with netG_A2B / netG_B2A / netSeg checkpoints')
    p.add_argument('--output_dir', default='cyclegan_output')
    p.add_argument('--size', type=int, default=256,
                   help='parity no-op: the loader gives 256x256 frames')
    p.add_argument('--input_nc', type=int, default=1)
    p.add_argument('--output_nc', type=int, default=1)
    p.add_argument('--n_residual_blocks', type=int, default=9)
    p.add_argument('--seg_structure', nargs=4, type=int, default=[3, 4, 6, 3])
    p.add_argument('--n_classes', type=int, default=12)
    p.add_argument('--limit', type=int, default=None)
    p.add_argument('--run_seg', action='store_true',
                   help='also run netSeg on night IR (test_ir_segmentation)')
    p.add_argument('--device', default=None, help='cuda (the default) or cpu')
    return p


def _load(net: torch.nn.Module, path: str, device: torch.device) -> torch.nn.Module:
    net.load_state_dict(load_state_dict(path), strict=True)
    return prepare_for_inference(net, device)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve(args.device)

    ckpt = lambda name: os.path.join(args.checkpoint_dir, name + ".pth")  # noqa: E731
    gen_a2b = _load(Generator(args.output_nc, args.n_residual_blocks, input_nc=args.input_nc),
                    ckpt("netG_A2B"), device)
    gen_b2a = _load(Generator(args.input_nc, args.n_residual_blocks, input_nc=args.output_nc),
                    ckpt("netG_B2A"), device)
    seg_net = None
    if args.run_seg:
        seg_net = _load(ResNeXtSeg(structure=tuple(args.seg_structure),
                                   input_channels=args.input_nc, classes=args.n_classes),
                        ckpt("netSeg"), device)

    ds = KAISTCycleGANDataset(args.dataroot)
    os.makedirs(os.path.join(args.output_dir, "A"), exist_ok=True)
    os.makedirs(os.path.join(args.output_dir, "B"), exist_ok=True)
    n = len(ds) if args.limit is None else min(args.limit, len(ds))
    for i in range(n):
        item = ds[i]
        real_a = to_device(item["A"][None], device)
        real_b = to_device(item["B"][None], device)
        with torch.no_grad():
            fake_b = 0.5 * (gen_a2b(real_a)[0].cpu().numpy() + 1.0)
            fake_a = 0.5 * (gen_b2a(real_b)[0].cpu().numpy() + 1.0)
            pred = (None if seg_net is None
                    else seg_net(real_b)[0].argmax(-1)[0].cpu().numpy())
        save_image(os.path.join(args.output_dir, "B", f"{i:04d}.png"), fake_b[..., 0])
        save_image(os.path.join(args.output_dir, "A", f"{i:04d}.png"), fake_a[..., 0])
        if pred is not None:
            save_image(os.path.join(args.output_dir, f"seg_{i:04d}.png"),
                       color_code_labels(pred.astype(np.int64)))
        if i % 50 == 0:
            print(f"Generated images {i:04d} of {n:04d}")
    return n


if __name__ == "__main__":
    main()
