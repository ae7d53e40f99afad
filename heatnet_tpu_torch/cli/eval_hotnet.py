"""The multi-run evaluator, the ``eval_hotnet.py`` surface.

Counterpart of ``heatnet_tpu/cli/eval_hotnet.py:30-102``: each ``--runs``
directory holds ``config.json`` (a run's logged CLI config) and the port's
``checkpoint_best.pth`` (a ``cli.train_conf`` checkpoint, whose segnet keys
carry the ``trgb_segnet.`` prefix, or a bare segnet ``state_dict``). The
segnet is ``ResNeXtSeg`` (``arch`` ``custom``: ``structure``,
``modalities``, ``cert_branch``, ``late_fusion`` from the config) or
PSPNet-ResNet-50 (``build_network``), loaded strictly and prepared for
inference (bf16 on the card, as the JAX tool's). The Freiburg validators run
night (``--testroot_night`` and ``--testroot_fence``) then day, the frames
decoded ahead on threads; the combined mIoU, the mean of the two IoU
vectors' average, is printed and logged per run.

A JAX run directory (an orbax ``checkpoint_best/`` directory) cannot be
read here: convert it with ``heatnet_tpu_torch/io/from_jax.py::
state_dict_from_jax`` where JAX runs (ROADMAP item 8).

Usage::

    python -m heatnet_tpu_torch.cli.eval_hotnet --runs RUN [RUN ...] \\
        --testroot_day DAY --testroot_night NIGHT
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Tuple

import numpy as np
import torch

from ..data.loaders import FreiburgThermalTestDataset, get_test_paths, prefetch_items
from ..device import resolve
from ..eval.validate import validate_model
from ..io.checkpoint import load_state_dict
from ..io.logging import RunLogger
from ..models import ResNeXtSeg, build_network
from ..models.conf_segnet import num_input_channels
from ..models.layers import prepare_for_inference

SEGNET_PREFIX = "trgb_segnet."


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument('--runs', nargs='+', required=True,
                   help='run directories (config.json + checkpoint_best.pth)')
    p.add_argument('--testroot_day', type=str, required=True)
    p.add_argument('--testroot_night', type=str, required=True)
    p.add_argument('--testroot_fence', type=str, default='')
    p.add_argument('--log_dir', type=str, default='runs')
    p.add_argument('--device', default=None, help='cuda (the default) or cpu')
    return p


def segnet_state_dict(saved: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The segnet's entries of a ``cli.train_conf`` checkpoint, the prefix
    stripped; a bare segnet ``state_dict`` as it is."""
    if any(k.startswith(SEGNET_PREFIX) for k in saved):
        return {k[len(SEGNET_PREFIX):]: v for k, v in saved.items()
                if k.startswith(SEGNET_PREFIX)}
    return dict(saved)


def load_run(run_dir: str, device: torch.device) -> Tuple[torch.nn.Module, str]:
    """The run's segnet, prepared for inference, and its modalities."""
    with open(os.path.join(run_dir, "config.json")) as f:
        cfg = json.load(f)
    modalities = cfg.get("modalities", "ir_rgb")
    n_in = num_input_channels(modalities)
    if cfg.get("arch", "custom") == "custom":
        model = ResNeXtSeg(structure=tuple(cfg.get("structure", (3, 4, 6, 3))),
                           input_channels=n_in, cert_branch=cfg.get("cert_branch", False),
                           late_fusion=cfg.get("late_fusion", False))
    else:
        model = build_network("resnet50", in_channels=n_in,
                              late_fusion=cfg.get("late_fusion", False))
    path = os.path.join(run_dir, "checkpoint_best.pth")
    if not os.path.exists(path) and os.path.isdir(os.path.join(run_dir, "checkpoint_best")):
        raise ValueError(
            f"{run_dir} holds an orbax checkpoint_best/ directory, which the port cannot "
            "read: convert its params and batch_stats with heatnet_tpu_torch/io/"
            "from_jax.py::state_dict_from_jax where JAX runs and save them as "
            "checkpoint_best.pth (ROADMAP item 8)")
    model.load_state_dict(segnet_state_dict(load_state_dict(path)), strict=True)
    return prepare_for_inference(model, device), modalities


def main(argv=None) -> Dict[str, float]:
    args = build_parser().parse_args(argv)
    device = resolve(args.device)
    logger = RunLogger("hotnet-eval", log_dir=args.log_dir)
    night_roots = [r for r in (args.testroot_night, args.testroot_fence) if r]
    results = {}
    for run_dir in args.runs:
        model, modalities = load_run(run_dir, device)
        ious_night = validate_model(
            model, prefetch_items(FreiburgThermalTestDataset(*get_test_paths(night_roots))),
            modalities, mode="night", logger=logger, device=device)
        ious_day = validate_model(
            model, prefetch_items(FreiburgThermalTestDataset(
                *get_test_paths([args.testroot_day]))),
            modalities, mode="day", logger=logger, device=device)
        combined = float(np.nanmean((ious_day + ious_night) / 2))
        name = os.path.basename(os.path.normpath(run_dir))
        results[name] = combined
        print(f"{name}: combined mIoU {combined:.4f}")
        logger.log({f"{name}_combined_mIoU": combined})
    logger.finish()
    return results


if __name__ == "__main__":
    main()
