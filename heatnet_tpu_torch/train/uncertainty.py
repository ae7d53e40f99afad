"""The IR segmentation + uncertainty pretrainer's step.

Counterpart of ``heatnet_tpu/train/uncertainty.py:27-90``: two
``ResNeXtEncoder``s on 1-channel IR (12 and 1 classes), a seg decoder and a
sigmoid uncertainty decoder, trained in one step under one Adam(0.5, 0.999).
The uncertainty decoder regresses the seg head's per-pixel cross-entropy,
detached: the loss is ``CE(seg) + mean((unc - CE_pixels)^2)``, labels -1
ignored.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn as nn

from .optim import with_schedule
from .state import TrainState
from .supervised import cross_entropy_ignore

MODULE_NAMES = ("encoder1", "encoder2", "seg_decoder", "unc_decoder")


def create_state(modules: Dict[str, nn.Module], schedule: Callable) -> TrainState:
    """One Adam(0.5, 0.999) over the four modules (``MODULE_NAMES``) at
    ``schedule``; the state's model is their ``ModuleDict``."""
    model = nn.ModuleDict({k: modules[k] for k in MODULE_NAMES})
    opt = torch.optim.Adam(model.parameters(), lr=1.0, betas=(0.5, 0.999))
    return TrainState(model, opt, with_schedule(opt, schedule))


def make_uncertainty_step(encoder1: nn.Module, encoder2: nn.Module,
                          seg_decoder: nn.Module, unc_decoder: nn.Module):
    """``step(state, {ir, label}) -> metrics``: the four modules in train
    mode, one backward, the Adam and schedule steps."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        ir, label = batch["ir"], batch["label"]
        state.model.train()
        enc1, out41 = encoder1(ir)
        enc2, out42 = encoder2(ir)
        seg = seg_decoder(enc1, out41)
        unc = unc_decoder(enc2, out42)
        seg_loss = cross_entropy_ignore(seg, label, ignore_index=-1)
        unc_gt = cross_entropy_ignore(seg.detach(), label, ignore_index=-1, reduce=False)
        unc_loss = torch.mean((unc[..., 0] - unc_gt) ** 2)
        (seg_loss + unc_loss).backward()
        state.apply_gradients()
        return {"Segmentation Loss": seg_loss.detach(),
                "Uncertainty Loss": unc_loss.detach()}

    return step
