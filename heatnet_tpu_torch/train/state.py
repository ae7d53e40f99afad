"""Train state: the model (parameters and BN statistics), optimizer, schedule.

Counterpart of ``heatnet_tpu/train/state.py:21-78``. The JAX state is an
immutable pytree threaded through jitted steps; here the module and the
optimizer update in place, and the BN running statistics update during the
train-mode forward.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
import torch.nn as nn
from torch.optim.lr_scheduler import LRScheduler

from ..device import resolve
from ..models.layers import init_params, prepare_for_training


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: LRScheduler
    step: int = 0

    def apply_gradients(self) -> None:
        """One optimizer step on the parameters' ``.grad``, then one
        schedule step; the gradients are cleared."""
        self.optimizer.step()
        self.scheduler.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1


def init_model(model: nn.Module, seed: int = 0,
               device: Optional[Union[str, torch.device]] = None) -> nn.Module:
    """Random weights from ``seed`` (``layers.init_params``), then train mode
    on ``device`` (the card unless the caller asks for the CPU)."""
    init_params(model, torch.Generator().manual_seed(seed))
    return prepare_for_training(model, resolve(device))
