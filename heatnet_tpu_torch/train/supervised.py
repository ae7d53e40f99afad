"""Supervised segmentation training: the loss and the train and eval steps.

Counterpart of ``heatnet_tpu/train/supervised.py:37-128``. BatchNorm
statistics span the whole batch on the one card, as they span the global
batch under the JAX package's sharded ``jit``.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn as nn

from ..ops.iou import confusion_matrix
from .state import TrainState

IGNORE_INDEX = 13


def cross_entropy_ignore(logits: torch.Tensor, labels: torch.Tensor,
                         ignore_index: int = IGNORE_INDEX,
                         reduce: bool = True) -> torch.Tensor:
    """Cross-entropy over NHWC logits and NHW integer labels, pixels labelled
    ``ignore_index`` masked out; the mean over the others, and 0 when every
    pixel is masked (where ``F.cross_entropy`` gives NaN)."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0).long()
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, 0.0)
    if not reduce:
        return nll
    return nll.sum() / valid.sum().clamp(min=1)


def robust_loss(loss: torch.Tensor, a: float = 0.5, c: float = 1.0) -> torch.Tensor:
    """Barron's general robust loss of a residual or loss tensor
    (``models/confusion_maximization/utils.py:13-26``):
    ``(b/d) * ((((loss/c)^2)/b + 1)^(d/2) - 1)``, ``b = |2-a|+eps``,
    ``d = a±eps``."""
    e = 1e-05
    b = abs(2.0 - a) + e
    d = a + e if a >= 0.0 else a - e
    return (b / d) * (torch.pow(torch.square(loss / c) / b + 1.0, 0.5 * d) - 1.0)


def _accuracy(seg: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    valid = labels != IGNORE_INDEX
    hit = valid & (seg.argmax(-1) == labels)
    return hit.sum() / valid.sum().clamp(min=1)


def make_train_step(model: nn.Module, learn_batch_stats: bool = True):
    """The supervised step: ``(state, batch) -> (state, metrics)``.

    ``batch`` holds ``image`` (NHWC, normalised) and ``label`` (NHW int).
    With ``learn_batch_stats=False`` the BN running statistics are restored
    after the train-mode forward, as the JAX step keeps the old ones.
    """

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, Any]]:
        model.train()
        kept = (None if learn_batch_stats
                else [b.detach().clone() for b in model.buffers()])
        seg, _, _ = model(batch["image"])
        loss = cross_entropy_ignore(seg, batch["label"])
        loss.backward()
        state.apply_gradients()
        if kept is not None:
            with torch.no_grad():
                for b, k in zip(model.buffers(), kept):
                    b.copy_(k)
        with torch.no_grad():
            acc = _accuracy(seg, batch["label"])
        return state, {"loss": loss.detach(), "accuracy": acc}

    return train_step


def make_eval_step(model: nn.Module, num_classes: int = 14):
    """The eval step: ``(state, batch) -> (K, K)`` confusion matrix on the device."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch) -> torch.Tensor:
        model.eval()
        seg, _, _ = model(batch["image"])
        return confusion_matrix(seg.argmax(-1), batch["label"], num_classes)

    return eval_step
