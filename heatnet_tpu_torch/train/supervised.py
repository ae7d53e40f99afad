"""Supervised segmentation training: the loss and the train and eval steps.

Counterpart of ``heatnet_tpu/train/supervised.py:37-128``. BatchNorm
statistics span the whole batch on the one card, as they span the global
batch under the JAX package's sharded ``jit``, unless the model's
``NormAct.bn_groups`` splits it. Over a data-parallel mesh
(``parallel/mesh.py``) the step takes the mean loss of the whole batch: each
process sums its rows' cross-entropy over the whole batch's valid count and
the gradients are summed over the processes. A model with train-mode dropout (PSPNet)
takes its keep masks per step as an argument (``draw_dropout``, from the
caller's ``torch.Generator``), where the JAX step folds the step count into
a dropout key.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn

from ..ops.iou import confusion_matrix
from ..parallel.mesh import all_reduce_gradients, global_count
from .state import TrainState

IGNORE_INDEX = 13


def cross_entropy_ignore(logits: torch.Tensor, labels: torch.Tensor,
                         ignore_index: int = IGNORE_INDEX,
                         reduce: bool = True) -> torch.Tensor:
    """Cross-entropy over NHWC logits and NHW integer labels, pixels labelled
    ``ignore_index`` masked out; the mean over the others, and 0 when every
    pixel is masked (where ``F.cross_entropy`` gives NaN).

    A label outside ``[-classes, classes)`` that is not ignored gives NaN, as
    the JAX version's ``take_along_axis`` fills it (a 12-class head fed
    label 12); a gather there would fault on the card. Negative labels
    count from the end, as there."""
    classes = logits.shape[-1]
    valid = labels != ignore_index
    inside = (labels >= -classes) & (labels < classes)
    safe = torch.where(valid & inside, labels, 0).long().remainder(classes)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, torch.where(inside, nll, float("nan")), 0.0)
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


def make_train_step(model: nn.Module, learn_batch_stats: bool = True, mesh=None):
    """The supervised step: ``(state, batch, dropout=None) -> (state, metrics)``.

    ``batch`` holds ``image`` (NHWC, normalised) and ``label`` (NHW int);
    ``dropout`` is a PSPNet's keep masks for this step (``draw_dropout``).
    With ``learn_batch_stats=False`` the BN running statistics are restored
    after the train-mode forward, as the JAX step keeps the old ones. With a
    ``mesh`` the batch is this process's rows of the whole batch, and the
    loss in ``metrics`` is the whole batch's.
    """

    def train_step(state: TrainState, batch,
                   dropout: Optional[tuple] = None) -> Tuple[TrainState, Dict[str, Any]]:
        model.train()
        kept = (None if learn_batch_stats
                else [b.detach().clone() for b in model.buffers()])
        kw = {} if dropout is None else {"dropout": dropout}
        seg, _, _ = model(batch["image"], **kw)
        if mesh is None:
            loss = cross_entropy_ignore(seg, batch["label"])
            loss.backward()
        else:
            nll = cross_entropy_ignore(seg, batch["label"], reduce=False)
            valid = global_count(mesh, (batch["label"] != IGNORE_INDEX).sum())
            loss = nll.sum() / valid.clamp(min=1)
            loss.backward()
            all_reduce_gradients(mesh, model.parameters())
            loss = global_count(mesh, loss)
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
