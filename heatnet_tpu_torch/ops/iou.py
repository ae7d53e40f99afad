"""Confusion matrix and per-class IoU on the device.

Counterpart of ``heatnet_tpu/ops/iou.py:17-72``. The JAX version builds the
matrix as a one-hot matmul for the TPU's matrix unit; here it is a
``bincount`` of ``target * K + predicted``, the same counts.
"""

from __future__ import annotations

from typing import Sequence

import torch


def confusion_matrix(predicted: torch.Tensor, target: torch.Tensor,
                     num_classes: int) -> torch.Tensor:
    """(K, K) int64 counts, rows = target, columns = predicted.

    Pixels whose label or prediction lies outside [0, K) count nowhere
    (``ConfusionMatrix.add``, scripts/iou_eval.py:81-88).
    """
    p = predicted.reshape(-1).long()
    t = target.reshape(-1).long()
    ok = (p >= 0) & (p < num_classes) & (t >= 0) & (t < num_classes)
    idx = torch.where(ok, t * num_classes + p, num_classes * num_classes)
    counts = torch.bincount(idx, minlength=num_classes * num_classes + 1)
    return counts[:num_classes * num_classes].view(num_classes, num_classes)


def iou_from_confusion(conf: torch.Tensor,
                       ignore_index: Sequence[int] = ()) -> torch.Tensor:
    """Per-class IoU, float32, NaN where a class is absent; the rows and
    columns of ``ignore_index`` classes are zeroed first (``IoU.value()``,
    scripts/iou_eval.py:161-181)."""
    conf = conf.to(torch.float32)
    if len(ignore_index):
        keep = torch.ones(conf.shape[0], dtype=torch.float32, device=conf.device)
        keep[list(ignore_index)] = 0.0
        conf = conf * keep[:, None] * keep[None, :]
    tp = torch.diagonal(conf)
    fp = conf.sum(0) - tp
    fn = conf.sum(1) - tp
    denom = tp + fp + fn
    return torch.where(denom > 0, tp / denom.clamp(min=1.0),
                       torch.full_like(tp, float("nan")))
