"""Confusion matrix and per-class IoU on the device.

Counterpart of ``heatnet_tpu/ops/iou.py:17-140``. The JAX version
builds the matrix as a one-hot matmul for the TPU's matrix unit and the
eval counts as (C, P) comparisons; here each is a ``bincount`` (pixels
that count nowhere go to a spare bin), the same counts.
``calculate_ious_device`` keeps JAX's (C, P) comparisons.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def _class_counts(idx: torch.Tensor, keep: torch.Tensor, n: int) -> torch.Tensor:
    return torch.bincount(torch.where(keep, idx, n), minlength=n + 1)[:n]


def iou_counts(pred: torch.Tensor, target: torch.Tensor, n_classes: int = 13,
               ignore_class: int = 13) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-class (intersection, predicted, target) pixel counts, three (C,)
    int64 tensors on the inputs' device.

    Pixels labelled ``ignore_class`` count in neither the predicted nor the
    target count. Summed over an eval set, ``inter / (pred + target -
    inter)`` is ``calculate_ious`` over the concatenated maps.
    """
    p = pred.reshape(-1).long()
    t = target.reshape(-1).long()
    valid = t != ignore_class
    p_in = (p >= 0) & (p < n_classes)
    t_in = (t >= 0) & (t < n_classes)
    return (_class_counts(t, t_in & (p == t), n_classes),
            _class_counts(p, p_in & valid, n_classes),
            _class_counts(t, t_in & valid, n_classes))


def ious_from_counts(inter, pred_cnt, targ_cnt, skip=(12, 13)) -> np.ndarray:
    """Final per-class IoU vector in float64 (NaN where a class is absent),
    without the ``skip`` classes."""
    inter = np.asarray(inter, np.float64)
    union = np.asarray(pred_cnt, np.float64) + np.asarray(targ_cnt, np.float64) - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(union > 0, inter / np.maximum(union, 1), np.nan)
    keep = [c for c in range(len(iou)) if c not in skip]
    return iou[keep]


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


def calculate_ious_device(pred: torch.Tensor, target: torch.Tensor,
                          n_classes: int = 13, background_class: int = 12,
                          ignore_class: int = 13) -> torch.Tensor:
    """Per-class IoU of one set of maps, float32 on their device, NaN where
    a class is absent (``heatnet_tpu/ops/iou.py:75``, the device form of
    ``eval/metrics.py::calculate_ious``): pixels whose target is
    ``ignore_class`` leave the union; the background and ignore classes are
    left out of the vector, which lists the others in class order."""
    p = pred.reshape(-1)
    t = target.reshape(-1)
    valid = t != ignore_class
    classes = torch.tensor([c for c in range(n_classes)
                            if c not in (background_class, ignore_class)], device=p.device)
    p_eq = p[None, :] == classes[:, None]
    t_eq = t[None, :] == classes[:, None]
    inter = (p_eq & t_eq).sum(1).to(torch.float32)
    union = ((p_eq & valid).sum(1) + (t_eq & valid).sum(1)).to(torch.float32) - inter
    return torch.where(union > 0, inter / union.clamp(min=1.0),
                       torch.full_like(union, float("nan")))


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
