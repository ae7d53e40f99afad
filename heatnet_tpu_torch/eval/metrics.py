"""Per-class IoU of the HeatNet evaluation protocol, in numpy.

Counterpart of ``heatnet_tpu/eval/metrics.py`` (the reference's
``calculate_ious``, ``models/confusion_maximization/utils.py:134-163``):
a boolean-mask IoU per class, classes 12 (background) and 13 (ignore)
skipped; pixels whose target is the ignore class leave the union; a class
absent from both the prediction and the target gives NaN, so that it drops
out of ``np.nanmean``. ``ops/iou.py`` counts the same on the device.
"""

from __future__ import annotations

import numpy as np

BACKGROUND_CLASS_IDX = 12
IGNORE_CLASS_IDX = 13


def calculate_ious(pred, target, n_classes: int = 13) -> np.ndarray:
    """Per-class IoU, NaN where a class is in neither map; one entry per
    class below ``n_classes`` other than 12 and 13 (12 for the default)."""
    pred = np.asarray(pred).reshape(-1)
    target = np.asarray(target).reshape(-1)
    valid = target != IGNORE_CLASS_IDX
    ious = []
    for cls in range(n_classes):
        if cls in (BACKGROUND_CLASS_IDX, IGNORE_CLASS_IDX):
            continue
        pred_inds = pred == cls
        target_inds = target == cls
        intersection = np.logical_and(pred_inds, target_inds).sum()
        union = (np.logical_and(pred_inds, valid).sum()
                 + np.logical_and(target_inds, valid).sum() - intersection)
        ious.append(float("nan") if union == 0 else float(intersection) / float(union))
    return np.array(ious)
