"""Confusion-matrix IoU, bit-compatible with the reference.

The port's copy of ``heatnet_tpu/eval/iou_eval.py`` (the reference's
``scripts/iou_eval.py``: ``ConfusionMatrix``'s bincount accumulation at
:81-88, ``IoU.value()``'s TP/FP/FN and nanmean with the ignored classes'
rows and columns zeroed at :161-181), numpy only. ``cli/main.py`` validates
with ``IoU(14, False, [12, 13])`` (``scripts/main.py:278``) and feeds it
confusion matrices counted on the device (``ops/iou.py::confusion_matrix``)
through ``add_confusion``.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple, Union

import numpy as np


class Metric:
    """Base class for all metrics (reference scripts/iou_eval.py:19-31)."""

    def reset(self):
        pass

    def add(self, *args, **kwargs):
        pass

    def value(self):
        pass


class ConfusionMatrix(Metric):
    """Accumulating confusion matrix for multi-class classification.

    Rows are ground-truth targets, columns are predictions
    (reference scripts/iou_eval.py:33-118).
    """

    def __init__(self, num_classes: int, normalized: bool = False):
        super().__init__()
        self.conf = np.zeros((num_classes, num_classes), dtype=np.int64)
        self.normalized = normalized
        self.num_classes = num_classes

    def reset(self):
        self.conf.fill(0)

    def add(self, predicted, target):
        predicted = np.asarray(predicted)
        target = np.asarray(target)

        assert predicted.shape[0] == target.shape[0], (
            "number of targets and predicted outputs do not match"
        )

        if np.ndim(predicted) != 1:
            assert predicted.shape[1] == self.num_classes, (
                "number of predictions does not match size of confusion matrix"
            )
            predicted = np.argmax(predicted, 1)
        else:
            assert (predicted.max() < self.num_classes) and (predicted.min() >= 0), (
                "predicted values are not between 0 and k-1"
            )

        if np.ndim(target) != 1:
            assert target.shape[1] == self.num_classes, (
                "Onehot target does not match size of confusion matrix"
            )
            assert (target >= 0).all() and (target <= 1).all(), (
                "in one-hot encoding, target values should be 0 or 1"
            )
            assert (target.sum(1) == 1).all(), "multi-label setting is not supported"
            target = np.argmax(target, 1)
        else:
            assert (target.max() < self.num_classes) and (target.min() >= 0), (
                "target values are not between 0 and k-1"
            )

        # bincount two arrays jointly: conf[t, p] counts pairs (t, p)
        x = predicted + self.num_classes * target
        bincount_2d = np.bincount(x.astype(np.int64), minlength=self.num_classes**2)
        assert bincount_2d.size == self.num_classes**2
        self.conf += bincount_2d.reshape((self.num_classes, self.num_classes))

    def value(self) -> np.ndarray:
        if self.normalized:
            conf = self.conf.astype(np.float32)
            return conf / conf.sum(1).clip(min=1e-12)[:, None]
        return self.conf


class IoU(Metric):
    """Per-class intersection-over-union and mean IoU.

    ``IoU = TP / (TP + FP + FN)`` accumulated in a confusion matrix; classes in
    ``ignore_index`` have their confusion rows/columns zeroed before the
    division, and the mean skips NaNs (reference scripts/iou_eval.py:121-181).
    """

    def __init__(
        self,
        num_classes: int,
        normalized: bool = False,
        ignore_index: Optional[Union[int, Iterable[int]]] = None,
    ):
        super().__init__()
        self.conf_metric = ConfusionMatrix(num_classes, normalized)

        if ignore_index is None:
            self.ignore_index: Optional[Tuple[int, ...]] = None
        elif isinstance(ignore_index, int):
            self.ignore_index = (ignore_index,)
        else:
            try:
                self.ignore_index = tuple(ignore_index)
            except TypeError:
                raise ValueError("'ignore_index' must be an int or iterable")

    def reset(self):
        self.conf_metric.reset()

    def add(self, predicted, target):
        """Add a (predicted, target) pair.

        Accepts ``(N, H, W)`` integer maps or ``(N, K, H, W)`` score tensors
        (argmax is taken over the class axis).
        """
        predicted = np.asarray(predicted)
        target = np.asarray(target)

        assert predicted.shape[0] == target.shape[0], (
            "number of targets and predicted outputs do not match"
        )
        assert predicted.ndim in (3, 4), (
            "predictions must be of dimension (N, H, W) or (N, K, H, W)"
        )
        assert target.ndim in (3, 4), (
            "targets must be of dimension (N, H, W) or (N, K, H, W)"
        )

        if predicted.ndim == 4:
            predicted = predicted.argmax(1)
        if target.ndim == 4:
            target = target.argmax(1)

        self.conf_metric.add(predicted.reshape(-1), target.reshape(-1))

    def add_confusion(self, conf: np.ndarray):
        """Accumulate a precomputed confusion matrix (device-side fast path)."""
        conf = np.asarray(conf)
        assert conf.shape == self.conf_metric.conf.shape
        self.conf_metric.conf += conf.astype(np.int64)

    def value(self) -> Tuple[np.ndarray, float]:
        conf_matrix = self.conf_metric.value().copy()
        if self.ignore_index is not None:
            idx = list(self.ignore_index)
            conf_matrix[:, idx] = 0
            conf_matrix[idx, :] = 0
        true_positive = np.diag(conf_matrix)
        false_positive = np.sum(conf_matrix, 0) - true_positive
        false_negative = np.sum(conf_matrix, 1) - true_positive

        with np.errstate(divide="ignore", invalid="ignore"):
            iou = true_positive / (true_positive + false_positive + false_negative)

        return iou, float(np.nanmean(iou))
