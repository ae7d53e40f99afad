"""Visualisation: label colour coding, an IR colormap and PNG dumps.

The port's copy of ``heatnet_tpu/utils/vis.py:17-50`` (``color_code_labels``,
``vis_depth``, ``draw_critic_labels``) and ``save_image`` (:52-61) with the
same contract, written by ``data.png.write_png`` instead of PIL, on which the
port does not depend.
"""

from __future__ import annotations

import numpy as np

from ..data.mappings import color_palette
from ..data.png import write_png


def color_code_labels(labels: np.ndarray, palette: np.ndarray = None) -> np.ndarray:
    """Integer label map (H, W) → float RGB in [0, 1]."""
    if palette is None:
        palette = color_palette()
    labels = np.asarray(labels).astype(np.int64)
    return palette[labels].astype(np.float32) / 255.0


def vis_depth(depth: np.ndarray) -> np.ndarray:
    """Single-channel map → JET-style colormap RGB in [0, 1]."""
    d = np.asarray(depth, np.float32)
    d = d.squeeze()
    lo, hi = float(d.min()), float(d.max())
    t = (d - lo) / (hi - lo) if hi > lo else np.zeros_like(d)
    r = np.clip(1.5 - np.abs(4 * t - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * t - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * t - 1), 0, 1)
    return np.stack([r, g, b], axis=-1).astype(np.float32)


def draw_critic_labels(image: np.ndarray, verdicts) -> np.ndarray:
    """Per-critic verdict dots in the top-left corner (the reference's
    drawCriticsLabels, vis_utils.py:98-125): green = fooled (> 0.5), red
    otherwise."""
    img = np.array(image, copy=True)
    r = max(2, img.shape[0] // 40)
    yy, xx = np.ogrid[:img.shape[0], :img.shape[1]]
    for i, v in enumerate(verdicts):
        cy, cx = r * 2, r * 2 + i * (3 * r)
        mask = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
        img[mask] = (0.0, 1.0, 0.0) if v else (1.0, 0.0, 0.0)
    return img


def save_image(path: str, image: np.ndarray) -> None:
    """Write an HWC float [0, 1] or uint8 array as an 8-bit PNG; a grey
    (H, W) image is stacked to 3 channels. Floats scale by 255 and truncate,
    as the JAX package's ``save_image`` does."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    write_png(path, img)
