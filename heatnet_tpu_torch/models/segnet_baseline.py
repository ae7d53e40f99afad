"""SegNet, the third model of the MFNet harness.

Counterpart of ``heatnet_tpu/models/segnet_baseline.py:25-107``
(``pool_with_indices``, ``unpool_with_indices``, ``ConvBnRelu``, ``_Stage``,
``SegNetBaseline``): five pooled encoder stages of widths 32-128, each 2x2
max pool recording its within-cell argmax, and a mirrored decoder whose
unpooling puts each value back at its recorded position.

The pool and unpool are the JAX package's reshape form, not
``F.max_pool2d(return_indices=True)`` and ``F.max_unpool2d``: each pool
views (N, C, H, W) as (N, C, H/2, W/2, 4) cells, takes ``amax`` and
``argmax`` over a cell, and the unpool multiplies by a one-hot of the
argmax. The forward is the same either way (ties resolve to the first
maximum in both frameworks), but the gradient is not: ``jnp.max`` splits
it evenly among tied elements, as ``torch.amax`` does, where the indexed
pool gives all of it to one element. NHWC at the surface, float32 out.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm, Conv2d

WIDTHS = (32, 64, 64, 128, 128)


def pool_cells(x: torch.Tensor) -> torch.Tensor:
    """NCHW ``x`` as its 2x2 cells, (N, C, H/2, W/2, 4), row-major in a cell."""
    n, c, h, w = x.shape
    cells = x.reshape(n, c, h // 2, 2, w // 2, 2).permute(0, 1, 2, 4, 3, 5)
    return cells.reshape(n, c, h // 2, w // 2, 4)


def pool_with_indices(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """2x2 stride-2 max pool of NCHW ``x``: (pooled, within-cell argmax 0..3)."""
    cells = pool_cells(x)
    return cells.amax(dim=-1), cells.argmax(dim=-1)


def unpool_with_indices(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pool_with_indices``: zeros off the recorded argmax."""
    n, c, h, w = x.shape
    cells = x[..., None] * F.one_hot(idx, 4).to(x.dtype)
    cells = cells.reshape(n, c, h, w, 2, 2).permute(0, 1, 2, 4, 3, 5)
    return cells.reshape(n, c, 2 * h, 2 * w)


class ConvBnRelu(nn.Module):
    """conv 3x3 (bias) → BN → ReLU."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.conv = Conv2d(in_channels, features, 3, padding=1)
        self.bn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class _Stage(nn.Sequential):
    """``ConvBnRelu`` units ``m0``, ``m1``, ... of the given widths."""

    def __init__(self, in_channels: int, features: Sequence[int]):
        super().__init__()
        for i, f in enumerate(features):
            self.add_module(f"m{i}", ConvBnRelu(in_channels, f))
            in_channels = f


class SegNetBaseline(nn.Module):
    def __init__(self, n_class: int = 9, in_channels: int = 4):
        super().__init__()
        c = WIDTHS
        downs = (("down1", [c[0], c[0]]), ("down2", [c[1], c[1]]),
                 ("down3", [c[2]] * 3), ("down4", [c[3]] * 3), ("down5", [c[4]] * 3))
        ups = (("up5", [c[4], c[4], c[3]]), ("up4", [c[3], c[3], c[2]]),
               ("up3", [c[2], c[2], c[1]]), ("up2", [c[1], c[0]]),
               ("up1", [c[0], n_class]))
        width = in_channels
        for name, feats in downs + ups:
            self.add_module(name, _Stage(width, feats))
            width = feats[-1]
        self.compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        indices = []
        for i in range(1, 6):
            x, idx = pool_with_indices(getattr(self, f"down{i}")(x))
            indices.append(idx)
        for i, idx in zip(range(5, 0, -1), reversed(indices)):
            x = getattr(self, f"up{i}")(unpool_with_indices(x, idx))
        return x.float().permute(0, 2, 3, 1)
