"""The UNets: the half-width input adapter and the full-width ``UNetSeg``.

Counterpart of ``heatnet_tpu/models/unet.py:21-107`` (``DoubleConv``,
``_Down``, ``_Up``, ``UNetAdapter``, ``UNetSeg``). ``UNetAdapter``
(input_adapter.py:75-101 of the reference) is an image-to-image UNet, f = 2,
three downs and three ups with bilinear upsampling, which
``--train_input_adapter`` puts in front of the segnet. ``UNetSeg`` (the
reference CycleGAN folder's segmentation UNet) is full width, four downs and
four ups, and ends in a sigmoid. Their BatchNorms are flax's
(``layers.BatchNorm``). NHWC at the surface, float32 out; the convolutions
run in ``compute_dtype``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm, Conv2d, resize_bilinear


class DoubleConv(nn.Module):
    """(conv3x3 with bias → BN → ReLU) x 2 (input_adapter.py:5-21)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1)
        self.bn1 = BatchNorm(out_channels)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1)
        self.bn2 = BatchNorm(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(x)))


class _Down(nn.Module):
    """2x2 max pool, then a DoubleConv."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = DoubleConv(in_channels, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.max_pool2d(x, 2, 2))


class _Up(nn.Module):
    """Bilinear x2 upsample, pad to the skip's size, concat, DoubleConv."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = DoubleConv(in_channels, out_channels)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        x1 = resize_bilinear(x1, (2 * x1.shape[2], 2 * x1.shape[3]))
        dh, dw = x2.shape[2] - x1.shape[2], x2.shape[3] - x1.shape[3]
        x1 = F.pad(x1, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
        return self.conv(torch.cat([x2, x1], dim=1))


class UNetAdapter(nn.Module):
    """Half-width image-to-image adapter UNet; ``n_classes`` output channels."""

    def __init__(self, in_channels: int, n_classes: int, f: int = 2):
        super().__init__()
        self.inc = DoubleConv(in_channels, 64 // f)
        self.down1 = _Down(64 // f, 128 // f)
        self.down2 = _Down(128 // f, 256 // f)
        self.down3 = _Down(256 // f, 512 // f)
        self.up2 = _Up(512 // f + 256 // f, 128 // f)
        self.up3 = _Up(128 // f + 128 // f, 64 // f)
        self.up4 = _Up(64 // f + 64 // f, 64 // f)
        self.outc = Conv2d(64 // f, n_classes, 1)
        self.compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        x1 = self.inc(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        y = self.up2(x4, x3)
        y = self.up3(y, x2)
        y = self.up4(y, x1)
        return self.outc(y).float().permute(0, 2, 3, 1)


class UNetSeg(nn.Module):
    """Full-width UNet with a sigmoid output; ``in_channels`` is the input's
    width (flax infers it)."""

    def __init__(self, n_classes: int, in_channels: int = 1):
        super().__init__()
        self.inc = DoubleConv(in_channels, 64)
        self.down1 = _Down(64, 128)
        self.down2 = _Down(128, 256)
        self.down3 = _Down(256, 512)
        self.down4 = _Down(512, 512)
        self.up1 = _Up(512 + 512, 256)
        self.up2 = _Up(256 + 256, 128)
        self.up3 = _Up(128 + 128, 64)
        self.up4 = _Up(64 + 64, 64)
        self.outc = Conv2d(64, n_classes, 1)
        self.compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        x1 = self.inc(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        y = self.up1(self.down4(x4), x4)
        y = self.up2(y, x3)
        y = self.up3(y, x2)
        y = self.up4(y, x1)
        return torch.sigmoid(self.outc(y).float()).permute(0, 2, 3, 1)
