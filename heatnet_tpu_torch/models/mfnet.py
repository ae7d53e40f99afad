"""MFNet, the two-stream mini-inception RGB/IR baseline of the MFNet harness.

Counterpart of ``heatnet_tpu/models/mfnet.py:20-100`` (``ConvBnLeakyRelu``,
``MiniInception``, ``MFNet``): an RGB stream of widths (16, 48, 48, 96, 96)
and an IR stream of (16, 16, 16, 36, 36), four 2x2 max pools, and a decoder
that upsamples by exactly 2x (nearest) and adds the streams' skips. Every
conv has a bias and is followed by flax's BatchNorm (``layers.BatchNorm``)
and a leaky ReLU of slope 0.2, the logits included. The input is NHWC
``(..., 4)``: RGB in channels 0-2, IR in 3; float32 NHWC logits out.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm, Conv2d

RGB_WIDTHS = (16, 48, 48, 96, 96)
IR_WIDTHS = (16, 16, 16, 36, 36)


class ConvBnLeakyRelu(nn.Module):
    """conv (bias) → BN → leaky ReLU 0.2."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3,
                 padding: int = 1, dilation: int = 1):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, kernel, padding=padding,
                           dilation=dilation)
        self.bn = BatchNorm(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(self.bn(self.conv(x)), 0.2)


class MiniInception(nn.Module):
    """Three rounds of a 3x3 and a dilation-2 3x3 branch, concatenated."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        half = out_channels // 2
        for i in range(1, 4):
            c_in = in_channels if i == 1 else out_channels
            self.add_module(f"conv{i}_left", ConvBnLeakyRelu(c_in, half))
            self.add_module(f"conv{i}_right",
                            ConvBnLeakyRelu(c_in, half, padding=2, dilation=2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(1, 4):
            x = torch.cat([getattr(self, f"conv{i}_left")(x),
                           getattr(self, f"conv{i}_right")(x)], dim=1)
        return x


def _up2(x: torch.Tensor) -> torch.Tensor:
    # jax.image.resize(method="nearest") at exactly 2x: output i reads input i // 2
    return F.interpolate(x, size=(2 * x.shape[2], 2 * x.shape[3]), mode="nearest")


class MFNet(nn.Module):
    def __init__(self, n_class: int = 9):
        super().__init__()
        for tag, ch, c_in in (("rgb", RGB_WIDTHS, 3), ("inf", IR_WIDTHS, 1)):
            self.add_module(f"conv1_{tag}", ConvBnLeakyRelu(c_in, ch[0]))
            self.add_module(f"conv2_1_{tag}", ConvBnLeakyRelu(ch[0], ch[1]))
            self.add_module(f"conv2_2_{tag}", ConvBnLeakyRelu(ch[1], ch[1]))
            self.add_module(f"conv3_1_{tag}", ConvBnLeakyRelu(ch[1], ch[2]))
            self.add_module(f"conv3_2_{tag}", ConvBnLeakyRelu(ch[2], ch[2]))
            self.add_module(f"conv4_{tag}", MiniInception(ch[2], ch[3]))
            self.add_module(f"conv5_{tag}", MiniInception(ch[3], ch[4]))
        r, i = RGB_WIDTHS, IR_WIDTHS
        self.decode4 = ConvBnLeakyRelu(r[4] + i[4], r[2] + i[2])
        self.decode3 = ConvBnLeakyRelu(r[2] + i[2], r[1] + i[1])
        self.decode2 = ConvBnLeakyRelu(r[1] + i[1], r[0] + i[0])
        self.decode1 = ConvBnLeakyRelu(r[0] + i[0], n_class)
        self.compute_dtype = torch.float32

    def _encode(self, y: torch.Tensor, tag: str):
        m = lambda name: getattr(self, f"{name}_{tag}")
        y = F.max_pool2d(m("conv1")(y), 2, 2)
        p2 = m("conv2_2")(m("conv2_1")(y))
        p3 = m("conv3_2")(m("conv3_1")(F.max_pool2d(p2, 2, 2)))
        p4 = m("conv4")(F.max_pool2d(p3, 2, 2))
        return m("conv5")(F.max_pool2d(p4, 2, 2)), p2, p3, p4

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        y_rgb, r2, r3, r4 = self._encode(x[:, :3], "rgb")
        y_inf, i2, i3, i4 = self._encode(x[:, 3:], "inf")
        y = _up2(torch.cat([y_rgb, y_inf], dim=1))
        y = _up2(self.decode4(y + torch.cat([r4, i4], dim=1)))
        y = _up2(self.decode3(y + torch.cat([r3, i3], dim=1)))
        y = _up2(self.decode2(y + torch.cat([r2, i2], dim=1)))
        return self.decode1(y).float().permute(0, 2, 3, 1)
