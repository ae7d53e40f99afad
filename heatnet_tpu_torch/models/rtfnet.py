"""RTFNet, the dual-ResNet RGB-T baseline of the MFNet harness.

Counterpart of ``heatnet_tpu/models/rtfnet.py:23-123`` (``TransBottleneck``,
``_TransLayer``, ``RTFNet``): two ResNet-50 encoders of the torchvision
geometry (``extractors.Bottleneck`` and ``_Layer``, strides (1, 2, 2, 2), no
dilation), the thermal one on a 1-channel 7x7 stem, thermal added into RGB
after the stem and after every layer, then five ``_TransLayer`` stages that
each double the resolution. An upsampling ``TransBottleneck`` ends in a 2x2
stride-2 transposed conv named ``conv3`` (and a 2x2 ``upsample_conv`` on its
shortcut), where a keep-shape block's ``conv3`` is a plain 3x3 conv: so
``io/from_jax.state_dict_from_jax`` needs the model (``target=``) to tell
them apart. The transposed convs are flax's ``nn.ConvTranspose`` path of
``deconv`` (k = 2, s = 2, p = 0: ``ConvTranspose2d(2, 2, 0)``). NHWC
``(..., 4)`` in (RGB in 0-2, IR in 3), float32 NHWC logits out.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .extractors import Bottleneck, _Layer
from .layers import BatchNorm, conv, deconv, max_pool_3x3_s2


class TransBottleneck(nn.Module):
    """1x1 conv → 3x3 conv → (2x2 transposed conv when upsampling, else a
    3x3 conv), each with BN; a projection shortcut on the upsampling block."""

    def __init__(self, in_channels: int, planes: int, stride: int = 1,
                 upsample: bool = False):
        super().__init__()
        self.conv1 = conv(in_channels, planes, 1)
        self.bn1 = BatchNorm(planes)
        self.conv2 = conv(planes, planes, 3)
        self.bn2 = BatchNorm(planes)
        if upsample and stride != 1:
            self.conv3 = deconv(planes, planes, 2, 2, 0)
        else:
            self.conv3 = conv(planes, planes, 3, stride=stride)
        self.bn3 = BatchNorm(planes)
        self.upsample = upsample
        if upsample:
            self.upsample_conv = (deconv(in_channels, planes, 2, 2, 0) if stride != 1
                                  else conv(in_channels, planes, 1))
            self.upsample_bn = BatchNorm(planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = self.upsample_bn(self.upsample_conv(x)) if self.upsample else x
        return F.relu(out + residual)


class _TransLayer(nn.Sequential):
    """``blocks - 1`` keep-shape bottlenecks, then one upsampling bottleneck."""

    def __init__(self, planes: int, blocks: int, stride: int, in_planes: int):
        super().__init__()
        for i in range(1, blocks):
            self.add_module(f"block{i}", TransBottleneck(in_planes, in_planes, 1, False))
        need_up = stride != 1 or in_planes != planes
        self.add_module(f"block{blocks}",
                        TransBottleneck(in_planes, planes, stride, need_up))


class RTFNet(nn.Module):
    def __init__(self, n_class: int = 9, layers: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        for tag, c_in in (("rgb", 3), ("thermal", 1)):
            self.add_module(f"encoder_{tag}_conv1", conv(c_in, 64, 7, stride=2, padding=3))
            self.add_module(f"encoder_{tag}_bn1", BatchNorm(64))
            width = 64
            for i, (planes, stride) in enumerate(zip((64, 128, 256, 512), (1, 2, 2, 2))):
                self.add_module(f"encoder_{tag}_layer{i + 1}",
                                _Layer(Bottleneck, width, planes, layers[i], stride=stride))
                width = planes * Bottleneck.expansion
        inplanes = 2048
        for i in range(1, 5):
            self.add_module(f"deconv{i}", _TransLayer(inplanes // 2, 2, 2, inplanes))
            inplanes //= 2
        self.deconv5 = _TransLayer(n_class, 2, 2, inplanes)
        self.compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        stem = lambda y, tag: F.relu(getattr(self, f"encoder_{tag}_bn1")(
            getattr(self, f"encoder_{tag}_conv1")(y)))
        rgb, thermal = stem(x[:, :3], "rgb"), stem(x[:, 3:], "thermal")
        rgb = max_pool_3x3_s2(rgb + thermal)
        thermal = max_pool_3x3_s2(thermal)
        for i in range(1, 5):
            rgb = getattr(self, f"encoder_rgb_layer{i}")(rgb)
            thermal = getattr(self, f"encoder_thermal_layer{i}")(thermal)
            rgb = rgb + thermal
        fuse = rgb
        for i in range(1, 6):
            fuse = getattr(self, f"deconv{i}")(fuse)
        return fuse.float().permute(0, 2, 3, 1)
