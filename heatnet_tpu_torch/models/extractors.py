"""ResNets of ``heatnet_tpu/models/extractors.py``: classifier mode.

Counterpart of ``BasicBlock``, ``Bottleneck``, ``_Layer``, ``ResNet`` and
``make_resnet`` (extractors.py:26-175, :341) in the mode the adversarial
trainer's ``resnet*`` critics use (critic_resnet.py): a 7x7 stride-2 stem,
four stride-2 layers of the torchvision geometry, global average pool and a
``fc`` to ``num_classes`` float32 outputs. The dilated extractor mode (5 taps
for PSPNet), late fusion and the DenseNet/SqueezeNet extractors raise
``NotImplementedError`` until the PSPNet slice (ROADMAP item 10).

Its BatchNorms are flax's (momentum 0.9 on the running statistics, the
biased variance): ``layers.BatchNorm``. Module names are the flax tree's
(``conv1``, ``bn1``, ``layer1.block1.downsample_bn``, ``fc``), and the
input width is explicit, as a PyTorch module needs it. Input and output are
NHWC at the surface; convolutions run in ``compute_dtype`` (bf16 on the
card) from float32 parameters.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm, Linear, conv, max_pool_3x3_s2


class BasicBlock(nn.Module):
    """Two 3x3 convs + identity (extractors.py:26-55). expansion = 1."""

    expansion = 1

    def __init__(self, in_channels: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = conv(in_channels, planes, 3, stride=stride, dilation=dilation)
        self.bn1 = BatchNorm(planes)
        self.conv2 = conv(planes, planes, 3, dilation=dilation)
        self.bn2 = BatchNorm(planes)
        self.downsample = downsample
        if downsample:
            self.downsample_conv = conv(in_channels, planes, 1, stride=stride)
            self.downsample_bn = BatchNorm(planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = (self.downsample_bn(self.downsample_conv(x))
                    if self.downsample else x)
        return F.relu(out + residual)


class Bottleneck(nn.Module):
    """1x1/3x3/1x1 bottleneck (extractors.py:58-90). expansion = 4."""

    expansion = 4

    def __init__(self, in_channels: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = conv(in_channels, planes, 1)
        self.bn1 = BatchNorm(planes)
        self.conv2 = conv(planes, planes, 3, stride=stride, dilation=dilation)
        self.bn2 = BatchNorm(planes)
        self.conv3 = conv(planes, planes * 4, 1)
        self.bn3 = BatchNorm(planes * 4)
        self.downsample = downsample
        if downsample:
            self.downsample_conv = conv(in_channels, planes * 4, 1, stride=stride)
            self.downsample_bn = BatchNorm(planes * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = (self.downsample_bn(self.downsample_conv(x))
                    if self.downsample else x)
        return F.relu(out + residual)


class _Layer(nn.Sequential):
    """One ResNet layer: the first block may stride and project, the rest
    dilate (extractors.py:93-111)."""

    def __init__(self, block: type, in_channels: int, planes: int, blocks: int,
                 stride: int = 1, dilation: int = 1):
        super().__init__()
        out = planes * block.expansion
        need_proj = stride != 1 or in_channels != out
        self.add_module("block1", block(in_channels, planes, stride, 1, need_proj))
        for i in range(1, blocks):
            self.add_module(f"block{i + 1}", block(out, planes, 1, dilation, False))


class ResNet(nn.Module):
    """``ResNet(num_classes=n)``: the classifier (critic) mode of
    extractors.py:114-175. ``forward(modal_1, modal_2=None)`` takes NHWC
    and returns float32 ``(N, num_classes)``."""

    def __init__(self, layers: Sequence[int] = (3, 4, 23, 3),
                 block_name: str = "bottleneck", late_fusion: bool = False,
                 in_channels: int = 3, num_classes: Optional[int] = None):
        super().__init__()
        if num_classes is None or late_fusion:
            raise NotImplementedError(
                "the dilated extractor mode and late fusion of ResNet are not "
                "ported yet (ROADMAP item 10, PSPNet)")
        block = Bottleneck if block_name == "bottleneck" else BasicBlock
        self.conv1 = conv(in_channels, 64, 7, stride=2, padding=3)
        self.bn1 = BatchNorm(64)
        in_ch = 64
        for i, (planes, stride) in enumerate(zip((64, 128, 256, 512), (1, 2, 2, 2))):
            self.add_module(f"layer{i + 1}",
                            _Layer(block, in_ch, planes, layers[i], stride))
            in_ch = planes * block.expansion
        self.fc = Linear(in_ch, num_classes)
        self.compute_dtype = torch.float32

    def forward(self, modal_1: torch.Tensor,
                modal_2: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = modal_1 if modal_2 is None else torch.cat([modal_1, modal_2], -1)
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        x = max_pool_3x3_s2(F.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return self.fc(x.mean(dim=(2, 3))).float()


_RESNETS = {
    "resnet18": dict(layers=(2, 2, 2, 2), block_name="basic"),
    "resnet34": dict(layers=(3, 4, 6, 3), block_name="basic"),
    "resnet50": dict(layers=(3, 4, 6, 3), block_name="bottleneck"),
    "resnet101": dict(layers=(3, 4, 23, 3), block_name="bottleneck"),
    "resnet152": dict(layers=(3, 8, 36, 3), block_name="bottleneck"),
}


def make_resnet(variant: str, **kw) -> ResNet:
    """Factory of extractors.py:341 (critic_resnet.py:228-349)."""
    if variant not in _RESNETS:
        raise KeyError(f"unknown resnet variant {variant}")
    return ResNet(**_RESNETS[variant], **kw)


def make_extractor(variant: str, late_fusion: bool = False, in_channels: int = 3):
    """The PSPNet backbones (extractors.py:348-364): not ported yet."""
    raise NotImplementedError(
        f"the {variant} feature extractor is not ported yet (ROADMAP item 10, PSPNet)")
