"""The feature extractors of ``heatnet_tpu/models/extractors.py``.

Counterpart of ``BasicBlock``, ``Bottleneck``, ``_Layer``, ``ResNet``,
``_DenseLayer``, ``_DenseBlock``, ``_Transition``, ``DenseNetExtractor``,
``Fire``, ``SqueezeNetExtractor``, ``make_resnet``, ``make_extractor`` and
``feature_channels`` (extractors.py:26-377). ``ResNet`` has two modes:

- classifier (``num_classes`` set; the ``resnet*`` critics,
  critic_resnet.py): a 7x7 stride-2 stem, four stride-2 layers of the
  torchvision geometry, global average pool and a ``fc`` to ``num_classes``
  float32 outputs;
- extractor (``num_classes=None``; the PSPNet backbones): ``layer3`` and
  ``layer4`` at stride 1, dilation 2 and 4 (each layer's ``block1`` keeps
  dilation 1), 8x downsampling, five taps deepest first
  ``[x_5, x_4, x_3, x_2, x_1]`` (:162-174). With ``late_fusion`` the second
  modality has its own stem (``conv1_2``/``bn1_2``), ``layer1_2`` and
  ``layer2_2``, concatenated from ``x_3`` on (:146-160).

The DenseNet and SqueezeNet extractors return five taps too (:177-329).

Their BatchNorms are flax's (momentum 0.9 on the running statistics, the
biased variance): ``layers.BatchNorm``. Module names are the flax tree's
(``conv1``, ``bn1``, ``layer1.block1.downsample_bn``, ``fc``,
``denseblock1.denselayer1.norm1``, ``feat2_fire1.squeeze``), and the input
widths are explicit, as a PyTorch module needs them: ``in_channels`` is
the stem's, and with late fusion the first modality is RGB (3 channels)
and the second takes the other ``in_channels - 3``. Inputs and outputs
are NHWC at the surface; convolutions run in ``compute_dtype`` (bf16 on
the card) from float32 parameters.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

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


RGB_CHANNELS = 3  # the first modality of a late-fusion extractor


def _nchw(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    # a contiguous NHWC tensor, permuted, is NCHW in channels_last memory
    return x.to(dtype).permute(0, 3, 1, 2)


def _nhwc(taps: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return [t.permute(0, 2, 3, 1) for t in taps]


class ResNet(nn.Module):
    """extractors.py:114-175 in classifier mode (``num_classes`` set:
    ``forward`` returns float32 ``(N, num_classes)``) or extractor mode
    (``num_classes=None``: five NHWC taps, deepest first)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 23, 3),
                 block_name: str = "bottleneck", late_fusion: bool = False,
                 in_channels: int = 3, num_classes: Optional[int] = None):
        super().__init__()
        block = Bottleneck if block_name == "bottleneck" else BasicBlock
        self.classifier = num_classes is not None
        self.late_fusion = (late_fusion and not self.classifier
                            and in_channels > RGB_CHANNELS)
        # (planes, stride, dilation) of layer1-4: torchvision's strides for
        # the classifier, stride-1 dilated layer3/4 for the extractor
        deep = ((2, 1), (2, 1)) if self.classifier else ((1, 2), (1, 4))
        geometry = ((64, 1, 1), (128, 2, 1), (256,) + deep[0], (512,) + deep[1])
        twins = ("", "_2") if self.late_fusion else ("",)
        stem_in = RGB_CHANNELS if self.late_fusion else in_channels
        for sfx in twins:
            self.add_module(f"conv1{sfx}", conv(stem_in, 64, 7, stride=2, padding=3))
            self.add_module(f"bn1{sfx}", BatchNorm(64))
            stem_in = in_channels - RGB_CHANNELS
        in_ch = 64
        for i, (planes, stride, dilation) in enumerate(geometry):
            if i == 2 and self.late_fusion:
                in_ch *= 2  # layer2 and layer2_2 concatenated
            for sfx in (twins if i < 2 else ("",)):
                self.add_module(f"layer{i + 1}{sfx}", _Layer(
                    block, in_ch, planes, layers[i], stride, dilation))
            in_ch = planes * block.expansion
        if self.classifier:
            self.fc = Linear(in_ch, num_classes)
        self.compute_dtype = torch.float32

    def _stem(self, x: torch.Tensor, sfx: str = "") -> torch.Tensor:
        x = getattr(self, f"conv1{sfx}")(_nchw(x, self.compute_dtype))
        return max_pool_3x3_s2(F.relu(getattr(self, f"bn1{sfx}")(x)))

    def forward(self, modal_1: torch.Tensor, modal_2: Optional[torch.Tensor] = None):
        if self.late_fusion:
            if modal_2 is None:
                raise ValueError("a late-fusion ResNet takes RGB and IR apart")
            x_1, x_1_ir = self._stem(modal_1), self._stem(modal_2, "_2")
            x_2, x_2_ir = self.layer1(x_1), self.layer1_2(x_1_ir)
            x_3 = torch.cat([self.layer2(x_2), self.layer2_2(x_2_ir)], dim=1)
            x_4 = self.layer3(x_3)
            return _nhwc([self.layer4(x_4), x_4, x_3, torch.cat([x_2, x_2_ir], dim=1),
                          torch.cat([x_1, x_1_ir], dim=1)])
        x_1 = self._stem(modal_1 if modal_2 is None
                         else torch.cat([modal_1, modal_2], -1))
        x_2 = self.layer1(x_1)
        x_3 = self.layer2(x_2)
        x_4 = self.layer3(x_3)
        x_5 = self.layer4(x_4)
        if self.classifier:
            return self.fc(x_5.mean(dim=(2, 3))).float()
        return _nhwc([x_5, x_4, x_3, x_2, x_1])


class _DenseLayer(nn.Module):
    """BN → ReLU → 1x1 conv → BN → ReLU → 3x3 conv, concatenated onto the
    input (extractors.py:177-196)."""

    def __init__(self, in_channels: int, growth_rate: int, bn_size: int = 4):
        super().__init__()
        self.norm1 = BatchNorm(in_channels)
        self.conv1 = conv(in_channels, bn_size * growth_rate, 1)
        self.norm2 = BatchNorm(bn_size * growth_rate)
        self.conv2 = conv(bn_size * growth_rate, growth_rate, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv1(F.relu(self.norm1(x)))
        out = self.conv2(F.relu(self.norm2(out)))
        return torch.cat([x, out], dim=1)


class _DenseBlock(nn.Sequential):
    def __init__(self, in_channels: int, num_layers: int, growth_rate: int):
        super().__init__()
        for i in range(num_layers):
            self.add_module(f"denselayer{i + 1}",
                            _DenseLayer(in_channels + i * growth_rate, growth_rate))


class _Transition(nn.Module):
    """BN → ReLU → 1x1 conv (→ 2x2 average pool) (extractors.py:212-227)."""

    def __init__(self, in_channels: int, out_channels: int, downsample: bool = True):
        super().__init__()
        self.norm = BatchNorm(in_channels)
        self.conv = conv(in_channels, out_channels, 1)
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(F.relu(self.norm(x)))
        return F.avg_pool2d(x, 2, stride=2) if self.downsample else x


class DenseNetExtractor(nn.Module):
    """DenseNet-121-shaped extractor, 8x downsampling: only ``transition1``
    pools (extractors.py:230-274). Taps, deepest first: ``[block4 (1024),
    transition3 (512), transition2 (256), block1 (256), stem (64)]``."""

    def __init__(self, growth_rate: int = 32,
                 block_config: Sequence[int] = (6, 12, 24, 16),
                 num_init_features: int = 64, in_channels: int = 3):
        super().__init__()
        self.n_blocks = len(block_config)
        self.conv0 = conv(in_channels, num_init_features, 7, stride=2, padding=3)
        self.norm0 = BatchNorm(num_init_features)
        ch = num_init_features
        for i, num_layers in enumerate(block_config):
            self.add_module(f"denseblock{i + 1}",
                            _DenseBlock(ch, num_layers, growth_rate))
            ch += num_layers * growth_rate
            if i != self.n_blocks - 1:
                self.add_module(f"transition{i + 1}",
                                _Transition(ch, ch // 2, downsample=i < 1))
                ch //= 2
        self.compute_dtype = torch.float32

    def forward(self, modal_1: torch.Tensor, modal_2: Optional[torch.Tensor] = None):
        x = modal_1 if modal_2 is None else torch.cat([modal_1, modal_2], -1)
        x = self.norm0(self.conv0(_nchw(x, self.compute_dtype)))
        x_1 = x = max_pool_3x3_s2(F.relu(x))
        taps = []
        for i in range(self.n_blocks):
            x = getattr(self, f"denseblock{i + 1}")(x)
            if i == 0:
                taps.append(x)
            if i != self.n_blocks - 1:
                x = getattr(self, f"transition{i + 1}")(x)
                taps.append(x)
        # taps: block1, transition1, transition2, transition3
        return _nhwc([x, taps[3], taps[2], taps[0], x_1])


class Fire(nn.Module):
    """1x1 squeeze → (1x1 expand ‖ dilated 3x3 expand), concatenated
    (extractors.py:277-296); every conv has a bias."""

    def __init__(self, in_channels: int, squeeze_planes: int, expand1x1_planes: int,
                 expand3x3_planes: int, dilation: int = 1):
        super().__init__()
        self.squeeze = conv(in_channels, squeeze_planes, 1, use_bias=True)
        self.expand1x1 = conv(squeeze_planes, expand1x1_planes, 1, use_bias=True)
        self.expand3x3 = conv(squeeze_planes, expand3x3_planes, 3, dilation=dilation,
                              use_bias=True)
        self.out_channels = expand1x1_planes + expand3x3_planes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.relu(self.squeeze(x))
        return torch.cat([F.relu(self.expand1x1(s)), F.relu(self.expand3x3(s))], dim=1)


# (name, squeeze, expand1x1, expand3x3, dilation) of SqueezeNet-1.1's Fires
_FIRES = (("feat2_fire1", 16, 64, 64, 1), ("feat2_fire2", 16, 64, 64, 1),
          ("feat3_fire1", 32, 128, 128, 2), ("feat3_fire2", 32, 128, 128, 2),
          ("feat4_fire1", 48, 192, 192, 4), ("feat4_fire2", 48, 192, 192, 4),
          ("feat4_fire3", 64, 256, 256, 4), ("feat4_fire4", 64, 256, 256, 4))


class SqueezeNetExtractor(nn.Module):
    """SqueezeNet-1.1, dilated (extractors.py:299-329). Taps, deepest first:
    ``[f4 (512, /8), f3 (256, /8), f2 (128, /4), f1 (64, /2), f1]``."""

    def __init__(self, in_channels: int = 3):
        super().__init__()
        self.feat1_conv = conv(in_channels, 64, 3, stride=2, padding=1, use_bias=True)
        ch = 64
        for name, *widths in _FIRES:
            fire = Fire(ch, *widths)
            self.add_module(name, fire)
            ch = fire.out_channels
        self.compute_dtype = torch.float32

    def forward(self, modal_1: torch.Tensor, modal_2: Optional[torch.Tensor] = None):
        x = modal_1 if modal_2 is None else torch.cat([modal_1, modal_2], -1)
        f1 = F.relu(self.feat1_conv(_nchw(x, self.compute_dtype)))
        f2 = self.feat2_fire2(self.feat2_fire1(max_pool_3x3_s2(f1)))
        f3 = self.feat3_fire2(self.feat3_fire1(max_pool_3x3_s2(f2)))
        f4 = f3
        for i in range(1, 5):
            f4 = getattr(self, f"feat4_fire{i}")(f4)
        return _nhwc([f4, f3, f2, f1, f1])


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


def make_extractor(variant: str, late_fusion: bool = False,
                   in_channels: int = 3) -> nn.Module:
    """Any of the 7 extractor backends (extractors.py:348-364)."""
    if variant in _RESNETS:
        return make_resnet(variant, late_fusion=late_fusion, in_channels=in_channels)
    if variant in ("densenet", "squeezenet"):
        if late_fusion:
            raise ValueError(f"{variant} extractor has no late-fusion variant "
                             "(reference extractors.py:368-373)")
        if variant == "densenet":
            return DenseNetExtractor(in_channels=in_channels)
        return SqueezeNetExtractor(in_channels=in_channels)
    raise KeyError(f"unknown extractor variant {variant}")


def feature_channels(variant: str, late_fusion: bool = False) -> List[int]:
    """Channels of the 5 taps, deepest first (extractors.py:367-377)."""
    if variant == "densenet":
        return [1024, 512, 256, 256, 64]
    if variant == "squeezenet":
        return [512, 256, 128, 64, 64]
    exp = 4 if _RESNETS[variant]["block_name"] == "bottleneck" else 1
    base = [512 * exp, 256 * exp, 128 * exp, 64 * exp, 64]
    if late_fusion:
        base = [base[0], base[1], base[2] * 2, base[3] * 2, base[4] * 2]
    return base
