"""Building blocks of ``ResNeXtSeg``, eval mode, PyTorch.

Counterpart of the parts of ``heatnet_tpu/models/layers.py`` that the RGB+thermal
inference path runs: ``NormAct``/``ABN`` (:38-62, :288-319), ``conv`` (:897-962),
the grouped conv, ``deconv``, the pools (:1153-1188), and
``IdentityResidualBlock``, ``ConvABN``, ``ASPP``, ``FuseModule``, ``InitBlock``
and ``stride_dilation`` (:1230-1435).

Only functions are ported, not XLA lowering choices: ``GroupedConvDense``'s
dense/native/int8 dispatch is the grouped conv of ``ops/grouped_conv.py``,
``banded_dilated_conv`` is ``nn.Conv2d(dilation=r, padding=r)``, and
``SubpixelConvTranspose`` is ``nn.ConvTranspose2d``.

Modules take NCHW tensors in ``torch.channels_last`` memory. Submodule names
are the JAX parameter tree's (``bn1``, ``conv2``, ABN's inner ``bn``), so a
``state_dict`` key is the JAX path joined with ``.``. Train mode is not
ported yet: a module in train mode raises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import grouped_conv as gc


@dataclasses.dataclass(frozen=True)
class NormAct:
    """Configuration of the ABN blocks (the reference's ``norm_act`` partial)."""

    activation: str = "relu"  # relu | leaky_relu | elu | none
    leaky_slope: float = 0.01
    bn_epsilon: float = 1e-5

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return gc.apply_act(x, self.activation, self.leaky_slope)


def _eval_only(module: nn.Module) -> None:
    if module.training:
        raise NotImplementedError(
            f"{type(module).__name__}: train mode is not ported yet; "
            "call .eval() first")


class ABN(nn.Module):
    """BatchNorm (running statistics) then activation (segnet.py:20-41).

    The statistics and affine stay float32 whatever the activation dtype:
    ``F.batch_norm`` computes in f32 and returns the input's dtype.
    """

    def __init__(self, channels: int, norm_act: NormAct = NormAct()):
        super().__init__()
        self.norm_act = norm_act
        self.bn = nn.BatchNorm2d(channels, eps=norm_act.bn_epsilon)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _eval_only(self)
        bn = self.bn
        x = F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                         False, 0.0, bn.eps)
        return self.norm_act.act(x)

    def affine(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The eval BN as ``x * scale + bias``, float32 (layers.py:1287-1309)."""
        bn = self.bn
        scale = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
        return scale, bn.bias.float() - bn.running_mean.float() * scale


class GroupedConv(nn.Module):
    """Grouped 3x3 stride-1 conv, padding = dilation, C in == C out.

    Owns the ``(C, C/groups, 3, 3)`` weight and calls ``ops/grouped_conv.py``
    (the CUDA kernel on the card). ``epilogue=(scale, bias, norm_act)``
    folds the following eval BN + activation into the same launch.
    """

    def __init__(self, channels: int, groups: int, dilation: int = 1):
        super().__init__()
        self.groups = groups
        self.dilation = dilation
        self.weight = nn.Parameter(
            torch.empty(channels, channels // groups, 3, 3))

    def forward(self, x: torch.Tensor, epilogue=None) -> torch.Tensor:
        xh = x.permute(0, 2, 3, 1)  # channels_last NCHW → contiguous NHWC view
        if epilogue is None:
            y = gc.grouped_conv3x3(xh, self.weight, self.groups, self.dilation)
        else:
            scale, bias, na = epilogue
            y = gc.grouped_conv3x3_fused(xh, self.weight, scale, bias,
                                         self.groups, self.dilation,
                                         na.activation, na.leaky_slope)
        return y.permute(0, 3, 1, 2)


def conv(in_channels: int, features: int, kernel: int, stride: int = 1,
         dilation: int = 1, groups: int = 1, padding: Optional[int] = None,
         use_bias: bool = False) -> nn.Module:
    """2D conv with the JAX package's defaults (padding = dilation for 3x3,
    0 for 1x1). A grouped 3x3 stride-1 conv is a ``GroupedConv``."""
    if padding is None:
        padding = dilation if kernel == 3 else 0
    if groups > 1:
        if (kernel, stride, padding, use_bias) != (3, 1, dilation, False) \
                or in_channels != features:
            raise NotImplementedError(
                "only the grouped 3x3 stride-1 'same' conv is ported")
        return GroupedConv(features, groups, dilation)
    return nn.Conv2d(in_channels, features, kernel, stride=stride,
                     padding=padding, dilation=dilation, bias=use_bias)


def deconv(in_channels: int, features: int, kernel: int, stride: int,
           padding: int, use_bias: bool = False) -> nn.ConvTranspose2d:
    """``ConvTranspose2d(k, s, p)``: the (4,2,1) and (8,4,2) decoder geometries."""
    return nn.ConvTranspose2d(in_channels, features, kernel, stride=stride,
                              padding=padding, bias=use_bias)


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """``nn.MaxPool2d(3, stride=2, padding=1)``."""
    return F.max_pool2d(x, 3, stride=2, padding=1)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Mean over H, W, kept as 1x1."""
    return x.mean(dim=(2, 3), keepdim=True)


def adaptive_avg_pool(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """``F.adaptive_avg_pool2d``: bins ``[floor(i*H/out), ceil((i+1)*H/out))``,
    the arithmetic the JAX version reproduces."""
    if tuple(x.shape[2:]) == tuple(out_hw):
        return x
    return F.adaptive_avg_pool2d(x, out_hw)


class IdentityResidualBlock(nn.Module):
    """Pre-activation bottleneck block (segnet.py:44-124), eval forward.

    ``channels`` = (c1, c2, c3): 1x1 → grouped 3x3 → 1x1. The projection
    shortcut consumes the normalised input, as in the reference. With
    groups > 1, ``conv2 → bn3 (+act)`` is one fused grouped-conv launch,
    its affine taken from bn3's running statistics in f32.
    """

    def __init__(self, in_channels: int, channels: Sequence[int],
                 stride: int = 1, dilation: int = 1, groups: int = 1,
                 norm_act: NormAct = NormAct()):
        super().__init__()
        chans = tuple(channels)
        if len(chans) != 3:
            raise NotImplementedError("only the bottleneck (3-conv) block is ported")
        self.norm_act = norm_act
        self.need_proj = stride != 1 or in_channels != chans[-1]
        self.bn1 = ABN(in_channels, norm_act)
        if self.need_proj:
            self.proj_conv = conv(in_channels, chans[-1], 1, stride=stride)
        self.conv1 = conv(in_channels, chans[0], 1, stride=stride)
        self.bn2 = ABN(chans[0], norm_act)
        self.conv2 = conv(chans[0], chans[1], 3, dilation=dilation, groups=groups)
        self.bn3 = ABN(chans[1], norm_act)
        self.conv3 = conv(chans[1], chans[2], 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _eval_only(self)
        bn1 = self.bn1(x)
        shortcut = self.proj_conv(bn1) if self.need_proj else x
        out = self.bn2(self.conv1(bn1))
        if isinstance(self.conv2, GroupedConv):
            scale, bias = self.bn3.affine()
            out = self.conv2(out, epilogue=(scale, bias, self.norm_act))
        else:
            out = self.bn3(self.conv2(out))
        return self.conv3(out) + shortcut


class ConvABN(nn.Module):
    """conv → ABN, the ``createConv`` unit of ASPP (trgb_segnet.py:152-163)."""

    def __init__(self, in_channels: int, features: int, kernel: int = 1,
                 dilation: int = 1, norm_act: NormAct = NormAct()):
        super().__init__()
        pad = dilation if dilation != 1 else (1 if kernel == 3 else 0)
        self.conv1 = conv(in_channels, features, kernel, dilation=dilation,
                          padding=pad)
        self.bn1 = ABN(features, norm_act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn1(self.conv1(x))


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling, rates (1, 12, 24, 36) + a global branch.

    Reference trgb_segnet.py:133-179. Returns ``(out, fusion, out_cert)``;
    ``out_cert`` is None unless ``cert_head``.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 rates: Sequence[int] = (1, 12, 24, 36),
                 kernels: Sequence[int] = (1, 3, 3, 3), cert_head: bool = False,
                 norm_act: NormAct = NormAct()):
        super().__init__()
        self.n_branches = len(rates)
        for i, (r, k) in enumerate(zip(rates, kernels)):
            self.add_module(f"conv{i + 1}",
                            ConvABN(in_channels, 256, k, r, norm_act))
        self.add_module(f"conv{len(rates) + 1}",
                        ConvABN(in_channels, 256, 1, 1, norm_act))
        self.fuse_conv = ConvABN(256 * (len(rates) + 1), 256, 1, 1, norm_act)
        self.final_conv = ConvABN(256, out_channels, 1, 1, norm_act)
        self.cert_head = cert_head
        if cert_head:
            self.final_conv2 = ConvABN(256, 1, 1, 1, norm_act)

    def forward(self, x: torch.Tensor):
        branches = [getattr(self, f"conv{i + 1}")(x)
                    for i in range(self.n_branches)]
        g = getattr(self, f"conv{self.n_branches + 1}")(global_avg_pool(x))
        branches.append(g.expand(-1, -1, *branches[-1].shape[2:]))
        fusion = self.fuse_conv(torch.cat(branches, dim=1))
        out = self.final_conv(fusion)
        out_cert = self.final_conv2(fusion) if self.cert_head else None
        return out, fusion, out_cert


class FuseModule(nn.Module):
    """Three 3x3 conv(+ABN) stages, then a 4x ConvTranspose2d(8, 4, 2)
    (``fuseModule``, segnet.py:188-196)."""

    def __init__(self, in_channels: int, out_channels: int,
                 norm_act: NormAct = NormAct()):
        super().__init__()
        self.conv1 = conv(in_channels, in_channels, 3)
        self.bn1 = ABN(in_channels, norm_act)
        self.conv2 = conv(in_channels, in_channels, 3)
        self.bn2 = ABN(in_channels, norm_act)
        self.conv3 = conv(in_channels, out_channels, 3)
        self.up = deconv(out_channels, out_channels, 8, 4, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn1(self.conv1(x))
        x = self.bn2(self.conv2(x))
        return self.up(self.conv3(x))


class InitBlock(nn.Module):
    """Stem: 3x3 s2 → ABN → 3x3 → ABN → 3x3 → max-pool s2 (``initBlock``,
    trgb_segnet.py:231-240), a 4x downsample to 64 channels."""

    def __init__(self, in_channels: int, norm_act: NormAct = NormAct()):
        super().__init__()
        self.conv1 = conv(in_channels, 64, 3, stride=2)
        self.bn1 = ABN(64, norm_act)
        self.conv2 = conv(64, 64, 3)
        self.bn2 = ABN(64, norm_act)
        self.conv3 = conv(64, 64, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn1(self.conv1(x))
        x = self.bn2(self.conv2(x))
        return max_pool_3x3_s2(self.conv3(x))


def stride_dilation(mod_id: int, block_id: int, dilation) -> Tuple[int, int]:
    """Per-block (stride, dilation) schedule (segnet.py:354-366)."""
    if dilation == 1:
        return (2 if mod_id > 0 and block_id == 0 else 1), 1
    d = dilation[mod_id]
    if d == 1:
        return (2 if mod_id > 0 and block_id == 0 else 1), 1
    try:
        d = d[block_id]
    except TypeError:
        pass
    return 1, d


def init_params(module: nn.Module, generator: torch.Generator) -> None:
    """Random weights from ``generator``: convolution weights ~ N(0, 1/fan_in)
    (flax's lecun_normal, untruncated), biases 0, BN identity."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, GroupedConv)):
                w = m.weight
                # flax's fan_in: the kernel's input channels (ConvTranspose
                # in (I, O, kh, kw) included) times its window
                fan_in = w.shape[1 if not isinstance(m, nn.ConvTranspose2d)
                                 else 0] * w.shape[2] * w.shape[3]
                w.copy_(torch.randn(w.shape, generator=generator)
                        / math.sqrt(fan_in))
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()


def prepare_for_inference(module: nn.Module, device: torch.device) -> nn.Module:
    """Eval mode on ``device``; convolution weights in the compute dtype.

    On the card the convolutions run in bf16 (the JAX package computes them
    in bf16 from float32 parameters, trgb_segnet.py:17-18; here the weights
    are cast once) and BN stays float32. Dense convolution weights move to
    channels_last, the activations' layout, so cuDNN does not relayout them
    per call; the grouped conv's weight stays contiguous, as its kernel reads it.
    """
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    module.eval().to(device)
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            m.to(dtype=dtype, memory_format=torch.channels_last)
        elif isinstance(m, GroupedConv):
            m.to(dtype=dtype)
    return module
