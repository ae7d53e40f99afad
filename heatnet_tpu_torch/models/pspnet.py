"""PSPNet: a pyramid scene parsing head on a dilated extractor.

Counterpart of ``heatnet_tpu/models/pspnet.py:46-166`` (``PSPModule``,
``PSPUpsample``, ``PSPNet``, ``pspnet_tap_channels``): the extractor's
deepest tap → pyramid pooling (sizes 1, 2, 3, 6 plus the identity, a 1x1
bottleneck to 1024 channels, ReLU) → channel dropout 0.3 → three x2
upsamples (bilinear, 3x3 conv with bias, flax's ``BatchNorm``, a
one-parameter PReLU), each followed by channel dropout 0.15 → a 1x1
``final`` conv. ``forward`` returns ``(out, [out, f0, f1, f2, f3, f4], None)``
with ``out`` float32 NHWC, the trgb segnet's output tuple.

The pyramid is the JAX default, chunked form (``HEATNET_PSP_FUSED=1``,
:94-107): one ``bottleneck`` weight of shape ``(1024, 5 C, 1, 1)`` is
sliced per chunk, priors 1..4 then the identity; each prior's chunk is
applied to its pooled s x s map and then resized, and the chunks add up.

Channel dropout draws one Bernoulli per (sample, channel) and scales the
kept channels by 1/(1-p) (flax ``Dropout(broadcast_dims=(1, 2))``, :148-156).
It runs in train mode only, on keep masks the caller draws from an explicit
``torch.Generator`` (``draw_dropout``) and passes to ``forward``: a
train-mode forward without masks raises, and nothing reads the global RNG.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .extractors import feature_channels, make_extractor
from .layers import BatchNorm, Conv2d, adaptive_avg_pool, conv, resize_bilinear

# the channel dropouts in call order: after the pyramid, after up_1, up_2, up_3
DROPOUT_RATES = (0.3, 0.15, 0.15, 0.15)
DROPOUT_CHANNELS = (1024, 256, 64, 64)

DropoutMasks = Tuple[torch.Tensor, ...]  # one (N, C) bool keep mask per dropout


def draw_dropout(n: int, generator: torch.Generator) -> DropoutMasks:
    """The keep masks of one train-mode forward of batch ``n``: channel c of
    sample i is kept with probability 1 - p."""
    return tuple(torch.rand((n, c), generator=generator) < 1.0 - p
                 for p, c in zip(DROPOUT_RATES, DROPOUT_CHANNELS))


def channel_dropout(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    """``where(keep, x / (1 - rate), 0)`` with ``keep`` (N, C) broadcast over
    H and W of NCHW ``x``."""
    keep = keep.to(x.device, non_blocking=True)[:, :, None, None]
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


class PSPModule(nn.Module):
    """Pyramid pooling: priors at ``sizes`` plus the identity, one 1x1
    bottleneck applied chunk by chunk, ReLU."""

    def __init__(self, in_channels: int, out_channels: int = 1024,
                 sizes: Sequence[int] = (1, 2, 3, 6)):
        super().__init__()
        self.sizes = tuple(sizes)
        for i in range(len(self.sizes)):
            self.add_module(f"stage{i + 1}_conv", conv(in_channels, in_channels, 1))
        self.bottleneck = Conv2d(in_channels * (len(self.sizes) + 1), out_channels, 1)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        h, w = feats.shape[2:]
        c = feats.shape[1]
        weight = self.bottleneck.weight.to(feats.dtype)

        def chunk(x, i):
            return F.conv2d(x, weight[:, i * c:(i + 1) * c])

        bottle = chunk(feats, len(self.sizes))
        for i, size in enumerate(self.sizes):
            p = getattr(self, f"stage{i + 1}_conv")(adaptive_avg_pool(feats, (size, size)))
            bottle = bottle + resize_bilinear(chunk(p, i), (h, w))
        return F.relu(bottle + self.bottleneck.bias.to(bottle.dtype)[:, None, None])


class PReLU(nn.PReLU):
    """One-parameter PReLU, flax's initial slope 0.01, the slope cast to the
    input's dtype."""

    def __init__(self):
        super().__init__(num_parameters=1, init=0.01)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.prelu(x, self.weight.to(x.dtype))


class PSPUpsample(nn.Module):
    """x2 bilinear → 3x3 conv (bias) → BN → PReLU (pspnet.py:110-124)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, 3, padding=1, bias=True)
        self.bn = BatchNorm(out_channels)
        self.prelu = PReLU()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = resize_bilinear(x, (2 * x.shape[2], 2 * x.shape[3]))
        return self.prelu(self.bn(self.conv(p)))


class PSPNet(nn.Module):
    """feats → PSP → drop(0.3) → up x3, each with drop(0.15) → 1x1 final."""

    def __init__(self, n_classes: int = 13, sizes: Sequence[int] = (1, 2, 3, 6),
                 psp_size: int = 2048, backend: str = "resnet50",
                 late_fusion: bool = False, in_channels: int = 3):
        super().__init__()
        self.feats = make_extractor(backend, late_fusion=late_fusion,
                                    in_channels=in_channels)
        self.late_fusion = getattr(self.feats, "late_fusion", False)
        self.psp = PSPModule(psp_size, DROPOUT_CHANNELS[0], sizes)
        self.up_1 = PSPUpsample(DROPOUT_CHANNELS[0], DROPOUT_CHANNELS[1])
        self.up_2 = PSPUpsample(DROPOUT_CHANNELS[1], DROPOUT_CHANNELS[2])
        self.up_3 = PSPUpsample(DROPOUT_CHANNELS[2], DROPOUT_CHANNELS[3])
        self.final = Conv2d(DROPOUT_CHANNELS[3], n_classes, 1, bias=True)
        self.compute_dtype = torch.float32

    def draw_dropout(self, n: int, generator: torch.Generator) -> DropoutMasks:
        return draw_dropout(n, generator)

    def forward(self, modal_1: torch.Tensor, modal_2: Optional[torch.Tensor] = None,
                dropout: Optional[DropoutMasks] = None):
        """NHWC in; ``dropout`` (``draw_dropout``) is required in train mode
        and ignored in eval mode."""
        if self.training and dropout is None:
            raise ValueError("a train-mode PSPNet forward needs its dropout keep "
                             "masks (draw_dropout)")
        feats = self.feats(modal_1, modal_2)
        p = feats[0].permute(0, 3, 1, 2)  # NHWC view → NCHW channels_last
        stages = (self.psp, self.up_1, self.up_2, self.up_3)
        for i, stage in enumerate(stages):
            p = stage(p)
            if self.training:
                p = channel_dropout(p, dropout[i], DROPOUT_RATES[i])
        out = self.final(p).float().permute(0, 2, 3, 1)
        return out, [out] + list(feats), None


def pspnet_tap_channels(backend: str = "resnet50", classes: int = 13,
                        late_fusion: bool = False) -> List[int]:
    """Critic tap channels for arch 'pspnet' (pspnet.py:163-166)."""
    return [classes] + list(feature_channels(backend, late_fusion))
