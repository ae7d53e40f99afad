"""CycleGAN generator and discriminator for IR day↔night translation.

Counterpart of ``heatnet_tpu/models/cyclegan.py:24-86``: the ResNet
``Generator`` (reflect-pad 3 + 7x7 conv to 64, two stride-2 3x3 convs to 128
and 256, ``n_residual_blocks`` residual blocks, two transposed convs back to
64, reflect-pad 3 + 7x7 conv + ``tanh``), each conv followed by a
parameter-free instance norm and relu, and the patch ``Discriminator``, which
is the critics' ``PoolDiscriminator``.

Module names are the JAX tree's (``inconv``, ``down1``/``down2``,
``res{i}.conv1``/``conv2``, ``up1``/``up2``, ``outconv``), so
``io/from_jax.state_dict_from_jax`` converts a flax tree unchanged: ``up1``
and ``up2`` start with ``up`` and are converted as transposed convs. JAX's
transposed-conv padding ``((1, 2), (1, 2))`` on the stride-dilated input is
torch's ``ConvTranspose2d(3, stride=2, padding=1, output_padding=1)``: both
double the size, the extra row and column at the bottom and right. Every
conv has a bias (flax ``nn.Conv``'s default) and a N(0, 0.02) random init.

NHWC at the surface; the convolutions run in ``compute_dtype`` (bf16 on the
card, set by ``prepare_for_training``/``prepare_for_inference``), instance
norms take their statistics in float32, and the output is the float32 tanh
(float64 stays float64).

Split by rows (``parallel.spatial.spatial_parallel``) every layer computes
its shard's rows: a reflect pad takes its rows of halo from the neighbouring
shards and mirrors only at the frame's true top and bottom
(``spatial.halo_rows(reflect=True)``; the width is each shard's own), and the
VALID conv after it runs on the extended shard as it stands
(``Conv2d.local``); the stride-2 convs and the output-padded transposed convs
exchange their halos, and the instance norms take their statistics over the
whole frame.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel import spatial
from .critics import PoolDiscriminator as Discriminator  # noqa: F401
from .layers import (NORMAL002, Conv2d, ConvTranspose2d, at_least_f32, instance_norm,
                     normal002_conv)


def _reflect_conv(conv: Conv2d, x: torch.Tensor, p: int) -> torch.Tensor:
    """``conv`` (unpadded) of ``x`` reflect-padded by ``p`` rows and
    columns; split by rows, of the shard with ``p`` rows of halo a side,
    mirrored at the frame's edges only."""
    if spatial.spatial_group() is None:
        return conv(F.pad(x, (p, p, p, p), mode="reflect"))
    x = spatial.halo_rows(x, p, p, reflect=True)
    return conv.local(F.pad(x, (p, p, 0, 0), mode="reflect"))


class ResidualBlock(nn.Module):
    """reflect-pad 1, conv3, IN, relu, reflect-pad 1, conv3, IN, plus x."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = normal002_conv(features, features, 3)
        self.conv2 = normal002_conv(features, features, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(instance_norm(_reflect_conv(self.conv1, x, 1)))
        return x + instance_norm(_reflect_conv(self.conv2, y, 1))


def _up(in_channels: int, features: int) -> ConvTranspose2d:
    up = ConvTranspose2d(in_channels, features, 3, stride=2, padding=1,
                         output_padding=1)
    up.init_std = NORMAL002
    return up


class Generator(nn.Module):
    """CycleGAN ResNet generator (models.py:26-67); ``input_nc`` is the
    input's width (flax infers it)."""

    def __init__(self, output_nc: int, n_residual_blocks: int = 9, input_nc: int = 1):
        super().__init__()
        self.n_residual_blocks = n_residual_blocks
        self.inconv = normal002_conv(input_nc, 64, 7)
        self.down1 = normal002_conv(64, 128, 3, stride=2, padding=1)
        self.down2 = normal002_conv(128, 256, 3, stride=2, padding=1)
        for i in range(n_residual_blocks):
            self.add_module(f"res{i + 1}", ResidualBlock(256))
        self.up1 = _up(256, 128)
        self.up2 = _up(128, 64)
        self.outconv = normal002_conv(64, output_nc, 7)
        self.compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        y = F.relu(instance_norm(_reflect_conv(self.inconv, y, 3)))
        y = F.relu(instance_norm(self.down1(y)))
        y = F.relu(instance_norm(self.down2(y)))
        for i in range(self.n_residual_blocks):
            y = getattr(self, f"res{i + 1}")(y)
        y = F.relu(instance_norm(self.up1(y)))
        y = F.relu(instance_norm(self.up2(y)))
        y = _reflect_conv(self.outconv, y, 3)
        return torch.tanh(at_least_f32(y)).permute(0, 2, 3, 1)
