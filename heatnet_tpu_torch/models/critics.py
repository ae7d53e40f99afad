"""Adversarial critics and the downscale feedback nets.

Counterpart of ``heatnet_tpu/models/critics.py:30-106``:

- ``FCDiscriminator``: 4 x (4x4 stride-2 conv + LeakyReLU 0.2), a 1-channel
  stride-2 classifier, then a float32 bilinear resize back to the tap's size
  (a patch-GAN map, NHWC ``(N, H, W, 1)``);
- ``PoolDiscriminator``: the conv stack with instance norms and a global
  average, ``(N, 1)``;
- ``DownNet``: N x (3x3 conv + instance norm + 0.5x bilinear), which
  shrinks the seg logits to a tap's size;
- ``create_critic``: ``cyclegan`` → ``FCDiscriminator``, ``resnet*`` → the
  ``ResNet`` classifier with one output.

A PyTorch module needs its input width, so each takes ``in_channels``
(flax infers it). Inputs and outputs are NHWC; the convolutions run in
``compute_dtype`` (bf16 on the card, set by ``prepare_for_training``) from
float32 parameters, and the maps come out float32 (float64 stays float64), as in the JAX
modules.

Split by rows (``parallel.spatial.spatial_parallel``) each critic runs its
maps by rows while its strided windows split the shards, and gathers the
first map they do not split whole (``spatial.RowsThenWhole``: at the
operating point the 1/32 map of a 320-row tap over 4 processes, 2.5 rows a
shard; ``PoolDiscriminator``'s stride-1 4x4 convs, which take H to H-1);
the rest runs on the whole map, every process alike. ``FCDiscriminator``'s
map is resized back to the tap's rows of each shard; the pooled scores
``(N, 1)`` are the whole frame's, the same on every process.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .extractors import make_resnet
from ..parallel import spatial
from .layers import (Conv2d, at_least_f32, global_avg_pool, instance_norm, normal002_conv,
                     resize_bilinear)


class FCDiscriminator(nn.Module):
    """Fully-convolutional patch critic, its map resized to the input's size."""

    def __init__(self, in_channels: int, ndf: int = 64):
        super().__init__()
        widths = [ndf, ndf * 2, ndf * 4, ndf * 8]
        for i, w in enumerate(widths):
            self.add_module(f"conv{i + 1}", normal002_conv(
                in_channels, w, 4, stride=2, padding=1))
            in_channels = w
        self.classifier = normal002_conv(in_channels, 1, 4, stride=2, padding=1)
        self.compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        in_hw = x.shape[1:3]
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        with spatial.RowsThenWhole() as frame:
            for i in range(4):
                conv = getattr(self, f"conv{i + 1}")
                x = F.leaky_relu(conv(frame.ready(x, *conv.window)), 0.2)
            x = at_least_f32(self.classifier(frame.ready(x, *self.classifier.window)))
        if frame.is_whole:  # each shard's rows of the resize to the whole tap
            return resize_bilinear(x, (spatial.frame_rows(in_hw[0]), in_hw[1]),
                                   frame=True).permute(0, 2, 3, 1)
        return resize_bilinear(x, in_hw).permute(0, 2, 3, 1)


class PoolDiscriminator(nn.Module):
    """PatchGAN conv stack + global average pooling → ``(N, 1)``."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.conv1 = normal002_conv(in_channels, 64, 4, stride=2, padding=1)
        self.conv2 = normal002_conv(64, 128, 4, stride=2, padding=1)
        self.conv3 = normal002_conv(128, 256, 4, stride=2, padding=1)
        self.conv4 = normal002_conv(256, 512, 4, stride=1, padding=1)
        self.conv5 = normal002_conv(512, 1, 4, stride=1, padding=1)
        self.compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        with spatial.RowsThenWhole() as frame:
            x = F.leaky_relu(self.conv1(frame.ready(x, *self.conv1.window)), 0.2)
            for conv in (self.conv2, self.conv3, self.conv4):
                x = F.leaky_relu(instance_norm(conv(frame.ready(x, *conv.window))), 0.2)
            x = self.conv5(frame.ready(x, *self.conv5.window))
            return global_avg_pool(at_least_f32(x)).flatten(1)


class DownNet(nn.Module):
    """``downsampling`` x (3x3 conv + instance norm + 0.5x bilinear); the
    channel count follows the input (critics.py:80-96)."""

    def __init__(self, downsampling: int, channels: int):
        super().__init__()
        self.downsampling = downsampling
        for i in range(downsampling):
            self.add_module(f"down{i + 1}_conv",
                            Conv2d(channels, channels, 3, padding=1, bias=False))
        self.compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Split by rows each shard's rows (even, so that every 0.5x output
        row reads two rows of its own shard)."""
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        for i in range(self.downsampling):
            x = instance_norm(getattr(self, f"down{i + 1}_conv")(x))
            x = resize_bilinear(x, (x.shape[2] // 2, x.shape[3] // 2))
        return x.permute(0, 2, 3, 1)


def create_critic(disc_arch: str, in_channels: int) -> nn.Module:
    """Critic factory (critics.py:99-106, conf_segnet.py:13-20)."""
    if disc_arch == "cyclegan":
        return FCDiscriminator(in_channels)
    if "resnet" in disc_arch:
        return make_resnet(disc_arch, in_channels=in_channels, num_classes=1)
    raise ValueError(f"unknown critic architecture {disc_arch}")
