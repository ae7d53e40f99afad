"""Split encoder/decoder ResNeXt of the IR uncertainty pretrainer.

Counterpart of ``heatnet_tpu/models/segnetsplit.py:25-109``:

- ``FuseModule2``: ``FuseModule`` whose last deconv is a 2x
  ``ConvTranspose2d(8, stride=2, padding=3)`` (named ``up``, so
  ``io/from_jax`` converts it as a transposed conv);
- ``ResNeXtEncoder``: the stem (``Stem7x7`` by default, ``InitBlock`` with
  ``input_3x3``), the four ``_Stage``s, ``bn_out_1`` and an ASPP without the
  cert head; returns ``(aspp_out, out_4)``, ``out_4`` being ``mod2_1``'s
  output;
- ``ResNeXtDecoder``: a 2x deconv ``up_seg_2``, the concat with ``out_4``,
  ``fuse_seg2`` (another 2x), then ``none``, ``sigmoid`` or ``log_softmax``
  in float32.

flax infers input widths; here the decoder's input has ``out_classes``
channels (the paired encoder's ``classes``) and its skip ``SKIP_CHANNELS``
(``mod2``'s width). The encoder has the JAX defaults' groups (64),
dilation (1,1,2,4) and widths. NHWC at the surface, ``compute_dtype``
inside (bf16 on the card).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from .layers import ABN, ASPP, InitBlock, NormAct, conv, deconv
from .trgb_segnet import Stem7x7, _Stage

SKIP_CHANNELS = 256  # mod2's output width: the encoder's out_4, the decoder's skip


class FuseModule2(nn.Module):
    """Three 3x3 conv(+ABN) stages, then a 2x ConvTranspose2d(8, 2, 3)
    (``fuseModule2``, segnetsplit.py:203-211)."""

    def __init__(self, in_channels: int, out_channels: int,
                 norm_act: NormAct = NormAct()):
        super().__init__()
        self.conv1 = conv(in_channels, in_channels, 3)
        self.bn1 = ABN(in_channels, norm_act)
        self.conv2 = conv(in_channels, in_channels, 3)
        self.bn2 = ABN(in_channels, norm_act)
        self.conv3 = conv(in_channels, out_channels, 3)
        self.up = deconv(out_channels, out_channels, 8, 2, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn1(self.conv1(x))
        x = self.bn2(self.conv2(x))
        return self.up(self.conv3(x))


class ResNeXtEncoder(nn.Module):
    """Backbone + ASPP; returns ``(aspp_out, out_4)`` as NHWC."""

    def __init__(self, structure: Sequence[int] = (3, 4, 6, 3), classes: int = 12,
                 in_channels: int = 3, input_3x3: bool = False,
                 norm_act: NormAct = NormAct()):
        super().__init__()
        ch = [[128, 128, SKIP_CHANNELS]]
        for _ in range(3):
            ch.append([c * 2 for c in ch[-1]])
        self.mod1 = (InitBlock if input_3x3 else Stem7x7)(in_channels, norm_act)
        in_ch = 64
        for mod_id, name in enumerate(("mod2_1", "mod3_1", "mod4_1", "mod5_1")):
            self.add_module(name, _Stage(in_ch, structure[mod_id], ch[mod_id], mod_id,
                                         64, (1, 1, 2, 4), norm_act))
            in_ch = ch[mod_id][-1]
        self.bn_out_1 = ABN(in_ch, norm_act)
        self.aspp = ASPP(in_ch, classes, cert_head=False, norm_act=norm_act)
        self.compute_dtype = torch.float32

    def forward(self, img: torch.Tensor):
        x = self.mod1(img.to(self.compute_dtype).permute(0, 3, 1, 2))
        out_4 = self.mod2_1(x)
        x = self.mod5_1(self.mod4_1(self.mod3_1(out_4)))
        seg, _, _ = self.aspp(self.bn_out_1(x))
        return seg.permute(0, 2, 3, 1), out_4.permute(0, 2, 3, 1)


ACTIVATIONS = ("none", "sigmoid", "log_softmax")


class ResNeXtDecoder(nn.Module):
    """2x deconv, concat the stage-2 skip, ``FuseModule2`` (another 2x), then
    the last activation in float32."""

    def __init__(self, out_classes: int = 12, last_activation: str = "none",
                 norm_act: NormAct = NormAct()):
        super().__init__()
        if last_activation not in ACTIVATIONS:
            raise ValueError(f"last_activation {last_activation!r} not in {ACTIVATIONS}")
        self.last_activation = last_activation
        self.up_seg_2 = deconv(out_classes, out_classes, 4, 2, 1)
        self.fuse_seg2 = FuseModule2(out_classes + SKIP_CHANNELS, out_classes, norm_act)
        self.compute_dtype = torch.float32

    def forward(self, encoded: torch.Tensor, out_4: torch.Tensor) -> torch.Tensor:
        def nchw(t):
            return t.to(self.compute_dtype).permute(0, 3, 1, 2)

        seg = self.up_seg_2(nchw(encoded))
        seg = self.fuse_seg2(torch.cat([seg, nchw(out_4)], dim=1)).float()
        if self.last_activation == "sigmoid":
            seg = torch.sigmoid(seg)
        elif self.last_activation == "log_softmax":
            seg = torch.log_softmax(seg, dim=1)
        return seg.permute(0, 2, 3, 1)
