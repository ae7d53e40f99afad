"""ResNeXt-ASPP segmentation network, HeatNet RGB+thermal variant.

Counterpart of ``heatnet_tpu/models/trgb_segnet.py`` (``_Stage``,
``Stem7x7``, ``ResNeXtSeg``, ``net_resnext{50,101,152}``, ``tap_channels``):
early fusion (RGB and IR concatenated into one stem, or one pre-fused
input), late fusion (:207-213: stems ``mod1``/``mod1_2`` and stages
``mod2_1``/``mod2_2``, one per modality, concatenated before ``mod3_1``), the
3x3 ``InitBlock`` stem or the Vistas 7x7 one (``input_3x3=False``), the
certainty branch (:276-291), eval and train mode.

flax infers every input width; here they are explicit. ``input_channels``
is the early-fusion stem's width. With ``late_fusion`` the first modality is
RGB (3 channels) and the second takes the other ``input_channels - 3`` (1,
IR, for ``ir_rgb``); a late-fusion net over one modality
(``input_channels <= 3``) is the single-stem net, as the JAX module falls
back to it when ``modal_2`` is None (:214-221). The widths behind the stems
follow: ``mod3_1`` and the fuse heads take twice ``mod2``'s 256 channels.

Mixed precision as in the JAX module (:115-117): the input is cast to
``compute_dtype`` (bf16 on the card, set by ``prepare_for_inference`` /
``prepare_for_training``), every convolution casts its weight to it, BN
statistics and affine stay float32, and the logits come out float32.

There is no rematerialisation. The JAX module's ``remat`` and
``HEATNET_REMAT_*`` (:119-182) trade recompute for memory on a 16 GB TPU and
do not change the function. At batch 10 x 320x640 the activations autograd
saves are of the order of 10 GB (about 0.6 GB per frame in bf16, more with
the float32 BN statistics), well inside the H100's 80 GB.

``forward`` takes and returns NHWC, like the JAX module, and returns
``(seg, [seg, cat(fusion, skip_down), out_4, out_3, out_2, out_1], cert)``
(trgb_segnet.py:248-258); seg is float32 whatever the compute dtype, and
cert is None, or with ``cert_branch`` the float32 sigmoid ``(N, H, W, 1)``
of ``fuse_seg_cert``. The outputs are views of channels_last tensors, so
the layout change costs no copy.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from .layers import (
    ABN,
    ASPP,
    FuseModule,
    IdentityResidualBlock,
    InitBlock,
    NormAct,
    adaptive_avg_pool,
    conv,
    deconv,
    max_pool_3x3_s2,
    stride_dilation,
)

RGB_CHANNELS = 3  # the first modality of a late-fusion net


class _Stage(nn.Sequential):
    """A group of IdentityResidualBlocks (one ``mod{i}_{j}`` of the reference)."""

    def __init__(self, in_channels: int, num_blocks: int, channels: Sequence[int],
                 mod_id: int, groups: int, dilation, norm_act: NormAct):
        super().__init__()
        for block_id in range(num_blocks):
            s, d = stride_dilation(mod_id, block_id, dilation)
            self.add_module(f"block{block_id + 1}", IdentityResidualBlock(
                in_channels, channels, stride=s, dilation=d, groups=groups,
                norm_act=norm_act))
            in_channels = channels[-1]


class Stem7x7(nn.Module):
    """7x7 stride-1 conv, no BN, then a 3x3 stride-2 max-pool (segnet.py:272-276,
    ``input_3x3=False``): a 2x downsample to 64 channels."""

    def __init__(self, in_channels: int, norm_act: NormAct = NormAct()):
        super().__init__()
        self.conv1 = conv(in_channels, 64, 7, padding=3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool_3x3_s2(self.conv1(x))


class ResNeXtSeg(nn.Module):
    """Pre-activation ResNeXt backbone + ASPP + fuse/upsample head."""

    def __init__(self, structure: Sequence[int] = (3, 4, 6, 3), groups: int = 64,
                 classes: int = 13, dilation=(1, 1, 2, 4),
                 base_channels: Sequence[int] = (128, 128, 256),
                 input_channels: int = 4, cert_branch: bool = False,
                 late_fusion: bool = False, input_3x3: bool = True,
                 norm_act: NormAct = NormAct()):
        super().__init__()
        self.classes = classes
        self.cert_branch = cert_branch
        self.late_fusion = late_fusion and input_channels > RGB_CHANNELS
        ch = [list(base_channels)]
        for _ in range(3):
            ch.append([c * 2 for c in ch[-1]])
        dilation = dilation if dilation != 1 else 1
        stem = InitBlock if input_3x3 else Stem7x7

        def stage(mod_id, in_ch):
            return _Stage(in_ch, structure[mod_id], ch[mod_id], mod_id, groups,
                          dilation, norm_act)

        if self.late_fusion:
            self.mod1 = stem(RGB_CHANNELS, norm_act)
            self.mod1_2 = stem(input_channels - RGB_CHANNELS, norm_act)
            self.mod2_1 = stage(0, 64)
            self.mod2_2 = stage(0, 64)
            skip_ch = 2 * ch[0][-1]
        else:
            self.mod1 = stem(input_channels, norm_act)
            self.mod2_1 = stage(0, 64)
            skip_ch = ch[0][-1]
        in_ch = skip_ch
        for mod_id, name in ((1, "mod3_1"), (2, "mod4_1"), (3, "mod5_1")):
            self.add_module(name, stage(mod_id, in_ch))
            in_ch = ch[mod_id][-1]
        self.bn_out_1 = ABN(in_ch, norm_act)
        # final_conv2 (the cert head) always exists, as in the JAX tree
        # (trgb_segnet.py:270); its output is unused until the cert branch
        self.aspp = ASPP(in_ch, classes, cert_head=True, norm_act=norm_act)
        self.up_seg_2 = deconv(classes, classes, 4, 2, 1)
        self.fuse_seg = FuseModule(classes + skip_ch, classes, norm_act)
        if cert_branch:
            self.up_seg_2_cert = deconv(1, 1, 4, 2, 1)
            self.fuse_seg_cert = FuseModule(1 + skip_ch, 1, norm_act)
        # the activations' dtype (bf16 on the card, see prepare_for_inference)
        self.compute_dtype = torch.float32

    def forward(self, modal_1: torch.Tensor,
                modal_2: Optional[torch.Tensor] = None):
        """modal_1/modal_2 are NHWC (RGB and IR); modal_2 may be None, and
        modal_1 may then be the pre-fused 4-channel input. A late-fusion net
        takes both."""
        # a contiguous NHWC tensor, permuted, is NCHW in channels_last memory
        def nchw(t):
            return t.to(self.compute_dtype).permute(0, 3, 1, 2)

        if self.late_fusion:
            if modal_2 is None:
                raise ValueError("a late-fusion ResNeXtSeg takes RGB and IR apart")
            out_1a, out_1b = self.mod1(nchw(modal_1)), self.mod1_2(nchw(modal_2))
            out_1 = torch.cat([out_1a, out_1b], dim=1)
            out_2 = torch.cat([self.mod2_1(out_1a), self.mod2_2(out_1b)], dim=1)
        else:
            x = modal_1 if modal_2 is None else torch.cat([modal_1, modal_2], -1)
            out_1 = self.mod1(nchw(x))
            out_2 = self.mod2_1(out_1)
        out_3 = self.mod3_1(out_2)
        out_4 = self.mod4_1(out_3)
        seg5 = self.mod5_1(out_4)

        seg, fusion, seg_cf = self.aspp(self.bn_out_1(seg5))
        seg = self.up_seg_2(seg)
        seg = self.fuse_seg(torch.cat([seg, out_2], dim=1))
        seg = seg.float()
        cert = None
        if self.cert_branch:
            cert = self.up_seg_2_cert(seg_cf)
            cert = self.fuse_seg_cert(torch.cat([cert, out_2], dim=1))
            cert = torch.sigmoid(cert.float()).permute(0, 2, 3, 1)

        skip_down = adaptive_avg_pool(out_2, tuple(fusion.shape[2:]))
        taps = [seg, torch.cat([fusion, skip_down], dim=1), out_4, out_3,
                out_2, out_1]
        nhwc = [t.permute(0, 2, 3, 1) for t in taps]
        return nhwc[0], nhwc, cert


def net_resnext50(**kw) -> ResNeXtSeg:
    return ResNeXtSeg(structure=(3, 4, 6, 3), **kw)


def net_resnext101(**kw) -> ResNeXtSeg:
    return ResNeXtSeg(structure=(3, 4, 23, 3), **kw)


def net_resnext152(**kw) -> ResNeXtSeg:
    return ResNeXtSeg(structure=(3, 8, 36, 3), **kw)


def tap_channels(classes: int = 13, late_fusion: bool = False) -> list:
    """Channel counts of the 6 critic taps (trgb_segnet.py:306-310)."""
    if late_fusion:
        return [classes, 768, 1024, 512, 512, 128]
    return [classes, 512, 1024, 512, 256, 64]
