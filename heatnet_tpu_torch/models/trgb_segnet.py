"""ResNeXt-ASPP segmentation network, HeatNet RGB+thermal variant.

Counterpart of ``heatnet_tpu/models/trgb_segnet.py`` (``_Stage``,
``ResNeXtSeg``, ``net_resnext50``). Ported so far: early fusion (RGB and IR
concatenated into one stem, or one pre-fused input), the 3x3 ``InitBlock``
stem, eval and train mode. Late fusion, the certainty branch, the Vistas 7x7
stem and ResNeXt-101/152 raise ``NotImplementedError``.

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
``(seg, [seg, cat(fusion, skip_down), out_4, out_3, out_2, out_1], None)``
(trgb_segnet.py:248-258); seg is float32 whatever the compute dtype. The
outputs are views of channels_last tensors, so the layout change costs no
copy.
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
    deconv,
    stride_dilation,
)


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


class ResNeXtSeg(nn.Module):
    """Pre-activation ResNeXt backbone + ASPP + fuse/upsample head."""

    def __init__(self, structure: Sequence[int] = (3, 4, 6, 3), groups: int = 64,
                 classes: int = 13, dilation=(1, 1, 2, 4),
                 base_channels: Sequence[int] = (128, 128, 256),
                 input_channels: int = 4, cert_branch: bool = False,
                 late_fusion: bool = False, input_3x3: bool = True,
                 norm_act: NormAct = NormAct()):
        super().__init__()
        if late_fusion or cert_branch or not input_3x3:
            raise NotImplementedError(
                "late fusion, the cert branch and the 7x7 stem are not ported yet")
        self.classes = classes
        ch = [list(base_channels)]
        for _ in range(3):
            ch.append([c * 2 for c in ch[-1]])
        self.mod1 = InitBlock(input_channels, norm_act)
        in_ch = 64
        for mod_id, name in enumerate(("mod2_1", "mod3_1", "mod4_1", "mod5_1")):
            self.add_module(name, _Stage(
                in_ch, structure[mod_id], ch[mod_id], mod_id, groups,
                dilation if dilation != 1 else 1, norm_act))
            in_ch = ch[mod_id][-1]
        self.bn_out_1 = ABN(in_ch, norm_act)
        # final_conv2 (the cert head) always exists, as in the JAX tree
        # (trgb_segnet.py:270); its output is unused until the cert branch
        self.aspp = ASPP(in_ch, classes, cert_head=True, norm_act=norm_act)
        self.up_seg_2 = deconv(classes, classes, 4, 2, 1)
        self.fuse_seg = FuseModule(classes + ch[0][-1], classes, norm_act)
        # the activations' dtype (bf16 on the card, see prepare_for_inference)
        self.compute_dtype = torch.float32

    def forward(self, modal_1: torch.Tensor,
                modal_2: Optional[torch.Tensor] = None):
        """modal_1/modal_2 are NHWC (RGB and IR); modal_2 may be None, and
        modal_1 may then be the pre-fused 4-channel input."""
        x = modal_1 if modal_2 is None else torch.cat([modal_1, modal_2], -1)
        # a contiguous NHWC tensor, permuted, is NCHW in channels_last memory
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)

        out_1 = self.mod1(x)
        out_2 = self.mod2_1(out_1)
        out_3 = self.mod3_1(out_2)
        out_4 = self.mod4_1(out_3)
        seg5 = self.mod5_1(out_4)

        seg, fusion, _ = self.aspp(self.bn_out_1(seg5))
        seg = self.up_seg_2(seg)
        seg = self.fuse_seg(torch.cat([seg, out_2], dim=1))
        seg = seg.float()

        skip_down = adaptive_avg_pool(out_2, tuple(fusion.shape[2:]))
        taps = [seg, torch.cat([fusion, skip_down], dim=1), out_4, out_3,
                out_2, out_1]
        nhwc = [t.permute(0, 2, 3, 1) for t in taps]
        return nhwc[0], nhwc, None


def net_resnext50(**kw) -> ResNeXtSeg:
    return ResNeXtSeg(structure=(3, 4, 6, 3), **kw)
