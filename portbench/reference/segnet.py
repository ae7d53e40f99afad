"""Plain PyTorch ResNeXt-ASPP segnet: the benchmark's reference forward.

HeatNet's RGB+thermal segnet (Vertens, Zuern, Burgard, IROS 2020;
github.com/jzuern/heatnet-pub, models/trgb_segnet.py): a pre-activation
ResNeXt backbone (bottleneck blocks 1x1 -> grouped 3x3 -> 1x1, 64 groups,
strides and dilations per stage), ASPP (rates 1, 12, 24, 36 and a global
branch), and the fuse decoder (a x2 transposed conv, three 3x3 convs, a x4
transposed conv) that joins the logits with the stride-4 features.

Written from the paper's equations and the published layer list, in float32
NCHW with ``torch.nn.functional`` alone: no kernel of the program, no
channels_last, no fused epilogue. The grouped 3x3 conv is
``F.conv2d(groups=64)``. Submodules carry the parameter names that the
program's ``state_dict`` uses, so one dictionary of weights made by the
benchmark loads into both.

Batch norm: eval mode normalises with the running statistics; train mode
with the batch mean and the biased batch variance (running statistics are
not updated here: no compared number reads them).

``quant`` (the control, ``reference/lowp.py``) is applied to every conv's
input, weight and output when set: the activations the program would hold
in its precision. A ``quant`` with ``activations`` set is applied as well to
every batch norm's activated output and every residual sum.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


class Ctx:
    """What every layer of one forward reads: train or eval BN, the
    activation, and the optional low-precision cast of conv operands."""

    def __init__(self, train: bool, activation: str = "relu", slope: float = 0.01,
                 quant: Quant = None, eps: float = 1e-5):
        self.train, self.activation, self.slope = train, activation, slope
        self.quant, self.eps = quant, eps
        self.held_quant = quant if getattr(quant, "activations", False) else None

    def act(self, x: torch.Tensor) -> torch.Tensor:
        if self.activation == "relu":
            return F.relu(x)
        if self.activation == "leaky_relu":
            return F.leaky_relu(x, self.slope)
        raise ValueError(f"unknown activation {self.activation}")

    def q(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.quant is None else self.quant(t)

    def held(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.held_quant is None else self.held_quant(t)


class Conv(nn.Module):
    """A conv's parameters (``weight``, optional ``bias``) and its geometry."""

    def __init__(self, cin, cout, k, stride=1, padding=0, dilation=1, groups=1,
                 bias=False, std: Optional[float] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        self.stride, self.padding, self.dilation, self.groups = stride, padding, dilation, groups
        self.init_std = std  # the benchmark's weight maker reads it

    def forward(self, x, ctx: Ctx):
        return ctx.q(F.conv2d(ctx.q(x), ctx.q(self.weight), self.bias, self.stride,
                              self.padding, self.dilation, self.groups))


class Deconv(nn.Module):
    """A transposed conv, weight (in, out, k, k), no bias."""

    def __init__(self, cin, cout, k, stride, padding):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cin, cout, k, k))
        self.stride, self.padding = stride, padding
        self.init_std = None

    def forward(self, x, ctx: Ctx):
        return ctx.q(F.conv_transpose2d(ctx.q(x), ctx.q(self.weight), None, self.stride,
                                        self.padding))


class BN(nn.Module):
    """Batch norm's affine and running statistics (``bn.*`` names)."""

    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))
        self.register_buffer("running_mean", torch.empty(c))
        self.register_buffer("running_var", torch.empty(c))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))

    def forward(self, x, ctx: Ctx):
        if ctx.train:
            return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, ctx.eps)
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                            self.bias, False, 0.0, ctx.eps)


class ABN(nn.Module):
    """BN then the activation (the parameters under ``bn``)."""

    def __init__(self, c):
        super().__init__()
        self.bn = BN(c)

    def forward(self, x, ctx: Ctx):
        return ctx.held(ctx.act(self.bn(x, ctx)))


def conv(cin, cout, k, stride=1, dilation=1, groups=1):
    """Padding = dilation for a 3x3, 0 for a 1x1."""
    return Conv(cin, cout, k, stride, dilation if k == 3 else 0, dilation, groups)


class Block(nn.Module):
    """Pre-activation bottleneck: bn1 -> (proj) ; conv1 -> bn2 -> grouped
    conv2 -> bn3 -> conv3, plus the shortcut."""

    def __init__(self, cin, chans, stride, dilation, groups):
        super().__init__()
        self.need_proj = stride != 1 or cin != chans[2]
        self.bn1 = ABN(cin)
        if self.need_proj:
            self.proj_conv = conv(cin, chans[2], 1, stride)
        self.conv1 = conv(cin, chans[0], 1, stride)
        self.bn2 = ABN(chans[0])
        self.conv2 = conv(chans[0], chans[1], 3, 1, dilation, groups)
        self.bn3 = ABN(chans[1])
        self.conv3 = conv(chans[1], chans[2], 1)

    def forward(self, x, ctx):
        b = self.bn1(x, ctx)
        short = self.proj_conv(b, ctx) if self.need_proj else x
        out = self.bn2(self.conv1(b, ctx), ctx)
        out = self.bn3(self.conv2(out, ctx), ctx)
        return ctx.held(self.conv3(out, ctx) + short)


class Stage(nn.Module):
    def __init__(self, cin, n, chans, mod_id, groups, dilation):
        super().__init__()
        self.n = n
        for i in range(n):
            d = dilation[mod_id]
            if d == 1:
                s, dd = (2 if mod_id > 0 and i == 0 else 1), 1
            else:
                s, dd = 1, d
            self.add_module(f"block{i + 1}", Block(cin, chans, s, dd, groups))
            cin = chans[2]

    def forward(self, x, ctx):
        for i in range(self.n):
            x = getattr(self, f"block{i + 1}")(x, ctx)
        return x


class Stem(nn.Module):
    """3x3 s2 -> ABN -> 3x3 -> ABN -> 3x3 -> 3x3 s2 max pool: H/4, 64 channels."""

    def __init__(self, cin):
        super().__init__()
        self.conv1 = conv(cin, 64, 3, 2)
        self.bn1 = ABN(64)
        self.conv2 = conv(64, 64, 3)
        self.bn2 = ABN(64)
        self.conv3 = conv(64, 64, 3)

    def forward(self, x, ctx):
        x = self.bn1(self.conv1(x, ctx), ctx)
        x = self.bn2(self.conv2(x, ctx), ctx)
        return F.max_pool2d(self.conv3(x, ctx), 3, 2, 1)


class ConvABN(nn.Module):
    def __init__(self, cin, cout, k, dilation):
        super().__init__()
        pad = dilation if dilation != 1 else (1 if k == 3 else 0)
        self.conv1 = Conv(cin, cout, k, 1, pad, dilation)
        self.bn1 = ABN(cout)

    def forward(self, x, ctx):
        return self.bn1(self.conv1(x, ctx), ctx)


class ASPP(nn.Module):
    def __init__(self, cin, classes, rates):
        super().__init__()
        self.n = len(rates)
        for i, r in enumerate(rates):
            self.add_module(f"conv{i + 1}", ConvABN(cin, 256, 1 if r == 1 else 3, r))
        self.add_module(f"conv{self.n + 1}", ConvABN(cin, 256, 1, 1))
        self.fuse_conv = ConvABN(256 * (self.n + 1), 256, 1, 1)
        self.final_conv = ConvABN(256, classes, 1, 1)
        self.final_conv2 = ConvABN(256, 1, 1, 1)  # the certainty head: unused

    def forward(self, x, ctx):
        branches = [getattr(self, f"conv{i + 1}")(x, ctx) for i in range(self.n)]
        g = getattr(self, f"conv{self.n + 1}")(x.mean(dim=(2, 3), keepdim=True), ctx)
        branches.append(g.expand(-1, -1, *branches[-1].shape[2:]))
        fusion = self.fuse_conv(torch.cat(branches, 1), ctx)
        return self.final_conv(fusion, ctx), fusion


class Fuse(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv1 = conv(cin, cin, 3)
        self.bn1 = ABN(cin)
        self.conv2 = conv(cin, cin, 3)
        self.bn2 = ABN(cin)
        self.conv3 = conv(cin, cout, 3)
        self.up = Deconv(cout, cout, 8, 4, 2)

    def forward(self, x, ctx):
        x = self.bn1(self.conv1(x, ctx), ctx)
        x = self.bn2(self.conv2(x, ctx), ctx)
        return self.up(self.conv3(x, ctx), ctx)


class Segnet(nn.Module):
    """The early-fusion segnet. ``forward(x_nhwc, ctx)`` returns the float32
    NHWC logits and the six critic taps (NHWC): the logits,
    cat(ASPP fusion, the stride-4 features pooled to stride 8), and the
    outputs of stages 4, 3, 2 and the stem."""

    def __init__(self, structure: Sequence[int] = (3, 4, 6, 3), groups: int = 64,
                 classes: int = 13, dilation: Sequence[int] = (1, 1, 2, 4),
                 input_channels: int = 4, aspp_rates: Sequence[int] = (1, 12, 24, 36),
                 base_channels: Sequence[int] = (128, 128, 256)):
        super().__init__()
        ch = [list(base_channels)]
        for _ in range(3):
            ch.append([c * 2 for c in ch[-1]])
        self.mod1 = Stem(input_channels)
        self.mod2_1 = Stage(64, structure[0], ch[0], 0, groups, dilation)
        cin = ch[0][2]
        for mod_id, name in ((1, "mod3_1"), (2, "mod4_1"), (3, "mod5_1")):
            self.add_module(name, Stage(cin, structure[mod_id], ch[mod_id], mod_id,
                                        groups, dilation))
            cin = ch[mod_id][2]
        self.bn_out_1 = ABN(cin)
        self.aspp = ASPP(cin, classes, aspp_rates)
        self.up_seg_2 = Deconv(classes, classes, 4, 2, 1)
        self.fuse_seg = Fuse(classes + ch[0][2], classes)

    def forward(self, x: torch.Tensor, ctx: Ctx):
        x = x.float().permute(0, 3, 1, 2)
        out_1 = self.mod1(x, ctx)
        out_2 = self.mod2_1(out_1, ctx)
        out_3 = self.mod3_1(out_2, ctx)
        out_4 = self.mod4_1(out_3, ctx)
        seg5 = self.mod5_1(out_4, ctx)
        seg, fusion = self.aspp(self.bn_out_1(seg5, ctx), ctx)
        seg = self.up_seg_2(seg, ctx)
        seg = self.fuse_seg(torch.cat([seg, out_2], 1), ctx)
        skip_down = F.adaptive_avg_pool2d(out_2, fusion.shape[2:])
        taps = [seg, torch.cat([fusion, skip_down], 1), out_4, out_3, out_2, out_1]
        taps = [t.permute(0, 2, 3, 1) for t in taps]
        return taps[0], taps


def segnet_from_config(cfg: dict, input_channels: Optional[int] = None) -> Segnet:
    """The segnet that a configuration file's ``segnet`` group describes."""
    s = cfg["segnet"]
    return Segnet(tuple(s["structure"]), s["groups"], s["classes"], tuple(s["dilation"]),
                  input_channels or s["input_channels"], tuple(s["aspp_rates"]),
                  tuple(s["base_channels"]))
