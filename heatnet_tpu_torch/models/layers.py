"""Building blocks of ``ResNeXtSeg``, eval and train mode, PyTorch.

Counterpart of the parts of ``heatnet_tpu/models/layers.py`` that the RGB+thermal
serving, supervised and adversarial training paths run: ``NormAct``/``ABN``
with ``StatNamedBatchNorm``'s train-mode statistics (:38-198, :288-319), flax's
``BatchNorm`` rule on its own (``BatchNorm``), ``conv`` (:897-962), the grouped
conv, ``deconv``, the pools (:1153-1188), ``resize_bilinear``,
``instance_norm`` and ``normal002`` (:1191-1222), and ``IdentityResidualBlock``,
``ConvABN``, ``ASPP``, ``FuseModule``, ``InitBlock`` and ``stride_dilation``
(:1230-1435).

Only functions are ported, not XLA lowering choices: ``GroupedConvDense``'s
dense/native dispatch is the grouped conv of ``ops/grouped_conv.py``,
``banded_dilated_conv`` is ``nn.Conv2d(dilation=r, padding=r)``, and
``SubpixelConvTranspose`` is ``nn.ConvTranspose2d``. The int8 serving mode
is ported as layers, because its dispatch decides the numerics:
``Int8Conv2d`` (``Int8Conv``, :760-894) and ``Int8GroupedConv``
(``GroupedConvDense``'s int8 arm and its predicate, :458-553), with
``int8_batch_ok`` (:716-736); ``ops/quant.py::convert_int8`` puts them in a
model.

Modules take NCHW tensors in ``torch.channels_last`` memory. Submodule names
are the JAX parameter tree's (``bn1``, ``conv2``, ABN's inner ``bn``), so a
``state_dict`` key is the JAX path joined with ``.``. Every convolution casts
its weight to the activations' dtype at call time, as the JAX convs do
(``kern.astype(self.dtype)``): float32 parameters train under bf16
activations. ``NormAct.bn_groups > 1`` takes train-mode BN statistics per
contiguous batch group (``StatNamedBatchNorm._grouped_train_call``,
:200-266). ``HEATNET_BN_IMPL=lean`` takes ``ABN``'s train mode through
``ops/lean_bn.py``. Inside ``parallel.mesh.data_parallel`` over several
processes, train-mode statistics are those of the whole batch.

Inside ``parallel.spatial.spatial_parallel``, a frame is split by rows over
processes and each operation computes exactly its rows of the unsharded
result: convolutions, transposed convolutions (output padding included), the
grouped conv, the int8 layers (float or int8 branch, chosen on the frame's
shape) and the max pools run on their shard extended by its halo of
neighbouring rows (``parallel/spatial.py``), the frame's true top and bottom
padded as each operation pads them; ``global_avg_pool``,
``adaptive_avg_pool(frame=True)`` and ``instance_norm`` sum over the
processes, and ``adaptive_avg_pool`` serves a factor of 1 or 2 in height
within a shard; ``resize_bilinear`` serves a map held whole to the frame's
rows (``frame=True``) and an integer factor (up or down) of a shard.
Train-mode BN takes its statistics over the shards, every exchange carries
its gradient back (training by rows). Other pools and resizes, and convs
padded other than with zeros, raise there, as the int8 layers do in train
mode anywhere.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import grouped_conv as gc
from ..ops import int8_conv
from ..ops.lean_bn import lean_bn_act
from ..parallel import spatial
from ..parallel.mesh import all_reduce_max, batch_stats_group, stats_split_by_rows


@dataclasses.dataclass(frozen=True)
class NormAct:
    """Configuration of the ABN blocks (the reference's ``norm_act`` partial)."""

    activation: str = "relu"  # relu | leaky_relu | elu | none
    leaky_slope: float = 0.01
    bn_momentum: float = 0.9  # flax's: running = m * running + (1 - m) * batch
    bn_epsilon: float = 1e-5
    # > 1: train-mode BN statistics per contiguous batch group of N/bn_groups
    # samples (nn.DataParallel's per-GPU BN); 1: over the whole batch
    bn_groups: int = 1

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return gc.apply_act(x, self.activation, self.leaky_slope)


class BatchNorm(nn.BatchNorm2d):
    """flax's ``nn.BatchNorm(momentum=m)`` with PyTorch's parameter names.

    Eval mode normalises with the running statistics. Train mode (flax,
    layers.py:173-198) normalises with the batch mean and the *biased* batch
    variance and updates the running statistics as ``m * running + (1 - m)
    * batch``, biased variance included. PyTorch's own update stores the
    unbiased variance, so the normalisation runs with no running statistics
    and the update is made here, without gradient. The statistics and
    affine stay float32 whatever the activation dtype: the batch-norm
    kernels compute in f32 and return the input's dtype.

    ``groups > 1`` (train mode only) splits the batch into that many
    contiguous groups and normalises each with its own statistics, the
    gradient flowing through each group's statistics; only group 0's
    statistics update the running ones, as only the first replica's buffers
    persist under ``nn.DataParallel`` (``_grouped_train_call``, :200-266).
    A batch that ``groups`` does not divide raises.

    Over processes (``parallel.mesh.batch_stats_group``) the count, sum and
    sum of squares are all-reduced in float64 (``ops/lean_bn.py``). Under
    ``data_parallel`` each process holds whole batch groups; split by rows
    (``spatial_parallel``) each batch group takes its statistics over every
    shard, and group 0's, equal on every process, update the running ones.
    """

    def __init__(self, channels: int, eps: float = 1e-5, momentum: float = 0.9,
                 groups: int = 1):
        super().__init__(channels, eps=eps)
        self.flax_momentum = momentum
        self.groups = groups

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        group = batch_stats_group()
        if group is not None and (self.groups == 1 or stats_split_by_rows()):
            if x.shape[0] % self.groups:
                raise ValueError(f"batch {x.shape[0]} not divisible by bn_groups "
                                 f"{self.groups}")
            outs = [spatial.ordered(lambda t: lean_bn_act(
                t, self.weight, self.bias, self.eps, "none", 0.0, group, torch.float64),
                xg, self.weight, self.bias) for xg in x.chunk(self.groups)]
            self.update_running(*outs[0][1:])
            return outs[0][0] if self.groups == 1 else torch.cat([o[0] for o in outs])
        groups = self.groups
        if group is not None:
            # the global batch's contiguous groups: whole groups on each process
            d = torch.distributed.get_world_size(group)
            if groups % d:
                raise ValueError(f"bn_groups {groups} not divisible by the {d} "
                                 "data-parallel processes")
            groups //= d
        if x.shape[0] % groups:
            raise ValueError(f"batch {x.shape[0]} not divisible by bn_groups {groups}")
        outs = [torch.native_batch_norm(xg, self.weight, self.bias, None, None, True,
                                        0.0, self.eps)
                for xg in x.chunk(groups)]
        _, mean, invstd = outs[0]
        # invstd = 1 / sqrt(var + eps): the kernel's biased variance
        self.update_running(mean, (invstd.float().pow(-2) - self.eps).clamp_(min=0.0))
        if group is not None:  # group 0 is the first process's
            for b in (self.running_mean, self.running_var):
                torch.distributed.broadcast(b, torch.distributed.get_global_rank(group, 0),
                                            group=group)
        return outs[0][0] if groups == 1 else torch.cat([o[0] for o in outs])

    @torch.no_grad()
    def update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """``running = m * running + (1 - m) * batch`` (flax's momentum)."""
        m = self.flax_momentum
        self.running_mean.mul_(m).add_(mean.float(), alpha=1.0 - m)
        self.running_var.mul_(m).add_(var.float(), alpha=1.0 - m)


class ABN(nn.Module):
    """BatchNorm then activation (segnet.py:20-41); ``bn`` is a
    ``BatchNorm``, flax's train-mode rule.

    ``HEATNET_BN_IMPL=lean`` (layers.py:308-315): in train mode with
    ``bn_groups == 1`` the normalisation and the activation run as
    ``ops/lean_bn.py::lean_bn_act``, whose backward saves ``y`` and the
    per-channel statistics only; the running statistics update by the same
    rule and the parameter names do not change. Eval mode and every other
    case take ``bn`` then the activation."""

    def __init__(self, channels: int, norm_act: NormAct = NormAct()):
        super().__init__()
        self.norm_act = norm_act
        self.bn = BatchNorm(channels, norm_act.bn_epsilon, norm_act.bn_momentum,
                            norm_act.bn_groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if (self.training and self.norm_act.bn_groups == 1
                and os.environ.get("HEATNET_BN_IMPL") == "lean"):
            bn = self.bn
            a, mean, var = spatial.ordered(lambda t: lean_bn_act(
                t, bn.weight, bn.bias, bn.eps, self.norm_act.activation,
                self.norm_act.leaky_slope, batch_stats_group()), x, bn.weight, bn.bias)
            bn.update_running(mean, var)
            return a
        return self.norm_act.act(self.bn(x))

    def affine(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The eval BN as ``x * scale + bias``, float32 (layers.py:1287-1309)."""
        bn = self.bn
        scale = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
        return scale, bn.bias.float() - bn.running_mean.float() * scale


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with its weight cast to the input's dtype per call.

    ``init_std`` set: ``init_params`` draws the weight from N(0, init_std)
    (the critics' ``normal002``) instead of flax's lecun_normal.
    """

    init_std: Optional[float] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv(x, self.weight.to(x.dtype),
                          None if self.bias is None else self.bias.to(x.dtype))

    def _conv(self, x: torch.Tensor, w: torch.Tensor,
              b: Optional[torch.Tensor]) -> torch.Tensor:
        if spatial.spatial_group() is None:
            return self._conv_forward(x, w, b)
        return F.conv2d(self._window(x), w, b, self.stride, (0, self.padding[1]),
                        self.dilation, self.groups)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """The conv of ``x`` as it stands, with no exchange: ``x`` whole, or
        a shard that its caller already extended by the halo the conv reads
        (a VALID conv after ``spatial.halo_rows``)."""
        return self._conv_forward(x, self.weight.to(x.dtype),
                                  None if self.bias is None else self.bias.to(x.dtype))

    @property
    def window(self) -> Tuple[int, int, int, int]:
        """(kernel, stride, padding, dilation) in height."""
        return self.kernel_size[0], self.stride[0], self.padding[0], self.dilation[0]

    def _window(self, x: torch.Tensor) -> torch.Tensor:
        """Split by rows: this shard and the halo that the conv, unpadded in
        height, needs for exactly its rows."""
        if self.padding_mode != "zeros" or isinstance(self.padding, str):
            spatial.refuse(f"a conv padded with {self.padding_mode!r} ({self.padding!r})",
                           "the halo pads the frame's top and bottom with zeros")
        return spatial.window_rows(x, *self.window)


class Linear(nn.Linear):
    """``nn.Linear`` (flax ``Dense``) with its weight cast to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype),
                        None if self.bias is None else self.bias.to(x.dtype))


# the reference's weights_init_normal (confusion_maximization/utils.py:126-132),
# the JAX package's ``normal002`` initialiser (layers.py:1222)
NORMAL002 = 0.02


def normal002_conv(*args, **kw) -> Conv2d:
    """A ``Conv2d`` whose random init is N(0, 0.02)."""
    c = Conv2d(*args, **kw)
    c.init_std = NORMAL002
    return c


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int],
                    frame: bool = False) -> torch.Tensor:
    """Bilinear resize of NCHW ``x``, half-pixel centres and no antialiasing
    (layers.py:1191-1205): ``F.interpolate(align_corners=False)``, 0.5x
    downscales included.

    Split by rows, this shard's rows of the unsharded resize, in two forms:
    ``frame=True``, ``x`` held whole by every process (PSPNet's pooled
    priors, a critic's map gathered whole) and ``out_hw`` the frame's size
    (``spatial.frame_resize_rows``); or a shard resized by an integer factor
    in height, up (``PSPUpsample``'s x2, a critic's x32) or down
    (``DownNet``'s 0.5x), ``out_hw`` the shard's output size
    (``spatial.resize_rows``). Other factors raise there."""
    if spatial.spatial_group() is not None:
        if frame:
            return spatial.frame_resize_rows(x, out_hw)
        return spatial.resize_rows(x, out_hw)
    if tuple(x.shape[2:]) == tuple(out_hw):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=False)


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32 where a module's output or statistics leave bf16 for
    float32; float64 stays float64, so a float64 check keeps its precision."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``InstanceNorm2d`` without affine (layers.py:1213-1217): per sample
    and channel over H, W, biased variance. The statistics are taken in
    f32 (``at_least_f32``) and the result returns in x's dtype. Split by
    rows, over the whole frame: each shard's count, sum and sum of squares
    summed over the processes (``spatial.frame_moments``)."""
    xf = at_least_f32(x)
    if spatial.spatial_group() is not None:
        mean, var = spatial.frame_moments(xf)
    else:
        var, mean = torch.var_mean(xf, dim=(2, 3), keepdim=True, correction=0)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` with its weight cast to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        if spatial.spatial_group() is None:
            return F.conv_transpose2d(x, w, b, self.stride, self.padding,
                                      self.output_padding, self.groups, self.dilation)
        rows = x.shape[2] * self.stride[0]
        xe, first = spatial.transposed_rows(x, self.kernel_size[0], self.stride[0],
                                            self.padding[0], self.dilation[0],
                                            self.output_padding[0])
        y = F.conv_transpose2d(xe, w, b, self.stride, (0, self.padding[1]),
                               (0, self.output_padding[1]), self.groups, self.dilation)
        return y.narrow(2, first, rows)


class GroupedConv(nn.Module):
    """Grouped 3x3 stride-1 conv, padding = dilation, C in == C out.

    Owns the ``(C, C/groups, 3, 3)`` weight and calls ``ops/grouped_conv.py``
    (the CUDA kernel on the card), differentiably, the weight cast to the
    input's dtype. ``epilogue=(scale, bias, norm_act)`` folds the following
    eval BN + activation into the same launch (no gradient). Split by rows
    (``spatial_parallel``), the kernel runs on the shard extended by d rows
    of halo a side and its 2d extra output rows are dropped (counted in
    ``parallel.spatial.EXCHANGE``).
    """

    def __init__(self, channels: int, groups: int, dilation: int = 1):
        super().__init__()
        self.groups = groups
        self.dilation = dilation
        self.weight = nn.Parameter(
            torch.empty(channels, channels // groups, 3, 3))

    def forward(self, x: torch.Tensor, epilogue=None) -> torch.Tensor:
        return self._forward(x, self.weight, epilogue)

    def _forward(self, x: torch.Tensor, weight: torch.Tensor, epilogue) -> torch.Tensor:
        if spatial.spatial_group() is not None:
            # the halo-extended shard is a fresh channels_last tensor: its
            # NHWC view is the contiguous operand the kernel takes
            d, rows = self.dilation, x.shape[2]
            y = self._conv(spatial.halo_rows(x, d, d), weight, epilogue)
            spatial.EXCHANGE["extra_rows"] += 2 * d
            spatial.EXCHANGE["rows"] += rows
            return y.narrow(2, d, rows)
        return self._conv(x, weight, epilogue)

    def _conv(self, x: torch.Tensor, weight: torch.Tensor, epilogue) -> torch.Tensor:
        xh = x.permute(0, 2, 3, 1)  # channels_last NCHW → contiguous NHWC view
        if epilogue is None:
            y = gc.differentiable_grouped_conv3x3(xh, weight, self.groups, self.dilation)
        else:
            scale, bias, na = epilogue
            y = gc.grouped_conv3x3_fused(xh, weight.to(x.dtype), scale, bias,
                                         self.groups, self.dilation,
                                         na.activation, na.leaky_slope)
        return y.permute(0, 3, 1, 2)


def int8_batch_ok(n, min_batch: int) -> bool:
    """``_int8_batch_ok`` (layers.py:716-736): int8 is a throughput mode,
    served from ``min_batch`` frames up (JAX's ``HEATNET_INT8_MIN_BATCH``,
    default 8); below it a layer serves its float conv. A symbolic batch
    (``torch.export``'s) counts as the throughput regime, as JAX counts an
    exported artifact's, with no guard on the batch."""
    return isinstance(n, torch.SymInt) or n >= min_batch


class _Int8Layer:
    """What the int8 layers share (``Int8Conv``, layers.py:760-894).

    ``x_scale`` is a persistent float32 buffer of shape ``()``, zero until
    calibrated: with ``calibrating`` set, each call raises it to the running
    max of ``max|x_f32| / 127`` before it picks its branch, as the JAX layers
    update the ``quant`` collection before ``_calibrated_branch``. A zero
    scale serves the float conv (``_calibrated_branch``, :739-757). The
    weight stays the float32 parameter, so the ``state_dict`` is the float
    model's plus ``x_scale``; its quantization (``w_q``, ``w_scale``, the
    kernel's packing) and its copy in the activations' dtype are derived on
    first use after any change of the parameter, and are not saved.

    ``freeze()`` fixes them, and whether the layer is calibrated, for
    ``torch.export`` (``io/export.py``): a traced layer can read neither a
    tensor's address nor its value. The derived weights become buffers that
    the exported program carries; ``thaw()`` undoes it.
    """

    def _init_int8(self, min_batch: int, max_hw: int) -> None:
        self.min_batch = min_batch
        self.max_hw = max_hw
        self.calibrating = False
        self.register_buffer("x_scale", torch.zeros((), dtype=torch.float32))
        self._derived = None   # (key, w_q, w_pack, w_scale, w_float)
        self._positive = None  # (key, x_scale > 0) read once per change of x_scale
        self._frozen = None    # (dtype, calibrated) while frozen

    _FROZEN = ("frozen_w_q", "frozen_w_pack", "frozen_w_scale", "frozen_w_float")

    def freeze(self, dtype: torch.dtype) -> None:
        """Hold the weights derived for activations of ``dtype`` as buffers,
        and the calibration state as it is, until ``thaw()``."""
        for name, t in zip(self._FROZEN, self._weights(dtype)):
            self.register_buffer(name, t, persistent=False)
        self._frozen = (dtype, self._calibrated())

    def thaw(self) -> None:
        for name in self._FROZEN:
            delattr(self, name)
        self._frozen = None

    def _weights(self, dtype: torch.dtype):
        if self._frozen is not None:
            if dtype != self._frozen[0]:
                raise ValueError(f"frozen for {self._frozen[0]} activations, got {dtype}")
            return tuple(getattr(self, name) for name in self._FROZEN)
        w = self.weight
        key = (w._version, w.data_ptr(), w.device, dtype)
        if self._derived is None or self._derived[0] != key:
            if w.dtype != torch.float32:
                raise ValueError("int8 layers quantize their float32 weight; convert "
                                 "the float32 model (before prepare_for_inference)")
            with torch.no_grad():
                w_q, w_scale = int8_conv.quantize_weight(w.detach())
                w_pack = int8_conv.pack_weight(w_q, self.groups)
                w_float = w.detach().to(dtype)
            self._derived = (key, w_q, w_pack, w_scale, w_float)
        return self._derived[1:]

    def _observe(self, x: torch.Tensor) -> None:
        if self.calibrating:
            with torch.no_grad():
                amax = x.detach().to(torch.float32).abs().amax()
                group = spatial.spatial_group()
                if group is not None:  # the frame's max, as JAX's over the global array
                    amax = all_reduce_max(group, amax)
                self.x_scale.copy_(torch.maximum(self.x_scale, amax / amax.new_tensor(127.0)))

    def _calibrated(self) -> bool:
        if self._frozen is not None:
            return self._frozen[1]
        xs = self.x_scale
        key = (xs._version, xs.data_ptr())
        if self._positive is None or self._positive[0] != key:
            self._positive = (key, bool(xs > 0))
        return self._positive[1]

    def _check_eval(self) -> None:
        if self.training:
            raise RuntimeError("int8 layers serve inference only (Int8Conv is not "
                               "differentiable); call model.eval()")


class Int8Conv2d(_Int8Layer, Conv2d):
    """A ``conv()`` layer in the int8 serving mode (``Int8Conv``).

    Built from the float ``Conv2d`` it replaces, sharing its parameters. An
    input of more than ``max_hw`` pixels serves the float conv and records no
    scale (full-resolution layers stay float, :826-847). Otherwise the batch
    gate and the calibration decide: the int8 conv of ``ops/int8_conv.py``, or
    the float conv with the weight in the activations' dtype, which is the
    float model's conv bit for bit.

    Split by rows, the gate reads the frame's pixels, not the shard's, and
    either branch runs on the shard with its halo (``window_rows``), the int8
    kernel unpadded in height and padded in width.
    """

    def __init__(self, conv: Conv2d, min_batch: int = 8, max_hw: int = 100_000):
        super().__init__(conv.in_channels, conv.out_channels, conv.kernel_size,
                         stride=conv.stride, padding=conv.padding,
                         dilation=conv.dilation, groups=conv.groups,
                         bias=conv.bias is not None, device="meta")
        self.weight = conv.weight
        self.bias = conv.bias
        self._init_int8(min_batch, max_hw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check_eval()
        n, _, h, w = x.shape
        w_q, w_pack, w_scale, w_float = self._weights(x.dtype)
        bias = self.bias
        if spatial.frame_rows(h) * w <= self.max_hw:
            self._observe(x)
            if int8_batch_ok(n, self.min_batch) and self._calibrated():
                pad_h, pad_w = self.padding
                if spatial.spatial_group() is not None:
                    x, pad_h = self._window(x), 0
                return int8_conv.int8_conv2d(
                    x, w_q, w_pack, w_scale, self.x_scale,
                    None if bias is None else bias.to(torch.float32), self.stride[0],
                    (pad_h, pad_w), self.dilation[0])
        return self._conv(x, w_float, None if bias is None else bias.to(x.dtype))


class Int8GroupedConv(_Int8Layer, GroupedConv):
    """A ``GroupedConv`` in the int8 serving mode (``GroupedConvDense``'s
    int8 arm, :485-553).

    It quantizes only where JAX's inference dispatch takes the dense
    block-diagonal form, ``not (cpg >= 4 and N*H*W*cpg >= 400_000)`` (:458-484),
    and the batch gate passes; the scale is recorded in either case. Otherwise
    it serves the float grouped conv. ``epilogue`` (bn3's affine + act) rides
    the int8 kernel's epilogue, after the dequantisation, as it rides the float
    kernel's. Split by rows, H in the volume is the frame's; the int8 kernel
    runs on the shard plus d rows a side, unpadded in height, and the float
    branch as ``GroupedConv`` runs it.
    """

    MIN_CPG_NATIVE = 4         # GroupedConvDense.min_cpg_native
    MIN_WORK_NATIVE = 400_000  # GroupedConvDense.min_work_native (N*H*W*cpg)

    def __init__(self, conv: GroupedConv, min_batch: int = 8, max_hw: int = 100_000):
        super().__init__(conv.weight.shape[0], conv.groups, conv.dilation)
        self.weight = conv.weight
        self._init_int8(min_batch, max_hw)

    def quantizes(self, n, h: int, w: int) -> bool:
        """Whether a calibrated layer serves int8 at input (n, h, w), h the
        frame's rows. A symbolic batch counts as 8 frames in the volume rule,
        as JAX's dispatch counts an exported artifact's (:458-463)."""
        cpg = self.weight.shape[1]
        volume = (8 if isinstance(n, torch.SymInt) else n) * h * w * cpg
        native = cpg >= self.MIN_CPG_NATIVE and volume >= self.MIN_WORK_NATIVE
        return not native and int8_batch_ok(n, self.min_batch)

    def forward(self, x: torch.Tensor, epilogue=None) -> torch.Tensor:
        self._check_eval()
        n, _, h, w = x.shape
        self._observe(x)
        w_q, w_pack, w_scale, w_float = self._weights(x.dtype)
        d = self.dilation
        if self.quantizes(n, spatial.frame_rows(h), w) and self._calibrated():
            ep = None if epilogue is None else (
                epilogue[0], epilogue[1], epilogue[2].activation, epilogue[2].leaky_slope)
            pad_h = d
            if spatial.spatial_group() is not None:
                x, pad_h = spatial.window_rows(x, 3, 1, d, d), 0
                spatial.EXCHANGE["rows"] += h
            return int8_conv.int8_conv2d(x, w_q, w_pack, w_scale, self.x_scale, None, 1,
                                         (pad_h, d), d, self.groups, ep)
        return self._forward(x, w_float, epilogue)


def conv(in_channels: int, features: int, kernel: int, stride: int = 1,
         dilation: int = 1, groups: int = 1, padding: Optional[int] = None,
         use_bias: bool = False) -> nn.Module:
    """2D conv with the JAX package's defaults (padding = dilation for 3x3,
    0 for 1x1). A grouped 3x3 stride-1 conv is a ``GroupedConv``. A dense one
    is a ``Conv2d`` marked ``int8_ok``: ``ops/quant.py::convert_int8`` swaps
    exactly these (and every ``GroupedConv``) for their int8 counterparts."""
    if padding is None:
        padding = dilation if kernel == 3 else 0
    if groups > 1:
        if (kernel, stride, padding, use_bias) != (3, 1, dilation, False) \
                or in_channels != features:
            raise NotImplementedError(
                "only the grouped 3x3 stride-1 'same' conv is ported")
        return GroupedConv(features, groups, dilation)
    c = Conv2d(in_channels, features, kernel, stride=stride, padding=padding,
               dilation=dilation, bias=use_bias)
    c.int8_ok = True  # JAX routes conv()'s dense convs to Int8Conv (:927-933)
    return c


def deconv(in_channels: int, features: int, kernel: int, stride: int,
           padding: int, use_bias: bool = False) -> nn.ConvTranspose2d:
    """``ConvTranspose2d(k, s, p)``: the (4,2,1) and (8,4,2) decoder geometries."""
    return ConvTranspose2d(in_channels, features, kernel, stride=stride,
                           padding=padding, bias=use_bias)


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """``nn.MaxPool2d(3, stride=2, padding=1)``. Split by rows, a shard's
    halo holds its neighbours' rows (the input, InitBlock's conv3 output, is
    not activated: it may be negative) and -inf beyond the frame only."""
    if spatial.spatial_group() is None:
        return F.max_pool2d(x, 3, stride=2, padding=1)
    xe = spatial.window_rows(x, 3, 2, 1, fill=float("-inf"))
    return F.max_pool2d(xe, 3, stride=2, padding=(0, 1))


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """``F.max_pool2d(2, 2)``. Split by rows each shard pools its own rows,
    which must be even: no window then straddles two shards."""
    if spatial.spatial_group() is not None and x.shape[2] % 2:
        raise ValueError(f"a 2x2 max pool does not split shards of {x.shape[2]} rows")
    return F.max_pool2d(x, 2, 2)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Mean over H, W, kept as 1x1 (split by rows: over the whole frame)."""
    if spatial.spatial_group() is not None:
        return spatial.global_mean(x)
    return x.mean(dim=(2, 3), keepdim=True)


def adaptive_avg_pool(x: torch.Tensor, out_hw: Tuple[int, int],
                      frame: bool = False) -> torch.Tensor:
    """``F.adaptive_avg_pool2d``: bins ``[floor(i*H/out), ceil((i+1)*H/out))``,
    the arithmetic the JAX version reproduces (layers.py:1165).

    Split by rows: ``frame=True`` pools the whole frame to ``out_hw``, the
    result the same on every process (PSPNet's pyramid,
    ``spatial.frame_pool``); otherwise the pool is the shard's own, served
    for a factor of 1 or 2 in height (bins within a shard)."""
    if spatial.spatial_group() is not None and frame:
        return spatial.frame_pool(x, out_hw)
    if tuple(x.shape[2:]) == tuple(out_hw):
        return x
    if x.shape[2] not in (out_hw[0], 2 * out_hw[0]):
        spatial.refuse(f"an adaptive pool of {x.shape[2]} rows to {out_hw[0]}",
                       "its bins straddle the shards (frame=True pools the whole frame)")
    return F.adaptive_avg_pool2d(x, out_hw)


class IdentityResidualBlock(nn.Module):
    """Pre-activation bottleneck block (segnet.py:44-124).

    ``channels`` = (c1, c2, c3): 1x1 → grouped 3x3 → 1x1. The projection
    shortcut consumes the normalised input, as in the reference. In eval
    mode with groups > 1, ``conv2 → bn3 (+act)`` is one fused grouped-conv
    launch, its affine taken from bn3's running statistics in f32; in train
    mode bn3 uses batch statistics and runs after the conv (layers.py:1310-1315).
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
        bn1 = self.bn1(x)
        shortcut = self.proj_conv(bn1) if self.need_proj else x
        out = self.bn2(self.conv1(bn1))
        if isinstance(self.conv2, GroupedConv) and not self.training:
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
    """Random weights from ``generator``: convolution and dense weights ~
    N(0, 1/fan_in) (flax's lecun_normal, untruncated), or N(0, init_std)
    where a conv sets it, biases 0, BN identity."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, GroupedConv, nn.Linear)):
                w = m.weight
                # flax's fan_in: the kernel's input channels (ConvTranspose
                # in (I, O, kh, kw) included) times its window
                fan_in = (w.shape[0] if isinstance(m, nn.ConvTranspose2d)
                          else w.shape[1]) * (1 if w.dim() == 2 else w.shape[2] * w.shape[3])
                draw = torch.randn(w.shape, generator=generator)
                std = getattr(m, "init_std", None)
                w.copy_(draw * std if std else draw / math.sqrt(fan_in))
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()


def _prepare(module: nn.Module, device: torch.device, cast_weights: bool,
             dtype: Optional[torch.dtype] = None) -> None:
    # bf16 activations on the card, as the JAX package computes in bf16 from
    # float32 parameters (trgb_segnet.py:17-18); float32 on the CPU; or the
    # caller's dtype (the MFNet harness runs float32 on the card)
    if dtype is None:
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    weight_dtype = dtype if cast_weights else torch.float32
    module.to(device)
    for m in module.modules():
        if isinstance(m, _Int8Layer):
            # the int8 layers keep the float32 weight they quantize
            if isinstance(m, nn.Conv2d):
                m.to(memory_format=torch.channels_last)
        elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            m.to(dtype=weight_dtype, memory_format=torch.channels_last)
        elif isinstance(m, (GroupedConv, nn.Linear)):
            m.to(dtype=weight_dtype)
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = dtype


def prepare_for_inference(module: nn.Module, device: torch.device,
                          dtype: Optional[torch.dtype] = None) -> nn.Module:
    """Eval mode on ``device``; convolution weights in the compute dtype.

    On the card the convolutions run in bf16 unless ``dtype`` says otherwise
    (here the weights are cast once, so the per-call cast is free) and BN
    stays float32. Dense convolution weights move to channels_last, the
    activations' layout, so cuDNN does not relayout them per call; the
    grouped conv's weight stays contiguous, as its kernel reads it.
    """
    module.eval()
    _prepare(module, device, cast_weights=True, dtype=dtype)
    return module


def prepare_for_training(module: nn.Module, device: torch.device,
                         dtype: Optional[torch.dtype] = None) -> nn.Module:
    """Train mode on ``device``; every parameter stays float32.

    The activations are bf16 on the card (or ``dtype``), each convolution
    casting its float32 weight per call; gradients and optimizer state are
    float32. Dense convolution weights move to channels_last as for
    inference.
    """
    module.train()
    _prepare(module, device, cast_weights=False, dtype=dtype)
    return module
