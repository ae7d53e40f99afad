"""Grouped 3x3 stride-1 'same' conv, with an optional fused BN affine + act.

Counterpart of ``heatnet_tpu/ops/pallas_grouped_conv.py``:

- ``grouped_conv3x3(x, w, groups, dilation)`` ↔ ``grouped_conv3x3_blockdiag``
- ``grouped_conv3x3_fused(x, w, scale, bias, groups, dilation, act, slope)``
  ↔ ``grouped_conv3x3_fused``: ``act(conv(x, w) * scale + bias)`` with the
  epilogue on the f32 sum before the one rounding to the output dtype.
- ``differentiable_grouped_conv3x3(x, w, groups, dilation)`` ↔ the
  ``grouped_conv3x3`` custom VJP (:297-322), through
  ``GroupedConv3x3Function``: the forward and the input gradient run the
  same kernel, the weight gradient is the library's (see the class).

``x`` is NHWC, ``w`` PyTorch's grouped layout ``(C, C/groups, 3, 3)`` (the
JAX kernel ``(3, 3, C/groups, C)`` transposed), output channels == C.

Dispatch: a CUDA tensor launches ``csrc/grouped_conv3x3.cu`` (bf16, C a
multiple of 64, 1/2/4/8/16 channels per group, dilation 1 to 8), which
multiplies the weight's 16x16 block-diagonal tiles (``pack_weight_tiles``
defines them) on tensor cores, or raises; a CPU tensor runs
``grouped_conv3x3_plain``, the 9-tap shifted-slice sum in f32, which relies
on no library convolution. Traced (``torch.export``), the forward and the
fused forward call ``heatnet::grouped_conv3x3`` and
``heatnet::grouped_conv3x3_fused`` (``ops/library.py``); training keeps
``GroupedConv3x3Function``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels.build import Kernel, tracing

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P]
# One C entry, three counts: the epilogue-free forward (training), the
# forward with the fused BN affine + act (serving, and the adversarial
# trainer's teacher), and the input gradient
GROUPED_CONV3X3 = Kernel("grouped_conv3x3", "hn_grouped_conv3x3", _ARGTYPES)
GROUPED_CONV3X3_FUSED = Kernel("grouped_conv3x3_fused", "hn_grouped_conv3x3", _ARGTYPES)
GROUPED_CONV3X3_DX = Kernel("grouped_conv3x3_dx", "hn_grouped_conv3x3", _ARGTYPES)

# Activation copies the Function makes to give the kernel contiguous NHWC
# (each is one read and one write of an activation), by tensor
layout_copies = {"x": 0, "dy": 0}

ACTS = {"none": 0, "relu": 1, "leaky_relu": 2, "elu": 3}
_KERNEL_CPG = (1, 2, 4, 8, 16)  # each divides the 16-channel tile
_KERNEL_CHANNELS = 64  # channels per block tile: C must be a multiple
_KERNEL_MAX_DILATION = 8
TILE = 16


def apply_act(y: torch.Tensor, act: str, slope: float) -> torch.Tensor:
    """The NormAct activations (the Pallas epilogue's ``_apply_act``)."""
    if act == "relu":
        return F.relu(y)
    if act == "leaky_relu":
        return F.leaky_relu(y, slope)
    if act == "elu":
        return F.elu(y)
    if act == "none":
        return y
    raise ValueError(f"unknown activation {act}")


def grouped_conv3x3_plain(x: torch.Tensor, w: torch.Tensor, groups: int,
                          dilation: int = 1,
                          scale: Optional[torch.Tensor] = None,
                          bias: Optional[torch.Tensor] = None,
                          act: str = "none", slope: float = 0.01) -> torch.Tensor:
    """Plain version: nine shifted slices, each a per-group matmul, summed in
    f32 (float64 operands in float64)."""
    n, h, wd, c = x.shape
    cpg = c // groups
    d = dilation
    acc_dtype = torch.promote_types(x.dtype, torch.float32)
    xp = F.pad(x.to(acc_dtype), (0, 0, d, d, d, d))
    xp = xp.view(n, h + 2 * d, wd + 2 * d, groups, cpg)
    wf = w.to(acc_dtype).view(groups, c // groups, cpg, 3, 3)
    acc = torch.zeros((n, h, wd, groups, c // groups), dtype=acc_dtype, device=x.device)
    for ky in range(3):
        for kx in range(3):
            xs = xp[:, ky * d:ky * d + h, kx * d:kx * d + wd]
            acc += torch.einsum("nhwgi,goi->nhwgo", xs, wf[..., ky, kx])
    y = acc.view(n, h, wd, c)
    if scale is not None:
        y = y * scale.to(acc_dtype) + bias.to(acc_dtype)
    return apply_act(y, act, slope).to(x.dtype)


def pack_weight_tiles(w: torch.Tensor, groups: int,
                      transpose_flip: bool = False) -> torch.Tensor:
    """PyTorch's ``(C, C/groups, 3, 3)`` weight as the kernel's bf16 tiles.

    Returns ``(9, C/16, 16, 16)``: ``tiles[t, j, co, ci]`` is the weight from
    input channel ``16j + ci`` to output channel ``16j + co`` at tap
    ``t = 3*ky + kx``, zero where the two channels lie in different groups.
    ``tiles[t, j].T`` is the diagonal 16x16 block ``j`` of the JAX
    ``_block_diag_taps`` (indexed ``[t, ci, co]``). ``ci`` is the inner axis
    because that is the order of mma's B operand (``.col``): a lane's
    register holds two consecutive ``ci`` of one ``co``.

    ``transpose_flip=True`` packs ``dx_weight(w)`` instead (each group's
    block transposed, the taps flipped), the weight of the input gradient,
    in the same gather.

    The CUDA kernel gathers these tiles itself, each warp its own B
    fragments straight from ``w``: a pack on the host added two PyTorch
    launches per call, and the host time they took held mod3's eager loop
    to 0.070 ms against 0.020 ms of card time (PERF.md). This function is
    their definition and plain version, held against JAX in the CPU tests.
    """
    c, cpg = w.shape[:2]
    if c % TILE or TILE % cpg or c // cpg != groups:
        raise ValueError(f"tiles need C % {TILE} == 0 and channels per group "
                         f"dividing {TILE}, got C={c}, groups={groups}")
    t = torch.arange(9, device=w.device).view(9, 1, 1, 1)
    j = torch.arange(c // TILE, device=w.device).view(1, -1, 1, 1)
    co = torch.arange(TILE, device=w.device).view(1, 1, TILE, 1)
    ci = torch.arange(TILE, device=w.device).view(1, 1, 1, TILE)
    if transpose_flip:
        src = ((TILE * j + ci) * cpg + co % cpg) * 9 + (8 - t)
    else:
        src = ((TILE * j + co) * cpg + ci % cpg) * 9 + t
    tiles = w.reshape(-1).to(torch.bfloat16)[src]
    return tiles.masked_fill_(co // cpg != ci // cpg, 0)


def check_operands(x, w, groups, dilation, scale, bias, act) -> None:
    """The operands' shapes and the epilogue, on any device."""
    if x.dim() != 4 or x.shape[-1] % groups != 0:
        raise ValueError(f"x must be NHWC with C divisible by groups={groups}, "
                         f"got {tuple(x.shape)}")
    c = x.shape[-1]
    cpg = c // groups
    if tuple(w.shape) != (c, cpg, 3, 3):
        raise ValueError(f"w must be {(c, cpg, 3, 3)}, got {tuple(w.shape)}")
    if dilation < 1:
        raise ValueError(f"dilation must be >= 1, got {dilation}")
    if (act not in ACTS or (scale is None) != (bias is None)
            or (scale is None and act != "none")):
        raise ValueError(f"bad epilogue act={act!r} (affine: {scale is not None})")
    for t, name in ((scale, "scale"), (bias, "bias")):
        if t is not None and (t.shape != (c,) or t.device != x.device):
            raise ValueError(f"{name} must be ({c},) on {x.device}")


def launch(x, w, groups, dilation, scale, bias, act, slope,
           kernel: Kernel = GROUPED_CONV3X3, transpose_flip: bool = False):
    """One launch of ``csrc/grouped_conv3x3.cu`` on checked operands; raises
    where the kernel does not take them."""
    c = x.shape[-1]
    cpg = c // groups
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"the CUDA kernel takes bf16 x and w, got {x.dtype}, {w.dtype}")
    if cpg not in _KERNEL_CPG or c % _KERNEL_CHANNELS != 0:
        raise ValueError(f"the CUDA kernel takes C % {_KERNEL_CHANNELS} == 0 and "
                         f"channels per group (cpg) in {_KERNEL_CPG}, got C={c}, "
                         f"cpg={cpg}")
    if dilation > _KERNEL_MAX_DILATION:
        raise ValueError(f"the CUDA kernel takes dilation <= {_KERNEL_MAX_DILATION}, "
                         f"got {dilation}")
    if not (x.is_contiguous() and w.is_contiguous()) or x.data_ptr() % 16:
        raise ValueError("x (NHWC) and w must be contiguous, x 16-byte aligned")
    if w.device != x.device:
        raise ValueError("w must be on x's device")
    if scale is not None and not (scale.dtype == bias.dtype == torch.float32
                                  and scale.is_contiguous() and bias.is_contiguous()):
        raise ValueError("scale and bias must be contiguous float32")

    n, h, wd, _ = x.shape
    out = torch.empty_like(x)
    args = (x.data_ptr(), w.data_ptr(), None if scale is None else scale.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(), n, h, wd, c,
            cpg, dilation, int(transpose_flip), ACTS[act], float(slope))
    dev = x.device.index
    stream = torch._C._cuda_getCurrentRawStream(dev)
    if dev == torch.cuda.current_device():  # the launch goes to the current device
        kernel.launch(*args, stream)
    else:
        with torch.cuda.device(dev):
            kernel.launch(*args, stream)
    return out


def _conv(x, w, groups, dilation, scale, bias, act, slope,
          kernel: Kernel = GROUPED_CONV3X3, transpose_flip: bool = False):
    check_operands(x, w, groups, dilation, scale, bias, act)
    if x.device.type == "cpu":
        return grouped_conv3x3_plain(
            x, dx_weight(w, groups) if transpose_flip else w, groups, dilation,
            scale, bias, act, slope)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return launch(x, w, groups, dilation, scale, bias, act, slope, kernel,
                  transpose_flip)


def grouped_conv3x3(x: torch.Tensor, w: torch.Tensor, groups: int,
                    dilation: int = 1) -> torch.Tensor:
    """Grouped 3x3 stride-1 conv, padding = dilation, NHWC in and out."""
    if tracing(x):
        return torch.ops.heatnet.grouped_conv3x3(x, w, groups, dilation)
    return _conv(x, w, groups, dilation, None, None, "none", 0.0)


def grouped_conv3x3_fused(x: torch.Tensor, w: torch.Tensor,
                          scale: torch.Tensor, bias: torch.Tensor, groups: int,
                          dilation: int = 1, act: str = "relu",
                          slope: float = 0.01) -> torch.Tensor:
    """``act(grouped_conv3x3(x, w) * scale + bias)``, the epilogue in f32."""
    if tracing(x):
        return torch.ops.heatnet.grouped_conv3x3_fused(x, w, scale, bias, groups,
                                                       dilation, act, float(slope))
    return _conv(x, w, groups, dilation, scale, bias, act, slope,
                 GROUPED_CONV3X3_FUSED)


def dx_weight(w: torch.Tensor, groups: int) -> torch.Tensor:
    """The weight whose grouped conv of ``dy`` is the input gradient.

    For a stride-1 conv with padding = dilation and C in == C out, the input
    gradient is the same grouped conv of ``dy`` with each group's
    ``(cpg_out, cpg_in)`` block transposed and the 3x3 taps flipped.
    """
    c, cpg = w.shape[:2]
    return (w.view(groups, cpg, cpg, 3, 3).transpose(1, 2).flip(3, 4)
            .reshape(c, cpg, 3, 3).contiguous())


def grouped_conv3x3_dx(dy: torch.Tensor, w: torch.Tensor, groups: int,
                       dilation: int = 1) -> torch.Tensor:
    """Input gradient of ``grouped_conv3x3``: the conv of ``dy`` with
    ``dx_weight(w)``. On the card the kernel gathers the transposed, flipped
    tiles from ``w`` itself (no copy of the weight); on the CPU the plain
    version runs with ``dx_weight(w)``."""
    return _conv(dy, w, groups, dilation, None, None, "none", 0.0,
                 GROUPED_CONV3X3_DX, transpose_flip=True)


def grouped_conv3x3_weight_grad_plain(x: torch.Tensor, dy: torch.Tensor,
                                      groups: int, dilation: int = 1
                                      ) -> torch.Tensor:
    """Plain weight gradient, f32 ``(C, C/groups, 3, 3)`` (float64 for
    float64 operands): per tap, the per-group product of the shifted input
    slice with ``dy``, summed over batch and pixels."""
    n, h, wd, c = x.shape
    cpg = c // groups
    d = dilation
    acc_dtype = torch.promote_types(x.dtype, torch.float32)
    xp = F.pad(x.to(acc_dtype), (0, 0, d, d, d, d))
    xp = xp.view(n, h + 2 * d, wd + 2 * d, groups, cpg)
    g = dy.to(acc_dtype).view(n, h, wd, groups, cpg)
    dk = torch.empty((groups, cpg, cpg, 3, 3), dtype=acc_dtype, device=x.device)
    for ky in range(3):
        for kx in range(3):
            xs = xp[:, ky * d:ky * d + h, kx * d:kx * d + wd]
            dk[..., ky, kx] = torch.einsum("nhwgi,nhwgo->goi", xs, g)
    return dk.view(c, cpg, 3, 3)


def grouped_conv3x3_weight_grad(x: torch.Tensor, dy: torch.Tensor,
                                groups: int, dilation: int = 1) -> torch.Tensor:
    """Weight gradient of ``grouped_conv3x3``, NHWC ``x`` and ``dy``.

    No TPU kernel computes it (the JAX backward is XLA's autodiff of
    ``_dense_reference``), so on the card it is the library's weight
    gradient, cuDNN's, which sums in f32 and returns the inputs' dtype.
    """
    if x.device.type == "cpu":
        return grouped_conv3x3_weight_grad_plain(x, dy, groups, dilation)
    c = x.shape[-1]
    return torch.nn.grad.conv2d_weight(
        x.permute(0, 3, 1, 2), (c, c // groups, 3, 3), dy.permute(0, 3, 1, 2),
        padding=dilation, dilation=dilation, groups=groups)


def _contiguous(t: torch.Tensor, name: str) -> torch.Tensor:
    if t.is_contiguous():
        return t
    layout_copies[name] += 1
    return t.contiguous()


class GroupedConv3x3Function(torch.autograd.Function):
    """Differentiable grouped 3x3 conv (the ``grouped_conv3x3`` custom VJP).

    Forward: ``grouped_conv3x3`` of NHWC ``x`` with ``w`` cast to x's dtype
    (``kern.astype(dtype)``). Backward: dx is ``grouped_conv3x3_dx``, the
    same kernel on ``dy``; dk is ``grouped_conv3x3_weight_grad``, returned
    in ``w``'s dtype as ``_bwd`` returns ``dk.astype(kern.dtype)``. A tensor
    that reaches the kernel in another layout is copied to contiguous NHWC
    and counted in ``layout_copies``.
    """

    @staticmethod
    def forward(ctx, x, w, groups: int, dilation: int):
        x = _contiguous(x, "x")
        wc = w.to(x.dtype)
        ctx.save_for_backward(x, wc)
        ctx.groups, ctx.dilation, ctx.w_dtype = groups, dilation, w.dtype
        return grouped_conv3x3(x, wc, groups, dilation)

    @staticmethod
    def backward(ctx, dy):
        x, wc = ctx.saved_tensors
        dy = _contiguous(dy.to(x.dtype), "dy")
        dx = dk = None
        if ctx.needs_input_grad[0]:
            dx = grouped_conv3x3_dx(dy, wc, ctx.groups, ctx.dilation)
        if ctx.needs_input_grad[1]:
            dk = grouped_conv3x3_weight_grad(
                x, dy, ctx.groups, ctx.dilation).to(ctx.w_dtype)
        return dx, dk, None, None


def differentiable_grouped_conv3x3(x: torch.Tensor, w: torch.Tensor,
                                   groups: int, dilation: int = 1) -> torch.Tensor:
    """``grouped_conv3x3`` with gradients (``GroupedConv3x3Function``)."""
    return GroupedConv3x3Function.apply(x, w, groups, dilation)
