"""Grouped 3x3 stride-1 'same' conv, with an optional fused BN affine + act.

Counterpart of ``heatnet_tpu/ops/pallas_grouped_conv.py``:

- ``grouped_conv3x3(x, w, groups, dilation)`` ↔ ``grouped_conv3x3_blockdiag``
- ``grouped_conv3x3_fused(x, w, scale, bias, groups, dilation, act, slope)``
  ↔ ``grouped_conv3x3_fused``: ``act(conv(x, w) * scale + bias)`` with the
  epilogue on the f32 sum before the one rounding to the output dtype.

``x`` is NHWC, ``w`` PyTorch's grouped layout ``(C, C/groups, 3, 3)`` (the
JAX kernel ``(3, 3, C/groups, C)`` transposed), output channels == C.

Dispatch: a CUDA tensor launches ``csrc/grouped_conv3x3.cu`` (bf16, C a
multiple of 32, 2/4/8/16 channels per group, any dilation) or raises; a CPU
tensor runs ``grouped_conv3x3_plain``, the 9-tap shifted-slice sum in f32,
which relies on no library convolution.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels.build import Kernel

_P = ctypes.c_void_p
_I = ctypes.c_int
GROUPED_CONV3X3 = Kernel("grouped_conv3x3", "hn_grouped_conv3x3", [
    _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P])

ACTS = {"none": 0, "relu": 1, "leaky_relu": 2, "elu": 3}
_KERNEL_CPG = (2, 4, 8, 16)


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
    """Plain version: nine shifted slices, each a per-group matmul, summed in f32."""
    n, h, wd, c = x.shape
    cpg = c // groups
    d = dilation
    xp = F.pad(x.to(torch.float32), (0, 0, d, d, d, d))
    xp = xp.view(n, h + 2 * d, wd + 2 * d, groups, cpg)
    wf = w.to(torch.float32).view(groups, c // groups, cpg, 3, 3)
    acc = torch.zeros((n, h, wd, groups, c // groups), dtype=torch.float32,
                      device=x.device)
    for ky in range(3):
        for kx in range(3):
            xs = xp[:, ky * d:ky * d + h, kx * d:kx * d + wd]
            acc += torch.einsum("nhwgi,goi->nhwgo", xs, wf[..., ky, kx])
    y = acc.view(n, h, wd, c)
    if scale is not None:
        y = y * scale.to(torch.float32) + bias.to(torch.float32)
    return apply_act(y, act, slope).to(x.dtype)


def _conv(x, w, groups, dilation, scale, bias, act, slope):
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
    if x.device.type == "cpu":
        return grouped_conv3x3_plain(x, w, groups, dilation, scale, bias,
                                     act, slope)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")

    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"the CUDA kernel takes bf16 x and w, got {x.dtype}, {w.dtype}")
    if cpg not in _KERNEL_CPG or c % 32 != 0:
        raise ValueError(f"the CUDA kernel takes C % 32 == 0 and channels per "
                         f"group in {_KERNEL_CPG}, got C={c}, cpg={cpg}")
    if not (x.is_contiguous() and w.is_contiguous()) or x.data_ptr() % 16:
        raise ValueError("x (NHWC) and w must be contiguous, x 16-byte aligned")
    if w.device != x.device:
        raise ValueError("w must be on x's device")
    if scale is not None and not (scale.dtype == bias.dtype == torch.float32
                                  and scale.is_contiguous() and bias.is_contiguous()):
        raise ValueError("scale and bias must be contiguous float32")

    n, h, wd, _ = x.shape
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        GROUPED_CONV3X3.launch(
            x.data_ptr(), w.data_ptr(),
            None if scale is None else scale.data_ptr(),
            None if bias is None else bias.data_ptr(),
            out.data_ptr(), n, h, wd, c, cpg, dilation, ACTS[act], float(slope),
            stream)
    return out


def grouped_conv3x3(x: torch.Tensor, w: torch.Tensor, groups: int,
                    dilation: int = 1) -> torch.Tensor:
    """Grouped 3x3 stride-1 conv, padding = dilation, NHWC in and out."""
    return _conv(x, w, groups, dilation, None, None, "none", 0.0)


def grouped_conv3x3_fused(x: torch.Tensor, w: torch.Tensor,
                          scale: torch.Tensor, bias: torch.Tensor, groups: int,
                          dilation: int = 1, act: str = "relu",
                          slope: float = 0.01) -> torch.Tensor:
    """``act(grouped_conv3x3(x, w) * scale + bias)``, the epilogue in f32."""
    return _conv(x, w, groups, dilation, scale, bias, act, slope)
