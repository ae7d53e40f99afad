"""Fused ingest: raw sensor frames → normalised network input in one pass.

Counterpart of ``heatnet_tpu/ops/pallas_preproc.py``. One CUDA kernel
(``csrc/ingest.cu``) serves all four entry points: it reads uint8 RGB and/or
uint16 IR through a column window and writes RGB, IR, both, or the
4-channel early-fusion tensor ``cat([rgb_n, ir_n], -1)`` that
``ResNeXtSeg`` would otherwise assemble (``trgb_segnet.py:215-219``).

Layout is NHWC in and out. The window is on axis -2 (columns): the pack
path serves ``(0, W)`` and full 960-wide frames ``(148, 852)``.

Dispatch: a CUDA tensor launches the kernel (or raises), a CPU tensor runs
the plain PyTorch version below, which repeats the kernel's arithmetic.
Traced (``torch.export``), the wrappers call ``heatnet::ingest``
(``ops/library.py``), whose implementations are ``ingest_cuda`` and
``ingest_plain``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..kernels.build import Kernel, tracing
from .preprocess import ir_normalize, normalize

_P = ctypes.c_void_p
INGEST = Kernel("ingest", "hn_ingest", [
    _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, _P])

_OUT_DTYPES = (torch.bfloat16, torch.float32)


def rgb_plain(rgb: torch.Tensor) -> torch.Tensor:
    """uint8 → float32 in [-1, 1], as ``_rgb_kernel`` (pallas_preproc.py:68-70)."""
    x = rgb.to(torch.float32) * (1.0 / 255.0)
    return (x - 0.5) / 0.5


def ir_plain(ir: torch.Tensor) -> torch.Tensor:
    """uint16 → float32 in [-1, 1], as ``_ir_kernel`` (pallas_preproc.py:60-65)."""
    return normalize(ir_normalize(ir), mean=(0.5,), std=(0.5,))


def _check(rgb: Optional[torch.Tensor], ir: Optional[torch.Tensor],
           col_lo: int, col_hi: int, out_dtype) -> torch.Tensor:
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"out_dtype must be one of {_OUT_DTYPES}, got {out_dtype}")
    ref = rgb if rgb is not None else ir
    for t, dtype, c, name in ((rgb, torch.uint8, 3, "rgb"),
                              (ir, torch.uint16, 1, "ir")):
        if t is None:
            continue
        if t.dtype != dtype or t.dim() < 3 or t.shape[-1] != c:
            raise ValueError(f"{name} must be {dtype} (..., W, {c}), got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.shape[:-1] != ref.shape[:-1] or t.device != ref.device:
            raise ValueError("rgb and ir must share shape (..., W) and device")
    if not 0 <= col_lo < col_hi <= ref.shape[-2]:
        raise ValueError(f"window {col_lo}:{col_hi} outside width {ref.shape[-2]}")
    return ref


def ingest_plain(rgb: Optional[torch.Tensor], ir: Optional[torch.Tensor],
                 col_lo: int, col_hi: int, out_dtype, cat: bool):
    """Plain version of the kernel: (rgb_n or None, ir_n or None), or the
    fused tensor when ``cat``."""
    rgb_n = (None if rgb is None
             else rgb_plain(rgb[..., col_lo:col_hi, :]).to(out_dtype))
    ir_n = (None if ir is None
            else ir_plain(ir[..., col_lo:col_hi, :]).to(out_dtype))
    return torch.cat([rgb_n, ir_n], -1) if cat else (rgb_n, ir_n)


def ingest_cuda(rgb: Optional[torch.Tensor], ir: Optional[torch.Tensor],
                col_lo: int, col_hi: int, out_dtype, cat: bool):
    """One launch of ``csrc/ingest.cu``; the results of ``ingest_plain``."""
    ref = rgb if rgb is not None else ir
    lead = tuple(ref.shape[:-2])
    w_out = col_hi - col_lo

    def empty(c):
        return torch.empty(lead + (w_out, c), dtype=out_dtype, device=ref.device)

    out_cat = empty(4) if cat else None
    out_rgb = empty(3) if rgb is not None and not cat else None
    out_ir = empty(1) if ir is not None and not cat else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    rows = ref.numel() // (ref.shape[-2] * ref.shape[-1])
    with torch.cuda.device(ref.device):
        stream = torch.cuda.current_stream(ref.device).cuda_stream
        INGEST.launch(ptr(rgb), ptr(ir), ptr(out_rgb), ptr(out_ir), ptr(out_cat),
                      int(out_dtype == torch.bfloat16), rows, ref.shape[-2],
                      col_lo, col_hi, stream)
    return out_cat if cat else (out_rgb, out_ir)


def _ingest(rgb: Optional[torch.Tensor], ir: Optional[torch.Tensor],
            col_lo: int, col_hi: int, out_dtype, cat: bool):
    """(rgb_n or None, ir_n or None), or the fused tensor when ``cat``."""
    if tracing(rgb if rgb is not None else ir):
        outs = list(torch.ops.heatnet.ingest(rgb, ir, col_lo, col_hi, out_dtype, cat))
        if cat:
            return outs[0]
        return (outs.pop(0) if rgb is not None else None,
                outs.pop(0) if ir is not None else None)
    ref = _check(rgb, ir, col_lo, col_hi, out_dtype)
    if ref.device.type == "cpu":
        return ingest_plain(rgb, ir, col_lo, col_hi, out_dtype, cat)
    if ref.device.type != "cuda":
        raise ValueError(f"unsupported device {ref.device}")
    return ingest_cuda(rgb, ir, col_lo, col_hi, out_dtype, cat)


def rgb_normalize_fused(rgb_u8: torch.Tensor,
                        out_dtype=torch.bfloat16) -> torch.Tensor:
    """uint8 RGB (..., W, 3) → out_dtype in [-1, 1], one pass."""
    return _ingest(rgb_u8, None, 0, rgb_u8.shape[-2], out_dtype, cat=False)[0]


def ir_normalize_fused(ir_u16: torch.Tensor,
                       out_dtype=torch.bfloat16) -> torch.Tensor:
    """uint16 thermal (..., W, 1) → out_dtype in [-1, 1], one pass."""
    return _ingest(None, ir_u16, 0, ir_u16.shape[-2], out_dtype, cat=False)[1]


def inference_preprocess_fused(rgb_u8: torch.Tensor, ir_u16: torch.Tensor,
                               col_lo: int = 148, col_hi: int = 852,
                               out_dtype=torch.bfloat16
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalise both modalities of columns col_lo:col_hi in one launch.

    Same result as ``pallas_preproc.inference_preprocess_fused`` (normalise
    the full frame, then slice), without reading the columns it drops.
    """
    return _ingest(rgb_u8, ir_u16, col_lo, col_hi, out_dtype, cat=False)


def early_fusion_input(rgb_u8: torch.Tensor, ir_u16: torch.Tensor,
                       col_lo: int, col_hi: int,
                       out_dtype=torch.bfloat16) -> torch.Tensor:
    """``cat([rgb_n, ir_n], -1)`` of columns col_lo:col_hi, (..., w, 4)."""
    return _ingest(rgb_u8, ir_u16, col_lo, col_hi, out_dtype, cat=True)
