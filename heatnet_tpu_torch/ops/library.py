"""The port's CUDA kernels as PyTorch custom ops, so that ``torch.export``
traces them.

A wrapper launches its kernel through ctypes on ``data_ptr()``, which a
fake tensor does not have, so no trace can follow it. Here each kernel is
a ``torch.library.custom_op`` with a fake implementation, and a wrapper
that is traced (``kernels/build.py::tracing``) calls its op instead:

- ``heatnet::ingest`` (``csrc/ingest.cu``, ``ops/fused_preproc.py``): uint8
  RGB and/or uint16 IR through a column window to the early-fusion tensor,
  or to RGB, IR or both; a list of one or two tensors;
- ``heatnet::grouped_conv3x3`` and ``heatnet::grouped_conv3x3_fused``
  (``csrc/grouped_conv3x3.cu``, ``ops/grouped_conv.py``): the forward,
  without and with the BN affine + activation epilogue. Training keeps
  ``GroupedConv3x3Function``;
- ``heatnet::int8_conv`` (``csrc/int8_conv.cu``, ``ops/int8_conv.py``).

Each op's CUDA implementation is the wrapper's launch, which raises if the
kernel does not build or launch and counts each launch where the wrapper
counts it (``Kernel.launches``), so a traced program's launches are counted
too. Its CPU implementation is the plain version. Its fake gives the
output's shape, dtype and strides from the inputs alone.

Eager calls keep the direct wrappers: a batch-1 forward is bound by host
time, and on an H100 80GB HBM3 at 700 W the dispatcher costs 17 µs more
host time per fused grouped-conv call than the direct wrapper
(``tools/host_time.py``, PERF.md). Importing ``heatnet_tpu_torch.ops``
registers the ops: that, and ``torch``, is all a process needs to load and
serve an exported program (``io/export.py``).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from . import fused_preproc as fp
from . import grouped_conv as gc
from . import int8_conv as i8

Tensor = torch.Tensor


# ingest ----------------------------------------------------------------------

def _listed(out, cat: bool) -> List[Tensor]:
    return [out] if cat else [t for t in out if t is not None]


@torch.library.custom_op("heatnet::ingest", mutates_args=(), device_types="cpu")
def ingest(rgb: Optional[Tensor], ir: Optional[Tensor], col_lo: int, col_hi: int,
           out_dtype: torch.dtype, cat: bool) -> List[Tensor]:
    fp._check(rgb, ir, col_lo, col_hi, out_dtype)
    return _listed(fp.ingest_plain(rgb, ir, col_lo, col_hi, out_dtype, cat), cat)


@ingest.register_kernel("cuda")
def _ingest_cuda(rgb, ir, col_lo, col_hi, out_dtype, cat):
    fp._check(rgb, ir, col_lo, col_hi, out_dtype)
    return _listed(fp.ingest_cuda(rgb, ir, col_lo, col_hi, out_dtype, cat), cat)


@ingest.register_fake
def _ingest_fake(rgb, ir, col_lo, col_hi, out_dtype, cat):
    ref = rgb if rgb is not None else ir
    lead = tuple(ref.shape[:-2]) + (col_hi - col_lo,)

    def empty(c):
        return ref.new_empty(lead + (c,), dtype=out_dtype)

    if cat:
        return [empty(4)]
    return [empty(c) for t, c in ((rgb, 3), (ir, 1)) if t is not None]


# the grouped 3x3 conv ---------------------------------------------------------

@torch.library.custom_op("heatnet::grouped_conv3x3", mutates_args=(), device_types="cpu")
def grouped_conv3x3(x: Tensor, w: Tensor, groups: int, dilation: int) -> Tensor:
    gc.check_operands(x, w, groups, dilation, None, None, "none")
    return gc.grouped_conv3x3_plain(x, w, groups, dilation)


@grouped_conv3x3.register_kernel("cuda")
def _grouped_conv3x3_cuda(x, w, groups, dilation):
    gc.check_operands(x, w, groups, dilation, None, None, "none")
    return gc.launch(x, w, groups, dilation, None, None, "none", 0.0, gc.GROUPED_CONV3X3)


@grouped_conv3x3.register_fake
def _grouped_conv3x3_fake(x, w, groups, dilation):
    return torch.empty_like(x)


@torch.library.custom_op("heatnet::grouped_conv3x3_fused", mutates_args=(),
                         device_types="cpu")
def grouped_conv3x3_fused(x: Tensor, w: Tensor, scale: Tensor, bias: Tensor, groups: int,
                          dilation: int, act: str, slope: float) -> Tensor:
    gc.check_operands(x, w, groups, dilation, scale, bias, act)
    return gc.grouped_conv3x3_plain(x, w, groups, dilation, scale, bias, act, slope)


@grouped_conv3x3_fused.register_kernel("cuda")
def _grouped_conv3x3_fused_cuda(x, w, scale, bias, groups, dilation, act, slope):
    gc.check_operands(x, w, groups, dilation, scale, bias, act)
    return gc.launch(x, w, groups, dilation, scale, bias, act, slope,
                     gc.GROUPED_CONV3X3_FUSED)


@grouped_conv3x3_fused.register_fake
def _grouped_conv3x3_fused_fake(x, w, scale, bias, groups, dilation, act, slope):
    return torch.empty_like(x)


# the int8 conv ----------------------------------------------------------------

def _epilogue(ep_scale, ep_bias, act, slope):
    return None if ep_scale is None else (ep_scale, ep_bias, act, slope)


@torch.library.custom_op("heatnet::int8_conv", mutates_args=(), device_types="cpu")
def int8_conv(x: Tensor, w_q: Tensor, w_pack: Tensor, w_scale: Tensor, x_scale: Tensor,
              bias: Optional[Tensor], stride: int, padding: int, dilation: int,
              groups: int, ep_scale: Optional[Tensor], ep_bias: Optional[Tensor],
              act: str, slope: float) -> Tensor:
    ep = _epilogue(ep_scale, ep_bias, act, slope)
    i8.check_operands(x, w_q, groups, ep)
    y = i8.int8_conv2d_plain(x, w_q, w_scale, x_scale, bias, stride, padding, dilation,
                             groups, ep)
    # the fake's strides, also where a size-1 dimension leaves them open
    return torch.empty(y.shape, dtype=y.dtype,
                       memory_format=torch.channels_last).copy_(y)


@int8_conv.register_kernel("cuda")
def _int8_conv_cuda(x, w_q, w_pack, w_scale, x_scale, bias, stride, padding, dilation,
                    groups, ep_scale, ep_bias, act, slope):
    ep = _epilogue(ep_scale, ep_bias, act, slope)
    i8.check_operands(x, w_q, groups, ep)
    return i8.int8_conv2d_cuda(x, w_pack, w_scale, x_scale, bias, stride, padding,
                               dilation, groups, ep, w_q.shape)


@int8_conv.register_fake
def _int8_conv_fake(x, w_q, w_pack, w_scale, x_scale, bias, stride, padding, dilation,
                    groups, ep_scale, ep_bias, act, slope):
    o, _, kh, kw = w_q.shape
    n, _, h, w = x.shape
    ho, wo = i8.output_hw(h, w, kh, kw, stride, padding, dilation)
    return torch.empty((n, o, ho, wo), dtype=x.dtype, device=x.device,
                       memory_format=torch.channels_last)
