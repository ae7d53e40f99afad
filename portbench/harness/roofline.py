"""The yardstick's arithmetic: the card's peaks, kernel families, the
grouped conv's bound and the reference's operation counts.

Peaks: NVIDIA H100 SXM data sheet, dense, at the 700 W limit.

``family`` is a frozen copy of the kernel-name rules of the program's
``tools/profile_infer.py::_family``: a kernel keeps its family whatever
the program does to those rules later.

``bound_s`` is the least time of one launch: max(bytes / HBM bandwidth,
operations / peak), each input, weight and output byte counted once
(``PERF.md``, the kernels' table).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def family(name: str) -> str:
    n = name.lower()
    if "grouped_conv3x3" in n:
        return "grouped_conv3x3 (port)"
    if "int8_conv" in n:
        return "int8_conv (port)"
    if "ingest" in n:
        return "ingest (port)"
    if any(s in n for s in ("cudnn", "cutlass", "xmma", "implicit_gemm",
                            "nvjet", "gemm", "nhwcaddpadding", "conv")):
        return "cuDNN/cuBLAS conv"
    if "batch_norm" in n:
        return "batch norm"
    if "upsample" in n:
        return "bilinear resize"
    if "multi_tensor" in n:
        return "optimizer"
    if "memcpy" in n:
        return "host-device copy"
    if any(s in n for s in ("elementwise", "reduce")):
        return "elementwise / reduce"
    return "other"


def bound_s(bytes_moved: float, ops: float) -> float:
    return max(bytes_moved / PEAK_HBM_BYTES, ops / PEAK_BF16_FLOPS)


def grouped_conv_bound(n: int, c: int, h: int, w: int, groups: int,
                       epilogue: bool = False) -> float:
    """One launch of a grouped 3x3 conv (forward or dx: the same shapes), bf16:
    input and output N·H·W·C once, the weight C·(C/groups)·9 once, a fused
    epilogue's float32 scale and bias once; ops 2·N·H·W·C·(C/groups)·9."""
    cpg = c // groups
    byt = 2 * (2 * n * h * w * c + c * cpg * 9) + (8 * c if epilogue else 0)
    return bound_s(byt, 2.0 * n * h * w * c * cpg * 9)


class GroupedConvShapes:
    """Forward hooks that record every grouped conv's (N, C, H, W, groups)."""

    def __init__(self, module: torch.nn.Module):
        self.shapes: List[Tuple[int, int, int, int, int]] = []
        self._hooks = [m.register_forward_hook(self._hook) for m in module.modules()
                       if getattr(m, "groups", 1) > 1 and hasattr(m, "weight")]

    def _hook(self, m, args, out):
        n, c, h, w = args[0].shape
        self.shapes.append((n, c, h, w, m.groups))

    def remove(self):
        for h in self._hooks:
            h.remove()


def _conv_backward_flop(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding,
                        _dilation, transposed, _output_padding, _groups, output_mask,
                        out_shape=None, **kwargs) -> int:
    """A conv's input and weight gradients, each the forward's multiplies:
    2 · N · (output positions, or input positions of a transposed conv) ·
    the weight's elements. ``FlopCounterMode``'s own formula counts a grouped
    conv's weight gradient as if it were dense (``groups`` times too many)."""
    spatial = x_shape[2:] if transposed else grad_out_shape[2:]
    one = 2 * grad_out_shape[0] * math.prod(spatial) * math.prod(w_shape)
    return one * (int(bool(output_mask[0])) + int(bool(output_mask[1])))


def count_flops(fn) -> float:
    """FLOPs of ``fn()`` (convs and matmuls, forward and backward) by
    ``FlopCounterMode``, with ``_conv_backward_flop`` for conv gradients;
    run it on meta tensors to count without computing."""
    mapping = {torch.ops.aten.convolution_backward: _conv_backward_flop}
    with FlopCounterMode(display=False, custom_mapping=mapping) as fc:
        fn()
    return float(fc.get_total_flops())


def sum_bounds(shapes, epilogue: bool = False) -> float:
    return sum(grouped_conv_bound(n, c, h, w, g, epilogue) for n, c, h, w, g in shapes)

