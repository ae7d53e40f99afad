"""int8 convolution of the int8 serving mode: weight quantization, packing,
the CUDA kernel's wrapper and its plain version.

Counterpart of the int8 arithmetic of ``heatnet_tpu/models/layers.py``:
``Int8Conv`` (:760-894) and ``GroupedConvDense``'s int8 arm (:485-553).
There, XLA computes ``conv_general_dilated(int8, int8,
preferred_element_type=int32)`` (:531-538, :859-865); no PyTorch call
computes an int8 convolution on CUDA, so the port's is the hand-written
``csrc/int8_conv.cu``. Not a TPU kernel: no Pallas kernel is behind it.

The function (per-output-channel weight scales, a static per-tensor
activation scale from calibration, symmetric, no zero points):

- ``quantize_weight``: ``w_scale[o] = max(max|w[o]| / 127, 1e-12)`` in f32,
  ``w_q = clip(round(w / w_scale), -127, 127)``;
- the activation: ``x_q = clip(round(x_f32 / max(x_scale, 1e-12)), -127,
  127)``, a true division;
- ``y = T(sum) * T(x_scale * w_scale)`` in the model's dtype ``T`` (JAX
  casts the int32 sum before the multiply, :539-540, :866), then ``+ T(bias)``;
  with ``epilogue=(scale, bias, act)`` (bn3 after the grouped conv, as the
  port's fused grouped conv takes it) ``T(act(y_f32 * scale + bias))``.

JAX's banded dilated conv is bit-identical to the plain one on int8 operands
(int32 sums are exact, :606-607, :856-857), so the port computes the plain
dilated conv. A grouped conv's block-diagonal expansion has per-output-channel
scales equal to the grouped kernel's own, and its structural zeros add 0 to an
int32 sum: the kernel multiplies 64-channel diagonal blocks, the plain version
the groups themselves.

Dispatch: a bf16 CUDA tensor launches the kernel (the serving paths run
bf16 on the card), any other CUDA tensor raises; a CPU tensor, of any float
dtype, runs ``int8_conv2d_plain``, ``F.conv2d`` in float64 on the
integer-valued operands (exact, then ``.to(torch.int32)``). Layout: NCHW tensors as the port's modules
pass them (channels_last memory on the card); the kernel reads and writes
NHWC. Traced (``torch.export``), ``int8_conv2d`` calls ``heatnet::int8_conv``
(``ops/library.py``), whose implementations are ``int8_conv2d_cuda`` and
``int8_conv2d_plain``.

The kernel's layouts, kept here where the CPU tests reach them: its first
pass writes ``quantize_padded``'s int8 NHWC (each block's channels padded to
a multiple of ``CHAN_ALIGN``) into a scratch tensor this wrapper allocates;
its product reads ``pack_weight``'s ``(blocks, rows, kh*kw*cin_pad)`` in
``K_STEP``-wide steps, one tap's at a time where cin_pad is a multiple of
``K_STEP`` (else across taps), and skips, per tile of 128 or 256 output
pixels, the taps ``tile_taps`` rules out (across taps, whole kernel rows).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..kernels.build import Kernel, tracing
from .grouped_conv import ACTS, apply_act

_P = ctypes.c_void_p
_I = ctypes.c_int
INT8_CONV = Kernel("int8_conv", "hn_int8_conv",
                   [_P] * 9 + [_I] * 18 + [ctypes.c_float, _P])

BLOCK = 64        # a grouped conv's channel block in the kernel
CHAN_ALIGN = 32   # x_q's and the weight's channels per block and tap, padded
ROW_ALIGN = 64    # the weight's output channels per block, padded
K_STEP = 128      # the kernel's K step (bytes of a swizzled row)
TILE_M = (128, 256)  # output pixels per kernel tile (256 beside a 128-channel tile)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


Padding = Union[int, Tuple[int, int]]


def pad_hw(padding: Padding) -> Tuple[int, int]:
    """``padding`` as (height, width): an int pads both alike. Split by rows
    (``parallel/spatial.py``), a layer passes 0 in height and runs on its
    shard extended by the halo."""
    return (padding, padding) if isinstance(padding, int) else tuple(padding)


Epilogue = Optional[Tuple[torch.Tensor, torch.Tensor, str, float]]


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(O, I/g, kh, kw)`` float32 → (int8 ``w_q`` of the same shape, f32
    ``w_scale`` ``(O,)``), per output channel (layers.py:849-851)."""
    if w.dtype != torch.float32:
        raise ValueError(f"quantize the float32 weight, got {w.dtype}")
    w_scale = torch.clamp_min(w.abs().amax(dim=(1, 2, 3)) / 127.0, 1e-12)
    w_q = torch.clamp(torch.round(w / w_scale.view(-1, 1, 1, 1)), -127, 127)
    return w_q.to(torch.int8), w_scale


def pack_weight(w_q: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """``w_q`` ``(O, I/g, kh, kw)`` int8 → the kernel's ``(blocks, rows,
    kh*kw*cin_pad)``: K in (ky, kx, ci) order, each tap's channels
    zero-padded to ``cin_pad`` (a multiple of ``CHAN_ALIGN``, as
    ``quantize_padded``'s) and each block's output channels to ``rows`` (a
    multiple of ``ROW_ALIGN``).

    A dense conv is one block. A grouped conv is ``C / 64`` blocks of 64 input
    and 64 output channels, the weight block-diagonal within each (zero
    between groups)."""
    o, cpg, kh, kw = w_q.shape
    if groups == 1:
        blocks = w_q.permute(0, 2, 3, 1).unsqueeze(0)  # block, co, ky, kx, ci
    else:
        if o % BLOCK or BLOCK % cpg or o // cpg != groups:
            raise ValueError(f"grouped int8 conv needs C % {BLOCK} == 0 and channels "
                             f"per group dividing {BLOCK}, got C={o}, groups={groups}")
        nb = o // BLOCK
        blocks = torch.zeros((nb, BLOCK, kh, kw, BLOCK), dtype=torch.int8,
                             device=w_q.device)
        wv = w_q.view(nb, BLOCK // cpg, cpg, cpg, kh, kw)  # block, group, co, ci, ky, kx
        for gi in range(BLOCK // cpg):
            sl = slice(gi * cpg, (gi + 1) * cpg)
            blocks[:, sl, :, :, sl] = wv[:, gi].permute(0, 1, 3, 4, 2)
    nb, cout_g, _, _, cin_g = blocks.shape
    out = torch.zeros((nb, _round_up(cout_g, ROW_ALIGN), kh, kw,
                       _round_up(cin_g, CHAN_ALIGN)), dtype=torch.int8, device=w_q.device)
    out[:, :cout_g, :, :, :cin_g] = blocks
    return out.view(nb, out.shape[1], -1)


def quantize_padded(x: torch.Tensor, x_scale: torch.Tensor,
                    groups: int = 1) -> torch.Tensor:
    """The kernel's first pass, plainly: NCHW ``x`` → int8 NHWC ``x_q``
    (``quantize_input``), each block's channels (64 for a grouped conv, all
    of them for a dense one) zero-padded to a multiple of ``CHAN_ALIGN``."""
    n, c, h, w = x.shape
    cin_g = c if groups == 1 else BLOCK
    q = quantize_input(x, x_scale).to(torch.int8).permute(0, 2, 3, 1)
    out = torch.zeros((n, h, w, c // cin_g, _round_up(cin_g, CHAN_ALIGN)),
                      dtype=torch.int8, device=x.device)
    out[..., :cin_g] = q.reshape(n, h, w, c // cin_g, cin_g)
    return out.view(n, h, w, -1)


def tile_taps(m0: int, m: int, ho: int, wo: int, h: int, w: int, kh: int, kw: int,
              stride: int, padding: Padding, dilation: int,
              tile: int = TILE_M[0]) -> Tuple[range, range]:
    """The taps (ky, kx ranges) the kernel multiplies for the output pixels
    ``m0 .. m0+tile-1`` of ``m``: those that read inside the image for some
    pixel of the tile (``csrc/int8_conv.cu::tile_taps``). A tile within one
    output row bounds ox, within one image oy; one across images reads every
    row. A tap left out reads only zero padding for the whole tile."""
    last = min(m0 + tile, m) - 1
    i0, r0 = divmod(m0, ho * wo)
    i1, r1 = divmod(last, ho * wo)
    oy, ox = (0, ho - 1), (0, wo - 1)
    if i0 == i1:
        oy = (r0 // wo, r1 // wo)
        if oy[0] == oy[1]:
            ox = (r0 % wo, r1 % wo)

    def valid(lo_hi, k, size, pad):
        ok = [t for t in range(k) if lo_hi[1] * stride - pad + t * dilation >= 0
              and lo_hi[0] * stride - pad + t * dilation <= size - 1]
        return range(ok[0], ok[-1] + 1) if ok else range(0)

    pad_h, pad_w = pad_hw(padding)
    return valid(oy, kh, h, pad_h), valid(ox, kw, w, pad_w)


def quantize_input(x: torch.Tensor, x_scale: torch.Tensor) -> torch.Tensor:
    """``clip(round(x_f32 / max(x_scale, 1e-12)), -127, 127)`` as float32
    integer values (layers.py:862-863)."""
    xs = torch.clamp_min(x_scale.to(torch.float32), 1e-12)
    return torch.clamp(torch.round(x.to(torch.float32) / xs), -127, 127)


def int8_sums_plain(x: torch.Tensor, w_q: torch.Tensor, x_scale: torch.Tensor,
                    stride: int = 1, padding: Padding = 0, dilation: int = 1,
                    groups: int = 1) -> torch.Tensor:
    """The int32 sums of the int8 conv, NCHW: the quantized operands convolved
    in float64 (exact for int8 operands)."""
    xq = quantize_input(x, x_scale).to(torch.float64)
    return F.conv2d(xq, w_q.to(torch.float64), None, stride, pad_hw(padding), dilation,
                    groups).to(torch.int32)


def dequantize(acc: torch.Tensor, dtype: torch.dtype, w_scale: torch.Tensor,
               x_scale: torch.Tensor, bias: Optional[torch.Tensor] = None,
               epilogue: Epilogue = None) -> torch.Tensor:
    """NCHW int32 sums → ``dtype`` ``T``, rounding where the JAX layer does:
    ``T(sum) * T(x_scale * w_scale)``, ``+ T(bias)``, then the epilogue in
    f32 and one rounding. channels_last, as the kernel writes it."""
    s = (torch.clamp_min(x_scale.to(torch.float32), 1e-12) * w_scale).to(dtype)
    y = acc.to(dtype) * s.view(1, -1, 1, 1)
    if bias is not None:
        y = y + bias.to(dtype).view(1, -1, 1, 1)
    if epilogue is not None:
        scale, ebias, act, slope = epilogue
        y = apply_act(y.to(torch.float32) * scale.view(1, -1, 1, 1)
                      + ebias.view(1, -1, 1, 1), act, slope).to(dtype)
    return y.contiguous(memory_format=torch.channels_last)


def int8_conv2d_plain(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                      x_scale: torch.Tensor, bias: Optional[torch.Tensor] = None,
                      stride: int = 1, padding: Padding = 0, dilation: int = 1,
                      groups: int = 1, epilogue: Epilogue = None) -> torch.Tensor:
    """Plain version: ``int8_sums_plain``, then ``dequantize`` in x's dtype.
    The result is channels_last, as the kernel writes it (a float64
    convolution may return another layout)."""
    acc = int8_sums_plain(x, w_q, x_scale, stride, padding, dilation, groups)
    return dequantize(acc, x.dtype, w_scale, x_scale, bias, epilogue)


def check_operands(x: torch.Tensor, w_q: torch.Tensor, groups: int,
                   epilogue: Epilogue) -> None:
    """The operands' shapes and the epilogue's activation, on any device."""
    o, cpg = w_q.shape[:2]
    c = x.shape[1]
    if w_q.dtype != torch.int8 or c != cpg * groups or o % groups:
        raise ValueError(f"bad int8 conv operands: x {tuple(x.shape)}, w_q "
                         f"{tuple(w_q.shape)} {w_q.dtype}, groups {groups}")
    if epilogue is not None and epilogue[2] not in ACTS:
        raise ValueError(f"unknown activation {epilogue[2]}")


def int8_conv2d(x: torch.Tensor, w_q: torch.Tensor, w_pack: Optional[torch.Tensor],
                w_scale: torch.Tensor, x_scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None, stride: int = 1,
                padding: Padding = 0, dilation: int = 1, groups: int = 1,
                epilogue: Epilogue = None) -> torch.Tensor:
    """The int8 conv of NCHW ``x`` (bf16 on the card) with ``w_q``; ``w_pack`` is
    ``pack_weight(w_q, groups)``, which the kernel reads; ``padding`` an int
    or (height, width). Returns NCHW in x's dtype (channels_last memory from
    the kernel)."""
    if tracing(x):
        pad_h, pad_w = pad_hw(padding)
        if pad_h != pad_w:
            raise NotImplementedError("a traced int8 conv pads height and width alike")
        ep_scale, ep_bias, act, slope = epilogue if epilogue is not None else \
            (None, None, "none", 0.0)
        return torch.ops.heatnet.int8_conv(x, w_q, w_pack, w_scale, x_scale, bias,
                                           stride, pad_h, dilation, groups, ep_scale,
                                           ep_bias, act, float(slope))
    check_operands(x, w_q, groups, epilogue)
    if x.device.type == "cpu":
        return int8_conv2d_plain(x, w_q, w_scale, x_scale, bias, stride, padding,
                                 dilation, groups, epilogue)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return int8_conv2d_cuda(x, w_pack, w_scale, x_scale, bias, stride, padding,
                            dilation, groups, epilogue, w_q.shape)


def int8_conv2d_cuda(x: torch.Tensor, w_pack: Optional[torch.Tensor],
                     w_scale: torch.Tensor, x_scale: torch.Tensor,
                     bias: Optional[torch.Tensor], stride: int, padding: Padding,
                     dilation: int, groups: int, epilogue: Epilogue,
                     w_shape) -> torch.Tensor:
    """One launch of ``csrc/int8_conv.cu`` (quantize pass and product) on
    checked operands, ``w_shape`` the shape of ``w_q``; raises where the
    kernel does not take them."""
    o, cpg, kh, kw = w_shape
    n, c, h, w = x.shape
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the CUDA kernel takes bf16 x, got {x.dtype}")
    cin_g, cout_g = (c, o) if groups == 1 else (BLOCK, BLOCK)
    want = (c // cin_g, _round_up(cout_g, ROW_ALIGN),
            kh * kw * _round_up(cin_g, CHAN_ALIGN))
    if w_pack is None or w_pack.dtype != torch.int8 or not w_pack.is_contiguous() \
            or tuple(w_pack.shape) != want:
        raise ValueError(f"w_pack must be pack_weight(w_q, {groups}) {want}, got "
                         f"{None if w_pack is None else tuple(w_pack.shape)}")
    f32 = [t for t in (w_scale, x_scale, bias) if t is not None]
    if epilogue is not None:
        f32 += list(epilogue[:2])
    for t in [w_pack] + f32:
        if t.device != x.device:
            raise ValueError("the int8 conv's tensors must be on x's device")
    for t in f32:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("w_scale, x_scale, bias and the epilogue must be "
                             "contiguous float32")
    ho, wo = output_hw(h, w, kh, kw, stride, padding, dilation)
    xh = x.permute(0, 2, 3, 1)
    if not xh.is_contiguous():
        xh = xh.contiguous()
    # NCHW in channels_last memory: the NHWC tensor the kernel writes
    out = torch.empty((n, o, ho, wo), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    xq = torch.empty((n, h, w, (c // cin_g) * _round_up(cin_g, CHAN_ALIGN)),
                     dtype=torch.int8, device=x.device)
    ep_scale, ep_bias, act, slope = epilogue if epilogue is not None else \
        (None, None, "none", 0.0)
    args = (xh.data_ptr(), xq.data_ptr(), w_pack.data_ptr(), w_scale.data_ptr(),
            x_scale.data_ptr(),
            None if bias is None else bias.data_ptr(),
            None if ep_scale is None else ep_scale.data_ptr(),
            None if ep_bias is None else ep_bias.data_ptr(), out.data_ptr(),
            n, h, w, c, ho, wo, o, kh, kw, stride, *pad_hw(padding), dilation, cin_g, cout_g,
            w_pack.shape[1], w_pack.shape[2], ACTS[act], float(slope))
    dev = x.device.index
    stream = torch._C._cuda_getCurrentRawStream(dev)
    if dev == torch.cuda.current_device():
        INT8_CONV.launch(*args, stream)
    else:
        with torch.cuda.device(dev):
            INT8_CONV.launch(*args, stream)
    return out


def output_hw(h: int, w: int, kh: int, kw: int, stride: int, padding: Padding,
              dilation: int) -> Tuple[int, int]:
    """The conv's output height and width."""
    pad_h, pad_w = pad_hw(padding)
    return ((h + 2 * pad_h - dilation * (kh - 1) - 1) // stride + 1,
            (w + 2 * pad_w - dilation * (kw - 1) - 1) // stride + 1)
