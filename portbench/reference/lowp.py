"""The control: the reference computed one precision below the program's;
and two witnesses of the program's own precision.

The configurations state bfloat16; the precision below is fp8. ``fp8`` casts
a tensor to float8 e4m3 with a per-tensor scale (its largest magnitude to
448) and back to float32; in the backward the incoming gradient is cast to
float8 e5m2 the same way (scale to 57344), as fp8 training recipes carry
gradients. The reference applies it to every conv's input, weight and
output, so its convs multiply fp8 values (summed in float32) and the
activations between them are held in fp8, as a program computing in fp8
would hold them where the configuration's program holds bfloat16.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _cast(t: torch.Tensor, dtype, top: float) -> torch.Tensor:
    amax = t.detach().abs().amax().float().clamp(min=1e-30)
    scale = top / amax
    return ((t.float() * scale).to(dtype).float() / scale).to(t.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _cast(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _cast(g, torch.float8_e5m2, E5M2_MAX)


def fp8(t: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(t)


def bf16(t: torch.Tensor) -> torch.Tensor:
    """A tensor rounded to bfloat16 (the program's precision), as a witness
    of what rounding alone does; gradients pass unchanged."""
    return t + (t.to(torch.bfloat16).to(t.dtype) - t).detach()


class _Bf16Both(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def bf16_held(t: torch.Tensor) -> torch.Tensor:
    """A tensor rounded to bfloat16 in the forward and its gradient rounded
    to bfloat16 in the backward: with ``activations`` set, the reference
    also holds every batch norm's activated output, every residual sum and
    every critic activation so, as the program holds its activations and
    their gradients in bfloat16."""
    return _Bf16Both.apply(t)


bf16_held.activations = True
