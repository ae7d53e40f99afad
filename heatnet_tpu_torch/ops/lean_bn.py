"""Train-mode BatchNorm + activation with a minimal-residual backward.

Counterpart of ``heatnet_tpu/ops/lean_bn.py:83-181`` (``HEATNET_BN_IMPL=lean``),
a ``torch.autograd.Function`` with the JAX custom VJP's semantics:

- forward: per-channel mean and E[y^2] in float32 (float64 for a float64
  ``y``; the fast-variance form,
  biased: var = max(E[y^2] - E[y]^2, 0)), then ``act((y - mean) * rstd *
  scale + bias)``, returned in ``y``'s dtype beside the float32 mean and
  var, which carry no gradient (the caller's running-average update);
- it saves ``y`` and the per-channel statistics only, nothing elementwise;
  the activation's derivative is recomputed from ``y`` (relu and leaky: a
  sign test on the pre-activation; elu: its exp);
- backward: the full train-mode BN gradient, through the batch statistics
  too, in ``_lean_bwd``'s two passes (:153-174): a reduce pass for
  s1 = sum(dz * xhat) and s2 = sum(dz) (dgamma and dbeta), then
  dy = scale * rstd * (dz - s2 / n - xhat * s1 / n), in ``y``'s dtype;
  dgamma and dbeta in float32.

``y`` is NCHW (any memory format); the statistics are over N, H and W.
With a data-parallel ``group`` (``parallel.mesh.batch_stats_group``) the
count, the sum and the sum of squares are all-reduced over the processes in
the forward, and s1, s2 in the backward, so the statistics and the
gradient are those of the whole batch; dgamma and dbeta stay this process's
share, which the gradient all-reduce sums. JAX's op is plain ``jnp`` (no
Pallas kernel), and so is this: PyTorch operations inside the Function.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_AXES = (0, 2, 3)


def _channel(v: torch.Tensor) -> torch.Tensor:
    return v[None, :, None, None]


def _act(pre: torch.Tensor, act: str, slope: float) -> torch.Tensor:
    if act == "relu":
        return torch.clamp_min(pre, 0.0)
    if act == "leaky_relu":
        return torch.where(pre >= 0, pre, pre * slope)
    if act == "elu":
        return torch.where(pre >= 0, pre, torch.expm1(pre))
    if act == "none":
        return pre
    raise ValueError(f"unknown activation {act}")


def _dact(pre: torch.Tensor, act: str, slope: float) -> torch.Tensor:
    if act == "relu":
        return (pre > 0).to(pre.dtype)
    if act == "leaky_relu":
        return torch.where(pre > 0, 1.0, slope).to(pre.dtype)
    if act == "elu":
        return torch.where(pre > 0, torch.ones_like(pre), torch.exp(pre))
    if act == "none":
        return torch.ones((), dtype=pre.dtype, device=pre.device)
    raise ValueError(f"unknown activation {act}")


def _compute_dtype(y: torch.Tensor) -> torch.dtype:
    """float32 for bf16, f16 and f32 activations (JAX's f32 reductions);
    float64 stays float64."""
    return torch.promote_types(y.dtype, torch.float32)


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    if group is not None:
        torch.distributed.all_reduce(t, group=group)
    return t


class LeanBNAct(torch.autograd.Function):

    @staticmethod
    def forward(ctx, y, scale, bias, eps, act, slope, group, stats_dtype):
        f = _compute_dtype(y)
        ys = y.to(torch.promote_types(stats_dtype, f))
        c = y.shape[1]
        sums = torch.cat([ys.sum(_AXES), ys.square().sum(_AXES),
                          ys.new_full((1,), y.numel() // c)])
        sums = _all_reduce(sums, group)
        mean = sums[:c] / sums[-1]
        var = torch.clamp_min(sums[c:2 * c] / sums[-1] - mean.square(), 0.0)
        n, mean, var = sums[-1].to(f), mean.to(f), var.to(f)
        rstd = torch.rsqrt(var + eps)
        pre = (y.to(f) - _channel(mean)) * _channel(rstd) * _channel(scale.to(f)) \
            + _channel(bias.to(f))
        ctx.save_for_backward(y, mean, rstd, scale, bias, n)
        ctx.act, ctx.slope, ctx.group = act, slope, group
        ctx.mark_non_differentiable(mean, var)
        return _act(pre, act, slope).to(y.dtype), mean, var

    @staticmethod
    def backward(ctx, dout, _dmean, _dvar):
        y, mean, rstd, scale, bias, n = ctx.saved_tensors
        f = _compute_dtype(y)
        s32 = _channel(scale.to(f))
        xhat = (y.to(f) - _channel(mean)) * _channel(rstd)
        dz = dout.to(f) * _dact(xhat * s32 + _channel(bias.to(f)), ctx.act, ctx.slope)
        s1, s2 = (dz * xhat).sum(_AXES), dz.sum(_AXES)
        g1, g2 = s1, s2
        if ctx.group is not None:
            g1, g2 = _all_reduce(torch.cat([s1, s2]), ctx.group).chunk(2)
        dy = (s32 * _channel(rstd)) * (dz - _channel(g2 / n) - xhat * _channel(g1 / n))
        return dy.to(y.dtype), s1, s2, None, None, None, None, None


def lean_bn_act(y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float,
                act: str, slope: float, group: Optional[object] = None,
                stats_dtype: torch.dtype = torch.float32
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``act(batch_norm(y))`` with train-mode batch statistics; returns
    ``(a, mean, var)``, mean and var float32 per channel without gradient.
    ``stats_dtype`` float64 takes the sums in double (the data-parallel form
    of the default BN, ``models/layers.py::BatchNorm``); the lean BN's are
    float32, as JAX's."""
    return LeanBNAct.apply(y, scale, bias, float(eps), act, float(slope), group,
                           stats_dtype)
