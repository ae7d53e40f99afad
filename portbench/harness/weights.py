"""Weights from the seed, made on the device in one draw.

The reference module (built on the meta device) lists every tensor by the
name that the program's ``state_dict`` uses; one ``torch.randn`` of their
total size, from a generator on the run's device, is cut into them and
shaped by each tensor's rule:

- conv and transposed-conv weights: N(0, 1/fan_in) (fan_in = input
  channels x window), or N(0, ``init_std``) where the module sets it (the
  critics' 0.02); conv biases N(0, 0.01);
- batch norm: weight 1 + 0.1 N, bias 0.1 N, running mean 0.1 N, running
  variance exp(0.2 N), so that the affine and the statistics are not the
  identity and a program that dropped them would show;
- ``num_batches_tracked`` 0.

Weights are returned in the dtype they are used in (``conv_dtype`` for conv
weights; float32 for the rest), so the program and the reference read the
same values.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from ..reference.segnet import BN, Conv, Deconv


def _rules(module: nn.Module):
    out = []
    for mname, m in module.named_modules():
        pre = mname + "." if mname else ""
        if isinstance(m, (Conv, Deconv)):
            w = m.weight
            fan_in = (w.shape[0] if isinstance(m, Deconv) else w.shape[1]) * w.shape[2] * w.shape[3]
            std = m.init_std or fan_in ** -0.5
            out.append((pre + "weight", tuple(w.shape), "conv", 0.0, std))
            if getattr(m, "bias", None) is not None:
                out.append((pre + "bias", tuple(m.bias.shape), "vec", 0.0, 0.01))
        elif isinstance(m, BN):
            c = (m.weight.shape[0],)
            out += [(pre + "weight", c, "vec", 1.0, 0.1), (pre + "bias", c, "vec", 0.0, 0.1),
                    (pre + "running_mean", c, "vec", 0.0, 0.1),
                    (pre + "running_var", c, "var", 0.0, 0.2)]
    return out


def make_weights(module: nn.Module, seed: int, device, conv_dtype=torch.float32
                 ) -> Dict[str, torch.Tensor]:
    """The weights of ``module``'s tensors (and BN counters), made from ``seed``."""
    rules = _rules(module)
    sizes = [torch.Size(shape).numel() for _, shape, *_ in rules]
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = torch.randn(sum(sizes), generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    for (name, shape, kind, loc, scale), part in zip(rules, torch.split(draw, sizes)):
        t = part.view(shape)
        if kind == "var":
            t = torch.exp(scale * t)
        else:
            t = loc + scale * t
        out[name] = t.to(conv_dtype) if kind == "conv" else t
    for name, buf in module.named_buffers():
        if name.endswith("num_batches_tracked"):
            out[name] = torch.zeros((), dtype=torch.long, device=device)
    missing = set(module.state_dict()) - set(out)
    if missing:
        raise KeyError(f"no rule makes {sorted(missing)[:5]}")
    return out


def load_reference(module: nn.Module, weights: Dict[str, torch.Tensor]) -> nn.Module:
    """The reference module with float32 copies of ``weights``, on their device."""
    module.load_state_dict({k: (v.to(torch.float32, copy=True) if v.is_floating_point() else v)
                            for k, v in weights.items()}, assign=True)
    return module

