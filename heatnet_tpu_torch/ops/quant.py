"""Post-training int8: the serving mode's conversion and calibration.

Counterpart of ``heatnet_tpu/ops/quant.py`` and of the switch that turns the
JAX package's ``conv()`` layers into ``Int8Conv`` (``HEATNET_QUANT=int8``,
``models/layers.py:927-933``). The JAX flag is read when a model traces; here
a model is converted once::

    model = ResNeXtSeg(...)                  # float32 weights, trained bf16
    model.load_state_dict(...)
    convert_int8(model)                      # before prepare_for_inference
    prepare_for_inference(model, device)
    calibrate_int8(model, [(x,)])            # static activation scales
    seg, _, _ = model(x)                     # int8 serving

``convert_int8`` replaces each dense conv made by ``models/layers.conv`` and
each ``GroupedConv`` with its int8 counterpart (``Int8Conv2d``,
``Int8GroupedConv``), keeping the module path and the float32 weight and
adding a float32 ``x_scale`` buffer. Other convolutions stay float, as in
JAX: the critics', the deconvs, PSPNet's head (``nn.Conv`` there). JAX's
``HEATNET_INT8_MIN_BATCH`` and ``HEATNET_QUANT_MAX_HW`` are the arguments
``min_batch`` and ``max_hw``. The state_dict of a model that is not
converted is unchanged.
"""

from __future__ import annotations

from typing import Any, Iterable, Sequence, Union

import torch
import torch.nn as nn

from ..models.layers import Conv2d, GroupedConv, Int8Conv2d, Int8GroupedConv, _Int8Layer


def convert_int8(model: nn.Module, min_batch: int = 8, max_hw: int = 100_000) -> nn.Module:
    """Swap ``model``'s ``conv()`` layers for int8 ones, in place; returns it.
    The weights must still be float32 (convert before ``prepare_for_inference``)."""
    swaps = []
    for parent in model.modules():
        for name, child in parent.named_children():
            if isinstance(child, _Int8Layer):
                continue
            if isinstance(child, GroupedConv):
                swaps.append((parent, name, Int8GroupedConv))
            elif isinstance(child, Conv2d) and getattr(child, "int8_ok", False):
                swaps.append((parent, name, Int8Conv2d))
    for parent, name, cls in swaps:
        child = getattr(parent, name)
        if child.weight.dtype != torch.float32:
            raise ValueError(f"{name}: convert_int8 takes the float32 model, before "
                             "prepare_for_inference casts its weights")
        q = cls(child, min_batch=min_batch, max_hw=max_hw)
        q.train(child.training)
        setattr(parent, name, q)
    return model


def int8_layers(model: nn.Module):
    """The model's int8 layers, by name."""
    return [(n, m) for n, m in model.named_modules() if isinstance(m, _Int8Layer)]


def calibrate_int8(model: nn.Module,
                   batches: Iterable[Union[torch.Tensor, Sequence[Any]]]) -> nn.Module:
    """Run ``model`` on each batch (a tensor or a tuple of positional
    arguments) with the int8 layers recording their scales: each keeps the
    running max of ``max|x| / 127`` over the batches. As in JAX, a layer
    updates its scale before it picks its branch, so from ``min_batch`` up
    the later layers calibrate on the int8 outputs of the earlier ones, and
    below it on float ones. Raises on a model without int8 layers and on an
    empty ``batches``."""
    layers = [m for _, m in int8_layers(model)]
    if not layers:
        raise ValueError("model has no int8 layers: run convert_int8 on it first")
    saw_batch = False
    try:
        for m in layers:
            m.calibrating = True
        with torch.no_grad():
            for batch in batches:
                saw_batch = True
                model(*(batch if isinstance(batch, (tuple, list)) else (batch,)))
    finally:
        for m in layers:
            m.calibrating = False
    if not saw_batch:
        raise ValueError("calibration saw no batches")
    return model
