"""JAX (flax) parameter trees → the port's ``state_dict``.

The inverse of ``heatnet_tpu/io/torch_import.py``'s layout rules
(:8-18, :215-225), for trees given as nested dicts of numpy arrays:

- conv kernel ``(kh, kw, I, O)`` → weight ``(O, I, kh, kw)`` (grouped convs
  included: ``I`` is the channels per group in both layouts);
- ConvTranspose kernel ``(kh, kw, I, O)`` → ``np.flip(k, (0, 1))
  .transpose(2, 3, 0, 1)``, i.e. ``(I, O, kh, kw)`` spatially flipped;
- Dense kernel ``(in, out)`` → ``Linear.weight`` ``(out, in)``;
- PReLU's scalar ``negative_slope`` → ``weight`` of shape ``(1,)``
  (``torch_import.py:233-236`` in the other direction);
- BN ``scale``/``bias`` → ``weight``/``bias``, whatever the BN module is
  named (``bn``, ``bn1``, ``downsample_bn``: only a BatchNorm has a
  ``scale``); batch_stats ``mean``/``var`` → ``running_mean``/``running_var``
  (plus ``num_batches_tracked`` = 0, a buffer of ``nn.BatchNorm2d``);
- the ``quant`` collection's ``x_scale`` (int8 serving, ``calibrate_int8``)
  → the ``x_scale`` buffer of the layer of the same path (``ops/quant.py``).

Port module names are the JAX tree's, so a key is the tree path joined with
``.``. Given the port module (``target``), a kernel is a transposed conv's
exactly where the target's module of that path is an ``nn.ConvTranspose2d``.
Without one, a transposed conv is recognised by its module name, with the
same rule as ``torch_import.convert_state_dict``: the last module name starts
with one of ``TRANSPOSE_NAMES`` (PSPNet's ``up_1/conv`` ends in ``conv`` and
is a plain conv). The name rule cannot convert RTFNet, whose upsampling
``TransBottleneck`` names its 2x2 transposed conv ``conv3``, as a keep-shape
block names its 3x3 conv.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

TRANSPOSE_NAMES = ("up", "up_seg_2", "up_seg_2_cert", "up_borders_3",
                   "up_inst_2", "deconv", "upsample")


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def state_dict_from_jax(params: Mapping, batch_stats: Optional[Mapping] = None,
                        target: Optional[nn.Module] = None,
                        quant: Optional[Mapping] = None) -> Dict[str, torch.Tensor]:
    """Convert flax ``params`` (and ``batch_stats``, and the int8 ``quant``
    collection) to a port ``state_dict``; with ``target`` (the port module the
    result is for) transposed convs are told apart by the target's module
    types, else by name."""
    transposed = None if target is None else {
        name for name, m in target.named_modules() if isinstance(m, nn.ConvTranspose2d)}
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(params):
        mods, name = list(path[:-1]), path[-1]
        a = np.asarray(leaf, np.float32)
        if name == "scale":  # a BatchNorm's, whatever its module is named
            name = "weight"
        elif name == "kernel" and a.ndim == 4:
            if (".".join(mods) in transposed if transposed is not None
                    else mods and mods[-1].startswith(TRANSPOSE_NAMES)):
                a = np.flip(a, (0, 1)).transpose(2, 3, 0, 1)
            else:
                a = a.transpose(3, 2, 0, 1)
            name = "weight"
        elif name == "kernel" and a.ndim == 2:  # Dense (in, out) → Linear (out, in)
            a = a.T
            name = "weight"
        elif name == "negative_slope":  # flax PReLU's scalar → nn.PReLU's (1,)
            a = a.reshape(1)
            name = "weight"
        sd[".".join(mods + [name])] = _tensor(a)
    for path, leaf in _leaves(batch_stats or {}):
        mods, name = list(path[:-1]), path[-1]
        if name not in ("mean", "var"):
            raise ValueError(f"unexpected batch_stats leaf {'/'.join(path)}")
        sd[".".join(mods + ["running_" + name])] = _tensor(leaf)
        if name == "mean":
            sd[".".join(mods + ["num_batches_tracked"])] = torch.tensor(0)
    for path, leaf in _leaves(quant or {}):
        if path[-1] != "x_scale":
            raise ValueError(f"unexpected quant leaf {'/'.join(path)}")
        sd[".".join(path)] = _tensor(leaf)
    return sd
