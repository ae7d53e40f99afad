"""Checkpoints as ``torch.save`` bundles: ``{"epoch", "state_dict"}``.

Counterpart of the parts of ``heatnet_tpu/io/checkpoint.py`` that the
trainers and the inference CLI use (the JAX package writes orbax
directories; the port writes one PyTorch file).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping

import torch
import torch.nn as nn


def save_checkpoint(bundle: Dict[str, Any], path: str) -> str:
    """Write ``bundle`` to ``path`` (via a temporary file, then a rename)."""
    path = os.path.abspath(path)
    tmp = path + ".tmp"
    torch.save(bundle, tmp)
    os.replace(tmp, path)
    return path


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of a checkpoint bundle, or of a bare ``state_dict`` file."""
    saved = torch.load(path, map_location="cpu", weights_only=True)
    return saved.get("state_dict", saved)


def restore_partial(model: nn.Module, saved: Mapping[str, torch.Tensor],
                    verbose: bool = True) -> int:
    """Load the saved entries whose name and shape match the model's
    (``initModelPartial``, scripts/main.py:25-37); returns their number."""
    own = model.state_dict()
    match = {k: v for k, v in saved.items()
             if k in own and tuple(v.shape) == tuple(own[k].shape)}
    model.load_state_dict(match, strict=False)
    if verbose:
        print(f"Updated : {len(match)} entries (restore_partial)")
    return len(match)
