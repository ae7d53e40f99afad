"""Checkpoints as ``torch.save`` bundles: ``{"epoch", "state_dict"}``.

Counterpart of the parts of ``heatnet_tpu/io/checkpoint.py`` that the
trainers and the inference CLI use (the JAX package writes orbax
directories; the port writes one PyTorch file).
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Mapping

import torch
import torch.nn as nn


def save_checkpoint(bundle: Dict[str, Any], path: str, is_best: bool = False) -> str:
    """Write ``bundle`` to ``path`` (via a temporary file, then a rename);
    with ``is_best`` also a copy beside it, ``<name>_best<ext>``
    (``heatnet_tpu/io/checkpoint.py:50-68``)."""
    path = os.path.abspath(path)
    tmp = path + ".tmp"
    torch.save(bundle, tmp)
    os.replace(tmp, path)
    if is_best:
        root, ext = os.path.splitext(path)
        shutil.copyfile(path, tmp)
        os.replace(tmp, root + "_best" + ext)
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


def restore_renamed(model: nn.Module, saved: Mapping[str, torch.Tensor],
                    to_rename: str, rename: str, verbose: bool = True) -> int:
    """Prefix-rewrite restore (``initModelRenamed``, checkpoint.py:128-144):
    ``to_rename`` → ``rename`` in every saved key, then the entries whose
    name and shape match the model's. Raises if none does."""
    renamed = {k.replace(to_rename, rename): v for k, v in saved.items()}
    n = restore_partial(model, renamed, verbose=False)
    if verbose:
        print(f"Loaded dict with {n} entries...")
    if n == 0:
        raise KeyError(f"renamed restore ({to_rename!r} -> {rename!r}) matched "
                       "zero keys")
    return n


def resolve_auto_resume(resume: str, default_path: str) -> str:
    """``--resume auto``: this run's own checkpoint if it exists, else a fresh
    start (checkpoint.py:72-84); any other value passes through."""
    if resume != "auto":
        return resume
    p = os.path.abspath(default_path)
    return p if os.path.exists(p) else ""


def best_iou_tracker(initial: float = 0.0):
    """The best-IoU checkpointing decision (checkpoint.py:151-162):
    ``update(miou)`` says whether ``miou`` is a new best and keeps it."""
    state = {"best": initial}

    def update(miou: float) -> bool:
        is_best = miou > state["best"]
        if is_best:
            state["best"] = miou
        return is_best

    update.state = state
    return update
