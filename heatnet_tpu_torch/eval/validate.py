"""Batched inference: raw frames → ingest → model → argmax → uint8 class maps.

Counterpart of ``heatnet_tpu/eval/validate.py:71-108,142-181,331-373``
(``_forward_factory``, ``_batched``, ``inference``) for label-free serving.
Frames arrive as the loaders ship them, uint8 RGB and uint16 IR; one launch
of the fused ingest kernel per batch normalises them on the device. For
RGB+IR it writes the early-fusion input directly, or, for a late-fusion
model (``model.late_fusion``), RGB and IR as two tensors; an RGB-only model
(PSPNet, ``--modalities rgb``) gets the normalised RGB. The JAX package
normalises in plain jnp (``_device_normalize``, :52-68); the function is the
same. The class map returns to the host as uint8.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from ..device import resolve
from ..ops import fused_preproc


def batched(frames: Iterable[Dict[str, np.ndarray]], batch_size: int,
            keys) -> Iterator[Tuple[Dict[str, np.ndarray], int]]:
    """Group per-item dicts (leading dim 1) into batches of ``batch_size``.

    The ragged tail pads by repeating its last frame, so every forward runs
    at one batch shape. Yields (batch, number of real frames).
    """
    buf = []

    def emit(items):
        batch = {k: np.concatenate([np.asarray(it[k]) for it in items], axis=0)
                 for k in keys}
        valid = len(items)
        if valid < batch_size:
            batch = {k: np.concatenate(
                [v, np.repeat(v[-1:], batch_size - valid, axis=0)], axis=0)
                for k, v in batch.items()}
        return batch, valid

    for item in frames:
        buf.append(item)
        if len(buf) == batch_size:
            yield emit(buf)
            buf = []
    if buf:
        yield emit(buf)


def modality_keys(modalities: str):
    keys = [k for k in ("rgb", "ir") if k in modalities]
    if not keys:
        raise ValueError(f"no known modality in {modalities!r}")
    return keys


def ingest(batch: Dict[str, np.ndarray], modalities: str, device: torch.device,
           dtype: torch.dtype, late_fusion: bool = False) -> Tuple[torch.Tensor, ...]:
    """Host uint8/uint16 frames → the model's NHWC inputs on ``device``, in
    one kernel launch.

    RGB+IR becomes the 4-channel early-fusion tensor, or with
    ``late_fusion`` the pair ``(rgb_n, ir_n)``. IR crosses as int16 bytes
    (uint16 has thin PyTorch support) and is viewed back as uint16 on the
    device.
    """
    rgb = ir = None
    if "rgb" in modalities:
        rgb = torch.from_numpy(np.array(batch["rgb"], order="C")).to(device)
    if "ir" in modalities:
        ir16 = np.array(batch["ir"], order="C").view(np.int16)
        ir = torch.from_numpy(ir16).to(device).view(torch.uint16)
    if rgb is not None and ir is not None:
        if late_fusion:
            return fused_preproc.inference_preprocess_fused(rgb, ir, 0, rgb.shape[-2],
                                                            dtype)
        return (fused_preproc.early_fusion_input(rgb, ir, 0, rgb.shape[-2], dtype),)
    if rgb is not None:
        return (fused_preproc.rgb_normalize_fused(rgb, dtype),)
    return (fused_preproc.ir_normalize_fused(ir, dtype),)


def predict(model: torch.nn.Module, batch: Dict[str, np.ndarray],
            modalities: str, device: torch.device) -> torch.Tensor:
    """One batch through ingest → model → argmax; a uint8 map on ``device``.
    The model's own ``late_fusion`` picks the ingest's outputs."""
    with torch.no_grad():
        seg, _, _ = model(*ingest(batch, modalities, device, model.compute_dtype,
                                  getattr(model, "late_fusion", False)))
        return seg.argmax(dim=-1).to(torch.uint8)


def inference(model: torch.nn.Module, frames: Iterable[Dict[str, np.ndarray]],
              batch_size: int, device: Optional[Union[str, torch.device]] = None,
              modalities: str = "ir_rgb") -> np.ndarray:
    """Serve ``frames`` in batches; returns the (n, H, W) uint8 class maps.

    ``model`` must already be on ``device`` in eval mode
    (``models.layers.prepare_for_inference``).
    """
    dev = resolve(device)
    keys = modality_keys(modalities)
    maps = []
    for batch, valid in batched(frames, max(int(batch_size), 1), keys):
        maps.append(predict(model, batch, modalities, dev)[:valid].cpu().numpy())
    if not maps:
        raise ValueError("no frames to serve")
    return np.concatenate(maps, axis=0)
