"""Validators (Freiburg Thermal, MFNet, BDD) and batched inference.

Counterpart of ``heatnet_tpu/eval/validate.py``: ``validate_model``
(:257-275), ``validate_model_mfnet`` (:278-299, predictions mapped to MFNet's
labels), ``validate_model_bdd`` (:302-328, BDD labels mapped to HeatNet's),
``inference`` (:331-373, PNG dumps with ``save_dir``), ``batched`` (:142-181)
and the accumulation (:210-254). The IoUs and the logged keys are the JAX
package's.

A loader's items are grouped into batches of 16 (``DEFAULT_EVAL_BATCH``; a
``batch_size`` argument or ``HEATNET_EVAL_BATCH`` overrides it). The ragged
tail repeats its last frame with the labels of the repeats set to an
ignored value, so batched IoUs equal a frame-by-frame pass. Raw uint8 RGB
and uint16 IR go to the device and through one launch of the fused ingest
kernel per batch: it writes the early-fusion input directly, or, for a
late-fusion model (``model.late_fusion``), RGB and IR as two tensors; an
RGB-only model (PSPNet, ``--modalities rgb``) gets the normalised RGB.
Float frames (MFNet's and BDD's, normalised on the host) pass through, cast
to the model's compute dtype, as ``_device_normalize`` (:52-68) passes them.
The three IoU count vectors accumulate on the device; a class map returns to
the host as uint8 only to be saved.

``mesh=`` (a ``parallel/mesh.py`` mesh, :72-140, :212-353) evaluates data
parallel: the batch rounds up to a multiple of the ``data`` size, each
process runs its rows, the counts are summed over the processes, and the
class maps are gathered to every process; the first process writes the
dumps.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Iterable, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from ..data.loaders import to_device
from ..data.mappings import BDD_TO_HEATNET, HEATNET_TO_MFNET, mapping_to_lut
from ..device import resolve
from ..ops import fused_preproc
from ..ops.iou import iou_counts, ious_from_counts
from ..parallel.mesh import all_gather, data_group, data_size, shard_batch

# wandb key names per class (train_trgb_segnet_conf.py:611-625)
_PER_CLASS_KEYS = [
    "road,parking", "ground,sidewalk", "building,", "curb", "fence",
    "pole,traffic light,traffic sign", "vegetation", "terrain", "sky",
    "person,rider", "car,truck,bus,train", "motorcycle,bicycle",
]

DEFAULT_EVAL_BATCH = 16

Device = Optional[Union[str, torch.device]]


def eval_batch_size(batch_size: Optional[int] = None, mesh=None) -> int:
    """``batch_size``, else ``HEATNET_EVAL_BATCH``, else 16; rounded up to a
    multiple of the mesh's ``data`` size."""
    if batch_size is None:
        batch_size = os.environ.get("HEATNET_EVAL_BATCH", DEFAULT_EVAL_BATCH)
    d = data_size(mesh)
    return -(-max(int(batch_size), 1) // d) * d


def _gather_rows(mesh, pred: torch.Tensor) -> torch.Tensor:
    """Every process's rows of a batch, in order (the identity without a mesh)."""
    if data_size(mesh) == 1:
        return pred
    return torch.cat(all_gather(data_group(mesh), pred).unbind(0))


def _writes(mesh) -> bool:
    """Whether this process writes the dumps (the first of the mesh)."""
    return data_size(mesh) == 1 or mesh.get_local_rank("data") == 0


def batched(frames: Iterable[Dict[str, np.ndarray]], batch_size: int, keys=None,
            pad_label: int = 13) -> Iterator[Tuple[Dict[str, np.ndarray], int]]:
    """Group per-item dicts (leading dim 1) into batches of ``batch_size``.

    The ragged tail pads by repeating its last frame, so every forward runs
    at one batch shape; the repeats' labels are ``pad_label``, which counts
    in no class. Only ``keys`` are stacked (all keys when None). Yields
    (batch, number of real frames).
    """
    buf = []

    def emit(items):
        batch = {k: np.concatenate([np.asarray(it[k]) for it in items], axis=0)
                 for k in items[0] if keys is None or k in keys}
        valid = len(items)
        if valid < batch_size:
            batch = {k: np.concatenate(
                [v, np.repeat(v[-1:], batch_size - valid, axis=0)], axis=0)
                for k, v in batch.items()}
            if "label" in batch:
                batch["label"][valid:] = pad_label
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
    """Host frames → the model's NHWC inputs on ``device``.

    uint8/uint16 frames take one launch of the ingest kernel: RGB+IR becomes
    the 4-channel early-fusion tensor, or with ``late_fusion`` the pair
    ``(rgb_n, ir_n)``. Float frames are already normalised and are only cast.
    """
    return normalize_frames([to_device(batch[k], device) for k in modality_keys(modalities)],
                            dtype, late_fusion)


def normalize_frames(frames, dtype: torch.dtype,
                     late_fusion: bool = False) -> Tuple[torch.Tensor, ...]:
    """Frames on the device (RGB before IR) → the model's NHWC inputs, as
    ``_device_normalize`` (:52-68) reads them: uint8 is RGB, uint16 is IR,
    and both take one launch of the ingest kernel; float frames are only
    cast. Also the in-graph normalisation of an exported program."""
    if any(t.is_floating_point() for t in frames):
        return tuple(t.to(dtype) for t in frames)
    if len(frames) == 2:
        rgb, ir = frames
        if late_fusion:
            return fused_preproc.inference_preprocess_fused(rgb, ir, 0, rgb.shape[-2],
                                                            dtype)
        return (fused_preproc.early_fusion_input(rgb, ir, 0, rgb.shape[-2], dtype),)
    if frames[0].dtype == torch.uint8:
        return (fused_preproc.rgb_normalize_fused(frames[0], dtype),)
    return (fused_preproc.ir_normalize_fused(frames[0], dtype),)


def predict(model: torch.nn.Module, batch: Dict[str, np.ndarray],
            modalities: str, device: torch.device) -> torch.Tensor:
    """One batch through ingest → model → argmax; a uint8 map on ``device``.
    The model's own ``late_fusion`` picks the ingest's outputs."""
    with torch.no_grad():
        seg, _, _ = model(*ingest(batch, modalities, device, model.compute_dtype,
                                  getattr(model, "late_fusion", False)))
        return seg.argmax(dim=-1).to(torch.uint8)


def _save_hook(save_dir: str) -> Optional[Callable]:
    if not save_dir:
        return None
    os.makedirs(save_dir, exist_ok=True)
    from ..utils.vis import color_code_labels, save_image, vis_depth

    def hook(i, pred, frame):
        """``pred``/``frame`` entries are single frames (no batch dim)."""
        save_image(os.path.join(save_dir, f"pred_{i}.png"), color_code_labels(pred))
        if "rgb_org" in frame:
            save_image(os.path.join(save_dir, f"rgb_{i}.png"), frame["rgb_org"])
        if "ir_org" in frame:
            save_image(os.path.join(save_dir, f"ir_{i}.png"), vis_depth(frame["ir_org"]))
        if "label" in frame:
            save_image(os.path.join(save_dir, f"gt_{i}.png"),
                       color_code_labels(frame["label"]))

    return hook


def _accumulate(model, frames, modalities: str, device: Device, save_dir: str = "",
                batch_size: Optional[int] = None, pad_label: int = 13,
                pred_lut: Optional[np.ndarray] = None,
                label_lut: Optional[np.ndarray] = None, mesh=None) -> np.ndarray:
    """The IoU vector of ``frames``: per-class counts summed on the device
    over batches (and over the mesh's processes); ``pred_lut`` maps the
    predictions and ``label_lut`` the labels before counting (the dumps keep
    the loader's labels)."""
    dev = resolve(device)
    hook = _save_hook(save_dir) if _writes(mesh) else None
    keys = None if save_dir else modality_keys(modalities) + ["label"]
    lut = None if pred_lut is None else torch.as_tensor(pred_lut, dtype=torch.long,
                                                        device=dev)
    counts = torch.zeros((3, 13), dtype=torch.long, device=dev)
    frame = 0
    for batch, valid in batched(frames, eval_batch_size(batch_size, mesh), keys, pad_label):
        rows = shard_batch(mesh, {k: batch[k] for k in modality_keys(modalities) + ["label"]})
        pred = predict(model, rows, modalities, dev)
        if lut is not None:
            pred = lut[pred.long()]
        label = rows["label"]
        if label_lut is not None:
            label = label_lut[label.astype(np.int64)]
        counts += torch.stack(iou_counts(pred, to_device(label, dev)))
        if save_dir:
            pred_np = _gather_rows(mesh, pred.to(torch.uint8)).cpu().numpy()
            for j in range(valid if hook else 0):
                hook(frame + j, pred_np[j], {k: v[j] for k, v in batch.items()})
        frame += valid
    if data_size(mesh) > 1:
        torch.distributed.all_reduce(counts, group=data_group(mesh))
    return ious_from_counts(*counts.cpu().numpy())


def _log_per_class(logger, prefix: str, ious: np.ndarray) -> None:
    logs = {f"{prefix}_Test mean IoU": float(np.nanmean(ious))}
    for k, name in enumerate(_PER_CLASS_KEYS):
        logs[f"{prefix}_Test IoU {name}"] = float(ious[k])
    logger.log(logs)


def validate_model(model, frames, modalities: str, mode: str = "day", logger=None,
                   save_dir: str = "", batch_size: Optional[int] = None,
                   device: Device = None, mesh=None) -> np.ndarray:
    """Freiburg Thermal validation (validation_bdd_mf.py:259-379): the
    12-entry per-class IoU vector (classes 12/13 skipped). ``model`` is on
    ``device`` in eval mode (``models.layers.prepare_for_inference``)."""
    ious = _accumulate(model, frames, modalities, device, save_dir, batch_size, mesh=mesh)
    if logger is not None:
        _log_per_class(logger, mode, ious)
    return ious


def validate_model_mfnet(model, frames, modalities: str, mode: str = "day",
                         logger=None, save_dir: str = "",
                         batch_size: Optional[int] = None,
                         device: Device = None, mesh=None) -> np.ndarray:
    """MFNet validation: HeatNet predictions → MFNet labels, then IoU
    (validation_bdd_mf.py:145-257; unmapped predictions become class 0)."""
    lut = mapping_to_lut(HEATNET_TO_MFNET, num_src=14, default=0)
    ious = _accumulate(model, frames, modalities, device, save_dir, batch_size,
                       pred_lut=lut, mesh=mesh)
    if logger is not None:
        logger.log({
            f"{mode}_MFNET_Test mean IoU": float(np.nanmean(ious)),
            f"{mode}_MFNET_Test IoU curb": float(ious[4]),
            f"{mode}_MFNET_Test IoU person,rider": float(ious[2]),
            f"{mode}_MFNET_Test IoU car,truck,bus,train": float(ious[1]),
            f"{mode}_MFNET_Test IoU bicycle": float(ious[3]),
        })
    return ious


def validate_model_bdd(model, frames, logger=None, save_dir: str = "",
                       batch_size: Optional[int] = None,
                       device: Device = None, mesh=None) -> np.ndarray:
    """BDD night validation: BDD label ids → HeatNet labels, RGB-only model
    input (validation_bdd_mf.py:39-143). The padded rows carry the raw label
    255, which maps to the ignore class (BDD's 13 is a real class)."""
    gt_lut = mapping_to_lut(BDD_TO_HEATNET, num_src=256, default=13)
    ious = _accumulate(model, frames, "rgb", device, save_dir, batch_size,
                       pad_label=255, label_lut=gt_lut, mesh=mesh)
    if logger is not None:
        _log_per_class(logger, "BDD", ious)
    return ious


def inference(model: torch.nn.Module, frames: Iterable[Dict[str, np.ndarray]],
              batch_size: int, device: Device = None, modalities: str = "ir_rgb",
              save_dir: str = "", mesh=None) -> np.ndarray:
    """Serve ``frames`` in batches; returns the (n, H, W) uint8 class maps.

    With ``save_dir`` each frame's map is written as ``pred_<i>.png``
    (palette colours) and its RGB as ``rgb_<i>.png``. ``model`` must already
    be on ``device`` in eval mode (``models.layers.prepare_for_inference``).
    """
    dev = resolve(device)
    hook = _save_hook(save_dir) if _writes(mesh) else None
    keys = modality_keys(modalities) + (["rgb_org"] if save_dir else [])
    maps, n = [], 0
    for batch, valid in batched(frames, eval_batch_size(batch_size, mesh), keys):
        rows = shard_batch(mesh, {k: batch[k] for k in modality_keys(modalities)})
        pred = _gather_rows(mesh, predict(model, rows, modalities, dev))[:valid].cpu().numpy()
        if hook:
            for j in range(valid):
                hook(n + j, pred[j], {k: v[j] for k, v in batch.items()})
        maps.append(pred)
        n += valid
    if not maps:
        raise ValueError("no frames to serve")
    return np.concatenate(maps, axis=0)
