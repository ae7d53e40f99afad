"""Frame packs: decode-free directory inference and training.

The port's own copy of ``heatnet_tpu/data/packed.py:37-48,149-214`` (numpy
only) plus ``write_pack`` and ``write_train_pack``, which write packs from
arrays. An inference pack (heatnet-pack-v1)::

    pack/
      meta.json   {"n": N, "height": H, "width": W, "names": [...],
                   "format": "heatnet-pack-v1"}
      rgb.npy     uint8  (N, H, W, 3)
      ir.npy      uint16 (N, H, W, 1)  radiometric counts, unclamped

Its frames are stored as the eval loaders ship them: resized to 960x320 and
cropped to the stride-aligned window 148:852 (W = 704), raw sensor dtypes.

A train pack (heatnet-train-pack-v1) holds full 960x320 frames::

    pack/
      meta.json      {"format": "heatnet-train-pack-v1", "split": ...,
                      "n_day": N, "n_night": M, "height": H, "width": W,
                      "test_stamps_filtered": bool}
      rgb_day.npy    uint8  (N, H, W, 3)    rgb_night.npy  uint8  (M, H, W, 3)
      ir_day.npy     uint16 (N, H, W)       ir_night.npy   uint16 (M, H, W)
      label_day.npy  uint8  (N, H, W)

Packing PNG trees (``pack_inference_dir``, ``pack_freiburg_train``) needs
the JAX package's cv2 loaders and is not ported.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

FORMAT = "heatnet-pack-v1"
TRAIN_FORMAT = "heatnet-train-pack-v1"


def is_pack_dir(path: str) -> bool:
    return os.path.isfile(os.path.join(path, "meta.json")) and \
        os.path.isfile(os.path.join(path, "rgb.npy"))


def is_train_pack_dir(path: str) -> bool:
    return os.path.isfile(os.path.join(path, "meta.json")) and \
        os.path.isfile(os.path.join(path, "rgb_day.npy"))


def write_pack(out_dir: str, rgb: np.ndarray, ir: np.ndarray,
               names: Optional[Sequence[str]] = None) -> int:
    """Write uint8 ``rgb`` (N,H,W,3) and uint16 ``ir`` (N,H,W,1) as a pack."""
    if rgb.dtype != np.uint8 or rgb.ndim != 4 or rgb.shape[-1] != 3:
        raise ValueError(f"rgb must be uint8 (N,H,W,3), got {rgb.dtype} {rgb.shape}")
    if ir.dtype != np.uint16 or ir.shape != rgb.shape[:3] + (1,):
        raise ValueError(f"ir must be uint16 {rgb.shape[:3] + (1,)}, "
                         f"got {ir.dtype} {ir.shape}")
    n, h, w = rgb.shape[:3]
    names = list(names) if names is not None else [f"{i:06d}" for i in range(n)]
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, "rgb.npy"), rgb)
    np.save(os.path.join(out_dir, "ir.npy"), ir)
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump({"format": FORMAT, "n": n, "height": h, "width": w,
                   "names": names}, f)
    return n


def write_train_pack(out_dir: str, rgb_day: np.ndarray, ir_day: np.ndarray,
                     label_day: np.ndarray, rgb_night: np.ndarray,
                     ir_night: np.ndarray, split: str = "train") -> Tuple[int, int]:
    """Write day (rgb, ir, label) and night (rgb, ir) frames as a train pack.

    uint8 rgb (N,H,W,3), uint16 ir (N,H,W) and uint8 labels (N,H,W); night
    frames share H and W. Returns (n_day, n_night).
    """
    n, h, w = rgb_day.shape[:3]
    m = rgb_night.shape[0]
    want = {"rgb_day": (rgb_day, np.uint8, (n, h, w, 3)),
            "ir_day": (ir_day, np.uint16, (n, h, w)),
            "label_day": (label_day, np.uint8, (n, h, w)),
            "rgb_night": (rgb_night, np.uint8, (m, h, w, 3)),
            "ir_night": (ir_night, np.uint16, (m, h, w))}
    for name, (a, dtype, shape) in want.items():
        if a.dtype != dtype or a.shape != shape:
            raise ValueError(f"{name} must be {np.dtype(dtype)} {shape}, "
                             f"got {a.dtype} {a.shape}")
    os.makedirs(out_dir, exist_ok=True)
    for name, (a, _, _) in want.items():
        np.save(os.path.join(out_dir, name + ".npy"), a)
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump({"format": TRAIN_FORMAT, "split": split, "n_day": n,
                   "n_night": m, "height": h, "width": w,
                   "test_stamps_filtered": False}, f)
    return n, m


class PackedFreiburgTrainDataset:
    """Serve a train pack with the ``FreiburgThermalDataset`` item surface.

    An item is the day frame ``index`` (uint8 rgb, uint16 ir, uint8 label)
    and a night frame drawn by a ``RandomState(seed)`` stream, as the JAX
    package pairs them.
    """

    def __init__(self, pack_dir: str, seed: int = 0):
        with open(os.path.join(pack_dir, "meta.json")) as f:
            self.meta = json.load(f)
        if self.meta.get("format") != TRAIN_FORMAT:
            raise ValueError(f"not a {TRAIN_FORMAT} directory: {pack_dir}")
        for name in ("rgb_day", "ir_day", "label_day", "rgb_night", "ir_night"):
            setattr(self, name, np.load(os.path.join(pack_dir, name + ".npy"),
                                        mmap_mode="r"))
        self._rng = np.random.RandomState(seed)

    def __len__(self):
        return int(self.meta["n_day"])

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        rand_idx = self._rng.randint(0, int(self.meta["n_night"]))
        return {
            "rgb_day": np.asarray(self.rgb_day[index]),
            "ir_day": np.asarray(self.ir_day[index]),
            "label_day": np.asarray(self.label_day[index]),
            "rgb_night": np.asarray(self.rgb_night[rand_idx]),
            "ir_night": np.asarray(self.ir_night[rand_idx]),
        }


class PackedFrameDataset:
    """Serve a pack directory with the ``FreiburgInferDataset`` item surface.

    ``__getitem__`` is a memmap slice (no image decode) returning
    ``rgb``/``rgb_org`` (1,H,W,3) uint8, ``ir`` (1,H,W,1) uint16 and
    ``ir_org``, the clamped IR scaled to [0, 1] for display.
    """

    def __init__(self, pack_dir: str):
        with open(os.path.join(pack_dir, "meta.json")) as f:
            self.meta = json.load(f)
        if self.meta.get("format") != FORMAT:
            raise ValueError(f"not a {FORMAT} directory: {pack_dir}")
        self.rgb = np.load(os.path.join(pack_dir, "rgb.npy"), mmap_mode="r")
        self.ir = np.load(os.path.join(pack_dir, "ir.npy"), mmap_mode="r")
        self.names = self.meta["names"]

    def __len__(self):
        return int(self.meta["n"])

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        rgb = np.asarray(self.rgb[index])
        ir = np.asarray(self.ir[index])
        ir_vis = (np.clip(ir.astype(np.float32), 21800, 25000)
                  - 21800) / 3200.0
        return {
            "rgb": rgb[None],
            "rgb_org": rgb[None],
            "ir": ir[None],
            "ir_org": ir_vis[None],
        }
