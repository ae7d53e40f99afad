"""heatnet-pack-v1 frame packs: decode-free directory inference.

The port's own copy of ``heatnet_tpu/data/packed.py:184-214`` (numpy only)
plus ``write_pack``, which writes a pack from arrays. Layout::

    pack/
      meta.json   {"n": N, "height": H, "width": W, "names": [...],
                   "format": "heatnet-pack-v1"}
      rgb.npy     uint8  (N, H, W, 3)
      ir.npy      uint16 (N, H, W, 1)  radiometric counts, unclamped

Frames are stored as the eval loaders ship them: resized to 960x320 and
cropped to the stride-aligned window 148:852 (W = 704), raw sensor dtypes.
Packing a PNG capture tree (``pack_inference_dir``) needs the JAX package's
cv2 loaders and is not ported.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence

import numpy as np

FORMAT = "heatnet-pack-v1"


def is_pack_dir(path: str) -> bool:
    return os.path.isfile(os.path.join(path, "meta.json")) and \
        os.path.isfile(os.path.join(path, "rgb.npy"))


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
