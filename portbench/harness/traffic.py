"""The one generator of host frames, driven by a traffic file's parameters.

Frames are made on the run's device from the seed (bulk draws from a
``torch.Generator`` there) and copied to host memory, where the program's
users hold them: uint8 RGB (N, H, W, 3) and uint16 IR counts, as packs ship
them (``data/packed.py``). Every seed gives the same sizes; only the values
differ.

- ``serve_pool``: ``pool`` distinct batches of ``batch`` frames, IR (N, H, W, 1);
- ``train_pool``: ``pool`` distinct raw batches of ``batch`` day frames
  (RGB, IR (N, H, W), banded labels) and as many night frames. The labels
  are diagonal bands (64 rows by 192 columns per class step, 13 classes),
  each frame's bands shifted by its own offsets.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _ir(gen, shape, lo, hi, device) -> np.ndarray:
    # counts below 2^15: int16 bits are the uint16 bits
    return _host(torch.randint(lo, hi, shape, generator=gen, device=device,
                               dtype=torch.int16)).view(np.uint16)


def serve_pool(p: dict, seed: int, device) -> List[Dict[str, np.ndarray]]:
    gen = torch.Generator(device=device).manual_seed(seed)
    n, b, h, w = p["pool"], p["batch"], p["height"], p["width"]
    lo, hi = p["ir_counts"]
    rgb = _host(torch.randint(0, 256, (n, b, h, w, 3), generator=gen, device=device,
                              dtype=torch.uint8))
    ir = _ir(gen, (n, b, h, w, 1), lo, hi, device)
    return [{"rgb": rgb[i], "ir": ir[i]} for i in range(n)]


def train_pool(p: dict, seed: int, device) -> List[Dict[str, np.ndarray]]:
    gen = torch.Generator(device=device).manual_seed(seed)
    n, b, h, w = p["pool"], p["batch"], p["height"], p["width"]
    lo, hi = p["ir_counts"]
    classes = p["classes"]
    rgb_day = _host(torch.randint(0, 256, (n, b, h, w, 3), generator=gen, device=device,
                                  dtype=torch.uint8))
    rgb_night = _host(torch.randint(0, 256, (n, b, h, w, 3), generator=gen, device=device,
                                    dtype=torch.uint8))
    ir_day = _ir(gen, (n, b, h, w), lo, hi, device)
    ir_night = _ir(gen, (n, b, h, w), lo, hi, device)
    off = torch.randint(0, 1 << 12, (n, b, 2), generator=gen, device=device)
    ys = torch.arange(h, device=device).view(1, 1, h, 1)
    xs = torch.arange(w, device=device).view(1, 1, 1, w)
    bands = ((ys + off[..., 0, None, None]) // 64
             + (xs + off[..., 1, None, None]) // 192) % classes
    label = _host(bands.to(torch.uint8))
    return [{"rgb_day": rgb_day[i], "ir_day": ir_day[i], "label_day": label[i],
             "rgb_night": rgb_night[i], "ir_night": ir_night[i]} for i in range(n)]
