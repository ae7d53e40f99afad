"""Synthetic KAIST trees in the reference on-disk layout.

The port's copy of ``heatnet_tpu/data/synthetic.py:153-171`` (``make_kaist``),
written with ``data.png.write_png`` instead of cv2: every file holds PNG
bytes, the ``.jpg`` names included (the JAX copy's cv2 writes JPEGs there).
PIL and the port's ``KAISTCycleGANDataset`` both decode by content, so a
tree written here needs no JPEG decoder. The loaders' globs run for real.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from .png import write_png


def _write(path: str, arr: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_png(path, arr)


def make_kaist(root: str, n_day: int = 3, n_night: int = 3,
               hw: Tuple[int, int] = (64, 80), seed: int = 6) -> str:
    """KAIST layout for the CycleGAN loader: ``Day/set00/V000/{lwir,visible,
    labels}`` and ``Night/set04/V000/lwir``, the JAX copy's draws in its
    order (labels 0-11)."""
    rng = np.random.RandomState(seed)
    h, w = hw
    for i in range(n_day):
        base = os.path.join(root, "Day", "set00", "V000")
        _write(os.path.join(base, "lwir", f"I{i:05d}.jpg"),
               rng.randint(0, 255, (h, w)).astype(np.uint8))
        _write(os.path.join(base, "visible", f"I{i:05d}.jpg"),
               rng.randint(0, 255, (h, w, 3)).astype(np.uint8))
        _write(os.path.join(base, "labels", f"I{i:05d}.png"),
               rng.randint(0, 12, (h, w)).astype(np.uint8))
    for i in range(n_night):
        base = os.path.join(root, "Night", "set04", "V000")
        _write(os.path.join(base, "lwir", f"I{i:05d}.jpg"),
               rng.randint(0, 100, (h, w)).astype(np.uint8))
    return root
