"""Synthetic Freiburg, KAIST, MFNet and Vistas trees in the reference layouts.

The port's copies of ``heatnet_tpu/data/synthetic.py:23-171``
(``make_freiburg_train``, ``make_freiburg_test``, ``make_freiburg_infer``,
``make_mfnet``, ``make_vistas``, ``make_kaist``), written with
``data.png.write_png`` instead of cv2. All but ``make_kaist`` write the JAX
copies' files: the
same draws in the same order, colour frames stored as cv2 stores the
arrays it is given (BGR(A) in, so R and B swap on disk). ``make_kaist``'s
files all hold PNG bytes, the ``.jpg`` names included (the JAX copy's cv2
writes JPEGs there); PIL and the port's ``KAISTCycleGANDataset`` both
decode by content, so a tree written here needs no JPEG decoder. The
loaders' globs run for real.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from .loaders import swap_rb
from .png import write_png


def _write(path: str, arr: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_png(path, arr)


def _write_as_cv2(path: str, arr: np.ndarray) -> None:
    """The file ``cv2.imwrite(path, arr)`` writes: colour arrays are BGR(A)."""
    if arr.ndim == 3:
        arr = np.concatenate([swap_rb(arr[..., :3]), arr[..., 3:]], -1)
    _write(path, arr)


def make_freiburg_train(root: str, n_day: int = 4, n_night: int = 3,
                        hw: Tuple[int, int] = (64, 192), seed: int = 0) -> str:
    """``root/*/*/fl_{rgb,ir_aligned,rgb_labels}/*.png``: day frames under
    ``seq00_day/drive0`` (stamps ``1500000000 + i``), night frames (no
    labels) under ``seq01_night/drive0`` (``1600000000 + i``). Sibling paths
    derive by a full-path replace of ``fl_ir_aligned``, so directories and
    file-name prefixes both follow it."""
    rng = np.random.RandomState(seed)
    h, w = hw
    for i in range(n_day):
        base = os.path.join(root, "seq00_day", "drive0")
        stamp = f"{1500000000 + i}_{i * 1000:09d}.png"
        _write(os.path.join(base, "fl_ir_aligned", "fl_ir_aligned_" + stamp),
               rng.randint(21000, 26000, (h, w)).astype(np.uint16))
        _write_as_cv2(os.path.join(base, "fl_rgb", "fl_rgb_" + stamp),
                      rng.randint(0, 255, (h, w, 3)).astype(np.uint8))
        _write(os.path.join(base, "fl_rgb_labels", "fl_rgb_labels_" + stamp),
               rng.randint(0, 13, (h, w)).astype(np.uint8))
    for i in range(n_night):
        base = os.path.join(root, "seq01_night", "drive0")
        stamp = f"{1600000000 + i}_{i * 1000:09d}.png"
        _write(os.path.join(base, "fl_ir_aligned", "fl_ir_aligned_" + stamp),
               rng.randint(21000, 26000, (h, w)).astype(np.uint16))
        _write_as_cv2(os.path.join(base, "fl_rgb", "fl_rgb_" + stamp),
                      rng.randint(0, 40, (h, w, 3)).astype(np.uint8))
    return root


def make_freiburg_test(root: str, n: int = 2, hw: Tuple[int, int] = (64, 192),
                       seed: int = 1) -> str:
    """``ImagesIR/``, ``ImagesRGB/`` and ``SegmentationClass/*.npy`` (getPaths),
    stamps ``1700000000 + i``."""
    rng = np.random.RandomState(seed)
    h, w = hw
    os.makedirs(os.path.join(root, "SegmentationClass"), exist_ok=True)
    for i in range(n):
        stamp = f"{1700000000 + i}_{i * 100:09d}"
        _write(os.path.join(root, "ImagesIR", f"{stamp}_ir.png"),
               rng.randint(21000, 26000, (h, w)).astype(np.uint16))
        _write_as_cv2(os.path.join(root, "ImagesRGB", f"{stamp}_rgb.png"),
                      rng.randint(0, 255, (h, w, 3)).astype(np.uint8))
        np.save(os.path.join(root, "SegmentationClass", f"{stamp}.npy"),
                rng.randint(0, 13, (h, w)).astype(np.uint8))
    return root


def make_freiburg_infer(root: str, n: int = 2, hw: Tuple[int, int] = (64, 192),
                        seed: int = 2) -> str:
    """A capture tree, ``fl_ir_aligned/`` and ``fl_rgb/`` (stamps
    ``1800000000 + i``)."""
    rng = np.random.RandomState(seed)
    h, w = hw
    for i in range(n):
        stamp = f"{1800000000 + i}_{i * 1000:09d}.png"
        _write(os.path.join(root, "fl_ir_aligned", "fl_ir_aligned_" + stamp),
               rng.randint(21000, 26000, (h, w)).astype(np.uint16))
        _write_as_cv2(os.path.join(root, "fl_rgb", "fl_rgb_" + stamp),
                      rng.randint(0, 255, (h, w, 3)).astype(np.uint8))
    return root


def make_mfnet(root: str, n_train: int = 4, n_test: int = 2,
               hw: Tuple[int, int] = (48, 64), seed: int = 3) -> str:
    """MFNet layout: 4-channel ``images/``, ``labels/``,
    ``labels_from_rgbteacher/``, ``train.txt`` / ``test_day.txt`` /
    ``test_night.txt`` / ``test.txt`` (train names alternate D and N)."""
    rng = np.random.RandomState(seed)
    h, w = hw
    names_train, names_day, names_night = [], [], []
    for i in range(n_train):
        name = f"{i:05d}" + ("D" if i % 2 == 0 else "N")
        _write_as_cv2(os.path.join(root, "images", name + ".png"),
                      rng.randint(0, 255, (h, w, 4)).astype(np.uint8))
        _write(os.path.join(root, "labels", name + ".png"),
               rng.randint(0, 9, (h, w)).astype(np.uint8))
        _write(os.path.join(root, "labels_from_rgbteacher", name + ".png"),
               rng.randint(0, 13, (h, w)).astype(np.uint8))
        names_train.append(name)
    for i in range(n_test):
        for suffix, bucket in (("D", names_day), ("N", names_night)):
            name = f"9{i:04d}{suffix}"
            _write_as_cv2(os.path.join(root, "images", name + ".png"),
                          rng.randint(0, 255, (h, w, 4)).astype(np.uint8))
            _write(os.path.join(root, "labels", name + ".png"),
                   rng.randint(0, 9, (h, w)).astype(np.uint8))
            bucket.append(name)
    for split, names in (("train", names_train), ("test_day", names_day),
                         ("test_night", names_night),
                         ("test", names_day + names_night)):
        with open(os.path.join(root, split + ".txt"), "w") as f:
            f.write("\n".join(names))
    return root


def make_vistas(root: str, n: int = 3, hw: Tuple[int, int] = (48, 96),
                seed: int = 5) -> str:
    """Relabelled-Vistas layout: ``images/`` and ``labels/`` (uint16
    class * 256 PNGs, classes 0-13) and ``paths.txt``."""
    rng = np.random.RandomState(seed)
    h, w = hw
    names = []
    for i in range(n):
        name = f"v{i:05d}"
        _write_as_cv2(os.path.join(root, "images", name + ".png"),
                      rng.randint(0, 255, (h, w, 3)).astype(np.uint8))
        cls = rng.randint(0, 14, (h, w)).astype(np.uint16)
        _write(os.path.join(root, "labels", name + ".png"), cls * 256)
        names.append(name)
    with open(os.path.join(root, "paths.txt"), "w") as f:
        f.write("\n".join(names))
    return root


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
