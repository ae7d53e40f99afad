"""Synthetic Freiburg, KAIST, MFNet, BDD, Vistas and drive-dump trees in the
reference layouts.

The port's copies of ``heatnet_tpu/data/synthetic.py`` (``make_freiburg_train``,
``make_freiburg_test``, ``make_freiburg_infer``, ``make_mfnet``,
``make_bdd``, ``make_vistas``, ``make_kaist``, ``make_drive_dump``,
``make_vistas_borders``), written with ``data.png.write_png`` instead of
cv2. All but ``make_kaist`` and ``make_bdd`` write the JAX copies' files:
the same draws in the same order, colour frames stored as cv2 stores the
arrays it is given (BGR(A) in, so R and B swap on disk). Their ``.jpg``
files hold PNG bytes (the JAX copy's cv2 writes JPEGs there, whose decoded
pixels are not the drawn ones); PIL, cv2 and the port's
``KAISTCycleGANDataset`` decode by content, so a tree written here needs no
JPEG decoder. The loaders' globs run for real.
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


def make_bdd(root: str, n: int = 2, hw: Tuple[int, int] = (48, 96),
             seed: int = 4) -> str:
    """BDD night validation layout: ``images/val/*.jpg`` (PNG bytes),
    ``labels/val/*_train_id.png`` (0-18, one 255) and ``bdd_night.txt``."""
    rng = np.random.RandomState(seed)
    h, w = hw
    names = []
    for i in range(n):
        name = f"bdd{i:04d}"
        _write_as_cv2(os.path.join(root, "images", "val", name + ".jpg"),
                      rng.randint(0, 255, (h, w, 3)).astype(np.uint8))
        lbl = rng.randint(0, 19, (h, w)).astype(np.uint8)
        lbl[0, 0] = 255
        _write(os.path.join(root, "labels", "val", name + "_train_id.png"), lbl)
        names.append(name)
    with open(os.path.join(root, "bdd_night.txt"), "w") as f:
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


def make_drive_dump(root: str, n_drives: int = 2, n_bursts: int = 2,
                    burst: int = 2, hw: Tuple[int, int] = (48, 64),
                    seed: int = 7) -> str:
    """Raw-dump drive layout for ``ThermalDriveDataset``
    (data/thermal_loader.py:46-152): per-drive ``{fl,fr}_{rgb,ir}`` frame
    dirs plus ``*_drive_*.txt`` lists of space-separated burst paths; also
    fl_ir_aligned/ siblings for the load_aligned_ir remap."""
    rng = np.random.RandomState(seed)
    h, w = hw
    for d in range(n_drives):
        base = os.path.join(root, f"drive_{d:02d}")
        lists = {k: [] for k in ("fl_rgb", "fr_rgb", "fl_ir", "fr_ir")}
        for b in range(n_bursts):
            for k in lists:
                paths = []
                for j in range(burst):
                    p = os.path.join(base, k, f"{k}_{d}{b}{j:07d}.png")
                    if "rgb" in k:
                        _write_as_cv2(p, rng.randint(0, 255, (h, w, 3)).astype(np.uint8))
                    else:
                        _write(p, rng.randint(21000, 26000, (h, w)).astype(np.uint16))
                    paths.append(p)
                lists[k].append(" ".join(paths))
            for j in range(burst):  # the aligned sibling of fl_ir
                _write(os.path.join(base, "fl_ir_aligned", f"fl_ir_aligned_{d}{b}{j:07d}.png"),
                       rng.randint(21000, 26000, (h, w)).astype(np.uint16))
        for k, lines in lists.items():
            with open(os.path.join(base, f"{k}_drive_{d:02d}.txt"), "w") as f:
                f.write("\n".join(lines))
    return root


def make_vistas_borders(root: str, n: int = 3, hw: Tuple[int, int] = (64, 96),
                        seed: int = 8) -> str:
    """Borders-augmented Vistas layout for ``VistasBordersDataset``
    (data/vistas_borders_dataset.py:55-66): a paths.txt with 4 paths per
    line (borders, trainIds as class*256+instance, image, dt); returns its
    path."""
    rng = np.random.RandomState(seed)
    h, w = hw
    lines = []
    for i in range(n):
        name = f"b{i:05d}"
        bp = os.path.join(root, "borders", name + ".png")
        _write(bp, (rng.rand(h, w) > 0.9).astype(np.uint8))
        ip = os.path.join(root, "ids", name + ".png")
        _write(ip, (rng.randint(0, 12, (h, w)) * 256
                    + rng.randint(0, 5, (h, w))).astype(np.uint16))
        mp = os.path.join(root, "images", name + ".png")
        _write_as_cv2(mp, rng.randint(0, 255, (h, w, 3)).astype(np.uint8))
        dp = os.path.join(root, "dt", name + ".png")
        _write(dp, rng.randint(0, 255, (h, w)).astype(np.uint8))
        lines.append(" ".join([bp, ip, mp, dp]))
    path_file = os.path.join(root, "paths.txt")
    with open(path_file, "w") as f:
        f.write("\n".join(lines))
    return path_file
