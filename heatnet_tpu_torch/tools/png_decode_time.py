"""Time ``data.png.read_png`` on PNGs whose rows carry each filter type.

libpng (cv2's and PIL's writer) picks a filter per row; Average and Paeth
rows are the slow ones for a numpy decoder (``data/png.py``). This script
encodes seeded frames at the eval geometries with every row set to one
filter, and with libpng's own heuristic (per row, the filter whose bytes
have the least sum of absolute values as signed bytes), then times the
decode, and ``cv2.imread`` where cv2 imports. Last, the eval loader's
frames/s (decode, resize, crop) on a tree of Freiburg-sized frames as libpng
would store them, on 1 and 8 threads. One process, host clock, median of
``--reps``. Prints one JSON line.

    python -m heatnet_tpu_torch.tools.png_decode_time [--reps 3] [--frames 16]
"""

from __future__ import annotations

import argparse
import json
import os
import struct
import tempfile
import time
import zlib

import numpy as np

from ..data.loaders import FreiburgThermalTestDataset, get_test_paths, prefetch_items
from ..data.png import _SIGNATURE, _chunk, read_png

FILTERS = ("none", "sub", "up", "average", "paeth")
# (name, shape, dtype): Freiburg RGB and IR as stored, MFNet's RGBA, and the
# loaders' 960x320 frames
FRAMES = (("rgb_650x1920", (650, 1920, 3), np.uint8),
          ("ir16_650x1920", (650, 1920), np.uint16),
          ("rgba_480x640", (480, 640, 4), np.uint8),
          ("rgb_320x960", (320, 960, 3), np.uint8))


def _frame(shape, dtype, rng) -> np.ndarray:
    """A smooth field plus sensor noise, as camera frames are."""
    h, w = shape[:2]
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    field = 0.5 + 0.25 * np.sin(xx / 37.0) * np.cos(yy / 23.0) + 0.1 * (xx / w)
    if len(shape) == 3:
        field = np.stack([field * (0.8 + 0.1 * k) for k in range(shape[2])], axis=-1)
    top = np.iinfo(dtype).max
    noise = rng.normal(0, 0.01, field.shape)
    return (np.clip(field + noise, 0, 1) * top).astype(dtype)


def _filtered_rows(img: np.ndarray) -> np.ndarray:
    """(5, H, 1 + row bytes): each row of ``img`` under each filter type."""
    rows = (img.astype(">u2") if img.dtype == np.uint16 else img)
    h = img.shape[0]
    x = np.ascontiguousarray(rows).view(np.uint8).reshape(h, -1).astype(np.int16)
    bpp = x.shape[1] // img.shape[1]
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    da, db = b - c, a - c
    pa, pb, pc = np.abs(da), np.abs(db), np.abs(da + db)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = (np.zeros_like(x), a, b, (a + b) >> 1, paeth)
    out = np.empty((5, h, 1 + x.shape[1]), np.uint8)
    for k, p in enumerate(preds):
        out[k, :, 0] = k
        out[k, :, 1:] = (x - p) & 0xFF
    return out


def write_filtered(path: str, img: np.ndarray, choice: str) -> list:
    """Write ``img`` (uint8 grey/RGB/RGBA or uint16 grey) with every row
    under ``choice`` (a filter name, or ``adaptive``); returns the number of
    rows of each filter type."""
    rows = _filtered_rows(img)
    if choice == "adaptive":
        cost = np.abs(rows[:, :, 1:].view(np.int8).astype(np.int32)).sum(-1)  # (5, H)
        raw = rows[cost.argmin(0), np.arange(img.shape[0])]
    else:
        raw = rows[FILTERS.index(choice)]
    channels = 1 if img.ndim == 2 else img.shape[2]
    depth = 16 if img.dtype == np.uint16 else 8
    colour = {1: 0, 3: 2, 4: 6}[channels]
    with open(path, "wb") as fh:
        fh.write(_SIGNATURE)
        fh.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", img.shape[1], img.shape[0],
                                             depth, colour, 0, 0, 0)))
        fh.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        fh.write(_chunk(b"IEND", b""))
    return np.bincount(raw[:, 0], minlength=5).tolist()


def _median_ms(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--frames", type=int, default=16,
                   help="frames of the loader tree timed through prefetch_items")
    args = p.parse_args(argv)
    try:
        import cv2
    except ImportError:
        cv2 = None
    rng = np.random.RandomState(0)
    result = {"cv2": None if cv2 is None else cv2.__version__, "ms": {}}
    with tempfile.TemporaryDirectory() as d:
        for name, shape, dtype in FRAMES:
            img = _frame(shape, dtype, rng)
            for choice in FILTERS + ("adaptive",):
                path = os.path.join(d, f"{name}_{choice}.png")
                kinds = write_filtered(path, img, choice)
                if not np.array_equal(read_png(path), img):
                    raise AssertionError(f"{name} {choice}: decode differs from the frame")
                row = {"read_png": _median_ms(lambda: read_png(path), args.reps)}
                if cv2 is not None:
                    row["cv2"] = _median_ms(
                        lambda: cv2.imread(path, cv2.IMREAD_UNCHANGED), args.reps)
                if choice == "adaptive":
                    row["row_filters"] = kinds
                result["ms"][f"{name}/{choice}"] = row
                print(f"{name:14s} {choice:9s} " + " ".join(
                    f"{k} {v}" if k == "row_filters" else f"{k} {v:.2f} ms"
                    for k, v in row.items()), flush=True)
        result["loader_frames_per_s"] = _loader_rate(d, rng, args.frames)
    print(json.dumps(result), flush=True)
    return result


def _loader_rate(d: str, rng, n: int) -> dict:
    """Frames/s of ``FreiburgThermalTestDataset`` through ``prefetch_items``
    (decode, resize to 960x320, crop) on a tree of ``n`` 650x1920 frames as
    stored, every file under libpng's filter heuristic, on 1 and 8 threads."""
    for sub in ("ImagesRGB", "ImagesIR", "SegmentationClass"):
        os.makedirs(os.path.join(d, "tree", sub))
    for i in range(n):
        stamp = os.path.join(d, "tree", "{}", f"{1700000000 + i}_{i:09d}")
        write_filtered(stamp.format("ImagesRGB") + "_rgb.png",
                       _frame((650, 1920, 3), np.uint8, rng), "adaptive")
        write_filtered(stamp.format("ImagesIR") + "_ir.png",
                       _frame((650, 1920), np.uint16, rng), "adaptive")
        np.save(stamp.format("SegmentationClass") + ".npy",
                rng.randint(0, 14, (650, 1920)).astype(np.uint8))
    ds = FreiburgThermalTestDataset(*get_test_paths([os.path.join(d, "tree")]))
    rates = {}
    for workers in (1, 8):
        t0 = time.perf_counter()
        got = sum(1 for _ in prefetch_items(ds, workers=workers))
        rates[f"{workers}_threads"] = got / (time.perf_counter() - t0)
        print(f"FreiburgThermalTestDataset, {n} frames 650x1920 (adaptive filters), "
              f"{workers} thread(s): {rates[f'{workers}_threads']:.2f} frames/s", flush=True)
    return rates


if __name__ == "__main__":
    main()
