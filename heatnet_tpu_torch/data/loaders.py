"""Eval loaders of PNG trees, training batches, and the augmentation on the card.

Counterpart of ``heatnet_tpu/data/loaders.py:43-339,386-591,936-983``.

The Freiburg training trees (``FreiburgThermalDataset``, with
``sort_day_night``, ``holdout_split``, ``filter_test_data`` and
``open_freiburg_train``, which also opens train packs) decode and resize on
the host as the JAX loader does; ``holdout_split`` is sklearn's split in
numpy.

The eval loaders (``FreiburgThermalTestDataset``, ``FreiburgInferDataset``,
``MFNetDataset``, ``BDDValDataset``) return the JAX loaders' items: same
keys, dtypes and shapes. They decode PNGs with ``data.png`` and resize with
``resize``, a numpy copy of ``cv2.resize`` as the JAX loaders call it, so
that the port does not depend on cv2. Only ``BDDValDataset`` needs cv2, for
JPEG. ``KAISTCycleGANDataset`` reads PNGs the same way and resizes with
``resize_pil``, a numpy copy of Pillow's resampling as the JAX loader calls
it; only a JPEG (KAIST's own frames) goes to PIL.

The training loaders of PNG trees, ``VistasDataset`` (Vistas pretraining,
its whole augmentation on the host, as in JAX) and ``MFNetTrainDataset``
(decode and resize; the augmentation runs on the device), draw from a numpy
``RandomState`` and give the JAX loaders' items for the same seed. Each
splits ``__getitem__`` into ``draw(index)``, which takes the item's random
draws in the JAX loader's order, and ``load(index, draws)``, which decodes
and transforms: ``batch_iterator(workers=n)`` draws in order and decodes
on threads. The cv2 calls of the Vistas chain are numpy copies here
(``resize_and_pad``, ``copy_make_border``, ``rgb_to_hsv``/``hsv_to_rgb``,
``get_rotation_matrix_2d``, ``warp_affine``, ``swap_rb``).

``MFHarnessTrainDataset`` (the MFNet harness's train split) decodes,
applies ``data/mf_augment.py``'s transforms and resizes on the host, as the
JAX loader does; its draws come from the transforms' own ``RandomState``s.

``ThermalDriveDataset`` (the raw capture dumps of ``cli/dump_capture.py``)
reads its bursts with ``imread_bgr`` and ``imread_grayscale``, copies of
``cv2.imread``'s colour and greyscale decodes of a PNG.

``batch_iterator`` and ``prefetch_items`` are copies (numpy and threads).
``DeviceAugment`` moves a raw batch to the device and runs
``ops.preprocess.train_sample_preprocess`` (or, for MFNet,
``mf_train_sample_preprocess``) over it, batched, with every sample's
random parameters drawn from the caller's ``torch.Generator`` (the JAX
version vmaps the chain over per-sample keys).
"""

from __future__ import annotations

import dataclasses
import fnmatch
import math
import os
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from glob import glob
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve
from ..parallel.mesh import shard_batch
from ..ops.preprocess import (TRAIN_WINDOW, draw_train_params,
                              mf_train_sample_preprocess, train_sample_preprocess)
from .clahe import apply_clahe
from .png import _SIGNATURE as _PNG_SIGNATURE
from .png import png_size, read_png, read_png_palette

IR_RES = (960, 320)  # (W, H), thermal_loader.py:622
_COEF_BITS = 11      # cv2's INTER_RESIZE_COEF_BITS


def _scale(n_in: int, n_out: int) -> float:
    return 1.0 / (n_out / n_in)  # cv2's 1/inv_scale, which can round off in/out


def _linear_taps(n_in: int, n_out: int, fraction_in_float32: bool):
    """Source index and fraction per output position, half-pixel centres
    (``cv2.resize``'s INTER_LINEAR); the fraction is taken in float32 (its
    fixed-point path) or in float64 (its 16-bit path)."""
    f = (np.arange(n_out) + 0.5) * _scale(n_in, n_out) - 0.5
    if fraction_in_float32:
        f = f.astype(np.float32)
    s = np.floor(f).astype(np.intp)
    return s, (f - s).astype(np.float32)


def resize(img: np.ndarray, wh: Tuple[int, int], nearest: bool = False) -> np.ndarray:
    """``cv2.resize(img, wh, interpolation=INTER_NEAREST if nearest else
    INTER_LINEAR)`` for (H, W) or (H, W, C) images, in numpy.

    NEAREST (any dtype): ``src = floor(dst / (out / in))``. LINEAR on uint8:
    cv2's fixed-point path (11-bit coefficients; an integer horizontal sum;
    the vertical sum as its SIMD rows compute it), equal to cv2 on every
    shape measured. LINEAR on uint16: float32 coefficients and sums, rounded
    half to even; cv2 breaks exact ties another way on a few pixels (at most
    1 count; tests/test_torch_png.py states the shares). A resize to the
    same size is a copy.
    """
    w_out, h_out = wh
    h, w = img.shape[:2]
    if (w, h) == (w_out, h_out):
        return img.copy()
    if nearest:
        ys = np.minimum(np.floor(np.arange(h_out) * _scale(h, h_out)).astype(np.intp), h - 1)
        xs = np.minimum(np.floor(np.arange(w_out) * _scale(w, w_out)).astype(np.intp), w - 1)
        return img[ys[:, None], xs[None, :]]
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"linear resize of {img.dtype} is not supported (uint8, uint16)")
    fixed = img.dtype == np.uint8
    sx, fx = _linear_taps(w, w_out, fixed)
    sy, fy = _linear_taps(h, h_out, fixed)
    # columns clamp with a zero fraction at the borders; rows clamp their index only
    low, high = sx < 0, sx >= w - 1
    fx[low | high] = 0
    sx = np.clip(sx, 0, w - 1)
    x1 = np.minimum(sx + 1, w - 1)
    y0, y1 = np.clip(sy, 0, h - 1), np.clip(sy + 1, 0, h - 1)
    src = img if img.ndim == 3 else img[..., None]
    if fixed:
        one = 1 << _COEF_BITS
        a1 = np.rint(fx * one).astype(np.int32)
        b1 = np.rint(fy * one).astype(np.int32)
        a0, b0 = one - a1, one - b1
        s = src.astype(np.int32)
        rows = s[:, sx] * a0[None, :, None] + s[:, x1] * a1[None, :, None]
        out = ((((rows[y0] >> 4) * b0[:, None, None]) >> 16)
               + (((rows[y1] >> 4) * b1[:, None, None]) >> 16) + 2) >> 2
        out = np.clip(out, 0, 255)
    else:
        a0, b0 = np.float32(1) - fx, np.float32(1) - fy
        s = src.astype(np.float32)
        rows = s[:, sx] * a0[None, :, None] + s[:, x1] * fx[None, :, None]
        out = rows[y0] * b0[:, None, None] + rows[y1] * fy[:, None, None]
        out = np.clip(np.rint(out), 0, 65535)
    return out.astype(img.dtype).reshape((h_out, w_out) + img.shape[2:])


# ---------------------------------------------------------------------------
# cv2's border, colour and affine-warp calls of the Vistas chain, in numpy
# ---------------------------------------------------------------------------

def swap_rb(img: np.ndarray) -> np.ndarray:
    """``COLOR_BGR2RGB`` and ``COLOR_RGB2BGR``: the channel order reversed."""
    return np.ascontiguousarray(img[..., ::-1])


def copy_make_border(img: np.ndarray, top: int, bottom: int, left: int, right: int,
                     value) -> np.ndarray:
    """``cv2.copyMakeBorder(..., BORDER_CONSTANT, value=value)``: ``value``
    is a scalar or one entry per channel."""
    if min(top, bottom, left, right) < 0:
        raise ValueError(f"negative border {(top, bottom, left, right)}")
    h, w = img.shape[:2]
    out = np.empty((h + top + bottom, w + left + right) + img.shape[2:], img.dtype)
    out[...] = np.asarray(value, img.dtype)
    out[top:top + h, left:left + w] = img
    return out


def resize_and_pad(img: np.ndarray, size: Tuple[int, int], pad_color=11,
                   nearest: bool = False) -> np.ndarray:
    """Aspect-preserving resize to width ``size[1]``, then constant rows
    above and below up to height ``size[0]`` (vistas_dataset.py:13-36,
    ``heatnet_tpu/data/loaders.py:599-616``); like the reference it handles
    frames wider than the target only."""
    h, w = img.shape[:2]
    sh, sw = size
    aspect = w / h
    new_w = sw
    new_h = int(np.round(new_w / aspect))
    pad_vert = (sh - new_h) / 2
    pad_top, pad_bot = int(np.floor(pad_vert)), int(np.ceil(pad_vert))
    if img.ndim == 3 and not isinstance(pad_color, (list, tuple, np.ndarray)):
        pad_color = [pad_color] * 3
    scaled = resize(img, (new_w, new_h), nearest=nearest)
    return copy_make_border(scaled, pad_top, pad_bot, 0, 0, pad_color)


# cv2's RGB2HSV_b tables: 12 fractional bits, saturate_cast (round half to even)
_HSV_SHIFT = 12
_SDIV = np.r_[0, np.rint((255 << _HSV_SHIFT) / np.arange(1, 256.0))].astype(np.int64)
_HDIV180 = np.r_[0, np.rint((180 << _HSV_SHIFT) / (6.0 * np.arange(1, 256.0)))].astype(np.int64)
# HSV2RGB's sectors: which of (v, p, q, t) each of b, g, r takes
_HSV_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, COLOR_RGB2HSV)`` of uint8 RGB: H in [0, 180),
    cv2's integer arithmetic with its division tables."""
    c = img.astype(np.int64)
    r, g, b = c[..., 0], c[..., 1], c[..., 2]
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV180[diff] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], -1).astype(np.uint8)


def _fma32(a, b, c) -> np.ndarray:
    """``a * b + c`` of float32 values rounded once to float32, as a fused
    multiply-add: the float64 product of two float32 values is exact."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


# cv2's HSV2RGB_b loop takes 32 pixels of a row per vector step (8 float
# lanes x 4) and the rest of the row one by one
_HSV_VECTOR_STEP = 32


def hsv_to_rgb(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, COLOR_HSV2RGB)`` of uint8 (H, W, 3) HSV with H in
    [0, 180): cv2's float32 arithmetic (S and V times 1/255, H times 6/180,
    the sector's ``v * (1 - s * f)`` terms with fused multiply-adds, times
    255). Its vector loop truncates to uint8 and covers each row's first
    multiple of 32 pixels; the row's last ``W % 32`` pixels, done one by
    one, round half to even."""
    f32 = np.float32
    h = img[..., 0].astype(f32) * f32(6.0 / 180)
    s = img[..., 1].astype(f32) * f32(1.0 / 255.0)
    v = img[..., 2].astype(f32) * f32(1.0 / 255.0)
    pre = np.trunc(h)
    frac = h - pre
    sector = (pre - np.trunc(pre * f32(1.0 / 6.0)) * f32(6.0)).astype(np.intp)
    one = np.ones_like(s)
    tab = np.stack([v, v * (one - s), v * _fma32(-s, frac, one),
                    v * _fma32(-s, one - frac, one)], -1)
    b, g, r = (np.take_along_axis(tab, _HSV_SECTORS[sector, k][..., None], -1)[..., 0]
               for k in range(3))
    rgb = np.stack([r, g, b], -1) * f32(255.0)
    w = img.shape[1]
    vector = np.arange(w) < w // _HSV_VECTOR_STEP * _HSV_VECTOR_STEP
    rgb = np.where(vector[:, None], np.trunc(rgb), np.rint(rgb))
    return np.clip(rgb, 0, 255).astype(np.uint8)


def get_rotation_matrix_2d(center: Tuple[float, float], angle: float,
                           scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: the centre as float32 (cv2's Point2f),
    the matrix in float64."""
    cx, cy = (float(np.float32(c)) for c in center)
    a = np.deg2rad(angle)
    alpha, beta = np.cos(a) * scale, np.sin(a) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _invert_affine(m: np.ndarray) -> np.ndarray:
    """cv2's inverse of a 2x3 affine map, in float64 (``warpAffine`` without
    ``WARP_INVERSE_MAP``)."""
    m = np.asarray(m, np.float64).ravel().copy()
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, -m[1] * d, -m[3] * d, a22
    m[2], m[5] = -m[0] * m[2] - m[1] * m[5], -m[3] * m[2] - m[4] * m[5]
    return m


_WARP_VECTOR_STEP = 16  # pixels of a row per step of cv2's warpAffine vector loop


def warp_affine(img: np.ndarray, m: np.ndarray, wh: Tuple[int, int],
                nearest: bool = False) -> np.ndarray:
    """``cv2.warpAffine(img, m, wh, flags=INTER_NEAREST if nearest else
    INTER_LINEAR)`` of a uint8 (H, W) or (H, W, C) image, border constant 0.

    cv2 5's float kernels: the inverse map in float32, source coordinates
    ``fma(x, m0, y * m1 + m2)`` in its vector loop (each row's first
    multiple of 16 pixels) and ``fma(x, m0, y * m1) + m2`` in the row's
    tail; NEAREST rounds them half to even; LINEAR takes the four
    neighbours (0 outside the frame) and interpolates as ``fma(a, p1 - p0,
    p0)`` along x, then along y, rounded half to even. Older cv2 (before
    4.11) took fixed-point coordinates in 1/32 pixel instead; the two differ
    on a few pixels per frame.
    """
    if img.dtype != np.uint8:
        raise ValueError(f"warp_affine takes uint8 images, got {img.dtype}")
    w_out, h_out = wh
    h, w = img.shape[:2]
    mi = _invert_affine(m).astype(np.float32)
    x = np.arange(w_out, dtype=np.float32)[None, :]
    y = np.arange(h_out, dtype=np.float32)[:, None]
    vector = x < w_out // _WARP_VECTOR_STEP * _WARP_VECTOR_STEP
    sx = np.where(vector, _fma32(x, mi[0], y * mi[1] + mi[2]),
                  _fma32(x, mi[0], y * mi[1]) + mi[2])
    sy = np.where(vector, _fma32(x, mi[3], y * mi[4] + mi[5]),
                  _fma32(x, mi[3], y * mi[4]) + mi[5])
    src = img if img.ndim == 3 else img[..., None]

    def tap(xi, yi):
        inside = ((xi >= 0) & (xi < w) & (yi >= 0) & (yi < h))[..., None]
        return np.where(inside, src[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)], 0)

    if nearest:
        out = tap(np.rint(sx).astype(np.intp), np.rint(sy).astype(np.intp))
    else:
        x0, y0 = np.floor(sx), np.floor(sy)
        a, b = (sx - x0)[..., None], (sy - y0)[..., None]
        x0, y0 = x0.astype(np.intp), y0.astype(np.intp)
        p00, p01 = tap(x0, y0).astype(np.float32), tap(x0 + 1, y0).astype(np.float32)
        p10, p11 = tap(x0, y0 + 1).astype(np.float32), tap(x0 + 1, y0 + 1).astype(np.float32)
        top, bot = _fma32(a, p01 - p00, p00), _fma32(a, p11 - p10, p10)
        out = np.clip(np.rint(_fma32(b, bot - top, top)), 0, 255)
    return out.astype(np.uint8).reshape((h_out, w_out) + img.shape[2:])


def _imread_rgb(path: str) -> np.ndarray:
    """An 8-bit RGB(A) PNG as RGB, as ``cv2.cvtColor(cv2.imread(path),
    COLOR_BGR2RGB)`` reads it (alpha dropped)."""
    img = read_png(path)
    if img.ndim != 3 or img.dtype != np.uint8:
        raise ValueError(f"{path}: expected an 8-bit colour PNG, got {img.dtype} {img.shape}")
    return np.ascontiguousarray(img[..., :3])


def _imread_grey(path: str, dtype) -> np.ndarray:
    """A single-channel PNG of ``dtype``, as ``cv2.IMREAD_ANYDEPTH`` (IR) or
    ``cv2.IMREAD_GRAYSCALE`` (labels) reads it."""
    img = read_png(path)
    if img.ndim != 2 or img.dtype != dtype:
        raise ValueError(f"{path}: expected a single-channel {np.dtype(dtype)} PNG, "
                         f"got {img.dtype} {img.shape}")
    return img


# libpng's png_set_rgb_to_gray(0.299, 0.587) coefficients, 15-bit and
# truncated as libpng truncates them; blue takes the rest of 2^15
_GREY_R, _GREY_G = 29900 * 32768 // 100000, 58700 * 32768 // 100000
_GREY_B = 32768 - _GREY_R - _GREY_G


def imread_grayscale(path: str, any_depth: bool = False) -> np.ndarray:
    """``cv2.imread(path, IMREAD_GRAYSCALE)`` (or ``IMREAD_ANYDEPTH``) of a
    PNG, as cv2 5.0 decodes it through libpng: grey as stored (16-bit to 8
    by ``>> 8`` unless ``any_depth``), 8-bit colour (palette entries, RGB,
    RGBA with its alpha dropped) by libpng's truncating ``rgb_to_gray``,
    ``(9797 R + 19234 G + 3737 B) >> 15``. 16-bit colour is not supported;
    a file that is not a PNG (a JPEG) raises, since the port has no JPEG
    decoder."""
    img, palette = read_png_palette(path)
    if palette is not None:
        img = palette[img]
    if img.ndim == 2:
        return img if (any_depth or img.dtype == np.uint8) else (img >> 8).astype(np.uint8)
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: 16-bit colour PNGs are not supported")
    rgb = img[..., :3].astype(np.int32)
    return ((_GREY_R * rgb[..., 0] + _GREY_G * rgb[..., 1] + _GREY_B * rgb[..., 2])
            >> 15).astype(np.uint8)


def imread_bgr(path: str) -> np.ndarray:
    """``cv2.imread(path)`` (IMREAD_COLOR) of an 8-bit PNG: BGR, alpha
    dropped, grey repeated over the three channels."""
    img, palette = read_png_palette(path)
    if palette is not None:
        img = palette[img]
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: expected an 8-bit PNG, got {img.dtype}")
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    return np.ascontiguousarray(img[..., 2::-1])


def stamp_sort_key(path: str) -> float:
    """Timestamp sort key (stampSortFun, thermal_loader.py:80-90)."""
    digits = []
    for s in os.path.basename(path).split("_"):
        fn = s.replace(".png", "")
        if fn.isdigit():
            digits.append(int(fn))
    return float(str(digits[0]).zfill(10) + "." + str(digits[1]).zfill(10))


def sort_day_night(fl_ir_files: Sequence[str]):
    """Split an aligned-IR file list into labelled day and night sets
    (sort_day_night, thermal_loader.py:105-150). Sibling paths come from a
    replace over the full path, so directories and file names both follow
    the ``fl_ir_aligned`` / ``fl_rgb`` / ``fl_rgb_labels`` convention."""
    day_rgb, day_ir, day_label = [], [], []
    night_rgb, night_ir = [], []
    for ir_file in fl_ir_files:
        rgb_file = ir_file.replace("fl_ir_aligned", "fl_rgb")
        label_file = ir_file.replace("fl_ir_aligned", "fl_rgb_labels")
        if not os.path.exists(rgb_file):
            continue
        if "night" in ir_file:
            night_rgb.append(rgb_file)
            night_ir.append(ir_file)
        else:
            if not os.path.exists(label_file):
                continue
            day_rgb.append(rgb_file)
            day_ir.append(ir_file)
            day_label.append(label_file)
    return day_rgb, day_ir, day_label, night_rgb, night_ir


def holdout_split(items: Sequence[list], test_size: float = 0.01, seed: int = 42):
    """sklearn's ``train_test_split(idx, test_size=0.01, random_state=42)``
    (thermal_loader.py:525-540) applied to parallel lists, in numpy: the
    permutation of ``RandomState(seed)``, its first ``ceil(test_size * n)``
    indices the test side and the rest the train side. An empty train side
    raises ``ValueError``, as sklearn does."""
    n = len(items[0])
    n_test = math.ceil(test_size * n)
    if n - n_test <= 0:
        raise ValueError(f"With n_samples={n}, test_size={test_size} and "
                         "train_size=None, the resulting train set will be empty. "
                         "Adjust any of the aforementioned parameters.")
    perm = np.random.RandomState(seed).permutation(n)
    test_idx, train_idx = perm[:n_test], perm[n_test:]
    return ([[lst[i] for i in train_idx] for lst in items],
            [[lst[i] for i in test_idx] for lst in items])


def filter_test_data(paths: Sequence[str], stamps) -> List[str]:
    """Exclude the files whose (sec, nsec) stamp is in ``stamps``.

    The reference (thermal_loader.py:60-78) keeps a file that mismatches
    any stamp, so it filters nothing; the JAX package excludes the exact
    matches, and so does this copy. The stamp is the first two digit
    tokens of the file name with ``.`` read as ``_``."""
    stamp_set = {tuple(t) for t in stamps}
    out = []
    for p in paths:
        digits = [int(s) for s in
                  os.path.basename(p).replace(".", "_").split("_") if s.isdigit()]
        if len(digits) >= 2 and (digits[0], digits[1]) in stamp_set:
            continue
        out.append(p)
    return out


class FreiburgThermalDataset:
    """Freiburg Thermal training items from a PNG tree (ThermalDataLoader,
    :501-746): a labelled day frame and a night frame drawn at random,
    decoded and resized to 960x320 (IR and RGB linearly, labels nearest).

    The tree is ``db_path/*/*/fl_ir_aligned/*.png`` with ``fl_rgb`` and
    ``fl_rgb_labels`` siblings; frames whose path holds ``night`` are night
    frames. The test stamps are filtered out, the day and night sets split
    1 % / 99 % (``holdout_split``), and ``split`` picks a side. Each
    ``__getitem__`` draws its night frame from a ``RandomState(seed)``
    stream, once per call in call order, as ``PackedFreiburgTrainDataset``
    does: a pack of the same tree gives the same items.
    """

    def __init__(self, db_path: str, split: str = "train", test_stamps=None,
                 seed: int = 0):
        fl_ir_files = sorted(glob(os.path.join(db_path, "*/*/fl_ir_aligned/*.png")))
        if test_stamps:
            fl_ir_files = filter_test_data(fl_ir_files, test_stamps)
        day_rgb, day_ir, day_label, night_rgb, night_ir = sort_day_night(fl_ir_files)
        if not day_rgb or not night_rgb:
            raise FileNotFoundError(
                f"no Freiburg Thermal data under {db_path!r}: found "
                f"{len(fl_ir_files)} aligned-IR files, {len(day_rgb)} labeled "
                f"day pairs, {len(night_rgb)} night pairs (expected "
                "*/*/fl_ir_aligned/*.png with fl_rgb/fl_rgb_labels siblings)")
        day_train, day_test = holdout_split([day_rgb, day_ir, day_label])
        night_train, night_test = holdout_split([night_rgb, night_ir])
        if split == "train":
            day, night = day_train, night_train
        elif split == "test":
            day, night = day_test, night_test
        else:
            raise ValueError(f"unknown split {split}")
        self.rgb_day_files, self.ir_day_files, self.label_day_files = day
        self.rgb_night_files, self.ir_night_files = night
        self._rng = np.random.RandomState(seed)
        if not self.rgb_day_files or not self.rgb_night_files:
            raise FileNotFoundError(
                f"no day/night pairs under {db_path} (found "
                f"{len(self.rgb_day_files)} day, {len(self.rgb_night_files)} night)")

    def __len__(self) -> int:
        return len(self.rgb_day_files)

    @staticmethod
    def read_day(rgb_path: str, ir_path: str, label_path: str):
        """One day frame: RGB, IR and labels at 960x320."""
        return (resize(_imread_rgb(rgb_path), IR_RES),
                resize(_imread_grey(ir_path, np.uint16), IR_RES),
                resize(_imread_grey(label_path, np.uint8), IR_RES, nearest=True))

    @staticmethod
    def read_night(rgb_path: str, ir_path: str):
        """One night frame: RGB and IR at 960x320."""
        return (resize(_imread_rgb(rgb_path), IR_RES),
                resize(_imread_grey(ir_path, np.uint16), IR_RES))

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        rand_idx = self._rng.randint(0, len(self.rgb_night_files))
        rgb_day, ir_day, label_day = self.read_day(
            self.rgb_day_files[index], self.ir_day_files[index],
            self.label_day_files[index])
        rgb_night, ir_night = self.read_night(self.rgb_night_files[rand_idx],
                                              self.ir_night_files[rand_idx])
        return {"rgb_day": rgb_day, "ir_day": ir_day, "label_day": label_day,
                "rgb_night": rgb_night, "ir_night": ir_night}


def open_freiburg_train(db_path: str, split: str = "train", test_stamps=None,
                        seed: int = 0):
    """A train pack (``cli/pack_frames.py --train``) as
    ``PackedFreiburgTrainDataset``, else the PNG tree as
    ``FreiburgThermalDataset`` (``heatnet_tpu/data/loaders.py:159-194``).
    Every Freiburg trainer opens its data here.

    A pack's choices are held against the caller's: a pack of another
    ``split``, or one packed without test-stamp filtering while
    ``test_stamps`` are given, would train on eval frames, and raises.
    """
    import json

    from .packed import PackedFreiburgTrainDataset, is_train_pack_dir

    if is_train_pack_dir(db_path):
        with open(os.path.join(db_path, "meta.json")) as f:
            meta = json.load(f)
        if meta.get("split", "train") != split:
            raise ValueError(
                f"train pack {db_path} was packed with split="
                f"{meta.get('split', 'train')!r} but split={split!r} was "
                f"requested; re-pack with cli/pack_frames.py --split {split}")
        if test_stamps is not None and len(test_stamps) > 0 \
                and not meta.get("test_stamps_filtered", False):
            raise ValueError(
                f"train pack {db_path} was packed WITHOUT test-stamp "
                "filtering but --testroot_* test stamps were passed; "
                "training on it would include eval frames. Re-pack with "
                "cli/pack_frames.py --testroot_day/--testroot_night")
        return PackedFreiburgTrainDataset(db_path, seed=seed)
    return FreiburgThermalDataset(db_path, split=split, test_stamps=test_stamps,
                                  seed=seed)


def get_test_paths(db_paths: Sequence[str]):
    """ImagesIR/ImagesRGB/SegmentationClass discovery (getPaths,
    train_trgb_segnet_conf.py:22-30)."""
    ir_files, rgb_files, label_files = [], [], []
    for d in db_paths:
        ir_files.extend(sorted(glob(os.path.join(d, "ImagesIR/*_ir.png"))))
        rgb_files.extend(sorted(glob(os.path.join(d, "ImagesRGB/*_rgb.png"))))
        label_files.extend(sorted(glob(os.path.join(d, "SegmentationClass/*.npy"))))
    return ir_files, rgb_files, label_files


def get_test_stamps(label_files: Sequence[str]):
    """(sec, nsec) stamps of labelled test files (conf trainer :88-98), the
    extension stripped before the split, as the JAX package does."""
    stamps = []
    for filename in label_files:
        stem = os.path.splitext(os.path.basename(filename))[0]
        digits = [int(s) for s in stem.split("_") if s.isdigit()]
        if len(digits) >= 2:
            stamps.append((digits[0], digits[1]))
    return stamps


def _ir_vis(ir: np.ndarray) -> np.ndarray:
    return (np.clip(ir.astype(np.float32), 21800, 25000) - 21800) / 3200.0


class FreiburgThermalTestDataset:
    """Freiburg eval items (ThermalTestDataLoader, :748-820): 8-bit RGB, 16-bit
    IR and ``.npy`` labels resized to 960x320, then the 148:852 window.
    Raw uint8/uint16 frames (normalised on the device) and their copies."""

    def __init__(self, ir_paths, rgb_paths, label_paths):
        if not len(ir_paths) == len(rgb_paths) == len(label_paths):
            raise ValueError(f"{len(ir_paths)} IR, {len(rgb_paths)} RGB and "
                             f"{len(label_paths)} label files")
        self.ir_files, self.rgb_files, self.label_files = ir_paths, rgb_paths, label_paths

    def __len__(self):
        return len(self.rgb_files)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        rgb = resize(_imread_rgb(self.rgb_files[index]), IR_RES)[:, 148:852]
        ir = resize(_imread_grey(self.ir_files[index], np.uint16), IR_RES)[:, 148:852]
        label = resize(np.load(self.label_files[index]), IR_RES, nearest=True)[:, 148:852]
        return {
            "rgb": rgb.astype(np.uint8)[None],
            "rgb_org": rgb.astype(np.uint8)[None],
            "ir": ir.astype(np.uint16)[None, ..., None],
            "ir_org": _ir_vis(ir)[None, ..., None],
            "label": label.astype(np.int32)[None],
        }


class FreiburgInferDataset:
    """Label-free, timestamp-sorted capture frames (ThermalDataLoaderInfer),
    in the stride-aligned 148:852 window of the 960x320 resize."""

    def __init__(self, db_path: str):
        self.ir_files = sorted(glob(os.path.join(db_path, "fl_ir_aligned/*.png")),
                               key=stamp_sort_key)

    def __len__(self):
        return len(self.ir_files)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        ir_file = self.ir_files[index]
        rgb_file = ir_file.replace("fl_ir_aligned", "fl_rgb")
        rgb = resize(_imread_rgb(rgb_file), IR_RES)[:, 148:852]
        ir = resize(_imread_grey(ir_file, np.uint16), IR_RES)[:, 148:852]
        return {
            "rgb": rgb.astype(np.uint8)[None],
            "rgb_org": rgb.astype(np.uint8)[None],
            "ir": ir.astype(np.uint16)[None, ..., None],
            "ir_org": _ir_vis(ir)[None, ..., None],
        }


class MFNetDataset:
    """MFNet eval split (MFDataset, :224-288): RGBA PNGs whose alpha channel
    is the IR, 640x480, host-normalised float32 frames."""

    WIDTH, HEIGHT = 640, 480
    _SPLIT_FILES = {"day": "test_day.txt", "night": "test_night.txt",
                    "combined": "test.txt"}

    def __init__(self, data_dir: str, split: str = "day"):
        if split not in self._SPLIT_FILES:
            raise ValueError(f"Unknown split {split}")
        with open(os.path.join(data_dir, self._SPLIT_FILES[split])) as f:
            self.names = [n.strip() for n in f.readlines()]
        self.data_dir = data_dir

    def __len__(self):
        return len(self.names)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        name = self.names[index]
        path = os.path.join(self.data_dir, "images", name + ".png")
        im = read_png(path)
        if im.ndim != 3 or im.shape[2] != 4 or im.dtype != np.uint8:
            raise ValueError(f"{path}: expected an 8-bit RGBA PNG, got {im.dtype} {im.shape}")
        # cv2's BGRA [:, :, :3] then BGR2RGB is the decoded RGBA's [..., :3]
        wh = (self.WIDTH, self.HEIGHT)
        rgb = resize(im[..., :3], wh).astype(np.float32) / 255.0
        ir = resize(im[..., 3], wh).astype(np.float32)[..., None] / 255.0
        label = _imread_grey(os.path.join(self.data_dir, "labels", name + ".png"), np.uint8)
        label = resize(label, wh, nearest=True)
        return {
            "rgb": ((rgb - 0.5) / 0.5)[None],
            "rgb_org": rgb[None],
            "ir": ((ir - 0.5) / 0.5)[None],
            "ir_org": ir[None],
            "label": label.astype(np.int32)[None],
        }


class MFNetTrainDataset:
    """MFNet train split (MFDatasetTrain, :291-440; ``heatnet_tpu/data/
    loaders.py:342-383``): each day item of ``train.txt`` (names ending in
    D, no ``flip``) with a night frame drawn from ``RandomState(seed)``, the
    RGBA PNG's RGB and its alpha (the 8-bit IR), the day labels from
    ``labels_from_rgbteacher/``, all resized to 640x480. Raw uint8 frames;
    ``DeviceAugment(mfnet=True)`` augments them on the device."""

    WIDTH, HEIGHT = 640, 480

    def __init__(self, data_dir: str, seed: int = 0):
        with open(os.path.join(data_dir, "train.txt")) as f:
            names = [n.strip() for n in f.readlines()]
        self.day_names = [n for n in names if "flip" not in n and n.endswith("D")]
        self.night_names = [n for n in names if "flip" not in n and n.endswith("N")]
        if not self.day_names or not self.night_names:
            raise FileNotFoundError(f"no day and night names in {data_dir}/train.txt")
        self.data_dir = data_dir
        self._rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.day_names)

    def _read(self, name: str):
        path = os.path.join(self.data_dir, "images", name + ".png")
        im = read_png(path)
        if im.ndim != 3 or im.shape[2] != 4 or im.dtype != np.uint8:
            raise ValueError(f"{path}: expected an 8-bit RGBA PNG, got {im.dtype} {im.shape}")
        wh = (self.WIDTH, self.HEIGHT)
        return resize(im[..., :3], wh), resize(im[..., 3:], wh)

    def draw(self, index: int) -> int:
        """The night frame of item ``index``."""
        return self._rng.randint(len(self.night_names))

    def load(self, index: int, night: int) -> Dict[str, np.ndarray]:
        day_name = self.day_names[index]
        rgb_day, ir_day = self._read(day_name)
        rgb_night, ir_night = self._read(self.night_names[night])
        label = _imread_grey(os.path.join(self.data_dir, "labels_from_rgbteacher",
                                          day_name + ".png"), np.uint8)
        return {"rgb_day": rgb_day, "ir_day": ir_day,
                "label_day": resize(label, (self.WIDTH, self.HEIGHT), nearest=True),
                "rgb_night": rgb_night, "ir_night": ir_night}

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        return self.load(index, self.draw(index))


class MFHarnessTrainDataset:
    """The MFNet harness's train split (``heatnet_tpu/data/loaders.py:386-423``,
    ``MF_dataset(have_label=True)`` of the reference): ``<split>.txt`` names,
    the RGBA PNG (alpha = IR, 8-bit) with its native 9-class labels, the
    ``transform`` callables applied per item (``data/mf_augment.py``), a
    resize back to 640x480 (nearest for the labels), the image scaled by
    1/255 with no mean or std: float32 ``image`` (480, 640, 4) and int32
    ``label``."""

    WIDTH, HEIGHT = 640, 480

    def __init__(self, data_dir: str, split: str = "train", transform=()):
        with open(os.path.join(data_dir, split + ".txt")) as f:
            self.names = [n.strip() for n in f.readlines()]
        self.data_dir = data_dir
        self.transform = list(transform)

    def __len__(self):
        return len(self.names)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        name = self.names[index]
        path = os.path.join(self.data_dir, "images", name + ".png")
        # cv2's BGRA with [:3] as RGB and the alpha after is the decoded RGBA
        image = read_png(path)
        if image.ndim != 3 or image.shape[2] != 4 or image.dtype != np.uint8:
            raise ValueError(f"{path}: expected an 8-bit RGBA PNG, got {image.dtype} "
                             f"{image.shape}")
        label = _imread_grey(os.path.join(self.data_dir, "labels", name + ".png"), np.uint8)
        for func in self.transform:
            image, label = func(image, label)
        wh = (self.WIDTH, self.HEIGHT)
        image = resize(np.ascontiguousarray(image), wh)
        label = resize(np.ascontiguousarray(label), wh, nearest=True)
        return {"image": image.astype(np.float32) / 255.0,
                "label": label.astype(np.int32)}


def _scaled_hw(h: int, w: int, scale: float) -> Tuple[int, int]:
    """The Vistas scale jitter's size: width 1024 x scale, the aspect kept
    (vistas_dataset.py:75-82)."""
    return int(int(h / w * 1024) * scale), int(1024 * scale)


def color_jitter(img: np.ndarray, brightness: float, contrast: float,
                 saturation: float, hue: float) -> np.ndarray:
    """The JAX loader's ColorJitter on uint8 RGB with the given factors
    (``VistasDataset._color_jitter``): brightness, contrast about the mean,
    saturation about the grey, in float32, truncated to uint8; then H moved
    by ``int(hue * 180)`` in cv2's 8-bit HSV."""
    img = img.astype(np.float32)
    img = img * brightness
    mean = img.mean()
    img = (img - mean) * contrast + mean
    gray = img.mean(axis=2, keepdims=True)
    img = (img - gray) * saturation + gray
    img = np.clip(img, 0, 255).astype(np.uint8)
    hsv = rgb_to_hsv(img)
    hsv[..., 0] = (hsv[..., 0].astype(np.int32) + int(hue * 180)) % 180
    return hsv_to_rgb(hsv)


class VistasDataset:
    """Relabelled Mapillary Vistas for pretraining (VistasBorderDataLoader,
    data/vistas_dataset.py:38-159; ``heatnet_tpu/data/loaders.py:827-933``).

    ``images/*.png`` with ``labels/*.png`` (uint16, class = value // 256).
    Items: normalised ``image`` (H, W, 3) float32, ``label`` (H, W) int32,
    ``image_org`` in [0, 1], at (height, width). The train chain: scale
    jitter {0.75, 1, 1.25} at width 1024, padding to the height
    (``resize_and_pad``, labels padded with ``background_id``), a random
    crop, an hflip (p 0.5), colour jitter (p 0.6), a rotation within ±20°
    (p 0.5), the Vistas mean and std. The eval chain resizes to width x
    height. The draws come from ``RandomState(seed)`` in the JAX loader's
    order; they depend on each frame's size (its PNG header) and on earlier
    draws, not on its pixels. ``contrast_enhancement`` runs CLAHE on the Lab
    lightness plane (``data/clahe.py``) after the padding, as in JAX.
    """

    MEAN = (0.28389175985075144, 0.32513300997108185, 0.28689552631651594)
    STD = (0.1777223070810445, 0.18099167120139084, 0.17613640748441522)

    def __init__(self, db_path: str, width: int, height: int,
                 augment_data: bool = True, sub_mean: bool = True,
                 background_id: int = 12, contrast_enhancement: bool = False,
                 seed: int = 0):
        self.width, self.height = width, height
        self.augment_data = augment_data
        self.sub_mean = sub_mean
        self.contrast_enhancement = contrast_enhancement
        self.background_id = background_id
        self._rng = np.random.RandomState(seed)

        label_files = sorted(glob(os.path.join(db_path, "labels/*.png")))
        self.pairs = [(l.replace("labels", "images"), l) for l in label_files
                      if os.path.isfile(l.replace("labels", "images"))]
        if not self.pairs:
            raise FileNotFoundError(f"no image/label pairs under {db_path}")

    def __len__(self):
        return len(self.pairs)

    def _needs_pad(self, h: int, w: int) -> bool:
        return not (h >= self.height and w >= self.width)

    def draw(self, index: int) -> Optional[dict]:
        """Item ``index``'s draws (None for the eval chain): ``scale``, crop
        ``i``, ``j``, ``flip``, optional ``jitter`` (brightness, contrast,
        saturation, hue) and ``angle``."""
        if not self.augment_data:
            return None
        rng = self._rng
        d = {"scale": [0.75, 1.0, 1.25][rng.randint(3)]}
        h, w = _scaled_hw(*png_size(self.pairs[index][0]), d["scale"])
        if self._needs_pad(h, w):
            h = self.height
        d["i"] = rng.randint(0, h - self.height + 1)
        d["j"] = rng.randint(0, w - self.width + 1)
        d["flip"] = rng.rand() > 0.5
        if rng.rand() > 0.4:
            d["jitter"] = (rng.uniform(0.8, 1.2), rng.uniform(0.8, 1.2),
                           rng.uniform(0.8, 1.2), rng.uniform(-0.1, 0.1))
        if rng.rand() > 0.5:
            d["angle"] = (rng.rand() - 0.5) * 40
        return d

    def load(self, index: int, d: Optional[dict]) -> Dict[str, np.ndarray]:
        rgb_file, label_file = self.pairs[index]
        image = _imread_rgb(rgb_file)  # RGB: the JAX loader's BGR read and its later swap
        ids = (_imread_grey(label_file, np.uint16) // 256).astype(np.uint8)
        if d is not None:
            h, w = _scaled_hw(*image.shape[:2], d["scale"])
            image, ids = resize(image, (w, h)), resize(ids, (w, h), nearest=True)
        if self._needs_pad(*image.shape[:2]):
            ids = resize_and_pad(ids, (self.height, ids.shape[1]),
                                 pad_color=self.background_id, nearest=True)
            image = resize_and_pad(image, (self.height, image.shape[1]), pad_color=0)
        if self.contrast_enhancement:
            image = apply_clahe(swap_rb(image))
        if d is None:
            image = resize(image, (self.width, self.height))
            ids = resize(ids, (self.width, self.height), nearest=True)
        else:
            i, j = d["i"], d["j"]
            image = image[i:i + self.height, j:j + self.width]
            ids = ids[i:i + self.height, j:j + self.width]
            if d["flip"]:
                image, ids = image[:, ::-1], ids[:, ::-1]
            if "jitter" in d:
                image = color_jitter(image, *d["jitter"])
            if "angle" in d:
                hw = image.shape[:2]
                m = get_rotation_matrix_2d((hw[1] / 2, hw[0] / 2), d["angle"], 1.0)
                image = warp_affine(image, m, hw[::-1])
                ids = warp_affine(np.ascontiguousarray(ids), m, hw[::-1], nearest=True)

        img_f = np.ascontiguousarray(image).astype(np.float32) / 255.0
        image_org = img_f.copy()
        if self.sub_mean:
            img_f = (img_f - np.array(self.MEAN, np.float32)) / np.array(self.STD, np.float32)
        return {"image": img_f, "label": np.ascontiguousarray(ids).astype(np.int32),
                "image_org": image_org}

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        return self.load(index, self.draw(index))


# cv2.distanceTransform(src, DIST_L2, 5): the 5x5 chamfer mask (not an exact
# Euclidean transform) with cv2's coefficients 1, 1.4 and 2.1969, in float32,
# FLT_MAX as infinity, two border rows and columns (distransform.cpp,
# distanceTransform_5x5)
_DT_HV, _DT_DIAG, _DT_LONG = (np.float32(v) for v in (1.0, 1.4, 2.1969))
_DT_MAX = np.finfo(np.float32).max


def distance_transform_l2_5(src: np.ndarray) -> np.ndarray:
    """``cv2.distanceTransform(src, cv2.DIST_L2, 5)`` of a uint8 mask: the
    float32 distance of each non-zero pixel to the nearest zero one under
    cv2's 5x5 chamfer metric (FLT_MAX where the mask has no zero), computed as
    cv2 computes it.

    cv2 makes two raster passes: forward, each pixel the minimum of its
    already-visited neighbours (two rows above, the left one) plus their
    coefficients; backward, the same over the bottom-right half, from the
    bottom-right corner. A pixel (i, j) needs only pixels of smaller
    ``j + 3 i`` in the forward pass (larger in the backward one), so the
    pixels of one ``j + 3 i`` are computed together, in the same float32
    operations cv2 makes in its loop."""
    src = np.asarray(src)
    if src.ndim != 2:
        raise ValueError(f"expected a single-channel mask, got {src.shape}")
    h, w = src.shape
    b = 2
    stride = w + 2 * b
    t = np.full((h + 2 * b) * stride, _DT_MAX, np.float32)
    ii, jj = np.mgrid[0:h, 0:w]
    key = (jj + 3 * ii).ravel()
    order = np.argsort(key, kind="stable")
    flat = ((ii + b) * stride + jj + b).ravel()[order]
    zero = src.ravel()[order] == 0
    starts = np.r_[np.flatnonzero(np.diff(key[order])) + 1, key.size]
    bounds = list(zip(np.r_[0, starts[:-1]], starts))
    up = ((-2 * stride - 1, _DT_LONG), (-2 * stride + 1, _DT_LONG), (-stride - 2, _DT_LONG),
          (-stride - 1, _DT_DIAG), (-stride, _DT_HV), (-stride + 1, _DT_DIAG),
          (-stride + 2, _DT_LONG), (-1, _DT_HV))
    for lo, hi in bounds:
        p = flat[lo:hi]
        v = t[p + up[0][0]] + up[0][1]
        for off, m in up[1:]:
            v = np.minimum(v, t[p + off] + m)
        v[zero[lo:hi]] = 0
        t[p] = v
    for lo, hi in reversed(bounds):
        p = flat[lo:hi]
        v = t[p]
        for off, m in up:
            v = np.minimum(v, t[p - off] + m)
        t[p] = v
    return t.reshape(h + 2 * b, stride)[b:b + h, b:b + w].copy()


def _read_rgb_any(path: str) -> np.ndarray:
    """An 8-bit colour image as RGB: a PNG through ``data.png``, another file
    (a Vistas JPEG) through PIL."""
    if _is_png(path):
        return _imread_rgb(path)
    return np.asarray(_pil_open(path).convert("RGB"), np.uint8)


class VistasBordersDataset:
    """Borders, instances and distance transform of relabelled Vistas
    (``data/vistas_borders_dataset.py:38-170``; ``heatnet_tpu/data/loaders.py:717-823``).

    ``paths.txt`` holds 4 space-separated paths per line: the borders PNG
    (uint8 0/1), the trainIds PNG (uint16 class * 256 + instance), the image
    and the distance-transform PNG (uint8). Items are the JAX loader's dict:
    ``borders, ids, inst, image, borders_clip, image_org, dt_borders, dt``;
    ``dt_borders`` is ``distance_transform_l2_5(1 - borders)``, cv2's chamfer
    transform copied. A frame smaller than (height, width) is padded with
    ``resize_and_pad`` (borders and dt with 2, ids and inst with 11, the image
    with 0). The train chain crops at random, flips (p 0.5) and jitters
    brightness, contrast and saturation (p 0.6) with the JAX loader's draws
    from ``RandomState(seed)``; the eval chain resizes to width x height.
    ``contrast_enhancement`` (on by default, as in JAX) runs CLAHE on the
    Lab lightness plane (``data/clahe.py``) before the augmentation.
    """

    MEAN = (0.28389175985075144, 0.32513300997108185, 0.28689552631651594)
    STD = (0.1777223070810445, 0.18099167120139084, 0.17613640748441522)

    def __init__(self, paths_file: str, width: int, height: int,
                 contrast_enhancement: bool = True, augment_data: bool = True,
                 sub_mean: bool = True, seed: int = 0):
        self.width, self.height = width, height
        self.contrast_enhancement = contrast_enhancement
        self.augment_data = augment_data
        self.sub_mean = sub_mean
        self._rng = np.random.RandomState(seed)
        with open(paths_file) as f:
            lines = [x.strip() for x in f.readlines() if x.strip()]
        self.items = [tuple(line.split(" ")[:4]) for line in lines]
        if not self.items:
            raise FileNotFoundError(f"no entries in {paths_file}")

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        borders_p, ids_p, image_p, dt_p = self.items[index]
        borders = _imread_grey(borders_p, np.uint8)
        dt = _imread_grey(dt_p, np.uint8)
        raw_ids = read_png(ids_p)
        if raw_ids.ndim != 2:
            raise ValueError(f"{ids_p}: expected a single-channel PNG, got {raw_ids.shape}")
        inst = (raw_ids % 256).astype(np.uint8)
        ids = (raw_ids // 256).astype(np.uint8)
        image = _read_rgb_any(image_p)  # RGB: the JAX loader's BGR read and its swap

        if not (image.shape[0] >= self.height and image.shape[1] >= self.width):
            borders = resize_and_pad(borders, (self.height, borders.shape[1]),
                                     pad_color=2, nearest=True)
            dt = resize_and_pad(dt, (self.height, dt.shape[1]), pad_color=2, nearest=True)
            ids = resize_and_pad(ids, (self.height, ids.shape[1]), pad_color=11,
                                 nearest=True)
            inst = resize_and_pad(inst, (self.height, inst.shape[1]), pad_color=11,
                                  nearest=True)
            image = resize_and_pad(image, (self.height, image.shape[1]), pad_color=0)
        if self.contrast_enhancement:
            image = apply_clahe(swap_rb(image))

        rng = self._rng
        if self.augment_data:
            i = rng.randint(0, image.shape[0] - self.height + 1)
            j = rng.randint(0, image.shape[1] - self.width + 1)
            sl = np.s_[i:i + self.height, j:j + self.width]
            image, borders, dt, ids, inst = (a[sl] for a in (image, borders, dt, ids, inst))
            if rng.rand() > 0.5:
                image, borders, dt, ids, inst = (a[:, ::-1] for a in
                                                 (image, borders, dt, ids, inst))
            if rng.rand() > 0.4:
                img = image.astype(np.float32)
                img = img * rng.uniform(0.8, 1.2)
                mean = img.mean()
                img = (img - mean) * rng.uniform(0.8, 1.2) + mean
                gray = img.mean(axis=2, keepdims=True)
                img = (img - gray) * rng.uniform(0.8, 1.2) + gray
                image = np.clip(img, 0, 255).astype(np.uint8)
        else:
            wh = (self.width, self.height)
            image = resize(image, wh)
            borders, dt, ids, inst = (resize(a, wh, nearest=True)
                                      for a in (borders, dt, ids, inst))

        borders = np.ascontiguousarray(borders)
        dt_borders = distance_transform_l2_5((1 - borders).astype(np.uint8))
        img_f = np.ascontiguousarray(image).astype(np.float32) / 255.0
        image_org = img_f.copy()
        if self.sub_mean:
            img_f = (img_f - np.array(self.MEAN, np.float32)) / np.array(self.STD, np.float32)
        return {
            "borders": borders.astype(np.int32),
            "ids": np.ascontiguousarray(ids).astype(np.int32),
            "inst": np.ascontiguousarray(inst).astype(np.int32),
            "image": img_f,
            "borders_clip": np.clip(borders, 0, 1).astype(np.int32),
            "image_org": image_org,
            "dt_borders": dt_borders,
            "dt": np.ascontiguousarray(dt).astype(np.float32),
        }


# Pillow's 8-bit resampling (libImaging/Resample.c): coefficients in
# fixed point with 32 - 8 - 2 fractional bits
_PIL_PRECISION_BITS = 22


def convert_l(img: np.ndarray, palette: Optional[np.ndarray] = None) -> np.ndarray:
    """PIL's ``convert("L")`` of an 8-bit image: grey passes, RGB and RGBA
    (alpha ignored) become ``(19595 R + 38470 G + 7471 B + 0x8000) >> 16``;
    palette indices go through ``palette`` first."""
    if img.dtype != np.uint8:
        raise ValueError(f"convert_l takes 8-bit images, got {img.dtype}")
    if palette is not None:
        img = palette[img]
    if img.ndim == 2:
        return img
    if img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"convert_l takes grey, RGB or RGBA, got shape {img.shape}")
    c = img[..., :3].astype(np.uint32)
    return ((19595 * c[..., 0] + 38470 * c[..., 1] + 7471 * c[..., 2] + 0x8000)
            >> 16).astype(np.uint8)


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _pil_bicubic_taps(n_in: int, n_out: int):
    """Per output position, its source indices and fixed-point weights
    (``precompute_coeffs`` and ``normalize_coeffs_8bpc``)."""
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(n_out) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.intp)
    xmax = np.minimum(np.trunc(center + support + 0.5), n_in).astype(np.intp) - xmin
    x = np.arange(ksize)[None, :]
    live = x < xmax[:, None]
    w = np.where(live, _bicubic((x + xmin[:, None] - center[:, None] + 0.5)
                                * (1.0 / filterscale)), 0.0)
    ww = np.zeros((n_out, 1))
    for j in range(ksize):  # summed in the C loop's order
        ww += w[:, j:j + 1]
    w = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    one = float(1 << _PIL_PRECISION_BITS)
    k = np.trunc(np.where(w < 0, -0.5 + w * one, 0.5 + w * one)).astype(np.int64)
    idx = np.minimum(xmin[:, None] + x, n_in - 1)
    return idx, k


def _pil_pass(img: np.ndarray, n_out: int, axis: int) -> np.ndarray:
    idx, k = _pil_bicubic_taps(img.shape[axis], n_out)
    src = np.take(img, idx, axis=axis).astype(np.int64)  # axis → (n_out, ksize)
    kk = k if axis == 1 else k[:, :, None]
    ss = (src * kk).sum(axis=axis + 1) + (1 << (_PIL_PRECISION_BITS - 1))
    return np.clip(ss >> _PIL_PRECISION_BITS, 0, 255).astype(np.uint8)


def _pil_nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """``ImagingScaleAffine``'s source positions: ``scale / 2`` plus ``scale``
    per step, accumulated in doubles, then truncated."""
    scale = n_in / n_out
    pos, out = scale * 0.5, np.empty(n_out, np.intp)
    for i in range(n_out):
        out[i] = min(int(pos), n_in - 1)
        pos += scale
    return out


def resize_pil(img: np.ndarray, wh: Tuple[int, int], resample: str) -> np.ndarray:
    """PIL's ``Image.resize(wh, BICUBIC | NEAREST)`` of a 2-D image, in numpy.

    ``"bicubic"`` (uint8 only): Pillow's two passes, horizontal then
    vertical, each skipped where the size does not change; a = -0.5
    bicubic taps over a support of 2·max(scale, 1), normalised, in 22-bit
    fixed point, the sum rounded and clipped to uint8 after each pass.
    ``"nearest"`` (any dtype): each output pixel takes the source pixel
    under its centre. A resize to the same size is a copy.
    """
    w_out, h_out = wh
    h, w = img.shape[:2]
    if img.ndim != 2:
        raise ValueError(f"resize_pil takes a 2-D image, got shape {img.shape}")
    if (w, h) == (w_out, h_out):
        return img.copy()
    if resample == "nearest":
        return img[_pil_nearest_index(h, h_out)[:, None], _pil_nearest_index(w, w_out)[None, :]]
    if resample != "bicubic":
        raise ValueError(f"resample {resample!r} is not 'bicubic' or 'nearest'")
    if img.dtype != np.uint8:
        raise ValueError(f"bicubic resize of {img.dtype} is not supported (uint8)")
    out = img
    if w_out != w:
        out = _pil_pass(out, w_out, axis=1)
    if h_out != h:
        out = _pil_pass(out, h_out, axis=0)
    return out


def _is_png(path: str) -> bool:
    with open(path, "rb") as fh:
        return fh.read(8) == _PNG_SIGNATURE


def _pil_open(path: str):
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(f"{path} is not a PNG file, and PIL, which decodes it, "
                           "does not import") from e
    return Image.open(path)


def _read_grey_pil(path: str) -> np.ndarray:
    """``Image.open(path).convert("L")`` as uint8: PNGs through ``data.png``
    and ``convert_l``, other files (KAIST's JPEGs) through PIL."""
    if _is_png(path):
        img, palette = read_png_palette(path)
        return convert_l(img, palette)
    return np.asarray(_pil_open(path).convert("L"), np.uint8)


def _read_label_pil(path: str) -> np.ndarray:
    """``np.asarray(Image.open(path))``: a palette PNG gives its indices."""
    if _is_png(path):
        return read_png(path)
    return np.asarray(_pil_open(path))


class KAISTCycleGANDataset:
    """KAIST day/night LWIR frames for CycleGAN (``data/loaders.py:936-983``).

    A = day thermal (set00/set01), B = a random night thermal (set04, set05,
    set09-set11), the day labels; grey, 256x256 bicubic (images) and
    nearest (labels), a shared p = 0.5 hflip, ``(x/255 - 0.5)/0.5``. The
    ``RandomState(seed)`` draws per item, in the JAX loader's order: the B
    file, then the flip. Decoding: ``_read_grey_pil`` and ``_read_label_pil``.
    """

    SIZE = 256

    def __init__(self, root: str, seed: int = 0):
        self.files_A, self.files_label, self.files_B = [], [], []
        for s in ("set00", "set01"):
            self.files_A += sorted(glob(os.path.join(root, "Day", s, "V*/lwir/I*.jpg")))
            self.files_label += sorted(glob(os.path.join(root, "Day", s, "V*/labels/I*.png")))
        for s in ("set04", "set05", "set09", "set10", "set11"):
            self.files_B += sorted(glob(os.path.join(root, "Night", s, "V*/lwir/I*.jpg")))
        self._rng = np.random.RandomState(seed)
        if not self.files_A or not self.files_B:
            raise FileNotFoundError(f"no KAIST day/night lwir files under {root}")

    def __len__(self):
        return max(len(self.files_A), len(self.files_B))

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        a = _read_grey_pil(self.files_A[index % len(self.files_A)])
        b = _read_grey_pil(self.files_B[self._rng.randint(len(self.files_B))])
        lbl = _read_label_pil(self.files_label[index % len(self.files_label)])

        wh = (self.SIZE, self.SIZE)
        a = resize_pil(a, wh, "bicubic").astype(np.float32) / 255.0
        b = resize_pil(b, wh, "bicubic").astype(np.float32) / 255.0
        if lbl.ndim == 3:
            lbl = lbl[..., 0]
        lbl = resize_pil(lbl, wh, "nearest").astype(np.int32)
        if self._rng.rand() > 0.5:  # the shared hflip
            a, b, lbl = a[:, ::-1], b[:, ::-1], lbl[:, ::-1]
        return {
            "A": np.ascontiguousarray((a - 0.5) / 0.5)[..., None],
            "B": np.ascontiguousarray((b - 0.5) / 0.5)[..., None],
            "label": np.ascontiguousarray(lbl),
        }


class BDDValDataset:
    """BDD night validation (BDDValDataset, :445-498): 704x320 RGB only.

    Its frames are JPEGs, decoded by cv2, which must import here."""

    WIDTH, HEIGHT = 704, 320

    def __init__(self, db_path: str, split: str = "val"):
        try:
            import cv2
        except ImportError as e:
            raise RuntimeError("BDDValDataset decodes JPEG frames through cv2, which "
                               "does not import here") from e
        self._cv2 = cv2
        if split != "val":
            raise NotImplementedError(f"BDD split {split!r}")
        with open(os.path.join(db_path, "bdd_night.txt")) as f:
            self.names = [n.strip() for n in f.readlines()]
        if not self.names:
            raise FileNotFoundError(f"no names in {db_path}/bdd_night.txt")
        self.data_dir = db_path
        self.split = split

    def __len__(self):
        return len(self.names)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        cv2 = self._cv2
        name = self.names[index]
        rgb = cv2.cvtColor(cv2.imread(os.path.join(self.data_dir, "images", self.split,
                                                   name + ".jpg")), cv2.COLOR_BGR2RGB)
        label = _imread_grey(os.path.join(self.data_dir, "labels", self.split,
                                          name + "_train_id.png"), np.uint8)
        wh = (self.WIDTH, self.HEIGHT)
        rgb = resize(rgb, wh).astype(np.float32) / 255.0
        label = resize(label, wh, nearest=True)
        return {
            "rgb": ((rgb - 0.5) / 0.5)[None],
            "rgb_org": rgb[None],
            "label": label.astype(np.int32)[None],
        }


class ThermalDriveDataset:
    """Raw-dump drive loader (``data/thermal_loader.py:46-152``;
    ``heatnet_tpu/data/loaders.py:634-716``).

    Walks ``db_path`` for ``{fl,fr}_{rgb,ir}_drive_*.txt`` path lists; each
    line is a burst of space-separated frame paths. Items are dicts of
    lists: ``rgb_fl``/``rgb_fr`` (HWC float RGB in [0,1]), ``ir_fl``/
    ``ir_fr`` (HW1 float raw counts), ``paths_left``, ``org_left`` (BGR
    uint8, as the reference keeps it; RGB under ``contrast_enhancement``,
    as in JAX). Options mirror the reference: ``contrast_enhancement``
    (``data/clahe.py``'s copy of cv2's CLAHE), ``load_aligned_ir`` (remap
    fl_ir → fl_ir_aligned paths), ``load_right``. Frames decode with
    ``data/png.py``: ``imread_bgr`` for ``cv2.imread`` and
    ``imread_grayscale(any_depth=True)`` for ``IMREAD_ANYDEPTH``.
    """

    def __init__(self, db_path: str, contrast_enhancement: bool = False,
                 load_aligned_ir: bool = False, load_right: bool = True):
        self.contrast_enhancement = contrast_enhancement
        self.load_aligned_ir = load_aligned_ir
        self.load_right = load_right

        def find(pattern):
            out = []
            for root, _dirs, files in os.walk(db_path):
                out.extend(os.path.join(root, f) for f in files
                           if fnmatch.fnmatch(f, pattern))
            return sorted(out)

        lists = [find(f"{side}_{mod}_drive_*.txt")
                 for side, mod in (("fl", "rgb"), ("fr", "rgb"), ("fl", "ir"), ("fr", "ir"))]
        assert len({len(l) for l in lists}) == 1, "mismatched drive list counts"

        def read_lines(path):
            with open(path) as f:
                return [x.strip() for x in f.readlines()]

        self.items = []
        for files in zip(*lists):
            for lines in zip(*(read_lines(f) for f in files)):
                self.items.append([line.split(" ") for line in lines])

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        paths = [list(p) for p in self.items[index]]
        rgb_fl = [imread_bgr(p) for p in paths[0]]
        rgb_fr = [imread_bgr(p) for p in paths[1]] if self.load_right else None

        if self.contrast_enhancement:
            rgb_fl = [apply_clahe(im) for im in rgb_fl]
            if self.load_right:
                rgb_fr = [apply_clahe(im) for im in rgb_fr]
        org_left = rgb_fl[0]

        if self.load_aligned_ir:
            for i, p in enumerate(paths[2]):
                name = os.path.split(p)[1].replace("fl_ir", "fl_ir_aligned")
                paths[2][i] = os.path.join(
                    os.path.split(os.path.split(p)[0])[0], "fl_ir_aligned", name)

        ir_fl = [imread_grayscale(p, any_depth=True) for p in paths[2] if os.path.isfile(p)]
        ir_fr = [imread_grayscale(p, any_depth=True) for p in paths[3]
                 if os.path.isfile(p)] if self.load_right else []

        def to_rgb_float(ims):
            out = []
            for im in ims:
                if not self.contrast_enhancement:  # CLAHE already emits RGB
                    im = swap_rb(im)
                out.append(im.astype(np.float32) / 255.0)
            return out

        return {
            "rgb_fl": to_rgb_float(rgb_fl),
            "rgb_fr": to_rgb_float(rgb_fr) if self.load_right else None,
            "ir_fl": [im.astype(np.float32)[..., None] for im in ir_fl],
            "ir_fr": [im.astype(np.float32)[..., None] for im in ir_fr],
            "paths_left": paths[0],
            "org_left": org_left,
        }


def prefetch_items(dataset, workers: int = 8, depth: int = 32
                   ) -> Iterator[Dict[str, np.ndarray]]:
    """Yield ``dataset[0..len)`` in order, decoding up to ``depth`` items
    ahead on a ``workers``-thread pool."""
    n = len(dataset)
    with ThreadPoolExecutor(max_workers=workers) as ex:
        pending: deque = deque()
        nxt = 0
        while nxt < min(depth, n):
            pending.append(ex.submit(dataset.__getitem__, nxt))
            nxt += 1
        while pending:
            item = pending.popleft().result()
            if nxt < n:
                pending.append(ex.submit(dataset.__getitem__, nxt))
                nxt += 1
            yield item


def batch_iterator(dataset, batch_size: int, shuffle: bool = True,
                   seed: int = 0, drop_last: bool = True, prefetch: int = 2,
                   workers: int = 1) -> Iterator[Dict[str, np.ndarray]]:
    """Stacked-numpy batch iterator with a background prefetch thread.

    The order is a ``RandomState(seed)`` shuffle; each batch stacks the
    items' arrays key by key. With ``workers > 1`` and a dataset that has
    ``draw``/``load``, a batch's items are drawn in order on the producer
    thread and decoded on ``workers`` threads, so the items equal those of
    one thread.
    """
    threaded = workers > 1 and hasattr(dataset, "draw")

    def items_of(idx, pool):
        if pool is None:
            return [dataset[int(i)] for i in idx]
        draws = [dataset.draw(int(i)) for i in idx]
        return list(pool.map(dataset.load, [int(i) for i in idx], draws))

    order = np.arange(len(dataset))
    if shuffle:
        np.random.RandomState(seed).shuffle(order)

    n_full = len(order) // batch_size
    tail = len(order) % batch_size
    n_batches = n_full + (0 if drop_last or tail == 0 else 1)

    stop = threading.Event()

    def produce(q: queue.Queue):
        pool = ThreadPoolExecutor(max_workers=workers) if threaded else None
        try:
            for b in range(n_batches):
                items = items_of(order[b * batch_size:(b + 1) * batch_size], pool)
                batch = {k: np.stack([it[k] for it in items]) for k in items[0]}
                # a bounded put that notices a consumer that stopped early,
                # so the thread does not wait on a full queue forever
                while not stop.is_set():
                    try:
                        q.put(batch, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        finally:
            if pool is not None:
                pool.shutdown()
            while True:
                try:
                    q.put(None, timeout=0.2)
                    break
                except queue.Full:
                    if stop.is_set():
                        break

    q: queue.Queue = queue.Queue(maxsize=prefetch)
    t = threading.Thread(target=produce, args=(q,), daemon=True)
    t.start()
    try:
        while True:
            batch = q.get()
            if batch is None:
                return
            yield batch
    finally:
        stop.set()


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device``; uint16 (thin PyTorch support)
    crosses as int16 bytes and is viewed back on arrival."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # a pack's memmap frames; torch wants writable memory
        a = a.copy()
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).to(device).view(torch.uint16)
    return torch.from_numpy(a).to(device)


class DeviceAugment:
    """The train augmentation chain, batched on ``device`` (the card by default).

    ``augment(generator, raw_batch)`` takes a ``batch_iterator`` batch of
    uint8/uint16 frames and returns float32 ``rgb_day``/``ir_day``/
    ``rgb_night``/``ir_night`` (N,h,w,C), int64 ``label_day`` (N,h,w) and
    ``mod_drop_params``, on the device. With ``mfnet`` it runs
    ``mf_train_sample_preprocess`` on ``MFNetTrainDataset`` batches (no
    window, 8-bit IR, no ``mod_drop_params``).

    With a data-parallel ``mesh`` (``parallel/mesh.py``) the draws are
    those of the whole batch, made on every process in one order, and this
    process augments its rows with its rows of the draws: the chain is per
    sample, so the rows equal the whole batch's augmentation's rows.
    """

    def __init__(self, crop_hw: Tuple[int, int] = (320, 640),
                 device: Optional[Union[str, torch.device]] = None,
                 mfnet: bool = False):
        self.crop_hw = tuple(crop_hw)
        self.device = resolve(device)
        self.mfnet = mfnet

    def __call__(self, generator: torch.Generator, raw_batch: Dict[str, np.ndarray],
                 mesh=None) -> Dict[str, torch.Tensor]:
        n, h, w = raw_batch["rgb_day"].shape[:3]
        if self.mfnet:
            params = draw_train_params(generator, n, (h, w), self.crop_hw, mod_drop=False)
            chain = mf_train_sample_preprocess
        else:
            lo, hi = TRAIN_WINDOW
            params = draw_train_params(generator, n, (h, len(range(w)[lo:hi])),
                                       self.crop_hw)
            chain = train_sample_preprocess
        keys = ("rgb_day", "ir_day", "label_day", "rgb_night", "ir_night")
        if mesh is not None:
            params = dataclasses.replace(params, **shard_batch(mesh, dataclasses.asdict(params)))
            raw_batch = shard_batch(mesh, {k: raw_batch[k] for k in keys})
        t = {k: to_device(raw_batch[k], self.device) for k in keys}
        out = chain(params, t["rgb_day"], t["ir_day"], t["label_day"], t["rgb_night"],
                    t["ir_night"], crop_hw=self.crop_hw)
        out["label_day"] = out["label_day"].long()
        return out
