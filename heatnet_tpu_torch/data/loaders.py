"""Eval loaders of PNG trees, training batches, and the augmentation on the card.

Counterpart of ``heatnet_tpu/data/loaders.py:43-67,216-339,426-591,936-983``.

The eval loaders (``FreiburgThermalTestDataset``, ``FreiburgInferDataset``,
``MFNetDataset``, ``BDDValDataset``) return the JAX loaders' items: same
keys, dtypes and shapes. They decode PNGs with ``data.png`` and resize with
``resize``, a numpy copy of ``cv2.resize`` as the JAX loaders call it, so
that the port does not depend on cv2. Only ``BDDValDataset`` needs cv2, for
JPEG. ``KAISTCycleGANDataset`` reads PNGs the same way and resizes with
``resize_pil``, a numpy copy of Pillow's resampling as the JAX loader calls
it; only a JPEG (KAIST's own frames) goes to PIL.

``batch_iterator`` and ``prefetch_items`` are copies (numpy and threads).
``DeviceAugment`` moves a raw batch to the device and runs
``ops.preprocess.train_sample_preprocess`` over it, batched, with every
sample's random parameters drawn from the caller's ``torch.Generator`` (the
JAX version vmaps the chain over per-sample keys).
"""

from __future__ import annotations

import os
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from glob import glob
from typing import Dict, Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve
from ..ops.preprocess import TRAIN_WINDOW, draw_train_params, train_sample_preprocess
from .png import _SIGNATURE as _PNG_SIGNATURE
from .png import read_png, read_png_palette

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


def stamp_sort_key(path: str) -> float:
    """Timestamp sort key (stampSortFun, thermal_loader.py:80-90)."""
    digits = []
    for s in os.path.basename(path).split("_"):
        fn = s.replace(".png", "")
        if fn.isdigit():
            digits.append(int(fn))
    return float(str(digits[0]).zfill(10) + "." + str(digits[1]).zfill(10))


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
                   seed: int = 0, drop_last: bool = True,
                   prefetch: int = 2) -> Iterator[Dict[str, np.ndarray]]:
    """Stacked-numpy batch iterator with a background prefetch thread.

    The order is a ``RandomState(seed)`` shuffle; each batch stacks the
    items' arrays key by key.
    """
    order = np.arange(len(dataset))
    if shuffle:
        np.random.RandomState(seed).shuffle(order)

    n_full = len(order) // batch_size
    tail = len(order) % batch_size
    n_batches = n_full + (0 if drop_last or tail == 0 else 1)

    stop = threading.Event()

    def produce(q: queue.Queue):
        try:
            for b in range(n_batches):
                idx = order[b * batch_size:(b + 1) * batch_size]
                items = [dataset[int(i)] for i in idx]
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
    ``mod_drop_params``, on the device.
    """

    def __init__(self, crop_hw: Tuple[int, int] = (320, 640),
                 device: Optional[Union[str, torch.device]] = None):
        self.crop_hw = tuple(crop_hw)
        self.device = resolve(device)

    def __call__(self, generator: torch.Generator,
                 raw_batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        n, h, w = raw_batch["rgb_day"].shape[:3]
        lo, hi = TRAIN_WINDOW
        params = draw_train_params(generator, n, (h, len(range(w)[lo:hi])),
                                   self.crop_hw)
        t = {k: to_device(raw_batch[k], self.device)
             for k in ("rgb_day", "ir_day", "label_day", "rgb_night", "ir_night")}
        out = train_sample_preprocess(params, t["rgb_day"], t["ir_day"],
                                      t["label_day"], t["rgb_night"],
                                      t["ir_night"], crop_hw=self.crop_hw)
        out["label_day"] = out["label_day"].long()
        return out
