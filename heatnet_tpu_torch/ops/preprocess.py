"""Image preprocessing, plain PyTorch (NHWC): eval ingest and train augmentation.

Counterpart of ``heatnet_tpu/ops/preprocess.py:29-115,120-281,289-353``
and of ``heatnet_tpu/eval/validate.py:52-68`` (``_device_normalize``). The
eval chain is the reference loader's (thermal_loader.py:633-659, :711-728):
window crop → radiometric IR clamp [21800, 25000] → [0, 1] → normalise (mean
.5, std .5). The train chain (``train_sample_preprocess``) adds a shared
random crop and independent day/night flips and rotations;
``mf_train_sample_preprocess`` is MFNet's (no window, 8-bit IR scaled by
1/255, no radiometric clamp, no modality-drop rectangle). The adversarial
trainer's seg phase adds ``rect_drop``, ``ir_scale_aug`` and
``(maybe_)smart_augment`` on the batch (:224-281), each draw an argument
(``draw_ir_scale``, ``draw_smart_augment``).

The train functions work on batches with per-sample parameters. Drawing the
parameters (``draw_train_params``, from an explicit ``torch.Generator``) is
separate from applying them, so a caller can apply parameters drawn
elsewhere, e.g. from a JAX key in the tests; the two frameworks' generators
give different numbers from one seed.

There are two crop conventions, and callers say which they follow:

- ``inference_preprocess`` crops 150:850 (the reference's window, width 700,
  as ``bench.py:195-197`` does before zero-padding 2 columns a side);
- the loaders and the fused ingest crop the stride-aligned 148:852
  (``data/loaders.py:258-259,291-292``, width 704).

The fused single-pass versions are in ``ops/fused_preproc.py``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

# Radiometric window of the FLIR unit used for Freiburg Thermal
# (thermal_loader.py:649-659)
IR_MINVAL = 21800.0
IR_MAXVAL = 25000.0

RGB_MEAN = (0.5, 0.5, 0.5)
RGB_STD = (0.5, 0.5, 0.5)

# Vistas training statistics (thermal_loader.py:22-23, vistas_dataset.py:150-151)
VISTAS_MEAN = (0.35675976, 0.37380189, 0.3764753)
VISTAS_STD = (0.32064945, 0.32098866, 0.32325324)


def ir_normalize(ir: torch.Tensor, minval: float = IR_MINVAL,
                 maxval: float = IR_MAXVAL) -> torch.Tensor:
    """Clamp 16-bit thermal counts to the radiometric window, scale to [0,1].

    uint16 has little PyTorch support (on CUDA least of all), so counts go
    through int32 first, from the int16 view of their bits.
    """
    if ir.dtype == torch.uint16:
        ir = ir.view(torch.int16).to(torch.int32) & 0xFFFF
    ir = ir.to(torch.float32)
    ir = torch.clamp(ir, minval, maxval)
    return (ir - minval) / (maxval - minval)


def normalize(img: torch.Tensor, mean: Sequence[float] = RGB_MEAN,
              std: Sequence[float] = RGB_STD) -> torch.Tensor:
    """Channelwise (x - mean) / std over the last (channel) axis."""
    mean_t = torch.tensor(mean, dtype=torch.float32, device=img.device)
    std_t = torch.tensor(std, dtype=torch.float32, device=img.device)
    return (img.to(torch.float32) - mean_t) / std_t


def denormalize(img: torch.Tensor, mean: Sequence[float] = RGB_MEAN,
                std: Sequence[float] = RGB_STD) -> torch.Tensor:
    """The inverse of ``normalize``: ``img * std + mean``, float32."""
    mean_t = torch.tensor(mean, dtype=torch.float32, device=img.device)
    std_t = torch.tensor(std, dtype=torch.float32, device=img.device)
    return img.to(torch.float32) * std_t + mean_t


def _axis_weights(size_in: int, size_out: int, nearest: bool) -> np.ndarray:
    """The (size_out, size_in) interpolation matrix of one axis, cv2's
    conventions: INTER_LINEAR samples ``(dst + 0.5) * scale - 0.5``, edge
    clamped; INTER_NEAREST ``floor(dst * scale)``, no half-pixel shift."""
    scale = size_in / size_out
    m = np.zeros((size_out, size_in), np.float32)
    if nearest:
        idx = np.minimum(np.floor(np.arange(size_out) * scale), size_in - 1)
        m[np.arange(size_out), idx.astype(int)] = 1.0
        return m
    src = (np.arange(size_out) + 0.5) * scale - 0.5
    i0 = np.clip(np.floor(src), 0, size_in - 1).astype(int)
    i1 = np.minimum(i0 + 1, size_in - 1)
    frac = np.clip(src - i0, 0.0, 1.0)
    np.add.at(m, (np.arange(size_out), i0), 1.0 - frac)
    np.add.at(m, (np.arange(size_out), i1), frac)
    return m


def resize(img: torch.Tensor, out_hw: Tuple[int, int],
           method: str = "bilinear") -> torch.Tensor:
    """NHWC, HWC or HW ``img`` to ``out_hw`` with cv2's conventions, in
    float32 (``bilinear``: INTER_LINEAR, half-pixel centres, no antialiasing
    on downscale; ``nearest``: INTER_NEAREST, integer images keep their
    dtype): one interpolation matrix per axis, as the JAX version (:92)."""
    x = img[None, ..., None] if img.dim() == 2 else img[None] if img.dim() == 3 else img
    _, h, w, _ = x.shape
    nearest = method == "nearest"
    mh = torch.from_numpy(_axis_weights(h, out_hw[0], nearest)).to(img.device)
    mw = torch.from_numpy(_axis_weights(w, out_hw[1], nearest)).to(img.device)
    out = torch.einsum("oh,nhwc->nowc", mh, x.to(torch.float32))
    out = torch.einsum("pw,nowc->nopc", mw, out)
    if nearest and not img.dtype.is_floating_point:
        out = torch.round(out).to(img.dtype)
    if img.dim() == 2:
        return out[0, ..., 0]
    return out[0] if img.dim() == 3 else out


def window_crop(img: torch.Tensor, col_lo: int = 150,
                col_hi: int = 850) -> torch.Tensor:
    """Static column window of HW, HWC or NHWC images (a view)."""
    if img.dim() == 2:
        return img[:, col_lo:col_hi]
    if img.dim() == 3:
        return img[:, col_lo:col_hi, :]
    return img[:, :, col_lo:col_hi, :]


def inference_preprocess(rgb: torch.Tensor, ir: torch.Tensor,
                         normalize_rgb: bool = True):
    """uint8 RGB (N,H,960,3) and uint16 IR (N,H,960,1) → float32 in [-1, 1],
    cropped to the reference window 150:850."""
    rgb = window_crop(rgb)
    ir = window_crop(ir)
    ir = ir_normalize(ir)
    rgb = rgb.to(torch.float32) / 255.0
    if normalize_rgb:
        rgb = normalize(rgb)
    ir = normalize(ir, mean=(0.5,), std=(0.5,))
    return rgb, ir


def device_normalize(x: torch.Tensor) -> torch.Tensor:
    """Raw sensor dtypes → normalised float32; float inputs pass through."""
    if x.dtype == torch.uint8:
        return normalize(x.to(torch.float32) / 255.0)
    if x.dtype == torch.uint16:
        return normalize(ir_normalize(x), mean=(0.5,), std=(0.5,))
    return x


# ---------------------------------------------------------------------------
# Train-time augmentation (batched, per-sample parameters)
# ---------------------------------------------------------------------------

# The reference window of the train loader (thermal_loader.py:633-638)
TRAIN_WINDOW = (150, 850)


def random_crop_params(generator: torch.Generator, n: int,
                       in_hw: Tuple[int, int], out_hw: Tuple[int, int]):
    """(i, j), each (n,) int64, of uniform random crops
    (transforms.RandomCrop.get_params)."""
    i = torch.randint(0, in_hw[0] - out_hw[0] + 1, (n,), generator=generator)
    j = torch.randint(0, in_hw[1] - out_hw[1] + 1, (n,), generator=generator)
    return i, j


def crop_at(img: torch.Tensor, i: Sequence[int], j: Sequence[int],
            out_hw: Tuple[int, int]) -> torch.Tensor:
    """Per-sample crop of an NHWC batch at offsets ``i[k], j[k]``."""
    h, w = out_hw
    return torch.stack([img[k, int(a):int(a) + h, int(b):int(b) + w]
                        for k, (a, b) in enumerate(zip(i, j))])


def hflip(img: torch.Tensor) -> torch.Tensor:
    """Horizontal flip of an NHWC batch."""
    return img.flip(2)


def maybe_hflip(do: torch.Tensor, *imgs: torch.Tensor):
    """Flip the samples where ``do`` (N,) bool is set, all images together
    (thermal_loader.py:685-692)."""
    out = tuple(torch.where(do.view(-1, 1, 1, 1), hflip(im), im) for im in imgs)
    return out if len(out) > 1 else out[0]


def rotate(img: torch.Tensor, angle_deg: torch.Tensor, method: str = "bilinear",
           fill: float = 0.0) -> torch.Tensor:
    """Rotate each NHWC sample about its centre by ``angle_deg`` (N,) degrees,
    counter-clockwise (PIL ``Image.rotate``).

    Inverse-mapped sampling with explicit gathers: ``bilinear`` for images,
    ``nearest`` (round half to even) for label maps (thermal_loader.py:695-705);
    pixels that map outside the frame get ``fill``. Integer images come back
    in their dtype, truncated. ``F.grid_sample`` is not used: its corner and
    out-of-bounds rules differ.
    """
    n, h, w, _ = img.shape
    theta = angle_deg.to(torch.float32) * math.pi / 180.0
    cos = torch.cos(theta).view(n, 1, 1)
    sin = torch.sin(theta).view(n, 1, 1)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = torch.arange(h, dtype=torch.float32, device=img.device).view(h, 1) - cy
    xx = torch.arange(w, dtype=torch.float32, device=img.device).view(1, w) - cx
    src_y = sin * xx + cos * yy + cy
    src_x = cos * xx - sin * yy + cx
    inside = (src_y >= 0) & (src_y <= h - 1) & (src_x >= 0) & (src_x <= w - 1)

    img_f = img.to(torch.float32)
    b = torch.arange(n, device=img.device).view(n, 1, 1)
    if method == "nearest":
        iy = torch.round(src_y).long().clamp(0, h - 1)
        ix = torch.round(src_x).long().clamp(0, w - 1)
        out = img_f[b, iy, ix]
    else:
        y0 = torch.floor(src_y).long().clamp(0, h - 1)
        x0 = torch.floor(src_x).long().clamp(0, w - 1)
        y1 = (y0 + 1).clamp(0, h - 1)
        x1 = (x0 + 1).clamp(0, w - 1)
        wy = (src_y - y0).clamp(0.0, 1.0)[..., None]
        wx = (src_x - x0).clamp(0.0, 1.0)[..., None]
        out = (img_f[b, y0, x0] * (1 - wy) * (1 - wx)
               + img_f[b, y1, x0] * wy * (1 - wx)
               + img_f[b, y0, x1] * (1 - wy) * wx
               + img_f[b, y1, x1] * wy * wx)
    out = torch.where(inside[..., None], out, fill)
    return out if img.dtype.is_floating_point else out.to(img.dtype)


def maybe_rotate_pair(do: torch.Tensor, angle_deg: torch.Tensor,
                      images: Sequence[torch.Tensor],
                      labels: Sequence[torch.Tensor] = ()):
    """Where ``do`` is set, rotate images (bilinear) and labels (nearest) by
    the sample's shared angle (thermal_loader.py:695-705)."""
    m = do.view(-1, 1, 1, 1)
    outs_i = tuple(torch.where(m, rotate(im, angle_deg, "bilinear"), im)
                   for im in images)
    outs_l = tuple(torch.where(m, rotate(lb, angle_deg, "nearest"), lb)
                   for lb in labels)
    return outs_i, outs_l


def rect_drop_params(generator: torch.Generator, n: int,
                     hw: Tuple[int, int]) -> torch.Tensor:
    """(n, 4) int32 [i, j, h, w] rectangles: h in [100, 300), w in [100, 500),
    placed uniformly inside the (H, W) frame (thermal_loader.py:661-666)."""
    h = (100 + torch.rand(n, generator=generator) * 200).to(torch.int32)
    w = (100 + torch.rand(n, generator=generator) * 400).to(torch.int32)
    i = (torch.rand(n, generator=generator) * (hw[0] - h)).to(torch.int32)
    j = (torch.rand(n, generator=generator) * (hw[1] - w)).to(torch.int32)
    return torch.stack([i, j, h, w], dim=1)


@dataclasses.dataclass
class TrainAugParams:
    """The random draws of ``train_sample_preprocess``, one row per sample."""

    crop_i: torch.Tensor       # (N,) int, crop offsets
    crop_j: torch.Tensor
    flip_day: torch.Tensor     # (N,) bool
    flip_night: torch.Tensor
    rotate_day: torch.Tensor   # (N,) bool
    angle_day: torch.Tensor    # (N,) float32 degrees
    rotate_night: torch.Tensor
    angle_night: torch.Tensor
    mod_drop: Optional[torch.Tensor]  # (N, 4) int32, rect_drop_params; None for MFNet


def draw_train_params(generator: torch.Generator, n: int,
                      in_hw: Tuple[int, int], crop_hw: Tuple[int, int],
                      max_angle: float = 20.0, mod_drop: bool = True) -> TrainAugParams:
    """Draw the parameters of ``n`` samples on the CPU: flips and rotations
    with probability 0.5, angles uniform in [-max_angle, max_angle], and
    (``mod_drop``) the modality-drop rectangles."""
    i, j = random_crop_params(generator, n, in_hw, crop_hw)

    def coin():
        return torch.rand(n, generator=generator) > 0.5

    def angle():
        return (torch.rand(n, generator=generator) - 0.5) * 2.0 * max_angle

    return TrainAugParams(i, j, coin(), coin(), coin(), angle(), coin(), angle(),
                          rect_drop_params(generator, n, crop_hw) if mod_drop else None)


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t if t.dim() == 4 else t[..., None]


def train_sample_preprocess(params: TrainAugParams, rgb_day, ir_day, label_day,
                            rgb_night, ir_night,
                            crop_hw: Tuple[int, int] = (320, 640)
                            ) -> Dict[str, torch.Tensor]:
    """The per-sample train chain after decode + resize, over a batch.

    ``rgb_*`` uint8 (N,H,W,3), ``ir_*`` uint16 (N,H,W[,1]), ``label_day``
    uint8 (N,H,W), all on one device. As ThermalDataLoader.__getitem__
    (:596-740): window crop, the shared random crop, IR clamp, independent
    day/night flips and rotations, normalisation. Returns float32 (N,h,w,3)
    and (N,h,w,1) images, uint8 (N,h,w) day labels and ``mod_drop_params``.
    The IR is normalised before the crops, with which it commutes, so no
    uint16 tensor is indexed.
    """
    lo, hi = TRAIN_WINDOW
    ir_day, ir_night = (ir_normalize(window_crop(_nhwc(x), lo, hi))
                        for x in (ir_day, ir_night))
    rgb_day, rgb_night = (window_crop(x, lo, hi) for x in (rgb_day, rgb_night))
    label_day = window_crop(label_day[..., None], lo, hi)

    rgb_day, ir_day, label_day, rgb_night, ir_night = _crop(
        params, crop_hw, rgb_day, ir_day, label_day, rgb_night, ir_night)
    out = _flip_rotate_normalize(params, rgb_day.to(torch.float32) / 255.0, ir_day,
                                 label_day, rgb_night.to(torch.float32) / 255.0, ir_night)
    out["mod_drop_params"] = params.mod_drop
    return out


def mf_train_sample_preprocess(params: TrainAugParams, rgb_day, ir_day, label_day,
                               rgb_night, ir_night,
                               crop_hw: Tuple[int, int] = (384, 384)
                               ) -> Dict[str, torch.Tensor]:
    """MFNet's per-sample train chain over a batch (MFDatasetTrain.__getitem__,
    thermal_loader.py:322-440; ``heatnet_tpu/ops/preprocess.py:356-386``):
    the shared random crop (384x384), /255 for RGB and the 8-bit IR,
    independent day/night flips and rotations, (x - 0.5) / 0.5. ``rgb_*``
    and ``ir_*`` uint8 (N,H,W,3) and (N,H,W[,1]), ``label_day`` uint8
    (N,H,W); the parameters' ``mod_drop`` is not used."""
    rgb_day, ir_day, label_day, rgb_night, ir_night = _crop(
        params, crop_hw, rgb_day, _nhwc(ir_day), label_day[..., None], rgb_night,
        _nhwc(ir_night))
    rgb_day, ir_day, rgb_night, ir_night = (x.to(torch.float32) / 255.0 for x in
                                            (rgb_day, ir_day, rgb_night, ir_night))
    return _flip_rotate_normalize(params, rgb_day, ir_day, label_day, rgb_night, ir_night)


def _crop(params: TrainAugParams, crop_hw, *images):
    i, j = params.crop_i.tolist(), params.crop_j.tolist()
    return tuple(crop_at(x, i, j, crop_hw) for x in images)


def _flip_rotate_normalize(params: TrainAugParams, rgb_day, ir_day, label_day,
                           rgb_night, ir_night) -> Dict[str, torch.Tensor]:
    """The chains' common tail on cropped [0, 1] images and (N,h,w,1)
    labels: flips, rotations, normalisation; labels come back (N,h,w)."""
    dev = rgb_day.device
    rgb_day, ir_day, label_day = maybe_hflip(params.flip_day.to(dev),
                                             rgb_day, ir_day, label_day)
    rgb_night, ir_night = maybe_hflip(params.flip_night.to(dev),
                                      rgb_night, ir_night)
    (rgb_day, ir_day), (label_day,) = maybe_rotate_pair(
        params.rotate_day.to(dev), params.angle_day.to(dev),
        (rgb_day, ir_day), (label_day,))
    (rgb_night, ir_night), _ = maybe_rotate_pair(
        params.rotate_night.to(dev), params.angle_night.to(dev),
        (rgb_night, ir_night))
    return {
        "rgb_day": normalize(rgb_day),
        "ir_day": normalize(ir_day, (0.5,), (0.5,)),
        "label_day": label_day[..., 0],
        "rgb_night": normalize(rgb_night),
        "ir_night": normalize(ir_night, (0.5,), (0.5,)),
    }


# ---------------------------------------------------------------------------
# Seg-phase batch augmentations of the adversarial trainer (preprocess.py:224-281)
# ---------------------------------------------------------------------------


def rect_drop(batch: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """Zero one rectangle per sample of an NHWC batch (rectDropTensor, conf
    trainer :82-86); ``params`` is (N, 4) int [i, j, h, w]."""
    n, h, w, _ = batch.shape
    p = params.to(device=batch.device, dtype=torch.int64)
    rows = torch.arange(h, device=batch.device).view(1, h, 1)
    cols = torch.arange(w, device=batch.device).view(1, 1, w)
    i, j, hh, ww = (p[:, k].view(n, 1, 1) for k in range(4))
    inside = (rows >= i) & (rows < i + hh) & (cols >= j) & (cols < j + ww)
    return torch.where(inside[..., None], 0.0, batch)


def ir_scale_aug(ir: torch.Tensor, do: bool, scale: float) -> torch.Tensor:
    """Where ``do``, the whole IR batch times ``scale`` (:253-258; the draws
    are p = 0.5 and U(0.1, 1), ``draw_ir_scale``)."""
    return ir * scale if do else ir


def smart_augment(ir: torch.Tensor, label: torch.Tensor,
                  factors: torch.Tensor) -> torch.Tensor:
    """Per-class IR intensity scaling (smartAugment, :261-274): each pixel
    times the factor of its label, labels clipped to the factors' range."""
    lbl = label.long().clamp(0, factors.shape[0] - 1)
    f = factors.to(device=ir.device, dtype=ir.dtype)[lbl]
    return ir * (f[..., None] if ir.dim() == 4 else f)


def maybe_smart_augment(ir: torch.Tensor, label: torch.Tensor, do: bool,
                        factors: torch.Tensor) -> torch.Tensor:
    return smart_augment(ir, label, factors) if do else ir


def draw_ir_scale(generator: torch.Generator):
    """(do, scale): p = 0.5, scale ~ U(0.1, 1)."""
    do = bool(torch.rand((), generator=generator) > 0.5)
    return do, float(0.1 + 0.9 * torch.rand((), generator=generator))


def draw_smart_augment(generator: torch.Generator, num_classes: int = 14):
    """(do, factors): p = 0.5, one factor ~ U(0.1, 1) per class id."""
    do = bool(torch.rand((), generator=generator) > 0.5)
    return do, 0.1 + 0.9 * torch.rand(num_classes, generator=generator)
