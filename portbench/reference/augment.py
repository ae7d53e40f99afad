"""The training inputs' maths, frozen: HeatNet's train chain and its draws.

The reference works out the augmented batch for itself from the raw frames
and the seed's generator: the same draws in the same order as the trainer
makes them (``thermal_loader.py``'s ThermalDataLoader and the conf
trainer's ``_augment_day``), then the same arithmetic, in float32.

Per step the draws are, from one CPU ``torch.Generator``: the crop offsets
(``randint`` rows, then columns), day flip, night flip, day rotation and its
angle, night rotation and its angle, the modality-drop rectangles (heights,
widths, rows, columns); then, in a seg step only, the seg augmentation: the
modality-drop coin, which modality, the IR-scale coin and factor, the
per-class scale coin and its 14 factors.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

IR_MIN, IR_MAX = 21800.0, 25000.0
TRAIN_WINDOW = (150, 850)


def draw_train(gen: torch.Generator, n: int, in_hw: Tuple[int, int],
               crop_hw: Tuple[int, int], max_angle: float = 20.0) -> Dict[str, torch.Tensor]:
    i = torch.randint(0, in_hw[0] - crop_hw[0] + 1, (n,), generator=gen)
    j = torch.randint(0, in_hw[1] - crop_hw[1] + 1, (n,), generator=gen)

    def coin():
        return torch.rand(n, generator=gen) > 0.5

    def angle():
        return (torch.rand(n, generator=gen) - 0.5) * 2.0 * max_angle

    d = {"i": i, "j": j, "flip_day": coin(), "flip_night": coin(),
         "rot_day": coin(), "angle_day": angle(), "rot_night": coin(),
         "angle_night": angle()}
    h = (100 + torch.rand(n, generator=gen) * 200).to(torch.int32)
    w = (100 + torch.rand(n, generator=gen) * 400).to(torch.int32)
    ri = (torch.rand(n, generator=gen) * (crop_hw[0] - h)).to(torch.int32)
    rj = (torch.rand(n, generator=gen) * (crop_hw[1] - w)).to(torch.int32)
    d["rect"] = torch.stack([ri, rj, h, w], 1)
    return d


def draw_seg(gen: torch.Generator, num_classes: int = 13) -> Dict[str, object]:
    moddrop = bool(torch.rand((), generator=gen) > 0.5)
    drop_rgb = bool(torch.rand((), generator=gen) > 0.5)
    irscale = bool(torch.rand((), generator=gen) > 0.5)
    factor = float(0.1 + 0.9 * torch.rand((), generator=gen))
    smart = bool(torch.rand((), generator=gen) > 0.5)
    smart_factors = 0.1 + 0.9 * torch.rand(num_classes + 1, generator=gen)
    return {"moddrop": moddrop, "drop_rgb": drop_rgb, "irscale": irscale,
            "factor": factor, "smart": smart, "smart_factors": smart_factors}


def _rotate(img: torch.Tensor, angle: torch.Tensor, nearest: bool) -> torch.Tensor:
    """Counter-clockwise about the centre, inverse-mapped; outside -> 0."""
    n, h, w, _ = img.shape
    th = angle.float() * math.pi / 180.0
    cos, sin = torch.cos(th).view(n, 1, 1), torch.sin(th).view(n, 1, 1)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = torch.arange(h, dtype=torch.float32, device=img.device).view(h, 1) - cy
    xx = torch.arange(w, dtype=torch.float32, device=img.device).view(1, w) - cx
    sy = sin * xx + cos * yy + cy
    sx = cos * xx - sin * yy + cx
    inside = (sy >= 0) & (sy <= h - 1) & (sx >= 0) & (sx <= w - 1)
    f = img.float()
    b = torch.arange(n, device=img.device).view(n, 1, 1)
    if nearest:
        out = f[b, torch.round(sy).long().clamp(0, h - 1), torch.round(sx).long().clamp(0, w - 1)]
    else:
        y0 = torch.floor(sy).long().clamp(0, h - 1)
        x0 = torch.floor(sx).long().clamp(0, w - 1)
        y1, x1 = (y0 + 1).clamp(0, h - 1), (x0 + 1).clamp(0, w - 1)
        wy = (sy - y0).clamp(0.0, 1.0)[..., None]
        wx = (sx - x0).clamp(0.0, 1.0)[..., None]
        out = (f[b, y0, x0] * (1 - wy) * (1 - wx) + f[b, y1, x0] * wy * (1 - wx)
               + f[b, y0, x1] * (1 - wy) * wx + f[b, y1, x1] * wy * wx)
    out = torch.where(inside[..., None], out, 0.0)
    return out if img.dtype.is_floating_point else out.to(img.dtype)


def _ir01(ir: torch.Tensor) -> torch.Tensor:
    return (ir.to(torch.float32).clamp(IR_MIN, IR_MAX) - IR_MIN) / (IR_MAX - IR_MIN)


def augment(raw: Dict[str, torch.Tensor], d: Dict[str, torch.Tensor],
            crop_hw: Tuple[int, int]) -> Dict[str, torch.Tensor]:
    """Raw frames on one device (``rgb_*`` uint8 NHW3, ``ir_*`` int32 counts
    NHW, ``label_day`` uint8 NHW) and a step's ``draw_train`` -> float32
    NHWC images in [-1, 1] and int64 day labels."""
    lo, hi = TRAIN_WINDOW
    h, w = crop_hw
    dev = raw["rgb_day"].device

    def crop(x):
        x = x[:, :, lo:hi]
        return torch.stack([x[k, int(a):int(a) + h, int(b):int(b) + w]
                            for k, (a, b) in enumerate(zip(d["i"].tolist(), d["j"].tolist()))])

    rgb_d = crop(raw["rgb_day"]).float() / 255.0
    rgb_n = crop(raw["rgb_night"]).float() / 255.0
    ir_d = crop(_ir01(raw["ir_day"])[..., None])
    ir_n = crop(_ir01(raw["ir_night"])[..., None])
    lab = crop(raw["label_day"][..., None])

    def flip(do, *xs):
        m = do.to(dev).view(-1, 1, 1, 1)
        return [torch.where(m, x.flip(2), x) for x in xs]

    rgb_d, ir_d, lab = flip(d["flip_day"], rgb_d, ir_d, lab)
    rgb_n, ir_n = flip(d["flip_night"], rgb_n, ir_n)

    def rot(do, ang, xs, nearest=False):
        m = do.to(dev).view(-1, 1, 1, 1)
        a = ang.to(dev)
        return [torch.where(m, _rotate(x, a, nearest), x) for x in xs]

    rgb_d, ir_d = rot(d["rot_day"], d["angle_day"], (rgb_d, ir_d))
    (lab,) = rot(d["rot_day"], d["angle_day"], (lab,), nearest=True)
    rgb_n, ir_n = rot(d["rot_night"], d["angle_night"], (rgb_n, ir_n))
    return {"rgb_day": (rgb_d - 0.5) / 0.5, "ir_day": (ir_d - 0.5) / 0.5,
            "rgb_night": (rgb_n - 0.5) / 0.5, "ir_night": (ir_n - 0.5) / 0.5,
            "label_day": lab[..., 0].long(), "rect": d["rect"]}


def augment_day(batch: Dict[str, torch.Tensor], s: Dict[str, object], moddrop: bool,
                irscale: bool, smartirscale: bool = False) -> Dict[str, torch.Tensor]:
    """The seg step's extra augmentation of the day inputs: one rectangle of
    one modality zeroed, the IR scaled, the IR scaled per class."""
    rgb, ir = batch["rgb_day"], batch["ir_day"]
    if moddrop and s["moddrop"]:
        n, h, w, _ = rgb.shape
        p = batch["rect"].to(device=rgb.device, dtype=torch.int64)
        rows = torch.arange(h, device=rgb.device).view(1, h, 1)
        cols = torch.arange(w, device=rgb.device).view(1, 1, w)
        i, j, hh, ww = (p[:, k].view(n, 1, 1) for k in range(4))
        inside = ((rows >= i) & (rows < i + hh) & (cols >= j) & (cols < j + ww))[..., None]
        if s["drop_rgb"]:
            rgb = torch.where(inside, 0.0, rgb)
        else:
            ir = torch.where(inside, 0.0, ir)
    if irscale and s["irscale"]:
        ir = ir * s["factor"]
    if smartirscale and s["smart"]:
        f = s["smart_factors"].to(device=ir.device, dtype=ir.dtype)
        ir = ir * f[batch["label_day"].clamp(0, f.shape[0] - 1)][..., None]
    return dict(batch, rgb_day=rgb, ir_day=ir)


def ingest(rgb: torch.Tensor, ir: torch.Tensor) -> torch.Tensor:
    """Serving's input: uint8 RGB and IR counts (NHW1) -> the float32
    early-fusion input cat(rgb, ir) in [-1, 1]."""
    r = (rgb.float() / 255.0 - 0.5) / 0.5
    i = (_ir01(ir) - 0.5) / 0.5
    return torch.cat([r, i], -1)
