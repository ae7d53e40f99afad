"""Eval-time image preprocessing, plain PyTorch (NHWC).

Counterpart of ``heatnet_tpu/ops/preprocess.py:29-57,120-127,289-305`` and of
``heatnet_tpu/eval/validate.py:52-68`` (``_device_normalize``). The chain is
the reference loader's (thermal_loader.py:633-659, :711-728): window crop →
radiometric IR clamp [21800, 25000] → [0, 1] → normalise (mean .5, std .5).

There are two crop conventions, and callers say which they follow:

- ``inference_preprocess`` crops 150:850 (the reference's window, width 700,
  as ``bench.py:195-197`` does before zero-padding 2 columns a side);
- the loaders and the fused ingest crop the stride-aligned 148:852
  (``data/loaders.py:258-259,291-292``, width 704).

The fused single-pass versions are in ``ops/fused_preproc.py``.
"""

from __future__ import annotations

from typing import Sequence

import torch

# Radiometric window of the FLIR unit used for Freiburg Thermal
# (thermal_loader.py:649-659)
IR_MINVAL = 21800.0
IR_MAXVAL = 25000.0

RGB_MEAN = (0.5, 0.5, 0.5)
RGB_STD = (0.5, 0.5, 0.5)


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
