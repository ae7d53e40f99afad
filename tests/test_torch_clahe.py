"""CLAHE on the Lab lightness plane (``heatnet_tpu_torch/data/clahe.py``)
against cv2 5.0, which the JAX package's ``apply_clahe`` calls.

Every comparison is exact, pixel for pixel:

- ``bgr_to_lab`` (``COLOR_BGR2LAB``) over a lattice of 2^20 colours, every
  16th of the 2^24 (each channel takes all 256 values), and ``lab_to_rgb``
  (``COLOR_LAB2RGB``) over the same lattice of Lab triplets; the whole 2^24
  of each under ``slow``;
- ``clahe`` (``createCLAHE(2.0, (8, 8)).apply``) at sizes that 8 divides and
  that it does not (cv2 pads with reflect-101 before tiling, a whole tile
  where 8 divides one side only), on noise (its integer clip limit and the
  residual's redistribution), flat regions (every bin clipped) and ramps
  (the bilinear blend between tile LUTs and its rounding);
- ``apply_clahe`` against the JAX package's at the same sizes.
"""

import cv2
import numpy as np
import pytest

from heatnet_tpu.data.loaders import apply_clahe as jax_apply_clahe
from heatnet_tpu_torch.data import clahe


def _lattice(stride: int) -> np.ndarray:
    """Every ``stride``-th 24-bit triplet, the offset turning so that each
    channel takes every value; (n, 1, 3) uint8."""
    k = np.arange((1 << 24) // stride, dtype=np.int64)
    idx = k * stride + (k // stride) % stride
    return np.stack([idx >> 16, (idx >> 8) & 255, idx & 255], -1).astype(np.uint8)[:, None]


def _check_lab(stride: int) -> None:
    px = _lattice(stride)
    for c in range(3):
        assert len(np.unique(px[..., c])) == 256
    np.testing.assert_array_equal(clahe.bgr_to_lab(px), cv2.cvtColor(px, cv2.COLOR_BGR2LAB))
    np.testing.assert_array_equal(clahe.lab_to_rgb(px), cv2.cvtColor(px, cv2.COLOR_LAB2RGB))


def test_lab_conversions_equal_cv2_on_a_lattice():
    _check_lab(16)


@pytest.mark.slow
def test_lab_conversions_equal_cv2_on_every_colour():
    _check_lab(1)


SIZES = [(64, 64), (61, 77), (96, 160), (100, 128), (128, 100), (37, 45), (33, 8),
         (192, 256)]


def _planes(hw, seed):
    rng = np.random.RandomState(seed)
    h, w = hw
    noise = rng.randint(0, 256, hw).astype(np.uint8)
    flat = np.full(hw, 90, np.uint8)
    flat[: h // 2] = 200
    ramp = (np.add.outer(np.arange(h), 3 * np.arange(w)) % 256).astype(np.uint8)
    steps = (noise // 40 * 40).astype(np.uint8)
    return {"noise": noise, "flat": flat, "ramp": ramp, "steps": steps}


@pytest.mark.parametrize("hw", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_clahe_equals_cv2(hw):
    ref = cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8, 8))
    for name, plane in _planes(hw, sum(hw)).items():
        np.testing.assert_array_equal(clahe.clahe(plane), ref.apply(plane), err_msg=name)


@pytest.mark.parametrize("hw", SIZES[:4], ids=[f"{h}x{w}" for h, w in SIZES[:4]])
def test_apply_clahe_equals_jax(hw):
    rng = np.random.RandomState(hw[0])
    img = rng.randint(0, 256, hw + (3,)).astype(np.uint8)
    img[: hw[0] // 3] //= 4  # a dark band: unlike tiles
    np.testing.assert_array_equal(clahe.apply_clahe(img), jax_apply_clahe(img))
