"""The JAX package's last public names in the port, against their JAX functions.

Numpy-seeded inputs, mirroring ``tests/test_preprocess.py:27``, ``:162`` and
``tests/test_metrics.py:88-105``:

- ``ops/preprocess.py``: ``VISTAS_MEAN``/``VISTAS_STD`` equal; ``denormalize``
  within 1e-6 (and the inverse of ``normalize``); ``resize`` bilinear and
  nearest, upscale and downscale, on float32 and on integer images: bilinear
  within 1e-6 of JAX's float32 einsums, nearest exact;
- ``ops/iou.py::calculate_ious_device``: NaN positions equal, values 1e-6;
- ``data/mappings.py::remap_labels``: exact, default class included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heatnet_tpu.data import mappings as jax_mappings
from heatnet_tpu.ops import iou as jax_iou
from heatnet_tpu.ops import preprocess as jax_pre
from heatnet_tpu_torch.data import mappings
from heatnet_tpu_torch.ops import iou
from heatnet_tpu_torch.ops import preprocess as pre


def test_vistas_statistics_and_denormalize_equal_jax():
    assert pre.VISTAS_MEAN == jax_pre.VISTAS_MEAN and pre.VISTAS_STD == jax_pre.VISTAS_STD
    img = np.random.RandomState(42).rand(2, 4, 4, 3).astype(np.float32)
    for kw in ({}, {"mean": pre.VISTAS_MEAN, "std": pre.VISTAS_STD}):
        got = pre.denormalize(torch.from_numpy(img), **kw).numpy()
        np.testing.assert_allclose(got, np.asarray(jax_pre.denormalize(jnp.asarray(img), **kw)),
                                   rtol=0, atol=1e-6)
        back = pre.denormalize(pre.normalize(torch.from_numpy(img), **kw), **kw).numpy()
        np.testing.assert_allclose(back, img, rtol=0, atol=1e-6)


@pytest.mark.parametrize("method", ["bilinear", "nearest"])
@pytest.mark.parametrize("out_hw", [(20, 60), (45, 130)], ids=["down", "up"])
def test_resize_equals_jax(method, out_hw):
    rng = np.random.RandomState(42)
    for img in (rng.rand(2, 32, 96, 3).astype(np.float32) * 255,   # NHWC
                rng.rand(32, 96).astype(np.float32),                # HW
                rng.randint(0, 14, (32, 96, 1)).astype(np.uint8)):  # HWC labels
        want = np.asarray(jax_pre.resize(jnp.asarray(img), out_hw, method))
        got = pre.resize(torch.from_numpy(img), out_hw, method).numpy()
        assert got.shape == want.shape and got.dtype == want.dtype
        if method == "nearest":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_calculate_ious_device_equals_jax():
    rng = np.random.RandomState(0)
    for n_classes in (13, 14):
        pred = rng.randint(0, n_classes, size=(2, 8, 8))
        target = rng.randint(0, 14, size=(2, 8, 8))
        target[0, :4] = 13  # ignored pixels
        pred[pred == 5] = 4  # a class never predicted
        target[target == 7] = 6  # a class never in the target
        target[(target == 6) & (pred != 6)] = 13
        for p, t in ((pred, target), (pred[:, :1, :1], np.full((2, 1, 1), 13))):
            want = np.asarray(jax_iou.calculate_ious_device(jnp.asarray(p), jnp.asarray(t),
                                                            n_classes))
            got = iou.calculate_ious_device(torch.from_numpy(p), torch.from_numpy(t),
                                            n_classes).numpy()
            assert got.dtype == np.float32 and got.shape == want.shape
            np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
            np.testing.assert_allclose(got[~np.isnan(got)], want[~np.isnan(want)],
                                       rtol=1e-6, atol=0)


def test_remap_labels_equals_jax():
    rng = np.random.RandomState(42)
    for labels, mapping, kw in (
            (rng.randint(0, 66, (16, 16)), mappings.VISTAS_TO_HEATNET, {}),
            (rng.randint(0, 300, (8, 8)).astype(np.uint16), mappings.BDD_TO_HEATNET,
             {"default": 13})):
        want = jax_mappings.remap_labels(labels, mapping, **kw)
        got = mappings.remap_labels(labels, mapping, **kw)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
