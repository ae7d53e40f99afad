"""``heatnet_tpu_torch/eval/metrics.py::calculate_ious`` against the JAX
package's on random class maps with ignore (13) and background (12) pixels
and classes absent from both maps: NaN at the same positions, the other
values within 1e-12."""

import numpy as np
import pytest

from heatnet_tpu.eval import metrics as jax_metrics
from heatnet_tpu_torch.eval import metrics


def test_constants_equal_jax():
    assert metrics.BACKGROUND_CLASS_IDX == jax_metrics.BACKGROUND_CLASS_IDX == 12
    assert metrics.IGNORE_CLASS_IDX == jax_metrics.IGNORE_CLASS_IDX == 13


@pytest.mark.parametrize("seed", range(4))
def test_calculate_ious_equals_jax(seed):
    rng = np.random.RandomState(seed)
    shape = (2, 17, 23)
    classes = rng.choice(14, 6 + seed, replace=False)  # the others absent
    pred = rng.choice(classes, shape)
    target = rng.choice(np.append(classes, [12, 13]), shape)
    for n_classes in (13, 14, 9):
        want = jax_metrics.calculate_ious(pred, target, n_classes)
        got = metrics.calculate_ious(pred, target, n_classes)
        assert got.shape == want.shape
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        assert np.isnan(got).any() and not np.isnan(got).all()
        np.testing.assert_allclose(got[~np.isnan(got)], want[~np.isnan(want)],
                                   rtol=0, atol=1e-12)
