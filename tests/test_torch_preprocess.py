"""Port ingest (heatnet_tpu_torch.ops) against the JAX package's.

Inputs come from numpy with a fixed seed and go through both packages. The
Pallas kernels run in interpret mode, as tests/test_pallas.py runs them.
Each case names the crop convention it matches:

- loaders 148:852 (data/loaders.py:258-259,291-292), which
  inference_preprocess_fused also uses, and which pack frames already have;
- the reference window 150:850 of inference_preprocess (bench.py:195-197).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heatnet_tpu.eval.validate import _device_normalize
from heatnet_tpu.ops import pallas_preproc as pp
from heatnet_tpu.ops import preprocess as P
from heatnet_tpu_torch.ops import fused_preproc as fp
from heatnet_tpu_torch.ops import preprocess as tp

torch.set_num_threads(2)


def _frames(seed, n, h, w):
    rng = np.random.RandomState(seed)
    rgb = rng.randint(0, 256, (n, h, w, 3)).astype(np.uint8)
    ir = rng.randint(20000, 27000, (n, h, w, 1)).astype(np.uint16)
    ir.flat[:3] = (0, 65535, 21800)  # both clamp ends and the window's edge
    return rgb, ir


def _t(a):
    return torch.from_numpy(a)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_fused_ingest_matches_pallas_window_148_852(out_dtype):
    """Loader convention 148:852 on 960-wide frames."""
    rgb, ir = _frames(0, 2, 4, 960)
    jdt = jnp.float32 if out_dtype == torch.float32 else jnp.bfloat16
    j_rgb, j_ir = pp.inference_preprocess_fused(
        jnp.asarray(rgb), jnp.asarray(ir), out_dtype=jdt, interpret=True)
    t_rgb, t_ir = fp.inference_preprocess_fused(_t(rgb), _t(ir), 148, 852,
                                                out_dtype=out_dtype)
    fused = fp.early_fusion_input(_t(rgb), _t(ir), 148, 852, out_dtype)
    assert t_rgb.dtype == out_dtype and t_rgb.shape == (2, 4, 704, 3)
    # bf16: both sides round an f32 value that may differ in its last bit
    # (XLA contracts x/255 - .5 otherwise), so one bf16 step, at most 2^-8
    atol = 1e-6 if out_dtype == torch.float32 else 2.0 ** -8
    for t, j in ((t_rgb, j_rgb), (t_ir, j_ir)):
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(j, np.float32), atol=atol)
    np.testing.assert_allclose(
        fused.float().numpy(),
        np.concatenate([np.asarray(j_rgb, np.float32),
                        np.asarray(j_ir, np.float32)], -1), atol=atol)


def test_pack_frames_match_device_normalize():
    """Pack frames are already cropped 148:852; the window is (0, 704)."""
    rgb, ir = _frames(1, 2, 6, 704)
    ref = np.concatenate([np.asarray(_device_normalize(jnp.asarray(rgb))),
                          np.asarray(_device_normalize(jnp.asarray(ir)))], -1)
    out = fp.early_fusion_input(_t(rgb), _t(ir), 0, 704, torch.float32)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)
    for x in (rgb, ir):
        np.testing.assert_allclose(
            tp.device_normalize(_t(x)).numpy(),
            np.asarray(_device_normalize(jnp.asarray(x))), atol=1e-6)


def test_inference_preprocess_matches_reference_window_150_850():
    """Reference convention 150:850 (bench.py crops this, then pads 2+2)."""
    rgb, ir = _frames(2, 2, 4, 960)
    j_rgb, j_ir = P.inference_preprocess(jnp.asarray(rgb), jnp.asarray(ir))
    t_rgb, t_ir = tp.inference_preprocess(_t(rgb), _t(ir))
    assert t_rgb.shape == (2, 4, 700, 3) and t_ir.shape == (2, 4, 700, 1)
    np.testing.assert_allclose(t_rgb.numpy(), np.asarray(j_rgb), atol=1e-6)
    np.testing.assert_allclose(t_ir.numpy(), np.asarray(j_ir), atol=1e-6)
    # the fused ingest on the same window gives the same numbers
    f_rgb, f_ir = fp.inference_preprocess_fused(_t(rgb), _t(ir), 150, 850,
                                                out_dtype=torch.float32)
    np.testing.assert_allclose(f_rgb.numpy(), np.asarray(j_rgb), atol=1e-6)
    np.testing.assert_allclose(f_ir.numpy(), np.asarray(j_ir), atol=1e-6)


@pytest.mark.parametrize("shape", [(5, 7), (1, 3, 13), (2, 1, 5, 11)])
def test_tail_not_a_multiple_of_128(shape):
    """Element counts that are not lane multiples (Pallas pads the tail)."""
    rng = np.random.RandomState(3)
    rgb = rng.randint(0, 256, shape + (3,)).astype(np.uint8)
    ir = rng.randint(20000, 27000, shape + (1,)).astype(np.uint16)
    j_rgb = pp.rgb_normalize_fused(jnp.asarray(rgb), out_dtype=jnp.float32,
                                   interpret=True)
    j_ir = pp.ir_normalize_fused(jnp.asarray(ir), out_dtype=jnp.float32,
                                 interpret=True)
    np.testing.assert_allclose(
        fp.rgb_normalize_fused(_t(rgb), torch.float32).numpy(),
        np.asarray(j_rgb), atol=1e-6)
    np.testing.assert_allclose(
        fp.ir_normalize_fused(_t(ir), torch.float32).numpy(),
        np.asarray(j_ir), atol=1e-6)
    # a window that leaves a ragged width
    w = shape[-1]
    lo, hi = 1, w - 2
    out = fp.early_fusion_input(_t(rgb), _t(ir), lo, hi, torch.float32)
    ref = np.concatenate([np.asarray(j_rgb), np.asarray(j_ir)], -1)[..., lo:hi, :]
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)


def test_window_crop_matches():
    x = np.arange(2 * 3 * 20 * 3).reshape(2, 3, 20, 3)
    for a in (x, x[0], x[0, ..., 0]):
        np.testing.assert_array_equal(
            tp.window_crop(_t(a), 4, 15).numpy(),
            np.asarray(P.window_crop(jnp.asarray(a), 4, 15)))


@pytest.mark.parametrize("bad", [
    lambda rgb, ir: fp.early_fusion_input(rgb.to(torch.int16), ir, 0, 8),
    lambda rgb, ir: fp.early_fusion_input(rgb, ir.to(torch.int32), 0, 8),
    lambda rgb, ir: fp.early_fusion_input(rgb, ir, 4, 9),
    lambda rgb, ir: fp.early_fusion_input(rgb, ir[:1], 0, 8),
    lambda rgb, ir: fp.early_fusion_input(rgb.transpose(1, 2), ir, 0, 4),
    lambda rgb, ir: fp.rgb_normalize_fused(rgb, torch.float16),
])
def test_ingest_rejects_bad_input(bad):
    rgb, ir = _frames(4, 2, 4, 8)
    with pytest.raises(ValueError):
        bad(_t(rgb), _t(ir))
