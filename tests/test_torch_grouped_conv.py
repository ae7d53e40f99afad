"""Port grouped 3x3 conv (heatnet_tpu_torch.ops.grouped_conv) against Pallas.

The JAX side is ``grouped_conv3x3_blockdiag`` / ``grouped_conv3x3_fused`` in
interpret mode, as tests/test_pallas.py runs them, at each ResNeXt-50
stage's (C, channels per group, dilation) and a small H x W. Inputs come from
numpy with a fixed seed; the JAX kernel (3, 3, cpg, C) is the port's weight
(C, cpg, 3, 3) transposed. f32, atol 1e-3 as test_pallas.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heatnet_tpu.ops.pallas_grouped_conv import (grouped_conv3x3_blockdiag,
                                                 grouped_conv3x3_fused)
from heatnet_tpu_torch.ops import grouped_conv as gc

torch.set_num_threads(2)

GROUPS = 64
# (C, channels per group, dilation) of mod2..mod5 (trgb_segnet.py:92-96)
STAGES = [(128, 2, 1), (256, 4, 1), (512, 8, 2), (1024, 16, 4)]


def _inputs(c, cpg, seed=0, n=2, h=6, w=9):
    rng = np.random.RandomState(seed + c)
    x = rng.randn(n, h, w, c).astype(np.float32)
    w_t = (rng.randn(c, cpg, 3, 3) * 0.3).astype(np.float32)
    scale = (rng.rand(c) + 0.5).astype(np.float32)
    bias = (rng.randn(c) * 0.5).astype(np.float32)
    return x, w_t, scale, bias


def _jax_kernel(w_t):
    return jnp.asarray(w_t.transpose(2, 3, 1, 0))  # (C,cpg,3,3) -> (3,3,cpg,C)


@pytest.mark.parametrize("c,cpg,d", STAGES)
def test_grouped_conv_matches_blockdiag(c, cpg, d):
    x, w_t, _, _ = _inputs(c, cpg)
    ref = grouped_conv3x3_blockdiag(jnp.asarray(x), _jax_kernel(w_t),
                                    groups=GROUPS, dilation=d,
                                    dtype=jnp.float32, interpret=True)
    out = gc.grouped_conv3x3(torch.from_numpy(x), torch.from_numpy(w_t),
                             GROUPS, d)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-3)


@pytest.mark.parametrize("c,cpg,d", STAGES)
@pytest.mark.parametrize("act", ["relu", "leaky_relu", "elu", "none"])
def test_grouped_conv_fused_matches_pallas_fused(c, cpg, d, act):
    x, w_t, scale, bias = _inputs(c, cpg, seed=1)
    ref = grouped_conv3x3_fused(
        jnp.asarray(x), _jax_kernel(w_t), jnp.asarray(scale), jnp.asarray(bias),
        groups=GROUPS, dilation=d, dtype=jnp.float32, act=act, slope=0.05,
        interpret=True)
    out = gc.grouped_conv3x3_fused(
        torch.from_numpy(x), torch.from_numpy(w_t), torch.from_numpy(scale),
        torch.from_numpy(bias), GROUPS, d, act, 0.05)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-3)


def test_grouped_conv_plain_matches_library_conv():
    """The 9-tap sum is the grouped conv that F.conv2d computes."""
    x, w_t, _, _ = _inputs(256, 4, n=1, h=7, w=5)
    for d in (1, 3):
        ref = torch.nn.functional.conv2d(
            torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(w_t),
            padding=d, dilation=d, groups=GROUPS).permute(0, 2, 3, 1)
        out = gc.grouped_conv3x3_plain(torch.from_numpy(x),
                                       torch.from_numpy(w_t), GROUPS, d)
        np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-4)


@pytest.mark.parametrize("bad", [
    lambda x, w, s, b: gc.grouped_conv3x3(x, w[:, :1], GROUPS),
    lambda x, w, s, b: gc.grouped_conv3x3(x[..., :100], w, GROUPS),
    lambda x, w, s, b: gc.grouped_conv3x3(x, w, GROUPS, 0),
    lambda x, w, s, b: gc.grouped_conv3x3_fused(x, w, s, b, GROUPS, 1, "gelu"),
    lambda x, w, s, b: gc.grouped_conv3x3_fused(x, w, s[:64], b, GROUPS),
    lambda x, w, s, b: gc.grouped_conv3x3_fused(x, w, s, None, GROUPS),
])
def test_grouped_conv_rejects_bad_input(bad):
    x, w_t, scale, bias = (torch.from_numpy(a) for a in _inputs(128, 2))
    with pytest.raises(ValueError):
        bad(x, w_t, scale, bias)
