"""The CUDA grouped conv's weight tiles and tile formulation, on the CPU.

``pack_weight_tiles`` gives the tensor-core kernel (csrc/grouped_conv3x3.cu)
its 16x16 block-diagonal weight tiles. These tests hold the tiles to the
diagonal blocks of the JAX ``_block_diag_taps`` (exactly: the weights are
bf16-valued, so the cast is exact), and the kernel's arithmetic, written out
here in f32 (9 shifted slices of x, each 16-channel slice times its tile),
to the Pallas kernel in interpret mode and, for dx, to ``jax.vjp`` of
``_dense_reference``, atol 1e-3 in f32 as tests/test_pallas.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from heatnet_tpu.ops.pallas_grouped_conv import (_block_diag_taps,
                                                 _dense_reference,
                                                 grouped_conv3x3_blockdiag)
from heatnet_tpu_torch.ops import grouped_conv as gc

torch.set_num_threads(2)

GROUPS = 64
STAGES = [(128, 2), (256, 4), (512, 8), (1024, 16)]


def _weight(c, cpg, seed):
    rng = np.random.RandomState(seed)
    w = torch.from_numpy((rng.randn(c, cpg, 3, 3) * 0.3).astype(np.float32))
    return w.to(torch.bfloat16).float()  # bf16-valued: the tiles' cast is exact


def _jax_kernel(w):
    return jnp.asarray(w.numpy().transpose(2, 3, 1, 0))  # -> (3, 3, cpg, C)


def _diag_blocks(w, groups):
    taps = np.asarray(_block_diag_taps(_jax_kernel(w), groups, jnp.float32))
    c = taps.shape[1]
    return np.stack([taps[:, 16 * j:16 * j + 16, 16 * j:16 * j + 16]
                     for j in range(c // 16)], 1)  # (9, C/16, ci, co)


@pytest.mark.parametrize("transpose_flip", [False, True])
@pytest.mark.parametrize("c,cpg", STAGES)
def test_pack_weight_tiles_are_the_blockdiag_diagonal(c, cpg, transpose_flip):
    groups = c // cpg
    w = _weight(c, cpg, seed=c)
    tiles = gc.pack_weight_tiles(w, groups, transpose_flip)
    assert tiles.dtype == torch.bfloat16 and tiles.shape == (9, c // 16, 16, 16)
    want = _diag_blocks(gc.dx_weight(w, groups) if transpose_flip else w, groups)
    np.testing.assert_array_equal(tiles.float().transpose(-1, -2).numpy(), want)


def _tile_conv(x, tiles, d):
    """The kernel's sum: per tap, the shifted slice's 16-channel pieces
    times their tiles (``tiles[t, j]`` is ``[co, ci]``), in f32."""
    n, h, w, c = x.shape
    xp = F.pad(x, (0, 0, d, d, d, d)).view(n, h + 2 * d, w + 2 * d, c // 16, 16)
    tf = tiles.float()
    acc = torch.zeros(n, h, w, c // 16, 16)
    for t in range(9):
        ky, kx = divmod(t, 3)
        xs = xp[:, ky * d:ky * d + h, kx * d:kx * d + w]
        acc += torch.einsum("nhwjc,joc->nhwjo", xs, tf[t])
    return acc.view(n, h, w, c)


@pytest.mark.parametrize("d", [1, 2, 4])
@pytest.mark.parametrize("cpg", [2, 4, 8, 16])
def test_tile_formulation_matches_pallas_and_vjp(cpg, d):
    c, groups = 128, 128 // cpg
    rng = np.random.RandomState(cpg * 10 + d)
    x = rng.randn(1, 7, 11, c).astype(np.float32)
    dy = rng.randn(1, 7, 11, c).astype(np.float32)
    w = _weight(c, cpg, seed=cpg + d)

    ref = grouped_conv3x3_blockdiag(jnp.asarray(x), _jax_kernel(w), groups=groups,
                                    dilation=d, dtype=jnp.float32, interpret=True)
    out = _tile_conv(torch.from_numpy(x), gc.pack_weight_tiles(w, groups), d)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-3)

    _, vjp = jax.vjp(lambda xx: _dense_reference(xx, _jax_kernel(w), groups, d,
                                                 jnp.float32), jnp.asarray(x))
    (dx_ref,) = vjp(jnp.asarray(dy))
    dx = _tile_conv(torch.from_numpy(dy), gc.pack_weight_tiles(w, groups, True), d)
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_ref), atol=1e-3)


def test_pack_weight_tiles_rejects_untileable_groups():
    with pytest.raises(ValueError, match="tiles"):
        gc.pack_weight_tiles(torch.zeros(96, 3, 3, 3), 32)  # cpg 3 does not divide 16
