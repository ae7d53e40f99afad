"""Port layers (heatnet_tpu_torch.models.layers) against the flax ones.

Each case initialises the flax module, randomises its BN running statistics
and affine with numpy, carries the weights to the port with
``state_dict_from_jax`` (strict load), and compares the eval forwards on the
same NHWC input at float32 (rtol 1e-3, atol 2e-3, as the model parity tests).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heatnet_tpu.models import layers as jl
from heatnet_tpu_torch.io.from_jax import state_dict_from_jax
from heatnet_tpu_torch.models import layers as tl

torch.set_num_threads(2)

ACTS = ("relu", "leaky_relu", "elu")


def randomize(variables, seed=7):
    """Non-trivial BN affine and running stats (test_torch_parity.py:92-104)."""
    rng = np.random.RandomState(seed)

    def walk(tree, bn):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                out[k] = walk(v, k == "bn")
                continue
            v = np.asarray(v, np.float32)
            if bn and k in ("scale", "var"):
                v = (rng.rand(*v.shape) + 0.5).astype(np.float32)
            elif bn and k in ("bias", "mean"):
                v = (rng.randn(*v.shape) * 0.1).astype(np.float32)
            out[k] = v
        return out

    return {col: walk(tree, False) for col, tree in variables.items()}


def carry(module_j, module_t, *inputs):
    """Init flax, randomise BN, load the port strictly; return variables."""
    variables = jax.jit(module_j.init)(jax.random.PRNGKey(0),
                                       *[jnp.asarray(x) for x in inputs])
    variables = randomize(dict(variables))
    module_t.load_state_dict(state_dict_from_jax(
        variables["params"], variables.get("batch_stats")), strict=True)
    module_t.eval()
    return variables


def nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def close(a, b):
    np.testing.assert_allclose(a, np.asarray(b), rtol=1e-3, atol=2e-3)


@pytest.mark.parametrize("stride,dilation,act", [
    (1, 1, "relu"), (2, 1, "leaky_relu"), (1, 2, "elu")])
def test_identity_residual_block(stride, dilation, act):
    na_j, na_t = jl.NormAct(activation=act), tl.NormAct(activation=act)
    blk_j = jl.IdentityResidualBlock(channels=(128, 128, 256), stride=stride,
                                     dilation=dilation, groups=64,
                                     norm_act=na_j, dtype=jnp.float32)
    blk_t = tl.IdentityResidualBlock(64, (128, 128, 256), stride=stride,
                                     dilation=dilation, groups=64, norm_act=na_t)
    x = np.random.RandomState(0).randn(2, 10, 12, 64).astype(np.float32)
    v = carry(blk_j, blk_t, x)
    with torch.no_grad():
        out = nhwc(blk_t(nchw(x)))
    close(out, blk_j.apply(v, jnp.asarray(x)))


def test_identity_residual_block_without_projection():
    blk_j = jl.IdentityResidualBlock(channels=(128, 128, 256), groups=64,
                                     dtype=jnp.float32)
    blk_t = tl.IdentityResidualBlock(256, (128, 128, 256), groups=64)
    x = np.random.RandomState(1).randn(1, 6, 7, 256).astype(np.float32)
    v = carry(blk_j, blk_t, x)
    assert not blk_t.need_proj
    with torch.no_grad():
        out = nhwc(blk_t(nchw(x)))
    close(out, blk_j.apply(v, jnp.asarray(x)))


def test_aspp():
    aspp_j = jl.ASPP(out_channels=13, cert_head=True, dtype=jnp.float32)
    aspp_t = tl.ASPP(96, 13, cert_head=True)
    x = np.random.RandomState(2).randn(2, 9, 14, 96).astype(np.float32)
    v = carry(aspp_j, aspp_t, x)
    with torch.no_grad():
        outs_t = aspp_t(nchw(x))
    outs_j = aspp_j.apply(v, jnp.asarray(x))
    for t, j in zip(outs_t, outs_j):
        close(nhwc(t), j)


@pytest.mark.parametrize("act", ACTS)
def test_fuse_module(act):
    fuse_j = jl.FuseModule(13, jl.NormAct(activation=act), jnp.float32)
    fuse_t = tl.FuseModule(40, 13, tl.NormAct(activation=act))
    x = np.random.RandomState(3).randn(2, 6, 9, 40).astype(np.float32)
    v = carry(fuse_j, fuse_t, x)
    with torch.no_grad():
        out = nhwc(fuse_t(nchw(x)))
    assert out.shape == (2, 24, 36, 13)
    close(out, fuse_j.apply(v, jnp.asarray(x)))


def test_init_block():
    init_j = jl.InitBlock(dtype=jnp.float32)
    init_t = tl.InitBlock(4)
    x = np.random.RandomState(4).randn(2, 17, 22, 4).astype(np.float32)
    v = carry(init_j, init_t, x)
    with torch.no_grad():
        out = nhwc(init_t(nchw(x)))
    close(out, init_j.apply(v, jnp.asarray(x)))


@pytest.mark.parametrize("k,s,p", [(4, 2, 1), (8, 4, 2)])
def test_deconv(k, s, p):
    """Both decoder geometries against the default (subpixel) flax deconv."""
    class Up(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.up = tl.deconv(13, 13, k, s, p)

    dec_j = jl.deconv(13, k, s, p, dtype=jnp.float32)
    x = np.random.RandomState(5).randn(2, 5, 7, 13).astype(np.float32)
    params = jax.jit(dec_j.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    up_t = Up()
    # the JAX module stands alone; its kernel sits under the name "up"
    up_t.load_state_dict(state_dict_from_jax({"up": params}), strict=True)
    with torch.no_grad():
        out = nhwc(up_t.up(nchw(x)))
    assert out.shape == (2, 5 * s, 7 * s, 13)
    close(out, dec_j.apply({"params": params}, jnp.asarray(x)))


@pytest.mark.parametrize("hw,out_hw", [((16, 24), (8, 12)), ((15, 23), (8, 12)),
                                       ((8, 12), (8, 12))])
def test_pools(hw, out_hw):
    x = np.random.RandomState(6).randn(2, *hw, 5).astype(np.float32)
    close(nhwc(tl.adaptive_avg_pool(nchw(x), out_hw)),
          jl.adaptive_avg_pool(jnp.asarray(x), out_hw))
    close(nhwc(tl.max_pool_3x3_s2(nchw(x))), jl.max_pool_3x3_s2(jnp.asarray(x)))
    close(nhwc(tl.global_avg_pool(nchw(x))), jl.global_avg_pool(jnp.asarray(x)))


def test_stride_dilation_schedule():
    for dil in (1, (1, 1, 2, 4), (1, 1, 2, (1, 2, 4))):
        for mod_id in range(4):
            for block_id in range(3):
                assert tl.stride_dilation(mod_id, block_id, dil) == \
                    jl.stride_dilation(mod_id, block_id, dil)


def test_train_mode_raises():
    """Train mode runs; its per-GPU BN statistics (bn_groups > 1) are not
    ported and raise."""
    blk = tl.IdentityResidualBlock(64, (128, 128, 256), groups=64)
    assert blk.train()(torch.zeros(2, 64, 4, 4)).shape == (2, 256, 4, 4)
    blk = tl.IdentityResidualBlock(64, (128, 128, 256), groups=64,
                                   norm_act=tl.NormAct(bn_groups=4))
    with pytest.raises(NotImplementedError):
        blk.train()(torch.zeros(4, 64, 4, 4))
