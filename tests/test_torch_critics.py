"""The adversarial trainer's modules in the port against the flax ones.

Each case initialises the flax module, randomises every BatchNorm's affine
and running statistics and every bias with numpy, carries the weights to
the port with ``state_dict_from_jax`` (a strict load: every JAX leaf lands
on a port tensor, the ``bn1``/``downsample_bn`` BatchNorms and the ``fc``
Dense included), and compares the forwards on the same NHWC input at
float32, rtol 1e-3 / atol 2e-3 (the repo's model tolerance). Train-mode
cases also compare the updated running statistics at rtol 1e-3 / atol 1e-4
(tests/test_torch_train.py's tolerance for them).

Modules: ``resize_bilinear``, ``instance_norm``, ``FCDiscriminator``,
``PoolDiscriminator``, ``DownNet``, the ``resnet18`` critic (train and
eval), ``UNetAdapter`` (train and eval) and the cert branch of
``ResNeXtSeg``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heatnet_tpu.models import critics as jc
from heatnet_tpu.models import extractors as jx
from heatnet_tpu.models import layers as jl
from heatnet_tpu.models import trgb_segnet as jt
from heatnet_tpu.models.unet import UNetAdapter as JaxUNetAdapter
from heatnet_tpu.train.state import init_model
from heatnet_tpu_torch.io.from_jax import state_dict_from_jax
from heatnet_tpu_torch.models import critics as tc
from heatnet_tpu_torch.models import extractors as tx
from heatnet_tpu_torch.models import layers as tl
from heatnet_tpu_torch.models import trgb_segnet as tt
from heatnet_tpu_torch.models.unet import UNetAdapter

from test_torch_layers import nchw, nhwc

torch.set_num_threads(2)

TOL = dict(rtol=1e-3, atol=2e-3)


def randomize_all(variables, seed=11):
    """Every BN scale/var in [0.5, 1.5), every bias and mean ~ N(0, 0.1)."""
    rng = np.random.RandomState(seed)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = walk(v)
                continue
            v = np.asarray(v, np.float32)
            if k in ("scale", "var"):
                v = (rng.rand(*v.shape) + 0.5).astype(np.float32)
            elif k in ("bias", "mean"):
                v = (rng.randn(*v.shape) * 0.1).astype(np.float32)
            out[k] = v
        return out

    return {col: walk(tree) for col, tree in variables.items()}


def carry(module_j, module_t, *inputs, **init_kw):
    variables = jax.jit(lambda k, *x: module_j.init(k, *x, **init_kw))(
        jax.random.PRNGKey(0), *[jnp.asarray(x) for x in inputs])
    variables = randomize_all(dict(variables))
    module_t.load_state_dict(state_dict_from_jax(
        variables["params"], variables.get("batch_stats")), strict=True)
    return variables


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# -- helpers -------------------------------------------------------------------

@pytest.mark.parametrize("hw,out_hw", [((16, 24), (8, 12)), ((15, 23), (7, 11)),
                                       ((2, 3), (64, 96)), ((5, 7), (13, 9))])
def test_resize_bilinear_matches_jax(hw, out_hw):
    x = _x((2, *hw, 3))
    np.testing.assert_allclose(nhwc(tl.resize_bilinear(nchw(x), out_hw)),
                               np.asarray(jl.resize_bilinear(jnp.asarray(x), out_hw)),
                               rtol=1e-5, atol=1e-5)


def test_instance_norm_matches_jax():
    x = _x((2, 9, 11, 5)) * 3 + 1
    np.testing.assert_allclose(nhwc(tl.instance_norm(nchw(x))),
                               np.asarray(jl.instance_norm(jnp.asarray(x))),
                               rtol=1e-4, atol=1e-5)


def test_normal002_init_and_tap_channels():
    critic = tc.FCDiscriminator(13)
    tl.init_params(critic, torch.Generator().manual_seed(0))
    std = float(critic.conv3.weight.detach().std())
    assert abs(std - 0.02) < 0.002 and float(critic.conv3.bias.abs().max()) == 0
    for lf in (False, True):
        assert tt.tap_channels(13, lf) == jt.tap_channels(13, lf)


# -- critics -------------------------------------------------------------------

def test_fc_discriminator_matches_jax():
    x = _x((2, 64, 96, 13))
    d_t = tc.FCDiscriminator(13)
    v = carry(jc.FCDiscriminator(dtype=jnp.float32), d_t, x)
    with torch.no_grad():
        out = d_t(torch.from_numpy(x))
    assert out.shape == (2, 64, 96, 1) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(jc.FCDiscriminator().apply(v, jnp.asarray(x))),
                               **TOL)


def test_pool_discriminator_matches_jax():
    x = _x((2, 32, 40, 8), 1)
    d_t = tc.PoolDiscriminator(8)
    v = carry(jc.PoolDiscriminator(dtype=jnp.float32), d_t, x)
    with torch.no_grad():
        out = d_t(torch.from_numpy(x))
    assert out.shape == (2, 1)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(jc.PoolDiscriminator().apply(v, jnp.asarray(x))),
                               **TOL)


@pytest.mark.parametrize("n", [2, 3])
def test_downnet_matches_jax(n):
    x = _x((2, 64, 96, 13), 2)
    d_t = tc.DownNet(n, 13)
    v = carry(jc.DownNet(n, dtype=jnp.float32), d_t, x)
    with torch.no_grad():
        out = d_t(torch.from_numpy(x))
    assert out.shape == (2, 64 >> n, 96 >> n, 13)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(jc.DownNet(n).apply(v, jnp.asarray(x))), **TOL)


def _flax_bs(stats):
    """flax batch_stats as port buffer names (mean → running_mean ...)."""
    return {k: v for k, v in state_dict_from_jax({}, stats).items()
            if not k.endswith("num_batches_tracked")}


@pytest.mark.parametrize("variant", ["resnet18", "resnet50"])
def test_resnet_critic_matches_jax_in_train_and_eval(variant):
    x = _x((2, 40, 56, 13), 3)
    c_j = jx.make_resnet(variant, num_classes=1, dtype=jnp.float32)
    c_t = tc.create_critic(variant, 13)
    v = carry(c_j, c_t, x)
    if variant == "resnet18":  # the repaired names are among the loaded keys
        assert {"bn1.weight", "layer2.block1.downsample_bn.weight",
                "fc.weight"} <= set(c_t.state_dict())
    with torch.no_grad():
        out_eval = c_t.eval()(torch.from_numpy(x))
        out_train = c_t.train()(torch.from_numpy(x))
    np.testing.assert_allclose(out_eval.numpy(),
                               np.asarray(c_j.apply(v, jnp.asarray(x))), **TOL)
    y_j, new = c_j.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    assert out_train.shape == (2, 1) and out_train.dtype == torch.float32
    np.testing.assert_allclose(out_train.numpy(), np.asarray(y_j), **TOL)
    sd = c_t.state_dict()
    for k, want in _flax_bs(new["batch_stats"]).items():
        np.testing.assert_allclose(sd[k].numpy(), want.numpy(), rtol=1e-3,
                                   atol=1e-4, err_msg=k)


def test_critic_factory_and_unported_modes():
    assert isinstance(tc.create_critic("cyclegan", 5), tc.FCDiscriminator)
    with pytest.raises(ValueError):
        tc.create_critic("vgg", 5)
    # the extractor modes are ported (tests/test_torch_pspnet.py holds them
    # to JAX): five taps, deepest first, and no late-fusion DenseNet
    taps = tx.make_resnet("resnet18", in_channels=4).eval()(torch.zeros(1, 32, 32, 4))
    assert [t.shape[-1] for t in taps] == tx.feature_channels("resnet18")
    assert isinstance(tx.make_extractor("densenet"), tx.DenseNetExtractor)
    with pytest.raises(ValueError, match="late-fusion"):
        tx.make_extractor("densenet", late_fusion=True)


# -- the input adapter -----------------------------------------------------------

@pytest.mark.parametrize("train", [False, True])
def test_unet_adapter_matches_jax(train):
    x = _x((2, 36, 52, 4), 4)  # 36 -> 18 -> 9 -> 4: the ups pad
    u_j = JaxUNetAdapter(4, dtype=jnp.float32)
    u_t = UNetAdapter(4, 4)
    v = carry(u_j, u_t, x)
    u_t.train(train)
    with torch.no_grad():
        out = u_t(torch.from_numpy(x))
    assert out.shape == (2, 36, 52, 4)
    if train:
        y_j, new = u_j.apply(v, jnp.asarray(x), True, mutable=["batch_stats"])
        sd = u_t.state_dict()
        for k, want in _flax_bs(new["batch_stats"]).items():
            np.testing.assert_allclose(sd[k].numpy(), want.numpy(), rtol=1e-3,
                                       atol=1e-4, err_msg=k)
    else:
        y_j = u_j.apply(v, jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(y_j), **TOL)


# -- the cert branch of ResNeXtSeg ---------------------------------------------------

def test_cert_branch_matches_jax_in_eval_and_train():
    rng = np.random.RandomState(5)
    rgb = rng.rand(2, 32, 48, 3).astype(np.float32) * 2 - 1
    ir = rng.rand(2, 32, 48, 1).astype(np.float32) * 2 - 1
    m_j = jt.ResNeXtSeg(structure=(1, 1, 1, 1), input_channels=4, cert_branch=True,
                        dtype=jnp.float32)
    params, stats = init_model(m_j, jax.random.PRNGKey(0), jnp.asarray(rgb),
                               jnp.asarray(ir))
    v = randomize_all({"params": params, "batch_stats": stats})
    m_t = tt.ResNeXtSeg(structure=(1, 1, 1, 1), input_channels=4, cert_branch=True)
    m_t.load_state_dict(state_dict_from_jax(v["params"], v["batch_stats"]), strict=True)
    for train in (False, True):
        with torch.no_grad():
            seg_t, _, cert_t = m_t.train(train)(torch.from_numpy(rgb),
                                                torch.from_numpy(ir))
        out = m_j.apply(v, jnp.asarray(rgb), jnp.asarray(ir), train=train,
                        mutable=["batch_stats"] if train else False)
        seg_j, _, cert_j = out[0] if train else out
        assert cert_t.shape == (2, 32, 48, 1) and cert_t.dtype == torch.float32
        np.testing.assert_allclose(cert_t.numpy(), np.asarray(cert_j), **TOL)
        np.testing.assert_allclose(seg_t.numpy(), np.asarray(seg_j), **TOL)
