"""The MFNet harness's models in the port against JAX: MFNet, SegNet, RTFNet, UNetSeg.

Float32 on the CPU, weights and inputs from numpy with fixed seeds
(``numpy_init``: every BN affine and statistic non-trivial), carried JAX →
port with ``state_dict_from_jax(..., target=model)`` and loaded strictly
(every JAX leaf lands on a port tensor and every port tensor is filled).
Outputs within rtol 1e-3 / atol 2e-3 and BN running statistics after one
train-mode forward within 1e-3 / 1e-4, the repo's model tolerances:

- MFNet and SegNet at full width on 2x64x96, RTFNet at ``layers=(1,1,1,1)``
  with its full widths (two ResNet-50-wide encoders, the 2048-channel
  decoder) on 2x64x64, UNetSeg on 1x32x32; eval and train mode. RTFNet's
  deep train-mode BNs normalise 8 values per channel (2x2 at batch 2), and
  flax's BatchNorm takes the variance in one pass, E[x^2] - E[x]^2, whose
  f32 cancellation there moves JAX's logits up to 9.9e-3 from a float64
  evaluation of the same weights (the port's two-pass statistics: 1.1e-3).
  So in train mode RTFNet is held to JAX with flax's two-pass variance
  (``use_fast_variance=False``, the same function; 1.4e-3 apart), and the
  port to its own float64 evaluation, both at the tolerance above;
- RTFNet's upsampling blocks name their 2x2 transposed conv ``conv3``, as
  the keep-shape blocks name a 3x3 conv: the name rule converts it as a
  plain conv, the target rule as a transposed one; for the models converted
  before (ResNeXtSeg, PSPNet, the CycleGAN generator) both rules give the
  same ``state_dict``;
- SegNet's pool and unpool, values, indices and gradients, with cells of
  exact ties, where ``jnp.max`` splits the gradient evenly (``torch.amax``
  does too; ``F.max_pool2d`` does not).
"""

import functools

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from heatnet_tpu.models import ResNeXtSeg as JaxResNeXtSeg
from heatnet_tpu.models import cyclegan as jax_cyclegan
from heatnet_tpu.models import extractors as jax_extractors
from heatnet_tpu.models import mfnet as jax_mfnet
from heatnet_tpu.models import rtfnet as jax_rtfnet
from heatnet_tpu.models import segnet_baseline as jax_segnet
from heatnet_tpu.models import unet as jax_unet
from heatnet_tpu.models.registry import build_network as jax_build_network
from heatnet_tpu_torch.io.from_jax import state_dict_from_jax
from heatnet_tpu_torch.models import (MFNet, ResNeXtSeg, RTFNet, SegNetBaseline, UNetSeg,
                                      build_network)
from heatnet_tpu_torch.models.cyclegan import Generator
from heatnet_tpu_torch.models.segnet_baseline import pool_with_indices, unpool_with_indices

from test_torch_late_fusion import assert_stats_close, japply, numpy_init

torch.set_num_threads(2)

TOL = dict(rtol=1e-3, atol=2e-3)
CASES = {
    "mfnet": (lambda: jax_mfnet.MFNet(n_class=9), lambda: MFNet(n_class=9), (2, 64, 96, 4)),
    "segnet": (lambda: jax_segnet.SegNetBaseline(n_class=9),
               lambda: SegNetBaseline(n_class=9), (2, 64, 96, 4)),
    "rtfnet": (lambda: jax_rtfnet.RTFNet(n_class=9, layers=(1, 1, 1, 1)),
               lambda: RTFNet(n_class=9, layers=(1, 1, 1, 1)), (2, 64, 64, 4)),
    "unet_seg": (lambda: jax_unet.UNetSeg(n_classes=3), lambda: UNetSeg(n_classes=3),
                 (1, 32, 32, 1)),
}


def _n_leaves(tree):
    return sum(_n_leaves(v) if hasattr(v, "items") else 1 for v in tree.values())


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    make_j, make_t, shape = CASES[request.param]
    x = np.random.RandomState(3).rand(*shape).astype(np.float32)
    m_j = make_j()
    v = numpy_init(m_j, jnp.asarray(x), seed=5, train=True)
    m_t = make_t()
    sd = state_dict_from_jax(v["params"], v["batch_stats"], target=m_t)
    # every leaf converted, and strict loading finds each port tensor filled
    n_bn = _n_leaves(v["batch_stats"]) // 2
    assert len(sd) == _n_leaves(v["params"]) + _n_leaves(v["batch_stats"]) + n_bn
    m_t.load_state_dict(sd, strict=True)
    return request.param, m_j, v, m_t, x


class _TwoPassVarianceFlax:
    """``flax.linen`` whose ``BatchNorm`` takes the variance in two passes."""

    BatchNorm = functools.partial(flax_nn.BatchNorm, use_fast_variance=False)

    def __getattr__(self, name):
        return getattr(flax_nn, name)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_baseline_forward_matches_jax(pair, train, monkeypatch):
    name, m_j, v, m_t, x = pair
    m_t.train(train)
    with torch.no_grad():
        got = m_t(torch.from_numpy(x))
    if train and name == "rtfnet":
        m64 = RTFNet(layers=(1, 1, 1, 1)).double().train()
        m64.compute_dtype = torch.float64
        m64.load_state_dict(state_dict_from_jax(v["params"], v["batch_stats"], target=m64))
        with torch.no_grad():
            ref64 = m64(torch.from_numpy(x).double())
        np.testing.assert_allclose(got.numpy(), ref64.numpy(), **TOL, err_msg="float64")
        del m64
        for mod in (jax_rtfnet, jax_extractors):
            monkeypatch.setattr(mod, "nn", _TwoPassVarianceFlax())
    out = japply(m_j, v, x, train=train)
    want, new_vars = out if train else (out, None)
    assert got.dtype == torch.float32 and tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL, err_msg=name)
    if train:
        assert_stats_close(m_t, new_vars["batch_stats"])
        m_t.load_state_dict(state_dict_from_jax(v["params"], v["batch_stats"], target=m_t))


def test_rtfnet_transposed_convs_need_the_target_rule():
    m_t = RTFNet(layers=(1, 1, 1, 1))
    v = numpy_init(jax_rtfnet.RTFNet(layers=(1, 1, 1, 1)), jnp.zeros((1, 64, 64, 4)),
                   seed=1, train=True)
    by_type = state_dict_from_jax(v["params"], v["batch_stats"], target=m_t)
    by_name = state_dict_from_jax(v["params"], v["batch_stats"])
    k = np.asarray(v["params"]["deconv1"]["block2"]["conv3"]["kernel"])  # (2, 2, I, O)
    np.testing.assert_array_equal(by_type["deconv1.block2.conv3.weight"].numpy(),
                                  np.flip(k, (0, 1)).transpose(2, 3, 0, 1))
    np.testing.assert_array_equal(by_name["deconv1.block2.conv3.weight"].numpy(),
                                  k.transpose(3, 2, 0, 1))
    assert isinstance(m_t.deconv1.block2.conv3, torch.nn.ConvTranspose2d)
    assert isinstance(m_t.deconv1.block1.conv3, torch.nn.Conv2d)
    # upsample_conv is a transposed conv by either rule
    np.testing.assert_array_equal(by_type["deconv5.block2.upsample_conv.weight"].numpy(),
                                  by_name["deconv5.block2.upsample_conv.weight"].numpy())


@pytest.mark.parametrize("which", ["resnext", "pspnet", "generator"])
def test_earlier_models_convert_as_before(which):
    if which == "resnext":
        m_j = JaxResNeXtSeg(structure=(1, 1, 1, 1), input_channels=4, dtype=jnp.float32)
        v = numpy_init(m_j, jnp.zeros((1, 64, 96, 4)))
        m_t = ResNeXtSeg(structure=(1, 1, 1, 1), input_channels=4)
    elif which == "pspnet":
        m_j = jax_build_network("squeezenet", in_channels=3, dtype=jnp.float32)
        v = numpy_init(m_j, jnp.zeros((1, 64, 96, 3)))
        m_t = build_network("squeezenet", in_channels=3)
    else:
        m_j = jax_cyclegan.Generator(output_nc=1, n_residual_blocks=1)
        v = numpy_init(m_j, jnp.zeros((1, 32, 32, 1)))
        m_t = Generator(output_nc=1, n_residual_blocks=1)
    by_type = state_dict_from_jax(v["params"], v.get("batch_stats"), target=m_t)
    by_name = state_dict_from_jax(v["params"], v.get("batch_stats"))
    assert sorted(by_type) == sorted(by_name)
    for k in by_name:
        np.testing.assert_array_equal(by_type[k].numpy(), by_name[k].numpy(), err_msg=k)
    m_t.load_state_dict(by_type, strict=True)
    # PSPNet's up_1/conv is a plain conv that ends in "conv"; the others deconvolve
    assert (which != "pspnet") == any(isinstance(m, torch.nn.ConvTranspose2d)
                                      for m in m_t.modules())


def _tied_cells():
    """(2, 6, 8, 3) NHWC values with whole cells tied, two-way ties and
    distinct cells."""
    rng = np.random.RandomState(0)
    x = rng.randint(0, 5, (2, 6, 8, 3)).astype(np.float32)  # many ties
    x[0, 0:2, 0:2, :] = 3.0  # a cell of four equal values
    x[1, 2:4, 4:6, 1] = [[1.0, 4.0], [4.0, 2.0]]  # two maxima, off the first slot
    return x


def test_segnet_pool_and_unpool_values_and_gradients_match_jax_on_ties():
    x = _tied_cells()
    w_pool = np.random.RandomState(1).randn(2, 3, 4, 3).astype(np.float32)
    w_up = np.random.RandomState(2).randn(*x.shape).astype(np.float32)
    pooled_j, idx_j = jax_segnet.pool_with_indices(jnp.asarray(x))
    up_j = jax_segnet.unpool_with_indices(pooled_j, idx_j)
    grad_j = jax.grad(lambda a: jnp.sum(jax_segnet.pool_with_indices(a)[0] * w_pool))(
        jnp.asarray(x))
    grad_up_j = jax.grad(lambda p: jnp.sum(jax_segnet.unpool_with_indices(p, idx_j) * w_up))(
        pooled_j)

    nchw = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))
    nhwc = lambda t: t.detach().permute(0, 2, 3, 1).numpy()
    xt = nchw(x).requires_grad_(True)
    pooled, idx = pool_with_indices(xt)
    (pooled * nchw(w_pool)).sum().backward()
    np.testing.assert_array_equal(nhwc(pooled), np.asarray(pooled_j))
    np.testing.assert_array_equal(nhwc(idx), np.asarray(idx_j))
    np.testing.assert_allclose(nhwc(xt.grad), np.asarray(grad_j), rtol=0, atol=1e-6)
    # the tied cell's gradient is split four ways, as jnp.max splits it
    np.testing.assert_allclose(nhwc(xt.grad)[0, 0:2, 0:2, 0], w_pool[0, 0, 0, 0] / 4,
                               rtol=1e-6)
    # where the indexed pool gives all of it to one element
    xm = nchw(x).requires_grad_(True)
    (F.max_pool2d(xm, 2, 2) * nchw(w_pool)).sum().backward()
    assert not np.allclose(nhwc(xm.grad), np.asarray(grad_j))

    pt = pooled.detach().requires_grad_(True)
    up = unpool_with_indices(pt, idx)
    (up * nchw(w_up)).sum().backward()
    np.testing.assert_array_equal(nhwc(up), np.asarray(up_j))
    np.testing.assert_allclose(nhwc(pt.grad), np.asarray(grad_up_j), rtol=0, atol=1e-6)


def test_segnet_train_step_gradients_match_jax():
    """The whole SegNet's loss (rel 1e-5) and parameter gradients against
    jax.grad, relative L2 < 0.05 per tensor of norm >= 1e-4 (the step
    contract, tests/test_train_parity.py:226). SegNet's down5 BNs normalise
    4 values per channel at this size: flax's one-pass variance moves JAX's
    gradients up to 1.5 % from a float64 evaluation of the port (1e-4 with
    flax's two-pass variance), the port's float32 ones 0.6 %; measured 1.1 %
    apart at the first conv."""
    from heatnet_tpu_torch.train.supervised import cross_entropy_ignore
    from heatnet_tpu.train.supervised import cross_entropy_ignore as jax_ce

    x = np.random.RandomState(3).rand(2, 32, 64, 4).astype(np.float32)
    label = np.random.RandomState(4).randint(-1, 9, (2, 32, 64)).astype(np.int32)
    m_j = jax_segnet.SegNetBaseline(n_class=9)
    v = numpy_init(m_j, jnp.asarray(x), seed=6, train=True)
    m_t = SegNetBaseline(n_class=9)
    m_t.load_state_dict(state_dict_from_jax(v["params"], v["batch_stats"], target=m_t))

    def loss_j(p):
        seg, _ = m_j.apply({"params": p, "batch_stats": v["batch_stats"]}, jnp.asarray(x),
                           train=True, mutable=["batch_stats"])
        return jax_ce(seg, jnp.asarray(label), ignore_index=-1)

    lj, gj = jax.jit(jax.value_and_grad(loss_j))(v["params"])
    m_t.train()
    lt = cross_entropy_ignore(m_t(torch.from_numpy(x)), torch.from_numpy(label),
                              ignore_index=-1)
    lt.backward()
    assert float(lt) == pytest.approx(float(lj), rel=1e-5)
    want = state_dict_from_jax(gj, target=m_t)
    checked = 0
    for name, p in m_t.named_parameters():
        g, ref = p.grad.numpy(), want[name].numpy()
        if np.linalg.norm(ref) >= 1e-4:
            assert np.linalg.norm(g - ref) / np.linalg.norm(ref) < 0.05, name
            checked += 1
    assert checked >= 40
