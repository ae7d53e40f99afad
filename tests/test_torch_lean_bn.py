"""The lean train-mode BN (``HEATNET_BN_IMPL=lean``) of the port against JAX's.

On the CPU, float32, inputs from numpy with fixed seeds:

- ``ops/lean_bn.py::lean_bn_act`` against ``heatnet_tpu/ops/lean_bn.py`` for
  relu, leaky_relu, elu and none: ``a``, mean, var and the three gradients
  (``jax.vjp`` with the same cotangent of ``a``) within rtol 1e-4 / atol
  1e-5 (the two sum in different orders);
- ``ABN`` under the knob: the output and the running statistics against
  JAX's ABN under the knob; the ``state_dict`` keys are those without it;
  eval mode does not reach the lean op and equals the default path bit for
  bit;
- the ``train_plain`` step at structure (1,1,1,1) with the knob set in both
  packages, under the contract of tests/test_train_parity.py:199-240:
  losses over 3 steps at rtol 2e-3 / atol 2e-4, step-0 gradients at rel L2
  < 0.05 per tensor of norm >= 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from heatnet_tpu.io.checkpoint import _flatten
from heatnet_tpu.io.torch_import import convert_state_dict
from heatnet_tpu.models import layers as jl
from heatnet_tpu.ops.lean_bn import lean_bn_act as jax_lean_bn_act
from heatnet_tpu.train.optim import lambda_linear_decay as jax_linear_decay
from heatnet_tpu.train.state import TrainState as JaxTrainState
from heatnet_tpu.train.supervised import cross_entropy_ignore as jax_ce
from heatnet_tpu_torch.cli import train_plain
from heatnet_tpu_torch.models import ResNeXtSeg
from heatnet_tpu_torch.models import layers as tl
from heatnet_tpu_torch.ops import lean_bn
from heatnet_tpu_torch.train.supervised import cross_entropy_ignore

from test_torch_layers import carry, nchw, nhwc
from test_torch_train import _inputs, _rel_l2, pair  # noqa: F401 (fixture)

torch.set_num_threads(2)


@pytest.fixture
def lean(monkeypatch):
    monkeypatch.setenv("HEATNET_BN_IMPL", "lean")


@pytest.mark.parametrize("act", ["relu", "leaky_relu", "elu", "none"])
def test_lean_bn_act_and_its_gradients_match_jax(act):
    rng = np.random.RandomState(4)
    y = (rng.randn(3, 5, 7, 24) * 1.7 + 0.3).astype(np.float32)
    scale = (rng.rand(24) + 0.5).astype(np.float32)
    bias = (rng.randn(24) * 0.2).astype(np.float32)
    ct = rng.randn(*y.shape).astype(np.float32)

    def fwd(y_, s_, b_):
        return jax_lean_bn_act(y_, s_, b_, 1e-5, act, 0.1)

    (a_j, mean_j, var_j), vjp = jax.vjp(fwd, jnp.asarray(y), jnp.asarray(scale),
                                        jnp.asarray(bias))
    dy_j, ds_j, db_j = vjp((jnp.asarray(ct), jnp.zeros(24), jnp.zeros(24)))

    y_t = nchw(y).requires_grad_(True)
    s_t = torch.from_numpy(scale).requires_grad_(True)
    b_t = torch.from_numpy(bias).requires_grad_(True)
    a_t, mean_t, var_t = lean_bn.lean_bn_act(y_t, s_t, b_t, 1e-5, act, 0.1)
    assert not mean_t.requires_grad and not var_t.requires_grad
    a_t.backward(nchw(ct))
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(nhwc(a_t.detach()), np.asarray(a_j), **tol)
    np.testing.assert_allclose(mean_t.numpy(), np.asarray(mean_j), **tol)
    np.testing.assert_allclose(var_t.numpy(), np.asarray(var_j), **tol)
    np.testing.assert_allclose(nhwc(y_t.grad), np.asarray(dy_j), **tol)
    np.testing.assert_allclose(s_t.grad.numpy(), np.asarray(ds_j), **tol)
    np.testing.assert_allclose(b_t.grad.numpy(), np.asarray(db_j), **tol)
    assert s_t.grad.dtype == b_t.grad.dtype == torch.float32


def test_lean_abn_matches_jax_keeps_its_keys_and_leaves_eval_mode_alone(lean, monkeypatch):
    abn_j = jl.ABN(jl.NormAct(activation="leaky_relu", leaky_slope=0.01), jnp.float32)
    abn_t = tl.ABN(32, tl.NormAct(activation="leaky_relu"))
    x = (np.random.RandomState(6).randn(2, 6, 5, 32) * 2 + 0.7).astype(np.float32)
    v = carry(abn_j, abn_t, x)
    y_j, new = abn_j.apply(v, jnp.asarray(x), True, mutable=["batch_stats"])
    calls = []
    apply = lean_bn.LeanBNAct.apply
    monkeypatch.setattr(lean_bn.LeanBNAct, "apply",
                        lambda *a: calls.append(1) or apply(*a))
    y_t = nhwc(abn_t.train()(nchw(x)))
    assert calls == [1]
    np.testing.assert_allclose(y_t, np.asarray(y_j), rtol=1e-5, atol=1e-6)
    stats = new["batch_stats"]["bn"]
    np.testing.assert_allclose(abn_t.bn.running_mean.numpy(), np.asarray(stats["mean"]),
                               rtol=1e-5)
    np.testing.assert_allclose(abn_t.bn.running_var.numpy(), np.asarray(stats["var"]),
                               rtol=1e-5)

    keys = list(ResNeXtSeg(structure=(1, 1, 1, 1)).state_dict())
    monkeypatch.delenv("HEATNET_BN_IMPL")
    assert list(ResNeXtSeg(structure=(1, 1, 1, 1)).state_dict()) == keys
    with torch.no_grad():
        want = abn_t.eval()(nchw(x))
    monkeypatch.setenv("HEATNET_BN_IMPL", "lean")
    with torch.no_grad():
        got = abn_t.eval()(nchw(x))
    assert calls == [1]  # eval mode never reached the lean op
    assert torch.equal(got, want)


def test_lean_train_plain_steps_and_gradients_match_jax(pair, lean):  # noqa: F811
    model_j, variables, port = pair
    opt = train_plain.build_parser().parse_args(
        ["--dataroot", "-", "--n_epochs", "4", "--decay_epoch", "1", "--lr", "2e-4"])
    batches = []
    for s in range(3):
        rgb, ir, label = _inputs(seed=20 + s)
        batches.append({"rgb_day": rgb, "ir_day": ir, "label_day": label})

    def loss_fn(p, bs, batch):
        (seg, _, _), new = model_j.apply(
            {"params": p, "batch_stats": bs}, batch["rgb_day"], batch["ir_day"],
            train=True, mutable=["batch_stats"])
        return jax_ce(seg, batch["label_day"], ignore_index=-1), new["batch_stats"]

    sched = jax_linear_decay(opt.n_epochs, opt.epoch, opt.decay_epoch, opt.lr, 1)
    state_j = JaxTrainState.create(model_j.apply, variables["params"],
                                   variables["batch_stats"],
                                   optax.adam(sched, b1=0.5, b2=0.999))

    @jax.jit
    def step_j(state, batch):
        (loss, bs), g = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params, state.batch_stats, batch)
        return state.apply_gradients(g, bs), loss, g

    losses_j, grads_j = [], []
    for b in batches:
        state_j, loss, g = step_j(state_j, {k: jnp.asarray(v) for k, v in b.items()})
        losses_j.append(float(loss))
        grads_j.append(g)

    model_t = port()
    b0 = batches[0]
    seg, _, _ = model_t(torch.from_numpy(b0["rgb_day"]), torch.from_numpy(b0["ir_day"]))
    cross_entropy_ignore(seg, torch.from_numpy(b0["label_day"]).long(), -1).backward()
    g_flat, _ = convert_state_dict({k: p.grad for k, p in model_t.named_parameters()
                                    if p.grad is not None})
    compared = 0
    for k, v in _flatten(grads_j[0]).items():
        if k.startswith("aspp/final_conv2"):  # the unused cert head
            continue
        if np.linalg.norm(np.asarray(v, np.float64)) >= 1e-4:
            err = _rel_l2(g_flat[k], v)
            assert err < 0.05, f"gradient of {k}: rel L2 {err:.2e}"
            compared += 1
    assert compared > 50

    model_t = port()
    state_t = train_plain.create_state(model_t, opt, steps_per_epoch=1)
    losses_t = []
    for b in batches:
        losses_t.append(float(train_plain.train_step(state_t, {
            "rgb_day": torch.from_numpy(b["rgb_day"]),
            "ir_day": torch.from_numpy(b["ir_day"]),
            "label_day": torch.from_numpy(b["label_day"]).long()})))
    np.testing.assert_allclose(losses_t, losses_j, rtol=2e-3, atol=2e-4)
