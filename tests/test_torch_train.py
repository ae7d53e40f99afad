"""The port's training path (heatnet_tpu_torch) against the JAX package.

Small sizes, float32, inputs from numpy with fixed seeds, both packages on
the CPU:

- the grouped conv's autograd Function (forward, dx, dk) against ``jax.vjp``
  of ``pallas_grouped_conv._dense_reference`` at atol = rtol = 1e-4, the
  JAX package's own tolerance for this VJP (tests/test_pallas.py:93-96);
- train-mode ``ABN`` against flax: output and both running statistics after
  one step at 1e-5 relative;
- ``ResNeXtSeg`` (1,1,1,1) at full width in train mode from the same
  weights: seg and taps at rtol 1e-3 / atol 2e-3, the updated batch_stats,
  and step-0 gradients through ``convert_state_dict`` at rel L2 < 0.05 per
  tensor of norm >= 1e-4 over more than 50 tensors (the contract of
  tests/test_train_parity.py:213-228);
- three steps of the ``train_plain`` step on identical pre-augmented
  batches: losses at rtol 2e-3 / atol 2e-4, final eval logits at 5e-3
  (test_train_parity.py:199, :239-240);
- ``cross_entropy_ignore``, an all-ignored batch included, and the CLI end
  to end on a tiny train pack, its checkpoint served by ``cli/inference.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from heatnet_tpu.io.checkpoint import _flatten
from heatnet_tpu.io.torch_import import convert_state_dict
from heatnet_tpu.models import ResNeXtSeg as JaxResNeXtSeg
from heatnet_tpu.models import layers as jl
from heatnet_tpu.ops.pallas_grouped_conv import _dense_reference
from heatnet_tpu.train.optim import lambda_linear_decay as jax_linear_decay
from heatnet_tpu.train.state import TrainState as JaxTrainState
from heatnet_tpu.train.state import init_model
from heatnet_tpu.train.supervised import cross_entropy_ignore as jax_ce
from heatnet_tpu_torch.cli import inference as infer_cli
from heatnet_tpu_torch.cli import train_plain
from heatnet_tpu_torch.data.packed import write_pack, write_train_pack
from heatnet_tpu_torch.io.from_jax import state_dict_from_jax
from heatnet_tpu_torch.models import ResNeXtSeg
from heatnet_tpu_torch.models import layers as tl
from heatnet_tpu_torch.ops import grouped_conv as gc
from heatnet_tpu_torch.train.supervised import cross_entropy_ignore

from test_torch_layers import carry, nchw, nhwc, randomize

torch.set_num_threads(2)

N, H, W = 2, 64, 96


# -- the grouped conv's VJP --------------------------------------------------

@pytest.mark.parametrize("c,cpg,d", [(128, 2, 1), (256, 4, 2)])
def test_grouped_conv_function_matches_jax_vjp(c, cpg, d):
    rng = np.random.RandomState(c + d)
    x = rng.randn(2, 7, 9, c).astype(np.float32)
    w = (rng.randn(c, cpg, 3, 3) * 0.3).astype(np.float32)
    g = rng.randn(2, 7, 9, c).astype(np.float32)
    y_j, vjp = jax.vjp(
        lambda xx, kk: _dense_reference(xx, kk, c // cpg, d, jnp.float32),
        jnp.asarray(x), jnp.asarray(w.transpose(2, 3, 1, 0)))
    dx_j, dk_j = vjp(jnp.asarray(g))

    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = gc.differentiable_grouped_conv3x3(xt, wt, c // cpg, d)
    y.backward(torch.from_numpy(g))
    tol = dict(atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), **tol)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), **tol)
    np.testing.assert_allclose(wt.grad.numpy(),
                               np.asarray(dk_j).transpose(3, 2, 0, 1), **tol)
    assert wt.grad.dtype == torch.float32


def test_grouped_conv_function_copies_a_strided_input_and_counts_it():
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(1, 64, 5, 6).astype(np.float32))  # NCHW
    w = torch.from_numpy(rng.randn(64, 2, 3, 3).astype(np.float32))
    before = dict(gc.layout_copies)
    y = gc.differentiable_grouped_conv3x3(x.permute(0, 2, 3, 1), w, 32)
    assert gc.layout_copies["x"] == before["x"] + 1
    np.testing.assert_allclose(
        y.numpy(), gc.grouped_conv3x3(x.permute(0, 2, 3, 1).contiguous(), w, 32).numpy())


def test_dx_weight_is_the_input_gradient_of_the_library_conv():
    """dx = conv(dy, flip(transpose(w))): held against F.conv2d's autograd."""
    rng = np.random.RandomState(1)
    c, cpg, d = 64, 8, 3
    x = torch.from_numpy(rng.randn(1, 9, 8, c).astype(np.float32)).requires_grad_()
    w = torch.from_numpy(rng.randn(c, cpg, 3, 3).astype(np.float32))
    dy = torch.from_numpy(rng.randn(1, 9, 8, c).astype(np.float32))
    y = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w, padding=d,
                                   dilation=d, groups=c // cpg)
    y.permute(0, 2, 3, 1).backward(dy)
    np.testing.assert_allclose(gc.grouped_conv3x3_dx(dy, w, c // cpg, d).numpy(),
                               x.grad.numpy(), atol=1e-4, rtol=1e-4)


# -- train-mode BN -----------------------------------------------------------

@pytest.mark.parametrize("act", ["relu", "leaky_relu", "elu"])
def test_abn_train_mode_matches_flax(act):
    abn_j = jl.ABN(jl.NormAct(activation=act), jnp.float32)
    abn_t = tl.ABN(48, tl.NormAct(activation=act))
    x = (np.random.RandomState(2).randn(3, 6, 7, 48) * 2 + 0.7).astype(np.float32)
    v = carry(abn_j, abn_t, x)
    y_j, new = abn_j.apply(v, jnp.asarray(x), True, mutable=["batch_stats"])
    y_t = nhwc(abn_t.train()(nchw(x)))
    np.testing.assert_allclose(y_t, np.asarray(y_j), rtol=1e-5, atol=1e-6)
    stats = new["batch_stats"]["bn"]
    np.testing.assert_allclose(abn_t.bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=1e-5)
    np.testing.assert_allclose(abn_t.bn.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=1e-5)


# -- the model in train mode -------------------------------------------------

def _inputs(seed=1, n=N):
    rng = np.random.RandomState(seed)
    rgb = rng.rand(n, H, W, 3).astype(np.float32) * 2 - 1
    ir = rng.rand(n, H, W, 1).astype(np.float32) * 2 - 1
    label = rng.randint(0, 13, (n, H, W)).astype(np.int32)
    return rgb, ir, label


@pytest.fixture(scope="module")
def pair():
    """The JAX model, its randomised variables, and a port model built from
    them (f32, train mode)."""
    model_j = JaxResNeXtSeg(structure=(1, 1, 1, 1), input_channels=4,
                            dtype=jnp.float32)
    rgb, ir, _ = _inputs()
    params, stats = init_model(model_j, jax.random.PRNGKey(0),
                               jnp.asarray(rgb), jnp.asarray(ir))
    variables = randomize({"params": params, "batch_stats": stats})

    def port():
        m = ResNeXtSeg(structure=(1, 1, 1, 1), input_channels=4)
        m.load_state_dict(state_dict_from_jax(variables["params"],
                                              variables["batch_stats"]),
                          strict=True)
        return m.train()

    return model_j, variables, port


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def test_train_forward_stats_and_gradients_match_jax(pair):
    model_j, variables, port = pair
    rgb, ir, label = _inputs()
    label = np.where(np.random.RandomState(3).rand(*label.shape) < 0.1, 13, label)

    def loss_j(params):
        (seg, taps, _), new = model_j.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(rgb), jnp.asarray(ir), train=True, mutable=["batch_stats"])
        return jax_ce(seg, jnp.asarray(label)), (seg, taps, new["batch_stats"])

    (loss_jv, (seg_j, taps_j, stats_j)), grads_j = jax.value_and_grad(
        loss_j, has_aux=True)(variables["params"])

    model_t = port()
    seg_t, taps_t, _ = model_t(torch.from_numpy(rgb), torch.from_numpy(ir))
    loss_t = cross_entropy_ignore(seg_t, torch.from_numpy(label).long())
    loss_t.backward()

    np.testing.assert_allclose(float(loss_t.detach()), float(loss_jv), rtol=1e-4)
    for i, (tt, tj) in enumerate(zip(taps_t, taps_j)):
        np.testing.assert_allclose(tt.detach().numpy(), np.asarray(tj),
                                   rtol=1e-3, atol=2e-3, err_msg=f"tap {i}")

    _, s_flat = convert_state_dict(model_t.state_dict())
    want = _flatten(stats_j)
    assert set(s_flat) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(s_flat[k], np.asarray(v), rtol=1e-3,
                                   atol=1e-4, err_msg=k)

    g_flat, _ = convert_state_dict({k: p.grad for k, p in model_t.named_parameters()
                                    if p.grad is not None})
    compared = 0
    for k, v in _flatten(grads_j).items():
        if k.startswith("aspp/final_conv2"):  # the unused cert head
            continue
        assert k in g_flat, f"no port gradient for {k}"
        if np.linalg.norm(np.asarray(v, np.float64)) >= 1e-4:
            err = _rel_l2(g_flat[k], v)
            assert err < 0.05, f"gradient of {k}: rel L2 {err:.2e}"
            compared += 1
    assert compared > 50


def test_train_plain_steps_match_jax(pair):
    model_j, variables, port = pair
    opt = train_plain.build_parser().parse_args(
        ["--dataroot", "-", "--n_epochs", "4", "--decay_epoch", "1",
         "--lr", "2e-4"])
    batches = []
    for s in range(3):
        rgb, ir, label = _inputs(seed=10 + s)
        batches.append({"rgb_day": rgb, "ir_day": ir, "label_day": label})

    # the JAX trainer's step (heatnet_tpu/cli/train_plain.py:78-99)
    sched = jax_linear_decay(opt.n_epochs, opt.epoch, opt.decay_epoch, opt.lr, 1)
    tx = optax.adam(sched, b1=0.5, b2=0.999)
    state_j = JaxTrainState.create(model_j.apply, variables["params"],
                                   variables["batch_stats"], tx)

    def loss_fn(p, bs, batch):
        (seg, _, _), new = model_j.apply(
            {"params": p, "batch_stats": bs}, batch["rgb_day"], batch["ir_day"],
            train=True, mutable=["batch_stats"])
        return jax_ce(seg, batch["label_day"], ignore_index=-1), new["batch_stats"]

    @jax.jit
    def step_j(state, batch):
        (loss, bs), g = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params, state.batch_stats, batch)
        return state.apply_gradients(g, bs), loss

    model_t = port()
    state_t = train_plain.create_state(model_t, opt, steps_per_epoch=1)
    losses_j, losses_t = [], []
    for b in batches:
        state_j, loss = step_j(state_j, {k: jnp.asarray(v) for k, v in b.items()})
        losses_j.append(float(loss))
        losses_t.append(float(train_plain.train_step(state_t, {
            "rgb_day": torch.from_numpy(b["rgb_day"]),
            "ir_day": torch.from_numpy(b["ir_day"]),
            "label_day": torch.from_numpy(b["label_day"]).long()})))
    np.testing.assert_allclose(losses_t, losses_j, rtol=2e-3, atol=2e-4)
    assert state_t.step == 3
    np.testing.assert_allclose(state_t.optimizer.param_groups[0]["lr"],
                               float(sched(3)), rtol=1e-6)

    rgb, ir, _ = _inputs(seed=99)
    seg_j, _, _ = model_j.apply({"params": state_j.params,
                                 "batch_stats": state_j.batch_stats},
                                jnp.asarray(rgb), jnp.asarray(ir), train=False)
    with torch.no_grad():
        seg_t = model_t.eval()(torch.from_numpy(rgb), torch.from_numpy(ir))[0]
    np.testing.assert_allclose(seg_t.numpy(), np.asarray(seg_j), rtol=5e-3,
                               atol=5e-3)


def test_supervised_train_and_eval_steps_match_jax(pair):
    """``make_train_step`` (CE with ignore 13, Adam from ``create_optimizer``)
    and ``make_eval_step`` against the JAX steps: loss, accuracy, the
    confusion matrix of the updated model."""
    from heatnet_tpu.train.optim import create_optimizer as jax_create_optimizer
    from heatnet_tpu.train.supervised import make_eval_step as jax_eval_step
    from heatnet_tpu.train.supervised import make_train_step as jax_train_step
    from heatnet_tpu_torch.train.optim import create_optimizer
    from heatnet_tpu_torch.train.state import TrainState
    from heatnet_tpu_torch.train.supervised import make_eval_step, make_train_step

    model_j, variables, port = pair
    rgb, ir, label = _inputs(seed=20)
    label = np.where(np.random.RandomState(21).rand(*label.shape) < 0.2, 13, label)
    image = np.concatenate([rgb, ir], -1)
    config = {"type": "Adam", "learning_rate": 1e-3}

    state_j = JaxTrainState.create(model_j.apply, variables["params"],
                                   variables["batch_stats"],
                                   jax_create_optimizer(config))
    state_j, m_j = jax_train_step(model_j)(
        state_j, {"image": jnp.asarray(image), "label": jnp.asarray(label)})
    conf_j = np.asarray(jax_eval_step(model_j)(
        state_j, {"image": jnp.asarray(image), "label": jnp.asarray(label)}))

    model_t = port()
    opt, sched = create_optimizer(config, model_t.parameters())
    state_t, m_t = make_train_step(model_t)(
        TrainState(model_t, opt, sched),
        {"image": torch.from_numpy(image), "label": torch.from_numpy(label).long()})
    conf_t = make_eval_step(model_t)(
        state_t, {"image": torch.from_numpy(image),
                  "label": torch.from_numpy(label).long()}).numpy()
    np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]), rtol=2e-3)
    np.testing.assert_allclose(float(m_t["accuracy"]), float(m_j["accuracy"]),
                               atol=1e-3)
    assert conf_t.sum() == conf_j.sum() == label.size  # 14 classes: 13 counts
    # after an Adam step (~sign(g)·lr) near-tied argmaxes of the random-init
    # logits may flip; a flipped pixel moves two entries: 1 % of pixels
    assert np.abs(conf_t - conf_j).sum() <= 2 * 0.01 * conf_j.sum()


def test_train_step_can_keep_the_batch_statistics(pair):
    from heatnet_tpu_torch.train.optim import create_optimizer
    from heatnet_tpu_torch.train.state import TrainState
    from heatnet_tpu_torch.train.supervised import make_train_step

    _, _, port = pair
    model_t = port()
    before = [b.clone() for b in model_t.buffers()]
    opt, sched = create_optimizer({"type": "SGD", "learning_rate": 1e-3},
                                  model_t.parameters())
    rgb, ir, label = _inputs(seed=22)
    state, m = make_train_step(model_t, learn_batch_stats=False)(
        TrainState(model_t, opt, sched),
        {"image": torch.from_numpy(np.concatenate([rgb, ir], -1)),
         "label": torch.from_numpy(label).long()})
    assert state.step == 1 and np.isfinite(float(m["loss"]))
    for b, k in zip(model_t.buffers(), before):
        assert torch.equal(b, k)


def test_robust_loss_matches_jax():
    from heatnet_tpu.train.supervised import robust_loss as jax_robust_loss
    from heatnet_tpu_torch.train.supervised import robust_loss

    x = np.random.RandomState(6).randn(50).astype(np.float32) * 3
    for a, c in ((0.5, 1.0), (-1.0, 2.0), (2.0, 0.5)):
        np.testing.assert_allclose(robust_loss(torch.from_numpy(x), a, c).numpy(),
                                   np.asarray(jax_robust_loss(jnp.asarray(x), a, c)),
                                   rtol=1e-5, atol=1e-6)


# -- the loss ----------------------------------------------------------------

@pytest.mark.parametrize("ignore", [13, -1])
def test_cross_entropy_ignore_matches_jax(ignore):
    rng = np.random.RandomState(4)
    logits = (rng.randn(2, 5, 6, 14) * 3).astype(np.float32)
    labels = rng.randint(0, 14, (2, 5, 6)).astype(np.int32)
    for lab in (labels, np.full_like(labels, ignore)):  # the second: all ignored
        want = jax_ce(jnp.asarray(logits), jnp.asarray(lab), ignore_index=ignore)
        got = cross_entropy_ignore(torch.from_numpy(logits),
                                   torch.from_numpy(lab).long(), ignore_index=ignore)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
        per_pixel = cross_entropy_ignore(torch.from_numpy(logits),
                                         torch.from_numpy(lab).long(),
                                         ignore_index=ignore, reduce=False)
        np.testing.assert_allclose(
            per_pixel.numpy(),
            np.asarray(jax_ce(jnp.asarray(logits), jnp.asarray(lab),
                              ignore_index=ignore, reduce=False)), rtol=1e-6)
    assert float(cross_entropy_ignore(torch.from_numpy(logits),
                                      torch.from_numpy(np.full_like(labels, ignore)).long(),
                                      ignore_index=ignore)) == 0.0


# -- the CLI end to end --------------------------------------------------------

def test_train_plain_cli_two_steps_then_inference(tmp_path, monkeypatch):
    monkeypatch.setattr(train_plain, "CROP", (48, 64))  # 320x640 is slow here
    rng = np.random.RandomState(5)
    n, h, w = 4, 56, 960
    write_train_pack(str(tmp_path / "train"),
                     rng.randint(0, 256, (n, h, w, 3)).astype(np.uint8),
                     rng.randint(21000, 26000, (n, h, w)).astype(np.uint16),
                     rng.randint(0, 13, (n, h, w)).astype(np.uint8),
                     rng.randint(0, 256, (3, h, w, 3)).astype(np.uint8),
                     rng.randint(21000, 26000, (3, h, w)).astype(np.uint16))
    run = train_plain.main([
        "--dataroot", str(tmp_path / "train"), "--device", "cpu",
        "--structure", "1", "1", "1", "1", "--batch_size", "2",
        "--n_epochs", "1",
        "--checkpointname", str(tmp_path / "ck"),
        "--log_dir", str(tmp_path / "runs")])
    assert len(run.losses) == 2 and all(np.isfinite(run.losses))
    saved = torch.load(run.checkpoint, weights_only=True)
    assert saved["epoch"] == 1 and "mod1.conv1.weight" in saved["state_dict"]

    write_pack(str(tmp_path / "frames"),
               rng.randint(0, 256, (2, 48, 64, 3)).astype(np.uint8),
               rng.randint(21000, 26000, (2, 48, 64, 1)).astype(np.uint16))
    served = infer_cli.main(["--data", str(tmp_path / "frames"), "--device", "cpu",
                             "--structure", "1", "1", "1", "1", "--iters", "1",
                             "--resume", run.checkpoint])
    assert served.maps.shape == (2, 48, 64)

    # a partial warm start takes every entry of the saved model
    again = train_plain.main([
        "--dataroot", str(tmp_path / "train"), "--device", "cpu",
        "--structure", "1", "1", "1", "1", "--batch_size", "2",
        "--n_epochs", "1", "--max_iters_per_epoch", "1",
        "--resume_partial", run.checkpoint,
        "--checkpointname", str(tmp_path / "ck2"),
        "--log_dir", str(tmp_path / "runs")])
    assert len(again.losses) == 1


def test_train_plain_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_plain.main(["--dataroot", str(tmp_path)])
