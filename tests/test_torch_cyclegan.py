"""The port's CycleGAN trainer against ``heatnet_tpu`` (models, steps, CLIs).

Small sizes, float32, inputs from numpy with fixed seeds, both packages on
the CPU, weights carried JAX → port with ``state_dict_from_jax`` (strict):

- ``Generator`` (1 and 2 residual blocks, 64x64) forwards at rtol 1e-3 /
  atol 2e-3, and its transposed convs ``up1``/``up2`` converted as
  transposed convs (flipped), which the forward depends on;
- the numpy ``ReplayBuffer`` bit-equal to JAX's for the same seed and
  inputs; ``DeviceReplayBuffer``'s semantics;
- 3 rounds of generator + D_A + D_B steps against ``make_cyclegan_steps``
  (generators with 1 residual block, netSeg (1,1,1,1), 64x64, batch 4),
  with the contract of tests/test_train_parity.py: losses at rtol 2e-3 /
  atol 2e-4; step-0 gradients at relative L2 0.05 per tensor of norm >=
  1e-4 (read from Adam's first moment: after one step it is (1 - b1) g in
  both frameworks); updates within 5 % elementwise on >= 95 % of
  elements; netSeg's running statistics against JAX's ``batch_stats``
  after each generator step (two train-mode forwards, real_A then fake_B);
  the discriminators bit-equal across a generator step;
- the CLIs end to end on the CPU: ``train_cyclegan`` → ``test_cyclegan
  --run_seg`` on a ``make_kaist`` tree.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from heatnet_tpu.models import ResNeXtSeg as JaxResNeXtSeg
from heatnet_tpu.models.cyclegan import Discriminator as JaxDiscriminator
from heatnet_tpu.models.cyclegan import Generator as JaxGenerator
from heatnet_tpu.train import cyclegan as jc
from heatnet_tpu.train.optim import lambda_linear_decay as jax_linear_decay
from heatnet_tpu.train.state import init_model
from heatnet_tpu_torch.cli import test_cyclegan, train_cyclegan
from heatnet_tpu_torch.data.loaders import KAISTCycleGANDataset, to_device
from heatnet_tpu_torch.data.png import read_png
from heatnet_tpu_torch.data.synthetic import make_kaist
from heatnet_tpu_torch.io.checkpoint import load_state_dict
from heatnet_tpu_torch.io.from_jax import state_dict_from_jax
from heatnet_tpu_torch.models import ResNeXtSeg
from heatnet_tpu_torch.models.critics import PoolDiscriminator
from heatnet_tpu_torch.models.cyclegan import Discriminator, Generator
from heatnet_tpu_torch.models.layers import prepare_for_inference
from heatnet_tpu_torch.train import cyclegan as tc
from heatnet_tpu_torch.train.optim import lambda_linear_decay
from heatnet_tpu_torch.utils.vis import color_code_labels

torch.set_num_threads(2)

TINY = (1, 1, 1, 1)
HW = 64
TOL = dict(rtol=1e-3, atol=2e-3)
# Adam's first steps move an element by about lr·sign(g): where the two
# frameworks' f32 gradients straddle 0, the update flips (as RMSprop's do in
# tests/test_torch_adversarial.py). Later steps add elements whose f32
# gradients (which agree to about 1 % rel L2 per tensor in netSeg's deep
# layers, where train-mode BN sees few values per channel) tip Adam's
# moments. Measured at batch 4: 0.36, 2.2 and 3.7 % of the generator step's
# elements after rounds 0, 1 and 2, at most 0.12 % of a discriminator's (the
# test prints the shares); at batch 2, 5.06 % after round 2, so the test
# runs at batch 4.
UPDATE_FLIPS = 0.05


def _perturbed(params, seed):
    """normal002 weights and zero biases plus N(0, 0.02) noise, so that no
    bias is zero and no two layers are alike."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + (rng.randn(*a.shape) * 0.02).astype(np.float32), params)


def _x(seed, n=4, hw=HW):
    return (np.random.RandomState(seed).rand(n, hw, hw, 1) * 2 - 1).astype(np.float32)


# -- models ---------------------------------------------------------------------

@pytest.mark.parametrize("n_res", [1, 2])
def test_generator_matches_jax(n_res):
    gen_j = JaxGenerator(output_nc=1, n_residual_blocks=n_res)
    x = _x(n_res)
    params = _perturbed(jax.jit(gen_j.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"],
                        n_res)
    gen_t = Generator(1, n_res)
    gen_t.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        y = gen_t(torch.from_numpy(x))
    assert y.dtype == torch.float32 and tuple(y.shape) == x.shape
    np.testing.assert_allclose(y.numpy(), np.asarray(gen_j.apply({"params": params},
                                                                 jnp.asarray(x))), **TOL)


def test_generator_transposed_convs_are_converted_as_such():
    """``up1``/``up2`` fall under ``TRANSPOSE_NAMES``' ``up`` prefix: the
    kernel is flipped and laid out (I, O, kh, kw). A plain-conv layout of
    the same kernel (a fault that keeps every shape) moves the output."""
    gen_j = JaxGenerator(output_nc=1, n_residual_blocks=1)
    x = _x(3)
    params = _perturbed(jax.jit(gen_j.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 3)
    sd = state_dict_from_jax(params)
    for name in ("up1", "up2"):
        k = np.asarray(params[name]["kernel"])
        np.testing.assert_array_equal(sd[f"{name}.weight"].numpy(),
                                      np.flip(k, (0, 1)).transpose(2, 3, 0, 1))
    gen_t = Generator(1, 1)
    assert gen_t.up1.output_padding == (1, 1) and gen_t.up1.stride == (2, 2)
    unflipped = dict(sd)
    for name in ("up1", "up2"):
        unflipped[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(
            np.asarray(params[name]["kernel"]).transpose(2, 3, 0, 1)))
    gen_t.load_state_dict(unflipped, strict=True)
    with torch.no_grad():
        wrong = gen_t(torch.from_numpy(x)).numpy()
    want = np.asarray(gen_j.apply({"params": params}, jnp.asarray(x)))
    assert np.abs(wrong - want).max() > 10 * TOL["atol"]


def test_discriminator_is_the_pool_critic():
    assert Discriminator is PoolDiscriminator


# -- replay buffers ------------------------------------------------------------------

def test_numpy_replay_buffer_is_bit_equal_to_jax():
    rng = np.random.RandomState(0)
    port, ref = tc.ReplayBuffer(max_size=5, seed=3), jc.ReplayBuffer(max_size=5, seed=3)
    for i in range(12):
        batch = rng.randn(2, 4, 4, 1).astype(np.float32)
        np.testing.assert_array_equal(port.push_and_pop(batch), ref.push_and_pop(batch))
    assert len(port.data) == 5


def test_device_replay_buffer_semantics():
    buf = tc.DeviceReplayBuffer(4, (2, 2, 1), torch.device("cpu"))
    g = torch.Generator().manual_seed(0)
    # filling: every element passes through and is stored
    for i in range(2):
        out = buf.push_and_pop(torch.full((2, 2, 2, 1), float(i)), g)
        assert torch.equal(out, torch.full((2, 2, 2, 1), float(i)))
    assert buf.size == 4 and sorted(buf.data[:, 0, 0, 0].tolist()) == [0, 0, 1, 1]
    # full: each element is either passed through or swapped for a stored one
    seen, passed, n = {0.0, 1.0}, 0, 200
    for i in range(n // 2):
        new = 100.0 + i
        stored_before = set(buf.data[:, 0, 0, 0].tolist())
        out = buf.push_and_pop(torch.full((2, 2, 2, 1), new), g)
        for v in out[:, 0, 0, 0].tolist():
            assert v == new or v in stored_before | seen
            passed += v == new
        assert buf.size == 4
        seen |= stored_before
    assert 0.4 < passed / n < 0.6  # p = 0.5
    assert all(v >= 100.0 for v in buf.data[:, 0, 0, 0].tolist())  # the old ones left


# -- the steps -----------------------------------------------------------------------

def _batches(n_rounds=3):
    out = []
    for i in range(n_rounds):
        rng = np.random.RandomState(20 + i)
        label = rng.randint(0, 12, (4, HW, HW)).astype(np.int32)
        label[rng.rand(4, HW, HW) < 0.1] = -1  # ignored pixels
        out.append({"A": _x(30 + i), "B": _x(40 + i), "label": label})
    return out


def _flat(tree):
    return {k: v.numpy() for k, v in state_dict_from_jax(tree).items()}


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _first_moments(ts):
    """``{name: exp_avg}`` of a port TrainState's Adam."""
    return {n: ts.optimizer.state[p]["exp_avg"].numpy()
            for n, p in ts.model.named_parameters() if p in ts.optimizer.state}


def _check_grads(moments_t, mu_j, what):
    """Step-0 gradients: 2 x Adam's first moment (b1 = 0.5) on both sides."""
    compared = 0
    for k, v in _flat(mu_j).items():
        if np.linalg.norm(v.astype(np.float64)) >= 1e-4:
            err = _rel_l2(moments_t[k], v)
            assert err < 0.05, f"{what}: gradient of {k}: rel L2 {err:.3g}"
            compared += 1
    return compared


def _check_updates(now_t, now_j, start, lr, what):
    n_el = n_bad = 0
    for k, v in now_j.items():
        d_j, d_t = v - start[k], now_t[k] - start[k]
        bad = np.abs(d_t - d_j) > 0.05 * np.abs(d_j) + 1e-3 * lr
        n_el, n_bad = n_el + bad.size, n_bad + int(bad.sum())
    print(f"{what}: {n_bad} of {n_el} updates differ by more than 5 %")
    assert n_bad <= UPDATE_FLIPS * n_el, f"{what}: {n_bad} of {n_el} updates differ"


def test_three_rounds_of_steps_match_jax():
    """At lr 1e-6 under the linear decay (n_epochs 3, decay from epoch 1,
    one step per epoch: rates lr, lr, lr/2).

    Adam's first step moves every element by about lr: the 0.4 % of the
    generators' and netSeg's elements whose f32 gradients straddle 0 move
    the other way in one framework (UPDATE_FLIPS). At the CLI's 2e-4 those
    flips alone moved round 1's fakes by up to 7.4e-3 and netSeg's running
    statistics by up to 5.7e-3, and round 2's by 4.3e-2 and 1.0e-2 (batch
    2): what JAX's own run then computes is decided by f32 rounding. At
    1e-6 they stayed within 4.4e-5 in every round, inside the forward and
    statistics tolerances."""
    lr = 1e-6
    gen_a2b_j = JaxGenerator(output_nc=1, n_residual_blocks=1)
    gen_b2a_j = JaxGenerator(output_nc=1, n_residual_blocks=1)
    disc_j = JaxDiscriminator()
    seg_j = JaxResNeXtSeg(structure=TINY, input_channels=1, classes=12)
    batches = _batches()
    x = jnp.asarray(batches[0]["A"])
    init = lambda m, k, *a: jax.jit(m.init)(jax.random.PRNGKey(k), *a)["params"]  # noqa: E731
    g_params = {"netG_A2B": _perturbed(init(gen_a2b_j, 0, x), 0),
                "netG_B2A": _perturbed(init(gen_b2a_j, 1, x), 1)}
    seg_params, seg_stats = init_model(seg_j, jax.random.PRNGKey(2), x, None,
                                       init_kwargs={"train": True})
    g_params["netSeg"] = seg_params
    d_a, d_b = init(disc_j, 3, x, None), init(disc_j, 4, x, None)
    sched_j = jax_linear_decay(3, 0, 1, lr, 1)
    adam = optax.adam(sched_j, b1=0.5, b2=0.999)
    state_j = jc.CycleGANState.create(g_params, seg_stats, d_a, d_b, adam, adam)
    g_j, da_j, db_j = jc.make_cyclegan_steps(gen_a2b_j, gen_b2a_j, disc_j, disc_j, seg_j)

    nets = {"netG_A2B": Generator(1, 1), "netG_B2A": Generator(1, 1),
            "netD_A": Discriminator(1), "netD_B": Discriminator(1),
            "netSeg": ResNeXtSeg(structure=TINY, input_channels=1, classes=12)}
    for k in ("netG_A2B", "netG_B2A"):
        nets[k].load_state_dict(state_dict_from_jax(g_params[k]), strict=True)
    nets["netSeg"].load_state_dict(state_dict_from_jax(seg_params, seg_stats), strict=True)
    nets["netD_A"].load_state_dict(state_dict_from_jax(d_a), strict=True)
    nets["netD_B"].load_state_dict(state_dict_from_jax(d_b), strict=True)
    for m in nets.values():
        m.train()
    state_t = tc.CycleGANState.create(nets, lambda_linear_decay(3, 0, 1, lr, 1))
    g_t, da_t, db_t = tc.make_cyclegan_steps(*(nets[k] for k in (
        "netG_A2B", "netG_B2A", "netD_A", "netD_B", "netSeg")))

    start_g, start_d = _flat(g_params), {"netD_A": _flat(d_a), "netD_B": _flat(d_b)}
    for i, b in enumerate(batches):
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        tb["label"] = tb["label"].long()

        d_before = {n: {k: v.clone() for k, v in nets[n].state_dict().items()}
                    for n in ("netD_A", "netD_B")}
        d_j_before = (state_j.d_a_params, state_j.d_b_params)
        state_j, fa_j, fb_j, m_j = g_j(state_j, jb)
        fa_t, fb_t, m_t = g_t(state_t, tb)
        for k in m_j:
            np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=2e-3,
                                       atol=2e-4, err_msg=f"round {i} {k}")
        np.testing.assert_allclose(fa_t.numpy(), np.asarray(fa_j), **TOL)
        np.testing.assert_allclose(fb_t.numpy(), np.asarray(fb_j), **TOL)
        assert not fa_t.requires_grad and not fb_t.requires_grad
        # no gradient reached the discriminators: bit-equal, both sides
        for n in ("netD_A", "netD_B"):
            assert all(torch.equal(v, d_before[n][k]) for k, v in nets[n].state_dict().items())
            assert all(p.grad is None for p in nets[n].parameters())
        for a, b_ in zip(jax.tree_util.tree_leaves(d_j_before),
                         jax.tree_util.tree_leaves((state_j.d_a_params, state_j.d_b_params))):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b_))
        # netSeg's running statistics: real_A then fake_B, as JAX threads them
        sd = nets["netSeg"].state_dict()
        for k, v in state_dict_from_jax({}, state_j.seg_batch_stats).items():
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-3, atol=1e-4,
                                       err_msg=f"round {i} netSeg {k}")
        if i == 0:
            n = _check_grads({k: 2 * v for k, v in _first_moments(state_t.g).items()},
                             jax.tree_util.tree_map(lambda m: 2 * np.asarray(m),
                                                    state_j.g_opt[0].mu), "g step")
            assert n > 40
        now_t = {k: v.detach().numpy() for k, v in state_t.g.model.named_parameters()}
        _check_updates(now_t, _flat(state_j.g_params), start_g, lr, f"round {i} g step")

        state_j, loss_da_j = da_j(state_j, jb["A"], fa_j)
        state_j, loss_db_j = db_j(state_j, jb["B"], fb_j)
        loss_da_t = da_t(state_t, tb["A"], fa_t)
        loss_db_t = db_t(state_t, tb["B"], fb_t)
        for t, j in ((loss_da_t, loss_da_j), (loss_db_t, loss_db_j)):
            np.testing.assert_allclose(float(t), float(j), rtol=2e-3, atol=2e-4,
                                       err_msg=f"round {i} D loss")
        for name, ts, params_j, opt_j in (("netD_A", state_t.d_a, state_j.d_a_params,
                                           state_j.d_a_opt),
                                          ("netD_B", state_t.d_b, state_j.d_b_params,
                                           state_j.d_b_opt)):
            if i == 0:
                moments = {k.split(".", 1)[1]: 2 * v
                           for k, v in _first_moments(ts).items()}
                _check_grads(moments, jax.tree_util.tree_map(
                    lambda m: 2 * np.asarray(m), opt_j[0].mu), f"{name} step")
            now_t = {k: v.detach().numpy() for k, v in nets[name].named_parameters()}
            _check_updates(now_t, _flat(params_j), start_d[name], lr, f"round {i} {name}")
    assert state_t.step == int(state_j.step) == 3
    assert state_t.d_a.scheduler.last_epoch == 3
    assert state_t.g.optimizer.param_groups[0]["lr"] == 0.0  # lr(3): decayed to 0


def test_label_outside_the_head_gives_nan_as_in_jax():
    from heatnet_tpu.train.supervised import cross_entropy_ignore as jax_ce
    from heatnet_tpu_torch.train.supervised import cross_entropy_ignore

    logits = np.random.RandomState(0).randn(1, 2, 3, 12).astype(np.float32)
    label = np.array([[[0, 12, -1], [13, 5, -3]]])
    want = np.asarray(jax_ce(jnp.asarray(logits), jnp.asarray(label), ignore_index=-1,
                             reduce=False))
    got = cross_entropy_ignore(torch.from_numpy(logits), torch.from_numpy(label),
                               ignore_index=-1, reduce=False).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert np.isnan(got).sum() == 2


# -- the CLIs --------------------------------------------------------------------------

def test_train_then_test_cli_round_trip(tmp_path):
    root = make_kaist(str(tmp_path / "kaist"))
    ckpt = str(tmp_path / "cg")
    tiny = ["--n_residual_blocks", "1", "--seg_structure", "1", "1", "1", "1",
            "--device", "cpu"]
    loss = train_cyclegan.main(["--dataroot", root, "--n_epochs", "1", "--batchSize", "1",
                                "--max_iters_per_epoch", "1", "--checkpoint_dir", ckpt,
                                "--log_dir", str(tmp_path / "runs"), *tiny])
    assert np.isfinite(loss)
    nets = {"netG_A2B": Generator(1, 1), "netG_B2A": Generator(1, 1),
            "netD_A": Discriminator(1), "netD_B": Discriminator(1),
            "netSeg": ResNeXtSeg(structure=TINY, input_channels=1, classes=12)}
    for name, net in nets.items():
        net.load_state_dict(load_state_dict(os.path.join(ckpt, name + ".pth")), strict=True)
    # netSeg trained one step in train mode: its running stats moved
    assert not torch.equal(nets["netSeg"].bn_out_1.bn.running_var,
                           torch.ones_like(nets["netSeg"].bn_out_1.bn.running_var))

    out = str(tmp_path / "out")
    n = test_cyclegan.main(["--dataroot", root, "--checkpoint_dir", ckpt,
                            "--output_dir", out, "--limit", "2", "--run_seg", *tiny])
    assert n == 2
    seg_net = prepare_for_inference(nets["netSeg"], torch.device("cpu"))
    gen = prepare_for_inference(nets["netG_A2B"], torch.device("cpu"))
    item = KAISTCycleGANDataset(root)[0]
    with torch.no_grad():
        pred = seg_net(to_device(item["B"][None], torch.device("cpu")))[0].argmax(-1)[0]
        fake_b = gen(torch.from_numpy(item["A"][None]))[0, ..., 0].numpy()
    want_seg = (color_code_labels(pred.numpy()) * 255).astype(np.uint8)
    np.testing.assert_array_equal(read_png(os.path.join(out, "seg_0000.png")), want_seg)
    want_b = (np.clip(0.5 * (fake_b + 1.0), 0, 1) * 255).astype(np.uint8)
    np.testing.assert_array_equal(read_png(os.path.join(out, "B", "0000.png"))[..., 0], want_b)
    for sub in ("A", "B"):
        assert sorted(os.listdir(os.path.join(out, sub))) == ["0000.png", "0001.png"]
