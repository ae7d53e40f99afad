"""The port's adversarial trainer against ``heatnet_tpu.train.adversarial``.

Small sizes, float32, inputs from numpy with fixed seeds, both packages on
the CPU, weights carried JAX → port with ``state_dict_from_jax`` (strict):

- the seg phase's augmentations (``rect_drop``, ``ir_scale_aug``,
  ``smart_augment``, ``_augment_day``) fed the draws of the JAX key;
- ``ConfSegnet``'s output dict at structure (1,1,1,1), 64x64, 2 ``resnet18``
  critics, with and without ``feedback_seg`` and the input adapter, and the
  BN statistics after its train-mode forward (rtol 1e-3 / atol 2e-3 for
  outputs, 1e-3 / 1e-4 for statistics);
- alternating critic / seg / critic steps against ``make_adversarial_steps``
  with the fixture of tests/test_train.py:97-115 plus the night-supervision
  teacher, under a ``step_lr`` schedule that halves after one step of each
  phase: losses at rtol 2e-3 / atol 2e-4 (tests/test_train_parity.py:199),
  phase isolation (the frozen side bit-for-bit unchanged), and after each
  step every trained parameter's change since the start within 5 % of
  JAX's, elementwise, on all but ``UPDATE_FLIPS`` of the elements (sign
  flips of RMSprop's first steps where f32 gradients straddle 0);
- the no-conf case of tests/test_train.py:157-177;
- the per-phase optimizers (membership, own moments, own schedules) and
  that the critic phase builds no graph through the frozen segnet.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heatnet_tpu.models import ConfSegnet as JaxConfSegnet
from heatnet_tpu.models import ResNeXtSeg as JaxResNeXtSeg
from heatnet_tpu.ops import preprocess as jp
from heatnet_tpu.train import adversarial as ja
from heatnet_tpu.train.optim import step_lr as jax_step_lr
from heatnet_tpu.train.state import init_model
from heatnet_tpu_torch.io.from_jax import state_dict_from_jax
from heatnet_tpu_torch.models import ConfSegnet, ResNeXtSeg
from heatnet_tpu_torch.models.layers import prepare_for_inference
from heatnet_tpu_torch.ops import preprocess as tp
from heatnet_tpu_torch.train import adversarial as ta
from heatnet_tpu_torch.train.optim import step_lr

torch.set_num_threads(2)

TINY = (1, 1, 1, 1)
HW_CYCLEGAN = 256
# RMSprop's first step moves an element by ~10 lr sign(g): where the two
# frameworks' f32 gradients (which agree to a few % rel L2 per tensor,
# tests/test_torch_train.py) straddle 0, the update flips. Measured: 0.01 %
# of the first critic step's elements, 1.1 % of the seg step's, 3.1 % of the
# second critic step's (its taps come from segnets already that far apart);
# the losses hold at rtol 2e-3 at every step.
UPDATE_FLIPS = 0.05
TOL = dict(rtol=1e-3, atol=2e-3)


def _batch(n=2, hw=64, seed=0, drop=True):
    rng = np.random.RandomState(seed)
    b = {"rgb_day": rng.rand(n, hw, hw, 3).astype(np.float32),
         "ir_day": rng.rand(n, hw, hw, 1).astype(np.float32),
         "rgb_night": rng.rand(n, hw, hw, 3).astype(np.float32),
         "ir_night": rng.rand(n, hw, hw, 1).astype(np.float32),
         "label_day": rng.randint(0, 13, (n, hw, hw)).astype(np.int32)}
    if drop:
        b["mod_drop_params"] = np.array([[5, 5, 20, 20], [0, 0, 10, 10]][:n], np.int32)
    return b


def _jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch(b):
    t = {k: torch.from_numpy(v) for k, v in b.items()}
    t["label_day"] = t["label_day"].long()
    return t


def jax_draws(key, num_classes=13):
    """The draws ``_augment_day`` makes from the seg step's key
    (adversarial.py:250, preprocess.py:253-281), as ``SegAugDraws``."""
    k_aug, _ = jax.random.split(key)
    k1, k2, k3, k4, _ = jax.random.split(k_aug, 5)
    s1, s2 = jax.random.split(k3)
    m1, m2 = jax.random.split(k4)
    u = lambda k, **kw: np.asarray(jax.random.uniform(k, **kw))
    return ta.SegAugDraws(
        moddrop=bool(u(k1) > 0.5), drop_rgb=bool(u(k2) > 0.5),
        irscale=bool(u(s1) > 0.5), irscale_factor=float(u(s2, minval=0.1, maxval=1.0)),
        smart=bool(u(m1) > 0.5),
        smart_factors=torch.from_numpy(u(m2, shape=(num_classes + 1,),
                                         minval=0.1, maxval=1.0).copy()))


# -- the seg phase's augmentations ---------------------------------------------

def test_rect_drop_ir_scale_and_smart_augment_match_jax():
    b = _batch(seed=1)
    params = np.array([[3, 7, 20, 30], [40, 0, 30, 64]], np.int32)
    for k in ("rgb_day", "ir_day"):
        np.testing.assert_array_equal(
            tp.rect_drop(torch.from_numpy(b[k]), torch.from_numpy(params)).numpy(),
            np.asarray(jp.rect_drop(jnp.asarray(b[k]), jnp.asarray(params))))
    ir, lab = b["ir_day"], b["label_day"]
    for seed in range(6):  # both outcomes of each coin
        key = jax.random.PRNGKey(seed)
        k1, k2 = jax.random.split(key)
        do = bool(jax.random.uniform(k1) > 0.5)
        scale = float(jax.random.uniform(k2, minval=0.1, maxval=1.0))
        np.testing.assert_allclose(
            tp.ir_scale_aug(torch.from_numpy(ir), do, scale).numpy(),
            np.asarray(jp.ir_scale_aug(key, jnp.asarray(ir))), rtol=1e-6)
        f = np.asarray(jax.random.uniform(k2, (14,), minval=0.1, maxval=1.0))
        np.testing.assert_allclose(
            tp.maybe_smart_augment(torch.from_numpy(ir), torch.from_numpy(lab), do,
                                   torch.from_numpy(f.copy())).numpy(),
            np.asarray(jp.maybe_smart_augment(key, jnp.asarray(ir), jnp.asarray(lab))),
            rtol=1e-6)


@pytest.mark.parametrize("seed", range(4))
def test_augment_day_matches_jax_with_the_keys_draws(seed):
    cfg_j = ja.AdversarialConfig(moddrop=True, irscale=True, smartirscale=True)
    cfg_t = ta.AdversarialConfig(moddrop=True, irscale=True, smartirscale=True)
    b = _batch(seed=2)
    key = jax.random.PRNGKey(100 + seed)
    k_aug, _ = jax.random.split(key)
    want = ja._augment_day(k_aug, _jax(b), cfg_j)
    got = ta.augment_day(_torch(b), jax_draws(key), cfg_t)
    for k in ("rgb_day", "ir_day"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6)


def test_draw_seg_aug_ranges():
    g = torch.Generator().manual_seed(0)
    draws = [ta.draw_seg_aug(g) for _ in range(200)]
    assert 40 < sum(d.moddrop for d in draws) < 160
    f = torch.stack([d.smart_factors for d in draws])
    assert f.shape == (200, 14) and float(f.min()) >= 0.1 and float(f.max()) <= 1.0
    assert all(0.1 <= d.irscale_factor <= 1.0 for d in draws)


# -- the model -----------------------------------------------------------------

def _pair(seed=0, disc_arch="resnet18", hw=64, **kw):
    """A JAX ConfSegnet's variables and a port ConfSegnet built from them."""
    model_j = JaxConfSegnet(disc_arch=disc_arch, num_critics=2, structure=TINY, **kw)
    b = _batch(hw=hw)
    in_day = [jnp.asarray(b["rgb_day"]), jnp.asarray(b["ir_day"])]
    params, stats = init_model(model_j, jax.random.PRNGKey(seed), in_day, in_day,
                               init_kwargs={"train": True})
    model_t = ConfSegnet(disc_arch=disc_arch, num_critics=2, structure=TINY, **kw)
    model_t.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    return model_j, params, stats, model_t.train()


def _flat(tree):
    return {k: v.numpy() for k, v in state_dict_from_jax(tree).items()}


def _randomize_stats(stats, seed=9):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda v: jnp.asarray(rng.rand(*v.shape).astype(np.float32) + 0.5), stats)


@pytest.mark.parametrize("kw", [{}, {"feedback_seg": True, "input_adapter": True}],
                         ids=["plain", "feedback_seg+adapter"])
def test_conf_segnet_output_dict_matches_jax(kw):
    """Eval mode, every output; train mode, every output but the critics'
    maps and every BN statistic but the critics'. A resnet18 critic on the
    8x8 tap of a 64x64 input normalises 2 values per channel at 1x1 in its
    deep layers in train mode: its output moves from -0.16 to 0.55 under a
    1e-5 change of its input, so f32 summation order alone decides it
    (the train-mode critics are held in the step test with cyclegan ones)."""
    model_j, params, stats, model_t = _pair(**kw)
    stats = _randomize_stats(stats)
    model_t.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    b = _batch(seed=3)
    ins = lambda s, f: [f(b[f"rgb_{s}"]), f(b[f"ir_{s}"])]
    n_crit = 2 + bool(kw.get("input_adapter"))
    for train in (False, True):
        out_j = model_j.apply({"params": params, "batch_stats": stats},
                              ins("day", jnp.asarray), ins("night", jnp.asarray),
                              train=train, mutable=["batch_stats"] if train else False)
        if train:
            out_j, new = out_j
        with torch.no_grad():
            out_t = model_t.train(train)(ins("day", torch.from_numpy),
                                         ins("night", torch.from_numpy))
        assert set(out_t) == set(out_j)
        assert len(out_t["critics_a"]) == len(out_t["critics_b"]) == n_crit
        for k in sorted(out_j):
            if out_j[k] is None:
                assert out_t[k] is None, k
                continue
            if train and k.startswith("critics_"):
                continue
            pairs = (zip(out_t[k], out_j[k]) if isinstance(out_j[k], list)
                     else [(out_t[k], out_j[k])])
            for i, (t, j) in enumerate(pairs):
                np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL,
                                           err_msg=f"train={train} {k}[{i}]")
    sd = {k: v.numpy() for k, v in model_t.state_dict().items()}
    for k, v in state_dict_from_jax({}, new["batch_stats"]).items():
        if not k.startswith(("critics_", "adapter_disc")):
            np.testing.assert_allclose(sd[k], v.numpy(), rtol=1e-3, atol=1e-4,
                                       err_msg=k)


def test_critic_phase_builds_no_graph_through_the_frozen_segnet():
    model = ConfSegnet(disc_arch="resnet18", num_critics=2, structure=TINY)
    b = _torch(_batch())
    seg_loss, critic_loss = ta.make_adversarial_losses(model, ta.AdversarialConfig())
    loss, _ = critic_loss(b)  # the critic step's own forward
    taps = model([b["rgb_day"], b["ir_day"]], [b["rgb_night"], b["ir_night"]])["inter_f_b"]
    assert not any(t.requires_grad for t in taps)
    loss.backward()
    assert all(p.grad is None for p in model.trgb_segnet.parameters())
    assert all(p.grad is not None for p in model.critics_0.parameters())
    # the seg phase: the critics frozen, the graph runs through them
    loss, _ = seg_loss(b, ta.draw_seg_aug(torch.Generator().manual_seed(0)))
    loss.backward()
    assert all(p.grad is None for p in model.critics_1.parameters())
    assert model.trgb_segnet.mod1.conv1.weight.grad is not None


def test_critic_phase_with_the_adapter_runs_dx_but_no_dk_in_the_segnet():
    model = ConfSegnet(disc_arch="resnet18", num_critics=2, structure=TINY,
                       input_adapter=True)
    b = _torch(_batch())
    model.set_phase("train_critic")
    out = model([b["rgb_day"], b["ir_day"]], [b["rgb_night"], b["ir_night"]])
    assert all(t.requires_grad for t in out["inter_f_b"])
    ta.critic_loss(out, ta.conf_criterion("BCE")).backward()
    assert all(p.grad is None for p in model.trgb_segnet.parameters())
    assert model.input_adapter_net.inc.conv1.weight.grad is not None
    assert model.adapter_disc.fc.weight.grad is not None


# -- the optimizers -----------------------------------------------------------------

class _Tree(torch.nn.Module):
    def __init__(self):
        super().__init__()
        for name in ("trgb_segnet", "critics_0", "critics_1", "downscale_nets_0",
                     "adapter_disc"):
            self.add_module(name, torch.nn.Linear(3, 2))


def test_phase_optimizers_keep_their_own_moments_and_schedules():
    model = _Tree()
    sched = step_lr(1.0, step_size=1, gamma=0.5, steps_per_epoch=2)
    state = ta.make_phase_optimizers(model, sched)
    ids = lambda opt: {id(p) for g in opt.param_groups for p in g["params"]}
    seg, crit = ids(state.seg.optimizer), ids(state.critic.optimizer)
    names = {id(p): n.split(".")[0] for n, p in model.named_parameters()}
    assert {names[i] for i in seg} == {"trgb_segnet", "downscale_nets_0", "adapter_disc"}
    assert {names[i] for i in crit} == {"critics_0", "critics_1", "downscale_nets_0",
                                         "adapter_disc"}
    x = torch.ones(1, 3)
    lrs = []
    for phase in ["train_critic"] * 3 + ["train_seg"] * 3:
        ts = state.critic if phase == "train_critic" else state.seg
        lrs.append(ts.optimizer.param_groups[0]["lr"])
        sum(m(x).sum() for m in model.children()).backward()
        frozen = model.critics_0 if phase == "train_seg" else model.trgb_segnet
        before = [p.detach().clone() for p in frozen.parameters()]
        ts.apply_gradients()
        model.zero_grad(set_to_none=True)
        assert all(torch.equal(a, p) for a, p in zip(before, frozen.parameters()))
    # each schedule counts its own steps: halves after its own 2nd step
    assert lrs == [1.0, 1.0, 0.5, 1.0, 1.0, 0.5]
    shared = model.downscale_nets_0.weight
    assert (state.seg.optimizer.state[shared]["square_avg"]
            is not state.critic.optimizer.state[shared]["square_avg"])
    assert model.critics_0.weight not in state.seg.optimizer.state


def test_conf_criterion_phase_machine_and_cert_target_match_jax():
    x = np.random.RandomState(4).randn(2, 5, 6, 1).astype(np.float32)
    for kind in ("MSE", "BCE"):
        for t in (0.0, 1.0):
            np.testing.assert_allclose(
                float(ta.conf_criterion(kind)(torch.from_numpy(x), t)),
                float(ja.conf_criterion(kind)(jnp.asarray(x), t)), rtol=1e-6)
    with pytest.raises(ValueError):
        ta.conf_criterion("L1")
    for no_conf in (False, True):
        cfg = dict(iter_seg_phase=2, iter_critic_phase=3, iter_initial_critic_phase=4)
        pm_j = ja.PhaseMachine(ja.AdversarialConfig(**cfg), no_conf)
        pm_t = ta.PhaseMachine(ta.AdversarialConfig(**cfg), no_conf)
        assert [pm_t.tick() for _ in range(14)] == [pm_j.tick() for _ in range(14)]
    logits = np.random.RandomState(5).randn(2, 4, 5, 13).astype(np.float32)
    label = np.random.RandomState(6).randint(-1, 15, (2, 4, 5))
    np.testing.assert_allclose(
        ta.cert_target(torch.from_numpy(logits), torch.from_numpy(label), 13).numpy(),
        np.asarray(ja.cert_target(jnp.asarray(logits), jnp.asarray(label), 13)),
        rtol=1e-5, atol=1e-6)


# -- the steps against make_adversarial_steps -------------------------------------------

def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_alternating_steps_match_jax():
    """critic, seg, critic steps with moddrop/irscale/smartirscale and the IR
    teacher, a schedule halving after each phase's first step. The critics
    are ``cyclegan`` (the operating point's), at 256x256, the least size
    their five stride-2 convs take on the 1/8 tap: a ``resnet18`` critic's
    train-mode output is decided by f32 rounding at 64x64 (see above)."""
    flags = dict(moddrop=True, irscale=True, smartirscale=True,
                 night_supervision=True, night_sup_modalities="ir")
    model_j, params, stats, model_t = _pair(disc_arch="cyclegan", hw=HW_CYCLEGAN)
    teacher_j = JaxResNeXtSeg(structure=TINY, input_channels=1)
    b = _batch(hw=HW_CYCLEGAN)
    t_params, t_stats = init_model(teacher_j, jax.random.PRNGKey(1),
                                   jnp.asarray(b["ir_night"]), None)
    teacher_t = ResNeXtSeg(structure=TINY, input_channels=1)
    teacher_t.load_state_dict(state_dict_from_jax(t_params, t_stats), strict=True)
    teacher_t = prepare_for_inference(teacher_t, torch.device("cpu"))

    lr = 1e-4
    seg_tx, critic_tx = ja.make_phase_optimizers(
        jax_step_lr(lr, step_size=1, gamma=0.5, steps_per_epoch=1))
    state_j = ja.AdversarialTrainState.create(params, stats, seg_tx, critic_tx)
    seg_j, critic_j = ja.make_adversarial_steps(
        model_j, ja.AdversarialConfig(**flags), teacher_j,
        {"params": t_params, "batch_stats": t_stats})
    state_t = ta.make_phase_optimizers(model_t, step_lr(lr, 1, 0.5, 1))
    seg_t, critic_t = ta.make_adversarial_steps(model_t, ta.AdversarialConfig(**flags),
                                                teacher_t)

    start = _flat(params)
    prev_j = prev_t = start
    batches = [_batch(hw=HW_CYCLEGAN, seed=10 + i) for i in range(3)]
    for i, phase in enumerate(["train_critic", "train_seg", "train_critic"]):
        if phase == "train_seg":
            key = jax.random.PRNGKey(7)
            state_j, m_j = seg_j(state_j, _jax(batches[i]), key)
            m_t = seg_t(state_t, _torch(batches[i]), jax_draws(key))
            keys = ("total_loss", "seg_loss", "conf_loss", "night_seg_loss")
        else:
            state_j, m_j = critic_j(state_j, _jax(batches[i]))
            m_t = critic_t(state_t, _torch(batches[i]))
            keys = ("critic_loss",)
        for k in keys:
            np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=2e-3,
                                       atol=2e-4, err_msg=f"step {i} {k}")

        now_j = _flat(state_j.params)
        now_t = {k: v.detach().numpy() for k, v in model_t.named_parameters()}
        frozen = "critics_" if phase == "train_seg" else "trgb_segnet."
        n_el = n_bad = 0
        for k, v in now_j.items():
            if k.startswith(frozen):  # phase isolation, both sides
                np.testing.assert_array_equal(now_t[k], prev_t[k], err_msg=k)
                np.testing.assert_array_equal(v, prev_j[k], err_msg=k)
                continue
            d_j, d_t = v - start[k], now_t[k] - start[k]
            bad = np.abs(d_t - d_j) > 0.05 * np.abs(d_j) + 1e-3 * lr
            n_el, n_bad = n_el + bad.size, n_bad + int(bad.sum())
        assert n_bad <= UPDATE_FLIPS * n_el, f"step {i}: {n_bad} of {n_el} updates differ"
        prev_j, prev_t = now_j, now_t
    assert state_t.seg.scheduler.last_epoch == 1 and state_t.critic.scheduler.last_epoch == 2
    assert state_t.critic.optimizer.param_groups[0]["lr"] == pytest.approx(lr / 4)
    assert state_t.step == int(state_j.step) == 3


def test_no_conf_seg_step_is_plain_cross_entropy():
    """tests/test_train.py:157-177: no critics, conf_loss 0, total = seg."""
    model_j = JaxConfSegnet(disc_arch="resnet18", num_critics=2, structure=TINY,
                            no_conf=True)
    b = _batch(n=1, drop=False)
    in_day = [jnp.asarray(b["rgb_day"]), jnp.asarray(b["ir_day"])]
    params, stats = init_model(model_j, jax.random.PRNGKey(0), in_day, in_day,
                               init_kwargs={"train": True})
    seg_tx, critic_tx = ja.make_phase_optimizers(lambda _: 1e-4)
    state_j = ja.AdversarialTrainState.create(params, stats, seg_tx, critic_tx)
    seg_j, _ = ja.make_adversarial_steps(model_j, ja.AdversarialConfig())
    _, m_j = seg_j(state_j, _jax(b), jax.random.PRNGKey(0))

    model_t = ConfSegnet(disc_arch="resnet18", num_critics=2, structure=TINY,
                         no_conf=True)
    model_t.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    assert not any(n.startswith("critics_") for n, _ in model_t.named_parameters())
    state_t = ta.make_phase_optimizers(model_t, lambda _: 1e-4)
    seg_t, _ = ta.make_adversarial_steps(model_t, ta.AdversarialConfig())
    m_t = seg_t(state_t, _torch(b), ta.draw_seg_aug(torch.Generator().manual_seed(0)))
    assert float(m_t["conf_loss"]) == 0.0
    assert float(m_t["total_loss"]) == pytest.approx(float(m_t["seg_loss"]))
    np.testing.assert_allclose(float(m_t["total_loss"]), float(m_j["total_loss"]),
                               rtol=2e-3, atol=2e-4)
