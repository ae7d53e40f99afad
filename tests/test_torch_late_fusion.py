"""Late fusion, the 7x7 stem and ResNeXt-101/152 in the port, against JAX.

Small sizes, float32, inputs and weights from numpy with fixed seeds, both
packages on the CPU, weights carried JAX → port with ``state_dict_from_jax``
(strict: every JAX leaf lands on a port tensor), rtol 1e-3 / atol 2e-3 for
outputs and 1e-3 / 1e-4 for BN statistics (the repo's model tolerances):

- late-fusion ``ResNeXtSeg`` at structure (1,1,1,1): logits, all six critic
  taps and the cert branch, eval and train mode, and the state_dict round
  trip through ``convert_state_dict``; ``Stem7x7`` (the Vistas stem, whose
  head runs at twice the input's size); the ResNeXt-101/152 trees;
- ``ConfSegnet(late_fusion=True)``'s output dict;
- critic / seg / critic steps against ``make_adversarial_steps`` to the step
  contract of tests/test_torch_adversarial.py (``check_alternating_steps``,
  which tests/test_torch_pspnet.py runs for arch ``pspnet``);
- ``eval.validate.inference`` on a late-fusion model against JAX's
  ``model.apply`` and argmax on ``_device_normalize``d inputs
  (heatnet_tpu/eval/validate.py:52-68, :97-108), from one two-output ingest
  call per batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from heatnet_tpu.eval.validate import _device_normalize
from heatnet_tpu.io.checkpoint import _flatten
from heatnet_tpu.io.torch_import import convert_state_dict
from heatnet_tpu.models import ConfSegnet as JaxConfSegnet
from heatnet_tpu.models import ResNeXtSeg as JaxResNeXtSeg
from heatnet_tpu.train import adversarial as ja
from heatnet_tpu.train.optim import step_lr as jax_step_lr
from heatnet_tpu_torch.eval import validate
from heatnet_tpu_torch.io.from_jax import state_dict_from_jax
from heatnet_tpu_torch.models import ConfSegnet, ResNeXtSeg, get_model
from heatnet_tpu_torch.models.layers import prepare_for_inference
from heatnet_tpu_torch.ops import fused_preproc
from heatnet_tpu_torch.train import adversarial as ta
from heatnet_tpu_torch.train.optim import step_lr

from test_torch_adversarial import (TOL, UPDATE_FLIPS, _batch, _flat, _jax, _torch,
                                    jax_draws)
from test_torch_critics import randomize_all

torch.set_num_threads(2)

TINY = (1, 1, 1, 1)


def numpy_init(module_j, *inputs, seed=0, **kw):
    """flax variables of ``module_j`` without compiling its init: the tree's
    shapes from ``jax.eval_shape``, the values from numpy. Kernels ~
    N(0, 1/fan_in) (flax's lecun_normal, untruncated), then every BN
    affine and statistic, bias and PReLU slope as ``randomize_all``."""
    shapes = jax.eval_shape(lambda: module_j.init(jax.random.PRNGKey(0), *inputs, **kw))
    rng = np.random.RandomState(seed)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = walk(v)
            elif k == "kernel":
                fan_in = int(np.prod(v.shape[:-1]))
                out[k] = (rng.randn(*v.shape) / np.sqrt(fan_in)).astype(np.float32)
            elif k == "negative_slope":
                out[k] = np.float32(0.05 + 0.2 * rng.rand())
            else:
                out[k] = np.zeros(v.shape, np.float32)
        return out

    return randomize_all({c: walk(t) for c, t in dict(shapes).items()}, seed)


def _inputs(n=2, h=64, w=96, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, h, w, 3).astype(np.float32) * 2 - 1,
            rng.rand(n, h, w, 1).astype(np.float32) * 2 - 1)


def japply(module_j, variables, *inputs, train=False):
    """``module_j.apply`` under jit; in train mode also the new batch_stats."""
    fn = jax.jit(lambda v, *x: module_j.apply(
        v, *x, train=train, mutable=["batch_stats"] if train else False))
    return fn(variables, *jax.tree_util.tree_map(jnp.asarray, inputs))


def assert_round_trip(model_t, variables):
    """The port's state_dict converts back to exactly the JAX tree."""
    model_t.load_state_dict(state_dict_from_jax(variables["params"],
                                                variables.get("batch_stats")))
    p_flat, s_flat = convert_state_dict(model_t.state_dict())
    for col, flat in (("params", p_flat), ("batch_stats", s_flat)):
        want = _flatten(variables.get(col, {}))
        assert set(flat) == set(want), sorted(set(want) ^ set(flat))[:8]
        for k, v in want.items():
            np.testing.assert_array_equal(flat[k], np.asarray(v), err_msg=k)


def assert_stats_close(model_t, new_stats, skip=()):
    sd = {k: v.numpy() for k, v in model_t.state_dict().items()}
    for k, v in state_dict_from_jax({}, new_stats).items():
        if not k.endswith("num_batches_tracked") and not k.startswith(skip):
            np.testing.assert_allclose(sd[k], v.numpy(), rtol=1e-3, atol=1e-4, err_msg=k)


# -- ResNeXtSeg --------------------------------------------------------------------

@pytest.fixture(scope="module")
def late():
    rgb, ir = _inputs()
    m_j = JaxResNeXtSeg(structure=TINY, input_channels=4, late_fusion=True,
                        cert_branch=True, dtype=jnp.float32)
    v = numpy_init(m_j, jnp.asarray(rgb), jnp.asarray(ir))
    m_t = ResNeXtSeg(structure=TINY, input_channels=4, late_fusion=True, cert_branch=True)
    m_t.load_state_dict(state_dict_from_jax(v["params"], v["batch_stats"]), strict=True)
    return m_j, v, m_t


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_late_fusion_resnext_matches_jax(late, train):
    m_j, v, m_t = late
    rgb, ir = _inputs()
    m_t.load_state_dict(state_dict_from_jax(v["params"], v["batch_stats"]))
    with torch.no_grad():
        seg_t, taps_t, cert_t = m_t.train(train)(torch.from_numpy(rgb),
                                                 torch.from_numpy(ir))
    out = japply(m_j, v, rgb, ir, train=train)
    (seg_j, taps_j, cert_j), new = out if train else (out, None)
    assert [t.shape[-1] for t in taps_t] == [13, 768, 1024, 512, 512, 128]
    assert cert_t.shape == (2, 64, 96, 1)
    np.testing.assert_allclose(seg_t.numpy(), np.asarray(seg_j), **TOL)
    np.testing.assert_allclose(cert_t.numpy(), np.asarray(cert_j), **TOL)
    for i, (tt, tj) in enumerate(zip(taps_t, taps_j)):
        np.testing.assert_allclose(tt.numpy(), np.asarray(tj), **TOL,
                                   err_msg=f"critic tap {i}")
    if train:
        assert_stats_close(m_t, new["batch_stats"])


def test_late_fusion_round_trip_and_its_refusals(late):
    _, v, m_t = late
    assert_round_trip(m_t, v)
    with pytest.raises(ValueError, match="RGB and IR apart"):
        m_t.eval()(torch.zeros(1, 32, 32, 3))
    # one modality: the single-stem net, as the JAX module falls back to it
    rgb_only = ResNeXtSeg(structure=TINY, input_channels=3, late_fusion=True)
    assert not rgb_only.late_fusion and not hasattr(rgb_only, "mod1_2")


def test_stem7x7_resnext_matches_jax():
    rgb, _ = _inputs(h=32, w=48, seed=2)
    m_j = JaxResNeXtSeg(structure=TINY, input_channels=3, input_3x3=False,
                        dtype=jnp.float32)
    v = numpy_init(m_j, jnp.asarray(rgb))
    m_t = ResNeXtSeg(structure=TINY, input_channels=3, input_3x3=False)
    m_t.load_state_dict(state_dict_from_jax(v["params"], v["batch_stats"]), strict=True)
    assert set(dict(m_t.mod1.named_parameters())) == {"conv1.weight"}  # no BN
    with torch.no_grad():
        seg_t, taps_t, _ = m_t.eval()(torch.from_numpy(rgb))
    seg_j, taps_j, _ = japply(m_j, v, rgb, None)
    # the stem downsamples 2x (InitBlock: 4x), so the head ends at 2x the input
    assert seg_t.shape == (2, 64, 96, 13) and taps_t[5].shape == (2, 16, 24, 64)
    for i, (tt, tj) in enumerate(zip(taps_t, taps_j)):
        np.testing.assert_allclose(tt.numpy(), np.asarray(tj), **TOL, err_msg=f"tap {i}")


@pytest.mark.parametrize("name,structure", [("net_resnext101", (3, 4, 23, 3)),
                                            ("net_resnext152", (3, 8, 36, 3))])
def test_deep_resnexts_have_the_jax_tree(name, structure):
    m_t = get_model(name, input_channels=4)
    assert [len(getattr(m_t, f"mod{i}_1")) for i in (2, 3, 4, 5)] == list(structure)
    x = jnp.zeros((1, 32, 32, 4))
    shapes = jax.eval_shape(lambda: JaxResNeXtSeg(structure=structure).init(
        jax.random.PRNGKey(0), x))
    p_flat, s_flat = convert_state_dict(m_t.state_dict())
    for col, flat in (("params", p_flat), ("batch_stats", s_flat)):
        want = _flatten(dict(shapes)[col])
        assert set(flat) == set(want)
        assert all(flat[k].shape == want[k].shape for k in want)


# -- ConfSegnet and the adversarial steps ---------------------------------------------

def test_late_fusion_conf_segnet_output_dict_matches_jax():
    """The eval forward, every output (``inter_f_b`` holds all six taps,
    whose widths the critics take from ``tap_channels``, held to JAX's in
    tests/test_torch_critics.py). Train mode is held in the segnet test
    above and in the steps below."""
    kw = dict(disc_arch="resnet18", structure=TINY, late_fusion=True)
    b = _batch(seed=3)
    ins = lambda s, f: [f(b[f"rgb_{s}"]), f(b[f"ir_{s}"])]
    m_j = JaxConfSegnet(num_critics=2, **kw)
    v = numpy_init(m_j, ins("day", jnp.asarray), ins("day", jnp.asarray), train=False)
    m_t = ConfSegnet(num_critics=2, **kw)
    m_t.load_state_dict(state_dict_from_jax(v["params"], v["batch_stats"]), strict=True)
    out_j = japply(m_j, v, ins("day", jnp.asarray), ins("night", jnp.asarray))
    with torch.no_grad():
        out_t = m_t.eval()(ins("day", torch.from_numpy), ins("night", torch.from_numpy))
    assert set(out_t) == set(out_j) and len(out_t["inter_f_b"]) == 6
    for k in sorted(out_j):
        if out_j[k] is None:
            assert out_t[k] is None, k
            continue
        pairs = (zip(out_t[k], out_j[k]) if isinstance(out_j[k], list)
                 else [(out_t[k], out_j[k])])
        for i, (t, j) in enumerate(pairs):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL, err_msg=f"{k}[{i}]")


def jax_dropout_masks(model_j, variables, *inputs, key):
    """The keep masks flax's ``Dropout``s draw in one train-mode apply of
    ``model_j`` with dropout key ``key``, one ``draw_dropout`` tuple per
    PSPNet forward (a ``ConfSegnet`` runs two: day, then night). Each
    ``Dropout`` call is intercepted: its key is drawn with ``make_rng`` (the
    draw it would make itself), the mask computed as flax does and the key
    passed on, so the apply is the one a step with this key runs."""
    masks = []

    def grab(next_fun, args, kwargs, context):
        mod = context.module
        if not isinstance(mod, nn.Dropout) or context.method_name != "__call__":
            return next_fun(*args, **kwargs)
        x, rng = args[0], mod.make_rng(mod.rng_collection)
        shape = [1 if d in mod.broadcast_dims else s for d, s in enumerate(x.shape)]
        keep = jax.random.bernoulli(rng, p=1.0 - mod.rate, shape=shape)
        masks.append(torch.from_numpy(np.array(keep).reshape(x.shape[0], x.shape[-1])))
        return next_fun(*args, rng=rng, **kwargs)

    with nn.intercept_methods(grab):
        model_j.apply(variables, *inputs, train=True, mutable=["batch_stats"],
                      rngs={"dropout": key})
    assert len(masks) % 4 == 0 and masks, len(masks)
    return tuple(tuple(masks[i:i + 4]) for i in range(0, len(masks), 4))


def check_alternating_steps(model_kw, teacher_j, teacher_t, t_vars, hw, n=2,
                            dropout=False, num_critics=2, lr=1e-4):
    """critic, seg and critic steps of the port against the JAX steps, from
    the same weights and batches, with moddrop/irscale/smartirscale and the
    IR teacher, a schedule halving after each phase's first step: losses at
    rtol 2e-3 / atol 2e-4, the frozen side bit-for-bit unchanged, each
    trained parameter's change since the start within 5 % of JAX's on all
    but ``UPDATE_FLIPS`` of the elements. With ``dropout`` each step gets
    the masks of the JAX step's own key (``jax_dropout_masks``)."""
    flags = dict(moddrop=True, irscale=True, smartirscale=True,
                 night_supervision=True, night_sup_modalities="ir")
    model_j = JaxConfSegnet(disc_arch="cyclegan", num_critics=num_critics,
                            structure=TINY, **model_kw)
    b0 = _batch(n=n, hw=hw)
    in_day = [jnp.asarray(b0["rgb_day"]), jnp.asarray(b0["ir_day"])]
    v = numpy_init(model_j, in_day, in_day, train=False)
    params, stats = v["params"], v["batch_stats"]
    model_t = ConfSegnet(disc_arch="cyclegan", num_critics=num_critics, structure=TINY,
                         **model_kw)
    model_t.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    model_t.train()

    seg_tx, critic_tx = ja.make_phase_optimizers(
        jax_step_lr(lr, step_size=1, gamma=0.5, steps_per_epoch=1))
    state_j = ja.AdversarialTrainState.create(params, stats, seg_tx, critic_tx)
    seg_j, critic_j = ja.make_adversarial_steps(model_j, ja.AdversarialConfig(**flags),
                                                teacher_j, t_vars)
    state_t = ta.make_phase_optimizers(model_t, step_lr(lr, 1, 0.5, 1))
    seg_t, critic_t = ta.make_adversarial_steps(model_t, ta.AdversarialConfig(**flags),
                                                teacher_t)

    def masks(batch, key):
        if not dropout:
            return None
        bj = _jax(batch)
        return jax_dropout_masks(
            model_j, {"params": state_j.params, "batch_stats": state_j.batch_stats},
            [bj["rgb_day"], bj["ir_day"]], [bj["rgb_night"], bj["ir_night"]], key=key)

    start = _flat(params)
    prev_j = prev_t = start
    batches = [_batch(n=n, hw=hw, seed=10 + i) for i in range(3)]
    for i, phase in enumerate(["train_critic", "train_seg", "train_critic"]):
        if phase == "train_seg":
            key = jax.random.PRNGKey(7)
            # the seg step's dropout key (heatnet_tpu/train/adversarial.py:284);
            # moddrop may drop a rectangle of the day inputs first, which
            # does not move the masks
            draws = jax_draws(key)
            draws.dropout = masks(batches[i], jax.random.split(key)[1])
            state_j, m_j = seg_j(state_j, _jax(batches[i]), key)
            m_t = seg_t(state_t, _torch(batches[i]), draws)
            keys = ("total_loss", "seg_loss", "conf_loss", "night_seg_loss")
        else:
            # the critic step's key (adversarial.py:341)
            drop = masks(batches[i], jax.random.fold_in(jax.random.PRNGKey(1),
                                                        state_j.step))
            state_j, m_j = critic_j(state_j, _jax(batches[i]))
            m_t = critic_t(state_t, _torch(batches[i]), drop)
            keys = ("critic_loss",)
        for k in keys:
            np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=2e-3,
                                       atol=2e-4, err_msg=f"step {i} {k}")
        now_j = _flat(state_j.params)
        now_t = {k: p.detach().numpy() for k, p in model_t.named_parameters()}
        frozen = "critics_" if phase == "train_seg" else "trgb_segnet."
        n_el = n_bad = 0
        for k, val in now_j.items():
            if k.startswith(frozen):  # phase isolation, both sides
                np.testing.assert_array_equal(now_t[k], prev_t[k], err_msg=k)
                np.testing.assert_array_equal(val, prev_j[k], err_msg=k)
                continue
            d_j, d_t = val - start[k], now_t[k] - start[k]
            bad = np.abs(d_t - d_j) > 0.05 * np.abs(d_j) + 1e-3 * lr
            n_el, n_bad = n_el + bad.size, n_bad + int(bad.sum())
        assert n_bad <= UPDATE_FLIPS * n_el, f"step {i}: {n_bad} of {n_el} updates differ"
        prev_j, prev_t = now_j, now_t
    assert state_t.step == int(state_j.step) == 3


def tiny_ir_teacher(hw):
    """A (1,1,1,1) IR-only ResNeXt teacher on both sides."""
    t_j = JaxResNeXtSeg(structure=TINY, input_channels=1)
    ir = jnp.zeros((1, hw, hw, 1))
    t_vars = numpy_init(t_j, ir, None, seed=1)
    t_t = ResNeXtSeg(structure=TINY, input_channels=1)
    t_t.load_state_dict(state_dict_from_jax(t_vars["params"], t_vars["batch_stats"]),
                        strict=True)
    return t_j, prepare_for_inference(t_t, torch.device("cpu")), t_vars


def test_late_fusion_alternating_steps_match_jax():
    """cyclegan critics at 256x256, the least size their five stride-2 convs
    take on the 1/8 tap (tests/test_torch_adversarial.py); the second critic
    takes the late-fusion tap 1 (768 channels: the fusion and the 512-channel
    two-stream skip)."""
    check_alternating_steps({"late_fusion": True}, *tiny_ir_teacher(256), hw=256)


# -- serving --------------------------------------------------------------------------

def test_validate_inference_serves_late_fusion_from_one_ingest_call(late, monkeypatch):
    m_j, v, m_t = late
    rng = np.random.RandomState(4)
    n, h, w = 3, 32, 48
    rgb = rng.randint(0, 256, (n, h, w, 3)).astype(np.uint8)
    ir = rng.randint(21000, 26000, (n, h, w, 1)).astype(np.uint16)
    calls = []
    two_out = fused_preproc.inference_preprocess_fused

    def counted(*a, **k):
        calls.append(a[0].shape[0])
        return two_out(*a, **k)

    monkeypatch.setattr(fused_preproc, "inference_preprocess_fused", counted)
    monkeypatch.setattr(fused_preproc, "early_fusion_input", None)  # must not run
    m_t.load_state_dict(state_dict_from_jax(v["params"], v["batch_stats"]))
    model = prepare_for_inference(m_t, torch.device("cpu"))
    frames = ({"rgb": rgb[i:i + 1], "ir": ir[i:i + 1]} for i in range(n))
    maps = validate.inference(model, frames, batch_size=2, device="cpu")
    assert calls == [2, 2] and maps.shape == (n, h, w) and maps.dtype == np.uint8

    seg_j, _, _ = japply(m_j, v, _device_normalize(jnp.asarray(rgb)),
                         _device_normalize(jnp.asarray(ir)))
    seg_j = np.asarray(seg_j)
    top2 = np.sort(seg_j, -1)[..., -2:]
    tied = (top2[..., 1] - top2[..., 0]) < 1e-3
    agree = (maps == seg_j.argmax(-1)) | tied
    assert agree.all(), f"{(~agree).sum()} pixels differ"
