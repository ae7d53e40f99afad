"""The port's IR uncertainty pretrainer against ``heatnet_tpu``.

Small sizes, float32, inputs from numpy with fixed seeds, both packages on
the CPU, weights carried JAX → port with ``state_dict_from_jax`` (strict):

- ``ResNeXtEncoder`` (structure (1,1,1,1), the 7x7 stem and the 3x3 one)
  and ``ResNeXtDecoder`` (each last activation) forwards, eval mode with
  randomised BN statistics, at rtol 1e-3 / atol 2e-3;
- 3 steps against ``make_uncertainty_step`` (two encoders of 12 and 1
  classes, the seg and the sigmoid uncertainty decoders) with the contract
  of tests/test_train_parity.py: losses at rtol 2e-3 / atol 2e-4; step-0
  gradients at relative L2 0.05 per tensor of norm >= 1e-4 (2 x Adam's
  first moment, b1 = 0.5); updates within 5 % elementwise on >= 95 % of
  elements; BN running statistics against JAX's ``batch_stats``;
- the CLI on the CPU on a tiny train pack; its checkpoint loads strictly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from heatnet_tpu.models.segnetsplit import ResNeXtDecoder as JaxDecoder
from heatnet_tpu.models.segnetsplit import ResNeXtEncoder as JaxEncoder
from heatnet_tpu.train.optim import lambda_linear_decay as jax_linear_decay
from heatnet_tpu.train.uncertainty import UncertaintyState, make_uncertainty_step
from heatnet_tpu_torch.cli import train_uncertainty
from heatnet_tpu_torch.data.packed import write_train_pack
from heatnet_tpu_torch.io.checkpoint import load_state_dict
from heatnet_tpu_torch.io.from_jax import state_dict_from_jax
from heatnet_tpu_torch.models.segnetsplit import ResNeXtDecoder, ResNeXtEncoder
from heatnet_tpu_torch.train import uncertainty as tu
from heatnet_tpu_torch.train.optim import lambda_linear_decay

from test_torch_cyclegan import _check_grads, _check_updates, _flat
from test_torch_layers import randomize

torch.set_num_threads(2)

TINY = (1, 1, 1, 1)
TOL = dict(rtol=1e-3, atol=2e-3)


def _ir(seed, n=2, hw=(64, 96)):
    return np.random.RandomState(seed).rand(n, *hw, 1).astype(np.float32)


def _carry(mod_j, mod_t, *inputs):
    v = randomize(dict(jax.jit(mod_j.init)(jax.random.PRNGKey(0),
                                           *[jnp.asarray(x) for x in inputs])))
    mod_t.load_state_dict(state_dict_from_jax(v["params"], v.get("batch_stats")),
                          strict=True)
    return v, mod_t.eval()


@pytest.mark.parametrize("input_3x3", [False, True])
def test_encoder_matches_jax(input_3x3):
    ir = _ir(1)
    v, enc_t = _carry(JaxEncoder(structure=TINY, in_channels=1, classes=12,
                                 input_3x3=input_3x3),
                      ResNeXtEncoder(structure=TINY, in_channels=1, classes=12,
                                     input_3x3=input_3x3), ir)
    seg_j, out4_j = JaxEncoder(structure=TINY, in_channels=1, classes=12,
                               input_3x3=input_3x3).apply(v, jnp.asarray(ir))
    with torch.no_grad():
        seg_t, out4_t = enc_t(torch.from_numpy(ir))
    np.testing.assert_allclose(seg_t.numpy(), np.asarray(seg_j), **TOL)
    np.testing.assert_allclose(out4_t.numpy(), np.asarray(out4_j), **TOL)
    down = 4 if input_3x3 else 2
    assert tuple(out4_t.shape) == (2, 64 // down, 96 // down, 256)


@pytest.mark.parametrize("act", ["none", "sigmoid", "log_softmax"])
def test_decoder_matches_jax(act):
    rng = np.random.RandomState(2)
    classes = 1 if act == "sigmoid" else 12
    enc = rng.randn(2, 8, 12, classes).astype(np.float32)
    out4 = rng.randn(2, 16, 24, 256).astype(np.float32)
    dec_j = JaxDecoder(out_classes=classes, last_activation=act)
    v, dec_t = _carry(dec_j, ResNeXtDecoder(classes, act), enc, out4)
    with torch.no_grad():
        got = dec_t(torch.from_numpy(enc), torch.from_numpy(out4))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 32, 48, classes)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        dec_j.apply(v, jnp.asarray(enc), jnp.asarray(out4))), **TOL)
    with pytest.raises(ValueError, match="last_activation"):
        ResNeXtDecoder(12, "softmax")


def _init_jax(ir):
    enc1 = JaxEncoder(structure=TINY, in_channels=1, classes=12)
    enc2 = JaxEncoder(structure=TINY, in_channels=1, classes=1)
    seg_dec = JaxDecoder(out_classes=12)
    unc_dec = JaxDecoder(out_classes=1, last_activation="sigmoid")
    params, stats = {}, {}
    x = jnp.asarray(ir)
    for k, (name, mod) in enumerate((("encoder1", enc1), ("encoder2", enc2))):
        v = jax.jit(lambda key, x, m=mod: m.init(key, x, train=True))(
            jax.random.PRNGKey(k), x)
        params[name], stats[name] = v["params"], v["batch_stats"]
    for k, (name, mod, enc_name, enc) in enumerate((
            ("seg_decoder", seg_dec, "encoder1", enc1),
            ("unc_decoder", unc_dec, "encoder2", enc2))):
        e, o4 = enc.apply({"params": params[enc_name], "batch_stats": stats[enc_name]}, x)
        v = jax.jit(lambda key, e, o, m=mod: m.init(key, e, o, train=True))(
            jax.random.PRNGKey(2 + k), e, o4)
        params[name], stats[name] = v["params"], v["batch_stats"]
    return (enc1, enc2, seg_dec, unc_dec), params, stats


def test_three_steps_match_jax():
    """At lr 1e-6 (the reason: test_torch_cyclegan's step test; Adam's first
    updates are lr·sign(g) either way), under the linear decay (n_epochs 3,
    decay from epoch 1: rates lr, lr, lr/2), batch 4 of 64x96 IR.

    The frames differ in mean brightness. Frames of iid noise share their
    means, so the ASPP's global branch normalises 4 nearly equal values per
    channel and the deep encoder gradients follow f32 rounding: updates
    then differed by > 5 % on 0.9, 4.6 and 6.4 % of the elements after
    steps 0-2 (most in mod3-mod5 and the ASPP); with the offsets 0.5, 2.2
    and 3.3 % (the test prints the shares)."""
    lr = 1e-6
    batches = []
    for i in range(3):
        rng = np.random.RandomState(50 + i)
        label = rng.randint(0, 12, (4, 64, 96)).astype(np.int32)
        label[rng.rand(4, 64, 96) < 0.1] = -1
        # frames of unlike mean brightness, as frames of different scenes are
        offset = np.linspace(0.0, 0.5, 4, dtype=np.float32)[:, None, None, None]
        batches.append({"ir": 0.5 * _ir(60 + i, n=4) + offset, "label": label})
    mods_j, params, stats = _init_jax(batches[0]["ir"])
    state_j = UncertaintyState.create(params, stats, optax.adam(
        jax_linear_decay(3, 0, 1, lr, 1), b1=0.5, b2=0.999))
    step_j = make_uncertainty_step(*mods_j)

    mods = {"encoder1": ResNeXtEncoder(structure=TINY, in_channels=1, classes=12),
            "encoder2": ResNeXtEncoder(structure=TINY, in_channels=1, classes=1),
            "seg_decoder": ResNeXtDecoder(12),
            "unc_decoder": ResNeXtDecoder(1, "sigmoid")}
    for k, m in mods.items():
        m.load_state_dict(state_dict_from_jax(params[k], stats[k]), strict=True)
    state_t = tu.create_state(mods, lambda_linear_decay(3, 0, 1, lr, 1))
    step_t = tu.make_uncertainty_step(*(mods[k] for k in tu.MODULE_NAMES))

    start = _flat(params)
    for i, b in enumerate(batches):
        state_j, m_j = step_j(state_j, {k: jnp.asarray(v) for k, v in b.items()})
        m_t = step_t(state_t, {"ir": torch.from_numpy(b["ir"]),
                               "label": torch.from_numpy(b["label"]).long()})
        for k in m_j:
            np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=2e-3,
                                       atol=2e-4, err_msg=f"step {i} {k}")
        sd = state_t.model.state_dict()
        for k, v in state_dict_from_jax({}, state_j.batch_stats).items():
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-3, atol=1e-4,
                                       err_msg=f"step {i} {k}")
        if i == 0:
            moments = {n: 2 * state_t.optimizer.state[p]["exp_avg"].numpy()
                       for n, p in state_t.model.named_parameters()}
            assert _check_grads(moments, jax.tree_util.tree_map(
                lambda m: 2 * np.asarray(m), state_j.opt_state[0].mu), "step 0") > 40
        now_t = {k: v.detach().numpy() for k, v in state_t.model.named_parameters()}
        _check_updates(now_t, _flat(state_j.params), start, lr, f"step {i}")
    assert state_t.step == int(state_j.step) == 3


def test_cli_trains_on_a_train_pack(tmp_path):
    rng = np.random.RandomState(0)
    pack = str(tmp_path / "pack")
    write_train_pack(pack, rng.randint(0, 256, (2, 320, 960, 3)).astype(np.uint8),
                     rng.randint(21000, 26000, (2, 320, 960)).astype(np.uint16),
                     rng.randint(0, 12, (2, 320, 960)).astype(np.uint8),
                     rng.randint(0, 256, (1, 320, 960, 3)).astype(np.uint8),
                     rng.randint(21000, 26000, (1, 320, 960)).astype(np.uint16))
    run = train_uncertainty.main([
        "--dataroot", pack, "--device", "cpu", "--structure", "1", "1", "1", "1",
        "--batch_size", "2", "--n_epochs", "1", "--checkpointname", str(tmp_path / "unc"),
        "--log_dir", str(tmp_path / "runs")])
    assert len(run.losses) == 1 and np.isfinite(run.losses[0])
    saved = torch.load(run.checkpoint, map_location="cpu", weights_only=True)
    assert saved["epoch"] == 1
    mods = train_uncertainty.build_modules(TINY, torch.device("cpu"))
    torch.nn.ModuleDict(mods).load_state_dict(load_state_dict(run.checkpoint), strict=True)
    # a directory that is neither a train pack nor a Freiburg tree
    with pytest.raises(FileNotFoundError, match="no Freiburg Thermal data"):
        train_uncertainty.main(["--dataroot", str(tmp_path), "--device", "cpu"])
