"""PSPNet, the dilated extractors and the registry in the port, against JAX.

Float32, inputs and weights from numpy with fixed seeds (``numpy_init``:
the flax tree's shapes from ``jax.eval_shape``, no compiled init), both
packages on the CPU, weights carried JAX → port with ``state_dict_from_jax``
(strict) and back with ``convert_state_dict`` (every leaf hit, values
equal), rtol 1e-3 / atol 2e-3 for outputs and 1e-3 / 1e-4 for BN
statistics:

- ``build_network`` on all 7 backends in eval mode, each extractor at full
  depth, the ResNets also in late fusion (the five taps of the extractor
  are taps 1-5 of PSPNet's output); DenseNet's and SqueezeNet's trees;
- PSPNet in train mode with JAX's own dropout masks injected;
- ``ConfSegnet(arch="pspnet")``'s eval output dict and its late-fusion taps;
- critic / seg / critic steps of arch ``pspnet`` against the JAX steps,
  each fed the masks of the JAX step's key (tests/test_torch_late_fusion.py,
  ``check_alternating_steps``);
- ``eval.validate`` serving an RGB-only PSPNet from ``rgb_normalize_fused``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heatnet_tpu.models import ConfSegnet as JaxConfSegnet
from heatnet_tpu.models import extractors as jx
from heatnet_tpu.models import pspnet as jp
from heatnet_tpu.models.registry import MODELS as JAX_MODELS
from heatnet_tpu.models.registry import build_network as jax_build_network
from heatnet_tpu_torch.eval import validate
from heatnet_tpu_torch.io.from_jax import TRANSPOSE_NAMES, state_dict_from_jax
from heatnet_tpu_torch.models import ConfSegnet, MODELS, build_network, get_model
from heatnet_tpu_torch.models import extractors as tx
from heatnet_tpu_torch.models import pspnet as tp
from heatnet_tpu_torch.models.layers import init_params, prepare_for_inference
from heatnet_tpu_torch.ops import fused_preproc

from test_torch_adversarial import TOL, _batch
from test_torch_late_fusion import (assert_round_trip, assert_stats_close,
                                    check_alternating_steps, japply, jax_dropout_masks,
                                    numpy_init, tiny_ir_teacher)

torch.set_num_threads(2)

BACKENDS = ("squeezenet", "densenet", "resnet18", "resnet34", "resnet50", "resnet101",
            "resnet152")


def _inputs(n=1, h=32, w=32, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, h, w, 3).astype(np.float32) * 2 - 1,
            rng.rand(n, h, w, 1).astype(np.float32) * 2 - 1)


def _pair(backend, late_fusion=False, seed=0):
    """A JAX PSPNet's variables and the port's, on RGB (+ IR in late fusion)."""
    rgb, ir = _inputs()
    ins = (rgb, ir) if late_fusion else (rgb,)
    m_j = jax_build_network(backend, in_channels=4 if late_fusion else 3,
                            late_fusion=late_fusion, dtype=jnp.float32)
    v = numpy_init(m_j, *map(jnp.asarray, ins), seed=seed)
    m_t = build_network(backend, in_channels=4 if late_fusion else 3,
                        late_fusion=late_fusion)
    m_t.load_state_dict(state_dict_from_jax(v["params"], v.get("batch_stats")), strict=True)
    return m_j, v, m_t, ins


def _check_outputs(out_t, out_j, what):
    (seg_t, taps_t, cert_t), (seg_j, taps_j, cert_j) = out_t, out_j
    assert cert_t is None and cert_j is None and seg_t.dtype == torch.float32
    assert len(taps_t) == len(taps_j) == 6
    for i, (t, j) in enumerate(zip(taps_t, taps_j)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL,
                                   err_msg=f"{what} tap {i}")


@pytest.mark.parametrize("backend,late_fusion", [(b, False) for b in BACKENDS]
                         + [("resnet18", True), ("resnet50", True)])
def test_pspnet_eval_matches_jax(backend, late_fusion):
    m_j, v, m_t, ins = _pair(backend, late_fusion)
    with torch.no_grad():
        out_t = m_t.eval()(*map(torch.from_numpy, ins))
    _check_outputs(out_t, japply(m_j, v, *ins), backend)
    want = jx.feature_channels(backend, late_fusion)
    assert [t.shape[-1] for t in out_t[1][1:]] == want == \
        tx.feature_channels(backend, late_fusion)
    assert out_t[0].shape == (1, 32, 32, 13)
    if backend in ("densenet", "squeezenet", "resnet18"):
        assert_round_trip(m_t, v)


@pytest.mark.parametrize("backend", ["resnet34", "resnet101", "resnet152"])
def test_late_fusion_resnet_extractors_have_the_jax_tree(backend):
    """The deep twins' trees: every JAX leaf lands on a port tensor of its
    shape, and back (eval above holds resnet18 and resnet50 numerically)."""
    rgb, ir = _inputs()
    shapes = jax.eval_shape(lambda: jx.make_resnet(backend, late_fusion=True).init(
        jax.random.PRNGKey(0), jnp.asarray(rgb), jnp.asarray(ir)))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), dict(shapes))
    m_t = tx.make_extractor(backend, late_fusion=True, in_channels=4)
    m_t.load_state_dict(state_dict_from_jax(zeros["params"], zeros["batch_stats"]),
                        strict=True)
    assert_round_trip(m_t, zeros)
    assert {"conv1_2.weight", "bn1_2.weight", "layer2_2.block1.conv1.weight"} <= \
        set(m_t.state_dict())


def test_pspnet_train_mode_with_jax_masks_matches_jax():
    m_j, v, m_t, (rgb,) = _pair("resnet18", seed=1)
    rgb = np.concatenate([rgb, _inputs(seed=5)[0]])  # batch 2
    key = jax.random.PRNGKey(3)
    (masks,) = jax_dropout_masks(m_j, v, jnp.asarray(rgb), key=key)
    (seg_j, taps_j, _), new = jax.jit(lambda v, x: m_j.apply(
        v, x, train=True, mutable=["batch_stats"], rngs={"dropout": key}))(
            v, jnp.asarray(rgb))
    assert [tuple(m.shape) for m in masks] == [(2, 1024), (2, 256), (2, 64), (2, 64)]
    with torch.no_grad():
        with pytest.raises(ValueError, match="dropout keep masks"):
            m_t.train()(torch.from_numpy(rgb))
        out_t = m_t.train()(torch.from_numpy(rgb), dropout=masks)
    _check_outputs(out_t, (seg_j, taps_j, None), "train")
    assert_stats_close(m_t, new["batch_stats"])


def test_draw_dropout_and_channel_dropout():
    g = torch.Generator().manual_seed(0)
    masks = tp.draw_dropout(400, g)
    for m, p, c in zip(masks, tp.DROPOUT_RATES, tp.DROPOUT_CHANNELS):
        assert m.dtype == torch.bool and m.shape == (400, c)
        assert abs(float(m.float().mean()) - (1 - p)) < 0.02
    x = torch.randn(2, 4, 3, 5)
    keep = torch.tensor([[True, False, True, True], [False, True, True, False]])
    y = tp.channel_dropout(x, keep, 0.3)
    np.testing.assert_array_equal(y[~keep].numpy(), 0.0)
    np.testing.assert_allclose(y[keep].numpy(), (x[keep] / 0.7).numpy())


# -- ConfSegnet and the adversarial steps ---------------------------------------------

def test_pspnet_conf_segnet_matches_jax_and_its_late_fusion_taps():
    kw = dict(disc_arch="resnet18", num_critics=2, arch="pspnet")
    b = _batch(n=1, seed=3)
    ins = lambda s, f: [f(b[f"rgb_{s}"]), f(b[f"ir_{s}"])]
    m_j = JaxConfSegnet(**kw)
    v = numpy_init(m_j, ins("day", jnp.asarray), ins("day", jnp.asarray))
    m_t = ConfSegnet(**kw)
    m_t.load_state_dict(state_dict_from_jax(v["params"], v["batch_stats"]), strict=True)
    out_j = japply(m_j, v, ins("day", jnp.asarray), ins("night", jnp.asarray))
    with torch.no_grad():
        out_t = m_t.eval()(ins("day", torch.from_numpy), ins("night", torch.from_numpy))
    assert set(out_t) == set(out_j) and out_t["cert_a"] is None
    for k in ("pred_label_a", "pred_label_b", "critics_a", "critics_b", "inter_f_b"):
        pairs = (zip(out_t[k], out_j[k]) if isinstance(out_j[k], list)
                 else [(out_t[k], out_j[k])])
        for i, (t, j) in enumerate(pairs):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL, err_msg=f"{k}[{i}]")
    assert m_t.draw_dropout(1, torch.Generator().manual_seed(0))[0][0].shape == (1, 1024)
    assert ConfSegnet(**kw, structure=(1, 1, 1, 1)).draw_dropout(1, None) is not None

    late = ConfSegnet(disc_arch="cyclegan", num_critics=6, arch="pspnet", late_fusion=True)
    want = jp.pspnet_tap_channels("resnet50", 13, True)
    assert want == tp.pspnet_tap_channels("resnet50", 13, True) == \
        [13, 2048, 1024, 1024, 512, 128]
    assert [getattr(late, f"critics_{i}").conv1.in_channels for i in range(6)] == want
    assert ConfSegnet(arch="custom").draw_dropout(2, None) is None


def test_pspnet_alternating_steps_match_jax():
    """Every step's dropout masks are those of the JAX step's key. lr 1e-6,
    one cyclegan critic on the seg map (64x64). RMSprop's first step moves
    every element by about 10 lr sign(g) whatever the gradient's size, and
    the elements whose f32 gradients straddle 0 (``UPDATE_FLIPS``) move the
    other way on one side: at lr 1e-4 a critic on the 2048-channel tap of a
    random-init train-mode ResNet-50 then moves the next seg step's
    confusion loss by 3 % (measured 6723 against 6926, with the seg and
    night losses equal to 1e-6), and a seg-map critic by 0.5 %. The change
    is proportional to lr; the tap critics are held in eval mode above."""
    check_alternating_steps({"arch": "pspnet"}, *tiny_ir_teacher(64), hw=64,
                            dropout=True, num_critics=1, lr=1e-6)


# -- the registry and serving ----------------------------------------------------------

def test_registry_build_network_and_the_weight_rules():
    assert set(MODELS) == set(JAX_MODELS)
    assert isinstance(get_model("pspnet", backend="squeezenet"), tp.PSPNet)
    for name, call in (("nope", lambda: get_model("nope")),
                       ("vgg", lambda: build_network("vgg"))):
        with pytest.raises(KeyError, match=name):
            call()
    for variant in ("densenet", "squeezenet"):
        with pytest.raises(ValueError, match="no late-fusion variant"):
            tx.make_extractor(variant, late_fusion=True)
    # PReLU's scalar slope becomes nn.PReLU's (1,) weight; up_1/conv ends in
    # "conv", so it is no transposed conv
    sd = state_dict_from_jax({"up_1": {"prelu": {"negative_slope": np.float32(0.2)},
                                       "conv": {"kernel": np.ones((3, 3, 5, 7))}}})
    assert sd["up_1.prelu.weight"].shape == (1,) and sd["up_1.conv.weight"].shape == (7, 5, 3, 3)
    assert not "conv".startswith(TRANSPOSE_NAMES)


def test_validate_serves_rgb_only_pspnet_from_rgb_normalize(monkeypatch):
    model = build_network("squeezenet")
    init_params(model, torch.Generator().manual_seed(0))
    model = prepare_for_inference(model, torch.device("cpu"))
    calls = []
    rgb_only = fused_preproc.rgb_normalize_fused
    monkeypatch.setattr(fused_preproc, "rgb_normalize_fused",
                        lambda x, d: calls.append(x.shape[0]) or rgb_only(x, d))
    rgb = np.random.RandomState(2).randint(0, 256, (3, 32, 48, 3)).astype(np.uint8)
    maps = validate.inference(model, ({"rgb": rgb[i:i + 1]} for i in range(3)),
                              batch_size=2, device="cpu", modalities="rgb")
    assert calls == [2, 2] and maps.shape == (3, 32, 48)
    with torch.no_grad():
        seg = model(fused_preproc.rgb_plain(torch.from_numpy(rgb)))[0]
    np.testing.assert_array_equal(maps, seg.argmax(-1).numpy())
