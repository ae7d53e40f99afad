"""The port's int8 serving mode against the JAX package's, on the CPU.

``ops/quant.py`` (``convert_int8``, ``calibrate_int8``), the int8 layers of
``models/layers.py`` and ``ops/int8_conv.py``'s plain version, held against
``heatnet_tpu``'s ``Int8Conv`` / ``GroupedConvDense`` under
``HEATNET_QUANT=int8`` and its ``calibrate_int8``, in float32:

- single layers on JAX's weights and JAX's calibrated ``x_scale`` (carried by
  ``state_dict_from_jax(quant=)``): equal bit for bit. Quantization,
  rounding (half to even) and the int32 sums are exact in both, and the f32
  dequantisation rounds at the same places.
- calibration of a ResNeXtSeg (1,1,1,1) at a batch below and at
  ``min_batch`` (JAX's ``HEATNET_INT8_MIN_BATCH``, lowered to 2 here): every
  layer's scale within rtol 1e-6 at batch 1. At batch 2 the later layers
  calibrate on the int8 outputs of the earlier ones, in both: the stem's and
  the stages' scales within 1e-6, ASPP's and the decoder's within 1e-2 (see
  the test).
- the model served int8 on JAX's scales: logits within 2e-2 of the largest
  |logit| and class maps equal except where JAX's own top two logits are
  within 2e-2 (BN's f32 arithmetic differs between the frameworks by an ulp,
  which can move a value across a quantization step: one step of an 8-bit
  activation, amplified by the layers after it); int8 against float class
  maps agree on > 0.9 of pixels.
- the batch gate and an uncalibrated model: the float model bit for bit.
- ``cli.inference --quant int8 --device cpu`` on a tiny pack: calibrated on
  the first frame as the JAX CLI calibrates, its maps those of the model
  converted, calibrated and served by hand.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heatnet_tpu.models import ResNeXtSeg as JaxResNeXtSeg
from heatnet_tpu.models.layers import conv as jax_conv
from heatnet_tpu.ops.quant import calibrate_int8 as jax_calibrate
from heatnet_tpu.train.state import init_model
from heatnet_tpu_torch.cli import inference as cli
from heatnet_tpu_torch.data.packed import write_pack
from heatnet_tpu_torch.eval.validate import inference, ingest
from heatnet_tpu_torch.io.from_jax import state_dict_from_jax
from heatnet_tpu_torch.models import ResNeXtSeg
from heatnet_tpu_torch.models import layers as L
from heatnet_tpu_torch.models.layers import prepare_for_inference
from heatnet_tpu_torch.ops import int8_conv
from heatnet_tpu_torch.ops.quant import calibrate_int8, convert_int8, int8_layers

from test_torch_layers import randomize

torch.set_num_threads(2)

HW = (32, 48)
MAX_HW = 1000  # below 32x48: the stem's first conv stays float, as at full size


@pytest.fixture
def int8_env(monkeypatch):
    monkeypatch.setenv("HEATNET_QUANT", "int8")
    monkeypatch.setenv("HEATNET_INT8_MIN_BATCH", "2")
    monkeypatch.setenv("HEATNET_QUANT_MAX_HW", str(MAX_HW))


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flat(v, prefix + (k,))
        else:
            yield ".".join(prefix + (k,)), np.asarray(v)


# (Cin, Cout, kernel, stride, dilation, bias, groups): 1x1, 3x3 stride 2, a
# dilated 3x3 with bias (ASPP's kind), the grouped 3x3 at cpg 2 and 4
LAYERS = [(16, 24, 1, 1, 1, False, 1), (16, 24, 3, 2, 1, False, 1),
          (32, 8, 3, 1, 4, True, 1), (128, 128, 3, 1, 1, False, 64),
          (256, 256, 3, 1, 1, False, 64)]


@pytest.mark.parametrize("cin,cout,k,s,d,bias,groups", LAYERS)
def test_single_layer_equals_jax(int8_env, cin, cout, k, s, d, bias, groups):
    x = np.random.RandomState(cin + k).randn(2, 12, 10, cin).astype(np.float32)
    m = jax_conv(cout, k, stride=s, dilation=d, groups=groups, use_bias=bias,
                 dtype=jnp.float32)
    v = m.init({"params": jax.random.PRNGKey(1)}, jnp.asarray(x))
    v = jax_calibrate(m.apply, v, [(jnp.asarray(x),)])
    want = np.asarray(m.apply(v, jnp.asarray(x)))

    holder = torch.nn.Sequential(L.conv(cin, cout, k, stride=s, dilation=d,
                                        groups=groups, use_bias=bias))
    convert_int8(holder, min_batch=2).eval()
    sd = state_dict_from_jax(v["params"], quant=v["quant"])
    holder.load_state_dict({"0." + k_: t for k_, t in sd.items()}, strict=True)
    assert float(holder[0].x_scale) > 0
    with torch.no_grad():
        got = holder(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), want)


def _jax_model(seed=3):
    model_j = JaxResNeXtSeg(structure=(1, 1, 1, 1), input_channels=4, dtype=jnp.float32)
    params, stats = init_model(model_j, jax.random.PRNGKey(seed),
                               jnp.zeros((1, *HW, 3)), jnp.zeros((1, *HW, 1)))
    return model_j, randomize({"params": params, "batch_stats": stats}, seed=11)


def _inputs(n, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, *HW, 3).astype(np.float32) * 2 - 1,
            rng.rand(n, *HW, 1).astype(np.float32) * 2 - 1)


def _port(variables, quant=True, **kw):
    m = ResNeXtSeg(structure=(1, 1, 1, 1), input_channels=4)
    m.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"]),
                      strict=True)
    if quant:
        convert_int8(m, **kw)
    return m.eval()


@pytest.fixture(scope="module")
def jax_pair():
    """The flax model under int8, randomised float variables, JAX's scales
    calibrated at batch 1 and 2, and its int8 logits on another batch."""
    mp = pytest.MonkeyPatch()
    for k, v in (("HEATNET_QUANT", "int8"), ("HEATNET_INT8_MIN_BATCH", "2"),
                 ("HEATNET_QUANT_MAX_HW", str(MAX_HW))):
        mp.setenv(k, v)
    try:
        model_j, variables = _jax_model()
        scales = {}
        for n in (1, 2):
            rgb, ir = _inputs(n)
            v = jax_calibrate(model_j.apply, variables,
                              [(jnp.asarray(rgb), jnp.asarray(ir))], train=False)
            scales[n] = v["quant"]
        rgb, ir = _inputs(2, seed=2)
        v = dict(variables, quant=scales[1])
        seg_q = np.asarray(model_j.apply(v, jnp.asarray(rgb), jnp.asarray(ir),
                                         train=False)[0])
        yield model_j, variables, scales, seg_q
    finally:
        mp.undo()


@pytest.mark.parametrize("n", [1, 2], ids=["below_min_batch", "at_min_batch"])
def test_calibration_matches_jax(jax_pair, n):
    _, variables, scales, _ = jax_pair
    model = _port(variables, min_batch=2, max_hw=MAX_HW)
    rgb, ir = _inputs(n)
    calibrate_int8(model, [(torch.from_numpy(rgb), torch.from_numpy(ir))])
    want = dict(_flat(scales[n]))
    got = {name + ".x_scale": float(m.x_scale) for name, m in int8_layers(model)}
    # the stem's first conv sees 32x48 > MAX_HW pixels: float, no scale in either
    assert set(got) - set(want) == {"mod1.conv1.x_scale"}
    assert got["mod1.conv1.x_scale"] == 0.0
    assert set(want) <= set(got) and len(want) == 29
    for k, v in want.items():
        # at batch 2 the int8 outputs feed the later layers' calibration: an
        # f32 ulp (a float conv's summation order, BN's arithmetic) that moves
        # one value across a rounding step moves ASPP's and the decoder's
        # scales by up to 2.8e-3 here; the 18 scales of the stem and the
        # stages stay within 1e-6 (calibrating them on float outputs, the
        # other order, moves 17 of them by 4.6e-5 to 1.8e-2)
        rtol = 1e-2 if n == 2 and not k.startswith("mod") else 1e-6
        np.testing.assert_allclose(got[k], float(v), rtol=rtol, err_msg=k)


def test_model_served_int8_on_jax_scales(jax_pair):
    model_j, variables, scales, seg_j = jax_pair
    model = _port(variables, min_batch=2, max_hw=MAX_HW)
    missing, unexpected = model.load_state_dict(state_dict_from_jax(
        variables["params"], variables["batch_stats"], quant=scales[1]), strict=False)
    assert missing == ["mod1.conv1.x_scale"] and not unexpected  # float in both
    rgb, ir = _inputs(2, seed=2)
    with torch.no_grad():
        seg = model(torch.from_numpy(rgb), torch.from_numpy(ir))[0].numpy()
    tol = 2e-2 * np.abs(seg_j).max()
    assert np.abs(seg - seg_j).max() <= tol
    top2 = np.sort(seg_j, -1)[..., -2:]
    tie = (top2[..., 1] - top2[..., 0]) <= tol
    assert np.array_equal(seg.argmax(-1)[~tie], seg_j.argmax(-1)[~tie])
    assert (seg.argmax(-1) != seg_j.argmax(-1)).mean() < 0.01  # 0.2 % measured
    with torch.no_grad():
        seg_f = _port(variables, quant=False)(torch.from_numpy(rgb),
                                              torch.from_numpy(ir))[0].numpy()
    assert (seg.argmax(-1) == seg_f.argmax(-1)).mean() > 0.9


def test_batch_gate_and_uncalibrated_serve_the_float_model(jax_pair):
    _, variables, _, _ = jax_pair
    float_model = _port(variables, quant=False)
    rgb, ir = (torch.from_numpy(a) for a in _inputs(2, seed=4))
    with torch.no_grad():
        want = float_model(rgb, ir)[0]
        gated = _port(variables, min_batch=3)
        calibrate_int8(gated, [(rgb, ir)])
        assert all(float(m.x_scale) > 0 for _, m in int8_layers(gated))
        assert torch.equal(gated(rgb, ir)[0], want)  # batch 2 < min_batch 3
        assert torch.equal(_port(variables, min_batch=2)(rgb, ir)[0], want)  # x_scale 0
        served = _port(variables, min_batch=2)
        calibrate_int8(served, [(rgb, ir)])
        assert not torch.equal(served(rgb, ir)[0], want)
    with pytest.raises(ValueError, match="no batches"):
        calibrate_int8(served, [])
    with pytest.raises(ValueError, match="no int8 layers"):
        calibrate_int8(float_model, [(rgb, ir)])


def test_cli_quant_int8_serves_the_calibrated_model(jax_pair, tmp_path, capsys,
                                                    monkeypatch):
    """8 frames at batch 8, calibrated on the first frame at batch 1 (on
    float outputs, as the JAX CLI calibrates), default min_batch 8 and
    max_hw: the maps of the same model converted, calibrated and served by
    hand, with the int8 layers run (the plain version on the CPU)."""
    _, variables, _, _ = jax_pair
    rng = np.random.RandomState(5)
    rgb = rng.randint(0, 256, (8, *HW, 3)).astype(np.uint8)
    ir = rng.randint(21000, 26000, (8, *HW, 1)).astype(np.uint16)
    write_pack(str(tmp_path / "pack"), rgb, ir)
    ckpt = tmp_path / "weights.pt"
    torch.save(state_dict_from_jax(variables["params"], variables["batch_stats"]), ckpt)
    calls = []
    plain = int8_conv.int8_conv2d_plain
    monkeypatch.setattr(int8_conv, "int8_conv2d_plain",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    run = cli.main(["--data", str(tmp_path / "pack"), "--device", "cpu", "--resume",
                    str(ckpt), "--batch", "8", "--iters", "1", "--quant", "int8",
                    "--structure", "1", "1", "1", "1"])
    assert "Ran inference on 8 frames" in capsys.readouterr().out
    assert len(calls) == 30  # one batch-8 forward's int8 layers; none at batch 1

    model = prepare_for_inference(_port(variables), torch.device("cpu"))
    first = {"rgb": rgb[:1], "ir": ir[:1]}
    calibrate_int8(model, [ingest(first, "ir_rgb", torch.device("cpu"), torch.float32)])
    maps = inference(model, ({"rgb": rgb[i:i + 1], "ir": ir[i:i + 1]} for i in range(8)),
                     8, torch.device("cpu"), "ir_rgb")
    np.testing.assert_array_equal(run.maps, maps)


@pytest.mark.parametrize("which", ["late_fusion", "vistas_stem", "resnext101", "pspnet"])
def test_convert_int8_quantizes_what_reaches_conv_in_jax(which, monkeypatch):
    """The layers ``convert_int8`` makes int8 are exactly those whose JAX
    counterparts register a ``quant`` scale under ``HEATNET_QUANT=int8``
    (``jax.eval_shape`` of the init: no compute): every ``conv()`` layer,
    grouped ones included; PSPNet's head (``nn.Conv``) stays float."""
    from heatnet_tpu.models.registry import build_network as jax_build_network
    from heatnet_tpu_torch.models import build_network

    monkeypatch.setenv("HEATNET_QUANT", "int8")
    monkeypatch.delenv("HEATNET_QUANT_MAX_HW", raising=False)  # the defaults, as
    monkeypatch.delenv("HEATNET_INT8_MIN_BATCH", raising=False)  # convert_int8's
    x = jnp.zeros((1, 32, 48, 3))
    ir = jnp.zeros((1, 32, 48, 1))
    if which == "pspnet":
        model_j, args = jax_build_network("resnet18", in_channels=3), (x,)
        model_t = build_network("resnet18", in_channels=3)
    else:
        kw = {"late_fusion": dict(late_fusion=True), "vistas_stem": dict(input_3x3=False),
              "resnext101": dict(structure=(1, 1, 23, 1))}[which]
        n_in = 3 if which == "vistas_stem" else 4
        model_j = JaxResNeXtSeg(input_channels=n_in, **{"structure": (1, 1, 1, 1), **kw})
        model_t = ResNeXtSeg(input_channels=n_in, **{"structure": (1, 1, 1, 1), **kw})
        args = (x,) if which == "vistas_stem" else (x, ir)
    shapes = jax.eval_shape(lambda: model_j.init(jax.random.PRNGKey(0), *args))
    want = {k[:-len(".x_scale")] for k, _ in _flat(shapes["quant"])}
    convert_int8(model_t)
    got = {name for name, _ in int8_layers(model_t)}
    assert got == want and len(got) > 10
    if which == "pspnet":
        assert isinstance(model_t.psp.bottleneck, L.Conv2d)
        assert not isinstance(model_t.psp.bottleneck, L.Int8Conv2d)
