"""The port's serving artifact against the JAX package's, on the CPU.

``heatnet_tpu_torch.io.export`` and ``cli.export_model`` (``torch.export``
with the kernels as registered ops, ``ops/library.py``) held against
``heatnet_tpu/io/export.py``'s ``platforms=["cpu"]`` artifact, on
``ResNeXtSeg(structure=(1, 1, 1, 1))`` at 32x64 with JAX's weights carried
by ``io/from_jax.py`` (float32 on both sides):

- class maps of the two artifacts on the same uint8/uint16 frames, equal
  except where JAX's own top-2 logits lie within 1e-3 (the repo's parity
  tolerance); one symbolic-batch artifact serves batches 1 and 3;
- the artifact's logits and f32-input mode against the model it was
  exported from (the same operations: bit for bit), a fixed batch, the
  save/load round trip and ``exported_info``;
- ``cli.export_model`` from a port checkpoint, and with ``--quant int8
  --calib-data`` at 320x704 against the in-process int8 model calibrated the
  same way; ``tpu`` in ``--platforms`` refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heatnet_tpu.io import export as jax_export
from heatnet_tpu.models import ResNeXtSeg as JaxResNeXtSeg
from heatnet_tpu.train.state import init_model
from heatnet_tpu_torch.cli import export_model
from heatnet_tpu_torch.data import synthetic
from heatnet_tpu_torch.data.loaders import FreiburgInferDataset
from heatnet_tpu_torch.eval.validate import normalize_frames
from heatnet_tpu_torch.io.export import (export_inference, exported_info, load_exported,
                                         save_exported)
from heatnet_tpu_torch.io.from_jax import state_dict_from_jax
from heatnet_tpu_torch.models import ResNeXtSeg
from heatnet_tpu_torch.models.layers import (Int8GroupedConv, init_params,
                                             prepare_for_inference)
from heatnet_tpu_torch.ops.quant import calibrate_int8, convert_int8, int8_layers

from test_torch_layers import randomize

torch.set_num_threads(2)

HW = (32, 64)
SHAPES = [(1, *HW, 3), (1, *HW, 1)]
RAW = [torch.uint8, torch.uint16]
TINY = ["--structure", "1", "1", "1", "1"]


def _frames(n, seed=0, hw=HW):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (n, *hw, 3)).astype(np.uint8),
            rng.randint(21000, 26000, (n, *hw, 1)).astype(np.uint16))


def _torch(rgb, ir):
    return (torch.from_numpy(rgb),
            torch.from_numpy(ir.view(np.int16)).view(torch.uint16))


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """JAX's weights in both models, JAX's artifact (class maps and
    logits) and the port's symbolic-batch artifact, saved and loaded."""
    base = tmp_path_factory.mktemp("export")
    model_j = JaxResNeXtSeg(structure=(1, 1, 1, 1), input_channels=4, dtype=jnp.float32)
    params, stats = init_model(model_j, jax.random.PRNGKey(3), jnp.zeros((1, *HW, 3)),
                               jnp.zeros((1, *HW, 1)))
    variables = randomize({"params": params, "batch_stats": stats}, seed=11)
    jax_fns = {}
    for argmax in (True, False):
        path = str(base / f"jax_{argmax}.jaxexp")
        jax_export.save_exported(path, jax_export.export_inference(
            model_j, variables, SHAPES, [jnp.uint8, jnp.uint16], platforms=["cpu"],
            normalize=True, argmax=argmax))
        jax_fns[argmax] = jax_export.load_exported(path)

    model = ResNeXtSeg(structure=(1, 1, 1, 1), input_channels=4)
    model.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"]),
                          strict=True)
    prepare_for_inference(model, torch.device("cpu"))
    path = str(base / "port.pt2")
    save_exported(path, export_inference(model, SHAPES, RAW, normalize=True))
    return {"jax": jax_fns, "model": model, "path": path, "serve": load_exported(path),
            "base": base}


@pytest.mark.parametrize("n", [1, 3])
def test_artifact_maps_equal_jax(pair, n):
    rgb, ir = _frames(n, seed=n)
    got = pair["serve"](*_torch(rgb, ir))
    assert got.dtype == torch.int32 and tuple(got.shape) == (n, *HW)
    want = np.asarray(pair["jax"][True](jnp.asarray(rgb), jnp.asarray(ir)))
    logits = np.sort(np.asarray(pair["jax"][False](jnp.asarray(rgb), jnp.asarray(ir))), -1)
    near_tie = logits[..., -1] - logits[..., -2] < 1e-3
    differ = got.numpy() != want
    assert not (differ & ~near_tie).any(), int((differ & ~near_tie).sum())


def test_logits_and_f32_inputs_equal_the_model(pair):
    model = pair["model"]
    rgb, ir = _torch(*_frames(2, seed=5))
    with torch.no_grad():
        x = normalize_frames([rgb, ir], torch.float32)
        want = model(*x)[0]
    logits = export_inference(model, SHAPES, RAW, normalize=True, argmax=False).module()
    assert torch.equal(logits(rgb, ir), want)
    f32 = export_inference(model, [(1, *HW, 4)], argmax=False).module()
    assert torch.equal(f32(x[0]), want)


def test_fixed_batch_serves_only_its_batch(pair):
    model = pair["model"]
    fixed = export_inference(model, [(2, *HW, 3), (2, *HW, 1)], RAW, symbolic_batch=False,
                             normalize=True).module()
    rgb, ir = _torch(*_frames(2, seed=6))
    np.testing.assert_array_equal(fixed(rgb, ir).numpy(), pair["serve"](rgb, ir).numpy())
    with pytest.raises(AssertionError, match="size"):  # the program's guard on its batch
        fixed(*_torch(*_frames(3, seed=6)))


def test_save_load_round_trip_and_info(pair):
    info = exported_info(pair["path"])
    assert info["platforms"] == ["cpu"] and info["fn_name"] == "ServingGraph"
    assert [s.split("[")[0] for s in info["in_avals"]] == ["uint8", "uint16"]
    assert info["in_avals"][0].endswith(",32,64,3]") and info["in_avals"][1].endswith(",32,64,1]")
    batch = info["in_avals"][0][len("uint8["):].split(",")[0]
    assert not batch.isdigit()  # the symbolic batch
    assert info["out_avals"] == [f"int32[{batch},32,64]"] and info["bytes"] > 0
    rgb, ir = _torch(*_frames(3, seed=7))
    before = export_inference(pair["model"], SHAPES, RAW, normalize=True).module()
    assert torch.equal(load_exported(pair["path"])(rgb, ir), before(rgb, ir))


def test_cli_round_trip_from_a_checkpoint(pair, tmp_path, capsys):
    ck = str(tmp_path / "ck.pth")
    src = ResNeXtSeg(structure=(1, 1, 1, 1), input_channels=4)
    init_params(src, torch.Generator().manual_seed(4))
    torch.save({"epoch": 1, "state_dict": src.state_dict()}, ck)
    out = str(tmp_path / "cli.pt2")
    assert export_model.main([*TINY, "--height", "32", "--width", "64", "--resume", ck,
                              "--out", out, "--platforms", "cpu"]) == out
    assert "exported " + out in capsys.readouterr().out
    prepare_for_inference(src, torch.device("cpu"))
    rgb, ir = _torch(*_frames(3, seed=8))
    with torch.no_grad():
        want = src(*normalize_frames([rgb, ir], torch.float32))[0].argmax(-1)
    assert torch.equal(load_exported(out)(rgb, ir), want.to(torch.int32))


def test_cli_refuses_tpu_and_missing_calibration(tmp_path):
    with pytest.raises(SystemExit, match="serves CUDA"):
        export_model.main([*TINY, "--out", str(tmp_path / "x"), "--platforms", "cpu", "tpu"])
    with pytest.raises(SystemExit, match="calib-data"):
        export_model.main([*TINY, "--out", str(tmp_path / "x"), "--platforms", "cpu",
                           "--quant", "int8"])


def test_cli_quant_int8_matches_the_in_process_int8_model(tmp_path):
    """``--quant int8`` at the default 320x704, calibrated on a capture tree
    one frame at a time, against the in-process int8 model calibrated the
    same way. At a symbolic batch the artifact's layers take JAX's rule for
    an exported artifact: int8 at any batch, a grouped conv's volume counted
    at 8 frames. The in-process model takes the same decisions at batch 1
    with ``min_batch`` 1 and the grouped convs' volume threshold divided by
    8 (the volume rule at 8 frames)."""
    cap = synthetic.make_freiburg_infer(str(tmp_path / "cap"), n=2, seed=9)
    out = str(tmp_path / "q.pt2")
    export_model.main([*TINY, "--out", out, "--platforms", "cpu", "--quant", "int8",
                       "--calib-data", cap])
    model = ResNeXtSeg(structure=(1, 1, 1, 1), input_channels=4)
    init_params(model, torch.Generator().manual_seed(0))
    convert_int8(model)
    prepare_for_inference(model, torch.device("cpu"))
    ds = FreiburgInferDataset(cap)
    calibrate_int8(model, [normalize_frames(_torch(ds[i]["rgb"], ds[i]["ir"]), torch.float32)
                           for i in range(len(ds))])
    for _, m in int8_layers(model):
        m.min_batch = 1
        if isinstance(m, Int8GroupedConv):
            m.MIN_WORK_NATIVE = Int8GroupedConv.MIN_WORK_NATIVE // 8
    rgb, ir = _torch(*_frames(1, seed=10, hw=(320, 704)))
    with torch.no_grad():
        want = model(*normalize_frames([rgb, ir], torch.float32))[0].argmax(-1)
    got = load_exported(out)(rgb, ir)
    assert torch.equal(got, want.to(torch.int32))
    native = [n for n, m in int8_layers(model)
              if isinstance(m, Int8GroupedConv) and not m.quantizes(1, 40, 88)]
    assert native == ["mod5_1.block1.conv2"]  # the volume rule at 8 frames
