"""The harness tools in the port against JAX's: run_demo, eval_hotnet, dataset_qa, the registry.

On the CPU, float32 (the JAX tools build their segnet in bf16 and shard
over the 8-device test mesh; both are patched off here, as
tests/test_torch_eval.py does), weights from numpy with fixed seeds, each
tool given JAX's orbax checkpoint and the port's conversion of it
(``state_dict_from_jax``):

- ``cli.run_demo``: the ``_pred.png`` files of MFNet decode to JAX's
  pixels, except where JAX's own top two logits lie within 1e-3;
- ``cli.eval_hotnet``: the night and day IoU vectors and the combined mIoU
  of a run directory (config.json and a ``trgb_segnet.``-prefixed
  ``checkpoint_best.pth``) equal JAX's within 1e-9, on Freiburg trees at the
  source size 320x960 (the loaders' identity resize); an orbax
  ``checkpoint_best/`` directory raises and names the converter;
- ``cli.dataset_qa``: ``freiburg`` and ``mfnet`` return the mean IoU of
  their own forward's class maps within 1e-9, and those maps equal JAX's
  except where JAX's own top two logits lie within 1e-3 (where none
  differs, the printed IoU lines are JAX's); ``stats`` prints JAX's
  histograms;
- ``get_model`` builds every name of the JAX registry, as the class of the
  same name.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heatnet_tpu.models as jax_models
import heatnet_tpu.parallel.mesh as jax_mesh
from heatnet_tpu.cli import dataset_qa as jax_qa
from heatnet_tpu.cli import eval_hotnet as jax_hotnet
from heatnet_tpu.cli import run_demo as jax_demo
from heatnet_tpu.data import synthetic
from heatnet_tpu.eval import validate as jax_validate
from heatnet_tpu.eval.validate import _device_normalize
from heatnet_tpu.io.checkpoint import save_checkpoint as jax_save_checkpoint
from heatnet_tpu.models.registry import MODELS as JAX_MODELS
from heatnet_tpu.models.registry import get_model as jax_get_model
from heatnet_tpu_torch.cli import dataset_qa, eval_hotnet, run_demo
from heatnet_tpu_torch.data import loaders
from heatnet_tpu_torch.data.mappings import HEATNET_TO_MFNET, mapping_to_lut
from heatnet_tpu_torch.data.png import read_png, write_png
from heatnet_tpu_torch.eval import validate
from heatnet_tpu_torch.io.checkpoint import save_checkpoint
from heatnet_tpu_torch.io.from_jax import state_dict_from_jax
from heatnet_tpu_torch.models import MFNet, ResNeXtSeg, get_model
from heatnet_tpu_torch.models.layers import prepare_for_inference
from heatnet_tpu_torch.ops.iou import iou_counts, ious_from_counts

from test_torch_late_fusion import numpy_init

torch.set_num_threads(2)

TINY = (1, 1, 1, 1)


@pytest.fixture
def f32_jax(monkeypatch):
    """The JAX tools' segnet in float32, evaluated at batch 1 without a mesh."""
    real = jax_models.ResNeXtSeg
    monkeypatch.setattr(jax_models, "ResNeXtSeg",
                        lambda *a, **kw: real(*a, **{**kw, "dtype": jnp.float32}))
    monkeypatch.setattr(jax_mesh, "create_mesh", lambda *a, **kw: None)
    monkeypatch.setenv("HEATNET_EVAL_BATCH", "1")


@pytest.fixture(scope="module")
def segnet():
    """A ResNeXtSeg (1,1,1,1) early-fusion segnet's flax variables and the
    port's state_dict of them."""
    m_j = jax_models.ResNeXtSeg(structure=TINY, input_channels=4, dtype=jnp.float32)
    v = numpy_init(m_j, jnp.zeros((1, 64, 96, 3)), jnp.zeros((1, 64, 96, 1)), seed=8)
    return v, state_dict_from_jax(v["params"], v["batch_stats"])


@pytest.fixture(scope="module")
def fr_trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("fr")
    return (synthetic.make_freiburg_test(str(base / "day"), n=1, hw=(320, 960), seed=4),
            synthetic.make_freiburg_test(str(base / "night"), n=1, hw=(320, 960), seed=5))


def _recording(fn, seen):
    def run(*a, **kw):
        ious = fn(*a, **kw)
        seen.append(np.asarray(ious))
        return ious
    return run


def test_eval_hotnet_matches_jax(segnet, fr_trees, f32_jax, tmp_path, monkeypatch):
    v, sd = segnet
    day, night = fr_trees
    cfg = {"modalities": "ir_rgb", "arch": "custom", "structure": list(TINY),
           "cert_branch": False, "late_fusion": False}
    jax_run, port_run = tmp_path / "jax" / "run_a", tmp_path / "port" / "run_a"
    for d in (jax_run, port_run):
        d.mkdir(parents=True)
        (d / "config.json").write_text(json.dumps(cfg))
    jax_save_checkpoint({"state_dict": {"params": {"trgb_segnet": v["params"]},
                                        "batch_stats": {"trgb_segnet": v["batch_stats"]}}},
                        str(jax_run / "checkpoint_best"))
    save_checkpoint({"epoch": 1, "state_dict": {"trgb_segnet." + k: t for k, t in sd.items()}},
                    str(port_run / "checkpoint_best.pth"))
    seen_j, seen_t = [], []
    monkeypatch.setattr(jax_validate, "validate_model",
                        _recording(jax_validate.validate_model, seen_j))
    monkeypatch.setattr(eval_hotnet, "validate_model",
                        _recording(eval_hotnet.validate_model, seen_t))
    argv = ["--testroot_day", day, "--testroot_night", night]
    want = jax_hotnet.main(["--runs", str(jax_run), *argv,
                            "--log_dir", str(tmp_path / "jax_logs")])
    got = eval_hotnet.main(["--runs", str(port_run), *argv, "--device", "cpu",
                            "--log_dir", str(tmp_path / "logs")])
    assert sorted(got) == sorted(want) == ["run_a"]
    assert got["run_a"] == pytest.approx(want["run_a"], abs=1e-9)
    assert len(seen_t) == len(seen_j) == 2  # night, then day
    for a, b in zip(seen_t, seen_j):
        assert a.shape == (12,)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)

    # a bare segnet state_dict loads too; a JAX run directory raises
    save_checkpoint({"state_dict": sd}, str(port_run / "checkpoint_best.pth"))
    assert eval_hotnet.main(["--runs", str(port_run), *argv, "--device", "cpu",
                             "--log_dir", str(tmp_path / "logs")]) == got
    with pytest.raises(ValueError, match="from_jax.py::state_dict_from_jax"):
        eval_hotnet.main(["--runs", str(jax_run), *argv, "--device", "cpu",
                          "--log_dir", str(tmp_path / "logs")])


def _qa_lines(text):
    return [line for line in text.splitlines() if line.startswith(("IoU ", "mean IoU"))]


def _maps_and_ious(v, sd, cmd, data, split):
    """JAX's and the port's class maps of the tree (the validators' forwards:
    JAX ``apply`` on ``_device_normalize``d frames, the port's ``predict``),
    where JAX's top two logits lie within 1e-3, and the IoU vector each
    side's maps give (one IoU function for both)."""
    m_j = jax_models.ResNeXtSeg(structure=TINY, input_channels=4, dtype=jnp.float32)
    m_t = ResNeXtSeg(structure=TINY, input_channels=4)
    m_t.load_state_dict(sd)
    prepare_for_inference(m_t, torch.device("cpu"))  # channels_last, as the tool's
    if cmd == "freiburg":
        ds, lut = loaders.FreiburgThermalTestDataset(*loaders.get_test_paths([data])), None
    else:
        ds = loaders.MFNetDataset(data, split=split)
        lut = torch.as_tensor(mapping_to_lut(HEATNET_TO_MFNET, num_src=14, default=0))
    apply = jax.jit(lambda v, *x: m_j.apply(v, *x, train=False)[0])
    out = {"jax": [], "port": [], "tied": [], "label": []}
    for i in range(len(ds)):
        item = ds[i]
        seg = np.asarray(apply(v, *[_device_normalize(jnp.asarray(item[k]))
                                    for k in ("rgb", "ir")]))
        top2 = np.sort(seg, axis=-1)[..., -2:]
        out["jax"].append(torch.from_numpy(seg.argmax(-1)))
        out["port"].append(validate.predict(m_t, item, "ir_rgb", torch.device("cpu")).long())
        out["tied"].append(top2[..., 1] - top2[..., 0] < 1e-3)
        out["label"].append(torch.from_numpy(item["label"]))
    label = torch.cat(out["label"])
    ious = {}
    for side in ("jax", "port"):
        pred = torch.cat(out[side])
        ious[side] = ious_from_counts(*[c.numpy() for c in iou_counts(
            pred if lut is None else lut[pred], label)])
    return torch.cat(out["jax"]).numpy(), torch.cat(out["port"]).numpy(), \
        np.concatenate(out["tied"]), ious


@pytest.mark.parametrize("cmd", ["freiburg", "mfnet"])
def test_dataset_qa_matches_jax(cmd, segnet, fr_trees, f32_jax, tmp_path, capsys):
    """Each tool's IoUs are those its own forward's maps give, exactly; the
    two forwards' maps are equal except at JAX's near-ties (on the MFNet
    tree, 480x640 after the loader's resize, a few pixels flip there)."""
    v, sd = segnet
    jax_save_checkpoint({"state_dict": {"params": {"trgb_segnet": v["params"]},
                                        "batch_stats": {"trgb_segnet": v["batch_stats"]}}},
                        str(tmp_path / "jax_ck"))
    save_checkpoint({"epoch": 1, "state_dict": {"trgb_segnet." + k: t for k, t in sd.items()}},
                    str(tmp_path / "port_ck.pth"))
    if cmd == "freiburg":
        data, split = fr_trees[1], "night"
    else:
        data = synthetic.make_mfnet(str(tmp_path / "mf"), n_train=0, n_test=1, seed=7)
        split = "day"
    argv = [cmd, "--data", data, "--split", split, "--structure", *map(str, TINY)]
    want = jax_qa.main(argv + ["--checkpoint", str(tmp_path / "jax_ck")])
    jax_out = capsys.readouterr().out
    got = dataset_qa.main(argv + ["--checkpoint", str(tmp_path / "port_ck.pth"),
                                  "--device", "cpu"])
    out = capsys.readouterr().out
    map_j, map_t, tied, ious = _maps_and_ious(v, sd, cmd, data, split)
    assert not np.any((map_j != map_t) & ~tied)
    assert want == pytest.approx(float(np.nanmean(ious["jax"])), abs=1e-9, nan_ok=True)
    assert got == pytest.approx(float(np.nanmean(ious["port"])), abs=1e-9, nan_ok=True)
    assert len(_qa_lines(out)) == len(_qa_lines(jax_out)) >= 6
    if np.array_equal(map_j, map_t):
        assert got == pytest.approx(want, abs=1e-9, nan_ok=True)
        assert _qa_lines(out) == _qa_lines(jax_out)


def test_dataset_qa_stats_prints_jax_histograms(fr_trees, tmp_path, capsys):
    train = synthetic.make_freiburg_train(str(tmp_path / "train"), n_day=2, n_night=1)
    argv = ["stats", "--train-root", train, "--test-day", fr_trees[0],
            "--test-night", fr_trees[1]]
    want = jax_qa.main(argv)
    jax_out = capsys.readouterr().out
    got = dataset_qa.main(argv)
    assert got == want > 0
    assert capsys.readouterr().out == jax_out


def test_run_demo_writes_jax_pngs(tmp_path):
    v = numpy_init(jax_models.MFNet(n_class=9), jnp.zeros((1, 64, 96, 4)), seed=9,
                   train=True)
    rng = np.random.RandomState(3)
    images = rng.randint(0, 256, (3, 64, 96, 4)).astype(np.uint8)
    for side in ("jax", "port"):
        os.makedirs(tmp_path / side / "image")
        os.makedirs(tmp_path / side / "weights" / "MFNet")
        for i, img in enumerate(images):
            write_png(str(tmp_path / side / "image" / f"frame{i}.png"), img)
    jax_save_checkpoint({"epoch": 1, "state_dict": v},
                        str(tmp_path / "jax" / "weights" / "MFNet" / "final"))
    save_checkpoint({"epoch": 1, "state_dict": state_dict_from_jax(
        v["params"], v["batch_stats"], target=MFNet())},
        str(tmp_path / "port" / "weights" / "MFNet" / "tmp"))
    want = jax_demo.main(["--image_dir", str(tmp_path / "jax" / "image"),
                          "--model_dir", str(tmp_path / "jax" / "weights")])
    got = run_demo.main(["--image_dir", str(tmp_path / "port" / "image"),
                         "--model_dir", str(tmp_path / "port" / "weights"),
                         "--device", "cpu"])
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want] == \
        [f"frame{i}_pred.png" for i in range(3)]
    seg = np.asarray(jax_models.MFNet(n_class=9).apply(
        v, jnp.asarray(images.astype(np.float32) / 255.0), train=False))
    top2 = np.sort(seg, axis=-1)[..., -2:]
    tied = top2[..., 1] - top2[..., 0] < 1e-3
    for i, (a, b) in enumerate(zip(got, want)):
        pa, pb = read_png(a), read_png(b)
        assert pa.shape == pb.shape == (64, 96, 3) and pa.dtype == np.uint8
        assert not np.any((pa != pb).any(-1) & ~tied[i]), i
    assert (read_png(got[0]) != 0).any()


def test_get_model_builds_every_jax_name():
    kwargs = {"cyclegan_generator": {"output_nc": 1, "n_residual_blocks": 1},
              "unet_adapter": {"n_classes": 4}, "unet_seg": {"n_classes": 2},
              "pspnet": {"backend": "squeezenet"}, "mfnet": {"n_class": 9}}
    for name in JAX_MODELS:
        kw = kwargs.get(name, {})
        ours, theirs = get_model(name, **kw), jax_get_model(name, **kw)
        assert isinstance(ours, torch.nn.Module)
        assert type(ours).__name__ == type(theirs).__name__, name
    assert isinstance(get_model("net_resnext50"), ResNeXtSeg)
    assert get_model("unet_adapter", n_classes=4).inc.conv1.in_channels == 4
    assert get_model("cyclegan_discriminator").conv1.in_channels == 1
    with pytest.raises(KeyError, match="available"):
        get_model("nope")
