"""The port's evaluation against the JAX package: counts, validators, CLI modes.

- ``ops.iou.iou_counts``/``ious_from_counts`` equal JAX's exactly on seeded
  maps whose padded tail is labelled ignore.
- ``validate_model`` (uint8/uint16 frames through the ingest's plain
  version), ``validate_model_mfnet`` and ``validate_model_bdd`` (float frames)
  on the weights of a randomised flax ResNeXtSeg (1,1,1,1), carried over with
  ``state_dict_from_jax``: the class maps equal JAX's except where JAX's own
  top two logits lie within 1e-3 (no near-tied pixel flips at these seeds),
  so the IoU vectors agree to 1e-9 and the logged keys and values are JAX's. Batch 4 equals a
  frame-by-frame pass.
- ``cli.train_conf --eval FR_day --device cpu`` prints JAX ``main``'s IoU
  vector on a 960x320 tree (the loaders' identity resize) and the weights
  JAX's main evaluated; ``--infer``/``--im_save_dir`` and ``cli.inference``
  on a capture tree write ``pred_<i>.png`` that decode to the palette-coded
  class maps.
- The trainer's logged averages take the log points' losses only, as JAX's.
- A periodic eval between two steps leaves the next step's losses and every
  parameter bit-equal to a run without it, and writes ``_best.pth``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heatnet_tpu.models as jax_models
from heatnet_tpu.data import synthetic
from heatnet_tpu.eval import validate as jax_validate
from heatnet_tpu.eval.validate import _device_normalize
from heatnet_tpu.io.logging import RunLogger as JaxRunLogger
from heatnet_tpu.ops import iou as jax_iou
from heatnet_tpu.train.state import init_model as jax_init_model
from heatnet_tpu_torch.cli import inference as cli_inference
from heatnet_tpu_torch.cli import train_conf
from heatnet_tpu_torch.data.loaders import FreiburgInferDataset
from heatnet_tpu_torch.data.packed import write_train_pack
from heatnet_tpu_torch.data.png import read_png
from heatnet_tpu_torch.eval import validate
from heatnet_tpu_torch.io.checkpoint import save_checkpoint
from heatnet_tpu_torch.io.from_jax import state_dict_from_jax
from heatnet_tpu_torch.io.logging import RunLogger
from heatnet_tpu_torch.models import ResNeXtSeg
from heatnet_tpu_torch.ops.iou import iou_counts, ious_from_counts
from heatnet_tpu_torch.utils.vis import color_code_labels

from test_torch_layers import randomize

torch.set_num_threads(2)

H, W, N = 64, 96, 5
CPU = torch.device("cpu")
TINY = ["--structure", "1", "1", "1", "1"]


def test_iou_counts_and_ious_equal_jax():
    rng = np.random.RandomState(0)
    pred = rng.randint(0, 14, (3, 32, 48)).astype(np.int32)
    target = rng.randint(0, 14, (3, 32, 48)).astype(np.int32)
    target[2] = 13  # a padded tail: ignored
    got = [t.numpy() for t in iou_counts(torch.from_numpy(pred), torch.from_numpy(target))]
    want = [np.asarray(c) for c in jax_iou.iou_counts(jnp.asarray(pred), jnp.asarray(target))]
    for g, w in zip(got, want):
        assert g.dtype == np.int64 and g.shape == (13,)
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(ious_from_counts(*got), jax_iou.ious_from_counts(*want))
    assert ious_from_counts(*got).dtype == np.float64


def _port(variables, in_ch):
    model_t = ResNeXtSeg(structure=(1, 1, 1, 1), input_channels=in_ch)
    model_t.load_state_dict(state_dict_from_jax(variables["params"],
                                                variables["batch_stats"]), strict=True)
    return model_t.eval()


@pytest.fixture(scope="module")
def fusion():
    model_j = jax_models.ResNeXtSeg(structure=(1, 1, 1, 1), input_channels=4,
                                    dtype=jnp.float32)
    params, stats = jax_init_model(model_j, jax.random.PRNGKey(4), jnp.zeros((1, H, W, 3)),
                                   jnp.zeros((1, H, W, 1)))
    variables = randomize({"params": params, "batch_stats": stats}, seed=4)
    return model_j, variables, _port(variables, 4)


@pytest.fixture(scope="module")
def rgb_only(fusion):
    """The RGB-only segnet: the same tree but the stem's input channels."""
    variables = jax.tree_util.tree_map(lambda a: a, fusion[1])
    conv1 = variables["params"]["mod1"]["conv1"]
    conv1["kernel"] = conv1["kernel"][:, :, :3]
    model_j = jax_models.ResNeXtSeg(structure=(1, 1, 1, 1), input_channels=3,
                                    dtype=jnp.float32)
    return model_j, variables, _port(variables, 3)


def _items(kind, n=N, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        if kind == "fr":
            item = {"rgb": rng.randint(0, 256, (1, H, W, 3)).astype(np.uint8),
                    "ir": rng.randint(21000, 26000, (1, H, W, 1)).astype(np.uint16),
                    "label": rng.randint(0, 14, (1, H, W)).astype(np.int32)}
        else:
            item = {"rgb": rng.uniform(-1, 1, (1, H, W, 3)).astype(np.float32),
                    "label": rng.randint(0, 19 if kind == "bdd" else 9,
                                         (1, H, W)).astype(np.int32)}
            if kind == "mf":
                item["ir"] = rng.uniform(-1, 1, (1, H, W, 1)).astype(np.float32)
            else:
                item["label"][0, :2] = 255
        out.append(item)
    return out


def _assert_maps_match(model_j, variables, model_t, items, modalities):
    """Port class maps equal JAX's except at JAX's near-ties; returns the
    number of pixels that differ."""
    ins = [k for k in ("rgb", "ir") if k in modalities]
    batch = {k: np.concatenate([it[k] for it in items]) for k in ins}
    apply = jax.jit(lambda v, *x: model_j.apply(v, *x, train=False)[0])
    seg = apply(variables, *[_device_normalize(jnp.asarray(batch[k])) for k in ins])
    seg = np.asarray(seg)
    ours = validate.predict(model_t, batch, modalities, CPU).numpy()
    top2 = np.sort(seg, axis=-1)[..., -2:]
    tied = top2[..., 1] - top2[..., 0] < 1e-3
    differ = ours != seg.argmax(-1)
    assert not np.any(differ & ~tied)
    return int(differ.sum())


def _logged(logger):
    logger.finish()
    return {k: v for line in open(logger.path) for k, v in json.loads(line).items()
            if not k.startswith("_")}


@pytest.mark.parametrize("kind", ["fr", "mf", "bdd"])
def test_validators_match_jax(fusion, rgb_only, kind, tmp_path):
    model_j, variables, model_t = rgb_only if kind == "bdd" else fusion
    items = _items(kind, seed={"fr": 0, "mf": 1, "bdd": 2}[kind])
    modalities = "rgb" if kind == "bdd" else "ir_rgb"
    assert _assert_maps_match(model_j, variables, model_t, items, modalities) == 0
    log_j = JaxRunLogger("jax", log_dir=str(tmp_path / "jax"))
    log_t = RunLogger("port", log_dir=str(tmp_path / "port"))
    if kind == "fr":
        want = jax_validate.validate_model(model_j, variables, items, modalities,
                                           mode="night", logger=log_j, batch_size=4)
        got = validate.validate_model(model_t, items, modalities, mode="night",
                                      logger=log_t, batch_size=4, device="cpu")
    elif kind == "mf":
        want = jax_validate.validate_model_mfnet(model_j, variables, items, modalities,
                                                 logger=log_j, batch_size=4)
        got = validate.validate_model_mfnet(model_t, items, modalities, logger=log_t,
                                            batch_size=4, device="cpu")
    else:
        want = jax_validate.validate_model_bdd(model_j, variables, items, logger=log_j,
                                               batch_size=4)
        got = validate.validate_model_bdd(model_t, items, logger=log_t, batch_size=4,
                                          device="cpu")
    assert got.shape == (12,) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    logged_j, logged_t = _logged(log_j), _logged(log_t)
    assert sorted(logged_t) == sorted(logged_j)
    for k, v in logged_j.items():
        assert logged_t[k] == pytest.approx(v, abs=1e-9, nan_ok=True), k


@pytest.mark.parametrize("kind,batch", [("fr", 4), ("bdd", 2)])
def test_batched_ious_equal_a_frame_by_frame_pass(fusion, rgb_only, kind, batch):
    model_t = (rgb_only if kind == "bdd" else fusion)[2]
    run = (validate.validate_model_bdd if kind == "bdd" else
           lambda m, f, **kw: validate.validate_model(m, f, "ir_rgb", **kw))
    items = _items(kind, n=5 if kind == "fr" else 3, seed=3)
    per_frame = run(model_t, items, batch_size=1, device="cpu")
    batched = run(model_t, items, batch_size=batch, device="cpu")
    np.testing.assert_array_equal(per_frame, batched)
    # the padded tail's labels are the ignore value of the label space
    pads = list(validate.batched(iter(items[:3]), 4, pad_label=255 if kind == "bdd" else 13))
    assert pads[0][1] == 3 and np.all(pads[0][0]["label"][3] == (255 if kind == "bdd" else 13))


def test_train_conf_eval_prints_jax_ious(tmp_path, monkeypatch, capsys):
    """One 960x320 frame; both sides evaluate it in f32 at batch 1 with the
    segnet weights JAX's main initialised (the JAX main evaluates in bf16
    unless its ResNeXtSeg is built in f32, and over the 8-device test mesh
    unless it gets none, as here)."""
    import heatnet_tpu.parallel.mesh as jax_mesh

    root = synthetic.make_freiburg_test(str(tmp_path / "day"), n=1, hw=(320, 960), seed=4)
    monkeypatch.setenv("HEATNET_EVAL_BATCH", "1")
    monkeypatch.setattr(jax_mesh, "create_mesh", lambda *a, **kw: None)
    real_segnet = jax_models.ResNeXtSeg
    monkeypatch.setattr(jax_models, "ResNeXtSeg",
                        lambda *a, **kw: real_segnet(*a, **{**kw, "dtype": jnp.float32}))
    seen = {}
    real_validate = jax_validate.validate_model

    def recording(model, variables, frames, *a, **kw):
        seen["variables"] = variables
        return real_validate(model, variables, frames, *a, **kw)

    monkeypatch.setattr(jax_validate, "validate_model", recording)
    from heatnet_tpu.cli.train_conf import main as jax_main

    argv = ["--eval", "FR_day", "--testroot_day", root, *TINY, "--num_critics", "1",
            "--discarch", "resnet18", "--crop_height", "64", "--crop_width", "64"]
    want = jax_main(argv + ["--log_dir", str(tmp_path / "jax_runs")])
    jax_out = capsys.readouterr().out

    v = seen["variables"]
    sd = state_dict_from_jax(v["params"], v["batch_stats"])
    ck = save_checkpoint({"epoch": 0, "state_dict": {"trgb_segnet." + k: t
                                                     for k, t in sd.items()}},
                         str(tmp_path / "segnet.pth"))
    got = train_conf.main(argv + ["--device", "cpu", "--resume", ck,
                                  "--log_dir", str(tmp_path / "runs")])
    out = capsys.readouterr().out
    assert "Eval successfull!" in out and "Starting evaluation on: FR_day" in out
    assert got == pytest.approx(want, abs=1e-9)
    # the printed vector and mean are JAX's
    block = lambda text: text.split("Starting evaluation on: FR_day....")[1].split(
        "Eval successfull!")[0]
    assert block(out) == block(jax_out)


def test_infer_and_inference_cli_write_png_dumps(tmp_path, monkeypatch, capsys):
    root = synthetic.make_freiburg_infer(str(tmp_path / "cap"), n=2, hw=(64, 192))
    monkeypatch.setenv("HEATNET_EVAL_BATCH", "2")
    save = tmp_path / "infer"
    assert train_conf.main(["--infer", root, "--im_save_dir", str(save), "--device", "cpu",
                            *TINY, "--num_critics", "1", "--discarch", "resnet18",
                            "--log_dir", str(tmp_path / "runs")]) == 0.0
    assert "Inference successfull !!!!" in capsys.readouterr().out
    ds = FreiburgInferDataset(root)
    for i in range(2):
        pred = read_png(str(save / f"pred_{i}.png"))
        assert pred.shape == (320, 704, 3) and pred.dtype == np.uint8
        np.testing.assert_array_equal(read_png(str(save / f"rgb_{i}.png")), ds[i]["rgb_org"][0])

    dumps = tmp_path / "served"
    run = cli_inference.main(["--data", root, "--device", "cpu", *TINY, "--batch", "2",
                              "--iters", "1", "--io-threads", "2",
                              "--im-save-dir", str(dumps)])
    assert "Directory throughput:" in capsys.readouterr().out
    assert run.maps.shape == (2, 320, 704) and run.frames_per_second > 0
    for i in range(2):
        want = (np.clip(color_code_labels(run.maps[i]), 0, 1) * 255).astype(np.uint8)
        np.testing.assert_array_equal(read_png(str(dumps / f"pred_{i}.png")), want)


def _train_pack(path, n_day=8, filtered=False):
    rng = np.random.RandomState(0)
    h, w = 64, 960
    write_train_pack(str(path),
                     rng.randint(0, 256, (n_day, h, w, 3)).astype(np.uint8),
                     rng.randint(21000, 26000, (n_day, h, w)).astype(np.uint16),
                     rng.randint(0, 13, (n_day, h, w)).astype(np.uint8),
                     rng.randint(0, 256, (3, h, w, 3)).astype(np.uint8),
                     rng.randint(21000, 26000, (3, h, w)).astype(np.uint16),
                     test_stamps_filtered=filtered)
    return str(path)


def _train_argv(pack, tmp_path, name, *extra):
    return ["--dataroot", pack, "--device", "cpu", *TINY, "--batch_size", "2",
            "--discarch", "resnet18", "--num_critics", "2", "--crop_height", "64",
            "--crop_width", "64", "--checkpointname", str(tmp_path / name),
            "--log_dir", str(tmp_path / "runs"), *extra]


def test_logged_averages_take_the_log_points_only(tmp_path, capsys):
    pack = _train_pack(tmp_path / "pack")
    run = train_conf.main(_train_argv(pack, tmp_path, "ck", "--n_epochs", "1", "--no_conf",
                                      "--log_everyn", "2"))
    losses = run.losses["train_seg"]
    assert len(losses) == 4  # 8 frames at batch 2; log points i = 0, 2 and 3
    printed = [float(line.split()[2]) for line in capsys.readouterr().out.splitlines()
               if line.startswith("Current loss")]
    jax_rule = [losses[0], np.mean(losses[0:3:2]), np.mean([losses[0], losses[2], losses[3]])]
    np.testing.assert_allclose(printed, jax_rule, rtol=1e-6)


def test_periodic_eval_leaves_training_untouched(tmp_path, monkeypatch):
    monkeypatch.setenv("HEATNET_EVAL_BATCH", "1")
    night = synthetic.make_freiburg_test(str(tmp_path / "night"), n=1, hw=(64, 192), seed=5)
    day = synthetic.make_freiburg_test(str(tmp_path / "day"), n=1, hw=(64, 192), seed=6)
    pack = _train_pack(tmp_path / "pack", n_day=2, filtered=True)
    common = ("--n_epochs", "1", "--iter_initial_critic_phase", "1", "--iter_seg_phase", "1",
              "--max_iters_per_epoch", "1")
    plain = train_conf.main(_train_argv(pack, tmp_path, "plain", *common))
    evald = train_conf.main(_train_argv(pack, tmp_path, "evald", *common,
                                        "--testroot_day", day, "--testroot_night", night,
                                        "--eval_everyn", "1"))
    assert plain.phases == evald.phases == ["train_critic", "train_seg"]
    assert plain.losses == evald.losses  # bit-equal: the eval ran between the steps
    a = torch.load(plain.checkpoint, weights_only=True)
    b = torch.load(evald.checkpoint, weights_only=True)
    assert a["epoch"] == b["epoch"] == 2
    assert a["state_dict"].keys() == b["state_dict"].keys()
    for k, v in a["state_dict"].items():
        assert torch.equal(v, b["state_dict"][k]), k
    # two evals (epochs 0 and 1), each logging night, day and the combined mean
    assert len(evald.evals) == 2 and plain.evals == []
    assert b["best_iou"] == max(evald.evals)
    assert (tmp_path / "evald_best.pth").exists() and not (tmp_path / "plain_best.pth").exists()
    logged = [json.loads(line) for p in (tmp_path / "runs").iterdir()
              for line in open(p)]
    assert sum("combined_Test mean IoU" in r for r in logged) == 2
    assert sum("night_Test mean IoU" in r for r in logged) == 2
    # a pack that may hold the test frames is refused
    with pytest.raises(ValueError, match="test-stamp"):
        train_conf.main(_train_argv(_train_pack(tmp_path / "raw"), tmp_path, "x",
                                    "--testroot_day", day, "--testroot_night", night))
