"""Freiburg training trees and packs in the port against the JAX package.

``heatnet_tpu_torch.data.loaders`` (``sort_day_night``, ``filter_test_data``,
``holdout_split``, ``FreiburgThermalDataset``, ``open_freiburg_train``),
``data.packed`` (``pack_freiburg_train``, ``pack_inference_dir``),
``cli.pack_frames``, ``data.synthetic.make_freiburg_*`` and the trainers'
tree input, on trees written by cv2 (``heatnet_tpu.data.synthetic``) from
numpy seeds:

- the file lists, the split and the stamp filter equal JAX's exactly;
  ``holdout_split`` is sklearn's split, and both raise at n = 1;
- items and packs: RGB and labels bit for bit; IR bit for bit from a
  960x320 tree (an identity resize), else within 1 count on at most 1 % of
  pixels (the port's uint16 resize rounds exact .5 ties half to even,
  ``tests/test_torch_png.py`` measures the shares);
- packs of either package open in the other's readers;
- ``cli.train_plain`` on a tree gives the losses of the same run on its
  pack, bit for bit.
"""

import json
import os
from glob import glob

import numpy as np
import pytest
import torch

from heatnet_tpu.data import loaders as jax_loaders
from heatnet_tpu.data import packed as jax_packed
from heatnet_tpu.data import synthetic as jax_synthetic
from heatnet_tpu_torch.cli import pack_frames, train_plain
from heatnet_tpu_torch.data import loaders, packed, synthetic
from heatnet_tpu_torch.data.png import read_png

torch.set_num_threads(2)

KEYS = ("rgb_day", "ir_day", "label_day", "rgb_night", "ir_night")


def _assert_frames(port, ref, exact, what=""):
    """RGB and labels bit for bit; IR (uint16 keys) bit for bit if ``exact``,
    else within 1 count on at most 1 % of pixels."""
    assert port.dtype == ref.dtype and port.shape == ref.shape, what
    if port.dtype != np.uint16 or exact:
        np.testing.assert_array_equal(port, ref, err_msg=what)
        return
    diff = np.abs(port.astype(np.int64) - ref.astype(np.int64))
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.01, (what, diff.max(),
                                                            (diff > 0).mean())


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """cv2-written trees: a train tree at the synthetic size (resized) and
    one at 960x320 (identity), two test trees sharing a day stamp with the
    first, and a capture tree."""
    base = tmp_path_factory.mktemp("fr")
    small = jax_synthetic.make_freiburg_train(str(base / "small"), n_day=5, n_night=3,
                                              hw=(64, 192), seed=3)
    full = jax_synthetic.make_freiburg_train(str(base / "full"), n_day=3, n_night=2,
                                             hw=(320, 960), seed=4)
    test_day = jax_synthetic.make_freiburg_test(str(base / "test_day"), n=1, seed=5)
    # a day frame of the train tree that the test tree also labels
    stamp = "1500000001_000001000"
    np.save(os.path.join(test_day, "SegmentationClass", stamp + ".npy"),
            np.zeros((64, 192), np.uint8))
    test_night = jax_synthetic.make_freiburg_test(str(base / "test_night"), n=1, seed=6)
    capture = jax_synthetic.make_freiburg_infer(str(base / "cap"), n=3, seed=7)
    return {"small": small, "full": full, "test_day": test_day,
            "test_night": test_night, "capture": capture, "base": base}


def _test_stamps(trees):
    paths = jax_loaders.get_test_paths([trees["test_night"], trees["test_day"]])[2]
    return jax_loaders.get_test_stamps(paths)


def test_sort_day_night_and_filter_equal_jax(trees, tmp_path):
    files = sorted(glob(os.path.join(trees["small"], "*/*/fl_ir_aligned/*.png")))
    assert loaders.sort_day_night(files) == jax_loaders.sort_day_night(files)
    # a day frame without its label and a frame without its RGB are dropped
    day_label = files[0].replace("fl_ir_aligned", "fl_rgb_labels")
    night_rgb = files[-1].replace("fl_ir_aligned", "fl_rgb")
    moved = {p: str(tmp_path / os.path.basename(p)) for p in (day_label, night_rgb)}
    for src, dst in moved.items():
        os.rename(src, dst)
    try:
        got = loaders.sort_day_night(files)
        assert got == jax_loaders.sort_day_night(files)
        assert len(got[0]) == 4 and len(got[3]) == 2
    finally:
        for src, dst in moved.items():
            os.rename(dst, src)
    stamps = _test_stamps(trees)
    assert (1500000001, 1000) in stamps
    kept = loaders.filter_test_data(files, stamps)
    assert kept == jax_loaders.filter_test_data(files, stamps)
    assert len(kept) == len(files) - 1


@pytest.mark.parametrize("n", [1, 2, 3, 7, 99, 100, 101, 250, 1234])
def test_holdout_split_equals_jax(n):
    items = [list(range(n)), [f"f{i}" for i in range(n)]]
    if n == 1:
        with pytest.raises(ValueError, match="train set will be empty"):
            jax_loaders.holdout_split(items)
        with pytest.raises(ValueError, match="train set will be empty"):
            loaders.holdout_split(items)
        return
    assert loaders.holdout_split(items) == jax_loaders.holdout_split(items)


@pytest.mark.parametrize("tree,split", [("small", "train"), ("small", "test"),
                                        ("full", "train")])
def test_items_equal_jax(trees, tree, split):
    port = loaders.FreiburgThermalDataset(trees[tree], split=split, seed=3)
    ref = jax_loaders.FreiburgThermalDataset(trees[tree], split=split, seed=3)
    assert port.rgb_day_files == ref.rgb_day_files
    assert port.ir_night_files == ref.ir_night_files
    assert len(port) == len(ref)
    for i in list(range(len(port))) * 2:  # the night draws continue in call order
        a, b = port[i], ref[i]
        assert sorted(a) == sorted(KEYS)
        for k in KEYS:
            _assert_frames(a[k], b[k], exact=tree == "full", what=f"{tree} {i} {k}")


def test_missing_tree_raises_as_in_jax(tmp_path):
    for mod in (loaders, jax_loaders):
        with pytest.raises(FileNotFoundError, match="no Freiburg Thermal data"):
            mod.FreiburgThermalDataset(str(tmp_path))


def _read_pack(path):
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return meta, {n[:-4]: np.load(os.path.join(path, n)) for n in os.listdir(path)
                  if n.endswith(".npy")}


@pytest.mark.parametrize("which", ["train", "train_filtered", "test_split", "inference"])
def test_packs_equal_jax(trees, tmp_path, which):
    if which == "inference":
        n = packed.pack_inference_dir(trees["capture"], str(tmp_path / "port"))
        assert n == jax_packed.pack_inference_dir(trees["capture"], str(tmp_path / "jax"))
    else:
        kw = {"split": "test" if which == "test_split" else "train",
              "test_stamps": _test_stamps(trees) if which == "train_filtered" else None}
        got = packed.pack_freiburg_train(trees["small"], str(tmp_path / "port"), **kw)
        assert got == jax_packed.pack_freiburg_train(trees["small"], str(tmp_path / "jax"),
                                                     **kw)
    meta_p, arrays_p = _read_pack(str(tmp_path / "port"))
    meta_j, arrays_j = _read_pack(str(tmp_path / "jax"))
    assert meta_p == meta_j
    assert sorted(arrays_p) == sorted(arrays_j)
    for k in arrays_p:
        _assert_frames(arrays_p[k], arrays_j[k], exact=False, what=k)


def test_pack_frames_cli_and_readers_of_either_package(trees, tmp_path):
    out = str(tmp_path / "pk")
    n_day = pack_frames.main(["--data", trees["small"], "--out", out, "--train", "--quiet",
                              "--testroot_day", trees["test_day"],
                              "--testroot_night", trees["test_night"]])
    assert n_day == 3  # 5 day frames, 1 a test stamp, 1 held out
    with open(os.path.join(out, "meta.json")) as f:
        assert json.load(f)["test_stamps_filtered"] is True
    # the port's pack in JAX's reader and the port's, against the tree's items
    tree = loaders.FreiburgThermalDataset(trees["small"], test_stamps=_test_stamps(trees))
    jax_reader = jax_loaders.open_freiburg_train(out, test_stamps=_test_stamps(trees))
    port_reader = loaders.open_freiburg_train(out, test_stamps=_test_stamps(trees))
    assert isinstance(port_reader, packed.PackedFreiburgTrainDataset)
    for i in range(n_day):
        want = tree[i]
        for got in (port_reader[i], jax_reader[i]):
            for k in KEYS:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # JAX's inference pack in the port's reader
    jax_packed.pack_inference_dir(trees["capture"], str(tmp_path / "jinf"))
    port_inf = packed.PackedFrameDataset(str(tmp_path / "jinf"))
    tree_inf = loaders.FreiburgInferDataset(trees["capture"])
    assert len(port_inf) == len(tree_inf) == 3
    for i in range(3):
        a, b = port_inf[i], tree_inf[i]
        np.testing.assert_array_equal(a["rgb"], b["rgb"])
        _assert_frames(a["ir"], b["ir"], exact=False)


def test_open_freiburg_train_dispatch_and_leakage_guards(trees, tmp_path):
    stamps = _test_stamps(trees)
    assert isinstance(loaders.open_freiburg_train(trees["small"]),
                      loaders.FreiburgThermalDataset)
    plain = str(tmp_path / "plain")
    packed.pack_freiburg_train(trees["small"], plain)
    assert isinstance(loaders.open_freiburg_train(plain), packed.PackedFreiburgTrainDataset)
    for mod in (loaders, jax_loaders):
        with pytest.raises(ValueError, match="split"):
            mod.open_freiburg_train(plain, split="test")
        with pytest.raises(ValueError, match="test-stamp"):
            mod.open_freiburg_train(plain, test_stamps=stamps)
    filtered = str(tmp_path / "filtered")
    packed.pack_freiburg_train(trees["small"], filtered, test_stamps=stamps)
    assert len(loaders.open_freiburg_train(filtered, test_stamps=stamps)) == 3


@pytest.mark.parametrize("maker", ["make_freiburg_train", "make_freiburg_test",
                                   "make_freiburg_infer"])
def test_synthetic_trees_equal_jax(tmp_path, maker):
    getattr(synthetic, maker)(str(tmp_path / "port"), hw=(16, 24))
    getattr(jax_synthetic, maker)(str(tmp_path / "jax"), hw=(16, 24))
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "port")
                   for d, _, fs in os.walk(tmp_path / "port") for f in fs)
    want = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "jax")
                  for d, _, fs in os.walk(tmp_path / "jax") for f in fs)
    assert files == want and files
    for f in files:
        read = np.load if f.endswith(".npy") else read_png
        a, b = read(str(tmp_path / "port" / f)), read(str(tmp_path / "jax" / f))
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_train_plain_on_a_tree_equals_its_pack(tmp_path):
    tree = synthetic.make_freiburg_train(str(tmp_path / "tree"), n_day=2, n_night=2,
                                         hw=(64, 192), seed=8)
    pack = str(tmp_path / "pack")
    pack_frames.main(["--data", tree, "--out", pack, "--train", "--quiet"])
    runs = []
    for root, name in ((tree, "t"), (pack, "p")):
        runs.append(train_plain.main([
            "--dataroot", root, "--device", "cpu", "--structure", "1", "1", "1", "1",
            "--batch_size", "1", "--n_epochs", "1", "--checkpointname",
            str(tmp_path / name), "--log_dir", str(tmp_path / "runs")]))
    assert len(runs[0].losses) == 1 and np.isfinite(runs[0].losses[0])
    assert runs[0].losses == runs[1].losses
