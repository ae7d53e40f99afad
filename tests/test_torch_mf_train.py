"""MFNet adversarial training (``--trainsetname MF``) in the port against JAX.

On the CPU, inputs from numpy with fixed seeds:

- the port's ``make_mfnet`` and ``make_vistas`` write the JAX copies' files
  (the same pixels, as cv2 decodes them);
- ``MFNetTrainDataset`` items equal the JAX loader's for the same seed (the
  night draws from its ``RandomState``, RGB and the IR alpha, the teacher's
  labels, all at 640x480), also when decoded on threads;
- ``mf_train_sample_preprocess`` against the JAX function for fixed PRNG
  keys, the port fed the draws each key's splits make
  (heatnet_tpu/ops/preprocess.py:356-386): labels exactly, images within
  1e-5 (the op-by-op chain, as tests/test_torch_augment.py holds the FR one);
- ``DeviceAugment(mfnet=True)``: 384x384 float32 images, int64 labels and no
  ``mod_drop_params``, as JAX's gives none;
- ``--trainsetname MF --moddrop``: JAX's seg-phase augmentation fails on an
  MF batch (``heatnet_tpu/train/adversarial.py:254`` reads the missing
  ``mod_drop_params``), and the port refuses the combination before
  training;
- ``cli.train_conf --trainsetname MF --bn_groups 2`` takes a critic and a
  seg step on a 480x640 MFNet tree and writes its checkpoint.
"""

import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heatnet_tpu.data import synthetic as jax_synthetic
from heatnet_tpu.data.loaders import DeviceAugment as JaxDeviceAugment
from heatnet_tpu.data.loaders import MFNetTrainDataset as JaxMFNetTrainDataset
from heatnet_tpu.ops import preprocess as jp
from heatnet_tpu.train import adversarial as jax_adv
from heatnet_tpu_torch.cli import train_conf
from heatnet_tpu_torch.data import synthetic
from heatnet_tpu_torch.data.loaders import DeviceAugment, MFNetTrainDataset, batch_iterator
from heatnet_tpu_torch.models import ConfSegnet
from heatnet_tpu_torch.ops import preprocess as tp

torch.set_num_threads(2)


def _same_tree(a, b):
    files = sorted(os.path.relpath(os.path.join(d, f), a)
                   for d, _, names in os.walk(a) for f in names)
    assert files == sorted(os.path.relpath(os.path.join(d, f), b)
                           for d, _, names in os.walk(b) for f in names)
    for f in files:
        if f.endswith(".png"):
            x = cv2.imread(os.path.join(a, f), cv2.IMREAD_UNCHANGED)
            y = cv2.imread(os.path.join(b, f), cv2.IMREAD_UNCHANGED)
            assert x.dtype == y.dtype and np.array_equal(x, y), f
        else:
            assert open(os.path.join(a, f)).read() == open(os.path.join(b, f)).read(), f


def test_synthetic_trees_are_the_jax_trees(tmp_path):
    _same_tree(jax_synthetic.make_mfnet(str(tmp_path / "jm"), n_train=4, n_test=1),
               synthetic.make_mfnet(str(tmp_path / "tm"), n_train=4, n_test=1))
    _same_tree(jax_synthetic.make_vistas(str(tmp_path / "jv"), n=2),
               synthetic.make_vistas(str(tmp_path / "tv"), n=2))


def test_mfnet_train_items_equal_jax(tmp_path):
    root = jax_synthetic.make_mfnet(str(tmp_path), n_train=10, n_test=0, hw=(60, 90))
    want, got = JaxMFNetTrainDataset(root, seed=2), MFNetTrainDataset(root, seed=2)
    assert len(got) == len(want) == 5
    for _ in range(2):  # two passes: the night draws go on
        for i in range(len(want)):
            a, b = want[i], got[i]
            assert set(a) == set(b)
            for k in a:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
                np.testing.assert_array_equal(b[k], a[k], err_msg=f"item {i} {k}")
    one = list(batch_iterator(MFNetTrainDataset(root, seed=5), 2, seed=1))
    threaded = list(batch_iterator(MFNetTrainDataset(root, seed=5), 2, seed=1, workers=3))
    for x, y in zip(one, threaded):
        for k in x:
            np.testing.assert_array_equal(y[k], x[k])


def _frames(seed, h=48, w=56):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (1, h, w, 3)).astype(np.uint8),
            rng.randint(0, 256, (1, h, w)).astype(np.uint8),
            rng.randint(0, 13, (1, h, w)).astype(np.uint8),
            rng.randint(0, 256, (1, h, w, 3)).astype(np.uint8),
            rng.randint(0, 256, (1, h, w)).astype(np.uint8))


def _jax_mf_draws(key, in_hw, crop_hw, max_angle=20.0):
    """The draws ``jp.mf_train_sample_preprocess`` makes from ``key``."""
    keys = jax.random.split(key, 5)
    i, j = jp.random_crop_params(keys[0], in_hw, crop_hw)

    def rot(k):
        k1, k2 = jax.random.split(k)
        return (bool(jax.random.uniform(k1) > 0.5),
                float((jax.random.uniform(k2) - 0.5) * 2.0 * max_angle))

    (rd, ad), (rn, an) = rot(keys[3]), rot(keys[4])
    return dict(crop_i=int(i), crop_j=int(j),
                flip_day=bool(jax.random.uniform(keys[1]) > 0.5),
                flip_night=bool(jax.random.uniform(keys[2]) > 0.5),
                rotate_day=rd, angle_day=ad, rotate_night=rn, angle_night=an)


def test_mf_train_sample_preprocess_matches_jax_for_fixed_keys():
    crop = (32, 40)
    keys = [jax.random.PRNGKey(s) for s in range(20, 28)]
    frames = [_frames(s) for s in range(20, 28)]
    draws = [_jax_mf_draws(k, (48, 56), crop) for k in keys]
    for coin in ("flip_day", "flip_night", "rotate_day", "rotate_night"):
        assert {d[coin] for d in draws} == {False, True}, coin
    want = [jp.mf_train_sample_preprocess(k, *(a[0] for a in f), crop_hw=crop)
            for k, f in zip(keys, frames)]

    def col(name, dtype):
        return torch.tensor([d[name] for d in draws], dtype=dtype)

    params = tp.TrainAugParams(
        col("crop_i", torch.int64), col("crop_j", torch.int64),
        col("flip_day", torch.bool), col("flip_night", torch.bool),
        col("rotate_day", torch.bool), col("angle_day", torch.float32),
        col("rotate_night", torch.bool), col("angle_night", torch.float32), None)
    got = tp.mf_train_sample_preprocess(
        params, *(torch.from_numpy(np.concatenate(a)) for a in zip(*frames)), crop_hw=crop)

    assert set(got) == set(want[0]) and "mod_drop_params" not in got
    np.testing.assert_array_equal(got["label_day"].numpy(),
                                  np.stack([np.asarray(w["label_day"]) for w in want]))
    for name in ("rgb_day", "rgb_night"):
        np.testing.assert_allclose(got[name].numpy(),
                                   np.stack([np.asarray(w[name]) for w in want]),
                                   atol=1e-5, err_msg=name)
    for name in ("ir_day", "ir_night"):  # the JAX chain's IR has no channel axis
        np.testing.assert_allclose(got[name].numpy()[..., 0],
                                   np.stack([np.asarray(w[name]) for w in want]),
                                   atol=1e-5, err_msg=name)


def test_device_augment_mfnet_and_the_moddrop_refusal(tmp_path):
    root = jax_synthetic.make_mfnet(str(tmp_path), n_train=4, n_test=0)
    raw = next(batch_iterator(MFNetTrainDataset(root), 2, seed=0))
    assert raw["ir_day"].shape == (2, 480, 640, 1) and raw["ir_day"].dtype == np.uint8
    out = DeviceAugment((384, 384), "cpu", mfnet=True)(torch.Generator().manual_seed(0), raw)
    assert set(out) == {"rgb_day", "ir_day", "label_day", "rgb_night", "ir_night"}
    assert out["rgb_day"].shape == (2, 384, 384, 3) and out["ir_night"].shape == (2, 384, 384, 1)
    assert out["rgb_day"].dtype == torch.float32 and out["label_day"].dtype == torch.int64
    assert float(out["ir_day"].min()) >= -1.0 and float(out["ir_day"].max()) <= 1.0

    # JAX: the MF chain returns no rectangles, which --moddrop's seg step reads
    batch_j = JaxDeviceAugment((384, 384), mfnet=True)(jax.random.PRNGKey(0), raw)
    assert "mod_drop_params" not in batch_j
    cfg = jax_adv.AdversarialConfig(moddrop=True)
    with pytest.raises(KeyError, match="mod_drop_params"):
        jax_adv._augment_day(jax.random.PRNGKey(1),
                             {k: jnp.asarray(v) for k, v in batch_j.items()}, cfg)
    with pytest.raises(ValueError, match="--moddrop"):
        train_conf.main(["--trainsetname", "MF", "--moddrop", "--dataroot", root,
                         "--device", "cpu"])


def test_train_conf_trains_on_mfnet_with_bn_groups(tmp_path):
    root = synthetic.make_mfnet(str(tmp_path / "mf"), n_train=4, n_test=0)
    run = train_conf.main([
        "--trainsetname", "MF", "--dataroot", root, "--bn_groups", "2", "--irscale",
        "--structure", "1", "1", "1", "1", "--discarch", "resnet18", "--num_critics", "2",
        "--batch_size", "2", "--n_epochs", "1", "--iter_initial_critic_phase", "1",
        "--iter_seg_phase", "1", "--max_iters_per_epoch", "1", "--device", "cpu",
        "--checkpointname", str(tmp_path / "conf"), "--log_dir", str(tmp_path / "runs")])
    assert run.phases == ["train_critic", "train_seg"]
    assert all(np.isfinite(v) for vs in run.losses.values() for v in vs)
    saved = torch.load(run.checkpoint, map_location="cpu", weights_only=True)
    net = ConfSegnet(disc_arch="resnet18", num_critics=2, structure=(1, 1, 1, 1),
                     bn_groups=2)
    net.load_state_dict(saved["state_dict"], strict=True)
    assert saved["epoch"] == 2
