"""The port's training data path against the JAX package, on the CPU.

- ``train_sample_preprocess`` against the JAX function for fixed PRNG keys:
  the port is fed the parameters each key's own splits draw
  (heatnet_tpu/ops/preprocess.py:320-344); labels must match exactly and
  images within 1e-5;
- ``rotate`` (bilinear and nearest, integer output truncated) per sample;
- a train pack written by the port reads back through the JAX
  ``PackedFreiburgTrainDataset`` with identical items;
- ``batch_iterator`` yields the JAX iterator's batches, and
  ``DeviceAugment`` the chain's shapes and dtypes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heatnet_tpu.data.loaders import batch_iterator as jax_batch_iterator
from heatnet_tpu.data.packed import PackedFreiburgTrainDataset as JaxTrainPack
from heatnet_tpu.ops import preprocess as jp
from heatnet_tpu_torch.data.loaders import DeviceAugment, batch_iterator
from heatnet_tpu_torch.data.packed import (PackedFreiburgTrainDataset,
                                           is_train_pack_dir, write_train_pack)
from heatnet_tpu_torch.ops import preprocess as tp

H, W_FULL = 40, 960
CROP = (32, 640)


def _frames(seed, n=1):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (n, H, W_FULL, 3)).astype(np.uint8),
            rng.randint(20000, 27000, (n, H, W_FULL)).astype(np.uint16),
            rng.randint(0, 13, (n, H, W_FULL)).astype(np.uint8),
            rng.randint(0, 256, (n, H, W_FULL, 3)).astype(np.uint8),
            rng.randint(20000, 27000, (n, H, W_FULL)).astype(np.uint16))


def _jax_draws(key, in_hw, crop_hw, max_angle=20.0):
    """The draws ``jp.train_sample_preprocess`` makes from ``key``."""
    keys = jax.random.split(key, 6)
    i, j = jp.random_crop_params(keys[0], in_hw, crop_hw)

    def rot(k):
        k1, k2 = jax.random.split(k)
        return (jax.random.uniform(k1) > 0.5,
                (jax.random.uniform(k2) - 0.5) * 2.0 * max_angle)

    rot_day, ang_day = rot(keys[4])
    rot_night, ang_night = rot(keys[5])
    return dict(crop_i=int(i), crop_j=int(j),
                flip_day=bool(jax.random.uniform(keys[2]) > 0.5),
                flip_night=bool(jax.random.uniform(keys[3]) > 0.5),
                rotate_day=bool(rot_day), angle_day=float(ang_day),
                rotate_night=bool(rot_night), angle_night=float(ang_night),
                mod_drop=np.asarray(jp.rect_drop_params(keys[1], 1, crop_hw)[0]))


def _params(draws):
    def col(name, dtype):
        return torch.tensor([d[name] for d in draws], dtype=dtype)

    return tp.TrainAugParams(
        col("crop_i", torch.int64), col("crop_j", torch.int64),
        col("flip_day", torch.bool), col("flip_night", torch.bool),
        col("rotate_day", torch.bool), col("angle_day", torch.float32),
        col("rotate_night", torch.bool), col("angle_night", torch.float32),
        torch.from_numpy(np.stack([d["mod_drop"] for d in draws])))


def test_train_sample_preprocess_matches_jax_for_fixed_keys():
    seeds = range(8, 16)
    keys = [jax.random.PRNGKey(s) for s in seeds]
    frames = [_frames(s) for s in seeds]
    in_hw = (H, jp.window_crop(jnp.zeros((H, W_FULL))).shape[1])
    draws = [_jax_draws(k, in_hw, CROP) for k in keys]
    # the keys cover both outcomes of every coin
    for coin in ("flip_day", "flip_night", "rotate_day", "rotate_night"):
        assert {d[coin] for d in draws} == {False, True}, coin

    # op by op: under jit XLA's fusion rounds the rotation's source
    # coordinates differently (by up to 2 f32 ulps at x ~ 600, 1e-4 after
    # interpolation); eager JAX and PyTorch round each op alike
    want = [jp.train_sample_preprocess(k, *(a[0] for a in f), crop_hw=CROP)
            for k, f in zip(keys, frames)]
    got = tp.train_sample_preprocess(
        _params(draws), *(torch.from_numpy(np.concatenate(a)) for a in zip(*frames)),
        crop_hw=CROP)

    assert got["label_day"].dtype == torch.uint8
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
    np.testing.assert_array_equal(got["mod_drop_params"].numpy(),
                                  np.stack([np.asarray(w["mod_drop_params"])
                                            for w in want]))


@pytest.mark.parametrize("method,dtype", [("bilinear", np.float32),
                                          ("nearest", np.uint8),
                                          ("bilinear", np.uint8)])
def test_rotate_matches_jax_per_sample(method, dtype):
    rng = np.random.RandomState(7)
    imgs = (rng.rand(3, 17, 24, 2) * 200).astype(dtype)
    angles = np.array([-17.5, 3.25, 90.0], np.float32)
    got = tp.rotate(torch.from_numpy(imgs), torch.from_numpy(angles), method)
    assert got.dtype == torch.from_numpy(imgs).dtype
    for k in range(3):
        want = jp.rotate(jnp.asarray(imgs[k]), jnp.float32(angles[k]), method)
        if dtype == np.uint8:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want))
        else:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want), atol=1e-4)


def test_train_pack_reads_back_through_jax(tmp_path):
    rgb_d, ir_d, lab_d, _, _ = _frames(1, n=5)
    _, _, _, rgb_n, ir_n = _frames(2, n=3)
    assert write_train_pack(str(tmp_path), rgb_d, ir_d, lab_d, rgb_n, ir_n) == (5, 3)
    assert is_train_pack_dir(str(tmp_path))
    ours, theirs = PackedFreiburgTrainDataset(str(tmp_path)), JaxTrainPack(str(tmp_path))
    assert len(ours) == len(theirs) == 5
    for i in range(5):
        a, b = ours[i], theirs[i]
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError):
        write_train_pack(str(tmp_path / "bad"), rgb_d, ir_d.astype(np.int32),
                         lab_d, rgb_n, ir_n)


def test_batch_iterator_and_device_augment(tmp_path):
    rgb_d, ir_d, lab_d, rgb_n, ir_n = _frames(3, n=5)
    write_train_pack(str(tmp_path), rgb_d, ir_d, lab_d, rgb_n, ir_n)
    ours = list(batch_iterator(PackedFreiburgTrainDataset(str(tmp_path)), 2, seed=4))
    theirs = list(jax_batch_iterator(JaxTrainPack(str(tmp_path)), 2, seed=4))
    assert len(ours) == len(theirs) == 2
    for a, b in zip(ours, theirs):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])

    out = DeviceAugment(crop_hw=CROP, device="cpu")(
        torch.Generator().manual_seed(0), ours[0])
    assert out["rgb_day"].shape == (2, *CROP, 3) and out["ir_day"].shape == (2, *CROP, 1)
    assert out["rgb_night"].shape == (2, *CROP, 3) and out["ir_night"].shape == (2, *CROP, 1)
    assert out["label_day"].shape == (2, *CROP) and out["label_day"].dtype == torch.int64
    assert out["mod_drop_params"].shape == (2, 4)
    for k in ("rgb_day", "ir_day", "rgb_night", "ir_night"):
        assert out[k].dtype == torch.float32
        assert float(out[k].min()) >= -1.0 and float(out[k].max()) <= 1.0
