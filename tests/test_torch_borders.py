"""The Vistas-borders loader and ``cli.inference --borders-data``, against
the JAX package (which reads with cv2) on the CPU.

- ``distance_transform_l2_5`` against ``cv2.distanceTransform(DIST_L2, 5)``
  (the 5x5 chamfer transform, not the exact Euclidean one) on random masks
  of many densities and sizes, edges and the zero-free mask included: equal
  in float32.
- ``VistasBordersDataset`` items against JAX's, eval and train chains, on a
  tree the port's PNG writer makes (frames smaller than the crop padded),
  without CLAHE and with it (the default): every array equal.
- ``--borders-data`` class maps against the JAX forward of the same weights
  on JAX's items (f32, structure 1,1,1,1, the 7x7 stem), equal except where
  JAX's top two logits are within 1e-3; the colour-coded PNGs are written,
  and ``--quant int8`` at the mode's batch 1 serves the float maps.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heatnet_tpu_torch.cli import inference as cli
from heatnet_tpu_torch.data.loaders import VistasBordersDataset, distance_transform_l2_5
from heatnet_tpu_torch.data.png import read_png, write_png
from heatnet_tpu_torch.io.from_jax import state_dict_from_jax

torch.set_num_threads(2)

W, H = 64, 48


def test_distance_transform_equals_cv2():
    cv2 = pytest.importorskip("cv2")
    rng = np.random.RandomState(0)
    for t in range(40):
        h, w = rng.randint(1, 48), rng.randint(1, 48)
        p = (0.01, 0.05, 0.3, 0.9, 0.99)[t % 5]
        m = ((rng.rand(h, w) < p) * rng.choice([1, 255])).astype(np.uint8)
        np.testing.assert_array_equal(distance_transform_l2_5(m),
                                      cv2.distanceTransform(m, cv2.DIST_L2, 5))
    ones = np.ones((5, 7), np.uint8)  # no zero: FLT_MAX everywhere, as cv2
    np.testing.assert_array_equal(distance_transform_l2_5(ones),
                                  cv2.distanceTransform(ones, cv2.DIST_L2, 5))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Three frames: one larger than the 64x48 crop, two shorter (padded)."""
    root = tmp_path_factory.mktemp("borders")
    rng = np.random.RandomState(1)
    lines = []
    for i, (h, w) in enumerate(((60, 80), (40, 96), (30, 64))):
        borders = np.zeros((h, w), np.uint8)
        borders[rng.randint(0, h, 3), :] = 1
        borders[:, rng.randint(0, w, 2)] = 1
        ids = (rng.randint(0, 14, (h, w)) * 256 + rng.randint(0, 256, (h, w))).astype(np.uint16)
        paths = [str(root / f"{k}_{i}.png") for k in ("borders", "ids", "image", "dt")]
        write_png(paths[0], borders)
        write_png(paths[1], ids)
        write_png(paths[2], rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
        write_png(paths[3], rng.randint(0, 30, (h, w)).astype(np.uint8))
        lines.append(" ".join(paths))
    paths_file = root / "paths.txt"
    paths_file.write_text("\n".join(lines) + "\n")
    return str(paths_file)


@pytest.mark.parametrize("augment", [False, True], ids=["eval", "train"])
def test_items_equal_jax(tree, augment):
    pytest.importorskip("cv2")
    from heatnet_tpu.data.loaders import VistasBordersDataset as JaxBorders

    kw = dict(contrast_enhancement=False, augment_data=augment, seed=3)
    port, ref = VistasBordersDataset(tree, W, H, **kw), JaxBorders(tree, W, H, **kw)
    assert len(port) == len(ref) == 3
    for i in range(3):
        a, b = port[i], ref[i]
        assert set(a) == set(b)
        for k in b:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"item {i} {k}")
    # the default: CLAHE on (data/clahe.py against cv2's)
    kw.pop("contrast_enhancement")
    port, ref = VistasBordersDataset(tree, W, H, **kw), JaxBorders(tree, W, H, **kw)
    for i in range(3):
        a, b = port[i], ref[i]
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"default, item {i} {k}")


def test_borders_cli_matches_jax_forward(tree, tmp_path, capsys):
    pytest.importorskip("cv2")
    from heatnet_tpu.data.loaders import VistasBordersDataset as JaxBorders
    from heatnet_tpu.models import ResNeXtSeg as JaxResNeXtSeg
    from heatnet_tpu.train.state import init_model

    from test_torch_layers import randomize

    model_j = JaxResNeXtSeg(structure=(1, 1, 1, 1), input_channels=3, input_3x3=False,
                            dtype=jnp.float32)
    params, stats = init_model(model_j, jax.random.PRNGKey(2), jnp.zeros((1, H, W, 3)))
    variables = randomize({"params": params, "batch_stats": stats}, seed=5)
    ckpt = tmp_path / "vistas.pth"
    torch.save(state_dict_from_jax(variables["params"], variables["batch_stats"]), ckpt)
    out = tmp_path / "out"
    argv = ["--borders-data", tree, "--width", str(W), "--height", str(H), "--device",
            "cpu", "--structure", "1", "1", "1", "1", "--resume", str(ckpt), "--iters", "1",
            "--im-save-dir", str(out)]
    run = cli.main(argv)
    assert "Network took" in capsys.readouterr().out
    names = sorted(os.listdir(out))
    assert names == sorted(f"{k}_{i}.png" for k in ("gt", "pred", "rgb") for i in range(3))
    assert read_png(str(out / "pred_0.png")).shape == run.maps.shape[1:] + (3,)

    ds = JaxBorders(tree, W, H, contrast_enhancement=False, augment_data=False)
    x = jnp.asarray(np.stack([ds[i]["image"] for i in range(3)]))
    seg = np.asarray(model_j.apply(variables, x, train=False)[0])
    top2 = np.sort(seg, -1)[..., -2:]
    tie = (top2[..., 1] - top2[..., 0]) <= 1e-3
    assert run.maps.shape == seg.shape[:3] and seg.shape[0] == 3
    np.testing.assert_array_equal(run.maps[~tie], seg.argmax(-1)[~tie])
    assert np.array_equal(cli.main(argv + ["--quant", "int8"]).maps, run.maps)
