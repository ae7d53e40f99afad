"""Reference checkpoints and the Vistas relabelling, against the JAX package.

- A reference-named ResNeXtSeg ``state_dict`` (the port's keys renamed to the
  reference's: ``convs.`` nesting, ``mod1.conv1_2``/``bn1_2``, a
  ``module.trgb_segnet.`` prefix) goes through JAX's ``import_into`` and
  through the port's ``cli.convert_checkpoint``: every tensor comes back bit
  for bit, and the two forwards agree at f32, rtol 1e-3 and atol 2e-3 (the
  tolerance of tests/test_torch_parity.py); ``cli.inference --resume`` on the
  converted file gives the original weights' class maps.
- The CycleGAN generator's and PatchGAN discriminator's Sequential renames:
  the port's converted keys load strictly and name the same modules as JAX's
  conversion of the same dict.
- ``relabel_vistas_image`` equals JAX's on random panoptic maps, and
  ``cli.generate_vistas`` writes the same PNG tree as JAX's CLI (cv2 reads
  and writes there) from a tree of PNG inputs.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heatnet_tpu.data.mappings import relabel_vistas_image as jax_relabel
from heatnet_tpu.io import torch_import as jti
from heatnet_tpu.models import ResNeXtSeg as JaxResNeXtSeg
from heatnet_tpu.train.state import init_model
from heatnet_tpu_torch.cli import convert_checkpoint, generate_vistas
from heatnet_tpu_torch.cli import inference as cli
from heatnet_tpu_torch.data.mappings import relabel_vistas_image
from heatnet_tpu_torch.data.packed import write_pack
from heatnet_tpu_torch.data.png import read_png, write_png
from heatnet_tpu_torch.io import torch_import as pti
from heatnet_tpu_torch.models import Discriminator, Generator, ResNeXtSeg
from heatnet_tpu_torch.models.layers import init_params


torch.set_num_threads(2)

HW = (32, 48)


def _port_model():
    m = ResNeXtSeg(structure=(1, 1, 1, 1), input_channels=4)
    init_params(m, torch.Generator().manual_seed(4))
    with torch.no_grad():  # non-trivial BN statistics and affine
        g = torch.Generator().manual_seed(5)
        for mod in m.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.weight.copy_(torch.rand(mod.weight.shape, generator=g) + 0.5)
                mod.bias.copy_(torch.randn(mod.bias.shape, generator=g) * 0.1)
                mod.running_mean.copy_(torch.randn(mod.running_mean.shape, generator=g) * 0.1)
                mod.running_var.copy_(torch.rand(mod.running_var.shape, generator=g) + 0.5)
    return m.eval()


def _reference_names(port_state_dict, prefix="module.trgb_segnet."):
    """The port's ResNeXtSeg keys under the reference's names: each block's
    ``conv1``/``bn2``/``conv2``/``bn3``/``conv3`` nested in ``convs``, the
    stem's ``conv1``/``bn1`` as ``conv1_2``/``bn1_2``, ``prefix`` in front (a
    ``DataParallel``-wrapped ``trgb_segnet``)."""
    out = {}
    for key, t in port_state_dict.items():
        parts = key.split(".")
        if parts[0].startswith("mod1") and len(parts) > 1 and parts[1] in ("conv1", "bn1"):
            parts[1] += "_2"
        elif (len(parts) > 2 and parts[0].startswith("mod") and parts[1].startswith("block")
              and parts[2] in ("conv1", "bn2", "conv2", "bn3", "conv3")):
            parts.insert(2, "convs")
        out[prefix + ".".join(parts)] = t
    return out


def test_reference_checkpoint_through_jax_and_the_port(tmp_path, capsys):
    model = _port_model()
    ref_sd = _reference_names(model.state_dict())
    assert "module.trgb_segnet.mod1.conv1_2.weight" in ref_sd
    assert "module.trgb_segnet.mod2_1.block1.convs.conv2.weight" in ref_sd
    src = tmp_path / "ref.pth.tar"
    torch.save({"state_dict": ref_sd, "epoch": 7}, src)

    out = tmp_path / "converted.pth"
    convert_checkpoint.main(["--torch-checkpoint", str(src), "--out", str(out),
                             "--structure", "1", "1", "1", "1",
                             "--to-rename", "module.trgb_segnet.", "--rename", ""])
    assert "Loaded dict with" in capsys.readouterr().out
    converted = torch.load(out, weights_only=True)["state_dict"]
    want = model.state_dict()
    assert set(converted) == set(want)
    for k, v in want.items():
        assert torch.equal(converted[k], v), k

    model_j = JaxResNeXtSeg(structure=(1, 1, 1, 1), input_channels=4, dtype=jnp.float32)
    params, stats = init_model(model_j, jax.random.PRNGKey(0),
                               jnp.zeros((1, *HW, 3)), jnp.zeros((1, *HW, 1)))
    params, stats = jti.import_into(params, stats, ref_sd,
                                    to_rename="module.trgb_segnet.", rename="")
    rng = np.random.RandomState(2)
    rgb = rng.rand(2, *HW, 3).astype(np.float32) * 2 - 1
    ir = rng.rand(2, *HW, 1).astype(np.float32) * 2 - 1
    seg_j = model_j.apply({"params": params, "batch_stats": stats}, jnp.asarray(rgb),
                          jnp.asarray(ir), train=False)[0]
    with torch.no_grad():
        seg_t = model(torch.from_numpy(rgb), torch.from_numpy(ir))[0]
    np.testing.assert_allclose(seg_t.numpy(), np.asarray(seg_j), rtol=1e-3, atol=2e-3)

    # --resume on the converted file serves the original weights
    prng = np.random.RandomState(3)
    pack = str(tmp_path / "pack")
    write_pack(pack, prng.randint(0, 256, (2, *HW, 3)).astype(np.uint8),
               prng.randint(21000, 26000, (2, *HW, 1)).astype(np.uint16))
    argv = ["--data", pack, "--device", "cpu", "--iters", "1", "--structure", "1", "1",
            "1", "1", "--batch", "2"]
    original = tmp_path / "original.pth"
    torch.save(model.state_dict(), original)
    got = cli.main(argv + ["--resume", str(out)]).maps
    assert np.array_equal(got, cli.main(argv + ["--resume", str(original)]).maps)


def _inverse(rename_map):
    return {v: k for k, v in rename_map.items()}


def _modules(keys, sep):
    return {sep.join(k.split(sep)[:-1]).replace("/", ".") for k in keys}


@pytest.mark.parametrize("which", ["generator", "patchgan"])
def test_cyclegan_renames(which):
    if which == "generator":
        model, renames = Generator(1, n_residual_blocks=2), pti.cyclegan_generator_renames(2)
        jax_map = jti.cyclegan_generator_renames(2)
    else:
        model, renames = Discriminator(1), pti.PATCHGAN_DISC_RENAMES
        jax_map = jti.PATCHGAN_DISC_RENAMES
    init_params(model, torch.Generator().manual_seed(1))
    inv = _inverse(renames)
    ref_sd = {pti._apply_rename_map(k, inv): v for k, v in model.state_dict().items()}
    assert all(k.startswith("model.") for k in ref_sd)
    converted = pti.convert_state_dict(ref_sd, rename_map=renames)
    fresh = type(model)(1, n_residual_blocks=2) if which == "generator" else Discriminator(1)
    fresh.load_state_dict(converted, strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    params, stats = jti.convert_state_dict(ref_sd, rename_map=jax_map)
    assert _modules(converted, ".") == _modules(list(params) + list(stats), "/")


def test_relabel_vistas_matches_jax():
    rng = np.random.RandomState(0)
    for shape in ((7, 9), (40, 33), (1, 1)):
        cls = rng.randint(0, 70, shape)
        inst = rng.choice([0, 1, 2, 200, 255], shape)
        img = (cls * 256 + inst).astype(np.uint16)
        got = relabel_vistas_image(img)
        assert got.dtype == np.uint16
        np.testing.assert_array_equal(got, jax_relabel(img))


def test_generate_vistas_matches_jax_cli(tmp_path, capsys):
    pytest.importorskip("cv2")  # JAX's CLI reads and writes with cv2
    from heatnet_tpu.cli import generate_vistas as jax_cli

    root = tmp_path / "vistas"
    os.makedirs(root / "training/images")
    os.makedirs(root / "v1.2/instances")
    rng = np.random.RandomState(1)
    for i, (h, w) in enumerate(((30, 41), (24, 64), (50, 37))):
        write_png(str(root / f"training/images/f{i}.png"),
                  rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
        lab = rng.randint(0, 66, (h, w)) * 256 + rng.randint(0, 4, (h, w))
        write_png(str(root / f"v1.2/instances/f{i}.png"), lab.astype(np.uint16))
    n = generate_vistas.main(["--vistas_root", str(root), "--out", str(tmp_path / "port"),
                              "--width", "48"])
    assert "numpy relabeller serves" in capsys.readouterr().out
    assert n == jax_cli.main(["--vistas_root", str(root), "--out", str(tmp_path / "jax"),
                              "--width", "48", "--no_native"]) == 3
    for d in ("images", "labels"):
        for name in sorted(os.listdir(tmp_path / "jax" / d)):
            a = read_png(str(tmp_path / "port" / d / name))
            b = read_png(str(tmp_path / "jax" / d / name))
            assert a.dtype == b.dtype and a.shape[1] == 48
            np.testing.assert_array_equal(a, b, err_msg=f"{d}/{name}")
    assert (open(tmp_path / "port/paths.txt").read()
            == open(tmp_path / "jax/paths.txt").read())
