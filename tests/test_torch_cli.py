"""The port's inference CLI against the JAX forward on the same weights.

A 4-frame heatnet-pack-v1 directory (numpy-made, 64x96) is served by
``heatnet_tpu_torch.cli.inference`` with ``--device cpu`` and the weights of
a randomised flax ResNeXtSeg (structure 1,1,1,1) carried over as a PyTorch
``state_dict`` file; the class maps must equal the JAX forward's argmax,
except where JAX's own top two logits are tied to within 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heatnet_tpu.eval.validate import _device_normalize
from heatnet_tpu.models import ResNeXtSeg as JaxResNeXtSeg
from heatnet_tpu.train.state import init_model
from heatnet_tpu_torch.cli import inference as cli
from heatnet_tpu_torch.data.packed import PackedFrameDataset, write_pack
from heatnet_tpu_torch.io.from_jax import state_dict_from_jax

from test_torch_layers import randomize

torch.set_num_threads(2)

STRUCTURE = ["--structure", "1", "1", "1", "1"]


@pytest.fixture(scope="module")
def pack(tmp_path_factory):
    rng = np.random.RandomState(0)
    rgb = rng.randint(0, 256, (4, 64, 96, 3)).astype(np.uint8)
    ir = rng.randint(21000, 26000, (4, 64, 96, 1)).astype(np.uint16)
    d = tmp_path_factory.mktemp("pack")
    write_pack(str(d), rgb, ir)
    return str(d), rgb, ir


def test_cli_matches_jax_forward(pack, tmp_path, capsys):
    pack_dir, rgb, ir = pack
    model_j = JaxResNeXtSeg(structure=(1, 1, 1, 1), input_channels=4,
                            dtype=jnp.float32)
    params, stats = init_model(model_j, jax.random.PRNGKey(3),
                               jnp.zeros((1, 64, 96, 3)), jnp.zeros((1, 64, 96, 1)))
    variables = randomize({"params": params, "batch_stats": stats}, seed=11)
    ckpt = tmp_path / "weights.pt"
    torch.save(state_dict_from_jax(variables["params"],
                                   variables["batch_stats"]), ckpt)

    run = cli.main(["--data", pack_dir, "--device", "cpu", "--resume", str(ckpt),
                    "--batch", "3", "--iters", "1", *STRUCTURE])
    out = capsys.readouterr().out
    assert "Network took" in out and "Ran inference on 4 frames" in out
    assert run.maps.shape == (4, 64, 96) and run.maps.dtype == np.uint8

    seg, _, _ = model_j.apply(variables, _device_normalize(jnp.asarray(rgb)),
                              _device_normalize(jnp.asarray(ir)), train=False)
    seg = np.asarray(seg)
    ref = seg.argmax(-1)
    top2 = np.sort(seg, axis=-1)[..., -2:]
    differ = run.maps != ref
    assert np.all(top2[..., 1][differ] - top2[..., 0][differ] < 1e-3), \
        f"{differ.sum()} pixels differ beyond near-ties"
    assert differ.mean() < 1e-3


def test_pack_round_trip(pack):
    pack_dir, rgb, ir = pack
    ds = PackedFrameDataset(pack_dir)
    assert len(ds) == 4
    item = ds[2]
    np.testing.assert_array_equal(item["rgb"][0], rgb[2])
    np.testing.assert_array_equal(item["ir"][0], ir[2])
    assert item["rgb"].shape == (1, 64, 96, 3) and item["ir"].dtype == np.uint16


def test_cli_raises_without_a_card(pack):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--data", pack[0], *STRUCTURE])


def test_cli_refuses_a_png_tree(tmp_path):
    # capture trees are served (tests/test_torch_eval.py); a directory that is
    # neither a pack nor a tree with frames is refused
    with pytest.raises(FileNotFoundError, match="no frames"):
        cli.main(["--data", str(tmp_path), "--device", "cpu", *STRUCTURE])
