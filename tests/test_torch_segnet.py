"""Port ResNeXtSeg (heatnet_tpu_torch.models) against the flax model.

Structure (1, 1, 1, 1) at full widths (64 → 2048 channels, groups 64,
dilation (1, 1, 2, 4)) on a 64x96 RGB+IR input, f32, rtol 1e-3 and atol
2e-3 (the tolerance of tests/test_torch_parity.py): seg and all six critic
taps. The weights go JAX → port with ``state_dict_from_jax`` and come back
with ``heatnet_tpu.io.torch_import.convert_state_dict``, which must hit every
JAX leaf and reproduce the tree. Full depth is the slow case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heatnet_tpu.io.checkpoint import _flatten
from heatnet_tpu.io.torch_import import convert_state_dict
from heatnet_tpu.models import ResNeXtSeg as JaxResNeXtSeg
from heatnet_tpu.train.state import init_model
from heatnet_tpu_torch.io.from_jax import state_dict_from_jax
from heatnet_tpu_torch.models import ResNeXtSeg, get_model

from test_torch_layers import randomize

torch.set_num_threads(2)


def _inputs(n=2, h=64, w=96):
    rng = np.random.RandomState(1)
    return (rng.rand(n, h, w, 3).astype(np.float32) * 2 - 1,
            rng.rand(n, h, w, 1).astype(np.float32) * 2 - 1)


def _pair(structure):
    model_j = JaxResNeXtSeg(structure=structure, input_channels=4,
                            dtype=jnp.float32)
    rgb, ir = _inputs()
    params, stats = init_model(model_j, jax.random.PRNGKey(0),
                               jnp.asarray(rgb), jnp.asarray(ir))
    variables = randomize({"params": params, "batch_stats": stats})
    model_t = ResNeXtSeg(structure=structure, input_channels=4)
    model_t.load_state_dict(state_dict_from_jax(variables["params"],
                                                variables["batch_stats"]),
                            strict=True)
    return model_j, variables, model_t.eval()


@pytest.fixture(scope="module")
def small():
    return _pair((1, 1, 1, 1))


def _check_forward(model_j, variables, model_t):
    rgb, ir = _inputs()
    seg_j, taps_j, cert_j = model_j.apply(variables, jnp.asarray(rgb),
                                          jnp.asarray(ir), train=False)
    with torch.no_grad():
        seg_t, taps_t, cert_t = model_t(torch.from_numpy(rgb),
                                        torch.from_numpy(ir))
    assert cert_j is None and cert_t is None
    assert seg_t.dtype == torch.float32 and seg_t.shape == (2, 64, 96, 13)
    np.testing.assert_allclose(seg_t.numpy(), np.asarray(seg_j),
                               rtol=1e-3, atol=2e-3)
    assert len(taps_t) == len(taps_j) == 6
    for i, (tt, tj) in enumerate(zip(taps_t, taps_j)):
        np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=1e-3,
                                   atol=2e-3, err_msg=f"critic tap {i}")


def test_forward_matches_jax(small):
    _check_forward(*small)


def test_prefused_input_equals_two_modalities(small):
    _, _, model_t = small
    rgb, ir = _inputs()
    with torch.no_grad():
        a = model_t(torch.from_numpy(rgb), torch.from_numpy(ir))[0]
        b = model_t(torch.from_numpy(np.concatenate([rgb, ir], -1)))[0]
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_state_dict_round_trip_hits_every_jax_leaf(small):
    _, variables, model_t = small
    p_flat, s_flat = convert_state_dict(model_t.state_dict())
    for tree, flat in ((variables["params"], p_flat),
                       (variables["batch_stats"], s_flat)):
        want = _flatten(tree)
        assert set(flat) == set(want), (sorted(set(want) ^ set(flat))[:8])
        for k, v in want.items():
            np.testing.assert_array_equal(flat[k], np.asarray(v), err_msg=k)


def test_registry_and_unported_variants():
    m = get_model("net_resnext50")
    assert [len(getattr(m, f"mod{i}_1")) for i in (2, 3, 4, 5)] == [3, 4, 6, 3]
    # late fusion and the 7x7 stem are ported (tests/test_torch_late_fusion.py
    # holds them to JAX): two stems and two mod2 stages, or a BN-free stem
    late = ResNeXtSeg(structure=(1, 1, 1, 1), late_fusion=True)
    assert late.mod1_2.conv1.in_channels == 1 and hasattr(late, "mod2_2")
    assert late.mod3_1.block1.bn1.bn.num_features == 512
    vistas = ResNeXtSeg(structure=(1, 1, 1, 1), input_3x3=False)
    assert vistas.mod1.conv1.kernel_size == (7, 7) and not hasattr(vistas.mod1, "bn1")
    # the cert branch is ported (tests/test_torch_critics.py holds it to JAX)
    assert hasattr(ResNeXtSeg(structure=(1, 1, 1, 1), cert_branch=True),
                   "fuse_seg_cert")
    assert len(get_model("net_resnext101").mod4_1) == 23
    with pytest.raises(KeyError):
        get_model("nope")


@pytest.mark.slow
def test_full_depth_forward_matches_jax():
    _check_forward(*_pair((3, 4, 6, 3)))
