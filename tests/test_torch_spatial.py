"""Height-sharded serving (``parallel/spatial.py``, ``spatial_sharding``) on the CPU.

The counterpart of ``tests/test_mesh.py::test_spatial_sharding_matches_unsharded``:
JAX's ``ResNeXtSeg(structure=(1,1,1,1))`` in float32 (numpy weights,
``numpy_init``) serves one numpy-seeded 1x128x64 raw frame unsharded
(``_device_normalize``, then the model); its weights reach the port through
``state_dict_from_jax``. Four gloo processes (``torch_spatial_worker.py``,
launched once for the module as ``torchrun`` would, with a time limit) serve
the frame split by rows over 4 and over 2 of them (``serve_frame``: raw rows,
ingest, the model under ``spatial_parallel``, argmax), for early fusion with
3 and 4 input channels and late fusion with the cert branch. At 4 shards a
shard holds 4 rows at stride 8, so ASPP's halos (12, 24, 36 rows) span
several shards and run past the frame.

- the gathered logits (and cert map) against JAX's at rtol 1e-3 / atol
  2e-3 (the repo's parity tolerance), and against the port's own unsharded
  forward at rtol/atol 1e-5 (JAX's tolerance for sharding,
  ``tests/test_mesh.py:185``);
- the gathered class maps equal JAX's argmax, except where JAX's own top-2
  logits are within 1e-3;
- ``halo_rows`` at halos smaller than, equal to and larger than a shard,
  ``fill`` beyond the frame;
- on one process: ``shard_rows``/``gather_rows`` against JAX's placement,
  and the refusals under the context (train mode, a height that is not a
  multiple of 8·n, PSPNet).
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from heatnet_tpu.eval.validate import _device_normalize
from heatnet_tpu.models import ResNeXtSeg as JaxResNeXtSeg
from heatnet_tpu.parallel import mesh as jax_mesh
from heatnet_tpu_torch.io.from_jax import state_dict_from_jax
from heatnet_tpu_torch.models import ResNeXtSeg, build_network
from heatnet_tpu_torch.models.layers import prepare_for_inference
from heatnet_tpu_torch.parallel import mesh as pm
from heatnet_tpu_torch.parallel import spatial

import torch_spatial_worker as worker
from test_torch_late_fusion import japply, numpy_init

torch.set_num_threads(2)

H, W = 128, 64
NEAR_TIE = 1e-3


def _frames():
    rng = np.random.RandomState(0)
    return {"rgb": rng.randint(0, 256, (1, H, W, 3)).astype(np.uint8),
            "ir": rng.randint(21000, 26000, (1, H, W, 1)).astype(np.uint16)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """JAX's unsharded outputs per case, and the 4 workers' results."""
    work = tmp_path_factory.mktemp("spatial")
    frames = _frames()
    np.savez(work / "frames.npz", **frames)
    models = {}
    for name, (kw, modalities) in worker.CASES.items():
        m_j = JaxResNeXtSeg(structure=worker.TINY, dtype=jnp.float32, **kw)
        keys = ["rgb"] + (["ir"] if "ir" in modalities else [])
        ins = [np.asarray(_device_normalize(jnp.asarray(frames[k]))) for k in keys]
        v = numpy_init(m_j, *ins)
        models[name] = (m_j, v, ins)
        torch.save(state_dict_from_jax(v["params"], v.get("batch_stats")),
                   work / f"{name}.pt")

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, WORLD_SIZE="4", MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()),
               PYTHONPATH=os.pathsep.join([here, os.path.dirname(here),
                                           os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, os.path.join(here, "torch_spatial_worker.py"),
                               str(work)], env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    logs, want = [], {}
    try:
        for name, (m_j, v, ins) in models.items():  # while the workers run
            seg, _, cert = japply(m_j, v, *ins)
            want[name] = (np.asarray(seg), None if cert is None else np.asarray(cert))
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return want, dict(np.load(work / "spatial.npz"))


SERVED = [(name, n) for name in worker.CASES for n in worker.SHARDS]


def _ids(case):
    return f"{case[0]}-{case[1]}shards"


@pytest.mark.parametrize("case", SERVED, ids=_ids)
def test_sharded_logits_equal_jax_unsharded(run, case):
    name, n = case
    want, got = run
    seg_j, cert_j = want[name]
    np.testing.assert_allclose(got[f"{name}/{n}/seg"], seg_j, rtol=1e-3, atol=2e-3)
    if cert_j is not None:
        np.testing.assert_allclose(got[f"{name}/{n}/cert"], cert_j, rtol=1e-3, atol=2e-3)


@pytest.mark.parametrize("case", SERVED, ids=_ids)
def test_sharded_logits_equal_the_ports_unsharded(run, case):
    name, n = case
    _, got = run
    for what in ("seg", "cert"):
        if f"{name}/1/{what}" in got:
            np.testing.assert_allclose(got[f"{name}/{n}/{what}"], got[f"{name}/1/{what}"],
                                       rtol=1e-5, atol=1e-5, err_msg=what)
    assert f"{name}/1/seg" in got and (f"{name}/1/cert" in got) == (name == "late_cert")


@pytest.mark.parametrize("case", SERVED, ids=_ids)
def test_sharded_class_map_equals_jax_but_at_near_ties(run, case):
    name, n = case
    want, got = run
    seg_j = want[name][0]
    pred = got[f"{name}/{n}/pred"]
    assert pred.shape == (1, H, W) and pred.dtype == np.uint8
    top2 = np.sort(seg_j, axis=-1)[..., -2:]
    tie = (top2[..., 1] - top2[..., 0]) < NEAR_TIE
    differ = pred != seg_j.argmax(-1)
    assert not (differ & ~tie).any(), int((differ & ~tie).sum())


@pytest.mark.parametrize("halo", worker.HALOS, ids=lambda h: h[0])
def test_halo_rows_take_the_neighbours_rows_and_fill_beyond_the_frame(run, halo):
    name, above, below = halo
    x = worker.halo_input()
    rows = worker.HALO_SHAPE[2] // 4
    padded = np.pad(x, ((0, 0), (0, 0), (above, below), (0, 0)),
                    constant_values=worker.HALO_FILL)
    got = run[1][f"halo/{name}"]
    assert got.shape == (4,) + x.shape[:2] + (above + rows + below, x.shape[3])
    for r in range(4):
        np.testing.assert_array_equal(got[r], padded[:, :, r * rows:(r + 1) * rows + above + below])


@pytest.fixture
def one_process(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    yield pm.create_mesh()
    if dist.is_initialized():
        dist.destroy_process_group()


def test_spatial_sharding_places_rows_as_jax(one_process):
    x = np.arange(2 * 16 * 3 * 2).reshape(2, 16, 3, 2).astype(np.float32)
    sharded = jax.device_put(jnp.asarray(x), jax_mesh.spatial_sharding(
        jax_mesh.create_mesh(num_devices=2)))

    class TwoByOne:  # data rank r of a (2, 1) mesh
        mesh_dim_names = ("data", "model")

        def __init__(self, r):
            self.r = r

        def size(self, dim):
            return (2, 1)[dim]

        def get_coordinate(self):
            return [self.r, 0]

        def get_local_rank(self, name):
            return self.r

    for r in range(2):
        want = next(np.asarray(s.data) for s in sharded.addressable_shards
                    if s.index[1].start == 8 * r)
        np.testing.assert_array_equal(pm.shard_rows(x, pm.spatial_sharding(TwoByOne(r))), want)
    one = pm.spatial_sharding(one_process)
    assert (one.size, one.rank, pm.HEIGHT_AXIS) == (1, 0, 1)
    t = torch.from_numpy(x)
    assert torch.equal(pm.gather_rows(pm.shard_rows(t, one), one), t)
    with spatial.spatial_parallel(one_process):
        assert spatial.spatial_group() is not None
        h = spatial.halo_rows(t.permute(0, 3, 1, 2), 2, 1, fill=5.0)
    assert spatial.spatial_group() is None
    assert (h[:, :, :2] == 5).all() and (h[:, :, -1:] == 5).all()
    assert torch.equal(h[:, :, 2:-1], t.permute(0, 3, 1, 2))


def _tiny_model():
    model = ResNeXtSeg(structure=worker.TINY, input_channels=3)
    return prepare_for_inference(model, torch.device("cpu"))


def test_train_mode_raises_under_the_context(one_process):
    model = _tiny_model().train()
    x = torch.zeros(1, 64, 32, 3)
    with spatial.spatial_parallel(one_process), pytest.raises(NotImplementedError,
                                                             match="train-mode BatchNorm"):
        model(x)


def test_a_height_not_a_multiple_of_8n_raises(one_process):
    frames = {"rgb": np.zeros((1, 60, 32, 3), np.uint8)}
    with pytest.raises(ValueError, match="not a multiple of 8"):
        spatial.serve_frame(_tiny_model(), frames, one_process, "cpu", "rgb")
    with spatial.spatial_parallel(one_process), pytest.raises(ValueError,
                                                             match="does not split"):
        _tiny_model()(torch.zeros(1, 36, 32, 3))  # mod3's stride-2 1x1s on 9 rows


def test_pspnet_raises_under_the_context(one_process):
    model = prepare_for_inference(build_network("resnet18"), torch.device("cpu"))
    with torch.no_grad(), spatial.spatial_parallel(one_process), \
            pytest.raises(NotImplementedError, match="adaptive pool"):
        model(torch.zeros(1, 64, 64, 3))
