"""``heatnet_tpu_torch/parallel/mesh.py`` and data parallelism on the CPU.

- One process: ``maybe_initialize_distributed`` is a no-op without the
  launcher's environment; ``create_mesh`` and ``mesh_for_batch`` give a
  ``(data, model)`` mesh of one; ``pad_batch_to`` equals JAX's (numpy and
  tensors); ``shard_batch`` takes the rows that JAX's ``shard_batch`` puts
  on each device of a 2-device mesh.
- Two gloo processes (``torch_mesh_worker.py``, launched as ``torchrun``
  would, with a time limit): the meshes' shapes, the idle-device warning,
  ``shard_params_tp``'s placement on a 1x2 mesh; one train step of a
  (1,1,1,1) ResNeXtSeg on batch 4 split 2 + 2 against one process on batch
  4 (``torch_mesh_cases.py``), with the default BN, with
  ``HEATNET_BN_IMPL=lean`` and with ``bn_groups`` 2 (a group per process):
  the loss at rtol 2e-3 / atol 2e-4, the accuracy the whole batch's, every
  parameter's update (SGD, so the gradient) and every running statistic at
  rtol 1e-5 (atol 1e-5 of the tensor's largest value: f32 sums in another
  order); a validator over the mesh (5 frames, batches of 2, the tail
  padded) gives one process's IoUs within 1e-9.
"""

import os
import socket
import subprocess
import sys
import warnings

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from heatnet_tpu.parallel import mesh as jax_mesh
from heatnet_tpu_torch.parallel import mesh as pm

import torch_mesh_cases as cases

torch.set_num_threads(2)


@pytest.fixture
def single(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_single_process_mesh(single):
    assert pm.maybe_initialize_distributed(torch.device("cpu")) is False
    assert not dist.is_initialized()
    mesh = pm.create_mesh()
    assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (1, 1)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # one process: nothing idles
        assert tuple(pm.mesh_for_batch(3).shape) == (1, 1)
    batch = {"x": np.arange(6).reshape(3, 2)}
    assert pm.shard_batch(mesh, batch) is batch


def test_pad_batch_to_and_shard_rows_equal_jax():
    batch = {"x": np.arange(3, dtype=np.float32), "y": np.arange(6).reshape(3, 2)}
    want, n_j = jax_mesh.pad_batch_to(batch, 8)
    got, n = pm.pad_batch_to(batch, 8)
    got_t, _ = pm.pad_batch_to({k: torch.from_numpy(v) for k, v in batch.items()}, 8)
    assert n == n_j == 3
    for k in batch:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
        np.testing.assert_array_equal(got_t[k].numpy(), np.asarray(want[k]))

    x = np.arange(8 * 3).reshape(8, 3)
    shards = jax_mesh.shard_batch(jax_mesh.create_mesh(num_devices=2), x).addressable_shards

    class TwoByOne:  # the rows of data rank r of a (2, 1) mesh
        mesh_dim_names = ("data", "model")

        def __init__(self, r):
            self.r = r

        def size(self, dim):
            return (2, 1)[dim]

        def get_local_rank(self, name):
            return self.r

    for r in range(2):
        want = next(np.asarray(s.data) for s in shards if s.index[0].start == 4 * r)
        np.testing.assert_array_equal(pm.shard_batch(TwoByOne(r), x), want)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_process_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, WORLD_SIZE="2", MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()),
               PYTHONPATH=os.pathsep.join([here, os.path.dirname(here),
                                           os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, os.path.join(here, "torch_mesh_worker.py"),
                               str(out)], env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return dict(np.load(out / "dp.npz"))


@pytest.mark.parametrize("impl", cases.IMPLS)
def test_two_process_step_equals_one_process_on_the_whole_batch(
        two_process_run, impl, monkeypatch):
    monkeypatch.setenv("HEATNET_BN_IMPL", impl)
    want = cases.train_step(impl)
    got = two_process_run
    np.testing.assert_allclose(got[f"{impl}/loss"], want[f"{impl}/loss"],
                               rtol=2e-3, atol=2e-4)
    # the whole batch's hits over its valid pixels, not this process's
    np.testing.assert_allclose(got[f"{impl}/accuracy"], want[f"{impl}/accuracy"],
                               rtol=0, atol=1e-12)
    compared = 0
    for k, v in want.items():
        if "/loss" in k or "/accuracy" in k:
            continue
        scale = float(np.abs(v).max()) if v.size else 0.0
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-5 * scale, err_msg=k)
        compared += 1
    assert compared > 100


def test_two_process_validation_equals_one_process(two_process_run):
    want = cases.validate()
    got = two_process_run["ious"]
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got[~np.isnan(got)], want[~np.isnan(want)], rtol=0, atol=1e-9)
