"""The supervised train step split by rows (``parallel/spatial.py::train_frames``) on the CPU.

The counterpart of JAX's ``make_train_step`` on a batch placed by
``spatial_sharding`` (``heatnet_tpu/train/supervised.py:73-75``: the
sharding of the inputs decides the parallelism). Four gloo processes
(``torch_spatial_train_worker.py``, launched once for the module as
``torchrun`` would, with a time limit) train on numpy-seeded 2x128x64
batches split by rows over 4 and over 2 of them: at 4 shards a shard holds
4 rows at stride 8, so ASPP's halos (12, 24, 36 rows) span several shards
and run past the frame, and PSPNet's pyramid bins straddle shards.

- (a) ResNeXtSeg (1,1,1,1), early fusion with 4 channels, float32, weights
  from JAX's (``numpy_init``, through ``state_dict_from_jax``), Adam at lr
  1e-6, 3 steps against JAX's ``make_train_step`` on the batches placed by
  ``spatial_sharding(create_mesh(num_devices=4))``, under the repo's step
  contract (``tests/test_train_parity.py:199-240``): losses rtol 2e-3 /
  atol 2e-4, step-0 gradients rel L2 < 0.05 per tensor of norm >= 1e-4
  (ASPP's ``conv5``, which normalises the replicated global pool in train
  mode, among them), eval logits after the steps 5e-3;
- (b) float64 over 4 processes against the port's own unsharded step (one
  SGD step, run by an idle rank): the loss, accuracy, every gradient,
  updated parameter and running statistic within 1e-5 of each tensor's
  largest |value| (as the data-parallel test of
  ``tests/test_torch_mesh.py``), for early fusion, late fusion with the cert
  branch (the cert map read by the loss), ``bn_groups=2`` at batch 4 and
  ``HEATNET_BN_IMPL=lean``; every process's parameters and buffers equal
  after each step. A missing halo or pool gradient moves gradients by their
  own size;
- (c) PSPNet-ResNet-18, RGB only, as (a) with JAX's dropout masks (drawn
  as ``jax_dropout_masks`` draws them, from the step's folded key), and in
  float64 as (b);
- (d) the gradients of ``halo_rows`` (at ``torch_spatial_worker.HALOS``:
  halos smaller than, equal to and larger than a shard, ``fill`` and
  ``replicate``), ``global_mean`` and ``frame_pool`` (sizes 1, 2, 3, 6)
  of each rank's seeded linear function of its output, against autograd of
  the sum of those functions through the gathered frame;
- on one process: every PSPNet backend of ``build_network``, a train-mode
  forward and backward under the context against the unsharded one.
"""

import concurrent.futures
import contextlib
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
import torch.nn.functional as F
from flax import linen as nn

from heatnet_tpu.models import ResNeXtSeg as JaxResNeXtSeg
from heatnet_tpu.models.registry import build_network as jax_build_network
from heatnet_tpu.parallel import mesh as jax_mesh
from heatnet_tpu.train.optim import create_optimizer as jax_create_optimizer
from heatnet_tpu.train.state import TrainState as JaxTrainState
from heatnet_tpu.train.supervised import cross_entropy_ignore as jax_ce
from heatnet_tpu.train.supervised import make_train_step as jax_train_step
from heatnet_tpu_torch.io.from_jax import state_dict_from_jax
from heatnet_tpu_torch.models import build_network
from heatnet_tpu_torch.models.layers import init_params, prepare_for_training
from heatnet_tpu_torch.parallel import mesh as pm
from heatnet_tpu_torch.parallel import spatial

import torch_spatial_train_worker as worker
import torch_spatial_worker as serving
from test_torch_late_fusion import japply, numpy_init

torch.set_num_threads(2)

DROPOUT_KEY = 11
F64_TOL = 1e-5
# a gradient that is zero but for float64 rounding (a conv bias before a
# train-mode BN, which removes it) is compared to this share of the model's
# largest gradient
F64_NOISE = 1e-12


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_model(name):
    arch, kw, _, _ = worker.JAX_CASES[name]
    if arch == "pspnet":
        return jax_build_network(dtype=jnp.float32, **kw)
    return JaxResNeXtSeg(structure=worker.TINY, dtype=jnp.float32, **kw)


def _jax_steps(name, m_j, variables, work):
    """JAX's step on the batches placed by ``spatial_sharding``: the losses,
    the step-0 gradients (written to ``<name>_grads.pt`` under the port's
    names) and the eval logits of the held-out batch after the steps."""
    _, _, channels, seed = worker.JAX_CASES[name]
    psp = name == "psp"
    mesh = jax_mesh.create_mesh(num_devices=4)
    sharding = jax_mesh.spatial_sharding(mesh)
    data = [{"image": jax.device_put(jnp.asarray(x), sharding),
             "label": jax.device_put(jnp.asarray(y, jnp.int32), sharding)}
            for x, y in worker.batches(worker.STEPS, 2, channels, seed)]
    key = jax.random.PRNGKey(DROPOUT_KEY)

    def loss_fn(params, batch):
        seg = m_j.apply({"params": params, "batch_stats": variables["batch_stats"]},
                        batch["image"], None, train=True, mutable=["batch_stats"],
                        rngs={"dropout": jax.random.fold_in(key, 0)} if psp else None)[0][0]
        return jax_ce(seg, batch["label"])

    grads = jax.jit(jax.grad(loss_fn))(variables["params"], data[0])
    torch.save(state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads)),
               work / f"{name}_grads.tmp")
    os.replace(work / f"{name}_grads.tmp", work / f"{name}_grads.pt")
    # the state replicated over the mesh, as each step returns it: one compile
    state = jax.device_put(JaxTrainState.create(
        m_j.apply, variables["params"], variables["batch_stats"],
        jax_create_optimizer(worker.ADAM)), jax_mesh.replicated(mesh))
    step = jax_train_step(m_j, dropout_rng=key if psp else None)
    losses = []
    for batch in data:
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    seg = japply(m_j, {"params": state.params, "batch_stats": state.batch_stats},
                 worker.held_out(channels))[0]
    return {"loss": np.array(losses), "eval": np.asarray(seg)}


def _dropout_masks(m_j, variables, keys):
    """The keep masks of a train-mode apply with each dropout key of
    ``keys``, as ``test_torch_late_fusion.jax_dropout_masks`` draws them
    (each flax ``Dropout`` intercepted, its key drawn with ``make_rng``), but
    under jit: the masks depend on the keys and the shapes only, so one
    compile serves every step."""
    _, _, channels, seed = worker.JAX_CASES["psp"]
    x = jnp.asarray(worker.batches(1, 2, channels, seed)[0][0])

    def draw(key):
        masks = []

        def grab(next_fun, args, kwargs, context):
            mod = context.module
            if not isinstance(mod, nn.Dropout) or context.method_name != "__call__":
                return next_fun(*args, **kwargs)
            y, rng = args[0], mod.make_rng(mod.rng_collection)
            shape = [1 if d in mod.broadcast_dims else s for d, s in enumerate(y.shape)]
            keep = jax.random.bernoulli(rng, p=1.0 - mod.rate, shape=shape)
            masks.append(keep.reshape(y.shape[0], y.shape[-1]))
            return next_fun(*args, rng=rng, **kwargs)

        with nn.intercept_methods(grab):
            m_j.apply(variables, x, train=True, mutable=["batch_stats"],
                      rngs={"dropout": key})
        return masks

    fn = jax.jit(draw)
    return [tuple(torch.from_numpy(np.array(m)) for m in fn(k)) for k in keys]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """JAX's results per case and rank 0's record of the 4 workers."""
    work = tmp_path_factory.mktemp("spatial_train")
    models = {}
    for name, (_, _, channels, seed) in worker.JAX_CASES.items():
        m_j = _jax_model(name)
        v = numpy_init(m_j, jnp.asarray(worker.batches(1, 2, channels, seed)[0][0]))
        models[name] = (m_j, v)
        torch.save(state_dict_from_jax(v["params"], v["batch_stats"]), work / f"{name}.pt")

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, WORLD_SIZE="4", MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()),
               PYTHONPATH=os.pathsep.join([here, os.path.dirname(here),
                                           os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, os.path.join(here,
                                                            "torch_spatial_train_worker.py"),
                               str(work)], env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    logs, want = [], {}
    try:  # while the workers run: JAX's masks first, then its steps
        m_j, v = models["psp"]
        key = jax.random.PRNGKey(DROPOUT_KEY)
        masks = _dropout_masks(m_j, v, [jax.random.fold_in(key, i)
                                        for i in range(worker.STEPS)])
        torch.save(masks, work / "psp_masks.tmp")
        os.replace(work / "psp_masks.tmp", work / "psp_masks.pt")
        with concurrent.futures.ThreadPoolExecutor(len(models)) as pool:  # compiles overlap
            futures = {name: pool.submit(_jax_steps, name, m_j, v, work)
                       for name, (m_j, v) in models.items()}
            want = {name: f.result() for name, f in futures.items()}
        for p in procs:
            logs.append(p.communicate(timeout=360)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return want, dict(np.load(work / "train.npz"))


JAX_RUNS = [(name, n) for name in worker.JAX_CASES for n in worker.SHARDS]
F64_RUNS = [(name, 4) for name in worker.F64]


def _ids(case):
    return f"{case[0]}-{case[1]}shards"


@pytest.mark.parametrize("case", JAX_RUNS, ids=_ids)
def test_steps_by_rows_match_jax_steps_on_the_spatially_sharded_batch(run, case):
    name, n = case
    want, got = run
    key = f"{name}/{n}"
    np.testing.assert_allclose(got[f"{key}/loss"], want[name]["loss"], rtol=2e-3, atol=2e-4)
    assert got[f"{key}/replicas_equal"].all()
    names, err, norm = got[f"{key}/names"], got[f"{key}/rel_l2"], got[f"{key}/norm"]
    held = norm >= 1e-4
    bad = [(k, e) for k, e, h in zip(names, err, held) if h and not e < 0.05]
    assert not bad, bad
    assert held.sum() > (40 if name == "psp" else 50)  # the whole tree, not a token few
    if name == "resnext":  # ASPP's global branch: BN over the replicated pooled map
        assert "aspp.conv5.conv1.weight" in names[held]
    np.testing.assert_allclose(got[f"{key}/eval"], want[name]["eval"], rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("case", F64_RUNS, ids=_ids)
def test_float64_step_by_rows_equals_the_unsharded_step(run, case):
    name, n = case
    got = run[1]
    key = f"{name}/{n}"
    np.testing.assert_allclose(got[f"{key}/loss"], got[f"{key}/loss_unsharded"],
                               rtol=F64_TOL, atol=0)
    np.testing.assert_allclose(got[f"{key}/accuracy"], got[f"{key}/accuracy_unsharded"],
                               rtol=0, atol=1e-12)
    assert got[f"{key}/replicas_equal"].all()
    names, diff, scale = got[f"{key}/names"], got[f"{key}/diff"], got[f"{key}/scale"]
    largest = max(s for k, s in zip(names, scale) if k.startswith("grad/"))
    bound = np.maximum(F64_TOL * scale, F64_NOISE * largest)
    bad = [(k, d, s) for k, d, s, b in zip(names, diff, scale, bound) if not d <= b]
    assert not bad, bad
    kinds = {k.split("/")[0] for k in names}
    assert kinds == {"grad", "param", "buffer"} and len(names) > 150
    if name == "late_cert":  # the cert branch trains by rows too
        grads = {k: s for k, s in zip(names, scale) if k.startswith("grad/")}
        assert grads["grad/net.aspp.final_conv2.conv1.weight"] > 1e-6


@pytest.mark.parametrize("halo", serving.HALOS, ids=lambda h: h[0])
def test_halo_rows_send_each_halo_gradient_to_the_rank_that_owns_the_row(run, halo):
    name, above, below, replicate = halo
    x = torch.from_numpy(serving.halo_input()).double().requires_grad_()
    rows = serving.HALO_SHAPE[2] // 4
    if replicate:
        padded = torch.cat([x[:, :, :1].expand(-1, -1, above, -1), x,
                            x[:, :, -1:].expand(-1, -1, below, -1)], 2)
    else:
        fill = torch.full((1,), serving.HALO_FILL, dtype=x.dtype)
        padded = torch.cat([fill.expand(*x.shape[:2], above, x.shape[3]), x,
                            fill.expand(*x.shape[:2], below, x.shape[3])], 2)
    total = 0
    for r in range(4):
        y = padded[:, :, r * rows:(r + 1) * rows + above + below]
        total = total + (y * worker.weight_of(r, y.shape)).sum()
    total.backward()
    got = run[1][f"halo/{name}"]
    np.testing.assert_allclose(np.concatenate(list(got), 2), x.grad.numpy(),
                               rtol=1e-12, atol=1e-12)
    assert int(run[1][f"halo/{name}/bwd_calls"]) == 1


@pytest.mark.parametrize("what", ["global_mean"] + [f"pool/{s}" for s in worker.POOL_SIZES])
def test_global_mean_and_frame_pool_send_the_summed_gradient_to_every_shard(run, what):
    x = torch.from_numpy(serving.halo_input()).double().requires_grad_()
    total = 0
    for r in range(4):
        y = (x.mean(dim=(2, 3), keepdim=True) if what == "global_mean"
             else F.adaptive_avg_pool2d(x, int(what.split("/")[1])))
        total = total + (y * worker.weight_of(r, y.shape)).sum()
    total.backward()
    got = run[1][what]
    np.testing.assert_allclose(np.concatenate(list(got), 2), x.grad.numpy(),
                               rtol=1e-12, atol=1e-12)


@pytest.fixture
def one_process(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    yield pm.create_mesh()
    if dist.is_initialized():
        dist.destroy_process_group()


BACKENDS = [("squeezenet", False), ("densenet", False), ("resnet18", False),
            ("resnet34", False), ("resnet50", False), ("resnet101", False),
            ("resnet152", False), ("resnet18", True)]


@pytest.mark.parametrize("backend,late_fusion", BACKENDS,
                         ids=[b + ("_late" if lf else "") for b, lf in BACKENDS])
def test_every_pspnet_backend_trains_under_the_context_as_unsharded(one_process, backend,
                                                                    late_fusion):
    """A mesh of one process, in float64: the train-mode forward and backward
    through the windows, the frame pool and the frame-sized resize (the
    exchanges local) give the unsharded logits, running statistics and
    gradients, each within 1e-9 of the tensor's largest |value| (a
    gradient that is zero but for rounding: ``F64_NOISE`` of the largest)."""
    model = build_network(backend, in_channels=4 if late_fusion else 3,
                          late_fusion=late_fusion)
    init_params(model, torch.Generator().manual_seed(0))
    model = prepare_for_training(model, torch.device("cpu"), torch.float64).double()
    rng = np.random.RandomState(2)
    ins = [torch.from_numpy(rng.rand(2, 24, 16, c) * 2 - 1)
           for c in ((3, 1) if late_fusion else (3,))]
    masks = model.draw_dropout(2, torch.Generator().manual_seed(1))
    weight = torch.from_numpy(rng.randn(2, 24, 16, 13))
    start = {k: v.clone() for k, v in model.state_dict().items()}
    outs = []
    for ctx in (False, True):
        model.load_state_dict(start)
        model.zero_grad(set_to_none=True)
        with spatial.spatial_parallel(one_process) if ctx else contextlib.nullcontext():
            seg = model(*ins, dropout=masks)[0]
        (seg * weight).sum().backward()
        outs.append({"seg": seg.detach(),
                     **{f"buffer/{k}": b.clone() for k, b in model.named_buffers()},
                     **{f"grad/{k}": p.grad.clone() for k, p in model.named_parameters()
                        if p.grad is not None}})
    want, got = outs
    assert got["seg"].shape == (2, 24, 16, 13)
    assert set(got) == set(want) and sum(k.startswith("grad/") for k in want) > 20
    largest = max(float(v.abs().max()) for k, v in want.items() if k.startswith("grad/"))
    for k, v in want.items():
        bound = max(1e-9 * float(v.abs().max()), F64_NOISE * largest)
        assert float((got[k] - v).abs().max()) <= bound, k
