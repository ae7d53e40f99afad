"""Height-sharded serving (``parallel/spatial.py``, ``spatial_sharding``) on the CPU.

The counterpart of ``tests/test_mesh.py::test_spatial_sharding_matches_unsharded``:
JAX's ``ResNeXtSeg(structure=(1,1,1,1))`` and PSPNet-ResNet-18 in float32
(numpy weights, ``numpy_init``) serve one numpy-seeded 1x128x64 raw frame
unsharded (``_device_normalize``, then the model); their weights reach the
port through ``state_dict_from_jax``. Four gloo processes
(``torch_spatial_worker.py``, launched once for the module as ``torchrun``
would, with a time limit) serve the frame split by rows over 4 and over 2 of
them (``serve_frame``: raw rows, ingest, the model under
``spatial_parallel``, argmax), for early fusion with 3 and 4 input channels,
late fusion with the cert branch, and PSPNet RGB-only and in late fusion. At
4 shards a shard holds 4 rows at stride 8, so ASPP's halos (12, 24, 36 rows)
span several shards and run past the frame, and PSPNet's pyramid bins of 3
and 6 (over the frame's 16 rows) straddle shards.

- the gathered logits (and cert map) against JAX's at rtol 1e-3 / atol
  2e-3 (the repo's parity tolerance), and against the port's own unsharded
  forward at rtol/atol 1e-5 (JAX's tolerance for sharding,
  ``tests/test_mesh.py:185``);
- the gathered class maps equal JAX's argmax, except where JAX's own top-2
  logits are within 1e-3;
- the int8 segnet (early fusion, ``min_batch`` 2 and ``max_hw`` 4096, so that
  the frame's stem conv is float while a full-resolution shard would
  quantize: ``torch_spatial_worker.INT8``): at batch 1 the float model served
  by rows bit for bit; at batch 2, calibrated by rows (``calibrate_frame``),
  the unsharded calibration's scales (rtol 1e-6) and its int8 logits (1e-5);
  served on JAX's scales (calibrated unsharded at batch 1, on float outputs,
  as ``tests/test_torch_int8.py`` does), JAX's int8 logits within 2e-2 of
  the largest |logit| (that file's tolerance: BN's f32 arithmetic differs
  between the frameworks by an ulp, which can move a value across a
  quantization step);
- ``halo_rows`` at halos smaller than, equal to and larger than a shard,
  ``fill`` or the frame's edge rows beyond the frame; ``all_reduce_max``
  over the 4 processes;
- on one process: ``shard_rows``/``gather_rows`` against JAX's placement,
  every PSPNet backend of ``build_network`` under the context against its
  own unsharded forward, the frame pool and the frame-sized resize against
  PyTorch's, the train step by rows equal to the unsharded step, instance
  norms and integer resizes equal to the unsharded ones, and the refusals
  under the context (the int8 layers in train mode, pools to other sizes,
  resizes by other factors, convs padded other than with zeros, a height
  that is not a multiple of 8·n). Training by rows over several processes:
  ``tests/test_torch_spatial_train.py``; the adversarial and CycleGAN steps:
  ``tests/test_torch_spatial_adversarial.py``.
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
import torch.nn.functional as F

from heatnet_tpu.eval.validate import _device_normalize
from heatnet_tpu.models import ResNeXtSeg as JaxResNeXtSeg
from heatnet_tpu.models.registry import build_network as jax_build_network
from heatnet_tpu.ops.quant import calibrate_int8 as jax_calibrate
from heatnet_tpu.parallel import mesh as jax_mesh
from heatnet_tpu_torch.io.from_jax import state_dict_from_jax
from heatnet_tpu_torch.models import ResNeXtSeg, build_network
from heatnet_tpu_torch.models import layers as L
from heatnet_tpu_torch.models.layers import init_params, prepare_for_inference
from heatnet_tpu_torch.ops.quant import convert_int8
from heatnet_tpu_torch.parallel import mesh as pm
from heatnet_tpu_torch.parallel import spatial
from heatnet_tpu_torch.train.optim import create_optimizer
from heatnet_tpu_torch.train.state import TrainState
from heatnet_tpu_torch.train.supervised import make_train_step

import torch_spatial_worker as worker
from test_torch_late_fusion import japply, numpy_init

torch.set_num_threads(2)

H, W = 128, 64
NEAR_TIE = 1e-3


def _frames(n=1, seed=0):
    rng = np.random.RandomState(seed)
    return {"rgb": rng.randint(0, 256, (n, H, W, 3)).astype(np.uint8),
            "ir": rng.randint(21000, 26000, (n, H, W, 1)).astype(np.uint16)}


def _jax_model(arch, kw):
    if arch == "pspnet":
        return jax_build_network(dtype=jnp.float32, **kw)
    return JaxResNeXtSeg(structure=worker.TINY, dtype=jnp.float32, **kw)


def _normalized(frames, modalities):
    keys = ["rgb"] + (["ir"] if "ir" in modalities else [])
    return [np.asarray(_device_normalize(jnp.asarray(frames[k]))) for k in keys]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _int8_env(mp):
    for k, v in (("HEATNET_QUANT", "int8"),
                 ("HEATNET_INT8_MIN_BATCH", str(worker.INT8["min_batch"])),
                 ("HEATNET_QUANT_MAX_HW", str(worker.INT8["max_hw"]))):
        mp.setenv(k, v)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """JAX's unsharded outputs per case and its int8 logits on its own
    scales, and the 4 workers' results."""
    work = tmp_path_factory.mktemp("spatial")
    frames, frames2 = _frames(), _frames(2, seed=1)
    np.savez(work / "frames.npz", **frames)
    np.savez(work / "frames_int8.npz", **frames2)
    models = {}
    for name, (arch, kw, modalities) in list(worker.CASES.items()) + [
            ("int8", ("resnext", {"input_channels": 4}, "ir_rgb"))]:
        m_j = _jax_model(arch, kw)
        ins = _normalized(frames, modalities)
        v = numpy_init(m_j, *ins)
        models[name] = (m_j, v, ins)
        torch.save(state_dict_from_jax(v["params"], v.get("batch_stats")),
                   work / f"{name}.pt")
    int8_variables = models.pop("int8")[1]

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
    try:  # while the workers run: JAX's scales first, for the workers' last part
        mp = pytest.MonkeyPatch()
        try:
            _int8_env(mp)
            m_j = JaxResNeXtSeg(structure=worker.TINY, dtype=jnp.float32, input_channels=4)
            v = jax_calibrate(m_j.apply, int8_variables,
                              [tuple(map(jnp.asarray, _normalized(frames, "ir_rgb")))],
                              train=False)
            torch.save(state_dict_from_jax(v["params"], v["batch_stats"], quant=v["quant"]),
                       work / "jax_scales.tmp")
            os.replace(work / "jax_scales.tmp", work / "jax_scales.pt")
            want["int8"] = np.asarray(japply(m_j, v, *_normalized(frames2, "ir_rgb"))[0])
        finally:
            mp.undo()
        for name, (m_j, v, ins) in models.items():
            seg, _, cert = japply(m_j, v, *ins)
            want[name] = (np.asarray(seg), None if cert is None else np.asarray(cert))
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
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
    name, above, below, replicate = halo
    x = worker.halo_input()
    rows = worker.HALO_SHAPE[2] // 4
    pad = ((0, 0), (0, 0), (above, below), (0, 0))
    padded = (np.pad(x, pad, mode="edge") if replicate
              else np.pad(x, pad, constant_values=worker.HALO_FILL))
    got = run[1][f"halo/{name}"]
    assert got.shape == (4,) + x.shape[:2] + (above + rows + below, x.shape[3])
    for r in range(4):
        np.testing.assert_array_equal(got[r], padded[:, :, r * rows:(r + 1) * rows + above + below])


def test_all_reduce_max_over_4_gloo_processes(run):
    got = run[1]["all_reduce_max"]
    want = np.stack([worker.max_input(r) for r in range(4)]).max(0)
    assert got.shape == (4,) + want.shape
    for r in range(4):  # every rank holds the max
        np.testing.assert_array_equal(got[r], want)


@pytest.mark.parametrize("n", worker.SHARDS, ids=lambda n: f"{n}shards")
def test_int8_segnet_at_batch_1_by_rows_is_the_float_model_bit_for_bit(run, n):
    got = run[1]
    assert got[f"int8/{n}/b1_int8"].shape == (1, H, W, 13)
    np.testing.assert_array_equal(got[f"int8/{n}/b1_int8"], got[f"int8/{n}/b1_float"])


@pytest.mark.parametrize("n", worker.SHARDS, ids=lambda n: f"{n}shards")
def test_int8_calibrated_by_rows_has_the_unsharded_scales(run, n):
    got = run[1]
    names = list(got["int8/names"])
    want = got["int8/1/scales"]
    # the stem's first conv sees the frame's 8192 > max_hw pixels: float, no
    # scale, though a shard's rows (2048 or 4096 pixels) are within max_hw
    assert want[names.index("mod1.conv1")] == 0.0
    assert (np.delete(want, names.index("mod1.conv1")) > 0).all()
    np.testing.assert_allclose(got[f"int8/{n}/scales"], want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("n", worker.SHARDS, ids=lambda n: f"{n}shards")
def test_int8_served_by_rows_equals_the_unsharded_int8_forward(run, n):
    got = run[1]
    assert got["int8/1/seg"].shape == (2, H, W, 13)
    np.testing.assert_allclose(got[f"int8/{n}/seg"], got["int8/1/seg"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", worker.SHARDS, ids=lambda n: f"{n}shards")
def test_int8_by_rows_on_jax_scales_matches_jax_int8(run, n):
    want, got = run
    seg_j = want["int8"]
    seg = got[f"int8/{n}/seg_jax_scales"]
    tol = 2e-2 * np.abs(seg_j).max()
    assert seg.shape == seg_j.shape and np.abs(seg - seg_j).max() <= tol


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


def _tiny_step(mesh=None):
    """One SGD step of a (1,1,1,1) segnet on a seeded 2x64x32 batch,
    unsharded or by rows over ``mesh``: the loss, accuracy, gradients and
    state after it."""
    model = ResNeXtSeg(structure=worker.TINY, input_channels=3)
    init_params(model, torch.Generator().manual_seed(4))
    opt, sched = create_optimizer({"type": "SGD", "learning_rate": 1e-3}, model.parameters())
    grads = {}
    opt.register_step_pre_hook(lambda *_: grads.update(
        {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}))
    state = TrainState(model.train(), opt, sched)
    rng = np.random.RandomState(6)
    batch = {"image": torch.from_numpy(rng.rand(2, 64, 32, 3).astype(np.float32) * 2 - 1),
             "label": torch.from_numpy(rng.randint(0, 14, (2, 64, 32)))}
    if mesh is None:
        _, m = make_train_step(model)(state, batch)
    else:
        _, m = spatial.train_frames(make_train_step(model, mesh=mesh), state, batch, mesh)
    return m, grads, model.state_dict()


def test_the_step_under_the_context_equals_the_unsharded_step(one_process):
    """A mesh of one process: the step by rows (windows, the global pool and
    BN, the exchanges local) is the unsharded step."""
    m0, g0, s0 = _tiny_step()
    m1, g1, s1 = _tiny_step(one_process)
    np.testing.assert_allclose(float(m1["loss"]), float(m0["loss"]), rtol=1e-6)
    assert float(m1["accuracy"]) == float(m0["accuracy"])
    assert set(g1) == set(g0) and len(g0) > 50
    for k, g in g0.items():
        np.testing.assert_allclose(g1[k].numpy(), g.numpy(), rtol=1e-4,
                                   atol=1e-4 * float(g.abs().max()) + 1e-8, err_msg=k)
    for k, v in s0.items():
        np.testing.assert_allclose(s1[k].numpy(), v.numpy(), rtol=1e-5, atol=1e-6, err_msg=k)


def test_an_int8_layer_in_train_mode_still_raises_and_names_itself(one_process):
    model = convert_int8(ResNeXtSeg(structure=worker.TINY, input_channels=3)).train()
    with spatial.spatial_parallel(one_process), pytest.raises(RuntimeError,
                                                             match="int8 layers serve"):
        model(torch.zeros(1, 64, 32, 3))


def test_a_height_not_a_multiple_of_8n_raises(one_process):
    frames = {"rgb": np.zeros((1, 60, 32, 3), np.uint8)}
    with pytest.raises(ValueError, match="not a multiple of 8"):
        spatial.serve_frame(_tiny_model(), frames, one_process, "cpu", "rgb")
    with spatial.spatial_parallel(one_process), pytest.raises(ValueError,
                                                             match="does not split"):
        _tiny_model()(torch.zeros(1, 36, 32, 3))  # mod3's stride-2 1x1s on 9 rows


BACKENDS = [("squeezenet", False), ("densenet", False), ("resnet18", False),
            ("resnet34", False), ("resnet50", False), ("resnet101", False),
            ("resnet152", False), ("resnet18", True)]


@pytest.mark.parametrize("backend,late_fusion", BACKENDS,
                         ids=[b + ("_late" if lf else "") for b, lf in BACKENDS])
def test_every_pspnet_backend_under_the_context_equals_unsharded(one_process, backend,
                                                                 late_fusion):
    """A mesh of one process: the rules apply (the windows, the frame pool,
    the frame-sized resize), the exchanges are local."""
    model = build_network(backend, in_channels=4 if late_fusion else 3,
                          late_fusion=late_fusion)
    init_params(model, torch.Generator().manual_seed(0))
    model = prepare_for_inference(model, torch.device("cpu"))
    rng = np.random.RandomState(2)
    ins = [torch.from_numpy(rng.rand(1, 48, 40, c).astype(np.float32) * 2 - 1)
           for c in ((3, 1) if late_fusion else (3,))]
    with torch.no_grad():
        want = model(*ins)[0]
        with spatial.spatial_parallel(one_process):
            got = model(*ins)[0]
    assert got.shape == (1, 48, 40, 13)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("size", [1, 2, 3, 6])
def test_frame_pool_and_frame_resize_equal_torch_on_one_process(one_process, size):
    x = torch.from_numpy(np.random.RandomState(size).randn(2, 5, 16, 9).astype(np.float32))
    x = x.contiguous(memory_format=torch.channels_last)
    with spatial.spatial_parallel(one_process):
        pooled = L.adaptive_avg_pool(x, (size, size), frame=True)
        resized = L.resize_bilinear(pooled, (16, 9), frame=True)
        up = L.resize_bilinear(x, (32, 18))
    np.testing.assert_allclose(pooled.numpy(), F.adaptive_avg_pool2d(x, size).numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(resized.numpy(), F.interpolate(
        pooled, size=(16, 9), mode="bilinear", align_corners=False).numpy(),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(up.numpy(), F.interpolate(
        x, size=(32, 18), mode="bilinear", align_corners=False).numpy(), rtol=1e-6, atol=1e-6)


def test_all_reduce_max_over_one_process_is_a_copy(one_process):
    group = pm.data_group(one_process)
    t = torch.tensor([1.0, -2.0, 3.0])
    got = pm.all_reduce_max(group, t)
    assert torch.equal(got, t) and got.data_ptr() != t.data_ptr()


REFUSED = {
    "pool_to_3": (lambda x: L.adaptive_avg_pool(x, (3, 3)), "adaptive pool of 8 rows to 3"),
    "resize_by_1.5": (lambda x: L.resize_bilinear(x, (12, 8)), "bilinear resize of 8 rows to 12"),
    "conv_reflect_padding": (lambda x: L.Conv2d(2, 2, 3, padding=1, padding_mode="reflect")(x),
                             "conv padded with 'reflect'"),
}


@pytest.mark.parametrize("what", list(REFUSED))
def test_a_refused_operation_raises_and_names_itself(one_process, what):
    """What stays refused by rows: pools whose bins straddle the shards,
    resizes by other than an integer factor, convs padded other than with
    zeros (the int8 layers in train mode: the test above)."""
    fn, match = REFUSED[what]
    x = torch.randn(1, 2, 8, 8)
    fn(x)  # served without the context
    with spatial.spatial_parallel(one_process), pytest.raises(NotImplementedError,
                                                             match=match):
        fn(x)


SERVED = {
    "instance_norm": lambda x: L.instance_norm(x),
    "downscale": lambda x: L.resize_bilinear(x, (4, 4)),
    "upsample_x4": lambda x: L.resize_bilinear(x, (32, 8)),
}


@pytest.mark.parametrize("what", list(SERVED))
def test_an_instance_norm_or_integer_resize_by_rows_equals_unsharded_on_one_process(
        one_process, what):
    """Once refused by rows, now served: over one process (the exchanges
    local) the unsharded result within 1e-6."""
    fn = SERVED[what]
    x = torch.randn(1, 2, 8, 8)
    with spatial.spatial_parallel(one_process):
        got = fn(x)
    np.testing.assert_allclose(got.numpy(), fn(x).numpy(), rtol=1e-6, atol=1e-6)
