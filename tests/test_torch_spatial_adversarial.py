"""The adversarial steps and the CycleGAN steps split by rows
(``parallel/spatial.py::adversarial_frames`` and ``cyclegan_frames``) on the
CPU.

The counterpart of JAX's ``make_adversarial_steps`` and
``make_cyclegan_steps`` on a batch placed by ``spatial_sharding``
(``heatnet_tpu/parallel/mesh.py:207-217``: the sharding of the inputs
decides the parallelism, and GSPMD runs the instance norms, the critics'
resizes, the reflect pads and the output-padded transposed convs on the
split frame). Four gloo processes (``torch_spatial_adversarial_worker.py``,
launched once for the module as ``torchrun`` would, with a time limit) split
the frames over 4 and over 2 of them, while this process computes JAX's side
in two threads.

- (a) A (1,1,1,1) ``ConfSegnet`` with 2 ``cyclegan`` critics at 2x256x256
  (the least size whose 1/8 tap their five stride-2 convs take: at
  2x128x64 that tap's width reaches 0; over 4 processes the critics gather
  their maps whole at 1/32 of the full-size tap and at 1/4 of the 1/8 tap),
  ``--moddrop --irscale --smartirscale`` on the draws of JAX's key (every one
  on, the IR rectangles straddling the shards), weights from JAX's
  (``state_dict_from_jax``), RMSprop at lr 1e-6 under the halving schedule,
  critic / seg / critic, against JAX's steps on the batch placed by
  ``spatial_sharding`` over 4 CPU devices: the adversarial step contract of
  ``tests/test_torch_adversarial.py::test_alternating_steps_match_jax``
  (losses rtol 2e-3 / atol 2e-4, updates within 5 % elementwise on >= 95 %
  of the elements, the frozen side bit for bit on both sides).
- (b) In float64, the critic / seg / critic steps of a (1,1,1,1)
  ``ConfSegnet`` with 2 ``resnet18`` critics on the 4x32x32 batches of
  ``torch_dp_adversarial_cases`` (RMSprop at lr 1e-7) over 4 processes
  against the port's own unsharded steps: the input adapter with
  ``feedback_seg`` and the certainty loss, and the IR teacher with
  ``weight_ir_sup``, the seg step with every augmentation on. Every metric,
  gradient and running statistic within 1e-5 of each tensor's largest
  |value| (a gradient that is rounding only, such as a bias before an
  instance norm or a train-mode BN: 1e-12 of the model's largest), the
  replicas bit for bit after every step, the frozen side unchanged.
- (c) The CycleGAN g, d_a and d_b steps with one-block generators on
  1x128x128 frames, 3 rounds, against JAX's ``make_cyclegan_steps`` on the
  sharded batch, under the CycleGAN contract of
  ``tests/test_torch_cyclegan.py::test_three_rounds_of_steps_match_jax``
  (losses, step-0 gradients rel L2 < 0.05, updates, the fakes and netSeg's
  running statistics, the discriminators bit for bit across a generator
  step); and 2 rounds at 1x32x32 in float64 against the unsharded rounds, as
  (b).
- (d) The gradients of the new primitives (instance norm; resizes by 0.5x,
  2x, 4x and 32x; a map gathered whole where a stride-2 window or a 4x4
  stride-1 conv does not split it; the reflect halo for p = 1 and 3; the
  output-padded transposed conv) of each rank's seeded linear function of
  its output, against autograd through the whole frame, 1e-12.
"""

import concurrent.futures
import dataclasses
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from heatnet_tpu.models import ConfSegnet as JaxConfSegnet
from heatnet_tpu.models import ResNeXtSeg as JaxResNeXtSeg
from heatnet_tpu.models.cyclegan import Discriminator as JaxDiscriminator
from heatnet_tpu.models.cyclegan import Generator as JaxGenerator
from heatnet_tpu.parallel import mesh as jax_mesh
from heatnet_tpu.train import adversarial as ja
from heatnet_tpu.train import cyclegan as jc
from heatnet_tpu.train.optim import lambda_linear_decay as jax_linear_decay
from heatnet_tpu.train.optim import step_lr as jax_step_lr
from heatnet_tpu.train.state import init_model
from heatnet_tpu_torch.io.from_jax import state_dict_from_jax

import test_torch_adversarial as single
import test_torch_cyclegan as single_cg
import torch_spatial_adversarial_worker as worker

torch.set_num_threads(2)

WORKER_TIMEOUT_S = 400
SEG_KEY = 6  # JAX's draws from this key drop an IR rectangle and scale the IR


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _save(obj, path: str) -> None:
    torch.save(obj, path + ".tmp")
    os.replace(path + ".tmp", path)


def _tensors(tree, prefix: str = "") -> dict:
    return {prefix + k: v for k, v in state_dict_from_jax(tree).items()}


def _placed(mesh, batch: dict) -> dict:
    """The maps split by rows (``spatial_sharding``), the rest replicated."""
    return {k: jax.device_put(jnp.asarray(v), jax_mesh.spatial_sharding(mesh)
                              if np.ndim(v) >= 3 else jax_mesh.replicated(mesh))
            for k, v in batch.items()}


def _jax_adversarial(work: str) -> dict:
    """(a) on JAX's side: the weights, draws (``adv_init.pt``), then the
    steps on the batch placed by ``spatial_sharding`` over 4 CPU devices:
    each step's metrics, the trained side after each step (``adv_jax.pt``)
    and whether the frozen side kept its bits."""
    model_j = JaxConfSegnet(disc_arch="cyclegan", num_critics=2, structure=worker.TINY)
    b0 = worker.adv_batch(0)
    in_day = [jnp.asarray(b0["rgb_day"]), jnp.asarray(b0["ir_day"])]
    params, stats = init_model(model_j, jax.random.PRNGKey(0), in_day, in_day,
                               init_kwargs={"train": True})
    key = jax.random.PRNGKey(SEG_KEY)
    draws = single.jax_draws(key)
    assert draws.moddrop and not draws.drop_rgb and draws.irscale and draws.smart
    _save({"state_dict": state_dict_from_jax(params, stats),
           "draws": dataclasses.asdict(draws)}, os.path.join(work, "adv_init.pt"))

    mesh = jax_mesh.create_mesh(num_devices=4)
    seg_tx, critic_tx = ja.make_phase_optimizers(
        jax_step_lr(worker.JAX_LR, step_size=1, gamma=0.5, steps_per_epoch=1))
    state = jax_mesh.replicate(mesh, ja.AdversarialTrainState.create(params, stats, seg_tx,
                                                                     critic_tx))
    seg_j, critic_j = ja.make_adversarial_steps(model_j, ja.AdversarialConfig(**worker.ADV_FLAGS))
    start = _tensors(params)
    prev, metrics, after, frozen_kept = start, [], [], []
    for i, phase in enumerate(worker.ADV_PHASES):
        placed = _placed(mesh, worker.adv_batch(10 + i))
        if phase == "train_seg":
            state, m = seg_j(state, placed, key)
        else:
            state, m = critic_j(state, placed)
        metrics.append({k: float(v) for k, v in m.items()})
        now = _tensors(state.params)
        frozen = "critics_" if phase == "train_seg" else "trgb_segnet."
        frozen_kept.append(all(torch.equal(v, prev[k]) for k, v in now.items()
                               if k.startswith(frozen)))
        after.append({k: v for k, v in now.items() if not k.startswith(frozen)})
        prev = now
    _save({"start": start, "after": after}, os.path.join(work, "adv_jax.pt"))
    return {"metrics": metrics, "frozen_kept": frozen_kept, "step": int(state.step)}


def _jax_cyclegan(work: str) -> dict:
    """(c) on JAX's side: the weights of
    ``test_three_rounds_of_steps_match_jax`` (``cg_init.pt``), then 3 rounds
    on the batch placed by ``spatial_sharding`` over 4 CPU devices: each
    round's metrics, fakes and netSeg statistics, whether the
    discriminators kept their bits across the generator step, each round's
    parameters and the generator step's first gradients (``cg_jax.pt``)."""
    gen_a2b, gen_b2a = (JaxGenerator(output_nc=1, n_residual_blocks=1) for _ in range(2))
    disc = JaxDiscriminator()
    seg = JaxResNeXtSeg(structure=worker.TINY, input_channels=1, classes=worker.CG_CLASSES)
    x = jnp.asarray(worker.cg_batch(0)["A"])
    init = lambda m, k, *a: jax.jit(m.init)(jax.random.PRNGKey(k), *a)["params"]  # noqa: E731
    g_params = {"netG_A2B": single_cg._perturbed(init(gen_a2b, 0, x), 0),
                "netG_B2A": single_cg._perturbed(init(gen_b2a, 1, x), 1)}
    seg_params, seg_stats = init_model(seg, jax.random.PRNGKey(2), x, None,
                                       init_kwargs={"train": True})
    g_params["netSeg"] = seg_params
    d_a, d_b = init(disc, 3, x, None), init(disc, 4, x, None)
    _save({"netG_A2B": state_dict_from_jax(g_params["netG_A2B"]),
           "netG_B2A": state_dict_from_jax(g_params["netG_B2A"]),
           "netSeg": state_dict_from_jax(seg_params, seg_stats),
           "netD_A": state_dict_from_jax(d_a), "netD_B": state_dict_from_jax(d_b)},
          os.path.join(work, "cg_init.pt"))

    adam = optax.adam(jax_linear_decay(3, 0, 1, worker.JAX_LR, 1), b1=0.5, b2=0.999)
    mesh = jax_mesh.create_mesh(num_devices=4)
    state = jax_mesh.replicate(mesh, jc.CycleGANState.create(g_params, seg_stats, d_a, d_b,
                                                             adam, adam))
    g_j, da_j, db_j = jc.make_cyclegan_steps(gen_a2b, gen_b2a, disc, disc, seg)

    def params_of(state):
        return {**_tensors(state.g_params, "g/"), **_tensors(state.d_a_params, "d_a/netD_A."),
                **_tensors(state.d_b_params, "d_b/netD_B.")}

    start = params_of(state)
    out = {"metrics": [], "fakes": [], "stats": [], "d_kept": []}
    after, moments = [], None
    for i in range(worker.CG_ROUNDS):
        placed = _placed(mesh, worker.cg_batch(i))
        d_before = jax.tree_util.tree_leaves((state.d_a_params, state.d_b_params))
        state, fake_a, fake_b, m = g_j(state, placed)
        out["d_kept"].append(all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(
            d_before, jax.tree_util.tree_leaves((state.d_a_params, state.d_b_params)))))
        if i == 0:  # Adam's first moment after one step is (1 - b1) g
            moments = {k: 2 * v for k, v in _tensors(state.g_opt[0].mu).items()}
        state, loss_a = da_j(state, placed["A"], fake_a)
        state, loss_b = db_j(state, placed["B"], fake_b)
        out["metrics"].append(dict({k: float(v) for k, v in m.items()},
                                   loss_D_A=float(loss_a), loss_D_B=float(loss_b)))
        out["fakes"].append({"A": np.asarray(fake_a), "B": np.asarray(fake_b)})
        out["stats"].append({k: v.numpy() for k, v in
                             state_dict_from_jax({}, state.seg_batch_stats).items()
                             if "running" in k})
        after.append(params_of(state))
    _save({"start": start, "after": after, "moments": moments},
          os.path.join(work, "cg_jax.pt"))
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """JAX's side and rank 0's record of the 4 workers."""
    work = str(tmp_path_factory.mktemp("spatial_adversarial"))
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, WORLD_SIZE="4", MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()),
               PYTHONPATH=os.pathsep.join([here, os.path.dirname(here),
                                           os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, os.path.join(
        here, "torch_spatial_adversarial_worker.py"), work],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(4)]
    logs = []
    try:  # JAX's two trainers in threads while the workers run: compiles overlap
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            adv = pool.submit(_jax_adversarial, work)
            cg = pool.submit(_jax_cyclegan, work)
            want = {"adv": adv.result(), "cg": cg.result()}
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    got = torch.load(os.path.join(work, "out.pt"), weights_only=False)
    print("worker seconds:", got["seconds"])
    return want, got


@pytest.mark.parametrize("n", worker.SHARDS, ids=lambda n: f"{n}shards")
def test_adversarial_steps_by_rows_match_jax_steps_on_the_spatially_sharded_batch(run, n):
    want, got = run
    jax_side, mine = want["adv"], got[f"jax/{n}"]
    assert jax_side["step"] == mine["adv_step"] == 3 and mine["adv_schedules"] == [1, 2]
    assert jax_side["frozen_kept"] == mine["adv_frozen"] == [True] * 3
    assert mine["adv_replicas"] == [True] * 3
    for i, (m_t, m_j) in enumerate(zip(mine["adv_metrics"], jax_side["metrics"])):
        keys = (("total_loss", "seg_loss", "conf_loss") if worker.ADV_PHASES[i] == "train_seg"
                else ("critic_loss",))
        for k in keys:
            np.testing.assert_allclose(m_t[k], m_j[k], rtol=2e-3, atol=2e-4,
                                       err_msg=f"step {i} {k}")
    for i, (n_bad, n_el) in enumerate(mine["adv_updates"]):
        print(f"{n} shards, step {i}: {n_bad} of {n_el} updates beyond 5 % of JAX's")
        assert n_el > 5e6 and n_bad <= single.UPDATE_FLIPS * n_el, (i, n_bad, n_el)


@pytest.mark.parametrize("n", worker.SHARDS, ids=lambda n: f"{n}shards")
def test_cyclegan_rounds_by_rows_match_jax_rounds_on_the_spatially_sharded_batch(run, n):
    want, got = run
    jax_side, mine = want["cg"], got[f"jax/{n}"]
    assert jax_side["d_kept"] == mine["cg_d_unchanged"] == [True] * worker.CG_ROUNDS
    assert mine["cg_replicas"] == [True] * worker.CG_ROUNDS
    for i in range(worker.CG_ROUNDS):
        for k, v in jax_side["metrics"][i].items():
            np.testing.assert_allclose(mine["cg_metrics"][i][k], v, rtol=2e-3, atol=2e-4,
                                       err_msg=f"round {i} {k}")
        for k, v in jax_side["fakes"][i].items():
            np.testing.assert_allclose(mine["cg_fakes"][i][k].numpy(), v, **single_cg.TOL,
                                       err_msg=f"round {i} fake {k}")
        for k, v in jax_side["stats"][i].items():
            np.testing.assert_allclose(mine["cg_stats"][i][k].numpy(), v, rtol=1e-3,
                                       atol=1e-4, err_msg=f"round {i} netSeg {k}")
        n_bad, n_el = mine["cg_updates"][i]
        print(f"{n} shards, round {i}: {n_bad} of {n_el} updates beyond 5 % of JAX's")
        assert n_el > 2e7 and n_bad <= single_cg.UPDATE_FLIPS * n_el, (i, n_bad, n_el)
    rel = dict(zip(mine["cg_grad_names"], mine["cg_grad_rel_l2"]))
    assert len(rel) > 40 and max(rel.values()) < 0.05, max(rel.items(), key=lambda kv: kv[1])


@pytest.mark.parametrize("case", list(worker.F64_ADV) + ["cg64"])
def test_float64_steps_by_rows_equal_the_unsharded_steps(run, case):
    rec = run[1][f"f64/{case}"]
    steps = worker.CG64_ROUNDS if case == "cg64" else 3
    assert rec["replicas"] == [True] * steps
    assert rec["frozen"] == rec["frozen_unsharded"] == [True] * steps
    assert rec["n_grads"] > (100 if case == "cg64" else 200)
    for i, (m, t) in enumerate(zip(rec["metrics"], rec["tensors"])):
        assert m[0] <= worker.F64_TOL, f"step {i}: metric {m}"
        assert t[0] <= 1.0, f"step {i}: {t} of its bound"


@pytest.mark.parametrize("name", list(worker.PRIMITIVES))
def test_by_rows_primitive_gradients_match_autograd_through_the_frame(run, name):
    """Each rank's output and its gradient of each rank's linear function
    of it, against the same function of the whole frame: rank r's rows of
    the output (or the whole output, where every rank holds it)."""
    fn = worker.primitive_fn(name)[1]
    x = torch.from_numpy(worker.primitive_input(name)).requires_grad_()
    y = fn(x)
    n = 4
    total, parts = 0, []
    for r in range(n):
        part = worker.reference_part(name, y, r, n)
        parts.append(part)
        total = total + (part * worker.weight_of(r, part.shape)).sum()
    total.backward()
    got = run[1]
    out = got[f"prim/{name}/out"]
    for r in range(n):
        np.testing.assert_allclose(out[r].numpy(), parts[r].detach().numpy(), rtol=1e-12,
                                   atol=1e-12, err_msg=f"rank {r}")
    grad = torch.cat(list(got[f"prim/{name}/grad"]), 2)
    np.testing.assert_allclose(grad.numpy(), x.grad.numpy(), rtol=1e-12, atol=1e-12)
