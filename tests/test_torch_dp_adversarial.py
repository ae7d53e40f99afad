"""The adversarial trainer and the trainers' and evaluators' CLIs data
parallel over two gloo processes, on the CPU.

One module fixture writes what the processes need for (c) (a tiny train
pack, a Freiburg test tree and a run directory), starts
``torch_dp_adversarial_worker.py`` twice as ``torchrun`` would, each with
its own time limit, and computes the one-process side while they run: in a
thread, JAX's weights, batches and draws for (b), which the workers wait
for, then JAX's steps on the ``shard_batch``-placed batch; beside it, one
process's CLI runs.

(a) ``torch_dp_adversarial_cases``: in float64, critic, seg and critic steps
    over two processes against one process on the whole batch (each worker
    computes half of the one-process runs in a child process and writes
    only differences).
(b) In float32 against JAX's ``make_adversarial_steps`` on a 2-device CPU
    mesh, the contract and sizes of
    ``tests/test_torch_adversarial.py::test_alternating_steps_match_jax``.
(c) ``cli.train_conf``, ``cli.train_plain``, ``cli.eval_hotnet`` and
    ``cli.dataset_qa`` over two processes against one process
    (``tests/test_mesh.py:187``'s counterpart).

Each case states its tolerance.
"""

import concurrent.futures
import dataclasses
import json
import os
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from heatnet_tpu.models import ResNeXtSeg as JaxResNeXtSeg
from heatnet_tpu.parallel import mesh as jax_mesh
from heatnet_tpu.train import adversarial as ja
from heatnet_tpu.train.optim import step_lr as jax_step_lr
from heatnet_tpu.train.state import init_model
from heatnet_tpu_torch.cli import dataset_qa, eval_hotnet, train_conf, train_plain
from heatnet_tpu_torch.data.loaders import DeviceAugment
from heatnet_tpu_torch.data.packed import write_train_pack
from heatnet_tpu_torch.data.png import write_png
from heatnet_tpu_torch.io.from_jax import state_dict_from_jax
from heatnet_tpu_torch.models import ResNeXtSeg
from heatnet_tpu_torch.models.layers import init_params

import test_torch_adversarial as single
import torch_dp_adversarial_cases as cases

torch.set_num_threads(2)

WORKER_TIMEOUT_S = 300
JAX_FLAGS = dict(moddrop=True, irscale=True, smartirscale=True, night_supervision=True,
                 night_sup_modalities="ir")
JAX_PHASES = ("train_critic", "train_seg", "train_critic")
# RMSprop's first update moves an element by about 10 lr sign(g), so the
# elements whose f32 gradients straddle 0 (3.1 % at the second critic step,
# test_torch_adversarial.py) flip with the summation order. At
# test_alternating_steps_match_jax's 1e-4 the second critic step's loss lies
# 1.26e-3 apart between JAX over 2 devices and over 1, 3.4e-3 between the
# port over 2 processes and over 1, and 3.86e-3 between the port's 2
# processes and JAX's 2 devices, beyond the contract's 2e-3; at 1e-6 every
# such pair lies within 4.4e-5 (torch_dp_adversarial_lr_witness.py). The
# float64 cases hold the two-process steps to one process's within 1e-6
JAX_LR = 1e-6


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_spec(root: str, lr: float = JAX_LR) -> dict:
    """Where (b)'s inputs will be: ``ready`` is written after the others."""
    return {"model": os.path.join(root, "model.pt"),
            "teacher": os.path.join(root, "teacher.pt"),
            "draws": os.path.join(root, "draws.pt"), "ready": os.path.join(root, "jax_ready"),
            "batches": [os.path.join(root, f"batch{i}.npz") for i in range(3)],
            "flags": JAX_FLAGS, "lr": lr, "phases": JAX_PHASES}


def _jax_case(spec: dict, devices: int = 2):
    """(b)'s inputs, written for the workers, and JAX's steps on the batch
    placed by ``shard_batch`` over ``devices`` CPU devices: per-step losses,
    parameters after each step, parameters at the start, JAX's step
    count."""
    model_j, params, stats, model_t = single._pair(disc_arch="cyclegan",
                                                   hw=single.HW_CYCLEGAN)
    b0 = single._batch(hw=single.HW_CYCLEGAN)
    teacher_j = JaxResNeXtSeg(structure=single.TINY, input_channels=1)
    t_params, t_stats = init_model(teacher_j, jax.random.PRNGKey(1),
                                   jax.numpy.asarray(b0["ir_night"]), None)
    torch.save(model_t.state_dict(), spec["model"])
    torch.save(state_dict_from_jax(t_params, t_stats), spec["teacher"])
    key = jax.random.PRNGKey(7)
    torch.save(dataclasses.asdict(single.jax_draws(key)), spec["draws"])
    batches = [single._batch(hw=single.HW_CYCLEGAN, seed=10 + i) for i in range(3)]
    for path, b in zip(spec["batches"], batches):
        np.savez(path, **b)
    open(spec["ready"], "w").close()

    mesh = jax_mesh.create_mesh(num_devices=devices)
    seg_tx, critic_tx = ja.make_phase_optimizers(
        jax_step_lr(spec["lr"], step_size=1, gamma=0.5, steps_per_epoch=1))
    state = jax_mesh.replicate(
        mesh, ja.AdversarialTrainState.create(params, stats, seg_tx, critic_tx))
    seg_j, critic_j = ja.make_adversarial_steps(
        model_j, ja.AdversarialConfig(**JAX_FLAGS), teacher_j,
        {"params": t_params, "batch_stats": t_stats})
    losses, after = [], []
    for b, phase in zip(batches, JAX_PHASES):
        placed = jax_mesh.shard_batch(mesh, single._jax(b))
        if phase == "train_seg":
            state, m = seg_j(state, placed, key)
        else:
            state, m = critic_j(state, placed)
        losses.append({k: float(v) for k, v in m.items()})
        after.append(single._flat(state.params))
    return losses, after, single._flat(params), int(state.step)


def _cli_inputs(root: str) -> dict:
    """A 2-day-frame train pack (one night frame), a 3-frame Freiburg test
    tree and a run directory of a (1,1,1,1) segnet; each CLI's arguments
    with ``{out}`` for its output directory."""
    rng = np.random.RandomState(0)
    pack = os.path.join(root, "pack")
    write_train_pack(pack, rng.randint(0, 256, (2, 320, 960, 3)).astype(np.uint8),
                     rng.randint(21000, 26000, (2, 320, 960)).astype(np.uint16),
                     rng.randint(0, 13, (2, 320, 960)).astype(np.uint8),
                     rng.randint(0, 256, (1, 320, 960, 3)).astype(np.uint8),
                     rng.randint(21000, 26000, (1, 320, 960)).astype(np.uint16))
    tree = os.path.join(root, "fr")
    for d in ("ImagesRGB", "ImagesIR", "SegmentationClass"):
        os.makedirs(os.path.join(tree, d))
    for i in range(3):
        stem = f"1_00000000{i}"
        write_png(os.path.join(tree, "ImagesRGB", f"{stem}_rgb.png"),
                  rng.randint(0, 256, (160, 480, 3)).astype(np.uint8))
        write_png(os.path.join(tree, "ImagesIR", f"{stem}_ir.png"),
                  rng.randint(21000, 26000, (160, 480)).astype(np.uint16))
        np.save(os.path.join(tree, "SegmentationClass", f"{stem}.npy"),
                rng.randint(0, 14, (160, 480)).astype(np.uint8))
    run = os.path.join(root, "run")
    os.makedirs(run)
    with open(os.path.join(run, "config.json"), "w") as f:
        json.dump({"structure": [1, 1, 1, 1]}, f)
    segnet = ResNeXtSeg(structure=(1, 1, 1, 1), input_channels=4)
    init_params(segnet, torch.Generator().manual_seed(5))
    torch.save(segnet.state_dict(), os.path.join(run, "checkpoint_best.pth"))
    tiny = ["--device", "cpu", "--structure", "1", "1", "1", "1"]
    return {
        "train_conf": ["--dataroot", pack, "--batch_size", "2", "--n_epochs", "1",
                       "--discarch", "cyclegan", "--num_critics", "2", "--crop_height",
                       "256", "--crop_width", "256", "--iter_initial_critic_phase", "1",
                       "--iter_seg_phase", "1", "--moddrop", "--irscale", "--log_everyn",
                       "1", "--n_cpu", "1", "--checkpointname", "{out}/conf",
                       "--log_dir", "{out}/runs", *tiny],
        "train_plain": ["--dataroot", pack, "--batch_size", "2", "--n_epochs", "2",
                        "--n_cpu", "1", "--checkpointname", "{out}/plain", "--log_dir",
                        "{out}/runs", *tiny],
        "eval_hotnet": ["--runs", run, "--testroot_day", tree, "--testroot_night", tree,
                        "--device", "cpu", "--log_dir", "{out}/runs"],
        "dataset_qa": ["freiburg", "--data", tree, "--checkpoint",
                       os.path.join(run, "checkpoint_best.pth"), *tiny],
    }


def _argv(args, out: str):
    return [a.replace("{out}", out) for a in args]


def _one_process_cli(name: str, argv) -> dict:
    """A CLI in this process (no launcher environment), recorded as the
    worker records it."""
    module = {"train_conf": train_conf, "train_plain": train_plain,
              "eval_hotnet": eval_hotnet, "dataset_qa": dataset_qa}[name]
    ious = []
    real = getattr(module, "validate_model", None)

    def validate(*a, **k):
        ious.append(real(*a, **k))
        return ious[-1]

    if real is not None:
        module.validate_model = validate
    try:
        result = module.main(argv)
    finally:
        if real is not None:
            module.validate_model = real
    return {"result": result, "ious": ious}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dp_adv"))
    here = os.path.dirname(os.path.abspath(__file__))
    jax_spec = _jax_spec(root)
    cli = _cli_inputs(root)
    spec = {"jax_case": jax_spec,
            "cli": {k: _argv(v, os.path.join(root, "dp")) for k, v in cli.items()}}
    spec_path = os.path.join(root, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    env = dict(os.environ, WORLD_SIZE="2", MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), HEATNET_EVAL_BATCH="1",
               PYTHONPATH=os.pathsep.join([here, os.path.dirname(here),
                                           os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, os.path.join(here, "torch_dp_adversarial_worker.py"),
                               spec_path, root],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = []
    try:  # JAX's steps in a thread beside one process's CLI runs
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            jax_steps = pool.submit(_jax_case, jax_spec)
            one, seconds = {}, {}
            os.environ["HEATNET_EVAL_BATCH"] = "1"
            try:
                for name, args in cli.items():
                    t0 = time.perf_counter()
                    one[name] = _one_process_cli(name, _argv(args, os.path.join(root, "one")))
                    seconds[name] = time.perf_counter() - t0
            finally:
                os.environ.pop("HEATNET_EVAL_BATCH")
            one["jax"] = jax_steps.result()
        print("one process, seconds:", seconds)
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    ranks = []
    for r in range(2):
        with open(os.path.join(root, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
        print(f"rank {r}, seconds:", ranks[-1]["seconds"])
    return {"ranks": ranks, "one": one, "root": root,
            "jax_case_port": dict(np.load(os.path.join(root, "jax_case.npz")))}


@pytest.mark.parametrize("case", list(cases.CASES))
def test_adversarial_steps_over_two_processes_equal_one_process(run, case):
    """Float64, critic / seg / critic steps (``torch_dp_adversarial_cases``):
    every step's losses, each phase's first step's gradients (as summed over
    the processes) and the running statistics after every step within 1e-6
    of each tensor's largest absolute value (a gradient that is rounding
    only, 1e-12 of the model's largest); the two replicas' parameters equal
    bit for bit after every step, and the frozen side unchanged bit for
    bit."""
    i = list(cases.CASES).index(case)
    mine = run["ranks"][i % 2]["float64"][case]
    other = run["ranks"][1 - i % 2]["float64"][case]
    assert mine["replicas"] == other["replicas"] == [True] * 3
    assert mine["frozen_unchanged"] == other["frozen_unchanged"] == [True] * 3
    assert mine["frozen_unchanged_one_process"] == [True] * 3
    assert mine["n_grads"] > 100
    for what in ("metrics", "grads", "stats"):
        for step, (rel, name) in enumerate(mine[what]):
            assert rel <= 1e-6, f"{case} step {step} {what}: {name} at {rel}"


def test_adversarial_steps_over_two_processes_match_jax_on_the_sharded_batch(run):
    """Float32, the contract of ``test_alternating_steps_match_jax``: each
    rank's critic / seg / critic losses within rtol 2e-3 / atol 2e-4 of JAX's
    steps on the ``shard_batch``-placed batch (2 CPU devices); the frozen side
    bit for bit unchanged; every trained parameter's change since the start
    within 5 % of JAX's, elementwise, on all but ``UPDATE_FLIPS`` of the
    elements; each schedule counts its own phase's steps."""
    losses_j, after_j, start, step_j = run["one"]["jax"]
    for rank in run["ranks"]:
        got = rank["jax_case"]
        assert got["step"] == step_j == 3 and got["schedules"] == [1, 2]
        assert got["frozen_unchanged"] == [True] * 3
        for i, (m_t, m_j) in enumerate(zip(got["metrics"], losses_j)):
            keys = (("total_loss", "seg_loss", "conf_loss", "night_seg_loss")
                    if JAX_PHASES[i] == "train_seg" else ("critic_loss",))
            for k in keys:
                np.testing.assert_allclose(m_t[k], m_j[k], rtol=2e-3, atol=2e-4,
                                           err_msg=f"rank {rank['rank']} step {i} {k}")
    port = run["jax_case_port"]
    prev = start
    for i, phase in enumerate(JAX_PHASES):
        frozen = "critics_" if phase == "train_seg" else "trgb_segnet."
        n_el = n_bad = 0
        for k, v in after_j[i].items():
            if k.startswith(frozen):  # JAX's side; the workers checked theirs
                np.testing.assert_array_equal(v, prev[k], err_msg=k)
                continue
            d_j, d_t = v - start[k], port[f"step{i}/{k}"] - start[k]
            bad = np.abs(d_t - d_j) > 0.05 * np.abs(d_j) + 1e-3 * JAX_LR
            n_el, n_bad = n_el + bad.size, n_bad + int(bad.sum())
        assert n_bad <= single.UPDATE_FLIPS * n_el, f"step {i}: {n_bad} of {n_el} differ"
        prev = after_j[i]


def _ranks_trained_one_model(run, name: str, n_checkpoints: int) -> None:
    r0, r1 = (rank[name] for rank in run["ranks"])
    assert "Current loss" in r0["printed"] and "Current loss" in r1["printed"]
    assert len(r0["saved"]) == n_checkpoints and r1["saved"] == []
    assert r0["checkpoint_equals_model"]
    assert r0["weights_equal_across_ranks"] and r1["weights_equal_across_ranks"]
    runs = os.path.join(run["root"], "dp", "runs")
    assert any(f.endswith(".jsonl") for f in os.listdir(runs))
    assert any(f.endswith(".jsonl") for f in os.listdir(os.path.join(runs, "rank1")))


def test_train_conf_over_two_processes_trains_one_model(run):
    """``cli.train_conf`` for a critic and a seg step (cyclegan critics at
    256x256 crops, ``--moddrop --irscale``) over 2 processes: both ranks print
    ``Current loss``, the first alone writes the checkpoints and the log
    (rank 1 logs under ``rank1/``), the ranks' final weights are equal bit
    for bit, and each rank's losses are within rtol 2e-3 / atol 2e-4 of one
    process's run on the whole batch."""
    _ranks_trained_one_model(run, "train_conf", 2)
    want = run["one"]["train_conf"]["result"].losses
    for rank in run["ranks"]:
        got = rank["train_conf"]["losses"]
        assert [len(v) for v in got.values()] == [len(v) for v in want.values()] == [1, 1]
        for phase in want:
            np.testing.assert_allclose(got[phase], want[phase], rtol=2e-3, atol=2e-4,
                                       err_msg=phase)


def test_train_plain_over_two_processes_trains_one_model(run):
    """``cli.train_plain`` for 2 steps over 2 processes: as train_conf's
    case; losses within rtol 2e-3 / atol 2e-4 of one process's."""
    _ranks_trained_one_model(run, "train_plain", 2)
    want = run["one"]["train_plain"]["result"].losses
    assert len(want) == 2
    for rank in run["ranks"]:
        np.testing.assert_allclose(rank["train_plain"]["losses"], want, rtol=2e-3,
                                   atol=2e-4)


@pytest.mark.parametrize("name", ["eval_hotnet", "dataset_qa"])
def test_evaluating_clis_over_two_processes_equal_one_process(run, name):
    """``cli.eval_hotnet`` (night, then day) and ``cli.dataset_qa freiburg``
    over an eval mesh of 2 processes (3 frames in eval batches of 2: the
    tail padded): every rank's IoU vectors within 1e-9 of the same CLI's
    in one process, NaN where it is NaN; the first rank alone prints."""
    want = [np.asarray(v, np.float64) for v in run["one"][name]["ious"]]
    assert len(want) == (2 if name == "eval_hotnet" else 1)
    for rank in run["ranks"]:
        got = [np.asarray(v, np.float64) for v in rank[name]["ious"]]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
            np.testing.assert_allclose(g[~np.isnan(g)], w[~np.isnan(w)], rtol=0, atol=1e-9)
    assert run["ranks"][0][name]["printed"] and not run["ranks"][1][name]["printed"]


def test_gradient_check_raises_when_the_ranks_graphs_differ(run):
    """``check_same_gradients``, which each adversarial phase's first step
    runs: a parameter with a gradient on one rank and none on the other
    makes both ranks raise, naming the count, before ``all_reduce_gradients``
    would sum misaligned buffers."""
    for rank in run["ranks"]:
        assert "1 of 2 processes hold a gradient" in rank["graphs_differ"]


def test_device_augment_gives_each_process_its_rows_of_the_whole_batch():
    """``DeviceAugment(..., mesh)``: each process's rows of one augmented
    batch bit for bit, the generator left where the whole batch's draws
    leave it."""
    rng = np.random.RandomState(3)
    raw = {"rgb_day": rng.randint(0, 256, (4, 320, 960, 3)).astype(np.uint8),
           "ir_day": rng.randint(21000, 26000, (4, 320, 960)).astype(np.uint16),
           "label_day": rng.randint(0, 13, (4, 320, 960)).astype(np.uint8),
           "rgb_night": rng.randint(0, 256, (4, 320, 960, 3)).astype(np.uint8),
           "ir_night": rng.randint(21000, 26000, (4, 320, 960)).astype(np.uint16)}
    augment = DeviceAugment(crop_hw=(64, 96), device="cpu")
    g = torch.Generator().manual_seed(1)
    whole = augment(g, raw)
    after = torch.rand(1, generator=g)

    class TwoByOne:  # the rows of data rank r of a (2, 1) mesh
        mesh_dim_names = ("data", "model")

        def __init__(self, r):
            self.r = r

        def size(self, dim):
            return (2, 1)[dim]

        def get_local_rank(self, name):
            return self.r

    for r in range(2):
        g = torch.Generator().manual_seed(1)
        rows = augment(g, raw, TwoByOne(r))
        assert torch.equal(torch.rand(1, generator=g), after)
        assert set(rows) == set(whole)
        for k, v in whole.items():
            assert torch.equal(rows[k], v[2 * r:2 * r + 2]), k
