"""One process of the 2-process gloo run of tests/test_torch_dp_adversarial.py.

Run as ``python torch_dp_adversarial_worker.py SPEC OUT_DIR`` under a
launcher-style environment (WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT); SPEC is the fixture's JSON. It imports no JAX. In order:

(a) each float64 case of ``torch_dp_adversarial_cases`` over the two
    processes, while a child process (no group) runs this rank's half of the
    cases in one process on the whole batch and hands them back through a
    queue; then their differences (``compare``);
(b) the port's float32 critic, seg and critic steps over the two processes
    from the weights, batches and draws the fixture carried over from JAX
    (written while (a) runs: the worker waits for them); the first rank
    writes the trained side's parameters after each step;
(c) ``cli.train_conf``, ``cli.train_plain``, ``cli.eval_hotnet`` and
    ``cli.dataset_qa`` with the spec's arguments, each joining the group
    this process already holds: their losses or IoUs, what each rank
    printed, the checkpoints each rank wrote, the digests of its final
    weights;
and ``check_same_gradients`` where one rank holds a gradient the other
does not. Each rank writes ``OUT_DIR/rank<r>.json``.
"""

import contextlib
import io
import json
import os
import queue as queue_module
import sys
import time
from unittest import mock

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from heatnet_tpu_torch.cli import dataset_qa, eval_hotnet, train_conf, train_plain  # noqa: E402
from heatnet_tpu_torch.models import ConfSegnet, ResNeXtSeg  # noqa: E402
from heatnet_tpu_torch.models.layers import prepare_for_inference  # noqa: E402
from heatnet_tpu_torch.parallel import mesh as pm  # noqa: E402
from heatnet_tpu_torch.train import adversarial as ta  # noqa: E402
from heatnet_tpu_torch.train.optim import step_lr  # noqa: E402

import torch_dp_adversarial_cases as cases  # noqa: E402


def _packed(tensors: dict) -> tuple:
    """A dict of tensors as (names, shapes, one flat tensor): a queue then
    shares one storage, not one file descriptor per tensor."""
    names = list(tensors)
    flat = (torch.cat([tensors[k].reshape(-1) for k in names]) if names
            else torch.zeros(0, dtype=torch.float64))
    return names, [tuple(tensors[k].shape) for k in names], flat


def _unpacked(packed: tuple) -> dict:
    names, shapes, flat = packed
    out, offset = {}, 0
    for k, shape in zip(names, shapes):
        n = int(np.prod(shape, dtype=np.int64))
        out[k] = flat[offset:offset + n].view(shape)
        offset += n
    return out


def one_process_runs(names, queue, received) -> None:
    """The cases ``names`` in one process on the whole batch, each put on
    ``queue`` as soon as it is done; the process stays until ``received``
    is set, since the tensors it shares live in its memory."""
    torch.set_num_threads(1)
    for case in names:
        want = cases.steps(case)
        for key in ("grads", "stats"):
            want[key] = [_packed(d) for d in want[key]]
        queue.put((case, want))
    received.wait(600)


def _get(queue, child, timeout_s: float = 300.0):
    """The queue's next item; raises if the child exits without one."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            return queue.get(timeout=1.0)
        except queue_module.Empty:
            if not child.is_alive():
                raise RuntimeError(f"the one-process child exited {child.exitcode}")
    raise TimeoutError("the one-process child sent nothing in time")


def float64_cases(mesh, rank: int) -> dict:
    mine = [case for i, case in enumerate(cases.CASES) if i % 2 == rank]
    ctx = torch.multiprocessing.get_context("spawn")
    queue, received = ctx.Queue(), ctx.Event()
    child = ctx.Process(target=one_process_runs, args=(mine, queue, received))
    child.start()
    out, kept = {}, {}
    try:
        for case in cases.CASES:
            got = cases.steps(case, mesh)
            out[case] = {"replicas": got["replicas"],
                         "frozen_unchanged": got["frozen_unchanged"]}
            if case in mine:  # this rank holds the case against one process
                kept[case] = got
        for _ in mine:
            case, want = _get(queue, child)
            for key in ("grads", "stats"):
                want[key] = [_unpacked(p) for p in want[key]]
            out[case].update(cases.compare(kept.pop(case), want),
                             frozen_unchanged_one_process=want["frozen_unchanged"])
        received.set()
        child.join(timeout=60)
    finally:
        if child.is_alive():
            child.kill()
    return out


def jax_weights_steps(spec: dict, mesh, rank: int, out_dir: str) -> dict:
    """(b): the port's steps over the mesh from JAX's weights and draws."""
    b = spec["jax_case"]
    deadline = time.monotonic() + 300
    while not os.path.exists(b["ready"]) and time.monotonic() < deadline:
        time.sleep(0.2)
    model = ConfSegnet(disc_arch="cyclegan", num_critics=2, structure=(1, 1, 1, 1))
    model.load_state_dict(torch.load(b["model"], weights_only=True), strict=True)
    model.train()
    teacher = ResNeXtSeg(structure=(1, 1, 1, 1), input_channels=1)
    teacher.load_state_dict(torch.load(b["teacher"], weights_only=True), strict=True)
    teacher = prepare_for_inference(teacher, torch.device("cpu"))
    cfg = ta.AdversarialConfig(**b["flags"])
    state = ta.make_phase_optimizers(model, step_lr(b["lr"], 1, 0.5, 1))
    seg_step, critic_step = ta.make_adversarial_steps(model, cfg, teacher, mesh)
    draws = ta.SegAugDraws(**torch.load(b["draws"], weights_only=True))
    metrics, frozen_unchanged, params = [], [], {}
    for i, phase in enumerate(b["phases"]):
        whole = dict(np.load(b["batches"][i]))
        rows = pm.shard_batch(mesh, {k: torch.from_numpy(v) for k, v in whole.items()})
        rows["label_day"] = rows["label_day"].long()
        frozen = "critics_" if phase == "train_seg" else "trgb_segnet."
        before = cases.digest(p for k, p in model.named_parameters() if k.startswith(frozen))
        if phase == "train_seg":
            m = seg_step(state, rows, draws)
        else:
            m = critic_step(state, rows)
        metrics.append({k: float(v) for k, v in m.items()})
        frozen_unchanged.append(bool(before == cases.digest(
            p for k, p in model.named_parameters() if k.startswith(frozen))))
        for k, p in model.named_parameters():
            if not k.startswith(frozen):
                params[f"step{i}/{k}"] = p.detach().numpy().copy()
    if rank == 0:
        np.savez(os.path.join(out_dir, "jax_case.npz"), **params)
    return {"metrics": metrics, "step": state.step, "frozen_unchanged": frozen_unchanged,
            "schedules": [state.seg.scheduler.last_epoch, state.critic.scheduler.last_epoch]}


def run_cli(module, argv, mesh_group) -> dict:
    """One CLI run in this process: its return value, what it printed, the
    checkpoints it wrote, the IoU vectors its validators returned and the
    digest of its final weights, held against the other rank's."""
    models, saved, ious = [], [], []

    def recording(name, keep):
        real = getattr(module, name)

        def wrapper(*args, **kw):
            out = real(*args, **kw)
            keep(args, out)
            return out
        return mock.patch.object(module, name, wrapper)

    printed = io.StringIO()
    with contextlib.ExitStack() as stack:
        for name, keep in (("init_model", lambda a, out: models.append(out)),
                           ("save_checkpoint", lambda a, out: saved.append(a[1])),
                           ("validate_model", lambda a, out: ious.append(out))):
            if hasattr(module, name):
                stack.enter_context(recording(name, keep))
        stack.enter_context(contextlib.redirect_stdout(printed))
        result = module.main(argv)
    rec = {"printed": printed.getvalue(), "saved": saved,
           "ious": [np.asarray(v).tolist() for v in ious]}
    if hasattr(result, "losses"):
        rec["losses"] = result.losses
    else:
        rec["result"] = result
    if models:
        mine = cases.digest(models[0].state_dict().values()).reshape(1)
        both = pm.all_gather(mesh_group, mine)
        rec["weights_equal_across_ranks"] = bool(both[0] == both[1])
        if saved:
            on_disk = torch.load(saved[-1], map_location="cpu", weights_only=True)
            rec["checkpoint_equals_model"] = bool(
                cases.digest(on_disk["state_dict"].values()) == mine[0])
    return rec


def graphs_differ(mesh, rank: int) -> str:
    """``check_same_gradients`` where only the first rank holds a gradient."""
    lin = torch.nn.Linear(3, 2)
    if rank == 0:
        lin(torch.ones(1, 3)).sum().backward()
    try:
        pm.check_same_gradients(mesh, lin.parameters())
    except RuntimeError as e:
        return str(e)
    return ""


def main(spec_path: str, out_dir: str) -> None:
    torch.set_num_threads(2)
    with open(spec_path) as f:
        spec = json.load(f)
    assert pm.maybe_initialize_distributed(torch.device("cpu"))
    rank = torch.distributed.get_rank()
    mesh = pm.create_mesh()
    group = pm.data_group(mesh)
    rec, seconds = {"rank": rank}, {}
    parts = [("float64", lambda: float64_cases(mesh, rank)),
             ("jax_case", lambda: jax_weights_steps(spec, mesh, rank, out_dir)),
             ("graphs_differ", lambda: graphs_differ(mesh, rank))]
    parts += [(name, lambda m=module, n=name: run_cli(m, spec["cli"][n], group))
              for name, module in (("train_conf", train_conf), ("train_plain", train_plain),
                                   ("eval_hotnet", eval_hotnet), ("dataset_qa", dataset_qa))]
    for name, part in parts:
        t0 = time.perf_counter()
        rec[name] = part()
        seconds[name] = time.perf_counter() - t0
    rec["seconds"] = seconds
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:3])
