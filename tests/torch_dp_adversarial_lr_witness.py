"""Why test (b) of tests/test_torch_dp_adversarial.py runs at a learning rate
below test_alternating_steps_match_jax's: the same critic / seg / critic
steps, from the same JAX weights, batches and draws, taken six ways at each
learning rate, and the losses' relative distances between them.

- JAX's steps on the batch placed by ``shard_batch`` over 2 CPU devices
  and over 1 (two summation orders of one implementation);
- the port's steps in one process and over 2 gloo processes
  (``torch_dp_adversarial_worker.jax_weights_steps``).

Usage (from the repo's root; about five minutes on a CPU)::

    python tests/torch_dp_adversarial_lr_witness.py [LR ...]   # default 1e-6 1e-4

It prints each run's losses per step, then for each pair of runs each
step's largest relative distance over the step's losses (test (b)'s keys).
"""

import json
import os
import socket
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

KEYS = {"train_critic": ("critic_loss",),
        "train_seg": ("total_loss", "seg_loss", "conf_loss", "night_seg_loss")}


def rank_main(spec_path: str, out_path: str) -> None:
    """One of the two gloo processes: the port's steps on its rows."""
    import torch

    import torch_dp_adversarial_worker as worker
    from heatnet_tpu_torch.parallel import mesh as pm

    torch.set_num_threads(2)
    with open(spec_path) as f:
        spec = json.load(f)
    assert pm.maybe_initialize_distributed(torch.device("cpu"))
    rank = torch.distributed.get_rank()
    out = worker.jax_weights_steps({"jax_case": spec}, pm.create_mesh(), rank,
                                   os.path.dirname(out_path))
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(out["metrics"], f)
    torch.distributed.destroy_process_group()


def two_processes(spec: dict, root: str) -> list:
    spec_path, out_path = os.path.join(root, "spec.json"), os.path.join(root, "two.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, WORLD_SIZE="2", MASTER_ADDR="localhost", MASTER_PORT=str(port))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", spec_path,
                               out_path], env=dict(env, RANK=str(r), LOCAL_RANK=str(r)))
             for r in range(2)]
    try:
        for p in procs:
            if p.wait(timeout=300) != 0:
                raise RuntimeError(f"a gloo process exited {p.returncode}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    with open(out_path) as f:
        return json.load(f)


def distances(a: list, b: list, phases) -> list:
    return [max(abs(a[i][k] - b[i][k]) / abs(b[i][k]) for k in KEYS[phase])
            for i, phase in enumerate(phases)]


def main(lrs) -> None:
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    import test_torch_dp_adversarial as dp
    import torch_dp_adversarial_worker as worker

    for lr in lrs:
        with tempfile.TemporaryDirectory(prefix="lr_witness_") as root:
            spec = dp._jax_spec(root, lr)
            runs = {"JAX, 2 devices": dp._jax_case(spec, devices=2)[0],
                    "JAX, 1 device": dp._jax_case(spec, devices=1)[0]}
            runs["port, 1 process"] = worker.jax_weights_steps(
                {"jax_case": spec}, None, 0, root)["metrics"]
            runs["port, 2 processes"] = two_processes(spec, root)
        print(f"lr {lr:g}: losses per step (critic; total, seg, conf, night; critic)")
        for name, metrics in runs.items():
            print(f"  {name}: " + "; ".join(
                ", ".join(f"{m[k]:.6f}" for k in KEYS[phase])
                for m, phase in zip(metrics, dp.JAX_PHASES)))
        print(f"lr {lr:g}: largest relative distance of each step's losses")
        for a, b in (("JAX, 2 devices", "JAX, 1 device"), ("port, 1 process", "JAX, 1 device"),
                     ("port, 1 process", "JAX, 2 devices"),
                     ("port, 2 processes", "JAX, 2 devices"),
                     ("port, 2 processes", "port, 1 process")):
            print(f"  {a} against {b}: "
                  f"{[f'{d:.3g}' for d in distances(runs[a], runs[b], dp.JAX_PHASES)]}")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_main(*sys.argv[2:4])
    else:
        main([float(v) for v in sys.argv[1:]] or [1e-6, 1e-4])
