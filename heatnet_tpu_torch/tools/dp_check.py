"""Data-parallel ``cli.main`` across processes against one process.

Writes a 16-frame 1024x768 Vistas tree, then runs ``cli.main`` (ResNeXt
structure 1 1 1 1, batch 8 of 192x384, 2 steps and a validation) twice with
the same arguments: as one process, and as ``--nproc`` processes under
``torch.distributed.run`` (one card each, NCCL; or gloo with ``--device
cpu``). Prints each run's losses and mIoU and their relative differences,
and exits non-zero where the losses differ by more than 1e-2 relative (the
repo's card step contract) or the mIoUs by more than 1e-3. The processes run
in bf16 on the card, so they sum in another order than one process: equal
to rounding, not bit for bit.

Usage::

    python -m heatnet_tpu_torch.tools.dp_check --nproc 4
    python -m heatnet_tpu_torch.tools.dp_check --nproc 4 --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def write_tree(root: str, n: int = 16, seed: int = 12) -> str:
    """A relabelled-Vistas tree of ``n`` 1024x768 frames."""
    from heatnet_tpu_torch.data.png import write_png

    rng = np.random.RandomState(seed)
    for d in ("images", "labels"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for i in range(n):
        name = f"v{i:05d}.png"
        write_png(os.path.join(root, "images", name),
                  rng.randint(0, 256, (768, 1024, 3)).astype(np.uint8), level=1)
        cls = (np.arange(768)[:, None] // 96 + np.arange(1024)[None, :] // 128 + i) % 14
        write_png(os.path.join(root, "labels", name),
                  (cls * 256 + rng.randint(0, 256, (768, 1024))).astype(np.uint16), level=1)
    return root


def worker(tree: str, out: str, device: str) -> None:
    """One process of a run: ``cli.main`` on ``tree``; rank 0 (or the only
    process) writes its losses and mIoUs to ``out``."""
    import torch

    from heatnet_tpu_torch.cli import main as main_cli

    run = main_cli.main(["--data", tree, "--valdata", tree, "--width", "384", "--height",
                         "192", "--batch-size", "8", "--epochs", "1", "--structure", "1",
                         "1", "1", "1", "--checkpoint-dir", out + ".ck", "--log-dir",
                         out + ".runs", "-j", "4", "--device", device])
    rank = torch.distributed.get_rank() if torch.distributed.is_initialized() else 0
    if rank == 0:
        with open(out, "w") as f:
            json.dump({"losses": run.losses, "mious": run.mious,
                       "world": (torch.distributed.get_world_size()
                                 if torch.distributed.is_initialized() else 1),
                       "device": (torch.cuda.get_device_name(0) if device == "cuda"
                                  else "cpu")}, f)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--nproc", type=int, default=2)
    p.add_argument("--device", default="cuda")
    p.add_argument("--worker", nargs=2, metavar=("TREE", "OUT"), help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker:
        worker(*args.worker, args.device)
        return 0
    if args.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        print(smi.stdout.strip(), flush=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT, os.environ.get("PYTHONPATH", "")]), OMP_NUM_THREADS="2")
    me = [os.path.abspath(__file__)]
    with tempfile.TemporaryDirectory() as work:
        tree = write_tree(os.path.join(work, "tree"))
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        runs = {}
        for tag, launcher in (
                ("one", [sys.executable]),
                (f"{args.nproc} processes",
                 [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
                  str(args.nproc), "--master_port", str(port)])):
            out = os.path.join(work, tag.replace(" ", "_") + ".json")
            proc = subprocess.run(launcher + me + ["--device", args.device, "--worker",
                                                   tree, out],
                                  env=env, capture_output=True, text=True, timeout=1200)
            if proc.returncode != 0:
                print(proc.stdout[-3000:], proc.stderr[-6000:])
                print(f"dp_check: the {tag} run failed")
                return 1
            with open(out) as f:
                runs[tag] = json.load(f)
            print(f"{tag}: {runs[tag]}", flush=True)
    a, b = runs["one"], runs[f"{args.nproc} processes"]
    loss_rel = [abs(x - y) / abs(x) for x, y in zip(a["losses"], b["losses"])]
    miou_diff = [abs(x - y) for x, y in zip(a["mious"], b["mious"])]
    ok = (b["world"] == args.nproc and len(a["losses"]) == len(b["losses"]) == 2
          and all(v <= 1e-2 for v in loss_rel) and all(v <= 1e-3 for v in miou_diff))
    print(f"dp_check: losses rel {loss_rel} (<= 1e-2), mIoU diff {miou_diff} (<= 1e-3): "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
