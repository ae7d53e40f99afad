"""The spatial path on the card, module by module, against the unsharded forward.

    python -m heatnet_tpu_torch.tools.spatial_layers [--procs 4] [--height 640]
        [--width 1920] [--cudnn-benchmark]

ResNeXt-50 early fusion (random weights, seed 0) serves one random raw
frame unsharded in this process, then split by rows over ``--procs`` gloo
processes sharing the one card (``parallel/spatial.py::serve_frame``), with
forward hooks on the stem, the stages, ASPP's branches and the decoder.
Prints, per module, the share of elements that differ from the unsharded
forward's and the largest difference relative to the largest |value|, the
class-map agreement, and the card time (total and by kernel name) of one
shard forward on rank 0 and of the unsharded forward (torch.profiler).
``--cudnn-benchmark`` runs every process with ``torch.backends.cudnn.benchmark``
on (cuDNN times its engines per shape and keeps the fastest; off, it takes
its heuristic's first engine), and then times the unsharded forward once more
with it off in the same process: PyTorch keeps the engine chosen per shape,
so that reading shows whether the benchmarked choice outlives the flag.
Needs a card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

MODULES = ("mod1", "mod2_1", "mod3_1", "mod4_1", "mod5_1", "aspp.conv1", "aspp.conv2",
           "aspp.conv3", "aspp.conv4", "aspp.conv5", "aspp.fuse_conv", "up_seg_2",
           "fuse_seg.conv1", "fuse_seg")


def _model(dev, weights):
    from ..models import net_resnext50
    from ..models.layers import prepare_for_inference

    net = net_resnext50(classes=13, input_channels=4)
    net.load_state_dict(torch.load(weights, map_location="cpu", weights_only=True))
    net = prepare_for_inference(net, dev)
    acts = {}
    for name in MODULES:
        net.get_submodule(name).register_forward_hook(
            lambda m, i, out, name=name: acts.__setitem__(
                name, out if torch.is_tensor(out) else out[0]))
    return net, acts


def _kernel_ms(fn):
    """Card ms of one call of ``fn``: the total, and by kernel name (the six
    largest, largest first)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    ms = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms[e.name[:80]] = ms.get(e.name[:80], 0.0) + e.device_time_total / 1e3
    return sum(ms.values()), sorted(ms.items(), key=lambda kv: -kv[1])[:6]


def worker(work: str) -> None:
    import torch.distributed as dist

    from ..parallel import mesh as pm
    from ..parallel import spatial

    rank = int(os.environ["RANK"])
    torch.backends.cudnn.benchmark = os.environ.get("CUDNN_BENCHMARK") == "1"
    torch.cuda.set_device(0)
    dev = torch.device("cuda")
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{os.environ['PORT']}",
                            rank=rank, world_size=int(os.environ["WORLD_SIZE"]))
    net, acts = _model(dev, os.path.join(work, "weights.pt"))
    frames = dict(np.load(os.path.join(work, "frames.npz")))
    mesh = pm.create_mesh()
    total, top = _kernel_ms(lambda: spatial.serve_frame(net, frames, mesh, dev))
    group = pm.data_group(mesh)
    out = {}
    for name in MODULES:
        a = acts[name]
        out[name] = (a if a.shape[2] == 1 else torch.cat(
            pm.all_gather(group, a).unbind(0), dim=2)).float().cpu().numpy()
    if rank == 0:
        np.savez(os.path.join(work, "sharded.npz"), **out)
        print(f"rank 0, one shard forward: card {total:.3f} ms; by kernel: {top}", flush=True)
    dist.destroy_process_group()


def main(argv=None) -> None:
    from ..data.loaders import to_device
    from ..models import net_resnext50
    from ..models.layers import init_params
    from ..ops import fused_preproc as fp

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--procs", type=int, default=4)
    p.add_argument("--height", type=int, default=640)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--cudnn-benchmark", action="store_true")
    p.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("spatial_layers needs a CUDA card")
    if args.worker:
        worker(args.worker)
        return
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    torch.backends.cudnn.benchmark = args.cudnn_benchmark
    print(f"torch.backends.cudnn.benchmark = {args.cudnn_benchmark}", flush=True)
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as work:
        net = net_resnext50(classes=13, input_channels=4)
        init_params(net, torch.Generator().manual_seed(0))
        torch.save(net.state_dict(), os.path.join(work, "weights.pt"))
        rng = np.random.RandomState(13)
        h, w = args.height, args.width
        frames = {"rgb": rng.randint(0, 256, (1, h, w, 3)).astype(np.uint8),
                  "ir": rng.randint(21000, 26000, (1, h, w, 1)).astype(np.uint16)}
        np.savez(os.path.join(work, "frames.npz"), **frames)
        net, acts = _model(dev, os.path.join(work, "weights.pt"))
        x = fp.early_fusion_input(to_device(frames["rgb"], dev), to_device(frames["ir"], dev),
                                  0, w, net.compute_dtype)
        with torch.no_grad():
            total, top = _kernel_ms(lambda: net(x))
        ref = {k: v.float().cpu().numpy() for k, v in acts.items()}
        print(f"unsharded forward: card {total:.3f} ms; by kernel: {top}", flush=True)
        if args.cudnn_benchmark:
            torch.backends.cudnn.benchmark = False
            with torch.no_grad():
                total, top = _kernel_ms(lambda: net(x))
            print(f"unsharded forward, benchmark off again in this process: card "
                  f"{total:.3f} ms; by kernel: {top}", flush=True)
        env = dict(os.environ, WORLD_SIZE=str(args.procs), PORT=str(_free_port()),
                   CUDNN_BENCHMARK=str(int(args.cudnn_benchmark)))
        procs = [subprocess.Popen([sys.executable, "-m", "heatnet_tpu_torch.tools.spatial_layers",
                                   "--worker", work], env=dict(env, RANK=str(r)))
                 for r in range(args.procs)]
        try:
            codes = [q.wait(timeout=600) for q in procs]
        finally:
            for q in procs:
                if q.poll() is None:
                    q.kill()
        if any(codes):
            raise SystemExit(f"a worker failed: exit codes {codes}")
        got = np.load(os.path.join(work, "sharded.npz"))
        for name in MODULES:
            a, b = got[name], ref[name]
            print(f"{name:16s} {str(b.shape):22s} elements that differ {float((a != b).mean()):.6f}, "
                  f"largest difference {float(np.abs(a - b).max() / np.abs(b).max()):.3g} of the "
                  f"largest |value|", flush=True)
        a, b = got["fuse_seg"].argmax(1), ref["fuse_seg"].argmax(1)
        print(f"class-map agreement {float((a == b).mean()):.6f}", flush=True)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


if __name__ == "__main__":
    main()
