"""One process of the 4-process gloo run of tests/test_torch_spatial.py.

Run as ``python torch_spatial_worker.py DIR`` under a launcher-style
environment (WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR, MASTER_PORT). DIR
holds ``frames.npz`` (raw uint8 RGB and uint16 IR, NHWC, batch 1),
``frames_int8.npz`` (the same at batch 2) and one ``<case>.pt`` state_dict
per entry of ``CASES`` and for ``INT8``. Each case's model serves the frame
split by rows over all 4 processes and over the first 2
(``parallel/spatial.py::serve_frame``), its logits and cert map gathered;
rank 0 also runs it unsharded. The int8 segnet (``INT8``) is calibrated by
rows on the batch-2 frame (``calibrate_frame``) and serves it, and the batch-1
frame beside its float model; last, once ``jax_scales.pt`` appears in DIR,
it serves the batch-2 frame on JAX's scales. ``halo_rows`` runs on the rows
of a seeded tensor at halos smaller than, equal to and larger than a shard,
filled or replicated beyond the frame, and ``all_reduce_max`` on a seeded
tensor per rank. Rank 0 writes everything to
``DIR/spatial.npz``. It imports no JAX.
"""

import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from heatnet_tpu_torch.eval.validate import ingest  # noqa: E402
from heatnet_tpu_torch.models import ResNeXtSeg, build_network  # noqa: E402
from heatnet_tpu_torch.models.layers import prepare_for_inference  # noqa: E402
from heatnet_tpu_torch.ops.quant import calibrate_int8, convert_int8, int8_layers  # noqa: E402
from heatnet_tpu_torch.parallel import mesh as pm  # noqa: E402
from heatnet_tpu_torch.parallel import spatial  # noqa: E402

TINY = (1, 1, 1, 1)
# name: (architecture, keywords, modalities); the ResNeXtSeg at TINY
CASES = {
    "early3": ("resnext", {"input_channels": 3}, "rgb"),
    "early4": ("resnext", {"input_channels": 4}, "ir_rgb"),
    "late_cert": ("resnext", {"input_channels": 4, "late_fusion": True, "cert_branch": True},
                  "ir_rgb"),
    "psp_rgb": ("pspnet", {"backend": "resnet18", "in_channels": 3}, "rgb"),
    "psp_late": ("pspnet", {"backend": "resnet18", "in_channels": 4, "late_fusion": True},
                 "ir_rgb"),
}
SHARDS = (4, 2)
# The int8 segnet: early fusion at TINY, min_batch 2 (as tests/test_torch_int8.py
# sets it) and max_hw 4096: the 128x64 frame's 8192 pixels serve the stem's
# first conv float, while a full-resolution shard (32x64 = 2048 pixels over 4
# processes, 64x64 = 4096 over 2) would quantize it if the gate read the
# shard; the half-resolution layers (64x32 = 2048) quantize either way
INT8 = {"min_batch": 2, "max_hw": 4096}
JAX_SCALES_WAIT_S = 200
# (name, rows above, rows below, replicate) for a 16-row tensor over 4
# processes: a shard holds 4 rows
HALOS = (("smaller", 1, 2, False), ("equal", 4, 4, False), ("larger", 9, 6, False),
         ("replicate", 9, 6, True))
HALO_SHAPE = (1, 3, 16, 5)
HALO_FILL = -7.0


def halo_input() -> np.ndarray:
    return np.random.RandomState(3).randn(*HALO_SHAPE).astype(np.float32)


def max_input(rank: int) -> np.ndarray:
    """Rank ``rank``'s operand of ``all_reduce_max``."""
    return np.random.RandomState(10 + rank).randn(3, 5).astype(np.float32)


def build(arch: str, kw: dict) -> torch.nn.Module:
    if arch == "pspnet":
        return build_network(**kw)
    return ResNeXtSeg(structure=TINY, **kw)


def _int8_model(sd, cpu):
    model = convert_int8(build("resnext", {"input_channels": 4}), **INT8)
    model.load_state_dict(sd, strict=False)
    return prepare_for_inference(model, cpu)


def _scales(model) -> np.ndarray:
    return np.array([float(m.x_scale) for _, m in int8_layers(model)])


def _wait_for(path: str) -> None:
    deadline = time.monotonic() + JAX_SCALES_WAIT_S
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not appear within {JAX_SCALES_WAIT_S} s")
        time.sleep(0.2)


def main(work: str) -> None:
    torch.set_num_threads(1)
    assert pm.maybe_initialize_distributed(torch.device("cpu"))
    rank = dist.get_rank()
    cpu = torch.device("cpu")
    frames = dict(np.load(os.path.join(work, "frames.npz")))
    frames2 = dict(np.load(os.path.join(work, "frames_int8.npz")))
    meshes = {n: pm.create_mesh(num_devices=n) for n in SHARDS}
    served = {n: mesh for n, mesh in meshes.items() if mesh.get_coordinate() is not None}
    out = {}

    def gathered(n, seg):
        return pm.gather_rows(seg, pm.spatial_sharding(meshes[n])).numpy()

    for name, (arch, kw, modalities) in CASES.items():
        model = build(arch, kw)
        model.load_state_dict(torch.load(os.path.join(work, name + ".pt")))
        prepare_for_inference(model, cpu)
        for n, mesh in served.items():
            pred, seg, cert = spatial.serve_frame(model, frames, mesh, cpu, modalities)
            out[f"{name}/{n}/pred"] = pred.numpy()
            out[f"{name}/{n}/seg"] = gathered(n, seg)
            if cert is not None:
                out[f"{name}/{n}/cert"] = gathered(n, cert)
        if rank == 0:  # the port's own forward of the whole frame
            with torch.no_grad():
                seg, _, cert = model(*ingest(frames, modalities, cpu, torch.float32,
                                             model.late_fusion))
            out[f"{name}/1/seg"] = seg.numpy()
            if cert is not None:
                out[f"{name}/1/cert"] = cert.numpy()

    sd = torch.load(os.path.join(work, "int8.pt"))
    float_model = prepare_for_inference(build("resnext", {"input_channels": 4}), cpu)
    float_model.load_state_dict(sd)
    for n, mesh in served.items():
        model = _int8_model(sd, cpu)
        spatial.calibrate_frame(model, frames2, mesh, cpu)
        out[f"int8/{n}/scales"] = _scales(model)
        out[f"int8/{n}/b1_int8"] = gathered(n, spatial.serve_frame(model, frames, mesh, cpu)[1])
        out[f"int8/{n}/b1_float"] = gathered(
            n, spatial.serve_frame(float_model, frames, mesh, cpu)[1])
        out[f"int8/{n}/seg"] = gathered(n, spatial.serve_frame(model, frames2, mesh, cpu)[1])
    if rank == 0:
        model = _int8_model(sd, cpu)
        inputs = ingest(frames2, "ir_rgb", cpu, torch.float32)
        calibrate_int8(model, [inputs])
        out["int8/1/scales"] = _scales(model)
        with torch.no_grad():
            out["int8/1/seg"] = model(*inputs)[0].numpy()
        out["int8/names"] = np.array([name for name, _ in int8_layers(model)])

    group = pm.data_group(meshes[4])
    x = torch.from_numpy(halo_input())
    rows = HALO_SHAPE[2] // 4
    shard = x[:, :, rank * rows:(rank + 1) * rows].contiguous(memory_format=torch.channels_last)
    for name, above, below, replicate in HALOS:
        h = spatial.halo_rows(shard, above, below, group, HALO_FILL, replicate)
        assert h.is_contiguous(memory_format=torch.channels_last)
        out[f"halo/{name}"] = pm.all_gather(group, h).numpy()
    top = pm.all_reduce_max(group, torch.from_numpy(max_input(rank)))
    out["all_reduce_max"] = pm.all_gather(group, top).numpy()

    # last: the int8 segnet on JAX's scales, which the test computes meanwhile
    _wait_for(os.path.join(work, "jax_scales.pt"))
    jax_sd = torch.load(os.path.join(work, "jax_scales.pt"))
    for n, mesh in served.items():
        model = _int8_model(jax_sd, cpu)
        out[f"int8/{n}/seg_jax_scales"] = gathered(
            n, spatial.serve_frame(model, frames2, mesh, cpu)[1])
    if rank == 0:
        np.savez(os.path.join(work, "spatial.npz"), **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
