"""One process of the 4-process gloo run of tests/test_torch_spatial.py.

Run as ``python torch_spatial_worker.py DIR`` under a launcher-style
environment (WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR, MASTER_PORT). DIR
holds ``frames.npz`` (raw uint8 RGB and uint16 IR, NHWC, batch 1) and one
``<case>.pt`` state_dict per entry of ``CASES``. Each case's model serves
the frame split by rows over all 4 processes and over the first 2
(``parallel/spatial.py::serve_frame``), its logits and cert map gathered;
rank 0 also runs it unsharded. ``halo_rows`` runs on the rows of a seeded
tensor at halos smaller than, equal to and larger than a shard. Rank 0
writes everything to ``DIR/spatial.npz``. It imports no JAX.
"""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from heatnet_tpu_torch.eval.validate import ingest  # noqa: E402
from heatnet_tpu_torch.models import ResNeXtSeg  # noqa: E402
from heatnet_tpu_torch.models.layers import prepare_for_inference  # noqa: E402
from heatnet_tpu_torch.parallel import mesh as pm  # noqa: E402
from heatnet_tpu_torch.parallel import spatial  # noqa: E402

TINY = (1, 1, 1, 1)
# name: (ResNeXtSeg keywords, modalities)
CASES = {
    "early3": ({"input_channels": 3}, "rgb"),
    "early4": ({"input_channels": 4}, "ir_rgb"),
    "late_cert": ({"input_channels": 4, "late_fusion": True, "cert_branch": True}, "ir_rgb"),
}
SHARDS = (4, 2)
# (name, rows above, rows below) for a 16-row tensor over 4 processes: a
# shard holds 4 rows
HALOS = (("smaller", 1, 2), ("equal", 4, 4), ("larger", 9, 6))
HALO_SHAPE = (1, 3, 16, 5)
HALO_FILL = -7.0


def halo_input() -> np.ndarray:
    return np.random.RandomState(3).randn(*HALO_SHAPE).astype(np.float32)


def main(work: str) -> None:
    torch.set_num_threads(1)
    assert pm.maybe_initialize_distributed(torch.device("cpu"))
    rank = dist.get_rank()
    cpu = torch.device("cpu")
    frames = dict(np.load(os.path.join(work, "frames.npz")))
    meshes = {n: pm.create_mesh(num_devices=n) for n in SHARDS}
    out = {}
    for name, (kw, modalities) in CASES.items():
        model = ResNeXtSeg(structure=TINY, **kw)
        model.load_state_dict(torch.load(os.path.join(work, name + ".pt")))
        prepare_for_inference(model, cpu)
        for n, mesh in meshes.items():
            if mesh.get_coordinate() is None:
                continue
            pred, seg, cert = spatial.serve_frame(model, frames, mesh, cpu, modalities)
            sharding = pm.spatial_sharding(mesh)
            out[f"{name}/{n}/pred"] = pred.numpy()
            out[f"{name}/{n}/seg"] = pm.gather_rows(seg, sharding).numpy()
            if cert is not None:
                out[f"{name}/{n}/cert"] = pm.gather_rows(cert, sharding).numpy()
        if rank == 0:  # the port's own forward of the whole frame
            with torch.no_grad():
                seg, _, cert = model(*ingest(frames, modalities, cpu, torch.float32,
                                             model.late_fusion))
            out[f"{name}/1/seg"] = seg.numpy()
            if cert is not None:
                out[f"{name}/1/cert"] = cert.numpy()

    group = pm.data_group(meshes[4])
    x = torch.from_numpy(halo_input())
    rows = HALO_SHAPE[2] // 4
    shard = x[:, :, rank * rows:(rank + 1) * rows].contiguous(memory_format=torch.channels_last)
    for name, above, below in HALOS:
        h = spatial.halo_rows(shard, above, below, group, HALO_FILL)
        assert h.is_contiguous(memory_format=torch.channels_last)
        out[f"halo/{name}"] = pm.all_gather(group, h).numpy()
    if rank == 0:
        np.savez(os.path.join(work, "spatial.npz"), **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
