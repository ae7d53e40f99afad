"""One process of the 2-process gloo run of tests/test_torch_mesh.py.

Run as ``python torch_mesh_worker.py OUT_DIR`` under a launcher-style
environment (WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR, MASTER_PORT). It
joins the group, checks the meshes, runs one data-parallel train step of a
(1,1,1,1) ResNeXtSeg on its rows of the global batch (the default BN, then
the lean one) and a data-parallel validation; rank 0 writes the results to
``OUT_DIR/dp.npz``. It imports no JAX.
"""

import os
import sys
import warnings

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from heatnet_tpu_torch.parallel import mesh as pm  # noqa: E402

import torch_mesh_cases as cases  # noqa: E402


def main(out_dir: str) -> None:
    torch.set_num_threads(1)
    assert pm.maybe_initialize_distributed(torch.device("cpu"))
    rank = torch.distributed.get_rank()
    mesh = pm.create_mesh()
    assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (2, 1)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        small = pm.mesh_for_batch(3)
    assert any("uses only 1 of 2 devices" in str(w.message) for w in caught)
    assert tuple(small.shape) == (1, 1)
    assert (small.get_coordinate() is None) == (rank == 1)

    tp = pm.create_mesh(model_parallel=2)
    assert tuple(tp.shape) == (1, 2)
    placed = pm.shard_params_tp(tp, {"big": torch.ones(64, 8, 3, 3),
                                     "small": torch.ones(32, 8, 3, 3),
                                     "bias": torch.ones(64)})
    placements = {k: [type(p).__name__ for p in v.placements] for k, v in placed.items()}
    assert placements == {"big": ["Replicate", "Shard"], "small": ["Replicate", "Replicate"],
                          "bias": ["Replicate", "Replicate"]}, placements
    assert tuple(placed["big"].to_local().shape) == (32, 8, 3, 3)

    results = {}
    for impl in cases.IMPLS:
        os.environ["HEATNET_BN_IMPL"] = impl
        results.update(cases.train_step(impl, mesh))
    os.environ.pop("HEATNET_BN_IMPL")
    results["ious"] = cases.validate(mesh)
    if rank == 0:
        np.savez(os.path.join(out_dir, "dp.npz"), **results)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
