"""The cases that tests/test_torch_mesh.py runs in one process on the whole
batch and torch_mesh_worker.py runs in each of two processes on its rows:
one train step of a (1,1,1,1) ResNeXtSeg and one validation. No JAX."""

import numpy as np
import torch

from heatnet_tpu_torch.eval.validate import validate_model
from heatnet_tpu_torch.models import NormAct, ResNeXtSeg
from heatnet_tpu_torch.parallel import mesh as pm
from heatnet_tpu_torch.train.state import TrainState, init_model
from heatnet_tpu_torch.train.supervised import make_train_step

BATCH, H, W = 4, 48, 64


def _batch():
    rng = np.random.RandomState(5)
    image = rng.randn(BATCH, H, W, 4)
    image[:2] = image[:2] * 2.0 + 0.5  # unlike statistics per process
    label = rng.randint(0, 13, (BATCH, H, W))
    label[rng.rand(BATCH, H, W) < 0.1] = 13  # ignored, unevenly per process
    return image, label


IMPLS = ("default", "lean", "bn_groups2")


def train_step(impl: str, mesh=None) -> dict:
    """One SGD step (lr 0.1, so the update is the gradient's scale) on the
    whole batch, or on this process's rows of it over ``mesh``; returns the
    loss and accuracy, every parameter's update and every buffer after the
    step. ``impl``
    is the BN: the default, the lean one (the caller sets
    ``HEATNET_BN_IMPL``), or the default with statistics per batch half.

    In float64: at random init this net's float32 gradients in mod3-mod5
    move by 1e-3 of their size when only the batch's order changes, so f32
    would hide a fault in the data-parallel sums under rounding."""
    norm_act = NormAct(bn_groups=2 if impl == "bn_groups2" else 1)
    model = init_model(ResNeXtSeg(structure=(1, 1, 1, 1), input_channels=4,
                                  norm_act=norm_act), seed=3, device="cpu").double()
    for m in model.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float64
    if mesh is not None:
        pm.replicate(mesh, model)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    state = TrainState(model, opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda _: 1.0))
    image, label = pm.shard_batch(mesh, _batch())
    with pm.data_parallel(mesh):
        _, metrics = make_train_step(model, mesh=mesh)(
            state, {"image": torch.from_numpy(image), "label": torch.from_numpy(label)})
    out = {f"{impl}/loss": float(metrics["loss"]),
           f"{impl}/accuracy": float(metrics["accuracy"])}
    for k, p in model.named_parameters():
        out[f"{impl}/update/{k}"] = (p.detach() - before[k]).numpy()
    for k, b in model.named_buffers():
        out[f"{impl}/buffer/{k}"] = b.numpy().copy()
    return out


def frames(n: int = 5):
    rng = np.random.RandomState(8)
    for _ in range(n):
        yield {"rgb": rng.randint(0, 256, (1, H, W, 3)).astype(np.uint8),
               "ir": rng.randint(21000, 26000, (1, H, W, 1)).astype(np.uint16),
               "label": rng.randint(0, 14, (1, H, W)).astype(np.uint8)}


def validate(mesh=None) -> np.ndarray:
    """The Freiburg validator's IoUs of 5 frames in batches of 2 (rounded up
    to the mesh's data size: the tail is padded)."""
    model = init_model(ResNeXtSeg(structure=(1, 1, 1, 1), input_channels=4), seed=4,
                       device="cpu").eval()
    return validate_model(model, frames(), "ir_rgb", batch_size=2, device="cpu", mesh=mesh)
