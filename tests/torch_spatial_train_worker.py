"""One process of the 4-process gloo run of tests/test_torch_spatial_train.py.

Run as ``python torch_spatial_train_worker.py DIR`` under a launcher-style
environment (WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR, MASTER_PORT). DIR
holds ``<case>.pt`` for each case of ``JAX_CASES`` (the state_dict of the JAX
model's weights); ``psp_masks.pt`` (JAX's dropout keep masks of each step)
and ``<case>_grads.pt`` (JAX's step-0 gradients under the port's names)
appear there while this runs. Every case trains by rows
(``parallel/spatial.py::train_frames``, the step of
``train/supervised.py::make_train_step`` with the mesh) over all 4
processes:

- ``JAX_CASES``: the (1,1,1,1) ResNeXtSeg and PSPNet-ResNet-18 (RGB only,
  on JAX's masks) in float32, Adam at lr 1e-6, ``STEPS`` steps, then again
  over the first 2 processes; the losses, the relative L2 distance of each
  step-0 gradient from JAX's, and the eval logits of the whole held-out batch
  after the steps;
- ``F64``: float64 models from seeded weights, one SGD step; rank 2 or 3
  runs it unsharded while the 2-process mesh leaves it idle (``REFERENCES``)
  and sends its result to rank 0, which records for every gradient,
  parameter and buffer the largest difference from it beside the tensor's
  largest |value|;
- ``halo_rows`` at ``torch_spatial_worker.HALOS``, ``global_mean`` and
  ``frame_pool``: the gradient of a seeded linear function of each rank's
  output, gathered.

After every step each rank all-gathers a checksum of its parameters and
buffers: the replicas must stay equal. Rank 0 writes ``DIR/train.npz``. It
imports no JAX.
"""

import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from heatnet_tpu_torch.models import NormAct, ResNeXtSeg, build_network  # noqa: E402
from heatnet_tpu_torch.models.layers import adaptive_avg_pool, global_avg_pool  # noqa: E402
from heatnet_tpu_torch.parallel import mesh as pm  # noqa: E402
from heatnet_tpu_torch.parallel import spatial  # noqa: E402
from heatnet_tpu_torch.train.optim import create_optimizer  # noqa: E402
from heatnet_tpu_torch.train.state import TrainState, init_model  # noqa: E402
from heatnet_tpu_torch.train.supervised import make_train_step  # noqa: E402

from torch_spatial_worker import HALO_FILL, HALO_SHAPE, HALOS, halo_input  # noqa: E402

TINY = (1, 1, 1, 1)
H, W = 128, 64  # 4 rows per shard at stride 8 over 4 processes
SHARDS = (4, 2)
STEPS = 3
ADAM = {"type": "Adam", "learning_rate": 1e-6}
SGD_LR = 0.1
# name: (architecture, keywords, image channels, data seed), float32 against JAX
JAX_CASES = {
    "resnext": ("resnext", {"input_channels": 4}, 4, 1),
    "psp": ("pspnet", {"backend": "resnet18", "in_channels": 3}, 3, 3),
}
# float64 against the port's own unsharded step:
# name: (architecture, keywords, batch, HEATNET_BN_IMPL)
F64 = {
    "early": ("resnext", {"input_channels": 4}, 2, None),
    "late_cert": ("resnext", {"input_channels": 4, "late_fusion": True, "cert_branch": True},
                  2, None),
    "bn_groups2": ("resnext", {"input_channels": 4, "norm_act": NormAct(bn_groups=2)}, 4,
                   None),
    "lean": ("resnext", {"input_channels": 4}, 2, "lean"),
    "psp64": ("pspnet", {"backend": "resnet18", "in_channels": 3}, 2, None),
}
# the F64 cases that ranks 2 and 3 run unsharded while ranks 0 and 1 run each
# JAX case over 2 processes: ((rank 2's, rank 3's) for each JAX case)
REFERENCES = ((("early",), ("late_cert",)), (("bn_groups2",), ("lean", "psp64")))
OWNER = {name: 2 + i for case in REFERENCES for i, names in enumerate(case) for name in names}
POOL_SIZES = (1, 2, 3, 6)
WAIT_S = 240


def batches(n: int, batch: int, channels: int, seed: int):
    """``n`` batches of normalised NHWC images in [-1, 1] and labels with
    about a tenth of the pixels ignored (13)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        image = (rng.rand(batch, H, W, channels) * 2 - 1).astype(np.float32)
        image[: batch // 2] *= 0.5  # unlike statistics per sample
        label = rng.randint(0, 13, (batch, H, W))
        label[rng.rand(batch, H, W) < 0.1] = 13
        out.append((image, label))
    return out


def held_out(channels: int) -> np.ndarray:
    return batches(1, 2, channels, seed=99)[0][0]


def weight_of(rank: int, shape) -> torch.Tensor:
    """Rank ``rank``'s seeded coefficients of the linear function whose
    gradient the exchange tests read."""
    return torch.from_numpy(np.random.RandomState(40 + rank).randn(*shape))


class ImageSplit(nn.Module):
    """A late-fusion net fed the supervised step's 4-channel image (RGB then
    IR); its logits are ``seg + cert * ramp`` (a ramp over the classes), so
    that the step's loss reads the cert branch too."""

    def __init__(self, net: nn.Module):
        super().__init__()
        self.net = net

    def forward(self, image):
        seg, taps, cert = self.net(image[..., :3], image[..., 3:])
        ramp = torch.linspace(-1.0, 1.0, seg.shape[-1], dtype=seg.dtype)
        return seg + cert * ramp, taps, cert


def build(arch: str, kw: dict) -> nn.Module:
    if arch == "pspnet":
        return build_network(**kw)
    return ResNeXtSeg(structure=TINY, **kw)


def f64_model(name: str) -> nn.Module:
    arch, kw, _, _ = F64[name]
    model = init_model(build(arch, kw), seed=7, device="cpu").double()
    for m in model.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float64
    return ImageSplit(model) if kw.get("late_fusion") else model


def checksum(model: nn.Module) -> torch.Tensor:
    """Sum and sum of squares of every parameter and buffer, in float64."""
    ts = [t.detach().double() for t in list(model.parameters()) + list(model.buffers())]
    return torch.stack([sum(t.sum() for t in ts), sum(t.square().sum() for t in ts)])


def train(model, data, mesh, optimizer, masks=None):
    """``len(data)`` steps, by rows over ``mesh`` or (None) unsharded.
    Returns the losses and accuracies, the step-0 gradients, the parameters
    and buffers after the steps, and (by rows) whether every process of the
    mesh holds the same parameters and buffers after each step."""
    opt, sched = optimizer(model.parameters())
    grads = {}

    def keep(*_):  # a parameter no loss reads has no gradient: zeros
        if not grads:
            grads.update({k: torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
                          for k, p in model.named_parameters()})

    opt.register_step_pre_hook(keep)
    state = TrainState(model, opt, sched)
    step = make_train_step(model, mesh=mesh)
    out = {"loss": [], "accuracy": [], "replicas_equal": []}
    for i, (image, label) in enumerate(data):
        batch = {"image": torch.from_numpy(image), "label": torch.from_numpy(label)}
        dropout = None if masks is None else masks[i]
        if mesh is None:
            _, m = step(state, batch, dropout)
        else:
            _, m = spatial.train_frames(step, state, batch, mesh, dropout)
            sums = pm.all_gather(pm.data_group(mesh), checksum(model))
            out["replicas_equal"].append(bool((sums == sums[0]).all()))
        out["loss"].append(float(m["loss"]))
        out["accuracy"].append(float(m["accuracy"]))
    out["tensors"] = {**{f"grad/{k}": v for k, v in grads.items()},
                      **{f"param/{k}": p.detach() for k, p in model.named_parameters()},
                      **{f"buffer/{k}": b for k, b in model.named_buffers()}}
    return out


def adam(params):
    return create_optimizer(ADAM, params)


def sgd(params):
    opt = torch.optim.SGD(params, lr=SGD_LR)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda _: 1.0)


def wait_for(path: str) -> None:
    deadline = time.monotonic() + WAIT_S
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not appear within {WAIT_S} s")
        time.sleep(0.2)


def flat(rec: dict) -> torch.Tensor:
    """A record's losses, accuracies and tensors in one float64 vector."""
    parts = [torch.tensor(rec["loss"] + rec["accuracy"], dtype=torch.float64)]
    parts += [rec["tensors"][k].reshape(-1).double() for k in sorted(rec["tensors"])]
    return torch.cat(parts)


def differences(got: dict, want: torch.Tensor) -> dict:
    """Per entry of ``got``: the largest |got - want| and the largest |want|,
    ``want`` being ``flat`` of the unsharded record."""
    n = len(got["loss"])
    out = {"loss": got["loss"], "loss_unsharded": want[:n].tolist(),
           "accuracy": got["accuracy"], "accuracy_unsharded": want[n:2 * n].tolist(),
           "replicas_equal": got["replicas_equal"]}
    names, diffs, scales, offset = [], [], [], 2 * n
    for k in sorted(got["tensors"]):
        t = got["tensors"][k].reshape(-1).double()
        ref = want[offset:offset + t.numel()]
        offset += t.numel()
        names.append(k)
        diffs.append(float((t - ref).abs().max()) if t.numel() else 0.0)
        scales.append(float(ref.abs().max()) if t.numel() else 0.0)
    assert offset == want.numel()
    out.update(names=np.array(names), diff=np.array(diffs), scale=np.array(scales))
    return out


def rel_l2(got: dict, want: dict) -> dict:
    """Per step-0 gradient that JAX's step gives: the relative L2 distance
    of the port's from JAX's and the norm of JAX's."""
    names = sorted(k for k in want)
    grads = got["tensors"]
    dist_, norm = [], []
    for k in names:
        w = want[k].double()
        g = grads[f"grad/{k}"].double() if f"grad/{k}" in grads else torch.zeros_like(w)
        norm.append(float(w.norm()))
        dist_.append(float((g - w).norm() / (w.norm() + 1e-12)))
    return {"names": np.array(names), "rel_l2": np.array(dist_), "norm": np.array(norm)}


def exchanges(mesh, rank: int) -> dict:
    """The gradients of ``halo_rows``, ``global_mean`` and ``frame_pool`` of
    this rank's rows of ``halo_input()`` for every rank, gathered."""
    group = pm.data_group(mesh)
    rows = HALO_SHAPE[2] // 4
    x = torch.from_numpy(halo_input()).double()
    out = {}

    def grad_of(fn, name):
        shard = x[:, :, rank * rows:(rank + 1) * rows].contiguous(
            memory_format=torch.channels_last).requires_grad_()
        y = fn(shard)
        (y * weight_of(rank, y.shape)).sum().backward()
        out[name] = pm.all_gather(group, shard.grad.contiguous()).numpy()

    for name, above, below, replicate in HALOS:
        spatial.reset_exchange()
        grad_of(lambda s: spatial.halo_rows(s, above, below, group, HALO_FILL, replicate),
                f"halo/{name}")
        out[f"halo/{name}/bwd_calls"] = np.array(spatial.EXCHANGE["bwd_calls"])
    with spatial.spatial_parallel(mesh):
        grad_of(global_avg_pool, "global_mean")
        for size in POOL_SIZES:
            grad_of(lambda s: adaptive_avg_pool(s, (size, size), frame=True), f"pool/{size}")
    return out


def _f64_run(name: str, mesh):
    """Case ``name`` of ``F64``: one SGD step, by rows over ``mesh`` or
    (None) unsharded."""
    arch, _, batch, impl = F64[name]
    os.environ.pop("HEATNET_BN_IMPL", None)
    if impl:
        os.environ["HEATNET_BN_IMPL"] = impl
    data = batches(1, batch, 3 if arch == "pspnet" else 4, seed=2)
    masks = ([build_network().draw_dropout(batch, torch.Generator().manual_seed(5))]
             if arch == "pspnet" else None)
    try:
        return train(f64_model(name), data, mesh, sgd, masks)
    finally:
        os.environ.pop("HEATNET_BN_IMPL", None)


def main(work: str) -> None:
    torch.set_num_threads(1)
    assert pm.maybe_initialize_distributed(torch.device("cpu"))
    rank = dist.get_rank()
    meshes = {n: pm.create_mesh(num_devices=n) for n in SHARDS}
    served = {n: mesh for n, mesh in meshes.items() if mesh.get_coordinate() is not None}
    out = exchanges(meshes[4], rank)

    def put(prefix, rec):
        out.update({f"{prefix}/{k}": np.asarray(v) for k, v in rec.items()})

    # float32 against JAX, over 4 processes, then over 2 while ranks 2 and 3
    # run the float64 cases unsharded (REFERENCES); rank 0 keeps its step-0
    # gradients until JAX's appear
    kept, refs = {}, {}
    for (name, (arch, kw, channels, seed)), idle in zip(JAX_CASES.items(), REFERENCES):
        masks = None
        if arch == "pspnet":
            wait_for(os.path.join(work, "psp_masks.pt"))
            masks = torch.load(os.path.join(work, "psp_masks.pt"))
        data = batches(STEPS, 2, channels, seed)
        for n, mesh in meshes.items():
            if mesh.get_coordinate() is None:
                for ref in idle[rank - 2]:
                    refs[ref] = flat(_f64_run(ref, None))
                continue
            model = build(arch, kw)
            model.load_state_dict(torch.load(os.path.join(work, f"{name}.pt")))
            rec = train(model.train(), data, mesh, adam, masks)
            with torch.no_grad():
                rec["eval"] = model.eval()(torch.from_numpy(held_out(channels)))[0].numpy()
            rec["tensors"] = {k: v for k, v in rec["tensors"].items() if k.startswith("grad/")}
            kept[f"{name}/{n}"] = rec
            put(f"{name}/{n}", {k: v for k, v in rec.items() if k != "tensors"})

    # float64 by rows over 4 processes against the unsharded step, which its
    # rank sends to rank 0
    for name in F64:
        got = _f64_run(name, meshes[4])
        if name in refs:
            dist.send(refs.pop(name), dst=0)
        if rank == 0:
            want = torch.empty_like(flat(got))
            dist.recv(want, src=OWNER[name])
            put(f"{name}/4", differences(got, want))
        del got

    if rank == 0:
        for key, rec in kept.items():
            path = os.path.join(work, f"{key.split('/')[0]}_grads.pt")
            wait_for(path)
            put(key, rel_l2(rec, torch.load(path)))
        np.savez(os.path.join(work, "train.npz"), **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
