"""Process meshes and data parallelism over ``torch.distributed``.

Counterpart of ``heatnet_tpu/parallel/mesh.py``. The JAX package declares a
``Mesh`` with axes ``("data", "model")``, shards batches over ``data`` and
lets XLA insert the collectives; here the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the same dimension names,
one process per card, and the collectives that XLA inserts for JAX are
written out:

- ``maybe_initialize_distributed``: joins the process group that PyTorch's
  launcher describes (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
  ``MASTER_ADDR``, ``MASTER_PORT``, as ``torchrun`` sets them), NCCL on the
  card and gloo on the CPU, then one barrier (JAX's
  ``_rendezvous_collective``). Without ``WORLD_SIZE`` it does nothing.
- ``shard_batch``: every process holds the same global batch (the loaders
  are seeded alike, JAX's ``_put_global`` choice, :103-118) and keeps its
  own rows of the ``data`` dimension.
- ``replicate``: a broadcast from the first process of the ``data`` row.
- ``shard_params_tp``: ``distribute_tensor`` with ``Shard(0)`` over
  ``model`` for weights of at least ``min_channels`` outputs (the port's
  weights are OIHW, so JAX's last dimension is dimension 0 here),
  ``Replicate`` otherwise.
- ``all_reduce_gradients``: the gradient sum over ``data``; with the loss
  of each process's rows divided by the whole batch's count
  (``global_count``), it is the gradient of the whole batch's mean loss.
- ``data_parallel(mesh)``: while it is active, train-mode BN statistics
  are those of the whole batch across processes (``batch_stats_group``,
  read by ``models/layers.py``): the count, sum and sum of squares are
  all-reduced in the forward and the matching sums in the backward, as
  XLA reduces a sharded batch's moments (``tests/test_mesh.py:52``).
  Over one process the all-reduce is the identity, and the layers keep
  their single-process path.

- ``spatial_sharding`` (:207-217): NHWC dimension 1, the height, over
  ``data``, for batch-1 serving of frames too large for one card.
  ``shard_rows`` keeps this process's block of rows (rank r of n: rows
  ``[r*H/n, (r+1)*H/n)``) and ``gather_rows`` puts the blocks back
  together. JAX's GSPMD inserts the halo exchanges the convolutions need and
  takes uneven shards; here the exchanges are written out in
  ``parallel/spatial.py``, and H must be a multiple of 8·n: the net's output
  stride is 8, so every stride-2 window of every shard starts on the shard's
  first row (ROADMAP §3, divergences by design).
- ``all_gather`` and ``all_reduce_sum``: the collectives of the spatial
  path, by the group's backend: NCCL moves card tensors directly; gloo
  carries host tensors, so a card tensor is staged through host memory
  explicitly and comes back to the card. A backend that cannot carry the
  tensor raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import warnings
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

DATA_AXIS = "data"
MODEL_AXIS = "model"

_BATCH_STATS_GROUP = None


def maybe_initialize_distributed(device: Optional[torch.device] = None,
                                 timeout_s: float = 600.0) -> bool:
    """Join the launcher's process group; True when one is joined.

    A no-op (False) without ``WORLD_SIZE`` in the environment; True at once
    when the default group exists already. The backend is NCCL when the run
    is on the card (``device``, or a card present when it is None), each
    process on card ``LOCAL_RANK``, and gloo on the CPU.
    """
    if "WORLD_SIZE" not in os.environ:
        return False
    if dist.is_initialized():
        return True
    on_card = torch.cuda.is_available() if device is None else device.type == "cuda"
    backend = "gloo"
    if on_card:
        backend = "nccl"
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend, init_method="env://",
                            timeout=datetime.timedelta(seconds=timeout_s))
    _rendezvous_collective()
    return True


def _rendezvous_collective() -> None:
    """One barrier right after joining: a broken link fails here, before a
    model is built, and every process starts its work together."""
    if dist.get_world_size() > 1:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def _ensure_group() -> None:
    """A single-process group (an in-memory store, no network) when no
    launcher started one, so that a mesh of one process can be built."""
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def create_mesh(num_devices: int = -1, model_parallel: int = 1):
    """A ``(data, model)`` mesh over the first ``num_devices`` processes (all
    of them for -1), one card each; ``model_parallel`` is the size of the
    ``model`` dimension."""
    from torch.distributed.device_mesh import DeviceMesh

    _ensure_group()
    n = dist.get_world_size() if num_devices <= 0 else min(num_devices,
                                                           dist.get_world_size())
    if n % model_parallel != 0:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    ranks = torch.arange(n).reshape(n // model_parallel, model_parallel)
    return DeviceMesh(_device_type(), ranks, mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def mesh_for_batch(batch_size: int, model_parallel: int = 1):
    """A mesh whose ``data`` size is the largest process count that divides
    the batch; the processes left out idle, with a warning (a process
    outside the mesh has no coordinate: ``mesh.get_coordinate()`` is None)."""
    _ensure_group()
    total = dist.get_world_size()
    n = total // model_parallel
    while n > 1 and batch_size % n != 0:
        n -= 1
    used = max(n, 1) * model_parallel
    if used < total:
        warnings.warn(
            f"batch size {batch_size} uses only {used} of {total} devices "
            f"({total - used} idle) — pick a batch divisible by "
            f"{total // model_parallel} to use the whole slice",
            RuntimeWarning, stacklevel=2)
    return create_mesh(num_devices=used, model_parallel=model_parallel)


def data_size(mesh) -> int:
    """The size of the mesh's ``data`` dimension (1 without a mesh)."""
    return 1 if mesh is None else mesh.size(mesh.mesh_dim_names.index(DATA_AXIS))


def _map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def shard_batch(mesh, batch):
    """This process's rows of a global batch (a dict, list or tuple of
    arrays or tensors, leading dimension the batch, which the ``data`` size
    must divide)."""
    d = data_size(mesh)
    if d == 1:
        return batch
    r = mesh.get_local_rank(DATA_AXIS)

    def rows(x):
        if x.shape[0] % d:
            raise ValueError(f"batch {x.shape[0]} not divisible by the data axis ({d})")
        k = x.shape[0] // d
        return x[r * k:(r + 1) * k]

    return _map(rows, batch)


def replicate(mesh, tree):
    """The values of the first process of this process's ``data`` row on
    every process of the row, in place: a module's parameters and buffers,
    or the tensors of a dict, list or tuple."""
    group = data_group(mesh)
    src = dist.get_global_rank(group, 0)
    tensors = (list(tree.parameters()) + list(tree.buffers())
               if isinstance(tree, nn.Module) else _leaves(tree))
    with torch.no_grad():
        for t in tensors:
            if isinstance(t, torch.Tensor):
                dist.broadcast(t.data, src=src, group=group)
    return tree


def pad_batch_to(batch, global_batch: int):
    """Right-pad every array's leading dimension to ``global_batch`` by
    repeating the last row; returns (padded batch, rows before padding)."""

    def pad(x):
        n = x.shape[0]
        if n == global_batch:
            return x
        if isinstance(x, torch.Tensor):
            return torch.cat([x, x[-1:].expand(global_batch - n, *x.shape[1:])])
        return np.concatenate([x, np.repeat(x[-1:], global_batch - n, axis=0)])

    return _map(pad, batch), _leaves(batch)[0].shape[0]


def shard_params_tp(mesh, params, min_channels: int = 64):
    """Tensor-parallel placement of a ``state_dict``-like mapping: a weight
    with two or more dimensions and at least ``min_channels`` outputs (dim 0,
    divisible by the ``model`` size) is sharded on dim 0 over ``model``;
    everything else is replicated. Returns a dict of DTensors."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    tp = mesh.size(mesh.mesh_dim_names.index(MODEL_AXIS))

    def place(x):
        if (tp > 1 and x.ndim >= 2 and x.shape[0] >= min_channels
                and x.shape[0] % tp == 0):
            return distribute_tensor(x, mesh, [Replicate(), Shard(0)])
        return distribute_tensor(x, mesh, [Replicate(), Replicate()])

    return {k: place(v) for k, v in params.items()}


def data_group(mesh):
    """The process group of the ``data`` dimension, or None without a mesh."""
    return None if mesh is None else mesh.get_group(DATA_AXIS)


def global_count(mesh, count: torch.Tensor) -> torch.Tensor:
    """``count`` summed over the ``data`` dimension (no gradient)."""
    if mesh is None:
        return count
    count = count.detach().clone()
    dist.all_reduce(count, group=data_group(mesh))
    return count


def all_reduce_gradients(mesh, params) -> None:
    """Sum the gradients of ``params`` over the ``data`` dimension, in one
    flat buffer per dtype."""
    grads = [p.grad for p in params if p.grad is not None]
    if mesh is None or not grads:
        return
    group = data_group(mesh)
    by_dtype = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for gs in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in gs])
        dist.all_reduce(flat, group=group)
        offset = 0
        for g in gs:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def batch_stats_group() -> Optional[Any]:
    """The process group over which train-mode BN statistics are taken, or
    None for this process's batch alone (see ``data_parallel``)."""
    return _BATCH_STATS_GROUP


@contextlib.contextmanager
def data_parallel(mesh):
    """Train-mode BN statistics over the whole batch of the mesh's ``data``
    dimension while the block runs (only when it spans several processes)."""
    global _BATCH_STATS_GROUP
    prev = _BATCH_STATS_GROUP
    _BATCH_STATS_GROUP = data_group(mesh) if data_size(mesh) > 1 else None
    try:
        yield mesh
    finally:
        _BATCH_STATS_GROUP = prev


# The net's output stride: InitBlock's stride-2 conv and max pool, mod3's
# stride-2 1x1s (trgb_segnet.py). A shard's rows must be a multiple of it.
OUTPUT_STRIDE = 8
HEIGHT_AXIS = 1  # NHWC: the dimension split by spatial_sharding


@dataclasses.dataclass(frozen=True)
class SpatialSharding:
    """NHWC dimension 1 (the height) split over the ``data`` dimension of
    ``mesh`` in equal contiguous blocks, one per process."""

    mesh: Any

    @property
    def size(self) -> int:
        return data_size(self.mesh)

    @property
    def rank(self) -> int:
        if self.mesh.get_coordinate() is None:
            raise ValueError("this process is outside the mesh: it holds no rows")
        return self.mesh.get_local_rank(DATA_AXIS)

    @property
    def group(self):
        return data_group(self.mesh)


def spatial_sharding(mesh) -> SpatialSharding:
    """The height of NHWC frames over the ``data`` dimension (:207-217)."""
    return SpatialSharding(mesh)


def shard_rows(x, sharding: SpatialSharding):
    """This process's block of rows of a whole frame (a tensor or an array,
    NHWC): rank r of n keeps rows ``[r*H/n, (r+1)*H/n)``. H must be a
    multiple of ``OUTPUT_STRIDE * n``."""
    n = sharding.size
    h = x.shape[HEIGHT_AXIS]
    if h % (OUTPUT_STRIDE * n):
        raise ValueError(f"height {h} is not a multiple of {OUTPUT_STRIDE * n} "
                         f"(output stride {OUTPUT_STRIDE} x {n} processes)")
    k = h // n
    r = sharding.rank
    index = [slice(None)] * x.ndim
    index[HEIGHT_AXIS] = slice(r * k, (r + 1) * k)
    return x[tuple(index)]


def gather_rows(x: torch.Tensor, sharding: SpatialSharding) -> torch.Tensor:
    """Every process's block of rows, in rank order, on every process."""
    blocks = all_gather(sharding.group, x)
    return torch.cat(blocks.unbind(0), dim=HEIGHT_AXIS)


def _carrier(group, t: torch.Tensor) -> torch.device:
    """Where the group's backend takes ``t``: the card for NCCL, the host
    for gloo; raises for a backend that cannot carry it."""
    backend = str(dist.get_backend(group))
    if t.device.type == "cuda" and "nccl" in backend:
        return t.device
    if "gloo" in backend:
        return torch.device("cpu")
    raise ValueError(f"a {backend} group cannot carry a {t.device.type} tensor")


def all_gather(group, t: torch.Tensor) -> torch.Tensor:
    """``(n, *t.shape)``: every process's ``t`` in rank order, on ``t``'s
    device. The bytes cross as uint8, so any dtype travels unchanged."""
    n = dist.get_world_size(group)
    if n == 1:
        return t.unsqueeze(0)
    where = _carrier(group, t)
    src = t.contiguous().view(-1).view(torch.uint8).to(where)
    out = torch.empty((n, src.numel()), dtype=torch.uint8, device=where)
    if where.type == "cuda":
        dist.all_gather_into_tensor(out, src, group=group)
    else:
        dist.all_gather(list(out.unbind(0)), src, group=group)
    return out.to(t.device).view(t.dtype).view(n, *t.shape)


def all_reduce_sum(group, t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the group, on ``t``'s device (a new tensor)."""
    if dist.get_world_size(group) == 1:
        return t.clone()
    buf = t.detach().to(_carrier(group, t), copy=True).contiguous()
    dist.all_reduce(buf, group=group)
    return buf.to(t.device)
