"""Height-sharded serving: the halo exchanges that GSPMD writes for JAX.

``heatnet_tpu/parallel/mesh.py::spatial_sharding`` splits a frame's height
over the ``data`` axis, and XLA inserts the exchanges that each window
operation needs at the shards' edges. JAX has no module for this part; here
it is written out:

- ``halo_rows(x, above, below, group, fill, replicate)``: the shard with
  ``above`` rows of the ranks before it and ``below`` rows of the ranks after
  it; rows beyond the frame's first and last are ``fill``, or with
  ``replicate`` copies of the frame's first and last row (a bilinear resize
  clamps its source rows there). A halo may be larger than a shard (at
  stride 8, a 128-row frame over 4 processes holds 4 rows per shard, and
  ASPP's rates are 12, 24 and 36), so the exchange reaches ranks beyond the
  neighbour: one ``all_gather`` of every shard's first ``min(below, R)`` and
  last ``min(above, R)`` rows, from which each rank slices what it needs. One
  collective per window operation, whatever the halo; point-to-point
  ``batch_isend_irecv`` to the neighbours only would move fewer bytes and is
  left for later (ROADMAP queue 4, item 2).
- ``spatial_parallel(mesh)``: while it is active, the layers of
  ``models/layers.py`` read ``spatial_group()`` and each computes exactly
  its rows of the unsharded result: ``window_rows`` extends a shard for a
  convolution or pool so that it runs with no padding in height, and the
  padding at the frame's true top and bottom stays each operation's own
  (zeros for a convolution, -inf for the max pool). Operations over the
  whole frame sum over the processes: ``global_mean`` and ``frame_pool``
  (PSPNet's pyramid pools: each bin's rows, wherever they lie). ``frame_rows``
  gives the frame's height from a shard's, for the layers whose dispatch
  reads the frame's size (the int8 layers' gates, as GSPMD traces JAX's on
  the global shape).
- ``serve_frame``: one frame served across the mesh's processes, each
  ingesting its own raw rows; ``calibrate_frame``: the int8 layers' scales
  calibrated on frames split the same way (each scale the max over every
  shard, the unsharded calibration's).

This is serving only: eval mode, no gradient. Operations whose window or
statistics span the frame in other ways (instance norms, train-mode BN,
bilinear resizes other than PSPNet's two forms, pools to other sizes than
half within a shard) raise under the context and name themselves.

``EXCHANGE`` counts the exchanges, the bytes each process receives, and the
rows the halo-extended grouped convs compute beyond their shards
(``extra_rows``, beside the shard rows they serve, ``rows``). These are host
counters only: nothing here waits for the card to time an exchange (a
caller that wants the time wraps ``all_gather``, as ``chip_smoke.py``
phase 13 does with CUDA events).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .mesh import (all_gather, all_reduce_sum, data_group, gather_rows,
                   shard_rows, spatial_sharding)

_SPATIAL_GROUP = None

EXCHANGE = {"calls": 0, "bytes": 0, "extra_rows": 0, "rows": 0}


def reset_exchange() -> None:
    for k in EXCHANGE:
        EXCHANGE[k] = 0


def spatial_group():
    """The process group over which frames are split by rows, or None."""
    return _SPATIAL_GROUP


@contextlib.contextmanager
def spatial_parallel(mesh):
    """The layers compute their rows of a frame split over the mesh's
    ``data`` dimension while the block runs (a mesh of one process included:
    the rules apply, the exchanges are local)."""
    global _SPATIAL_GROUP
    prev = _SPATIAL_GROUP
    _SPATIAL_GROUP = data_group(mesh)
    try:
        yield mesh
    finally:
        _SPATIAL_GROUP = prev


def refuse(what: str) -> None:
    """Raise if frames are split by rows: ``what`` needs the whole frame."""
    if _SPATIAL_GROUP is not None:
        raise NotImplementedError(f"{what} is not served under spatial_parallel: "
                                  "its window or statistics span the whole frame")


def _empty_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    n, c, _, w = x.shape
    fmt = (torch.channels_last if x.is_contiguous(memory_format=torch.channels_last)
           else torch.contiguous_format)
    return torch.empty((n, c, rows, w), dtype=x.dtype, device=x.device, memory_format=fmt)


def frame_rows(rows: int) -> int:
    """The frame's height for a shard of ``rows`` rows under
    ``spatial_parallel`` (equal shards), else ``rows``."""
    if _SPATIAL_GROUP is None:
        return rows
    return rows * torch.distributed.get_world_size(_SPATIAL_GROUP)


def halo_rows(x: torch.Tensor, above: int, below: int, group=None,
              fill: float = 0.0, replicate: bool = False) -> torch.Tensor:
    """NCHW ``x`` (this rank's rows) with ``above`` rows of the ranks before
    it and ``below`` of the ranks after it, in the layout of ``x``; beyond
    the frame ``fill``, or with ``replicate`` the frame's first (last) row
    again. Every rank of ``group`` (the active ``spatial_group()`` if None)
    calls it together with equal shards."""
    if above == 0 and below == 0:
        return x
    if group is None:
        group = _SPATIAL_GROUP
    n = torch.distributed.get_world_size(group)
    r = torch.distributed.get_rank(group)
    rows = x.shape[2]
    first = r * rows - above  # global row of out's first row
    last = (r + 1) * rows + below  # one past the global row of out's last row
    out = _empty_rows(x, above + rows + below)
    out.narrow(2, above, rows).copy_(x)
    if n > 1:
        top, bot = min(below, rows), min(above, rows)
        edges = torch.cat([x.narrow(2, 0, top), x.narrow(2, rows - bot, bot)], 2)
        gathered = all_gather(group, edges)
        for q in range(r - 1, -1, -1):  # the ranks before: their last rows
            lo, hi = max(first, q * rows), (q + 1) * rows
            if lo >= hi:
                break
            src = gathered[q].narrow(2, top + lo - q * rows - (rows - bot), hi - lo)
            out.narrow(2, lo - first, hi - lo).copy_(src)
        for q in range(r + 1, n):  # the ranks after: their first rows
            lo, hi = q * rows, min((q + 1) * rows, last)
            if lo >= hi:
                break
            out.narrow(2, lo - first, hi - lo).copy_(gathered[q].narrow(2, 0, hi - lo))
        EXCHANGE["calls"] += 1
        EXCHANGE["bytes"] += (n - 1) * edges.numel() * edges.element_size()
    # rows beyond the frame: a0 above its first row, b0 below its last; the
    # frame's edge rows are in out (a halo that reaches past the frame took
    # the whole shards of the ranks between)
    a0, b0 = max(0, -first), max(0, last - n * rows)
    end = out.shape[2]
    for start, count, edge in ((0, a0, a0), (end - b0, b0, end - b0 - 1)):
        if count:
            beyond = out.narrow(2, start, count)
            if replicate:
                beyond.copy_(out.narrow(2, edge, 1).expand_as(beyond))
            else:
                beyond.fill_(fill)
    return out


def window_rows(x: torch.Tensor, kernel: int, stride: int, padding: int,
                dilation: int = 1, fill: float = 0.0):
    """NCHW ``x`` extended by the halo a window operation (``kernel`` x
    dilation ``dilation`` in height, ``stride``, ``padding``) needs, so that
    the operation with no padding in height gives exactly this shard's
    output rows. The global operation must map H rows to H / stride."""
    n = torch.distributed.get_world_size(_SPATIAL_GROUP)
    rows = x.shape[2]
    span = dilation * (kernel - 1)
    h = rows * n
    if rows % stride or padding > span or (h + 2 * padding - span - 1) // stride + 1 != h // stride:
        raise ValueError(f"a window of {kernel} (dilation {dilation}, stride {stride}, "
                         f"padding {padding}) does not split {n} shards of {rows} rows")
    return halo_rows(x, padding, max(0, span - padding - (stride - 1)), fill=fill)


def transposed_rows(x: torch.Tensor, kernel: int, stride: int, padding: int,
                    dilation: int = 1):
    """For a transposed conv (H rows to H * stride): NCHW ``x`` extended by
    its halo, and the first output row of this shard in the result of the
    transposed conv of the extended input with no padding in height."""
    span = dilation * (kernel - 1)
    if span + 1 != stride + 2 * padding:
        raise ValueError(f"a transposed conv of {kernel} (stride {stride}, padding "
                         f"{padding}) does not map H rows to H * {stride}")
    above, below = -(-(span - padding) // stride), -(-padding // stride)
    return halo_rows(x, above, below), above * stride + padding


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the whole frame's H, W of NCHW shards, kept as 1x1: the
    per-shard sum in float32, summed over the group, divided by the frame's
    pixel count, cast back."""
    n = torch.distributed.get_world_size(_SPATIAL_GROUP)
    s = all_reduce_sum(_SPATIAL_GROUP, x.float().sum(dim=(2, 3), keepdim=True))
    return (s / (x.shape[2] * n * x.shape[3])).to(x.dtype)


def frame_pool(x: torch.Tensor, out_hw) -> torch.Tensor:
    """``F.adaptive_avg_pool2d`` of the whole frame of NCHW shards, the same
    ``(N, C, oh, ow)`` on every process: the bins ``[floor(i*H/oh),
    ceil((i+1)*H/oh))`` over the frame's H, which overlap and straddle
    shards. Each process sums its rows of every bin in float32 and pools the
    width (not split) itself; one ``all_reduce_sum`` adds the processes'
    sums, which are divided by the bins' row counts and cast back."""
    n = torch.distributed.get_world_size(_SPATIAL_GROUP)
    r = torch.distributed.get_rank(_SPATIAL_GROUP)
    nb, c, rows, w = x.shape
    h, (oh, ow) = rows * n, out_hw
    bins = [(i * h // oh, -(-(i + 1) * h // oh)) for i in range(oh)]
    sums = []
    for lo, hi in bins:  # this shard's rows of each bin, local indices
        lo, hi = max(lo - r * rows, 0), min(hi - r * rows, rows)
        sums.append(x.narrow(2, lo, hi - lo).sum(2, keepdim=True, dtype=torch.float32)
                    if lo < hi else x.new_zeros((nb, c, 1, w), dtype=torch.float32))
    # height bins of one row each: the width's bins only
    s = F.adaptive_avg_pool2d(torch.cat(sums, 2), (oh, ow))
    s = all_reduce_sum(_SPATIAL_GROUP, s)
    counts = torch.tensor([hi - lo for lo, hi in bins], dtype=torch.float32, device=x.device)
    return (s / counts.view(1, 1, oh, 1)).to(x.dtype).contiguous(
        memory_format=torch.channels_last)


def frame_resize_rows(x: torch.Tensor, out_hw) -> torch.Tensor:
    """This process's rows of the bilinear resize (half-pixel centres, no
    antialiasing, ``F.interpolate(align_corners=False)``) of ``x``, a map
    every process holds whole (PSPNet's pooled priors), to ``out_hw``, the
    frame's size: the width resized first, then each output row blended from
    its two source rows, both in float32 as PyTorch's kernel computes
    (``scale = in / out``, source ``(y + 0.5) * scale - 0.5`` clamped at 0)."""
    n = torch.distributed.get_world_size(_SPATIAL_GROUP)
    r = torch.distributed.get_rank(_SPATIAL_GROUP)
    in_h = x.shape[2]
    oh, ow = out_hw
    if oh % n:
        raise ValueError(f"{oh} rows do not split into {n} shards")
    rows = oh // n
    xw = F.interpolate(x.float(), size=(in_h, ow), mode="bilinear", align_corners=False)
    scale = torch.tensor(in_h, dtype=torch.float32) / oh
    y = torch.arange(r * rows, (r + 1) * rows, dtype=torch.float32)
    src = ((y + 0.5) * scale - 0.5).clamp_min(0.0)
    y0 = src.long().clamp_max(in_h - 1)
    y1 = (y0 + 1).clamp_max(in_h - 1)
    h1 = (src - y0).clamp(0.0, 1.0).to(x.device).view(1, 1, rows, 1)
    y0, y1 = y0.to(x.device), y1.to(x.device)
    out = xw.index_select(2, y0) * (1.0 - h1) + xw.index_select(2, y1) * h1
    return out.to(dtype=x.dtype, memory_format=torch.channels_last)


def upsample_rows(x: torch.Tensor, out_hw) -> torch.Tensor:
    """This shard's rows of the x2 bilinear upsample (half-pixel centres) in
    height of the frame's NCHW shards, to ``out_hw`` (any width): the shard
    plus one row a side (the frame's edge row repeated beyond it, as the
    resize clamps there) is resized and its 2 extra output rows a side are
    dropped. Each output row reads its two nearest source rows, at most one
    beyond the shard, at the frame's own offsets (the scale is 1/2 exactly):
    the unsharded rows."""
    rows = x.shape[2]
    xe = halo_rows(x, 1, 1, replicate=True)
    y = F.interpolate(xe, size=(2 * (rows + 2), out_hw[1]), mode="bilinear",
                      align_corners=False)
    return y.narrow(2, 2, 2 * rows)


def _ingest_rows(model, frames, mesh, dev, modalities):
    from ..eval.validate import ingest, modality_keys

    sharding = spatial_sharding(mesh)
    rows = {k: shard_rows(frames[k], sharding) for k in modality_keys(modalities)}
    return ingest(rows, modalities, dev, model.compute_dtype,
                  getattr(model, "late_fusion", False))


def serve_frame(model: torch.nn.Module, frames: Dict[str, np.ndarray], mesh,
                device: Optional[torch.device] = None, modalities: str = "ir_rgb"):
    """One frame (batch 1 or more, NHWC, raw uint8 RGB / uint16 IR or float)
    split by rows over the processes of ``mesh``'s ``data`` dimension.

    Each process keeps its rows (``shard_rows``), ingests them (one launch
    of the ingest kernel on the card), runs ``model`` (eval mode, on
    ``device``) under ``spatial_parallel`` and takes the argmax. Returns the
    whole class map (uint8, gathered to every process) and this process's
    rows of the logits and of the cert map (None without the cert branch);
    ``gather_rows`` puts those together where they are wanted."""
    from ..device import resolve

    dev = resolve(device)
    with torch.no_grad(), spatial_parallel(mesh):
        seg, _, cert = model(*_ingest_rows(model, frames, mesh, dev, modalities))
        pred = gather_rows(seg.argmax(dim=-1).to(torch.uint8), spatial_sharding(mesh))
    return pred, seg, cert


def calibrate_frame(model: torch.nn.Module, frames: Dict[str, np.ndarray], mesh,
                    device: Optional[torch.device] = None, modalities: str = "ir_rgb"):
    """``ops/quant.py::calibrate_int8`` of an int8-converted ``model`` on
    ``frames`` split by rows as ``serve_frame`` splits them: each layer's
    scale is the max over every shard (``all_reduce_max``), so every process
    holds the unsharded calibration's scales. Returns ``model``."""
    from ..device import resolve
    from ..ops.quant import calibrate_int8

    dev = resolve(device)
    with spatial_parallel(mesh):
        return calibrate_int8(model, [_ingest_rows(model, frames, mesh, dev, modalities)])
