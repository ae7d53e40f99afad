"""Height-sharded serving and training: the halo exchanges that GSPMD writes
for JAX.

``heatnet_tpu/parallel/mesh.py::spatial_sharding`` splits a frame's height
over the ``data`` axis, and XLA inserts the exchanges that each window
operation needs at the shards' edges. JAX has no module for this part; here
it is written out:

- ``halo_rows(x, above, below, group, fill, replicate, reflect)``: the
  shard with ``above`` rows of the ranks before it and ``below`` rows of the
  ranks after it; rows beyond the frame's first and last are ``fill``, or
  with ``replicate`` copies of the frame's first and last row (a bilinear
  resize clamps its source rows there), or with ``reflect`` the frame's rows
  mirrored about them (the CycleGAN generator's reflect pads, which mirror
  at the frame's true top and bottom only). A halo may be larger than a shard (at
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
  whole frame sum over the processes: ``global_mean``, ``frame_pool``
  (PSPNet's pyramid pools: each bin's rows, wherever they lie) and
  ``frame_moments`` (the instance norms' per-sample statistics: each
  shard's count, sum and sum of squares in one all-reduce). ``resize_rows``
  resizes a shard by an integer factor in height (an upscale reads one row
  of halo a side, a downscale its own rows) and ``frame_resize_rows`` a map
  every process holds whole to the frame's rows. ``frame_rows`` gives the
  frame's height from a shard's, for the layers whose dispatch reads the
  frame's size (the int8 layers' gates, as GSPMD traces JAX's on the global
  shape).
- Maps whose rows no longer split evenly. GSPMD pads such shards; here one
  rule holds: a module runs its maps by rows while each window operation
  splits the shards (``splits``: the frame's H rows map to H / stride and
  each shard's to its rows / stride), and at the first that does not it
  gathers the map whole (``whole_frame``) and runs the rest unsharded, every
  process alike (``whole``; ``RowsThenWhole`` does both): the critics' maps
  at 1/32 of a tap, ``PoolDiscriminator``'s stride-1 4x4 convs, which take H
  to H-1. A map held whole by every process is computed once per process
  and counted once in each loss: each process's gradient of it is a part of
  the whole gradient, as for a result of ``all_reduce_sum``, so
  ``whole_frame``'s backward sums the parts over the group and each shard
  takes its rows. A map of a tap's size is split again where the module
  returns it (``frame_resize_rows``); a pooled score ``(N, k)`` stays whole.
- ``serve_frame``: one frame served across the mesh's processes, each
  ingesting its own raw rows; ``calibrate_frame``: the int8 layers' scales
  calibrated on frames split the same way (each scale the max over every
  shard, the unsharded calibration's); ``train_frames``: the supervised
  train step on a batch split the same way, JAX's step on a batch placed by
  ``spatial_sharding``; ``adversarial_frames`` and ``cyclegan_frames``: the
  adversarial seg and critic steps and a round of the CycleGAN steps, the
  same way.

Training by rows: every exchange carries its gradient back. ``halo_rows``'
backward returns each halo row's gradient to the rank that owns the row,
where it is summed (the transpose of the ``all_gather`` slicing: one
``all_reduce_sum`` of the ``(n, edges)`` gradients, of which each rank takes
its own; beyond the frame, the gradient of ``replicate``'s copies goes to
the edge row, that of ``reflect``'s to the rows they mirror, and that of
``fill`` is dropped). ``global_mean``, ``frame_pool`` and ``frame_moments``
sum through the differentiable ``mesh.all_reduce_sum``, whose
gradient is the group's sum of the replicated result's gradients, since
every rank's part of the loss reads the whole result. Train-mode BN takes
its count, sum and sum of squares over the group (``models/layers.py``,
``mesh.batch_stats_over``). The collectives of the backward must be issued
in the same order on every rank, and autograd orders the ready nodes of a
graph that differs between ranks (``frame_pool`` takes other rows of each
bin on each rank) as it finds them: ``ordered`` chains every operation whose
backward communicates to the one before it by a scalar token, so the
backward issues them in the reverse of the forward's order on every rank.
The chain reaches an operation that no loss reads too (ASPP's cert head in
the supervised step): its backward runs on zero gradients, and its
parameters get zero gradients where the unsharded step leaves them none.

What still refuses by rows, each naming itself (``refuse``): adaptive
average pools of a shard to other than 1 or 2 times fewer rows (their bins
straddle the shards; ``frame=True`` pools the whole frame), bilinear resizes
by other than an integer factor, and convs padded other than with zeros; the
int8 layers raise in train mode anywhere. A window operation that does not
split the shards raises outside a module that gathers (``window_rows``), as
does a reflect halo wider than the frame's rows in the extended shard.

``EXCHANGE`` counts the exchanges, the bytes each process receives, and the
rows the halo-extended grouped convs compute beyond their shards
(``extra_rows``, beside the shard rows they serve, ``rows``); the backward's
exchanges apart (``bwd_calls``, and ``bwd_bytes``, the bytes of each
all-reduced gradient tensor: a ring all-reduce receives 2(n-1)/n of them).
A map gathered whole counts as one exchange, its backward as one. These
are host counters only: nothing here waits for the card to time an exchange
(a caller that wants the time wraps ``all_gather``, ``sum_halo_grads`` or
``all_reduce_sum``, as ``chip_smoke.py`` phases 13, 13e and 13g do with
CUDA events).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .mesh import (all_gather, all_reduce_sum, batch_stats_over, data_group, gather_rows,
                   shard_rows, spatial_sharding)

_SPATIAL_GROUP = None
_TOKEN = None  # the last ``ordered`` operation's token in this forward, or None

EXCHANGE = {"calls": 0, "bytes": 0, "extra_rows": 0, "rows": 0, "bwd_calls": 0,
            "bwd_bytes": 0}


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
    the rules apply, the exchanges are local), and train-mode BN takes its
    statistics over those processes (over one, its own)."""
    global _SPATIAL_GROUP, _TOKEN
    prev = _SPATIAL_GROUP
    _SPATIAL_GROUP, _TOKEN = data_group(mesh), None
    try:
        with batch_stats_over(mesh, by_rows=True):
            yield mesh
    finally:
        _SPATIAL_GROUP, _TOKEN = prev, None


class _Enter(torch.autograd.Function):
    """``x`` unchanged; in the backward, the token's gradient (zero) is
    given to the previous ordered operation once this one's is done."""

    @staticmethod
    def forward(ctx, x, token):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad, grad.new_zeros(())


class _Exit(torch.autograd.Function):
    """``y`` unchanged and a new token; the backward waits for the token's
    gradient, i.e. for the next ordered operation's backward."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y), y.new_zeros(())

    @staticmethod
    def backward(ctx, grad, _token_grad):
        global _TOKEN
        _TOKEN = None  # this forward's graph is being consumed
        return grad


def ordered(fn, x: torch.Tensor, *also: torch.Tensor):
    """``fn(x)``, an operation whose backward runs a collective, chained to
    the previous such operation of this forward so that its backward runs
    before theirs: every rank issues the backward's collectives in the
    reverse of the forward's order, whatever graph its rows make. ``fn`` may
    return a tuple whose first element carries the gradient. Outside
    ``spatial_parallel``, without gradient, or when neither ``x`` nor
    ``also`` (the operation's other differentiable inputs) requires one,
    ``fn(x)`` alone."""
    global _TOKEN
    if (_SPATIAL_GROUP is None or not torch.is_grad_enabled()
            or not any(t.requires_grad for t in (x,) + also)):
        return fn(x)
    if _TOKEN is not None:
        x = _Enter.apply(x, _TOKEN)
    out = fn(x)
    first = out[0] if isinstance(out, tuple) else out
    first, _TOKEN = _Exit.apply(first)
    return (first,) + tuple(out[1:]) if isinstance(out, tuple) else first


def refuse(what: str, why: str) -> None:
    """Raise if frames are split by rows: ``what`` is not served by rows,
    for the reason ``why``."""
    if _SPATIAL_GROUP is not None:
        raise NotImplementedError(f"{what} is not served under spatial_parallel: {why}")


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


def _halo_plan(n: int, r: int, rows: int, above: int, below: int):
    """Where ``halo_rows`` takes its rows: each rank sends its first ``top``
    and last ``bot`` rows (``edges``); ``pieces`` are (rank q, offset in q's
    edges, offset in the extended shard, rows) for rank r."""
    first, last = r * rows - above, (r + 1) * rows + below
    top, bot = min(below, rows), min(above, rows)
    pieces = []
    for q in range(r - 1, -1, -1):  # the ranks before: their last rows
        lo, hi = max(first, q * rows), (q + 1) * rows
        if lo >= hi:
            break
        pieces.append((q, top + lo - q * rows - (rows - bot), lo - first, hi - lo))
    for q in range(r + 1, n):  # the ranks after: their first rows
        lo, hi = q * rows, min((q + 1) * rows, last)
        if lo >= hi:
            break
        pieces.append((q, 0, lo - first, hi - lo))
    # rows beyond the frame: a0 above its first row, b0 below its last
    return top, bot, pieces, max(0, -first), max(0, last - n * rows)


def _mirrors(end: int, a0: int, b0: int):
    """Where ``reflect`` takes the rows beyond the frame: (the ``a0`` rows
    above its first row, the rows they mirror, the ``b0`` below its last,
    theirs), as (start, count) in a halo-extended shard of ``end`` rows."""
    if max(a0, b0) >= end - a0 - b0:
        raise ValueError(f"a reflect halo of {max(a0, b0)} rows needs more rows of the "
                         f"frame than the {end - a0 - b0} the extended shard holds")
    return (0, a0), (a0 + 1, a0), (end - b0, b0), (end - 2 * b0 - 1, b0)


def _halo_forward(x, above, below, group, fill, replicate, reflect=False):
    n = torch.distributed.get_world_size(group)
    r = torch.distributed.get_rank(group)
    rows = x.shape[2]
    top, bot, pieces, a0, b0 = _halo_plan(n, r, rows, above, below)
    out = _empty_rows(x, above + rows + below)
    out.narrow(2, above, rows).copy_(x)
    if n > 1:
        edges = torch.cat([x.narrow(2, 0, top), x.narrow(2, rows - bot, bot)], 2)
        gathered = all_gather(group, edges)
        for q, src, dst, count in pieces:
            out.narrow(2, dst, count).copy_(gathered[q].narrow(2, src, count))
        EXCHANGE["calls"] += 1
        EXCHANGE["bytes"] += (n - 1) * edges.numel() * edges.element_size()
    # the frame's edge rows are in out (a halo that reaches past the frame
    # took the whole shards of the ranks between)
    end = out.shape[2]
    if reflect:  # row -k is row k, row H-1+k is row H-1-k
        top, top_src, bot, bot_src = _mirrors(end, a0, b0)
        for (start, count), (src, _) in ((top, top_src), (bot, bot_src)):
            if count:
                out.narrow(2, start, count).copy_(out.narrow(2, src, count).flip(2))
        return out
    for start, count, edge in ((0, a0, a0), (end - b0, b0, end - b0 - 1)):
        if count:
            beyond = out.narrow(2, start, count)
            if replicate:
                beyond.copy_(out.narrow(2, edge, 1).expand_as(beyond))
            else:
                beyond.fill_(fill)
    return out


def sum_halo_grads(group, grads: torch.Tensor) -> torch.Tensor:
    """The backward's exchange: the ``(n, edges)`` halo gradients of every
    rank summed over the group (rank q then takes its slice ``q``)."""
    return all_reduce_sum(group, grads)


def _halo_backward(grad, rows, above, below, group, replicate, reflect=False):
    """The gradient of ``halo_rows``' input from that of its output: the
    shard's own rows, plus every halo row's gradient on the rank that owns
    the row (the transpose of the forward's slicing)."""
    n = torch.distributed.get_world_size(group)
    r = torch.distributed.get_rank(group)
    top, bot, pieces, a0, b0 = _halo_plan(n, r, rows, above, below)
    end = grad.shape[2]
    if reflect and (a0 or b0):  # the mirrored rows beyond the frame: to their rows
        grad = grad.clone()
        top_, top_src, bot_, bot_src = _mirrors(end, a0, b0)
        for (start, count), (src, _) in ((top_, top_src), (bot_, bot_src)):
            if count:
                grad.narrow(2, src, count).add_(grad.narrow(2, start, count).flip(2))
    elif replicate and (a0 or b0):  # the copies beyond the frame: to its edge row
        grad = grad.clone()
        for start, count, edge in ((0, a0, a0), (end - b0, b0, end - b0 - 1)):
            if count:
                grad.narrow(2, edge, 1).add_(grad.narrow(2, start, count).sum(2, keepdim=True))
    dx = grad.narrow(2, above, rows).clone()
    if n > 1:
        nb, c, _, w = grad.shape
        edges = grad.new_zeros((n, nb, c, top + bot, w))
        for q, src, dst, count in pieces:
            edges[q].narrow(2, src, count).copy_(grad.narrow(2, dst, count))
        mine = sum_halo_grads(group, edges)[r]
        dx.narrow(2, 0, top).add_(mine.narrow(2, 0, top))
        dx.narrow(2, rows - bot, bot).add_(mine.narrow(2, top, bot))
        EXCHANGE["bwd_calls"] += 1
        EXCHANGE["bwd_bytes"] += edges.numel() * edges.element_size()
    return dx


class _HaloRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, above, below, group, fill, replicate, reflect):
        ctx.args = (x.shape[2], above, below, group, replicate, reflect)
        return _halo_forward(x, above, below, group, fill, replicate, reflect)

    @staticmethod
    def backward(ctx, grad):
        return (_halo_backward(grad, *ctx.args),) + (None,) * 6


def halo_rows(x: torch.Tensor, above: int, below: int, group=None,
              fill: float = 0.0, replicate: bool = False,
              reflect: bool = False) -> torch.Tensor:
    """NCHW ``x`` (this rank's rows) with ``above`` rows of the ranks before
    it and ``below`` of the ranks after it, in the layout of ``x``; beyond
    the frame ``fill``, or with ``replicate`` the frame's first (last) row
    again, or with ``reflect`` the frame's rows mirrored about its first
    (last) row, that row not repeated (``F.pad(mode="reflect")``). Every
    rank of ``group`` (the active ``spatial_group()`` if None) calls it
    together with equal shards. Differentiable: the backward sends each halo
    row's gradient back to its owner (``sum_halo_grads``), and that of a row
    copied beyond the frame to the row it copies."""
    if above == 0 and below == 0:
        return x
    if group is None:
        group = _SPATIAL_GROUP
    if torch.is_grad_enabled() and x.requires_grad:
        return ordered(lambda t: _HaloRows.apply(t, above, below, group, fill, replicate,
                                                 reflect), x)
    return _halo_forward(x, above, below, group, fill, replicate, reflect)


def splits(rows: int, kernel: int, stride: int = 1, padding: int = 0,
           dilation: int = 1) -> bool:
    """Whether a window operation (``kernel`` x dilation ``dilation`` in
    height, ``stride``, ``padding``) on the frame of equal shards of ``rows``
    rows gives each shard's output rows from that shard and its halo: the
    frame's H rows map to H / stride, and each shard's rows to rows /
    stride."""
    n = torch.distributed.get_world_size(_SPATIAL_GROUP)
    span = dilation * (kernel - 1)
    h = rows * n
    return (rows % stride == 0 and padding <= span
            and (h + 2 * padding - span - 1) // stride + 1 == h // stride)


def window_rows(x: torch.Tensor, kernel: int, stride: int, padding: int,
                dilation: int = 1, fill: float = 0.0):
    """NCHW ``x`` extended by the halo a window operation (``kernel`` x
    dilation ``dilation`` in height, ``stride``, ``padding``) needs, so that
    the operation with no padding in height gives exactly this shard's
    output rows. The operation must split the shards (``splits``)."""
    rows = x.shape[2]
    if not splits(rows, kernel, stride, padding, dilation):
        n = torch.distributed.get_world_size(_SPATIAL_GROUP)
        raise ValueError(f"a window of {kernel} (dilation {dilation}, stride {stride}, "
                         f"padding {padding}) does not split {n} shards of {rows} rows")
    span = dilation * (kernel - 1)
    return halo_rows(x, padding, max(0, span - padding - (stride - 1)), fill=fill)


def transposed_rows(x: torch.Tensor, kernel: int, stride: int, padding: int,
                    dilation: int = 1, output_padding: int = 0):
    """For a transposed conv (H rows to H * stride, ``output_padding`` rows
    added at the frame's bottom): NCHW ``x`` extended by its halo, and the
    first output row of this shard in the result of the transposed conv of
    the extended input with no padding and no output padding in height.
    Only the last shard's output reaches the padded rows, which read its
    rows and the zeros beyond the frame, as the unsharded conv reads them."""
    span = dilation * (kernel - 1)
    if span + 1 + output_padding != stride + 2 * padding:
        raise ValueError(f"a transposed conv of {kernel} (stride {stride}, padding "
                         f"{padding}, output padding {output_padding}) does not map H "
                         f"rows to H * {stride}")
    above, below = -(-(span - padding) // stride), -(-padding // stride)
    return halo_rows(x, above, below), above * stride + padding


def _sum_dtype(x: torch.Tensor) -> torch.dtype:
    """float32 sums for bf16, f16 and f32 shards; float64 stays float64."""
    return torch.promote_types(x.dtype, torch.float32)


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the whole frame's H, W of NCHW shards, kept as 1x1: the
    per-shard sum in float32 (float64 for float64), summed over the group, divided by the frame's
    pixel count, cast back. Its gradient is the group's sum of the mean's
    gradients, spread over this shard's pixels."""
    n = torch.distributed.get_world_size(_SPATIAL_GROUP)
    s = ordered(lambda t: all_reduce_sum(_SPATIAL_GROUP, t),
                x.to(_sum_dtype(x)).sum(dim=(2, 3), keepdim=True))
    return (s / (x.shape[2] * n * x.shape[3])).to(x.dtype)


def frame_pool(x: torch.Tensor, out_hw) -> torch.Tensor:
    """``F.adaptive_avg_pool2d`` of the whole frame of NCHW shards, the same
    ``(N, C, oh, ow)`` on every process: the bins ``[floor(i*H/oh),
    ceil((i+1)*H/oh))`` over the frame's H, which overlap and straddle
    shards. Each process sums its rows of every bin in float32 (float64 for
    float64) and pools the
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
        sums.append(x.narrow(2, lo, hi - lo).sum(2, keepdim=True, dtype=_sum_dtype(x))
                    if lo < hi else x.new_zeros((nb, c, 1, w), dtype=_sum_dtype(x)))
    # height bins of one row each: the width's bins only
    s = F.adaptive_avg_pool2d(torch.cat(sums, 2), (oh, ow))
    s = ordered(lambda t: all_reduce_sum(_SPATIAL_GROUP, t), s)
    counts = torch.tensor([hi - lo for lo, hi in bins], dtype=_sum_dtype(x), device=x.device)
    return (s / counts.view(1, 1, oh, 1)).to(x.dtype).contiguous(
        memory_format=torch.channels_last)


def frame_resize_rows(x: torch.Tensor, out_hw) -> torch.Tensor:
    """This process's rows of the bilinear resize (half-pixel centres, no
    antialiasing, ``F.interpolate(align_corners=False)``) of ``x``, a map
    every process holds whole (PSPNet's pooled priors), to ``out_hw``, the
    frame's size: the width resized first, then each output row blended from
    its two source rows, both in float32 (float64 for float64) as PyTorch's
    kernel computes (``scale = in / out``, source ``(y + 0.5) * scale - 0.5``
    clamped at 0)."""
    n = torch.distributed.get_world_size(_SPATIAL_GROUP)
    r = torch.distributed.get_rank(_SPATIAL_GROUP)
    in_h = x.shape[2]
    oh, ow = out_hw
    if oh % n:
        raise ValueError(f"{oh} rows do not split into {n} shards")
    rows = oh // n
    ct = _sum_dtype(x)
    xw = F.interpolate(x.to(ct), size=(in_h, ow), mode="bilinear", align_corners=False)
    scale = torch.tensor(in_h, dtype=ct) / oh
    y = torch.arange(r * rows, (r + 1) * rows, dtype=ct)
    src = ((y + 0.5) * scale - 0.5).clamp_min(0.0)
    y0 = src.long().clamp_max(in_h - 1)
    y1 = (y0 + 1).clamp_max(in_h - 1)
    h1 = (src - y0).clamp(0.0, 1.0).to(x.device).view(1, 1, rows, 1)
    y0, y1 = y0.to(x.device), y1.to(x.device)
    out = xw.index_select(2, y0) * (1.0 - h1) + xw.index_select(2, y1) * h1
    return out.to(dtype=x.dtype, memory_format=torch.channels_last)


def resize_rows(x: torch.Tensor, out_hw) -> torch.Tensor:
    """This shard's rows of the bilinear resize (half-pixel centres, no
    antialiasing, ``F.interpolate(align_corners=False)``) of the frame's NCHW
    shards to ``out_hw`` (this shard's output rows, any width), as
    ``F.interpolate`` computes it at the frame's own scale: a resize of the
    width alone is the shard's own; so is a downscale by an integer k that
    divides the shard's rows (output row y blends rows ky + (k-1)/2 and the
    next, both in its block of k); an upscale by an integer f resizes the
    shard plus one row a side (the frame's edge row repeated beyond it, as
    the resize clamps there) to f times its rows, at the frame's scale
    1/f, and drops the f extra output rows a side: each output row reads
    its two nearest source rows, at most one beyond the shard. Other
    factors raise."""
    rows, oh = x.shape[2], out_hw[0]
    if oh == rows or (oh < rows and rows % oh == 0):
        if tuple(x.shape[2:]) == tuple(out_hw):
            return x
        return F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=False)
    if oh % rows:
        refuse(f"a bilinear resize of {rows} rows to {oh}",
               "only integer factors map each shard onto its own output rows")
    f = oh // rows
    y = F.interpolate(halo_rows(x, 1, 1, replicate=True), size=(f * (rows + 2), out_hw[1]),
                      mode="bilinear", align_corners=False)
    return y.narrow(2, f, oh)


def frame_moments(x: torch.Tensor):
    """The mean and the biased variance, per sample and channel, of the
    whole frame of NCHW shards (``x`` float32 or float64, the sums in its
    dtype), each ``(N, C, 1, 1)``: each shard's count, sum and sum of
    squares, summed over the group in one ``all_reduce_sum`` (``ordered``).
    The gradient reaches every shard through the sums."""
    nb, c, rows, w = x.shape
    count = x.new_full((nb, c), float(rows * w))
    sums = ordered(lambda t: all_reduce_sum(_SPATIAL_GROUP, t),
                   torch.stack([x.sum((2, 3)), x.square().sum((2, 3)), count]))
    mean = sums[0] / sums[2]
    var = (sums[1] / sums[2] - mean.square()).clamp_min(0.0)
    return mean.view(nb, c, 1, 1), var.view(nb, c, 1, 1)


def _gather_frame(x: torch.Tensor, group) -> torch.Tensor:
    n = torch.distributed.get_world_size(group)
    blocks = all_gather(group, x)
    EXCHANGE["calls"] += 1
    EXCHANGE["bytes"] += (n - 1) * x.numel() * x.element_size()
    return torch.cat(blocks.unbind(0), 2).contiguous(memory_format=torch.channels_last)


class _WholeFrame(torch.autograd.Function):
    """Every shard's rows in rank order on every process; the backward sums
    the processes' gradients of the whole map and hands each its rows."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[2]
        return _gather_frame(x, group)

    @staticmethod
    def backward(ctx, grad):
        r = torch.distributed.get_rank(ctx.group)
        summed = all_reduce_sum(ctx.group, grad.contiguous())
        EXCHANGE["bwd_calls"] += 1
        EXCHANGE["bwd_bytes"] += grad.numel() * grad.element_size()
        return summed.narrow(2, r * ctx.rows, ctx.rows), None


def whole_frame(x: torch.Tensor) -> torch.Tensor:
    """The whole frame of NCHW shards, the same on every process
    (channels_last). Differentiable: a map every process holds whole is
    computed alike by each, and each process's gradient of it is its part
    of the whole gradient (every loss term that reads the map is counted
    once over the processes, as for a result of ``all_reduce_sum``), so the
    backward sums the parts over the group and each shard takes its rows."""
    if torch.is_grad_enabled() and x.requires_grad:
        return ordered(lambda t: _WholeFrame.apply(t, _SPATIAL_GROUP), x)
    return _gather_frame(x, _SPATIAL_GROUP)


@contextlib.contextmanager
def whole():
    """The layers compute on maps that every process holds whole while the
    block runs: no exchange, train-mode BN statistics of the map itself, as
    unsharded. ``spatial_parallel`` resumes after it."""
    global _SPATIAL_GROUP
    prev = _SPATIAL_GROUP
    _SPATIAL_GROUP = None
    try:
        with batch_stats_over(None, by_rows=False):
            yield
    finally:
        _SPATIAL_GROUP = prev


class RowsThenWhole(contextlib.ExitStack):
    """A module's maps by rows while each window operation splits the
    shards, then whole. ``ready(x, kernel, stride, padding, dilation)``
    before each window operation returns ``x``, or, at the first that does
    not split them (``splits``: a stride-2 window on an odd shard, a map
    that shrinks by a row), ``x`` gathered whole (``whole_frame``); the
    rest of the block runs unsharded (``whole``), every process alike.
    ``is_whole`` says which. Unsharded, ``ready`` returns ``x``."""

    is_whole = False

    def ready(self, x: torch.Tensor, kernel: int, stride: int = 1, padding: int = 0,
              dilation: int = 1) -> torch.Tensor:
        if _SPATIAL_GROUP is None or splits(x.shape[2], kernel, stride, padding, dilation):
            return x
        x = whole_frame(x)
        self.enter_context(whole())
        self.is_whole = True
        return x


def row_offset(rows: int) -> int:
    """The frame's index of this shard's first row under
    ``spatial_parallel`` (equal shards of ``rows`` rows), else 0."""
    if _SPATIAL_GROUP is None:
        return 0
    return rows * torch.distributed.get_rank(_SPATIAL_GROUP)


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


def train_frames(step, state, batch, mesh, dropout=None):
    """One supervised step on whole frames split by rows over the processes
    of ``mesh``'s ``data`` dimension: JAX's ``make_train_step`` on a batch
    placed by ``spatial_sharding``.

    ``step`` is ``train/supervised.py::make_train_step(model, mesh=mesh)``;
    ``batch`` holds ``image`` (NHWC, normalised) and ``label`` (NHW), the
    whole frames, as every process holds them, on the model's device; each
    process keeps its rows (``shard_rows``) and runs ``step`` under
    ``spatial_parallel``. ``dropout``: PSPNet's keep masks (``draw_dropout``,
    (N, C)), the same on every process. Returns ``step``'s (state, metrics),
    the loss and accuracy the whole batch's; each process's parameters and
    running statistics stay equal to the others'."""
    sharding = spatial_sharding(mesh)
    rows = {k: shard_rows(v, sharding).contiguous() for k, v in batch.items()}
    with spatial_parallel(mesh):
        return step(state, rows, dropout)


def _rows_of(batch: Dict[str, torch.Tensor], sharding) -> Dict[str, torch.Tensor]:
    """This process's rows of every map of ``batch`` (NHWC or NHW); a
    per-sample tensor (``mod_drop_params``, (N, 4)) stays whole."""
    return {k: shard_rows(v, sharding).contiguous() if v.dim() >= 3 else v
            for k, v in batch.items()}


def adversarial_frames(step, state, batch, mesh, *args):
    """One adversarial step on whole frames split by rows over the processes
    of ``mesh``'s ``data`` dimension: JAX's ``make_adversarial_steps``' seg
    or critic step on a batch placed by ``spatial_sharding``.

    ``step`` is ``seg_step`` or ``critic_step`` of
    ``train/adversarial.py::make_adversarial_steps(model, cfg, teacher,
    mesh=mesh)``, and ``args`` what it takes after the batch (the seg
    step's ``SegAugDraws``, the critic step's dropout masks), the same on
    every process. ``batch`` holds the whole frames (``rgb_*``, ``ir_*``,
    ``label_day``) and ``mod_drop_params`` as every process holds them, on
    the model's device; each process keeps its rows of every map and runs
    ``step`` under ``spatial_parallel``. Returns ``step``'s metrics, the
    whole batch's; each process's parameters and running statistics stay
    equal to the others'."""
    rows = _rows_of(batch, spatial_sharding(mesh))
    with spatial_parallel(mesh):
        return step(state, rows, *args)


def cyclegan_frames(steps, state, batch, mesh, buffers, generator: torch.Generator):
    """One round of CycleGAN steps on whole frames split by rows over the
    processes of ``mesh``'s ``data`` dimension, the round
    ``cli/train_cyclegan.py`` runs: JAX's ``make_cyclegan_steps`` on a
    batch placed by ``spatial_sharding``.

    ``steps`` is ``train/cyclegan.py::make_cyclegan_steps(..., mesh=mesh)``
    (g_step, d_a_step, d_b_step); ``batch`` holds ``A``, ``B`` (NHWC) and
    ``label`` (NHW), whole, as every process holds them. Each process runs
    the generator step on its rows, pushes its rows of the two fakes
    through its own ``buffers`` (two ``DeviceReplayBuffer`` of a shard's
    rows) and runs the discriminator steps on its rows of the reals and of
    the replayed fakes; every process draws from ``generator`` alike, so
    each keeps its rows of the same replayed frames. Returns (fake_a,
    fake_b, metrics, loss_d_a, loss_d_b): the fakes this process's rows,
    the losses the whole batch's."""
    g_step, d_a_step, d_b_step = steps
    rows = _rows_of(batch, spatial_sharding(mesh))
    with spatial_parallel(mesh):
        fake_a, fake_b, metrics = g_step(state, rows)
        replay_a = buffers[0].push_and_pop(fake_a, generator)
        replay_b = buffers[1].push_and_pop(fake_b, generator)
        loss_a = d_a_step(state, rows["A"], replay_a)
        loss_b = d_b_step(state, rows["B"], replay_b)
    return fake_a, fake_b, metrics, loss_a, loss_b
