"""Short profiler spans across a traced window, reduced to a ``Readout``.

A long ``torch.profiler`` session loses kernel records late in a process,
so a traced run opens one short session per span (a few batches or one
schedule block), every few units across the window. Each span starts and
ends on a synchronised device. On a card the spans alternate:

- device spans (the first, third, ...) record the card alone (CUDA
  activity, no host ops), so the host runs near its untraced pace; their
  window is the card's clock between two CUDA events at the span's ends,
  and their busy time the union of the device events' intervals. The idle
  share and ``device``'s ``busy_s`` and ``window_s`` come from these alone;
- host spans (the second, fourth, ...) record the host's ops too, which
  slows the host several times over; they name the idle gaps, each by what
  the host was doing at its middle (the innermost ``pb.*`` span of the
  harness, then the innermost host op), for ``breakdown``.

Device events (kernels, copies, sets) and their durations, and the units
covered, are summed over both kinds. On a CPU every span is a host span.
The ``Readout`` holds the sums; the metric readers (``metrics/*.py``) take
their numbers from it.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .roofline import family

GAPS_NAMED = 2000  # the longest gaps of each span get a host name
MIN_GAP_S = 2e-6


class Readout:
    """What the metric readers read. ``kind`` is ``serve`` or ``train``;
    ``units`` counts the batches or steps (by kind) inside the spans;
    ``work`` holds per-unit quantities of the yardstick (``flops``, and
    ``bound.<kernel>`` in seconds)."""

    def __init__(self, kind: str):
        self.kind = kind
        self.units: Dict[str, int] = collections.Counter()
        self.device_s: Dict[str, float] = collections.Counter()  # by event name
        self.window_s = 0.0  # device spans: the card's clock over them
        self.busy_s = 0.0  # device spans: union of device intervals
        self.gaps_s: Dict[str, float] = collections.Counter()
        self.work: Dict[str, Dict[str, float]] = {}
        self.spans = 0
        self.span_wall_s = 0.0  # host clock over the spans, profiler start and stop included
        self.kind_wall_s: Dict[str, float] = collections.Counter()  # by span kind
        self.kind_units: Dict[str, int] = collections.Counter()
        self.reduce_s = 0.0  # host clock spent reading the spans' events
        self.run_units: Dict[str, int] = {}  # every unit of the window, traced or not
        self.run_s = 0.0  # the window on the host clock

    @property
    def n_units(self) -> int:
        return sum(self.units.values())

    def untraced(self):
        """({kind: units}, host seconds) of the window outside the spans,
        where the profiler's own host cost does not slow the loop."""
        units = {k: v - self.units.get(k, 0) for k, v in self.run_units.items()}
        return units, self.run_s - self.span_wall_s - self.reduce_s

    def family_s(self, *families: str) -> float:
        return sum(s for n, s in self.device_s.items() if family(n) in families)

    def named_s(self, *parts: str) -> float:
        return sum(s for n, s in self.device_s.items()
                   if any(p in n.lower() for p in parts))

    def breakdown(self) -> dict:
        ops = sorted(self.device_s.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps_s.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:120], s] for n, s in ops],
                "idle_gaps": [[n[:120], s] for n, s in gaps]}


def _union(intervals: np.ndarray) -> Tuple[float, List[Tuple[float, float]]]:
    """Length of the union of [start, end] rows, and the merged intervals."""
    if len(intervals) == 0:
        return 0.0, []
    iv = intervals[np.argsort(intervals[:, 0])]
    merged = []
    s, e = iv[0]
    for a, b in iv[1:]:
        if a > e:
            merged.append((s, e))
            s, e = a, b
        elif b > e:
            e = b
    merged.append((s, e))
    return float(sum(b - a for a, b in merged)), merged


class Tracer:
    """``with tracer.span(kind=count, ...): <work>`` profiles one span."""

    def __init__(self, readout: Readout, device: torch.device):
        self.readout = readout
        self.device = device

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def span(self, **units: int):
        cuda = self.device.type == "cuda"
        device_only = cuda and self.readout.spans % 2 == 0
        acts = [torch.profiler.ProfilerActivity.CUDA] if device_only else (
            [torch.profiler.ProfilerActivity.CPU]
            + ([torch.profiler.ProfilerActivity.CUDA] if cuda else []))
        self._sync()
        t0 = time.perf_counter()
        with torch.profiler.profile(activities=acts) as prof:
            if device_only:
                ends = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ends[0].record()
            yield
            if device_only:
                ends[1].record()
            self._sync()
        t1 = time.perf_counter()
        r = self.readout
        kind = "device" if device_only else "host"
        r.span_wall_s += t1 - t0
        r.kind_wall_s[kind] += t1 - t0
        r.kind_units[kind] += sum(units.values())
        r.spans += 1
        for k, v in units.items():
            r.units[k] += v
        dev, host, marks = self._events(prof.events())
        if device_only:
            r.window_s += ends[0].elapsed_time(ends[1]) * 1e-3
            r.busy_s += _union(dev)[0] * 1e-6
        elif len(host):
            self._gaps(dev, host, marks)
        r.reduce_s += time.perf_counter() - t1

    def _events(self, events):
        """(device intervals, host intervals, host names); device time by name."""
        r = self.readout
        dev, host, marks = [], [], []
        for e in events:
            tr = e.time_range
            if e.device_type == torch.autograd.DeviceType.CUDA:
                if getattr(e, "is_user_annotation", False):
                    continue
                dev.append((tr.start, tr.end))
                r.device_s[e.name] += (tr.end - tr.start) * 1e-6
            else:
                host.append((tr.start, tr.end))
                marks.append(e.name)
        return (np.asarray(dev, dtype=np.float64).reshape(-1, 2),
                np.asarray(host, dtype=np.float64).reshape(-1, 2), marks)

    def _gaps(self, dev_iv: np.ndarray, host_iv: np.ndarray, marks: List[str]) -> None:
        """The idle gaps of a host span, first host op to last event, named."""
        r = self.readout
        lo = float(host_iv[:, 0].min())
        hi = float(max(host_iv[:, 1].max(), dev_iv[:, 1].max() if len(dev_iv) else lo))
        _, merged = _union(np.clip(dev_iv, lo, hi))
        # idle gaps: before, between and after the merged device intervals
        edges = [lo] + [x for ab in merged for x in ab] + [hi]
        gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b - a > MIN_GAP_S * 1e6]
        gaps.sort(key=lambda ab: ab[0] - ab[1])
        names = np.asarray(marks, dtype=object)
        harness = np.asarray([m.startswith("pb.") for m in marks])
        dur = host_iv[:, 1] - host_iv[:, 0]
        for i, (a, b) in enumerate(gaps):
            if i >= GAPS_NAMED:
                r.gaps_s["(shorter gaps)"] += (b - a) * 1e-6
                continue
            mid = 0.5 * (a + b)
            cover = (host_iv[:, 0] <= mid) & (host_iv[:, 1] >= mid)
            r.gaps_s[_name(cover, harness, names, dur)] += (b - a) * 1e-6


def _name(cover, harness, names, dur) -> str:
    def innermost(mask) -> Optional[str]:
        if not mask.any():
            return None
        idx = np.flatnonzero(mask)
        return str(names[idx[np.argmin(dur[idx])]])

    outer = innermost(cover & harness) or "pb.(between harness spans)"
    inner = innermost(cover & ~harness)
    return outer if inner is None else f"{outer}/{inner}"
