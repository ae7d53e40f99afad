"""Step timers, traces and loop benchmarks.

Counterpart of ``heatnet_tpu/utils/profiling.py``:

- ``StepTimer``: batch and data wall-clock meters under the reference's
  names (``scripts/main.py:215-217,261-262``), with steps per second.
- ``trace(log_dir)``: a ``torch.profiler`` context that writes a Chrome
  trace (``trace.json``) under ``log_dir``; it records CUDA activity when a
  card is present, so the port's kernels show by name beside PyTorch's.
- ``annotate(name)``: a named span in that trace
  (``torch.profiler.record_function``).
- ``scan_benchmark``: seconds per call, from the difference of two loop
  lengths, so that the fixed costs of a timed run cancel.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch

from ..io.logging import AverageMeter


class StepTimer:
    """batch_time / data_time meters (scripts/main.py naming)."""

    def __init__(self):
        self.batch_time = AverageMeter()
        self.data_time = AverageMeter()
        self._end = time.time()

    def data_loaded(self):
        self.data_time.update(time.time() - self._end)

    def step_done(self):
        now = time.time()
        self.batch_time.update(now - self._end)
        self._end = now

    @property
    def steps_per_sec(self) -> float:
        return 1.0 / self.batch_time.avg if self.batch_time.avg else 0.0

    def log_dict(self, prefix: str = "") -> dict:
        return {
            f"{prefix}batch_time": self.batch_time.avg,
            f"{prefix}data_time": self.data_time.avg,
            f"{prefix}steps_per_sec": self.steps_per_sec,
        }


@contextlib.contextmanager
def trace(log_dir: str = "profile"):
    """Profile the block; on exit write ``<log_dir>/trace.json`` (Chrome
    trace format, for ``chrome://tracing`` or Perfetto). Yields the
    profiler, whose ``key_averages()`` tabulates the same events."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named span in the profiler's timeline."""
    return torch.profiler.record_function(name)


def scan_benchmark(step_fn: Callable, example_args, n_small: int = 5,
                   n_large: int = 25, reps: int = 3) -> float:
    """Seconds per call of ``step_fn(*example_args)``.

    Runs loops of ``n_small`` and ``n_large`` calls, ``reps`` times each
    after one warm-up loop, and divides the difference of their mean times
    by ``n_large - n_small``, so the fixed cost of a timed loop cancels.
    When an argument is a CUDA tensor the loops are timed on the card with
    CUDA events; otherwise on ``perf_counter``. The JAX version threads a
    carry through a scanned loop so that XLA cannot hoist the call out of
    it; eager PyTorch runs every call as written, so none is needed here.
    """
    args = tuple(example_args)
    cuda = any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)

    def loop(n: int) -> None:
        for _ in range(n):
            step_fn(*args)

    def timed(n: int) -> float:
        loop(n)  # warm-up
        if cuda:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                loop(n)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3 / reps
        t0 = time.perf_counter()
        for _ in range(reps):
            loop(n)
        return (time.perf_counter() - t0) / reps

    t_small, t_large = timed(n_small), timed(n_large)
    return max((t_large - t_small) / (n_large - n_small), 1e-12)
