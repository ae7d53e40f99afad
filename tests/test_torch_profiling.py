"""``heatnet_tpu_torch/utils/profiling.py`` on the CPU: ``StepTimer`` keeps
the JAX package's keys, ``trace`` writes a Chrome trace that names an
``annotate`` span, and ``scan_benchmark`` returns a positive time per call
that grows with the work."""

import json
import os
import time

import pytest
import torch

from heatnet_tpu.utils.profiling import StepTimer as JaxStepTimer
from heatnet_tpu_torch.utils import profiling


def test_step_timer_keys_equal_jax():
    t, j = profiling.StepTimer(), JaxStepTimer()
    for timer in (t, j):
        timer.data_loaded()
        timer.step_done()
    assert set(t.log_dict("train/")) == set(j.log_dict("train/"))
    assert t.log_dict()["steps_per_sec"] > 0


def test_trace_writes_the_annotated_span(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("heatnet_span"):
            (x @ x).sum()
    path = os.path.join(str(tmp_path), "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "heatnet_span" for e in events)
    assert any(e.key == "heatnet_span" for e in prof.key_averages())


def test_scan_benchmark_is_positive_and_grows_with_the_work(monkeypatch):
    """``scan_benchmark``'s arithmetic under a clock that advances a fixed
    cost per call of the step, so the box's load cannot decide it: the cost
    per call comes back exactly, grows with the work, and is clamped to
    1e-12 where no time passes. Then one real-clock check: a step that sleeps
    20 ms, timed as the difference of loops of 0 and 2 calls, reads at least
    10 ms. A preemption only lengthens a sleep; to shrink the difference it
    would have to fall in the 0-call loop, which lasts microseconds, and last
    over 20 ms."""
    clock = [0.0]
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: clock[0])

    def work(cost):
        clock[0] += cost

    per_call = [profiling.scan_benchmark(work, (cost,), 2, 12, reps=2)
                for cost in (1e-4, 2.5e-3)]
    assert per_call == [pytest.approx(1e-4, rel=1e-9), pytest.approx(2.5e-3, rel=1e-9)]
    assert 0 < per_call[0] < per_call[1]
    assert profiling.scan_benchmark(work, (0.0,), 2, 12, reps=2) == 1e-12
    monkeypatch.undo()
    assert profiling.scan_benchmark(time.sleep, (0.02,), 0, 2, reps=1) >= 0.01
