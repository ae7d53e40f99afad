"""``heatnet_tpu_torch/utils/profiling.py`` on the CPU: ``StepTimer`` keeps
the JAX package's keys, ``trace`` writes a Chrome trace that names an
``annotate`` span, and ``scan_benchmark`` returns a positive time per call
that grows with the work."""

import json
import os

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


def test_scan_benchmark_is_positive_and_grows_with_the_work():
    small, big = torch.randn(16, 16), torch.randn(384, 384)
    t_small = profiling.scan_benchmark(torch.mm, (small, small), 2, 12, reps=2)
    t_big = profiling.scan_benchmark(torch.mm, (big, big), 2, 12, reps=2)
    assert 0 < t_small < t_big
