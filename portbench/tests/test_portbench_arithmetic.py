"""The yardstick's arithmetic against hand counts on one small conv."""

import pytest
import torch
from portbench_tiny import ROOT  # noqa: F401

from portbench.harness import roofline
from portbench.harness.trace import Readout, _union
from portbench.reference.segnet import Conv, Ctx

import numpy as np


def test_flops_of_a_grouped_conv_forward_and_backward():
    n, c, h, w, g = 2, 128, 10, 12, 64
    with torch.device("meta"):
        conv = Conv(c, c, 3, 1, 2, 2, g)
        x = torch.empty(n, c, h, w, requires_grad=True)
    fwd = 2 * n * h * w * c * (c // g) * 9
    assert roofline.count_flops(lambda: conv(x, Ctx(False))) == fwd
    # backward: the input gradient and the weight gradient, each one forward's worth
    assert roofline.count_flops(lambda: conv(x, Ctx(False)).sum().backward()) == 3 * fwd


def test_grouped_conv_bound_by_hand():
    n, c, h, w, g = 8, 512, 40, 88, 64
    cpg = c // g
    byt = 2 * (2 * n * h * w * c + c * cpg * 9)
    ops = 2 * n * h * w * c * cpg * 9
    expect = max(byt / 3.35e12, ops / 989e12)
    assert roofline.grouped_conv_bound(n, c, h, w, g) == pytest.approx(expect, rel=1e-12)
    assert byt / 3.35e12 > ops / 989e12  # memory bound at 8 channels per group
    fused = roofline.grouped_conv_bound(n, c, h, w, g, epilogue=True)
    assert fused == pytest.approx((byt + 8 * c) / 3.35e12, rel=1e-12)


def test_shapes_hook_sees_only_grouped_convs():
    with torch.device("meta"):
        a, b = Conv(64, 64, 3, groups=64 // 8), Conv(64, 64, 1)
        x = torch.empty(1, 64, 8, 8)
    m = torch.nn.ModuleList([a, b])
    hooks = roofline.GroupedConvShapes(m)
    b(a(x, Ctx(False)), Ctx(False))
    assert hooks.shapes == [(1, 64, 8, 8, 8)]
    hooks.remove()


def test_families_are_the_frozen_rules():
    f = roofline.family
    assert f("void (anonymous namespace)::grouped_conv3x3_mma_kernel<true, 1>") == \
        "grouped_conv3x3 (port)"
    assert f("sm90_xmma_fprop_implicit_gemm_bf16bf16") == "cuDNN/cuBLAS conv"
    assert f("void at::native::batch_norm_collect_statistics_kernel") == "batch norm"
    assert f("Memcpy HtoD (Pageable -> Device)") == "host-device copy"
    assert f("void at::native::vectorized_elementwise_kernel<4>") == "elementwise / reduce"


def test_union_and_readers():
    busy, merged = _union(np.array([[0.0, 2.0], [1.0, 3.0], [5.0, 6.0]]))
    assert busy == 4.0 and merged == [(0.0, 3.0), (5.0, 6.0)]
    from portbench.harness.manifest import metric_reader
    r = Readout("serve")
    r.units["batch"] = 2
    r.window_s, r.busy_s = 0.1, 0.08
    r.device_s.update({"grouped_conv3x3_mma_kernel": 0.004, "Memcpy HtoD (Pageable)": 0.002,
                       "sm90_xmma_fprop": 0.03})
    r.work = {"flops": {"batch": 1e12}, "bound.grouped_conv3x3": {"batch": 1e-3}}
    r.run_units, r.run_s, r.span_wall_s = {"batch": 12}, 0.3, 0.1
    assert metric_reader("device_idle_share.serve")(r) == pytest.approx(20.0)
    assert metric_reader("h2d_ms.serve")(r) == pytest.approx(1.0)
    assert metric_reader("library_conv_ms.serve")(r) == pytest.approx(15.0)
    assert metric_reader("grouped_conv_roofline.serve")(r) == pytest.approx(50.0)
    assert metric_reader("serve_mfu")(r) == pytest.approx(100 * 10e12 / (0.2 * 989e12))
    assert metric_reader("train_mfu")(r) is None  # nothing to read in a serve cell
    assert metric_reader("norm_act_ms.serve")(r) is None
