"""The port's CUDA kernels against their plain versions, on the card.

Every test carries the ``cuda`` marker and skips without a card. This file
and the port import no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: ingest is the plain version's arithmetic (f32 within 1e-6; nvcc
contracts x/255 - .5 into one FMA, a last-bit difference that can move a bf16
rounding by one step, 2^-8 at most in [-1, 1]); the grouped conv rounds f32
sums taken in another order, so at most one bf16 step apart. Its gradients
are held against autograd of the plain version in f32 on the same
bf16-valued inputs: dx within one bf16 step (the kernel rounds once), dk
(cuDNN's, returned in bf16) within 1e-2 in relative L2 norm. The
tensor-core kernel's tile edges (8 x 16 output pixels, 64 channels) are
probed at shapes that are not multiples of them.
"""

import numpy as np
import pytest
import torch

from heatnet_tpu_torch.ops import fused_preproc as fp
from heatnet_tpu_torch.ops import grouped_conv as gc

pytestmark = pytest.mark.cuda

GROUPS = 64
STAGES = [(128, 2, 1), (256, 4, 1), (512, 8, 2), (1024, 16, 4)]
# (C, cpg, d, H, W) of ResNeXt-50's grouped convs at a 320x640 train crop
TRAIN_STAGES = [(128, 2, 1, 80, 160), (256, 4, 1, 40, 80), (512, 8, 2, 40, 80),
                (1024, 16, 4, 40, 80)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _frames(seed, n, h, w):
    rng = np.random.RandomState(seed)
    rgb = torch.from_numpy(rng.randint(0, 256, (n, h, w, 3)).astype(np.uint8))
    ir = rng.randint(0, 65536, (n, h, w, 1)).astype(np.uint16)
    return rgb, torch.from_numpy(ir)


def _to(ir, dev):
    return ir.view(torch.int16).to(dev).view(torch.uint16)


@pytest.mark.parametrize("w,lo,hi", [(960, 148, 852), (704, 0, 704), (37, 3, 30)])
def test_ingest_kernel_matches_plain(dev, w, lo, hi):
    rgb, ir = _frames(w, 3, 5, w)
    before = fp.INGEST.launches
    for dtype, atol in ((torch.float32, 1e-6), (torch.bfloat16, 2.0 ** -8)):
        out = fp.early_fusion_input(rgb.to(dev), _to(ir, dev), lo, hi, dtype)
        ref = fp.early_fusion_input(rgb, ir, lo, hi, dtype)
        np.testing.assert_allclose(out.cpu().float().numpy(),
                                   ref.float().numpy(), atol=atol)
        for got, want in zip(
                fp.inference_preprocess_fused(rgb.to(dev), _to(ir, dev), lo, hi, dtype),
                fp.inference_preprocess_fused(rgb, ir, lo, hi, dtype)):
            np.testing.assert_allclose(got.cpu().float().numpy(),
                                       want.float().numpy(), atol=atol)
    assert fp.INGEST.launches == before + 4


@pytest.mark.parametrize("c,cpg,d", STAGES)
def test_grouped_conv_kernel_matches_plain(dev, c, cpg, d):
    g = torch.Generator().manual_seed(c)
    x = torch.randn((2, 13, 37, c), generator=g).to(torch.bfloat16)
    w = (torch.randn((c, cpg, 3, 3), generator=g) / (9 * cpg) ** 0.5).to(torch.bfloat16)
    s = torch.rand(c, generator=g) + 0.5
    b = torch.randn(c, generator=g) * 0.1

    def close(out, ref):
        out, ref = out.cpu().float(), ref.float()
        assert bool(((out - ref).abs() <= 2.0 ** -7 * ref.abs() + 1e-3).all())

    close(gc.grouped_conv3x3(x.to(dev), w.to(dev), GROUPS, d),
          gc.grouped_conv3x3(x, w, GROUPS, d))
    for act in ("relu", "leaky_relu", "elu", "none"):
        close(gc.grouped_conv3x3_fused(x.to(dev), w.to(dev), s.to(dev), b.to(dev),
                                       GROUPS, d, act, 0.1),
              gc.grouped_conv3x3_fused(x, w, s, b, GROUPS, d, act, 0.1))


def _close(out, ref):
    out, ref = out.float(), ref.float()
    assert out.shape == ref.shape
    err = (out - ref).abs() - (2.0 ** -7 * ref.abs() + 1e-3)
    assert bool(torch.isfinite(out).all()) and float(err.max()) <= 0, float(err.max())


# (N, H, W): one pixel, smaller than a tile, ragged in both, a serving stage
EDGE_SHAPES = [(1, 1, 1), (3, 7, 5), (1, 17, 33), (3, 40, 88)]


@pytest.mark.parametrize("d", [1, 2, 4])
@pytest.mark.parametrize("cpg", [1, 2, 4, 8, 16])
def test_grouped_conv_kernel_tile_edges(dev, cpg, d):
    c = 64 if cpg == 1 else 128
    groups = c // cpg
    g = torch.Generator().manual_seed(cpg * 10 + d)
    w = (torch.randn((c, cpg, 3, 3), generator=g) / (9 * cpg) ** 0.5).to(dev, torch.bfloat16)
    s = (torch.rand(c, generator=g) + 0.5).to(dev)
    b = (torch.randn(c, generator=g) * 0.1).to(dev)
    for n, h, wd in EDGE_SHAPES:
        x = torch.randn((n, h, wd, c), generator=g).to(dev, torch.bfloat16)
        counts = (gc.GROUPED_CONV3X3.launches, gc.GROUPED_CONV3X3_DX.launches)
        _close(gc.grouped_conv3x3(x, w, groups, d), gc.grouped_conv3x3_plain(x, w, groups, d))
        _close(gc.grouped_conv3x3_fused(x, w, s, b, groups, d, "leaky_relu", 0.1),
               gc.grouped_conv3x3_plain(x, w, groups, d, s, b, "leaky_relu", 0.1))
        _close(gc.grouped_conv3x3_dx(x, w, groups, d),
               gc.grouped_conv3x3_plain(x, gc.dx_weight(w, groups), groups, d))
        # one launch per call, forward and fused on one count, dx on its own
        assert (gc.GROUPED_CONV3X3.launches, gc.GROUPED_CONV3X3_DX.launches) == \
            (counts[0] + 2, counts[1] + 1)


# (N, C, cpg, d, H, W): the serving stages at batch 2 and the training ones
MAIN_SHAPES = [(2, c, cpg, d, 40 * (2 if c == 128 else 1), 88 * (2 if c == 128 else 1))
               for c, cpg, d in STAGES] + [(2,) + t for t in TRAIN_STAGES]


@pytest.mark.parametrize("n,c,cpg,d,h,w", MAIN_SHAPES)
def test_grouped_conv_dx_at_main_path_shapes(dev, n, c, cpg, d, h, w):
    groups = c // cpg
    g = torch.Generator().manual_seed(c + h)
    dy = torch.randn((n, h, w, c), generator=g).to(dev, torch.bfloat16)
    wt = (torch.randn((c, cpg, 3, 3), generator=g) / (9 * cpg) ** 0.5).to(dev, torch.bfloat16)
    before = gc.GROUPED_CONV3X3_DX.launches
    _close(gc.grouped_conv3x3_dx(dy, wt, groups, d),
           gc.grouped_conv3x3_plain(dy, gc.dx_weight(wt, groups), groups, d))
    assert gc.GROUPED_CONV3X3_DX.launches == before + 1


def test_dx_launches_no_weight_flip_copies(dev):
    """dx and the forward each launch the conv kernel and nothing else: the
    kernel gathers its weight tiles itself (no packing launch, no transpose
    or flip copy of ``dx_weight``)."""
    from torch.profiler import ProfilerActivity, profile

    dy = torch.randn(2, 40, 80, 512, device=dev, dtype=torch.bfloat16)
    wt = torch.randn(512, 8, 3, 3, device=dev, dtype=torch.bfloat16)
    for conv in (gc.grouped_conv3x3, gc.grouped_conv3x3_dx):
        conv(dy, wt, 64, 2)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            conv(dy, wt, 64, 2)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
        assert len(names) == 1 and "grouped_conv3x3" in names[0], names


def test_cuda_wrappers_raise_instead_of_falling_back(dev):
    x = torch.randn(1, 4, 4, 128, device=dev)  # f32: the kernel takes bf16
    w = torch.randn(128, 2, 3, 3, device=dev)
    with pytest.raises(ValueError, match="bf16"):
        gc.grouped_conv3x3(x, w, GROUPS)
    xb = torch.randn(1, 4, 4, 96, device=dev, dtype=torch.bfloat16)
    wb = torch.randn(96, 1, 3, 3, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="cpg"):  # C = 96: not 64-channel slices
        gc.grouped_conv3x3(xb, wb, 96)
    x64 = torch.randn(1, 4, 4, 192, device=dev, dtype=torch.bfloat16)
    w64 = torch.randn(192, 2, 3, 3, device=dev, dtype=torch.bfloat16)
    gc.grouped_conv3x3(x64, w64, 96)  # C = 3 x 64 is taken
    with pytest.raises(ValueError, match="C % 64"):
        gc.grouped_conv3x3(x64[..., :160].contiguous(), w64[:160], 80)
    with pytest.raises(ValueError, match="dilation"):
        gc.grouped_conv3x3(x64, w64, 96, 9)


@pytest.mark.parametrize("c,cpg,d,h,w", TRAIN_STAGES)
def test_grouped_conv_gradients_match_autograd_of_plain(dev, c, cpg, d, h, w):
    g = torch.Generator().manual_seed(c + 1)
    x = torch.randn((2, h, w, c), generator=g).to(torch.bfloat16)
    wt = torch.randn((c, cpg, 3, 3), generator=g) / (9 * cpg) ** 0.5
    dy = torch.randn((2, h, w, c), generator=g).to(torch.bfloat16)

    xk = x.to(dev).requires_grad_()
    wk = wt.to(dev).requires_grad_()
    before = (gc.GROUPED_CONV3X3.launches, gc.GROUPED_CONV3X3_DX.launches)
    gc.differentiable_grouped_conv3x3(xk, wk, GROUPS, d).backward(dy.to(dev))
    assert (gc.GROUPED_CONV3X3.launches, gc.GROUPED_CONV3X3_DX.launches) == \
        (before[0] + 1, before[1] + 1)
    assert xk.grad.dtype == torch.bfloat16 and wk.grad.dtype == torch.float32

    xr = x.to(dev).float().requires_grad_()
    wr = wt.to(dev).to(torch.bfloat16).float().requires_grad_()
    gc.grouped_conv3x3_plain(xr, wr, GROUPS, d).backward(dy.to(dev).float())
    dx, dx_ref = xk.grad.float(), xr.grad
    assert bool(((dx - dx_ref).abs() <= 2.0 ** -7 * dx_ref.abs() + 1e-3).all())
    rel = float((wk.grad - wr.grad).norm() / wr.grad.norm())
    assert rel <= 1e-2, rel
