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
(cuDNN's, returned in bf16) within 1e-2 in relative L2 norm.
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


def test_cuda_wrappers_raise_instead_of_falling_back(dev):
    x = torch.randn(1, 4, 4, 128, device=dev)  # f32: the kernel takes bf16
    w = torch.randn(128, 2, 3, 3, device=dev)
    with pytest.raises(ValueError, match="bf16"):
        gc.grouped_conv3x3(x, w, GROUPS)
    xb = torch.randn(1, 4, 4, 96, device=dev, dtype=torch.bfloat16)
    wb = torch.randn(96, 1, 3, 3, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="cpg"):  # depthwise: not a kernel shape
        gc.grouped_conv3x3(xb, wb, 96)


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
