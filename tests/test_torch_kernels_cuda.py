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
probed at shapes that are not multiples of them. The int8 conv sums int8
products exactly in int32 and rounds its dequantisation as its plain
version does, so the two are held equal bit for bit.
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
        kernels = (gc.GROUPED_CONV3X3, gc.GROUPED_CONV3X3_FUSED, gc.GROUPED_CONV3X3_DX)
        counts = [k.launches for k in kernels]
        _close(gc.grouped_conv3x3(x, w, groups, d), gc.grouped_conv3x3_plain(x, w, groups, d))
        _close(gc.grouped_conv3x3_fused(x, w, s, b, groups, d, "leaky_relu", 0.1),
               gc.grouped_conv3x3_plain(x, w, groups, d, s, b, "leaky_relu", 0.1))
        _close(gc.grouped_conv3x3_dx(x, w, groups, d),
               gc.grouped_conv3x3_plain(x, gc.dx_weight(w, groups), groups, d))
        # one launch per call, each entry point on its own count
        assert [k.launches for k in kernels] == [c + 1 for c in counts]


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


# (C, cpg, d, H, W) of ResNeXt-50's grouped convs at MFNet's 480x640 frames
MFNET_STAGES = [(128, 2, 1, 120, 160), (256, 4, 1, 60, 80), (512, 8, 2, 60, 80),
                (1024, 16, 4, 60, 80)]


@pytest.mark.parametrize("c,cpg,d,h,w", MFNET_STAGES)
def test_fused_grouped_conv_at_mfnet_stage_shapes(dev, c, cpg, d, h, w):
    groups = c // cpg
    g = torch.Generator().manual_seed(c + h)
    x = torch.randn((2, h, w, c), generator=g).to(dev, torch.bfloat16)
    wt = (torch.randn((c, cpg, 3, 3), generator=g) / (9 * cpg) ** 0.5).to(dev, torch.bfloat16)
    s = (torch.rand(c, generator=g) + 0.5).to(dev)
    b = (torch.randn(c, generator=g) * 0.1).to(dev)
    before = gc.GROUPED_CONV3X3_FUSED.launches
    _close(gc.grouped_conv3x3_fused(x, wt, s, b, groups, d),
           gc.grouped_conv3x3_plain(x, wt, groups, d, s, b, "relu"))
    assert gc.GROUPED_CONV3X3_FUSED.launches == before + 1


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


def test_adversarial_steps_launch_each_entry_point_as_the_phase_needs(dev):
    """A critic step runs the frozen segnet without a graph (forward only);
    a seg step runs dx for both forwards and the IR teacher on the fused
    kernel. Structure (1,1,1,1): 4 grouped convs per forward."""
    from heatnet_tpu_torch.models import ConfSegnet, ResNeXtSeg
    from heatnet_tpu_torch.models.layers import init_params, prepare_for_inference
    from heatnet_tpu_torch.train import adversarial as adv
    from heatnet_tpu_torch.train.state import init_model

    model = init_model(ConfSegnet(disc_arch="cyclegan", num_critics=6,
                                  structure=(1, 1, 1, 1)), 0, dev)
    teacher = ResNeXtSeg(structure=(1, 1, 1, 1), input_channels=1)
    init_params(teacher, torch.Generator().manual_seed(1))
    teacher = prepare_for_inference(teacher, dev)
    cfg = adv.AdversarialConfig(moddrop=True, irscale=True, night_supervision=True)
    state = adv.make_phase_optimizers(model, lambda count: 1e-4)
    seg_step, critic_step = adv.make_adversarial_steps(model, cfg, teacher)
    g = torch.Generator().manual_seed(2)
    batch = {k: torch.rand((2, 256, 256, c), generator=g).to(dev)
             for k, c in (("rgb_day", 3), ("ir_day", 1), ("rgb_night", 3), ("ir_night", 1))}
    batch["label_day"] = torch.randint(0, 13, (2, 256, 256), generator=g).to(dev)
    batch["mod_drop_params"] = torch.tensor([[5, 5, 100, 100], [0, 0, 50, 50]])
    kernels = (gc.GROUPED_CONV3X3, gc.GROUPED_CONV3X3_FUSED, gc.GROUPED_CONV3X3_DX)
    for step, want in ((lambda: critic_step(state, batch), [8, 0, 0]),
                       (lambda: seg_step(state, batch, adv.draw_seg_aug(g)), [8, 4, 8])):
        before = [k.launches for k in kernels]
        metrics = step()
        assert [k.launches - b for k, b in zip(kernels, before)] == want
        assert all(bool(torch.isfinite(v)) for v in metrics.values())


def test_late_fusion_serving_and_steps_launch_the_kernels(dev):
    """Late fusion at structure (1,1,1,1): 5 grouped convs per forward
    (mod2_1 and mod2_2, mod3-mod5). Serving takes RGB and IR from one ingest
    launch; a critic step runs 10 forward launches, a seg step 10 forward,
    10 dx and the teacher's 4 fused."""
    from heatnet_tpu_torch.eval import validate
    from heatnet_tpu_torch.models import ConfSegnet, ResNeXtSeg
    from heatnet_tpu_torch.models.layers import init_params, prepare_for_inference
    from heatnet_tpu_torch.train import adversarial as adv
    from heatnet_tpu_torch.train.state import init_model

    kernels = (fp.INGEST, gc.GROUPED_CONV3X3, gc.GROUPED_CONV3X3_FUSED,
               gc.GROUPED_CONV3X3_DX)
    net = ResNeXtSeg(structure=(1, 1, 1, 1), input_channels=4, late_fusion=True)
    init_params(net, torch.Generator().manual_seed(0))
    net = prepare_for_inference(net, dev)
    rgb, ir = _frames(3, 2, 64, 96)
    batch = {"rgb": rgb.numpy(), "ir": ir.numpy()}
    before = [k.launches for k in kernels]
    maps = validate.predict(net, batch, "ir_rgb", dev)
    assert [k.launches - b for k, b in zip(kernels, before)] == [1, 0, 5, 0]
    assert maps.shape == (2, 64, 96) and maps.dtype == torch.uint8

    model = init_model(ConfSegnet(disc_arch="cyclegan", num_critics=6,
                                  structure=(1, 1, 1, 1), late_fusion=True), 0, dev)
    teacher = ResNeXtSeg(structure=(1, 1, 1, 1), input_channels=1)
    init_params(teacher, torch.Generator().manual_seed(1))
    teacher = prepare_for_inference(teacher, dev)
    cfg = adv.AdversarialConfig(moddrop=True, irscale=True, night_supervision=True)
    state = adv.make_phase_optimizers(model, lambda count: 1e-4)
    seg_step, critic_step = adv.make_adversarial_steps(model, cfg, teacher)
    g = torch.Generator().manual_seed(2)
    batch = {k: torch.rand((2, 256, 256, c), generator=g).to(dev)
             for k, c in (("rgb_day", 3), ("ir_day", 1), ("rgb_night", 3), ("ir_night", 1))}
    batch["label_day"] = torch.randint(0, 13, (2, 256, 256), generator=g).to(dev)
    batch["mod_drop_params"] = torch.tensor([[5, 5, 100, 100], [0, 0, 50, 50]])
    for step, want in ((lambda: critic_step(state, batch), [0, 10, 0, 0]),
                       (lambda: seg_step(state, batch, adv.draw_seg_aug(g)), [0, 10, 4, 10])):
        before = [k.launches for k in kernels]
        metrics = step()
        assert [k.launches - b for k, b in zip(kernels, before)] == want
        assert all(bool(torch.isfinite(v)) for v in metrics.values())


def test_pspnet_serves_from_the_rgb_ingest_and_trains_with_live_dropout(dev):
    """RGB-only PSPNet (SqueezeNet backend, small): one ingest launch per
    forward and no grouped conv; in train mode two dropout draws give two
    outputs, one draw twice the same output."""
    from heatnet_tpu_torch.eval import validate
    from heatnet_tpu_torch.models import build_network
    from heatnet_tpu_torch.models.layers import init_params, prepare_for_inference

    net = build_network("squeezenet")
    init_params(net, torch.Generator().manual_seed(0))
    net = prepare_for_inference(net, dev)
    rgb, _ = _frames(4, 2, 64, 96)
    before = (fp.INGEST.launches, gc.GROUPED_CONV3X3_FUSED.launches)
    maps = validate.predict(net, {"rgb": rgb.numpy()}, "rgb", dev)
    assert (fp.INGEST.launches, gc.GROUPED_CONV3X3_FUSED.launches) == \
        (before[0] + 1, before[1])
    assert maps.shape == (2, 64, 96)
    x = fp.rgb_normalize_fused(rgb.to(dev), net.compute_dtype)
    net.train()
    with torch.no_grad():
        outs = [net(x, dropout=net.draw_dropout(2, torch.Generator().manual_seed(s)))[0]
                for s in (0, 0, 1)]
    assert torch.isfinite(outs[0]).all() and not torch.equal(outs[0], outs[2])
    assert (outs[0] - outs[1]).abs().max() <= 1e-2 * outs[0].abs().max()


# (N, C, cpg, d, H, W) of the IR-only trainers' grouped convs: netSeg of
# cli.train_cyclegan at batch 2 on 256x256 (InitBlock: mod2 at 64x64, mod3-5
# at 32x32) and the encoders of cli.train_uncertainty at batch 4 on 80x160
# (Stem7x7: mod2 at 40x80, mod3-5 at 20x40; W = 40 is 2.5 column tiles)
GAN_SHAPES = [(2, 128, 2, 1, 64, 64), (2, 256, 4, 1, 32, 32), (2, 512, 8, 2, 32, 32),
              (2, 1024, 16, 4, 32, 32), (4, 128, 2, 1, 40, 80), (4, 256, 4, 1, 20, 40),
              (4, 512, 8, 2, 20, 40), (4, 1024, 16, 4, 20, 40)]


@pytest.mark.parametrize("n,c,cpg,d,h,w", GAN_SHAPES)
def test_grouped_conv_forward_dx_and_fused_at_the_gan_shapes(dev, n, c, cpg, d, h, w):
    groups = c // cpg
    g = torch.Generator().manual_seed(c + h + n)
    x = torch.randn((n, h, w, c), generator=g).to(dev, torch.bfloat16)
    wt = (torch.randn((c, cpg, 3, 3), generator=g) / (9 * cpg) ** 0.5).to(dev, torch.bfloat16)
    s = (torch.rand(c, generator=g) + 0.5).to(dev)
    b = (torch.randn(c, generator=g) * 0.1).to(dev)
    kernels = (gc.GROUPED_CONV3X3, gc.GROUPED_CONV3X3_FUSED, gc.GROUPED_CONV3X3_DX)
    before = [k.launches for k in kernels]
    _close(gc.grouped_conv3x3(x, wt, groups, d), gc.grouped_conv3x3_plain(x, wt, groups, d))
    _close(gc.grouped_conv3x3_fused(x, wt, s, b, groups, d),
           gc.grouped_conv3x3_plain(x, wt, groups, d, s, b, "relu"))
    _close(gc.grouped_conv3x3_dx(x, wt, groups, d),
           gc.grouped_conv3x3_plain(x, gc.dx_weight(wt, groups), groups, d))
    assert [k.launches - c0 for k, c0 in zip(kernels, before)] == [1, 1, 1]


def test_cyclegan_and_uncertainty_steps_launch_the_kernels(dev):
    """Structure (1,1,1,1): 4 grouped convs per netSeg or encoder forward. A
    CycleGAN generator step runs netSeg twice in train mode (8 forward, 8
    dx), a discriminator step none, netSeg in eval mode 4 fused; an
    uncertainty step runs two encoders (8 forward, 8 dx)."""
    from heatnet_tpu_torch.cli import train_cyclegan, train_uncertainty
    from heatnet_tpu_torch.models.layers import prepare_for_inference
    from heatnet_tpu_torch.train import cyclegan as tc
    from heatnet_tpu_torch.train import uncertainty as tu

    opt = train_cyclegan.build_parser().parse_args(
        ["--n_residual_blocks", "2", "--seg_structure", "1", "1", "1", "1"])
    nets = train_cyclegan.build_nets(opt, dev)
    state = tc.CycleGANState.create(nets, lambda count: 2e-4)
    g_step, d_a_step, d_b_step = tc.make_cyclegan_steps(
        *(nets[k] for k in ("netG_A2B", "netG_B2A", "netD_A", "netD_B", "netSeg")))
    g = torch.Generator().manual_seed(0)
    batch = {"A": (torch.rand((2, 256, 256, 1), generator=g) * 2 - 1).to(dev),
             "B": (torch.rand((2, 256, 256, 1), generator=g) * 2 - 1).to(dev),
             "label": torch.randint(-1, 12, (2, 256, 256), generator=g).to(dev)}
    kernels = (gc.GROUPED_CONV3X3, gc.GROUPED_CONV3X3_FUSED, gc.GROUPED_CONV3X3_DX)
    before = [k.launches for k in kernels]
    fake_a, fake_b, metrics = g_step(state, batch)
    assert [k.launches - c0 for k, c0 in zip(kernels, before)] == [8, 0, 8]
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert fake_a.shape == batch["A"].shape and fake_a.dtype == torch.float32
    before = [k.launches for k in kernels]
    losses = [d_a_step(state, batch["A"], fake_a), d_b_step(state, batch["B"], fake_b)]
    assert [k.launches for k in kernels] == before
    assert all(bool(torch.isfinite(v)) for v in losses)
    seg = prepare_for_inference(nets["netSeg"], dev)
    with torch.no_grad():
        out = seg(batch["B"])[0]
    assert [k.launches - c0 for k, c0 in zip(kernels, before)] == [0, 4, 0]
    assert out.shape == (2, 256, 256, 12) and bool(torch.isfinite(out).all())

    mods = train_uncertainty.build_modules((1, 1, 1, 1), dev)
    ustate = tu.create_state(mods, lambda count: 1e-4)
    step = tu.make_uncertainty_step(*(mods[k] for k in tu.MODULE_NAMES))
    ub = {"ir": (torch.rand((4, 80, 160, 1), generator=g) * 2 - 1).to(dev),
          "label": torch.randint(0, 12, (4, 80, 160), generator=g).to(dev)}
    before = [k.launches for k in kernels]
    m = step(ustate, ub)
    assert [k.launches - c0 for k, c0 in zip(kernels, before)] == [8, 0, 8]
    assert all(bool(torch.isfinite(v)) for v in m.values())


# (N, C, cpg, d, H, W) of this slice's grouped convs: the Vistas step at batch
# 30 of 384x768 crops (mod2 at 96x192, mod3-5 at 48x96), its eval at batch
# 16 of 384x768, and the MFNet adversarial steps at batch 16 of 384x384
# (96x96, 48x48)
VISTAS_MF_SHAPES = [(30, 128, 2, 1, 96, 192), (30, 256, 4, 1, 48, 96),
                    (30, 512, 8, 2, 48, 96), (30, 1024, 16, 4, 48, 96),
                    (16, 128, 2, 1, 96, 192), (16, 1024, 16, 4, 48, 96),
                    (16, 128, 2, 1, 96, 96), (16, 256, 4, 1, 48, 48),
                    (16, 512, 8, 2, 48, 48), (16, 1024, 16, 4, 48, 48)]


@pytest.mark.parametrize("n,c,cpg,d,h,w", VISTAS_MF_SHAPES)
def test_grouped_conv_forward_dx_and_fused_at_the_vistas_and_mf_shapes(dev, n, c, cpg, d,
                                                                        h, w):
    test_grouped_conv_forward_dx_and_fused_at_the_gan_shapes(dev, n, c, cpg, d, h, w)


def test_vistas_and_mf_seg_steps_launch_the_kernels(dev):
    """Structure (1,1,1,1): 4 grouped convs per forward. A Vistas step (3-channel
    ResNeXt, leaky ReLU, BN statistics per 2 groups) runs 4 forward and 4 dx,
    its eval forward 4 fused; an MF seg step at 384x384 with an IR teacher
    runs 8 forward, 8 dx and 4 fused, a critic step 8 forward."""
    from heatnet_tpu_torch.cli import main as vistas_cli
    from heatnet_tpu_torch.models import ConfSegnet, ResNeXtSeg
    from heatnet_tpu_torch.models.layers import init_params, prepare_for_inference
    from heatnet_tpu_torch.train import adversarial as adv
    from heatnet_tpu_torch.train.state import init_model
    from heatnet_tpu_torch.train.supervised import make_eval_step, make_train_step
    from heatnet_tpu_torch.utils.config import load_config

    kernels = (gc.GROUPED_CONV3X3, gc.GROUPED_CONV3X3_FUSED, gc.GROUPED_CONV3X3_DX)
    conf = load_config(vistas_cli.DEFAULT_CONFIG)
    args = vistas_cli.build_parser().parse_args(
        ["--data", "-", "--valdata", "-", "--structure", "1", "1", "1", "1",
         "--bn-groups", "2"])
    model = init_model(vistas_cli.build_model(args, conf), 0, dev)
    state = vistas_cli.create_state(model, conf["optimizer"], 10)
    g = torch.Generator().manual_seed(0)
    batch = {"image": torch.randn((4, 96, 192, 3), generator=g).to(dev),
             "label": torch.randint(0, 14, (4, 96, 192), generator=g).to(dev)}
    before = [k.launches for k in kernels]
    _, m = make_train_step(model)(state, batch)
    assert [k.launches - c0 for k, c0 in zip(kernels, before)] == [4, 0, 4]
    assert bool(torch.isfinite(m["loss"]))
    before = [k.launches for k in kernels]
    conf_mat = make_eval_step(model)(state, batch)
    assert [k.launches - c0 for k, c0 in zip(kernels, before)] == [0, 4, 0]
    assert int(conf_mat.sum()) == batch["label"].numel()

    model = init_model(ConfSegnet(disc_arch="cyclegan", num_critics=6,
                                  structure=(1, 1, 1, 1), bn_groups=2), 0, dev)
    teacher = ResNeXtSeg(structure=(1, 1, 1, 1), input_channels=1)
    init_params(teacher, torch.Generator().manual_seed(1))
    teacher = prepare_for_inference(teacher, dev)
    cfg = adv.AdversarialConfig(irscale=True, night_supervision=True)
    state = adv.make_phase_optimizers(model, lambda count: 1e-4)
    seg_step, critic_step = adv.make_adversarial_steps(model, cfg, teacher)
    batch = {k: torch.rand((2, 384, 384, c), generator=g).to(dev) * 2 - 1
             for k, c in (("rgb_day", 3), ("ir_day", 1), ("rgb_night", 3), ("ir_night", 1))}
    batch["label_day"] = torch.randint(0, 13, (2, 384, 384), generator=g).to(dev)
    for step, want in ((lambda: critic_step(state, batch), [8, 0, 0]),
                       (lambda: seg_step(state, batch, adv.draw_seg_aug(g)), [8, 4, 8])):
        before = [k.launches for k in kernels]
        metrics = step()
        assert [k.launches - c0 for k, c0 in zip(kernels, before)] == want
        assert all(bool(torch.isfinite(v)) for v in metrics.values())


@pytest.mark.parametrize("name", ["MFNet", "RTFNet", "SegNet"])
def test_harness_baselines_card_forward_matches_the_cpu(dev, name):
    """The MFNet harness's models, float32 with TF32 off, eval mode: the card's
    logits within 1e-3 of max |logit| of the CPU's on the same weights and a
    64x96 frame pair, the class maps on >= 0.999 of pixels. RTFNet at
    layers (1,1,1,1) with its full widths. SegNet's pools on the card may
    record another argmax where a cell's two largest values lie within
    rounding (its unpool then moves that value by a pixel): each such switch
    must be a near-tie (1e-5 of the cell's maximum), and the card pools at
    the CPU's argmaxes for the logits' comparison."""
    import copy
    from unittest import mock

    from heatnet_tpu_torch.cli.train_baseline import BASELINES
    from heatnet_tpu_torch.models import segnet_baseline
    from heatnet_tpu_torch.models.layers import init_params, prepare_for_inference

    model = BASELINES[name](n_class=9, **({"layers": (1, 1, 1, 1)} if name == "RTFNet"
                                          else {}))
    init_params(model, torch.Generator().manual_seed(0))
    x = torch.rand((2, 64, 96, 4), generator=torch.Generator().manual_seed(1))
    cpu = prepare_for_inference(copy.deepcopy(model), torch.device("cpu"), dtype=torch.float32)
    card = prepare_for_inference(model, dev, dtype=torch.float32)
    real_pool = segnet_baseline.pool_with_indices
    cpu_idx, n_card = [], []

    def recording_pool(t):
        pooled, idx = real_pool(t)
        cpu_idx.append(idx)
        return pooled, idx

    def cpu_index_pool(t):
        cells = segnet_baseline.pool_cells(t)
        ref = cpu_idx[len(n_card)].to(t.device)
        at_ref = torch.gather(cells, -1, ref[..., None])[..., 0]
        differ = cells.argmax(-1) != ref
        top = cells.amax(-1)
        assert bool(((top - at_ref)[differ].abs() <= 1e-5 * top[differ].abs()).all())
        n_card.append(int(differ.sum()))
        return at_ref, ref

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            with mock.patch.object(segnet_baseline, "pool_with_indices", recording_pool):
                want = cpu(x)
            with mock.patch.object(segnet_baseline, "pool_with_indices", cpu_index_pool):
                got = card(x.to(dev)).cpu()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert len(n_card) == (5 if name == "SegNet" else 0)
    assert got.shape == want.shape == (2, 64, 96, 9) and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max())
    assert float((got.argmax(-1) == want.argmax(-1)).float().mean()) >= 0.999


def test_harness_train_step_launches_no_port_kernel(dev):
    """A cli.train_baseline step (MFNet, float32, SGD) on the card launches
    none of the port's kernels, and evaluation neither."""
    from heatnet_tpu_torch.cli import train_baseline
    from heatnet_tpu_torch.models.layers import init_params, prepare_for_training

    kernels = (fp.INGEST, gc.GROUPED_CONV3X3, gc.GROUPED_CONV3X3_FUSED,
               gc.GROUPED_CONV3X3_DX)
    model = train_baseline.build_model("MFNet")
    init_params(model, torch.Generator().manual_seed(0))
    prepare_for_training(model, dev, dtype=torch.float32)
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9, weight_decay=5e-4)
    step = train_baseline.make_train_step(model, opt)
    g = torch.Generator().manual_seed(2)
    image = torch.rand((2, 96, 128, 4), generator=g).to(dev)
    label = torch.randint(-1, 9, (2, 96, 128), generator=g).to(dev)
    before = [k.launches for k in kernels]
    losses = [float(step(image, label)) for _ in range(3)]
    model.eval()
    with torch.no_grad():
        model(image).argmax(-1)
    assert [k.launches for k in kernels] == before
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert next(model.parameters()).dtype == torch.float32


# (N, Cin, Cout, k, stride, dilation, H, W, groups, x) of the int8 conv: the
# layer kinds of ResNeXtSeg's int8 path (stem 3x3, strided 1x1 projection,
# ASPP's dilated 3x3 with a rate beyond the map, the 269-channel FuseModule
# and its 13- and 1-channel heads, the grouped 3x3 at every channels-per-
# group), at shapes that are not multiples of the 128-pixel tile; then the
# kernel's paths: an all-zero x, an x_scale that saturates most values, M a
# multiple of the tile and one more (1x1 at stride 1: the TMA-fed
# activation), cout 2048 and ASPP's global branch at 1x1 spatial (M = 8),
# 2048->256 at rate 36 on 40x120 (taps skipped for whole tiles), 1024->2048
# 1x1 (the widest N tile), the decoder's 269->269 at its 80x240 map. x:
# "randn" (a scale of max|x| / 100, so the tails clip), "zeros", "saturate"
# (a scale of max|x| / 4000)
INT8_CASES = [(8, 64, 64, 3, 1, 1, 20, 30, 1, "randn"), (3, 256, 128, 1, 2, 1, 17, 23, 1, "randn"),
              (2, 512, 256, 3, 1, 12, 9, 15, 1, "randn"), (2, 512, 256, 3, 1, 36, 9, 15, 1, "randn"),
              (2, 269, 269, 3, 1, 1, 11, 13, 1, "randn"), (2, 269, 13, 3, 1, 1, 11, 13, 1, "randn"),
              (2, 256, 1, 1, 1, 1, 5, 7, 1, "randn"), (4, 96, 40, 7, 2, 1, 19, 21, 1, "randn"),
              (3, 128, 128, 3, 1, 1, 9, 11, 64, "randn"), (3, 256, 256, 3, 1, 1, 9, 11, 64, "randn"),
              (3, 512, 512, 3, 1, 2, 9, 11, 64, "randn"),
              (3, 1024, 1024, 3, 1, 4, 9, 11, 64, "randn"),
              (2, 269, 269, 3, 1, 1, 11, 13, 1, "zeros"), (3, 256, 256, 3, 1, 1, 9, 11, 64, "zeros"),
              (2, 512, 256, 3, 1, 1, 9, 15, 1, "saturate"),
              (3, 128, 128, 3, 1, 1, 9, 11, 64, "saturate"),
              (2, 256, 256, 1, 1, 1, 8, 16, 1, "randn"), (1, 256, 256, 1, 1, 1, 1, 257, 1, "randn"),
              (2, 64, 64, 3, 1, 1, 8, 16, 1, "randn"), (1, 64, 64, 3, 1, 1, 1, 257, 1, "randn"),
              (8, 256, 2048, 1, 1, 1, 1, 1, 1, "randn"), (8, 2048, 256, 1, 1, 1, 1, 1, 1, "randn"),
              (2, 2048, 256, 3, 1, 36, 40, 120, 1, "randn"),
              (2, 1024, 2048, 1, 1, 1, 40, 120, 1, "randn"),
              (2, 269, 269, 3, 1, 1, 80, 240, 1, "randn")]


def _int8_operands(dev, n, cin, cout, k, groups, h, w, dtype, seed, x_kind="randn"):
    from heatnet_tpu_torch.ops import int8_conv

    g = torch.Generator().manual_seed(seed)
    x = (torch.randn((n, h, w, cin), generator=g) * 2).to(dev, dtype).permute(0, 3, 1, 2)
    wt = torch.randn((cout, cin // groups, k, k), generator=g)
    w_q, w_scale = int8_conv.quantize_weight(wt)
    # a scale below max|x| / 127, so the activation's tails clip at +-127
    x_scale = (x.float().abs().amax() / (4000 if x_kind == "saturate" else 100)).reshape(())
    if x_kind == "zeros":
        x = torch.zeros_like(x)
    return (x, w_q.to(dev), int8_conv.pack_weight(w_q, groups).to(dev), w_scale.to(dev),
            x_scale, (torch.randn(cout, generator=g) * 0.1).to(dev),
            (torch.rand(cout, generator=g) + 0.5).to(dev))


@pytest.mark.parametrize("n,cin,cout,k,s,d,h,w,groups,x_kind", INT8_CASES)
def test_int8_conv_kernel_equals_plain(dev, n, cin, cout, k, s, d, h, w, groups, x_kind):
    """int32 sums are exact, so the kernel's output equals the plain
    version's bit for bit in bf16, on signed and post-ReLU x, with a bias,
    and for the grouped layers with bn3's affine + act in the epilogue; one
    launch per call."""
    from heatnet_tpu_torch.ops import int8_conv

    pad = d * (k // 2)
    x, w_q, w_pack, w_scale, x_scale, bias, scale = _int8_operands(
        dev, n, cin, cout, k, groups, h, w, torch.bfloat16, seed=cin + cout + k + d,
        x_kind=x_kind)
    variants = [dict(), dict(bias=bias)] if groups == 1 else \
        [dict()] + [dict(epilogue=(scale, bias, act, 0.01))
                    for act in ("relu", "leaky_relu", "elu", "none")]
    for xi in (x, torch.relu(x)):
        for kw in variants:
            before = int8_conv.INT8_CONV.launches
            out = int8_conv.int8_conv2d(xi, w_q, w_pack, w_scale, x_scale, stride=s,
                                        padding=pad, dilation=d, groups=groups, **kw)
            ref = int8_conv.int8_conv2d_plain(xi, w_q, w_scale, x_scale, stride=s,
                                              padding=pad, dilation=d, groups=groups, **kw)
            torch.cuda.synchronize()
            assert int8_conv.INT8_CONV.launches == before + 1
            assert out.shape == ref.shape and out.dtype == ref.dtype == torch.bfloat16
            assert torch.equal(out, ref), (list(kw), float((out.float() - ref.float()).abs().max()))


@pytest.mark.parametrize("x_scale", [1.0, 0.5, 3.0, 1 / 3, 0.0137, 2.0 ** -20])
def test_int8_quantize_pass_equals_the_division_on_every_bf16(dev, x_scale):
    """The quantize pass rounds x * (1 / x_scale) and divides only where the
    two could round apart. On every finite bf16 value (scales 0.5, 1 and 3
    make exact .5 ties; 2^-20 saturates nearly all), through a 1x1 conv whose
    weight keeps each channel (127 * x_q), the kernel equals the plain
    version's IEEE division bit for bit."""
    from heatnet_tpu_torch.ops import int8_conv

    v = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    v = v[torch.isfinite(v.float())]
    x = v.view(1, 1, -1, 64).to(dev).permute(0, 3, 1, 2)
    w_q, w_scale = int8_conv.quantize_weight(torch.eye(64).view(64, 64, 1, 1))
    w_q, w_scale = w_q.to(dev), w_scale.to(dev)
    xs = torch.tensor(x_scale, dtype=torch.float32, device=dev)
    out = int8_conv.int8_conv2d(x, w_q, int8_conv.pack_weight(w_q), w_scale, xs)
    ref = int8_conv.int8_conv2d_plain(x, w_q, w_scale, xs)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


def test_int8_conv_on_cuda_never_reaches_the_plain_version(dev):
    from unittest import mock

    from heatnet_tpu_torch.ops import int8_conv

    x, w_q, w_pack, w_scale, x_scale, bias, _ = _int8_operands(
        dev, 2, 64, 32, 3, 1, 6, 7, torch.bfloat16, seed=5)

    def refuse(*a, **kw):
        raise AssertionError("the plain version ran on a CUDA tensor")

    with mock.patch.object(int8_conv, "int8_conv2d_plain", refuse):
        int8_conv.int8_conv2d(x, w_q, w_pack, w_scale, x_scale, bias, padding=1)
        for dtype in (torch.float16, torch.float32):
            with pytest.raises(ValueError, match="takes bf16"):
                int8_conv.int8_conv2d(x.to(dtype), w_q, w_pack, w_scale, x_scale, padding=1)
        with pytest.raises(ValueError, match="pack_weight"):
            int8_conv.int8_conv2d(x, w_q, None, w_scale, x_scale, padding=1)
        with pytest.raises(ValueError, match="float32"):
            int8_conv.int8_conv2d(x, w_q, w_pack, w_scale.double(), x_scale, padding=1)


def test_int8_model_serves_through_the_kernel(dev):
    """A converted, calibrated ResNeXtSeg (1,1,1,1) at batch 8: the int8
    kernel serves the quantized layers (the fused grouped conv none of them at
    this size), its class maps agree with the same model on the plain int8
    version on >= 0.99 of pixels, and at batch 1 it is the bf16 model bit for
    bit with no int8 launch."""
    from unittest import mock

    from heatnet_tpu_torch.models import ResNeXtSeg
    from heatnet_tpu_torch.models.layers import init_params, prepare_for_inference
    from heatnet_tpu_torch.ops import int8_conv
    from heatnet_tpu_torch.ops.quant import calibrate_int8, convert_int8

    def build(quant):
        m = ResNeXtSeg(structure=(1, 1, 1, 1))
        init_params(m, torch.Generator().manual_seed(0))
        if quant:
            convert_int8(m)
        return prepare_for_inference(m, dev)

    g = torch.Generator().manual_seed(3)
    x = (torch.rand((8, 64, 96, 4), generator=g) * 2 - 1).to(dev)
    q, f = build(True), build(False)
    calibrate_int8(q, [(x[:1],)])
    with torch.no_grad():
        before = int8_conv.INT8_CONV.launches
        seg = q(x)[0]
        n_int8 = int8_conv.INT8_CONV.launches - before
        with mock.patch.object(int8_conv, "int8_conv2d",
                               lambda x, w_q, w_pack, *a, **kw:
                               int8_conv.int8_conv2d_plain(x, w_q, *a, **kw)):
            seg_plain = q(x)[0]
        before = int8_conv.INT8_CONV.launches
        one, one_f = q(x[:1])[0], f(x[:1])[0]
        assert int8_conv.INT8_CONV.launches == before
    assert n_int8 == 3 + 2 * 4 + 4 + 4 + 8 + 3  # stem, blocks, proj, grouped, ASPP, fuse
    agree = float((seg.argmax(-1) == seg_plain.argmax(-1)).float().mean())
    assert agree >= 0.99 and bool(torch.isfinite(seg).all())
    assert torch.equal(one, one_f)


def test_registered_ops_launch_on_cuda_and_equal_their_plain_versions(dev):
    """``torch.ops.heatnet.*`` (``ops/library.py``): the CUDA implementation
    launches the kernel, counted once per call, and agrees with the CPU
    implementation (the plain version) as the wrappers do."""
    from heatnet_tpu_torch.ops import int8_conv

    ops = torch.ops.heatnet
    rgb, ir = _frames(11, 2, 5, 960)
    before = fp.INGEST.launches
    for cat in (True, False):
        got = ops.ingest(rgb.to(dev), _to(ir, dev), 148, 852, torch.bfloat16, cat)
        want = ops.ingest(rgb, ir, 148, 852, torch.bfloat16, cat)
        assert len(got) == len(want) == (1 if cat else 2)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.cpu().float().numpy(), b.float().numpy(),
                                       atol=2.0 ** -8)
    got = ops.ingest(rgb.to(dev), None, 0, 960, torch.bfloat16, False)
    assert len(got) == 1 and got[0].shape == (2, 5, 960, 3)
    assert fp.INGEST.launches == before + 3

    g = torch.Generator().manual_seed(12)
    c, cpg, d = 256, 4, 2
    x = torch.randn((2, 13, 37, c), generator=g).to(torch.bfloat16)
    w = (torch.randn((c, cpg, 3, 3), generator=g) / (9 * cpg) ** 0.5).to(torch.bfloat16)
    s, b = torch.rand(c, generator=g) + 0.5, torch.randn(c, generator=g) * 0.1
    before = (gc.GROUPED_CONV3X3.launches, gc.GROUPED_CONV3X3_FUSED.launches)
    _close(ops.grouped_conv3x3(x.to(dev), w.to(dev), c // cpg, d).cpu(),
           ops.grouped_conv3x3(x, w, c // cpg, d))
    _close(ops.grouped_conv3x3_fused(x.to(dev), w.to(dev), s.to(dev), b.to(dev), c // cpg, d,
                                     "relu", 0.01).cpu(),
           ops.grouped_conv3x3_fused(x, w, s, b, c // cpg, d, "relu", 0.01))
    assert (gc.GROUPED_CONV3X3.launches, gc.GROUPED_CONV3X3_FUSED.launches) == \
        (before[0] + 1, before[1] + 1)

    for groups, k, cin in ((1, 3, 96), (64, 3, 256)):
        x8, w_q, w_pack, w_scale, x_scale, bias, scale = _int8_operands(
            dev, 2, cin, cin if groups > 1 else 40, k, groups, 9, 11, torch.bfloat16, seed=13)
        ep = (scale, bias, "relu", 0.01) if groups > 1 else (None, None, "none", 0.0)
        bias_arg = None if groups > 1 else bias
        before = int8_conv.INT8_CONV.launches
        out = ops.int8_conv(x8, w_q, w_pack, w_scale, x_scale, bias_arg, 1, 1, 1, groups, *ep)
        ref = ops.int8_conv(x8.cpu(), w_q.cpu(), w_pack.cpu(), w_scale.cpu(), x_scale.cpu(),
                            None if bias_arg is None else bias_arg.cpu(), 1, 1, 1, groups,
                            *[t.cpu() if isinstance(t, torch.Tensor) else t for t in ep])
        torch.cuda.synchronize()
        assert int8_conv.INT8_CONV.launches == before + 1
        assert out.stride() == ref.stride() and torch.equal(out.cpu(), ref)


def test_exported_forward_launches_the_kernels_through_the_ops(dev, tmp_path):
    """A ResNeXtSeg (1,1,1,1) exported on the card with a symbolic batch and
    loaded back: each call launches 1 ingest + 4 fused grouped convs through
    the registered ops, and its class maps are the eager model's bit for bit;
    int8 converted and calibrated, it launches the int8 kernel where the
    eager model does at batch 8 (JAX's rule for a symbolic batch)."""
    from heatnet_tpu_torch.eval.validate import normalize_frames
    from heatnet_tpu_torch.io.export import export_inference, load_exported, save_exported
    from heatnet_tpu_torch.models import ResNeXtSeg
    from heatnet_tpu_torch.models.layers import init_params, prepare_for_inference
    from heatnet_tpu_torch.ops import int8_conv
    from heatnet_tpu_torch.ops.quant import calibrate_int8, convert_int8

    h, w = 64, 128
    shapes = [(1, h, w, 3), (1, h, w, 1)]
    rng = np.random.RandomState(14)
    rgb = torch.from_numpy(rng.randint(0, 256, (8, h, w, 3)).astype(np.uint8)).to(dev)
    ir = _to(torch.from_numpy(rng.randint(21000, 26000, (8, h, w, 1)).astype(np.uint16)), dev)
    for quant in (False, True):
        m = ResNeXtSeg(structure=(1, 1, 1, 1))
        init_params(m, torch.Generator().manual_seed(0))
        if quant:
            convert_int8(m)
        prepare_for_inference(m, dev)
        if quant:
            calibrate_int8(m, [normalize_frames([rgb[:1], ir[:1]], m.compute_dtype)])
        path = str(tmp_path / f"q{quant}.pt2")
        save_exported(path, export_inference(m, shapes, [torch.uint8, torch.uint16],
                                             normalize=True))
        serve = load_exported(path)

        def counts():
            return (fp.INGEST.launches, gc.GROUPED_CONV3X3_FUSED.launches,
                    int8_conv.INT8_CONV.launches)

        with torch.no_grad():
            before = counts()
            want = m(*normalize_frames([rgb, ir], m.compute_dtype))[0].argmax(-1)
            eager = [a - b for a, b in zip(counts(), before)]
            for n in (8, 1):
                before = counts()
                got = serve(rgb[:n], ir[:n])
                torch.cuda.synchronize()
                launched = [a - b for a, b in zip(counts(), before)]
                assert launched == eager, (quant, n, launched, eager)
                assert torch.equal(got, want[:n].to(torch.int32)) or n == 1
        if not quant:
            assert eager == [1, 4, 0]
        else:
            assert eager[2] > 0 and eager[1] + eager[2] >= 4


@pytest.mark.parametrize("act", ["relu", "leaky_relu", "elu", "none"])
def test_lean_bn_act_on_the_card_equals_the_cpu(dev, act):
    """``ops/lean_bn.py`` (PyTorch operations, not a kernel of the port) in
    float32 on the card against the CPU: the output, the statistics and the
    three gradients within 1e-5 of each tensor's largest value."""
    from heatnet_tpu_torch.ops import lean_bn

    g = torch.Generator().manual_seed(7)
    y = torch.randn((3, 48, 10, 14), generator=g) * 1.5 + 0.3
    scale, bias = torch.rand(48, generator=g) + 0.5, torch.randn(48, generator=g) * 0.2
    ct = torch.randn(y.shape, generator=g)
    got = {}
    for where in ("cpu", dev):
        ins = [t.detach().to(where).requires_grad_(True) for t in (y, scale, bias)]
        a, mean, var = lean_bn.lean_bn_act(*ins, 1e-5, act, 0.1)
        a.backward(ct.to(where))
        got[str(where)] = [t.detach().cpu() for t in (a, mean, var)] + [
            t.grad.cpu() for t in ins]
    for c, r in zip(got["cuda"], got["cpu"]):
        assert float((c - r).abs().max()) <= 1e-5 * float(r.abs().max())


# (C, cpg, d, H, W) of ResNeXt-50's grouped convs on a 640x1920 frame, whose
# rows the spatial path splits over 4 processes
SPATIAL_STAGES = [(128, 2, 1, 160, 480), (256, 4, 1, 80, 240), (512, 8, 2, 80, 240),
                  (1024, 16, 4, 80, 240)]


@pytest.mark.parametrize("c,cpg,d,h,w", SPATIAL_STAGES)
def test_halo_extended_fused_grouped_conv_equals_the_whole_frame(dev, c, cpg, d, h, w):
    """The spatial path's grouped conv (``models/layers.py::GroupedConv``
    under ``spatial_parallel``): each shard of 4, extended by d rows of its
    neighbours (zeros beyond the frame), through the fused kernel with its
    'same' padding, d rows dropped a side, equals the kernel on the whole
    frame at those rows bit for bit; the extended shard's kernel output is
    held against the plain version on it."""
    g = torch.Generator().manual_seed(c + d)
    x = torch.randn((1, h, w, c), generator=g).to(torch.bfloat16).to(dev)
    wt = (torch.randn((c, cpg, 3, 3), generator=g) / (9 * cpg) ** 0.5).to(torch.bfloat16)
    s, b = torch.rand(c, generator=g) + 0.5, torch.randn(c, generator=g) * 0.1
    wt, s, b = wt.to(dev), s.to(dev), b.to(dev)
    whole = gc.grouped_conv3x3_fused(x, wt, s, b, GROUPS, d, "relu")
    rows = h // 4
    for r in range(4):
        lo, hi = r * rows - d, (r + 1) * rows + d
        ext = torch.zeros((1, rows + 2 * d, w, c), dtype=torch.bfloat16, device=dev)
        ext[:, max(lo, 0) - lo:min(hi, h) - lo] = x[:, max(lo, 0):min(hi, h)]
        out = gc.grouped_conv3x3_fused(ext, wt, s, b, GROUPS, d, "relu")
        _close(out, gc.grouped_conv3x3_plain(ext, wt, GROUPS, d, s, b, "relu"))
        part = out[:, d:d + rows]
        assert torch.equal(part, whole[:, r * rows:(r + 1) * rows]), r


@pytest.mark.parametrize("c,cpg,d,h,w", TRAIN_STAGES)
def test_halo_extended_forward_and_dx_equal_the_whole_frame(dev, c, cpg, d, h, w):
    """The train step by rows (``chip_smoke.py`` 13e: batch 10 of 320x640
    over 4 processes): each shard, extended by d rows of its neighbours
    (zeros beyond the frame), through the epilogue-free forward, d rows
    dropped a side, equals the whole frame's launch at those rows bit for
    bit. The dx kernel on the extended shard's output gradient (its halo rows
    zero, as the dropped rows give it) equals the whole frame's dx bit for
    bit at the rows whose taps all lie in the shard, and the shards' dx added
    where the halos overlap (the halo exchange's backward) is the whole
    frame's within a bf16 step of each part. Each extended launch is held
    against the plain version."""
    n, groups = 10, c // cpg
    g = torch.Generator().manual_seed(c + d + h)
    x = torch.randn((n, h, w, c), generator=g).to(torch.bfloat16).to(dev)
    dy = torch.randn((n, h, w, c), generator=g).to(torch.bfloat16).to(dev)
    wt = (torch.randn((c, cpg, 3, 3), generator=g) / (9 * cpg) ** 0.5).to(torch.bfloat16)
    wt = wt.to(dev)
    whole = gc.grouped_conv3x3(x, wt, groups, d)
    dx_whole = gc.grouped_conv3x3_dx(dy, wt, groups, d)
    rows = h // 4
    total = torch.zeros((n, h + 2 * d, w, c), device=dev)  # frame row f at f + d
    parts = torch.zeros_like(total)
    for r in range(4):
        lo, hi = r * rows - d, (r + 1) * rows + d
        ext = torch.zeros((n, rows + 2 * d, w, c), dtype=torch.bfloat16, device=dev)
        ext[:, max(lo, 0) - lo:min(hi, h) - lo] = x[:, max(lo, 0):min(hi, h)]
        out = gc.grouped_conv3x3(ext, wt, groups, d)
        _close(out, gc.grouped_conv3x3_plain(ext, wt, groups, d))
        assert torch.equal(out[:, d:d + rows], whole[:, r * rows:(r + 1) * rows]), r
        dy_ext = torch.zeros_like(ext)
        dy_ext[:, d:d + rows] = dy[:, r * rows:(r + 1) * rows]
        dx = gc.grouped_conv3x3_dx(dy_ext, wt, groups, d)
        _close(dx, gc.grouped_conv3x3_plain(dy_ext, gc.dx_weight(wt, groups), groups, d))
        assert torch.equal(dx[:, 2 * d:rows], dx_whole[:, r * rows + d:(r + 1) * rows - d]), r
        total[:, r * rows:r * rows + rows + 2 * d] += dx.float()
        parts[:, r * rows:r * rows + rows + 2 * d] += dx.float().abs()
    err = (total[:, d:d + h] - dx_whole.float()).abs() - 2.0 ** -7 * parts[:, d:d + h]
    assert float(err.max()) <= 0, float(err.max())


# The int8 launches of one shard in chip_smoke.py 13c: ResNeXt-50 early
# fusion, batch 8 of 640x1920 split by rows over 4 processes, the layers
# gated on the frame's shape (the stem and mod3-5's grouped convs float).
# (cin, cout, k, stride, pad_w, dilation, groups, shard rows with the halo, W)
INT8_SHARD_CASES = [
    (64, 256, 1, 1, 0, 1, 1, 40, 480), (64, 128, 1, 1, 0, 1, 1, 40, 480),
    (128, 128, 3, 1, 1, 1, 64, 42, 480), (128, 256, 1, 1, 0, 1, 1, 40, 480),
    (256, 128, 1, 1, 0, 1, 1, 40, 480), (256, 512, 1, 2, 0, 1, 1, 40, 480),
    (256, 256, 1, 2, 0, 1, 1, 40, 480), (256, 512, 1, 1, 0, 1, 1, 20, 240),
    (512, 256, 1, 1, 0, 1, 1, 20, 240), (512, 1024, 1, 1, 0, 1, 1, 20, 240),
    (512, 512, 1, 1, 0, 1, 1, 20, 240), (1024, 512, 1, 1, 0, 1, 1, 20, 240),
    (1024, 2048, 1, 1, 0, 1, 1, 20, 240), (1024, 1024, 1, 1, 0, 1, 1, 20, 240),
    (2048, 1024, 1, 1, 0, 1, 1, 20, 240), (2048, 256, 1, 1, 0, 1, 1, 20, 240),
    (2048, 256, 3, 1, 12, 12, 1, 44, 240), (2048, 256, 3, 1, 24, 24, 1, 68, 240),
    (2048, 256, 3, 1, 36, 36, 1, 92, 240), (2048, 256, 1, 1, 0, 1, 1, 1, 1),
    (1280, 256, 1, 1, 0, 1, 1, 20, 240), (256, 13, 1, 1, 0, 1, 1, 20, 240),
    (256, 1, 1, 1, 0, 1, 1, 20, 240), (269, 269, 3, 1, 1, 1, 1, 42, 480),
    (269, 13, 3, 1, 1, 1, 1, 42, 480)]


@pytest.mark.parametrize("cin,cout,k,s,pad_w,d,groups,h,w", INT8_SHARD_CASES)
def test_int8_conv_at_the_spatial_shard_shapes_equals_plain(dev, cin, cout, k, s, pad_w, d,
                                                           groups, h, w):
    """Each int8 launch of a 160-row shard (its halo rows included, no
    padding in height), batch 8, bit for bit with the plain version, on
    signed and post-ReLU x, the grouped layer with bn3's epilogue. For the
    3x3 layers, the other way to serve the shard (the same rows padded in
    height too, the extra output rows dropped) gives the same rows."""
    from heatnet_tpu_torch.ops import int8_conv

    x, w_q, w_pack, w_scale, x_scale, bias, scale = _int8_operands(
        dev, 8, cin, cout, k, groups, h, w, torch.bfloat16, seed=cin + cout + k + d + h)
    kw = dict(epilogue=(scale, bias, "relu", 0.01)) if groups > 1 else dict(bias=bias)
    for xi in (x, torch.relu(x)):
        out = int8_conv.int8_conv2d(xi, w_q, w_pack, w_scale, x_scale, stride=s,
                                    padding=(0, pad_w), dilation=d, groups=groups, **kw)
        ref = int8_conv.int8_conv2d_plain(xi, w_q, w_scale, x_scale, stride=s,
                                          padding=(0, pad_w), dilation=d, groups=groups, **kw)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), float((out.float() - ref.float()).abs().max())
        if k == 3:  # rows pad_w .. h - pad_w of x padded alike: the same rows
            sym = int8_conv.int8_conv2d(xi, w_q, w_pack, w_scale, x_scale, stride=s,
                                        padding=pad_w, dilation=d, groups=groups, **kw)
            assert torch.equal(sym[:, :, pad_w:pad_w + out.shape[2]], out)


def test_spatial_upsample_and_pyramid_by_rows_equal_the_whole_map(dev, monkeypatch):
    """PSPNet's x2 upsample and pyramid by rows (``parallel/spatial.py``) on
    the card, each of 4 ranks emulated in this process (its rank and the
    group's size; its halo rows cut from the whole map; the all-reduce the
    sum over the ranks): the x2 upsample's rows (bf16) equal
    ``F.interpolate`` of the whole map's, but for the frame's first and last
    row, within one bf16 step there (the resize clamps its source row at the
    edge, the shard blends the edge row with its copy: the same value up to
    an f32 rounding); the pooled priors (f32, sizes 1, 2,
    3 and 6 over the 20-row shards of an 80-row map, bins straddling shards)
    ``F.adaptive_avg_pool2d`` within 1e-5, and their frame-sized resizes'
    rows (bf16) ``F.interpolate``'s within one bf16 step."""
    import torch.nn.functional as F

    from heatnet_tpu_torch.parallel import spatial

    n, rows = 4, 20
    g = torch.Generator().manual_seed(16)
    x = torch.randn((1, 64, n * rows, 48), generator=g).to(dev)
    x = x.contiguous(memory_format=torch.channels_last)
    rank = {"r": 0}
    monkeypatch.setattr(spatial, "_SPATIAL_GROUP", object())
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda group=None: n)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda group=None: rank["r"])
    monkeypatch.setattr(spatial, "all_reduce_sum", lambda group, t: t)

    def halo(shard, above, below, replicate):
        r = rank["r"]
        idx = torch.arange(r * rows - above, (r + 1) * rows + below).clamp(0, n * rows - 1)
        return whole.index_select(2, idx.to(dev))

    monkeypatch.setattr(spatial, "halo_rows", lambda s, a, b, replicate=False: halo(
        s, a, b, replicate))
    whole = x.to(torch.bfloat16)
    want = F.interpolate(whole, size=(2 * n * rows, 96), mode="bilinear", align_corners=False)
    for r in range(n):
        rank["r"] = r
        got = spatial.resize_rows(whole[:, :, r * rows:(r + 1) * rows], (2 * rows, 96))
        part = want[:, :, 2 * r * rows:2 * (r + 1) * rows]
        inner = slice(int(r == 0), 2 * rows - int(r == n - 1))
        assert torch.equal(got[:, :, inner], part[:, :, inner]), r
        assert float((got.float() - part.float()).abs().max()) <= \
            2.0 ** -7 * float(part.float().abs().max()), r
    for size in (1, 2, 3, 6):
        pooled = 0
        for r in range(n):
            rank["r"] = r
            pooled = pooled + spatial.frame_pool(x[:, :, r * rows:(r + 1) * rows], (size, size))
        ref = F.adaptive_avg_pool2d(x, size)
        assert float((pooled - ref).abs().max()) <= 1e-5 * float(ref.abs().max()), size
        prior = ref.to(torch.bfloat16)
        want = F.interpolate(prior, size=(n * rows, 48), mode="bilinear", align_corners=False)
        for r in range(n):
            rank["r"] = r
            got = spatial.frame_resize_rows(prior, (n * rows, 48)).float()
            part = want[:, :, r * rows:(r + 1) * rows].float()
            assert float((got - part).abs().max()) <= 2.0 ** -7 * float(part.abs().max()), r
