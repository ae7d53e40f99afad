#!/usr/bin/env python3
"""Drive heatnet_tpu_torch on one CUDA card, end to end.

    python3 chip_smoke.py        (from the repository root; needs one card)

Phases, each of which exits non-zero on failure:

1. the card's name and power limit (nvidia-smi);
2. the build of ``heatnet_tpu_torch/csrc/*.cu`` and its time;
3. kernels: each kernel against its plain PyTorch version on the card at
   the main path's shapes, with the error beside its stated tolerance and
   CUDA-event times of the kernel, the plain version and, for the grouped
   conv, ``F.conv2d(groups=64)`` (a yardstick only; the port never calls it);
4. the main path: a 16-frame 320x704 heatnet-pack-v1 directory served by
   ``heatnet_tpu_torch.cli.inference.main`` with ResNeXt-50 at full depth and
   width (random weights, seed 0) at batch 8, the kernels' launch counts
   read around that run, then the same weights served again through the
   plain versions for the class-map agreement, and one forward checked for
   finite logits of the right shapes;
5. one ``{"kernels": [...]}`` JSON line; the last line is
   ``{"ok": true, "device": {...}}``.

Without a card, or run from a directory that does not hold the package, it
prints no result and exits non-zero.
"""

import json
import os
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12    # dense bf16 tensor-core peak, same source
N_BATCH, H_IN, W_IN = 8, 320, 704
# (name, C, channels per group, dilation, H, W, launches per forward) of
# ResNeXt-50's grouped convs at a 320x704 input (trgb_segnet.py:92-96)
STAGES = (("mod2", 128, 2, 1, 80, 176, 3), ("mod3", 256, 4, 1, 40, 88, 4),
          ("mod4", 512, 8, 2, 40, 88, 6), ("mod5", 1024, 16, 4, 40, 88, 3))
MIN_AGREEMENT = 0.99


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bound_ms(n_bytes: float, flops: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    if not os.path.isdir(os.path.join(ROOT, "heatnet_tpu_torch", "csrc")):
        fail(f"no heatnet_tpu_torch package beside {__file__}")
    sys.path.insert(0, ROOT)

    import torch.nn.functional as F

    from heatnet_tpu_torch.cli import inference as cli
    from heatnet_tpu_torch.data.packed import PackedFrameDataset, write_pack
    from heatnet_tpu_torch.eval import validate
    from heatnet_tpu_torch.kernels import build
    from heatnet_tpu_torch.models import get_model
    from heatnet_tpu_torch.models.layers import init_params, prepare_for_inference
    from heatnet_tpu_torch.ops import fused_preproc as fp
    from heatnet_tpu_torch.ops import grouped_conv as gc

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {build.library_path()}",
          flush=True)
    with open(os.path.join(build.BUILD_DIR, "nvcc.log")) as f:
        for line in f:
            if "registers" in line or ("spill" in line and " 0 bytes spill stores" not in line):
                print("  ptxas:", line.strip())

    def time_ms(fn, reps: int = 20) -> float:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def check(name, out, ref, tol_fn, tol_text) -> float:
        torch.cuda.synchronize()
        out, ref = out.float(), ref.float()
        if out.shape != ref.shape:
            fail(f"{name}: shape {tuple(out.shape)} != {tuple(ref.shape)}")
        diff = (out - ref).abs()
        err = float(diff.max())
        ok = bool(torch.isfinite(out).all()) and bool((diff <= tol_fn(ref)).all())
        print(f"  {name}: max_abs_err {err:.3g} (tolerance {tol_text}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"{name} disagrees with its plain version")
        return err

    rng = np.random.RandomState(0)

    def frames(n, h, w):
        rgb = torch.from_numpy(rng.randint(0, 256, (n, h, w, 3)).astype(np.uint8))
        ir = rng.randint(20000, 27000, (n, h, w, 1)).astype(np.uint16)
        ir = torch.from_numpy(ir.view(np.int16)).to(dev).view(torch.uint16)
        return rgb.to(dev), ir

    # 3a. ingest: f32 bit-for-bit up to 1e-6; bf16 within one rounding step
    print("kernels: ingest", flush=True)
    tol = {torch.float32: (lambda r: 1e-6, "1e-6"),
           torch.bfloat16: (lambda r: 2.0 ** -8, "2^-8, one bf16 ulp below 1")}
    ingest_err, ingest_ms = 0.0, {}
    for w_full, lo, hi in ((960, 148, 852), (W_IN, 0, W_IN)):
        rgb, ir = frames(N_BATCH, H_IN, w_full)
        plain_rgb = fp.rgb_plain(rgb[..., lo:hi, :])
        plain_ir = fp.ir_plain(ir[..., lo:hi, :])
        for dtype in (torch.bfloat16, torch.float32):
            t_fn, t_text = tol[dtype]
            tag = f"{w_full}[{lo}:{hi}] {str(dtype)[6:]}"
            ingest_err = max(ingest_err, check(
                f"early_fusion_input {tag}", fp.early_fusion_input(rgb, ir, lo, hi, dtype),
                torch.cat([plain_rgb, plain_ir], -1).to(dtype), t_fn, t_text))
            r_out, i_out = fp.inference_preprocess_fused(rgb, ir, lo, hi, dtype)
            ingest_err = max(ingest_err, check(
                f"inference_preprocess_fused rgb {tag}", r_out, plain_rgb.to(dtype), t_fn, t_text))
            ingest_err = max(ingest_err, check(
                f"inference_preprocess_fused ir {tag}", i_out, plain_ir.to(dtype), t_fn, t_text))
        ingest_err = max(ingest_err, check(
            f"rgb_normalize_fused {w_full}", fp.rgb_normalize_fused(rgb),
            fp.rgb_plain(rgb).to(torch.bfloat16), *tol[torch.bfloat16]))
        ingest_err = max(ingest_err, check(
            f"ir_normalize_fused {w_full}", fp.ir_normalize_fused(ir),
            fp.ir_plain(ir).to(torch.bfloat16), *tol[torch.bfloat16]))
        k_ms = time_ms(lambda: fp.early_fusion_input(rgb, ir, lo, hi))
        p_ms = time_ms(lambda: torch.cat([fp.rgb_plain(rgb[..., lo:hi, :]),
                                          fp.ir_plain(ir[..., lo:hi, :])], -1)
                       .to(torch.bfloat16))
        n_pix = N_BATCH * H_IN * (hi - lo)
        b_ms, b_by = bound_ms(n_pix * (3 + 2) + n_pix * 4 * 2, n_pix * 4 * 4)
        ingest_ms[(w_full, lo, hi)] = (k_ms, p_ms, b_ms, b_by)
        print(f"  early_fusion_input bf16 ({N_BATCH},{H_IN},{w_full}) window "
              f"{lo}:{hi}: kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} "
              f"bound_ms {b_ms:.4f} ({b_by})", flush=True)

    # 3b. grouped conv, plain and fused with each act, at every stage shape.
    # Both sides round f32 sums to bf16 once; they differ only where the
    # summation order moves a sum across a rounding boundary: one bf16 step.
    print("kernels: grouped_conv3x3", flush=True)
    gc_tol = (lambda r: 2.0 ** -7 * r.abs() + 1e-3, "2^-7 |plain| + 1e-3")
    gc_err, gc_rows = 0.0, []
    for name, c, cpg, d, h, w, count in STAGES:
        g = torch.Generator(device="cpu").manual_seed(c)
        x = torch.randn((N_BATCH, h, w, c), generator=g).to(dev, torch.bfloat16)
        wt = (torch.randn((c, cpg, 3, 3), generator=g) / (9 * cpg) ** 0.5
              ).to(dev, torch.bfloat16)
        scale = (torch.rand(c, generator=g) + 0.5).to(dev)
        bias = (torch.randn(c, generator=g) * 0.1).to(dev)
        gc_err = max(gc_err, check(
            f"grouped_conv3x3 {name}", gc.grouped_conv3x3(x, wt, c // cpg, d),
            gc.grouped_conv3x3_plain(x, wt, c // cpg, d), *gc_tol))
        for act in ("relu", "leaky_relu", "elu", "none"):
            gc_err = max(gc_err, check(
                f"grouped_conv3x3_fused {name} {act}",
                gc.grouped_conv3x3_fused(x, wt, scale, bias, c // cpg, d, act, 0.01),
                gc.grouped_conv3x3_plain(x, wt, c // cpg, d, scale, bias, act, 0.01),
                *gc_tol))
        k_ms = time_ms(lambda: gc.grouped_conv3x3_fused(x, wt, scale, bias, c // cpg, d))
        p_ms = time_ms(lambda: gc.grouped_conv3x3_plain(
            x, wt, c // cpg, d, scale, bias, "relu"), reps=5)
        x_cl = x.permute(0, 3, 1, 2)
        l_ms = time_ms(lambda: F.conv2d(x_cl, wt, padding=d, dilation=d,
                                        groups=c // cpg))
        n_bytes = 2 * x.numel() * 2 + wt.numel() * 2 + 2 * c * 4
        flops = 2 * x.numel() * cpg * 9
        b_ms, b_by = bound_ms(n_bytes, flops)
        gc_rows.append((name, count, k_ms, p_ms, l_ms, b_ms, n_bytes, flops))
        print(f"  {name} (C {c}, cpg {cpg}, d {d}, {N_BATCH}x{h}x{w}) fused relu: "
              f"kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} library_ms {l_ms:.4f} "
              f"bound_ms {b_ms:.4f} ({b_by}, {n_bytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.2f} GFLOP)", flush=True)

    # 4. the main path through the CLI
    print("main path: cli.inference, ResNeXt-50 (3,4,6,3), batch 8", flush=True)
    iters = 3
    with tempfile.TemporaryDirectory() as pack:
        prng = np.random.RandomState(1)
        write_pack(pack, prng.randint(0, 256, (16, H_IN, W_IN, 3)).astype(np.uint8),
                   prng.randint(21000, 26000, (16, H_IN, W_IN, 1)).astype(np.uint16))
        argv = ["--data", pack, "--batch", str(N_BATCH), "--iters", str(iters)]
        kernels = (fp.INGEST, gc.GROUPED_CONV3X3)
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        run = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels}
        forwards = 1 + iters + 2  # warm-up, timing iterations, two batches
        print(f"  launches {launches} over {forwards} forwards "
              f"({wall:.1f} s wall, batch 1 network {run.network_seconds * 1e3:.2f} ms)",
              flush=True)
        if launches["ingest"] < forwards or launches["grouped_conv3x3"] != 16 * forwards:
            fail(f"expected >= {forwards} ingest and {16 * forwards} grouped-conv "
                 f"launches, got {launches}")
        maps = run.maps
        if maps.shape != (16, H_IN, W_IN) or maps.dtype != np.uint8 or maps.max() >= 13:
            fail(f"class maps {maps.shape} {maps.dtype} max {maps.max()}")

        def ingest_plain(rgb, ir, lo, hi, out_dtype=torch.bfloat16):
            return torch.cat([fp.rgb_plain(rgb[..., lo:hi, :]),
                              fp.ir_plain(ir[..., lo:hi, :])], -1).to(out_dtype)

        def conv_plain(x, w, scale, bias, groups, dilation=1, act="relu", slope=0.01):
            return gc.grouped_conv3x3_plain(x, w, groups, dilation, scale, bias,
                                            act, slope)

        for k in kernels:
            k.launches = 0
        with mock.patch.object(fp, "early_fusion_input", ingest_plain), \
                mock.patch.object(gc, "grouped_conv3x3_fused", conv_plain):
            plain = cli.main(argv)
        if any(k.launches for k in kernels):
            fail("the plain-version run launched a kernel")
        agree = float((plain.maps == maps).mean())
        print(f"  class-map agreement with the plain versions: {agree:.6f} "
              f"(need >= {MIN_AGREEMENT})", flush=True)
        if agree < MIN_AGREEMENT:
            fail(f"class-map agreement {agree} < {MIN_AGREEMENT}")

        model = get_model("net_resnext50", classes=13, input_channels=4)
        init_params(model, torch.Generator().manual_seed(0))
        model = prepare_for_inference(model, dev)
        ds = PackedFrameDataset(pack)
        batch, _ = next(validate.batched((ds[i] for i in range(N_BATCH)), N_BATCH,
                                         ["rgb", "ir"]))
        with torch.no_grad():
            seg, taps, cert = model(validate.ingest(batch, "ir_rgb", dev,
                                                    model.compute_dtype))
        want = [(N_BATCH, H_IN, W_IN, 13), (N_BATCH, 40, 88, 512), (N_BATCH, 40, 88, 1024),
                (N_BATCH, 40, 88, 512), (N_BATCH, 80, 176, 256), (N_BATCH, 80, 176, 64)]
        got = [tuple(t.shape) for t in taps]
        if seg.dtype != torch.float32 or got != want or cert is not None:
            fail(f"forward outputs {seg.dtype} {got}")
        if not all(bool(torch.isfinite(t).all()) for t in taps):
            fail("non-finite values in the forward's outputs")
        if not np.array_equal(seg.argmax(-1).to(torch.uint8).cpu().numpy(), maps[:N_BATCH]):
            fail("a direct forward disagrees with the CLI's class maps")
        print("  forward: float32 logits, 6 taps of the JAX shapes, all finite", flush=True)

    # 5. the record
    k_ms, p_ms, b_ms, b_by = ingest_ms[(W_IN, 0, W_IN)]
    sums = [sum(r[1] * r[i] for r in gc_rows) for i in (2, 3, 4)]
    gc_bound, gc_by = bound_ms(sum(r[1] * r[6] for r in gc_rows),
                               sum(r[1] * r[7] for r in gc_rows))
    record = {"kernels": [
        {"name": "ingest", "route": "cuda",
         "source": "heatnet_tpu_torch/csrc/ingest.cu",
         "replaces": "heatnet_tpu/ops/pallas_preproc.py:60 (_ir_kernel), "
                     "heatnet_tpu/ops/pallas_preproc.py:68 (_rgb_kernel)",
         "launches": launches["ingest"], "max_abs_err": ingest_err,
         "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
         "library_ms": None,
         "work": f"early-fusion input, bf16, batch {N_BATCH} x {H_IN}x{W_IN}"},
        {"name": "grouped_conv3x3", "route": "cuda",
         "source": "heatnet_tpu_torch/csrc/grouped_conv3x3.cu",
         "replaces": "heatnet_tpu/ops/pallas_grouped_conv.py:141 (_kernel_fused), "
                     "heatnet_tpu/ops/pallas_grouped_conv.py:121 (_kernel)",
         "launches": launches["grouped_conv3x3"], "max_abs_err": gc_err,
         "ms": sums[0], "plain_ms": sums[1], "bound_ms": gc_bound,
         "bound_by": gc_by, "library_ms": sums[2],
         "work": f"one forward's 16 launches (3/4/6/3 per stage), batch {N_BATCH}, "
                 "fused bn3 + relu"},
    ]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
