"""Where a forward's time goes on the card: the main path at batch 1 and 8.

    python -m heatnet_tpu_torch.tools.profile_infer [--batches 1 8] [--iters 20]
        [--arch resnext50|pspnet] [--late_fusion] [--quant int8]
        [--height 320] [--width 704]

For each batch size, the model (random weights, seed 0) serves random
``--height`` x ``--width`` (320x704) uint8/uint16 frames already on the
card through the same ``ingest → model → argmax`` as
``eval.validate.predict``. The model is
ResNeXt-50, early fusion (one 4-channel input) or ``--late_fusion`` (RGB and
IR from one two-output ingest launch), or ``--arch pspnet``: PSPNet on the
dilated ResNet-50, RGB only (``tools/bench_pspnet.py:52-64``). ``--quant
int8`` serves the int8 mode (``ops/quant.py``), calibrated on one frame.

- ``forward_ms``: CUDA-event time per call, median and p95 of ``--iters``;
- a ``torch.profiler`` window of 5 calls: device time summed by kernel name
  and grouped into families (the port's kernels, cuDNN/cuBLAS
  convolutions with their layout padding, BN, elementwise, other);
- the device's idle share of a call, 1 - busy/forward_ms_p50, from the
  profiled busy time and the unprofiled event time.

Prints the card (nvidia-smi) and one JSON line per batch size. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch


def _family(name: str) -> str:
    n = name.lower()
    if "grouped_conv3x3" in n:
        return "grouped_conv3x3 (port)"
    if "int8_conv" in n:
        return "int8_conv (port)"
    if "ingest" in n:
        return "ingest (port)"
    if any(s in n for s in ("cudnn", "cutlass", "xmma", "implicit_gemm",
                            "nvjet", "gemm", "nhwcaddpadding", "conv")):
        return "cuDNN/cuBLAS conv"
    if "batch_norm" in n:
        return "batch norm"
    if "upsample" in n:
        return "bilinear resize"
    if "multi_tensor" in n:
        return "optimizer"
    if "memcpy" in n:
        return "host-device copy"
    if any(s in n for s in ("elementwise", "reduce")):
        return "elementwise / reduce"
    return "other"


def main(argv=None) -> None:
    from ..models import build_network, get_model
    from ..models.layers import init_params, prepare_for_inference
    from ..ops import fused_preproc as fp
    from ..ops.quant import calibrate_int8, convert_int8

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batches", nargs="+", type=int, default=[1, 8])
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--arch", choices=("resnext50", "pspnet"), default="resnext50")
    p.add_argument("--late_fusion", action="store_true")
    p.add_argument("--quant", choices=("none", "int8"), default="none")
    p.add_argument("--height", type=int, default=320)
    p.add_argument("--width", type=int, default=704)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_infer needs a CUDA card")
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()[0])

    if args.arch == "pspnet":
        model = build_network("resnet50", in_channels=3, late_fusion=args.late_fusion)
    else:
        model = get_model("net_resnext50", classes=13, input_channels=4,
                          late_fusion=args.late_fusion)
    init_params(model, torch.Generator().manual_seed(0))
    if args.quant == "int8":
        convert_int8(model)
    model = prepare_for_inference(model, dev)
    rng = np.random.RandomState(0)
    calibrated = args.quant != "int8"

    h, w = args.height, args.width
    for b in args.batches:
        rgb = torch.from_numpy(rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8)).to(dev)
        ir = rng.randint(21000, 26000, (b, h, w, 1)).astype(np.uint16)
        ir = torch.from_numpy(ir.view(np.int16)).to(dev).view(torch.uint16)

        def inputs(rgb, ir):
            dtype = model.compute_dtype
            if args.arch == "pspnet":
                return (fp.rgb_normalize_fused(rgb, dtype),)
            if model.late_fusion:
                return fp.inference_preprocess_fused(rgb, ir, 0, w, dtype)
            return (fp.early_fusion_input(rgb, ir, 0, w, dtype),)

        def step():
            with torch.no_grad():
                return model(*inputs(rgb, ir))[0].argmax(dim=-1).to(torch.uint8)

        if not calibrated:  # the CLI's calibration: the first frame, at batch 1
            calibrate_int8(model, [inputs(rgb[:1], ir[:1])])
            calibrated = True
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        times = []
        for _ in range(args.iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            step()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))

        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(5):
                step()
            torch.cuda.synchronize()
        by_name, families = {}, {}
        for evt in prof.events():
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                continue
            ms = evt.device_time_total / 1e3  # a kernel's own span, in µs
            by_name[evt.name] = by_name.get(evt.name, 0.0) + ms
            fam = _family(evt.name)
            families[fam] = families.get(fam, 0.0) + ms
        busy = sum(by_name.values()) / 5
        p50 = float(np.median(times))
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
        print(json.dumps({
            "model": args.arch + (" late fusion" if args.late_fusion else "")
            + (" int8" if args.quant == "int8" else ""),
            "batch": b, "frames": f"{h}x{w}",
            "forward_ms_p50": p50,
            "forward_ms_p95": float(np.percentile(times, 95)),
            "profile_calls": 5,
            "device_busy_ms_per_call": busy,
            "idle_share": 1.0 - busy / p50,
            "families_ms_per_call": {k: v / 5 for k, v in
                                     sorted(families.items(), key=lambda kv: -kv[1])},
            "top_kernels_ms_per_call": [[k[:90], v / 5] for k, v in top],
        }), flush=True)


if __name__ == "__main__":
    main()
