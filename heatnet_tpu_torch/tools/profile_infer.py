"""Where a forward's time goes on the card: the main path at batch 1 and 8.

    python -m heatnet_tpu_torch.tools.profile_infer [--batches 1 8] [--iters 20]

For each batch size, ResNeXt-50 (random weights, seed 0) serves random
320x704 uint8/uint16 frames already on the card through the same
``ingest → model → argmax`` as ``eval.validate.predict``:

- ``forward_ms``: CUDA-event time per call, median and p95 of ``--iters``;
- a ``torch.profiler`` window of 5 calls: device time summed by kernel name
  and grouped into families (the port's two kernels, cuDNN/cuBLAS
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
    if "ingest" in n:
        return "ingest (port)"
    if any(s in n for s in ("cudnn", "cutlass", "xmma", "implicit_gemm",
                            "nvjet", "gemm", "nhwcaddpadding", "conv")):
        return "cuDNN/cuBLAS conv"
    if "batch_norm" in n:
        return "batch norm"
    if "multi_tensor" in n:
        return "optimizer"
    if "memcpy" in n:
        return "host-device copy"
    if any(s in n for s in ("elementwise", "reduce")):
        return "elementwise / reduce"
    return "other"


def main(argv=None) -> None:
    from ..models import get_model
    from ..models.layers import init_params, prepare_for_inference
    from ..ops import fused_preproc as fp

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batches", nargs="+", type=int, default=[1, 8])
    p.add_argument("--iters", type=int, default=20)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_infer needs a CUDA card")
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()[0])

    model = get_model("net_resnext50", classes=13, input_channels=4)
    init_params(model, torch.Generator().manual_seed(0))
    model = prepare_for_inference(model, dev)
    rng = np.random.RandomState(0)

    for b in args.batches:
        rgb = torch.from_numpy(rng.randint(0, 256, (b, 320, 704, 3)).astype(np.uint8)).to(dev)
        ir = rng.randint(21000, 26000, (b, 320, 704, 1)).astype(np.uint16)
        ir = torch.from_numpy(ir.view(np.int16)).to(dev).view(torch.uint16)

        def step():
            with torch.no_grad():
                x = fp.early_fusion_input(rgb, ir, 0, 704, model.compute_dtype)
                return model(x)[0].argmax(dim=-1).to(torch.uint8)

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
            "batch": b, "frames": "320x704",
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
