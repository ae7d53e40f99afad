"""Host time of the serving path: per call of the grouped conv, per forward.

    python -m heatnet_tpu_torch.tools.host_time    (needs a card)

Prints the card's name and power limit, then one JSON line:

- ``per_call_us``: host time per call at mod3's serving shape (batch 8,
  40x88, C 256, cpg 4), the mean of 300 calls enqueued without a
  synchronise, the median of 7 such rounds taken in turn with the other
  calls': the fused grouped conv, the same without the wrapper's check for
  a trace (``kernels/build.py::tracing``), the same call through its
  registered op (``torch.ops.heatnet.grouped_conv3x3_fused``, the route an
  exported program takes; ``ops/library.py``), its dx and
  ``F.conv2d(groups=64)`` (the library's call, a yardstick);
- ``forward_ms``: for batches 1 and 8 of the serving forward (ingest ->
  ResNeXt-50 -> argmax), the p50 over 50 forwards of the host's enqueue time
  (``step()`` returning) and of the wall time to a synchronise. Where the two
  are close, the forward is bound by the host.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch
import torch.nn.functional as F


def main() -> None:
    from ..models import get_model
    from ..models.layers import init_params, prepare_for_inference
    from ..ops import fused_preproc as fp
    from ..ops import grouped_conv as gc

    if not torch.cuda.is_available():
        raise SystemExit("host_time needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()[0])
    dev = torch.device("cuda")

    def host_us(fn, n=300):
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / n * 1e6

    c, cpg, d = 256, 4, 1
    g = torch.Generator().manual_seed(0)
    x = torch.randn((8, 40, 88, c), generator=g).to(dev, torch.bfloat16)
    w = torch.randn((c, cpg, 3, 3), generator=g).to(dev, torch.bfloat16)
    s, b = torch.rand(c, device=dev) + 0.5, torch.rand(c, device=dev)
    x_cl = x.permute(0, 3, 1, 2)
    calls = {
        "grouped_conv3x3_fused": lambda: gc.grouped_conv3x3_fused(x, w, s, b, c // cpg, d),
        "grouped_conv3x3_fused without the trace check": lambda: gc._conv(
            x, w, c // cpg, d, s, b, "relu", 0.01, gc.GROUPED_CONV3X3_FUSED),
        "torch.ops.heatnet.grouped_conv3x3_fused": lambda: (
            torch.ops.heatnet.grouped_conv3x3_fused(x, w, s, b, c // cpg, d, "relu", 0.01)),
        "grouped_conv3x3_dx": lambda: gc.grouped_conv3x3_dx(x, w, c // cpg, d),
        "F.conv2d": lambda: F.conv2d(x_cl, w, padding=d, dilation=d, groups=c // cpg),
    }
    rounds = {k: [] for k in calls}
    for _ in range(7):
        for k, fn in calls.items():
            rounds[k].append(host_us(fn))
    per_call = {k: float(np.median(v)) for k, v in rounds.items()}

    model = get_model("net_resnext50", classes=13, input_channels=4)
    init_params(model, torch.Generator().manual_seed(0))
    model = prepare_for_inference(model, dev)
    rng = np.random.RandomState(0)
    forward = {}
    for n in (1, 8):
        rgb = torch.from_numpy(rng.randint(0, 256, (n, 320, 704, 3)).astype(np.uint8)).to(dev)
        ir = rng.randint(21000, 26000, (n, 320, 704, 1)).astype(np.uint16)
        ir = torch.from_numpy(ir.view(np.int16)).to(dev).view(torch.uint16)

        def step():
            with torch.no_grad():
                xin = fp.early_fusion_input(rgb, ir, 0, 704, model.compute_dtype)
                return model(xin)[0].argmax(dim=-1).to(torch.uint8)

        for _ in range(5):
            step()
        torch.cuda.synchronize()
        enqueue, wall = [], []
        for _ in range(50):
            t0 = time.perf_counter()
            step()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            enqueue.append((t1 - t0) * 1e3)
            wall.append((time.perf_counter() - t0) * 1e3)
        forward[f"batch {n}"] = {"enqueue_ms_p50": float(np.median(enqueue)),
                                 "wall_ms_p50": float(np.median(wall))}
    print(json.dumps({"per_call_us": per_call, "forward_ms": forward}), flush=True)


if __name__ == "__main__":
    main()
