"""Where a training step's time goes on the card: the train_plain step.

    python -m heatnet_tpu_torch.tools.profile_train [--batch 10] [--iters 10]

ResNeXt-50 (random weights, seed 0), batch ``--batch`` of 320x640 crops from
random 320x960 frames, through the trainer's own pieces: ``DeviceAugment``
(host frames → the card → augmentation) and ``cli.train_plain.train_step``
(train-mode forward, loss, backward, Adam and schedule steps). Reports:

- ``step_ms``: CUDA-event time of augmentation + step, median and p95 of
  ``--iters``, and of the step alone (batch already on the card);
- a ``torch.profiler`` window of 3 steps: device time by kernel family (the
  grouped-conv kernel's forward and dx launches together, cuDNN/cuBLAS
  convolutions and their weight gradients, BN, elementwise, optimizer, other);
- the device's idle share of a step, 1 - busy/step_ms_p50;
- peak device memory over the steps.

Prints the card (nvidia-smi) and one JSON line. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch


def main(argv=None) -> None:
    from ..cli import train_plain
    from ..data.loaders import DeviceAugment
    from ..models import get_model
    from ..ops import grouped_conv as gc
    from ..train.state import init_model
    from .profile_infer import _family

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=10)
    p.add_argument("--iters", type=int, default=10)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA card")
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()[0])

    model = init_model(get_model("net_resnext50", classes=13, input_channels=4), 0, dev)
    opt = train_plain.build_parser().parse_args(["--dataroot", "-"])
    state = train_plain.create_state(model, opt, steps_per_epoch=1)
    augment = DeviceAugment((320, 640), dev)
    generator = torch.Generator().manual_seed(0)

    rng = np.random.RandomState(0)
    n, h, w = args.batch, 320, 960
    bands = (np.arange(h)[:, None] // 64 + np.arange(w)[None, :] // 192) % 13
    raw = {"rgb_day": rng.randint(0, 256, (n, h, w, 3)).astype(np.uint8),
           "ir_day": rng.randint(21000, 26000, (n, h, w)).astype(np.uint16),
           "label_day": np.broadcast_to(bands, (n, h, w)).astype(np.uint8),
           "rgb_night": rng.randint(0, 256, (n, h, w, 3)).astype(np.uint8),
           "ir_night": rng.randint(21000, 26000, (n, h, w)).astype(np.uint16)}
    batch = augment(generator, raw)

    def timed(fn, iters):
        times = []
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return times

    def full_step():
        return train_plain.train_step(state, augment(generator, raw))

    for _ in range(3):
        full_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gc.layout_copies.update(x=0, dy=0)
    full = timed(full_step, args.iters)
    copies = dict(gc.layout_copies)
    step_only = timed(lambda: train_plain.train_step(state, batch), args.iters)
    aug_only = timed(lambda: augment(generator, raw), args.iters)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            full_step()
        torch.cuda.synchronize()
    by_name, families = {}, {}
    for evt in prof.events():
        # user annotations (Optimizer.step) span kernels counted on their own
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)):
            continue
        ms = evt.device_time_total / 1e3
        by_name[evt.name] = by_name.get(evt.name, 0.0) + ms
        fam = _family(evt.name)
        families[fam] = families.get(fam, 0.0) + ms
    busy = sum(by_name.values()) / 3
    p50 = float(np.median(full))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    print(json.dumps({
        "batch": n, "crop": "320x640", "frames": "320x960",
        "step_ms_p50": p50, "step_ms_p95": float(np.percentile(full, 95)),
        "step_only_ms_p50": float(np.median(step_only)),
        "step_only_ms_p95": float(np.percentile(step_only, 95)),
        "augment_ms_p50": float(np.median(aug_only)),
        "peak_memory_gb": peak_gb,
        "layout_copies_per_step": {k: v / args.iters for k, v in copies.items()},
        "profile_steps": 3,
        "device_busy_ms_per_step": busy,
        "idle_share": 1.0 - busy / p50,
        "families_ms_per_step": {k: v / 3 for k, v in
                                 sorted(families.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms_per_step": [[k[:90], v / 3] for k, v in top],
    }), flush=True)


if __name__ == "__main__":
    main()
