"""Where the adversarial trainer's time goes on the card: seg and critic steps.

    python -m heatnet_tpu_torch.tools.profile_adversarial [--batch 16] [--iters 10]
        [--arch custom|pspnet] [--late_fusion]

The JAX bench's adversarial operating point (``tools/bench_train_step.py:140-170``):
ResNeXt-50 (3,4,6,3), groups 64, dilation (1,1,2,4), early fusion (or
``--late_fusion``; or ``--arch pspnet``, PSPNet on the dilated ResNet-50),
6 ``cyclegan`` critics, batch ``--batch`` of 320x640 crops from random
320x960 frames, ``--moddrop --irscale``, and a random IR-only teacher of the
same arch (the night supervision; random weights from seeds). Each step
goes through the trainer's own pieces: ``DeviceAugment`` (host frames → the
card → augmentation), ``ConfSegnet.draw_dropout`` (PSPNet's masks) and
``train.adversarial``'s ``seg_step`` / ``critic_step``.
Reports, for each phase:

- ``step_ms``: CUDA-event time of augmentation + step, median and p95 of
  ``--iters``;
- a ``torch.profiler`` window of 3 steps: device time by kernel family (the
  grouped-conv kernel's forward, fused and dx launches together, cuDNN/cuBLAS
  convolutions and their gradients, BN, elementwise, the critics' bilinear
  resizes, optimizer, other) and the device's idle share, 1 - busy/p50;
- peak device memory over the phase's steps.

Prints the card (nvidia-smi) and one JSON line. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch


def main(argv=None) -> None:
    from ..data.loaders import DeviceAugment
    from ..models import ConfSegnet, ResNeXtSeg, build_network
    from ..models.layers import init_params, prepare_for_inference
    from ..train import adversarial as adv
    from ..train.state import init_model
    from .profile_infer import _family

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--arch", choices=("custom", "pspnet"), default="custom")
    p.add_argument("--late_fusion", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_adversarial needs a CUDA card")
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()[0])

    model = init_model(ConfSegnet(disc_arch="cyclegan", num_critics=6, arch=args.arch,
                                  late_fusion=args.late_fusion), 0, dev)
    teacher = (build_network("resnet50", in_channels=1) if args.arch == "pspnet"
               else ResNeXtSeg(structure=(3, 4, 6, 3), input_channels=1))
    init_params(teacher, torch.Generator().manual_seed(1))
    teacher = prepare_for_inference(teacher, dev)
    cfg = adv.AdversarialConfig(moddrop=True, irscale=True, night_supervision=True)
    state = adv.make_phase_optimizers(model, lambda count: 1e-4)
    seg_step, critic_step = adv.make_adversarial_steps(model, cfg, teacher)
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

    def seg():
        batch = augment(generator, raw)
        draws = adv.draw_seg_aug(generator)
        draws.dropout = model.draw_dropout(n, generator)
        return seg_step(state, batch, draws)

    steps = {
        "seg": seg,
        "critic": lambda: critic_step(state, augment(generator, raw),
                                      model.draw_dropout(n, generator)),
    }

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

    out = {"arch": args.arch + (" late fusion" if args.late_fusion else ""), "batch": n,
           "crop": "320x640", "frames": "320x960", "critics": "6 cyclegan",
           "teacher": f"IR-only {args.arch}, eval", "profile_steps": 3}
    for phase, fn in steps.items():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = timed(fn, args.iters)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(3):
                fn()
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
        p50 = float(np.median(times))
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
        out[phase] = {
            "step_ms_p50": p50, "step_ms_p95": float(np.percentile(times, 95)),
            "peak_memory_gb": peak_gb, "device_busy_ms_per_step": busy,
            "idle_share": 1.0 - busy / p50,
            "families_ms_per_step": {k: v / 3 for k, v in
                                     sorted(families.items(), key=lambda kv: -kv[1])},
            "top_kernels_ms_per_step": [[k[:90], v / 3] for k, v in top],
        }
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
