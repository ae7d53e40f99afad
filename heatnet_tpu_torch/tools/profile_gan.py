"""Where the IR-only trainers' time goes on the card: CycleGAN and uncertainty steps.

    python -m heatnet_tpu_torch.tools.profile_gan [--iters 10]

Three steps at the CLIs' defaults, random weights from seeds, through the
trainers' own pieces:

- ``generator``: ``train.cyclegan``'s generator step (two 9-block
  ``Generator``s, the identity, GAN and cycle losses through both
  ``Discriminator``s, netSeg ResNeXt-50 (3,4,6,3) with 12 classes twice in
  train mode), batch 2 of 256x256 KAIST-size frames on the card;
- ``discriminator``: the D_A step on a real batch and replayed fakes;
- ``uncertainty``: ``cli.train_uncertainty``'s chain, random 320x960 frames
  → ``DeviceAugment`` (320x640 crops) → ``subsample`` (80x160) → the step
  (two (2,2,2,2) encoders, the seg and uncertainty decoders), batch 4.

For each: CUDA-event time per step (median and p95 of ``--iters``), a
``torch.profiler`` window of 3 steps with device time by kernel family (as
``tools/profile_train.py`` groups them), the device's idle share
(1 - busy/p50), and peak device memory over the timed steps. Prints the
card (nvidia-smi) and one JSON line. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch


def main(argv=None) -> None:
    from ..cli import train_cyclegan, train_uncertainty
    from ..data.loaders import DeviceAugment
    from ..train import cyclegan as tc
    from ..train import uncertainty as tu
    from .profile_infer import _family

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=10)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_gan needs a CUDA card")
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()[0])

    opt = train_cyclegan.build_parser().parse_args([])
    nets = train_cyclegan.build_nets(opt, dev)
    state = tc.CycleGANState.create(nets, lambda count: opt.lr)
    g_step, d_a_step, _ = tc.make_cyclegan_steps(
        *(nets[k] for k in ("netG_A2B", "netG_B2A", "netD_A", "netD_B", "netSeg")))
    g = torch.Generator().manual_seed(0)
    n = opt.batchSize
    batch = {"A": (torch.rand((n, 256, 256, 1), generator=g) * 2 - 1).to(dev),
             "B": (torch.rand((n, 256, 256, 1), generator=g) * 2 - 1).to(dev),
             "label": torch.randint(0, opt.n_classes, (n, 256, 256), generator=g).to(dev)}
    fake_a = g_step(state, batch)[0]

    uopt = train_uncertainty.build_parser().parse_args(["--dataroot", "-"])
    mods = train_uncertainty.build_modules(uopt.structure, dev)
    ustate = tu.create_state(mods, lambda count: uopt.lr)
    ustep = tu.make_uncertainty_step(*(mods[k] for k in tu.MODULE_NAMES))
    augment = DeviceAugment((320, 640), dev)
    rng = np.random.RandomState(0)
    un, h, w = uopt.batch_size, 320, 960
    raw = {"rgb_day": rng.randint(0, 256, (un, h, w, 3)).astype(np.uint8),
           "ir_day": rng.randint(21000, 26000, (un, h, w)).astype(np.uint16),
           "label_day": rng.randint(0, 12, (un, h, w)).astype(np.uint8),
           "rgb_night": rng.randint(0, 256, (un, h, w, 3)).astype(np.uint8),
           "ir_night": rng.randint(21000, 26000, (un, h, w)).astype(np.uint16)}

    steps = {
        "generator": lambda: g_step(state, batch),
        "discriminator": lambda: d_a_step(state, batch["A"], fake_a),
        "uncertainty": lambda: ustep(ustate, train_uncertainty.subsample(augment(g, raw))),
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

    out = {"generator": {"batch": n, "frames": "256x256", "residual_blocks":
                         opt.n_residual_blocks, "netSeg": opt.seg_structure},
           "uncertainty": {"batch": un, "frames": "320x960 -> 320x640 crop -> 80x160",
                           "structure": uopt.structure},
           "profile_steps": 3}
    for name, fn in steps.items():
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
        out.setdefault(name, {}).update({
            "step_ms_p50": p50, "step_ms_p95": float(np.percentile(times, 95)),
            "peak_memory_gb": peak_gb, "device_busy_ms_per_step": busy,
            "idle_share": 1.0 - busy / p50,
            "families_ms_per_step": {k: v / 3 for k, v in
                                     sorted(families.items(), key=lambda kv: -kv[1])},
            "top_kernels_ms_per_step": [[k[:90], v / 3] for k, v in top],
        })
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
