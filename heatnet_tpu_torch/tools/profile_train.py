"""Where a training step's time goes on the card: the train_plain step, with
``--vistas`` the Vistas pretraining step of ``cli/main.py``, or with
``--baseline`` an MFNet harness step of ``cli/train_baseline.py``.

    python -m heatnet_tpu_torch.tools.profile_train [--batch 10] [--iters 10]
    python -m heatnet_tpu_torch.tools.profile_train --vistas [--batch 30] [--workers 8]
    python -m heatnet_tpu_torch.tools.profile_train --baseline RTFNet [--batch 8]

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

``--vistas``: ResNeXt-50 at ``experiments/heatnet_conf.json``'s settings
(3-channel input, 3x3 stem, leaky ReLU 0.01, 13 classes), batch ``--batch``
(30) of 384x768 crops, Adam at 1e-5 with the poly decay, through
``cli.main``'s pieces: a synthetic Vistas tree of 1024x768 PNG frames
written to a temporary directory, ``VistasDataset``'s host chain on
``--workers`` threads (``batch_iterator``), the H2D copy and the supervised
step. Reports the step's CUDA-event p50/p95 (H2D to loss, the batch decoded
beforehand), the same device-time breakdown, idle share and peak memory,
and the host's ms per batch for decode and augmentation (on one thread and
on ``--workers``), apart from the card's time.

``--baseline {MFNet,RTFNet,SegNet}``: the harness's model (random weights,
seed 0) in float32 at batch ``--batch`` (8) of 480x640 frames, SGD with
momentum and weight decay, through ``cli.train_baseline``'s pieces:
``MFHarnessTrainDataset`` (decode, flip, crop, resize on the host) on a
synthetic MFNet tree of 480x640 PNG frames, the H2D copy and
``make_train_step``. Reports the step's CUDA-event p50/p95 (H2D to the SGD
step, the batch decoded beforehand) with cuDNN's TF32 convolutions allowed
(PyTorch's default, as the CLI runs) and with them off (strict float32),
the device-time breakdown, idle share and peak memory of the default, the
eval-mode forward of a batch of 8 (frames/s), and the host's ms per batch.

Prints the card (nvidia-smi) and one JSON line. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import tempfile
import time

import numpy as np
import torch


def main(argv=None) -> None:
    from ..cli import train_plain
    from ..data.loaders import DeviceAugment
    from ..models import get_model
    from ..ops import grouped_conv as gc
    from ..train.state import init_model

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=None,
                   help="10 (30 with --vistas, 8 with --baseline)")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--vistas", action="store_true")
    p.add_argument("--baseline", choices=["MFNet", "RTFNet", "SegNet"], default=None)
    p.add_argument("--workers", type=int, default=8, help="decode threads (--vistas)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA card")
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()[0])
    if args.vistas:
        print(json.dumps(profile_vistas(args.batch or 30, args.iters, args.workers, dev)),
              flush=True)
        return
    if args.baseline:
        print(json.dumps(profile_baseline(args.baseline, args.batch or 8, args.iters, dev)),
              flush=True)
        return

    model = init_model(get_model("net_resnext50", classes=13, input_channels=4), 0, dev)
    opt = train_plain.build_parser().parse_args(["--dataroot", "-"])
    state = train_plain.create_state(model, opt, steps_per_epoch=1)
    augment = DeviceAugment((320, 640), dev)
    generator = torch.Generator().manual_seed(0)

    rng = np.random.RandomState(0)
    n, h, w = args.batch or 10, 320, 960
    bands = (np.arange(h)[:, None] // 64 + np.arange(w)[None, :] // 192) % 13
    raw = {"rgb_day": rng.randint(0, 256, (n, h, w, 3)).astype(np.uint8),
           "ir_day": rng.randint(21000, 26000, (n, h, w)).astype(np.uint16),
           "label_day": np.broadcast_to(bands, (n, h, w)).astype(np.uint8),
           "rgb_night": rng.randint(0, 256, (n, h, w, 3)).astype(np.uint8),
           "ir_night": rng.randint(21000, 26000, (n, h, w)).astype(np.uint16)}
    batch = augment(generator, raw)

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

    by_name, families, busy = device_breakdown(full_step)
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


def timed(fn, iters):
    """CUDA-event ms of each of ``iters`` calls of ``fn``."""
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


def device_breakdown(step, steps: int = 3):
    """Device ms by kernel name and by family over ``steps`` calls of
    ``step`` (torch.profiler), and the busy ms per call."""
    from .profile_infer import _family

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            step()
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
    return by_name, families, sum(by_name.values()) / steps


def profile_vistas(n: int, iters: int, workers: int, dev: torch.device) -> dict:
    """The ``--vistas`` report (see the module docstring)."""
    from ..cli import main as vistas_cli
    from ..data.loaders import VistasDataset, batch_iterator, to_device
    from ..data.synthetic import make_vistas
    from ..ops import grouped_conv as gc
    from ..train.state import init_model
    from ..train.supervised import make_train_step
    from ..utils.config import load_config

    conf = load_config(vistas_cli.DEFAULT_CONFIG)
    args = vistas_cli.build_parser().parse_args(["--data", "-", "--valdata", "-"])
    model = init_model(vistas_cli.build_model(args, conf), 0, dev)
    state = vistas_cli.create_state(model, conf["optimizer"], total_steps=1000)
    step = make_train_step(model)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        make_vistas(tmp, n=n, hw=(768, 1024), seed=0)
        write_s = time.perf_counter() - t0
        ds = VistasDataset(tmp, width=768, height=384)
        t0 = time.perf_counter()
        items = [ds[i] for i in range(n)]
        one_thread_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        raw = next(batch_iterator(ds, n, seed=0, workers=workers))
        threaded_ms = (time.perf_counter() - t0) * 1e3
    del items

    def full_step():
        return step(state, {"image": to_device(raw["image"], dev),
                            "label": to_device(raw["label"], dev).long()})

    for _ in range(3):
        full_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in (gc.GROUPED_CONV3X3, gc.GROUPED_CONV3X3_DX):
        k.launches = 0
    full = timed(full_step, iters)
    launches = {k.name: k.launches / iters for k in (gc.GROUPED_CONV3X3, gc.GROUPED_CONV3X3_DX)}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    by_name, families, busy = device_breakdown(full_step)
    p50 = float(np.median(full))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    return {
        "what": "vistas", "batch": n, "crop": "384x768", "frames": "768x1024 PNG",
        "step_ms_p50": p50, "step_ms_p95": float(np.percentile(full, 95)),
        "frames_per_s_card": n / p50 * 1e3, "peak_memory_gb": peak_gb,
        "launches_per_step": launches,
        "host_ms_per_batch_one_thread": one_thread_ms,
        f"host_ms_per_batch_{workers}_threads": threaded_ms,
        "host_share_if_serial": threaded_ms / (threaded_ms + p50),
        "tree_write_s": write_s, "profile_steps": 3,
        "device_busy_ms_per_step": busy, "idle_share": 1.0 - busy / p50,
        "families_ms_per_step": {k: v / 3 for k, v in
                                 sorted(families.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms_per_step": [[k[:90], v / 3] for k, v in top],
    }


def profile_baseline(name: str, n: int, iters: int, dev: torch.device) -> dict:
    """The ``--baseline`` report (see the module docstring)."""
    from ..cli.train_baseline import EVAL_BATCH, build_model, make_train_step
    from ..data.loaders import MFHarnessTrainDataset, batch_iterator, to_device
    from ..data.mf_augment import default_train_augmentations
    from ..data.synthetic import make_mfnet
    from ..models.layers import init_params, prepare_for_training

    model = build_model(name)
    init_params(model, torch.Generator().manual_seed(0))
    prepare_for_training(model, dev, dtype=torch.float32)
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9, weight_decay=5e-4)
    step = make_train_step(model, opt)
    with tempfile.TemporaryDirectory() as tmp:
        make_mfnet(tmp, n_train=n, n_test=0, hw=(480, 640), seed=0)
        ds = MFHarnessTrainDataset(tmp, transform=default_train_augmentations(seed=0))
        t0 = time.perf_counter()
        raw = next(batch_iterator(ds, n, seed=1))
        host_ms = (time.perf_counter() - t0) * 1e3

    def full_step():
        return step(to_device(raw["image"], dev), to_device(raw["label"], dev))

    tf32 = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = False
        for _ in range(3):
            full_step()
        strict = timed(full_step, iters)
        torch.backends.cudnn.allow_tf32 = True
        for _ in range(3):
            full_step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        full = timed(full_step, iters)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        by_name, families, busy = device_breakdown(full_step)
        image = to_device(raw["image"][:EVAL_BATCH], dev)
        model.eval()
        with torch.no_grad():
            fwd = timed(lambda: model(image).argmax(-1), iters)
        model.train()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    p50 = float(np.median(full))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    return {
        "what": f"baseline {name}", "batch": n, "frames": "480x640 PNG, float32 /255",
        "params_m": sum(p.numel() for p in model.parameters()) / 1e6,
        "step_ms_p50": p50, "step_ms_p95": float(np.percentile(full, 95)),
        "step_ms_p50_tf32_off": float(np.median(strict)),
        "step_ms_p95_tf32_off": float(np.percentile(strict, 95)),
        "frames_per_s_card": n / p50 * 1e3, "peak_memory_gb": peak_gb,
        "eval_forward_ms_p50": float(np.median(fwd)),
        "eval_frames_per_s": EVAL_BATCH / float(np.median(fwd)) * 1e3,
        "host_ms_per_batch_one_thread": host_ms, "profile_steps": 3,
        "device_busy_ms_per_step": busy, "idle_share": 1.0 - busy / p50,
        "families_ms_per_step": {k: v / 3 for k, v in
                                 sorted(families.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms_per_step": [[k[:90], v / 3] for k, v in top],
    }


if __name__ == "__main__":
    main()
