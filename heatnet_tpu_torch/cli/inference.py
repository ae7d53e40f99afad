"""RGB+thermal directory inference with forward-pass timing.

Counterpart of ``heatnet_tpu/cli/inference.py:141-241``. ``--data`` is a
heatnet-pack-v1 directory (``data/packed.py``), which serves frames with no
decode step, or a capture tree (``fl_rgb/`` + ``fl_ir_aligned/`` PNGs, read by
``data.loaders.FreiburgInferDataset`` without cv2). It prints the same
``Network took %f seconds`` (one frame, averaged over ``--iters``) and ``Ran
inference on N frames`` lines; ``--batch N`` serves the directory in batches
of N, decoding ahead on ``--io-threads`` threads, and prints ``Directory
throughput: ... frames/sec end-to-end``. ``--im-save-dir`` writes each
frame's class map (``pred_<i>.png``, palette colours) and RGB.

``--arch`` is ``resnext50``, ``resnext101`` or ``resnext152`` (the registry's
``net_<arch>``, ``heatnet_tpu/cli/inference.py:161-162``). Weights are
random from seed 0 unless ``--resume`` names a PyTorch
``state_dict`` file or a ``{"epoch", "state_dict"}`` checkpoint of
``cli/train_plain.py`` (``io/from_jax.py`` converts JAX trees;
``cli/convert_checkpoint.py`` converts the reference's). Runs on the card
unless ``--device cpu``. Not ported yet: orbax checkpoints (ROADMAP item 8).

``--quant int8`` serves the int8 mode (:126-138, :194-203): the loaded float
model goes through ``ops/quant.py::convert_int8`` and is calibrated on the
first frame, at batch 1, before anything is timed. Below batch 8
(``--batch 0``'s frame-at-a-time loop included) every layer serves its float
conv. The int8 kernel (``csrc/int8_conv.cu``) is exact but untuned: on an
H100 80GB HBM3 at 700 W, ``chip_smoke.py`` phase 9b measures an int8
forward about 7x slower than the bf16 one at batch 8 and 32, so bf16 is the
mode to serve with until the kernel is made faster (ROADMAP §2).

``--borders-data paths.txt`` is the reference's ``scripts/inference.py:91-143``
mode (:54-119): the RGB-only Vistas segnet (7x7 stem) on
``data.loaders.VistasBordersDataset``'s frames at ``--width`` x ``--height``,
``Network took`` for the first frame, and with ``--im-save-dir`` the
colour-coded ``pred_<i>.png``, ``gt_<i>.png`` and ``rgb_<i>.png`` of every
frame. One of ``--data`` and ``--borders-data`` is required.

Usage::

    python -m heatnet_tpu_torch.cli.inference --data PACK_DIR --batch 8 --quant int8
    python -m heatnet_tpu_torch.cli.inference --borders-data paths.txt --im-save-dir out
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from ..data.loaders import FreiburgInferDataset, VistasBordersDataset, prefetch_items
from ..data.packed import PackedFrameDataset, is_pack_dir
from ..device import resolve
from ..eval.validate import ingest, inference, modality_keys, predict
from ..io.checkpoint import load_state_dict, restore_partial
from ..models import ResNeXtSeg, get_model
from ..models.layers import init_params, prepare_for_inference
from ..ops.quant import calibrate_int8, convert_int8


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="HeatNet inference (PyTorch/CUDA)")
    p.add_argument("--arch", "-a", default="resnext50")
    p.add_argument("--resume", default="", type=str,
                   help="PyTorch state_dict or checkpoint file to load")
    p.add_argument("--data", default="",
                   help="heatnet-pack-v1 directory (meta.json, rgb.npy, ir.npy) or "
                        "capture tree (fl_rgb/ + fl_ir_aligned/)")
    p.add_argument("--borders-data", default="", type=str,
                   help="vistas-borders paths.txt (scripts/inference.py:97 mode)")
    p.add_argument("--width", default=768, type=int,
                   help="borders mode width (scripts/inference.py:92)")
    p.add_argument("--height", default=384, type=int)
    p.add_argument("--im-save-dir", default="", type=str,
                   help="write pred_<i>.png and rgb_<i>.png for every frame")
    p.add_argument("--modalities", default="ir_rgb")
    p.add_argument("--iters", default=10, type=int, help="timing iterations")
    p.add_argument("--batch", default=0, type=int,
                   help="serve the directory in batches of this many frames, "
                        "decoded ahead, the ragged tail padded, and print the "
                        "directory throughput; 0 = one frame at a time")
    p.add_argument("--io-threads", default=8, type=int,
                   help="decode threads for --batch mode")
    p.add_argument("--classes", default=13, type=int)
    p.add_argument("--structure", nargs=4, type=int, default=[3, 4, 6, 3])
    p.add_argument("--quant", default="none", choices=["none", "int8"],
                   help="int8: serve the int8 mode (ops/quant.py), calibrating the "
                        "activation scales on the first frame; float below batch 8. "
                        "Its kernel is untuned: on an H100 80GB HBM3 (700 W) it "
                        "serves about 7x slower than bf16 (chip_smoke.py phase 9b, "
                        "PERF.md)")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    return p


@dataclasses.dataclass
class InferenceRun:
    network_seconds: float  # one frame's forward, averaged over --iters
    maps: np.ndarray        # (n, H, W) uint8 class maps of the directory
    frames_per_second: Optional[float] = None  # --batch mode, end to end


def _timed(forward, iters: int, device: torch.device) -> float:
    """Seconds per call of ``forward`` over ``iters`` calls, after a warm-up."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    forward()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        forward()
    sync()
    return (time.perf_counter() - t0) / max(iters, 1)


def _borders_main(args, device: torch.device) -> InferenceRun:
    """The Vistas-borders mode (``heatnet_tpu/cli/inference.py:54-119``)."""
    from ..utils.vis import color_code_labels, save_image

    ds = VistasBordersDataset(args.borders_data, args.width, args.height,
                              contrast_enhancement=False, augment_data=False)
    model = ResNeXtSeg(structure=tuple(args.structure), input_channels=3,
                       classes=args.classes, input_3x3=False)
    init_params(model, torch.Generator().manual_seed(0))
    if args.resume:
        restore_partial(model, load_state_dict(args.resume))
    if args.quant == "int8":
        convert_int8(model)
    model = prepare_for_inference(model, device)

    def image(item):
        return torch.from_numpy(item["image"][None]).to(device)

    def forward(x):
        with torch.no_grad():
            return model(x)[0].argmax(dim=-1).to(torch.uint8)

    first = image(ds[0])
    if args.quant == "int8":
        calibrate_int8(model, [(first,)])
    dt = _timed(lambda: forward(first), args.iters, device)
    print("Network took %f seconds" % dt)

    maps = [forward(first)[0].cpu().numpy()]
    if args.im_save_dir:
        os.makedirs(args.im_save_dir, exist_ok=True)
        maps = []
        for i in range(len(ds)):
            item = ds[i]
            pred = forward(image(item))[0].cpu().numpy()
            maps.append(pred)
            save_image(os.path.join(args.im_save_dir, f"pred_{i}.png"), color_code_labels(pred))
            save_image(os.path.join(args.im_save_dir, f"gt_{i}.png"),
                       color_code_labels(item["ids"]))
            save_image(os.path.join(args.im_save_dir, f"rgb_{i}.png"), item["image_org"])
    return InferenceRun(dt, np.stack(maps))


def main(argv=None) -> InferenceRun:
    args = build_parser().parse_args(argv)
    device = resolve(args.device)
    if args.borders_data:
        return _borders_main(args, device)
    if not args.data:
        raise SystemExit("one of --data / --borders-data is required")
    # a pack serves decode-free; a capture tree decodes per frame
    ds = (PackedFrameDataset(args.data) if is_pack_dir(args.data)
          else FreiburgInferDataset(args.data))
    if len(ds) == 0:
        raise FileNotFoundError(f"no frames under {args.data}")

    n_in = (3 if "rgb" in args.modalities else 0) + \
        (1 if "ir" in args.modalities else 0)
    if tuple(args.structure) == (3, 4, 6, 3):
        model = get_model("net_" + args.arch, classes=args.classes,
                          input_channels=n_in)
    else:
        model = ResNeXtSeg(structure=tuple(args.structure),
                           classes=args.classes, input_channels=n_in)
    init_params(model, torch.Generator().manual_seed(0))
    if args.resume:
        model.load_state_dict(load_state_dict(args.resume))
    if args.quant == "int8":
        convert_int8(model)
    model = prepare_for_inference(model, device)

    item = ds[0]  # decoded once: a capture tree's frames are PNGs
    first = {k: item[k] for k in modality_keys(args.modalities)}
    if args.quant == "int8":
        # one calibration pass on the first frame records the static scales
        calibrate_int8(model, [ingest(first, args.modalities, device, model.compute_dtype,
                                      getattr(model, "late_fusion", False))])
    dt = _timed(lambda: predict(model, first, args.modalities, device), args.iters, device)
    print("Network took %f seconds" % dt)

    if args.batch > 0:
        t0 = time.perf_counter()
        maps = inference(model, prefetch_items(ds, workers=args.io_threads,
                                               depth=max(4 * args.batch, 32)),
                         args.batch, device, args.modalities, save_dir=args.im_save_dir)
        fps = len(maps) / (time.perf_counter() - t0)
        print(f"Directory throughput: {fps:.1f} frames/sec end-to-end ({len(maps)} "
              f"frames, batch {args.batch}, decode+H2D+forward"
              f"{'+save' if args.im_save_dir else ''})")
    else:
        fps = None
        maps = inference(model, (ds[i] for i in range(len(ds))), 1, device,
                         args.modalities, save_dir=args.im_save_dir)
    print(f"Ran inference on {len(maps)} frames")
    return InferenceRun(dt, maps, fps)


if __name__ == "__main__":
    main()
