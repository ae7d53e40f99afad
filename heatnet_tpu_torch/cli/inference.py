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
``cli/train_plain.py`` (``io/from_jax.py`` converts JAX trees). Runs on the card
unless ``--device cpu``. Not ported yet: orbax checkpoints, ``--borders-data``
and ``--quant`` (ROADMAP item 8).

Usage::

    python -m heatnet_tpu_torch.cli.inference --data PACK_DIR --batch 8
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..data.loaders import FreiburgInferDataset, prefetch_items
from ..data.packed import PackedFrameDataset, is_pack_dir
from ..device import resolve
from ..eval.validate import inference, modality_keys, predict
from ..io.checkpoint import load_state_dict
from ..models import ResNeXtSeg, get_model
from ..models.layers import init_params, prepare_for_inference


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="HeatNet inference (PyTorch/CUDA)")
    p.add_argument("--arch", "-a", default="resnext50")
    p.add_argument("--resume", default="", type=str,
                   help="PyTorch state_dict or checkpoint file to load")
    p.add_argument("--data", required=True,
                   help="heatnet-pack-v1 directory (meta.json, rgb.npy, ir.npy) or "
                        "capture tree (fl_rgb/ + fl_ir_aligned/)")
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
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    return p


@dataclasses.dataclass
class InferenceRun:
    network_seconds: float  # one frame's forward, averaged over --iters
    maps: np.ndarray        # (n, H, W) uint8 class maps of the directory
    frames_per_second: Optional[float] = None  # --batch mode, end to end


def main(argv=None) -> InferenceRun:
    args = build_parser().parse_args(argv)
    device = resolve(args.device)
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
    model = prepare_for_inference(model, device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    item = ds[0]  # decoded once: a capture tree's frames are PNGs
    first = {k: item[k] for k in modality_keys(args.modalities)}
    predict(model, first, args.modalities, device)  # warm-up
    sync()
    t0 = time.perf_counter()
    for _ in range(args.iters):
        predict(model, first, args.modalities, device)
    sync()
    dt = (time.perf_counter() - t0) / max(args.iters, 1)
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
