"""The MFNet harness's demo: predict every PNG of a directory, write ``*_pred.png``.

Counterpart of ``heatnet_tpu/cli/run_demo.py:40-124`` (the reference's
``models/external_models/mfnet/run_demo.py``): the ``--model_name`` baseline
with the checkpoint ``<model_dir>/<model_name>/final`` (else ``tmp``), as
``cli.train_baseline --checkpointname`` writes it, loaded strictly; every
4-channel PNG of ``--image_dir`` (RGB + IR, /255) through one eval-mode
forward in float32; the class maps coloured with the MFNet palette (class 0
stays black, ids painted up to the largest predicted id) and written beside
each input as ``<name>_pred.png``. PNGs are read and written with
``data/png.py``. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Sequence

import numpy as np
import torch

from ..data.loaders import to_device
from ..data.png import read_png, write_png
from ..device import resolve
from ..io.checkpoint import load_state_dict
from ..models.layers import prepare_for_inference
from .train_baseline import build_model

# util/util.py:30-41: the MFNet 9-class palette
MFNET_PALETTE = [
    [0, 0, 0],        # unlabelled
    [64, 0, 128],     # car
    [64, 64, 0],      # person
    [0, 128, 192],    # bike
    [0, 0, 192],      # curve
    [128, 128, 0],    # car_stop
    [64, 64, 128],    # guardrail
    [192, 128, 128],  # color_cone
    [192, 64, 0],     # bump
]


def visualize(names: Sequence[str], predictions: np.ndarray,
              out_suffix: str = "_pred.png") -> List[str]:
    """Colour each class map and write it beside its input (util/util.py:44-54)."""
    palette = np.asarray(MFNET_PALETTE, np.uint8)
    out_paths = []
    for name, pred in zip(names, predictions):
        img = np.zeros((pred.shape[0], pred.shape[1], 3), np.uint8)
        for cid in range(1, int(predictions.max()) + 1):
            img[pred == cid] = palette[cid % len(palette)]
        out = name.replace(".png", out_suffix)
        write_png(out, img)
        out_paths.append(out)
    return out_paths


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Run MFNet-harness demo")
    p.add_argument("--model_name", "-M", default="MFNet",
                   choices=["MFNet", "RTFNet", "SegNet"])
    p.add_argument("--image_dir", default="image",
                   help="directory of 4-channel pngs (RGB+IR)")
    p.add_argument("--model_dir", default="weights",
                   help="holds <model_name>/{final,tmp} checkpoints")
    p.add_argument("--gpu", "-G", type=int, default=0, help="parity no-op")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    return p


def main(argv=None) -> List[str]:
    args = build_parser().parse_args(argv)
    device = resolve(args.device)
    model = build_model(args.model_name)

    files = sorted(f for f in os.listdir(args.image_dir)
                   if f.endswith(".png") and not f.endswith("_pred.png"))
    if not files:
        raise FileNotFoundError(f"no pngs under {args.image_dir}")
    paths = [os.path.join(args.image_dir, f) for f in files]
    images = np.asarray([read_png(p) for p in paths], np.float32) / 255.0  # NHWC, 4 channels

    model_dir = os.path.join(args.model_dir, args.model_name)
    ckpt = next((os.path.join(model_dir, n) for n in ("final", "tmp")
                 if os.path.exists(os.path.join(model_dir, n))), None)
    if ckpt is None:
        raise FileNotFoundError(f"model file does not exist in {model_dir}")
    model.load_state_dict(load_state_dict(ckpt), strict=True)
    print("| model loaded!")
    prepare_for_inference(model, device, dtype=torch.float32)
    with torch.no_grad():
        preds = model(to_device(images, device)).argmax(dim=-1).cpu().numpy()
    out = visualize(paths, preds)
    print(f"| prediction files have been saved in {args.image_dir}/")
    return out


if __name__ == "__main__":
    main()
