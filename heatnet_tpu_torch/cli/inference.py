"""RGB+thermal directory inference with forward-pass timing.

Counterpart of ``heatnet_tpu/cli/inference.py:141-241`` for a heatnet-pack-v1
directory (``data/packed.py``), which serves frames with no decode step. It
prints the same ``Network took %f seconds`` (one frame, averaged over
``--iters``) and ``Ran inference on N frames`` lines.

``--arch`` is ``resnext50``, ``resnext101`` or ``resnext152`` (the registry's
``net_<arch>``, ``heatnet_tpu/cli/inference.py:161-162``). Weights are
random from seed 0 unless ``--resume`` names a PyTorch
``state_dict`` file or a ``{"epoch", "state_dict"}`` checkpoint of
``cli/train_plain.py`` (``io/from_jax.py`` converts JAX trees). Runs on the card
unless ``--device cpu``. Not ported yet: orbax checkpoints, PNG capture trees
(their loader needs cv2), ``--borders-data``, ``--im-save-dir`` and ``--quant``.

Usage::

    python -m heatnet_tpu_torch.cli.inference --data PACK_DIR --batch 8
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

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
                   help="heatnet-pack-v1 directory (meta.json, rgb.npy, ir.npy)")
    p.add_argument("--modalities", default="ir_rgb")
    p.add_argument("--iters", default=10, type=int, help="timing iterations")
    p.add_argument("--batch", default=0, type=int,
                   help="serve the directory in batches of this many frames, "
                        "the ragged tail padded; 0 = one frame at a time")
    p.add_argument("--classes", default=13, type=int)
    p.add_argument("--structure", nargs=4, type=int, default=[3, 4, 6, 3])
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    return p


@dataclasses.dataclass
class InferenceRun:
    network_seconds: float  # one frame's forward, averaged over --iters
    maps: np.ndarray        # (n, H, W) uint8 class maps of the directory


def main(argv=None) -> InferenceRun:
    args = build_parser().parse_args(argv)
    device = resolve(args.device)
    if not is_pack_dir(args.data):
        raise SystemExit(f"{args.data} is not a heatnet-pack-v1 directory "
                         "(PNG capture trees are not served by the port yet)")
    ds = PackedFrameDataset(args.data)
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

    first = {k: ds[0][k] for k in modality_keys(args.modalities)}
    predict(model, first, args.modalities, device)  # warm-up
    sync()
    t0 = time.perf_counter()
    for _ in range(args.iters):
        predict(model, first, args.modalities, device)
    sync()
    dt = (time.perf_counter() - t0) / max(args.iters, 1)
    print("Network took %f seconds" % dt)

    maps = inference(model, (ds[i] for i in range(len(ds))),
                     batch_size=max(args.batch, 1), device=device,
                     modalities=args.modalities)
    print(f"Ran inference on {len(maps)} frames")
    return InferenceRun(dt, maps)


if __name__ == "__main__":
    main()
