"""Export a trained model to a self-contained serving artifact.

Counterpart of ``heatnet_tpu/cli/export_model.py``, with the same flags and
defaults but ``--platforms``: checkpoint + model + in-graph normalisation +
argmax become one ``torch.export`` program (``io/export.py``) with a
symbolic batch. A process serves it with ``torch`` and
``heatnet_tpu_torch.ops`` (the registered kernels), without the model code::

    python -m heatnet_tpu_torch.cli.export_model --resume ckpt.pth --out heatnet.pt2
    # serving side:
    import torch, heatnet_tpu_torch.ops
    infer = torch.export.load("heatnet.pt2").module()
    classes = infer(rgb_uint8, ir_uint16)             # any batch size

``--platforms`` names the device the artifact is traced on and serves on:
``cuda`` (the default, the card) or ``cpu``. A program holds its weights
on one device, so one is named; ``tpu`` is refused: the port serves CUDA.

``--resume`` loads a port checkpoint (a ``state_dict`` file or a
``{"epoch", "state_dict"}`` one, as ``cli.inference --resume``); without it
the weights are random from seed 0. ``--quant int8 --calib-data DIR``
converts the model to the int8 serving mode (``ops/quant.py``), calibrates
its activation scales on up to 8 frames of the capture tree ``DIR``
(``fl_rgb/`` + ``fl_ir_aligned/``), one frame at a time as JAX's CLI does
(:163-185), and bakes the quantized weights and scales into the artifact.
Those frames are 320x704 (the eval loaders' window of the 960x320 resize),
so ``--quant int8`` exports at ``--height 320 --width 704``, the default:
JAX resizes calibration frames to another size with ``jax.image.resize``,
which antialiases when it shrinks, and the port does not copy that resize.
At a symbolic batch the int8 layers serve int8 whatever the batch (JAX's
throughput assumption); with ``--fixed-batch`` below 8 they serve bf16.
"""

from __future__ import annotations

import argparse

PLATFORMS = ("cpu", "cuda")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Export serving artifact")
    p.add_argument("--arch", default="resnext50",
                   choices=["resnext50", "resnext101", "resnext152", "pspnet"],
                   help="model family to export (pspnet uses --backend)")
    p.add_argument("--backend", default="resnet50",
                   help="PSPNet extractor backend (--arch pspnet only)")
    p.add_argument("--late-fusion", action="store_true")
    p.add_argument("--structure", nargs=4, type=int, default=None,
                   help="override the ResNeXt stage depths (default: per --arch)")
    p.add_argument("--classes", default=13, type=int)
    p.add_argument("--modalities", default="ir_rgb",
                   help="ir_rgb | rgb | ir (input surface of the artifact)")
    p.add_argument("--height", default=320, type=int)
    p.add_argument("--width", default=704, type=int)
    p.add_argument("--resume", default="", help="port checkpoint to embed "
                   "(omitted: random init, for pipeline tests)")
    p.add_argument("--out", required=True, help="artifact path (.pt2)")
    p.add_argument("--platforms", nargs="+", default=["cuda"],
                   help="the device to export for and serve on: cuda or cpu")
    p.add_argument("--raw-inputs", action="store_true", default=True,
                   help="consume uint8 RGB / uint16 IR and normalize in-graph (default)")
    p.add_argument("--f32-inputs", dest="raw_inputs", action="store_false",
                   help="consume pre-normalized float32 instead")
    p.add_argument("--logits", action="store_true",
                   help="emit logits instead of the argmax class map")
    p.add_argument("--fixed-batch", default=0, type=int,
                   help=">0: fix the batch dimension instead of symbolic. A symbolic "
                        "batch counts as batch >= 8 (the throughput regime) in the "
                        "int8 layers' dispatch; fix it here to serve small batches "
                        "in bf16")
    p.add_argument("--quant", default="none", choices=["none", "int8"],
                   help="int8: bake the int8 serving mode into the artifact "
                        "(requires --calib-data for the activation scales)")
    p.add_argument("--calib-data", default="",
                   help="Freiburg-layout inference dir (fl_rgb/ + fl_ir_aligned/) "
                        "used to calibrate int8 activation scales")
    return p


def main(argv=None) -> str:
    import torch

    from ..data.loaders import FreiburgInferDataset, to_device
    from ..device import resolve
    from ..eval.validate import modality_keys, normalize_frames
    from ..io.checkpoint import load_state_dict
    from ..io.export import export_inference, exported_info, save_exported
    from ..models import ResNeXtSeg, build_network
    from ..models.layers import init_params, prepare_for_inference
    from ..ops.quant import calibrate_int8, convert_int8

    args = build_parser().parse_args(argv)
    for p in args.platforms:
        if p not in PLATFORMS:
            raise SystemExit(f"platform {p!r}: the port serves CUDA (--platforms cuda, "
                             "or cpu); a TPU artifact comes from heatnet_tpu's exporter")
    if len(args.platforms) != 1:
        raise SystemExit("a torch.export artifact holds its weights on one device: "
                         f"name one of {PLATFORMS} in --platforms")
    if args.quant == "int8" and not args.calib_data:
        raise SystemExit("--quant int8 requires --calib-data (frames to "
                         "calibrate activation scales on)")
    device = resolve(args.platforms[0])

    keys = modality_keys(args.modalities)
    n_in = sum(3 if k == "rgb" else 1 for k in keys)
    if args.arch == "pspnet":
        model = build_network(backend=args.backend, n_classes=args.classes,
                              in_channels=n_in, late_fusion=args.late_fusion)
    else:
        structure = tuple(args.structure) if args.structure else {
            "resnext50": (3, 4, 6, 3),
            "resnext101": (3, 4, 23, 3),
            "resnext152": (3, 8, 36, 3),
        }[args.arch]
        model = ResNeXtSeg(structure=structure, classes=args.classes,
                           input_channels=n_in, late_fusion=args.late_fusion)
    init_params(model, torch.Generator().manual_seed(0))
    if args.resume:
        model.load_state_dict(load_state_dict(args.resume))
    if args.quant == "int8":
        convert_int8(model)
    model = prepare_for_inference(model, device)

    if args.quant == "int8":
        ds = FreiburgInferDataset(args.calib_data)
        if len(ds) == 0:
            raise FileNotFoundError(f"no frames under {args.calib_data}")
        hw = ds[0]["rgb"].shape[1:3]
        if tuple(hw) != (args.height, args.width):
            raise SystemExit(f"--quant int8 calibrates on the capture tree's "
                             f"{hw[0]}x{hw[1]} frames, so it exports at that size, not "
                             f"{args.height}x{args.width}: JAX resizes them with "
                             "jax.image.resize, which the port does not copy")
        late = getattr(model, "late_fusion", False)

        def calib_batches():
            for i in range(min(len(ds), 8)):
                item = ds[i]
                yield normalize_frames([to_device(item[k], device) for k in keys],
                                       model.compute_dtype, late)

        calibrate_int8(model, calib_batches())

    b = max(args.fixed_batch, 1)
    shapes, dtypes = [], []
    if "rgb" in keys:
        shapes.append((b, args.height, args.width, 3))
        dtypes.append(torch.uint8 if args.raw_inputs else torch.float32)
    if "ir" in keys:
        shapes.append((b, args.height, args.width, 1))
        dtypes.append(torch.uint16 if args.raw_inputs else torch.float32)

    artifact = export_inference(model, shapes, dtypes,
                                symbolic_batch=args.fixed_batch == 0,
                                normalize=args.raw_inputs, argmax=not args.logits)
    save_exported(args.out, artifact)
    info = exported_info(args.out)
    print(f"exported {args.out}: {info['in_avals']} -> {info['out_avals']} "
          f"platforms={info['platforms']} ({info['bytes'] / 1e6:.1f} MB)")
    return args.out


if __name__ == "__main__":
    main()
