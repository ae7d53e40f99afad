"""Convert a reference PyTorch ``.pth`` checkpoint into a port checkpoint.

Counterpart of ``heatnet_tpu/cli/convert_checkpoint.py``, with the same
flags. The reference saves ``torch.save({'state_dict': …})`` bundles
(scripts/main.py:321-324, train_trgb_segnet_conf.py:112-116) under its own
module names and restores them with prefix rewrites (``initModelRenamed``,
utils.py:59-78). This CLI renames the keys (``io/torch_import.py``), rewrites
the prefix (``--to-rename`` → ``--rename``, then ``--prepend``), keeps the
entries whose name and shape match the target architecture, and writes a
``{"epoch": 0, "state_dict": …}`` file that every port CLI's ``--resume``
loads (the JAX CLI writes an orbax directory). A checkpoint that matches no
entry of the target raises instead of writing random weights.

    python -m heatnet_tpu_torch.cli.convert_checkpoint \\
        --torch-checkpoint ref_best.pth.tar \\
        --to-rename module.trgb_segnet. --rename "" --out converted.pth
"""

from __future__ import annotations

import argparse

from ..io.checkpoint import restore_partial, save_checkpoint
from ..io.torch_import import convert_state_dict, load_torch_checkpoint
from ..models import ResNeXtSeg, build_network


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="reference torch .pth -> port checkpoint")
    p.add_argument("--torch-checkpoint", required=True, help=".pth/.pth.tar")
    p.add_argument("--out", required=True, help="port checkpoint file (.pth)")
    p.add_argument("--arch", default="resnext", choices=["resnext", "pspnet"])
    p.add_argument("--structure", nargs=4, type=int, default=[3, 4, 6, 3])
    p.add_argument("--backend", default="resnet50", help="pspnet extractor backend")
    p.add_argument("--classes", default=13, type=int)
    p.add_argument("--modalities", default="ir_rgb")
    p.add_argument("--late-fusion", action="store_true")
    p.add_argument("--cert-branch", action="store_true")
    p.add_argument("--input-3x3", action="store_true", default=True)
    p.add_argument("--vistas-stem", dest="input_3x3", action="store_false",
                   help="7x7 stem (Vistas segnet variant)")
    p.add_argument("--to-rename", default="",
                   help="prefix to rewrite (initModelRenamed), e.g. "
                        "'module.trgb_segnet.'")
    p.add_argument("--rename", default="", help="replacement prefix")
    p.add_argument("--prepend", default="",
                   help="prefix to PREPEND to every converted key: a bare "
                        "torchvision resnet state_dict lands under the extractor "
                        "with --prepend feats. (extractors.py:369-408)")
    return p


def main(argv=None) -> str:
    args = build_parser().parse_args(argv)
    n_in = ((3 if "rgb" in args.modalities else 0)
            + (1 if "ir" in args.modalities else 0))
    if args.arch == "pspnet":
        model = build_network(backend=args.backend, n_classes=args.classes,
                              in_channels=n_in, late_fusion=args.late_fusion)
    else:
        model = ResNeXtSeg(structure=tuple(args.structure), classes=args.classes,
                           input_channels=n_in, late_fusion=args.late_fusion,
                           cert_branch=args.cert_branch, input_3x3=args.input_3x3)

    sd = convert_state_dict(load_torch_checkpoint(args.torch_checkpoint))
    if args.to_rename:
        sd = {k.replace(args.to_rename, args.rename): v for k, v in sd.items()}
    sd = {args.prepend + k: v for k, v in sd.items()}
    n = restore_partial(model, sd, verbose=False)
    print(f"Loaded dict with {n} entries...")
    if n == 0:
        raise SystemExit(f"{args.torch_checkpoint}: no entry matches the target "
                         "(check --to-rename / --prepend and the architecture flags)")
    save_checkpoint({"epoch": 0, "state_dict": model.state_dict()}, args.out)
    print(f"converted {args.torch_checkpoint} -> {args.out}")
    return args.out


if __name__ == "__main__":
    main()
