"""Dataset QA: a checkpoint evaluated on a test tree, and label statistics.

Counterpart of ``heatnet_tpu/cli/dataset_qa.py`` (the reference's
``data/validate_{freiburg,mfnet,bdd}_dataset.py`` and
``data/get_dataset_stats.py``):

- ``freiburg``, ``mfnet``, ``bdd``: a ``ResNeXtSeg`` of ``--structure``
  over ``--modalities`` (random weights from seed 0, then the entries of
  ``--checkpoint`` whose names and shapes match, a ``cli.train_conf``
  checkpoint's ``trgb_segnet.`` entries with the prefix stripped), prepared
  for inference, through the port's validators on the tree (frames decoded
  ahead on threads; ``--split`` is the MFNet split, or the Freiburg mode
  tag), the per-class IoUs and their mean printed; ``--save-dir`` dumps
  PNGs. ``bdd`` reads JPEGs, so it needs cv2, as ``BDDValDataset`` does.
- ``stats``: class-pixel histograms of a Freiburg train tree's
  ``*/*/fl_rgb_labels/*.png`` (read with ``data/png.py``) and of test trees'
  ``SegmentationClass/*.npy``; returns the number of pixels counted.

Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
from glob import glob

import numpy as np
import torch

from ..data.loaders import (BDDValDataset, FreiburgThermalTestDataset, MFNetDataset,
                            _imread_grey, get_test_paths, prefetch_items)
from ..data.mappings import CLASS_NAMES as _CLASS_NAMES
from ..device import resolve
from ..eval.validate import validate_model, validate_model_bdd, validate_model_mfnet
from ..io.checkpoint import load_state_dict, restore_partial
from ..models import ResNeXtSeg
from ..models.conf_segnet import num_input_channels
from ..models.layers import init_params, prepare_for_inference
from .eval_hotnet import SEGNET_PREFIX, segnet_state_dict

# the reference's trailing comma of "building," (a wandb key) stripped
CLASS_NAMES_13 = [n.rstrip(",") for n in _CLASS_NAMES[:13]]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="heatnet dataset QA")
    sub = p.add_subparsers(dest="cmd", required=True)

    for name in ("freiburg", "mfnet", "bdd"):
        sp = sub.add_parser(name, help=f"validate a checkpoint on {name}")
        sp.add_argument("--data", required=True,
                        help="dataset root (test layout)")
        sp.add_argument("--checkpoint", default="", type=str)
        sp.add_argument("--modalities", default="ir_rgb")
        sp.add_argument("--split", default="night",
                        help="mfnet: day|night|combined; freiburg mode tag")
        sp.add_argument("--save-dir", default="", type=str)
        sp.add_argument("--structure", nargs=4, type=int,
                        default=[3, 4, 6, 3])
        sp.add_argument("--cert-branch", action="store_true")
        sp.add_argument("--late-fusion", action="store_true")
        sp.add_argument("--device", default=None, help="cuda (the default) or cpu")

    st = sub.add_parser("stats", help="class-pixel histograms")
    st.add_argument("--train-root", default="", type=str,
                    help="Freiburg train tree (*/*/fl_rgb_labels/*.png)")
    st.add_argument("--test-day", default="", type=str,
                    help="test tree with SegmentationClass/*.npy")
    st.add_argument("--test-night", default="", type=str)
    return p


def load_segnet(args: argparse.Namespace, device: torch.device) -> torch.nn.Module:
    """The segnet of the subcommand's flags with ``--checkpoint``'s matching
    entries, prepared for inference on ``device``."""
    model = ResNeXtSeg(structure=tuple(args.structure),
                       input_channels=num_input_channels(args.modalities),
                       cert_branch=args.cert_branch, late_fusion=args.late_fusion)
    init_params(model, torch.Generator().manual_seed(0))
    if args.checkpoint:
        saved = load_state_dict(args.checkpoint)
        restore_partial(model, saved)
        # a conf_segnet checkpoint nests the segnet under trgb_segnet.
        if any(k.startswith(SEGNET_PREFIX) for k in saved):
            restore_partial(model, segnet_state_dict(saved))
    return prepare_for_inference(model, device)


def _print_ious(ious, names) -> float:
    for k, name in enumerate(names[:len(ious)]):
        print(f"IoU {name:35s} {ious[k]:.4f}")
    print(f"mean IoU: {float(np.nanmean(ious)):.4f}")
    return float(np.nanmean(ious))


def main(argv=None) -> float:
    args = build_parser().parse_args(argv)
    if args.cmd == "stats":
        return stats_main(args)

    device = resolve(args.device)
    model = load_segnet(args, device)
    if args.cmd == "freiburg":
        ds = FreiburgThermalTestDataset(*get_test_paths([args.data]))
        ious = validate_model(model, prefetch_items(ds), args.modalities, mode=args.split,
                              save_dir=args.save_dir, device=device)
        return _print_ious(ious, CLASS_NAMES_13)
    if args.cmd == "mfnet":
        ds = MFNetDataset(args.data, split=args.split)
        ious = validate_model_mfnet(model, prefetch_items(ds), args.modalities,
                                    mode=args.split, save_dir=args.save_dir, device=device)
        return _print_ious(ious, ["unlabelled", "car", "person", "bike", "curve"])
    ds = BDDValDataset(args.data)
    ious = validate_model_bdd(model, prefetch_items(ds), save_dir=args.save_dir,
                              device=device)
    return _print_ious(ious, CLASS_NAMES_13)


def stats_main(args: argparse.Namespace) -> float:
    """Class-pixel histograms (get_dataset_stats.py:24-94 print format)."""
    n = len(CLASS_NAMES_13) + 1  # + ignore
    names = CLASS_NAMES_13 + ["ignore"]

    def histo(files, read):
        counts = np.zeros(n, np.int64)
        for f in files:
            counts += np.bincount(read(f).reshape(-1), minlength=n)[:n]
        return counts

    total_checked = 0.0
    if args.train_root:
        files = sorted(glob(os.path.join(args.train_root, "*/*/fl_rgb_labels/*.png")))
        counts = histo(files, lambda f: _imread_grey(f, np.uint8))
        print("\nTRAINING DATASET STATS\n")
        for k in range(n):
            print(k, " - ", names[k], " - ", int(counts[k]))
        total_checked += counts.sum()

    for tag, root in (("DAY", args.test_day), ("NIGHT", args.test_night)):
        if not root:
            continue
        files = sorted(glob(os.path.join(root, "SegmentationClass/*.npy")))
        counts = histo(files, lambda f: np.load(f).astype(np.int64))
        total = max(counts.sum(), 1)
        print(f"\nTESTING DATASET STATS ({tag})\n")
        for k in range(n):
            pct = 100.0 * counts[k] / total
            print(f"{tag:6s} {names[k]:35s} has {int(counts[k]):10d} pixels "
                  f"or {pct:05.2f}% of all {tag} pixels.")
        total_checked += counts.sum()
    return total_checked


if __name__ == "__main__":
    main()
