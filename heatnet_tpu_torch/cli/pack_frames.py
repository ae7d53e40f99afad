"""Pack a capture or training directory into the raw-frame formats.

Counterpart of ``heatnet_tpu/cli/pack_frames.py``, with the same flags and
defaults. Packing is host work (PNG decode and resize, numpy only, no cv2),
so it takes no ``--device``::

    # inference pack (fl_rgb/ + fl_ir_aligned/ tree)
    python -m heatnet_tpu_torch.cli.pack_frames --data DIR --out PACK_DIR

    # training pack (Freiburg */*/fl_ir_aligned tree, day + night split)
    python -m heatnet_tpu_torch.cli.pack_frames --data ROOT --out PACK_DIR --train \\
        [--testroot_day D --testroot_night N]   # bake test-stamp filtering

``PACK_DIR`` then serves through ``cli.inference --data PACK_DIR`` or trains
through ``cli.train_plain`` / ``train_conf`` / ``train_uncertainty
--dataroot PACK_DIR`` (the trainers tell a train pack from a PNG tree) with
no decode per frame. The packs are the JAX package's format: either
package's readers open either package's packs.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data", required=True,
                   help="capture dir (fl_rgb/ + fl_ir_aligned/) or, with "
                        "--train, a Freiburg train root")
    p.add_argument("--out", required=True, help="pack output directory")
    p.add_argument("--train", action="store_true",
                   help="pack a Freiburg Thermal TRAIN tree (day+night)")
    p.add_argument("--split", default="train", choices=["train", "test"],
                   help="holdout side to pack (--train only)")
    p.add_argument("--testroot_day", default="", type=str,
                   help="labeled test dir; its stamps are excluded from "
                        "the pack (--train only, matches the conf trainer)")
    p.add_argument("--testroot_night", default="", type=str)
    p.add_argument("--quiet", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.train:
        from ..data.loaders import get_test_paths, get_test_stamps
        from ..data.packed import pack_freiburg_train

        roots = [r for r in (args.testroot_night, args.testroot_day) if r]
        stamps = get_test_stamps(get_test_paths(roots)[2]) if roots else None
        n_day, n_night = pack_freiburg_train(
            args.data, args.out, split=args.split, test_stamps=stamps,
            verbose=not args.quiet)
        print(f"packed {n_day} day + {n_night} night frames -> {args.out}")
        return n_day

    from ..data.packed import pack_inference_dir

    n = pack_inference_dir(args.data, args.out, verbose=not args.quiet)
    print(f"packed {n} frames -> {args.out}")
    return n


if __name__ == "__main__":
    main()
