"""Vistas dataset builder: the ``generate_vista_dataset.py`` surface.

Counterpart of ``heatnet_tpu/cli/generate_vistas.py`` (reference
``data/datasets/generate_vista_dataset.py:32-69``): each Mapillary Vistas
image is resized to ``--width`` (1024, aspect kept; linear for the image,
nearest for the labels), its 66-class panoptic label relabelled to the
13-class HeatNet space (``data/mappings.py::relabel_vistas_image``), and
``images/``, ``labels/`` (uint16 ``class * 256 + instance``) and
``paths.txt`` written: the tree ``cli/main.py`` trains on.

PNGs are read and written with ``data/png.py`` and resized with
``data/loaders.py::resize`` (copies of cv2's calls), so the port needs
neither cv2 nor PIL for PNG inputs. Vistas' own JPEG images go through PIL
where it imports; a JPEG decoder may differ from cv2's by a level.
``--use_native`` (the default) relabels with the native C++ relabeller
(``native.relabel_vistas_image_native``, built with ``g++`` on first use);
where it cannot build, the CLI says so and the numpy relabeller serves, as
in JAX. ``--no_native`` takes the numpy relabeller.

Usage::

    python -m heatnet_tpu_torch.cli.generate_vistas --vistas_root VISTAS --out TREE
"""

from __future__ import annotations

import argparse
import os
from glob import glob

import numpy as np

from ..data.loaders import _read_rgb_any, resize
from ..data.mappings import CLASS_NAMES, VISTAS_TO_HEATNET, relabel_vistas_image
from ..data.png import read_png, write_png


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument('--print_labels', action='store_true',
                   help='print the class ids + Vistas→IROS mapping '
                        '(print_label_names.py surface) and exit')
    p.add_argument('--vistas_root', required=False, default='',
                   help='Mapillary Vistas root (training/images + v1.2/instances)')
    p.add_argument('--out', required=False, default='',
                   help='output dataset directory')
    p.add_argument('--width', type=int, default=1024)
    p.add_argument('--limit', type=int, default=None)
    p.add_argument('--use_native', action='store_true', default=True,
                   help='use the C++ relabeller (falls back to numpy)')
    p.add_argument('--no_native', dest='use_native', action='store_false')
    return p


def print_labels() -> None:
    """Class ids + Vistas→IROS mapping (print_label_names.py:1-23)."""
    for i, name in enumerate(CLASS_NAMES):
        print('ID: %i: %s' % (i, name))
    print('################ Mapping ############################')
    for i, name in enumerate(CLASS_NAMES):
        srcs = sorted(k for k, v in VISTAS_TO_HEATNET.items() if v == i)
        print('Map: %s -> vistas ids %s' % (name, srcs))


def _label_file(root: str, stem: str):
    for cand in ("v1.2/instances", "training/instances"):
        path = os.path.join(root, cand, stem + ".png")
        if os.path.isfile(path):
            return path
    return None


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.print_labels:
        print_labels()
        return 0
    if not args.vistas_root or not args.out:
        raise SystemExit("--vistas_root and --out are required")
    relabel = relabel_vistas_image
    if args.use_native:
        try:
            from ..native import bindings

            bindings.get_lib()
            relabel = bindings.relabel_vistas_image_native
        except Exception as e:  # native build unavailable → python fallback
            print(f"native relabeller unavailable ({e}); using python path")

    img_files = sorted(glob(os.path.join(args.vistas_root, "training/images/*.jpg")))
    img_files += sorted(glob(os.path.join(args.vistas_root, "training/images/*.png")))
    if args.limit:
        img_files = img_files[:args.limit]

    os.makedirs(os.path.join(args.out, "images"), exist_ok=True)
    os.makedirs(os.path.join(args.out, "labels"), exist_ok=True)
    names = []
    for i, img_file in enumerate(img_files):
        stem = os.path.splitext(os.path.basename(img_file))[0]
        label_file = _label_file(args.vistas_root, stem)
        if label_file is None:
            continue
        img = _read_rgb_any(img_file)
        inst = read_png(label_file).astype(np.uint16)

        h, w = img.shape[:2]
        new_h = int(round(h * args.width / w))
        img = resize(img, (args.width, new_h))
        inst = resize(inst, (args.width, new_h), nearest=True)

        write_png(os.path.join(args.out, "images", stem + ".png"), img)
        write_png(os.path.join(args.out, "labels", stem + ".png"),
                  relabel(inst, VISTAS_TO_HEATNET))
        names.append(stem)
        if i % 100 == 0:
            print(f"{i}/{len(img_files)} processed")

    with open(os.path.join(args.out, "paths.txt"), "w") as f:
        f.write("\n".join(names))
    print(f"wrote {len(names)} pairs to {args.out}")
    return len(names)


if __name__ == "__main__":
    main()
