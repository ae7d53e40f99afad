"""Drive-dump IR/RGB overlay renderer — the annotation viewer, headless.

Counterpart of ``heatnet_tpu/cli/visualize_data.py`` (reference
``data/visualize_data.py:11-214``, ``IrVisualizer``, a Tkinter app that pages
through a raw drive dump, renders the aligned IR frame with an adjustable
radiometric window as a JET overlay on the RGB frame, and saves
``<stamp>_{ir,rgb,overlay}.png`` triples for annotation): it renders the
same triples for every (or a range of) burst(s) in one pass, with the IR
window and blend weight as flags instead of sliders. The overlay math is
the viewer's (:154-203: clamp → [0,1] → JET colormap → ``cv2.addWeighted``),
in numpy: ``apply_jet`` looks up cv2's 256-entry ``COLORMAP_JET`` table
and ``add_weighted`` is cv2's uint8 blend, ``fma(a, alpha, fma(b, beta,
gamma))`` in float32, rounded half to even. The triples are written with
``data/png.py`` (BGR arrays stored as cv2 stores them).

Usage::

    python -m heatnet_tpu_torch.cli.visualize_data -s DUMP --save-dir OUT
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..data.loaders import ThermalDriveDataset, _fma32, swap_rb
from ..data.png import write_png

# cv2.applyColorMap(range(256), COLORMAP_JET)'s BGR bytes
_JET = np.frombuffer(bytes.fromhex(
    "8000008400008800008c00009000009400009800009c0000a00000a40000a80000ac0000"
    "b00000b40000b80000bc0000c00000c40000c80000cc0000d00000d40000d80000dc0000"
    "e00000e40000e80000ec0000f00000f40000f80000fc0000ff0000ff0400ff0800ff0c00"
    "ff1000ff1400ff1800ff1c00ff2000ff2400ff2800ff2c00ff3000ff3400ff3800ff3c00"
    "ff4000ff4400ff4800ff4c00ff5000ff5400ff5800ff5c00ff6000ff6400ff6800ff6c00"
    "ff7000ff7400ff7800ff7c00ff8000ff8400ff8800ff8c00ff9000ff9400ff9800ff9c00"
    "ffa000ffa400ffa800ffac00ffb000ffb400ffb800ffbc00ffc000ffc400ffc800ffcc00"
    "ffd000ffd400ffd800ffdc00ffe000ffe400ffe800ffec00fff000fff400fff800fffc00"
    "feff02faff06f6ff0af2ff0eeeff12eaff16e6ff1ae2ff1edeff22daff26d6ff2ad2ff2e"
    "ceff32caff36c6ff3ac2ff3ebeff42baff46b6ff4ab2ff4eaeff52aaff56a6ff5aa2ff5e"
    "9eff629aff6696ff6a92ff6e8eff728aff7686ff7a82ff7e7eff827aff8676ff8a72ff8e"
    "6eff926aff9666ff9a62ff9e5effa25affa656ffaa52ffae4effb24affb646ffba42ffbe"
    "3effc23affc636ffca32ffce2effd22affd626ffda22ffde1effe21affe616ffea12ffee"
    "0efff20afff606fffa01fffe00fcff00f8ff00f4ff00f0ff00ecff00e8ff00e4ff00e0ff"
    "00dcff00d8ff00d4ff00d0ff00ccff00c8ff00c4ff00c0ff00bcff00b8ff00b4ff00b0ff"
    "00acff00a8ff00a4ff00a0ff009cff0098ff0094ff0090ff008cff0088ff0084ff0080ff"
    "007cff0078ff0074ff0070ff006cff0068ff0064ff0060ff005cff0058ff0054ff0050ff"
    "004cff0048ff0044ff0040ff003cff0038ff0034ff0030ff002cff0028ff0024ff0020ff"
    "001cff0018ff0014ff0010ff000cff0008ff0004ff0000ff0000fc0000f80000f40000f0"
    "0000ec0000e80000e40000e00000dc0000d80000d40000d00000cc0000c80000c40000c0"
    "0000bc0000b80000b40000b00000ac0000a80000a40000a000009c000098000094000090"
    "00008c000088000084000080"), np.uint8).reshape(256, 3)


def apply_jet(im: np.ndarray) -> np.ndarray:
    """``cv2.applyColorMap(im, COLORMAP_JET)`` of uint8 (H, W): BGR uint8."""
    return _JET[np.asarray(im, np.uint8)]


def add_weighted(a: np.ndarray, alpha: float, b: np.ndarray, beta: float,
                 gamma: float = 0.0) -> np.ndarray:
    """``cv2.addWeighted(a, alpha, b, beta, gamma)`` of uint8 arrays."""
    al, be, ga = np.float32(alpha), np.float32(beta), np.float32(gamma)
    s = _fma32(np.asarray(a, np.float32), al,
               _fma32(np.asarray(b, np.float32), be, ga))
    return np.clip(np.rint(s), 0, 255).astype(np.uint8)


def normalize_ir(ir, ir_min: float, ir_max: float):
    """16-bit IR → JET-colormapped BGR uint8 (visualize_data.py:192-203)."""
    im = (ir.astype("float32") - ir_min) / (ir_max - ir_min)
    im = (im.clip(0, 1) * 255).astype("uint8")
    return apply_jet(im)


def build_overlay(rgb_bgr, ir, ir_min: float, ir_max: float,
                  alpha: float = 0.7):
    """RGB/IR blend exactly as the viewer's build_overlay (:154-172)."""
    ir_cv = normalize_ir(ir, ir_min, ir_max)
    return add_weighted(rgb_bgr.astype("uint8"), alpha, ir_cv, 1.0 - alpha, 0.0)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Render IR/RGB overlay triples from a raw drive dump")
    p.add_argument("-s", "--src", required=True,
                   help="drive dump root (holds *_drive_*.txt path lists)")
    p.add_argument("--save-dir", required=True)
    p.add_argument("--ir-min", type=float, default=21800.0)
    p.add_argument("--ir-max", type=float, default=25000.0)
    p.add_argument("--alpha", type=float, default=0.7,
                   help="RGB weight in the blend (slider default :154)")
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--limit", type=int, default=None,
                   help="max bursts to render")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    ds = ThermalDriveDataset(args.src, load_aligned_ir=True, load_right=False)
    os.makedirs(args.save_dir, exist_ok=True)

    end = len(ds) if args.limit is None else min(len(ds), args.start + args.limit)
    n = 0
    for idx in range(args.start, end):
        item = ds[idx]
        if not item["ir_fl"]:
            continue
        name = os.path.splitext(os.path.basename(item["paths_left"][0]))[0]
        rgb_bgr = item["org_left"]  # BGR uint8, as the viewer keeps it
        ir = item["ir_fl"][0][..., 0]
        overlay = build_overlay(rgb_bgr, ir, args.ir_min, args.ir_max, args.alpha)
        # cv2.imwrite(ir.astype("uint16")): IR counts are integers in float32
        write_png(os.path.join(args.save_dir, f"{name}_ir.png"), ir.astype("uint16"))
        write_png(os.path.join(args.save_dir, f"{name}_rgb.png"), swap_rb(rgb_bgr))
        write_png(os.path.join(args.save_dir, f"{name}_overlay.png"), swap_rb(overlay))
        n += 1
    print(f"Rendered {n} overlay triples into {args.save_dir}")
    return n


if __name__ == "__main__":
    main()
