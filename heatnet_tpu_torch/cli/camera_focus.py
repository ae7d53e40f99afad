"""Camera focus helper: frequency-domain entropy per frame.

Counterpart of ``heatnet_tpu/cli/camera_focus.py`` (reference
``ros_src/camera_focus/kalibr_camera_focus:1-63``): prints the
frequency-domain entropy (FDE, Kristan & Pernuš "Entropy Based Measure of
Camera Focus") of each frame: minimize it while turning the lens. The ROS
subscription becomes a file/directory CLI (or library use via
:func:`frequency_domain_entropy` on live frames).

Frames decode with ``data/loaders.py::imread_grayscale``, the copy of
``cv2.imread(path, IMREAD_GRAYSCALE)`` for PNGs; a JPEG frame raises (the
port has no JPEG decoder).

Usage::

    python -m heatnet_tpu_torch.cli.camera_focus --images DIR_OR_FILES...
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..data.loaders import imread_grayscale


def frequency_domain_entropy(gray: np.ndarray) -> float:
    """FDE of a grayscale frame (kalibr_camera_focus:29-39 math).

    ``sum(p * log(p))`` over the normalized FFT magnitude spectrum —
    NEGATIVE entropy, so sharper focus → more spread spectrum → the value
    to MINIMIZE, exactly as the reference prints it.
    """
    img = np.asarray(gray, np.float64)
    if img.ndim == 3:
        img = img.mean(axis=-1)
    spectrum = np.abs(np.fft.fftshift(np.fft.fft2(img)))
    total = spectrum.sum()
    if total == 0:
        return 0.0
    p = spectrum / total
    with np.errstate(divide="ignore", invalid="ignore"):
        logp = np.where(p > 0, np.log(p), 0.0)
    return float(np.sum(p * logp))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Validate camera focus (minimize the printed FDE)")
    p.add_argument("--images", nargs="+", required=True,
                   help="image files or directories of frames")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    files = []
    for path in args.images:
        if os.path.isdir(path):
            files.extend(sorted(
                os.path.join(path, f) for f in os.listdir(path)
                if f.lower().endswith((".png", ".jpg", ".jpeg"))))
        else:
            files.append(path)
    if not files:
        raise FileNotFoundError("no frames found")

    results = {}
    for f in files:
        fde = frequency_domain_entropy(imread_grayscale(f))
        results[f] = fde
        print(f"fde: {fde}   (minimize this for focus)  [{f}]")
    return results


if __name__ == "__main__":
    main()
