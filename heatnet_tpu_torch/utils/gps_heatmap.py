"""GPS track heatmaps and UTM conversion, with numpy alone.

Counterpart of ``heatnet_tpu/utils/gps_heatmap.py``, which rebuilds the
reference's GPS side of the capture stack without the ``utm``/``gmplot``
packages:

- UTM ↔ WGS84 lat/lon (``utm.from_latlon``/``to_latlon`` replacement, the
  classic Krüger series; bag_parser.py:306 converts odometry+origin to
  lat/lon on zone 32U), copied;
- ``save_heat_stats``: the ``"lat lon\\n"`` text format of
  bag_parser.py:562-565 (``saveHeatStats``), copied;
- ``collect_heat_stats``: the recursive ``heat_stats_*`` harvest of
  plot_gm.py:17-36, copied;
- ``write_heatmap_html``: the ``gmplot.heatmap(...).draw(...)`` stand-in
  (plot_gm.py:38-41, bag_parser.py:551-555), a self-contained HTML file
  holding a PNG of the gaussian-splatted density raster over the track's
  bounding box. The JAX copy draws it with matplotlib (``imshow`` with
  the ``hot`` colormap, the track scattered in cyan, lat/lon axes). Here
  the same raster goes through ``hot``'s 256 entries (copied as numbers),
  the track points are drawn as pixels and the PNG is written with
  ``data/png.py``: the picture has no axes, by design.
"""

from __future__ import annotations

import base64
import fnmatch
import math
import os
from typing import List, Sequence, Tuple

import numpy as np

from ..data.png import encode_png

# WGS84
_A = 6378137.0
_F = 1 / 298.257223563
_E2 = _F * (2 - _F)              # first eccentricity squared
_EP2 = _E2 / (1 - _E2)           # second eccentricity squared
_K0 = 0.9996

_ZONE_LETTERS = "CDEFGHJKLMNPQRSTUVWXX"


def latlon_to_utm(lat: float, lon: float
                  ) -> Tuple[float, float, int, str]:
    """(easting, northing, zone_number, zone_letter) — utm.from_latlon."""
    if not -80.0 <= lat <= 84.0:
        raise ValueError("latitude out of UTM range")
    lat_r = math.radians(lat)
    zone = int((lon + 180) / 6) + 1
    # Norway/Svalbard exceptions (match the utm package)
    if 56 <= lat < 64 and 3 <= lon < 12:
        zone = 32
    if 72 <= lat <= 84 and lon >= 0:
        if lon < 9:
            zone = 31
        elif lon < 21:
            zone = 33
        elif lon < 33:
            zone = 35
        elif lon < 42:
            zone = 37
    letter = _ZONE_LETTERS[int((lat + 80) / 8)]

    lon0 = math.radians((zone - 1) * 6 - 180 + 3)
    n = _A / math.sqrt(1 - _E2 * math.sin(lat_r) ** 2)
    t = math.tan(lat_r) ** 2
    c = _EP2 * math.cos(lat_r) ** 2
    a = math.cos(lat_r) * (math.radians(lon) - lon0)

    m = _A * ((1 - _E2 / 4 - 3 * _E2 ** 2 / 64 - 5 * _E2 ** 3 / 256) * lat_r
              - (3 * _E2 / 8 + 3 * _E2 ** 2 / 32
                 + 45 * _E2 ** 3 / 1024) * math.sin(2 * lat_r)
              + (15 * _E2 ** 2 / 256
                 + 45 * _E2 ** 3 / 1024) * math.sin(4 * lat_r)
              - (35 * _E2 ** 3 / 3072) * math.sin(6 * lat_r))

    easting = _K0 * n * (a + (1 - t + c) * a ** 3 / 6
                         + (5 - 18 * t + t ** 2 + 72 * c - 58 * _EP2)
                         * a ** 5 / 120) + 500000.0
    northing = _K0 * (m + n * math.tan(lat_r)
                      * (a ** 2 / 2
                         + (5 - t + 9 * c + 4 * c ** 2) * a ** 4 / 24
                         + (61 - 58 * t + t ** 2 + 600 * c - 330 * _EP2)
                         * a ** 6 / 720))
    if lat < 0:
        northing += 10000000.0
    return easting, northing, zone, letter


def utm_to_latlon(easting: float, northing: float, zone_number: int,
                  zone_letter: str = "U") -> Tuple[float, float]:
    """(lat, lon) — utm.to_latlon replacement (bag_parser.py:441)."""
    northern = zone_letter.upper() >= "N"
    x = easting - 500000.0
    y = northing if northern else northing - 10000000.0

    m = y / _K0
    mu = m / (_A * (1 - _E2 / 4 - 3 * _E2 ** 2 / 64 - 5 * _E2 ** 3 / 256))
    e1 = (1 - math.sqrt(1 - _E2)) / (1 + math.sqrt(1 - _E2))
    phi1 = (mu
            + (3 * e1 / 2 - 27 * e1 ** 3 / 32) * math.sin(2 * mu)
            + (21 * e1 ** 2 / 16 - 55 * e1 ** 4 / 32) * math.sin(4 * mu)
            + (151 * e1 ** 3 / 96) * math.sin(6 * mu)
            + (1097 * e1 ** 4 / 512) * math.sin(8 * mu))

    sin1, cos1, tan1 = math.sin(phi1), math.cos(phi1), math.tan(phi1)
    c1 = _EP2 * cos1 ** 2
    t1 = tan1 ** 2
    n1 = _A / math.sqrt(1 - _E2 * sin1 ** 2)
    r1 = _A * (1 - _E2) / (1 - _E2 * sin1 ** 2) ** 1.5
    d = x / (n1 * _K0)

    lat = phi1 - (n1 * tan1 / r1) * (
        d ** 2 / 2
        - (5 + 3 * t1 + 10 * c1 - 4 * c1 ** 2 - 9 * _EP2) * d ** 4 / 24
        + (61 + 90 * t1 + 298 * c1 + 45 * t1 ** 2 - 252 * _EP2
           - 3 * c1 ** 2) * d ** 6 / 720)
    lon = (d - (1 + 2 * t1 + c1) * d ** 3 / 6
           + (5 - 2 * c1 + 28 * t1 - 3 * c1 ** 2 + 8 * _EP2
              + 24 * t1 ** 2) * d ** 5 / 120) / cos1
    lon0 = math.radians((zone_number - 1) * 6 - 180 + 3)
    return math.degrees(lat), math.degrees(lon) + math.degrees(lon0)


# ---------------------------------------------------------------------------
# heat_stats files (bag_parser.saveHeatStats / plot_gm.py harvest)
# ---------------------------------------------------------------------------


def save_heat_stats(lat: Sequence[float], lon: Sequence[float],
                    filename: str) -> None:
    """Append "lat lon" lines (bag_parser.py:562-565 format, space-sep)."""
    with open(filename, "a") as f:
        for la, lo in zip(lat, lon):
            f.write(f"{la} {lo}\n")


def collect_heat_stats(core_dir: str, pattern: str = "heat_stats_*"
                       ) -> Tuple[List[float], List[float]]:
    """Recursively read every heat_stats_* file (plot_gm.py:17-36)."""
    lats: List[float] = []
    lons: List[float] = []
    for root, _dirs, filenames in os.walk(core_dir):
        for filename in fnmatch.filter(filenames, pattern):
            with open(os.path.join(root, filename)) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    la, lo = line.split(" ")
                    lats.append(float(la))
                    lons.append(float(lo))
    return lats, lons


def _density_raster(lats: np.ndarray, lons: np.ndarray, bins: int = 256,
                    sigma_px: float = 4.0):
    """Gaussian-splatted 2D density over the padded bounding box."""
    pad_lat = max((lats.max() - lats.min()) * 0.1, 1e-4)
    pad_lon = max((lons.max() - lons.min()) * 0.1, 1e-4)
    extent = (lons.min() - pad_lon, lons.max() + pad_lon,
              lats.min() - pad_lat, lats.max() + pad_lat)
    hist, _, _ = np.histogram2d(
        lats, lons, bins=bins,
        range=[[extent[2], extent[3]], [extent[0], extent[1]]])
    # separable gaussian blur (no scipy needed)
    r = int(3 * sigma_px)
    k = np.exp(-0.5 * (np.arange(-r, r + 1) / sigma_px) ** 2)
    k /= k.sum()
    blurred = np.apply_along_axis(
        lambda row: np.convolve(row, k, mode="same"), 1, hist)
    blurred = np.apply_along_axis(
        lambda col: np.convolve(col, k, mode="same"), 0, blurred)
    return blurred, extent


# matplotlib's ``hot`` colormap, ``colormaps["hot"](range(256), bytes=True)``'s
# RGB bytes
_HOT = np.frombuffer(bytes.fromhex(
    "0a00000d00000f00001200001500001700001a00001c00001f0000220000240000270000"
    "2a00002c00002f00003100003400003700003900003c00003f0000410000440000460000"
    "4900004c00004e00005100005400005600005900005b00005e0000610000630000660000"
    "6900006b00006e00007000007300007600007800007b00007e0000800000830000850000"
    "8800008b00008d00009000009300009500009800009a00009d0000a00000a20000a50000"
    "a80000aa0000ad0000af0000b20000b50000b70000ba0000bd0000bf0000c20000c40000"
    "c70000ca0000cc0000cf0000d20000d40000d70000d90000dc0000df0000e10000e40000"
    "e70000e90000ec0000ee0000f10000f40000f60000f90000fc0000fe0000ff0200ff0500"
    "ff0700ff0a00ff0c00ff0f00ff1200ff1400ff1700ff1a00ff1c00ff1f00ff2100ff2400"
    "ff2700ff2900ff2c00ff2f00ff3100ff3400ff3600ff3900ff3c00ff3e00ff4100ff4400"
    "ff4600ff4900ff4b00ff4e00ff5100ff5300ff5600ff5900ff5b00ff5e00ff6000ff6300"
    "ff6600ff6800ff6b00ff6e00ff7000ff7300ff7500ff7800ff7b00ff7d00ff8000ff8300"
    "ff8500ff8800ff8a00ff8d00ff9000ff9200ff9500ff9700ff9a00ff9d00ff9f00ffa200"
    "ffa500ffa700ffaa00ffac00ffaf00ffb200ffb400ffb700ffba00ffbc00ffbf00ffc100"
    "ffc400ffc700ffc900ffcc00ffcf00ffd100ffd400ffd600ffd900ffdc00ffde00ffe100"
    "ffe400ffe600ffe900ffeb00ffee00fff100fff300fff600fff900fffb00fffe00ffff02"
    "ffff06ffff0affff0effff12ffff16ffff1affff1effff22ffff26ffff2affff2effff32"
    "ffff36ffff3affff3effff41ffff45ffff49ffff4dffff51ffff55ffff59ffff5dffff61"
    "ffff65ffff69ffff6dffff71ffff75ffff79ffff7dffff80ffff84ffff88ffff8cffff90"
    "ffff94ffff98ffff9cffffa0ffffa4ffffa8ffffacffffb0ffffb4ffffb8ffffbcffffbf"
    "ffffc3ffffc7ffffcbffffcfffffd3ffffd7ffffdbffffdfffffe3ffffe7ffffebffffef"
    "fffff3fffff7fffffbffffff"), np.uint8).reshape(256, 3)
_TRACK_RGB = np.array([0, 255, 255], np.int32)  # the JAX copy's "cyan", alpha 0.5
_UPSCALE = 3  # raster pixels per PNG pixel side


def render_heatmap(lats: Sequence[float], lons: Sequence[float]) -> np.ndarray:
    """The heatmap picture, uint8 RGB: ``_density_raster`` normalised to its
    own range and looked up in ``hot`` as matplotlib's ``imshow`` colours it
    (north up), each track point blended into its raster pixel at alpha
    0.5, then every pixel repeated ``_UPSCALE`` times along each side."""
    lats = np.asarray(list(lats), np.float64)
    lons = np.asarray(list(lons), np.float64)
    if lats.size == 0:
        raise ValueError("no GPS points to plot")
    density, extent = _density_raster(lats, lons)
    bins = density.shape[0]
    lo, hi = density.min(), density.max()
    x = (density - lo) / (hi - lo) if hi > lo else np.zeros_like(density)
    idx = np.clip((x * 256).astype(np.int64), 0, 255)
    img = _HOT[idx].astype(np.int32)
    col = np.floor((lons - extent[0]) / (extent[1] - extent[0]) * bins).astype(np.int64)
    row = np.floor((lats - extent[2]) / (extent[3] - extent[2]) * bins).astype(np.int64)
    keep = (col >= 0) & (col < bins) & (row >= 0) & (row < bins)
    row, col = np.clip(row[keep], 0, bins - 1), np.clip(col[keep], 0, bins - 1)
    img[row, col] = (img[row, col] + _TRACK_RGB + 1) // 2
    img = img[::-1].astype(np.uint8)  # origin "lower": north up
    return np.repeat(np.repeat(img, _UPSCALE, axis=0), _UPSCALE, axis=1)


def write_heatmap_html(lats: Sequence[float], lons: Sequence[float],
                       out_path: str, title: str = "GPS heatmap") -> str:
    """Render a self-contained HTML heatmap of GPS points.

    The offline stand-in for ``gmplot.GoogleMapPlotter.heatmap + draw``:
    ``render_heatmap``'s picture embedded as a base64 PNG, so the HTML needs
    no tiles, JS, or network; the JAX copy's title and point count.
    """
    lats = list(lats)
    png_b64 = base64.b64encode(encode_png(render_heatmap(lats, lons))).decode("ascii")
    html = (
        "<!DOCTYPE html><html><head><meta charset='utf-8'>"
        f"<title>{title}</title></head><body>"
        f"<h3>{title} — {len(lats)} points</h3>"
        f"<img alt='heatmap' src='data:image/png;base64,{png_b64}'/>"
        "</body></html>")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        f.write(html)
    return out_path
