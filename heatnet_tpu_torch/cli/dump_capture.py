"""Capture dump: synchronized streams → rectified PNG folder tree.

Counterpart of ``heatnet_tpu/cli/dump_capture.py``, the TPU-era equivalent
of the reference's rosbag parsing script (``data/bag_parser.py:294-558``
PC_Parser.start + parseListofFiles): it consumes a recorded stream
directory (the no-ROS replacement for a bag) and composes

- the native ApproximateTime ``Synchronizer`` (``native/``) in place of the
  hand-rolled nearest-to-reference-topic queue scan (bag_parser.py:185-246);
- ``data.tf_store.TransformStore`` in place of BagTfTransformer for the
  ``odom_combined → base_link`` vehicle-pose lookups (bag_parser.py:434,
  checkTransforms :271-291);
- ``data.calibration.StereoRectifier`` (kalibr camchain yaml) in place of
  the cv2.fisheye Undistorter (bag_parser.py:91-143);
- ``data.pointcloud`` lidar arrays → per-frame ``.npy`` (extract_lidar_pcl.py
  flow);
- ``utils.gps_heatmap`` for UTM→lat/lon, heat_stats files and the track
  heatmap HTML (bag_parser.py:441,541-555, plot_gm.py).

The same flags, defaults and output tree as the JAX CLI. Frames are read
and written with ``data/png.py`` instead of ``cv2.imread(IMREAD_UNCHANGED)``
and ``cv2.imwrite``: a frame keeps its stored channel order end to end (the
rectifier treats each channel alike), so the files hold what the JAX CLI's
hold. The rectifier is the numpy copy of cv2's fisheye maps and remap.

Recorded stream directory layout (what a capture box writes):

    capture/
      streams/<topic>/<secs>_<nsecs>.png   8-bit RGB / 16-bit IR frames
      streams/<topic>/<secs>_<nsecs>.npy   lidar structured arrays
      tf.jsonl                             stamped transforms (tf_store)
      origin.json                          {"position": [utm_x, utm_y, z]}

Output tree (reference on-disk contract, bag_parser.py:373-410):

    out/drive_{day|night}_<Y_m_d_H_M_S>/
      <prefix>/<prefix>_<secs>_<nsecs><seq>.png   per topic
      vehicle/<prefix0>_drive_<ts>_<sx>-<sy>_vehicle.txt
      paths/<prefix>_drive_<ts>_<sx>-<sy>.txt
      origin/drive_<ts>_origin.txt
      heat_stats_<ts>                             "lat lon" lines
      heatmap.html

The day/night folder name comes from ``datetime.fromtimestamp``: local
time. Each window is stamped with its newest synced frame's stamp (the
JAX CLI's documented deviation from bag_parser.py:396).

Usage::

    python -m heatnet_tpu_torch.cli.dump_capture --capture CAPTURE --out OUT \\
        [--calib camchain.yaml --calib-cams left right]
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..data.calibration import StereoRectifier, load_kalibr_yaml
from ..data.png import read_png_palette, write_png
from ..data.tf_store import TransformLookupError, TransformStore
from ..native.bindings import Synchronizer
from ..utils.gps_heatmap import (latlon_to_utm, save_heat_stats, utm_to_latlon,
                                 write_heatmap_html)

QUEUE_SIZE = 5  # bag_parser.py:31


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Dump a recorded capture "
                                            "directory to a dataset tree")
    p.add_argument("--capture", required=True, help="capture directory "
                   "(streams/ + tf.jsonl + origin.json)")
    p.add_argument("--out", required=True, help="core output directory")
    p.add_argument("--topics", nargs="+",
                   default=["rgb_fl_burst", "rgb_fr_burst",
                            "ir_left_burst", "ir_right_burst"])
    p.add_argument("--prefixes", nargs="+",
                   default=["fl_rgb", "fr_rgb", "fl_ir", "fr_ir"])
    p.add_argument("--calib", default="", help="kalibr camchain yaml for "
                   "the stereo RGB pair (topics 0/1); omit to dump raw")
    p.add_argument("--calib-cams", nargs=2, default=["cam0", "cam1"],
                   help="camchain entries for left/right RGB")
    p.add_argument("--sync-slop-ms", type=float, default=16.0,
                   help="max stream time skew (bag_parser.py:226 16 ms)")
    p.add_argument("--max-frame-gap-ms", type=float, default=36.0,
                   help="frame-rate consistency bound "
                        "(bag_parser.py checkFramerate 36 ms)")
    p.add_argument("--utm-zone", default="32U",
                   help="UTM zone of the odometry origin (Freiburg: 32U)")
    p.add_argument("--section-center", nargs=2, type=float,
                   default=[48.013551, 7.833116],
                   help="lat lon of the 500 m section-grid center "
                        "(bag_parser.py:306)")
    p.add_argument("--heatmap-min-dist", type=float, default=10.0,
                   help="meters between recorded heatmap points "
                        "(bag_parser.py:541)")
    return p


def _scan_stream(capture: str, topic: str) -> List[Tuple[float, str]]:
    """(stamp_s, path) list for one topic, stamp-sorted."""
    d = os.path.join(capture, "streams", topic)
    out = []
    if not os.path.isdir(d):
        raise FileNotFoundError(f"no stream directory {d}")
    for name in os.listdir(d):
        stem, ext = os.path.splitext(name)
        if ext not in (".png", ".npy"):
            continue
        secs, _, nsecs = stem.partition("_")
        out.append((int(secs) + int(nsecs) / 1e9, os.path.join(d, name)))
    out.sort()
    return out


def _is_lidar(path: str) -> bool:
    return path.endswith(".npy")


def _name(prefix: str, stamp_s: float, seq: int) -> str:
    # generateName (bag_parser.py:263): prefix_secs_nsecs{seq}.png
    secs = int(stamp_s)
    nsecs = int(round((stamp_s - secs) * 1e9))
    return f"{prefix}_{secs}_{nsecs}{seq}.png"


def _check_framerate(stamps: Sequence[float], threshold_s: float) -> bool:
    """checkFramerate (bag_parser.py:248-260): max consecutive gap."""
    gaps = [abs(b - a) for a, b in zip(stamps, list(stamps)[1:])]
    return not gaps or max(gaps) < threshold_s


def _read_frame(path: str) -> np.ndarray:
    """A frame as stored (a palette image expanded to its colours)."""
    img, palette = read_png_palette(path)
    return img if palette is None else palette[img]


def main(argv=None) -> Optional[str]:
    args = build_parser().parse_args(argv)

    topics = list(args.topics)
    prefixes = list(args.prefixes)
    if len(topics) != len(prefixes):
        raise SystemExit("--topics and --prefixes must pair up")

    store = TransformStore.from_jsonl(os.path.join(args.capture, "tf.jsonl"))
    with open(os.path.join(args.capture, "origin.json")) as f:
        origin = np.asarray(json.load(f)["position"], np.float64)

    zone_number = int(args.utm_zone[:-1])
    zone_letter = args.utm_zone[-1]
    center_lat, center_lon = args.section_center
    center = latlon_to_utm(center_lat, center_lon)[:2]

    rectifier = None
    if args.calib:
        cams = load_kalibr_yaml(args.calib)
        left, right = (cams[c] for c in args.calib_cams)
        if right.T_cn_cnm1 is None:
            raise SystemExit(f"{args.calib_cams[1]} needs T_cn_cnm1")
        rectifier = StereoRectifier(left, right,
                                    right.T_cn_cnm1[:3, :3],
                                    right.T_cn_cnm1[:3, 3])

    # merge every stream into one stamp-ordered message list
    streams = {t: _scan_stream(args.capture, t) for t in topics}
    messages = sorted(
        (stamp, ti, path)
        for ti, t in enumerate(topics)
        for stamp, path in streams[t])
    if not messages:
        raise SystemExit("capture contains no frames")

    sync = Synchronizer(len(topics), slop_s=args.sync_slop_ms / 1000.0)
    queues: List[deque] = [deque(maxlen=QUEUE_SIZE) for _ in topics]

    # directory init happens on the first message (bag_parser.py:379-407)
    first_stamp = messages[0][0]
    dt0 = datetime.datetime.fromtimestamp(int(first_stamp))
    time_str = dt0.strftime("%Y_%m_%d_%H_%M_%S")
    daytime = "night" if (dt0.hour >= 22 or dt0.hour < 6) else "day"
    save_dir = os.path.join(args.out, f"drive_{daytime}_{time_str}")
    save_dirs = [os.path.join(save_dir, p) for p in prefixes]
    if os.path.isdir(save_dirs[-1]):
        print("File is already parsed")
        return None
    vehicle_dir = os.path.join(save_dir, "vehicle")
    paths_dir = os.path.join(save_dir, "paths")
    origin_dir = os.path.join(save_dir, "origin")
    for d in save_dirs + [vehicle_dir, paths_dir, origin_dir]:
        os.makedirs(d, exist_ok=True)

    heat_lat: List[float] = []
    heat_lon: List[float] = []
    pre_translation = np.ones(3) * 100.0  # bag_parser.py:302
    pre_time = -1.0
    written = 0

    id_to_path: Dict[int, str] = {}
    for msg_id, (stamp, ti, path) in enumerate(messages):
        id_to_path[msg_id] = path
        sync.push(ti, stamp, msg_id)
        synced = sync.poll()
        if synced is None:
            continue
        stamps, ids = synced
        time_stamp = float(stamps.min())  # earliest of the synced pair
        if time_stamp <= pre_time:  # td must advance (bag_parser.py:425)
            continue
        pre_time = time_stamp
        for i, q in enumerate(queues):
            q.append((float(stamps[i]), id_to_path[int(ids[i])]))

        try:
            translation, quaternion = store.lookup_transform(
                "odom_combined", "base_link", time_stamp)
        except TransformLookupError:
            print("Failed to get transformation!")
            continue
        translation = np.asarray(translation)
        diff = translation - pre_translation
        translation_utm = translation + origin
        lat_lon = utm_to_latlon(translation_utm[0], translation_utm[1],
                                zone_number, zone_letter)

        if len(queues[0]) == QUEUE_SIZE:
            window_stamps = [s for s, _ in queues[0]]
            if _check_framerate(window_stamps,
                                args.max_frame_gap_ms / 1000.0):
                section_x = int((translation_utm[0] - center[0]) / 500)
                section_y = int((translation_utm[1] - center[1]) / 500)
                burst_stamp = window_stamps[-1]

                # vehicle transform string for the window (checkTransforms)
                try:
                    window_tf = [store.lookup_transform(
                        "odom_combined", "base_link", s)
                        for s in window_stamps]
                except TransformLookupError:
                    print("Transforms are inconsistent")
                    continue
                tf_str = "".join(
                    f"{t[0]} {t[1]} {t[2]} {q[0]} {q[1]} {q[2]} {q[3]} / "
                    for t, q in window_tf)
                vehicle_txt = os.path.join(
                    vehicle_dir, f"{prefixes[0]}_drive_{time_str}_"
                                 f"{section_x}-{section_y}_vehicle.txt")
                with open(vehicle_txt, "a") as f:
                    f.write(tf_str + "\n")

                for ti2, (topic, prefix) in enumerate(zip(topics, prefixes)):
                    paths_out = []
                    for seq, (s, src) in enumerate(queues[ti2]):
                        dst = os.path.join(
                            save_dirs[ti2], _name(prefix, burst_stamp, seq))
                        if _is_lidar(src):
                            # rename BEFORE recording/dedup so the paths
                            # manifest points at the .npy actually written
                            dst = dst[:-4] + ".npy"
                        paths_out.append(dst)
                        if os.path.isfile(dst):
                            continue
                        if _is_lidar(src):
                            np.save(dst, np.load(src))
                            written += 1
                            continue
                        img = _read_frame(src)
                        if rectifier is not None and "rgb" in topic:
                            left = ("fl" in topic or "left" in topic
                                    or "bl" in topic)
                            img = rectifier.remap(img, left)
                        write_png(dst, img, level=1)  # cv2.imwrite's default
                        written += 1
                    paths_txt = os.path.join(
                        paths_dir, f"{prefix}_drive_{time_str}_"
                                   f"{section_x}-{section_y}.txt")
                    with open(paths_txt, "a") as f:
                        f.write(" ".join(paths_out) + " \n")
            else:
                print("Time difference too high")

        # heatmap point every N meters (bag_parser.py:539-544)
        if float(np.sqrt(diff.dot(diff))) > args.heatmap_min_dist:
            heat_lat.append(lat_lon[0])
            heat_lon.append(lat_lon[1])
            pre_translation = translation

    # origin + heatmap epilogue (writeOrigin, saveHeatStats, gmap.draw)
    with open(os.path.join(origin_dir, f"drive_{time_str}_origin.txt"),
              "a") as f:
        f.write(f"{origin[0]}/{origin[1]}/{origin[2]}\n")
    print(f"Generating heatmap with: {len(heat_lat)} entries")
    if heat_lat:
        save_heat_stats(heat_lat, heat_lon,
                        os.path.join(save_dir, f"heat_stats_{time_str}"))
        write_heatmap_html(heat_lat, heat_lon,
                           os.path.join(save_dir, "heatmap.html"))
    print(f"dumped {written} frames -> {save_dir}")
    return save_dir


if __name__ == "__main__":
    main()
