"""Camera calibration loading and fisheye stereo rectification, in numpy.

Counterpart of ``heatnet_tpu/data/calibration.py``, which rebuilds the
offline calibration tooling of the reference's capture stack:

- kalibr camchain loading (``bag_parser.py:40-90`` CameraInfoReader). The
  JAX copy parses with PyYAML; ``load_yaml`` here reads the subset of YAML
  that kalibr's camchain files use (block mappings, block lists, flow lists
  and mappings, plain and quoted scalars, comments) and resolves scalars as
  ``yaml.safe_load`` does;
- fisheye stereo rectification (``data/rectify.py:15-55`` Undistorter).
  The JAX copy calls ``cv2.fisheye.stereoRectify`` (``CALIB_ZERO_DISPARITY``,
  ``balance=0``, ``fov_scale=1``), ``cv2.fisheye.initUndistortRectifyMap(...,
  CV_16SC2)`` and ``cv2.remap(..., INTER_LINEAR)``; ``stereo_rectify``,
  ``init_undistort_rectify_map`` and ``remap`` are numpy copies of those
  three calls, in cv2's own float64 order of operations;
- RGB↔thermal extrinsics/intrinsics JSON (``t_calib.json``: {"translation",
  "rotation", "intrinsic" (fx, fy, cx, cy)}) and the thermal projection
  warp field, copied.

cv2's rotation averaging orthogonalises through an SVD, and its inverse of
``P·R`` is an SVD pseudo-inverse: numpy's LAPACK gives the same matrices to
within a few ulps, so a map entry can differ from cv2's only where ``u·32``
lies within that distance of a rounding tie. ``remap`` has no such
freedom: given the same maps it equals cv2 bit for bit (uint8: the 15-bit
fixed-point bilinear table, ``(Σ + 2^14) >> 15``; uint16: the float table,
rounded half to even; taps outside the frame read 0).
"""

from __future__ import annotations

import json
import math
import re
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass
class CameraCalib:
    """Pinhole/fisheye camera model (kalibr 'intrinsics' convention)."""

    K: np.ndarray  # 3x3
    D: np.ndarray  # distortion (4,) for fisheye/equidistant
    resolution: Tuple[int, int]  # (width, height)
    distortion_model: str = "equidistant"
    T_cn_cnm1: Optional[np.ndarray] = None  # 4x4 extrinsic to previous cam


# ---------------------------------------------------------------------------
# the YAML subset of kalibr's camchain files
# ---------------------------------------------------------------------------

# PyYAML's YAML 1.1 implicit resolvers (yaml/resolver.py), sexagesimal forms left out
_BOOL = {**dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"), True),
         **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"),
                         False)}
_NULL = {"", "~", "null", "Null", "NULL"}
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?)$")
_INF = re.compile(r"^[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"^\.(?:nan|NaN|NAN)$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+)$")


def _scalar(text: str):
    """A plain or quoted scalar, resolved as ``yaml.safe_load`` resolves it."""
    t = text.strip()
    if len(t) >= 2 and t[0] == t[-1] == "'":
        return t[1:-1].replace("''", "'")
    if len(t) >= 2 and t[0] == t[-1] == '"':
        return json.loads(t)
    if t in _NULL:
        return None
    if t in _BOOL:
        return _BOOL[t]
    if _INT.match(t):
        v = t.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if len(v) > 1 and v[0] == "0":
            return sign * int(v, 8)
        return sign * int(v)
    if _FLOAT.match(t):
        return float(t.replace("_", ""))
    if _INF.match(t):
        return -math.inf if t[0] == "-" else math.inf
    if _NAN.match(t):
        return math.nan
    return t


def _flow(text: str):
    """A flow list or mapping (``[1, 2.0, [a, b]]``, ``{k: v}``) or a scalar."""
    pos = 0

    def item(stop: str):
        nonlocal pos
        while text[pos] == " ":
            pos += 1
        if text[pos] in "[{":
            close = "]" if text[pos] == "[" else "}"
            pos += 1
            out = [] if close == "]" else {}
            while True:
                while text[pos] == " ":
                    pos += 1
                if text[pos] == close:
                    pos += 1
                    return out
                if close == "]":
                    out.append(item(",]"))
                else:
                    key = item(":")
                    pos += 1  # the ':'
                    out[key] = item(",}")
                while text[pos] == " ":
                    pos += 1
                if text[pos] == ",":
                    pos += 1
        start = pos
        if text[pos] in "'\"":
            q = text[pos]
            pos += 1
            while True:  # '' escapes a single quote, a backslash a double-quoted char
                if q == '"' and text[pos] == "\\":
                    pos += 2
                elif text[pos] == q and q == "'" and text[pos + 1:pos + 2] == "'":
                    pos += 2
                elif text[pos] == q:
                    break
                else:
                    pos += 1
            pos += 1
        else:
            while pos < len(text) and text[pos] not in stop:
                pos += 1
        return _scalar(text[start:pos])

    text = text.strip()
    if not text or text[0] not in "[{":
        return _scalar(text)
    return item("")


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _split_key(text: str):
    """``key: rest`` → (key, rest); None when the text is not a mapping entry."""
    m = re.match(r"""^((?:'[^']*'|"[^"]*"|[^'"\[\]{}#][^:#]*?)):(?:\s+(.*)|$)""", text)
    if m is None:
        return None
    return _scalar(m.group(1)), (m.group(2) or "").strip()


def load_yaml(path: str):
    """Parse a kalibr-style YAML file as ``yaml.safe_load`` would."""
    lines = []
    pending = ""
    with open(path) as f:
        for raw in f:
            line = _strip_comment(raw.rstrip("\n"))
            if not line.strip() or line.strip() in ("---", "...") or line.startswith("%"):
                continue
            if pending:  # a flow collection continued on the next line
                pending += " " + line.strip()
            else:
                pending = line
            body = pending.strip()
            depth = 0
            for ch in body:
                depth += ch in "[{"
                depth -= ch in "]}"
            if depth > 0:
                continue
            indent = len(pending) - len(pending.lstrip(" "))
            lines.append((indent, pending.strip()))
            pending = ""
    if not lines:
        return None
    node, end = _block(lines, 0, lines[0][0])
    if end != len(lines):
        raise ValueError(f"{path}: cannot parse line {lines[end][1]!r}")
    return node


def _block(lines, i: int, indent: int):
    """The block node whose lines start at ``i`` with indentation ``indent``;
    returns (node, index after it)."""
    if lines[i][1] == "-" or lines[i][1].startswith("- "):
        out = []
        while i < len(lines) and lines[i][0] == indent and (
                lines[i][1] == "-" or lines[i][1].startswith("- ")):
            rest = lines[i][1][1:].strip()
            i += 1
            if rest and rest[0] not in "[{'\"" and _split_key(rest) is not None:
                raise ValueError(f"block lists of mappings are not supported: {rest!r}")
            if rest:
                out.append(_flow(rest))
            elif i < len(lines) and lines[i][0] > indent:
                value, i = _block(lines, i, lines[i][0])
                out.append(value)
            else:
                out.append(None)
        return out, i
    out = {}
    while i < len(lines) and lines[i][0] == indent:
        entry = _split_key(lines[i][1])
        if entry is None:
            raise ValueError(f"cannot parse YAML line {lines[i][1]!r}")
        key, rest = entry
        i += 1
        if rest:
            out[key] = _flow(rest)
        elif i < len(lines) and (lines[i][0] > indent or (
                lines[i][0] == indent and (lines[i][1] == "-" or lines[i][1].startswith("- ")))):
            out[key], i = _block(lines, i, lines[i][0])
        else:
            out[key] = None
    return out, i


def load_kalibr_yaml(path: str):
    """Parse a kalibr camchain yaml → {cam_name: CameraCalib}."""
    data = load_yaml(path)
    out = {}
    for name, cam in data.items():
        if not isinstance(cam, dict) or "intrinsics" not in cam:
            continue
        fx, fy, cx, cy = cam["intrinsics"]
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)
        D = np.asarray(cam.get("distortion_coeffs", [0, 0, 0, 0]), np.float64)
        T = (np.asarray(cam["T_cn_cnm1"], np.float64)
             if "T_cn_cnm1" in cam else None)
        out[name] = CameraCalib(
            K=K, D=D,
            resolution=tuple(cam.get("resolution", (0, 0))),
            distortion_model=cam.get("distortion_model", "equidistant"),
            T_cn_cnm1=T,
        )
    return out


def load_thermal_calib(path: str):
    """RGB↔thermal calibration JSON (t_calib.json schema).

    Returns (T_4x4 extrinsic, K_3x3 thermal intrinsics)."""
    with open(path) as f:
        data = json.load(f)
    t = np.asarray(data["translation"], np.float64).reshape(3)
    r = np.asarray(data["rotation"], np.float64)
    if r.size == 9:
        R = r.reshape(3, 3)
    else:  # quaternion (x, y, z, w)
        x, y, z, w = r
        R = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ])
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    fx, fy, cx, cy = data["intrinsic"][:4]
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)
    return T, K


# ---------------------------------------------------------------------------
# cv2.fisheye's rectification, in cv2's float64 order of operations
# ---------------------------------------------------------------------------

def rodrigues(rvec) -> np.ndarray:
    """``cv2.Rodrigues`` of a rotation vector: the 3x3 matrix."""
    r = np.asarray(rvec, np.float64).reshape(3)
    theta = math.sqrt(r[0] * r[0] + r[1] * r[1] + r[2] * r[2])
    if theta < np.finfo(np.float64).eps:
        return np.eye(3)
    c, s = math.cos(theta), math.sin(theta)
    x, y, z = r * (1.0 / theta)
    rrt = np.array([[x * x, x * y, x * z], [x * y, y * y, y * z], [x * z, y * z, z * z]])
    r_x = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]])
    return c * np.eye(3) + (1.0 - c) * rrt + s * r_x


def rotation_vector(R) -> np.ndarray:
    """``cv::Affine3d(R).rvec()``: the matrix orthogonalised (``u·vt`` of its
    SVD), then its rotation vector."""
    u, _, vt = np.linalg.svd(np.asarray(R, np.float64))
    m = (u @ vt).ravel()
    rx, ry, rz = m[7] - m[5], m[2] - m[6], m[3] - m[1]
    s = math.sqrt((rx * rx + ry * ry + rz * rz) * 0.25)
    c = min(max((m[0] + m[4] + m[8] - 1) * 0.5, -1.0), 1.0)
    theta = math.acos(c)
    if s < 1e-5:
        if c > 0:
            return np.zeros(3)
        rx = math.sqrt(max((m[0] + 1) * 0.5, 0.0))
        ry = math.sqrt(max((m[4] + 1) * 0.5, 0.0)) * (-1.0 if m[1] < 0 else 1.0)
        rz = math.sqrt(max((m[8] + 1) * 0.5, 0.0)) * (-1.0 if m[2] < 0 else 1.0)
        if abs(rx) < abs(ry) and abs(rx) < abs(rz) and (m[5] > 0) != (ry * rz > 0):
            rz = -rz
        theta /= math.sqrt(rx * rx + ry * ry + rz * rz)
        return np.array([rx * theta, ry * theta, rz * theta])
    vth = 1 / (2 * s) * theta
    return np.array([rx * vth, ry * vth, rz * vth])


def undistort_points(points, K, D, R=None) -> np.ndarray:
    """``cv2.fisheye.undistortPoints(points, K, D, R=R)`` of (N, 2) float64
    points: Newton's method on the equidistant model (at most 10 steps, to
    1e-8), then the rotation and the normalised projection."""
    f, c, k = (K[0, 0], K[1, 1]), (K[0, 2], K[1, 2]), np.asarray(D, np.float64).ravel()
    RR = np.eye(3) if R is None else np.asarray(R, np.float64)
    out = []
    for px, py in np.asarray(points, np.float64).reshape(-1, 2):
        pw = ((px - c[0]) / f[0], (py - c[1]) / f[1])
        theta_d = min(max(-math.pi / 2.0, math.sqrt(pw[0] * pw[0] + pw[1] * pw[1])),
                      math.pi / 2.0)
        converged, theta, scale = False, theta_d, 0.0
        if abs(theta_d) > 1e-8:
            for _ in range(10):
                t2 = theta * theta
                t4 = t2 * t2
                t6 = t4 * t2
                t8 = t6 * t2
                k0, k1, k2, k3 = k[0] * t2, k[1] * t4, k[2] * t6, k[3] * t8
                fix = ((theta * (1 + k0 + k1 + k2 + k3) - theta_d)
                       / (1 + 3 * k0 + 5 * k1 + 7 * k2 + 9 * k3))
                theta = theta - fix
                if abs(fix) < 1e-8:
                    converged = True
                    break
            scale = math.tan(theta) / theta_d
        else:
            converged = True
        flipped = (theta_d < 0 < theta) or (theta < 0 < theta_d)
        if converged and not flipped:
            pr = RR @ np.array([pw[0] * scale, pw[1] * scale, 1.0])
            out.append((pr[0] / pr[2], pr[1] / pr[2]))
        else:
            out.append((-1000000.0, -1000000.0))
    return np.array(out)


def estimate_new_camera_matrix(K, D, size, R, balance: float = 0.0,
                               fov_scale: float = 1.0) -> np.ndarray:
    """``cv2.fisheye.estimateNewCameraMatrixForUndistortRectify``: the
    focal length and centre that keep the undistorted midpoints of the
    four image borders in view (``balance`` 0: the largest focal length)."""
    w, h = size
    balance = min(max(balance, 0.0), 1.0)
    p = undistort_points([(w // 2, 0), (w, h // 2), (w // 2, h), (0, h // 2)], K, D, R)
    cn = np.array([((p[0, 0] + p[1, 0]) + p[2, 0] + p[3, 0]) * 0.25,
                   ((p[0, 1] + p[1, 1]) + p[2, 1] + p[3, 1]) * 0.25])
    aspect = K[0, 0] / K[1, 1]
    cn[1] *= aspect
    p[:, 1] *= aspect
    minx, maxx, miny, maxy = p[:, 0].min(), p[:, 0].max(), p[:, 1].min(), p[:, 1].max()
    fs = (w * 0.5 / (cn[0] - minx), w * 0.5 / (maxx - cn[0]),
          h * 0.5 * aspect / (cn[1] - miny), h * 0.5 * aspect / (maxy - cn[1]))
    f = balance * min(fs) + (1.0 - balance) * max(fs)
    f *= 1.0 / fov_scale if fov_scale > 0 else 1.0
    fx, fy = f, f / aspect
    cx, cy = -cn[0] * f + w * 0.5, (-cn[1] * f + h * aspect * 0.5) / aspect
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])


def stereo_rectify(K1, D1, K2, D2, size, R, tvec, balance: float = 0.0,
                   fov_scale: float = 1.0):
    """``cv2.fisheye.stereoRectify(..., CALIB_ZERO_DISPARITY, balance,
    fov_scale)`` → (R1, R2, P1, P2, Q): the rotation halved (a Rodrigues
    vector times -0.5), the baseline rotated onto x, the smaller of the two
    new focal lengths and the mean of the two centres."""
    r_r = rodrigues(rotation_vector(R) * -0.5)
    tvec = np.asarray(tvec, np.float64).reshape(3)
    t = r_r @ tvec
    uu = np.array([1.0 if t[0] > 0 else -1.0, 0.0, 0.0])
    ww = np.cross(t, uu)
    nw = np.linalg.norm(ww)
    if nw > 0.0:
        ww = ww * (math.acos(abs(t[0]) / np.linalg.norm(t)) / nw)
    wr = rodrigues(ww)
    R1, R2 = wr @ r_r.T, wr @ r_r
    tnew = R2 @ tvec
    k1 = estimate_new_camera_matrix(K1, D1, size, R1, balance, fov_scale)
    k2 = estimate_new_camera_matrix(K2, D2, size, R2, balance, fov_scale)
    fc = min(k1[1, 1], k2[1, 1])
    cc = (np.array([k1[0, 2], k1[1, 2]]) + np.array([k2[0, 2], k2[1, 2]])) * 0.5
    P1 = np.array([[fc, 0, cc[0], 0], [0, fc, cc[1], 0], [0, 0, 1, 0]])
    P2 = np.array([[fc, 0, cc[0], tnew[0] * fc], [0, fc, cc[1], 0], [0, 0, 1, 0]])
    Q = np.array([[1, 0, 0, -cc[0]], [0, 1, 0, -cc[1]], [0, 0, 0, fc],
                  [0, 0, -1.0 / tnew[0], 0.0 / tnew[0]]])
    return R1, R2, P1, P2, Q


_INTER_BITS = 5
_TAB = 1 << _INTER_BITS  # cv2's INTER_TAB_SIZE: maps in 1/32 pixel


def _cv_round(x: np.ndarray) -> np.ndarray:
    """``cvRound`` to int32: half to even; out of range (and NaN) gives
    INT_MIN, as x86's conversion does."""
    with np.errstate(invalid="ignore"):
        ok = np.abs(x) < 2147483647.5
        r = np.where(ok, np.rint(np.where(ok, x, 0.0)), -2147483648.0)
    return r.astype(np.int64).astype(np.int32)


def init_undistort_rectify_map(K, D, R, P, size):
    """``cv2.fisheye.initUndistortRectifyMap(K, D, R, P, size, CV_16SC2)`` →
    (map1 int16 (H, W, 2), map2 uint16 (H, W)). Each row walks ``(P·R)^-1``
    by repeated addition, as cv2 does; ``u·32`` is rounded half to even, its
    integer pixel goes in map1 and ``(v & 31)·32 + (u & 31)`` in map2."""
    w, h = size
    f, c = (K[0, 0], K[1, 1]), (K[0, 2], K[1, 2])
    k = np.asarray(D, np.float64).ravel()
    iR = np.linalg.pinv(np.asarray(P, np.float64)[:, :3] @ np.asarray(R, np.float64))
    rows = np.arange(h, dtype=np.float64)[:, None]

    def walk(row, col: int):
        a = np.empty((h, w))
        a[:, :1] = rows * iR[row, 1] + iR[row, 2]
        a[:, 1:] = iR[row, col]
        return np.cumsum(a, axis=1)

    _x, _y, _w = walk(0, 0), walk(1, 0), walk(2, 0)
    with np.errstate(divide="ignore", invalid="ignore"):
        x, y = _x / _w, _y / _w
        r = np.sqrt(x * x + y * y)
        theta = np.arctan(r)
        t2 = theta * theta
        t4 = t2 * t2
        theta_d = theta * (1 + k[0] * t2 + k[1] * t4 + k[2] * (t4 * t2) + k[3] * (t4 * t4))
        scale = np.where(r == 0, 1.0, theta_d / r)
        u = f[0] * x * scale + c[0]
        v = f[1] * y * scale + c[1]
    behind = _w <= 0
    u = np.where(behind, np.where(_x > 0, -np.inf, np.inf), u)
    v = np.where(behind, np.where(_y > 0, -np.inf, np.inf), v)
    iu, iv = _cv_round(u * _TAB), _cv_round(v * _TAB)
    map1 = np.stack([(iu >> _INTER_BITS).astype(np.int16),
                     (iv >> _INTER_BITS).astype(np.int16)], -1)
    map2 = ((iv & (_TAB - 1)) * _TAB + (iu & (_TAB - 1))).astype(np.uint16)
    return map1, map2


def _bilinear_tables():
    """cv2's INTER_LINEAR remap tables, one row of 4 weights (top-left,
    top-right, bottom-left, bottom-right) per 1/32-pixel fraction ``(fy, fx)``:
    float32, and the same scaled to 2^15 (exact here, so no entry needs
    cv2's adjustment to make the four sum to 2^15)."""
    t = np.arange(_TAB, dtype=np.float32) / np.float32(_TAB)
    one = np.stack([np.float32(1) - t, t], -1).astype(np.float32)
    ft = (one[:, None, :, None] * one[None, :, None, :]).astype(np.float32)
    ft = ft.reshape(_TAB * _TAB, 4)
    return ft, np.rint(ft.astype(np.float64) * (1 << 15)).astype(np.int32)


class RemapPlan:
    """``cv2.remap(img, map1, map2, INTER_LINEAR)`` with BORDER_CONSTANT 0 for
    (H, W) or (H, W, C) uint8 or uint16 frames of one source size: the four
    taps' flat indices (a tap outside the frame reads an appended zero
    pixel) and weights, computed once per map and source size."""

    def __init__(self, map1: np.ndarray, map2: np.ndarray, src_hw: Tuple[int, int]):
        h, w = src_hw
        sx = map1[..., 0].astype(np.int64).ravel()
        sy = map1[..., 1].astype(np.int64).ravel()
        self.shape = map1.shape[:2]
        self.src_hw = (h, w)
        idx = []
        for dy in (0, 1):
            for dx in (0, 1):
                x, y = sx + dx, sy + dy
                inside = (x >= 0) & (x < w) & (y >= 0) & (y < h)
                idx.append(np.where(inside, y * w + x, h * w).astype(np.int32))
        self.idx = idx
        ft, it = _bilinear_tables()
        a = (map2.ravel() & (_TAB * _TAB - 1)).astype(np.intp)
        self.int_w = [np.ascontiguousarray(it[a, k]) for k in range(4)]
        self.float_w = [np.ascontiguousarray(ft[a, k]) for k in range(4)]

    def __call__(self, img: np.ndarray) -> np.ndarray:
        if img.shape[:2] != self.src_hw:
            raise ValueError(f"frame {img.shape[:2]} != the plan's source {self.src_hw}")
        if img.dtype not in (np.uint8, np.uint16):
            raise ValueError(f"remap takes uint8 or uint16 frames, got {img.dtype}")
        planes = img[..., None] if img.ndim == 2 else img
        out = np.empty((self.idx[0].size, planes.shape[2]), img.dtype)
        for c in range(planes.shape[2]):  # one channel at a time: 1-D gathers
            flat = np.concatenate([planes[..., c].ravel(), np.zeros(1, img.dtype)])
            if img.dtype == np.uint8:
                acc = np.full(self.idx[0].size, 1 << 14, np.int32)
                for i, wk in zip(self.idx, self.int_w):
                    acc += np.take(flat, i).astype(np.int32) * wk
                out[:, c] = acc >> 15
            else:
                acc = np.take(flat, self.idx[0]).astype(np.float32) * self.float_w[0]
                for i, wk in zip(self.idx[1:], self.float_w[1:]):
                    acc = acc + np.take(flat, i).astype(np.float32) * wk
                out[:, c] = np.clip(np.rint(acc), 0, 65535)
        return out.reshape(self.shape + img.shape[2:])


def remap(img: np.ndarray, map1: np.ndarray, map2: np.ndarray) -> np.ndarray:
    """``cv2.remap(img, map1, map2, interpolation=INTER_LINEAR)`` for
    CV_16SC2 / CV_16UC1 maps (``RemapPlan`` for one call)."""
    return RemapPlan(map1, map2, img.shape[:2])(img)


class StereoRectifier:
    """Fisheye stereo rectification (rectify.py Undistorter semantics)."""

    def __init__(self, left: CameraCalib, right: CameraCalib,
                 R: np.ndarray, tvec: np.ndarray):
        size = left.resolution
        R1, R2, P1, P2, Q = stereo_rectify(left.K, left.D, right.K, right.D, size, R, tvec,
                                           balance=0.0, fov_scale=1.0)
        self.maps_left = init_undistort_rectify_map(left.K, left.D, R1, P1, size)
        self.maps_right = init_undistort_rectify_map(right.K, right.D, R2, P2, size)
        self.Q = Q
        self._plans = {}

    def remap(self, img: np.ndarray, left: bool) -> np.ndarray:
        """One frame through the left or right camera's maps (its taps and
        weights kept per source size)."""
        key = (left, img.shape[:2])
        if key not in self._plans:
            maps = self.maps_left if left else self.maps_right
            self._plans[key] = RemapPlan(*maps, img.shape[:2])
        return self._plans[key](img)

    def rectify(self, img_left: np.ndarray, img_right: np.ndarray):
        return self.remap(img_left, True), self.remap(img_right, False)


def project_thermal_to_rgb(depth: np.ndarray, K_rgb: np.ndarray,
                           K_ir: np.ndarray, T_rgb_to_ir: np.ndarray):
    """Per-pixel warp field RGB→thermal from depth + calibration.

    The geometric core of the reference's fl_ir_aligned generation: for
    each RGB pixel with depth d, back-project with K_rgb, transform by the
    extrinsic, project with K_ir. Returns float32 (H, W, 2) sample coords.
    """
    h, w = depth.shape
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    z = depth.astype(np.float64)
    x = (xs - K_rgb[0, 2]) / K_rgb[0, 0] * z
    y = (ys - K_rgb[1, 2]) / K_rgb[1, 1] * z
    pts = np.stack([x, y, z, np.ones_like(z)], axis=-1)  # (H, W, 4)
    cam_ir = pts @ T_rgb_to_ir.T
    with np.errstate(divide="ignore", invalid="ignore"):
        u = K_ir[0, 0] * cam_ir[..., 0] / cam_ir[..., 2] + K_ir[0, 2]
        v = K_ir[1, 1] * cam_ir[..., 1] / cam_ir[..., 2] + K_ir[1, 2]
    return np.stack([u, v], axis=-1).astype(np.float32)
