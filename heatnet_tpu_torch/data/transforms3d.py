"""3D rigid-transform math for the capture/TF tooling (numpy, no ROS).

A copy of ``heatnet_tpu/data/transforms3d.py`` (the port imports nothing of
the JAX package). Clean-room equivalent of the quaternion/euler/matrix slice
of the reference's vendored Gohlke library
(``data/transformations.py:180-1705``) that the TF-buffer tooling depends
on. Conventions match the reference exactly where the capture stack uses
them:

- quaternions are ``(x, y, z, w)`` numpy arrays (ROS tf order; the vendored
  lib's ``quaternion_about_axis(0.123, (1,0,0)) ≈ [0.0615, 0, 0, 0.9981]``)
- matrices are 4x4 homogeneous float64
- euler axes specs are the 24 Gohlke strings (``'sxyz'``, ``'rzxz'`` ...):
  ``'s'`` = static/extrinsic frame, ``'r'`` = rotating/intrinsic frame

Not rebuilt (nothing in the capture stack calls them): Arcball, projection /
shear / scale decompositions, superimposition_matrix.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

_EPS = np.finfo(np.float64).eps * 4.0

_AXIS_VECS = {"x": (1.0, 0.0, 0.0), "y": (0.0, 1.0, 0.0), "z": (0.0, 0.0, 1.0)}


# ---------------------------------------------------------------------------
# vectors / matrices
# ---------------------------------------------------------------------------


def vector_norm(v) -> float:
    return float(np.linalg.norm(np.asarray(v, np.float64)))


def unit_vector(v) -> np.ndarray:
    v = np.asarray(v, np.float64)
    n = np.linalg.norm(v)
    if n < _EPS:
        raise ValueError("zero-length vector")
    return v / n


def identity_matrix() -> np.ndarray:
    return np.eye(4, dtype=np.float64)


def translation_matrix(direction) -> np.ndarray:
    m = np.eye(4, dtype=np.float64)
    m[:3, 3] = np.asarray(direction, np.float64)[:3]
    return m


def translation_from_matrix(matrix) -> np.ndarray:
    return np.array(matrix, np.float64)[:3, 3].copy()


def rotation_matrix(angle: float, direction,
                    point: Optional[Sequence[float]] = None) -> np.ndarray:
    """4x4 matrix rotating by ``angle`` (rad) about ``direction`` through
    ``point`` (origin if None). Rodrigues form."""
    d = unit_vector(direction)
    c, s = math.cos(angle), math.sin(angle)
    K = np.array([[0, -d[2], d[1]], [d[2], 0, -d[0]], [-d[1], d[0], 0]],
                 np.float64)
    R = np.eye(3) * c + s * K + (1.0 - c) * np.outer(d, d)
    m = np.eye(4, dtype=np.float64)
    m[:3, :3] = R
    if point is not None:
        p = np.asarray(point, np.float64)[:3]
        m[:3, 3] = p - R @ p
    return m


def concatenate_matrices(*matrices) -> np.ndarray:
    m = np.eye(4, dtype=np.float64)
    for mat in matrices:
        m = m @ np.asarray(mat, np.float64)
    return m


def inverse_matrix(matrix) -> np.ndarray:
    return np.linalg.inv(np.asarray(matrix, np.float64))


def rigid_inverse(matrix) -> np.ndarray:
    """Inverse of a rigid (R, t) transform without a general solve."""
    m = np.asarray(matrix, np.float64)
    R, t = m[:3, :3], m[:3, 3]
    out = np.eye(4, dtype=np.float64)
    out[:3, :3] = R.T
    out[:3, 3] = -R.T @ t
    return out


# ---------------------------------------------------------------------------
# quaternions (x, y, z, w)
# ---------------------------------------------------------------------------


def quaternion_about_axis(angle: float, axis) -> np.ndarray:
    a = np.asarray(axis, np.float64)[:3]
    n = np.linalg.norm(a)
    q = np.zeros(4, np.float64)
    if n > _EPS:
        q[:3] = a / n * math.sin(angle / 2.0)
    q[3] = math.cos(angle / 2.0)
    return q


def quaternion_matrix(quaternion) -> np.ndarray:
    """4x4 rotation matrix from (x, y, z, w) quaternion (need not be unit)."""
    q = np.asarray(quaternion, np.float64)
    n = np.dot(q, q)
    m = np.eye(4, dtype=np.float64)
    if n < _EPS:
        return m
    q = q * math.sqrt(2.0 / n)
    x, y, z, w = q
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m[:3, :3] = np.array([
        [1.0 - yy - zz, xy - wz, xz + wy],
        [xy + wz, 1.0 - xx - zz, yz - wx],
        [xz - wy, yz + wx, 1.0 - xx - yy],
    ])
    return m


def quaternion_from_matrix(matrix) -> np.ndarray:
    """(x, y, z, w) quaternion from a rotation/homogeneous matrix.

    Shepperd's method: pick the largest of (w, x, y, z) traces for
    numerical stability.
    """
    M = np.asarray(matrix, np.float64)[:3, :3]
    tr = M[0, 0] + M[1, 1] + M[2, 2]
    if tr > 0.0:
        s = math.sqrt(tr + 1.0) * 2.0
        w = 0.25 * s
        x = (M[2, 1] - M[1, 2]) / s
        y = (M[0, 2] - M[2, 0]) / s
        z = (M[1, 0] - M[0, 1]) / s
    elif M[0, 0] >= M[1, 1] and M[0, 0] >= M[2, 2]:
        s = math.sqrt(1.0 + M[0, 0] - M[1, 1] - M[2, 2]) * 2.0
        x = 0.25 * s
        w = (M[2, 1] - M[1, 2]) / s
        y = (M[0, 1] + M[1, 0]) / s
        z = (M[0, 2] + M[2, 0]) / s
    elif M[1, 1] >= M[2, 2]:
        s = math.sqrt(1.0 + M[1, 1] - M[0, 0] - M[2, 2]) * 2.0
        y = 0.25 * s
        w = (M[0, 2] - M[2, 0]) / s
        x = (M[0, 1] + M[1, 0]) / s
        z = (M[1, 2] + M[2, 1]) / s
    else:
        s = math.sqrt(1.0 + M[2, 2] - M[0, 0] - M[1, 1]) * 2.0
        z = 0.25 * s
        w = (M[1, 0] - M[0, 1]) / s
        x = (M[0, 2] + M[2, 0]) / s
        y = (M[1, 2] + M[2, 1]) / s
    q = np.array([x, y, z, w], np.float64)
    if q[3] < 0.0:
        q = -q
    return q


def quaternion_multiply(q1, q0) -> np.ndarray:
    """Hamilton product: rotation q0 followed by q1 (matches matrix order
    ``quaternion_matrix(q1) @ quaternion_matrix(q0)``)."""
    x0, y0, z0, w0 = np.asarray(q0, np.float64)
    x1, y1, z1, w1 = np.asarray(q1, np.float64)
    return np.array([
        w1 * x0 + x1 * w0 + y1 * z0 - z1 * y0,
        w1 * y0 - x1 * z0 + y1 * w0 + z1 * x0,
        w1 * z0 + x1 * y0 - y1 * x0 + z1 * w0,
        w1 * w0 - x1 * x0 - y1 * y0 - z1 * z0,
    ], np.float64)


def quaternion_conjugate(q) -> np.ndarray:
    q = np.asarray(q, np.float64)
    return np.array([-q[0], -q[1], -q[2], q[3]], np.float64)


def quaternion_inverse(q) -> np.ndarray:
    q = np.asarray(q, np.float64)
    return quaternion_conjugate(q) / np.dot(q, q)


def quaternion_slerp(quat0, quat1, fraction: float,
                     shortestpath: bool = True) -> np.ndarray:
    """Spherical linear interpolation between two unit quaternions.

    The interpolation primitive of tf transform lookup (tf_bag.py lookups
    interpolate between bracketing /tf messages)."""
    q0 = unit_vector(quat0)
    q1 = unit_vector(quat1)
    if fraction == 0.0:
        return q0
    if fraction == 1.0:
        return q1
    d = float(np.dot(q0, q1))
    if abs(abs(d) - 1.0) < _EPS:
        return q0
    if shortestpath and d < 0.0:
        d = -d
        q1 = -q1
    d = min(max(d, -1.0), 1.0)
    angle = math.acos(d)
    if abs(angle) < _EPS:
        return q0
    isin = 1.0 / math.sin(angle)
    return (math.sin((1.0 - fraction) * angle) * isin * q0
            + math.sin(fraction * angle) * isin * q1)


def random_quaternion(rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Uniform random unit quaternion (Shoemake); seedable, unlike the
    reference's global-state version."""
    rng = rng or np.random.default_rng()
    u1, u2, u3 = rng.random(3)
    r1, r2 = math.sqrt(1.0 - u1), math.sqrt(u1)
    t1, t2 = 2.0 * math.pi * u2, 2.0 * math.pi * u3
    return np.array([r1 * math.sin(t1), r1 * math.cos(t1),
                     r2 * math.sin(t2), r2 * math.cos(t2)], np.float64)


# ---------------------------------------------------------------------------
# euler angles (24 Gohlke axis conventions)
# ---------------------------------------------------------------------------


def _validate_axes(axes: str) -> str:
    axes = axes.lower()
    if (len(axes) != 4 or axes[0] not in "sr"
            or any(c not in "xyz" for c in axes[1:])
            or axes[1] == axes[2] or axes[2] == axes[3]):
        raise ValueError(f"invalid axes spec {axes!r}")
    return axes


def euler_matrix(ai: float, aj: float, ak: float, axes: str = "sxyz"
                 ) -> np.ndarray:
    """4x4 rotation from euler angles in the given axis convention.

    Static frame ('s'): rotations about the FIXED axes in listed order →
    ``R = R3 @ R2 @ R1``. Rotating frame ('r'): about the body axes →
    ``R = R1 @ R2 @ R3``.
    """
    axes = _validate_axes(axes)
    frame, seq = axes[0], axes[1:]
    mats = [rotation_matrix(a, _AXIS_VECS[c])
            for a, c in zip((ai, aj, ak), seq)]
    if frame == "s":
        return mats[2] @ mats[1] @ mats[0]
    return mats[0] @ mats[1] @ mats[2]


def euler_from_matrix(matrix, axes: str = "sxyz"):
    """Euler angles from a rotation matrix, any of the 24 conventions.

    Delegates the extraction to scipy's Rotation (baked into the image as a
    jax dependency): Gohlke 's'+seq == scipy extrinsic lowercase seq,
    'r'+seq == scipy intrinsic uppercase seq.
    """
    from scipy.spatial.transform import Rotation

    axes = _validate_axes(axes)
    frame, seq = axes[0], axes[1:]
    scipy_seq = seq if frame == "s" else seq.upper()
    angles = Rotation.from_matrix(
        np.asarray(matrix, np.float64)[:3, :3]).as_euler(scipy_seq)
    return float(angles[0]), float(angles[1]), float(angles[2])


def euler_from_quaternion(quaternion, axes: str = "sxyz"):
    return euler_from_matrix(quaternion_matrix(quaternion), axes)


def quaternion_from_euler(ai: float, aj: float, ak: float,
                          axes: str = "sxyz") -> np.ndarray:
    return quaternion_from_matrix(euler_matrix(ai, aj, ak, axes))


# ---------------------------------------------------------------------------
# (translation, quaternion) pair helpers — the tf tuple convention
# ---------------------------------------------------------------------------


def pair_to_matrix(translation, quaternion) -> np.ndarray:
    m = quaternion_matrix(quaternion)
    m[:3, 3] = np.asarray(translation, np.float64)[:3]
    return m


def matrix_to_pair(matrix):
    m = np.asarray(matrix, np.float64)
    return m[:3, 3].copy(), quaternion_from_matrix(m)
