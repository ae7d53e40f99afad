"""CLAHE on the Lab lightness plane, cv2's 8-bit arithmetic in numpy.

Counterpart of ``heatnet_tpu/data/loaders.py::apply_clahe`` (:619-631; the
reference's ``vistas_dataset.py:95-104``): ``cv2.cvtColor(COLOR_BGR2LAB)``,
``cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8, 8)).apply`` on the L plane,
then ``cv2.cvtColor(COLOR_LAB2RGB)``. Each step copies cv2 5.0's 8-bit
kernel, so the result equals cv2's on every pixel:

- ``bgr_to_lab``: fixed point (``RGB2Lab_b``): an sRGB gamma table in
  1/8 steps, the XYZ matrix scaled by 2^12 and divided by the D65 white,
  a cube-root table in 2^15 steps; tables built in float32 and double as
  cv2's ``softfloat`` builds them, rounded half to even (its cube root
  rounds toward zero).
- ``lab_to_rgb``: fixed point (``Lab2RGBinteger``): L to (y, f(y)) and
  a, b to f(x), f(z) by integer approximations of /500 and /200, the
  inverse cube by a table, the sRGB matrix scaled by 2^12 times the white,
  an inverse-gamma table of 4096 steps.
- ``clahe``: tiles of an image padded (reflect-101) to a multiple of the
  grid (a dimension the grid already divides still gains a whole tile when
  the other does not, as cv2 pads), an integer clip limit, the clipped
  counts spread evenly with the residual one per ``256 // residual``
  bins, LUTs by float32 scaling, and a float32 bilinear blend of the four
  nearest tiles' LUTs, each rounded half to even.
"""

from __future__ import annotations

import numpy as np

_F32 = np.float32

# cv2's constants (color.hpp: sRGB2XYZ_D65, XYZ2sRGB_D65, D65), as doubles
_SRGB2XYZ = np.array([0.412453, 0.357580, 0.180423,
                      0.212671, 0.715160, 0.072169,
                      0.019334, 0.119193, 0.950227]).reshape(3, 3)
_XYZ2SRGB = np.array([3.240479, -1.53715, -0.498535,
                      -0.969256, 1.875991, 0.041556,
                      0.055648, -0.204043, 1.057311]).reshape(3, 3)
_D65 = np.array([0.950456, 1.0, 1.088754])

_LAB_SHIFT, _GAMMA_SHIFT = 12, 3
_LAB_SHIFT2 = _LAB_SHIFT + _GAMMA_SHIFT
_LAB_BASE = 1 << 14
_INV_GAMMA = 1 << 12
_MIN_AB = -8145


def _round_even(x) -> np.ndarray:
    """``cvRound``: to the nearest integer, ties to even."""
    return np.rint(x).astype(np.int64)


def _descale(x, n: int) -> np.ndarray:
    """``CV_DESCALE``: ``(x + 2^(n-1)) >> n``, arithmetic shift."""
    return (x + (1 << (n - 1))) >> n


def _gamma(x: np.ndarray) -> np.ndarray:
    """``applyGamma`` in double on float32 inputs, returned as float32."""
    xd = x.astype(np.float64)
    return np.where(xd <= 0.04045, xd / 12.92,
                    np.power((xd + 0.055) / (1.0 + 0.055), 2.4)).astype(_F32)


def _inv_gamma(x: np.ndarray) -> np.ndarray:
    """``applyInvGamma`` in double on float32 inputs, returned as float32."""
    xd = x.astype(np.float64)
    return np.where(xd <= 0.0031308, xd * 12.92,
                    np.power(xd, 1.0 / 2.4) * (1.0 + 0.055) - 0.055).astype(_F32)


def _fma32(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` with one rounding (the product is exact in
    double for float32 operands)."""
    return (a.astype(np.float64) * np.float64(b) + np.float64(c)).astype(_F32)


def _build_tables():
    i = np.arange(256)
    x = i.astype(_F32) / _F32(255)
    srgb_gamma = _round_even(_F32(255 * (1 << _GAMMA_SHIFT)) * _gamma(x))

    j = np.arange(256 * 3 // 2 * (1 << _GAMMA_SHIFT))
    x = _F32(1) / _F32(255 * (1 << _GAMMA_SHIFT)) * j.astype(_F32)
    lthresh = _F32(216) / _F32(24389)
    lin = _fma32(x, _F32(841) / _F32(108), _F32(16) / _F32(116))
    # softfloat's cbrt: the double cube root truncated to float32 (a correctly
    # rounded one differs at entry 324, a tie after the 2^15 scaling)
    c64 = np.cbrt(x.astype(np.float64))
    cbrt = c64.astype(_F32)
    cbrt = np.where(cbrt.astype(np.float64) > c64, np.nextafter(cbrt, _F32(0)), cbrt)
    cbrt_tab = _round_even(_F32(1 << _LAB_SHIFT2) * np.where(x < lthresh, lin, cbrt))

    k = np.arange(_INV_GAMMA)
    x = _F32(1) / _F32(_INV_GAMMA) * k.astype(_F32)
    inv_gamma = _round_even(_F32(255) * _inv_gamma(x))

    # L (0..255) -> (y, f(y)) in 2^14 units
    lo = i <= 20
    y_lo = _round_even((i * _LAB_BASE * 20 * 9).astype(_F32)
                       / _F32(17 * 29 * 29 * 29))
    fy_lo = _round_even(_F32(_LAB_BASE) * (_F32(16) / _F32(116)
                                           + (i * 5).astype(_F32) / _F32(3 * 17 * 29)))
    fy = ((i * 100 * _LAB_BASE).astype(_F32) / _F32(255 * 116)
          + _F32(16 * _LAB_BASE) / _F32(116))
    y_hi = _round_even(fy * fy * fy / _F32(_LAB_BASE * _LAB_BASE))
    l_to_y = np.where(lo, y_lo, y_hi)
    l_to_fy = np.where(lo, fy_lo, _round_even(fy))

    # f(x) or f(z) (2^14 units, from _MIN_AB) -> x or z
    v = np.arange(_MIN_AB, _LAB_BASE * 9 // 4 + _MIN_AB)
    lin = np.trunc(v * 108 / 841).astype(np.int64) - _LAB_BASE * 16 // 116 * 108 // 841
    ab_to_xz = np.where(v <= 3390, lin, v * v // _LAB_BASE * v // _LAB_BASE)

    to_xyz = _round_even((1 << _LAB_SHIFT) * _SRGB2XYZ / _D65[:, None])
    to_rgb = _round_even((1 << _LAB_SHIFT) * _XYZ2SRGB * _D65[None, :])
    return dict(srgb_gamma=srgb_gamma, cbrt=cbrt_tab, inv_gamma=inv_gamma,
                l_to_y=l_to_y, l_to_fy=l_to_fy, ab_to_xz=ab_to_xz,
                to_xyz=to_xyz, to_rgb=to_rgb)


_TABLES = None


def _tables() -> dict:
    global _TABLES
    if _TABLES is None:
        _TABLES = _build_tables()
    return _TABLES


def bgr_to_lab(bgr: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(bgr, COLOR_BGR2LAB)`` for uint8 (..., 3)."""
    t = _tables()
    g = t["srgb_gamma"][bgr[..., ::-1]]  # R, G, B gamma-expanded, 1/8 steps
    fx, fy, fz = (t["cbrt"][_descale(g @ t["to_xyz"][r], _LAB_SHIFT)] for r in range(3))
    big = 128 << _LAB_SHIFT2
    lab = np.stack([_descale(((116 * 255 + 50) // 100) * fy
                             - (16 * 255 * (1 << _LAB_SHIFT2) + 50) // 100, _LAB_SHIFT2),
                    _descale(500 * (fx - fy) + big, _LAB_SHIFT2),
                    _descale(200 * (fy - fz) + big, _LAB_SHIFT2)], -1)
    return np.clip(lab, 0, 255).astype(np.uint8)


def lab_to_rgb(lab: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(lab, COLOR_LAB2RGB)`` for uint8 (..., 3)."""
    t = _tables()
    L, a, b = (lab[..., c].astype(np.int64) for c in range(3))
    y, fy = t["l_to_y"][L], t["l_to_fy"][L]
    adiv = ((5 * a * 53687 + (1 << 7)) >> 13) - 128 * _LAB_BASE // 500
    bdiv = ((b * 41943 + (1 << 4)) >> 9) - 128 * _LAB_BASE // 200 + 1
    x = t["ab_to_xz"][fy + adiv - _MIN_AB]
    z = t["ab_to_xz"][fy - bdiv - _MIN_AB]
    xyz = np.stack([x, y, z], -1)
    shift = _LAB_SHIFT + 14 - 12
    rgb = _descale(xyz @ t["to_rgb"].T, shift)
    rgb = t["inv_gamma"][np.clip(rgb, 0, _INV_GAMMA - 1)]
    return np.clip(rgb, 0, 255).astype(np.uint8)


def clahe(plane: np.ndarray, clip_limit: float = 2.0, grid: int = 8) -> np.ndarray:
    """``cv2.createCLAHE(clip_limit, (grid, grid)).apply`` on a uint8 (H, W)."""
    plane = np.asarray(plane, np.uint8)
    h, w = plane.shape
    src = plane
    if h % grid or w % grid:
        src = np.pad(plane, ((0, grid - h % grid), (0, grid - w % grid)), mode="reflect")
    th, tw = src.shape[0] // grid, src.shape[1] // grid
    total = th * tw
    tiles = src[:grid * th, :grid * tw].reshape(grid, th, grid, tw).transpose(0, 2, 1, 3)
    tiles = tiles.reshape(grid * grid, total).astype(np.int64)
    tiles += 256 * np.arange(grid * grid)[:, None]
    hist = np.bincount(tiles.ravel(), minlength=grid * grid * 256).reshape(grid * grid, 256)

    if clip_limit > 0:
        limit = max(int(clip_limit * total / 256), 1)
        clipped = np.maximum(hist - limit, 0).sum(1)
        hist = np.minimum(hist, limit) + (clipped // 256)[:, None]
        residual = clipped % 256
        for t in np.nonzero(residual)[0]:
            step = max(256 // int(residual[t]), 1)
            idx = np.arange(0, 256, step)[:residual[t]]
            hist[t, idx] += 1

    scale = _F32(255) / _F32(total)
    lut = np.clip(_round_even(np.cumsum(hist, 1).astype(_F32) * scale), 0, 255)
    lut = lut.reshape(grid, grid, 256).astype(_F32)

    def axis(n: int, size: int):
        f = np.arange(n).astype(_F32) * (_F32(1) / _F32(size)) - _F32(0.5)
        i1 = np.floor(f).astype(np.int64)
        a = (f - i1.astype(_F32)).astype(_F32)
        return np.maximum(i1, 0), np.minimum(i1 + 1, grid - 1), a, (_F32(1) - a)

    ty1, ty2, ya, ya1 = axis(h, th)
    tx1, tx2, xa, xa1 = axis(w, tw)
    v = plane.astype(np.int64)
    l11 = lut[ty1[:, None], tx1[None, :], v]
    l12 = lut[ty1[:, None], tx2[None, :], v]
    l21 = lut[ty2[:, None], tx1[None, :], v]
    l22 = lut[ty2[:, None], tx2[None, :], v]
    res = ((l11 * xa1 + l12 * xa) * ya1[:, None] + (l21 * xa1 + l22 * xa) * ya[:, None])
    return np.clip(_round_even(res.astype(_F32)), 0, 255).astype(np.uint8)


def apply_clahe(image_bgr: np.ndarray, clip_limit: float = 2.0, grid: int = 8) -> np.ndarray:
    """CLAHE on the Lab L plane of a uint8 BGR image; returns RGB, as the
    JAX loader's ``apply_clahe`` (the Lab → RGB step is also its BGR → RGB
    swap)."""
    lab = bgr_to_lab(image_bgr)
    lab[..., 0] = clahe(lab[..., 0], clip_limit, grid)
    return lab_to_rgb(lab)
