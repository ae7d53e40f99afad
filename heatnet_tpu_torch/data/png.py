"""PNG files read and written with ``zlib`` and numpy alone.

The JAX package's loaders decode through cv2
(``heatnet_tpu/data/loaders.py:46-57``) and its dumps are written through PIL
(``heatnet_tpu/utils/vis.py:52-61``); the port depends on neither, since a
CUDA machine need not have them. ``read_png`` decodes
non-interlaced 8- and 16-bit greyscale, RGB and RGBA (colour types 0, 2, 6)
and 8-bit palette images (colour type 3, returned as their indices, as
``np.asarray`` of a PIL ``"P"`` image gives them; ``read_png_palette`` also
returns the palette) with every row filter; it raises on Adam7 interlacing,
grey+alpha and depths below 8. ``write_png`` writes 8-bit grey, RGB and RGBA and 16-bit
grey, every row with filter 0.

Decoding speed: libpng picks a filter per row, so real files hold Average
and Paeth rows, whose bytes each depend on the decoded byte to their left;
a loop over pixels in Python would visit every byte. Such images are
reconstructed along anti-diagonals instead: pixel (r, c) needs only
(r, c-1), (r-1, c) and (r-1, c-1), so each anti-diagonal is one vector
step, H + W steps in all. Images whose rows use only None, Sub and Up take
a row-by-row path of a few vector operations per row (Sub is a cumulative
sum per byte lane). ``tools/png_decode_time.py`` times both paths.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 6: 4}  # colour type → samples per pixel


def _chunks(data: bytes, path: str):
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc, = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: truncated (no IEND chunk)")


def _paeth(a, b, c):
    # p = a + b - c; |p - a| = |b - c|, |p - b| = |a - c|, |p - c| = their sum's
    da, db = b - c, a - c
    pa, pb, pc = np.abs(da), np.abs(db), np.abs(da + db)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_rows(filt: np.ndarray, kinds: np.ndarray, bpp: int) -> np.ndarray:
    """None, Sub and Up rows only: each row in a few vector operations."""
    h, row_bytes = filt.shape
    out = np.empty((h, row_bytes), np.uint8)
    prev = np.zeros(row_bytes, np.uint8)
    for r in range(h):
        x = filt[r]
        if kinds[r] == 1:  # Sub: a running sum over each byte lane
            x = np.cumsum(x.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kinds[r] == 2:  # Up
            x = x + prev
        out[r] = x
        prev = out[r]
    return out


def _unfilter_wavefront(filt: np.ndarray, kinds: np.ndarray, bpp: int) -> np.ndarray:
    """Every filter, along anti-diagonals of the (H, W) pixel grid.

    The grid is stored skewed and diagonal-major, ``s[r + c + 1, r + 1] =
    pixel (r, c)``, with a zero row and column as PNG's "outside the image".
    Anti-diagonal ``k = r + c`` is then the contiguous row ``k + 1`` of
    ``s``: left neighbours are row ``k`` one place lower, up neighbours row
    ``k`` at the same place, up-left neighbours row ``k - 1``.
    """
    h, row_bytes = filt.shape
    w = row_bytes // bpp
    r = np.arange(h)[:, None]
    skew = r + np.arange(w)[None, :]  # pixel (r, c) → diagonal r + c
    f = np.zeros((h + w, h, bpp), np.int16)
    f[skew, r] = filt.reshape(h, w, bpp)
    s = np.zeros((h + w + 1, h + 1, bpp), np.int16)
    kind = kinds.astype(np.intp)[:, None]
    zero = np.zeros((h, bpp), np.int16)
    for k in range(h + w - 1):
        lo, hi = max(0, k - w + 1), min(h, k + 1)  # rows on this diagonal
        a = s[k, lo + 1:hi + 1]
        b = s[k, lo:hi]
        c = s[k - 1, lo:hi] if k > 0 else zero[lo:hi]
        pred = np.choose(kind[lo:hi], (zero[lo:hi], a, b, (a + b) >> 1, _paeth(a, b, c)))
        s[k + 1, lo + 1:hi + 1] = (f[k, lo:hi] + pred) & 0xFF
    return s[skew + 1, r + 1].astype(np.uint8).reshape(h, row_bytes)


def png_size(path: str):
    """(height, width) from a PNG's IHDR chunk, without decoding the image."""
    with open(path, "rb") as fh:
        head = fh.read(24)
    if head[:8] != _SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    width, height = struct.unpack(">II", head[16:24])
    return height, width


def read_png(path: str) -> np.ndarray:
    """Decode ``path`` as stored: (H, W) for grey and palette indices, (H, W,
    3) RGB, (H, W, 4) RGBA, uint8 or uint16 (16-bit samples are big-endian
    on disk)."""
    return read_png_palette(path)[0]


def read_png_palette(path: str):
    """``(pixels, palette)``: ``read_png``'s pixels and, for a palette image,
    its ``(entries, 3)`` uint8 RGB palette (else None)."""
    with open(path, "rb") as fh:
        data = fh.read()
    header, idat, palette = None, [], None
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, colour, compression, filter_method, interlace = header
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) PNGs are not supported")
    if colour not in _CHANNELS:
        raise ValueError(f"{path}: colour type {colour} is not supported "
                         "(grey, RGB, RGBA and palette only; no grey+alpha)")
    if depth not in ((8,) if colour == 3 else (8, 16)):
        raise ValueError(f"{path}: bit depth {depth} is not supported "
                         f"({'8 for a palette' if colour == 3 else '8 or 16'})")
    if colour == 3 and palette is None:
        raise ValueError(f"{path}: a palette image without a PLTE chunk")
    if compression or filter_method:
        raise ValueError(f"{path}: unknown compression or filter method")
    channels = _CHANNELS[colour]
    bpp = channels * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * bpp):
        raise ValueError(f"{path}: {raw.size} bytes of image data, expected "
                         f"{h * (1 + w * bpp)}")
    raw = raw.reshape(h, 1 + w * bpp)
    kinds, filt = raw[:, 0], raw[:, 1:]
    if kinds.max(initial=0) > 4:
        raise ValueError(f"{path}: unknown row filter {int(kinds.max())}")
    if not kinds.any():
        pixels = filt
    elif kinds.max() <= 2:
        pixels = _unfilter_rows(filt, kinds, bpp)
    else:
        pixels = _unfilter_wavefront(filt, kinds, bpp)
    if depth == 16:
        pixels = pixels.reshape(-1).view(">u2").astype(np.uint16)
    shape = (h, w) if channels == 1 else (h, w, channels)
    return np.ascontiguousarray(pixels.reshape(shape)), (palette if colour == 3 else None)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray, level: int = 3) -> None:
    """Write uint8 (H, W), (H, W, 1), (H, W, 3) or (H, W, 4), or uint16
    (H, W) or (H, W, 1), as a PNG whose rows all use filter 0."""
    img = np.asarray(image)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    channels = {2: 1, 3: img.shape[-1]}.get(img.ndim)
    colour = {1: 0, 3: 2, 4: 6}.get(channels)
    if colour is None:
        raise ValueError(f"cannot write an image of shape {img.shape}")
    if img.dtype == np.uint16 and channels == 1:
        depth, rows = 16, img.astype(">u2")
    elif img.dtype == np.uint8:
        depth, rows = 8, img
    else:
        raise ValueError(f"cannot write {img.dtype} with {channels} channels "
                         "(uint8 grey/RGB/RGBA or uint16 grey)")
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(rows).view(np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    with open(path, "wb") as fh:
        fh.write(_SIGNATURE)
        fh.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, 0)))
        fh.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), level)))
        fh.write(_chunk(b"IEND", b""))
