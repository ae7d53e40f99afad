"""ctypes bindings for the native C++ components, built with ``g++`` on first use.

Counterpart of ``heatnet_tpu/native/bindings.py``: the same Python surface
(``relabel_vistas_image_native``, ``relabel_image_native``,
``Synchronizer``, ``BurstSampler``, ``thermal_to_8bit``, ``gray_binarize``,
``MessageBus``) over the same four C++ files, which are copies of the JAX
package's. A plain C ABI and ctypes keep the build to one ``g++`` process
with no Python build-time dependency.

The build follows ``kernels/build.py``: the library's name carries a hash
of the sources and flags, so a build is reused until a source changes; it
lives in ``heatnet_tpu_torch/_build/`` (listed in ``.gitignore``), never
beside the sources, and appears atomically (written to a temporary file,
then ``os.replace``), so concurrent processes may race to build it safely.
Nothing builds at import: the first call that needs the library builds and
loads it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
SOURCES = ("relabeller.cpp", "burst_sampler.cpp", "thermal_preproc.cpp", "pubsub.cpp")
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def library_path() -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for src in SOURCES:
        with open(os.path.join(_DIR, src), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libheatnet_native_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the four sources into one shared library unless this build
    exists; return its path. Raises if ``g++`` is missing or fails."""
    so = library_path()
    if os.path.isfile(so):
        return so
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH; the native library "
                           "(heatnet_tpu_torch/native/*.cpp) cannot be built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        tmp_so = os.path.join(tmp, os.path.basename(so))
        res = subprocess.run([gxx, *GXX_FLAGS, "-o", tmp_so,
                              *(os.path.join(_DIR, s) for s in SOURCES)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"native build failed:\n{res.stdout}")
        os.replace(tmp_so, so)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return so


def get_lib() -> ctypes.CDLL:
    """The loaded native library, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(build())
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        sigs = {
            "relabel_vistas_image": (i32, [vp, vp, i32, i32, vp, i32]),
            "relabel_image": (None, [vp, vp, i32, i32, vp]),
            "sync_create": (vp, [i32, i64, i32]),
            "sync_destroy": (None, [vp]),
            "sync_push": (None, [vp, i32, i64, i64]),
            "sync_poll": (i32, [vp, vp, vp]),
            "burst_create": (vp, [i32, i64, i32, ctypes.c_double, i32]),
            "burst_destroy": (None, [vp]),
            "burst_push": (None, [vp, i32, i64, i64]),
            "burst_poll": (i32, [vp, vp, vp]),
            "thermal_to_8bit": (None, [vp, vp, vp, i32, ctypes.c_float, i32]),
            "gray_binarize": (None, [vp, vp, i32, i32]),
            "bus_create": (vp, []),
            "bus_destroy": (None, [vp]),
            "bus_subscribe": (i32, [vp, ctypes.c_char_p, i32]),
            "bus_publish": (None, [vp, ctypes.c_char_p, i64, vp, i32]),
            "bus_poll": (i32, [vp, i32, vp, vp, i32]),
            "bus_pending": (i32, [vp, i32]),
        }
        for name, (restype, argtypes) in sigs.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _LIB = lib
        return lib


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.c_void_p)


def relabel_vistas_image_native(img: np.ndarray, mapping: dict,
                                background: int = 12) -> np.ndarray:
    """Native panoptic relabel (Cython relabeller.pyx:4-36 semantics)."""
    lib = get_lib()
    img = np.ascontiguousarray(img, dtype=np.uint16)
    out = np.empty_like(img)
    map_arr = np.full(256, -1, dtype=np.int32)
    for k, v in mapping.items():
        if 0 <= k < 256:
            map_arr[k] = v
    lib.relabel_vistas_image(_ptr(img), _ptr(out), img.shape[0], img.shape[1],
                             _ptr(map_arr), background)
    return out


def relabel_image_native(seg: np.ndarray, palette: np.ndarray) -> np.ndarray:
    """Native class-map → RGB (relabeller.pyx:38-58)."""
    lib = get_lib()
    seg = np.ascontiguousarray(seg, dtype=np.uint8)
    palette = np.ascontiguousarray(palette, dtype=np.uint8)
    assert palette.shape == (256, 3)
    out = np.empty((*seg.shape, 3), dtype=np.uint8)
    lib.relabel_image(_ptr(seg), _ptr(out), seg.shape[0], seg.shape[1], _ptr(palette))
    return out


class _Stamped:
    """A native N-stream synchronizer handle (``<prefix>_create/push/poll/destroy``)."""

    def __init__(self, prefix: str, num_streams: int, *create_args):
        lib = get_lib()
        self.num_streams = num_streams
        self._push, self._poll, self._destroy = (
            getattr(lib, f"{prefix}_{op}") for op in ("push", "poll", "destroy"))
        self._h = getattr(lib, f"{prefix}_create")(num_streams, *create_args)

    def push(self, stream: int, stamp_s: float, frame_id: int) -> None:
        self._push(self._h, stream, int(stamp_s * 1e9), frame_id)

    def poll(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        stamps = np.empty(self.num_streams, np.int64)
        ids = np.empty(self.num_streams, np.int64)
        if self._poll(self._h, _ptr(stamps), _ptr(ids)):
            return stamps / 1e9, ids
        return None

    def __del__(self):
        try:
            self._destroy(self._h)
        except Exception:
            pass


class Synchronizer(_Stamped):
    """ApproximateTime-style N-stream synchronizer (image_sampler core)."""

    def __init__(self, num_streams: int, slop_s: float = 0.1, max_queue: int = 100):
        super().__init__("sync", num_streams, int(slop_s * 1e9), max_queue)


class BurstSampler(_Stamped):
    """Synchronizer + burst gate: `burst_img_count` tuples per
    `burst_period` seconds (image_sampler.cpp:32-94)."""

    def __init__(self, num_streams: int, slop_s: float = 0.1, max_queue: int = 100,
                 burst_period: float = 1.0, burst_img_count: int = 5):
        super().__init__("burst", num_streams, int(slop_s * 1e9), max_queue, burst_period,
                         burst_img_count)


def thermal_to_8bit(ir: np.ndarray, trunc_value: float = 30000.0,
                    bin_thresh: int = 100) -> Tuple[np.ndarray, np.ndarray]:
    """IR16 → (inverted 8-bit, binary mask) (combinedNode.cpp:37-166)."""
    lib = get_lib()
    ir = np.ascontiguousarray(ir, dtype=np.uint16)
    out = np.empty(ir.shape, np.uint8)
    mask = np.empty(ir.shape, np.uint8)
    lib.thermal_to_8bit(_ptr(ir), _ptr(out), _ptr(mask), ir.size, trunc_value, bin_thresh)
    return out, mask


def gray_binarize(gray: np.ndarray, thresh: int = 140) -> np.ndarray:
    lib = get_lib()
    gray = np.ascontiguousarray(gray, dtype=np.uint8)
    out = np.empty(gray.shape, np.uint8)
    lib.gray_binarize(_ptr(gray), _ptr(out), gray.size, thresh)
    return out


class MessageBus:
    """In-process pub/sub bus (native pubsub.cpp): the msg_filter scaffolding
    (firstNode/secondNode, ros_src/learn_msg_filter).

    Topics are strings; messages are (stamp_s, bytes) with per-subscriber
    bounded drop-oldest queues like ros::Publisher queue_size semantics.
    """

    def __init__(self):
        self._lib = get_lib()
        self._h = self._lib.bus_create()

    def subscribe(self, topic: str, queue_size: int = 5) -> int:
        return self._lib.bus_subscribe(self._h, topic.encode(), queue_size)

    def publish(self, topic: str, stamp_s: float, payload: bytes) -> None:
        buf = np.frombuffer(payload, dtype=np.uint8)
        self._lib.bus_publish(self._h, topic.encode(), int(stamp_s * 1e9),
                              _ptr(np.ascontiguousarray(buf)), len(payload))

    def poll(self, sub_id: int, max_len: int = 1 << 20):
        """Dequeue one message; None if the queue is empty.

        Raises ``BufferError`` when the head message exceeds ``max_len``
        (the C layer returns -2 and leaves it queued): returning None there
        would make every drain loop spin forever on the oversized message."""
        stamp = np.empty(1, np.int64)
        buf = np.empty(max_len, np.uint8)
        n = self._lib.bus_poll(self._h, sub_id, _ptr(stamp), _ptr(buf), max_len)
        if n == -2:
            raise BufferError(f"queued message exceeds max_len={max_len}; retry poll() "
                              "with a larger buffer")
        if n < 0:
            return None
        return float(stamp[0]) / 1e9, bytes(buf[:n].tobytes())

    def pending(self, sub_id: int) -> int:
        return self._lib.bus_pending(self._h, sub_id)

    def __del__(self):
        try:
            self._lib.bus_destroy(self._h)
        except Exception:
            pass
