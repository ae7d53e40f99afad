"""Build ``csrc/*.cu`` into one shared library and bind its C entries.

Route: ``nvcc`` by hand into a library with a plain C interface, loaded with
``ctypes`` (seconds to build, against minutes for a source that includes
PyTorch's headers). Each source compiles to an object in its own ``nvcc``
process, all started together, and one link makes the ``.so``. The library's
name carries a hash of the sources and flags, so a build is reused until a
source changes; it lives in ``heatnet_tpu_torch/_build/`` (listed in
``.gitignore``) and appears atomically, so concurrent processes may race to
build it safely.

Nothing here runs at import: ``import heatnet_tpu_torch`` works on a machine
with no ``nvcc`` and no card. The first launch of a kernel builds and loads.

A wrapper that is traced (``torch.export``, ``torch.compile``; ``tracing``)
does not launch: it calls its op registered in ``ops/library.py``, whose
CUDA implementation launches, and counts, when the traced program runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import List, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("ingest.cu", "grouped_conv3x3.cu", "int8_conv.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin; "
                           "the CUDA kernels cannot be built")
    return path


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        with open(os.path.join(CSRC, src), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libheatnet_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile and link the kernels unless this build exists; return the path.

    ``nvcc``'s output, ``-Xptxas -v``'s registers and spills included, goes
    to ``_build/nvcc.log``. Raises with that output if a step fails.
    """
    so = library_path()
    if os.path.isfile(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tmp = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        objs, procs = [], []
        for src in SOURCES:
            obj = os.path.join(tmp, src + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", os.path.join(CSRC, src), "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for src, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== nvcc {src}\n{out}")
            if proc.returncode != 0:
                failed.append(src)
        if not failed:
            tmp_so = os.path.join(tmp, os.path.basename(so))
            link = subprocess.run(
                [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp_so, *objs],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            log.append(f"== link\n{link.stdout}")
            if link.returncode != 0:
                failed.append("link")
        with open(os.path.join(BUILD_DIR, "nvcc.log"), "w") as f:
            f.write("".join(log))
        if failed:
            raise RuntimeError(f"kernel build failed at {failed}:\n"
                               + "".join(log))
        os.replace(tmp_so, so)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.hn_error_string.argtypes = [ctypes.c_int]
            lib.hn_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


class Kernel:
    """One C entry of the library and the count of its launches.

    Every argument crosses as the declared ctypes type; pointers and the
    stream are ``c_void_p`` so that ctypes never cuts them to 32 bits. The C
    entry returns ``cudaGetLastError()`` after its launch, and a non-zero
    value raises here: a refused launch never runs, and a later
    synchronise would not report it.
    """

    def __init__(self, name: str, symbol: str, argtypes: List):
        self.name = name
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def launch(self, *args) -> None:
        if self._fn is None:
            lib = library()
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            msg = library().hn_error_string(err).decode()
            raise RuntimeError(f"{self.name}: CUDA error {err} ({msg})")
        self.launches += 1


def tracing(t) -> bool:
    """Whether the tensor ``t`` is being traced rather than computed: inside
    ``torch.export`` or ``torch.compile``, or a fake tensor. A wrapper then
    calls its registered op instead of launching (``ops/library.py``)."""
    return torch.compiler.is_compiling() or isinstance(t, FakeTensor)
