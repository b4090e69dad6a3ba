"""Native (C++) host components, bound via ctypes.

A copy of ``pytorch_yolo_tpu/native`` for the port: ``weights_loader.cpp``
reads a Darknet ``.weights`` file by mmap and folds BatchNorm into OIHW
kernels (the port's layout) on a small thread pool.  It is built with
``g++`` at first use into ``native/_build/`` (no pybind11: a plain C
interface loaded with ``ctypes``).  This is a host loader, not a device
kernel: ``weights.load_weights(native=None)`` falls back to numpy when the
toolchain or the library is unavailable, and ``native=True`` raises then.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

log = logging.getLogger(__name__)

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "weights_loader.cpp")
_SO = os.path.join(_DIR, "_build", "libpyt_native.so")
_lock = threading.Lock()
_lib: "ctypes.CDLL | None | bool" = None  # None = untried, False = unavailable


class LayerDescStruct(ctypes.Structure):
    """``LayerDesc`` of weights_loader.cpp, field for field."""

    _fields_ = [
        ("filters", ctypes.c_int32),
        ("in_channels", ctypes.c_int32),
        ("size", ctypes.c_int32),
        ("batch_normalize", ctypes.c_int32),
        ("stream_offset", ctypes.c_int64),
        ("out_w", ctypes.POINTER(ctypes.c_float)),
        ("out_b", ctypes.POINTER(ctypes.c_float)),
    ]


def _is_fresh(so: str) -> bool:
    """True if the built .so is at least as new as its source file (a
    missing source, as in a binary-only deployment, counts as fresh)."""
    if not os.path.exists(_SRC):
        return True
    try:
        return os.path.getmtime(so) >= os.path.getmtime(_SRC)
    except OSError:
        return False


def ensure_built(force: bool = False) -> "str | None":
    """Compile the native library if it is missing or older than its
    source; returns its path, or None when g++ is missing or fails.  The
    library is written under a temporary name and renamed into place, so
    processes that build at once never load a half-written file."""
    if os.path.exists(_SO) and _is_fresh(_SO) and not force:
        return _SO
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", "-pthread", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        log.debug("native build failed: %s", e)
        return None
    os.replace(tmp, _SO)
    return _SO


def load_library(build: bool = True) -> "ctypes.CDLL | None":
    """ctypes handle to the native library (builds it on first use)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib or None
        if os.path.exists(_SO) and _is_fresh(_SO):
            path = _SO
        else:
            path = ensure_built() if build else None
        if path is None:
            _lib = False
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            log.debug("native load failed: %s", e)
            _lib = False
            return None
        lib.pyt_load_weights.restype = ctypes.c_int
        lib.pyt_load_weights.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(LayerDescStruct), ctypes.c_int,
            ctypes.c_int64, ctypes.c_int]
        lib.pyt_probe.restype = ctypes.c_int
        lib.pyt_probe.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint64)]
        lib.pyt_strerror.restype = ctypes.c_char_p
        lib.pyt_strerror.argtypes = [ctypes.c_int]
        _lib = lib
        return lib
