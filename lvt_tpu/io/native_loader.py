"""ctypes bindings for the native C++ data loader (PNG decode + prefetch).

The shared library is built from lvt_tpu/native/png_loader.cpp by `make`
in that directory on first use in each process (a no-op when it is up to
date), so a library left in the tree never stands in for the committed
sources. All entry points degrade gracefully: callers fall back to OpenCV
if the native loader is unavailable (lvt_tpu.io.datasets.imread_gray).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "liblvt_native.so")

_lib = None
_lib_lock = threading.Lock()
_build_attempted = False


def _load_library():
    global _lib, _build_attempted
    with _lib_lock:
        if _lib is not None or _build_attempted:
            return _lib
        _build_attempted = True
        try:
            subprocess.run(
                ["make", "-s", "liblvt_native.so"], cwd=_NATIVE_DIR,
                check=True, capture_output=True, timeout=120,
            )
        except (OSError, subprocess.SubprocessError):
            return None
        lib = ctypes.CDLL(_LIB_PATH)
        lib.lvt_png_probe.argtypes = [
            ctypes.c_char_p] + [ctypes.POINTER(ctypes.c_int)] * 4
        lib.lvt_png_probe.restype = ctypes.c_int
        lib.lvt_png_read.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
        lib.lvt_png_read.restype = ctypes.c_int
        lib.lvt_png_read_gray.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
        lib.lvt_png_read_gray.restype = ctypes.c_int
        lib.lvt_png_read_gray_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int]
        lib.lvt_png_read_gray_batch.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return _load_library() is not None


def probe(path: str):
    """(width, height, channels, bit_depth) or None."""
    lib = _load_library()
    if lib is None:
        return None
    w = ctypes.c_int()
    h = ctypes.c_int()
    c = ctypes.c_int()
    b = ctypes.c_int()
    if lib.lvt_png_probe(path.encode(), ctypes.byref(w), ctypes.byref(h),
                         ctypes.byref(c), ctypes.byref(b)) != 0:
        return None
    return w.value, h.value, c.value, b.value


def imread_gray_native(path: str) -> np.ndarray | None:
    """8-bit grayscale decode via the native loader, or None."""
    lib = _load_library()
    if lib is None or not path.lower().endswith(".png"):
        return None
    info = probe(path)
    if info is None:
        return None
    w, h, _, _ = info
    out = np.empty((h, w), np.uint8)
    rc = lib.lvt_png_read_gray(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.size,
    )
    return out if rc == 0 else None


def imread_native(path: str) -> np.ndarray | None:
    """Full-fidelity decode (any supported channels/bit depth), or None."""
    lib = _load_library()
    if lib is None or not path.lower().endswith(".png"):
        return None
    info = probe(path)
    if info is None:
        return None
    w, h, c, bits = info
    dtype = np.uint16 if bits == 16 else np.uint8
    shape = (h, w) if c == 1 else (h, w, c)
    out = np.empty(shape, dtype)
    rc = lib.lvt_png_read(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.nbytes,
    )
    return out if rc == 0 else None


def imread_gray_batch(paths: list[str], width: int, height: int,
                      n_threads: int = 0) -> np.ndarray | None:
    """Threaded batch decode -> [N, H, W] uint8 (the chunk-prefetch path)."""
    lib = _load_library()
    if lib is None:
        return None
    n = len(paths)
    out = np.empty((n, height, width), np.uint8)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    rc = lib.lvt_png_read_gray_batch(
        arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        width * height, n_threads,
    )
    return out if rc == 0 else None
