"""ctypes bindings for the native trace-IO runtime (native/bfmmm_io.cpp).

Auto-builds ``libbfmmm_io.so`` with g++ on first use; every entry point has
a pure-Python fallback (io/armaio.py) so the package works without a
toolchain.  The async writer overlaps trace persistence with device compute
— the reference blocks its sampling loop on synchronous arma::save calls
(BFMMM.h:1720-1730).

The port's own copy of ``bayesfmmm_tpu/io/native.py``: the library is host
IO shared by both packages and its fallback hides no device work.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_LIB = None
_TRIED = False


def _native_dir():
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))), "native")


def _load():
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    so = os.path.join(_native_dir(), "libbfmmm_io.so")
    if not os.path.exists(so):
        try:
            subprocess.run(["make", "-C", _native_dir()], check=True,
                           capture_output=True, timeout=120)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    lib.bfmmm_read_arma_ascii.restype = ctypes.POINTER(ctypes.c_double)
    lib.bfmmm_read_arma_ascii.argtypes = [ctypes.c_char_p,
                                          ctypes.c_long * 3]
    lib.bfmmm_free.argtypes = [ctypes.POINTER(ctypes.c_double)]
    lib.bfmmm_write_arma_ascii.restype = ctypes.c_int
    lib.bfmmm_write_arma_ascii.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_double), ctypes.c_long,
        ctypes.c_long, ctypes.c_long]
    lib.bfmmm_writer_create.restype = ctypes.c_void_p
    lib.bfmmm_writer_submit.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_double),
        ctypes.c_long, ctypes.c_long, ctypes.c_long]
    lib.bfmmm_writer_flush.restype = ctypes.c_long
    lib.bfmmm_writer_flush.argtypes = [ctypes.c_void_p]
    lib.bfmmm_writer_completed.restype = ctypes.c_long
    lib.bfmmm_writer_completed.argtypes = [ctypes.c_void_p]
    lib.bfmmm_writer_destroy.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def read_arma_ascii(path: str):
    """Fast path for ARMA_MAT_TXT / ARMA_CUB_TXT; falls back to armaio."""
    lib = _load()
    if lib is None:
        from bayesfmmm_torch.io import armaio
        return armaio.load_arma(path, prefer_native=False)
    dims = (ctypes.c_long * 3)()
    ptr = lib.bfmmm_read_arma_ascii(path.encode(), dims)
    if not ptr:
        from bayesfmmm_torch.io import armaio
        return armaio.load_arma(path, prefer_native=False)
    rows, cols, slices = dims[0], dims[1], dims[2]
    n = rows * cols * slices
    arr = np.ctypeslib.as_array(ptr, shape=(n,)).copy()
    lib.bfmmm_free(ptr)
    if slices > 1:
        return arr.reshape(slices, rows, cols)
    return arr.reshape(rows, cols)


def write_arma_ascii(path: str, arr: np.ndarray) -> None:
    lib = _load()
    arr = np.ascontiguousarray(np.asarray(arr, dtype=np.float64))
    if lib is None:
        from bayesfmmm_torch.io import armaio
        if arr.ndim == 3:
            armaio.save_arma_cube(path, arr)
        else:
            armaio.save_arma_matrix(path, np.atleast_2d(arr))
        return
    if arr.ndim == 3:
        s, r, c = arr.shape
        slices = s
    else:
        arr = np.atleast_2d(arr)
        r, c = arr.shape
        slices = 0
    rc = lib.bfmmm_write_arma_ascii(
        path.encode(), arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        r, c, slices)
    if rc != 0:
        raise IOError(f"native write failed ({rc}) for {path}")


class AsyncTraceWriter:
    """Background-thread batch writer (no-op fallback = synchronous)."""

    def __init__(self):
        self._lib = _load()
        self._h = self._lib.bfmmm_writer_create() if self._lib else None

    def submit(self, path: str, arr: np.ndarray) -> None:
        arr = np.ascontiguousarray(np.asarray(arr, dtype=np.float64))
        if self._h is None:
            write_arma_ascii(path, arr)
            return
        if arr.ndim == 3:
            s, r, c = arr.shape
            slices = s
        else:
            arr = np.atleast_2d(arr)
            r, c = arr.shape
            slices = 0
        self._lib.bfmmm_writer_submit(
            self._h, path.encode(),
            arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), r, c, slices)

    def flush(self) -> int:
        if self._h is None:
            return 0
        return int(self._lib.bfmmm_writer_flush(self._h))

    def close(self) -> None:
        if self._h is not None:
            self._lib.bfmmm_writer_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
