"""ctypes binding for the native columnar event store (evstore.cpp).

Compiled on first use with g++ (cached next to the source); all
functionality has a pure-Python fallback in sxmc_jax.io.loaders, so the
package works without a toolchain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional, Sequence, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "evstore.cpp")
_LIB = os.path.join(_DIR, "_evstore.so")

_lib = None
_lib_error: Optional[str] = None


def _build() -> None:
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", _SRC,
           "-o", _LIB]
    subprocess.run(cmd, check=True, capture_output=True)


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _lib_error
    if _lib is not None or _lib_error is not None:
        return _lib
    try:
        if (not os.path.exists(_LIB) or
                os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
            _build()
        lib = ctypes.CDLL(_LIB)
    except Exception as e:  # no compiler / load failure -> fallback
        _lib_error = str(e)
        return None

    lib.sxnt_write.restype = ctypes.c_int
    lib.sxnt_write.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_uint64,
        ctypes.c_uint32, ctypes.POINTER(ctypes.c_char_p)]
    lib.sxnt_open.restype = ctypes.c_void_p
    lib.sxnt_open.argtypes = [ctypes.c_char_p]
    lib.sxnt_close.argtypes = [ctypes.c_void_p]
    lib.sxnt_nrows.restype = ctypes.c_uint64
    lib.sxnt_nrows.argtypes = [ctypes.c_void_p]
    lib.sxnt_nfields.restype = ctypes.c_uint32
    lib.sxnt_nfields.argtypes = [ctypes.c_void_p]
    lib.sxnt_field_name.restype = ctypes.c_int
    lib.sxnt_field_name.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32, ctypes.c_char_p,
        ctypes.c_uint32]
    lib.sxnt_read_all.restype = ctypes.c_int
    lib.sxnt_read_all.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
    lib.sxnt_select.restype = ctypes.c_int64
    lib.sxnt_select.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_uint32, ctypes.c_float,
        ctypes.POINTER(ctypes.c_float)]
    _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


def write_sxnt(path: str, data: np.ndarray,
               fields: Sequence[str]) -> None:
    """Write a row-major float table as an SXNT file."""
    lib = get_lib()
    data = np.ascontiguousarray(data, np.float32)
    nrows, nfields = data.shape
    if lib is None:
        raise RuntimeError(f"native evstore unavailable: {_lib_error}")
    names = (ctypes.c_char_p * nfields)(
        *[f.encode() for f in fields])
    rc = lib.sxnt_write(
        path.encode(), data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        nrows, nfields, names)
    if rc != 0:
        raise IOError(f"sxnt_write failed: {rc}")


class EventStore:
    """mmap-backed SXNT reader with native cut/selection."""

    def __init__(self, path: str):
        lib = get_lib()
        if lib is None:
            raise RuntimeError(
                f"native evstore unavailable: {_lib_error}")
        self._lib = lib
        self._h = lib.sxnt_open(path.encode())
        if not self._h:
            raise IOError(f"cannot open SXNT file: {path}")
        self.nrows = int(lib.sxnt_nrows(self._h))
        self.nfields = int(lib.sxnt_nfields(self._h))
        self.fields: List[str] = []
        buf = ctypes.create_string_buffer(256)
        for i in range(self.nfields):
            lib.sxnt_field_name(self._h, i, buf, 256)
            self.fields.append(buf.value.decode())

    def close(self):
        if self._h:
            self._lib.sxnt_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def read_all(self) -> np.ndarray:
        out = np.empty((self.nrows, self.nfields), np.float32)
        rc = self._lib.sxnt_read_all(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc != 0:
            raise IOError(f"sxnt_read_all failed: {rc}")
        return out

    def select(
        self,
        sel_fields: Sequence[str],
        cuts: Sequence[Tuple[str, float, float]] = (),
        dataset_tag: float = 0.0,
    ) -> np.ndarray:
        """Native cuts + column mapping + DATASET tag column.

        The native analog of Signal.read_dataset_to_samples
        (reference: signal.cpp:50-109): rows pass iff
        ``lo <= value <= hi`` for every cut.
        """
        sel_idx = np.asarray(
            [self.fields.index(f) for f in sel_fields], np.uint32)
        cut_idx = np.asarray(
            [self.fields.index(c[0]) for c in cuts], np.uint32)
        cut_lo = np.asarray([c[1] for c in cuts], np.float32)
        cut_hi = np.asarray([c[2] for c in cuts], np.float32)
        out = np.empty((self.nrows, len(sel_fields) + 1), np.float32)

        def ptr(a, ty):
            if a.size == 0:
                return None
            return a.ctypes.data_as(ctypes.POINTER(ty))

        n = self._lib.sxnt_select(
            self._h, ptr(sel_idx, ctypes.c_uint32), len(sel_fields),
            ptr(cut_idx, ctypes.c_uint32), ptr(cut_lo, ctypes.c_float),
            ptr(cut_hi, ctypes.c_float), len(cuts),
            ctypes.c_float(dataset_tag),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if n < 0:
            raise IOError(f"sxnt_select failed: {n}")
        return out[:n]
