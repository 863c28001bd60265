"""ctypes bindings for the native numeric-table writer
(csrc/host/table_writer.cpp, built at first use by io/hostlib.py).

Covers the large per-K estimate tables (.etaik / .pklm,
write_file_detail write_file.c:203-335): the engine rewrites them on
every best-so-far improvement (multiclust.c:584-600), and at biobank
scale the .pklm table is tens of millions of rows - a pure-Python
formatting loop is far slower than ``mc_write_table`` (byte-identical
"%d"/"%f" output).

Falls back silently: ``write_table`` raises when the native library is
unavailable and callers keep their Python loop.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from multiclust_tpu_torch.io import hostlib

_lib: Optional[ctypes.CDLL] = None


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is None:
        lib = hostlib.load("table_writer")
        if lib is None:
            return None
        lib.mc_write_table.restype = ctypes.c_int
        lib.mc_write_table.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_double)]
        _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def write_table(path: str, header: str, trailer: str,
                ints: np.ndarray, floats: np.ndarray) -> None:
    """Write ``header`` + rows of tab-separated int64 columns followed by
    "%f" double columns + ``trailer``.  ``ints`` [n_rows, n_int] int64,
    ``floats`` [n_rows, n_f] float64, both C-contiguous."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native table writer unavailable")
    ints = np.ascontiguousarray(ints, dtype=np.int64)
    floats = np.ascontiguousarray(floats, dtype=np.float64)
    assert ints.ndim == 2 and floats.ndim == 2
    assert ints.shape[0] == floats.shape[0]
    rc = lib.mc_write_table(
        path.encode(), header.encode(), trailer.encode(),
        ints.shape[0], ints.shape[1],
        ints.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        floats.shape[1],
        floats.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if rc == 4:
        raise ValueError(
            f"mc_write_table: a formatted field overflows the width cap "
            f"(value out of supported range) writing {path}")
    if rc != 0:
        raise OSError(f"mc_write_table failed with code {rc} for {path}")
