"""ctypes bindings for the native STRUCTURE tokenizer
(csrc/host/structure_reader.cpp).

io/hostlib.py builds the shared object on first use when a host compiler is
present; callers
fall back to the pure-Python parser when unavailable (read_structure_raw
handles the fallback - never a hard dependency).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np

from multiclust_tpu_torch.io import hostlib

_lib = None


class _McParse(ctypes.Structure):
    _fields_ = [
        ("n_rows", ctypes.c_int64),
        ("n_cols", ctypes.c_int64),
        ("header_cols", ctypes.c_int64),
        ("skipped_distances", ctypes.c_int32),
        ("error", ctypes.c_int32),
        ("err_msg", ctypes.c_char * 256),
        ("data", ctypes.POINTER(ctypes.c_int64)),
        ("blob", ctypes.POINTER(ctypes.c_char)),
        ("blob_len", ctypes.c_int64),
    ]


class _McScan(ctypes.Structure):
    _fields_ = [
        ("n_rows", ctypes.c_int64),
        ("header_cols", ctypes.c_int64),
        ("skipped_distances", ctypes.c_int32),
        ("error", ctypes.c_int32),
        ("err_msg", ctypes.c_char * 256),
        ("name0", ctypes.c_char * 256),
        ("name1", ctypes.c_char * 256),
    ]


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is None:
        lib = hostlib.load("structure_reader")
        if lib is None:
            return None
        lib.mc_parse_structure.restype = ctypes.POINTER(_McParse)
        lib.mc_parse_structure.argtypes = [ctypes.c_char_p]
        lib.mc_parse_structure_range.restype = ctypes.POINTER(_McParse)
        lib.mc_parse_structure_range.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64]
        lib.mc_scan_structure.restype = ctypes.POINTER(_McScan)
        lib.mc_scan_structure.argtypes = [ctypes.c_char_p]
        lib.mc_free.argtypes = [ctypes.POINTER(_McParse)]
        lib.mc_free.restype = None
        lib.mc_free_scan.argtypes = [ctypes.POINTER(_McScan)]
        lib.mc_free_scan.restype = None
        _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def scan_file(path: str) -> Tuple[int, int, bool, str, str]:
    """Metadata pass (native mc_scan_structure): returns (n_data_rows,
    header_cols, skipped_distance_line, name0, name1) where name0/name1
    are the first two data-row names (interleave autodetection,
    read_file.c:89-95).  Numeric payloads are never materialized -
    memory is O(chunk) regardless of file size."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native reader unavailable")
    handle = lib.mc_scan_structure(path.encode())
    if not handle:
        raise MemoryError("mc_scan_structure failed")
    try:
        s = handle.contents
        if s.error:
            raise ValueError(s.err_msg.decode(errors="replace"))
        return (int(s.n_rows), int(s.header_cols),
                bool(s.skipped_distances),
                s.name0.decode(errors="replace"),
                s.name1.decode(errors="replace"))
    finally:
        lib.mc_free_scan(handle)


def parse_file(path: str, row_range: Optional[Tuple[int, int]] = None
               ) -> Tuple[int, List[str], List[str], np.ndarray, bool]:
    """Returns (header_cols, names, locales, data[n_rows, n_cols],
    skipped_distance_line).  Raises on parse errors or when the native
    library is unavailable.

    ``row_range=(lo, hi)`` materializes only data rows [lo, hi) - the
    per-process ingestion primitive for multi-host runs (parsing stops
    at hi, memory stays O(range))."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native reader unavailable")
    if row_range is None:
        handle = lib.mc_parse_structure(path.encode())
    else:
        handle = lib.mc_parse_structure_range(
            path.encode(), int(row_range[0]), int(row_range[1]))
    if not handle:
        raise MemoryError("mc_parse_structure failed")
    try:
        h = handle.contents
        if h.error:
            raise ValueError(h.err_msg.decode(errors="replace"))
        n = int(h.n_rows) * int(h.n_cols)
        data = np.ctypeslib.as_array(h.data, shape=(n,)).copy() \
            .reshape(int(h.n_rows), int(h.n_cols)) \
            if n else np.empty((0, 0), np.int64)
        blob = ctypes.string_at(h.blob, h.blob_len) if h.blob_len else b""
        toks = blob.split(b"\0")[:-1] if blob else []
        names = [t.decode(errors="replace") for t in toks[0::2]]
        locales = [t.decode(errors="replace") for t in toks[1::2]]
        return (int(h.header_cols), names, locales, data,
                bool(h.skipped_distances))
    finally:
        lib.mc_free(handle)
