"""Build and load the host-side C++ helpers under ``csrc/host/``.

Each helper is one source with a plain C interface, compiled with the
host C++ compiler at first use into ``multiclust_tpu_torch/build/`` (the
library is named by a hash of its source, so an edited source rebuilds)
and loaded with ctypes.  ``load`` returns None when no compiler is found
or the build fails: the callers keep a pure-Python path, so the helpers
are never a hard dependency.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional

PKG_DIR = Path(__file__).resolve().parent.parent
HOST_SRC_DIR = PKG_DIR / "csrc" / "host"
BUILD_DIR = PKG_DIR / "build"

_lock = threading.Lock()
_libs: Dict[str, Optional[ctypes.CDLL]] = {}


def _compiler() -> Optional[str]:
    for cand in ("g++", "c++", "clang++"):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    return None


def _build(stem: str) -> Optional[Path]:
    src = HOST_SRC_DIR / f"{stem}.cpp"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"_{stem}_{digest}.so"
    if out.exists():
        return out
    cxx = _compiler()
    if cxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile beside the target, then rename: a concurrent or interrupted
    # build never leaves a partial library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib = str(Path(tmp) / "lib.so")
        done = subprocess.run(
            [cxx, "-O3", "-std=c++17", "-fPIC", "-shared", "-o", lib,
             str(src)], capture_output=True, timeout=300)
        if done.returncode != 0:
            return None
        os.replace(lib, out)
    return out


def load(stem: str) -> Optional[ctypes.CDLL]:
    """The library built from ``csrc/host/<stem>.cpp``, or None."""
    with _lock:
        if stem not in _libs:
            lib = None
            try:
                path = _build(stem)
                if path is not None:
                    lib = ctypes.CDLL(str(path))
            except (OSError, subprocess.SubprocessError):
                lib = None
            _libs[stem] = lib
        return _libs[stem]
