"""Build, bind and count the port's CUDA kernels.

The sources under ``multiclust_tpu_torch/csrc/`` are compiled with nvcc for
``sm_90a`` at first use (one nvcc per source, run concurrently, then one
link) into one shared library with a plain C interface
(``multiclust_tpu_torch/build/``, named by a hash of the sources so an
edited source rebuilds), loaded with ctypes.  Every launch goes through
``launch``, which runs on PyTorch's current stream, raises on a nonzero
``cudaGetLastError()`` and counts the launch by kernel name.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong

# argtypes of every exported launcher; each returns a cudaError_t as int
_SIGNATURES = {
    "mc_fullstep_bi_rows": [_P, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _F, _I, _I, _I, _P],
    "mc_fullstep_bi_rows_seg": [_P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                _P, _I, _P],
    "mc_fullstep_bi_finish": [_P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _F, _I, _I, _I, _I, _P],
    "mc_fullstep_bi_cols": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _I,
                            _P, _I, _P],
    "mc_fullstep_bi_p0": [_P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _I, _I, _I, _F, _F, _I, _P],
    "mc_fullstep_bi_window": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                              _I, _I, _P],
    "mc_fullstep_rows": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I, _I,
                         _P, _I, _I, _P],
    "mc_fullstep_cols": [_P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _I, _I, _I, _P, _I, _P],
    "mc_fullstep_p": [_P, _P, _P, _P, _P,
                      _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P],
    "mc_fullstep_step": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I,
                         _I, _I, _I, _I, _I, _P],
    "mc_mix_rows": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                    _I, _I, _I, _I, _I, _I, _P],
    "mc_mix_cols": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "mc_mix_finish": [_P, _P, _P, _P, _P, _P, _P,
                      _I, _I, _I, _I, _I, _I, _I, _F, _F, _F, _F, _I, _I,
                      _I, _I, _P],
    "mc_allele_counts": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _LL, _LL, _I,
                         _P],
    "mc_allele_counts_planes": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _LL,
                                _LL, _P],
}

# Launches counted under a name of their own as well as the launcher's
# (``launch(..., also=)``): a loop of launches that is a kernel of its own
# in the JAX package (the chunked biallelic step), once per window, where
# the loop launches the window's rows pass; and the wide kernels (128 <
# Kp <= 1024), which run behind the launchers of the narrow ones: of
# csrc/wide.cuh the rows pass (its d and A launches; both steps), its
# finish (both steps; not the t-only finish, which takes any Kp), the
# biallelic and the generic columns pass (a launcher that runs both
# passes on one d, mc_fullstep_bi_window or mc_fullstep_step, counts
# each); of csrc/mixture_bi.cu the mixture's rows pass (its scores
# and its softmax, one call of the launcher), columns pass and finish
# (either half alone too); and the launches that read a runtime lane mask
# (``Params.kmask``: one [Kp] mask, or a row a chain of a mixed-K
# lattice): the pair's rows pass, the rows finish and the wide finish
# where they project eta, the generic p epilogue, the mixture's rows pass
# at most 128 lanes and its softmax launch above, and the mixture finish
# where its eta half runs
EXTRA_COUNTS = ("fullstep_bi_chunked", "wide_rows", "wide_finish",
                "wide_cols_bi", "wide_cols_generic", "wide_mix_rows",
                "wide_mix_cols", "wide_mix_finish", "masked_pair_rows",
                "masked_rows_finish", "masked_wide_finish", "masked_p",
                "masked_mix_rows", "masked_mix_softmax",
                "masked_mix_finish")

# The spans of a fit (runtime/observe.span), and the program's counters,
# kept in LAUNCHES beside the launches under dotted names that no kernel
# has (``kernel_launches`` leaves them out): the model steps and
# chain-steps of EM (``em.``) and of Rand-EM's scoring of its candidate
# starts (``init.``), counted in opt/em.model_em_step by the chains of the
# batch stepped; the windows of loci an admixture start counts
# (``init.windows``); the host's reads of a device value (``host.syncs``)
# and its queries of the device's free memory (``host.mem_queries``),
# counted where they are made; and, from a fit run under a profiler, each
# span's summed stream time in whole microseconds (``span_us.<span>``) and
# its count (``span_n.<span>``); the start's counts (``mc.init.counts``)
# lie inside ``mc.init``.  reset_launch_counts zeroes them too.
SPANS = ("mc.fit", "mc.plan", "mc.init", "mc.init.counts", "mc.em",
         "mc.harvest")
COUNTERS = ("em.model_steps", "em.chain_steps", "init.model_steps",
            "init.chain_steps", "init.windows", "host.syncs",
            "host.mem_queries") + tuple(
                f"span_{what}.{span}" for what in ("us", "n")
                for span in SPANS)

# launches per kernel, and the counters, since the last
# reset_launch_counts()
LAUNCHES: Dict[str, int] = {
    name: 0 for name in tuple(_SIGNATURES) + EXTRA_COUNTS + COUNTERS}

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC_DIR.glob("*.cu*")):   # sources and headers
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmulticlust_kernels_{h.hexdigest()[:16]}.so"


def _run(cmds):
    """Run the commands concurrently; (returncode, output) of each."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    results = []
    for p in procs:
        text = p.communicate()[0]
        results.append((p.returncode, text))
    return results


def build() -> Path:
    """Compile csrc/*.cu into the shared library unless it exists: one
    nvcc per source, all started together, then one link."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # compile into a temporary directory in the build dir, then rename the
    # library: a concurrent or interrupted build never leaves a partial one
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / (s.stem + ".o")) for s in _sources()]
        results = _run([
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-c", "-Xcompiler", "-fPIC",
             "-Xptxas", "-v", "-o", o, str(s)]
            for s, o in zip(_sources(), objs)])
        report = "".join(text for _, text in results)
        if any(rc != 0 for rc, _ in results):
            raise RuntimeError("nvcc failed:\n" + report)
        lib = str(Path(tmp) / "lib.so")
        [(rc, text)] = _run([[nvcc, "-shared", "-o", lib] + objs])
        if rc != 0:
            raise RuntimeError("nvcc link failed:\n" + text)
        os.replace(lib, out)
    # nvcc's -Xptxas -v report: registers, shared memory, spills
    out.with_suffix(".ptxas.txt").write_text(report)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        # the kernels' own tile arithmetic, for the tests of its mirror
        lib.mc_fullstep_bi_tiles.argtypes = [_I, _I] + [
            ctypes.POINTER(ctypes.c_int)] * 4
        lib.mc_fullstep_bi_tiles.restype = None
        lib.mc_wide_cols_tiles.argtypes = [_I] + [
            ctypes.POINTER(ctypes.c_int)] * 6
        lib.mc_wide_cols_tiles.restype = None
        lib.mc_mix_tiles.argtypes = [_I, _I] + [
            ctypes.POINTER(ctypes.c_int)] * 3
        lib.mc_mix_tiles.restype = ctypes.c_int
        lib.mc_error_string.argtypes = [ctypes.c_int]
        lib.mc_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def kernel_tiles(lib: ctypes.CDLL, k_true: int, Kp: int):
    """(kc, rows of a rows-pass block, columns of a columns-pass block,
    rows of a columns-pass tile) as ``lib``'s mc_fullstep_bi_tiles has
    them: the tiles of csrc/tiles.cuh, which the biallelic and the generic
    kernels share."""
    out = [ctypes.c_int() for _ in range(4)]
    lib.mc_fullstep_bi_tiles(k_true, Kp, *(ctypes.byref(o) for o in out))
    return tuple(o.value for o in out)


def wide_cols_tiles(lib: ctypes.CDLL, generic: bool):
    """(columns of a B-launch block, rows of its stage, lanes of a chunk
    at most, rows and columns of a d-launch tile, lanes of a d stage) of
    the wide columns pass for the biallelic or the generic cells, as
    ``lib``'s mc_wide_cols_tiles has them (csrc/wide.cuh)."""
    out = [ctypes.c_int() for _ in range(6)]
    lib.mc_wide_cols_tiles(int(generic), *(ctypes.byref(o) for o in out))
    return tuple(o.value for o in out)


def mixture_tiles(lib: ctypes.CDLL, Kp: int, two: bool):
    """(loci of a block, rows of a stage, blocks an SM of the current
    device holds) of the mixture columns pass as ``lib``'s mc_mix_tiles
    has them (csrc/mixture_bi.cu, ColsTile, and the occupancy of the
    compiled kernel)."""
    out = [ctypes.c_int() for _ in range(3)]
    err = lib.mc_mix_tiles(Kp, int(two), *(ctypes.byref(o) for o in out))
    if err != 0:
        raise RuntimeError(f"mc_mix_tiles(Kp={Kp}): "
                           f"{lib.mc_error_string(err).decode()}")
    return tuple(o.value for o in out)


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """A tensor's device pointer, or None (a null pointer) for no tensor."""
    return None if t is None else t.data_ptr()


def launch(name: str, device: torch.device, *args,
           also: Tuple[str, ...] = ()) -> None:
    """Launch kernel ``name`` on ``device``'s current stream and count it,
    and each of the EXTRA_COUNTS in ``also``.

    ``args`` are the launcher's arguments without the trailing stream."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.mc_error_string(err).decode()}")
    LAUNCHES[name] += 1
    for kernel in also:
        LAUNCHES[kernel] += 1


def kernel_launches() -> Dict[str, int]:
    """LAUNCHES by kernel name, without the program's COUNTERS."""
    return {name: n for name, n in LAUNCHES.items() if name not in COUNTERS}


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (one of COUNTERS)."""
    LAUNCHES[name] += n


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
