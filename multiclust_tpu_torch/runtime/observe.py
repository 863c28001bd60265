"""Observability (multiclust_tpu/runtime/observe.py): per-iteration traces,
a throughput meter, and a profiler context.

The reference's tracing surface: one line per EM iteration with the logL,
the step kind and the logL delta at verbosity > MINIMAL (stop,
em_alg.c:123-136).  Added: an iterations/s and genotype-cells/s meter and
a ``torch.profiler`` context.
"""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Optional

from multiclust_tpu_torch.messages import Verbosity

MINIMAL = Verbosity.MINIMAL  # message.h:45-53


def make_trace_printer(verbosity: int, out=None):
    """Per-iteration trace in the reference's format
    ('%4d (EM): %.2f (delta): %.5g', em_alg.c:123-136), a
    ``trace(logL, n_iter, kind)`` for opt/driver.fit; None when the
    verbosity gates it off."""
    if verbosity <= MINIMAL:
        return None
    out = out or sys.stderr
    last = {"ll": None}

    def trace(ll: float, n_iter: int, kind: str = "EM") -> None:
        prev = last["ll"]
        delta = float("inf") if prev is None else ll - prev
        out.write("%4d (%s): %.2f (delta): %.5g\n" % (n_iter, kind, ll,
                                                        delta))
        last["ll"] = ll

    return trace


class ThroughputMeter:
    """EM iterations/s and genotype-cells/s per device; the caller
    synchronizes the device before it reads a rate."""

    def __init__(self, cells_per_iter: int, n_devices: int = 1):
        self.cells_per_iter = cells_per_iter
        self.n_devices = max(n_devices, 1)
        self.n_iter = 0
        self.t0 = time.perf_counter()

    def update(self, n_iter: int):
        self.n_iter = n_iter

    @property
    def seconds(self) -> float:
        return time.perf_counter() - self.t0

    @property
    def iters_per_sec(self) -> float:
        return self.n_iter / max(self.seconds, 1e-9)

    @property
    def cells_per_sec_per_device(self) -> float:
        return self.iters_per_sec * self.cells_per_iter / self.n_devices

    def report(self) -> str:
        return (f"{self.n_iter} EM iterations in {self.seconds:.2f}s = "
                f"{self.iters_per_sec:.1f} it/s, "
                f"{self.cells_per_sec_per_device:.3e} cells/s/device")


@contextlib.contextmanager
def profile(log_dir: Optional[str]):
    """``torch.profiler`` trace of the host and, where there is one, the
    CUDA device, written as a Chrome trace into ``log_dir`` (no-op when
    ``log_dir`` is falsy)."""
    if not log_dir:
        yield None
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
