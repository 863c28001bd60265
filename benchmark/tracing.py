"""The reduction of a ``torch.profiler`` trace to what the benchmark reports.

The traced sub-window runs whole fits, each inside a span of the
benchmark's own (``torch.profiler.record_function``): ``bench.fit`` around
``fit_model_data`` (the program's init, EM and harvest) and
``bench.record`` around the benchmark's reading of the result.  The
window is from the first span's start to the last span's end.  Device
operations are the trace's CUDA events (kernels, copies, sets); the
device is busy where one of them runs, and idle elsewhere in the window.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

SPANS = ("bench.fit", "bench.record")
TOP = 10
NAME_CHARS = 120


@dataclasses.dataclass
class Interval:
    start: float   # seconds, the trace's clock
    end: float
    name: str


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernel_s: float                      # summed kernel durations
    device_ops: List[Tuple[str, float]]  # by summed time, at most TOP
    idle_gaps: List[Tuple[str, float]]   # the longest, at most TOP
    n_device_ops: int


def merge(intervals: List[Interval]) -> List[Tuple[float, float]]:
    """The union of the intervals, as sorted disjoint (start, end)."""
    out: List[Tuple[float, float]] = []
    for iv in sorted(intervals, key=lambda v: v.start):
        if out and iv.start <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], iv.end))
        else:
            out.append((iv.start, iv.end))
    return out


def _innermost(cpu: List[Interval], t: float) -> str:
    best = None
    for iv in cpu:
        if iv.start <= t < iv.end and (best is None
                                        or iv.end - iv.start
                                        < best.end - best.start):
            best = iv
    return best.name if best is not None else "python"


def summarize(device: List[Interval], spans: List[Interval],
              cpu: List[Interval]) -> TraceSummary:
    """Busy and idle time of the window the spans cover, the device
    operations that took most time, and the longest idle gaps, each named
    by the benchmark's span open at its middle and the innermost host
    operation running then ("python" where none was)."""
    w0 = min(s.start for s in spans)
    w1 = max(s.end for s in spans)
    inside = [Interval(max(d.start, w0), min(d.end, w1), d.name)
              for d in device if d.end > w0 and d.start < w1]
    busy = merge(inside)
    busy_s = sum(b - a for a, b in busy)
    by_name: dict = {}
    for d in inside:
        key = d.name[:NAME_CHARS]
        by_name[key] = by_name.get(key, 0.0) + (d.end - d.start)
    gaps = []
    cursor = w0
    for a, b in busy + [(w1, w1)]:
        if a > cursor:
            gaps.append((cursor, a))
        cursor = max(cursor, b)
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for a, b in gaps[:TOP]:
        mid = 0.5 * (a + b)
        span = next((s.name for s in spans if s.start <= mid < s.end),
                    "bench")
        named.append((f"{span}:{_innermost(cpu, mid)[:NAME_CHARS]}", b - a))
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return TraceSummary(window_s=w1 - w0, busy_s=busy_s,
                        kernel_s=sum(d.end - d.start for d in inside),
                        device_ops=ops, idle_gaps=named,
                        n_device_ops=len(inside))


def from_profiler(prof) -> TraceSummary:
    """``summarize`` of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    device, spans, cpu = [], [], []
    for e in prof.events():
        iv = Interval(e.time_range.start * 1e-6, e.time_range.end * 1e-6,
                      e.name)
        if e.name in SPANS:
            # the span itself, and its mark on the device's timeline
            if e.device_type != DeviceType.CUDA:
                spans.append(iv)
        elif e.device_type == DeviceType.CUDA:
            device.append(iv)
        else:
            cpu.append(iv)
    if not spans:
        raise RuntimeError("the trace holds none of the benchmark's spans")
    return summarize(device, spans, cpu)
