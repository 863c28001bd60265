"""Observability (multiclust_tpu/runtime/observe.py): per-iteration traces,
and the spans and counters of a fit.

The reference's tracing surface: one line per EM iteration with the logL,
the step kind and the logL delta at verbosity > MINIMAL (stop,
em_alg.c:123-136).

Added: spans at the layer boundaries of a fit (``ops/build.SPANS``), on
exactly when a ``torch.profiler`` session records in the process, as it
is when ``fit`` opens; the whole fit is then traced or not.  Off, a span
is one test of a module-level value.  On, a span opens a host range in the
profiler's timeline that is not a user annotation (so it leaves no mark on
the device's timeline), records an event on the current stream at its
open and at its close (the host clock on a CPU fit), and adds the stream
time between the two, the device work enqueued inside the span and any
idle the host left there, to its name's total.  When the fit closes it
waits for its own close event and adds each name's total, in whole
microseconds, and its count to the counters of ``ops/build.LAUNCHES``
(``span_us.<name>``, ``span_n.<name>``).  A span's children are the spans
opened inside it, as the profiler's timeline nests them.  The counters
(``ops/build.count``) are always on.
"""

from __future__ import annotations

import contextlib
import sys
import time

import torch

from multiclust_tpu_torch.messages import Verbosity
from multiclust_tpu_torch.ops.build import count

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


class _Trace:
    """The spans of one traced fit: (name, open mark, close mark) in the
    order they closed."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.spans = []

    def mark(self):
        if not self.cuda:
            return time.perf_counter_ns()
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(self.device))
        return event

    def write_out(self) -> None:
        """Wait for the last close mark, then add each name's stream time
        and count to the counters."""
        if self.cuda:
            self.spans[-1][2].synchronize()
        total, n = {}, {}
        for name, a, b in self.spans:
            us = 1e3 * a.elapsed_time(b) if self.cuda else (b - a) / 1e3
            total[name] = total.get(name, 0.0) + us
            n[name] = n.get(name, 0) + 1
        for name in total:
            count(f"span_us.{name}", round(total[name]))
            count(f"span_n.{name}", n[name])


# the open traced fit's _Trace; None: spans are off
_trace = None
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "range", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.range = torch._C._profiler._RecordFunctionFast(self.name)
        self.range.__enter__()
        self.t0 = _trace.mark()

    def __exit__(self, *exc):
        _trace.spans.append((self.name, self.t0, _trace.mark()))
        self.range.__exit__(*exc)


def span(name: str):
    """A context for the span ``name`` (one of ops/build.SPANS) of the open
    fit; nothing where the fit is not traced."""
    return _OFF if _trace is None else _Span(name)


@contextlib.contextmanager
def fit(device):
    """The root span ``mc.fit`` of a fit on ``device``, and the fit traced,
    where a profiler records now."""
    global _trace
    if not torch.autograd.profiler._is_profiler_enabled:
        yield
        return
    _trace = _Trace(torch.device(device))
    try:
        with _Span("mc.fit"):
            yield
        _trace.write_out()
    finally:
        _trace = None
