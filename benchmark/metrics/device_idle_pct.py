"""The share of the traced sub-window in which no operation runs on the
card, from the profiler's timeline."""


def read(run):
    if run.trace is None or not run.trace.window_s:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
