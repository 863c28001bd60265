"""Seconds from the start of the benchmark's process until it is ready to
measure: imports, the kernels' build or load, the panel made on the card,
and the two-iteration warm fit (host clock, after a synchronize)."""


def read(run):
    return run.setup_s
