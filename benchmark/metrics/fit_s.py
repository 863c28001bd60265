"""Seconds of the window over the fits completed in it: the time a user
waits for one converged fit, the window from the first fit's start to the
end of its last whole pass over the mix's set of starts (host clock, each
fit ending in a synchronize)."""


def read(run):
    return run.window_s / len(run.fits) if run.fits else None
