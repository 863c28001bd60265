"""EM iterations of every chain of a fit (``n_iter_all``), the mean over
the window's fits: a count that repeats exactly for a seed."""


def read(run):
    if not run.fits:
        return None
    return sum(f.n_iter_all for f in run.fits) / len(run.fits)
