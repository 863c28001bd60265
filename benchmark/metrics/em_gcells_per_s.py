"""Useful genotype-cells a second of init + EM: I x (sum over loci of the
alleles) x the fit's EM iterations of every chain (``n_iter_all``), summed
over the window's fits, over their summed ``MaximizeResult.seconds``, in
10^9 cells/s."""


def read(run):
    secs = sum(f.seconds for f in run.fits)
    if not secs:
        return None
    return run.cells * sum(f.n_iter_all for f in run.fits) / secs / 1e9
