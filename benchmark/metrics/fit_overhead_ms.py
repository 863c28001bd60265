"""Milliseconds a fit spends outside the program's own init + EM timer:
the benchmark's wall time around ``fit_model_data`` (ending in a
synchronize) less the fit's ``MaximizeResult.seconds``, the mean over the
window's fits.  It holds the API's set-up of a fit (the allele codes of an
admixture fit, the options), the harvest's last copies and the host's
return."""


def read(run):
    if not run.fits:
        return None
    return 1e3 * sum(f.wall_s - f.seconds for f in run.fits) / len(run.fits)
