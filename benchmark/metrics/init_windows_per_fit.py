"""Windows of loci the admixture starts of a fit count (the program's
``init.windows``: a start draws and counts its copies a window at a time,
sized to the card's free memory), the mean over every fit of the run;
None where the program keeps no such count or no fit counts a window."""


def read(run):
    fits = run.fits + run.traced
    counted = [f.launches.get("init.windows") for f in fits]
    if not fits or all(c is None for c in counted):
        return None
    return sum(c or 0 for c in counted) / len(fits)
