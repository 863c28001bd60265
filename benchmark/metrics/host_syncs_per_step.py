"""Host reads of a device value (``host.syncs``, each a wait for the
stream) per EM model step (``em.model_steps``), over every fit of the
run; None where the program keeps no such count."""


def read(run):
    fits = run.fits + run.traced
    steps = sum(f.launches.get("em.model_steps", 0) for f in fits)
    if not steps:
        return None
    return sum(f.launches.get("host.syncs", 0) for f in fits) / steps
