"""The share of the chain-steps the EM driver computed that a harvested
chain kept: the EM iterations of every chain (``n_iter_all``) over the
program's count of chain-steps (``em.chain_steps``: every chain of the
lockstep batch, each model step), over every fit of the run; None where
the program keeps no such count."""


def read(run):
    fits = run.fits + run.traced
    steps = sum(f.launches.get("em.chain_steps", 0) for f in fits)
    if not steps:
        return None
    return 100.0 * sum(f.n_iter_all for f in fits) / steps
