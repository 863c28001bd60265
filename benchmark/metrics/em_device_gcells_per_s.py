"""Useful genotype-cells a second of the program's EM spans: I x (sum
over loci of the alleles) x the EM iterations of every chain
(``n_iter_all``), summed over the traced fits, over their summed stream
time in ``mc.em`` (the chain states made and the segments of steps run),
in 10^9 cells/s; None where the program keeps no such span."""


def read(run):
    us = [f.launches.get("span_us.mc.em") for f in run.traced]
    if not us or None in us or not sum(us):
        return None
    iters = sum(f.n_iter_all for f in run.traced)
    return run.cells * iters / (sum(us) * 1e-6) / 1e9
