"""Milliseconds of stream time a traced fit spends in the program's own
set-up spans: the allele codes of an admixture fit (``mc.codes``) and the
plan (``mc.plan``: the options, the panel's flags, the router's scratch
budget and the chain batch, with their memory queries), the mean over the
traced fits; None where the program keeps no such span."""


def read(run):
    if not run.traced or any("span_us.mc.plan" not in f.launches
                             for f in run.traced):
        return None
    us = sum(f.launches["span_us.mc.plan"]
             + f.launches.get("span_us.mc.codes", 0) for f in run.traced)
    return us / len(run.traced) / 1e3
