"""Milliseconds of stream time a traced fit spends in the program's init
spans (``mc.init``: the starts drawn and padded, the first batch and every
refill), the mean over the traced fits; None where the program keeps no
such span."""


def read(run):
    us = [f.launches.get("span_us.mc.init") for f in run.traced]
    if not us or None in us:
        return None
    return sum(us) / len(us) / 1e3
