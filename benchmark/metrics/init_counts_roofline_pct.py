"""The least time the card needs for the traced fits' admixture starts'
counts (``roofline/allele_counts.py``, from the configuration and each
fit's ``n_launched`` starts) as a share of the stream time the program's
``mc.init.counts`` span gives them, in %; None where the program keeps no
such span (a mixture fit draws no allele partition)."""

import importlib.util
from pathlib import Path

_ROOFLINE = Path(__file__).resolve().parent.parent / "roofline" / \
    "allele_counts.py"


def _roofline():
    spec = importlib.util.spec_from_file_location(
        "benchmark_roofline_allele_counts", _ROOFLINE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read(run):
    us = [f.launches.get("span_us.mc.init.counts") for f in run.traced]
    if not us or None in us or not sum(us):
        return None
    starts = sum(f.n_launched for f in run.traced)
    least, _ = _roofline().least_seconds(run.config, int(run.traffic["K"]),
                                         starts, run.peaks)
    return 100.0 * least / (sum(us) * 1e-6)
