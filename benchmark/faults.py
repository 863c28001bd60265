"""Faults planted in the program, to show that the check catches them: each
patches one function of ``multiclust_tpu_torch`` for the duration of a
``with`` block.  The benchmark's runs never use them; the control script
(control.py) and the CPU tests do.

- ``unchanged``: every EM step returns its state unchanged;
- ``half_batch``: every EM step updates from the first half of the
  individuals alone (the second half's proportions kept), so the allele
  frequencies are the mean over half the panel;
- ``altered``: the answer is altered where the harvest produces it: the
  two alleles' frequencies swapped at every 64th locus, as a slip in the
  copy out of the kernels' p0 layout would.
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("unchanged", "half_batch", "altered")


def _half(md):
    h = md.I // 2
    return md._replace(x=md.x[:h], miss=md.miss[:h], c=md.c[:h],
                       x0=None if md.x0 is None else md.x0[:h],
                       x1=None if md.x1 is None else md.x1[:h])


@contextlib.contextmanager
def planted(fault: str):
    """The program with ``fault`` planted (one of FAULTS)."""
    from multiclust_tpu_torch.opt import em
    from multiclust_tpu_torch.runtime import multistart

    if fault == "unchanged":
        target, name = em, "model_em_step"
        orig = em.model_em_step

        def patched(params, md, cfg, want_ll=True):
            _, ll, scale = orig(params, md, cfg, want_ll)
            return params, ll, scale
    elif fault == "half_batch":
        target, name = em, "model_em_step"
        orig = em.model_em_step

        def patched(params, md, cfg, want_ll=True):
            per_row = params.eta.dim() == 3
            h = md.I // 2
            sub = params._replace(eta=params.eta[:, :h].contiguous()) \
                if per_row else params
            new, ll, scale = orig(sub, _half(md), cfg, want_ll)
            if per_row:
                new = new._replace(eta=torch.cat([new.eta,
                                                  params.eta[:, h:]], 1))
            return new, ll, scale
    elif fault == "altered":
        target, name = multistart, "lane_params"
        orig = multistart.lane_params

        def patched(*a, **kw):
            out = orig(*a, **kw)
            p = out.p.clone()
            p[:, ::64] = out.p[:, ::64].flip(-1)
            return out._replace(p=p)
    else:
        raise ValueError(f"fault {fault!r}: one of {', '.join(FAULTS)}")
    setattr(target, name, patched)
    try:
        yield
    finally:
        setattr(target, name, orig)
