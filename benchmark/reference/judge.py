"""The numbers that decide whether a fit's answer is correct.

A fit answers with the best chain's parameters theta = (eta, p) and a log
likelihood X.  As in the reference C program, X is the log likelihood of
the parameters that the last EM step started from, and theta is that
step's result.  The reference judges the answer by what it says, in
float64:

- ``logl_gap``: |X - logL(theta)| / |logL(theta)|.  A converged fit's X
  lies below logL(theta) by its last step's gain, which its stop rule
  keeps under the float32 noise floor; a logL computed in a lower
  precision, or of other parameters, lies further off.
- ``step_gain``: (logL(EM(theta)) - logL(theta)) / |logL(theta)|, what one
  more exact EM step still gains.  A fit stopped by its rule gains about
  as little as its last step did (a float32 answer, whose rows add to 1
  only to float32 rounding, can read slightly below 0); a fit that
  returned its start or stepped on part of the data gains much more.

A number that is not finite fails its limit.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import models

NUMBERS = ("logl_gap", "step_gain")


def judge(model: str, eta, p, X: float, planes, miss, lb: float,
          plb: float, block_cells: int = models.BLOCK_CELLS) -> dict:
    """The numbers of one answer (see the module's docstring)."""
    eta64, p64 = eta.to(torch.float64), p.to(torch.float64)
    eta1, p1, t0 = models.step(model, eta64, p64, planes, miss, lb, plb,
                               block_cells=block_cells)
    ll0 = float(t0.sum())
    ll1 = float(models.terms(model, eta1, p1, planes, miss,
                             block_cells=block_cells).sum())
    return {"logl_gap": abs(X - ll0) / abs(ll0),
            "step_gain": (ll1 - ll0) / abs(ll0), "logl": ll0}


def within(numbers: dict, limits: dict) -> bool:
    """Every compared number finite and at most its limit."""
    return all(math.isfinite(numbers[k]) and numbers[k] <= limits[k]
               for k in limits)
