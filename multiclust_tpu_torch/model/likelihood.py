"""Information criteria (log_likelihood.c:70-85)."""

from __future__ import annotations

import math


def aic(max_logL: float, n_parameters: int) -> float:
    return -2.0 * max_logL + 2.0 * n_parameters


def bic(max_logL: float, n_parameters: int, n_individuals: int) -> float:
    return -2.0 * max_logL + n_parameters * math.log(n_individuals)
