"""K-sweep and model selection (multiclust_tpu/runtime/ksweep.py;
estimate_model, multiclust.c:365-452).

Fits K = min_K..max_K one after another, each K with its own static
``k_true`` and its own generator stream, and tracks the AIC/BIC argmin.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict

import numpy as np
import torch

from multiclust_tpu_torch.config import Options
from multiclust_tpu_torch.model.common import ModelData
from multiclust_tpu_torch.runtime.multistart import MaximizeResult, \
    maximize_likelihood


@dataclasses.dataclass
class EstimateResult:
    per_K: Dict[int, MaximizeResult]
    aic_K: int
    bic_K: int
    min_aic: float
    max_logL: float            # of the largest K
    seconds: float = 0.0

    @property
    def last(self) -> MaximizeResult:
        return self.per_K[max(self.per_K)]


def estimate_model(seed: int, md: ModelData, opt: Options, n_parameters_fn,
                   codes=None, warm=None, true_partition=None,
                   on_model_done=None, on_improve=None) -> EstimateResult:
    """``n_parameters_fn(K) -> int`` gives the AIC/BIC parameter count;
    ``on_improve(K, res)`` fires when an init improves K's best logL and
    ``on_model_done(K, res)`` when K is finished."""
    if opt.n_bootstrap:
        raise NotImplementedError(
            "the bootstrap test (-b) is not yet ported; see ROADMAP.md "
            "queue 1, item 15")
    t0 = time.time()
    ks = list(range(opt.min_K, opt.max_K + 1))
    # one generator stream per K, as the JAX package splits one key per K
    seeds = np.random.SeedSequence(seed).generate_state(len(ks))
    per_K: Dict[int, MaximizeResult] = {}
    min_aic = min_bic = float("inf")
    aic_K = bic_K = ks[0]
    for K, s in zip(ks, seeds):
        gen = torch.Generator(device=md.device).manual_seed(int(s))
        res = maximize_likelihood(
            gen, md, K, opt, n_parameters_fn(K), codes=codes, warm=warm,
            true_partition=true_partition,
            on_improve=(lambda r, K=K: on_improve(K, r)) if on_improve
            else None)
        per_K[K] = res
        if res.aic < min_aic:
            min_aic, aic_K = res.aic, K
        if res.bic < min_bic:
            min_bic, bic_K = res.bic, K
        if on_model_done:
            on_model_done(K, res)
    return EstimateResult(per_K=per_K, aic_K=aic_K, bic_K=bic_K,
                          min_aic=min_aic, max_logL=per_K[ks[-1]].max_logL,
                          seconds=time.time() - t0)
