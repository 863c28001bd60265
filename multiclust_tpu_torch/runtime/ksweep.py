"""K-sweep and model selection (multiclust_tpu/runtime/ksweep.py;
estimate_model, multiclust.c:365-452).

Fits K = min_K..max_K (or only H0 and Ha when bootstrapping: null_K =
max_K - 1, alt_K = max_K, synchronize multiclust.c:874-877), each K with
its own generator stream, tracks the AIC/BIC argmin, and records the
likelihood-ratio test statistic of the bootstrap.

``MULTICLUST_SWEEP_MODE`` picks how the K >= 2 fits run, with the JAX
package's values (ksweep.py:83-106):

* ``auto`` (the default), ``static`` and ``shared``: one K after
  another, each with its own static ``k_true`` (the reference's loop);
* ``merged``: every K >= 2's chains at once, in one mixed-K lattice
  (``swept_maximize``), each chain carrying its true lanes as
  ``Params.kmask``, where the fit has no warm start and no checkpoint and
  ``swept_eligible`` admits it; else the serial loop.  K = 1 stays on its
  single-start path.  Each K keeps its stream, chain batch and
  bookkeeping, so the lattice fits the same chains and gives the same
  per-K results up to rounding.

``shared`` is accepted for the JAX package's sake and runs the serial
loop.  There it pads every K's chains to the lanes of the sweep's largest
K (one 32-lane count) with their kmask, so that one compiled program
serves every K, the kernels taking K as a static argument; for the same
reason the JAX ``auto`` is ``shared`` on an accelerator.  The port's
kernels take K at run time and compile nothing per K, and every K of
such a sweep already runs on those 32 lanes, so the shared layout would
only widen each chain's lanes of work from K to the largest K.  On the
CPU the JAX ``auto`` is the serial loop too.  ``merged`` is the one way a
K-sweep puts several K's chains on the card at once; it pays when the
K's chains run about as long, and otherwise every K waits for the
slowest (the JAX package measured 34 s against 9 s on a mixture sweep).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from multiclust_tpu_torch.config import Options
from multiclust_tpu_torch.model.common import ModelData, Params
from multiclust_tpu_torch.runtime.multistart import MaximizeResult, \
    maximize_likelihood, swept_eligible, swept_maximize

SWEEP_MODES = ("auto", "static", "shared", "merged")


@dataclasses.dataclass
class EstimateResult:
    per_K: Dict[int, MaximizeResult]
    aic_K: int
    bic_K: int
    min_aic: float
    max_logL: float            # of the largest / alternative K
    max_logL_H0: float = -float("inf")
    ts: float = 0.0            # logL(Ha) - logL(H0) when bootstrapping
    h0_params: Optional[Params] = None
    seconds: float = 0.0

    @property
    def last(self) -> MaximizeResult:
        return self.per_K[max(self.per_K)]


def sweep_mode() -> str:
    """``MULTICLUST_SWEEP_MODE`` (default ``auto``); ValueError for a value
    outside SWEEP_MODES."""
    mode = os.environ.get("MULTICLUST_SWEEP_MODE", "auto")
    if mode not in SWEEP_MODES:
        raise ValueError(f"MULTICLUST_SWEEP_MODE={mode!r}: one of "
                         f"{', '.join(SWEEP_MODES)}")
    return mode


def estimate_model(seed: int, md: ModelData, opt: Options, n_parameters_fn,
                   warm=None, true_partition=None,
                   bootstrap: bool = False, on_model_done=None,
                   on_improve=None, checkpoint_dir=None) -> EstimateResult:
    """``n_parameters_fn(K) -> int`` gives the AIC/BIC parameter count;
    ``on_improve(K, res)`` fires when an init improves K's best logL and
    ``on_model_done(K, res)`` when K is finished.  ``bootstrap`` marks a
    replicate fit: no ``on_improve`` and no per-init progress lines, as
    in the reference (:584 ``!bootstrap``).  ``checkpoint_dir`` persists
    and resumes each K (runtime/checkpoint.py).  The sweep mode is read
    from the environment (``sweep_mode``)."""
    t0 = time.time()
    if opt.n_bootstrap:
        ks = [opt.max_K - 1, opt.max_K]
    else:
        ks = list(range(opt.min_K, opt.max_K + 1))
    # one generator stream per K, as the JAX package splits one key per K
    seeds = np.random.SeedSequence(seed).generate_state(len(ks))
    gens = {K: torch.Generator(device=md.device).manual_seed(int(s))
            for K, s in zip(ks, seeds)}
    swept: Dict[int, MaximizeResult] = {}
    if (sweep_mode() == "merged" and warm is None and checkpoint_dir is None
            and swept_eligible(opt, md, ks)):
        swept = swept_maximize(
            [(K, gens[K]) for K in ks if K >= 2], md, opt, n_parameters_fn,
            true_partition=true_partition,
            on_improve=on_improve if not bootstrap else None,
            quiet=bootstrap)
    per_K: Dict[int, MaximizeResult] = {}
    min_aic = min_bic = float("inf")
    aic_K = bic_K = ks[0]
    for K in ks:
        res = swept.get(K)
        if res is None:
            res = maximize_likelihood(
                gens[K], md, K, opt, n_parameters_fn(K), warm=warm,
                true_partition=true_partition,
                checkpoint_dir=checkpoint_dir,
                on_improve=((lambda r, K=K: on_improve(K, r))
                            if on_improve and not bootstrap else None),
                quiet=bootstrap)
        per_K[K] = res
        if res.aic < min_aic:
            min_aic, aic_K = res.aic, K
        if res.bic < min_bic:
            min_bic, bic_K = res.bic, K
        if on_model_done:
            on_model_done(K, res)
    out = EstimateResult(per_K=per_K, aic_K=aic_K, bic_K=bic_K,
                         min_aic=min_aic, max_logL=per_K[ks[-1]].max_logL,
                         seconds=time.time() - t0)
    if opt.n_bootstrap:
        h0 = per_K[ks[0]]
        out.max_logL_H0, out.h0_params = h0.max_logL, h0.best_params
        diff = out.max_logL - out.max_logL_H0
        if diff <= 0:
            raise RuntimeError(
                "Null hypothesis likelihood exceeds alternative hypothesis "
                "likelihood.  Try increasing number of initializations "
                "(command-line option -n)")
        out.ts = diff
    return out
