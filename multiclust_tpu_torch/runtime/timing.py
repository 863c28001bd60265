"""Repeat-timing harness (-w; multiclust_tpu/runtime/timing.py,
timed_model_estimation, multiclust.c:201-347).

Repeats the whole model estimation at least n times / at least t seconds /
at most m seconds and reports the mean and sd of the wall time, logL,
iterations and initializations, and the AIC/BIC-chosen K.  Every repeat
ends with the device idle (``torch.cuda.synchronize()`` on a CUDA
device), so the clock reads finished work.  Under a mesh each repeat's
adjusted Rand (-A) is scored inside the fit on the rank's block, through
contingency tables summed over the ranks (runtime/ingest.py).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from multiclust_tpu_torch.config import Options
from multiclust_tpu_torch.runtime import mesh as mesh_mod
from multiclust_tpu_torch.runtime.ksweep import estimate_model


@dataclasses.dataclass
class TimingStats:
    n_repeats: int = 0
    converged_repeats: int = 0
    target_reached: int = 0
    total_seconds: float = 0.0
    max_ll: float = -float("inf")
    first_ll: float = -float("inf")
    first_hit_index: int = 0
    min_aic: float = 0.0
    min_bic: float = 0.0
    max_ar: float = -1.0
    max_ll_rand: float = 0.0
    lls: List[float] = dataclasses.field(default_factory=list)
    inits: List[int] = dataclasses.field(default_factory=list)
    iters: List[int] = dataclasses.field(default_factory=list)
    aic_Ks: List[int] = dataclasses.field(default_factory=list)
    bic_Ks: List[int] = dataclasses.field(default_factory=list)
    ars: List[float] = dataclasses.field(default_factory=list)

    @staticmethod
    def _mean_sd(vals):
        n = len(vals)
        if not n:
            return 0.0, 0.0
        mean = sum(vals) / n
        if n < 2:
            return mean, 0.0
        var = sum((v - mean) ** 2 for v in vals) / (n - 1)
        return mean, math.sqrt(max(var, 0.0))


def repeat_seed(seed: int, n: int) -> int:
    """The generator seed of repeat ``n``: each repeat draws its own
    starts, as the JAX package splits a key per repeat."""
    return int(np.random.SeedSequence(seed, spawn_key=(n,))
               .generate_state(1)[0])


def timed_model_estimation(seed: int, md, opt: Options,
                           n_parameters_fn, warm=None,
                           true_partition=None,
                           emit: Optional[Callable[[str], None]] = None
                           ) -> TimingStats:
    emit = emit or print
    st = TimingStats()
    start = time.time()
    enough_time = not opt.repeat_seconds

    while st.n_repeats < opt.n_repeat or not enough_time:
        est = estimate_model(repeat_seed(seed, st.n_repeats), md, opt,
                             n_parameters_fn, warm=warm,
                             true_partition=true_partition)
        if md.device.type == "cuda":
            torch.cuda.synchronize(md.device)
        res = est.last
        if res.max_logL > st.max_ll:
            st.max_ll = res.max_logL
            st.min_aic = res.aic
            st.min_bic = res.bic
            st.max_ll_rand = res.arand
            if abs(res.max_logL - st.first_ll) > (opt.abs_error or 1e-15):
                st.first_ll = res.max_logL
                st.first_hit_index = st.n_repeats
        st.max_ar = max(st.max_ar, res.arand)
        st.lls.append(res.max_logL)
        st.inits.append(res.n_init)
        st.iters.append(res.n_total_iter)
        st.aic_Ks.append(est.aic_K)
        st.bic_Ks.append(est.bic_K)
        if opt.afile:
            st.ars.append(res.arand)
        st.n_repeats += 1
        if res.ever_converged:
            st.converged_repeats += 1
        if res.n_targetll_times:
            st.target_reached += 1

        st.total_seconds = time.time() - start
        # budget decisions are rank 0's on every rank of a meshed run: a
        # rank that left the loop while another started a fit would hang
        if not enough_time and mesh_mod.past_deadline(start,
                                                      opt.repeat_seconds):
            enough_time = True
        if opt.max_repeat_seconds and mesh_mod.past_deadline(
                start, opt.max_repeat_seconds):
            break

    n = st.n_repeats
    model = ("admix constrained" if opt.admixture and opt.eta_constrained
             else "admix" if opt.admixture else "mix")
    emit(f"Data, Method, Model: {opt.filename}, "
         f"{opt.accel_abbreviation}, {model}")
    emit(f"Number of repetitions: {n} of {opt.n_repeat} requested, "
         f"{st.converged_repeats} converged, "
         f"{st.target_reached} reach target")
    emit(f"Average time: {st.total_seconds / max(n, 1):f}s "
         f"(total: {st.total_seconds:f}s)")
    m, s = st._mean_sd(st.lls)
    emit(f"Average log likelihood: {m:f} (+/- {s:f})")
    emit(f"Maximum log likelihood: {st.max_ll:f} first hit at run "
         f"{st.first_hit_index} (AIC {st.min_aic:f}; BIC {st.min_bic:f}; "
         f"RAND: {st.max_ll_rand:f})")
    if opt.max_K != opt.min_K:
        m, s = st._mean_sd(st.aic_Ks)
        emit(f"Average K (AIC): {m:f} (+/- {s:f})")
        m, s = st._mean_sd(st.bic_Ks)
        emit(f"Average K (BIC): {m:f} (+/- {s:f})")
    else:
        emit(f"Total initializations, iterations: {sum(st.inits)}, "
             f"{sum(st.iters)}")
        m, s = st._mean_sd(st.inits)
        emit(f"Average initializations: {m:f} (+/- {s:f})")
        m, s = st._mean_sd(st.iters)
        emit(f"Average iterations: {m:f} (+/- {s:f})")
    return st
