"""The system under test, as the benchmark calls it: one whole fit of a
panel that lies on the card, through ``multiclust_tpu_torch.api.
fit_model_data``, and the counters the program keeps.

This is the only module of the benchmark that imports the program, and it
imports it inside functions, so that loading the benchmark's files loads
nothing of it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch


@dataclasses.dataclass
class Answer:
    """What one fit returns, and what the benchmark reads beside it."""

    eta: torch.Tensor          # [I, K] admixture proportions, or [K]
    p: torch.Tensor            # [K, L, 2] allele frequencies
    logl: float                # the best chain's log likelihood
    n_iter_all: int            # EM iterations of every chain it ran
    n_launched: int            # chains it ran
    seconds: float             # MaximizeResult.seconds
    route: str = ""
    batch_chains: int = 0
    launches: Optional[dict] = None


def model_data(planes: torch.Tensor, miss: torch.Tensor):
    """The panel as the program's ModelData (no copy)."""
    from multiclust_tpu_torch.model.common import model_data_from_planes

    return model_data_from_planes(planes, miss)


# the keys of a traffic mix that ``options`` reads (the harness reads the
# others: harness.RUN_KEYS)
OPTION_KEYS = ("model", "K", "n_init", "accel", "max_iter", "abs_error")


def options(traffic: dict, seed: int, max_iter: Optional[int] = None):
    """The program's Options for one fit of ``traffic``: the model, K, the
    number of starts, the acceleration (``accel``, as the CLI's ``-s``:
    0 plain EM, 1-3 SQUAREM, 4 and up quasi-Newton), the iteration cap
    (``max_iter``, 0 none) and the stop rule's ``abs_error`` (the
    program's default where the mix names none); ``seed`` the fit's own."""
    from multiclust_tpu_torch.config import AccelScheme, Options

    K = int(traffic["K"])
    accel = int(traffic["accel"])
    kw = {} if "abs_error" not in traffic else {
        "abs_error": float(traffic["abs_error"])}
    return Options(admixture=traffic["model"] == "admixture", min_K=K,
                   max_K=K, n_init=int(traffic["n_init"]),
                   accel_scheme=AccelScheme(accel) if accel <= 4 else accel,
                   max_iter=int(traffic["max_iter"]
                                if max_iter is None else max_iter),
                   seed=int(seed), verbosity=2, write_files=False, **kw)


def fit(md, ploidy: int, opt) -> Answer:
    """One fit; returns once the card has finished it."""
    from multiclust_tpu_torch.api import fit_model_data
    from multiclust_tpu_torch.ops import build

    before = dict(build.LAUNCHES)
    out = fit_model_data(md, ploidy, opt)
    best = out.best
    if md.x.is_cuda:
        torch.cuda.synchronize()
    launches = {k: v - before.get(k, 0) for k, v in build.LAUNCHES.items()
                if v - before.get(k, 0)}
    return Answer(eta=best.best_params.eta, p=best.best_params.p,
                  logl=float(best.max_logL), n_iter_all=int(best.n_iter_all),
                  n_launched=int(best.n_launched),
                  seconds=float(best.seconds), route=best.route,
                  batch_chains=int(best.batch_chains), launches=launches)


def timed_fit(md, ploidy: int, opt):
    """(Answer, wall seconds from the call to the card's end of it)."""
    t0 = time.perf_counter()
    ans = fit(md, ploidy, opt)
    return ans, time.perf_counter() - t0
