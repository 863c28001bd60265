"""Host-orchestrated single-chain fit (multiclust_tpu/opt/driver.py).

Mirrors ``em()`` (em_alg.c:44-90): optional plain warmup iterations (-i),
collection of q-1 secant pairs, then plain or accelerated macro steps until
convergence, the iteration cap, or the wall-clock cap (-t,
stop_condition em_alg.c:145-161).  The chain runs as a batch of one lane
through the batched state machine of opt/em.py, with one host read of the
stop flag per macro step.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

from multiclust_tpu_torch.config import AccelScheme
from multiclust_tpu_torch.model.common import EMConfig, ModelData, Params, \
    map_params
from multiclust_tpu_torch.opt import em as em_mod


@dataclasses.dataclass
class FitResult:
    state: em_mod.EMState   # a batch of one lane
    time_stop: bool = False
    seconds: float = 0.0

    @property
    def params(self) -> Params:
        return map_params(lambda t: t[0], self.state.params)

    @property
    def logL(self) -> float:
        return float(self.state.logL[0])

    @property
    def converged(self) -> bool:
        return bool(self.state.converged[0])

    @property
    def n_iter(self) -> int:
        return int(self.state.n_iter[0])


def fit(params0: Params, md: ModelData, cfg: EMConfig, *,
        n_seconds: float = 0.0,
        start_time: Optional[float] = None) -> FitResult:
    """Run one EM chain (unbatched params) to convergence."""
    t0 = time.time() if start_time is None else start_time
    params0 = map_params(lambda t: t[None], params0)
    if params0.K == 1:
        return FitResult(state=em_mod.fit_k1(params0, md, cfg),
                         seconds=time.time() - t0)

    state = em_mod.init_state(params0, cfg)
    accel = cfg.accel_scheme != int(AccelScheme.NONE)

    def timed_out() -> bool:
        return bool(n_seconds) and (time.time() - t0) > n_seconds

    # warmup (em_alg.c:61-64)
    for _ in range(cfg.n_init_iter):
        if bool(state.stopped[0]) or timed_out():
            break
        state = em_mod.plain_step(state, md, cfg)

    time_stop = False
    if accel:
        # collect all but the last secant condition (em_alg.c:69-74)
        for _ in range(cfg.q - 1):
            if bool(state.stopped[0]) or timed_out():
                break
            state = em_mod.two_em_steps(state, md, cfg)[0]

    step = em_mod.accel_macro_step if accel else em_mod.plain_macro_step
    while not bool(state.stopped[0]):
        if timed_out():
            time_stop = True
            break
        state = step(state, md, cfg)
    return FitResult(state=state, time_stop=time_stop,
                     seconds=time.time() - t0)
