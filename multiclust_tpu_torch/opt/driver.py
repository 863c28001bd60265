"""Host-orchestrated single-chain fit (multiclust_tpu/opt/driver.py).

Mirrors ``em()`` (em_alg.c:44-90): optional plain warmup iterations (-i),
collection of q-1 secant pairs, then plain or accelerated macro steps until
convergence, the iteration cap, or the wall-clock cap (-t,
stop_condition em_alg.c:145-161).  The chain runs as a batch of one lane
through the batched state machine of opt/em.py, with one host read of the
stop flag per macro step; a ``trace`` (runtime/observe.make_trace_printer)
gets the logL, the iteration count and the step kind from that same read.
Under a mesh (cfg.mesh) the chain's parameters are this rank's block, and
the wall-clock decision (-t) is rank 0's on every rank
(runtime/mesh.past_deadline), as in multiclust_tpu/opt/driver.py:88-91.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from multiclust_tpu_torch.config import AccelScheme
from multiclust_tpu_torch.model.common import EMConfig, ModelData, Params, \
    map_params
from multiclust_tpu_torch.ops.build import count
from multiclust_tpu_torch.opt import em as em_mod
from multiclust_tpu_torch.runtime.mesh import past_deadline
from multiclust_tpu_torch.runtime.observe import span


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


def cfg_label(cfg: EMConfig, accel_step: bool) -> str:
    """The trace's step kind: EM, or the accelerator's abbreviation when
    the accelerated point was accepted."""
    if not accel_step:
        return "EM"
    return {1: "S1", 2: "S2", 3: "S3", 4: f"Q{cfg.q}"}.get(
        int(cfg.accel_scheme), "EM")


def fit(params0: Params, md: ModelData, cfg: EMConfig, *,
        n_seconds: float = 0.0,
        start_time: Optional[float] = None,
        trace: Optional[Callable] = None) -> FitResult:
    """Run one EM chain (unbatched params) to convergence;
    ``trace(logL, n_iter, kind)`` is called after every step."""
    t0 = time.time() if start_time is None else start_time
    params0 = map_params(lambda t: t[None], params0)
    if params0.K == 1:
        with span("mc.em"):
            state = em_mod.fit_k1(params0, md, cfg)
        return FitResult(state=state, seconds=time.time() - t0)

    state = em_mod.init_state(params0, cfg)
    accel = cfg.accel_scheme != int(AccelScheme.NONE)

    def timed_out() -> bool:
        return bool(n_seconds) and past_deadline(t0, n_seconds)

    def stopped(state, kind=None) -> bool:
        """The stop flag, and the trace line of the step just made (kind
        None: from the state's accel flag), in one host read."""
        with span("mc.harvest"):
            count("host.syncs")
            if trace is None:
                return bool(state.stopped[0])
            ll, n, acc, stop = torch.stack([
                state.logL[0], state.n_iter[0].double(),
                state.accel_step[0].double(),
                state.stopped[0].double()]).tolist()
            trace(ll, int(n), kind or cfg_label(cfg, bool(acc)))
            return bool(stop)

    def stepped(step, state):
        with span("mc.em"):
            return step(state, md, cfg)

    # warmup (em_alg.c:61-64)
    stop = False
    for _ in range(cfg.n_init_iter):
        if stop or timed_out():
            break
        state = stepped(em_mod.plain_step, state)
        stop = stopped(state, "EM")

    time_stop = False
    if accel:
        # collect all but the last secant condition (em_alg.c:69-74)
        for _ in range(cfg.q - 1):
            if stop or timed_out():
                break
            state = stepped(em_mod.two_em_steps, state)[0]
            stop = stopped(state, "EM")

    step = em_mod.accel_macro_step if accel else em_mod.plain_macro_step
    while not stop:
        if timed_out():
            time_stop = True
            break
        state = stepped(step, state)
        stop = stopped(state)
    return FitResult(state=state, time_stop=time_stop,
                     seconds=time.time() - t0)
