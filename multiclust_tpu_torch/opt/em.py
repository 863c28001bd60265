"""EM chain state machine (multiclust_tpu/opt/em.py).

Replaces the reference's ``em()`` loop (em_alg.c:44-90) and its stopping
logic (``stop`` :101-143, ``converged`` :163-182).  Every function works on
a chain batch: each tensor of the state has a leading lane dimension B,
and stopped lanes stay frozen through masked selects, as the JAX package's
vmapped lanes do.

Numerical note: logL values are float64 sums of per-individual terms.  The
convergence tolerance is floored at ``noise_factor * eps * scale``, with
eps that of the PARAMS dtype (float32 chains carry float64 logL, but their
terms are rounded to float32) and scale the RMS of the per-individual
terms; on float64 the floor is negligible and reference semantics hold.

Host reads: blind runs never read the device.  The adaptive interval is
read once per macro step, an accelerated macro step reads whether any lane
still runs, and backtracking reads one flag per trial.  Each read counts
as ``host.syncs``, and each model step under ``em.model_steps`` and, by
the chains of its batch, ``em.chain_steps`` (ops/build.COUNTERS).

A replicate lattice (model/common.Lattice) runs through the same machine:
``model_em_step`` and ``model_log_likelihood`` step each live replicate's
lanes on that replicate's counts.  So does a jagged panel's bucketed layout
(model/bucketed.py): every helper below recurses into the tuple of
per-bucket p, and the model steps dispatch on BucketedData.

The chains of a mixed-K lattice carry ``Params.kmask``: the tree helpers
carry it like any leaf (a secant difference of it is 0), the accelerated
points keep their base point's mask as it is, and the projection of a
trial point keeps each chain to its lanes (multiclust_tpu/opt/em.py:395).

Under a mesh (cfg.mesh, runtime/mesh.py) the state holds this rank's block:
eta by rows, p by loci.  The model steps and logL return global values, so
every decision taken from them (convergence, stops, the adaptive interval,
accepts and backtracking) is the same on every rank without a broadcast.
The reductions over parameters made here are written out: a dot product's
eta part is summed over the data group and its p part over the model group
(eta is whole on each model group and p on each data group, so one sum
over all ranks would count them M or D times), and the finiteness check
over all ranks.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from multiclust_tpu_torch.config import AccelScheme
from multiclust_tpu_torch.model import admixture, mixture
from multiclust_tpu_torch.model.bucketed import BucketedData
from multiclust_tpu_torch.model.common import EMConfig, Lattice, \
    ModelData, Params, is_bi_repr, map_params, param_leaves
from multiclust_tpu_torch.ops.build import count
from multiclust_tpu_torch.ops.fullstep_bi import p0_clip_bounds
from multiclust_tpu_torch.ops.simplex import kmask_lanes, project_rows
from multiclust_tpu_torch.runtime.mesh import DATA_AXIS, MODEL_AXIS, \
    any_over_world

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# batched helpers (a lane is the leading dimension of every tensor)

def tree_map(fn, *trees):
    """Apply ``fn`` to every tensor leaf of nested NamedTuples and tuples
    (a bucketed p)."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, tuple):
        parts = (tree_map(fn, *leaves) for leaves in zip(*trees))
        if hasattr(first, "_fields"):
            return type(first)(*parts)
        return tuple(parts)
    return fn(*trees)


def _lanes(pred: Tensor, t: Tensor) -> Tensor:
    """Broadcast a [B] tensor against ``t``'s trailing dims."""
    return pred.reshape(pred.shape + (1,) * (t.dim() - pred.dim()))


def lane_select(pred: Tensor, a, b):
    """Per-lane where over every leaf."""
    return tree_map(lambda x, y: torch.where(_lanes(pred, x), x, y), a, b)


def tree_sub(a: Params, b: Params) -> Params:
    return map_params(torch.sub, a, b)


def _sum_leaves(terms, cfg: Optional[EMConfig]) -> Tensor:
    """Sum of per-leaf terms (eta's first, then each p's); under a mesh
    eta's summed over the data group when eta is split by rows, p's over
    the model group."""
    mesh = cfg.mesh if cfg is not None else None
    if mesh is None:
        return sum(terms)
    eta_t = terms[0]
    if cfg.admixture and not cfg.eta_constrained:
        eta_t = mesh.sum(eta_t, DATA_AXIS)
    return eta_t + mesh.sum(sum(terms[1:]), MODEL_AXIS)


def tree_vdot(a: Params, b: Params, cfg: Optional[EMConfig] = None
              ) -> Tensor:
    """Per-lane dot product over every parameter block (step_size sums
    the etaik and pklm blocks together, accel_em.c:140-184); over the
    whole parameters under a mesh."""
    return _sum_leaves([(x * y).flatten(1).sum(dim=1)
                        for x, y in zip(param_leaves(a), param_leaves(b))],
                       cfg)


# ---------------------------------------------------------------------------
# state

class AccelRing(NamedTuple):
    """q-deep ring of secant increments (multiclust.h:285-293)."""

    u: Params     # [B, q, ...]
    v: Params     # [B, q, ...]
    pos: Tensor   # [B] next write slot


class EMState(NamedTuple):
    params: Params
    logL: Tensor          # [B] float64
    scale: Tensor         # [B] float64 noise scale of the latest logL
    n_iter: Tensor        # [B] int64
    converged: Tensor     # [B] bool
    stopped: Tensor       # [B] bool: converged | iteration cap | failure
    failed: Tensor        # [B] bool: NaN or fatal monotonicity violation
    mono_viol: Tensor     # [B] bool: any monotonicity violation observed
    accel_step: Tensor    # [B] bool: the last accepted step was accelerated
    ring: Optional[AccelRing]
    # adaptive check interval (cfg.check_interval == 0): logL-free
    # iterations before the next stop() check, escalated while the logL
    # delta is far above tolerance (plain_macro_step)
    interval: Tensor      # [B] int64


def init_state(params: Params, cfg: EMConfig) -> EMState:
    nb = params.eta.shape[0]
    dev = params.eta.device

    def f(v):
        return torch.full((nb,), v, dtype=torch.float64, device=dev)

    def zi():
        return torch.zeros(nb, dtype=torch.int64, device=dev)

    def zb():
        return torch.zeros(nb, dtype=torch.bool, device=dev)

    ring = None
    if cfg.accel_scheme != int(AccelScheme.NONE):
        z = map_params(lambda t: t.new_zeros((nb, cfg.q) + t.shape[1:]),
                       params)
        ring = AccelRing(u=z, v=map_params(torch.clone, z), pos=zi())
    return EMState(
        params=params, logL=f(-float("inf")), scale=f(0.0), n_iter=zi(),
        converged=zb(), stopped=zb(), failed=zb(), mono_viol=zb(),
        accel_step=zb(), ring=ring,
        interval=torch.ones(nb, dtype=torch.int64, device=dev))


def _eps(params: Params) -> float:
    return torch.finfo(params.eta.dtype).eps


# ---------------------------------------------------------------------------
# model dispatch

def _cat(parts):
    if isinstance(parts[0], Params):
        return map_params(lambda *ts: torch.cat(ts), *parts)
    return torch.cat(parts)


def _over_replicates(fn, params: Params, lat: Lattice, stopped_out):
    """``fn(params_r, md_r)`` for each live replicate's B lanes, joined in
    lane order; a replicate out of ``lat.live`` gives ``stopped_out(
    params_r)`` (its lanes have stopped, so no caller reads its values)."""
    B = lat.B
    outs = []
    for r, md_r in enumerate(lat.reps):
        p_r = map_params(lambda t: t[r * B:(r + 1) * B], params)
        outs.append(fn(p_r, md_r) if r in lat.live else stopped_out(p_r))
    return tuple(_cat(parts) for parts in zip(*outs))


def model_em_step(params: Params, md: ModelData, cfg: EMConfig,
                  want_ll: bool = True, counter: str = "em"):
    """One EM step of every chain of the batch, counted as one model step
    and as a chain-step a chain under ``counter`` (``em``; ``init`` for
    Rand-EM's scoring of starts); a lattice's live replicates each count
    one."""
    if isinstance(md, Lattice):
        return _over_replicates(
            lambda p, m: model_em_step(p, m, cfg, want_ll, counter),
            params, md, lambda p: (p,) + admixture._no_ll(p.eta))
    count(f"{counter}.model_steps")
    count(f"{counter}.chain_steps", params.eta.shape[0])
    if not cfg.admixture:
        return mixture.em_step(params, md, cfg, want_ll)
    return admixture.em_step(params, md, cfg, want_ll)


def model_log_likelihood(params: Params, md: ModelData, cfg: EMConfig):
    if isinstance(md, Lattice):
        return _over_replicates(
            lambda p, m: model_log_likelihood(p, m, cfg), params, md,
            lambda p: admixture._no_ll(p.eta))
    if not cfg.admixture:
        return mixture.log_likelihood(params, md, cfg)
    if isinstance(md, BucketedData):
        return admixture.log_likelihood_bucketed(params, md, cfg)
    if cfg.eta_constrained:
        return admixture.log_likelihood_constrained(params, md, cfg.mesh)
    if cfg.bi_repr_active and is_bi_repr(params):
        return admixture.log_likelihood_bi_repr(params, md,
                                                k_true=cfg.k_true,
                                                mesh=cfg.mesh)
    return admixture.log_likelihood(params, md, cfg.mesh)


# ---------------------------------------------------------------------------
# stopping logic

def _converged(cfg: EMConfig, prev: Tensor, ll: Tensor, scale: Tensor,
               eps: float) -> Tensor:
    """converged() (em_alg.c:163-182) with the noise floor."""
    abs_diff = (ll - prev).abs()
    eff_abs = torch.clamp(cfg.noise_factor * eps * scale,
                          min=cfg.abs_error)
    keep = torch.zeros_like(abs_diff, dtype=torch.bool)
    if cfg.abs_error:
        keep = keep | (abs_diff > eff_abs)
    if cfg.rel_error:
        keep = keep | (abs_diff / prev.abs() > cfg.rel_error)
    return torch.isfinite(prev) & ~keep


def _params_finite(params: Params, cfg: Optional[EMConfig] = None
                   ) -> Tensor:
    """[B] every parameter finite; under a mesh on every rank's block."""
    ok = torch.stack([torch.isfinite(t).flatten(1).all(dim=1)
                      for t in param_leaves(params)]).all(dim=0)
    if cfg is not None and cfg.mesh is not None:
        ok = ~any_over_world(~ok)
    return ok


def _apply_stop(state: EMState, new_params: Params, ll: Tensor,
                scale: Tensor, cfg: EMConfig, live: Tensor) -> EMState:
    """stop() bookkeeping (em_alg.c:101-143) for one EM iteration;
    ``live`` masks lanes that must not advance."""
    eps = _eps(state.params)
    n_iter = state.n_iter + 1
    # NaN detection inspects the parameters too: safe_log zeroes
    # non-finite contributions, so a poisoned parameter set can otherwise
    # give a finite-looking logL
    nan_fail = ~torch.isfinite(ll) | ~_params_finite(new_params, cfg)
    conv = _converged(cfg, state.logL, ll, scale, eps)
    iter_cap = (n_iter > max(cfg.max_iter, 1)) if cfg.max_iter > 0 \
        else torch.zeros_like(conv)
    stopped = conv | iter_cap | nan_fail

    # monotonicity: a decrease beyond the noise floor while not stopped is
    # fatal in the reference (em_alg.c:115-120)
    prev = state.logL
    floor = cfg.noise_factor * eps * torch.maximum(scale, state.scale)
    mono_viol = (ll < prev - floor) & torch.isfinite(prev) & ~stopped
    failed = nan_fail
    if cfg.monotonicity == "fatal":
        failed = failed | mono_viol
        stopped = stopped | mono_viol

    def sel(a, b):
        return torch.where(live, a, b)

    return state._replace(
        params=lane_select(live, new_params, state.params),
        logL=sel(ll, state.logL), scale=sel(scale, state.scale),
        n_iter=sel(n_iter, state.n_iter),
        converged=sel(conv, state.converged),
        stopped=sel(stopped, state.stopped),
        failed=sel(failed, state.failed),
        mono_viol=sel(mono_viol | state.mono_viol, state.mono_viol),
        accel_step=state.accel_step & ~live)


# ---------------------------------------------------------------------------
# plain EM iteration

def plain_step(state: EMState, md: ModelData, cfg: EMConfig) -> EMState:
    """One EM iteration (em_step, em_alg.c:195-207)."""
    new_params, ll, scale = model_em_step(state.params, md, cfg)
    return _apply_stop(state, new_params, ll, scale, cfg, ~state.stopped)


def blind_plain_steps(state: EMState, md: ModelData, cfg: EMConfig,
                      n_lane: Tensor, n_max: int) -> EMState:
    """LogL-free EM iterations with no stop() checks in between
    (check-interval mode; the reference checks every iteration).  EM is
    monotone over any number of steps, so this can stop later than
    per-iteration checking but never prematurely.  Lane b runs its first
    ``n_lane[b]`` steps; ``n_max``, the largest live value, is known on
    the host, so the run itself never reads the device."""
    live = ~state.stopped
    params = state.params
    for i in range(n_max):
        new, _, _ = model_em_step(params, md, cfg, want_ll=False)
        params = lane_select(live & (i < n_lane), new, params)
    return state._replace(
        params=params,
        n_iter=state.n_iter + torch.where(live, n_lane, 0))


# adaptive check interval (cfg.check_interval == 0): escalate 1 -> 2 -> 4
# ... -> CAP while the average per-iteration logL gain is more than
# ESCALATE x the effective tolerance, reset to 1 otherwise
ADAPTIVE_CAP = 16
ADAPTIVE_ESCALATE = 64.0


def _adapt_interval(state: EMState, prev: Tensor, prev_finite: Tensor,
                    live: Tensor, cfg: EMConfig) -> EMState:
    eps = _eps(state.params)
    delta = state.logL - prev
    avg = delta / torch.clamp(state.interval, min=1).to(delta.dtype)
    eff = torch.clamp(cfg.noise_factor * eps * state.scale,
                      min=cfg.abs_error)
    if cfg.rel_error:
        eff = torch.maximum(eff, cfg.rel_error * state.logL.abs())
    fast = (avg > ADAPTIVE_ESCALATE * eff) | ~prev_finite
    new_int = torch.where(fast, torch.clamp(state.interval * 2,
                                            max=ADAPTIVE_CAP),
                          torch.ones_like(state.interval))
    return state._replace(interval=torch.where(live, new_int,
                                               state.interval))


def plain_macro_step(state: EMState, md: ModelData,
                     cfg: EMConfig) -> EMState:
    """One macro plain-EM iteration with ONE stop() evaluation:
    cfg.check_interval 1 = plain_step; N > 1 = N-1 blind steps then a
    plain_step; 0 = adaptive, the blind-run length per lane lives in
    state.interval (_adapt_interval)."""
    if cfg.check_interval == 0:
        live = ~state.stopped
        n_lane = state.interval - 1
        # one host read: the blind-run length, and whether any lane runs
        # (a macro step of stopped lanes only is a no-op)
        count("host.syncs")
        n_max, n_live = torch.stack([torch.where(live, n_lane, 0).max(),
                                     live.sum()]).tolist()
        if not n_live:
            return state
        prev = state.logL
        state = blind_plain_steps(state, md, cfg, n_lane, n_max)
        state = plain_step(state, md, cfg)
        return _adapt_interval(state, prev, torch.isfinite(prev), live, cfg)
    if cfg.check_interval > 1:
        n = cfg.check_interval - 1
        state = blind_plain_steps(state, md, cfg,
                                  torch.full_like(state.n_iter, n), n)
    return plain_step(state, md, cfg)


# ---------------------------------------------------------------------------
# secant collection (em_2_steps, em_alg.c:1072-1211)

def _ring_push(ring: AccelRing, u: Params, v: Params, live: Tensor,
               q: int) -> AccelRing:
    lanes = torch.arange(live.shape[0], device=live.device)

    def write(buf, val):
        new = buf.clone()
        new[lanes, ring.pos] = val
        return torch.where(_lanes(live, buf), new, buf)

    return AccelRing(
        u=map_params(write, ring.u, u), v=map_params(write, ring.v, v),
        pos=torch.where(live, (ring.pos + 1) % q, ring.pos))


def two_em_steps(state: EMState, md: ModelData, cfg: EMConfig
                 ) -> Tuple[EMState, Params]:
    """Two EM steps recording the secant pair u = F(x) - x and
    v = F(F(x)) - F(x); returns (state at F(F(x)), the base point x)."""
    x0 = state.params
    s1 = plain_step(state, md, cfg)
    u = tree_sub(s1.params, x0)
    s2 = plain_step(s1, md, cfg)
    v = tree_sub(s2.params, s1.params)
    # the pair counts only when the first step left the lane running
    ring = _ring_push(s2.ring, u, v, ~s1.stopped, cfg.q)
    return s2._replace(ring=ring), x0


# ---------------------------------------------------------------------------
# accelerated updates (accel_em.c)

def _slot(ring: AccelRing, q: int, back: int):
    """The (u, v) pair written ``back`` pushes ago (1 = newest)."""
    idx = (ring.pos - back) % q
    lanes = torch.arange(idx.shape[0], device=idx.device)
    return (map_params(lambda b: b[lanes, idx], ring.u),
            map_params(lambda b: b[lanes, idx], ring.v))


def step_size(scheme: int, u: Params, v: Params,
              cfg: Optional[EMConfig] = None) -> Tensor:
    """SQUAREM/QN1 step size per lane (step_size, accel_em.c:130-243)."""
    utu = tree_vdot(u, u, cfg)
    vmu = tree_sub(v, u)
    utvu = tree_vdot(u, vmu, cfg)
    vutvu = tree_vdot(vmu, vmu, cfg)
    if scheme == int(AccelScheme.SQS1):
        s = utu / utvu
    elif scheme == int(AccelScheme.SQS2):
        s = utvu / vutvu
    elif scheme == int(AccelScheme.SQS3):
        s = torch.where(torch.sqrt(utu) < 1e-8,
                        torch.full_like(utu, float("nan")),
                        -torch.sqrt(utu / vutvu))
    elif scheme == int(AccelScheme.QN):
        s = -utu / utvu
    else:
        s = torch.full_like(utu, -1.0)
    if scheme < int(AccelScheme.QN):
        s = torch.clamp(s, max=-1.0)
    return s


def _point(fn, x0: Params, *deltas: Params) -> Params:
    """An accelerated point ``fn`` of the base ``x0`` and its secant
    increments, leaf by leaf, with the base's kmask as it is (its
    increments are 0, but a non-finite step size would spoil it)."""
    return map_params(fn, x0._replace(kmask=None),
                      *(d._replace(kmask=None) for d in deltas)
                      )._replace(kmask=x0.kmask)


def squarem_point(x0: Params, u: Params, v: Params, s: Tensor) -> Params:
    """x' = x0 - 2 s u + s^2 (v - u)   (accelerated_update,
    accel_em.c:460-466)."""
    def pt(x, uu, vv):
        sb = _lanes(s, x)
        return x - 2.0 * sb * uu + sb * sb * (vv - uu)
    return _point(pt, x0, u, v)


def qn1_point(x0: Params, u: Params, v: Params, s: Tensor) -> Params:
    """x' = x0 + u + s v   (accelerated_update QN branch,
    accel_em.c:449-454)."""
    return _point(lambda x, uu, vv: x + uu + _lanes(s, x) * vv, x0, u, v)


def _project_params(params: Params, md: ModelData, cfg: EMConfig
                    ) -> Params:
    if not cfg.do_projection:
        return params
    kmask = params.kmask
    eta = admixture._project_eta_rows(params.eta, cfg, kmask)
    if isinstance(params.p, tuple):
        # bucketed p: each bucket projected with its own mask
        # (multiclust_tpu/opt/em.py:396-408)
        bd = md.reps[0] if isinstance(md, Lattice) else md
        return Params(eta=eta, p=tuple(
            _project_p(pb, md_b.mask, cfg, kmask)
            for md_b, pb in zip(bd.buckets, params.p)), kmask=kmask)
    if cfg.bi_repr_active and is_bi_repr(params):
        # p0 layout: the closed 2-simplex projection of (p0, 1 - p0) is a
        # clip, with the kernel's bounds; pad lanes it lifts are inert
        # (their eta is 0) and the next step's p0 update zeroes them
        lo, hi = p0_clip_bounds(cfg.p_lower_bound, params.p.dtype)
        return Params(eta=eta, p=torch.clamp(params.p, lo, hi), kmask=kmask)
    return Params(eta=eta, p=_project_p(params.p, md.mask, cfg, kmask),
                  kmask=kmask)


def _project_p(p: Tensor, mask: Tensor, cfg: EMConfig,
               kmask: Optional[Tensor] = None) -> Tensor:
    """Full-layout p projected on ``mask``, K-pad rows (or the rows
    outside each chain's ``kmask``) kept zero."""
    p = project_rows(p, mask, cfg.p_lower_bound)
    if kmask is not None:
        return torch.where(kmask_lanes(kmask, p.dim(), -3), p,
                           torch.zeros_like(p))
    kv = admixture._k_valid(cfg, p.shape[-3], p.device)
    if kv is not None:
        p = torch.where(kv[:, None, None], p, torch.zeros_like(p))
    return p


def qn_point(x0: Params, ring: AccelRing, cfg: EMConfig) -> Params:
    """Quasi-Newton update with q > 1 secants (Zhou/Alexander/Lange 2011;
    qn_accelerated_update, accel_em.c:262-419):

        x' = x0 + u_add + sum_j y_j V_j,  y = A^{-1} c,
        A[j, n] = <U_j, U_n> - <U_j, V_n>,  c[n] = <u_new, U_n>.

    ``u_add`` keeps the reference's indexing (accel_em.c:267-268): the
    SECOND newest u when q > 1.  A singular A gives a NaN trial point,
    which the guarded accept rejects."""
    q = cfg.q
    u_new, _ = _slot(ring, q, 1)
    u_add, _ = _slot(ring, q, 2 if q > 1 else 1)
    nb = u_new.eta.shape[0]

    def flat(t):
        return t.reshape(nb, q, -1)

    U, V = param_leaves(ring.u), param_leaves(ring.v)
    A = _sum_leaves([torch.einsum("bqn,brn->bqr", flat(uu), flat(uu))
                     - torch.einsum("bqn,brn->bqr", flat(uu), flat(vv))
                     for uu, vv in zip(U, V)], cfg)
    c = _sum_leaves([torch.einsum("bqn,bn->bq", flat(uu), un.reshape(nb, -1))
                     for uu, un in zip(U, param_leaves(u_new))], cfg)
    y, info = torch.linalg.solve_ex(A, c)
    y = torch.where((info != 0)[:, None], torch.full_like(y, float("nan")),
                    y)

    def upd(x, ua, vv):
        return x + ua + torch.einsum("bq,bqn->bn", y,
                                     flat(vv)).reshape(x.shape)
    return _point(upd, x0, u_add, ring.v)


def accel_macro_step(state: EMState, md: ModelData,
                     cfg: EMConfig) -> EMState:
    """One accelerated iteration (accelerated_em_step, accel_em.c:35-114):
    two EM steps for a secant pair, then a guarded accelerated jump with
    optional Varadhan backtracking, falling back to the EM iterate.  A
    macro step of stopped lanes only changes nothing, so it returns at
    once after one host read."""
    count("host.syncs")
    if not bool((~state.stopped).any()):
        return state
    return _accel_jump(state, md, cfg)


def _accel_jump(state: EMState, md: ModelData, cfg: EMConfig) -> EMState:
    scheme = int(cfg.accel_scheme)
    pre_stopped = state.stopped
    state2, x0 = two_em_steps(state, md, cfg)
    live = ~pre_stopped & ~state2.stopped
    x2 = state2.params                                # latest EM iterate
    emll, _ = model_log_likelihood(x2, md, cfg)       # accel_em.c:53
    u, v = _slot(state2.ring, cfg.q, 1)

    if scheme == int(AccelScheme.QN) and cfg.q > 1:
        xt = _project_params(qn_point(x0, state2.ring, cfg), md, cfg)
        ll, _ = model_log_likelihood(xt, md, cfg)
        accept = live & (ll > emll) & torch.isfinite(ll)
    else:
        s = step_size(scheme, u, v, cfg)
        s_ok = torch.isfinite(s)

        def make_point(sv):
            if scheme == int(AccelScheme.QN):
                return _project_params(qn1_point(x0, u, v, sv), md, cfg)
            return _project_params(squarem_point(x0, u, v, sv), md, cfg)

        xt = make_point(s)
        ll, _ = model_log_likelihood(xt, md, cfg)
        # backtracking: s <- (s - 1) / 2 while the trial underperforms
        # (accel_em.c:76-82); one host read per trial
        for _ in range(cfg.adjust_step):
            active = (ll < emll) & (s < -1.0)
            count("host.syncs")
            if not bool(active.any()):
                break
            s = torch.where(active, (s - 1.0) / 2.0, s)
            pt = make_point(s)
            ll2, _ = model_log_likelihood(pt, md, cfg)
            ll = torch.where(active, ll2, ll)
            xt = lane_select(active, pt, xt)
        accept = live & s_ok & (ll > emll) & torch.isfinite(ll)

    # accept the accelerated point or fall back to the EM iterate
    # (accel_em.c:90-113); the jump itself does not call stop()
    return state2._replace(params=lane_select(accept, xt, x2),
                           accel_step=torch.where(live, accept,
                                                  state2.accel_step))


# ---------------------------------------------------------------------------
# K = 1 (em, em_alg.c:49-58)

def fit_k1(params: Params, md: ModelData, cfg: EMConfig) -> EMState:
    state = init_state(params, cfg)
    new_params, _, _ = model_em_step(params, md, cfg)
    ll, scale = model_log_likelihood(new_params, md, cfg)
    one = torch.ones_like(state.stopped)
    return state._replace(params=new_params, logL=ll, scale=scale,
                          n_iter=torch.ones_like(state.n_iter),
                          converged=one, stopped=one)
