"""Multi-start likelihood maximization (multiclust_tpu/runtime/multistart.py;
maximize_likelihood, multiclust.c:471-656).

A batch of EM chains runs in lockstep as the leading dimension of every
state tensor (the JAX package vmaps instead); the reference's bookkeeping
replays over finished chains in completion order, so the stop regimes
keep their semantics:

1. fixed count   (-n n_init)
2. wall-clock    (-t minutes; checked between segments)
3. target logL   (-u l <ll>, optionally x times)
4. revisit count (-u n <times> of the best logL)

The port pads only K, to 32 lanes, for the kernel; the kernel masks ragged
I and L itself, so no row or loci padding exists here.  A jagged panel
(M > 2, ``model.bucketed.worth_bucketing``) runs its chains on the bucketed
layout: starts are drawn and Rand-EM scored on the dense data, split by the
plan before the first step, and merged back to dense original-order p at
harvest, so outputs and checkpoints see the dense layout.

Under a mesh (``--mesh DxM``, runtime/mesh.py) every rank fits its block
of rows and loci: the block it read (runtime/ingest.py), or its slice of a
whole panel given to the fit.  Starts are drawn as blocks of the unsharded
ones (init/random.py), a warm start is sliced, harvest gathers a chain's
eta rows and p loci back to every rank, and the hard partition of the
adjusted Rand index is scored through contingency tables summed over the
ranks.  The fit's flags (any missing copy, every locus biallelic) are
reduced over the ranks.  Decisions taken from wall clocks go through
``past_deadline``, and the chain batch and the router's scratch budget,
read from each card's free memory, take the least over the ranks.  Jagged
buckets compose with data-axis meshes only; a loci-split mesh keeps the
dense layout, as the JAX package's ``_prepare_fit_data`` decides
(multistart.py:729-736).

A K-sweep may run every K's chains at once in one mixed-K lattice
(``swept_maximize``, the JAX package's multistart.py:952-1093,
runtime/ksweep.py), each chain carrying its true lanes as
``Params.kmask``.  The config is the sweep's largest K's, the chains are
padded to its lanes (``lattice_lanes``), and each K keeps the generator
stream, chain batch, refill schedule and completion-order bookkeeping of
its own serial loop, so the same chains are fitted.

Under a profiler a fit's layers here open the spans of runtime/observe.py:
``mc.plan`` (the config, the chain batch and the route), ``mc.init`` (the
starts drawn and padded), ``mc.em`` (chain states made and segments of
steps run) and ``mc.harvest`` (the stop flags read, and the harvest).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from multiclust_tpu_torch.config import AccelScheme, Options
from multiclust_tpu_torch.model.likelihood import aic as aic_fn, bic as bic_fn
from multiclust_tpu_torch.init import random as rinit
from multiclust_tpu_torch.model import bucketed
from multiclust_tpu_torch.model.admixture import bi_route, \
    posterior_allele_mass
from multiclust_tpu_torch.model.bucketed import BucketedData, \
    merge_params_like, split_params_like
from multiclust_tpu_torch.model.common import EMConfig, Lattice, \
    ModelData, Params, collapse_for_constrained, is_bi_repr, \
    k_padded_size, map_params, pad_params_k, unpad_params_k
from multiclust_tpu_torch.model.mixture import e_step
from multiclust_tpu_torch.ops.build import count
from multiclust_tpu_torch.ops.fullstep_bi import scratch_budget
from multiclust_tpu_torch.opt import em as em_mod
from multiclust_tpu_torch.runtime import mesh as mesh_mod
from multiclust_tpu_torch.runtime.observe import span


def device_policy(opt: Options, device):
    """``(use_pallas, storage_dtype)`` for a fit on ``device``, as
    Options.device_policy does for JAX backends (config.py:250-273): the
    kernels are on for float32 fits on CUDA, where counts are stored int8
    (admixture: the routed biallelic step on biallelic panels, the generic
    triple on any other, both to Kp = 1024, the wide kernels above Kp =
    128 and the plain step with a one-time notice above 1024, as the JAX
    package falls back to XLA there; mixture: the biallelic mixture
    kernels on biallelic panels, the plain products with the eta and p
    finish on the card on any other panel, both to Kp = 1024, the wide
    kernels above Kp = 128 and the plain step with no notice above 1024,
    as the JAX package's mixture falls through to XLA); CPU fits run the
    plain step in the compute dtype.
    ``opt.use_pallas`` overrides the kernel choice on the CPU only: on CUDA
    the kernels are the one route of a float32 fit."""
    on_cuda = torch.device(device).type == "cuda"
    kernel = on_cuda and opt.dtype == "float32"
    up = opt.use_pallas
    if up is None:
        up = kernel
    elif kernel and not up:
        raise ValueError("float32 fits on CUDA run the kernels; "
                         "use_pallas=False is for CPU tensors")
    storage = torch.int8 if (on_cuda and opt.dtype == "float32") else None
    return bool(up), storage


def cfg_from_options(opt: Options, K: int, md: ModelData) -> EMConfig:
    """Static EM config; ``md`` fixes has_missing and biallelic, and the
    data-pinned ``opt.ploidy`` (Options.synchronize) the biallelic
    mixture's fold.  ``opt.mesh_shape`` (D, M) builds the process mesh
    (D = -1: every process on the data axis; (1, 1): none); a shape that
    does not cover the process group raises ValueError."""
    mesh = mesh_shape_of(opt)
    if mesh is not None:
        mesh = mesh_mod.cached_mesh(mesh)
    use_pallas, _ = device_policy(opt, md.device)
    budget = scratch_budget(md.device) if use_pallas else 0
    # the largest count, not a mask: no [I, L] temporary of a biobank panel
    has_missing = md.miss.numel() > 0 and bool(md.miss.amax() > 0)
    biallelic = md.M == 2 and bool((md.n_alleles == 2).all())
    count("host.syncs", 1 + (md.M == 2))
    if mesh is not None:
        budget = mesh_mod.world_min(budget)
        if md.block is not None:
            # a block sees its rows and loci only: the panel's flags
            has_missing, mixed = mesh_mod.host_any([has_missing,
                                                    not biallelic])
            biallelic = not mixed
    return EMConfig(
        admixture=opt.admixture, eta_constrained=opt.eta_constrained,
        do_projection=opt.do_projection,
        eta_lower_bound=opt.eta_lower_bound,
        p_lower_bound=opt.p_lower_bound,
        abs_error=opt.abs_error, rel_error=opt.rel_error,
        max_iter=opt.max_iter, accel_scheme=int(opt.accel_scheme),
        q=opt.q, n_init_iter=opt.n_init_iter, adjust_step=opt.adjust_step,
        monotonicity=opt.resolved_monotonicity(),
        use_pallas="on" if use_pallas else "off",
        has_missing=bool(has_missing), biallelic=bool(biallelic),
        ploidy=opt.ploidy,
        k_true=K if (opt.admixture and not opt.eta_constrained) else 0,
        check_interval=opt.check_interval,
        # the router's scratch budget, read from the device once per fit
        scratch_budget=budget, mesh=mesh)


def mesh_shape_of(opt: Options):
    """The (D, M) mesh of ``opt``, with ``auto`` (D = -1) resolved over the
    process group; None for one device, as the JAX CLI does
    (cli.py:436-441)."""
    if not opt.mesh_shape:
        return None
    D, M = opt.mesh_shape
    if D == -1:
        D = max(mesh_mod.world_size() // M, 1)
    return None if (D, M) == (1, 1) else (D, M)


def lattice_lanes(K: int, cfg: EMConfig) -> int:
    """Lanes of a chain of K clusters: K padded to 32 where the admixture
    kernels run (``_pad_k``), else K.  With the config of a K-sweep's
    largest K, the lanes every chain of its lattice shares."""
    if (cfg.use_pallas != "off" and cfg.admixture
            and not cfg.eta_constrained and cfg.k_true):
        return k_padded_size(K, 32)
    return K


def _pad_k(params: Params, cfg: EMConfig) -> Params:
    """K-pad admixture params to the kernel's 32-lane layout (pads zero);
    no-op for the plain path."""
    return pad_params_k(params, lattice_lanes(cfg.k_true, cfg))


def static_cfg(cfg: EMConfig, K: int) -> EMConfig:
    """The config a K-cluster fit of its own runs under, from a mixed-K
    lattice's (only k_true differs)."""
    return cfg._replace(k_true=K) if cfg.k_true else cfg


def _to_bi_repr(params: Params, cfg: EMConfig) -> Params:
    """Full K-padded params [.., Kp, L, 2] -> the p0 layout [.., Kp, L]
    (model/common.EMConfig.bi_repr_active); no-op when inactive."""
    if not cfg.bi_repr_active or is_bi_repr(params):
        return params
    return params._replace(eta=params.eta.contiguous(),
                           p=params.p[..., 0].contiguous())


def _to_fit_layout(params: Params, md, cfg: EMConfig) -> Params:
    """Dense K-padded params -> the layout the chains run on ``md``: split
    by the plan of a bucketed panel (or of a lattice of them), else the
    p0 layout where it is active."""
    bd = md.reps[0] if isinstance(md, Lattice) else md
    if isinstance(bd, BucketedData):
        return split_params_like(params, bd)
    return _to_bi_repr(params, cfg)


def _warm_block(warm: Params, md: ModelData, cfg: EMConfig) -> Params:
    """This rank's block of a whole start given to the fit (a -Q/-P warm
    start); drawn starts come as blocks (init/random.py)."""
    if cfg.mesh is None:
        return warm
    return mesh_mod.shard_params(warm, cfg.mesh, md.I_total, md.L_total,
                                 _per_individual(cfg))


def _per_individual(cfg: EMConfig) -> bool:
    """eta is [.., I, K] (split by rows under a mesh)."""
    return cfg.admixture and not cfg.eta_constrained


def lane_params(params_b: Params, lane: int, cfg: EMConfig,
                md_fit, k_lane: int = 0) -> Params:
    """Dense K-sized full-layout params of one lane of a chain batch in
    the fit layout; under a mesh its eta rows and p loci gathered to every
    rank first.  ``k_lane``: the lane's own K in a mixed-K lattice."""
    params = map_params(lambda t: t[lane], params_b._replace(kmask=None))
    if cfg.mesh is not None:
        bd = md_fit.reps[0] if isinstance(md_fit, Lattice) else md_fit
        params = mesh_mod.gather_params(params, cfg.mesh, bd.I_total,
                                        bd.L_total, _per_individual(cfg))
    return _unpad_k(params, cfg, md_fit, k_lane)


def _unpad_k(params: Params, cfg: EMConfig, md_fit=None,
             k_lane: int = 0) -> Params:
    """Back to dense K-sized full-layout params in original locus order
    (harvest time only), with no kmask; bucketed p is merged by
    ``md_fit``'s plan.  ``k_lane`` (0: cfg.k_true) is the chain's own K
    where chains of several K share a layout, a fact of the host
    (the JAX package's ``_unpad_k(k_lane=)``, multistart.py:126-156)."""
    params = params._replace(kmask=None)
    kt_cfg = k_lane or cfg.k_true
    if isinstance(params.p, tuple):
        params = merge_params_like(params, md_fit)
    if cfg.bi_repr_active and is_bi_repr(params):
        kt = kt_cfg or params.p.shape[-2]
        p0 = params.p[..., :kt, :]
        params = Params(eta=params.eta[..., :kt],
                        p=torch.stack([p0, 1.0 - p0], dim=-1))
    if kt_cfg and params.p.shape[-3] != kt_cfg:
        params = unpad_params_k(params, kt_cfg)
    return params


# chains that run in lockstep unless -batch_chains says otherwise, and the
# share of the device's free memory their states and scratch may take
MAX_AUTO_CHAINS = 8
CHAIN_MEMORY_SHARE = 0.5


def chain_bytes(md: ModelData, K: int, cfg: EMConfig,
                plan: Optional[bucketed.JaggedPlan] = None) -> int:
    """Bytes one chain holds while it runs: its parameters, about eight
    more tensors of their size (the new iterate, the selects of the state
    machine, a trial point) and the secant ring's 2 q copies, plus the
    step's scratch for one chain (the biallelic route's own count, its
    rows partials bounded at a wide Kp by ``row_segments``; the generic
    and mixture steps' partials are of the size of p).  A bucketed panel
    (or ``plan``) counts its tight lanes."""
    itemsize = torch.finfo(md.dtype).bits // 8
    Kp = k_padded_size(K, 32) if cfg.use_pallas != "off" else K
    if isinstance(md, BucketedData):
        plan = md.plan
    if cfg.bi_repr_active:
        lanes = md.L
    else:
        lanes = plan.lanes if plan is not None else md.L * md.M
    n_eta = md.I * Kp if cfg.admixture and not cfg.eta_constrained else Kp
    params = (n_eta + Kp * lanes) * itemsize
    copies = 9 + (2 * cfg.q if cfg.accel_scheme else 0)
    if cfg.bi_repr_active:
        scratch = bi_route(1, md, cfg, Kp).scratch_bytes
    else:
        scratch = 2 * Kp * lanes * itemsize
    return copies * params + scratch


def chain_batch(opt: Options, md: ModelData, K: int, cfg: EMConfig) -> int:
    """Chains to run in lockstep: ``opt.batch_chains`` when given, else up
    to MAX_AUTO_CHAINS, as many as CHAIN_MEMORY_SHARE of the device's free
    memory holds (``chain_bytes`` each; asked once per fit), at least
    one."""
    if opt.batch_chains:
        return opt.batch_chains
    B = min(max(opt.n_init, 1), MAX_AUTO_CHAINS)
    if md.device.type == "cuda":
        count("host.mem_queries")
        free, _ = torch.cuda.mem_get_info(md.device)
        B = min(B, int(CHAIN_MEMORY_SHARE * free) // chain_bytes(md, K, cfg))
    if cfg.mesh is not None:
        # ``md`` is this rank's block; every rank runs the same batch
        B = mesh_mod.world_min(B)
    return max(B, 1)


@dataclasses.dataclass
class MaximizeResult:
    """Statistics across initializations (the _model fields kept across
    inits, multiclust.h:337-355)."""

    K: int
    best_params: Optional[Params] = None
    max_logL: float = -np.inf
    first_max_logL: float = -np.inf
    aic: float = np.inf
    bic: float = np.inf
    n_init: int = 0            # counted (converged) initializations
    n_launched: int = 0        # chains actually computed
    n_iter_all: int = 0        # EM iterations of every harvested chain
    n_total_iter: int = 0
    n_max_iter: int = 0
    n_maxll_init: int = -1
    n_maxll_times: int = 0
    n_targetll_times: int = 0
    n_targetll_init: int = 0
    time_stop: bool = False
    ever_converged: bool = False
    any_failed: bool = False
    mono_viol: bool = False
    arand: float = 0.0
    seconds: float = 0.0
    # how the biallelic admixture step ran (ops/fullstep_bi.Route.describe;
    # empty for every other step), the chains run in lockstep, and the
    # bucketing plan of a jagged panel (model/bucketed.JaggedPlan.describe;
    # empty for the dense layout)
    route: str = ""
    batch_chains: int = 1
    buckets: str = ""


def _host_converged(opt: Options, a: float, b: float) -> bool:
    """Host-side converged() (em_alg.c:163-182) for solution comparison."""
    if not np.isfinite(b):
        return False
    abs_diff = abs(a - b)
    keep = False
    if opt.abs_error:
        keep |= abs_diff > opt.abs_error
    if opt.rel_error:
        keep |= abs_diff / abs(b) > opt.rel_error
    return not keep


def _draw_init_batch(gen: torch.Generator, n: int, md: ModelData, K: int,
                     cfg: EMConfig, opt: Options,
                     md_score: Optional[ModelData] = None,
                     width: int = 0) -> Params:
    """n starts of K clusters from ``gen``, stacked; ``width`` > 0: the
    dynamic-K starts of a lattice of that many lanes, whose shared config
    is ``cfg`` (``_draw_init_batch_dyn``, multistart.py:352-358)."""
    kw = dict(method=opt.initialization_method,
              procedure=opt.initialization_procedure,
              n_rand_em_init=opt.n_rand_em_init, md_score=md_score)
    starts = [rinit.initialize_dyn(gen, md, K, width, cfg, **kw) if width
              else rinit.initialize(gen, md, K, cfg, **kw)
              for _ in range(n)]
    return map_params(lambda *t: torch.stack(t), *starts)


def _make_state(params_b: Params, md: ModelData, cfg: EMConfig
                ) -> em_mod.EMState:
    """Fresh chain states, in the layout the chains run on ``md``, with
    their warmup/secant prologue."""
    state = em_mod.init_state(_to_fit_layout(params_b, md, cfg), cfg)
    for _ in range(cfg.n_init_iter):
        state = em_mod.plain_step(state, md, cfg)
    if cfg.accel_scheme != int(AccelScheme.NONE):
        for _ in range(cfg.q - 1):
            state = em_mod.two_em_steps(state, md, cfg)[0]
    return state


def _segment(state: em_mod.EMState, md: ModelData, cfg: EMConfig,
             segment: int) -> em_mod.EMState:
    body = (em_mod.accel_macro_step
            if cfg.accel_scheme != int(AccelScheme.NONE)
            else em_mod.plain_macro_step)
    for _ in range(segment):
        state = body(state, md, cfg)
    return state


def fit_batch(params_b: Params, md: ModelData, cfg: EMConfig, *,
              segment: int = 16, n_seconds: float = 0.0,
              start_time: Optional[float] = None):
    """Run a batch of chains to convergence, reading the stop flags once
    per segment of macro steps; returns (EMState batch, timed_out)."""
    t0 = time.time() if start_time is None else start_time
    with span("mc.em"):
        state = _make_state(params_b, md, cfg)
    timed_out = False
    while True:
        with span("mc.harvest"):
            count("host.syncs")
            if bool(state.stopped.all()):
                break
        if n_seconds and mesh_mod.past_deadline(t0, n_seconds):
            timed_out = True
            break
        with span("mc.em"):
            state = _segment(state, md, cfg, segment)
    return state, timed_out


def _make_progress(opt: Options, K: int, t0: float, quiet: bool):
    """Per-init completion line (multiclust.c:618-627) at verbosity >
    QUIET when writing files; hh:mm:ss is the time since the sweep
    started, since batched chains finish together."""
    if quiet or opt.verbosity <= 2 or not opt.write_files:
        return None

    def pr(res: MaximizeResult, ll: float, conv: bool, iters: int) -> None:
        d = int(time.time() - t0)
        print("K = %d, initialization = %d: %f (%s) in %3d iterations, "
              "%02d:%02d:%02d (%f; %d), seed: %u"
              % (K, res.n_launched - 1, ll,
                 "converged" if conv else "not converged", iters,
                 d // 3600, (d % 3600) // 60, d % 60, res.max_logL,
                 res.n_maxll_times, opt.seed))
    return pr


def _bookkeep_lane(res: MaximizeResult, opt: Options, n_parameters: int,
                   I: int, ll: float, conv: bool, iters: int, failed: bool,
                   mono: bool, get_params, timed_out: bool,
                   on_improve=None, progress=None) -> bool:
    """Per-chain bookkeeping (multiclust.c:538-652); returns True when a
    stop regime is satisfied."""
    res.n_launched += 1
    res.n_iter_all += iters
    res.any_failed |= failed
    res.mono_viol |= mono
    if conv:
        res.ever_converged = True
    # iteration stats (multiclust.c:538-543)
    if conv or (res.n_init == 0 and timed_out):
        res.n_total_iter += iters
        res.n_max_iter = max(res.n_max_iter, iters)
        res.n_init += 1
    # same-solution bookkeeping (multiclust.c:546-554)
    if conv and _host_converged(opt, ll, res.first_max_logL):
        res.n_maxll_times += 1
    elif conv and ll > res.first_max_logL:
        res.n_maxll_times = 1
        res.first_max_logL = ll
        res.n_maxll_init = res.n_init
    # better solution (multiclust.c:557-560)
    if ll > res.max_logL and np.isfinite(ll):
        res.max_logL = ll
        res.aic = aic_fn(ll, n_parameters)
        res.bic = bic_fn(ll, n_parameters, I)
        res.best_params = get_params()
        if on_improve is not None:
            # best-so-far persistence (multiclust.c:584-600)
            on_improve(res)
    if progress is not None:
        progress(res, ll, conv, iters)

    # stop regimes (multiclust.c:629-652)
    if timed_out:
        res.time_stop = True
        return True
    if (opt.target_revisit and not opt.target_ll
            and res.n_maxll_times >= opt.target_revisit):
        return True
    if opt.target_ll and (ll > opt.desired_ll
                          or _host_converged(opt, ll, opt.desired_ll)):
        if not res.n_targetll_times:
            res.n_targetll_init = res.n_init
        res.n_targetll_times += 1
        if (not opt.target_revisit
                or opt.target_revisit <= res.n_targetll_times):
            return True
    if (not opt.target_revisit and not opt.target_ll
            and not opt.n_seconds and res.n_launched >= opt.n_init):
        return True
    return False


def _harvest(state: em_mod.EMState, cfg: EMConfig, md_fit):
    """Host copies of the per-lane results and a (lane, its K in a
    mixed-K lattice, or 0) -> params getter (dense params: bucketed p
    merged by ``md_fit``'s plan)."""
    fields = ("logL", "converged", "n_iter", "failed", "mono_viol")
    count("host.syncs", len(fields))
    host = {f: getattr(state, f).cpu().numpy() for f in fields}

    def get(lane, k_lane=0):
        return lane_params(state.params, lane, cfg, md_fit, k_lane)
    return host, get


def _fit_data(md: ModelData, cfg: EMConfig,
              plan: Optional[bucketed.JaggedPlan]):
    """(what the chains run on, its dense layout): the collapsed column
    sums of constrained-eta fits, or ``md``; bucketed by ``plan``
    (``model.bucketed.plan_for``) after the collapse, as the JAX package's
    ``_prepare_fit_data`` (multistart.py:713-794) does.  Starts, the hard
    partition and AIC/BIC use ``md``; Rand-EM scores on the dense
    layout.  Under a mesh, this rank's block (``md`` when it is one); the
    collapsed data has one row, whole on every rank of a data group."""
    constrained = cfg.admixture and cfg.eta_constrained
    md = mesh_mod.as_block(md, cfg.mesh)
    dense = md
    if constrained:
        dense = (collapse_for_constrained(md) if cfg.mesh is None
                 else _collapse_block(md, cfg.mesh))
    if plan is None:
        return dense, dense
    return bucketed.bucketize_model_data(dense, plan), dense


def _collapse_block(md: ModelData, mesh) -> ModelData:
    """``collapse_for_constrained`` of a block: its rows' column sums
    summed over the data group, and ``c`` the panel's missing total."""
    dtype = md.dtype

    def col(t):
        return mesh.sum(t.to(dtype).sum(dim=0, keepdim=True),
                        mesh_mod.DATA_AXIS)
    return ModelData(x=col(md.x), miss=col(md.miss), mask=md.mask,
                     n_alleles=md.n_alleles, c=col(md.c),
                     block=md.block._replace(I=1, row0=0))


def _chains(opt: Options, md_fit, K: int, cfg: EMConfig) -> int:
    """The chain batch of K's serial loop (``cfg`` that of a fit of K
    alone): ``chain_batch``, at most n_init under a fixed count."""
    B = chain_batch(opt, md_fit, K, cfg)
    if not (opt.target_revisit or opt.target_ll or opt.n_seconds):
        B = min(B, opt.n_init)
    return B


def _run_continuous(gen, res: MaximizeResult, md: ModelData,
                    md_fit: ModelData, md_score: ModelData, K: int,
                    cfg: EMConfig, opt: Options, n_parameters: int,
                    t0: float, segment: int = 16, on_improve=None,
                    progress=None) -> None:
    """Continuous batching: B chains run in lockstep segments; a stopped
    lane is harvested and refilled with a fresh start at once instead of
    idling until the slowest chain finishes.  Starts are drawn on ``md``
    and Rand-EM scored on ``md_score``; the chains run on ``md_fit``."""
    fixed_n = (not opt.target_revisit and not opt.target_ll
               and not opt.n_seconds)
    with span("mc.plan"):
        B = _chains(opt, md_fit, K, cfg)
        res.batch_chains = B
        if cfg.bi_repr_active:
            res.route = bi_route(B, md_fit, cfg,
                                 k_padded_size(K, 32)).describe()

    def starts(n):
        return _pad_k(_draw_init_batch(gen, n, md, K, cfg, opt, md_score),
                      cfg)

    with span("mc.init"):
        pb = starts(B)
    with span("mc.em"):
        state = _make_state(pb, md_fit, cfg)
    launched = B
    harvested = np.zeros(B, dtype=bool)

    def bookkeep(lanes, timed_out) -> bool:
        host, get = _harvest(state, cfg, md_fit)
        for lane in lanes:
            harvested[lane] = True
            if _bookkeep_lane(
                    res, opt, n_parameters, md.I_total,
                    float(host["logL"][lane]),
                    bool(host["converged"][lane]),
                    int(host["n_iter"][lane]), bool(host["failed"][lane]),
                    bool(host["mono_viol"][lane]),
                    lambda ln=lane: get(ln), timed_out,
                    on_improve=on_improve, progress=progress):
                return True
        return False

    while True:
        with span("mc.harvest"):
            count("host.syncs")
            stopped = state.stopped.cpu().numpy()
            fresh_lanes = np.nonzero(stopped & ~harvested)[0]
            if fresh_lanes.size and bookkeep(fresh_lanes, False):
                return

        want_more = (launched < opt.n_init) if fixed_n else True
        refillable = np.nonzero(harvested)[0]
        if want_more and refillable.size:
            nref = refillable.size
            if fixed_n:
                nref = min(nref, opt.n_init - launched)
            lanes = refillable[:nref]
            with span("mc.init"):
                count("host.syncs")     # the lanes' copy to the device
                idx = torch.as_tensor(lanes, device=md_fit.device)
                pb = starts(nref)
            with span("mc.em"):
                state = em_mod.tree_map(
                    lambda old, new: old.index_copy(0, idx, new), state,
                    _make_state(pb, md_fit, cfg))
            launched += nref
            harvested[lanes] = False
        elif harvested.all():
            return  # nothing active and no more chains wanted

        if opt.n_seconds and mesh_mod.past_deadline(t0, opt.n_seconds):
            # harvest the active lanes as timed out (best-so-far logL
            # counts, multiclust.c:538-560 with time_stop)
            with span("mc.harvest"):
                if not bookkeep(np.nonzero(~harvested)[0], True):
                    res.time_stop = True
            return

        with span("mc.em"):
            state = _segment(state, md_fit, cfg, segment)


def _single_init(gen, md, K, cfg, opt, warm, md_score=None):
    if warm is not None:
        return _pad_k(_warm_block(warm, md, cfg), cfg)
    return _pad_k(rinit.initialize(
        gen, md, K, cfg, method=opt.initialization_method,
        procedure=opt.initialization_procedure,
        n_rand_em_init=opt.n_rand_em_init, md_score=md_score), cfg)


def maximize_likelihood(gen: torch.Generator, md: ModelData, K: int,
                        opt: Options, n_parameters: int,
                        warm: Optional[Params] = None, true_partition=None,
                        checkpoint_dir: Optional[str] = None,
                        on_improve=None, quiet: bool = False
                        ) -> MaximizeResult:
    """Maximize over initializations (maximize_likelihood,
    multiclust.c:471-656).  ``checkpoint_dir`` persists the counters, the
    best parameters and ``gen``'s state after every batch of chains and
    resumes from them (runtime/checkpoint.py); ``on_improve(res)`` fires
    whenever an init improves the best logL (best-so-far outputs,
    multiclust.c:584-600); ``quiet`` suppresses the per-init progress
    lines (bootstrap replicate fits)."""
    with span("mc.plan"):
        cfg = cfg_from_options(opt, K, md)
        md = mesh_mod.as_block(md, cfg.mesh)
        res = MaximizeResult(K=K)
        t0 = time.time()
        progress = _make_progress(opt, K, t0, quiet)
        plan = bucketed.plan_for(md) if cfg.model_shards == 1 else None
        md_fit, md_score = _fit_data(md, cfg, plan)

    if checkpoint_dir:
        from multiclust_tpu_torch.runtime import checkpoint as ckpt
        loaded = ckpt.load(checkpoint_dir, K, dtype=md.dtype,
                           device=md.device, gen=gen)
        if loaded is not None:
            res = loaded
            if _regimes_satisfied(res, opt):
                _score_arand(res, md, opt, true_partition, cfg.mesh)
                return res

    if isinstance(md_fit, BucketedData):
        res.buckets = md_fit.plan.describe()
    if K == 1:
        with span("mc.init"):
            params = _single_init(gen, md, K, cfg, opt, warm, md_score)
        with span("mc.em"):
            state = em_mod.fit_k1(
                _to_fit_layout(map_params(lambda t: t[None], params),
                               md_fit, cfg), md_fit, cfg)
        with span("mc.harvest"):
            count("host.syncs")
            ll = float(state.logL[0])
            res.best_params = lane_params(state.params, 0, cfg, md_fit)
        res.max_logL = res.first_max_logL = ll
        res.aic = aic_fn(ll, n_parameters)
        res.bic = bic_fn(ll, n_parameters, md.I_total)
        res.n_init = res.n_launched = 1
        res.n_total_iter = res.n_max_iter = 1
        res.n_maxll_init = 1
        res.n_maxll_times = 1
        res.ever_converged = True
        res.seconds = time.time() - t0
        _score_arand(res, md, opt, true_partition, cfg.mesh)
        return res

    def checkpoint():
        res.seconds = time.time() - t0
        if checkpoint_dir:
            from multiclust_tpu_torch.runtime import checkpoint as ckpt
            ckpt.save(checkpoint_dir, K, res, gen)

    # at verbosity > MINIMAL the reference prints one line per EM
    # iteration (stop, em_alg.c:123-136): one traced chain a round
    serial = opt.verbosity > 3
    if not serial and warm is None:
        _run_continuous(gen, res, md, md_fit, md_score, K, cfg, opt,
                        n_parameters, t0, on_improve=on_improve,
                        progress=progress)
        checkpoint()
        _score_arand(res, md, opt, true_partition, cfg.mesh)
        return res

    # -Q/-P warm start: every init identical (initialize_model,
    # rnd_init.c:74-76); one chain a round
    if warm is not None:
        with span("mc.init"):
            warm_b = map_params(lambda t: t[None],
                                _pad_k(_warm_block(warm, md, cfg), cfg))
    if cfg.bi_repr_active:
        res.route = bi_route(1, md_fit, cfg, k_padded_size(K, 32)).describe()
    while True:
        if serial:
            states, timed_out = _fit_serial_traced(
                gen, md, md_fit, md_score, K, cfg, opt, warm, t0)
        else:
            states, timed_out = fit_batch(warm_b, md_fit, cfg,
                                          n_seconds=opt.n_seconds,
                                          start_time=t0)
        with span("mc.harvest"):
            host, get = _harvest(states, cfg, md_fit)
            done = _bookkeep_lane(
                res, opt, n_parameters, md.I_total, float(host["logL"][0]),
                bool(host["converged"][0]), int(host["n_iter"][0]),
                bool(host["failed"][0]), bool(host["mono_viol"][0]),
                lambda: get(0), timed_out, on_improve=on_improve,
                progress=progress)
        # warm starts are deterministic; more chains are pointless unless
        # a count/target regime explicitly asks for them
        if (warm is not None and res.n_launched >= opt.n_init
                and not (opt.target_revisit or opt.target_ll
                         or opt.n_seconds)):
            done = True
        checkpoint()
        if done:
            break
    _score_arand(res, md, opt, true_partition, cfg.mesh)
    return res


def sweep_device(md: ModelData) -> bool:
    """A K-sweep may run as one mixed-K lattice: its fit runs on a CUDA
    device (the JAX package asks ``device_policy()[0]``, an
    accelerator)."""
    return md.device.type == "cuda"


# bytes the chain states of a mixed-K lattice may hold at once
# (multistart.py:946-949)
SWEPT_STATE_BYTES = 4e9


def swept_eligible(opt: Options, md: ModelData, ks) -> bool:
    """The gate of the mixed-K lattice (``swept_eligible``, the JAX
    package's multistart.py:918-949, condition for condition): at least
    two K >= 2 under the fixed-count regime, at verbosity <= 3, with no
    mesh, on a CUDA fit device, every K >= 2 padded to one 32-lane
    count, and every K's chain states resident at once within
    SWEPT_STATE_BYTES (about (3 + 2 q) copies of eta and p a chain).
    Everything else runs the serial loop (estimate_model,
    multiclust.c:365-452)."""
    ks = [K for K in ks if K >= 2]
    if len(ks) < 2:
        return False
    if (opt.target_ll or opt.target_revisit or opt.n_seconds
            or opt.verbosity > 3 or opt.n_init < 1):
        return False
    if opt.mesh_shape:
        return False
    if not sweep_device(md):
        return False
    if k_padded_size(min(ks), 32) != k_padded_size(max(ks), 32):
        return False
    Kp = k_padded_size(max(ks), 32)
    B = min(opt.batch_chains or min(max(opt.n_init, 1), MAX_AUTO_CHAINS),
            opt.n_init)
    per_chain = (md.I * Kp + Kp * md.L * md.M) * 4
    copies = 3 + 2 * (opt.q if int(opt.accel_scheme) else 0)
    return len(ks) * B * per_chain * copies < SWEPT_STATE_BYTES


def swept_maximize(gens_by_K, md: ModelData, opt: Options, n_parameters_fn,
                   true_partition=None, on_improve=None,
                   quiet: bool = False, segment: int = 16):
    """Fit every K of a K-sweep as ONE mixed-K chain lattice
    (``swept_maximize``, the JAX package's multistart.py:952-1093).

    ``gens_by_K``: (K, generator) pairs, K >= 2, each generator the one
    the serial loop gives K.  The config is the largest K's; every chain
    runs on its lanes (``lattice_lanes``) with its kmask.  Each K's group
    keeps its own generator stream, chain batch (that of its serial loop,
    ``chain_batch`` under K's own config), refill schedule and
    completion-order bookkeeping, so the lattice fits the chains the
    serial loop fits, and each K's results match it up to the rounding of
    a wider batch.  Fixed-count regime only (``swept_eligible``).
    ``on_improve(K, res)`` fires as ``estimate_model``'s does.  Returns
    {K: MaximizeResult}."""
    ks = [K for K, _ in gens_by_K]
    with span("mc.plan"):
        cfg = cfg_from_options(opt, max(ks), md)
        t0 = time.time()
        plan = bucketed.plan_for(md)
        md_fit, md_score = _fit_data(md, cfg, plan)
        width = lattice_lanes(max(ks), cfg)
        groups = []
        off = 0
        for K, gen in gens_by_K:
            B = _chains(opt, md_fit, K, static_cfg(cfg, K))
            res = MaximizeResult(K=K, batch_chains=B,
                                 buckets=plan.describe() if plan else "")
            groups.append(dict(K=K, gen=gen, B=B, off=off, res=res,
                               harvested=np.zeros(B, dtype=bool),
                               launched=B, done=False,
                               n_parameters=n_parameters_fn(K),
                               progress=_make_progress(opt, K, t0, quiet)))
            off += B
        route = (bi_route(off, md_fit, cfg, width).describe()
                 if cfg.bi_repr_active else "")

    def draws(g, n):
        return _draw_init_batch(g["gen"], n, md, g["K"], cfg, opt, md_score,
                                width)

    def cat(parts):
        return map_params(lambda *t: torch.cat(t), *parts)

    with span("mc.init"):
        pb = cat([draws(g, g["B"]) for g in groups])
    with span("mc.em"):
        state = _make_state(pb, md_fit, cfg)
    while not all(g["done"] for g in groups):
        with span("mc.harvest"):
            count("host.syncs")
            stopped = state.stopped.cpu().numpy()
            if any((stopped[g["off"]:g["off"] + g["B"]]
                    & ~g["harvested"]).any()
                   for g in groups if not g["done"]):
                host, get = _harvest(state, cfg, md_fit)
                for g in groups:
                    if g["done"]:
                        continue
                    sl = slice(g["off"], g["off"] + g["B"])
                    fresh = np.nonzero(stopped[sl] & ~g["harvested"])[0]
                    for lane in fresh:
                        g["harvested"][lane] = True
                        ln = g["off"] + int(lane)
                        if _bookkeep_lane(
                                g["res"], opt, g["n_parameters"],
                                md.I_total,
                                float(host["logL"][ln]),
                                bool(host["converged"][ln]),
                                int(host["n_iter"][ln]),
                                bool(host["failed"][ln]),
                                bool(host["mono_viol"][ln]),
                                lambda ln=ln, K=g["K"]: get(ln, K), False,
                                on_improve=((lambda r, K=g["K"]:
                                             on_improve(K, r))
                                            if on_improve else None),
                                progress=g["progress"]):
                            g["done"] = True
                            break

        # refill each unfinished group's harvested lanes from its own
        # stream, as its serial loop does; one state update a pass
        with span("mc.init"):
            lanes, parts = [], []
            for g in groups:
                if g["done"] or g["launched"] >= opt.n_init:
                    continue
                refillable = np.nonzero(g["harvested"])[0]
                nref = min(refillable.size, opt.n_init - g["launched"])
                if not nref:
                    continue
                parts.append(draws(g, nref))
                lanes.append(g["off"] + refillable[:nref])
                g["launched"] += nref
                g["harvested"][refillable[:nref]] = False
            if parts:
                count("host.syncs")     # the lanes' copy to the device
                idx = torch.as_tensor(np.concatenate(lanes),
                                      device=md_fit.device)
                pb = cat(parts)
        if parts:
            with span("mc.em"):
                state = em_mod.tree_map(
                    lambda old, new: old.index_copy(0, idx, new), state,
                    _make_state(pb, md_fit, cfg))
        elif all(g["done"] or g["harvested"].all() for g in groups):
            break  # nothing runs and no more chains are wanted
        if not all(g["done"] for g in groups):
            with span("mc.em"):
                state = _segment(state, md_fit, cfg, segment)

    out = {}
    for g in groups:
        res = g["res"]
        res.route = route
        res.seconds = time.time() - t0
        _score_arand(res, md, opt, true_partition)
        out[g["K"]] = res
    return out


def _regimes_satisfied(res: MaximizeResult, opt: Options) -> bool:
    """Is a resumed sweep already past its stop regime?"""
    if res.time_stop:
        return True
    if opt.target_revisit and not opt.target_ll:
        return res.n_maxll_times >= opt.target_revisit
    if opt.target_ll:
        needed = opt.target_revisit or 1
        return res.n_targetll_times >= needed
    if not opt.n_seconds:
        return res.n_launched >= opt.n_init
    return False


def _fit_serial_traced(gen, md, md_fit, md_score, K, cfg, opt, warm, t0):
    """One chain, traced line by line at verbosity > MINIMAL (the trace
    reads the logL, the iteration and the step kind in the one host read
    a step makes); returns (its state, a batch of one, timed_out)."""
    from multiclust_tpu_torch.opt.driver import fit
    from multiclust_tpu_torch.runtime.observe import make_trace_printer

    with span("mc.init"):
        params = _single_init(gen, md, K, cfg, opt, warm, md_score)
    out = fit(_to_fit_layout(params, md_fit, cfg), md_fit, cfg,
              n_seconds=opt.n_seconds, start_time=t0,
              trace=make_trace_printer(opt.verbosity))
    return out.state, out.time_stop


def posterior_mass(params: Params, md: ModelData, admixture: bool,
                   eta_constrained: bool = False, mesh=None) -> torch.Tensor:
    """[I, K] cluster mass per individual of unbatched full-layout params:
    the mixture's posterior (partition_mixture, write_file.c:582-600), or
    the admixture's posterior allele mass (partition_admixture
    :350-382).  Of a block (``md.block``, under ``mesh``): the whole
    params' block, and the mass of its rows, summed over the model
    group."""
    if md.block is not None:
        r0, l0 = md.offsets
        eta = params.eta
        if admixture and not eta_constrained:
            eta = eta[r0:r0 + md.I]
        params = Params(eta=eta, p=params.p[:, l0:l0 + md.L])
    if admixture:
        return posterior_allele_mass(params, md, eta_constrained, mesh=mesh)
    return e_step(Params(params.eta[None], params.p[None]), md, mesh)[0][0]


def hard_partition(params: Params, md: ModelData, admixture: bool,
                   eta_constrained: bool = False, mesh=None) -> np.ndarray:
    """MAP cluster per individual (of a block's rows): the argmax of
    ``posterior_mass``."""
    count("host.syncs")
    return torch.argmax(posterior_mass(params, md, admixture,
                                       eta_constrained, mesh),
                        dim=1).cpu().numpy()


def _score_arand(res: MaximizeResult, md, opt: Options, true_partition,
                 mesh=None):
    if true_partition is None or res.best_params is None:
        return
    if md.block is not None:
        from multiclust_tpu_torch.runtime.ingest import \
            score_arand_distributed
        res.arand = score_arand_distributed(opt, md, res.best_params,
                                            true_partition, mesh)
        return
    from multiclust_tpu_torch.stats.rand_index import adjusted_rand
    res.arand = adjusted_rand(np.asarray(true_partition),
                              hard_partition(res.best_params, md,
                                             opt.admixture,
                                             opt.eta_constrained))
