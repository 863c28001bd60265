"""Admixture model, main-path part (multiclust_tpu/model/admixture.py).

Likelihood (logL_admixture, log_likelihood.c:96-147):
    logL = sum_{i,l,m} x_ilm log( sum_k eta_ik p_klm )

The step never materializes the responsibility tensor: with
w = x / (eta @ p) the whole EM step is four products,

    denom = eta @ p,  A = w @ p^T,  B = eta^T @ w,  C = eta^T @ miss,

because sum_lm d_iklm = eta_ik (A_ik + c_i) and sum_i d_iklm = p_klm (B_klm
+ C_kl).  Every function takes a chain batch: eta [B, I, K] and p
[B, K, L, M], or the biallelic p0 layout p [B, Kp, L]; constrained eta
(cfg.eta_constrained) is one K-vector per chain, eta [B, K], and its step
reads only the column sums of the data.  logL values are
float64 sums of the per-individual terms, returned with the RMS scale of
those terms that the noise floor reads (opt/em.py).

A jagged panel's bucketed layout (model/bucketed.py) runs the same sums one
bucket at a time: A, t and the constrained step's a add up over the
buckets, p is updated bucket by bucket at its own M_b, eta once.

The chains of a mixed-K lattice (runtime/ksweep.py) carry their true
lanes as ``params.kmask`` ([B, Kp], a row a chain): every route projects
eta and keeps p over each chain's lanes (the JAX package's
``_project_eta_rows`` / ``_normalize_p`` with a kmask,
multiclust_tpu/model/admixture.py:58-88), the kernels through their
runtime mask, and the step returns the mask with the new parameters.
A chain's lanes outside its mask hold eta 0 and p 0, so they add nothing
to any product.

Under a mesh (cfg.mesh, runtime/mesh.py) every function runs on this
rank's block of rows and loci and writes out the collectives GSPMD inserts
for the JAX package: the per-individual sums over loci (A + r, t, the
constrained step's a and logL lanes) over the model group, the per-locus
sums over individuals (B, B0/B1) and the logL over the data group.  The
step takes the route the unmeshed step takes on the block's shape, with
the kernels' sharded variants (``emit_b``, ``emit_a``, ``finish=False``)
where a sum must cross ranks before a finish.
"""

from __future__ import annotations

from typing import Optional, Tuple

import sys

import torch

from multiclust_tpu_torch.model.bucketed import BucketedData, \
    split_params_like
from multiclust_tpu_torch.model.common import EMConfig, ModelData, Params, \
    WINDOW_BYTES, column_window, is_bi_repr, safe_log
from multiclust_tpu_torch.ops.fullstep import admixture_fullstep, \
    admixture_sweep_stats, fullstep_cols, fullstep_p, fullstep_rows, \
    normalize_p, rows_and_partials
from multiclust_tpu_torch.ops.fullstep_bi import KP_MAX, Route, \
    admixture_fullstep_biallelic_chunked, \
    admixture_fullstep_biallelic_routed, device_sm_count, is_wide, \
    p0_epilogue, pick_route, rows_finish, rows_log_likelihood_terms, \
    scratch_budget
from multiclust_tpu_torch.ops.simplex import kmask_lanes, project_rows
from multiclust_tpu_torch.runtime.mesh import DATA_AXIS, MODEL_AXIS, \
    sum_over

Tensor = torch.Tensor


def _safe_div(num: Tensor, den: Tensor) -> Tensor:
    ok = num > 0
    return torch.where(ok, num / torch.where(den > 0, den,
                                             torch.ones_like(den)),
                       torch.zeros_like(num))


def _k_valid(cfg: EMConfig, Kp: int, device) -> Optional[Tensor]:
    """bool[Kp] marking true clusters under the K-padded layout, or None
    when the parameters are unpadded."""
    kt = cfg.k_true or Kp
    if kt == Kp:
        return None
    return torch.arange(Kp, device=device) < kt


def _project_eta_rows(eta: Tensor, cfg: EMConfig,
                      kmask: Optional[Tensor] = None) -> Tensor:
    """eta's rows projected onto the lanes below cfg.k_true, or onto each
    chain's ``kmask`` lanes where one is given."""
    if kmask is not None:
        return project_rows(eta, kmask_lanes(kmask, eta.dim()),
                            cfg.eta_lower_bound)
    kv = _k_valid(cfg, eta.shape[-1], eta.device)
    if kv is None:
        kv = torch.ones(eta.shape[-1], dtype=torch.bool, device=eta.device)
    return project_rows(eta, kv, cfg.eta_lower_bound)


def _normalize_p(pc: Tensor, md: ModelData, cfg: EMConfig,
                 kmask: Optional[Tensor] = None) -> Tensor:
    return normalize_p(pc, md.mask, k_true=cfg.k_true or pc.shape[-3],
                       plb=cfg.p_lower_bound, project=cfg.do_projection,
                       kmask=kmask)


def _ll_terms(per_i: Tensor, mesh=None, axis: str = DATA_AXIS
              ) -> Tuple[Tensor, Tensor]:
    """(logL [B], scale [B]) in float64 from per-individual terms (or the
    constrained step's per-lane terms); under a mesh this rank's terms,
    their sums and sums of squares added over ``axis``."""
    per_i = per_i.to(torch.float64)
    ll, sq = per_i.sum(dim=-1), (per_i * per_i).sum(dim=-1)
    if mesh is not None:
        ll, sq = mesh.sum(torch.stack([ll, sq]), axis).unbind(0)
    return ll, torch.sqrt(sq)


def _no_ll(eta: Tensor) -> Tuple[Tensor, Tensor]:
    z = torch.zeros(eta.shape[0], dtype=torch.float64, device=eta.device)
    return z, z


def em_step(params: Params, md: ModelData, cfg: EMConfig,
            want_ll: bool = True, route: Optional[Route] = None
            ) -> Tuple[Params, Tensor, Tensor]:
    """One fused E+M iteration for a chain batch; the logL is that of the
    INPUT params.  ``want_ll=False`` skips the logL terms and returns
    zeros (the blind steps of opt/em.blind_plain_steps).  ``route`` fixes
    the biallelic step's route (``bi_route`` picks it when None).  The new
    parameters carry the input's kmask."""
    if isinstance(md, BucketedData):
        out = _em_step_bucketed(params, md, cfg, want_ll)
    elif cfg.eta_constrained:
        out = _em_step_constrained(params, md, cfg, want_ll)
    elif cfg.bi_repr_active and is_bi_repr(params):
        out = _em_step_bi_repr(params, md, cfg, want_ll, route)
    elif cfg.use_pallas != "off" and params.p.dtype == torch.float32:
        out = _em_step_generic(params, md, cfg, want_ll)
    else:
        out = _em_step_unconstrained(params, md, cfg, want_ll)
    new, ll, scale = out
    return new._replace(kmask=params.kmask), ll, scale


def _miss_inputs(md: ModelData, cfg: EMConfig, dtype):
    """(c [I], miss [I, L] or None) for the kernels; miss keeps its
    storage dtype (int8 on CUDA)."""
    if not cfg.has_missing:
        return torch.zeros(md.I, dtype=dtype, device=md.device), None
    return md.c.to(dtype), md.miss


def bi_route(n_chains: int, md: ModelData, cfg: EMConfig, Kp: int) -> Route:
    """The biallelic step's route for a batch of ``n_chains`` on ``md``
    (ops/fullstep_bi.pick_route, the counterpart of
    pick_layout_biallelic_any): from the shapes, the device's SM count and
    the scratch budget of the fit (read from the device when the config
    carries none)."""
    budget = cfg.scratch_budget or scratch_budget(md.device)
    return pick_route(n_chains, md.I, md.L, Kp, device_sm_count(md.device),
                      budget, cfg.k_true)


def _em_step_bi_repr(params: Params, md: ModelData, cfg: EMConfig,
                     want_ll: bool = True, route: Optional[Route] = None):
    """Biallelic step on the p0 layout: params.p IS p0 [B, Kp, L] (pads
    zero), one routed step (a kernel pair, the streamed pair with its
    finish, or the chunked loop of them) per EM iteration for the whole
    chain batch."""
    eta, p0 = params.eta, params.p
    if route is None:
        route = bi_route(eta.shape[0], md, cfg, eta.shape[-1])
    if cfg.mesh is not None:
        return _em_step_bi_repr_meshed(params, md, cfg, want_ll, route)
    c, miss = _miss_inputs(md, cfg, eta.dtype)
    eta_new, per_i, p0n = admixture_fullstep_biallelic_routed(
        eta, p0, md.x0, md.x1, c, miss, params.kmask, route=route,
        k_true=cfg.k_true,
        lb=float(cfg.eta_lower_bound), plb=float(cfg.p_lower_bound),
        project=cfg.do_projection, compute_t=want_ll)
    ll, scale = _ll_terms(per_i) if want_ll else _no_ll(eta)
    return Params(eta=eta_new, p=p0n), ll, scale


def _em_step_bi_repr_meshed(params: Params, md: ModelData, cfg: EMConfig,
                            want_ll: bool, route: Route):
    """The biallelic step on this rank's (I_loc, L_loc) block
    (``_em_step_bi_repr_meshed``, multiclust_tpu/model/admixture.py:
    170-280): the streamed or chunked step of the block's route (the pair
    takes no ``emit_*`` flag, so it runs as one segment a window) with
    ``emit_b``: raw B0/B1, summed over the data group, then the p0
    epilogue on this rank's loci.  With the loci split (M > 1) also
    ``emit_a``: the raw A + r (no c) and t cover only this rank's loci, so
    they are summed over the model group before the rows finish adds c and
    finishes eta, as a single segment."""
    mesh = cfg.mesh
    eta, p0 = params.eta, params.p
    lb, plb = float(cfg.eta_lower_bound), float(cfg.p_lower_bound)
    c, miss = _miss_inputs(md, cfg, eta.dtype)
    emit_a = mesh.model_shards > 1
    eta_new, per_i, b0, b1 = admixture_fullstep_biallelic_chunked(
        eta, p0, md.x0, md.x1, c, miss, params.kmask, window=route.window,
        seg_cols=route.seg_cols or route.window, k_true=cfg.k_true, lb=lb,
        plb=plb, project=cfg.do_projection, compute_t=want_ll, emit_b=True,
        emit_a=emit_a, n_rseg=route.n_rseg)
    if emit_a:
        araw = mesh.sum(eta_new, MODEL_AXIS)
        if want_ll:
            per_i = mesh.sum(per_i, MODEL_AXIS)
        eta_new, _ = rows_finish(
            eta, araw[:, None], eta.new_zeros((eta.shape[0], 1,
                                               eta.shape[1])), c,
            kmask=params.kmask, k_true=cfg.k_true, lb=lb,
            project_eta=cfg.do_projection, compute_t=False)
    part = mesh.sum(torch.stack([b0, b1], dim=1), DATA_AXIS)
    p0n = torch.empty_like(p0)
    p0_epilogue(p0, part[:, None], (p0n,), l_lo=0, l_hi=p0.shape[-1],
                k_true=cfg.k_true, plb=plb, project=cfg.do_projection)
    ll, scale = _ll_terms(per_i, mesh) if want_ll else _no_ll(eta)
    return Params(eta=eta_new, p=p0n), ll, scale


def log_likelihood_bi_repr(params: Params, md: ModelData,
                           budget: int = WINDOW_BYTES, k_true: int = 0,
                           mesh=None):
    """logL on the p0 layout (the accelerated accept test).  Float32
    chains on CUDA take the t terms of the segmented rows pass (A phase
    skipped): the same terms as the step's own, and no [B, I, L]
    temporary.  Elsewhere the plain terms are summed one column window of
    about ``budget`` bytes at a time, each individual's in float64.
    ``k_true`` (0: all padded lanes) is where the kernel's loops stop.
    Under a ``mesh`` the block's terms are summed over the model group."""
    eta, p0 = params.eta, params.p
    if eta.is_cuda and eta.dtype == torch.float32:
        per_i = rows_log_likelihood_terms(eta, p0, md.x0, md.x1,
                                          k_true=k_true)
        return _ll_terms(_sum_loci(per_i, mesh), mesh)
    B, I, _ = eta.shape
    itemsize = torch.finfo(eta.dtype).bits // 8
    win = column_window(md.L, 6 * B * I * itemsize, budget)
    s = eta.sum(dim=-1, keepdim=True)
    per_i = torch.zeros((B, I), dtype=torch.float64, device=eta.device)
    for lo in range(0, md.L, win):
        hi = min(md.L, lo + win)
        d0 = eta @ p0[..., lo:hi]                     # [B, I, window]
        d1 = s - d0
        t = (md.x0[:, lo:hi].to(eta.dtype) * safe_log(d0)
             + md.x1[:, lo:hi].to(eta.dtype) * safe_log(d1))
        per_i += t.sum(dim=-1).to(torch.float64)
    return _ll_terms(_sum_loci(per_i, mesh), mesh)


def _sum_loci(per_i: Tensor, mesh) -> Tensor:
    """Per-individual terms of this rank's loci summed over the model
    group (float64)."""
    if mesh is None:
        return per_i
    return mesh.sum(per_i.to(torch.float64), MODEL_AXIS)


_K_BEYOND_NOTICED = set()


def _beyond_kernels(Kp: int) -> bool:
    """Kp above the kernels' range: the step takes the plain formulation,
    with a notice once per lane count, as the JAX package's Pallas step
    does above its ladder (``_notice_k_beyond_ladder``,
    multiclust_tpu/model/admixture.py:465-499; the reference's -k has no
    bound, multiclust.c:1447-1453)."""
    if Kp <= KP_MAX:
        return False
    if Kp not in _K_BEYOND_NOTICED:
        _K_BEYOND_NOTICED.add(Kp)
        print(f"multiclust-tpu: K lanes ({Kp}) exceed the CUDA kernels' "
              f"range ({KP_MAX}); using the plain formulation",
              file=sys.stderr)
    return True


def _em_step_generic(params: Params, md: ModelData, cfg: EMConfig,
                     want_ll: bool = True):
    """Generic (multi-allelic) float32 step on the K-padded full layout
    (the single-device branch of _em_step_unconstrained_pallas,
    multiclust_tpu/model/admixture.py:477-574): one kernel triple per EM
    iteration for the whole chain batch (ops/fullstep.py), x read as its
    int8 [I, L*M] view, p normalized and projected on the card.  Above
    KP_MAX lanes: the plain step, with the notice."""
    eta, p = params.eta, params.p                     # [B,I,Kp], [B,Kp,L,M]
    nb, Kp = p.shape[0], p.shape[1]
    if _beyond_kernels(Kp):
        return _em_step_unconstrained(params, md, cfg, want_ll)
    c, miss = _miss_inputs(md, cfg, eta.dtype)
    if cfg.mesh is not None:
        return _em_step_generic_meshed(params, md, cfg, want_ll, c, miss)
    eta_new, per_i, p_new = admixture_fullstep(
        eta, p.reshape(nb, Kp, -1), md.x_lanes, c, miss, md.mask,
        params.kmask, k_true=cfg.k_true or Kp, lb=float(cfg.eta_lower_bound),
        plb=float(cfg.p_lower_bound), project=cfg.do_projection,
        compute_t=want_ll)
    ll, scale = _ll_terms(per_i) if want_ll else _no_ll(eta)
    return Params(eta=eta_new, p=p_new), ll, scale


def _em_step_generic_meshed(params: Params, md: ModelData, cfg: EMConfig,
                            want_ll: bool, c: Tensor, miss):
    """The generic float32 step on this rank's block.  Loci whole (M = 1,
    ``_sharded_fullstep``, multiclust_tpu/model/admixture.py:340-380): the
    rows pass with its eta finish, the columns pass with ``finish=False``,
    raw B (miss folded in) summed over the data group, then the p epilogue
    on the merged B.  Loci split (``_sharded_sweep`` and
    ``_em_step_unconstrained_pallas_meshed``, :383-420, :622-660): the
    sweep statistics A, t, B of ``admixture_sweep_stats``; A and t summed
    over the model group, B over the data group; then the rows finish (c
    added, eta finished as a single segment) and the p epilogue on the
    merged statistics."""
    mesh = cfg.mesh
    eta, p, kmask = params.eta, params.p, params.kmask
    nb, Kp = p.shape[0], p.shape[1]
    k_true = cfg.k_true or Kp
    lb = float(cfg.eta_lower_bound)
    p2 = p.reshape(nb, Kp, -1)
    if mesh.model_shards == 1:
        eta_new, per_i = fullstep_rows(
            eta, p2, md.x_lanes, c, None, kmask, k_true=k_true, lb=lb,
            project=cfg.do_projection, compute_t=want_ll, M=md.M)
        p_new = _generic_p(eta, p2, md, cfg, k_true, kmask=kmask)
    else:
        A, per_i, Bm = admixture_sweep_stats(
            eta, p2, md.x_lanes, miss, M=md.M, k_true=k_true,
            compute_t=want_ll)
        A = mesh.sum(A, MODEL_AXIS)
        if want_ll:
            per_i = _sum_loci(per_i, mesh)
        eta_new, _ = rows_finish(
            eta, A[:, None], eta.new_zeros((nb, 1, eta.shape[1])), c,
            kmask=kmask, k_true=k_true, lb=lb,
            project_eta=cfg.do_projection, compute_t=False)
        Bm = mesh.sum(Bm, DATA_AXIS)
        p_new = fullstep_p(p2, Bm[:, None], md.mask, kmask, M=md.M,
                           k_true=k_true, plb=float(cfg.p_lower_bound),
                           project=cfg.do_projection)
    ll, scale = _ll_terms(per_i, mesh) if want_ll else _no_ll(eta)
    return Params(eta=eta_new, p=p_new), ll, scale


def _sweep(eta: Tensor, p: Tensor, md: ModelData, cfg: EMConfig,
           want_ll: bool, kmask: Optional[Tensor] = None):
    """One block of loci's part of the plain step (``_bucket_sweep`` and
    ``_finish_bucket_p``, multiclust_tpu/model/admixture.py:662-684): (A
    [B, I, K] without c, t [B, I] or None, p' [B, K, L, M]).  Under a mesh
    B is summed over the data group before p is normalized; A and t are
    this rank's loci's."""
    A, t, Bm = _sweep_stats(eta, p, md, cfg, want_ll)
    Bm = sum_over(cfg.mesh, Bm, DATA_AXIS)
    return A, t, _normalize_p(p * Bm, md, cfg, kmask)


def _sweep_stats(eta: Tensor, p: Tensor, md: ModelData, cfg: EMConfig,
                 want_ll: bool):
    """The plain sweep statistics of one block of loci: (A, t or None, B
    [B, K, L, M] with the miss fold)."""
    nb, K = p.shape[0], p.shape[1]
    p2 = p.reshape(nb, K, -1)                         # [B, K, LM]
    x2 = md.x2d                                       # [I, LM]
    denom = eta @ p2                                  # [B, I, LM]
    w = _safe_div(x2, denom)
    t = (torch.where(x2 > 0, x2 * safe_log(denom),
                     torch.zeros_like(w)).sum(dim=-1) if want_ll else None)
    # p update: sum_i d_iklm = p_klm (B_klm + C_kl)
    et = eta.transpose(-1, -2)
    Bm = (et @ w).reshape(p.shape)                    # [B, K, L, M]
    if cfg.has_missing:
        Bm = Bm + (et @ md.miss.to(eta.dtype))[..., None]
    # eta statistics: sum_lm d_iklm = eta_ik (A_ik + c_i)
    return w @ p2.transpose(-1, -2), t, Bm


def _eta_update(eta: Tensor, A: Tensor, c: Tensor, cfg: EMConfig,
                kmask: Optional[Tensor] = None) -> Tensor:
    """eta' from the merged A (c added when data are missing)."""
    if cfg.has_missing:
        A = A + c.to(A.dtype)[:, None]
    eta_num = eta * A
    tot = eta_num.sum(dim=-1, keepdim=True)
    # zero-mass rows keep their eta instead of 0/0
    ok = tot > 0
    eta_new = torch.where(ok, eta_num / torch.where(ok, tot,
                                                    torch.ones_like(tot)),
                          eta)
    if cfg.do_projection:
        eta_new = _project_eta_rows(eta_new, cfg, kmask)
    return eta_new


def _em_step_unconstrained(params: Params, md: ModelData, cfg: EMConfig,
                           want_ll: bool = True):
    """The plain step; under a mesh A and t are summed over the model
    group before the eta update and the logL (the formulation GSPMD
    shards for the JAX package)."""
    mesh = cfg.mesh
    A, t, p_new = _sweep(params.eta, params.p, md, cfg, want_ll,
                         params.kmask)
    A = sum_over(mesh, A, MODEL_AXIS)
    if want_ll:
        t = _sum_loci(t, mesh)
    ll, scale = _ll_terms(t, mesh) if want_ll else _no_ll(params.eta)
    return Params(eta=_eta_update(params.eta, A, md.c, cfg, params.kmask),
                  p=p_new), ll, scale


def _constrained_sweep(eta: Tensor, p: Tensor, md: ModelData, cfg: EMConfig,
                       want_ll: bool, kmask: Optional[Tensor] = None):
    """One block of loci's part of the constrained step: (a [B, K], the
    per-lane logL terms [B, LM] or None, p' [B, K, L, M])."""
    nb, K = p.shape[0], p.shape[1]
    p2 = p.reshape(nb, K, -1)                         # [B, K, LM]
    colx = md.x2d.sum(dim=0)                          # [LM]
    msum = md.miss.to(eta.dtype).sum(dim=0)           # [L]
    denom = (eta[:, None, :] @ p2)[:, 0]              # [B, LM]
    t = (torch.where(colx > 0, colx * safe_log(denom),
                     torch.zeros_like(denom)) if want_ll else None)
    S = _safe_div(colx, denom).reshape(nb, md.L, md.M) + msum[:, None]
    S = torch.where(md.mask, S, torch.zeros_like(S)).reshape(nb, -1)
    a = (p2 @ S[..., None])[..., 0]                   # [B, K]
    return a, t, _normalize_p(p * S.reshape(nb, 1, md.L, md.M), md, cfg,
                              kmask)


def _constrained_eta(eta: Tensor, a: Tensor, cfg: EMConfig,
                     kmask: Optional[Tensor] = None) -> Tensor:
    eta_num = eta * a
    eta_new = eta_num / eta_num.sum(dim=-1, keepdim=True)
    if cfg.do_projection:
        eta_new = _project_eta_rows(eta_new, cfg, kmask)
    return eta_new


def _em_step_constrained(params: Params, md: ModelData, cfg: EMConfig,
                         want_ll: bool = True):
    """Constrained-eta step (eta [B, K] shared by every individual): the
    data enter only through the column sums sum_i x_ilm and sum_i miss_il,
    so ``md`` may be the collapsed 1-row data (collapse_for_constrained).
    The logL terms are per allele lane."""
    a, t, p_new = _constrained_sweep(params.eta, params.p, md, cfg, want_ll,
                                     params.kmask)
    mesh = cfg.mesh
    # the a-term and the logL lanes of this rank's loci: summed over the
    # model group (the collapsed data is whole on each data group)
    a = sum_over(mesh, a, MODEL_AXIS)
    ll, scale = (_ll_terms(t, mesh, MODEL_AXIS) if want_ll
                 else _no_ll(params.eta))
    return Params(eta=_constrained_eta(params.eta, a, cfg, params.kmask),
                  p=p_new), ll, scale


def _em_step_bucketed(params: Params, bd: BucketedData, cfg: EMConfig,
                      want_ll: bool = True):
    """The step on a bucketed panel (``_em_step_bucketed``,
    multiclust_tpu/model/admixture.py:879-932): float32 chains with the
    kernels on take ``_bucketed_fullstep_chain`` up to KP_MAX lanes; every
    other step the plain sweep one bucket at a time, A and t summed over
    the buckets, eta updated once from the merged A."""
    params = split_params_like(params, bd)
    eta = params.eta
    if cfg.eta_constrained:
        return _em_step_constrained_bucketed(params, bd, cfg, want_ll)
    if (cfg.use_pallas != "off" and eta.dtype == torch.float32
            and not _beyond_kernels(eta.shape[-1])):
        return _bucketed_fullstep_chain(params, bd, cfg, want_ll)
    A, per_i, new_ps = None, None, []
    for md_b, p_b in zip(bd.buckets, params.p):
        A_b, t_b, p_new = _sweep(eta, p_b, md_b, cfg, want_ll, params.kmask)
        A = A_b if A is None else A + A_b
        if want_ll:
            per_i = t_b if per_i is None else per_i + t_b
        new_ps.append(p_new)
    ll, scale = _ll_terms(per_i, cfg.mesh) if want_ll else _no_ll(eta)
    return Params(eta=_eta_update(eta, A, bd.c, cfg, params.kmask),
                  p=tuple(new_ps)), ll, scale


def _bucketed_fullstep_chain(params: Params, bd: BucketedData,
                             cfg: EMConfig, want_ll: bool = True):
    """The bucketed step through the generic kernels, one launch chain a
    bucket at its own M_b (``_bucketed_fullstep_chain``,
    multiclust_tpu/model/admixture.py:787-839).  The rows passes run in
    plan order and thread A through ``a0``: raw (``finish=False``, no c)
    on every bucket but the last, which adds c and finishes and projects
    eta once, on the merged A; t is summed over the buckets in float64.
    Every pass reads the OLD eta.  Each bucket's columns pass and p
    epilogue then update its p, as the JAX package's consolidated epilogue
    ``_bucketed_p_epilogue`` (:687-717) does in one XLA pass for the same
    per-locus function.  Above 128 lanes a bucket's two passes run on one
    d (``ops/fullstep.rows_and_partials``) and its p epilogue follows."""
    eta, kmask = params.eta, params.kmask             # [B, I, Kp]
    nb, Kp = eta.shape[0], eta.shape[-1]
    kw = dict(k_true=cfg.k_true or Kp, project=cfg.do_projection)
    c = bd.c.to(eta.dtype) if cfg.has_missing else None
    last = len(bd.buckets) - 1
    A, per_i, new_ps = None, None, []
    for j, (md_b, p_b) in enumerate(zip(bd.buckets, params.p)):
        p2 = p_b.reshape(nb, Kp, -1)
        rkw = dict(lb=float(cfg.eta_lower_bound), compute_t=want_ll,
                   finish=j == last, M=md_b.M, **kw)
        c_j = c if j == last else None
        km_j = kmask if j == last else None
        if is_wide(Kp):
            A, t_b, part = rows_and_partials(
                eta, p2, md_b.x_lanes, c_j, A,
                md_b.miss if cfg.has_missing else None, km_j, **rkw)
            new_ps.append(_generic_p(eta, p2, md_b, cfg, kw["k_true"],
                                     part, kmask))
        else:
            A, t_b = fullstep_rows(eta, p2, md_b.x_lanes, c_j, A, km_j,
                                   **rkw)
        if want_ll:
            t_b = t_b.to(torch.float64)
            per_i = t_b if per_i is None else per_i + t_b
    if not new_ps:
        new_ps = [_generic_p(eta, p_b.reshape(nb, Kp, -1), md_b, cfg,
                             kw["k_true"], kmask=kmask)
                  for md_b, p_b in zip(bd.buckets, params.p)]
    ll, scale = _ll_terms(per_i, cfg.mesh) if want_ll else _no_ll(eta)
    return Params(eta=A, p=tuple(new_ps)), ll, scale


def _generic_p(eta: Tensor, p2: Tensor, md: ModelData, cfg: EMConfig,
               k_true: int, part: Optional[Tensor] = None,
               kmask: Optional[Tensor] = None) -> Tensor:
    """p' of one block of loci through the generic columns pass and p
    epilogue, or through the epilogue alone on the columns pass's
    partials ``part`` where a step has them; under a mesh the raw B
    (``finish=False``) is summed over the data group before the
    epilogue.  ``kmask``: each chain's rows, the others kept 0."""
    kw = dict(k_true=k_true, plb=float(cfg.p_lower_bound),
              project=cfg.do_projection)
    miss = md.miss if cfg.has_missing else None
    if cfg.mesh is None:
        if part is not None:
            return fullstep_p(p2, part, md.mask, kmask, M=md.M, **kw)
        return fullstep_cols(eta, p2, md.x_lanes, miss, md.mask, kmask,
                             **kw)
    if part is not None:
        Bm = fullstep_p(p2, part, M=md.M, k_true=k_true, finish=False)
    else:
        Bm = fullstep_cols(eta, p2, md.x_lanes, miss, md.mask,
                           k_true=k_true, finish=False)
    Bm = cfg.mesh.sum(Bm, DATA_AXIS)
    return fullstep_p(p2, Bm[:, None], md.mask, kmask, M=md.M, **kw)


def _em_step_constrained_bucketed(params: Params, bd: BucketedData,
                                  cfg: EMConfig, want_ll: bool = True):
    """The constrained step on a bucketed (collapsed) panel
    (``_em_step_constrained_bucketed``,
    multiclust_tpu/model/admixture.py:842-876): each bucket's a-term and
    per-lane logL terms at its own M_b, eta updated once."""
    eta = params.eta
    a, ts, new_ps = None, [], []
    for md_b, p_b in zip(bd.buckets, params.p):
        a_b, t_b, p_new = _constrained_sweep(eta, p_b, md_b, cfg, want_ll,
                                             params.kmask)
        a = a_b if a is None else a + a_b
        ts.append(t_b)
        new_ps.append(p_new)
    ll, scale = (_ll_terms(torch.cat(ts, dim=-1)) if want_ll
                 else _no_ll(eta))
    return Params(eta=_constrained_eta(eta, a, cfg, params.kmask),
                  p=tuple(new_ps)), ll, scale


def log_likelihood_bucketed(params: Params, bd: BucketedData,
                            cfg: EMConfig):
    """logL on a bucketed panel (``log_likelihood_bucketed``,
    multiclust_tpu/model/admixture.py:935-948), one bucket at a time in
    plain torch: no [B, I, L M_max] temporary.  Buckets compose with
    data-axis meshes only: a rank's rows hold every locus."""
    params = split_params_like(params, bd)
    if cfg.eta_constrained:
        return _ll_terms(torch.cat([
            _constrained_terms(params.eta, p_b, md_b)
            for md_b, p_b in zip(bd.buckets, params.p)], dim=-1))
    per_i = None
    for md_b, p_b in zip(bd.buckets, params.p):
        t = _terms(params.eta, p_b, md_b).to(torch.float64)
        per_i = t if per_i is None else per_i + t
    return _ll_terms(per_i, cfg.mesh)


def _constrained_terms(eta: Tensor, p: Tensor, md: ModelData) -> Tensor:
    """Per-lane logL terms [B, LM] of constrained-eta params."""
    denom = (eta[:, None, :] @ p.reshape(p.shape[0], p.shape[1], -1))[:, 0]
    colx = md.x2d.sum(dim=0)
    return torch.where(colx > 0, colx * safe_log(denom),
                       torch.zeros_like(denom))


def _terms(eta: Tensor, p: Tensor, md: ModelData) -> Tensor:
    """Per-individual logL terms [B, I] of full-layout params."""
    denom = eta @ p.reshape(p.shape[0], p.shape[1], -1)
    x2 = md.x2d
    return torch.where(x2 > 0, x2 * safe_log(denom),
                       torch.zeros_like(denom)).sum(dim=-1)


def log_likelihood_constrained(params: Params, md: ModelData, mesh=None):
    """logL of constrained-eta params (eta [B, K]) from the column sums;
    ``md`` may be the collapsed data.  Under a ``mesh`` the lanes of this
    rank's loci are summed over the model group."""
    return _ll_terms(_constrained_terms(params.eta, params.p, md), mesh,
                     MODEL_AXIS)


def log_likelihood(params: Params, md: ModelData, mesh=None):
    """logL of full-layout params (logL_admixture); under a ``mesh`` the
    terms of this rank's block, summed over the model group, then the
    data group."""
    return _ll_terms(_sum_loci(_terms(params.eta, params.p, md), mesh), mesh)


def posterior_allele_mass(params: Params, md: ModelData,
                          eta_constrained: bool = False,
                          budget: int = WINDOW_BYTES, mesh=None) -> Tensor:
    """dik[i, k] = sum_{l,m} d_iklm, expected allele copies sourced from
    cluster k, for unbatched full-layout params (partition_admixture,
    write_file.c:350-382; indivq_admix :525-543; popq_admix :446-459).
    ``eta_constrained``: eta is the shared K-vector.  The [I, L*M]
    temporaries are made one window of loci at a time, about ``budget``
    bytes each.  Under a ``mesh`` md and params are this rank's block:
    the sum over its loci is summed over the model group."""
    p = params.p                                      # [K, L, M]
    K = p.shape[0]
    eta = params.eta
    if eta_constrained:
        eta = eta[None, :].expand(md.I, -1)
    itemsize = torch.finfo(eta.dtype).bits // 8
    win = column_window(md.L, 4 * md.I * md.M * itemsize, budget)
    A = None
    for lo in range(0, md.L, win):
        hi = min(md.L, lo + win)
        p2 = p[:, lo:hi].reshape(K, -1)
        xw = md.x[:, lo:hi].reshape(md.I, -1).to(eta.dtype)
        a_w = _safe_div(xw, eta @ p2) @ p2.T
        A = a_w if A is None else A + a_w
    A = sum_over(mesh, A, MODEL_AXIS)
    return eta * (A + md.c.to(eta.dtype)[:, None])
