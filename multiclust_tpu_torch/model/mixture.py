"""Mixture model, chain-batched (multiclust_tpu/model/mixture.py): each
individual is drawn wholly from one cluster.

Likelihood (logL_mixture, log_likelihood.c:157-232):
    L_i = sum_k eta_k prod_{l,m} p_klm^{x_ilm}

The per-(i, k) log score  s_ik = log eta_k + sum_{l,m} x_ilm log p_klm  is
one [I, L*M] x [L*M, K] product; the E-step posterior v is its row softmax
and the logsumexp gives the per-individual logL terms.  M-step
(m_step_mixture, em_alg.c:907-1011): eta_k = sum_i v_ik / I, p_klm from
``p_lower_bound`` plus the expected counts v^T x, normalized per (k, l),
then the optional projections.

Every function takes a chain batch: eta [B, K], p [B, K, L, M] in the
full, unpadded layout.  Float32 biallelic fits with the kernels on run
``_em_step_bi_kernel`` (ops/mixture_bi.py), which K-pads lp and the bias
per call; every other fit runs the plain products here, with the eta and
p finish on the card when the kernels are on (no host read per step).
The kernels take K padded to at most KP_MAX = 1024 lanes; above that
every mixture step is the plain one, with no notice, as the JAX package
falls through to XLA (``_em_step_bi_kernel`` returning None,
multiclust_tpu/model/mixture.py:328-331).  A
jagged panel's bucketed layout (model/bucketed.py) sums the scores over
its buckets and updates each bucket's p at its own M_b.

The chains of a mixed-K lattice (runtime/ksweep.py) carry their true
lanes as ``params.kmask`` ([B, K], a row a chain): the scores of the other
lanes are -inf, so they take no posterior mass and stay out of the
logsumexp (``_mask_scores``, multiclust_tpu/model/mixture.py:33-38), eta
is normalized and projected over the chain's lanes (``_finish_eta``), and
p there becomes the lb-smoothed row of zero counts, as in the JAX step.
The kernel route gives its kernels the mask.

Under a mesh (cfg.mesh, runtime/mesh.py) the same plain products run on
this rank's block of rows and loci, as the JAX package keeps meshed
mixture fits off its kernels (``_kernel_ok``, multiclust_tpu/model/
mixture.py:176-178): the allele scores of this rank's loci are summed over
the model group before log eta and the softmax, the expected counts and
the responsibility sums over the data group before the finish (each sum
the identity without a mesh).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from multiclust_tpu_torch.model.admixture import _ll_terms, _no_ll
from multiclust_tpu_torch.model.bucketed import BucketedData, \
    split_params_like
from multiclust_tpu_torch.model.common import EMConfig, ModelData, Params, \
    k_padded_size, safe_log
from multiclust_tpu_torch.ops.fullstep import fullstep_p
from multiclust_tpu_torch.ops.fullstep_bi import KP_MAX
from multiclust_tpu_torch.ops.mixture_bi import mixture_eta, \
    mixture_finish, mixture_partials, mixture_rows
from multiclust_tpu_torch.ops.simplex import kmask_lanes, project_rows
from multiclust_tpu_torch.runtime.mesh import DATA_AXIS, MODEL_AXIS, \
    sum_over

Tensor = torch.Tensor

# K-pad lanes of the kernel route's bias: their posterior mass is exactly
# 0 in the plain versions (the kernels stop at k_true)
PAD_BIAS = -1e30


# The scores are summed in float64 whatever the params dtype: at L in the
# thousands |s| ~ 10^3-10^4, and float32 rounding of the per-individual
# terms would exceed the float32 noise floor of the convergence and
# monotonicity tests (opt/em.py).  The kernel route does the same
# (csrc/mixture_bi.cu); the posterior returns to the params dtype.
F64 = torch.float64


def _x0(md: ModelData, dtype: torch.dtype) -> Tensor:
    """[I, L] allele-0 counts in ``dtype``."""
    x0 = md.x0 if md.x0 is not None else md.x[..., 0]
    return x0.to(dtype)


def _allele_scores(p: Tensor, md: ModelData) -> Tensor:
    """[B, I, K] sum_lm x_ilm log p_klm over md's loci, float64."""
    logp = safe_log(p, md.mask).to(F64)              # [B, K, L, M]
    nb, K = logp.shape[:2]
    return (md.x.reshape(md.I, -1).to(F64)
            @ logp.reshape(nb, K, -1).transpose(-1, -2))


def _mask_scores(s: Tensor, params: Params) -> Tensor:
    """Scores [B, I, K] with the lanes outside each chain's kmask at
    -inf: their eta is 0, which safe_log maps to 0, not -inf."""
    if params.kmask is None:
        return s
    return torch.where(kmask_lanes(params.kmask, 3), s,
                       torch.full((), -torch.inf, dtype=s.dtype,
                                  device=s.device))


def scores(params: Params, md: ModelData, mesh=None) -> Tensor:
    """[B, I, K] per-individual per-cluster log scores, float64; on a
    bucketed panel summed over the buckets, each cast to float64 at its
    own M_b.  Under a ``mesh`` the allele sums of this rank's loci are
    summed over the model group before log eta is added."""
    if isinstance(md, BucketedData):
        s = sum(_allele_scores(p_b, md_b)
                for md_b, p_b in zip(md.buckets, params.p))
    else:
        s = _allele_scores(params.p, md)
    s = sum_over(mesh, s, MODEL_AXIS)
    return _mask_scores(s + safe_log(params.eta).to(F64)[:, None, :],
                        params)


def _scores_bi(params: Params, md: ModelData, ploidy: int,
               mesh=None) -> Tensor:
    """Biallelic missing-free scores in ONE [I, L] x [L, K] product: with
    x1 = ploidy - x0,
        sum_lm x_ilm log p_klm = x0 @ (log p0 - log p1)^T
                                 + ploidy * sum_l log p1_kl,
    summed over the model group under a ``mesh``; then log eta."""
    logp = safe_log(params.p, md.mask).to(F64)       # [B, K, L, 2]
    d = (logp[..., 0] - logp[..., 1]).transpose(-1, -2)   # [B, L, K]
    base = ploidy * logp[..., 1].sum(dim=-1)          # [B, K]
    s = sum_over(mesh, _x0(md, F64) @ d + base[:, None, :], MODEL_AXIS)
    return _mask_scores(s + safe_log(params.eta).to(F64)[:, None, :],
                        params)


def _posterior_and_ll(s: Tensor, dtype: torch.dtype, mesh=None):
    """(v [B, I, K] in ``dtype``, logL [B], scale [B]): the row softmax
    and the float64 sums of the per-individual logsumexp terms (summed
    over the data group under a ``mesh``)."""
    m = s.max(dim=-1, keepdim=True).values
    e = torch.exp(s - m)
    tot = e.sum(dim=-1, keepdim=True)
    ll, scale = _ll_terms(torch.log(tot[..., 0]) + m[..., 0], mesh)
    return (e / tot).to(dtype), ll, scale


def e_step(params: Params, md: ModelData, mesh=None):
    """Posterior v [B, I, K] plus the logL of the input params."""
    return _posterior_and_ll(scores(params, md, mesh), params.eta.dtype,
                             mesh)


def _bi_fast(md: ModelData, cfg: EMConfig) -> bool:
    """Single-product biallelic path: every locus has exactly 2 valid
    alleles and every copy is observed, so x1 = ploidy - x0."""
    return cfg.biallelic and not cfg.has_missing and md.M == 2


def _in_range(K: int) -> bool:
    """K clusters pad to a Kp the mixture kernels take (at most KP_MAX
    lanes)."""
    return k_padded_size(K, 32) <= KP_MAX


def _kernel_ok(md: ModelData, cfg: EMConfig, params: Params) -> bool:
    """The kernel route (ops/mixture_bi.py): kernels on (every float32 fit
    on CUDA, ``runtime/multistart.device_policy``), a biallelic panel with
    its x0/x1 planes, float32 parameters, K padded to at most KP_MAX
    lanes (narrow kernels up to 128, the wide ones above).  Never under a
    mesh, as in the JAX package."""
    return (cfg.use_pallas != "off" and cfg.mesh is None and cfg.biallelic
            and md.x0 is not None and params.p.dtype == torch.float32
            and _in_range(params.K))


def _on_card(cfg: EMConfig, t: Tensor, K: int) -> bool:
    """The eta and p finish of K clusters go through the kernels (their
    plain versions on CPU tensors) when the kernels are on for a float32
    fit and K pads to at most KP_MAX lanes."""
    return (cfg.use_pallas != "off" and t.dtype == torch.float32
            and _in_range(K))


def log_likelihood(params: Params, md: ModelData, cfg: EMConfig):
    """logL (logL_mixture) without the M-step; the kernel route reads it
    from the rows pass, which never casts the counts to float."""
    if isinstance(md, BucketedData):
        params = split_params_like(params, md)
    elif _kernel_ok(md, cfg, params):
        lp0, x0, bias, lp1, x1, kmask = _kernel_inputs(params, md, cfg)
        return _ll_terms(mixture_rows(lp0, x0, bias, lp1, x1, kmask,
                                      k_true=params.K)[1])
    s = (_scores_bi(params, md, cfg.ploidy, cfg.mesh) if _bi_fast(md, cfg)
         else scores(params, md, cfg.mesh))
    _, ll, scale = _posterior_and_ll(s, params.eta.dtype, cfg.mesh)
    return ll, scale


def _finish_p(pc: Tensor, md: ModelData, cfg: EMConfig) -> Tensor:
    """p from the expected counts pc [B, K, L, M]: ``p_lower_bound`` on
    the valid lanes, per-locus normalization, optional projection.  With
    the kernels on, the generic p epilogue computes exactly this from
    p2 = 1 on the valid lanes and the partial pc + plb."""
    plb = cfg.p_lower_bound
    maskf = md.mask.to(pc.dtype)
    pc = pc + plb * maskf
    if _on_card(cfg, pc, pc.shape[1]):
        nb, K, L, M = pc.shape
        p2 = maskf.reshape(1, 1, -1).expand(nb, K, -1).contiguous()
        return fullstep_p(p2, pc.reshape(nb, 1, K, L * M), md.mask, M=M,
                          k_true=K, plb=plb, project=cfg.do_projection)
    tot = pc.sum(dim=-1, keepdim=True)
    p = torch.where(md.mask, pc / tot, torch.zeros_like(pc))
    if cfg.do_projection:
        p = project_rows(p, md.mask, plb)
    return p


def _finish_eta(v: Tensor, cfg: EMConfig, kmask=None) -> Tensor:
    """eta [B, K] = sum_i v / total, then the optional projection, over
    each chain's ``kmask`` lanes where one is given; with the kernels on,
    the kernel route's eta finish on the K-padded sums.  Under a mesh the
    sums are summed over the data group first."""
    vsum = sum_over(cfg.mesh, v.sum(dim=1), DATA_AXIS)    # [B, K]
    K = vsum.shape[-1]
    if _on_card(cfg, vsum, K):
        dK = k_padded_size(K, 32) - K
        vpart = F.pad(vsum, (0, dK))[:, None]
        eta = mixture_eta(vpart.contiguous(), _pad_kmask(kmask, dK),
                          k_true=K, lb=cfg.eta_lower_bound,
                          project=cfg.do_projection)
        return eta[:, :K].contiguous()
    lanes = (torch.ones(K, dtype=torch.bool, device=vsum.device)
             if kmask is None else kmask_lanes(kmask, 2))
    vsum = torch.where(lanes, vsum, torch.zeros_like(vsum))
    eta = vsum / vsum.sum(dim=-1, keepdim=True)
    if cfg.do_projection:
        eta = project_rows(eta, lanes, cfg.eta_lower_bound)
    return eta


def _pad_kmask(kmask, dK: int):
    """A kmask [B, K] padded with dK false lanes (the kernels' Kp), as a
    contiguous float32 tensor; None stays None."""
    if kmask is None:
        return None
    return F.pad(kmask, (0, dK)).to(torch.float32).contiguous()


def _counts_p(v: Tensor, md: ModelData, cfg: EMConfig) -> Tensor:
    """p' from the expected counts v^T x over md's loci (summed over the
    data group under a mesh)."""
    nb, _, K = v.shape
    pc = sum_over(cfg.mesh, (v.transpose(-1, -2) @ md.x2d).reshape(
        nb, K, md.L, md.M), DATA_AXIS)
    return _finish_p(pc, md, cfg)


def m_step(v: Tensor, md: ModelData, cfg: EMConfig, kmask=None) -> Params:
    """Parameter update given the posteriors (m_step_mixture); on a
    bucketed panel eta is finished once and p bucket by bucket.  The
    kmask (v is 0 outside it) sets eta's lanes and rides along."""
    if isinstance(md, BucketedData):
        p = tuple(_counts_p(v, md_b, cfg) for md_b in md.buckets)
    else:
        p = _counts_p(v, md, cfg)
    return Params(eta=_finish_eta(v, cfg, kmask), p=p, kmask=kmask)


def _m_step_bi(v: Tensor, md: ModelData, cfg: EMConfig,
               kmask=None) -> Params:
    """Biallelic missing-free M-step in ONE product: with x1 = ploidy - x0,
    pc1_kl = ploidy * sum_i v_ik - pc0_kl (both summed over the data
    group under a mesh)."""
    pc0 = v.transpose(-1, -2) @ _x0(md, v.dtype)      # [B, K, L]
    pc1 = cfg.ploidy * v.sum(dim=1)[..., None] - pc0
    pc = sum_over(cfg.mesh, torch.stack([pc0, pc1], dim=-1), DATA_AXIS)
    return Params(eta=_finish_eta(v, cfg, kmask), p=_finish_p(pc, md, cfg),
                  kmask=kmask)


def _kernel_inputs(params: Params, md: ModelData, cfg: EMConfig):
    """(lp0, x0, bias, lp1, x1, kmask) of the kernel route, K-padded to
    Kp = 32 lanes per call (mixture.py:218-230): missing-free panels
    stream x0 alone with lp0 = log p0 - log p1 and the ploidy fold in the
    bias; panels with missing data stream both planes.  The kmask (None
    without one) is padded with false lanes."""
    K = params.K
    dK = k_padded_size(K, 32) - K
    lp0 = safe_log(params.p[..., 0])                  # [B, K, L]
    lp1 = safe_log(params.p[..., 1])
    log_eta = safe_log(params.eta)                    # [B, K]
    if cfg.has_missing:
        blk0, blk1, bias_k = lp0, F.pad(lp1, (0, 0, 0, dK)), log_eta
        x1 = md.x1
    else:
        blk0, blk1, x1 = lp0 - lp1, None, None
        bias_k = cfg.ploidy * lp1.sum(dim=-1) + log_eta
    bias = F.pad(bias_k, (0, dK), value=PAD_BIAS)
    return (F.pad(blk0, (0, 0, 0, dK)), md.x0, bias, blk1, x1,
            _pad_kmask(params.kmask, dK))


def _em_step_bi_kernel(params: Params, md: ModelData, cfg: EMConfig,
                       want_ll: bool = True):
    """Biallelic mixture step through the kernels (the port of
    ``_em_step_bi_kernel``, mixture.py:180-273): rows pass, the logL terms
    of its t, columns pass, then the finish, which writes the new
    parameters in the full [B, K, L, 2] layout (``mixture_finish(...,
    params=True)``), for the whole chain batch, with no host read and no
    launch after the finish."""
    K = params.K
    lp0, x0, bias, lp1, x1, kmask = _kernel_inputs(params, md, cfg)
    v, t = mixture_rows(lp0, x0, bias, lp1, x1, kmask, k_true=K)
    ll, scale = _ll_terms(t) if want_ll else _no_ll(params.eta)
    part, vpart = mixture_partials(v, x0, x1, k_true=K)
    eta, p = mixture_finish(part, vpart, kmask, k_true=K,
                            lb=float(cfg.eta_lower_bound),
                            plb=float(cfg.p_lower_bound), ploidy=cfg.ploidy,
                            project=cfg.do_projection, params=True)
    return Params(eta=eta, p=p, kmask=params.kmask), ll, scale


def em_step(params: Params, md: ModelData, cfg: EMConfig,
            want_ll: bool = True) -> Tuple[Params, Tensor, Tensor]:
    """One EM iteration; the logL is that of the INPUT params (em_step,
    em_alg.c:195-207).  ``want_ll=False`` lets the kernel route skip the
    float64 logL sums (the plain route gets the logL with the posterior).
    A bucketed panel takes the plain products bucket by bucket
    (``_em_step_bucketed``, multiclust_tpu/model/mixture.py:276-301)."""
    if isinstance(md, BucketedData):
        params = split_params_like(params, md)
    elif _kernel_ok(md, cfg, params):
        return _em_step_bi_kernel(params, md, cfg, want_ll)
    if _bi_fast(md, cfg):
        v, ll, scale = _posterior_and_ll(
            _scores_bi(params, md, cfg.ploidy, cfg.mesh), params.p.dtype,
            cfg.mesh)
        return _m_step_bi(v, md, cfg, params.kmask), ll, scale
    v, ll, scale = e_step(params, md, cfg.mesh)
    return m_step(v, md, cfg, params.kmask), ll, scale

