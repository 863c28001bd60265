"""The two models of a diploid biallelic panel, written from their
equations (the reference C program's log_likelihood.c and em_alg.c).

The panel is its three planes: x0 and x1, the copies of allele 0 and 1,
and miss, the missing copies, each [I, L] int8.  Parameters are eta
([I, K] admixture proportions, or the mixture's [K] weights) and p
[K, L, 2], the allele frequencies of each cluster; every step here takes
them as the program returned them, so a p whose two alleles do not add to
1 is used as it stands.

Admixture:  logL = sum_il x0 log(eta_i . p0_l) + x1 log(eta_i . p1_l).
  E and M step: with w_a = x_a / (eta_i . p_a_l),
  eta'_ik ~ eta_ik (sum_l w0 p0_kl + w1 p1_kl + c_i),  c_i = sum_l miss_il,
  p'_kla ~ p_kla (sum_i eta_ik w_a_il + sum_i eta_ik miss_il),
  each row normalized, then projected onto the simplex bounded below by
  lb (eta) and plb (p): a missing copy is credited to the clusters in
  proportion to eta.
Mixture:    logL = sum_i log sum_k eta_k exp(sum_l x0 log p0_kl + x1 log p1_kl).
  With v the posterior of the cluster of each individual,
  eta' = sum_i v_i / I (projected), p'_kla ~ sum_i v_ik x_a_il + plb.

Every function works in blocks of rows of ``block_cells`` cells, in the
precision ``prec`` (reference/precision.py); sums of log terms are always
taken in float64.
"""

from __future__ import annotations

import torch

from benchmark.reference.precision import F64, dtype_of, mm

BLOCK_CELLS = 1 << 26


def project(v: torch.Tensor, lb: float) -> torch.Tensor:
    """Rows of ``v`` (last axis) projected onto {x >= lb, sum x = 1}:
    Michelot's algorithm, every row at once; a pass subtracts the surplus
    from the free lanes and pins the lanes that fall below lb, and a row
    is done after a pass that pins none."""
    w = v.clone()
    free = torch.ones_like(w, dtype=torch.bool)
    done = torch.zeros(w.shape[:-1], dtype=torch.bool, device=w.device)
    while not bool(done.all()):
        n = free.sum(dim=-1).clamp(min=1).to(w.dtype)
        off = (w.sum(dim=-1) - 1.0) / n
        upd = free & ~done[..., None]
        w = torch.where(upd, w - off[..., None], w)
        pin = upd & (w < lb)
        w = torch.where(pin, torch.full_like(w, lb), w)
        free = free & ~pin
        done = done | ~pin.any(dim=-1) | (free.sum(dim=-1) == 0)
    return w


def _rows(I: int, L: int, block_cells: int):
    step = max(1, block_cells // max(L, 1))
    for lo in range(0, I, step):
        yield slice(lo, min(I, lo + step))


def _xlogd(x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """sum over loci of x log d where x > 0, per row, float64."""
    return torch.where(x > 0, x * torch.log(d), torch.zeros_like(d)).sum(
        dim=-1, dtype=torch.float64)


def _wdiv(x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, x / d, torch.zeros_like(d))


def admixture_terms(eta, p, planes, miss, prec: str = F64,
                    block_cells: int = BLOCK_CELLS) -> torch.Tensor:
    """Per-individual logL terms [I] (float64) of the admixture model."""
    dt = dtype_of(prec)
    I, L = miss.shape
    p0, p1 = p[..., 0].to(dt), p[..., 1].to(dt)
    out = torch.empty(I, dtype=torch.float64, device=miss.device)
    for r in _rows(I, L, block_cells):
        e = eta[r].to(dt)
        out[r] = (_xlogd(planes[0, r].to(dt), mm(e, p0, prec))
                  + _xlogd(planes[1, r].to(dt), mm(e, p1, prec)))
    return out


def admixture_step(eta, p, planes, miss, lb: float, plb: float,
                   prec: str = F64, block_cells: int = BLOCK_CELLS):
    """One EM step of the admixture model: (eta' [I, K], p' [K, L, 2], the
    input's per-individual logL terms [I] float64)."""
    dt = dtype_of(prec)
    I, L = miss.shape
    K = eta.shape[-1]
    dev = miss.device
    p0, p1 = p[..., 0].to(dt), p[..., 1].to(dt)
    t = torch.empty(I, dtype=torch.float64, device=dev)
    A = torch.empty((I, K), dtype=dt, device=dev)
    c = torch.empty(I, dtype=dt, device=dev)
    B0 = torch.zeros((K, L), dtype=dt, device=dev)
    B1 = torch.zeros_like(B0)
    C = torch.zeros_like(B0)
    for r in _rows(I, L, block_cells):
        e = eta[r].to(dt)
        x0, x1 = planes[0, r].to(dt), planes[1, r].to(dt)
        m = miss[r].to(dt)
        d0, d1 = mm(e, p0, prec), mm(e, p1, prec)
        t[r] = _xlogd(x0, d0) + _xlogd(x1, d1)
        w0, w1 = _wdiv(x0, d0), _wdiv(x1, d1)
        del d0, d1, x0, x1
        A[r] = mm(w0, p0.T, prec) + mm(w1, p1.T, prec)
        et = e.T.contiguous()
        B0 += mm(et, w0, prec)
        B1 += mm(et, w1, prec)
        C += mm(et, m, prec)
        c[r] = m.sum(dim=1)
    num = eta.to(dt) * (A + c[:, None])
    eta_new = project(num / num.sum(dim=-1, keepdim=True), lb)
    pn = torch.stack([p0 * (B0 + C), p1 * (B1 + C)], dim=-1)
    p_new = project(pn / pn.sum(dim=-1, keepdim=True), plb)
    return eta_new, p_new, t


def mixture_scores(eta, p, planes, prec: str = F64,
                   block_cells: int = BLOCK_CELLS) -> torch.Tensor:
    """[I, K] log eta_k + sum_l x0 log p0_kl + x1 log p1_kl, float64 (the
    products themselves in ``prec``)."""
    dt = dtype_of(prec)
    _, I, L = planes.shape
    lp0, lp1 = torch.log(p[..., 0].to(dt)).T, torch.log(p[..., 1].to(dt)).T
    s = torch.empty((I, eta.shape[-1]), dtype=torch.float64,
                    device=planes.device)
    for r in _rows(I, L, block_cells):
        s[r] = (mm(planes[0, r], lp0, prec)
                + mm(planes[1, r], lp1, prec)).to(torch.float64)
    return s + torch.log(eta.to(torch.float64))[None, :]


def mixture_terms(eta, p, planes, prec: str = F64,
                  block_cells: int = BLOCK_CELLS) -> torch.Tensor:
    """Per-individual logL terms [I] (float64) of the mixture model."""
    return torch.logsumexp(mixture_scores(eta, p, planes, prec, block_cells),
                           dim=-1)


def mixture_step(eta, p, planes, lb: float, plb: float, prec: str = F64,
                 block_cells: int = BLOCK_CELLS):
    """One EM step of the mixture model: (eta' [K], p' [K, L, 2], the
    input's per-individual logL terms [I] float64)."""
    dt = dtype_of(prec)
    _, I, L = planes.shape
    s = mixture_scores(eta, p, planes, prec, block_cells)
    t = torch.logsumexp(s, dim=-1)
    v = torch.exp(s - t[:, None]).to(dt)
    K = v.shape[1]
    n = torch.zeros((2, K, L), dtype=dt, device=planes.device)
    for r in _rows(I, L, block_cells):
        vt = v[r].T.contiguous()
        n[0] += mm(vt, planes[0, r], prec)
        n[1] += mm(vt, planes[1, r], prec)
    eta_new = project(v.sum(dim=0) / I, lb)
    pn = n.permute(1, 2, 0) + plb
    p_new = project(pn / pn.sum(dim=-1, keepdim=True), plb)
    return eta_new, p_new, t


def terms(model: str, eta, p, planes, miss, prec: str = F64,
          block_cells: int = BLOCK_CELLS) -> torch.Tensor:
    if model == "admixture":
        return admixture_terms(eta, p, planes, miss, prec, block_cells)
    return mixture_terms(eta, p, planes, prec, block_cells)


def step(model: str, eta, p, planes, miss, lb: float, plb: float,
         prec: str = F64, block_cells: int = BLOCK_CELLS):
    if model == "admixture":
        return admixture_step(eta, p, planes, miss, lb, plb, prec,
                              block_cells)
    return mixture_step(eta, p, planes, lb, plb, prec, block_cells)


def lower_bound(I: int, ploidy: int, bound: float = 1e-8) -> float:
    """The parameters' lower bound: the stated bound, or half of one copy's
    share of the panel when that is smaller (multiclust.c synchronize)."""
    return min(bound, 0.5 / (I * ploidy))
