"""Generic (multi-allelic) admixture full EM step: the CUDA kernels and
their plain PyTorch versions.

Replaces the Pallas TPU kernels ``admixture_fullstep`` /
``_fullstep_kernel`` (multiclust_tpu/ops/kernels.py:200-341) and the sweep
statistics ``admixture_sweep_fused`` (:1479-1552) and
``admixture_sweep_stats`` (:1555-1651).  The kernel source,
``csrc/fullstep.cu``, splits the step into a rows pass (denom, w, t, A and
the eta finish with its Michelot projection), a columns pass (denom, w
again, per-segment partials of B = eta^T (w + miss)) and a p epilogue (the
partials' fixed-order sum, p B normalized per locus and the masked
Michelot: ``_normalize_p``, which JAX runs in XLA).  ``finish=False``
returns the raw statistics instead: A from the rows pass (the ``a0`` /
``emit_a`` chaining of jagged buckets), B from the columns pass; the two
together are the sweep statistics.

The CUDA passes are built from the biallelic step's register tiles (see
``csrc/fullstep.cu``): the rows pass splits L*M into column segments and
finishes eta in a second kernel, as the biallelic streamed step does, and
the columns pass splits I into row segments; both stop their cluster
loops at the lane tile of ``k_true`` (``fullstep_bi.lane_tile``), so the
segment arithmetic takes it (``fullstep_bi.row_segments``,
``cols_segments``).

For 128 < Kp <= 1024 the rows pass, its finish and the columns pass are
the wide kernels of ``csrc/wide.cuh`` (the generic cells at every M; the
columns pass a d launch and a B launch on the float64 tensor cores for
each lane sub-window, ``fullstep_bi.cols_sub_cols``); the p epilogue
takes any Kp.

The wrappers launch the kernels for CUDA tensors and run the plain version
only for CPU tensors; there is no fallback for CUDA tensors.  Shapes: a
chain batch B leads.  eta [B, I, Kp] f32 with Kp a multiple of 32 up to
1024, p2
[B, Kp, L*M] f32 (the [B, Kp, L, M] parameters flattened), x2 [I, L*M]
int8, miss [I, L] int8 or None, c [I] f32 missing totals, mask [L, M] bool
valid allele lanes.  Pad lanes (k >= k_true) of eta and p2 must be zero;
the full step keeps them zero.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from multiclust_tpu_torch.ops import build
from multiclust_tpu_torch.ops.build import ptr as _ptr
from multiclust_tpu_torch.ops.fullstep_bi import COLS_BLOCKS_PER_SM, \
    COLS_MAX_RSEG, SCRATCH_CAP, check_kp, col_segments, cols_sub_cols, \
    cols_tile, device_sm_count, is_wide, kc_of, row_segments, wide_chunks
from multiclust_tpu_torch.ops.simplex import project_rows

Tensor = torch.Tensor

# allele slots per locus the p epilogue takes (csrc/fullstep.cu)
M_MAX = 1024


def _weights(eta: Tensor, p2: Tensor, x2: Tensor):
    """(x, x > 0, safe denominator, w) over [B, I, L*M]: the generic path
    masks x > 0, and a zero denominator under x > 0 counts as 1
    (kernels.py:226-229)."""
    x = x2.to(eta.dtype)
    d = eta @ p2
    pos = x > 0
    sd = torch.where(d > 0, d, torch.ones_like(d))
    w = torch.where(pos, x / sd, torch.zeros_like(d))
    return x, pos, sd, w


def normalize_p(pc: Tensor, mask: Tensor, *, k_true: int, plb: float,
                project: bool) -> Tensor:
    """p from its unnormalized update pc [B, Kp, L, M] (``_normalize_p``,
    multiclust_tpu/model/admixture.py:72-88): each locus normalized over
    its M lanes, 0 where the mask is off or the total is 0; with
    ``project`` the masked Michelot with ``plb`` (a zero-mass cluster
    becomes 1/n_alleles), and the K-pad rows k >= k_true kept 0."""
    tot = pc.sum(dim=-1, keepdim=True)
    ok = tot > 0
    p = torch.where(mask & ok, pc / torch.where(ok, tot, torch.ones_like(tot)),
                    torch.zeros_like(pc))
    if project:
        p = project_rows(p, mask, plb)
        Kp = p.shape[-3]
        if k_true < Kp:
            kv = torch.arange(Kp, device=p.device) < k_true
            p = torch.where(kv[:, None, None], p, torch.zeros_like(p))
    return p


def fullstep_rows_reference(eta: Tensor, p2: Tensor, x2: Tensor,
                            c: Optional[Tensor] = None,
                            a0: Optional[Tensor] = None, *, k_true: int,
                            lb: float, project: bool,
                            compute_t: bool = True, finish: bool = True
                            ) -> Tuple[Tensor, Tensor]:
    """Plain version of the rows pass: (eta' [B, I, Kp], t [B, I]), or
    (raw A [B, I, Kp], t) under ``finish=False`` (c not added)."""
    x, pos, sd, w = _weights(eta, p2, x2)
    if compute_t:
        t = torch.where(pos, x * torch.log(sd), torch.zeros_like(sd)).sum(-1)
    else:
        t = eta.new_zeros(eta.shape[:-1])
    A = w @ p2.transpose(-1, -2)
    if a0 is not None:
        A = A + a0
    if not finish:
        return A, t
    if c is not None:
        A = A + c.to(eta.dtype)[:, None]
    num = eta * A
    tot = num.sum(dim=-1, keepdim=True)
    ok = tot > 0
    eta_new = torch.where(ok, num / torch.where(ok, tot, torch.ones_like(tot)),
                          eta)
    if project:
        lanes = torch.arange(eta.shape[-1], device=eta.device) < k_true
        eta_new = project_rows(eta_new, lanes, lb)
    return eta_new, t


def fullstep_partials_reference(eta: Tensor, p2: Tensor, x2: Tensor,
                                miss: Optional[Tensor] = None) -> Tensor:
    """Plain version of the columns pass: B = eta^T (w + miss) as a single
    row segment, [B, 1, Kp, L*M]."""
    nb, Kp, LM = p2.shape
    _, _, _, w = _weights(eta, p2, x2)
    et = eta.transpose(-1, -2)
    Bm = et @ w
    if miss is not None:
        # missing-mass p-update term: B_klm += (eta^T miss)_kl
        L = miss.shape[-1]
        C = et @ miss.to(eta.dtype)
        Bm = (Bm.reshape(nb, Kp, L, -1) + C[..., None]).reshape(nb, Kp, LM)
    return Bm[:, None]


def fullstep_p_reference(p2: Tensor, part: Tensor,
                         mask: Optional[Tensor] = None, *, k_true: int = 0,
                         plb: float = 0.0, project: bool = False,
                         finish: bool = True) -> Tensor:
    """Plain version of the p epilogue: the partials [B, S, Kp, L*M]
    summed over segments, then p' [B, Kp, L, M], or raw B [B, Kp, L*M]
    under ``finish=False``."""
    Bm = part.sum(dim=1)
    if not finish:
        return Bm
    shape = Bm.shape[:2] + tuple(mask.shape)
    return normalize_p(p2.reshape(shape) * Bm.reshape(shape), mask,
                       k_true=k_true, plb=plb, project=project)


def fullstep_cols_reference(eta: Tensor, p2: Tensor, x2: Tensor,
                            miss: Optional[Tensor] = None,
                            mask: Optional[Tensor] = None, *,
                            k_true: int = 0, plb: float = 0.0,
                            project: bool = False, finish: bool = True
                            ) -> Tensor:
    """Plain version of the columns pass and the p epilogue: p' [B, Kp, L,
    M], or raw B [B, Kp, L*M] under ``finish=False`` (with eta^T miss
    folded in when miss is given)."""
    return fullstep_p_reference(
        p2, fullstep_partials_reference(eta, p2, x2, miss), mask,
        k_true=k_true, plb=plb, project=project, finish=finish)


def admixture_fullstep_reference(eta, p2, x2, c, miss, mask, *, k_true: int,
                                 lb: float, plb: float, project: bool,
                                 compute_t: bool = True):
    """Plain PyTorch version of the whole step: (eta', t, p')."""
    eta_new, t = fullstep_rows_reference(
        eta, p2, x2, c, k_true=k_true, lb=lb, project=project,
        compute_t=compute_t)
    p_new = fullstep_cols_reference(eta, p2, x2, miss, mask, k_true=k_true,
                                    plb=plb, project=project)
    return eta_new, t, p_new


def admixture_sweep_stats_reference(eta, p2, x2, *, compute_t: bool = True):
    """Plain version of the sweep statistics: (A, t, B)."""
    A, t = fullstep_rows_reference(eta, p2, x2, k_true=eta.shape[-1],
                                   lb=0.0, project=False,
                                   compute_t=compute_t, finish=False)
    return A, t, fullstep_cols_reference(eta, p2, x2, finish=False)


def _check_cuda_inputs(eta, p2, x2, *extra):
    if eta.dim() != 3 or p2.dim() != 3:
        raise ValueError(f"eta [B, I, Kp] and p2 [B, Kp, L*M] expected, got "
                         f"{tuple(eta.shape)} and {tuple(p2.shape)}")
    B, I, Kp = eta.shape
    LM = p2.shape[-1]
    check_kp(Kp)
    if p2.shape != (B, Kp, LM):
        raise ValueError(f"p2 shape {tuple(p2.shape)} != {(B, Kp, LM)}")
    for name, t, dt, shape in (("eta", eta, torch.float32, None),
                               ("p2", p2, torch.float32, None),
                               ("x2", x2, torch.int8, (I, LM))) + extra:
        if t.device != eta.device:
            raise ValueError(f"{name} on {t.device}, eta on {eta.device}")
        if t.dtype != dt:
            raise ValueError(f"{name} dtype {t.dtype}, kernel takes {dt}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return B, I, LM, Kp


def cols_segments(B: int, I: int, LM: int, Kp: int, n_sm: int,
                  k_true: int = 0) -> Tuple[int, int]:
    """(row segments, rows per segment) of the columns pass: enough for
    COLS_BLOCKS_PER_SM blocks an SM at the tile of ``k_true`` (at a wide
    Kp, as many as fill the card in one wave over a lane sub-window's B
    blocks, as ``fullstep_bi.cols_row_segments``), at most COLS_MAX_RSEG,
    with the partials [B, n, Kp, L*M] no larger than SCRATCH_CAP or than
    the int8 x the pass reads, and at least one."""
    tc, ri = cols_tile(k_true, Kp, generic=True)
    if is_wide(Kp):
        n_ch = wide_chunks(kc_of(k_true, Kp))
        sub = cols_sub_cols(B, I, LM, n_ch, n_sm, bi=False)
        n_want = min(n_sm // (-(-sub // tc) * B * n_ch), -(-I // (4 * ri)))
    else:
        n_want, _ = col_segments(I, LM, B, n_sm, tc=tc, ri=ri,
                                 per_sm=COLS_BLOCKS_PER_SM)
    n = max(1, min(n_want, COLS_MAX_RSEG, SCRATCH_CAP // (4 * B * Kp * LM),
                   I // (4 * B * Kp)))
    seg_rows = -(-I // n)
    seg_rows = -(-seg_rows // ri) * ri
    return -(-I // seg_rows), seg_rows


def _check_k_true(k_true: int, Kp: int) -> None:
    if not 0 <= k_true <= Kp:
        raise ValueError(f"k_true={k_true} outside [0, Kp={Kp}]: the "
                         f"kernels' cluster loops stop at k_true (0: Kp)")


def fullstep_rows(eta, p2, x2, c=None, a0=None, *, k_true: int, lb: float,
                  project: bool, compute_t: bool = True,
                  finish: bool = True, M: int = 0):
    """Rows pass: (eta' [B, I, Kp] in a new buffer, t [B, I]), or (raw A,
    t) under ``finish=False``; ``a0`` [B, I, Kp] seeds A.  ``k_true`` is
    where the kernels' cluster loops stop; the L*M lanes are split into
    segments as the biallelic streamed step splits its columns
    (``fullstep_bi.row_segments``).  ``M`` the allele slots a locus where
    the caller knows them (0: not said): at M a multiple of 4 the kernel
    computes the reciprocals and logs of the set lanes only, with the same
    result."""
    _check_k_true(k_true, eta.shape[-1])
    if not eta.is_cuda:
        return fullstep_rows_reference(
            eta, p2, x2, c, a0, k_true=k_true, lb=lb, project=project,
            compute_t=compute_t, finish=finish)
    extra = ()
    if c is not None:
        extra += (("c", c, torch.float32, (eta.shape[1],)),)
    if a0 is not None:
        extra += (("a0", a0, torch.float32, tuple(eta.shape)),)
    B, I, LM, Kp = _check_cuda_inputs(eta, p2, x2, *extra)
    n_seg, seg_cols = row_segments(B, I, LM, device_sm_count(eta.device),
                                   k_true=k_true, Kp=Kp)
    dev = eta.device
    apart = torch.empty((B, n_seg, I, Kp), dtype=torch.float32, device=dev)
    tpart = torch.empty((B, n_seg, I), dtype=torch.float32, device=dev)
    out = torch.empty_like(eta)
    t = torch.empty((B, I), dtype=torch.float64, device=dev)
    build.launch("mc_fullstep_rows", dev,
                 eta.data_ptr(), p2.data_ptr(), x2.data_ptr(), _ptr(c),
                 _ptr(a0), apart.data_ptr(), tpart.data_ptr(),
                 out.data_ptr(), t.data_ptr(), B, I, LM, int(M), Kp,
                 int(k_true), float(lb), int(project), int(compute_t),
                 int(finish), seg_cols, n_seg,
                 also=("wide_rows", "wide_finish") if is_wide(Kp)
                 else ())
    # summed over the segments in float64, returned as the plain version's
    return out, t.to(torch.float32)


def _loci(LM: int, M: int) -> int:
    """Loci L of L*M lanes at M allele slots each."""
    if M < 1 or M > M_MAX or LM % M:
        raise ValueError(f"{LM} lanes at M = {M} slots per locus: the "
                         f"kernels take M <= {M_MAX} dividing the lanes")
    return LM // M


def fullstep_partials(eta, p2, x2, miss=None, *, M: int, k_true: int = 0):
    """Columns pass: per-row-segment partials of B = eta^T (w + miss),
    [B, n_seg, Kp, L*M] (reads the OLD eta); M is the allele slots per
    locus, which maps a lane to its locus's miss count.  ``k_true`` (0:
    all Kp lanes) is where the kernel's cluster loops stop: rows k >= it
    come out 0.  The rows are split into ``cols_segments``."""
    L = _loci(p2.shape[-1], M)
    _check_k_true(k_true, eta.shape[-1])
    if not eta.is_cuda:
        return fullstep_partials_reference(eta, p2, x2, miss)
    extra = ()
    if miss is not None:
        extra = (("miss", miss, torch.int8, (eta.shape[1], L)),)
    B, I, LM, Kp = _check_cuda_inputs(eta, p2, x2, *extra)
    n_seg, seg_rows = cols_segments(B, I, LM, Kp,
                                    device_sm_count(eta.device), k_true)
    part = torch.empty((B, n_seg, Kp, LM), dtype=torch.float32,
                       device=eta.device)
    sub, scratch = 0, None
    if is_wide(Kp):   # d of a lane sub-window (fullstep_bi.cols_sub_cols)
        sub = cols_sub_cols(B, I, LM, wide_chunks(kc_of(k_true, Kp)),
                            device_sm_count(eta.device), bi=False)
        scratch = torch.empty(B * I * sub, dtype=torch.float32,
                              device=eta.device)
    build.launch("mc_fullstep_cols", eta.device,
                 eta.data_ptr(), p2.data_ptr(), x2.data_ptr(), _ptr(miss),
                 part.data_ptr(), B, I, L, M, Kp, int(k_true), n_seg,
                 seg_rows, _ptr(scratch), sub,
                 also=("wide_cols_generic",) if is_wide(Kp) else ())
    return part


def fullstep_p(p2, part, mask=None, *, M: int, k_true: int = 0,
               plb: float = 0.0, project: bool = False, finish: bool = True):
    """p epilogue: p' [B, Kp, L, M] from the partials, or raw B [B, Kp,
    L*M] under ``finish=False``.  The kernel reads the partials' lanes
    below the lane tile of ``k_true``; the lanes past it must be zero, as
    the columns pass writes them, and come out 0."""
    B, Kp, LM = p2.shape
    L = _loci(LM, M)
    if finish and (mask is None or tuple(mask.shape) != (L, M)):
        raise ValueError(f"the p epilogue needs the [L, M] = {[L, M]} "
                         f"allele mask")
    if not p2.is_cuda:
        return fullstep_p_reference(p2, part, mask, k_true=k_true, plb=plb,
                                    project=project, finish=finish)
    if part.dim() != 4 or (part.shape[0], part.shape[2],
                           part.shape[3]) != (B, Kp, LM):
        raise ValueError(f"partials shape {tuple(part.shape)} against p2 "
                         f"{tuple(p2.shape)}")
    for name, t, dt in (("p2", p2, torch.float32),
                        ("part", part, torch.float32)) + (
            () if mask is None else (("mask", mask, torch.bool),)):
        if t.device != p2.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: contiguous {dt} on {p2.device} "
                             f"expected")
    out = torch.empty_like(p2)
    build.launch("mc_fullstep_p", p2.device,
                 p2.data_ptr(), part.data_ptr(), _ptr(mask), out.data_ptr(),
                 B, Kp, L, M, part.shape[1], int(k_true), float(plb),
                 int(project), int(finish))
    return out.view(B, Kp, L, M) if finish else out


def fullstep_cols(eta, p2, x2, miss=None, mask=None, *, k_true: int = 0,
                  plb: float = 0.0, project: bool = False,
                  finish: bool = True):
    """Columns pass and p epilogue: p' [B, Kp, L, M] (reads the OLD eta),
    or raw B [B, Kp, L*M] under ``finish=False``.  ``k_true`` (0: all Kp
    lanes) bounds both the kernels' cluster loops and the projection's
    lanes."""
    if mask is not None:
        M = mask.shape[1]
    elif miss is not None:
        M = p2.shape[-1] // miss.shape[-1]
    else:
        M = 1
    part = fullstep_partials(eta, p2, x2, miss, M=M, k_true=k_true)
    return fullstep_p(p2, part, mask, M=M, k_true=k_true, plb=plb,
                      project=project, finish=finish)


def admixture_fullstep(eta, p2, x2, c, miss, mask, *, k_true: int, lb: float,
                       plb: float, project: bool, compute_t: bool = True):
    """One generic admixture EM step for a chain batch:
    (eta' [B, I, Kp], t [B, I], p' [B, Kp, L, M]).  The eta Michelot and
    the p projection share ``project`` (cfg.do_projection)."""
    eta_new, t = fullstep_rows(eta, p2, x2, c, k_true=k_true, lb=lb,
                               project=project, compute_t=compute_t,
                               M=mask.shape[1])
    p_new = fullstep_cols(eta, p2, x2, miss, mask, k_true=k_true, plb=plb,
                          project=project)
    return eta_new, t, p_new


def admixture_sweep_stats(eta, p2, x2, miss=None, *, M: int = 0,
                          k_true: int = 0, compute_t: bool = True):
    """Sweep statistics A [B, I, Kp], t [B, I], B [B, Kp, L*M] with no eta
    or p finish (``admixture_sweep_fused`` / ``admixture_sweep_stats``):
    the same passes as the full step, with ``finish=False``.  With ``miss``
    [I, L] (and ``M`` slots a locus) B has the miss fold; ``k_true`` (0:
    all Kp lanes) is where the kernels' cluster loops stop, and B's rows
    past it come out 0."""
    k_true = k_true or eta.shape[-1]
    A, t = fullstep_rows(eta, p2, x2, k_true=k_true, lb=0.0, project=False,
                         compute_t=compute_t, finish=False, M=M)
    if miss is None:
        return A, t, fullstep_cols(eta, p2, x2, k_true=k_true, finish=False)
    part = fullstep_partials(eta, p2, x2, miss, M=M, k_true=k_true)
    return A, t, fullstep_p(p2, part, M=M, k_true=k_true, finish=False)
