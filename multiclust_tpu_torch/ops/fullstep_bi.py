"""Biallelic admixture full EM step: the CUDA kernel pair and its plain
PyTorch version.

Replaces the Pallas TPU kernel ``admixture_fullstep_biallelic`` /
``_fullstep_bi_kernel`` (multiclust_tpu/ops/kernels.py:344-615).  The
kernel source, ``csrc/fullstep_bi.cu``, splits the step into a rows pass
(d, w, t, A, and the eta finish with its Michelot projection) and a
columns pass (d, w again, per-segment B0/B1 partials, then the p0 update
over their fixed-order sum), each reading x once:
Hopper blocks run concurrently, so the TPU's in-order grid that keeps
B0/B1 resident cannot carry over.  The price is reading x twice, against
once on the TPU; the step is bound by IEEE f32 FMA (no TF32) and shared
memory issue, not by device memory (see the .cu header).

The wrappers launch the kernels for CUDA tensors and run the plain
version only for CPU tensors; there is no fallback for CUDA tensors.
Variants ported: ``miss``, ``compute_t`` and ``project``.  Shapes: eta
[B, I, Kp] f32 with Kp in {32, 64, 96, 128}, p0 [B, Kp, L] f32, x0/x1
[I, L] int8, c [I] f32 missing totals, miss [I, L] int8 or None.  Pad
lanes (k >= k_true) of eta and p0 must be zero and stay zero.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from multiclust_tpu_torch.ops import build
from multiclust_tpu_torch.ops.simplex import project_rows

Tensor = torch.Tensor

KP_SUPPORTED = (32, 64, 96, 128)
# columns-pass tiling of csrc/fullstep_bi.cu (COL_TC columns per block,
# COL_RI rows per tile); the row-segment count is chosen here
COL_TC, COL_RI = 16, 32
# padded / degenerate columns have d = 0 with x = 0: the clamp keeps
# 0 / d at 0 and 0 * log(d) at 0
D_MIN = 1e-30


def p0_clip_bounds(plb: float, dtype: torch.dtype = torch.float32
                   ) -> Tuple[float, float]:
    """(lb, ub) of the closed-form 2-simplex projection of p0.  The upper
    bound is the largest representable 1 - max(plb, eps): in float32,
    1 - plb rounds to 1.0 for the reference's 1e-8 bound, which would make
    the implicit complement an exact zero probability
    (kernels.py:453-462)."""
    ft = np.float32 if dtype == torch.float32 else np.float64
    ub = float(ft(1.0) - ft(max(plb, float(np.finfo(ft).eps))))
    return float(plb), ub


def _denominators(eta: Tensor, p0: Tensor):
    d0 = eta @ p0                                     # [B, I, L]
    d1 = eta.sum(dim=-1, keepdim=True) - d0
    return torch.clamp(d0, min=D_MIN), torch.clamp(d1, min=D_MIN)


def fullstep_bi_rows_reference(eta: Tensor, p0: Tensor, x0: Tensor,
                               x1: Tensor, c: Tensor, *, k_true: int,
                               lb: float, project: bool,
                               compute_t: bool = True
                               ) -> Tuple[Tensor, Tensor]:
    """Plain version of the rows pass: (eta' [B, I, Kp], t [B, I])."""
    dtype = eta.dtype
    x0f, x1f = x0.to(dtype), x1.to(dtype)
    d0, d1 = _denominators(eta, p0)
    w0, w1 = x0f / d0, x1f / d1
    if compute_t:
        t = (x0f * torch.log(d0) + x1f * torch.log(d1)).sum(dim=-1)
    else:
        t = eta.new_zeros(eta.shape[:-1])
    # A_ik = sum_l [w0 p0 + w1 (1 - p0)]_k = (w0 - w1) @ p0^T + sum_l w1
    A = ((w0 - w1) @ p0.transpose(-1, -2)
         + w1.sum(dim=-1, keepdim=True) + c.to(dtype)[:, None])
    num = eta * A
    tot = num.sum(dim=-1, keepdim=True)
    ok = tot > 0
    eta_new = torch.where(ok, num / torch.where(ok, tot, torch.ones_like(tot)),
                          eta)
    if project:
        lanes = torch.arange(eta.shape[-1], device=eta.device) < k_true
        eta_new = project_rows(eta_new, lanes, lb)
    return eta_new, t


def fullstep_bi_cols_reference(eta: Tensor, p0: Tensor, x0: Tensor,
                               x1: Tensor, miss: Optional[Tensor], *,
                               plb: float, project: bool) -> Tensor:
    """Plain version of the columns pass: p0' [B, Kp, L]."""
    dtype = eta.dtype
    d0, d1 = _denominators(eta, p0)
    w0, w1 = x0.to(dtype) / d0, x1.to(dtype) / d1
    if miss is not None:
        # missing-mass p-update term (em_alg.c:727-746): B += eta^T miss
        # for both alleles, folded into the B products
        m = miss.to(dtype)
        w0, w1 = w0 + m, w1 + m
    et = eta.transpose(-1, -2)
    pc0 = p0 * (et @ w0)
    pc1 = (1.0 - p0) * (et @ w1)
    tot = pc0 + pc1
    ok = tot > 0
    zero = torch.zeros((), dtype=dtype, device=eta.device)
    q0 = torch.where(ok, pc0 / torch.where(ok, tot, torch.ones_like(tot)),
                     zero)
    if project:
        lo, hi = p0_clip_bounds(plb)
        q0 = torch.where(ok, torch.clamp(q0, lo, hi), zero)
    return q0


def admixture_fullstep_biallelic_reference(eta, p0, x0, x1, c, miss=None,
                                           *, k_true: int, lb: float,
                                           plb: float, project: bool,
                                           compute_t: bool = True):
    """Plain PyTorch version of the whole step: (eta', t, p0')."""
    eta_new, t = fullstep_bi_rows_reference(
        eta, p0, x0, x1, c, k_true=k_true, lb=lb, project=project,
        compute_t=compute_t)
    p0_new = fullstep_bi_cols_reference(eta, p0, x0, x1, miss, plb=plb,
                                        project=project)
    return eta_new, t, p0_new


def check_kp(Kp: int) -> None:
    """Raise for a padded cluster count the CUDA kernels do not take."""
    if Kp not in KP_SUPPORTED:
        raise ValueError(f"Kp={Kp}: the CUDA kernels take Kp in "
                         f"{KP_SUPPORTED} (K <= 128); see ROADMAP.md queue 3, "
                         f"'Kp > 128 on CUDA'")


def _check_cuda_inputs(eta, p0, x0, x1, *extra):
    if eta.dim() != 3 or p0.dim() != 3:
        raise ValueError(f"eta [B, I, Kp] and p0 [B, Kp, L] expected, got "
                         f"{tuple(eta.shape)} and {tuple(p0.shape)}")
    B, I, Kp = eta.shape
    L = p0.shape[-1]
    check_kp(Kp)
    if p0.shape != (B, Kp, L):
        raise ValueError(f"p0 shape {tuple(p0.shape)} != {(B, Kp, L)}")
    for name, t, dt, shape in (("eta", eta, torch.float32, None),
                               ("p0", p0, torch.float32, None),
                               ("x0", x0, torch.int8, (I, L)),
                               ("x1", x1, torch.int8, (I, L))) + extra:
        if t.device != eta.device:
            raise ValueError(f"{name} on {t.device}, eta on {eta.device}")
        if t.dtype != dt:
            raise ValueError(f"{name} dtype {t.dtype}, kernel takes {dt}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return B, I, L, Kp


def fullstep_bi_rows(eta, p0, x0, x1, c, *, k_true: int, lb: float,
                     project: bool, compute_t: bool = True):
    """Rows pass: (eta' [B, I, Kp] in a new buffer, t [B, I])."""
    if not eta.is_cuda:
        return fullstep_bi_rows_reference(
            eta, p0, x0, x1, c, k_true=k_true, lb=lb, project=project,
            compute_t=compute_t)
    B, I, L, Kp = _check_cuda_inputs(
        eta, p0, x0, x1, ("c", c, torch.float32, (eta.shape[1],)))
    eta_new = torch.empty_like(eta)
    t = torch.empty((B, I), dtype=torch.float32, device=eta.device)
    build.launch("mc_fullstep_bi_rows", eta.device,
                 eta.data_ptr(), p0.data_ptr(), x0.data_ptr(),
                 x1.data_ptr(), c.data_ptr(), eta_new.data_ptr(),
                 t.data_ptr(), B, I, L, Kp, int(k_true), float(lb),
                 int(project), int(compute_t))
    return eta_new, t


def col_segments(I: int, L: int, B: int, n_sm: int, *, tc: int = COL_TC,
                 ri: int = COL_RI, per_sm: int = 4) -> Tuple[int, int]:
    """(segments, rows per segment) splitting I for a columns pass of
    ``tc`` columns per block and ``ri`` rows per tile: at least ``per_sm``
    blocks per SM when I allows, each segment >= 4 row tiles."""
    blocks = -(-L // tc) * B
    n_seg = max(1, min(-(-per_sm * n_sm // blocks), -(-I // (4 * ri))))
    seg_rows = -(-I // n_seg)
    seg_rows = -(-seg_rows // ri) * ri
    return -(-I // seg_rows), seg_rows


def fullstep_bi_cols(eta, p0, x0, x1, miss=None, *, plb: float,
                     project: bool):
    """Columns pass: p0' [B, Kp, L] (reads the OLD eta)."""
    if not eta.is_cuda:
        return fullstep_bi_cols_reference(eta, p0, x0, x1, miss, plb=plb,
                                          project=project)
    extra = ()
    if miss is not None:
        extra = (("miss", miss, torch.int8, tuple(x0.shape)),)
    B, I, L, Kp = _check_cuda_inputs(eta, p0, x0, x1, *extra)
    lo, hi = p0_clip_bounds(plb)
    n_seg, seg_rows = col_segments(
        I, L, B, torch.cuda.get_device_properties(
            eta.device).multi_processor_count)
    part = torch.empty((B, n_seg, 2, Kp, L), dtype=torch.float32,
                       device=eta.device)
    p0_new = torch.empty_like(p0)
    build.launch("mc_fullstep_bi_cols", eta.device,
                 eta.data_ptr(), p0.data_ptr(), x0.data_ptr(),
                 x1.data_ptr(), build.ptr(miss),
                 part.data_ptr(), p0_new.data_ptr(), B, I, L, Kp, n_seg,
                 seg_rows, lo, hi, int(project))
    return p0_new


def admixture_fullstep_biallelic(eta, p0, x0, x1, c, miss=None, *,
                                 k_true: int, lb: float, plb: float,
                                 project: bool, compute_t: bool = True):
    """One biallelic admixture EM step for a chain batch:
    (eta' [B, I, Kp], t [B, I], p0' [B, Kp, L]).  The p0 clip and the eta
    Michelot share ``project`` (kernels.py:435, :452)."""
    eta_new, t = fullstep_bi_rows(eta, p0, x0, x1, c, k_true=k_true, lb=lb,
                                  project=project, compute_t=compute_t)
    p0_new = fullstep_bi_cols(eta, p0, x0, x1, miss, plb=plb,
                              project=project)
    return eta_new, t, p0_new
