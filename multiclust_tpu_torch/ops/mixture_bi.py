"""Biallelic mixture EM step: the CUDA kernels and their plain PyTorch
versions.

Replaces the Pallas TPU kernels ``mixture_fullstep_biallelic`` /
``_mix_scores_kernel``, ``_mix_counts_kernel``
(multiclust_tpu/ops/kernels.py:1139-1313) and the single-pass sweep
``mixture_sweep_resident`` / ``_mix_resident_kernel`` (:1316-1415).  The
kernel source, ``csrc/mixture_bi.cu``, splits the step into a rows pass
(scores, row softmax: v and the logsumexp t), a columns pass (per-segment
partials of B0 = v^T x0, B1 = v^T x1, and of sum_i v) and one finish
launch: its eta half sums the v partials in a fixed order, normalizes and
projects (``_finish_eta``, which JAX runs in XLA), its p half sums the B
partials and applies the p0 update of ``_mix_counts_kernel``, each half
summing vtot itself.  The finish writes the JAX function's outputs (eta',
p0' [B, Kp, L]) or the model's parameters (eta [B, K], p [B, K, L, 2] =
(p0', 1 - p0'), ``params=True``).  Either half runs alone: the eta half
as ``mixture_eta`` (the other mixtures' eta), the p half without its p0
update as ``mixture_b`` (the sweep's raw B0, B1).  The rows and
columns passes contract on the float64 tensor cores, as the plain
versions' float64 products do; their cluster tiles stop at ``k_true``.  At
128 < Kp <= 1024 (KP_MAX, the TPU kernels' own range) the same launchers
run the wide passes: 128 x 128 block tiles of 4 x 4 float64 DMMA tiles a
warp on balanced chunks of at most 128 of the ``k_true`` live lanes
(``chunks``), the rows pass's scores in a float64 scratch and a softmax
launch, and the finish's eta half at 8, 16 or 32 lanes a thread.
Rows, columns and the raw p half together are the sweep
(``mixture_sweep_stats``).  Every
step of the finish runs on the card, so a kernel-route EM step never
reads the host.

The wrappers launch the kernels for CUDA tensors and run the plain version
only for CPU tensors; there is no fallback for CUDA tensors, and a Kp
above KP_MAX raises there (the model runs the plain step above it, as the
JAX package runs XLA).  Shapes: a chain batch B leads.  lp0/lp1 [B, Kp, L]
f32 with Kp a multiple of 32 up to 1024, bias [B, Kp] f32 (K-pad lanes
-1e30, their lp 0), x0/x1 [I, L] int8.
One-stream calls (x1 None) fold x1 = ploidy - x0 (lp0 = log p0 - log p1);
two-stream calls carry missing data.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from multiclust_tpu_torch.ops import build
from multiclust_tpu_torch.ops.build import ptr as _ptr
from multiclust_tpu_torch.ops.fullstep_bi import GRID_YZ_MAX, KP_MAX, \
    KP_NARROW, device_sm_count, p0_clip_bounds
from multiclust_tpu_torch.ops.simplex import project_rows

Tensor = torch.Tensor

# the columns pass's tiling in csrc/mixture_bi.cu (ColsTile): warps a
# block, rows a stage; the row-segment count is chosen here.  WK: cluster
# lanes a chunk of the wide passes (MIX_WK, at most); the wide columns
# pass (WideColsTile): loci a block for one and two streams, rows a stage
NW, COL_RI, WK = 8, 32, 128
WIDE_TC, WIDE_RI = {False: 128, True: 64}, 128


def check_kp(Kp: int) -> None:
    """Raise for a padded cluster count the mixture kernels do not take:
    the multiples of 32 up to KP_MAX; above it the model's step takes the
    plain formulation."""
    if Kp % 32 or not 32 <= Kp <= KP_MAX:
        raise ValueError(f"Kp={Kp}: the mixture kernels take a multiple of "
                         f"32 up to {KP_MAX}; above that the mixture "
                         f"takes the plain step (model/mixture._kernel_ok)")


def is_wide(Kp: int) -> bool:
    """Kp of the wide passes (128 < Kp <= KP_MAX)."""
    return Kp > KP_NARROW[-1]


def chunks(Kp: int, k_true: int = 0) -> int:
    """Cluster chunks the wide passes cut the live lanes into (1 at Kp <=
    128): the ceil(k_true / 8) live tiles of 8 lanes (k_true outside [1,
    Kp]: Kp) in chunks of at most WK lanes that differ by at most one
    tile (csrc/mixture_bi.cu, ``wide_chunks``)."""
    if not is_wide(Kp):
        return 1
    tiles = -(-(k_true if 1 <= k_true <= Kp else Kp) // 8)
    return -(-tiles // (WK // 8))


def cols_tile(Kp: int, two: bool) -> int:
    """Loci a columns-pass block for Kp lanes and one or two streams, as
    ``ColsTile`` in csrc/mixture_bi.cu computes it (``mc_mix_tiles``
    reports it): a warp computes one tile of 16 loci by ``ntw`` tiles of 8
    clusters, at most 8 float64 accumulator tiles a thread over the
    streams, and the block's NW warps split the Kp / 8 cluster tiles into
    groups of ``ntw``.  The wide pass (``WideColsTile``) takes WIDE_TC
    loci on each chunk of at most WK lanes."""
    if is_wide(Kp):
        return WIDE_TC[two]
    ns, nt8 = (2 if two else 1), Kp // 8
    ntw = next((d for d in range(nt8, 1, -1)
                if nt8 % d == 0 and ns * d <= 8 and NW % (nt8 // d) == 0), 1)
    return 16 * (NW // (nt8 // ntw))


def cols_stage_rows(Kp: int) -> int:
    """Rows a columns-pass stage (``mc_mix_tiles`` reports it): COL_RI,
    WIDE_RI in the wide pass."""
    return WIDE_RI if is_wide(Kp) else COL_RI


def cols_blocks_per_sm(Kp: int, two: bool) -> int:
    """Columns-pass blocks an SM holds (``ColsTile::MINB``): two at Kp = 32
    and 96 with one stream, one elsewhere (the wide pass too)."""
    return 2 if Kp in (32, 96) and not two else 1


def cols_segments(I: int, L: int, B: int, Kp: int, two: bool,
                  n_sm: int, k_true: int = 0) -> Tuple[int, int]:
    """(segments, rows per segment) of I for the columns pass: as many
    row segments as fill the card's block slots in one wave without
    passing them (a block is a tile of ``cols_tile`` loci of one chain; a
    wave a few blocks past the slots costs a second wave, and fewer
    segments mean fewer partials to write and sum), each segment whole
    stages (``cols_stage_rows``) and at least 4 of them, at most
    GRID_YZ_MAX.  A wide pass has a block for each cluster chunk of
    k_true's lanes as well."""
    ri = cols_stage_rows(Kp)
    blocks = -(-L // cols_tile(Kp, two)) * B * chunks(Kp, k_true)
    n_seg = max(1, min(cols_blocks_per_sm(Kp, two) * n_sm // blocks,
                       -(-I // (4 * ri)), GRID_YZ_MAX))
    seg_rows = -(-I // n_seg)
    seg_rows = -(-seg_rows // ri) * ri
    return -(-I // seg_rows), seg_rows


def _streams(x0: Tensor, x1: Optional[Tensor]):
    return (x0,) if x1 is None else (x0, x1)


def mixture_rows_reference(lp0: Tensor, x0: Tensor, bias: Tensor,
                           lp1: Optional[Tensor] = None,
                           x1: Optional[Tensor] = None
                           ) -> Tuple[Tensor, Tensor]:
    """Plain version of the rows pass: (v [B, I, Kp], t [B, I]).  The
    scores and the softmax run in float64 whatever the input dtype: at L
    in the thousands |s| ~ 10^3, and float32 rounding of s alone would move
    v by more than the kernel's 1e-4 tolerance."""
    dtype, f64 = lp0.dtype, torch.float64
    s = x0.to(f64) @ lp0.to(f64).transpose(-1, -2)    # [B, I, Kp]
    if lp1 is not None:
        s = s + x1.to(f64) @ lp1.to(f64).transpose(-1, -2)
    s = s + bias.to(f64)[:, None, :]
    m = s.max(dim=-1, keepdim=True).values
    e = torch.exp(s - m)
    tot = e.sum(dim=-1, keepdim=True)
    return ((e / tot).to(dtype),
            (torch.log(tot[..., 0]) + m[..., 0]).to(dtype))


def mixture_cols_reference(v: Tensor, x0: Tensor,
                           x1: Optional[Tensor] = None
                           ) -> Tuple[Tensor, Tensor]:
    """Plain version of the columns pass as a single row segment: the B
    partials [B, 1, S, Kp, L] (S = 1 or 2 streams: B0 = v^T x0, B1 =
    v^T x1) and the v sums [B, 1, Kp]."""
    vt = v.transpose(-1, -2)                          # [B, Kp, I]
    part = torch.stack([vt @ x.to(v.dtype) for x in _streams(x0, x1)],
                       dim=1)
    return part[:, None], v.sum(dim=1)[:, None]


def mixture_eta_reference(vpart: Tensor, *, k_true: int, lb: float,
                          project: bool) -> Tensor:
    """Plain version of the eta finish (``_finish_eta``, mixture.py:106):
    eta' [B, Kp] from the v sums [B, S, Kp]."""
    vtot = vpart.sum(dim=1)
    eta = vtot / vtot.sum(dim=-1, keepdim=True)
    if project:
        lanes = torch.arange(eta.shape[-1], device=eta.device) < k_true
        eta = project_rows(eta, lanes, lb)
    return eta


def mixture_b_reference(part: Tensor) -> Tuple[Tensor, Optional[Tensor]]:
    """Plain version of the raw p half: B0 [B, Kp, L] and B1 (None for one
    stream), the partials [B, S, 1|2, Kp, L] summed over the segments."""
    Bm = part.sum(dim=1)                              # [B, 1|2, Kp, L]
    return Bm[:, 0], (Bm[:, 1] if Bm.shape[1] == 2 else None)


def mixture_p_reference(part: Tensor, vtot: Tensor, *, plb: float,
                        ploidy: int, project: bool) -> Tensor:
    """Plain version of the p0 epilogue (``_mix_counts_kernel``'s finish,
    kernels.py:1196-1210): p0' [B, Kp, L] from the partials [B, S, 1|2,
    Kp, L] and vtot [B, Kp]."""
    b0, b1 = mixture_b_reference(part)
    pc0 = b0 + plb
    if b1 is not None:
        pc1 = b1 + plb
    else:
        # sum_i v_ik x1_il = ploidy vtot_k - B0_kl (x1 = ploidy - x0)
        pc1 = ploidy * vtot[..., None] - b0 + plb
    q = pc0 / (pc0 + pc1)
    if project:
        lo, hi = p0_clip_bounds(plb, q.dtype)
        q = torch.clamp(q, lo, hi)
    return q


def params_layout(eta: Tensor, p0: Tensor, k_true: int
                  ) -> Tuple[Tensor, Tensor]:
    """The model's parameters from the finish's K-padded outputs: eta [B,
    K] and p [B, K, L, 2] = (p0', 1 - p0') over the k_true live lanes."""
    p0 = p0[:, :k_true]
    return (eta[:, :k_true].contiguous(),
            torch.stack([p0, 1.0 - p0], dim=-1))


def mixture_finish_reference(part: Tensor, vpart: Tensor, *, k_true: int,
                             lb: float, plb: float, ploidy: int,
                             project: bool, params: bool = False):
    """Plain version of the finish, the eta finish and the p0 epilogue in
    turn: (eta' [B, Kp], vtot [B, Kp], p0' [B, Kp, L]) from the partials
    [B, S, 1|2, Kp, L] and the v sums [B, S, Kp], or under ``params``
    the model's (eta [B, K], p [B, K, L, 2]) (``params_layout``)."""
    eta = mixture_eta_reference(vpart, k_true=k_true, lb=lb,
                                project=project)
    vtot = vpart.sum(dim=1)
    p0 = mixture_p_reference(part, vtot, plb=plb, ploidy=ploidy,
                             project=project)
    return params_layout(eta, p0, k_true) if params else (eta, vtot, p0)


def mixture_fullstep_biallelic_reference(lp0, x0, bias, lp1=None, x1=None,
                                         *, k_true: int, lb: float,
                                         plb: float, ploidy: int,
                                         project: bool):
    """Plain PyTorch version of the whole step: (eta' [B, Kp], t [B, I],
    p0' [B, Kp, L])."""
    v, t = mixture_rows_reference(lp0, x0, bias, lp1, x1)
    part, vpart = mixture_cols_reference(v, x0, x1)
    eta, _, p0 = mixture_finish_reference(part, vpart, k_true=k_true, lb=lb,
                                          plb=plb, ploidy=ploidy,
                                          project=project)
    return eta, t, p0


def mixture_sweep_stats_reference(lp0, x0, bias, lp1=None, x1=None):
    """Plain version of the sweep statistics (``mixture_sweep_resident``):
    raw v [B, I, Kp], t [B, I], B0 [B, Kp, L] and B1 (None for one
    stream)."""
    v, t = mixture_rows_reference(lp0, x0, bias, lp1, x1)
    part, _ = mixture_cols_reference(v, x0, x1)
    return (v, t) + mixture_b_reference(part)


def _check(name: str, t: Tensor, dev, dtype, shape) -> None:
    if t.device != dev:
        raise ValueError(f"{name} on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise ValueError(f"{name} dtype {t.dtype}, kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def mixture_rows(lp0, x0, bias, lp1=None, x1=None, *, k_true: int = 0):
    """Rows pass: (v [B, I, Kp], t [B, I]); the kernels compute the lanes
    below ``k_true`` (0: all Kp) and write v = 0 past it."""
    if not lp0.is_cuda:
        return mixture_rows_reference(lp0, x0, bias, lp1, x1)
    if (lp1 is None) != (x1 is None):
        raise ValueError("lp1 and x1 come together (two-stream variant)")
    B, Kp, L = lp0.shape
    check_kp(Kp)
    I = x0.shape[0]
    dev = lp0.device
    _check("lp0", lp0, dev, torch.float32, (B, Kp, L))
    _check("x0", x0, dev, torch.int8, (I, L))
    _check("bias", bias, dev, torch.float32, (B, Kp))
    if lp1 is not None:
        _check("lp1", lp1, dev, torch.float32, (B, Kp, L))
        _check("x1", x1, dev, torch.int8, (I, L))
    v = torch.empty((B, I, Kp), dtype=torch.float32, device=dev)
    t = torch.empty((B, I), dtype=torch.float32, device=dev)
    # the wide pass's float64 scores, between its two launches
    s = (torch.empty((B, I, Kp), dtype=torch.float64, device=dev)
         if is_wide(Kp) else None)
    build.launch("mc_mix_rows", dev, lp0.data_ptr(), _ptr(lp1),
                 x0.data_ptr(), _ptr(x1), bias.data_ptr(), v.data_ptr(),
                 t.data_ptr(), _ptr(s), B, I, L, Kp, int(k_true),
                 also=("wide_mix_rows",) if is_wide(Kp) else ())
    return v, t


def mixture_partials(v, x0, x1=None, *, k_true: int = 0):
    """Columns pass: the per-row-segment B partials [B, n_seg, 1|2, Kp, L]
    and v sums [B, n_seg, Kp]; the kernels compute the lanes below
    ``k_true`` (0: all Kp) and write zeros past it (above 128 lanes the v
    sums too: v is 0 there on the rows pass's output)."""
    if not v.is_cuda:
        return mixture_cols_reference(v, x0, x1)
    B, I, Kp = v.shape
    check_kp(Kp)
    L = x0.shape[1]
    dev = v.device
    _check("v", v, dev, torch.float32, (B, I, Kp))
    _check("x0", x0, dev, torch.int8, (I, L))
    if x1 is not None:
        _check("x1", x1, dev, torch.int8, (I, L))
    n_ch = chunks(Kp, k_true)
    if B * n_ch > GRID_YZ_MAX:
        raise ValueError(f"{B} chains x {n_ch} cluster chunks exceed the "
                         f"grid's {GRID_YZ_MAX}")
    ns = 1 if x1 is None else 2
    n_seg, seg_rows = cols_segments(I, L, B, Kp, ns == 2,
                                    device_sm_count(dev), k_true)
    part = torch.empty((B, n_seg, ns, Kp, L), dtype=torch.float32,
                       device=dev)
    vpart = torch.empty((B, n_seg, Kp), dtype=torch.float32, device=dev)
    build.launch("mc_mix_cols", dev, v.data_ptr(), x0.data_ptr(), _ptr(x1),
                 part.data_ptr(), vpart.data_ptr(), B, I, L, Kp, n_seg,
                 seg_rows, int(k_true),
                 also=("wide_mix_cols",) if is_wide(Kp) else ())
    return part, vpart


def _launch_finish(part, vpart, *, vtot=None, eta=None, out0=None,
                   out1=None, k_true=0, lb=0.0, plb=0.0, ploidy=0,
                   project=False, finish=True, params=False) -> None:
    """One launch of the finish (``mc_mix_finish``): the eta half where
    ``eta`` is given, the p half where ``out0`` is; shapes checked by the
    callers."""
    src = part if part is not None else vpart
    Kp = src.shape[-2] if part is not None else src.shape[-1]
    n_seg, two = ((part.shape[1], int(part.shape[2] == 2))
                  if part is not None else (0, 0))
    L = part.shape[-1] if part is not None else 0
    lo, hi = p0_clip_bounds(plb)
    build.launch("mc_mix_finish", src.device, _ptr(part), _ptr(vpart),
                 _ptr(vtot), _ptr(eta), _ptr(out0), _ptr(out1),
                 src.shape[0], Kp, L, n_seg,
                 vpart.shape[1] if vpart is not None else 0, two,
                 int(k_true), float(lb), lo, hi, float(ploidy), int(project),
                 int(finish), int(params),
                 also=("wide_mix_finish",) if is_wide(Kp) else ())


def _check_part(part: Tensor):
    """(B, n_seg, streams, Kp, L) of checked columns-pass partials."""
    B, n_seg, ns, Kp, L = part.shape
    check_kp(Kp)
    _check("part", part, part.device, torch.float32, part.shape)
    if ns not in (1, 2):
        raise ValueError(f"part has {ns} streams, the kernels take 1 or 2")
    return B, n_seg, ns, Kp, L


def mixture_finish(part, vpart, *, k_true: int, lb: float, plb: float,
                   ploidy: int, project: bool, params: bool = False):
    """The finish, one launch: (eta' [B, Kp], vtot [B, Kp], p0' [B, Kp,
    L]) from the columns pass's partials [B, S, 1|2, Kp, L] and v sums
    [B, S, Kp]; under ``params`` the model's (eta [B, K], p [B, K, L, 2]
    = (p0', 1 - p0')) for K = ``k_true`` in [1, Kp], written by the
    kernel.  The eta Michelot and the p0 clip share ``project``."""
    if not part.is_cuda:
        return mixture_finish_reference(part, vpart, k_true=k_true, lb=lb,
                                        plb=plb, ploidy=ploidy,
                                        project=project, params=params)
    B, n_seg, _, Kp, L = _check_part(part)
    dev = part.device
    _check("vpart", vpart, dev, torch.float32, (B, n_seg, Kp))
    kw = dict(k_true=k_true, lb=lb, plb=plb, ploidy=ploidy, project=project)
    if params:
        if not 1 <= k_true <= Kp:
            raise ValueError(f"k_true={k_true}: the model's layout takes 1 "
                             f"to Kp={Kp} clusters")
        eta = torch.empty((B, k_true), dtype=torch.float32, device=dev)
        p = torch.empty((B, k_true, L, 2), dtype=torch.float32, device=dev)
        _launch_finish(part, vpart, eta=eta, out0=p, params=True, **kw)
        return eta, p
    eta = torch.empty((B, Kp), dtype=torch.float32, device=dev)
    vtot = torch.empty_like(eta)
    p0 = torch.empty((B, Kp, L), dtype=torch.float32, device=dev)
    _launch_finish(part, vpart, vtot=vtot, eta=eta, out0=p0, **kw)
    return eta, vtot, p0


def mixture_eta(vpart, *, k_true: int, lb: float, project: bool):
    """Eta finish: eta' [B, Kp] from the v sums [B, S, Kp]; the finish's
    eta half alone."""
    if not vpart.is_cuda:
        return mixture_eta_reference(vpart, k_true=k_true, lb=lb,
                                     project=project)
    B, n_seg, Kp = vpart.shape
    check_kp(Kp)
    _check("vpart", vpart, vpart.device, torch.float32, (B, n_seg, Kp))
    eta = torch.empty((B, Kp), dtype=torch.float32, device=vpart.device)
    _launch_finish(None, vpart, eta=eta, k_true=k_true, lb=lb,
                   project=project)
    return eta


def mixture_b(part):
    """Raw B0 [B, Kp, L] and B1 (None for one stream) from the partials
    [B, S, 1|2, Kp, L], summed in segment order: the finish's p half
    alone, without its p0 update."""
    if not part.is_cuda:
        return mixture_b_reference(part)
    B, n_seg, ns, Kp, L = _check_part(part)
    out0 = torch.empty((B, Kp, L), dtype=torch.float32, device=part.device)
    out1 = torch.empty_like(out0) if ns == 2 else None
    _launch_finish(part, None, out0=out0, out1=out1, finish=False)
    return out0, out1


def mixture_fullstep_biallelic(lp0, x0, bias, lp1=None, x1=None, *,
                               k_true: int, lb: float, plb: float,
                               ploidy: int, project: bool):
    """One biallelic mixture EM step for a chain batch: (eta' [B, Kp],
    t [B, I], p0' [B, Kp, L]), three launches (rows, columns, finish).
    The eta Michelot and the p0 clip share ``project``
    (cfg.do_projection)."""
    v, t = mixture_rows(lp0, x0, bias, lp1, x1, k_true=k_true)
    part, vpart = mixture_partials(v, x0, x1, k_true=k_true)
    eta, _, p0 = mixture_finish(part, vpart, k_true=k_true, lb=lb, plb=plb,
                                ploidy=ploidy, project=project)
    return eta, t, p0


def mixture_sweep_stats(lp0, x0, bias, lp1=None, x1=None, *,
                        k_true: int = 0):
    """Sweep statistics v, t, B0 [B, Kp, L] and B1 (None for one stream)
    with no eta or p finish (``mixture_sweep_resident``): the same passes
    as the full step, with the finish's raw p half."""
    v, t = mixture_rows(lp0, x0, bias, lp1, x1, k_true=k_true)
    part, _ = mixture_partials(v, x0, x1, k_true=k_true)
    return (v, t) + mixture_b(part)
