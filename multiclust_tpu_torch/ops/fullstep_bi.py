"""Biallelic admixture full EM step: the CUDA kernels and their plain
PyTorch versions.

Replaces the Pallas TPU kernel ``admixture_fullstep_biallelic`` /
``_fullstep_bi_kernel`` (multiclust_tpu/ops/kernels.py:344-615).  The
kernel source, ``csrc/fullstep_bi.cu``, splits the step into a rows pass
(d, w, t, A, and the eta finish with its Michelot projection) and a
columns pass (d, w again, per-segment B0/B1 partials, then the p0 update
over their fixed-order sum), each reading x once:
Hopper blocks run concurrently, so the TPU's in-order grid that keeps
B0/B1 resident cannot carry over.  The price is reading x twice, against
once on the TPU.  Both passes are bound by instruction issue, not by
device memory: IEEE f32 FMA on the CUDA cores (no TF32) in the columns
pass, ``logf`` and the reciprocals of the cells in the rows pass.  The
kernels keep the SM's shared-memory loads out of the way with register
tiles read as float4, stop their k loops at the lane tile of ``k_true``
(``lane_tile``), give a warp 4 x 32 / GL columns or rows, and stream the
other operand through cp.async rings (see the .cu header).  The tile
sizes depend on ``k_true``, so the segment arithmetic here
(``cols_row_segments``, ``row_segments``, ``pick_route``) takes it.

Three routes run the step (``pick_route`` chooses, the counterpart of
``pick_layout_biallelic_any``, kernels.py:809):

* ``pair``: the rows pass with its fused eta finish and the columns pass;
* ``streamed`` (``admixture_fullstep_biallelic_streamed``, kernels.py:1007):
  the rows pass also splits L into column segments, so that a wide and
  short panel fills the card; a finish kernel sums the segments' partials
  in order (t in float64) and finishes eta;
* ``chunked`` (``admixture_fullstep_biallelic_chunked``, kernels.py:829): a
  loop of such steps over column windows, raw A + r threaded from window
  to window through ``a0``/``emit_a``; it bounds the partials' scratch.

For 128 < Kp <= 1024 (the TPU kernels' own range, ``_bi_k_fits`` and
``_stream_vmem_fits``, kernels.py:653, :709) the segmented rows pass, its
finish and the columns pass are the wide kernels of ``csrc/wide.cuh``,
with their own tiles (``rows_block``, ``cols_tile``), on the float64
tensor cores: for each column sub-window a d launch (d = eta @ p into a
scratch plane), then the rows pass's A launch (A = u p^T on blocks of WR
rows x a balanced lane chunk of at most WA_CHUNK) and the columns pass's
B launch (B0/B1 on chunks of at most WIDE_CHUNK); the sub-windows keep
that scratch within SCRATCH_CAP (``cols_sub_cols``).  A step's window runs
both passes on one d (``window_partials``), then the finish and the p0
epilogue.  The pair has no wide kernel: ``pick_route`` sends those Kp down
the streamed or chunked step, and ``fullstep_bi_rows`` refuses them.
Above 1024 no kernel runs: the model takes the plain step
(``model/admixture.py``, the JAX package's XLA fallback).

The wrappers launch the kernels for CUDA tensors and run the plain
version only for CPU tensors; there is no fallback for CUDA tensors.
Variants: ``miss``, ``compute_t``, ``project`` and a runtime ``kmask``
on every route; ``emit_a``, ``emit_b``, ``a0`` and ``project_eta`` on
the streamed and chunked ones (which return t in float64).  A ``kmask``
(1.0/0.0 float32) is one [Kp] mask for every chain or a [B, Kp] mask of a
mixed-K lattice, a row a chain: the eta finish of the pair's rows pass
and of the finish kernel projects each chain over its row (``kmask_arg``),
while ``k_true``, the lattice's largest K, still bounds the loops; a
chain's lanes outside its row hold eta 0 and p0 0 and stay so.  Shapes: eta
[B, I, Kp] f32 with Kp a multiple of 32 up to 1024, p0 [B, Kp, L] f32,
x0/x1 [I, L] int8, c [I] f32 missing totals, miss [I, L] int8 or None.
Pad lanes (k >= k_true) of eta and p0 must be zero and stay zero: the
kernels neither load nor compute them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from multiclust_tpu_torch.ops import build
from multiclust_tpu_torch.ops.simplex import kmask_lanes, project_rows

Tensor = torch.Tensor

# the padded cluster counts of the narrow kernels (csrc/fullstep_bi.cu,
# csrc/fullstep.cu), and the largest of the wide ones (csrc/wide.cuh)
KP_NARROW = (32, 64, 96, 128)
KP_MAX = 1024
# tile constants of csrc/fullstep_bi.cu, under its names: warps a block;
# rows a thread in the rows pass's A phase, columns a rows-pass tile, the
# most row lanes of a rows-pass warp; columns a thread and rows a thread
# (d phase) in the columns pass
NW = 8
ROW_AR, ROW_TL, ROW_CW_MAX = 4, 32, 8
COL_CT, COL_DR = 4, 4
# tile constants of csrc/wide.cuh: rows of a rows-pass (A launch) block
# and cluster lanes of its chunk at most; the columns pass's B launch:
# columns of a block and rows a stage with the biallelic and with the
# generic cells, cluster lanes a chunk at most (``wide_chunks``); the d
# launch: rows and columns of a tile (a sub-window's columns are whole d
# tiles where they can be, ``cols_sub_cols``)
WR, WA_CHUNK = 64, 256
WTC, WRI, WTC_GENERIC, WRI_GENERIC = 64, 64, 128, 48
WIDE_CHUNK, WD_TILE = 128, 128
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
                               x1: Tensor, c: Tensor,
                               kmask: Optional[Tensor] = None, *,
                               k_true: int, lb: float, project: bool,
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
        eta_new = project_rows(
            eta_new, lanes_valid(eta.shape[-1], k_true, kmask, eta.device,
                                  eta.dim()), lb)
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
        lo, hi = p0_clip_bounds(plb, dtype)
        q0 = torch.where(ok, torch.clamp(q0, lo, hi), zero)
    return q0


def admixture_fullstep_biallelic_reference(eta, p0, x0, x1, c, miss=None,
                                           kmask=None, *, k_true: int,
                                           lb: float, plb: float,
                                           project: bool,
                                           compute_t: bool = True):
    """Plain PyTorch version of the whole step: (eta', t, p0')."""
    eta_new, t = fullstep_bi_rows_reference(
        eta, p0, x0, x1, c, kmask, k_true=k_true, lb=lb, project=project,
        compute_t=compute_t)
    p0_new = fullstep_bi_cols_reference(eta, p0, x0, x1, miss, plb=plb,
                                        project=project)
    return eta_new, t, p0_new


class LaneTile(NamedTuple):
    """How a warp's lanes and a thread's registers split the cluster axis
    (``lane_tile`` of csrc/fullstep_bi.cu): ``kc`` computed lanes, ``jt``
    groups of four a thread, ``gl`` cluster lanes, ``cw`` lanes of the
    other axis."""

    kc: int
    jt: int
    gl: int
    cw: int


def lane_tile(k_true: int, Kp: int, cw_max: int = 32) -> LaneTile:
    """The kernels' lane tile for ``k_true`` clusters padded to ``Kp``
    (``k_true`` outside [1, Kp] means Kp)."""
    k = Kp if not 1 <= k_true <= Kp else k_true
    g = -(-k // 4)
    jt = -(-g // 8)
    gl = -(-g // jt)
    return LaneTile(4 * gl * jt, jt, gl, min(32 // gl, cw_max))


def is_wide(Kp: int) -> bool:
    """Whether ``Kp`` runs the wide kernels (csrc/wide.cuh)."""
    return Kp > KP_NARROW[-1]


def kc_of(k_true: int, Kp: int) -> int:
    """Lanes the passes compute for ``k_true`` clusters padded to ``Kp``
    (``pass_kc`` of csrc/wide.cuh): the narrow lane tile's, or k_true
    rounded up to 4 lanes for the wide kernels."""
    if not is_wide(Kp):
        return lane_tile(k_true, Kp).kc
    k = Kp if not 1 <= k_true <= Kp else k_true
    return -(-k // 4) * 4


def rows_block(k_true: int, Kp: int) -> int:
    """Rows of a rows-pass block."""
    if is_wide(Kp):
        return WR
    return NW * ROW_AR * lane_tile(k_true, Kp, ROW_CW_MAX).cw


def cols_tile(k_true: int, Kp: int, generic: bool = False
              ) -> Tuple[int, int]:
    """(columns of a columns-pass block, rows of its eta tile); a wide
    Kp's B launch takes WTC columns and WRI-row stages with the biallelic
    cells (two streams), WTC_GENERIC and WRI_GENERIC with the generic
    ones (``generic``)."""
    if is_wide(Kp):
        return (WTC_GENERIC, WRI_GENERIC) if generic else (WTC, WRI)
    lt = lane_tile(k_true, Kp)
    return NW * COL_CT * lt.cw, COL_DR * lt.gl


def wide_chunks(kc: int, lanes: int = WIDE_CHUNK) -> int:
    """Cluster chunks of a wide launch for kc live lanes: ceil(kc / 8)
    tiles of 8 in chunks of at most ``lanes`` (csrc/dmma.cuh,
    ``wide_chunks``): WIDE_CHUNK for the columns pass's B launch, WA_CHUNK
    for the rows pass's A launch."""
    return -(-(-(-kc // 8)) // (lanes // 8))


def check_kp(Kp: int) -> None:
    """Raise for a padded cluster count the CUDA kernels do not take: a
    multiple of 32 up to KP_MAX."""
    if Kp % 32 or not 32 <= Kp <= KP_MAX:
        raise ValueError(f"Kp={Kp}: the CUDA kernels take Kp a multiple of "
                         f"32 up to {KP_MAX}; above that the fit takes the "
                         f"plain step with a notice (model/admixture.py, "
                         f"the JAX package's XLA fallback)")


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


def kmask_arg(kmask: Optional[Tensor], B: int, Kp: int, device):
    """(pointer, chain stride) of a runtime lane mask for the kernels:
    (None, 0) without one, stride 0 for a [Kp] mask every chain shares,
    Kp for a [B, Kp] mask (a row a chain); contiguous float32 on
    ``device``."""
    if kmask is None:
        return None, 0
    if (tuple(kmask.shape) not in ((Kp,), (B, Kp))
            or kmask.dtype != torch.float32 or kmask.device != device
            or not kmask.is_contiguous()):
        raise ValueError(f"kmask: contiguous float32 [{Kp}] or [{B}, {Kp}] "
                         f"on {device} expected, got {kmask.dtype} "
                         f"{tuple(kmask.shape)} on {kmask.device}")
    return kmask.data_ptr(), Kp if kmask.dim() == 2 else 0


def fullstep_bi_rows(eta, p0, x0, x1, c, kmask=None, *, k_true: int,
                     lb: float, project: bool, compute_t: bool = True):
    """Rows pass: (eta' [B, I, Kp] in a new buffer, t [B, I]); eta is
    projected over the lanes below ``k_true`` or over each chain's row of
    ``kmask`` ([Kp] or [B, Kp])."""
    if not eta.is_cuda:
        return fullstep_bi_rows_reference(
            eta, p0, x0, x1, c, kmask, k_true=k_true, lb=lb,
            project=project, compute_t=compute_t)
    B, I, L, Kp = _check_cuda_inputs(
        eta, p0, x0, x1, ("c", c, torch.float32, (eta.shape[1],)))
    if is_wide(Kp):
        raise ValueError(f"Kp={Kp}: the pair's fused rows pass takes Kp <= "
                         f"{KP_NARROW[-1]}; wider Kp run the streamed step "
                         f"(pick_route, admixture_fullstep_biallelic_"
                         f"streamed)")
    km, km_stride = kmask_arg(kmask, B, Kp, eta.device)
    eta_new = torch.empty_like(eta)
    t = torch.empty((B, I), dtype=torch.float32, device=eta.device)
    build.launch("mc_fullstep_bi_rows", eta.device,
                 eta.data_ptr(), p0.data_ptr(), x0.data_ptr(),
                 x1.data_ptr(), c.data_ptr(), km, eta_new.data_ptr(),
                 t.data_ptr(), B, I, L, Kp, int(k_true), float(lb),
                 int(project), int(compute_t), km_stride,
                 also=("masked_pair_rows",) if km is not None else ())
    return eta_new, t


def col_segments(I: int, L: int, B: int, n_sm: int, *, tc: int, ri: int,
                 per_sm: int = 4) -> Tuple[int, int]:
    """(segments, rows per segment) splitting I for a columns pass of
    ``tc`` columns per block and ``ri`` rows per tile: at least ``per_sm``
    blocks per SM when I allows, each segment >= 4 row tiles."""
    blocks = -(-L // tc) * B
    n_seg = max(1, min(-(-per_sm * n_sm // blocks), -(-I // (4 * ri)),
                       GRID_YZ_MAX))
    seg_rows = -(-I // n_seg)
    seg_rows = -(-seg_rows // ri) * ri
    return -(-I // seg_rows), seg_rows


def fullstep_bi_cols(eta, p0, x0, x1, miss=None, *, plb: float,
                     project: bool, k_true: int = 0, n_rseg: int = 0):
    """Columns pass: p0' [B, Kp, L] (reads the OLD eta).  ``k_true`` (0:
    all Kp lanes) is where the kernel's cluster loops stop; ``n_rseg`` as
    in ``cols_window``."""
    if not eta.is_cuda:
        return fullstep_bi_cols_reference(eta, p0, x0, x1, miss, plb=plb,
                                          project=project)
    p0_new = torch.empty_like(p0)
    cols_window(eta, p0, x0, x1, miss, (p0_new,), l_lo=0, l_hi=p0.shape[-1],
                plb=plb, project=project, k_true=k_true, n_rseg=n_rseg)
    return p0_new


def admixture_fullstep_biallelic(eta, p0, x0, x1, c, miss=None, kmask=None,
                                 *, k_true: int, lb: float, plb: float,
                                 project: bool, compute_t: bool = True,
                                 n_rseg: int = 0):
    """One biallelic admixture EM step for a chain batch:
    (eta' [B, I, Kp], t [B, I], p0' [B, Kp, L]).  The p0 clip and the eta
    Michelot share ``project`` (kernels.py:435, :452); ``kmask`` as in
    ``fullstep_bi_rows``, ``n_rseg`` as in ``cols_window``."""
    eta_new, t = fullstep_bi_rows(eta, p0, x0, x1, c, kmask, k_true=k_true,
                                  lb=lb, project=project,
                                  compute_t=compute_t)
    p0_new = fullstep_bi_cols(eta, p0, x0, x1, miss, plb=plb,
                              project=project, k_true=k_true, n_rseg=n_rseg)
    return eta_new, t, p0_new


# ---------------------------------------------------------------------------
# streamed and chunked steps (column segments and column windows)

# Thresholds set from times on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md
# section 6; route_times.py measures them and prints the lines named
# here, at K = 20 and chain batches 1 and 2).
# Rows pass ("rows pass: unsegmented ..., n segments + finish"): it keeps
# gaining from column segments until the grid holds about 20 blocks an SM
# (65536 x 16384 x 2 chains, 5 blocks an SM from its rows alone: 16.8 ms
# at 1 segment, 14.5 at 4; 8192 x 131072 x 2: 15.4 at 16 segments, 14.7 at
# 32), so the segmented pass splits L up to ROWS_BLOCKS_PER_SM blocks an
# SM, in segments of at least MIN_SEG_COLS columns (16384 x 2048: 8
# segments of 256 beat 4 and 16).  The fused kernel of the pair equals the
# one-segment pass within 1 % wherever both were timed and loses to more
# segments, so the pair is taken only where no split is wanted: a rows
# grid of PAIR_BLOCKS_PER_SM blocks an SM on its own, or a window too
# narrow for two segments.
# All of these were set at K = 20 (two blocks an SM); at Kp >= 64 a block
# fills an SM and fewer segments win ("route_times --k 100": one rows
# segment and 4 row segments of the columns pass at 16384 x 2048 x 2).
MIN_SEG_COLS = 256
PAIR_BLOCKS_PER_SM = 20
ROWS_BLOCKS_PER_SM = 20
# The wide rows pass (Kp > 128) holds one block an SM (its A launch's
# DMMA accumulators take the registers), so it splits L only until the
# grid (row blocks x lane chunks x chains) holds WIDE_ROWS_BLOCKS_PER_SM
# blocks an SM, and never into more segments than keep its partials [B,
# n, I, Kp] within SCRATCH_CAP.  Set for the fmaf rows pass ("route_times
# --k 200" and "--k 1024" at 16384 x 2048: one segment beat 2-32 at 1 and
# 2 chains); for the A launch, the one case where it splits there (K =
# 200, 1 chain: 256 blocks, two segments) times as one segment does
# ("route_times --kernels --k 200 --chains 1": 2.167-2.211 ms against
# 2.179-2.180 on an H100 at 700 W).
WIDE_ROWS_BLOCKS_PER_SM = 2
# Columns pass ("columns pass: router row segments, n row segments"): it
# splits I until its grid holds COLS_BLOCKS_PER_SM blocks an SM, in at
# most COLS_MAX_RSEG segments (16384 x 2048 x 1 chain: 0.32 ms at 64
# segments, 0.39 at 164; 8192 x 131072 x 2: 13.2 ms at 2, 14.0 at 16).
COLS_BLOCKS_PER_SM = 16
COLS_MAX_RSEG = 64
# The partials of one window stay under this many bytes whatever the card
# has free: they grow with B x Kp x L, and the chunked loop that bounds
# them costs up to 3 % of a step at the biobank shapes ("step chunked"
# against "step streamed").
SCRATCH_CAP = 192 << 20
# The wide columns pass's B launch holds one block an SM: a column
# sub-window whose grid would end in a wave filled below this share is
# narrowed to whole waves (at 16384 x 8192 lanes, 2 chains, K = 1024:
# 1024-lane sub-windows of 128 blocks, not 1408 of 176)
WAVE_FILL = 0.9
# grid y/z limit, and the widest L whose int column arithmetic cannot
# overflow in the kernels
GRID_YZ_MAX = 65535
L_MAX = 2 ** 31 - 2 ** 20
# the plain versions work in column windows of about this many bytes
REFERENCE_BYTES = 1 << 30


class Route(NamedTuple):
    """How one step runs: ``pair`` (``seg_cols`` 0), ``streamed`` or
    ``chunked``; ``window`` columns per window (L unless chunked) and
    ``seg_cols`` columns per rows-pass segment within a window;
    ``scratch_bytes`` the partials one window allocates for the chain
    batch (``window_scratch_bytes``); ``n_rseg`` the row segments of the
    columns pass, which every route hands to it."""

    name: str
    seg_cols: int
    window: int
    scratch_bytes: int
    n_rseg: int = 0

    def describe(self) -> str:
        return (f"{self.name} (window {self.window}, segment "
                f"{self.seg_cols or self.window} columns, "
                f"{self.n_rseg or 'auto'} row segments, scratch "
                f"{self.scratch_bytes} bytes)")


def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


def cols_sub_cols(B: int, I: int, W: int, chunks: int, n_sm: int, *,
                  bi: bool = True) -> int:
    """Columns a sub-window of the wide passes takes over a window of W
    columns: the d launch writes d [B, I, sub] float32 (and, ``bi``, the
    rows' eta sums [B, I]) to a scratch that the A and B launches read,
    and that scratch stays within SCRATCH_CAP.  All of W (rounded up to 4)
    when it fits, else W in balanced sub-windows of whole d tiles (WD_TILE
    columns; ROW_TL where not even one tile fits).  A sub-window whose B
    grid (its column tiles x B chains x ``chunks`` lane chunks; row
    segments fill a first wave) would end in a wave of the ``n_sm`` SMs it
    fills below WAVE_FILL is narrowed to whole waves.  Raises when not
    even ROW_TL columns fit."""
    per_col = 4 * B * I
    most = (SCRATCH_CAP - (per_col if bi else 0)) // per_col
    if most < ROW_TL:
        raise MemoryError(
            f"the wide columns pass's scratch for B={B} x I={I} rows takes "
            f"{per_col * ROW_TL} bytes for {ROW_TL} columns, over the cap "
            f"of {SCRATCH_CAP} bytes")
    step = WD_TILE if most >= WD_TILE else ROW_TL
    tc, per_tile = (WTC if bi else WTC_GENERIC), B * chunks
    blocks = -(-min(most, W) // tc) * per_tile
    waves = -(-blocks // n_sm)
    if blocks > n_sm and blocks < WAVE_FILL * waves * n_sm:
        most = min(most, max((waves - 1) * n_sm // per_tile * tc, step))
    if most >= _ceil_to(W, 4):
        return _ceil_to(W, 4)
    most = most // step * step
    n = -(-W // most)
    return _ceil_to(-(-W // n), step)


def cols_sub_windows(l_lo: int, l_hi: int, sub_cols: int):
    """The sub-windows [lo, hi) the wide columns pass runs on the window
    [l_lo, l_hi), as the launcher loops (csrc/wide.cuh, ``launch_wide``)."""
    return [(a, min(l_hi, a + sub_cols)) for a in range(l_lo, l_hi,
                                                         sub_cols)]


def cols_scratch_bytes(B: int, I: int, W: int, chunks: int, n_sm: int, *,
                       bi: bool = True) -> int:
    """Bytes of the wide passes' scratch over a window of W columns: d of
    one sub-window (``cols_sub_cols``), and the rows' eta sums (``bi``).
    The rows pass, the columns pass and a step that runs both on one d
    take the same."""
    sub = cols_sub_cols(B, I, W, chunks, n_sm, bi=bi)
    return 4 * B * I * (sub + (1 if bi else 0))


def wide_scratch(B: int, I: int, W: int, Kp: int, k_true: int, device, *,
                 bi: bool = True) -> Tuple[int, Tensor]:
    """(sub_cols, scratch) of the wide passes over a window of W columns
    on ``device``: the d plane of a sub-window [B, I, sub_cols] and, for
    the biallelic cells, the rows' eta sums [B, I], float32."""
    sub = cols_sub_cols(B, I, W, wide_chunks(kc_of(k_true, Kp)),
                        device_sm_count(device), bi=bi)
    return sub, torch.empty(B * I * (sub + (1 if bi else 0)),
                            dtype=torch.float32, device=device)


def rows_sub_segments(l_lo: int, l_hi: int, seg_cols: int, sub_cols: int):
    """The wide rows pass's plan over the window [l_lo, l_hi), as the
    launcher runs it (csrc/wide.cuh, ``launch_wide`` and
    ``wide_rows_a_kernel``): for each sub-window [s0, s1) of sub_cols
    columns, the column segments it meets as (segment, first column, end,
    add): the segment's columns in the sub-window, and whether they are
    added to partials an earlier sub-window wrote (the segment began
    before s0) rather than written."""
    plan = []
    for s0, s1 in cols_sub_windows(l_lo, l_hi, sub_cols):
        parts = []
        for seg in range((s0 - l_lo) // seg_cols,
                         (s1 - 1 - l_lo) // seg_cols + 1):
            start = l_lo + seg * seg_cols
            parts.append((seg, max(start, s0), min(start + seg_cols, s1),
                          start < s0))
        plan.append(((s0, s1), parts))
    return plan


def row_segments(B: int, I: int, W: int, n_sm: int, *,
                 per_sm: int = ROWS_BLOCKS_PER_SM, k_true: int = 0,
                 Kp: int = 32) -> Tuple[int, int]:
    """(segments, columns per segment) splitting a window of W columns for
    the segmented rows pass: one segment when the (chain, row block) grid
    alone fills the card (PAIR_BLOCKS_PER_SM a SM), else enough segments
    for ``per_sm`` blocks per SM when W allows, each segment >=
    MIN_SEG_COLS wide and a multiple of the tile.  The row block is that
    of ``k_true`` clusters padded to ``Kp``; a wide Kp splits as
    WIDE_ROWS_BLOCKS_PER_SM says, its blocks one a row block and lane
    chunk."""
    blocks = B * -(-I // rows_block(k_true, Kp))
    n = 1
    if is_wide(Kp):
        blocks *= wide_chunks(kc_of(k_true, Kp), WA_CHUNK)
        if blocks < WIDE_ROWS_BLOCKS_PER_SM * n_sm:
            n = max(1, min(-(-WIDE_ROWS_BLOCKS_PER_SM * n_sm // blocks),
                           W // MIN_SEG_COLS,
                           SCRATCH_CAP // (4 * B * I * (Kp + 1)),
                           GRID_YZ_MAX))
    elif blocks < PAIR_BLOCKS_PER_SM * n_sm:
        n = max(1, min(-(-per_sm * n_sm // blocks), W // MIN_SEG_COLS,
                       GRID_YZ_MAX))
    seg_cols = _ceil_to(-(-W // n), ROW_TL)
    return -(-W // seg_cols), seg_cols


def cols_row_segments(B: int, I: int, W: int, Kp: int, n_sm: int,
                      k_true: int = 0,
                      budget: Optional[int] = None) -> Tuple[int, int]:
    """(row segments, rows per segment) of the columns pass over a window
    of W columns: as many as fill the card at the tile of ``k_true``
    (``col_segments`` for COLS_BLOCKS_PER_SM blocks an SM; at a wide Kp,
    whose B launch holds one block an SM, as many as fill one wave with a
    sub-window's blocks, each segment at least 4 stages), but no more than
    COLS_MAX_RSEG, than keep the partials within ``budget`` bytes
    (SCRATCH_CAP when None) or below the bytes of x the pass reads, and at
    least one."""
    tc, ri = cols_tile(k_true, Kp)
    if is_wide(Kp):
        n_ch = wide_chunks(kc_of(k_true, Kp))
        sub = cols_sub_cols(B, I, W, n_ch, n_sm)
        n_want = min(n_sm // (-(-sub // tc) * B * n_ch), -(-I // (4 * ri)))
    else:
        n_want, _ = col_segments(I, W, B, n_sm, tc=tc, ri=ri,
                                 per_sm=COLS_BLOCKS_PER_SM)
    cap = SCRATCH_CAP if budget is None else budget
    n = max(1, min(n_want, COLS_MAX_RSEG, cap // (8 * B * Kp * W),
                   3 * I // (8 * Kp)))
    seg_rows = _ceil_to(-(-I // n), ri)
    return -(-I // seg_rows), seg_rows


def cols_partials_bytes(B: int, I: int, W: int, Kp: int, n_sm: int,
                        k_true: int = 0,
                        budget: Optional[int] = None) -> int:
    """Bytes of the columns pass's partials over a window of W columns,
    [B, row segments, 2, Kp, W] float32: they grow with B x Kp x W, and a
    narrower window is what bounds them (the row segments give way to the
    budget first)."""
    n_rseg, _ = cols_row_segments(B, I, W, Kp, n_sm, k_true, budget)
    return 4 * B * n_rseg * 2 * Kp * W


def window_scratch_bytes(B: int, I: int, W: int, Kp: int, n_sm: int,
                         n_cseg: int, k_true: int = 0,
                         budget: Optional[int] = None) -> int:
    """Bytes of scratch one window of W columns allocates: the columns
    pass's partials, the segmented rows pass's [B, n_cseg, I, Kp + 1]
    (none for the pair, n_cseg = 0) and, at a wide Kp, the d scratch that
    both passes read (``cols_scratch_bytes``, within SCRATCH_CAP by its
    own sub-windows; a step's window holds all three at once).  The rows pass's need no bound: it splits L only while B
    x I is small, so they stay near ROWS_BLOCKS_PER_SM blocks an SM x a
    block's rows x Kp, or are as large as eta itself (one segment)."""
    return (cols_partials_bytes(B, I, W, Kp, n_sm, k_true, budget)
            + 4 * B * n_cseg * I * (Kp + 1)
            + (cols_scratch_bytes(B, I, W, wide_chunks(kc_of(k_true, Kp)),
                                  n_sm) if is_wide(Kp) else 0))


def pick_route(B: int, I: int, L: int, Kp: int, n_sm: int,
               budget: int, k_true: int = 0) -> Route:
    """The route of a step for a chain batch of B on an I x L panel: the
    pair when its rows grid fills the SMs, the streamed step when it does
    not, the chunked loop when the columns pass's partials over all L
    would take more than ``budget`` bytes even in one row segment.  A wide
    Kp (> 128) never takes the pair: its streamed step runs one rows
    segment where the pair would run.  ``k_true`` (0: Kp) sets the
    kernels' tiles.  Raises when no window fits or an index would
    overflow."""
    check_kp(Kp)
    if L > L_MAX or B > GRID_YZ_MAX:
        raise ValueError(f"L={L} or B={B} beyond the kernels' index range "
                         f"(L <= {L_MAX}, B <= {GRID_YZ_MAX})")

    def route(name: str, W: int) -> Route:
        n_cseg, seg_cols = row_segments(B, I, W, n_sm, k_true=k_true, Kp=Kp)
        if name == "streamed" and n_cseg == 1 and not is_wide(Kp):
            name, n_cseg, seg_cols = "pair", 0, 0
        n_rseg, _ = cols_row_segments(B, I, W, Kp, n_sm, k_true, budget)
        return Route(name, seg_cols, W, window_scratch_bytes(
            B, I, W, Kp, n_sm, n_cseg, k_true, budget), n_rseg)

    if cols_partials_bytes(B, I, L, Kp, n_sm, k_true, budget) <= budget:
        return route("streamed", L)
    n_win = 2
    while True:
        W = _ceil_to(-(-L // n_win), ROW_TL)
        need = cols_partials_bytes(B, I, W, Kp, n_sm, k_true, budget)
        if need <= budget:
            return route("chunked", W)
        if W <= MIN_SEG_COLS:
            raise MemoryError(
                f"no window of the chunked step fits: {need} bytes of "
                f"partials for {W} columns (B={B}, I={I}, Kp={Kp}) against "
                f"a budget of {budget} bytes")
        n_win *= 2


def device_sm_count(device) -> int:
    """SMs of a CUDA device; an H100's count for the CPU, where the router
    only has to be consistent."""
    device = torch.device(device)
    if device.type != "cuda":
        return 132
    return torch.cuda.get_device_properties(device).multi_processor_count


def scratch_budget(device) -> int:
    """Bytes the columns pass's partials of one step may take on
    ``device``: an eighth of what is free, at most SCRATCH_CAP."""
    device = torch.device(device)
    if device.type != "cuda":
        return SCRATCH_CAP
    build.count("host.mem_queries")
    free, _ = torch.cuda.mem_get_info(device)
    return min(SCRATCH_CAP, free // 8)


def lanes_valid(Kp: int, k_true: int, kmask: Optional[Tensor], device,
                 ndim: int = 1):
    """The lanes a Michelot keeps, shaped for a chain batch of ``ndim``
    dims whose last is the cluster axis: those below ``k_true``, or each
    chain's row of ``kmask``."""
    if kmask is not None:
        return kmask_lanes(kmask.to(device), ndim)
    return torch.arange(Kp, device=device) < k_true


def window_stats_reference(eta: Tensor, p0: Tensor, x0: Tensor, x1: Tensor,
                           miss: Optional[Tensor], lo: int, hi: int, *,
                           compute_t: bool = True, want_a: bool = True,
                           want_b: bool = True):
    """Plain statistics of the columns [lo, hi): raw A + r [B, I, Kp], t
    [B, I] float64, and B0/B1 [B, Kp, hi - lo] with the miss fold.  Works
    in sub-windows of about REFERENCE_BYTES of temporaries, so it fits on
    a card beside a panel of any width."""
    dtype = eta.dtype
    B, I, Kp = eta.shape
    itemsize = torch.finfo(dtype).bits // 8
    sub = max(ROW_TL, REFERENCE_BYTES // (8 * B * I * itemsize))
    araw = eta.new_zeros((B, I, Kp)) if want_a else None
    t = torch.zeros((B, I), dtype=torch.float64, device=eta.device)
    b0 = eta.new_empty((B, Kp, hi - lo)) if want_b else None
    b1 = torch.empty_like(b0) if want_b else None
    s = eta.sum(dim=-1, keepdim=True)
    et = eta.transpose(-1, -2)
    for a in range(lo, hi, sub):
        e = min(hi, a + sub)
        pw = p0[..., a:e]
        d0 = eta @ pw
        d1 = torch.clamp(s - d0, min=D_MIN)
        d0 = torch.clamp(d0, min=D_MIN)
        x0f, x1f = x0[:, a:e].to(dtype), x1[:, a:e].to(dtype)
        if compute_t:
            t += (x0f * torch.log(d0) + x1f * torch.log(d1)).sum(
                dim=-1).to(torch.float64)
        w0, w1 = x0f / d0, x1f / d1
        if want_a:
            araw += ((w0 - w1) @ pw.transpose(-1, -2)
                     + w1.sum(dim=-1, keepdim=True))
        if want_b:
            if miss is not None:
                m = miss[:, a:e].to(dtype)
                w0, w1 = w0 + m, w1 + m
            b0[..., a - lo:e - lo] = et @ w0
            b1[..., a - lo:e - lo] = et @ w1
    return araw, t, b0, b1


def finish_eta_reference(eta: Tensor, araw: Tensor, c: Tensor, *,
                         k_true: int, lb: float, project_eta: bool,
                         kmask: Optional[Tensor] = None) -> Tensor:
    """eta' from the raw A + r: add c, normalize (zero-mass rows keep
    their eta), Michelot over the static or the runtime lane set."""
    num = eta * (araw + c.to(eta.dtype)[:, None])
    tot = num.sum(dim=-1, keepdim=True)
    ok = tot > 0
    eta_new = torch.where(ok, num / torch.where(ok, tot, torch.ones_like(tot)),
                          eta)
    if project_eta:
        eta_new = project_rows(
            eta_new, lanes_valid(eta.shape[-1], k_true, kmask, eta.device,
                                  eta.dim()), lb)
    return eta_new


def p0_update_reference(p0: Tensor, b0: Tensor, b1: Tensor, *, plb: float,
                        project: bool) -> Tensor:
    """p0' = clip(p0 B0 / (p0 B0 + (1 - p0) B1)) from raw B0/B1."""
    pc0 = p0 * b0
    pc1 = (1.0 - p0) * b1
    tot = pc0 + pc1
    ok = tot > 0
    zero = torch.zeros((), dtype=p0.dtype, device=p0.device)
    q0 = torch.where(ok, pc0 / torch.where(ok, tot, torch.ones_like(tot)),
                     zero)
    if project:
        lo, hi = p0_clip_bounds(plb, p0.dtype)
        q0 = torch.where(ok, torch.clamp(q0, lo, hi), zero)
    return q0


def _check_window(L: int, l_lo: int, l_hi: int, B: int) -> None:
    if not 0 <= l_lo < l_hi <= L or L > L_MAX or B > GRID_YZ_MAX:
        raise ValueError(f"window [{l_lo}, {l_hi}) of L={L} (B={B}) is "
                         f"outside the kernels' range")


def rows_partials_reference(eta, p0, x0, x1, *, l_lo: int, l_hi: int,
                            compute_t: bool = True, compute_a: bool = True):
    """Plain version of ``rows_partials``: one segment, its t in
    float64."""
    araw, t, _, _ = window_stats_reference(
        eta, p0, x0, x1, None, l_lo, l_hi, compute_t=compute_t,
        want_a=compute_a, want_b=False)
    return (araw[:, None] if compute_a else None), t[:, None]


def rows_partials(eta, p0, x0, x1, *, l_lo: int, l_hi: int, seg_cols: int,
                  compute_t: bool = True, compute_a: bool = True,
                  loop: Optional[str] = None, k_true: int = 0):
    """Segmented rows pass over the window [l_lo, l_hi): the segments' raw
    A + r partials [B, n_seg, I, Kp] (None without ``compute_a``) and t
    partials [B, n_seg, I].  ``k_true`` (0: all Kp lanes) is where the
    kernel's cluster loops stop.  At a wide Kp the pass is a d launch and
    an A launch a column sub-window (``wide_scratch``)."""
    if not eta.is_cuda:
        return rows_partials_reference(
            eta, p0, x0, x1, l_lo=l_lo, l_hi=l_hi, compute_t=compute_t,
            compute_a=compute_a)
    B, I, L, Kp = _check_cuda_inputs(eta, p0, x0, x1)
    _check_window(L, l_lo, l_hi, B)
    n_seg = -(-(l_hi - l_lo) // max(seg_cols, 1))
    if seg_cols <= 0 or n_seg > GRID_YZ_MAX:
        raise ValueError(f"{n_seg} segments of {seg_cols} columns exceed "
                         f"the grid's limit")
    dev = eta.device
    apart = (torch.empty((B, n_seg, I, Kp), dtype=torch.float32, device=dev)
             if compute_a else None)
    tpart = torch.empty((B, n_seg, I), dtype=torch.float32, device=dev)
    sub, scratch = (wide_scratch(B, I, l_hi - l_lo, Kp, k_true, dev)
                    if is_wide(Kp) else (0, None))
    build.launch("mc_fullstep_bi_rows_seg", dev,
                 eta.data_ptr(), p0.data_ptr(), x0.data_ptr(),
                 x1.data_ptr(), build.ptr(apart), tpart.data_ptr(),
                 B, I, L, Kp, int(k_true), l_lo, l_hi, seg_cols, n_seg,
                 int(compute_t), int(compute_a), build.ptr(scratch), sub,
                 also=(() if loop is None else (loop,))
                 + (("wide_rows",) if is_wide(Kp) else ()))
    return apart, tpart


def window_partials_reference(eta, p0, x0, x1, miss=None, *, l_lo: int,
                              l_hi: int, compute_t: bool = True):
    """Plain version of ``window_partials``: one segment of each."""
    araw, t, b0, b1 = window_stats_reference(eta, p0, x0, x1, miss, l_lo,
                                             l_hi, compute_t=compute_t)
    return araw[:, None], t[:, None], torch.stack((b0, b1), dim=1)[:, None]


def window_partials(eta, p0, x0, x1, miss=None, *, l_lo: int, l_hi: int,
                    seg_cols: int, k_true: int, n_rseg: int = 0,
                    compute_t: bool = True, loop: Optional[str] = None):
    """Both passes of a step over the window [l_lo, l_hi) at a wide Kp on
    one d a column sub-window (d launch, A launch, B launch): the rows
    pass's partials (raw A + r [B, n_cseg, I, Kp] over segments of
    ``seg_cols`` columns, t [B, n_cseg, I]) and the columns pass's [B,
    n_rseg, 2, Kp, l_hi - l_lo] (B0/B1 with the miss fold; ``n_rseg`` as
    in ``cols_window``).  ``rows_finish`` and ``p0_epilogue`` finish them;
    the partials are those of ``rows_partials`` and ``cols_partials``, bit
    for bit."""
    if not eta.is_cuda:
        return window_partials_reference(eta, p0, x0, x1, miss, l_lo=l_lo,
                                         l_hi=l_hi, compute_t=compute_t)
    extra = ()
    if miss is not None:
        extra = (("miss", miss, torch.int8, tuple(x0.shape)),)
    B, I, L, Kp = _check_cuda_inputs(eta, p0, x0, x1, *extra)
    _check_window(L, l_lo, l_hi, B)
    if not is_wide(Kp):
        raise ValueError(f"Kp={Kp}: one d for both passes is the wide "
                         f"kernels' (Kp > {KP_NARROW[-1]})")
    W = l_hi - l_lo
    n_cseg = -(-W // max(seg_cols, 1))
    n_seg, seg_rows = _cols_row_plan(B, I, W, Kp, k_true, n_rseg, eta.device)
    if seg_cols <= 0 or max(n_cseg, n_seg) > GRID_YZ_MAX:
        raise ValueError(f"{n_cseg} column segments of {seg_cols} columns "
                         f"or {n_seg} row segments exceed the grid's limit")
    dev = eta.device
    apart = torch.empty((B, n_cseg, I, Kp), dtype=torch.float32, device=dev)
    tpart = torch.empty((B, n_cseg, I), dtype=torch.float32, device=dev)
    part = torch.empty((B, n_seg, 2, Kp, W), dtype=torch.float32,
                       device=dev)
    sub, scratch = wide_scratch(B, I, W, Kp, k_true, dev)
    build.launch("mc_fullstep_bi_window", dev,
                 eta.data_ptr(), p0.data_ptr(), x0.data_ptr(),
                 x1.data_ptr(), build.ptr(miss), apart.data_ptr(),
                 tpart.data_ptr(), part.data_ptr(), scratch.data_ptr(),
                 B, I, L, Kp, int(k_true), l_lo, l_hi, seg_cols, n_cseg,
                 int(compute_t), n_seg, seg_rows, sub,
                 also=(() if loop is None else (loop,))
                 + ("wide_rows", "wide_cols_bi"))
    return apart, tpart, part


def rows_finish_reference(eta, apart, tpart, c, a0=None, kmask=None, *,
                          k_true: int, lb: float, project_eta: bool,
                          compute_t: bool = True, emit_a: bool = False):
    """Plain version of ``rows_finish``."""
    t = tpart.to(torch.float64).sum(dim=1) if compute_t else torch.zeros(
        eta.shape[:2], dtype=torch.float64, device=eta.device)
    if apart is None:
        return None, t
    araw = apart.sum(dim=1) if a0 is None else a0 + apart.sum(dim=1)
    if emit_a:
        return araw, t
    return finish_eta_reference(eta, araw, c, k_true=k_true, lb=lb,
                                project_eta=project_eta, kmask=kmask), t


def rows_finish(eta, apart, tpart, c, a0=None, kmask=None, *, k_true: int,
                lb: float, project_eta: bool, compute_t: bool = True,
                emit_a: bool = False):
    """Finish of the segmented rows pass: the partials summed in segment
    order (t in float64) on top of the ``a0`` seed, then the raw A + r
    (``emit_a``) or eta' with c added, normalized and projected over the
    static ``k_true`` lanes or the runtime ``kmask``.  Returns (eta' or
    raw A + r, or None when ``apart`` is None; t [B, I] float64).
    ``kmask`` is [Kp] (every chain) or [B, Kp] (a row a chain).  The
    kernel reads the lanes of ``apart`` below the lane tile of ``k_true``
    and, for ``emit_a``, the first lane past it as the value of every pad
    lane: the rows passes write one value a row there (the row's sum of
    w1, or 0)."""
    if not eta.is_cuda:
        return rows_finish_reference(
            eta, apart, tpart, c, a0, kmask, k_true=k_true, lb=lb,
            project_eta=project_eta, compute_t=compute_t, emit_a=emit_a)
    B, I, Kp = eta.shape
    check_kp(Kp)
    n_seg = tpart.shape[1]
    checks = [("eta", eta, torch.float32, (B, I, Kp)),
              ("tpart", tpart, torch.float32, (B, n_seg, I)),
              ("c", c, torch.float32, (I,))]
    if apart is not None:
        checks.append(("apart", apart, torch.float32, (B, n_seg, I, Kp)))
    if a0 is not None:
        checks.append(("a0", a0, torch.float32, (B, I, Kp)))
    for name, t, dt, shape in checks:
        if (t.device != eta.device or t.dtype != dt
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name}: contiguous {dt} {shape} on "
                             f"{eta.device} expected, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    for name, t in (("apart", apart), ("eta", eta), ("a0", a0)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must start at a multiple of 16 bytes "
                             f"(the finish stages it by 16-byte copies)")
    km, km_stride = kmask_arg(kmask, B, Kp, eta.device)
    out = torch.empty_like(eta) if apart is not None else None
    t = torch.empty((B, I), dtype=torch.float64, device=eta.device)
    build.launch("mc_fullstep_bi_finish", eta.device,
                 eta.data_ptr(), build.ptr(apart), tpart.data_ptr(),
                 build.ptr(a0), c.data_ptr(), km, build.ptr(out),
                 t.data_ptr(), B, I, Kp, n_seg, int(k_true), float(lb),
                 int(emit_a), int(project_eta), int(compute_t), km_stride,
                 also=finish_counts(Kp, out is not None,
                                    km is not None and project_eta
                                    and not emit_a))
    return out, t


def finish_counts(Kp: int, eta_out: bool, masked: bool) -> Tuple[str, ...]:
    """The names besides its launcher's that a rows finish launch counts
    under: the wide finish above 128 lanes, and its masked instance
    where a kmask projects eta (the t-only finish, ``eta_out`` false,
    takes neither)."""
    if not eta_out:
        return ()
    wide = is_wide(Kp)
    return ((("wide_finish",) if wide else ())
            + ((("masked_wide_finish" if wide else "masked_rows_finish"),)
               if masked else ()))


def _rows_window(eta, p0, x0, x1, c, a0, kmask, *, l_lo: int, l_hi: int,
                 seg_cols: int, k_true: int, lb: float, project_eta: bool,
                 compute_t: bool, emit_a: bool, compute_a: bool = True,
                 loop: Optional[str] = None):
    """Segmented rows pass and its finish over the window [l_lo, l_hi)."""
    apart, tpart = rows_partials(eta, p0, x0, x1, l_lo=l_lo, l_hi=l_hi,
                                 seg_cols=seg_cols, compute_t=compute_t,
                                 compute_a=compute_a, loop=loop,
                                 k_true=k_true)
    return rows_finish(eta, apart, tpart, c, a0, kmask, k_true=k_true,
                       lb=lb, project_eta=project_eta, compute_t=compute_t,
                       emit_a=emit_a)


def cols_window_reference(eta, p0, x0, x1, miss, outs, *, l_lo: int,
                          l_hi: int, plb: float, project: bool) -> None:
    """Plain version of ``cols_window``."""
    _, _, b0, b1 = window_stats_reference(
        eta, p0, x0, x1, miss, l_lo, l_hi, compute_t=False, want_a=False)
    if len(outs) == 2:
        outs[0][..., l_lo:l_hi] = b0
        outs[1][..., l_lo:l_hi] = b1
    else:
        outs[0][..., l_lo:l_hi] = p0_update_reference(
            p0[..., l_lo:l_hi], b0, b1, plb=plb, project=project)


def cols_window(eta, p0, x0, x1, miss, outs, *, l_lo: int, l_hi: int,
                plb: float, project: bool, k_true: int = 0,
                n_rseg: int = 0) -> None:
    """Columns pass and epilogue over the window [l_lo, l_hi), written at
    the window's columns of the full-width ``outs``: (p0',) or, for emit_b,
    (B0, B1) with the miss fold.  ``k_true`` (0: all Kp lanes) is where
    the kernel's cluster loops stop.  ``n_rseg`` row segments: a routed
    step passes its route's, chosen within the fit's scratch budget; 0,
    for a caller without a route, takes ``cols_row_segments`` within
    SCRATCH_CAP."""
    if not eta.is_cuda:
        return cols_window_reference(eta, p0, x0, x1, miss, outs, l_lo=l_lo,
                                     l_hi=l_hi, plb=plb, project=project)
    _cols_launch(eta, p0, x0, x1, miss, outs, l_lo=l_lo, l_hi=l_hi,
                 plb=plb, project=project, k_true=k_true, n_rseg=n_rseg)


def cols_partials(eta, p0, x0, x1, miss=None, *, l_lo: int, l_hi: int,
                  k_true: int = 0, n_rseg: int = 0) -> Tensor:
    """The columns pass alone over the window [l_lo, l_hi): its raw
    partials [B, n_seg, 2, Kp, l_hi - l_lo] of B0/B1 (with the miss fold)
    a row segment, the lanes past the kernels' kc zero (``cols_window``
    runs the p0 epilogue on them; ``k_true`` and ``n_rseg`` as there).
    The plain version returns one segment."""
    if not eta.is_cuda:
        _, _, b0, b1 = window_stats_reference(
            eta, p0, x0, x1, miss, l_lo, l_hi, compute_t=False,
            want_a=False)
        return torch.stack((b0, b1), dim=1)[:, None]
    return _cols_launch(eta, p0, x0, x1, miss, (), l_lo=l_lo, l_hi=l_hi,
                        plb=0.0, project=False, k_true=k_true, n_rseg=n_rseg)


def _cols_row_plan(B: int, I: int, W: int, Kp: int, k_true: int,
                   n_rseg: int, device) -> Tuple[int, int]:
    """(row segments, rows per segment) of the columns pass over a window
    of W columns: ``n_rseg`` segments of whole stages (a routed step's),
    or ``cols_row_segments`` within SCRATCH_CAP when it is 0."""
    if n_rseg:
        seg_rows = _ceil_to(-(-I // n_rseg), cols_tile(k_true, Kp)[1])
        return -(-I // seg_rows), seg_rows
    return cols_row_segments(B, I, W, Kp, device_sm_count(device), k_true)


def _cols_launch(eta, p0, x0, x1, miss, outs, *, l_lo: int, l_hi: int,
                 plb: float, project: bool, k_true: int,
                 n_rseg: int) -> Tensor:
    """Launch the columns pass over [l_lo, l_hi) with its epilogue into
    ``outs`` ((p0',), (B0, B1), or () for the pass alone); returns the
    partials."""
    emit_b = len(outs) == 2
    extra = ()
    if miss is not None:
        extra = (("miss", miss, torch.int8, tuple(x0.shape)),)
    B, I, L, Kp = _check_cuda_inputs(eta, p0, x0, x1, *extra)
    _check_window(L, l_lo, l_hi, B)
    W = l_hi - l_lo
    lo, hi = p0_clip_bounds(plb)
    n_seg, seg_rows = _cols_row_plan(B, I, W, Kp, k_true, n_rseg, eta.device)
    if n_seg > GRID_YZ_MAX:
        raise ValueError(f"{n_seg} row segments exceed the grid's limit")
    part = torch.empty((B, n_seg, 2, Kp, W), dtype=torch.float32,
                       device=eta.device)
    sub, scratch = (wide_scratch(B, I, W, Kp, k_true, eta.device)
                    if is_wide(Kp) else (0, None))
    build.launch("mc_fullstep_bi_cols", eta.device,
                 eta.data_ptr(), p0.data_ptr(), x0.data_ptr(),
                 x1.data_ptr(), build.ptr(miss), part.data_ptr(),
                 outs[0].data_ptr() if len(outs) == 1 else None,
                 outs[0].data_ptr() if emit_b else None,
                 outs[1].data_ptr() if emit_b else None,
                 B, I, L, Kp, int(k_true), l_lo, l_hi, n_seg, seg_rows, lo,
                 hi, int(project), build.ptr(scratch), sub,
                 also=("wide_cols_bi",) if is_wide(Kp) else ())
    return part


# ---------------------------------------------------------------------------
# the segment reductions: the rows finish and the p0 epilogue

def ordered_segment_sum(parts: Tensor, seed: Optional[Tensor] = None, *,
                        dtype: Optional[torch.dtype] = None) -> Tensor:
    """``parts`` [B, n_seg, ...] summed over the segment axis one segment
    after another, on top of ``seed`` (zeros when None), in ``dtype``
    (that of ``parts`` when None): the order of the finish's and the p0
    epilogue's sums (A and B0/B1 in float32, t in float64), so that their
    raw outputs are bit-equal to this."""
    dtype = parts.dtype if dtype is None else dtype
    if seed is None:
        acc = torch.zeros(parts.shape[:1] + parts.shape[2:], dtype=dtype,
                          device=parts.device)
    else:
        acc = seed.to(dtype)
    for s in range(parts.shape[1]):
        acc = acc + parts[:, s].to(dtype)
    return acc


def p0_epilogue_reference(p0, part, outs, *, l_lo: int, l_hi: int,
                          k_true: int, plb: float, project: bool) -> None:
    """Plain version of ``p0_epilogue``."""
    kc = kc_of(k_true, p0.shape[1])
    b0, b1 = (ordered_segment_sum(part[:, :, a]) for a in (0, 1))
    b0[:, kc:] = 0.0
    b1[:, kc:] = 0.0
    if len(outs) == 2:
        outs[0][..., l_lo:l_hi] = b0
        outs[1][..., l_lo:l_hi] = b1
    else:
        outs[0][..., l_lo:l_hi] = p0_update_reference(
            p0[..., l_lo:l_hi], b0, b1, plb=plb, project=project)


def p0_epilogue(p0, part, outs, *, l_lo: int, l_hi: int, k_true: int,
                plb: float, project: bool) -> None:
    """The columns pass's epilogue alone (``cols_window`` runs it after
    the pass): the partials ``part`` [B, n_seg, 2, Kp, l_hi - l_lo], of
    which the lanes below the lane tile of ``k_true`` are read and the
    rest count as zeros, summed in segment order, written at the window's
    columns of the full-width ``outs``: (p0',) or, for emit_b, (B0, B1)."""
    if not p0.is_cuda:
        return p0_epilogue_reference(p0, part, outs, l_lo=l_lo, l_hi=l_hi,
                                     k_true=k_true, plb=plb, project=project)
    B, Kp, L = p0.shape
    check_kp(Kp)
    _check_window(L, l_lo, l_hi, B)
    n_seg = part.shape[1] if part.dim() == 5 else 0
    checks = [("p0", p0, (B, Kp, L)),
              ("part", part, (B, max(n_seg, 1), 2, Kp, l_hi - l_lo))]
    checks += [(f"outs[{i}]", o, (B, Kp, L)) for i, o in enumerate(outs)]
    for name, t, shape in checks:
        if (t.device != p0.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name}: contiguous float32 {shape} on "
                             f"{p0.device} expected, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    emit_b = len(outs) == 2
    lo, hi = p0_clip_bounds(plb)
    build.launch("mc_fullstep_bi_p0", p0.device, p0.data_ptr(),
                 part.data_ptr(), None if emit_b else outs[0].data_ptr(),
                 outs[0].data_ptr() if emit_b else None,
                 outs[1].data_ptr() if emit_b else None,
                 B, L, Kp, int(k_true), l_lo, l_hi, n_seg, lo, hi,
                 int(project))


def admixture_fullstep_biallelic_chunked(eta, p0, x0, x1, c, miss=None,
                                         kmask=None, *, window: int,
                                         seg_cols: Optional[int] = None,
                                         k_true: int, lb: float, plb: float,
                                         project: bool,
                                         compute_t: bool = True,
                                         emit_b: bool = False,
                                         emit_a: bool = False,
                                         project_eta: Optional[bool] = None,
                                         a0: Optional[Tensor] = None,
                                         n_rseg: int = 0):
    """The step as a loop over column windows of ``window`` columns (the
    last may be short), the contract of the JAX package's
    ``admixture_fullstep_biallelic_chunked``: raw A + r is threaded from
    window to window through a0/emit_a, t is summed, c is added and eta
    finished on the last window, and p0' (or raw B0/B1) is complete per
    window.  Every window reads the full-width arrays at its columns.

    Returns (eta', t [B, I] float64, p0'); under ``emit_b`` (eta', t, B0,
    B1) with the miss fold in B0/B1; under ``emit_a`` the first output is
    the raw A + r (c not added).  ``kmask`` (1.0/0.0, [Kp] or [B, Kp] a
    row a chain) replaces the static ``k_true`` lane set of the eta
    Michelot; ``project_eta`` switches the eta Michelot
    apart from the p0 clip, which stays governed by ``project``; ``a0``
    seeds the first window; ``n_rseg`` fixes the columns pass's row
    segments (0: chosen to fill the card).  One window over all L is the
    streamed step.  At a wide Kp a window runs both passes on one d
    (``window_partials``), then the finish and the p0 epilogue."""
    B, I, Kp = eta.shape
    L = p0.shape[-1]
    window = min(int(window), L)
    if seg_cols is None:
        _, seg_cols = row_segments(B, I, window,
                                   device_sm_count(eta.device),
                                   k_true=k_true, Kp=Kp)
    if project_eta is None:
        project_eta = project
    outs = ((torch.empty_like(p0), torch.empty_like(p0)) if emit_b
            else (torch.empty_like(p0),))
    loop = "fullstep_bi_chunked" if window < L else None
    t_sum = None
    for l_lo in range(0, L, window):
        l_hi = min(L, l_lo + window)
        last = l_hi == L
        if is_wide(Kp):
            apart, tpart, part = window_partials(
                eta, p0, x0, x1, miss, l_lo=l_lo, l_hi=l_hi,
                seg_cols=min(seg_cols, l_hi - l_lo), k_true=k_true,
                n_rseg=n_rseg, compute_t=compute_t, loop=loop)
            a0, t = rows_finish(eta, apart, tpart, c, a0, kmask,
                                k_true=k_true, lb=lb,
                                project_eta=project_eta,
                                compute_t=compute_t,
                                emit_a=emit_a or not last)
            del apart, tpart
            t_sum = t if t_sum is None else t_sum + t
            p0_epilogue(p0, part, outs, l_lo=l_lo, l_hi=l_hi,
                        k_true=k_true, plb=plb, project=project)
            del part
            continue
        a0, t = _rows_window(
            eta, p0, x0, x1, c, a0, kmask, l_lo=l_lo, l_hi=l_hi,
            seg_cols=min(seg_cols, l_hi - l_lo), k_true=k_true, lb=lb,
            project_eta=project_eta, compute_t=compute_t,
            emit_a=emit_a or not last, loop=loop)
        t_sum = t if t_sum is None else t_sum + t
        cols_window(eta, p0, x0, x1, miss, outs, l_lo=l_lo, l_hi=l_hi,
                    plb=plb, project=project, k_true=k_true, n_rseg=n_rseg)
    return (a0, t_sum) + outs


def admixture_fullstep_biallelic_streamed(eta, p0, x0, x1, c, miss=None,
                                          kmask=None, *,
                                          seg_cols: Optional[int] = None,
                                          **kw):
    """The step with the rows pass split into column segments of
    ``seg_cols`` (chosen to fill the card when None), the counterpart of
    the JAX package's ``admixture_fullstep_biallelic_streamed``; arguments
    and returns as ``admixture_fullstep_biallelic_chunked``."""
    return admixture_fullstep_biallelic_chunked(
        eta, p0, x0, x1, c, miss, kmask, window=p0.shape[-1],
        seg_cols=seg_cols, **kw)


def admixture_fullstep_biallelic_chunked_reference(eta, p0, x0, x1, c,
                                                   miss=None, kmask=None, *,
                                                   window: int, k_true: int,
                                                   lb: float, plb: float,
                                                   project: bool,
                                                   compute_t: bool = True,
                                                   emit_b: bool = False,
                                                   emit_a: bool = False,
                                                   project_eta=None,
                                                   a0=None, seg_cols=None):
    """Plain PyTorch version of the chunked step (any device), in column
    windows: same arguments and returns; ``seg_cols`` is accepted and has
    no meaning here."""
    L = p0.shape[-1]
    window = min(int(window), L)
    if project_eta is None:
        project_eta = project
    araw = None if a0 is None else a0.clone()
    t_sum = None
    outs = ((torch.empty_like(p0), torch.empty_like(p0)) if emit_b
            else (torch.empty_like(p0),))
    for l_lo in range(0, L, window):
        l_hi = min(L, l_lo + window)
        a_w, t, b0, b1 = window_stats_reference(
            eta, p0, x0, x1, miss, l_lo, l_hi, compute_t=compute_t)
        araw = a_w if araw is None else araw + a_w
        t_sum = t if t_sum is None else t_sum + t
        if emit_b:
            outs[0][..., l_lo:l_hi] = b0
            outs[1][..., l_lo:l_hi] = b1
        else:
            outs[0][..., l_lo:l_hi] = p0_update_reference(
                p0[..., l_lo:l_hi], b0, b1, plb=plb, project=project)
    first = araw if emit_a else finish_eta_reference(
        eta, araw, c, k_true=k_true, lb=lb, project_eta=project_eta,
        kmask=kmask)
    return (first, t_sum) + outs


def admixture_fullstep_biallelic_streamed_reference(eta, p0, x0, x1, c,
                                                    miss=None, kmask=None,
                                                    **kw):
    """Plain PyTorch version of the streamed step (any device)."""
    return admixture_fullstep_biallelic_chunked_reference(
        eta, p0, x0, x1, c, miss, kmask, window=p0.shape[-1], **kw)


def rows_log_likelihood_terms(eta, p0, x0, x1, *, seg_cols=None,
                              k_true: int = 0) -> Tensor:
    """t [B, I] float64, the per-individual logL terms of (eta, p0), from
    the segmented rows pass with its A phase skipped: no [B, I, L]
    temporary exists (CUDA), or one column window of it (CPU).  ``k_true``
    (0: all Kp lanes) is where the kernel's cluster loops stop."""
    B, I, Kp = eta.shape
    L = p0.shape[-1]
    if seg_cols is None:
        _, seg_cols = row_segments(B, I, L, device_sm_count(eta.device),
                                   k_true=k_true, Kp=Kp)
    c = eta.new_zeros(I)
    return _rows_window(eta, p0, x0, x1, c, None, None, l_lo=0, l_hi=L,
                        seg_cols=seg_cols, k_true=k_true, lb=0.0,
                        project_eta=False, compute_t=True, emit_a=True,
                        compute_a=False)[1]


def admixture_fullstep_biallelic_routed(eta, p0, x0, x1, c, miss=None,
                                        kmask=None, *, route: Route,
                                        k_true: int, lb: float, plb: float,
                                        project: bool,
                                        compute_t: bool = True):
    """One step by ``route`` (pick_route): (eta', t, p0'); ``kmask`` as
    in ``fullstep_bi_rows``."""
    if route.name == "pair":
        return admixture_fullstep_biallelic(
            eta, p0, x0, x1, c, miss, kmask, k_true=k_true, lb=lb, plb=plb,
            project=project, compute_t=compute_t, n_rseg=route.n_rseg)
    if route.name not in ("streamed", "chunked"):
        raise ValueError(f"unknown route {route.name!r}")
    return admixture_fullstep_biallelic_chunked(
        eta, p0, x0, x1, c, miss, kmask, window=route.window,
        seg_cols=route.seg_cols, k_true=k_true, lb=lb, plb=plb,
        project=project, compute_t=compute_t, n_rseg=route.n_rseg)
