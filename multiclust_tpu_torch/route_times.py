"""Times of the biallelic admixture step's three routes on one GPU, the
measurements behind the router's thresholds (ops/fullstep_bi.pick_route).

Run with ``python -m multiclust_tpu_torch.route_times`` (a CUDA device is
required).  For each of the four shapes 16384 x 2048, 65536 x 16384,
8192 x 131072 and 2048 x 524288 (K = 20, 1 % missing, chain batches 1 and
2; the last three are 2^30 cells, 1 GiB an int8 plane) it prints what the
router picks (route, window, column segment, row segments, the kernels'
tiles) and the median CUDA-event time of the routed step, of the pair, of
the streamed step at 2-32 column segments, of the chunked loop at 2-8
windows, of each rows pass and of the columns pass alone at several segment
counts, of the logL terms alone and of the windowed plain version, every
step held to the plain version first (rtol 1e-4, atol 5e-5).  Each pass's
line carries its bound (the larger of its tensors over 3.35 TB/s and its
operations over 67 TFLOP/s, the counts chip_smoke.py uses) and the share
of it that the best time reaches.  The first line is the card's name and
power limit.

``--k K`` times another cluster count (padded to a multiple of 32 lanes,
at most 1024) and ``--shapes IxL,IxL`` other panels, for the kernels' wider
instantiations: ``--k 100 --shapes 16384x2048,8192x131072``.  Above 128
lanes the wide kernels (csrc/wide.cuh) run, and the pair, which has no
wide kernel, is left out: ``--k 200`` and ``--k 1024``, alone or with
``--kernels``, ``--generic`` or ``--jagged``.

``--mixture`` times the biallelic mixture step instead (16384 x 2048 by
default; one stream, the ploidy fold, and two streams, 2 % missing) at the
chain batches ``--chains``: the step held to its plain version, its median
CUDA-event time over ``--reps`` calls, the device time of each of its
kernels inside it (torch.profiler: the rows pass, above 128 lanes its
softmax on a line of its own, the columns pass, the eta finish, the p0
epilogue), the passes' bounds (their operations on
the float64 tensor cores at 67 TFLOP/s, or their tensors over 3.35 TB/s)
and the share reached, and the plain step and plain rows pass; above 128
lanes (``--k 200``, ``--k 1024``) the wide passes.  A tree whose mixture
kernels refuse the lanes (before the wide ones) times its plain step
alone, so parent and change are timed by the same file.
``--mixture --fit`` runs ``api.fit_model_data`` on a mixture panel made on
the card from seed 80 instead, 2 chains, plain EM with the adaptive
interval twice (the first fit of a process also pays the library's load),
cap 100, missing-free, then SQUAREM and plain EM at 1 % missing: the
panels and fits of chip_smoke.py's phase 10; at 8192 x 131072
(``--shapes``) plain EM twice, 1 % missing, cap 30.
Like ``--generic`` it calls only the step's entry point, the fit's and the
plain versions, so a parent tree is timed by the same file.

``--generic`` times the generic (multi-allelic) admixture step instead, on
a panel of ``--m`` allele slots a locus (default 4; shapes default
16384 x 2048) at the chain batches ``--chains`` (default 1,2,4): the step
held to its plain version, its median CUDA-event time over ``--reps``
calls, the device time of each of its kernels inside it (torch.profiler:
the rows pass with its finish, the columns pass, the p epilogue), each
pass's bound and the share of it reached, the columns pass with its
epilogue on CUDA events, and the plain step.  ``--generic --fit`` runs
``api.fit_dataset`` on the panel instead, 2 chains from seed 3, plain EM
with the adaptive interval twice (the first fit of a process also pays
the library's load) and then SQUAREM, cap 100.  This mode calls only the
step's entry point and the plain versions, so a tree whose wrappers take
other arguments is timed by the same file (copied into its package).

``--kernels`` times the biallelic step as the router runs it instead
(16384 x 2048 by default) at the chain batches ``--chains``: the routed
step held to its plain version, its median CUDA-event time over
``--reps`` calls, and the device time of each of its kernels inside it
(torch.profiler: the rows pass, the rows finish, the columns pass, the p0
epilogue), each with its bound and the share reached; the finish's and
the epilogue's bounds both ways, every tensor of the call once and only
the live lanes (k below the lane tile of K) of the partials and of eta
or p0.  ``--kernels --k 100`` and ``--shapes 8192x131072 --chains 2``
time the wider kernels and the biobank panel.  It calls only the routed
step and the plain version, so a parent tree is timed by the same file.
``--finish-alone`` times the rows finish alone instead, at the router's
column segments for each chain batch, launched back to back (its partials
in L2 as far as they fit) and with L2 flushed before each launch (a 256 MB
buffer written): the device time of each with the finish's bounds.  It
calls only the finish's wrapper and its plain version.

``--squarem --k 200`` runs the SQUAREM fit of chip_smoke.py's phase 22
(its K = 200 missing-free mixture panel, drawn on the host) from two
starts of the port's init drawn on the host (``squarem_case``), in float64
and through the float32 kernels, monotonicity fatal: the iterations,
whether a violation stopped the fit, and the logL, beside the digests of
the panel and the starts, which the JAX package's fit on the CPU from the
same starts is held to (tests/test_torch_wide_mixture.py, marked slow).

``--jagged`` times the admixture step on a jagged panel instead: the mix of
bench.py:199-201 (80 % of the loci with 2 alleles, the rest 8,
interleaved; 16384 x 2048 by default, 1 % missing), made on the card from
seed 300, at the chain batches ``--chains``: the bucketed step
(model/bucketed.py, one launch chain a bucket) held to its plain version
and to the dense step on the same parameters, its median CUDA-event time,
its kernels' device time summed over the buckets, the dense step through
the generic kernels at M = 8 and the plain bucketed step.  ``--jagged
--fit`` runs ``api.fit_model_data`` on that panel, 2 chains from seed 3,
cap 100: plain EM twice (the first fit of a process also pays the
library's load) and SQUAREM, bucketed and with the dense layout forced
(``model.bucketed.worth_bucketing`` patched, as the tests force it), with
iterations, logL, walls and useful cells/s (I x sum_l M_l a chain
iteration, as bench.py:199 counts them).  A tree without
model/bucketed.py (before the port bucketed jagged panels) runs the
dense step and the fits as it runs them, so the same file times a parent
tree.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import numpy as np
import torch

from multiclust_tpu_torch.model.mixture import PAD_BIAS
from multiclust_tpu_torch.ops import fullstep as fs
from multiclust_tpu_torch.ops import fullstep_bi as fb
from multiclust_tpu_torch.ops import mixture_bi as mb

SHAPES = ((16384, 2048), (65536, 16384), (8192, 131072), (2048, 524288))
K, KP = 20, 32
# the card's published peaks: device memory, and float32 outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def bound_ms(tensors, flop: float) -> float:
    """The least ms the card could take: ``tensors`` moved once each, or
    ``flop`` float32 operations."""
    n_bytes = sum(t.numel() * t.element_size() for t in tensors
                  if t is not None)
    return max(n_bytes / HBM_BYTES_PER_S, flop / F32_FLOP_PER_S) * 1e3


def count_planes(gen, I: int, L: int, miss_rate: float, prob, dev):
    """Diploid biallelic genotypes drawn on ``dev`` from ``gen`` in blocks
    of rows (no [I, L] float tensor): each copy is missing with probability
    ``miss_rate`` and else carries allele 0 with probability ``prob(lo,
    hi)`` [hi - lo, L] (rows lo to hi).  Returns the two int8 count planes
    [2, I, L] and miss [I, L] int8."""
    planes = torch.empty((2, I, L), dtype=torch.int8, device=dev)
    miss = torch.empty((I, L), dtype=torch.int8, device=dev)
    rows = max(1, (1 << 27) // L)
    for lo in range(0, I, rows):
        hi = min(I, lo + rows)
        p = prob(lo, hi)
        m = (torch.rand((hi - lo, L, 2), generator=gen, device=dev)
             < miss_rate).sum(dim=-1)
        x0 = torch.zeros((hi - lo, L), dtype=torch.int64, device=dev)
        for a in range(2):
            u = torch.rand((hi - lo, L), generator=gen, device=dev)
            x0 += (u < p) & (a < 2 - m)
        planes[0, lo:hi], planes[1, lo:hi], miss[lo:hi] = x0, 2 - m - x0, m
    return planes, miss


def device_panel(seed: int, I: int, L: int, K: int, miss_rate: float, dev):
    """Admixture-model genotypes of a strictly biallelic panel, drawn on
    ``dev`` from ``seed`` (``count_planes``): the two int8 count planes
    [2, I, L] and miss [I, L] int8."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    Q = torch.tensor(rng.dirichlet(np.full(K, 0.5), size=I),
                     dtype=torch.float32, device=dev)
    P0 = torch.tensor(rng.beta(0.8, 0.8, size=(K, L)).clip(0.01, 0.99),
                      dtype=torch.float32, device=dev)
    return count_planes(gen, I, L, miss_rate, lambda lo, hi: Q[lo:hi] @ P0,
                        dev)


def device_step_params(seed: int, B: int, I: int, L: int, K: int, Kp: int,
                       dev):
    """eta [B, I, Kp] and p0 [B, Kp, L] with zero pads, drawn on ``dev``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    eta = torch.zeros((B, I, Kp), device=dev)
    eta[..., :K] = torch.rand((B, I, K), generator=gen, device=dev) + 0.05
    eta /= eta.sum(dim=-1, keepdim=True)
    p0 = torch.zeros((B, Kp, L), device=dev)
    p0[:, :K] = torch.rand((B, K, L), generator=gen, device=dev) * 0.96 + 0.02
    return eta, p0


def median_ms(fn, n: int = 5, warm: int = 1) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _held(got, ref) -> None:
    for g, r in zip(got, ref):
        torch.testing.assert_close(g.to(r.dtype), r, rtol=1e-4, atol=5e-5)


def _share(label: str, times: dict, bound: float) -> str:
    best = min(times, key=times.get)
    return (f"  {label}: " + ", ".join(f"{n} {t:.3f}" for n, t in
                                        times.items())
            + f" ms; bound {bound:.3f} ms, best ({best}) reaches "
            f"{100 * bound / times[best]:.1f} % of it")


def time_shape(I: int, L: int, dev) -> None:
    kw = dict(k_true=K, lb=1e-8, plb=1e-8, project=True)
    planes, miss = device_panel(1, I, L, K, 0.01, dev)
    x0, x1 = planes[0], planes[1]
    c = miss.sum(dim=1, dtype=torch.float32)
    n_sm = fb.device_sm_count(dev)
    for B in (1, 2):
        eta, p0 = device_step_params(2, B, I, L, K, KP, dev)
        route = fb.pick_route(B, I, L, KP, n_sm, fb.scratch_budget(dev), K)
        print(f"{I} x {L}, {B} chains: router {route.describe()}; rows "
              f"block {fb.rows_block(K, KP)} rows, columns block "
              f"{fb.cols_tile(K, KP)[0]} columns x {fb.cols_tile(K, KP)[1]} "
              f"rows a tile", flush=True)
        ref = fb.admixture_fullstep_biallelic_streamed_reference(
            eta, p0, x0, x1, c, miss, **kw)
        steps = {"routed": lambda: fb.admixture_fullstep_biallelic_routed(
            eta, p0, x0, x1, c, miss, route=route, **kw)}
        if not fb.is_wide(KP):   # the pair has no wide kernel
            steps["pair"] = lambda: fb.admixture_fullstep_biallelic(
                eta, p0, x0, x1, c, miss, **kw)
        for n_seg in (2, 4, 8, 16, 32):
            sc = -(-L // n_seg // 32) * 32
            steps[f"streamed, {n_seg} segments"] = (
                lambda sc=sc: fb.admixture_fullstep_biallelic_streamed(
                    eta, p0, x0, x1, c, miss, seg_cols=sc, **kw))
        for n_win in (2, 4, 8):
            w = -(-L // n_win // 32) * 32
            steps[f"chunked, {n_win} windows"] = (
                lambda w=w: fb.admixture_fullstep_biallelic_chunked(
                    eta, p0, x0, x1, c, miss, window=w, **kw))
        for name, fn in steps.items():
            _held(fn(), ref)
            print(f"  step {name}: {median_ms(fn):.3f} ms", flush=True)
        # each pass alone, with the operations chip_smoke.py counts: two
        # contractions of I x L x K a pass (B0 and B1 as two) at 2 a
        # multiply-add, and ~10 / ~6 a cell elementwise
        cells = B * I * L
        row_kw = dict(k_true=K, lb=1e-8, project=True)
        fin = dict(k_true=K, lb=1e-8, project_eta=True)
        rows = {} if fb.is_wide(KP) else {
            "unsegmented (fused finish)": median_ms(
                lambda: fb.fullstep_bi_rows(eta, p0, x0, x1, c, **row_kw))}
        for n_seg in (1, 2, 4, 8, 16, 32):
            sc = -(-L // n_seg // 32) * 32

            def seg(sc=sc):
                return fb.rows_finish(eta, *fb.rows_partials(
                    eta, p0, x0, x1, l_lo=0, l_hi=L, seg_cols=sc, k_true=K),
                    c, **fin)
            rows[f"{n_seg} segments + finish"] = median_ms(seg)
        print(_share("rows pass", rows, bound_ms(
            (eta, p0, x0, x1, c, eta, c), (4 * K + 10) * cells)), flush=True)
        outs = (torch.empty_like(p0),)
        cols = {}
        for n_rseg in (0, 1, 2, 4, 16, 64):
            if 8 * B * KP * L * n_rseg > 1 << 30:
                continue   # partials of more than 1 GiB
            cols[f"{n_rseg or 'router'} row segments"] = median_ms(
                lambda n=n_rseg: fb.cols_window(
                    eta, p0, x0, x1, miss, outs, l_lo=0, l_hi=L, plb=1e-8,
                    project=True, k_true=K, n_rseg=n or route.n_rseg))
        print(_share("columns pass", cols, bound_ms(
            (eta, p0, x0, x1, miss, p0), (6 * K + 6) * cells)), flush=True)
        print(f"  logL terms alone: "
              f"{median_ms(lambda: fb.rows_log_likelihood_terms(eta, p0, x0, x1, k_true=K)):.3f}"
              f" ms; plain step in column windows: "
              f"{median_ms(lambda: fb.admixture_fullstep_biallelic_streamed_reference(eta, p0, x0, x1, c, miss, **kw), n=2):.3f}"
              f" ms", flush=True)
        del eta, p0, ref, steps, outs
        torch.cuda.empty_cache()


def lanes_panel(seed: int, I: int, L: int, M: int, dev):
    """Admixture-model genotypes at M allele slots a locus, drawn on
    ``dev`` from ``seed`` in blocks of rows: x [I, L*M] int8 and miss [I,
    L] int8 (each of two copies missing with 1 %)."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    Q = torch.tensor(rng.dirichlet(np.full(K, 0.5), size=I),
                     dtype=torch.float32, device=dev)
    P = torch.tensor(rng.dirichlet(np.full(M, 0.7), size=(K, L)),
                     dtype=torch.float32, device=dev)
    x = torch.zeros((I, L, M), dtype=torch.int8, device=dev)
    miss = torch.empty((I, L), dtype=torch.int8, device=dev)
    rows = max(1, (1 << 26) // (L * M))
    for lo in range(0, I, rows):
        hi = min(I, lo + rows)
        cum = (Q[lo:hi] @ P.reshape(K, -1)).view(hi - lo, L, M).cumsum(-1)
        m = (torch.rand((hi - lo, L, 2), generator=gen, device=dev)
             < 0.01).sum(dim=-1)
        for a in range(2):
            u = torch.rand((hi - lo, L, 1), generator=gen, device=dev)
            allele = torch.clamp((u > cum).sum(dim=-1), max=M - 1)
            x[lo:hi].scatter_add_(2, allele[..., None],
                                  (a < 2 - m)[..., None].to(torch.int8))
        miss[lo:hi] = m
    return x.view(I, L * M), miss


# the generic step's kernels by name, as the profiler sees them
# (above 128 lanes the columns pass is two kernels, a d launch and a B
# launch; a tree of the one-kernel design names it wide_cols_kernel; the
# d launch's share is printed on a line of its own)
WIDE_COLS = ("wide_cols_kernel", "wide_cols_d_kernel", "wide_cols_b_kernel")
D_LAUNCH = "columns pass: its d launch (wide)"
GENERIC_KERNELS = {"rows pass": ("fullstep_rows_kernel", "wide_rows_kernel"),
                   "rows finish": ("rows_finish_kernel",
                                   "wide_finish_kernel"),
                   "columns pass": ("fullstep_cols_kernel",) + WIDE_COLS,
                   D_LAUNCH: ("wide_cols_d_kernel",),
                   "p epilogue": ("fullstep_p_kernel",)}
# the biallelic step's, on any of its routes (the wide kernels above 128
# lanes)
BI_KERNELS = {"rows pass": ("fullstep_bi_rows_seg_kernel",
                            "fullstep_bi_rows_kernel", "wide_rows_kernel"),
              "rows finish": ("rows_finish_kernel", "wide_finish_kernel"),
              "columns pass": ("fullstep_bi_cols_kernel",) + WIDE_COLS,
              D_LAUNCH: ("wide_cols_d_kernel",),
              "p0 epilogue": ("fullstep_bi_p0_kernel",)}


def finish_bytes(B: int, I: int, Kp: int, n_seg: int, kc: int):
    """Bytes the rows finish must move for B chains of I rows over n_seg
    segments, as a pair: every tensor of the call once (apart, tpart, eta,
    c, eta' and t in float64), and only the lanes it has to read (the kc
    live lanes of apart and eta; eta' is written in full)."""
    rest = 4 * B * n_seg * I + 4 * I + 4 * B * I * Kp + 8 * B * I
    return (4 * B * I * Kp * (n_seg + 1) + rest,
            4 * B * I * kc * (n_seg + 1) + rest)


def p0_bytes(B: int, Kp: int, W: int, n_seg: int, kc: int):
    """Bytes the p0 epilogue must move over a window of W columns and
    n_seg row segments, as a pair: every tensor once (the partials [B,
    n_seg, 2, Kp, W], p0 and p0' at the window's columns), and only the kc
    live lanes of the partials and of p0 (p0' is written in full)."""
    return (4 * B * Kp * W * (2 * n_seg + 2),
            4 * B * W * (kc * (2 * n_seg + 1) + Kp))


def p_bytes(B: int, Kp: int, LM: int, n_seg: int, kl: int):
    """Bytes the generic p epilogue must move over L*M lanes and n_seg row
    segments, as a pair: every tensor once (the partials [B, n_seg, Kp,
    L*M], p2, the [L, M] mask, p'), and only the kl live lanes of the
    partials and of p2 (p' is written in full)."""
    return (4 * B * Kp * LM * (n_seg + 2) + LM,
            4 * B * LM * (kl * (n_seg + 1) + Kp) + LM)


def _kernel_line(label: str, ms: float, bnd) -> str:
    """A kernel's device time with its bound (a number, or a pair: every
    tensor once, the live lanes) and the share of it reached."""
    if not ms:
        return f"  {label}: not run or not measured (no device events)"
    line = f"  {label}: {ms:.4f} ms of device time a step"
    if bnd is None:
        return line
    bnd = bnd if isinstance(bnd, tuple) else (bnd,)
    line += f"; bound {bnd[0]:.4f} ms, {100 * bnd[0] / ms:.1f} % of it"
    if len(bnd) == 2:
        line += (f"; live-lane bound {bnd[1]:.4f} ms, "
                 f"{100 * bnd[1] / ms:.1f} % of it")
    return line


def time_bi_kernels(I: int, L: int, chains, n: int, dev) -> None:
    """The routed biallelic step, held to its plain version: its median
    CUDA-event time and each of its kernels' device time inside it
    (torch.profiler), with each kernel's bound; the finish and the p0
    epilogue with theirs both ways (every tensor once, the live lanes)."""
    kw = dict(k_true=K, lb=1e-8, plb=1e-8, project=True)
    planes, miss = device_panel(1, I, L, K, 0.01, dev)
    x0, x1 = planes[0], planes[1]
    c = miss.sum(dim=1, dtype=torch.float32)
    n_sm = fb.device_sm_count(dev)
    kc = fb.kc_of(K, KP)
    for B in chains:
        eta, p0 = device_step_params(2, B, I, L, K, KP, dev)
        route = fb.pick_route(B, I, L, KP, n_sm, fb.scratch_budget(dev), K)

        def step():
            return fb.admixture_fullstep_biallelic_routed(
                eta, p0, x0, x1, c, miss, route=route, **kw)

        _held(step(), fb.admixture_fullstep_biallelic_streamed_reference(
            eta, p0, x0, x1, c, miss, **kw))
        step_ms = median_ms(step, n)
        dev_ms = kernel_device_ms(step, n, BI_KERNELS)
        # the bytes of every window's finish and epilogue
        ri = fb.cols_tile(K, KP)[1]
        seg_rows = -(-(-(-I // route.n_rseg)) // ri) * ri
        n_rseg = -(-I // seg_rows)
        fin, epi = [0, 0], [0, 0]
        for lo in range(0, L, route.window):
            W = min(L, lo + route.window) - lo
            n_cseg = -(-W // route.seg_cols) if route.seg_cols else 0
            if n_cseg:
                fin = [a + b for a, b in zip(fin, finish_bytes(
                    B, I, KP, n_cseg, kc))]
            epi = [a + b for a, b in zip(epi, p0_bytes(B, KP, W, n_rseg,
                                                       kc))]
        cells = B * I * L
        bounds = {
            "rows pass": bound_ms((eta, p0, x0, x1, c, eta, c),
                                  (4 * K + 10) * cells),
            "rows finish": (tuple(b / HBM_BYTES_PER_S * 1e3 for b in fin)
                            if fin[0] else None),
            "columns pass": bound_ms((eta, p0, x0, x1, miss, p0),
                                     (6 * K + 6) * cells),
            D_LAUNCH: bound_ms((eta, p0), 2 * K * cells),
            "p0 epilogue": tuple(b / HBM_BYTES_PER_S * 1e3 for b in epi)}
        print(f"{I} x {L}, K = {K} on {KP} lanes, {B} chains: router "
              f"{route.describe()}; routed step {step_ms:.4f} ms on CUDA "
              f"events", flush=True)
        for label, ms in dev_ms.items():
            print(_kernel_line(label, ms, bounds[label]), flush=True)
        del eta, p0
        torch.cuda.empty_cache()


def time_finish_alone(I: int, L: int, chains, n: int, dev) -> None:
    """The rows finish alone on partials of the router's column segments
    (random, one value a row on the pad lanes as the rows passes write
    them), its device time (torch.profiler) two ways: launched back to
    back, so the partials the launch before read sit in the 50 MB L2 as
    far as they fit, and with a 256 MB buffer written before each launch,
    so they come from device memory; each with its bounds."""
    kc = fb.kc_of(K, KP)
    gen = torch.Generator(device=dev).manual_seed(5)
    flush = torch.empty(2 ** 26, device=dev)   # 256 MB
    n_sm = fb.device_sm_count(dev)
    for B in chains:
        route = fb.pick_route(B, I, L, KP, n_sm, fb.scratch_budget(dev), K)
        W = min(L, route.window)
        n_seg = -(-W // route.seg_cols) if route.seg_cols else 1
        eta, _ = device_step_params(2, B, I, L, K, KP, dev)
        apart = torch.rand((B, n_seg, I, KP), generator=gen, device=dev)
        apart[..., kc:] = apart[..., kc:kc + 1]
        tpart = -torch.rand((B, n_seg, I), generator=gen, device=dev) * 50
        c = torch.rand((I,), generator=gen, device=dev) * 4
        kw = dict(k_true=K, lb=1e-8, project_eta=True)

        def warm():
            return fb.rows_finish(eta, apart, tpart, c, **kw)

        def cold():
            flush.fill_(1.0)
            return fb.rows_finish(eta, apart, tpart, c, **kw)

        _held(warm(), fb.rows_finish_reference(eta, apart, tpart, c, **kw))
        bnd = tuple(b / HBM_BYTES_PER_S * 1e3
                    for b in finish_bytes(B, I, KP, n_seg, kc))
        print(f"{I} x {L}, K = {K} on {KP} lanes, {B} chains, {n_seg} "
              f"column segments ({4 * apart.numel() / 1e6:.1f} MB of A "
              f"partials): the finish alone", flush=True)
        for label, fn in (("L2 warm", warm), ("L2 flushed", cold)):
            ms = kernel_device_ms(fn, n, {label: ("rows_finish_kernel",)})
            print(_kernel_line(f"rows finish, {label}", ms[label], bnd),
                  flush=True)
        del eta, apart, tpart
        torch.cuda.empty_cache()


def kernel_device_ms(fn, n: int, groups) -> dict:
    """Device ms that each group of kernels (by name) takes in a call of
    ``fn``: torch.profiler's kernel times summed over ``n`` calls, / n."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(groups, 0.0)
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for label, names in groups.items():
            if any(name in ev.key for name in names):
                out[label] += ev.device_time_total / 1e3 / n
    return out


def time_generic(I: int, L: int, M: int, chains, n: int, dev) -> None:
    x2, miss = lanes_panel(1, I, L, M, dev)
    c = miss.sum(dim=1, dtype=torch.float32)
    mask = torch.ones((L, M), dtype=torch.bool, device=dev)
    kw = dict(k_true=K, lb=1e-8, plb=1e-8, project=True)
    print(f"{I} x {L} x M = {M}, K = {K} on {KP} lanes: "
          f"{100 * float((x2 == 0).float().mean()):.1f} % of the lanes "
          f"have x = 0", flush=True)
    for B in chains:
        gen = torch.Generator(device=dev).manual_seed(2)
        eta = torch.zeros((B, I, KP), device=dev)
        eta[..., :K] = torch.rand((B, I, K), generator=gen, device=dev) + 0.05
        eta /= eta.sum(dim=-1, keepdim=True)
        p = torch.zeros((B, KP, L, M), device=dev)
        p[:, :K] = torch.rand((B, K, L, M), generator=gen, device=dev) + 0.05
        p2 = (p / p.sum(dim=-1, keepdim=True).clamp(min=1e-30)).view(
            B, KP, L * M)
        del p

        def step():
            return fs.admixture_fullstep(eta, p2, x2, c, miss, mask, **kw)

        ref = fs.admixture_fullstep_reference(eta, p2, x2, c, miss, mask,
                                              **kw)
        _held(step(), ref)
        del ref
        step_ms = median_ms(step, n)
        cols_ms = median_ms(lambda: fs.fullstep_cols(
            eta, p2, x2, miss, mask, k_true=K, plb=1e-8, project=True), n)
        dev_ms = kernel_device_ms(step, n, GENERIC_KERNELS)
        plain_ms = median_ms(lambda: fs.admixture_fullstep_reference(
            eta, p2, x2, c, miss, mask, **kw), max(2, n // 4))
        lanes = B * I * L * M
        n_sm = fb.device_sm_count(dev)
        n_cseg = fb.row_segments(B, I, L * M, n_sm, k_true=K, Kp=KP)[0]
        n_rseg = fs.cols_segments(B, I, L * M, KP, n_sm, K)[0]
        kc = fb.kc_of(K, KP)
        ms_of = lambda b: tuple(n / HBM_BYTES_PER_S * 1e3 for n in b)
        bounds = {"rows pass": bound_ms((eta, p2, x2, c, eta, c),
                                        (4 * K + 5) * lanes),
                  "rows finish": ms_of(finish_bytes(B, I, KP, n_cseg, kc)),
                  "columns pass": bound_ms((eta, p2, x2, miss, p2),
                                           (4 * K + 3) * lanes),
                  D_LAUNCH: bound_ms((eta, p2), 2 * K * lanes),
                  "p epilogue": ms_of(p_bytes(B, KP, L * M, n_rseg,
                                              min(kc, KP)))}
        print(f" {B} chains: step {step_ms:.3f} ms (plain {plain_ms:.3f}); "
              f"columns pass + p epilogue {cols_ms:.3f} ms on CUDA events",
              flush=True)
        for label, ms in dev_ms.items():
            print(_kernel_line(label, ms, bounds[label]), flush=True)
        del eta, p2
        torch.cuda.empty_cache()


def time_generic_fits(I: int, L: int, M: int, dev) -> None:
    import time

    from multiclust_tpu_torch.api import fit_dataset
    from multiclust_tpu_torch.convert import dataset_from_counts

    x2, miss = lanes_panel(42, I, L, M, dev)
    ds = dataset_from_counts(x2.view(I, L, M).cpu().numpy(),
                             miss.cpu().numpy(), 2)
    base = dict(admixture=True, min_K=K, max_K=K, n_init=2, max_iter=100,
                seed=3, verbosity=0)
    for label, kw in (("plain EM, first in the process", {}),
                      ("plain EM", {}), ("SQUAREM", {"accel_scheme": 1})):
        t0 = time.time()
        res = fit_dataset(ds, device=dev, **base, **kw).best
        torch.cuda.synchronize()
        print(f"fit {I} x {L} x M = {M}, K = {K}, {label}: "
              f"{res.n_iter_all} iterations over the chains, logL "
              f"{res.max_logL:.4f}, monotonicity violated: "
              f"{bool(res.mono_viol)}; {time.time() - t0:.3f} s of wall, "
              f"init + EM {res.seconds:.3f} s", flush=True)


# the mixture step's kernels by name, as the profiler sees them (the wide
# rows pass is two kernels, its scores and its softmax, each on a line of
# its own)
MIXTURE_KERNELS = {"rows pass": ("mix_rows_kernel", "mix_rows_wide_kernel"),
                   "rows softmax (wide)": ("mix_softmax_kernel",),
                   "columns pass": ("mix_cols_kernel",
                                    "mix_cols_wide_kernel"),
                   "eta finish": ("mix_eta_kernel",),
                   "p0 epilogue": ("mix_p_kernel",)}


def mixture_planes(seed: int, I: int, L: int, K: int, miss_rate: float,
                   dev, spread=None):
    """Mixture-model genotypes drawn on the host from ``seed``
    (``count_planes`` with a CPU generator, so that every machine draws the
    same panel) and uploaded to ``dev``: individual i belongs to cluster
    z_i ~ eta, each observed copy carries allele 0 with probability P0[z_i,
    l], uniform on [0.1, 0.9] per cluster, or with ``spread`` one shared
    locus frequency plus N(0, spread) per cluster (weakly separated
    clusters).  Returns the two int8 count planes [2, I, L] and miss [I, L]
    int8."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    eta = rng.dirichlet(np.full(K, 5.0))
    if spread is None:
        P0 = rng.uniform(0.1, 0.9, size=(K, L))
    else:
        P0 = np.clip(rng.uniform(0.2, 0.8, size=L)
                     + rng.normal(0.0, spread, size=(K, L)), 0.05, 0.95)
    P0 = torch.tensor(P0, dtype=torch.float32)
    z = torch.tensor(rng.choice(K, size=I, p=eta))
    planes, miss = count_planes(gen, I, L, miss_rate,
                                lambda lo, hi: P0[z[lo:hi]], "cpu")
    return planes.to(dev), miss.to(dev)


# the options of the SQUAREM fit that chip_smoke.py's phase 22 runs at
# K = 200 on a missing-free mixture panel (seed 460 + K)
SQUAREM_FIT = dict(admixture=False, n_init=2, max_iter=30, seed=3,
                   accel_scheme=1)


def squarem_case(I: int, L: int, K: int):
    """Phase 22's SQUAREM fit at K on the host: its panel (drawn on the
    host), the EMConfig that ``api.fit_model_data`` builds for its options
    (``runtime.multistart.cfg_from_options``) with monotonicity fatal, so
    that a fit stops where a violation is recorded, and two starts drawn
    as the API draws them (``multistart._draw_init_batch``: random
    centers) but from a CPU generator seeded with the API's seed, on the
    panel's float64 ModelData on the host (the distances are sums of
    integers: exact).  They are the same on every machine, so that a fit
    on the card and the JAX package's fit on the CPU start from the same
    parameters (eta [K], p [K, L, 2] float64 numpy arrays,
    ``convert.params_from_numpy``).  Returns (planes, miss, the host
    Dataset, its float64 ModelData, the starts, the EMConfig)."""
    from multiclust_tpu_torch.config import Options
    from multiclust_tpu_torch.convert import dataset_from_counts
    from multiclust_tpu_torch.model.common import model_data_from_dataset
    from multiclust_tpu_torch.runtime.multistart import _draw_init_batch, \
        cfg_from_options

    planes, miss = mixture_planes(460 + K, I, L, K, 0.0, "cpu")
    ds = dataset_from_counts(planes.permute(1, 2, 0).long().numpy(),
                             miss.long().numpy(), 2)
    md = model_data_from_dataset(ds, dtype=torch.float64)
    opt = Options(min_K=K, max_K=K, **SQUAREM_FIT).synchronize(I, 2)
    cfg = cfg_from_options(opt, K, md)._replace(monotonicity="fatal")
    batch = _draw_init_batch(torch.Generator().manual_seed(opt.seed),
                             opt.n_init, md, K, cfg, opt, None)
    starts = [(batch.eta[i].numpy(), batch.p[i].numpy())
              for i in range(opt.n_init)]
    return planes, miss, ds, md, starts, cfg


def digest(*arrays) -> str:
    """A short hash of the arrays' bytes, to show two machines drew the
    same panel and starts."""
    import hashlib

    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(np.asarray(a)).tobytes())
    return h.hexdigest()[:16]


def time_squarem(I: int, L: int, dev) -> None:
    """Phase 22's SQUAREM fit at K on the card: through
    ``api.fit_model_data`` on the panel as phase 22 runs it (2 chains,
    monotonicity as the options have it: recorded), then from each start
    of ``squarem_case`` in float64 (the plain products) and float32 (the
    kernels), monotonicity fatal: iterations, whether a violation stopped
    the fit, logL and wall; the digests of the panel and of the starts."""
    import time

    from multiclust_tpu_torch.api import fit_model_data
    from multiclust_tpu_torch.convert import params_from_numpy
    from multiclust_tpu_torch.model.common import model_data_from_dataset, \
        model_data_from_planes
    from multiclust_tpu_torch.opt.driver import fit

    planes, miss, ds, md, starts, cfg = squarem_case(I, L, K)
    del md
    print(f"squarem K={K} {I} x {L}: panel digest "
          f"{digest(planes.numpy(), miss.numpy())}, starts "
          f"{[digest(*s) for s in starts]}", flush=True)
    md = model_data_from_planes(planes.to(dev), miss.to(dev))
    res = fit_model_data(md, 2, min_K=K, max_K=K, verbosity=0,
                         **SQUAREM_FIT).estimate.per_K[K]
    print(f"squarem K={K} api.fit_model_data (phase 22's fit): "
          f"{res.n_iter_all} iterations over the chains, monotonicity "
          f"violated {bool(res.mono_viol)}, logL {res.max_logL:.6f}",
          flush=True)
    for dtype in (torch.float64, torch.float32):
        md = (model_data_from_dataset(ds, dtype=dtype, device=dev)
              if dtype == torch.float64
              else model_data_from_planes(planes.to(dev), miss.to(dev)))
        run_cfg = cfg._replace(use_pallas="on" if dtype == torch.float32
                               else "off")
        for i, (eta, p) in enumerate(starts):
            t0 = time.time()
            res = fit(params_from_numpy(eta, p, device=dev, dtype=dtype),
                      md, run_cfg)
            torch.cuda.synchronize()
            print(f"squarem K={K} start {i} {str(dtype)[6:]}"
                  f"{' kernels' if dtype == torch.float32 else ''}: "
                  f"{res.n_iter} iterations, monotonicity violated "
                  f"{bool(res.state.mono_viol[0])}, logL {res.logL:.6f}, "
                  f"{time.time() - t0:.2f} s", flush=True)
        del md


def mixture_step_inputs(seed: int, B: int, I: int, L: int, K: int,
                        Kp: int, miss_rate: float, dev):
    """Kernel-route inputs of the mixture step on ``dev``, K-padded as
    model/mixture.py builds them (pads: lp 0, bias PAD_BIAS): lp0 [B, Kp, L],
    x0 int8 [I, L], bias [B, Kp], and lp1 / x1 with missing data (two
    streams); missing-free inputs fold x1 = 2 - x0 into lp0 = log p0 -
    log p1 and the bias."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    p0 = torch.rand((B, K, L), generator=gen, device=dev) * 0.96 + 0.02
    eta = torch.rand((B, K), generator=gen, device=dev) + 0.1
    eta /= eta.sum(dim=-1, keepdim=True)
    miss = (torch.rand((I, L, 2), generator=gen, device=dev)
            < miss_rate).sum(dim=-1)
    x0 = sum(((torch.rand((I, L), generator=gen, device=dev) < 0.5)
              & (a < 2 - miss)).to(torch.int8) for a in range(2))
    lp0 = torch.zeros((B, Kp, L), device=dev)
    bias = torch.full((B, Kp), PAD_BIAS, device=dev)
    if not miss_rate:
        lp0[:, :K] = torch.log(p0) - torch.log1p(-p0)
        bias[:, :K] = 2 * torch.log1p(-p0).sum(dim=-1) + torch.log(eta)
        return lp0, x0, bias, None, None
    lp1 = torch.zeros_like(lp0)
    lp0[:, :K], lp1[:, :K] = torch.log(p0), torch.log1p(-p0)
    bias[:, :K] = torch.log(eta)
    return lp0, x0, bias, lp1, (2 - miss - x0).to(torch.int8)


def _mixture_kernels_take(Kp: int) -> bool:
    """Whether this tree's mixture kernels take Kp lanes (a tree before the
    wide mixture kernels refuses Kp > 128)."""
    try:
        mb.check_kp(Kp)
    except ValueError:
        return False
    return True


def time_mixture(I: int, L: int, chains, n: int, dev) -> None:
    kw = dict(k_true=K, lb=1e-8, plb=1e-8, ploidy=2, project=True)
    for two in (False, True):
        for B in chains:
            args = mixture_step_inputs(60 + B, B, I, L, K, KP,
                                       0.02 if two else 0.0, dev)
            streams = "two streams" if two else "one stream"
            if not _mixture_kernels_take(KP):
                plain_ms = median_ms(
                    lambda: mb.mixture_fullstep_biallelic_reference(
                        *args, **kw), max(2, n // 4))
                print(f"mixture {I} x {L}, {streams}, {B} chains: the "
                      f"kernels refuse {KP} lanes; plain step "
                      f"{plain_ms:.3f} ms on CUDA events", flush=True)
                del args
                torch.cuda.empty_cache()
                continue

            def step():
                return mb.mixture_fullstep_biallelic(*args, **kw)

            _held(step(), mb.mixture_fullstep_biallelic_reference(*args,
                                                                  **kw))
            step_ms = median_ms(step, n)
            dev_ms = kernel_device_ms(step, n, MIXTURE_KERNELS)
            plain_ms = median_ms(
                lambda: mb.mixture_fullstep_biallelic_reference(*args, **kw),
                max(2, n // 4))
            plain_rows_ms = median_ms(
                lambda: mb.mixture_rows_reference(*args), max(2, n // 4))
            # one contraction of I x L x K a stream for the scores and one
            # for B, 2 a multiply-add, and the softmax's ~20 a posterior
            lp0, x0, bias, lp1, x1 = args
            ns = 2 if two else 1
            flop = 2 * K * ns * B * I * L
            v = torch.empty((B, I, KP), device=dev)
            t = torch.empty((B, I), device=dev)
            part = torch.empty((B, ns, KP, L), device=dev)
            bounds = {"rows pass": bound_ms((lp0, x0, bias, lp1, x1, v, t),
                                            flop + 20 * v.numel()),
                      "columns pass": bound_ms((v, x0, x1, part), flop)}
            if mb.is_wide(KP):
                # the softmax reads the float64 scores of the K live
                # lanes and writes v and t
                bounds["rows softmax (wide)"] = (
                    (8 * B * I * K + 4 * v.numel() + 4 * t.numel())
                    / HBM_BYTES_PER_S * 1e3)
            print(f"mixture {I} x {L}, {streams}, {B} chains: step "
                  f"{step_ms:.3f} ms (plain {plain_ms:.3f}, plain rows pass "
                  f"{plain_rows_ms:.3f}) on CUDA events", flush=True)
            for label, ms in dev_ms.items():
                line = f"  {label}: {ms:.3f} ms of device time a step"
                if not ms and label in bounds:
                    line = f"  {label}: not measured (no device events)"
                elif not ms:
                    continue   # the narrow rows pass has no softmax
                elif label in bounds:
                    line += (f"; bound {bounds[label]:.3f} ms, "
                             f"{100 * bounds[label] / ms:.1f} % of it")
                print(line, flush=True)
            del args, v, t, part
            torch.cuda.empty_cache()


def time_mixture_fits(I: int, L: int, dev) -> None:
    import time

    from multiclust_tpu_torch.api import fit_model_data
    from multiclust_tpu_torch.model.common import model_data_from_planes
    from multiclust_tpu_torch.ops import build

    wide = L > 16384
    md = model_data_from_planes(*mixture_planes(80, I, L, K,
                                                0.01 if wide else 0.0, dev))
    base = dict(admixture=False, min_K=K, max_K=K, n_init=2,
                max_iter=30 if wide else 100, seed=3, verbosity=0)
    fits = [("plain EM, first in the process", md, {}), ("plain EM", md, {})]
    if not wide:
        # chip_smoke.py's other two mixture fits of this panel
        md_miss = model_data_from_planes(*mixture_planes(80, I, L, K, 0.01,
                                                         dev))
        fits += [("SQUAREM", md, {"accel_scheme": 1}),
                 ("plain EM, 1 % missing", md_miss, {})]
    for label, data, kw in fits:
        build.reset_launch_counts()
        t0 = time.time()
        res = fit_model_data(data, 2, **base, **kw).best
        torch.cuda.synchronize()
        print(f"mixture fit {I} x {L}, K = {K}, {label}: "
              f"{res.n_iter_all} iterations over the chains, logL "
              f"{res.max_logL:.4f}, monotonicity violated: "
              f"{bool(res.mono_viol)}; {time.time() - t0:.3f} s of wall, "
              f"init + EM {res.seconds:.3f} s; rows-pass launches "
              f"{build.LAUNCHES['mc_mix_rows']}", flush=True)
    # the plain-EM fit once more under the profiler: its kernels' device
    # time
    dev_ms = kernel_device_ms(lambda: fit_model_data(md, 2, **base), 1,
                              MIXTURE_KERNELS)
    print("  device ms of the fit's kernels: " + ", ".join(
        f"{label} {ms:.3f}" for label, ms in dev_ms.items())
        + f"; together {sum(dev_ms.values()):.3f}", flush=True)


def jagged_panel(seed: int, I: int, L: int, dev, n_alleles=None):
    """A jagged panel drawn on ``dev`` from ``seed``: by default the mix of
    bench.py:199-201 (80 % of the loci with 2 alleles, the rest 8,
    interleaved), else the loci's ``n_alleles``; admixture-model genotypes
    over each locus's valid slots, 1 % of the copies missing.  Returns the
    ModelData of a float32 fit (x int8 [I, L, max n_alleles])."""
    from multiclust_tpu_torch.model.common import make_model_data

    rng = np.random.default_rng(seed)
    n_all = (np.where(rng.random(L) < 0.8, 2, 8) if n_alleles is None
             else np.asarray(n_alleles))
    M = int(n_all.max())
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_dev = torch.as_tensor(n_all, device=dev)
    mask = torch.arange(M, device=dev)[None] < n_dev[:, None]
    Q = torch.tensor(rng.dirichlet(np.full(K, 0.5), size=I),
                     dtype=torch.float32, device=dev)
    P = torch.tensor(rng.dirichlet(np.full(M, 0.7), size=(K, L)),
                     dtype=torch.float32, device=dev) * mask
    P /= P.sum(dim=-1, keepdim=True)
    x = torch.zeros((I, L, M), dtype=torch.int8, device=dev)
    miss = torch.empty((I, L), dtype=torch.int8, device=dev)
    rows = max(1, (1 << 26) // (L * M))
    for lo in range(0, I, rows):
        hi = min(I, lo + rows)
        cum = (Q[lo:hi] @ P.reshape(K, -1)).view(hi - lo, L, M).cumsum(-1)
        m = (torch.rand((hi - lo, L, 2), generator=gen, device=dev)
             < 0.01).sum(dim=-1)
        for a in range(2):
            u = torch.rand((hi - lo, L, 1), generator=gen, device=dev)
            allele = torch.minimum((u > cum).sum(dim=-1), n_dev - 1)
            x[lo:hi].scatter_add_(2, allele[..., None],
                                  (a < 2 - m)[..., None].to(torch.int8))
        miss[lo:hi] = m
    return make_model_data(x, miss, mask, n_dev, dtype=torch.float32,
                           device=dev, storage_dtype=torch.int8)


def _bucketed_module():
    """model/bucketed.py, or None in a tree without it."""
    try:
        from multiclust_tpu_torch.model import bucketed
    except ImportError:
        return None
    return bucketed


def time_jagged(I: int, L: int, chains, n: int, dev) -> None:
    from multiclust_tpu_torch.model import admixture as adm
    from multiclust_tpu_torch.model.common import EMConfig, Params

    bk = _bucketed_module()
    md = jagged_panel(300, I, L, dev)
    useful = I * int(md.n_alleles.sum())
    bd = bk.bucketize_model_data(md, bk.plan_for(md)) if bk else None
    print(f"jagged {I} x {L}, K = {K} on {KP} lanes: "
          + (bd.plan.describe() if bd else "no model/bucketed.py: dense")
          + f"; {useful} useful cells a chain iteration", flush=True)
    kw = dict(k_true=K, lb=1e-8, plb=1e-8, project=True)
    for B in chains:
        gen = torch.Generator(device=dev).manual_seed(2)
        eta = torch.zeros((B, I, KP), device=dev)
        eta[..., :K] = torch.rand((B, I, K), generator=gen, device=dev) + 0.05
        eta /= eta.sum(dim=-1, keepdim=True)
        p = torch.zeros((B, KP, L, md.M), device=dev)
        p[:, :K] = (torch.rand((B, K, L, md.M), generator=gen, device=dev)
                    + 0.05) * md.mask
        p /= p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
        p2 = p.view(B, KP, -1)

        def dense():
            return fs.admixture_fullstep(eta, p2, md.x_lanes, md.c, md.miss,
                                         md.mask, **kw)

        _held(dense(), fs.admixture_fullstep_reference(
            eta, p2, md.x_lanes, md.c, md.miss, md.mask, **kw))
        dense_ms = median_ms(dense, n)
        line = (f" {B} chains: dense step (M = {md.M}) {dense_ms:.3f} ms "
                f"({useful * B / dense_ms / 1e6:.2f} G useful cells/s)")
        if bd is not None:
            cfg = EMConfig(admixture=True, has_missing=True,
                           use_pallas="on", k_true=K)
            params = bk.split_params_like(Params(eta, p), bd)

            def step():
                return adm.em_step(params, bd, cfg)

            got = step()
            ref = adm.em_step(params, bd, cfg._replace(use_pallas="off"))
            _held((got[0].eta,) + got[0].p, (ref[0].eta,) + ref[0].p)
            d_eta, _, d_p = dense()
            _held((got[0].eta, bk.merge_params_like(got[0], bd).p),
                  (d_eta, d_p))
            del ref, d_eta, d_p
            step_ms = median_ms(step, n)
            dev_ms = kernel_device_ms(step, n, GENERIC_KERNELS)
            plain_ms = median_ms(lambda: adm.em_step(
                params, bd, cfg._replace(use_pallas="off")), max(2, n // 4))
            line += (f"; bucketed step {step_ms:.3f} ms "
                     f"({useful * B / step_ms / 1e6:.2f} G useful cells/s, "
                     f"the dense step takes {dense_ms / step_ms:.2f}x), "
                     f"plain bucketed {plain_ms:.3f} ms; device time a "
                     f"step: " + ", ".join(f"{k} {v:.3f} ms"
                                           for k, v in dev_ms.items()))
        print(line, flush=True)
        del eta, p, p2
        torch.cuda.empty_cache()


def time_jagged_fits(I: int, L: int, dev) -> None:
    import time

    from multiclust_tpu_torch.api import fit_model_data

    bk = _bucketed_module()
    md = jagged_panel(300, I, L, dev)
    useful = I * int(md.n_alleles.sum())
    base = dict(admixture=True, min_K=K, max_K=K, n_init=2, max_iter=100,
                seed=3, verbosity=0)
    for label, kw in (("plain EM, first in the process", {}),
                      ("plain EM", {}), ("SQUAREM", {"accel_scheme": 1})):
        for layout in ("bucketed", "dense") if bk else ("dense",):
            real = bk.worth_bucketing if bk else None
            if layout == "dense" and bk:
                bk.worth_bucketing = lambda *a, **k: False
            try:
                t0 = time.time()
                res = fit_model_data(md, 2, **base, **kw).estimate.last
                torch.cuda.synchronize()
                wall = time.time() - t0
            finally:
                if bk:
                    bk.worth_bucketing = real
            n = res.n_iter_all
            print(f"jagged fit {I} x {L}, K = {K}, {label}, {layout}: {n} "
                  f"iterations over the chains, logL {res.max_logL:.4f}, "
                  f"monotonicity violated: {bool(res.mono_viol)}; "
                  f"{wall:.3f} s of wall ({useful * n / wall / 1e9:.2f} G "
                  f"useful cells/s), init + EM {res.seconds:.3f} s "
                  f"({useful * n / res.seconds / 1e9:.2f} G useful "
                  f"cells/s)", flush=True)


def main(argv=None) -> int:
    global K, KP, SHAPES
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k", type=int, default=K)
    ap.add_argument("--shapes")
    ap.add_argument("--generic", action="store_true")
    ap.add_argument("--mixture", action="store_true")
    ap.add_argument("--jagged", action="store_true")
    ap.add_argument("--kernels", action="store_true")
    ap.add_argument("--finish-alone", action="store_true")
    ap.add_argument("--m", type=int, default=4)
    ap.add_argument("--chains", default="1,2,4")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--fit", action="store_true")
    ap.add_argument("--squarem", action="store_true")
    args = ap.parse_args(argv)
    K, KP = args.k, -(-args.k // 32) * 32
    if args.shapes:
        SHAPES = tuple(tuple(int(n) for n in s.split("x"))
                       for s in args.shapes.split(","))
    elif (args.generic or args.mixture or args.jagged or args.kernels
          or args.finish_alone or args.squarem):
        SHAPES = ((16384, 2048),)
    if not torch.cuda.is_available():
        print("route_times: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda")
    print(f"K = {K} on {KP} lanes", flush=True)
    for I, L in SHAPES:
        chains = [int(b) for b in args.chains.split(",")]
        if args.squarem:
            time_squarem(I, L, dev)
        elif args.kernels:
            time_bi_kernels(I, L, chains, args.reps, dev)
        elif args.finish_alone:
            time_finish_alone(I, L, chains, args.reps, dev)
        elif args.jagged and args.fit:
            time_jagged_fits(I, L, dev)
        elif args.jagged:
            time_jagged(I, L, chains, args.reps, dev)
        elif args.mixture and args.fit:
            time_mixture_fits(I, L, dev)
        elif args.mixture:
            time_mixture(I, L, chains, args.reps, dev)
        elif args.generic and args.fit:
            time_generic_fits(I, L, args.m, dev)
        elif args.generic:
            time_generic(I, L, args.m, chains, args.reps, dev)
        else:
            time_shape(I, L, dev)
    print(f"peak allocation "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
