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
softmax on a line of its own, the columns pass, the finish, or a parent
tree's eta finish and p0 epilogue), the passes' bounds (their operations on
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
(``--shapes``) plain EM twice, 1 % missing, cap 30; then the Michelot
passes of the eta finish along a fit at K (``fit_michelot_passes``).
Each ``--mixture`` step's lines end with the finish: its device time in
the step against its bound from the live lanes, its halves alone
(``time_finish_halves``: the eta half as it runs, with one segment, and
without Michelot; the p half), the eta finish after each kind of work
that can precede it (``time_eta_after``), the sweep statistics and their
raw p half (``time_sweep``), and the model's step (``em_step``, the
parameters in the model's layout) on CUDA events with the device
operations it runs.
Like ``--generic`` it calls only the step's entry point, the fit's and the
plain versions, so a parent tree is timed by the same file.

``--generic`` times the generic (multi-allelic) admixture step instead, on
a panel of ``--m`` allele slots a locus (default 4; shapes default
16384 x 2048) at the chain batches ``--chains`` (default 1,2,4): the step
held to its plain version, its median CUDA-event time over ``--reps``
calls, the device time of each of its kernels inside it (torch.profiler:
the rows pass with its finish, the columns pass, the p epilogue), each
pass's bound and the share of it reached, the columns pass with its
epilogue on CUDA events, the plain step, the sweep statistics
(``admixture_sweep_stats``) on CUDA events and the float32 matmul
yardstick of both passes (``yardstick_ms``).  ``--generic --fit`` runs
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
or p0.  Above 128 lanes the d launch has a line of its own, each pass's
line is held to its own launch's work, and it also prints the rows pass
alone through ``rows_partials`` (d + A, held to both), the finish alone
on its partials, the step in the order that runs d for each pass
(``bi_step_unshared``) and, where the router splits the rows pass into
column segments, the step at one segment, all on CUDA events.
Each chain batch ends with the float32 ``torch.matmul`` yardstick of
the two passes' products (``yardstick_ms``), which the port never calls.
``--kernels --k 100`` and ``--shapes 8192x131072 --chains 2`` time the
wider kernels and the biobank panel.  It calls only the routed step, the
rows and columns passes' wrappers and the plain version, so a parent
tree is timed by the same file.

``--accuracy`` measures the float32 kernels' rounding against float64
instead, at K (``--k``): (a) one routed step on the panel of ``--kernels``
at each chain batch of ``--chains``: the raw A + r (``rows_partials`` and
``rows_finish`` at the route's segments), t, eta' and p0' against the
plain step in float64 on the same (float32) inputs, each as its largest
absolute error and its error's norm over the reference's; (b) the
30-iteration warm start of chip_smoke.py's phase 21 (600 x 500, 1 %
missing, ``warm_start_case``) from ``--seeds`` (24 is the phase's): the
fit through the kernels and the float64 fit on the CPU, their logL gap
after iterations 1, 2, 5, 10, 20 and 31 against the float32 noise floor,
and the float32 logL terms of the float64 fit's last parameters (the rows
pass, t only) against their float64 sum, the rounding of the logL alone;
(c) along the float64 trajectory of that warm start, what each step
through the kernels loses in logL against the float64 step from the same
parameters, for the step and for eta' or p0' alone (``warm_start_steps``).
It calls only the routed step, the rows pass's wrappers, the fit and the
plain versions, so a parent tree is measured by the same file.
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


def _errs(got, ref) -> str:
    """Largest absolute error of ``got`` against ``ref`` and the error's
    norm over the reference's, both in float64."""
    d = got.to(torch.float64) - ref.to(torch.float64)
    rel = float(d.norm() / ref.to(torch.float64).norm().clamp(min=1e-300))
    return f"max|d| {float(d.abs().max()):.3e}, |d|/|ref| {rel:.3e}"


def step_accuracy(I: int, L: int, chains, dev) -> None:
    """The routed step's outputs and its raw A + r against the plain step
    in float64 on the same float32 inputs (``--accuracy`` (a))."""
    kw = dict(k_true=K, lb=1e-8, plb=1e-8, project=True)
    planes, miss = device_panel(1, I, L, K, 0.01, dev)
    x0, x1 = planes[0], planes[1]
    c = miss.sum(dim=1, dtype=torch.float32)
    n_sm = fb.device_sm_count(dev)
    for B in chains:
        eta, p0 = device_step_params(2, B, I, L, K, KP, dev)
        route = fb.pick_route(B, I, L, KP, n_sm, fb.scratch_budget(dev), K)
        e64, p64, c64 = eta.double(), p0.double(), c.double()
        got = fb.admixture_fullstep_biallelic_routed(
            eta, p0, x0, x1, c, miss, route=route, **kw)
        ref = fb.admixture_fullstep_biallelic_streamed_reference(
            e64, p64, x0, x1, c64, miss, **kw)
        W = min(L, route.window)
        apart, tpart = fb.rows_partials(eta, p0, x0, x1, l_lo=0, l_hi=W,
                                        seg_cols=route.seg_cols or W,
                                        k_true=K)
        araw, _ = fb.rows_finish(eta, apart, tpart, c, k_true=K, lb=1e-8,
                                 project_eta=True, emit_a=True)
        a_ref, _ = fb.rows_partials_reference(e64, p64, x0, x1, l_lo=0,
                                              l_hi=W)
        print(f"{I} x {L}, K = {K} on {KP} lanes, {B} chains, "
              f"{route.describe()}, against float64: raw A + r of the "
              f"first window {_errs(araw, a_ref[:, 0])}; t "
              f"{_errs(got[1], ref[1])}; eta' {_errs(got[0], ref[0])}; p0' "
              f"{_errs(got[2], ref[2])}", flush=True)
        del eta, p0, e64, p64, got, ref, apart, tpart, araw, a_ref
        torch.cuda.empty_cache()


def warm_start_case(seed: int, I: int = 600, L: int = 500, K: int = 200):
    """chip_smoke.py phase 21's warm start (``phase_wide_reference``, seed
    24) drawn as it draws it from ``seed``: admixture-model counts [I, L,
    2] (each copy draws a cluster from Q_i and an allele from P_k), miss
    [I, L] with 1 % of the copies missing, and the start eta [I, K], p
    [K, L, 2]."""
    rng = np.random.default_rng(seed)
    Q = rng.dirichlet(np.full(K, 0.5), size=I)
    P0 = rng.beta(0.8, 0.8, size=(K, L)).clip(0.01, 0.99)
    miss = rng.binomial(2, 0.01, size=(I, L))
    x0 = rng.binomial(2 - miss, Q @ P0)
    counts = np.stack([x0, 2 - miss - x0], axis=2)
    eta = rng.dirichlet(np.full(K, 2.0), size=I)
    p0 = rng.uniform(0.2, 0.8, size=(K, L))
    return counts, miss, eta, np.stack([p0, 1 - p0], axis=2)


def warm_start_accuracy(seeds, dev) -> None:
    """``--accuracy`` (b): the warm start through the kernels against the
    float64 CPU fit, the gap along the way, and the float32 logL of the
    float64 fit's last parameters."""
    from multiclust_tpu_torch.convert import model_data_from_numpy, \
        params_from_numpy
    from multiclust_tpu_torch.model import admixture as adm
    from multiclust_tpu_torch.model.common import EMConfig, Params
    from multiclust_tpu_torch.opt.driver import fit
    from multiclust_tpu_torch.runtime.multistart import _pad_k, _to_bi_repr

    K_W, at = 200, (1, 2, 5, 10, 20, 31)
    for seed in seeds:
        counts, miss, eta, p = warm_start_case(seed, K=K_W)
        I, L = miss.shape
        mask, n_all = np.ones((L, 2), bool), np.full(L, 2)
        base = dict(admixture=True, has_missing=True, biallelic=True,
                    k_true=K_W, max_iter=30, abs_error=1e-12,
                    eta_lower_bound=1e-8, p_lower_bound=1e-8)
        logl = {"cpu": {}, "gpu": {}}
        md64 = model_data_from_numpy(counts, miss, mask, n_all)
        cpu = fit(params_from_numpy(eta, p), md64, EMConfig(**base),
                  trace=lambda ll, n, kind: logl["cpu"].__setitem__(n, ll))
        cfg = EMConfig(use_pallas="on", **base)
        md32 = model_data_from_numpy(counts, miss, mask, n_all, device=dev,
                                     dtype=torch.float32)
        gpu = fit(_to_bi_repr(_pad_k(params_from_numpy(
            eta, p, device=dev, dtype=torch.float32), cfg), cfg), md32, cfg,
            trace=lambda ll, n, kind: logl["gpu"].__setitem__(n, ll))
        # the phase's floor: from the scale of the float64 fit's terms
        best = cpu.params
        _, scale = adm.log_likelihood(Params(eta=best.eta[None],
                                             p=best.p[None]), md64)
        floor = (cfg.noise_factor * float(np.finfo(np.float32).eps)
                 * float(scale[0]))
        # the float64 fit's last parameters, rounded to float32, on the
        # kernels' layout: their logL terms through the rows pass (t
        # only) and in float64 by the plain version
        Kp = -(-K_W // 32) * 32
        eta_l = torch.zeros((1, I, Kp), dtype=torch.float32, device=dev)
        p0_l = torch.zeros((1, Kp, L), dtype=torch.float32, device=dev)
        eta_l[0, :, :K_W] = best.eta.to(dev, torch.float32)
        p0_l[0, :K_W] = best.p[..., 0].to(dev, torch.float32)
        x0 = torch.tensor(counts[..., 0], dtype=torch.int8, device=dev)
        x1 = torch.tensor(counts[..., 1], dtype=torch.int8, device=dev)
        t32 = fb.rows_log_likelihood_terms(eta_l, p0_l, x0, x1, k_true=K_W)
        _, t64 = fb.rows_partials_reference(eta_l.double(), p0_l.double(),
                                            x0, x1, l_lo=0, l_hi=L,
                                            compute_a=False)
        ll32 = float(t32.to(torch.float64).sum())
        ll64 = float(t64.sum())
        # the kernel fit's last parameters: their logL through the rows
        # pass, in float64 as they stand (d1 = the row's sum - d0) and in
        # float64 with eta's rows scaled to sum to 1; each against the
        # float64 fit's last parameters in float64
        eta_g, p0_g = gpu.params.eta[None], gpu.params.p[None]
        sums = eta_g.double().sum(dim=-1, keepdim=True)
        best64 = (torch.zeros((1, I, Kp), dtype=torch.float64, device=dev),
                  torch.zeros((1, Kp, L), dtype=torch.float64, device=dev))
        best64[0][0, :, :K_W] = best.eta.to(dev)
        best64[1][0, :K_W] = best.p[..., 0].to(dev)

        def terms64(e_, p_) -> float:
            return float(fb.rows_partials_reference(
                e_, p_, x0, x1, l_lo=0, l_hi=L, compute_a=False)[1].sum())

        ll_cpu = terms64(*best64)
        ll_k = float(fb.rows_log_likelihood_terms(
            eta_g, p0_g, x0, x1, k_true=K_W).to(torch.float64).sum())
        ll_raw = terms64(eta_g.double(), p0_g.double())
        ll_norm = terms64(eta_g.double() / sums, p0_g.double())
        to_one = float((sums.float() == 1.0).double().mean())
        gaps = ", ".join(f"{n}: {abs(logl['gpu'][n] - logl['cpu'][n]):.4f}"
                         for n in at if n in logl["gpu"]
                         and n in logl["cpu"])
        print(f"warm start seed {seed}, {I} x {L}, K = {K_W}: "
              f"{gpu.n_iter} / {cpu.n_iter} iterations, logL "
              f"{gpu.logL:.4f} through the kernels against {cpu.logL:.4f} "
              f"in float64: gap {abs(gpu.logL - cpu.logL):.4f}, noise floor "
              f"{floor:.4f}; gap after iteration {gaps}; the float64 fit's "
              f"last parameters in float32, logL through the rows pass "
              f"{ll32:.4f} against {ll64:.4f} in float64: "
              f"{abs(ll32 - ll64):.4f}; the kernel fit's last parameters "
              f"less the float64 fit's, logL through the rows pass "
              f"{ll_k - ll_cpu:+.4f}, in float64 {ll_raw - ll_cpu:+.4f}, "
              f"in float64 with eta's rows summing to 1 "
              f"{ll_norm - ll_cpu:+.4f}; their rows' sums less 1, mean "
              f"{float((sums - 1).mean()):.3e}, {100 * to_one:.1f} % of "
              f"the rows' sums 1 in float32", flush=True)


def warm_start_steps(seeds, dev, n_steps: int = 30) -> None:
    """``--accuracy`` (c): the warm start's float64 trajectory (the plain
    step in float64 on ``dev``), each of its steps also taken through the
    kernels from the same parameters rounded to float32.  Each step's
    deficit is the float64 logL (plain terms) of the kernels' result less
    that of the float64 step's, for the whole step and for eta' or p0'
    alone (the other from float64), and for eta' with its rows scaled to
    sum to 1 in float64 (what is left once the rounding of the rows' sums
    is taken out); summed over the steps.  The rows' sums: the mean of
    sum_k eta'_32 - 1 over the rows and steps.  The shrink is eta''s error
    along the step, <eta'_32 - eta'_64, eta'_64 - eta> over |eta'_64 -
    eta|^2: a step cut short reads below 0."""
    K_W = 200
    Kp = -(-K_W // 32) * 32
    kw = dict(k_true=K_W, lb=1e-8, plb=1e-8, project=True)
    n_sm = fb.device_sm_count(dev)
    for seed in seeds:
        counts, miss, eta, p = warm_start_case(seed, K=K_W)
        I, L = miss.shape
        x0 = torch.tensor(counts[..., 0], dtype=torch.int8, device=dev)
        x1 = torch.tensor(counts[..., 1], dtype=torch.int8, device=dev)
        m = torch.tensor(miss, dtype=torch.int8, device=dev)
        c = m.sum(dim=1, dtype=torch.float64)
        e = torch.zeros((1, I, Kp), dtype=torch.float64, device=dev)
        p0 = torch.zeros((1, Kp, L), dtype=torch.float64, device=dev)
        e[0, :, :K_W] = torch.tensor(eta, device=dev)
        p0[0, :K_W] = torch.tensor(p[..., 0], device=dev)
        route = fb.pick_route(1, I, L, Kp, n_sm, fb.scratch_budget(dev),
                              K_W)

        def logl(eta_, p0_) -> float:
            return float(fb.rows_partials_reference(
                eta_, p0_, x0, x1, l_lo=0, l_hi=L, compute_a=False)[1].sum())

        deficit = np.zeros(4)
        shrink, row_sum = [], []
        for _ in range(n_steps):
            ref = fb.admixture_fullstep_biallelic_streamed_reference(
                e, p0, x0, x1, c, m, **kw)
            got = fb.admixture_fullstep_biallelic_routed(
                e.float(), p0.float(), x0, x1, c.float(), m, route=route,
                **kw)
            ge, gp = got[0].double(), got[2].double()
            sums = ge.sum(dim=-1, keepdim=True)
            row_sum.append(float((sums - 1).mean()))
            base = logl(ref[0], ref[2])
            deficit += (logl(ge, gp) - base, logl(ge, ref[2]) - base,
                        logl(ref[0], gp) - base,
                        logl(ge / sums, ref[2]) - base)
            step = ref[0] - e
            shrink.append(float(((ge - ref[0]) * step).sum()
                                / (step * step).sum()))
            e, p0 = ref[0], ref[2]
        print(f"warm start seed {seed} along the float64 trajectory, "
              f"{n_steps} steps through the kernels ({route.describe()}): "
              f"logL deficit summed {deficit[0]:.5f} (eta' alone "
              f"{deficit[1]:.5f}, p0' alone {deficit[2]:.5f}, eta' alone "
              f"with its rows summing to 1 {deficit[3]:.5f}); rows' sums "
              f"less 1, mean {np.mean(row_sum):.3e}; shrink of eta' along "
              f"the step mean {np.mean(shrink):.3e}, first "
              f"{shrink[0]:.3e}, last {shrink[-1]:.3e}", flush=True)


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


# the generic step's kernels by name, as the profiler sees them.  Above
# 128 lanes d = eta @ p is a launch of its own (wide_cols_d_kernel), on a
# line of its own: a tree whose step shares it runs one a sub-window for
# both passes, a tree whose rows pass computes its own d (wide_rows_kernel,
# the fmaf pass) one for the columns pass alone; the rows pass is then
# the A launch (wide_rows_a_kernel) or that whole pass, the columns pass
# the B launch (or, in a tree of the one-kernel design, wide_cols_kernel)
WIDE_COLS = ("wide_cols_kernel", "wide_cols_b_kernel")
WIDE_ROWS = ("wide_rows_kernel", "wide_rows_a_kernel")
D_LAUNCH = "d launch (wide)"
GENERIC_KERNELS = {"rows pass": ("fullstep_rows_kernel",) + WIDE_ROWS,
                   "rows finish": ("rows_finish_kernel",
                                   "wide_finish_kernel"),
                   D_LAUNCH: ("wide_cols_d_kernel",),
                   "columns pass": ("fullstep_cols_kernel",) + WIDE_COLS,
                   "p epilogue": ("fullstep_p_kernel",)}
# the biallelic step's, on any of its routes (the wide kernels above 128
# lanes)
BI_KERNELS = {"rows pass": ("fullstep_bi_rows_seg_kernel",
                            "fullstep_bi_rows_kernel") + WIDE_ROWS,
              "rows finish": ("rows_finish_kernel", "wide_finish_kernel"),
              D_LAUNCH: ("wide_cols_d_kernel",),
              "columns pass": ("fullstep_bi_cols_kernel",) + WIDE_COLS,
              "p0 epilogue": ("fullstep_bi_p0_kernel",)}


def bi_step_unshared(eta, p0, x0, x1, c, miss=None, kmask=None, *,
                     window: int, seg_cols: int, k_true: int, lb: float,
                     plb: float, project: bool, compute_t: bool = True,
                     emit_b: bool = False, emit_a: bool = False,
                     project_eta=None, a0=None, n_rseg: int = 0):
    """The chunked biallelic step in the order that runs d for each pass
    (at a wide Kp: d + A, then d + B, a window), from the public pieces:
    ``rows_partials`` and ``rows_finish``, then ``cols_window``.  What one
    d for both passes saves is the routed step's time against this one's;
    arguments and returns as ``admixture_fullstep_biallelic_chunked``
    (``seg_cols`` given)."""
    L = p0.shape[-1]
    window = min(int(window), L)
    if project_eta is None:
        project_eta = project
    outs = ((torch.empty_like(p0), torch.empty_like(p0)) if emit_b
            else (torch.empty_like(p0),))
    t_sum = None
    for l_lo in range(0, L, window):
        l_hi = min(L, l_lo + window)
        apart, tpart = fb.rows_partials(
            eta, p0, x0, x1, l_lo=l_lo, l_hi=l_hi,
            seg_cols=min(seg_cols, l_hi - l_lo), compute_t=compute_t,
            k_true=k_true)
        a0, t = fb.rows_finish(eta, apart, tpart, c, a0, kmask,
                               k_true=k_true, lb=lb, project_eta=project_eta,
                               compute_t=compute_t,
                               emit_a=emit_a or l_hi < L)
        t_sum = t if t_sum is None else t_sum + t
        fb.cols_window(eta, p0, x0, x1, miss, outs, l_lo=l_lo, l_hi=l_hi,
                       plb=plb, project=project, k_true=k_true,
                       n_rseg=n_rseg)
    return (a0, t_sum) + outs


def generic_step_unshared(eta, p2, x2, c, miss, mask, *, k_true: int,
                          lb: float, plb: float, project: bool,
                          compute_t: bool = True):
    """The generic step in the order that runs d for each pass, from the
    public pieces ``fullstep_rows`` and ``fullstep_cols``; arguments and
    returns as ``admixture_fullstep``."""
    eta_new, t = fs.fullstep_rows(eta, p2, x2, c, k_true=k_true, lb=lb,
                                  project=project, compute_t=compute_t,
                                  M=mask.shape[1])
    return eta_new, t, fs.fullstep_cols(eta, p2, x2, miss, mask,
                                        k_true=k_true, plb=plb,
                                        project=project)


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
        wide = {}
        if fb.is_wide(KP):
            wide = wide_rows_times(eta, p0, x0, x1, c, route, n)
            # the order that runs d for each pass: d + A, then d + B
            wide["step, unshared d"] = median_ms(
                lambda: bi_step_unshared(
                    eta, p0, x0, x1, c, miss, window=route.window,
                    seg_cols=route.seg_cols, n_rseg=route.n_rseg, **kw), n)
            if route.seg_cols < route.window:
                # the router's column segments against one
                one = route._replace(seg_cols=route.window)
                wide["step, one rows segment"] = median_ms(
                    lambda: fb.admixture_fullstep_biallelic_routed(
                        eta, p0, x0, x1, c, miss, route=one, **kw), n)
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
        # the passes' operations: the cells, d (2 K a cell), A (2 K) and
        # B0/B1 (4 K); above 128 lanes d is a launch of its own line and
        # each pass's line is held to its own launch's work (a tree whose
        # rows pass computes d itself does more than its line's bound)
        d_flop = 0 if fb.is_wide(KP) else 2 * K
        bounds = {
            "rows pass": bound_ms((eta, p0, x0, x1, c, eta, c),
                                  (2 * K + d_flop + 10) * cells),
            "rows pass alone (d + A)": bound_ms(
                (eta, p0, x0, x1, c, eta, c), (4 * K + 10) * cells),
            "rows finish": (tuple(b / HBM_BYTES_PER_S * 1e3 for b in fin)
                            if fin[0] else None),
            "columns pass": bound_ms((eta, p0, x0, x1, miss, p0),
                                     (4 * K + d_flop + 6) * cells),
            D_LAUNCH: bound_ms((eta, p0), 2 * K * cells),
            "p0 epilogue": tuple(b / HBM_BYTES_PER_S * 1e3 for b in epi)}
        print(f"{I} x {L}, K = {K} on {KP} lanes, {B} chains: router "
              f"{route.describe()}; routed step {step_ms:.4f} ms on CUDA "
              f"events", flush=True)
        for label, ms in dev_ms.items():
            print(_kernel_line(label, ms, bounds[label]), flush=True)
        # the wide passes on CUDA events: the rows pass and its finish
        # alone with their bounds (the finish's both ways), the step in the
        # order that runs d for each pass
        wide_bounds = {"rows pass alone (d + A)":
                       bounds["rows pass alone (d + A)"],
                       "rows finish alone": bounds["rows finish"]}
        for label, ms in wide.items():
            print(_kernel_line(label, ms, wide_bounds.get(label)).replace(
                "of device time a step", "on CUDA events"), flush=True)
        print(_yardstick_line(yardstick_ms(eta, p0, 2 * L, n)), flush=True)
        del eta, p0
        torch.cuda.empty_cache()


def yardstick_ms(eta, p, lanes: int, n: int) -> dict:
    """The float32 ``torch.matmul`` yardstick of an admixture step's two
    passes, a library call the port never makes (TF32 off), on the K live
    lanes: the rows pass's products d = eta p and A = w p^T, the columns
    pass's d and B = eta^T w over ``lanes`` columns of w (the x0 and x1
    planes: 2 L; or L x M); CUDA-event ms of each pass's pair."""
    assert not torch.backends.cuda.matmul.allow_tf32
    B, I, _ = eta.shape
    e_k, p_k = eta[..., :K].contiguous(), p[:, :K].contiguous()
    w = torch.rand((B, I, lanes), device=eta.device)
    w1 = w[..., :p_k.shape[-1]].contiguous()
    out = {"rows (d, A)": median_ms(
               lambda: (e_k @ p_k, w1 @ p_k.transpose(1, 2)), n),
           "columns (d, B)": median_ms(
               lambda: (e_k @ p_k, e_k.transpose(1, 2) @ w), n)}
    del e_k, p_k, w, w1
    torch.cuda.empty_cache()
    return out


def _yardstick_line(yard: dict) -> str:
    return ("  yardstick, not a route of the port: float32 matmuls of the "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in yard.items())
            + f", together {sum(yard.values()):.3f} ms on CUDA events")


def wide_rows_times(eta, p0, x0, x1, c, route, n: int) -> dict:
    """CUDA-event ms of the wide rows pass alone through ``rows_partials``
    (its d and A launches, or the fmaf pass of a tree before them) at the
    route's segments, and of its finish alone on those partials."""
    L = p0.shape[-1]
    win = dict(l_lo=0, l_hi=min(L, route.window), k_true=K)
    seg = route.seg_cols or route.window
    apart, tpart = fb.rows_partials(eta, p0, x0, x1, seg_cols=seg, **win)
    fin = dict(k_true=K, lb=1e-8, project_eta=True)
    out = {"rows pass alone (d + A)": median_ms(
        lambda: fb.rows_partials(eta, p0, x0, x1, seg_cols=seg, **win), n),
        "rows finish alone": median_ms(
            lambda: fb.rows_finish(eta, apart, tpart, c, **fin), n)}
    del apart, tpart
    return out


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
        unshared = ""
        if fb.is_wide(KP):
            # the order that runs d for each pass: d + A, then d + B
            un_ms = median_ms(lambda: generic_step_unshared(
                eta, p2, x2, c, miss, mask, **kw), n)
            unshared = f", unshared d {un_ms:.3f} ms"
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
        d_flop = 0 if fb.is_wide(KP) else 2 * K   # as time_bi_kernels
        bounds = {"rows pass": bound_ms((eta, p2, x2, c, eta, c),
                                        (2 * K + d_flop + 5) * lanes),
                  "rows finish": ms_of(finish_bytes(B, I, KP, n_cseg, kc)),
                  "columns pass": bound_ms((eta, p2, x2, miss, p2),
                                           (2 * K + d_flop + 3) * lanes),
                  D_LAUNCH: bound_ms((eta, p2), 2 * K * lanes),
                  "p epilogue": ms_of(p_bytes(B, KP, L * M, n_rseg,
                                              min(kc, KP)))}
        print(f" {B} chains: step {step_ms:.3f} ms (plain {plain_ms:.3f})"
              f"{unshared}; columns pass + p epilogue {cols_ms:.3f} ms on "
              f"CUDA events", flush=True)
        for label, ms in dev_ms.items():
            print(_kernel_line(label, ms, bounds[label]), flush=True)
        # the sweep statistics (admixture_sweep_fused / _stats): both
        # passes with finish=False, against both yardstick pairs
        sweep_ms = median_ms(lambda: fs.admixture_sweep_stats(
            eta, p2, x2, miss, M=M, k_true=K), n)
        print(f"  sweep statistics {sweep_ms:.3f} ms on CUDA events",
              flush=True)
        print(_yardstick_line(yardstick_ms(eta, p2, L * M, n)), flush=True)
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
# its own); a tree before the one finish launch ran the eta finish and
# the p0 epilogue as two kernels, named here so that this file times such
# a parent too
MIXTURE_KERNELS = {"rows pass": ("mix_rows_kernel", "mix_rows_wide_kernel"),
                   "rows softmax (wide)": ("mix_softmax_kernel",),
                   "columns pass": ("mix_cols_kernel",
                                    "mix_cols_wide_kernel"),
                   "finish": ("mix_finish_kernel",),
                   "eta finish (parent)": ("mix_eta_kernel",),
                   "p0 epilogue (parent)": ("mix_p_kernel",)}
# the finish's kernels, the one launch or a parent's two
FINISH_KERNELS = {"finish": ("mix_finish_kernel", "mix_eta_kernel",
                             "mix_p_kernel")}


def device_ops(fn) -> list:
    """Names of the device operations (kernels, copies, fills) that one
    call of ``fn`` ran, in the order they started (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    return [e.name for e in sorted(evs, key=lambda e: e.time_range.start)]


def michelot_passes(w, k_true: int, lb: float):
    """Passes of the warp Michelot (csrc/simplex.cuh) on each row of ``w``
    [B, Kp] (eta before its projection), counted by running its loop in
    float32 on the host: a pass subtracts the surplus from the free lanes
    and pins those that fall below ``lb``; the loop ends after a pass that
    pins none or leaves none free.  Returns one count a row."""
    w = w.detach().float().cpu().clone()
    fr = torch.arange(w.shape[-1])[None] < k_true
    fr = fr.expand_as(w).clone()
    w[~fr] = 0.0
    nf = fr.sum(dim=-1)
    active = torch.ones(w.shape[0], dtype=torch.bool)
    passes = torch.zeros(w.shape[0], dtype=torch.int64)
    while active.any():
        off = (w.sum(dim=-1) - 1.0) / nf.clamp(min=1).float()
        w2 = w - off[:, None]
        live = fr & active[:, None]
        pin = live & (w2 < lb)
        w = torch.where(live, torch.where(pin, torch.full_like(w, lb), w2),
                        w)
        fr = fr & ~pin
        left = fr.sum(dim=-1)
        passes += active
        active = active & (left < nf) & (left > 0)
        nf = left
    return passes


def mix_finish_bytes(B: int, n_seg: int, ns: int, k: int, L: int,
                     params: bool) -> float:
    """Bytes the mixture's finish must move over ``k`` lanes: the B partials and the
    v sums read once; eta', vtot and p0' [B, k, L] written once, or the
    model's eta [B, k] and p [B, k, L, 2]."""
    read = n_seg * ns * k * L + n_seg * k
    written = k + 2 * k * L if params else 2 * k + k * L
    return 4 * B * (read + written)


def _eta_only(out):
    """eta' of ``mixture_eta``, which in a parent tree also returned vtot."""
    return out[0] if isinstance(out, tuple) else out


def time_finish_halves(part, vpart, n: int) -> None:
    """The finish's halves alone on the step's partials, launched back to
    back (the partials in L2, as after the columns pass): the eta half
    (``mixture_eta``) as it runs, with its segment loop cut to the first
    segment and with its Michelot cut (projection off), the p half (with
    the one launch: its p0 update, vtot summed from the v partials as in
    the step; in a parent: ``mixture_p`` on the eta finish's vtot), and
    where the tree has the one launch (``mixture_finish``) both halves
    together in either layout; device ms a launch (torch.profiler) and
    CUDA-event ms of a call, and the Michelot passes the step's eta
    takes."""
    ekw = dict(k_true=K, lb=1e-8, project=True)
    one = vpart[:, :1].contiguous()
    calls = {
        "eta half": lambda: mb.mixture_eta(vpart, **ekw),
        "eta half, one segment": lambda: mb.mixture_eta(one, **ekw),
        "eta half, no Michelot": lambda: mb.mixture_eta(
            vpart, k_true=K, lb=1e-8, project=False)}
    if hasattr(mb, "mixture_finish"):
        p0 = torch.empty((part.shape[0],) + part.shape[3:],
                         device=part.device)
        calls["p half"] = lambda: mb._launch_finish(
            part, vpart, out0=p0, plb=1e-8, ploidy=2, project=True)
        fkw = dict(ekw, plb=1e-8, ploidy=2)
        calls["finish, both halves"] = lambda: mb.mixture_finish(
            part, vpart, **fkw)
        calls["finish, the model's layout"] = lambda: mb.mixture_finish(
            part, vpart, params=True, **fkw)
    else:
        _, vtot = mb.mixture_eta(vpart, **ekw)
        calls["p half"] = lambda: mb.mixture_p(part, vtot, plb=1e-8,
                                               ploidy=2, project=True)
    for label, fn in calls.items():
        dev_ms = kernel_device_ms(fn, n, FINISH_KERNELS)["finish"]
        print(f"  {label} alone ({part.shape[1]} segments): "
              f"{dev_ms:.4f} ms of device time a launch, "
              f"{median_ms(fn, n):.4f} ms on CUDA events", flush=True)
    w = _eta_only(mb.mixture_eta(vpart, k_true=K, lb=1e-8, project=False))
    passes = michelot_passes(w, K, 1e-8)
    print(f"  Michelot passes on this step's eta: {passes.tolist()} (one a "
          f"chain)", flush=True)
    del one, calls


def time_eta_after(args, vpart, n: int) -> None:
    """The eta finish (``mixture_eta`` on the step's v partials; a
    parent's M3) timed after each kind of work that can precede it: itself
    (launched back to back), the rows pass, the columns pass (its v
    partials new, as in the step), a 256 MiB fill (the 50 MB L2 flushed:
    the partials and the kernel's code read from HBM), and an idle wait of
    ~50 us (torch.cuda._sleep).  Device ms of the eta launch alone
    (torch.profiler), so that its time in the step can be set beside
    these."""
    ekw = dict(k_true=K, lb=1e-8, project=True)
    lp0, x0, bias, lp1, x1 = args
    v, _ = mb.mixture_rows(lp0, x0, bias, lp1, x1, k_true=K)
    flush = torch.empty(64 * 2 ** 20, device=vpart.device)

    def cols_then_eta():
        _, vp = mb.mixture_partials(v, x0, x1, k_true=K)
        mb.mixture_eta(vp, **ekw)

    before = {
        "itself": lambda: None,
        "the rows pass": lambda: mb.mixture_rows(lp0, x0, bias, lp1, x1,
                                                 k_true=K),
        "a 256 MiB fill": lambda: flush.fill_(1.0),
        "an idle wait of ~50 us": lambda: torch.cuda._sleep(100_000)}
    eta_names = {"eta": ("mix_eta_kernel", "mix_finish_kernel")}
    for label, pre in before.items():
        def fn(pre=pre):
            pre()
            mb.mixture_eta(vpart, **ekw)
        ms = kernel_device_ms(fn, n, eta_names)["eta"]
        print(f"  eta finish after {label}: {ms:.4f} ms of device time a "
              f"launch", flush=True)
    ms = kernel_device_ms(cols_then_eta, n, eta_names)["eta"]
    print(f"  eta finish after the columns pass: {ms:.4f} ms of device "
          f"time a launch", flush=True)
    del v, flush


def time_sweep(args, n: int) -> None:
    """``mixture_sweep_stats`` (rows, columns, the raw p half: the finish
    launch without its eta half, or a parent's raw ``mix_p_kernel``): the
    call on CUDA events and the raw p half's device ms."""
    def sweep():
        return mb.mixture_sweep_stats(*args, k_true=K)

    raw = kernel_device_ms(sweep, n, {"raw": ("mix_finish_kernel",
                                              "mix_p_kernel")})["raw"]
    print(f"  sweep statistics: {median_ms(sweep, n):.3f} ms on CUDA "
          f"events; its raw p half {raw:.4f} ms of device time a call",
          flush=True)


def time_model_step(I: int, L: int, B: int, two: bool, n: int, dev) -> None:
    """``model.mixture.em_step`` (the kernel route, K-padding, the logL
    terms and the parameters in the model's layout included) on CUDA
    events, the device operations it runs (torch.profiler: how many, and
    the last one) and the finish's device time in it; the panel and the
    parameters drawn on the card (``device_panel``, 2 % missing with
    ``two``)."""
    from multiclust_tpu_torch.model import mixture
    from multiclust_tpu_torch.model.common import EMConfig, Params, \
        model_data_from_planes

    seed = 90 + B
    md = model_data_from_planes(*device_panel(seed, I, L, K,
                                              0.02 if two else 0.0, dev))
    gen = torch.Generator(device=dev).manual_seed(seed)
    eta = torch.rand((B, K), generator=gen, device=dev) + 0.1
    p0 = torch.rand((B, K, L), generator=gen, device=dev) * 0.96 + 0.02
    params = Params(eta=eta / eta.sum(dim=-1, keepdim=True),
                    p=torch.stack([p0, 1.0 - p0], dim=-1))
    cfg = EMConfig(admixture=False, use_pallas="on", biallelic=True,
                   has_missing=two, ploidy=2)

    def step():
        return mixture.em_step(params, md, cfg)

    ops = device_ops(step)
    finish_ms = kernel_device_ms(step, n, FINISH_KERNELS)["finish"]
    print(f"  model step (em_step): {median_ms(step, n):.3f} ms on CUDA "
          f"events, {len(ops)} device operations a step, the last "
          f"{ops[-1][:60] if ops else None}; the finish "
          f"{finish_ms:.4f} ms of device time in it", flush=True)
    del params, md


def fit_michelot_passes(I: int, L: int, dev) -> None:
    """Michelot passes of the eta finish along chip_smoke.py's mixture fits
    at K (phase 22's panel, seed 460 + K, missing-free, 2 chains, cap 30;
    at K = 20 phase 10's, seed 80, cap 100): each step's v sums recorded
    from the columns pass and counted by ``michelot_passes``."""
    from multiclust_tpu_torch.api import fit_model_data
    from multiclust_tpu_torch.model import mixture
    from multiclust_tpu_torch.model.common import model_data_from_planes

    seed = 80 if K <= 128 else 460 + K
    md = model_data_from_planes(*mixture_planes(seed, I, L, K, 0.0, dev))
    seen = []
    patched = [m for m in (mb, mixture) if hasattr(m, "mixture_partials")]
    real = mb.mixture_partials

    def record(*a, **kw):
        part, vpart = real(*a, **kw)
        seen.append(vpart.sum(dim=1).cpu())
        return part, vpart

    for m in patched:
        m.mixture_partials = record
    try:
        res = fit_model_data(md, 2, admixture=False, min_K=K, max_K=K,
                             n_init=2, max_iter=100 if K <= 128 else 30,
                             seed=3, verbosity=0).best
    finally:
        for m in patched:
            m.mixture_partials = real
    passes = torch.cat([michelot_passes(v / v.sum(dim=-1, keepdim=True), K,
                                        1e-8) for v in seen])
    print(f"fit at K = {K} ({res.n_iter_all} iterations over the chains): "
          f"Michelot passes of the eta finish over {len(seen)} steps x 2 "
          f"chains: min {int(passes.min())}, median "
          f"{float(passes.float().median()):.0f}, max {int(passes.max())}",
          flush=True)


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
            # the finish (or a parent's eta finish and p0 epilogue
            # together) moves the partials and its outputs once
            v_k, _ = mb.mixture_rows(lp0, x0, bias, lp1, x1, k_true=K)
            parts, vparts = mb.mixture_partials(v_k, x0, x1, k_true=K)
            del v_k
            n_seg = parts.shape[1]
            live = {params: mix_finish_bytes(B, n_seg, ns, K, L, params)
                    / HBM_BYTES_PER_S * 1e3 for params in (False, True)}
            fin = sum(ms for label, ms in dev_ms.items()
                      if label in ("finish", "eta finish (parent)",
                                   "p0 epilogue (parent)"))
            bounds["finish"] = live[False]
            print(f"mixture {I} x {L}, {streams}, {B} chains: step "
                  f"{step_ms:.3f} ms (plain {plain_ms:.3f}, plain rows pass "
                  f"{plain_rows_ms:.3f}) on CUDA events", flush=True)
            for label, ms in dev_ms.items():
                line = f"  {label}: {ms:.4f} ms of device time a step"
                if not ms and label in bounds:
                    line = f"  {label}: not measured (no device events)"
                elif not ms:
                    continue   # no softmax narrow, one finish or two
                elif label in bounds:
                    line += (f"; bound {bounds[label]:.4f} ms, "
                             f"{100 * bounds[label] / ms:.1f} % of it")
                print(line, flush=True)
            print(f"  finish launches together: {fin:.4f} ms of device time "
                  f"a step over {n_seg} segments; bound from the live lanes "
                  f"{live[False]:.4f} ms (eta', vtot, p0' [B, K, L]), "
                  f"{live[True]:.4f} ms in the model's layout (p [B, K, L, "
                  f"2])", flush=True)
            time_finish_halves(parts, vparts, n)
            time_eta_after(args, vparts, n)
            time_sweep(args, n)
            time_model_step(I, L, B, two, n, dev)
            del args, v, t, part, parts, vparts
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
    fit_michelot_passes(I, L, dev)


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
    ap.add_argument("--accuracy", action="store_true")
    ap.add_argument("--seeds", default="24,25,26")
    args = ap.parse_args(argv)
    K, KP = args.k, -(-args.k // 32) * 32
    if args.shapes:
        SHAPES = tuple(tuple(int(n) for n in s.split("x"))
                       for s in args.shapes.split(","))
    elif (args.generic or args.mixture or args.jagged or args.kernels
          or args.finish_alone or args.squarem or args.accuracy):
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
        elif args.accuracy:
            step_accuracy(I, L, chains, dev)
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
    if args.accuracy:
        seeds = [int(s) for s in args.seeds.split(",")]
        warm_start_steps(seeds, dev)
        warm_start_accuracy(seeds, dev)
    print(f"peak allocation "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
