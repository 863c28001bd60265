"""Smoke run of the PyTorch/CUDA port on one GPU: the admixture and mixture
main paths at the full panel width, through their hand-written CUDA
kernels, for biallelic and for multi-allelic panels.

Run from the root of a checkout with ``python3 chip_smoke.py``.  Phases,
each raising on failure:

1. device: a CUDA device is required; prints the card's name and limit;
2. build: compiles ``multiclust_tpu_torch/csrc/*.cu`` with nvcc, one nvcc
   per source, concurrently;
3. kernels: the biallelic EM-step kernel pair against its plain PyTorch
   version at I=16384, L=2048, K=20 (Kp=32), chain batches 1 and 4,
   missing 0 % and 2 %, logL terms on and off; median CUDA-event times;
   each pass of the pair alone at chain batches 2 and 32 (the batch at
   which the router gives this panel to the pair); the streamed step as
   the router splits this panel for chain batches 1, 2 and 4 (its column
   segments and row segments), each of its kernels against plain, the p0
   epilogue also alone on partials of the route's row segments; the raw
   sums of the finish and of the epilogue bit-equal to the partials added
   in segment order, and so the t of the t-only finish (SQUAREM's logL
   terms); the two reductions' times with their bounds, the live lanes
   they read and every tensor once;
4. fit: ``api.fit_dataset`` on a simulated 16384 x 2048, K=20 biallelic
   panel: 2 chains (plain EM with the adaptive interval, then SQUAREM),
   which the router sends down the streamed route, then 32 chains in
   lockstep, which it gives to the pair; the kernel launch counts of each
   run on its own, counted from 0; then a small warm-start fit held to
   the float64 CPU path;
5. CLI: ``multiclust_tpu_torch.cli.main`` on a 1024 x 1000, K=3 STRUCTURE
   file with 5 % missing;
6. generic kernels: the multi-allelic rows pass, columns pass and p
   epilogue (its raw B bit-equal to the partials added in segment order,
   its bound both ways) against their plain versions at I=16384, L=2048,
   M=4, K=20,
   chain batches 1, 2 and 4 with the segments the wrappers pick, missing
   0 % and 2 %, logL terms on and off; a jagged panel (80 % M=2, 20 % M=8
   loci, dense at M=8); each pass alone beside a yardstick the port never
   calls (the two float32 matmuls of its shapes); the sweep statistics and
   an a0 / emit_a chain; the rows and columns passes at Kp = 64 and 128 on
   an unaligned panel, rerun bit-equal, and their compiler report;
7. generic fits: ``api.fit_dataset`` on a simulated 16384 x 2048, M=4,
   K=20 panel with 1 % missing (plain EM with the adaptive interval, then
   SQUAREM), with the generic kernels' launch counts and the codes'
   counts kernel's (``mc_allele_counts``: one launch a window of each
   start, every window counted); then a small warm-start M=5 fit held to
   the float64 CPU path;
8. generic CLI: a 512 x 200 STRUCTURE file with 3-6 alleles per locus and
   5 % missing, SQUAREM from Rand-EM starts;
9. mixture kernels: the biallelic mixture step (rows pass, columns pass,
   the finish: one launch each) and the sweep statistics against their
   plain versions at I=16384, L=2048, K=20 (Kp=32), chain batches 1 and
   4, missing 0 % (one stream, the ploidy fold) and 2 % (two streams),
   the columns pass with the segments its wrapper picks; the finish on
   those partials in both layouts, its vtot and raw B0 (B1) bit-equal to
   the ordered segment sums; each pass alone at
   the fit's shape, beside a yardstick the port never calls (one
   torch.matmul of each pass's product, float64 and float32); the sweep's
   launches, counted on a call of its own (no fit calls it); the step at
   Kp = 128 on an unaligned panel, rerun bit-equal, and the compiler's
   report of the two contraction kernels;
10. mixture fits: ``api.fit_dataset(admixture=False)`` on a 16384 x 2048,
   K=20 biallelic panel simulated under the mixture model (plain EM with
   the adaptive interval and SQUAREM, missing-free; plain EM with 1 %
   missing), with the mixture kernels' launch counts; a small warm-start
   fit held to the float64 CPU path; one M=4 mixture fit through the plain
   route (its eta and p finish on the card);
11. mixture CLIs: a 1024 x 1000, K=3 STRUCTURE file with 5 % missing,
   fitted without -a and with -a -c;
12. biobank kernels: on a panel made on the card from a seed, 8192 x
   131072, K=20, 1 % missing, chain batches 1 and 2: the three routes of
   the biallelic step (the pair, the streamed step with its segmented rows
   pass and finish kernel, the chunked loop over column windows) against
   the plain version, which works in column windows; logL terms on and
   off, emit_a / emit_b once; each pass alone, the p0 epilogue on
   partials of the route's row segments; the rows passes again at
   2048 x 524288; then the two redesigned kernels at Kp = 64 and 128, on
   an unaligned panel (1000 x 1003) and on a window with an odd start,
   each against its plain version and rerun bit-equal, the compiler's
   register / shared-memory / spill report of them, of the rows finish
   and of the generic p epilogue, and their share of the bound;
13. biobank fits: ``api.fit_model_data`` on that panel, 2 chains, plain EM
   with the adaptive interval and then SQUAREM, iteration cap 50, and one
   plain-EM fit at 2048 x 524288, which the router sends down the chunked
   loop; the route, iterations/s, cells/s and the peak allocation; the
   admixture starts' counts launch once a window of each start (16
   windows a start on both panels), read from the int8 count planes
   (``mc_allele_counts_planes``; the codes' kernel not at all);
14. biobank reference: a warm-start 30-iteration fit at 256 x 131072
   through the kernels, held to the float64 CPU fit;
15. biobank mixture: the mixture step and the sweep at 8192 x 131072, 2
   chains, one stream and two (1 % missing), against their plain
   versions with the row segments the columns wrapper picks (one segment
   of 256 stages on an H100), and the columns pass alone on a soft v;
   then one mixture fit at that shape through the mixture kernels;
16. biobank CLI: a 512 x 8192 STRUCTURE file, ``-a -k 3``, down the
   streamed route;
17. bootstrap: ``api.fit_model_data`` with ``-k 3 -b 16 -n 2`` on two
   16384 x 2048 panels, 1 % missing (the mixture-model one drawn on the
   host and uploaded, the admixture-model one made on the card): the
   mixture model on a mixture-model panel, and ``-a`` (iteration cap 100)
   on an admixture-model panel; each replicate fit as a lattice of 16 x 2
   chains through the kernels of its route, with the launches counted
   from 0 on each run; replicate 0 refitted alone from the same starts
   (``fit_batch``) to the lattice's statistic; one lattice step at that
   shape under ``torch.cuda.set_sync_debug_mode("error")``; the admixture
   run again with ``--checkpoint`` into a fresh directory, under
   ``torch.profiler`` (the device's busy share), and once more from it
   (same statistics, no kernel launched); then ``-w n 2`` and ``-v 4``
   CLI runs on phase 16's file;
18. jagged: jagged-M bucketing (model/bucketed.py) on the jagged mix of
   bench.py:199-201 made on the card, 16384 x 2048, K=20, 80 % M=2 + 20 %
   M=8 loci interleaved, 1 % missing, 2 chains: the bucketed step through
   the generic kernels (one launch chain a bucket, launches counted)
   against its plain version and the dense step on the same parameters;
   plain EM and SQUAREM fits through ``api.fit_model_data``, bucketed and
   with the dense layout forced (``worth_bucketing`` patched, as the tests
   force it): iterations, logL gap against the noise floor, walls, useful
   cells/s (I x sum_l M_l a chain iteration); a microsatellite-like panel
   (2..20 alleles a locus, the 8-bucket cap); a -b 4 -k 3 -n 2 bootstrap
   and a mixture fit on the jagged panel;
19. mesh (runtime/mesh.py over torch.distributed): (a) NCCL at world size
   1 on the card through ``initialize_distributed`` with a ``file://``
   init: all_reduce in float32 and float64, broadcast, the row gather and
   both subgroups on card tensors; (b) 2 and 4 ranks on the one card over
   an explicit gloo group, as child processes of this script (each with a
   timeout; a child that fails, hangs or disagrees fails the phase), on
   2x1, 1x2 and 2x2 meshes: the main path's 16384 x 2048, K = 20, 2
   chains, 1 % missing, made from seeds on the card: one meshed biallelic
   step (the sharded variants ``emit_b``, and ``emit_a`` with the loci
   split) and one generic M = 4 step (``finish=False``; the sweep
   statistics with the loci split), each held to the unsharded kernel
   step; on 2x1 a plain-EM fit from the same start held to the unsharded
   fit's logL within the float32 noise floor of opt/em.py.  The unsharded
   steps and fit run in this process before any process group exists.
   Each rank's launches are counted from 0 before its meshed step, and
   the wrappers it called are recorded with their sharded-variant flags:
   the kernels line's ``mesh`` entry holds both, shape by shape.  These
   ranks share one card: their times are no multi-GPU speed;
20. per-process ingest (runtime/ingest.py): one 16384 x 2048 biallelic
   STRUCTURE file, 1 % missing, from a seed; the CLI at ``-a -k 20 -n 2 -T
   30`` on it single-process, as 2x1 and 2x2 gloo ranks on the one card
   and through ``cli.main_meshed`` at NCCL world size 1, all at once, each
   a child process of this script (``--ingest-child``, with a timeout).
   Each rank's rows parsed, ModelData bytes (its block's, exactly), peak
   allocation at the end of ingest (a 2x1 rank at most 0.6 of the
   single-process run's) and of the run, host max RSS and wall; each run's
   ``.part`` files joined in data-index order and rank 0's files held to
   the single-process files (logL within the float32 noise floor of
   opt/em.py, tables within 1e-4); the ranks' launches and sharded
   variants go into the ``mesh`` entry as ``ingest 2x1`` and so on;
21. K above 128 (the wide kernels of csrc/wide.cuh): at K = 200 (224
   lanes) and K = 1024 on a 16384 x 2048 panel, 1 % missing, 1 and 2
   chains, the router's route and segments: the wide rows pass, its
   finish and the wide biallelic columns pass (a d launch and a B launch
   on the float64 tensor cores a column sub-window) each against its
   plain version, the routed step and the t-only logL terms, reruns
   bit-equal, the finish's raw sums and t and the columns pass's raw
   B0/B1 (emit_b) bit-equal to the ordered sums of their partials, each
   kernel's time at 2 chains on CUDA events (the biallelic columns pass
   with the p0 epilogue its launcher runs) beside its plain version and
   bound; every variant (compute_t off, emit_b, emit_a / a0,
   kmask, project_eta off, project off, windows) on a ragged 1001 x 4099
   panel; the generic step at M = 4 and on a ragged 1001 x 333 x M = 3
   panel with the sweep statistics and an a0 / emit_a chain, the wide
   generic columns pass timed on CUDA events, the rows and columns
   passes beside the float32 matmuls of their contractions; fits through
   ``api.fit_model_data`` at K = 200 (plain EM and SQUAREM, cap 30; M = 4
   and the jagged mix, cap 10) and K = 1024 (cap 10), each run's wide
   launches counted from 0; a 600 x 500 warm-start fit at K = 200 within
   the float32 noise floor of the float64 CPU fit; ``-a -k 200 -n 2 -T
   30`` through the CLI on a 16384 x 2048 file; a 2x1 gloo step at K =
   200 (``--wide-mesh-child``) held to the unsharded one; a step at 1056
   lanes, which takes the plain step, launches nothing and prints its
   notice once; the compiler's report of the wide kernels, none
   spilling.  The kernels line's wide records carry their times at K =
   200 and, under ``kp1024``, at K = 1024, and the columns passes'
   records the registers of their two kernels;
22. the mixture above 128 lanes (the wide kernels of csrc/mixture_bi.cu):
   at K = 200 (224 lanes) and K = 1024 on 16384 x 2048, chain batches 1
   and 2, one stream (missing-free) and two (1 % missing): the wide rows
   pass (scores and softmax), columns pass and finish each against its
   plain version, the step and the sweep, reruns bit-equal, v and the
   partials 0 past K, the finish's vtot and raw B bit-equal to the
   ordered segment sums; each kernel's time at 2 chains, one stream, on CUDA
   events beside its plain version's, its bound and one float64
   torch.matmul of its product; every Kp of the range on a ragged 1001 x
   4099 panel (and 130 live lanes of 512); fits through
   ``api.fit_model_data`` at K = 200 (plain EM
   and SQUAREM, cap 30, and plain EM at 1 % missing) and K = 1024 (cap
   10), an M = 4 and a jagged panel at K = 200 (cap 10; the finish's eta
   half and the generic p epilogue at 200 lanes), each run's launches
   counted from 0; a 600 x 500 warm-start fit at K = 200 within the
   float32 noise floor of the float64 CPU fit; ``-k 200 -n 2 -T 30``
   through the CLI on a 16384 x 2048 file; steps at 1056 lanes, which
   take the plain step, launch nothing and print nothing; the compiler's
   report of the wide mixture kernels, none spilling.  Their records in
   the kernels line carry the times at K = 200 and, under ``kp1024``, at
   K = 1024;
23. the mixed-K sweep (``MULTICLUST_SWEEP_MODE``, runtime/ksweep.py):
   K-sweeps through ``api.fit_model_data`` in the modes ``static``,
   ``merged`` (every K's chains in one lattice, each chain's true lanes
   its ``Params.kmask``) and ``shared`` (the serial loop, as ``static``),
   same seed and iteration cap: admixture on phase 1's 16384 x 2048
   biallelic panel (1 % missing), K = 2..20, -n 8, plain EM, cap 20 (152
   chains in the lattice); the mixture there, K = 2..20, -n 4; the M = 4
   generic admixture panel of phase 8, K = 2..8, -n 4; and a wide case,
   K = 129..140 (160 lanes) on 4096 x 2048, -n 2, admixture and mixture,
   cap 8.  Where the lattice runs the biallelic step on another route
   than the serial fits (the pair where 8 chains take the streamed step),
   the static sweep runs once more with every step forced onto the
   lattice's route.  Per K: launched chains, iterations, best logL and its
   difference from ``static``, the AIC and BIC choice, and each mode's
   wall with the model steps it ran and the chain-steps they computed.
   ``shared`` must equal ``static`` exactly; ``merged`` must lie within
   the float32 noise floor of opt/em.py for the panel (noise_factor x eps
   x the RMS scale of the static fit's best logL terms) of the static
   sweep on its own route, and, where that route is not the serial fits',
   within the floor beyond the route's own move of the static sweep.
   Then one EM step of the admixture and the mixture lattice (152 and 76
   chains of K = 2..20) against the same batch of K = 20 chains with no
   mask and against the sum of the 19 serial steps.  The launches of the
   masked kernels are counted from 0 over these runs and each must be
   launched; each masked kernel is then held to its plain version (rtol
   1e-4, atol 5e-5) at the batch its lattice gives it (152 chains for the
   pair's rows pass, in groups of 8 for its plain version; 28 for the
   rows finish and the generic p epilogue; 24 for the wide finish and the
   wide mixture rows pass; 76 for the mixture rows pass and finish) and
   timed there: the pair's rows pass, the rows finish, the wide finish,
   the generic p epilogue, the mixture rows pass, its wide scores and
   softmax, and the mixture finish (narrow, and its eta half at 160
   lanes), their records in the kernels line
   named ``(kmask)``, their bounds from each chain's own K;
24. the admixture start's counts (csrc/allele_counts.cu): one window of
   the HGDP 650Y panel as a start draws it (938 x 71,544 loci, 2 copies,
   K = 7, 0.2 % of the genotypes missing, int8 codes a column slice of a
   wider panel, the raw int64 draw), then K = 200 at M = 4 and K = 1024
   at M = 2: the kernel's copies and pc equal to the plain version's, its
   median CUDA-event ms beside its bound (9 bytes a copy and the outputs
   over 3.35 TB/s) and the plain version's; then the planes' variant
   (``allele_partition_counts_planes``) on the same HGDP window at K = 7
   and on a 10^6 x 64 window of TeraStructure's panel at K = 6, the
   planes cut at a column offset and a row block: equal to the codes'
   kernel and to the plain version, both kernels timed (8 bytes a copy,
   2 a genotype and the outputs over 3.35 TB/s); the codes' kernel's
   records carry its launches in the generic fits (phase 7), the planes'
   kernel's its launches in the biobank fits (phase 13).

Every kernel's record carries its bound: the least time this card could
take for the same work, the larger of the bytes the call must move (its
input and output tensors, each once) over 3.35 TB/s and its operations
over 67 TFLOP/s (IEEE float32 outside the tensor cores for the admixture
kernels, float64 on the tensor cores for the mixture rows and columns
passes: the same rate).  The segment reductions (the finish, the p0
epilogue, the generic p epilogue) must read only the live lanes of their
partials (the lane tile of K): their ``bound_ms`` counts those bytes, and
``bound_every_tensor_ms`` every tensor of the call once beside it.
``library_ms`` of the mixture rows and columns passes (narrow and wide)
is one float64 torch.matmul of the pass's product (the softmax left out),
the port's
plain arithmetic in one library call; no single PyTorch call computes the
other functions (phase 6 prints two float32 matmuls a generic pass beside
them), so theirs is null.  The wide admixture rows and columns passes
(phase 21) carry the float32 matmuls of their contractions under
``yardstick_matmuls_ms`` (and ``kp1024``'s), a yardstick the port never
calls.

Records of kernels the mesh phase launched name the sharded variants it
took (``mesh_variants``) and their launches on each rank of each shape
(``mesh_launches_per_rank``).

The last two lines are the kernels' JSON record and the device record.
"""

import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

I_FULL, L_FULL, K_FULL = 16384, 2048, 20
# float32, kernel against plain version (sums in other orders)
RTOL, ATOL = 1e-4, 5e-5
TPU_KERNEL = "multiclust_tpu/ops/kernels.py:344"
SOURCE = "multiclust_tpu_torch/csrc/fullstep_bi.cu"
BI_KERNELS = ("mc_fullstep_bi_rows", "mc_fullstep_bi_cols")
# a biallelic admixture step launches one of the two rows kernels (the
# fused one on the pair route, the segmented one with its finish on the
# streamed and chunked routes) and the columns kernel
BI_ROWS = ("mc_fullstep_bi_rows", "mc_fullstep_bi_rows_seg")
# chains in lockstep at which the router gives the 16384 x 2048 panel to the
# pair: its rows grid then fills the card without a column split
PAIR_CHAINS = 32
M_FULL = 4
GENERIC_TPU = "multiclust_tpu/ops/kernels.py:263"
GENERIC_SOURCE = "multiclust_tpu_torch/csrc/fullstep.cu"
GENERIC_KERNELS = ("mc_fullstep_rows", "mc_fullstep_cols", "mc_fullstep_p")
# the sweep statistics are the generic kernels with finish=False
SWEEP_TPU = {"admixture_sweep_fused": "multiclust_tpu/ops/kernels.py:1510",
             "admixture_sweep_stats": "multiclust_tpu/ops/kernels.py:1593"}
MIX_TPU = "multiclust_tpu/ops/kernels.py:1215"
MIX_SWEEP_TPU = "multiclust_tpu/ops/kernels.py:1361"
MIX_SOURCE = "multiclust_tpu_torch/csrc/mixture_bi.cu"
MIX_KERNELS = ("mc_mix_rows", "mc_mix_cols", "mc_mix_finish")
I_BIO, L_BIO = 8192, 131072          # the wide biobank panel
I_NARROW, L_NARROW = 2048, 524288    # the same cells, four times as wide
BOOT_REPS = 16                       # bootstrap replicates (-b)
STREAM_TPU = "multiclust_tpu/ops/kernels.py:1007"
CHUNK_TPU = "multiclust_tpu/ops/kernels.py:829"
# the columns pass's launcher also runs the p0 epilogue, once a call
STREAM_KERNELS = ("mc_fullstep_bi_rows_seg", "mc_fullstep_bi_finish",
                  "mc_fullstep_bi_cols")
# the TPU kernels the finish and the p0 epilogue take the place of: the
# last steps of the streamed step's two passes
FINISH_TPU = "multiclust_tpu/ops/kernels.py:887"
P0_TPU = "multiclust_tpu/ops/kernels.py:944"
# the card's published peaks: device memory, and float32 outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
OUT_FILES = ("sim.str.admix.K=3.out.txt", "sim.str.admix.K=3.etaik.txt",
             "sim.str.admix.K=3.pklm.txt", "sim.str_admix_popq_3.popq",
             "sim.str_admix_indivq_3.indivq")
# the mesh phase: shapes run as groups of child processes on the one card
MESH_SHAPES = ((2, 1), (1, 2), (2, 2))
MESH_TIMEOUT = 240
MESH_FIT_ITERS = 300
# the ingest phase's runs, at once on the one card (the NCCL run at world
# size 1 through the ingest path)
INGEST_RUNS = (("single", "single", None), ("nccl", "nccl", None),
               ("2x1", "gloo", (2, 1)), ("2x2", "gloo", (2, 2)))
INGEST_ITERS = 30
INGEST_TIMEOUT = 240


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def median_ms(fn, n=20, warm=3) -> float:
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


def step_inputs(rng, B, I, L, K, Kp, miss_rate, dev):
    eta = np.zeros((B, I, Kp), np.float32)
    eta[:, :, :K] = rng.dirichlet(np.full(K, 0.5), size=(B, I))
    p0 = np.zeros((B, Kp, L), np.float32)
    p0[:, :K] = rng.uniform(0.02, 0.98, size=(B, K, L))
    miss = rng.binomial(2, miss_rate, size=(I, L))
    x0 = rng.binomial(2 - miss, 0.5)
    return (torch.tensor(eta, device=dev), torch.tensor(p0, device=dev),
            torch.tensor(x0, dtype=torch.int8, device=dev),
            torch.tensor(2 - miss - x0, dtype=torch.int8, device=dev),
            torch.tensor(miss.sum(1), dtype=torch.float32, device=dev),
            torch.tensor(miss, dtype=torch.int8, device=dev)
            if miss_rate else None)


def max_err(got, ref) -> float:
    torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
    return float((got - ref).abs().max())


def tensors_bytes(*groups) -> int:
    """Bytes of every tensor in the (nested) groups, each counted once."""
    total = 0
    for g in groups:
        if torch.is_tensor(g):
            total += g.numel() * g.element_size()
        elif g is not None:
            total += tensors_bytes(*g)
    return total


def bound(n_bytes: float, n_flop: float):
    """(bound_ms, bound_by) of a call that must move ``n_bytes`` and do
    ``n_flop`` float32 operations."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_flop / F32_FLOP_PER_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def kernel_record(name, source, replaces, launches, err, ms, bnd,
                  library_ms=None):
    """A record of the kernels line; ``bnd`` (bound_ms, bound_by) or, for
    a segment reduction, (bound_ms from the live lanes it reads,
    bound_by, the bound of every tensor of the call once)."""
    rec = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": launches, "max_abs_err": err,
           "ms": ms[0], "plain_ms": ms[1], "bound_ms": bnd[0],
           "bound_by": bnd[1], "library_ms": library_ms}
    if len(bnd) > 2:
        rec["bound_every_tensor_ms"] = bnd[2]
    return rec


def phase_kernels(fb, dev, where):
    rng = np.random.default_rng(1)
    K, Kp = K_FULL, 32
    errs = {"rows": 0.0, "cols": 0.0}
    for B in (1, 4):
        for miss_rate in (0.0, 0.02):
            args = step_inputs(rng, B, I_FULL, L_FULL, K, Kp, miss_rate,
                               dev)
            for compute_t in (True, False):
                kw = dict(k_true=K, lb=1e-8, plb=1e-8, project=True,
                          compute_t=compute_t)
                got = fb.admixture_fullstep_biallelic(*args, **kw)
                ref = fb.admixture_fullstep_biallelic_reference(*args, **kw)
                torch.cuda.synchronize()
                e_eta, e_t, e_p = (max_err(g, r) for g, r in zip(got, ref))
                assert (got[0][..., K:] == 0).all()
                assert (got[2][:, K:] == 0).all()
                errs["rows"] = max(errs["rows"], e_eta, e_t)
                errs["cols"] = max(errs["cols"], e_p)
                k_ms = median_ms(
                    lambda: fb.admixture_fullstep_biallelic(*args, **kw))
                p_ms = median_ms(
                    lambda: fb.admixture_fullstep_biallelic_reference(
                        *args, **kw))
                cells = B * I_FULL * L_FULL * 2
                print(f"kernel B={B} miss={miss_rate:.2f} "
                      f"compute_t={compute_t}: max|d| eta'={e_eta:.3e} "
                      f"t={e_t:.3e} p0'={e_p:.3e} (rtol {RTOL}, atol "
                      f"{ATOL}); kernel {k_ms:.3f} ms "
                      f"({cells / k_ms / 1e6:.2f} Gcells/s), plain "
                      f"{p_ms:.3f} ms ({cells / p_ms / 1e6:.2f} Gcells/s) "
                      f"on {where}", flush=True)
    # each pass of the pair alone, 1 % missing: at the 2-chain fits' batch
    # and at 32 chains, where the router gives this panel to the pair
    # (the kernels' record)
    ms, bnd = {}, {}
    for B in (2, PAIR_CHAINS):
        e, p, a, z, c, m = step_inputs(rng, B, I_FULL, L_FULL, K, Kp, 0.01,
                                       dev)
        row_kw = dict(k_true=K, lb=1e-8, project=True, compute_t=True)
        passes = {
            "rows": (lambda: fb.fullstep_bi_rows(e, p, a, z, c, **row_kw),
                     lambda: fb.fullstep_bi_rows_reference(e, p, a, z, c,
                                                           **row_kw)),
            "cols": (lambda: (fb.fullstep_bi_cols(e, p, a, z, m, plb=1e-8,
                                                  project=True, k_true=K),),
                     lambda: (fb.fullstep_bi_cols_reference(
                         e, p, a, z, m, plb=1e-8, project=True),)),
        }
        # operations: two contractions of I x L x K (d0 and A; d0 and B0,
        # B1 as two) at 2 a multiply-add, and ~10 / ~6 a cell elementwise
        cells = B * I_FULL * L_FULL
        flop = {"rows": (4 * K + 10) * cells, "cols": (6 * K + 6) * cells}
        inputs = {"rows": (e, p, a, z, c), "cols": (e, p, a, z, m)}
        for name, (kernel, plain) in passes.items():
            got, ref = kernel(), plain()
            torch.cuda.synchronize()
            err = max(max_err(g, r) for g, r in zip(got, ref))
            errs[name] = max(errs[name], err)
            bnd[name, B] = bound(tensors_bytes(inputs[name], got),
                                 flop[name])
            del ref
            ms[name, B] = (median_ms(kernel),
                           median_ms(plain, n=5, warm=1))
            print(f"pass {name} B={B} miss=0.01: max|d| {err:.3e}; kernel "
                  f"{ms[name, B][0]:.3f} ms, plain {ms[name, B][1]:.3f} ms, "
                  f"bound {bnd[name, B][0]:.3f} ms ({bnd[name, B][1]}) on "
                  f"{where}", flush=True)
        del e, p, a, z, c, m, passes, inputs, got
        torch.cuda.empty_cache()
    return errs, ms, bnd


def segment_partials(gen, B, n_seg, Kp, W, kc, dev):
    """Columns-pass partials [B, n_seg, 2, Kp, W] drawn on the card, NaN on
    the lanes past kc, which the columns pass leaves unwritten and the p0
    epilogue must not read."""
    part = torch.rand((B, n_seg, 2, Kp, W), generator=gen, device=dev) * 64
    part[:, :, :, kc:] = float("nan")
    return part


def check_p0_epilogue(fb, p0, part, K):
    """The p0 epilogue alone on ``part`` over all of p0's columns against
    its plain version: raw B0/B1 bit-equal to the partials summed in
    segment order, p0' within the float32 tolerance.  Returns the largest
    error, and the kernel and its plain version as calls that return
    (p0',)."""
    win = dict(l_lo=0, l_hi=p0.shape[-1], k_true=K, plb=1e-8, project=True)
    raw = (torch.empty_like(p0), torch.empty_like(p0))
    raw_ref = (torch.empty_like(p0), torch.empty_like(p0))
    fb.p0_epilogue(p0, part, raw, **win)
    fb.p0_epilogue_reference(p0, part, raw_ref, **win)
    out, out_ref = torch.empty_like(p0), torch.empty_like(p0)

    def kernel():
        fb.p0_epilogue(p0, part, (out,), **win)
        return (out,)

    def plain():
        fb.p0_epilogue_reference(p0, part, (out_ref,), **win)
        return (out_ref,)

    kernel(), plain()
    torch.cuda.synchronize()
    assert all(torch.equal(g, r) for g, r in zip(raw, raw_ref))
    assert (out[:, K:] == 0).all()
    return max_err(out, out_ref), kernel, plain


def reduction_bytes(fb, B, I, L, Kp, K, n_cseg, n_rseg):
    """(finish, p0 epilogue) bytes, each as (every tensor of the call once,
    only the live lanes it reads): route_times's byte counts."""
    from multiclust_tpu_torch.route_times import finish_bytes, p0_bytes

    kc = fb.lane_tile(K, Kp).kc
    return (finish_bytes(B, I, Kp, n_cseg, kc),
            p0_bytes(B, Kp, L, n_rseg, kc))


def share_line(name, t_ms, n_bytes):
    """A reduction's time beside its bound (the live lanes it must read)
    and beside every tensor of the call once, both over 3.35 TB/s."""
    every, live = (n / HBM_BYTES_PER_S * 1e3 for n in n_bytes)
    return (f"{name} {t_ms:.4f} ms, bound {live:.4f} ms "
            f"({100 * live / t_ms:.1f} %; the live lanes), every tensor "
            f"once {every:.4f} ms ({100 * every / t_ms:.1f} %)")


def phase_routed_kernels(fb, dev, where):
    """The streamed step as the router splits the 16384 x 2048 panel for
    chain batches 1, 2 and 4 (the fits' route there): the segmented rows
    pass, its finish and the windowed columns pass, with the route's own
    column segments and row segments, each against its plain version; the
    t-only finish bit-equal to the ordered t; the p0 epilogue alone on
    partials of the route's row segments.  The
    finish's and the epilogue's times on CUDA events, with their bounds
    both ways.  Returns the largest error of each kernel."""
    rng = np.random.default_rng(6)
    gen = torch.Generator(device=dev).manual_seed(6)
    K, Kp = K_FULL, 32
    n_sm = fb.device_sm_count(dev)
    win = dict(l_lo=0, l_hi=L_FULL)
    fin = dict(k_true=K, lb=1e-8, project_eta=True)
    errs = {}
    for B in (1, 2, 4):
        e, p, a, z, c, m = step_inputs(rng, B, I_FULL, L_FULL, K, Kp, 0.01,
                                       dev)
        route = fb.pick_route(B, I_FULL, L_FULL, Kp, n_sm,
                              fb.scratch_budget(dev), K)
        assert route.name == "streamed" and route.n_rseg > 1, route

        def rows():
            return fb.rows_partials(e, p, a, z, seg_cols=route.seg_cols,
                                    k_true=K, **win)

        def cols(fn, outs, **kw):
            fn(e, p, a, z, m, outs, plb=1e-8, project=True, **win, **kw)
            return outs[0]

        apart, tpart = rows()
        ref_a, ref_t = fb.rows_partials_reference(e, p, a, z, **win)
        got = fb.rows_finish(e, apart, tpart, c, **fin)
        ref = fb.rows_finish_reference(e, apart, tpart, c, **fin)
        out = cols(fb.cols_window, (torch.empty_like(p),), k_true=K,
                   n_rseg=route.n_rseg)
        out_ref = cols(fb.cols_window_reference, (torch.empty_like(p),))
        torch.cuda.synchronize()
        assert apart.shape[1] == -(-L_FULL // route.seg_cols) > 1
        e_rows = max(max_err(apart.sum(dim=1), ref_a[:, 0]),
                     max_err_cast(tpart.double().sum(dim=1), ref_t[:, 0]))
        e_fin = max(max_err_cast(g, r) for g, r in zip(got, ref))
        e_cols = max_err(out, out_ref)
        assert (got[0][..., K:] == 0).all() and (out[:, K:] == 0).all()
        # the raw sums of the finish, bit-equal to the ordered ones
        raw, t_raw = fb.rows_finish(e, apart, tpart, c, emit_a=True, **fin)
        assert torch.equal(raw, fb.ordered_segment_sum(apart))
        t_want = fb.ordered_segment_sum(tpart, dtype=torch.float64)
        assert torch.equal(t_raw, t_want)
        # the t-only kernel (SQUAREM's logL terms) on the route's segments
        none, t_only = fb.rows_finish(e, None, tpart, c, **fin)
        assert none is None and torch.equal(t_only, t_want)
        n_rseg = route.n_rseg
        part = segment_partials(gen, B, n_rseg, Kp, L_FULL,
                                fb.lane_tile(K, Kp).kc, dev)
        e_p0, p0_once, _ = check_p0_epilogue(fb, p, part, K)
        for key, err in (("rows_seg", e_rows), ("finish", e_fin),
                         ("cols_window", e_cols), ("p0_epilogue", e_p0)):
            errs[key] = max(errs.get(key, 0.0), err)
        fin_ms = median_ms(lambda: fb.rows_finish(e, apart, tpart, c, **fin))
        p0_ms = median_ms(p0_once)
        fin_bnd, p0_bnd = reduction_bytes(fb, B, I_FULL, L_FULL, Kp, K,
                                          apart.shape[1], n_rseg)
        print(f"routed step {I_FULL} x {L_FULL} B={B}, "
              f"{route.describe()}: max|d| raw A + r, t {e_rows:.3e}, "
              f"eta', t {e_fin:.3e}, p0' {e_cols:.3e}, p0' of the "
              f"epilogue alone {e_p0:.3e} (rtol {RTOL}, atol {ATOL}; the "
              f"raw sums of the finish and the epilogue bit-equal to the "
              f"ordered ones); rows pass {median_ms(rows):.3f} ms, columns "
              f"pass "
              f"{median_ms(lambda: cols(fb.cols_window, (out,), k_true=K, n_rseg=route.n_rseg)):.3f}"
              f" ms; {share_line('finish', fin_ms, fin_bnd)}; "
              f"{share_line('p0 epilogue', p0_ms, p0_bnd)} on {where}",
              flush=True)
        del part
    return errs


def simulated_counts(rng, I, L, K, miss_rate):
    """Admixture-model genotypes: each copy draws a cluster from Q_i and
    an allele from P_k, so allele 0 has probability (Q @ P0)_il."""
    Q = rng.dirichlet(np.full(K, 0.5), size=I)
    P0 = rng.beta(0.8, 0.8, size=(K, L)).clip(0.01, 0.99)
    miss = rng.binomial(2, miss_rate, size=(I, L))
    x0 = rng.binomial(2 - miss, Q @ P0)
    return np.stack([x0, 2 - miss - x0], axis=2), miss


def check_fit(out, wall, label, where, md=None, K=K_FULL, mono=True):
    """Checks of a finished fit of ``K`` clusters; ``md`` stands in for the
    host Dataset when the panel was made on the device.  ``mono=False``
    leaves a monotonicity violation to the caller, who holds it to another
    fit's."""
    res = out.best
    eta, p = res.best_params.eta, res.best_params.p
    assert np.isfinite(res.max_logL) and not (mono and res.mono_viol), \
        (label, res.max_logL, res.mono_viol, res.n_iter_all)
    assert not res.any_failed, label
    ds = out.dataset if md is None else md
    # the mixture shares one K-vector eta across individuals
    assert eta.shape == ((ds.I, K) if eta.dim() == 2 else (K,))
    assert p.shape == (K, ds.L, ds.M)
    mask = torch.as_tensor(ds.mask, device=p.device)
    lb = 1e-8 * (1 - 1e-6)
    assert float(eta.min()) >= lb and float(p[:, mask].min()) >= lb, label
    assert (p[:, ~mask] == 0).all(), label
    torch.testing.assert_close(eta.sum(dim=-1), torch.ones_like(eta[..., 0]),
                               rtol=0, atol=1e-5)
    # the masked lanes are 0, so the sum runs over the valid lanes
    torch.testing.assert_close(p.sum(dim=2), torch.ones_like(p[..., 0]),
                               rtol=0, atol=1e-6)
    n = res.n_iter_all
    cells = n * ds.I * ds.L * ds.M
    print(f"fit {label}: logL {res.max_logL:.4f}, {n} EM iterations over "
          f"{res.n_launched} chains; fit_dataset {wall:.3f} s wall "
          f"({n / wall:.1f} iterations/s, {cells / wall / 1e9:.2f} Gcells/s), "
          f"of which init + EM {res.seconds:.3f} s ({n / res.seconds:.1f} "
          f"iterations/s, {cells / res.seconds / 1e9:.2f} Gcells/s) on "
          f"{where}", flush=True)
    return res


def phase_fit(build, dev, where):
    from multiclust_tpu_torch.api import fit_dataset
    from multiclust_tpu_torch.convert import dataset_from_counts

    rng = np.random.default_rng(2)
    counts, miss = simulated_counts(rng, I_FULL, L_FULL, K_FULL, 0.01)
    ds = dataset_from_counts(counts, miss, 2)
    base = dict(admixture=True, min_K=K_FULL, max_K=K_FULL, n_init=2,
                max_iter=100, seed=3, verbosity=2)

    def timed_fit(label, **kw):
        t0 = time.time()
        out = fit_dataset(ds, device=dev, **{**base, **kw})
        torch.cuda.synchronize()
        return check_fit(out, time.time() - t0, label, where)

    build.reset_launch_counts()
    plain = timed_fit("plain EM")
    squarem = timed_fit("SQUAREM", accel_scheme=1)
    launches = {name: build.LAUNCHES[name] for name in STREAM_KERNELS}
    print(f"launches in the 2-chain fits: {build.kernel_launches()} (route "
          f"{plain.route})", flush=True)
    assert plain.route.startswith("streamed"), plain.route
    # one launch of each pass serves the whole chain batch (2 lanes)
    steps = (plain.n_iter_all + squarem.n_iter_all) // 2
    assert all(n >= steps > 0 for n in launches.values()), launches
    assert not build.LAUNCHES["mc_fullstep_bi_rows"]

    # 32 chains in lockstep: the pair, counted from 0 on its own
    build.reset_launch_counts()
    many = timed_fit(f"plain EM, {PAIR_CHAINS} chains", n_init=PAIR_CHAINS,
                     batch_chains=PAIR_CHAINS, max_iter=10)
    pair = {name: build.LAUNCHES[name] for name in BI_KERNELS}
    print(f"launches in the {PAIR_CHAINS}-chain fit: "
          f"{build.kernel_launches()} (route {many.route})", flush=True)
    assert many.route.startswith("pair"), many.route
    assert many.batch_chains == PAIR_CHAINS
    steps = many.n_iter_all // PAIR_CHAINS
    assert all(n >= steps > 0 for n in pair.values()), pair
    assert not build.LAUNCHES["mc_fullstep_bi_rows_seg"]
    return pair


def phase_reference(build, dev):
    """A small warm-start fit through the kernel path (600 x 500 is too
    narrow to split, so the router takes the pair and its fused rows
    kernel), held to the plain float64 step on the CPU over the same 30
    iterations; the pair's launches in this fit are printed on its
    line."""
    from multiclust_tpu_torch.convert import model_data_from_numpy, \
        params_from_numpy
    from multiclust_tpu_torch.model.common import EMConfig
    from multiclust_tpu_torch.opt.driver import fit
    from multiclust_tpu_torch.runtime.multistart import _pad_k, _to_bi_repr

    rng = np.random.default_rng(4)
    I, L, K = 600, 500, 3
    counts, miss = simulated_counts(rng, I, L, K, 0.05)
    mask, n_all = np.ones((L, 2), bool), np.full(L, 2)
    eta = rng.dirichlet(np.full(K, 2.0), size=I)
    p0 = rng.uniform(0.2, 0.8, size=(K, L))
    p = np.stack([p0, 1 - p0], axis=2)
    base = dict(admixture=True, has_missing=True, biallelic=True, k_true=K,
                max_iter=30, abs_error=1e-12, eta_lower_bound=1e-8,
                p_lower_bound=1e-8)
    cpu = fit(params_from_numpy(eta, p),
              model_data_from_numpy(counts, miss, mask, n_all),
              EMConfig(**base))
    cfg = EMConfig(use_pallas="on", **base)
    warm = params_from_numpy(eta, p, device=dev, dtype=torch.float32)
    build.reset_launch_counts()
    gpu = fit(_to_bi_repr(_pad_k(warm, cfg), cfg),
              model_data_from_numpy(counts, miss, mask, n_all, device=dev,
                                    dtype=torch.float32), cfg)
    launches = {name: build.LAUNCHES[name] for name in BI_KERNELS}
    print(f"reference fit: kernel path logL {gpu.logL:.4f} vs float64 CPU "
          f"{cpu.logL:.4f} after {gpu.n_iter} iterations, launches "
          f"{launches}", flush=True)
    assert gpu.n_iter == cpu.n_iter == 31
    assert abs(gpu.logL - cpu.logL) < 0.1
    assert all(n >= 31 for n in launches.values()), launches


def write_structure_biallelic(path, counts, miss):
    """STRUCTURE rows of a biallelic panel, one per allele copy: copy a
    carries allele 1 when a < x0, allele 2 when observed otherwise, -9
    when missing; each allele in a 3-character field, the rows built as
    byte arrays."""
    I, L = miss.shape
    with open(path, "wb") as fh:
        fh.write((" ".join(f"loc{l}" for l in range(L)) + "\n").encode())
        for lo in range(0, I, 1024):
            x0, ms = counts[lo:lo + 1024, :, 0], miss[lo:lo + 1024]
            for i in range(x0.shape[0]):
                for a in range(2):
                    field = np.full((L, 3), ord(" "), np.uint8)
                    field[:, 2] = np.where(a < x0[i], ord("1"), ord("2"))
                    gone = a >= 2 - ms[i]
                    field[gone, 1], field[gone, 2] = ord("-"), ord("9")
                    fh.write(f"ind{lo + i} pop0".encode() + field.tobytes()
                             + b"\n")


def phase_cli(build, where):
    from multiclust_tpu_torch.cli import main

    rng = np.random.default_rng(5)
    I, L, K = 1024, 1000, 3
    counts, miss = simulated_counts(rng, I, L, K, 0.05)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sim.str")
        write_structure_biallelic(path, counts, miss)
        build.reset_launch_counts()
        t0 = time.time()
        rc = main(["-f", path, "-a", "-k", "3", "-n", "4", "-s", "1",
                   "-d", tmp])
        torch.cuda.synchronize()
        launches = {name: build.LAUNCHES[name]
                    for name in BI_KERNELS + BI_ROWS[1:]}
        assert rc == 0, rc
        for f in OUT_FILES:
            assert os.path.getsize(os.path.join(tmp, f)) > 0, f
    assert sum(launches[name] for name in BI_ROWS) > 0, launches
    assert launches["mc_fullstep_bi_cols"] > 0, launches
    print(f"cli: rc 0 in {time.time() - t0:.2f} s, launches {launches} on "
          f"{where}", flush=True)


def generic_counts(seed, I, L, n_alleles, K, miss_rate, dev):
    """Admixture-model genotypes for multi-allelic loci, drawn on ``dev``
    from ``seed``: each observed copy draws its allele from (Q P)_il over
    the locus's n_alleles[l] valid slots.  Returns counts [I, L, M] int8,
    miss [I, L] int8 and the mask [L, M], all on ``dev``."""
    n_alleles = torch.as_tensor(n_alleles, device=dev)
    M = int(n_alleles.max())
    mask = torch.arange(M, device=dev)[None, :] < n_alleles[:, None]
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    Q = torch.tensor(rng.dirichlet(np.full(K, 0.5), size=I),
                     dtype=torch.float32, device=dev)
    P = torch.tensor(rng.dirichlet(np.full(M, 0.7), size=(K, L)),
                     dtype=torch.float32, device=dev) * mask
    P /= P.sum(dim=-1, keepdim=True)
    cum = (Q @ P.reshape(K, -1)).view(I, L, M).cumsum(dim=-1)
    miss = (torch.rand((I, L, 2), generator=gen, device=dev)
            < miss_rate).sum(dim=-1).to(torch.int8)
    counts = torch.zeros((I, L, M), dtype=torch.int8, device=dev)
    top = (n_alleles - 1).to(torch.int64)
    for a in range(2):
        u = torch.rand((I, L, 1), generator=gen, device=dev)
        allele = torch.minimum((u > cum).sum(dim=-1), top)
        counts.scatter_add_(2, allele[..., None],
                            (a < 2 - miss)[..., None].to(torch.int8))
    return counts, miss, mask


def generic_inputs(seed, B, I, L, n_alleles, K, Kp, miss_rate, dev):
    """Full-step inputs on ``dev``: eta [B, I, Kp] and p2 [B, Kp, L*M] with
    zero pads, x2 int8 [I, L*M], c [I], miss [I, L] int8 or None, mask."""
    counts, miss, mask = generic_counts(seed, I, L, n_alleles, K, miss_rate,
                                        dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    M = mask.shape[1]
    eta = torch.zeros((B, I, Kp), device=dev)
    eta[..., :K] = torch.rand((B, I, K), generator=gen, device=dev) + 0.05
    eta /= eta.sum(dim=-1, keepdim=True)
    p = torch.zeros((B, Kp, L, M), device=dev)
    p[:, :K] = (torch.rand((B, K, L, M), generator=gen, device=dev)
                + 0.05) * mask
    p /= p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    return (eta, p.view(B, Kp, L * M), counts.view(I, L * M),
            miss.sum(dim=1, dtype=torch.float32),
            miss if miss_rate else None, mask)


def phase_generic_kernels(fs, build, dev, where):
    """The generic kernels against their plain versions at the full shape,
    then each kernel alone at the fit's shape (its CUDA-event time for
    the kernels' record), the sweep statistics and an a0 chain."""
    from multiclust_tpu_torch.ops.fullstep_bi import row_segments

    K, Kp = K_FULL, 32
    full_m = np.full(L_FULL, M_FULL)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    errs = {"rows": 0.0, "cols": 0.0, "p": 0.0}
    cases = [(B, miss_rate, full_m, "M=4") for B in (1, 2, 4)
             for miss_rate in (0.0, 0.02)]
    # the jagged mix of bench.py:199-201, dense at M = 8
    jag = np.where(np.random.default_rng(10).random(L_FULL) < 0.8, 2, 8)
    cases.append((2, 0.02, jag, "jagged 80 % M=2 + 20 % M=8"))
    for seed, (B, miss_rate, n_all, label) in enumerate(cases):
        args = generic_inputs(20 + 2 * seed, B, I_FULL, L_FULL, n_all, K,
                              Kp, miss_rate, dev)
        for compute_t in (True, False):
            kw = dict(k_true=K, lb=1e-8, plb=1e-8, project=True,
                      compute_t=compute_t)
            got = fs.admixture_fullstep(*args, **kw)
            ref = fs.admixture_fullstep_reference(*args, **kw)
            torch.cuda.synchronize()
            e_eta, e_t, e_p = (max_err(g, r) for g, r in zip(got, ref))
            assert (got[0][..., K:] == 0).all() and (got[2][:, K:] == 0).all()
            assert (got[2][..., ~args[-1]] == 0).all()
            errs["rows"] = max(errs["rows"], e_eta, e_t)
            errs["p"] = max(errs["p"], e_p)
            k_ms = median_ms(lambda: fs.admixture_fullstep(*args, **kw))
            p_ms = median_ms(lambda: fs.admixture_fullstep_reference(
                *args, **kw))
            cells = B * I_FULL * args[1].shape[-1]
            # the segments the wrappers pick for this batch
            LM = cells // B // I_FULL
            segs = (row_segments(B, I_FULL, LM, n_sm, k_true=K, Kp=Kp)[0],
                    fs.cols_segments(B, I_FULL, LM, Kp, n_sm, K)[0])
            print(f"generic step {label} B={B} miss={miss_rate:.2f} "
                  f"compute_t={compute_t} ({segs[0]} lane segments, "
                  f"{segs[1]} row segments): max|d| eta'={e_eta:.3e} "
                  f"t={e_t:.3e} p'={e_p:.3e} (rtol {RTOL}, atol {ATOL}); "
                  f"kernel {k_ms:.3f} ms ({cells / k_ms / 1e6:.2f} "
                  f"Glanes/s), plain {p_ms:.3f} ms "
                  f"({cells / p_ms / 1e6:.2f} Glanes/s) on {where}",
                  flush=True)
        del args, got, ref
        torch.cuda.empty_cache()

    # each kernel alone at the fit's shape (chain batch 2, 1 % missing)
    e, p2, x2, c, m, mask = generic_inputs(40, 2, I_FULL, L_FULL, full_m,
                                           K, Kp, 0.01, dev)
    row_kw = dict(k_true=K, lb=1e-8, project=True, compute_t=True)
    p_kw = dict(k_true=K, plb=1e-8, project=True)
    part = fs.fullstep_partials(e, p2, x2, m, M=M_FULL, k_true=K)
    passes = {
        "rows": (lambda: fs.fullstep_rows(e, p2, x2, c, M=M_FULL,
                                          **row_kw),
                 lambda: fs.fullstep_rows_reference(e, p2, x2, c, **row_kw)),
        # the columns pass's partials, compared summed over segments
        "cols": (lambda: (fs.fullstep_partials(
                     e, p2, x2, m, M=M_FULL, k_true=K).sum(dim=1),),
                 lambda: (fs.fullstep_partials_reference(
                     e, p2, x2, m)[:, 0],)),
        "p": (lambda: (fs.fullstep_p(p2, part, mask, M=M_FULL, **p_kw),),
              lambda: (fs.fullstep_p_reference(p2, part, mask, **p_kw),)),
    }
    # operations: d and A (rows), d and B (columns), 2 a multiply-add per
    # lane and cluster, plus ~5 / ~3 a lane elementwise; the p epilogue
    # ~10 a p entry
    lanes = 2 * I_FULL * L_FULL * M_FULL
    flop = {"rows": (4 * K + 5) * lanes, "cols": (4 * K + 3) * lanes,
            "p": 10 * p2.numel()}
    inputs = {"rows": (e, p2, x2, c), "cols": (e, p2, x2, m),
              "p": (p2, part, mask)}
    ms, bnd = {}, {}
    for name, (kernel, plain) in passes.items():
        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        err = max(max_err(g, r) for g, r in zip(got, ref))
        errs[name] = max(errs[name], err)
        ms[name] = (median_ms(kernel), median_ms(plain))
        bnd[name] = bound(tensors_bytes(inputs[name], got), flop[name])
        print(f"generic pass {name} B=2 miss=0.01: max|d| {err:.3e}; kernel "
              f"{ms[name][0]:.3f} ms, plain {ms[name][1]:.3f} ms, bound "
              f"{bnd[name][0]:.3f} ms ({bnd[name][1]}) on {where}",
              flush=True)
    # the p epilogue's raw B bit-equal to the partials added in segment
    # order; its bound from the live lanes it reads (the record's), and
    # every tensor once beside it
    from multiclust_tpu_torch.ops.fullstep_bi import lane_tile, \
        ordered_segment_sum
    from multiclust_tpu_torch.route_times import p_bytes

    raw = fs.fullstep_p(p2, part, mask, M=M_FULL, k_true=K, finish=False)
    torch.cuda.synchronize()
    assert torch.equal(raw, ordered_segment_sum(part))
    p_bnd = p_bytes(2, Kp, L_FULL * M_FULL, part.shape[1],
                    lane_tile(K, Kp).kc)
    bnd["p"] = bound(p_bnd[1], flop["p"]) + (bound(p_bnd[0], flop["p"])[0],)
    print(f"generic p epilogue B=2 ({part.shape[1]} row segments; raw B "
          f"bit-equal to the ordered sum): "
          f"{share_line('kernel', ms['p'][0], p_bnd)} on {where}",
          flush=True)
    del raw

    # the yardstick the port never calls: each pass's two products alone,
    # float32 torch.matmul (TF32 off) on K-wide operands
    e_k, p_k = e[..., :K].contiguous(), p2[:, :K].contiguous()
    w = torch.rand(x2.shape, device=dev).expand(2, -1, -1).contiguous()
    mm = {"rows": median_ms(lambda: (e_k @ p_k, w @ p_k.transpose(1, 2))),
          "cols": median_ms(lambda: (e_k @ p_k, e_k.transpose(1, 2) @ w))}
    del w
    print(f"yardstick, not a route of the port: two float32 matmuls of the "
          f"rows pass's shapes (d, A) {mm['rows']:.3f} ms, of the columns "
          f"pass's (d, B) {mm['cols']:.3f} ms; the kernels "
          f"{ms['rows'][0]:.3f} and {ms['cols'][0]:.3f} ms on {where}",
          flush=True)

    # the sweep statistics (finish=False), its launches counted from 0 on
    # a call of its own (of the fits only a meshed one with the loci split
    # calls it, phase 19), and an a0 / emit_a chain
    build.reset_launch_counts()
    got = fs.admixture_sweep_stats(e, p2, x2)
    sweep_launches = build.LAUNCHES["mc_fullstep_rows"]
    ref = fs.admixture_sweep_stats_reference(e, p2, x2)
    torch.cuda.synchronize()
    sweep_err = max(max_err(g, r) for g, r in zip(got, ref))
    sweep_ms = (median_ms(lambda: fs.admixture_sweep_stats(e, p2, x2)),
                median_ms(lambda: fs.admixture_sweep_stats_reference(
                    e, p2, x2)))
    # the sweep's d, A and B contractions over x read once
    bnd["sweep"] = bound(tensors_bytes((e, p2, x2), got), 6 * K * lanes)
    print(f"generic sweep stats B=2: max|d| {sweep_err:.3e}; kernel "
          f"{sweep_ms[0]:.3f} ms, plain {sweep_ms[1]:.3f} ms, bound "
          f"{bnd['sweep'][0]:.3f} ms ({bnd['sweep'][1]}) on {where}",
          flush=True)
    h = (L_FULL // 2) * M_FULL
    halves = [(p2[..., :h].contiguous(), x2[:, :h].contiguous()),
              (p2[..., h:].contiguous(), x2[:, h:].contiguous())]
    A, _ = fs.fullstep_rows(e, *halves[0], c, finish=False, **row_kw)
    chain = fs.fullstep_rows(e, *halves[1], c, A, **row_kw)
    A_ref, _ = fs.fullstep_rows_reference(e, *halves[0], c, finish=False,
                                          **row_kw)
    chain_ref = fs.fullstep_rows_reference(e, *halves[1], c, A_ref,
                                           **row_kw)
    torch.cuda.synchronize()
    chain_err = max([max_err(A, A_ref)]
                    + [max_err(g, r) for g, r in zip(chain, chain_ref)])
    print(f"generic a0 / emit_a chain of two launches B=2: max|d| "
          f"{chain_err:.3e} on {where}", flush=True)
    errs["rows"] = max(errs["rows"], chain_err)
    return errs, ms, (sweep_err, sweep_ms, sweep_launches), bnd


def phase_generic_shapes(fs, build, dev, where):
    """The two redesigned generic kernels where the M = 4 fits do not take
    them: Kp = 64 and 128 (K = 40, 100) on an unaligned panel (I = 1000,
    L*M = 1003 x 3: byte loads, ragged tiles), in the segments the
    wrappers pick, each against its plain version and rerun bit-equal;
    then what the compiler made of them."""
    from multiclust_tpu_torch.kernel_report import ptxas_lines
    from multiclust_tpu_torch.ops.fullstep_bi import row_segments

    I, L, M = 1000, 1003, 3
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for seed, (K, Kp) in enumerate(((40, 64), (100, 128))):
        e, p2, x2, c, m, mask = generic_inputs(
            60 + seed, 2, I, L, np.full(L, M), K, Kp, 0.02, dev)
        row_kw = dict(k_true=K, lb=1e-8, project=True)

        def rows():
            return fs.fullstep_rows(e, p2, x2, c, M=M, **row_kw)

        def cols():
            return fs.fullstep_partials(e, p2, x2, m, M=M, k_true=K)

        ref_rows = fs.fullstep_rows_reference(e, p2, x2, c, **row_kw)
        ref_part = fs.fullstep_partials_reference(e, p2, x2, m)[:, 0]
        got_rows, part = rows(), cols()
        torch.cuda.synchronize()
        err = max([max_err(g, r) for g, r in zip(got_rows, ref_rows)]
                  + [max_err(part.sum(dim=1), ref_part)])
        assert (part[:, :, K:] == 0).all()
        assert all(torch.equal(u, v) for u, v in zip(got_rows, rows()))
        assert torch.equal(part, cols())
        segs = row_segments(2, I, L * M, n_sm, k_true=K, Kp=Kp)[0]
        print(f"redesigned generic kernels, Kp={Kp} (K={K}, B=2, {I} x "
              f"{L} x M={M}): max|d| {err:.3e} (rtol {RTOL}, atol "
              f"{ATOL}); reruns bit-equal; rows pass "
              f"{median_ms(rows, n=5, warm=1):.3f} ms ({segs} lane "
              f"segments), columns pass {median_ms(cols, n=5, warm=1):.3f} "
              f"ms ({part.shape[1]} row segments) on {where}", flush=True)
    report = build.library_path().with_suffix(".ptxas.txt").read_text()
    for name, text in ptxas_lines(report, "fullstep_(?:rows|cols)_"):
        print(f"ptxas {name}: {text}", flush=True)
        assert " 0 bytes spill stores, 0 bytes spill loads" in text, name


def phase_fit_generic(build, dev, where):
    from multiclust_tpu_torch.api import fit_dataset
    from multiclust_tpu_torch.convert import dataset_from_counts

    counts, miss, _ = generic_counts(42, I_FULL, L_FULL,
                                     np.full(L_FULL, M_FULL), K_FULL, 0.01,
                                     dev)
    ds = dataset_from_counts(counts.cpu().numpy(), miss.cpu().numpy(), 2)
    assert ds.M == M_FULL
    base = dict(admixture=True, min_K=K_FULL, max_K=K_FULL, n_init=2,
                max_iter=100, seed=3, verbosity=2)

    def timed_fit(label, **kw):
        t0 = time.time()
        out = fit_dataset(ds, device=dev, **base, **kw)
        torch.cuda.synchronize()
        return check_fit(out, time.time() - t0, label, where)

    build.reset_launch_counts()
    plain = timed_fit("M=4 plain EM")
    squarem = timed_fit("M=4 SQUAREM", accel_scheme=1)
    launches = {name: build.LAUNCHES[name] for name in GENERIC_KERNELS}
    print(f"launches in the M=4 fits: {build.kernel_launches()}", flush=True)
    # one launch of each kernel serves the whole chain batch (2 lanes)
    steps = (plain.n_iter_all + squarem.n_iter_all) // 2
    for name, n in launches.items():
        assert n >= steps > 0, (name, n, steps)
    assert not any(build.LAUNCHES[name] for name in BI_KERNELS)
    # the multi-allelic starts count each window from its codes
    counts, windows = (build.LAUNCHES[name] for name in ("mc_allele_counts",
                                                         "init.windows"))
    assert counts == windows >= plain.n_launched + squarem.n_launched, \
        (counts, windows)
    assert not build.LAUNCHES["mc_allele_counts_planes"]
    return dict(launches, mc_allele_counts=counts)


def phase_reference_generic(dev):
    """A small multi-allelic warm-start fit through the generic kernels,
    held to the plain float64 step on the CPU over the same 30
    iterations."""
    from multiclust_tpu_torch.convert import model_data_from_numpy, \
        params_from_numpy
    from multiclust_tpu_torch.model.common import EMConfig
    from multiclust_tpu_torch.opt.driver import fit
    from multiclust_tpu_torch.runtime.multistart import _pad_k

    I, L, M, K = 600, 300, 5, 3
    counts, miss, mask = (t.numpy() for t in generic_counts(
        43, I, L, np.full(L, M), K, 0.05, "cpu"))
    n_all = mask.sum(axis=1)
    rng = np.random.default_rng(14)
    eta = rng.dirichlet(np.full(K, 2.0), size=I)
    p = rng.dirichlet(np.full(M, 2.0), size=(K, L))
    base = dict(admixture=True, has_missing=True, k_true=K, max_iter=30,
                abs_error=1e-12, eta_lower_bound=1e-8, p_lower_bound=1e-8)
    cpu = fit(params_from_numpy(eta, p),
              model_data_from_numpy(counts, miss, mask, n_all),
              EMConfig(**base))
    cfg = EMConfig(use_pallas="on", **base)
    warm = params_from_numpy(eta, p, device=dev, dtype=torch.float32)
    gpu = fit(_pad_k(warm, cfg),
              model_data_from_numpy(counts, miss, mask, n_all, device=dev,
                                    dtype=torch.float32), cfg)
    print(f"reference fit M=5: kernel path logL {gpu.logL:.4f} vs float64 "
          f"CPU {cpu.logL:.4f} after {gpu.n_iter} iterations", flush=True)
    assert gpu.n_iter == cpu.n_iter == 31
    assert abs(gpu.logL - cpu.logL) < 0.1


def write_structure(path, counts, miss):
    """STRUCTURE rows, one per allele copy: allele m + 1 once for each
    count of slot m, then -9 for each missing copy."""
    I, L, M = counts.shape
    with open(path, "w") as fh:
        fh.write(" ".join(f"loc{l}" for l in range(L)) + "\n")
        for i in range(I):
            copies = [np.concatenate([np.repeat(np.arange(1, M + 1),
                                                counts[i, l]),
                                      np.full(miss[i, l], -9)])
                      for l in range(L)]
            for a in range(2):
                fh.write(f"ind{i} pop0 "
                         + " ".join(str(c[a]) for c in copies) + "\n")


def phase_cli_generic(build, where):
    from multiclust_tpu_torch.cli import main

    I, L = 512, 200
    n_all = np.random.default_rng(44).integers(3, 7, size=L)
    counts, miss, _ = (t.numpy() for t in generic_counts(
        45, I, L, n_all, 3, 0.05, "cpu"))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sim.str")
        write_structure(path, counts, miss)
        build.reset_launch_counts()
        t0 = time.time()
        # -m 5: Rand-EM starts, scored through the generic kernels
        rc = main(["-f", path, "-a", "-k", "3", "-n", "4", "-s", "1",
                   "-m", "5", "-d", tmp])
        torch.cuda.synchronize()
        launches = {name: build.LAUNCHES[name] for name in GENERIC_KERNELS}
        assert rc == 0, rc
        for f in OUT_FILES:
            assert os.path.getsize(os.path.join(tmp, f)) > 0, f
    assert all(n > 0 for n in launches.values()), launches
    print(f"cli M<=6: rc 0 in {time.time() - t0:.2f} s, launches {launches} "
          f"on {where}", flush=True)


def mixture_counts(seed, I, L, K, miss_rate, dev, spread=None):
    """Mixture-model genotypes of ``route_times.mixture_planes`` (drawn on
    the host from ``seed`` and uploaded to ``dev``; ``spread`` as there) as
    numpy counts [I, L, 2] and miss [I, L]."""
    from multiclust_tpu_torch.route_times import mixture_planes

    planes, miss = mixture_planes(seed, I, L, K, miss_rate, dev, spread)
    return (planes.permute(1, 2, 0).long().cpu().numpy(),
            miss.long().cpu().numpy())


def check_mixture_finish(mb, build, part, vpart, kw) -> float:
    """The finish on the columns pass's partials (the wrapper's own
    segments): one launch a call, against its plain version; its vtot and
    the raw B0 (B1) of its p half bit-equal to the ordered segment sums,
    and the model's layout (eta [B, K], p [B, K, L, 2]) bit-equal to its
    K-padded outputs.  Returns the largest error."""
    from multiclust_tpu_torch.ops.fullstep_bi import ordered_segment_sum

    before = build.kernel_launches()
    got = mb.mixture_finish(part, vpart, **kw)
    assert {n: v - before[n] for n, v in build.kernel_launches().items()
            if v != before[n]} == (
        {"mc_mix_finish": 1, "wide_mix_finish": 1}
        if mb.is_wide(part.shape[3]) else {"mc_mix_finish": 1})
    ref = mb.mixture_finish_reference(part, vpart, **kw)
    model = mb.mixture_finish(part, vpart, params=True, **kw)
    raw = mb.mixture_b(part)
    torch.cuda.synchronize()
    err = max(max_err(g, r) for g, r in zip(got, ref))
    assert torch.equal(got[1], ordered_segment_sum(vpart))
    for s, b in enumerate(raw[:part.shape[2]]):
        assert torch.equal(b, ordered_segment_sum(part[:, :, s]))
    assert all(torch.equal(g, w) for g, w in zip(
        model, mb.params_layout(got[0], got[2], kw["k_true"])))
    return err


def finish_bound(part, vpart, K):
    """(bound_ms from the live lanes, "bytes", bound_ms of every tensor
    once) of the finish in the model's layout: the partials and v sums
    read, eta [B, K] and p [B, K, L, 2] written."""
    from multiclust_tpu_torch.route_times import mix_finish_bytes

    B, n_seg, ns, Kp, L = part.shape
    live = mix_finish_bytes(B, n_seg, ns, K, L, True)
    every = tensors_bytes(part, vpart) + 4 * B * (K + 2 * K * L)
    return (live / HBM_BYTES_PER_S * 1e3, "bytes",
            every / HBM_BYTES_PER_S * 1e3)


def phase_mixture_kernels(mb, build, dev, where):
    """The mixture step and the sweep against their plain versions at the
    full shape, then each pass alone at the fit's shape (chain batch 2,
    one stream) for the kernels' record, with the matmul yardstick of the
    two contraction passes; the step at Kp = 128; the compiler's report."""
    from multiclust_tpu_torch.kernel_report import ptxas_lines
    from multiclust_tpu_torch.route_times import mixture_step_inputs

    K, Kp = K_FULL, 32
    errs = {"rows": 0.0, "cols": 0.0, "finish": 0.0, "sweep": 0.0}
    kw = dict(k_true=K, lb=1e-8, plb=1e-8, ploidy=2, project=True)
    fin_kw = dict(kw)
    for seed, (B, miss_rate) in enumerate(
            [(B, m) for B in (1, 4) for m in (0.0, 0.02)]):
        args = mixture_step_inputs(60 + seed, B, I_FULL, L_FULL, K, Kp,
                                   miss_rate, dev)
        before = build.kernel_launches()
        got = mb.mixture_fullstep_biallelic(*args, **kw)
        # one launch each of rows, columns and the finish
        assert {n: build.LAUNCHES[n] - before[n] for n in MIX_KERNELS} \
            == dict.fromkeys(MIX_KERNELS, 1)
        ref = mb.mixture_fullstep_biallelic_reference(*args, **kw)
        torch.cuda.synchronize()
        e_eta, e_t, e_p = (max_err(g, r) for g, r in zip(got, ref))
        assert (got[0][:, K:] == 0).all()
        v, _ = mb.mixture_rows(*args, k_true=K)
        part, vpart = mb.mixture_partials(v, args[1], args[4], k_true=K)
        e_fin = check_mixture_finish(mb, build, part, vpart, fin_kw)
        del v, part, vpart
        errs["finish"] = max(errs["finish"], e_eta, e_p, e_fin)
        errs["rows"] = max(errs["rows"], e_t)
        sweep = mb.mixture_sweep_stats(*args, k_true=K)
        sweep_ref = mb.mixture_sweep_stats_reference(*args)
        torch.cuda.synchronize()
        e_sw = max(max_err(g, r) for g, r in zip(sweep, sweep_ref)
                   if g is not None)
        errs["sweep"] = max(errs["sweep"], e_sw)
        k_ms = median_ms(lambda: mb.mixture_fullstep_biallelic(*args, **kw))
        p_ms = median_ms(lambda: mb.mixture_fullstep_biallelic_reference(
            *args, **kw))
        cells = B * I_FULL * L_FULL
        print(f"mixture step B={B} miss={miss_rate:.2f}: max|d| "
              f"eta'={e_eta:.3e} t={e_t:.3e} p0'={e_p:.3e} sweep={e_sw:.3e} "
              f"finish on the columns pass's {args[0].shape[0]}-chain "
              f"partials {e_fin:.3e}, its vtot and raw B bit-equal to the "
              f"ordered sums (rtol {RTOL}, atol {ATOL}); kernel {k_ms:.3f} ms "
              f"({cells / k_ms / 1e6:.2f} Gcells/s), plain {p_ms:.3f} ms "
              f"({cells / p_ms / 1e6:.2f} Gcells/s) on {where}", flush=True)
        del args, got, ref, sweep, sweep_ref
        torch.cuda.empty_cache()

    # each pass alone at the fit's shape (chain batch 2, missing-free)
    lp0, x0, bias, _, _ = mixture_step_inputs(70, 2, I_FULL, L_FULL, K, Kp,
                                              0.0, dev)
    v, _ = mb.mixture_rows(lp0, x0, bias, k_true=K)
    part, vpart = mb.mixture_partials(v, x0, k_true=K)
    # the finish as the model's step runs it (its layout)
    model_kw = dict(fin_kw, params=True)
    passes = {
        "rows": (lambda: mb.mixture_rows(lp0, x0, bias, k_true=K),
                 lambda: mb.mixture_rows_reference(lp0, x0, bias)),
        # the partials, compared summed over segments
        "cols": (lambda: tuple(t.sum(dim=1)
                               for t in mb.mixture_partials(v, x0,
                                                            k_true=K)),
                 lambda: tuple(t[:, 0]
                               for t in mb.mixture_cols_reference(v, x0))),
        "finish": (lambda: mb.mixture_finish(part, vpart, **model_kw),
                   lambda: mb.mixture_finish_reference(part, vpart,
                                                       **model_kw)),
        "sweep": (lambda: mb.mixture_sweep_stats(lp0, x0, bias,
                                                 k_true=K)[:3],
                  lambda: mb.mixture_sweep_stats_reference(lp0, x0,
                                                           bias)[:3]),
    }
    # operations: one contraction of I x L x K each for the scores (rows)
    # and for B0 (columns), 2 a multiply-add (float64 on the tensor
    # cores), and the softmax's ~20 a posterior; the finish's bound is its
    # bytes (finish_bound)
    cells = 2 * I_FULL * L_FULL
    flop = {"rows": 2 * K * cells + 20 * v.numel(), "cols": 2 * K * cells,
            "sweep": 4 * K * cells + 20 * v.numel()}
    inputs = {"rows": (lp0, x0, bias), "cols": (v, x0),
              "sweep": (lp0, x0, bias)}
    ms, bnd = {}, {}
    for name, (kernel, plain) in passes.items():
        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        err = max(max_err(g, r) for g, r in zip(got, ref))
        errs[name] = max(errs[name], err)
        ms[name] = (median_ms(kernel), median_ms(plain))
        bnd[name] = (finish_bound(part, vpart, K) if name == "finish" else
                     bound(tensors_bytes(inputs[name], got), flop[name]))
        print(f"mixture pass {name} B=2 miss=0.00: max|d| {err:.3e}; kernel "
              f"{ms[name][0]:.3f} ms, plain {ms[name][1]:.3f} ms, bound "
              f"{bnd[name][0]:.3f} ms ({bnd[name][1]}) on {where}",
              flush=True)

    # the yardstick the port never calls: each pass's product alone, one
    # torch.matmul on K-wide operands, in float64 (the plain version's
    # arithmetic, cuBLAS on the float64 tensor cores) and in float32
    assert not torch.backends.cuda.matmul.allow_tf32
    library = {}
    for dtype in (torch.float64, torch.float32):
        xx = x0.to(dtype)
        lp_t = lp0[:, :K].to(dtype).transpose(1, 2)            # [B, L, K]
        v_t = v[..., :K].to(dtype).transpose(1, 2).contiguous()  # [B, K, I]
        library[dtype] = {
            "rows": median_ms(lambda: torch.matmul(xx, lp_t)),
            "cols": median_ms(lambda: torch.matmul(v_t, xx))}
        del xx, lp_t, v_t
    # the sweep's launches, counted from 0 on a call of its own (no fit
    # calls it)
    build.reset_launch_counts()
    mb.mixture_sweep_stats(lp0, x0, bias, k_true=K)
    torch.cuda.synchronize()
    sweep_launches = {name: build.LAUNCHES[name] for name in MIX_KERNELS}
    assert sweep_launches == {"mc_mix_rows": 1, "mc_mix_cols": 1,
                              "mc_mix_finish": 1}, sweep_launches
    print(f"launches of one mixture_sweep_stats call: {sweep_launches}",
          flush=True)
    print(f"yardstick, not a route of the port: one matmul of the rows "
          f"pass's product (x lp^T) {library[torch.float64]['rows']:.3f} ms "
          f"in float64, {library[torch.float32]['rows']:.3f} ms in float32; "
          f"of the columns pass's (v^T x) "
          f"{library[torch.float64]['cols']:.3f} / "
          f"{library[torch.float32]['cols']:.3f} ms; the kernels "
          f"{ms['rows'][0]:.3f} and {ms['cols'][0]:.3f} ms on {where}",
          flush=True)
    del lp0, x0, bias, v, part, vpart
    torch.cuda.empty_cache()

    # Kp = 128 (K = 100) on an unaligned panel, one stream and two
    for miss_rate in (0.0, 0.02):
        args = mixture_step_inputs(75, 2, 4000, 4001, 100, 128, miss_rate,
                                   dev)
        kw128 = dict(kw, k_true=100)
        got = mb.mixture_fullstep_biallelic(*args, **kw128)
        ref = mb.mixture_fullstep_biallelic_reference(*args, **kw128)
        torch.cuda.synchronize()
        e_eta, e_t, e_p = (max_err(g, r) for g, r in zip(got, ref))
        again = mb.mixture_fullstep_biallelic(*args, **kw128)
        assert all(torch.equal(g, a) for g, a in zip(got, again))
        v, _ = mb.mixture_rows(*args, k_true=100)
        part, vpart = mb.mixture_partials(v, args[1], args[4], k_true=100)
        e_fin = check_mixture_finish(mb, build, part, vpart,
                                     dict(fin_kw, k_true=100))
        del v, part, vpart
        for name, err in (("finish", max(e_eta, e_p, e_fin)),
                          ("rows", e_t)):
            errs[name] = max(errs[name], err)
        step_ms = median_ms(
            lambda: mb.mixture_fullstep_biallelic(*args, **kw128), n=5,
            warm=1)
        print(f"mixture step Kp=128 (K=100, B=2, 4000 x 4001, miss="
              f"{miss_rate:.2f}): max|d| eta'={e_eta:.3e} t={e_t:.3e} "
              f"p0'={e_p:.3e}, finish {e_fin:.3e} (rtol {RTOL}, atol "
              f"{ATOL}); vtot and raw B bit-equal to the ordered sums; "
              f"reruns bit-equal; "
              f"{step_ms:.3f} ms on {where}", flush=True)
        del args, got, ref, again
    report = build.library_path().with_suffix(".ptxas.txt").read_text()
    for name, text in ptxas_lines(report, "mix_(?:rows|cols)"):
        print(f"ptxas {name}: {text}", flush=True)
        assert " 0 bytes spill stores, 0 bytes spill loads" in text, name
    return errs, ms, bnd, library[torch.float64], \
        sweep_launches["mc_mix_rows"]


def phase_fit_mixture(build, dev, where):
    """Full-size mixture fits through the kernel route; every mixture
    kernel launches at least once per EM step of the chain batch."""
    from multiclust_tpu_torch.api import fit_dataset
    from multiclust_tpu_torch.convert import dataset_from_counts

    base = dict(admixture=False, min_K=K_FULL, max_K=K_FULL, n_init=2,
                max_iter=100, seed=3, verbosity=2)
    panels = {}
    for miss_rate in (0.0, 0.01):
        counts, miss = mixture_counts(80, I_FULL, L_FULL, K_FULL,
                                         miss_rate, dev)
        panels[miss_rate] = dataset_from_counts(counts, miss, 2)
    assert not panels[0.0].miss.any() and panels[0.01].miss.any()

    def timed_fit(label, miss_rate, **kw):
        t0 = time.time()
        out = fit_dataset(panels[miss_rate], device=dev, **base, **kw)
        torch.cuda.synchronize()
        return check_fit(out, time.time() - t0, label, where)

    build.reset_launch_counts()
    fits = [timed_fit("mixture plain EM", 0.0),
            timed_fit("mixture SQUAREM", 0.0, accel_scheme=1),
            timed_fit("mixture plain EM 1 % missing", 0.01)]
    launches = {name: build.LAUNCHES[name] for name in MIX_KERNELS}
    print(f"launches in the mixture fits: {build.kernel_launches()}",
          flush=True)
    # one launch of each kernel serves the whole chain batch (2 lanes);
    # a step launches one columns pass and one finish (SQUAREM's logL a
    # rows pass alone)
    steps = sum(r.n_iter_all for r in fits) // 2
    for name, n in launches.items():
        assert n >= steps > 0, (name, n, steps)
    assert launches["mc_mix_finish"] == launches["mc_mix_cols"], launches
    assert not any(build.LAUNCHES[name]
                   for name in BI_KERNELS + GENERIC_KERNELS)
    return launches


def phase_reference_mixture(build, dev):
    """A small warm-start mixture fit through the kernels, held to the
    plain float64 step on the CPU over at most 30 iterations."""
    from multiclust_tpu_torch.convert import model_data_from_numpy, \
        params_from_numpy
    from multiclust_tpu_torch.model.common import EMConfig
    from multiclust_tpu_torch.opt.driver import fit

    I, L, K = 600, 500, 3
    # weakly separated clusters keep the posteriors soft, so the fit runs
    # its 30 iterations instead of settling in a few
    counts, miss = mixture_counts(81, I, L, K, 0.05, "cpu", spread=0.04)
    mask, n_all = np.ones((L, 2), bool), np.full(L, 2)
    rng = np.random.default_rng(82)
    eta = rng.dirichlet(np.full(K, 3.0))
    p0 = rng.uniform(0.2, 0.8, size=(K, L))
    p = np.stack([p0, 1 - p0], axis=2)
    base = dict(admixture=False, has_missing=True, biallelic=True, ploidy=2,
                max_iter=30, abs_error=1e-12, eta_lower_bound=1e-8,
                p_lower_bound=1e-8)
    cpu = fit(params_from_numpy(eta, p),
              model_data_from_numpy(counts, miss, mask, n_all),
              EMConfig(**base))
    build.reset_launch_counts()
    gpu = fit(params_from_numpy(eta, p, device=dev, dtype=torch.float32),
              model_data_from_numpy(counts, miss, mask, n_all, device=dev,
                                    dtype=torch.float32),
              EMConfig(use_pallas="on", **base))
    print(f"reference mixture fit: kernel path logL {gpu.logL:.4f} after "
          f"{gpu.n_iter} iterations vs float64 CPU {cpu.logL:.4f} after "
          f"{cpu.n_iter}", flush=True)
    assert build.LAUNCHES["mc_mix_rows"] >= gpu.n_iter > 20
    assert gpu.n_iter <= 31 and cpu.n_iter <= 31
    assert abs(gpu.logL - cpu.logL) < 0.1


def phase_fit_mixture_generic(build, dev, where):
    """One M=4 mixture fit through the plain route: products in torch, the
    eta finish (the finish's eta half) and the p epilogue on the card."""
    from multiclust_tpu_torch.api import fit_dataset
    from multiclust_tpu_torch.convert import dataset_from_counts

    counts, miss, _ = generic_counts(83, I_FULL, L_FULL,
                                     np.full(L_FULL, M_FULL), K_FULL, 0.01,
                                     dev)
    ds = dataset_from_counts(counts.cpu().numpy(), miss.cpu().numpy(), 2)
    build.reset_launch_counts()
    t0 = time.time()
    out = fit_dataset(ds, device=dev, admixture=False, min_K=K_FULL,
                      max_K=K_FULL, n_init=2, max_iter=100, seed=3,
                      verbosity=2)
    torch.cuda.synchronize()
    res = check_fit(out, time.time() - t0, "mixture M=4 plain EM", where)
    print(f"launches in the M=4 mixture fit: {build.kernel_launches()}",
          flush=True)
    steps = res.n_iter_all // 2
    assert build.LAUNCHES["mc_mix_finish"] >= steps > 0
    assert build.LAUNCHES["mc_fullstep_p"] >= steps
    assert not build.LAUNCHES["mc_mix_rows"]


def phase_cli_mixture(build, where):
    """The CLI without -a (the mixture, through its kernels) and with
    -a -c (constrained eta, on the collapsed data)."""
    from multiclust_tpu_torch.cli import main

    counts, miss = mixture_counts(84, 1024, 1000, 3, 0.05, "cpu")
    for flags in ([], ["-a", "-c"]):
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "sim.str")
            write_structure(path, counts, miss)
            build.reset_launch_counts()
            t0 = time.time()
            rc = main(["-f", path, "-k", "3", "-n", "4", "-s", "1",
                       "-d", tmp] + flags)
            torch.cuda.synchronize()
            assert rc == 0, rc
            outs = [f for f in os.listdir(tmp) if f != "sim.str"]
            assert len(outs) == 5, outs
            assert all(os.path.getsize(os.path.join(tmp, f)) > 0
                       for f in outs), outs
        launches = {name: build.LAUNCHES[name] for name in MIX_KERNELS}
        if not flags:
            assert all(n > 0 for n in launches.values()), launches
        print(f"cli {' '.join(flags) or '(mixture)'}: rc 0 in "
              f"{time.time() - t0:.2f} s, files {sorted(outs)}, launches "
              f"{launches} on {where}", flush=True)


def max_err_cast(got, ref) -> float:
    """max_err across the routes' t dtypes (float32 or float64)."""
    return max_err(got.to(ref.dtype), ref)


def phase_biobank_kernels(fb, dev, where):
    """The three routes of the biallelic step at 8192 x 131072 against the
    windowed plain version, then each new kernel alone at the fits' shape
    (chain batch 2) for the kernels' record, then the rows passes at
    2048 x 524288."""
    from multiclust_tpu_torch.route_times import device_panel, \
        device_step_params

    K, Kp = K_FULL, 32
    kw = dict(k_true=K, lb=1e-8, plb=1e-8, project=True)
    planes, miss = device_panel(90, I_BIO, L_BIO, K, 0.01, dev)
    x0, x1 = planes[0], planes[1]
    c = miss.sum(dim=1, dtype=torch.float32)
    n_sm = fb.device_sm_count(dev)
    errs = {k: 0.0 for k in ("rows_seg", "finish", "cols_window", "chunked")}
    quick = dict(n=5, warm=1)
    for B in (1, 2):
        eta, p0 = device_step_params(91 + B, B, I_BIO, L_BIO, K, Kp, dev)
        _, seg_cols = fb.row_segments(B, I_BIO, L_BIO, n_sm, k_true=K, Kp=Kp)
        routes = {
            "pair": lambda **k: fb.admixture_fullstep_biallelic(
                eta, p0, x0, x1, c, miss, **kw, **k),
            "streamed": lambda **k: fb.admixture_fullstep_biallelic_streamed(
                eta, p0, x0, x1, c, miss, seg_cols=seg_cols, **kw, **k),
            "chunked": lambda **k: fb.admixture_fullstep_biallelic_chunked(
                eta, p0, x0, x1, c, miss, window=L_BIO // 4, **kw, **k),
        }
        for compute_t in (True, False):
            ref = fb.admixture_fullstep_biallelic_streamed_reference(
                eta, p0, x0, x1, c, miss, compute_t=compute_t, **kw)
            for name, fn in routes.items():
                got = fn(compute_t=compute_t)
                torch.cuda.synchronize()
                e_eta, e_t, e_p = (max_err_cast(g, r)
                                   for g, r in zip(got, ref))
                assert (got[0][..., K:] == 0).all()
                assert (got[2][:, K:] == 0).all()
                if name != "pair":
                    key = "chunked" if name == "chunked" else "rows_seg"
                    errs[key] = max(errs[key], e_eta, e_t)
                    errs["cols_window"] = max(errs["cols_window"], e_p)
                k_ms = median_ms(lambda: fn(compute_t=compute_t), **quick)
                cells = B * I_BIO * L_BIO * 2
                print(f"biobank step {name} B={B} compute_t={compute_t}: "
                      f"max|d| eta'={e_eta:.3e} t={e_t:.3e} p0'={e_p:.3e} "
                      f"(rtol {RTOL}, atol {ATOL}); kernel {k_ms:.3f} ms "
                      f"({cells / k_ms / 1e6:.2f} Gcells/s) on {where}",
                      flush=True)
            del ref, got
        if B == 2:
            break
        del eta, p0, routes
        torch.cuda.empty_cache()

    # the raw outputs once (chain batch 2): emit_b, and emit_a + emit_b
    for emit_a in (False, True):
        ref = fb.admixture_fullstep_biallelic_streamed_reference(
            eta, p0, x0, x1, c, miss, emit_a=emit_a, emit_b=True, **kw)
        for name in ("streamed", "chunked"):
            got = routes[name](emit_a=emit_a, emit_b=True)
            torch.cuda.synchronize()
            e = [max_err_cast(g, r) for g, r in zip(got, ref)]
            key = "chunked" if name == "chunked" else "rows_seg"
            errs[key] = max(errs[key], e[0], e[1])
            errs["cols_window"] = max(errs["cols_window"], e[2], e[3])
            print(f"biobank {name} emit_a={emit_a} emit_b=True B=2: max|d| "
                  f"first={e[0]:.3e} t={e[1]:.3e} B0={e[2]:.3e} "
                  f"B1={e[3]:.3e} on {where}", flush=True)
        del ref, got

    # each new kernel alone at the fits' shape (chain batch 2)
    win = dict(l_lo=0, l_hi=L_BIO)
    fin = dict(k_true=K, lb=1e-8, project_eta=True)
    apart, tpart = fb.rows_partials(eta, p0, x0, x1, seg_cols=seg_cols,
                                    k_true=K, **win)
    outs = (torch.empty_like(p0),)
    outs_ref = (torch.empty_like(p0),)

    def cols(fn, o, **kw):
        fn(eta, p0, x0, x1, miss, o, plb=1e-8, project=True, **win, **kw)
        return o

    # the p0 epilogue alone on partials of the fits' row segments
    route = fb.pick_route(2, I_BIO, L_BIO, Kp, n_sm, fb.scratch_budget(dev),
                          K)
    gen = torch.Generator(device=dev).manual_seed(94)
    part = segment_partials(gen, 2, route.n_rseg, Kp, L_BIO,
                            fb.lane_tile(K, Kp).kc, dev)
    e_p0, p0_kernel, p0_plain = check_p0_epilogue(fb, p0, part, K)
    errs["p0_epilogue"] = e_p0
    passes = {
        # the partials, compared summed over segments
        "rows_seg": (lambda: tuple(t.sum(dim=1) for t in fb.rows_partials(
                         eta, p0, x0, x1, seg_cols=seg_cols, k_true=K,
                         **win)),
                     lambda: tuple(t[:, 0] for t in
                                   fb.rows_partials_reference(
                                       eta, p0, x0, x1, **win))),
        "finish": (lambda: fb.rows_finish(eta, apart, tpart, c, **fin),
                   lambda: fb.rows_finish_reference(eta, apart, tpart, c,
                                                    **fin)),
        "cols_window": (lambda: cols(fb.cols_window, outs, k_true=K),
                        lambda: cols(fb.cols_window_reference, outs_ref)),
        "chunked": (lambda: routes["chunked"](),
                    lambda: fb.admixture_fullstep_biallelic_chunked_reference(
                        eta, p0, x0, x1, c, miss, window=L_BIO // 4, **kw)),
        "p0_epilogue": (p0_kernel, p0_plain),
    }
    # operations as the pair's: d0 and A (rows), d0, B0 and B1 (columns),
    # 2 a multiply-add per cell and cluster, plus the elementwise terms;
    # the finish ~10 a live partial entry
    cells = 2 * I_BIO * L_BIO
    kc = fb.lane_tile(K, Kp).kc
    # the epilogue one add a live partial entry and ~6 an output
    flop = {"rows_seg": (4 * K + 10) * cells,
            "finish": 10 * apart.numel() // Kp * kc,
            "cols_window": (6 * K + 6) * cells,
            "chunked": (10 * K + 16) * cells,
            "p0_epilogue": part.numel() // Kp * kc + 6 * p0.numel()}
    inputs = {"rows_seg": (eta, p0, x0, x1), "finish": (eta, apart, tpart, c),
              "cols_window": (eta, p0, x0, x1, miss),
              "chunked": (eta, p0, x0, x1, c, miss),
              "p0_epilogue": (p0, part)}
    ms, bnd = {}, {}
    for name, (kernel, plain) in passes.items():
        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        err = max(max_err_cast(g, r) for g, r in zip(got, ref))
        errs[name] = max(errs[name], err)
        bnd[name] = bound(tensors_bytes(inputs[name], got), flop[name])
        del got, ref
        ms[name] = (median_ms(kernel, **quick),
                    median_ms(plain, n=2, warm=1))
        print(f"biobank pass {name} B=2: max|d| {err:.3e}; kernel "
              f"{ms[name][0]:.3f} ms, plain {ms[name][1]:.3f} ms, bound "
              f"{bnd[name][0]:.3f} ms ({bnd[name][1]}) on {where}",
              flush=True)
    # the reductions' records take their bound from the live lanes they
    # read, every tensor once beside it
    fin_bnd, p0_bnd = reduction_bytes(fb, 2, I_BIO, L_BIO, Kp, K,
                                      apart.shape[1], route.n_rseg)
    for name, b in (("finish", fin_bnd), ("p0_epilogue", p0_bnd)):
        bnd[name] = bound(b[1], flop[name]) + (bound(b[0], flop[name])[0],)
    # the t-only kernel (the logL terms) on the fits' column segments
    none, t_only = fb.rows_finish(eta, None, tpart, c, k_true=K, lb=1e-8,
                                  project_eta=True)
    assert none is None and torch.equal(t_only, fb.ordered_segment_sum(
        tpart, dtype=torch.float64))
    del t_only
    print(f"biobank reductions B=2: "
          f"{share_line('finish', ms['finish'][0], fin_bnd)}; "
          f"{share_line('p0 epilogue', ms['p0_epilogue'][0], p0_bnd)} on "
          f"{where}", flush=True)
    t_ms = median_ms(lambda: fb.rows_log_likelihood_terms(
        eta, p0, x0, x1, k_true=K), **quick)
    print(f"biobank logL terms alone (rows pass, A phase skipped) B=2: "
          f"{t_ms:.3f} ms on {where}", flush=True)
    del planes, miss, x0, x1, c, eta, p0, apart, tpart, outs, outs_ref, \
        routes, passes, part, p0_kernel, p0_plain
    torch.cuda.empty_cache()

    # the rows passes where the panel is short: 2048 x 524288
    planes, miss = device_panel(95, I_NARROW, L_NARROW, K, 0.01, dev)
    x0, x1 = planes[0], planes[1]
    c = miss.sum(dim=1, dtype=torch.float32)
    row_kw = dict(k_true=K, lb=1e-8, project=True, compute_t=True)
    for B in (1, 2):
        eta, p0 = device_step_params(96 + B, B, I_NARROW, L_NARROW, K, Kp,
                                     dev)
        n_seg, seg_cols = fb.row_segments(B, I_NARROW, L_NARROW, n_sm,
                                          k_true=K, Kp=Kp)
        ref_a, ref_t = fb.rows_partials_reference(
            eta, p0, x0, x1, l_lo=0, l_hi=L_NARROW)
        ref = fb.rows_finish_reference(eta, ref_a, ref_t, c, **fin)

        def seg_rows():
            return fb.rows_finish(eta, *fb.rows_partials(
                eta, p0, x0, x1, l_lo=0, l_hi=L_NARROW, seg_cols=seg_cols,
                k_true=K), c, **fin)

        def pair_rows():
            return fb.fullstep_bi_rows(eta, p0, x0, x1, c, **row_kw)

        line = []
        for name, fn in (("segmented", seg_rows), ("unsegmented", pair_rows)):
            got = fn()
            torch.cuda.synchronize()
            e = [max_err_cast(g, r) for g, r in zip(got, ref)]
            errs["rows_seg"] = max(errs["rows_seg"], *e) \
                if name == "segmented" else errs["rows_seg"]
            line.append(f"{name} max|d| eta'={e[0]:.3e} t={e[1]:.3e} "
                        f"{median_ms(fn, **quick):.3f} ms")
            del got
        print(f"narrow rows pass {I_NARROW} x {L_NARROW} B={B} ({n_seg} "
              f"segments of {seg_cols}): " + "; ".join(line) + f" on {where}",
              flush=True)
        del eta, p0, ref_a, ref_t, ref
        torch.cuda.empty_cache()
    return errs, ms, bnd


def phase_redesign_shapes(fb, build, dev, where):
    """The two redesigned kernels of the biallelic step (the segmented
    rows pass with the loop it shares with the fused rows kernel, and the
    windowed columns pass) where the fits do not take them: Kp = 64 and
    128 (K = 40, 100), an unaligned panel (I = 1000, L = 1003: byte
    loads) and a window with an odd start, each against its plain version
    and rerun bit-equal; then what the compiler made of them."""
    from multiclust_tpu_torch.kernel_report import ptxas_lines

    rng = np.random.default_rng(110)
    cases = [("Kp=64", 1, 4096, 4096, 40, 64, 0, 4096),
             ("Kp=128", 1, 4096, 4096, 100, 128, 0, 4096),
             ("unaligned 1000 x 1003", 2, 1000, 1003, 20, 32, 0, 1003),
             ("odd window start", 2, 4096, 4096, 20, 32, 1001, 3999)]
    for label, B, I, L, K, Kp, l_lo, l_hi in cases:
        eta, p0, x0, x1, c, miss = step_inputs(rng, B, I, L, K, Kp, 0.02, dev)
        win = dict(l_lo=l_lo, l_hi=l_hi)
        seg_cols = -(-(l_hi - l_lo) // 3 // 32) * 32

        def rows():
            return fb.rows_partials(eta, p0, x0, x1, seg_cols=seg_cols,
                                    k_true=K, **win)

        def cols():
            outs = (torch.zeros_like(p0), torch.zeros_like(p0))
            fb.cols_window(eta, p0, x0, x1, miss, outs, plb=1e-8,
                           project=True, k_true=K, n_rseg=3, **win)
            return outs

        ref_a, ref_t = fb.rows_partials_reference(eta, p0, x0, x1, **win)
        refs = (torch.zeros_like(p0), torch.zeros_like(p0))
        fb.cols_window_reference(eta, p0, x0, x1, miss, refs, plb=1e-8,
                                 project=True, **win)
        (apart, tpart), outs = rows(), cols()
        torch.cuda.synchronize()
        errs = [max_err(apart.sum(dim=1), ref_a[:, 0]),
                max_err_cast(tpart.double().sum(dim=1), ref_t[:, 0]),
                max_err(outs[0], refs[0]), max_err(outs[1], refs[1])]
        again_rows, again_cols = rows(), cols()
        assert torch.equal(apart, again_rows[0])
        assert torch.equal(tpart, again_rows[1])
        assert all(torch.equal(u, v) for u, v in zip(outs, again_cols))
        assert all((o[:, K:] == 0).all() for o in outs)
        print(f"redesigned kernels, {label} (B={B}, {I} x {L}, K={K}, "
              f"window [{l_lo}, {l_hi})): max|d| raw A + r {errs[0]:.3e}, "
              f"t {errs[1]:.3e}, B0 {errs[2]:.3e}, B1 {errs[3]:.3e} (rtol "
              f"{RTOL}, atol {ATOL}); reruns bit-equal; rows pass "
              f"{median_ms(rows, n=5, warm=1):.3f} ms, columns pass "
              f"{median_ms(cols, n=5, warm=1):.3f} ms on {where}",
              flush=True)
    report = build.library_path().with_suffix(".ptxas.txt").read_text()
    for name, text in ptxas_lines(
            report, "fullstep_bi_(?:rows|rows_seg|cols)_|rows_finish"
            "|fullstep_p_kernel"):
        print(f"ptxas {name}: {text}", flush=True)
        assert " 0 bytes spill stores, 0 bytes spill loads" in text, name


def phase_biobank_fits(build, dev, where):
    """Whole fits at the biobank widths through ``api.fit_model_data``, the
    panels made on the card: 8192 x 131072 under plain EM and SQUAREM (the
    streamed route), 2048 x 524288 under plain EM (the chunked loop)."""
    from multiclust_tpu_torch.api import fit_model_data
    from multiclust_tpu_torch.init.random import init_window
    from multiclust_tpu_torch.model.common import model_data_from_planes
    from multiclust_tpu_torch.route_times import device_panel

    base = dict(admixture=True, min_K=K_FULL, max_K=K_FULL, n_init=2,
                seed=3, verbosity=2)

    def count_windows(md, fits):
        # every start counts each window of its loci in one launch
        windows = -(-md.L // init_window(md, 2))
        starts = sum(r.n_launched for r in fits)
        print(f"admixture starts' counts: {starts} starts x {windows} "
              f"windows of {md.I} x {md.L}", flush=True)
        assert windows > 1 and starts > 0, (windows, starts)
        return starts * windows

    def timed_fit(md, label, route, **kw):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        out = fit_model_data(md, 2, **base, **kw)
        torch.cuda.synchronize()
        res = check_fit(out, time.time() - t0, label, where, md=md)
        assert res.route.startswith(route), (label, res.route)
        print(f"fit {label}: route {res.route}, {res.batch_chains} chains in "
              f"lockstep, peak allocation "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB of "
              f"which the panel {tensors_bytes(md.x0, md.x1, md.miss) / 2 ** 30:.2f}"
              f" GiB, on {where}", flush=True)
        return res

    build.reset_launch_counts()
    md = model_data_from_planes(*device_panel(100, I_BIO, L_BIO, K_FULL,
                                              0.01, dev))
    fits = [timed_fit(md, "biobank plain EM", "streamed", max_iter=50),
            timed_fit(md, "biobank SQUAREM", "streamed", max_iter=50,
                      accel_scheme=1)]
    stream_steps = sum(r.n_iter_all for r in fits) // 2
    assert build.LAUNCHES["mc_fullstep_bi_rows_seg"] >= stream_steps > 0
    assert not build.LAUNCHES["fullstep_bi_chunked"]
    counts = count_windows(md, fits)
    # the int8 planes' starts count from the planes: no codes
    assert build.LAUNCHES["mc_allele_counts_planes"] == counts, \
        (build.LAUNCHES["mc_allele_counts_planes"], counts)
    assert not build.LAUNCHES["mc_allele_counts"]
    del md
    torch.cuda.empty_cache()
    md = model_data_from_planes(*device_panel(101, I_NARROW, L_NARROW,
                                              K_FULL, 0.01, dev))
    narrow = timed_fit(md, "narrow plain EM", "chunked", max_iter=20)
    counts += count_windows(md, [narrow])
    del md
    torch.cuda.empty_cache()
    launches = {name: build.LAUNCHES[name]
                for name in STREAM_KERNELS + ("fullstep_bi_chunked",
                                              "mc_allele_counts_planes")}
    print(f"launches in the biobank fits: {build.kernel_launches()}",
          flush=True)
    assert launches["mc_allele_counts_planes"] == counts, \
        (launches["mc_allele_counts_planes"], counts)
    assert not build.LAUNCHES["mc_allele_counts"]
    # one launch of each kernel serves the whole chain batch (2 lanes),
    # and the chunked loop makes one for each of its windows
    steps = stream_steps + narrow.n_iter_all // 2
    for name in STREAM_KERNELS:
        assert launches[name] >= steps, (name, launches[name], steps)
    assert launches["fullstep_bi_chunked"] >= 2 * (narrow.n_iter_all // 2)
    assert not build.LAUNCHES["mc_fullstep_bi_rows"]
    return launches


def phase_biobank_reference(build, dev):
    """A warm-start fit at the full biobank width and a reduced height
    (256 x 131072, so the t sums run over 131072 loci) through the
    streamed route, held to the plain float64 step on the CPU over the
    same 30 iterations.  At |logL| ~ 4e7 the float32 terms alone differ
    from float64 ones by more than the 0.1 that the small reference fits
    are held to (a fifth of an ulp a term is 0.8 over 3e7 terms), so both
    the trajectories and the t sums themselves (the kernel's float32 terms
    under its float64 finish, against float64 terms at the same
    parameters) are held to the noise floor that the convergence test
    reads there, noise_factor x eps x scale (opt/em.py)."""
    from multiclust_tpu_torch.convert import model_data_from_numpy, \
        params_from_numpy
    from multiclust_tpu_torch.model.admixture import log_likelihood_bi_repr
    from multiclust_tpu_torch.model.common import EMConfig, Params
    from multiclust_tpu_torch.opt.driver import fit
    from multiclust_tpu_torch.runtime.multistart import _pad_k, _to_bi_repr

    rng = np.random.default_rng(104)
    I, L, K = 256, L_BIO, 3
    counts, miss = simulated_counts(rng, I, L, K, 0.01)
    mask, n_all = np.ones((L, 2), bool), np.full(L, 2)
    eta = rng.dirichlet(np.full(K, 2.0), size=I)
    p0 = rng.uniform(0.2, 0.8, size=(K, L))
    p = np.stack([p0, 1 - p0], axis=2)
    base = dict(admixture=True, has_missing=True, biallelic=True, k_true=K,
                max_iter=30, abs_error=1e-12, eta_lower_bound=1e-8,
                p_lower_bound=1e-8)
    t0 = time.time()
    md64 = model_data_from_numpy(counts, miss, mask, n_all)
    cpu = fit(params_from_numpy(eta, p), md64, EMConfig(**base))
    t_cpu = time.time() - t0
    cfg = EMConfig(use_pallas="on", **base)
    warm = params_from_numpy(eta, p, device=dev, dtype=torch.float32)
    md32 = model_data_from_numpy(counts, miss, mask, n_all, device=dev,
                                 dtype=torch.float32)
    build.reset_launch_counts()
    gpu = fit(_to_bi_repr(_pad_k(warm, cfg), cfg), md32, cfg)
    gap = gpu.logL - cpu.logL
    # the t sums alone: the fitted float32 parameters scored by the rows
    # pass on the card and by float64 terms on the CPU
    final = gpu.state.params
    ll32 = float(log_likelihood_bi_repr(final, md32)[0][0])
    ll64 = float(log_likelihood_bi_repr(
        Params(eta=final.eta.double().cpu(), p=final.p.double().cpu()),
        md64)[0][0])
    floor = (cfg.noise_factor * torch.finfo(torch.float32).eps
             * float(gpu.state.scale[0]))
    print(f"biobank reference fit {I} x {L}: streamed route logL "
          f"{gpu.logL:.4f} vs float64 CPU {cpu.logL:.4f} (gap {gap:+.4f}, "
          f"{abs(gap / cpu.logL):.2e} of |logL|) after {gpu.n_iter} "
          f"iterations; t sums at the fitted parameters {ll32:.4f} on the "
          f"card vs {ll64:.4f} in float64 (gap {ll32 - ll64:+.4f}); the "
          f"convergence test's noise floor there {floor:.4f}; the CPU fit "
          f"took {t_cpu:.1f} s", flush=True)
    assert gpu.n_iter == cpu.n_iter == 31
    assert build.LAUNCHES["mc_fullstep_bi_rows_seg"] >= 31
    assert not build.LAUNCHES["mc_fullstep_bi_rows"]
    assert abs(gap) < floor and abs(ll32 - ll64) < floor


def phase_biobank_mixture_kernels(mb, dev, where):
    """The mixture step and the sweep at 8192 x 131072, 2 chains, one
    stream and two (1 % missing), against their plain versions, with the
    row segments the columns wrapper picks (one segment of hundreds of
    stages here); the columns pass alone on a soft v, whose v sums are
    fractional over the whole segment."""
    from multiclust_tpu_torch.ops.fullstep_bi import device_sm_count
    from multiclust_tpu_torch.route_times import mixture_step_inputs

    K, Kp, B = K_FULL, 32, 2
    kw = dict(k_true=K, lb=1e-8, plb=1e-8, ploidy=2, project=True)
    errs = {"rows": 0.0, "cols": 0.0, "finish": 0.0, "sweep": 0.0}
    gen = torch.Generator(device=dev).manual_seed(107)
    for seed, miss_rate in ((108, 0.0), (109, 0.01)):
        args = mixture_step_inputs(seed, B, I_BIO, L_BIO, K, Kp, miss_rate,
                                   dev)
        two = miss_rate > 0
        n_seg, seg_rows = mb.cols_segments(I_BIO, L_BIO, B, Kp, two,
                                           device_sm_count(dev))
        got = mb.mixture_fullstep_biallelic(*args, **kw)
        ref = mb.mixture_fullstep_biallelic_reference(*args, **kw)
        torch.cuda.synchronize()
        e_eta, e_t, e_p = (max_err(g, r) for g, r in zip(got, ref))
        assert (got[0][:, K:] == 0).all()
        del got, ref
        sweep = mb.mixture_sweep_stats(*args, k_true=K)
        sweep_ref = mb.mixture_sweep_stats_reference(*args)
        torch.cuda.synchronize()
        e_sw = max(max_err(g, r) for g, r in zip(sweep, sweep_ref)
                   if g is not None)
        del sweep, sweep_ref
        # a soft v: softmax of N(0, 1) scores over the K live lanes
        v = torch.zeros((B, I_BIO, Kp), device=dev)
        v[..., :K] = torch.softmax(torch.randn((B, I_BIO, K), generator=gen,
                                               device=dev), dim=-1)
        x0, x1 = args[1], args[4]
        cols = [t.sum(dim=1)
                for t in mb.mixture_partials(v, x0, x1, k_true=K)]
        cols_ref = [t[:, 0] for t in mb.mixture_cols_reference(v, x0, x1)]
        torch.cuda.synchronize()
        e_c = max(max_err(g, r) for g, r in zip(cols, cols_ref))
        for name, err in (("finish", max(e_eta, e_p)), ("rows", e_t),
                          ("sweep", e_sw), ("cols", e_c)):
            errs[name] = max(errs[name], err)
        print(f"mixture step {I_BIO} x {L_BIO} B={B} miss={miss_rate:.2f} "
              f"({'two streams' if two else 'one stream'}; columns pass in "
              f"{n_seg} row segment(s) of {seg_rows} rows, "
              f"{-(-seg_rows // mb.COL_RI)} stages of {mb.COL_RI}): max|d| "
              f"eta'={e_eta:.3e} t={e_t:.3e} p0'={e_p:.3e} sweep={e_sw:.3e}, "
              f"columns pass on a soft v {e_c:.3e} (rtol {RTOL}, atol "
              f"{ATOL}) on {where}", flush=True)
        del args, v, cols, cols_ref
        torch.cuda.empty_cache()
    return errs


def phase_biobank_mixture(build, dev, where):
    """One mixture fit at 8192 x 131072 through the mixture kernels."""
    from multiclust_tpu_torch.api import fit_model_data
    from multiclust_tpu_torch.model.common import model_data_from_planes
    from multiclust_tpu_torch.route_times import device_panel

    md = model_data_from_planes(*device_panel(105, I_BIO, L_BIO, K_FULL,
                                              0.01, dev))
    build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    out = fit_model_data(md, 2, admixture=False, min_K=K_FULL, max_K=K_FULL,
                         n_init=2, max_iter=30, seed=3, verbosity=2)
    torch.cuda.synchronize()
    res = check_fit(out, time.time() - t0, "biobank mixture plain EM", where,
                    md=md)
    launches = {name: build.LAUNCHES[name] for name in MIX_KERNELS}
    print(f"biobank mixture fit: launches {launches}, peak allocation "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB on {where}",
          flush=True)
    assert all(n >= res.n_iter_all // 2 > 0 for n in launches.values())


def phase_cli_biobank(build, where, tmp):
    """The CLI on a short and wide file, 512 x 8192, which the router
    sends down the streamed route; the file stays in ``tmp``."""
    from multiclust_tpu_torch.cli import main

    rng = np.random.default_rng(106)
    counts, miss = simulated_counts(rng, 512, 8192, 3, 0.02)
    path = os.path.join(tmp, "sim.str")
    write_structure_biallelic(path, counts, miss)
    build.reset_launch_counts()
    t0 = time.time()
    rc = main(["-f", path, "-a", "-k", "3", "-n", "4", "-d", tmp])
    torch.cuda.synchronize()
    launches = {name: build.LAUNCHES[name]
                for name in STREAM_KERNELS + ("mc_fullstep_bi_rows",)}
    assert rc == 0, rc
    for f in OUT_FILES:
        assert os.path.getsize(os.path.join(tmp, f)) > 0, f
    assert all(launches[name] > 0 for name in STREAM_KERNELS), launches
    assert not launches["mc_fullstep_bi_rows"], launches
    print(f"cli 512 x 8192: rc 0 in {time.time() - t0:.2f} s, launches "
          f"{launches} on {where}", flush=True)
    return path


def route_kernels(route: str):
    """The kernels a biallelic admixture step of ``route`` launches
    (ops/fullstep_bi.Route.describe)."""
    if route.startswith("pair"):
        return BI_KERNELS
    if route.startswith("chunked"):
        return STREAM_KERNELS + ("fullstep_bi_chunked",)
    return STREAM_KERNELS


def phase_bootstrap(build, dev, where, cli_path):
    """The bootstrap LRT (-b) through ``api.fit_model_data`` on two
    16384 x 2048 panels made on the card, then resumed from a checkpoint,
    then the -w and -v 4 CLI runs on ``cli_path``."""
    import contextlib
    import io

    from multiclust_tpu_torch.api import fit_model_data
    from multiclust_tpu_torch.cli import main
    from multiclust_tpu_torch.config import Options
    from multiclust_tpu_torch.model.common import Lattice, map_params, \
        model_data_from_planes
    from multiclust_tpu_torch.opt import em as em_mod
    from multiclust_tpu_torch.route_times import device_panel, \
        mixture_planes
    from multiclust_tpu_torch.runtime.multistart import _to_bi_repr, \
        cfg_from_options, fit_batch
    from multiclust_tpu_torch.stats import bootstrap as bs
    from torch.profiler import ProfilerActivity, profile

    K, B, n_reps, seed = 3, 2, BOOT_REPS, 11
    base = dict(min_K=K, max_K=K, n_init=B, n_bootstrap=n_reps, seed=seed,
                verbosity=0)

    def run(label, md, admixture, **kw):
        build.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        out = fit_model_data(md, 2, admixture=admixture, **base, **kw)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = build.kernel_launches()
        boot = out.bootstrap
        ts = np.asarray(boot.ts_bs)
        cells = md.I * md.L * md.M * boot.chain_iterations
        print(f"bootstrap {label}: ts_obs {out.estimate.ts:.4f}, p-value "
              f"{boot.pvalue}, ts {[round(t, 4) for t in boot.ts_bs]}; "
              f"chunk {boot.chunk} replicates x {B} chains, routes "
              f"{boot.routes or 'mixture kernels'}; fit_model_data "
              f"{wall:.3f} s, bootstrap {boot.seconds:.3f} s "
              f"({boot.seconds / n_reps:.3f} s a replicate, "
              f"{boot.chain_iterations} chain-iterations, "
              f"{cells / max(boot.seconds, 1e-9) / 1e9:.2f} Gcells/s); peak "
              f"allocation {torch.cuda.max_memory_allocated() / 2 ** 30:.2f}"
              f" GiB; launches {({k: n for k, n in launches.items() if n})}"
              f" on {where}", flush=True)
        assert len(ts) == n_reps and np.isfinite(ts).all(), (label, ts)
        return out, launches, wall

    def refit_replicate_0(label, md, out, admixture, **kw):
        """Replicate 0 alone from its lattice starts, and one lattice step
        of replicates 0 and 1 that reads nothing from the device."""
        opt = Options(admixture=admixture, **base, **kw).synchronize(md.I, 2)
        reps = [bs.draw_replicate(seed, r, md, out.estimate.h0_params, 2,
                                  admixture) for r in (0, 1)]
        maxll = {}
        for k in (K - 1, K):
            cfg = cfg_from_options(opt, k, md)
            starts = [bs.replicate_starts(seed, r, k, rep, cfg, opt)
                      for r, rep in enumerate(reps)]
            state, _ = fit_batch(starts[0], bs._fit_data(reps[0], cfg), cfg)
            maxll[k] = float(state.logL.max())
        lat = Lattice(reps=tuple(reps), B=B, live=frozenset({0, 1}))
        params = _to_bi_repr(map_params(lambda *t: torch.cat(t), *starts),
                             cfg)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            em_mod.model_em_step(params, lat, cfg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        ts0 = maxll[K] - maxll[K - 1]
        print(f"bootstrap {label}: replicate 0 refitted alone: ts "
              f"{ts0:.6f} against the lattice's {out.bootstrap.ts_bs[0]:.6f}"
              f"; a lattice step of 2 replicates read nothing from the "
              f"device", flush=True)
        assert ts0 == out.bootstrap.ts_bs[0], (label, ts0)

    # (a) the default model
    md = model_data_from_planes(*mixture_planes(200, I_FULL, L_FULL, K, 0.01,
                                                dev))
    out, launches, _ = run("mixture", md, False)
    assert out.bootstrap.pvalue == 0.0, out.bootstrap.pvalue
    steps = out.bootstrap.chain_iterations // B
    assert all(launches[k] >= steps > 0 for k in MIX_KERNELS), launches
    refit_replicate_0("mixture", md, out, False)
    del md

    # (b) admixture, and (c) the same resumed from a checkpoint
    md = model_data_from_planes(*device_panel(201, I_FULL, L_FULL, K, 0.01,
                                              dev))
    out, launches, wall = run("admixture", md, True, max_iter=100)
    assert out.bootstrap.pvalue == 0.0, out.bootstrap.pvalue
    steps = out.bootstrap.chain_iterations // B
    for route in out.bootstrap.routes.values():
        assert all(launches[k] > 0 for k in route_kernels(route)), launches
    assert sum(launches[k] for k in BI_ROWS) >= steps > 0, launches
    refit_replicate_0("admixture", md, out, True, max_iter=100)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        # the checkpointed run under torch.profiler: the device's busy
        # share of a bootstrap whose lattices loop over their replicates
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            first, _, w1 = run("admixture, checkpointed", md, True,
                               max_iter=100, checkpoint_dir=ckpt_dir)
        busy = sum(ev.self_device_time_total for ev in prof.key_averages()
                   if ev.device_type == torch.autograd.DeviceType.CUDA) / 1e6
        again, launches, w2 = run("admixture, resumed", md, True,
                                  max_iter=100, checkpoint_dir=ckpt_dir)
    print(f"bootstrap resume: {w1:.3f} s checkpointed (under "
          f"torch.profiler: the device busy {busy:.3f} s, "
          f"{100 * busy / w1:.1f} % of it), {w2:.3f} s resumed "
          f"({sum(launches.values())} launches); the checkpointed run's "
          f"statistics are (b)'s: "
          f"{first.bootstrap.ts_bs == out.bootstrap.ts_bs}", flush=True)
    assert again.bootstrap.ts_bs == first.bootstrap.ts_bs
    assert again.bootstrap.pvalue == first.bootstrap.pvalue
    assert not any(launches.values()), launches
    del md
    torch.cuda.empty_cache()

    # (d) the -w and -v 4 CLI runs
    for flags in (["-w", "n", "2"], ["-v", "4"]):
        build.reset_launch_counts()
        out_buf, err_buf = io.StringIO(), io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(out_buf), \
                contextlib.redirect_stderr(err_buf):
            rc = main(["-f", cli_path, "-a", "-k", "3", "-n", "2", "-d",
                       os.path.dirname(cli_path)] + flags)
        torch.cuda.synchronize()
        assert rc == 0, (flags, rc, err_buf.getvalue()[-2000:])
        trace = [ln for ln in err_buf.getvalue().splitlines()
                 if "(delta)" in ln]
        last = out_buf.getvalue().strip().splitlines()[-1]
        assert build.LAUNCHES["mc_fullstep_bi_cols"] > 0 and sum(
            build.LAUNCHES[k] for k in BI_ROWS) > 0, build.LAUNCHES
        assert bool(trace) == (flags[0] == "-v"), len(trace)
        print(f"cli 512 x 8192 {' '.join(flags)}: rc 0 in "
              f"{time.time() - t0:.2f} s, last line {last!r}"
              + (f", {len(trace)} trace lines, the last {trace[-1]!r}"
                 if trace else "") + f" on {where}", flush=True)


def phase_jagged(build, dev, where):
    """Jagged-M bucketing (model/bucketed.py) on the jagged mix of
    bench.py:199-201, made on the card: (a) the bucketed step against its
    plain version and the dense step; (b) plain EM and SQUAREM fits,
    bucketed and dense-forced; (c) a microsatellite-like panel at the
    8-bucket cap; (d) a -b 4 -k 3 -n 2 bootstrap and a mixture fit."""
    from multiclust_tpu_torch.api import fit_model_data
    from multiclust_tpu_torch.model import admixture as adm, bucketed as bk
    from multiclust_tpu_torch.model.common import EMConfig, Params
    from multiclust_tpu_torch.opt import em as em_mod
    from multiclust_tpu_torch.route_times import jagged_panel

    K, Kp, B = K_FULL, 32, 2
    eps32 = float(np.finfo(np.float32).eps)
    md = jagged_panel(300, I_FULL, L_FULL, dev)
    useful = I_FULL * int(md.n_alleles.sum())
    plan = bk.plan_for(md)
    bd = bk.bucketize_model_data(md, plan)
    print(f"jagged {I_FULL} x {L_FULL} (80 % M=2 + 20 % M=8), K={K}: plan "
          f"{plan.describe()}; {useful} useful cells a chain iteration on "
          f"{where}", flush=True)

    # (a) the step, kernels against plain and against the dense step
    gen = torch.Generator(device=dev).manual_seed(301)
    eta = torch.zeros((B, I_FULL, Kp), device=dev)
    eta[..., :K] = torch.rand((B, I_FULL, K), generator=gen,
                              device=dev) + 0.05
    eta /= eta.sum(dim=-1, keepdim=True)
    p = torch.zeros((B, Kp, L_FULL, md.M), device=dev)
    p[:, :K] = (torch.rand((B, K, L_FULL, md.M), generator=gen, device=dev)
                + 0.05) * md.mask
    p /= p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    cfg = EMConfig(admixture=True, has_missing=True, use_pallas="on",
                   k_true=K)
    params = bk.split_params_like(Params(eta, p), bd)
    build.reset_launch_counts()
    got, ll, _ = adm.em_step(params, bd, cfg)
    torch.cuda.synchronize()
    per_bucket = {n: build.LAUNCHES[n] for n in GENERIC_KERNELS}
    assert all(n == plan.n_buckets for n in per_bucket.values()), per_bucket
    ref, ll_ref, _ = adm.em_step(params, bd, cfg._replace(use_pallas="off"))
    dense, ll_dense, _ = adm.em_step(Params(eta, p), md, cfg)
    torch.cuda.synchronize()
    err = max([max_err(got.eta, ref.eta)]
              + [max_err(g, r) for g, r in zip(got.p, ref.p)])
    err_dense = max(max_err(got.eta, dense.eta),
                    max_err(bk.merge_params_like(got, bd).p, dense.p))
    torch.testing.assert_close(ll, ll_ref, rtol=1e-5, atol=0)
    torch.testing.assert_close(ll, ll_dense, rtol=1e-5, atol=0)
    ms_b = median_ms(lambda: adm.em_step(params, bd, cfg))
    ms_d = median_ms(lambda: adm.em_step(Params(eta, p), md, cfg))
    ms_p = median_ms(lambda: adm.em_step(
        params, bd, cfg._replace(use_pallas="off")), n=5, warm=1)
    print(f"jagged step B={B}: one launch of each generic kernel a bucket "
          f"({per_bucket}); max|d| against plain {err:.3e}, against the "
          f"dense step {err_dense:.3e} (rtol {RTOL}, atol {ATOL}); "
          f"bucketed {ms_b:.3f} ms ({useful * B / ms_b / 1e6:.2f} G useful "
          f"cells/s), dense {ms_d:.3f} ms ({ms_d / ms_b:.2f}x), plain "
          f"bucketed {ms_p:.3f} ms on {where}", flush=True)
    del eta, p, params, got, ref, dense
    torch.cuda.empty_cache()

    # (b) fits, bucketed and dense-forced
    base = dict(admixture=True, min_K=K, max_K=K, n_init=2, max_iter=100,
                seed=3, verbosity=0)

    def fit(label, dense_forced=False, panel=md, **kw):
        real = bk.worth_bucketing
        if dense_forced:
            bk.worth_bucketing = lambda *a, **k: False
        try:
            t0 = time.time()
            res = fit_model_data(panel, 2, **{**base, **kw}).estimate.last
            torch.cuda.synchronize()
            wall = time.time() - t0
        finally:
            bk.worth_bucketing = real
        assert np.isfinite(res.max_logL) and not res.any_failed, label
        assert bool(res.buckets) != dense_forced, (label, res.buckets)
        eta_b, p_b = res.best_params.eta, res.best_params.p
        assert (p_b[:, ~panel.mask] == 0).all(), label
        # the fit's own noise floor (opt/em.py): from the scale of its
        # logL terms at the best parameters
        _, scale = em_mod.model_log_likelihood(
            Params(eta_b[None], p_b[None]),
            bk.bucketize_model_data(panel, bk.plan_for(panel)),
            EMConfig(admixture=kw.get("admixture", True), has_missing=True))
        n = res.n_iter_all
        cells = I_FULL * int(panel.n_alleles.sum()) * n
        print(f"jagged fit {label}: {n} iterations over the chains, logL "
              f"{res.max_logL:.4f} (noise floor 8 eps32 x scale "
              f"{8 * eps32 * float(scale[0]):.3f}); wall {wall:.3f} s, init "
              f"+ EM {res.seconds:.3f} s, {cells / res.seconds / 1e9:.2f} G "
              f"useful cells/s of init + EM on {where}", flush=True)
        return res, 8 * eps32 * float(scale[0])

    build.reset_launch_counts()
    plain_b, floor = fit("plain EM, bucketed")
    sq_b, _ = fit("SQUAREM, bucketed", accel_scheme=1)
    launches = {n: build.LAUNCHES[n] for n in GENERIC_KERNELS}
    steps = (plain_b.n_iter_all + sq_b.n_iter_all) // 2 * plan.n_buckets
    assert all(n >= steps > 0 for n in launches.values()), (launches, steps)
    print(f"launches in the bucketed fits: {launches} "
          f"({plan.n_buckets} buckets)", flush=True)
    plain_d, _ = fit("plain EM, dense-forced", dense_forced=True)
    sq_d, _ = fit("SQUAREM, dense-forced", dense_forced=True,
                  accel_scheme=1)
    for label, b, d in (("plain EM", plain_b, plain_d),
                        ("SQUAREM", sq_b, sq_d)):
        print(f"jagged {label}: bucketed {b.n_iter_all} iterations against "
              f"dense {d.n_iter_all}; logL gap {b.max_logL - d.max_logL:.4f}"
              f" against the noise floor {floor:.3f}; init + EM "
              f"{b.seconds:.3f} s against {d.seconds:.3f} s "
              f"({d.seconds / b.seconds:.2f}x) on {where}", flush=True)

    # (c) a microsatellite-like panel at the same I x L, 2..20 alleles
    n_ms = np.random.default_rng(302).integers(2, 21, size=L_FULL)
    ms = jagged_panel(303, I_FULL, L_FULL, dev, n_alleles=n_ms)
    ms_plan = bk.plan_for(ms)
    assert ms_plan.n_buckets == 8, ms_plan
    build.reset_launch_counts()
    ms_res, _ = fit("microsatellites 2..20, plain EM, cap 10", panel=ms,
                    max_iter=10)
    ms_launch = {n: build.LAUNCHES[n] for n in GENERIC_KERNELS}
    assert all(n >= ms_res.n_iter_all // 2 * 8 for n in
               ms_launch.values()), ms_launch
    print(f"microsatellite plan {ms_plan.describe()}; launches "
          f"{ms_launch} on {where}", flush=True)
    del ms
    torch.cuda.empty_cache()

    # (d) the bootstrap and a mixture fit on the jagged panel
    build.reset_launch_counts()
    t0 = time.time()
    out = fit_model_data(md, 2, admixture=True, min_K=3, max_K=3, n_init=2,
                         n_bootstrap=4, max_iter=100, seed=11, verbosity=0)
    torch.cuda.synchronize()
    boot = out.bootstrap
    assert len(boot.ts_bs) == 4 and np.isfinite(boot.ts_bs).all()
    assert all(build.LAUNCHES[n] > 0 for n in GENERIC_KERNELS)
    print(f"jagged bootstrap -b 4 -k 3 -n 2: ts {boot.ts_bs}, p-value "
          f"{boot.pvalue}, {boot.chain_iterations} chain-iterations, "
          f"bootstrap {boot.seconds:.3f} s, run {time.time() - t0:.3f} s on "
          f"{where}", flush=True)
    build.reset_launch_counts()
    mix, _ = fit("mixture model, bucketed", admixture=False)
    assert build.LAUNCHES["mc_mix_finish"] > 0 and \
        build.LAUNCHES["mc_fullstep_p"] >= plan.n_buckets, build.LAUNCHES
    del md, bd
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 19: the mesh

def start_children(flag, task, n, init):
    """``n`` child processes of this script, each in a session of its own
    and started by a shell that forks it (the command after it keeps the
    shell from exec-ing): a child forked straight from this process would
    count this process's resident set in its ru_maxrss."""
    return [subprocess.Popen(
        ["sh", "-c", '"$@"; exit $?', "sh", sys.executable,
         os.path.abspath(__file__), flag, task, str(r), str(n), init],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True) for r in range(n)]


def wait_children(label, procs, t0, timeout):
    """Wait for a group of children; a rank that fails or outlives
    ``timeout`` (from ``t0``) fails the phase, with its output."""
    try:
        logs = [p.communicate(timeout=max(
            1.0, timeout - (time.time() - t0)))[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
        raise RuntimeError(f"{label}: a process outlived {timeout} s")
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"{label} rank {r} exited {p.returncode}:\n"
                               f"{log}")



def phase_nccl_world_one(where):
    """NCCL at world size 1: the helpers of runtime/mesh.py on card
    tensors, through a process group of one rank."""
    import torch.distributed as dist

    from multiclust_tpu_torch.runtime import mesh as mesh_mod

    with tempfile.TemporaryDirectory() as tmp:
        dev = mesh_mod.initialize_distributed(
            num_processes=1, process_id=0, device="cuda",
            init_method="file://" + os.path.join(tmp, "init"))
        try:
            assert dist.get_backend() == "nccl", dist.get_backend()
            mesh = mesh_mod.make_mesh((1, 1))
            gen = torch.Generator(device=dev).manual_seed(19)
            # a mesh's sums skip an axis of one shard, so the collectives
            # are called here on its groups themselves
            for dtype in (torch.float32, torch.float64):
                x = torch.rand((3, 1000, 32), generator=gen, device=dev,
                               dtype=dtype)
                for group in (mesh.data_group, mesh.model_group):
                    got = x.clone()
                    dist.all_reduce(got, group=group)
                    assert torch.equal(got, x), (dtype, group)
                # the row gather as Mesh.gather makes it: the block in a
                # zero-filled buffer, summed over the data group
                lo, hi = mesh.rows(1000)
                whole = x.new_zeros(x.shape)
                whole.narrow(1, lo, hi - lo).copy_(x[:, lo:hi])
                dist.all_reduce(whole, group=mesh.data_group)
                assert torch.equal(whole, x), dtype
            y = torch.arange(5, device=dev, dtype=torch.float64)
            assert torch.equal(mesh.broadcast(y.clone()), y)
            assert mesh_mod.sync_host_flag(True)
            assert mesh_mod.world_min(7) == 7
            flags = torch.tensor([True, False], device=dev)
            assert torch.equal(mesh_mod.any_over_world(flags), flags)
            torch.cuda.synchronize()
        finally:
            dist.destroy_process_group()
    print(f"mesh: NCCL at world size 1 on {dev}: all_reduce float32 and "
          f"float64 over the data and model groups, broadcast, the row "
          f"gather, sync_host_flag and world_min agree, on {where}",
          flush=True)


def mesh_panels(dev):
    """The main path's panels made on the card from seeds (the same on
    every rank): a biallelic 16384 x 2048 and an M = 4 one, 1 % missing,
    and 2-chain starts of each (K = 20, K-padded to 32 lanes)."""
    from multiclust_tpu_torch.model.common import Params, make_model_data

    panels = {}
    for name, n_alleles, seed in (("biallelic", 2, 191), ("generic", M_FULL,
                                                         192)):
        counts, miss, mask = generic_counts(
            seed, I_FULL, L_FULL, np.full(L_FULL, n_alleles), K_FULL, 0.01,
            dev)
        md = make_model_data(counts, miss, mask,
                             torch.full((L_FULL,), n_alleles, device=dev),
                             dtype=torch.float32, device=dev,
                             storage_dtype=torch.int8)
        gen = torch.Generator(device=dev).manual_seed(seed + 100)
        eta = torch.rand((2, I_FULL, K_FULL), generator=gen,
                         device=dev) + 0.05
        p = (torch.rand((2, K_FULL, L_FULL, mask.shape[1]), generator=gen,
                        device=dev) + 0.05) * mask
        panels[name] = (md, Params(eta=eta / eta.sum(-1, keepdim=True),
                                   p=p / p.sum(-1, keepdim=True)))
    return panels


def mesh_step(md, start, mesh, build, n_timed=3):
    """One meshed kernel step of ``start`` on this rank's block (launches
    counted from 0 before it), its wall over ``n_timed`` more, and the
    whole results of both lanes; ``mesh`` None: the unsharded step."""
    import torch.distributed as dist

    from multiclust_tpu_torch.config import Options
    from multiclust_tpu_torch.opt import em as em_mod
    from multiclust_tpu_torch.runtime import multistart as ms

    opt = Options(admixture=True, dtype="float32", use_pallas=True,
                  mesh_shape=None if mesh is None else mesh.shape)
    cfg = ms.cfg_from_options(opt, K_FULL, md)
    md_fit, _ = ms._fit_data(md, cfg, None)
    params = ms._to_fit_layout(
        ms._pad_k(ms._warm_block(start, md, cfg), cfg), md_fit, cfg)
    build.reset_launch_counts()
    new, ll, scale = em_mod.model_em_step(params, md_fit, cfg)
    torch.cuda.synchronize()
    launches = {k: v for k, v in build.kernel_launches().items() if v}
    if mesh is not None:
        dist.barrier()
    t0 = time.time()
    for _ in range(n_timed):
        em_mod.model_em_step(params, md_fit, cfg)
    torch.cuda.synchronize()
    wall = (time.time() - t0) / max(n_timed, 1)
    whole = [ms.lane_params(new, b, cfg, md_fit) for b in range(2)]
    return whole, ll, launches, wall


def mesh_fit(md, start, mesh):
    """A plain-EM fit of one chain from ``start``: its logL, iterations,
    whole best parameters and wall."""
    from multiclust_tpu_torch.config import Options
    from multiclust_tpu_torch.model.common import Params
    from multiclust_tpu_torch.runtime.multistart import maximize_likelihood

    opt = Options(admixture=True, min_K=K_FULL, max_K=K_FULL, n_init=1,
                  max_iter=MESH_FIT_ITERS, verbosity=0, dtype="float32",
                  use_pallas=True, mesh_shape=None if mesh is None else mesh.shape
                  ).synchronize(I_FULL, 2)
    warm = Params(eta=start.eta[0], p=start.p[0])
    t0 = time.time()
    res = maximize_likelihood(torch.Generator(device=md.device).manual_seed(
        1), md, K_FULL, opt, 0, warm=warm)
    torch.cuda.synchronize()
    return res.max_logL, res.n_iter_all, res.best_params, time.time() - t0


# the wrappers model/admixture.py calls on the meshed kernel routes: the
# mesh children record each call with its sharded-variant flags
MESH_SPIED = ("admixture_fullstep_biallelic_chunked", "admixture_sweep_stats",
              "fullstep_rows", "fullstep_cols", "rows_finish", "p0_epilogue",
              "fullstep_p")


def spy_variants(calls: set) -> None:
    """Make every call of a MESH_SPIED wrapper from model/admixture.py add
    ``name(flags)`` to ``calls``, the flags being the ``emit_*`` and
    ``finish`` arguments the call passed."""
    from multiclust_tpu_torch.model import admixture

    for name in MESH_SPIED:
        def wrapped(*a, _fn=getattr(admixture, name), _name=name, **kw):
            flags = ",".join(f"{k}={kw[k]}" for k in sorted(kw)
                             if k.startswith(("emit", "finish")))
            calls.add(f"{_name}({flags})")
            return _fn(*a, **kw)
        setattr(admixture, name, wrapped)


def mesh_child(task: str, rank: int, world: int, init: str) -> int:
    """A rank of the mesh phase: joins the gloo group on the one card and
    runs the meshed steps (and on 2x1 the fit) of its shape; writes its
    launches, the variants its steps called and its walls to
    ``task.rank<r>``, and rank 0 its whole results to ``task.rank0.pt``
    for the parent to hold to the unsharded ones."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch.distributed as dist

    from multiclust_tpu_torch.ops import build
    from multiclust_tpu_torch.runtime import mesh as mesh_mod

    with open(task) as fh:
        shape = tuple(json.load(fh)["shape"])
    dev = mesh_mod.initialize_distributed(
        num_processes=world, process_id=rank, backend="gloo", device="cuda",
        init_method=init)
    mesh = mesh_mod.cached_mesh(shape)
    calls = set()
    spy_variants(calls)
    panels = mesh_panels(dev)
    out = {"rank": rank, "steps": {}}
    whole_out = {}
    for name, (md, start) in panels.items():
        calls.clear()
        whole, ll, launches, wall = mesh_step(md, start, mesh, build)
        out["steps"][name] = {"launches": launches,
                              "variants": sorted(calls),
                              "wall_ms": 1e3 * wall}
        whole_out[name] = {"whole": [(w.eta.cpu(), w.p.cpu())
                                     for w in whole], "ll": ll.cpu()}
    if shape == (2, 1):
        md, start = panels["biallelic"]
        ll, n_iter, best, wall = mesh_fit(md, start, mesh)
        out["fit"] = {"logL": ll, "n_iter": n_iter, "wall_s": wall}
    if rank == 0:
        torch.save(whole_out, f"{task}.rank0.pt")
    with open(f"{task}.rank{rank}", "w") as fh:
        json.dump(out, fh)
    dist.destroy_process_group()
    return 0


def mesh_references(build, dev):
    """The unsharded kernel steps and fit of the mesh phase's panels, run
    here before any process group exists: each panel's whole lanes and
    logL, and the fit's logL, iterations, float32 noise floor (opt/em.py)
    and wall."""
    from multiclust_tpu_torch.model import admixture as adm
    from multiclust_tpu_torch.model.common import EMConfig, Params

    panels = mesh_panels(dev)
    steps = {}
    for name, (md, start) in panels.items():
        whole, ll, _, _ = mesh_step(md, start, None, build, n_timed=0)
        steps[name] = {"whole": [(w.eta.cpu(), w.p.cpu()) for w in whole],
                       "ll": ll.cpu()}
    md, start = panels["biallelic"]
    ll, n_iter, best, wall = mesh_fit(md, start, None)
    _, scale = adm.log_likelihood(Params(eta=best.eta[None],
                                         p=best.p[None]), md)
    floor = (EMConfig().noise_factor * float(np.finfo(np.float32).eps)
             * float(scale[0]))
    del panels, md, start, best
    torch.cuda.empty_cache()
    return steps, {"logL": ll, "n_iter": n_iter, "floor": floor,
                   "wall_s": wall}


def phase_mesh(build, dev, where, tmp):
    """2 and 4 ranks on the one card over gloo, a child process a rank,
    each shape held to the unsharded kernel step and fit; returns each
    shape's records, rank by rank."""
    ref_steps, ref_fit = mesh_references(build, dev)
    results = {}
    for shape in MESH_SHAPES:
        D, M = shape
        n = D * M
        task = os.path.join(tmp, f"mesh_{D}x{M}.json")
        with open(task, "w") as fh:
            json.dump({"shape": shape}, fh)
        t0 = time.time()
        wait_children(f"mesh {D}x{M}", start_children(
            "--mesh-child", task, n,
            "file://" + os.path.join(tmp, f"init_{D}x{M}")), t0, MESH_TIMEOUT)
        recs = []
        for r in range(n):
            with open(f"{task}.rank{r}") as fh:
                recs.append(json.load(fh))
        got = torch.load(f"{task}.rank0.pt")
        for name, ref in ref_steps.items():
            err = 0.0
            for g, w in zip(got[name]["whole"], ref["whole"]):
                err = max(err, max_err(g[0], w[0]), max_err(g[1], w[1]))
            torch.testing.assert_close(got[name]["ll"], ref["ll"],
                                       rtol=1e-5, atol=0)
            recs[0]["steps"][name]["max_abs_err"] = err
            print(f"mesh {D}x{M} {name} step: max|d| against the unsharded "
                  f"kernel step {err:.3e} (rtol {RTOL}, atol {ATOL}); "
                  f"launches a rank "
                  f"{[q['steps'][name]['launches'] for q in recs]}; "
                  f"variants {recs[0]['steps'][name]['variants']}; a meshed "
                  f"step {recs[0]['steps'][name]['wall_ms']:.2f} ms wall on "
                  f"rank 0", flush=True)
        if "fit" in recs[0]:
            f = recs[0]["fit"]
            gap = abs(f["logL"] - ref_fit["logL"])
            assert gap <= ref_fit["floor"], (f, ref_fit)
            print(f"mesh {D}x{M} plain-EM fit from the same start: logL "
                  f"{f['logL']:.4f} in {f['n_iter']} iterations "
                  f"({f['wall_s']:.2f} s), unsharded {ref_fit['logL']:.4f} "
                  f"in {ref_fit['n_iter']} ({ref_fit['wall_s']:.2f} s): gap "
                  f"{gap:.4f} against the float32 noise floor "
                  f"{ref_fit['floor']:.4f}", flush=True)
        print(f"mesh {D}x{M}: {time.time() - t0:.1f} s wall with the "
              f"children's start-up, on {where}", flush=True)
        results[f"{D}x{M}"] = recs
    print(f"mesh: the ranks of each shape shared one card ({where}) over "
          f"gloo, which stages CUDA tensors through the host: these times "
          f"are no multi-GPU speed", flush=True)
    return results


def check_mesh_launches(results):
    """Each rank's meshed steps launched the kernels of their route, with
    the sharded variants the shape calls for, the same on every rank."""
    for shape, recs in results.items():
        split = not shape.endswith("x1")
        for q in recs:
            bi = q["steps"]["biallelic"]
            gen = q["steps"]["generic"]
            assert bi["variants"] == recs[0]["steps"]["biallelic"][
                "variants"], (shape, bi)
            assert gen["variants"] == recs[0]["steps"]["generic"][
                "variants"], (shape, gen)
            launches = bi["launches"]
            need_bi = ["mc_fullstep_bi_rows_seg", "mc_fullstep_bi_finish",
                       "mc_fullstep_bi_cols", "mc_fullstep_bi_p0"]
            assert all(launches.get(k, 0) >= 1 for k in need_bi), (
                shape, launches)
            # the loci split adds the finish of the merged A + r
            assert launches["mc_fullstep_bi_finish"] == 1 + split, (
                shape, launches)
            assert (f"admixture_fullstep_biallelic_chunked(emit_a={split},"
                    f"emit_b=True)") in bi["variants"], (shape, bi)
            assert "p0_epilogue()" in bi["variants"], (shape, bi)
            assert ("rows_finish()" in bi["variants"]) == split, (shape, bi)
            launches = gen["launches"]
            need_gen = ["mc_fullstep_rows", "mc_fullstep_cols",
                        "mc_fullstep_p"]
            assert all(launches.get(k, 0) >= 1 for k in need_gen), (
                shape, launches)
            assert launches["mc_fullstep_p"] == 2, (shape, launches)
            assert launches.get("mc_fullstep_bi_finish", 0) == split, (
                shape, launches)
            assert ("admixture_sweep_stats()" in gen["variants"]) == split, (
                shape, gen)
            assert ("fullstep_cols(finish=False)" in gen["variants"]) == (
                not split), (shape, gen)


def mesh_record(results):
    """The kernels line's ``mesh`` entry: for each shape and each meshed
    step (biallelic, generic), the launches of each rank as the step's
    launch counts read them, the wrappers with the sharded-variant flags
    its calls passed (``spy_variants``) and rank 0's max |d| against the
    unsharded step."""
    return {shape: {name: {"launches_per_rank": [q["steps"][name]["launches"]
                                                 for q in recs],
                           "variants": recs[0]["steps"][name]["variants"],
                           "max_abs_err": recs[0]["steps"][name][
                               "max_abs_err"]}
                    for name in recs[0]["steps"]}
            for shape, recs in results.items()}


# ---------------------------------------------------------------------------
# phase 20: per-process ingest

def model_data_bytes(md) -> int:
    """Device bytes of a ModelData's tensors, each storage once (x is a
    view of the two planes on a biallelic panel)."""
    seen = {}
    for t in (md.x, md.miss, md.mask, md.n_alleles, md.c, md.x0, md.x1):
        if t is not None:
            st = t.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def ingest_child(task: str, rank: int, world: int, init: str) -> int:
    """A process of the ingest phase: the CLI on the phase's file, single-
    process (``single``), as a rank of a gloo group on the one card
    (``gloo``), or through ``cli.main_meshed`` at NCCL world size 1
    (``nccl``).  Records the rows it parsed, its ModelData's bytes, the
    peak allocation at the end of ingest (the ModelData on the card) and
    at the end of the run, its host max RSS, its wall, its launches and
    the wrappers with the sharded-variant flags its steps called; the
    single-process run also the float32 noise floor of its best fit's
    logL (opt/em.py)."""
    t0 = time.time()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import resource

    import torch.distributed as dist

    from multiclust_tpu_torch import cli
    from multiclust_tpu_torch.model import admixture as adm
    from multiclust_tpu_torch.model import common
    from multiclust_tpu_torch.ops import build
    from multiclust_tpu_torch.runtime import ingest
    from multiclust_tpu_torch.runtime import mesh as mesh_mod

    with open(task) as fh:
        spec = json.load(fh)
    mode, argv = spec["mode"], spec["argv"]
    rec = {"rank": rank, "mode": mode}

    def note_ingest(md, rows):
        torch.cuda.synchronize()
        rec.update(rows_parsed=rows, md_bytes=model_data_bytes(md),
                   md_shape=[md.I, md.L, md.M],
                   peak_ingest=torch.cuda.max_memory_allocated())

    if mode == "single":
        upload, write = common.model_data_from_dataset, cli._write_outputs

        def uploaded(ds, *a, **kw):
            md = upload(ds, *a, **kw)
            note_ingest(md, ds.I)
            return md

        def written(opt, ds, md, K, mres):
            write(opt, ds, md, K, mres)
            best = mres.best_params
            _, scale = adm.log_likelihood(
                common.Params(eta=best.eta[None], p=best.p[None]), md)
            rec["floor"] = (common.EMConfig().noise_factor
                            * float(np.finfo(np.float32).eps)
                            * float(scale[0]))
        common.model_data_from_dataset = uploaded
        cli._write_outputs = written
    else:
        load = ingest.load_structure_distributed

        def loaded(*a, **kw):
            md, info = load(*a, **kw)
            note_ingest(md, info.hi - info.lo)
            return md, info
        ingest.load_structure_distributed = loaded
        dev = mesh_mod.initialize_distributed(
            num_processes=world, process_id=rank,
            backend="nccl" if mode == "nccl" else "gloo", device="cuda",
            init_method=init)
        rec["backend"] = dist.get_backend()
    calls = set()
    spy_variants(calls)
    build.reset_launch_counts()
    if mode == "nccl":
        rc = cli.main_meshed(cli.parse_args(argv), dev)
    else:
        rc = cli.main(argv)
    torch.cuda.synchronize()
    rec.update(rc=rc, launches={k: v for k, v
                                in build.kernel_launches().items() if v},
               variants=sorted(calls),
               peak_fit=torch.cuda.max_memory_allocated(),
               rss_kib=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss,
               wall_s=time.time() - t0)
    with open(f"{task}.rank{rank}", "w") as fh:
        json.dump(rec, fh)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


PART = re.compile(r"^(.*)\.part(\d+)(\.txt)?$")
NUMBER = r"-?\d+\.\d+(?:e[-+]\d+)?|-?\d+"


def joined_outputs(out_dir):
    """A meshed run's files by their single-process names, each table's
    ``.part<d>`` row blocks joined in data-index order."""
    files, parts = {}, {}
    for name in os.listdir(out_dir):
        with open(os.path.join(out_dir, name)) as fh:
            text = fh.read()
        m = PART.match(name)
        if m is None:
            files[name] = text
        else:
            parts.setdefault(m.group(1) + (m.group(3) or ""), []).append(
                (int(m.group(2)), text))
    for name, texts in parts.items():
        files[name] = "".join(t for _, t in sorted(texts))
    return files


def compare_ingest_outputs(label, want, got, floor):
    """The joined files of a meshed run against the single-process ones:
    the text outside the numbers equal; logL within the float32 noise
    floor (AIC and BIC within twice it), count.K within 1e-4 of I an
    entry, every other number within 1e-4; returns the largest table
    difference."""
    assert sorted(got) == sorted(want), (label, sorted(got), sorted(want))
    worst = 0.0
    for name, a in want.items():
        b = got[name]
        assert re.sub(NUMBER, "#", a) == re.sub(NUMBER, "#", b), (label,
                                                                  name)
        va = np.array([float(v) for v in re.findall(NUMBER, a)])
        vb = np.array([float(v) for v in re.findall(NUMBER, b)])
        d = np.abs(va - vb)
        if name.endswith(".out.txt"):
            # logL, AIC, BIC, then count.K
            assert d[0] <= floor and (d[1:3] <= 2 * floor + 2e-6).all(), (
                label, name, va[:3], vb[:3], floor)
            assert (d[3:] <= 1e-4 * I_FULL).all(), (label, name, va, vb)
            assert va[3:].sum() == vb[3:].sum() == I_FULL, (label, name)
            continue
        assert (d <= 1e-4).all(), (label, name, float(d.max()))
        worst = max(worst, float(d.max()) if d.size else 0.0)
    return worst


def phase_ingest(where, tmp):
    """Per-process ingest: the CLI at ``-a -k 20 -n 2`` with an iteration
    cap on a 16384 x 2048 file, single-process, as 2x1 and 2x2 gloo ranks
    on the one card and at NCCL world size 1 on the ingest path, all at
    once; each run's joined files held to the single-process files, and
    each rank's rows, ModelData bytes and peak allocations held to its
    block.  Returns the records by run."""
    from multiclust_tpu_torch.runtime.mesh import block

    t0 = time.time()
    rng = np.random.default_rng(20)
    counts, miss = simulated_counts(rng, I_FULL, L_FULL, K_FULL, 0.01)
    path = os.path.join(tmp, "ingest.str")
    write_structure_biallelic(path, counts, miss)
    del counts, miss
    print(f"ingest: wrote {I_FULL} x {L_FULL} ({os.path.getsize(path)} "
          f"bytes, 1 % missing) in {time.time() - t0:.1f} s", flush=True)
    argv = ["-f", path, "-a", "-k", str(K_FULL), "-n", "2", "-T",
            str(INGEST_ITERS)]
    runs, procs = {}, {}
    for name, mode, shape in INGEST_RUNS:
        out = os.path.join(tmp, f"out_{name}")
        os.makedirs(out)
        n = shape[0] * shape[1] if shape else 1
        task = os.path.join(tmp, f"ingest_{name}.json")
        extra = ["--mesh", f"{shape[0]}x{shape[1]}"] if shape else []
        with open(task, "w") as fh:
            json.dump({"mode": mode, "argv": argv + ["-d", out] + extra}, fh)
        runs[name] = (task, n, out, shape)
        procs[name] = start_children(
            "--ingest-child", task, n,
            "file://" + os.path.join(tmp, f"init_ingest_{name}"))
    t1 = time.time()
    for name, group in procs.items():
        wait_children(f"ingest {name}", group, t1, INGEST_TIMEOUT)

    recs = {}
    for name, (task, n, out, shape) in runs.items():
        recs[name] = []
        for r in range(n):
            with open(f"{task}.rank{r}") as fh:
                recs[name].append(json.load(fh))
    single = recs["single"][0]
    want = joined_outputs(runs["single"][2])
    for name, (task, n, out, shape) in runs.items():
        D, M = shape or (1, 1)
        for q in recs[name]:
            d, m = divmod(q["rank"], M)
            r0, r1 = block(I_FULL, D, d)
            l0, l1 = block(L_FULL, M, m)
            assert q["rc"] == 0, (name, q)
            assert q["rows_parsed"] == r1 - r0, (name, q)
            assert q["md_shape"] == [r1 - r0, l1 - l0, 2], (name, q)
            # the int8 planes and miss, c, mask and n_alleles of the block
            rows, cols = r1 - r0, l1 - l0
            assert q["md_bytes"] == 3 * rows * cols + 4 * rows + 6 * cols, (
                name, q)
            if name != "single":
                assert q["backend"] == ("nccl" if name == "nccl"
                                        else "gloo"), q
            q["md_share"] = q["md_bytes"] / single["md_bytes"]
            q["ingest_share"] = q["peak_ingest"] / single["peak_ingest"]
            print(f"ingest {name} rank {q['rank']}: {q['rows_parsed']} rows "
                  f"parsed, ModelData {q['md_bytes']} bytes "
                  f"({q['md_share']:.3f} of single), peak allocated "
                  f"{q['peak_ingest']} bytes at the end of ingest "
                  f"({q['ingest_share']:.3f} of single), "
                  f"{q['peak_fit']} at the end of the run, host max RSS "
                  f"{q['rss_kib']} KiB, wall {q['wall_s']:.1f} s on {where}",
                  flush=True)
        if name == "2x1":
            assert all(q["ingest_share"] <= 0.6 for q in recs[name]), \
                recs[name]
        if name != "single":
            err = compare_ingest_outputs(name, want, joined_outputs(out),
                                         single["floor"])
            recs[name][0]["max_abs_err"] = err
            print(f"ingest {name}: joined files against the single-process "
                  f"files: max|d| {err:.3e} in the tables, logL within the "
                  f"float32 noise floor {single['floor']:.4f}", flush=True)
        if shape:
            split = M > 1
            for q in recs[name]:
                assert q["variants"] == recs[name][0]["variants"], (name, q)
                assert (f"admixture_fullstep_biallelic_chunked(emit_a="
                        f"{split},emit_b=True)") in q["variants"], (name, q)
                assert q["launches"].get("mc_fullstep_bi_p0", 0) > 0, q
    print(f"ingest: the four runs at once on the one card ({where}): "
          f"their walls share it and the host's cores; {time.time() - t0:.1f}"
          f" s in all", flush=True)
    return recs


def ingest_record(recs):
    """The ingest runs' part of the kernels line's ``mesh`` entry: each
    meshed run's launches rank by rank, the wrappers with the
    sharded-variant flags its steps called, and its largest table
    difference against the single-process files."""
    return {f"ingest {name}": {"cli": {
        "launches_per_rank": [q["launches"] for q in qs],
        "variants": qs[0]["variants"],
        "max_abs_err": qs[0]["max_abs_err"]}}
        for name, qs in recs.items() if name != "single"}


# ---------------------------------------------------------------------------
# phase 21: K above 128 (the wide kernels of csrc/wide.cuh)

WIDE_SOURCE = "multiclust_tpu_torch/csrc/wide.cuh"
# the TPU kernels each wide kernel replaces above 128 lanes: the streamed
# step's two pass bodies (the main path's route) and the generic step
WIDE_TPU = {"wide_rows": "multiclust_tpu/ops/kernels.py:887",
            "wide_finish": FINISH_TPU,
            "wide_cols_bi": P0_TPU,
            "wide_cols_generic": GENERIC_TPU}
WIDE_KERNELS = tuple(WIDE_TPU)
# K = 200 (224 lanes) and the top of the TPU kernels' range, 1024 lanes
WIDE_K = (200, 1024)
WIDE_FIT_ITERS = {200: 30, 1024: 10}
WIDE_CLI_K, WIDE_CLI_ITERS = 200, 30
WIDE_MESH_TIMEOUT = 240


def wide_step_checks(fb, args, route, K, W):
    """Each wide kernel of the streamed step on the window [0, W) of
    ``args`` against its plain version, reruns bit-equal, the finish's raw
    sums and t bit-equal to the ordered ones; the rows pass alone (its d
    and A launches) and inside the step's window, where both passes run on
    one d (``window_partials``): its partials and the columns pass's
    bit-equal to those of each pass alone; returns the errors and the
    partials (for the timings)."""
    e, p, a, z, c, m = args
    fin = dict(k_true=K, lb=1e-8, project_eta=True)
    win = dict(l_lo=0, l_hi=W)
    apart, tpart = fb.rows_partials(e, p, a, z, seg_cols=route.seg_cols,
                                    k_true=K, **win)
    ref_a, ref_t = fb.rows_partials_reference(e, p, a, z, **win)
    again = fb.rows_partials(e, p, a, z, seg_cols=route.seg_cols, k_true=K,
                             **win)
    torch.cuda.synchronize()
    assert torch.equal(apart, again[0]) and torch.equal(tpart, again[1])
    errs = {"rows": max(max_err(apart.sum(dim=1), ref_a[:, 0]),
                        max_err_cast(tpart.double().sum(dim=1),
                                     ref_t[:, 0]))}
    del ref_a, again
    got = fb.rows_finish(e, apart, tpart, c, **fin)
    ref = fb.rows_finish_reference(e, apart, tpart, c, **fin)
    errs["finish"] = max(max_err_cast(g, r) for g, r in zip(got, ref))
    assert (got[0][..., K:] == 0).all()
    again = fb.rows_finish(e, apart, tpart, c, **fin)
    assert all(torch.equal(u, v) for u, v in zip(got, again))
    raw, t_raw = fb.rows_finish(e, apart, tpart, c, emit_a=True, **fin)
    assert torch.equal(raw, fb.ordered_segment_sum(apart))
    t_want = fb.ordered_segment_sum(tpart, dtype=torch.float64)
    assert torch.equal(t_raw, t_want)
    none, t_only = fb.rows_finish(e, None, tpart, c, **fin)
    assert none is None and torch.equal(t_only, t_want)
    del got, ref, again, raw
    cw = dict(plb=1e-8, project=True, **win)
    outs = (torch.zeros_like(p),)
    fb.cols_window(e, p, a, z, m, outs, k_true=K, n_rseg=route.n_rseg, **cw)
    want = (torch.zeros_like(p),)
    fb.cols_window_reference(e, p, a, z, m, want, **cw)
    again = (torch.zeros_like(p),)
    fb.cols_window(e, p, a, z, m, again, k_true=K, n_rseg=route.n_rseg,
                   **cw)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], again[0]) and (outs[0][:, K:] == 0).all()
    errs["cols_bi"] = max_err(outs[0][..., :W], want[0][..., :W])
    del want, again
    # the columns pass's partials alone: the raw B0/B1 of its epilogue
    # (emit_b) are their ordered sums, lanes past kc zero
    part = fb.cols_partials(e, p, a, z, m, k_true=K, n_rseg=route.n_rseg,
                            **win)
    raw = (torch.zeros_like(p), torch.zeros_like(p))
    fb.cols_window(e, p, a, z, m, raw, k_true=K, n_rseg=route.n_rseg, **cw)
    torch.cuda.synchronize()
    kc = fb.kc_of(K, p.shape[1])
    for s in (0, 1):
        ordered = fb.ordered_segment_sum(part[:, :, s])
        ordered[:, kc:] = 0.0
        assert torch.equal(raw[s][..., :W], ordered), s
    # both passes on one d: the partials of each pass alone, bit for bit
    shared = fb.window_partials(e, p, a, z, m, seg_cols=route.seg_cols,
                                k_true=K, n_rseg=route.n_rseg, **win)
    torch.cuda.synchronize()
    assert torch.equal(shared[0], apart) and torch.equal(shared[1], tpart)
    assert torch.equal(shared[2], part)
    del part, raw, ordered, shared
    return errs, apart, tpart


def phase_wide_kernels(fb, fs, build, dev, where):
    """The wide kernels against their plain versions on the card: (a) at
    16384 x 2048, 1 % missing, chain batches 1 and 2, K = 200 and 1024,
    the router's route and segments: each kernel alone and the routed
    step, reruns bit-equal, the finish's sums and t bit-equal to the
    ordered ones, the t-only pass; each kernel's time at 2 chains
    (CUDA events; the columns pass with its p0 epilogue) beside its plain
    version's (CUDA events) and its bound; (b) every variant (miss,
    compute_t, emit_b, emit_a / a0, kmask, project_eta off, project off, a
    window) on a ragged 1001 x 4099 panel, streamed and chunked; (c) the
    generic kernels at M = 4 on 16384 x 2048 and on a ragged 1001 x 333 x
    M = 3 panel: the step, the sweep statistics (finish=False, the miss
    fold) and an a0 / emit_a chain.  Beside the rows and columns passes
    (W1, W3, W4) the float32 matmuls of their contractions, a yardstick
    the port never calls; the routed step with both passes on one d and
    in the order that runs d for each.  Returns errors, times, bounds and
    yardsticks by (kernel, K), and the step times by K."""
    from multiclust_tpu_torch.model.common import k_padded_size
    from multiclust_tpu_torch.route_times import finish_bytes

    rng = np.random.default_rng(21)
    n_sm = fb.device_sm_count(dev)
    errs = dict.fromkeys(WIDE_KERNELS, 0.0)
    ms, bnd, yard, steps = {}, {}, {}, {}
    kw = dict(lb=1e-8, plb=1e-8, project=True)
    for K in WIDE_K:
        Kp = k_padded_size(K, 32)
        kc = fb.kc_of(K, Kp)
        for B in (1, 2):
            args = step_inputs(rng, B, I_FULL, L_FULL, K, Kp, 0.01, dev)
            e, p, a, z, c, m = args
            route = fb.pick_route(B, I_FULL, L_FULL, Kp, n_sm,
                                  fb.scratch_budget(dev), K)
            assert route.name in ("streamed", "chunked"), route
            W = route.window
            e_k, apart, tpart = wide_step_checks(fb, args, route, K, W)
            for name, key in (("wide_rows", "rows"),
                              ("wide_finish", "finish"),
                              ("wide_cols_bi", "cols_bi")):
                errs[name] = max(errs[name], e_k[key])
            step = fb.admixture_fullstep_biallelic_routed(
                *args, route=route, k_true=K, **kw)
            ref = fb.admixture_fullstep_biallelic_streamed_reference(
                *args, k_true=K, **kw)
            e_step = max(max_err_cast(g, r) for g, r in zip(step, ref))
            assert (step[0][..., K:] == 0).all() and (step[2][:, K:] == 0).all()
            t_terms = fb.rows_log_likelihood_terms(e, p, a, z, k_true=K)
            e_terms = max_err_cast(t_terms, ref[1])
            del step, ref
            print(f"wide K={K} ({Kp} lanes) {I_FULL} x {L_FULL} B={B}, "
                  f"{route.describe()}: max|d| raw A + r, t {e_k['rows']:.3e}"
                  f", eta', t {e_k['finish']:.3e}, p0' {e_k['cols_bi']:.3e}, "
                  f"routed step {e_step:.3e}, logL terms alone "
                  f"{e_terms:.3e} (rtol {RTOL}, atol {ATOL}); reruns "
                  f"bit-equal, the finish's raw sums and t bit-equal to the "
                  f"ordered ones", flush=True)
            if B == 2:
                fin = dict(k_true=K, lb=1e-8, project_eta=True)
                win = dict(l_lo=0, l_hi=W)
                cw = dict(plb=1e-8, project=True, **win)
                outs = (torch.empty_like(p),)
                n_cseg, n_rseg = apart.shape[1], route.n_rseg
                calls = {
                    "wide_rows": (
                        lambda: fb.rows_partials(
                            e, p, a, z, seg_cols=route.seg_cols, k_true=K,
                            **win),
                        lambda: fb.rows_partials_reference(e, p, a, z,
                                                           **win)),
                    "wide_finish": (
                        lambda: fb.rows_finish(e, apart, tpart, c, **fin),
                        lambda: fb.rows_finish_reference(e, apart, tpart, c,
                                                         **fin)),
                    "wide_cols_bi": (
                        lambda: fb.cols_window(e, p, a, z, m, outs, k_true=K,
                                               n_rseg=n_rseg, **cw),
                        lambda: fb.cols_window_reference(e, p, a, z, m, outs,
                                                         **cw))}
                cells = B * I_FULL * W
                live = finish_bytes(B, I_FULL, Kp, n_cseg, kc)
                bounds = {
                    "wide_rows": bound(
                        tensors_bytes((e, p, a, z)) + 4 * B * n_cseg
                        * I_FULL * (Kp + 1), (4 * K + 10) * cells),
                    "wide_finish": (live[1] / HBM_BYTES_PER_S * 1e3,
                                    "bytes",
                                    live[0] / HBM_BYTES_PER_S * 1e3),
                    "wide_cols_bi": bound(
                        tensors_bytes((e, p, a, z, m))
                        + 4 * B * n_rseg * 2 * Kp * W, (6 * K + 6) * cells)}
                for name, (kernel, plain) in calls.items():
                    k_ms = median_ms(kernel)
                    ms[name, K] = (k_ms, median_ms(plain, n=3, warm=1))
                    bnd[name, K] = bounds[name]
                    print(f"wide K={K} {name} at 2 chains: kernel "
                          f"{k_ms:.4f} ms, plain "
                          f"{ms[name, K][1]:.3f} ms, bound "
                          f"{bounds[name][0]:.4f} ms ({bounds[name][1]}), "
                          f"{100 * bounds[name][0] / k_ms:.1f} % of it, on "
                          f"{where}", flush=True)
                # the routed step with both passes on one d, and in the
                # order that runs d for each (d + A, then d + B): the rows
                # and columns passes' wrappers in turn
                from multiclust_tpu_torch.route_times import \
                    bi_step_unshared
                steps[K] = {
                    "shared d": median_ms(
                        lambda: fb.admixture_fullstep_biallelic_routed(
                            *args, route=route, k_true=K, **kw)),
                    "unshared d": median_ms(
                        lambda: bi_step_unshared(
                            *args, window=route.window,
                            seg_cols=route.seg_cols, n_rseg=route.n_rseg,
                            k_true=K, **kw))}
                print(f"wide K={K} routed step at 2 chains: "
                      + ", ".join(f"{k} {v:.4f} ms" for k, v in
                                  steps[K].items()) + f", on {where}",
                      flush=True)
                del calls, outs
                # the yardstick the port never calls: each pass's
                # contractions alone, float32 torch.matmul (TF32 off) on
                # K-wide operands: d = eta p0 and A = w p0^T (the rows
                # pass; p1 = 1 - p0 folds into one product), d and B =
                # eta^T w over the x0 and x1 planes (the columns pass)
                e_k, p_k = e[..., :K].contiguous(), p[:, :K, :W].contiguous()
                w = torch.rand((B, I_FULL, 2 * W), device=dev)
                w1 = w[..., :W].contiguous()
                yard["wide_rows", K] = median_ms(
                    lambda: (e_k @ p_k, w1 @ p_k.transpose(1, 2)))
                yard["wide_cols_bi", K] = median_ms(
                    lambda: (e_k @ p_k, e_k.transpose(1, 2) @ w))
                print(f"wide K={K} yardstick, not a route of the port: the "
                      f"float32 matmuls of the rows pass's contractions "
                      f"(d, A) {yard['wide_rows', K]:.4f} ms, of the "
                      f"columns pass's (d, B0 and B1) "
                      f"{yard['wide_cols_bi', K]:.4f} ms; the kernels "
                      f"{ms['wide_rows', K][0]:.4f} and "
                      f"{ms['wide_cols_bi', K][0]:.4f} ms on {where}",
                      flush=True)
                del e_k, p_k, w, w1
            del args, e, p, a, z, c, m, apart, tpart
            torch.cuda.empty_cache()

        # (b) every variant on a ragged panel, streamed and chunked
        args = step_inputs(rng, 2, 1001, 4099, K, Kp, 0.03, dev)
        variants = {"base": {}, "compute_t off": dict(compute_t=False),
                    "emit_b": dict(emit_b=True),
                    "emit_a + emit_b": dict(emit_a=True, emit_b=True),
                    "kmask": dict(k_true=Kp, kmask=(
                        torch.arange(Kp, device=dev) < K).float()),
                    "project_eta off": dict(project_eta=False),
                    "a0": dict(emit_a=True, emit_b=True, a0=torch.rand(
                        (2, 1001, Kp), device=dev)),
                    "project off": dict(project=False)}
        e_var = 0.0
        for label, extra in variants.items():
            vkw = {**kw, "k_true": K, **extra}
            ref = fb.admixture_fullstep_biallelic_chunked_reference(
                *args, window=4099, **vkw)
            for call in (dict(seg_cols=1056), dict(window=1312)):
                fn = (fb.admixture_fullstep_biallelic_streamed
                      if "seg_cols" in call
                      else fb.admixture_fullstep_biallelic_chunked)
                got = fn(*args, **call, **vkw)
                again = fn(*args, **call, **vkw)
                assert all(torch.equal(u, v) for u, v in zip(got, again))
                e_var = max(e_var, max(max_err_cast(g, r)
                                       for g, r in zip(got, ref)))
        errs["wide_rows"] = max(errs["wide_rows"], e_var)
        print(f"wide K={K} variants on 1001 x 4099, streamed (1056-column "
              f"segments) and chunked (1312-column windows): "
              f"{', '.join(variants)}: max|d| {e_var:.3e}, reruns "
              f"bit-equal", flush=True)
        del args, variants

        # (c) the generic kernels
        full_m = np.full(L_FULL, M_FULL)
        for label, (B, I, L, n_all) in (
                ("M=4", (2, I_FULL, L_FULL, full_m)),
                ("ragged M=3", (1, 1001, 333, np.full(333, 3)))):
            args = generic_inputs(210 + K, B, I, L, n_all, K, Kp, 0.01, dev)
            eta, p2, x2, c, miss, mask = args
            M = mask.shape[1]
            gkw = dict(k_true=K, **kw)
            got = fs.admixture_fullstep(*args, **gkw)
            ref = fs.admixture_fullstep_reference(*args, **gkw)
            e_step = max(max_err(g, r) for g, r in zip(got, ref))
            again = fs.admixture_fullstep(*args, **gkw)
            assert all(torch.equal(u, v) for u, v in zip(got, again))
            assert (got[0][..., K:] == 0).all() and (got[2][:, K:] == 0).all()
            del got, ref, again
            part = fs.fullstep_partials(eta, p2, x2, miss, M=M, k_true=K)
            part_ref = fs.fullstep_partials_reference(eta, p2, x2, miss)
            e_cols = max_err(part.sum(dim=1), part_ref[:, 0])
            assert (part[:, :, kc:] == 0).all()
            sweep = fs.admixture_sweep_stats(eta, p2, x2, miss, M=M, k_true=K)
            A_ref, t_ref = fs.fullstep_rows_reference(
                eta, p2, x2, k_true=K, lb=0.0, project=False, finish=False)
            e_sweep = max(max_err(sweep[0], A_ref), max_err(sweep[1], t_ref),
                          max_err(sweep[2], part_ref[:, 0]))
            del sweep, A_ref, t_ref
            h = (L // 2) * M
            rkw = dict(k_true=K, lb=1e-8, project=True)
            halves = [(p2[..., :h].contiguous(), x2[:, :h].contiguous()),
                      (p2[..., h:].contiguous(), x2[:, h:].contiguous())]
            A, _ = fs.fullstep_rows(eta, *halves[0], c, finish=False, **rkw)
            A_ref, _ = fs.fullstep_rows_reference(eta, *halves[0], c,
                                                  finish=False, **rkw)
            e2 = fs.fullstep_rows(eta, *halves[1], c, A, **rkw)
            e2_ref = fs.fullstep_rows_reference(eta, *halves[1], c, A_ref,
                                                **rkw)
            e_chain = max([max_err(A, A_ref)]
                          + [max_err(g, r) for g, r in zip(e2, e2_ref)])
            del halves, A, A_ref, e2, e2_ref
            errs["wide_cols_generic"] = max(errs["wide_cols_generic"],
                                            e_cols, e_sweep)
            errs["wide_rows"] = max(errs["wide_rows"], e_step, e_chain)
            errs["wide_finish"] = max(errs["wide_finish"], e_step, e_chain)
            print(f"wide K={K} generic {label} {I} x {L} B={B}: max|d| step "
                  f"{e_step:.3e}, columns partials {e_cols:.3e}, sweep "
                  f"statistics {e_sweep:.3e}, a0 / emit_a chain "
                  f"{e_chain:.3e}; reruns bit-equal", flush=True)
            if label == "M=4":
                cols = lambda: fs.fullstep_partials(eta, p2, x2, miss, M=M,
                                                    k_true=K)
                k_ms = median_ms(cols)
                p_ms = median_ms(lambda: fs.fullstep_partials_reference(
                    eta, p2, x2, miss), n=3, warm=1)
                lanes = B * I * L * M
                ms["wide_cols_generic", K] = (k_ms, p_ms)
                bnd["wide_cols_generic", K] = bound(
                    tensors_bytes((eta, p2, x2, miss, part)),
                    (4 * K + 3) * lanes)
                b = bnd["wide_cols_generic", K]
                # the yardstick: d = eta p and B = eta^T w over L x M lanes
                e_k, p_k = eta[..., :K].contiguous(), p2[:, :K].contiguous()
                w = torch.rand((B, I, L * M), device=dev)
                yard["wide_cols_generic", K] = median_ms(
                    lambda: (e_k @ p_k, e_k.transpose(1, 2) @ w))
                del e_k, p_k, w
                print(f"wide K={K} wide_cols_generic at 2 chains, M=4: "
                      f"kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms, bound "
                      f"{b[0]:.4f} ms ({b[1]}), {100 * b[0] / k_ms:.1f} % of "
                      f"it; yardstick, not a route of the port: the float32 "
                      f"matmuls of its contractions (d, B) "
                      f"{yard['wide_cols_generic', K]:.4f} ms, on {where}",
                      flush=True)
            del args, eta, p2, x2, c, miss, mask, part, part_ref
            torch.cuda.empty_cache()
    return errs, ms, bnd, yard, steps


def wide_fit_counts(K, I, L, n_alleles, seed, dev):
    """Counts of an admixture-model panel of K clusters made on the card,
    1 % missing, and its ModelData (int8 storage)."""
    from multiclust_tpu_torch.model.common import make_model_data

    counts, miss, mask = generic_counts(seed, I, L, n_alleles, K, 0.01, dev)
    return make_model_data(counts, miss, mask,
                           torch.as_tensor(n_alleles, device=dev),
                           dtype=torch.float32, device=dev,
                           storage_dtype=torch.int8)


def phase_wide_fits(build, dev, where):
    """The main path above 128 lanes: ``api.fit_model_data`` on a 16384 x
    2048 biallelic panel made on the card (1 % missing, 2 chains): K = 200
    plain EM and SQUAREM, cap 30, and K = 1024 plain EM, cap 10; then K =
    200 on the M = 4 configuration and on the jagged mix (plain EM, cap
    10).  The launches of each run counted from 0; returns the wide
    kernels' launches in the K = 200 biallelic fits (the main path) and
    the generic columns pass's in the M = 4 fit, and those of the K = 1024
    fit."""
    from multiclust_tpu_torch.api import fit_model_data

    launches, launches_1024 = {}, {}
    for K in WIDE_K:
        md = wide_fit_counts(K, I_FULL, L_FULL, np.full(L_FULL, 2), 220 + K,
                             dev)
        runs = [("plain EM", {})]
        if K == 200:
            runs.append(("SQUAREM", dict(accel_scheme=1)))
        build.reset_launch_counts()
        for label, extra in runs:
            t0 = time.time()
            out = fit_model_data(md, 2, admixture=True, min_K=K, max_K=K,
                                 n_init=2, max_iter=WIDE_FIT_ITERS[K],
                                 seed=3, verbosity=0, **extra)
            torch.cuda.synchronize()
            res = check_fit(out, time.time() - t0, f"wide K={K} {label}",
                            where, md=md, K=K)
            assert res.route.startswith(("streamed", "chunked")), res.route
        wide = {name: build.LAUNCHES[name] for name in WIDE_KERNELS}
        ran = {k: v for k, v in build.kernel_launches().items() if v}
        print(f"wide K={K} fits ({', '.join(r[0] for r in runs)}), route "
              f"{res.route}: launches of the wide kernels {wide}; all {ran}",
              flush=True)
        for name in ("wide_rows", "wide_finish", "wide_cols_bi"):
            assert wide[name] > 0, (K, wide)
        assert not build.LAUNCHES["mc_fullstep_bi_rows"], build.LAUNCHES
        (launches if K == 200 else launches_1024).update(wide)
        del md, out
        torch.cuda.empty_cache()
    K = 200
    jag = np.where(np.random.default_rng(10).random(L_FULL) < 0.8, 2, 8)
    for label, n_all in (("M=4", np.full(L_FULL, M_FULL)),
                         ("jagged 80 % M=2 + 20 % M=8", jag)):
        md = wide_fit_counts(K, I_FULL, L_FULL, n_all, 230, dev)
        build.reset_launch_counts()
        t0 = time.time()
        out = fit_model_data(md, 2, admixture=True, min_K=K, max_K=K,
                             n_init=2, max_iter=10, seed=3, verbosity=0)
        torch.cuda.synchronize()
        check_fit(out, time.time() - t0, f"wide K={K} generic {label}",
                  where, md=md, K=K)
        wide = {name: build.LAUNCHES[name] for name in WIDE_KERNELS}
        print(f"wide K={K} generic {label}: launches of the wide kernels "
              f"{wide}", flush=True)
        for name in ("wide_rows", "wide_finish", "wide_cols_generic"):
            assert wide[name] > 0, (label, wide)
        if label == "M=4":
            launches["wide_cols_generic"] = wide["wide_cols_generic"]
        del md, out
        torch.cuda.empty_cache()
    return launches, launches_1024


def phase_wide_reference(build, dev):
    """A 30-iteration warm-start fit at K = 200 through the wide kernels
    (600 x 500, the streamed route), held to the plain float64 fit on the
    CPU over the same iterations: within the float32 noise floor of
    opt/em.py."""
    from multiclust_tpu_torch.convert import model_data_from_numpy, \
        params_from_numpy
    from multiclust_tpu_torch.model import admixture as adm
    from multiclust_tpu_torch.model.common import EMConfig, Params
    from multiclust_tpu_torch.opt.driver import fit
    from multiclust_tpu_torch.runtime.multistart import _pad_k, _to_bi_repr

    rng = np.random.default_rng(24)
    I, L, K = 600, 500, 200
    counts, miss = simulated_counts(rng, I, L, K, 0.01)
    mask, n_all = np.ones((L, 2), bool), np.full(L, 2)
    eta = rng.dirichlet(np.full(K, 2.0), size=I)
    p0 = rng.uniform(0.2, 0.8, size=(K, L))
    p = np.stack([p0, 1 - p0], axis=2)
    base = dict(admixture=True, has_missing=True, biallelic=True, k_true=K,
                max_iter=30, abs_error=1e-12, eta_lower_bound=1e-8,
                p_lower_bound=1e-8)
    md64 = model_data_from_numpy(counts, miss, mask, n_all)
    cpu = fit(params_from_numpy(eta, p), md64, EMConfig(**base))
    cfg = EMConfig(use_pallas="on", **base)
    warm = params_from_numpy(eta, p, device=dev, dtype=torch.float32)
    build.reset_launch_counts()
    gpu = fit(_to_bi_repr(_pad_k(warm, cfg), cfg),
              model_data_from_numpy(counts, miss, mask, n_all, device=dev,
                                    dtype=torch.float32), cfg)
    wide = {name: build.LAUNCHES[name] for name in WIDE_KERNELS}
    best = cpu.params
    _, scale = adm.log_likelihood(Params(eta=best.eta[None],
                                         p=best.p[None]), md64)
    floor = (EMConfig().noise_factor * float(np.finfo(np.float32).eps)
             * float(scale[0]))
    gap = abs(gpu.logL - cpu.logL)
    print(f"wide reference fit K={K}: kernel path logL {gpu.logL:.4f} vs "
          f"float64 CPU {cpu.logL:.4f} after {gpu.n_iter} iterations: gap "
          f"{gap:.4f} against the float32 noise floor {floor:.4f}; launches "
          f"{wide}", flush=True)
    assert gpu.n_iter == cpu.n_iter == 31
    assert gap <= floor, (gap, floor)
    assert all(wide[n] >= 31 for n in ("wide_rows", "wide_finish",
                                       "wide_cols_bi")), wide


def phase_wide_cli(build, where, tmp):
    """The CLI at ``-a -k 200 -n 2 -T 30`` on a 16384 x 2048 STRUCTURE
    file (1 % missing): through the wide kernels, every output file
    written."""
    from multiclust_tpu_torch.cli import main

    K = WIDE_CLI_K
    rng = np.random.default_rng(25)
    counts, miss = simulated_counts(rng, I_FULL, L_FULL, K, 0.01)
    path = os.path.join(tmp, "wide.str")
    write_structure_biallelic(path, counts, miss)
    del counts, miss
    build.reset_launch_counts()
    t0 = time.time()
    rc = main(["-f", path, "-a", "-k", str(K), "-n", "2", "-T",
               str(WIDE_CLI_ITERS), "-s", "1", "-d", tmp])
    torch.cuda.synchronize()
    wall = time.time() - t0
    assert rc == 0, rc
    outs = [f for f in os.listdir(tmp) if f"K={K}" in f or f"_{K}." in f]
    assert len(outs) >= 5 and all(
        os.path.getsize(os.path.join(tmp, f)) > 0 for f in outs), outs
    wide = {name: build.LAUNCHES[name] for name in WIDE_KERNELS}
    for name in ("wide_rows", "wide_finish", "wide_cols_bi"):
        assert wide[name] > 0, wide
    print(f"wide cli -a -k {K} -n 2 -T {WIDE_CLI_ITERS} on {I_FULL} x "
          f"{L_FULL}: rc 0 in {wall:.1f} s, files {sorted(outs)}, launches "
          f"{wide} on {where}", flush=True)


def wide_mesh_step(md, start, mesh, build, K):
    """One wide kernel step of ``start`` (the meshed one on this rank's
    block when ``mesh`` is given): whole lanes, logL and launches."""
    from multiclust_tpu_torch.config import Options
    from multiclust_tpu_torch.opt import em as em_mod
    from multiclust_tpu_torch.runtime import multistart as ms

    opt = Options(admixture=True, dtype="float32", use_pallas=True,
                  mesh_shape=None if mesh is None else mesh.shape)
    cfg = ms.cfg_from_options(opt, K, md)
    md_fit, _ = ms._fit_data(md, cfg, None)
    params = ms._to_fit_layout(
        ms._pad_k(ms._warm_block(start, md, cfg), cfg), md_fit, cfg)
    build.reset_launch_counts()
    new, ll, _ = em_mod.model_em_step(params, md_fit, cfg)
    torch.cuda.synchronize()
    launches = {k: v for k, v in build.kernel_launches().items() if v}
    return [ms.lane_params(new, b, cfg, md_fit) for b in range(2)], ll, \
        launches


def wide_mesh_panel(dev, K):
    """The main path's biallelic 16384 x 2048 panel (1 % missing) made on
    the card from a seed, and a 2-chain start of K clusters."""
    from multiclust_tpu_torch.model.common import Params

    md = wide_fit_counts(K, I_FULL, L_FULL, np.full(L_FULL, 2), 240, dev)
    gen = torch.Generator(device=dev).manual_seed(241)
    eta = torch.rand((2, I_FULL, K), generator=gen, device=dev) + 0.05
    p = torch.rand((2, K, L_FULL, 2), generator=gen, device=dev) + 0.05
    return md, Params(eta=eta / eta.sum(-1, keepdim=True),
                      p=p / p.sum(-1, keepdim=True))


def wide_mesh_child(task: str, rank: int, world: int, init: str) -> int:
    """A rank of the wide mesh step: joins the gloo group on the one card,
    runs the meshed step at K = 200 on its block and writes its launches
    (and rank 0 the whole results) next to ``task``."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch.distributed as dist

    from multiclust_tpu_torch.ops import build
    from multiclust_tpu_torch.runtime import mesh as mesh_mod

    with open(task) as fh:
        spec = json.load(fh)
    dev = mesh_mod.initialize_distributed(
        num_processes=world, process_id=rank, backend="gloo", device="cuda",
        init_method=init)
    mesh = mesh_mod.cached_mesh(tuple(spec["shape"]))
    md, start = wide_mesh_panel(dev, spec["k"])
    whole, ll, launches = wide_mesh_step(md, start, mesh, build, spec["k"])
    if rank == 0:
        torch.save({"whole": [(w.eta.cpu(), w.p.cpu()) for w in whole],
                    "ll": ll.cpu()}, f"{task}.rank0.pt")
    with open(f"{task}.rank{rank}", "w") as fh:
        json.dump({"launches": launches}, fh)
    dist.destroy_process_group()
    return 0


def phase_wide_mesh(build, dev, where, tmp):
    """A 2x1 gloo meshed step at K = 200 (224 lanes) on the one card,
    held to the unsharded wide step run here first."""
    K, shape = 200, (2, 1)
    md, start = wide_mesh_panel(dev, K)
    whole, ll, _ = wide_mesh_step(md, start, None, build, K)
    ref = {"whole": [(w.eta.cpu(), w.p.cpu()) for w in whole],
           "ll": ll.cpu()}
    del md, start, whole
    torch.cuda.empty_cache()
    task = os.path.join(tmp, "wide_mesh.json")
    with open(task, "w") as fh:
        json.dump({"shape": shape, "k": K}, fh)
    t0 = time.time()
    wait_children("wide mesh 2x1", start_children(
        "--wide-mesh-child", task, 2,
        "file://" + os.path.join(tmp, "init_wide")), t0, WIDE_MESH_TIMEOUT)
    got = torch.load(f"{task}.rank0.pt")
    err = 0.0
    for g, w in zip(got["whole"], ref["whole"]):
        err = max(err, max_err(g[0], w[0]), max_err(g[1], w[1]))
    torch.testing.assert_close(got["ll"], ref["ll"], rtol=1e-5, atol=0)
    launches = []
    for r in range(2):
        with open(f"{task}.rank{r}") as fh:
            launches.append(json.load(fh)["launches"])
    for q in launches:
        for name in ("wide_rows", "wide_finish", "wide_cols_bi"):
            assert q.get(name, 0) >= 1, launches
    print(f"wide mesh 2x1 step at K={K}: max|d| against the unsharded wide "
          f"step {err:.3e} (rtol {RTOL}, atol {ATOL}); launches a rank "
          f"{launches}; {time.time() - t0:.1f} s wall with the children's "
          f"start-up, on {where}", flush=True)
    return {"2x1 K=200": {"launches_per_rank": launches,
                          "max_abs_err": err}}


def phase_wide_beyond(build, dev, where):
    """A step at 1056 lanes (K = 1040): the plain step, no kernel launched,
    its one-time notice on stderr, and the plain step's own result."""
    import contextlib
    import io

    from multiclust_tpu_torch.model import admixture as adm
    from multiclust_tpu_torch.model.common import EMConfig, Params

    K, Kp = 1040, 1056
    md = wide_fit_counts(K, 2048, 512, np.full(512, 2), 250, dev)
    gen = torch.Generator(device=dev).manual_seed(251)
    eta = torch.zeros((1, md.I, Kp), device=dev)
    eta[..., :K] = torch.rand((1, md.I, K), generator=gen, device=dev) + 0.05
    p = torch.zeros((1, Kp, md.L, 2), device=dev)
    p[:, :K] = torch.rand((1, K, md.L, 2), generator=gen, device=dev) + 0.05
    params = Params(eta=eta / eta.sum(-1, keepdim=True),
                    p=p / p.sum(-1, keepdim=True).clamp(min=1e-30))
    cfg = EMConfig(admixture=True, has_missing=True, use_pallas="on",
                   biallelic=True, k_true=K)
    assert not cfg.bi_repr_active
    adm._K_BEYOND_NOTICED.discard(Kp)
    build.reset_launch_counts()
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        out = adm.em_step(params, md, cfg)
        adm.em_step(out[0], md, cfg)
    torch.cuda.synchronize()
    want = adm._em_step_unconstrained(params, md, cfg)
    for g, w in zip((out[0].eta, out[0].p, out[1]),
                    (want[0].eta, want[0].p, want[1])):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=0)
    notice = f"K lanes ({Kp}) exceed the CUDA kernels' range (1024)"
    assert err.getvalue().count(notice) == 1, err.getvalue()
    assert not any(build.kernel_launches().values()), build.LAUNCHES
    print(f"wide beyond: a step at {Kp} lanes took the plain step (no "
          f"kernel launched; the notice once: {err.getvalue().strip()!r}) "
          f"on {where}", flush=True)


def phase_wide(fb, fs, build, dev, where):
    """Phase 21: the admixture step at 128 < Kp <= 1024 through the wide
    kernels, and above 1024 through the plain step; returns the kernels'
    records and the mesh entry."""
    t0 = time.time()
    torch.cuda.empty_cache()
    errs, ms, bnd, yard, steps = phase_wide_kernels(fb, fs, build, dev,
                                                    where)
    print(f"wide kernels: {time.time() - t0:.1f} s", flush=True)
    launches, launches_1024 = phase_wide_fits(build, dev, where)
    phase_wide_reference(build, dev)
    with tempfile.TemporaryDirectory() as tmp:
        phase_wide_cli(build, where, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        mesh = phase_wide_mesh(build, dev, where, tmp)
    phase_wide_beyond(build, dev, where)
    from multiclust_tpu_torch.kernel_report import WIDE, ptxas_lines
    report = build.library_path().with_suffix(".ptxas.txt").read_text()
    regs = {}
    for name, text in ptxas_lines(report, WIDE):
        print(f"ptxas {name}: {text}", flush=True)
        assert " 0 bytes spill stores, 0 bytes spill loads" in text, name
        regs[name] = int(re.search(r"Used (\d+) registers", text).group(1))
    # each pass's launches (the d launch is one kernel for both cells and
    # both passes, built in both sources; a step runs it once for both)
    pass_kernels = {"wide_rows": ("wide_cols_d_kernel",
                                  "wide_rows_a_kernel<kBi>"),
                    "wide_finish": ("wide_finish_kernel<8>",
                                    "wide_finish_kernel<32>"),
                    "wide_cols_bi": ("wide_cols_d_kernel",
                                     "wide_cols_b_kernel<kBi>"),
                    "wide_cols_generic": ("wide_cols_d_kernel",
                                          "wide_cols_b_kernel<kDense>")}
    records = []
    for name in WIDE_KERNELS:
        rec = kernel_record(name, WIDE_SOURCE, WIDE_TPU[name],
                            launches[name], errs[name], ms[name, 200],
                            bnd[name, 200])
        rec["shape"] = (f"K = 200 on 224 lanes, {I_FULL} x {L_FULL}, 2 "
                        f"chains, 1 % missing"
                        + (", M = 4" if name == "wide_cols_generic" else ""))
        if name == "wide_cols_bi":   # its launcher's epilogue, timed with it
            rec["timed_with"] = "fullstep_bi_p0_kernel"
        # the kernels behind the record (the finish: at K = 200 and 1024)
        rec["registers"] = {k: regs[k] for k in pass_kernels[name]}
        rec["kp1024"] = {"ms": ms[name, 1024][0],
                         "plain_ms": ms[name, 1024][1],
                         "bound_ms": bnd[name, 1024][0],
                         "bound_by": bnd[name, 1024][1]}
        if name in launches_1024:
            rec["kp1024"]["launches"] = launches_1024[name]
        if name == "wide_rows":   # timed through rows_partials: d + A
            rec["timed_with"] = "wide_cols_d_kernel"
            rec["routed_step_ms"] = steps[200]
            rec["kp1024"]["routed_step_ms"] = steps[1024]
        # no single PyTorch call computes these functions (library_ms
        # null); the float32 matmuls of their contractions beside them
        if (name, 200) in yard:
            rec["yardstick_matmuls_ms"] = yard[name, 200]
            rec["kp1024"]["yardstick_matmuls_ms"] = yard[name, 1024]
        records.append(rec)
    print(f"wide phase: {time.time() - t0:.1f} s", flush=True)
    return records, mesh


# ---------------------------------------------------------------------------
# phase 22: the mixture above 128 lanes (the wide kernels of
# csrc/mixture_bi.cu)

# the TPU kernels each wide mixture kernel replaces above 128 lanes: the
# step's scores pass and counts pass; the finish is the step's
MIX_WIDE_TPU = {"wide_mix_rows": "multiclust_tpu/ops/kernels.py:1139",
                "wide_mix_cols": "multiclust_tpu/ops/kernels.py:1172",
                "wide_mix_finish": MIX_TPU}
MIX_WIDE_KERNELS = tuple(MIX_WIDE_TPU)
MIX_WIDE_FIT_ITERS = {200: 30, 1024: 10}


def wide_mixture_pass_calls(mb, args, K):
    """(kernel, plain) callables of each wide mixture pass on the step
    inputs ``args``, with the inputs of the columns pass and the finish
    made by the kernels before them; the finish in the model's layout,
    as the fits run it."""
    lp0, x0, bias, lp1, x1 = args
    v, _ = mb.mixture_rows(lp0, x0, bias, lp1, x1, k_true=K)
    part, vpart = mb.mixture_partials(v, x0, x1, k_true=K)
    fkw = dict(k_true=K, lb=1e-8, plb=1e-8, ploidy=2, project=True,
               params=True)
    calls = {
        "wide_mix_rows": (
            lambda: mb.mixture_rows(lp0, x0, bias, lp1, x1, k_true=K),
            lambda: mb.mixture_rows_reference(lp0, x0, bias, lp1, x1)),
        # the partials, compared summed over segments
        "wide_mix_cols": (
            lambda: tuple(t.sum(dim=1) for t in mb.mixture_partials(
                v, x0, x1, k_true=K)),
            lambda: tuple(t[:, 0] for t in mb.mixture_cols_reference(
                v, x0, x1))),
        "wide_mix_finish": (
            lambda: mb.mixture_finish(part, vpart, **fkw),
            lambda: mb.mixture_finish_reference(part, vpart, **fkw))}
    return calls, v, part, vpart


def phase_wide_mixture_kernels(mb, build, dev, where):
    """The wide mixture kernels against their plain versions on the card:
    at 16384 x 2048, K = 200 and 1024, chain batches 1 and 2, one stream
    (missing-free) and two (1 % missing): the step, the sweep and each
    pass alone, reruns bit-equal, v and the partials 0 past K, the finish
    on the partials as check_mixture_finish holds it; each pass's
    time at 2 chains, one stream (CUDA events) beside its plain version's,
    its bound and the float64 matmul of its product; then every Kp of the
    range on a ragged 1001 x 4099 panel.  Returns errors, times, bounds
    and library times by (kernel, K)."""
    from multiclust_tpu_torch.model.common import k_padded_size
    from multiclust_tpu_torch.route_times import mixture_step_inputs

    errs = dict.fromkeys(MIX_WIDE_KERNELS, 0.0)
    ms, bnd, lib = {}, {}, {}
    for K in WIDE_K:
        Kp = k_padded_size(K, 32)
        kw = dict(k_true=K, lb=1e-8, plb=1e-8, ploidy=2, project=True)
        for B in (1, 2):
            for miss_rate in (0.0, 0.01):
                args = mixture_step_inputs(400 + K + B, B, I_FULL, L_FULL, K,
                                           Kp, miss_rate, dev)
                before = build.kernel_launches()
                got = mb.mixture_fullstep_biallelic(*args, **kw)
                # one launch of each, the finish's two halves in one
                assert {n: build.LAUNCHES[n] - before[n]
                        for n in MIX_KERNELS + MIX_WIDE_KERNELS} == \
                    dict.fromkeys(MIX_KERNELS + MIX_WIDE_KERNELS, 1)
                ref = mb.mixture_fullstep_biallelic_reference(*args, **kw)
                again = mb.mixture_fullstep_biallelic(*args, **kw)
                torch.cuda.synchronize()
                e_step = max(max_err(g, r) for g, r in zip(got, ref))
                assert all(torch.equal(g, a) for g, a in zip(got, again))
                assert (got[0][:, K:] == 0).all()
                del got, ref, again
                sweep = mb.mixture_sweep_stats(*args, k_true=K)
                sweep_ref = mb.mixture_sweep_stats_reference(*args)
                torch.cuda.synchronize()
                e_sw = max(max_err(g, r) for g, r in zip(sweep, sweep_ref)
                           if g is not None)
                assert (sweep[0][..., K:] == 0).all()
                del sweep, sweep_ref
                calls, v, part, vpart = wide_mixture_pass_calls(mb, args, K)
                assert (v[..., K:] == 0).all() and (vpart[..., K:] == 0).all()
                e_fin = check_mixture_finish(mb, build, part, vpart, kw)
                errs["wide_mix_finish"] = max(errs["wide_mix_finish"], e_fin)
                e_pass = {}
                for name, (kernel, plain) in calls.items():
                    k_out, p_out, again = kernel(), plain(), kernel()
                    torch.cuda.synchronize()
                    e_pass[name] = max(max_err(g, r)
                                       for g, r in zip(k_out, p_out))
                    assert all(torch.equal(g, a)
                               for g, a in zip(k_out, again)), name
                    errs[name] = max(errs[name], e_pass[name], e_step)
                    del k_out, p_out, again
                print(f"wide mixture K={K} ({Kp} lanes) {I_FULL} x {L_FULL} "
                      f"B={B} miss={miss_rate:.2f}: max|d| step {e_step:.3e}"
                      f", sweep {e_sw:.3e}, "
                      + ", ".join(f"{n} {e:.3e}" for n, e in e_pass.items())
                      + f", finish in the K-padded layout {e_fin:.3e} "
                      f"(rtol {RTOL}, atol {ATOL}); vtot and raw B "
                      f"bit-equal to the ordered sums over "
                      f"{part.shape[1]} segment(s); reruns bit-equal",
                      flush=True)
                if B == 2 and not miss_rate:
                    lp0, x0, bias = args[:3]
                    cells = B * I_FULL * L_FULL
                    t_rows = mb.mixture_rows(lp0, x0, bias, k_true=K)[1]
                    bounds = {
                        "wide_mix_rows": bound(
                            tensors_bytes((lp0, x0, bias, v, t_rows)),
                            2 * K * cells + 20 * B * I_FULL * K),
                        "wide_mix_cols": bound(
                            tensors_bytes((v, x0, part[:, :1])),
                            2 * K * cells),
                        "wide_mix_finish": finish_bound(part, vpart, K)}
                    for name, (kernel, plain) in calls.items():
                        ms[name, K] = (median_ms(kernel),
                                       median_ms(plain, n=5, warm=1))
                        bnd[name, K] = bounds[name]
                    # the yardstick the port never calls: each contraction
                    # pass's product alone, one float64 torch.matmul on
                    # K-wide operands (the plain version's arithmetic)
                    xx = x0.double()
                    lp_t = lp0[:, :K].double().transpose(1, 2)
                    v_t = v[..., :K].double().transpose(1, 2).contiguous()
                    lib["wide_mix_rows", K] = median_ms(
                        lambda: torch.matmul(xx, lp_t), n=5, warm=1)
                    lib["wide_mix_cols", K] = median_ms(
                        lambda: torch.matmul(v_t, xx), n=5, warm=1)
                    lib["wide_mix_finish", K] = None
                    del xx, lp_t, v_t, t_rows
                    for name in MIX_WIDE_KERNELS:
                        b = bnd[name, K]
                        print(f"wide mixture K={K} {name} at 2 chains, one "
                              f"stream: kernel {ms[name, K][0]:.4f} ms, "
                              f"plain {ms[name, K][1]:.3f} ms, bound "
                              f"{b[0]:.4f} ms ({b[1]}), "
                              f"{100 * b[0] / ms[name, K][0]:.1f} % of it, "
                              f"float64 matmul "
                              + ("none" if lib[name, K] is None
                                 else f"{lib[name, K]:.3f} ms")
                              + f" on {where}", flush=True)
                del args, calls, v, part, vpart
                torch.cuda.empty_cache()
    # every Kp of the range on a ragged panel, one stream and two
    for K, Kp in ((150, 160), (200, 224), (500, 512), (1024, 1024),
                  (130, 512)):
        e_rag = 0.0
        for miss_rate in (0.0, 0.03):
            args = mixture_step_inputs(450 + K, 2, 1001, 4099, K, Kp,
                                       miss_rate, dev)
            kw = dict(k_true=K, lb=1e-8, plb=1e-8, ploidy=2, project=True)
            got = mb.mixture_fullstep_biallelic(*args, **kw)
            ref = mb.mixture_fullstep_biallelic_reference(*args, **kw)
            again = mb.mixture_fullstep_biallelic(*args, **kw)
            torch.cuda.synchronize()
            assert all(torch.equal(g, a) for g, a in zip(got, again))
            e_rag = max(e_rag, max(max_err(g, r) for g, r in zip(got, ref)))
            calls, _, part, vpart = wide_mixture_pass_calls(mb, args, K)
            e_rag = max(e_rag, check_mixture_finish(mb, build, part, vpart,
                                                    kw))
            for name, (kernel, plain) in calls.items():
                err = max(max_err(g, r) for g, r in zip(kernel(), plain()))
                errs[name] = max(errs[name], err)
                e_rag = max(e_rag, err)
            del args, got, ref, again, calls, part, vpart
        print(f"wide mixture K={K} ({Kp} lanes) ragged 1001 x 4099, B=2, one "
              f"stream and two: max|d| {e_rag:.3e}; reruns bit-equal",
              flush=True)
    return errs, ms, bnd, lib


def phase_wide_mixture_fits(build, dev, where):
    """Mixture fits above 128 lanes through ``api.fit_model_data`` on
    16384 x 2048 panels (mixture-model ones drawn on the host and
    uploaded, ``route_times.mixture_planes``), 2 chains: K = 200 plain EM
    and SQUAREM (cap 30, missing-free: one stream) and plain EM at 1 %
    missing (two streams), K = 1024 plain EM (cap 10); then K = 200 on an M = 4
    and on the jagged mix (cap 10; the plain products with the finish's
    eta half and the generic p epilogue).  The launches of each run counted
    from 0; returns the wide kernels' launches in the K = 200 missing-free
    fits (the main path)."""
    from multiclust_tpu_torch.api import fit_model_data
    from multiclust_tpu_torch.model.common import model_data_from_planes
    from multiclust_tpu_torch.route_times import mixture_planes

    launches = {}
    for K in WIDE_K:
        runs = [("plain EM", 0.0, {})]
        if K == 200:
            runs += [("SQUAREM", 0.0, dict(accel_scheme=1)),
                     ("plain EM 1 % missing", 0.01, {})]
        for label, miss_rate, extra in runs:
            planes = mixture_planes(460 + K, I_FULL, L_FULL, K, miss_rate,
                                    dev)
            md = model_data_from_planes(*planes)
            fit_kw = dict(admixture=False, min_K=K, max_K=K, n_init=2,
                          max_iter=MIX_WIDE_FIT_ITERS[K], seed=3,
                          verbosity=0, **extra)
            build.reset_launch_counts()
            t0 = time.time()
            out = fit_model_data(md, 2, **fit_kw)
            torch.cuda.synchronize()
            accel = bool(extra)
            res = check_fit(out, time.time() - t0,
                            f"wide mixture K={K} {label}", where, md=md, K=K,
                            mono=not accel)
            wide = {n: build.LAUNCHES[n] for n in MIX_WIDE_KERNELS}
            ran = {k: v for k, v in build.kernel_launches().items() if v}
            print(f"wide mixture K={K} {label}: launches {wide}, all {ran}",
                  flush=True)
            steps = res.n_iter_all // 2
            for name in MIX_WIDE_KERNELS + ("mc_mix_finish",):
                assert build.LAUNCHES[name] >= steps > 0, (name, K, label)
            # one finish a step, as one columns pass
            assert build.LAUNCHES["mc_mix_finish"] == \
                build.LAUNCHES["mc_mix_cols"], build.LAUNCHES
            assert not any(build.LAUNCHES[n]
                           for n in BI_KERNELS + GENERIC_KERNELS)
            if K == 200 and not miss_rate:
                for name in MIX_WIDE_KERNELS:
                    launches[name] = launches.get(name, 0) + wide[name]
            if accel:
                wide_mixture_squarem_against_plain(
                    res, md, model_data_from_planes(*planes,
                                                    dtype=torch.float64),
                    fit_kw, where)
            del md, out, planes
            torch.cuda.empty_cache()
    K = 200
    jag = np.where(np.random.default_rng(10).random(L_FULL) < 0.8, 2, 8)
    for label, n_all in (("M=4", np.full(L_FULL, M_FULL)),
                         ("jagged 80 % M=2 + 20 % M=8", jag)):
        md = wide_fit_counts(K, I_FULL, L_FULL, n_all, 470, dev)
        build.reset_launch_counts()
        t0 = time.time()
        out = fit_model_data(md, 2, admixture=False, min_K=K, max_K=K,
                             n_init=2, max_iter=10, seed=3, verbosity=0)
        torch.cuda.synchronize()
        res = check_fit(out, time.time() - t0, f"wide mixture K={K} {label}",
                        where, md=md, K=K)
        ran = {k: v for k, v in build.kernel_launches().items() if v}
        print(f"wide mixture K={K} {label}: launches {ran}",
              flush=True)
        steps = res.n_iter_all // 2
        assert build.LAUNCHES["wide_mix_finish"] >= steps > 0, label
        assert build.LAUNCHES["mc_fullstep_p"] >= steps, label
        assert not build.LAUNCHES["mc_mix_rows"], label
        del md, out
        torch.cuda.empty_cache()
    return launches


def wide_mixture_squarem_against_plain(res, md, md64, fit_kw, where):
    """The wide-kernel SQUAREM fit ``res`` held to the same fit through the
    plain products on the card (the model's kernel gates patched off), from
    the same starts: the same iterations and monotonicity flag, the logL
    within the float32 noise floor of opt/em.py (the same law drawn by a
    CUDA generator recorded a violation on both routes; ROADMAP queue 3
    closes that entry); the float64 fit on the card from the same starts
    is printed beside them (``md64``, the panel's float64 ModelData)."""
    from multiclust_tpu_torch.api import fit_model_data
    from multiclust_tpu_torch.model import mixture as mix
    from multiclust_tpu_torch.model.common import EMConfig

    gates = mix._kernel_ok, mix._on_card
    mix._kernel_ok = mix._on_card = lambda *a, **k: False
    try:
        plain = fit_model_data(md, 2, **fit_kw).best
    finally:
        mix._kernel_ok, mix._on_card = gates
    f64 = fit_model_data(md64, 2, dtype="float64", **fit_kw).best
    floor = (EMConfig().noise_factor * float(np.finfo(np.float32).eps)
             * abs(plain.max_logL))
    gap = abs(res.max_logL - plain.max_logL)
    print(f"SQUAREM K={fit_kw['max_K']}: wide kernels logL "
          f"{res.max_logL:.4f}, {res.n_iter_all} iterations, monotonicity "
          f"violated {bool(res.mono_viol)}; plain products on the card "
          f"{plain.max_logL:.4f}, {plain.n_iter_all}, "
          f"{bool(plain.mono_viol)}: gap {gap:.4f} against the float32 "
          f"noise floor {floor:.4f}; float64 on the card {f64.max_logL:.4f}, "
          f"{f64.n_iter_all}, {bool(f64.mono_viol)} on {where}", flush=True)
    assert res.n_iter_all == plain.n_iter_all, (res.n_iter_all,
                                                plain.n_iter_all)
    assert bool(res.mono_viol) == bool(plain.mono_viol)
    assert gap <= floor, (gap, floor)


def phase_wide_mixture_reference(build, dev):
    """A 30-iteration-cap warm-start mixture fit at K = 200 through the
    wide kernels (600 x 500, 5 % missing, weakly separated clusters),
    held to the plain float64 fit on the CPU: within the float32 noise
    floor of opt/em.py."""
    from multiclust_tpu_torch.convert import model_data_from_numpy, \
        params_from_numpy
    from multiclust_tpu_torch.model import mixture as mix
    from multiclust_tpu_torch.model.common import EMConfig, Params
    from multiclust_tpu_torch.opt.driver import fit

    I, L, K = 600, 500, 200
    counts, miss = mixture_counts(81, I, L, K, 0.05, "cpu", spread=0.04)
    mask, n_all = np.ones((L, 2), bool), np.full(L, 2)
    rng = np.random.default_rng(82)
    eta = rng.dirichlet(np.full(K, 3.0))
    p0 = rng.uniform(0.2, 0.8, size=(K, L))
    p = np.stack([p0, 1 - p0], axis=2)
    base = dict(admixture=False, has_missing=True, biallelic=True, ploidy=2,
                max_iter=30, abs_error=1e-12, eta_lower_bound=1e-8,
                p_lower_bound=1e-8)
    md64 = model_data_from_numpy(counts, miss, mask, n_all)
    cpu = fit(params_from_numpy(eta, p), md64, EMConfig(**base))
    build.reset_launch_counts()
    gpu = fit(params_from_numpy(eta, p, device=dev, dtype=torch.float32),
              model_data_from_numpy(counts, miss, mask, n_all, device=dev,
                                    dtype=torch.float32),
              EMConfig(use_pallas="on", **base))
    wide = {n: build.LAUNCHES[n] for n in MIX_WIDE_KERNELS}
    _, scale = mix.log_likelihood(Params(eta=cpu.params.eta[None],
                                         p=cpu.params.p[None]), md64,
                                  EMConfig(**base))
    floor = (EMConfig().noise_factor * float(np.finfo(np.float32).eps)
             * float(scale[0]))
    gap = abs(gpu.logL - cpu.logL)
    print(f"wide mixture reference fit K={K}: kernel path logL "
          f"{gpu.logL:.4f} after {gpu.n_iter} iterations vs float64 CPU "
          f"{cpu.logL:.4f} after {cpu.n_iter}: gap {gap:.4f} against the "
          f"float32 noise floor {floor:.4f}; launches {wide}", flush=True)
    assert gpu.n_iter <= 31 and cpu.n_iter <= 31
    assert gap <= floor, (gap, floor)
    assert all(wide[n] >= gpu.n_iter for n in MIX_WIDE_KERNELS), wide


def phase_wide_mixture_cli(build, dev, where, tmp):
    """The CLI at ``-k 200 -n 2 -T 30`` (the mixture, no -a) on a 16384 x
    2048 STRUCTURE file of a mixture-model panel: through the wide
    kernels, every output file written."""
    from multiclust_tpu_torch.cli import main

    K = WIDE_CLI_K
    counts, miss = mixture_counts(480, I_FULL, L_FULL, K, 0.0, dev)
    path = os.path.join(tmp, "wide_mix.str")
    write_structure_biallelic(path, counts, miss)
    del counts, miss
    build.reset_launch_counts()
    t0 = time.time()
    rc = main(["-f", path, "-k", str(K), "-n", "2", "-T",
               str(WIDE_CLI_ITERS), "-s", "1", "-d", tmp])
    torch.cuda.synchronize()
    wall = time.time() - t0
    assert rc == 0, rc
    outs = [f for f in os.listdir(tmp) if f != "wide_mix.str"]
    assert len(outs) == 5 and all(
        os.path.getsize(os.path.join(tmp, f)) > 0 for f in outs), outs
    wide = {n: build.LAUNCHES[n] for n in MIX_WIDE_KERNELS}
    assert all(n > 0 for n in wide.values()), wide
    print(f"wide mixture cli -k {K} -n 2 -T {WIDE_CLI_ITERS} on {I_FULL} x "
          f"{L_FULL}: rc 0 in {wall:.1f} s, files {sorted(outs)}, launches "
          f"{wide} on {where}", flush=True)


def phase_wide_mixture_beyond(build, dev, where):
    """A mixture step at 1056 lanes (K = 1040), one stream and two: the
    plain step, no kernel launched, nothing printed, and the step with the
    kernels off."""
    import contextlib
    import io

    from multiclust_tpu_torch.model import mixture as mix
    from multiclust_tpu_torch.model.common import EMConfig, Params, \
        model_data_from_planes
    from multiclust_tpu_torch.route_times import mixture_planes

    K = 1040
    for miss_rate in (0.0, 0.01):
        md = model_data_from_planes(*mixture_planes(490, 2048, 512, 8,
                                                    miss_rate, dev))
        gen = torch.Generator(device=dev).manual_seed(491)
        eta = torch.rand((1, K), generator=gen, device=dev) + 0.05
        p = torch.rand((1, K, md.L, 2), generator=gen, device=dev) + 0.05
        params = Params(eta=eta / eta.sum(-1, keepdim=True),
                        p=p / p.sum(-1, keepdim=True))
        kw = dict(admixture=False, biallelic=True,
                  has_missing=bool(miss_rate), ploidy=2)
        cfg = EMConfig(use_pallas="on", **kw)
        assert not mix._kernel_ok(md, cfg, params)
        build.reset_launch_counts()
        text = io.StringIO()
        with contextlib.redirect_stderr(text), \
                contextlib.redirect_stdout(text):
            got = mix.em_step(params, md, cfg)
        torch.cuda.synchronize()
        want = mix.em_step(params, md, EMConfig(use_pallas="off", **kw))
        for g, w in zip((got[0].eta, got[0].p, got[1]),
                        (want[0].eta, want[0].p, want[1])):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
        assert not text.getvalue(), text.getvalue()
        assert not any(build.kernel_launches().values()), build.LAUNCHES
    print(f"wide mixture beyond: steps at 1056 lanes took the plain step "
          f"(no kernel launched, nothing printed), one stream and two, on "
          f"{where}", flush=True)


def phase_wide_mixture(mb, build, dev, where):
    """Phase 22: the mixture at 128 < Kp <= 1024 through the wide mixture
    kernels, and above 1024 through the plain step; returns the kernels'
    records."""
    t0 = time.time()
    torch.cuda.empty_cache()
    errs, ms, bnd, lib = phase_wide_mixture_kernels(mb, build, dev, where)
    print(f"wide mixture kernels: {time.time() - t0:.1f} s", flush=True)
    launches = phase_wide_mixture_fits(build, dev, where)
    phase_wide_mixture_reference(build, dev)
    with tempfile.TemporaryDirectory() as tmp:
        phase_wide_mixture_cli(build, dev, where, tmp)
    phase_wide_mixture_beyond(build, dev, where)
    report = build.library_path().with_suffix(".ptxas.txt").read_text()
    from multiclust_tpu_torch.kernel_report import MIX_WIDE, ptxas_lines
    for name, text in ptxas_lines(report, MIX_WIDE):
        print(f"ptxas {name}: {text}", flush=True)
        assert " 0 bytes spill stores, 0 bytes spill loads" in text, name
    records = []
    for name in MIX_WIDE_KERNELS:
        rec = kernel_record(name, MIX_SOURCE, MIX_WIDE_TPU[name],
                            launches[name], errs[name], ms[name, 200],
                            bnd[name, 200], lib[name, 200])
        rec["shape"] = (f"K = 200 on 224 lanes, {I_FULL} x {L_FULL}, 2 "
                        f"chains, one stream")
        rec["kp1024"] = {"ms": ms[name, 1024][0],
                         "plain_ms": ms[name, 1024][1],
                         "bound_ms": bnd[name, 1024][0],
                         "bound_by": bnd[name, 1024][1],
                         "library_ms": lib[name, 1024]}
        records.append(rec)
    print(f"wide mixture phase: {time.time() - t0:.1f} s", flush=True)
    return records


# ---------------------------------------------------------------------------
# phase 23: the mixed-K sweep

SWEEP_RUN_MODES = ("static", "merged", "shared")
I_WIDE_SWEEP, L_WIDE_SWEEP = 4096, 2048
# (label, admixture, panel, K range, -n, iteration cap)
SWEEP_CASES = (
    ("admixture", True, "biallelic", (2, 20), 8, 20),
    ("mixture", False, "biallelic", (2, 20), 4, 20),
    ("admixture M=4", True, "M=4", (2, 8), 4, 20),
    ("wide admixture", True, "wide", (129, 140), 2, 8),
    ("wide mixture", False, "wide", (129, 140), 2, 8),
)
MASKED_KERNELS = ("masked_pair_rows", "masked_rows_finish",
                  "masked_wide_finish", "masked_p", "masked_mix_rows",
                  "masked_mix_softmax", "masked_mix_finish")


def sweep_panels(dev):
    """The phase's panels on the card: phase 1's biallelic panel, phase 8's
    M = 4 one (made on the card) and a 4096 x 2048 biallelic one."""
    from multiclust_tpu_torch.convert import dataset_from_counts
    from multiclust_tpu_torch.model.common import model_data_from_dataset

    counts, miss = simulated_counts(np.random.default_rng(2), I_FULL, L_FULL,
                                    K_FULL, 0.01)
    bi = model_data_from_dataset(dataset_from_counts(counts, miss, 2),
                                 dtype=torch.float32, device=dev,
                                 storage_dtype=torch.int8)
    return {"biallelic": bi,
            "M=4": wide_fit_counts(K_FULL, I_FULL, L_FULL,
                                   np.full(L_FULL, M_FULL), 42, dev),
            "wide": wide_fit_counts(140, I_WIDE_SWEEP, L_WIDE_SWEEP,
                                    np.full(L_WIDE_SWEEP, 2), 240, dev)}


def sweep_fit(md, mode, kw):
    """``api.fit_model_data`` of a K-sweep under MULTICLUST_SWEEP_MODE =
    ``mode``: (its EstimateResult, wall seconds, (model steps, chain-steps
    they computed))."""
    from multiclust_tpu_torch.api import fit_model_data
    from multiclust_tpu_torch.opt import em as em_mod

    steps = [0, 0]
    model_step = em_mod.model_em_step

    def counted(params, *a, **k):
        steps[0] += 1
        steps[1] += params.eta.shape[0]
        return model_step(params, *a, **k)
    os.environ["MULTICLUST_SWEEP_MODE"] = mode
    em_mod.model_em_step = counted
    try:
        t0 = time.time()
        out = fit_model_data(md, 2, **kw)
        torch.cuda.synchronize()
        return out.estimate, time.time() - t0, tuple(steps)
    finally:
        em_mod.model_em_step = model_step
        del os.environ["MULTICLUST_SWEEP_MODE"]


def noise_floor(res, md, opt, K) -> float:
    """The float32 noise floor of opt/em.py at ``res``'s best parameters:
    noise_factor x eps x the RMS scale of their logL terms."""
    from multiclust_tpu_torch.model.common import map_params
    from multiclust_tpu_torch.opt.em import model_log_likelihood
    from multiclust_tpu_torch.runtime.multistart import cfg_from_options

    cfg = cfg_from_options(opt, K, md)
    _, scale = model_log_likelihood(
        map_params(lambda t: t[None], res.best_params), md, cfg)
    return cfg.noise_factor * float(np.finfo(np.float32).eps) * float(scale)


def lattice_route(md, opt, est):
    """The biallelic step's route of a merged sweep's lattice (its chains
    of every K >= 2 at the largest K's config and lanes), or None where
    the step takes no route (the mixture, the generic layout)."""
    from multiclust_tpu_torch.model.admixture import bi_route
    from multiclust_tpu_torch.runtime.multistart import cfg_from_options, \
        lattice_lanes

    ks = [K for K in est.per_K if K >= 2]
    cfg = cfg_from_options(opt, max(ks), md)
    if not cfg.bi_repr_active:
        return None
    B = sum(est.per_K[K].batch_chains for K in ks)
    return bi_route(B, md, cfg, lattice_lanes(max(ks), cfg))


def sweep_fit_on_route(md, kw, route):
    """``sweep_fit`` of the static sweep with every biallelic step forced
    onto ``route``, the route its merged lattice takes."""
    from multiclust_tpu_torch.model import admixture

    pick = admixture.bi_route
    admixture.bi_route = lambda *a, **k: route
    try:
        return sweep_fit(md, "static", kw)
    finally:
        admixture.bi_route = pick


def phase_sweep_runs(build, dev, where):
    """The phase's sweeps in the three modes and, where the merged lattice
    runs the biallelic step on another route than the serial fits, the
    static sweep forced onto the lattice's route; the masked kernels'
    launches over them, counted from 0."""
    from multiclust_tpu_torch.config import Options

    panels = sweep_panels(dev)
    build.reset_launch_counts()
    walls, gaps = {}, []
    for label, admixture, panel, (k_lo, k_hi), n_init, cap in SWEEP_CASES:
        md = panels[panel]
        kw = dict(admixture=admixture, min_K=k_lo, max_K=k_hi,
                  n_init=n_init, max_iter=cap, seed=3, verbosity=0)
        opt = Options(**kw).synchronize(md.I, 2)
        runs = {}

        def run(mode, fit):
            before = {n: build.LAUNCHES[n] for n in MASKED_KERNELS}
            runs[mode] = fit()
            walls[label, mode] = runs[mode][1]
            masked = {n: build.LAUNCHES[n] - before[n]
                      for n in MASKED_KERNELS if build.LAUNCHES[n] > before[n]}
            est, _, (n_steps, chain_steps) = runs[mode]
            print(f"sweep {label} K={k_lo}..{k_hi} -n {n_init} cap {cap} "
                  f"{mode}: {runs[mode][1]:.2f} s wall, {n_steps} model "
                  f"steps of {chain_steps} chain-steps; AIC K={est.aic_K}, "
                  f"BIC K={est.bic_K}; masked launches {masked}; route "
                  f"{est.per_K[k_hi].route or '-'} on {where}", flush=True)
            assert bool(masked) == (mode == "merged"), (label, mode, masked)
        for mode in SWEEP_RUN_MODES:
            run(mode, lambda mode=mode: sweep_fit(md, mode, kw))
        want = runs["static"][0].per_K
        route = lattice_route(md, opt, runs["merged"][0])
        if route is not None and any(
                runs["merged"][0].per_K[K].route != want[K].route
                for K in want):
            # the witness: the serial fits on the lattice's route, which
            # tells the route's rounding from the mask's
            run("static on the lattice's route",
                lambda: sweep_fit_on_route(md, kw, route))
            print(f"sweep {label}: the lattice's route, forced on the "
                  f"static sweep: {route.describe()}", flush=True)
        witness = runs.get("static on the lattice's route")
        for K in range(k_lo, k_hi + 1):
            floor = noise_floor(want[K], md, opt, K)
            line = [f"K={K}: static n_launched {want[K].n_launched}, "
                    f"{want[K].n_iter_all} iterations, logL "
                    f"{want[K].max_logL:.4f}"]
            for mode in runs:
                if mode == "static":
                    continue
                got = runs[mode][0].per_K[K]
                d = got.max_logL - want[K].max_logL
                line.append(f"{mode} {got.n_launched}, {got.n_iter_all} "
                            f"iterations, {got.max_logL:.4f} ({d:+.4f}, "
                            f"{abs(d) / floor:.2f} floors)")
                assert got.best_params.kmask is None
            merged = runs["merged"][0].per_K[K]
            drift = None
            if merged.route != want[K].route:
                w = witness[0].per_K[K]
                drift = w.max_logL - want[K].max_logL
                dw = merged.max_logL - w.max_logL
                line.append(f"merged against the static sweep on its route "
                            f"{dw:+.4f} ({abs(dw) / floor:.2f} floors)")
                gaps.append((label, K, "merged / static on its route",
                             merged.n_launched, w.n_launched, dw, floor))
            gaps.append((label, K, "merged", merged.n_launched,
                         want[K].n_launched,
                         merged.max_logL - want[K].max_logL,
                         floor + abs(drift or 0.0)))
            shared = runs["shared"][0].per_K[K]
            assert (shared.max_logL, shared.n_iter_all, shared.n_launched) \
                == (want[K].max_logL, want[K].n_iter_all,
                    want[K].n_launched), (label, K, "shared")
            print(f"sweep {label} " + "; ".join(line)
                  + f"; noise floor {floor:.4f}", flush=True)
        del runs, witness
        torch.cuda.empty_cache()
    launches = {n: build.LAUNCHES[n] for n in MASKED_KERNELS}
    print(f"masked launches in the phase's sweeps: {launches}", flush=True)
    for name, n in launches.items():
        assert n > 0, (name, launches)
    # merged against the serial fits: within the noise floor on the same
    # route (the lattice against the static sweep forced onto its route);
    # against the serial fits on their own route, within the floor beyond
    # what that route change alone moved the static sweep
    for label, K, what, n_got, n_want, d, limit in gaps:
        assert n_got == n_want, (label, K, what, n_got, n_want)
        assert abs(d) <= limit, (label, K, what, d, limit)
    a, m = walls["admixture", "merged"], walls["admixture", "static"]
    print(f"sweep admixture K=2..20 -n 8 at {I_FULL} x {L_FULL}: the "
          f"152-chain lattice (merged) {a:.2f} s against 19 serial fits of "
          f"8 chains (static) {m:.2f} s: the lattice is "
          f"{'faster' if a < m else 'slower'} ({m / a:.2f}x) on {where}",
          flush=True)
    return launches, panels


def sweep_step_params(gen, ks, width, md, admixture, masked):
    """Parameters of chains of K = ``ks`` clusters on ``width`` lanes (the
    biallelic p0 layout for the admixture), drawn with ``gen``, with their
    kmask where ``masked``."""
    from multiclust_tpu_torch.model.common import Params

    dev = md.device
    B = len(ks)
    lanes = torch.arange(width, device=dev)[None, :] < torch.as_tensor(
        ks, device=dev)[:, None]
    eta_shape = (B, md.I, width) if admixture else (B, width)
    eta = torch.rand(eta_shape, generator=gen, device=dev) + 0.05
    eta = eta * (lanes[:, None, :] if admixture else lanes)
    eta = (eta / eta.sum(dim=-1, keepdim=True)).contiguous()
    p0 = (0.02 + 0.96 * torch.rand((B, width, md.L), generator=gen,
                                   device=dev)) * lanes[:, :, None]
    p = p0 if admixture else torch.stack([p0, 1 - p0], dim=-1) \
        * lanes[:, :, None, None]
    return Params(eta=eta, p=p.contiguous(),
                  kmask=lanes.float() if masked else None)


def phase_sweep_steps(md, where):
    """One EM step of the phase's lattices (152 admixture chains of K =
    2..20 on the pair, k_true 20; 76 mixture chains, width 20) against the
    sum of the 19 serial steps of each K's chains at k_true = K, and the
    same lattice of K = 20 chains with no mask, median CUDA-event ms."""
    from multiclust_tpu_torch.config import Options
    from multiclust_tpu_torch.opt.em import model_em_step
    from multiclust_tpu_torch.runtime.multistart import cfg_from_options

    gen = torch.Generator(device=md.device).manual_seed(19)
    for label, admixture, n in (("admixture", True, 8),
                                ("mixture", False, 4)):
        opt = Options(admixture=admixture, min_K=2, max_K=K_FULL,
                      n_init=n).synchronize(md.I, 2)

        def step_ms(ks, masked, k_cfg):
            width = 32 if admixture else k_cfg
            params = sweep_step_params(gen, ks, width, md, admixture, masked)
            cfg = cfg_from_options(opt, k_cfg, md)
            t = median_ms(lambda: model_em_step(params, md, cfg), n=5,
                          warm=2)
            del params
            return t
        ks = [K for K in range(2, K_FULL + 1) for _ in range(n)]
        lattice = step_ms(ks, True, K_FULL)
        same = step_ms([K_FULL] * len(ks), False, K_FULL)
        serial = [step_ms([K] * n, False, K) for K in range(2, K_FULL + 1)]
        print(f"sweep step {label} {md.I} x {md.L}: the lattice of "
              f"{len(ks)} chains (K = 2..{K_FULL}, masked) {lattice:.3f} ms; "
              f"{len(ks)} chains of K = {K_FULL} unmasked {same:.3f} ms "
              f"({lattice / same:.3f}x); 19 serial steps of {n} chains "
              f"{sum(serial):.3f} ms in all (K = 2 {serial[0]:.3f}, K = "
              f"{K_FULL} {serial[-1]:.3f}): the lattice "
              f"{lattice / sum(serial):.2f}x of them on {where}",
              flush=True)
        torch.cuda.empty_cache()


def lattice_mask(k_lo, k_hi, n, Kp, dev):
    """[B, Kp] kmask of a merged sweep's lattice, ``n`` chains of each K =
    k_lo..k_hi in turn as ``swept_maximize`` lays them out, and their K."""
    ks = np.repeat(np.arange(k_lo, k_hi + 1), n)
    km = (np.arange(Kp)[None] < ks[:, None]).astype(np.float32)
    return torch.tensor(km, device=dev), ks


def in_groups(fn, n_chains, size):
    """``fn(lo, hi)`` over chain groups [lo, hi) of ``size``, each output
    concatenated over the groups: a plain version over a lattice whose
    [B, I, L] temporaries would not fit on the card at once."""
    parts = [fn(lo, min(lo + size, n_chains))
             for lo in range(0, n_chains, size)]
    return tuple(torch.cat(t) for t in zip(*parts))


def masked_step_inputs(rng, B, I, L, ks, km, dev):
    """step_inputs of a lattice: eta and p0 zero outside each chain's lanes,
    eta's rows renormalized over them."""
    e, p, a, z, c, m = step_inputs(rng, B, I, L, int(ks.max()),
                                   km.shape[1], 0.01, dev)
    e = e * km[:, None, :]
    e = (e / e.sum(dim=-1, keepdim=True)).contiguous()
    return e, (p * km[:, :, None]).contiguous(), a, z, c, m


def masked_mix_inputs(rng, md, km, ks, k_true):
    """Mixture rows-pass inputs of a lattice on ``md``'s two streams: lp
    of each chain's lanes, bias log eta there, 0 on the lanes outside the
    chain's mask below k_true (scores that would lead, were they not
    masked), the pad value past it."""
    from multiclust_tpu_torch.model.mixture import PAD_BIAS

    B, Kp = km.shape
    L = md.L
    dev = km.device
    p0 = torch.tensor(rng.uniform(0.02, 0.98, size=(B, Kp, L)),
                      dtype=torch.float32, device=dev) * km[:, :, None]
    lp0 = torch.where(p0 > 0, torch.log(p0.clamp(min=1e-30)), 0.0)
    lp1 = torch.where(p0 > 0, torch.log1p(-p0), 0.0)
    eta = np.zeros((B, Kp), np.float32)
    for b, K in enumerate(ks):
        eta[b, :K] = rng.dirichlet(np.ones(K))
    bias = torch.tensor(np.where(eta > 0, np.log(np.maximum(eta, 1e-30)),
                                 0.0), dtype=torch.float32, device=dev)
    bias[:, k_true:] = PAD_BIAS
    return (lp0.contiguous(), md.x0, bias.contiguous(), lp1.contiguous(),
            md.x1)


def phase_masked_kernels(fb, fs, mb, dev, where, panels, launches):
    """Each masked kernel against its plain version at the batch the
    phase's merged lattices give it (each K's chains in turn, as
    ``swept_maximize`` lays them out), timed there; returns their
    records."""
    from multiclust_tpu_torch.route_times import finish_bytes, \
        mix_finish_bytes, p_bytes

    rng = np.random.default_rng(23)
    gen = torch.Generator(device=dev).manual_seed(23)
    n_sm = fb.device_sm_count(dev)
    recs = []

    def record(name, source, replaces, counter, kernel, plain, n_bytes,
               n_flop, check=None, lib=None, n_plain=3):
        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        err = max(max_err(g, r) for g, r in zip(got, ref)
                  if g is not None)
        if check is not None:
            check(got)
        del got, ref
        bnd = bound(n_bytes, n_flop)
        ms = (median_ms(kernel), median_ms(plain, n=n_plain, warm=1))
        lib_ms = median_ms(lib, n=5, warm=1) if lib is not None else None
        print(f"{name}: max|d| {err:.3e} (rtol {RTOL}, atol {ATOL}); kernel "
              f"{ms[0]:.4f} ms, plain {ms[1]:.3f} ms, bound {bnd[0]:.4f} ms "
              f"({bnd[1]}; {100 * bnd[0] / ms[0]:.1f} %)"
              + (f", library {lib_ms:.3f} ms" if lib_ms is not None else "")
              + f", {launches[counter]} launches in the sweeps, on {where}",
              flush=True)
        recs.append(kernel_record(name, source, replaces, launches[counter],
                                  err, ms, bnd, lib_ms))
        torch.cuda.empty_cache()

    def off_zero(km):
        def check(got):
            eta = got[0]
            off = (km < 0.5)[:, None, :].expand_as(eta)
            assert (eta.masked_select(off) == 0).all()
        return check

    # the pair's rows pass: the admixture lattice, 152 chains of K = 2..20
    # on 32 lanes, k_true 20, on the sweep's panel; the plain version 8
    # chains at a time
    md = panels["biallelic"]
    km, ks = lattice_mask(2, K_FULL, 8, 32, dev)
    B = len(ks)
    prm = sweep_step_params(gen, ks, 32, md, True, True)
    e, p, a, z, c = prm.eta, prm.p, md.x0, md.x1, md.c.float()
    del prm
    kw = dict(k_true=K_FULL, lb=1e-8, project=True, compute_t=True)
    out = fb.fullstep_bi_rows(e, p, a, z, c, km, **kw)
    out_bytes = tensors_bytes(out)
    del out
    record("fullstep_bi_rows (kmask)", SOURCE, TPU_KERNEL, "masked_pair_rows",
           lambda: fb.fullstep_bi_rows(e, p, a, z, c, km, **kw),
           lambda: in_groups(lambda lo, hi: fb.fullstep_bi_rows_reference(
               e[lo:hi], p[lo:hi], a, z, c, km[lo:hi], **kw), B, 8),
           tensors_bytes((e, p, a, z, c, km)) + out_bytes,
           sum(4 * int(k) + 10 for k in ks) * md.I * md.L, off_zero(km),
           n_plain=2)
    del e, p
    torch.cuda.empty_cache()

    # the rows finish: the M = 4 lattice, 28 chains of K = 2..8, 32 lanes,
    # at the generic rows pass's segment count (partials of the biallelic
    # segmented pass on the sweep's panel)
    km, ks = lattice_mask(2, 8, 4, 32, dev)
    prm = sweep_step_params(gen, ks, 32, md, True, True)
    e = prm.eta
    n_g, _ = fb.row_segments(len(ks), md.I, md.L * M_FULL, n_sm, k_true=8,
                             Kp=32)
    seg_cols = -(-md.L // (n_g * fb.ROW_TL)) * fb.ROW_TL
    apart, tpart = fb.rows_partials(e, prm.p, md.x0, md.x1, l_lo=0,
                                    l_hi=md.L, seg_cols=seg_cols, k_true=8)
    del prm
    n_cseg = apart.shape[1]
    print(f"rows_finish (kmask): {len(ks)} chains, {n_cseg} segments (the "
          f"generic pass's {n_g})", flush=True)
    fkw = dict(k_true=8, lb=1e-8, project_eta=True)
    record("rows_finish (kmask)", "multiclust_tpu_torch/csrc/tiles.cuh",
           FINISH_TPU, "masked_rows_finish",
           lambda: fb.rows_finish(e, apart, tpart, c, None, km, **fkw),
           lambda: fb.rows_finish_reference(e, apart, tpart, c, None, km,
                                            **fkw),
           sum(finish_bytes(1, md.I, 32, n_cseg, int(k))[1] for k in ks),
           0, off_zero(km))
    del e, apart, tpart, c
    torch.cuda.empty_cache()

    # the wide finish: the wide admixture lattice, 24 chains of K =
    # 129..140 on 160 lanes
    md = panels["wide"]
    km, ks = lattice_mask(129, 140, 2, 160, dev)
    e, p, a, z, c, _ = masked_step_inputs(rng, len(ks), md.I, md.L, ks, km,
                                          dev)
    n_cseg, seg_cols = fb.row_segments(len(ks), md.I, md.L, n_sm,
                                       k_true=140, Kp=160)
    apart, tpart = fb.rows_partials(e, p, a, z, l_lo=0, l_hi=md.L,
                                    seg_cols=seg_cols, k_true=140)
    fkw = dict(k_true=140, lb=1e-8, project_eta=True)
    record("wide_finish (kmask)", "multiclust_tpu_torch/csrc/wide.cuh",
           FINISH_TPU, "masked_wide_finish",
           lambda: fb.rows_finish(e, apart, tpart, c, None, km, **fkw),
           lambda: fb.rows_finish_reference(e, apart, tpart, c, None, km,
                                            **fkw),
           sum(finish_bytes(1, md.I, 160, n_cseg, int(k))[1] for k in ks),
           0, off_zero(km))
    del e, p, a, z, c, apart, tpart
    torch.cuda.empty_cache()

    # the generic p epilogue: the M = 4 lattice, 28 chains of K = 2..8, 32
    # lanes
    km, ks = lattice_mask(2, 8, 4, 32, dev)
    eta, p2, x2, c, miss, mask = generic_inputs(42, len(ks), I_FULL, L_FULL,
                                                np.full(L_FULL, M_FULL), 8,
                                                32, 0.01, dev)
    eta = eta * km[:, None, :]
    eta = (eta / eta.sum(dim=-1, keepdim=True)).contiguous()
    p2 = (p2 * km[:, :, None]).contiguous()
    part = fs.fullstep_partials(eta, p2, x2, miss, M=M_FULL, k_true=8)
    pkw = dict(k_true=8, plb=1e-8, project=True)

    def p_check(got):
        off = (km < 0.5)[:, :, None, None].expand_as(got[0])
        assert (got[0].masked_select(off) == 0).all()
    LM = L_FULL * M_FULL
    record("fullstep_p (kmask)", GENERIC_SOURCE, GENERIC_TPU, "masked_p",
           lambda: (fs.fullstep_p(p2, part, mask, km, M=M_FULL, **pkw),),
           lambda: (fs.fullstep_p_reference(p2, part, mask, km, **pkw),),
           sum(p_bytes(1, 32, LM, part.shape[1], int(k))[1] for k in ks),
           0, p_check)
    del eta, p2, x2, c, miss, mask, part
    torch.cuda.empty_cache()

    # the mixture: its lattice, 76 chains of K = 2..20 on 32 lanes (two
    # streams), and the wide one, 24 chains of K = 129..140 on 160 lanes
    for name, counter, md, n, (k_lo, k_hi), Kp in (
            ("mixture_rows (kmask)", "masked_mix_rows", panels["biallelic"],
             4, (2, K_FULL), 32),
            ("mixture_rows_wide+softmax (kmask)", "masked_mix_softmax",
             panels["wide"], 2, (129, 140), 160)):
        km, ks = lattice_mask(k_lo, k_hi, n, Kp, dev)
        B = len(ks)
        args = masked_mix_inputs(rng, md, km, ks, k_hi)
        flop = sum(2 * 2 * md.I * md.L * int(k) for k in ks)

        def v_check(got, km=km):
            off = (km < 0.5)[:, None, :].expand_as(got[0])
            assert (got[0].masked_select(off) == 0).all()
        xx = md.x0.double()
        lp_t = args[0][:, :k_hi].double().transpose(1, 2)
        record(name, MIX_SOURCE, MIX_TPU, counter,
               lambda: mb.mixture_rows(*args, km, k_true=k_hi),
               lambda: mb.mixture_rows_reference(*args, km),
               tensors_bytes(args, km) + 4 * B * md.I * (Kp + 1), flop,
               v_check, lib=lambda: torch.matmul(xx, lp_t))
        del xx, lp_t
        v, _ = mb.mixture_rows(*args, km, k_true=k_hi)
        part, vpart = mb.mixture_partials(v, args[1], args[4], k_true=k_hi)
        del v
        fkw = dict(k_true=k_hi, lb=1e-8, plb=1e-8, ploidy=2, project=True,
                   params=True)

        def eta_check(got, km=km, k_hi=k_hi):
            assert (got[0].masked_select(km[:, :k_hi] < 0.5) == 0).all()
        if Kp == 32:
            record("mixture_finish (kmask)", MIX_SOURCE, MIX_TPU,
                   "masked_mix_finish",
                   lambda: mb.mixture_finish(part, vpart, km, **fkw),
                   lambda: mb.mixture_finish_reference(part, vpart, km,
                                                       **fkw),
                   sum(mix_finish_bytes(1, part.shape[1], 2, int(k), md.L,
                                        True) for k in ks), 0, eta_check)
        else:
            # the finish's eta half at 160 lanes (KJ = 8): held to plain,
            # its error in the record
            got = mb.mixture_finish(part, vpart, km, **fkw)
            ref = mb.mixture_finish_reference(part, vpart, km, **fkw)
            torch.cuda.synchronize()
            err = max(max_err(g, r) for g, r in zip(got, ref))
            eta_check(got)
            print(f"mixture_finish (kmask) at {Kp} lanes, {B} chains of "
                  f"K = {k_lo}..{k_hi}: max|d| {err:.3e}", flush=True)
            fin = next(r for r in recs
                       if r["name"] == "mixture_finish (kmask)")
            fin["max_abs_err"] = max(fin["max_abs_err"], err)
            del got, ref
        del part, vpart, args
        torch.cuda.empty_cache()
    return recs


def phase_sweep(fb, fs, mb, build, dev, where):
    """Phase 23: the sweeps, then the masked kernels' checks and times."""
    t0 = time.time()
    launches, panels = phase_sweep_runs(build, dev, where)
    phase_sweep_steps(panels["biallelic"], where)
    t1 = time.time()
    recs = phase_masked_kernels(fb, fs, mb, dev, where, panels, launches)
    print(f"sweep phase: {time.time() - t0:.1f} s ({t1 - t0:.1f} s the "
          f"sweeps and their steps) on {where}", flush=True)
    return recs


# phase 24: the admixture start's counts

COUNT_SHAPE = (938, 71544, 2)     # a window of hgdp650k's start, 2 copies
COUNT_CASES = ((7, 2), (200, 4), (1024, 2))  # (K, M)
# windows of a start read from the count planes: hgdp650k's, and one of
# TeraStructure's 10^6 x 10^4 panel (about 64 loci); (I, L, K)
PLANE_CASES = ((938, 71544, 7), (1_000_000, 64, 6))


def phase_allele_counts(build, dev, where, launches, plane_launches):
    """Phase 24: ``init/random.allele_partition_counts`` on the card
    against its plain version, exact, at a window of hgdp650k's start,
    then the planes' variant (``plane_counts_case``); returns the kernels'
    records, one a case, the codes' kernel's with ``launches``, its
    launches in the generic fits, the planes' kernel's with
    ``plane_launches``, its launches in the biobank fits (one a window of
    each start)."""
    from multiclust_tpu_torch.init import random as rinit

    t0 = time.time()
    I, L, P = COUNT_SHAPE
    gen = torch.Generator(device=dev).manual_seed(24)
    records = []
    for K, M in COUNT_CASES:
        panel = torch.randint(0, M, (I, L + 64, P), generator=gen,
                              device=dev, dtype=torch.int8)
        gone = torch.rand((I, L + 64), generator=gen, device=dev) < 0.002
        panel[gone] = -1                            # whole genotypes
        codes = panel[:, 32:32 + L]
        labels = torch.randint(0, K, (I, L, P), generator=gen, device=dev)
        before = build.LAUNCHES["mc_allele_counts"]
        got = rinit.allele_partition_counts(labels, codes, M, K,
                                            torch.float32)
        want = rinit.allele_partition_counts_reference(labels, codes, M, K,
                                                       torch.float32)
        torch.cuda.synchronize()
        assert build.LAUNCHES["mc_allele_counts"] == before + 1
        assert all(torch.equal(g, w) for g, w in zip(got, want)), (K, M)
        ms = median_ms(lambda: rinit.allele_partition_counts(
            labels, codes, M, K, torch.float32))
        plain_ms = median_ms(lambda: rinit.allele_partition_counts_reference(
            labels, codes, M, K, torch.float32), n=5, warm=1)
        bnd = bound(tensors_bytes(labels, codes) + 4 * (I * K + K * L * M),
                    0)
        print(f"allele counts {I} x {L} x {P}, K={K}, M={M}: kernel "
              f"{ms:.3f} ms against {bnd[0]:.3f} ms ({bnd[1]}): "
              f"{100 * bnd[0] / ms:.1f} %; plain {plain_ms:.3f} ms; exact; "
              f"on {where}", flush=True)
        records.append(kernel_record(
            f"allele_counts K={K} M={M}",
            "multiclust_tpu_torch/csrc/allele_counts.cu",
            "none (the JAX package counts with XLA one-hot sums, "
            "multiclust_tpu/init/random.py:148-158)",
            launches, 0.0, (ms, plain_ms), bnd))
        del panel, codes, labels, got, want
        torch.cuda.empty_cache()
    for I, L, K in PLANE_CASES:
        records.append(plane_counts_case(build, dev, where, gen, I, L, K,
                                         plane_launches))
    print(f"allele counts phase: {time.time() - t0:.1f} s", flush=True)
    return records


def plane_counts_case(build, dev, where, gen, I, L, K, launches):
    """``allele_partition_counts_planes`` at one window of I x L genotypes
    cut from wider planes (at a column offset and a row block), against
    the codes' kernel on the codes ``codes_from_counts`` gives and against
    the plain version, exact; both kernels timed.  Its record, with the
    planes' kernel's launches in the biobank fits."""
    from multiclust_tpu_torch.init import random as rinit

    P = 2
    wide = (I + 8, L + 64)
    miss = (torch.rand(wide, generator=gen, device=dev) < 0.002).to(
        torch.int8) * 2                              # whole genotypes
    x0 = (torch.rand(wide, generator=gen, device=dev) < 0.5).to(torch.int8)
    x0 += (torch.rand(wide, generator=gen, device=dev) < 0.5).to(torch.int8)
    x0 = torch.where(miss > 0, torch.zeros_like(x0), x0)
    cut = (slice(4, 4 + I), slice(32, 32 + L))
    x0w, missw = x0[cut], miss[cut]
    codes = rinit.codes_from_counts(
        torch.stack([x0w, P - missw - x0w], dim=2), missw, P)
    labels = torch.randint(0, K, (I, L, P), generator=gen, device=dev)
    before = build.LAUNCHES["mc_allele_counts_planes"]
    got = rinit.allele_partition_counts_planes(labels, x0w, missw, K,
                                               torch.float32)
    by_codes = rinit.allele_partition_counts(labels, codes, 2, K,
                                             torch.float32)
    torch.cuda.synchronize()
    assert build.LAUNCHES["mc_allele_counts_planes"] == before + 1
    assert all(torch.equal(g, w) for g, w in zip(got, by_codes)), (I, L, K)
    want = rinit.allele_partition_counts_reference(labels, codes, 2, K,
                                                   torch.float32)
    assert all(torch.equal(g, w) for g, w in zip(got, want)), (I, L, K)
    ms = median_ms(lambda: rinit.allele_partition_counts_planes(
        labels, x0w, missw, K, torch.float32))
    codes_ms = median_ms(lambda: rinit.allele_partition_counts(
        labels, codes, 2, K, torch.float32))
    plain_ms = median_ms(lambda: rinit.allele_partition_counts_reference(
        labels, codes, 2, K, torch.float32), n=3, warm=1)
    bnd = bound(tensors_bytes(labels) + 2 * I * L + 4 * (I * K + K * L * 2),
                0)
    print(f"allele counts from the planes {I} x {L} x {P}, K={K}: kernel "
          f"{ms:.3f} ms against {bnd[0]:.3f} ms ({bnd[1]}): "
          f"{100 * bnd[0] / ms:.1f} %; the codes' kernel {codes_ms:.3f} ms; "
          f"plain {plain_ms:.3f} ms; exact; on {where}", flush=True)
    rec = kernel_record(
        f"allele_counts_planes {I}x{L} K={K}",
        "multiclust_tpu_torch/csrc/allele_counts.cu",
        "none (the JAX package counts with XLA one-hot sums, "
        "multiclust_tpu/init/random.py:148-158)",
        launches, 0.0, (ms, plain_ms), bnd)
    rec["codes_kernel_ms"] = codes_ms
    del x0, miss, codes, labels, got, by_codes, want
    torch.cuda.empty_cache()
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from multiclust_tpu_torch.ops import build, fullstep as fs, \
        fullstep_bi as fb, mixture_bi as mb

    dev = torch.device("cuda")
    where = card()
    print(where, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)

    lib = build.library_path()
    if lib.exists():
        lib.unlink()   # prove the sources in this checkout build
    t0 = time.time()
    build.library()
    print(f"build: {time.time() - t0:.1f} s ({lib.name})", flush=True)

    errs, ms, bnd = phase_kernels(fb, dev, where)
    routed_errs = phase_routed_kernels(fb, dev, where)
    # the pair's launches are those of the 32-chain fit alone
    launches = phase_fit(build, dev, where)
    phase_reference(build, dev)
    phase_cli(build, where)
    g_errs, g_ms, (sweep_err, sweep_ms, sweep_launches), g_bnd = \
        phase_generic_kernels(fs, build, dev, where)
    phase_generic_shapes(fs, build, dev, where)
    launches.update(phase_fit_generic(build, dev, where))
    phase_reference_generic(dev)
    phase_cli_generic(build, where)
    m_errs, m_ms, m_bnd, m_lib, m_sweep_launches = phase_mixture_kernels(
        mb, build, dev, where)
    mix_launches = phase_fit_mixture(build, dev, where)
    phase_reference_mixture(build, dev)
    phase_fit_mixture_generic(build, dev, where)
    phase_cli_mixture(build, where)

    b_errs, b_ms, b_bnd = phase_biobank_kernels(fb, dev, where)
    for key, err in routed_errs.items():
        b_errs[key] = max(b_errs[key], err)
    phase_redesign_shapes(fb, build, dev, where)
    for label, key, t, b in (
            ("fused rows pass 16384 x 2048, 2 chains", ("rows", 2), ms, bnd),
            ("columns pass 16384 x 2048, 2 chains", ("cols", 2), ms, bnd),
            (f"fused rows pass 16384 x 2048, {PAIR_CHAINS} chains",
             ("rows", PAIR_CHAINS), ms, bnd),
            (f"columns pass 16384 x 2048, {PAIR_CHAINS} chains",
             ("cols", PAIR_CHAINS), ms, bnd),
            ("segmented rows pass 8192 x 131072, 2 chains", "rows_seg", b_ms,
             b_bnd),
            ("windowed columns pass 8192 x 131072, 2 chains", "cols_window",
             b_ms, b_bnd),
            ("generic rows pass 16384 x 2048 x M=4, 2 chains", "rows", g_ms,
             g_bnd),
            ("generic columns pass 16384 x 2048 x M=4, 2 chains", "cols",
             g_ms, g_bnd),
            ("mixture rows pass 16384 x 2048, 2 chains", "rows", m_ms,
             m_bnd),
            ("mixture columns pass 16384 x 2048, 2 chains", "cols", m_ms,
             m_bnd)):
        print(f"share of bound, {label}: {t[key][0]:.3f} ms "
              f"against {b[key][0]:.3f} ms ({b[key][1]}): "
              f"{100 * b[key][0] / t[key][0]:.1f} % on {where}", flush=True)
    bio_launches = phase_biobank_fits(build, dev, where)
    phase_biobank_reference(build, dev)
    for name, err in phase_biobank_mixture_kernels(mb, dev, where).items():
        m_errs[name] = max(m_errs[name], err)
    phase_biobank_mixture(build, dev, where)
    with tempfile.TemporaryDirectory() as tmp:
        cli_path = phase_cli_biobank(build, where, tmp)
        t0 = time.time()
        phase_bootstrap(build, dev, where, cli_path)
        print(f"bootstrap phase: {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    phase_jagged(build, dev, where)
    print(f"jagged phase: {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    torch.cuda.empty_cache()   # the children share this card
    phase_nccl_world_one(where)
    with tempfile.TemporaryDirectory() as tmp:
        mesh_results = phase_mesh(build, dev, where, tmp)
    check_mesh_launches(mesh_results)
    print(f"mesh phase: {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        ingest_results = phase_ingest(where, tmp)
    print(f"ingest phase: {time.time() - t0:.1f} s", flush=True)
    wide_records, wide_mesh = phase_wide(fb, fs, build, dev, where)
    wide_mix_records = phase_wide_mixture(mb, build, dev, where)
    masked_records = phase_sweep(fb, fs, mb, build, dev, where)
    count_records = phase_allele_counts(
        build, dev, where, launches["mc_allele_counts"],
        bio_launches["mc_allele_counts_planes"])

    # the pair: its launches in the 32-chain fit, its times at that batch
    kernels = [
        kernel_record(f"fullstep_bi_{name}", SOURCE, TPU_KERNEL,
                      launches[f"mc_fullstep_bi_{name}"], errs[name],
                      ms[name, PAIR_CHAINS], bnd[name, PAIR_CHAINS])
        for name in ("rows", "cols")]
    # a launch of the generic rows pass is two kernels, the pass and its
    # finish (tiles.cuh's rows_finish_kernel), counted once and timed
    # together: the record's name says so
    kernels += [
        kernel_record(record, GENERIC_SOURCE, GENERIC_TPU,
                      launches[f"mc_fullstep_{name}"], g_errs[name],
                      g_ms[name], g_bnd[name])
        for name, record in (("rows", "fullstep_rows+rows_finish"),
                             ("cols", "fullstep_cols"), ("p", "fullstep_p"))]
    # the sweeps' port is the generic rows, columns and p kernels with
    # finish=False; of the fits only a meshed one with the loci split calls
    # it (the mesh entry below): its launches here are those of one
    # admixture_sweep_stats call counted on their own, its times and error
    # those of such a call
    kernels += [
        kernel_record(name, GENERIC_SOURCE, tpu, sweep_launches, sweep_err,
                      sweep_ms, g_bnd["sweep"])
        for name, tpu in SWEEP_TPU.items()]
    # the finish's record: the model's layout, as the fits run it; its
    # bound from the live lanes, every tensor's beside it
    kernels += [
        kernel_record(f"mixture_{name}", MIX_SOURCE, MIX_TPU,
                      mix_launches[f"mc_mix_{name}"], m_errs[name],
                      m_ms[name], m_bnd[name], m_lib.get(name))
        for name in ("rows", "cols", "finish")]
    # the resident sweep's port is the mixture rows and columns passes
    # with the raw epilogue (finish=False); no fit calls it: its launches
    # are those of one mixture_sweep_stats call counted on their own, its
    # times and error those of such calls
    kernels.append(
        kernel_record("mixture_sweep_resident", MIX_SOURCE, MIX_SWEEP_TPU,
                      m_sweep_launches, m_errs["sweep"], m_ms["sweep"],
                      m_bnd["sweep"]))
    # the streamed step's kernels (the segmented rows pass, its finish, the
    # windowed columns pass with its epilogue) and the chunked loop of
    # them, with their launches in the biobank fits
    kernels += [
        kernel_record(f"fullstep_bi_{name}", SOURCE, STREAM_TPU,
                      bio_launches[launcher], b_errs[name], b_ms[name],
                      b_bnd[name])
        for name, launcher in (("rows_seg", "mc_fullstep_bi_rows_seg"),
                               ("cols_window", "mc_fullstep_bi_cols"))]
    # the two segment reductions, each with the TPU pass step it replaces
    kernels += [
        kernel_record(f"fullstep_bi_{name}", SOURCE, tpu,
                      bio_launches[launcher], b_errs[name], b_ms[name],
                      b_bnd[name])
        for name, launcher, tpu in (
            ("finish", "mc_fullstep_bi_finish", FINISH_TPU),
            # the columns launcher runs the epilogue once a call
            ("p0_epilogue", "mc_fullstep_bi_cols", P0_TPU))]
    kernels.append(
        kernel_record("fullstep_bi_chunked", SOURCE, CHUNK_TPU,
                      bio_launches["fullstep_bi_chunked"], b_errs["chunked"],
                      b_ms["chunked"], b_bnd["chunked"]))
    # the wide kernels (128 < Kp <= 1024), with their launches in the K =
    # 200 main-path fits and their times at 224 lanes (1024 beside them)
    kernels += wide_records
    # the mixture's wide kernels, with their launches in the K = 200
    # missing-free fits and their times at 224 lanes (1024 beside them)
    kernels += wide_mix_records
    # the masked kernels (a per-chain kmask), with their launches in the
    # mixed-K sweeps and their times on mixed-K batches at those shapes
    kernels += masked_records
    # the admixture start's counts: the codes' kernel with its launches in
    # the generic fits, the planes' kernel with its in the biobank fits
    kernels += count_records
    mesh_entry = mesh_record(mesh_results)
    mesh_entry.update(ingest_record(ingest_results))
    mesh_entry.update(wide_mesh)
    record = {"kernels": kernels, "mesh": mesh_entry}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-child"]:
        raise SystemExit(mesh_child(sys.argv[2], int(sys.argv[3]),
                                    int(sys.argv[4]), sys.argv[5]))
    if sys.argv[1:2] == ["--wide-mesh-child"]:
        raise SystemExit(wide_mesh_child(sys.argv[2], int(sys.argv[3]),
                                         int(sys.argv[4]), sys.argv[5]))
    if sys.argv[1:2] == ["--ingest-child"]:
        raise SystemExit(ingest_child(sys.argv[2], int(sys.argv[3]),
                                      int(sys.argv[4]), sys.argv[5]))
    raise SystemExit(main())
