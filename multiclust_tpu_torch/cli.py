"""Command-line interface of the port, flag-compatible with the reference
binary and with the JAX CLI (multiclust_tpu/cli.py, single-process path).

Parser semantics follow parse_options (multiclust.c:1396-1735): single-pass
switch on the first non-dash character with multi-character disambiguation
(e.g. -b vs --bound by prefix "bou").  See fprint_usage
(multiclust.c:1744-1891) for the documented surface.

Run as ``python -m multiclust_tpu_torch.cli <reference flags>``.
``--platform cpu`` fits on the CPU in float64, as the JAX CLI does, and the
default fits on CUDA.  Flags outside the ported slice raise a usage error
that names the ROADMAP.md item.
"""

from __future__ import annotations

import sys
import time
from typing import List, Optional

import numpy as np
import torch

from multiclust_tpu_torch.config import AccelScheme, InitProcedure, \
    Options, OutputFormat


class UsageError(SystemExit):
    def __init__(self, msg: str):
        super().__init__(f"multiclust-tpu: {msg}\nTry '-h' for help.")


def _need(argv, i, flag):
    if i >= len(argv):
        raise UsageError(f"option '{flag}' requires an argument")
    return argv[i]


def parse_args(argv: List[str]) -> Options:
    opt = Options()
    i = 0
    while i < len(argv):
        arg = argv[i]
        if len(arg) < 2 or arg[0] != "-":
            raise UsageError(f"unrecognized argument '{arg}'")
        name = arg.lstrip("-")
        if not name:
            raise UsageError(f"unrecognized argument '{arg}'")
        a = name[0]
        i += 1
        if a == "a":
            opt.admixture = True
        elif a == "A":
            opt.afile = _need(argv, i, arg); i += 1
        elif a == "b":
            if name.startswith("bou"):
                opt.lower_bound = float(_need(argv, i, arg)); i += 1
                if opt.lower_bound < 0:
                    raise UsageError("--bound must be >= 0")
            else:
                opt.n_bootstrap = int(_need(argv, i, arg)); i += 1
                if opt.n_bootstrap < 0:
                    raise UsageError("-b must be >= 0")
        elif a == "B":
            pass  # debug-only simplified loop in the reference (-B)
        elif a == "c":
            if name.startswith("check-") or name.startswith("checki"):
                # --check-interval N (extension): evaluate convergence
                # only every N-th plain-EM iteration (config.Options)
                opt.check_interval = int(_need(argv, i, arg)); i += 1
                if opt.check_interval < 0:
                    raise UsageError("--check-interval must be >= 0")
            elif name.startswith("com"):
                # --compile-cache <dir|off> (extension)
                opt.compile_cache = _need(argv, i, arg); i += 1
            elif name.startswith("ch"):
                opt.checkpoint_dir = _need(argv, i, arg); i += 1
            else:
                opt.eta_constrained = True
        elif a == "d":
            opt.path = _need(argv, i, arg); i += 1
        elif a == "e":
            opt.rel_error = float(_need(argv, i, arg)); i += 1
        elif a == "E":
            opt.abs_error = float(_need(argv, i, arg)); i += 1
        elif a == "f":
            if name.startswith("fo"):
                fmt = _need(argv, i, arg); i += 1
                if fmt == "ped":
                    opt.output_format = OutputFormat.PED
                elif fmt == "stru":
                    opt.output_format = OutputFormat.STRUCTURE
                else:
                    raise UsageError(f"unknown output format '{fmt}'")
            else:
                opt.filename = _need(argv, i, arg); i += 1
        elif a == "g":
            opt.adjust_step = int(_need(argv, i, arg)); i += 1
        elif a == "h":
            print_usage()
            raise SystemExit(0)
        elif a == "i":
            if name.startswith("im"):
                opt.imputation_method = 1
                if i < len(argv) and not argv[i].startswith("-"):
                    opt.imputed_outfile = argv[i]; i += 1
            else:
                opt.n_init_iter = int(_need(argv, i, arg)); i += 1
        elif a == "I":
            if name == "I1":
                opt.one_plus = True
            opt.alleles_are_indices = True
        elif a == "1":
            opt.min_K = int(_need(argv, i, arg)); i += 1
        elif a == "2":
            opt.max_K = int(_need(argv, i, arg)); i += 1
        elif a == "k":
            opt.max_K = int(_need(argv, i, arg)); i += 1
            opt.min_K = opt.max_K
        elif a == "m":
            if name.startswith("mi"):
                opt.missing_value = int(_need(argv, i, arg)); i += 1
            elif name.startswith("me"):
                # --mesh DxM: (data_shards, loci_shards) device mesh for
                # the production fit path; "auto" = all devices on data
                spec = _need(argv, i, arg); i += 1
                if spec == "auto":
                    opt.mesh_shape = (-1, 1)  # resolved at run time
                else:
                    try:
                        d, m_ = spec.lower().split("x")
                        opt.mesh_shape = (int(d), int(m_))
                    except ValueError:
                        raise UsageError(
                            f"--mesh wants DxM or 'auto', got '{spec}'")
            else:
                opt.n_rand_em_init = int(_need(argv, i, arg)); i += 1
                if opt.n_rand_em_init == 0:
                    opt.initialization_procedure = InitProcedure.NOTHING
                else:
                    opt.initialization_procedure = InitProcedure.RAND_EM
        elif a == "M":
            opt.parallel = True
            opt.n_repeat = 1
            opt.verbosity = 1  # SILENT
        elif a == "n":
            opt.n_init = int(_need(argv, i, arg)); i += 1
            if opt.n_init == 0:
                opt.n_repeat = 0
        elif a == "o":
            opt.outfile_name = _need(argv, i, arg); i += 1
        elif a == "p":
            if name.startswith("pr"):
                opt.do_projection = False
            elif name.startswith("pl"):
                opt.write_plus_one = True
            else:
                opt.ploidy = int(_need(argv, i, arg)); i += 1
                if opt.ploidy < 1:
                    raise UsageError("-p must be >= 1")
        elif a == "P":
            opt.pfile = _need(argv, i, arg); i += 1
        elif a == "Q":
            opt.qfile = _need(argv, i, arg); i += 1
        elif a == "R":
            opt.R_format = True
        elif a == "r":
            opt.seed = int(_need(argv, i, arg)); i += 1
        elif a == "x":
            # block relaxation: parsed but never implemented in the
            # reference ("[KSD TODO: no block relax implemented]",
            # em_alg.c:80); accepted and ignored for compatibility
            pass
        elif a == "s":
            if name.startswith("si"):
                opt.simulate = True
                opt.admix_qfile = _need(argv, i, arg); i += 1
                opt.admix_pfile = _need(argv, i, arg); i += 1
                if i < len(argv) and not argv[i].startswith("-"):
                    opt.simulate_outfile = argv[i]; i += 1
            else:
                s = int(_need(argv, i, arg)); i += 1
                if s < 0:
                    raise UsageError("-s must be >= 0")
                opt.accel_scheme = AccelScheme(min(s, 4)) \
                    if s <= 4 else AccelScheme.QN
                if s >= 4:
                    opt.accel_scheme = s  # resolved in synchronize()
        elif a == "t":
            opt.n_seconds = 60 * int(_need(argv, i, arg)); i += 1
        elif a == "T" or (a == "C" and len(name) == 1):
            opt.max_iter = int(_need(argv, i, arg)); i += 1
        elif a == "u":
            while i < len(argv) and not argv[i].startswith("-"):
                sub = argv[i]; i += 1
                if sub == "l":
                    opt.target_ll = True
                    opt.desired_ll = float(_need(argv, i, arg)); i += 1
                elif sub == "n":
                    opt.target_revisit = int(_need(argv, i, arg)); i += 1
                else:
                    raise UsageError(f"unknown -u selector '{sub}'")
        elif a == "v":
            if i < len(argv):
                try:
                    opt.verbosity = int(argv[i]); i += 1
                except ValueError:
                    opt.verbosity = 6  # VERBOSE
            else:
                opt.verbosity = 6
        elif a == "w":
            while i < len(argv) and not argv[i].startswith("-"):
                sub = argv[i]; i += 1
                if sub == "t":
                    opt.repeat_seconds = 60 * int(_need(argv, i, arg))
                    i += 1
                elif sub == "m":
                    opt.max_repeat_seconds = 60 * int(_need(argv, i, arg))
                    i += 1
                elif sub == "n":
                    opt.n_repeat = int(_need(argv, i, arg)); i += 1
                    if opt.n_repeat <= 0:
                        raise UsageError("-w n must be > 0")
                else:
                    raise UsageError(f"unknown -w selector '{sub}'")
            opt.write_files = False
        else:
            raise UsageError(f"unknown option '{arg}'")

    if opt.filename is None and not opt.simulate:
        raise UsageError(
            "You must specify the data file with command line option '-f'.")
    return opt


def print_usage():
    """Full usage text (fprint_usage, multiclust.c:1744-1891), with the
    same option documentation plus the additions without a reference
    counterpart."""
    opt = Options()
    print(f"""
NAME
\tmulticlust-tpu - Maximum likelihood clustering of discrete data
\t(PyTorch/CUDA port of the multiclust reimplementation)

SYNOPSIS
\tpython -m multiclust_tpu_torch.cli [-k <n> | -1 <n> -2 <n>] [-a -b <n>
\t\t--bound <d> -c -C <n> -d <s> -e <d> -E <d> -g <n> -h -i <n> -I
\t\t-m <n> --missing <n> -M -n <n> -o <s> -p <n> --projection --plus
\t\t-Q <s> -P <s> -A <s> -r <n> -R -s <n> -t <n> -T <n> -u <s> -v [n]
\t\t-w <s> -x --impute [<s>] --mesh <s> --checkpoint <s>
\t\t--check-interval <n> --platform <s>] -f <s> [--format <s>]
\tpython -m multiclust_tpu_torch.cli --simulate <qfile> <pfile> [<ofile>]

\twhere <n> stands for integer, <s> for string, <d> for double

DESCRIPTION
\tmulticlust-tpu clusters multivariate discrete data observed on a
\tsample of individuals using the EM algorithm.  It handles data
\tmissing at random and assumes coordinates within an individual are
\tindependent.  It allows the admixture model, where each coordinate
\tis independently drawn from a cluster, or the mixture model, where
\teach individual is drawn from a cluster.  Fits run as batched
\tEM chains on one CUDA device.

OPTIONS
\t-a\tChoose admixture model (default: no).
\t-b, --bootstrap
\t\tBootstrap test of H0: K=<k>-1 vs. Ha: K=<k>, where <k> is
\t\tgiven by -k.  Argument = number of bootstraps (default: {opt.n_bootstrap}).
\t--bound\tLower bound for allele and mixing/admixing proportions
\t\t(default: {opt.lower_bound:e}).
\t-B\tDEBUG ONLY: accepted for compatibility; ignored.
\t-c\tConstrain mixing proportions identical across individuals
\t\t(only enforced with -a; default: no).
\t-C, -T\tThe maximum number of iterations to fit (default: {opt.max_iter}).
\t-d\tDirectory where output files are written (default: {opt.path}).
\t-e\tAllowable log likelihood relative error for convergence
\t\t(default: {opt.rel_error:.1e}).
\t-E\tAllowable log likelihood absolute error for convergence
\t\t(default: {opt.abs_error:.1e}).
\t-f\tName of data file (STRUCTURE format).
\t--format
\t\tFormat of data output file (default: stru).
\t\t\tstru\tSTRUCTURE format, the default.
\t\t\tped\tPlink's ped format.
\t-g\tAdjust step size at most this many times (default: {opt.adjust_step}).
\t-h\tThis help.
\t-i\tInitial iterations prior to acceleration (default: {opt.n_init_iter}).
\t--impute [<file>]
\t\tImpute missing alleles by locus mode; optionally write the
\t\timputed dataset to <file>.
\t-I\tAlleles are indices (no sorting, etc.) (default: no).
\t-I1\tAlleles are indices plus 1 (default: no).
\t-k\tThe number of clusters to fit (default: {opt.max_K}).
\t-1\tThe minimum number of clusters to fit (default: {opt.min_K}).
\t-2\tThe maximum number of clusters to fit (default: {opt.max_K}).
\t-m\tThe number of Rand EM initializations, 0 to avoid Rand EM
\t\t(default: {opt.n_rand_em_init}).
\t--missing
\t\tInteger value that indicates missing (default: -9).
\t-M\tParallel scripting mode: print only max log likelihood on
\t\tstdout (default: off).  
\t-n\tNumber of initializations to run EM to convergence
\t\t(default: {opt.n_init}).
\t-o\tOption to create unique output file name.
\t-p\tThe ploidy (default: {opt.ploidy}).
\t--projection
\t\tTurn off simplex projection (default: on).
\t--plus\tPlus one to alleles when writing data (default: off).
\t-Q, -P\tWarm-start files: -Q mixing proportions (I*K values for
\t\tunconstrained admixture, K otherwise), -P biallelic allele
\t\tfrequencies (L rows of K values).  Unlike the reference,
\t\tthese warm-start the mixture model too.
\t-A\tTrue-partition file; report the adjusted Rand index.
\t-r\tRandom number seed (default: {opt.seed}).
\t-R\tData file in R format (default: no).
\t-s\tThe acceleration scheme (default: 0).
\t\t\t0 (default) - no acceleration
\t\t\t1 - SQUAREM version 1
\t\t\t2 - SQUAREM version 2
\t\t\t3 - SQUAREM version 3
\t\t\t4 - Quasi Newton version 1 (1 secant condition)
\t\t\t5 - Quasi Newton version 2 (2 secant conditions)
\t\t\t6 - Quasi Newton version 3 (3 secant conditions)
\t--simulate <qfile> <pfile> [<ofile>]
\t\tSimulate data from admixture <qfile>, <pfile>, and write
\t\tdata to <ofile>.
\t-u\tIterate until beat target:
\t\t-u n #: repeat until reach same max # times (default: {opt.target_revisit})
\t\t-u l #: repeat until reach max log likelihood # (default: {opt.desired_ll:f})
\t-t\tThe time (in minutes) to maximize likelihood (default: 0).
\t\tBe sure to check convergence if you set the above!
\t-v\tLevel of verbosity (default: {opt.verbosity}).
\t\t0 silence, 1 silent, 2 quiet, 3 minimal (per-init progress),
\t\t4+ per-iteration traces.
\t-w\tRepeat-timing harness (disables file output):
\t\t-w n <n>: repeat at least <n> times (default: {opt.n_repeat})
\t\t-w t <n>: repeat at least <n> minutes (default: 0)
\t\t-w m <n>: repeat at most <n> minutes (default: 0)
\t-x\tBlock relaxation: accepted for compatibility; never
\t\timplemented in the reference (em_alg.c:80) and ignored here.

OPTIONS WITHOUT A REFERENCE COUNTERPART
\t--mesh <DxM|auto>
\t\tProcess mesh for multi-device fits: D data (individual) shards
\t\tx M loci shards, one process per device; 'auto' puts every
\t\tprocess on the data axis.  Each process is started with
\t\tMULTICLUST_COORDINATOR=<host:port of process 0>,
\t\tMULTICLUST_NUM_PROCESSES=<D*M> and MULTICLUST_PROCESS_ID=<rank>
\t\t(NCCL on cuda, gloo on cpu).  Each process reads and uploads
\t\tonly its block of the file and writes the per-individual
\t\ttables of its row block as <file>.part<d>; process 0 writes
\t\tthe other output files.
\t--checkpoint <dir>
\t\tPersist/resume the multi-start sweep state and the bootstrap
\t\t(multi-process runs: the bootstrap's only, with -b).
\t--compile-cache <dir|off>
\t\tAccepted for compatibility with the JAX CLI and unused.
\t--check-interval <n>
\t\tEvaluate convergence only every n-th plain-EM iteration; the
\t\titerations in between skip the log-likelihood entirely (faster
\t\tat small K).  Never stops prematurely (EM is monotone); the
\t\titeration cap gains granularity n.  0 (default) adapts the
\t\tinterval from the measured logL deltas (1..16); 1 restores
\t\treference per-iteration semantics.  Forced to 1 under -s and
\t\tat verbosity > 3.
\t--platform <cpu|cuda>
\t\tThe fit device (default cuda; cpu implies float64 semantics).
""")



# ---------------------------------------------------------------------------

def main(argv: Optional[List[str]] = None) -> int:
    """CLI entry: errors are reported through the message() taxonomy, the
    error code becoming the exit status (main, multiclust.c:157-164)."""
    from multiclust_tpu_torch.messages import Err, MsgType, \
        MulticlustError, message
    try:
        return _main(argv)
    except MulticlustError as e:
        return message(sys.stderr, MsgType.ERROR, e.err, e.text)
    except FileNotFoundError as e:
        return message(sys.stderr, MsgType.ERROR, Err.FILE_OPEN_ERROR,
                       e.filename or str(e))


def _main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    platform = "cuda"
    if "--platform" in argv:
        i = argv.index("--platform")
        if i + 1 >= len(argv):
            raise UsageError("option '--platform' requires an argument")
        platform = argv[i + 1]
        del argv[i:i + 2]
    if platform not in ("cpu", "cuda", "gpu"):
        raise UsageError(f"--platform wants cpu or cuda, got '{platform}'")

    opt = parse_args(argv)
    if opt.simulate:
        return _run_simulate(opt)

    if platform == "cpu":
        opt.dtype = "float64"  # reference-precision semantics on CPU
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda")
    else:
        raise UsageError("no CUDA device is available; run with "
                         "--platform cpu")

    # multi-process bring-up from MULTICLUST_COORDINATOR /
    # MULTICLUST_NUM_PROCESSES / MULTICLUST_PROCESS_ID (a no-op for one
    # process): NCCL on cuda, gloo on cpu; one process per device
    from multiclust_tpu_torch.api import check_ported
    from multiclust_tpu_torch.runtime import mesh as mesh_mod
    from multiclust_tpu_torch.runtime.multistart import mesh_shape_of
    device = mesh_mod.initialize_distributed(device=device) or device
    n_proc = mesh_mod.world_size()
    shape = mesh_shape_of(opt)
    if shape is None and n_proc > 1:
        raise UsageError("multi-process runs require --mesh")
    if shape is not None and shape[0] * shape[1] != n_proc:
        raise UsageError(f"mesh shape {shape[0]}x{shape[1]} does not cover "
                         f"{n_proc} process(es): a mesh runs one process "
                         f"per device (MULTICLUST_NUM_PROCESSES)")
    opt.mesh_shape = shape
    try:
        check_ported(opt)
    except NotImplementedError as e:
        raise UsageError(str(e))
    if n_proc > 1:
        return main_meshed(opt, device)

    from multiclust_tpu_torch.io.structure import read_structure
    from multiclust_tpu_torch.io.warm_start import read_afile, read_pfile, \
        read_qfile
    from multiclust_tpu_torch.model.common import Params, \
        model_data_from_dataset
    from multiclust_tpu_torch.runtime.ksweep import estimate_model
    from multiclust_tpu_torch.runtime.multistart import device_policy

    ds = read_structure(opt.filename, opt)
    if opt.imputation_method and opt.imputed_outfile:
        # write the imputed dataset (read_file, read_file.c:295-296)
        from multiclust_tpu_torch.io.writers import write_data
        write_data(opt, ds, opt.imputed_outfile)
    opt = opt.synchronize(ds.I, ds.ploidy)
    dtype = getattr(torch, opt.dtype)
    _, storage = device_policy(opt, device)
    md = model_data_from_dataset(ds, dtype=dtype, device=device,
                                 storage_dtype=storage)

    warm = None
    if opt.qfile and opt.pfile:
        # per-individual eta for unconstrained admixture, a K-vector for
        # the mixture and constrained eta (initialize_model,
        # rnd_init.c:74-76)
        per_individual = opt.admixture and not opt.eta_constrained
        eta = read_qfile(opt.qfile, ds.I, opt.max_K,
                         per_individual=per_individual)
        p = read_pfile(opt.pfile, ds.L, opt.max_K)
        if ds.M != p.shape[-1]:
            # the reference's read_pfile assumes biallelic loci
            # (read_file.c:937); reject instead (PARITY.md)
            raise UsageError(
                f"-P warm start assumes biallelic data; dataset has up to "
                f"{ds.M} alleles per locus")
        warm = Params(eta=torch.as_tensor(eta, dtype=dtype, device=device),
                      p=torch.as_tensor(p, dtype=dtype, device=device))

    truth = None
    if opt.afile:
        truth, _ = read_afile(opt.afile, ds.I)

    def n_parameters(K):
        return ds.n_parameters(K, opt.admixture, opt.eta_constrained)

    t_start = time.time()

    if opt.n_repeat != 1:
        from multiclust_tpu_torch.runtime.timing import timed_model_estimation
        timed_model_estimation(opt.seed, md, opt, n_parameters, warm=warm,
                               true_partition=truth)
        return 0

    def on_model_improve(K, mres):
        # best-so-far persistence: rewrite the per-K files whenever an
        # init improves the best logL (multiclust.c:584-600)
        if opt.write_files and mres.best_params is not None:
            _write_outputs(opt, ds, md, K, mres)

    def on_model_done(K, mres):
        if opt.write_files and mres.best_params is not None:
            _write_outputs(opt, ds, md, K, mres)
        _report_model(opt, K, mres, t_start)

    est = estimate_model(opt.seed, md, opt, n_parameters, warm=warm,
                         true_partition=truth,
                         on_model_done=on_model_done,
                         on_improve=on_model_improve,
                         checkpoint_dir=opt.checkpoint_dir)
    _finish(opt, md, est, n_parameters)
    return 0


def _report_model(opt: Options, K: int, mres, t_start: float) -> None:
    """The lines printed when K is done: how the step ran, and the model
    state."""
    if opt.verbosity > 2 and mres.route:
        # how the biallelic admixture step ran on the card
        print(f"K = {K}: step route {mres.route}, "
              f"{mres.batch_chains} chains in lockstep")
    if opt.verbosity > 2 and mres.buckets:
        # the jagged panel's bucketing plan (model/bucketed.py)
        print(f"K = {K}: jagged loci bucketed: {mres.buckets}")
    if opt.verbosity:
        print_model_state(opt, None, mres, time.time() - t_start)


def _finish(opt: Options, md, est, n_parameters) -> None:
    """After the K-sweep: -M's line, and the bootstrap test under -b."""
    if opt.parallel:
        # -M: stdout carries only the max log likelihood
        print(f"{est.last.max_logL:f}")
    if not opt.n_bootstrap:
        return
    from multiclust_tpu_torch.stats.bootstrap import run_bootstrap

    def log(rep, ts, ntime):
        print(f"Bootstrap dataset {rep + 1} (of {opt.n_bootstrap}): "
              f"test statistics bs={ts:f} obs={est.ts:f} "
              f"({ntime / (rep + 1):f})")

    bres = run_bootstrap(opt.seed, md, opt, n_parameters, est.ts,
                         est.h0_params, opt.ploidy, log=log,
                         checkpoint_dir=opt.checkpoint_dir)
    print(f"p-value to reject H0: K={bres.null_K} is {bres.pvalue:f}")


def main_meshed(opt: Options, device: torch.device) -> int:
    """The CLI's multi-process run (multiclust_tpu/cli.py:457-573), in a
    process group that ``runtime/mesh.initialize_distributed`` joined:
    every rank reads and uploads its block of the panel
    (runtime/ingest.py), draws its starts and replicates on that block,
    and writes the per-individual tables of its row block as ``.part<d>``
    files; rank 0 writes the replicated ones.  The K-sweep
    runs without a checkpoint (``api.check_ported`` refuses one without
    -b); the bootstrap checkpoints through rank 0.  A group of one process
    runs it as a 1 x 1 mesh."""
    from multiclust_tpu_torch.io.warm_start import read_afile
    from multiclust_tpu_torch.runtime import ingest
    from multiclust_tpu_torch.runtime import mesh as mesh_mod
    from multiclust_tpu_torch.runtime.ksweep import estimate_model
    from multiclust_tpu_torch.runtime.multistart import device_policy, \
        mesh_shape_of

    mesh = mesh_mod.cached_mesh(mesh_shape_of(opt) or (1, 1))
    dtype = getattr(torch, opt.dtype)
    _, storage = device_policy(opt, device)
    md, info = ingest.load_structure_distributed(
        opt.filename, opt, mesh, dtype=dtype, storage_dtype=storage,
        device=device)
    if opt.imputation_method and opt.imputed_outfile:
        ingest.write_data_distributed(opt, info, opt.imputed_outfile)
    I_total = info.I_total
    opt = opt.synchronize(I_total, opt.ploidy)
    warm = None
    if opt.qfile and opt.pfile:
        warm = ingest.warm_start_distributed(opt, info, dtype, device)
    # the whole true partition on every rank (O(I) ints); each scores its
    # rows (runtime/ingest.score_arand_distributed)
    truth = read_afile(opt.afile, I_total)[0] if opt.afile else None
    free_p = int((info.n_alleles - 1).sum())

    def n_parameters(K):
        # Dataset.n_parameters (multiclust.c:1267-1277) of the panel
        per_i = opt.admixture and not opt.eta_constrained
        return (I_total * (K - 1) if per_i else K - 1) + free_p * K

    t_start = time.time()
    if opt.n_repeat != 1:
        from multiclust_tpu_torch.runtime.timing import timed_model_estimation
        timed_model_estimation(opt.seed, md, opt, n_parameters, warm=warm,
                               true_partition=truth)
        return 0

    def on_model_done(K, mres):
        if opt.write_files and mres.best_params is not None:
            ingest.write_outputs_distributed(opt, info, K, mres, md)
        _report_model(opt, K, mres, t_start)

    est = estimate_model(opt.seed, md, opt, n_parameters, warm=warm,
                         true_partition=truth,
                         on_model_done=on_model_done)
    _finish(opt, md, est, n_parameters)
    return 0


def _write_outputs(opt: Options, ds, md, K: int, mres) -> None:
    from multiclust_tpu_torch.io import writers
    from multiclust_tpu_torch.runtime.multistart import posterior_mass

    params = mres.best_params
    eta = params.eta.cpu().numpy().astype(np.float64)
    p = params.p.cpu().numpy().astype(np.float64)
    mass = posterior_mass(params, md, opt.admixture, opt.eta_constrained)
    mass = mass.cpu().numpy().astype(np.float64)
    count_K = np.bincount(np.argmax(mass, axis=1), minlength=K)
    writers.write_file_detail(opt, ds, K, mres.max_logL,
                              mres.ever_converged, mres.aic, mres.bic,
                              count_K, eta, p)
    if opt.admixture:
        writers.write_popq(opt, ds, K, mass / (ds.ploidy * ds.L))
        writers.write_indivq(
            opt, ds, K, writers.admixture_indivq_mass(opt, ds, eta, mass))
    else:
        # the mixture's popq and indivq are its posterior
        writers.write_popq(opt, ds, K, mass)
        writers.write_indivq(opt, ds, K, mass)


def _run_simulate(opt: Options) -> int:
    """--simulate qfile pfile [ofile] (multiclust.c:101-116)."""
    from multiclust_tpu_torch.io.warm_start import read_admixture_pfile, \
        read_admixture_qfile
    from multiclust_tpu_torch.io.writers import write_data
    from multiclust_tpu_torch.stats.sim import simulate_admixture_fast

    Q = read_admixture_qfile(opt.admix_qfile)
    P = read_admixture_pfile(opt.admix_pfile, Q.shape[1])
    rng = np.random.default_rng(opt.seed)
    ds = simulate_admixture_fast(rng, Q, P, ploidy=opt.ploidy)
    write_data(opt, ds, opt.simulate_outfile)
    if opt.verbosity:
        print(f"Simulated {ds.I} individuals x {ds.L} loci -> "
              f"{opt.simulate_outfile}")
    return 0


def print_model_state(opt: Options, ds, mres, diff: float,
                      newline: bool = True) -> None:
    """print_model_state (multiclust.c:718-791), compact form."""
    out = sys.stdout
    if opt.compact:
        out.write("%s %s %s %d %u %e %e %e %e %f %f %f " % (
            opt.filename, opt.accel_abbreviation,
            "admix" if opt.admixture else "mix", mres.K, opt.seed,
            opt.eta_lower_bound, opt.p_lower_bound,
            opt.abs_error, opt.rel_error,
            mres.max_logL, mres.aic, mres.bic))
        out.write("%f " % mres.arand if opt.afile else "ND ")
        d = int(diff)
        out.write("%s %02d:%02d:%02d %d %d %d %d" % (
            "converged" if mres.ever_converged else "not",
            d // 3600, (d % 3600) // 60, d % 60,
            mres.n_total_iter, mres.n_init, mres.n_maxll_init,
            mres.n_maxll_times))
        if opt.target_ll:
            out.write(" %f %d %d" % (opt.desired_ll, mres.n_targetll_init,
                                     mres.n_targetll_times))
        if mres.time_stop:
            out.write(" time")
        if newline:
            out.write("\n")
    else:
        # long form (print_model_state, multiclust.c:748-790)
        d = int(diff)
        out.write(f"Dataset: {opt.filename}\n")
        out.write(f"Method/Model: {opt.accel_abbreviation}, "
                  f"{'admix' if opt.admixture else 'mix'}, K={mres.K}\n")
        out.write("Convergence: ae=%e, re=%e\n"
                  % (opt.abs_error, opt.rel_error))
        out.write("Bounds: e=%e, p=%e\n"
                  % (opt.eta_lower_bound, opt.p_lower_bound))
        out.write("Total number of iterations: %d\n" % mres.n_total_iter)
        out.write("Total time: %02d:%02d:%02d\n"
                  % (d // 3600, (d % 3600) // 60, d % 60))
        out.write("Iteration of max log likelihood: %d of %d\n"
                  % (mres.n_maxll_init, mres.n_init))
        out.write("Number of times reach max log likelihood: %d\n"
                  % mres.n_maxll_times)
        out.write(f"Maximum log likelihood: {mres.max_logL:f}\n")
        out.write(f"AIC: {mres.aic:f}\nBIC: {mres.bic:f}\n")
        out.write("Converged: %s\n" %
                  ("yes" if mres.ever_converged else "no"))
        if opt.target_ll and mres.n_targetll_times:
            out.write("Iteration of target log likelihood (%f): %d\n"
                      % (opt.desired_ll, mres.n_targetll_init))
            out.write("Number of times reach target log likelihood "
                      "(%f): %d\n"
                      % (opt.desired_ll, mres.n_targetll_times))
        elif opt.target_ll and not opt.target_revisit:
            out.write("WARNING: Did not reach target log likelihood "
                      "(%f).\n" % opt.desired_ll)
        if mres.time_stop:
            out.write("WARNING: Fitting stopped because ran out of time\n")



if __name__ == "__main__":
    raise SystemExit(main())
