"""Command-line interface of the port, flag-compatible with the JAX CLI
(multiclust_tpu/cli.py, single-process path).

Run as ``python -m multiclust_tpu_torch.cli <reference flags>``.  Flags are
parsed by ``multiclust_tpu.cli.parse_args``; ``--platform cpu`` fits on
the CPU in float64, as the JAX CLI does, and the default fits on CUDA.
Flags outside the ported slice raise a usage error that names the
ROADMAP.md item.
"""

from __future__ import annotations

import sys
import time
from typing import List, Optional

import numpy as np
import torch

from multiclust_tpu.cli import UsageError, parse_args, print_model_state
from multiclust_tpu.config import Options


def main(argv: Optional[List[str]] = None) -> int:
    """CLI entry: errors are reported through the message() taxonomy, the
    error code becoming the exit status (main, multiclust.c:157-164)."""
    from multiclust_tpu.messages import Err, MsgType, MulticlustError, \
        message
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
        from multiclust_tpu.cli import _run_simulate
        return _run_simulate(opt)

    from multiclust_tpu_torch.api import check_ported
    try:
        check_ported(opt)
    except NotImplementedError as e:
        raise UsageError(str(e))
    if platform == "cpu":
        opt.dtype = "float64"  # reference-precision semantics on CPU
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda")
    else:
        raise UsageError("no CUDA device is available; run with "
                         "--platform cpu")

    from multiclust_tpu.io.structure import read_structure
    from multiclust_tpu.io.warm_start import read_afile, read_pfile, \
        read_qfile
    from multiclust_tpu_torch.init.random import codes_from_counts
    from multiclust_tpu_torch.model.common import Params, \
        model_data_from_dataset
    from multiclust_tpu_torch.runtime.ksweep import estimate_model
    from multiclust_tpu_torch.runtime.multistart import device_policy

    ds = read_structure(opt.filename, opt)
    if opt.imputation_method and opt.imputed_outfile:
        # write the imputed dataset (read_file, read_file.c:295-296)
        from multiclust_tpu.io.writers import write_data
        write_data(opt, ds, opt.imputed_outfile)
    opt = opt.synchronize(ds.I, ds.ploidy)
    dtype = getattr(torch, opt.dtype)
    _, storage = device_policy(opt, device)
    md = model_data_from_dataset(ds, dtype=dtype, device=device,
                                 storage_dtype=storage)
    # allele codes seed the admixture starts only
    codes = (codes_from_counts(md.x, md.miss, ds.ploidy) if opt.admixture
             else None)

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

    def on_model_improve(K, mres):
        # best-so-far persistence: rewrite the per-K files whenever an
        # init improves the best logL (multiclust.c:584-600)
        if opt.write_files and mres.best_params is not None:
            _write_outputs(opt, ds, md, K, mres)

    def on_model_done(K, mres):
        if opt.write_files and mres.best_params is not None:
            _write_outputs(opt, ds, md, K, mres)
        if opt.verbosity:
            print_model_state(opt, ds, mres, time.time() - t_start)

    est = estimate_model(opt.seed, md, opt, n_parameters, codes=codes,
                         warm=warm, true_partition=truth,
                         on_model_done=on_model_done,
                         on_improve=on_model_improve)
    if opt.parallel:
        # -M: stdout carries only the max log likelihood
        print(f"{est.last.max_logL:f}")
    return 0


def _write_outputs(opt: Options, ds, md, K: int, mres) -> None:
    from multiclust_tpu.io import writers
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


if __name__ == "__main__":
    raise SystemExit(main())
