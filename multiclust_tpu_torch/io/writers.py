"""Output writers (write_file.c) - byte-format-compatible where sane.

Slot-index note: the reference's per-locus allele axis includes a leading
MISSING slot when the locus has missing observations (uniquealleles[l] =
observed + 1); our dense tensors index observed alleles only.  File output
restores the reference indexing: slot 0 of a missing locus is emitted with
probability 0.000000 (the reference prints uninitialized memory there -
vpklm slot 0 is never written by the M-step, em_alg.c:711-746).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from multiclust_tpu_torch.config import MISSING, Options, OutputFormat
from multiclust_tpu_torch.io.dataset import Dataset


def _base(opt: Options, for_popq: bool = False) -> str:
    """Output file base name (write_file_detail, write_file.c:211-233)."""
    if opt.outfile_name is not None:
        return opt.outfile_name
    fname = os.path.basename(opt.filename) if opt.filename else "out"
    path = opt.path or "./"
    sep = "" if path.endswith(("/", "\\")) else "/"
    return f"{path}{sep}{fname}"


def _model_tag(opt: Options) -> str:
    return "admix" if opt.admixture else "mix"


def write_file_detail(opt: Options, ds: Dataset, K: int, logL: float,
                      converged: bool, aic: float, bic: float,
                      count_K: np.ndarray, eta: np.ndarray,
                      p: np.ndarray) -> None:
    """Per-K best-fit files (write_file_detail, write_file.c:203-335)."""
    base = f"{_base(opt)}.{_model_tag(opt)}.K={K}"

    with open(base + ".out.txt", "w") as fp:
        fp.write("logL = %f (%s)\n" % (
            logL, "converged" if converged else "not converged"))
        fp.write("AIC = %f\n" % aic)
        fp.write("BIC = %f\n\n" % bic)
        fp.write("count.K\n")
        fp.write("".join("%d " % c for c in count_K))
        fp.write("\n\n")

    if eta.ndim == 1:
        with open(base + ".etak.txt", "w") as fp:
            fp.write("i\tk\tetak\n")
            for k in range(K):
                fp.write("%d\t%f\n" % (k, eta[k]))
            fp.write("\n")
    else:
        I = eta.shape[0]
        ik = np.stack([np.repeat(np.arange(I, dtype=np.int64), K),
                       np.tile(np.arange(K, dtype=np.int64), I)], axis=1)
        _write_big_table(base + ".etaik.txt", "i\tk\tetaik\n", ik,
                         np.asarray(eta, np.float64).reshape(-1, 1))

    write_pklm(base, K, p, ds.n_alleles, ds.has_missing_slot)


def write_pklm(base: str, K: int, p: np.ndarray, n_alleles,
               has_missing_slot) -> None:
    """.pklm table: rows are jagged per locus (n_alleles + an extra slot
    0 for missing loci, printed as 0.0 - see module docstring); build
    the (k, l, m, value) columns vectorized, then bulk-write.  Shared by
    the single-host writer and the multi-host process-0 writer
    (runtime/ingest.write_outputs_distributed)."""
    L = len(np.asarray(n_alleles))
    rows_l = (np.asarray(n_alleles, np.int64)
              + np.asarray(has_missing_slot, np.int64))     # [L]
    per_k = int(rows_l.sum())
    l_idx = np.repeat(np.arange(L, dtype=np.int64), rows_l)
    starts = np.repeat(np.cumsum(rows_l) - rows_l, rows_l)
    m_idx = np.arange(per_k, dtype=np.int64) - starts
    m_start = np.asarray(has_missing_slot, np.int64)[l_idx]
    obs = m_idx >= m_start
    slot = np.where(obs, m_idx - m_start, 0)
    k_col = np.repeat(np.arange(K, dtype=np.int64), per_k)
    klm = np.stack([k_col, np.tile(l_idx, K), np.tile(m_idx, K)], axis=1)
    vals = np.where(obs[None, :],
                    np.asarray(p, np.float64)[:, l_idx, slot],
                    0.0).reshape(-1, 1)
    _write_big_table(base + ".pklm.txt", "k\tl\tm\tKLM\n", klm, vals)


def _write_big_table(path: str, header: str, ints: np.ndarray,
                     floats: np.ndarray, trailer: str = "\n") -> None:
    """Bulk table write: native C++ writer when available (~30x faster -
    the engine rewrites these files on every best-so-far improvement,
    multiclust.c:584-600), byte-identical Python fallback otherwise.
    ``trailer`` ends the file (only the last of a table's row-block parts
    carries it, runtime/ingest.write_outputs_distributed)."""
    from multiclust_tpu_torch.io import fastwrite
    if fastwrite.available():
        fastwrite.write_table(path, header, trailer, ints, floats)
        return
    fmt = "\t".join(["%d"] * ints.shape[1]
                    + ["%f"] * floats.shape[1]) + "\n"
    with open(path, "w") as fp:
        fp.write(header)
        for iv, fv in zip(ints, floats):
            fp.write(fmt % (*iv, *fv))
        fp.write(trailer)


def write_popq(opt: Options, ds: Dataset, K: int, mass: np.ndarray) -> None:
    """CLUMPP/DISTRUCT .popq (popq_admix write_file.c:398-475; popq_mix
    :616-682).  ``mass[i, k]`` is the per-individual cluster weight: the
    posterior v_ik for the mixture model, or dik/(ploidy*L) under admixture.
    """
    if opt.admixture:
        name = f"{_base(opt)}_admix_popq_{K}.popq"
    else:
        name = f"{_base(opt)}_mix_popq.popq"
    pops = ds.pops or ["pop0"]
    locales = ds.locales if ds.locales is not None else \
        np.zeros(ds.I, dtype=np.int64)
    sizes = np.bincount(locales, minlength=len(pops))
    agg = np.zeros((len(pops), K))
    np.add.at(agg, locales, mass)
    agg /= np.maximum(sizes, 1)[:, None]
    with open(name, "w") as fp:
        for n, pop in enumerate(pops):
            fp.write("%s:\t" % pop)
            fp.write("".join("%f\t" % v for v in agg[n]))
            fp.write("%d\n" % sizes[n])


def write_indivq(opt: Options, ds: Dataset, K: int,
                 mass: np.ndarray) -> None:
    """CLUMPP/DISTRUCT .indivq (indivq_admix write_file.c:492-569;
    indivq_mix :696-732)."""
    if opt.admixture:
        name = f"{_base(opt)}_admix_indivq_{K}.indivq"
    else:
        name = f"{_base(opt)}.mix.K={K}.indivq"
    pops = ds.pops or ["pop0"]
    locales = ds.locales if ds.locales is not None else \
        np.zeros(ds.I, dtype=np.int64)
    names = ds.names or [str(i) for i in range(ds.I)]
    with open(name, "w") as fp:
        for i in range(ds.I):
            fp.write("%d\t%s\t(x)\t%s\t:" % (i, names[i],
                                             pops[locales[i]]))
            fp.write("".join("\t%f" % v for v in mass[i]))
            fp.write("\n")


def admixture_indivq_mass(opt: Options, ds: Dataset, eta: np.ndarray,
                          dik: np.ndarray) -> np.ndarray:
    """indivq_admix source selection (write_file.c:525-550): posterior
    allele fractions when eta is shared or data has missing entries, else
    the fitted etaik."""
    if opt.eta_constrained or ds.missing_data or eta.ndim == 1:
        return dik / (ds.ploidy * ds.L)
    return eta


def write_data(opt: Options, ds: Dataset, outfile: Optional[str],
               use_counts: bool = False, header: bool = True) -> str:
    """Write genotype data (write_data, write_file.c:22-130).

    ``use_counts`` reconstructs haplotypes from the count tensor (bootstrap
    replicates); copies are emitted missing-first then ascending alleles,
    matching the reference's slot-order walk (write_file.c:104-122).
    ``header=False`` omits the locus-name line (sharded multi-process
    parts after the first, runtime/ingest.write_data_distributed).
    """
    if outfile is None:
        outfile = os.path.join(opt.path or "./", "bs.str")
    fmt = opt.output_format
    plus = 1 if (opt.write_plus_one or fmt == OutputFormat.PED) else 0
    names = ds.names or [str(i) for i in range(ds.I)]
    pops = ds.pops or ["0"]
    locales = ds.locales if ds.locales is not None else \
        np.zeros(ds.I, dtype=np.int64)

    def hap_alleles(i, j):
        if not use_counts:
            return ds.IL[i * ds.ploidy + j]
        row = np.empty(ds.L, dtype=np.int64)
        for l in range(ds.L):
            # j-th copy in slot order: missing copies first
            c = j
            if c < ds.miss[i, l]:
                row[l] = MISSING
                continue
            c -= ds.miss[i, l]
            m = 0
            while c >= ds.counts[i, l, m]:
                c -= ds.counts[i, l, m]
                m += 1
            row[l] = (ds.L_alleles[l][m] if ds.L_alleles is not None else m)
        return row

    with open(outfile, "w") as fp:
        if fmt == OutputFormat.STRUCTURE:
            if header:
                fp.write(" ".join(f"loc{l + 1}"
                                  for l in range(ds.L)) + "\n")
            for i in range(ds.I):
                for j in range(ds.ploidy):
                    fp.write("%s %s" % (names[i], pops[locales[i]]))
                    fp.write("".join(" %d" % (a + plus)
                                     for a in hap_alleles(i, j)))
                    fp.write("\n")
        else:  # PED
            for i in range(ds.I):
                fp.write("%s %s 0 0 0 -9" % (names[i], names[i]))
                haps = [hap_alleles(i, j) for j in range(ds.ploidy)]
                for l in range(ds.L):
                    for j in range(ds.ploidy):
                        fp.write(" %d" % (haps[j][l] + plus))
                fp.write("\n")
    return outfile
