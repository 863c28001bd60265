"""Per-process ingest and the sharded writers of a meshed run
(multiclust_tpu/runtime/ingest.py) over ``torch.distributed``.

The reference reads the whole file on one host (read_file.c:38-300).
Here every rank of a ``--mesh DxM`` run parses ONLY the rows of its data
block with the row-range reader (io/structure.read_structure_shard_raw,
backed by csrc/host/structure_reader.cpp), and uploads only its block of
rows and loci (model/common.model_data_from_block): host memory and parse
time grow with I / D, device memory with the block.  The ranks of one
model group parse the same rows.

Layout: rank r holds data block ``r // M`` and loci block ``r % M``
(runtime/mesh.Mesh), each contiguous and uneven when it must be (the first
``n % parts`` blocks one longer); the port pads no rows.  What crosses
ranks does so through the host-array collectives of runtime/mesh.py, over
the data group (each row block once):

* position-coded alleles (``-I``) sync the per-locus allele-count maximum;
  label-coded panels (microsatellite fragment lengths) union each rank's
  per-locus labels into the global sorted vocabulary, the reference's
  summarize_alleles order (read_file.c:443-600), and map their labels
  through it;
* ``--impute`` takes the global per-locus modal allele, from summed
  histograms;
* the any-missing flags of the loci (the ``.pklm`` missing slot, the
  ``.indivq`` mass source) are OR-ed.

Output files follow the JAX package's multi-process layout: the
per-individual tables (``.etaik``, ``.indivq``, ``--impute`` data) as
``.part<d>`` row blocks, numbered by the data index d and written by the
rank with model index 0 of each data block (part 0 carries the header, the
last part the trailer, so the parts joined in order are the single-process
file); rank 0 writes the replicated ``.out`` (with the global count.K),
``.etak``, ``.pklm`` and ``.popq``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from multiclust_tpu_torch.runtime import mesh as mesh_mod


class IngestInfo(NamedTuple):
    """A rank's side of a per-process load."""

    ds_local: object          # the Dataset of this rank's rows, every locus
    lo: int                   # first global individual of the rows
    hi: int                   # one past the last
    I_total: int              # the panel's individuals
    miss_any: np.ndarray      # [L] bool, any missing copy at the locus
    n_alleles: np.ndarray     # [L] int64, the panel's allele counts
    mesh: mesh_mod.Mesh

    @property
    def part(self) -> int:
        """The number of this rank's ``.part`` files: its data index."""
        return self.mesh.data_index

    @property
    def writes_part(self) -> bool:
        """One rank of each data block writes its part: model index 0."""
        return self.mesh.model_index == 0

    @property
    def last_part(self) -> bool:
        return self.mesh.data_index == self.mesh.data_shards - 1


def _data_group(mesh):
    """(group, index, size) of the data group, over which each row block
    counts once."""
    return mesh.data_group, mesh.data_index, mesh.data_shards


def _global_label_vocab(vloc: np.ndarray, mesh):
    """The union of the ranks' per-locus label tables ([L, U] padded with
    LABEL_PAD, io/structure.local_label_summary) in sorted order: the
    single-file reader's np.unique order.  Each rank's table travels in
    its row of a zero-filled [D, L, U] buffer summed over the data
    group."""
    from multiclust_tpu_torch.io.structure import LABEL_PAD

    group, index, n = _data_group(mesh)
    U = int(mesh_mod.host_max(np.int64(vloc.shape[1]), group))
    if vloc.shape[1] < U:
        vloc = np.pad(vloc, ((0, 0), (0, U - vloc.shape[1])),
                      constant_values=LABEL_PAD)
    tables = np.zeros((n,) + vloc.shape, np.int64)
    tables[index] = vloc
    tables = mesh_mod.host_sum(tables, group)          # [D, L, U]
    L = vloc.shape[0]
    uniques = []
    for l in range(L):
        vals = tables[:, l, :].ravel()
        uniques.append(np.unique(vals[vals != LABEL_PAD]))
    vocab = np.full((L, max(max((u.size for u in uniques), default=0), 1)),
                    LABEL_PAD, np.int64)
    sizes = np.zeros(L, np.int64)
    for l, u in enumerate(uniques):
        vocab[l, :u.size] = u
        sizes[l] = u.size
    return vocab, sizes


def _impute_global_mode(ds_local, mesh):
    """``--impute`` under per-process reads: the GLOBAL per-locus modal
    allele (summarize_alleles imputation, read_file.c:487-509, :545-554;
    ties to the smallest), from the ranks' count histograms summed; a
    rank-local mode would differ between ranks.  The rows come back free
    of missing copies."""
    group, _, _ = _data_group(mesh)
    counts = np.asarray(ds_local.counts, np.int64)
    miss = np.asarray(ds_local.miss, np.int64)
    M = int(mesh_mod.host_max(np.int64(counts.shape[2]), group))
    if M > counts.shape[2]:
        counts = np.pad(counts, ((0, 0), (0, 0), (0, M - counts.shape[2])))
    hist = mesh_mod.host_sum(counts.sum(axis=0), group)   # [L, M]
    mode = hist.argmax(axis=1)
    counts[:, np.arange(counts.shape[1]), mode] += miss
    if ds_local.IL is not None:
        ds_local.IL = np.where(ds_local.IL == -9, mode[None, :],
                               ds_local.IL)
    ds_local.counts = counts.astype(np.int32)
    ds_local.miss = np.zeros_like(ds_local.miss)
    # the mode is an allele seen somewhere; the panel's n_alleles (the
    # maximum over the ranks) covers a slot these rows never saw
    ds_local.n_alleles = np.maximum(np.asarray(ds_local.n_alleles,
                                               np.int64), mode + 1)
    return ds_local


def write_data_distributed(opt, info: IngestInfo, outfile: str) -> None:
    """``--impute`` data (write_data, write_file.c:22-130) as
    ``<outfile>.part<d>``: the rows of data block d, part 0 with the
    header line."""
    from multiclust_tpu_torch.io import writers

    if info.writes_part:
        writers.write_data(opt, info.ds_local, f"{outfile}.part{info.part}",
                           header=info.part == 0)


def load_structure_distributed(path: str, opt, mesh,
                               dtype: torch.dtype = torch.float32,
                               storage_dtype: Optional[torch.dtype] = None,
                               device="cpu"):
    """Read this rank's block of ``path`` and upload it.

    A metadata scan fixes the panel's row count; the rank parses the rows
    of its data block only, syncs the allele counts (or the label
    vocabulary), the ``--impute`` mode and the any-missing flags over the
    data group, and uploads its block of rows and loci, with ``c`` taken
    over every locus (model/common.model_data_from_block).  Returns (md,
    IngestInfo).  A 1 x 1 ``mesh`` reads the whole file through the same
    path, and ``md`` is then no block."""
    from multiclust_tpu_torch.io.dataset import from_haplotypes
    from multiclust_tpu_torch.io.structure import codes_from_labels, \
        local_label_summary, read_structure_shard, \
        read_structure_shard_raw, scan_structure
    from multiclust_tpu_torch.model.common import model_data_from_block, \
        model_data_from_dataset

    group, _, _ = _data_group(mesh)
    n_rows, header_cols, n0, n1 = scan_structure(path)
    interleaved = n_rows < 2 or n0 != n1
    I_total = n_rows if interleaved else n_rows // opt.ploidy
    L_file = header_cols - 2 if opt.R_format else header_cols
    if I_total < mesh.data_shards or L_file < mesh.model_shards:
        raise ValueError(f"a {mesh.shape[0]}x{mesh.shape[1]} mesh leaves a "
                         f"rank no rows or loci of the {I_total} x {L_file} "
                         f"panel in '{path}'")
    lo, hi = mesh.rows(I_total)
    # the mode is the panel's (below), never the rows'
    opt_read = (dataclasses.replace(opt, imputation_method=0)
                if opt.imputation_method else opt)
    vocab = None
    if opt.alleles_are_indices:
        ds, I_check = read_structure_shard(path, lo, hi, opt_read)
    else:
        IL, names, locales, pops, I_check, _ = read_structure_shard_raw(
            path, lo, hi, ploidy=opt.ploidy, R_format=opt.R_format,
            one_plus=opt.one_plus, missing_value=opt.missing_value)
        vocab, sizes = _global_label_vocab(local_label_summary(IL)[0], mesh)
        ds = from_haplotypes(codes_from_labels(IL, vocab, sizes),
                             ploidy=opt.ploidy, alleles_are_indices=True,
                             names=names, locales=locales, pops=pops)
        ds.L_alleles = [vocab[l, :sizes[l]] for l in range(vocab.shape[0])]
    assert I_check == I_total, (I_check, I_total)
    if opt.imputation_method:
        ds = _impute_global_mode(ds, mesh)
    if vocab is not None:
        # the writers emit labels, as the single-file reader's IL holds
        codes = np.asarray(ds.IL)
        lab = vocab[np.arange(vocab.shape[0])[None, :],
                    np.maximum(codes, 0)]
        ds.IL = np.where(codes == -9, -9, lab)
        n_alleles = sizes
    else:
        n_alleles = mesh_mod.host_max(np.asarray(ds.n_alleles, np.int64),
                                      group)
    miss_any = mesh_mod.host_any(np.asarray(ds.miss).any(axis=0), group)
    n_alleles = np.asarray(n_alleles, np.int64)
    info = IngestInfo(ds_local=ds, lo=lo, hi=hi, I_total=I_total,
                      miss_any=miss_any, n_alleles=n_alleles, mesh=mesh)
    if mesh.shape == (1, 1):
        M = int(n_alleles.max()) if n_alleles.size else 0
        if ds.M < M:
            ds.counts = np.pad(ds.counts,
                               ((0, 0), (0, 0), (0, M - ds.M)))
        ds.n_alleles = n_alleles
        return (model_data_from_dataset(ds, dtype=dtype, device=device,
                                        storage_dtype=storage_dtype), info)
    md = model_data_from_block(ds.counts, ds.miss, n_alleles, I_total, lo,
                               mesh.loci(n_alleles.shape[0]), dtype=dtype,
                               device=device, storage_dtype=storage_dtype)
    return md, info


def mass_block(opt, params, md, mesh) -> np.ndarray:
    """[I_b, K] cluster mass of this rank's rows (float64 host array):
    the admixture posterior allele mass (partition_admixture,
    write_file.c:350-382) or the mixture posterior (partition_mixture
    :582-600), summed over the model group."""
    from multiclust_tpu_torch.runtime.multistart import posterior_mass

    mass = posterior_mass(params, md, opt.admixture, opt.eta_constrained,
                          mesh=mesh)
    return mass.cpu().numpy().astype(np.float64)


def score_arand_distributed(opt, md, params, truth, mesh) -> float:
    """Adjusted Rand index against a true partition (-A; adj_rand,
    multiclust.c:1903-1985) of a meshed fit: each rank's rows' hard
    partition against their truth as a contingency table, the tables
    summed over the data group before the closed form."""
    from multiclust_tpu_torch.stats.rand_index import ADJUSTED_RAND_INDEX, \
        agreement_from_contingency

    truth = np.asarray(truth)
    assign = mass_block(opt, params, md, mesh).argmax(axis=1)
    r0, _ = md.offsets
    table = np.zeros((int(truth.max()) + 1, params.K))
    np.add.at(table, (truth[r0:r0 + md.I], assign), 1.0)
    table = mesh_mod.host_sum(table, _data_group(mesh)[0])
    return float(agreement_from_contingency(table, md.I_total,
                                            ADJUSTED_RAND_INDEX))


def write_clumpp_distributed(opt, info: IngestInfo, K: int, params,
                             md) -> np.ndarray:
    """CLUMPP / DISTRUCT outputs of a meshed fit (popq_admix
    write_file.c:398-475, indivq_admix :492-569, the mixture's :616-732):
    each data block's ``.indivq`` rows as ``.part<d>``, and the ``.popq``
    of the panel from per-locale sums and sizes summed over the data
    group, over a locale vocabulary unioned in first-appearance order
    (the single-file reader's order: the blocks are contiguous).  Returns
    the panel's count.K (the hard partition's bincount)."""
    from multiclust_tpu_torch.io import writers

    mesh = info.mesh
    group, index, n = _data_group(mesh)
    ds = info.ds_local
    lo, n_loc = info.lo, info.hi - info.lo
    mass = mass_block(opt, params, md, mesh)
    count_K = mesh_mod.host_sum(
        np.bincount(mass.argmax(axis=1), minlength=K).astype(np.int64),
        group)
    if opt.admixture:
        frac = mass / (opt.ploidy * info.n_alleles.shape[0])
        # admixture_indivq_mass (write_file.c:525-550) on the panel's
        # missing flag, which every rank holds the same
        eta = params.eta
        if (opt.eta_constrained or bool(info.miss_any.any())
                or eta.dim() == 1):
            ind_mass = frac
        else:
            ind_mass = eta[lo:info.hi].cpu().numpy().astype(np.float64)
        pop_mass = frac
    else:
        ind_mass = pop_mass = mass
    base = writers._base(opt)
    if opt.admixture:
        iq_name = f"{base}_admix_indivq_{K}.indivq.part{info.part}"
        pq_name = f"{base}_admix_popq_{K}.popq"
    else:
        iq_name = f"{base}.mix.K={K}.indivq.part{info.part}"
        pq_name = f"{base}_mix_popq.popq"
    names = ds.names or [str(lo + i) for i in range(n_loc)]
    pops = ds.pops or ["pop0"]
    locales = (np.asarray(ds.locales, np.int64) if ds.locales is not None
               else np.zeros(n_loc, np.int64))
    if info.writes_part:
        with open(iq_name, "w") as fp:
            for j in range(n_loc):
                fp.write("%d\t%s\t(x)\t%s\t:" % (lo + j, names[j],
                                                 pops[locales[j]]))
                fp.write("".join("\t%f" % v for v in ind_mass[j]))
                fp.write("\n")

    pops_g, where = [], {}
    for plist in mesh_mod.gather_strings(pops, index, n, group):
        for name in plist:
            if name not in where:
                where[name] = len(pops_g)
                pops_g.append(name)
    g = np.array([where[name] for name in pops], np.int64)[locales]
    agg = np.zeros((len(pops_g), K))
    np.add.at(agg, g, pop_mass)
    agg = mesh_mod.host_sum(agg, group)
    sizes = mesh_mod.host_sum(
        np.bincount(g, minlength=len(pops_g)).astype(np.int64), group)
    if mesh_mod.rank() == 0:
        agg /= np.maximum(sizes, 1)[:, None]
        with open(pq_name, "w") as fp:
            for i, pop in enumerate(pops_g):
                fp.write("%s:\t" % pop)
                fp.write("".join("%f\t" % v for v in agg[i]))
                fp.write("%d\n" % sizes[i])
    return count_K


def warm_start_distributed(opt, info: IngestInfo, dtype: torch.dtype,
                           device):
    """-Q / -P warm start (read_qfile / read_pfile, read_file.c:880-959)
    of a meshed run: the files are O(I K) and O(L K), so every rank reads
    them whole; the fit slices its block (runtime/multistart._warm_block).
    M comes from the panel's n_alleles."""
    from multiclust_tpu_torch.cli import UsageError
    from multiclust_tpu_torch.io.warm_start import read_pfile, read_qfile
    from multiclust_tpu_torch.model.common import Params

    M = int(info.n_alleles.max())
    if M != 2:
        raise UsageError(f"-P warm start assumes biallelic data; dataset "
                         f"has up to {M} alleles per locus")
    per_individual = opt.admixture and not opt.eta_constrained
    eta = read_qfile(opt.qfile, info.I_total, opt.max_K,
                     per_individual=per_individual)
    p = read_pfile(opt.pfile, info.n_alleles.shape[0], opt.max_K)
    return Params(eta=torch.as_tensor(eta, dtype=dtype, device=device),
                  p=torch.as_tensor(p, dtype=dtype, device=device))


def write_outputs_distributed(opt, info: IngestInfo, K: int, mres,
                              md) -> None:
    """Per-K output files of a meshed fit (write_file_detail,
    write_file.c:203-335): each data block's ``.etaik`` rows as
    ``.etaik.part<d>.txt``, the CLUMPP files (write_clumpp_distributed),
    and on rank 0 ``.out.txt`` with the panel's count.K, ``.etak`` and
    ``.pklm``.  Every rank calls it: the count.K and ``.popq`` sums are
    collective."""
    from multiclust_tpu_torch.io import writers

    base = f"{writers._base(opt)}.{writers._model_tag(opt)}.K={K}"
    params = mres.best_params
    eta = params.eta.cpu().numpy().astype(np.float64)
    if eta.ndim == 2 and info.writes_part:
        rows = eta[info.lo:info.hi]
        n_loc = rows.shape[0]
        ik = np.stack([info.lo + np.repeat(np.arange(n_loc, dtype=np.int64),
                                           K),
                       np.tile(np.arange(K, dtype=np.int64), n_loc)], axis=1)
        writers._write_big_table(
            f"{base}.etaik.part{info.part}.txt",
            "i\tk\tetaik\n" if info.part == 0 else "", ik,
            rows.reshape(-1, 1), trailer="\n" if info.last_part else "")
    count_K = write_clumpp_distributed(opt, info, K, params, md)
    if mesh_mod.rank() != 0:
        return
    with open(base + ".out.txt", "w") as fp:
        fp.write("logL = %f (%s)\n" % (
            mres.max_logL,
            "converged" if mres.ever_converged else "not converged"))
        fp.write("AIC = %f\n" % mres.aic)
        fp.write("BIC = %f\n\n" % mres.bic)
        fp.write("count.K\n")
        fp.write("".join("%d " % c for c in count_K))
        fp.write("\n\n")
    if eta.ndim == 1:
        with open(base + ".etak.txt", "w") as fp:
            fp.write("i\tk\tetak\n")
            for k in range(K):
                fp.write("%d\t%f\n" % (k, eta[k]))
            fp.write("\n")
    writers.write_pklm(base, K, params.p.cpu().numpy().astype(np.float64),
                       info.n_alleles, info.miss_any)
