"""Model initialization (multiclust_tpu/init/random.py, rnd_init.c): the
mixture model's individual partitions and the admixture model's allele
partitions.

Every draw comes from an explicit ``torch.Generator`` on the data's
device.  Its streams differ from JAX's threefry keys (and from the
reference's libc ``rand()``), so draw-for-draw parity is impossible and
the tests check these inits statistically; warm starts are the
deterministic check.

Documented deviation kept from the JAX package: ``random_allele_center``
falls back to the random allele partition when no locus can supply K
centers (every SNP panel at K > 2), where the reference's "random" starts
would all be identical.  So is its deviation from the reference's
``initialize_parameters_mixture`` (plain add-one smoothing) and from its
missing-data correction of ``random_individual_center`` (against center
k's missing counts, not center 0's).

The dynamic-K starts of a mixed-K K-sweep lattice (``initialize_dyn``,
the JAX package's ``initialize_dyn``, multiclust_tpu/init/random.py:
358-450) are the static-K starts of the same generator, draw for draw,
zero-padded to the lattice's lanes and carrying their ``kmask``; Rand-EM
scores their candidates on that layout, through the masked step of the
lattice's config.

The counts of a labelled window (``allele_partition_counts``) are one
launch of a hand-written CUDA kernel on the card (csrc/allele_counts.cu;
no host read) and the plain version's scatter and bincount on the CPU;
integers both ways, so the starts are the same bit for bit.  A start hands
the kernel the raw draw where every copy's label is drawn: it skips
missing copies itself.

A start makes no allele codes of the whole panel: each window of loci
takes the codes of its own slice of the counts (``_window_codes``; on a
panel held as int8 count planes, from the allele-0 and missing planes
alone, ``plane_codes``), and on the card a window whose labels are all
the raw draw (SNPs at K > 2) is counted from those planes themselves by
the kernel's planes variant (``allele_partition_counts_planes``).  No
temporary grows with the whole I x L x P, and the start is the one the
whole panel's codes give, draw for draw.

Under a mesh (runtime/mesh.py) ``md`` is this rank's block of the
panel (a whole panel given under a mesh is sliced first,
``mesh.as_block``).  Every rank makes the whole panel's draws from the same
generator, window by window of loci sized from the panel's I and L, so the
starts equal the unsharded fit's, and keeps and counts its block of them:
the per-individual counts over its loci are summed over the model group,
the per-locus counts over its rows over the data group, and a rank's start
is its block (eta rows, p loci).  A mixture center's row reaches every
rank of the data group from the rank that holds it, and a row's distances
to the centers are summed over the model group.
"""

from __future__ import annotations

import torch

from multiclust_tpu_torch.config import InitMethod, InitProcedure
from multiclust_tpu_torch.model.common import EMConfig, ModelData, Params, \
    column_window, make_kmask, map_params, pad_params_k
from multiclust_tpu_torch.ops import build
from multiclust_tpu_torch.ops.build import count
from multiclust_tpu_torch.runtime.mesh import DATA_AXIS, MODEL_AXIS, \
    as_block, host_max, sum_over, world_min
from multiclust_tpu_torch.runtime.observe import span

Tensor = torch.Tensor


# host reads of a CUDA bincount: its input's least and largest value
BINCOUNT_SYNCS = 2


# ---------------------------------------------------------------------------
# mixture model

def random_individual_partition(gen: torch.Generator, md: ModelData,
                                K: int) -> Tensor:
    """I_K[i] ~ Uniform{0..K-1} (rnd_init.c:173-179); of a block, its rows
    of the whole panel's draw."""
    r0, _ = md.offsets
    return torch.randint(0, K, (md.I_total,), generator=gen,
                         device=md.device)[r0:r0 + md.I]


def random_individual_center(gen: torch.Generator, md: ModelData,
                             K: int, mesh=None) -> Tensor:
    """K distinct random centers; each individual joins the center nearest
    in L1 distance on the counts, with the missing-data correction
    (rnd_init.c:192-259):
        dist[i, k] = sum_lm |x_i - x_c| - sum_l |miss_i - miss_c| / n_l
    over the loci with any missing copy; each center joins its own
    cluster.  Under a ``mesh`` ``md`` is this rank's block: the centers'
    rows are summed over the data group from the ranks that hold them, and
    the distances of its rows over the model group."""
    dev = md.device
    if K == 1:
        return torch.zeros(md.I, dtype=torch.int64, device=dev)
    r0, _ = md.offsets
    centers = torch.randperm(md.I_total, generator=gen, device=dev)[:K]
    x = md.x.to(md.dtype)
    missf = md.miss.to(md.dtype)
    denom = torch.clamp(md.n_alleles.to(md.dtype), min=1.0)
    own = (centers >= r0) & (centers < r0 + md.I)
    # each index by ``own`` reads its count of True on the host
    count("host.syncs", 4)
    local = (centers - r0)[own]
    xc = x.new_zeros((K,) + tuple(x.shape[1:]))
    xc[own] = x[local]
    mc = missf.new_zeros((K, md.L))
    mc[own] = missf[local]
    xc = sum_over(mesh, xc, DATA_AXIS)
    mc = sum_over(mesh, mc, DATA_AXIS)
    has_miss = sum_over(mesh, (missf.max(dim=0).values > 0).to(torch.int32),
                        DATA_AXIS) > 0                # [L]
    dists = []
    for k in range(K):                                # one [I, L, M] at a time
        d = (x - xc[k]).abs().sum(dim=(1, 2))
        corr = torch.where(has_miss, (missf - mc[k]).abs() / denom,
                           torch.zeros_like(missf)).sum(dim=1)
        dists.append(d - corr)
    assign = torch.argmin(sum_over(mesh, torch.stack(dists, dim=1),
                                   MODEL_AXIS), dim=1)
    assign[local] = torch.arange(K, device=dev)[own]
    return assign


def parameters_from_partition_mixture(I_K: Tensor, md: ModelData,
                                      K: int, mesh=None) -> Params:
    """Add-one-smoothed counts given a hard partition
    (initialize_parameters_mixture, rnd_init.c:268-339): eta [K], p [K, L,
    M].  Counts are exact integers, so bincounts and an index sum give the
    JAX package's one-hot sums.  Under a ``mesh`` ``md`` is this rank's
    block and ``I_K`` its rows' clusters: the p of its loci, from the
    counts of its rows summed over the data group."""
    dtype = md.dtype
    count("host.syncs", BINCOUNT_SYNCS)
    sizes = sum_over(mesh, torch.bincount(I_K, minlength=K).to(dtype),
                     DATA_AXIS)
    eta = (1.0 + sizes) / (md.I_total + K)
    pc = torch.zeros((K, md.L * md.M), dtype=dtype, device=md.device)
    pc.index_add_(0, I_K, md.x.reshape(md.I, -1).to(dtype))
    pc = sum_over(mesh, pc, DATA_AXIS)
    pc = torch.where(md.mask[None], pc.reshape(K, md.L, md.M) + 1.0,
                     torch.zeros((), dtype=dtype, device=md.device))
    return Params(eta=eta, p=pc / pc.sum(dim=2, keepdim=True))


# ---------------------------------------------------------------------------
# admixture model

# a start holds about this many bytes of int64 temporaries per allele copy
# (labels, matches, draws; the plain counts' slots and bin indices, which
# the CUDA counts do without; the window's codes, a few bytes); a panel
# whose I x L x P copies need more than the budget is drawn one window of
# loci at a time
INIT_BYTES_PER_COPY = 64
INIT_BYTES = 8 << 30


def init_window(md: ModelData, ploidy: int, budget: int = None) -> int:
    """Loci per window of an admixture start: all of L when the start's
    temporaries fit ``budget`` bytes (by default INIT_BYTES, and on CUDA at
    most a quarter of what the device has free).  Of a block, the window
    of the whole panel: every rank draws each window whole."""
    if budget is None:
        budget = INIT_BYTES
        if md.device.type == "cuda":
            count("host.mem_queries")
            budget = min(budget, torch.cuda.mem_get_info(md.device)[0] // 4)
    return column_window(md.L_total, INIT_BYTES_PER_COPY * md.I_total * ploidy,
                         budget)


def _raw_labels(method: InitMethod, K: int, n_max: int) -> bool:
    """Whether every copy's label is the random draw: a random partition,
    or random centers where no locus has K alleles to match (``n_max`` the
    panel's largest n_alleles)."""
    return method == InitMethod.RANDOM_PARTITION or (K > 1 and n_max < K)


def _window_labels(gen: torch.Generator, md: ModelData, codes: Tensor,
                   K: int, method: InitMethod, window, own,
                   n_max: int, shape=None) -> Tensor:
    """Cluster labels of the copies ``codes`` [I_b, L_b, P] of a window of
    loci, or of this rank's block of it.  ``window`` = (I, lo, hi): the
    whole panel's rows and the window's loci [lo, hi); ``own`` = (r0, a,
    m0): the first row of ``codes`` in the panel, its first locus in the
    window and in ``md``.  Every draw is made for the whole window, so the
    generator's stream is that of the unsharded start, and the block of
    the draws is kept.  ``n_max`` is the panel's largest n_alleles.
    Where every copy's label is the random draw (``_raw_labels``), the
    draw itself: a missing copy keeps its label, which the counts skip,
    and ``codes`` may be None with ``shape`` its (I_b, L_b, P); elsewhere
    -1 at missing copies."""
    I, lo, hi = window
    r0, a, m0 = own
    Ib, Lb, P = codes.shape if codes is not None else shape
    dev = md.device

    def draw():
        return torch.randint(0, K, (I, hi - lo, P), generator=gen,
                             device=dev)[r0:r0 + Ib, a:a + Lb]

    if _raw_labels(method, K, n_max):
        return draw()
    if K == 1:
        return torch.where(codes >= 0, 0, -1)
    M = md.M
    mask = md.mask[m0:m0 + Lb]
    # random permutation of the slots of each locus; invalid slots last
    noise = torch.rand((hi - lo, M), generator=gen, device=dev)[a:a + Lb]
    noise = torch.where(mask, noise, 2.0)
    rank = torch.argsort(torch.argsort(noise, dim=1), dim=1)
    slots = torch.arange(M, device=dev)[None, :]
    n_all = md.n_alleles[m0:m0 + Lb].to(torch.int64)[:, None]
    # inv[l, m] = cluster of slot m, or -1 when slot m is not a center
    ident = torch.where(slots < n_all, slots, -1)
    inv = torch.where(n_all < K, ident, torch.where(rank < K, rank, -1))
    inv = torch.where(mask, inv, -1)
    loci = torch.arange(Lb, device=dev)[None, :, None]
    matched = inv[loci, codes.clamp(min=0).long()]    # [I_b, L_b, P]
    lab = torch.where(matched >= 0, matched, draw())
    return torch.where(codes >= 0, lab, -1)


def _allele_labels(gen: torch.Generator, md: ModelData, codes: Tensor,
                   K: int, method: InitMethod, lo: int = 0,
                   hi: int = None) -> Tensor:
    """The labels of the copies ``codes`` of the loci [lo, hi) of ``md``
    (by default as many as ``codes`` has), drawn whole, to be counted:
    ``_window_labels`` of one window."""
    hi = lo + codes.shape[1] if hi is None else hi
    n_max = 0
    if method != InitMethod.RANDOM_PARTITION:
        count("host.syncs")
        n_max = int(md.n_alleles.max())
    return _window_labels(gen, md, codes, K, method,
                          (codes.shape[0], lo, hi), (0, 0, lo), n_max)


def random_allele_partition(gen: torch.Generator, md: ModelData,
                            codes: Tensor, K: int) -> Tensor:
    """Assign every observed allele copy to a random cluster
    (random_allele_partition, rnd_init.c:456-482).  Returns [I, L, P]
    cluster labels (-1 for missing copies)."""
    return torch.where(codes >= 0, _allele_labels(
        gen, md, codes, K, InitMethod.RANDOM_PARTITION), -1)


def random_allele_center(gen: torch.Generator, md: ModelData,
                         codes: Tensor, K: int, lo: int = 0,
                         hi: int = None) -> Tensor:
    """Per-locus random center alleles; copies matching a center join its
    cluster, the others are assigned at random (random_allele_center,
    rnd_init.c:496-580).  ``codes`` may cover only the loci [lo, hi) of
    ``md``.  Returns -1 for missing copies."""
    hi = md.L if hi is None else hi
    return torch.where(codes >= 0, _allele_labels(
        gen, md, codes, K, InitMethod.RANDOM_CENTERS, lo, hi), -1)


def allele_partition_counts_reference(labels: Tensor, codes: Tensor,
                                      M: int, K: int, dtype: torch.dtype):
    """Plain version of ``allele_partition_counts``: a scatter of ones
    into copies and a bincount of the copies' (cluster, locus, slot)
    bins; on CUDA tensors the bincount reads its input's range on the
    host."""
    I, L, P = codes.shape
    dev = codes.device
    valid = codes >= 0
    lab = torch.where(valid, labels, K)               # K = discard bin
    copies = torch.zeros((I, K + 1), dtype=dtype, device=dev)
    copies.scatter_add_(1, lab.reshape(I, -1),
                        torch.ones((I, L * P), dtype=dtype, device=dev))
    slot = torch.where(valid, codes.long(), M)        # M = discard bin
    loci = torch.arange(L, device=dev)[None, :, None]
    idx = (lab * L + loci) * (M + 1) + slot
    count("host.syncs", BINCOUNT_SYNCS)
    pc = torch.bincount(idx.reshape(-1), minlength=(K + 1) * L * (M + 1))
    pc = pc.reshape(K + 1, L, M + 1)[:K, :, :M].to(dtype)
    return copies[:, :K], pc


def allele_partition_counts(labels: Tensor, codes: Tensor, M: int, K: int,
                            dtype: torch.dtype):
    """Exact counts of a labelled window of loci: copies [I, K], the
    copies of each individual given to each cluster, and pc [K, L, M], the
    copies of each allele slot given to each cluster.  A missing copy
    (code < 0) is skipped whatever its label, so ``labels`` may be the raw
    draw.  On CUDA one launch of ``mc_allele_counts``
    (csrc/allele_counts.cu), which reads ``labels`` (int64) and ``codes``
    (int8 or int16) in place at their row strides, their L x P axis
    contiguous, and reads nothing back to the host; on the CPU the plain
    version.  Timed as ``mc.init.counts``; counted as a window
    (``init.windows``)."""
    count("init.windows")
    if not codes.is_cuda:
        with span("mc.init.counts"):
            return allele_partition_counts_reference(labels, codes, M, K,
                                                     dtype)
    I, L, P = codes.shape
    dev = codes.device
    _check_layout(dev, "labels", labels, (torch.int64,), (I, L, P))
    _check_layout(dev, "codes", codes, (torch.int8, torch.int16), (I, L, P))
    copies = torch.zeros((I, K), dtype=torch.int32, device=dev)
    pc = torch.zeros((K, L, M), dtype=torch.int32, device=dev)
    with span("mc.init.counts"):
        if codes.numel():
            build.launch("mc_allele_counts", dev, labels.data_ptr(),
                         codes.data_ptr(), copies.data_ptr(), pc.data_ptr(),
                         I, L, P, M, K, labels.stride(0), codes.stride(0),
                         codes.element_size())
    return copies.to(dtype), pc.to(dtype)


def allele_partition_counts_planes(labels: Tensor, x0: Tensor, miss: Tensor,
                                   K: int, dtype: torch.dtype):
    """``allele_partition_counts`` of a biallelic window read from its
    count planes on the card, with no codes: one launch of
    ``mc_allele_counts_planes`` (csrc/allele_counts.cu), which derives
    each copy's code from the allele-0 plane ``x0`` and the missing plane
    ``miss`` (int8 [I, L], a column slice of the panel's planes at their
    row stride) as ``plane_codes`` gives it, and reads ``labels`` (int64
    [I, L, P], P the ploidy) in place.  The planes must add up to the
    ploidy with the other allele's, as a panel's do."""
    I, L, P = labels.shape
    dev = labels.device
    if dev.type != "cuda":
        raise ValueError(f"the planes' counts run on a CUDA device; "
                         f"labels on {dev}")
    _check_layout(dev, "labels", labels, (torch.int64,), (I, L, P))
    _check_layout(dev, "x0", x0, (torch.int8,), (I, L))
    _check_layout(dev, "miss", miss, (torch.int8,), (I, L))
    if I > 1 and miss.stride(0) != x0.stride(0):
        raise ValueError(f"x0 and miss at one row stride expected, got "
                         f"{x0.stride(0)} and {miss.stride(0)}")
    count("init.windows")
    copies = torch.zeros((I, K), dtype=torch.int32, device=dev)
    pc = torch.zeros((K, L, 2), dtype=torch.int32, device=dev)
    with span("mc.init.counts"):
        if labels.numel():
            build.launch("mc_allele_counts_planes", dev, labels.data_ptr(),
                         x0.data_ptr(), miss.data_ptr(), copies.data_ptr(),
                         pc.data_ptr(), I, L, P, K, labels.stride(0),
                         x0.stride(0))
    return copies.to(dtype), pc.to(dtype)


def _check_layout(dev, name: str, t: Tensor, types, shape) -> None:
    """Raise unless ``t`` lies on ``dev`` in one of ``types`` at ``shape``
    with its axes after the first contiguous (rows at any stride)."""
    inner = [int(torch.Size(shape[j + 1:]).numel())
             for j in range(1, len(shape))]
    if (t.device != dev or t.dtype not in types
            or tuple(t.shape) != tuple(shape)
            or any(n > 1 and t.stride(j) != st
                   for j, (n, st) in enumerate(zip(shape[1:], inner), 1))):
        raise ValueError(
            f"{name}: {' or '.join(map(str, types))} {tuple(shape)} on "
            f"{dev} with contiguous axes after the rows expected, got "
            f"{t.dtype} {tuple(t.shape)} at strides {t.stride()} on "
            f"{t.device}")


def _int8_planes(md: ModelData) -> bool:
    """Whether ``md`` is a biallelic panel held as int8 count planes (the
    allele-0 plane and the missing plane)."""
    return md.x0 is not None and md.x0.dtype == md.miss.dtype == torch.int8


def plane_codes(x0: Tensor, miss: Tensor, ploidy: int) -> Tensor:
    """The codes ``codes_from_counts`` gives a biallelic window (int8 [I,
    L, P]), from its int8 allele-0 and missing planes alone: copy a is
    slot 0 where a < x0, slot 1 where a < ploidy - miss, and missing (-1)
    after, that is (a >= x0) - 2 (a >= ploidy - miss), in four int8
    passes."""
    a = torch.arange(ploidy, dtype=torch.int8, device=x0.device)
    beyond = (a >= (ploidy - miss)[..., None]).view(torch.int8)
    return torch.sub((a >= x0[..., None]).view(torch.int8), beyond,
                     alpha=2)


def _window_codes(md: ModelData, m0: int, m1: int, ploidy: int) -> Tensor:
    """The allele codes of the loci [m0, m1) of ``md``, made from their
    slice of the counts: on int8 count planes ``plane_codes``."""
    if _int8_planes(md):
        return plane_codes(md.x0[:, m0:m1], md.miss[:, m0:m1], ploidy)
    return codes_from_counts(md.x[:, m0:m1], md.miss[:, m0:m1], ploidy)


def parameters_from_allele_counts(copies: Tensor, pc: Tensor,
                                  md: ModelData, n_copies: int,
                                  eta_constrained: bool = False,
                                  mesh=None) -> Params:
    """Add-one-smoothed parameters from the exact counts of a whole panel
    (``n_copies`` = L x P copies per individual).  Under a ``mesh`` ``md``
    is this rank's block, copies those of its rows and pc of its loci,
    each already summed over the other axis's ranks; the shared eta of
    ``eta_constrained`` sums the rows over the data group."""
    K = copies.shape[1]
    if eta_constrained:
        col = sum_over(mesh, copies.sum(dim=0), DATA_AXIS)
        eta = (1.0 + col) / (md.I_total * n_copies + K)
    else:
        eta = (1.0 + copies) / (n_copies + K)
    pc = torch.where(md.mask[None], pc + 1.0, torch.zeros_like(pc))
    return Params(eta=eta, p=pc / pc.sum(dim=2, keepdim=True))


def parameters_from_allele_partition(labels: Tensor, codes: Tensor,
                                     md: ModelData, K: int,
                                     eta_constrained: bool = False
                                     ) -> Params:
    """Add-one-smoothed counts given per-copy cluster labels
    (initialize_parameters_admixture, rnd_init.c:590-705): eta [I, K], or
    the shared eta [K] under ``eta_constrained``.  Counts are exact
    integers, so bincounts give the JAX package's one-hot sums."""
    _, L, P = codes.shape
    copies, pc = allele_partition_counts(labels, codes, md.M, K, md.dtype)
    return parameters_from_allele_counts(copies, pc, md, L * P,
                                         eta_constrained)


def windowed_allele_start(gen: torch.Generator, md: ModelData, K: int,
                          method: InitMethod, eta_constrained: bool,
                          window: int, ploidy: int, mesh=None) -> Params:
    """An admixture start of ``ploidy`` copies a genotype, drawn and
    counted ``window`` loci at a time from the codes of each window's own
    slice of the counts (``_window_codes``), or, where every copy's label
    is the raw draw, on the card from an int8 panel's count planes
    (``allele_partition_counts_planes``), so that no temporary grows with
    the whole I x L x P.  The counts are those of the whole panel's
    codes for the same labels; the draws come one window after another,
    so with one window they are the whole panel's draw.  Under a ``mesh``
    ``md`` is this rank's block: each window's labels are drawn whole and
    this rank counts its block of them; its start is its block."""
    I, L = md.I_total, md.L_total
    r0, l0 = md.offsets
    count("host.syncs")
    n_max = int(md.n_alleles.max())
    if mesh is not None and mesh.model_shards > 1:
        n_max = int(host_max(n_max, mesh.model_group))
    # the raw draw's windows of int8 planes on the card are counted from
    # the planes themselves, in less time than their codes take to make
    from_planes = (_raw_labels(method, K, n_max)
                   and md.device.type == "cuda" and _int8_planes(md))
    copies = None
    pcs = []
    for lo in range(0, L, window):
        hi = min(L, lo + window)
        g0, g1 = max(lo, l0), max(min(hi, l0 + md.L), lo)  # own loci
        m0, m1 = g0 - l0, max(g1, g0) - l0
        cw = None if from_planes else _window_codes(md, m0, m1, ploidy)
        # drawn on every rank, so that the generators stay in step
        labels = _window_labels(gen, md, cw, K, method, (I, lo, hi),
                                (r0, g0 - lo, m0), n_max,
                                (md.I, m1 - m0, ploidy))
        if g0 >= g1:
            continue
        if from_planes:
            cp, pc = allele_partition_counts_planes(
                labels, md.x0[:, m0:m1], md.miss[:, m0:m1], K, md.dtype)
        else:
            cp, pc = allele_partition_counts(labels, cw, md.M, K, md.dtype)
        copies = cp if copies is None else copies + cp
        pcs.append(pc)
    pc = torch.cat(pcs, dim=1)
    if mesh is not None:
        copies = mesh.sum(copies, MODEL_AXIS)
        pc = mesh.sum(pc, DATA_AXIS)
    return parameters_from_allele_counts(copies, pc, md, L * ploidy,
                                         eta_constrained, mesh)


def random_initialize(gen: torch.Generator, md: ModelData, K: int,
                      method: InitMethod, *, admixture: bool = True,
                      eta_constrained: bool = False,
                      budget: int = None, mesh=None,
                      ploidy: int = 2) -> Params:
    """One random start of the admixture model (allele partitions of
    ``ploidy`` copies a genotype) or of the mixture model (individual
    partitions).  An admixture start is drawn in windows of loci whose
    temporaries fit ``budget`` bytes (``init_window``; one window where the
    whole panel fits).  Under a ``mesh`` this rank's block of the start
    (every rank takes the least window)."""
    md = as_block(md, mesh)
    if admixture:
        window = init_window(md, ploidy, budget)
        if mesh is not None:
            window = world_min(window)
        return windowed_allele_start(gen, md, K, method, eta_constrained,
                                     window, ploidy, mesh)
    if method == InitMethod.RANDOM_PARTITION:
        part = random_individual_partition(gen, md, K)
    else:
        part = random_individual_center(gen, md, K, mesh)
    return parameters_from_partition_mixture(part, md, K, mesh)


def rand_em_chunk(md: ModelData, n: int, hbm_budget: float = 2e9) -> int:
    """Candidates to score at once: the plain scoring step materializes
    about three [I, L*M] tensors per candidate (of the whole panel, so
    that every rank of a mesh scores in the same batches)."""
    itemsize = torch.finfo(md.dtype).bits // 8
    per_cand = 3 * md.I_total * md.L_total * md.M * itemsize
    return max(1, min(n, int(hbm_budget // max(per_cand, 1))))


def with_kmask(params: Params, K: int, width: int) -> Params:
    """Full-layout params of K clusters (a chain batch or one chain)
    zero-padded to ``width`` lanes, with the kmask of their K true
    lanes."""
    p = params.p
    kmask = make_kmask(K, width, p.dtype, p.device)
    return pad_params_k(params, width)._replace(
        kmask=kmask.expand(p.shape[:-3] + (width,)).contiguous())


def random_initialize_dyn(gen: torch.Generator, md: ModelData, K: int,
                          width: int, method: InitMethod, **kw) -> Params:
    """``random_initialize`` of K clusters on the ``width`` lanes of a
    mixed-K lattice: the same draws, padded, with the kmask (the JAX
    package's ``random_initialize_dyn``)."""
    return with_kmask(random_initialize(gen, md, K, method, **kw), K, width)


def rand_em_initialize(gen: torch.Generator, md: ModelData, K: int,
                       cfg: EMConfig, method: InitMethod,
                       n_rand_em_init: int, md_score: ModelData = None,
                       chunk: int = 0,
                       width: int = 0) -> Params:
    """Rand-EM: run n starts through one EM step and keep the start whose
    refined logL is best (randem_initialize_mixture, rnd_init.c:123-161;
    randem_initialize_admixture :412-444).  The winning START, not its
    refined parameters, seeds the fit.  Candidates are drawn on ``md`` and
    scored on ``md_score`` (the collapsed data of a constrained-eta fit;
    ``md`` by default) in batches of ``chunk`` lanes, in the layout the fit
    will run (the p0 layout through the kernel when it is active).  Under a
    mesh ``md`` and ``md_score`` are this rank's block: each candidate is
    this rank's block of it, scored by the meshed step and logL, so every
    rank keeps the same winner.  ``width`` > 0: the start of a mixed-K
    lattice whose shared config is ``cfg``, candidates scored padded to
    ``width`` lanes with their kmask, the winner returned so."""
    from multiclust_tpu_torch.opt.em import model_em_step, \
        model_log_likelihood
    from multiclust_tpu_torch.runtime.multistart import _pad_k, \
        _to_fit_layout

    md = as_block(md, cfg.mesh)
    md_score = md if md_score is None else md_score
    n = n_rand_em_init if K > 1 else 1
    c = chunk or rand_em_chunk(md_score, n)
    cands = [random_initialize(gen, md, K, method, admixture=cfg.admixture,
                               eta_constrained=cfg.eta_constrained,
                               mesh=cfg.mesh, ploidy=cfg.ploidy)
             for _ in range(n)]
    lls = []
    for lo in range(0, n, c):
        batch = map_params(lambda *t: torch.stack(t), *cands[lo:lo + c])
        batch = with_kmask(batch, K, width) if width else _pad_k(batch, cfg)
        batch = _to_fit_layout(batch, md_score, cfg)
        stepped, _, _ = model_em_step(batch, md_score, cfg,
                                      counter="init")
        lls.append(model_log_likelihood(stepped, md_score, cfg)[0])
    count("host.syncs")
    best = cands[int(torch.argmax(torch.cat(lls)))]
    return with_kmask(best, K, width) if width else best


def initialize(gen: torch.Generator, md: ModelData, K: int, cfg: EMConfig,
               method: InitMethod = InitMethod.RANDOM_CENTERS,
               procedure: InitProcedure = InitProcedure.NOTHING,
               n_rand_em_init: int = 50,
               md_score: ModelData = None) -> Params:
    """One start (initialize_model, rnd_init.c:54-89), unbatched and
    unpadded: eta [I, K] (admixture) or [K] (mixture, constrained eta), p
    [K, L, M]; under a mesh (cfg.mesh) this rank's block of it, ``md``
    being this rank's block or the whole panel.  ``md_score`` is where
    Rand-EM scores its candidates."""
    md = as_block(md, cfg.mesh)
    if procedure == InitProcedure.RAND_EM:
        return rand_em_initialize(gen, md, K, cfg, method, n_rand_em_init,
                                  md_score=md_score)
    return random_initialize(gen, md, K, method, admixture=cfg.admixture,
                             eta_constrained=cfg.eta_constrained,
                             mesh=cfg.mesh, ploidy=cfg.ploidy)


def initialize_dyn(gen: torch.Generator, md: ModelData, K: int, width: int,
                   cfg: EMConfig,
                   method: InitMethod = InitMethod.RANDOM_CENTERS,
                   procedure: InitProcedure = InitProcedure.NOTHING,
                   n_rand_em_init: int = 50,
                   md_score: ModelData = None) -> Params:
    """``initialize`` of K clusters for a mixed-K lattice of ``width``
    lanes whose shared config is ``cfg``: the same start, padded, with its
    kmask (the JAX package's ``initialize_dyn``,
    multiclust_tpu/init/random.py:393-450)."""
    md = as_block(md, cfg.mesh)
    if procedure == InitProcedure.RAND_EM:
        return rand_em_initialize(gen, md, K, cfg, method, n_rand_em_init,
                                  md_score=md_score, width=width)
    return random_initialize_dyn(gen, md, K, width, method,
                                 admixture=cfg.admixture,
                                 eta_constrained=cfg.eta_constrained,
                                 mesh=cfg.mesh, ploidy=cfg.ploidy)


def codes_from_counts(counts: Tensor, miss: Tensor, ploidy: int) -> Tensor:
    """[I, L, P] allele-slot index per copy (-1 for missing copies), int8
    (int16 when a locus has more than 127 slots): a biobank panel's codes
    are then as large as its data, not eight times that.  Computed where
    ``counts`` [I, L, M] and ``miss`` [I, L] lie (the device, as
    codes_from_counts_jax does; the host numpy version costs seconds at
    cohort scale).  Copies are exchangeable, so the count vector is
    expanded in slot order."""
    dev = counts.device
    small = torch.int8 if counts.shape[2] <= 127 and ploidy <= 127 \
        else torch.int16
    a = torch.arange(ploidy, dtype=small, device=dev)
    cum = torch.zeros(counts.shape[:2], dtype=small, device=dev)
    codes = torch.zeros(counts.shape[:2] + (ploidy,), dtype=small,
                        device=dev)
    # codes[i,l,a] = number of slots m with cum[i,l,m] <= a; the running
    # sum over the few slots is written out because torch.cumsum over an
    # innermost dim of 2 took 0.19 s on an H100 at 16384 x 2048
    for m in range(counts.shape[2]):
        cum += counts[..., m].to(small)
        codes += cum[..., None] <= a
    observed = (ploidy - miss.to(torch.int32)).to(small)          # [I, L]
    return torch.where(a < observed[..., None], codes,
                       torch.full((), -1, dtype=small, device=dev))
