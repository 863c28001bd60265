"""Shared model-side containers and helpers (multiclust_tpu/model/common.py).

The parameterization follows the reference: ``eta[I, K]`` per-individual
admixture proportions (a K-vector ``eta[K]`` for the mixture model and for
constrained-eta admixture) and ``p[K, L, M]`` per-cluster allele
frequencies on the padded dense allele axis.  The port writes the chain
batch out as a leading dimension: the model functions take ``eta[B, I, K]``
(or ``eta[B, K]``) and ``p[B, K, L, M]`` (or the biallelic p0 layout
``p[B, Kp, L]``), where the JAX package vmaps over unbatched arrays.  A
batched K-vector eta has as many dims as an unbatched per-individual one,
so which it is follows from the EMConfig (the mixture, or
``eta_constrained``), never from ``eta.ndim``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

Tensor = torch.Tensor


class Params(NamedTuple):
    """Model parameters; ``map_params`` treats every tensor uniformly."""

    eta: Tensor  # [..., I, K], or [..., K] (mixture, constrained eta)
    # [..., K, L, M] full, [..., Kp, L] p0 layout, or a tuple of per-bucket
    # [..., K, L_b, M_b] (model/bucketed.py)
    p: Union[Tensor, Tuple[Tensor, ...]]
    # [..., Kp] 1.0/0.0 mask of a chain's TRUE cluster lanes, the chains
    # of a mixed-K K-sweep lattice (runtime/ksweep.py) each padded to the
    # lattice's lanes: carried as data, so one batch runs every K (the JAX
    # package's Params.kmask, multiclust_tpu/model/common.py:26-35).  None:
    # cfg.k_true alone sets the lanes.  Float, not bool, so the vector
    # arithmetic of opt/em.py treats it as inert data: a secant difference
    # of it is exactly 0, and an accelerated point keeps its base's mask.
    kmask: Optional[Tensor] = None

    @property
    def K(self) -> int:
        return self.eta.shape[-1]


def _map_leaves(fn, *xs):
    if isinstance(xs[0], tuple):
        return tuple(_map_leaves(fn, *parts) for parts in zip(*xs))
    return fn(*xs)


def map_params(fn, *ps: Params) -> Params:
    """Apply ``fn`` tensor by tensor across one or more Params (into each
    bucket of a bucketed p, and to the kmask where the first has one)."""
    return Params(eta=fn(*(q.eta for q in ps)),
                  p=_map_leaves(fn, *(q.p for q in ps)),
                  kmask=(None if ps[0].kmask is None
                         else fn(*(q.kmask for q in ps))))


def param_leaves(params: Params) -> Tuple[Tensor, ...]:
    """The tensors of ``params``: eta, then p or each bucket's p (not the
    kmask, which is no parameter)."""
    p = params.p
    return (params.eta,) + (p if isinstance(p, tuple) else (p,))


def is_bi_repr(params: Params) -> bool:
    """p0 layout marker: p has as many dims as eta ([.., Kp, L])."""
    return (not isinstance(params.p, tuple)
            and params.p.ndim == params.eta.ndim)


class ModelData(NamedTuple):
    """Device-side genotype tensors consumed by the E/M steps.

    Biallelic panels (every locus with two alleles) also carry
    ``x0``/``x1``, the two per-allele [I, L] count planes the biallelic
    kernel reads, made once at construction; ``x`` is then a view of those
    planes, so the counts are stored once.  Every other panel keeps ``x``
    contiguous, and ``x_lanes`` is its [I, L*M] view for the generic
    kernel.
    ``c`` holds the per-individual missing-copy totals in the compute
    dtype, summed once after the cast (int8 sums overflow above 127).
    """

    x: Tensor          # [I, L, M] counts (compute dtype, or int8 on CUDA)
    miss: Tensor       # [I, L] missing-copy counts (same storage rule)
    mask: Tensor       # [L, M] bool valid allele lanes
    n_alleles: Tensor  # [L] int32 valid lanes per locus
    c: Tensor          # [I] missing totals, compute dtype
    x0: Optional[Tensor] = None  # [I, L] allele-0 counts, storage dtype
    x1: Optional[Tensor] = None  # [I, L] allele-1 counts, storage dtype
    # a rank's block of a meshed panel (runtime/mesh.shard_model_data, or
    # model_data_from_block for a block read per process): the global I
    # and L and the block's offsets; None for a whole panel
    block: Optional[object] = None

    @property
    def I(self) -> int:  # noqa: E743
        return self.x.shape[0]

    @property
    def L(self) -> int:
        return self.x.shape[1]

    @property
    def M(self) -> int:
        return self.x.shape[2]

    @property
    def I_total(self) -> int:
        """Individuals of the whole panel (of the block when unsharded)."""
        return self.block.I if self.block is not None else self.I

    @property
    def L_total(self) -> int:
        """Loci of the whole panel."""
        return self.block.L if self.block is not None else self.L

    @property
    def offsets(self) -> Tuple[int, int]:
        """(first row, first locus) of the block in the whole panel; (0, 0)
        for a whole panel."""
        b = self.block
        return (0, 0) if b is None else (b.row0, b.locus0)

    @property
    def device(self) -> torch.device:
        return self.x.device

    @property
    def dtype(self) -> torch.dtype:
        """Compute dtype: miss carries it on the CPU/f64 paths; int8
        storage is only ever paired with float32 compute."""
        if self.miss.dtype.is_floating_point:
            return self.miss.dtype
        if self.x.dtype.is_floating_point:
            return self.x.dtype
        return torch.float32

    @property
    def x2d(self) -> Tensor:
        """[I, L*M] counts in the compute dtype."""
        return self.x.reshape(self.I, -1).to(self.dtype)

    @property
    def x_lanes(self) -> Tensor:
        """[I, L*M] counts in the storage dtype (int8 on CUDA), a view of
        ``x``: the generic kernel casts in registers, so no step makes a
        float copy.  Raises on the biallelic planes layout, which the
        generic step never reads."""
        return self.x.view(self.I, -1)


class Lattice(NamedTuple):
    """The data of a replicate lattice (stats/bootstrap.py): an R x B
    lattice of chains in which lanes r*B .. r*B + B - 1 of every state
    tensor fit replicate r on ``reps[r]``.  The replicates share miss,
    mask, n_alleles and c; only their counts differ.  opt/em.py steps the
    replicates in ``live`` one after another, each through the routed
    step of a B-chain batch, and leaves the lanes of the others as they
    are (every one of them has stopped)."""

    reps: tuple        # ModelData per replicate
    B: int             # chains per replicate
    live: frozenset    # replicates with a running chain

    @property
    def mask(self) -> Tensor:
        return self.reps[0].mask


def _to_device(a, device, dtype: torch.dtype) -> Tensor:
    """An array-like as a ``dtype`` tensor on ``device``.  A tensor stays
    where it is made (no round trip through numpy); a host array is cast
    on the host when that narrows it, so the wide type is never
    uploaded."""
    if not torch.is_tensor(a):
        a = torch.as_tensor(np.asarray(a))
        if a.element_size() > torch.empty((), dtype=dtype).element_size():
            a = a.to(dtype)
    return a.to(device=device, dtype=dtype)


# cells of a block of rows that ``row_sums`` casts at a time
ROW_SUM_CELLS = 1 << 26


def row_sums(t: Tensor, dtype: torch.dtype) -> Tensor:
    """``t.sum(dim=1, dtype=dtype)`` of an [I, L] tensor, a block of rows
    at a time: a sum into another dtype casts its whole input first, which
    for a biobank panel's int8 plane is a transient of [I, L] floats."""
    rows = max(1, ROW_SUM_CELLS // max(t.shape[1], 1))
    if t.shape[0] <= rows:
        return t.sum(dim=1, dtype=dtype)
    return torch.cat([t[lo:lo + rows].sum(dim=1, dtype=dtype)
                      for lo in range(0, t.shape[0], rows)])


def make_model_data(x, miss, mask, n_alleles, *, dtype: torch.dtype,
                    device, storage_dtype: Optional[torch.dtype] = None,
                    planes: Optional[bool] = None) -> ModelData:
    """Build ModelData from array-likes (numpy or tensors).

    ``storage_dtype=torch.int8`` keeps x (and, for float32 compute, miss)
    as int8 on the device; counts never exceed the ploidy, so the cast is
    exact.  ``planes`` overrides whether the counts are held as the two
    biallelic planes (by default: M = 2 and every locus given has two
    alleles), so that every block of a panel takes the panel's layout."""
    device = torch.device(device)
    miss_dtype = (storage_dtype if (storage_dtype is not None
                                    and dtype == torch.float32) else dtype)
    mt = _to_device(miss, device, miss_dtype)
    n_all = torch.as_tensor(np.asarray(n_alleles) if not torch.is_tensor(
        n_alleles) else n_alleles).to(device=device, dtype=torch.int32)
    if planes is None:
        planes = np.shape(x)[2] == 2 and bool((n_all == 2).all())
    x0 = x1 = None
    if planes:
        # the counts are held once, as two contiguous planes; x is a view.
        # A host array is split into planes on the host, so the device
        # never holds the panel twice
        if torch.is_tensor(x):
            planes = _to_device(x, device, storage_dtype or dtype).permute(
                2, 0, 1).contiguous()                 # [2, I, L]
        else:
            planes = _to_device(
                np.ascontiguousarray(np.moveaxis(np.asarray(x), 2, 0)),
                device, storage_dtype or dtype)
        x0, x1 = planes[0], planes[1]
        xt = planes.permute(1, 2, 0)
    else:
        xt = _to_device(x, device, storage_dtype or dtype)
    if torch.is_tensor(miss):
        c = row_sums(mt, dtype)
    else:
        # a host panel's totals are summed on the host: summing the int8
        # miss on the card in ``dtype`` makes a [I, L] transient of dtype
        c = torch.as_tensor(np.asarray(miss).sum(axis=1)).to(device=device,
                                                              dtype=dtype)
    return ModelData(
        x=xt, miss=mt,
        mask=torch.as_tensor(np.asarray(mask) if not torch.is_tensor(mask)
                             else mask).to(device=device, dtype=torch.bool),
        n_alleles=n_all, c=c, x0=x0, x1=x1)


def model_data_from_planes(planes: Tensor, miss: Tensor, *,
                           dtype: torch.dtype = torch.float32) -> ModelData:
    """ModelData of a strictly biallelic panel from its two count planes
    [2, I, L] and miss [I, L], tensors in their storage dtype already on
    the device (a panel generated there): used as they are, with no copy
    and no round trip through the host."""
    if planes.dim() != 3 or planes.shape[0] != 2 \
            or planes.shape[1:] != miss.shape or not planes.is_contiguous():
        raise ValueError(f"planes [2, I, L] contiguous and miss [I, L] "
                         f"expected, got {tuple(planes.shape)} and "
                         f"{tuple(miss.shape)}")
    L = planes.shape[2]
    dev = planes.device
    return ModelData(
        x=planes.permute(1, 2, 0), miss=miss,
        mask=torch.ones((L, 2), dtype=torch.bool, device=dev),
        n_alleles=torch.full((L,), 2, dtype=torch.int32, device=dev),
        c=row_sums(miss, dtype), x0=planes[0], x1=planes[1])


def model_data_from_dataset(ds, dtype: torch.dtype = torch.float32,
                            device="cpu",
                            storage_dtype: Optional[torch.dtype] = None
                            ) -> ModelData:
    """Lift a host Dataset (io/dataset.py) onto ``device``."""
    return make_model_data(ds.counts, ds.miss, ds.mask, ds.n_alleles,
                           dtype=dtype, device=device,
                           storage_dtype=storage_dtype)


def model_data_from_block(counts: np.ndarray, miss: np.ndarray,
                          n_alleles: np.ndarray, I_total: int, row0: int,
                          loci: Tuple[int, int], *,
                          dtype: torch.dtype = torch.float32, device="cpu",
                          storage_dtype: Optional[torch.dtype] = None
                          ) -> ModelData:
    """ModelData of one rank's block of a meshed panel of ``I_total``
    individuals, from the host counts [I_b, L, M_b] and miss [I_b, L] of
    the rows it parsed (from row ``row0``, every locus) and the panel's
    n_alleles [L]: ``c`` is taken over every locus before the loci are
    sliced, the allele lanes are padded to the panel's M, and only the
    loci [l0, l1) = ``loci`` are uploaded.  ``block`` (runtime/mesh.Block)
    marks the result as a block, which no fit slices again."""
    from multiclust_tpu_torch.runtime.mesh import Block

    n_alleles = np.asarray(n_alleles, np.int64)
    L = n_alleles.shape[0]
    M = int(n_alleles.max()) if L else 0
    l0, l1 = loci
    x = np.ascontiguousarray(counts[:, l0:l1])
    if x.shape[2] < M:
        x = np.pad(x, ((0, 0), (0, 0), (0, M - x.shape[2])))
    own = n_alleles[l0:l1]
    md = make_model_data(
        x, np.ascontiguousarray(miss[:, l0:l1]),
        np.arange(M)[None, :] < own[:, None], own, dtype=dtype,
        device=device, storage_dtype=storage_dtype,
        planes=M == 2 and bool((n_alleles == 2).all()))
    c = torch.as_tensor(np.asarray(miss).sum(axis=1))
    return md._replace(c=c.to(device=md.device, dtype=dtype),
                       block=Block(I=I_total, L=L, row0=row0, locus0=l0))


class EMConfig(NamedTuple):
    """Static EM configuration (the JAX package's model/common.EMConfig
    without the interpret mode)."""

    admixture: bool = False
    eta_constrained: bool = False
    do_projection: bool = True
    eta_lower_bound: float = 1e-8
    p_lower_bound: float = 1e-8
    abs_error: float = 1e-4
    rel_error: float = 0.0
    max_iter: int = 0
    accel_scheme: int = 0
    q: int = 1
    n_init_iter: int = 0
    adjust_step: int = 0
    monotonicity: str = "warn"
    # multiplier on the params-dtype rounding noise floor (opt/em.py)
    noise_factor: float = 8.0
    # "on": float32 steps go through the CUDA kernels (admixture:
    # ops/fullstep_bi.py or ops/fullstep.py; biallelic mixture:
    # ops/mixture_bi.py; their plain versions for CPU tensors); "off":
    # the plain matmul steps
    use_pallas: str = "off"
    has_missing: bool = True
    biallelic: bool = False
    # allele copies per (i, l), pinned from the data (Options.synchronize):
    # the missing-free biallelic mixture folds x1 = ploidy - x0
    ploidy: int = 2
    # true cluster count when the params carry K-padded lanes (pads zero)
    k_true: int = 0
    # 1 = check stop() every iteration, N > 1 = every N-th, 0 = adaptive
    check_interval: int = 1
    # bytes the biallelic step's partials may take (the router's budget,
    # ops/fullstep_bi.pick_route), read from the device once per fit;
    # 0 = ask the device at each step
    scratch_budget: int = 0
    # the process mesh of a multi-device fit (runtime/mesh.Mesh): the
    # steps, logL and EM reductions then run on this rank's block and
    # write their sums over the data and model groups out; None = one
    # device
    mesh: object = None

    @property
    def data_shards(self) -> int:
        return self.mesh.data_shards if self.mesh is not None else 1

    @property
    def model_shards(self) -> int:
        return self.mesh.model_shards if self.mesh is not None else 1

    @property
    def bi_repr_active(self) -> bool:
        """Chains carry the biallelic p0 layout (p [.., Kp, L]); not above
        the kernels' Kp (ops/fullstep_bi.KP_MAX), where the fit takes the
        plain step on the full layout, as the JAX package's shapes that do
        not tile stay on it (its multistart._to_bi_repr)."""
        from multiclust_tpu_torch.ops.fullstep_bi import KP_MAX
        return (self.use_pallas != "off" and self.admixture
                and not self.eta_constrained and self.biallelic
                and bool(self.k_true)
                and k_padded_size(self.k_true, 32) <= KP_MAX)


def collapse_for_constrained(md: ModelData) -> ModelData:
    """Constrained-eta admixture sufficient statistics: with shared mixing
    proportions the step depends on the data only through the column sums
    sum_i x_ilm and sum_i miss_il, so the fit runs on a collapsed 1-row
    dataset in the compute dtype (the sums overflow int8)."""
    dtype = md.dtype
    miss = md.miss.to(dtype).sum(dim=0, keepdim=True)
    return ModelData(x=md.x.to(dtype).sum(dim=0, keepdim=True), miss=miss,
                     mask=md.mask, n_alleles=md.n_alleles,
                     c=miss.sum(dim=1))


# temporaries that grow with I x L are made one column window at a time,
# each window holding about this many bytes of them
WINDOW_BYTES = 1 << 30


def column_window(L: int, bytes_per_column: int,
                  budget: int = WINDOW_BYTES) -> int:
    """Columns per window so that ``bytes_per_column`` a column stays
    under ``budget`` bytes: L when the whole panel fits."""
    return max(1, min(L, int(budget) // max(int(bytes_per_column), 1)))


def k_padded_size(K: int, multiple: int = 128) -> int:
    """Lane-aligned padded cluster count for the K-padded layout."""
    return -(-K // multiple) * multiple


def pad_params_k(params: Params, k_pad: int) -> Params:
    """Zero-pad full-layout params to ``k_pad`` clusters (batched OK):
    eta [..., I, K] -> [..., I, k_pad]; p [..., K, L, M] -> [..., k_pad, L,
    M].  Pads contribute nothing and the masked projections keep them 0."""
    K = params.p.shape[-3]
    if k_pad <= K:
        return params
    d = k_pad - K
    eta = torch.nn.functional.pad(params.eta, (0, d))
    p = torch.nn.functional.pad(params.p, (0, 0, 0, 0, 0, d))
    kmask = (None if params.kmask is None
             else torch.nn.functional.pad(params.kmask, (0, d)))
    return Params(eta=eta, p=p, kmask=kmask)


def unpad_params_k(params: Params, k_true: int) -> Params:
    """Inverse of pad_params_k (batched OK); drops any kmask."""
    K = params.p.shape[-3]
    if k_true >= K:
        return params._replace(kmask=None)
    return Params(eta=params.eta[..., :k_true],
                  p=params.p[..., :k_true, :, :])


def make_kmask(K: int, Kp: int, dtype=torch.float32, device="cpu") -> Tensor:
    """[Kp] 1.0/0.0 true-lane mask."""
    return (torch.arange(Kp, device=device) < K).to(dtype)


def safe_log(x: Tensor, valid: Optional[Tensor] = None) -> Tensor:
    """log with zeros (and lanes outside ``valid``) mapped to a 0
    contribution."""
    ok = x > 0
    if valid is not None:
        ok = ok & valid
    return torch.where(ok, torch.log(torch.where(ok, x, torch.ones_like(x))),
                       torch.zeros_like(x))
