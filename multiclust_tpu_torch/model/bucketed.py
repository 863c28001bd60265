"""Jagged-M locus bucketing (multiclust_tpu/model/bucketed.py).

The dense layout pads every locus to the panel-wide M_max (``x[I, L,
M_max]``, ``dat->uniquealleles``, read_file.c:443-600).  A mixed panel,
SNP blocks next to microsatellites with 2-40 alleles, then spends work and
memory in proportion to sum_l (M_max - M_l) / sum_l M_l on lanes that are
always zero.  Bucketing groups loci by allele count: the loci are permuted
into ascending-M_l order once, split into a few contiguous buckets, and
each bucket keeps only ITS OWN allele ceiling M_b.

An EM step then runs one pass per bucket: the per-individual statistics
A[i, k] and the logL terms t[i] (admixture), or the scores s[i, k]
(mixture), add up over the buckets, while the p update is local to each
bucket's loci; eta is updated once, from the merged sums.  Parameters
carry p as a TUPLE of per-bucket tensors [.., K, L_b, M_b]; opt/em.py's
tree helpers and ``model.common.map_params`` recurse into it, so only the
model steps and the projections look at the layout.

The port pads nothing: its plan is the JAX package's ``tight=True`` plan
(``pad_Ls`` = the real L_b), and the TPU lane rules ``_pad_L`` /
``lane_pad`` have no counterpart.  Nor does ``x_lanes``, the JAX package's
concatenation of every bucket for one Pallas launch: the port chains one
launch per bucket, each reading its bucket's own contiguous counts, so the
counts are stored once, at the tight size.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from multiclust_tpu_torch.model.common import ModelData, Params
from multiclust_tpu_torch.ops.build import count

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class JaggedPlan:
    """Host-side bucketing plan."""

    order: np.ndarray          # [L] original locus at sorted position j
    inv_order: np.ndarray      # [L] sorted position of original locus l
    ranges: Tuple[Tuple[int, int], ...]  # per-bucket [lo, hi) sorted pos
    Ms: Tuple[int, ...]        # per-bucket allele ceiling
    M_full: int                # the dense M_max

    @property
    def n_buckets(self) -> int:
        return len(self.ranges)

    @property
    def Ls(self) -> Tuple[int, ...]:
        return tuple(hi - lo for lo, hi in self.ranges)

    @property
    def lanes(self) -> int:
        """Allele lanes of the bucketed layout, sum_b L_b M_b."""
        return sum(L_b * M_b for L_b, M_b in zip(self.Ls, self.Ms))

    def describe(self) -> str:
        L = self.order.shape[0]
        return (f"{self.n_buckets} buckets, M_b {list(self.Ms)}, L_b "
                f"{list(self.Ls)}: {self.lanes} lanes against "
                f"{L * self.M_full} dense")


def plan_buckets(n_alleles: np.ndarray, M_full: int, min_bucket: int = 64,
                 max_buckets: int = 8) -> Optional[JaggedPlan]:
    """Group loci by allele count into at most ``max_buckets`` buckets of
    at least ``min_bucket`` loci (small runs merge UPWARD into the next
    larger-M bucket, which only adds padding, never drops lanes); None
    for a single group."""
    n_alleles = np.asarray(n_alleles)
    L = n_alleles.shape[0]
    order = np.argsort(n_alleles, kind="stable")
    sorted_m = n_alleles[order]
    # distinct-M run boundaries in sorted order
    cuts = [0] + list(np.nonzero(np.diff(sorted_m))[0] + 1) + [L]
    if len(cuts) <= 2:
        return None
    ranges = []
    lo = 0
    for hi in cuts[1:]:
        if hi - lo >= min_bucket or hi == L:
            ranges.append((lo, hi))
            lo = hi
    if lo < L:
        ranges.append((lo, L))
    # cap the launch count: merge the smallest bucket (but the last) upward
    while len(ranges) > max_buckets:
        sizes = [hi - lo for lo, hi in ranges]
        j = int(np.argmin(sizes[:-1]))
        ranges[j] = (ranges[j][0], ranges[j + 1][1])
        del ranges[j + 1]
    if len(ranges) <= 1:
        return None
    inv = np.empty(L, np.int64)
    inv[order] = np.arange(L)
    return JaggedPlan(order=order, inv_order=inv,
                      ranges=tuple((int(a), int(b)) for a, b in ranges),
                      Ms=tuple(int(sorted_m[hi - 1]) for _, hi in ranges),
                      M_full=int(M_full))


def jagged_savings(n_alleles: np.ndarray) -> float:
    """Fraction of the dense layout's cells that are padding:
    sum_l (M_max - M_l) / (L M_max)."""
    n_alleles = np.asarray(n_alleles, np.int64)
    if n_alleles.size == 0:
        return 0.0
    M = int(n_alleles.max())
    return float(np.sum(M - n_alleles) / (n_alleles.size * M))


def worth_bucketing(n_alleles: np.ndarray, threshold: float = 0.25) -> bool:
    """Bucketing pays when the dense padding crosses ``threshold`` (the
    launches of more buckets eat smaller gains)."""
    return jagged_savings(n_alleles) >= threshold


def plan_for(md: ModelData) -> Optional[JaggedPlan]:
    """The plan a fit on ``md`` runs under, as the JAX package's
    ``_prepare_fit_data`` decides it (multistart.py:734-772): panels with
    M > 2 whose padding ``worth_bucketing``; None for the dense layout.
    Reads n_alleles from the device once."""
    if md.M <= 2:
        return None
    count("host.syncs")
    n_all = md.n_alleles.cpu().numpy()
    if not worth_bucketing(n_all):
        return None
    return plan_buckets(n_all, md.M)


class BucketedData(NamedTuple):
    """A panel in plan order, one ModelData a bucket, each with its own
    contiguous counts [I, L_b, M_b] (``x_lanes`` is then the generic
    kernels' [I, L_b M_b] view), miss [I, L_b], mask [L_b, M_b] and
    n_alleles; ``c`` the whole panel's missing totals."""

    buckets: Tuple[ModelData, ...]
    perm: Tensor       # [L] original locus at each sorted position
    inv: Tensor        # [L] sorted position of each original locus
    c: Tensor          # [I] missing totals, compute dtype
    plan: JaggedPlan

    @property
    def I(self) -> int:  # noqa: E743
        return self.buckets[0].I

    @property
    def L(self) -> int:
        return sum(b.L for b in self.buckets)

    @property
    def M(self) -> int:
        return max(b.M for b in self.buckets)

    @property
    def I_total(self) -> int:
        """Individuals of the whole panel (a mesh splits only its rows)."""
        return self.buckets[0].I_total

    @property
    def L_total(self) -> int:
        return self.L

    @property
    def device(self) -> torch.device:
        return self.c.device

    @property
    def dtype(self) -> torch.dtype:
        return self.buckets[0].dtype


def bucketize_model_data(md: ModelData, plan: JaggedPlan) -> BucketedData:
    """``md``'s loci gathered into the plan's buckets, once, before any EM
    step: each bucket's tensors are new contiguous copies at its own M_b."""
    perm = torch.as_tensor(plan.order, device=md.device)
    buckets = []
    for (lo, hi), M_b in zip(plan.ranges, plan.Ms):
        idx = perm[lo:hi]
        miss = md.miss.index_select(1, idx)
        buckets.append(ModelData(
            x=md.x[..., :M_b].index_select(1, idx).contiguous(), miss=miss,
            mask=md.mask[:, :M_b].index_select(0, idx),
            n_alleles=md.n_alleles.index_select(0, idx),
            c=miss.sum(dim=1, dtype=md.dtype), block=md.block))
    return BucketedData(buckets=tuple(buckets), perm=perm,
                        inv=torch.as_tensor(plan.inv_order, device=md.device),
                        c=md.c, plan=plan)


def split_params_like(params: Params, bd: BucketedData) -> Params:
    """Dense p [.., K, L, M] -> the per-bucket tuple, zero off each
    bucket's mask; a no-op on split params.  eta and a kmask ride
    along."""
    if isinstance(params.p, tuple):
        return params
    parts = []
    lo = 0
    for b in bd.buckets:
        part = params.p[..., :b.M].index_select(-2, bd.perm[lo:lo + b.L])
        parts.append(torch.where(b.mask, part, torch.zeros_like(part)))
        lo += b.L
    return params._replace(p=tuple(parts))


def merge_params_like(params: Params, bd: BucketedData) -> Params:
    """Inverse of ``split_params_like``: the per-bucket tuple -> dense
    [.., K, L, M_full] in ORIGINAL locus order, zero off the mask."""
    if not isinstance(params.p, tuple):
        return params
    M_full = bd.plan.M_full
    p_sorted = torch.cat([F.pad(pb, (0, M_full - pb.shape[-1]))
                          for pb in params.p], dim=-2)
    return params._replace(p=p_sorted.index_select(-2, bd.inv))
