"""Dense genotype dataset.

The reference stores sufficient statistics in a jagged ``ILM[i][l][m]`` array
(read_file.c:633-663) where ``m`` ranges over the unique alleles at locus l
and, when locus l has missing observations, slot ``m=0`` holds the count of
missing copies (alleles sorted so MISSING=-9 sorts first; read_file.c:438).

The representation is a dense padded count tensor plus an explicit
missing-count matrix:

* ``counts[I, L, M]`` - observed allele-copy counts, ``M = max_l M_l``; lanes
  ``m >= n_alleles[l]`` are padding (always zero).
* ``miss[I, L]`` - number of missing copies, so
  ``counts[i,l].sum() + miss[i,l] == ploidy``.
* ``n_alleles[L]`` - observed distinct alleles per locus (the reference's
  ``uniquealleles`` minus the missing slot).

Padding lanes carry zero probability mass; all per-locus normalizations and
simplex projections mask them out.  This buys rectangular shapes, which the
E/M steps' dense contractions need.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from multiclust_tpu_torch.config import MISSING


@dataclasses.dataclass
class Dataset:
    """Genotype data with dense sufficient statistics (host-side, numpy)."""

    counts: np.ndarray            # [I, L, M] observed allele-copy counts
    miss: np.ndarray              # [I, L] missing-copy counts
    n_alleles: np.ndarray         # [L] observed distinct alleles per locus
    ploidy: int
    # allele vocabulary: L_alleles[l][m] = original allele label of slot m
    # (sorted ascending, missing excluded); None when alleles are indices (-I)
    L_alleles: Optional[List[np.ndarray]] = None
    # raw haplotype matrix [I*ploidy, L] with MISSING sentinels, for
    # write_data() round trips; optional.
    IL: Optional[np.ndarray] = None
    names: Optional[List[str]] = None    # individual names
    locales: Optional[np.ndarray] = None  # [I] locale index per individual
    pops: Optional[List[str]] = None     # locale names

    @property
    def I(self) -> int:  # noqa: E743 - matches reference naming
        return self.counts.shape[0]

    @property
    def L(self) -> int:
        return self.counts.shape[1]

    @property
    def M(self) -> int:
        return self.counts.shape[2]

    @property
    def missing_data(self) -> bool:
        return bool(self.miss.any())

    @property
    def mask(self) -> np.ndarray:
        """[L, M] bool - valid (non-padding) allele lanes."""
        return np.arange(self.M)[None, :] < self.n_alleles[:, None]

    @property
    def has_missing_slot(self) -> np.ndarray:
        """[L] bool - locus has a missing slot in the reference layout.

        The reference gives locus l a leading MISSING slot iff any individual
        has a missing observation there (summarize_alleles,
        read_file.c:520-533).  Needed for output-format parity
        (uniquealleles[l] = n_alleles[l] + has_missing_slot[l]).
        """
        return self.miss.any(axis=0)

    @property
    def locale_sizes(self) -> Optional[np.ndarray]:
        if self.locales is None or self.pops is None:
            return None
        return np.bincount(self.locales, minlength=len(self.pops))

    def n_parameters(self, K: int, admixture: bool,
                     eta_constrained: bool) -> int:
        """Free-parameter count for AIC/BIC (multiclust.c:1267-1277)."""
        eta_params = (self.I * (K - 1) if admixture and not eta_constrained
                      else K - 1)
        p_params = int(np.sum(self.n_alleles - 1)) * K
        return eta_params + p_params

    def validate(self) -> None:
        assert self.counts.shape[:2] == self.miss.shape
        total = self.counts.sum(axis=2) + self.miss
        assert (total == self.ploidy).all(), "counts+miss must equal ploidy"
        assert (self.counts[~np.broadcast_to(
            self.mask[None], self.counts.shape)] == 0).all()


def from_haplotypes(
    IL: np.ndarray,
    ploidy: int,
    alleles_are_indices: bool = False,
    imputation_method: int = 0,
    names: Optional[List[str]] = None,
    locales: Optional[np.ndarray] = None,
    pops: Optional[List[str]] = None,
) -> Dataset:
    """Summarize alleles and build sufficient statistics.

    ``IL`` is the [I*ploidy, L] haplotype matrix with MISSING sentinels; rows
    i*ploidy..(i+1)*ploidy-1 belong to individual i.  Replaces
    ``summarize_alleles`` (read_file.c:443-600, per-locus bubble sort) and
    ``sufficient_statistics`` (read_file.c:633-663) with vectorized numpy.

    ``imputation_method``: nonzero imputes missing haplotypes with the
    locus-wise modal allele (read_file.c:487-509, :545-554) before counting.
    """
    IL = np.asarray(IL)
    n_hap, L = IL.shape
    if n_hap % ploidy:
        raise ValueError(f"number of haplotypes ({n_hap}) is not a multiple "
                         f"of ploidy ({ploidy})")
    I = n_hap // ploidy

    IL = IL.copy()
    missing = IL == MISSING

    if alleles_are_indices:
        if (IL[~missing] < 0).any():
            raise ValueError("alleles cannot be negative indices (-I)")
        n_alleles = np.zeros(L, dtype=np.int64)
        for l in range(L):
            obs = IL[~missing[:, l], l]
            n_alleles[l] = obs.max() + 1 if obs.size else 0
        L_alleles = None
        codes = IL  # already slot indices
    else:
        L_alleles = []
        codes = np.zeros_like(IL)
        n_alleles = np.zeros(L, dtype=np.int64)
        for l in range(L):
            obs_mask = ~missing[:, l]
            alleles = np.unique(IL[obs_mask, l])
            L_alleles.append(alleles)
            n_alleles[l] = alleles.size
            codes[obs_mask, l] = np.searchsorted(alleles, IL[obs_mask, l])

    if imputation_method:
        for l in range(L):
            if not missing[:, l].any():
                continue
            obs = codes[~missing[:, l], l]
            if obs.size == 0:
                continue
            bc = np.bincount(obs, minlength=n_alleles[l])
            mode = int(bc.argmax())  # ties -> smallest allele, as reference
            codes[missing[:, l], l] = mode
            IL[missing[:, l], l] = (L_alleles[l][mode] if L_alleles is not None
                                    else mode)
        missing = np.zeros_like(missing)

    M = int(n_alleles.max()) if L else 0
    counts = np.zeros((I, L, M), dtype=np.int32)
    miss = np.zeros((I, L), dtype=np.int32)
    hap_of = np.repeat(np.arange(I), ploidy)
    for a in range(ploidy):
        rows = np.arange(I) * ploidy + a
        code_a = codes[rows]          # [I, L]
        miss_a = missing[rows]        # [I, L]
        ii, ll = np.nonzero(~miss_a)
        np.add.at(counts, (ii, ll, code_a[ii, ll]), 1)
        miss += miss_a.astype(np.int32)
    del hap_of

    ds = Dataset(counts=counts, miss=miss, n_alleles=n_alleles, ploidy=ploidy,
                 L_alleles=L_alleles, IL=IL, names=names, locales=locales,
                 pops=pops)
    ds.validate()
    return ds


def from_counts(counts: np.ndarray, miss: np.ndarray, ploidy: int,
                n_alleles: Optional[np.ndarray] = None,
                **kw) -> Dataset:
    """Build a Dataset directly from count tensors (simulators, bootstrap)."""
    counts = np.asarray(counts, dtype=np.int32)
    miss = np.asarray(miss, dtype=np.int32)
    if n_alleles is None:
        n_alleles = np.full(counts.shape[1], counts.shape[2], dtype=np.int64)
    ds = Dataset(counts=counts, miss=miss, n_alleles=np.asarray(n_alleles),
                 ploidy=ploidy, **kw)
    ds.validate()
    return ds
