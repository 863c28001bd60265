"""Data simulation.

Covers the reference's ``--simulate`` (simulate_data, multiclust.c:167-186:
biallelic admixture draws written as a STRUCTURE file) and generalizes it to
multi-allelic, polyploid, missing-at-random generators used to regenerate
the reference's absent ``data/`` fixtures (00README:15-27) for golden tests.

Note: the reference simulator draws each copy's source cluster uniformly at
random (``rand() % K``, multiclust.c:178) instead of from the supplied Q
matrix, and only fills individuals at stride ``ploidy`` (multiclust.c:175) -
both at odds with its own documentation.  We implement the documented
semantics: cluster ~ Q[i], allele ~ P[k, l].
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from multiclust_tpu_torch.config import MISSING
from multiclust_tpu_torch.io.dataset import Dataset, from_haplotypes


def simulate_admixture(
    rng: np.random.Generator,
    Q: np.ndarray,            # [I, K] admixture proportions
    P: np.ndarray,            # [K, L, M] allele frequencies
    ploidy: int = 2,
    missing_rate: float = 0.0,
) -> Dataset:
    """Draw genotypes under the admixture model; returns a Dataset with the
    haplotype matrix attached (so STRUCTURE files can be written)."""
    I, K = Q.shape
    K2, L, M = P.shape
    assert K == K2
    # cluster per copy: [I, L, P]
    ks = np.stack([
        np.stack([rng.choice(K, size=ploidy, p=Q[i]) for _ in range(L)])
        for i in range(I)])
    # allele per copy
    IL = np.empty((I * ploidy, L), dtype=np.int64)
    for i in range(I):
        for l in range(L):
            for a in range(ploidy):
                IL[i * ploidy + a, l] = rng.choice(M, p=P[ks[i, l, a], l])
    if missing_rate > 0:
        mask = rng.random(IL.shape) < missing_rate
        IL[mask] = MISSING
    return from_haplotypes(IL, ploidy=ploidy,
                           names=[f"ind{i}" for i in range(I)],
                           locales=np.zeros(I, dtype=np.int64),
                           pops=["pop0"])


def simulate_admixture_fast(
    rng: np.random.Generator,
    Q: np.ndarray, P: np.ndarray,
    ploidy: int = 2, missing_rate: float = 0.0,
) -> Dataset:
    """Vectorized variant for larger fixtures."""
    I, K = Q.shape
    _, L, M = P.shape
    # cluster per copy via inverse-CDF on Q
    u = rng.random((I, L, ploidy))
    cq = np.cumsum(Q, axis=1)                     # [I, K]
    ks = (u[..., None] > cq[:, None, None, :]).sum(axis=-1)  # [I, L, P]
    # allele per copy via inverse-CDF on P[k, l]
    u2 = rng.random((I, L, ploidy))
    cp = np.cumsum(P, axis=2)                     # [K, L, M]
    cp_sel = cp[ks, np.arange(L)[None, :, None]]  # [I, L, P, M]
    alleles = (u2[..., None] > cp_sel).sum(axis=-1)
    IL = np.empty((I * ploidy, L), dtype=np.int64)
    for a in range(ploidy):
        IL[a::ploidy] = alleles[:, :, a]
    if missing_rate > 0:
        m = rng.random(IL.shape) < missing_rate
        IL[m] = MISSING
    return from_haplotypes(IL, ploidy=ploidy,
                           names=[f"ind{i}" for i in range(I)],
                           locales=np.zeros(I, dtype=np.int64),
                           pops=["pop0"])


def simulate_mixture(
    rng: np.random.Generator,
    eta: np.ndarray,          # [K]
    P: np.ndarray,            # [K, L, M]
    I: int, ploidy: int = 2, missing_rate: float = 0.0,
) -> Tuple[Dataset, np.ndarray]:
    """Draw genotypes under the mixture model; returns (Dataset, truth)."""
    K, L, M = P.shape
    z = rng.choice(K, size=I, p=eta)              # true cluster per indiv
    u = rng.random((I, L, ploidy))
    cp = np.cumsum(P, axis=2)
    alleles = (u[..., None] > cp[z][:, :, None, :]).sum(axis=-1)  # [I, L, P]
    IL = np.empty((I * ploidy, L), dtype=np.int64)
    for a in range(ploidy):
        IL[a::ploidy] = alleles[:, :, a]
    if missing_rate > 0:
        m = rng.random(IL.shape) < missing_rate
        IL[m] = MISSING
    ds = from_haplotypes(IL, ploidy=ploidy,
                         names=[f"ind{i}" for i in range(I)],
                         locales=np.zeros(I, dtype=np.int64),
                         pops=["pop0"])
    return ds, z


def random_model(rng: np.random.Generator, K: int, L: int, M: int,
                 I: Optional[int] = None, concentration: float = 0.5):
    """Random (Q or eta, P) with Dirichlet draws; sharper clusters for
    smaller concentration."""
    P = rng.dirichlet(np.full(M, concentration), size=(K, L))
    if I is None:
        eta = rng.dirichlet(np.full(K, 5.0))
        return eta, P
    Q = rng.dirichlet(np.full(K, 1.0), size=I)
    return Q, P
