"""Cluster-agreement indices (adj_rand, multiclust.c:1903-1985)."""

from __future__ import annotations

import numpy as np

E_INDEX = 0
RAND_INDEX = 1
ADJUSTED_RAND_INDEX = 2


def agreement_index(cl1, cl2, which: int = ADJUSTED_RAND_INDEX) -> float:
    """E index, Rand index, or adjusted Rand index of two partitions.

    cl1/cl2 are integer label vectors of equal length (0-based).
    """
    cl1 = np.asarray(cl1)
    cl2 = np.asarray(cl2)
    n = cl1.shape[0]
    k1 = int(cl1.max()) + 1
    k2 = int(cl2.max()) + 1
    nmat = np.zeros((k1, k2))
    np.add.at(nmat, (cl1, cl2), 1.0)
    return agreement_from_contingency(nmat, n, which)


def agreement_from_contingency(nmat, n: int,
                               which: int = ADJUSTED_RAND_INDEX) -> float:
    """Same indices from a precomputed contingency table ``nmat``
    ([k1, k2] pair counts over ``n`` items).  The table is additive over
    row shards, so multi-process runs build per-process tables from
    their local rows and allgather-sum them before this closed form
    (runtime/ingest.score_arand_distributed)."""
    nmat = np.asarray(nmat, np.float64)
    sumtr = nmat.sum(axis=1)
    sumpr = nmat.sum(axis=0)
    sumtrsq = (sumtr ** 2).sum()
    sumprsq = (sumpr ** 2).sum()

    if which == E_INDEX:
        sumtrprsq = ((sumtr ** 2)[:, None] * (sumpr ** 2)[None, :]).sum()
        index = (sumtrprsq / (n * (n - 1) + n * n / (n - 1))
                 - (sumprsq + sumtrsq) / (n - 1))
        return 2.0 * index / (n * (n - 1))

    if which == RAND_INDEX:
        sumsq = (nmat ** 2).sum()
        discordant = 0.5 * (sumtrsq + sumprsq) - sumsq
        return 1.0 - discordant / (n * (n - 1.0) / 2.0)

    nidot2 = (sumtr * (sumtr - 1) / 2.0).sum()
    ndotj2 = (sumpr * (sumpr - 1) / 2.0).sum()
    nij2 = (nmat * (nmat - 1) / 2.0).sum()
    term3 = nidot2 * ndotj2 / (n * (n - 1.0) / 2.0)
    return (nij2 - term3) / ((nidot2 + ndotj2) / 2.0 - term3)


def adjusted_rand(cl1, cl2) -> float:
    return agreement_index(cl1, cl2, ADJUSTED_RAND_INDEX)
