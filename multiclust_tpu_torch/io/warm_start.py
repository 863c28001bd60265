"""Warm-start and ground-truth file readers.

Covers read_qfile / read_pfile (read_file.c:880-959), read_afile
(:970-999), and read_admixture_{q,p}file (:302-372).  Format deviations
from the reference are documented inline.
"""

from __future__ import annotations

import numpy as np


def read_qfile(path: str, I: int, K: int, per_individual: bool):
    """Warm-start mixing proportions: I*K (admixture unconstrained) or K
    whitespace-separated floats (read_qfile, read_file.c:880-922)."""
    vals = np.fromstring(open(path).read(), sep=" ")
    if per_individual:
        if vals.size < I * K:
            raise ValueError(f"qfile '{path}' has {vals.size} values, "
                             f"expected {I * K}")
        return vals[:I * K].reshape(I, K)
    if vals.size < K:
        raise ValueError(f"qfile '{path}' has {vals.size} values, "
                         f"expected {K}")
    return vals[:K]


def read_pfile(path: str, L: int, K: int):
    """Warm-start allele frequencies, biallelic: L rows of K values giving
    p[k][l][0]; slot 1 is the complement (read_pfile, read_file.c:924-959).
    Read order is l-major, k-minor."""
    vals = np.fromstring(open(path).read(), sep=" ")
    if vals.size < L * K:
        raise ValueError(f"pfile '{path}' has {vals.size} values, "
                         f"expected {L * K}")
    p0 = vals[:L * K].reshape(L, K).T          # [K, L]
    return np.stack([p0, 1.0 - p0], axis=2)    # [K, L, 2]


def read_afile(path: str, I: int):
    """True partition, 1-based contiguous labels (read_afile,
    read_file.c:970-999); returns (labels0, pK)."""
    vals = np.fromstring(open(path).read(), sep=" ").astype(np.int64)
    if vals.size < I:
        raise ValueError(f"afile '{path}' has {vals.size} labels, "
                         f"expected {I}")
    labels = vals[:I] - 1
    return labels, int(labels.max()) + 1


def read_admixture_qfile(path: str):
    """Simulation Q input: I rows x K columns (read_admixture_qfile,
    read_file.c:302-338; the reference's line-count halving is a quirk of
    its own .etaik output layout - we read a plain matrix)."""
    return np.atleast_2d(np.loadtxt(path))


def read_admixture_pfile(path: str, K: int):
    """Simulation P input, biallelic: L rows x K columns of p[k][l][0]
    (read_admixture_pfile, read_file.c:340-372)."""
    vals = np.atleast_2d(np.loadtxt(path))
    if vals.shape[1] != K:
        raise ValueError(f"pfile '{path}' has {vals.shape[1]} columns, "
                         f"expected K={K}")
    p0 = vals.T                                # [K, L]
    return np.stack([p0, 1.0 - p0], axis=2)    # [K, L, 2]
