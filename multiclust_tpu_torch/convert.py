"""State carried between the JAX package and the port, as numpy arrays.

Parameters come in either layout of the JAX package: full (eta [.., I, K],
or the K-vector eta [.., K] of the mixture and of constrained eta; p
[.., K, L, M]) or the biallelic p0 layout (p [.., Kp, Lp]).  The JAX
engine pads rows and loci for its TPU tiles; ``n_rows``/``n_loci`` trim
those pads, since the port keeps I and L as they are.  A K-vector eta is
told by its shape against p's (p has two more dims), and carries no rows
to trim.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from multiclust_tpu_torch.model.common import ModelData, Params, \
    make_model_data


def params_from_numpy(eta, p, *, device="cpu",
                      dtype: torch.dtype = torch.float64,
                      n_rows: Optional[int] = None,
                      n_loci: Optional[int] = None) -> Params:
    """Numpy (or JAX) parameter arrays -> port Params on ``device``."""
    eta = np.asarray(eta)
    p = np.asarray(p)
    eta_vector = p.ndim == eta.ndim + 2
    if n_rows is not None and not eta_vector:
        eta = eta[..., :n_rows, :]
    if n_loci is not None:
        p = p[..., :n_loci] if p.ndim == eta.ndim else p[..., :n_loci, :]
    return Params(eta=torch.as_tensor(eta).to(device=device, dtype=dtype),
                  p=torch.as_tensor(p).to(device=device, dtype=dtype))


def params_to_numpy(params: Params) -> Tuple[np.ndarray, np.ndarray]:
    """Port Params -> (eta, p) numpy arrays in the same layout."""
    return (params.eta.detach().cpu().numpy(),
            params.p.detach().cpu().numpy())


def dataset_from_counts(counts, miss, ploidy: int = 2):
    """Counts [I, L, M] and missing copies [I, L] -> the host Dataset that
    ``api.fit_dataset`` takes (multiclust_tpu.io.dataset.from_counts)."""
    from multiclust_tpu.io.dataset import from_counts
    return from_counts(counts, miss, ploidy)


def model_data_from_numpy(x, miss, mask, n_alleles, *, device="cpu",
                          dtype: torch.dtype = torch.float64) -> ModelData:
    """Counts x [I, L, M], miss [I, L], mask [L, M], n_alleles [L] ->
    ModelData; float32 data on CUDA is stored int8, as the fit path does."""
    storage = (torch.int8 if (torch.device(device).type == "cuda"
                              and dtype == torch.float32) else None)
    return make_model_data(x, miss, mask, n_alleles, dtype=dtype,
                           device=device, storage_dtype=storage)
