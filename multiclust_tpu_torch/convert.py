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

import dataclasses
import enum
from typing import Optional, Tuple

import numpy as np
import torch

from multiclust_tpu_torch.config import Options
from multiclust_tpu_torch.io.dataset import Dataset, from_counts
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


def p0_from_padded(p0, n_loci: int) -> np.ndarray:
    """A JAX-side p0 layout [.., Kp, Lp] -> [.., Kp, n_loci].  A chunked or
    streamed JAX fit pads loci to its tile multiple (pads zero); the port
    pads no loci, so the pad columns are dropped."""
    return np.ascontiguousarray(np.asarray(p0)[..., :n_loci])


def p0_to_padded(p0, n_loci_padded: int) -> np.ndarray:
    """Inverse of ``p0_from_padded``: zero pad columns restored up to the
    JAX layout's ``n_loci_padded``."""
    p0 = np.asarray(p0)
    pad = n_loci_padded - p0.shape[-1]
    if pad < 0:
        raise ValueError(f"p0 has {p0.shape[-1]} loci, more than the padded "
                         f"width {n_loci_padded}")
    return np.pad(p0, [(0, 0)] * (p0.ndim - 1) + [(0, pad)])


def dataset_from_counts(counts, miss, ploidy: int = 2, **kw) -> Dataset:
    """Counts [I, L, M] and missing copies [I, L] -> the host Dataset that
    ``api.fit_dataset`` takes (io/dataset.from_counts; ``kw`` as there)."""
    return from_counts(np.asarray(counts), np.asarray(miss), ploidy, **kw)


def dataset_from(ds) -> Dataset:
    """The port's Dataset from any object with the same field names (a
    Dataset of the JAX package, handed across by the tests)."""
    return Dataset(**{f.name: getattr(ds, f.name)
                      for f in dataclasses.fields(Dataset)})


def options_from(obj) -> Options:
    """The port's Options from any object with the same field names (an
    Options of the JAX package, handed across by the tests).  Enum fields
    cross by their ``.value`` and are rebuilt as the port's own enums."""
    defaults = Options()
    kw = {}
    for f in dataclasses.fields(Options):
        v = getattr(obj, f.name)
        if isinstance(v, enum.Enum):
            v = type(getattr(defaults, f.name))(v.value)
        kw[f.name] = v
    return Options(**kw)


def model_data_from_numpy(x, miss, mask, n_alleles, *, device="cpu",
                          dtype: torch.dtype = torch.float64) -> ModelData:
    """Counts x [I, L, M], miss [I, L], mask [L, M], n_alleles [L] ->
    ModelData; float32 data on CUDA is stored int8, as the fit path does."""
    storage = (torch.int8 if (torch.device(device).type == "cuda"
                              and dtype == torch.float32) else None)
    return make_model_data(x, miss, mask, n_alleles, dtype=dtype,
                           device=device, storage_dtype=storage)
