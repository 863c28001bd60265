"""Checkpoint / resume of the K-sweep and of the bootstrap
(multiclust_tpu/runtime/checkpoint.py).

A K-sweep checkpoint holds each K's best parameters, its counters and the
state of the generator that drew its starts, so an interrupted sweep
resumes where it stopped.  The file is the JAX package's: the same names,
an ``.npz`` with the counters as JSON under ``meta`` and the parameters as
``eta`` / ``p``, so a checkpoint written by either package loads in the
other with the same counters and parameters.  Generator states cannot be
shared (threefry keys against ``torch.Generator`` states): the port writes
its own under ``torch_generator`` and reads no ``key``, and the JAX
package reads no ``torch_generator``.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from multiclust_tpu_torch.model.common import Params
from multiclust_tpu_torch.runtime.multistart import MaximizeResult


_COUNTER_FIELDS = [
    "max_logL", "first_max_logL", "aic", "bic", "n_init", "n_launched",
    "n_total_iter", "n_max_iter", "n_maxll_init", "n_maxll_times",
    "n_targetll_times", "n_targetll_init", "time_stop", "ever_converged",
    "any_failed", "mono_viol", "arand", "seconds",
]
# the port's own MaximizeResult fields; a file without them (one the JAX
# package wrote) loads with their defaults
_PORT_FIELDS = ["n_iter_all", "route", "batch_chains", "buckets"]


def _write(path: str, **arrays) -> str:
    """Write the .npz next to ``path`` and move it into place, so a run
    killed while writing leaves the previous checkpoint whole."""
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    return path


def _meta_array(meta: dict) -> np.ndarray:
    return np.frombuffer(json.dumps(meta, default=float).encode(),
                         dtype=np.uint8)


def checkpoint_file(directory: str, K: int) -> str:
    return os.path.join(directory, f"multiclust_ckpt.K={K}.npz")


def save(directory: str, K: int, res: MaximizeResult,
         gen: Optional[torch.Generator] = None) -> str:
    """Persist K's counters and best parameters, and ``gen``'s state."""
    os.makedirs(directory, exist_ok=True)
    meta = {f: getattr(res, f) for f in _COUNTER_FIELDS + _PORT_FIELDS}
    meta["K"] = K
    arrays = {}
    if res.best_params is not None:
        arrays["eta"] = res.best_params.eta.cpu().numpy()
        arrays["p"] = res.best_params.p.cpu().numpy()
    if gen is not None:
        meta["torch_generator_device"] = gen.device.type
        arrays["torch_generator"] = gen.get_state().numpy()
    return _write(checkpoint_file(directory, K), meta=_meta_array(meta),
                  **arrays)


def load(directory: str, K: int, dtype=None, device="cpu",
         gen: Optional[torch.Generator] = None
         ) -> Optional[MaximizeResult]:
    """K's MaximizeResult, or None when there is no checkpoint.  The
    parameters come back in ``dtype`` (the file's by default) on
    ``device``; ``gen`` takes the saved generator state when the file
    holds one of a generator on the same kind of device."""
    path = checkpoint_file(directory, K)
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        res = MaximizeResult(K=int(meta["K"]))
        for f in _COUNTER_FIELDS + _PORT_FIELDS:
            if f not in meta:
                continue
            cur = getattr(res, f)
            val = meta[f]
            if isinstance(cur, bool):
                val = bool(val)
            elif isinstance(cur, int):
                val = int(val)
            setattr(res, f, val)
        if "eta" in z:
            def tensor(a):
                t = torch.as_tensor(np.asarray(a))
                return t.to(device=device, dtype=dtype or t.dtype)
            res.best_params = Params(eta=tensor(z["eta"]), p=tensor(z["p"]))
        if (gen is not None and "torch_generator" in z
                and meta.get("torch_generator_device") == gen.device.type):
            gen.set_state(torch.as_tensor(np.asarray(z["torch_generator"])))
    return res


def bootstrap_file(directory: str, null_K: int, alt_K: int) -> str:
    return os.path.join(
        directory, f"multiclust_ckpt.bootstrap.K={null_K}v{alt_K}.npz")


def save_bootstrap(directory: str, null_K: int, alt_K: int,
                   n_bootstrap: int, ts, next_rep: int, seed: int) -> str:
    """Persist bootstrap progress after a replicate chunk: the test
    statistics so far and the index of the next replicate.  Replicate r's
    draws depend on (seed, r) alone (stats/bootstrap.py), so the seed is
    all a resumed run needs to fit the rest identically."""
    os.makedirs(directory, exist_ok=True)
    meta = {"null_K": null_K, "alt_K": alt_K, "n_bootstrap": n_bootstrap,
            "next_rep": int(next_rep), "seed": int(seed)}
    return _write(bootstrap_file(directory, null_K, alt_K),
                  meta=_meta_array(meta), ts=np.asarray(ts, np.float64))


def load_bootstrap(directory: str, null_K: int, alt_K: int,
                   n_bootstrap: int, seed: int) -> Optional[np.ndarray]:
    """The test statistics of the replicates done, or None when there is
    no checkpoint of this -b / -k configuration and seed, or it is not
    whole (a file the JAX package wrote holds a key and no seed)."""
    path = bootstrap_file(directory, null_K, alt_K)
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        ts = np.asarray(z["ts"], np.float64)
    if (meta["null_K"] != null_K or meta["alt_K"] != alt_K
            or meta["n_bootstrap"] != n_bootstrap
            or meta.get("seed") != int(seed)
            or meta["next_rep"] != len(ts)):
        return None
    return ts
