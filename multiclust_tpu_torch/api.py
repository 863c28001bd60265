"""One-call library API (multiclust_tpu/api.py) with an explicit device.

``fit_file`` / ``fit_dataset`` run read -> synchronize -> K-sweep
multi-start -> the bootstrap test when ``n_bootstrap`` asks for it.  The
device defaults to ``cuda``; without a CUDA device they raise unless
``device="cpu"`` is passed.  A meshed fit (``mesh_shape``) runs in every
process of a group that ``runtime/mesh.initialize_distributed`` joined,
each on its own device with its block of the panel: ``fit_file`` then
reads and uploads only that block (runtime/ingest.py), and a panel given
whole is sliced.  Every process gets the whole results.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from multiclust_tpu_torch.config import Options
from multiclust_tpu_torch.io.dataset import Dataset


@dataclasses.dataclass
class FitOutput:
    dataset: Optional[Dataset]          # None for a panel made on the device
    estimate: "EstimateResult"          # noqa: F821 - runtime import
    bootstrap: Optional["BootstrapResult"] = None  # noqa: F821

    @property
    def best(self):
        """MaximizeResult of the best (AIC-selected) K."""
        return self.estimate.per_K[self.estimate.aic_K]

    @property
    def Q(self) -> np.ndarray:
        """Fitted mixing proportions of the selected K: [I, K] admixture
        proportions, or the shared [K] vector (mixture, constrained
        eta)."""
        return self.best.best_params.eta.cpu().numpy()

    @property
    def P(self) -> np.ndarray:
        """Fitted allele frequencies of the selected K."""
        return self.best.best_params.p.cpu().numpy()


def resolve_device(device) -> torch.device:
    """The fit device; a CUDA request without a CUDA device raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' to fit on the CPU")
    return device


# the JAX package's refusal of a multi-process K-sweep checkpoint
# (multiclust_tpu/cli.py:474-478)
CHECKPOINT_REFUSAL = ("--checkpoint (K-sweep state) is single-process only; "
                      "bootstrap checkpointing (-b with --checkpoint) works "
                      "multi-process")


def check_ported(opt: Options) -> None:
    """Raise NotImplementedError for options outside the ported slice: a
    multi-process K-sweep checkpoint, as the JAX package does."""
    from multiclust_tpu_torch.runtime.mesh import world_size

    if opt.checkpoint_dir and not opt.n_bootstrap and world_size() > 1:
        raise NotImplementedError(CHECKPOINT_REFUSAL)


def _mesh_of(opt: Options):
    from multiclust_tpu_torch.runtime.mesh import cached_mesh
    from multiclust_tpu_torch.runtime.multistart import mesh_shape_of

    shape = mesh_shape_of(opt)
    return None if shape is None else cached_mesh(shape)


def fit_model_data(md, ploidy: int, opt: Optional[Options] = None, *,
                   dataset: Optional[Dataset] = None, **kw) -> FitOutput:
    """Fit a panel that already lies on its device as ModelData (one
    generated there, model/common.model_data_from_planes; or the one
    ``fit_dataset`` uploads) under the given options, then run the
    bootstrap test when ``n_bootstrap`` is set."""
    from multiclust_tpu_torch.runtime import observe

    with observe.fit(md.device):
        return _fit_model_data(md, ploidy, opt, dataset, kw)


def _fit_model_data(md, ploidy: int, opt: Optional[Options],
                    dataset: Optional[Dataset], kw) -> FitOutput:
    from multiclust_tpu_torch.ops.build import count
    from multiclust_tpu_torch.runtime import mesh as mesh_mod
    from multiclust_tpu_torch.runtime.ksweep import estimate_model
    from multiclust_tpu_torch.runtime.observe import span
    from multiclust_tpu_torch.stats.bootstrap import run_bootstrap

    with span("mc.plan"):
        opt = opt or Options()
        if kw:
            opt = dataclasses.replace(opt, **kw)
        check_ported(opt)
        resolve_device(md.device)
        mesh = _mesh_of(opt)
        md = mesh_mod.as_block(md, mesh)
        opt = opt.synchronize(md.I_total, ploidy)
        count("host.syncs")
        free_p = (md.n_alleles - 1).sum().cpu().numpy()
        if md.block is not None:
            free_p = mesh_mod.host_sum(free_p, mesh.model_group)
        free_p = int(free_p)

    def n_parameters(K):
        # Dataset.n_parameters (multiclust.c:1267-1277)
        per_i = opt.admixture and not opt.eta_constrained
        return (md.I_total * (K - 1) if per_i else K - 1) + free_p * K

    # a multi-process run checkpoints its bootstrap only, as the JAX CLI
    est = estimate_model(opt.seed, md, opt, n_parameters,
                         checkpoint_dir=(opt.checkpoint_dir
                                         if mesh_mod.world_size() == 1
                                         else None))
    boot = None
    if opt.n_bootstrap:
        boot = run_bootstrap(opt.seed, md, opt, n_parameters, est.ts,
                             est.h0_params, ploidy,
                             checkpoint_dir=opt.checkpoint_dir)
    return FitOutput(dataset=dataset, estimate=est, bootstrap=boot)


def fit_dataset(ds: Dataset, opt: Optional[Options] = None, *,
                device="cuda", **kw) -> FitOutput:
    """Fit a Dataset under the given options (kw override Options
    fields) on ``device``."""
    from multiclust_tpu_torch.model.common import model_data_from_dataset
    from multiclust_tpu_torch.runtime.multistart import device_policy

    opt = opt or Options()
    if kw:
        opt = dataclasses.replace(opt, **kw)
    check_ported(opt)
    device = resolve_device(device)
    _, storage = device_policy(opt, device)
    md = model_data_from_dataset(ds, dtype=getattr(torch, opt.dtype),
                                 device=device, storage_dtype=storage)
    return fit_model_data(md, ds.ploidy, opt, dataset=ds)


def fit_file(path: str, opt: Optional[Options] = None, *, device="cuda",
             **kw) -> FitOutput:
    """Read a STRUCTURE file and fit it on ``device``.  In a process group
    of more than one process every process reads and uploads its block of
    the ``mesh_shape`` mesh only (runtime/ingest.py); its FitOutput's
    dataset is then the Dataset of its rows."""
    from multiclust_tpu_torch.io.structure import read_structure
    from multiclust_tpu_torch.runtime.ingest import \
        load_structure_distributed
    from multiclust_tpu_torch.runtime.mesh import world_size
    from multiclust_tpu_torch.runtime.multistart import device_policy

    opt = opt or Options()
    if kw:
        opt = dataclasses.replace(opt, **kw)
    if world_size() == 1:
        return fit_dataset(read_structure(path, opt), opt, device=device)
    check_ported(opt)
    device = resolve_device(device)
    mesh = _mesh_of(opt)
    if mesh is None:
        raise ValueError(f"{world_size()} processes fit on a mesh: pass "
                         f"mesh_shape")
    _, storage = device_policy(opt, device)
    md, info = load_structure_distributed(
        path, opt, mesh, dtype=getattr(torch, opt.dtype),
        storage_dtype=storage, device=device)
    return fit_model_data(md, opt.ploidy, opt, dataset=info.ds_local)
