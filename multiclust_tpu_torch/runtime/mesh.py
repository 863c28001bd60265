"""Process mesh for multi-device fits (multiclust_tpu/runtime/mesh.py) over
``torch.distributed``.

The scaling axes are those of the JAX package: ``data`` shards the
individuals (I) and ``model`` the loci (L).  PyTorch's idiom is one process
per device, so a D x M mesh is a world of D * M processes: rank r holds data
block ``r // M`` and loci block ``r % M``, the row-major order of the JAX
package's ``np.reshape(devices, shape)`` (make_mesh, :83-93).  Each rank
keeps its contiguous block of rows and of loci; blocks may be uneven (the
first ``n % parts`` blocks hold one more), since the port pads no rows and
no loci.

Where the JAX package lets GSPMD insert its collectives, the port writes
every one out in the module that needs it, through two groups of this
rank:

* the **data group**, the D ranks that share this rank's loci block: the
  sums over individuals (the p statistics B, the mixture's responsibility
  sums, the logL) run over it;
* the **model group**, the M ranks that share this rank's row block: the
  sums over loci (the admixture A + r and t, the mixture's scores) run over
  it.

Parameters follow the data: per-individual eta [.., I, K] is split by rows
and replicated over the model group; p [.., K, L, M] (or the biallelic p0
[.., Kp, L]) is split by loci and replicated over the data group; a shared
K-vector eta is replicated everywhere.  Every replica computes the same
update from the same reduced statistics, so the replicas stay equal.

Only ``all_reduce`` and ``broadcast`` are used: gloo takes CUDA tensors for
those two (not for ``all_gather``), so one card can host a multi-rank check
over gloo, and a gather is an ``all_reduce`` of a zero-filled global
buffer.  Host arrays (the per-process ingest's allele counts, label
tables and histograms, contingency tables, locale names) cross ranks the
same way, as tensors on ``_flag_device()`` (``host_sum``, ``host_max``,
``host_any``, ``gather_strings``, ``broadcast_host``).  A decision taken
from reduced values is the same on every rank and needs no broadcast; one
taken from a wall clock or from rank 0's file system goes through
``sync_host_flag`` or ``broadcast_host``.
"""

from __future__ import annotations

import functools
import os
import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

Tensor = torch.Tensor

DATA_AXIS = "data"
MODEL_AXIS = "model"


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None, *,
                           device="cuda",
                           init_method: Optional[str] = None
                           ) -> Optional[torch.device]:
    """Join the process group of a multi-process fit (``initialize_
    distributed``, multiclust_tpu/runtime/mesh.py:38) and return this
    rank's device, or None for a single-process run (nothing to join).

    Arguments left None are read from ``MULTICLUST_COORDINATOR`` (host:port
    of rank 0), ``MULTICLUST_NUM_PROCESSES`` and ``MULTICLUST_PROCESS_ID``,
    as the JAX CLI reads them.  ``init_method`` (``file://...`` or
    ``tcp://...``) replaces the coordinator.  The backend is ``nccl`` when
    ``device`` is CUDA and ``gloo`` on the CPU; an explicit ``backend``
    overrides that (``gloo`` with CUDA tensors hosts several ranks on one
    card).  A CUDA rank takes card ``rank % device_count``; a CPU rank,
    unless OMP_NUM_THREADS says otherwise, an equal share of the host's
    cores (ranks that each spin up every core wait on one another at each
    collective)."""
    env = os.environ
    if coordinator is None:
        coordinator = env.get("MULTICLUST_COORDINATOR")
    if num_processes is None and env.get("MULTICLUST_NUM_PROCESSES"):
        num_processes = int(env["MULTICLUST_NUM_PROCESSES"])
    if process_id is None and env.get("MULTICLUST_PROCESS_ID"):
        process_id = int(env["MULTICLUST_PROCESS_ID"])
    device = torch.device(device)
    if not dist.is_initialized():
        if (init_method is None and coordinator is None
                and num_processes in (None, 1)):
            return None
        if init_method is None:
            if coordinator is None:
                raise ValueError(f"{num_processes} processes need a "
                                 f"coordinator (MULTICLUST_COORDINATOR)")
            init_method = (coordinator if "://" in coordinator
                           else f"tcp://{coordinator}")
        if backend is None:
            backend = "nccl" if device.type == "cuda" else "gloo"
        rank = process_id or 0
        if device.type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        elif "OMP_NUM_THREADS" not in env:
            torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                      // (num_processes or 1)))
        dist.init_process_group(backend, init_method=init_method,
                                world_size=num_processes or 1, rank=rank)
    if device.type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return device


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _flag_device() -> torch.device:
    """Where a host value travels: NCCL moves CUDA tensors only."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def sync_host_flag(flag) -> bool:
    """A decision taken from state that differs between processes (wall
    clocks: -t, -w budgets), made the same on every process: rank 0's
    value wins (multiclust_tpu/runtime/mesh.py:53).  A loop that one rank
    left while another launched a collective would hang the mesh."""
    if not dist.is_initialized():
        return bool(flag)
    t = torch.tensor([int(bool(flag))], device=_flag_device())
    dist.broadcast(t, src=0)
    return bool(t.item())


def past_deadline(t0: float, seconds: float) -> bool:
    """More than ``seconds`` since ``t0``: in a process group rank 0's
    answer on every rank (``sync_host_flag``), as the JAX package's clock
    decisions (multistart.py:455, :683, driver.py:88-91)."""
    return sync_host_flag((time.time() - t0) > seconds)


def world_min(value: int) -> int:
    """The least of an integer over all processes (a chain batch or a
    scratch budget read from each card's free memory)."""
    if not dist.is_initialized():
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64, device=_flag_device())
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return int(t.item())


def any_over_world(flags: Tensor) -> Tensor:
    """Elementwise OR of a bool tensor over all processes."""
    if not dist.is_initialized():
        return flags
    t = flags.to(torch.int32)
    dist.all_reduce(t)
    return t > 0


def _host_reduce(arr, op, group=None) -> np.ndarray:
    """A host array reduced elementwise over ``group`` (the world by
    default): it travels as a tensor on ``_flag_device()``, as every
    collective of a run does.  Without a process group, the array."""
    arr = np.asarray(arr)
    if not dist.is_initialized():
        return arr
    t = torch.as_tensor(np.ascontiguousarray(arr)).to(_flag_device())
    dist.all_reduce(t, op=op, group=group)
    return t.cpu().numpy()


def host_sum(arr, group=None) -> np.ndarray:
    """The sum of a same-shaped host array over the ranks of ``group``
    (counts, contingency tables, per-locale sums)."""
    return _host_reduce(arr, dist.ReduceOp.SUM, group)


def host_max(arr, group=None) -> np.ndarray:
    """The elementwise maximum of a host array over ``group``."""
    return _host_reduce(arr, dist.ReduceOp.MAX, group)


def host_any(arr, group=None) -> np.ndarray:
    """The elementwise OR of a bool host array over ``group``."""
    return _host_reduce(np.asarray(arr).astype(np.int32),
                        dist.ReduceOp.MAX, group) > 0


def gather_strings(strings, index: int, n: int, group=None):
    """The string lists of the ``n`` ranks of ``group``, in the order of
    their ``index``: each list utf-8 encoded, newline-joined, written into
    its row of a zero-filled [n, longest] uint8 buffer that is summed."""
    data = np.frombuffer("\n".join(strings).encode(), np.uint8)
    lens = np.zeros(n, np.int64)
    lens[index] = data.size
    lens = host_sum(lens, group)
    buf = np.zeros((n, max(int(lens.max()), 1)), np.uint8)
    buf[index, :data.size] = data
    buf = host_sum(buf, group)
    out = []
    for row, ln in zip(buf, lens):
        s = row[:int(ln)].tobytes().decode()
        out.append(s.split("\n") if s else [])
    return out


def broadcast_host(arr) -> np.ndarray:
    """Rank 0's host array on every rank (same shape and dtype on each)."""
    arr = np.asarray(arr)
    if not dist.is_initialized():
        return arr
    t = torch.as_tensor(np.ascontiguousarray(arr)).to(_flag_device())
    dist.broadcast(t, src=0)
    return t.cpu().numpy()


def block(n: int, parts: int, index: int) -> Tuple[int, int]:
    """[lo, hi) of block ``index`` when n items split into ``parts``
    contiguous blocks, the first n % parts of them one item longer."""
    base, extra = divmod(n, parts)
    lo = index * base + min(index, extra)
    return lo, lo + base + (index < extra)


class Block(NamedTuple):
    """Where a rank's data sits in the global panel: the global I and L
    and the offsets of its first row and locus."""

    I: int  # noqa: E741
    L: int
    row0: int
    locus0: int


class Mesh:
    """A (data, model) mesh of D x M processes and this rank's two groups.
    Building it is collective: every rank creates every group, in the
    same order.  Without an initialized process group only (1, 1)
    exists, and its sums are the identity."""

    def __init__(self, shape: Tuple[int, int]):
        D, M = (int(s) for s in shape)
        n = world_size()
        if D < 1 or M < 1 or D * M != n:
            raise ValueError(f"mesh shape {D}x{M} does not cover {n} "
                             f"processes")
        self.shape = (D, M)
        self.rank = rank()
        self.data_index, self.model_index = divmod(self.rank, M)
        self.data_group = self.model_group = None
        if dist.is_initialized():
            for d in range(D):
                g = dist.new_group([d * M + m for m in range(M)])
                if d == self.data_index:
                    self.model_group = g
            for m in range(M):
                g = dist.new_group([d * M + m for d in range(D)])
                if m == self.model_index:
                    self.data_group = g

    @property
    def data_shards(self) -> int:
        return self.shape[0]

    @property
    def model_shards(self) -> int:
        return self.shape[1]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape[0]}x{self.shape[1]}, rank {self.rank}: "
                f"data block {self.data_index}, loci block "
                f"{self.model_index})")

    def rows(self, I: int) -> Tuple[int, int]:  # noqa: E741
        """[lo, hi) of this rank's rows among I."""
        return block(I, self.data_shards, self.data_index)

    def loci(self, L: int) -> Tuple[int, int]:
        """[lo, hi) of this rank's loci among L."""
        return block(L, self.model_shards, self.model_index)

    def _axis(self, axis: str):
        if axis == DATA_AXIS:
            return self.data_shards, self.data_group
        if axis == MODEL_AXIS:
            return self.model_shards, self.model_group
        raise ValueError(f"unknown mesh axis {axis!r}")

    def sum(self, x: Tensor, axis: str) -> Tensor:
        """x summed over the ranks of ``axis`` (``data``: over the
        individuals, the data group; ``model``: over the loci, the model
        group), in place when x is contiguous.  An axis of one shard
        returns x as it is."""
        n, group = self._axis(axis)
        if n == 1 or group is None:
            return x
        x = x.contiguous()
        dist.all_reduce(x, group=group)
        return x

    def gather(self, x: Tensor, n: int, dim: int, axis: str) -> Tensor:
        """This rank's block of ``n`` rows (``data``) or loci (``model``)
        along ``dim`` of x made whole on every rank: the block written into
        a zero-filled buffer, which is summed over the axis's group (an
        axis of one shard returns x)."""
        shards, _ = self._axis(axis)
        if shards == 1:
            return x
        lo, hi = self.rows(n) if axis == DATA_AXIS else self.loci(n)
        shape = list(x.shape)
        shape[dim] = n
        out = x.new_zeros(shape)
        out.narrow(dim, lo, hi - lo).copy_(x)
        return self.sum(out, axis)

    def broadcast(self, x: Tensor, src: int = 0) -> Tensor:
        """x of rank ``src`` on every rank, in place."""
        if dist.is_initialized():
            dist.broadcast(x, src=src)
        return x


def sum_over(mesh: Optional[Mesh], x: Tensor, axis: str) -> Tensor:
    """``mesh.sum(x, axis)``; x itself without a mesh."""
    return x if mesh is None else mesh.sum(x, axis)


@functools.lru_cache(maxsize=8)
def _cached(shape: Tuple[int, int], world) -> Mesh:
    return Mesh(shape)


def cached_mesh(shape: Tuple[int, int]) -> Mesh:
    """One Mesh per shape and process group (``cached_mesh``, :77): its
    groups are made once, not at every K of a sweep."""
    world = dist.group.WORLD if dist.is_initialized() else None
    return _cached(tuple(int(s) for s in shape), world)


def make_mesh(shape: Optional[Tuple[int, int]] = None) -> Mesh:
    """A (data, model) mesh over the process group; the default puts
    every process on the data axis (make_mesh, :83-93)."""
    return Mesh(shape if shape is not None else (world_size(), 1))


# ---------------------------------------------------------------------------
# block slicing (data_specs / param_specs / shard_model_data /
# shard_chain_params, :96-193: each rank keeps its block)

def shard_model_data(md, mesh: Mesh, rows: bool = True):
    """This rank's block of a ModelData: rows (unless ``rows`` is False:
    the collapsed one-row data of constrained eta, which every rank of a
    data group holds whole) and loci, each block contiguous, with ``c``
    the rows' missing totals over ALL loci (the eta update adds them once,
    after the sum over the loci) and ``block`` the global sizes and
    offsets."""
    from multiclust_tpu_torch.model.common import ModelData

    I, L = md.I, md.L
    r0, r1 = mesh.rows(I) if rows else (0, I)
    l0, l1 = mesh.loci(L)
    if r1 <= r0 or l1 <= l0:
        raise ValueError(f"a {mesh.shape[0]}x{mesh.shape[1]} mesh leaves "
                         f"rank {mesh.rank} no rows or loci of an {I} x {L} "
                         f"panel")
    miss = md.miss[r0:r1, l0:l1].contiguous()
    x0 = x1 = None
    if md.x0 is not None:
        planes = torch.stack([md.x0[r0:r1, l0:l1], md.x1[r0:r1, l0:l1]])
        x0, x1 = planes[0], planes[1]
        x = planes.permute(1, 2, 0)
    else:
        x = md.x[r0:r1, l0:l1].contiguous()
    return ModelData(x=x, miss=miss, mask=md.mask[l0:l1].contiguous(),
                     n_alleles=md.n_alleles[l0:l1].contiguous(),
                     c=md.c[r0:r1].contiguous(), x0=x0, x1=x1,
                     block=Block(I=I, L=L, row0=r0, locus0=l0))


def as_block(md, mesh: Optional[Mesh]):
    """This rank's block of ``md``: a whole panel is sliced by
    ``shard_model_data``; a block (``md.block`` set: a panel read per
    process, runtime/ingest.py) and a fit without a mesh pass as they
    are."""
    if mesh is None or md.block is not None:
        return md
    return shard_model_data(md, mesh)


def _p_locus_dim(params) -> int:
    """The loci dim of a p tensor: the last of the p0 layout, the one
    before the allele slots of the full layout."""
    return -1 if params.p.ndim == params.eta.ndim else -2


def shard_params(params, mesh: Mesh, I: int, L: int,  # noqa: E741
                 per_individual: bool):
    """This rank's block of chain parameters (``shard_chain_params``):
    per-individual eta by rows, p by loci; a bucketed p (a tuple, data-axis
    meshes only) and a shared eta stay whole."""
    from multiclust_tpu_torch.model.common import Params

    eta, p = params.eta, params.p
    if per_individual:
        r0, r1 = mesh.rows(I)
        eta = eta[..., r0:r1, :].contiguous()
    if not isinstance(p, tuple):
        l0, l1 = mesh.loci(L)
        p = p.narrow(_p_locus_dim(params), l0, l1 - l0).contiguous()
    elif mesh.model_shards > 1:
        raise ValueError("bucketed loci compose with data-axis meshes only")
    return Params(eta=eta, p=p)


def gather_params(params, mesh: Mesh, I: int, L: int,  # noqa: E741
                  per_individual: bool):
    """Inverse of ``shard_params``: the whole parameters on every rank."""
    from multiclust_tpu_torch.model.common import Params

    eta, p = params.eta, params.p
    if per_individual:
        eta = mesh.gather(eta, I, eta.dim() - 2, DATA_AXIS)
    if not isinstance(p, tuple):
        p = mesh.gather(p, L, p.dim() + _p_locus_dim(params), MODEL_AXIS)
    return Params(eta=eta, p=p)
