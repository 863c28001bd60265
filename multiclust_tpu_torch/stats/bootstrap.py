"""Parametric bootstrap LRT of H0: K = k - 1 against Ha: K = k
(multiclust_tpu/stats/bootstrap.py; run_bootstrap, multiclust.c:675-708,
and parametric_bootstrap, bootstrap.c:31-175).

Each replicate simulates data from the H0 fit with every missing entry
kept, then refits both models with the full multi-start procedure; the
p-value is the fraction of replicate statistics at or above the observed
one.  Under the admixture model a copy's allele is drawn from q_ilm =
sum_k eta_ik p_klm; under the mixture model the individual's cluster is
drawn first (bootstrap.c:138-146), then its copies from p[k_i, l].

By default the replicates fit in chunks as an R x B lattice of chains (B
= ``n_init`` starts a replicate; model/common.Lattice): one lattice of R
x B chains in lockstep through opt/em.py, whose model step runs each
replicate's B chains through the routed step of a B-chain batch on that
replicate's counts, so every kernel runs as it does in a fit of B chains.
The serial regime (one ``estimate_model`` a replicate) serves the stop
regimes whose bookkeeping is sequential (-t, -u) and -v > 3.

Deviations, besides the JAX package's own (the p-value is the real
fraction, not the reference's integer division; draws are made on the
device, not with libc ``rand()``):

* replicate r draws its counts and its starts from generators seeded by
  (seed, r) alone (``np.random.SeedSequence(seed, spawn_key=(r,))``),
  where the JAX package splits one key per chunk of replicates.  The chunk
  size follows the device's free memory; the test statistics and the
  p-value do not, and a resumed run may take another chunk size;
* a biallelic replicate is drawn straight into its two count planes (P
  Bernoulli comparisons a cell, in windows of loci), never as a one-hot
  [I, L, P, M] tensor;
* under a mesh (``--mesh``) ``md`` is this rank's block (a whole panel is
  sliced first).  Every rank draws each window of loci of a replicate
  whole from (seed, r), as in a single-process run, keeps its block of
  rows and loci, draws the starts' blocks the same way (init/random.py)
  and fits its block (the meshed lattices of the JAX package's
  ``_shard_replicates`` / ``_shard_lattice_params``, :313-351), so the
  replicates and their statistics are those of the unsharded run.  Rank 0
  writes the checkpoints and a resume takes rank 0's view, broadcast
  (the JAX package's ``_save_bootstrap_synced`` /
  ``_load_bootstrap_synced``, :264-311): the ranks need not share a
  filesystem.

The replicates of a jagged panel fit bucketed, as the JAX package's do
(multiclust_tpu/stats/bootstrap.py:151-168): every replicate shares the
panel's n_alleles, so one plan buckets them all.  Each dense draw is
bucketed once, after its starts are drawn on it and before its fits.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from multiclust_tpu_torch.model import bucketed
from multiclust_tpu_torch.model.common import Lattice, ModelData, Params, \
    column_window, k_padded_size, map_params
from multiclust_tpu_torch.model.admixture import bi_route
from multiclust_tpu_torch.ops.build import count
from multiclust_tpu_torch.runtime import checkpoint as ckpt
from multiclust_tpu_torch.runtime import mesh as mesh_mod
from multiclust_tpu_torch.runtime import multistart as ms
from multiclust_tpu_torch.runtime.multistart import CHAIN_MEMORY_SHARE, \
    _draw_init_batch, _make_state, _pad_k, _segment, cfg_from_options, \
    chain_bytes


@dataclasses.dataclass
class BootstrapResult:
    ts_obs: float
    ts_bs: List[float]
    pvalue: float
    null_K: int
    alt_K: int
    seconds: float = 0.0
    # the batched regime: replicates a lattice, the route of a replicate's
    # biallelic admixture step by K (ops/fullstep_bi.Route.describe; none
    # for the other steps), and the chain-iterations its lattices ran
    chunk: int = 0
    routes: Dict[int, str] = dataclasses.field(default_factory=dict)
    chain_iterations: int = 0


def _seeds(seed: int, rep: int) -> np.ndarray:
    """(simulation seed, fit seed) of replicate ``rep``: a function of
    (seed, rep) alone."""
    return np.random.SeedSequence(seed, spawn_key=(rep,)).generate_state(2)


def _generator(device, seed) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def simulate_replicate(gen: torch.Generator, params: Params, md: ModelData,
                       ploidy: int, admixture: bool) -> ModelData:
    """A replicate of ``md`` drawn from unbatched full-layout ``params``
    on md's device: its own counts, ``md``'s miss, mask, n_alleles and c.
    Each (i, l) draws ploidy - miss copies; invalid allele lanes stay 0.
    Temporaries are made one window of loci (about WINDOW_BYTES) at a
    time.  Of a block (``md.block``), every window is drawn for the whole
    panel's rows and loci, so the draws are the unsharded run's, and the
    block of them is kept."""
    p = params.p                                      # [K, L, M]
    K = p.shape[0]
    dev = md.device
    I, L = md.I_total, md.L_total
    r0, l0 = md.offsets
    rows = slice(r0, r0 + md.I)
    eta = params.eta
    if not admixture:
        z = torch.multinomial(eta, I, replacement=True, generator=gen)[rows]
    elif eta.dim() == 1:                              # constrained eta
        eta = eta.expand(md.I, K)
    else:
        eta = eta[rows]
    bi = md.x0 is not None
    out = (torch.empty((2, md.I, md.L), dtype=md.x0.dtype, device=dev)
           if bi else torch.empty_like(md.x))
    win = column_window(L, I * (3 * md.M * p.element_size() + 16))
    for lo in range(0, L, win):
        hi = min(L, lo + win)
        g0, g1 = max(lo, l0), max(min(hi, l0 + md.L), lo)  # own loci
        cols, own = slice(g0 - lo, g1 - lo), slice(g0 - l0, g1 - l0)
        if admixture:
            q = (eta @ p[:, g0:g1].reshape(K, -1)).reshape(md.I, g1 - g0,
                                                           md.M)
        else:
            q = p[z, g0:g1]
        n_obs = ploidy - md.miss[:, own].to(torch.int16)
        if bi:
            # P Bernoulli comparisons a cell, straight into the planes
            q0 = q[..., 0] / (q[..., 0] + q[..., 1])
            x0 = torch.zeros_like(n_obs)
            for c in range(ploidy):
                u = torch.rand((I, hi - lo), generator=gen, device=dev,
                               dtype=q0.dtype)[rows, cols]
                x0 += (u < q0) & (n_obs > c)
            out[0, :, own] = x0
            out[1, :, own] = n_obs - x0
            continue
        # a copy's allele by inverse CDF (bootstrap.c:95-120)
        q = torch.where(md.mask[own], q, torch.zeros_like(q))
        cdf = q.cumsum(dim=-1)
        cdf = cdf / cdf[..., -1:]
        last = (md.n_alleles[own].long() - 1).clamp(min=0)
        counts = torch.zeros(q.shape, dtype=torch.int32, device=dev)
        for c in range(ploidy):
            u = torch.rand((I, hi - lo), generator=gen, device=dev,
                           dtype=q.dtype)[rows, cols]
            slot = torch.minimum((u[..., None] > cdf).sum(dim=-1), last)
            counts.scatter_add_(2, slot[..., None],
                                (n_obs > c)[..., None].to(torch.int32))
        out[:, own] = counts
    if bi:
        return md._replace(x=out.permute(1, 2, 0), x0=out[0], x1=out[1])
    return md._replace(x=out)


def draw_replicate(seed: int, rep: int, md: ModelData, h0_params: Params,
                   ploidy: int, admixture: bool) -> ModelData:
    """Replicate ``rep`` of the bootstrap seeded by ``seed``."""
    return simulate_replicate(_generator(md.device, _seeds(seed, rep)[0]),
                              h0_params, md, ploidy, admixture)


def replicate_starts(seed: int, rep: int, K: int, rep_md: ModelData, cfg,
                     opt) -> Params:
    """The ``opt.n_init`` starts of replicate ``rep`` at K (K-padded as the
    fit runs them), drawn on ``rep_md`` and scored by Rand-EM on its
    collapsed data under constrained eta: those the serial regime's
    ``estimate_model`` of the replicate draws at that K."""
    ks = (opt.max_K - 1, opt.max_K)
    gen = _generator(rep_md.device, np.random.SeedSequence(
        int(_seeds(seed, rep)[1])).generate_state(len(ks))[ks.index(K)])
    return _pad_k(_draw_init_batch(gen, max(opt.n_init, 1), rep_md, K, cfg,
                                   opt, _fit_data(rep_md, cfg)), cfg)


def _fit_data(rep_md: ModelData, cfg,
              plan: Optional[bucketed.JaggedPlan] = None):
    """What a replicate's chains run on: its collapsed column sums under
    constrained eta, its counts otherwise; bucketed by ``plan``."""
    return ms._fit_data(rep_md, cfg, plan)[0]


def fit_lattice(params: Params, reps, cfg, segment: int = 16):
    """Run an R x B lattice of chains (params [R*B, ...], lanes r*B ..
    r*B + B - 1 on ``reps[r]``) to convergence in lockstep, reading the
    stop flags once a segment of macro steps, as
    runtime/multistart.fit_batch does; a replicate whose chains have all
    stopped is left out of the segments that follow.  Returns the EMState
    of every lane."""
    R = len(reps)
    B = params.eta.shape[0] // R
    lat = Lattice(reps=tuple(reps), B=B, live=frozenset(range(R)))
    state = _make_state(params, lat, cfg)
    while True:
        done = state.stopped.reshape(R, B).all(dim=1).cpu().numpy()
        if done.all():
            return state
        lat = lat._replace(live=frozenset(np.nonzero(~done)[0].tolist()))
        state = _segment(state, lat, cfg, segment)


def replicate_chunk(md: ModelData, n_chains: int, n_reps: int,
                    bytes_per_chain: int, mesh=None) -> int:
    """Replicates a lattice fits at once: on CUDA as many as
    CHAIN_MEMORY_SHARE of the device's free memory holds, a replicate
    being its counts (of this rank's block, under a ``mesh``) plus
    ``n_chains`` chains of ``bytes_per_chain``
    (runtime/multistart.chain_bytes); all of them on the CPU.  Every rank
    of a ``mesh`` takes the least over the ranks."""
    if md.device.type != "cuda":
        return n_reps
    count("host.mem_queries")
    free, _ = torch.cuda.mem_get_info(md.device)
    per_rep = md.x.numel() * md.x.element_size() + n_chains * bytes_per_chain
    chunk = max(1, min(n_reps, int(CHAIN_MEMORY_SHARE * free) // per_rep))
    return chunk if mesh is None else mesh_mod.world_min(chunk)


def _batched_ts(seed: int, md: ModelData, opt, h0_params: Params,
                ploidy: int, done: List[float], out: BootstrapResult,
                checkpoint_dir=None) -> Iterator[float]:
    """The test statistics of replicates len(done) .. n_bootstrap - 1,
    fitted chunk by chunk as [R x B] chain lattices (replacing the
    reference's serial refit loop, multiclust.c:681); each chunk's are
    checkpointed before they are given out."""
    n_reps = opt.n_bootstrap
    B = max(opt.n_init, 1)
    ks = (opt.max_K - 1, opt.max_K)
    cfgs = {K: cfg_from_options(opt, K, md) for K in ks}
    plan = bucketed.plan_for(md) if cfgs[ks[0]].model_shards == 1 else None
    out.chunk = replicate_chunk(
        md, B, n_reps, max(chain_bytes(md, K, cfgs[K], plan) for K in ks),
        cfgs[ks[0]].mesh)
    for K in ks:
        if cfgs[K].bi_repr_active:
            out.routes[K] = bi_route(B, md, cfgs[K],
                                     k_padded_size(K, 32)).describe()
    ts = list(done)
    for lo in range(len(ts), n_reps, out.chunk):
        starts = {K: [] for K in ks}
        fit_reps = []
        for r in range(lo, min(n_reps, lo + out.chunk)):
            rep = draw_replicate(seed, r, md, h0_params, ploidy,
                                 opt.admixture)
            for K in ks:
                starts[K].append(replicate_starts(seed, r, K, rep, cfgs[K],
                                                  opt))
            # the fit data depend on the model type, not on K
            fit_reps.append(_fit_data(rep, cfgs[ks[0]], plan))
            del rep
        maxll = {}
        for K in ks:
            state = fit_lattice(
                map_params(lambda *t: torch.cat(t), *starts[K]), fit_reps,
                cfgs[K])
            lls = state.logL.cpu().numpy().reshape(len(fit_reps), B)
            maxll[K] = np.where(np.isfinite(lls), lls, -np.inf).max(axis=1)
            out.chain_iterations += int(state.n_iter.sum())
        new = (maxll[ks[1]] - maxll[ks[0]]).tolist()
        ts += new
        if checkpoint_dir:
            _save_bootstrap_synced(checkpoint_dir, ks[0], ks[1], n_reps, ts,
                                   seed)
        yield from new


def _serial_ts(seed: int, md: ModelData, opt, n_parameters_fn,
               h0_params: Params, ploidy: int, done: List[float],
               checkpoint_dir=None) -> Iterator[float]:
    """The test statistics of replicates len(done) .. n_bootstrap - 1, one
    ``estimate_model(..., bootstrap=True)`` each, checkpointed one by
    one."""
    from multiclust_tpu_torch.runtime.ksweep import estimate_model

    ts = list(done)
    for r in range(len(ts), opt.n_bootstrap):
        rep = draw_replicate(seed, r, md, h0_params, ploidy, opt.admixture)
        est = estimate_model(int(_seeds(seed, r)[1]), rep, opt,
                             n_parameters_fn, bootstrap=True)
        ts.append(est.ts)
        if checkpoint_dir:
            _save_bootstrap_synced(checkpoint_dir, opt.max_K - 1, opt.max_K,
                                   opt.n_bootstrap, ts, seed)
        yield est.ts


def _save_bootstrap_synced(directory: str, null_K: int, alt_K: int,
                           n_reps: int, ts, seed: int) -> None:
    """The checkpoint after a chunk or a replicate, written by rank 0: the
    statistics are the same on every rank, so one writer suffices."""
    if mesh_mod.rank() == 0:
        ckpt.save_bootstrap(directory, null_K, alt_K, n_reps, ts, len(ts),
                            seed)


def _load_bootstrap_synced(directory: str, null_K: int, alt_K: int,
                           n_reps: int, seed: int) -> Optional[np.ndarray]:
    """The statistics a resume starts from: rank 0 reads its checkpoint
    and broadcasts what it found (a count, -1 for none, then the
    statistics), so every rank resumes from the same state."""
    if mesh_mod.world_size() == 1:
        return ckpt.load_bootstrap(directory, null_K, alt_K, n_reps, seed)
    buf = np.zeros(n_reps + 1, np.float64)
    buf[0] = -1
    if mesh_mod.rank() == 0:
        done = ckpt.load_bootstrap(directory, null_K, alt_K, n_reps, seed)
        if done is not None:
            buf[0] = len(done)
            buf[1:1 + len(done)] = done
    buf = mesh_mod.broadcast_host(buf)
    n = int(buf[0])
    return None if n < 0 else buf[1:1 + n]


def run_bootstrap(seed: int, md: ModelData, opt, n_parameters_fn,
                  ts_obs: float, h0_params: Params, ploidy: int,
                  log: Optional[Callable] = None,
                  checkpoint_dir: Optional[str] = None) -> BootstrapResult:
    """run_bootstrap (multiclust.c:675-708): ``opt.n_bootstrap``
    replicates of ``md`` drawn from the H0 fit ``h0_params``, each refitted
    at K - 1 and K.  The batched regime by default (``replicate_chunk``
    replicates a lattice); the serial one under -t, -u and -v > 3.  ``log(rep, ts, n_at_or_above)`` follows each
    replicate.  ``checkpoint_dir`` persists the statistics after every
    chunk (batched) or replicate (serial), and a killed run resumes with
    the identical statistics and p-value."""
    t0 = time.time()
    shape = ms.mesh_shape_of(opt)
    if shape is not None:
        md = mesh_mod.as_block(md, mesh_mod.cached_mesh(shape))
    null_K, alt_K = opt.max_K - 1, opt.max_K
    out = BootstrapResult(ts_obs=ts_obs, ts_bs=[], pvalue=0.0,
                          null_K=null_K, alt_K=alt_K)
    done = []
    if checkpoint_dir:
        loaded = _load_bootstrap_synced(checkpoint_dir, null_K, alt_K,
                                        opt.n_bootstrap, seed)
        if loaded is not None:
            done = loaded.tolist()
    if (opt.target_ll or opt.target_revisit or opt.n_seconds
            or opt.verbosity > 3):
        new = _serial_ts(seed, md, opt, n_parameters_fn, h0_params, ploidy,
                         done, checkpoint_dir)
    else:
        new = _batched_ts(seed, md, opt, h0_params, ploidy, done, out,
                          checkpoint_dir)
    ntime = 0
    for rep, t in enumerate(itertools.chain(done, new)):
        out.ts_bs.append(float(t))
        if t >= ts_obs:
            ntime += 1
        if log:
            log(rep, float(t), ntime)
    out.pvalue = ntime / opt.n_bootstrap
    out.seconds = time.time() - t0
    return out
