"""The port's bootstrap LRT (stats/bootstrap.py) against the JAX package on
the CPU in float64: the replicate lattice from the same replicate counts
and starts (drawn on the JAX side), the simulator by its law (threefry and
Philox draws are never compared), the chunk-independence of the test
statistics, and the decision on a structured and a homogeneous panel.
Also the frozen SQUAREM macro step (opt/em.accel_macro_step)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiclust_tpu.config import Options as JaxOptions
from multiclust_tpu.init.random import codes_from_counts_jax, \
    initialize as jax_initialize
from multiclust_tpu.model.common import Params as JaxParams, \
    model_data_from_dataset as jax_model_data
from multiclust_tpu.runtime.multistart import \
    cfg_from_options as jax_cfg_from_options
from multiclust_tpu.stats import bootstrap as jax_bootstrap
from multiclust_tpu.stats.sim import simulate_mixture
from multiclust_tpu_torch.config import Options
from multiclust_tpu_torch.convert import model_data_from_numpy, \
    options_from, params_from_numpy
from multiclust_tpu_torch.model.common import map_params, \
    model_data_from_dataset
from multiclust_tpu_torch.opt import em as em_mod
from multiclust_tpu_torch.runtime.ksweep import estimate_model
from multiclust_tpu_torch.runtime.multistart import _draw_init_batch, \
    cfg_from_options, fit_batch
from multiclust_tpu_torch.stats import bootstrap as bs
from multiclust_tpu_torch.stats.sim import simulate_admixture_fast

torch.set_num_threads(2)


def _mixture_panel(seed, M, K=3, I=40, L=30):
    rng = np.random.default_rng(seed)
    P = rng.dirichlet(np.full(M, 0.5), size=(K, L))
    ds, _ = simulate_mixture(rng, np.array([.3, .3, .4]), P, I=I,
                             missing_rate=0.05)
    return ds, P, rng


def _jax_replicates(ds, h0, admixture, R):
    """R replicate count tensors [R, I, L, M] drawn by the JAX package."""
    md = jax_model_data(ds, dtype=jnp.float64)
    counts = jax.vmap(lambda k: jax_bootstrap.simulate_replicate(
        k, h0, md, 2, admixture))(jax.random.split(jax.random.PRNGKey(1), R))
    return md, counts


@pytest.mark.parametrize("admixture,M", [(True, 2), (True, 4), (False, 2),
                                         (False, 4)])
def test_lattice_matches_jax(admixture, M):
    """The port's R x B lattice against the JAX `_fit_lattice` on the same
    replicate counts and the same starts: every lane stops at the same
    iteration and each replicate's max logL agrees to 1e-8 relative."""
    R, B, K = 3, 2, 3
    ds, P, rng = _mixture_panel(5, M, K)
    eta = (rng.dirichlet(np.ones(K), size=ds.I) if admixture
           else rng.dirichlet(np.ones(K)))
    h0 = JaxParams(eta=jnp.asarray(eta), p=jnp.asarray(P))
    md, counts = _jax_replicates(ds, h0, admixture, R)
    opt = JaxOptions(admixture=admixture, min_K=K, max_K=K, n_init=B,
                     dtype="float64", check_interval=1, abs_error=1e-2,
                     max_iter=300).synchronize(ds.I, 2)
    cfg = jax_cfg_from_options(opt, K, md)
    md_b = jax.vmap(lambda x: md._replace(
        x=x.astype(md.x.dtype), x_flat=None, x_bi=None, miss_st=None))(
            counts)
    starts = []
    for r in range(R):
        codes = (codes_from_counts_jax(counts[r], md.miss, 2)
                 if admixture else None)
        one = [jax_initialize(k, jax.tree_util.tree_map(lambda t: t[r],
                                                        md_b), K, cfg,
                              codes=codes)
               for k in jax.random.split(jax.random.PRNGKey(10 + r), B)]
        starts.append(jax.tree_util.tree_map(lambda *t: jnp.stack(t), *one))
    params_rb = jax.tree_util.tree_map(lambda *t: jnp.stack(t), *starts)
    js = jax_bootstrap._fit_lattice(params_rb, md_b, cfg)
    j_ll = np.asarray(js.logL_hi + js.logL_lo)
    j_n = np.asarray(js.n_iter)

    reps = [model_data_from_numpy(np.array(counts[r]), ds.miss, ds.mask,
                                  ds.n_alleles) for r in range(R)]
    params = params_from_numpy(
        *(np.asarray(t).reshape((R * B,) + t.shape[2:])
          for t in (params_rb.eta, params_rb.p)))
    state = bs.fit_lattice(params, reps,
                           cfg_from_options(options_from(opt), K, reps[0]))
    t_ll = state.logL.numpy().reshape(R, B)
    np.testing.assert_array_equal(state.n_iter.numpy().reshape(R, B), j_n)
    np.testing.assert_allclose(t_ll.max(axis=1), j_ll.max(axis=1),
                               rtol=1e-8, atol=0)
    assert (j_n < 301).any()       # some chains converged, not all capped


@pytest.mark.parametrize("label,kw", [
    ("plain EM, adaptive interval", dict(check_interval=0)),
    ("SQUAREM", dict(accel_scheme=1, adjust_step=3)),
])
def test_lattice_equals_each_replicate_fitted_alone(label, kw):
    """Each replicate's lanes of a lattice end with the bits of the same
    starts fitted alone as a B-chain batch (fit_batch): the lattice only
    loops the routed step over replicates."""
    R, B, K = 3, 2, 3
    ds = _admixture_panel(11, I=40, L=30)
    md = model_data_from_dataset(ds, dtype=torch.float64)
    opt = Options(admixture=True, min_K=K, max_K=K, n_init=B,
                  dtype="float64", abs_error=1e-2, max_iter=150,
                  **kw).synchronize(ds.I, 2)
    cfg = cfg_from_options(opt, K, md)
    h0 = params_from_numpy(np.full((ds.I, K), 1.0 / K),
                           np.random.default_rng(3).dirichlet(
                               np.ones(2), size=(K, ds.L)))
    reps = [bs.simulate_replicate(bs._generator("cpu", r), h0, md, 2, True)
            for r in range(R)]
    starts = [_draw_init_batch(bs._generator("cpu", 20 + r), B, rep, K, cfg,
                               opt)
              for r, rep in enumerate(reps)]
    lat = bs.fit_lattice(map_params(lambda *t: torch.cat(t), *starts), reps,
                         cfg)
    for r, (rep, start) in enumerate(zip(reps, starts)):
        alone, _ = fit_batch(start, rep, cfg)
        lanes = slice(r * B, (r + 1) * B)
        assert torch.equal(lat.logL[lanes], alone.logL), label
        assert torch.equal(lat.n_iter[lanes], alone.n_iter), label
        assert torch.equal(lat.params.p[lanes], alone.params.p), label


def _admixture_panel(seed, I=60, L=40, K=3):
    rng = np.random.default_rng(seed)
    Q = rng.dirichlet(np.full(K, 0.3), size=I)
    p0 = rng.choice([0.1, 0.5, 0.9], size=(K, L))
    return simulate_admixture_fast(rng, Q, np.stack([p0, 1 - p0], axis=2),
                                   missing_rate=0.05)


@pytest.mark.parametrize("M,constrained", [(2, False), (4, False),
                                           (3, True)])
def test_simulate_replicate_follows_the_admixture_law(M, constrained):
    """Over many draws from fixed parameters (drawn with numpy), each
    cell's mean count sits within 4 standard errors of (ploidy - miss) q;
    missing copies and invalid allele lanes are exact in every draw."""
    K, I, L, n_draws = 3, 30, 12, 400
    ds, P, rng = _mixture_panel(7, M, K, I=I, L=L)
    ds.miss[0, :] = 2                         # a wholly missing row
    ds.counts[0] = 0
    if M > 2:                                 # one locus with fewer alleles
        ds.mask[0, M - 1] = False
        ds.n_alleles[0] = M - 1
        P[:, 0, M - 1] = 0.0
        P[:, 0] /= P[:, 0].sum(axis=1, keepdims=True)
    eta = rng.dirichlet(np.ones(K)) if constrained else \
        rng.dirichlet(np.ones(K), size=I)
    md = model_data_from_dataset(ds, dtype=torch.float64)
    params = params_from_numpy(eta, P)
    q = (np.broadcast_to(eta, (I, K)) @ P.reshape(K, -1)).reshape(I, L, M)
    n_obs = (2 - ds.miss)[..., None]
    gen = bs._generator("cpu", 5)
    draws = np.stack([bs.simulate_replicate(gen, params, md, 2, True)
                      .x.numpy() for _ in range(n_draws)])
    np.testing.assert_array_equal(draws.sum(axis=-1),
                                  np.broadcast_to(2 - ds.miss, draws.shape[:3]))
    assert (draws[:, :, ~ds.mask] == 0).all()
    mean, var = n_obs * q, n_obs * q * (1 - q)
    se = np.sqrt(var / n_draws)
    ok = se > 0
    z = np.abs(draws.mean(axis=0) - mean)[ok] / se[ok]
    assert z.max() < 4, z.max()
    assert (draws.mean(axis=0)[~ok] == mean[~ok]).all()


def test_simulate_replicate_mixture_clusters_follow_eta():
    """Mixture replicates draw each individual's cluster from eta, then
    its copies from that cluster's p: with one allele per cluster the
    cluster is read off the counts, and its frequencies sit within 4
    standard errors of eta; the biallelic planes keep miss exactly."""
    K, I, L = 3, 3000, 4
    eta = np.array([0.2, 0.3, 0.5])
    P = np.zeros((K, L, K))
    P[np.arange(K), :, np.arange(K)] = 1.0
    rng = np.random.default_rng(2)
    miss = rng.binomial(1, 0.1, size=(I, L))
    miss[:, 0] = 0
    counts = np.zeros((I, L, K), np.int64)
    counts[..., 0] = 2 - miss
    md = model_data_from_numpy(counts, miss, np.ones((L, K), bool),
                               np.full(L, K))
    rep = bs.simulate_replicate(bs._generator("cpu", 9), params_from_numpy(
        eta, P), md, 2, False)
    x = rep.x.numpy()
    np.testing.assert_array_equal(x.sum(axis=-1), 2 - miss)
    cluster = x[:, 0].argmax(axis=-1)
    assert (x[np.arange(I), :, cluster] == (2 - miss)).all()
    freq = np.bincount(cluster, minlength=K) / I
    assert (np.abs(freq - eta) < 4 * np.sqrt(eta * (1 - eta) / I)).all()

    bi = model_data_from_dataset(_admixture_panel(4, I=200, L=30),
                                 dtype=torch.float64)
    p0 = np.random.default_rng(1).uniform(0.1, 0.9, size=(K, bi.L))
    rep = bs.simulate_replicate(bs._generator("cpu", 3), params_from_numpy(
        eta, np.stack([p0, 1 - p0], axis=2)), bi, 2, False)
    assert rep.x0.data_ptr() == rep.x.data_ptr() and rep.miss is bi.miss
    assert torch.equal(rep.x0 + rep.x1, 2 - bi.miss)


def _observed(ds, opt, seed=0):
    md = model_data_from_dataset(ds, dtype=torch.float64)
    opt = opt.synchronize(ds.I, ds.ploidy)

    def npar(K):
        return ds.n_parameters(K, opt.admixture, opt.eta_constrained)
    est = estimate_model(seed, md, opt, npar)
    return md, opt, npar, est


@pytest.mark.parametrize("admixture", [True, False])
def test_ts_does_not_depend_on_the_chunk(admixture, capsys, monkeypatch):
    """Replicate r's draws depend on (seed, r) alone: chunks of 1, 3 and
    all replicates give the same statistics, bit for bit; the p-value is
    the direct count.  The serial regime (-v 4 here) draws the same
    replicates and starts, and fits them to the same statistics (K - 1 >
    1: at K = 1 the serial regime takes one EM step, as the reference
    does, and the lattice runs EM to convergence, as the JAX package's
    does)."""
    opt = Options(admixture=admixture, min_K=3, max_K=3, n_init=2,
                  n_bootstrap=5, dtype="float64", verbosity=0,
                  check_interval=1, abs_error=1e-2)
    md, opt, npar, est = _observed(_admixture_panel(21, I=40, L=30, K=3),
                                   opt)
    runs = []
    for c in (1, 3, 5):
        monkeypatch.setattr(bs, "replicate_chunk", lambda *a, c=c: c)
        runs.append(bs.run_bootstrap(3, md, opt, npar, est.ts,
                                     est.h0_params, 2))
    assert [r.chunk for r in runs] == [1, 3, 5]
    for r in runs[1:]:
        assert r.ts_bs == runs[0].ts_bs
    ts = np.asarray(runs[0].ts_bs)
    assert np.isfinite(ts).all() and len(set(ts.tolist())) == len(ts)
    assert runs[0].pvalue == (ts >= est.ts).sum() / 5
    serial = bs.run_bootstrap(3, md, dataclasses.replace(opt, verbosity=4),
                              npar, est.ts, est.h0_params, 2)
    assert serial.chunk == 0 and "(EM)" in capsys.readouterr().err
    np.testing.assert_allclose(serial.ts_bs, runs[0].ts_bs, rtol=1e-12)


def test_bootstrap_decision_structured_and_homogeneous(rng):
    """A structured K = 2 panel rejects H0: K = 1 and a homogeneous one
    does not (the panels and thresholds of the JAX package's
    test_bootstrap_lrt_statistical_validity)."""
    def pvalue(ds, seed):
        opt = Options(admixture=True, n_init=2, min_K=2, max_K=2,
                      n_bootstrap=8, dtype="float64", verbosity=0)
        md, opt, npar, est = _observed(ds, opt, seed)
        return bs.run_bootstrap(seed + 1, md, opt, npar, est.ts,
                                est.h0_params, 2).pvalue

    P2 = np.stack([np.stack([np.full(25, 0.9), np.full(25, 0.1)], 1),
                   np.stack([np.full(25, 0.1), np.full(25, 0.9)], 1)])
    Q2 = np.tile(np.array([[1.0, 0.0]]), (30, 1))
    Q2[15:] = [0.0, 1.0]
    assert pvalue(simulate_admixture_fast(rng, Q2, P2, ploidy=2), 0) < 0.2
    ds1 = simulate_admixture_fast(rng, np.tile([[1.0, 0.0]], (30, 1)),
                                  np.stack([P2[0], P2[0]]), ploidy=2)
    assert pvalue(ds1, 2) > 0.2


def _leaves(state):
    out = []
    em_mod.tree_map(out.append, state)
    return out


def test_frozen_squarem_macro_steps_return_at_once(monkeypatch):
    """An accelerated macro step of stopped lanes returns its state after
    one read and runs no EM step; macro step by macro step, before and
    after every lane has stopped, a SQUAREM batch keeps the bits of the
    step without the early return (``_accel_jump``)."""
    ds = _admixture_panel(13, I=40, L=40)
    md = model_data_from_dataset(ds, dtype=torch.float64)
    opt = Options(admixture=True, min_K=3, max_K=3, n_init=3,
                  accel_scheme=1, adjust_step=3,
                  dtype="float64").synchronize(ds.I, 2)
    cfg = cfg_from_options(opt, 3, md)
    start = _draw_init_batch(bs._generator("cpu", 1), 3, md, 3, cfg, opt)
    calls = []
    real = em_mod.two_em_steps
    monkeypatch.setattr(em_mod, "two_em_steps",
                        lambda *a: calls.append(1) or real(*a))
    new = old = bs._make_state(start, md, cfg)
    n_frozen = n_steps = 0
    while n_frozen < 3:
        frozen = bool(new.stopped.all())
        before = len(calls)
        new = em_mod.accel_macro_step(new, md, cfg)
        if frozen:
            assert len(calls) == before
            n_frozen += 1
        old = em_mod._accel_jump(old, md, cfg)
        n_steps += 1
        assert all(torch.equal(a, b)
                   for a, b in zip(_leaves(new), _leaves(old)))
    assert n_steps > n_frozen
