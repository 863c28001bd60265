"""The port's mixture model and constrained-eta admixture against the JAX
package, on the CPU: the mixture kernels' plain versions against the
Pallas kernels in interpret mode (float32), the plain steps against the
XLA steps (float64, step for step), warm-start fits, inits and the CLI.
The CUDA kernels themselves are held to the plain versions on the card by
tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiclust_tpu.config import InitMethod as JaxInitMethod, Options
from multiclust_tpu.model import admixture as jadm, mixture as jmix
from multiclust_tpu.model.common import EMConfig as JaxEMConfig, \
    Params as JaxParams, collapse_for_constrained as jax_collapse, \
    model_data_from_dataset as jax_model_data
from multiclust_tpu.ops import df64
from multiclust_tpu.opt.driver import fit as jax_fit
from multiclust_tpu.runtime.ksweep import estimate_model as jax_estimate
from multiclust_tpu.stats.sim import random_model, simulate_admixture_fast, \
    simulate_mixture
from multiclust_tpu_torch.config import InitMethod
from multiclust_tpu_torch.convert import dataset_from_counts, options_from, \
    params_from_numpy, params_to_numpy
from multiclust_tpu_torch.init import random as rinit
from multiclust_tpu_torch.model import admixture as tadm, mixture as tmix
from multiclust_tpu_torch.model.common import EMConfig, Params, \
    collapse_for_constrained, model_data_from_dataset
from multiclust_tpu_torch.opt.driver import fit
from multiclust_tpu_torch.runtime.ksweep import estimate_model
from multiclust_tpu_torch.runtime.multistart import cfg_from_options, \
    device_policy, hard_partition

torch.set_num_threads(2)

# float32: the Pallas kernels' approximate reciprocal (kernels.py:145)
# holds interpret mode to XLA only this close (test_kernels.py:736-742)
INTERPRET = dict(rtol=2e-4, atol=1e-5)


def _mixture_panel(seed, K=3, I=70, L=50, M=2, missing_rate=0.0, ploidy=2):
    """A mixture-model panel; biallelic panels get both allele slots valid
    at every locus (the biallelic layout)."""
    rng = np.random.default_rng(seed)
    eta, P = random_model(rng, K, L, M, concentration=0.8)
    ds, z = simulate_mixture(rng, eta, P, I=I, ploidy=ploidy,
                             missing_rate=missing_rate)
    if M == 2:
        ds = dataset_from_counts(ds.counts, ds.miss, ploidy)
    return ds, z


def _warm_mixture(seed, ds, K):
    rng = np.random.default_rng(seed)
    p = rng.dirichlet(np.full(ds.M, 2.0), size=(K, ds.L)) * ds.mask[None]
    return rng.dirichlet(np.full(K, 3.0)), p / p.sum(axis=2, keepdims=True)


def _cfg(ds, **kw):
    base = dict(admixture=False, biallelic=bool((ds.n_alleles == 2).all()
                                                and ds.M == 2),
                has_missing=bool(ds.miss.any()), ploidy=ds.ploidy)
    base.update(kw)
    return base


@pytest.mark.parametrize("variant,missing_rate,ploidy,project", [
    ("two-pass", 0.0, 2, True), ("two-pass", 0.0, 4, False),
    ("two-pass", 0.15, 2, False), ("two-pass", 0.15, 4, True),
    ("resident", 0.0, 2, True), ("resident", 0.0, 4, False),
    ("resident", 0.15, 2, False), ("resident", 0.15, 4, True),
])
def test_kernel_route_matches_pallas_interpret(variant, missing_rate, ploidy,
                                               project, monkeypatch):
    """The port's kernel route (the wrappers' plain versions on CPU
    tensors) against JAX's mixture step through the Pallas kernels in
    interpret mode: mixture_fullstep_biallelic (two-pass) or
    mixture_sweep_resident (resident, its epilogue in XLA).  I = 70 is no
    tile multiple; missing-free panels take the one-stream ploidy fold."""
    if variant == "two-pass":
        import multiclust_tpu.ops.kernels as kmod
        monkeypatch.setattr(kmod, "pick_layout_mixture_resident",
                            lambda *a, **k: (0, 0, 0))
    ds, _ = _mixture_panel(3 + ploidy, missing_rate=missing_rate,
                           ploidy=ploidy)
    eta, p = _warm_mixture(4, ds, 3)
    base = _cfg(ds, do_projection=project, eta_lower_bound=0.05,
                p_lower_bound=1e-3)
    jmd = jax_model_data(ds, dtype=jnp.float32,
                         storage_dtype=jnp.int8).prepare_for_em(bi=True)
    jcfg = JaxEMConfig(use_pallas="interpret", **base)
    jp = JaxParams(eta=jnp.asarray(eta, jnp.float32),
                   p=jnp.asarray(p, jnp.float32))
    assert jmix._kernel_ok(jmd, jcfg, jp)
    tmd = model_data_from_dataset(ds, dtype=torch.float32)
    tcfg = EMConfig(use_pallas="on", **base)
    tp = params_from_numpy(eta[None], p[None], dtype=torch.float32)
    assert tmix._kernel_ok(tmd, tcfg, tp)
    for _ in range(2):
        jp, jll, _, _ = jmix.em_step(jp, jmd, jcfg)
        tp, tll, _ = tmix.em_step(tp, tmd, tcfg)
        np.testing.assert_allclose(tp.eta[0].numpy(), np.asarray(jp.eta),
                                   **INTERPRET)
        np.testing.assert_allclose(tp.p[0].numpy(), np.asarray(jp.p),
                                   **INTERPRET)
        np.testing.assert_allclose(float(tll[0]), float(df64.df_value(jll)),
                                   rtol=1e-5)
    # the kernel route's logL (the rows pass alone) is the step's
    ll, _ = tmix.log_likelihood(tp, tmd, tcfg)
    jll2, _ = jmix.log_likelihood(jp, jmd, jcfg)
    np.testing.assert_allclose(float(ll[0]), float(df64.df_value(jll2)),
                               rtol=1e-5)


@pytest.mark.parametrize("missing_rate", [0.0, 0.15])
def test_sweep_stats_reference_matches_pallas_interpret(missing_rate):
    """The plain sweep statistics against mixture_sweep_resident in
    interpret mode on the same K-padded inputs (pad rows zero)."""
    from multiclust_tpu.ops.kernels import mixture_sweep_resident
    from multiclust_tpu_torch.ops import mixture_bi as mb

    rng = np.random.default_rng(11)
    I, Ip, L, K, Kp = 70, 72, 50, 3, 32
    miss = rng.binomial(2, missing_rate, size=(I, L))
    x0 = rng.binomial(2 - miss, rng.uniform(0.2, 0.8, size=(1, L)))
    x1 = 2 - miss - x0
    lp0 = np.zeros((Kp, L), np.float32)
    lp1 = np.zeros((Kp, L), np.float32)
    lp0[:K] = np.log(rng.uniform(0.1, 0.9, size=(K, L)))
    lp1[:K] = np.log(rng.uniform(0.1, 0.9, size=(K, L)))
    bias = np.full((1, Kp), -1e30, np.float32)
    bias[0, :K] = np.log(rng.dirichlet(np.ones(K)))
    two = missing_rate > 0

    def pad(a):
        return jnp.asarray(np.pad(a, ((0, Ip - I), (0, 0))), jnp.int8)

    jv, jt, jb0, jb1 = mixture_sweep_resident(
        jnp.asarray(lp0), pad(x0), jnp.asarray(bias),
        jnp.asarray(lp1) if two else None, pad(x1) if two else None, ti=8,
        interpret=True)
    tv, tt, tb0, tb1 = mb.mixture_sweep_stats(
        torch.as_tensor(lp0)[None], torch.as_tensor(x0, dtype=torch.int8),
        torch.as_tensor(bias), torch.as_tensor(lp1)[None] if two else None,
        torch.as_tensor(x1, dtype=torch.int8) if two else None)
    np.testing.assert_allclose(tv[0].numpy(), np.asarray(jv)[:I],
                               **INTERPRET)
    np.testing.assert_allclose(tt[0].numpy(), np.asarray(jt)[:I], rtol=1e-5)
    # pad rows of the JAX sweep carry zero x rows, so B never saw them
    np.testing.assert_allclose(tb0[0].numpy(), np.asarray(jb0), **INTERPRET)
    assert (tb1 is None) == (jb1 is None) == (not two)
    if two:
        np.testing.assert_allclose(tb1[0].numpy(), np.asarray(jb1),
                                   **INTERPRET)
    assert (tv[0, :, K:] == 0).all()


@pytest.mark.parametrize("case", ["bi-fold", "bi-missing", "M5", "K1"])
def test_em_step_f64_matches_xla(case):
    """Four float64 mixture steps track the JAX XLA step to 1e-10: the
    biallelic one-product fold, the missing-data path, a multi-allelic
    panel and K = 1."""
    K = 1 if case == "K1" else 3
    M = 5 if case == "M5" else 2
    missing_rate = 0.0 if case == "bi-fold" else 0.1
    ds, _ = _mixture_panel(7, K=max(K, 2), M=M, missing_rate=missing_rate)
    eta, p = _warm_mixture(8, ds, K)
    base = _cfg(ds)
    assert base["biallelic"] == (M == 2)
    assert base["has_missing"] == (missing_rate > 0)
    jmd = jax_model_data(ds, dtype=jnp.float64)
    tmd = model_data_from_dataset(ds, dtype=torch.float64)
    jp = JaxParams(eta=jnp.asarray(eta), p=jnp.asarray(p))
    tp = params_from_numpy(eta[None], p[None])
    for _ in range(4):
        jp, jll, jsc, _ = jmix.em_step(jp, jmd, JaxEMConfig(**base))
        tp, tll, tsc = tmix.em_step(tp, tmd, EMConfig(**base))
        np.testing.assert_allclose(tp.eta[0].numpy(), np.asarray(jp.eta),
                                   rtol=1e-10, atol=1e-14)
        np.testing.assert_allclose(tp.p[0].numpy(), np.asarray(jp.p),
                                   rtol=1e-10, atol=1e-14)
        np.testing.assert_allclose(float(tll[0]),
                                   float(df64.df_value(jll)), rtol=1e-10)
        np.testing.assert_allclose(float(tsc[0]), float(jsc), rtol=1e-10)
    ll, sc = tmix.log_likelihood(tp, tmd, EMConfig(**base))
    jll, jsc = jmix.log_likelihood(jp, jmd, JaxEMConfig(**base))
    np.testing.assert_allclose(float(ll[0]), float(df64.df_value(jll)),
                               rtol=1e-10)


@pytest.mark.parametrize("label,kw", [
    ("plain", dict(check_interval=1)),
    ("adaptive", dict(check_interval=0)),
    ("squarem", dict(accel_scheme=1, adjust_step=3)),
    ("qn1", dict(accel_scheme=4, q=1)),
    ("qn2", dict(accel_scheme=4, q=2)),
])
def test_mixture_fit_matches_jax(label, kw):
    """Warm-start mixture fits through the JAX driver and the port reach
    the same logL in the same number of iterations."""
    ds, _ = _mixture_panel(12, I=90, L=60, missing_rate=0.05)
    eta, p = _warm_mixture(13, ds, 3)
    base = _cfg(ds, **kw)
    jr = jax_fit(JaxParams(eta=jnp.asarray(eta), p=jnp.asarray(p)),
                 jax_model_data(ds, dtype=jnp.float64), JaxEMConfig(**base))
    tr = fit(params_from_numpy(eta, p),
             model_data_from_dataset(ds, dtype=torch.float64),
             EMConfig(**base))
    assert tr.converged and jr.converged
    assert tr.n_iter == jr.n_iter, (tr.n_iter, jr.n_iter)
    np.testing.assert_allclose(tr.logL, jr.logL, rtol=1e-10)


@pytest.mark.parametrize("missing_rate", [0.0, 0.2])
def test_partition_mixture_params_exact(missing_rate):
    """The add-one-smoothed parameters of a shared hard partition equal
    the JAX package's one-hot sums, on a multi-allelic mask."""
    from multiclust_tpu.init.random import \
        parameters_from_partition_mixture as jax_from_partition
    rng = np.random.default_rng(14)
    P = rng.dirichlet(np.ones(4), size=(4, 30))
    P[:, ::2, 3] = 0.0                   # every other locus: three alleles
    P /= P.sum(axis=2, keepdims=True)
    ds, z = simulate_mixture(rng, np.full(4, 0.25), P, I=60,
                             missing_rate=missing_rate)
    assert not ds.mask.all()
    md = model_data_from_dataset(ds, dtype=torch.float64)
    got = rinit.parameters_from_partition_mixture(torch.as_tensor(z), md, 4)
    want = jax_from_partition(jnp.asarray(z),
                              jax_model_data(ds, dtype=jnp.float64), 4)
    np.testing.assert_allclose(got.eta.numpy(), np.asarray(want.eta),
                               rtol=1e-15)
    np.testing.assert_allclose(got.p.numpy(), np.asarray(want.p),
                               rtol=1e-15)
    assert got.eta.shape == (4,) and got.p.shape == (4, ds.L, ds.M)


@pytest.mark.parametrize("method", [InitMethod.RANDOM_CENTERS,
                                    InitMethod.RANDOM_PARTITION])
@pytest.mark.parametrize("K", [2, 4])
def test_mixture_init_draws_are_valid(method, K):
    """Individual partitions: every label in range and used; random
    centers join their own cluster and sort a well-separated panel by its
    true clusters far better than chance; the smoothed params are on the
    simplex."""
    ds, z = _mixture_panel(15 + K, K=K, I=200, L=80, missing_rate=0.1)
    md = model_data_from_dataset(ds, dtype=torch.float64)
    gen = torch.Generator().manual_seed(K)
    if method == InitMethod.RANDOM_PARTITION:
        part = rinit.random_individual_partition(gen, md, K)
        counts = torch.bincount(part, minlength=K)
        assert counts.min() > 0.5 * counts.float().mean()
    else:
        gen2 = torch.Generator().manual_seed(K)
        centers = torch.randperm(md.I, generator=gen2)[:K]
        part = rinit.random_individual_center(gen, md, K)
        assert (part[centers] == torch.arange(K)).all()
        # the assignment agrees with the truth up to a relabelling more
        # often than not when centers land in distinct true clusters
        from multiclust_tpu.stats.rand_index import adjusted_rand
        if len(set(z[centers.numpy()])) == K:
            assert adjusted_rand(z, part.numpy()) > 0.5
    assert part.shape == (ds.I,)
    assert 0 <= int(part.min()) <= int(part.max()) < K
    params = rinit.random_initialize(gen, md, K, method, admixture=False)
    np.testing.assert_allclose(float(params.eta.sum()), 1.0, rtol=1e-12)
    np.testing.assert_allclose(params.p.sum(dim=2).numpy(), 1.0, rtol=1e-12)
    assert float(params.p[:, torch.as_tensor(ds.mask)].min()) > 0


def _admixture_panel(seed, I=60, L=80, missing_rate=0.1):
    rng = np.random.default_rng(seed)
    Q = rng.dirichlet(np.full(3, 0.3), size=I)
    p0 = rng.choice([0.1, 0.5, 0.9], size=(3, L))
    return simulate_admixture_fast(rng, Q, np.stack([p0, 1 - p0], axis=2),
                                   missing_rate=missing_rate)


@pytest.mark.parametrize("collapsed", [False, True])
def test_constrained_step_matches_jax(collapsed):
    """Four constrained-eta steps (eta a K-vector) track JAX's
    _em_step_constrained to 1e-10, on the full data and on the collapsed
    column sums; the logL and the posterior allele mass agree too."""
    ds = _admixture_panel(20)
    rng = np.random.default_rng(21)
    eta = rng.dirichlet(np.full(3, 2.0))
    p0 = rng.uniform(0.2, 0.8, size=(3, ds.L))
    p = np.stack([p0, 1 - p0], axis=2)
    base = dict(admixture=True, eta_constrained=True, has_missing=True)
    jmd = jax_model_data(ds, dtype=jnp.float64)
    tmd = model_data_from_dataset(ds, dtype=torch.float64)
    if collapsed:
        jmd, tmd = jax_collapse(jmd), collapse_for_constrained(tmd)
        assert tmd.I == 1
    jp = JaxParams(eta=jnp.asarray(eta), p=jnp.asarray(p))
    tp = params_from_numpy(eta[None], p[None])
    cfg = EMConfig(**base)
    for _ in range(4):
        jp, jll, jsc = jadm.em_step(jp, jmd, JaxEMConfig(**base))
        tp, tll, tsc = tadm.em_step(tp, tmd, cfg)
        np.testing.assert_allclose(tp.eta[0].numpy(), np.asarray(jp.eta),
                                   rtol=1e-10, atol=1e-14)
        np.testing.assert_allclose(tp.p[0].numpy(), np.asarray(jp.p),
                                   rtol=1e-10, atol=1e-14)
        np.testing.assert_allclose(float(tll[0]),
                                   float(df64.df_value(jll)), rtol=1e-10)
        np.testing.assert_allclose(float(tsc[0]), float(jsc), rtol=1e-10)
    ll, _ = tadm.log_likelihood_constrained(tp, tmd)
    np.testing.assert_allclose(
        float(ll[0]), float(df64.df_value(jadm.log_likelihood(jp, jmd)[0])),
        rtol=1e-10)
    full = model_data_from_dataset(ds, dtype=torch.float64)
    dik = tadm.posterior_allele_mass(Params(tp.eta[0], tp.p[0]), full,
                                     eta_constrained=True)
    want = jadm.posterior_allele_mass(jp, jax_model_data(ds,
                                                         dtype=jnp.float64))
    np.testing.assert_allclose(dik.numpy(), np.asarray(want), rtol=1e-10)


def _opt(**kw):
    base = dict(min_K=3, max_K=3, n_init=1, seed=7, verbosity=0,
                write_files=False, dtype="float64")
    base.update(kw)
    return Options(**base)


@pytest.mark.parametrize("model,accel", [
    ("mixture", 0), ("mixture", 1), ("constrained", 0), ("constrained", 1),
])
def test_estimate_model_matches_jax(model, accel):
    """Warm-start K-sweeps through the engines: the mixture, and
    constrained eta fitted on the collapsed data, reach the JAX package's
    logL, AIC and BIC in the same number of iterations."""
    if model == "mixture":
        ds, _ = _mixture_panel(30, I=80, L=60, missing_rate=0.05)
        eta, p = _warm_mixture(31, ds, 3)
        opt = _opt(admixture=False, accel_scheme=accel)
    else:
        ds = _admixture_panel(32)
        eta, p = _warm_mixture(33, ds, 3)
        opt = _opt(admixture=True, eta_constrained=True, accel_scheme=accel)
    opt = opt.synchronize(ds.I, ds.ploidy)

    def n_par(K):
        return ds.n_parameters(K, opt.admixture, opt.eta_constrained)

    je = jax_estimate(jax.random.PRNGKey(0),
                      jax_model_data(ds, dtype=jnp.float64), opt, n_par,
                      warm=JaxParams(eta=jnp.asarray(eta),
                                     p=jnp.asarray(p)))
    te = estimate_model(0, model_data_from_dataset(ds, dtype=torch.float64),
                        options_from(opt), n_par,
                        warm=params_from_numpy(eta, p))
    jr, tr = je.per_K[3], te.per_K[3]
    for a in ("max_logL", "aic", "bic"):
        np.testing.assert_allclose(getattr(tr, a), getattr(jr, a),
                                   rtol=1e-10)
    assert tr.n_total_iter == jr.n_total_iter and tr.ever_converged
    assert tr.best_params.eta.shape == (3,)
    np.testing.assert_allclose(tr.best_params.eta.numpy(),
                               np.asarray(jr.best_params.eta), atol=1e-8)


@pytest.mark.parametrize("model", ["mixture", "constrained"])
def test_k1_matches_jax(model):
    """K = 1: one EM step and the logL of its result, as in JAX."""
    ds = (_mixture_panel(34, missing_rate=0.1)[0] if model == "mixture"
          else _admixture_panel(35))
    opt = _opt(admixture=model != "mixture",
               eta_constrained=model != "mixture", min_K=1, max_K=1,
               initialization_method=JaxInitMethod.RANDOM_PARTITION)
    opt = opt.synchronize(ds.I, ds.ploidy)

    def n_par(K):
        return ds.n_parameters(K, opt.admixture, opt.eta_constrained)

    codes = None
    if opt.admixture:
        from multiclust_tpu.init.random import codes_from_counts
        codes = codes_from_counts(ds.counts, ds.miss, ds.ploidy)
    je = jax_estimate(jax.random.PRNGKey(0),
                      jax_model_data(ds, dtype=jnp.float64), opt, n_par,
                      codes=None if codes is None else jnp.asarray(codes))
    tmd = model_data_from_dataset(ds, dtype=torch.float64)
    te = estimate_model(0, tmd, options_from(opt), n_par,
                        codes=None if codes is None
                        else rinit.codes_from_counts(tmd.x, tmd.miss, 2))
    # K = 1 starts are draw-free: every copy joins the one cluster
    np.testing.assert_allclose(te.per_K[1].max_logL, je.per_K[1].max_logL,
                               rtol=1e-10)
    assert te.per_K[1].best_params.eta.shape == (1,)


def test_rand_em_scores_constrained_candidates_on_collapsed_data():
    """Rand-EM for -c draws its candidates on the full data and scores
    them on the collapsed data: the same winner as scoring on the full
    data, whose logL it equals; the mixture's Rand-EM keeps the best
    scoring draw."""
    ds = _admixture_panel(40, I=40, L=50)
    md = model_data_from_dataset(ds, dtype=torch.float64)
    codes = rinit.codes_from_counts(md.x, md.miss, 2)
    cfg = EMConfig(admixture=True, eta_constrained=True)
    picks = [rinit.rand_em_initialize(
        torch.Generator().manual_seed(5), md, 3, cfg,
        InitMethod.RANDOM_PARTITION, 6, codes, md_score=score, chunk=4)
        for score in (collapse_for_constrained(md), md)]
    assert torch.equal(picks[0].eta, picks[1].eta)
    assert picks[0].eta.shape == (3,)

    mds, _ = _mixture_panel(41, I=50, L=40)
    mmd = model_data_from_dataset(mds, dtype=torch.float64)
    mcfg = EMConfig(**_cfg(mds))
    best = rinit.rand_em_initialize(torch.Generator().manual_seed(6), mmd, 3,
                                    mcfg, InitMethod.RANDOM_PARTITION, 5,
                                    chunk=2)
    gen = torch.Generator().manual_seed(6)
    scores, cands = [], []
    for _ in range(5):
        c = rinit.random_initialize(gen, mmd, 3, InitMethod.RANDOM_PARTITION,
                                    admixture=False)
        stepped, _, _ = tmix.em_step(Params(c.eta[None], c.p[None]), mmd,
                                     mcfg)
        scores.append(float(tmix.log_likelihood(stepped, mmd, mcfg)[0][0]))
        cands.append(c)
    want = cands[int(np.argmax(scores))]
    assert torch.equal(best.eta, want.eta) and torch.equal(best.p, want.p)


def test_hard_partition_and_policy():
    """The mixture's hard partition is the posterior argmax, as JAX's;
    float32 mixture fits on CUDA take the kernels, with the ploidy pinned
    from the data."""
    from multiclust_tpu.runtime.multistart import \
        hard_partition as jax_partition
    ds, z = _mixture_panel(42, I=80, L=60, missing_rate=0.05)
    eta, p = _warm_mixture(43, ds, 3)
    got = hard_partition(params_from_numpy(eta, p),
                         model_data_from_dataset(ds, dtype=torch.float64),
                         admixture=False)
    want = jax_partition(JaxParams(eta=jnp.asarray(eta), p=jnp.asarray(p)),
                         jax_model_data(ds, dtype=jnp.float64), False)
    np.testing.assert_array_equal(got, want)
    opt = options_from(Options(admixture=False, dtype="float32"))
    assert device_policy(opt, "cuda") == (True, torch.int8)
    assert device_policy(opt, "cpu") == (False, None)
    ds4, _ = _mixture_panel(44, ploidy=4)
    opt4 = opt.synchronize(ds4.I, ds4.ploidy)
    cfg = cfg_from_options(opt4, 3, model_data_from_dataset(ds4))
    assert cfg.ploidy == 4 and cfg.biallelic and not cfg.admixture
    assert not cfg.bi_repr_active and cfg.k_true == 0


def test_params_from_numpy_keeps_vector_eta():
    """A K-vector eta crosses without trimming, batched or not; the
    per-individual eta still loses the JAX engine's pad rows."""
    rng = np.random.default_rng(45)
    for eta, p in ((rng.dirichlet(np.ones(4)), rng.uniform(size=(4, 20, 2))),
                   (rng.dirichlet(np.ones(4), size=2),
                    rng.uniform(size=(2, 4, 20, 2)))):
        back = params_from_numpy(eta, np.pad(p, [(0, 0)] * (p.ndim - 2)
                                             + [(0, 12), (0, 0)]),
                                 n_rows=3, n_loci=20)
        e2, q2 = params_to_numpy(back)
        assert (e2 == eta).all() and (q2 == p).all()
    eta_i = rng.dirichlet(np.ones(4), size=30)
    back = params_from_numpy(eta_i, rng.uniform(size=(4, 20, 2)), n_rows=25)
    assert back.eta.shape == (25, 4)


def _write_structure(ds, path):
    """STRUCTURE rows, one per allele copy: allele m + 1 once for each
    count of slot m, then -9 for each missing copy."""
    with open(path, "w") as fh:
        fh.write(" ".join(f"loc{l}" for l in range(ds.L)) + "\n")
        for i in range(ds.I):
            copies = [np.concatenate([np.repeat(np.arange(1, ds.M + 1),
                                                ds.counts[i, l]),
                                      np.full(ds.miss[i, l], -9)])
                      for l in range(ds.L)]
            for a in range(ds.ploidy):
                fh.write(f"ind{i} pop{i % 2} "
                         + " ".join(str(c[a]) for c in copies) + "\n")


@pytest.mark.parametrize("model", ["mixture", "constrained"])
def test_cli_warm_start_matches_jax(tmp_path, capsys, model):
    """The CPU CLI without -a and with -a -c against the JAX CLI from the
    same -Q/-P warm start: the same printed summary and output files."""
    import re

    from multiclust_tpu.cli import main as jax_main
    from multiclust_tpu_torch.cli import main

    if model == "mixture":
        ds, _ = _mixture_panel(50, I=60, L=80, missing_rate=0.05)
        flags, tag = [], "mix"
    else:
        ds = _admixture_panel(51, L=80, missing_rate=0.05)
        flags, tag = ["-a", "-c"], "admix"
    data = str(tmp_path / "sim.str")
    _write_structure(ds, data)
    rng = np.random.default_rng(52)
    qf, pf = str(tmp_path / "w.q"), str(tmp_path / "w.p")
    np.savetxt(qf, rng.dirichlet(np.full(3, 3.0))[None], fmt="%.17g")
    np.savetxt(pf, rng.uniform(0.2, 0.8, size=(ds.L, 3)), fmt="%.17g")
    outs = {}
    for name, entry in (("jax", jax_main), ("torch", main)):
        d = tmp_path / name
        d.mkdir()
        assert entry(["-f", data, "-k", "3", "-n", "1", "-Q", qf, "-P", pf,
                      "--platform", "cpu", "-d", str(d)] + flags) == 0
        outs[name] = d
    printed = [ln.split() for ln in capsys.readouterr().out.splitlines()
               if ln.startswith(data)]
    assert len(printed) == 2 and printed[0][2] == tag
    assert printed[0][9:12] == printed[1][9:12]
    files = sorted(f.name for f in outs["jax"].iterdir())
    assert files == sorted(f.name for f in outs["torch"].iterdir())
    assert len(files) == 5

    def numbers(path):
        with open(path) as fh:
            return np.array([float(v) for v in re.findall(
                r"-?\d+\.\d+(?:e[-+]\d+)?|-?\d+", fh.read())])

    for f in files:
        np.testing.assert_allclose(numbers(outs["torch"] / f),
                                   numbers(outs["jax"] / f), atol=1.5e-6)


def test_cli_cold_start_runs_both_models(tmp_path, capsys):
    """Cold starts (random centers, Rand-EM) of the mixture and of -a -c
    through the CPU CLI write every file."""
    from multiclust_tpu_torch.cli import main

    ds, _ = _mixture_panel(53, I=50, L=40, missing_rate=0.05)
    data = str(tmp_path / "sim.str")
    _write_structure(ds, data)
    for flags in ([], ["-a", "-c", "-m", "3"]):
        d = tmp_path / ("c" if flags else "m")
        d.mkdir()
        assert main(["-f", data, "-k", "2", "-n", "3", "-s", "1",
                     "--platform", "cpu", "-d", str(d)] + flags) == 0
        assert len(list(d.iterdir())) == 5
        line = capsys.readouterr().out.strip().splitlines()[-1].split()
        assert np.isfinite(float(line[9])) and int(line[16]) == 3


def test_float32_kernel_route_fit_stays_near_f64():
    """A float32 warm-start fit through the kernel route's plain versions
    ends within 0.1 logL of the float64 plain fit capped at 30 iterations
    (this panel converges before the cap)."""
    ds, _ = _mixture_panel(54, I=120, L=100, missing_rate=0.05)
    eta, p = _warm_mixture(55, ds, 3)
    base = _cfg(ds, max_iter=30, abs_error=1e-12)
    ref = fit(params_from_numpy(eta, p),
              model_data_from_dataset(ds, dtype=torch.float64),
              EMConfig(**base))
    got = fit(params_from_numpy(eta, p, dtype=torch.float32),
              model_data_from_dataset(ds, dtype=torch.float32),
              EMConfig(use_pallas="on", **base))
    assert ref.n_iter <= 31 and got.n_iter <= 31 and ref.converged
    assert abs(got.logL - ref.logL) < 0.1


def test_blind_steps_match_checked_steps():
    """Blind kernel-route steps (want_ll=False, as blind_plain_steps runs
    them) give the same parameters as checked ones."""
    from multiclust_tpu_torch.opt import em as em_mod

    ds, _ = _mixture_panel(56, missing_rate=0.0)
    eta, p = _warm_mixture(57, ds, 3)
    md = model_data_from_dataset(ds, dtype=torch.float32)
    cfg = EMConfig(use_pallas="on", **_cfg(ds))
    params = params_from_numpy(eta[None], p[None], dtype=torch.float32)
    state = em_mod.init_state(params, cfg)
    blind = em_mod.blind_plain_steps(state, md, cfg,
                                     torch.full((1,), 3), 3)
    want = params
    for _ in range(3):
        want, ll, _ = tmix.em_step(want, md, cfg)
    assert torch.equal(blind.params.eta, want.eta)
    assert torch.equal(blind.params.p, want.p)
    assert int(blind.n_iter[0]) == 3
    _, ll0, _ = tmix.em_step(params, md, cfg, want_ll=False)
    assert float(ll0[0]) == 0.0


# the columns pass's tile (loci a block) at each Kp, one and two streams:
# a warp takes one 16-locus MMA tile by as many 8-cluster tiles as keep
# 8 accumulator tiles a thread, and the cluster tiles split over warps
# beyond that
MIX_COLS_TILES = {(32, False): 128, (32, True): 128, (64, False): 128,
                  (64, True): 64, (96, False): 64, (96, True): 32,
                  (128, False): 64, (128, True): 32}


@pytest.mark.parametrize("Kp,two", sorted(MIX_COLS_TILES))
def test_mixture_cols_tile_mirror(Kp, two):
    """``ops/mixture_bi.cols_tile``, the Python mirror of the columns
    pass's ColsTile (the card's tests hold it to the built library): the
    block's loci are one 16-locus MMA tile for each of its locus warps, at
    most 32 float64 accumulators a thread; two blocks an SM only at Kp =
    32 and 96 with one stream."""
    from multiclust_tpu_torch.ops import mixture_bi as mb

    tc = mb.cols_tile(Kp, two)
    assert tc == MIX_COLS_TILES[Kp, two]
    ns, nt8 = (2 if two else 1), Kp // 8
    wl = tc // 16                           # locus warps
    wn = mb.NW // wl                        # cluster warps
    assert wl * wn == mb.NW and nt8 % wn == 0
    assert 4 * ns * (nt8 // wn) <= 32
    assert mb.cols_blocks_per_sm(Kp, two) == (
        2 if (Kp, two) in ((32, False), (96, False)) else 1)


@pytest.mark.parametrize("I,L,B", [(1, 17, 1), (40, 2048, 2),
                                   (16384, 2048, 2), (16384, 2048, 32),
                                   (8192, 131072, 2), (131072, 64, 32),
                                   (131071, 1000, 7), (4000, 96, 2)])
def test_mixture_cols_segments_cover_rows(I, L, B):
    """The row segments of the columns pass cover I exactly, in whole
    stages of COL_RI rows, each at least 4 stages where there is more than
    one, their blocks fit one wave of the card where there is more than
    one segment, and their count stays within the grid's limit (65535) for
    I up to 2^17 rows and B up to 32 chains, at every Kp and both stream
    variants."""
    from multiclust_tpu_torch.ops import mixture_bi as mb
    from multiclust_tpu_torch.ops.fullstep_bi import GRID_YZ_MAX

    for Kp in (32, 64, 96, 128):
        for two in (False, True):
            n_seg, seg_rows = mb.cols_segments(I, L, B, Kp, two, 132)
            assert 1 <= n_seg <= GRID_YZ_MAX
            assert seg_rows % mb.COL_RI == 0
            assert (n_seg - 1) * seg_rows < I <= n_seg * seg_rows
            assert n_seg == 1 or seg_rows >= 4 * mb.COL_RI
            # one wave: the blocks fit the card's slots (132 SMs)
            tiles = -(-L // mb.cols_tile(Kp, two)) * B
            assert n_seg == 1 or \
                n_seg * tiles <= mb.cols_blocks_per_sm(Kp, two) * 132


def test_kernel_report_names_the_mixture_passes():
    """``kernel_report.ptxas_lines`` tells the two stream variants of a
    mixture pass apart by their bool template argument, and keeps the
    admixture kernels' names as they were."""
    from multiclust_tpu_torch.kernel_report import CONTRACTIONS, ptxas_lines

    def entry(mangled, regs):
        return (f"ptxas info    : Function properties for {mangled}\n"
                f"    0 bytes stack frame, 0 bytes spill stores, 0 bytes "
                f"spill loads\nptxas info    : Used {regs} registers, used "
                f"1 barriers\n")

    report = (entry("_ZN53_GLOBAL__N__3e1c2b7a_13_mixture_bi_cu_9f0d1e2a_"
                    "3141515mix_rows_kernelILi32ELb1EEEvPKfS2_PKaS4_S2_PfS5"
                    "_iii", 112)
              + entry("_ZN53_GLOBAL__N__3e1c2b7a_13_mixture_bi_cu_9f0d1e2a_"
                      "3141515mix_cols_kernelILi128ELb0EEEvPKfPKaS4_PfS5_iiii",
                      177)
              + entry("_ZN54_GLOBAL__N__0a1b2c3d_14_fullstep_bi_cu_4d5e6f7a_"
                      "2718223fullstep_bi_cols_kernelILi64EEEvPKfS2_PKaS4_S4_"
                      "S2_PfS5_S5_S5_iiiiiiiiffi", 128)
              + entry("_ZN53_GLOBAL__N__3e1c2b7a_13_mixture_bi_cu_9f0d1e2a_"
                      "3141517mix_finish_kernelILi1EEEvNS_10FinishArgsE",
                      30))
    lines = ptxas_lines(report, CONTRACTIONS)
    assert [name for name, _ in lines] == [
        "mix_rows_kernel<32, true>", "mix_cols_kernel<128, false>",
        "fullstep_bi_cols_kernel<64>"]
    assert lines[0][1] == ("Used 112 registers, used 1 barriers; 0 bytes "
                           "stack frame, 0 bytes spill stores, 0 bytes "
                           "spill loads")


@pytest.mark.parametrize("miss_rate", [0.0, 0.02])
def test_pad_bias_marks_the_pad_lanes_for_the_rows_kernel(miss_rate):
    """model/mixture.PAD_BIAS, the bias of the K-pad lanes, gives them
    exactly zero posterior mass in the rows pass's plain version (which
    knows no k_true; the kernels stop at k_true, csrc/mixture_bi.cu no
    longer reads the bias for it): v is 0 there and v and t equal the
    same pass over the live lanes alone, in inputs built as
    route_times.mixture_step_inputs builds them for chip_smoke.py."""
    from multiclust_tpu_torch.ops import mixture_bi as mb
    from multiclust_tpu_torch.route_times import mixture_step_inputs

    K, Kp = 5, 32
    lp0, x0, bias, lp1, x1 = mixture_step_inputs(3, 2, 40, 300, K, Kp,
                                                 miss_rate, "cpu")
    assert bias.dtype == torch.float32
    assert (bias[:, K:] == tmix.PAD_BIAS).all()
    assert (bias[:, :K] > tmix.PAD_BIAS / 10).all()
    v, t = mb.mixture_rows_reference(lp0, x0, bias, lp1, x1)
    assert (v[..., K:] == 0).all()
    live = mb.mixture_rows_reference(
        lp0[:, :K], x0, bias[:, :K], None if lp1 is None else lp1[:, :K], x1)
    torch.testing.assert_close(v[..., :K], live[0], rtol=0, atol=0)
    torch.testing.assert_close(t, live[1], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the finish (eta' and p0' in one launch on the card) against the JAX
# package

# float32: the plain finish against the Pallas step in interpret mode
# (its p0' through the kernel's Newton-refined reciprocal, kernels.py:145,
# and B0 / B1 summed over the rows in another order; the ploidy fold's
# pc1 = ploidy vtot - B0 cancels where p0' nears 1, so the two sums'
# rounding shows there as an absolute error of a few ulps of 1) and
# against _finish_eta; float64: against the XLA M-step
FINISH_F32 = dict(rtol=1e-5, atol=1e-5)
FINISH_F64 = dict(rtol=1e-10, atol=1e-10)
FINISH_SEGMENTS = (1, 3, 7)


def finish_case(Kp, K, two, project, seed):
    """The port's plain finish (``mixture_finish`` on CPU tensors) on
    partials of a JAX posterior cut into 1, 3 and 7 row segments, against
    the JAX package: p0' against ``mixture_fullstep_biallelic`` in
    interpret mode and eta' against ``_finish_eta`` in float32, both
    against the XLA M-step in float64; the model's layout against the
    K-padded outputs.  Numpy inputs from ``seed``: 48 x 128, one stream
    (the ploidy fold) or two (10 % missing)."""
    from multiclust_tpu.ops.kernels import mixture_fullstep_biallelic
    from multiclust_tpu_torch.ops import mixture_bi as mb

    rng = np.random.default_rng(seed)
    I, L, ploidy = 48, 128, 2
    lb, plb = min(0.01, 0.1 / K), 1e-3
    miss = rng.binomial(2, 0.1 if two else 0.0, size=(I, L))
    x0 = rng.binomial(2 - miss, rng.uniform(0.2, 0.8, size=(1, L)))
    x1 = 2 - miss - x0
    p0 = rng.uniform(0.05, 0.95, size=(K, L))
    log_eta = np.log(rng.dirichlet(np.ones(K)))
    lp0, lp1 = np.zeros((Kp, L), np.float32), np.zeros((Kp, L), np.float32)
    bias = np.full((1, Kp), -1e30, np.float32)
    if two:
        lp0[:K], lp1[:K], bias[0, :K] = np.log(p0), np.log1p(-p0), log_eta
    else:
        lp0[:K] = np.log(p0) - np.log1p(-p0)
        bias[0, :K] = ploidy * np.log1p(-p0).sum(1) + log_eta
    jv, _, jp0 = mixture_fullstep_biallelic(
        jnp.asarray(lp0), jnp.asarray(x0, jnp.int8), jnp.asarray(bias),
        jnp.asarray(lp1) if two else None,
        jnp.asarray(x1, jnp.int8) if two else None, ti=8, tl=L, plb=plb,
        ploidy=ploidy, project=project, interpret=True)
    jv = np.asarray(jv)
    base = dict(admixture=False, biallelic=True, has_missing=two,
                ploidy=ploidy, do_projection=project, eta_lower_bound=lb,
                p_lower_bound=plb)
    jmd = jax_model_data(dataset_from_counts(np.stack([x0, x1], -1), miss,
                                             ploidy), dtype=jnp.float64)
    v64 = jnp.asarray(jv[:, :K], jnp.float64)
    want64 = (jmix.m_step if two else jmix._m_step_bi)(
        v64, jmd, JaxEMConfig(**base))
    want_eta = np.asarray(jmix._finish_eta(jnp.asarray(jv[:, :K]),
                                           JaxEMConfig(**base)))
    xs = [torch.as_tensor(x, dtype=torch.int8) for x in (x0, x1)]
    kw = dict(k_true=K, lb=lb, plb=plb, ploidy=ploidy, project=project)
    for n_seg in FINISH_SEGMENTS:
        cuts = np.linspace(0, I, n_seg + 1).astype(int)
        for dtype in (torch.float32, torch.float64):
            v = torch.tensor(jv, dtype=dtype)[None]
            segs = [mb.mixture_cols_reference(
                v[:, lo:hi], xs[0][lo:hi], xs[1][lo:hi] if two else None)
                for lo, hi in zip(cuts[:-1], cuts[1:])]
            part = torch.cat([s[0] for s in segs], dim=1)
            vpart = torch.cat([s[1] for s in segs], dim=1)
            assert part.shape == (1, n_seg, 2 if two else 1, Kp, L)
            eta, vtot, p0n = mb.mixture_finish(part, vpart, **kw)
            torch.testing.assert_close(vtot, vpart.sum(dim=1), rtol=0,
                                       atol=1e-5 * I)
            assert (eta[:, K:] == 0).all()
            if dtype == torch.float32:
                np.testing.assert_allclose(p0n[0].numpy(), np.asarray(jp0),
                                           **FINISH_F32)
                np.testing.assert_allclose(eta[0, :K].numpy(), want_eta,
                                           **FINISH_F32)
            else:
                np.testing.assert_allclose(
                    p0n[0, :K].numpy(), np.asarray(want64.p)[..., 0],
                    **FINISH_F64)
                np.testing.assert_allclose(eta[0, :K].numpy(),
                                           np.asarray(want64.eta),
                                           **FINISH_F64)
            got = mb.mixture_finish(part, vpart, params=True, **kw)
            want = mb.params_layout(eta, p0n, K)
            assert got[1].shape == (1, K, L, 2)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
            if dtype == torch.float64:
                np.testing.assert_allclose(got[1][0].numpy(),
                                           np.asarray(want64.p),
                                           **FINISH_F64)


@pytest.mark.parametrize("Kp,K", [(32, 20), (128, 100)])
@pytest.mark.parametrize("two", [False, True])
@pytest.mark.parametrize("project", [True, False])
def test_finish_matches_jax(Kp, K, two, project):
    """The plain finish at 32 and 128 lanes against the JAX package
    (``finish_case``); test_torch_wide_mixture.py takes 224 and 1024."""
    finish_case(Kp, K, two, project, seed=Kp + 2 * two + project)


@pytest.mark.parametrize("K", [3, 200])
@pytest.mark.parametrize("missing_rate", [0.0, 0.15])
@pytest.mark.parametrize("want_ll", [True, False])
def test_kernel_route_step_writes_the_params_of_two_launches(
        K, missing_rate, want_ll):
    """The model's kernel step, whose finish writes eta [B, K] and p [B,
    K, L, 2] itself, equals on the CPU, bit for bit, the step as two
    finish launches and the glue after them made it: the step's K-padded
    outputs, eta[:, :K] and stack([p0', 1 - p0']) over the live lanes;
    the logL terms too."""
    from multiclust_tpu_torch.model.admixture import _ll_terms
    from multiclust_tpu_torch.ops import mixture_bi as mb

    ds, _ = _mixture_panel(61 + K, K=min(K, 3), missing_rate=missing_rate)
    eta, p = _warm_mixture(62, ds, K)
    md = model_data_from_dataset(ds, dtype=torch.float32)
    cfg = EMConfig(use_pallas="on", **_cfg(ds, eta_lower_bound=1e-4,
                                           p_lower_bound=1e-3))
    params = params_from_numpy(np.stack([eta, eta[::-1]]),
                               np.stack([p, p[::-1]]), dtype=torch.float32)
    assert tmix._kernel_ok(md, cfg, params)
    got, ll, scale = tmix.em_step(params, md, cfg, want_ll)
    args = tmix._kernel_inputs(params, md, cfg)
    eta_p, t, p0n = mb.mixture_fullstep_biallelic(
        *args, k_true=K, lb=1e-4, plb=1e-3, ploidy=cfg.ploidy,
        project=cfg.do_projection)
    p0n = p0n[:, :K]
    assert torch.equal(got.eta, eta_p[:, :K].contiguous())
    assert torch.equal(got.p, torch.stack([p0n, 1.0 - p0n], dim=-1))
    assert got.eta.is_contiguous() and got.p.is_contiguous()
    if want_ll:
        want_ll, want_scale = _ll_terms(t)
        assert torch.equal(ll, want_ll) and torch.equal(scale, want_scale)
    else:
        assert not ll.any() and not scale.any()
