"""The biobank-L slice of the port on the CPU: the streamed and chunked
biallelic steps against the JAX package's Pallas kernels in interpret
mode, the routed EM step and a warm-start fit against the JAX package in
float64, the windowed logL / posterior mass / init against their
unwindowed versions, and the router.

On the CPU the port's wrappers run their plain PyTorch versions (the
kernels themselves are held to those on the card, tests/test_torch_cuda.py).
Inputs are made with numpy from a seed and handed to both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiclust_tpu.config import Options as JaxOptions
from multiclust_tpu.model import admixture as jadm
from multiclust_tpu.model.common import EMConfig as JaxEMConfig, \
    ModelData as JaxModelData, Params as JaxParams, \
    model_data_from_dataset as jax_model_data
from multiclust_tpu.ops import kernels as jk
from multiclust_tpu.runtime.ksweep import estimate_model as jax_estimate
from multiclust_tpu_torch.config import InitMethod
from multiclust_tpu_torch.convert import dataset_from_counts, \
    model_data_from_numpy, options_from, p0_from_padded, params_from_numpy
from multiclust_tpu_torch.init import random as rinit
from multiclust_tpu_torch.model import admixture as tadm
from multiclust_tpu_torch.model.common import EMConfig, Params, \
    column_window, make_model_data, model_data_from_dataset, \
    model_data_from_planes
from multiclust_tpu_torch.ops import fullstep_bi as fb
from multiclust_tpu_torch.runtime import multistart as tms
from multiclust_tpu_torch.runtime.ksweep import estimate_model

torch.set_num_threads(2)

KW = dict(k_true=5, lb=1e-8, plb=1e-8, project=True)


def _inputs(seed, I, L, Kp=32, kt=5, with_miss=True):
    rng = np.random.default_rng(seed)
    eta = np.zeros((I, Kp), np.float32)
    eta[:, :kt] = rng.dirichlet(np.full(kt, 2.0), size=I)
    p0 = np.zeros((Kp, L), np.float32)
    p0[:kt] = rng.uniform(0.2, 0.8, size=(kt, L))
    miss = (rng.binomial(2, 0.1, size=(I, L)) if with_miss
            else np.zeros((I, L), np.int64))
    x0 = rng.binomial(2 - miss, 0.5)
    return eta, p0, x0, 2 - miss - x0, miss


def _jax_args(eta, p0, x0, x1, miss, with_miss):
    return [jnp.asarray(eta), jnp.asarray(p0), jnp.asarray(x0, jnp.int8),
            jnp.asarray(x1, jnp.int8),
            jnp.asarray(miss.sum(axis=1, keepdims=True), jnp.float32),
            jnp.asarray(miss, jnp.int8) if with_miss else None]


def _torch_args(eta, p0, x0, x1, miss, with_miss, dtype=torch.float32):
    t = torch.as_tensor
    return [t(eta).to(dtype)[None], t(p0).to(dtype)[None], t(x0).to(dtype),
            t(x1).to(dtype), t(miss.sum(axis=1)).to(dtype),
            t(miss).to(dtype) if with_miss else None]


def _close(got, want, names):
    """The JAX package's own tolerances (tests/test_kernels.py:377-420)."""
    tol = {"eta'": (1e-5, 1e-6), "p0'": (1e-5, 1e-6), "t": (1e-5, 1e-3),
           "A": (1e-5, 2e-3), "B0": (1e-5, 2e-3), "B1": (1e-5, 2e-3)}
    for name, g, w in zip(names, got, want):
        rtol, atol = tol[name]
        np.testing.assert_allclose(g[0].numpy(), np.asarray(w), rtol=rtol,
                                   atol=atol, err_msg=name)


@pytest.mark.parametrize("with_miss", [False, True])
@pytest.mark.parametrize("compute_t", [True, False])
def test_streamed_matches_jax_streamed(with_miss, compute_t):
    """The port's streamed step (column segments that do not divide L)
    against admixture_fullstep_biallelic_streamed in interpret mode."""
    data = _inputs(17, 128, 256, with_miss=with_miss)
    want = jk.admixture_fullstep_biallelic_streamed(
        *_jax_args(*data, with_miss), ti=64, tl=128, compute_t=compute_t,
        interpret=True, **KW)
    got = fb.admixture_fullstep_biallelic_streamed(
        *_torch_args(*data, with_miss), seg_cols=96, compute_t=compute_t,
        **KW)
    assert got[1].dtype == torch.float64
    _close(got, want, ("eta'", "t", "p0'"))


@pytest.mark.parametrize("variant", ["emit_b", "emit_ab", "kmask",
                                     "project_eta_off"])
def test_streamed_variants_match_jax_streamed(variant):
    data = _inputs(19, 128, 256)
    kw = dict(KW)
    jkw, tkw = {}, {}
    names = ("eta'", "t", "p0'")
    if variant.startswith("emit"):
        kw.update(emit_b=True, emit_a=variant == "emit_ab")
        names = ("A" if kw["emit_a"] else "eta'", "t", "B0", "B1")
    elif variant == "kmask":
        # the runtime lane set in place of the static k_true test
        mask = (np.arange(32) < 5).astype(np.float32)
        kw["k_true"] = 32
        jkw["kmask"], tkw["kmask"] = jnp.asarray(mask), torch.as_tensor(mask)
    else:
        kw["project_eta"] = False
    want = jk.admixture_fullstep_biallelic_streamed(
        *_jax_args(*data, True), ti=64, tl=128, interpret=True, **kw, **jkw)
    got = fb.admixture_fullstep_biallelic_streamed(
        *_torch_args(*data, True), seg_cols=96, **kw, **tkw)
    _close(got, want, names)
    if variant == "project_eta_off":
        # the Michelot is off, the p0 clip is not: they part only here
        assert float(got[2][0, :5].min()) >= 1e-8
        on = fb.admixture_fullstep_biallelic_streamed(
            *_torch_args(*data, True), seg_cols=96, **KW)
        torch.testing.assert_close(got[2], on[2])


@pytest.mark.parametrize("with_miss,emit", [(False, ""), (True, ""),
                                            (False, "b"), (True, "ab")])
def test_chunked_matches_jax_chunked(with_miss, emit):
    """The port's loop over column windows against
    admixture_fullstep_biallelic_chunked (n_chunks=4) in interpret mode,
    and against its own one-window step in float64."""
    data = _inputs(31, 128, 512, with_miss=with_miss)
    kw = dict(KW, emit_b="b" in emit, emit_a="a" in emit)
    want = jk.admixture_fullstep_biallelic_chunked(
        *_jax_args(*data, with_miss), ti=64, tl=128, n_chunks=4,
        interpret=True, **kw)
    got = fb.admixture_fullstep_biallelic_chunked(
        *_torch_args(*data, with_miss), window=128, **kw)
    names = (("A" if "a" in emit else "eta'"), "t", "B0", "B1") \
        if "b" in emit else ("eta'", "t", "p0'")
    _close(got, want, names)
    args64 = _torch_args(*data, with_miss, dtype=torch.float64)
    one = fb.admixture_fullstep_biallelic_chunked(*args64, window=512, **kw)
    for window in (128, 200):          # 200 leaves a short last window
        many = fb.admixture_fullstep_biallelic_chunked(
            *args64, window=window, **kw)
        plain = fb.admixture_fullstep_biallelic_chunked_reference(
            *args64, window=window, **kw)
        for a, b, c in zip(one, many, plain):
            torch.testing.assert_close(b, a, rtol=1e-10, atol=1e-10)
            torch.testing.assert_close(c, a, rtol=1e-10, atol=1e-10)


def test_chunked_threads_a0_through_the_windows():
    """A seed a0 is added once, before the finish, whatever the windows;
    the streamed step is the one-window loop."""
    data = _inputs(33, 64, 300)
    args = _torch_args(*data, True, dtype=torch.float64)
    seed = torch.rand((1, 64, 32), dtype=torch.float64)
    raw = fb.admixture_fullstep_biallelic_chunked(
        *args, window=100, emit_a=True, emit_b=True, **KW)
    seeded = fb.admixture_fullstep_biallelic_chunked(
        *args, window=100, emit_a=True, emit_b=True, a0=seed, **KW)
    torch.testing.assert_close(seeded[0], raw[0] + seed, rtol=1e-12,
                               atol=1e-12)
    streamed = fb.admixture_fullstep_biallelic_streamed(*args, **KW)
    pair = fb.admixture_fullstep_biallelic(*args, **KW)
    for a, b in zip(streamed, pair):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10)


# ---------------------------------------------------------------------------
# the slice as a whole

ROUTES = {
    "pair": fb.Route("pair", 0, 500, 0),
    "streamed": fb.Route("streamed", 96, 500, 0),
    "chunked": fb.Route("chunked", 64, 160, 0),
}


def _panel(seed, I=64, L=500, K=4, miss_rate=0.05):
    rng = np.random.default_rng(seed)
    p0 = rng.uniform(0.2, 0.8, size=(K, L))
    eta = rng.dirichlet(np.full(K, 2.0), size=I)
    miss = rng.binomial(2, miss_rate, size=(I, L))
    x0 = rng.binomial(2 - miss, 0.5)
    counts = np.stack([x0, 2 - miss - x0], axis=2)
    return counts, miss, eta, np.stack([p0, 1 - p0], axis=2)


def _torch_bi(eta, p, K, dtype):
    cfg = EMConfig(admixture=True, has_missing=True, use_pallas="on",
                   biallelic=True, k_true=K)
    params = params_from_numpy(eta[None], p[None], dtype=dtype)
    return tms._to_bi_repr(tms._pad_k(params, cfg), cfg), cfg


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_em_step_under_each_route_matches_jax_f64(route):
    """admixture.em_step of the port in float64, the route passed as an
    argument, against the JAX package's float64 step: 1e-10 a step."""
    counts, miss, eta, p = _panel(41)
    L, K = counts.shape[1], eta.shape[1]
    mask, n_all = np.ones((L, 2), bool), np.full(L, 2)
    jmd = JaxModelData(x=jnp.asarray(counts, jnp.float64),
                       miss=jnp.asarray(miss, jnp.float64),
                       mask=jnp.asarray(mask),
                       n_alleles=jnp.asarray(n_all, jnp.int32))
    jpar = JaxParams(eta=jnp.asarray(eta), p=jnp.asarray(p))
    jcfg = JaxEMConfig(admixture=True, has_missing=True)
    tmd = model_data_from_numpy(counts, miss, mask, n_all)
    tpar, tcfg = _torch_bi(eta, p, K, torch.float64)
    for _ in range(3):
        jpar, jll, _ = jadm.em_step(jpar, jmd, jcfg)
        tpar, tll, _ = tadm.em_step(tpar, tmd, tcfg, route=ROUTES[route])
        got = tms._unpad_k(Params(tpar.eta[0], tpar.p[0]), tcfg)
        np.testing.assert_allclose(got.eta.numpy(), np.asarray(jpar.eta),
                                   rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(got.p.numpy(), np.asarray(jpar.p),
                                   rtol=1e-10, atol=1e-10)
    from multiclust_tpu.ops import df64
    np.testing.assert_allclose(float(tll[0]), float(df64.df_value(jll)),
                               rtol=1e-12)


@pytest.mark.parametrize("mode", ["chunked", "streamed"])
def test_em_step_matches_jax_kernels_in_interpret_mode(monkeypatch, mode):
    """The float32 step of the port under the chunked and the streamed
    route against the JAX em_step with its layout chooser patched to the
    same mode (as tests/test_kernels.py:207-245 and
    tests/test_sharding.py:531-541 patch it), Pallas in interpret mode."""
    from multiclust_tpu.model.common import k_padded_size, pad_params_k
    from multiclust_tpu.runtime.multistart import _to_bi_repr

    monkeypatch.setattr(jk, "pick_layout_biallelic",
                        lambda I, Kp, L, emit_b=False: (0, 0, 0))
    if mode == "chunked":
        monkeypatch.setattr(jk, "_FULLSTEP_BI_TILES",
                            ((64, 128, 2 * 128 * 32 * 4),))
    else:
        monkeypatch.setattr(jk, "pick_layout_biallelic_chunked",
                            lambda I, Kp, L: (0, 0, 0, 0))
    counts, miss, eta, p = _panel(43)
    I, L, K = counts.shape[0], counts.shape[1], eta.shape[1]
    Kp = k_padded_size(K, 32)
    assert jk.pick_layout_biallelic_any(I, Kp, L)[3] == mode
    jmd = JaxModelData(x=jnp.asarray(counts, jnp.int8),
                       miss=jnp.asarray(miss, jnp.float32),
                       mask=jnp.ones((L, 2), bool),
                       n_alleles=jnp.full((L,), 2, jnp.int32)
                       ).prepare_for_em(bi=True)
    jcfg = JaxEMConfig(admixture=True, has_missing=True, k_true=K,
                       use_pallas="interpret", biallelic=True)
    jpar = _to_bi_repr(pad_params_k(JaxParams(
        eta=jnp.asarray(eta, jnp.float32), p=jnp.asarray(p, jnp.float32)),
        Kp), jcfg, I, L)
    assert jpar.p.ndim == 2 and jpar.p.shape[1] >= L
    tmd = model_data_from_numpy(counts, miss, np.ones((L, 2), bool),
                                np.full(L, 2), dtype=torch.float32)
    tpar, tcfg = _torch_bi(eta, p, K, torch.float32)
    for _ in range(2):
        jpar, _, _ = jadm.em_step(jpar, jmd, jcfg)
        tpar, _, _ = tadm.em_step(tpar, tmd, tcfg, route=ROUTES[mode])
    # the JAX layout pads loci to its tile; the port pads none
    np.testing.assert_allclose(tpar.p[0].numpy(),
                               p0_from_padded(jpar.p, L), rtol=1e-4,
                               atol=5e-5)
    np.testing.assert_allclose(tpar.eta[0].numpy(), np.asarray(jpar.eta),
                               rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_warm_start_fit_under_each_route_matches_jax(monkeypatch, route):
    """A warm-start estimate_model on the p0 layout under each route (the
    router patched, as the JAX tests patch the layout chooser) reaches the
    JAX fit's logL in the same number of iterations."""
    _, _, eta, p = _panel(45, I=60, L=300, K=3)
    # a panel with clear structure, so that the fit converges in tens of
    # iterations and not in thousands
    rng = np.random.default_rng(46)
    Q = rng.dirichlet(np.full(3, 0.3), size=60)
    P0 = rng.choice([0.1, 0.5, 0.9], size=(3, 300))
    miss = rng.binomial(2, 0.05, size=(60, 300))
    x0 = rng.binomial(2 - miss, Q @ P0)
    counts = np.stack([x0, 2 - miss - x0], axis=2)
    ds = dataset_from_counts(counts, miss, 2)
    opt = JaxOptions(admixture=True, min_K=3, max_K=3, n_init=1, seed=7,
                     verbosity=0, write_files=False, dtype="float64",
                     abs_error=1e-2, check_interval=1
                     ).synchronize(ds.I, 2)

    def n_par(K):
        return ds.n_parameters(K, True, False)

    je = jax_estimate(jax.random.PRNGKey(0),
                      jax_model_data(ds, dtype=jnp.float64), opt, n_par,
                      warm=JaxParams(eta=jnp.asarray(eta), p=jnp.asarray(p)))
    fixed = ROUTES[route]._replace(window=min(ROUTES[route].window, 300))
    picked = []
    monkeypatch.setattr(tadm, "pick_route",
                        lambda *a: picked.append(a) or fixed)
    topt = options_from(opt)
    topt.use_pallas = True           # the p0 layout, plain versions on CPU
    tmd = model_data_from_dataset(ds, dtype=torch.float64)
    assert tms.cfg_from_options(topt, 3, tmd).bi_repr_active
    te = estimate_model(0, tmd, topt, n_par, warm=params_from_numpy(eta, p))
    jr, tr = je.per_K[3], te.per_K[3]
    assert picked and tr.route.startswith(route)
    assert tr.n_total_iter == jr.n_total_iter > 20 and tr.ever_converged
    np.testing.assert_allclose(tr.max_logL, jr.max_logL, rtol=1e-10)
    np.testing.assert_allclose(tr.best_params.eta.numpy(),
                               np.asarray(jr.best_params.eta), atol=1e-6)


# ---------------------------------------------------------------------------
# bounded memory around the step

def _md(seed, I=40, L=300, missing_rate=0.1, dtype=torch.float64):
    counts, miss, eta, p = _panel(seed, I=I, L=L, K=3, miss_rate=missing_rate)
    md = model_data_from_numpy(counts, miss, np.ones((L, 2), bool),
                               np.full(L, 2), dtype=dtype)
    return md, eta, p


def test_windowed_log_likelihood_bi_repr_matches_unwindowed():
    md, eta, p = _md(51)
    one, _ = _torch_bi(eta, p, 3, torch.float64)
    # a batch of two different chains
    params = Params(torch.cat([one.eta, one.eta.flip(1)]),
                    torch.cat([one.p, one.p.flip(2)]))
    e, p0 = params.eta, params.p
    d0 = e @ p0
    d1 = e.sum(dim=-1, keepdim=True) - d0
    want = (md.x0 * torch.log(d0) + md.x1 * torch.log(d1)).sum(dim=-1)
    whole = tadm.log_likelihood_bi_repr(params, md)
    budget = 6 * 2 * md.I * 8 * 37           # 37 columns a window
    assert column_window(md.L, 6 * 2 * md.I * 8, budget) == 37
    windowed = tadm.log_likelihood_bi_repr(params, md, budget=budget)
    for got in (whole, windowed):
        np.testing.assert_allclose(got[0].numpy(), want.sum(dim=-1).numpy(),
                                   rtol=1e-12)
        np.testing.assert_allclose(got[1].numpy(),
                                   want.pow(2).sum(dim=-1).sqrt().numpy(),
                                   rtol=1e-10)
    # and the rows pass's own terms (what float32 chains on CUDA read)
    t = fb.rows_log_likelihood_terms(e, p0, md.x0, md.x1)
    np.testing.assert_allclose(t.numpy(), want.numpy(), rtol=1e-10)


@pytest.mark.parametrize("constrained", [False, True])
def test_windowed_posterior_allele_mass_matches_unwindowed(constrained):
    md, eta, p = _md(53)
    params = params_from_numpy(eta[0] if constrained else eta, p)
    whole = tadm.posterior_allele_mass(params, md, constrained)
    budget = 4 * md.I * 2 * 8 * 41           # 41 loci a window
    windowed = tadm.posterior_allele_mass(params, md, constrained,
                                          budget=budget)
    np.testing.assert_allclose(windowed.numpy(), whole.numpy(), rtol=1e-10,
                               atol=1e-10)
    # every observed copy is sourced from some cluster
    np.testing.assert_allclose(
        whole.sum(dim=1).numpy(),
        (md.x.sum(dim=(1, 2)) + md.c).numpy(), rtol=1e-10)
    assert np.array_equal(
        tms.hard_partition(params, md, True, constrained),
        torch.argmax(whole, dim=1).numpy())


@pytest.mark.parametrize("method", [InitMethod.RANDOM_CENTERS,
                                    InitMethod.RANDOM_PARTITION])
def test_windowed_init_counts_are_exact(method):
    """The windowed start counts, window by window, what the unwindowed
    path counts for the same labels; its draws are valid starts."""
    md, _, _ = _md(55, I=30, L=200)
    K = 3
    codes = rinit.codes_from_counts(md.x, md.miss, 2)
    assert codes.dtype == torch.int8 and codes.shape == (30, 200, 2)
    labels = rinit.random_allele_partition(
        torch.Generator().manual_seed(1), md, codes, K)
    copies, pc = rinit.allele_partition_counts(labels, codes, md.M, K,
                                               md.dtype)
    parts = [rinit.allele_partition_counts(labels[:, lo:lo + 64],
                                           codes[:, lo:lo + 64], md.M, K,
                                           md.dtype)
             for lo in range(0, 200, 64)]
    assert torch.equal(sum(c for c, _ in parts), copies)
    assert torch.equal(torch.cat([q for _, q in parts], dim=1), pc)
    assert float(copies.sum()) == float((codes >= 0).sum())
    whole = rinit.parameters_from_allele_partition(labels, codes, md, K)
    again = rinit.parameters_from_allele_counts(copies, pc, md, 200 * 2)
    assert torch.equal(whole.eta, again.eta) and torch.equal(whole.p, again.p)

    # a budget that forces several windows; under the default one the
    # start is today's, draw for draw
    budget = rinit.INIT_BYTES_PER_COPY * md.I * 2 * 48
    assert rinit.init_window(md, 2, budget) == 48
    assert rinit.init_window(md, 2) == md.L
    start = rinit.random_initialize(torch.Generator().manual_seed(2), md, K,
                                    method, budget=budget)
    assert start.eta.shape == (30, K) and start.p.shape == (K, 200, 2)
    # add-one smoothing over every copy, observed or not: a row of eta
    # sums to (K + observed copies) / (K + L P)
    observed = (codes >= 0).sum(dim=(1, 2)).double()
    torch.testing.assert_close(start.eta.sum(dim=1),
                               (K + observed) / (K + 200 * 2))
    torch.testing.assert_close(start.p.sum(dim=2),
                               torch.ones(K, 200).double())
    assert float(start.p.min()) > 0 and float(start.eta.min()) > 0
    a = rinit.random_initialize(torch.Generator().manual_seed(3), md, K,
                                method)
    lab = rinit._allele_labels(torch.Generator().manual_seed(3), md, codes,
                               K, method)
    b = rinit.parameters_from_allele_partition(lab, codes, md, K)
    assert torch.equal(a.eta, b.eta) and torch.equal(a.p, b.p)


@pytest.mark.parametrize("method", [InitMethod.RANDOM_CENTERS,
                                    InitMethod.RANDOM_PARTITION])
def test_init_counts_on_the_cpu_take_the_plain_path(method):
    """On CPU tensors ``allele_partition_counts`` is the plain version: it
    launches no kernel and counts its bincount's host reads; a raw draw
    (missing copies keep their label) counts as the masked labels do, at
    the column slice of a window."""
    from multiclust_tpu_torch.ops import build

    md, _, _ = _md(59, I=30, L=200)
    K = 3
    codes = rinit.codes_from_counts(md.x, md.miss, 2)
    assert bool((codes < 0).any())
    gen = lambda: torch.Generator().manual_seed(4)
    masked = rinit.random_allele_partition(gen(), md, codes, K)
    raw = rinit._allele_labels(gen(), md, codes, K,
                               InitMethod.RANDOM_PARTITION)
    assert torch.equal(torch.where(codes >= 0, raw, -1), masked)
    assert bool((raw[codes < 0] >= 0).all())
    before = dict(build.LAUNCHES)
    window = (slice(None), slice(40, 104))
    got = rinit.allele_partition_counts(raw[window], codes[window], md.M, K,
                                        md.dtype)
    assert build.LAUNCHES["host.syncs"] == before["host.syncs"] + \
        rinit.BINCOUNT_SYNCS
    assert build.kernel_launches() == {
        n: v for n, v in before.items() if n not in build.COUNTERS}
    want = rinit.allele_partition_counts_reference(
        masked[window], codes[window], md.M, K, md.dtype)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    # the start that counts the raw draw is the start of the masked labels
    start = rinit.random_initialize(gen(), md, K, method)
    lab = (rinit.random_allele_partition(gen(), md, codes, K)
           if method == InitMethod.RANDOM_PARTITION
           else rinit.random_allele_center(gen(), md, codes, K))
    again = rinit.parameters_from_allele_partition(lab, codes, md, K)
    assert torch.equal(start.eta, again.eta) and torch.equal(start.p, again.p)


def test_model_data_from_planes_is_the_uploaded_panel():
    counts, miss, _, _ = _panel(57, I=20, L=50)
    want = make_model_data(counts, miss, np.ones((50, 2), bool),
                           np.full(50, 2), dtype=torch.float32, device="cpu",
                           storage_dtype=torch.int8)
    planes = torch.as_tensor(np.ascontiguousarray(
        np.moveaxis(counts, 2, 0))).to(torch.int8)
    got = model_data_from_planes(planes, torch.as_tensor(miss).to(torch.int8))
    assert got.x0.data_ptr() == planes.data_ptr()      # no copy
    for f in ("x", "miss", "mask", "n_alleles", "c", "x0", "x1"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    assert want.x0.dtype == torch.int8 and want.x0.is_contiguous()
    with pytest.raises(ValueError):
        model_data_from_planes(planes[:, :, :10],
                               torch.as_tensor(miss).to(torch.int8))


def test_chain_batch_and_bytes():
    md, _, _ = _md(59, dtype=torch.float32)
    opt = options_from(JaxOptions(admixture=True, n_init=20,
                                  use_pallas=True)).synchronize(md.I, 2)
    cfg = tms.cfg_from_options(opt, 3, md)
    assert cfg.bi_repr_active and cfg.scratch_budget == fb.SCRATCH_CAP
    assert tms.chain_batch(opt, md, 3, cfg) == tms.MAX_AUTO_CHAINS
    opt.batch_chains = 3
    assert tms.chain_batch(opt, md, 3, cfg) == 3
    one = tms.chain_bytes(md, 3, cfg)
    params = 4 * (md.I * 32 + 32 * md.L)
    assert one >= 9 * params
    sq = cfg._replace(accel_scheme=1, q=2)
    assert tms.chain_bytes(md, 3, sq) == one + 4 * params


# ---------------------------------------------------------------------------
# the router

SHAPES = [(16384, 2048), (65536, 16384), (8192, 131072), (2048, 524288)]


@pytest.mark.parametrize("I,L", SHAPES)
@pytest.mark.parametrize("B", [1, 2, 8])
@pytest.mark.parametrize("Kp", [32, 128])
def test_router_keeps_its_budget(I, L, B, Kp):
    budget = fb.SCRATCH_CAP
    r = fb.pick_route(B, I, L, Kp, 132, budget)
    assert r.name in ("pair", "streamed", "chunked")
    # the budget bounds what a window can bound, the columns pass's
    # partials; the rows pass's are small or as large as eta
    assert 0 < fb.cols_partials_bytes(B, I, r.window, Kp, 132) <= budget
    assert r.scratch_bytes >= fb.cols_partials_bytes(B, I, r.window, Kp, 132)
    assert r.window == L or r.name == "chunked"
    assert r.window % 32 == 0 or r.window == L
    if r.name == "pair":
        assert r.seg_cols == 0
        assert B * -(-I // fb.rows_block(0, Kp)) >= \
            fb.PAIR_BLOCKS_PER_SM * 132
    else:
        assert r.seg_cols % 32 == 0 and r.seg_cols >= fb.MIN_SEG_COLS
        n_cseg = -(-r.window // r.seg_cols)
        assert n_cseg <= fb.GRID_YZ_MAX
        # the scratch the route reports is what its window allocates
        assert r.scratch_bytes == fb.window_scratch_bytes(
            B, I, r.window, Kp, 132, n_cseg)
        assert r.scratch_bytes <= budget + 4 * B * I * (Kp + 1) * n_cseg
    assert r.name in r.describe()


def test_router_cases():
    cap = fb.SCRATCH_CAP
    # the rows pass gains from column segments up to ~20 blocks an SM, so
    # the pair is left to grids that hold as many from their rows alone
    # and to windows too narrow to split
    assert fb.pick_route(2, 16384, 2048, 32, 132, cap).name == "streamed"
    assert fb.pick_route(2, 65536, 16384, 32, 132, cap).name == "streamed"
    assert fb.pick_route(8, 65536, 16384, 32, 132, cap, 20).name == "pair"
    assert fb.pick_route(1, 600, 500, 32, 132, cap, 3).name == "pair"
    # 32 chains in lockstep fill the card from 16384 rows alone, 16 do not
    assert fb.pick_route(32, 16384, 2048, 32, 132, cap, 20).name == "pair"
    assert fb.pick_route(16, 16384, 2048, 32, 132, cap, 20).name == "streamed"
    wide = fb.pick_route(2, 8192, 131072, 32, 132, cap)
    assert wide.name == "streamed" and wide.window == 131072
    assert -(-131072 // wide.seg_cols) >= 8
    narrow = fb.pick_route(2, 2048, 524288, 32, 132, cap)
    assert narrow.name == "chunked" and narrow.window == 262144
    assert fb.pick_route(1, 2048, 524288, 32, 132, cap).name == "streamed"
    # fewer SMs to fill, fewer segments
    small = fb.pick_route(2, 8192, 131072, 32, 16, cap)
    assert small.name == "streamed"
    assert small.seg_cols > 4 * wide.seg_cols
    # eight chains' partials outgrow the cap where two chains' do not
    assert fb.pick_route(8, 8192, 131072, 32, 132, cap).name == "chunked"
    # a smaller budget, more windows; none that fits, an error with counts
    tight = fb.pick_route(2, 8192, 131072, 32, 132, 16 << 20)
    assert tight.name == "chunked" and tight.window == 32768
    assert fb.cols_partials_bytes(2, 8192, 32768, 32, 132, 0,
                                  16 << 20) <= 16 << 20
    assert tight.n_rseg == 1
    with pytest.raises(MemoryError, match="bytes"):
        fb.pick_route(2, 8192, 131072, 32, 132, 1 << 16)
    with pytest.raises(ValueError, match="Kp=1056"):
        fb.pick_route(1, 100, 100, 1056, 132, cap)
    with pytest.raises(ValueError, match="index range"):
        fb.pick_route(1, 100, 2 ** 31 - 1, 32, 132, cap)
    assert fb.scratch_budget("cpu") == cap and fb.device_sm_count("cpu") == 132


def test_bi_route_reads_the_config_budget():
    md, _, _ = _md(61, I=64, L=4096, dtype=torch.float32)
    cfg = EMConfig(admixture=True, use_pallas="on", biallelic=True, k_true=3)
    free = tadm.bi_route(1, md, cfg, 32)
    assert free.name == "streamed" and free.window == 4096
    tight = tadm.bi_route(1, md, cfg._replace(scratch_budget=400_000), 32)
    assert tight.name == "chunked" and tight.window < 4096
    assert fb.cols_partials_bytes(1, 64, tight.window, 32, 132) <= 400_000


# ---------------------------------------------------------------------------
# segment arithmetic at the kernels' lane tiles

@pytest.mark.parametrize("I,L", SHAPES)
@pytest.mark.parametrize("B", [1, 2, 8])
@pytest.mark.parametrize("K,Kp", [(20, 32), (100, 128)])
def test_segments_cover_the_panel(I, L, B, K, Kp):
    """Row segments of the columns pass cover I exactly in multiples of
    its eta tile, column segments of the rows pass cover W in multiples of
    its tile, both within the grid's limit; the route's scratch keeps the
    budget."""
    budget = fb.SCRATCH_CAP
    r = fb.pick_route(B, I, L, Kp, 132, budget, K)
    tc, ri = fb.cols_tile(K, Kp)
    assert tc % 32 == 0 and ri % 4 == 0
    n_rseg, seg_rows = fb.cols_row_segments(B, I, r.window, Kp, 132, K,
                                            budget)
    assert n_rseg == r.n_rseg and 1 <= n_rseg <= fb.GRID_YZ_MAX
    assert seg_rows % ri == 0
    assert (n_rseg - 1) * seg_rows < I <= n_rseg * seg_rows
    assert fb.cols_partials_bytes(B, I, r.window, Kp, 132, K, budget) == \
        8 * B * n_rseg * Kp * r.window <= budget
    # the partials stay below the bytes of x the pass reads
    assert 8 * B * n_rseg * K * r.window <= 3 * B * I * r.window
    n_cseg, seg_cols = fb.row_segments(B, I, r.window, 132, k_true=K, Kp=Kp)
    assert seg_cols % fb.ROW_TL == 0 and 1 <= n_cseg <= fb.GRID_YZ_MAX
    assert (n_cseg - 1) * seg_cols < r.window <= n_cseg * seg_cols
    if r.name == "pair":
        assert n_cseg == 1 and r.seg_cols == 0
        assert B * -(-I // fb.rows_block(K, Kp)) >= \
            fb.PAIR_BLOCKS_PER_SM * 132
    else:
        assert r.seg_cols == seg_cols
        assert seg_cols >= fb.MIN_SEG_COLS or n_cseg == 1
    assert r.scratch_bytes == fb.window_scratch_bytes(
        B, I, r.window, Kp, 132, 0 if r.name == "pair" else n_cseg, K,
        budget)
    assert str(r.n_rseg) in r.describe()


def test_row_segments_give_way_to_the_budget():
    """A budget below what the card-filling row segments would take cuts
    the segments before it cuts the window."""
    B, I, W, Kp, K = 2, 16384, 2048, 32, 20
    free, _ = fb.cols_row_segments(B, I, W, Kp, 132, K)
    one = 8 * B * Kp * W
    assert free > 4
    tight, seg_rows = fb.cols_row_segments(B, I, W, Kp, 132, K, 4 * one)
    assert tight <= 4 and seg_rows * tight >= I
    assert fb.cols_row_segments(B, I, W, Kp, 132, K, one // 2)[0] == 1
    r = fb.pick_route(B, I, W, Kp, 132, 4 * one, K)
    assert r.window == W and r.n_rseg == tight


@pytest.mark.parametrize("name", ["pair", "streamed", "chunked"])
def test_every_route_hands_its_row_segments_to_the_columns_pass(monkeypatch,
                                                                name):
    """The columns pass's row segments have one source in a routed step,
    the route, whichever of the three it is."""
    seen = []
    real = fb.cols_window

    def spy(*args, n_rseg=0, **kw):
        seen.append(n_rseg)
        return real(*args, n_rseg=n_rseg, **kw)

    def cols(eta, p0, x0, x1, miss=None, *, plb, project, k_true=0,
             n_rseg=0):
        # the CPU wrapper returns its plain version before the window call
        out = torch.empty_like(p0)
        fb.cols_window(eta, p0, x0, x1, miss, (out,), l_lo=0,
                       l_hi=p0.shape[-1], plb=plb, project=project,
                       k_true=k_true, n_rseg=n_rseg)
        return out

    monkeypatch.setattr(fb, "cols_window", spy)
    monkeypatch.setattr(fb, "fullstep_bi_cols", cols)
    args = _torch_args(*_inputs(71, 24, 96), True)
    window = 40 if name == "chunked" else 96
    route = fb.Route(name, 0 if name == "pair" else 32, window, 0, 5)
    got = fb.admixture_fullstep_biallelic_routed(*args, route=route, **KW)
    assert seen == [5] * -(-96 // window)
    ref = fb.admixture_fullstep_biallelic_reference(*args, **KW)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g.to(r.dtype), r, rtol=1e-5, atol=1e-6)
