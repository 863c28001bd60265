"""The admixture step at 128 < Kp <= 1024 (the wide kernels of
csrc/wide.cuh) and above 1024 (the plain step with a notice) on the CPU.

On the CPU the port's wrappers run their plain PyTorch versions (the wide
kernels are held to those on the card, tests/test_torch_cuda.py); what
runs here is the port's routing, padding and chaining at those Kp: the
biallelic step on its streamed and chunked routes, the generic M = 4 step
and the bucketed step, each in float64 against the JAX package's XLA step
(which is what its Pallas step computes), the biallelic step in float32
against the JAX package's Pallas kernels in interpret mode, a warm-start
fit at K = 200, the router, the Kp = 1056 route against the JAX package's
XLA fallback, and a meshed step over gloo.  Inputs are made with numpy
from a seed and handed to both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiclust_tpu.config import Options as JaxOptions
from multiclust_tpu.io.dataset import from_counts
from multiclust_tpu.model import admixture as jadm
from multiclust_tpu.model import bucketed as jbk
from multiclust_tpu.model.common import EMConfig as JaxEMConfig, \
    ModelData as JaxModelData, Params as JaxParams, \
    model_data_from_dataset as jax_model_data, pad_params_k as jax_pad_k
from multiclust_tpu.ops import df64
from multiclust_tpu.ops import kernels as jk
from multiclust_tpu.runtime.ksweep import estimate_model as jax_estimate
from multiclust_tpu.runtime.multistart import _to_bi_repr as jax_to_bi_repr
from multiclust_tpu_torch.convert import dataset_from_counts, \
    model_data_from_numpy, options_from, p0_from_padded, params_from_numpy
from multiclust_tpu_torch.model import admixture as tadm
from multiclust_tpu_torch.model import bucketed as tbk
from multiclust_tpu_torch.model.common import EMConfig, Params, \
    k_padded_size, make_model_data, model_data_from_dataset
from multiclust_tpu_torch.ops import fullstep as fs, fullstep_bi as fb
from multiclust_tpu_torch.runtime import multistart as tms
from multiclust_tpu_torch.runtime.ksweep import estimate_model

torch.set_num_threads(2)

F64 = dict(rtol=1e-10, atol=1e-10)
# float32 against the interpret-mode kernels (tests/test_torch_biobank.py)
INTERPRET_P = dict(rtol=1e-4, atol=5e-5)
INTERPRET_ETA = dict(rtol=1e-4, atol=2e-5)
WIDE_K = (130, 200)


def _bi_panel(seed, I, L, K, miss_rate=0.01):
    """A biallelic panel with structure and the warm parameters the steps
    start from: counts [I, L, 2], miss, eta [I, K], p [K, L, 2]."""
    rng = np.random.default_rng(seed)
    Q = rng.dirichlet(np.full(K, 0.3), size=I)
    P0 = rng.uniform(0.05, 0.95, size=(K, L))
    miss = rng.binomial(2, miss_rate, size=(I, L))
    x0 = rng.binomial(2 - miss, Q @ P0)
    counts = np.stack([x0, 2 - miss - x0], axis=2)
    eta = rng.dirichlet(np.full(K, 2.0), size=I)
    p0 = rng.uniform(0.2, 0.8, size=(K, L))
    return counts, miss, eta, np.stack([p0, 1 - p0], axis=2)


def _generic_panel(seed, I, L, M, K, miss_rate=0.01, jagged=False):
    """A multi-allelic panel (every locus M alleles, or 80 % of the loci
    2 and the rest M when ``jagged``) and warm parameters."""
    rng = np.random.default_rng(seed)
    Ml = (np.where(rng.random(L) < 0.8, 2, M) if jagged
          else np.full(L, M))
    mask = np.arange(M)[None] < Ml[:, None]
    Q = rng.dirichlet(np.full(K, 0.5), size=I)
    P = rng.gamma(1.0, size=(K, L, M)) * mask
    P /= P.sum(axis=2, keepdims=True)
    miss = rng.binomial(2, miss_rate, size=(I, L))
    prob = np.einsum("ik,klm->ilm", Q, P)
    counts = np.stack([rng.multinomial(2 - miss[i, l], prob[i, l])
                       for i in range(I) for l in range(L)]).reshape(I, L, M)
    eta = rng.dirichlet(np.full(K, 2.0), size=I)
    p = rng.gamma(1.0, size=(K, L, M)) * mask
    return counts, miss, mask, Ml, eta, p / p.sum(axis=2, keepdims=True)


def _jax_md(counts, miss, mask, Ml, dtype=jnp.float64):
    return JaxModelData(x=jnp.asarray(counts, dtype),
                        miss=jnp.asarray(miss, dtype),
                        mask=jnp.asarray(mask),
                        n_alleles=jnp.asarray(Ml, jnp.int32))


def _bi_port(eta, p, K, dtype):
    """Port params on the K-padded p0 layout of a biallelic fit."""
    cfg = EMConfig(admixture=True, has_missing=True, use_pallas="on",
                   biallelic=True, k_true=K)
    params = params_from_numpy(eta[None], p[None], dtype=dtype)
    return tms._to_bi_repr(tms._pad_k(params, cfg), cfg), cfg


def _jax_steps(jpar, jmd, jcfg, n):
    step = jax.jit(jadm.em_step, static_argnums=2)
    out = []
    for _ in range(n):
        jpar, jll, _ = step(jpar, jmd, jcfg)
        out.append((np.asarray(jpar.eta), np.asarray(jpar.p),
                    float(df64.df_value(jll))))
    return out


@pytest.mark.parametrize("route", ["routed", "chunked"])
@pytest.mark.parametrize("K", WIDE_K)
def test_bi_step_matches_jax_f64(K, route):
    """Three float64 steps of the port's biallelic step at Kp = 160 and
    224 (the router's streamed route, never the pair; and a chunked route
    over windows that do not divide L) against the JAX package's step:
    1e-10 a step, the logL of each step too."""
    counts, miss, eta, p = _bi_panel(61, 96, 300, K)
    L = counts.shape[1]
    mask, n_all = np.ones((L, 2), bool), np.full(L, 2)
    want = _jax_steps(JaxParams(eta=jnp.asarray(eta), p=jnp.asarray(p)),
                      _jax_md(counts, miss, mask, n_all),
                      JaxEMConfig(admixture=True, has_missing=True), 3)
    tmd = model_data_from_numpy(counts, miss, mask, n_all)
    tpar, tcfg = _bi_port(eta, p, K, torch.float64)
    Kp = tpar.eta.shape[-1]
    assert Kp == k_padded_size(K, 32) and fb.is_wide(Kp)
    fixed = (None if route == "routed"
             else fb.Route("chunked", 64, 128, 0))
    picked = tadm.bi_route(1, tmd, tcfg, Kp)
    assert picked.name != "pair"
    for e_w, p_w, ll_w in want:
        tpar, tll, _ = tadm.em_step(tpar, tmd, tcfg, route=fixed)
        got = tms._unpad_k(Params(tpar.eta[0], tpar.p[0]), tcfg)
        np.testing.assert_allclose(got.eta.numpy(), e_w, **F64)
        np.testing.assert_allclose(got.p.numpy(), p_w, **F64)
        np.testing.assert_allclose(float(tll[0]), ll_w, rtol=1e-12)
        assert (tpar.eta[0, :, K:] == 0).all() and (tpar.p[0, K:] == 0).all()


def test_bi_step_matches_jax_kernels_in_interpret_mode():
    """The float32 step of the port at K = 130 on its own route against
    the JAX em_step on the p0 layout with its own layout chooser at Kp =
    160, Pallas in interpret mode: the JAX package's kernels at this Kp."""
    K, I, L = 130, 64, 256
    counts, miss, eta, p = _bi_panel(63, I, L, K)
    Kp = k_padded_size(K, 32)
    assert jk.pick_layout_biallelic_any(I, Kp, L)[3]
    jmd = JaxModelData(x=jnp.asarray(counts, jnp.int8),
                       miss=jnp.asarray(miss, jnp.float32),
                       mask=jnp.ones((L, 2), bool),
                       n_alleles=jnp.full((L,), 2, jnp.int32)
                       ).prepare_for_em(bi=True)
    jcfg = JaxEMConfig(admixture=True, has_missing=True, k_true=K,
                       use_pallas="interpret", biallelic=True)
    jpar = jax_to_bi_repr(jax_pad_k(JaxParams(
        eta=jnp.asarray(eta, jnp.float32), p=jnp.asarray(p, jnp.float32)),
        Kp), jcfg, I, L)
    assert jpar.p.ndim == 2
    tmd = model_data_from_numpy(counts, miss, np.ones((L, 2), bool),
                                np.full(L, 2), dtype=torch.float32)
    tpar, tcfg = _bi_port(eta, p, K, torch.float32)
    assert tadm.bi_route(1, tmd, tcfg, Kp).name == "streamed"
    for _ in range(2):
        jpar, jll, _ = jadm.em_step(jpar, jmd, jcfg)
        tpar, tll, _ = tadm.em_step(tpar, tmd, tcfg)
    np.testing.assert_allclose(tpar.p[0].numpy(), p0_from_padded(jpar.p, L),
                               **INTERPRET_P)
    np.testing.assert_allclose(tpar.eta[0].numpy(), np.asarray(jpar.eta),
                               **INTERPRET_ETA)
    ll = float(df64.df_value(jll))
    assert abs(float(tll[0]) - ll) < 1e-5 * abs(ll)


@pytest.mark.parametrize("K", WIDE_K)
def test_generic_step_matches_jax_f64(K):
    """Three float64 steps of the port's generic kernel route
    (``_em_step_generic``: the rows pass and its finish, the columns pass
    and the p epilogue, K-padded to Kp = 160 / 224) on an M = 4 panel
    against the JAX package's step: 1e-10."""
    counts, miss, mask, Ml, eta, p = _generic_panel(65, 48, 40, 4, K)
    want = _jax_steps(JaxParams(eta=jnp.asarray(eta), p=jnp.asarray(p)),
                      _jax_md(counts, miss, mask, Ml),
                      JaxEMConfig(admixture=True, has_missing=True), 3)
    tmd = make_model_data(counts, miss, mask, Ml, dtype=torch.float64,
                          device="cpu")
    cfg = EMConfig(admixture=True, has_missing=True, use_pallas="on",
                   k_true=K)
    tpar = tms._pad_k(params_from_numpy(eta[None], p[None]), cfg)
    assert fb.is_wide(tpar.eta.shape[-1])
    for e_w, p_w, ll_w in want:
        tpar, tll, _ = tadm._em_step_generic(tpar, tmd, cfg)
        np.testing.assert_allclose(tpar.eta[0, :, :K].numpy(), e_w, **F64)
        np.testing.assert_allclose(tpar.p[0, :K].numpy(), p_w, **F64)
        np.testing.assert_allclose(float(tll[0]), ll_w, rtol=1e-12)
        assert (tpar.eta[0, :, K:] == 0).all() and (tpar.p[0, K:] == 0).all()


@pytest.mark.parametrize("K", WIDE_K)
def test_bucketed_step_matches_jax_f64(K):
    """Two float64 steps of the port's bucketed kernel chain
    (``_bucketed_fullstep_chain``: the rows passes chained through a0, a
    bucket's columns pass and p epilogue at its own M) on a jagged panel
    (80 % M = 2, 20 % M = 8 loci) against the JAX package's bucketed step
    (XLA): 1e-10."""
    counts, miss, mask, Ml, eta, p = _generic_panel(67, 40, 100, 8, K,
                                                    jagged=True)
    jmd = _jax_md(counts, miss, mask, Ml)
    jplan = jbk.plan_buckets(Ml, 8, min_bucket=4, tight=True)
    jbd = jax.jit(lambda m: jbk.bucketize_model_data(m, jplan))(jmd)
    jcfg = JaxEMConfig(admixture=True, has_missing=True)
    step = jax.jit(lambda q: jadm._em_step_bucketed(q, jbd, jcfg))
    md = make_model_data(counts, miss, mask, Ml, dtype=torch.float64,
                         device="cpu")
    bd = tbk.bucketize_model_data(md, tbk.plan_buckets(Ml, 8, min_bucket=4))
    assert len(bd.buckets) > 1
    cfg = EMConfig(admixture=True, has_missing=True, use_pallas="on",
                   k_true=K)
    tpar = tbk.split_params_like(
        tms._pad_k(params_from_numpy(eta[None], p[None]), cfg), bd)
    jpar = JaxParams(jnp.asarray(eta), jnp.asarray(p))
    for _ in range(2):
        jpar, jll, _ = step(jpar)
        tpar, tll, _ = tadm._bucketed_fullstep_chain(tpar, bd, cfg)
        got = tbk.merge_params_like(tpar, bd).p[0]
        want = np.asarray(jbk.merge_params_like(jpar, jbd, 8).p)
        np.testing.assert_allclose(got[:K].numpy(), want, **F64)
        np.testing.assert_allclose(tpar.eta[0, :, :K].numpy(),
                                   np.asarray(jpar.eta), **F64)
        np.testing.assert_allclose(float(tll[0]),
                                   float(df64.df_value(jll)), rtol=1e-12)
        assert (got[K:] == 0).all() and (tpar.eta[0, :, K:] == 0).all()
        jpar = jbk.split_params_like(jbk.merge_params_like(jpar, jbd, 8),
                                     jbd)


def test_warm_start_fit_k200_matches_jax():
    """A warm-start fit at K = 200 (Kp = 224) on the p0 layout, through
    the router's wide route (plain versions on the CPU), reaches the JAX
    fit's logL in the same iterations: both stop at the cap of 15.  The
    panel has more individuals than clusters, as the options demand."""
    K = 200
    counts, miss, eta, p = _bi_panel(69, 208, 150, K)
    ds = dataset_from_counts(counts, miss, 2)
    opt = JaxOptions(admixture=True, min_K=K, max_K=K, n_init=1, seed=7,
                     verbosity=0, write_files=False, dtype="float64",
                     abs_error=1e-12, max_iter=15, check_interval=1
                     ).synchronize(ds.I, 2)

    def n_par(k):
        return ds.n_parameters(k, True, False)

    je = jax_estimate(jax.random.PRNGKey(0),
                      jax_model_data(ds, dtype=jnp.float64), opt, n_par,
                      warm=JaxParams(eta=jnp.asarray(eta), p=jnp.asarray(p)))
    topt = options_from(opt)
    topt.use_pallas = True           # the p0 layout, plain versions on CPU
    tmd = model_data_from_dataset(ds, dtype=torch.float64)
    assert tms.cfg_from_options(topt, K, tmd).bi_repr_active
    te = estimate_model(0, tmd, topt, n_par, warm=params_from_numpy(eta, p))
    jr, tr = je.per_K[K], te.per_K[K]
    assert tr.route.startswith("streamed")
    # neither converges at 1e-12 before the cap: both ran 15 iterations
    assert not tr.ever_converged and not jr.ever_converged
    assert tr.n_launched == jr.n_launched == 1
    assert tr.n_iter_all >= 15
    np.testing.assert_allclose(tr.max_logL, jr.max_logL, rtol=1e-10)
    np.testing.assert_allclose(tr.best_params.eta.numpy(),
                               np.asarray(jr.best_params.eta), atol=1e-8)


# ---------------------------------------------------------------------------
# the router

@pytest.mark.parametrize("Kp", [160, 224, 512, 1024])
def test_pick_route_wide(Kp):
    """At every wide Kp the router picks the streamed or the chunked step,
    never the pair: its columns partials within the budget, its rows
    partials within SCRATCH_CAP or one segment; the tiles of the wide
    kernels."""
    cap = fb.SCRATCH_CAP
    K = Kp - 24
    for B, I, L, budgets in ((1, 16384, 2048, (cap, 32 << 20)),
                             (2, 16384, 2048, (cap, 32 << 20)),
                             (32, 16384, 2048, (cap,)),
                             (2, 8192, 131072, (cap, 32 << 20)),
                             (1, 1001, 4099, (cap, 32 << 20))):
        for budget in budgets:
            r = fb.pick_route(B, I, L, Kp, 132, budget, K)
            assert r.name in ("streamed", "chunked"), (B, I, L, r)
            n_cseg = -(-r.window // r.seg_cols)
            rows = 4 * B * n_cseg * I * (Kp + 1)
            assert rows <= max(cap, 4 * B * I * (Kp + 1))
            cols = fb.cols_partials_bytes(B, I, r.window, Kp, 132, K, budget)
            assert cols <= budget
            # the columns pass's d scratch, within SCRATCH_CAP on its own
            d = fb.cols_scratch_bytes(B, I, r.window,
                                      fb.wide_chunks(fb.kc_of(K, Kp)), 132)
            assert 0 < d <= cap
            assert r.scratch_bytes == cols + rows + d
    assert fb.rows_block(K, Kp) == fb.WR
    assert fb.cols_tile(K, Kp) == (fb.WTC, fb.WRI)
    assert fb.cols_tile(K, Kp, generic=True) == (fb.WTC_GENERIC,
                                                 fb.WRI_GENERIC)
    assert fb.kc_of(K, Kp) == K and fb.kc_of(0, Kp) == Kp
    assert fb.kc_of(K - 2, Kp) == K


# the columns pass's sub-windows (a d launch and a B launch each)

@pytest.mark.parametrize("B,I,W,l_lo,cap", [
    (2, 16384, 2048, 0, None),            # two sub-windows at the cap
    (2, 16384, 8192, 0, None),            # the generic lanes at M = 4
    (1, 16384, 2048, 0, None),            # one
    (2, 1001, 4099, 3, 4 * 2 * 1001 * 300),   # a window, a small cap
    (32, 16384, 2048, 0, None),           # not one d tile: ROW_TL columns
    (2, 8192, 131072, 64, None),          # biobank width
])
@pytest.mark.parametrize("bi", [True, False])
def test_cols_sub_windows_cover_the_window(B, I, W, l_lo, cap, bi,
                                          monkeypatch):
    """The sub-windows the wide columns pass runs cover [l_lo, l_lo + W)
    exactly and in order, each as wide as the plan's sub_cols but the
    last; the scratch they share (d [B, I, sub_cols], and the rows' eta
    sums with the biallelic cells) stays within the cap; sub_cols is a
    multiple of the d tile, of ROW_TL where not one d tile fits, or all of
    the window rounded up to 4 columns; no more sub-windows than the cap
    needs."""
    if cap is not None:
        monkeypatch.setattr(fb, "SCRATCH_CAP", cap)
    limit = fb.SCRATCH_CAP
    # one lane chunk: the wave rule leaves these plans to the cap
    sub = fb.cols_sub_cols(B, I, W, 1, 132, bi=bi)
    wins = fb.cols_sub_windows(l_lo, l_lo + W, sub)
    assert wins[0][0] == l_lo and wins[-1][1] == l_lo + W
    assert all(a[1] == b[0] for a, b in zip(wins, wins[1:]))
    assert all(hi - lo == sub for lo, hi in wins[:-1])
    assert 0 < wins[-1][1] - wins[-1][0] <= sub
    scratch = fb.cols_scratch_bytes(B, I, W, 1, 132, bi=bi)
    assert scratch == 4 * B * I * (sub + bi) <= limit
    if len(wins) == 1:
        assert sub == -(-W // 4) * 4
    else:
        step = fb.WD_TILE if sub >= fb.WD_TILE else fb.ROW_TL
        assert sub % step == 0
        # one sub-window fewer would not fit
        most = (limit - 4 * B * I * bi) // (4 * B * I) // step * step
        assert len(wins) == -(-W // most)


@pytest.mark.parametrize("B,I,W,Kp,bi", [
    (2, 16384, 8192, 1024, False),   # M = 4 lanes: 1408 -> 1024 lanes
    (2, 16384, 2048, 1024, True),    # 256 blocks, 97 % of two waves: kept
    (2, 16384, 8192, 224, False),    # 44 blocks: row segments fill a wave
    (2, 8192, 131072, 1024, True),   # biobank width
    (1, 65536, 16384, 512, False),
])
def test_cols_sub_windows_end_in_full_waves(B, I, W, Kp, bi):
    """With the card's SMs the sub-window plan keeps the B launch's grid
    (column tiles x chains x lane chunks) within one wave, or ends it in
    a wave filled to at least WAVE_FILL, or takes the narrowest
    sub-window; within the cap's plan either way."""
    n_sm, n_ch = 132, fb.wide_chunks(Kp)
    tc = fb.WTC if bi else fb.WTC_GENERIC
    sub = fb.cols_sub_cols(B, I, W, n_ch, n_sm, bi=bi)
    assert sub <= fb.cols_sub_cols(B, I, W, 1, 1 << 20, bi=bi)
    blocks = -(-sub // tc) * B * n_ch
    waves = -(-blocks // n_sm)
    assert (blocks <= n_sm or blocks >= fb.WAVE_FILL * waves * n_sm
            or sub == fb.WD_TILE)
    if (B, W, Kp, bi) == (2, 8192, 1024, False):
        assert sub == 1024 and blocks == 128


def test_cols_sub_cols_refuses_what_no_sub_window_fits(monkeypatch):
    monkeypatch.setattr(fb, "SCRATCH_CAP", 4 * 2 * 16384 * 16)
    with pytest.raises(MemoryError, match="over the cap"):
        fb.cols_sub_cols(2, 16384, 2048, 1, 132)
    monkeypatch.setattr(fb, "SCRATCH_CAP", 4 * 2 * 16384 * 33)
    assert fb.cols_sub_cols(2, 16384, 2048, 1, 132) == 32


@pytest.mark.parametrize("Kp", [32, 128, 160, 224, 1024])
def test_window_scratch_counts_the_wide_d_scratch(Kp):
    """``window_scratch_bytes``: the columns partials, the rows partials
    and, at a wide Kp only, the columns pass's d scratch."""
    B, I, W, K = 2, 16384, 2048, Kp - 20
    cols = fb.cols_partials_bytes(B, I, W, Kp, 132, K)
    rows = 4 * B * 3 * I * (Kp + 1)
    plan = (fb.wide_chunks(fb.kc_of(K, Kp)), 132)
    d = fb.cols_scratch_bytes(B, I, W, *plan) if Kp > 128 else 0
    assert fb.window_scratch_bytes(B, I, W, Kp, 132, 3, K) == cols + rows + d
    if Kp > 128:
        assert d == 4 * B * I * (fb.cols_sub_cols(B, I, W, *plan) + 1) > 0


@pytest.mark.parametrize("Kp", [160, 224, 512, 1024])
def test_pick_route_wide_takes_the_chunked_route_under_a_small_budget(Kp):
    """A budget the partials of all L exceed sends a wide Kp down the
    chunked loop, its window's partials within the budget, its scratch
    counted with the d scratch of that window."""
    B, I, L, K = 2, 16384, 2048, Kp - 20
    full = fb.cols_partials_bytes(B, I, L, Kp, 132, K, 1 << 40)
    budget = full // 3
    r = fb.pick_route(B, I, L, Kp, 132, budget, K)
    assert r.name == "chunked" and r.window < L
    assert fb.cols_partials_bytes(B, I, r.window, Kp, 132, K,
                                  budget) <= budget
    n_cseg = -(-r.window // r.seg_cols)
    assert r.scratch_bytes == fb.window_scratch_bytes(
        B, I, r.window, Kp, 132, n_cseg, K, budget)
    assert fb.pick_route(B, I, L, Kp, 132, fb.SCRATCH_CAP, K).name == \
        "streamed"


@pytest.mark.parametrize("K,Kp", [(130, 160), (200, 224), (500, 512),
                                  (1024, 1024)])
@pytest.mark.parametrize("B,I,W", [(1, 16384, 2048), (2, 16384, 2048),
                                   (2, 1001, 4099), (4, 300, 8192)])
def test_wide_cols_segments_follow_the_new_tiles(K, Kp, B, I, W):
    """The wide columns pass's row segments: whole stages covering I, a
    grid of at most one wave of B blocks (a sub-window's column tiles x
    chains x lane chunks x segments) wherever it splits I, at least 4
    stages a segment; the generic cells' the same at their block width
    and stage."""
    kc = fb.kc_of(K, Kp)
    assert fb.wide_chunks(kc) == -(-kc // fb.WIDE_CHUNK)
    for generic in (False, True):
        if generic:
            n, rows = fs.cols_segments(B, I, W, Kp, 132, K)
        else:
            n, rows = fb.cols_row_segments(B, I, W, Kp, 132, K)
        tc, ri = fb.cols_tile(K, Kp, generic)
        assert rows % ri == 0 and (n - 1) * rows < I <= n * rows
        sub = fb.cols_sub_cols(B, I, W, fb.wide_chunks(kc), 132,
                               bi=not generic)
        blocks = -(-sub // tc) * B * fb.wide_chunks(kc)
        if n > 1:
            assert n * blocks <= 132 and rows >= 4 * ri


def test_check_kp_takes_multiples_of_32_to_1024():
    """check_kp takes multiples of 32 up to 1024 and names the plain step
    above (tests/test_torch_cuda.py holds the pair's own refusal of a wide
    Kp on the card)."""
    for Kp in (160, 224, 1024):
        fb.check_kp(Kp)
    for Kp in (1056, 100, 0):
        with pytest.raises(ValueError, match=f"Kp={Kp}.*plain step"):
            fb.check_kp(Kp)


# ---------------------------------------------------------------------------
# above the kernels' range

def test_kp_1056_takes_the_plain_route_with_one_notice(capsys, monkeypatch):
    """K lanes beyond 1024: the port's float32 kernel step takes the plain
    formulation with a one-time notice on stderr, as the JAX package's
    Pallas step takes XLA (tests/test_kernels.py:837-860); the two agree
    as that test holds them, and a fit at K = 1056 keeps the full layout."""
    monkeypatch.setattr(tadm, "_K_BEYOND_NOTICED", set())
    rng = np.random.default_rng(71)
    K, I, L, Kp = 3, 8, 16, 1056
    counts, miss, eta, p = _bi_panel(71, I, L, K, miss_rate=0.0)
    eta_p = np.zeros((I, Kp), np.float32)
    eta_p[:, :K] = rng.dirichlet(np.ones(K), size=I)
    p_p = np.zeros((Kp, L, 2), np.float32)
    p_p[:K] = rng.dirichlet(np.ones(2), size=(K, L))
    ds = from_counts(counts, miss, 2)
    jmd = jax_model_data(ds, dtype=jnp.float32).prepare_for_em()
    jcfg = JaxEMConfig(admixture=True, use_pallas="interpret", k_true=K,
                       biallelic=True, has_missing=False)
    jpar = JaxParams(eta=jnp.asarray(eta_p), p=jnp.asarray(p_p))
    tmd = model_data_from_numpy(counts, miss, np.ones((L, 2), bool),
                                np.full(L, 2), dtype=torch.float32)
    cfg = EMConfig(admixture=True, use_pallas="on", k_true=K,
                   biallelic=True, has_missing=False)
    tpar = Params(torch.as_tensor(eta_p)[None], torch.as_tensor(p_p)[None])
    capsys.readouterr()
    for _ in range(2):
        jpar, jll, _ = jadm.em_step(jpar, jmd, jcfg)
        tpar, tll, _ = tadm.em_step(tpar, tmd, cfg)
        np.testing.assert_allclose(tpar.eta[0].numpy(), np.asarray(jpar.eta),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(tpar.p[0].numpy(), np.asarray(jpar.p),
                                   rtol=1e-6, atol=1e-7)
        assert abs(float(tll[0]) - float(df64.df_value(jll))) < 1e-3
    err = capsys.readouterr().err
    notice = "K lanes (1056) exceed the CUDA kernels' range (1024)"
    assert err.count(notice) == 1, err
    # a fit at K = 1056 runs on the full layout: no p0 layout, no route
    wide_cfg = EMConfig(admixture=True, use_pallas="on", k_true=1056,
                        biallelic=True)
    assert not wide_cfg.bi_repr_active
    assert EMConfig(admixture=True, use_pallas="on", k_true=1024,
                    biallelic=True).bi_repr_active


def test_kp_1056_bucketed_takes_the_plain_route(capsys, monkeypatch):
    """The bucketed float32 kernel step beyond 1024 lanes is the plain
    bucketed step, with the same notice once."""
    monkeypatch.setattr(tadm, "_K_BEYOND_NOTICED", set())
    K, Kp = 3, 1056
    counts, miss, mask, Ml, eta, p = _generic_panel(73, 12, 30, 6, K,
                                                    jagged=True)
    md = make_model_data(counts, miss, mask, Ml, dtype=torch.float32,
                         device="cpu")
    bd = tbk.bucketize_model_data(md, tbk.plan_buckets(Ml, 6, min_bucket=4))
    cfg = EMConfig(admixture=True, has_missing=True, use_pallas="on",
                   k_true=K)
    params = tbk.split_params_like(
        tms.pad_params_k(params_from_numpy(eta[None], p[None],
                                           dtype=torch.float32), Kp), bd)
    plain = tadm._em_step_bucketed(params, bd, EMConfig(
        admixture=True, has_missing=True, k_true=K))
    capsys.readouterr()
    for _ in range(2):
        got = tadm.em_step(params, bd, cfg)
    for a, b in zip((got[0].eta,) + tuple(got[0].p) + got[1:],
                    (plain[0].eta,) + tuple(plain[0].p) + plain[1:]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert capsys.readouterr().err.count("K lanes (1056)") == 1


# ---------------------------------------------------------------------------
# a meshed step

def test_mesh_2x1_step_k130(tmp_path):
    """The meshed biallelic step at K = 130 over two gloo ranks (rows
    split; float64 and the float32 kernel route, plain versions on the
    CPU) held to the port's unsharded step, and in float64 to the JAX
    package's meshed step."""
    from test_torch_mesh import _check_group, biallelic_panel, run_group, \
        warm_params

    counts, miss, mask, n_all = biallelic_panel(1, 48, 40, 0.1)
    eta, p = warm_params(75, 48, 40, mask, K=130)
    base = dict(kind="step", counts=counts, miss=miss, mask=mask,
                n_alleles=n_all, eta=eta, p=p, admixture=True)
    cases = [dict(base, name="bi_k130"),
             dict(base, name="bi_k130_f32", dtype="float32")]
    results = run_group(tmp_path, (2, 1), cases)
    _check_group(results, cases, (2, 1))


def test_kernel_report_names_the_wide_kernels():
    """``kernel_report.ptxas_lines`` names the wide passes by their cells
    (a Cells template argument, as nvcc mangles it) and the finish by its
    lanes a thread, and keeps the narrow generic rows pass's name."""
    from multiclust_tpu_torch.kernel_report import WIDE, ptxas_lines

    def entry(mangled, regs):
        return (f"ptxas info    : Function properties for {mangled}\n"
                f"    0 bytes stack frame, 0 bytes spill stores, 0 bytes "
                f"spill loads\nptxas info    : Used {regs} registers, used "
                f"1 barriers\n")

    ns = "_ZN44_GLOBAL__N__fb59ccda_11_fullstep_cu_df92ba42"
    report = (entry(ns + "18wide_cols_b_kernelILNS_5CellsE1EEEvPKfS3_S3_PKa"
                    "S5_S5_Pfiiiiiiiiiiiiii", 168)
              + entry(ns + "18wide_cols_d_kernelEPKfS2_PfS3_iiiiiiiii", 184)
              + entry(ns + "16wide_rows_kernelILNS_5CellsE0EEEvPKfS3_PKaS5_"
                      "PfS6_iiiiiiiiii", 122)
              + entry(ns + "18wide_finish_kernelILi32EEEvPKfS2_S2_S2_S2_S2_"
                      "PfPdiiiiifiii", 107)
              + entry(ns + "20fullstep_rows_kernelILi32ELNS_5CellsE1EEEvPKf",
                      80))
    assert [n for n, _ in ptxas_lines(report, WIDE)] == [
        "wide_cols_b_kernel<kDense>", "wide_cols_d_kernel",
        "wide_rows_kernel<kBi>", "wide_finish_kernel<32>"]
    assert [n for n, _ in ptxas_lines(report, "fullstep_rows")] == [
        "fullstep_rows_kernel<32>"]
