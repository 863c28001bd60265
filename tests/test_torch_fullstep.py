"""The port's generic (multi-allelic) full-step kernel functions against the
JAX package.

On the CPU the port's wrappers run their plain PyTorch versions; they are
held to the Pallas kernels ``admixture_fullstep``, ``admixture_sweep_fused``
and ``admixture_sweep_stats`` in interpret mode (float32), to the JAX step
``_em_step_unconstrained_pallas`` in interpret mode, and at fit level to
the JAX driver in float64.  The CUDA kernels themselves are held to the
plain versions on the card by tests/test_torch_cuda.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiclust_tpu.config import InitProcedure, Options
from multiclust_tpu.io.dataset import from_counts
from multiclust_tpu.model import admixture as jadm
from multiclust_tpu.model.common import EMConfig as JaxEMConfig, \
    ModelData as JaxModelData, Params as JaxParams, \
    model_data_from_dataset as jax_model_data, pad_params_k as jax_pad_k
from multiclust_tpu.ops import df64
from multiclust_tpu.ops.kernels import admixture_fullstep as jax_fullstep, \
    admixture_sweep_fused as jax_sweep_fused, \
    admixture_sweep_stats as jax_sweep_stats
from multiclust_tpu.opt.driver import fit as jax_fit
from multiclust_tpu_torch.convert import params_from_numpy
from multiclust_tpu_torch.model import admixture as tadm
from multiclust_tpu_torch.model.common import EMConfig, Params, \
    make_model_data, model_data_from_dataset
from multiclust_tpu_torch.ops import fullstep as fs
from multiclust_tpu_torch.convert import dataset_from, options_from
from multiclust_tpu_torch.opt.driver import fit
from multiclust_tpu_torch.runtime.multistart import _pad_k

torch.set_num_threads(2)

# float32 against the interpret-mode kernels, whose _recip is an
# approximate reciprocal plus one Newton step (kernels.py:145-151)
F32 = dict(rtol=1e-5, atol=1e-6)
LL_TOL = 5e-3
TL = 128   # the JAX kernels' lane tile; their lanes are padded to it


def _counts(rng, Q, P, miss):
    """Genotype counts [I, L, M]: each observed copy draws its allele from
    the admixed frequencies Q_i P_l."""
    prob = np.einsum("ik,klm->ilm", Q, P)
    prob /= prob.sum(axis=-1, keepdims=True)
    return rng.multinomial(2 - miss, prob)


def _panel(seed, I, L, M, K, miss_rate, small=2, frac_small=0.3,
           conc=(0.5, 1.0)):
    """A jagged panel: a fraction of the loci have ``small`` valid allele
    slots, the rest M; admixture proportions and allele frequencies drawn
    with the Dirichlet concentrations ``conc``.  Returns counts, miss,
    mask."""
    rng = np.random.default_rng(seed)
    n_all = np.where(rng.random(L) < frac_small, small, M)
    mask = np.arange(M)[None, :] < n_all[:, None]
    Q = rng.dirichlet(np.full(K, conc[0]), size=I)
    P = rng.dirichlet(np.full(M, conc[1]), size=(K, L)) * mask
    P /= P.sum(axis=-1, keepdims=True)
    miss = (rng.binomial(2, miss_rate, size=(I, L)) if miss_rate
            else np.zeros((I, L), np.int64))
    return _counts(rng, Q, P, miss), miss, mask


def _params(seed, I, K, Kp, mask):
    """eta [I, Kp] and p [Kp, L, M] with zero pads on the allele mask.
    Sharp Dirichlet draws make the eta and p projections pin lanes for
    the bounds used below."""
    rng = np.random.default_rng(seed)
    L, M = mask.shape
    eta = np.zeros((I, Kp))
    eta[:, :K] = rng.dirichlet(np.full(K, 0.3), size=I)
    p = np.zeros((Kp, L, M))
    p[:K] = rng.dirichlet(np.full(M, 0.5), size=(K, L)) * mask
    p[:K] /= p[:K].sum(axis=-1, keepdims=True)
    return eta, p


def _lanes_padded(a, lm):
    """Zero-pad the last axis to the JAX kernels' lane tile."""
    return np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, -(-lm // TL) * TL - lm)])


def _f32(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float32)


def _i8(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.int8)


def _jax_p_epilogue(B, p, eta, miss, mask, K, plb):
    """The XLA epilogue of _em_step_unconstrained_pallas
    (admixture.py:568-573): B + eta^T miss, then _normalize_p."""
    Kp, L, M = p.shape
    B = jnp.asarray(B).reshape(Kp, L, M)
    if miss is not None:
        B = B + (jnp.asarray(eta, jnp.float32).T
                 @ jnp.asarray(miss, jnp.float32))[:, :, None]
    md = JaxModelData(x=jnp.zeros((1, L, M), jnp.float32),
                      miss=jnp.zeros((1, L), jnp.float32),
                      mask=jnp.asarray(mask),
                      n_alleles=jnp.asarray(mask.sum(axis=1), jnp.int32))
    cfg = JaxEMConfig(admixture=True, k_true=K, p_lower_bound=plb)
    return jadm._normalize_p(jnp.asarray(p, jnp.float32) * B, md, cfg)


@pytest.mark.parametrize("Kp,K", [(32, 5), (64, 40)])
@pytest.mark.parametrize("miss_rate", [0.0, 0.15])
@pytest.mark.parametrize("compute_t", [True, False])
def test_fullstep_matches_pallas_interpret(Kp, K, miss_rate, compute_t):
    """Rows pass, columns pass and p epilogue on a jagged M = 3 panel,
    against the Pallas kernel in interpret mode and JAX's XLA epilogue."""
    I, L, M = 64, 40, 3
    x, miss, mask = _panel(K, I, L, M, K, miss_rate)
    eta, p = _params(K + 1, I, K, Kp, mask)
    LM = L * M
    x2, p2 = x.reshape(I, LM), p.reshape(Kp, LM)
    c = miss.sum(axis=1).astype(np.float32)
    kw = dict(k_true=K, lb=0.01, project=True, compute_t=compute_t)
    je, jt, jB = jax_fullstep(
        jnp.asarray(eta, jnp.float32), jnp.asarray(_lanes_padded(p2, LM),
                                                   jnp.float32),
        jnp.asarray(_lanes_padded(x2, LM), jnp.int8), jnp.asarray(c[:, None]),
        ti=I, tl=TL, interpret=True, **kw)
    jB = np.asarray(jB)[:, :LM]
    jp = _jax_p_epilogue(jB, p, eta, miss if miss_rate else None, mask, K,
                         0.05)

    te, tt, tp = fs.admixture_fullstep(
        _f32(eta)[None], _f32(p2)[None], _i8(x2), _f32(c),
        _i8(miss) if miss_rate else None, torch.as_tensor(mask), plb=0.05,
        **kw)
    tB = fs.fullstep_cols(_f32(eta)[None], _f32(p2)[None], _i8(x2),
                          finish=False)
    np.testing.assert_allclose(te[0].numpy(), np.asarray(je), **F32)
    np.testing.assert_allclose(tB[0].numpy(), jB, **F32)
    np.testing.assert_allclose(tp[0].numpy(), np.asarray(jp), **F32)
    np.testing.assert_allclose(tt[0].numpy(), np.asarray(jt), rtol=1e-5,
                               atol=LL_TOL / I)
    assert abs(float(tt.double().sum()) - float(np.sum(jt))) < LL_TOL
    if not compute_t:
        assert (tt == 0).all()
    # pads stay exactly zero; masked lanes and zero denominators stay
    # free of NaN (x > 0 is masked, the denominator is not clamped)
    assert torch.isfinite(te).all() and torch.isfinite(tp).all()
    assert (te[0, :, K:] == 0).all() and (tp[0, K:] == 0).all()
    assert (tp[0][:, ~torch.as_tensor(mask)] == 0).all()
    np.testing.assert_allclose(tp[0, :K].sum(dim=-1).numpy(), 1.0, rtol=1e-5)


def test_a0_emit_a_chain_matches_pallas_interpret():
    """Two launches over the two halves of the lanes, A threaded through
    a0 / emit_a (the jagged-bucket chaining), equal JAX's chain and the
    single launch over all lanes."""
    I, L, M, K, Kp = 64, 40, 3, 5, 32
    x, miss, mask = _panel(3, I, L, M, K, 0.1)
    eta, p = _params(4, I, K, Kp, mask)
    LM, LM1 = L * M, 20 * M
    x2, p2 = x.reshape(I, LM), p.reshape(Kp, LM)
    c = miss.sum(axis=1).astype(np.float32)
    kw = dict(k_true=K, lb=0.01, project=True)
    halves = ((x2[:, :LM1], p2[:, :LM1]), (x2[:, LM1:], p2[:, LM1:]))

    def jax_launch(xh, ph, a0=None, emit_a=False):
        n = xh.shape[1]
        return jax_fullstep(
            jnp.asarray(eta, jnp.float32),
            jnp.asarray(_lanes_padded(ph, n), jnp.float32),
            jnp.asarray(_lanes_padded(xh, n), jnp.int8),
            jnp.asarray(c[:, None]), a0, ti=I, tl=TL, emit_a=emit_a,
            interpret=True, **kw)

    jA, jt1, _ = jax_launch(*halves[0], emit_a=True)
    je, jt2, _ = jax_launch(*halves[1], a0=jA)

    te = _f32(eta)[None]
    tA, tt1 = fs.fullstep_rows(te, _f32(halves[0][1])[None],
                               _i8(halves[0][0]), _f32(c), finish=False, **kw)
    te2, tt2 = fs.fullstep_rows(te, _f32(halves[1][1])[None],
                                _i8(halves[1][0]), _f32(c), tA, **kw)
    np.testing.assert_allclose(tA[0].numpy(), np.asarray(jA), **F32)
    np.testing.assert_allclose(te2[0].numpy(), np.asarray(je), **F32)
    assert abs(float((tt1 + tt2).double().sum())
               - float(np.sum(jt1) + np.sum(jt2))) < LL_TOL
    one, t_one = fs.fullstep_rows(te, _f32(p2)[None], _i8(x2), _f32(c), **kw)
    np.testing.assert_allclose(te2.numpy(), one.numpy(), **F32)
    np.testing.assert_allclose(float((tt1 + tt2).sum()),
                               float(t_one.sum()), rtol=1e-5)


@pytest.mark.parametrize("compute_t", [True, False])
def test_sweep_stats_match_pallas_interpret(compute_t):
    """The port's sweep statistics (the full step's passes with
    finish=False) against both JAX sweeps, fused and two-pass."""
    I, L, M, K, Kp = 64, 30, 5, 6, 32
    x, miss, mask = _panel(5, I, L, M, K, 0.0, small=3)
    eta, p = _params(6, I, K, Kp, mask)
    LM = L * M
    x2, p2 = x.reshape(I, LM), p.reshape(Kp, LM)
    args = (jnp.asarray(eta, jnp.float32),
            jnp.asarray(_lanes_padded(p2, LM), jnp.float32),
            jnp.asarray(_lanes_padded(x2, LM), jnp.int8))
    tA, tt, tB = fs.admixture_sweep_stats(_f32(eta)[None], _f32(p2)[None],
                                          _i8(x2), compute_t=compute_t)
    for sweep in (jax_sweep_fused, jax_sweep_stats):
        jA, jt, jB = sweep(*args, ti=I, tl=TL, compute_t=compute_t,
                           interpret=True)
        np.testing.assert_allclose(tA[0].numpy(), np.asarray(jA), **F32)
        np.testing.assert_allclose(tB[0].numpy(), np.asarray(jB)[:, :LM],
                                   **F32)
        assert abs(float(tt.double().sum()) - float(np.sum(jt))) < LL_TOL


def test_em_step_generic_matches_pallas_step():
    """Three float32 steps of the port's _em_step_generic (plain versions
    on CPU tensors, K-padded) against JAX's _em_step_unconstrained_pallas
    with the fullstep kernel in interpret mode."""
    I, L, M, K, Kp = 64, 40, 4, 4, 32
    x, miss, mask = _panel(7, I, L, M, K, 0.1, small=3)
    ds = from_counts(x, miss, 2, n_alleles=mask.sum(axis=1))
    eta, p = _params(8, I, K, K, mask)
    jcfg = JaxEMConfig(admixture=True, k_true=K, use_pallas="interpret")
    jmd = jax_model_data(ds, dtype=jnp.float32)
    jp = jax_pad_k(JaxParams(eta=jnp.asarray(eta, jnp.float32),
                             p=jnp.asarray(p, jnp.float32)), Kp)
    cfg = EMConfig(admixture=True, k_true=K, use_pallas="on")
    tmd = model_data_from_dataset(ds, dtype=torch.float32)
    tp = _pad_k(params_from_numpy(eta[None], p[None], dtype=torch.float32),
                cfg)
    assert tp.eta.shape == (1, I, Kp)
    for _ in range(3):
        jp, jll, _ = jadm.em_step(jp, jmd, jcfg)
        tp, tll, _ = tadm.em_step(tp, tmd, cfg)
        np.testing.assert_allclose(tp.eta[0].numpy(), np.asarray(jp.eta),
                                   **F32)
        np.testing.assert_allclose(tp.p[0].numpy(), np.asarray(jp.p), **F32)
        assert abs(float(tll[0]) - float(df64.df_value(jll))) < LL_TOL
        assert (tp.eta[0, :, K:] == 0).all() and (tp.p[0, K:] == 0).all()


def test_int8_storage_step_matches_float_storage():
    """The CUDA storage layout on CPU tensors: int8 x and miss, with
    missing totals above 127 (the int8 miss is cast before any sum),
    give the same step as float storage."""
    I, L, M, K = 16, 150, 3, 3
    x, miss, mask = _panel(9, I, L, M, K, 0.6)
    assert miss.sum(axis=1).max() > 127
    eta, p = _params(10, I, K, 32, mask)
    cfg = EMConfig(admixture=True, k_true=K, use_pallas="on")
    params = Params(eta=_f32(eta)[None], p=_f32(p)[None])
    out = []
    for storage in (None, torch.int8):
        md = make_model_data(x, miss, mask, mask.sum(axis=1),
                             dtype=torch.float32, device="cpu",
                             storage_dtype=storage)
        np.testing.assert_array_equal(md.c.numpy(), miss.sum(axis=1))
        out.append(tadm.em_step(params, md, cfg))
    assert out[1][0].p.dtype == torch.float32
    for a, b in zip(out[0][0], out[1][0]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float(out[0][1][0]) == float(out[1][1][0])


def test_zero_mass_cluster_projects_to_uniform():
    """A real cluster with no mass at all gets p = 1/n_alleles on each
    locus's valid lanes under projection, 0 without it."""
    I, L, M, K, Kp = 32, 10, 4, 3, 32
    x, miss, mask = _panel(11, I, L, M, K, 0.05, small=3)
    eta, p = _params(12, I, K, Kp, mask)
    eta[:, 1] = 0.0
    eta /= eta.sum(axis=1, keepdims=True)
    args = (_f32(eta)[None], _f32(p.reshape(Kp, -1))[None],
            _i8(x.reshape(I, -1)), _i8(miss), torch.as_tensor(mask))
    got = fs.fullstep_cols(*args, k_true=K, plb=1e-8, project=True)
    want = np.where(mask, 1.0 / mask.sum(axis=1, keepdims=True), 0.0)
    np.testing.assert_allclose(got[0, 1].numpy(), want, rtol=1e-6)
    off = fs.fullstep_cols(*args, k_true=K, plb=1e-8, project=False)
    assert (off[0, 1] == 0).all()


def test_generic_fit_matches_jax_f64_and_f32_route():
    """A warm-start fit on an M = 4 panel: the port's float64 CPU fit
    reaches the JAX driver's logL to 1e-8 relative in the same number of
    iterations.  The float32 kernel route (plain versions on CPU tensors)
    stays within the float32 noise floor of the float64 trajectory over
    the same 30 capped iterations; run free, it stops where its logL gain
    first falls under that floor, short of the float64 optimum on this
    slowly converging panel (0.03 logL here), and within 0.1 of it."""
    I, L, M, K = 80, 50, 4, 3
    x, miss, mask = _panel(14, I, L, M, K, 0.05, small=3, conc=(0.2, 0.5))
    ds = from_counts(x, miss, 2, n_alleles=mask.sum(axis=1))
    rng = np.random.default_rng(15)
    eta = rng.dirichlet(np.full(K, 2.0), size=I)
    p = rng.dirichlet(np.full(M, 2.0), size=(K, L)) * mask
    p /= p.sum(axis=-1, keepdims=True)
    base = dict(admixture=True, has_missing=True)
    jr = jax_fit(JaxParams(eta=jnp.asarray(eta), p=jnp.asarray(p)),
                 jax_model_data(ds, dtype=jnp.float64), JaxEMConfig(**base))
    md64 = model_data_from_dataset(ds, dtype=torch.float64)
    tr = fit(params_from_numpy(eta, p), md64, EMConfig(**base))
    assert tr.converged and jr.converged
    assert tr.n_iter == jr.n_iter
    assert abs(tr.logL - jr.logL) <= 1e-8 * abs(jr.logL)

    md32 = model_data_from_dataset(ds, dtype=torch.float32)
    warm32 = params_from_numpy(eta, p, dtype=torch.float32)
    capped = dict(max_iter=30, abs_error=1e-12, **base)
    cfg = EMConfig(use_pallas="on", k_true=K, **capped)
    f32 = fit(_pad_k(warm32, cfg), md32, cfg)
    f64 = fit(params_from_numpy(eta, p), md64, EMConfig(**capped))
    assert f32.n_iter == f64.n_iter == 31
    floor = cfg.noise_factor * np.finfo(np.float32).eps * float(
        f32.state.scale[0])
    assert abs(f32.logL - f64.logL) <= floor, (f32.logL, f64.logL, floor)

    cfg = EMConfig(use_pallas="on", k_true=K, **base)
    free = fit(_pad_k(warm32, cfg), md32, cfg)
    assert free.converged and not bool(free.state.mono_viol[0])
    assert abs(free.logL - tr.logL) < 0.1, (free.logL, tr.logL)


def test_fit_dataset_takes_the_generic_route(monkeypatch):
    """api.fit_dataset on a multi-allelic panel with the kernel policy on
    (float32 CPU tensors, the plain versions) runs Rand-EM scoring,
    K-padding, multi-start and the harvest through _em_step_generic."""
    from multiclust_tpu_torch.api import fit_dataset

    calls = []
    orig = tadm._em_step_generic
    monkeypatch.setattr(tadm, "_em_step_generic",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    x, miss, mask = _panel(15, 60, 30, 5, 3, 0.05, small=3)
    ds = from_counts(x, miss, 2, n_alleles=mask.sum(axis=1))
    opt = Options(admixture=True, min_K=3, max_K=3, n_init=2, seed=1,
                  dtype="float32", use_pallas=True, max_iter=40, verbosity=0,
                  write_files=False,
                  initialization_procedure=InitProcedure.RAND_EM,
                  n_rand_em_init=3)
    out = fit_dataset(dataset_from(ds), options_from(opt), device="cpu")
    res = out.best
    assert calls and np.isfinite(res.max_logL) and not res.mono_viol
    eta, p = res.best_params.eta, res.best_params.p
    assert eta.shape == (ds.I, 3) and p.shape == (3, ds.L, ds.M)
    np.testing.assert_allclose(p.sum(dim=-1).numpy(), 1.0, rtol=1e-5)
    assert (p[:, ~torch.as_tensor(ds.mask)] == 0).all()
    # on CUDA the kernels are the one route of such a fit
    from multiclust_tpu_torch.runtime.multistart import device_policy
    with pytest.raises(ValueError, match="kernels"):
        device_policy(options_from(dataclasses.replace(
            opt, use_pallas=False)), "cuda")


def test_cuda_wrappers_refuse_unsupported_shapes():
    """The wrappers validate before launching: Kp above 1024 raises with
    the plain route's name (no fallback), as do more than M_MAX allele slots,
    lanes that are not whole loci, a p epilogue without its mask and a
    k_true (where the kernels' cluster loops stop) outside [0, Kp]."""
    x = torch.zeros(8, 10, dtype=torch.int8)
    with pytest.raises(ValueError, match="Kp=1056.*plain step"):
        fs._check_cuda_inputs(torch.zeros(1, 8, 1056),
                              torch.zeros(1, 1056, 10), x)
    with pytest.raises(ValueError, match="x2 dtype"):
        fs._check_cuda_inputs(torch.zeros(1, 8, 32), torch.zeros(1, 32, 10),
                              x.float())
    with pytest.raises(ValueError, match="allele mask"):
        fs.fullstep_p(torch.zeros(1, 32, 12), torch.zeros(1, 1, 32, 12),
                      M=3)
    with pytest.raises(ValueError, match="M <= 1024"):
        fs.fullstep_cols(torch.zeros(1, 8, 32), torch.zeros(1, 32, 2050), x,
                         mask=torch.ones(2, 1025, dtype=torch.bool))
    with pytest.raises(ValueError, match="dividing"):
        fs.fullstep_partials(torch.zeros(1, 8, 32), torch.zeros(1, 32, 10),
                             x, M=3)
    args = (torch.zeros(1, 8, 32), torch.zeros(1, 32, 10), x)
    for k_true in (33, -1):
        with pytest.raises(ValueError, match="k_true"):
            fs.fullstep_partials(*args, M=5, k_true=k_true)
        with pytest.raises(ValueError, match="k_true"):
            fs.fullstep_cols(*args, k_true=k_true, finish=False)
        with pytest.raises(ValueError, match="k_true"):
            fs.fullstep_rows(*args, k_true=k_true, lb=0.0, project=False)
    # 0 means all Kp lanes, as every k_true in [1, Kp] is taken
    for k_true in (0, 1, 32):
        assert fs.fullstep_partials(*args, M=5, k_true=k_true).shape == (
            1, 1, 32, 10)



@pytest.mark.parametrize("K,Kp", [(20, 32), (40, 64), (70, 96), (100, 128)])
def test_cols_segments_fill_the_card_within_their_caps(K, Kp):
    """The columns pass's row segments (on 132 SMs): whole eta tiles that
    cover I, at most COLS_MAX_RSEG, partials no larger than SCRATCH_CAP
    or than the int8 x the pass reads; the fit's panel (16384 x 2048 x M =
    4) gets about COLS_BLOCKS_PER_SM blocks an SM at 1, 2 and 4 chains, a
    short panel one segment."""
    from multiclust_tpu_torch.ops import fullstep_bi as fb

    n_sm = 132
    tc, ri = fb.cols_tile(K, Kp)
    for B, I, LM in ((1, 16384, 8192), (2, 16384, 8192), (4, 16384, 8192),
                     (2, 40, 85), (2, 3100, 400), (1, 100000, 64),
                     (2, 8192, 1 << 20)):
        n, seg_rows = fs.cols_segments(B, I, LM, Kp, n_sm, K)
        assert 1 <= n <= fb.COLS_MAX_RSEG
        assert seg_rows % ri == 0 and (n - 1) * seg_rows < I <= n * seg_rows
        if n > 1:
            part_bytes = 4 * B * n * Kp * LM
            assert part_bytes <= min(fb.SCRATCH_CAP, I * LM)
        if I == 16384:
            blocks = -(-LM // tc) * B * n
            assert blocks >= (fb.COLS_BLOCKS_PER_SM - 1) * n_sm, (B, n)
    assert fs.cols_segments(2, 40, 85, Kp, n_sm, K)[0] == 1

def _write_structure(x, miss, path):
    """STRUCTURE rows, one per allele copy: allele m + 1 once for each
    count of slot m, then -9 for each missing copy."""
    I, L, _ = x.shape
    with open(path, "w") as fh:
        fh.write(" ".join(f"loc{l}" for l in range(L)) + "\n")
        for i in range(I):
            copies = [np.concatenate([np.repeat(np.arange(1, x.shape[2] + 1),
                                                x[i, l]),
                                      np.full(miss[i, l], -9)])
                      for l in range(L)]
            for a in range(2):
                fh.write(f"ind{i} pop0 "
                         + " ".join(str(c[a]) for c in copies) + "\n")


def test_cli_multiallelic_writes_every_file(tmp_path):
    """The port's CLI on a multi-allelic STRUCTURE file (3-6 alleles per
    locus, missing copies) writes the five files of a biallelic run."""
    from multiclust_tpu_torch.cli import main

    x, miss, mask = _panel(16, 40, 25, 6, 3, 0.05, small=3, frac_small=0.5)
    data = str(tmp_path / "sim.str")
    _write_structure(x, miss, data)
    assert main(["-f", data, "-a", "-k", "3", "-n", "2", "-s", "1",
                 "--platform", "cpu", "-d", str(tmp_path)]) == 0
    for f in ("sim.str.admix.K=3.out.txt", "sim.str.admix.K=3.etaik.txt",
              "sim.str.admix.K=3.pklm.txt", "sim.str_admix_popq_3.popq",
              "sim.str_admix_indivq_3.indivq"):
        assert (tmp_path / f).stat().st_size > 0, f
