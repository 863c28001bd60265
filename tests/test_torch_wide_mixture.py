"""The mixture step at 128 < Kp <= 1024 (the wide mixture kernels of
csrc/mixture_bi.cu) and above 1024 (the plain step, with no notice) on the
CPU.

On the CPU the port's wrappers run their plain PyTorch versions (the wide
kernels are held to those on the card, tests/test_torch_cuda.py); what
runs here is the port's routing and padding at those Kp: the float64 step
against the JAX package's XLA step (biallelic with and without missing
data, M = 4, a jagged panel bucketed), the float32 kernel route against
the JAX package's Pallas kernels in interpret mode, warm-start fits at
K = 200, the gate at 1024 / 1056 lanes, the wrappers' Kp check and the
columns pass's tiling.  Inputs are made with numpy from a seed and handed
to both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multiclust_tpu.model.bucketed as jbk
import multiclust_tpu_torch.model.bucketed as tbk
from multiclust_tpu.model import mixture as jmix
from multiclust_tpu.model.common import EMConfig as JaxEMConfig, \
    ModelData as JaxModelData, Params as JaxParams, \
    model_data_from_dataset as jax_model_data
from multiclust_tpu.ops import df64
from multiclust_tpu.opt.driver import fit as jax_fit
from multiclust_tpu_torch.convert import dataset_from_counts, \
    params_from_numpy
from multiclust_tpu_torch.model import mixture as tmix
from multiclust_tpu_torch.model.common import EMConfig, Params, \
    make_model_data, model_data_from_dataset
from multiclust_tpu_torch.ops import fullstep as fs, mixture_bi as mb
from multiclust_tpu_torch.opt.driver import fit

torch.set_num_threads(2)

WIDE_K = (130, 200)
F64 = dict(rtol=1e-10, atol=1e-10)
# float32: the Pallas kernels' approximate reciprocal (kernels.py:145)
# holds interpret mode to XLA only this close (test_kernels.py:736-742)
INTERPRET = dict(rtol=2e-4, atol=1e-5)


def _panel(seed, I, L, K, M=2, missing_rate=0.0, jagged=False):
    """A mixture-model panel of K clusters: counts [I, L, M], miss, mask,
    n_alleles, and warm parameters eta [K], p [K, L, M].  Every locus has
    M alleles, or with ``jagged`` 80 % of them 2 and the rest M."""
    rng = np.random.default_rng(seed)
    Ml = np.where(rng.random(L) < 0.8, 2, M) if jagged else np.full(L, M)
    mask = np.arange(M)[None] < Ml[:, None]
    P = rng.gamma(0.8, size=(K, L, M)) * mask
    P /= P.sum(axis=2, keepdims=True)
    z = rng.choice(K, size=I, p=rng.dirichlet(np.full(K, 5.0)))
    miss = rng.binomial(2, missing_rate, size=(I, L))
    counts = np.stack([rng.multinomial(2 - miss[i, l], P[z[i], l])
                       for i in range(I) for l in range(L)]).reshape(I, L, M)
    eta = rng.dirichlet(np.full(K, 3.0))
    p = rng.dirichlet(np.full(M, 2.0), size=(K, L)) * mask
    return counts, miss, mask, Ml, eta, p / p.sum(axis=2, keepdims=True)


def _cfg(counts, miss, Ml, **kw):
    base = dict(admixture=False, biallelic=bool((Ml == 2).all()
                                                and counts.shape[2] == 2),
                has_missing=bool(miss.any()), ploidy=2)
    base.update(kw)
    return base


def _ll(df):
    return float(df64.df_value(df))


@pytest.mark.parametrize("case", ["bi-fold", "bi-missing", "M4", "jagged"])
@pytest.mark.parametrize("K", WIDE_K)
def test_em_step_f64_matches_xla(K, case):
    """Three float64 mixture steps at K = 130 and 200 (160 and 224 lanes
    in the kernels' padding) track the JAX XLA step to 1e-10: the
    biallelic one-product fold, the missing-data path, an M = 4 panel and
    a jagged panel (80 % M = 2, 20 % M = 8) on its buckets."""
    M = {"M4": 4, "jagged": 8}.get(case, 2)
    miss_rate = 0.0 if case == "bi-fold" else 0.05
    counts, miss, mask, Ml, eta, p = _panel(K, 48, 40, K, M, miss_rate,
                                            jagged=case == "jagged")
    base = _cfg(counts, miss, Ml)
    assert base["biallelic"] == (M == 2)
    jmd = JaxModelData(x=jnp.asarray(counts, jnp.float64),
                       miss=jnp.asarray(miss, jnp.float64),
                       mask=jnp.asarray(mask), n_alleles=jnp.asarray(Ml))
    tmd = make_model_data(counts, miss, mask, Ml, dtype=torch.float64,
                          device="cpu")
    if case == "jagged":
        jmd = jax.jit(lambda m: jbk.bucketize_model_data(
            m, jbk.plan_buckets(Ml, M, min_bucket=4, tight=True)))(jmd)
        tmd = tbk.bucketize_model_data(tmd, tbk.plan_buckets(Ml, M,
                                                             min_bucket=4))
    else:
        jmd = jmd.prepare_for_em(bi=base["biallelic"])
    jcfg, tcfg = JaxEMConfig(**base), EMConfig(**base)
    jp = JaxParams(eta=jnp.asarray(eta), p=jnp.asarray(p))
    tp = params_from_numpy(eta[None], p[None])
    step = jax.jit(lambda q: jmix.em_step(q, jmd, jcfg)[:2])
    for _ in range(3):
        jp, jll = step(jp)
        tp, tll, _ = tmix.em_step(tp, tmd, tcfg)
        got_p = (tbk.merge_params_like(tp, tmd).p if case == "jagged"
                 else tp.p)
        want_p = (jbk.merge_params_like(jp, jmd, M).p if case == "jagged"
                  else jp.p)
        np.testing.assert_allclose(tp.eta[0].numpy(), np.asarray(jp.eta),
                                   **F64)
        np.testing.assert_allclose(got_p[0].numpy(), np.asarray(want_p),
                                   **F64)
        np.testing.assert_allclose(float(tll[0]), _ll(jll), rtol=1e-10)


def _bi_dataset(seed, I, L, K, missing_rate):
    counts, miss, _, _, eta, p = _panel(seed, I, L, K, 2, missing_rate)
    return dataset_from_counts(counts, miss, 2), eta, p


@pytest.mark.parametrize("variant", ["two-pass", "resident"])
@pytest.mark.parametrize("missing_rate", [0.0, 0.15])
def test_kernel_route_matches_pallas_interpret_kp160(variant, missing_rate,
                                                     monkeypatch):
    """At K = 150 (160 lanes, the wide passes on the card) the port's
    float32 kernel route (the wrappers' plain versions on CPU tensors)
    against JAX's mixture step through the Pallas kernels in interpret
    mode, mixture_fullstep_biallelic (two-pass) or mixture_sweep_resident
    (resident), two steps, each from the same parameters (the JAX step's
    last ones), and the kernel route's logL.  The two-pass kernel sums B0
    and B1 in float32 over the rows (kernels.py:1190-1194): with 150
    clusters over 70 individuals its p lies up to 1.5 times its own
    tolerance from the float64 step (measured on this panel; the port's
    within 4 % of it), so there the port's p is held to JAX's float64 XLA
    step, and its eta and logL to the kernel."""
    if variant == "two-pass":
        import multiclust_tpu.ops.kernels as kmod
        monkeypatch.setattr(kmod, "pick_layout_mixture_resident",
                            lambda *a, **k: (0, 0, 0))
    K = 150
    ds, eta, p = _bi_dataset(21, 70, 50, K, missing_rate)
    base = dict(admixture=False, biallelic=True,
                has_missing=missing_rate > 0, ploidy=2,
                eta_lower_bound=1e-4, p_lower_bound=1e-3)
    jmd = jax_model_data(ds, dtype=jnp.float32,
                         storage_dtype=jnp.int8).prepare_for_em(bi=True)
    jmd64 = jax_model_data(ds, dtype=jnp.float64).prepare_for_em(bi=True)
    jcfg = JaxEMConfig(use_pallas="interpret", **base)
    jp = JaxParams(eta=jnp.asarray(eta, jnp.float32),
                   p=jnp.asarray(p, jnp.float32))
    assert jmix._kernel_ok(jmd, jcfg, jp)
    tmd = model_data_from_dataset(ds, dtype=torch.float32)
    tcfg = EMConfig(use_pallas="on", **base)
    tp = params_from_numpy(eta[None], p[None], dtype=torch.float32)
    assert tmix._kernel_ok(tmd, tcfg, tp)
    for _ in range(2):
        start = params_from_numpy(np.array(jp.eta)[None],
                                  np.array(jp.p)[None], dtype=torch.float32)
        p_ref = jmix.em_step(JaxParams(eta=jp.eta.astype(jnp.float64),
                                       p=jp.p.astype(jnp.float64)),
                             jmd64, JaxEMConfig(**base))[0].p
        jp, jll, _, _ = jmix.em_step(jp, jmd, jcfg)
        tp, tll, _ = tmix.em_step(start, tmd, tcfg)
        np.testing.assert_allclose(tp.eta[0].numpy(), np.asarray(jp.eta),
                                   **INTERPRET)
        np.testing.assert_allclose(
            tp.p[0].numpy(),
            np.asarray(p_ref if variant == "two-pass" else jp.p),
            **INTERPRET)
        np.testing.assert_allclose(float(tll[0]), _ll(jll), rtol=1e-5)
    ll, _ = tmix.log_likelihood(tp, tmd, tcfg)
    jll2, _ = jmix.log_likelihood(jp, jmd, jcfg)
    np.testing.assert_allclose(float(ll[0]), _ll(jll2), rtol=1e-5)


def test_sweep_stats_reference_matches_pallas_interpret_kp160():
    """The plain sweep statistics at 160 lanes (K = 150) against
    mixture_sweep_resident in interpret mode on the same K-padded inputs,
    two streams; v is 0 past K."""
    from multiclust_tpu.ops.kernels import mixture_sweep_resident

    rng = np.random.default_rng(12)
    I, Ip, L, K, Kp = 70, 72, 50, 150, 160
    miss = rng.binomial(2, 0.1, size=(I, L))
    x0 = rng.binomial(2 - miss, rng.uniform(0.2, 0.8, size=(1, L)))
    x1 = 2 - miss - x0
    lp0 = np.zeros((Kp, L), np.float32)
    lp1 = np.zeros((Kp, L), np.float32)
    lp0[:K] = np.log(rng.uniform(0.1, 0.9, size=(K, L)))
    lp1[:K] = np.log(rng.uniform(0.1, 0.9, size=(K, L)))
    bias = np.full((1, Kp), tmix.PAD_BIAS, np.float32)
    bias[0, :K] = np.log(rng.dirichlet(np.ones(K)))

    def pad(a):
        return jnp.asarray(np.pad(a, ((0, Ip - I), (0, 0))), jnp.int8)

    jv, jt, jb0, jb1 = mixture_sweep_resident(
        jnp.asarray(lp0), pad(x0), jnp.asarray(bias), jnp.asarray(lp1),
        pad(x1), ti=8, interpret=True)
    tv, tt, tb0, tb1 = mb.mixture_sweep_stats(
        torch.as_tensor(lp0)[None], torch.as_tensor(x0, dtype=torch.int8),
        torch.as_tensor(bias), torch.as_tensor(lp1)[None],
        torch.as_tensor(x1, dtype=torch.int8), k_true=K)
    np.testing.assert_allclose(tv[0].numpy(), np.asarray(jv)[:I],
                               **INTERPRET)
    np.testing.assert_allclose(tt[0].numpy(), np.asarray(jt)[:I], rtol=1e-5)
    np.testing.assert_allclose(tb0[0].numpy(), np.asarray(jb0), **INTERPRET)
    np.testing.assert_allclose(tb1[0].numpy(), np.asarray(jb1), **INTERPRET)
    assert (tv[0, :, K:] == 0).all()


def test_warm_start_fit_k200_matches_jax():
    """Warm-start mixture fits at K = 200 on a 600 x 500 panel of weakly
    separated clusters (chip_smoke.py's reference panel, 5 % missing)
    through the JAX driver and the port (float64) reach the same logL in
    the same iterations; the port's float32 kernel route from the same
    start (the wrappers' plain versions on the CPU) ends within the
    float32 noise floor of opt/em.py of the float64 fit."""
    from multiclust_tpu_torch.route_times import mixture_planes

    I, L, K = 600, 500, 200
    planes, miss = mixture_planes(81, I, L, K, 0.05, "cpu", spread=0.04)
    ds = dataset_from_counts(planes.permute(1, 2, 0).long().numpy(),
                             miss.long().numpy(), 2)
    rng = np.random.default_rng(82)
    eta = rng.dirichlet(np.full(K, 3.0))
    p0 = rng.uniform(0.2, 0.8, size=(K, L))
    p = np.stack([p0, 1 - p0], axis=2)
    base = dict(admixture=False, biallelic=True, has_missing=True,
                ploidy=2, max_iter=30, abs_error=1e-12,
                eta_lower_bound=1e-8, p_lower_bound=1e-8)
    jr = jax_fit(JaxParams(eta=jnp.asarray(eta), p=jnp.asarray(p)),
                 jax_model_data(ds, dtype=jnp.float64), JaxEMConfig(**base))
    md64 = model_data_from_dataset(ds, dtype=torch.float64)
    tr = fit(params_from_numpy(eta, p), md64, EMConfig(**base))
    assert tr.n_iter == jr.n_iter, (tr.n_iter, jr.n_iter)
    np.testing.assert_allclose(tr.logL, jr.logL, rtol=1e-10)
    f32 = fit(params_from_numpy(eta, p, dtype=torch.float32),
              model_data_from_dataset(ds, dtype=torch.float32),
              EMConfig(use_pallas="on", **base))
    _, scale = tmix.log_likelihood(
        Params(eta=tr.params.eta[None], p=tr.params.p[None]), md64,
        EMConfig(**base))
    floor = (EMConfig().noise_factor * float(np.finfo(np.float32).eps)
             * float(scale[0]))
    assert f32.n_iter <= 31 and tr.n_iter <= 31
    assert abs(f32.logL - tr.logL) <= floor, (f32.logL, tr.logL, floor)


@pytest.mark.parametrize("start", [0, 1, 2, 3])
def test_squarem_monotonicity_matches_jax_k150(start):
    """Whether SQUAREM's monotonicity record on a mixture panel with many
    clusters is the port's own: float64 SQUAREM fits through the JAX
    driver and the port from the same start, drawn by the JAX package's
    random-centers init and carried across by ``convert.params_from_numpy``,
    on a 600 x 400 mixture-model panel at K = 150 (160 lanes), with
    monotonicity fatal, so that a violation stops a fit where it happens:
    both record a violation at the same iteration with the same logL, or
    neither does (here neither does)."""
    from multiclust_tpu.init.random import initialize as jax_initialize
    from multiclust_tpu_torch.route_times import mixture_planes

    I, L, K = 600, 400, 150
    planes, miss = mixture_planes(150 + start, I, L, K, 0.0, "cpu")
    ds = dataset_from_counts(planes.permute(1, 2, 0).long().numpy(),
                             miss.long().numpy(), 2)
    base = dict(admixture=False, biallelic=True, has_missing=False,
                ploidy=2, max_iter=100, accel_scheme=1,
                monotonicity="fatal", eta_lower_bound=1e-8,
                p_lower_bound=1e-8)
    jmd = jax_model_data(ds, dtype=jnp.float64)
    jcfg = JaxEMConfig(**base)
    p0 = jax_initialize(jax.random.PRNGKey(start), jmd, K, jcfg)
    jr = jax_fit(p0, jmd, jcfg)
    tr = fit(params_from_numpy(np.array(p0.eta), np.array(p0.p)),
             model_data_from_dataset(ds, dtype=torch.float64),
             EMConfig(**base))
    j_viol = bool(np.asarray(jr.state.mono_viol).any())
    assert bool(tr.state.mono_viol[0]) == j_viol
    assert tr.n_iter == jr.n_iter, (tr.n_iter, jr.n_iter)
    np.testing.assert_allclose(tr.logL, jr.logL, rtol=1e-10)
    assert not j_viol


# ---------------------------------------------------------------------------
# the gate at 1024 lanes

def _spy(monkeypatch, called):
    """Record the mixture wrappers and the generic p epilogue as called."""
    for module, name in ((tmix, "mixture_rows"), (tmix, "mixture_eta"),
                         (tmix, "mixture_fullstep_biallelic"),
                         (tmix, "fullstep_p")):
        real = getattr(module, name)

        def spy(*a, _real=real, _name=name, **kw):
            called.add(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("K,M", [(1024, 2), (1040, 2), (1000, 4),
                                 (1040, 4)])
def test_kernel_gate_at_1024_lanes(K, M, monkeypatch, capsys):
    """``_kernel_ok`` and the finishes' gate take K padded to at most 1024
    lanes: a float32 step with the kernels on calls the kernel wrappers
    (their plain versions here) at K = 1024 and 1000, and none of them at
    K = 1040 (1056 lanes), where the step is the plain one and prints
    nothing, and equals the step with the kernels off."""
    counts, miss, mask, Ml, eta, p = _panel(M, 30, 8, K, M, 0.05)
    md = make_model_data(counts, miss, mask, Ml, dtype=torch.float32,
                         device="cpu")
    base = _cfg(counts, miss, Ml)
    params = params_from_numpy(eta[None], p[None], dtype=torch.float32)
    cfg = EMConfig(use_pallas="on", **base)
    in_range = K <= 1024
    assert tmix._kernel_ok(md, cfg, params) == (in_range and M == 2)
    called = set()
    _spy(monkeypatch, called)
    capsys.readouterr()
    got = tmix.em_step(params, md, cfg)
    out = capsys.readouterr()
    assert out.out == out.err == ""
    if not in_range:
        assert not called, called
    elif M == 2:
        assert called == {"mixture_fullstep_biallelic"}, called
    else:
        assert called == {"mixture_eta", "fullstep_p"}, called
    want = tmix.em_step(params, md, EMConfig(use_pallas="off", **base))
    tol = dict(rtol=0, atol=0) if not in_range else dict(rtol=1e-5,
                                                         atol=1e-6)
    for g, w in zip((got[0].eta, got[0].p, got[1]),
                    (want[0].eta, want[0].p, want[1])):
        torch.testing.assert_close(g, w, **tol)


def test_step_beyond_1024_lanes_matches_jax():
    """At K = 1040 (1056 lanes) the port's float32 step with the kernels
    on and the JAX package's with its Pallas kernels in interpret mode
    both take the plain formulation (JAX's ``_em_step_bi_kernel`` returns
    None above 1024 and XLA runs the step), and agree."""
    K = 1040
    ds, eta, p = _bi_dataset(25, 24, 12, K, 0.0)
    base = dict(admixture=False, biallelic=True, has_missing=False,
                ploidy=2)
    jmd = jax_model_data(ds, dtype=jnp.float32,
                         storage_dtype=jnp.int8).prepare_for_em(bi=True)
    jp = JaxParams(eta=jnp.asarray(eta, jnp.float32),
                   p=jnp.asarray(p, jnp.float32))
    jp, jll, _, _ = jmix.em_step(jp, jmd,
                                 JaxEMConfig(use_pallas="interpret", **base))
    tp = params_from_numpy(eta[None], p[None], dtype=torch.float32)
    tp, tll, _ = tmix.em_step(tp, model_data_from_dataset(
        ds, dtype=torch.float32), EMConfig(use_pallas="on", **base))
    # the two float32 formulations (the port's scores in float64, the
    # JAX package's in float32) at the mixture's float32 tolerance
    np.testing.assert_allclose(tp.eta[0].numpy(), np.asarray(jp.eta),
                               **INTERPRET)
    np.testing.assert_allclose(tp.p[0].numpy(), np.asarray(jp.p),
                               **INTERPRET)
    np.testing.assert_allclose(float(tll[0]), _ll(jll), rtol=1e-5)


# ---------------------------------------------------------------------------
# the wrappers' range and the columns pass's tiling

def test_check_kp_takes_multiples_of_32_to_1024():
    """The mixture wrappers' check takes multiples of 32 up to 1024 and
    names the plain step above (tests/test_torch_cuda.py holds the
    wrappers' refusal of 1056 lanes on the card)."""
    for Kp in (32, 64, 96, 128, 160, 224, 512, 1024):
        mb.check_kp(Kp)
        assert mb.is_wide(Kp) == (Kp > 128)
        assert mb.chunks(Kp) == (-(-Kp // 128) if Kp > 128 else 1)
    for Kp in (1056, 2048, 100, 0):
        with pytest.raises(ValueError, match=f"Kp={Kp}.*plain step"):
            mb.check_kp(Kp)


@pytest.mark.parametrize("Kp", [160, 224, 512, 1024])
def test_wide_cols_tile_and_segments(Kp):
    """The wide columns pass takes blocks of 128 loci (one stream) or 64
    (two) on each chunk of live lanes, whatever Kp, in stages of 128 rows;
    its row segments cover I exactly, in whole stages, and with the chunk
    blocks of k_true's lanes counted fit one wave of the card where there
    is more than one segment."""
    from multiclust_tpu_torch.ops.fullstep_bi import GRID_YZ_MAX

    assert mb.cols_stage_rows(Kp) == 128
    for two in (False, True):
        assert mb.cols_tile(Kp, two) == (64 if two else 128)
        assert mb.cols_blocks_per_sm(Kp, two) == 1
        for k_true in (0, Kp - 31, 129):
            for I, L, B in ((1, 17, 1), (16384, 2048, 1), (16384, 2048, 2),
                            (8192, 131072, 2), (131071, 64, 7),
                            (4000, 96, 2)):
                n_seg, seg_rows = mb.cols_segments(I, L, B, Kp, two, 132,
                                                   k_true)
                assert 1 <= n_seg <= GRID_YZ_MAX
                assert seg_rows % mb.cols_stage_rows(Kp) == 0
                assert (n_seg - 1) * seg_rows < I <= n_seg * seg_rows
                blocks = (-(-L // mb.cols_tile(Kp, two)) * B
                          * mb.chunks(Kp, k_true))
                assert n_seg == 1 or n_seg * blocks <= 132


@pytest.mark.parametrize("Kp", [160, 224, 512, 1024])
def test_wide_chunks_count_the_live_tiles(Kp):
    """The wide passes cut the ceil(k_true / 8) live lane tiles into
    ``chunks(Kp, k_true)`` chunks of at most 16 tiles (128 lanes), as
    csrc/mixture_bi.cu's ``wide_chunks`` does; k_true 0 or past Kp takes
    every lane, so ``chunks(Kp)`` is ceil(Kp / 128)."""
    for k_true in range(0, Kp + 2):
        live = k_true if 1 <= k_true <= Kp else Kp
        assert mb.chunks(Kp, k_true) == -(-(-(-live // 8)) // 16)
    assert mb.chunks(Kp) == -(-Kp // 128)
    assert mb.chunks(1024, 130) == 2 and mb.chunks(224, 200) == 2
    assert mb.chunks(128, 100) == 1


def test_kernel_report_names_the_wide_mixture_kernels():
    """``kernel_report.ptxas_lines`` names the mixture's wide kernels: the
    score and columns kernels by their stream flag, the softmax by its
    score pairs a lane, and the eta finish by its lanes a thread."""
    from multiclust_tpu_torch.kernel_report import MIX_WIDE, ptxas_lines

    def entry(mangled, regs):
        return (f"ptxas info    : Function properties for {mangled}\n"
                f"    0 bytes stack frame, 0 bytes spill stores, 0 bytes "
                f"spill loads\nptxas info    : Used {regs} registers, used "
                f"1 barriers\n")

    pre = "_ZN53_GLOBAL__N__3e1c2b7a_13_mixture_bi_cu_9f0d1e2a_31415"
    report = (entry(pre + "20mix_rows_wide_kernelILb1EEEvPKfS2_PKaS4_S2_PdiiiiI",
                    168)
              + entry(pre + "20mix_cols_wide_kernelILb0EEEvPKfPKaS4_PfS5_"
                      "iiiiii", 190)
              + entry(pre + "18mix_softmax_kernelILi16EEvPKdPfS3_iii", 96)
              + entry(pre + "14mix_eta_kernelILi32EEEvPKfPfS2_iiiifi", 80)
              + entry(pre + "14mix_eta_kernelILi2EEEvPKfPfS2_iiiifi", 40))
    names = [name for name, _ in ptxas_lines(report, MIX_WIDE)]
    assert names == ["mix_rows_wide_kernel<true>",
                     "mix_cols_wide_kernel<false>", "mix_softmax_kernel<16>",
                     "mix_eta_kernel<32>", "mix_eta_kernel<2>"]
