"""The port's mixed-K K-sweep (Params.kmask, runtime/ksweep.py) on the CPU.

Chains of several K share one lane layout, each carrying its true lanes
as ``Params.kmask``.  Its model steps are held to the JAX package's kmask
steps on the same inputs (float64 to rtol 1e-12, as tests/test_ksweep.py
holds the JAX step to its static one; float32 against the Pallas kernels
in interpret mode at rtol 2e-5 / atol 1e-5), each chain of a batch of
mixed K to the JAX step of its own K.  Its ``merged`` lattice
(``swept_maximize``) is held to its own static sweep chain for chain, as
tests/test_ksweep.py holds the JAX package's; ``shared`` is the static
serial loop.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multiclust_tpu.model.bucketed as jbk
import multiclust_tpu_torch.model.bucketed as tbk
from multiclust_tpu.model import admixture as jadm, mixture as jmix
from multiclust_tpu.model.common import EMConfig as JaxEMConfig, \
    ModelData as JaxModelData, Params as JaxParams, \
    make_kmask as jax_make_kmask, model_data_from_dataset as jax_md
from multiclust_tpu.ops import df64
from multiclust_tpu.stats.sim import random_model, simulate_admixture_fast
from multiclust_tpu_torch.config import InitMethod, InitProcedure, Options
from multiclust_tpu_torch.convert import dataset_from_counts
from multiclust_tpu_torch.init import random as rinit
from multiclust_tpu_torch.model.common import EMConfig, Params, \
    make_model_data, model_data_from_dataset
from multiclust_tpu_torch.opt import em as em_mod
from multiclust_tpu_torch.runtime import ksweep, multistart as ms

torch.set_num_threads(2)

F64 = dict(rtol=1e-12, atol=1e-14)
F32 = dict(rtol=2e-5, atol=1e-5)


def _dataset(seed, K=3, I=50, L=30, M=2, missing_rate=0.0):
    rng = np.random.default_rng(seed)
    Q, P = random_model(rng, K, L, M, I=I, concentration=0.3)
    return simulate_admixture_fast(rng, Q, P, ploidy=2,
                                   missing_rate=missing_rate)


def _starts(seed, ks, width, L, M, mask, I=None):
    """Random parameters of chains of K = ``ks`` clusters each, padded to
    ``width`` lanes: (eta, p) numpy stacks on the dataset's allele mask,
    and the [B, width] kmask."""
    rng = np.random.default_rng(seed)
    B = len(ks)
    eta = np.zeros((B, width) if I is None else (B, I, width))
    p = np.zeros((B, width, L, M))
    for b, K in enumerate(ks):
        eta[b, ..., :K] = rng.dirichlet(np.ones(K), size=None if I is None
                                        else I)
        pk = rng.dirichlet(np.ones(M), size=(K, L)) * mask[None]
        p[b, :K] = pk / pk.sum(axis=-1, keepdims=True)
    km = (np.arange(width)[None] < np.asarray(ks)[:, None]).astype(float)
    return eta, p, km


def _ll(df):
    return float(df64.df_value(df))


def _jax_step(model, params, md, cfg):
    if model == "mixture":
        out, ll, _, _ = jmix.em_step(params, md, cfg)
    else:
        out, ll, _ = jadm.em_step(params, md, cfg)
    return out, ll


# ---------------------------------------------------------------------------
# kmask steps against the JAX package's kmask steps

@pytest.mark.parametrize("model,M,missing_rate,bi", [
    ("admixture", 3, 0.1, False),
    ("admixture", 2, 0.0, False),
    ("constrained", 3, 0.1, False),
    ("mixture", 2, 0.0, True),        # the single-product biallelic path
    ("mixture", 3, 0.1, False),       # multi-allelic
])
def test_kmask_step_matches_jax_f64(model, M, missing_rate, bi):
    """Four float64 steps of a batch of chains of K = 3, 2 and 5 on 8
    lanes with their [B, 8] kmask: each chain equals the JAX package's
    kmask step of its K (plain XLA), the mask survives every step bit for
    bit, and the lanes outside it stay exactly 0 (eta; p too but in the
    mixture, whose p there is the lb-smoothed row of zero counts, as in
    the JAX step)."""
    ks, Kp = [3, 2, 5], 8
    ds = _dataset(11 + M, K=3, I=40, L=25, M=M, missing_rate=missing_rate)
    admixture = model != "mixture"
    per_i = model == "admixture"
    eta, p, km = _starts(M, ks, Kp, ds.L, ds.M, ds.mask,
                         I=ds.I if per_i else None)
    jmd = jax_md(ds, dtype=jnp.float64).prepare_for_em(bi=bi)
    jcfg = JaxEMConfig(admixture=admixture,
                       eta_constrained=model == "constrained",
                       k_true=Kp if per_i else 0, biallelic=bi,
                       has_missing=missing_rate > 0)
    md = model_data_from_dataset(ds, dtype=torch.float64)
    cfg = EMConfig(admixture=admixture, eta_constrained=model == "constrained",
                   k_true=Kp if per_i else 0, biallelic=bi,
                   has_missing=missing_rate > 0)
    mask = torch.tensor(km)
    params = Params(torch.tensor(eta), torch.tensor(p), mask)
    jps = [JaxParams(jnp.asarray(eta[b]), jnp.asarray(p[b]),
                     jax_make_kmask(K, Kp, jnp.float64))
           for b, K in enumerate(ks)]
    step = jax.jit(lambda q: _jax_step(model, q, jmd, jcfg)[0])
    for _ in range(4):
        new, ll, _ = em_mod.model_em_step(params, md, cfg)
        assert torch.equal(new.kmask, mask)
        for b in range(len(ks)):
            jll = _ll(_jax_step(model, jps[b], jmd, jcfg)[1])
            jps[b] = step(jps[b])
            np.testing.assert_allclose(new.eta[b].numpy(),
                                       np.asarray(jps[b].eta), **F64)
            np.testing.assert_allclose(new.p[b].numpy(),
                                       np.asarray(jps[b].p), **F64)
            assert abs(float(ll[b]) - jll) < 1e-8 * abs(jll)
        off = mask < 0.5
        assert (new.eta.masked_select(
            off.reshape(off.shape[:1] + (1,) * (new.eta.dim() - 2)
                        + off.shape[1:]).expand_as(new.eta)) == 0).all()
        if admixture:
            assert (new.p[off] == 0).all()
        params = new


@pytest.mark.parametrize("route", ["generic", "p0 layout", "mixture"])
def test_kmask_kernel_route_matches_jax_interpret(route):
    """The float32 kernel routes with a [B, Kp] kmask (their plain versions
    on CPU tensors): the generic step and the biallelic p0-layout step
    against the JAX package's kmask steps through its Pallas kernels in
    interpret mode, the biallelic mixture step against the JAX kmask step
    (XLA: its kernels take no mask, model/mixture.py:172), each chain of
    K = 3 or 2 against the JAX step of its K."""
    ks = [3, 2]
    mix = route == "mixture"
    M = 3 if route == "generic" else 2
    ds = _dataset(5, K=3, I=64, L=128, M=M, missing_rate=0.1)
    if M == 2:
        # both slots of every locus valid: the biallelic planes
        ds = dataset_from_counts(ds.counts, ds.miss, ds.ploidy)
    Kp = 8 if mix else 32
    eta, p, km = _starts(7, ks, Kp, ds.L, ds.M, ds.mask,
                         I=None if mix else ds.I)
    f32 = np.float32
    jmd = jax_md(ds, dtype=jnp.float32, storage_dtype=jnp.int8
                 ).prepare_for_em(bi=M == 2)
    jcfg = JaxEMConfig(admixture=not mix, k_true=0 if mix else Kp,
                       biallelic=M == 2,
                       use_pallas="off" if mix else "interpret")
    md = model_data_from_dataset(ds, dtype=torch.float32)
    cfg = EMConfig(admixture=not mix, k_true=0 if mix else Kp,
                   biallelic=M == 2, use_pallas="on")
    jeta, jp = eta.astype(f32), p.astype(f32)
    tp = torch.tensor(p[..., 0] if route == "p0 layout" else p,
                      dtype=torch.float32)
    if route == "p0 layout":
        jp = jp[..., 0]
        assert cfg.bi_repr_active
    params = Params(torch.tensor(eta, dtype=torch.float32), tp,
                    torch.tensor(km, dtype=torch.float32))
    new, ll, _ = em_mod.model_em_step(params, md, cfg)
    assert torch.equal(new.kmask, params.kmask)
    for b, K in enumerate(ks):
        jq = JaxParams(jnp.asarray(jeta[b]), jnp.asarray(jp[b]),
                       jax_make_kmask(K, Kp, jnp.float32))
        jout, jll = _jax_step("mixture" if mix else "admixture", jq, jmd,
                              jcfg)
        jll = _ll(jll)
        np.testing.assert_allclose(new.eta[b].numpy(),
                                   np.asarray(jout.eta), **F32)
        np.testing.assert_allclose(new.p[b].numpy(), np.asarray(jout.p),
                                   **F32)
        assert abs(float(ll[b]) - jll) < 2e-6 * abs(jll)
        assert (new.eta[b, ..., K:] == 0).all()
        if not mix:
            assert (new.p[b, K:] == 0).all()


def test_kmask_bucketed_step_matches_jax():
    """The float64 bucketed (jagged-M) admixture step of a chain carrying
    its kmask: the mask rides the tuple p, and the step equals the JAX
    package's bucketed kmask step."""
    rng = np.random.default_rng(9)
    I, L, K, Kp = 40, 100, 3, 8
    Ml = np.where(rng.random(L) < 0.8, 2, 8)
    mask = np.arange(8)[None] < Ml[:, None]
    miss = rng.binomial(2, 0.1, size=(I, L))
    q = np.broadcast_to(mask / Ml[:, None], (I, L, 8))
    counts = np.stack([rng.multinomial(2 - miss[i, l], q[i, l])
                       for i in range(I) for l in range(L)]).reshape(
        I, L, 8)
    eta, p, km = _starts(10, [K], Kp, L, 8, mask, I=I)
    jplan = jbk.plan_buckets(Ml, 8, min_bucket=4, tight=True)
    jbd = jax.jit(lambda m: jbk.bucketize_model_data(m, jplan))(
        JaxModelData(x=jnp.asarray(counts, jnp.float64),
                     miss=jnp.asarray(miss, jnp.float64),
                     mask=jnp.asarray(mask), n_alleles=jnp.asarray(Ml)))
    jcfg = JaxEMConfig(admixture=True, k_true=Kp)
    jq = jbk.split_params_like(JaxParams(
        jnp.asarray(eta[0]), jnp.asarray(p[0]),
        jax_make_kmask(K, Kp, jnp.float64)), jbd)
    jout, jll, _ = jax.jit(lambda q: jadm._em_step_bucketed(q, jbd, jcfg))(jq)
    assert jout.kmask is not None
    md = make_model_data(counts, miss, mask, Ml, dtype=torch.float64,
                         device="cpu")
    bd = tbk.bucketize_model_data(md, tbk.plan_buckets(Ml, 8, min_bucket=4))
    cfg = EMConfig(admixture=True, k_true=Kp)
    params = Params(torch.tensor(eta), torch.tensor(p), torch.tensor(km))
    out, ll, _ = em_mod.model_em_step(params, bd, cfg)
    assert isinstance(out.p, tuple) and torch.equal(out.kmask, params.kmask)
    got = tbk.merge_params_like(out, bd)
    np.testing.assert_allclose(
        got.p[0].numpy(), np.asarray(jbk.merge_params_like(jout, jbd, 8).p),
        **F64)
    np.testing.assert_allclose(out.eta[0].numpy(), np.asarray(jout.eta),
                               **F64)
    assert abs(float(ll[0]) - _ll(jll)) < 1e-8 * abs(_ll(jll))
    assert (got.p[0, K:] == 0).all() and (out.eta[..., K:] == 0).all()
    # the projection of an accelerated point keeps the tuple and the lanes
    proj = em_mod._project_params(out, bd, cfg)
    assert torch.equal(proj.kmask, params.kmask)
    assert all((pb[0, K:] == 0).all() for pb in proj.p)


def test_squarem_point_keeps_the_mask_bit_for_bit():
    """A SQUAREM and a QN1 point from secant pairs of two kmask steps keep
    the base point's mask bit for bit, at a finite step size and at a
    NaN one; a secant difference of the mask is exactly 0."""
    ks, Kp = [3, 2], 8
    ds = _dataset(3, I=30, L=20, M=3, missing_rate=0.1)
    md = model_data_from_dataset(ds, dtype=torch.float64)
    cfg = EMConfig(admixture=True, k_true=Kp)
    eta, p, km = _starts(4, ks, Kp, ds.L, ds.M, ds.mask, I=ds.I)
    x0 = Params(torch.tensor(eta), torch.tensor(p), torch.tensor(km))
    x1 = em_mod.model_em_step(x0, md, cfg)[0]
    x2 = em_mod.model_em_step(x1, md, cfg)[0]
    u, v = em_mod.tree_sub(x1, x0), em_mod.tree_sub(x2, x1)
    assert not u.kmask.any() and not v.kmask.any()
    for s in (torch.tensor([-1.7, -3.0], dtype=torch.float64),
              torch.tensor([float("nan"), -2.0], dtype=torch.float64)):
        for point in (em_mod.squarem_point, em_mod.qn1_point):
            xt = point(x0, u, v, s)
            assert torch.equal(xt.kmask, x0.kmask)
            proj = em_mod._project_params(xt, md, cfg)
            assert torch.equal(proj.kmask, x0.kmask)
            assert (proj.eta[1, :, 2:] == 0).all()
            assert (proj.p[1, 2:] == 0).all()


# ---------------------------------------------------------------------------
# the dynamic-K starts

@pytest.mark.parametrize("admixture,procedure", [
    (True, InitProcedure.NOTHING), (True, InitProcedure.RAND_EM),
    (False, InitProcedure.NOTHING), (False, InitProcedure.RAND_EM)])
def test_dynamic_starts_are_the_static_ones_padded(admixture, procedure):
    """``initialize_dyn`` draws the static start of the same generator,
    draw for draw, pads it to the lattice's lanes and gives it its kmask;
    Rand-EM, scoring through the masked step of the lattice's config,
    keeps the same winner."""
    ds = _dataset(6, I=40, L=30, M=2)
    md = model_data_from_dataset(ds, dtype=torch.float64)
    K, width = 3, 7
    kw = dict(method=InitMethod.RANDOM_CENTERS, procedure=procedure,
              n_rand_em_init=4)
    static = rinit.initialize(torch.Generator().manual_seed(5), md, K,
                              EMConfig(admixture=admixture,
                                       k_true=K if admixture else 0), **kw)
    dyn = rinit.initialize_dyn(torch.Generator().manual_seed(5), md, K,
                               width, EMConfig(admixture=admixture,
                                               k_true=width if admixture
                                               else 0), **kw)
    assert torch.equal(dyn.eta[..., :K], static.eta)
    assert torch.equal(dyn.p[:K], static.p)
    assert not dyn.eta[..., K:].any() and not dyn.p[K:].any()
    assert torch.equal(dyn.kmask, (torch.arange(width) < K).double())


# ---------------------------------------------------------------------------
# merged and shared sweeps against the static sweep

def _sweep(ds, md, opt, seed, mode, monkeypatch):
    """estimate_model's per-K results under MULTICLUST_SWEEP_MODE=mode,
    with the sweep's device gate opened on the CPU."""
    monkeypatch.setenv("MULTICLUST_SWEEP_MODE", mode)
    monkeypatch.setattr(ms, "sweep_device", lambda md: True)
    return ksweep.estimate_model(
        seed, md, opt, lambda K: ds.n_parameters(
            K, opt.admixture, opt.eta_constrained)).per_K


def _check(got, want, rtol):
    for K in want:
        g, w = got[K], want[K]
        assert g.n_launched == w.n_launched and g.n_init == w.n_init
        np.testing.assert_allclose(g.max_logL, w.max_logL, rtol=rtol)
        np.testing.assert_allclose(g.aic, w.aic, rtol=rtol)
        np.testing.assert_allclose(g.bic, w.bic, rtol=rtol)
        assert g.best_params.kmask is None
        assert g.best_params.p.shape == w.best_params.p.shape
        assert g.best_params.eta.shape == w.best_params.eta.shape


@pytest.mark.parametrize("mode", ["merged", "shared"])
@pytest.mark.parametrize("case", ["admixture", "accel 1", "accel 4",
                                  "mixture", "constrained", "jagged",
                                  "float32 kernels"])
def test_sweep_matches_static(mode, case, monkeypatch):
    """The merged lattice and the shared mode (the serial loop) give each
    K the static sweep's n_launched, n_init, max_logL, AIC and BIC (rtol 1e-9
    with plain EM in float64, 1e-5 accelerated, as tests/test_ksweep.py
    holds the JAX package's; 1e-6 for float32 through the kernels' plain
    versions, the p0 layout), and harvest dense parameters with no
    kmask."""
    M = 6 if case == "jagged" else 3 if case == "constrained" else 2
    ds = _dataset(21 + M, K=3, I=48, L=40 if case == "jagged" else 30,
                  M=M)
    f32 = case == "float32 kernels"
    md = model_data_from_dataset(
        ds, dtype=torch.float32 if f32 else torch.float64)
    accel = int(case[-1]) if case.startswith("accel") else 0
    opt = Options(admixture=case != "mixture",
                  eta_constrained=case == "constrained", min_K=2,
                  max_K=3 if case == "jagged" else 4, n_init=3,
                  accel_scheme=accel, dtype="float32" if f32 else "float64",
                  use_pallas=True if f32 else None, max_iter=250,
                  n_rand_em_init=2 if case == "jagged" else 1,
                  initialization_procedure=(InitProcedure.RAND_EM
                                            if case == "jagged"
                                            else InitProcedure.NOTHING),
                  write_files=False).synchronize(ds.I, ds.ploidy)
    want = _sweep(ds, md, opt, 7, "static", monkeypatch)
    got = _sweep(ds, md, opt, 7, mode, monkeypatch)
    _check(got, want, 1e-6 if f32 else 1e-5 if accel else 1e-9)


def test_merged_lattice_is_one_batch(monkeypatch):
    """The merged sweep runs every K's chains in one batch: each model
    step of the lattice holds all K's chains, with their masks."""
    ds = _dataset(31, I=40, L=20)
    md = model_data_from_dataset(ds, dtype=torch.float64)
    opt = Options(admixture=True, min_K=2, max_K=4, n_init=2, max_iter=30,
                  write_files=False).synchronize(ds.I, 2)
    widths = []
    orig = em_mod.model_em_step

    def spy(params, *a, **k):
        if params.kmask is not None:
            widths.append(tuple(params.kmask.sum(dim=-1).tolist()))
        return orig(params, *a, **k)
    monkeypatch.setattr(em_mod, "model_em_step", spy)
    _sweep(ds, md, opt, 3, "merged", monkeypatch)
    assert (2.0, 2.0, 3.0, 3.0, 4.0, 4.0) in widths


def test_auto_and_static_are_the_serial_loop(monkeypatch):
    """``auto`` (the default), ``static`` and ``shared`` run the serial
    loop with static K and no kmask, bit for bit, even where the merged
    lattice is allowed; an unknown mode is refused."""
    ds = _dataset(41, I=40, L=20)
    md = model_data_from_dataset(ds, dtype=torch.float64)
    opt = Options(admixture=True, min_K=2, max_K=3, n_init=2, max_iter=100,
                  write_files=False).synchronize(ds.I, 2)
    seen = []
    orig = em_mod.model_em_step

    def spy(params, *a, **k):
        seen.append(params.kmask is None)
        return orig(params, *a, **k)
    monkeypatch.setattr(em_mod, "model_em_step", spy)
    monkeypatch.setattr(ksweep, "swept_maximize", None)
    auto = _sweep(ds, md, opt, 5, "auto", monkeypatch)
    for mode in ("static", "shared"):
        other = _sweep(ds, md, opt, 5, mode, monkeypatch)
        for K in auto:
            assert auto[K].max_logL == other[K].max_logL
            assert auto[K].n_iter_all == other[K].n_iter_all
            assert torch.equal(auto[K].best_params.p,
                               other[K].best_params.p)
    assert seen and all(seen)
    monkeypatch.setenv("MULTICLUST_SWEEP_MODE", "swept")
    with pytest.raises(ValueError, match="MULTICLUST_SWEEP_MODE"):
        ksweep.estimate_model(5, md, opt, lambda K: 1)


def test_warm_and_checkpoint_keep_the_serial_loop(monkeypatch, tmp_path):
    """A warm start or a checkpoint keeps a ``merged`` or ``shared`` sweep
    on the static serial loop, as in the JAX package: one serial fit per
    K."""
    ds = _dataset(42, I=30, L=20)
    md = model_data_from_dataset(ds, dtype=torch.float64)
    opt = Options(admixture=True, min_K=2, max_K=3, n_init=2, max_iter=50,
                  write_files=False).synchronize(ds.I, 2)
    seen = []
    orig = ms.maximize_likelihood
    monkeypatch.setattr(ksweep, "maximize_likelihood",
                        lambda gen, md, K, *a, **k: seen.append(K)
                        or orig(gen, md, K, *a, **k))
    monkeypatch.setattr(ksweep, "swept_maximize", None)
    monkeypatch.setattr(ms, "sweep_device", lambda md: True)
    for mode in ("merged", "shared"):
        monkeypatch.setenv("MULTICLUST_SWEEP_MODE", mode)
        ksweep.estimate_model(5, md, opt, lambda K: 1,
                              checkpoint_dir=str(tmp_path / mode))
    assert seen == [2, 3, 2, 3]


def _gate_opt(**kw):
    base = dict(admixture=True, min_K=2, max_K=5, n_init=4)
    base.update(kw)
    return Options(**base).synchronize(100, 2)


class _FakeMD:
    def __init__(self, device="cuda", I=100, L=50, M=2):
        self.device = torch.device(device)
        self.I, self.L, self.M = I, L, M


@pytest.mark.parametrize("case,kw,ks,md,want", [
    ("eligible", {}, [2, 3, 4, 5], _FakeMD(), True),
    ("one K >= 2", {}, [1, 2], _FakeMD(), False),
    ("target logL", dict(target_ll=True, desired_ll=-1.0), [2, 3],
     _FakeMD(), False),
    ("revisit", dict(target_revisit=2), [2, 3], _FakeMD(), False),
    ("wall clock", dict(n_seconds=60.0), [2, 3], _FakeMD(), False),
    ("verbosity", dict(verbosity=4), [2, 3], _FakeMD(), False),
    ("mesh", dict(mesh_shape=(2, 1)), [2, 3], _FakeMD(), False),
    ("CPU", {}, [2, 3], _FakeMD("cpu"), False),
    ("two lane counts", {}, [2, 40], _FakeMD(), False),
    ("one lane count", {}, [33, 64], _FakeMD(), True),
    ("state budget", {}, [2, 3], _FakeMD(I=10 ** 7), False),
    ("budget with SQUAREM", dict(accel_scheme=1, q=1), [2, 3],
     _FakeMD(I=1_200_000), False),
    ("within budget", {}, [2, 3], _FakeMD(I=1_200_000), True),
])
def test_swept_eligible_gate(case, kw, ks, md, want):
    """``swept_eligible``, condition by condition against the JAX gate
    (multistart.py:918-949), with the CUDA fit device for the JAX
    package's accelerator."""
    assert ms.swept_eligible(_gate_opt(**kw), md, ks) is want, case
