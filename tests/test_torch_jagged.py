"""The port's jagged-M locus bucketing (model/bucketed.py) against the JAX
package on the CPU, on mixed panels of SNP (M = 2) and microsatellite
(M = 8) loci, interleaved, the size of tests/test_jagged.py's.

The plan, the bucketed data and the parameter split are held to the JAX
package's; one bucketed EM step to the JAX bucketed step and to the port's
dense step (float64, step for step), the float32 kernel route (its plain
versions on CPU tensors) to the JAX chained and fused kernels in interpret
mode, and a warm-start fit to the JAX bucketed fit.  Fits through the
engine, the bootstrap and the CLI are held to the same runs with the
dense layout forced, as tests/test_jagged.py forces it: by patching
``worth_bucketing`` on the module.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multiclust_tpu.model.bucketed as jbk
import multiclust_tpu_torch.model.bucketed as tbk
from multiclust_tpu.config import Options as JaxOptions
from multiclust_tpu.model import admixture as jadm, mixture as jmix
from multiclust_tpu.model.common import EMConfig as JaxEMConfig, \
    ModelData as JaxModelData, Params as JaxParams, \
    collapse_for_constrained as jax_collapse, pad_params_k as jax_pad_k
from multiclust_tpu.ops import df64
from multiclust_tpu.runtime import checkpoint as jax_ckpt
from multiclust_tpu.runtime.multistart import \
    maximize_likelihood as jax_maximize
from multiclust_tpu_torch.api import fit_dataset
from multiclust_tpu_torch.config import Options
from multiclust_tpu_torch.convert import dataset_from_counts, options_from
from multiclust_tpu_torch.io.writers import write_data
from multiclust_tpu_torch.model import admixture as tadm, mixture as tmix
from multiclust_tpu_torch.model.common import EMConfig, Params, \
    collapse_for_constrained, k_padded_size, make_model_data, pad_params_k
from multiclust_tpu_torch.runtime.multistart import maximize_likelihood
from multiclust_tpu_torch.stats import bootstrap as bs

torch.set_num_threads(2)

K = 3
# float64, the port's step against the JAX step and its own dense step
F64 = dict(rtol=0, atol=1e-10)
# float32 against the interpret-mode kernels, whose reciprocal is an
# approximate one plus a Newton step (kernels.py:145-151)
INTERPRET = dict(rtol=2e-4, atol=1e-5)
# engine, bootstrap: bucketed against dense-forced fits
FIT_ATOL = 1e-6


def _panel(seed, I=40, L=100, missing=0.1, conc=None):
    """An interleaved mixed panel: ~80 % M = 2 loci, the rest M = 8, and
    K = 3 parameters on its mask.  ``conc`` (Dirichlet concentrations of
    eta and p) draws the counts from those parameters, a panel with
    structure; None draws every copy's allele uniformly, as
    tests/test_jagged.py's make_mixed_panel does.  Returns counts, miss,
    mask, n_alleles, eta [I, K] and p [K, L, M]."""
    rng = np.random.default_rng(seed)
    Ml = np.where(rng.random(L) < 0.8, 2, 8)
    M = int(Ml.max())
    mask = np.arange(M)[None] < Ml[:, None]
    miss = rng.binomial(2, missing, size=(I, L))
    a_eta, a_p = conc or (2.0, 1.0)
    eta = rng.dirichlet(np.full(K, a_eta), size=I)
    p = rng.gamma(a_p, size=(K, L, M)) * mask
    p /= p.sum(axis=2, keepdims=True)
    if conc is None:
        q = np.broadcast_to(mask / Ml[:, None], (I, L, M))
    else:
        q = np.einsum("ik,klm->ilm", eta, p)
    counts = np.stack([rng.multinomial(2 - miss[i, l], q[i, l])
                       for i in range(I) for l in range(L)])
    return counts.reshape(I, L, M), miss, mask, Ml, eta, p


def _jax_md(counts, miss, mask, Ml, dtype=jnp.float64):
    return JaxModelData(x=jnp.asarray(counts, dtype),
                        miss=jnp.asarray(miss, dtype),
                        mask=jnp.asarray(mask), n_alleles=jnp.asarray(Ml))


def _port_md(counts, miss, mask, Ml, dtype=torch.float64, storage=None):
    return make_model_data(counts, miss, mask, Ml, dtype=dtype, device="cpu",
                           storage_dtype=storage)


def _ll(df):
    return float(df64.df_value(df))


def _jit(fn, *args):
    """``fn(*args)`` compiled once: eager JAX compiles op by op, several
    times slower on these shapes."""
    return jax.jit(fn)(*args)


def _jax_bucketize(md, plan):
    return _jit(lambda m: jbk.bucketize_model_data(m, plan), md)


# a vector that hits the 8-bucket cap: 19 runs of 70 loci, M = 2 .. 20
CAPPED = np.repeat(np.arange(2, 21), 70)


@pytest.mark.parametrize("name,Ml,kw", [
    ("80/20 mix", np.where(np.random.default_rng(3).random(100) < 0.8, 2, 8),
     {}),
    ("80/20 mix, small buckets",
     np.where(np.random.default_rng(3).random(100) < 0.8, 2, 8),
     dict(min_bucket=4)),
    ("tiny runs merge upward", np.array([2] * 100 + [4] * 70 + [8] * 3
                                        + [12] * 2), dict(min_bucket=16)),
    ("8-bucket cap", np.random.default_rng(4).permutation(CAPPED), {}),
    ("microsatellites 2..40",
     np.random.default_rng(5).integers(2, 41, size=2048), {}),
    ("uniform", np.full(50, 8), {}),
    ("one M=2 run under 64 loci", np.array([2] * 48 + [8] * 12), {}),
])
def test_plan_matches_jax(name, Ml, kw):
    """plan_buckets equals the JAX tight plan (order, inverse, ranges,
    ceilings) or is None with it; jagged_savings and worth_bucketing
    agree."""
    j = jbk.plan_buckets(Ml, int(Ml.max()), tight=True, **kw)
    t = tbk.plan_buckets(Ml, int(Ml.max()), **kw)
    assert (j is None) == (t is None), name
    assert tbk.jagged_savings(Ml) == jbk.jagged_savings(Ml)
    assert tbk.worth_bucketing(Ml) == jbk.worth_bucketing(Ml)
    if t is None:
        return
    np.testing.assert_array_equal(t.order, j.order)
    np.testing.assert_array_equal(t.inv_order, j.inv_order)
    assert t.ranges == j.ranges and t.Ms == j.Ms and t.M_full == j.M_full
    assert t.Ls == j.pad_Ls
    assert t.lanes == sum(L_b * M_b for L_b, M_b in zip(t.Ls, t.Ms))
    if name == "8-bucket cap":
        assert t.n_buckets == 8


@pytest.mark.parametrize("missing", [0.0, 0.1])
def test_bucketize_split_merge_match_jax(missing):
    """bucketize_model_data and split_params_like give the JAX package's
    buckets and parts; merge after split is the identity, with exact zeros
    off the mask."""
    counts, miss, mask, Ml, eta, p = _panel(1, missing=missing)
    plan = tbk.plan_buckets(Ml, 8, min_bucket=4)
    jbd = _jax_bucketize(_jax_md(counts, miss, mask, Ml),
                         jbk.plan_buckets(Ml, 8, min_bucket=4, tight=True))
    bd = tbk.bucketize_model_data(_port_md(counts, miss, mask, Ml), plan)
    assert bd.I == 40 and bd.L == 100 and bd.M == 8
    np.testing.assert_array_equal(bd.perm.numpy(), np.asarray(jbd.perm))
    np.testing.assert_array_equal(bd.inv.numpy(), np.asarray(jbd.inv))
    for b, jb in zip(bd.buckets, jbd.buckets):
        for f in ("x", "miss", "mask", "n_alleles"):
            np.testing.assert_array_equal(getattr(b, f).numpy(),
                                          np.asarray(getattr(jb, f)), f)
        assert b.x.is_contiguous() and b.x_lanes.shape == (40, b.L * b.M)
    pb = np.stack([p, p[::-1]])                       # a batch of two
    parts = tbk.split_params_like(Params(torch.tensor(eta),
                                         torch.tensor(pb)), bd).p
    jparts = jbk.split_params_like(JaxParams(jnp.asarray(eta),
                                             jnp.asarray(pb)), jbd).p
    for t, j, b in zip(parts, jparts, bd.buckets):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        assert (t[..., ~b.mask] == 0).all()
    back = tbk.merge_params_like(Params(torch.tensor(eta), parts), bd).p
    np.testing.assert_array_equal(back.numpy(), pb)


@pytest.mark.parametrize("missing", [0.0, 0.15])
def test_float64_step_matches_jax_and_dense(missing):
    """One float64 bucketed admixture step equals the JAX
    ``_em_step_bucketed`` (XLA) and the port's dense step, and so does the
    bucketed logL."""
    counts, miss, mask, Ml, eta, p = _panel(2, missing=missing)
    jplan = jbk.plan_buckets(Ml, 8, min_bucket=4, tight=True)
    jbd = _jax_bucketize(_jax_md(counts, miss, mask, Ml), jplan)
    jcfg = JaxEMConfig(admixture=True, has_missing=missing > 0)
    jout, jll, _ = _jit(lambda q: jadm._em_step_bucketed(q, jbd, jcfg),
                        JaxParams(jnp.asarray(eta), jnp.asarray(p)))
    jp = np.asarray(jbk.merge_params_like(jout, jbd, 8).p)

    md = _port_md(counts, miss, mask, Ml)
    bd = tbk.bucketize_model_data(md, tbk.plan_buckets(Ml, 8, min_bucket=4))
    cfg = EMConfig(admixture=True, has_missing=missing > 0)
    params = Params(torch.tensor(eta)[None], torch.tensor(p)[None])
    out, ll, scale = tadm.em_step(params, bd, cfg)
    dense, dll, _ = tadm.em_step(params, md, cfg)
    got = tbk.merge_params_like(out, bd).p[0].numpy()
    np.testing.assert_allclose(got, jp, **F64)
    np.testing.assert_allclose(out.eta[0].numpy(), np.asarray(jout.eta),
                               **F64)
    np.testing.assert_allclose(got, dense.p[0].numpy(), **F64)
    np.testing.assert_allclose(out.eta.numpy(), dense.eta.numpy(), **F64)
    assert abs(float(ll[0]) - _ll(jll)) < 1e-8
    assert abs(float(ll[0]) - float(dll[0])) < 1e-8
    lb, _ = tadm.log_likelihood_bucketed(params, bd, cfg)
    assert abs(float(lb[0]) - float(dll[0])) < 1e-8


@pytest.mark.parametrize("jax_path", ["chain", "fused"])
def test_float32_kernel_route_matches_jax_interpret(jax_path):
    """The float32 kernel route (the rows passes chained through a0, each
    bucket's columns pass and p epilogue: their plain versions on CPU
    tensors) against the JAX package's chained (aligned plan) and fused
    (tight plan) bucketed kernels in interpret mode, run as
    tests/test_jagged.py:135-210 runs them, on K-padded int8 data."""
    counts, miss, mask, Ml, eta, p = _panel(3, I=64, missing=0.1)
    md8 = _jax_md(counts, miss, mask, Ml, jnp.int8)
    jplan = jbk.plan_buckets(Ml, 8, min_bucket=4, tight=jax_path == "fused")
    jbd = _jit(lambda m: jbk.bucketize_model_data(m, jplan).prepare_for_em(),
               md8)
    jcfg = JaxEMConfig(admixture=True, has_missing=True,
                       use_pallas="interpret", k_true=K)
    jpad = jbk.split_params_like(jax_pad_k(JaxParams(
        jnp.asarray(eta, jnp.float32), jnp.asarray(p, jnp.float32)),
        k_padded_size(K, 32)), jbd)
    fn = (jadm._bucketed_fullstep_chain if jax_path == "chain"
          else jadm._bucketed_fullstep_fused)
    jout = _jit(lambda q: fn(q, jbd, jcfg, True), jpad)
    assert jout is not None          # the kernel path engaged
    jparams, jll, _ = jout
    jp = np.asarray(jbk.merge_params_like(jparams, jbd, 8).p)[:K]

    md = _port_md(counts, miss, mask, Ml, torch.float32, torch.int8)
    bd = tbk.bucketize_model_data(md, tbk.plan_buckets(Ml, 8, min_bucket=4))
    assert bd.buckets[0].x.dtype == torch.int8
    cfg = EMConfig(admixture=True, has_missing=True, use_pallas="on",
                   k_true=K)
    params = pad_params_k(Params(torch.tensor(eta, dtype=torch.float32)[None],
                                 torch.tensor(p, dtype=torch.float32)[None]),
                          k_padded_size(K, 32))
    out, ll, _ = tadm.em_step(params, bd, cfg)
    got = tbk.merge_params_like(out, bd).p[0]
    np.testing.assert_allclose(got[:K].numpy(), jp, **INTERPRET)
    np.testing.assert_allclose(out.eta[0, :, :K].numpy(),
                               np.asarray(jparams.eta)[:, :K], **INTERPRET)
    assert (got[K:] == 0).all() and (out.eta[..., K:] == 0).all()
    # logL of about -9.5e3: float32 terms summed in other orders
    assert abs(float(ll[0]) - _ll(jll)) < 2e-4 * abs(_ll(jll))


@pytest.mark.parametrize("model", ["mixture", "constrained"])
def test_mixture_and_constrained_steps_match_jax(model):
    """The bucketed mixture step (scores summed over the buckets) and the
    constrained step (on the collapsed column sums) and both logLs equal
    the JAX package's bucketed ones, and the port's dense steps."""
    counts, miss, mask, Ml, _, p = _panel(4, missing=0.1)
    eta = np.random.default_rng(5).dirichlet(np.full(K, 2.0))
    jplan = jbk.plan_buckets(Ml, 8, min_bucket=4, tight=True)
    plan = tbk.plan_buckets(Ml, 8, min_bucket=4)
    jmd = _jax_md(counts, miss, mask, Ml)
    md = _port_md(counts, miss, mask, Ml)
    jparams = JaxParams(jnp.asarray(eta), jnp.asarray(p))
    params = Params(torch.tensor(eta)[None], torch.tensor(p)[None])
    if model == "mixture":
        jbd = _jax_bucketize(jmd, jplan)
        jcfg = JaxEMConfig(admixture=False, has_missing=True)
        jout, jll, _, _ = _jit(lambda q: jmix.em_step(q, jbd, jcfg),
                               jparams)
        jll2, _ = _jit(lambda q: jmix.log_likelihood_bucketed(q, jbd),
                       jparams)
        cfg = EMConfig(admixture=False, has_missing=True)
        step, dense_md = tmix.em_step, md
        bd = tbk.bucketize_model_data(md, plan)
        ll2, _ = tmix.log_likelihood(params, bd, cfg)
    else:
        jbd = _jax_bucketize(jax_collapse(jmd), jplan)
        jcfg = JaxEMConfig(admixture=True, eta_constrained=True,
                           has_missing=True)
        jout, jll, _ = _jit(lambda q: jadm.em_step(q, jbd, jcfg), jparams)
        jll2, _ = _jit(lambda q: jadm.log_likelihood_bucketed(q, jbd),
                       jparams)
        cfg = EMConfig(admixture=True, eta_constrained=True,
                       has_missing=True)
        step, dense_md = tadm.em_step, collapse_for_constrained(md)
        bd = tbk.bucketize_model_data(dense_md, plan)
        ll2, _ = tadm.log_likelihood_bucketed(params, bd, cfg)
    out, ll, _ = step(params, bd, cfg)
    dense, dll, _ = step(params, dense_md, cfg)
    got = tbk.merge_params_like(out, bd).p[0].numpy()
    jp = np.asarray(jbk.merge_params_like(jout, jbd, 8).p)
    np.testing.assert_allclose(got, jp, **F64)
    np.testing.assert_allclose(out.eta[0].numpy(), np.asarray(jout.eta),
                               **F64)
    np.testing.assert_allclose(got, dense.p[0].numpy(), **F64)
    for value in (float(ll[0]), float(ll2[0]), _ll(jll2)):
        assert abs(value - _ll(jll)) < 1e-8
        assert abs(value - float(dll[0])) < 1e-8


def _structured_ds(seed, I=40, L=100):
    """A mixed panel drawn from sharp K = 3 parameters, whose fits from
    every start reach one optimum: SQUAREM, the only chaotic part of a
    fit, then converges to it from either layout (a bucketed and a dense
    trajectory part at rounding, ~1e-16, and the gap grows by ~10x every
    five macro steps on a panel without structure)."""
    counts, miss, _, Ml, _, _ = _panel(seed, I=I, L=L, missing=0.05,
                                       conc=(0.2, 0.3))
    return dataset_from_counts(counts, miss, 2, n_alleles=Ml)


def _dense_forced(monkeypatch, fn):
    """``fn()`` with the dense layout forced, as tests/test_jagged.py
    forces it on the JAX side."""
    with monkeypatch.context() as m:
        m.setattr(tbk, "worth_bucketing", lambda *a, **k: False)
        return fn()


# a tight convergence test: two SQUAREM trajectories that stop at logL
# 1e-9 apart may still differ in p by ~7e-6 (flat directions at the
# optimum); at 1e-11 by ~5e-8
FIT = dict(min_K=K, max_K=K, n_init=2, batch_chains=2, dtype="float64",
           n_rand_em_init=2, verbosity=0, write_files=False, seed=5,
           abs_error=1e-11)


@pytest.mark.parametrize("label,kw", [
    ("admixture plain EM", dict(admixture=True, max_iter=400)),
    ("admixture SQUAREM", dict(admixture=True, accel_scheme=1,
                               adjust_step=2)),
    ("mixture", dict(admixture=False)),
    ("-a -c", dict(admixture=True, eta_constrained=True)),
])
def test_engine_fit_matches_dense_forced(monkeypatch, label, kw):
    """api.fit_dataset buckets a jagged panel for every model type and
    returns the dense-forced run's logL and dense original-order p, exact
    zeros off the mask."""
    ds = _structured_ds(6)
    opts = {**FIT, **kw}
    b = fit_dataset(ds, device="cpu", **opts).estimate.last
    d = _dense_forced(monkeypatch, lambda: fit_dataset(
        ds, device="cpu", **opts)).estimate.last
    assert b.buckets.startswith("2 buckets, M_b [2, 8]"), b.buckets
    assert not d.buckets
    assert b.best_params.p.shape == d.best_params.p.shape == (K, ds.L, 8)
    assert abs(b.max_logL - d.max_logL) < FIT_ATOL, (b.max_logL, d.max_logL)
    np.testing.assert_allclose(b.best_params.p.numpy(),
                               d.best_params.p.numpy(), rtol=0,
                               atol=FIT_ATOL)
    assert (b.best_params.p[:, ~torch.as_tensor(ds.mask)] == 0).all()


def test_warm_start_fit_matches_jax():
    """A float64 bucketed fit from parameters drawn on the JAX side: step
    for step against the JAX bucketed step (40 plain EM steps), and as a
    warm-start fit against the JAX fit from the same parameters, in logL
    and iteration count.  The JAX fit runs dense: its engine cannot start
    a bucketed fit (its ``init_state`` reads ``params.p.dtype``, a tuple
    there; ROADMAP.md queue 3)."""
    counts, miss, mask, Ml, eta, p = _panel(7, missing=0.1,
                                            conc=(0.5, 0.5))
    jmd = _jax_md(counts, miss, mask, Ml)
    jbd = _jax_bucketize(jmd, jbk.plan_buckets(Ml, 8, tight=True))
    jcfg = JaxEMConfig(admixture=True, has_missing=True)
    jstep = jax.jit(lambda q: jadm._em_step_bucketed(q, jbd, jcfg))
    md = _port_md(counts, miss, mask, Ml)
    bd = tbk.bucketize_model_data(md, tbk.plan_for(md))
    cfg = EMConfig(admixture=True, has_missing=True)
    jq = jbk.split_params_like(JaxParams(jnp.asarray(eta), jnp.asarray(p)),
                               jbd)
    q = Params(torch.tensor(eta)[None], torch.tensor(p)[None])
    for _ in range(40):
        jq, jll, _ = jstep(jq)
        q, ll, _ = tadm.em_step(q, bd, cfg)
        assert abs(float(ll[0]) - _ll(jll)) < 1e-8
    np.testing.assert_allclose(tbk.merge_params_like(q, bd).p[0].numpy(),
                               np.asarray(jbk.merge_params_like(jq, jbd,
                                                                8).p),
                               **F64)

    jopt = JaxOptions(admixture=True, min_K=K, max_K=K, n_init=1,
                      dtype="float64").synchronize(md.I, 2)
    orig = jbk.worth_bucketing
    jbk.worth_bucketing = lambda *a, **k: False
    try:
        jres = jax_maximize(jax.random.PRNGKey(0), jmd, K, jopt, 50,
                            warm=JaxParams(jnp.asarray(eta),
                                           jnp.asarray(p)))
    finally:
        jbk.worth_bucketing = orig
    res = maximize_likelihood(
        torch.Generator().manual_seed(0), md, K, options_from(jopt), 50,
        warm=Params(torch.tensor(eta), torch.tensor(p)))
    assert res.buckets
    assert res.n_total_iter == jres.n_total_iter > 40
    assert abs(res.max_logL - jres.max_logL) < 1e-8
    np.testing.assert_allclose(res.best_params.p.numpy(),
                               np.asarray(jres.best_params.p), rtol=0,
                               atol=1e-8)


@pytest.mark.parametrize("admixture", [True, False])
def test_batched_bootstrap_matches_dense_forced(monkeypatch, admixture):
    """The batched bootstrap's replicate lattices run bucketed by the
    panel's plan and give the dense-forced run's test statistics."""
    counts, miss, _, Ml, eta, p = _panel(8, missing=0.1, conc=(0.5, 0.5))
    md = _port_md(counts, miss, np.arange(8)[None] < Ml[:, None], Ml)
    opt = Options(admixture=admixture, n_init=1, min_K=2, max_K=3,
                  n_bootstrap=2, dtype="float64", max_iter=150,
                  n_rand_em_init=2).synchronize(md.I, 2)
    h0_eta = eta[:, :2] / eta[:, :2].sum(1, keepdims=True)
    h0 = Params(torch.tensor(h0_eta if admixture else h0_eta.mean(0)),
                torch.tensor(p[:2]))

    def ts():
        out = bs.BootstrapResult(0.0, [], 0.0, 2, 3)
        return list(bs._batched_ts(11, md, opt, h0, 2, [], out))

    calls = []
    real = tbk.bucketize_model_data
    with monkeypatch.context() as m:
        m.setattr(tbk, "bucketize_model_data",
                  lambda *a: calls.append(1) or real(*a))
        ts_b = ts()
    assert len(calls) == 2           # each replicate bucketed once
    ts_d = _dense_forced(monkeypatch, ts)
    np.testing.assert_allclose(ts_b, ts_d, rtol=0, atol=FIT_ATOL)


def _numbers(text):
    """(value, printed decimals) of every number in ``text``."""
    return [(float(v), len(v.split(".")[1].split("e")[0]) if "." in v else 0)
            for v in re.findall(r"-?\d+\.?\d*(?:e[-+]\d+)?", text)]


def test_cli_matches_dense_forced(tmp_path, monkeypatch, capsys):
    """The CLI fits a mixed STRUCTURE file bucketed, prints the plan at
    -v 3, and writes the files of a dense-forced run: the same files, every
    number equal to its printed precision."""
    from multiclust_tpu_torch.cli import main

    ds = _structured_ds(9)
    data = str(tmp_path / "jag.str")
    write_data(Options(path=str(tmp_path)), ds, data, use_counts=True)
    dirs = {}
    for name in ("bucketed", "dense"):
        d = tmp_path / name
        d.mkdir()
        argv = ["-f", data, "-a", "-k", "3", "-n", "2", "-s", "1", "-v", "3",
                "--platform", "cpu", "-d", str(d)]
        if name == "bucketed":
            assert main(argv) == 0
        else:
            assert _dense_forced(monkeypatch, lambda: main(argv)) == 0
        dirs[name] = d
    out = capsys.readouterr().out
    assert out.count("jagged loci bucketed: 2 buckets, M_b [2, 8]") == 1
    files = sorted(os.listdir(dirs["dense"]))
    assert files == sorted(os.listdir(dirs["bucketed"])) and len(files) >= 5
    for f in files:
        with open(dirs["bucketed"] / f) as a, open(dirs["dense"] / f) as b:
            got, want = _numbers(a.read()), _numbers(b.read())
        assert len(got) == len(want), f
        for (g, dg), (w, dw) in zip(got, want):
            assert dg == dw and abs(g - w) <= 1.01 * 10.0 ** -dg, (f, g, w)


def test_checkpoint_of_a_bucketed_fit_crosses_packages(tmp_path):
    """A bucketed fit's checkpoint holds dense original-order p: it loads
    in the JAX package, and a resumed run returns it without fitting."""
    ds = _structured_ds(10)
    opts = {**FIT, "admixture": True, "max_iter": 50,
            "checkpoint_dir": str(tmp_path)}
    first = fit_dataset(ds, device="cpu", **opts).estimate.last
    loaded, _ = jax_ckpt.load(str(tmp_path), K)
    np.testing.assert_array_equal(np.asarray(loaded.best_params.p),
                                  first.best_params.p.numpy())
    assert loaded.max_logL == first.max_logL
    again = fit_dataset(ds, device="cpu", **opts).estimate.last
    assert again.buckets == first.buckets
    torch.testing.assert_close(again.best_params.p, first.best_params.p,
                               rtol=0, atol=0)
