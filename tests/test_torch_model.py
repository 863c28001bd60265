"""The port's model, simplex, conversion and init layers against the JAX
package, on the CPU in float64 (and the port's init draws statistically)."""

import ast
import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiclust_tpu.config import Options as JaxOptions
from multiclust_tpu.model import admixture as jadm
from multiclust_tpu.model.common import EMConfig as JaxEMConfig, \
    Params as JaxParams, model_data_from_dataset as jax_model_data
from multiclust_tpu.ops import df64
from multiclust_tpu.ops.simplex import project_rows as jax_project_rows
from multiclust_tpu.stats.sim import random_model, simulate_admixture_fast
from multiclust_tpu_torch.config import InitMethod
from multiclust_tpu_torch.convert import dataset_from_counts, \
    model_data_from_numpy, options_from, params_from_numpy, params_to_numpy
from multiclust_tpu_torch.init import random as rinit
from multiclust_tpu_torch.model import admixture as tadm
from multiclust_tpu_torch.model.common import EMConfig, Params, \
    k_padded_size, make_kmask, model_data_from_dataset, pad_params_k, \
    unpad_params_k
from multiclust_tpu_torch.ops.simplex import michelot_reference, project_rows
from multiclust_tpu_torch.runtime.multistart import _pad_k, _to_bi_repr, \
    _unpad_k, device_policy

torch.set_num_threads(2)


def _dataset(seed, K=3, I=40, L=60, M=2, missing_rate=0.1):
    rng = np.random.default_rng(seed)
    Q, P = random_model(rng, K, L, M, I=I, concentration=0.3)
    return simulate_admixture_fast(rng, Q, P, missing_rate=missing_rate)


def _biallelic(ds):
    """The panel with both allele slots of every locus valid (monomorphic
    loci keep an unobserved second allele): the biallelic layout."""
    return dataset_from_counts(ds.counts, ds.miss, ds.ploidy)


def _warm(seed, ds, K):
    """Random full-layout params on the dataset's allele mask."""
    rng = np.random.default_rng(seed)
    eta = rng.dirichlet(np.ones(K), size=ds.I)
    p = rng.dirichlet(np.ones(ds.M), size=(K, ds.L)) * ds.mask[None]
    return eta, p / p.sum(axis=2, keepdims=True)


@pytest.mark.parametrize("M,missing_rate", [(2, 0.0), (2, 0.1), (3, 0.1)])
def test_em_step_matches_jax_f64(M, missing_rate):
    """Four plain EM steps in float64 track the JAX XLA step to 1e-10."""
    ds = _dataset(1, M=M, missing_rate=missing_rate)
    K = 3
    eta, p = _warm(2, ds, K)
    cfg = dict(admixture=True, has_missing=bool(ds.miss.any()))
    jmd = jax_model_data(ds, dtype=jnp.float64)
    tmd = model_data_from_dataset(ds, dtype=torch.float64)
    jp = JaxParams(eta=jnp.asarray(eta), p=jnp.asarray(p))
    tp = params_from_numpy(eta[None], p[None])
    for _ in range(4):
        jp, jll, jsc = jadm.em_step(jp, jmd, JaxEMConfig(**cfg))
        tp, tll, tsc = tadm.em_step(tp, tmd, EMConfig(**cfg))
        np.testing.assert_allclose(tp.eta[0].numpy(), np.asarray(jp.eta),
                                   rtol=1e-10, atol=1e-14)
        np.testing.assert_allclose(tp.p[0].numpy(), np.asarray(jp.p),
                                   rtol=1e-10, atol=1e-14)
        np.testing.assert_allclose(float(tll[0]),
                                   float(df64.df_value(jll)), rtol=1e-10)
        np.testing.assert_allclose(float(tsc[0]), float(jsc), rtol=1e-10)


def test_log_likelihoods_match_jax():
    """log_likelihood (full layout) and log_likelihood_bi_repr (p0
    layout, K-padded) agree with JAX and with each other to 1e-10."""
    ds = _biallelic(_dataset(4, missing_rate=0.05))
    K = 3
    eta, p = _warm(5, ds, K)
    jll, jsc = jadm.log_likelihood(JaxParams(eta=jnp.asarray(eta),
                                             p=jnp.asarray(p)),
                                   jax_model_data(ds, dtype=jnp.float64))
    tmd = model_data_from_dataset(ds, dtype=torch.float64)
    full = params_from_numpy(eta[None], p[None])
    tll, tsc = tadm.log_likelihood(full, tmd)
    cfg = EMConfig(admixture=True, use_pallas="on", biallelic=True,
                   k_true=K)
    bi = _to_bi_repr(_pad_k(full, cfg), cfg)
    assert bi.p.shape == (1, 32, ds.L)
    bll, bsc = tadm.log_likelihood_bi_repr(bi, tmd)
    ref = float(df64.df_value(jll))
    np.testing.assert_allclose(float(tll[0]), ref, rtol=1e-10)
    np.testing.assert_allclose(float(bll[0]), ref, rtol=1e-10)
    np.testing.assert_allclose(float(bsc[0]), float(jsc), rtol=1e-10)
    # posterior allele mass: every observed copy is sourced somewhere
    dik = tadm.posterior_allele_mass(Params(full.eta[0], full.p[0]), tmd)
    np.testing.assert_allclose(dik.sum(dim=1).numpy(),
                               np.full(ds.I, ds.ploidy * ds.L), rtol=1e-10)


def test_project_rows_matches_jax():
    """Masked, batched Michelot projection with active lower bounds, held
    to the JAX project_rows and the reference's own loop."""
    rng = np.random.default_rng(11)
    v = rng.normal(0.2, 0.4, size=(3, 50, 8))
    mask = np.arange(8) < 6
    lb = 0.02
    got = project_rows(torch.as_tensor(v), torch.as_tensor(mask), lb)
    ref = jax_project_rows(jnp.asarray(v), jnp.asarray(mask), 6, lb)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-15)
    g = got.numpy()
    assert (g[..., 6:] == 0).all()
    assert (g[..., :6] >= lb - 1e-15).all()
    assert (g[..., :6] == lb).any()                     # bounds were active
    np.testing.assert_allclose(g.sum(axis=-1), 1.0, rtol=1e-12)
    for row in v.reshape(-1, 8)[:20]:
        np.testing.assert_allclose(
            project_rows(torch.as_tensor(row[None, :6]),
                         torch.ones(6, dtype=torch.bool), lb)[0].numpy(),
            michelot_reference(row[:6], lb), rtol=1e-12, atol=1e-15)


def test_convert_roundtrips_exactly():
    rng = np.random.default_rng(3)
    eta = rng.dirichlet(np.ones(4), size=(2, 30))
    p_full = rng.uniform(size=(2, 4, 20, 2))
    p0 = rng.uniform(size=(2, 32, 20))
    for p in (p_full, p0):
        e2, q2 = params_to_numpy(params_from_numpy(eta, p))
        assert e2.dtype == np.float64 and (e2 == eta).all()
        assert (q2 == p).all()
    # padded rows / loci of the JAX engine are trimmed on the way in
    eta_pad = np.concatenate([eta, np.full((2, 34, 4), 0.25)], axis=1)
    p0_pad = np.pad(p0, ((0, 0), (0, 0), (0, 108)))
    back = params_from_numpy(eta_pad, p0_pad, n_rows=30, n_loci=20)
    assert (back.eta.numpy() == eta).all() and (back.p.numpy() == p0).all()
    ds = _dataset(6)
    assert (ds.n_alleles == 1).any()         # monomorphic loci: not biallelic
    bi = _biallelic(ds)
    md = model_data_from_numpy(bi.counts, bi.miss, bi.mask, bi.n_alleles)
    assert (md.x.numpy() == ds.counts).all()
    assert (md.x0.numpy() == ds.counts[:, :, 0]).all()
    assert (md.x1.numpy() == ds.counts[:, :, 1]).all()
    assert md.x0.is_contiguous() and md.x1.is_contiguous()
    # the counts are stored once: x is a view of the two planes
    assert md.x.data_ptr() == md.x0.data_ptr()
    assert (md.c.numpy() == ds.miss.sum(axis=1)).all()
    # any other panel keeps x contiguous, x_lanes its [I, L*M] view
    md = model_data_from_numpy(ds.counts, ds.miss, ds.mask, ds.n_alleles)
    assert md.x0 is None and md.x.is_contiguous()
    assert md.x_lanes.data_ptr() == md.x.data_ptr()
    assert (md.x_lanes.numpy() == ds.counts.reshape(ds.I, -1)).all()
    back = dataset_from_counts(ds.counts, ds.miss, ds.ploidy)
    assert (back.counts == ds.counts).all() and (back.miss == ds.miss).all()
    assert back.ploidy == ds.ploidy and (back.n_alleles == 2).all()


def test_device_policy_keeps_the_kernel_on_cuda():
    """float32 admixture fits on CUDA take the kernel, and cannot be
    switched to the plain step; CPU fits keep the override."""
    opt = options_from(JaxOptions(admixture=True, dtype="float32"))
    assert device_policy(opt, "cuda") == (True, torch.int8)
    assert device_policy(opt, "cpu") == (False, None)
    on = dataclasses.replace(opt, use_pallas=True)
    assert device_policy(on, "cpu") == (True, None)
    off = dataclasses.replace(opt, use_pallas=False)
    with pytest.raises(ValueError, match="kernel"):
        device_policy(off, "cuda")
    f64 = dataclasses.replace(opt, dtype="float64")
    assert device_policy(f64, "cpu") == (False, None)


def test_k_padding_roundtrip():
    rng = np.random.default_rng(8)
    full = params_from_numpy(rng.dirichlet(np.ones(3), size=(2, 10)),
                             rng.dirichlet(np.ones(2), size=(2, 3, 7)))
    cfg = EMConfig(admixture=True, use_pallas="on", biallelic=True,
                   k_true=3)
    padded = pad_params_k(full, k_padded_size(3, 32))
    assert padded.eta.shape == (2, 10, 32) and (padded.p[:, 3:] == 0).all()
    assert torch.equal(unpad_params_k(padded, 3).p, full.p)
    back = _unpad_k(_to_bi_repr(_pad_k(full, cfg), cfg), cfg)
    torch.testing.assert_close(back.p, full.p, rtol=0, atol=1e-15)
    assert torch.equal(back.eta, full.eta)
    assert make_kmask(3, 32).sum() == 3


def test_import_leaves_jax_out():
    """Importing every module of the port never imports jax."""
    mods = ["multiclust_tpu_torch", "multiclust_tpu_torch.api",
            "multiclust_tpu_torch.cli", "multiclust_tpu_torch.convert",
            "multiclust_tpu_torch.model.common",
            "multiclust_tpu_torch.model.admixture",
            "multiclust_tpu_torch.model.mixture",
            "multiclust_tpu_torch.ops.mixture_bi",
            "multiclust_tpu_torch.ops.simplex",
            "multiclust_tpu_torch.ops.build",
            "multiclust_tpu_torch.ops.fullstep",
            "multiclust_tpu_torch.ops.fullstep_bi",
            "multiclust_tpu_torch.opt.em", "multiclust_tpu_torch.opt.driver",
            "multiclust_tpu_torch.init.random",
            "multiclust_tpu_torch.runtime.multistart",
            "multiclust_tpu_torch.runtime.ksweep"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "import numpy as np\n"
            "from multiclust_tpu_torch.convert import dataset_from_counts\n"
            "dataset_from_counts(np.ones((2, 3, 2)), np.zeros((2, 3)), 2)\n"
            "assert 'jax' not in sys.modules, sorted(\n"
            "    m for m in sys.modules if m.startswith('jax'))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_imports_only_the_port():
    """The GPU smoke script drives the port alone: no jax and nothing of
    the JAX package, at any level of the file."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "chip_smoke.py")) as fh:
        tree = ast.parse(fh.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
    tops = {n.split(".")[0] for n in names}
    assert "multiclust_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "multiclust_tpu"}, sorted(names)


@pytest.mark.parametrize("M", [2, 3])
def test_codes_from_counts_matches_jax(M):
    """The port's device-side allele codes equal the JAX package's host
    codes, int8 counts (the CUDA storage) included."""
    from multiclust_tpu.init.random import codes_from_counts as jax_codes
    ds = _dataset(10, M=M, missing_rate=0.2)
    want = jax_codes(ds.counts, ds.miss, ds.ploidy)
    assert (want == -1).any() and (want == M - 1).any()
    for dtype in (torch.float64, torch.int8):
        got = rinit.codes_from_counts(torch.as_tensor(ds.counts).to(dtype),
                                      torch.as_tensor(ds.miss).to(dtype),
                                      ds.ploidy)
        # codes are stored as narrow as the data (a biobank panel's int64
        # codes would take eight times its planes)
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("method", [InitMethod.RANDOM_CENTERS,
                                    InitMethod.RANDOM_PARTITION])
@pytest.mark.parametrize("K", [2, 4])
def test_init_draws_are_valid_and_use_every_label(method, K):
    ds = _dataset(9, I=50, L=80, missing_rate=0.1)
    md = model_data_from_dataset(ds, dtype=torch.float64)
    codes = rinit.codes_from_counts(md.x, md.miss, 2)
    gen = torch.Generator().manual_seed(K)
    labels = (rinit.random_allele_partition(gen, md, codes, K)
              if method == InitMethod.RANDOM_PARTITION
              else rinit.random_allele_center(gen, md, codes, K))
    assert ((labels == -1) == (codes == -1)).all()
    counts = torch.bincount(labels[labels >= 0], minlength=K).numpy()
    assert (counts > 0).all()
    # near-uniform label use over thousands of copies
    assert counts.min() > 0.5 * counts.mean()
    params = rinit.parameters_from_allele_partition(labels, codes, md, K)
    lb = 1e-8
    # eta rows: add-one smoothing over the observed copies (on the
    # simplex exactly when nothing is missing, rnd_init.c:590-705)
    observed = 2 * ds.L - ds.miss.sum(axis=1)
    np.testing.assert_allclose(params.eta.sum(dim=1).numpy(),
                               (K + observed) / (2 * ds.L + K), rtol=1e-12)
    np.testing.assert_allclose(params.p.sum(dim=2).numpy(), 1.0,
                               rtol=1e-12)
    assert float(params.eta.min()) >= lb and float(params.p.min()) >= lb
    # the smoothed counts are the one-hot sums of the JAX package
    from multiclust_tpu.init.random import \
        parameters_from_allele_partition as jax_from_partition
    ref = jax_from_partition(jnp.asarray(labels.numpy()),
                             jnp.asarray(codes.numpy()),
                             jax_model_data(ds, dtype=jnp.float64), K, False)
    np.testing.assert_allclose(params.eta.numpy(), np.asarray(ref.eta),
                               rtol=1e-14)
    np.testing.assert_allclose(params.p.numpy(), np.asarray(ref.p),
                               rtol=1e-14)


def test_rand_em_keeps_best_scoring_draw():
    ds = _dataset(12, I=30, L=40, missing_rate=0.0)
    md = model_data_from_dataset(ds, dtype=torch.float64)
    cfg = EMConfig(admixture=True, has_missing=False)
    K, n = 3, 6
    best = rinit.rand_em_initialize(torch.Generator().manual_seed(5), md, K,
                                    cfg, InitMethod.RANDOM_PARTITION, n,
                                    chunk=4)
    gen = torch.Generator().manual_seed(5)
    scores = []
    cands = []
    for _ in range(n):
        c = rinit.random_initialize(gen, md, K, InitMethod.RANDOM_PARTITION)
        stepped, _, _ = tadm.em_step(Params(c.eta[None], c.p[None]), md, cfg)
        scores.append(float(tadm.log_likelihood(stepped, md)[0][0]))
        cands.append(c)
    assert len(set(scores)) == n
    want = cands[int(np.argmax(scores))]
    assert torch.equal(best.eta, want.eta) and torch.equal(best.p, want.p)
