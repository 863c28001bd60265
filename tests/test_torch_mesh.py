"""The port's meshed EM steps (runtime/mesh.py over torch.distributed)
against the JAX package's meshed steps and the port's own unsharded steps,
on the CPU in float64 over gloo.

Each mesh shape runs as one group of D x M worker processes (this file run
as a script), which join a gloo group through a ``file://`` init in the
test's tmp_path, run every case of that shape and save the whole results
of each case.  The workers import torch and the port only; the JAX side
runs here, on the conftest's 8 virtual CPU devices, with the same inputs
made from a numpy seed.  JAX is imported inside the functions that use it,
so that the workers never load it.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_TIMEOUT = 240

# ---------------------------------------------------------------------------
# the port side (runs in the workers, and here for the unsharded step)


def biallelic_panel(seed, I, L, missing_rate):  # noqa: E741
    """Counts [I, L, 2], miss [I, L], mask, n_alleles of a simulated
    biallelic admixture panel."""
    rng = np.random.default_rng(seed)
    K = 3
    Q = rng.dirichlet(np.full(K, 0.5), size=I)
    p0 = rng.uniform(0.1, 0.9, size=(K, L))
    miss = (rng.binomial(2, missing_rate, size=(I, L)) if missing_rate
            else np.zeros((I, L), np.int64))
    x0 = rng.binomial(2 - miss, Q @ p0)
    counts = np.stack([x0, 2 - miss - x0], axis=2)
    return counts, miss, np.ones((L, 2), bool), np.full(L, 2, np.int32)


def generic_panel(seed, I, L, M=4, missing_rate=0.1):  # noqa: E741
    """A multi-allelic panel: loci with up to M alleles."""
    from multiclust_tpu_torch.stats.sim import random_model, \
        simulate_admixture_fast

    rng = np.random.default_rng(seed)
    Q, P = random_model(rng, 3, L, M, I=I, concentration=0.5)
    ds = simulate_admixture_fast(rng, Q, P, missing_rate=missing_rate)
    return ds.counts, ds.miss, ds.mask, ds.n_alleles


def warm_params(seed, I, L, mask, K=3, per_individual=True):  # noqa: E741
    rng = np.random.default_rng(seed)
    M = mask.shape[1]
    eta = (rng.dirichlet(np.full(K, 2.0), size=I) if per_individual
           else rng.dirichlet(np.full(K, 2.0)))
    p = (rng.random((K, L, M)) + 0.1) * mask[None]
    return eta, p / p.sum(axis=2, keepdims=True)


def port_config(case, mesh):
    from multiclust_tpu_torch.model.common import EMConfig

    counts, miss, n_all = case["counts"], case["miss"], case["n_alleles"]
    admix, constrained = case["admixture"], case.get("constrained", False)
    on = case.get("use_pallas", "on")
    K = case["eta"].shape[-1]
    return EMConfig(
        admixture=admix, eta_constrained=constrained,
        has_missing=bool(miss.any()), use_pallas=on,
        biallelic=counts.shape[2] == 2 and bool((n_all == 2).all()),
        k_true=K if (admix and not constrained and on == "on") else 0,
        mesh=mesh)


def port_steps(case, mesh=None):
    """``case["n_steps"]`` EM steps of the port from the case's params
    (the meshed step when ``mesh`` is given), then the logL of the result;
    every output whole, as numpy."""
    from multiclust_tpu_torch.model.common import Params, make_model_data
    from multiclust_tpu_torch.opt import em as em_mod
    from multiclust_tpu_torch.runtime import multistart as ms

    dtype = getattr(torch, case.get("dtype", "float64"))
    f32 = dtype == torch.float32
    md = make_model_data(case["counts"], case["miss"], case["mask"],
                         case["n_alleles"], dtype=dtype, device="cpu",
                         storage_dtype=torch.int8 if f32 else None)
    cfg = port_config(case, mesh)
    md_fit, _ = ms._fit_data(md, cfg, None)
    params = Params(eta=torch.as_tensor(case["eta"], dtype=dtype)[None],
                    p=torch.as_tensor(case["p"], dtype=dtype)[None])
    params = ms._to_fit_layout(
        ms._pad_k(ms._warm_block(params, md, cfg), cfg), md_fit, cfg)
    out = []
    for _ in range(case.get("n_steps", 2)):
        params, ll, scale = em_mod.model_em_step(params, md_fit, cfg)
        whole = ms.lane_params(params, 0, cfg, md_fit)
        out.append((whole.eta.numpy(), whole.p.numpy(), float(ll[0]),
                    float(scale[0])))
    ll, scale = em_mod.model_log_likelihood(params, md_fit, cfg)
    return {"steps": out, "logL": (float(ll[0]), float(scale[0]))}


def _spy(module, name, calls):
    """Record each call of ``module.name`` (its keyword flags) in
    ``calls``."""
    fn = getattr(module, name)

    def wrapped(*a, **kw):
        calls.append((name, {k: v for k, v in kw.items()
                             if k.startswith(("emit", "finish"))}))
        return fn(*a, **kw)
    setattr(module, name, wrapped)


def run_case(case, mesh):
    """One case in a worker: its result, and for the kernel routes the
    wrappers the meshed step called."""
    if case["kind"] == "step":
        from multiclust_tpu_torch.model import admixture
        calls = []
        saved = {n: getattr(admixture, n) for n in (
            "admixture_fullstep_biallelic_chunked", "admixture_sweep_stats",
            "fullstep_rows", "fullstep_cols", "rows_finish", "p0_epilogue",
            "fullstep_p")}
        for n in saved:
            _spy(admixture, n, calls)
        try:
            out = port_steps(case, mesh)
        finally:
            for n, fn in saved.items():
                setattr(admixture, n, fn)
        out["calls"] = calls
        return out
    return CASES_ELSEWHERE[case["kind"]](case, mesh)


# kinds of case the fit tests add (tests/test_torch_mesh_fit.py)
CASES_ELSEWHERE = {}


def worker(task: str, rank: int, world: int, init: str) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist

    from multiclust_tpu_torch.runtime import mesh as mesh_mod

    mesh_mod.initialize_distributed(num_processes=world, process_id=rank,
                                    device="cpu", init_method=init)
    spec = torch.load(task, weights_only=False)
    if spec.get("fit_module"):
        # the fit module registers its kinds of case in this module's
        # CASES_ELSEWHERE: let its import find this module, not a copy
        sys.modules.setdefault("test_torch_mesh", sys.modules[__name__])
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        __import__(spec["fit_module"])
    mesh = mesh_mod.cached_mesh(spec["shape"])
    out = {c["name"]: run_case(c, mesh) for c in spec["cases"]}
    torch.save(out, f"{task}.rank{rank}")
    dist.destroy_process_group()


def run_group(tmp_path, shape, cases, fit_module=None):
    """Run ``cases`` on a D x M mesh of worker processes; returns each
    rank's results.  A worker that fails or outlives GROUP_TIMEOUT fails
    the test, with its output."""
    D, M = shape
    n = D * M
    task = str(tmp_path / f"mesh_{D}x{M}.pt")
    torch.save({"shape": shape, "cases": cases, "fit_module": fit_module},
               task)
    init = "file://" + str(tmp_path / f"init_{D}x{M}")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), task, str(r), str(n),
         init], env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(n)]
    deadline = time.time() + GROUP_TIMEOUT
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(1.0, deadline - time.time()))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"mesh {D}x{M} workers outlived {GROUP_TIMEOUT} s")
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {D}x{M} failed:\n{log}"
    return [torch.load(f"{task}.rank{r}", weights_only=False)
            for r in range(n)]


# ---------------------------------------------------------------------------
# the JAX side


def jax_steps(case, shape):
    """The JAX package's step ``n_steps`` times on a mesh of ``shape`` of
    the virtual CPU devices (GSPMD shards the float64 XLA step from the
    input placements), then its logL."""
    import jax
    import jax.numpy as jnp

    from multiclust_tpu.model import admixture as jadm
    from multiclust_tpu.model import mixture as jmix
    from multiclust_tpu.model.common import EMConfig as JaxEMConfig, \
        ModelData as JaxModelData, Params as JaxParams
    from multiclust_tpu.ops import df64
    from multiclust_tpu.runtime import mesh as jmesh

    md = JaxModelData(x=jnp.asarray(case["counts"], jnp.float64),
                      miss=jnp.asarray(case["miss"], jnp.float64),
                      mask=jnp.asarray(case["mask"]),
                      n_alleles=jnp.asarray(case["n_alleles"]))
    params = JaxParams(eta=jnp.asarray(case["eta"]),
                       p=jnp.asarray(case["p"]))
    D, M = shape
    I, L = case["miss"].shape  # noqa: E741
    if I % D == 0 and L % M == 0:
        # an uneven panel stays whole: the JAX package pads rows and loci
        # to shardable sizes (mesh.shardable_sizes), the port does not
        m = jmesh.make_mesh(shape, devices=jax.devices()[:D * M])
        md = jmesh.shard_model_data(md, m)
        params = jmesh.shard_params(params, m)
    cfg = JaxEMConfig(admixture=case["admixture"],
                      eta_constrained=case.get("constrained", False),
                      has_missing=bool(case["miss"].any()))
    if case["admixture"]:
        step, loglik = jadm.em_step, jadm.log_likelihood
    else:
        def step(p, d, c):
            return jmix.em_step(p, d, c)[:3]
        loglik = jmix.log_likelihood
    step = jax.jit(step, static_argnums=2)
    loglik = jax.jit(loglik)
    out = []
    for _ in range(case.get("n_steps", 2)):
        params, ll, scale = step(params, md, cfg)
        out.append((np.asarray(params.eta), np.asarray(params.p),
                    float(df64.df_value(ll)), float(scale)))
    ll, scale = loglik(params, md)
    return {"steps": out, "logL": (float(df64.df_value(ll)), float(scale))}


def assert_same(got, want, rtol, atol=1e-14):
    for (e1, p1, ll1, s1), (e2, p2, ll2, s2) in zip(got["steps"],
                                                     want["steps"]):
        np.testing.assert_allclose(e1, e2, rtol=rtol, atol=atol)
        np.testing.assert_allclose(p1, p2, rtol=rtol, atol=atol)
        np.testing.assert_allclose(ll1, ll2, rtol=rtol)
        np.testing.assert_allclose(s1, s2, rtol=rtol)
    np.testing.assert_allclose(got["logL"], want["logL"], rtol=rtol)


# ---------------------------------------------------------------------------
# cases


def _case(name, panel, admixture=True, seed=7, **kw):
    counts, miss, mask, n_all = panel
    I, L = miss.shape  # noqa: E741
    per_i = admixture and not kw.get("constrained", False)
    eta, p = warm_params(seed, I, L, mask, per_individual=per_i)
    return dict(name=name, kind="step", counts=counts, miss=miss, mask=mask,
                n_alleles=n_all, eta=eta, p=p, admixture=admixture, **kw)


def step_cases(I=48, L=40):  # noqa: E741
    bi = biallelic_panel(1, I, L, 0.1)
    bi0 = biallelic_panel(2, I, L, 0.0)
    gen = generic_panel(3, I, L)
    return [
        _case("bi", bi),
        _case("bi_nomiss", bi0),
        _case("generic", gen),
        _case("constrained", bi, constrained=True),
        _case("mixture", bi, admixture=False),
        _case("mixture_nomiss", bi0, admixture=False),
        # the float32 kernel routes (their plain versions on the CPU)
        _case("bi_f32", bi, dtype="float32"),
        _case("generic_f32", gen, dtype="float32"),
    ]


def _check_group(results, cases, shape):
    D, M = shape
    for case in cases:
        name = case["name"]
        got = [r[name] for r in results]
        # every rank holds the same whole result
        for other in got[1:]:
            assert_same(other, got[0], rtol=0, atol=0)
        mine = got[0]
        if case.get("dtype", "float64") == "float64":
            assert_same(mine, port_steps(case), rtol=1e-10)
            assert_same(mine, jax_steps(case, shape), rtol=1e-10)
            continue
        # float32 kernel routes: the unsharded kernel route's values, and
        # the sharded variants named in the issue were called
        assert_same(mine, port_steps(case), rtol=2e-5, atol=2e-6)
        names = [c[0] for c in mine["calls"]]
        if case["counts"].shape[2] == 2:
            flags = [c[1] for c in mine["calls"]
                     if c[0] == "admixture_fullstep_biallelic_chunked"]
            assert flags and all(f["emit_b"] for f in flags)
            assert all(f["emit_a"] == (M > 1) for f in flags)
            assert "p0_epilogue" in names
            assert ("rows_finish" in names) == (M > 1)
        else:
            assert ("admixture_sweep_stats" in names) == (M > 1)
            finish = [c[1].get("finish") for c in mine["calls"]
                      if c[0] == "fullstep_cols"]
            if M == 1:
                assert finish and not any(finish)
                assert "fullstep_rows" in names
            assert "fullstep_p" in names


def test_mesh_2x1_steps(tmp_path):
    """Rows split over two ranks, with an uneven panel (I = 61)."""
    cases = step_cases()
    uneven = [dict(c, name=c["name"] + "_I61") for c in step_cases(I=61)
              if c["name"] in ("bi", "generic", "mixture", "bi_f32")]
    results = run_group(tmp_path, (2, 1), cases + uneven)
    _check_group(results, cases + uneven, (2, 1))


def test_mesh_1x2_steps(tmp_path):
    """Loci split over two ranks: eta whole on each (the SQUAREM dot
    products must not count it twice), with an uneven panel (L = 33)."""
    cases = step_cases()
    uneven = [dict(c, name=c["name"] + "_L33") for c in step_cases(L=33)
              if c["name"] in ("bi", "generic", "constrained", "bi_f32",
                               "generic_f32")]
    results = run_group(tmp_path, (1, 2), cases + uneven)
    _check_group(results, cases + uneven, (1, 2))


def test_mesh_2x2_steps(tmp_path):
    cases = step_cases()
    results = run_group(tmp_path, (2, 2), cases)
    _check_group(results, cases, (2, 2))


def test_mesh_blocks_and_shape_checks():
    """Uneven blocks cover the axis in order; a shape that does not cover
    the process group raises."""
    from multiclust_tpu_torch.runtime import mesh as mesh_mod

    for n, parts in ((61, 2), (33, 2), (7, 3), (4, 4)):
        blocks = [mesh_mod.block(n, parts, i) for i in range(parts)]
        assert blocks[0][0] == 0 and blocks[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))
        sizes = [hi - lo for lo, hi in blocks]
        assert max(sizes) - min(sizes) <= 1
    with pytest.raises(ValueError, match="does not cover 1 processes"):
        mesh_mod.make_mesh((2, 1))
    assert mesh_mod.make_mesh().shape == (1, 1)
    assert not mesh_mod.sync_host_flag(0) and mesh_mod.sync_host_flag(3)


if __name__ == "__main__":
    worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
