"""The port's EM driver, K-sweep and CLI against the JAX package on the
CPU, from the same warm starts (JAX and torch random streams differ, so
parity is fit for fit from shared parameters)."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiclust_tpu.config import Options
from multiclust_tpu.model.common import EMConfig as JaxEMConfig, \
    Params as JaxParams, model_data_from_dataset as jax_model_data
from multiclust_tpu.opt.driver import fit as jax_fit
from multiclust_tpu.runtime.ksweep import estimate_model as jax_estimate
from multiclust_tpu.stats.sim import simulate_admixture_fast
from multiclust_tpu_torch.convert import options_from, params_from_numpy
from multiclust_tpu_torch.model.common import EMConfig, \
    model_data_from_dataset
from multiclust_tpu_torch.opt.driver import fit
from multiclust_tpu_torch.runtime.ksweep import estimate_model

torch.set_num_threads(2)


def _panel(seed, K=3, I=120, L=200, missing_rate=0.05):
    """Simulated biallelic admixture panel with clear structure."""
    rng = np.random.default_rng(seed)
    Q = rng.dirichlet(np.full(K, 0.3), size=I)
    p0 = rng.choice([0.1, 0.5, 0.9], size=(K, L))
    ds = simulate_admixture_fast(rng, Q, np.stack([p0, 1 - p0], axis=2),
                                 missing_rate=missing_rate)
    assert (ds.n_alleles == 2).all()
    return ds


def _warm(seed, I, L, K):
    rng = np.random.default_rng(seed)
    p0 = rng.uniform(0.2, 0.8, size=(K, L))
    return (rng.dirichlet(np.full(K, 2.0), size=I),
            np.stack([p0, 1 - p0], axis=2))


@pytest.mark.parametrize("label,kw,ll_tol,iter_tol", [
    ("plain", dict(check_interval=1), 1e-8, 0),
    ("adaptive", dict(check_interval=0), 1e-8, 0),
    ("interval4", dict(check_interval=4), 1e-8, 0),
    ("squarem", dict(accel_scheme=1, adjust_step=3), 1e-6, 2),
    ("qn1", dict(accel_scheme=4, q=1), 1e-6, 2),
    ("qn2", dict(accel_scheme=4, q=2), 1e-6, 2),
])
def test_driver_fit_matches_jax(label, kw, ll_tol, iter_tol):
    ds = _panel(1, I=60, L=80)
    eta, p = _warm(2, ds.I, ds.L, 3)
    base = dict(admixture=True, has_missing=True, **kw)
    jr = jax_fit(JaxParams(eta=jnp.asarray(eta), p=jnp.asarray(p)),
                 jax_model_data(ds, dtype=jnp.float64), JaxEMConfig(**base))
    tr = fit(params_from_numpy(eta, p),
             model_data_from_dataset(ds, dtype=torch.float64),
             EMConfig(**base))
    assert tr.converged and jr.converged
    assert abs(tr.n_iter - jr.n_iter) <= iter_tol, (tr.n_iter, jr.n_iter)
    assert abs(tr.logL - jr.logL) <= ll_tol * abs(jr.logL), \
        (tr.logL, jr.logL)


def _opt(**kw):
    base = dict(admixture=True, min_K=3, max_K=3, n_init=1, seed=7,
                verbosity=0, write_files=False)
    base.update(kw)
    return Options(**base)


def test_estimate_model_matches_jax_f64():
    ds = _panel(3)
    eta, p = _warm(4, ds.I, ds.L, 3)
    opt = _opt(dtype="float64").synchronize(ds.I, ds.ploidy)

    def n_par(K):
        return ds.n_parameters(K, True, False)

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
                                   rtol=1e-9)
    assert tr.n_total_iter == jr.n_total_iter
    assert tr.ever_converged and te.aic_K == je.aic_K == 3
    np.testing.assert_allclose(tr.best_params.eta.numpy(),
                               np.asarray(jr.best_params.eta), atol=1e-6)


def test_estimate_model_f32_kernel_path_matches_interpret(monkeypatch):
    """The port's float32 p0-layout path (the kernel's plain version on
    CPU tensors) against JAX with the Pallas kernel in interpret mode.
    Both run to the same iteration cap: free-running float32 chains stop
    wherever the logL gain first falls under the float32 noise floor,
    several tenths apart on this slowly converging panel, so the capped
    trajectories are what can be compared (as test_kernels.py:294-337).
    The cap is short because the Pallas kernel's approximate reciprocal
    (kernels.py:145) drifts its trajectory off the exact float32 one:
    0.53 logL after 127 iterations here, where the port stays within 0.02
    of the float64 fit."""
    import multiclust_tpu.runtime.multistart as jms

    ds = _panel(5)
    eta, p = _warm(6, ds.I, ds.L, 3)
    opt = _opt(dtype="float32", use_pallas=True, max_iter=30,
               abs_error=1e-12).synchronize(ds.I, 2)
    orig = jms.cfg_from_options
    monkeypatch.setattr(jms, "cfg_from_options",
                        lambda o, K, md=None: orig(o, K, md)._replace(
                            use_pallas="interpret"))

    def n_par(K):
        return ds.n_parameters(K, True, False)

    je = jax_estimate(jax.random.PRNGKey(0),
                      jax_model_data(ds, dtype=jnp.float32), opt, n_par,
                      warm=JaxParams(eta=jnp.asarray(eta, jnp.float32),
                                     p=jnp.asarray(p, jnp.float32)))
    tmd = model_data_from_dataset(ds, dtype=torch.float32)
    te = estimate_model(0, tmd, options_from(opt), n_par,
                        warm=params_from_numpy(eta, p, dtype=torch.float32))
    from multiclust_tpu_torch.runtime.multistart import cfg_from_options
    assert cfg_from_options(options_from(opt), 3, tmd).bi_repr_active
    jr, tr = je.per_K[3], te.per_K[3]
    assert not (tr.ever_converged or jr.ever_converged)   # both capped
    assert not tr.mono_viol and not tr.any_failed
    assert abs(tr.max_logL - jr.max_logL) < 0.1, (tr.max_logL, jr.max_logL)


def _write_structure(ds, path):
    with open(path, "w") as fh:
        fh.write(" ".join(f"loc{l}" for l in range(ds.L)) + "\n")
        for i in range(ds.I):
            for a in range(ds.ploidy):
                fh.write(f"ind{i} pop{i % 2} "
                         + " ".join(map(str, ds.IL[i * ds.ploidy + a]))
                         + "\n")


def _numbers(path):
    with open(path) as fh:
        return np.array([float(v) for v in re.findall(
            r"-?\d+\.\d+(?:e[-+]\d+)?|-?\d+", fh.read())])


OUT_FILES = ("sim.str.admix.K=3.out.txt", "sim.str.admix.K=3.etaik.txt",
             "sim.str.admix.K=3.pklm.txt", "sim.str_admix_popq_3.popq",
             "sim.str_admix_indivq_3.indivq")


def test_cli_warm_start_matches_jax(tmp_path, capsys):
    from multiclust_tpu.cli import main as jax_main
    from multiclust_tpu_torch.cli import main

    ds = _panel(7, I=80, L=120)
    data = str(tmp_path / "sim.str")
    _write_structure(ds, data)
    eta, p = _warm(8, ds.I, ds.L, 3)
    qf, pf = str(tmp_path / "w.q"), str(tmp_path / "w.p")
    np.savetxt(qf, eta, fmt="%.17g")
    np.savetxt(pf, p[:, :, 0].T, fmt="%.17g")
    outs = {}
    for name, entry in (("jax", jax_main), ("torch", main)):
        d = tmp_path / name
        d.mkdir()
        assert entry(["-f", data, "-a", "-k", "3", "-n", "1", "-Q", qf,
                      "-P", pf, "--platform", "cpu", "-d", str(d)]) == 0
        outs[name] = d
    printed = [ln.split() for ln in capsys.readouterr().out.splitlines()
               if ln.startswith(data)]
    assert len(printed) == 2 and printed[0][9:12] == printed[1][9:12]
    with open(outs["jax"] / OUT_FILES[0]) as a, \
            open(outs["torch"] / OUT_FILES[0]) as b:
        head_j, head_t = a.read().split("\n\n")[0], b.read().split("\n\n")[0]
    assert head_t == head_j      # logL, AIC and BIC to the printed digits
    for f in OUT_FILES[1:]:
        np.testing.assert_allclose(_numbers(outs["torch"] / f),
                                   _numbers(outs["jax"] / f), atol=1.5e-6)


def test_cli_multistart_squarem_writes_every_file(tmp_path, capsys):
    from multiclust_tpu_torch.cli import main

    ds = _panel(9, I=60, L=80)
    data = str(tmp_path / "sim.str")
    _write_structure(ds, data)
    assert main(["-f", data, "-a", "-k", "3", "-n", "4", "-s", "1",
                 "--platform", "cpu", "-d", str(tmp_path)]) == 0
    for f in OUT_FILES:
        assert os.path.getsize(tmp_path / f) > 0
    line = capsys.readouterr().out.strip().splitlines()[-1].split()
    assert line[1] == "S1" and line[2] == "admix"
    assert np.isfinite(float(line[9])) and int(line[16]) == 4  # n_init


@pytest.mark.parametrize("argv,last", [
    (["-k", "3", "-w", "n", "2"], "Average iterations: "),
    (["-a", "-k", "3", "-c", "-b", "2"], "p-value to reject H0: K=2 is "),
    (["-a", "-k", "3", "-b", "2"], "p-value to reject H0: K=2 is "),
])
def test_cli_runs_timing_and_bootstrap(tmp_path, capsys, argv, last):
    """-w and -b run on the CPU: the timing summary's last line, and one
    line per bootstrap replicate before the p-value."""
    from multiclust_tpu_torch.cli import main

    ds = _panel(9, I=40, L=40)
    data = str(tmp_path / "sim.str")
    _write_structure(ds, data)
    assert main(["-f", data, "-n", "2", "-E", "1e-2", "--platform", "cpu",
                 "-d", str(tmp_path)] + argv) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1].startswith(last)
    if "-b" in argv:
        assert [ln.split(":")[0] for ln in out[-3:-1]] == [
            "Bootstrap dataset 1 (of 2)", "Bootstrap dataset 2 (of 2)"]
        assert 0.0 <= float(out[-1].split()[-1]) <= 1.0


@pytest.mark.parametrize("argv,what", [
    (["-a", "-k", "3", "--mesh", "2x1"], "mesh shape 2x1 does not cover 1 "),
])
def test_cli_rejects_unported_flags(tmp_path, argv, what):
    from multiclust_tpu_torch.cli import UsageError
    from multiclust_tpu_torch.cli import main

    with pytest.raises(UsageError, match=what):
        main(["-f", str(tmp_path / "x.str"), "--platform", "cpu"] + argv)


def test_default_device_needs_cuda(tmp_path, monkeypatch):
    """Without a CUDA device the API and CLI raise instead of falling
    back to the CPU."""
    from multiclust_tpu_torch.cli import UsageError
    from multiclust_tpu_torch.api import fit_dataset
    from multiclust_tpu_torch.cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit_dataset(_panel(1, I=10, L=10), admixture=True, min_K=2, max_K=2)
    with pytest.raises(UsageError, match="no CUDA device"):
        main(["-f", str(tmp_path / "x.str"), "-a", "-k", "2"])
