"""The port's checkpoint / resume (runtime/checkpoint.py) and its -w / -v > 3
harness (runtime/timing.py, runtime/observe.py) on the CPU: the JAX
package's checkpoint cases replayed on the port, checkpoints crossing
between the packages, and the CLI's trace and timing lines against the
JAX CLI's from the same warm start."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiclust_tpu.config import Options as JaxOptions
from multiclust_tpu.model.common import model_data_from_dataset as \
    jax_model_data
from multiclust_tpu.runtime import checkpoint as jax_ckpt
from multiclust_tpu.runtime.multistart import maximize_likelihood as \
    jax_maximize
from multiclust_tpu.stats.sim import simulate_mixture
from multiclust_tpu_torch.config import Options
from multiclust_tpu_torch.convert import options_from
from multiclust_tpu_torch.model.common import model_data_from_dataset
from multiclust_tpu_torch.runtime import checkpoint as ckpt
from multiclust_tpu_torch.runtime.ksweep import estimate_model
from multiclust_tpu_torch.runtime.multistart import maximize_likelihood
from multiclust_tpu_torch.stats import bootstrap as bs
from multiclust_tpu_torch.stats.sim import simulate_admixture_fast

torch.set_num_threads(2)


def _make(rng):
    """tests/test_checkpoint.py's panel: 50 x 25, three alleles."""
    P = rng.dirichlet(np.full(3, 0.3), size=(3, 25))
    ds, _ = simulate_mixture(rng, np.array([.3, .3, .4]), P, I=50)
    return ds


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _fit(ds, tmp_path, n_init=3, seed=0):
    md = model_data_from_dataset(ds, dtype=torch.float64)
    opt = Options(n_init=n_init, min_K=2, max_K=2, dtype="float64")
    return maximize_likelihood(_gen(seed), md, 2, opt,
                               ds.n_parameters(2, False, False),
                               checkpoint_dir=str(tmp_path))


def test_checkpoint_roundtrip(tmp_path, rng):
    ds = _make(rng)
    res = _fit(ds, tmp_path)
    assert (tmp_path / "multiclust_ckpt.K=2.npz").exists()
    gen = torch.Generator()
    loaded = ckpt.load(str(tmp_path), 2, gen=gen)
    assert loaded.max_logL == res.max_logL
    assert loaded.n_launched == res.n_launched == 3
    assert (loaded.route, loaded.batch_chains) == (res.route,
                                                   res.batch_chains)
    torch.testing.assert_close(loaded.best_params.p, res.best_params.p,
                               rtol=0, atol=0)
    # the generator state after the fit's draws came back too
    after = _gen(0)
    _fit(ds, tmp_path / "again", seed=0)
    assert not torch.equal(gen.get_state(), after.get_state())


def test_checkpoint_resume_skips_completed(tmp_path, rng):
    """A finished sweep resumes at once with identical results, whatever
    the generator."""
    ds = _make(rng)
    res1 = _fit(ds, tmp_path)
    res2 = _fit(ds, tmp_path, seed=777)
    assert res2.max_logL == res1.max_logL
    assert res2.n_launched == res1.n_launched


def test_checkpoint_resume_continues(tmp_path, rng):
    ds = _make(rng)
    res1 = _fit(ds, tmp_path, n_init=2)
    assert res1.n_launched == 2
    res2 = _fit(ds, tmp_path, n_init=6)
    assert res2.n_launched >= 6
    assert res2.max_logL >= res1.max_logL


def test_checkpoint_crosses_between_the_packages(tmp_path, rng):
    """A K-sweep checkpoint written by the JAX package loads in the port
    with the same counters and parameters, and the reverse."""
    ds = _make(rng)
    jd, td = tmp_path / "jax", tmp_path / "torch"
    jopt = JaxOptions(n_init=3, min_K=2, max_K=2, dtype="float64")
    npar = ds.n_parameters(2, False, False)
    jres = jax_maximize(jax.random.PRNGKey(0),
                        jax_model_data(ds, dtype=jnp.float64), 2, jopt,
                        npar, checkpoint_dir=str(jd))
    tres = _fit(ds, td)
    fields = ckpt._COUNTER_FIELDS
    from_jax = ckpt.load(str(jd), 2)
    from_torch, key = jax_ckpt.load(str(td), 2)
    assert key is None                  # the port writes no threefry key
    for f in fields:
        assert getattr(from_jax, f) == getattr(jres, f), f
        assert getattr(from_torch, f) == getattr(tres, f), f
    np.testing.assert_array_equal(from_jax.best_params.p.numpy(),
                                  np.asarray(jres.best_params.p))
    np.testing.assert_array_equal(np.asarray(from_torch.best_params.eta),
                                  tres.best_params.eta.numpy())
    np.testing.assert_array_equal(np.asarray(from_torch.best_params.p),
                                  tres.best_params.p.numpy())
    # the port resumes a finished JAX sweep without fitting a chain
    res = maximize_likelihood(_gen(5), model_data_from_dataset(
        ds, dtype=torch.float64), 2, options_from(jopt), npar,
        checkpoint_dir=str(jd))
    assert res.max_logL == jres.max_logL
    assert res.n_launched == jres.n_launched


def _bootstrap_setup(rng, **kw):
    """A small structured admixture panel and its observed fit."""
    P2 = np.stack([np.stack([np.full(20, 0.9), np.full(20, 0.1)], 1),
                   np.stack([np.full(20, 0.1), np.full(20, 0.9)], 1)])
    Q2 = np.tile(np.array([[1.0, 0.0]]), (24, 1))
    Q2[12:] = [0.0, 1.0]
    ds = simulate_admixture_fast(rng, Q2, P2, ploidy=2)
    md = model_data_from_dataset(ds, dtype=torch.float64)
    opt = Options(admixture=True, n_init=2, min_K=2, max_K=2,
                  n_bootstrap=6, dtype="float64", verbosity=0,
                  **kw).synchronize(ds.I, 2)

    def npar(K):
        return ds.n_parameters(K, True, False)
    est = estimate_model(0, md, opt, npar)
    return md, opt, npar, est


def test_bootstrap_checkpoint_resume_identical(tmp_path, rng, monkeypatch):
    """A batched -b run killed inside its second chunk resumes to the
    identical statistics and p-value; a finished one fits nothing."""
    md, opt, npar, est = _bootstrap_setup(rng)
    # chunks of 2 replicates, so that a run can die between chunks
    monkeypatch.setattr(bs, "replicate_chunk", lambda *a: 2)

    def run(**kw):
        return bs.run_bootstrap(11, md, opt, npar, est.ts, est.h0_params,
                                2, **kw)
    ref = run()
    real = bs.fit_lattice
    calls = []

    def dying(*a, **k):
        calls.append(1)
        if len(calls) > 2:            # the first chunk's two K are done
            raise RuntimeError("killed mid-bootstrap")
        return real(*a, **k)

    monkeypatch.setattr(bs, "fit_lattice", dying)
    with pytest.raises(RuntimeError, match="killed"):
        run(checkpoint_dir=str(tmp_path))
    assert ckpt.load_bootstrap(str(tmp_path), 1, 2, 6, 11).tolist() == \
        ref.ts_bs[:2]
    monkeypatch.setattr(bs, "fit_lattice", real)
    res = run(checkpoint_dir=str(tmp_path))
    assert res.ts_bs == ref.ts_bs and res.pvalue == ref.pvalue

    monkeypatch.setattr(bs, "fit_lattice", dying)
    res = run(checkpoint_dir=str(tmp_path))   # nothing left to fit
    assert res.ts_bs == ref.ts_bs and res.pvalue == ref.pvalue
    # another seed's checkpoint is not this run's
    assert ckpt.load_bootstrap(str(tmp_path), 1, 2, 6, 12) is None


def test_bootstrap_checkpoint_serial_path(tmp_path, rng):
    """The same on the serial replicate loop (-t / -u / -v > 3): killed
    after one replicate, resumed to the identical statistics."""
    md, opt, npar, est = _bootstrap_setup(rng)
    opt.n_bootstrap = 3
    opt.verbosity = 4          # per-iteration traces: the serial regime

    def run(**kw):
        return bs.run_bootstrap(5, md, opt, npar, est.ts, est.h0_params, 2,
                                **kw)
    ref = run()
    assert ref.chunk == 0

    def dying_log(rep, ts, ntime):
        if rep >= 1:
            raise RuntimeError("killed mid-bootstrap")

    with pytest.raises(RuntimeError, match="killed"):
        run(log=dying_log, checkpoint_dir=str(tmp_path))
    res = run(checkpoint_dir=str(tmp_path))
    assert res.ts_bs == ref.ts_bs and res.pvalue == ref.pvalue


# ---------------------------------------------------------------------------
# the -v > 3 trace and the -w harness against the JAX CLI

def _write_structure(ds, path):
    with open(path, "w") as fh:
        fh.write(" ".join(f"loc{l}" for l in range(ds.L)) + "\n")
        for i in range(ds.I):
            for a in range(ds.ploidy):
                fh.write(f"ind{i} pop{i % 2} "
                         + " ".join(map(str, ds.IL[i * ds.ploidy + a]))
                         + "\n")


def _warm_files(tmp_path, I=60, L=80, K=3):
    rng = np.random.default_rng(1)
    Q = rng.dirichlet(np.full(K, 0.3), size=I)
    p0 = rng.choice([0.1, 0.5, 0.9], size=(K, L))
    ds = simulate_admixture_fast(rng, Q, np.stack([p0, 1 - p0], axis=2),
                                 missing_rate=0.05)
    data = str(tmp_path / "sim.str")
    _write_structure(ds, data)
    p0w = rng.uniform(0.2, 0.8, size=(K, L))
    qf, pf = str(tmp_path / "w.q"), str(tmp_path / "w.p")
    np.savetxt(qf, rng.dirichlet(np.full(K, 2.0), size=I), fmt="%.17g")
    np.savetxt(pf, p0w.T, fmt="%.17g")
    return ["-f", data, "-a", "-k", str(K), "-n", "1", "-Q", qf, "-P", pf,
            "--platform", "cpu"]


TRACE = re.compile(r"^\s*(\d+) \((\w+)\): (-?[\d.]+) \(delta\): (\S+)$")


@pytest.mark.parametrize("accel", [[], ["-s", "1"]])
def test_cli_trace_matches_jax(tmp_path, capsys, accel):
    """-v 4 prints one line per EM step with the reference's format; from
    a -Q/-P warm start the port's lines are the JAX CLI's, numerically.
    Under SQUAREM a jump that backtracked to s = -1 is the EM iterate
    itself, so its accept test (ll > emll) is a tie decided by rounding and
    the two packages may label that point differently; every number
    agrees all the same."""
    from multiclust_tpu.cli import main as jax_main
    from multiclust_tpu_torch.cli import main

    argv = _warm_files(tmp_path) + ["-v", "4", "-T", "60"] + accel
    lines = {}
    for name, entry in (("jax", jax_main), ("torch", main)):
        d = tmp_path / name
        d.mkdir()
        assert entry(argv + ["-d", str(d)]) == 0
        lines[name] = [TRACE.match(ln).groups()
                       for ln in capsys.readouterr().err.splitlines()
                       if TRACE.match(ln)]
    j, t = lines["jax"], lines["torch"]
    assert len(t) == len(j) > 10
    assert [ln[0] for ln in t] == [ln[0] for ln in j]
    kinds = sum(a[1] != b[1] for a, b in zip(t, j))
    if accel:
        assert sum(ln[1] == "S1" for ln in t) > 5 and kinds <= len(t) // 20
    else:
        assert {ln[1] for ln in t} == {"EM"} and not kinds
    np.testing.assert_allclose([float(ln[2]) for ln in t],
                               [float(ln[2]) for ln in j], rtol=0,
                               atol=0.0101)
    np.testing.assert_allclose([float(ln[3]) for ln in t[1:]],
                               [float(ln[3]) for ln in j[1:]], rtol=1e-3,
                               atol=1e-6)


def test_cli_timing_harness_matches_jax(tmp_path, capsys):
    """-w n 2 prints the JAX CLI's summary lines; from a warm start every
    number but the times is the JAX CLI's."""
    from multiclust_tpu.cli import main as jax_main
    from multiclust_tpu_torch.cli import main

    argv = _warm_files(tmp_path) + ["-w", "n", "2"]
    out = {}
    for name, entry in (("jax", jax_main), ("torch", main)):
        assert entry(argv) == 0
        out[name] = [ln for ln in capsys.readouterr().out.splitlines()
                     if not ln.startswith("Average time")]
    assert len(out["torch"]) == len(out["jax"]) == 7
    number = re.compile(r"-?\d+\.?\d*(?:e[-+]\d+)?")
    for t, j in zip(out["torch"], out["jax"]):
        assert number.sub("#", t) == number.sub("#", j)
        np.testing.assert_allclose(
            [float(v) for v in number.findall(t)],
            [float(v) for v in number.findall(j)], rtol=1e-8, atol=1e-6)
    assert "Number of repetitions: 2 of 2 requested" in out["torch"][1]


def test_trace_printer():
    import io

    from multiclust_tpu_torch.runtime.observe import make_trace_printer

    assert make_trace_printer(3) is None      # MINIMAL gates it off
    buf = io.StringIO()
    tr = make_trace_printer(4, out=buf)
    tr(-100.0, 1, "EM")
    tr(-90.0, 2, "S1")
    lines = buf.getvalue().splitlines()
    assert lines[0] == "   1 (EM): -100.00 (delta): inf"
    assert lines[1] == "   2 (S1): -90.00 (delta): 10"
