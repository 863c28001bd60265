"""The port stands alone: it imports nothing of the JAX package, and its
own copies of the host layer (options, parser, readers, writers,
simulators, statistics) behave as the originals do.

The first test proves the cut at run time, in a process whose import path
holds ``multiclust_tpu_torch`` and not ``multiclust_tpu``; the others hold
each copy to its original on the same inputs."""

import dataclasses
import filecmp
import os
import pkgutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import multiclust_tpu.cli as jcli
import multiclust_tpu.config as jconfig
import multiclust_tpu.io.structure as jstructure
import multiclust_tpu.io.warm_start as jwarm
import multiclust_tpu.io.writers as jwriters
import multiclust_tpu.model.likelihood as jlik
import multiclust_tpu.stats.rand_index as jrand
import multiclust_tpu.stats.sim as jsim
import multiclust_tpu_torch
import multiclust_tpu_torch.cli as tcli
import multiclust_tpu_torch.config as tconfig
import multiclust_tpu_torch.io.structure as tstructure
import multiclust_tpu_torch.io.warm_start as twarm
import multiclust_tpu_torch.io.writers as twriters
import multiclust_tpu_torch.model.likelihood as tlik
import multiclust_tpu_torch.stats.rand_index as trand
import multiclust_tpu_torch.stats.sim as tsim
from multiclust_tpu_torch.convert import dataset_from, options_from, \
    p0_from_padded, p0_to_padded

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        multiclust_tpu_torch.__path__, "multiclust_tpu_torch."))


def test_port_runs_without_the_jax_package(tmp_path):
    """A process that can see only the port imports every module of it,
    fits on the CPU through the API and through the CLI, and ends with
    neither jax nor multiclust_tpu among its modules."""
    site = tmp_path / "site"
    site.mkdir()
    os.symlink(os.path.join(REPO, "multiclust_tpu_torch"),
               site / "multiclust_tpu_torch")
    mods = _port_modules()
    assert "multiclust_tpu_torch.io.structure" in mods
    assert "multiclust_tpu_torch.stats.sim" in mods
    assert "multiclust_tpu_torch.model.bucketed" in mods
    assert "multiclust_tpu_torch.runtime.mesh" in mods
    assert "multiclust_tpu_torch.runtime.ingest" in mods
    code = textwrap.dedent(f"""
        import importlib, os, sys
        import numpy as np
        sys.path[:] = [p for p in sys.path
                       if os.path.abspath(p or '.') != {REPO!r}]
        for name in {mods!r}:
            importlib.import_module(name)
        import importlib.util
        assert importlib.util.find_spec("multiclust_tpu") is None
        from multiclust_tpu_torch.runtime.mesh import make_mesh
        assert make_mesh().shape == (1, 1)
        from multiclust_tpu_torch.api import fit_dataset
        from multiclust_tpu_torch.cli import main
        from multiclust_tpu_torch.config import Options
        from multiclust_tpu_torch.io.writers import write_data
        from multiclust_tpu_torch.stats.sim import random_model, \\
            simulate_admixture_fast
        rng = np.random.default_rng(0)
        eta, P = random_model(rng, 3, 40, 2)
        ds = simulate_admixture_fast(rng, rng.dirichlet(np.ones(3), size=30),
                                     P, missing_rate=0.05)
        out = fit_dataset(ds, device="cpu", admixture=True, min_K=2, max_K=2,
                          n_init=2, max_iter=20, dtype="float64", verbosity=0,
                          write_files=False)
        assert np.isfinite(out.best.max_logL)
        # a jagged panel (80 % of the loci with 2 alleles, the rest 8)
        # fits bucketed
        from multiclust_tpu_torch.convert import dataset_from_counts
        n_all = np.where(rng.random(100) < 0.8, 2, 8)
        counts = np.stack([rng.multinomial(2, (np.arange(8) < n) / n)
                           for _ in range(30) for n in n_all])
        jag = fit_dataset(dataset_from_counts(
            counts.reshape(30, 100, 8), np.zeros((30, 100), int), 2,
            n_alleles=n_all), device="cpu", admixture=True, min_K=2,
            max_K=2, n_init=1, max_iter=20, dtype="float64", verbosity=0,
            write_files=False)
        assert jag.best.buckets.startswith("2 buckets")
        path = os.path.join({str(tmp_path)!r}, "sim.str")
        write_data(Options(path={str(tmp_path)!r}), ds, path)
        assert main(["-f", path, "-a", "-k", "2", "-n", "2", "-T", "20",
                     "--platform", "cpu", "-d", {str(tmp_path)!r}]) == 0
        assert main(["-f", path, "-k", "2", "-n", "2", "-T", "20", "-s", "1",
                     "--platform", "cpu", "-d", {str(tmp_path)!r}]) == 0
        bad = sorted(m for m in sys.modules
                     if m in ("jax", "jaxlib", "multiclust_tpu")
                     or m.startswith(("jax.", "jaxlib.", "multiclust_tpu.")))
        assert not bad, bad
        print("standalone ok")
        """)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(site)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p and os.path.abspath(p) != REPO])
    done = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stdout + done.stderr
    assert "standalone ok" in done.stdout
    assert os.path.getsize(tmp_path / "sim.str.admix.K=2.out.txt") > 0
    assert os.path.getsize(tmp_path / "sim.str.mix.K=2.out.txt") > 0


def test_no_source_line_imports_the_jax_package():
    """No module of the port, nor the card-only tests, nor the smoke
    script, has an import of jax or of the JAX package."""
    import re
    pat = re.compile(r"^\s*(from|import)\s+(jax|multiclust_tpu)(\.|\s|$)")
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "tests", "test_torch_cuda.py")]
    for root, _, names in os.walk(os.path.join(REPO, "multiclust_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 30
    for path in files:
        with open(path) as fh:
            hits = [ln for ln in fh if pat.match(ln)]
        assert not hits, (path, hits)


ARGV_TABLE = [
    ["-f", "x.str"],
    ["-f", "x.str", "-a", "-k", "3"],
    ["-f", "x.str", "-a", "-c", "-1", "2", "-2", "5", "-n", "7", "-r", "11"],
    ["-f", "x.str", "-s", "1", "-g", "3", "-i", "2"],
    ["-f", "x.str", "-s", "5", "-e", "1e-6", "-E", "1e-3"],
    ["-f", "x.str", "-s", "6", "-T", "40", "-t", "2"],
    ["-f", "x.str", "--bound", "1e-6", "--projection", "--plus"],
    ["-f", "x.str", "-b", "10", "-k", "4", "-a"],
    ["-f", "x.str", "-m", "0", "-M", "-o", "tag", "-d", "out/"],
    ["-f", "x.str", "-m", "12", "-p", "4", "--missing", "-1", "-R"],
    ["-f", "x.str", "-I", "--impute", "imp.str", "--format", "ped"],
    ["-f", "x.str", "-I1", "--impute", "-v", "2"],
    ["-f", "x.str", "-u", "l", "-1234.5", "n", "3", "-v"],
    ["-f", "x.str", "-w", "n", "3", "t", "1", "m", "2"],
    ["-f", "x.str", "-Q", "q.txt", "-P", "p.txt", "-A", "a.txt", "-x", "-B"],
    ["-f", "x.str", "--mesh", "2x1", "--checkpoint", "ck", "--check-interval",
     "4", "--compile-cache", "off"],
    ["--simulate", "q.txt", "p.txt", "out.str", "-r", "5"],
    ["-f", "x.str", "-n", "0", "-C", "9"],
]


@pytest.mark.parametrize("argv", ARGV_TABLE, ids=lambda a: " ".join(a))
def test_parse_args_matches_the_jax_cli(argv):
    got, want = tcli.parse_args(list(argv)), jcli.parse_args(list(argv))
    assert isinstance(got, tconfig.Options)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    # and after synchronize, which resolves -s >= 4 and the bounds
    if not got.simulate:
        got_s = got.synchronize(50, got.ploidy)
        want_s = want.synchronize(50, want.ploidy)
        assert dataclasses.asdict(got_s) == dataclasses.asdict(want_s)
        assert got_s.accel_abbreviation == want_s.accel_abbreviation


@pytest.mark.parametrize("argv", [
    [], ["-f"], ["x.str"], ["-f", "x.str", "--format", "vcf"],
    ["-f", "x.str", "-u", "z"], ["-f", "x.str", "-p", "0"],
    ["-f", "x.str", "-w", "n", "0"], ["-f", "x.str", "-Z"],
], ids=lambda a: " ".join(a) or "(none)")
def test_parse_args_refuses_what_the_jax_cli_refuses(argv):
    with pytest.raises(jcli.UsageError) as want:
        jcli.parse_args(list(argv))
    with pytest.raises(tcli.UsageError) as got:
        tcli.parse_args(list(argv))
    assert str(got.value) == str(want.value)


def test_options_from_rebuilds_the_ports_enums():
    src = jconfig.Options(admixture=True, accel_scheme=jconfig.AccelScheme.SQS2,
                          initialization_method=jconfig.InitMethod(0),
                          output_format=jconfig.OutputFormat.PED, max_K=4)
    got = options_from(src)
    assert type(got) is tconfig.Options
    assert type(got.accel_scheme) is tconfig.AccelScheme
    assert type(got.initialization_method) is tconfig.InitMethod
    assert type(got.output_format) is tconfig.OutputFormat
    assert dataclasses.asdict(got) == dataclasses.asdict(src)
    assert tconfig.MISSING == jconfig.MISSING


def _panel(seed, I=24, L=30, M=3, missing_rate=0.1, package=tsim):
    rng = np.random.default_rng(seed)
    eta, P = package.random_model(rng, 3, L, M)
    return package.simulate_mixture(rng, eta, P, I=I,
                                    missing_rate=missing_rate)[0]


def _same_dataset(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f.name)
            assert x.dtype == y.dtype, f.name
        elif isinstance(x, list) and x and isinstance(x[0], np.ndarray):
            assert len(x) == len(y)
            for u, v in zip(x, y):
                np.testing.assert_array_equal(u, v, err_msg=f.name)
        else:
            assert x == y, f.name


@pytest.mark.parametrize("fn", ["simulate_mixture", "simulate_admixture",
                                "simulate_admixture_fast", "random_model"])
def test_simulators_draw_the_same(fn):
    outs = []
    for pkg in (jsim, tsim):
        rng = np.random.default_rng(5)
        eta, P = pkg.random_model(rng, 3, 20, 3)
        Q = rng.dirichlet(np.ones(3), size=15)
        if fn == "random_model":
            outs.append((eta, P))
        elif fn == "simulate_mixture":
            outs.append(pkg.simulate_mixture(rng, eta, P, I=15,
                                             missing_rate=0.1))
        else:
            outs.append((getattr(pkg, fn)(rng, Q, P, missing_rate=0.1),))
    for a, b in zip(*outs):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            _same_dataset(a, b)
            assert type(b).__module__ == "multiclust_tpu_torch.io.dataset"


def _write_raw(ds, path, header=True):
    with open(path, "w") as fh:
        if header:
            fh.write(" ".join(f"loc{l}" for l in range(ds.L)) + "\n")
        for i in range(ds.I):
            for a in range(ds.ploidy):
                fh.write(f"ind{i} pop{i % 3} "
                         + " ".join(map(str, ds.IL[i * ds.ploidy + a]))
                         + "\n")


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("kw", [dict(), dict(alleles_are_indices=True),
                                dict(imputation_method=1)],
                         ids=["plain", "indices", "impute"])
def test_read_structure_matches(tmp_path, monkeypatch, native, kw):
    """The port's reader, through its own build of the C++ tokenizer and
    through the pure-Python path, gives the JAX package's arrays."""
    from multiclust_tpu_torch.io import fastread
    ds = _panel(6)
    path = str(tmp_path / "d.str")
    _write_raw(ds, path)
    if native:
        if not fastread.available():
            pytest.skip("no host C++ compiler to build the tokenizer")
        built = [f for f in os.listdir(os.path.join(
            REPO, "multiclust_tpu_torch", "build"))
            if f.startswith("_structure_reader_")]
        assert built
    else:
        monkeypatch.setattr(fastread, "_load", lambda: None)
        assert not fastread.available()
    want = jstructure.read_structure(path, jconfig.Options(**kw))
    got = tstructure.read_structure(path, tconfig.Options(**kw))
    _same_dataset(dataset_from(want), got)
    assert got.n_parameters(3, True, False) == want.n_parameters(3, True,
                                                                 False)


def test_warm_start_readers_match(tmp_path):
    rng = np.random.default_rng(7)
    I, L, K = 9, 11, 3
    q = rng.dirichlet(np.ones(K), size=I)
    p = rng.uniform(0.1, 0.9, size=(L, K))
    a = rng.integers(0, K, size=I)
    qf, qv, pf, af = (str(tmp_path / n) for n in ("q", "qv", "p", "a"))
    np.savetxt(qf, q)
    np.savetxt(qv, q[0][None])
    np.savetxt(pf, p)
    np.savetxt(af, a, fmt="%d")
    for name, args in (("read_qfile", (qf, I, K, True)),
                       ("read_qfile", (qv, I, K, False)),
                       ("read_pfile", (pf, L, K)),
                       ("read_admixture_qfile", (qf,)),
                       ("read_admixture_pfile", (pf, K))):
        np.testing.assert_array_equal(getattr(twarm, name)(*args),
                                      getattr(jwarm, name)(*args))
    for u, v in zip(twarm.read_afile(af, I), jwarm.read_afile(af, I)):
        np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("admixture", [True, False], ids=["admix", "mix"])
@pytest.mark.parametrize("fmt", ["STRUCTURE", "PED"])
def test_writers_write_identical_files(tmp_path, admixture, fmt):
    """Every writer of the port, fed the same dataset and parameters,
    writes byte for byte what the JAX package's writer writes."""
    ds_j = _panel(8, package=jsim)
    ds_t = _panel(8, package=tsim)
    rng = np.random.default_rng(9)
    K = 3
    eta = (rng.dirichlet(np.ones(K), size=ds_j.I) if admixture
           else rng.dirichlet(np.ones(K)))
    p = rng.dirichlet(np.ones(ds_j.M), size=(K, ds_j.L)) * ds_j.mask
    p /= p.sum(axis=2, keepdims=True)
    mass = rng.dirichlet(np.ones(K), size=ds_j.I) * (
        ds_j.ploidy * ds_j.L if admixture else 1.0)
    dirs = {}
    for name, writers, config, ds in (("jax", jwriters, jconfig, ds_j),
                                      ("torch", twriters, tconfig, ds_t)):
        d = tmp_path / name
        d.mkdir()
        opt = config.Options(admixture=admixture, filename="data.str",
                             path=str(d) + "/",
                             output_format=config.OutputFormat[fmt])
        writers.write_file_detail(opt, ds, K, -1234.5678, True, 10.5, 20.25,
                                  np.array([5, 9, 10]), eta, p)
        writers.write_popq(opt, ds, K, mass / (ds.ploidy * ds.L)
                           if admixture else mass)
        indivq = (writers.admixture_indivq_mass(opt, ds, eta, mass)
                  if admixture else mass)
        writers.write_indivq(opt, ds, K, indivq)
        writers.write_data(opt, ds, str(d / "copy.out"))
        dirs[name] = d
    names = sorted(os.listdir(dirs["jax"]))
    assert names == sorted(os.listdir(dirs["torch"])) and len(names) >= 5
    match, mismatch, errors = filecmp.cmpfiles(dirs["jax"], dirs["torch"],
                                               names, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)


def test_table_writer_builds_from_the_ports_sources(tmp_path):
    """The native table writer is built from csrc/host into the port's own
    build directory, and writes what the Python loop writes."""
    from multiclust_tpu_torch.io import fastwrite
    if not fastwrite.available():
        pytest.skip("no host C++ compiler to build the table writer")
    ints = np.arange(12, dtype=np.int64).reshape(6, 2)
    vals = np.linspace(0, 1, 6).reshape(6, 1)
    path = str(tmp_path / "t.txt")
    fastwrite.write_table(path, "a\tb\tc\n", "\n", ints, vals)
    with open(path) as fh:
        text = fh.read()
    want = "a\tb\tc\n" + "".join(
        "%d\t%d\t%f\n" % (i, j, v) for (i, j), (v,) in zip(ints, vals)) + "\n"
    assert text == want
    built = os.listdir(os.path.join(REPO, "multiclust_tpu_torch", "build"))
    assert any(f.startswith("_table_writer_") for f in built)


@pytest.mark.parametrize("ll,n_par,n", [(-1234.5, 10, 50), (-9.25e6, 1234, 8192),
                                        (0.0, 1, 1)])
def test_information_criteria_match(ll, n_par, n):
    assert tlik.aic(ll, n_par) == jlik.aic(ll, n_par)
    assert tlik.bic(ll, n_par, n) == jlik.bic(ll, n_par, n)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_adjusted_rand_matches(seed):
    rng = np.random.default_rng(seed)
    a, b = rng.integers(0, 4, size=60), rng.integers(0, 3, size=60)
    assert trand.adjusted_rand(a, b) == jrand.adjusted_rand(a, b)
    assert trand.adjusted_rand(a, a) == 1.0
    for which in range(3):
        assert trand.agreement_index(a, b, which) == \
            jrand.agreement_index(a, b, which)


def test_p0_pad_columns_drop_and_restore():
    """A chunked or streamed JAX fit pads the loci of its p0 layout to its
    tile (pads zero); the port pads none."""
    rng = np.random.default_rng(3)
    p0 = rng.uniform(0.1, 0.9, size=(2, 32, 500))
    padded = p0_to_padded(p0, 512)
    assert padded.shape == (2, 32, 512) and (padded[..., 500:] == 0).all()
    np.testing.assert_array_equal(p0_from_padded(padded, 500), p0)
    with pytest.raises(ValueError):
        p0_to_padded(p0, 499)
