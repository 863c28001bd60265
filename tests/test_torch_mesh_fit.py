"""Meshed fits of the port (runtime/mesh.py over torch.distributed) against
its unsharded fits, on the CPU in float64 over gloo: plain EM and SQUAREM
from a JAX-drawn warm start on 2x1 and 1x2 meshes, ``--mesh 2x1`` through
the CLI in two processes, and the bootstrap's meshed lattices.  The worker
processes are those of tests/test_torch_mesh.py; the cases below register
their kinds with it (``CASES_ELSEWHERE``), and the workers import this
module, which loads no JAX at import.
"""

import os
import re

import numpy as np
import torch

from test_torch_mesh import CASES_ELSEWHERE, biallelic_panel, run_group

K = 3


def _opt(case, mesh):
    from multiclust_tpu_torch.config import AccelScheme, InitMethod, \
        InitProcedure, Options

    I, _ = case["miss"].shape  # noqa: E741
    return Options(
        admixture=case.get("admixture", True),
        eta_constrained=case.get("constrained", False),
        initialization_method=InitMethod(case.get("method", 1)),
        initialization_procedure=InitProcedure(case.get("procedure", 0)),
        n_rand_em_init=case.get("n_rand", 3),
        min_K=K, max_K=K, n_init=case.get("n_init", 1),
        max_iter=case.get("max_iter", 0),
        dtype="float64", use_pallas=True, seed=case.get("seed", 1),
        accel_scheme=AccelScheme(case.get("accel", 0)),
        adjust_step=case.get("adjust", 0),
        n_bootstrap=case.get("n_bootstrap", 0), verbosity=0,
        mesh_shape=None if mesh is None else mesh.shape).synchronize(I, 2)


def _model_data(case):
    from multiclust_tpu_torch.model.common import make_model_data

    return make_model_data(case["counts"], case["miss"], case["mask"],
                           case["n_alleles"], dtype=torch.float64,
                           device="cpu")


def fit_case(case, mesh=None):
    """A multi-start fit at K from the case's warm start, or from starts
    drawn from a seed without one: its logL, iterations and whole best
    parameters."""
    from multiclust_tpu_torch.model.common import Params
    from multiclust_tpu_torch.runtime.multistart import maximize_likelihood

    md = _model_data(case)
    warm = None
    if "eta" in case:
        warm = Params(eta=torch.tensor(case["eta"]),
                      p=torch.tensor(case["p"]))
    res = maximize_likelihood(torch.Generator().manual_seed(1), md, K,
                              _opt(case, mesh), 100, warm=warm)
    return dict(logL=res.max_logL, n_iter=res.n_iter_all,
                eta=res.best_params.eta.numpy(),
                p=res.best_params.p.numpy())


def start_case(case, mesh=None):
    """Starts drawn from one seed (each rank its block, gathered): the
    admixture's allele partitions and centers (shared eta under -c), the
    mixture's individual partitions and centers, and a Rand-EM start."""
    from multiclust_tpu_torch.config import InitMethod, InitProcedure
    from multiclust_tpu_torch.init import random as rinit
    from multiclust_tpu_torch.runtime import mesh as mesh_mod
    from multiclust_tpu_torch.runtime import multistart as ms

    md = _model_data(case)
    out = {}
    for admix, constrained in ((True, False), (True, True), (False, False)):
        opt = _opt(dict(case, admixture=admix, constrained=constrained),
                   mesh)
        cfg = ms.cfg_from_options(opt, K, md)
        _, md_score = ms._fit_data(md, cfg, None)
        for method, procedure in ((InitMethod.RANDOM_PARTITION,
                                   InitProcedure.NOTHING),
                                  (InitMethod.RANDOM_CENTERS,
                                   InitProcedure.NOTHING),
                                  (InitMethod.RANDOM_CENTERS,
                                   InitProcedure.RAND_EM)):
            start = rinit.initialize(
                torch.Generator().manual_seed(5), md, K, cfg, method,
                procedure, n_rand_em_init=3, md_score=md_score)
            if mesh is not None:
                start = mesh_mod.gather_params(start, mesh, md.I, md.L,
                                               admix and not constrained)
            out[admix, constrained, int(method), int(procedure)] = (
                start.eta.numpy(), start.p.numpy())
    return out


def bootstrap_case(case, mesh=None):
    """``-b`` through the API: the observed statistic and each replicate's
    (the replicates drawn whole and fitted as meshed lattices)."""
    from multiclust_tpu_torch.api import fit_model_data

    out = fit_model_data(_model_data(case), 2, _opt(case, mesh))
    return dict(ts=out.estimate.ts, ts_bs=out.bootstrap.ts_bs)


def cli_case(case, mesh=None):
    """The CLI on the case's file; process 0 writes into its out dir."""
    from multiclust_tpu_torch.cli import main

    argv = list(case["argv"])
    if mesh is not None:
        argv += ["--mesh", f"{mesh.shape[0]}x{mesh.shape[1]}"]
    assert main(argv + ["-d", case["out"][mesh is not None]]) == 0
    return {}


CASES_ELSEWHERE.update(fit=fit_case, bootstrap=bootstrap_case, cli=cli_case,
                       start=start_case)




def _jax_warm(counts, miss, seed):
    """A start drawn by the JAX package's init (numpy arrays)."""
    import jax
    import jax.numpy as jnp

    from multiclust_tpu.init.random import codes_from_counts, initialize
    from multiclust_tpu.model.common import EMConfig, ModelData

    md = ModelData(x=jnp.asarray(counts, jnp.float64),
                   miss=jnp.asarray(miss, jnp.float64),
                   mask=jnp.ones((counts.shape[1], 2), bool),
                   n_alleles=jnp.full((counts.shape[1],), 2, jnp.int32))
    codes = jnp.asarray(codes_from_counts(counts, miss, 2))
    start = initialize(jax.random.PRNGKey(seed), md, K,
                       EMConfig(admixture=True), codes=codes)
    return np.asarray(start.eta), np.asarray(start.p)


def _fit_cases():
    counts, miss, mask, n_all = biallelic_panel(11, 60, 50, 0.05)
    eta, p = _jax_warm(counts, miss, 4)
    base = dict(counts=counts, miss=miss, mask=mask, n_alleles=n_all,
                eta=eta, p=p, kind="fit")
    drawn = {k: base[k] for k in ("counts", "miss", "mask", "n_alleles")}
    return [dict(base, name="plain"),
            dict(base, name="squarem", accel=1, adjust=2),
            # starts drawn on each rank's block, Rand-EM scored meshed
            dict(drawn, kind="fit", name="drawn", n_init=2, procedure=1,
                 max_iter=60),
            dict(drawn, kind="fit", name="drawn_mixture", n_init=2,
                 admixture=False, max_iter=60),
            dict(drawn, kind="start", name="starts")]


def _check_fits(results, cases):
    for case in cases:
        got = [r[case["name"]] for r in results]
        if case["kind"] == "start":
            # the blocks of the unsharded starts, bit for bit
            want = start_case(case)
            for g in got:
                assert g.keys() == want.keys()
                for key, (eta, p) in want.items():
                    np.testing.assert_array_equal(g[key][0], eta, str(key))
                    np.testing.assert_array_equal(g[key][1], p, str(key))
            continue
        want = fit_case(case)
        for g in got:
            assert g["n_iter"] == want["n_iter"]
            np.testing.assert_allclose(g["logL"], want["logL"], rtol=1e-8)
            if case.get("accel"):
                # SQUAREM's jumps carry the rounding of its dot products'
                # order into the parameters (1e-5 here), within the
                # convergence tolerance: iterations and logL decide
                continue
            np.testing.assert_allclose(g["eta"], want["eta"], rtol=1e-10,
                                       atol=1e-13)
            np.testing.assert_allclose(g["p"], want["p"], rtol=1e-10,
                                       atol=1e-13)


def _write_structure(counts, path):
    """Two lines an individual, allele indices 1/2, -9 missing."""
    I, L, _ = counts.shape  # noqa: E741
    with open(path, "w") as fh:
        fh.write(" ".join(f"loc{j}" for j in range(L)) + "\n")
        for i in range(I):
            for a in range(2):
                row = ["1" if counts[i, j, 0] > a else
                       "2" if counts[i, j, 0] + counts[i, j, 1] > a else
                       "-9" for j in range(L)]
                fh.write(f"ind{i} pop{i % 2} " + " ".join(row) + "\n")


NUMBER = r"-?\d+\.\d+(?:e[-+]\d+)?|-?\d+"


def _compare_outputs(one, two):
    names = sorted(os.listdir(one))
    assert names and names == sorted(os.listdir(two))
    for name in names:
        with open(os.path.join(one, name)) as fh:
            a = fh.read()
        with open(os.path.join(two, name)) as fh:
            b = fh.read()
        assert re.sub(NUMBER, "#", a) == re.sub(NUMBER, "#", b), name
        np.testing.assert_allclose(
            np.array([float(v) for v in re.findall(NUMBER, a)]),
            np.array([float(v) for v in re.findall(NUMBER, b)]),
            rtol=1e-6, atol=1e-9, err_msg=name)


PART = re.compile(r"^(.*)\.part(\d+)(\.txt)?$")


def join_parts(src, dst):
    """Copy the files of a meshed run's out dir ``src`` into ``dst``, each
    table's ``.part<d>`` row blocks joined in data-index order under the
    single-process file's name (the JAX package's layout)."""
    os.makedirs(dst)
    parts = {}
    for name in os.listdir(src):
        m = PART.match(name)
        if m is None:
            with open(os.path.join(src, name)) as fh, \
                    open(os.path.join(dst, name), "w") as out:
                out.write(fh.read())
            continue
        parts.setdefault(m.group(1) + (m.group(3) or ""), []).append(
            (int(m.group(2)), name))
    for whole, names in parts.items():
        with open(os.path.join(dst, whole), "w") as out:
            for _, name in sorted(names):
                with open(os.path.join(src, name)) as fh:
                    out.write(fh.read())


def test_mesh_2x1_fits_cli_and_bootstrap(tmp_path):
    """Plain EM and SQUAREM fits on a 2x1 mesh reach the unsharded fit's
    iterations and logL; ``--mesh 2x1`` in two processes writes the files
    of a single-process run, the per-individual tables as row-block parts
    that join into them; the bootstrap's statistics are the unsharded
    run's."""
    from multiclust_tpu_torch.cli import main

    counts, miss, mask, n_all = biallelic_panel(12, 40, 30, 0.05)
    data = str(tmp_path / "sim.str")
    _write_structure(counts, data)
    outs = [str(tmp_path / "single"), str(tmp_path / "meshed")]
    for d in outs:
        os.makedirs(d)
    argv = ["-f", data, "-a", "-k", str(K), "-n", "2", "-E", "1e-3",
            "--platform", "cpu"]
    cli = dict(name="cli", kind="cli", argv=argv, out=outs)
    boot = dict(name="boot", kind="bootstrap", counts=counts, miss=miss,
                mask=mask, n_alleles=n_all, n_bootstrap=2, n_init=2,
                seed=5, max_iter=40)
    fits = _fit_cases()
    results = run_group(tmp_path, (2, 1), fits + [cli, boot],
                        fit_module="test_torch_mesh_fit")
    _check_fits(results, fits)

    assert main(argv + ["-d", outs[0]]) == 0
    joined = str(tmp_path / "joined")
    join_parts(outs[1], joined)
    _compare_outputs(outs[0], joined)

    want = bootstrap_case(boot)
    for r in results:
        np.testing.assert_allclose(r["boot"]["ts"], want["ts"], rtol=1e-8)
        np.testing.assert_allclose(r["boot"]["ts_bs"], want["ts_bs"],
                                   rtol=1e-6)


def test_mesh_1x2_fits(tmp_path):
    """The same fits with the loci split: p is split, eta whole on both
    ranks, so SQUAREM's dot products sum eta's part over the data group
    only."""
    fits = _fit_cases()
    results = run_group(tmp_path, (1, 2), fits,
                        fit_module="test_torch_mesh_fit")
    _check_fits(results, fits)
