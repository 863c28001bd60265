"""Per-process ingest and the sharded writers of a meshed run
(runtime/ingest.py) on the CPU in float64 over gloo: the JAX package's
two-process cases (tests/test_distributed.py) through the port's CLI, each
held to the port's single-process run of the same file, and the ingest
itself held to the JAX package's whole-file reader.

The workers are those of tests/test_torch_mesh.py (this file registers its
kinds of case in ``CASES_ELSEWHERE``), one group of processes a mesh shape.
Every rank of a CLI case reads its block through a spy that fails the case
if the whole-file reader runs.
"""

import contextlib
import io
import os
import re

import numpy as np
import torch

from test_torch_mesh import CASES_ELSEWHERE, run_group
from test_torch_mesh_fit import NUMBER, _compare_outputs, join_parts

K = 2


# ---------------------------------------------------------------------------
# the port side (runs in the workers)


class _Killed(Exception):
    """Raised on every rank after the first bootstrap checkpoint."""


@contextlib.contextmanager
def _patched(module, name, fn):
    saved = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, saved)


def cli_case(case, mesh):
    """The CLI on ``--mesh DxM`` (``{rank}`` in an argument becomes the
    rank): its exit, its stdout, and the whole-file reads it made."""
    from multiclust_tpu_torch.cli import main
    from multiclust_tpu_torch.io import structure
    from multiclust_tpu_torch.stats import bootstrap

    reads = []

    def whole_read(*a, **kw):
        reads.append(a[:1])
        raise AssertionError("the whole-file reader ran in a meshed run")

    save = bootstrap._save_bootstrap_synced

    def save_then_die(*a, **kw):
        save(*a, **kw)
        raise _Killed()

    argv = [a.replace("{rank}", str(mesh.rank)) for a in case["argv"]]
    argv += ["--mesh", f"{mesh.shape[0]}x{mesh.shape[1]}"]
    out = {"exit": None, "killed": False}
    buf = io.StringIO()
    with contextlib.ExitStack() as stack:
        stack.enter_context(_patched(structure, "read_structure", whole_read))
        stack.enter_context(_patched(structure, "read_structure_raw",
                                     whole_read))
        if case.get("chunk1"):
            stack.enter_context(_patched(bootstrap, "replicate_chunk",
                                         lambda *a, **kw: 1))
        if case.get("kill"):
            stack.enter_context(_patched(bootstrap, "_save_bootstrap_synced",
                                         save_then_die))
        stack.enter_context(contextlib.redirect_stdout(buf))
        try:
            out["exit"] = main(argv)
        except SystemExit as e:
            out["exit"] = str(e.code)
        except _Killed:
            out["killed"] = True
    out["stdout"] = buf.getvalue()
    out["whole_reads"] = len(reads)
    return out


def read_case(case, mesh):
    """This rank's ingest of the case's file: its ModelData as host arrays,
    its block and the side information."""
    from multiclust_tpu_torch.config import Options
    from multiclust_tpu_torch.runtime.ingest import \
        load_structure_distributed

    opt = Options(alleles_are_indices=case["indices"],
                  imputation_method=int(case["impute"]))
    md, info = load_structure_distributed(case["path"], opt, mesh,
                                          dtype=torch.float64)
    ds = info.ds_local
    return dict(x=md.x.numpy(), miss=md.miss.numpy(), c=md.c.numpy(),
                n_alleles=md.n_alleles.numpy(), block=tuple(md.block),
                rows_parsed=len(ds.names), lo=info.lo, hi=info.hi,
                I_total=info.I_total, global_n_alleles=info.n_alleles,
                miss_any=info.miss_any,
                L_alleles=(None if ds.L_alleles is None
                           else [np.asarray(a) for a in ds.L_alleles]))


CASES_ELSEWHERE.update(ingest_cli=cli_case, ingest_read=read_case)


# ---------------------------------------------------------------------------
# files


def snp_file(path, I=64, L=32, seed=3):  # noqa: E741
    """Two lines an individual, alleles 0/1, 5 % missing, two sampling
    locales that alternate (both span every row block); the true partition
    beside it as ``path.afile``."""
    rng = np.random.default_rng(seed)
    pop = rng.integers(0, 2, I)
    freq = np.where(pop[:, None] == 0, 0.85, 0.15) * np.ones((1, L))
    with open(path, "w") as fh:
        fh.write(" ".join(f"l{j}" for j in range(L)) + "\n")
        for i in range(I):
            for _ in range(2):
                hap = rng.binomial(1, freq[i])
                hap = np.where(rng.random(L) < 0.05, -9, hap)
                fh.write(f"i{i} p{i % 2} " + " ".join(map(str, hap))
                         + "\n")
    with open(path + ".afile", "w") as fh:
        fh.write(" ".join(str(p + 1) for p in pop))
    return path


def microsat_file(path, I=64, L=12):  # noqa: E741
    """A label-coded panel (fragment lengths 120..132): label 132 only in
    the second half of the rows, so a rank-local vocabulary would number
    the slots wrong."""
    rng = np.random.default_rng(23)
    with open(path, "w") as fh:
        fh.write(" ".join(f"loc{j}" for j in range(L)) + "\n")
        for i in range(I):
            for _ in range(2):
                top = 4 if i >= I // 2 else 3
                hap = [120 + 4 * int(rng.integers(0, top)) for _ in range(L)]
                if rng.random() < 0.3:
                    hap[int(rng.integers(0, L))] = -9
                fh.write(f"ind{i} pop{i % 2} " + " ".join(map(str, hap))
                         + "\n")
    return path


def warm_files(tmp_path, I=64, L=32):  # noqa: E741
    rng = np.random.default_rng(11)
    q, p = str(tmp_path / "warm.q"), str(tmp_path / "warm.p")
    with open(q, "w") as fh:
        fh.write("\n".join(" ".join(f"{v:.6f}" for v in row)
                           for row in rng.dirichlet(np.full(K, 2.0),
                                                    size=I)))
    with open(p, "w") as fh:
        fh.write("\n".join(" ".join(f"{v:.6f}" for v in row)
                           for row in rng.uniform(0.2, 0.8, size=(L, K))))
    return q, p


# ---------------------------------------------------------------------------
# the single-process runs and the comparisons (in this process)


def run_single(argv, out_dir=None):
    """The port's single-process CLI: its stdout."""
    from multiclust_tpu_torch.cli import main

    buf = io.StringIO()
    extra = []
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        extra = ["-d", out_dir]
    with contextlib.redirect_stdout(buf):
        assert main(argv + extra) == 0
    return buf.getvalue()


def _numbers_close(a, b, what):
    assert re.sub(NUMBER, "#", a) == re.sub(NUMBER, "#", b), what
    np.testing.assert_allclose(
        np.array([float(v) for v in re.findall(NUMBER, a)]),
        np.array([float(v) for v in re.findall(NUMBER, b)]),
        rtol=1e-6, atol=1e-9, err_msg=what)


def _lines(text, prefixes):
    return "\n".join(ln for ln in text.splitlines()
                     if ln.startswith(prefixes))


def _compact(text, data):
    """The compact record's fields without its wall clock."""
    name = os.path.basename(data)
    for ln in text.splitlines():
        if ln.split() and ln.split()[0].endswith(name):
            return " ".join(ln.split()[:14])
    raise AssertionError(f"no compact record in:\n{text[-2000:]}")


def check_files(one, meshed, tmp_path, name):
    """The meshed run's parts, joined in data-index order, and rank 0's
    files against the single-process files."""
    joined = str(tmp_path / f"joined_{name}")
    join_parts(meshed, joined)
    _compare_outputs(one, joined)


def cli_cases(tmp_path, shape):
    """The CLI cases of a mesh ``shape`` and their single-process argv:
    (name, argv, extra case fields)."""
    D, M = shape
    tag = f"{D}x{M}"
    snp = snp_file(str(tmp_path / f"snp_{tag}.str"))
    micro = microsat_file(str(tmp_path / f"micro_{tag}.str"))
    base = ["--platform", "cpu", "-a", "-k", str(K)]
    cases = [("outputs", ["-f", snp, "-I", "-n", "2", "-A", snp + ".afile"]
              + base, {}),
             ("label", ["-f", micro, "-n", "2"] + base, {}),
             ("mixture", ["-f", snp, "-I", "-n", "2", "-A", snp + ".afile",
                          "--platform", "cpu", "-k", str(K)], {})]
    if shape != (2, 1):
        return cases
    snp61 = snp_file(str(tmp_path / "snp61.str"), I=61, seed=5)
    q, p = warm_files(tmp_path)
    boot = ["-f", snp, "-I", "-n", "1", "-b", "3", "-T", "60"] + base
    ck = str(tmp_path / "ck{rank}")
    cases += [
        ("uneven", ["-f", snp61, "-I", "-n", "2", "-A", snp61 + ".afile"]
         + base, {}),
        ("warm", ["-f", snp, "-I", "-Q", q, "-P", p] + base, {}),
        ("impute", ["-f", snp, "-I", "-n", "2", "--impute",
                    str(tmp_path / "imp_meshed.str")] + base, {}),
        ("boot", boot, {}),
        ("boot_killed", boot + ["--checkpoint", ck], dict(chunk1=True,
                                                          kill=True)),
        ("boot_resumed", boot + ["--checkpoint", ck], dict(chunk1=True)),
        ("timing", ["-f", snp, "-I", "-n", "2", "-w", "n", "2", "-A",
                    snp + ".afile"] + base, {}),
        ("refused", ["-f", snp, "-I", "--checkpoint",
                     str(tmp_path / "ck_sweep")] + base, {}),
    ]
    return cases


def read_cases(tmp_path, shape):
    tag = f"{shape[0]}x{shape[1]}"
    snp = snp_file(str(tmp_path / f"snp_read_{tag}.str"), I=61)
    micro = microsat_file(str(tmp_path / f"micro_read_{tag}.str"), I=61)
    return [dict(name=f"read_{kind}_{int(imp)}", kind="ingest_read",
                 path=path, indices=kind == "snp", impute=imp)
            for kind, path in (("snp", snp), ("micro", micro))
            for imp in (False, True)]


def check_reads(results, cases, shape):
    """The rank blocks joined together against the JAX package's
    whole-file reader: counts, miss and L_alleles; each rank's rows parsed
    and ModelData shapes are its block's."""
    from multiclust_tpu.config import Options as JaxOptions
    from multiclust_tpu.io.structure import read_structure as jax_read
    from multiclust_tpu_torch.runtime.mesh import block

    D, M = shape
    for case in cases:
        want = jax_read(case["path"], JaxOptions(
            alleles_are_indices=case["indices"],
            imputation_method=int(case["impute"])))
        I, L = want.miss.shape  # noqa: E741
        Mw = want.counts.shape[2]
        x = np.full((I, L, Mw), -1.0)
        miss = np.full((I, L), -1.0)
        for r, res in enumerate(results):
            got = res[case["name"]]
            d, m = divmod(r, M)
            r0, r1 = block(I, D, d)
            l0, l1 = block(L, M, m)
            assert got["block"] == (I, L, r0, l0)
            assert (got["lo"], got["hi"]) == (r0, r1)
            assert got["rows_parsed"] == r1 - r0
            assert got["x"].shape == (r1 - r0, l1 - l0, Mw)
            x[r0:r1, l0:l1] = got["x"]
            miss[r0:r1, l0:l1] = got["miss"]
            np.testing.assert_array_equal(got["c"], want.miss[r0:r1].sum(1))
            np.testing.assert_array_equal(got["n_alleles"],
                                          want.n_alleles[l0:l1])
            np.testing.assert_array_equal(got["global_n_alleles"],
                                          want.n_alleles)
            np.testing.assert_array_equal(got["miss_any"],
                                          want.miss.any(axis=0))
            if case["indices"]:
                assert got["L_alleles"] is None
            else:
                assert len(got["L_alleles"]) == L
                for a, b in zip(got["L_alleles"], want.L_alleles):
                    np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(x, want.counts)
        np.testing.assert_array_equal(miss, want.miss)


def run_mesh(tmp_path, shape, names, reads=True):
    """Run the shape's CLI cases ``names`` (and its read cases) in one
    group of workers; returns (results, the CLI cases, the meshed runs'
    out dir of each)."""
    clis = [c for c in cli_cases(tmp_path, shape) if c[0] in names]
    reads = read_cases(tmp_path, shape) if reads else []
    tag = f"{shape[0]}x{shape[1]}"
    worker_cases, outs = [], {}
    for name, argv, extra in clis:
        outs[name] = str(tmp_path / f"meshed_{tag}_{name}")
        os.makedirs(outs[name])
        worker_cases.append(dict(name=name, kind="ingest_cli",
                                 argv=argv + ["-d", outs[name]], **extra))
    results = run_group(tmp_path, shape, worker_cases + reads,
                        fit_module="test_torch_ingest")
    for r in results:
        for name, _, _ in clis:
            assert r[name]["whole_reads"] == 0, (name, r[name])
    check_reads(results, reads, shape)
    return results, clis, outs


def check_cli_files(tmp_path, results, clis, outs, names):
    """Each named case's joined parts against the single-process files,
    and its compact record (the adjusted Rand index with it)."""
    argvs = {name: argv for name, argv, _ in clis}
    for name in names:
        one = str(tmp_path / f"single_{os.path.basename(outs[name])}")
        os.makedirs(one)
        text = run_single(argvs[name], one)
        check_files(one, outs[name], tmp_path, os.path.basename(outs[name]))
        data = argvs[name][argvs[name].index("-f") + 1]
        for r in results:
            assert r[name]["exit"] == 0, r[name]
            _numbers_close(_compact(r[name]["stdout"], data),
                           _compact(text, data), name)


def test_ingest_2x1_outputs(tmp_path):
    """2x1: sharded outputs with -A (admixture and mixture), uneven blocks
    (I = 61), a warm start, a label-coded panel and --impute; the rank
    blocks against the JAX reader."""
    names = ("outputs", "mixture", "uneven", "warm", "label", "impute")
    results, clis, outs = run_mesh(tmp_path, (2, 1), names)
    argvs = {name: argv for name, argv, _ in clis}
    check_cli_files(tmp_path, results, clis, outs, names)

    # the imputed data's parts, joined, are the single-process file
    single_imp = str(tmp_path / "imp_single.str")
    run_single([single_imp if a.endswith("imp_meshed.str") else a
                for a in argvs["impute"]], str(tmp_path / "imp_out"))
    with open(single_imp) as fh:
        want = fh.read()
    whole = ""
    for d in range(2):
        with open(str(tmp_path / f"imp_meshed.str.part{d}")) as fh:
            whole += fh.read()
    assert whole == want


def test_ingest_2x1_bootstrap_and_harness(tmp_path):
    """2x1: -b, -b --checkpoint killed after the first chunk and resumed,
    -w with -A, and the K-sweep checkpoint's refusal."""
    import ast
    import inspect

    import multiclust_tpu.cli as jax_cli
    from multiclust_tpu_torch.api import CHECKPOINT_REFUSAL
    from multiclust_tpu_torch.cli import UsageError

    results, clis, _ = run_mesh(
        tmp_path, (2, 1),
        ("boot", "boot_killed", "boot_resumed", "timing", "refused"),
        reads=False)
    argvs = {name: argv for name, argv, _ in clis}

    # -b: the statistics and the p-value of the single-process run; a run
    # killed after its first chunk resumes to them from rank 0's
    # checkpoint (rank 1's directory stays empty)
    lines = ("Bootstrap dataset", "p-value")
    ref = _lines(run_single(argvs["boot"], str(tmp_path / "boot_out")),
                 lines)
    assert ref.count("Bootstrap dataset") == 3
    for r in results:
        _numbers_close(_lines(r["boot"]["stdout"], lines), ref, "boot")
        assert r["boot_killed"]["killed"]
        _numbers_close(_lines(r["boot_resumed"]["stdout"], lines), ref,
                       "boot resumed")
    assert os.listdir(tmp_path / "ck0")
    assert not os.path.exists(tmp_path / "ck1")

    # -w with -A: the summary's RAND of the single-process harness
    timing = ("Maximum log likelihood:", "Average log likelihood:")
    ref = _lines(run_single(argvs["timing"]), timing)
    for r in results:
        _numbers_close(_lines(r["timing"]["stdout"], timing), ref, "-w -A")

    # a multi-process K-sweep checkpoint is refused with the JAX text: the
    # literal of the JAX CLI's UsageError that names --checkpoint
    texts = [node.args[0].value for node in ast.walk(ast.parse(
        inspect.getsource(jax_cli)))
        if isinstance(node, ast.Call) and getattr(node.func, "id", "")
        == "UsageError" and node.args
        and isinstance(node.args[0], ast.Constant)
        and "--checkpoint" in str(node.args[0].value)]
    assert texts == [CHECKPOINT_REFUSAL]
    for r in results:
        assert r["refused"]["exit"] == UsageError(CHECKPOINT_REFUSAL).code
    assert not os.path.exists(tmp_path / "ck_sweep")


def test_ingest_2x2(tmp_path):
    """2x2: rows and loci split; the outputs of an admixture and a mixture
    fit with -A and of a label-coded panel, and the ingest's blocks."""
    names = ("outputs", "label", "mixture")
    results, clis, outs = run_mesh(tmp_path, (2, 2), names)
    check_cli_files(tmp_path, results, clis, outs, names)
