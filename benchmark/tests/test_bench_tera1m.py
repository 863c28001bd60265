"""The cell tera1m.admix_k6, the roofline of an admixture start's counts
and the two readers of the init's counts (``init_counts_roofline_pct``,
``init_windows_per_fit``): by hand, and on a traced run of the cell on
the CPU at a small size."""

import json

import pytest

from benchmark import harness
from benchmark.tests.helpers import run_small, small_cell

CELL = "tera1m.admix_k6"
NAMES = ("init_counts_roofline_pct", "init_windows_per_fit")
SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())


def test_the_cell_loads():
    cell = harness.load_cell(CELL)
    conf, traffic = cell.config, cell.traffic
    assert (conf["individuals"], conf["loci"], conf["alleles"],
            conf["ploidy"]) == (1_000_000, 10_000, 2, 2)
    assert conf["missing_rate"] == 0 and conf["generating_K"] == 6
    assert conf["reduced"] == ["loci", "max_iter"]
    assert set(conf["cut"]) == set(conf["reduced"])
    assert (traffic["model"], traffic["K"], traffic["n_init"],
            traffic["accel"], traffic["max_iter"]) == ("admixture", 6, 2, 0,
                                                       10)
    assert set(cell.limits) == {"logl_gap", "step_gain"}
    assert cell.chips == 1
    entry = next(c for c in SPEC["configs"] if c["name"] == "tera1m")
    assert entry["reduced"] == conf["reduced"]
    for name in NAMES:
        m = next(m for m in SPEC["per_layer"] if m["name"] == name)
        assert CELL in m["workloads"] and m["moves"] == "fit_s"
        assert hasattr(harness.reader(name), "read")


def test_counts_roofline_by_hand():
    mod = harness.load_module(harness.BENCH / "roofline" /
                              "allele_counts.py")
    conf = {"individuals": 1000, "loci": 50, "alleles": 2, "ploidy": 2}
    peaks = {"hbm_bytes_per_s": 1e9}
    # per start: 1000 x 50 x 2 labels of 8 B, 1000 x 50 genotypes of 2 B,
    # (1000 x 6 + 6 x 50 x 2) int32 counts
    want = 3 * (800_000 + 100_000 + 4 * 6_600) / 1e9
    least, by = mod.least_seconds(conf, 6, 3, peaks)
    assert by == "bytes" and least == pytest.approx(want)


def _fit(n_launched, **launches):
    return harness.FitRecord(wall_s=1.0, seconds=0.9, n_iter_all=8,
                             n_launched=n_launched, batch_chains=2,
                             route="", launches=launches)


def _run(fits, traced):
    config = {"individuals": 1000, "loci": 50, "alleles": 2, "ploidy": 2}
    return harness.Run(config=config, traffic={"K": 6}, setup_s=1.0,
                       window_s=2.0, fits=fits, peak_bytes=0, traced=traced,
                       peaks={"hbm_bytes_per_s": 1e9})


def test_the_readers_by_hand():
    traced = [_fit(2, **{"span_us.mc.init.counts": 1000,
                         "init.windows": 4}),
              _fit(2, **{"span_us.mc.init.counts": 3000,
                         "init.windows": 4})]
    run = _run([_fit(2, **{"init.windows": 4}), _fit(2)], traced)
    # 4 starts' least 4 x 926,400 B at 1 GB/s over 4 ms
    assert harness.reader("init_counts_roofline_pct").read(run) == \
        pytest.approx(100 * 4 * 926_400 / 1e9 / 4e-3)
    # (4 + 0 + 4 + 4) windows over 4 fits
    assert harness.reader("init_windows_per_fit").read(run) == \
        pytest.approx(3.0)


@pytest.mark.parametrize("name", NAMES)
def test_the_readers_find_nothing_without_the_program_s_counts(name):
    """A program without the span and the counter (the parent of this
    cell, or a mixture fit) leaves both metrics out."""
    plain = _run([_fit(2), _fit(2)], [_fit(2, **{"span_us.mc.init": 9})])
    assert harness.reader(name).read(plain) is None
    assert harness.reader(name).read(_run([], [])) is None


def test_a_traced_run_of_the_cell_reads_both():
    cell = small_cell(CELL, I=48, L=300)
    out, verdict, res = run_small(cell, traced=True)
    assert res["failed"] == 0
    for name in NAMES:
        assert res["metrics"][name]["value"] > 0, name
    fits = out["run"].fits + out["run"].traced
    assert res["metrics"]["init_windows_per_fit"]["value"] == sum(
        f.launches["init.windows"] for f in fits) / len(fits)
