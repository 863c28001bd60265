"""The readers of the program's spans and counters, on hand-built runs and
on a traced run of each cell on the CPU."""

import pytest

from benchmark import harness
from benchmark.tests.helpers import run_small, small_cell

NAMES = ("init_ms_per_fit", "setup_ms_per_fit", "em_device_gcells_per_s",
         "chain_step_yield_pct", "host_syncs_per_step")


def _fit(n_iter_all, **launches):
    return harness.FitRecord(wall_s=1.0, seconds=0.9, n_iter_all=n_iter_all,
                             n_launched=4, batch_chains=4, route="",
                             launches=launches)


def _run(fits, traced):
    config = {"individuals": 10, "loci": 100, "alleles": 2}
    return harness.Run(config=config, traffic={}, setup_s=1.0, window_s=2.0,
                       fits=fits, peak_bytes=0, traced=traced)


def _counted(n_iter_all, chain_steps, model_steps, syncs):
    return _fit(n_iter_all, **{"em.chain_steps": chain_steps,
                               "em.model_steps": model_steps,
                               "host.syncs": syncs})


def _traced(n_iter_all, init_us, plan_us, codes_us, em_us):
    f = _counted(n_iter_all, 40, 10, 25)
    f.launches.update({"span_us.mc.init": init_us,
                       "span_us.mc.plan": plan_us,
                       "span_us.mc.em": em_us})
    if codes_us:
        f.launches["span_us.mc.codes"] = codes_us
    return f


def read(name, run):
    return harness.reader(name).read(run)


def test_readers_by_hand():
    fits = [_counted(30, 40, 10, 20), _counted(10, 20, 5, 5)]
    traced = [_traced(32, 400_000, 3_000, 20_000, 500_000),
              _traced(16, 600_000, 1_000, 0, 700_000)]
    run = _run(fits, traced)
    assert read("init_ms_per_fit", run) == pytest.approx(500.0)
    # (3 + 20 + 1 + 0) ms over 2 fits
    assert read("setup_ms_per_fit", run) == pytest.approx(12.0)
    # 10 x 100 x 2 cells x 48 iterations over 1.2 s
    assert read("em_device_gcells_per_s", run) == pytest.approx(
        2000 * 48 / 1.2 / 1e9)
    # (30 + 10 + 32 + 16) of (40 + 20 + 40 + 40) chain-steps
    assert read("chain_step_yield_pct", run) == pytest.approx(
        100 * 88 / 140)
    # (20 + 5 + 25 + 25) syncs over (10 + 5 + 10 + 10) model steps
    assert read("host_syncs_per_step", run) == pytest.approx(75 / 35)


@pytest.mark.parametrize("name", NAMES)
def test_readers_find_nothing_without_counters_or_traced_fits(name):
    bare = _run([_fit(30)], [_fit(30)])
    assert read(name, bare) is None
    assert read(name, _run([], [])) is None
    if name in NAMES[:3]:
        # the span readers read the traced fits alone
        counted = [_counted(30, 40, 10, 20)]
        assert read(name, _run(counted, [])) is None
        assert read(name, _run(counted, counted)) is None


@pytest.mark.parametrize("name", ["hgdp650k.admix_k7", "hgdp650k.mix_k7"])
def test_a_traced_run_reports_every_reader(name):
    # the iteration cap keeps the CPU's plain steps short; what is judged
    # here is the result line, not the answers (test_bench_result.py)
    cell = small_cell(name, max_iter=30)
    out, _, res = run_small(cell, traced=True)
    for metric in NAMES:
        assert metric in res["metrics"], metric
        assert res["metrics"][metric]["value"] > 0, metric
    assert res["metrics"]["chain_step_yield_pct"]["value"] <= 100.0
    traced = out["run"].traced
    assert traced and all(f.launches["span_n.mc.fit"] == 1 for f in traced)
    assert ("span_us.mc.codes" in traced[0].launches) == (
        cell.traffic["model"] == "admixture")
