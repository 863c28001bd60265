"""The result line's keys, on a small cell run on the CPU."""

import json

import pytest

from benchmark import harness
from benchmark.tests.helpers import run_small, small_cell


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_keys(traced):
    cell = small_cell("hgdp650k.mix_k7")
    out, verdict, res = run_small(cell, traced=traced)
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= len(out["run"].fits) >= 1
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    names = {m["name"] for m in (cell.per_layer if traced
                                 else cell.end_to_end)}
    assert set(res["metrics"]) <= names
    for v in res["metrics"].values():
        assert set(v) == {"value", "unit"}
    for k, v in res["checks"].items():
        assert k in cell.limits and set(v) == {"value", "limit"}
    if traced:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert len(res["breakdown"]["idle_gaps"]) <= 10
        assert "chain_iters_per_fit" in res["metrics"]
    else:
        assert {"setup_s", "fit_s"} <= set(res["metrics"])
    json.dumps(res, allow_nan=False)


def test_a_number_that_is_not_finite_fails_and_is_printed_as_text():
    cell = small_cell("hgdp650k.mix_k7")
    out, _, _ = run_small(cell)
    ans, planes, miss = out["judged"][0]
    ans.p[0, 0, 0] = float("nan")
    verdict = harness.check(cell, [(ans, planes, miss)])
    assert not verdict["correct"]
    assert isinstance(verdict["checks"]["logl_gap"]["value"], str)


@pytest.mark.parametrize("seconds", [0.0, 1.0])
def test_the_window_is_whole_passes_of_the_fit_set(seconds):
    cell = small_cell("hgdp650k.mix_k7", fit_set=3)
    out, _, _ = run_small(cell, seconds=seconds)
    run = out["run"]
    n = len(run.fits)
    assert n and n % 3 == 0 and out["failed"] == 0
    # every pass is the same set of starts: the same work
    iters = [f.n_iter_all for f in run.fits]
    for j in range(3, n, 3):
        assert sorted(iters[j:j + 3]) == sorted(iters[:3])
    # no pass started that the last one's time said would end past the
    # window's length (the fits' own times lie inside the passes')
    passes = [sum(f.wall_s for f in run.fits[j:j + 3])
              for j in range(0, n, 3)]
    for k in range(len(passes) - 1):
        assert sum(passes[:k + 1]) + passes[k] <= seconds
    assert seconds or len(passes) == 1
    assert run.window_s >= sum(passes)
    # the check judges the first pass and one fit drawn from the seed
    assert out["seeded"] is not None and len(out["judged"]) == 4
