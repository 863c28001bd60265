"""Cells, mixes and metrics are found by name, and a new one is new files."""

import dataclasses
import json
import shutil

import pytest

from benchmark import harness, program
from benchmark.tests.helpers import run_small, small_cell

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_loads_with_its_files(name):
    cell = harness.load_cell(name)
    assert cell.traffic["model"] in ("admixture", "mixture")
    assert set(cell.limits) <= {"logl_gap", "step_gain"}
    assert cell.end_to_end and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert hasattr(harness.reader(m["name"]), "read")
    assert hasattr(harness.roofline(cell.config, cell.traffic),
                   "least_seconds")


def test_every_metric_moves_a_reported_end_to_end_metric():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e


def test_a_new_cell_mix_and_metric_are_new_files_only(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / "benchmark")
    b = tmp_path / "benchmark"
    conf = json.loads((b / "configs" / "hgdp650k.json").read_text())
    conf.update(name="tiny", individuals=40, loci=200)
    (b / "configs" / "tiny.json").write_text(json.dumps(conf))
    traffic = json.loads((b / "traffic" / "admix_k7.json").read_text())
    traffic.update(K=3, n_init=2)
    (b / "traffic" / "admix_k3.json").write_text(json.dumps(traffic))
    (b / "limits" / "tiny.admix_k3.json").write_text(json.dumps(
        {"logl_gap": 1e-5, "step_gain": 1e-5}))
    (b / "metrics" / "fits_in_window.py").write_text(
        "def read(run):\n"
        "    return len(run.fits) if run.config['name'] == 'tiny' "
        "else None\n")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny", "source": "test",
                            "file": "benchmark/configs/tiny.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tiny.admix_k3", "config": "tiny",
                              "traffic": "admix_k3", "chips": 1,
                              "why": "test"})
    spec["per_layer"].append({"name": "fits_in_window", "unit": "fits",
                              "better": "higher",
                              "source": "program_counter", "layer": "api",
                              "moves": "fit_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = harness.load_cell("tiny.admix_k3", root=tmp_path)
    assert cell.bench == b and cell.traffic["K"] == 3
    assert "fits_in_window" in [m["name"] for m in cell.per_layer]
    cell.traffic["trace_seconds"] = 0.05
    out, verdict, res = run_small(cell, traced=True)
    assert res["metrics"]["fits_in_window"]["value"] == len(out["run"].fits)
    assert verdict["correct"]
    # a cell it does not apply to finds nothing to read, and leaves it out
    other = dataclasses.replace(out["run"], config=dict(conf, name="x"))
    assert harness.metrics_of(other, cell.per_layer, b).get(
        "fits_in_window") is None


def test_a_traffic_key_that_no_code_reads_is_refused(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / "benchmark")
    mix = tmp_path / "benchmark" / "traffic" / "admix_k7.json"
    traffic = json.loads(mix.read_text())
    mix.write_text(json.dumps(dict(traffic, tolerance=1e-6)))
    with pytest.raises(ValueError, match="tolerance"):
        harness.load_cell("hgdp650k.admix_k7", root=tmp_path)


@pytest.mark.parametrize("accel,scheme", [(0, "NONE"), (1, "SQS1"),
                                          (3, "SQS3"), (4, "QN")])
def test_the_mix_sets_the_programs_options(accel, scheme):
    from multiclust_tpu_torch.config import AccelScheme

    traffic = dict(harness.load_cell(CELLS[0]).traffic, accel=accel,
                   abs_error=1e-6, max_iter=9)
    opt = program.options(traffic, 5)
    assert opt.accel_scheme == AccelScheme[scheme]
    assert (opt.abs_error, opt.max_iter, opt.seed) == (1e-6, 9, 5)
    assert (opt.min_K, opt.max_K, opt.n_init) == (7, 7, traffic["n_init"])


def test_a_metric_that_finds_nothing_is_left_out():
    cell = small_cell()
    out, _, res = run_small(cell)
    assert "kernel_roofline_pct" not in res["metrics"]
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end} - {
        "peak_device_gib"}
