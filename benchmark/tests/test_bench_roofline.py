"""The roofline counts against hand counts at small shapes."""

import pytest

from benchmark import harness

PEAKS = {"fp32_flops_per_s": 1e12, "fp64_tensor_flops_per_s": 2e12,
         "hbm_bytes_per_s": 1e14}


def _rf(model):
    return harness.roofline({"alleles": 2}, {"model": model})


def test_admixture_ops_by_hand():
    conf = {"individuals": 10, "loci": 20, "missing_rate": 0.0}
    # 200 cells x (8 K + 2) at K = 3, for 5 chain-iterations
    t, bound = _rf("admixture").least_seconds(conf, 3, 5, 1, PEAKS)
    assert bound == "ops"
    assert t == pytest.approx(5 * 200 * 26 / 1e12)


def test_admixture_missing_copies_add_their_share():
    conf = {"individuals": 10, "loci": 20, "missing_rate": 0.5}
    t, _ = _rf("admixture").least_seconds(conf, 3, 1, 1, PEAKS)
    assert t == pytest.approx(200 * (26 + 2 * 3 * 0.5) / 1e12)


def test_admixture_bytes_bound_shares_the_panel_among_chains():
    conf = {"individuals": 1000, "loci": 1000, "missing_rate": 0.0}
    peaks = dict(PEAKS, hbm_bytes_per_s=1e6)
    t, bound = _rf("admixture").least_seconds(conf, 2, 8, 4, peaks)
    # the int8 plane once a model step (8 / 4 steps), eta and p read and
    # written once a chain-iteration in float32
    nbytes = 8 * (1e6 / 4 + 2 * 4 * (1000 * 2 + 2 * 2 * 1000))
    assert bound == "bytes" and t == pytest.approx(nbytes / 1e6)


def test_mixture_ops_by_hand():
    conf = {"individuals": 10, "loci": 20, "missing_rate": 0.0}
    # 200 cells x 4 K at K = 7 on the float64 tensor cores
    t, bound = _rf("mixture").least_seconds(conf, 7, 3, 8, PEAKS)
    assert bound == "ops" and t == pytest.approx(3 * 200 * 28 / 2e12)


def test_roofline_share_cannot_pass_a_kernel_time_at_peak():
    # the counted work at the peak rates never takes longer than the same
    # work counted with every product a kernel might do
    conf = {"individuals": 938, "loci": 642690, "missing_rate": 0.002}
    t, _ = _rf("admixture").least_seconds(conf, 7, 1, 4, {
        "fp32_flops_per_s": 67e12, "fp64_tensor_flops_per_s": 67e12,
        "hbm_bytes_per_s": 3.35e12})
    assert t < 938 * 642690 * 2 * (12 * 7 + 4) / 67e12
