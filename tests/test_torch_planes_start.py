"""An admixture start that makes no allele codes of the whole panel
(init/random.py: ``_window_codes``, ``plane_codes``), on the CPU: each
window's codes are the slice of the panel's codes, its counts are the
plain reference's, its start is the whole codes' start bit for bit, and a
fit never makes the whole panel's codes."""

import numpy as np
import pytest
import torch

from multiclust_tpu_torch.api import fit_model_data
from multiclust_tpu_torch.config import InitMethod
from multiclust_tpu_torch.init import random as rinit
from multiclust_tpu_torch.model import common
from multiclust_tpu_torch.model.common import make_model_data, \
    model_data_from_planes
from multiclust_tpu_torch.ops import build

torch.set_num_threads(2)


def _planes(seed, I, L, missing=True):
    """(planes [2, I, L], miss [I, L]) int8 of a diploid panel: 4 % of the
    genotypes missing whole and 2 % one copy where ``missing``."""
    rng = np.random.default_rng(seed)
    miss = np.zeros((I, L), np.int64)
    if missing:
        miss[rng.random((I, L)) < 0.04] = 2
        miss[rng.random((I, L)) < 0.02] = 1
    f = rng.beta(0.8, 0.8, size=L).clip(0.01, 0.99)
    x0 = rng.binomial(2 - miss, f)
    planes = torch.as_tensor(np.stack([x0, 2 - miss - x0])).to(torch.int8)
    return planes.contiguous(), torch.as_tensor(miss).to(torch.int8)


def _md(seed, I=64, L=400, missing=True):
    return model_data_from_planes(*_planes(seed, I, L, missing))


def test_plane_codes_are_the_codes_of_the_counts():
    md = _md(1)
    codes = rinit.codes_from_counts(md.x, md.miss, 2)
    assert bool((codes < 0).any())
    assert torch.equal(rinit.plane_codes(md.x0, md.miss, 2), codes)
    # a column slice of the planes gives the slice of the codes
    assert torch.equal(rinit.plane_codes(md.x0[:, 33:90], md.miss[:, 33:90],
                                         2), codes[:, 33:90])


@pytest.mark.parametrize("K", [1, 2, 3, 6])
@pytest.mark.parametrize("missing", [True, False])
@pytest.mark.parametrize("window", [400, 48])
def test_planes_counts_equal_the_reference_counts(K, missing, window):
    """The counts of every window of a start from the codes of its slice
    of the planes equal the plain reference's
    (``allele_partition_counts_reference`` on ``codes_from_counts``) for
    the same labels, and the start that sums them is the start whose
    windows take their slice of the whole panel's codes."""
    md = _md(K + 10 * missing, missing=missing)
    codes = rinit.codes_from_counts(md.x, md.miss, 2)
    assert bool((codes < 0).any()) == missing
    gen = torch.Generator().manual_seed(K)
    for lo in range(0, md.L, window):
        hi = min(md.L, lo + window)
        labels = torch.randint(0, K, (md.I, hi - lo, 2), generator=gen)
        got = rinit.allele_partition_counts(
            labels, rinit._window_codes(md, lo, hi, 2), 2, K, md.dtype)
        want = rinit.allele_partition_counts_reference(
            labels, codes[:, lo:hi], 2, K, md.dtype)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), (lo, hi)
    budget = rinit.INIT_BYTES_PER_COPY * md.I * 2 * window
    assert rinit.init_window(md, 2, budget) == window

    def start():
        return rinit.windowed_allele_start(
            torch.Generator().manual_seed(5), md, K,
            InitMethod.RANDOM_CENTERS, False, window, 2)

    a = start()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rinit, "_window_codes",
                   lambda md, m0, m1, P: codes[:, m0:m1])
        b = start()
    assert torch.equal(a.eta, b.eta) and torch.equal(a.p, b.p)


def _flat(seed, I=64, L=400):
    """The panel of ``_md(seed)`` held as float32 counts, not as planes."""
    planes, miss = _planes(seed, I, L)
    flat = make_model_data(planes.permute(1, 2, 0).numpy(), miss.numpy(),
                           np.ones((L, 2), bool), np.full(L, 2),
                           dtype=torch.float32, device="cpu", planes=False)
    assert flat.x0 is None
    return flat


@pytest.mark.parametrize("method", list(InitMethod))
@pytest.mark.parametrize("K", [1, 2, 3, 6])
@pytest.mark.parametrize("constrained", [False, True])
def test_start_of_the_planes_is_the_codes_start(method, K, constrained):
    """On a 64 x 400 planes panel the start of ``random_initialize`` equals
    bit for bit, from the same generator state, the start of the same
    panel held as counts (its windows' codes from ``codes_from_counts``),
    in one window and in several, and leaves the generator where that
    start leaves it; in one window it is the start the whole panel's
    labels and codes give."""
    md, flat = _md(7), _flat(7)
    codes = rinit.codes_from_counts(md.x, md.miss, 2)
    for budget in (None, rinit.INIT_BYTES_PER_COPY * md.I * 2 * 48):
        gens = [torch.Generator().manual_seed(11) for _ in range(2)]
        a = rinit.random_initialize(gens[0], md, K, method,
                                    eta_constrained=constrained,
                                    budget=budget)
        b = rinit.random_initialize(gens[1], flat, K, method,
                                    eta_constrained=constrained,
                                    budget=budget)
        assert torch.equal(a.eta, b.eta) and torch.equal(a.p, b.p)
        assert torch.equal(gens[0].get_state(), gens[1].get_state())
    lab = rinit._allele_labels(torch.Generator().manual_seed(11), md, codes,
                               K, method)
    whole = rinit.parameters_from_allele_partition(lab, codes, md, K,
                                                   constrained)
    a = rinit.random_initialize(torch.Generator().manual_seed(11), md, K,
                                method, eta_constrained=constrained)
    assert torch.equal(a.eta, whole.eta) and torch.equal(a.p, whole.p)


def test_the_windows_are_counted():
    md = _md(4)
    before = dict(build.LAUNCHES)
    rinit.random_initialize(torch.Generator().manual_seed(2), md, 6,
                            InitMethod.RANDOM_CENTERS,
                            budget=rinit.INIT_BYTES_PER_COPY * md.I * 2 * 48)
    n_win = -(-md.L // 48)
    assert build.LAUNCHES["init.windows"] - before["init.windows"] == n_win


def _fit(md, **kw):
    return fit_model_data(md, 2, admixture=True, min_K=6, max_K=6,
                          n_init=2, seed=9, verbosity=0, write_files=False,
                          **kw).best


def test_a_fit_makes_no_codes_of_the_whole_panel(monkeypatch):
    """An admixture fit at K = 6 of an int8 planes panel makes its codes
    from the planes alone (``codes_from_counts`` made to raise), one
    window at a time; the same panel held as counts makes them with
    ``codes_from_counts`` a window at a time, never of the whole panel;
    both fits give one answer."""
    md, flat = _md(5), _flat(5)
    window = 48
    monkeypatch.setattr(rinit, "INIT_BYTES",
                        rinit.INIT_BYTES_PER_COPY * md.I * 2 * window)
    loci = []
    real_codes, real_planes = rinit.codes_from_counts, rinit.plane_codes

    def refuse(*a, **kw):
        raise AssertionError("codes_from_counts called")

    def planes_window(x0, miss, ploidy):
        loci.append(x0.shape[1])
        return real_planes(x0, miss, ploidy)

    monkeypatch.setattr(rinit, "codes_from_counts", refuse)
    monkeypatch.setattr(rinit, "plane_codes", planes_window)
    got = _fit(md, max_iter=10)
    assert loci and max(loci) == window
    n_planes = len(loci)

    def counts_window(counts, miss, ploidy):
        loci.append(counts.shape[1])
        return real_codes(counts, miss, ploidy)

    monkeypatch.setattr(rinit, "codes_from_counts", counts_window)
    monkeypatch.setattr(rinit, "plane_codes", refuse)
    want = _fit(flat, max_iter=10)
    assert len(loci) == 2 * n_planes and max(loci[n_planes:]) == window
    assert got.max_logL == want.max_logL and got.n_iter_all == want.n_iter_all
    assert torch.equal(got.best_params.eta, want.best_params.eta)


def test_a_planes_fit_passes_the_reference_check():
    """The answer of a 64 x 400 fit of an int8 planes panel (the
    benchmark's generator, 3 populations), its start coded from the
    planes and run to the stop rule, passes the benchmark's plain
    reference check in float64 within hgdp650k.admix_k7's limits.  (Capped
    at 10 iterations a panel this small is far from its stop, and its
    answer's logl_gap is its last step's gain, 1e-5 to 1e-2.)"""
    import json
    from pathlib import Path

    from benchmark import harness, panel
    from benchmark.reference import judge, models

    root = Path(__file__).resolve().parent.parent
    limits = json.loads((root / "benchmark" / "limits" /
                         "hgdp650k.admix_k7.json").read_text())
    conf = dict(harness.load_cell("hgdp650k.admix_k7").config,
                individuals=64, loci=400, generating_K=3)
    planes, miss = panel.make_panel(conf, 24, torch.device("cpu"))
    md = model_data_from_planes(planes, miss)
    best = fit_model_data(md, 2, admixture=True, min_K=3, max_K=3, n_init=2,
                          seed=9, verbosity=0, write_files=False).best
    lb = models.lower_bound(64, 2, float(conf["lower_bound"]))
    nums = judge.judge("admixture", best.best_params.eta.double(),
                       best.best_params.p.double(), best.max_logL,
                       planes, miss, lb, lb)
    assert judge.within(nums, limits), nums


def test_model_data_row_sums_are_exact_in_blocks(monkeypatch):
    """``c``, the per-individual missing copies, summed a block of rows at
    a time (no [I, L] float transient) equals the whole sum."""
    planes, miss = _planes(8, 50, 120)
    want = miss.sum(dim=1, dtype=torch.float32)
    monkeypatch.setattr(common, "ROW_SUM_CELLS", 7 * 120)
    got = model_data_from_planes(planes, miss).c
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert torch.equal(common.row_sums(miss, torch.float64),
                       miss.sum(dim=1, dtype=torch.float64))
