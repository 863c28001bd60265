"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device.  This
file imports neither jax nor the JAX package, so it also runs where only
PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from multiclust_tpu_torch import route_times as rt
from multiclust_tpu_torch.model.mixture import PAD_BIAS
from multiclust_tpu_torch.ops import build, fullstep as fs, \
    fullstep_bi as fb, mixture_bi as mb

# float32: the kernel and the plain version sum in other orders
F32 = dict(rtol=1e-4, atol=5e-5)
BI_KERNELS = ("mc_fullstep_bi_rows", "mc_fullstep_bi_cols")
GENERIC_KERNELS = ("mc_fullstep_rows", "mc_fullstep_cols", "mc_fullstep_p")
MIX_KERNELS = ("mc_mix_rows", "mc_mix_cols", "mc_mix_finish")


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _step_args(seed, B, I, L, K, Kp, miss_rate, dev):
    rng = np.random.default_rng(seed)
    eta = np.zeros((B, I, Kp), np.float32)
    eta[:, :, :K] = rng.dirichlet(np.full(K, 0.3), size=(B, I))
    p0 = np.zeros((B, Kp, L), np.float32)
    p0[:, :K] = rng.uniform(0.01, 0.99, size=(B, K, L))
    miss = rng.binomial(2, miss_rate, size=(I, L))
    x0 = rng.binomial(2 - miss, 0.5)
    return (torch.tensor(eta, device=dev), torch.tensor(p0, device=dev),
            torch.tensor(x0, dtype=torch.int8, device=dev),
            torch.tensor(2 - miss - x0, dtype=torch.int8, device=dev),
            torch.tensor(miss.sum(1), dtype=torch.float32, device=dev),
            torch.tensor(miss, dtype=torch.int8, device=dev)
            if miss_rate else None)


@pytest.mark.cuda
@pytest.mark.parametrize("B,I,L,K,Kp,miss_rate,compute_t,project", [
    (1, 1000, 333, 20, 32, 0.02, True, True),     # ragged against tiles
    (2, 777, 129, 40, 64, 0.0, True, True),
    (1, 300, 500, 70, 96, 0.05, False, True),
    (3, 300, 500, 128, 128, 0.1, True, False),
    (1, 40, 17, 3, 32, 0.1, True, True),          # one row segment
])
def test_fullstep_kernel_matches_plain(B, I, L, K, Kp, miss_rate,
                                       compute_t, project):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = _step_args(K, B, I, L, K, Kp, miss_rate, torch.device("cuda"))
    kw = dict(k_true=K, lb=0.01, plb=0.05, project=project,
              compute_t=compute_t)
    before = dict(build.LAUNCHES)
    got = fb.admixture_fullstep_biallelic(*args, **kw)
    ref = fb.admixture_fullstep_biallelic_reference(*args, **kw)
    torch.cuda.synchronize()
    for name in BI_KERNELS:
        assert build.LAUNCHES[name] == before[name] + 1
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, **F32)
    assert (got[0][..., K:] == 0).all() and (got[2][:, K:] == 0).all()
    # the kernel is deterministic: no atomics, fixed-order partial sums
    again = fb.admixture_fullstep_biallelic(*args, **kw)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


def _generic_args(seed, B, I, L, M, K, Kp, miss_rate, dev, small=2,
                  ploidy=2):
    """eta [B, I, Kp], p2 [B, Kp, L*M] (zero pads, on a jagged allele
    mask: 30 % of the loci have ``small`` valid slots), x2 [I, L*M] int8
    (``ploidy`` copies a locus, less the missing ones), c [I], miss [I, L]
    int8 or None, mask [L, M]."""
    rng = np.random.default_rng(seed)
    n_all = np.where(rng.random(L) < 0.3, min(small, M), M)
    mask = np.arange(M)[None, :] < n_all[:, None]
    eta = np.zeros((B, I, Kp), np.float32)
    eta[:, :, :K] = rng.dirichlet(np.full(K, 0.3), size=(B, I))
    p = np.zeros((B, Kp, L, M), np.float32)
    p[:, :K] = rng.dirichlet(np.full(M, 0.5), size=(B, K, L)) * mask
    p[:, :K] /= p[:, :K].sum(axis=-1, keepdims=True)
    miss = rng.binomial(ploidy, miss_rate, size=(I, L))
    freq = np.broadcast_to(mask / n_all[:, None], (I, L, M))
    x = rng.multinomial(ploidy - miss, freq)
    return (torch.tensor(eta, device=dev),
            torch.tensor(p.reshape(B, Kp, L * M), device=dev),
            torch.tensor(x.reshape(I, L * M), dtype=torch.int8, device=dev),
            torch.tensor(miss.sum(1), dtype=torch.float32, device=dev),
            torch.tensor(miss, dtype=torch.int8, device=dev)
            if miss_rate else None,
            torch.tensor(mask, device=dev))


# K in {3, 20, 21, 32, 40, 100} across the four Kp, M in {2, 3, 5, 8, 40}
# in turn; I and L*M multiples of no tile unless stated
_GENERIC_CASES = [
    # B, I, L, M, K, Kp, miss_rate, compute_t, project
    (1, 1001, 333, 3, 20, 32, 0.02, True, True),   # ragged I and L*M
    (2, 777, 129, 8, 40, 64, 0.0, True, True),
    (1, 300, 50, 40, 70, 96, 0.05, False, True),   # two slots per lane
    (3, 300, 101, 4, 128, 128, 0.1, True, False),
    (1, 40, 17, 5, 3, 32, 0.1, True, True),        # one row segment
    (2, 1000, 257, 2, 21, 32, 0.03, True, True),
    (1, 999, 201, 5, 32, 32, 0.0, False, True),
    (2, 513, 77, 3, 3, 64, 0.02, True, True),
    (1, 700, 61, 8, 20, 64, 0.05, True, False),
    (2, 401, 13, 40, 21, 64, 0.0, True, True),
    (1, 650, 99, 2, 32, 64, 0.02, True, True),
    (2, 333, 45, 5, 3, 96, 0.0, True, True),
    (1, 555, 71, 3, 40, 96, 0.03, True, True),
    (2, 300, 33, 8, 100, 128, 0.02, True, True),
    (1, 257, 23, 40, 20, 128, 0.05, True, True),
    (2, 513, 150, 2, 3, 128, 0.0, False, True),
    (1, 1024, 64, 4, 40, 128, 0.02, True, True),   # aligned, vector loads
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,I,L,M,K,Kp,miss_rate,compute_t,project",
                         _GENERIC_CASES)
def test_generic_fullstep_kernel_matches_plain(B, I, L, M, K, Kp, miss_rate,
                                               compute_t, project):
    dev = _cuda()
    args = _generic_args(K + L, B, I, L, M, K, Kp, miss_rate, dev)
    kw = dict(k_true=K, lb=0.01, plb=0.05, project=project,
              compute_t=compute_t)
    before = dict(build.LAUNCHES)
    got = fs.admixture_fullstep(*args, **kw)
    ref = fs.admixture_fullstep_reference(*args, **kw)
    torch.cuda.synchronize()
    for name in GENERIC_KERNELS:
        assert build.LAUNCHES[name] == before[name] + 1
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, **F32)
    eta_new, _, p_new = got
    assert (eta_new[..., K:] == 0).all() and (p_new[:, K:] == 0).all()
    assert (p_new[..., ~args[-1]] == 0).all()
    # the kernels are deterministic: no atomics, fixed-order partial sums
    again = fs.admixture_fullstep(*args, **kw)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [4, 3])
def test_generic_kernels_at_ploidy_four(M):
    """Counts of 3 and 4 a lane: w = x * rcp(d) is not bit-equal to x / d
    for a count of 3, and stays within the float32 tolerance of the plain
    version."""
    dev = _cuda()
    args = _generic_args(41 + M, 2, 700, 64, M, 20, 32, 0.02, dev,
                         ploidy=4)
    x2 = args[2]
    assert (x2 == 3).any() and (x2 == 4).any()
    kw = dict(k_true=20, lb=0.01, plb=0.05, project=True)
    got = fs.admixture_fullstep(*args, **kw)
    ref = fs.admixture_fullstep_reference(*args, **kw)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, **F32)
    raw = fs.fullstep_cols(*args[:3], args[4], k_true=20, finish=False)
    raw_ref = fs.fullstep_cols_reference(*args[:3], args[4], finish=False)
    torch.testing.assert_close(raw, raw_ref, **F32)


@pytest.mark.cuda
@pytest.mark.parametrize("K,Kp", [(3, 32), (20, 32), (40, 64), (70, 96),
                                  (100, 128)])
def test_generic_passes_at_any_split(K, Kp):
    """The splits the wrappers pick for a short, wide panel (the rows pass
    in several lane segments) and a tall, narrow one (one lane segment,
    the columns pass in several row segments), each pass against its
    plain version and rerun bit-equal: raw A (finish=False), eta' and t,
    the partials (rows k >= K exactly 0) and raw B with the miss fold; the
    rows pass's set-lane cells (M = 4) bit-equal to its dense ones."""
    dev = _cuda()
    n_sm = fb.device_sm_count(dev)
    lane_segs, row_segs = [], []
    kw = dict(k_true=K, lb=0.01, project=True)
    for seed, (I, L) in enumerate(((1001, 211), (3100, 80))):
        eta, p2, x2, c, miss, mask = _generic_args(K + seed, 2, I, L, 5, K,
                                                   Kp, 0.03, dev)
        LM = p2.shape[-1]
        lane_segs.append(fb.row_segments(2, I, LM, n_sm, k_true=K, Kp=Kp)[0])
        row_segs.append(fs.cols_segments(2, I, LM, Kp, n_sm, K)[0])
        for finish in (False, True):
            got = fs.fullstep_rows(eta, p2, x2, c, finish=finish, **kw)
            ref = fs.fullstep_rows_reference(eta, p2, x2, c, finish=finish,
                                             **kw)
            for g, r in zip(got, ref):
                torch.testing.assert_close(g, r, **F32)
            again = fs.fullstep_rows(eta, p2, x2, c, finish=finish, **kw)
            assert all(torch.equal(u, v) for u, v in zip(got, again))
        ref_part = fs.fullstep_partials_reference(eta, p2, x2, miss)[:, 0]
        part = fs.fullstep_partials(eta, p2, x2, miss, M=5, k_true=K)
        assert part.shape[1] == row_segs[-1]
        assert (part[:, :, K:] == 0).all()
        torch.testing.assert_close(part.sum(dim=1), ref_part, **F32)
        assert torch.equal(part, fs.fullstep_partials(eta, p2, x2, miss,
                                                      M=5, k_true=K))
        raw = fs.fullstep_cols(eta, p2, x2, miss, k_true=K, finish=False)
        torch.testing.assert_close(raw, ref_part, **F32)
    assert lane_segs[0] > 1 and lane_segs[1] == 1, lane_segs
    assert row_segs[1] > 1, row_segs
    # M = 4: the cells of the set lanes only; the same bits as the dense
    # cells of M unsaid
    e4, p4, x4, c4, _, _ = _generic_args(K + 2, 2, 1001, 211, 4, K, Kp,
                                         0.03, dev)
    for finish in (False, True):
        sparse = fs.fullstep_rows(e4, p4, x4, c4, finish=finish, M=4, **kw)
        dense = fs.fullstep_rows(e4, p4, x4, c4, finish=finish, **kw)
        assert all(torch.equal(u, v) for u, v in zip(sparse, dense))


@pytest.mark.cuda
def test_generic_zero_mass_cluster_is_uniform():
    """A real cluster with no mass gets 1/n_alleles on every valid lane."""
    dev = _cuda()
    eta, p2, x2, c, miss, mask = _generic_args(5, 1, 500, 64, 6, 5, 32,
                                               0.05, dev, small=3)
    eta[..., 2] = 0.0
    eta /= eta.sum(dim=-1, keepdim=True)
    got = fs.fullstep_cols(eta, p2, x2, miss, mask, k_true=5, plb=1e-8,
                           project=True)
    ref = fs.fullstep_cols_reference(eta, p2, x2, miss, mask, k_true=5,
                                     plb=1e-8, project=True)
    torch.testing.assert_close(got, ref, **F32)
    want = torch.where(mask, 1.0 / mask.sum(dim=1, keepdim=True), 0.0)
    torch.testing.assert_close(got[0, 2], want, rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("K,Kp", [(20, 32), (40, 64), (100, 128)])
def test_generic_sweep_and_a0_chain_match_plain(K, Kp):
    """finish=False: the sweep statistics (all Kp lanes computed), and an
    a0 / emit_a chain of two launches (the loops stopped at K), against
    their plain versions."""
    dev = _cuda()
    eta, p2, x2, c, miss, mask = _generic_args(6, 2, 999, 210, 4, K, Kp,
                                               0.02, dev)
    before = dict(build.LAUNCHES)
    got = fs.admixture_sweep_stats(eta, p2, x2)
    ref = fs.admixture_sweep_stats_reference(eta, p2, x2)
    assert all(build.LAUNCHES[n] == before[n] + 1 for n in GENERIC_KERNELS)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, **F32)
    kw = dict(k_true=K, lb=0.01, project=True)
    h = 100 * 4
    halves = [(p2[..., :h].contiguous(), x2[:, :h].contiguous()),
              (p2[..., h:].contiguous(), x2[:, h:].contiguous())]
    A, _ = fs.fullstep_rows(eta, *halves[0], c, finish=False, **kw)
    A_ref, _ = fs.fullstep_rows_reference(eta, *halves[0], c, finish=False,
                                          **kw)
    torch.testing.assert_close(A, A_ref, **F32)
    e2, t2 = fs.fullstep_rows(eta, *halves[1], c, A, **kw)
    e2_ref, t2_ref = fs.fullstep_rows_reference(eta, *halves[1], c, A_ref,
                                                **kw)
    torch.testing.assert_close(e2, e2_ref, **F32)
    torch.testing.assert_close(t2, t2_ref, **F32)


@pytest.mark.cuda
def test_generic_kernels_refuse_kp160():
    """The edge of the generic kernels' range moved from Kp = 160 to 1056:
    beyond 1024 they refuse, naming the plain step."""
    dev = _cuda()
    eta = torch.zeros(1, 8, 1056, device=dev)
    p2 = torch.zeros(1, 1056, 12, device=dev)
    x2 = torch.zeros(8, 12, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="Kp=1056.*plain step"):
        fs.fullstep_rows(eta, p2, x2, k_true=1050, lb=0.0, project=False)
    with pytest.raises(ValueError, match="Kp=1056.*plain step"):
        fs.fullstep_cols(eta, p2, x2, None,
                         torch.ones(4, 3, dtype=torch.bool, device=dev),
                         k_true=1050)


def _mix_args(seed, B, I, L, K, Kp, miss_rate, ploidy, dev):
    """Mixture kernel inputs on ``dev``: lp0 (and lp1) [B, Kp, L] and the
    bias [B, Kp] as model/mixture._kernel_inputs builds them (pads: lp 0,
    bias PAD_BIAS), x0 (and x1) int8 [I, L]; one stream without missing
    data (the ploidy fold), two with."""
    rng = np.random.default_rng(seed)
    p0 = rng.uniform(0.02, 0.98, size=(B, K, L))
    eta = rng.dirichlet(np.ones(K), size=B)
    miss = rng.binomial(ploidy, miss_rate, size=(I, L))
    x0 = rng.binomial(ploidy - miss, rng.uniform(0.1, 0.9, size=(1, L)))
    lp0 = np.zeros((B, Kp, L), np.float32)
    lp1 = np.zeros((B, Kp, L), np.float32)
    bias = np.full((B, Kp), PAD_BIAS, np.float32)
    if miss_rate:
        lp0[:, :K], lp1[:, :K] = np.log(p0), np.log1p(-p0)
        bias[:, :K] = np.log(eta)
    else:
        lp0[:, :K] = np.log(p0) - np.log1p(-p0)
        bias[:, :K] = ploidy * np.log1p(-p0).sum(-1) + np.log(eta)
    two = bool(miss_rate)
    return (torch.tensor(lp0, device=dev),
            torch.tensor(x0, dtype=torch.int8, device=dev),
            torch.tensor(bias, device=dev),
            torch.tensor(lp1, device=dev) if two else None,
            torch.tensor(ploidy - miss - x0, dtype=torch.int8, device=dev)
            if two else None)


@pytest.mark.cuda
@pytest.mark.parametrize("B,I,L,K,Kp,miss_rate,ploidy,project", [
    (1, 1001, 999, 20, 32, 0.02, 2, True),     # ragged against tiles
    (2, 1001, 999, 20, 32, 0.0, 2, True),      # one stream, ploidy fold
    (2, 777, 129, 40, 64, 0.0, 4, False),
    (1, 300, 500, 70, 96, 0.05, 4, True),
    (3, 300, 257, 128, 128, 0.1, 2, False),
    (1, 40, 17, 3, 32, 0.0, 2, True),          # one row segment
    # K not a multiple of 8 at each Kp, aligned L (cp.async) and ragged
    (2, 1003, 1024, 37, 64, 0.0, 2, True),
    (1, 515, 333, 70, 96, 0.0, 2, False),
    (2, 300, 400, 125, 128, 0.0, 4, True),     # ploidy 4, one stream
    (1, 700, 256, 125, 128, 0.03, 4, True),    # ploidy 4, two streams
    (2, 4000, 96, 20, 32, 0.0, 2, True),       # many row segments
    (1, 3001, 112, 37, 64, 0.02, 2, True),
    (2, 130, 160, 24, 32, 0.02, 2, True),      # two segments, K = 3 tiles
    (1, 129, 2048, 32, 32, 0.0, 2, True),      # every lane live
])
def test_mixture_kernels_match_plain(B, I, L, K, Kp, miss_rate, ploidy,
                                     project):
    """The three mixture launches (rows, columns, the finish) and the
    sweep route against their plain versions; reruns are
    bit-equal (no atomics, fixed-order partial sums).  The columns pass
    runs with the segments its wrapper picks (one, a few or many)."""
    dev = _cuda()
    args = _mix_args(K, B, I, L, K, Kp, miss_rate, ploidy, dev)
    kw = dict(k_true=K, lb=1e-3, plb=1e-3, ploidy=ploidy, project=project)
    before = dict(build.LAUNCHES)
    got = mb.mixture_fullstep_biallelic(*args, **kw)
    torch.cuda.synchronize()
    for name in MIX_KERNELS:
        assert build.LAUNCHES[name] == before[name] + 1
    ref = mb.mixture_fullstep_biallelic_reference(*args, **kw)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, **F32)
    eta = got[0]
    assert (eta[:, K:] == 0).all()
    if project:
        assert float(eta[:, :K].min()) >= 1e-3 * (1 - 1e-6)
    torch.testing.assert_close(eta.sum(dim=1), torch.ones(B, device=dev),
                               rtol=0, atol=1e-6)
    again = mb.mixture_fullstep_biallelic(*args, **kw)
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    sweep = mb.mixture_sweep_stats(*args)
    sweep_ref = mb.mixture_sweep_stats_reference(*args)
    assert (sweep[3] is None) == (miss_rate == 0)
    for g, r in zip(sweep, sweep_ref):
        if g is not None:
            torch.testing.assert_close(g, r, **F32)
    assert (sweep[0][..., K:] == 0).all()


def _finish_partials(seed, B, n_seg, two, K, Kp, L, dev):
    """Partials as the columns pass leaves them, drawn on ``dev``: v sums
    [B, n_seg, Kp] (cubed uniforms, so that the projection pins lanes) and
    B0 (B1) [B, n_seg, 1|2, Kp, L] with B0 + B1 <= 2 vtot in each segment,
    zeros past K."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    ns = 2 if two else 1
    vpart = torch.zeros((B, n_seg, Kp), device=dev)
    vpart[..., :K] = 60 * torch.rand((B, n_seg, K), generator=gen,
                                     device=dev) ** 3
    u = torch.rand((B, n_seg, 1, K, L), generator=gen, device=dev)
    kept = 2 * vpart[:, :, None, :K, None] * (
        1 - 0.1 * torch.rand((B, n_seg, 1, K, L), generator=gen,
                             device=dev))
    part = torch.zeros((B, n_seg, ns, Kp, L), device=dev)
    part[:, :, :1, :K] = kept * u
    if two:
        part[:, :, 1:, :K] = kept * (1 - u)
    return part, vpart


@pytest.mark.cuda
@pytest.mark.parametrize("K,Kp", [(20, 32), (37, 64), (70, 96), (128, 128),
                                  (150, 160), (200, 224), (500, 512),
                                  (1000, 1024), (1024, 1024)])
@pytest.mark.parametrize("two", [False, True])
def test_mixture_finish_matches_plain(K, Kp, two):
    """The finish, one launch, against its plain version at every eta
    instance (1-4 slots a lane narrow, 8, 16 and 32 wide) on partials of
    1, 3, 7 and 40 segments (more than a thread loads at once), 16-byte
    and ragged loci, projection on and off: its vtot and its p half's raw
    B0 (B1) bit-equal to the ordered segment sums, its eta half alone
    (``mixture_eta``) bit-equal to it, the model's layout
    bit-equal to its K-padded outputs, reruns bit-equal, one launch a
    call."""
    dev = _cuda()
    counted = ("mc_mix_finish", "wide_mix_finish") if mb.is_wide(Kp) \
        else ("mc_mix_finish",)
    for n_seg, L, project in ((1, 2048, True), (3, 333, False),
                              (7, 1024, True), (40, 97, True)):
        B = 1 + n_seg % 3
        part, vpart = _finish_partials(K + n_seg, B, n_seg, two, K, Kp, L,
                                       dev)
        lb = min(1e-3, 0.1 / K)
        kw = dict(k_true=K, lb=lb, plb=1e-3, ploidy=2, project=project)
        before = dict(build.LAUNCHES)
        got = mb.mixture_finish(part, vpart, **kw)
        torch.cuda.synchronize()
        assert {n: build.LAUNCHES[n] - before[n] for n in build.LAUNCHES
                if build.LAUNCHES[n] != before[n]} == dict.fromkeys(counted,
                                                                    1)
        ref = mb.mixture_finish_reference(part, vpart, **kw)
        for g, r in zip(got, ref):
            torch.testing.assert_close(g, r, **F32)
        eta, vtot, p0 = got
        assert torch.equal(vtot, fb.ordered_segment_sum(vpart))
        assert (eta[:, K:] == 0).all()
        if project:
            assert float(eta[:, :K].min()) >= lb * (1 - 1e-6)
        alone = mb.mixture_eta(vpart, k_true=K, lb=lb, project=project)
        assert torch.equal(alone, eta)
        raw = mb.mixture_b(part)
        assert (raw[1] is None) == (not two)
        for s in range(part.shape[2]):
            assert torch.equal(raw[s], fb.ordered_segment_sum(part[:, :, s]))
        model = mb.mixture_finish(part, vpart, params=True, **kw)
        want = mb.params_layout(eta, p0, K)
        assert model[1].shape == (B, K, L, 2)
        assert all(torch.equal(g, w) for g, w in zip(model, want))
        again = mb.mixture_finish(part, vpart, **kw)
        assert all(torch.equal(g, a) for g, a in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("K", [20, 200])
@pytest.mark.parametrize("miss_rate", [0.0, 0.02])
def test_mixture_model_step_ends_with_the_finish(K, miss_rate):
    """The model's kernel step launches rows, columns and one finish, and
    nothing after the finish (torch.profiler's device operations of one
    step: the finish last, once, and no eta finish or p epilogue of their
    own); its parameters bit-equal to the step's K-padded outputs taken
    to the model's layout, as two finish launches and plain torch made
    them."""
    from multiclust_tpu_torch.model import mixture
    from multiclust_tpu_torch.model.common import EMConfig, Params, \
        model_data_from_planes

    dev = _cuda()
    B, I, L = 2, 3000, 1000
    md = model_data_from_planes(*rt.device_panel(K, I, L, K, miss_rate,
                                                 dev))
    gen = torch.Generator(device=dev).manual_seed(K)
    eta = torch.rand((B, K), generator=gen, device=dev) + 0.1
    p0 = torch.rand((B, K, L), generator=gen, device=dev) * 0.96 + 0.02
    params = Params(eta=eta / eta.sum(dim=-1, keepdim=True),
                    p=torch.stack([p0, 1.0 - p0], dim=-1))
    cfg = EMConfig(admixture=False, use_pallas="on", biallelic=True,
                   has_missing=miss_rate > 0, ploidy=2)
    assert mixture._kernel_ok(md, cfg, params)
    before = dict(build.LAUNCHES)
    got, ll, _ = mixture.em_step(params, md, cfg)
    torch.cuda.synchronize()
    assert {n: build.LAUNCHES[n] - before[n] for n in MIX_KERNELS} == \
        dict.fromkeys(MIX_KERNELS, 1)
    ops = rt.device_ops(lambda: mixture.em_step(params, md, cfg))
    assert "mix_finish_kernel" in ops[-1], ops
    assert sum("mix_finish_kernel" in op for op in ops) == 1, ops
    assert not any("mix_eta_kernel" in op or "mix_p_kernel" in op
                   for op in ops), ops
    args = mixture._kernel_inputs(params, md, cfg)
    eta_p, _, p0n = mb.mixture_fullstep_biallelic(
        *args, k_true=K, lb=cfg.eta_lower_bound, plb=cfg.p_lower_bound,
        ploidy=2, project=cfg.do_projection)
    want = mb.params_layout(eta_p, p0n, K)
    assert torch.equal(got.eta, want[0]) and torch.equal(got.p, want[1])
    assert torch.isfinite(ll).all()


@pytest.mark.cuda
@pytest.mark.parametrize("miss_rate", [0.0, 0.02])
def test_mixture_rows_pass_at_large_scores(miss_rate):
    """At 64 x 131072 |s| reaches 10^5: the float64 tensor-core sums keep t
    at rtol 1e-6 of the float64 plain version, and v within the kernels'
    usual tolerance of the plain version, with one stream (the ploidy
    fold) and with two (missing data)."""
    dev = _cuda()
    lp0, x0, bias, lp1, x1 = _mix_args(11, 1, 64, 131072, 20, 32,
                                       miss_rate, 2, dev)
    v, t = mb.mixture_rows(lp0, x0, bias, lp1, x1)
    v_ref, _ = mb.mixture_rows_reference(lp0, x0, bias, lp1, x1)
    _, t64 = mb.mixture_rows_reference(
        lp0.double(), x0, bias.double(),
        None if lp1 is None else lp1.double(), x1)
    torch.cuda.synchronize()
    assert float(t64.abs().min()) > 1e4
    torch.testing.assert_close(t.double(), t64, rtol=1e-6, atol=0)
    torch.testing.assert_close(v, v_ref, **F32)
    again = mb.mixture_rows(lp0, x0, bias, lp1, x1)
    assert torch.equal(v, again[0]) and torch.equal(t, again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("Kp,K,two", [(32, 20, False), (32, 20, True),
                                      (128, 100, False)])
def test_mixture_columns_pass_in_one_long_segment(Kp, K, two):
    """Where the locus tiles alone fill the card the columns wrapper takes
    one row segment: here 8199 rows, 257 stages of 32, the last ragged.
    That segment's partials (B0, B1) and v sums, on a soft v whose sums
    are fractional, against the plain version; reruns bit-equal."""
    dev = _cuda()
    I = 8199
    n_sm = fb.device_sm_count(dev)
    L = mb.cols_tile(Kp, two) * mb.cols_blocks_per_sm(Kp, two) * n_sm + 5
    n_seg, seg_rows = mb.cols_segments(I, L, 1, Kp, two, n_sm)
    assert n_seg == 1 and seg_rows // mb.COL_RI == 257
    gen = torch.Generator(device=dev).manual_seed(14)
    x0, x1 = (torch.randint(0, 3, (I, L), generator=gen, device=dev,
                            dtype=torch.int8) for _ in range(2))
    x1 = x1 if two else None
    v = torch.zeros((1, I, Kp), device=dev)
    v[..., :K] = torch.softmax(
        torch.randn((1, I, K), generator=gen, device=dev), dim=-1)
    part, vpart = mb.mixture_partials(v, x0, x1)
    part_ref, vpart_ref = mb.mixture_cols_reference(v, x0, x1)
    assert part.shape[1] == vpart.shape[1] == 1
    torch.testing.assert_close(part, part_ref, **F32)
    torch.testing.assert_close(vpart, vpart_ref, **F32)
    again = mb.mixture_partials(v, x0, x1)
    assert torch.equal(part, again[0]) and torch.equal(vpart, again[1])


@pytest.mark.cuda
def test_mixture_kernels_stop_at_the_live_lanes():
    """The rows pass computes the ceil(k_true / 8) tiles of 8 below k_true
    whatever the pad lanes' lp hold, and writes v = 0 past k_true; with
    k_true 0 it computes all Kp.  The columns pass computes the tiles below
    k_true: a tile whose v is all zero, between live ones, comes out 0,
    and so do the pad tiles."""
    dev = _cuda()
    lp0, x0, bias, _, _ = _mix_args(12, 2, 600, 512, 20, 64, 0.0, 2, dev)
    noisy = lp0.clone()
    noisy[:, 20:] = torch.randn_like(noisy[:, 20:])
    for lp in (lp0, noisy):
        got = mb.mixture_rows(lp, x0, bias, k_true=20)
        ref = mb.mixture_rows_reference(lp, x0, bias)
        for g, r in zip(got, ref):
            torch.testing.assert_close(g, r, **F32)
        assert (got[0][..., 20:] == 0).all()
    flat = torch.full_like(bias, PAD_BIAS)
    v, t = mb.mixture_rows(lp0, x0, flat)
    torch.testing.assert_close(v, torch.full_like(v, 1 / 64), **F32)
    torch.testing.assert_close(
        t, mb.mixture_rows_reference(lp0, x0, flat)[1], **F32)
    v = mb.mixture_rows(lp0, x0, bias, k_true=20)[0].clone()
    v[..., 8:16] = 0   # a dead tile between live ones
    part, vpart = mb.mixture_partials(v, x0, k_true=20)
    part_ref, vpart_ref = mb.mixture_cols_reference(v, x0)
    torch.testing.assert_close(part.sum(dim=1), part_ref[:, 0], **F32)
    torch.testing.assert_close(vpart.sum(dim=1), vpart_ref[:, 0], **F32)
    assert (part[..., 8:16, :] == 0).all() and (part[..., 24:, :] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("Kp", [32, 64, 96, 128, 160, 224, 512, 1024])
def test_mixture_tiles_match_the_python_mirror(Kp):
    """``cols_tile``, ``cols_stage_rows`` and ``cols_blocks_per_sm``, which
    choose the columns pass's segments, against the built library's own
    tile (csrc/mixture_bi.cu; above 128 lanes the wide pass's) and the
    compiled kernel's occupancy."""
    _cuda()
    lib = build.library()
    for two in (False, True):
        assert build.mixture_tiles(lib, Kp, two) == (
            mb.cols_tile(Kp, two), mb.cols_stage_rows(Kp),
            mb.cols_blocks_per_sm(Kp, two))


@pytest.mark.cuda
def test_mixture_passes_run_on_the_float64_tensor_cores():
    """The machine code of both mixture contraction kernels, at every Kp
    and both stream variants, and of the wide passes' score and columns
    kernels, holds DMMA instructions (kernel_report's opcode mix, from
    cuobjdump)."""
    from multiclust_tpu_torch.kernel_report import sass_mix

    _cuda()
    lib = build.build()
    for kernel in ("mix_rows_kernel", "mix_cols_kernel"):
        for kp in (32, 64, 96, 128):
            for targs in ("Lb0E", "Lb1E"):
                mix = sass_mix(lib, kernel, kp, targs)
                assert mix["DMMA"] > 0, (kernel, kp, targs, mix)
    for kernel in ("mix_rows_wide_kernel", "mix_cols_wide_kernel"):
        for targs in ("ILb0E", "ILb1E"):
            mix = sass_mix(lib, kernel, None, targs)
            assert mix["DMMA"] > 0, (kernel, targs, mix)


@pytest.mark.cuda
def test_mixture_kernels_refuse_kp160():
    """The edge of the mixture kernels' range moved from Kp = 160 to 1056:
    beyond 1024 every wrapper refuses, naming the plain step."""
    dev = _cuda()
    lp = torch.zeros(1, 1056, 12, device=dev)
    x = torch.zeros(8, 12, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="Kp=1056.*plain step"):
        mb.mixture_rows(lp, x, torch.zeros(1, 1056, device=dev))
    with pytest.raises(ValueError, match="Kp=1056.*plain step"):
        mb.mixture_partials(torch.zeros(1, 8, 1056, device=dev), x)
    with pytest.raises(ValueError, match="Kp=1056.*plain step"):
        mb.mixture_eta(torch.zeros(1, 1, 1056, device=dev), k_true=1050,
                       lb=0.0, project=False)
    with pytest.raises(ValueError, match="Kp=1056.*plain step"):
        mb.mixture_b(torch.zeros(1, 1, 1, 1056, 12, device=dev))
    with pytest.raises(ValueError, match="Kp=1056.*plain step"):
        mb.mixture_finish(torch.zeros(1, 1, 1, 1056, 12, device=dev),
                          torch.zeros(1, 1, 1056, device=dev), k_true=1050,
                          lb=0.0, plb=0.0, ploidy=2, project=False)


def _mixture_fit_inputs(dev, M, missing_rate, seed=3):
    """A mixture panel's ModelData on ``dev`` (int8 storage) and on the
    CPU (float32), with warm-start params for a batch of two chains."""
    from multiclust_tpu_torch.convert import model_data_from_numpy, \
        params_from_numpy

    rng = np.random.default_rng(seed)
    I, L, K = 500, 300, 5
    z = rng.integers(0, K, size=I)
    P = rng.dirichlet(np.full(M, 0.5), size=(K, L))
    miss = rng.binomial(2, missing_rate, size=(I, L))
    counts = rng.multinomial(2 - miss, P[z])
    mask, n_all = np.ones((L, M), bool), np.full(L, M)
    eta = rng.dirichlet(np.full(K, 3.0), size=2)
    p = rng.dirichlet(np.full(M, 2.0), size=(2, K, L))
    mds = [model_data_from_numpy(counts, miss, mask, n_all, device=d,
                                 dtype=torch.float32) for d in (dev, "cpu")]
    return mds, [params_from_numpy(eta, p, device=d, dtype=torch.float32)
                 for d in (dev, "cpu")]


@pytest.mark.cuda
@pytest.mark.parametrize("M,missing_rate", [(2, 0.0), (2, 0.02), (4, 0.02)])
def test_mixture_blind_steps_read_no_host(M, missing_rate):
    """Blind mixture steps on the card, called as opt/em.blind_plain_steps
    calls them, make no host read (the biallelic kernel route, and the
    multi-allelic route with its eta and p finish on the card) and agree
    with the same route's plain versions on the CPU."""
    from multiclust_tpu_torch.model import mixture
    from multiclust_tpu_torch.model.common import EMConfig
    from multiclust_tpu_torch.opt import em as em_mod

    dev = _cuda()
    (md, md_cpu), (params, params_cpu) = _mixture_fit_inputs(
        dev, M, missing_rate)
    cfg = EMConfig(admixture=False, use_pallas="on", biallelic=M == 2,
                   has_missing=missing_rate > 0, ploidy=2)
    assert mixture._kernel_ok(md, cfg, params) == (M == 2)
    state = em_mod.init_state(params, cfg)
    n_lane = torch.full((2,), 3, dtype=torch.int64, device=dev)
    before = dict(build.LAUNCHES)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = em_mod.blind_plain_steps(state, md, cfg, n_lane, 3)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launched = {n: build.LAUNCHES[n] - before[n] for n in build.LAUNCHES}
    if M == 2:
        assert all(launched[n] == 3 for n in MIX_KERNELS), launched
    else:
        # the finish's eta half alone, then the generic p epilogue
        assert launched["mc_mix_finish"] == launched["mc_fullstep_p"] == 3
    want = params_cpu
    for _ in range(3):
        want, _, _ = mixture.em_step(want, md_cpu, cfg, want_ll=False)
    torch.testing.assert_close(out.params.eta.cpu(), want.eta, **F32)
    torch.testing.assert_close(out.params.p.cpu(), want.p, **F32)


# ---------------------------------------------------------------------------
# the streamed and chunked biallelic steps

STREAM_KERNELS = ("mc_fullstep_bi_rows_seg", "mc_fullstep_bi_finish",
                  "mc_fullstep_bi_cols")


def _stream_close(got, ref):
    for g, r in zip(got, ref):
        torch.testing.assert_close(g.to(r.dtype), r, **F32)


@pytest.mark.cuda
@pytest.mark.parametrize("K,Kp", [(20, 32), (40, 64), (70, 96), (128, 128)])
@pytest.mark.parametrize("B,miss_rate,compute_t", [(1, 0.02, True),
                                                   (2, 0.0, False)])
def test_streamed_and_chunked_kernels_match_plain(K, Kp, B, miss_rate,
                                                  compute_t):
    """Ragged I = 1001 x L = 4099 with a segment size (1056) and a window
    (1312) that leave a short last segment and window; bit-equal reruns;
    the three routes against each other."""
    dev = _cuda()
    args = _step_args(K + B, B, 1001, 4099, K, Kp, miss_rate, dev)
    kw = dict(k_true=K, lb=0.01, plb=0.05, project=True, compute_t=compute_t)
    ref = fb.admixture_fullstep_biallelic_streamed_reference(*args, **kw)
    before = dict(build.LAUNCHES)
    streamed = fb.admixture_fullstep_biallelic_streamed(*args, seg_cols=1056,
                                                        **kw)
    torch.cuda.synchronize()
    for name in STREAM_KERNELS:
        assert build.LAUNCHES[name] == before[name] + 1
    assert build.LAUNCHES["fullstep_bi_chunked"] == \
        before["fullstep_bi_chunked"]
    chunked = fb.admixture_fullstep_biallelic_chunked(*args, window=1312,
                                                      **kw)
    torch.cuda.synchronize()
    assert build.LAUNCHES["fullstep_bi_chunked"] == \
        before["fullstep_bi_chunked"] + 4
    pair = fb.admixture_fullstep_biallelic(*args, **kw)
    for got in (streamed, chunked, pair):
        _stream_close(got, ref)
        assert (got[0][..., K:] == 0).all() and (got[2][:, K:] == 0).all()
    assert streamed[1].dtype == torch.float64
    for fn, extra in ((fb.admixture_fullstep_biallelic_streamed,
                       dict(seg_cols=1056)),
                      (fb.admixture_fullstep_biallelic_chunked,
                       dict(window=1312))):
        a, b = fn(*args, **extra, **kw), fn(*args, **extra, **kw)
        assert all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["emit_b", "emit_ab", "kmask",
                                     "project_eta_off", "a0", "no_project"])
@pytest.mark.parametrize("route", ["streamed", "chunked"])
def test_streamed_variants_match_plain(variant, route):
    dev = _cuda()
    K, Kp = 20, 32
    args = _step_args(7, 2, 1001, 4099, K, Kp, 0.03, dev)
    kw = dict(k_true=K, lb=0.01, plb=0.05, project=True)
    extra = {}
    if variant.startswith("emit"):
        kw.update(emit_b=True, emit_a=variant == "emit_ab")
    elif variant == "kmask":
        kw["k_true"] = Kp
        extra["kmask"] = (torch.arange(Kp, device=dev) < K).float()
    elif variant == "project_eta_off":
        kw["project_eta"] = False
    elif variant == "a0":
        kw.update(emit_a=True, emit_b=True)
        extra["a0"] = torch.rand((2, 1001, Kp), device=dev)
    else:
        kw["project"] = False
    if route == "streamed":
        got = fb.admixture_fullstep_biallelic_streamed(
            *args, seg_cols=1056, **kw, **extra)
    else:
        got = fb.admixture_fullstep_biallelic_chunked(
            *args, window=1312, **kw, **extra)
    ref = fb.admixture_fullstep_biallelic_chunked_reference(
        *args, window=4099, **kw, **extra)
    torch.cuda.synchronize()
    assert len(got) == len(ref) == (4 if kw.get("emit_b") else 3)
    _stream_close(got, ref)


@pytest.mark.cuda
def test_rows_pass_terms_and_each_new_kernel_alone():
    """The segmented rows pass, its finish and the windowed columns pass,
    each against its plain version; the t-only pass skips A."""
    dev = _cuda()
    K, Kp = 20, 32
    eta, p0, x0, x1, c, miss = _step_args(9, 2, 1001, 4099, K, Kp, 0.03, dev)
    win = dict(l_lo=1000, l_hi=3001)
    apart, tpart = fb.rows_partials(eta, p0, x0, x1, seg_cols=512, **win)
    ref_a, ref_t = fb.rows_partials_reference(eta, p0, x0, x1, **win)
    assert apart.shape == (2, 4, 1001, Kp) and tpart.shape == (2, 4, 1001)
    torch.testing.assert_close(apart.sum(dim=1), ref_a[:, 0], **F32)
    torch.testing.assert_close(tpart.double().sum(dim=1), ref_t[:, 0], **F32)
    fin = dict(k_true=K, lb=0.01, project_eta=True)
    got = fb.rows_finish(eta, apart, tpart, c, **fin)
    ref = fb.rows_finish_reference(eta, apart, tpart, c, **fin)
    _stream_close(got, ref)
    for emit_b in (False, True):
        outs = tuple(torch.zeros_like(p0) for _ in range(1 + emit_b))
        refs = tuple(torch.zeros_like(p0) for _ in range(1 + emit_b))
        fb.cols_window(eta, p0, x0, x1, miss, outs, plb=0.05, project=True,
                       **win)
        fb.cols_window_reference(eta, p0, x0, x1, miss, refs, plb=0.05,
                                 project=True, **win)
        _stream_close(outs, refs)
        # nothing outside the window is written
        assert all((o[..., :1000] == 0).all() and (o[..., 3001:] == 0).all()
                   for o in outs)
    before = build.LAUNCHES["mc_fullstep_bi_rows_seg"]
    t = fb.rows_log_likelihood_terms(eta, p0, x0, x1)
    want = fb.admixture_fullstep_biallelic_streamed_reference(
        eta, p0, x0, x1, c, miss, k_true=K, lb=0.01, plb=0.05,
        project=True)[1]
    torch.cuda.synchronize()
    assert build.LAUNCHES["mc_fullstep_bi_rows_seg"] == before + 1
    torch.testing.assert_close(t, want, **F32)


@pytest.mark.cuda
def test_streamed_wrappers_refuse_what_the_kernels_do_not_take():
    dev = _cuda()
    eta, p0, x0, x1, c, miss = _step_args(11, 1, 64, 256, 5, 32, 0.0, dev)
    with pytest.raises(ValueError, match="window"):
        fb.rows_partials(eta, p0, x0, x1, l_lo=0, l_hi=300, seg_cols=64)
    with pytest.raises(ValueError, match="segments"):
        fb.rows_partials(eta, p0, x0, x1, l_lo=0, l_hi=256, seg_cols=0)
    with pytest.raises(ValueError, match="dtype"):
        fb.rows_partials(eta, p0, x0.float(), x1, l_lo=0, l_hi=256,
                         seg_cols=64)
    with pytest.raises(ValueError, match="Kp=1056.*plain step"):
        fb.admixture_fullstep_biallelic_streamed(
            torch.zeros(1, 8, 1056, device=dev),
            torch.zeros(1, 1056, 12, device=dev),
            torch.zeros(8, 12, dtype=torch.int8, device=dev),
            torch.zeros(8, 12, dtype=torch.int8, device=dev),
            torch.zeros(8, device=dev), k_true=1050, lb=0.0, plb=0.0,
            project=False)


@pytest.mark.cuda
@pytest.mark.parametrize("budget,route", [(0, "streamed"),
                                          (3 << 20, "chunked")])
def test_routed_blind_steps_read_no_host(budget, route):
    """Blind admixture steps down the streamed and the chunked route, as
    opt/em.blind_plain_steps calls them, make no host read, and the
    SQUAREM logL takes the rows pass."""
    from multiclust_tpu_torch.convert import model_data_from_numpy, \
        params_from_numpy
    from multiclust_tpu_torch.model import admixture
    from multiclust_tpu_torch.model.common import EMConfig
    from multiclust_tpu_torch.opt import em as em_mod
    from multiclust_tpu_torch.runtime.multistart import _pad_k, _to_bi_repr

    dev = _cuda()
    rng = np.random.default_rng(13)
    I, L, K = 300, 8192, 4
    miss = rng.binomial(2, 0.02, size=(I, L))
    x0 = rng.binomial(2 - miss, 0.5)
    counts = np.stack([x0, 2 - miss - x0], axis=2)
    mask, n_all = np.ones((L, 2), bool), np.full(L, 2)
    eta = rng.dirichlet(np.full(K, 2.0), size=(2, I))
    p0 = rng.uniform(0.2, 0.8, size=(2, K, L))
    p = np.stack([p0, 1 - p0], axis=-1)
    cfg = EMConfig(admixture=True, use_pallas="on", biallelic=True, k_true=K,
                   scratch_budget=budget or fb.SCRATCH_CAP)
    mds = [model_data_from_numpy(counts, miss, mask, n_all, device=d,
                                 dtype=torch.float32) for d in (dev, "cpu")]
    pars = [_to_bi_repr(_pad_k(params_from_numpy(
        eta, p, device=d, dtype=torch.float32), cfg), cfg)
        for d in (dev, "cpu")]
    assert admixture.bi_route(2, mds[0], cfg, 32).name == route
    state = em_mod.init_state(pars[0], cfg)
    n_lane = torch.full((2,), 3, dtype=torch.int64, device=dev)
    before = dict(build.LAUNCHES)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = em_mod.blind_plain_steps(state, mds[0], cfg, n_lane, 3)
        ll = admixture.log_likelihood_bi_repr(out.params, mds[0])[0]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launched = {n: build.LAUNCHES[n] - before[n] for n in build.LAUNCHES}
    assert launched["mc_fullstep_bi_rows"] == 0
    assert launched["mc_fullstep_bi_rows_seg"] >= 4
    assert (launched["fullstep_bi_chunked"] > 0) == (route == "chunked")
    want = pars[1]
    for _ in range(3):
        want, _, _ = admixture.em_step(want, mds[1], cfg, want_ll=False)
    torch.testing.assert_close(out.params.eta.cpu(), want.eta, **F32)
    torch.testing.assert_close(out.params.p.cpu(), want.p, **F32)
    torch.testing.assert_close(
        ll.cpu(), admixture.log_likelihood_bi_repr(want, mds[1])[0],
        rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# the redesigned rows and columns kernels: lane tiles, load paths, windows

@pytest.mark.cuda
@pytest.mark.parametrize("K,Kp", [(3, 32), (20, 32), (21, 32), (32, 32),
                                  (40, 64), (70, 96), (100, 128),
                                  (128, 128)])
@pytest.mark.parametrize("I,L,l_lo,l_hi,miss_rate", [
    (1000, 1003, 0, 1003, 0.03),     # L % 4 != 0: byte loads
    (1000, 1024, 40, 1000, 0.0),     # aligned window, vector loads
    (777, 1024, 41, 999, 0.03),      # odd window start: byte loads
    (9, 7, 0, 7, 0.1),               # smaller than one tile either way
])
def test_redesigned_kernels_match_plain(K, Kp, I, L, l_lo, l_hi, miss_rate):
    """The segmented rows pass (1 and 33 column segments, t and A on and
    off) and the windowed columns pass (1 and 3 row segments, p0' and raw
    B0/B1) against their plain versions; reruns bit-equal; lanes past
    k_true exact."""
    dev = _cuda()
    eta, p0, x0, x1, c, miss = _step_args(K + L, 2, I, L, K, Kp, miss_rate,
                                          dev)
    win = dict(l_lo=l_lo, l_hi=l_hi)
    W = l_hi - l_lo
    ref_a, ref_t = fb.rows_partials_reference(eta, p0, x0, x1, **win)
    for n_seg in (1, 33):
        seg_cols = max(32, -(-W // n_seg // 32) * 32)
        apart, tpart = fb.rows_partials(eta, p0, x0, x1, seg_cols=seg_cols,
                                        k_true=K, **win)
        assert apart.shape[1] == tpart.shape[1] == -(-W // seg_cols)
        torch.testing.assert_close(apart.sum(dim=1), ref_a[:, 0], **F32)
        torch.testing.assert_close(tpart.double().sum(dim=1), ref_t[:, 0],
                                   **F32)
        again = fb.rows_partials(eta, p0, x0, x1, seg_cols=seg_cols,
                                 k_true=K, **win)
        assert torch.equal(apart, again[0]) and torch.equal(tpart, again[1])
        none, t_only = fb.rows_partials(eta, p0, x0, x1, seg_cols=seg_cols,
                                        k_true=K, compute_a=False, **win)
        assert none is None and torch.equal(t_only, tpart)
        a_only, t_zero = fb.rows_partials(eta, p0, x0, x1, seg_cols=seg_cols,
                                          k_true=K, compute_t=False, **win)
        assert torch.equal(a_only, apart) and (t_zero == 0).all()
    for n_rseg in (1, 3):
        for emit_b in (False, True):
            outs = tuple(torch.zeros_like(p0) for _ in range(1 + emit_b))
            refs = tuple(torch.zeros_like(p0) for _ in range(1 + emit_b))
            twice = tuple(torch.zeros_like(p0) for _ in range(1 + emit_b))
            kw = dict(plb=0.05, project=True, **win)
            fb.cols_window(eta, p0, x0, x1, miss, outs, k_true=K,
                           n_rseg=n_rseg, **kw)
            fb.cols_window(eta, p0, x0, x1, miss, twice, k_true=K,
                           n_rseg=n_rseg, **kw)
            fb.cols_window_reference(eta, p0, x0, x1, miss, refs, **kw)
            _stream_close(outs, refs)
            for o, t in zip(outs, twice):
                assert torch.equal(o, t)
                assert (o[:, K:] == 0).all()
                assert (o[..., :l_lo] == 0).all() and \
                    (o[..., l_hi:] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("K,Kp", [(3, 32), (21, 32), (40, 64), (100, 128)])
def test_fused_rows_kernel_matches_plain(K, Kp):
    """The pair's rows kernel (fused eta finish) at a ragged shape."""
    dev = _cuda()
    eta, p0, x0, x1, c, _ = _step_args(K, 2, 1000, 1003, K, Kp, 0.03, dev)
    for project, compute_t in ((True, True), (False, False)):
        kw = dict(k_true=K, lb=0.01, project=project, compute_t=compute_t)
        got = fb.fullstep_bi_rows(eta, p0, x0, x1, c, **kw)
        ref = fb.fullstep_bi_rows_reference(eta, p0, x0, x1, c, **kw)
        _stream_close(got, ref)
        assert (got[0][..., K:] == 0).all()
        again = fb.fullstep_bi_rows(eta, p0, x0, x1, c, **kw)
        assert all(torch.equal(u, v) for u, v in zip(got, again))


@pytest.mark.cuda
def test_routed_pair_takes_the_routes_row_segments():
    """The pair under a route: its columns pass splits I as the route
    says (bit-equal to the same split asked of the pass directly)."""
    dev = _cuda()
    K, Kp = 20, 32
    eta, p0, x0, x1, c, miss = _step_args(7, 2, 1000, 1024, K, Kp, 0.03, dev)
    kw = dict(k_true=K, lb=0.01, plb=0.05, project=True)
    route = fb.Route("pair", 0, 1024, 0, 3)
    got = fb.admixture_fullstep_biallelic_routed(eta, p0, x0, x1, c, miss,
                                                 route=route, **kw)
    ref = fb.admixture_fullstep_biallelic_reference(eta, p0, x0, x1, c, miss,
                                                    **kw)
    _stream_close(got, ref)
    direct = fb.fullstep_bi_cols(eta, p0, x0, x1, miss, plb=0.05,
                                 project=True, k_true=K, n_rseg=3)
    assert torch.equal(got[2], direct)


@pytest.mark.cuda
@pytest.mark.parametrize("Kp", [32, 64, 96, 128])
def test_tiles_match_the_python_mirror(Kp):
    """``lane_tile``, ``rows_block`` and ``cols_tile`` against the built
    library's own arithmetic (csrc/tiles.cuh, the tiles of the biallelic
    and of the generic kernels, whose segments ops/fullstep.py computes
    from the same mirror)."""
    _cuda()
    lib = build.library()
    for K in range(0, Kp + 1):
        kc, row_block, col_block, col_rows = build.kernel_tiles(lib, K, Kp)
        assert kc == fb.lane_tile(K, Kp).kc
        assert row_block == fb.rows_block(K, Kp)
        assert (col_block, col_rows) == fb.cols_tile(K, Kp)


@pytest.mark.cuda
def test_build_reports_no_spills():
    """The -Xptxas -v report of every kernel of csrc/fullstep_bi.cu, of
    the generic rows and columns passes of csrc/fullstep.cu and of the
    mixture rows and columns passes of csrc/mixture_bi.cu, narrow and wide
    (both stream variants): none spills, at every Kp; the rows finish (with A at every
    Kp, and t-only) in both admixture sources and the generic p epilogue
    at every lane split (G lanes a locus, MJ slots a lane; up to M = 1024)
    among them."""
    from multiclust_tpu_torch.kernel_report import ptxas_lines

    _cuda()
    build.library()
    report = build.library_path().with_suffix(".ptxas.txt").read_text()
    lines = ptxas_lines(
        report, "fullstep_(?:bi_)?(?:rows|cols)|fullstep_bi_p0|rows_finish"
        "|fullstep_p_kernel|mix_(?:rows|cols)")
    assert all(" 0 bytes spill stores, 0 bytes spill loads" in text
               for _, text in lines), lines
    names = [name for name, _ in lines]
    for kernel in ("fullstep_rows_kernel", "fullstep_cols_kernel",
                   "fullstep_bi_rows_kernel", "fullstep_bi_rows_seg_kernel",
                   "fullstep_bi_cols_kernel"):
        for kp in (32, 64, 96, 128):
            assert f"{kernel}<{kp}>" in names, (kernel, kp, names)
    for kernel in ("mix_rows_kernel", "mix_cols_kernel"):
        for kp in (32, 64, 96, 128):
            for two in ("false", "true"):
                assert f"{kernel}<{kp}, {two}>" in names, (kernel, kp, names)
    for kp in (32, 64, 96, 128):
        assert names.count(f"rows_finish_kernel<{kp}>") == 2, names
    assert names.count("rows_finish_t_kernel") == 2, names
    assert "fullstep_bi_p0_kernel" in names, names
    for g, mj in ((4, 1), (8, 1), (16, 1), (32, 1), (32, 2), (32, 4),
                  (32, 8), (32, 32)):
        assert f"fullstep_p_kernel<{g}, {mj}>" in names, names
    # the finish kernels are built into both admixture sources (4 + 1
    # instances each), the generic rows pass with its dense and its
    # sparse cells; 8 generic p epilogues; 16 mixture passes and the 4
    # wide ones (scores and columns, one and two streams)
    for kernel in ("mix_rows_wide_kernel", "mix_cols_wide_kernel"):
        for two in ("false", "true"):
            assert f"{kernel}<{two}>" in names, (kernel, names)
    assert len(names) == 63, names


# ---------------------------------------------------------------------------
# the segment reductions: the rows finish and the p0 epilogue

SEGMENTS = [1, 3, 8, 62, 64, 256]
LANES = [(20, 32), (40, 64), (70, 96), (100, 128)]


def _finish_args(seed, B, I, K, Kp, n_seg, dev):
    """eta with zero pads, the partials apart [B, n_seg, I, Kp] with one
    value a (segment, row) on every lane past the lane tile of K, as the
    rows passes write them, tpart, a seed a0 whose pad lanes differ, c."""
    rng = np.random.default_rng(seed)
    kc = fb.lane_tile(K, Kp).kc
    eta = np.zeros((B, I, Kp), np.float32)
    eta[..., :K] = rng.dirichlet(np.full(K, 0.3), size=(B, I))
    apart = rng.uniform(-1.0, 3.0, size=(B, n_seg, I, Kp)).astype(np.float32)
    apart[..., kc:] = apart[..., kc:kc + 1]
    t = lambda a: torch.tensor(a, device=dev)
    return (t(eta), t(apart),
            t(rng.normal(-50.0, 20.0, size=(B, n_seg, I)).astype(np.float32)),
            t(rng.uniform(0.0, 2.0, size=(B, I, Kp)).astype(np.float32)),
            t(rng.uniform(0.0, 4.0, size=I).astype(np.float32)))


@pytest.mark.cuda
@pytest.mark.parametrize("K,Kp", LANES)
@pytest.mark.parametrize("n_seg", SEGMENTS)
def test_finish_kernel_sums_the_segments_in_order(K, Kp, n_seg):
    """The rows finish at 1 and 4 chains on a ragged I: the raw A (emit_a,
    with and without a0) and t bit-equal to the partials added one
    segment after another (float32 and float64), pad lanes included; eta'
    (static lanes, a runtime kmask, the Michelot off) against the plain
    finish of that sum; the t-only and the t-off variants; reruns
    bit-equal."""
    dev = _cuda()
    I = 1001 if n_seg <= 8 else 301
    kmask = (torch.arange(Kp, device=dev) < K - 3).float()
    for B in (1, 4):
        eta, apart, tpart, a0, c = _finish_args(K + n_seg + B, B, I, K, Kp,
                                                n_seg, dev)
        fin = dict(k_true=K, lb=0.01)
        t_want = fb.ordered_segment_sum(tpart, dtype=torch.float64)
        for seed in (None, a0):
            got, t = fb.rows_finish(eta, apart, tpart, c, seed, **fin,
                                    project_eta=True, emit_a=True)
            assert torch.equal(got, fb.ordered_segment_sum(apart, seed))
            assert torch.equal(t, t_want)
        araw = fb.ordered_segment_sum(apart)
        for kw in (dict(project_eta=True), dict(project_eta=False),
                   dict(project_eta=True, kmask=kmask)):
            got, t = fb.rows_finish(eta, apart, tpart, c, **fin, **kw)
            again = fb.rows_finish(eta, apart, tpart, c, **fin, **kw)
            want = fb.finish_eta_reference(eta, araw, c, **fin, **kw)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, **F32)
            assert (got[..., K:] == 0).all()
            assert torch.equal(t, t_want)
            assert torch.equal(got, again[0]) and torch.equal(t, again[1])
        none, t = fb.rows_finish(eta, None, tpart, c, **fin,
                                 project_eta=True)
        assert none is None and torch.equal(t, t_want)
        _, t_off = fb.rows_finish(eta, apart, tpart, c, **fin,
                                  project_eta=True, compute_t=False)
        assert (t_off == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("K,Kp", LANES)
@pytest.mark.parametrize("n_seg", SEGMENTS)
def test_p0_epilogue_sums_the_segments_in_order(K, Kp, n_seg):
    """The p0 epilogue alone at 1 and 4 chains, on a window of 16-byte
    units (L = 1024, [64, 576)) and of single columns (L = 1003, [1,
    1000)): raw B0/B1 (emit_b) bit-equal to the partials added one segment
    after another, p0' (clipped and not) against the plain update of that
    sum; the lanes past the lane tile are not read (NaN there) and come
    out 0; nothing outside the window is written; reruns bit-equal."""
    dev = _cuda()
    kc = fb.lane_tile(K, Kp).kc
    for B, (L, lo, hi) in ((1, (1024, 64, 576)), (4, (1003, 1, 1000))):
        if n_seg > 8:
            hi = lo + 160
        rng = np.random.default_rng(K + n_seg + B)
        part = rng.uniform(0.0, 50.0, size=(B, n_seg, 2, Kp, hi - lo))
        part[:, :, :, kc:] = np.nan
        part = torch.tensor(part.astype(np.float32), device=dev)
        p0 = np.zeros((B, Kp, L), np.float32)
        p0[:, :K] = rng.uniform(0.0, 1.0, size=(B, K, L))
        p0 = torch.tensor(p0, device=dev)
        win = dict(l_lo=lo, l_hi=hi, k_true=K, plb=0.05)
        b = [fb.ordered_segment_sum(part[:, :, a]) for a in (0, 1)]
        for out in b:
            out[:, kc:] = 0.0
        outs = (torch.zeros_like(p0), torch.zeros_like(p0))
        fb.p0_epilogue(p0, part, outs, project=True, **win)
        for o, want in zip(outs, b):
            assert torch.equal(o[..., lo:hi], want)
            assert (o[..., :lo] == 0).all() and (o[..., hi:] == 0).all()
        for project in (True, False):
            got, again = torch.zeros_like(p0), torch.zeros_like(p0)
            fb.p0_epilogue(p0, part, (got,), project=project, **win)
            fb.p0_epilogue(p0, part, (again,), project=project, **win)
            want = fb.p0_update_reference(p0[..., lo:hi], *b, plb=0.05,
                                          project=project)
            torch.cuda.synchronize()
            torch.testing.assert_close(got[..., lo:hi], want, **F32)
            assert (got[:, kc:] == 0).all() and torch.equal(got, again)
            assert (got[..., :lo] == 0).all() and (got[..., hi:] == 0).all()


@pytest.mark.cuda
def test_segment_reductions_read_no_host():
    """The finish, the biallelic p0 epilogue alone and inside the columns
    pass, and the generic p epilogue make no host read; each launch is
    counted under its own entry point."""
    dev = _cuda()
    K, Kp, n_seg = 20, 32, 8
    eta, apart, tpart, a0, c = _finish_args(5, 2, 1001, K, Kp, n_seg, dev)
    _, p0, x0, x1, _, miss = _step_args(5, 2, 1001, 1024, K, Kp, 0.02, dev)
    part = torch.rand((2, n_seg, 2, Kp, 1024), device=dev)
    outs = [torch.zeros_like(p0) for _ in range(3)]
    before = dict(build.LAUNCHES)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fb.rows_finish(eta, apart, tpart, c, a0, k_true=K, lb=0.01,
                       project_eta=True)
        fb.rows_finish(eta, None, tpart, c, k_true=K, lb=0.01,
                       project_eta=True)
        fb.p0_epilogue(p0, part, outs[:1], l_lo=0, l_hi=1024, k_true=K,
                       plb=0.05, project=True)
        fb.cols_window(eta, p0, x0, x1, miss, outs[1:], l_lo=0, l_hi=1024,
                       plb=0.05, project=True, k_true=K, n_rseg=3)
        fs.fullstep_p(p0, part[:, :, 0].contiguous(),
                      torch.ones((512, 2), dtype=torch.bool, device=dev),
                      M=2, k_true=K, plb=0.05, project=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launched = {n: build.LAUNCHES[n] - before[n] for n in build.LAUNCHES}
    assert launched["mc_fullstep_bi_finish"] == 2
    assert launched["mc_fullstep_bi_cols"] == 1
    assert launched["mc_fullstep_bi_p0"] == 1
    assert launched["mc_fullstep_p"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("M", [2, 3, 4, 7, 8, 20, 64, 100, 300, 1024])
def test_generic_p_epilogue_sums_the_segments_in_order(M):
    """The generic p epilogue at 1 and 4 chains over 1, 3 and 64 segments,
    K = 21 of Kp = 32 (lanes 21-23 of the lane tile zero, as the columns
    pass leaves them; lanes 24-31 NaN: not read, they come out 0): raw B
    (finish=False) bit-equal to the partials added one segment after
    another; p', projected and not, against the plain normalization of
    that sum; reruns bit-equal."""
    dev = _cuda()
    K, Kp = 21, 32
    kc = fb.lane_tile(K, Kp).kc
    L = max(3, 2048 // M)
    rng = np.random.default_rng(M)
    mask = rng.random((L, M)) < 0.7
    mask[:, 0] = True
    p = np.where(mask, rng.uniform(0.1, 1.0, size=(4, Kp, L, M)), 0.0)
    p[:, K:] = 0.0
    mask_t = torch.tensor(mask, device=dev)
    for B in (1, 4):
        p2 = torch.tensor(p[:B].reshape(B, Kp, L * M).astype(np.float32),
                          device=dev)
        for n_seg in (1, 3, 64):
            part = rng.uniform(0.0, 5.0, size=(B, n_seg, Kp, L * M))
            part[:, :, K:kc] = 0.0
            part[:, :, kc:] = np.nan
            part = torch.tensor(part.astype(np.float32), device=dev)
            want = fb.ordered_segment_sum(part)
            want[:, kc:] = 0.0
            raw = fs.fullstep_p(p2, part, mask_t, M=M, k_true=K,
                                finish=False)
            assert torch.equal(raw, want)
            for project in (True, False):
                kw = dict(M=M, k_true=K, plb=0.01, project=project)
                got = fs.fullstep_p(p2, part, mask_t, **kw)
                again = fs.fullstep_p(p2, part, mask_t, **kw)
                ref = fs.normalize_p((p2 * want).view(B, Kp, L, M), mask_t,
                                     k_true=K, plb=0.01, project=project)
                torch.cuda.synchronize()
                torch.testing.assert_close(got, ref, **F32)
                assert (got[:, K:] == 0).all() and torch.equal(got, again)


def _lattice(dev, admixture, R=3, B=2, I=2048, L=1024, K=3):
    """An R x B bootstrap lattice on the card: replicates of a simulated
    panel drawn from random H0 parameters, and their K-padded starts in
    the layout the chains run."""
    from multiclust_tpu_torch.config import Options
    from multiclust_tpu_torch.convert import params_from_numpy
    from multiclust_tpu_torch.model.common import map_params, \
        model_data_from_planes
    from multiclust_tpu_torch.route_times import device_panel
    from multiclust_tpu_torch.runtime.multistart import _to_bi_repr, \
        cfg_from_options
    from multiclust_tpu_torch.stats import bootstrap as bs

    md = model_data_from_planes(*device_panel(3, I, L, K, 0.01, dev))
    opt = Options(admixture=admixture, min_K=K, max_K=K, n_init=B,
                  n_bootstrap=R).synchronize(I, 2)
    cfg = cfg_from_options(opt, K, md)
    rng = np.random.default_rng(4)
    p0 = rng.uniform(0.05, 0.95, size=(K, L))
    h0 = params_from_numpy(
        rng.dirichlet(np.ones(K), size=I if admixture else None),
        np.stack([p0, 1 - p0], axis=2), device=dev, dtype=torch.float32)
    reps = [bs.draw_replicate(7, r, md, h0, 2, admixture) for r in range(R)]
    starts = [bs.replicate_starts(7, r, K, rep, cfg, opt, 2)
              for r, rep in enumerate(reps)]
    params = _to_bi_repr(map_params(lambda *t: torch.cat(t), *starts), cfg)
    return md, reps, params, cfg


def _route_launches(admixture) -> int:
    """The fewest launches of a kernel of the step's route since the
    counts were reset: the biallelic admixture step's columns pass and
    either rows pass, or each of the four mixture kernels."""
    if admixture:
        return min(build.LAUNCHES["mc_fullstep_bi_cols"],
                   build.LAUNCHES["mc_fullstep_bi_rows"]
                   + build.LAUNCHES["mc_fullstep_bi_rows_seg"])
    return min(build.LAUNCHES[k] for k in MIX_KERNELS)


@pytest.mark.cuda
@pytest.mark.parametrize("admixture", [True, False])
def test_lattice_step_is_each_replicates_step(admixture):
    """A lattice's model step (opt/em.model_em_step over all R x B lanes)
    reads nothing from the device and gives, bit for bit, each
    replicate's own routed step of its B chains; so does its logL."""
    from multiclust_tpu_torch.model.common import Lattice, map_params
    from multiclust_tpu_torch.opt import em as em_mod

    dev = _cuda()
    _, reps, params, cfg = _lattice(dev, admixture)
    R, B = len(reps), params.eta.shape[0] // len(reps)
    lat = Lattice(reps=tuple(reps), B=B, live=frozenset(range(R)))
    build.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        new, ll, scale = em_mod.model_em_step(params, lat, cfg)
        ll2, _ = em_mod.model_log_likelihood(new, lat, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert _route_launches(admixture) >= R, build.LAUNCHES
    for r, rep in enumerate(reps):
        lanes = slice(r * B, (r + 1) * B)
        own = map_params(lambda t: t[lanes], params)
        ref, ref_ll, ref_scale = em_mod.model_em_step(own, rep, cfg)
        assert torch.equal(new.eta[lanes], ref.eta)
        assert torch.equal(new.p[lanes], ref.p)
        assert torch.equal(ll[lanes], ref_ll)
        assert torch.equal(scale[lanes], ref_scale)
        assert torch.equal(ll2[lanes], em_mod.model_log_likelihood(
            ref, rep, cfg)[0])
    # a replicate out of ``live`` keeps its lanes as they are
    frozen = lat._replace(live=frozenset({0}))
    out, _, _ = em_mod.model_em_step(params, frozen, cfg)
    assert torch.equal(out.p[B:], params.p[B:])
    assert torch.equal(out.p[:B], new.p[:B])


@pytest.mark.cuda
@pytest.mark.parametrize("admixture", [True, False])
def test_simulate_replicate_on_the_card_keeps_miss(admixture):
    """Replicates drawn on the card keep every missing copy: x0 + x1 =
    ploidy - miss, int8 planes, md's own miss tensor."""
    dev = _cuda()
    md, reps, _, _ = _lattice(dev, admixture)
    for rep in reps:
        assert rep.x0.dtype == torch.int8 and rep.miss is md.miss
        assert torch.equal(rep.x0.int() + rep.x1.int(), 2 - md.miss.int())
    assert not torch.equal(reps[0].x0, reps[1].x0)


@pytest.mark.cuda
@pytest.mark.parametrize("admixture", [True, False])
def test_bootstrap_api_run_at_4096_x_2048(admixture):
    """A -b 4 run through the API on a 4096 x 2048 panel made on the card:
    finite statistics, a p-value of the direct count, every replicate in
    one lattice, and the kernels of the route launched."""
    from multiclust_tpu_torch.api import fit_model_data
    from multiclust_tpu_torch.model.common import model_data_from_planes
    from multiclust_tpu_torch.route_times import device_panel

    dev = _cuda()
    md = model_data_from_planes(*device_panel(5, 4096, 2048, 3, 0.01, dev))
    build.reset_launch_counts()
    out = fit_model_data(md, 2, admixture=admixture, min_K=3, max_K=3,
                         n_init=2, n_bootstrap=4, max_iter=100, seed=3,
                         verbosity=0)
    boot = out.bootstrap
    ts = np.asarray(boot.ts_bs)
    assert len(ts) == 4 and np.isfinite(ts).all() and boot.chunk == 4
    assert boot.pvalue == (ts >= out.estimate.ts).sum() / 4
    assert _route_launches(admixture) > 0, build.LAUNCHES


def _jagged_panel(dev, I=16384, B=2, K=20, Kp=32, miss_rate=0.01, seed=7):
    """A jagged panel made on the card from a seed, and its bucketing:
    interleaved loci with 2, 3, 4 and 8 alleles (200, 64, 80 and 100 of
    them), so the plan has a 64-locus bucket at M_b = 3, one at M_b = 4
    and counts drawn uniformly on each locus's slots; K-padded float32
    parameters of B chains on its buckets, and the EMConfig of a float32
    fit with the kernels on."""
    from multiclust_tpu_torch.model import bucketed as bk
    from multiclust_tpu_torch.model.common import EMConfig, Params, \
        make_model_data

    rng = np.random.default_rng(seed)
    n_all = rng.permutation(np.repeat([2, 3, 4, 8], [200, 64, 80, 100]))
    L, M = n_all.size, 8
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_dev = torch.as_tensor(n_all, device=dev)
    mask = torch.arange(M, device=dev)[None] < n_dev[:, None]
    miss = (torch.rand((I, L, 2), generator=gen, device=dev)
            < miss_rate).sum(dim=-1).to(torch.int8)
    counts = torch.zeros((I, L, M), dtype=torch.int8, device=dev)
    for a in range(2):
        allele = (torch.rand((I, L), generator=gen, device=dev)
                  * n_dev).long()
        counts.scatter_add_(2, allele[..., None],
                            (a < 2 - miss)[..., None].to(torch.int8))
    md = make_model_data(counts, miss, mask, n_dev, dtype=torch.float32,
                         device=dev, storage_dtype=torch.int8)
    plan = bk.plan_for(md)
    assert plan.Ms == (2, 3, 4, 8) and plan.Ls == (200, 64, 80, 100)
    bd = bk.bucketize_model_data(md, plan)
    eta = torch.zeros((B, I, Kp), device=dev)
    eta[..., :K] = torch.rand((B, I, K), generator=gen, device=dev) + 0.05
    eta /= eta.sum(dim=-1, keepdim=True)
    p = torch.zeros((B, Kp, L, M), device=dev)
    p[:, :K] = (torch.rand((B, K, L, M), generator=gen, device=dev)
                + 0.05) * mask
    p /= p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    cfg = EMConfig(admixture=True, has_missing=True, use_pallas="on",
                   k_true=K)
    return md, bd, bk.split_params_like(Params(eta, p), bd), cfg


@pytest.mark.cuda
@pytest.mark.parametrize("want_ll", [True, False])
def test_bucketed_step_matches_plain(want_ll):
    """The bucketed admixture step through the generic kernels at I =
    16384 (one launch chain a bucket, a 64-locus bucket at M_b = 3 among
    them) against its plain version on the same tensors, with no host
    read, and against the dense step on the same parameters; reruns are
    bit-equal."""
    from multiclust_tpu_torch.model import admixture as adm, \
        bucketed as bk

    dev = _cuda()
    md, bd, params, cfg = _jagged_panel(dev)
    build.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = adm.em_step(params, bd, cfg, want_ll)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for name in GENERIC_KERNELS:
        assert build.LAUNCHES[name] == len(bd.buckets), build.LAUNCHES
    ref = adm.em_step(params, bd, cfg._replace(use_pallas="off"), want_ll)
    for g, r in zip(got[0].p, ref[0].p):
        torch.testing.assert_close(g, r, **F32)
    torch.testing.assert_close(got[0].eta, ref[0].eta, **F32)
    torch.testing.assert_close(got[1], ref[1], rtol=1e-6, atol=0)
    dense = adm.em_step(bk.merge_params_like(params, bd), md, cfg, want_ll)
    torch.testing.assert_close(bk.merge_params_like(got[0], bd).p,
                               dense[0].p, **F32)
    torch.testing.assert_close(got[0].eta, dense[0].eta, **F32)
    again = adm.em_step(params, bd, cfg, want_ll)
    assert torch.equal(got[0].eta, again[0].eta)
    assert all(torch.equal(g, a) for g, a in zip(got[0].p, again[0].p))
    assert torch.equal(got[1], again[1])


@pytest.mark.cuda
def test_bucketed_mixture_step_matches_plain():
    """The bucketed mixture step, its eta finish (the finish's eta half,
    mc_mix_finish) and each
    bucket's p epilogue (mc_fullstep_p at M_b) on the card, against the
    plain finish on the same tensors."""
    from multiclust_tpu_torch.model import mixture as mix
    from multiclust_tpu_torch.model.common import Params

    dev = _cuda()
    _, bd, params, cfg = _jagged_panel(dev, I=4096, B=2)
    K = cfg.k_true
    eta = torch.rand((2, K), device=dev) + 0.1
    params = Params(eta / eta.sum(dim=-1, keepdim=True),
                    tuple(p[:, :K].contiguous() for p in params.p))
    cfg = cfg._replace(admixture=False, k_true=0)
    build.reset_launch_counts()
    got = mix.em_step(params, bd, cfg)
    assert build.LAUNCHES["mc_mix_finish"] == 1
    assert build.LAUNCHES["mc_fullstep_p"] == len(bd.buckets)
    ref = mix.em_step(params, bd, cfg._replace(use_pallas="off"))
    torch.testing.assert_close(got[0].eta, ref[0].eta, **F32)
    for g, r in zip(got[0].p, ref[0].p):
        torch.testing.assert_close(g, r, **F32)
    assert torch.equal(got[1], ref[1])


@pytest.mark.cuda
@pytest.mark.parametrize("label,kw", [
    ("QN", dict(admixture=True, accel_scheme=4, q=2)),
    ("-a -c", dict(admixture=True, eta_constrained=True)),
    ("mixture, SQUAREM", dict(admixture=False, accel_scheme=1)),
    ("K-sweep", dict(admixture=True, min_K=2)),
])
def test_bucketed_api_fits_on_the_card(tmp_path, label, kw):
    """api.fit_model_data on a jagged panel on the card fits bucketed by
    default, returns dense p with exact zeros off the mask, and a run
    resumed from its checkpoint returns the same parameters without a
    launch."""
    from multiclust_tpu_torch.api import fit_model_data

    dev = _cuda()
    md, bd, _, _ = _jagged_panel(dev, I=2048)
    opts = {**dict(min_K=3, max_K=3, n_init=2, max_iter=60, seed=4,
                   verbosity=0, checkpoint_dir=str(tmp_path)), **kw}
    out = fit_model_data(md, 2, **opts)
    for res in out.estimate.per_K.values():
        assert res.buckets == bd.plan.describe(), res.buckets
        eta, p = res.best_params
        assert np.isfinite(res.max_logL) and not res.any_failed
        assert p.shape == (res.K, md.L, md.M) and p.is_cuda
        assert (p[:, ~md.mask] == 0).all()
        torch.testing.assert_close(p.sum(dim=-1), torch.ones_like(p[..., 0]),
                                   rtol=0, atol=1e-5)
    build.reset_launch_counts()
    again = fit_model_data(md, 2, **opts)
    assert not any(build.LAUNCHES.values()), build.LAUNCHES
    for K, res in again.estimate.per_K.items():
        assert torch.equal(res.best_params.p,
                           out.estimate.per_K[K].best_params.p)


@pytest.mark.cuda
def test_mesh_collectives_under_nccl_at_world_size_one(tmp_path):
    """runtime/mesh.py's helpers on card tensors through an NCCL group of
    one rank: the sums over both subgroups (float32 and float64), the row
    and loci gathers, broadcast and the host-flag helpers."""
    _cuda()
    import torch.distributed as dist

    from multiclust_tpu_torch.runtime import mesh as mesh_mod

    dev = mesh_mod.initialize_distributed(
        num_processes=1, process_id=0, device="cuda",
        init_method="file://" + str(tmp_path / "init"))
    try:
        assert dist.get_backend() == "nccl"
        mesh = mesh_mod.make_mesh((1, 1))
        gen = torch.Generator(device=dev).manual_seed(5)
        for dtype in (torch.float32, torch.float64):
            x = torch.rand((2, 300, 32), generator=gen, device=dev,
                           dtype=dtype)
            # a mesh's sums skip an axis of one shard: the collectives run
            # on its groups themselves, the gather as Mesh.gather makes it
            for group, (lo, hi) in ((mesh.data_group, mesh.rows(300)),
                                    (mesh.model_group, mesh.loci(300))):
                got = x.clone()
                dist.all_reduce(got, group=group)
                assert torch.equal(got, x)
                whole = x.new_zeros(x.shape)
                whole.narrow(1, lo, hi - lo).copy_(x[:, lo:hi])
                dist.all_reduce(whole, group=group)
                assert torch.equal(whole, x)
        y = torch.arange(4, device=dev, dtype=torch.float64)
        assert torch.equal(mesh.broadcast(y.clone()), y)
        assert mesh_mod.sync_host_flag(True) and \
            not mesh_mod.sync_host_flag(False)
        assert mesh_mod.world_min(11) == 11
        flags = torch.tensor([False, True], device=dev)
        assert torch.equal(mesh_mod.any_over_world(flags), flags)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the wide kernels (csrc/wide.cuh): 128 < Kp <= 1024

WIDE_LANES = [(130, 160), (200, 224), (500, 512), (1024, 1024)]
WIDE_COUNTS = ("wide_rows", "wide_finish", "wide_cols_bi")
# the launchers of a wide window: both passes on one d, the finish, the
# p0 epilogue
WIDE_STREAM_KERNELS = ("mc_fullstep_bi_window", "mc_fullstep_bi_finish",
                       "mc_fullstep_bi_p0")


@pytest.mark.cuda
@pytest.mark.parametrize("K,Kp", WIDE_LANES)
@pytest.mark.parametrize("B,I,L,miss_rate,compute_t,seg_cols,window", [
    (1, 1001, 4099, 0.02, True, 1056, 1312),    # ragged, byte loads
    (2, 640, 2048, 0.0, False, 512, 768),       # aligned, vector loads
])
def test_wide_streamed_and_chunked_kernels_match_plain(
        K, Kp, B, I, L, miss_rate, compute_t, seg_cols, window):
    """The streamed and the chunked step at a wide Kp (both passes of a
    window on one d, the wide finish, the p0 epilogue) against the plain
    version, each wide kernel counted once a window and the narrow
    launchers not at all; reruns bit-equal; the pair refuses the Kp,
    naming the streamed route."""
    dev = _cuda()
    args = _step_args(K + B, B, I, L, K, Kp, miss_rate, dev)
    kw = dict(k_true=K, lb=0.01, plb=0.05, project=True, compute_t=compute_t)
    ref = fb.admixture_fullstep_biallelic_streamed_reference(*args, **kw)
    before = dict(build.LAUNCHES)
    streamed = fb.admixture_fullstep_biallelic_streamed(
        *args, seg_cols=seg_cols, **kw)
    torch.cuda.synchronize()
    for name in WIDE_STREAM_KERNELS + WIDE_COUNTS:
        assert build.LAUNCHES[name] == before[name] + 1, name
    for name in ("mc_fullstep_bi_rows_seg", "mc_fullstep_bi_cols"):
        assert build.LAUNCHES[name] == before[name], name
    chunked = fb.admixture_fullstep_biallelic_chunked(*args, window=window,
                                                      **kw)
    torch.cuda.synchronize()
    n_win = -(-L // window)
    for name in WIDE_COUNTS:
        assert build.LAUNCHES[name] == before[name] + 1 + n_win, name
    for got in (streamed, chunked):
        _stream_close(got, ref)
        assert (got[0][..., K:] == 0).all() and (got[2][:, K:] == 0).all()
    for fn, extra in ((fb.admixture_fullstep_biallelic_streamed,
                       dict(seg_cols=seg_cols)),
                      (fb.admixture_fullstep_biallelic_chunked,
                       dict(window=window))):
        a, b = fn(*args, **extra, **kw), fn(*args, **extra, **kw)
        assert all(torch.equal(u, v) for u, v in zip(a, b))
    with pytest.raises(ValueError, match=f"Kp={Kp}.*streamed"):
        fb.admixture_fullstep_biallelic(*args, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("K,Kp", [(200, 224), (1000, 1024)])
@pytest.mark.parametrize("variant", ["emit_b", "emit_ab", "kmask",
                                     "project_eta_off", "a0", "no_project"])
@pytest.mark.parametrize("route", ["streamed", "chunked"])
def test_wide_streamed_variants_match_plain(K, Kp, variant, route):
    dev = _cuda()
    args = _step_args(7, 2, 1001, 4099, K, Kp, 0.03, dev)
    kw = dict(k_true=K, lb=0.01, plb=0.05, project=True)
    extra = {}
    if variant.startswith("emit"):
        kw.update(emit_b=True, emit_a=variant == "emit_ab")
    elif variant == "kmask":
        kw["k_true"] = Kp
        extra["kmask"] = (torch.arange(Kp, device=dev) < K).float()
    elif variant == "project_eta_off":
        kw["project_eta"] = False
    elif variant == "a0":
        kw.update(emit_a=True, emit_b=True)
        extra["a0"] = torch.rand((2, 1001, Kp), device=dev)
    else:
        kw["project"] = False
    if route == "streamed":
        got = fb.admixture_fullstep_biallelic_streamed(
            *args, seg_cols=1056, **kw, **extra)
    else:
        got = fb.admixture_fullstep_biallelic_chunked(
            *args, window=1312, **kw, **extra)
    ref = fb.admixture_fullstep_biallelic_chunked_reference(
        *args, window=4099, **kw, **extra)
    torch.cuda.synchronize()
    assert len(got) == len(ref) == (4 if kw.get("emit_b") else 3)
    _stream_close(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("K,Kp", WIDE_LANES)
def test_wide_logl_terms_match_plain(K, Kp):
    """The t-only rows pass (A stages skipped) and its t-only finish, in
    one and in several column segments."""
    dev = _cuda()
    eta, p0, x0, x1, _, _ = _step_args(K, 2, 1001, 2051, K, Kp, 0.0, dev)
    want = fb.rows_log_likelihood_terms(eta.cpu(), p0.cpu(), x0.cpu(),
                                        x1.cpu(), k_true=K)
    for seg_cols in (None, 512):
        before = build.LAUNCHES["wide_rows"]
        got = fb.rows_log_likelihood_terms(eta, p0, x0, x1, k_true=K,
                                           seg_cols=seg_cols)
        torch.cuda.synchronize()
        assert build.LAUNCHES["wide_rows"] == before + 1
        torch.testing.assert_close(got.cpu(), want, **F32)


def _wide_finish_args(seed, B, I, K, Kp, n_seg, dev):
    """As _finish_args, with the pad lanes past the wide kernels' kc."""
    rng = np.random.default_rng(seed)
    kc = fb.kc_of(K, Kp)
    eta = np.zeros((B, I, Kp), np.float32)
    eta[..., :K] = rng.dirichlet(np.full(K, 0.3), size=(B, I))
    apart = rng.uniform(-1.0, 3.0, size=(B, n_seg, I, Kp)).astype(np.float32)
    apart[..., kc:] = apart[..., kc:kc + 1]
    t = lambda a: torch.tensor(a, device=dev)
    return (t(eta), t(apart),
            t(rng.normal(-50.0, 20.0, size=(B, n_seg, I)).astype(np.float32)),
            t(rng.uniform(0.0, 2.0, size=(B, I, Kp)).astype(np.float32)),
            t(rng.uniform(0.0, 4.0, size=I).astype(np.float32)))


@pytest.mark.cuda
@pytest.mark.parametrize("K,Kp", [(130, 160), (198, 224), (1021, 1024)])
@pytest.mark.parametrize("n_seg", [1, 3, 64])
def test_wide_finish_and_p0_epilogue_sum_the_segments_in_order(K, Kp,
                                                               n_seg):
    """The wide finish: raw A (emit_a, with and without a0) and t
    bit-equal to the partials added one segment after another, pad lanes
    included; eta' (static lanes, a runtime kmask, the Michelot off)
    against the plain finish of that sum; reruns bit-equal.  The p0
    epilogue at the wide kc: NaN past it is not read."""
    dev = _cuda()
    I = 1001 if n_seg <= 3 else 301
    kmask = (torch.arange(Kp, device=dev) < K - 3).float()
    for B in (1, 3):
        eta, apart, tpart, a0, c = _wide_finish_args(K + n_seg + B, B, I,
                                                     K, Kp, n_seg, dev)
        fin = dict(k_true=K, lb=0.01)
        t_want = fb.ordered_segment_sum(tpart, dtype=torch.float64)
        for seed in (None, a0):
            got, t = fb.rows_finish(eta, apart, tpart, c, seed, **fin,
                                    project_eta=True, emit_a=True)
            assert torch.equal(got, fb.ordered_segment_sum(apart, seed))
            assert torch.equal(t, t_want)
        araw = fb.ordered_segment_sum(apart)
        for kw in (dict(project_eta=True), dict(project_eta=False),
                   dict(project_eta=True, kmask=kmask)):
            got, t = fb.rows_finish(eta, apart, tpart, c, **fin, **kw)
            again = fb.rows_finish(eta, apart, tpart, c, **fin, **kw)
            want = fb.finish_eta_reference(eta, araw, c, **fin, **kw)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, **F32)
            assert (got[..., K:] == 0).all()
            assert torch.equal(t, t_want)
            assert torch.equal(got, again[0]) and torch.equal(t, again[1])
    kc = fb.kc_of(K, Kp)
    rng = np.random.default_rng(K + n_seg)
    L, lo, hi = 1003, 1, 1000
    part = rng.uniform(0.0, 50.0, size=(2, n_seg, 2, Kp, hi - lo))
    part[:, :, :, kc:] = np.nan
    part = torch.tensor(part.astype(np.float32), device=dev)
    p0 = np.zeros((2, Kp, L), np.float32)
    p0[:, :K] = rng.uniform(0.0, 1.0, size=(2, K, L))
    p0 = torch.tensor(p0, device=dev)
    b = [fb.ordered_segment_sum(part[:, :, a]) for a in (0, 1)]
    for out in b:
        out[:, kc:] = 0.0
    got = torch.zeros_like(p0)
    fb.p0_epilogue(p0, part, (got,), l_lo=lo, l_hi=hi, k_true=K, plb=0.05,
                   project=True)
    want = fb.p0_update_reference(p0[..., lo:hi], *b, plb=0.05, project=True)
    torch.testing.assert_close(got[..., lo:hi], want, **F32)
    assert (got[:, kc:] == 0).all()


_WIDE_GENERIC_CASES = [
    # B, I, L, M, K, Kp, miss_rate, compute_t, project
    (1, 1001, 333, 3, 130, 160, 0.02, True, True),   # ragged I and L*M
    (2, 777, 129, 4, 200, 224, 0.0, True, True),
    (1, 300, 101, 8, 500, 512, 0.05, False, True),
    (2, 257, 61, 5, 1024, 1024, 0.02, True, False),
    (1, 1024, 64, 4, 198, 224, 0.02, True, True),    # aligned, vector loads
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,I,L,M,K,Kp,miss_rate,compute_t,project",
                         _WIDE_GENERIC_CASES)
def test_wide_generic_kernels_match_plain(B, I, L, M, K, Kp, miss_rate,
                                          compute_t, project):
    """The generic step at a wide Kp (the wide rows pass with the generic
    cells and its finish, the wide generic columns pass, the p epilogue)
    against its plain version, each wide kernel counted; the sweep
    statistics (finish=False, with the miss fold) and an a0 / emit_a chain
    of two launches; reruns bit-equal."""
    dev = _cuda()
    args = _generic_args(K + L, B, I, L, M, K, Kp, miss_rate, dev)
    eta, p2, x2, c, miss, mask = args
    kw = dict(k_true=K, lb=0.01, plb=0.05, project=project,
              compute_t=compute_t)
    before = dict(build.LAUNCHES)
    got = fs.admixture_fullstep(*args, **kw)
    ref = fs.admixture_fullstep_reference(*args, **kw)
    torch.cuda.synchronize()
    # both passes on one d (mc_fullstep_step), then the p epilogue
    for name in ("mc_fullstep_step", "mc_fullstep_p", "wide_rows",
                 "wide_finish", "wide_cols_generic"):
        assert build.LAUNCHES[name] == before[name] + 1, name
    for name in ("mc_fullstep_rows", "mc_fullstep_cols"):
        assert build.LAUNCHES[name] == before[name], name
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, **F32)
    eta_new, _, p_new = got
    assert (eta_new[..., K:] == 0).all() and (p_new[:, K:] == 0).all()
    assert (p_new[..., ~mask] == 0).all()
    again = fs.admixture_fullstep(*args, **kw)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    sweep = fs.admixture_sweep_stats(eta, p2, x2, miss, M=M, k_true=K)
    A_ref, t_ref = fs.fullstep_rows_reference(eta, p2, x2, k_true=K, lb=0.0,
                                              project=False, finish=False)
    B_ref = fs.fullstep_cols_reference(eta, p2, x2, miss, finish=False)
    for g, r in zip(sweep, (A_ref, t_ref, B_ref)):
        torch.testing.assert_close(g, r, **F32)
    h = (L // 2) * M
    halves = [(p2[..., :h].contiguous(), x2[:, :h].contiguous()),
              (p2[..., h:].contiguous(), x2[:, h:].contiguous())]
    rkw = dict(k_true=K, lb=0.01, project=True)
    A, _ = fs.fullstep_rows(eta, *halves[0], c, finish=False, **rkw)
    A_ref, _ = fs.fullstep_rows_reference(eta, *halves[0], c, finish=False,
                                          **rkw)
    torch.testing.assert_close(A, A_ref, **F32)
    e2, t2 = fs.fullstep_rows(eta, *halves[1], c, A, **rkw)
    e2_ref, t2_ref = fs.fullstep_rows_reference(eta, *halves[1], c, A_ref,
                                                **rkw)
    torch.testing.assert_close(e2, e2_ref, **F32)
    torch.testing.assert_close(t2, t2_ref, **F32)


@pytest.mark.cuda
@pytest.mark.parametrize("Kp", [160, 224, 512, 1024])
def test_wide_tiles_match_the_python_mirror(Kp):
    """kc, the rows-pass block and the columns-pass tile of the wide
    kernels against ``kc_of``, ``rows_block`` and ``cols_tile``."""
    _cuda()
    lib = build.library()
    for K in list(range(0, 40)) + list(range(Kp - 40, Kp + 1)):
        kc, row_block, col_block, col_rows = build.kernel_tiles(lib, K, Kp)
        assert kc == fb.kc_of(K, Kp)
        assert row_block == fb.rows_block(K, Kp)
        assert (col_block, col_rows) == fb.cols_tile(K, Kp)
    # the columns pass's two launches, both cells
    for generic in (False, True):
        assert build.wide_cols_tiles(lib, generic) == (
            fb.cols_tile(0, Kp, generic) + (fb.WIDE_CHUNK, fb.WD_TILE,
                                             fb.WD_TILE, 64))


# the redesigned wide columns pass (csrc/wide.cuh: a d launch and a B
# launch a column sub-window, both on the float64 tensor cores)

def _raw_bi(part, kc):
    """B0/B1 of the partials [B, S, 2, Kp, W] added one segment after
    another, the lanes past kc zero: what the p0 epilogue's raw output
    (emit_b) must equal bit for bit."""
    raw = [fb.ordered_segment_sum(part[:, :, a]) for a in (0, 1)]
    for r in raw:
        r[:, kc:] = 0.0
    return raw


@pytest.mark.cuda
@pytest.mark.parametrize("K,Kp", WIDE_LANES)
@pytest.mark.parametrize("I,L,l_lo,l_hi,miss_rate", [
    (1001, 4099, 0, 4099, 0.02),   # ragged I and L (L % 4 != 0): byte loads
    (1001, 4099, 5, 3001, 0.0),    # a window at l_lo > 0, no miss
    (640, 2048, 512, 2048, 0.03),  # aligned: vector loads, a window
    (640, 2048, 0, 2048, 0.0),     # aligned, all of L, no miss
])
def test_wide_cols_bi_partials_match_plain(K, Kp, I, L, l_lo, l_hi,
                                           miss_rate):
    """The wide biallelic columns pass alone (``cols_partials``) at the
    router's row segments, one and three: the partials' ordered sums
    against the plain B0/B1 (miss folded), the lanes past kc zero; the
    epilogue's raw B0/B1 (emit_b) bit-equal to those ordered sums and its
    p0' against the plain update; one wide launch a call; reruns
    bit-equal."""
    dev = _cuda()
    B = 2
    eta, p0, x0, x1, _, miss = _step_args(K + l_lo, B, I, L, K, Kp,
                                          miss_rate, dev)
    kc = fb.kc_of(K, Kp)
    win = dict(l_lo=l_lo, l_hi=l_hi)
    _, _, b0, b1 = fb.window_stats_reference(eta, p0, x0, x1, miss, l_lo,
                                             l_hi, compute_t=False,
                                             want_a=False)
    want_p = fb.p0_update_reference(p0[..., l_lo:l_hi], b0, b1, plb=0.05,
                                    project=True)
    for n_rseg in (0, 1, 3):
        before = build.LAUNCHES["wide_cols_bi"]
        part = fb.cols_partials(eta, p0, x0, x1, miss, k_true=K,
                                n_rseg=n_rseg, **win)
        again = fb.cols_partials(eta, p0, x0, x1, miss, k_true=K,
                                 n_rseg=n_rseg, **win)
        torch.cuda.synchronize()
        assert build.LAUNCHES["wide_cols_bi"] == before + 2
        assert torch.equal(part, again)
        assert n_rseg == 0 or part.shape[1] == n_rseg
        assert (part[:, :, :, kc:] == 0).all()
        raw = _raw_bi(part, kc)
        torch.testing.assert_close(raw[0], b0, **F32)
        torch.testing.assert_close(raw[1], b1, **F32)
        outs = (torch.zeros_like(p0), torch.zeros_like(p0))
        fb.cols_window(eta, p0, x0, x1, miss, outs, plb=0.05, project=True,
                       k_true=K, n_rseg=n_rseg, **win)
        p_new = torch.zeros_like(p0)
        fb.cols_window(eta, p0, x0, x1, miss, (p_new,), plb=0.05,
                       project=True, k_true=K, n_rseg=n_rseg, **win)
        torch.cuda.synchronize()
        for o, r in zip(outs, raw):
            assert torch.equal(o[..., l_lo:l_hi], r)
        torch.testing.assert_close(p_new[..., l_lo:l_hi], want_p, **F32)
        assert (p_new[:, K:] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("K,Kp", WIDE_LANES)
@pytest.mark.parametrize("l_lo,l_hi", [(0, 4099), (3, 2050)])
def test_wide_cols_sub_windows_are_one_window(monkeypatch, K, Kp, l_lo,
                                              l_hi):
    """A scratch cap small enough for several sub-windows (d launch + B
    launch each, the rows' eta sums from the first): the partials
    bit-equal to those of one sub-window at the same row segments, and
    the generic cells' partials the same; the scratch each plan allocates
    within its cap."""
    dev = _cuda()
    B, I, L = 2, 1001, 4099
    eta, p0, x0, x1, _, miss = _step_args(K, B, I, L, K, Kp, 0.02, dev)
    win = dict(l_lo=l_lo, l_hi=l_hi, k_true=K, n_rseg=3)
    plan = (fb.wide_chunks(fb.kc_of(K, Kp)), fb.device_sm_count(dev))
    whole = fb.cols_partials(eta, p0, x0, x1, miss, **win)
    assert fb.cols_sub_cols(B, I, l_hi - l_lo, *plan) >= l_hi - l_lo
    cap = 4 * B * I * 300
    monkeypatch.setattr(fb, "SCRATCH_CAP", cap)
    sub = fb.cols_sub_cols(B, I, l_hi - l_lo, *plan)
    assert sub == 256
    assert fb.cols_scratch_bytes(B, I, l_hi - l_lo, *plan) <= cap
    assert len(fb.cols_sub_windows(l_lo, l_hi, sub)) > 4
    split = fb.cols_partials(eta, p0, x0, x1, miss, **win)
    torch.cuda.synchronize()
    assert torch.equal(split, whole)
    monkeypatch.undo()
    M = 3
    g_eta, p2, x2, _, g_miss, _ = _generic_args(K + 1, B, I, 333, M, K, Kp,
                                                0.02, dev)
    whole = fs.fullstep_partials(g_eta, p2, x2, g_miss, M=M, k_true=K)
    monkeypatch.setattr(fb, "SCRATCH_CAP", cap)
    monkeypatch.setattr(fs, "SCRATCH_CAP", cap)
    assert fb.cols_sub_cols(B, I, 333 * M, *plan, bi=False) == 256
    split = fs.fullstep_partials(g_eta, p2, x2, g_miss, M=M, k_true=K)
    torch.cuda.synchronize()
    if split.shape == whole.shape:
        assert torch.equal(split, whole)
    torch.testing.assert_close(fb.ordered_segment_sum(split),
                               fb.ordered_segment_sum(whole), **F32)


@pytest.mark.cuda
@pytest.mark.parametrize("K,Kp", WIDE_LANES)
@pytest.mark.parametrize("I,L,M,miss_rate", [
    (1001, 333, 3, 0.02),   # ragged I and L*M = 999 (not a multiple of 4)
    (640, 512, 2, 0.0),     # M = 2, aligned, no miss
    (777, 129, 4, 0.03),    # M = 4, L % 4 != 0 (miss by bytes)
])
def test_wide_cols_generic_partials_match_plain(K, Kp, I, L, M, miss_rate):
    """The wide generic columns pass: its partials' ordered sum against
    the plain B (miss folded), the lanes past kc zero; the p epilogue's
    raw B (finish=False) bit-equal to that ordered sum; one wide launch a
    call; reruns bit-equal."""
    dev = _cuda()
    B = 2
    eta, p2, x2, _, miss, mask = _generic_args(K + L, B, I, L, M, K, Kp,
                                               miss_rate, dev)
    kc = fb.kc_of(K, Kp)
    before = build.LAUNCHES["wide_cols_generic"]
    part = fs.fullstep_partials(eta, p2, x2, miss, M=M, k_true=K)
    again = fs.fullstep_partials(eta, p2, x2, miss, M=M, k_true=K)
    torch.cuda.synchronize()
    assert build.LAUNCHES["wide_cols_generic"] == before + 2
    assert torch.equal(part, again)
    assert (part[:, :, kc:] == 0).all()
    want = fb.ordered_segment_sum(part)
    ref = fs.fullstep_partials_reference(eta, p2, x2, miss)[:, 0]
    torch.testing.assert_close(want, ref, **F32)
    raw = fs.fullstep_p(p2, part, M=M, k_true=K, finish=False)
    assert torch.equal(raw, want)


# the redesigned wide rows pass (csrc/wide.cuh: the A launch on the d
# launch's d; kc 132, 200, 500 and 1024: not a multiple of 8, of 8 but not
# 16, of 4 alone, all of Kp) and the finish at each of its lane counts
WIDE_ROWS_LANES = [(130, 160), (198, 224), (500, 512), (1021, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("K,Kp", WIDE_ROWS_LANES)
@pytest.mark.parametrize("I,L,l_lo,l_hi,seg_cols", [
    (1001, 4099, 0, 4099, 1056),   # ragged I and L: byte loads, 4 segments
    (1001, 4099, 5, 3001, 3000),   # a window at l_lo > 0, one segment
    (640, 2048, 512, 2048, 512),   # aligned: vector loads, 3 segments
])
def test_wide_rows_pass_matches_plain(K, Kp, I, L, l_lo, l_hi, seg_cols):
    """The wide rows pass alone (a d launch and the A launch): the
    segments' raw A + r (r on the lanes past kc) and t summed against the
    plain version, with t and without; t alone (compute_a off) bit-equal
    to the full pass's t; one wide launch a call; reruns bit-equal; an
    emit_a chain of two windows through a0, finished on the second,
    against the plain finish of the whole window."""
    dev = _cuda()
    eta, p0, x0, x1, c, _ = _step_args(K + I, 2, I, L, K, Kp, 0.02, dev)
    win = dict(l_lo=l_lo, l_hi=l_hi)
    ref_a, ref_t = fb.rows_partials_reference(eta, p0, x0, x1, **win)
    n_seg = -(-(l_hi - l_lo) // seg_cols)
    for compute_t in (True, False):
        kw = dict(seg_cols=seg_cols, k_true=K, compute_t=compute_t, **win)
        before = build.LAUNCHES["wide_rows"]
        apart, tpart = fb.rows_partials(eta, p0, x0, x1, **kw)
        again = fb.rows_partials(eta, p0, x0, x1, **kw)
        torch.cuda.synchronize()
        assert build.LAUNCHES["wide_rows"] == before + 2
        assert torch.equal(apart, again[0]) and torch.equal(tpart, again[1])
        assert apart.shape[1] == tpart.shape[1] == n_seg
        torch.testing.assert_close(apart.sum(dim=1), ref_a[:, 0], **F32)
        if compute_t:
            torch.testing.assert_close(tpart.double().sum(dim=1),
                                       ref_t[:, 0], **F32)
            none, t_only = fb.rows_partials(eta, p0, x0, x1,
                                            compute_a=False, **kw)
            assert none is None and torch.equal(t_only, tpart)
        else:
            assert (tpart == 0).all()
    mid = l_lo + (l_hi - l_lo) // 2
    fin = dict(k_true=K, lb=0.001, project_eta=True)
    a0 = None
    for lo, hi, last in ((l_lo, mid, False), (mid, l_hi, True)):
        part = fb.rows_partials(eta, p0, x0, x1, l_lo=lo, l_hi=hi,
                                seg_cols=seg_cols, k_true=K)
        a0, _ = fb.rows_finish(eta, *part, c, a0, **fin, emit_a=not last)
    want = fb.finish_eta_reference(eta, ref_a[:, 0], c, **fin)
    torch.cuda.synchronize()
    torch.testing.assert_close(a0, want, **F32)


@pytest.mark.cuda
@pytest.mark.parametrize("K,Kp", WIDE_ROWS_LANES)
@pytest.mark.parametrize("l_lo,l_hi", [(0, 4099), (3, 2050)])
def test_wide_rows_sub_windows_add_in_order(monkeypatch, K, Kp, l_lo, l_hi):
    """A scratch cap small enough for several d sub-windows: segments
    that each lie in one sub-window give partials bit-equal to those of
    one sub-window; a segment spanning them all (each sub-window's part
    added in order) against the plain version, reruns bit-equal; the
    plan the launcher runs (``rows_sub_segments``) as the Python mirror
    has it."""
    dev = _cuda()
    B, I, L = 2, 1001, 4099
    eta, p0, x0, x1, _, _ = _step_args(K + 7, B, I, L, K, Kp, 0.02, dev)
    win = dict(l_lo=l_lo, l_hi=l_hi, k_true=K)
    whole = fb.rows_partials(eta, p0, x0, x1, seg_cols=256, **win)
    cap = 4 * B * I * 300
    monkeypatch.setattr(fb, "SCRATCH_CAP", cap)
    plan = (fb.wide_chunks(fb.kc_of(K, Kp)), fb.device_sm_count(dev))
    sub = fb.cols_sub_cols(B, I, l_hi - l_lo, *plan)
    assert sub == 256
    split = fb.rows_partials(eta, p0, x0, x1, seg_cols=256, **win)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(split, whole))
    steps = fb.rows_sub_segments(l_lo, l_hi, l_hi - l_lo, sub)
    assert len(steps) > 4 and all(len(p) == 1 for _, p in steps)
    assert [p[0][3] for _, p in steps] == [False] + [True] * (len(steps) - 1)
    one = fb.rows_partials(eta, p0, x0, x1, seg_cols=l_hi - l_lo, **win)
    again = fb.rows_partials(eta, p0, x0, x1, seg_cols=l_hi - l_lo, **win)
    ref_a, ref_t = fb.rows_partials_reference(eta, p0, x0, x1, l_lo=l_lo,
                                              l_hi=l_hi)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(one, again))
    torch.testing.assert_close(one[0][:, 0], ref_a[:, 0], **F32)
    torch.testing.assert_close(one[1][:, 0].double(), ref_t[:, 0], **F32)


@pytest.mark.cuda
@pytest.mark.parametrize("K,Kp", WIDE_ROWS_LANES)
def test_wide_shared_d_matches_unshared(K, Kp):
    """A step that runs both passes on one d against the order that runs
    d for each pass, the public pieces in turn
    (``route_times.bi_step_unshared`` / ``generic_step_unshared``): the
    biallelic streamed and chunked step's p0' and raw B0/B1 (emit_b) and
    the generic step's p' and sweep B bit-equal, eta' (or raw A) and t
    within the float32 tolerance; ``window_partials`` and
    ``rows_and_partials`` bit-equal to each pass's wrapper alone; reruns
    bit-equal; one d launch for both passes counted as one launch of each
    wide pass."""
    dev = _cuda()
    args = _step_args(K + 3, 2, 1001, 4099, K, Kp, 0.02, dev)
    kw = dict(k_true=K, lb=0.01, plb=0.05, project=True)
    win = dict(l_lo=1312, l_hi=4099)
    shared = fb.window_partials(*args[:4], args[5], seg_cols=1056, k_true=K,
                                **win)
    alone = fb.rows_partials(*args[:4], seg_cols=1056, k_true=K, **win) + (
        fb.cols_partials(*args[:4], args[5], k_true=K, **win),)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(shared, alone))
    for fn, call in ((fb.admixture_fullstep_biallelic_streamed,
                      dict(seg_cols=1056)),
                     (fb.admixture_fullstep_biallelic_chunked,
                      dict(window=1312, seg_cols=1056))):
        for extra in ({}, dict(emit_b=True), dict(emit_a=True,
                                                  emit_b=True)):
            shared = fn(*args, **call, **kw, **extra)
            again = fn(*args, **call, **kw, **extra)
            unshared = rt.bi_step_unshared(
                *args, **{"window": 4099, **call}, **kw, **extra)
            torch.cuda.synchronize()
            assert all(torch.equal(u, v) for u, v in zip(shared, again))
            for g, u in zip(shared[2:], unshared[2:]):
                assert torch.equal(g, u)
            _stream_close(shared[:2], unshared[:2])
    eta, p2, x2, c, miss, mask = _generic_args(K + 5, 2, 1001, 333, 3, K,
                                               Kp, 0.02, dev)
    gkw = dict(k_true=K, lb=0.01, plb=0.05, project=True)
    before = dict(build.LAUNCHES)
    shared = fs.admixture_fullstep(eta, p2, x2, c, miss, mask, **gkw)
    torch.cuda.synchronize()
    assert build.LAUNCHES["mc_fullstep_step"] == before["mc_fullstep_step"] + 1
    unshared = rt.generic_step_unshared(eta, p2, x2, c, miss, mask, **gkw)
    assert torch.equal(shared[2], unshared[2])
    _stream_close(shared[:2], unshared[:2])
    both = fs.rows_and_partials(eta, p2, x2, None, None, miss, M=3,
                                k_true=K, lb=0.0, project=False,
                                finish=False)
    alone = fs.fullstep_rows(eta, p2, x2, k_true=K, lb=0.0, project=False,
                             finish=False, M=3) + (
        fs.fullstep_partials(eta, p2, x2, miss, M=3, k_true=K),)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(both, alone))
    sw = fs.admixture_sweep_stats(eta, p2, x2, miss, M=3, k_true=K)
    su = alone[:2] + (fs.fullstep_p(p2, alone[2], M=3, k_true=K,
                                    finish=False),)
    torch.cuda.synchronize()
    assert torch.equal(sw[2], su[2])
    _stream_close(sw[:2], su[:2])


@pytest.mark.cuda
@pytest.mark.parametrize("K,Kp", [(130, 160), (250, 256), (300, 320),
                                  (510, 512), (600, 640), (1021, 1024)])
def test_wide_finish_instances_project_like_plain(K, Kp):
    """The wide finish at each of its instances (8, 16 and 32 lanes a
    thread: Kp <= 256, 512, 1024) on rows whose mass sits on a few lanes,
    so that the Michelot passes pin most lanes at lb, with the static
    lanes and with a runtime kmask: eta' against the plain finish of the
    ordered sum, t bit-equal to it, reruns bit-equal."""
    dev = _cuda()
    rng = np.random.default_rng(K)
    B, I, n_seg = 2, 777, 3
    eta = np.zeros((B, I, Kp), np.float32)
    eta[..., :K] = rng.dirichlet(np.full(K, 0.05), size=(B, I))
    eta = torch.tensor(eta, device=dev)
    _, apart, tpart, _, c = _wide_finish_args(K + 1, B, I, K, Kp, n_seg, dev)
    lb = 0.5 / K
    araw = fb.ordered_segment_sum(apart)
    t_want = fb.ordered_segment_sum(tpart, dtype=torch.float64)
    kmask = (torch.arange(Kp, device=dev) < K - 5).float()
    for extra in ({}, dict(kmask=kmask)):
        fin = dict(k_true=K, lb=lb, project_eta=True, **extra)
        got, t = fb.rows_finish(eta, apart, tpart, c, **fin)
        again = fb.rows_finish(eta, apart, tpart, c, **fin)
        want = fb.finish_eta_reference(eta, araw, c, **fin)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **F32)
        assert torch.equal(t, t_want)
        assert torch.equal(got, again[0]) and torch.equal(t, again[1])
        live = K - 5 if extra else K
        pinned = (want[..., :live] <= lb * (1 + 1e-5)).float().mean()
        assert pinned > 0.3, float(pinned)
        assert (got[..., live:] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("K,Kp", [(200, 224), (1000, 1024)])
def test_wide_bucketed_step_matches_plain(K, Kp):
    """The bucketed admixture step at a wide Kp on a jagged panel (buckets
    at M_b = 2, 3, 4 and 8): each bucket's wide columns pass (its partials'
    ordered sum against the plain B, bit-equal raw B from the p epilogue),
    and the whole step against its plain version; reruns bit-equal."""
    from multiclust_tpu_torch.model import admixture as adm

    dev = _cuda()
    md, bd, params, cfg = _jagged_panel(dev, I=1001, K=K, Kp=Kp)
    kc = fb.kc_of(K, Kp)
    for bucket, p in zip(bd.buckets, params.p):
        Mb = bucket.M
        p2 = p.reshape(p.shape[0], Kp, -1).contiguous()
        part = fs.fullstep_partials(params.eta, p2, bucket.x_lanes,
                                    bucket.miss, M=Mb, k_true=K)
        assert (part[:, :, kc:] == 0).all()
        want = fb.ordered_segment_sum(part)
        ref = fs.fullstep_partials_reference(params.eta, p2, bucket.x_lanes,
                                             bucket.miss)[:, 0]
        torch.testing.assert_close(want, ref, **F32)
        assert torch.equal(fs.fullstep_p(p2, part, M=Mb, k_true=K,
                                         finish=False), want)
    before = build.LAUNCHES["wide_cols_generic"]
    got = adm.em_step(params, bd, cfg, True)
    torch.cuda.synchronize()
    assert build.LAUNCHES["wide_cols_generic"] == before + len(bd.buckets)
    ref = adm.em_step(params, bd, cfg._replace(use_pallas="off"), True)
    for g, r in zip(got[0].p, ref[0].p):
        torch.testing.assert_close(g, r, **F32)
    torch.testing.assert_close(got[0].eta, ref[0].eta, **F32)
    again = adm.em_step(params, bd, cfg, True)
    assert all(torch.equal(g, a) for g, a in zip(got[0].p, again[0].p))


def _plain_raises(monkeypatch):
    """Every plain version of a kernel, and the plain step, raise."""
    from multiclust_tpu_torch.model import admixture as tadm

    def boom(*a, **kw):
        raise AssertionError("a plain function ran in a kernel fit")
    for module in (fb, fs):
        for name in dir(module):
            if name.endswith("_reference"):
                monkeypatch.setattr(module, name, boom)
    for name in ("_em_step_unconstrained", "_sweep", "_sweep_stats"):
        monkeypatch.setattr(tadm, name, boom)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [200, 1000])
@pytest.mark.parametrize("panel,accel", [("biallelic", 0), ("biallelic", 1),
                                         ("M=4", 0), ("jagged", 1)])
def test_wide_float32_fits_run_no_plain_function(monkeypatch, K, panel,
                                                 accel):
    """A float32 fit on the card at Kp = 224 and 1024 (plain EM and
    SQUAREM; biallelic, M = 4 and a jagged panel) runs the wide kernels
    and not one plain function: they are patched to raise."""
    from multiclust_tpu_torch.api import fit_model_data
    from multiclust_tpu_torch.convert import model_data_from_numpy

    dev = _cuda()
    rng = np.random.default_rng(K + accel)
    I, L = 1100, 256
    if panel == "biallelic":
        M, Ml = 2, np.full(L, 2)
    elif panel == "M=4":
        M, Ml = 4, np.full(L, 4)
    else:
        M, Ml = 8, np.where(rng.random(L) < 0.8, 2, 8)
    mask = np.arange(M)[None] < Ml[:, None]
    miss = rng.binomial(2, 0.01, size=(I, L))
    freq = np.broadcast_to(mask / Ml[:, None], (I, L, M))
    counts = rng.multinomial(2 - miss, freq)
    md = model_data_from_numpy(counts, miss, mask, Ml, device=dev,
                               dtype=torch.float32)
    _plain_raises(monkeypatch)
    build.reset_launch_counts()
    out = fit_model_data(md, 2, admixture=True, min_K=K, max_K=K, n_init=2,
                         max_iter=4, seed=3, verbosity=0,
                         accel_scheme=accel)
    res = out.estimate.per_K[K]
    assert np.isfinite(res.max_logL) and not res.any_failed
    assert build.LAUNCHES["wide_rows"] > 0 and build.LAUNCHES["wide_finish"]
    cols = "wide_cols_bi" if panel == "biallelic" else "wide_cols_generic"
    assert build.LAUNCHES[cols] > 0, build.LAUNCHES


@pytest.mark.cuda
def test_wide_kernels_build_without_spills():
    """The -Xptxas -v report of the wide kernels: the rows pass's A launch
    and the columns pass's B launch with both cells, the d launch and the
    finish at 8, 16 and 32 lanes a thread, in both admixture sources
    where each is built, none spilling."""
    from multiclust_tpu_torch.kernel_report import WIDE, ptxas_lines

    _cuda()
    build.library()
    report = build.library_path().with_suffix(".ptxas.txt").read_text()
    lines = ptxas_lines(report, WIDE)
    assert all(" 0 bytes spill stores, 0 bytes spill loads" in text
               for _, text in lines), lines
    assert sorted(name for name, _ in lines) == [
        "wide_cols_b_kernel<kBi>", "wide_cols_b_kernel<kDense>",
        "wide_cols_d_kernel", "wide_cols_d_kernel",
        "wide_finish_kernel<16>", "wide_finish_kernel<16>",
        "wide_finish_kernel<32>", "wide_finish_kernel<32>",
        "wide_finish_kernel<8>", "wide_finish_kernel<8>",
        "wide_rows_a_kernel<kBi>", "wide_rows_a_kernel<kDense>"], lines


# ---------------------------------------------------------------------------
# the mixture's wide kernels (128 < Kp <= 1024, csrc/mixture_bi.cu)

WIDE_MIX = ("wide_mix_rows", "wide_mix_cols", "wide_mix_finish")


@pytest.mark.cuda
@pytest.mark.parametrize("B,I,L,K,Kp,miss_rate,ploidy,project", [
    (1, 1001, 4099, 150, 160, 0.0, 2, True),     # ragged I and L
    (2, 1001, 4099, 200, 224, 0.02, 2, True),
    (2, 777, 2048, 200, 224, 0.0, 2, False),     # aligned L (cp.async)
    (1, 600, 1000, 500, 512, 0.02, 2, True),
    (2, 513, 2048, 1000, 1024, 0.0, 2, True),
    (1, 300, 333, 1024, 1024, 0.02, 4, True),    # every lane live
    (2, 4000, 96, 129, 160, 0.0, 2, True),       # many row segments
    (1, 130, 160, 161, 192, 0.02, 2, True),      # K one past a chunk
    # phase 22's ragged panel at every wide Kp, the other stream variant
    (2, 1001, 4099, 150, 160, 0.03, 2, True),
    (2, 1001, 4099, 200, 224, 0.0, 2, True),
    (2, 1001, 4099, 500, 512, 0.0, 2, True),
    (2, 1001, 4099, 1000, 1024, 0.03, 2, True),
    # one chunk of 17 live lane tiles on 512 lanes: the rest zero-filled
    (2, 1001, 4099, 130, 512, 0.0, 2, True),
    (2, 1001, 4099, 130, 512, 0.03, 2, True),
])
def test_wide_mixture_kernels_match_plain(B, I, L, K, Kp, miss_rate,
                                          ploidy, project):
    """The wide rows pass, columns pass and finish (and its eta half
    alone), the step and the sweep against their plain versions; v, the
    partials and the v sums are 0 past K; reruns are bit-equal; each call
    launches each wide kernel once.  The eta bound 1e-4 keeps K lb below
    1 up to K = 1024, as the projection needs."""
    dev = _cuda()
    args = _mix_args(K, B, I, L, K, Kp, miss_rate, ploidy, dev)
    lp0, x0, bias, lp1, x1 = args
    kw = dict(k_true=K, lb=1e-4, plb=1e-3, ploidy=ploidy, project=project)
    before = dict(build.LAUNCHES)
    got = mb.mixture_fullstep_biallelic(*args, **kw)
    torch.cuda.synchronize()
    for name in WIDE_MIX + MIX_KERNELS:
        assert build.LAUNCHES[name] == before[name] + 1, name
    ref = mb.mixture_fullstep_biallelic_reference(*args, **kw)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, **F32)
    assert (got[0][:, K:] == 0).all()
    if project:
        assert float(got[0][:, :K].min()) >= 1e-4 * (1 - 1e-6)
    torch.testing.assert_close(got[0].sum(dim=1), torch.ones(B, device=dev),
                               rtol=0, atol=1e-5)
    again = mb.mixture_fullstep_biallelic(*args, **kw)
    assert all(torch.equal(g, a) for g, a in zip(got, again))

    v, t = mb.mixture_rows(lp0, x0, bias, lp1, x1, k_true=K)
    v_ref, t_ref = mb.mixture_rows_reference(lp0, x0, bias, lp1, x1)
    torch.testing.assert_close(v, v_ref, **F32)
    torch.testing.assert_close(t, t_ref, **F32)
    assert (v[..., K:] == 0).all()
    part, vpart = mb.mixture_partials(v, x0, x1, k_true=K)
    part_ref, vpart_ref = mb.mixture_cols_reference(v, x0, x1)
    torch.testing.assert_close(part.sum(dim=1), part_ref[:, 0], **F32)
    torch.testing.assert_close(vpart.sum(dim=1), vpart_ref[:, 0], **F32)
    assert (part[..., K:, :] == 0).all() and (vpart[..., K:] == 0).all()
    again = mb.mixture_partials(v, x0, x1, k_true=K)
    assert torch.equal(part, again[0]) and torch.equal(vpart, again[1])
    ekw = dict(k_true=K, lb=1e-4, project=project)
    torch.testing.assert_close(mb.mixture_eta(vpart, **ekw),
                               mb.mixture_eta_reference(vpart, **ekw), **F32)

    sweep = mb.mixture_sweep_stats(*args, k_true=K)
    sweep_ref = mb.mixture_sweep_stats_reference(*args)
    assert (sweep[3] is None) == (miss_rate == 0)
    for g, r in zip(sweep, sweep_ref):
        if g is not None:
            torch.testing.assert_close(g, r, **F32)


@pytest.mark.cuda
@pytest.mark.parametrize("Kp", [160, 224, 1024])
def test_wide_mixture_eta_projects_like_plain(Kp):
    """The finish's eta half at wide Kp (8 or 32 slots a lane) on sums
    that pin lanes at the lower bound, 1, 3 and 40 segments, every lane
    or a few live."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(Kp)
    for K in (Kp, Kp - 31, 129):
        for n_seg in (1, 3, 40):
            vpart = torch.zeros((2, n_seg, Kp), device=dev)
            vpart[..., :K] = torch.rand((2, n_seg, K), generator=gen,
                                        device=dev) ** 8
            kw = dict(k_true=K, lb=2e-4, project=True)
            got = mb.mixture_eta(vpart, **kw)
            ref = mb.mixture_eta_reference(vpart, **kw)
            torch.testing.assert_close(got, ref, **F32)
            assert (got[:, K:] == 0).all()
            assert float(got[:, :K].min()) >= 2e-4 * (1 - 1e-6)


def _mixture_plain_raises(monkeypatch):
    """Every plain version of a mixture kernel, and of the generic p
    epilogue, raises."""
    def boom(*a, **kw):
        raise AssertionError("a plain function ran in a kernel fit")
    for module in (mb, fs):
        for name in dir(module):
            if name.endswith("_reference"):
                monkeypatch.setattr(module, name, boom)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [200, 1000])
@pytest.mark.parametrize("panel,accel", [("biallelic", 0), ("missing", 1),
                                         ("M=4", 0), ("jagged", 0)])
def test_wide_mixture_fits_run_no_plain_function(monkeypatch, K, panel,
                                                 accel):
    """A float32 mixture fit on the card at Kp = 224 and 1024 (plain EM and
    SQUAREM; biallelic one stream and two, M = 4 and a jagged panel) runs
    the wide kernels and no plain version of one: the biallelic fits the
    three wide kernels (the finish among them), the others the plain
    products with the finish's eta half and the generic p epilogue at K
    lanes."""
    from multiclust_tpu_torch.api import fit_model_data
    from multiclust_tpu_torch.convert import model_data_from_numpy

    dev = _cuda()
    rng = np.random.default_rng(K + accel)
    I, L = 1100, 256
    if panel in ("biallelic", "missing"):
        M, Ml = 2, np.full(L, 2)
    elif panel == "M=4":
        M, Ml = 4, np.full(L, 4)
    else:
        M, Ml = 8, np.where(rng.random(L) < 0.8, 2, 8)
    mask = np.arange(M)[None] < Ml[:, None]
    miss = rng.binomial(2, 0.0 if panel == "biallelic" else 0.01,
                        size=(I, L))
    freq = np.broadcast_to(mask / Ml[:, None], (I, L, M))
    counts = rng.multinomial(2 - miss, freq)
    md = model_data_from_numpy(counts, miss, mask, Ml, device=dev,
                               dtype=torch.float32)
    _mixture_plain_raises(monkeypatch)
    build.reset_launch_counts()
    out = fit_model_data(md, 2, admixture=False, min_K=K, max_K=K,
                         n_init=2, max_iter=4, seed=3, verbosity=0,
                         accel_scheme=accel)
    res = out.estimate.per_K[K]
    assert np.isfinite(res.max_logL) and not res.any_failed
    assert build.LAUNCHES["wide_mix_finish"] > 0, build.LAUNCHES
    if M == 2:
        assert build.LAUNCHES["wide_mix_rows"] > 0
        assert build.LAUNCHES["wide_mix_cols"] > 0
        assert build.LAUNCHES["mc_mix_finish"] == \
            build.LAUNCHES["mc_mix_cols"]
    else:
        assert build.LAUNCHES["mc_fullstep_p"] > 0
        assert not build.LAUNCHES["mc_mix_rows"]


@pytest.mark.cuda
@pytest.mark.parametrize("M", [2, 4])
def test_mixture_step_above_1024_lanes_launches_nothing(M, capsys):
    """At Kp = 1056 (K = 1040) the mixture step is the plain one: no kernel
    launched, nothing printed, the plain step's own result."""
    from multiclust_tpu_torch.model import mixture
    from multiclust_tpu_torch.model.common import EMConfig, make_model_data

    dev = _cuda()
    K, I, L = 1040, 300, 64
    rng = np.random.default_rng(M)
    miss = rng.binomial(2, 0.02, size=(I, L))
    counts = rng.multinomial(2 - miss, np.full(M, 1 / M), size=(I, L))
    mask = np.ones((L, M), bool)
    md = make_model_data(torch.as_tensor(counts, device=dev),
                         torch.as_tensor(miss, device=dev),
                         torch.as_tensor(mask, device=dev),
                         torch.full((L,), M, device=dev),
                         dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    eta = torch.rand((1, K), generator=gen, device=dev) + 0.05
    p = torch.rand((1, K, L, M), generator=gen, device=dev) + 0.05
    from multiclust_tpu_torch.model.common import Params
    params = Params(eta=eta / eta.sum(-1, keepdim=True),
                    p=p / p.sum(-1, keepdim=True))
    cfg = EMConfig(admixture=False, use_pallas="on", biallelic=M == 2,
                   has_missing=True, ploidy=2)
    assert not mixture._kernel_ok(md, cfg, params)
    build.reset_launch_counts()
    capsys.readouterr()
    got = mixture.em_step(params, md, cfg)
    torch.cuda.synchronize()
    assert not any(build.LAUNCHES.values()), build.LAUNCHES
    out = capsys.readouterr()
    assert out.out == out.err == ""
    off = EMConfig(admixture=False, use_pallas="off", biallelic=M == 2,
                   has_missing=True, ploidy=2)
    want = mixture.em_step(params, md, off)
    for g, w in zip((got[0].eta, got[0].p, got[1]),
                    (want[0].eta, want[0].p, want[1])):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=0)


@pytest.mark.cuda
def test_wide_mixture_kernels_build_without_spills():
    """The -Xptxas -v report of the mixture's wide kernels: the score and
    columns kernels (one and two streams), the softmax at 4, 8 and 16
    score pairs a lane and the finish at each of its eta slots a lane
    (1-4 narrow, 8, 16 and 32 wide) and its p half alone (0), none
    spilling."""
    from multiclust_tpu_torch.kernel_report import MIX_WIDE, ptxas_lines

    _cuda()
    build.library()
    report = build.library_path().with_suffix(".ptxas.txt").read_text()
    lines = ptxas_lines(report, MIX_WIDE)
    assert all(" 0 bytes spill stores, 0 bytes spill loads" in text
               for _, text in lines), lines
    assert sorted(name for name, _ in lines) == [
        "mix_cols_wide_kernel<false>", "mix_cols_wide_kernel<true>",
        "mix_finish_kernel<0>", "mix_finish_kernel<16>",
        "mix_finish_kernel<1>",
        "mix_finish_kernel<2>", "mix_finish_kernel<32>",
        "mix_finish_kernel<3>", "mix_finish_kernel<4>",
        "mix_finish_kernel<8>", "mix_rows_wide_kernel<false>",
        "mix_rows_wide_kernel<true>", "mix_softmax_kernel<16>",
        "mix_softmax_kernel<4>", "mix_softmax_kernel<8>"], lines
