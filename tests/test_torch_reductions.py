"""The segment reductions of the biallelic step on the CPU: the rows
finish and the p0 epilogue add per-segment partials in segment order
(``ops/fullstep_bi.ordered_segment_sum``, the plain helper the card tests
hold both CUDA kernels to bit for bit).  Here the ordered sums of the
plain per-segment partials are held to the JAX package's streamed step in
interpret mode, as its own tests run it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiclust_tpu.ops import kernels as jk
from multiclust_tpu_torch.ops import fullstep as fs, fullstep_bi as fb

torch.set_num_threads(2)

KW = dict(k_true=5, lb=1e-8, plb=1e-8, project=True)
I, L, KP = 128, 256, 32
# the JAX package's own tolerances for the raw sums (tests/test_kernels.py:
# 377-420); p0' at the port's float32 tolerance (rtol 1e-4, atol 5e-5):
# each row segment's B0/B1 is a float32 sum over its rows in another order
# than the JAX kernel's, and p0 B0 / (p0 B0 + (1 - p0) B1) can double
# their relative error
TOL = {"A": (1e-5, 2e-3), "t": (1e-5, 1e-3), "B0": (1e-5, 2e-3),
       "B1": (1e-5, 2e-3), "p0'": (1e-4, 5e-5)}
SEGMENTS = (1, 3, 8)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    eta = np.zeros((I, KP), np.float32)
    eta[:, :5] = rng.dirichlet(np.full(5, 2.0), size=I)
    p0 = np.zeros((KP, L), np.float32)
    p0[:5] = rng.uniform(0.2, 0.8, size=(5, L))
    miss = rng.binomial(2, 0.1, size=(I, L))
    x0 = rng.binomial(2 - miss, 0.5)
    return eta, p0, x0, 2 - miss - x0, miss


def _jax_streamed(eta, p0, x0, x1, miss, **kw):
    return jk.admixture_fullstep_biallelic_streamed(
        jnp.asarray(eta), jnp.asarray(p0), jnp.asarray(x0, jnp.int8),
        jnp.asarray(x1, jnp.int8),
        jnp.asarray(miss.sum(axis=1, keepdims=True), jnp.float32),
        jnp.asarray(miss, jnp.int8), ti=64, tl=128, interpret=True,
        **KW, **kw)


def _torch(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _bounds(n: int, size: int, tile: int):
    """[lo, hi) of the n segments of ``size`` at a multiple of ``tile``."""
    step = -(-size // n // tile) * tile
    return [(lo, min(size, lo + step)) for lo in range(0, size, step)]


def _close(name, got, want):
    rtol, atol = TOL[name]
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(
        got.shape), rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("n_seg", SEGMENTS)
def test_ordered_rows_partials_match_jax_streamed(n_seg, seeded):
    """The raw A + r (emit_a) and t of the finish: the plain partials of
    n_seg column segments added in segment order on top of an a0 seed (A
    float32, t float64 from float32 partials, as the kernels keep them)
    against the JAX streamed step's emit_a outputs plus the seed."""
    eta, p0, x0, x1, miss = _inputs(40 + n_seg)
    te, tp, tx0, tx1 = _torch(eta[None], p0[None], x0, x1)
    bounds = _bounds(n_seg, L, 32)
    assert len(bounds) == n_seg
    parts = [fb.rows_partials_reference(te, tp, tx0, tx1, l_lo=lo, l_hi=hi)
             for lo, hi in bounds]
    apart = torch.cat([a for a, _ in parts], dim=1)
    tpart = torch.cat([t for _, t in parts], dim=1).float()
    seed = (torch.as_tensor(np.random.default_rng(n_seg).uniform(
        0, 2, size=(1, I, KP)).astype(np.float32)) if seeded else None)
    A = fb.ordered_segment_sum(apart, seed)
    t = fb.ordered_segment_sum(tpart, dtype=torch.float64)
    assert A.dtype == torch.float32 and t.dtype == torch.float64
    want = _jax_streamed(eta, p0, x0, x1, miss, emit_a=True, emit_b=True)
    wa = np.asarray(want[0]) + (seed[0].numpy() if seeded else 0.0)
    _close("A", A[0], wa)
    _close("t", t[0], want[1])


@pytest.mark.parametrize("emit_b", [False, True])
@pytest.mark.parametrize("n_seg", SEGMENTS)
def test_ordered_columns_partials_match_jax_streamed(n_seg, emit_b):
    """The p0 epilogue's plain version (``p0_epilogue`` on CPU tensors):
    the plain B0/B1 partials of n_seg row segments added in segment order,
    then p0' or the raw B0/B1, against the JAX streamed step."""
    eta, p0, x0, x1, miss = _inputs(50 + n_seg)
    te, tp, tx0, tx1, tm = _torch(eta[None], p0[None], x0, x1, miss)
    bounds = _bounds(n_seg, I, 1)
    assert len(bounds) == n_seg
    part = torch.stack([torch.stack(fb.window_stats_reference(
        te[:, lo:hi], tp, tx0[lo:hi], tx1[lo:hi], tm[lo:hi], 0, L,
        compute_t=False, want_a=False)[2:], dim=1) for lo, hi in bounds],
        dim=1)
    assert part.shape == (1, n_seg, 2, KP, L)
    outs = tuple(torch.zeros_like(tp) for _ in range(1 + emit_b))
    fb.p0_epilogue(tp, part, outs, l_lo=0, l_hi=L, k_true=5, plb=1e-8,
                   project=True)
    want = _jax_streamed(eta, p0, x0, x1, miss, emit_b=emit_b)
    names = ("B0", "B1") if emit_b else ("p0'",)
    for name, got, w in zip(names, outs, want[2:]):
        _close(name, got[0], w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ordered_segment_sum_is_a_running_sum(dtype):
    """Bit for bit the running sum in segment order on top of the seed,
    in ``dtype``, which a sum in another order is not."""
    rng = np.random.default_rng(3)
    parts = (rng.standard_normal((2, 64, 7, 5)) * 10.0 ** rng.integers(
        -4, 5, size=(2, 64, 7, 5))).astype(np.float32)
    seed = rng.standard_normal((2, 7, 5)).astype(np.float32)
    np_t = np.float32 if dtype == torch.float32 else np.float64
    want = seed.astype(np_t)
    for s in range(parts.shape[1]):
        want = want + parts[:, s].astype(np_t)
    got = fb.ordered_segment_sum(torch.as_tensor(parts),
                                 torch.as_tensor(seed), dtype=dtype)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.numpy(), want)
    reordered = fb.ordered_segment_sum(torch.as_tensor(parts[:, ::-1].copy()),
                                       torch.as_tensor(seed), dtype=dtype)
    assert not torch.equal(reordered, got)
