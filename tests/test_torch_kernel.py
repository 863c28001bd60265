"""The port's biallelic full-step kernel function against the JAX package.

On the CPU the port's wrapper runs its plain PyTorch version; it is held
to the Pallas kernel in interpret mode (float32) and to the JAX XLA step
(float64).  The CUDA kernel itself is held to the plain version on the
card by tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiclust_tpu.model import admixture as jadm
from multiclust_tpu.model.common import EMConfig as JaxEMConfig, \
    ModelData as JaxModelData, Params as JaxParams
from multiclust_tpu.ops import df64
from multiclust_tpu.ops.kernels import \
    admixture_fullstep_biallelic as jax_fullstep_bi
from multiclust_tpu_torch.ops import fullstep_bi as fb

torch.set_num_threads(2)

# float32: the interpret-mode kernel and the plain version sum in other
# orders (test_kernels.py:196-199 holds the kernel to XLA the same way)
F32 = dict(rtol=1e-4, atol=5e-5)


def _inputs(seed, I, L, K, Kp, miss_rate):
    """eta [I, Kp] and p0 [Kp, L] with zero pad lanes, and genotypes.
    Sharp Dirichlet rows and p0 near 0/1 make the eta Michelot and the p0
    clip pin lanes for the bounds used below."""
    rng = np.random.default_rng(seed)
    eta = np.zeros((I, Kp))
    eta[:, :K] = rng.dirichlet(np.full(K, 0.3), size=I)
    p0 = np.zeros((Kp, L))
    p0[:K] = rng.uniform(0.01, 0.99, size=(K, L))
    miss = (rng.binomial(2, miss_rate, size=(I, L)) if miss_rate
            else np.zeros((I, L), np.int64))
    x0 = rng.binomial(2 - miss, 0.5)
    return eta, p0, x0, 2 - miss - x0, miss


@pytest.mark.parametrize("K", [4, 20])
@pytest.mark.parametrize("miss_rate", [0.0, 0.15])
@pytest.mark.parametrize("compute_t", [True, False])
@pytest.mark.parametrize("project", [True, False])
def test_fullstep_matches_pallas_interpret(K, miss_rate, compute_t,
                                           project):
    I, L, Kp = 64, 128, 32
    eta, p0, x0, x1, miss = _inputs(K + 7, I, L, K, Kp, miss_rate)
    kw = dict(k_true=K, lb=0.01, plb=0.05, project=project,
              compute_t=compute_t)
    c = miss.sum(axis=1).astype(np.float32)
    je, jt, jp = jax_fullstep_bi(
        jnp.asarray(eta, jnp.float32), jnp.asarray(p0, jnp.float32),
        jnp.asarray(x0, jnp.int8), jnp.asarray(x1, jnp.int8),
        jnp.asarray(c[:, None]),
        jnp.asarray(miss, jnp.int8) if miss_rate else None,
        ti=64, tl=128, interpret=True, **kw)

    def t8(a):
        return torch.as_tensor(a, dtype=torch.int8)

    te, tt, tp = fb.admixture_fullstep_biallelic(
        torch.as_tensor(eta, dtype=torch.float32)[None],
        torch.as_tensor(p0, dtype=torch.float32)[None], t8(x0), t8(x1),
        torch.as_tensor(c), t8(miss) if miss_rate else None, **kw)
    np.testing.assert_allclose(te[0].numpy(), np.asarray(je), **F32)
    np.testing.assert_allclose(tt[0].numpy(), np.asarray(jt), **F32)
    np.testing.assert_allclose(tp[0].numpy(), np.asarray(jp), **F32)
    # pad lanes stay exactly zero; the p0 clip keeps the upper bound below
    # 1 in float32
    assert (te[0, :, K:] == 0).all() and (tp[0, K:] == 0).all()
    if project:
        lo, hi = fb.p0_clip_bounds(0.05)
        assert hi < 1.0
        live = tp[0, :K]
        assert float(live.min()) >= np.float32(lo)
        assert float(live.max()) <= np.float32(hi)


@pytest.mark.parametrize("miss_rate", [0.0, 0.15])
@pytest.mark.parametrize("project", [True, False])
def test_fullstep_f64_matches_xla_step(miss_rate, project):
    """In float64 the plain version is the JAX XLA step (four products,
    p rebuilt as [K, L, 2]) on the p0 layout, to 1e-10."""
    I, L, K, Kp = 48, 70, 4, 32
    eta, p0, x0, x1, miss = _inputs(3, I, L, K, Kp, miss_rate)
    md = JaxModelData(x=jnp.asarray(np.stack([x0, x1], axis=2), jnp.float64),
                      miss=jnp.asarray(miss, jnp.float64),
                      mask=jnp.ones((L, 2), bool),
                      n_alleles=jnp.full((L,), 2, jnp.int32))
    cfg = JaxEMConfig(admixture=True, has_missing=miss_rate > 0,
                      do_projection=project, eta_lower_bound=0.01,
                      p_lower_bound=1e-8)
    full = JaxParams(eta=jnp.asarray(eta[:, :K]),
                     p=jnp.asarray(np.stack([p0[:K], 1 - p0[:K]], axis=2)))
    ref, ll, _ = jadm._em_step_unconstrained(full, md, cfg)

    te, tt, tp = fb.admixture_fullstep_biallelic(
        torch.as_tensor(eta)[None], torch.as_tensor(p0)[None],
        torch.as_tensor(x0), torch.as_tensor(x1),
        torch.as_tensor(miss.sum(axis=1), dtype=torch.float64),
        torch.as_tensor(miss) if miss_rate else None,
        k_true=K, lb=0.01, plb=1e-8, project=project)
    np.testing.assert_allclose(te[0, :, :K].numpy(), np.asarray(ref.eta),
                               rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(tp[0, :K].numpy(), np.asarray(ref.p)[:, :, 0],
                               rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(float(tt.sum()), float(df64.df_value(ll)),
                               rtol=1e-10)


def test_wrapper_refuses_unsupported_cuda_shapes():
    """The CUDA path validates before launching: Kp above 1024 raises
    (no fallback), as does a non-int8 genotype plane."""
    eta = torch.zeros(1, 8, 1056)
    p0 = torch.zeros(1, 1056, 5)
    x = torch.zeros(8, 5, dtype=torch.int8)
    with pytest.raises(ValueError, match="Kp=1056"):
        fb._check_cuda_inputs(eta, p0, x, x)
    with pytest.raises(ValueError, match="x1 dtype"):
        fb._check_cuda_inputs(torch.zeros(1, 8, 32), torch.zeros(1, 32, 5),
                              x, x.float())


# ---------------------------------------------------------------------------
# the kernels' tile constants and the pad lanes their k loops leave out

def _cu_constants():
    """``constexpr int NAME = <int or NAME / int>;`` of csrc/tiles.cuh, the
    register tiles that csrc/fullstep_bi.cu and csrc/fullstep.cu share."""
    import re
    from pathlib import Path

    text = (Path(fb.__file__).resolve().parent.parent / "csrc"
            / "tiles.cuh").read_text()
    out = {}
    for name, expr in re.findall(
            r"constexpr int (\w+) = ([\w /]+);", text):
        m = re.fullmatch(r"(\w+) / (\d+)", expr)
        if expr.isdigit():
            out[name] = int(expr)
        elif m and m.group(1) in out:
            out[name] = out[m.group(1)] // int(m.group(2))
    return out


@pytest.mark.parametrize("name", ["NW", "ROW_AR", "ROW_TL", "ROW_CW_MAX",
                                  "COL_CT", "COL_DR"])
def test_tile_constants_mirror_the_source(name):
    """ops/fullstep_bi.py's tile constants say what the biallelic and the
    generic kernels are built with (csrc/tiles.cuh): the segment
    arithmetic of ops/fullstep_bi.py and ops/fullstep.py rests on them."""
    assert _cu_constants()[name] == getattr(fb, name)


@pytest.mark.parametrize("Kp", [32, 64, 96, 128])
def test_lane_tile_covers_k(Kp):
    """The lane tile computes at least k_true lanes and at most Kp, fits a
    warp, and gives blocks of the sizes the docstrings state."""
    for K in range(1, Kp + 1):
        lt = fb.lane_tile(K, Kp)
        assert K <= lt.kc <= Kp and lt.kc == 4 * lt.gl * lt.jt
        assert lt.jt <= Kp // 32 and 1 <= lt.gl <= 8
        assert lt.gl * lt.cw <= 32 and lt.cw >= 4
        assert fb.rows_block(K, Kp) == 32 * min(lt.cw, fb.ROW_CW_MAX)
        assert fb.cols_tile(K, Kp) == (32 * lt.cw, 4 * lt.gl)
    assert fb.lane_tile(0, Kp) == fb.lane_tile(Kp, Kp)
    assert fb.lane_tile(20, 32) == (20, 1, 5, 6)
    assert fb.rows_block(20, 32) == 192 and fb.cols_tile(20, 32) == (192, 20)


def _pad_to(t, Kp, dim):
    shape = list(t.shape)
    shape[dim] = Kp - shape[dim]
    return torch.cat([t, t.new_zeros(shape)], dim=dim)


@pytest.mark.parametrize("miss_rate", [0.0, 0.1])
def test_plain_versions_do_not_read_pad_lanes(miss_rate):
    """K = 20 padded to Kp = 32 and to Kp = 64 gives the same eta', t,
    p0', raw A + r and B0/B1 on the first 20 lanes and exact zeros beyond
    (raw A + r: the row's sum of w1, since p0 is zero there).  The kernels'
    k loops stop at the lane tile of k_true because of this."""
    I, L, K = 40, 70, 20
    eta, p0, x0, x1, miss = _inputs(31, I, L, K, K, miss_rate)
    t8 = lambda a: torch.as_tensor(a, dtype=torch.int8)  # noqa: E731
    c = torch.as_tensor(miss.sum(axis=1), dtype=torch.float32)
    outs = []
    for Kp in (32, 64):
        e = _pad_to(torch.as_tensor(eta, dtype=torch.float32)[None], Kp, 2)
        p = _pad_to(torch.as_tensor(p0, dtype=torch.float32)[None], Kp, 1)
        args = (e, p, t8(x0), t8(x1), c, t8(miss) if miss_rate else None)
        kw = dict(k_true=K, lb=0.01, plb=0.05, project=True)
        step = fb.admixture_fullstep_biallelic_reference(*args, **kw)
        raw = fb.admixture_fullstep_biallelic_streamed_reference(
            *args, emit_a=True, emit_b=True, **kw)
        assert (step[0][..., K:] == 0).all() and (step[2][:, K:] == 0).all()
        assert (raw[2][:, K:] == 0).all() and (raw[3][:, K:] == 0).all()
        # raw A + r on a pad lane is the row's sum of w1, one value a row
        assert (raw[0][..., K:] == raw[0][..., K:K + 1]).all()
        outs.append((step[0][..., :K], step[1], step[2][:, :K],
                     raw[0][..., :K], raw[2][:, :K], raw[3][:, :K]))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
