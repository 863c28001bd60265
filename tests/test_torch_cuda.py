"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device.  This
file imports neither jax nor the JAX package, so it also runs where only
PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from multiclust_tpu_torch.ops import build, fullstep_bi as fb

# float32: the kernel and the plain version sum in other orders
F32 = dict(rtol=1e-4, atol=5e-5)


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
    for name in build.LAUNCHES:
        assert build.LAUNCHES[name] == before[name] + 1
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, **F32)
    assert (got[0][..., K:] == 0).all() and (got[2][:, K:] == 0).all()
    # the kernel is deterministic: no atomics, fixed-order partial sums
    again = fb.admixture_fullstep_biallelic(*args, **kw)
    for g, a in zip(got, again):
        assert torch.equal(g, a)
