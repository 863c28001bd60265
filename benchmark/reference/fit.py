"""A whole fit by the reference, to be put in the program's place: the
control of the check that decides ``correct``.

Each start runs plain EM with the reference's step (reference/models.py)
in the precision it is given, until the log likelihood changes by no more
than the tolerance (``abs_error``, floored at 8 float32 epsilons of the
norm of the per-individual terms, the noise floor of a float32 fit) or
the iteration cap, as a float32 fit of the program stops; the best start's
parameters and the log likelihood of the parameters its last step started
from are its answer.  Its starts are drawn from the fit's seed as the
reference C program draws them: an admixture start from a random partition
of the observed allele copies (each copy given to a cluster uniformly at
random; eta and p are the partition's shares), a mixture start with equal
weights and allele frequencies uniform on [0.05, 0.95].
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from benchmark.reference import models
from benchmark.reference.precision import dtype_of

EPS32 = float(np.finfo(np.float32).eps)
NOISE_FACTOR = 8.0


@dataclasses.dataclass
class RefAnswer:
    eta: torch.Tensor
    p: torch.Tensor
    logl: float
    n_iter_all: int
    n_launched: int
    seconds: float
    route: str = "reference"
    batch_chains: int = 1
    launches: dict = None
    # the parameters the last step started from (``keep_prev``), whose
    # log likelihood ``logl`` is
    prev_eta: torch.Tensor = None
    prev_p: torch.Tensor = None


def partition_start(planes, miss, K: int, gen, dtype, lb: float):
    """(eta [I, K], p [K, L, 2]) of a random partition of the observed
    allele copies, made in blocks of rows."""
    _, I, L = planes.shape
    dev = planes.device
    n = torch.zeros((I, K), dtype=torch.float64, device=dev)
    pc = torch.zeros((K, L, 2), dtype=torch.float64, device=dev)
    for r in models._rows(I, L, models.BLOCK_CELLS // 2):
        x0 = planes[0, r][..., None]
        obs = (2 - miss[r])[..., None]
        copy = torch.arange(2, device=dev, dtype=torch.int8)
        allele = torch.where(copy < x0, 0, torch.where(copy < obs, 1, 2))
        lab = torch.randint(0, K, allele.shape, generator=gen, device=dev,
                            dtype=torch.int8)
        for k in range(K):
            mine = lab == k
            n[r, k] = (mine & (allele < 2)).sum(dim=(1, 2), dtype=torch.float64)
            for a in range(2):
                pc[k, :, a] += (mine & (allele == a)).sum(
                    dim=(0, 2), dtype=torch.float64)
    eta = models.project(n / n.sum(dim=-1, keepdim=True), lb)
    tot = pc.sum(dim=-1, keepdim=True)
    p = torch.where(tot > 0, pc / tot.clamp(min=1), torch.full_like(pc, 0.5))
    return eta.to(dtype), models.project(p, lb).to(dtype)


def start(model: str, planes, miss, K: int, gen, dtype, lb: float):
    if model == "admixture":
        return partition_start(planes, miss, K, gen, dtype, lb)
    L = miss.shape[1]
    p0 = 0.05 + 0.9 * torch.rand((K, L), generator=gen, device=miss.device,
                                 dtype=dtype)
    return (torch.full((K,), 1.0 / K, dtype=dtype, device=miss.device),
            torch.stack([p0, 1 - p0], -1))


def fit(planes, miss, model: str, K: int, n_init: int, max_iter: int,
        abs_error: float, seed: int, prec: str, lb: float,
        cap: int = 0, keep_prev: bool = False) -> RefAnswer:
    """The best of ``n_init`` starts, each run as described above; ``cap``
    (0: none) ends a start after that many steps where ``max_iter`` sets
    no nearer end: in TF32 the log likelihood's rounding moves it by more
    than a float32 fit's noise floor, so the stop rule alone may never end
    a start.  ``keep_prev`` keeps the parameters the best start's last
    step started from."""
    if cap and (not max_iter or max_iter > cap):
        max_iter = cap
    t0 = time.perf_counter()
    dev = miss.device
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    best, total = None, 0
    for _ in range(n_init):
        eta, p = start(model, planes, miss, K, gen, dtype_of(prec), lb)
        prev, n = -math.inf, 0
        while True:
            eta_n, p_n, t = models.step(model, eta, p, planes, miss, lb, lb,
                                        prec)
            ll = float(t.sum())
            floor = NOISE_FACTOR * EPS32 * float(torch.sqrt((t * t).sum()))
            n += 1
            done = (math.isfinite(prev)
                    and abs(ll - prev) <= max(abs_error, floor))
            last = (eta, p) if keep_prev else (None, None)
            eta, p, prev = eta_n, p_n, ll
            if done or not math.isfinite(ll) or (max_iter and n > max_iter):
                break
        total += n
        if best is None or ll > best[2]:
            best = (eta, p, ll, *last)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return RefAnswer(eta=best[0], p=best[1], logl=best[2], n_iter_all=total,
                     n_launched=n_init, seconds=time.perf_counter() - t0,
                     prev_eta=best[3], prev_p=best[4])
