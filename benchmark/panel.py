"""Genotype panels made on the device from a seed.

A copy of the port's generator (``route_times.device_panel`` and
``count_planes``), kept here so that a change to the program cannot change
the benchmark's data.  Diploid biallelic genotypes of the admixture model:
individual i carries ancestry proportions q_i ~ Dirichlet(alpha), cluster k
the allele-0 frequency f_kl ~ Beta(a, b) clipped to [0.01, 0.99], and each
of the two copies of locus l is allele 0 with probability q_i . f_l.  A
genotype is missing (both copies) with probability ``missing_rate``, as a
failed call is in a real panel.

The draws are made in blocks of rows, so no [I, L] float tensor exists:
the panel costs its three int8 planes (two count planes and the missing
plane), I x L x 3 bytes.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK_CELLS = 1 << 27


def panel_seed(seed: int) -> int:
    """The panel's own seed, derived from the run's."""
    return int(np.random.SeedSequence([seed, 0x5EED]).generate_state(1)[0])


def make_panel(config: dict, seed: int, device):
    """(planes [2, I, L] int8, miss [I, L] int8) of ``config``'s panel,
    drawn on ``device`` from ``seed``: planes[0] counts allele 0, planes[1]
    allele 1, miss the missing copies (0 or 2); the three add up to the
    ploidy in every cell."""
    I, L = int(config["individuals"]), int(config["loci"])
    if int(config["alleles"]) != 2 or int(config["ploidy"]) != 2:
        raise ValueError("the generator makes diploid biallelic panels")
    K = int(config["generating_K"])
    alpha = float(config["dirichlet_alpha"])
    a, b = (float(v) for v in config["frequency_beta"])
    rate = float(config["missing_rate"])
    s = panel_seed(seed)
    rng = np.random.default_rng(s)
    gen = torch.Generator(device=device).manual_seed(s)
    q = torch.tensor(rng.dirichlet(np.full(K, alpha), size=I),
                     dtype=torch.float32, device=device)
    f = torch.tensor(rng.beta(a, b, size=(K, L)).clip(0.01, 0.99),
                     dtype=torch.float32, device=device)
    planes = torch.empty((2, I, L), dtype=torch.int8, device=device)
    miss = torch.empty((I, L), dtype=torch.int8, device=device)
    rows = max(1, BLOCK_CELLS // L)
    for lo in range(0, I, rows):
        hi = min(I, lo + rows)
        p = q[lo:hi] @ f
        x0 = (torch.rand((hi - lo, L), generator=gen, device=device)
              < p).to(torch.int8)
        x0 += (torch.rand((hi - lo, L), generator=gen, device=device)
               < p).to(torch.int8)
        del p
        if rate > 0:
            m = (torch.rand((hi - lo, L), generator=gen, device=device)
                 < rate).to(torch.int8) * 2
            x0 = torch.where(m > 0, torch.zeros_like(x0), x0)
        else:
            m = torch.zeros_like(x0)
        planes[0, lo:hi] = x0
        planes[1, lo:hi] = 2 - m - x0
        miss[lo:hi] = m
    return planes, miss
