"""Projection onto the lower-bounded probability simplex
(multiclust_tpu/ops/simplex.py).

Michelot's finite iterative algorithm (michelot_project, simplex.c:109-143)
batched over every row at once: each pass subtracts the uniform surplus
from the free lanes and pins any lane that falls below lb; a row is done
after a pass that pins nothing.  EM inputs are near-feasible, so the loop
ends after one or two passes.  Each pass reads one flag to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from multiclust_tpu_torch.ops.build import count

Tensor = torch.Tensor


def project_rows(v: Tensor, mask: Tensor, lower_bound: float,
                 total: float = 1.0) -> Tensor:
    """Project rows of ``v`` onto {x >= lb on valid lanes, sum = total}.

    Args:
      v: [..., M] rows to project.
      mask: bool, valid lanes, broadcastable to v's shape.
      lower_bound: lb >= 0.
      total: the required sum (1.0 for probability rows).

    Returns: projected rows; invalid lanes are zeroed.
    """
    dtype = v.dtype
    mask = mask.expand(v.shape)
    zero = torch.zeros((), dtype=dtype, device=v.device)
    lb = torch.full((), lower_bound, dtype=dtype, device=v.device)
    w = torch.where(mask, v, zero)
    free = mask
    done = torch.zeros(v.shape[:-1], dtype=torch.bool, device=v.device)
    while True:
        count("host.syncs")
        if bool(done.all()):
            break
        n_free = free.sum(dim=-1).to(dtype)
        csum = w.sum(dim=-1)
        offset = (csum - total) / torch.clamp(n_free, min=1.0)
        upd = free & ~done[..., None]
        w2 = torch.where(upd, w - offset[..., None], w)
        newly = upd & (w2 < lb)
        w = torch.where(newly, lb, w2)
        clamped = newly.any(dim=-1)
        free = free & ~newly
        done = done | ~clamped | (free.sum(dim=-1) == 0)
    return torch.where(mask, w, zero)


def kmask_lanes(kmask: Tensor, ndim: int, axis: int = -1) -> Tensor:
    """The true lanes of a runtime lane mask (``Params.kmask``: 1.0/0.0,
    [Kp] for every chain or [B, Kp] a chain each) as bools shaped to
    broadcast against a chain batch of ``ndim`` dims whose cluster axis
    is ``axis`` (its leading dim the chain, for a [B, Kp] mask)."""
    valid = kmask > 0.5
    axis %= ndim
    tail = (1,) * (ndim - axis - 1)
    if valid.dim() == 2:
        return valid.reshape(valid.shape[:1] + (1,) * (axis - 1)
                             + valid.shape[1:] + tail)
    return valid.reshape(valid.shape + tail)


def michelot_reference(params, lower_bound: float, total: float = 1.0):
    """Direct numpy port of michelot_project (simplex.c:109-143): a test
    oracle for project_rows, not used in the compute path."""
    params = np.array(params, dtype=np.float64)
    length = params.shape[0]
    fixed = np.zeros(length, dtype=bool)
    n = length
    while n:
        csum = params.sum()
        offset = (csum - total) / n
        can_terminate = True
        for i in range(length):
            if not fixed[i]:
                params[i] -= offset
                if params[i] < lower_bound:
                    params[i] = lower_bound
                    fixed[i] = True
                    n -= 1
                    can_terminate = False
        if can_terminate:
            break
    return params
