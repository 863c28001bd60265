"""Small cells for the benchmark's CPU tests."""

import time

import torch

from benchmark import harness

CPU = torch.device("cpu")


def small_cell(name="hgdp650k.admix_k7", I=48, L=300, **traffic):
    """The cell ``name`` of the repository, at I x L, with ``traffic``'s
    overrides."""
    cell = harness.load_cell(name)
    cell.config = dict(cell.config, individuals=I, loci=L)
    cell.traffic = dict(cell.traffic, trace_seconds=0.05, **traffic)
    return cell


def run_small(cell, seed=2**31 + 5, seconds=0.2, traced=False, **kw):
    """measure + check + the result line of ``cell`` on the CPU."""
    out = harness.measure(cell, seed, seconds, traced, CPU,
                          time.perf_counter(), **kw)
    verdict = harness.check(cell, out["judged"])
    return out, verdict, harness.result_line(cell, out, verdict, traced, CPU)
