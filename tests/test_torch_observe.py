"""The spans and counters of a fit (runtime/observe.py, ops/build.LAUNCHES)
on the CPU: the counters move on every fit, the spans only under a
profiler, where they nest in ``mc.fit`` as host ranges that are not user
annotations (so they leave no mark on a card's timeline)."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from multiclust_tpu_torch.api import fit_model_data
from multiclust_tpu_torch.config import InitProcedure, Options
from multiclust_tpu_torch.init import random as rinit
from multiclust_tpu_torch.model.common import model_data_from_dataset
from multiclust_tpu_torch.ops import build
from multiclust_tpu_torch.runtime.multistart import cfg_from_options
from multiclust_tpu_torch.stats.sim import simulate_admixture_fast

torch.set_num_threads(2)

CHILDREN = ("mc.plan", "mc.init", "mc.em", "mc.harvest")
# spans opened inside another child, by their parent: an admixture start's
# counts
NESTED = {"mc.init.counts": "mc.init"}


@pytest.fixture(scope="module")
def md():
    rng = np.random.default_rng(22)
    Q = rng.dirichlet(np.full(3, 0.5), size=40)
    P = rng.dirichlet(np.full(2, 0.8), size=(3, 120))
    ds = simulate_admixture_fast(rng, Q, P, missing_rate=0.02)
    return model_data_from_dataset(ds, dtype=torch.float64)


def _fit(md, admixture, **kw):
    """(the fit's best MaximizeResult, the counters' deltas)."""
    before = dict(build.LAUNCHES)
    out = fit_model_data(md, 2, admixture=admixture, min_K=3, max_K=3,
                         n_init=3, seed=5, max_iter=40, verbosity=0,
                         write_files=False, **kw)
    return out.best, {k: v - before[k] for k, v in build.LAUNCHES.items()
                      if v != before[k]}


@pytest.mark.parametrize("admixture", [True, False])
def test_counters_move_and_spans_stay_off_outside_a_profiler(md, admixture):
    best, moved = _fit(md, admixture)
    assert moved["em.model_steps"] > 0
    assert moved["em.chain_steps"] >= moved["em.model_steps"]
    assert moved["host.syncs"] > 0
    assert 0 < best.n_iter_all <= moved["em.chain_steps"]
    assert not any(k.startswith("span_") for k in moved), moved
    assert "host.mem_queries" not in moved        # none on the CPU


@pytest.mark.parametrize("admixture", [True, False])
def test_spans_nest_in_the_fit_under_a_profiler(md, admixture):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        best, moved = _fit(md, admixture)
    spans = [e for e in prof.events() if e.name.startswith("mc.")]
    names = {e.name for e in spans}
    want = set(CHILDREN)
    nested = set(NESTED) if admixture else set()
    assert names == want | nested | {"mc.fit"}
    for e in spans:
        # a host range, not a user annotation: on a card a user annotation
        # is marked on the device's timeline too
        assert not e.is_user_annotation, e.name
        if e.name != "mc.fit":
            assert e.cpu_parent is not None
            assert e.cpu_parent.name == NESTED.get(e.name, "mc.fit"), \
                e.name
    for name in want | nested | {"mc.fit"}:
        assert moved[f"span_us.{name}"] > 0, name
        assert moved[f"span_n.{name}"] == sum(e.name == name
                                              for e in spans), name
    assert moved["span_n.mc.fit"] == 1
    # the children lie inside the root, and do not overlap one another
    assert sum(moved[f"span_us.{n}"] for n in want) <= \
        moved["span_us.mc.fit"]
    for name in nested:
        assert moved[f"span_us.{name}"] <= moved[f"span_us.{NESTED[name]}"]
    assert best.n_iter_all <= moved["em.chain_steps"]


def test_rand_em_scoring_counts_as_init(md):
    opt = Options(admixture=True, min_K=3, max_K=3).synchronize(md.I, 2)
    cfg = cfg_from_options(opt, 3, md)
    gen = torch.Generator().manual_seed(3)
    before = dict(build.LAUNCHES)
    rinit.initialize(gen, md, 3, cfg, procedure=InitProcedure.RAND_EM,
                     n_rand_em_init=4)
    moved = {k: v - before[k] for k, v in build.LAUNCHES.items()
             if v != before[k]}
    # the 4 candidates are scored in one batch: one model step
    assert moved["init.model_steps"] == 1
    assert moved["init.chain_steps"] == 4
    assert "em.model_steps" not in moved and "em.chain_steps" not in moved
    # in a fit, the scoring steps count apart from the EM steps
    _, fitted = _fit(md, True,
                     initialization_procedure=InitProcedure.RAND_EM,
                     n_rand_em_init=4)
    assert fitted["init.chain_steps"] == 4 * fitted["init.model_steps"] > 0
    assert fitted["em.chain_steps"] > 0


def test_kernel_launches_leave_the_counters_out():
    names = set(build.kernel_launches())
    assert names and not names & set(build.COUNTERS)
    assert names | set(build.COUNTERS) == set(build.LAUNCHES)
    build.count("host.syncs", 3)
    assert build.LAUNCHES["host.syncs"] >= 3
    build.reset_launch_counts()
    assert not any(build.LAUNCHES.values())
