"""What benchmark/run.py runs loads neither jax nor the JAX package, and
the reference loads nothing of the program either (module names compared
whole by their top-level part: multiclust_tpu_torch is not
multiclust_tpu)."""

import json
import subprocess
import sys

from benchmark import harness

RUN_SMALL = """
import sys, time
sys.path[0] = {root!r}
from benchmark import harness
from benchmark.tests.helpers import run_small, small_cell
run_small(small_cell("hgdp650k.mix_k7"), traced=True)
print(harness.loaded_forbidden())
"""

REFERENCE = """
import sys, json
sys.path[0] = {root!r}
import torch
from benchmark.reference import fit, judge, models, precision
eta = torch.full((6, 2), 0.5, dtype=torch.float64)
p = torch.full((2, 5, 2), 0.5, dtype=torch.float64)
planes = torch.ones((2, 6, 5), dtype=torch.int8)
miss = torch.zeros((6, 5), dtype=torch.int8)
judge.judge("admixture", eta, p, -1.0, planes, miss, 1e-8, 1e-8)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _python(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(harness.ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]


def test_a_run_loads_no_jax_and_no_jax_package():
    assert _python(RUN_SMALL.format(root=str(harness.ROOT))) == "[]"


def test_the_reference_loads_nothing_of_the_program():
    top = set(json.loads(_python(REFERENCE.format(root=str(harness.ROOT)))))
    assert not top & {"multiclust_tpu_torch", "multiclust_tpu", "jax",
                      "jaxlib", "flax"}


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "multiclust_tpu_torch_like", sys)
    assert "multiclust_tpu" not in harness.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib" in harness.loaded_forbidden()


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "hgdp650k.admix_k7", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=600,
        cwd=str(harness.ROOT))
    assert out.returncode != 0
    assert "correct" not in out.stdout
