"""The check's control and its faults, on small cells on the CPU.

The control is the reference put in the program's place in TF32 (its
products' inputs rounded by hand on the CPU); each fault is planted in the
program (benchmark/faults.py) underneath a whole run of the harness.  Each
must come out as not correct, where the program's own run is correct.

The small cells take limits of their own: the numbers scale with the
panel (a 48 x 300 panel's float32 noise floor is far above the full
panels'), so the cells' limits (benchmark/limits/) do not apply here.
These were set from CPU readings at this size: program logl_gap
1.9e-7-2.2e-7 (admixture), 2e-9-3e-9 (mixture); control 1.3e-5-1.1e-4;
faults 4.6e-3 and above in step_gain or logl_gap.
"""

import pytest

from benchmark import control, faults
from benchmark.tests.helpers import run_small, small_cell

LIMITS = {"logl_gap": 2e-6, "step_gain": 2e-6}
CELLS = ("hgdp650k.admix_k7", "hgdp650k.mix_k7")


def _cell(name):
    cell = small_cell(name)
    cell.limits = dict(LIMITS)
    return cell


@pytest.mark.parametrize("name", CELLS)
def test_the_program_is_correct(name):
    _, verdict, res = run_small(_cell(name))
    assert verdict["correct"] and res["correct"], verdict["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_in_tf32_is_not_correct(name):
    cell = _cell(name)
    _, verdict, res = run_small(cell, fit=control.reference_fit(),
                                prepare=control.reference_data(cell.config))
    assert not verdict["correct"] and not res["correct"], verdict["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_reference_in_float64_in_its_place_is_correct(name):
    cell = _cell(name)
    _, verdict, _ = run_small(cell, fit=control.reference_fit("f64"),
                              prepare=control.reference_data(cell.config))
    assert verdict["correct"], verdict["checks"]


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_a_planted_fault_is_not_correct(name, fault):
    with faults.planted(fault):
        _, verdict, res = run_small(_cell(name))
    assert not verdict["correct"] and not res["correct"], verdict["checks"]
