"""Readings that set a cell's limits: the numbers of the check
(reference/judge.py) for the program's answers, for the control's (the
reference put in the program's place, in TF32: reference/fit.py) and for
the program with each fault of faults.py planted, at the cell's own size,
on several seeds, in one process.  The benchmark's runs do not run it.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 \
        [--modes program,control,unchanged,half_batch,altered] [--fits 2]

One JSON line per answer on standard output (and in bench_out/).  A
control's line also holds ``x_rounding``, |X - logL(theta')| / |logL|
with theta' the parameters its last step started from and logL in
float64: the part of its ``logl_gap`` that its precision makes, apart
from ``last_gain``, what that last step gained (a capped start's is not
nought).

    python3 benchmark/control.py --workload <name> --seeds 1 --harness <seconds>

runs the control in the program's place through a whole run of the
harness instead (harness.measure and harness.check, at the cell's size
and with its limits) and prints the verdict.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __name__ == "__main__":
    # the checkout's root, in place of this script's folder
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from benchmark import faults, harness, panel, program  # noqa: E402
from benchmark.reference import fit as reffit, judge, models  # noqa: E402
from benchmark.reference.precision import TF32  # noqa: E402

MODES = ("program", "control") + faults.FAULTS
# steps a start of the control may take (reference/fit.py's ``cap``)
CONTROL_CAP = 30


def reference_fit(prec: str = TF32, keep_prev: bool = False):
    """The harness's ``fit`` with the reference, in ``prec``, in the
    program's place (``prepare`` = ``reference_data``)."""
    def fit(data, traffic, seed, max_iter=None):
        planes, miss, lb = data
        t0 = time.perf_counter()
        ans = reffit.fit(planes, miss, traffic["model"], int(traffic["K"]),
                         int(traffic["n_init"]),
                         int(traffic["max_iter"]
                             if max_iter is None else max_iter),
                         float(traffic.get("abs_error", 1e-4)), seed, prec,
                         lb, cap=CONTROL_CAP if prec == TF32 else 0,
                         keep_prev=keep_prev)
        return ans, time.perf_counter() - t0
    return fit


def reference_data(config: dict):
    """The harness's ``prepare`` for ``reference_fit``."""
    lb = models.lower_bound(int(config["individuals"]),
                            int(config["ploidy"]),
                            float(config["lower_bound"]))
    return lambda planes, miss: (planes, miss, lb)


def answer(mode: str, cell, md, planes, miss, seed: int, lb: float):
    """One answer of ``mode``: the program's, the control's, or the
    program's with a fault planted."""
    if mode == "control":
        return reference_fit(keep_prev=True)((planes, miss, lb),
                                             cell.traffic, seed)[0]
    opt = program.options(cell.traffic, seed)
    if mode == "program":
        return program.fit(md, 2, opt)
    with faults.planted(mode):
        return program.fit(md, 2, opt)


def rounding(model: str, ans, logl: float, planes, miss) -> dict:
    """A control answer's ``x_rounding`` and ``last_gain`` (see above),
    ``logl`` the float64 log likelihood of its parameters."""
    prev = float(models.terms(model, ans.prev_eta.to(torch.float64),
                              ans.prev_p.to(torch.float64), planes,
                              miss).sum())
    return {"x_rounding": abs(ans.logl - prev) / abs(prev),
            "last_gain": (logl - prev) / abs(prev)}


def through_harness(cell, seed: int, seconds: float, dev):
    """The verdict of one whole run of the harness at the cell's size with
    the control in the program's place."""
    t0 = time.perf_counter()
    out = harness.measure(cell, seed, seconds, False, dev, t0,
                          fit=reference_fit(),
                          prepare=reference_data(cell.config))
    verdict = harness.check(cell, out["judged"])
    return {"mode": "control", "seed": seed, "harness": True,
            "correct": verdict["correct"] and out["failed"] == 0,
            "checks": verdict["checks"], "checked": verdict["checked"],
            "attempted": out["attempted"], "failed": out["failed"],
            "fits": len(out["run"].fits),
            "wall_s": time.perf_counter() - t0}


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", default=",".join(MODES))
    ap.add_argument("--fits", type=int, default=2)
    ap.add_argument("--harness", type=float, default=0.0,
                    help="seconds of a whole harness run of the control a "
                         "seed")
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    dev = torch.device("cuda")
    conf = cell.config
    lb = models.lower_bound(int(conf["individuals"]), int(conf["ploidy"]),
                            float(conf["lower_bound"]))
    out_dir = harness.ROOT / harness.OUT_DIR
    out_dir.mkdir(exist_ok=True)
    log = open(out_dir / f"control.{cell.name}.jsonl", "a")
    if args.harness:
        for seed in (int(s) for s in args.seeds.split(",")):
            row = through_harness(cell, seed, args.harness, dev)
            print(json.dumps(row), flush=True)
            log.write(json.dumps(row) + "\n")
            log.flush()
            torch.cuda.empty_cache()
        log.close()
        return 0
    for seed in (int(s) for s in args.seeds.split(",")):
        planes, miss = panel.make_panel(conf, seed, dev)
        md = program.model_data(planes, miss)
        for mode in args.modes.split(","):
            seeds = harness.fit_seeds(seed)
            for _ in range(args.fits):
                fs = next(seeds)
                t0 = time.perf_counter()
                try:
                    ans = answer(mode, cell, md, planes, miss, fs, lb)
                except Exception as e:  # a control that fails has failed
                    row = {"mode": mode, "seed": seed, "fit_seed": fs,
                           "error": repr(e)}
                else:
                    wall = time.perf_counter() - t0
                    nums = judge.judge(cell.traffic["model"], ans.eta, ans.p,
                                       ans.logl, planes, miss, lb, lb)
                    row = {"mode": mode, "seed": seed, "fit_seed": fs,
                           "wall_s": wall, "iters": ans.n_iter_all,
                           "logl": ans.logl, **nums}
                    if mode == "control":
                        row.update(rounding(cell.traffic["model"], ans,
                                            nums["logl"], planes, miss))
                    del ans
                print(json.dumps(row), flush=True)
                log.write(json.dumps(row) + "\n")
                log.flush()
        del md, planes, miss
        torch.cuda.empty_cache()
    log.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
