"""The benchmark of ``multiclust_tpu_torch``: whole fits of a genotype panel
made on the card, timed as a user waits for them.

A cell of ``BENCHMARK.json`` names a configuration (a panel's shape, in
``configs/``) and a traffic mix (the fits' options, in ``traffic/``).  A
run makes the panel on the card from the configuration's own seed, warms
the program with a two-iteration fit (set-up ends there), then runs whole
fits back to back, one client, in passes: each pass is the mix's fixed
set of ``fit_set`` starts in an order drawn from ``--seed``, and no pass
starts that the last pass's time says would end after ``--seconds`` (one
always runs).  A fit's work (its iterations) follows from its data and
its start, so every seed times the same work.  With ``--trace 1`` it then
runs whole fits under ``torch.profiler`` for the mix's ``trace_seconds``.
Then it fits one more panel, drawn from ``--seed``, from a start drawn
from ``--seed``.  Once the peak memory has been read and the program's
state freed, the plain reference (``reference/``) judges the first pass's
answers (every fit of the set) and that last fit's, against the limits
in ``limits/<cell>.json``.

Every metric is read by its own file ``metrics/<name>.py`` from the
``Run`` below, and the roofline by ``roofline/<model>_<alleles>.py``:
a later cell, mix or metric is new files and entries, not an edit.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np
import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "multiclust_tpu")
OUT_DIR = "bench_out"
# the keys of a traffic mix that the harness reads (program.OPTION_KEYS
# the rest); a mix with any other key is refused
RUN_KEYS = ("fit_set", "trace_seconds")


# ---------------------------------------------------------------------------
# the cell, found by name

@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration's file
    traffic: dict         # the mix's file
    limits: dict          # the compared numbers' limits
    end_to_end: list      # BENCHMARK.json entries reported with --trace 0
    per_layer: list       # ... and with --trace 1
    bench: Path = BENCH   # the folder its files were found in


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json, with its files."""
    spec = _json(root / "BENCHMARK.json")
    wl = next((w for w in spec["workloads"] if w["name"] == name), None)
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == wl["config"])
    from benchmark.program import OPTION_KEYS

    bench = root / "benchmark"
    traffic = _json(bench / "traffic" / f"{wl['traffic']}.json")
    unread = sorted(set(traffic) - set(RUN_KEYS) - set(OPTION_KEYS))
    if unread:
        raise ValueError(f"traffic {wl['traffic']!r}: no code reads "
                         f"{', '.join(unread)}")
    return Cell(name=name, chips=int(wl["chips"]),
                config=_json(root / conf["file"]), traffic=traffic,
                limits=_json(bench / "limits" / f"{name}.json"),
                end_to_end=spec["end_to_end"], per_layer=spec["per_layer"],
                bench=bench)


def load_module(path: Path):
    """A module of the benchmark loaded from its file (a metric's reader,
    a model's roofline)."""
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{path.parent.name}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, bench: Path = BENCH):
    return load_module(bench / "metrics" / f"{metric}.py")


def roofline(config: dict, traffic: dict, bench: Path = BENCH):
    kind = "bi" if int(config["alleles"]) == 2 else "generic"
    return load_module(bench / "roofline" / f"{traffic['model']}_{kind}.py")


# ---------------------------------------------------------------------------
# one run

@dataclasses.dataclass
class FitRecord:
    wall_s: float
    seconds: float
    n_iter_all: int
    n_launched: int
    batch_chains: int
    route: str
    launches: dict


@dataclasses.dataclass
class Run:
    """What a run measured, as the metrics' readers see it."""

    config: dict
    traffic: dict
    setup_s: float
    window_s: float
    fits: List[FitRecord]
    peak_bytes: int
    traced: List[FitRecord] = dataclasses.field(default_factory=list)
    trace: Optional[object] = None        # tracing.TraceSummary
    peaks: dict = dataclasses.field(default_factory=dict)
    roofline: Optional[object] = None

    @property
    def cells(self) -> int:
        """Genotype cells of the panel: I x sum over loci of the alleles."""
        return (int(self.config["individuals"]) * int(self.config["loci"])
                * int(self.config["alleles"]))


def on_host(ans):
    """``ans`` with its parameters copied to the host, so that holding it
    holds none of the program's memory on the card (its tensors may be
    views of a whole chain batch)."""
    return dataclasses.replace(ans, eta=ans.eta.cpu(), p=ans.p.cpu())


def fit_seeds(seed: int):
    """An endless sequence of fit seeds drawn from ``seed``."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 1]))
    while True:
        yield int(rng.integers(0, 2**31 - 1))


def fit_passes(config: dict, traffic: dict, seed: int):
    """The run's passes of fit seeds: each the set of the mix's
    ``fit_set`` starts (drawn from the configuration's panel seed, the same
    in every run), in an order drawn from ``seed``."""
    base = fit_seeds(int(config["panel_seed"]))
    fixed = [next(base) for _ in range(int(traffic["fit_set"]))]
    rng = np.random.default_rng(np.random.SeedSequence([seed, 3]))
    while True:
        yield [fixed[j] for j in rng.permutation(len(fixed))]


def record(ans, wall: float) -> FitRecord:
    return FitRecord(wall_s=wall, seconds=ans.seconds,
                     n_iter_all=ans.n_iter_all, n_launched=ans.n_launched,
                     batch_chains=ans.batch_chains, route=ans.route,
                     launches=ans.launches or {})


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def program_fit(md, traffic: dict, seed: int, max_iter=None):
    """One fit of the program under ``traffic``: (Answer, wall seconds)."""
    from benchmark import program

    return program.timed_fit(md, 2, program.options(traffic, seed,
                                                    max_iter=max_iter))


def measure(cell: Cell, seed: int, seconds: float, traced: bool,
            device, t_start: float,
            fit: Callable = program_fit, prepare: Callable = None) -> dict:
    """Set-up, the window, the traced sub-window and the seeded fit of one
    run: {"run": Run, "judged": [(answer, planes, miss)], "seeded": the
    seeded fit's FitRecord or None, "attempted", "failed"}.
    ``fit(md, traffic, seed, max_iter=None)`` runs one fit (the program's,
    or the reference in its place for the control); ``prepare(planes,
    miss)`` makes what it fits (the program's ModelData)."""
    from benchmark import panel, tracing

    if prepare is None:
        from benchmark.program import model_data as prepare
    conf, traffic = cell.config, cell.traffic
    planes, miss = panel.make_panel(conf, int(conf["panel_seed"]), device)
    md = prepare(planes, miss)
    fit(md, traffic, int(conf["panel_seed"]), max_iter=2)
    _sync(device)
    setup_s = time.perf_counter() - t_start

    passes = fit_passes(conf, traffic, seed)
    fits: List[FitRecord] = []
    judged = []
    tally = {"attempted": 0, "failed": 0}

    def attempt(data, fit_seed):
        """One fit: its Answer and wall seconds, or None where it raised
        (counted as failed, and the run goes on)."""
        tally["attempted"] += 1
        try:
            return fit(data, traffic, fit_seed)
        except Exception:
            traceback.print_exc()
            tally["failed"] += 1
            return None

    w0 = end = time.perf_counter()
    first = True
    while True:
        start = end
        for fit_seed in next(passes):
            got = attempt(md, fit_seed)
            if got is not None:
                fits.append(record(*got))
                if first:
                    judged.append((on_host(got[0]), planes, miss))
            del got
        end = time.perf_counter()
        first = False
        # a next pass would take about as long as this one did
        if end + (end - start) - w0 > seconds:
            break
    window_s = end - w0

    traced_fits: List[FitRecord] = []
    summary = None
    if traced:
        from torch.profiler import ProfilerActivity, profile, \
            record_function
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        seeds = (s for one in passes for s in one)
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            while not traced_fits or (time.perf_counter() - t0
                                      < float(traffic["trace_seconds"])):
                with record_function("bench.fit"):
                    got = attempt(md, next(seeds))
                with record_function("bench.record"):
                    if got is None:
                        break
                    traced_fits.append(record(*got))
                    del got
        summary = tracing.from_profiler(prof)

    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    del md
    # one fit more, of a panel and from a start drawn from the run's seed,
    # outside the window and after the peak was read: what the check
    # judges is not only the fixed set
    planes_s, miss_s = panel.make_panel(conf, seed, device)
    md = prepare(planes_s, miss_s)
    got = attempt(md, next(fit_seeds(seed)))
    del md
    seeded = None
    if got is not None:
        seeded = record(*got)
        judged.append((on_host(got[0]), planes_s, miss_s))
    del got
    if device.type == "cuda":
        torch.cuda.empty_cache()
    run = Run(config=conf, traffic=traffic, setup_s=setup_s,
              window_s=window_s, fits=fits, peak_bytes=peak,
              traced=traced_fits, trace=summary,
              peaks=_json(cell.bench / "peaks.json"),
              roofline=roofline(conf, traffic, cell.bench))
    return {"run": run, "judged": judged, "seeded": seeded, **tally}


def check(cell: Cell, judged) -> dict:
    """The worst of each compared number over the judged answers (each
    beside the panel it was fitted to), beside its limit, and whether all
    are within."""
    from benchmark.reference import judge, models

    conf = cell.config
    lb = models.lower_bound(int(conf["individuals"]), int(conf["ploidy"]),
                            float(conf["lower_bound"]))
    readings = [judge.judge(cell.traffic["model"], ans.eta.to(pl.device),
                            ans.p.to(pl.device), ans.logl, pl, mi, lb, lb)
                for ans, pl, mi in judged]
    worst = {}
    for k in cell.limits:
        vals = [r[k] for r in readings] or [math.nan]
        worst[k] = next((v for v in vals if not math.isfinite(v)), max(vals))
    ok = bool(judged) and judge.within(worst, cell.limits)
    return {"correct": ok,
            "checks": {k: {"value": _number(worst[k]),
                           "limit": cell.limits[k]} for k in cell.limits},
            "checked": len(judged)}


def _number(v: float):
    """``v``, or its name where JSON has no number for it."""
    return v if math.isfinite(v) else repr(v)


def metrics_of(run: Run, entries: list, bench: Path = BENCH) -> dict:
    """{name: {"value", "unit"}} of the metrics ``entries`` that their
    readers find something to read for."""
    out = {}
    for m in entries:
        v = reader(m["name"], bench).read(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def loaded_forbidden() -> List[str]:
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole (multiclust_tpu_torch is not multiclust_tpu)."""
    top = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(top & set(FORBIDDEN))


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip() or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def result_line(cell: Cell, out: dict, verdict: dict, traced: bool,
                device) -> dict:
    run: Run = out["run"]
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(run.peak_bytes)}
    res = {"correct": verdict["correct"] and out["failed"] == 0,
           "attempted": out["attempted"], "failed": out["failed"],
           "metrics": metrics_of(run, cell.per_layer if traced
                                 else cell.end_to_end, cell.bench),
           "device": dev}
    if traced:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        res["breakdown"] = {
            "device_ops": [[n, s] for n, s in run.trace.device_ops],
            "idle_gaps": [[n, s] for n, s in run.trace.idle_gaps]}
    res["checks"] = verdict["checks"]
    return res


def details(cell: Cell, seed: int, out: dict, traced: bool) -> dict:
    """The run's route, chain batch and launches per fit: an earlier line
    of standard output and a file under bench_out/, not metrics."""
    run: Run = out["run"]
    fits = run.fits + run.traced
    d = {"workload": cell.name, "seed": seed,
         "fits": len(run.fits), "traced_fits": len(run.traced),
         "routes": sorted({f.route for f in fits}),
         "batch_chains": sorted({f.batch_chains for f in fits}),
         "launches_per_fit": {
             k: sum(f.launches.get(k, 0) for f in fits) / max(len(fits), 1)
             for k in sorted({k for f in fits for k in f.launches})},
         "fit_wall_s": [f.wall_s for f in fits],
         "fit_seconds": [f.seconds for f in fits],
         "chain_iters": [f.n_iter_all for f in fits],
         "seeded_fit": (dataclasses.asdict(out["seeded"])
                        if out["seeded"] else None)}
    if traced:
        d["power"] = power_limit()
    return d


def main(argv, t_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    traced = bool(args.trace)
    out = measure(cell, args.seed, args.seconds, traced, device, t_start)
    verdict = check(cell, out["judged"])
    bad = loaded_forbidden()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    info = details(cell, args.seed, out, traced)
    out_dir = ROOT / OUT_DIR
    out_dir.mkdir(exist_ok=True)
    with open(out_dir / f"{cell.name}.{args.seed}.{args.trace}.json",
              "w") as f:
        json.dump(info, f)
    print(json.dumps(info))
    res = result_line(cell, out, verdict, traced, device)
    for k, v in verdict["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(f"checked {verdict['checked']} answers; failed fits "
          f"{out['failed']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0
