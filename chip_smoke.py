"""Smoke run of the PyTorch/CUDA port on one GPU: the admixture main path at
the full panel width, through its hand-written CUDA kernels.

Run from the root of a checkout with ``python3 chip_smoke.py``.  Phases,
each raising on failure:

1. device: a CUDA device is required; prints the card's name and limit;
2. build: compiles ``multiclust_tpu_torch/csrc/*.cu`` with nvcc;
3. kernels: the biallelic EM-step kernel pair against its plain PyTorch
   version at I=16384, L=2048, K=20 (Kp=32), chain batches 1 and 4,
   missing 0 % and 2 %, logL terms on and off; median CUDA-event times;
4. fit: ``api.fit_dataset`` on a simulated 16384 x 2048, K=20 panel
   (plain EM with the adaptive interval, then SQUAREM), with the kernel
   launch counts of that run; then a small warm-start fit held to the
   float64 CPU path;
5. CLI: ``multiclust_tpu_torch.cli.main`` on a 1024 x 1000, K=3 STRUCTURE
   file with 5 % missing.

The last two lines are the kernels' JSON record and the device record.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

I_FULL, L_FULL, K_FULL = 16384, 2048, 20
# float32, kernel against plain version (sums in other orders)
RTOL, ATOL = 1e-4, 5e-5
TPU_KERNEL = "multiclust_tpu/ops/kernels.py:344"
SOURCE = "multiclust_tpu_torch/csrc/fullstep_bi.cu"


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def median_ms(fn, n=20, warm=3) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def step_inputs(rng, B, I, L, K, Kp, miss_rate, dev):
    eta = np.zeros((B, I, Kp), np.float32)
    eta[:, :, :K] = rng.dirichlet(np.full(K, 0.5), size=(B, I))
    p0 = np.zeros((B, Kp, L), np.float32)
    p0[:, :K] = rng.uniform(0.02, 0.98, size=(B, K, L))
    miss = rng.binomial(2, miss_rate, size=(I, L))
    x0 = rng.binomial(2 - miss, 0.5)
    return (torch.tensor(eta, device=dev), torch.tensor(p0, device=dev),
            torch.tensor(x0, dtype=torch.int8, device=dev),
            torch.tensor(2 - miss - x0, dtype=torch.int8, device=dev),
            torch.tensor(miss.sum(1), dtype=torch.float32, device=dev),
            torch.tensor(miss, dtype=torch.int8, device=dev)
            if miss_rate else None)


def max_err(got, ref) -> float:
    torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
    return float((got - ref).abs().max())


def phase_kernels(fb, dev, where):
    rng = np.random.default_rng(1)
    K, Kp = K_FULL, 32
    errs = {"rows": 0.0, "cols": 0.0}
    for B in (1, 4):
        for miss_rate in (0.0, 0.02):
            args = step_inputs(rng, B, I_FULL, L_FULL, K, Kp, miss_rate,
                               dev)
            for compute_t in (True, False):
                kw = dict(k_true=K, lb=1e-8, plb=1e-8, project=True,
                          compute_t=compute_t)
                got = fb.admixture_fullstep_biallelic(*args, **kw)
                ref = fb.admixture_fullstep_biallelic_reference(*args, **kw)
                torch.cuda.synchronize()
                e_eta, e_t, e_p = (max_err(g, r) for g, r in zip(got, ref))
                assert (got[0][..., K:] == 0).all()
                assert (got[2][:, K:] == 0).all()
                errs["rows"] = max(errs["rows"], e_eta, e_t)
                errs["cols"] = max(errs["cols"], e_p)
                k_ms = median_ms(
                    lambda: fb.admixture_fullstep_biallelic(*args, **kw))
                p_ms = median_ms(
                    lambda: fb.admixture_fullstep_biallelic_reference(
                        *args, **kw))
                cells = B * I_FULL * L_FULL * 2
                print(f"kernel B={B} miss={miss_rate:.2f} "
                      f"compute_t={compute_t}: max|d| eta'={e_eta:.3e} "
                      f"t={e_t:.3e} p0'={e_p:.3e} (rtol {RTOL}, atol "
                      f"{ATOL}); kernel {k_ms:.3f} ms "
                      f"({cells / k_ms / 1e6:.2f} Gcells/s), plain "
                      f"{p_ms:.3f} ms ({cells / p_ms / 1e6:.2f} Gcells/s) "
                      f"on {where}", flush=True)
    # each pass at the fit's shape (chain batch 2, 1 % missing)
    e, p, a, z, c, m = step_inputs(rng, 2, I_FULL, L_FULL, K, Kp, 0.01, dev)
    row_kw = dict(k_true=K, lb=1e-8, project=True, compute_t=True)
    passes = {
        "rows": (lambda: fb.fullstep_bi_rows(e, p, a, z, c, **row_kw),
                 lambda: fb.fullstep_bi_rows_reference(e, p, a, z, c,
                                                       **row_kw)),
        "cols": (lambda: (fb.fullstep_bi_cols(e, p, a, z, m, plb=1e-8,
                                              project=True),),
                 lambda: (fb.fullstep_bi_cols_reference(
                     e, p, a, z, m, plb=1e-8, project=True),)),
    }
    ms = {}
    for name, (kernel, plain) in passes.items():
        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        err = max(max_err(g, r) for g, r in zip(got, ref))
        errs[name] = max(errs[name], err)
        ms[name] = (median_ms(kernel), median_ms(plain))
        print(f"pass {name} B=2 miss=0.01: max|d| {err:.3e}; kernel "
              f"{ms[name][0]:.3f} ms, plain {ms[name][1]:.3f} ms on {where}",
              flush=True)
    return errs, ms


def simulated_counts(rng, I, L, K, miss_rate):
    """Admixture-model genotypes: each copy draws a cluster from Q_i and
    an allele from P_k, so allele 0 has probability (Q @ P0)_il."""
    Q = rng.dirichlet(np.full(K, 0.5), size=I)
    P0 = rng.beta(0.8, 0.8, size=(K, L)).clip(0.01, 0.99)
    miss = rng.binomial(2, miss_rate, size=(I, L))
    x0 = rng.binomial(2 - miss, Q @ P0)
    return np.stack([x0, 2 - miss - x0], axis=2), miss


def check_fit(out, wall, label, where):
    res = out.best
    eta, p = res.best_params
    assert np.isfinite(res.max_logL) and not res.mono_viol, label
    assert not res.any_failed, label
    assert eta.shape == (out.dataset.I, K_FULL)
    assert p.shape == (K_FULL, out.dataset.L, 2)
    lb = 1e-8 * (1 - 1e-6)
    assert float(eta.min()) >= lb and float(p.min()) >= lb, label
    torch.testing.assert_close(eta.sum(dim=1), torch.ones_like(eta[:, 0]),
                               rtol=0, atol=1e-5)
    torch.testing.assert_close(p.sum(dim=2), torch.ones_like(p[..., 0]),
                               rtol=0, atol=1e-6)
    n = res.n_iter_all
    cells = n * out.dataset.I * out.dataset.L * 2
    print(f"fit {label}: logL {res.max_logL:.4f}, {n} EM iterations over "
          f"{res.n_launched} chains; fit_dataset {wall:.3f} s wall "
          f"({n / wall:.1f} iterations/s, {cells / wall / 1e9:.2f} Gcells/s), "
          f"of which init + EM {res.seconds:.3f} s ({n / res.seconds:.1f} "
          f"iterations/s, {cells / res.seconds / 1e9:.2f} Gcells/s) on "
          f"{where}", flush=True)
    return res


def phase_fit(build, dev, where):
    from multiclust_tpu_torch.api import fit_dataset
    from multiclust_tpu_torch.convert import dataset_from_counts

    rng = np.random.default_rng(2)
    counts, miss = simulated_counts(rng, I_FULL, L_FULL, K_FULL, 0.01)
    ds = dataset_from_counts(counts, miss, 2)
    base = dict(admixture=True, min_K=K_FULL, max_K=K_FULL, n_init=2,
                max_iter=100, seed=3, verbosity=2)

    def timed_fit(label, **kw):
        t0 = time.time()
        out = fit_dataset(ds, device=dev, **base, **kw)
        torch.cuda.synchronize()
        return check_fit(out, time.time() - t0, label, where)

    build.reset_launch_counts()
    plain = timed_fit("plain EM")
    squarem = timed_fit("SQUAREM", accel_scheme=1)
    launches = dict(build.LAUNCHES)
    print(f"launches in the fits: {launches}", flush=True)
    # one launch of each pass serves the whole chain batch (2 lanes)
    steps = (plain.n_iter_all + squarem.n_iter_all) // 2
    for name, n in launches.items():
        assert n >= steps > 0, (name, n, steps)
    return launches


def phase_reference(dev):
    """A small warm-start fit through the kernel path, held to the plain
    float64 step on the CPU over the same 30 iterations."""
    from multiclust_tpu_torch.convert import model_data_from_numpy, \
        params_from_numpy
    from multiclust_tpu_torch.model.common import EMConfig
    from multiclust_tpu_torch.opt.driver import fit
    from multiclust_tpu_torch.runtime.multistart import _pad_k, _to_bi_repr

    rng = np.random.default_rng(4)
    I, L, K = 600, 500, 3
    counts, miss = simulated_counts(rng, I, L, K, 0.05)
    mask, n_all = np.ones((L, 2), bool), np.full(L, 2)
    eta = rng.dirichlet(np.full(K, 2.0), size=I)
    p0 = rng.uniform(0.2, 0.8, size=(K, L))
    p = np.stack([p0, 1 - p0], axis=2)
    base = dict(admixture=True, has_missing=True, biallelic=True, k_true=K,
                max_iter=30, abs_error=1e-12, eta_lower_bound=1e-8,
                p_lower_bound=1e-8)
    cpu = fit(params_from_numpy(eta, p),
              model_data_from_numpy(counts, miss, mask, n_all),
              EMConfig(**base))
    cfg = EMConfig(use_pallas="on", **base)
    warm = params_from_numpy(eta, p, device=dev, dtype=torch.float32)
    gpu = fit(_to_bi_repr(_pad_k(warm, cfg), cfg),
              model_data_from_numpy(counts, miss, mask, n_all, device=dev,
                                    dtype=torch.float32), cfg)
    print(f"reference fit: kernel path logL {gpu.logL:.4f} vs float64 CPU "
          f"{cpu.logL:.4f} after {gpu.n_iter} iterations", flush=True)
    assert gpu.n_iter == cpu.n_iter == 31
    assert abs(gpu.logL - cpu.logL) < 0.1


def phase_cli(build, where):
    from multiclust_tpu_torch.cli import main

    rng = np.random.default_rng(5)
    I, L, K = 1024, 1000, 3
    counts, miss = simulated_counts(rng, I, L, K, 0.05)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sim.str")
        with open(path, "w") as fh:
            fh.write(" ".join(f"loc{l}" for l in range(L)) + "\n")
            for i in range(I):
                # copy a carries allele 1 when a < x0, allele 2 when
                # observed otherwise, -9 when missing
                for a in range(2):
                    obs = a < 2 - miss[i]
                    allele = np.where(a < counts[i, :, 0], 1, 2)
                    row = np.where(obs, allele, -9)
                    fh.write(f"ind{i} pop0 " + " ".join(map(str, row))
                             + "\n")
        build.reset_launch_counts()
        t0 = time.time()
        rc = main(["-f", path, "-a", "-k", "3", "-n", "4", "-s", "1",
                   "-d", tmp])
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
        assert rc == 0, rc
        for f in ("sim.str.admix.K=3.out.txt", "sim.str.admix.K=3.etaik.txt",
                  "sim.str.admix.K=3.pklm.txt", "sim.str_admix_popq_3.popq",
                  "sim.str_admix_indivq_3.indivq"):
            assert os.path.getsize(os.path.join(tmp, f)) > 0, f
    assert all(n > 0 for n in launches.values()), launches
    print(f"cli: rc 0 in {time.time() - t0:.2f} s, launches {launches} on "
          f"{where}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from multiclust_tpu_torch.ops import build, fullstep_bi as fb

    dev = torch.device("cuda")
    where = card()
    print(where, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)

    lib = build.library_path()
    if lib.exists():
        lib.unlink()   # prove the sources in this checkout build
    t0 = time.time()
    build.library()
    print(f"build: {time.time() - t0:.1f} s ({lib.name})", flush=True)

    errs, ms = phase_kernels(fb, dev, where)
    launches = phase_fit(build, dev, where)
    phase_reference(dev)
    phase_cli(build, where)

    record = {"kernels": [
        {"name": f"fullstep_bi_{name}", "route": "cuda", "source": SOURCE,
         "replaces": TPU_KERNEL,
         "launches": launches[f"mc_fullstep_bi_{name}"],
         "max_abs_err": errs[name], "ms": ms[name][0],
         "plain_ms": ms[name][1]} for name in ("rows", "cols")]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
