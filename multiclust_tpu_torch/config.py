"""Run configuration (the port's own copy of multiclust_tpu/config.py).

Mirrors the reference's ~60-field ``options`` struct (multiclust.h:155-215)
with the same defaults (multiclust.c:902-978), expressed as a frozen
dataclass.  Fields that only made sense for the C build (memory-allocation
behavior, OLDWAY toggles) are omitted; the fields without a reference
counterpart are added at the bottom and documented as such.  The field
names and defaults are those of the JAX package, so one command line means
the same in both.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


MISSING = -9  # sentinel for missing alleles (multiclust.h:140)


class AccelScheme(enum.IntEnum):
    """Acceleration schemes (multiclust.h:125-131).

    Command-line ``-s 4,5,6`` map to QN with q=1,2,3 secants
    (synchronize, multiclust.c:818-853).
    """

    NONE = 0
    SQS1 = 1  # SQUAREM v1: s = u.u / u.(v-u)
    SQS2 = 2  # SQUAREM v2: s = u.(v-u) / |v-u|^2
    SQS3 = 3  # SQUAREM v3: s = -sqrt(u.u / |v-u|^2)
    QN = 4    # quasi-Newton (q secant conditions)


class InitMethod(enum.IntEnum):
    """Initialization methods (multiclust.h:99-103)."""

    RANDOM_PARTITION = 0
    RANDOM_CENTERS = 1
    TESTING = 2


class InitProcedure(enum.IntEnum):
    """Initialization procedures (multiclust.h:108-111)."""

    NOTHING = 0
    RAND_EM = 1


class OutputFormat(enum.IntEnum):
    """Data-file output formats (multiclust.h:136-138)."""

    STRUCTURE = 0
    PED = 1


ACCEL_ABBREVIATIONS = {
    AccelScheme.NONE: "EM",
    AccelScheme.SQS1: "S1",
    AccelScheme.SQS2: "S2",
    AccelScheme.SQS3: "S3",
    AccelScheme.QN: "Q",
}

ACCEL_NAMES = {
    AccelScheme.NONE: "No acceleration",
    AccelScheme.SQS1: "SQUAREM version 1",
    AccelScheme.SQS2: "SQUAREM version 2",
    AccelScheme.SQS3: "SQUAREM version 3",
    AccelScheme.QN: "Quasi Newton",
}


@dataclasses.dataclass
class Options:
    """Run options; defaults match ``make_options`` (multiclust.c:902-978)."""

    # --- model choice ---
    admixture: bool = False           # -a
    eta_constrained: bool = False     # -c: one eta vector shared by all i

    # --- K sweep ---
    min_K: int = 6                    # -1 (default tests K=6, multiclust.c:930)
    max_K: int = 6                    # -2 / -k

    # --- initialization ---
    initialization_method: InitMethod = InitMethod.RANDOM_CENTERS
    initialization_procedure: InitProcedure = InitProcedure.NOTHING
    n_init: int = 50                  # -n
    n_rand_em_init: int = 50          # -m
    seed: int = 1234567               # -r

    # --- convergence (Lange's definition, multiclust.c:924-927) ---
    max_iter: int = 0                 # -C/-T; 0 = unlimited
    rel_error: float = 0.0            # -e
    abs_error: float = 1e-4           # -E
    n_seconds: float = 0.0            # -t (stored in seconds)

    # --- stop regimes of maximize_likelihood ---
    target_ll: bool = False           # -u l
    desired_ll: float = 0.0
    target_revisit: int = 0           # -u n

    # --- acceleration ---
    accel_scheme: AccelScheme = AccelScheme.NONE   # -s
    q: int = 1                        # number of secant conditions (QN)
    n_init_iter: int = 0              # -i: plain EM warmup steps
    adjust_step: int = 0              # -g: max backtracking attempts

    # --- numerical bounds ---
    lower_bound: float = 1e-8         # --bound; synchronized vs data later
    eta_lower_bound: float = 1e-8
    p_lower_bound: float = 1e-8
    do_projection: bool = True        # --projection turns OFF

    # --- data interpretation ---
    ploidy: int = 2                   # -p
    missing_value: int = MISSING      # --missing
    R_format: bool = False            # -R
    interleaved: bool = False         # autodetected from file
    alleles_are_indices: bool = False # -I
    one_plus: bool = False            # -I1
    imputation_method: int = 0        # --impute
    imputed_outfile: Optional[str] = None

    # --- bootstrap ---
    n_bootstrap: int = 0              # -b

    # --- I/O ---
    filename: Optional[str] = None    # -f
    path: str = "./"                  # -d
    outfile_name: Optional[str] = None  # -o
    output_format: OutputFormat = OutputFormat.STRUCTURE  # --format
    write_plus_one: bool = False      # --plus
    write_files: bool = True
    qfile: Optional[str] = None       # -Q warm-start eta
    pfile: Optional[str] = None       # -P warm-start p
    afile: Optional[str] = None       # -A true partition for adjusted Rand

    # --- simulation ---
    simulate: bool = False            # --simulate
    admix_qfile: Optional[str] = None
    admix_pfile: Optional[str] = None
    simulate_outfile: str = "sim.stru"

    # --- repeat-timing harness (-w) ---
    n_repeat: int = 1
    repeat_seconds: float = 0.0
    max_repeat_seconds: float = 0.0

    # --- reporting ---
    # message.h:45-53 levels: 0 ABSOLUTE_SILENCE, 1 SILENT, 2 QUIET,
    # 3 MINIMAL (the reference default, multiclust.c:954), 4 RESTRAINED,
    # 5 TALKATIVE, 6 VERBOSE, 7 DEBUG.  Per-init progress prints at
    # > QUIET (multiclust.c:618), per-iteration traces at > MINIMAL
    # (em_alg.c:123).
    verbosity: int = 3                # MINIMAL
    compact: bool = True
    parallel: bool = False            # -M: print only max logL on stdout

    # --- additions (no reference counterpart) ---
    dtype: str = "float32"            # compute dtype for E/M tensors
    batch_chains: int = 0             # 0 = auto: chains run in lockstep
    use_pallas: Optional[bool] = None  # the hand-written kernels; None =
                                      # auto (on for float32 fits on CUDA;
                                      # runtime/multistart.device_policy)
    mesh_shape: Optional[tuple] = None  # (data_shards, loci_shards)
    checkpoint_dir: Optional[str] = None  # --checkpoint: sweep persistence
    # --compile-cache: accepted for command-line compatibility with the
    # JAX package and unused (PyTorch runs eagerly; the kernels' build is
    # cached by ops/build.py)
    compile_cache: Optional[str] = None
    # --check-interval N: evaluate the log likelihood (and hence the
    # convergence/monotonicity checks of stop(), em_alg.c:101-143) only
    # every N-th plain-EM iteration; the N-1 iterations between checks run
    # a logL-free kernel.  DEVIATION from the reference, which checks every
    # iteration - but EM is monotone over any number of steps, so interval
    # checking can only stop LATER (never prematurely) and converges to the
    # same optimum; the iteration cap (-T) gains granularity N.
    # 0 (the default) = ADAPTIVE: the engine escalates the interval
    # (1 -> 2 -> ... -> 16) while the per-iteration logL delta is far
    # above tolerance and resets to 1 near convergence
    # (opt/em.plain_macro_step), so the stop iteration matches
    # per-iteration checking while the bulk of the fit skips the logL.
    # Forced to 1 under acceleration (-s: the guarded accept needs logL
    # every macro step) and at verbosity > MINIMAL (the per-iteration
    # trace contract) - see synchronize.
    check_interval: int = 0
    monotonicity: str = "auto"        # "fatal" (reference, em_alg.c:115-120),
                                      # "warn", "off", or "auto": fatal on
                                      # float64 (reference semantics are
                                      # exactly representable there), warn
                                      # on f32 where accept/backtrack fp
                                      # chaos needs slack

    def resolved_monotonicity(self) -> str:
        if self.monotonicity == "auto":
            return "fatal" if self.dtype == "float64" else "warn"
        return self.monotonicity

    def synchronize(self, n_individuals: int, ploidy: int) -> "Options":
        """Derive data-dependent bounds and resolve the acceleration scheme.

        Mirrors ``synchronize`` (multiclust.c:807-893):
        ``lower_bound = min(bound, 1/(I*P) - 0.5/(I*P))`` and ``-s >= 4``
        resolves to QN with ``q = scheme - SQS3``; QN disables backtracking.
        """
        out = dataclasses.replace(self)
        # pin the DATA-derived ploidy: the biallelic mixture fast path
        # folds x1 = ploidy - x0 into per-cluster constants
        # (model/mixture._scores_bi), so a stale default here would
        # silently corrupt non-diploid fits driven through the API
        out.ploidy = ploidy
        out.lower_bound = min(
            self.lower_bound,
            1.0 / n_individuals / ploidy - 0.5 / n_individuals / ploidy,
        )
        out.eta_lower_bound = out.lower_bound
        out.p_lower_bound = out.lower_bound
        scheme = int(self.accel_scheme)
        if scheme >= int(AccelScheme.QN):
            out.adjust_step = 0
            out.q = scheme - int(AccelScheme.SQS3)
            out.accel_scheme = AccelScheme.QN
        if (not out.target_ll and not out.target_revisit
                and not out.n_seconds and not out.n_init):
            out.n_init = 1
        out.check_interval = max(0, out.check_interval)
        if out.verbosity > 3:
            # per-iteration trace contract (em_alg.c:123-136) requires a
            # logL at every step
            out.check_interval = 1
        if out.accel_scheme != AccelScheme.NONE:
            # the guarded accept evaluates logL every macro step anyway;
            # pin the interval so the stale value cannot leak into a
            # future accelerated path
            out.check_interval = 1
        if out.min_K > out.max_K:
            raise ValueError(
                f"Minimum K ({out.min_K}) must not exceed maximum K "
                f"({out.max_K}).")
        if n_individuals < out.max_K:
            raise ValueError(
                f"Maximum number of clusters ({out.max_K}) cannot exceed "
                f"the number of individuals ({n_individuals})")
        if out.n_bootstrap and out.max_K <= 1:
            raise ValueError("When bootstrapping, maximum K must exceed 1.")
        return out

    @property
    def accel_abbreviation(self) -> str:
        if self.accel_scheme == AccelScheme.QN:
            return f"Q{self.q}"
        return ACCEL_ABBREVIATIONS[self.accel_scheme]

    @property
    def accel_name(self) -> str:
        if self.accel_scheme == AccelScheme.QN:
            return f"{ACCEL_NAMES[AccelScheme.QN]} (q={self.q})"
        return ACCEL_NAMES[self.accel_scheme]
