"""What the compiler made of the port's contraction kernels: the
biallelic admixture ones (csrc/fullstep_bi.cu), the generic rows and
columns passes (csrc/fullstep.cu), the biallelic mixture rows and
columns passes (csrc/mixture_bi.cu, one and two streams) and the wide
kernels of the admixture step for 128 < Kp <= 1024 (csrc/wide.cuh: the
rows pass's A launch and the columns pass's B launch with the biallelic
and the generic cells, the d launch both take, the finish at 8, 16 and
32 lanes a thread, each built once for every Kp in its range)
and of the mixture step (csrc/mixture_bi.cu: the rows pass's scores and
softmax, the columns pass, one and two streams, and the finish at 8, 16
and 32 lanes a thread): registers, shared memory and spills (``nvcc
-Xptxas -v``),
and the static instruction mix of each kernel's machine code
(``cuobjdump -sass``: FFMA against LDS, MUFU and the rest; DMMA, the
float64 tensor-core product, counted on a line of its own for the mixture
passes and the wide kernels).

Run with ``python -m multiclust_tpu_torch.kernel_report [Kp ...]`` where
nvcc and a CUDA toolkit are installed (default Kp: 32 and 128).  The mix counts
every instruction of a kernel once, the byte-load path and the prologue
included; the loops over a tile are fully unrolled, so the counts of FFMA,
MUFU and LDS are those of one tile plus that fringe.
"""

from __future__ import annotations

import collections
import re
import shutil
import subprocess
import sys
from pathlib import Path

from multiclust_tpu_torch.ops import build

# (kernel, mangled template arguments after Kp): the mixture passes take
# a bool for their second stream
KERNELS = (("fullstep_bi_rows_kernel", ""),
           ("fullstep_bi_rows_seg_kernel", ""),
           ("fullstep_bi_cols_kernel", ""), ("fullstep_rows_kernel", ""),
           ("fullstep_cols_kernel", ""), ("mix_rows_kernel", "Lb0E"),
           ("mix_rows_kernel", "Lb1E"), ("mix_cols_kernel", "Lb0E"),
           ("mix_cols_kernel", "Lb1E"))
# the contraction kernels' names in the -Xptxas -v report
CONTRACTIONS = "fullstep_(?:bi_)?(?:rows|cols)|mix_(?:rows|cols)"
# the wide kernels (csrc/wide.cuh), and their instantiations: the cells
# (a Cells value) or the finish's lanes a thread
WIDE = "wide_(?:rows_a|cols_d|cols_b|finish)_kernel"
CELLS = ("kBi", "kDense", "kSparse")
WIDE_KERNELS = (("wide_rows_a_kernel", "kBi"),
                ("wide_rows_a_kernel", "kDense"),
                ("wide_cols_d_kernel", None),
                ("wide_cols_b_kernel", "kBi"),
                ("wide_cols_b_kernel", "kDense"),
                ("wide_finish_kernel", 8), ("wide_finish_kernel", 16),
                ("wide_finish_kernel", 32))
# the mixture's wide kernels (csrc/mixture_bi.cu), and their mangled
# template arguments: the contraction passes' second stream, the
# softmax's score pairs a lane, the finish's eta slots a lane (the
# pattern names the narrow finishes too)
MIX_WIDE = "mix_(?:rows_wide|cols_wide|softmax|finish)_kernel"
MIX_WIDE_KERNELS = (("mix_rows_wide_kernel", "ILb0E"),
                    ("mix_rows_wide_kernel", "ILb1E"),
                    ("mix_cols_wide_kernel", "ILb0E"),
                    ("mix_cols_wide_kernel", "ILb1E"),
                    ("mix_softmax_kernel", "ILi4E"),
                    ("mix_softmax_kernel", "ILi16E"),
                    ("mix_finish_kernel", "ILi8E"),
                    ("mix_finish_kernel", "ILi32E"))


def ptxas_lines(report: str, pattern: str = "fullstep_bi"):
    """(kernel, 'Used ... registers ...; n bytes spill ...') pairs of the
    -Xptxas -v report for the kernels whose name starts with ``pattern``
    (a regular expression).  The mangled name carries each identifier's
    length before it (and, for a kernel in an unnamed namespace, the
    source file's name before that), which is how the kernel's own name
    is told from the file's."""
    lines = report.splitlines()
    out = []
    for i, line in enumerate(lines):
        if "Function properties for " not in line or i + 2 >= len(lines):
            continue
        mangled = line.split("Function properties for ")[1]
        name = None
        for m in re.finditer(pattern, mangled):
            digits = re.search(r"\d+$", mangled[:m.start()])
            for k in range(1, len(digits.group()) + 1 if digits else 1):
                n = int(digits.group()[-k:])
                ident = mangled[m.start():m.start() + n]
                if n == len(ident) and ident.endswith("kernel"):
                    rest = mangled[m.start() + n:]
                    targ = re.match(r"ILi(\d+)E(?:Lb([01])E|Li(\d+)E)?",
                                    rest)
                    cells = re.match(r"ILN\w*?CellsE(\d)E", rest)
                    flag = re.match(r"ILb([01])E", rest)
                    if cells:   # a Cells value, the wide passes' argument
                        name = ident + f"<{CELLS[int(cells.group(1))]}>"
                    elif flag:   # a bool alone: the second stream
                        name = ident + ("<true>" if flag.group(1) == "1"
                                        else "<false>")
                    elif targ and targ.group(2):
                        two = "true" if targ.group(2) == "1" else "false"
                        name = ident + f"<{targ.group(1)}, {two}>"
                    elif targ and targ.group(3):
                        name = ident + f"<{targ.group(1)}, {targ.group(3)}>"
                    else:
                        name = ident + (f"<{targ.group(1)}>" if targ else "")
                    break
            if name:
                break
        if name:
            used = lines[i + 2].replace("ptxas info    : ", "").strip()
            out.append((name, f"{used}; {lines[i + 1].strip()}"))
    return out


def sass_mix(lib: Path, kernel: str, kp, targs: str = ""):
    """Opcode counts of one kernel's SASS (``targs``: its mangled template
    arguments after Kp; ``kp`` a name of CELLS: the wide passes' cells;
    ``kp`` None: ``targs`` are all of its mangled template arguments, or
    "E" for none)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    if kp is None:
        tag = re.compile(rf"{len(kernel)}{kernel}{targs}")
    elif kp in CELLS:
        tag = re.compile(rf"{len(kernel)}{kernel}ILN\w*?CellsE"
                         rf"{CELLS.index(kp)}E")
    else:
        tag = re.compile(rf"{len(kernel)}{kernel}ILi{kp}E{targs}")
    counts = collections.Counter()
    inside = False
    for line in text.splitlines():
        if "Function :" in line:
            inside = tag.search(line) is not None
        elif inside:
            m = re.match(r"\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\d\s+)?([A-Z0-9_]+)",
                         line)
            if m:
                counts[m.group(1)] += 1
    return counts


def main(argv) -> int:
    kps = [int(a) for a in argv] or [32, 128]
    lib = build.build()
    report = lib.with_suffix(".ptxas.txt").read_text()
    for name, text in ptxas_lines(report, CONTRACTIONS):
        print(f"ptxas {name}: {text}", flush=True)
    for name, text in ptxas_lines(report, WIDE):
        print(f"ptxas {name}: {text}", flush=True)
    for name, text in ptxas_lines(report, MIX_WIDE):
        print(f"ptxas {name}: {text}", flush=True)
    for kernel, arg in WIDE_KERNELS:
        mix = sass_mix(lib, kernel, arg, "E" if arg is None else "")
        top = ", ".join(f"{op} {n}" for op, n in mix.most_common(14))
        label = kernel if arg is None else f"{kernel}<{arg}>"
        print(f"sass {label}: {sum(mix.values())} instructions: {top}; "
              f"DMMA {mix['DMMA']}", flush=True)
    for kernel, targs in MIX_WIDE_KERNELS:
        mix = sass_mix(lib, kernel, None, targs)
        top = ", ".join(f"{op} {n}" for op, n in mix.most_common(14))
        print(f"sass {kernel} {targs}: {sum(mix.values())} instructions: "
              f"{top}; DMMA {mix['DMMA']}", flush=True)
    for kp in kps:
        for kernel, targs in KERNELS:
            mix = sass_mix(lib, kernel, kp, targs)
            total = sum(mix.values())
            top = ", ".join(f"{op} {n}" for op, n in mix.most_common(14))
            two = ", two streams" if targs == "Lb1E" else ""
            label = f"{kernel}<{kp}{two}>"
            print(f"sass {label}: {total} instructions: {top}", flush=True)
            if kernel.startswith("mix_"):
                print(f"sass {label}: DMMA {mix['DMMA']}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
