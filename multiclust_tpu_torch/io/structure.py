"""STRUCTURE-format reader.

Replicates the reference parser's behavior (read_file.c:38-300):

* line 1 is a header of locus names; with ``R_format`` the header has two
  extra columns (read_file.c:58-59);
* an optional second line starting with ``-1`` carries inter-marker distances
  and is skipped (read_file.c:70-82);
* layout is autodetected by comparing the names of the first two data rows
  (read_file.c:89-95): equal names mean "ploidy consecutive rows per
  individual" (non-interleaved), different names mean one row per individual
  with ploidy consecutive columns per locus (interleaved);
* each data row leads with two info columns (name, sampling locale); rows
  2..ploidy of a non-interleaved individual repeat them;
* ``one_plus`` shifts alleles (and the missing sentinel) down by one
  (read_file.c:224-225, :263-264); a user-supplied ``missing_value`` is then
  remapped to the canonical MISSING=-9 (change_missing_value,
  read_file.c:411-429).

Tokenizing/number parsing uses the native C++ reader (native/, loaded via
io/fastread.py) when available, with a transparent pure-Python fallback.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from multiclust_tpu_torch.config import MISSING, Options
from multiclust_tpu_torch.io.dataset import Dataset, from_haplotypes
from multiclust_tpu_torch.messages import Err, MulticlustError


class StructureFormatError(ValueError, MulticlustError):
    """Invalid STRUCTURE file; carries Err.FILE_FORMAT_ERROR so cli.main
    reports it through the message() taxonomy (message.h:28)."""

    def __init__(self, text: str):
        MulticlustError.__init__(self, Err.FILE_FORMAT_ERROR, text)


def _parse_tokens_python(path: str):
    """Pure-Python fallback matching the native reader's contract."""
    with open(path, "r") as fh:
        lines = [ln.split() for ln in fh if ln.strip()]
    if not lines:
        raise StructureFormatError(f"'{path}' is empty")
    header_cols = len(lines[0])
    body = lines[1:]
    skipped = False
    if body and body[0] and body[0][0] == "-1":
        body = body[1:]
        skipped = True
    if not body:
        raise StructureFormatError(f"'{path}' has no data rows")
    names = [row[0] for row in body]
    locales = [row[1] for row in body]
    widths = {len(row) - 2 for row in body}
    if len(widths) != 1:
        raise StructureFormatError(f"ragged data rows in '{path}'")
    try:
        data = np.array([[int(v) for v in row[2:]] for row in body],
                        dtype=np.int64)
    except ValueError as e:
        raise StructureFormatError(f"non-integer allele in '{path}': {e}")
    return header_cols, names, locales, data, skipped


def _parse_tokens(path: str, use_native: bool = True, row_range=None):
    import os
    if not os.path.isfile(path):
        # fopen failure is FILE_OPEN_ERROR in the taxonomy, distinct from
        # a parse failure (read_file.c:47-49)
        raise MulticlustError(Err.FILE_OPEN_ERROR, path)
    if use_native:
        try:
            from multiclust_tpu_torch.io import fastread
            if fastread.available():
                return fastread.parse_file(path, row_range=row_range)
        except (RuntimeError, MemoryError):
            pass
        except ValueError as e:
            raise StructureFormatError(f"'{path}': {e}")
    out = _parse_tokens_python(path)
    if row_range is not None:
        header_cols, names, locales, data, skipped = out
        lo, hi = row_range
        hi = len(names) if hi < 0 else min(hi, len(names))
        out = (header_cols, names[lo:hi], locales[lo:hi], data[lo:hi],
               skipped)
    return out


def scan_structure(path: str, use_native: bool = True):
    """Metadata pass: (n_data_rows, header_cols, name0, name1) without
    materializing numeric payloads (native streaming scan; the Python
    fallback parses fully - fine at fallback scale)."""
    import os
    if not os.path.isfile(path):
        raise MulticlustError(Err.FILE_OPEN_ERROR, path)
    if use_native:
        try:
            from multiclust_tpu_torch.io import fastread
            if fastread.available():
                n_rows, header_cols, _, n0, n1 = fastread.scan_file(path)
                return n_rows, header_cols, n0, n1
        except (RuntimeError, MemoryError):
            pass
        except ValueError as e:
            raise StructureFormatError(f"'{path}': {e}")
    header_cols, names, _, data, _ = _parse_tokens_python(path)
    return (len(names), header_cols,
            names[0] if names else "", names[1] if len(names) > 1 else "")


def read_structure_raw(
    path: str,
    ploidy: int = 2,
    R_format: bool = False,
    one_plus: bool = False,
    missing_value: int = MISSING,
    use_native: bool = True,
) -> Tuple[np.ndarray, List[str], np.ndarray, List[str]]:
    """Parse a STRUCTURE file into (IL, names, locales, pops).

    ``IL`` is the [I*ploidy, L] haplotype matrix with MISSING sentinels.
    """
    header_cols, row_names, row_locales, data, _ = _parse_tokens(
        path, use_native)
    L = header_cols - 2 if R_format else header_cols  # read_file.c:58-59
    n_rows, D = data.shape

    interleaved = n_rows < 2 or row_names[0] != row_names[1]

    if interleaved:
        if D != L and D != ploidy * L:
            raise StructureFormatError(
                f"number of columns ({L}) in '{path}' is not a multiple of "
                f"ploidy ({ploidy})")
        n_loci = L // ploidy if D == L else L
        if D != ploidy * n_loci:
            raise StructureFormatError(
                f"data columns ({D}) in '{path}' do not cover "
                f"{n_loci} loci x ploidy {ploidy}")
        I = n_rows
        # locus-major: ploidy consecutive values per locus
        IL = data.reshape(I, n_loci, ploidy).transpose(0, 2, 1) \
            .reshape(I * ploidy, n_loci)
        names = list(row_names)
        locale_strs = list(row_locales)
    else:
        if D != L:
            raise StructureFormatError(
                f"number of columns ({L}) in '{path}' does not match number "
                f"of alleles ({D}) given for first individual")
        if n_rows % ploidy:
            raise StructureFormatError(
                f"number of lines ({n_rows}) in '{path}' is not a "
                f"multiple of ploidy ({ploidy})")
        I = n_rows // ploidy
        IL = np.ascontiguousarray(data)
        names = row_names[::ploidy]
        locale_strs = row_locales[::ploidy]

    pops: List[str] = []
    pop_index = {}
    locales = np.empty(I, dtype=np.int64)
    for i, s in enumerate(locale_strs):
        if s not in pop_index:
            pop_index[s] = len(pops)
            pops.append(s)
        locales[i] = pop_index[s]

    if one_plus:
        IL = IL - 1
        missing_value -= 1
    if missing_value != MISSING:
        if (IL == MISSING).any():
            raise StructureFormatError(
                f"The default missing value ({MISSING}) is observed in the "
                f"input file, but the user has defined the missing value to "
                f"be {missing_value}.")
        IL = np.where(IL == missing_value, MISSING, IL)

    return IL, names, locales, pops


def read_structure_shard_raw(
    path: str,
    i_lo: int,
    i_hi: int,
    ploidy: int = 2,
    R_format: bool = False,
    one_plus: bool = False,
    missing_value: int = MISSING,
    use_native: bool = True,
) -> Tuple[np.ndarray, List[str], np.ndarray, List[str], int, int]:
    """Parse ONLY individuals [i_lo, i_hi) of a STRUCTURE file.

    The per-process ingestion primitive for multi-host runs (SURVEY.md
    section 2.3: replaces the reference's single-host whole-file read,
    read_file.c:38-300): a streaming metadata scan determines the global
    layout (row count + interleave autodetection from the first two row
    names, read_file.c:89-95), then only the shard's data rows are
    parsed and materialized - memory and parse time are O(shard), not
    O(file).  Returns (IL_shard [(i_hi-i_lo)*ploidy, L], names, locales,
    pops, I_total, L); locale indices are LOCAL to the shard.
    """
    n_rows, header_cols, name0, name1 = scan_structure(path, use_native)
    if n_rows == 0:
        raise StructureFormatError(f"'{path}' has no data rows")
    L = header_cols - 2 if R_format else header_cols
    interleaved = n_rows < 2 or name0 != name1

    if interleaved:
        I_total = n_rows
        row_range = (i_lo, i_hi)
    else:
        if n_rows % ploidy:
            raise StructureFormatError(
                f"number of lines ({n_rows}) in '{path}' is not a "
                f"multiple of ploidy ({ploidy})")
        I_total = n_rows // ploidy
        row_range = (i_lo * ploidy, i_hi * ploidy)
    if not (0 <= i_lo <= i_hi <= I_total):
        raise ValueError(f"shard [{i_lo}, {i_hi}) outside [0, {I_total})")

    _, row_names, row_locales, data, _ = _parse_tokens(
        path, use_native, row_range=row_range)
    n_shard = i_hi - i_lo
    D = data.shape[1] if data.size else (L if not interleaved else 0)

    if interleaved:
        if D != L and D != ploidy * L:
            raise StructureFormatError(
                f"number of columns ({L}) in '{path}' is not a multiple "
                f"of ploidy ({ploidy})")
        n_loci = L // ploidy if D == L else L
        IL = data.reshape(n_shard, n_loci, ploidy).transpose(0, 2, 1) \
            .reshape(n_shard * ploidy, n_loci)
        names = list(row_names)
        locale_strs = list(row_locales)
    else:
        if D != L:
            raise StructureFormatError(
                f"number of columns ({L}) in '{path}' does not match "
                f"number of alleles ({D}) given for first individual")
        IL = np.ascontiguousarray(data)
        names = row_names[::ploidy]
        locale_strs = row_locales[::ploidy]

    pops: List[str] = []
    pop_index = {}
    locales = np.empty(n_shard, dtype=np.int64)
    for i, s in enumerate(locale_strs):
        if s not in pop_index:
            pop_index[s] = len(pops)
            pops.append(s)
        locales[i] = pop_index[s]

    if one_plus:
        IL = IL - 1
        missing_value -= 1
    if missing_value != MISSING:
        if (IL == MISSING).any():
            raise StructureFormatError(
                f"The default missing value ({MISSING}) is observed in "
                f"the input file, but the user has defined the missing "
                f"value to be {missing_value}.")
        IL = np.where(IL == missing_value, MISSING, IL)

    return IL, names, locales, pops, I_total, IL.shape[1]


def local_label_summary(IL: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-locus sorted distinct observed allele labels of a shard.

    Returns (vocab [L, U] int64 padded with LABEL_PAD, sizes [L] int64)
    - the shard's contribution to the cross-process label-vocabulary
    union (runtime/ingest._global_label_vocab; replaces the single-host
    per-locus label collection of summarize_alleles,
    read_file.c:443-600, for sharded reads)."""
    IL = np.asarray(IL)
    L = IL.shape[1]
    locs = []
    for l in range(L):
        obs = IL[:, l]
        locs.append(np.unique(obs[obs != MISSING]))
    U = max((u.size for u in locs), default=0)
    vocab = np.full((L, max(U, 1)), LABEL_PAD, np.int64)
    sizes = np.zeros(L, np.int64)
    for l, u in enumerate(locs):
        vocab[l, :u.size] = u
        sizes[l] = u.size
    return vocab, sizes


#: padding sentinel for label-vocabulary tables; below any real label
#: (the reference's labels are ints parsed by strtol, read_file.c)
LABEL_PAD = np.int64(np.iinfo(np.int64).min)


def codes_from_labels(IL: np.ndarray, vocab: np.ndarray,
                      sizes: np.ndarray) -> np.ndarray:
    """Map labeled haplotypes onto GLOBAL per-locus slot indices.

    ``vocab``/``sizes`` come from the cross-process union
    (runtime/ingest._global_label_vocab): vocab[l, :sizes[l]] is the
    sorted global label list of locus l (the reference's L_alleles
    ordering, missing excluded - summarize_alleles read_file.c:443-600).
    MISSING positions stay MISSING."""
    IL = np.asarray(IL)
    codes = np.full_like(IL, MISSING)
    for l in range(IL.shape[1]):
        obs = IL[:, l] != MISSING
        if not obs.any():
            continue
        v = vocab[l, :sizes[l]]
        idx = np.searchsorted(v, IL[obs, l])
        # every observed label must be in the global union
        if (idx >= v.size).any() or (v[np.minimum(idx, v.size - 1)]
                                     != IL[obs, l]).any():
            raise StructureFormatError(
                f"allele label missing from the global vocabulary at "
                f"locus {l} (internal union error)")
        codes[obs, l] = idx
    return codes


def read_structure_shard(path: str, i_lo: int, i_hi: int,
                         opt: Optional[Options] = None,
                         label_vocab=None,
                         **kw) -> Tuple[Dataset, int]:
    """Read individuals [i_lo, i_hi) into a (Dataset, I_total) pair.

    Position-coded alleles (``-I``) need no coordination: per-shard slot
    indices agree globally (only the lane-count max is synced by the
    caller).  Label-coded panels (e.g. microsatellite fragment lengths)
    pass ``label_vocab=(vocab, sizes)`` - the GLOBAL per-locus sorted
    label table from the cross-process union
    (runtime/ingest._global_label_vocab) - and the shard's labels map
    through it; without a vocab a label-coded shard read is an error
    (the caller must run the union pre-pass first).
    """
    if opt is None:
        opt = Options(**{k: v for k, v in kw.items()
                         if k in Options.__dataclass_fields__})
    IL, names, locales, pops, I_total, _ = read_structure_shard_raw(
        path, i_lo, i_hi, ploidy=opt.ploidy, R_format=opt.R_format,
        one_plus=opt.one_plus, missing_value=opt.missing_value)
    if not opt.alleles_are_indices:
        if label_vocab is None:
            raise MulticlustError(
                Err.INVALID_CMD_OPTION,
                "label-coded sharded reading needs the global label "
                "vocabulary (runtime/ingest builds it with a "
                "cross-process union pre-pass)")
        vocab, sizes = label_vocab
        IL = codes_from_labels(IL, vocab, sizes)
    ds = from_haplotypes(
        IL, ploidy=opt.ploidy, alleles_are_indices=True,
        imputation_method=opt.imputation_method,
        names=names, locales=locales, pops=pops)
    if not opt.alleles_are_indices:
        vocab, sizes = label_vocab
        ds.L_alleles = [vocab[l, :sizes[l]] for l in range(vocab.shape[0])]
    return ds, I_total


def read_structure(path: str, opt: Optional[Options] = None,
                   **kw) -> Dataset:
    """Read a STRUCTURE file into a :class:`Dataset`."""
    if opt is None:
        opt = Options(**{k: v for k, v in kw.items()
                         if k in Options.__dataclass_fields__})
    IL, names, locales, pops = read_structure_raw(
        path, ploidy=opt.ploidy, R_format=opt.R_format,
        one_plus=opt.one_plus, missing_value=opt.missing_value)
    return from_haplotypes(
        IL, ploidy=opt.ploidy,
        alleles_are_indices=opt.alleles_are_indices,
        imputation_method=opt.imputation_method,
        names=names, locales=locales, pops=pops)
