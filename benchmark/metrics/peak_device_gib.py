"""The card's peak allocated memory over the run up to the window's close
(``torch.cuda.max_memory_allocated``), panel included, in GiB: it decides
the largest panel a user can fit on one card."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
