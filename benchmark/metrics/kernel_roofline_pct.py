"""The least time the card needs for the traced fits' useful EM
chain-iterations (``roofline/<model>_<alleles>.py``, at the true K), as a
share of the device time of every operation in the traced sub-window
(``torch.profiler``)."""


def read(run):
    if run.trace is None or not run.traced or not run.trace.kernel_s:
        return None
    iters = sum(f.n_iter_all for f in run.traced)
    chains = sum(f.batch_chains for f in run.traced) / len(run.traced)
    least, _ = run.roofline.least_seconds(
        run.config, int(run.traffic["K"]), iters, chains, run.peaks)
    return 100.0 * least / run.trace.kernel_s
