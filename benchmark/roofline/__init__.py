"""The least time the card needs for a model's EM work, one file a model
and allele layout (``<model>_<bi|generic>.py``), each with
``least_seconds(config, K, chain_iters, chains, peaks) -> (seconds,
bound)``:
counted from the panel's shape, the true K and the useful chain-iterations,
the same whatever kernels ran."""
