"""The least time of an admixture start's counts on a biallelic panel
(the program's ``mc.init.counts``: each window's labelled copies counted
into copies [I, K] and pc [K, L, 2]).

Per start, counting what the counts need and not what a kernel happens
to do: each allele copy's label, drawn as int64, read once (8 B a copy);
each genotype's allele-0 and missing counts, int8, read once (2 B a
genotype, the copies' slots following from them); and the counts, int32,
written once (I K + 2 K L).  No operation is counted: a copy is two adds.
Bytes at the card's memory bandwidth.
"""


def least_seconds(config: dict, K: int, starts: float, peaks: dict):
    I, L = int(config["individuals"]), int(config["loci"])
    P = int(config["ploidy"])
    M = int(config["alleles"])
    nbytes = starts * (8 * I * L * P + 2 * I * L + 4 * (I * K + K * L * M))
    return nbytes / peaks["hbm_bytes_per_s"], "bytes"
