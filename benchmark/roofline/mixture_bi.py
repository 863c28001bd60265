"""The least time of the mixture model's EM steps on a biallelic panel.

Per chain-iteration, at the true K, on I x L cells of two alleles, counting
what the step needs and not what a kernel happens to do:

- operations: the scores s_ik = sum_l x0_il (log p0_kl - log p1_kl) plus
  the ploidy's share of log p1 (x1 = 2 - x0 where no copy is missing: K
  multiply-adds a cell, 2K) and the expected counts sum_i v_ik x0_il (2K;
  those of allele 1 follow from the posterior's sums): 4K a cell; and
  where a genotype is missing, its correction to both (4K).  The
  posterior's exponentials and the frequencies' logarithms (I x K and
  K x L) are not counted.
- bytes: the allele-0 plane (int8) read once per model step, a step
  serving ``chains`` chains; eta and p read and written once per
  chain-iteration in float32.

The passes run on the float64 tensor cores, whose rate is the float32
rate outside them (67 TFLOP/s); the least time is the larger of the two.
"""


def least_seconds(config: dict, K: int, chain_iters: float, chains: float,
                  peaks: dict):
    I, L = int(config["individuals"]), int(config["loci"])
    cells = I * L
    ops = chain_iters * cells * 4 * K * (1 + float(config["missing_rate"]))
    nbytes = chain_iters * (cells / chains + 2 * 4 * (K + 2 * K * L))
    t_ops = ops / peaks["fp64_tensor_flops_per_s"]
    t_bytes = nbytes / peaks["hbm_bytes_per_s"]
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")
