"""The least time of the admixture model's EM steps on a biallelic panel.

Per chain-iteration, at the true K, on I x L cells of two alleles, counting
what the step needs and not what a kernel happens to do:

- operations: for each cell, the fitted frequency d0 = eta_i . p0_l (K
  multiply-adds: 2K; d1 = 1 - d0), the two ratios w_a = x_a / d_a (2), the
  eta statistics sum_l (w0 - w1) p0_kl (2K) and the p statistics
  sum_i eta_ik w_a_il for both alleles (4K): 8K + 2; and where a genotype
  is missing, its share sum_i eta_ik miss_il (2K).  The logarithms of the
  log likelihood are not counted (the program skips them on the steps its
  check interval leaves blind).
- bytes: the allele-0 plane (int8; the other allele is the ploidy less
  it and the missing copies, which are few) read once per model step, a
  step serving ``chains`` chains in lockstep; eta and p read and written
  once per chain-iteration in float32.

Operations at the card's float32 rate outside the tensor cores, bytes at
its memory bandwidth; the least time is the larger of the two.
"""


def least_seconds(config: dict, K: int, chain_iters: float, chains: float,
                  peaks: dict):
    I, L = int(config["individuals"]), int(config["loci"])
    cells = I * L
    ops = chain_iters * cells * ((8 * K + 2)
                                 + 2 * K * float(config["missing_rate"]))
    nbytes = chain_iters * (cells / chains + 2 * 4 * (I * K + 2 * K * L))
    t_ops = ops / peaks["fp32_flops_per_s"]
    t_bytes = nbytes / peaks["hbm_bytes_per_s"]
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")
