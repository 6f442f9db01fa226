"""The share of its roofline of K2's Gram kernel (work/k2_gram.py): the
wgmma 3xTF32 body at "high", the bf16 one at "default" and "sr". Its
split-T partial sums are reduced by copy_reduce's reduce_splits_kernel,
which K2's pass and K6 share and which is not counted here."""
from gibbsbench.metrics import roofline

KERNELS = ("group_pass_tf32_kernel", "group_pass_wgmma_kernel")


def read(run):
    return roofline(run, "k2_gram", KERNELS)
