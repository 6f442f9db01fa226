"""K6's share of its roofline (work/k6.py), whichever body runs: 3xTF32
on wgmma ("high", "sr"), bf16 on wgmma ("default"), fp32 FMA
("highest")."""
from gibbsbench.metrics import roofline

KERNELS = ("group_gram_tf32_kernel", "group_gram_wgmma_kernel",
           "group_gram_kernel")


def read(run):
    return roofline(run, "k6", KERNELS)
