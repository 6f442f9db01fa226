"""K1's share of its roofline (work/k1.py)."""
from gibbsbench.metrics import roofline

KERNELS = ("pg_devroye_kernel",)


def read(run):
    return roofline(run, "k1", KERNELS)
