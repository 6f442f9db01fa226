"""K4's share of its roofline (work/k4.py)."""
from gibbsbench.metrics import roofline

KERNELS = ("pg_gamma_kernel",)


def read(run):
    return roofline(run, "k4", KERNELS)
