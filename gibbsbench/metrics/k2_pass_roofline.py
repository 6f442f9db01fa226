"""The share of its roofline of K2's streaming pass (work/k2_pass.py),
every form of it: the first group's, the middle groups', the last
scatter."""
from gibbsbench.metrics import roofline

KERNELS = ("stream_pass_kernel",)


def read(run):
    return roofline(run, "k2_pass", KERNELS)
