"""The whole step's algorithmic work, for ``sweep_mfu``: psi = X w
(2 T P lanes), every group's packed Gram (2 T lanes npair Ng), and the
gather M0 = X_g u and the scatter X_g' dW of each group (2 T lanes GB
each, Ng times), whichever loop runs them; the small per-edge and network
arithmetic is left out. One entry: the step as a whole."""
from gibbsbench.work import groups


def launches(s):
    Ng, GB, npair = groups(s)
    T, n, P = s["T"], s["lanes"], s["N"] * s["B"] + 1
    flops = 2.0 * T * n * (P + npair * Ng + 2 * GB * Ng)
    return [(flops, 0.0)]
