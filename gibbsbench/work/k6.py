"""K6, every group's packed Gram in one launch (csrc/group_gram.cu, the
staged loop): 2 T lanes npair Ng FLOPs; the design's group rows and omega
in, the packed Grams out."""
from gibbsbench.work import groups, omega_bytes


def launches(s):
    if s["loop_kind"] != "staged":
        return []
    Ng, GB, npair = groups(s)
    T, n = s["T"], s["lanes"]
    return [(2.0 * T * n * npair * Ng,
             4.0 * Ng * GB * T + omega_bytes(s) * T * n
             + 4.0 * Ng * npair * n)]
