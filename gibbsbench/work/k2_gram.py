"""K2's packed group Gram (csrc/ss_group_pass.cu, the fused loop): per
group g < Ng, X_g' diag(omega_n) X_g for every lane, only the GB(GB+1)/2
packed entries: 2 T lanes npair FLOPs; X_g's rows and omega in, the packed
Gram out."""
from gibbsbench.work import groups, omega_bytes


def launches(s):
    if s["loop_kind"] != "fused":
        return []
    Ng, GB, npair = groups(s)
    T, n = s["T"], s["lanes"]
    return [(2.0 * T * n * npair,
             4.0 * GB * T + omega_bytes(s) * T * n + 4.0 * npair * n)] * Ng
