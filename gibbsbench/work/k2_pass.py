"""K2's streaming pass (csrc/ss_group_pass.cu, the fused loop): Ng + 1
launches a step. Launch 0 forms M0 = X_0 u and sum_t omega; launch g in
1..Ng-1 applies group g-1's change, u -= omega (X_{g-1}' dW), and forms
M0 = X_g u from the new u; launch Ng applies the last change alone. Each
product is 2 T lanes GB FLOPs; u is read and written once a launch, omega
and the design rows read once."""
from gibbsbench.work import groups, omega_bytes


def launches(s):
    if s["loop_kind"] != "fused":
        return []
    Ng, GB, _ = groups(s)
    T, n = s["T"], s["lanes"]
    om, x, u, gbn = omega_bytes(s) * T * n, 4.0 * GB * T, 4.0 * T * n, \
        4.0 * GB * n
    prod = 2.0 * T * n * GB
    first = (prod, x + om + u + gbn + 4.0 * n)
    middle = (2 * prod, 2 * x + om + 2 * u + 2 * gbn)
    last = (prod, x + om + 2 * u + gbn)
    return [first] + [middle] * (Ng - 1) + [last]
