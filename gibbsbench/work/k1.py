"""K1, PG(1, psi) by Devroye's exact sampler (csrc/pg_devroye.cu): one
launch over the (T, lanes) auxiliaries when every shape is 1. psi in and
omega out, float32; the sampler's arithmetic is not multiply-adds and is
not counted, so the bytes bound it."""


def launches(s):
    if s.get("betas") is not None:
        return []
    return [(0.0, 8.0 * s["T"] * s["lanes"])]
