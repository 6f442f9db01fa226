"""K4, PG(b, psi) by the gamma series (csrc/pg_gamma.cu): one launch over
the (T, lanes) auxiliaries of a tempered step, b = beta of the lane's
rung. psi in and omega out per element, beta once a lane, float32; bound
by its bytes."""


def launches(s):
    if s.get("betas") is None:
        return []
    return [(0.0, 8.0 * s["T"] * s["lanes"] + 4.0 * s["lanes"])]
