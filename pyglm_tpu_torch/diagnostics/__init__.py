"""Diagnostics. ``geweke_chain`` and ``ks_two_sample`` (from ``geweke``)
load on first use: the models import ``profiling``'s span recorder, and
``geweke`` imports the models."""


def __getattr__(name):
    if name in ("geweke_chain", "ks_two_sample"):
        from pyglm_tpu_torch.diagnostics import geweke
        return getattr(geweke, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
