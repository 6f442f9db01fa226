from pyglm_tpu_torch.diagnostics.geweke import (  # noqa: F401
    geweke_chain, ks_two_sample,
)
