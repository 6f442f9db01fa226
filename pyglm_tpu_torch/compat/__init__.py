from pyglm_tpu_torch.compat.pypolyagamma import (  # noqa: F401
    PyPolyaGamma, pgdrawv, pgdrawvpar,
)
