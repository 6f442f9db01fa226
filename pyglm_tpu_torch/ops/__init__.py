from pyglm_tpu_torch.ops.basis import (  # noqa: F401
    cosine_basis, convolve_with_basis,
)
from pyglm_tpu_torch.ops.polyagamma import (  # noqa: F401
    polya_gamma, pg_devroye, pg_gamma_series, pg_normal_approx, pg_mean,
    pg_var,
)
