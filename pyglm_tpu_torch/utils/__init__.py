from pyglm_tpu_torch.utils.utils import (  # noqa: F401
    logistic, logit, expand_scalar, expand_cov,
)
