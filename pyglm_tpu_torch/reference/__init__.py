from pyglm_tpu_torch.reference.numpy_ref import (  # noqa: F401
    NumpyGLMReference, numpy_pg_devroye,
)
