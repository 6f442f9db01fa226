"""pyglm_tpu_torch: the network GLM of pyglm_tpu on PyTorch and CUDA.

A second implementation of the JAX package ``pyglm_tpu`` for one NVIDIA
H100. The JAX package stays the reference; this package mirrors its module
names and is tested against it. Every Pallas TPU kernel on the ported path
is a CUDA C++ kernel written for Hopper (``csrc/``), built with nvcc at
first use and bound with ctypes; each has a plain PyTorch version beside
it, which tensors on the CPU take.

It runs the spike-and-slab GLMs with an Erdos-Renyi prior and Bernoulli,
Binomial or negative-binomial observations:

    m = SparseBernoulliGLM(N, B=4, L=10, seed=0, device="cuda")
    m.add_data(Y)
    m.fit(n_samples=100, n_burnin=50)

    m = SparseNegativeBinomialGLM(N, seed=0, obs_kwargs=dict(max_y=16),
                                  device="cuda")
"""

__version__ = "0.1.0"

from pyglm_tpu_torch.ops.basis import cosine_basis, convolve_with_basis
from pyglm_tpu_torch.ops.polyagamma import (
    pg_draw_unit, pg_mean, pg_var, polya_gamma,
)
from pyglm_tpu_torch.models.glm import (
    GLM, NonlinearAutoregressiveModel, SparseBernoulliGLM,
    SparseNegativeBinomialGLM,
)
from pyglm_tpu_torch.models.observations import Binomial, NegativeBinomial

__all__ = [
    "cosine_basis",
    "convolve_with_basis",
    "pg_draw_unit",
    "pg_mean",
    "pg_var",
    "polya_gamma",
    "NonlinearAutoregressiveModel",
    "GLM",
    "SparseBernoulliGLM",
    "SparseNegativeBinomialGLM",
    "Binomial",
    "NegativeBinomial",
]
