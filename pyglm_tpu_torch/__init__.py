"""pyglm_tpu_torch: the network GLM of pyglm_tpu on PyTorch and CUDA.

A second implementation of the JAX package ``pyglm_tpu`` for one NVIDIA
H100. The JAX package stays the reference; this package mirrors its module
names and is tested against it. Every Pallas TPU kernel on the ported path
is a CUDA C++ kernel written for Hopper (``csrc/``), built with nvcc at
first use and bound with ctypes; each has a plain PyTorch version beside
it, which tensors on the CPU take.

This slice runs the spike-and-slab Bernoulli GLM with an Erdos-Renyi prior:

    m = SparseBernoulliGLM(N, B=4, L=10, seed=0, device="cuda")
    m.add_data(Y)
    m.fit(n_samples=100, n_burnin=50)
"""

__version__ = "0.1.0"

from pyglm_tpu_torch.ops.basis import cosine_basis, convolve_with_basis
from pyglm_tpu_torch.ops.polyagamma import pg_draw_unit, pg_mean, pg_var
from pyglm_tpu_torch.models.glm import (
    GLM, NonlinearAutoregressiveModel, SparseBernoulliGLM,
)

__all__ = [
    "cosine_basis",
    "convolve_with_basis",
    "pg_draw_unit",
    "pg_mean",
    "pg_var",
    "NonlinearAutoregressiveModel",
    "GLM",
    "SparseBernoulliGLM",
]
