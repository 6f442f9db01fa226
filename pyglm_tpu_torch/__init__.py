"""pyglm_tpu_torch: the network GLM of pyglm_tpu on PyTorch and CUDA.

A second implementation of the JAX package ``pyglm_tpu`` for one NVIDIA
H100. The JAX package stays the reference; this package mirrors its module
names and is tested against it. Every Pallas TPU kernel of the JAX package
has a CUDA C++ kernel written for Hopper here (``csrc/``), built with nvcc
at first use and bound with ctypes; each has a plain PyTorch version beside
it, which tensors on the CPU take.

It runs the network GLM with Bernoulli, Binomial, negative-binomial or
Gaussian observations, dense or spike-and-slab weights, and a dense,
Erdos-Renyi, stochastic-block or latent-distance prior, one chain or a
lane-stacked ensemble. Models live on the card unless ``device="cpu"`` is
passed:

    m = SparseBernoulliGLM(N, B=4, L=10, seed=0)
    m.add_data(Y)
    m.fit(n_samples=100, n_burnin=50)

    m = BernoulliGLM(N, seed=0)          # dense weights, the dense prior
    m = NonlinearAutoregressiveModel(N, network="sbm", spike_and_slab=True,
                                     net_kwargs=dict(K=5))

    m = SparseNegativeBinomialGLM(N, seed=0, obs_kwargs=dict(max_y=16))

    m = NonlinearAutoregressiveModel(N, spike_and_slab=True,
                                     network="latent_distance")
    m.add_data(Y)
    m.fit_ensemble(n_chains=8, n_samples=100, collect="mean")
    m.fit_tempered(n_samples=100, n_rungs=8)    # parallel tempering

On several ranks (``torchrun`` or ``parallel.sharding.spawn``; every rank
runs the same calls and gets the same results):

    m.shard(make_mesh(n_time=2, n_neuron=2))    # one model, 4 ranks
    m.fit_ensemble(n_chains=8, n_samples=100,
                   mesh=make_chain_mesh(4))     # chains over 4 ranks

Beside the network GLM: checkpoints (``utils.checkpoint``), profiling
(``diagnostics.profiling``), the standalone PG regressions
(``models.regressions``), the conjugate Gaussian and linear regressions
(``models.bayesian``), the stick-breaking transforms and the
``pypolyagamma`` API surface (``compat``).
"""

__version__ = "0.1.0"

from pyglm_tpu_torch.ops.basis import cosine_basis, convolve_with_basis
from pyglm_tpu_torch.ops.polyagamma import (
    pg_devroye, pg_draw_unit, pg_gamma_series, pg_mean, pg_var, polya_gamma,
)
from pyglm_tpu_torch.ops.stick_breaking import pi_to_psi, psi_to_pi
from pyglm_tpu_torch.models.glm import (
    GLM, BernoulliGLM, BinomialGLM, GaussianGLM, NegativeBinomialGLM,
    NonlinearAutoregressiveModel, SparseBernoulliGLM, SparseGaussianGLM,
    SparseNegativeBinomialGLM,
)
from pyglm_tpu_torch.models.observations import (
    Binomial, Gaussian, NegativeBinomial,
)
from pyglm_tpu_torch.models.regressions import (
    BernoulliRegression, BinomialRegression, MultinomialRegression,
    NegativeBinomialRegression,
)
from pyglm_tpu_torch.models.bayesian import DiagonalRegression, Regression
from pyglm_tpu_torch.models.tempering import suggest_ladder
from pyglm_tpu_torch.compat.pypolyagamma import (
    PyPolyaGamma, pgdrawv, pgdrawvpar,
)
from pyglm_tpu_torch.utils.checkpoint import load_state, save_state
from pyglm_tpu_torch.diagnostics.profiling import sweep_breakdown
from pyglm_tpu_torch.parallel import (
    glm_shardings, make_mesh, make_sharded_sweep, shard_model,
)
from pyglm_tpu_torch.parallel.sharding import (
    best_mesh_for, make_chain_data_mesh, make_chain_mesh,
)

__all__ = [
    "cosine_basis",
    "convolve_with_basis",
    "pg_devroye",
    "pg_gamma_series",
    "pg_draw_unit",
    "pg_mean",
    "pg_var",
    "polya_gamma",
    "NonlinearAutoregressiveModel",
    "GLM",
    "BernoulliGLM",
    "SparseBernoulliGLM",
    "GaussianGLM",
    "SparseGaussianGLM",
    "NegativeBinomialGLM",
    "SparseNegativeBinomialGLM",
    "BinomialGLM",
    "Binomial",
    "Gaussian",
    "NegativeBinomial",
    "psi_to_pi",
    "pi_to_psi",
    "BernoulliRegression",
    "BinomialRegression",
    "NegativeBinomialRegression",
    "MultinomialRegression",
    "Regression",
    "DiagonalRegression",
    "suggest_ladder",
    "PyPolyaGamma",
    "pgdrawv",
    "pgdrawvpar",
    "save_state",
    "load_state",
    "sweep_breakdown",
    "make_mesh",
    "glm_shardings",
    "shard_model",
    "make_sharded_sweep",
    "make_chain_mesh",
    "make_chain_data_mesh",
    "best_mesh_for",
]
