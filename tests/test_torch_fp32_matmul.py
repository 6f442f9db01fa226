"""The port pins its float32 GEMMs to full float32 (utils.fp32_matmul), on
the CPU.

PyTorch reads one process-wide flag for cuBLAS's float32 matmuls; a caller
who turns TF32 on (``allow_tf32``, ``set_float32_matmul_precision`` or the
per-backend ``fp32_precision``) would make the port's "high" and "highest"
GEMMs TF32. The JAX package pins each GEMM per call. The helper switches
TF32 off inside the sweep, the log-likelihood and generation, and restores
the caller's setting on exit, also after an exception. The card test that
the update is unchanged under TF32 is in tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

from pyglm_tpu_torch import NonlinearAutoregressiveModel, SparseBernoulliGLM
from pyglm_tpu_torch.utils.utils import fp32_matmul

torch.set_num_threads(1)
MATMUL = torch.backends.cuda.matmul


def _tf32_on() -> bool:
    if hasattr(MATMUL, "fp32_precision"):
        return MATMUL.fp32_precision == "tf32"
    return MATMUL.allow_tf32


def _state():
    """The caller-visible flags, each as its getter reads it."""
    try:
        legacy = torch.get_float32_matmul_precision()
    except RuntimeError:
        legacy = "mixed"
    return getattr(MATMUL, "fp32_precision", None), legacy


def _set_allow_tf32():
    MATMUL.allow_tf32 = True


def _set_precision_high():
    torch.set_float32_matmul_precision("high")


def _set_precision_medium():
    torch.set_float32_matmul_precision("medium")


def _set_fp32_precision():
    if not hasattr(MATMUL, "fp32_precision"):
        pytest.skip("this torch has no matmul.fp32_precision")
    MATMUL.fp32_precision = "tf32"


TF32_ON = {"allow_tf32": _set_allow_tf32, "precision_high": _set_precision_high,
           "precision_medium": _set_precision_medium,
           "fp32_precision": _set_fp32_precision}


@pytest.fixture(params=sorted(TF32_ON))
def tf32(request):
    """TF32 switched on through one of the APIs; full float32 afterwards."""
    TF32_ON[request.param]()
    assert _tf32_on()
    yield _state()
    torch.set_float32_matmul_precision("highest")


def test_helper_pins_and_restores(tf32):
    with fp32_matmul():
        assert not _tf32_on()
        with fp32_matmul():            # nested entry restores the outer one
            assert not _tf32_on()
        assert not _tf32_on()
    assert _state() == tf32 and _tf32_on()


def test_helper_restores_after_a_raise(tf32):
    with pytest.raises(KeyError):
        with fp32_matmul():
            assert not _tf32_on()
            raise KeyError("inside")
    assert _state() == tf32 and _tf32_on()


def test_helper_leaves_full_fp32_alone():
    torch.set_float32_matmul_precision("highest")
    before = _state()
    with fp32_matmul():
        assert not _tf32_on()
    assert _state() == before


def _watch(monkeypatch, obs, seen):
    """Wrap a family's omega_kappa (called inside every sweep, after the
    psi GEMM) to record whether TF32 was on there."""
    inner = type(obs).omega_kappa

    def omega_kappa(self, *args, **kw):
        seen.append(_tf32_on())
        return inner(self, *args, **kw)
    monkeypatch.setattr(type(obs), "omega_kappa", omega_kappa)


def test_cpu_sweep_runs_fp32_and_leaves_the_flags(tf32, monkeypatch):
    """Under TF32-on flags, a CPU model's sweep (fused loop), its
    log-likelihood, generation and a lane-stacked ensemble (staged loop)
    run with TF32 off inside and leave the flags as they found them."""
    truth = SparseBernoulliGLM(8, seed=1, device="cpu")
    Y = truth.generate(400, keep=False)
    assert _state() == tf32
    m = SparseBernoulliGLM(8, seed=2, group=4, device="cpu")
    m.add_data(Y)
    seen = []
    _watch(monkeypatch, m.observation, seen)
    m.resample_model()
    assert np.isfinite(m.log_likelihood())
    ens = m.fit_ensemble(n_chains=2, n_samples=4, collect="mean")
    assert np.isfinite(ens["lls"]).all()
    assert seen and not any(seen)
    assert _state() == tf32 and _tf32_on()


def test_cpu_sweep_same_under_tf32_flags(tf32):
    """On the CPU the flags change no product, so a sweep under them
    equals the sweep under full float32, sample for sample."""
    kw = dict(observation="bernoulli", network="erdos_renyi",
              spike_and_slab=True, group=4, device="cpu")
    Y = SparseBernoulliGLM(8, seed=1, device="cpu").generate(400, keep=False)
    outs = []
    for flags in (tf32, None):
        if flags is None:
            torch.set_float32_matmul_precision("highest")
        m = NonlinearAutoregressiveModel(8, seed=3, **kw)
        m.add_data(Y)
        m.resample_model()
        outs.append((m.A, m.W))
    assert np.array_equal(outs[0][0], outs[1][0])
    assert np.array_equal(outs[0][1], outs[1][1])
