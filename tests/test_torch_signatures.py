"""The port's parameters against the JAX package's, module by module.

For each public function and each public class's ``__init__`` and public
methods of ``pyglm_tpu`` (parsed with ``ast``; JAX is not imported), every
parameter must be a parameter of the port's twin (read with
``inspect.signature``): the same name, or a ``*args`` / ``**kwargs`` for
JAX's. The modules and names that ``test_torch_public_names`` leaves out
are left out here too.

JAX-only, in general (``GENERIC``): the PRNG key, which the port's
generators replace, and the trace-time mesh context. Each other parameter
without a twin is in ``ARG_EXCEPTIONS`` with the reason; an exception must
name a real JAX parameter that the port still lacks.
"""
from __future__ import annotations

import ast
import importlib
import inspect

import pytest

from test_torch_public_names import EXCEPTIONS, JAX_PKG, _module_paths, _twin

# Parameter names that are JAX-only wherever they appear: why.
GENERIC = {
    "key": "a JAX PRNG key; the port draws from torch.Generator objects "
           "(`generator`, `gens`, `seed`)",
    "rng": "a JAX PRNG key, as `key`",
    "mesh": "where the JAX function reads the trace-time mesh; the port "
            "passes a mesh to the calls that take one",
    "local": "marks a trace inside a shard_map body; each of the port's "
             "ranks is a process of its own",
}

# (module, function or Class.method, parameter): why the port lacks it.
ARG_EXCEPTIONS = {
    ("ops/polyagamma.py", "pg_devroye", "init"):
        "continues a partly finished Pallas fast pass, a TPU workaround; "
        "kernel K1 loops each element until it accepts",
    ("ops/polyagamma.py", "pg_draw_unit", "backend"):
        "picks the Pallas or the XLA sampler; the port picks by the "
        "tensor's device (K1 on a card, the plain version on the CPU) and "
        "has no XLA path",
    ("diagnostics/geweke.py", "geweke_chain", "with_xt"):
        "registers the transposed design with each dataset; the port's "
        "datasets always carry it (GLMData.Xt)",
    ("diagnostics/geweke.py", "geweke_chain", "seg_iters"):
        "segments a lax.scan of the chain into launches; the port's chain "
        "is a host loop",
    ("diagnostics/profiling.py", "PhaseTimer.phase", "result_ref"):
        "a result to block on before the clock stops; the port's phase "
        "synchronises the device itself",
    ("models/ensemble.py", "run_stacked_chains", "max_sweeps_per_launch"):
        "caps the sweeps one XLA launch folds in; the port launches each "
        "sweep from a host loop, so there is no launch to cap",
    ("models/regressions.py", "BernoulliRegression.__init__", "**kw"):
        "forwards to the base constructor; the port's class inherits that "
        "constructor, whose parameters name every keyword",
    ("models/weights.py", "group_gram_blocks", "Xf"):
        "the design; the kernels read it transposed, so the port takes Xt "
        "(P, T) in its place",
    ("models/weights.py", "group_gram_blocks", "t_chunk"):
        "chunks the XLA Gram's scan; the port's Gram is kernel K6, which "
        "splits T by its own plan (ops/gram_cuda.py)",
    ("models/weights.py", "resample_spike_slab_tspace", "Xf"):
        "the design; the port's loops read it transposed, as Xt",
    ("models/weights.py", "resample_spike_slab_tspace", "t_chunk"):
        "chunks the XLA Grams; the port's loops are kernels K2 + K3 or "
        "K6 + K3, each splitting T by its own plan",
    ("parallel/sharding.py", "glm_shardings", "state"):
        "builds jax.sharding objects for a state; the port's "
        "glm_shardings(mesh, T, n_lanes, L) gives a rank's rows and lanes "
        "for torch.distributed",
    ("parallel/sharding.py", "glm_shardings", "datas"):
        "as `state`: the port's layout needs only the shapes",
    ("parallel/sharding.py", "make_sharded_sweep", "sweep_fn"):
        "jits a given sweep with shardings; the port's "
        "make_sharded_sweep(model, mesh) builds the rank's sweep from the "
        "model",
    ("parallel/sharding.py", "make_sharded_sweep", "state"):
        "as `sweep_fn`: the port reads the state from the model",
    ("parallel/sharding.py", "make_sharded_sweep", "datas"):
        "as `sweep_fn`: the port reads the datasets from the model",
    ("parallel/sharding.py", "make_sharded_sweep", "return_raw"):
        "returns the sweep before jit as well; the port's sweep is never "
        "jitted",
}


def _params(fn: ast.FunctionDef) -> list[str]:
    """fn's parameter names, ``*name`` / ``**name`` for the variadic ones,
    without ``self`` and ``cls``."""
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append("*" + a.vararg.arg)
    if a.kwarg:
        names.append("**" + a.kwarg.arg)
    return [n for n in names if n not in ("self", "cls")]


def _is_property(fn: ast.FunctionDef) -> bool:
    return any(isinstance(d, ast.Name) and d.id == "property"
               or isinstance(d, ast.Attribute) and d.attr in ("setter",
                                                              "getter")
               for d in fn.decorator_list)


def jax_signatures(rel: str) -> dict[str, list[str]]:
    """{function or Class.method: parameters} of the public callables of
    JAX module `rel`, less the names of ``EXCEPTIONS``."""
    tree = ast.parse((JAX_PKG / rel).read_text(), filename=rel)
    out = {}
    for node in tree.body:
        name = getattr(node, "name", None)
        if name is None or name.startswith("_") or (rel, name) in EXCEPTIONS:
            continue
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef):
            for f in node.body:
                if (isinstance(f, ast.FunctionDef) and not _is_property(f)
                        and (f.name == "__init__"
                             or not f.name.startswith("_"))):
                    out[f"{node.name}.{f.name}"] = _params(f)
    return out


def _port_callable(module, qual: str):
    obj = module
    for part in qual.split("."):
        obj = getattr(obj, part)
    return obj


def _port_takes(sig: inspect.Signature, name: str) -> bool:
    kinds = {p.kind for p in sig.parameters.values()}
    if name.startswith("**"):
        return inspect.Parameter.VAR_KEYWORD in kinds
    if name.startswith("*"):
        return inspect.Parameter.VAR_POSITIONAL in kinds
    return name in sig.parameters


def _missing(rel: str) -> list[tuple[str, str]]:
    module = importlib.import_module(_twin(rel))
    missing = []
    for qual, params in jax_signatures(rel).items():
        sig = inspect.signature(_port_callable(module, qual))
        missing += [(qual, p) for p in params if not _port_takes(sig, p)]
    return missing


@pytest.mark.parametrize("rel", _module_paths())
def test_port_twin_takes_every_jax_parameter(rel):
    missing = [(q, p) for q, p in _missing(rel)
               if p not in GENERIC and (rel, q, p) not in ARG_EXCEPTIONS]
    assert not missing, f"{_twin(rel)} lacks {missing}"


def test_each_exception_names_a_jax_parameter_the_port_lacks():
    """An exception names a parameter of its JAX function, and stays one
    only while the port's twin lacks it."""
    rels = set(_module_paths())
    for (rel, qual, param), why in ARG_EXCEPTIONS.items():
        assert rel in rels and why, (rel, qual, param)
        assert param in jax_signatures(rel).get(qual, []), (rel, qual, param)
        assert (qual, param) in _missing(rel), \
            f"{_twin(rel)}.{qual} now takes {param}: drop it from " \
            f"ARG_EXCEPTIONS"


def test_the_signatures_cover_the_parameters_this_port_added():
    """The parameters the port took over from the JAX package for the
    gamma series, the dense statistics and the sweep factories are seen by
    the scan (a guard against a scan that reads nothing)."""
    want = {
        "ops/polyagamma.py": [("polya_gamma", "K"),
                              ("pg_gamma_series", "K")],
        "models/sweep.py": [("make_gibbs_sweep", "t_chunk"),
                            ("make_log_likelihood", "precision")],
        "models/weights.py": [("sufficient_stats", "t_chunk"),
                              ("sufficient_stats", "precision"),
                              ("diag_blocks", "t_chunk"),
                              ("diag_blocks", "precision")],
        "diagnostics/geweke.py": [("geweke_chain", "t_chunk")],
        "models/glm.py": [("NonlinearAutoregressiveModel.__init__",
                           "t_chunk")],
    }
    for rel, pairs in want.items():
        sigs = jax_signatures(rel)
        module = importlib.import_module(_twin(rel))
        for qual, param in pairs:
            assert param in sigs[qual], (rel, qual, param)
            assert param in inspect.signature(
                _port_callable(module, qual)).parameters, (rel, qual, param)
