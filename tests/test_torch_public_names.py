"""The port's public surface against the JAX package's, module by module.

Each module of ``pyglm_tpu`` is parsed with ``ast`` (JAX is not imported):
its public top-level names are the non-underscore ``def``s, ``class``es and
assigned names, and in an ``__init__.py`` also the names that its
``from ... import`` statements bring in. Each must be an attribute of the
port's twin module (``pyglm_tpu_torch`` at the same path), except the names
of ``EXCEPTIONS``, each with the reason it has no twin.

Left out: the three ``ops/*_pallas.py`` modules, whose counterparts are the
CUDA kernels of ``pyglm_tpu_torch/csrc`` and their wrappers in
``ops/*_cuda.py``, named by design after what they launch; and the compiled
``native/libpg.so``, which is no module.
"""
from __future__ import annotations

import ast
import importlib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "pyglm_tpu"
SKIPPED = {"ops/pg_pallas.py", "ops/ss_pallas.py", "ops/gram_pallas.py"}

# (module path relative to the package, name): why the port has no twin.
EXCEPTIONS = {
    ("parallel/sharding.py", "active_mesh"):
        "the mesh that the JAX call sites read at trace time to wrap their "
        "Pallas kernels in shard_map; the port passes its mesh to each call",
    ("parallel/sharding.py", "set_active_mesh"):
        "sets that trace-time mesh; the port has none to set",
    ("parallel/sharding.py", "local_spmd"):
        "marks the tracing of a shard_map body on single devices; the port "
        "traces nothing, and each of its ranks is a process of its own",
    ("parallel/sharding.py", "in_local_spmd"):
        "reads that trace-time marker; the port has none",
    ("ops/polyagamma.py", "LAST_GAMMA_PATH"):
        "records which JAX gamma-series path ran; the port counts its "
        "kernels' launches in ops._build.LAUNCHES",
    ("utils/utils.py", "PerformanceWarning"):
        "the JAX package's warning class for a slower path; the port never "
        "used it, and its one such warning (models.weights.mesh_ss_path) is "
        "a UserWarning",
}


def _module_paths():
    return sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py")
                  if str(p.relative_to(JAX_PKG)) not in SKIPPED)


def public_names(path: Path) -> set[str]:
    """The public top-level names that `path` defines or, in an
    ``__init__.py``, re-exports."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                names.update(n.id for n in ast.walk(target)
                             if isinstance(n, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.add(node.target.id)
        elif (isinstance(node, ast.ImportFrom) and path.name == "__init__.py"
              and node.module != "__future__"):
            names.update(a.asname or a.name for a in node.names)
    return {n for n in names if not n.startswith("_")}


def _twin(rel: str) -> str:
    parts = Path(rel).with_suffix("").parts
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(("pyglm_tpu_torch", *parts))


def test_the_jax_package_is_parsed_whole():
    """Every JAX module but the skipped ones is covered, and each exception
    names a public name of its module."""
    rels = _module_paths()
    assert len(rels) > 20 and "__init__.py" in rels
    assert SKIPPED <= {str(p.relative_to(JAX_PKG))
                       for p in JAX_PKG.rglob("*.py")}
    for rel, name in EXCEPTIONS:
        assert name in public_names(JAX_PKG / rel), (rel, name)


@pytest.mark.parametrize("rel", _module_paths())
def test_port_twin_has_every_public_name(rel):
    module = importlib.import_module(_twin(rel))
    want = public_names(JAX_PKG / rel)
    missing = sorted(n for n in want
                     if (rel, n) not in EXCEPTIONS and not hasattr(module, n))
    assert not missing, f"{_twin(rel)} lacks {missing}"
    # An exception stays one: its name is still absent from the port.
    present = sorted(n for (r, n) in EXCEPTIONS if r == rel
                     and hasattr(module, n))
    assert not present, f"{_twin(rel)} now has {present}: drop them from " \
        f"EXCEPTIONS"
