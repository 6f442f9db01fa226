"""The exact Polya-Gamma sampler on the host (C++ with OpenMP, bound with
ctypes): the oracle that kernels K1 and K4 are held against.

``pg_sampler.cpp`` is the JAX package's source, copied byte for byte: the
Devroye-type sampler of Polson, Scott and Windle (2013) for PG(1, c), and
PG(b, c) for integer b as a sum of b such draws, on std::mt19937_64 streams
(one per thread, seeded from `seed` and the thread's index). Other code and
another generator than the card's kernels: the draws agree with theirs in
law, never bit for bit.

At first use g++ compiles it into ``build/pyglm_tpu_torch/libpg.so`` at the
root of the checkout (again when the source is newer), with OpenMP where
the compiler has it; nothing is written into the package. :func:`library`
raises when the build fails; :func:`native_available` says whether it
succeeded, for callers that may go without the oracle.
"""
from __future__ import annotations

import ctypes
import functools
import os
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().with_name("pg_sampler.cpp")
_LIB = Path(__file__).resolve().parents[2] / "build" / "pyglm_tpu_torch" / \
    "libpg.so"
_FLAGS = (["-O3", "-fopenmp"], ["-O3"])      # without OpenMP if it fails
_D = ctypes.POINTER(ctypes.c_double)


def _build() -> None:
    _LIB.parent.mkdir(parents=True, exist_ok=True)
    tmp = _LIB.with_name(f"{_LIB.name}.{os.getpid()}.tmp")
    errors = []
    try:
        for flags in _FLAGS:
            cmd = ["g++", *flags, "-shared", "-fPIC", str(_SRC), "-o",
                   str(tmp)]
            try:
                res = subprocess.run(cmd, capture_output=True, text=True,
                                     timeout=300)
            except (OSError, subprocess.TimeoutExpired) as e:
                errors.append(f"{' '.join(cmd)}: {e}")
                continue
            if res.returncode == 0:
                os.replace(tmp, _LIB)
                return
            errors.append(f"{' '.join(cmd)}:\n{res.stderr[-2000:]}")
    finally:
        tmp.unlink(missing_ok=True)
    raise RuntimeError("the native PG oracle did not build:\n"
                       + "\n".join(errors))


@functools.cache
def library() -> ctypes.CDLL:
    """The oracle's library, built first if it is missing or stale; raises
    RuntimeError if it cannot be built."""
    if not _LIB.exists() or _LIB.stat().st_mtime < _SRC.stat().st_mtime:
        _build()
    lib = ctypes.CDLL(str(_LIB))
    lib.pg_devroye_vec.argtypes = [_D, _D, ctypes.c_int64, ctypes.c_uint64,
                                   ctypes.c_int]
    lib.pg_int_b_vec.argtypes = [_D, _D, _D, ctypes.c_int64,
                                 ctypes.c_uint64, ctypes.c_int]
    for fn in (lib.pg_devroye_vec, lib.pg_int_b_vec):
        fn.restype = None
    return lib


def native_available() -> bool:
    """True if the oracle builds and loads here."""
    try:
        library()
    except (RuntimeError, OSError):
        return False
    return True


def _threads(n_threads: int) -> int:
    return n_threads if n_threads > 0 else (os.cpu_count() or 1)


def pg_devroye_native(c, seed: int = 0, n_threads: int = 0) -> np.ndarray:
    """Exact PG(1, c) draws, float64 of c's shape, on `n_threads` host
    threads (0: every core). The same (seed, n_threads) gives the same
    draws."""
    lib = library()
    c = np.ascontiguousarray(np.asarray(c, np.float64))
    out = np.empty_like(c)
    lib.pg_devroye_vec(c.ctypes.data_as(_D), out.ctypes.data_as(_D), c.size,
                       np.uint64(seed), _threads(n_threads))
    return out


def pg_int_b_native(b, c, seed: int = 0, n_threads: int = 0) -> np.ndarray:
    """Exact PG(b, c) draws for whole b (a sum of b PG(1, c) draws; c
    broadcast to b's shape), float64."""
    lib = library()
    b = np.ascontiguousarray(np.asarray(b, np.float64))
    c = np.ascontiguousarray(np.broadcast_to(np.asarray(c, np.float64),
                                             b.shape))
    out = np.empty_like(c)
    lib.pg_int_b_vec(b.ctypes.data_as(_D), c.ctypes.data_as(_D),
                     out.ctypes.data_as(_D), c.size, np.uint64(seed),
                     _threads(n_threads))
    return out
