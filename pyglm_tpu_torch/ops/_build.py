"""Build and load the port's hand-written CUDA kernels.

On first use, ``nvcc`` compiles every ``pyglm_tpu_torch/csrc/*.cu`` into
one shared library with a plain C interface, in ``build/pyglm_tpu_torch/``
at the root of the checkout, and ``ctypes`` loads it. The library is rebuilt
when a source is newer than it. A missing ``nvcc`` or a failed build raises:
there is no fallback. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "pyglm_tpu_torch"
LIB_PATH = BUILD_DIR / "libpyglm_tpu_torch_kernels.so"
LOG_PATH = BUILD_DIR / "nvcc.log"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_ULL = ctypes.c_ulonglong
# C entry points: name -> argument types. Each returns cudaGetLastError().
_ENTRY_POINTS = {
    "pg_devroye_launch": [_P, _P, _LL, _ULL, _ULL, _P],
    "ss_group_pass_launch": [_P, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _P],
    "ss_edge_scan_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _P],
}

# Kernel launches per wrapper. Each wrapper adds one where it launches its
# kernel and nowhere else; reset_launches() sets every count to 0.
LAUNCHES = {"pg_devroye": 0, "ss_group_pass": 0, "ss_edge_scan": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "pyglm_tpu_torch cannot be built")
    return path


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def build(force: bool = False) -> float:
    """Compile the kernels if the library is missing or stale. Returns the
    seconds the build took (0.0 when the library was current)."""
    srcs = _sources()
    if (not force and LIB_PATH.exists() and all(
            s.stat().st_mtime <= LIB_PATH.stat().st_mtime for s in srcs)):
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIB_PATH.with_name(f"{LIB_PATH.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in srcs if s.suffix == ".cu"]]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    LOG_PATH.write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stderr[-4000:]}")
    os.replace(tmp, LIB_PATH)
    return time.perf_counter() - t0


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    build()
    lib = ctypes.CDLL(str(LIB_PATH))
    for name, argtypes in _ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.pgt_error_string.argtypes = [ctypes.c_int]
    lib.pgt_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = library().pgt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg}) at launch")
