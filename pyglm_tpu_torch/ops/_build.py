"""Build and load the port's hand-written CUDA kernels.

On first use, one ``nvcc`` per ``pyglm_tpu_torch/csrc/*.cu``, all started
together, compiles the sources to objects, and one more links them into a
shared library with a plain C interface, in ``build/pyglm_tpu_torch/`` at
the root of the checkout; ``ctypes`` loads it. The library is rebuilt when
a source is newer than it. A missing ``nvcc`` or a failed build raises:
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

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "pyglm_tpu_torch"
LIB_PATH = BUILD_DIR / "libpyglm_tpu_torch_kernels.so"
LOG_PATH = BUILD_DIR / "nvcc.log"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong
_ULL = ctypes.c_ulonglong
# C entry points: name -> argument types. Each returns cudaGetLastError().
_ENTRY_POINTS = {
    "pg_devroye_launch": [_P, _P, _LL, _ULL, _ULL, _P],
    "ss_group_pass_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                             _ULL, _ULL, _P],
    "ss_edge_scan_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _P],
    "pg_gamma_series_launch": [_P, _P, _P, _LL, _F, _ULL, _ULL, _P],
    "crt_sample_launch": [_P, _I, _P, _P, _I, _LL, _I, _I, _ULL, _ULL, _P],
    "group_gram_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "group_gram_fp32_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _P],
    "group_gram_bf16_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "wgmma_probe_launch": [_P, _P, _P, _P],
    "wgmma_tf32_probe_launch": [_P, _P, _P, _P],
}

# Kernel launches per wrapper, and per Gram mode for K2 and K6 (the bf16
# bodies count under their own keys, so a run shows which body ran) and per
# form for K5 (per element, and summed per column). Each
# wrapper adds one where it launches its kernel and nowhere else;
# reset_launches() sets every count to 0.
LAUNCHES = {"pg_devroye": 0, "ss_group_pass": 0, "ss_group_pass_bf16": 0,
            "ss_group_pass_sr": 0, "ss_edge_scan": 0, "pg_gamma_series": 0,
            "crt_sample": 0, "crt_sample_sums": 0, "group_gram": 0,
            "group_gram_bf16": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def philox_seed(generator) -> tuple[int, int]:
    """A fresh (seed, offset) pair for a kernel's Philox streams, drawn from
    `generator`. Pass a CPU generator to keep the draw off the device stream:
    on a CUDA generator ``tolist`` waits for the device."""
    seed, offset = torch.randint(0, 2 ** 62, (2,), generator=generator,
                                 device=generator.device).tolist()
    return seed, offset


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
    nvcc, pid = _nvcc(), os.getpid()
    t0 = time.perf_counter()
    cus = [s for s in srcs if s.suffix == ".cu"]
    objs = [BUILD_DIR / f"{s.stem}.{pid}.o" for s in cus]   # nvcc reads .o
    jobs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True))
            for cmd in ([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                        for s, o in zip(cus, objs))]
    tmp = LIB_PATH.with_name(f"{LIB_PATH.name}.{pid}.tmp")
    link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
    log = []
    try:
        for cmd, proc in jobs:
            out, _ = proc.communicate()
            log.append(out)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{out[-4000:]}")
        res = subprocess.run(link, capture_output=True, text=True)
        log.append(res.stdout + res.stderr)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{' '.join(link)}\n{res.stderr[-4000:]}")
        os.replace(tmp, LIB_PATH)
    finally:
        for _, proc in jobs:
            proc.kill()
            proc.wait()
        LOG_PATH.write_text("".join(log))
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
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
