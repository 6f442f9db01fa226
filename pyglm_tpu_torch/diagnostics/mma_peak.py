"""Peak rate of the tensor-core instruction K2's 3xTF32 gather M0 uses.

    python -m pyglm_tpu_torch.diagnostics.mma_peak

Builds a small kernel with nvcc (into ``build/pyglm_tpu_torch/``) that
issues ``mma.sync.aligned.m16n8k8`` TF32 products (and, for scale, the
m16n8k16 fp16 ones) back to back on registers, 8 independent accumulators
per warp, 4 blocks per SM, and prints TFLOP/s for 4, 8 and 16 warps per
block with the card's name and power limit. It bounds csrc/gram_tc.cuh
(each fp32-grade product there costs three TF32 products), the mma.sync
loop on which the 3xTF32 Grams ran before they moved to wgmma
(csrc/gram_wgmma.cuh::gram_tile_tf32). Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import ctypes
import subprocess

from pyglm_tpu_torch.ops import _build

_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <bool kTf32>
__global__ void mma_loop(float* out, int iters) {
  float c[8][4] = {};
  const uint32_t a[4] = {threadIdx.x, 1u, 2u, 3u}, b[2] = {5u, 7u};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (kTf32)
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                     "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                     : "+f"(c[i][0]), "+f"(c[i][1]), "+f"(c[i][2]),
                       "+f"(c[i][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
                       "r"(b[1]));
      else
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
                     "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                     : "+f"(c[i][0]), "+f"(c[i][1]), "+f"(c[i][2]),
                       "+f"(c[i][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
                       "r"(b[1]));
    }
  }
  float s = 0.0f;
  for (int i = 0; i < 8; ++i) s += c[i][0] + c[i][1] + c[i][2] + c[i][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
// TFLOP/s of `warps`-warp blocks, 4 per SM, each warp issuing 8 x iters
// products; tf32 != 0 for m16n8k8 TF32, else m16n8k16 fp16.
extern "C" float mma_tflops(int tf32, int warps, int iters) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const dim3 grid(4 * sms), block(32 * warps);
  float* out = nullptr;
  if (cudaMalloc(&out, (size_t)grid.x * block.x * sizeof(float)) != 0)
    return -1.0f;
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  float ms = 0.0f;
  for (int rep = 0; rep < 2; ++rep) {       // the first is the warm-up
    cudaEventRecord(e0);
    if (tf32) mma_loop<true><<<grid, block>>>(out, iters);
    else mma_loop<false><<<grid, block>>>(out, iters);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    cudaEventElapsedTime(&ms, e0, e1);
  }
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  cudaFree(out);
  if (cudaGetLastError() != cudaSuccess) return -1.0f;
  const double flop = (double)grid.x * warps * iters * 8 *
                      (tf32 ? 2.0 * 16 * 8 * 8 : 2.0 * 16 * 8 * 16);
  return (float)(flop / (ms * 1e-3) / 1e12);
}
"""


def main() -> None:
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "mma_peak.cu"
    lib_path = _build.BUILD_DIR / "libmma_peak.so"
    src.write_text(_SRC)
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o",
                    str(lib_path), str(src)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.mma_tflops.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.mma_tflops.restype = ctypes.c_float
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for tf32, name in ((1, "m16n8k8 tf32"), (0, "m16n8k16 fp16")):
        rates = [lib.mma_tflops(tf32, w, 20_000) for w in (4, 8, 16)]
        if min(rates) < 0:
            raise SystemExit("mma_peak: a CUDA call failed")
        print(f"mma.sync {name}: " + ", ".join(
            f"{w} warps/block {r:.1f} TFLOP/s" for w, r in zip((4, 8, 16),
                                                                rates)))


if __name__ == "__main__":
    main()
