"""The issue rate of Hopper's `mma.sync` tensor-core product on this card.

    python3 tools/port_mma_rate.py

Builds a small CUDA program with nvcc (into ``build/``) whose warps each run
independent chains of bf16 `mma.sync.m16n8k16` products (fp32
accumulators) and prints, for 1 to 16 warps a block and for a block on
every SM, the cycles between one warp's products and the TFLOP/s of the
whole grid. K6's bf16 kernel (``kernels/ssd_scan``) issues its products
this way, so its busiest warp's count of products bounds it. Prints the
card's name and power limit first. Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SOURCE = r"""
#include <cuda_runtime.h>
#include <cstdio>
__device__ __forceinline__ void mma(float* d, const unsigned* a, unsigned b0,
                                    unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// CH independent accumulator chains a warp, `iters` products each
template <int CH>
__global__ void chains(float* out, long long* cyc, int iters) {
  unsigned a[4] = {threadIdx.x, 1u, 2u, 3u};
  float d[CH][4] = {};
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int c = 0; c < CH; ++c) mma(d[c], a, i, c);
  const long long t1 = clock64();
  float s = 0;
  for (int c = 0; c < CH; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) cyc[blockIdx.x] = t1 - t0;
}
template <int CH>
void run(float* out, long long* cyc, int warps, int blocks) {
  const int iters = 4096;
  chains<CH><<<blocks, 32 * warps>>>(out, cyc, iters);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  chains<CH><<<blocks, 32 * warps>>>(out, cyc, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0;
  cudaEventElapsedTime(&ms, e0, e1);
  long long c = 0;
  cudaMemcpy(&c, cyc, sizeof(c), cudaMemcpyDeviceToHost);
  const double n = static_cast<double>(iters) * CH;
  printf("%d chains a warp, %2d warps a block, %3d blocks: %6.2f cycles "
         "between a warp's products, %6.1f TFLOP/s\n", CH, warps, blocks,
         c / n, 4096.0 * n * warps * blocks / (ms * 1e-3) / 1e12);
}
int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* out;
  long long* cyc;
  cudaMalloc(&out, 1 << 24);
  cudaMalloc(&cyc, 8 * 1024);
  run<1>(out, cyc, 1, 1);
  run<8>(out, cyc, 1, 1);
  for (int w : {2, 4, 8, 16}) run<8>(out, cyc, w, 1);
  for (int w : {8, 16}) run<8>(out, cyc, w, sms);
  return cudaGetLastError() != cudaSuccess;
}
"""


def main() -> None:
    from repro_torch.kernels import _build
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    out = _build.build_dir()
    out.mkdir(parents=True, exist_ok=True)
    src, exe = out / "mma_rate.cu", out / "mma_rate"
    src.write_text(SOURCE)
    subprocess.run([_build.nvcc_path(), *_build.ARCH_FLAGS, "-O3", "-o",
                    str(exe), str(src)], check=True, timeout=600)
    sys.exit(subprocess.run([str(exe)], timeout=600).returncode)


if __name__ == "__main__":
    main()
