// Segment-boundary fit of the temporal path: the over-reservation cost matrix
// over a pool's usage profiles, then the k-step change-point DP and its
// backtrack, in one kernel and one block.
//
// Replaces the TPU kernel src/repro/kernels/segment_dp/kernel.py::
// segment_cost_blocked (body _cost_row_body), which builds the cost matrix,
// together with the jitted DP and backtrack of src/repro/kernels/segment_dp/
// ops.py::_fit_cuts_jit. For fp32 profiles P (M, G):
//   cost[i][j] = sum over m, in index order from 0.0, of
//                rmax(m, i, j) * (j - i) - csum(m, i, j)     for 0 <= i < j <= G,
//   rmax the max and csum the left-to-right sum of P[m][i..j-1], and inf
//   elsewhere; then dp_0 = (0, inf, ...), dp_s[j] = min_i dp_{s-1}[i] + cost[i][j]
//   with the first minimising i kept as back_s[j], and the cuts are read back
//   from j = G. This is src/repro/kernels/segment_dp/ref.py::fit_cuts_ref,
//   bit for bit: the cut indices come from argmins, so every rounding is made
//   in the reference's order. The _rn intrinsics stop nvcc from contracting
//   the multiply and the subtract (or the adds) into one fused multiply-add.
//
// What bounds it on an H100: it reads M*G*4 bytes (64 KB at M = 512, G = 32)
// and does ~5*M*G(G+1)/2 operations, a bound of tens of nanoseconds. The work
// is an ordered fold over m and a DP of k dependent steps, so what bounds this
// design is its longest serial chain, M*G column steps for the pair (0, G),
// run by one thread of one block. The simple design: one thread per (i, j)
// entry walks m = 0..M-1 and, for each profile, columns i..j-1; the profiles
// are read from device memory (64 KB at most on the main path, so they stay
// in L1 and L2) and the cost matrix and back pointers go to device scratch,
// so no shared-memory limit caps M; then one thread per column j scans i
// with a strict < from i = 0 (the first index of the minimum; an all-inf
// column keeps 0, as np.argmin does), with a barrier between DP steps; then
// one thread walks the back pointers. A faster build (one thread per (m, i)
// row into scratch, then the ordered fold per (i, j): a chain of M + G steps)
// is later work.
//
// CUDA and not Triton: the fold over m must keep its order and the DP is an
// argmin chained over k steps, which Triton's block reductions, free to sum
// in any order, would not keep.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;

__device__ void build_cost(const float* __restrict__ P, float* __restrict__ cost,
                           int M, int G) {
  const int n = G + 1;
  const float inf = __int_as_float(0x7f800000);
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
    const int i = e / n;
    const int j = e - i * n;
    if (i >= G || j <= i) {
      cost[e] = inf;
      continue;
    }
    const float width = static_cast<float>(j - i);
    float acc = 0.0f;
    for (int m = 0; m < M; ++m) {
      const float* row = P + static_cast<size_t>(m) * G;
      float rmax = row[i];
      float csum = row[i];
      for (int g = i + 1; g < j; ++g) {
        const float v = row[g];
        rmax = fmaxf(rmax, v);
        csum = __fadd_rn(csum, v);
      }
      acc = __fadd_rn(acc, __fsub_rn(__fmul_rn(rmax, width), csum));
    }
    cost[e] = acc;
  }
}

__global__ void segment_cost_kernel(const float* __restrict__ P,
                                    float* __restrict__ cost, int M, int G) {
  build_cost(P, cost, M, G);
}

__global__ void segment_dp_kernel(const float* __restrict__ P,
                                  float* __restrict__ cost,
                                  int* __restrict__ back,
                                  long long* __restrict__ cuts, int M, int G,
                                  int k) {
  extern __shared__ float dp[];   // two rows of G + 1: previous and current
  const int n = G + 1;
  build_cost(P, cost, M, G);
  const float inf = __int_as_float(0x7f800000);
  for (int j = threadIdx.x; j < n; j += blockDim.x) dp[j] = j == 0 ? 0.0f : inf;
  __syncthreads();
  float* prev = dp;
  float* cur = dp + n;
  for (int s = 0; s < k; ++s) {
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      float best = __fadd_rn(prev[0], cost[j]);
      int arg = 0;
      for (int i = 1; i < n; ++i) {
        const float c = __fadd_rn(prev[i], cost[i * n + j]);
        if (c < best) {
          best = c;
          arg = i;
        }
      }
      cur[j] = best;
      back[s * n + j] = arg;
    }
    __syncthreads();
    float* t = prev;
    prev = cur;
    cur = t;
  }
  if (threadIdx.x == 0) {
    int j = G;
    for (int s = k - 1; s >= 0; --s) {
      cuts[s] = j;
      j = back[s * n + j];
    }
  }
}

int threads_for(int G) {
  const int want = (G + 1) * (G + 1);
  const int t = want < kMaxThreads ? want : kMaxThreads;
  return (t + 31) / 32 * 32;
}

}  // namespace

// P (M, G) -> cost (G + 1, G + 1), inf where j <= i: the TPU kernel's function.
extern "C" int segment_cost_f32(const float* P, float* cost, int M, int G,
                                cudaStream_t stream) {
  segment_cost_kernel<<<1, threads_for(G), 0, stream>>>(P, cost, M, G);
  return static_cast<int>(cudaGetLastError());
}

// P (M, G), k -> cuts (k,) int64, the DP's end columns, last == G. cost
// ((G + 1)^2 floats) and back (k * (G + 1) ints) are scratch.
extern "C" int segment_dp_fit_f32(const float* P, float* cost, int* back,
                                  long long* cuts, int M, int G, int k,
                                  cudaStream_t stream) {
  const size_t smem = sizeof(float) * 2 * static_cast<size_t>(G + 1);
  segment_dp_kernel<<<1, threads_for(G), smem, stream>>>(P, cost, back, cuts,
                                                          M, G, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
