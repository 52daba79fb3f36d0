// k-NN regression over Sizey's masked history buffer, fused in one kernel:
// scaled direct-difference distances, a stable top-k and the mean target.
//
// Replaces the TPU kernel src/repro/kernels/knn/kernel.py::pairwise_sq_dists_blocked
// (body _dist_body) together with the top-k mean of src/repro/kernels/knn/ops.py::
// knn_predict, and computes what the k-NN model computes per query
// (src/repro/core/models/knn.py::predict):
//   d2[q, t] = sum_f ((hist[t, f] - q[f]) / scale[f])^2, summed over f in order;
//   masked rows (mask <= 0) are excluded;
//   the k smallest are kept lowest index first on ties, as jax.lax.top_k does;
//   out[q] = mean of the kept rows' targets, 0 when no row is valid.
// The TPU kernel expands |q - x|^2 into |q|^2 + |x|^2 - 2 q.x for the MXU; with
// d = 1 feature there is no product worth a matrix unit, and the direct
// difference is what the model computes, so the kernel keeps it.
//
// What bounds it on an H100: at Sizey's shapes (Q = 1..CAP queries, T = CAP
// history rows, d = 1, k = 5) it reads a few KB to a few tens of KB and does
// ~5*Q*T*d FLOPs plus the selection: launch latency dominates. Design: one
// thread per query, the history streamed through shared memory in tiles of
// 256 rows shared by the block's 128 queries, and a sorted list of the best
// KCAP >= k rows scanned in index order. A new row goes after every kept row
// at a distance <= its own, which keeps the lower index on ties. KCAP is a
// template parameter (5 for k <= 5, Sizey's k = 5; 32 above) and the list
// is only ever indexed by unrolled constants: the list of 5 stays in
// registers (ptxas: no stack frame), while ptxas gives the list of 32 a
// 128-byte stack frame, which only k > 5 reaches.
// Arithmetic uses the _rn intrinsics so that nvcc contracts no multiply-add:
// the distances and the sum of targets are then bitwise those of the plain
// PyTorch version (kernels/knn/ref.py).
//
// pairwise_sq_dists_f32 is the TPU kernel's own function (scale = 1): the
// masked (Q, T) distance matrix with 3.4e38 at masked columns.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 256;
constexpr int kMaxK = 32;

template <int KCAP>
__global__ void knn_predict_kernel(const float* __restrict__ queries,
                                   const float* __restrict__ hist,
                                   const float* __restrict__ ys,
                                   const float* __restrict__ mask,
                                   const float* __restrict__ scale,
                                   float* __restrict__ out,
                                   int Q, int T, int d, int k) {
  extern __shared__ float smem[];
  float* sh = smem;                 // (kTile, d) history rows
  float* sy = sh + kTile * d;       // (kTile,) targets
  float* smask = sy + kTile;        // (kTile,) mask
  float* sscale = smask + kTile;    // (d,)
  for (int i = threadIdx.x; i < d; i += blockDim.x) sscale[i] = scale[i];

  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = qi < Q;
  const float* qr = queries + static_cast<size_t>(active ? qi : 0) * d;
  float best_d[KCAP];
  float best_y[KCAP];
#pragma unroll
  for (int i = 0; i < KCAP; ++i) best_d[i] = best_y[i] = 0.0f;
  int n = 0;          // rows kept, <= k
  float kth = 0.0f;   // best_d[k - 1] once n == k

  for (int t0 = 0; t0 < T; t0 += kTile) {
    const int nt = min(kTile, T - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < nt * d; i += blockDim.x)
      sh[i] = hist[static_cast<size_t>(t0) * d + i];
    for (int i = threadIdx.x; i < nt; i += blockDim.x) {
      sy[i] = ys[t0 + i];
      smask[i] = mask[t0 + i];
    }
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < nt; ++j) {
      if (!(smask[j] > 0.0f)) continue;
      float dist = 0.0f;
      for (int f = 0; f < d; ++f) {
        const float diff = __fdiv_rn(__fsub_rn(sh[j * d + f], qr[f]), sscale[f]);
        dist = __fadd_rn(dist, __fmul_rn(diff, diff));
      }
      if (dist != dist) continue;  // NaN never ranks
      if (n < k || dist < kth) {
        // slot p = the number of kept rows at a distance <= dist
        int p = 0;
#pragma unroll
        for (int i = 0; i < KCAP; ++i) p += (i < n && best_d[i] <= dist);
        const float y = sy[j];
#pragma unroll
        for (int i = KCAP - 1; i > 0; --i) {
          if (i > p) {
            best_d[i] = best_d[i - 1];
            best_y[i] = best_y[i - 1];
          } else if (i == p) {
            best_d[i] = dist;
            best_y[i] = y;
          }
        }
        if (p == 0) {
          best_d[0] = dist;
          best_y[0] = y;
        }
        if (n < k) ++n;
#pragma unroll
        for (int i = 0; i < KCAP; ++i)
          if (i == k - 1) kth = best_d[i];
      }
    }
  }
  if (!active) return;
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < KCAP; ++i)
    if (i < n) s = __fadd_rn(s, best_y[i]);
  out[qi] = n > 0 ? __fdiv_rn(s, static_cast<float>(n)) : 0.0f;
}

__global__ void pairwise_sq_dists_kernel(const float* __restrict__ queries,
                                         const float* __restrict__ hist,
                                         const float* __restrict__ mask,
                                         float* __restrict__ out,
                                         int Q, int T, int d) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int q = blockIdx.y;
  if (t >= T) return;
  float v = 3.4e38f;
  if (mask[t] > 0.0f) {
    v = 0.0f;
    for (int f = 0; f < d; ++f) {
      const float diff = __fsub_rn(queries[static_cast<size_t>(q) * d + f],
                                   hist[static_cast<size_t>(t) * d + f]);
      v = __fadd_rn(v, __fmul_rn(diff, diff));
    }
  }
  out[static_cast<size_t>(q) * T + t] = v;
}

}  // namespace

extern "C" int knn_predict_f32(const float* queries, const float* hist,
                               const float* ys, const float* mask,
                               const float* scale, float* out, int Q, int T,
                               int d, int k, cudaStream_t stream) {
  const dim3 grid((Q + kThreads - 1) / kThreads);
  const size_t smem = sizeof(float) * (static_cast<size_t>(kTile) * (d + 2) + d);
  if (k <= 5)
    knn_predict_kernel<5><<<grid, kThreads, smem, stream>>>(
        queries, hist, ys, mask, scale, out, Q, T, d, k);
  else
    knn_predict_kernel<kMaxK><<<grid, kThreads, smem, stream>>>(
        queries, hist, ys, mask, scale, out, Q, T, d, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pairwise_sq_dists_f32(const float* queries, const float* hist,
                                     const float* mask, float* out, int Q,
                                     int T, int d, cudaStream_t stream) {
  const dim3 grid((T + kThreads - 1) / kThreads, Q);
  pairwise_sq_dists_kernel<<<grid, kThreads, 0, stream>>>(queries, hist, mask,
                                                          out, Q, T, d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
