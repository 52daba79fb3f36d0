// k-NN regression over Sizey's masked history buffer, fused in one kernel:
// scaled direct-difference distances, a stable top-k and the mean target.
//
// Replaces the TPU kernel src/repro/kernels/knn/kernel.py::pairwise_sq_dists_blocked
// (body _dist_body) together with the top-k mean of src/repro/kernels/knn/ops.py::
// knn_predict, and computes what the k-NN model computes per query
// (src/repro/core/models/knn.py::predict):
//   d2[q, t] = sum_f ((hist[t, f] - q[f]) / scale[f])^2, summed over f in order;
//   masked rows (mask <= 0) and rows whose distance is not finite are
//   excluded (NaN never ranks);
//   the k smallest are kept lowest index first on ties, as jax.lax.top_k does;
//   out[q] = their targets summed in rank order over their count, 0 when no
//   row is valid.
//
// What bounds it on an H100: at Sizey's shapes (Q = 1..1024 queries, T =
// 128..1024 history rows, d = 1 or 2, k = 5) it reads a few KB and does
// ~4 Q T d operations plus the selection: a few microseconds of work, so
// what a launch costs is its latency and its longest serial chain. The
// first design ran one thread per query over all T rows in series, on
// ceil(Q / 128) blocks: at Q = 4 that was four busy threads on one SM.
//
// Design: a warp per query, so that the Q T pairs spread over the card even
// at small Q. Block = 8 warps; a query takes S = 1, 2, 4 or 8 of them, so
// a block serves 8 / S queries. The wrapper plans S from Q and T, by the
// device times measured at each (ops.py::plan_splits): one warp below 256
// rows, else the most warps that keep Q S <= 1,024 (8 at Q = 4).
//   - The block stages its history tile in shared memory once for all its
//     warps, feature-major (each feature's column contiguous, so the lanes
//     of a warp read consecutive words), with 16-byte loads where aligned.
//   - Lane l of the query's warp w takes rows w 32 + l, + 32 S, ... in
//     order of increasing index and keeps its best k as (dist, row, target)
//     in registers, sorted by (dist, row): a new row goes after every kept
//     row at a distance <= its own.
//   - The warp merges the 32 lists in k rounds: a __shfl_xor_sync butterfly
//     finds the lexicographic minimum of (dist, row) over the lanes' heads,
//     and the lane that holds it pops its head. That is jax.lax.top_k's
//     order, lowest index first on ties.
//   - With S > 1 each warp writes its merged list to shared memory, and the
//     query's first warp merges the S lists the same way, lane j walking
//     list j.
//   - The targets are added in rank order and divided by their count, as
//     the plain version adds them.
// The arithmetic uses the _rn intrinsics (the division by scale with
// __fdiv_rn), so that nvcc contracts no multiply-add: the distances, the
// order and the sum are bitwise those of the plain PyTorch version
// (kernels/knn/ref.py).
//
// What does not fit this work: the TPU kernel expands |q - x|^2 into |q|^2 +
// |x|^2 - 2 q.x for its matrix unit, which would break the bitwise match
// with the direct difference the model computes, and at d <= 2 there is no
// product worth a tensor core. TMA adds nothing for a few KB. What matters
// here are warp shuffles, shared memory and enough warps in flight.
//
// KCAP, the list length, is a template parameter (5 for k <= 5, Sizey's
// k = 5; 32 above), and a list is indexed only by unrolled constants:
// ptxas builds the list of 5 in 63 registers and a 72-byte stack frame
// with no spills; the list of 32, which only k > 5 reaches, spills.
//
// pairwise_sq_dists_f32 is the TPU kernel's own function (scale = 1): the
// masked (Q, T) distance matrix with 3.4e38 at masked columns, one thread
// per (query, row) pair.
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxK = 32;
constexpr int kMaxFeatures = 32;
constexpr unsigned kFull = 0xffffffffu;
// shared memory a block may use without opting in, in floats
constexpr int kSmemFloats = 48 * 1024 / 4;
// the merge lists of S > 1 ((dist, row, target) per rank per warp), the
// block's queries and the scale, ahead of the tile
constexpr int kFixedFloats = 3 * kWarps * kMaxK + kWarps * kMaxFeatures +
                             kMaxFeatures;

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// (da, ra) before (db, rb) in (dist, row) order
__device__ __forceinline__ bool before(float da, int ra, float db, int rb) {
  return da < db || (da == db && ra < rb);
}

// A lane's best rows, sorted by (dist, row); n of them are kept (n <= k).
template <int KCAP>
struct Best {
  float d[KCAP];
  int r[KCAP];
  float y[KCAP];
  int n;
  float kth;   // d[k - 1] once n == k

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int i = 0; i < KCAP; ++i) {
      d[i] = inf_f();
      r[i] = INT_MAX;
      y[i] = 0.0f;
    }
    n = 0;
    kth = inf_f();
  }
  // a row of a higher index than every kept one
  __device__ __forceinline__ void push(float dist, int row, float yv, int k) {
    if (n == k && !(dist < kth)) return;
    // slot p = the number of kept rows at a distance <= dist
    int p = 0;
#pragma unroll
    for (int i = 0; i < KCAP; ++i) p += (i < n && d[i] <= dist);
#pragma unroll
    for (int i = KCAP - 1; i > 0; --i) {
      if (i > p) {
        d[i] = d[i - 1];
        r[i] = r[i - 1];
        y[i] = y[i - 1];
      } else if (i == p) {
        d[i] = dist;
        r[i] = row;
        y[i] = yv;
      }
    }
    if (p == 0) {
      d[0] = dist;
      r[0] = row;
      y[0] = yv;
    }
    if (n < k) ++n;
#pragma unroll
    for (int i = 0; i < KCAP; ++i)
      if (i == k - 1) kth = d[i];
  }
  __device__ __forceinline__ void pop() {
#pragma unroll
    for (int i = 0; i + 1 < KCAP; ++i) {
      d[i] = d[i + 1];
      r[i] = r[i + 1];
      y[i] = y[i + 1];
    }
    --n;
  }
};

// Merge the warp's 32 lists in up to k rounds; round i calls
// emit(i, dist, row, target) with the i-th nearest of the warp, in every
// lane. Returns the number of rounds (the rows ranked).
template <int KCAP, typename Emit>
__device__ __forceinline__ int warp_merge(Best<KCAP>& b, int k, Emit&& emit) {
  int i = 0;
  for (; i < k; ++i) {
    const float hd = b.n > 0 ? b.d[0] : inf_f();
    const int hr = b.n > 0 ? b.r[0] : INT_MAX;
    float md = hd;
    int mr = hr;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float od = __shfl_xor_sync(kFull, md, o);
      const int orow = __shfl_xor_sync(kFull, mr, o);
      if (before(od, orow, md, mr)) {
        md = od;
        mr = orow;
      }
    }
    if (mr == INT_MAX) break;   // every list is empty (uniform)
    const unsigned win = __ballot_sync(kFull, b.n > 0 && hr == mr);
    const int wl = __ffs(win) - 1;
    const float yv = __shfl_sync(kFull, b.y[0], wl);
    if (static_cast<int>(threadIdx.x & 31) == wl) b.pop();
    emit(i, md, mr, yv);
  }
  return i;
}

// copy n floats from global src to shared memory through store(i, v), with
// 16-byte loads where src is 16-byte aligned
template <typename Store>
__device__ __forceinline__ void stage(const float* __restrict__ src, int n,
                                      Store&& store) {
  int i0 = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n4 = n >> 2;
    for (int i = threadIdx.x; i < n4; i += kThreads) {
      const float4 v = reinterpret_cast<const float4*>(src)[i];
      store(4 * i, v.x);
      store(4 * i + 1, v.y);
      store(4 * i + 2, v.z);
      store(4 * i + 3, v.w);
    }
    i0 = 4 * n4;
  }
  for (int i = i0 + threadIdx.x; i < n; i += kThreads) store(i, src[i]);
}

template <int KCAP>
__global__ void __launch_bounds__(kThreads)
knn_predict_kernel(const float* __restrict__ queries,
                   const float* __restrict__ hist,
                   const float* __restrict__ ys,
                   const float* __restrict__ mask,
                   const float* __restrict__ scale, float* __restrict__ out,
                   int Q, int T, int d, int k, int S, int tile) {
  extern __shared__ float smem[];
  float* const sList = smem;                             // [kWarps][3][kMaxK]
  float* const sq = sList + 3 * kWarps * kMaxK;          // [kWarps][d]
  float* const ss = sq + kWarps * kMaxFeatures;          // [d]
  float* const sh = ss + kMaxFeatures;                   // [d][tile]
  float* const sy = sh + d * tile;                       // [tile]
  float* const sm = sy + tile;                           // [tile]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per_block = kWarps / S;
  const int grp = warp / S, wg = warp % S;               // query, its part
  const int q0 = blockIdx.x * per_block;
  const int qi = q0 + grp;
  const bool active = qi < Q;
  for (int i = threadIdx.x; i < d; i += kThreads) ss[i] = scale[i];
  for (int i = threadIdx.x; i < per_block * d; i += kThreads)
    sq[i] = q0 + i / d < Q ? queries[static_cast<size_t>(q0) * d + i] : 0.0f;
  const float* const qv = sq + grp * d;

  Best<KCAP> best;
  best.clear();
  const int stride = 32 * S, first = 32 * wg + lane;
  for (int t0 = 0; t0 < T; t0 += tile) {
    const int nt = min(tile, T - t0);
    __syncthreads();   // the last tile is read by every warp
    stage(hist + static_cast<size_t>(t0) * d, nt * d, [&](int i, float v) {
      sh[(i % d) * tile + i / d] = v;
    });
    stage(ys + t0, nt, [&](int i, float v) { sy[i] = v; });
    stage(mask + t0, nt, [&](int i, float v) { sm[i] = v; });
    __syncthreads();
    if (!active) continue;
    for (int j = first; j < nt; j += stride) {
      if (!(sm[j] > 0.0f)) continue;
      float dist = 0.0f;
      for (int f = 0; f < d; ++f) {
        const float diff = __fdiv_rn(__fsub_rn(sh[f * tile + j], qv[f]), ss[f]);
        dist = __fadd_rn(dist, __fmul_rn(diff, diff));
      }
      if (!(dist < inf_f())) continue;   // NaN and inf never rank
      best.push(dist, t0 + j, sy[j], k);
    }
  }

  float s = 0.0f;
  int n = 0;
  if (S == 1) {
    if (active)
      n = warp_merge(best, k, [&](int, float, int, float yv) {
        s = __fadd_rn(s, yv);
      });
  } else {
    // each warp's k nearest to shared memory, then the query's first warp
    // merges the S lists (lane j < S walks list j)
    float* const mine = sList + warp * 3 * kMaxK;
    int cnt = 0;
    if (active)
      cnt = warp_merge(best, k, [&](int i, float dv, int rv, float yv) {
        if (lane == 0) {
          mine[i] = dv;
          mine[kMaxK + i] = __int_as_float(rv);
          mine[2 * kMaxK + i] = yv;
        }
      });
    if (lane == 0 && active && cnt < kMaxK)
      mine[kMaxK + cnt] = __int_as_float(INT_MAX);   // end of the list
    __syncthreads();
    if (active && wg == 0) {
      best.clear();
      if (lane < S) {
        const float* const li = sList + (warp + lane) * 3 * kMaxK;
#pragma unroll
        for (int i = 0; i < KCAP; ++i) {
          if (i < k && best.n == i && __float_as_int(li[kMaxK + i]) != INT_MAX) {
            best.d[i] = li[i];
            best.r[i] = __float_as_int(li[kMaxK + i]);
            best.y[i] = li[2 * kMaxK + i];
            best.n = i + 1;
          }
        }
      }
      n = warp_merge(best, k, [&](int, float, int, float yv) {
        s = __fadd_rn(s, yv);
      });
    }
  }
  if (active && wg == 0 && lane == 0)
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

// queries (Q, d), hist (T, d), ys, mask (T,), scale (d,), out (Q,): float32,
// contiguous, on the device; d <= 32, 1 <= k <= 32, S in {1, 2, 4, 8} warps
// a query.
extern "C" int knn_predict_f32(const float* queries, const float* hist,
                               const float* ys, const float* mask,
                               const float* scale, float* out, int Q, int T,
                               int d, int k, int S, cudaStream_t stream) {
  if (d < 1 || d > kMaxFeatures || k < 1 || k > kMaxK ||
      (S != 1 && S != 2 && S != 4 && S != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  // the history tile: all T rows where they fit beside the fixed part, in
  // rows of whole warps
  const int cap = (kSmemFloats - kFixedFloats) / (d + 2) / 32 * 32;
  const int tile = std::min(cap, (T + 31) / 32 * 32);
  const size_t smem =
      sizeof(float) * (kFixedFloats + static_cast<size_t>(tile) * (d + 2));
  const int per_block = kWarps / S;
  const dim3 grid((Q + per_block - 1) / per_block);
  if (k <= 5)
    knn_predict_kernel<5><<<grid, kThreads, smem, stream>>>(
        queries, hist, ys, mask, scale, out, Q, T, d, k, S, tile);
  else
    knn_predict_kernel<kMaxK><<<grid, kThreads, smem, stream>>>(
        queries, hist, ys, mask, scale, out, Q, T, d, k, S, tile);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pairwise_sq_dists_f32(const float* queries, const float* hist,
                                     const float* mask, float* out, int Q,
                                     int T, int d, cudaStream_t stream) {
  constexpr int kPairThreads = 128;
  const dim3 grid((T + kPairThreads - 1) / kPairThreads, Q);
  pairwise_sq_dists_kernel<<<grid, kPairThreads, 0, stream>>>(
      queries, hist, mask, out, Q, T, d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
