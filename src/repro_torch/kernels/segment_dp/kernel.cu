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
// What bounds it on an H100: it reads M*G*4 bytes (16.5 KB at M = 129, G =
// 32) and does ~5*M*G(G+1)/2 operations, a bound of a few nanoseconds. The
// fold over m must keep its order and the DP is k dependent steps, so one
// block of 1,024 threads does it all, and what bounds a fit is that block's
// instruction issue (about seven instructions and two shared-memory accesses
// per (m, i, j)) and the barriers between its steps. The design:
//   * the cost is built one tile of Mt profiles at a time, in two phases.
//     The tile's rows of P are staged in shared memory with coalesced loads.
//     Phase A: one thread per (m, i) walks j = i+1..G with its running max
//     and sum and writes each value of the profile's triangle into a shared
//     tile; a warp holds the profiles of one start column side by side, so
//     its lanes walk rows of one length and none idles on the triangle, and
//     the strides are odd, so they hit 32 banks. Phase B: one thread per
//     entry (i, j) adds the tile's Mt values in m order to the entry's sum,
//     which carries over from tile to tile. The chain is about
//     ceil(M*G/1024)*G/2 + M steps where the first design's was M*G (about
//     190 against 4,096 at M = 128, G = 32);
//   * Mt and the bands of start columns come from the shared-memory budget
//     (ops.py::plan, a function of (M, G) only). A band is a run of start
//     columns whose triangle rows fit beside one profile's row of P; at
//     G = 32 one band holds them all and Mt = 101. Bands are needed from
//     G = 338, where a single profile's triangle no longer fits;
//   * the cost matrix, the DP's two rows and the back pointers stay in
//     shared memory where the cost and the back pointers at k = G fit (G <=
//     169; the back pointers reuse the build's tile), and in device scratch
//     above that;
//   * each DP step gives a column j >= 1 to a warp (column 0 ends no
//     segment: its value is inf and its pick row 0 at every step): each
//     lane keeps its rows' (lane, lane + 32, ...) smallest candidate with a
//     strict <, then two warp reductions (__reduce_min_sync) take the
//     smallest value and, among the lanes holding it, the smallest row. That
//     is the first index of the minimum, as the serial scan and np.argmin
//     find it, 0 for an all-inf column; a NaN candidate counts as -inf at
//     row 0 and +inf elsewhere, so the pick is the serial strict-< scan's on
//     any input. One thread walks the back pointers.
//
// CUDA and not Triton: the fold over m must keep its order and the DP is an
// argmin chained over k steps, which Triton's block reductions, free to sum
// in any order, would not keep.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kSmemBytes = 232448;   // an H100 block's shared memory, 227 KB
constexpr int kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// The first band of start columns at i0: the most rows whose entries stay
// within cap (at least one row; the plan makes cap >= G).
__device__ __host__ inline int band_end(int i0, int G, int cap, int* entries) {
  int i1 = i0, e = 0;
  while (i1 < G && (i1 == i0 || e + (G - i1) <= cap)) {
    e += G - i1;
    ++i1;
  }
  *entries = e;
  return i1;
}

// inf at every entry with j <= i or i == G; the build writes the others.
__device__ void fill_inf(float* C, int G) {
  const int n = G + 1;
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
    const int i = e / n;
    const int j = e - i * n;
    if (i >= G || j <= i) C[e] = inf_f();
  }
}

// Strides of the staging area, odd so that 32 profiles at one column (or
// one entry) fall in 32 banks: a row of P, and a triangle of E entries.
__device__ __host__ inline int p_stride(int G) { return (G + 1) | 1; }
__device__ __host__ inline int t_stride(int E) { return E | 1; }

// Entries of a band before its row r, rows of L, L - 1, ... entries.
__device__ inline int row_start(int r, int L) { return r * L - r * (r - 1) / 2; }

// The row of a band's entry e: the largest r with row_start(r) <= e, from
// the quadratic's root (exact in fp32 for G <= 1024) and a one-step fix.
__device__ inline int row_of(int e, int L, int bw) {
  const float b = static_cast<float>(2 * L + 1);
  int r = static_cast<int>((b - sqrtf(b * b - 8.0f * e)) * 0.5f);
  r = max(0, min(r, bw - 1));
  while (r > 0 && row_start(r, L) > e) --r;
  while (r + 1 < bw && row_start(r + 1, L) <= e) ++r;
  return r;
}

// The cost matrix's finite entries into C ((G+1)^2, row-major; shared or
// device memory), tile by tile; build is the staging area of mt rows of P
// and mt triangles of the largest band, at their strides. Ends with a
// barrier.
__device__ void build_cost(const float* __restrict__ P, float* C, float* build,
                           int M, int G, int mt, int cap) {
  const int n = G + 1;
  const int ps = p_stride(G);
  float* Ps = build;
  float* T = build + mt * ps;
  for (int i0 = 0; i0 < G;) {
    int E;
    const int i1 = band_end(i0, G, cap, &E);
    const int bw = i1 - i0;
    const int L = G - i0;              // the band's first row's entries
    const int ts = t_stride(E);
    int m0 = 0;
    do {
      const int mc = min(mt, M - m0);
      const float* src = P + static_cast<size_t>(m0) * G;
      for (int x = threadIdx.x; x < mc * G; x += blockDim.x) {
        const int ml = x / G;
        Ps[ml * ps + x - ml * G] = src[x];
      }
      __syncthreads();
      // phase A: thread (m, i), the profiles of a row side by side in a
      // warp, writes row i of profile m's triangle
      for (int p = threadIdx.x; p < mc * bw; p += blockDim.x) {
        const int r = p / mc;
        const int ml = p - r * mc;
        const int i = i0 + r;
        const float* row = Ps + ml * ps + i;
        float* out = T + ml * ts + row_start(r, L);
        float rmax = row[0];
        float csum = rmax;
        float width = 1.0f;
        out[0] = __fsub_rn(__fmul_rn(rmax, width), csum);
        const int len = G - i;
        int s = 1;
        for (; s + 4 <= len; s += 4) {   // the four loads ahead of their use
          const float v[4] = {row[s], row[s + 1], row[s + 2], row[s + 3]};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            rmax = fmaxf(rmax, v[u]);
            csum = __fadd_rn(csum, v[u]);
            width += 1.0f;           // exact: a small integer
            out[s + u] = __fsub_rn(__fmul_rn(rmax, width), csum);
          }
        }
        for (; s < len; ++s) {
          rmax = fmaxf(rmax, row[s]);
          csum = __fadd_rn(csum, row[s]);
          width += 1.0f;
          out[s] = __fsub_rn(__fmul_rn(rmax, width), csum);
        }
      }
      __syncthreads();
      // phase B: thread e folds the tile's values of entry e in m order
      for (int e = threadIdx.x; e < E; e += blockDim.x) {
        const int r = row_of(e, L, bw);
        const int i = i0 + r;
        float* dst = C + i * n + i + 1 + (e - row_start(r, L));
        float acc = m0 == 0 ? 0.0f : *dst;
#pragma unroll 8
        for (int ml = 0; ml < mc; ++ml) acc = __fadd_rn(acc, T[ml * ts + e]);
        *dst = acc;
      }
      m0 += mc;
    } while (m0 < M);
    i0 = i1;
  }
  __syncthreads();
}

// A candidate's key: unsigned order is the candidates' order (no candidate
// is -0: the cost's sums start from +0, and dp from +0 and the cost); a NaN
// at row 0 first and elsewhere last, as the serial strict-< scan from row 0
// treats it.
__device__ inline unsigned dp_key(float c, int i) {
  if (c != c) c = i == 0 ? -inf_f() : inf_f();
  const unsigned u = __float_as_uint(c);
  return (u & 0x80000000u) ? ~u : u | 0x80000000u;
}

__global__ void __launch_bounds__(kThreads, 1)
segment_cost_build_kernel(const float* __restrict__ P, float* cost, int M,
                          int G, int mt, int cap) {
  extern __shared__ float smem[];
  fill_inf(cost, G);
  build_cost(P, cost, smem, M, G, mt, cap);
}

// The k cuts. With kSmem the cost matrix and the back pointers live in
// shared memory (cost and back unused); else in the scratch cost ((G+1)^2
// floats) and back (k * (G+1) ints).
template <bool kSmem>
__global__ void __launch_bounds__(kThreads, 1)
segment_dp_fit_kernel(const float* __restrict__ P, float* cost, int* back,
                      long long* __restrict__ cuts, int M, int G, int k,
                      int mt, int cap) {
  extern __shared__ float smem[];
  const int n = G + 1;
  float* C = kSmem ? smem : cost;
  float* dp = kSmem ? smem + n * n : smem;       // two rows of n
  float* build = dp + 2 * n;
  int* bk = kSmem ? reinterpret_cast<int*>(build) : back;
  fill_inf(C, G);
  build_cost(P, C, build, M, G, mt, cap);  // ends with a barrier
  for (int j = threadIdx.x; j < n; j += blockDim.x)
    dp[j] = j == 0 ? 0.0f : inf_f();
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  float* prev = dp;
  float* cur = dp + n;
  for (int s = 0; s < k; ++s) {
    // column 0 ends no segment: every candidate is inf, the pick row 0
    if (threadIdx.x == 0) {
      cur[0] = inf_f();
      bk[s * n] = 0;
    }
    for (int j = 1 + warp; j < n; j += warps) {
      unsigned key = 0xffffffffu;    // above every candidate's key
      unsigned arg = 0;
      for (int i = lane; i < n; i += 32) {
        const unsigned c = dp_key(__fadd_rn(prev[i], C[i * n + j]), i);
        if (c < key) {
          key = c;
          arg = i;
        }
      }
      const unsigned best = __reduce_min_sync(0xffffffffu, key);
      arg = __reduce_min_sync(0xffffffffu, key == best ? arg : 0xffffffffu);
      if (lane == 0) {
        cur[j] = __fadd_rn(prev[arg], C[arg * n + j]);
        bk[s * n + j] = arg;
      }
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
      j = bk[s * n + j];
    }
  }
}

// The plan's largest band (the staging area's stride), or -1 if cap < G.
int largest_band(int G, int cap) {
  if (cap < G) return -1;
  int emax = 0;
  for (int i0 = 0; i0 < G;) {
    int e;
    i0 = band_end(i0, G, cap, &e);
    emax = e > emax ? e : emax;
  }
  return emax;
}

// Let kernel take `bytes` of dynamic shared memory on the current device
// (once per device and size).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, int* allowed) {
  if (bytes <= static_cast<size_t>(kDefaultSmem)) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (allowed[dev] >= static_cast<int>(bytes)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) allowed[dev] = static_cast<int>(bytes);
  return err;
}

int cost_allowed[64];
int fit_allowed[64];
int fit_scratch_allowed[64];

}  // namespace

// P (M, G) -> cost (G + 1, G + 1), inf where j <= i: the TPU kernel's function.
// mt and cap are the plan's (ops.py::plan).
extern "C" int segment_cost_f32(const float* P, float* cost, int M, int G,
                                int mt, int cap, cudaStream_t stream) {
  const int emax = largest_band(G, cap);
  if (emax < 0 || mt < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * static_cast<size_t>(mt) *
                      (p_stride(G) + t_stride(emax));
  if (smem > static_cast<size_t>(kSmemBytes))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(segment_cost_build_kernel, smem, cost_allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  segment_cost_build_kernel<<<1, kThreads, smem, stream>>>(P, cost, M, G, mt,
                                                           cap);
  return static_cast<int>(cudaGetLastError());
}

// P (M, G), k -> cuts (k,) int64, the DP's end columns, last == G. cost
// ((G + 1)^2 floats) and back (k * (G + 1) ints) are device scratch, or
// both null to keep them in shared memory (the plan says which).
extern "C" int segment_dp_fit_f32(const float* P, float* cost, int* back,
                                  long long* cuts, int M, int G, int k, int mt,
                                  int cap, cudaStream_t stream) {
  const int emax = largest_band(G, cap);
  if (emax < 0 || mt < 1 || (cost == nullptr) != (back == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t n = static_cast<size_t>(G) + 1;
  size_t build = sizeof(float) * static_cast<size_t>(mt) *
                 (p_stride(G) + t_stride(emax));
  size_t fixed = sizeof(float) * 2 * n;
  if (cost == nullptr) {
    fixed += sizeof(float) * n * n;
    const size_t bk = sizeof(int) * static_cast<size_t>(k) * n;
    build = build > bk ? build : bk;
  }
  const size_t smem = fixed + build;
  if (smem > static_cast<size_t>(kSmemBytes))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (cost == nullptr) {
    err = allow_smem(segment_dp_fit_kernel<true>, smem, fit_allowed);
    if (err != cudaSuccess) return static_cast<int>(err);
    segment_dp_fit_kernel<true><<<1, kThreads, smem, stream>>>(
        P, cost, back, cuts, M, G, k, mt, cap);
  } else {
    err = allow_smem(segment_dp_fit_kernel<false>, smem, fit_scratch_allowed);
    if (err != cudaSuccess) return static_cast<int>(err);
    segment_dp_fit_kernel<false><<<1, kThreads, smem, stream>>>(
        P, cost, back, cuts, M, G, k, mt, cap);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
