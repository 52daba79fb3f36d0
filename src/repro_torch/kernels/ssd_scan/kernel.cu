// Mamba2's chunked SSD scan (state-space duality), one block per (head,
// sequence) walking the chunks in order with the head's (P, N) state on
// chip.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py::ssd_scan_bhsp
// (body _ssd_body) and its wrapper ops.py::ssd_scan, and computes, per chunk
// of Q positions (x, B and C read in their own type, the rest in fp32):
//   da = dt * a[h];  cum = cumsum(da);  xs = x * dt
//   y_diag[q] = sum_{t <= q} (C_q . B_t) exp(cum_q - cum_t) xs_t
//   y_off[q]  = exp(cum_q) (C_q . state)
//   y = y_diag + y_off
//   state' = exp(cum_{Q-1}) state + sum_t (xs_t exp(cum_{Q-1} - cum_t)) B_t^T
// The TPU kernel keeps the state in scratch and drops it; this kernel also
// writes the final state (B, H, P, N), which a prefill needs to seed decode
// (the reference model's _ssd_chunked returns it). It reads x, B and C in
// the model's layout through their strides (x (B, S, H, P) and B, C (B, S,
// N) are slices of the convolution's output), so nothing is transposed or
// copied; a ragged last chunk reads its missing rows as dt = 0 and x = B = C
// = 0, which is inert (the TPU wrapper's padding) and is not stored.
//
// What bounds it on an H100: at the serving shape (B = 8, H = 112, S =
// 2048, P = N = 64, Q = 128) in bf16 it reads x, B, C and dt and writes y
// and the state in fp32, 730.9 MB, 0.2182 ms at 3.35 TB/s. Its products
// (C.B^T, M.x over the causal pairs, C.state^T and the state update) are
// 45.4 GFLOP: 0.677 ms at the fp32 CUDA-core rate, but 0.137 ms on the
// bf16 tensor cores even with three passes for every fp32 operand (135.8
// GFLOP). So bytes bound the bf16 kernel (ssd_scan_tc_kernel, below), which
// runs every product on the tensor cores: y and the final state are its
// only writes; TMA brings x, B and C in once per head, the next chunk's
// while this chunk's products run; and two blocks share an SM (108 KB of
// shared memory each, at most 128 registers a thread) where N <= 64. What
// keeps it above that bound is the warp with the most causal key tiles: one
// warp issues mma.sync at most once per ~12.8 cycles
// (tools/port_mma_rate.py).
//
// The fp32 kernel (ssd_scan_kernel) runs on CUDA cores in fp32 FMA and
// recomputes C.B^T in each head's block: 256 threads as 16 x 16; per chunk
// B and C (rows padded to N + 1 floats), xs (rows padded to P + 1), dt and
// cum are staged in shared memory, B, C and x with 16-byte loads all issued
// before any is stored (cum summed in order by one thread); each product is
// register-blocked (y_off and y as 8 rows x 4 columns a thread, the new
// state 4 x 8, C.B^T 8 x 8), so a thread reads 12 to 16 shared values per
// 32 to 64 FMAs; the masked C.B^T is written over B and C (Q x Q floats,
// 64 KB at Q = 128, above the default 48 KB, so the kernel opts in to more
// shared memory); then y = y_off + M.xs is written once.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;   // 16 x 16: (ty, tx)
constexpr int kMaxQ = 128;      // chunk rows ty + 16 i, i < 8
constexpr int kMaxP = 64;       // head width: 16 j + tx (j < 4) or ty + 16 i (i < 4)
constexpr int kMaxN = 128;      // state width: tx + 16 j, j < 8

// Stage rows 0..Q-1 of a (rows x W) tile (row stride ld elements) in shared
// memory as floats, dst[r * dld + c], times rscale[r * rld] where given;
// rows nv..Q-1 are zeros. 16-byte loads, all of a thread's issued before
// any is stored; consecutive threads take consecutive rows, so the stores
// of rows padded to an odd stride do not conflict.
__device__ __forceinline__ void stage(const float* __restrict__ src,
                                      long long ld, int nv, int Q, int W,
                                      float* dst, int dld,
                                      const float* rscale, long long rld) {
  constexpr int E = 4;   // floats in a 16-byte load
  constexpr int kMaxU = kMaxQ * kMaxN / (E * kThreads);
  const int cw = W / E, n = Q * cw;
  uint4 buf[kMaxU];
  float sc[kMaxU];
#pragma unroll
  for (int u = 0; u < kMaxU; ++u) {
    const int i = threadIdx.x + u * kThreads;
    const int r = i % Q, j = i / Q;
    const bool in = i < n && r < nv;
    buf[u] = in ? *reinterpret_cast<const uint4*>(src + r * ld + j * E)
                : make_uint4(0u, 0u, 0u, 0u);
    sc[u] = (in && rscale != nullptr) ? rscale[r * rld] : 1.0f;
  }
#pragma unroll
  for (int u = 0; u < kMaxU; ++u) {
    const int i = threadIdx.x + u * kThreads;
    if (i < n) {
      const int r = i % Q, j = i / Q;
      const float f[E] = {__uint_as_float(buf[u].x), __uint_as_float(buf[u].y),
                          __uint_as_float(buf[u].z), __uint_as_float(buf[u].w)};
#pragma unroll
      for (int e = 0; e < E; ++e) dst[r * dld + j * E + e] = f[e] * sc[u];
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ bm, const float* __restrict__ cm,
                const float* __restrict__ a, float* __restrict__ y,
                float* __restrict__ final_state, int S, int H, int P, int N,
                int Q, long long x_sb, long long x_ss, long long x_sh,
                long long b_sb, long long b_ss, long long c_sb,
                long long c_ss) {
  extern __shared__ float4 smem4[];
  const int N1 = N + 1, P1 = P + 1;
  float* sState = reinterpret_cast<float*>(smem4);  // [P][N + 1]
  float* sX = sState + P * N1;                       // [Q][P + 1] xs = x * dt
  float* sDt = sX + Q * P1;                          // [Q]
  float* sCum = sDt + Q;                             // [Q]
  float* sW = sCum + Q;                              // [Q] exp(cum_end - cum_t)
  float* sB = sW + Q;                                // [Q][N + 1]
  float* sC = sB + Q * N1;                           // [Q][N + 1]
  float* sM = sB;                                    // [Q][Q] over B and C

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int h = blockIdx.x, b = blockIdx.y;
  const float ah = a[h];
  const float* xb = x + b * x_sb + h * x_sh;
  const float* bb = bm + b * b_sb;
  const float* cb = cm + b * c_sb;
  const float* dtb = dt + static_cast<size_t>(b) * S * H + h;
  float* yb = y + (static_cast<size_t>(b) * S * H + h) * P;
  // this thread's rows and columns, clamped for the loads (results at
  // clamped indices are computed and dropped)
  int qi[8], pj[4], pi[4], nj[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    qi[i] = min(ty + 16 * i, Q - 1);
    nj[i] = min(tx + 16 * i, N - 1);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    pj[j] = min(tx + 16 * j, P - 1);
    pi[j] = min(ty + 16 * j, P - 1);
  }

  for (int i = tid; i < P * N1; i += kThreads) sState[i] = 0.0f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int nv = min(Q, S - c0);
    __syncthreads();   // the last chunk is done with every buffer
    stage(bb + c0 * b_ss, b_ss, nv, Q, N, sB, N1, nullptr, 0);
    stage(cb + c0 * c_ss, c_ss, nv, Q, N, sC, N1, nullptr, 0);
    stage(xb + c0 * x_ss, x_ss, nv, Q, P, sX, P1,
          dtb + static_cast<size_t>(c0) * H, H);
    for (int r = tid; r < Q; r += kThreads)
      sDt[r] = r < nv ? dtb[static_cast<size_t>(c0 + r) * H] : 0.0f;
    __syncthreads();
    if (tid == 0) {   // cum = cumsum(dt * a), in order
      float run = 0.0f;
      for (int r = 0; r < Q; ++r) {
        run += sDt[r] * ah;
        sCum[r] = run;
      }
    }
    __syncthreads();
    const float cum_end = sCum[Q - 1];
    for (int t = tid; t < Q; t += kThreads) sW[t] = expf(cum_end - sCum[t]);
    __syncthreads();

    // y_off[q][p] = exp(cum_q) * (C_q . state_p), q = ty + 16 i, p = tx + 16 j
    float yo[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) yo[i][j] = 0.0f;
    for (int n = 0; n < N; ++n) {
      float cv[8], sv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) cv[i] = sC[qi[i] * N1 + n];
#pragma unroll
      for (int j = 0; j < 4; ++j) sv[j] = sState[pj[j] * N1 + n];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) yo[i][j] = fmaf(cv[i], sv[j], yo[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float e = expf(sCum[qi[i]]);
#pragma unroll
      for (int j = 0; j < 4; ++j) yo[i][j] = e * yo[i][j];
    }
    // state'[p][n] = exp(cum_end) * state + sum_t (xs[t][p] * w[t]) * B[t][n],
    // p = ty + 16 i, n = tx + 16 j
    float ns[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) ns[i][j] = 0.0f;
    for (int t = 0; t < Q; ++t) {
      const float w = sW[t];
      float xw[4], bv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) xw[i] = sX[t * P1 + pi[i]] * w;
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = sB[t * N1 + nj[j]];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) ns[i][j] = fmaf(xw[i], bv[j], ns[i][j]);
    }
    const float e_end = expf(cum_end);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        ns[i][j] = e_end * sState[pi[i] * N1 + nj[j]] + ns[i][j];
    // G = C.B^T, q = ty + 16 i, t = tx + 16 j, masked with the decay
    float g[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) g[i][j] = 0.0f;
    for (int n = 0; n < N; ++n) {
      float cv[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        cv[i] = sC[qi[i] * N1 + n];
        bv[i] = sB[min(tx + 16 * i, Q - 1) * N1 + n];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) g[i][j] = fmaf(cv[i], bv[j], g[i][j]);
    }
    __syncthreads();   // every read of B, C and the old state is done
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int qq = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int t = tx + 16 * j;
        if (qq < Q && t < Q)
          sM[qq * Q + t] = t <= qq ? g[i][j] * expf(sCum[qq] - sCum[t]) : 0.0f;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (ty + 16 * i < P && tx + 16 * j < N)
          sState[(ty + 16 * i) * N1 + tx + 16 * j] = ns[i][j];
    __syncthreads();
    // y = y_diag + y_off, y_diag[q][p] = sum_t M[q][t] xs[t][p] (M is 0 above
    // the diagonal)
    float yd[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) yd[i][j] = 0.0f;
    for (int t = 0; t < Q; ++t) {
      float mv[8], xv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) mv[i] = sM[qi[i] * Q + t];
#pragma unroll
      for (int j = 0; j < 4; ++j) xv[j] = sX[t * P1 + pj[j]];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) yd[i][j] = fmaf(mv[i], xv[j], yd[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int qq = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = tx + 16 * j;
        if (qq < nv && p < P)
          yb[static_cast<size_t>(c0 + qq) * H * P + p] = yd[i][j] + yo[i][j];
      }
    }
  }
  __syncthreads();
  float* fb = final_state + (static_cast<size_t>(b) * H + h) * P * N;
  for (int i = tid; i < P * N; i += kThreads) fb[i] = sState[(i / N) * N1 + i % N];
}

size_t smem_bytes(int P, int N, int Q) {
  const size_t n1 = static_cast<size_t>(N) + 1;
  const size_t bc = 2 * static_cast<size_t>(Q) * n1;
  const size_t qq = static_cast<size_t>(Q) * Q;
  return sizeof(float) * (P * n1 + static_cast<size_t>(Q) * (P + 1) + 3 * Q +
                          (bc > qq ? bc : qq));
}

// ------------------------------------------------------------------------
// The bf16 path on the tensor cores (mma.sync m16n8k16, bf16 operands, fp32
// accumulators), 8 warps a block. Per chunk, thread 0 has TMA bring the
// next chunk's B and x (a two-stage ring, one mbarrier a stage) and, once
// every warp holds its C fragments, the next C (one slot); warp 0 brings
// dt with cp.async and computes cum (lane 0, in order) and w dt = exp(cum_end
// - cum) dt. Tiles have 128-byte rows in TMA's 128-byte swizzle, so
// ldmatrix reads 8 rows without bank conflicts.
//
// Each warp owns 16 chunk rows: m-tiles 0-3 for warps 0-3 and 7-4 for
// warps 4-7, so the two warps of a scheduler share 9 causal key tiles.
//   y_off = C.state^T (C from registers, the state's hi, mid and lo
//   passes),
//   scaled per row by exp(cum_q);
//   for each causal key tile kk: G = C.B^T (the next tile's issued before
//   this tile's M.x), M = G exp(cum_q - cum_t) dt_t built from G's
//   accumulators (on the diagonal tile only t <= q is kept, by selection,
//   since exp above the diagonal may overflow), split hi + mid + lo in
//   registers and used as the A operand of y += M.x (x as it is, exact in
//   bf16).
// Then warp w updates state rows 16 (w % 4) .., columns (w / 4) N / 2 ..
// in registers, state = exp(cum_end) state + (x^T w dt, split hi + mid +
// lo).B, and writes its hi/mid/lo split for the next chunk's C.state^T.
// Every fp32 operand (M, the state, x w dt) runs as three bf16 passes: hi,
// then mid, the bf16 of what hi leaves over, then lo, the bf16 of what mid
// leaves over. Each bf16 holds 8 significant bits, so the three keep ~24
// bits of the fp32 operand, which is fp32's own precision: the scan is
// fp32 math, as the reference's (src/repro/models/ssm.py: "All SSD math
// runs in fp32"). C.B^T takes one pass (both operands are bf16 inputs);
// every sum stays fp32.

constexpr int kTcWarps = 8;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcP = 64;   // x tiles and state rows, P zero-padded to 64

// Shared memory of the bf16 kernel. B, C, x and the state's hi/mid/lo split
// are tiles of 128-byte rows (64 bf16 columns), N = 128 as two such tiles;
// dt, cum and w dt have a buffer per stage, as cum and w dt are computed a
// chunk ahead.
template <int NT>
struct TcPlan {
  static constexpr int kSub = kMaxQ * 128;          // 64 columns of a chunk
  static constexpr int kBTile = (NT / 64) * kSub;   // B or C
  static constexpr int kX = kBTile;                 // x within a stage
  static constexpr int kStage = kX + kSub;          // B and x, by TMA
  static constexpr int kC = 2 * kStage;
  static constexpr int kStateSub = kTcP * 128;      // 64 state columns
  static constexpr int kStateHalf = (NT / 64) * kStateSub;
  static constexpr int kState = kC + kBTile;        // hi, mid, then lo
  static constexpr int kDt = kState + 3 * kStateHalf;   // [2][kMaxQ] fp32
  static constexpr int kCum = kDt + 2 * 4 * kMaxQ;   // [2][kMaxQ] fp32
  static constexpr int kWdt = kCum + 2 * 4 * kMaxQ;  // [2][kMaxQ] fp32
  static constexpr int kBar = kWdt + 2 * 4 * kMaxQ;  // full[2], C full
  // and slack to align the base to 1024 bytes (TMA's 128-byte swizzle)
  static constexpr int kBytes = kBar + 3 * 8 + 1024;
  static constexpr int kMinBlocks = kBytes <= 113 * 1024 ? 2 : 1;
};

// ---- PTX wrappers
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
// wait until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// the box at (c0, c1, c2[, c3]) of a 3-D or 4-D tensor map, completing on bar
__device__ __forceinline__ void tma_load_3d(unsigned dst, const CUtensorMap* map,
                                            unsigned bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(unsigned dst, const CUtensorMap* map,
                                            unsigned bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void cp_async4(unsigned dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned addr, unsigned* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// d += a.b, a 16 x 16 (row), b 16 x 8 (col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d += a0.b0 + a1.b1 + a2.b2, three passes of one fp32 product (hi, mid,
// lo)
__device__ __forceinline__ void mma_sum3(float* d, const unsigned* a0,
                                         unsigned b00, unsigned b01,
                                         const unsigned* a1, unsigned b10,
                                         unsigned b11, const unsigned* a2,
                                         unsigned b20, unsigned b21) {
  mma_bf16(d, a0, b00, b01);
  mma_bf16(d, a1, b10, b11);
  mma_bf16(d, a2, b20, b21);
}
// two floats as bf16x2, round to nearest; `lo` in the low half
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  unsigned r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
// e^v, flushing results below 2^-126 to zero
__device__ __forceinline__ float exp_ftz(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(v * 1.4426950408889634f));
  return r;
}
// ---- end PTX wrappers

__device__ __forceinline__ float bf16_lo(unsigned u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned u) {
  return __uint_as_float(u & 0xffff0000u);
}
// (v0, v1) as bf16x2 hi, mid, the bf16x2 of what hi leaves over, and lo,
// the bf16x2 of what mid leaves over (both remainders are exact in fp32)
__device__ __forceinline__ void split3(float v0, float v1, unsigned& hi,
                                       unsigned& mid, unsigned& lo) {
  hi = pack_bf16x2(v0, v1);
  const float r0 = v0 - bf16_lo(hi), r1 = v1 - bf16_hi(hi);
  mid = pack_bf16x2(r0, r1);
  lo = pack_bf16x2(r0 - bf16_lo(mid), r1 - bf16_hi(mid));
}
// byte offset of (row, col) in a tile of 128-byte rows, 64 columns per `sub`
// bytes, each 16-byte unit XOR-swizzled by the row's low three bits (TMA's
// 128-byte swizzle), so ldmatrix reads 8 rows without bank conflicts
__device__ __forceinline__ unsigned toff(int row, int col, int sub) {
  return (col >> 6) * sub + row * 128 + ((((col >> 3) ^ row) & 7) << 4) +
         (col & 7) * 2;
}
// a lane's offset `off` moved right by `units` 16-byte units, where the
// lane's own unit and units % 8 share no bits
__device__ __forceinline__ unsigned toff_add(unsigned off, int units,
                                             int sub) {
  return (off ^ ((units & 7) << 4)) + (units >> 3) * sub;
}

template <int NT>
__global__ void __launch_bounds__(kTcThreads, TcPlan<NT>::kMinBlocks)
ssd_scan_tc_kernel(const __grid_constant__ CUtensorMap tx,
                   const __grid_constant__ CUtensorMap tb,
                   const __grid_constant__ CUtensorMap tc,
                   const float* __restrict__ dt, const float* __restrict__ a,
                   float* __restrict__ y, float* __restrict__ final_state,
                   int S, int H, int P, int N, int Q) {
  using L = TcPlan<NT>;
  constexpr int kSub = L::kSub, kSSub = L::kStateSub;
  constexpr int kKt = NT / 16;         // k tiles over N
  constexpr int kNh = NT / 16;         // state n tiles of 8 per warp
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* const smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const unsigned sbase = smem_u32(smem);
  float* const sCum0 = reinterpret_cast<float*>(smem + L::kCum);
  float* const sWdt0 = reinterpret_cast<float*>(smem + L::kWdt);
  const unsigned bar_c = sbase + L::kBar + 16;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;          // fragment row, column pair
  const int lr = lane & 7, lm = lane >> 3;         // ldmatrix row, matrix
  const int h = blockIdx.x, b = blockIdx.y;
  const int QT = (Q + 15) & ~15, MT = QT / 16;
  const int nchunks = (S + Q - 1) / Q;
  const float ah = a[h];
  const float* const dtb = dt + static_cast<size_t>(b) * S * H + h;
  constexpr unsigned kTileTx = 128u * (NT / 64 + 1);   // bytes a row, B and x

  // thread 0: B and x of the chunk at c0 into stage s; C into its slot
  auto issue_stage = [&](int s, int c0) {
    const unsigned dst = sbase + s * L::kStage, bar = sbase + L::kBar + 8 * s;
    mbar_expect_tx(bar, kTileTx * Q);
#pragma unroll
    for (int k = 0; k < NT / 64; ++k)
      tma_load_3d(dst + k * kSub, &tb, bar, 64 * k, c0, b);
    tma_load_4d(dst + L::kX, &tx, bar, 0, h, c0, b);
  };
  auto issue_c = [&](int c0) {
    mbar_expect_tx(bar_c, 128u * (NT / 64) * Q);
#pragma unroll
    for (int k = 0; k < NT / 64; ++k)
      tma_load_3d(sbase + L::kC + k * kSub, &tc, bar_c, 64 * k, c0, b);
  };
  // warp 0: dt of the chunk at c0 into its stage (rows >= nv read as 0)
  auto load_dt = [&](int s, int c0) {
    const int nv = min(Q, S - c0);
    for (int r = lane; r < QT; r += 32)
      cp_async4(sbase + L::kDt + 4 * (s * kMaxQ + r),
                dtb + (r < nv ? static_cast<size_t>(c0 + r) * H : 0), r < nv);
    cp_async_commit();
  };

  // warp 0: cum = cumsum(dt a) of the chunk whose dt is in stage s, in
  // order and rounding each product and sum as the plain version does (a
  // parallel scan rounds the running sums otherwise, and exp(cum_q -
  // cum_t) carries that error at every pair), then w dt = exp(cum_end -
  // cum) dt; lane 0 runs the chain, in the slack of warp 0, whose rows
  // have the fewest causal key tiles
  auto scan_dt = [&](int s) {
    const float* const d = reinterpret_cast<const float*>(smem + L::kDt) +
                           s * kMaxQ;
    float* const cum = sCum0 + s * kMaxQ;
    if (lane == 0) {
      float run = 0.0f;
#pragma unroll 8
      for (int r = 0; r < QT; ++r) {
        run = __fadd_rn(run, __fmul_rn(d[r], ah));
        cum[r] = run;
      }
    }
    __syncwarp();
    const float cend = cum[QT - 1];
    for (int r = lane; r < kMaxQ; r += 32)
      sWdt0[s * kMaxQ + r] = r < QT ? exp_ftz(cend - cum[r]) * d[r] : 0.0f;
  };

  // the state: this warp's rows 16 pm + g (+ 8), columns n0 + 8 j + 2 t4;
  // its hi/mid/lo split starts at zero, as do the tile rows Q..QT-1 that
  // no load writes
  const int pm = warp & 3, n0 = (warp >> 2) * (NT / 2);
  float st[kNh][4];
#pragma unroll
  for (int j = 0; j < kNh; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) st[j][e] = 0.0f;
  for (int i = tid; i < 3 * L::kStateHalf / 16; i += kTcThreads)
    reinterpret_cast<uint4*>(smem + L::kState)[i] = make_uint4(0, 0, 0, 0);
  if (Q < QT) {
    const int tiles = 2 * (NT / 64 + 1) + NT / 64, per = (QT - Q) * 8;
    for (int i = tid; i < tiles * per; i += kTcThreads) {
      const int t = i / per, r = Q + (i % per) / 8, u = i % 8;
      *reinterpret_cast<uint4*>(smem + t * kSub + r * 128 + u * 16) =
          make_uint4(0, 0, 0, 0);
    }
  }
  if (tid == 0) {
    mbar_init(sbase + L::kBar, 1);
    mbar_init(sbase + L::kBar + 8, 1);
    mbar_init(bar_c, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    issue_stage(0, 0);
    issue_c(0);
  }
  if (warp == 0) load_dt(0, 0);

  // this warp's 16 chunk rows: m-tiles 0-3 and 7-4, so that the warps w and
  // w + 4 of a scheduler share 9 causal key tiles
  const int mt = warp < 4 ? warp : 11 - warp, q0 = 16 * mt;
  // per-lane ldmatrix offsets at key tile 0; tile kk adds kk 16 rows (the
  // swizzle depends on the row's low three bits only)
  const unsigned oB = toff(lr + 8 * (lm >> 1), 8 * (lm & 1), kSub);
  const unsigned oXd = toff(lr + 8 * (lm & 1), 8 * (lm >> 1), kSub);
  const unsigned oXs = toff(lr + 8 * (lm >> 1), 16 * pm + 8 * (lm & 1), kSub);
  const unsigned oBs = toff(lr + 8 * (lm & 1), n0 + 8 * (lm >> 1), kSub);
  for (int c = 0; c < nchunks; ++c) {
    const int c0 = c * Q, nv = min(Q, S - c0), s = c & 1;
    const unsigned stg = sbase + s * L::kStage;
    const float* sDt =
        reinterpret_cast<const float*>(smem + L::kDt) + s * kMaxQ;
    const float* const sCum = sCum0 + s * kMaxQ;
    const float* const sWdt = sWdt0 + s * kMaxQ;
    __syncthreads();   // the last chunk is done with stage s ^ 1
    if (tid == 0 && c + 1 < nchunks) issue_stage(s ^ 1, c0 + Q);

    // warp 0: the first chunk's cum (later chunks' are computed a chunk
    // ahead), then the next chunk's dt into the stage the last chunk used
    if (warp == 0) {
      if (c == 0) {
        cp_async_wait_all();
        __syncwarp();
        scan_dt(0);
      }
      if (c + 1 < nchunks) load_dt(s ^ 1, c0 + Q);
    }
    mbar_wait(sbase + L::kBar + 8 * s, (c >> 1) & 1);   // B and x landed
    mbar_wait(bar_c, c & 1);                             // C landed

    // this warp's C rows as A fragments, one per k tile over N
    unsigned cf[kKt][4];
    float yacc[8][4];
    if (mt < MT) {
#pragma unroll
      for (int kt = 0; kt < kKt; ++kt)
        ldsm_x4(sbase + L::kC +
                    toff(q0 + lr + 8 * (lm & 1), 16 * kt + 8 * (lm >> 1), kSub),
                cf[kt]);
      // y_off = C.state^T, the state's hi, mid and lo passes
      const unsigned shi = sbase + L::kState, smid = shi + L::kStateHalf,
                     slo = smid + L::kStateHalf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[j][e] = 0.0f;
#pragma unroll
      for (int kt = 0; kt < kKt; ++kt)
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          const unsigned off = 16 * np * 128 + toff_add(oB, 2 * kt, kSSub);
          unsigned bh[4], bm[4], bl[4];
          ldsm_x4(shi + off, bh);
          ldsm_x4(smid + off, bm);
          ldsm_x4(slo + off, bl);
          mma_sum3(yacc[2 * np], cf[kt], bh[0], bh[1], cf[kt], bm[0], bm[1],
                   cf[kt], bl[0], bl[1]);
          mma_sum3(yacc[2 * np + 1], cf[kt], bh[2], bh[3], cf[kt], bm[2],
                   bm[3], cf[kt], bl[2], bl[3]);
        }
    }
    __syncthreads();   // cum ready; every warp holds its C fragments
    if (tid == 0 && c + 1 < nchunks) issue_c(c0 + Q);

    if (mt < MT) {
      const float cq0 = sCum[q0 + g], cq1 = sCum[q0 + g + 8];
      {
        const float e0 = exp_ftz(cq0), e1 = exp_ftz(cq1);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          yacc[j][0] *= e0;
          yacc[j][1] *= e0;
          yacc[j][2] *= e1;
          yacc[j][3] *= e1;
        }
      }
      // G = C.B^T of key tile kk
      auto c_bt = [&](int kk, float (&gt)[2][4]) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) gt[j][e] = 0.0f;
        const unsigned base = stg + kk * 16 * 128;
#pragma unroll
        for (int kt = 0; kt < kKt; ++kt) {
          unsigned bf[4];
          ldsm_x4(base + toff_add(oB, 2 * kt, kSub), bf);
          mma_bf16(gt[0], cf[kt], bf[0], bf[1]);
          mma_bf16(gt[1], cf[kt], bf[2], bf[3]);
        }
      };
      // y += M.x over the causal key tiles, M = G exp(cum_q - cum_t) dt_t
      float gt[2][4];
      c_bt(0, gt);
      for (int kk = 0; kk <= mt; ++kk) {
        const int t0 = 16 * kk;
        float gn[2][4];
        if (kk < mt) c_bt(kk + 1, gn);   // the next tile's G in flight
        // A fragments (rows g, k 0-7), (g + 8, 0-7), (g, 8-15), (g + 8, 8-15)
        unsigned mhi[4], mmid[4], mlo[4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int t = t0 + 8 * j + 2 * t4;
          const float2 ct = *reinterpret_cast<const float2*>(sCum + t);
          const float2 dtt = *reinterpret_cast<const float2*>(sDt + t);
          float m[4] = {gt[j][0] * exp_ftz(cq0 - ct.x) * dtt.x,
                        gt[j][1] * exp_ftz(cq0 - ct.y) * dtt.y,
                        gt[j][2] * exp_ftz(cq1 - ct.x) * dtt.x,
                        gt[j][3] * exp_ftz(cq1 - ct.y) * dtt.y};
          if (kk == mt) {   // the diagonal tile: t <= q only (the exponent
                            // above it may overflow, so select, not scale)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (8 * j + 2 * t4 + (e & 1) > g + 8 * (e >> 1)) m[e] = 0.0f;
          }
          split3(m[0], m[1], mhi[2 * j], mmid[2 * j], mlo[2 * j]);
          split3(m[2], m[3], mhi[2 * j + 1], mmid[2 * j + 1], mlo[2 * j + 1]);
        }
        const unsigned xt = stg + L::kX + kk * 16 * 128;
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          unsigned bf[4];
          ldsm_x4_t(xt + toff_add(oXd, 2 * np, kSub), bf);
          mma_sum3(yacc[2 * np], mhi, bf[0], bf[1], mmid, bf[0], bf[1], mlo,
                   bf[0], bf[1]);
          mma_sum3(yacc[2 * np + 1], mhi, bf[2], bf[3], mmid, bf[2], bf[3],
                   mlo, bf[2], bf[3]);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) gt[j][e] = gn[j][e];
      }
      // y rows < nv, columns < P
      float* const yb = y + (static_cast<size_t>(b) * S * H + h) * P;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q = q0 + g + 8 * half;
        if (q >= nv) continue;
        float* row = yb + static_cast<size_t>(c0 + q) * H * P;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (8 * j < P)
            *reinterpret_cast<float2*>(row + 8 * j + 2 * t4) =
                make_float2(yacc[j][2 * half], yacc[j][2 * half + 1]);
      }
    }

    // state = exp(cum_end) state + (x^T w dt).B, then its hi/mid/lo split
    {
      const float eend = exp_ftz(sCum[QT - 1]);
#pragma unroll
      for (int j = 0; j < kNh; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] *= eend;
      for (int kt = 0; kt < MT; ++kt) {
        const int t0 = 16 * kt;
        unsigned xa[4], ahi[4], amid[4], alo[4];
        ldsm_x4_t(stg + L::kX + oXs + t0 * 128, xa);
        const float2 w0 = *reinterpret_cast<const float2*>(sWdt + t0 + 2 * t4);
        const float2 w1 =
            *reinterpret_cast<const float2*>(sWdt + t0 + 8 + 2 * t4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 w = i < 2 ? w0 : w1;
          split3(bf16_lo(xa[i]) * w.x, bf16_hi(xa[i]) * w.y, ahi[i], amid[i],
                 alo[i]);
        }
        const unsigned bt = stg + t0 * 128;
#pragma unroll
        for (int jj = 0; jj < kNh / 2; ++jj) {
          unsigned bf[4];
          ldsm_x4_t(bt + toff_add(oBs, 2 * jj, kSub), bf);
          mma_sum3(st[2 * jj], ahi, bf[0], bf[1], amid, bf[0], bf[1], alo,
                   bf[0], bf[1]);
          mma_sum3(st[2 * jj + 1], ahi, bf[2], bf[3], amid, bf[2], bf[3], alo,
                   bf[2], bf[3]);
        }
      }
      unsigned char* const shi = smem + L::kState;
#pragma unroll
      for (int j = 0; j < kNh; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          unsigned hi, mid, lo;
          split3(st[j][2 * half], st[j][2 * half + 1], hi, mid, lo);
          const unsigned off =
              toff(16 * pm + g + 8 * half, n0 + 8 * j + 2 * t4, kSSub);
          *reinterpret_cast<unsigned*>(shi + off) = hi;
          *reinterpret_cast<unsigned*>(shi + L::kStateHalf + off) = mid;
          *reinterpret_cast<unsigned*>(shi + 2 * L::kStateHalf + off) = lo;
        }
    }

    // warp 0: the next chunk's cum and w dt, while the warps with more
    // causal key tiles finish this chunk
    if (warp == 0 && c + 1 < nchunks) {
      cp_async_wait_all();
      __syncwarp();
      scan_dt(s ^ 1);
    }
  }

  // the final state, rows < P and columns < N
  float* const fb = final_state + (static_cast<size_t>(b) * H + h) * P * N;
#pragma unroll
  for (int j = 0; j < kNh; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = 16 * pm + g + 8 * half, n = n0 + 8 * j + 2 * t4;
      if (p < P && n < N)
        *reinterpret_cast<float2*>(fb + p * N + n) =
            make_float2(st[j][2 * half], st[j][2 * half + 1]);
    }
}

// ---------------------------------------------------------------- backward
// K6's backward: the VJP of the scan above (the reference takes it by
// autodiff of src/repro/models/ssm.py::_ssd_chunked; the TPU kernel has
// none). Its chunked form is mamba_ssm's ssd_combined backward (state
// passing, chunk state, chunk scan). fp32 runs ssd_scan_bwd_kernel below:
// one block per (head, sequence), 256 threads as 16 x 16, in fp32 FMA on
// the CUDA cores (the tensor cores would round to TF32). bf16 runs the
// chunk-parallel kernels on the tensor cores further down (ssd_bwd_*).
//
// First a forward walk over the chunks recomputes each chunk's entry state
// and writes it to device scratch (B, H, chunks, P, N) fp32: the forward
// kernels keep the state on chip (the bf16 one in mma fragments), so a
// serving launch stays the same code and writes nothing more. Then a
// reverse walk carries dS, the gradient of the state leaving the chunk,
// from dfinal (zero if none) in shared memory, and per chunk, with
// L[t][k] = exp(cum_t - cum_k) for k <= t, M = (C B^T) o L, D[t][k] =
// dt_k (dy_t . x_k) and w_k = exp(cum_end - cum_k):
//   dxs = M^T dy + diag(w) B dS^T               (dx = dxs dt)
//   dC  = (D o L) B + diag(exp(cum)) dy prev
//   dB  = (D o L)^T C + diag(w dt) x dS
//   dcum_t = rowsum(M o D)_t - colsum(M o D)_t + exp(cum_t) dy_t . (prev C_t)
//            - U_t, U_k = w_k dt_k x_k^T dS B_k, and on the chunk's last
//            row + sum_k U_k + exp(cum_end) <dS, prev>
//   dda = reverse cumsum(dcum); ddt = dda a + dxs . x; da_h = sum dda dt
//   dS <- exp(cum_end) dS + (dy o exp(cum))^T C   (the previous chunk's)
// dB and dC are sums over heads (B and C are shared by the H heads) and da
// over sequences and chunks: each block writes its own partials (B, S, H,
// N) and (B, H, chunks) in fp32, and a second kernel adds them in a fixed
// order, so there are no atomics and a repeat is bitwise.
//
// What bounds it on an H100: at mamba2-780m's training shape (B = 8, S =
// 1024, H = 48, P = 64, N = 128, Q = 128, bf16) the products it needs are
// 51.8 GFLOP over the causal pairs, 0.77 ms at the fp32 CUDA-core rate and
// 0.157 ms at the bf16 tensor rate with each fp32 operand in three passes,
// against 0.064 ms for its 213 MB of bytes: so operations. The fp32 kernel
// computes the whole (t, k) square in fp32 FMA, the simple design.
// Shared memory holds x, dy, the Q x Q matrix (M, then D o L), dS and
// 32-column tiles of B, C and prev (212 KB at that shape, one block an
// SM); each product is register-blocked (8 x 8, 8 x 4 or 8 x 2 a thread)
// as the fp32 forward's are.
constexpr int kBwdNT = 32;   // state columns a tile of B, C and prev

__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Stage rows 0..Q-1 of W columns (row stride ld elements) as floats in
// dst[r * dld + j]; zeros at rows >= nv and columns >= lim.
__device__ __forceinline__ void stage_rows(const float* src, long long ld,
                                           int nv, int Q, int W, int lim,
                                           float* dst, int dld) {
  for (int i = threadIdx.x; i < Q * W; i += kThreads) {
    const int r = i / W, j = i % W;
    dst[r * dld + j] = (r < nv && j < lim) ? src[r * ld + j] : 0.0f;
  }
}

template <typename T>
struct BwdArgs {
  const T* x;           // (B, S, H, P), strides x_sb, x_ss, x_sh
  const float* dt;      // (B, S, H)
  const T* bm;          // (B, S, N), strides b_sb, b_ss
  const T* cm;          // (B, S, N), strides c_sb, c_ss
  const float* a;       // (H,)
  const float* dy;      // (B, S, H, P)
  const float* dfinal;  // (B, H, P, N) or null
  float* prevs;         // scratch (B, H, chunks, P, N): chunk-entry states
  float* dstates;       // bf16 only: scratch (B, H, chunks, P, N), dS
  T* dx;                // (B, S, H, P)
  float* ddt;           // (B, S, H)
  float* dbp;           // partials (B, S, H, N)
  float* dcp;           // partials (B, S, H, N)
  float* dap;           // partials (B, H, chunks); bf16: cum_end first
  int S, H, P, N, Q;
  long long x_sb, x_ss, x_sh, b_sb, b_ss, c_sb, c_ss;
};

size_t bwd_smem_bytes(int P, int N, int Q) {
  const size_t q = Q, p = P, t1 = kBwdNT + 1;
  return sizeof(float) * (2 * q * (p + 1) + q * (q + 1) + p * (N + 1) +
                          2 * q * t1 + p * t1 + 6 * q + kThreads);
}

__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_bwd_kernel(const BwdArgs<float> g) {
  extern __shared__ float4 smem4[];
  const int S = g.S, H = g.H, P = g.P, N = g.N, Q = g.Q;
  const int P1 = P + 1, N1 = N + 1, Q1 = Q + 1, T1 = kBwdNT + 1;
  float* sX = reinterpret_cast<float*>(smem4);  // [Q][P + 1] x
  float* sDy = sX + Q * P1;                      // [Q][P + 1] dy
  float* sQQ = sDy + Q * P1;                     // [Q][Q + 1] M, then D o L
  float* sS = sQQ + Q * Q1;                      // [P][N + 1] state, then dS
  float* sBt = sS + P * N1;                      // [Q][NT + 1] B tile
  float* sCt = sBt + Q * T1;                     // [Q][NT + 1] C tile
  float* sPv = sCt + Q * T1;                     // [P][NT + 1] prev tile
  float* sDt = sPv + P * T1;                     // [Q] dt
  float* sCum = sDt + Q;                         // [Q] cum
  float* sW = sCum + Q;                          // [Q] w (forward: w dt)
  float* sE = sW + Q;                            // [Q] exp(cum)
  float* sDc = sE + Q;                           // [Q] dcum, then dda
  float* sU = sDc + Q;                           // [Q] U
  float* sRed = sU + Q;                          // [kThreads] <dS, prev>
  // between tiles, sBt and sCt hold [Q][16] partial sums (one per tx)
  float* sPartA = sBt;
  float* sPartB = sCt;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int h = blockIdx.x, b = blockIdx.y;
  const int nc = (S + Q - 1) / Q;
  const float ah = g.a[h];
  const float* xb = g.x + b * g.x_sb + h * g.x_sh;
  const float* bb = g.bm + b * g.b_sb;
  const float* cb = g.cm + b * g.c_sb;
  const float* dtb = g.dt + static_cast<size_t>(b) * S * H + h;
  const float* dyb = g.dy + (static_cast<size_t>(b) * S * H + h) * P;
  const long long dy_ld = static_cast<long long>(H) * P;
  float* prevb = g.prevs + (static_cast<size_t>(b) * H + h) * nc * P * N;
  // this thread's rows (ty + 16 i) and columns (tx + 16 j) of a Q x Q
  // tile, of P and of a state tile, clamped for the loads (results at
  // clamped indices are computed and dropped)
  int qi[8], qk[8], pj[4], pi[4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    qi[i] = min(ty + 16 * i, Q - 1);
    qk[i] = min(tx + 16 * i, Q - 1);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    pj[j] = min(tx + 16 * j, P - 1);
    pi[j] = min(ty + 16 * j, P - 1);
  }
  // cum = cumsum(dt a) in order, by one thread
  auto scan_cum = [&]() {
    if (tid == 0) {
      float run = 0.0f;
      for (int r = 0; r < Q; ++r) {
        run += sDt[r] * ah;
        sCum[r] = run;
      }
    }
  };

  // ---- forward walk: the chunk-entry states
  for (int i = tid; i < P * N1; i += kThreads) sS[i] = 0.0f;
  for (int c = 0; c < nc; ++c) {
    const int c0 = c * Q, nv = min(Q, S - c0);
    __syncthreads();   // the last chunk is done with every buffer
    stage_rows(xb + c0 * g.x_ss, g.x_ss, nv, Q, P, P, sX, P1);
    for (int r = tid; r < Q; r += kThreads)
      sDt[r] = r < nv ? dtb[static_cast<size_t>(c0 + r) * H] : 0.0f;
    float* pv = prevb + static_cast<size_t>(c) * P * N;
    for (int i = tid; i < P * N; i += kThreads)
      pv[i] = sS[(i / N) * N1 + i % N];
    __syncthreads();
    scan_cum();
    __syncthreads();
    const float cum_end = sCum[Q - 1], e_end = expf(cum_end);
    for (int t = tid; t < Q; t += kThreads)
      sW[t] = expf(cum_end - sCum[t]) * sDt[t];
    for (int n0 = 0; n0 < N; n0 += kBwdNT) {
      const int wn = min(kBwdNT, N - n0);
      __syncthreads();
      stage_rows(bb + c0 * g.b_ss + n0, g.b_ss, nv, Q, kBwdNT, wn, sBt, T1);
      __syncthreads();
      // state[p][n] = e_end state + sum_t x[t][p] (w dt)[t] B[t][n],
      // p = ty + 16 i, n = n0 + tx + 16 j
      float acc[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = 0.0f;
      for (int t = 0; t < Q; ++t) {
        const float w = sW[t];
        float xv[4], bv[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = sX[t * P1 + pi[i]] * w;
#pragma unroll
        for (int j = 0; j < 2; ++j) bv[j] = sBt[t * T1 + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) acc[i][j] = fmaf(xv[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int p = ty + 16 * i, n = tx + 16 * j;
          if (p < P && n < wn) {
            float* s = sS + p * N1 + n0 + n;
            *s = e_end * *s + acc[i][j];
          }
        }
    }
  }

  // ---- reverse walk
  __syncthreads();
  const float* dfb = g.dfinal == nullptr
                         ? nullptr
                         : g.dfinal + (static_cast<size_t>(b) * H + h) * P * N;
  for (int i = tid; i < P * N1; i += kThreads) {
    const int p = i / N1, n = i % N1;
    sS[i] = (dfb != nullptr && n < N) ? dfb[p * N + n] : 0.0f;
  }
  for (int c = nc - 1; c >= 0; --c) {
    const int c0 = c * Q, nv = min(Q, S - c0);
    __syncthreads();
    stage_rows(xb + c0 * g.x_ss, g.x_ss, nv, Q, P, P, sX, P1);
    stage_rows(dyb + c0 * dy_ld, dy_ld, nv, Q, P, P, sDy, P1);
    for (int r = tid; r < Q; r += kThreads)
      sDt[r] = r < nv ? dtb[static_cast<size_t>(c0 + r) * H] : 0.0f;
    __syncthreads();
    scan_cum();
    __syncthreads();
    const float cum_end = sCum[Q - 1], e_end = expf(cum_end);
    for (int t = tid; t < Q; t += kThreads) {
      sW[t] = expf(cum_end - sCum[t]);
      sE[t] = expf(sCum[t]);
    }
    const float* prevc = prevb + static_cast<size_t>(c) * P * N;

    // 1. M = (C B^T) o L, t = ty + 16 i, k = tx + 16 j, into sQQ
    {
      float m[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) m[i][j] = 0.0f;
      for (int n0 = 0; n0 < N; n0 += kBwdNT) {
        const int wn = min(kBwdNT, N - n0);
        __syncthreads();
        stage_rows(bb + c0 * g.b_ss + n0, g.b_ss, nv, Q, kBwdNT, wn, sBt, T1);
        stage_rows(cb + c0 * g.c_ss + n0, g.c_ss, nv, Q, kBwdNT, wn, sCt, T1);
        __syncthreads();
        for (int nn = 0; nn < wn; ++nn) {
          float cv[8], bv[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            cv[i] = sCt[qi[i] * T1 + nn];
            bv[i] = sBt[qk[i] * T1 + nn];
          }
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) m[i][j] = fmaf(cv[i], bv[j], m[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int k = tx + 16 * j;
          if (t < Q && k < Q)   // exp above the diagonal may overflow
            sQQ[t * Q1 + k] =
                k <= t ? m[i][j] * expf(sCum[t] - sCum[k]) : 0.0f;
        }
      }
    }
    __syncthreads();

    // 2. dxs = M^T dy, k = ty + 16 i, p = tx + 16 j
    float dxs[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dxs[i][j] = 0.0f;
    for (int t = 0; t < Q; ++t) {
      float mv[8], dv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) mv[i] = sQQ[t * Q1 + qi[i]];
#pragma unroll
      for (int j = 0; j < 4; ++j) dv[j] = sDy[t * P1 + pj[j]];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dxs[i][j] = fmaf(mv[i], dv[j], dxs[i][j]);
    }

    // 3. D[t][k] = dt_k (dy_t . x_k), t = ty + 16 i, k = tx + 16 j; the row
    // and column sums of M o D; then D o L over M
    {
      float d[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) d[i][j] = 0.0f;
      for (int p = 0; p < P; ++p) {
        float yv[8], xv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          yv[i] = sDy[qi[i] * P1 + p];
          xv[i] = sX[qk[i] * P1 + p];
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) d[i][j] = fmaf(yv[i], xv[j], d[i][j]);
      }
      float rs[8], cs[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) rs[i] = cs[i] = 0.0f;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          d[i][j] *= sDt[qk[j]];
          if (ty + 16 * i < Q && tx + 16 * j < Q) {
            const float md = sQQ[qi[i] * Q1 + qk[j]] * d[i][j];
            rs[i] += md;
            cs[j] += md;
          }
        }
      __syncthreads();   // every read of M is done
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int k = tx + 16 * j;
          if (t < Q && k < Q)
            sQQ[t * Q1 + k] =
                k <= t ? d[i][j] * expf(sCum[t] - sCum[k]) : 0.0f;
        }
        if (t < Q) sPartA[t * 16 + tx] = rs[i];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (tx + 16 * j < Q) sPartB[(tx + 16 * j) * 16 + ty] = cs[j];
    }
    __syncthreads();
    for (int t = tid; t < Q; t += kThreads) {
      float r = 0.0f, s = 0.0f;
      for (int u = 0; u < 16; ++u) r += sPartA[t * 16 + u];
      for (int u = 0; u < 16; ++u) s += sPartB[t * 16 + u];
      sDc[t] = r - s;
    }

    // 4. per 32-column tile of the state: dC, dB, dxs += w B dS^T, the
    // terms of dcum, then dS for the previous chunk
    float yo[8], uu[8], dec = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) yo[i] = uu[i] = 0.0f;
    for (int n0 = 0; n0 < N; n0 += kBwdNT) {
      const int wn = min(kBwdNT, N - n0);
      __syncthreads();   // the partial sums (first tile) or the last tile
      stage_rows(bb + c0 * g.b_ss + n0, g.b_ss, nv, Q, kBwdNT, wn, sBt, T1);
      stage_rows(cb + c0 * g.c_ss + n0, g.c_ss, nv, Q, kBwdNT, wn, sCt, T1);
      stage_rows(prevc + n0, N, P, P, kBwdNT, wn, sPv, T1);
      __syncthreads();
      int ns[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) ns[j] = n0 + min(tx + 16 * j, wn - 1);
      // dC[t][n] = sum_k (D o L)[t][k] B[k][n] + exp(cum_t) dy_t . prev[:, n]
      {
        float a1[8][2], a2[8][2];
#pragma unroll
        for (int i = 0; i < 8; ++i) a1[i][0] = a1[i][1] = a2[i][0] = a2[i][1] = 0.0f;
        for (int k = 0; k < Q; ++k) {
          float lv[8], bv[2];
#pragma unroll
          for (int i = 0; i < 8; ++i) lv[i] = sQQ[qi[i] * Q1 + k];
#pragma unroll
          for (int j = 0; j < 2; ++j) bv[j] = sBt[k * T1 + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) a1[i][j] = fmaf(lv[i], bv[j], a1[i][j]);
        }
        for (int p = 0; p < P; ++p) {
          float yv[8], pv[2];
#pragma unroll
          for (int i = 0; i < 8; ++i) yv[i] = sDy[qi[i] * P1 + p];
#pragma unroll
          for (int j = 0; j < 2; ++j) pv[j] = sPv[p * T1 + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) a2[i][j] = fmaf(yv[i], pv[j], a2[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int t = ty + 16 * i;
          const float e = sE[qi[i]];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int n = tx + 16 * j;
            const float off = e * a2[i][j];
            if (t < Q) yo[i] = fmaf(sCt[t * T1 + n], off, yo[i]);
            if (t < nv && n < wn)
              g.dcp[((static_cast<size_t>(b) * S + c0 + t) * H + h) * N + n0 +
                    n] = a1[i][j] + off;
          }
        }
      }
      // dB[k][n] = sum_t (D o L)[t][k] C[t][n] + w_k dt_k x_k . dS[:, n]
      {
        float b1[8][2], b2[8][2];
#pragma unroll
        for (int i = 0; i < 8; ++i) b1[i][0] = b1[i][1] = b2[i][0] = b2[i][1] = 0.0f;
        for (int t = 0; t < Q; ++t) {
          float lv[8], cv[2];
#pragma unroll
          for (int i = 0; i < 8; ++i) lv[i] = sQQ[t * Q1 + qi[i]];
#pragma unroll
          for (int j = 0; j < 2; ++j) cv[j] = sCt[t * T1 + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) b1[i][j] = fmaf(lv[i], cv[j], b1[i][j]);
        }
        for (int p = 0; p < P; ++p) {
          float xv[8], sv[2];
#pragma unroll
          for (int i = 0; i < 8; ++i) xv[i] = sX[qi[i] * P1 + p];
#pragma unroll
          for (int j = 0; j < 2; ++j) sv[j] = sS[p * N1 + ns[j]];
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) b2[i][j] = fmaf(xv[i], sv[j], b2[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int k = ty + 16 * i;
          const float wd = sW[qi[i]] * sDt[qi[i]];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int n = tx + 16 * j;
            const float st = wd * b2[i][j];
            if (k < Q) uu[i] = fmaf(sBt[k * T1 + n], st, uu[i]);
            if (k < nv && n < wn)
              g.dbp[((static_cast<size_t>(b) * S + c0 + k) * H + h) * N + n0 +
                    n] = b1[i][j] + st;
          }
        }
      }
      // dxs[k][p] += w_k sum_n B[k][n] dS[p][n], k = ty + 16 i, p = tx + 16 j
      {
        float acc[8][4];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
        for (int nn = 0; nn < wn; ++nn) {
          float bv[8], sv[4];
#pragma unroll
          for (int i = 0; i < 8; ++i) bv[i] = sBt[qi[i] * T1 + nn];
#pragma unroll
          for (int j = 0; j < 4; ++j) sv[j] = sS[pj[j] * N1 + n0 + nn];
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(bv[i], sv[j], acc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float w = sW[qi[i]];
#pragma unroll
          for (int j = 0; j < 4; ++j) dxs[i][j] = fmaf(w, acc[i][j], dxs[i][j]);
        }
      }
      // <dS, prev> over this thread's elements of the tile
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int p = ty + 16 * i, n = tx + 16 * j;
          if (p < P && n < wn)
            dec = fmaf(sS[p * N1 + n0 + n], sPv[p * T1 + n], dec);
        }
      __syncthreads();   // every read of this tile of dS is done
      // dS[p][n] <- e_end dS[p][n] + sum_t dy[t][p] exp(cum_t) C[t][n]
      {
        float acc[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = 0.0f;
        for (int t = 0; t < Q; ++t) {
          const float e = sE[t];
          float yv[4], cv[2];
#pragma unroll
          for (int i = 0; i < 4; ++i) yv[i] = sDy[t * P1 + pi[i]] * e;
#pragma unroll
          for (int j = 0; j < 2; ++j) cv[j] = sCt[t * T1 + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) acc[i][j] = fmaf(yv[i], cv[j], acc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int p = ty + 16 * i, n = tx + 16 * j;
            if (p < P && n < wn) {
              float* s = sS + p * N1 + n0 + n;
              *s = e_end * *s + acc[i][j];
            }
          }
      }
    }

    // 5. dcum's remaining terms, dda = reverse cumsum, this chunk's da
    __syncthreads();   // the last tile is done with sBt and sCt
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = ty + 16 * i;
      if (t < Q) {
        sPartA[t * 16 + tx] = yo[i];
        sPartB[t * 16 + tx] = uu[i];
      }
    }
    sRed[tid] = dec;
    __syncthreads();
    for (int t = tid; t < Q; t += kThreads) {
      float y = 0.0f, u = 0.0f;
      for (int v = 0; v < 16; ++v) y += sPartA[t * 16 + v];
      for (int v = 0; v < 16; ++v) u += sPartB[t * 16 + v];
      sU[t] = u;
      sDc[t] += y - u;
    }
    __syncthreads();
    if (tid == 0) {
      float us = 0.0f, dsp = 0.0f;
      for (int t = 0; t < Q; ++t) us += sU[t];
      for (int i = 0; i < kThreads; ++i) dsp += sRed[i];
      sDc[Q - 1] += us + e_end * dsp;
      float run = 0.0f, da = 0.0f;
      for (int t = Q - 1; t >= 0; --t) {
        run += sDc[t];
        sDc[t] = run;
        da = fmaf(run, sDt[t], da);
      }
      g.dap[(static_cast<size_t>(b) * H + h) * nc + c] = da;
    }
    __syncthreads();

    // 6. dx = dxs dt; ddt = dda a + dxs . x
    float rx[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int k = ty + 16 * i;
      rx[i] = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = tx + 16 * j;
        if (p < P) {
          rx[i] = fmaf(dxs[i][j], sX[qi[i] * P1 + p], rx[i]);
          if (k < nv)
            g.dx[((static_cast<size_t>(b) * S + c0 + k) * H + h) * P + p] =
                dxs[i][j] * sDt[k];
        }
      }
      if (k < Q) sPartA[k * 16 + tx] = rx[i];
    }
    __syncthreads();
    for (int t = tid; t < nv; t += kThreads) {
      float s = 0.0f;
      for (int v = 0; v < 16; ++v) s += sPartA[t * 16 + v];
      g.ddt[(static_cast<size_t>(b) * S + c0 + t) * H + h] = sDc[t] * ah + s;
    }
  }
}

// dB and dC: the per-head partials summed over heads in order, in the
// inputs' type; da: the (sequence, chunk) partials summed in order
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_bwd_sum_kernel(const float* __restrict__ dbp,
                        const float* __restrict__ dcp,
                        const float* __restrict__ dap, T* db, T* dc,
                        float* da, int B, int S, int H, int N, int nc) {
  const long long total = static_cast<long long>(B) * S * N;
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < total) {
    const long long bs = i / N;
    const int n = static_cast<int>(i % N);
    const float* pb = dbp + bs * H * N + n;
    const float* pc = dcp + bs * H * N + n;
    float sb = 0.0f, sc = 0.0f;
    for (int hh = 0; hh < H; ++hh) {
      sb += pb[static_cast<size_t>(hh) * N];
      sc += pc[static_cast<size_t>(hh) * N];
    }
    store_as(db + i, sb);
    store_as(dc + i, sc);
  } else if (i < total + H) {
    const int hh = static_cast<int>(i - total);
    float s = 0.0f;
    for (int bb = 0; bb < B; ++bb)
      for (int c = 0; c < nc; ++c)
        s += dap[(static_cast<size_t>(bb) * H + hh) * nc + c];
    da[hh] = s;
  }
}
// ---- the bf16 backward on the tensor cores
// Chunk-parallel, as ssd_scan_backward_plain (ref.py) is written: only the
// elementwise passing of the chunk-entry states forward and of dS backward
// runs in order over the chunks. Four launches on the stream:
//   (a) ssd_bwd_state_kernel, a block per (chunk, head, sequence): the
//       chunk's own state sum_t x_t (w_t dt_t) B_t^T and its term of dS,
//       sum_t exp(cum_t) dy_t C_t^T (ref.py's `into`), both (P, N) fp32 to
//       device scratch, its cum_end, and each position's cum (the in-order
//       sum, in ddt's place until (c) writes ddt);
//   (b) ssd_bwd_pass_kernel, a thread per (sequence, head, p, n): turns the
//       states into the chunk-entry states and the terms into dS, the
//       gradient of the state leaving each chunk, in place, in the plain
//       version's order (carry = carry * decay + term);
//   (c) ssd_bwd_chunk_kernel, a block per (chunk, head, sequence): every
//       (Q, Q) product of the chunk and the rest of its gradient (dx, ddt,
//       per-head dB and dC partials, da's partial);
//   (d) ssd_scan_bwd_sum_kernel: dB and dC summed over heads, da over
//       sequences and chunks, in a fixed order.
// In (c), with L[t][k] = exp(cum_t - cum_k) for k <= t, warp w owns the
// 16-row tile w of the chunk twice: as rows t, over the key tiles k <= t,
//   M = (C_t B_k^T) o L, D = dt_k (dy_t . x_k), rowsum(M o D), and
//   dC_t = exp(cum_t) dy_t prev + sum_k (D o L) B_k;
// and as columns k, over the row tiles t >= k, the same blocks transposed,
//   colsum(M o D), dxs_k = w_k B_k dS^T + sum_t M^T dy_t and
//   dB_k = w_k dt_k x_k dS + sum_t (D o L)^T C_t,
// so every warp takes Q / 16 + 1 blocks, whatever its tile, and C B^T and
// dy x^T are computed twice (once a side) rather than kept in shared
// memory: a (Q, Q) fp32 matrix in three bf16 parts is 96 KB at Q = 128.
// The blocks above the diagonal are skipped; L is built only where k <= t
// (a select: exp above the diagonal may overflow). C B^T takes one bf16
// pass, both operands being bf16 inputs. Every product with an fp32
// operand takes three: the operand split hi + mid + lo in bf16 (split3, ~24
// bits, fp32's own precision), and where both operands are fp32 (M^T dy,
// dy prev) both split in two and hi.hi + hi.lo + lo.hi. x, B and C come
// by cp.async as bf16 tiles of 128-byte rows (XOR-swizzled, as the
// forward's TMA boxes); dy, the chunk-entry state and dS are read in fp32
// and split into bf16 tiles on the way into shared memory, every load of
// a thread issued before any is split.
// What bounds it on an H100: at mamba2-780m's shape (B = 8, H = 48, S =
// 1024, P = 64, N = 128, Q = 128) the products it needs take 0.157 ms at
// the bf16 tensor rate with three passes an fp32 operand; this design
// issues ~187 GFLOP of mma.sync (C B^T and dy x^T on both sides). (c)
// holds 214 KB of shared memory, so one block of 8 warps an SM, whose
// loads are not overlapped with its products and whose two warps a
// scheduler issue mma.sync at about a product per 4 cycles an SM; (a)
// fits two blocks an SM; (b) and (d) move 400 MB and 403 MB of fp32
// scratch. PERF.md gives each launch's time.
constexpr int kBwdTcWarps = 8;
constexpr int kBwdTcThreads = 32 * kBwdTcWarps;
constexpr int kSubQ = kMaxQ * 128;   // a 64-column tile of a chunk
constexpr int kSubP = kTcP * 128;    // a 64-column tile of a state

// (a)'s shared memory: x, B, C as bf16 tiles, dy in fp32 (64 floats a row,
// each 4-float unit XOR-swizzled by row bits 1-2, so that a fragment's
// reads of 4 rows by 8 columns take 32 banks), then dt and cum, which
// become w dt and exp(cum) in place: 113 KB at N = 128, two blocks an SM
template <int NT>
struct StatePlan {
  static constexpr int kB = kSubQ;
  static constexpr int kC = kB + (NT / 64) * kSubQ;
  static constexpr int kDy = kC + (NT / 64) * kSubQ;
  static constexpr int kF = kDy + kMaxQ * kTcP * 4;
  static constexpr int kBytes = kF + 2 * kMaxQ * 4;
};
// the float offset of dy's (t, p) in (a)'s tile
__device__ __forceinline__ int dy_off(int t, int p) {
  return t * kTcP + (p ^ (((t >> 1) & 3) << 3));
}

// (c)'s shared memory: x, B, C, dy's hi/mid/lo, prev's hi/lo and dS's
// hi/mid/lo as bf16 tiles, then the per-row floats (dt, cum, exp(cum),
// w, and the row sums rs, yo, cs, U, rx) and a reduction buffer
template <int NT>
struct ChunkPlan {
  static constexpr int kB = kSubQ;
  static constexpr int kC = kB + (NT / 64) * kSubQ;
  static constexpr int kDy = kC + (NT / 64) * kSubQ;
  static constexpr int kPv = kDy + 3 * kSubQ;
  static constexpr int kPvTile = (NT / 64) * kSubP;
  static constexpr int kDs = kPv + 2 * kPvTile;
  static constexpr int kF = kDs + 3 * kPvTile;
  static constexpr int kBytes = kF + (9 * kMaxQ + kBwdTcThreads) * 4;
};

// cp.async of rows 0 .. rows - 1 of a bf16 chunk tile (row stride ld
// elements, `units` 16-byte units a row) into a tile of 128-byte rows at
// dst; units at rows >= nv or columns >= lim are zeros
__device__ __forceinline__ void load_bf16_tile(unsigned dst,
                                               const __nv_bfloat16* src,
                                               long long ld, int rows,
                                               int units, int nv, int lim,
                                               int sub) {
  for (int i = threadIdx.x; i < rows * units; i += kBwdTcThreads) {
    const int r = i / units, u = i % units;
    const bool valid = r < nv && 8 * u < lim;
    cp_async16(dst + toff(r, 8 * u, sub), src + (valid ? r * ld + 8 * u : 0),
               valid);
  }
}

// a thread's share of dy's fp32 rows in (c): kMaxQ x 64 values in units of
// 8, over 256 threads
constexpr int kSplitIter = 4;   // kMaxQ x 64 or kTcP x 128 values, 256 threads

// dt of the chunk (rows >= nv read as 0), then, by thread 0, cum =
// cumsum(dt a) in order, rounding each product and sum as the forward's
// scan_dt does; leaves cum_end = cum[QT - 1] in the return value (all
// threads, after the barrier)
__device__ __forceinline__ float chunk_cum(const float* dtb, int H, int nv,
                                           int QT, float ah, float* sDt,
                                           float* sCum) {
  for (int r = threadIdx.x; r < kMaxQ; r += kBwdTcThreads)
    sDt[r] = r < nv ? dtb[static_cast<size_t>(r) * H] : 0.0f;
  __syncthreads();
  if (threadIdx.x == 0) {
    float run = 0.0f;
    for (int r = 0; r < QT; ++r) {
      run = __fadd_rn(run, __fmul_rn(sDt[r], ah));
      sCum[r] = run;
    }
  }
  __syncthreads();
  return sCum[QT - 1];
}

// the sum over the 4 lanes of a fragment row (a fixed order)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// A fragment of a 16 x 16 block from its two accumulator n-tiles acc[0..1]
// (rows g, g + 8; columns 2 t4 (+ 8)), split in three bf16 parts
__device__ __forceinline__ void acc_to_a3(float (*acc)[4],
                                          unsigned* hi, unsigned* mid,
                                          unsigned* lo) {
  split3(acc[0][0], acc[0][1], hi[0], mid[0], lo[0]);
  split3(acc[0][2], acc[0][3], hi[1], mid[1], lo[1]);
  split3(acc[1][0], acc[1][1], hi[2], mid[2], lo[2]);
  split3(acc[1][2], acc[1][3], hi[3], mid[3], lo[3]);
}

// the sum over a warp's lanes, every lane the same total (a fixed order)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the same, split in two (hi, and the bf16 of what hi leaves over)
__device__ __forceinline__ void acc_to_a2(float (*acc)[4], unsigned* hi,
                                          unsigned* lo) {
  const float v[4][2] = {{acc[0][0], acc[0][1]}, {acc[0][2], acc[0][3]},
                         {acc[1][0], acc[1][1]}, {acc[1][2], acc[1][3]}};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = pack_bf16x2(v[i][0], v[i][1]);
    lo[i] = pack_bf16x2(v[i][0] - bf16_lo(hi[i]), v[i][1] - bf16_hi(hi[i]));
  }
}

template <int NT>
__global__ void __launch_bounds__(kBwdTcThreads, 2)
ssd_bwd_state_kernel(const BwdArgs<__nv_bfloat16> g) {
  using L = StatePlan<NT>;
  extern __shared__ __align__(128) unsigned char smem[];
  const unsigned sbase = smem_u32(smem);
  float* const sDy = reinterpret_cast<float*>(smem + L::kDy);
  float* const sDt = reinterpret_cast<float*>(smem + L::kF);
  float* const sCum = sDt + kMaxQ;
  float* const sWdt = sDt;   // w dt over dt, exp(cum) over cum (below)
  float* const sE = sCum;
  const int S = g.S, H = g.H, P = g.P, N = g.N, Q = g.Q;
  // x = head * chunks + chunk (no limit of 65535 heads), y = sequence
  const int nc = (S + Q - 1) / Q;
  const int c = blockIdx.x % nc, h = blockIdx.x / nc, b = blockIdx.y;
  const int c0 = c * Q, nv = min(Q, S - c0);
  const int QT = (Q + 15) & ~15, MT = QT / 16, PT = (P + 15) & ~15;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const int lr = lane & 7, lm = lane >> 3;

  load_bf16_tile(sbase, g.x + b * g.x_sb + c0 * g.x_ss + h * g.x_sh,
                 g.x_ss, QT, 8, nv, P, kSubQ);
  load_bf16_tile(sbase + L::kB, g.bm + b * g.b_sb + c0 * g.b_ss, g.b_ss, QT,
                 NT / 8, nv, N, kSubQ);
  load_bf16_tile(sbase + L::kC, g.cm + b * g.c_sb + c0 * g.c_ss, g.c_ss, QT,
                 NT / 8, nv, N, kSubQ);
  // dy (fp32) rows as 16-byte units of 4, zeros past nv and P
  const float* dyb = g.dy + (static_cast<size_t>(b) * S + c0) * H * P +
                     static_cast<size_t>(h) * P;
  const long long dy_ld = static_cast<long long>(H) * P;
  for (int i = tid; i < QT * (PT / 4); i += kBwdTcThreads) {
    const int r = i / (PT / 4), u = i % (PT / 4);
    const bool valid = r < nv && 4 * u < P;
    cp_async16(sbase + L::kDy + 4 * dy_off(r, 4 * u),
               dyb + (valid ? r * dy_ld + 4 * u : 0), valid);
  }
  cp_async_commit();
  const float cend = chunk_cum(g.dt + (static_cast<size_t>(b) * S + c0) * H +
                                   h,
                               H, nv, QT, g.a[h], sDt, sCum);
  __syncthreads();   // every thread has read cum_end before cum's rows change
  if (tid == 0) g.dap[(static_cast<size_t>(b) * H + h) * nc + c] = cend;
  // each position's cum, for (c), in ddt's place (which (c) overwrites
  // with ddt, row by row, in the same block); then w dt and exp(cum) in
  // place, each thread its own rows
  for (int r = tid; r < kMaxQ; r += kBwdTcThreads) {
    const float cr = sCum[r], dr = sDt[r];
    if (r < nv) g.ddt[(static_cast<size_t>(b) * S + c0 + r) * H + h] = cr;
    sWdt[r] = r < QT ? exp_ftz(cend - cr) * dr : 0.0f;
    sE[r] = r < QT ? exp_ftz(cr) : 0.0f;
  }
  cp_async_wait_all();
  __syncthreads();

  // warp w: state rows 16 pm + gq (+ 8), columns n0 + 8 j + 2 t4
  const int pm = warp & 3, n0 = (warp >> 2) * (NT / 2);
  if (16 * pm >= PT) return;
  float st[NT / 16][4], into[NT / 16][4];
#pragma unroll
  for (int j = 0; j < NT / 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) st[j][e] = into[j][e] = 0.0f;
  const unsigned oXs = toff(lr + 8 * (lm >> 1), 16 * pm + 8 * (lm & 1), kSubQ);
  const unsigned oBs = toff(lr + 8 * (lm & 1), n0 + 8 * (lm >> 1), kSubQ);
  for (int kt = 0; kt < MT; ++kt) {
    const int t0 = 16 * kt;
    // (x w dt)^T, x read transposed; (dy exp(cum))^T from fp32
    unsigned xa[4], xh[4], xm[4], xl[4], yh[4], ym[4], yl[4];
    ldsm_x4_t(sbase + oXs + t0 * 128, xa);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + 2 * t4 + 8 * (i >> 1), p = 16 * pm + gq + 8 * (i & 1);
      split3(bf16_lo(xa[i]) * sWdt[t], bf16_hi(xa[i]) * sWdt[t + 1], xh[i],
             xm[i], xl[i]);
      split3(sDy[dy_off(t, p)] * sE[t], sDy[dy_off(t + 1, p)] * sE[t + 1],
             yh[i], ym[i], yl[i]);
    }
#pragma unroll
    for (int jj = 0; jj < NT / 32; ++jj) {
      unsigned bf[4], cf[4];
      const unsigned off = toff_add(oBs, 2 * jj, kSubQ) + t0 * 128;
      ldsm_x4_t(sbase + L::kB + off, bf);
      ldsm_x4_t(sbase + L::kC + off, cf);
      mma_sum3(st[2 * jj], xh, bf[0], bf[1], xm, bf[0], bf[1], xl, bf[0],
               bf[1]);
      mma_sum3(st[2 * jj + 1], xh, bf[2], bf[3], xm, bf[2], bf[3], xl, bf[2],
               bf[3]);
      mma_sum3(into[2 * jj], yh, cf[0], cf[1], ym, cf[0], cf[1], yl, cf[0],
               cf[1]);
      mma_sum3(into[2 * jj + 1], yh, cf[2], cf[3], ym, cf[2], cf[3], yl,
               cf[2], cf[3]);
    }
  }
  const size_t so = ((static_cast<size_t>(b) * H + h) * nc + c) * P * N;
#pragma unroll
  for (int j = 0; j < NT / 16; ++j)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int p = 16 * pm + gq + 8 * hr, n = n0 + 8 * j + 2 * t4;
      if (p < P && n < N) {
        *reinterpret_cast<float2*>(g.prevs + so + p * N + n) =
            make_float2(st[j][2 * hr], st[j][2 * hr + 1]);
        *reinterpret_cast<float2*>(g.dstates + so + p * N + n) =
            make_float2(into[j][2 * hr], into[j][2 * hr + 1]);
      }
    }
}

// (b): states -> chunk-entry states, terms -> dS, in place; decay =
// exp(cum_end) of each chunk, from (a). A thread takes 4 neighbouring
// elements (P N is a multiple of 8) and the chunks kPassBatch at a time,
// every load of a batch issued before its stores, so that it waits for
// memory once a batch and not once a chunk.
constexpr int kPassBatch = 8;

__device__ __forceinline__ float4 fma4(float4 c, float d, float4 t) {
  return make_float4(c.x * d + t.x, c.y * d + t.y, c.z * d + t.z,
                     c.w * d + t.w);
}

__global__ void __launch_bounds__(kThreads)
ssd_bwd_pass_kernel(float* __restrict__ states, float* __restrict__ dstates,
                    const float* __restrict__ dfinal,
                    const float* __restrict__ cend, long long BH, int PN,
                    int nc) {
  const int pn4 = PN / 4;
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= BH * pn4) return;
  const long long bh = i / pn4;
  const int e = static_cast<int>(i % pn4);
  float4* const sp = reinterpret_cast<float4*>(states + bh * nc * PN) + e;
  float4* const dp = reinterpret_cast<float4*>(dstates + bh * nc * PN) + e;
  const float* const ce = cend + bh * nc;
  float4 carry = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int c0 = 0; c0 < nc; c0 += kPassBatch) {
    float4 term[kPassBatch];
    float dec[kPassBatch];
#pragma unroll
    for (int j = 0; j < kPassBatch; ++j)
      if (c0 + j < nc) {
        term[j] = sp[static_cast<size_t>(c0 + j) * pn4];
        dec[j] = expf(ce[c0 + j]);
      }
#pragma unroll
    for (int j = 0; j < kPassBatch; ++j)
      if (c0 + j < nc) {
        sp[static_cast<size_t>(c0 + j) * pn4] = carry;
        carry = fma4(carry, dec[j], term[j]);
      }
  }
  float4 dcarry = dfinal != nullptr
                      ? reinterpret_cast<const float4*>(dfinal + bh * PN)[e]
                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int c1 = nc - 1; c1 >= 0; c1 -= kPassBatch) {
    float4 term[kPassBatch];
    float dec[kPassBatch];
#pragma unroll
    for (int j = 0; j < kPassBatch; ++j)
      if (c1 - j >= 0) {
        term[j] = dp[static_cast<size_t>(c1 - j) * pn4];
        dec[j] = expf(ce[c1 - j]);
      }
#pragma unroll
    for (int j = 0; j < kPassBatch; ++j)
      if (c1 - j >= 0) {
        dp[static_cast<size_t>(c1 - j) * pn4] = dcarry;
        dcarry = fma4(dcarry, dec[j], term[j]);
      }
  }
}

// dy's rows (hi/mid/lo), the chunk-entry state's (hi/lo) and dS's
// (hi/mid/lo) into their bf16 tiles, every load of a thread issued before
// any is split; returns this thread's share of <dS, prev>
template <int NT>
__device__ __forceinline__ float load_chunk_fp32(
    unsigned char* smem, unsigned sDy, unsigned sPv, unsigned sDs,
    int pv_tile, const float* dy, long long dy_ld, int QT, int nv, int P,
    const float* prev, const float* ds, int N) {
  constexpr int kSU = NT / 32;   // state units a thread (64 rows x NT / 8)
  const int tid = threadIdx.x;
  float yv[kSplitIter][8], pv[kSU][8], dv[kSU][8];
#pragma unroll
  for (int it = 0; it < kSplitIter; ++it) {
    const int i = tid + it * kBwdTcThreads, r = i / 8, u = i % 8;
#pragma unroll
    for (int e = 0; e < 8; ++e) yv[it][e] = 0.0f;
    if (r < QT && r < nv && 8 * u < P) {
      const float4* s4 = reinterpret_cast<const float4*>(dy + r * dy_ld + 8 * u);
      const float4 a = s4[0], b = s4[1];
      yv[it][0] = a.x; yv[it][1] = a.y; yv[it][2] = a.z; yv[it][3] = a.w;
      yv[it][4] = b.x; yv[it][5] = b.y; yv[it][6] = b.z; yv[it][7] = b.w;
    }
  }
#pragma unroll
  for (int it = 0; it < kSU; ++it) {
    const int i = tid + it * kBwdTcThreads, r = i / (NT / 8), u = i % (NT / 8);
#pragma unroll
    for (int e = 0; e < 8; ++e) pv[it][e] = dv[it][e] = 0.0f;
    if (r < P && 8 * u < N) {
      const float4* p4 = reinterpret_cast<const float4*>(prev + r * N + 8 * u);
      const float4* d4 = reinterpret_cast<const float4*>(ds + r * N + 8 * u);
      const float4 a = p4[0], b = p4[1], c = d4[0], d = d4[1];
      pv[it][0] = a.x; pv[it][1] = a.y; pv[it][2] = a.z; pv[it][3] = a.w;
      pv[it][4] = b.x; pv[it][5] = b.y; pv[it][6] = b.z; pv[it][7] = b.w;
      dv[it][0] = c.x; dv[it][1] = c.y; dv[it][2] = c.z; dv[it][3] = c.w;
      dv[it][4] = d.x; dv[it][5] = d.y; dv[it][6] = d.z; dv[it][7] = d.w;
    }
  }
  const unsigned base = smem_u32(smem);
  auto store = [&](unsigned off, const unsigned* h, int stride, int parts) {
#pragma unroll
    for (int q = 0; q < 3; ++q)
      if (q < parts)
        *reinterpret_cast<uint4*>(smem + off - base + q * stride) =
            make_uint4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
  };
#pragma unroll
  for (int it = 0; it < kSplitIter; ++it) {
    const int i = tid + it * kBwdTcThreads, r = i / 8, u = i % 8;
    if (r >= QT) break;
    unsigned w[12];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split3(yv[it][2 * e], yv[it][2 * e + 1], w[e], w[4 + e], w[8 + e]);
    store(sDy + toff(r, 8 * u, kSubQ), w, kSubQ, 3);
  }
  float dot = 0.0f;
#pragma unroll
  for (int it = 0; it < kSU; ++it) {
    const int i = tid + it * kBwdTcThreads, r = i / (NT / 8), u = i % (NT / 8);
    unsigned w[12];
#pragma unroll
    for (int e = 0; e < 8; ++e) dot = fmaf(dv[it][e], pv[it][e], dot);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split3(pv[it][2 * e], pv[it][2 * e + 1], w[e], w[4 + e], w[8 + e]);
    store(sPv + toff(r, 8 * u, kSubP), w, pv_tile, 2);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split3(dv[it][2 * e], dv[it][2 * e + 1], w[e], w[4 + e], w[8 + e]);
    store(sDs + toff(r, 8 * u, kSubP), w, pv_tile, 3);
  }
  return dot;
}

template <int NT>
__global__ void __launch_bounds__(kBwdTcThreads, 1)
ssd_bwd_chunk_kernel(const BwdArgs<__nv_bfloat16> g) {
  using L = ChunkPlan<NT>;
  constexpr int kNn = NT / 8;    // n-tiles over the state
  constexpr int kKn = NT / 16;   // k-tiles over the state
  extern __shared__ __align__(128) unsigned char smem[];
  const unsigned sbase = smem_u32(smem);
  const unsigned sX = sbase, sB = sbase + L::kB, sC = sbase + L::kC;
  const unsigned sDy = sbase + L::kDy, sPv = sbase + L::kPv;
  const unsigned sDs = sbase + L::kDs;
  float* const sDt = reinterpret_cast<float*>(smem + L::kF);
  float* const sCum = sDt + kMaxQ;
  float* const sE = sCum + kMaxQ;
  float* const sW = sE + kMaxQ;
  float* const sRs = sW + kMaxQ;
  float* const sYo = sRs + kMaxQ;
  float* const sCs = sYo + kMaxQ;
  float* const sU = sCs + kMaxQ;
  float* const sRx = sU + kMaxQ;
  float* const sRed = sRx + kMaxQ;
  const int S = g.S, H = g.H, P = g.P, N = g.N, Q = g.Q;
  // x = head * chunks + chunk (no limit of 65535 heads), y = sequence
  const int nc = (S + Q - 1) / Q;
  const int c = blockIdx.x % nc, h = blockIdx.x / nc, b = blockIdx.y;
  const int c0 = c * Q, nv = min(Q, S - c0);
  const int QT = (Q + 15) & ~15, MT = QT / 16, PT = (P + 15) & ~15;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const int lr = lane & 7, lm = lane >> 3;
  const float ah = g.a[h];

  // x, B and C (bf16), dt and cum as (a) computed it (rows >= nv: dt = 0,
  // cum = cum_end) by cp.async; dy, the state and dS in fp32 meanwhile
  load_bf16_tile(sX, g.x + b * g.x_sb + c0 * g.x_ss + h * g.x_sh, g.x_ss,
                 QT, 8, nv, P, kSubQ);
  load_bf16_tile(sB, g.bm + b * g.b_sb + c0 * g.b_ss, g.b_ss, QT, NT / 8, nv,
                 N, kSubQ);
  load_bf16_tile(sC, g.cm + b * g.c_sb + c0 * g.c_ss, g.c_ss, QT, NT / 8, nv,
                 N, kSubQ);
  {
    const size_t row0 = (static_cast<size_t>(b) * S + c0) * H + h;
    for (int r = tid; r < kMaxQ; r += kBwdTcThreads) {
      cp_async4(smem_u32(sDt + r),
                g.dt + row0 + static_cast<size_t>(min(r, nv - 1)) * H, r < nv);
      cp_async4(smem_u32(sCum + r),
                g.ddt + row0 + static_cast<size_t>(min(r, nv - 1)) * H, true);
    }
  }
  cp_async_commit();
  const size_t so = ((static_cast<size_t>(b) * H + h) * nc + c) * P * N;
  sRed[tid] = load_chunk_fp32<NT>(
      smem, sDy, sPv, sDs, L::kPvTile,
      g.dy + (static_cast<size_t>(b) * S + c0) * H * P +
          static_cast<size_t>(h) * P,
      static_cast<long long>(H) * P, QT, nv, P, g.prevs + so,
      g.dstates + so, N);
  cp_async_wait_all();
  __syncthreads();
  const float cend = sCum[QT - 1];
  for (int r = tid; r < kMaxQ; r += kBwdTcThreads) {
    sE[r] = r < QT ? exp_ftz(sCum[r]) : 0.0f;
    sW[r] = r < QT ? exp_ftz(cend - sCum[r]) : 0.0f;
  }
  __syncthreads();

  const int m = warp;   // this warp's row tile (as t) and column tile (as k)
  // ldmatrix offsets: A rows of tile m; B rows (non-trans) of a tile
  const unsigned oA = toff(16 * m + lr + 8 * (lm & 1), 8 * (lm >> 1), kSubQ);
  auto oBn = [&](int tile, int kt) {   // B operand, rows = n, cols = k
    return toff(16 * tile + lr + 8 * (lm >> 1), 16 * kt + 8 * (lm & 1), kSubQ);
  };
  auto oBt = [&](int tile, int np, int sub) {   // B operand read transposed
    return toff(16 * tile + lr + 8 * (lm & 1), 16 * np + 8 * (lm >> 1), sub);
  };
  const int pk = PT / 16;           // k-tiles over P
  const int pp = (pk + 1) / 2;      // pairs of n-tiles over P (the last
                                    // may run on the tiles' zero columns)

  if (m < MT) {
    // ---- rows t of tile m
    const int ta = 16 * m + gq, tb = ta + 8;
    float dc[kNn][4];
#pragma unroll
    for (int j = 0; j < kNn; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dc[j][e] = 0.0f;
    // this tile's A fragments, loaded once: C_t over n, dy_t's three parts
    // over p
    unsigned cf[kKn][4], yf[3][4][4];
#pragma unroll
    for (int kt = 0; kt < kKn; ++kt)
      ldsm_x4(sC + toff_add(oA, 2 * kt, kSubQ), cf[kt]);
#pragma unroll
    for (int kt = 0; kt < 4; ++kt)
      if (16 * kt < PT)
#pragma unroll
        for (int pass = 0; pass < 3; ++pass)
          ldsm_x4(sDy + pass * kSubQ + toff_add(oA, 2 * kt, kSubQ),
                  yf[pass][kt]);
    // exp(cum_t) dy_t prev: dy hi/mid against prev hi/lo
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      if (16 * kt >= PT) break;
#pragma unroll
      for (int np = 0; np < kKn; ++np) {
        unsigned ph[4], pl[4];
        const unsigned off = oBt(kt, np, kSubP);
        ldsm_x4_t(sPv + off, ph);
        ldsm_x4_t(sPv + L::kPvTile + off, pl);
        mma_sum3(dc[2 * np], yf[0][kt], ph[0], ph[1], yf[0][kt], pl[0],
                 pl[1], yf[1][kt], ph[0], ph[1]);
        mma_sum3(dc[2 * np + 1], yf[0][kt], ph[2], ph[3], yf[0][kt], pl[2],
                 pl[3], yf[1][kt], ph[2], ph[3]);
      }
    }
    {
      const float ea = sE[ta], eb = sE[tb];
      float ya = 0.0f, yb = 0.0f;
#pragma unroll
      for (int j = 0; j < kNn; ++j) {
        dc[j][0] *= ea;
        dc[j][1] *= ea;
        dc[j][2] *= eb;
        dc[j][3] *= eb;
        const int n = 8 * j + 2 * t4;
        const unsigned ca =
            *reinterpret_cast<const unsigned*>(smem + L::kC + toff(ta, n, kSubQ));
        const unsigned cb =
            *reinterpret_cast<const unsigned*>(smem + L::kC + toff(tb, n, kSubQ));
        ya = fmaf(bf16_lo(ca), dc[j][0], fmaf(bf16_hi(ca), dc[j][1], ya));
        yb = fmaf(bf16_lo(cb), dc[j][2], fmaf(bf16_hi(cb), dc[j][3], yb));
      }
      ya = quad_sum(ya);
      yb = quad_sum(yb);
      if (t4 == 0) {
        sYo[ta] = ya;
        sYo[tb] = yb;
      }
    }
    float rs[2] = {0.0f, 0.0f};
    for (int kk = 0; kk <= m; ++kk) {
      // G = C_t B_k^T and D' = dy_t x_k^T (dy in three passes)
      float ga[2][4], da[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) ga[j][e] = da[j][e] = 0.0f;
#pragma unroll
      for (int kt = 0; kt < kKn; ++kt) {
        unsigned bf[4];
        ldsm_x4(sB + oBn(kk, kt), bf);
        mma_bf16(ga[0], cf[kt], bf[0], bf[1]);
        mma_bf16(ga[1], cf[kt], bf[2], bf[3]);
      }
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {
        if (16 * kt >= PT) break;
        unsigned xf[4];
        ldsm_x4(sX + oBn(kk, kt), xf);
#pragma unroll
        for (int pass = 0; pass < 3; ++pass) {
          mma_bf16(da[0], yf[pass][kt], xf[0], xf[1]);
          mma_bf16(da[1], yf[pass][kt], xf[2], xf[3]);
        }
      }
      // M = G o L, D = D' dt_k, D o L; the row sums of M o D
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = ta + 8 * (e >> 1), k = 16 * kk + 8 * j + 2 * t4 + (e & 1);
          const float l = k <= t ? exp_ftz(sCum[t] - sCum[k]) : 0.0f;
          const float d = da[j][e] * sDt[k];
          rs[e >> 1] = fmaf(ga[j][e] * l, d, rs[e >> 1]);
          da[j][e] = d * l;
        }
      // dC_t += (D o L) B_k, B read transposed
      unsigned hi[4], mid[4], lo[4];
      acc_to_a3(da, hi, mid, lo);
#pragma unroll
      for (int np = 0; np < kKn; ++np) {
        unsigned bf[4];
        ldsm_x4_t(sB + oBt(kk, np, kSubQ), bf);
        mma_sum3(dc[2 * np], hi, bf[0], bf[1], mid, bf[0], bf[1], lo, bf[0],
                 bf[1]);
        mma_sum3(dc[2 * np + 1], hi, bf[2], bf[3], mid, bf[2], bf[3], lo,
                 bf[2], bf[3]);
      }
    }
    rs[0] = quad_sum(rs[0]);
    rs[1] = quad_sum(rs[1]);
    if (t4 == 0) {
      sRs[ta] = rs[0];
      sRs[tb] = rs[1];
    }
    // this head's dC partial, rows < nv, columns < N
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int t = ta + 8 * hr;
      if (t >= nv) continue;
      float* const row =
          g.dcp + ((static_cast<size_t>(b) * S + c0 + t) * H + h) * N;
#pragma unroll
      for (int j = 0; j < kNn; ++j)
        if (8 * j + 2 * t4 < N)
          *reinterpret_cast<float2*>(row + 8 * j + 2 * t4) =
              make_float2(dc[j][2 * hr], dc[j][2 * hr + 1]);
    }
  }

  if (m < MT) {
    // ---- columns k of tile m
    const int ka = 16 * m + gq, kb = ka + 8;
    float db[kNn][4], dxs[8][4];
#pragma unroll
    for (int j = 0; j < kNn; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) db[j][e] = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dxs[j][e] = 0.0f;
    // this tile's A fragments, loaded once: B_k over n, x_k over p
    unsigned bk[kKn][4], xk[4][4];
#pragma unroll
    for (int kt = 0; kt < kKn; ++kt)
      ldsm_x4(sB + toff_add(oA, 2 * kt, kSubQ), bk[kt]);
#pragma unroll
    for (int kt = 0; kt < 4; ++kt)
      if (16 * kt < PT) ldsm_x4(sX + toff_add(oA, 2 * kt, kSubQ), xk[kt]);
    // w_k dt_k x_k dS: x against dS's three parts, dS read transposed
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      if (16 * kt >= PT) break;
      const unsigned* xf = xk[kt];
#pragma unroll
      for (int np = 0; np < kKn; ++np) {
        unsigned s0[4], s1[4], s2[4];
        const unsigned off = oBt(kt, np, kSubP);
        ldsm_x4_t(sDs + off, s0);
        ldsm_x4_t(sDs + L::kPvTile + off, s1);
        ldsm_x4_t(sDs + 2 * L::kPvTile + off, s2);
        mma_sum3(db[2 * np], xf, s0[0], s0[1], xf, s1[0], s1[1], xf, s2[0],
                 s2[1]);
        mma_sum3(db[2 * np + 1], xf, s0[2], s0[3], xf, s1[2], s1[3], xf,
                 s2[2], s2[3]);
      }
    }
    {
      const float wa = sW[ka] * sDt[ka], wb = sW[kb] * sDt[kb];
      float ua = 0.0f, ub = 0.0f;
#pragma unroll
      for (int j = 0; j < kNn; ++j) {
        db[j][0] *= wa;
        db[j][1] *= wa;
        db[j][2] *= wb;
        db[j][3] *= wb;
        const int n = 8 * j + 2 * t4;
        const unsigned ba =
            *reinterpret_cast<const unsigned*>(smem + L::kB + toff(ka, n, kSubQ));
        const unsigned bb =
            *reinterpret_cast<const unsigned*>(smem + L::kB + toff(kb, n, kSubQ));
        ua = fmaf(bf16_lo(ba), db[j][0], fmaf(bf16_hi(ba), db[j][1], ua));
        ub = fmaf(bf16_lo(bb), db[j][2], fmaf(bf16_hi(bb), db[j][3], ub));
      }
      ua = quad_sum(ua);
      ub = quad_sum(ub);
      if (t4 == 0) {
        sU[ka] = ua;
        sU[kb] = ub;
      }
    }
    // w_k B_k dS^T: B against dS's three parts, dS rows as the B operand
#pragma unroll
    for (int kt = 0; kt < kKn; ++kt) {
      const unsigned* bf = bk[kt];
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (16 * np >= PT) break;
        unsigned s0[4], s1[4], s2[4];
        const unsigned off =
            toff(16 * np + lr + 8 * (lm >> 1), 16 * kt + 8 * (lm & 1), kSubP);
        ldsm_x4(sDs + off, s0);
        ldsm_x4(sDs + L::kPvTile + off, s1);
        ldsm_x4(sDs + 2 * L::kPvTile + off, s2);
        mma_sum3(dxs[2 * np], bf, s0[0], s0[1], bf, s1[0], s1[1], bf, s2[0],
                 s2[1]);
        mma_sum3(dxs[2 * np + 1], bf, s0[2], s0[3], bf, s1[2], s1[3], bf,
                 s2[2], s2[3]);
      }
    }
    {
      const float wa = sW[ka], wb = sW[kb];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        dxs[j][0] *= wa;
        dxs[j][1] *= wa;
        dxs[j][2] *= wb;
        dxs[j][3] *= wb;
      }
    }
    float cs[2] = {0.0f, 0.0f};
    for (int tt = m; tt < MT; ++tt) {
      // G^T = B_k C_t^T and D'^T = x_k dy_t^T (dy in three passes)
      float ga[2][4], da[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) ga[j][e] = da[j][e] = 0.0f;
#pragma unroll
      for (int kt = 0; kt < kKn; ++kt) {
        unsigned cf[4];
        ldsm_x4(sC + oBn(tt, kt), cf);
        mma_bf16(ga[0], bk[kt], cf[0], cf[1]);
        mma_bf16(ga[1], bk[kt], cf[2], cf[3]);
      }
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {
        if (16 * kt >= PT) break;
#pragma unroll
        for (int pass = 0; pass < 3; ++pass) {
          unsigned yf[4];
          ldsm_x4(sDy + pass * kSubQ + oBn(tt, kt), yf);
          mma_bf16(da[0], xk[kt], yf[0], yf[1]);
          mma_bf16(da[1], xk[kt], yf[2], yf[3]);
        }
      }
      // M^T, D^T o L^T; the column sums of M o D
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = ka + 8 * (e >> 1), t = 16 * tt + 8 * j + 2 * t4 + (e & 1);
          const float l = k <= t ? exp_ftz(sCum[t] - sCum[k]) : 0.0f;
          const float d = da[j][e] * sDt[k];
          ga[j][e] *= l;
          cs[e >> 1] = fmaf(ga[j][e], d, cs[e >> 1]);
          da[j][e] = d * l;
        }
      // dxs_k += M^T dy_t: M^T and dy both split in two, hi.hi + hi.lo +
      // lo.hi
      unsigned mh[4], ml[4];
      acc_to_a2(ga, mh, ml);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (16 * np >= PT) break;
        unsigned yh[4], ym[4];
        const unsigned off = oBt(tt, np, kSubQ);
        ldsm_x4_t(sDy + off, yh);
        ldsm_x4_t(sDy + kSubQ + off, ym);
        mma_sum3(dxs[2 * np], mh, yh[0], yh[1], mh, ym[0], ym[1], ml, yh[0],
                 yh[1]);
        mma_sum3(dxs[2 * np + 1], mh, yh[2], yh[3], mh, ym[2], ym[3], ml,
                 yh[2], yh[3]);
      }
      // dB_k += (D o L)^T C_t, C read transposed
      unsigned hi[4], mid[4], lo[4];
      acc_to_a3(da, hi, mid, lo);
#pragma unroll
      for (int np = 0; np < kKn; ++np) {
        unsigned cf[4];
        ldsm_x4_t(sC + oBt(tt, np, kSubQ), cf);
        mma_sum3(db[2 * np], hi, cf[0], cf[1], mid, cf[0], cf[1], lo, cf[0],
                 cf[1]);
        mma_sum3(db[2 * np + 1], hi, cf[2], cf[3], mid, cf[2], cf[3], lo,
                 cf[2], cf[3]);
      }
    }
    cs[0] = quad_sum(cs[0]);
    cs[1] = quad_sum(cs[1]);
    // dx = dxs dt (rows < nv, columns < P); rx = dxs . x
    float rx[2] = {0.0f, 0.0f};
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int k = ka + 8 * hr;
      const float dtk = sDt[k];
      __nv_bfloat16* const row =
          g.dx + ((static_cast<size_t>(b) * S + c0 + k) * H + h) * P;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = 8 * j + 2 * t4;
        if (p >= PT) break;
        const unsigned xv =
            *reinterpret_cast<const unsigned*>(smem + toff(k, p, kSubQ));
        rx[hr] = fmaf(dxs[j][2 * hr], bf16_lo(xv),
                      fmaf(dxs[j][2 * hr + 1], bf16_hi(xv), rx[hr]));
        if (k < nv && p < P)
          *reinterpret_cast<unsigned*>(row + p) = pack_bf16x2(
              dxs[j][2 * hr] * dtk, dxs[j][2 * hr + 1] * dtk);
      }
      rx[hr] = quad_sum(rx[hr]);
    }
    if (t4 == 0) {
      sCs[ka] = cs[0];
      sCs[kb] = cs[1];
      sRx[ka] = rx[0];
      sRx[kb] = rx[1];
    }
    // this head's dB partial
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int k = ka + 8 * hr;
      if (k >= nv) continue;
      float* const row =
          g.dbp + ((static_cast<size_t>(b) * S + c0 + k) * H + h) * N;
#pragma unroll
      for (int j = 0; j < kNn; ++j)
        if (8 * j + 2 * t4 < N)
          *reinterpret_cast<float2*>(row + 8 * j + 2 * t4) =
              make_float2(db[j][2 * hr], db[j][2 * hr + 1]);
    }
  }
  __syncthreads();

  // warp 0: dcum, dda = its reverse cumulative sum, this chunk's da. Lane l
  // takes rows 4 l .. 4 l + 3 from the bottom up and adds the sums of the
  // lanes below it in the chunk (a suffix scan over the lanes, a fixed
  // order); the chunk decay's term joins the last row.
  if (warp == 0) {
    float dcum[4], us = 0.0f, dsp = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * lane + i;
      dcum[i] = r < QT ? sRs[r] - sCs[r] + sYo[r] - sU[r] : 0.0f;
      us += r < QT ? sU[r] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kBwdTcThreads / 32; ++i)
      dsp += sRed[(kBwdTcThreads / 32) * lane + i];
    us = warp_sum(us);
    dsp = warp_sum(dsp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (4 * lane + i == QT - 1) dcum[i] += us + exp_ftz(cend) * dsp;
    const float tot = ((dcum[3] + dcum[2]) + dcum[1]) + dcum[0];
    float suf = tot;   // the sum over lanes >= this one
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_down_sync(0xffffffffu, suf, o);
      if (lane + o < 32) suf += v;
    }
    float run = __shfl_down_sync(0xffffffffu, suf, 1);
    if (lane == 31) run = 0.0f;
    float da = 0.0f;
#pragma unroll
    for (int i = 3; i >= 0; --i) {
      const int r = 4 * lane + i;
      run += dcum[i];
      if (r < QT) {
        sRs[r] = run;
        da = fmaf(run, sDt[r], da);
      }
    }
    da = warp_sum(da);
    if (lane == 0) g.dap[(static_cast<size_t>(b) * H + h) * nc + c] = da;
  }
  __syncthreads();
  for (int t = tid; t < nv; t += kBwdTcThreads)
    g.ddt[(static_cast<size_t>(b) * S + c0 + t) * H + h] =
        sRs[t] * ah + sRx[t];
}
// ---------------------------------------------------------- end backward

constexpr int kMaxDevices = 64;

// Opt a kernel in to `bytes` of dynamic shared memory once per device: the
// attribute persists, so later launches skip the call.
cudaError_t opt_in_smem(const void* kernel, int* done, int bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) done[dev] = bytes;
  return err;
}

int launch_f32(const void* x, const float* dt, const void* bm, const void* cm,
               const float* a, float* y, float* fin, int B, int S, int H,
               int P, int N, int Q, long long x_sb, long long x_ss,
               long long x_sh, long long b_sb, long long b_ss, long long c_sb,
               long long c_ss, cudaStream_t stream) {
  static int opted[kMaxDevices];
  const int smem = static_cast<int>(smem_bytes(P, N, Q));
  cudaError_t err = opt_in_smem(
      reinterpret_cast<const void*>(ssd_scan_kernel), opted, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_kernel<<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const float*>(x), dt, static_cast<const float*>(bm),
      static_cast<const float*>(cm), a, y, fin, S, H, P, N, Q, x_sb, x_ss,
      x_sh, b_sb, b_ss, c_sb, c_ss);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd_sum(const float* dbp, const float* dcp, const float* dap, T* db,
                   T* dc, float* da, int B, int S, int H, int N, int Q,
                   cudaStream_t stream) {
  const long long total = static_cast<long long>(B) * S * N + H;
  const int nc = (S + Q - 1) / Q;
  ssd_scan_bwd_sum_kernel<T>
      <<<static_cast<unsigned>((total + kThreads - 1) / kThreads), kThreads,
         0, stream>>>(dbp, dcp, dap, db, dc, da, B, S, H, N, nc);
  return static_cast<int>(cudaGetLastError());
}

int launch_bwd_f32(const BwdArgs<float>& args, float* db, float* dc,
                   float* da, int B, cudaStream_t stream) {
  static int opted[kMaxDevices];
  const int smem = static_cast<int>(bwd_smem_bytes(args.P, args.N, args.Q));
  cudaError_t err = opt_in_smem(
      reinterpret_cast<const void*>(ssd_scan_bwd_kernel), opted, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_bwd_kernel<<<dim3(args.H, B), kThreads, smem, stream>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_bwd_sum(args.dbp, args.dcp, args.dap, db, dc, da, B, args.S,
                        args.H, args.N, args.Q, stream);
}

// (a), (b), (c) and (d) of the bf16 backward, in order on the stream
template <int NT>
int launch_bwd_tc(const BwdArgs<__nv_bfloat16>& args, __nv_bfloat16* db,
                  __nv_bfloat16* dc, float* da, int B, cudaStream_t stream) {
  static int opted_a[kMaxDevices], opted_c[kMaxDevices];
  constexpr int smem_a = StatePlan<NT>::kBytes, smem_c = ChunkPlan<NT>::kBytes;
  cudaError_t err = opt_in_smem(
      reinterpret_cast<const void*>(ssd_bwd_state_kernel<NT>), opted_a,
      smem_a);
  if (err == cudaSuccess)
    err = opt_in_smem(reinterpret_cast<const void*>(ssd_bwd_chunk_kernel<NT>),
                      opted_c, smem_c);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nc = (args.S + args.Q - 1) / args.Q;
  const dim3 grid(nc * args.H, B);
  ssd_bwd_state_kernel<NT><<<grid, kBwdTcThreads, smem_a, stream>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long bh = static_cast<long long>(B) * args.H;
  const long long quads = bh * args.P * args.N / 4;
  ssd_bwd_pass_kernel<<<static_cast<unsigned>((quads + kThreads - 1) /
                                              kThreads),
                        kThreads, 0, stream>>>(args.prevs, args.dstates,
                                               args.dfinal, args.dap, bh,
                                               args.P * args.N, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_chunk_kernel<NT><<<grid, kBwdTcThreads, smem_c, stream>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_bwd_sum(args.dbp, args.dcp, args.dap, db, dc, da, B, args.S,
                        args.H, args.N, args.Q, stream);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda.so.1, which the CUDA runtime has
// loaded (no link against it)
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return lib ? reinterpret_cast<EncodeTiled>(
                     dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// The TMA descriptor of a bf16 tensor of `rank` dims (innermost first, byte
// strides of dims 1.. multiples of 16) loaded in boxes of 64 values by Q
// rows (dim 2 of x (P, H, S, B), dim 1 of B and C (N, S, B)); 128-byte
// swizzle, zeros outside the tensor.
cudaError_t tensor_map(CUtensorMap* map, const void* ptr, int rank,
                       const long long* dims, const long long* strides,
                       int Q) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSharedObjectInitFailed;
  cuuint64_t gdim[4], gstride[3];
  cuuint32_t box[4], estride[4] = {1, 1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    gdim[i] = static_cast<cuuint64_t>(dims[i]);
    box[i] = i == 0 ? 64 : (i == rank - 2 ? Q : 1);
  }
  for (int i = 0; i + 1 < rank; ++i)
    gstride[i] = static_cast<cuuint64_t>(strides[i]) * 2;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                        const_cast<void*>(ptr), gdim, gstride, box, estride,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int NT>
int launch_tc(const void* x, const float* dt, const void* bm, const void* cm,
              const float* a, float* y, float* fin, int B, int S, int H,
              int P, int N, int Q, long long x_sb, long long x_ss,
              long long x_sh, long long b_sb, long long b_ss, long long c_sb,
              long long c_ss, cudaStream_t stream) {
  alignas(64) CUtensorMap tx, tb, tc;
  const long long xd[4] = {P, H, S, B}, xs[3] = {x_sh, x_ss, x_sb};
  const long long bd[3] = {N, S, B}, bs[2] = {b_ss, b_sb}, cs[2] = {c_ss, c_sb};
  cudaError_t err = tensor_map(&tx, x, 4, xd, xs, Q);
  if (err == cudaSuccess) err = tensor_map(&tb, bm, 3, bd, bs, Q);
  if (err == cudaSuccess) err = tensor_map(&tc, cm, 3, bd, cs, Q);
  if (err != cudaSuccess) return static_cast<int>(err);
  static int opted[kMaxDevices];
  constexpr int smem = TcPlan<NT>::kBytes;
  err = opt_in_smem(reinterpret_cast<const void*>(ssd_scan_tc_kernel<NT>),
                    opted, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_tc_kernel<NT><<<dim3(H, B), kTcThreads, smem, stream>>>(
      tx, tb, tc, dt, a, y, fin, S, H, P, N, Q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, S, H, P) with element strides x_sb, x_ss, x_sh and unit stride over
// P; dt (B, S, H) fp32 contiguous, already softplused; B and C (B, S, N) with
// strides (b_sb, b_ss) and (c_sb, c_ss) and unit stride over N; a (H,) fp32
// = -exp(a_log); y (B, S, H, P) and final_state (B, H, P, N) fp32
// contiguous. dtype 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores)
// for x, B and C, whose rows are read in 16-byte chunks (16-byte aligned, P
// and N multiples of 16 bytes). Q <= 128, P <= 64, N <= 128.
extern "C" int ssd_scan_fwd(int dtype, const void* x, const float* dt,
                            const void* bm, const void* cm, const float* a,
                            float* y, float* final_state, int B, int S, int H,
                            int P, int N, int Q, long long x_sb, long long x_ss,
                            long long x_sh, long long b_sb, long long b_ss,
                            long long c_sb, long long c_ss,
                            cudaStream_t stream) {
  const int per16 = dtype == 0 ? 4 : 8;
  if (Q < 1 || Q > kMaxQ || P < 1 || P > kMaxP || N < 1 || N > kMaxN ||
      P % per16 != 0 || N % per16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_f32(x, dt, bm, cm, a, y, final_state, B, S, H, P, N, Q,
                      x_sb, x_ss, x_sh, b_sb, b_ss, c_sb, c_ss, stream);
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (N <= 64)
    return launch_tc<64>(x, dt, bm, cm, a, y, final_state, B, S, H, P, N, Q,
                         x_sb, x_ss, x_sh, b_sb, b_ss, c_sb, c_ss, stream);
  return launch_tc<128>(x, dt, bm, cm, a, y, final_state, B, S, H, P, N, Q,
                        x_sb, x_ss, x_sh, b_sb, b_ss, c_sb, c_ss, stream);
}

// The backward: x, dt, B, C and a as ssd_scan_fwd takes them; dy (B, S, H,
// P) fp32 contiguous; dfinal (B, H, P, N) fp32 contiguous or null (zero).
// Scratch, fp32: prevs (B, H, chunks, P, N), dstates (the same; bf16 only,
// null for fp32), dbp and dcp (B, S, H, N), dap (B, H, chunks). Writes dx
// (B, S, H, P), dB and dC (B, S, N) contiguous in the inputs' type, ddt (B,
// S, H) and da (H,) fp32. fp32: two launches on the stream, the backward
// then the fixed-order sum over heads; bf16: four, (a)-(d) above.
extern "C" int ssd_scan_bwd(int dtype, const void* x, const float* dt,
                            const void* bm, const void* cm, const float* a,
                            const float* dy, const float* dfinal,
                            float* prevs, float* dstates, float* dbp,
                            float* dcp, float* dap, void* dx, float* ddt,
                            void* db, void* dc, float* da, int B, int S,
                            int H, int P, int N, int Q, long long x_sb,
                            long long x_ss, long long x_sh, long long b_sb,
                            long long b_ss, long long c_sb, long long c_ss,
                            cudaStream_t stream) {
  if (Q < 1 || Q > kMaxQ || P < 1 || P > kMaxP || N < 1 || N > kMaxN ||
      B < 1 || S < 1 || H < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    const BwdArgs<float> args{
        static_cast<const float*>(x), dt, static_cast<const float*>(bm),
        static_cast<const float*>(cm), a, dy, dfinal, prevs, nullptr,
        static_cast<float*>(dx), ddt, dbp, dcp, dap, S, H, P, N, Q, x_sb,
        x_ss, x_sh, b_sb, b_ss, c_sb, c_ss};
    return launch_bwd_f32(args, static_cast<float*>(db),
                          static_cast<float*>(dc), da, B, stream);
  }
  if (dtype != 1 || dstates == nullptr || P % 8 != 0 || N % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  using bf16 = __nv_bfloat16;
  const BwdArgs<bf16> args{
      static_cast<const bf16*>(x), dt, static_cast<const bf16*>(bm),
      static_cast<const bf16*>(cm), a, dy, dfinal, prevs, dstates,
      static_cast<bf16*>(dx), ddt, dbp, dcp, dap, S, H, P, N, Q, x_sb, x_ss,
      x_sh, b_sb, b_ss, c_sb, c_ss};
  if (N <= 64)
    return launch_bwd_tc<64>(args, static_cast<bf16*>(db),
                             static_cast<bf16*>(dc), da, B, stream);
  return launch_bwd_tc<128>(args, static_cast<bf16*>(db),
                            static_cast<bf16*>(dc), da, B, stream);
}

// The dynamic shared memory of the bf16 backward's kernel (a) (which 0) or
// (c) (which 1) at N, in bytes.
extern "C" int ssd_scan_bwd_smem(int N, int which) {
  if (N <= 64) return which == 0 ? StatePlan<64>::kBytes : ChunkPlan<64>::kBytes;
  return which == 0 ? StatePlan<128>::kBytes : ChunkPlan<128>::kBytes;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
