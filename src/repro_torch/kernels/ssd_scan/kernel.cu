// Mamba2's chunked SSD scan (state-space duality), one block per (head,
// batch) walking the chunks in order with the (P, N) state on chip.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py::ssd_scan_bhsp
// (body _ssd_body) and its wrapper ops.py::ssd_scan, and computes, per chunk
// of Q positions (all in fp32; x, B and C are read in their own type):
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
// What bounds it on an H100: at the serving shapes (B = 8, H = 112, P = N =
// 64, S = 256..2048) it reads x (bf16) and writes y (fp32), 0.7 GB at S =
// 2048 (0.21 ms at 3.35 TB/s), and does about 2 Q P N + Q^2 P / 2 fp32
// FLOPs per position and head (45 GFLOP at S = 2048, 0.67 ms at the fp32
// rate): operations bound it. This first kernel runs on CUDA cores in fp32
// FMA and recomputes C.B^T (Q x Q), which is the same for every head, in
// each head's block. Design: 256 threads as 16 x 16; per chunk B and C
// (rows padded to N + 1 floats), xs (rows padded to P + 1), dt and cum are
// staged in shared memory, B, C and x with 16-byte loads all issued before
// any is stored (cum summed in order by one thread); each product is
// register-blocked (y_off and y as 8 rows x 4 columns a thread, the new
// state 4 x 8, C.B^T 8 x 8), so a thread reads 12 to 16 shared values per
// 32 to 64 FMAs; the
// masked C.B^T is written over B and C (Q x Q floats, 64 KB at Q = 128,
// above the default 48 KB, so the kernel opts in to more shared memory);
// then y = y_off + M.xs is written once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16: (ty, tx)
constexpr int kMaxQ = 128;      // chunk rows ty + 16 i, i < 8
constexpr int kMaxP = 64;       // head width: 16 j + tx (j < 4) or ty + 16 i (i < 4)
constexpr int kMaxN = 128;      // state width: tx + 16 j, j < 8

// the 16 / sizeof(T) values of one 16-byte chunk, as floats
__device__ __forceinline__ void unpack(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* f,
                                       __nv_bfloat16) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Stage rows 0..Q-1 of a (rows x W) tile (row stride ld elements) in shared
// memory as floats, dst[r * dld + c], times rscale[r * rld] where given;
// rows nv..Q-1 are zeros. 16-byte loads, all of a thread's issued before
// any is stored; consecutive threads take consecutive rows, so the stores
// of rows padded to an odd stride do not conflict.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, long long ld,
                                      int nv, int Q, int W, float* dst,
                                      int dld, const float* rscale,
                                      long long rld) {
  constexpr int E = 16 / sizeof(T);
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
      float f[E];
      unpack(buf[u], f, T());
#pragma unroll
      for (int e = 0; e < E; ++e) dst[r * dld + j * E + e] = f[e] * sc[u];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const T* __restrict__ bm, const T* __restrict__ cm,
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
  const T* xb = x + b * x_sb + h * x_sh;
  const T* bb = bm + b * b_sb;
  const T* cb = cm + b * c_sb;
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

template <typename T>
int launch(const void* x, const float* dt, const void* bm, const void* cm,
           const float* a, float* y, float* fin, int B, int S, int H, int P,
           int N, int Q, long long x_sb, long long x_ss, long long x_sh,
           long long b_sb, long long b_ss, long long c_sb, long long c_ss,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(P, N, Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_kernel<T><<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, static_cast<const T*>(bm),
      static_cast<const T*>(cm), a, y, fin, S, H, P, N, Q, x_sb, x_ss, x_sh,
      b_sb, b_ss, c_sb, c_ss);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, S, H, P) with element strides x_sb, x_ss, x_sh and unit stride over
// P; dt (B, S, H) fp32 contiguous, already softplused; B and C (B, S, N) with
// strides (b_sb, b_ss) and (c_sb, c_ss) and unit stride over N; a (H,) fp32
// = -exp(a_log); y (B, S, H, P) and final_state (B, H, P, N) fp32
// contiguous. dtype 0 = float32, 1 = bfloat16 for x, B and C, whose rows
// are read in 16-byte chunks (16-byte aligned, P and N multiples of 16
// bytes). Q <= 128, P <= 64, N <= 128.
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
    return launch<float>(x, dt, bm, cm, a, y, final_state, B, S, H, P, N, Q,
                         x_sb, x_ss, x_sh, b_sb, b_ss, c_sb, c_ss, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, bm, cm, a, y, final_state, B, S, H, P,
                                 N, Q, x_sb, x_ss, x_sh, b_sb, b_ss, c_sb, c_ss,
                                 stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
