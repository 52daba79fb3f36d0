// Blocked attention with an online softmax (flash attention), causal or not,
// with grouped-query heads, in the model's (B, S, H, D) layout.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::
// flash_attention_bhsd (body _flash_body) and its wrapper ops.py::
// flash_attention, and computes the same function:
//   s[r, c] = (q[r] . k[c]) * scale in fp32, -1e30 where c >= kv_len or
//             (causal and r < c);
//   running max m, denominator l and accumulator acc in fp32, tile by tile in
//   ascending key order; p = exp(s - m) is rounded to v's type before P.V
//   (the TPU kernel's p.astype(v.dtype)); out = acc / max(l, 1e-30) in q's type;
//   kv_head = head / (H / Hkv), so the grouped heads are never repeated;
//   key tiles wholly above the causal diagonal are never loaded.
// The TPU wrapper pads D to 128 lanes and S to the block and transposes to
// (B, H, S, D); this kernel reads the (B, S, H, D) tensors as they are and
// masks the ragged edge itself, so D = 32, 64, 112 and 128 run unpadded.
//
// What bounds it on an H100: at the serving shapes (B = 8, H = Hkv = 32,
// D = 112, S = 256..2048, bf16) a launch does 4 * B * H * S^2 * D / 2 FLOPs
// of products (240.6 GFLOP at S = 2048) on 0.2 GB of inputs and outputs, so
// operations bound it (0.243 ms at the bf16 tensor rate). bf16 runs on the
// tensor cores with mma.sync (m16n8k16, fp32 accumulation; the products of
// bf16 values are exact, as in the TPU kernel's fp32 dots): one block of 4
// warps per (64-row query tile, head, batch), each warp keeping its 16 rows'
// Q fragments, 16 x 64 scores and 16 x D output in registers (the scores'
// accumulator layout is the A operand of P.V, so P never goes to shared
// memory), K and V^T tiles of 64 keys staged as bf16 with 16-byte loads.
// It issues mma.sync, not Hopper's wgmma, and waits on each tile's loads:
// wgmma with TMA and a pipeline is later work. fp32 runs on CUDA cores in
// fp32 FMA (the tensor cores would round to TF32): one block of 256 threads
// per tile; the query tile kept transposed in shared memory as fp32, each
// 64-key tile of K (transposed) and then V goes through one shared buffer
// (copied with 16-byte loads, all of a thread's issued before any is
// stored), and each thread owns a 4 x 4 block of the score tile and a
// 4 x (D / 16) block of the output accumulator in registers (float4 reads
// of the transposed tiles, 2 shared loads per 16 FMAs in Q.K^T). Row max
// and row sum run over the lanes that hold a row with warp shuffles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 256;    // 16 x 16 threads
constexpr int kTS = kBQ + 4;     // row stride of the transposed tiles (floats)
constexpr int kMaxD = 128;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}
// p rounded to T and back: the TPU kernel's p.astype(v.dtype) before P.V
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}
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

// Stage rows r0..r0+63 of a (S x D) slab (row stride ld elements) in shared
// memory as floats, transposed (dst[c * kTS + r]) or not (dst[r * (D + 1) +
// c], rows padded to an odd stride); rows past S are zeros. 16-byte loads, all of a thread's issued before any
// is stored; consecutive threads take consecutive rows.
template <typename T, bool kTransposed>
__device__ __forceinline__ void stage(const T* __restrict__ src, size_t ld,
                                      int r0, int S, int D, float* dst) {
  constexpr int E = 16 / sizeof(T);
  constexpr int kMaxU = kBK * kMaxD / (E * kThreads);
  const int n = kBK * (D / E);
  uint4 buf[kMaxU];
#pragma unroll
  for (int u = 0; u < kMaxU; ++u) {
    const int i = threadIdx.x + u * kThreads;
    const int r = i % kBK, j = i / kBK;
    buf[u] = (i < n && r0 + r < S)
                 ? *reinterpret_cast<const uint4*>(src + (r0 + r) * ld + j * E)
                 : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int u = 0; u < kMaxU; ++u) {
    const int i = threadIdx.x + u * kThreads;
    if (i < n) {
      const int r = i % kBK, j = i / kBK;
      float f[E];
      unpack(buf[u], f, T());
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int c = j * E + e;
        if (kTransposed)
          dst[c * kTS + r] = f[e];
        else
          dst[r * (D + 1) + c] = f[e];
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int S,
                       int H, int Hkv, int D, float scale, int causal,
                       int kv_len) {
  extern __shared__ float4 smem4[];
  float* sQt = reinterpret_cast<float*>(smem4);  // [D][kTS]   Q^T
  float* sKV = sQt + D * kTS;                     // [D][kTS] K^T, then [kBK][D + 1] V
  float* sPt = sKV + D * kTS;                     // [kBK][kTS] P^T

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const size_t row_q = static_cast<size_t>(H) * D;
  const size_t row_kv = static_cast<size_t>(Hkv) * D;
  const T* qb = q + static_cast<size_t>(b) * S * row_q + static_cast<size_t>(h) * D;
  const T* kb = k + static_cast<size_t>(b) * S * row_kv + static_cast<size_t>(kvh) * D;
  const T* vb = v + static_cast<size_t>(b) * S * row_kv + static_cast<size_t>(kvh) * D;
  T* ob = out + static_cast<size_t>(b) * S * row_q + static_cast<size_t>(h) * D;

  stage<T, true>(qb, row_q, q0, S, D, sQt);

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
  const int nd = D / 16;   // output columns per thread: tx + 16 * j
  const int limit = min(kv_len, S);
  const int kv_end = causal ? min(limit, q0 + kBQ) : limit;

  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();   // the last tile's P.V is done with sKV and sPt
    stage<T, true>(kb, row_kv, k0, S, D, sKV);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&sQt[d * kTS + ty * 4]);
      const float4 bk = *reinterpret_cast<const float4*>(&sKV[d * kTS + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bk.x, bk.y, bk.z, bk.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        const bool live = col < limit && (!causal || row >= col);
        s[i][j] = live ? s[i][j] * scale : kNegInf;
        mt = fmaxf(mt, s[i][j]);
      }
      // the row's 64 columns lie on the 16 lanes of one half-warp
#pragma unroll
      for (int o = 8; o >= 1; o >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_new = fmaxf(m[i], mt);
      const float corr = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        sPt[(tx * 4 + j) * kTS + ty * 4 + i] = round_to<T>(p);
      }
#pragma unroll
      for (int o = 8; o >= 1; o >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= corr;
    }
    __syncthreads();   // Q.K^T is done with sKV; sPt is complete
    stage<T, false>(vb, row_kv, k0, S, D, sKV);
    __syncthreads();
    const int kn = min(kBK, kv_end - k0);   // keys past kv_end have p == 0
    for (int kk = 0; kk < kn; ++kk) {
      const float4 p4 = *reinterpret_cast<const float4*>(&sPt[kk * kTS + ty * 4]);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < nd) {
          const float vv = sKV[kk * (D + 1) + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float inv_l = 1.0f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j < nd) ob[row * row_q + tx + 16 * j] = from_f<T>(acc[i][j] * inv_l);
  }
}

// ---------------------------------------------------------------- bf16
// The bf16 path on the tensor cores: mma.sync m16n8k16 (bf16 products, fp32
// accumulation). Each of 4 warps owns 16 query rows of the block's 64 and
// keeps their Q fragments, their 16 x 64 score tile and their 16 x D output
// accumulator in registers (the scores' accumulator layout is the A operand
// layout of P.V, so P never goes through shared memory); K (row-major) and
// V (transposed) tiles of 64 keys are staged in shared memory as bf16.
constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kVtS = kBK + 8;   // row stride of the transposed V tile (bf16)

__device__ __forceinline__ void mma_bf16_16816(float* d, const unsigned* a,
                                               const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two floats rounded to bf16 in one 32-bit word, the first in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const unsigned l = __bfloat16_as_ushort(__float2bfloat16(lo));
  const unsigned h = __bfloat16_as_ushort(__float2bfloat16(hi));
  return l | (h << 16);
}

__device__ __forceinline__ unsigned load_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__global__ void __launch_bounds__(kMmaThreads)
flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ out, int S, int H,
                           int Hkv, int D, float scale, int causal,
                           int kv_len) {
  extern __shared__ float4 smem4[];
  const int ks = D + 8;                            // K tile row stride (bf16)
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem4);  // [kBK][ks]
  __nv_bfloat16* sVt = sK + kBK * ks;                            // [D][kVtS]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const size_t row_q = static_cast<size_t>(H) * D;
  const size_t row_kv = static_cast<size_t>(Hkv) * D;
  const __nv_bfloat16* qb = q + static_cast<size_t>(b) * S * row_q + static_cast<size_t>(h) * D;
  const __nv_bfloat16* kb = k + static_cast<size_t>(b) * S * row_kv + static_cast<size_t>(kvh) * D;
  const __nv_bfloat16* vb = v + static_cast<size_t>(b) * S * row_kv + static_cast<size_t>(kvh) * D;
  __nv_bfloat16* ob = out + static_cast<size_t>(b) * S * row_q + static_cast<size_t>(h) * D;
  const int nk = D / 16, nd = D / 8;   // k-steps of Q.K^T, n-tiles of P.V
  const int ra = q0 + 16 * warp + gid, rb = ra + 8;   // this thread's rows

  // Q fragments: a[kk] = rows (ra, rb) x cols 16 kk + tig * 2 + {0, 1, 8, 9}
  unsigned qa[kMaxD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kMaxD / 16; ++kk) {
    if (kk < nk) {
      const int c = 16 * kk + 2 * tig;
      qa[kk][0] = ra < S ? load_u32(qb + ra * row_q + c) : 0u;
      qa[kk][1] = rb < S ? load_u32(qb + rb * row_q + c) : 0u;
      qa[kk][2] = ra < S ? load_u32(qb + ra * row_q + c + 8) : 0u;
      qa[kk][3] = rb < S ? load_u32(qb + rb * row_q + c + 8) : 0u;
    }
  }
  float o[kMaxD / 8][4];
#pragma unroll
  for (int j = 0; j < kMaxD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  const int limit = min(kv_len, S);
  const int kv_end = causal ? min(limit, q0 + kBQ) : limit;
  const int cpr = D / 8;   // 16-byte chunks per row

  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();   // the last tile's products are done with sK and sVt
    {
      constexpr int kMaxU = kBK * kMaxD / (8 * kMmaThreads);
      uint4 kbuf[kMaxU], vbuf[kMaxU];
#pragma unroll
      for (int u = 0; u < kMaxU; ++u) {
        const int i = tid + u * kMmaThreads;
        const int r = i % kBK, j = i / kBK;
        const bool in = i < kBK * cpr && k0 + r < S;
        kbuf[u] = in ? *reinterpret_cast<const uint4*>(kb + (k0 + r) * row_kv + 8 * j)
                     : make_uint4(0u, 0u, 0u, 0u);
        vbuf[u] = in ? *reinterpret_cast<const uint4*>(vb + (k0 + r) * row_kv + 8 * j)
                     : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kMaxU; ++u) {
        const int i = tid + u * kMmaThreads;
        if (i < kBK * cpr) {
          const int r = i % kBK, j = i / kBK;
          *reinterpret_cast<uint4*>(sK + r * ks + 8 * j) = kbuf[u];
          const unsigned w[4] = {vbuf[u].x, vbuf[u].y, vbuf[u].z, vbuf[u].w};
          unsigned short* vt = reinterpret_cast<unsigned short*>(sVt);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            vt[(8 * j + 2 * e) * kVtS + r] = static_cast<unsigned short>(w[e] & 0xffffu);
            vt[(8 * j + 2 * e + 1) * kVtS + r] = static_cast<unsigned short>(w[e] >> 16);
          }
        }
      }
    }
    __syncthreads();

    // S = Q K^T: 8 n-tiles of 8 keys; s[j] = rows (ra, rb) x keys
    // k0 + 8 j + tig * 2 + {0, 1}
    float sc[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.0f;
      const __nv_bfloat16* krow = sK + (8 * j + gid) * ks + 2 * tig;
#pragma unroll
      for (int kk = 0; kk < kMaxD / 16; ++kk) {
        if (kk < nk) {
          const unsigned bb[2] = {load_u32(krow + 16 * kk),
                                  load_u32(krow + 16 * kk + 8)};
          mma_bf16_16816(sc[j], qa[kk], bb);
        }
      }
    }
    // mask, scale and the online softmax of rows ra (e = 0, 1) and rb (2, 3)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = hr == 0 ? ra : rb;
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + 8 * j + 2 * tig + e;
          const bool live = col < limit && (!causal || row >= col);
          float& x = sc[j][2 * hr + e];
          x = live ? x * scale : kNegInf;
          mt = fmaxf(mt, x);
        }
      // the row's 64 keys lie on the 4 lanes of a quad
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(m[hr], mt);
      const float corr = expf(m[hr] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[j][2 * hr + e];
          x = expf(x - m_new);
          rs += x;
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l[hr] = l[hr] * corr + rs;
      m[hr] = m_new;
#pragma unroll
      for (int j = 0; j < kMaxD / 8; ++j) {
        o[j][2 * hr] *= corr;
        o[j][2 * hr + 1] *= corr;
      }
    }
    // O += P V, P rounded to bf16 (the TPU kernel's p.astype(v.dtype)); the
    // score tiles 2 kk and 2 kk + 1 are the A fragment of key step kk
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const unsigned pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                              pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                              pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < kMaxD / 8; ++j) {
        if (j < nd) {
          const __nv_bfloat16* vrow = sVt + (8 * j + gid) * kVtS + 16 * kk + 2 * tig;
          const unsigned bb[2] = {load_u32(vrow), load_u32(vrow + 8)};
          mma_bf16_16816(o[j], pa, bb);
        }
      }
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = hr == 0 ? ra : rb;
    if (row >= S) continue;
    const float inv_l = 1.0f / fmaxf(l[hr], 1e-30f);
#pragma unroll
    for (int j = 0; j < kMaxD / 8; ++j)
      if (j < nd)
        *reinterpret_cast<unsigned*>(ob + row * row_q + 8 * j + 2 * tig) =
            pack_bf16(o[j][2 * hr] * inv_l, o[j][2 * hr + 1] * inv_l);
  }
}

int launch_mma(const void* q, const void* k, const void* v, void* out, int B,
               int S, int H, int Hkv, int D, float scale, int causal,
               int kv_len, cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) *
      (static_cast<size_t>(kBK) * (D + 8) + static_cast<size_t>(D) * kVtS);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_attention_mma_kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      S, H, Hkv, D, scale, causal, kv_len);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int Hkv, int D, float scale, int causal, int kv_len,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(D) * kTS +
                                       static_cast<size_t>(kBK) * kTS);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, Hkv, D, scale,
      causal, kv_len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, S, H, D), k and v (B, S, Hkv, D), out (B, S, H, D), all contiguous
// and 16-byte aligned, of one type: dtype 0 = float32, 1 = bfloat16.
// D % 16 == 0, D <= 128.
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k,
                                   const void* v, void* out, int B, int S,
                                   int H, int Hkv, int D, float scale,
                                   int causal, int kv_len,
                                   cudaStream_t stream) {
  if (D % 16 != 0 || D > kMaxD || H % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch<float>(q, k, v, out, B, S, H, Hkv, D, scale, causal,
                         kv_len, stream);
  if (dtype == 1)
    return launch_mma(q, k, v, out, B, S, H, Hkv, D, scale, causal, kv_len,
                      stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
