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
// operations bound it (0.243 ms at the bf16 tensor rate of 989 TFLOP/s).
//
// bf16 runs on Hopper's warpgroup tensor-core products (wgmma) fed by the
// Tensor Memory Accelerator (TMA), FlashAttention-3 style. One block of three
// warpgroups per (128-row query tile, head, sequence); the grid's x walks a
// head's query tiles in falling order of work, so each head's heaviest
// causal tiles start first and the blocks on the card at once share a few
// heads' K and V in L2. One producer thread keeps TMA loads of
// 128-key K and V tiles in flight through a K ring and a V ring in shared
// memory (full and empty mbarriers each), so a K tile is released once
// Q.K^T has read it and a V tile once P.V has; setmaxnreg moves registers
// from the producer to the two consumer warpgroups of 64 query rows each.
// A consumer computes S = Q.K^T (wgmma m64n128k16, Q and K from shared
// memory, both K-major), its softmax, then O += P.V (P from registers: the
// scores' accumulator layout is the A operand's, rounded to bf16 there, the
// TPU kernel's p.astype(v.dtype); V from shared memory read MN-major with
// wgmma's transpose bit, so V is never transposed by hand; N = 64 and
// D - 64 over V's two boxes, 64 + 48 at D = 112). The two consumers take
// turns to issue Q.K^T (named barriers), so one's softmax overlaps the
// other's products. (ptxas holds every thread to the 168 registers of
// __launch_bounds__(384, 1); overlapping a warpgroup's own softmax with its
// P.V needs the scores, P and O live at once and spilled.)
// The tensors are 4-D tensor maps (D, heads, S, B) read in boxes of 64
// values of one head (one 128-byte swizzled row, the swizzle the wgmma
// descriptors name) over 128 positions: a box never reaches
// into the next head, and TMA fills zeros past D and past S. The softmax
// stays in fp32 registers: the running maximum of the unscaled scores, and
// p = 2^(s c - m c) with c = scale * log2(e), one FFMA and one ex2 a score;
// the causal and kv_len mask is a second copy of the softmax, run only on
// the tiles that cross the diagonal or kv_len. At the serving shape it
// reaches a little over a third of the bf16 rate (PERF.md): one block per
// SM leaves each block's first loads exposed, every 128-row query tile reads
// its K and V through L2 again, and the special-function unit's ex2s queue
// behind one another.
//
// fp32 runs on CUDA cores in fp32 FMA (the tensor cores would round to TF32):
// one block of 256 threads per 64-row tile; the query tile kept transposed in
// shared memory as fp32, each 64-key tile of K (transposed) and then V goes
// through one shared buffer (copied with 16-byte loads, all of a thread's
// issued before any is stored), and each thread owns a 4 x 4 block of the
// score tile and a 4 x (D / 16) block of the output accumulator in registers
// (float4 reads of the transposed tiles, 2 shared loads per 16 FMAs in
// Q.K^T). Row max and row sum run over the lanes that hold a row with warp
// shuffles.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <cstdint>
#include <cstring>
#include <type_traits>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 256;    // 16 x 16 threads
constexpr int kTS = kBQ + 4;     // row stride of the transposed tiles (floats)
constexpr int kMaxD = 128;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
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

// kLse: also write each row's log-sum-exp of its scaled scores, m + log(l),
// to lse (B, H, S) fp32, for the backward
template <typename T, bool kLse>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ lse, int S, int H, int Hkv, int D,
                       float scale, int causal, int kv_len) {
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
    if constexpr (kLse) {
      if (tx == 0)
        lse[(static_cast<size_t>(b) * H + h) * S + row] =
            m[i] + logf(fmaxf(l[i], 1e-30f));
    }
  }
}


// ---------------------------------------------------------------- bf16
// wgmma + TMA. Shared memory (1024-byte aligned, as the 128-byte swizzle
// needs): the Q tile (kChunks boxes of 128 rows x 64 columns, 16 KB each),
// then the K ring and the V ring (kStages tiles each of kChunks boxes of 64
// rows x 64 columns, 8 KB each), then the mbarriers.
constexpr int kTile = 128;            // query rows per block
constexpr int kKeys = 128;            // keys per K or V tile
constexpr int kAtom = 64;             // bf16 columns per 128-byte swizzle row
constexpr int kBoxBytes = kTile * kAtom * 2;      // a Q box
constexpr int kKvBoxBytes = kKeys * kAtom * 2;   // a K or V box
constexpr int kConsumers = 2;         // warpgroups of 64 query rows
constexpr int kWgThreads = 128;
constexpr int kWgmmaThreads = (kConsumers + 1) * kWgThreads;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// wait until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}
// the (64, 1, 128, 1) box at (d, head, s, b) of a 4-D tensor map, completing
// on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int h, int s,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(h), "r"(s),
      "r"(b) : "memory");
}
// wgmma's shared-memory matrix descriptor of a 128-byte-swizzled operand:
// start address, leading and stride byte offsets (in 16-byte units)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo & 0x3FFF) << 16) |
         (static_cast<uint64_t>(sbo & 0x3FFF) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// keep the compiler from moving accesses of wgmma's registers across a wait
template <int N>
__device__ __forceinline__ void pin(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D(64 x 64, fp32) += A(64 x 16, registers) . B(16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const unsigned* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64 x 128, fp32) (+)= A(64 x 16, smem) . B(16 x 128, smem), both K-major
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                             uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// D(64 x 16, fp32) += A(64 x 16, registers) . B(16 x 16, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n16(float* d, const unsigned* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64 x 32, fp32) += A(64 x 16, registers) . B(16 x 32, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n32(float* d, const unsigned* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64 x 48, fp32) += A(64 x 16, registers) . B(16 x 48, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n48(float* d, const unsigned* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O(64 x N) += P(64 x 16) . V(16 x N) for the N columns of one V box
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const unsigned* a,
                                         uint64_t db) {
  static_assert(N == 16 || N == 32 || N == 48 || N == 64, "N");
  if constexpr (N == 16) wgmma_rs_n16(d, a, db);
  if constexpr (N == 32) wgmma_rs_n32(d, a, db);
  if constexpr (N == 48) wgmma_rs_n48(d, a, db);
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
}

// two floats rounded to bf16 in one 32-bit word, the first in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  unsigned r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// kChunks 64-column boxes span D (1: D <= 64, 2: D <= 128). K and V have
// rings of their own, so a K tile is released as soon as Q.K^T has read it
// and a V tile once P.V has.
template <int kChunks>
struct WgmmaPlan {
  static constexpr int kStages = kChunks == 1 ? 4 : 2;
  static constexpr int kQBytes = kChunks * kBoxBytes;
  static constexpr int kTileBytes = kChunks * kKvBoxBytes;
  static constexpr int kBars = 4 * kStages + 1;
  // Q, the K and V rings, the barriers, and slack to align to 1024 bytes
  static constexpr int kSmem =
      kQBytes + 2 * kStages * kTileBytes + 8 * kBars + 1024;
};

// 2^x on the special-function unit (flushes denormals, 2 ulp)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
// named barriers of the two consumer warpgroups (0 is __syncthreads')
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kConsumers * kWgThreads)
               : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id),
               "n"(kConsumers * kWgThreads) : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// kNk = D / 16 k-steps of Q.K^T; kChunks = 64-column boxes spanning D;
// P.V runs over kN0 columns of the first box and kN1 of the second; kLse as
// in the fp32 kernel (m is kept unscaled here: lse = (m c + log2 l) ln 2)
template <int kNk, bool kLse, int kChunks = (kNk + 3) / 4,
          int kN0 = (kNk < 4 ? kNk : 4) * 16, int kN1 = 16 * kNk - kN0>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             __nv_bfloat16* __restrict__ out,
                             float* __restrict__ lse, int S, int H,
                             int Hkv, int D, float scale_log2, int causal,
                             int kv_len) {
  using Plan = WgmmaPlan<kChunks>;
  constexpr int kStages = Plan::kStages, kTileBytes = Plan::kTileBytes;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023u) & ~1023u;
  const uint32_t sK0 = sQ + Plan::kQBytes;              // K ring
  const uint32_t sV0 = sK0 + kStages * kTileBytes;      // V ring
  const uint32_t bars = sV0 + kStages * kTileBytes;
  auto sK = [&](int st) { return sK0 + st * kTileBytes; };
  auto sV = [&](int st) { return sV0 + st * kTileBytes; };
  auto full_k = [&](int st) { return bars + 8 * st; };
  auto empty_k = [&](int st) { return bars + 8 * (kStages + st); };
  auto full_v = [&](int st) { return bars + 8 * (2 * kStages + st); };
  auto empty_v = [&](int st) { return bars + 8 * (3 * kStages + st); };
  const uint32_t qbar = bars + 32 * kStages;

  const int tid = threadIdx.x;
  // x walks a head's query tiles in falling order of work, so the blocks
  // on the card at once share few heads' K and V (they stay in L2) and
  // each head's heaviest tiles start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int limit = min(kv_len, S);
  const int kv_end = causal ? min(limit, q0 + kTile) : limit;
  const int n_tiles = (kv_end + kKeys - 1) / kKeys;

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_k(st), 1);                 // the producer's arrival
      mbar_init(full_v(st), 1);
      mbar_init(empty_k(st), kConsumers * 4);   // each consumer warp's
      mbar_init(empty_v(st), kConsumers * 4);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers * kWgThreads) {
    // the producer warpgroup: one thread issues every load, K_i before V_i
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == kConsumers * kWgThreads) {
      mbar_expect_tx(qbar, Plan::kQBytes);
      for (int c = 0; c < kChunks; ++c)
        tma_load(sQ + c * kBoxBytes, &tq, qbar, c * kAtom, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        const unsigned ph = ((i / kStages) & 1) ^ 1;
        mbar_wait(empty_k(st), ph);
        mbar_expect_tx(full_k(st), kTileBytes);
        for (int c = 0; c < kChunks; ++c)
          tma_load(sK(st) + c * kKvBoxBytes, &tk, full_k(st), c * kAtom, kvh,
                   i * kKeys, b);
        mbar_wait(empty_v(st), ph);
        mbar_expect_tx(full_v(st), kTileBytes);
        for (int c = 0; c < kChunks; ++c)
          tma_load(sV(st) + c * kKvBoxBytes, &tv, full_v(st), c * kAtom, kvh,
                   i * kKeys, b);
      }
    }
  } else {
    // a consumer warpgroup: query rows q0 + 64 wg .. + 63. The two
    // warpgroups take turns to issue Q.K^T (named barriers 1 and 2), so
    // one's softmax overlaps the other's products.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = tid / kWgThreads;
    const int warp = (tid % kWgThreads) / 32, lane = tid % 32;
    const int quad = lane / 4, t4 = lane % 4;
    const int r0 = q0 + 64 * wg + 16 * warp + quad;   // rows r0 and r0 + 8
    // this warpgroup's 64 rows of each Q box (64 rows x 128 bytes)
    const uint32_t qa = sQ + wg * 64 * 128;
    // o0[4 j + 2 hr + e] is row r0 + 8 hr, column 8 j + 2 t4 + e; o1 the
    // same 64 columns on
    float o0[kN0 / 2], o1[kN1 > 0 ? kN1 / 2 : 1];
#pragma unroll
    for (int i = 0; i < kN0 / 2; ++i) o0[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < kN1 / 2; ++i) o1[i] = 0.0f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
    // P of the tile, rounded to bf16 (the TPU kernel's p.astype(v.dtype)):
    // the score blocks 2 kk and 2 kk + 1 are the A fragment of key step kk
    unsigned p[8][4];
    // O += P V over V's tile st; V's key step kk is 16 rows of 128 bytes
    // into each box
    auto pv = [&](int st) {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        wgmma_rs<kN0>(o0, p[kk], sw128_desc(sV(st) + kk * 2048, 64, 64));
        if constexpr (kN1 > 0)
          wgmma_rs<kN1>(o1, p[kk], sw128_desc(sV(st) + kKvBoxBytes +
                                                  kk * 2048, 64, 64));
      }
    };
    auto pin_o = [&] {
      pin<kN0 / 2>(o0);
      if constexpr (kN1 > 0) pin<kN1 / 2>(o1);
    };
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // S = Q K^T over K's tile st: 64 x 128 in fp32; k-step kk is 32 bytes
    // into box kk / 4. s[4 j + 2 hr + e] is row r0 + 8 hr, key
    // k0 + 8 j + 2 t4 + e.
    float s[64];
    auto qk = [&](int st) {
#pragma unroll
      for (int kk = 0; kk < kNk; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss_n128(s, sw128_desc(qa + (kk / 4) * kBoxBytes + off, 1, 64),
                     sw128_desc(sK(st) + (kk / 4) * kKvBoxBytes + off, 1, 64),
                     kk > 0);
      }
    };
    // the online softmax of tile k0: m is the running maximum of the
    // unscaled scores and p = 2^(s c - m c) with c = scale * log2(e), one
    // FFMA and one ex2 a score; the mask is compiled into a second copy,
    // which runs only on the tiles that cross the diagonal or kv_len
    float corr[2];
    auto softmax_as = [&](int k0, auto masked_t) {
      constexpr bool masked = decltype(masked_t)::value;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = r0 + 8 * hr;
        float mx[2] = {kNegInf, kNegInf};   // two chains
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[4 * j + 2 * hr + e];
            if constexpr (masked) {
              const int col = k0 + 8 * j + 2 * t4 + e;
              if (col >= limit || (causal && col > row)) x = kNegInf;
            }
            mx[e] = fmaxf(mx[e], x);
          }
        float mt = fmaxf(mx[0], mx[1]);
        // the row's 128 keys lie on the 4 lanes of a quad
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
        const float m_new = fmaxf(m[hr], mt);
        corr[hr] = ex2((m[hr] - m_new) * scale_log2);
        const float mc = m_new * scale_log2;
        float sum[2] = {0.0f, 0.0f};   // two chains
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[4 * j + 2 * hr + e];
            x = ex2(fmaf(x, scale_log2, -mc));
            sum[e] += x;
          }
        float rs = sum[0] + sum[1];
        rs += __shfl_xor_sync(0xffffffffu, rs, 1);
        rs += __shfl_xor_sync(0xffffffffu, rs, 2);
        l[hr] = l[hr] * corr[hr] + rs;
        m[hr] = m_new;
      }
    };
    auto softmax = [&](int k0) {
      if (k0 + kKeys > limit || (causal && k0 + kKeys - 1 > q0 + 64 * wg))
        softmax_as(k0, std::true_type());
      else
        softmax_as(k0, std::false_type());
    };
    auto pack_p = [&] {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
    };
    mbar_wait(qbar, 0);
    if (wg == 1) bar_arrive(1);   // warpgroup 0 issues first

    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % kStages;
      mbar_wait(full_k(st), (i / kStages) & 1);
      bar_sync(1 + wg);   // this warpgroup's turn to issue
      wgmma_fence();
      qk(st);
      wgmma_commit();
      // the other warpgroup's turn (warpgroup 1's last turn has no taker)
      if (wg == 0 || i + 1 < n_tiles) bar_arrive(2 - wg);
      wgmma_wait<0>();
      pin<64>(s);
      release(empty_k(st));
      softmax(i * kKeys);
#pragma unroll
      for (int j = 0; j < kN0 / 2; ++j) o0[j] *= corr[(j / 2) % 2];
#pragma unroll
      for (int j = 0; j < kN1 / 2; ++j) o1[j] *= corr[(j / 2) % 2];
      pack_p();
      mbar_wait(full_v(st), (i / kStages) & 1);
      wgmma_fence();
      pv(st);
      wgmma_commit();
      wgmma_wait<0>();
      pin_o();
      release(empty_v(st));
    }

    const size_t row_q = static_cast<size_t>(H) * D;
    __nv_bfloat16* ob = out + static_cast<size_t>(b) * S * row_q +
                        static_cast<size_t>(h) * D;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = r0 + 8 * hr;
      if (row >= S) continue;
      const float inv_l = 1.0f / fmaxf(l[hr], 1e-30f);
      __nv_bfloat16* orow = ob + row * row_q + 2 * t4;
#pragma unroll
      for (int j = 0; j < kN0 / 8; ++j)
        *reinterpret_cast<unsigned*>(orow + 8 * j) = pack_bf16(
            o0[4 * j + 2 * hr] * inv_l, o0[4 * j + 2 * hr + 1] * inv_l);
#pragma unroll
      for (int j = 0; j < kN1 / 8; ++j)
        *reinterpret_cast<unsigned*>(orow + 64 + 8 * j) = pack_bf16(
            o1[4 * j + 2 * hr] * inv_l, o1[4 * j + 2 * hr + 1] * inv_l);
      if constexpr (kLse) {
        if (t4 == 0)
          lse[(static_cast<size_t>(b) * H + h) * S + row] =
              (m[hr] * scale_log2 + log2f(fmaxf(l[hr], 1e-30f))) *
              0.6931471805599453f;
      }
    }
  }
}

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
  if (err == cudaSuccess) done[dev] = bytes;
  return err;
}

template <int kNk, bool kLse>
int launch_wgmma(const CUtensorMap& tq, const CUtensorMap& tk,
                 const CUtensorMap& tv, void* out, void* lse, int B, int S,
                 int H, int Hkv, int D, float scale, int causal, int kv_len,
                 cudaStream_t stream) {
  static int opted[kMaxDevices];
  const int smem = WgmmaPlan<(kNk + 3) / 4>::kSmem;
  cudaError_t err = opt_in_smem(
      reinterpret_cast<const void*>(flash_attention_wgmma_kernel<kNk, kLse>),
      opted, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  flash_attention_wgmma_kernel<kNk, kLse>
      <<<grid, kWgmmaThreads, smem, stream>>>(
          tq, tk, tv, static_cast<__nv_bfloat16*>(out),
          static_cast<float*>(lse), S, H, Hkv, D,
          scale * 1.4426950408889634f, causal, kv_len);
  return static_cast<int>(cudaGetLastError());
}

template <bool kLse>
int launch_bf16(const void* q_map, const void* k_map, const void* v_map,
                void* out, void* lse, int B, int S, int H, int Hkv, int D,
                float scale, int causal, int kv_len, cudaStream_t stream) {
  if (D % 16 != 0 || D < 16 || D > kMaxD || H % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  alignas(64) CUtensorMap tq, tk, tv;
  std::memcpy(&tq, q_map, sizeof(tq));
  std::memcpy(&tk, k_map, sizeof(tk));
  std::memcpy(&tv, v_map, sizeof(tv));
  using Launch = int (*)(const CUtensorMap&, const CUtensorMap&,
                        const CUtensorMap&, void*, void*, int, int, int, int,
                        int, float, int, int, cudaStream_t);
  static const Launch by_nk[8] = {
      launch_wgmma<1, kLse>, launch_wgmma<2, kLse>, launch_wgmma<3, kLse>,
      launch_wgmma<4, kLse>, launch_wgmma<5, kLse>, launch_wgmma<6, kLse>,
      launch_wgmma<7, kLse>, launch_wgmma<8, kLse>};
  return by_nk[D / 16 - 1](tq, tk, tv, out, lse, B, S, H, Hkv, D, scale,
                           causal, kv_len, stream);
}

template <bool kLse>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               void* lse, int B, int S, int H, int Hkv, int D, float scale,
               int causal, int kv_len, cudaStream_t stream) {
  if (D % 16 != 0 || D > kMaxD || H % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  static int opted[kMaxDevices];
  const int smem = static_cast<int>(
      sizeof(float) * (2 * static_cast<size_t>(D) * kTS +
                       static_cast<size_t>(kBK) * kTS));
  cudaError_t err = opt_in_smem(
      reinterpret_cast<const void*>(flash_attention_kernel<float, kLse>),
      opted, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<float, kLse><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), S, H, Hkv, D, scale, causal, kv_len);
  return static_cast<int>(cudaGetLastError());
}

// ---- backward
// The gradient of attention, for training: dQ, dK and dV from dO, the
// forward's output O and each row's log-sum-exp (lse), without the (S, S)
// probabilities in device memory. It is the autograd of the plain version
// (ref.py) on the same inputs:
//   p  = exp(s * scale - lse), 0 where masked (keys >= kv_len; causal r < c);
//   dV = round(p)^T dO, with p rounded to v's type where the plain version
//        rounds it before P.V;
//   Delta = rowsum(dO * O);  dS = p * (dO V^T - Delta);
//   dQ = dS K * scale;  dK = dS^T Q * scale.
// Two kernels, no atomics, so two runs are bitwise equal. The first runs a
// block per (64-row query tile, head, sequence): it computes Delta for its
// rows (written to device memory for the second) and dQ over the key tiles
// up to the diagonal. The second runs a block per (64-key tile, KV head,
// sequence): it walks the G query heads of its group and, for each, the
// query tiles from the diagonal on, accumulating dK and dV in fp32. Both
// recompute the scores and p. Keys past kv_len get zero dK and dV.
// What bounds it on an H100: 2.5 times the forward's products (Q.K^T and
// dO.V^T recomputed, dV, dK and dQ); at granite's training shape (B = 8,
// S = 256, H = 32, Hkv = 8, D = 64, bf16) 5.39 GFLOP, 0.0055 ms at the
// bf16 tensor rate, against 0.0126 ms for its bytes: so bytes, and the
// short causal rows leave the card little work a block.
//
// fp32 runs in fp32 FMA on CUDA cores (the tensor cores would round to
// TF32): 256 threads as 16 x 16, each thread a 4 x 4 block of a score tile
// and a 4 x (D / 16) block of an output, the tiles staged transposed in
// shared memory as fp32, as the fp32 forward does.
//
// bf16 runs its five products on the tensor cores, mma.sync m16n8k16 (bf16
// operands, fp32 accumulators) fed by ldmatrix, 4 warps of 16 rows a
// group. mma.sync and not wgmma: the backward takes its operands in four
// orientations (K and Q as the B operand of a product over D and, through
// ldmatrix's transpose, over positions), which ldmatrix reads from one
// row-major tile each, where wgmma would need a descriptor layout per
// orientation; and at these shapes the causal rows are short, so the
// products are a fraction of a block's time. Tiles stay bf16 in shared
// memory (64 rows of 128-byte lines, 64 columns a line, each 16-byte unit
// XOR-swizzled by the row's low three bits, so ldmatrix reads 8 rows
// without bank conflicts) and are brought by cp.async into a two-stage
// ring: the next tile's copy is in flight while this tile's products run.
// p and dS never leave registers: the score accumulators' layout is the A
// operand's, so p is rounded to bf16 there (the plain version's p.to(v's
// type)) for dV += P^T dO, and dS is rounded to bf16 for dQ += dS K and
// dK += dS^T Q (a rounding point the plain backward, which keeps dS in
// fp32, does not have: ~2^-9 of each term; ref.py's
// flash_attention_backward_rounded rounds where this kernel does).
//   dQ: a block of 128 threads per (64-row query tile, head, sequence);
//   warp w owns rows 16 w ..; the grid's z walks the query tiles in
//   falling order of work, so the longest causal rows start first.
//   dK, dV: a block of 256 threads per (64-key tile, KV head, sequence),
//   two groups of 4 warps; warp w of a group owns keys 16 w ..; the
//   block's (query head, query tile) items from the diagonal on are dealt
//   to the groups in turn, each group with its own ring and named barrier,
//   and at the end group 1's dK and dV accumulators are added to group 0's
//   through shared memory (a fixed order). The grid's z is the key tile,
//   so the heaviest tiles (the first, under a causal mask) start first.
constexpr int kBwdRows = 64;   // query rows or keys per tile

// Stage lse and Delta of rows q0 .. q0 + 63 of head h into shared memory.
__device__ __forceinline__ void stage_rows(const float* __restrict__ lse,
                                           const float* __restrict__ delta,
                                           size_t base, int q0, int S,
                                           float* sLse, float* sDelta) {
  const int t = threadIdx.x;
  if (t < kBwdRows) {
    const int row = q0 + t;
    sLse[t] = row < S ? lse[base + row] : 0.0f;
    sDelta[t] = row < S ? delta[base + row] : 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ o,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        float* __restrict__ delta, float* __restrict__ dq,
                        int S, int H, int Hkv, int D, float scale, int causal,
                        int kv_len) {
  extern __shared__ float4 smem4[];
  float* sQt = reinterpret_cast<float*>(smem4);   // [D][kTS] Q^T
  float* sDOt = sQt + D * kTS;                     // [D][kTS] dO^T
  float* sKt = sDOt + D * kTS;                     // [D][kTS] K^T (O^T first)
  float* sVt = sKt + D * kTS;                      // [D][kTS] V^T
  float* sDSt = sVt + D * kTS;                     // [kBK][kTS] dS^T
  float* sLse = sDSt + kBK * kTS;                  // [64]
  float* sDelta = sLse + kBwdRows;                 // [64]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * kBwdRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const size_t row_q = static_cast<size_t>(H) * D;
  const size_t row_kv = static_cast<size_t>(Hkv) * D;
  const size_t qoff = static_cast<size_t>(b) * S * row_q +
                      static_cast<size_t>(h) * D;
  const size_t kvoff = static_cast<size_t>(b) * S * row_kv +
                       static_cast<size_t>(kvh) * D;
  const size_t base = (static_cast<size_t>(b) * H + h) * S;

  stage<float, true>(q + qoff, row_q, q0, S, D, sQt);
  stage<float, true>(dout + qoff, row_q, q0, S, D, sDOt);
  stage<float, true>(o + qoff, row_q, q0, S, D, sKt);
  __syncthreads();
  if (tid < kBwdRows) {
    // Delta of row q0 + tid, summed over D in order
    float dsum = 0.0f;
    for (int c = 0; c < D; ++c)
      dsum = fmaf(sDOt[c * kTS + tid], sKt[c * kTS + tid], dsum);
    const int row = q0 + tid;
    sDelta[tid] = dsum;
    sLse[tid] = row < S ? lse[base + row] : 0.0f;
    if (row < S) delta[base + row] = dsum;
  }
  __syncthreads();

  float lr[4], dr[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lr[i] = sLse[ty * 4 + i];
    dr[i] = sDelta[ty * 4 + i];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
  const int nd = D / 16;
  const int limit = min(kv_len, S);
  const int kv_end = causal ? min(limit, q0 + kBwdRows) : limit;

  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();   // the last tile's dS.K is done with sKt and sDSt
    stage<float, true>(k + kvoff, row_kv, k0, S, D, sKt);
    stage<float, true>(v + kvoff, row_kv, k0, S, D, sVt);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&sQt[d * kTS + ty * 4]);
      const float4 bk = *reinterpret_cast<const float4*>(&sKt[d * kTS + tx * 4]);
      const float4 g = *reinterpret_cast<const float4*>(&sDOt[d * kTS + ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&sVt[d * kTS + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float kv4[4] = {bk.x, bk.y, bk.z, bk.w};
      const float gv[4] = {g.x, g.y, g.z, g.w};
      const float vv4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(av[i], kv4[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv4[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        const bool live = row < S && col < limit && (!causal || row >= col);
        const float p = live ? expf(s[i][j] * scale - lr[i]) : 0.0f;
        sDSt[(tx * 4 + j) * kTS + ty * 4 + i] = p * (dp[i][j] - dr[i]);
      }
    }
    __syncthreads();   // sDSt is complete
    const int kn = min(kBK, kv_end - k0);
    for (int kk = 0; kk < kn; ++kk) {
      const float4 d4 = *reinterpret_cast<const float4*>(&sDSt[kk * kTS + ty * 4]);
      const float dsv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < nd) {
          const float kvv = sKt[(tx + 16 * j) * kTS + kk];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(dsv[i], kvv, acc[i][j]);
        }
      }
    }
  }

  float* dqb = dq + qoff;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j < nd) dqb[row * row_q + tx + 16 * j] = acc[i][j] * scale;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_dkdv_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int S, int H, int Hkv, int D, float scale,
                          int causal, int kv_len) {
  extern __shared__ float4 smem4[];
  float* sKt = reinterpret_cast<float*>(smem4);   // [D][kTS] K^T
  float* sVt = sKt + D * kTS;                      // [D][kTS] V^T
  float* sQt = sVt + D * kTS;                      // [D][kTS] Q^T
  float* sDOt = sQt + D * kTS;                     // [D][kTS] dO^T
  float* sP = sDOt + D * kTS;                      // [kBQ][kTS] P, by row
  float* sDS = sP + kBQ * kTS;                     // [kBQ][kTS] dS, by row
  float* sLse = sDS + kBQ * kTS;                   // [64]
  float* sDelta = sLse + kBwdRows;                 // [64]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int k0 = blockIdx.x * kBwdRows;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv;
  const size_t row_q = static_cast<size_t>(H) * D;
  const size_t row_kv = static_cast<size_t>(Hkv) * D;
  const size_t kvoff = static_cast<size_t>(b) * S * row_kv +
                       static_cast<size_t>(kvh) * D;
  const int nd = D / 16;
  const int limit = min(kv_len, S);

  float ak[4][8], av[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) ak[i][j] = av[i][j] = 0.0f;

  if (k0 < limit) {
    stage<float, true>(k + kvoff, row_kv, k0, S, D, sKt);
    stage<float, true>(v + kvoff, row_kv, k0, S, D, sVt);
    for (int g = 0; g < G; ++g) {
      const int h = kvh * G + g;
      const size_t qoff = static_cast<size_t>(b) * S * row_q +
                          static_cast<size_t>(h) * D;
      const size_t base = (static_cast<size_t>(b) * H + h) * S;
      for (int q0 = causal ? k0 : 0; q0 < S; q0 += kBwdRows) {
        __syncthreads();   // the last tile's products are done with sQt,
                           // sDOt, sP, sDS and the row stats
        stage<float, true>(q + qoff, row_q, q0, S, D, sQt);
        stage<float, true>(dout + qoff, row_q, q0, S, D, sDOt);
        stage_rows(lse, delta, base, q0, S, sLse, sDelta);
        __syncthreads();

        // transposed scores: key ty * 4 + i, query row tx * 4 + j
        float s[4][4], dp[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
        for (int d = 0; d < D; ++d) {
          const float4 a = *reinterpret_cast<const float4*>(&sKt[d * kTS + ty * 4]);
          const float4 bq = *reinterpret_cast<const float4*>(&sQt[d * kTS + tx * 4]);
          const float4 w = *reinterpret_cast<const float4*>(&sVt[d * kTS + ty * 4]);
          const float4 g4 = *reinterpret_cast<const float4*>(&sDOt[d * kTS + tx * 4]);
          const float kv4[4] = {a.x, a.y, a.z, a.w};
          const float qv[4] = {bq.x, bq.y, bq.z, bq.w};
          const float vv4[4] = {w.x, w.y, w.z, w.w};
          const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              s[i][j] = fmaf(kv4[i], qv[j], s[i][j]);
              dp[i][j] = fmaf(vv4[i], gv[j], dp[i][j]);
            }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = k0 + ty * 4 + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int r = tx * 4 + j, row = q0 + r;
            const bool live = row < S && key < limit && (!causal || row >= key);
            const float p = live ? expf(s[i][j] * scale - sLse[r]) : 0.0f;
            sP[r * kTS + ty * 4 + i] = p;
            sDS[r * kTS + ty * 4 + i] = p * (dp[i][j] - sDelta[r]);
          }
        }
        __syncthreads();   // sP and sDS are complete
        const int rn = min(kBwdRows, S - q0);
        for (int r = 0; r < rn; ++r) {
          const float4 p4 = *reinterpret_cast<const float4*>(&sP[r * kTS + ty * 4]);
          const float4 d4 = *reinterpret_cast<const float4*>(&sDS[r * kTS + ty * 4]);
          const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
          const float dsv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (j < nd) {
              const float gg = sDOt[(tx + 16 * j) * kTS + r];
              const float qq = sQt[(tx + 16 * j) * kTS + r];
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                av[i][j] = fmaf(pv[i], gg, av[i][j]);
                ak[i][j] = fmaf(dsv[i], qq, ak[i][j]);
              }
            }
          }
        }
      }
    }
  }

  float* dkb = dk + kvoff;
  float* dvb = dv + kvoff;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key >= S) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j < nd) {
        dkb[key * row_kv + tx + 16 * j] = ak[i][j] * scale;
        dvb[key * row_kv + tx + 16 * j] = av[i][j];
      }
  }
}

size_t bwd_dq_smem(int D) {
  return sizeof(float) * (4 * static_cast<size_t>(D) * kTS +
                          static_cast<size_t>(kBK) * kTS + 2 * kBwdRows);
}
size_t bwd_dkdv_smem(int D) {
  return sizeof(float) * (4 * static_cast<size_t>(D) * kTS +
                          2 * static_cast<size_t>(kBQ) * kTS + 2 * kBwdRows);
}

// ---- PTX wrappers of the bf16 backward
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most one of this thread's copy groups is in flight
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t addr, unsigned* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, unsigned* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
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
// the 128 threads of dK/dV's group `grp` (named barrier 1 + grp)
__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + grp) : "memory");
}
// ---- end PTX wrappers

constexpr int kMmaWarps = 4;                  // warps of a group, 16 rows each
constexpr int kMmaThreads = 32 * kMmaWarps;   // dQ's block, a dK/dV group
constexpr int kMmaGroups = 2;                 // dK/dV: groups of a block
constexpr float kLog2e = 1.4426950408889634f;

// byte offset of (row, col) in a tile of 128-byte rows, 64 columns per `sub`
// bytes, each 16-byte unit XOR-swizzled by the row's low three bits
__device__ __forceinline__ uint32_t toff(int row, int col, int sub) {
  return (col >> 6) * sub + row * 128 + ((((col >> 3) ^ row) & 7) << 4) +
         (col & 7) * 2;
}

// the low and high bf16 of a 32-bit word, as floats
__device__ __forceinline__ float bf16_lo(unsigned u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned u) {
  return __uint_as_float(u & 0xffff0000u);
}

// cp.async rows r0 .. r0 + 63 of D bf16 columns (row stride ld elements)
// into a tile at dst; rows past S are zeros. `nthr` threads, `t` this one's
// index among them.
template <int kNk>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src, size_t ld,
                                          int r0, int S, int t, int nthr) {
  constexpr int kUnits = 2 * kNk;   // 16-byte units a row
  constexpr int kSub = kBwdRows * 128;
  for (int i = t; i < kBwdRows * kUnits; i += nthr) {
    const int r = i / kUnits, u = i % kUnits;
    const bool valid = r0 + r < S;
    cp_async16(dst + toff(r, 8 * u, kSub),
               src + (valid ? (r0 + r) * ld + 8 * u : 0), valid);
  }
}

// The bytes of a 64-row tile of D (= 16 kNk) bf16 columns
template <int kNk>
struct BwdTile {
  static constexpr int kSub = kBwdRows * 128;
  static constexpr int kBytes = ((kNk + 3) / 4) * kSub;
};

// dQ and Delta, bf16, on the tensor cores. Shared memory: Q, dO, then a
// two-stage ring of (K, V) tiles.
template <int kNk>
__global__ void __launch_bounds__(kMmaThreads)
attention_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const __nv_bfloat16* __restrict__ o,
                            const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ lse,
                            float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dq, int S, int H,
                            int Hkv, int D, float scale, int causal,
                            int kv_len) {
  using L = BwdTile<kNk>;
  constexpr int kSub = L::kSub, kT = L::kBytes;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t sQ = smem_u32(smem_raw), sDO = sQ + kT;
  auto sK = [&](int st) { return sQ + (2 + 2 * st) * kT; };
  auto sV = [&](int st) { return sQ + (3 + 2 * st) * kT; };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;     // fragment row, column pair
  const int lr = lane & 7, lm = lane >> 3;    // ldmatrix row, matrix
  // z walks the query tiles in falling order of work
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBwdRows;
  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / (H / Hkv);
  const size_t row_q = static_cast<size_t>(H) * D;
  const size_t row_kv = static_cast<size_t>(Hkv) * D;
  const size_t qoff = static_cast<size_t>(b) * S * row_q +
                      static_cast<size_t>(h) * D;
  const __nv_bfloat16* kb = k + static_cast<size_t>(b) * S * row_kv +
                            static_cast<size_t>(kvh) * D;
  const __nv_bfloat16* vb = v + static_cast<size_t>(b) * S * row_kv +
                            static_cast<size_t>(kvh) * D;
  const size_t base = (static_cast<size_t>(b) * H + h) * S;
  const int limit = min(kv_len, S);
  const int kv_end = causal ? min(limit, q0 + kBwdRows) : limit;
  const int n_tiles = (kv_end + kBwdRows - 1) / kBwdRows;

  // Q, dO, K and V's first tiles, and O in the second stage's K slot (free
  // until the first iteration refills it)
  load_tile<kNk>(sQ, q + qoff, row_q, q0, S, tid, kMmaThreads);
  load_tile<kNk>(sDO, dout + qoff, row_q, q0, S, tid, kMmaThreads);
  load_tile<kNk>(sK(1), o + qoff, row_q, q0, S, tid, kMmaThreads);
  load_tile<kNk>(sK(0), kb, row_kv, 0, S, tid, kMmaThreads);
  load_tile<kNk>(sV(0), vb, row_kv, 0, S, tid, kMmaThreads);
  cp_async_commit();
  cp_async_wait_0();
  __syncthreads();

  // Delta = rowsum(dO * O) of this warp's 16 rows: lanes 2 r and 2 r + 1
  // sum the two halves of row r's columns in order, then each other's (a
  // fixed order); each lane keeps its fragment rows' Delta and lse, the
  // latter pre-scaled to base 2
  const int w0 = q0 + 16 * warp;
  float dlt[2], lse2[2];
  {
    const int r = 16 * warp + (lane >> 1), c0 = (lane & 1) * 8 * kNk;
    float sum = 0.0f;
#pragma unroll
    for (int c = c0; c < c0 + 8 * kNk; c += 2) {
      const uint32_t off = toff(r, c, kSub);
      const unsigned dv = *reinterpret_cast<const unsigned*>(smem_raw + (sDO - sQ) + off);
      const unsigned ov = *reinterpret_cast<const unsigned*>(smem_raw + (sK(1) - sQ) + off);
      sum = fmaf(bf16_lo(dv), bf16_lo(ov), fmaf(bf16_hi(dv), bf16_hi(ov), sum));
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (q0 + r < S && (lane & 1) == 0) delta[base + q0 + r] = sum;
    dlt[0] = __shfl_sync(0xffffffffu, sum, 2 * g);
    dlt[1] = __shfl_sync(0xffffffffu, sum, 2 * (g + 8));
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = w0 + g + 8 * hr;
    lse2[hr] = row < S ? lse[base + row] * kLog2e : 0.0f;
  }
  __syncthreads();   // O's slot is refilled by the first iteration
  const float sl = scale * kLog2e;

  // dq[2 np + j][e]: row w0 + g + 8 (e >> 1), column 16 np + 8 j + 2 t4 +
  // (e & 1)
  float acc[2 * kNk][4];
#pragma unroll
  for (int j = 0; j < 2 * kNk; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i & 1, k0 = i * kBwdRows;
    if (i + 1 < n_tiles) {
      load_tile<kNk>(sK(st ^ 1), kb, row_kv, k0 + kBwdRows, S, tid,
                     kMmaThreads);
      load_tile<kNk>(sV(st ^ 1), vb, row_kv, k0 + kBwdRows, S, tid,
                     kMmaThreads);
    }
    cp_async_commit();
    cp_async_wait_1();   // tile i (and Q, dO) landed
    __syncthreads();

    // S = Q K^T and dP = dO V^T, 16 x 64 a warp: s[j][e] is row w0 + g +
    // 8 (e >> 1), key k0 + 8 j + 2 t4 + (e & 1)
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
#pragma unroll
    for (int kt = 0; kt < kNk; ++kt) {
      unsigned qa[4], da[4];
      const uint32_t oa = toff(16 * warp + lr + 8 * (lm & 1),
                               16 * kt + 8 * (lm >> 1), kSub);
      ldsm_x4(sQ + oa, qa);
      ldsm_x4(sDO + oa, da);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned kf[4], vf[4];
        const uint32_t ob = toff(16 * np + lr + 8 * (lm >> 1),
                                 16 * kt + 8 * (lm & 1), kSub);
        ldsm_x4(sK(st) + ob, kf);
        ldsm_x4(sV(st) + ob, vf);
        mma_bf16(s[2 * np], qa, kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qa, kf[2], kf[3]);
        mma_bf16(dp[2 * np], da, vf[0], vf[1]);
        mma_bf16(dp[2 * np + 1], da, vf[2], vf[3]);
      }
    }
    // dS = p (dP - Delta), rounded to bf16 as the A operand of dS K
    unsigned dsa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = w0 + g + 8 * (e >> 1);
        const int col = k0 + 8 * j + 2 * t4 + (e & 1);
        const bool live =
            row < S && col < limit && (!causal || col <= row);
        const float p = live ? ex2(fmaf(s[j][e], sl, -lse2[e >> 1])) : 0.0f;
        s[j][e] = p * (dp[j][e] - dlt[e >> 1]);
      }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      dsa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      dsa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      dsa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      dsa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
    // dQ += dS K: K read transposed (keys are the product's depth)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int np = 0; np < kNk; ++np) {
        unsigned kf[4];
        ldsm_x4_t(sK(st) + toff(16 * kk + lr + 8 * (lm & 1),
                                16 * np + 8 * (lm >> 1), kSub),
                  kf);
        mma_bf16(acc[2 * np], dsa[kk], kf[0], kf[1]);
        mma_bf16(acc[2 * np + 1], dsa[kk], kf[2], kf[3]);
      }
    __syncthreads();   // every warp is done with stage st before its refill
  }

  __nv_bfloat16* dqb = dq + qoff;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = w0 + g + 8 * hr;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < 2 * kNk; ++j)
      *reinterpret_cast<unsigned*>(dqb + row * row_q + 8 * j + 2 * t4) =
          pack_bf16(acc[j][2 * hr] * scale, acc[j][2 * hr + 1] * scale);
  }
}

// dK and dV, bf16, on the tensor cores. Shared memory: K, V, then per
// group a two-stage ring of (Q, dO) tiles, then per group and stage the
// tile's 64 lse and 64 Delta values.
template <int kNk>
struct DkdvPlan {
  static constexpr int kT = BwdTile<kNk>::kBytes;
  static constexpr int kRing = 4 * kT;   // a group's two stages of Q, dO
  static constexpr int kRows = 2 * kT + kMmaGroups * kRing;
  static constexpr int kBytes = kRows + kMmaGroups * 2 * 2 * kBwdRows * 4;
};

template <int kNk>
__global__ void __launch_bounds__(kMmaGroups * kMmaThreads, 1)
attention_bwd_dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const __nv_bfloat16* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dk,
                              __nv_bfloat16* __restrict__ dv, int S, int H,
                              int Hkv, int D, float scale, int causal,
                              int kv_len) {
  using L = DkdvPlan<kNk>;
  constexpr int kSub = BwdTile<kNk>::kSub, kT = L::kT;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t sK = smem_u32(smem_raw), sV = sK + kT;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = warp / kMmaWarps, wg = warp % kMmaWarps;
  const int gt = tid % kMmaThreads;            // thread index in its group
  const int g = lane >> 2, t4 = lane & 3;
  const int lr = lane & 7, lm = lane >> 3;
  const uint32_t ring = sK + 2 * kT + grp * L::kRing;
  auto sQ = [&](int st) { return ring + 2 * st * kT; };
  auto sDO = [&](int st) { return ring + (2 * st + 1) * kT; };
  // a stage's lse (x log2 e, below) and Delta of its 64 rows
  float* const rows = reinterpret_cast<float*>(smem_raw + L::kRows) +
                      grp * 2 * 2 * kBwdRows;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * kBwdRows;   // z = 0 first: the heaviest tile
  const int G = H / Hkv;
  const size_t row_q = static_cast<size_t>(H) * D;
  const size_t row_kv = static_cast<size_t>(Hkv) * D;
  const size_t kvoff = static_cast<size_t>(b) * S * row_kv +
                       static_cast<size_t>(kvh) * D;
  const int limit = min(kv_len, S);
  const int qt0 = causal ? k0 / kBwdRows : 0;
  const int n_qt = (S + kBwdRows - 1) / kBwdRows;
  // the block's items (query head g, query tile qt), g major; none when
  // every key of the tile is past kv_len (its dK and dV are zero)
  const int n_items = k0 < limit ? G * (n_qt - qt0) : 0;

  load_tile<kNk>(sK, k + kvoff, row_kv, k0, S, tid, 2 * kMmaThreads);
  load_tile<kNk>(sV, v + kvoff, row_kv, k0, S, tid, 2 * kMmaThreads);
  cp_async_commit();
  cp_async_wait_0();
  __syncthreads();

  // item it of this group into stage st: Q, dO, lse and Delta
  auto load_item = [&](int it, int st) {
    const int hh = kvh * G + it / (n_qt - qt0);
    const int q0 = (qt0 + it % (n_qt - qt0)) * kBwdRows;
    const size_t qoff = static_cast<size_t>(b) * S * row_q +
                        static_cast<size_t>(hh) * D;
    const size_t base = (static_cast<size_t>(b) * H + hh) * S;
    load_tile<kNk>(sQ(st), q + qoff, row_q, q0, S, gt, kMmaThreads);
    load_tile<kNk>(sDO(st), dout + qoff, row_q, q0, S, gt, kMmaThreads);
    const int r = gt % kBwdRows, row = q0 + r;
    const bool valid = row < S;
    const float* src = gt < kBwdRows ? lse : delta;
    cp_async4(smem_u32(rows + (2 * st + gt / kBwdRows) * kBwdRows + r),
              src + (valid ? base + row : 0), valid);
  };

  // dk[2 np + j][e], dv likewise: key k0 + 16 wg + g + 8 (e >> 1), column
  // 16 np + 8 j + 2 t4 + (e & 1)
  float dka[2 * kNk][4], dva[2 * kNk][4];
#pragma unroll
  for (int j = 0; j < 2 * kNk; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.0f;
  const float sl = scale * kLog2e;
  const int key0 = k0 + 16 * wg;

  if (grp < n_items) load_item(grp, 0);
  cp_async_commit();
  for (int it = grp, j = 0; it < n_items; it += kMmaGroups, ++j) {
    const int st = j & 1;
    if (it + kMmaGroups < n_items) load_item(it + kMmaGroups, st ^ 1);
    cp_async_commit();
    cp_async_wait_1();
    group_sync(grp);
    const int q0 = (qt0 + it % (n_qt - qt0)) * kBwdRows;
    const float* const sl2 = rows + 2 * st * kBwdRows;   // lse
    const float* const sdl = sl2 + kBwdRows;             // Delta
    // two halves of 32 query rows, so that the scores stay few registers
#pragma unroll 1
    for (int hf = 0; hf < 2; ++hf) {
      const int c0 = q0 + 32 * hf;
      if (c0 >= S || (causal && c0 + 31 < key0)) continue;   // all masked
      // S^T = K Q^T and dP^T = V dO^T, 16 keys x 32 rows a warp: s[j][e]
      // is key key0 + g + 8 (e >> 1), row c0 + 8 j + 2 t4 + (e & 1)
      float s[4][4], dp[4][4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[jj][e] = dp[jj][e] = 0.0f;
#pragma unroll
      for (int kt = 0; kt < kNk; ++kt) {
        unsigned ka[4], va[4];
        const uint32_t oa = toff(16 * wg + lr + 8 * (lm & 1),
                                 16 * kt + 8 * (lm >> 1), kSub);
        ldsm_x4(sK + oa, ka);
        ldsm_x4(sV + oa, va);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          unsigned qf[4], of[4];
          const uint32_t ob = toff(32 * hf + 16 * np + lr + 8 * (lm >> 1),
                                   16 * kt + 8 * (lm & 1), kSub);
          ldsm_x4(sQ(st) + ob, qf);
          ldsm_x4(sDO(st) + ob, of);
          mma_bf16(s[2 * np], ka, qf[0], qf[1]);
          mma_bf16(s[2 * np + 1], ka, qf[2], qf[3]);
          mma_bf16(dp[2 * np], va, of[0], of[1]);
          mma_bf16(dp[2 * np + 1], va, of[2], of[3]);
        }
      }
      // P^T rounded to bf16 and dS^T = P^T (dP^T - Delta) rounded to bf16,
      // as A operands over the 32 rows
      unsigned pa[2][4], dsa[2][4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + g + 8 * (e >> 1);
          const int r = 32 * hf + 8 * jj + 2 * t4 + (e & 1), row = q0 + r;
          const bool live =
              row < S && key < limit && (!causal || key <= row);
          const float p =
              live ? ex2(fmaf(s[jj][e], sl, -sl2[r] * kLog2e)) : 0.0f;
          s[jj][e] = p;
          dp[jj][e] = p * (dp[jj][e] - sdl[r]);
        }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        dsa[kk][0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
        dsa[kk][1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
        dsa[kk][2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
        dsa[kk][3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
      }
      // dV += P^T dO and dK += dS^T Q, dO and Q read transposed
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int np = 0; np < kNk; ++np) {
          unsigned of[4], qf[4];
          const uint32_t ob = toff(32 * hf + 16 * kk + lr + 8 * (lm & 1),
                                   16 * np + 8 * (lm >> 1), kSub);
          ldsm_x4_t(sDO(st) + ob, of);
          ldsm_x4_t(sQ(st) + ob, qf);
          mma_bf16(dva[2 * np], pa[kk], of[0], of[1]);
          mma_bf16(dva[2 * np + 1], pa[kk], of[2], of[3]);
          mma_bf16(dka[2 * np], dsa[kk], qf[0], qf[1]);
          mma_bf16(dka[2 * np + 1], dsa[kk], qf[2], qf[3]);
        }
    }
    group_sync(grp);   // the group is done with stage st before its refill
  }

  // group 1's sums added to group 0's in shared memory (group 1's ring,
  // 4 kT >= 2 x 128 threads x 16 kNk floats), then group 0 writes
  __syncthreads();
  float* const part = reinterpret_cast<float*>(smem_raw + 2 * kT +
                                               L::kRing);
  if (grp == 1) {
#pragma unroll
    for (int j = 0; j < 2 * kNk; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        part[(4 * j + e) * kMmaThreads + gt] = dka[j][e];
        part[(8 * kNk + 4 * j + e) * kMmaThreads + gt] = dva[j][e];
      }
  }
  __syncthreads();
  if (grp == 0) {
    __nv_bfloat16* dkb = dk + kvoff;
    __nv_bfloat16* dvb = dv + kvoff;
#pragma unroll
    for (int j = 0; j < 2 * kNk; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dka[j][e] += part[(4 * j + e) * kMmaThreads + gt];
        dva[j][e] += part[(8 * kNk + 4 * j + e) * kMmaThreads + gt];
      }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int key = key0 + g + 8 * hr;
      if (key >= S) continue;
#pragma unroll
      for (int j = 0; j < 2 * kNk; ++j) {
        const size_t off = key * row_kv + 8 * j + 2 * t4;
        *reinterpret_cast<unsigned*>(dkb + off) = pack_bf16(
            dka[j][2 * hr] * scale, dka[j][2 * hr + 1] * scale);
        *reinterpret_cast<unsigned*>(dvb + off) =
            pack_bf16(dva[j][2 * hr], dva[j][2 * hr + 1]);
      }
    }
  }
}

int launch_bwd_dq_f32(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const void* lse,
                      void* delta, void* dq, int B, int S, int H, int Hkv,
                      int D, float scale, int causal, int kv_len,
                      cudaStream_t stream) {
  static int opted[kMaxDevices];
  const int smem = static_cast<int>(bwd_dq_smem(D));
  cudaError_t err = opt_in_smem(
      reinterpret_cast<const void*>(attention_bwd_dq_kernel), opted, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBwdRows - 1) / kBwdRows, H, B);
  attention_bwd_dq_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(o),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<float*>(dq), S, H, Hkv, D,
      scale, causal, kv_len);
  return static_cast<int>(cudaGetLastError());
}

int launch_bwd_dkdv_f32(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dk, void* dv, int B, int S, int H, int Hkv,
                        int D, float scale, int causal, int kv_len,
                        cudaStream_t stream) {
  static int opted[kMaxDevices];
  const int smem = static_cast<int>(bwd_dkdv_smem(D));
  cudaError_t err = opt_in_smem(
      reinterpret_cast<const void*>(attention_bwd_dkdv_kernel), opted, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBwdRows - 1) / kBwdRows, Hkv, B);
  attention_bwd_dkdv_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), S, H, Hkv, D, scale,
      causal, kv_len);
  return static_cast<int>(cudaGetLastError());
}

using bf16_t = __nv_bfloat16;

template <int kNk>
int launch_bwd_dq_mma(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const void* lse,
                      void* delta, void* dq, int B, int S, int H, int Hkv,
                      int D, float scale, int causal, int kv_len,
                      cudaStream_t stream) {
  static int opted[kMaxDevices];
  constexpr int smem = 6 * BwdTile<kNk>::kBytes;
  cudaError_t err = opt_in_smem(
      reinterpret_cast<const void*>(attention_bwd_dq_mma_kernel<kNk>), opted,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, B, (S + kBwdRows - 1) / kBwdRows);
  attention_bwd_dq_mma_kernel<kNk><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16_t*>(q), static_cast<const bf16_t*>(k),
      static_cast<const bf16_t*>(v), static_cast<const bf16_t*>(o),
      static_cast<const bf16_t*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<bf16_t*>(dq), S, H, Hkv, D,
      scale, causal, kv_len);
  return static_cast<int>(cudaGetLastError());
}

template <int kNk>
int launch_bwd_dkdv_mma(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dk, void* dv, int B, int S, int H, int Hkv,
                        int D, float scale, int causal, int kv_len,
                        cudaStream_t stream) {
  static int opted[kMaxDevices];
  constexpr int smem = DkdvPlan<kNk>::kBytes;
  cudaError_t err = opt_in_smem(
      reinterpret_cast<const void*>(attention_bwd_dkdv_mma_kernel<kNk>),
      opted, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(Hkv, B, (S + kBwdRows - 1) / kBwdRows);
  attention_bwd_dkdv_mma_kernel<kNk>
      <<<grid, kMmaGroups * kMmaThreads, smem, stream>>>(
          static_cast<const bf16_t*>(q), static_cast<const bf16_t*>(k),
          static_cast<const bf16_t*>(v), static_cast<const bf16_t*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<bf16_t*>(dk), static_cast<bf16_t*>(dv), S, H, Hkv, D,
          scale, causal, kv_len);
  return static_cast<int>(cudaGetLastError());
}
// ---- end backward

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver library that the CUDA runtime has
// loaded (no link against libcuda)
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return lib ? reinterpret_cast<EncodeTiled>(
                     dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

}  // namespace

// The TMA descriptor of a bf16 tensor viewed as 4-D: dims (innermost first),
// the byte strides of dims 1..3 (multiples of 16), the box; 128-byte swizzle,
// zeros outside the tensor. Written to map_out (128 bytes).
extern "C" int flash_attention_tensor_map(void* map_out, const void* ptr,
                                          const long long* dims,
                                          const long long* strides,
                                          const int* box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorSharedObjectInitFailed);
  alignas(64) CUtensorMap map;
  cuuint64_t gdim[4], gstride[3];
  cuuint32_t bdim[4], estride[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) {
    gdim[i] = static_cast<cuuint64_t>(dims[i]);
    bdim[i] = static_cast<cuuint32_t>(box[i]);
  }
  for (int i = 0; i < 3; ++i) gstride[i] = static_cast<cuuint64_t>(strides[i]);
  const CUresult r = fn(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), gdim, gstride, bdim, estride,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  std::memcpy(map_out, &map, sizeof(map));
  return 0;
}

// bf16: q, k, v given by their tensor maps (flash_attention_tensor_map with
// the (64, 1, 128, 1) box), out (B, S, H, D) contiguous. D % 16 == 0,
// D <= 128.
extern "C" int flash_attention_bf16(const void* q_map, const void* k_map,
                                    const void* v_map, void* out, int B, int S,
                                    int H, int Hkv, int D, float scale,
                                    int causal, int kv_len,
                                    cudaStream_t stream) {
  return launch_bf16<false>(q_map, k_map, v_map, out, nullptr, B, S, H, Hkv,
                            D, scale, causal, kv_len, stream);
}

// fp32: q (B, S, H, D), k and v (B, S, Hkv, D), out (B, S, H, D), all
// contiguous and 16-byte aligned. D % 16 == 0, D <= 128.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* out, int B, int S,
                                   int H, int Hkv, int D, float scale,
                                   int causal, int kv_len,
                                   cudaStream_t stream) {
  return launch_f32<false>(q, k, v, out, nullptr, B, S, H, Hkv, D, scale,
                           causal, kv_len, stream);
}

// The forward of training: as flash_attention_bf16 and flash_attention_f32,
// and also each row's log-sum-exp of its scaled scores to lse (B, H, S) fp32.
extern "C" int flash_attention_lse_bf16(const void* q_map, const void* k_map,
                                        const void* v_map, void* out,
                                        void* lse, int B, int S, int H,
                                        int Hkv, int D, float scale,
                                        int causal, int kv_len,
                                        cudaStream_t stream) {
  return launch_bf16<true>(q_map, k_map, v_map, out, lse, B, S, H, Hkv, D,
                           scale, causal, kv_len, stream);
}

extern "C" int flash_attention_lse_f32(const void* q, const void* k,
                                       const void* v, void* out, void* lse,
                                       int B, int S, int H, int Hkv, int D,
                                       float scale, int causal, int kv_len,
                                       cudaStream_t stream) {
  return launch_f32<true>(q, k, v, out, lse, B, S, H, Hkv, D, scale, causal,
                          kv_len, stream);
}

// The backward (dtype 0: fp32, 1: bf16). q, o, dout, dq (B, S, H, D); k, v,
// dk, dv (B, S, Hkv, D), all contiguous in one type and 16-byte aligned; lse
// and delta (B, H, S) fp32. D % 16 == 0, D <= 128. bwd_dq writes Delta to
// delta and dq; bwd_dkdv, launched after it on the same stream, reads delta
// and writes dk and dv. One kernel launch each.
extern "C" int flash_attention_bwd_dq(int dtype, const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* dout, const void* lse,
                                      void* delta, void* dq, int B, int S,
                                      int H, int Hkv, int D, float scale,
                                      int causal, int kv_len,
                                      cudaStream_t stream) {
  if (D % 16 != 0 || D < 16 || D > kMaxD || H % Hkv != 0 || dtype < 0 ||
      dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_bwd_dq_f32(q, k, v, o, dout, lse, delta, dq, B, S, H, Hkv,
                             D, scale, causal, kv_len, stream);
  using Launch = int (*)(const void*, const void*, const void*, const void*,
                         const void*, const void*, void*, void*, int, int,
                         int, int, int, float, int, int, cudaStream_t);
  static const Launch by_nk[8] = {
      launch_bwd_dq_mma<1>, launch_bwd_dq_mma<2>, launch_bwd_dq_mma<3>,
      launch_bwd_dq_mma<4>, launch_bwd_dq_mma<5>, launch_bwd_dq_mma<6>,
      launch_bwd_dq_mma<7>, launch_bwd_dq_mma<8>};
  return by_nk[D / 16 - 1](q, k, v, o, dout, lse, delta, dq, B, S, H, Hkv, D,
                           scale, causal, kv_len, stream);
}

extern "C" int flash_attention_bwd_dkdv(int dtype, const void* q,
                                        const void* k, const void* v,
                                        const void* dout, const void* lse,
                                        const void* delta, void* dk, void* dv,
                                        int B, int S, int H, int Hkv, int D,
                                        float scale, int causal, int kv_len,
                                        cudaStream_t stream) {
  if (D % 16 != 0 || D < 16 || D > kMaxD || H % Hkv != 0 || dtype < 0 ||
      dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_bwd_dkdv_f32(q, k, v, dout, lse, delta, dk, dv, B, S, H,
                               Hkv, D, scale, causal, kv_len, stream);
  using Launch = int (*)(const void*, const void*, const void*, const void*,
                         const void*, const void*, void*, void*, int, int,
                         int, int, int, float, int, int, cudaStream_t);
  static const Launch by_nk[8] = {
      launch_bwd_dkdv_mma<1>, launch_bwd_dkdv_mma<2>, launch_bwd_dkdv_mma<3>,
      launch_bwd_dkdv_mma<4>, launch_bwd_dkdv_mma<5>, launch_bwd_dkdv_mma<6>,
      launch_bwd_dkdv_mma<7>, launch_bwd_dkdv_mma<8>};
  return by_nk[D / 16 - 1](q, k, v, dout, lse, delta, dk, dv, B, S, H, Hkv, D,
                           scale, causal, kv_len, stream);
}

// The dynamic shared memory of the bf16 backward kernel at D: which 0 is
// dQ's, 1 dK/dV's (bytes; 0 for a D the kernels do not take).
extern "C" int flash_attention_bwd_smem(int D, int which) {
  if (D % 16 != 0 || D < 16 || D > kMaxD) return 0;
  static const int dq[8] = {
      6 * BwdTile<1>::kBytes, 6 * BwdTile<2>::kBytes, 6 * BwdTile<3>::kBytes,
      6 * BwdTile<4>::kBytes, 6 * BwdTile<5>::kBytes, 6 * BwdTile<6>::kBytes,
      6 * BwdTile<7>::kBytes, 6 * BwdTile<8>::kBytes};
  static const int dkdv[8] = {
      DkdvPlan<1>::kBytes, DkdvPlan<2>::kBytes, DkdvPlan<3>::kBytes,
      DkdvPlan<4>::kBytes, DkdvPlan<5>::kBytes, DkdvPlan<6>::kBytes,
      DkdvPlan<7>::kBytes, DkdvPlan<8>::kBytes};
  return which == 0 ? dq[D / 16 - 1] : dkdv[D / 16 - 1];
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
