// Flash decode: one query token per sequence against the layer's KV cache,
// over the live positions 0..pos, with grouped-query heads.
//
// Replaces the TPU kernel src/repro/kernels/flash_decode/kernel.py::
// flash_decode_bhd (body _decode_body) and its wrapper ops.py::
// flash_decode_attention, and computes the same function:
//   s[t] = (q . k[t]) * scale in fp32 for t <= pos (-1e30 past pos), K read
//   as fp32 whatever the cache's type; running max, denominator and
//   accumulator in fp32, block by block in ascending position; p rounded
//   to P's type before P.V (the TPU kernel's: v's type; the reference
//   model's: the query's, which the model passes); out = acc / max(l,
//   1e-30) in q's type; kv_head = head / (H / Hkv).
// The caches are of the query's type (fp32 or bf16) or e4m3 (fp8), read in
// 16-byte chunks (16 e4m3 values; 8 bytes where a lane serves 4 or more
// query heads, to keep its accumulators in registers) and widened in
// registers: to fp32 for Q.K^T, and V to fp32 for the products with P in
// P's type (a product of two e4m3 or bf16 values is exact in fp32, so this
// is the TPU kernel's P.V in V's type with fp32 accumulation).
// The log-sum-exp variant (lse != null) computes the same over one rank's
// slice of a cache sharded over the sequence, the positions offset..offset
// + S_loc - 1 with pos global, and writes the fp32 output, normalised and
// not rounded, and each (b, h) row's log-sum-exp, natural log, for the
// merge across ranks (a slice with no live position: out = 0 and lse =
// -inf, as the TPU kernel leaves acc = 0 and l = 0 when it skips every
// block).
// pos is read on the device from an int32 (the TPU kernel takes it as a
// scalar block), so a decode step needs no device->host copy, and positions
// past pos are never read (the TPU kernel's pl.when(isb * bs <= pos)). The
// cache is read in the model's layout (B, S_max, Hkv, D) through its
// strides: the TPU wrapper pads D to 128, pads S to the block and transposes
// the whole cache on every call; this kernel copies and pads nothing.
//
// What bounds it on an H100: bytes. At the serving shapes (B = 8, H = Hkv =
// 32, D = 112, pos up to 2,079, bf16) a launch reads 2 * B * (pos + 1) * Hkv *
// D values of K and V (235 MB at pos = 2,047: 70 us at 3.35 TB/s; half of
// that from an e4m3 cache) and does 4 FLOPs per value read per query head.
//
// Design: split-KV with the combine in a thread-block cluster. The grid is
// (splits, Hkv, B) with a cluster of `splits` blocks (at most 8, the
// portable size) along x; split i covers the positions [i * span, (i + 1) *
// span). The wrapper fixes splits and span from the shapes and the SM count
// (about two blocks per SM), never from pos, so pos never goes to the host;
// a split that starts past pos loads nothing. (A split with nothing to
// read still holds its place until its cluster is done, so on an H100
// fewer, longer splits ran faster once B * Hkv blocks fill the card.) One
// block serves all G = H / Hkv query heads of its KV head, so the cache is
// read once.
// Each warp streams its own rows with no block-wide barrier: a row is read
// by a group of lpr lanes, each holding kCpl chunks of K and of V (for
// bf16 at G = 1, 2 chunks: 7 lanes of 8 at D = 112), loaded straight into
// registers, the next step's rows while this step's are used. A lane
// reduces its dot products over the group with shuffles and keeps the
// group's online softmax (m, l, in log2 units: q is scaled by scale *
// log2(e) once) and its chunks of the accumulator per head in registers.
// The block's row groups then merge in shared memory in a fixed order, and
// each block leaves (m, l, acc[G][D]) there; after cluster.sync() every
// block merges its slice of the outputs over the splits in split order,
// reading the others' through distributed shared memory (an empty split or
// row group gives m = -1e30, l = 0, acc = 0): no second launch, no scratch
// in device memory, no atomics, the same result every run.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>


namespace {

namespace cg = cooperative_groups;
using fp8 = __nv_fp8_e4m3;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 2;        // rows a row group loads together
constexpr int kTile = 64;         // the span is a multiple of this
constexpr int kMaxD = 128;
constexpr int kMaxG = 8;          // query heads per KV head
constexpr int kMaxSplits = 8;     // the portable cluster size
constexpr int kMaxDevices = 64;
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

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

// a chunk of kBytes bytes, loaded by one instruction
template <int kBytes> struct Chunk;
template <> struct Chunk<16> { using type = uint4; };
template <> struct Chunk<8> { using type = uint2; };

// the values of one chunk of a cache of the tag's type, as floats
__device__ __forceinline__ void unpack(const uint4& u, float* f,
                                       const float*) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* f,
                                       const __nv_bfloat16*) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
// four e4m3 values, the lowest byte first, widened exactly (e4m3 -> f16
// -> f32, two at a time)
__device__ __forceinline__ void fp8x4(unsigned w, float* f) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>((w >> (16 * i)) & 0xffffu),
        __NV_E4M3);
    const float2 x = __half22float2(__half2(h));
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}
__device__ __forceinline__ void unpack(const uint4& u, float* f,
                                       const fp8*) {
  fp8x4(u.x, f);
  fp8x4(u.y, f + 4);
  fp8x4(u.z, f + 8);
  fp8x4(u.w, f + 12);
}
__device__ __forceinline__ void unpack(const uint2& u, float* f,
                                       const fp8*) {
  fp8x4(u.x, f);
  fp8x4(u.y, f + 4);
}

// p rounded to P's type: 0 fp32 (as it is), 1 bf16, 2 e4m3 (round to
// nearest even, as torch's and JAX's casts)
__device__ __forceinline__ float round_p(float p, int mode) {
  if (mode == 1) return __bfloat162float(__float2bfloat16(p));
  if (mode == 2) return static_cast<float>(fp8(p));
  return p;
}

// the floats of shared memory: each row group's m and l per head and its
// accumulator, then the block's (m, l, acc) that the cluster's blocks read
__host__ __device__ constexpr int smem_floats(int slots, int kG, int D) {
  return slots * kG * (D + 2) + kG * (D + 2);
}

// TQ the query's (and the output's) type, TC the cache's; kG >= G query
// heads per KV head (1, 2, 4 or 8); a lane holds kCpl chunks of kCB bytes
// of a row (chunks j, j + lpr, ...); kU rows per row group have their loads
// in flight together. With lse_out the output is fp32 and each row's
// log-sum-exp is written too.
template <typename TQ, typename TC, int kG, int kCpl, int kCB, int kU>
__global__ void __launch_bounds__(kThreads)
flash_decode_split_kernel(const TQ* __restrict__ q, const TC* __restrict__ kc,
                          const TC* __restrict__ vc,
                          const int* __restrict__ pos_ptr, void* out,
                          float* __restrict__ lse_out, int H, int Hkv, int D,
                          int S_loc, long long k_sb, long long k_ss,
                          long long k_sh, long long v_sb, long long v_ss,
                          long long v_sh, float scale_log2, int pround,
                          int offset, int span, int lpr) {
  using ChunkT = typename Chunk<kCB>::type;
  constexpr int E = kCB / sizeof(TC);   // values per chunk
  constexpr int W = kCpl * E;           // values of a row per lane
  const TC* tag = nullptr;
  cg::cluster_group cluster = cg::this_cluster();
  const int G = H / Hkv, cpr = D / E;
  const int rpw = 32 / lpr, slots = kWarps * rpw;   // row groups
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int slot = warp * rpw + lane / lpr, j = lane % lpr;
  bool act[kCpl];
#pragma unroll
  for (int c = 0; c < kCpl; ++c) act[c] = j + lpr * c < cpr;
  const int split = static_cast<int>(cluster.block_rank());
  const int kvh = blockIdx.y, b = blockIdx.z;
  const TC* kb = kc + b * k_sb + kvh * k_sh + j * E;
  const TC* vb = vc + b * v_sb + kvh * v_sh + j * E;
  // the G query heads of this KV head are kvh * G .. kvh * G + G - 1; q is
  // held scaled by scale * log2(e), so the scores come out in log2 units
  const size_t qoff = (static_cast<size_t>(b) * H +
                       static_cast<size_t>(kvh) * G) * D;
  float qv[kG][W], m[kG], l[kG], acc[kG][W];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCpl; ++c)
#pragma unroll
      for (int e = 0; e < E; ++e) {
        acc[g][c * E + e] = 0.0f;
        qv[g][c * E + e] =
            act[c] && g < G
                ? to_f(q[qoff + g * D + (j + lpr * c) * E + e]) * scale_log2
                : 0.0f;
      }
  }
  // the live positions of this slice: global offset + t <= pos
  const int n_live = min(max(*pos_ptr + 1 - offset, 0), S_loc);
  const int s_begin = split * span;
  const int s_end = min(s_begin + span, n_live);

  // the block takes kU * slots rows a step (the bound is block-uniform, so
  // every lane of a warp takes part in the shuffles); the next step's rows
  // are loaded while this step's are used
  const int step = kU * slots;
  ChunkT kn[kU][kCpl], vn[kU][kCpl];
  auto load = [&](int it) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int r = it + u * slots + slot;
#pragma unroll
      for (int c = 0; c < kCpl; ++c) {
        const bool in = act[c] && r < s_end;
        const long long off = lpr * c * E;
        kn[u][c] = in ? __ldg(reinterpret_cast<const ChunkT*>(
                            kb + r * k_ss + off))
                      : ChunkT{};
        vn[u][c] = in ? __ldg(reinterpret_cast<const ChunkT*>(
                            vb + r * v_ss + off))
                      : ChunkT{};
      }
    }
  };
  load(s_begin);
  for (int it = s_begin; it < s_end; it += step) {
    ChunkT kr[kU][kCpl], vr[kU][kCpl];
    bool valid[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      valid[u] = it + u * slots + slot < s_end;
#pragma unroll
      for (int c = 0; c < kCpl; ++c) {
        kr[u][c] = kn[u][c];
        vr[u][c] = vn[u][c];
      }
    }
    load(it + step);
    float s[kU][kG];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      float d[kG];
#pragma unroll
      for (int g = 0; g < kG; ++g) d[g] = 0.0f;
#pragma unroll
      for (int c = 0; c < kCpl; ++c) {
        float kf[E];
        unpack(kr[u][c], kf, tag);
#pragma unroll
        for (int g = 0; g < kG; ++g)
#pragma unroll
          for (int e = 0; e < E; ++e)
            d[g] = fmaf(qv[g][c * E + e], kf[e], d[g]);
      }
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        for (int o = lpr / 2; o >= 1; o >>= 1)
          d[g] += __shfl_xor_sync(0xffffffffu, d[g], o);
        s[u][g] = valid[u] ? d[g] : kNegInf;
      }
    }
    float p[kG][kU];
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      float mt = kNegInf;
#pragma unroll
      for (int u = 0; u < kU; ++u) mt = fmaxf(mt, s[u][g]);
      const float m_new = fmaxf(m[g], mt);
      const float corr = exp2f(m[g] - m_new);
      float ps = 0.0f;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        p[g][u] = valid[u] ? exp2f(s[u][g] - m_new) : 0.0f;
        ps += p[g][u];
        p[g][u] = round_p(p[g][u], pround);   // p.astype(P's type)
      }
      l[g] = l[g] * corr + ps;
      m[g] = m_new;
#pragma unroll
      for (int w = 0; w < W; ++w) acc[g][w] *= corr;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u)
#pragma unroll
      for (int c = 0; c < kCpl; ++c) {
        float vf[E];
        unpack(vr[u][c], vf, tag);
#pragma unroll
        for (int g = 0; g < kG; ++g)
#pragma unroll
          for (int e = 0; e < E; ++e)
            acc[g][c * E + e] = fmaf(p[g][u], vf[e], acc[g][c * E + e]);
      }
  }

  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);   // [slots][kG]
  float* sl = sm + slots * kG;                    // [slots][kG]
  float* sa = sl + slots * kG;                    // [slots][kG][D]
  float* pm = sa + slots * kG * D;                // [kG]
  float* pl = pm + kG;                            // [kG]
  float* pacc = pl + kG;                          // [kG][D]
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    if (j == 0) {
      sm[slot * kG + g] = m[g];
      sl[slot * kG + g] = l[g];
    }
#pragma unroll
    for (int c = 0; c < kCpl; ++c) {
      if (act[c]) {
#pragma unroll
        for (int e = 0; e < E; ++e)
          sa[(slot * kG + g) * D + (j + lpr * c) * E + e] = acc[g][c * E + e];
      }
    }
  }
  __syncthreads();
  // the block's row groups in order (a group with no row: m = -1e30, l = 0)
  for (int x = tid; x < G * D; x += kThreads) {
    const int g = x / D, c = x % D;
    float mx = kNegInf;
#pragma unroll 8
    for (int r = 0; r < slots; ++r) mx = fmaxf(mx, sm[r * kG + g]);
    float lsum = 0.0f, a = 0.0f;
#pragma unroll 8
    for (int r = 0; r < slots; ++r) {
      const float w = exp2f(sm[r * kG + g] - mx);
      lsum = fmaf(sl[r * kG + g], w, lsum);
      a = fmaf(sa[(r * kG + g) * D + c], w, a);
    }
    pacc[x] = a;
    if (c == 0) {
      pm[g] = mx;
      pl[g] = lsum;
    }
  }
  cluster.sync();

  // each block of the cluster merges its slice of the G * D outputs over
  // the splits in split order, reading the others' partial results through
  // distributed shared memory (all of a thread's reads issued together)
  const int n = static_cast<int>(cluster.num_blocks());
  const int per = (G * D + n - 1) / n;
  const int x1 = min(G * D, (split + 1) * per);
  for (int x = split * per + tid; x < x1; x += kThreads) {
    const int g = x / D;
    float rm[kMaxSplits], rl[kMaxSplits], ra[kMaxSplits];
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) {
      if (r < n) {
        rm[r] = cluster.map_shared_rank(pm, r)[g];
        rl[r] = cluster.map_shared_rank(pl, r)[g];
        ra[r] = cluster.map_shared_rank(pacc, r)[x];
      }
    }
    float mx = kNegInf;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r)
      if (r < n) mx = fmaxf(mx, rm[r]);
    float lsum = 0.0f, a = 0.0f;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) {
      if (r < n) {
        const float w = exp2f(rm[r] - mx);
        lsum = fmaf(rl[r], w, lsum);
        a = fmaf(ra[r], w, a);
      }
    }
    const float o = a / fmaxf(lsum, 1e-30f);
    if (lse_out != nullptr) {
      static_cast<float*>(out)[qoff + x] = o;
      if (x % D == 0)   // once a row: the natural log of l * 2^m
        lse_out[qoff / D + g] = lsum > 0.0f ? (mx + log2f(lsum)) * kLn2
                                            : -__int_as_float(0x7f800000);
    } else {
      static_cast<TQ*>(out)[qoff + x] = from_f<TQ>(o);
    }
  }
  cluster.sync();   // each block's shared memory lives until all have read
}

struct Args {
  const void *q, *kc, *vc;
  const int* pos;
  void* out;
  float* lse;
  int B, H, Hkv, D, S_loc;
  long long k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float scale;
  int pround, offset, splits, span;
  cudaStream_t stream;
};

template <typename TQ, typename TC, int kG>
int launch(const Args& a) {
  // an e4m3 cache: one chunk a lane, of 8 bytes from 4 query heads a KV
  // head up (the accumulators of 8 heads x 16 values would not stay in
  // registers)
  constexpr bool kNarrow = sizeof(TC) == 1;
  constexpr int kCB = kNarrow && kG >= 4 ? 8 : 16;
  constexpr int kCpl = kNarrow || kG > 1 ? 1 : 2;
  const auto kernel =
      flash_decode_split_kernel<TQ, TC, kG, kCpl, kCB, kUnroll>;
  const int cpr = a.D / (kCB / static_cast<int>(sizeof(TC)));
  int lpr = 1;   // lanes per row: the power of two >= a row's chunks / kCpl
  while (lpr * kCpl < cpr) lpr *= 2;
  const int smem = 4 * smem_floats(kWarps * (32 / lpr), kG, a.D);
  static int opted[kMaxDevices];   // set the attribute once per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (opted[dev] < smem) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted[dev] = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.splits, a.Hkv, a.B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const TQ*>(a.q),
                           static_cast<const TC*>(a.kc),
                           static_cast<const TC*>(a.vc), a.pos, a.out, a.lse,
                           a.H, a.Hkv, a.D, a.S_loc, a.k_sb, a.k_ss, a.k_sh,
                           a.v_sb, a.v_ss, a.v_sh,
                           a.scale * 1.4426950408889634f, a.pround, a.offset,
                           a.span, lpr);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TC>
int launch_g(const Args& a) {
  const int G = a.H / a.Hkv;
  if (G == 1) return launch<TQ, TC, 1>(a);
  if (G == 2) return launch<TQ, TC, 2>(a);
  if (G <= 4) return launch<TQ, TC, 4>(a);
  return launch<TQ, TC, 8>(a);
}

}  // namespace

// q (B, 1, H, D) contiguous, of qtype (0 = float32, 1 = bfloat16); the
// caches (B, S_loc, Hkv, D) of ctype (0 = float32, 1 = bfloat16, 2 = e4m3;
// the query's type or e4m3) with the given element strides for B, S and
// Hkv and unit stride over D, 16-byte aligned rows (D and the strides
// multiples of 16 bytes); pos one int32 on the device; P rounded to pround
// (0 = as it is, float32; 1 = bfloat16; 2 = e4m3). With lse null, out (B,
// 1, H, D) of qtype and offset 0; else out fp32 and lse (B, 1, H) fp32 for
// the slice of positions offset..offset + S_loc - 1. D <= 128, D % 8 == 0,
// H / Hkv <= 8; splits (1..8) blocks of span positions (a multiple of 64)
// cover S_loc.
extern "C" int flash_decode_fwd(int qtype, int ctype, int pround,
                                const void* q, const void* kc, const void* vc,
                                const int* pos, void* out, float* lse, int B,
                                int H, int Hkv, int D, int S_loc,
                                long long k_sb, long long k_ss, long long k_sh,
                                long long v_sb, long long v_ss, long long v_sh,
                                float scale, int offset, int splits, int span,
                                cudaStream_t stream) {
  if (D > kMaxD || D % 8 != 0 || H % Hkv != 0 || H / Hkv > kMaxG ||
      splits < 1 || splits > kMaxSplits || span % kTile != 0 ||
      static_cast<long long>(splits) * span < S_loc || pround < 0 ||
      pround > 2 || (ctype == 2 && D % 16 != 0) ||
      (lse == nullptr && offset != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = {q,    kc,   vc,   pos,  out,    lse,    B,    H,
                  Hkv,  D,    S_loc, k_sb, k_ss,  k_sh,   v_sb, v_ss,
                  v_sh, scale, pround, offset, splits, span, stream};
  if (qtype == 0 && ctype == 0) return launch_g<float, float>(a);
  if (qtype == 1 && ctype == 1)
    return launch_g<__nv_bfloat16, __nv_bfloat16>(a);
  if (qtype == 0 && ctype == 2) return launch_g<float, fp8>(a);
  if (qtype == 1 && ctype == 2) return launch_g<__nv_bfloat16, fp8>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
