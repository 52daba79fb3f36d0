// Flash decode: one query token per sequence against the layer's KV cache,
// over the live positions 0..pos, with grouped-query heads.
//
// Replaces the TPU kernel src/repro/kernels/flash_decode/kernel.py::
// flash_decode_bhd (body _decode_body) and its wrapper ops.py::
// flash_decode_attention, and computes the same function:
//   s[t] = (q . k[t]) * scale in fp32 for t <= pos (-1e30 past pos);
//   running max, denominator and accumulator in fp32, block by block in
//   ascending position; p rounded to v's type before P.V; out = acc /
//   max(l, 1e-30) in q's type; kv_head = head / (H / Hkv).
// pos is read on the device from an int32 (the TPU kernel takes it as a
// scalar block), so a decode step needs no device->host copy, and positions
// past pos are never read (the TPU kernel's pl.when(isb * bs <= pos)). The
// cache is read in the model's layout (B, S_max, Hkv, D) through its
// strides: the TPU wrapper pads D to 128, pads S to the block and transposes
// the whole cache on every call; this kernel copies and pads nothing.
//
// What bounds it on an H100: bytes. At the serving shapes (B = 8, H = Hkv =
// 32, D = 112, pos up to 2,079, bf16) a launch reads 2 * B * (pos + 1) * Hkv *
// D values of K and V (235 MB at pos = 2,047: 70 us at 3.35 TB/s) and does
// 4 FLOPs per value read per query head.
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
// by a group of lpr lanes, each holding kCpl 16-byte chunks of K and of V
// (for bf16 at G = 1, 2 chunks: 7 lanes of 8 at D = 112), loaded straight
// into registers, the next step's rows while this step's are used. A lane
// reduces its dot products over the group with shuffles and keeps the
// group's online softmax (m, l, in log2 units: q is scaled by scale *
// log2(e) once) and its chunks of the accumulator per head in registers.
// The block's row groups then merge in shared memory in a fixed order, and
// each block leaves (m, l, acc[G][D]) there; after cluster.sync() every
// block merges its slice of the outputs over the splits in split order,
// reading the others' through distributed shared memory (an empty split or
// row group gives m = -1e30, l = 0, acc = 0; split 0 always holds position
// 0): no second launch, no scratch in device memory, no atomics, the same
// result every run.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>


namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 2;        // rows a row group loads together
constexpr int kTile = 64;         // the span is a multiple of this
constexpr int kMaxD = 128;
constexpr int kMaxG = 8;          // query heads per KV head
constexpr int kMaxSplits = 8;     // the portable cluster size
constexpr int kMaxDevices = 64;
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

// the floats of shared memory: each row group's m and l per head and its
// accumulator, then the block's (m, l, acc) that the cluster's blocks read
__host__ __device__ constexpr int smem_floats(int slots, int kG, int D) {
  return slots * kG * (D + 2) + kG * (D + 2);
}

// kG >= G query heads per KV head (1, 2, 4 or 8); a lane holds kCpl 16-byte
// chunks of a row (chunks j, j + lpr, ...); kU rows per row group have their
// loads in flight together
template <typename T, int kG, int kCpl, int kU>
__global__ void __launch_bounds__(kThreads)
flash_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                          const T* __restrict__ vc,
                          const int* __restrict__ pos_ptr, T* __restrict__ out,
                          int H, int Hkv, int D, int S_max, long long k_sb,
                          long long k_ss, long long k_sh, long long v_sb,
                          long long v_ss, long long v_sh, float scale_log2,
                          int span, int lpr) {
  constexpr int E = 16 / sizeof(T);   // values per 16-byte chunk
  constexpr int W = kCpl * E;         // values of a row per lane
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
  const T* kb = kc + b * k_sb + kvh * k_sh + j * E;
  const T* vb = vc + b * v_sb + kvh * v_sh + j * E;
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
  const int n_live = min(*pos_ptr + 1, S_max);
  const int s_begin = split * span;
  const int s_end = min(s_begin + span, n_live);

  // the block takes kU * slots rows a step (the bound is block-uniform, so
  // every lane of a warp takes part in the shuffles); the next step's rows
  // are loaded while this step's are used
  const int step = kU * slots;
  uint4 kn[kU][kCpl], vn[kU][kCpl];
  auto load = [&](int it) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int r = it + u * slots + slot;
#pragma unroll
      for (int c = 0; c < kCpl; ++c) {
        const bool in = act[c] && r < s_end;
        const long long off = lpr * c * E;
        kn[u][c] = in ? __ldg(reinterpret_cast<const uint4*>(
                            kb + r * k_ss + off))
                      : make_uint4(0u, 0u, 0u, 0u);
        vn[u][c] = in ? __ldg(reinterpret_cast<const uint4*>(
                            vb + r * v_ss + off))
                      : make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };
  load(s_begin);
  for (int it = s_begin; it < s_end; it += step) {
    uint4 kr[kU][kCpl], vr[kU][kCpl];
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
        unpack(kr[u][c], kf, T());
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
        p[g][u] = to_f(from_f<T>(p[g][u]));   // p.astype(v.dtype)
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
        unpack(vr[u][c], vf, T());
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
    out[qoff + x] = from_f<T>(a / fmaxf(lsum, 1e-30f));
  }
  cluster.sync();   // each block's shared memory lives until all have read
}

template <typename T, int kG>
int launch(const void* q, const void* kc, const void* vc, const int* pos,
           void* out, int B, int H, int Hkv, int D, int S_max,
           long long k_sb, long long k_ss, long long k_sh, long long v_sb,
           long long v_ss, long long v_sh, float scale, int splits, int span,
           cudaStream_t stream) {
  constexpr int kCpl = kG == 1 ? 2 : 1;
  const auto kernel = flash_decode_split_kernel<T, kG, kCpl, kUnroll>;
  const int cpr = D / (16 / static_cast<int>(sizeof(T)));
  int lpr = 1;   // lanes per row: the power of two >= a row's chunks / kCpl
  while (lpr * kCpl < cpr) lpr *= 2;
  const int smem = 4 * smem_floats(kWarps * (32 / lpr), kG, D);
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
  cfg.gridDim = dim3(splits, Hkv, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(q),
                           static_cast<const T*>(kc),
                           static_cast<const T*>(vc), pos,
                           static_cast<T*>(out), H, Hkv, D, S_max, k_sb, k_ss,
                           k_sh, v_sb, v_ss, v_sh,
                           scale * 1.4426950408889634f, span, lpr);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_g(const void* q, const void* kc, const void* vc, const int* pos,
             void* out, int B, int H, int Hkv, int D, int S_max,
             long long k_sb, long long k_ss, long long k_sh, long long v_sb,
             long long v_ss, long long v_sh, float scale, int splits,
             int span, cudaStream_t stream) {
  const int G = H / Hkv;
  if (G == 1)
    return launch<T, 1>(q, kc, vc, pos, out, B, H, Hkv, D, S_max, k_sb, k_ss,
                        k_sh, v_sb, v_ss, v_sh, scale, splits, span, stream);
  if (G == 2)
    return launch<T, 2>(q, kc, vc, pos, out, B, H, Hkv, D, S_max, k_sb, k_ss,
                        k_sh, v_sb, v_ss, v_sh, scale, splits, span, stream);
  if (G <= 4)
    return launch<T, 4>(q, kc, vc, pos, out, B, H, Hkv, D, S_max, k_sb, k_ss,
                        k_sh, v_sb, v_ss, v_sh, scale, splits, span, stream);
  return launch<T, 8>(q, kc, vc, pos, out, B, H, Hkv, D, S_max, k_sb, k_ss,
                      k_sh, v_sb, v_ss, v_sh, scale, splits, span, stream);
}

}  // namespace

// q and out (B, 1, H, D) contiguous; the caches (B, S_max, Hkv, D) with the
// given element strides for B, S and Hkv and unit stride over D, 16-byte
// aligned rows (D and the strides multiples of 16 bytes); pos one int32 on
// the device. dtype 0 = float32, 1 = bfloat16. D <= 128, D % 8 == 0,
// H / Hkv <= 8; splits (1..8) blocks of span positions (a multiple of 64)
// cover S_max.
extern "C" int flash_decode_fwd(int dtype, const void* q, const void* kc,
                                const void* vc, const int* pos, void* out,
                                int B, int H, int Hkv, int D, int S_max,
                                long long k_sb, long long k_ss, long long k_sh,
                                long long v_sb, long long v_ss, long long v_sh,
                                float scale, int splits, int span,
                                cudaStream_t stream) {
  if (D > kMaxD || D % 8 != 0 || H % Hkv != 0 || H / Hkv > kMaxG ||
      splits < 1 || splits > kMaxSplits || span % kTile != 0 ||
      static_cast<long long>(splits) * span < S_max)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_g<float>(q, kc, vc, pos, out, B, H, Hkv, D, S_max, k_sb,
                           k_ss, k_sh, v_sb, v_ss, v_sh, scale, splits, span,
                           stream);
  if (dtype == 1)
    return launch_g<__nv_bfloat16>(q, kc, vc, pos, out, B, H, Hkv, D, S_max,
                                   k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale,
                                   splits, span, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
