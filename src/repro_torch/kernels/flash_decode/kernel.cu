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
// scalar block), so a decode step needs no device->host copy, and blocks
// past pos are never read (the TPU kernel's pl.when(isb * bs <= pos)). The
// cache is read in the model's layout (B, S_max, Hkv, D) through its
// strides: the TPU wrapper pads D to 128, pads S to the block and transposes
// the whole cache on every call; this kernel copies and pads nothing.
//
// What bounds it on an H100: bytes. At the serving shapes (B = 8, H = Hkv =
// 32, D = 112, pos up to 2,079, bf16) a launch reads 2 * B * (pos + 1) * Hkv *
// D values of K and V (235 MB at pos = 2,047: 70 us at 3.35 TB/s) and does
// 4 FLOPs per value read. Design: one block of 256 threads per (head,
// batch) walks the live positions in tiles of 128. Each tile of K and of V
// is copied to shared memory in its own type with 16-byte loads, all issued
// before any is used (rows padded to an odd number of 16-byte chunks, so
// the 16-byte reads of one row per thread do not conflict); one thread per
// position takes its dot product, a block max and sum update the online
// softmax, and two threads per column (one per half of the tile) accumulate
// P.V, summed at the end. With B * H = 256 blocks and one tile in flight
// per block it does not reach the memory rate; splitting the positions
// over more blocks with a combine step is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBS = 128;          // positions per tile
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

// block-wide reduction of one value per thread; every thread gets the result
template <bool kMax>
__device__ float block_reduce(float x, float* red) {
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = kMax ? fmaxf(x, y) : x + y;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();   // red may still be read by the last reduction
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kThreads / 32; ++w)
    r = kMax ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, const int* __restrict__ pos_ptr,
                    T* __restrict__ out, int H, int Hkv, int D, int S_max,
                    long long k_sb, long long k_ss, long long k_sh,
                    long long v_sb, long long v_ss, long long v_sh,
                    float scale) {
  constexpr int E = 16 / sizeof(T);   // values per 16-byte chunk
  const int cpr = D / E;              // chunks per row
  const int rs = cpr | 1;             // row stride in chunks (odd)
  extern __shared__ float4 smem4[];
  uint4* sK = reinterpret_cast<uint4*>(smem4);   // [kBS][rs] chunks
  uint4* sV = sK + kBS * rs;                      // [kBS][rs] chunks
  const T* sVe = reinterpret_cast<const T*>(sV);  // [kBS][rs * E] values
  float* sq = reinterpret_cast<float*>(sV + kBS * rs);  // [kMaxD]
  float* sp = sq + kMaxD;                         // [kBS] rounded p
  float* red = sp + kBS;                          // [kThreads / 32]
  float* sacc = red + kThreads / 32;              // [kMaxD]

  const int tid = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / (H / Hkv);
  const T* kb = kc + b * k_sb + kvh * k_sh;
  const T* vb = vc + b * v_sb + kvh * v_sh;
  const size_t qoff = (static_cast<size_t>(b) * H + h) * D;
  for (int c = tid; c < D; c += kThreads) sq[c] = to_f(q[qoff + c]);
  const int n_live = min(*pos_ptr + 1, S_max);
  const int half = tid / kBS, col = tid % kBS;   // P.V: a half of the tile

  float m = kNegInf, l = 0.0f, acc = 0.0f;   // acc: column col of half
  for (int s0 = 0; s0 < n_live; s0 += kBS) {
    const int nt = min(kBS, n_live - s0);
    __syncthreads();   // the last tile's P.V is done with sK, sV and sp
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int i = tid; i < kBS * cpr; i += kThreads) {
      const int r = i / cpr, j = i % cpr;
      const bool in = r < nt;
      const uint4 kv = in ? *reinterpret_cast<const uint4*>(
          kb + (s0 + r) * k_ss + j * E) : zero;
      const uint4 vv = in ? *reinterpret_cast<const uint4*>(
          vb + (s0 + r) * v_ss + j * E) : zero;
      sK[r * rs + j] = kv;
      sV[r * rs + j] = vv;
    }
    __syncthreads();
    float s = kNegInf;
    if (tid < nt) {
      float dot = 0.0f;
      for (int j = 0; j < cpr; ++j) {
        float f[E];
        unpack(sK[tid * rs + j], f, T());
#pragma unroll
        for (int e = 0; e < E; ++e) dot = fmaf(sq[j * E + e], f[e], dot);
      }
      s = dot * scale;
    }
    const float m_new = fmaxf(m, block_reduce<true>(s, red));
    const float p = expf(s - m_new);
    const float corr = expf(m - m_new);
    l = l * corr + block_reduce<false>(p, red);
    m = m_new;
    if (tid < kBS) sp[tid] = to_f(from_f<T>(p));   // p.astype(v.dtype)
    __syncthreads();
    if (col < D) {
      float pv = 0.0f;
      const int t1 = min(nt, (half + 1) * (kBS / 2));
      for (int t = half * (kBS / 2); t < t1; ++t)
        pv = fmaf(sp[t], to_f(sVe[t * rs * E + col]), pv);
      acc = acc * corr + pv;
    }
  }
  if (half == 1 && col < D) sacc[col] = acc;
  __syncthreads();
  if (half == 0 && col < D)
    out[qoff + col] = from_f<T>((acc + sacc[col]) / fmaxf(l, 1e-30f));
}

template <typename T>
size_t smem_bytes(int D) {
  const int rs = (D / (16 / static_cast<int>(sizeof(T)))) | 1;
  return 2 * sizeof(uint4) * kBS * rs +
         sizeof(float) * (kMaxD + kBS + kThreads / 32 + kMaxD);
}

template <typename T>
int launch(const void* q, const void* kc, const void* vc, const int* pos,
           void* out, int B, int H, int Hkv, int D, int S_max,
           long long k_sb, long long k_ss, long long k_sh, long long v_sb,
           long long v_ss, long long v_sh, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_decode_kernel<T><<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), pos, static_cast<T*>(out), H, Hkv, D, S_max,
      k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q and out (B, 1, H, D) contiguous; the caches (B, S_max, Hkv, D) with the
// given element strides for B, S and Hkv and unit stride over D, 16-byte
// aligned rows (D and the strides multiples of 16 bytes); pos one int32 on
// the device. dtype 0 = float32, 1 = bfloat16. D <= 128, D % 8 == 0.
extern "C" int flash_decode_fwd(int dtype, const void* q, const void* kc,
                                const void* vc, const int* pos, void* out,
                                int B, int H, int Hkv, int D, int S_max,
                                long long k_sb, long long k_ss, long long k_sh,
                                long long v_sb, long long v_ss, long long v_sh,
                                float scale, cudaStream_t stream) {
  if (D > kMaxD || D % 8 != 0 || H % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch<float>(q, kc, vc, pos, out, B, H, Hkv, D, S_max, k_sb, k_ss,
                         k_sh, v_sb, v_ss, v_sh, scale, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, kc, vc, pos, out, B, H, Hkv, D, S_max,
                                 k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale,
                                 stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
