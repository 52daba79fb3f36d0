// Fused (models x tasks) MLP forward: out[m, t] = tanh(x[m, t] W1[m] + b1[m]) W2[m] + b2[m].
//
// Replaces the TPU kernel src/repro/kernels/ensemble_mlp/kernel.py::ensemble_mlp_blocked
// (body _mlp_body), which computes one (model, 128-task block) tile per grid step
// with two MXU dot_generals.
//
// What bounds it on an H100: at Sizey's shapes (M = 1 model, d = 1 or 2
// features, h = 32 hidden units, T = 1..1024 tasks) the work is a few KB of
// bytes and ~4*h*d*T FLOPs, far below both roofs: one call is bound by the
// host, which issues it, not by the device, which runs it in a few
// microseconds. The product is too small for tensor cores (d and the output
// width are 1), so the device side is one thread per (model, task) row,
// the model's weights staged once per block in shared memory, and fp32
// FMAs with tanhf (no fast math); the ragged end of T is masked in the
// kernel, with no padding.
//
// What the design does about the host: the model's predict
// (core/models/mlp.py::predict_batch) normalises its features, runs the
// forward and de-normalises the output. Eagerly that is five launches, the
// four elementwise steps around this kernel. mlp_predict_f32 runs all of it
// in one launch: it reads the four normalisation statistics from device
// memory (no host sync) and rounds each step as the eager launch does,
// xn = (x - mu_x) / sd_x with __fsub_rn and __fdiv_rn, y = yn * sd_y + mu_y
// with __fmul_rn and __fadd_rn, so nvcc contracts none of them into a
// multiply-add: its output is bitwise that of the five launches.
// ensemble_mlp_forward_f32, the TPU kernel's own function over M models,
// stays beside it.
//
// C interface (bound with ctypes): every pointer is a device pointer to
// contiguous float32 data; x (M,T,d), w1 (M,d,h), b1 (M,h), w2 (M,h,1),
// b2 (M,1), out (M,T); mlp_predict_f32 takes one model (M = 1) and mu_x,
// sd_x (d,), mu_y, sd_y (one value each). Returns cudaGetLastError() of
// the launch.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

// kNorm: normalise x with (mu_x, sd_x) on the way in and de-normalise the
// output with (sd_y, mu_y) on the way out
template <bool kNorm>
__global__ void ensemble_mlp_kernel(const float* __restrict__ x,
                                    const float* __restrict__ w1,
                                    const float* __restrict__ b1,
                                    const float* __restrict__ w2,
                                    const float* __restrict__ b2,
                                    const float* __restrict__ mu_x,
                                    const float* __restrict__ sd_x,
                                    const float* __restrict__ mu_y,
                                    const float* __restrict__ sd_y,
                                    float* __restrict__ out,
                                    int T, int d, int h) {
  extern __shared__ float smem[];
  float* sw1 = smem;          // (d, h)
  float* sb1 = sw1 + d * h;   // (h,)
  float* sw2 = sb1 + h;       // (h,)
  float* sxn = sw2 + h;       // kNorm: (2, d) mu_x and sd_x, then
  float* sxr = sxn + 2 * d;   // (kThreads, d) each thread's row normalised
  const int m = blockIdx.y;
  const size_t wbase = static_cast<size_t>(m) * d * h;
  for (int i = threadIdx.x; i < d * h; i += blockDim.x) sw1[i] = w1[wbase + i];
  for (int i = threadIdx.x; i < h; i += blockDim.x) {
    sb1[i] = b1[static_cast<size_t>(m) * h + i];
    sw2[i] = w2[static_cast<size_t>(m) * h + i];
  }
  if (kNorm)
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      sxn[i] = mu_x[i];
      sxn[d + i] = sd_x[i];
    }
  __syncthreads();

  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  const size_t row = static_cast<size_t>(m) * T + t;
  const float* xr = x + row * d;
  if (kNorm) {
    float* const xo = sxr + threadIdx.x * d;
    for (int f = 0; f < d; ++f)
      xo[f] = __fdiv_rn(__fsub_rn(xr[f], sxn[f]), sxn[d + f]);
    xr = xo;
  }
  float acc = 0.0f;
  for (int j = 0; j < h; ++j) {
    float s = 0.0f;
    for (int f = 0; f < d; ++f) s = fmaf(xr[f], sw1[f * h + j], s);
    acc = fmaf(tanhf(s + sb1[j]), sw2[j], acc);
  }
  const float yn = __fadd_rn(acc, b2[m]);
  out[row] = kNorm ? __fadd_rn(__fmul_rn(yn, *sd_y), *mu_y) : yn;
}

size_t smem_bytes(int d, int h, bool norm) {
  return sizeof(float) * (static_cast<size_t>(d) * h + 2 * h +
                          (norm ? static_cast<size_t>(2 + kThreads) * d : 0));
}

}  // namespace

extern "C" int ensemble_mlp_forward_f32(const float* x, const float* w1,
                                        const float* b1, const float* w2,
                                        const float* b2, float* out, int M,
                                        int T, int d, int h,
                                        cudaStream_t stream) {
  const dim3 grid((T + kThreads - 1) / kThreads, M);
  const size_t smem = smem_bytes(d, h, false);
  ensemble_mlp_kernel<false><<<grid, kThreads, smem, stream>>>(
      x, w1, b1, w2, b2, nullptr, nullptr, nullptr, nullptr, out, T, d, h);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mlp_predict_f32(const float* x, const float* w1,
                               const float* b1, const float* w2,
                               const float* b2, const float* mu_x,
                               const float* sd_x, const float* mu_y,
                               const float* sd_y, float* out, int T, int d,
                               int h, cudaStream_t stream) {
  const dim3 grid((T + kThreads - 1) / kThreads, 1);
  const size_t smem = smem_bytes(d, h, true);
  ensemble_mlp_kernel<true><<<grid, kThreads, smem, stream>>>(
      x, w1, b1, w2, b2, mu_x, sd_x, mu_y, sd_y, out, T, d, h);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
