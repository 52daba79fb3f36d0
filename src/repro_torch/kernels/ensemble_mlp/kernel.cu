// Fused (models x tasks) MLP forward: out[m, t] = tanh(x[m, t] W1[m] + b1[m]) W2[m] + b2[m].
//
// Replaces the TPU kernel src/repro/kernels/ensemble_mlp/kernel.py::ensemble_mlp_blocked
// (body _mlp_body), which computes one (model, 128-task block) tile per grid step
// with two MXU dot_generals.
//
// What bounds it on an H100: at Sizey's shapes (M = 1 model, d = 1 feature,
// h = 32 hidden units, T = 1..CAP tasks) the work is a few KB of bytes and
// ~4*h*d*T FLOPs, far below both roofs, so a launch is bound by launch latency
// and one pass over x. The product is too small for tensor cores (d and the
// output width are 1), so the design is one thread per (model, task) row, the
// model's weights staged once per block in shared memory, and fp32 FMAs with
// tanhf (no fast math). The ragged end of T is masked in the kernel; there is
// no padding.
//
// C interface (bound with ctypes): every pointer is a device pointer to
// contiguous float32 data; x (M,T,d), w1 (M,d,h), b1 (M,h), w2 (M,h,1),
// b2 (M,1), out (M,T). Returns cudaGetLastError() of the launch.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void ensemble_mlp_kernel(const float* __restrict__ x,
                                    const float* __restrict__ w1,
                                    const float* __restrict__ b1,
                                    const float* __restrict__ w2,
                                    const float* __restrict__ b2,
                                    float* __restrict__ out,
                                    int T, int d, int h) {
  extern __shared__ float smem[];
  float* sw1 = smem;          // (d, h)
  float* sb1 = sw1 + d * h;   // (h,)
  float* sw2 = sb1 + h;       // (h,)
  const int m = blockIdx.y;
  const size_t wbase = static_cast<size_t>(m) * d * h;
  for (int i = threadIdx.x; i < d * h; i += blockDim.x) sw1[i] = w1[wbase + i];
  for (int i = threadIdx.x; i < h; i += blockDim.x) {
    sb1[i] = b1[static_cast<size_t>(m) * h + i];
    sw2[i] = w2[static_cast<size_t>(m) * h + i];
  }
  __syncthreads();

  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  const size_t row = static_cast<size_t>(m) * T + t;
  const float* xr = x + row * d;
  float acc = 0.0f;
  for (int j = 0; j < h; ++j) {
    float s = 0.0f;
    for (int f = 0; f < d; ++f) s = fmaf(xr[f], sw1[f * h + j], s);
    acc = fmaf(tanhf(s + sb1[j]), sw2[j], acc);
  }
  out[row] = acc + b2[m];
}

}  // namespace

extern "C" int ensemble_mlp_forward_f32(const float* x, const float* w1,
                                        const float* b1, const float* w2,
                                        const float* b2, float* out, int M,
                                        int T, int d, int h,
                                        cudaStream_t stream) {
  const dim3 grid((T + kThreads - 1) / kThreads, M);
  const size_t smem = sizeof(float) * (static_cast<size_t>(d) * h + 2 * h);
  ensemble_mlp_kernel<<<grid, kThreads, smem, stream>>>(x, w1, b1, w2, b2,
                                                        out, T, d, h);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
