// Row RMSNorm backward: dx and dgamma, fp32 inside, one cast each.
//
// The Pallas rmsnorm kernel (src/repro/kernels/rmsnorm.py) is forward only;
// in the JAX package XLA differentiates rms_norm (src/repro/models/layers.py).
// For each row, r = rsqrt(mean(x^2) + eps), xhat = x r and g = dy gamma; then
// dx = r (g - xhat mean(g xhat)) and dgamma = sum over rows of dy xhat.
//
// Two launches of this source, no atomics, so dgamma is the same from run to
// run:
//   1. one block per run of rows_per_block rows: per row, the two sums
//      (x^2 and g x) by warp shuffles and shared memory, then dx; each thread
//      keeps the dgamma partial of its own columns in shared memory and the
//      block writes them as one fp32 row of `partial` (n_blocks, D);
//   2. one thread per column sums `partial` over the blocks in order.
// What bounds it on the H100: device memory, at 3 D bytes per row (read x and
// dy, write dx) plus the n_blocks x D fp32 partials, written and read once.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                       const T* __restrict__ dy, T* __restrict__ dx,
                       float* __restrict__ partial, int rows, int D, int rows_per_block,
                       float eps) {
  extern __shared__ float dg[];  // [D]
  __shared__ float red[2][kWarps];
  __shared__ float row_r;
  __shared__ float row_mean;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  for (int i = threadIdx.x; i < D; i += kThreads) dg[i] = 0.f;

  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);
  for (int rr = r0; rr < r1; ++rr) {
    const T* xr = x + static_cast<size_t>(rr) * D;
    const T* dyr = dy + static_cast<size_t>(rr) * D;
    float ss = 0.f;
    float gx = 0.f;
    for (int i = threadIdx.x; i < D; i += kThreads) {
      const float xv = rt::to_float(xr[i]);
      ss += xv * xv;
      gx += rt::to_float(dyr[i]) * rt::to_float(gamma[i]) * xv;
    }
    ss = rt::warp_sum(ss);
    gx = rt::warp_sum(gx);
    if (lane == 0) {
      red[0][warp] = ss;
      red[1][warp] = gx;
    }
    __syncthreads();
    if (warp == 0) {
      float a = lane < kWarps ? red[0][lane] : 0.f;
      float c = lane < kWarps ? red[1][lane] : 0.f;
      a = rt::warp_sum(a);
      c = rt::warp_sum(c);
      if (lane == 0) {
        const float r = rsqrtf(a / static_cast<float>(D) + eps);
        row_r = r;
        row_mean = c * r / static_cast<float>(D);  // mean(g xhat) = r mean(g x)
      }
    }
    __syncthreads();
    const float r = row_r;
    const float mean = row_mean;
    T* dxr = dx + static_cast<size_t>(rr) * D;
    for (int i = threadIdx.x; i < D; i += kThreads) {
      const float xhat = rt::to_float(xr[i]) * r;
      const float dyv = rt::to_float(dyr[i]);
      const float g = dyv * rt::to_float(gamma[i]);
      dxr[i] = rt::from_float<T>(r * (g - xhat * mean));
      dg[i] += dyv * xhat;  // column i belongs to this thread alone
    }
    __syncthreads();  // red, row_r and row_mean are reused by the next row
  }
  for (int i = threadIdx.x; i < D; i += kThreads) {
    partial[static_cast<size_t>(blockIdx.x) * D + i] = dg[i];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dgamma_reduce_kernel(const float* __restrict__ partial, T* __restrict__ dgamma, int n_blocks,
                         int D) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= D) return;
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b) s += partial[static_cast<size_t>(b) * D + i];
  dgamma[i] = rt::from_float<T>(s);
}

template <typename T>
int launch(const void* x, const void* gamma, const void* dy, void* dx, float* partial,
           void* dgamma, int rows, int D, int rows_per_block, int n_blocks, float eps,
           cudaStream_t s) {
  rmsnorm_bwd_kernel<T><<<n_blocks, kThreads, D * sizeof(float), s>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma), static_cast<const T*>(dy),
      static_cast<T*>(dx), partial, rows, D, rows_per_block, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dgamma_reduce_kernel<T><<<(D + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      partial, static_cast<T*>(dgamma), n_blocks, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, dy, dx: (rows, D); gamma, dgamma: (D,); partial: (n_blocks, D) fp32
// scratch with n_blocks = ceil(rows / rows_per_block).  Returns
// cudaGetLastError() of the first launch that failed, else 0.
extern "C" int rt_rmsnorm_bwd(const void* x, const void* gamma, const void* dy, void* dx,
                              void* partial, void* dgamma, int rows, int D, int rows_per_block,
                              int n_blocks, float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  if (dtype == rt::kFloat32)
    return launch<float>(x, gamma, dy, dx, p, dgamma, rows, D, rows_per_block, n_blocks, eps, s);
  if (dtype == rt::kBFloat16)
    return launch<__nv_bfloat16>(x, gamma, dy, dx, p, dgamma, rows, D, rows_per_block, n_blocks,
                                 eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
