// Row RMSNorm: y = x * rsqrt(mean(x^2) + eps) * gamma, fp32 inside, one cast.
//
// Replaces the Pallas kernel _rmsnorm_kernel (src/repro/kernels/rmsnorm.py).
// One block per row; each thread strides over the row, the sum of squares is
// reduced by warp shuffles and then across the block's warps through shared
// memory.  The row is read twice (the second read hits L1/L2) and written
// once, so the op is bound by 2 * D * bytes per row of device memory.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ gamma, T* __restrict__ out,
                   int D, float eps) {
  const T* xr = x + static_cast<size_t>(blockIdx.x) * D;
  T* yr = out + static_cast<size_t>(blockIdx.x) * D;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;

  float ss = 0.f;
  for (int i = threadIdx.x; i < D; i += kThreads) {
    const float v = rt::to_float(xr[i]);
    ss += v * v;
  }
  ss = rt::warp_sum(ss);

  __shared__ float partial[kThreads / 32];
  __shared__ float inv_rms;
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kThreads / 32 ? partial[lane] : 0.f;
    t = rt::warp_sum(t);
    if (lane == 0) inv_rms = rsqrtf(t / static_cast<float>(D) + eps);
  }
  __syncthreads();

  const float r = inv_rms;
  for (int i = threadIdx.x; i < D; i += kThreads) {
    yr[i] = rt::from_float<T>(rt::to_float(xr[i]) * r * rt::to_float(gamma[i]));
  }
}

}  // namespace

// x, out: (rows, D) contiguous; gamma: (D,).  Returns cudaGetLastError().
extern "C" int rt_rmsnorm(const void* x, const void* gamma, void* out, int rows, int D,
                          float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kFloat32) {
    rmsnorm_kernel<float><<<rows, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(gamma),
        static_cast<float*>(out), D, eps);
  } else if (dtype == rt::kBFloat16) {
    rmsnorm_kernel<__nv_bfloat16><<<rows, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(gamma),
        static_cast<__nv_bfloat16*>(out), D, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
