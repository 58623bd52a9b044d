// Row RMSNorm: y = x * rsqrt(mean(x^2) + eps) * gamma, fp32 inside, one cast.
//
// Replaces the Pallas kernel _rmsnorm_kernel (src/repro/kernels/rmsnorm.py).
// Bound by device memory: 2 * D * bytes per row (x read, y written) plus
// gamma.  Two bodies, chosen by the wrapper (kernels/rmsnorm.py, route()):
//
// rmsnorm_vec_kernel (D a multiple of 8, a row of at most 16 KB, 16-byte
// aligned x and gamma): one warp a row, two rows a block.  Each lane loads
// its share of the row once into registers with 16-byte loads (kVec of them:
// 4 at D = 1024 in bf16, 7 of 8 at D = 1600), the sum of squares is reduced
// by warp shuffles alone, and the scaled row leaves with 16-byte stores: no
// shared memory, no block barrier, one read of x.
//
// rmsnorm_kernel (any other D): one block per row; each thread strides over
// the row, the sum of squares is reduced by warp shuffles and then across
// the block's warps through shared memory; the row is read twice (the
// second read hits L1/L2).
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

// Two rows (warps) a block: on the H100, small blocks spread the rows over
// the SMs sooner than blocks of 4 or 8 at hymba-1.5b's 4352 rows of 1600,
// and capping the registers to fit more blocks on an SM was slower still.
constexpr int kRows = 2;

template <typename T, int kVec>
__global__ void __launch_bounds__(32 * kRows)
    rmsnorm_vec_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                       T* __restrict__ out, int rows, int D, float eps) {
  constexpr int kPer = 16 / sizeof(T);  // elements in 16 bytes
  const int lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * kRows + threadIdx.x / 32;
  if (row >= rows) return;
  const int nvec = D / kPer;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * D);
  uint4 v[kVec];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int c = lane + 32 * i;
    if (c < nvec) {
      v[i] = xr[c];
      const T* e = reinterpret_cast<const T*>(&v[i]);
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const float f = rt::to_float(e[k]);
        ss += f * f;
      }
    }
  }
  const float r = rsqrtf(rt::warp_sum(ss) / static_cast<float>(D) + eps);
  const uint4* gr = reinterpret_cast<const uint4*>(gamma);
  uint4* yr = reinterpret_cast<uint4*>(out + row * D);
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int c = lane + 32 * i;
    if (c < nvec) {
      const uint4 gv = gr[c];
      const T* e = reinterpret_cast<const T*>(&v[i]);
      const T* g = reinterpret_cast<const T*>(&gv);
      uint4 o;
      T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int k = 0; k < kPer; ++k)
        oe[k] = rt::from_float<T>(rt::to_float(e[k]) * r * rt::to_float(g[k]));
      yr[c] = o;
    }
  }
}

template <typename T, int kVec>
int launch_vec_n(const void* x, const void* gamma, void* out, int rows, int D, float eps,
                 cudaStream_t s) {
  const unsigned grid = static_cast<unsigned>((rows + kRows - 1) / kRows);
  rmsnorm_vec_kernel<T, kVec><<<grid, 32 * kRows, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma), static_cast<T*>(out), rows, D,
      eps);
  return static_cast<int>(cudaGetLastError());
}

// The smallest instance whose kVec vectors a lane cover the row.
template <typename T>
int launch_vec(const void* x, const void* gamma, void* out, int rows, int D, float eps,
               cudaStream_t s) {
  const int per_lane = (D / (16 / static_cast<int>(sizeof(T))) + 31) / 32;
  if (per_lane <= 1) return launch_vec_n<T, 1>(x, gamma, out, rows, D, eps, s);
  if (per_lane <= 2) return launch_vec_n<T, 2>(x, gamma, out, rows, D, eps, s);
  if (per_lane <= 4) return launch_vec_n<T, 4>(x, gamma, out, rows, D, eps, s);
  if (per_lane <= 8) return launch_vec_n<T, 8>(x, gamma, out, rows, D, eps, s);
  if (per_lane <= 16) return launch_vec_n<T, 16>(x, gamma, out, rows, D, eps, s);
  if (per_lane <= 32) return launch_vec_n<T, 32>(x, gamma, out, rows, D, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The vec body: D a multiple of 8 with a row of at most 16 KB, x and gamma
// 16-byte aligned; arguments as rt_rmsnorm's.  Returns cudaGetLastError().
extern "C" int rt_rmsnorm_vec(const void* x, const void* gamma, void* out, int rows, int D,
                              float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % 8 || D < 8) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == rt::kFloat32) return launch_vec<float>(x, gamma, out, rows, D, eps, s);
  if (dtype == rt::kBFloat16) return launch_vec<__nv_bfloat16>(x, gamma, out, rows, D, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

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
