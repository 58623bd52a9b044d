// SwiGLU MLP: y = (silu(x @ Wg) * (x @ Wu)).to(x.dtype) @ Wd, fp32 accumulation.
//
// Replaces the Pallas kernel _swiglu_kernel (src/repro/kernels/swiglu.py).
// The TPU kernel carries a (block_m, D) fp32 accumulator across the d_ff axis
// of its sequential grid; GPU blocks run in no order, so the port splits the
// work into two launches of one kernel template on the same stream:
//   1. h = silu(x @ Wg) * (x @ Wu), in fp32, cast to x.dtype into an (N, F)
//      scratch buffer the wrapper allocates;
//   2. y = h @ Wd with fp32 accumulation.
// At decode (N = 8 rows) the op is bound by reading the three weight
// matrices once (3 * D * F * bytes).  Each block owns 32 output columns (one
// per lane, so a warp reads 32 neighbouring weights of a row) and 8 rows of
// x; its 8 warps split the contraction axis, and their partial sums meet in
// shared memory.  Every weight is read by exactly one block per 8 rows of x.
// The round trip of h through device memory (N * F * bytes) is what fusing
// the two launches would save.
#include "common.cuh"

namespace {

constexpr int kCols = 32;    // output columns per block, one per lane
constexpr int kSlices = 8;   // warps per block; warp s takes contraction rows s, s+8, ...
constexpr int kRows = 8;     // rows of the left operand per block
constexpr int kChunk = 256;  // contraction elements staged in shared memory at a time
constexpr int kThreads = kCols * kSlices;
static_assert(kRows * kCols == kThreads, "the epilogue maps one thread to one output");

// out[n, m] = epilogue(sum_k a[n, k] * w0[k, m] [, sum_k a[n, k] * w1[k, m]])
// a: (N, K), w0 and w1: (K, M), out: (N, M), all row-major.
// kGated: out = silu(acc0) * acc1; otherwise out = acc0.
template <typename T, bool kGated>
__global__ void __launch_bounds__(kThreads)
    rows_matmul_kernel(const T* __restrict__ a, const T* __restrict__ w0,
                       const T* __restrict__ w1, T* __restrict__ out, int N, int K, int M) {
  __shared__ float as[kRows][kChunk];
  __shared__ float red0[kSlices][kRows][kCols];
  __shared__ float red1[kGated ? kSlices : 1][kRows][kCols];

  const int lane = threadIdx.x;
  const int slice = threadIdx.y;
  const int tid = slice * kCols + lane;
  const int m = blockIdx.x * kCols + lane;
  const int n0 = blockIdx.y * kRows;

  float acc0[kRows];
  float acc1[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc0[r] = acc1[r] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kChunk) {
    const int len = min(kChunk, K - k0);
    for (int i = tid; i < kRows * kChunk; i += kThreads) {
      const int r = i / kChunk;
      const int c = i % kChunk;
      const int n = n0 + r;
      as[r][c] = (n < N && c < len) ? rt::to_float(a[static_cast<size_t>(n) * K + k0 + c]) : 0.f;
    }
    __syncthreads();
    if (m < M) {
      for (int c = slice; c < len; c += kSlices) {
        const size_t w_off = static_cast<size_t>(k0 + c) * M + m;
        const float g = rt::to_float(w0[w_off]);
        float u = 0.f;
        if constexpr (kGated) u = rt::to_float(w1[w_off]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          acc0[r] += as[r][c] * g;
          if constexpr (kGated) acc1[r] += as[r][c] * u;
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    red0[slice][r][lane] = acc0[r];
    if constexpr (kGated) red1[slice][r][lane] = acc1[r];
  }
  __syncthreads();

  const int r = tid / kCols;
  const int c = tid % kCols;
  const int n = n0 + r;
  const int mo = blockIdx.x * kCols + c;
  float s0 = 0.f;
  float s1 = 0.f;
#pragma unroll
  for (int s = 0; s < kSlices; ++s) {
    s0 += red0[s][r][c];
    if constexpr (kGated) s1 += red1[s][r][c];
  }
  if (n < N && mo < M) {
    float y = s0;
    if constexpr (kGated) y = s0 / (1.f + expf(-s0)) * s1;
    out[static_cast<size_t>(n) * M + mo] = rt::from_float<T>(y);
  }
}

template <typename T>
int launch(const void* x, const void* wg, const void* wu, const void* wd, void* h, void* y,
           int N, int D, int F, cudaStream_t s) {
  const dim3 block(kCols, kSlices);
  const int row_tiles = (N + kRows - 1) / kRows;
  const dim3 grid_up((F + kCols - 1) / kCols, row_tiles);
  const dim3 grid_down((D + kCols - 1) / kCols, row_tiles);
  rows_matmul_kernel<T, true><<<grid_up, block, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg), static_cast<const T*>(wu),
      static_cast<T*>(h), N, D, F);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rows_matmul_kernel<T, false><<<grid_down, block, 0, s>>>(
      static_cast<const T*>(h), static_cast<const T*>(wd), nullptr, static_cast<T*>(y), N, F, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (N, D); wg, wu: (D, F); wd: (F, D); h: (N, F) scratch; y: (N, D).
// Returns cudaGetLastError() of the first launch that failed, else 0.
extern "C" int rt_swiglu(const void* x, const void* wg, const void* wu, const void* wd, void* h,
                         void* y, int N, int D, int F, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kFloat32) return launch<float>(x, wg, wu, wd, h, y, N, D, F, s);
  if (dtype == rt::kBFloat16) return launch<__nv_bfloat16>(x, wg, wu, wd, h, y, N, D, F, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
