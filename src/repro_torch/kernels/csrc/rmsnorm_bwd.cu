// Row RMSNorm backward: dx and dgamma, fp32 inside, one cast each.
//
// The Pallas rmsnorm kernel (src/repro/kernels/rmsnorm.py) is forward only;
// in the JAX package XLA differentiates rms_norm (src/repro/models/layers.py).
// For each row, r = rsqrt(mean(x^2) + eps), xhat = x r and g = dy gamma; then
// dx = r (g - xhat mean(g xhat)) and dgamma = sum over rows of dy xhat.
// What bounds it on the H100: device memory, at 3 D bytes per row (read x and
// dy, write dx) plus the fp32 partial rows of dgamma, written and read once.
//
// No atomics, so dgamma is the same from run to run: each block writes one
// fp32 partial row of dgamma (its rows' sum, in a fixed order) to `partial`
// (n_blocks, D), and dgamma_reduce_kernel sums the partial rows in a fixed
// order.  Two bodies, chosen by the wrapper (kernels/rmsnorm_bwd.py, route()):
//
// rmsnorm_bwd_vec_kernel (D a multiple of 8, a row of at most 8 KB, x, gamma
// and dy 16-byte aligned): one warp a row, after the forward's vec body.  The
// rows reach shared memory by TMA bulk copies, three rows of x and of dy in
// flight a warp, so that the rows in flight do not cost registers: device
// memory is read once, and each pass reads the row's 16-byte vectors from
// shared memory.  Both row sums (x^2 and g x) are reduced by warp shuffles
// alone, with no block barrier a row; dx leaves with 16-byte stores.  A lane
// owns fixed columns and sums dy xhat for them in fp32 registers over the
// rows its warp takes (row warp, warp + all warps, ...): 56 values a lane at
// hymba-1.5b's D = 1600, 128 at the 8 KB rows of xlstm-1.3b's mLSTM output
// norm (D = 4096), which caps the row.  Blocks of 8 warps (4 past 4 KB rows);
// the wrapper launches as many as the card holds at once, which the shared
// memory sets (rt_rmsnorm_bwd_vec_config), at most two an SM.  At the end
// the block's warps add their sums in warp order.  It stays well under the
// bound (chip_smoke.py times it beside the bound and PyTorch's own
// backward): trial builds with the sums in shared memory, 4 to 16 warps a
// block, or plain loads in place of the bulk copies were no faster, and one
// with the arithmetic taken out was slower than an elementwise pass over the
// same bytes, so the loop over rows and the second launch are what hold it
// back.
//
// rmsnorm_bwd_kernel (any other D up to MAX_D): one block per run of rows;
// per row the two sums by warp shuffles and shared memory, then dx, the row
// read twice; each thread keeps the dgamma partial of its own columns in
// shared memory.
#include "common.cuh"
#include "hopper.cuh"

#include <type_traits>

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

constexpr int kVecStages = 3;  // rows of x and of dy in flight a warp

// Warps of a vec block: 8, or 4 for rows of over 4 KB, so that a block's rows
// in flight (kVecWarps kVecStages rows of x and of dy) fit its shared memory.
template <typename T, int kVec>
constexpr int kVecWarps = kVec * 32 * 16 > 4096 ? 4 : 8;

// Warp w of block b takes rows b kVecWarps + w, then every gridDim.x
// kVecWarps rows.  Its lane 0 keeps kVecStages of them in flight: a TMA bulk
// copy of the x row and of the dy row into the warp's stage s of shared
// memory, completing on bar[w][s].  Lane l owns the 16-byte vectors l, l +
// 32, ... of a row, reads them from the stage in each pass and sums dy xhat
// for them in fp32 registers.
template <typename T, int kVec>
__global__ void __launch_bounds__(32 * kVecWarps<T, kVec>)
    rmsnorm_bwd_vec_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                           const T* __restrict__ dy, T* __restrict__ dx,
                           float* __restrict__ partial, int rows, int D, float eps) {
  constexpr int kPer = 16 / sizeof(T);  // elements in 16 bytes
  constexpr int kWarps = kVecWarps<T, kVec>;
  extern __shared__ __align__(16) uint8_t smem[];  // [warp][stage][x row, dy row]
  __shared__ uint64_t bar[kWarps][kVecStages];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int nvec = D / kPer;
  const uint32_t row_bytes = static_cast<uint32_t>(D) * sizeof(T);
  uint8_t* ring = smem + static_cast<size_t>(warp) * kVecStages * 2 * row_bytes;
  const long long step = static_cast<long long>(gridDim.x) * kWarps;
  const long long first = static_cast<long long>(blockIdx.x) * kWarps + warp;

  // lane 0: rows first + s step .. into stage s (its barrier expects both copies)
  auto fetch = [&](int s, long long row) {
    hop::mbar_expect_tx(&bar[warp][s], 2 * row_bytes);
    hop::bulk_load(ring + s * 2 * row_bytes, x + row * D, row_bytes, &bar[warp][s]);
    hop::bulk_load(ring + s * 2 * row_bytes + row_bytes, dy + row * D, row_bytes,
                   &bar[warp][s]);
  };
  if (lane == 0) {
    for (int s = 0; s < kVecStages; ++s) hop::mbar_init(&bar[warp][s], 1);
    hop::mbar_fence_init();
    for (int s = 0; s < kVecStages && first + s * step < rows; ++s) fetch(s, first + s * step);
  }
  __syncwarp();

  const uint4* gr = reinterpret_cast<const uint4*>(gamma);
  float dg[kVec][kPer];
#pragma unroll
  for (int i = 0; i < kVec; ++i)
#pragma unroll
    for (int k = 0; k < kPer; ++k) dg[i][k] = 0.f;

  int n = 0;  // rows this warp has taken
  for (long long row = first; row < rows; row += step, ++n) {
    const int s = n % kVecStages;
    hop::mbar_wait(&bar[warp][s], (n / kVecStages) & 1);
    const uint4* xs = reinterpret_cast<const uint4*>(ring + s * 2 * row_bytes);
    const uint4* ds = reinterpret_cast<const uint4*>(ring + s * 2 * row_bytes + row_bytes);
    float ss = 0.f;
    float gx = 0.f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int c = lane + 32 * i;
      if (c < nvec) {
        const uint4 xv = xs[c];
        const uint4 dv = ds[c];
        const uint4 gv = gr[c];
        const T* xe = reinterpret_cast<const T*>(&xv);
        const T* de = reinterpret_cast<const T*>(&dv);
        const T* ge = reinterpret_cast<const T*>(&gv);
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          const float xf = rt::to_float(xe[k]);
          ss += xf * xf;
          gx += rt::to_float(de[k]) * rt::to_float(ge[k]) * xf;
        }
      }
    }
    const float r = rsqrtf(rt::warp_sum(ss) / static_cast<float>(D) + eps);
    const float mean = rt::warp_sum(gx) * r / static_cast<float>(D);  // mean(g xhat)
    uint4* dxr = reinterpret_cast<uint4*>(dx + row * D);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int c = lane + 32 * i;
      if (c < nvec) {
        const uint4 xv = xs[c];
        const uint4 dv = ds[c];
        const uint4 gv = gr[c];
        const T* xe = reinterpret_cast<const T*>(&xv);
        const T* de = reinterpret_cast<const T*>(&dv);
        const T* ge = reinterpret_cast<const T*>(&gv);
        uint4 o;
        T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          const float xhat = rt::to_float(xe[k]) * r;
          const float dyv = rt::to_float(de[k]);
          oe[k] = rt::from_float<T>(r * (dyv * rt::to_float(ge[k]) - xhat * mean));
          dg[i][k] += dyv * xhat;
        }
        dxr[c] = o;
      }
    }
    // the stage is read: lane 0 refills it with the row kVecStages on
    __syncwarp();
    if (lane == 0 && row + kVecStages * step < rows) fetch(s, row + kVecStages * step);
  }

  // the block's partial row: the warps' sums added in warp order, through the
  // rings (every copy has landed: each warp waited for all it started)
  __syncthreads();
  float* sums = reinterpret_cast<float*>(smem);  // [warp][D]
#pragma unroll
  for (int i = 0; i < kVec; ++i)
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int col = (lane + 32 * i) * kPer + k;
      if (col < D) sums[warp * D + col] = dg[i][k];
    }
  __syncthreads();
  for (int col = threadIdx.x; col < D; col += 32 * kWarps) {
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += sums[w * D + col];
    partial[static_cast<size_t>(blockIdx.x) * D + col] = t;
  }
}

// dgamma[i] = sum over b of partial[b][i], in a fixed order: a block takes 32
// columns; its 8 warps each sum every 8th partial row in order (warp s: rows
// s, s + 8, ...), and then the 8 sums are added in warp order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dgamma_reduce_kernel(const float* __restrict__ partial, T* __restrict__ dgamma, int n_blocks,
                         int D) {
  __shared__ float red[kWarps][32];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int i = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (i < D)
    for (int b = warp; b < n_blocks; b += kWarps) s += partial[static_cast<size_t>(b) * D + i];
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && i < D) {
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += red[w][lane];
    dgamma[i] = rt::from_float<T>(t);
  }
}

template <typename T>
int reduce(const float* partial, void* dgamma, int D, int n_blocks, cudaStream_t s) {
  dgamma_reduce_kernel<T><<<(D + 31) / 32, kThreads, 0, s>>>(partial, static_cast<T*>(dgamma),
                                                             n_blocks, D);
  return static_cast<int>(cudaGetLastError());
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
  return reduce<T>(partial, dgamma, D, n_blocks, s);
}

// Dynamic shared memory of a vec block: kVecStages rows of x and of dy a warp.
template <typename T, int kVec>
int vec_smem(int D) {
  return kVecWarps<T, kVec> * kVecStages * 2 * D * static_cast<int>(sizeof(T));
}

// f(std::integral_constant<int, kVec>) for the smallest instance whose kVec
// vectors a lane cover the row; cudaErrorInvalidValue past 16.
template <typename T, typename F>
int with_vec(int D, F f) {
  const int per_lane = (D / (16 / static_cast<int>(sizeof(T))) + 31) / 32;
  if (per_lane <= 1) return f(std::integral_constant<int, 1>{});
  if (per_lane <= 2) return f(std::integral_constant<int, 2>{});
  if (per_lane <= 4) return f(std::integral_constant<int, 4>{});
  if (per_lane <= 8) return f(std::integral_constant<int, 8>{});
  if (per_lane <= 16) return f(std::integral_constant<int, 16>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int vec_config(int D, int* warps, int* blocks_per_sm) {
  return with_vec<T>(D, [&](auto vec) {
    constexpr int kVec = decltype(vec)::value;
    auto kernel = rmsnorm_bwd_vec_kernel<T, kVec>;
    const int smem = vec_smem<T, kVec>(D);
    // The limit belongs to the kernel instance, which row lengths of the same
    // kVec share (fp32 1600 and 2048): a shorter row configured later must
    // not lower it below a longer one's, whose launches read it still.
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
    if (e == cudaSuccess && smem > attr.maxDynamicSharedSizeBytes)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel,
                                                        32 * kVecWarps<T, kVec>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (*blocks_per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    *warps = kVecWarps<T, kVec>;
    return 0;
  });
}

template <typename T>
int launch_vec(const void* x, const void* gamma, const void* dy, void* dx, float* partial,
               void* dgamma, int rows, int D, int n_blocks, float eps, cudaStream_t s) {
  return with_vec<T>(D, [&](auto vec) {
    constexpr int kVec = decltype(vec)::value;
    constexpr int kThreadsVec = 32 * kVecWarps<T, kVec>;
    rmsnorm_bwd_vec_kernel<T, kVec><<<n_blocks, kThreadsVec, vec_smem<T, kVec>(D), s>>>(
        static_cast<const T*>(x), static_cast<const T*>(gamma), static_cast<const T*>(dy),
        static_cast<T*>(dx), partial, rows, D, eps);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    return reduce<T>(partial, dgamma, D, n_blocks, s);
  });
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

// The vec body's launch shape at row length D: its warps a block and, from the
// occupancy calculator, its blocks an SM.  Also raises the kernel's dynamic
// shared-memory limit on the current device to what D needs, if it is lower
// (never lowers it), which its launches need: call it once per device, D and
// dtype before rt_rmsnorm_bwd_vec.  Returns the first error, else 0.
extern "C" int rt_rmsnorm_bwd_vec_config(int D, int dtype, int* warps, int* blocks_per_sm) {
  if (D % 8 || D < 8) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == rt::kFloat32) return vec_config<float>(D, warps, blocks_per_sm);
  if (dtype == rt::kBFloat16) return vec_config<__nv_bfloat16>(D, warps, blocks_per_sm);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The vec body: D a multiple of 8 with a row of at most 8 KB, x, gamma and dy
// 16-byte aligned; n_blocks >= 1 blocks (the wrapper takes as many as the card
// holds at once, from rt_rmsnorm_bwd_vec_config), partial: (n_blocks, D) fp32
// scratch; other arguments as rt_rmsnorm_bwd's.  Returns the first launch
// error, else 0.
extern "C" int rt_rmsnorm_bwd_vec(const void* x, const void* gamma, const void* dy, void* dx,
                                  void* partial, void* dgamma, int rows, int D, int n_blocks,
                                  float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  if (D % 8 || D < 8) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == rt::kFloat32)
    return launch_vec<float>(x, gamma, dy, dx, p, dgamma, rows, D, n_blocks, eps, s);
  if (dtype == rt::kBFloat16)
    return launch_vec<__nv_bfloat16>(x, gamma, dy, dx, p, dgamma, rows, D, n_blocks, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
