// SwiGLU MLP: y = (silu(x @ Wg) * (x @ Wu)).to(x.dtype) @ Wd, fp32 accumulation.
//
// Replaces the Pallas kernel _swiglu_kernel (src/repro/kernels/swiglu.py).
// The TPU kernel carries a (block_m, D) fp32 accumulator across the d_ff axis
// of its sequential grid and keeps h in VMEM.  GPU blocks run in no order,
// and that accumulator (128 rows x D fp32: 800 KB at Hymba's D = 1600) is
// far beyond a block's 227 KB of shared memory, so the port splits the work
// into two products on the same stream and h travels through device memory
// as an (N, F) buffer in x's dtype (48 MB at Hymba's 4352 x 5504, an eighth
// of the bound's bytes):
//   1. gated product: h = silu(x @ Wg) * (x @ Wu), in fp32, cast once;
//   2. down product:  y = h @ Wd, cast once.
// Two routes, chosen by the wrapper (kernels/swiglu.py, route()) from the
// dtype, the shape and the pointers' alignment alone:
//
// Tensor cores (bf16, D and F multiples of 8, 16-byte aligned pointers: the
// TMA's rules).  Bound on the H100: at training rows by operations (6 N D F
// at 989 TFLOP/s, 0.072 ms for qwen's 4096 rows), at 8 decode rows by the
// weights' bytes (3 D F bf16, 17.3 MB a qwen layer: 0.005 ms).  Both products
// run one warp-specialised kernel, swiglu_tc_kernel: a producer warp keeps
// TMA loads of (rows x 64) x tiles and (64 x 128) weight tiles in flight in
// a 4-stage mbarrier ring; consumer warpgroups of 64 rows each run wgmma
// m64n128k16 into two fp32 accumulators.  The weights are row-major (K, N),
// so B is MN-major: wgmma's transpose-B reads the 128-byte-swizzled boxes as
// the TMA wrote them, and no weight is transposed.  The gated product's two
// accumulators are gate and up of 128 columns; the down product's are two
// 128-column halves of a 256-column tile.  Ragged edges: TMA fills
// out-of-bounds loads with zeros, and the epilogue masks the stores.
//  - Training rows (N >= 64): 128-row tiles, two consumer warpgroups; the
//    epilogue forms silu(g) * u = g / (1 + exp(-g)) * u in fp32, as the CUDA-
//    core kernel does, or the down product's cast, and stores from registers.
//    When a gradient is needed it also stores g and u, cast once, as a and b
//    for the backward (2 N F bf16 more written: 46 MB at qwen's 4096 rows).
//    XLA's autodiff of layers.swiglu keeps the same two arrays.  The gated
//    product's stores are 16 bytes a lane (hop::quad_transpose).
//  - Decode rows (N < 64): 64-row tiles (rows past N are the TMA's zeros), one
//    consumer warpgroup, and the contraction split over blocks (split-K) so
//    that about one block per SM streams the weights.  Each block writes its
//    fp32 partial sums to scratch; swiglu_splitk_sum_kernel adds them in a
//    fixed order and applies silu * mul or the cast: no atomics, the same
//    bits every run.
//
// CUDA cores (fp32, and bf16 that the TMA cannot take): rows_matmul_kernel,
// built for decode.  Bound by reading the weights once per 8 rows: each block
// owns 32 output columns (one per lane, so a warp reads 32 neighbouring
// weights of a row) and 8 rows of x; its 8 warps split the contraction axis,
// and their partial sums meet in shared memory.
#include "common.cuh"
#include "hopper.cuh"

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

// ------------------------------------------------------------ tensor cores
namespace {

constexpr int kBK = 64;                  // contraction per stage: one 128-byte bf16 row
constexpr int kBN = 128;                 // columns of one accumulator
constexpr int kStages = 4;
constexpr int kBox = 64 * 64 * 2;        // one 64 x 64 bf16 TMA box: 8 KB
constexpr int kTileB = 2 * kBox;         // a 64 x 128 weight tile: two boxes side by side

template <int kWG>
struct Layout {
  static constexpr int kTileA = kWG * 64 * kBK * 2;     // (64 kWG) x 64 of the left operand
  static constexpr int kStage = kTileA + 2 * kTileB;    // 48 KB with two consumer warpgroups
  static constexpr int kThreads = 128 * (kWG + 1);      // consumers, then the producer
  static constexpr int kSmem = 1024 + kStages * kStage + 2 * kStages * 8;
};

struct Args {
  int M;        // rows of the left operand and of the output
  int K;        // contraction length
  int ldc;      // columns of the output (F for the gated product, D for the down one)
  int split;    // blocks along the contraction (gridDim.z)
  void* out;    // (M, ldc) bf16 when split == 1
  float* part;  // (split, [2,] M, ldc) fp32 partial sums when split > 1
  void* a_out;  // gated product, or null: (M, ldc) bf16 x Wg, saved for the backward
  void* b_out;  // likewise x Wu (both null or both set)
};

// kGated: accumulators (x Wg, x Wu) over columns [n0, n0 + 128), out =
// silu(g) * u; otherwise (h Wd) over [n0, n0 + 128) and [n0 + 128, n0 + 256).
// ta: the left operand, box (64, 64 kWG); tb0, tb1: the weights, box (64, 64).
template <bool kGated, int kWG>
__global__ void __launch_bounds__(Layout<kWG>::kThreads, 1)
    swiglu_tc_kernel(const __grid_constant__ CUtensorMap ta,
                     const __grid_constant__ CUtensorMap tb0,
                     const __grid_constant__ CUtensorMap tb1, Args args) {
  using L = Layout<kWG>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hop::align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * L::kStage);
  uint64_t* empty = full + kStages;

  const int n0 = blockIdx.x * (kGated ? kBN : 2 * kBN);
  const int m0 = blockIdx.y * 64 * kWG;
  const int k_tiles = (args.K + kBK - 1) / kBK;
  const int kt0 = static_cast<int>(blockIdx.z) * k_tiles / args.split;
  const int nk = (static_cast<int>(blockIdx.z) + 1) * k_tiles / args.split - kt0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 4 * kWG);  // lane 0 of every consumer warp
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (wg == kWG) {  // producer warpgroup: one thread starts every load
    // with one consumer warpgroup (256 threads) every thread has registers enough
    if constexpr (kWG == 2) hop::regs_release<40>();
    if (threadIdx.x != kWG * 128) return;
    for (int i = 0; i < nk; ++i) {
      const int s = i % kStages;
      if (i >= kStages) hop::mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
      uint8_t* st = smem + s * L::kStage;
      const int kc = (kt0 + i) * kBK;
      const int n1 = kGated ? n0 : n0 + kBN;
      hop::mbar_expect_tx(&full[s], L::kStage);
      hop::tma_load_2d(st, &ta, &full[s], kc, m0);
      hop::tma_load_2d(st + L::kTileA, &tb0, &full[s], n0, kc);
      hop::tma_load_2d(st + L::kTileA + kBox, &tb0, &full[s], n0 + 64, kc);
      hop::tma_load_2d(st + L::kTileA + kTileB, &tb1, &full[s], n1, kc);
      hop::tma_load_2d(st + L::kTileA + kTileB + kBox, &tb1, &full[s], n1 + 64, kc);
    }
    return;
  }

  // consumer warpgroup wg: rows m0 + 64 wg .. + 63
  if constexpr (kWG == 2) hop::regs_claim<232>();
  float acc0[64];
  float acc1[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
  const int lane = threadIdx.x % 32;
  for (int i = 0; i < nk; ++i) {
    const int s = i % kStages;
    hop::mbar_wait(&full[s], (i / kStages) & 1);
    const uint8_t* st = smem + s * L::kStage;
    hop::fence_regs(acc0);
    hop::fence_regs(acc1);
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t da = hop::desc_sw128(st + wg * 64 * 128 + kk * 32, 16, 1024);
      const uint64_t db0 = hop::desc_sw128(st + L::kTileA + kk * 2048, kBox, 1024);
      const uint64_t db1 = hop::desc_sw128(st + L::kTileA + kTileB + kk * 2048, kBox, 1024);
      hop::wgmma_ss_n128<1>(acc0, da, db0, 1);
      hop::wgmma_ss_n128<1>(acc1, da, db1, 1);
    }
    hop::wgmma_commit();
    // keep this stage's products in flight; the previous stage is read
    hop::wgmma_wait<1>();
    hop::fence_regs(acc0);
    hop::fence_regs(acc1);
    if (i > 0 && lane == 0) hop::mbar_arrive(&empty[(i - 1) % kStages]);
  }
  hop::wgmma_wait<0>();
  hop::fence_regs(acc0);
  hop::fence_regs(acc1);
  // the last stage needs no release: nothing is loaded after it

  const int warp = (threadIdx.x % 128) / 32;
  const int r0 = m0 + wg * 64 + warp * 16 + lane / 4;
  const int c0 = n0 + 2 * (lane % 4);
  const size_t plane = static_cast<size_t>(args.M) * args.ldc;
  if (kGated && args.split == 1) {
    // h (and a, b) by 16-byte stores, a quad's 64 bytes of a row contiguous:
    // four column groups at a time through hop::quad_transpose (ldc = F is a
    // multiple of 8, so a group is all in or all out)
    const int t = lane % 4;
    const bool save = args.a_out != nullptr;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 8 * half;
#pragma unroll
      for (int jb = 0; jb < 4; ++jb) {
        uint32_t hv[4], av[4], bv[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int e = 4 * (4 * jb + k) + 2 * half;
          const float g0 = acc0[e], g1 = acc0[e + 1];
          const float u0 = acc1[e], u1 = acc1[e + 1];
          hv[k] = hop::pack_bf16(g0 / (1.f + expf(-g0)) * u0, g1 / (1.f + expf(-g1)) * u1);
          av[k] = hop::pack_bf16(g0, g1);
          bv[k] = hop::pack_bf16(u0, u1);
        }
        hop::quad_transpose(hv);
        if (save) {
          hop::quad_transpose(av);
          hop::quad_transpose(bv);
        }
        const int c = n0 + 8 * (4 * jb + t);
        if (r >= args.M || c >= args.ldc) continue;
        const size_t at = static_cast<size_t>(r) * args.ldc + c;
        *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(args.out) + at) =
            make_uint4(hv[0], hv[1], hv[2], hv[3]);
        if (save) {
          *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(args.a_out) + at) =
              make_uint4(av[0], av[1], av[2], av[3]);
          *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(args.b_out) + at) =
              make_uint4(bv[0], bv[1], bv[2], bv[3]);
        }
      }
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 8 * half;
      const int c = c0 + 8 * j;
      if (r >= args.M) continue;
      const float g0 = acc0[4 * j + 2 * half], g1 = acc0[4 * j + 2 * half + 1];
      const float u0 = acc1[4 * j + 2 * half], u1 = acc1[4 * j + 2 * half + 1];
      const size_t at = static_cast<size_t>(r) * args.ldc + c;
      if (args.split > 1) {
        float* p = args.part + blockIdx.z * (kGated ? 2 : 1) * plane + at;
        if (kGated) {
          if (c < args.ldc) {
            *reinterpret_cast<float2*>(p) = make_float2(g0, g1);
            *reinterpret_cast<float2*>(p + plane) = make_float2(u0, u1);
          }
        } else {
          if (c < args.ldc) *reinterpret_cast<float2*>(p) = make_float2(g0, g1);
          if (c + kBN < args.ldc) *reinterpret_cast<float2*>(p + kBN) = make_float2(u0, u1);
        }
        continue;
      }
      // the down product (the gated one stored above)
      uint32_t* o = reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(args.out) + at);
      if (c < args.ldc) *o = hop::pack_bf16(g0, g1);
      if (c + kBN < args.ldc) o[kBN / 2] = hop::pack_bf16(u0, u1);
    }
  }
}

// out[i] = epilogue(sum over the split of part[z][i]), z in order; the gated
// product also writes the two sums to a_out and b_out where they are set.
template <bool kGated>
__global__ void __launch_bounds__(256)
    swiglu_splitk_sum_kernel(const float* __restrict__ part, __nv_bfloat16* __restrict__ out,
                             __nv_bfloat16* __restrict__ a_out,
                             __nv_bfloat16* __restrict__ b_out, int split, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    float a = 0.f;
    float b = 0.f;
    for (int z = 0; z < split; ++z) {
      a += part[static_cast<size_t>(z) * (kGated ? 2 : 1) * n + i];
      if (kGated) b += part[(static_cast<size_t>(z) * 2 + 1) * n + i];
    }
    out[i] = __float2bfloat16(kGated ? a / (1.f + expf(-a)) * b : a);
    if (kGated && a_out != nullptr) {
      a_out[i] = __float2bfloat16(a);
      b_out[i] = __float2bfloat16(b);
    }
  }
}

// A row-major (rows, cols) bf16 matrix as a TMA map with box (64, box_rows).
int map_2d(CUtensorMap* m, const void* p, int rows, int cols, int box_rows) {
  const uint64_t dims[2] = {static_cast<uint64_t>(cols), static_cast<uint64_t>(rows)};
  const uint64_t strides[1] = {static_cast<uint64_t>(cols) * 2};
  const uint32_t box[2] = {64, static_cast<uint32_t>(box_rows)};
  return hop::make_map(m, p, 2, dims, strides, box);
}

template <bool kGated, int kWG>
int product(const void* a, const void* b0, const void* b1, int M, int K, int ldc, int split,
            void* out, float* part, void* a_out, void* b_out, cudaStream_t s) {
  using L = Layout<kWG>;
  CUtensorMap ta, tb0, tb1;
  int err = map_2d(&ta, a, M, K, 64 * kWG);
  if (!err) err = map_2d(&tb0, b0, K, ldc, 64);
  if (!err) err = map_2d(&tb1, b1, K, ldc, 64);
  if (err) return err;
  auto kernel = swiglu_tc_kernel<kGated, kWG>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int cols = kGated ? kBN : 2 * kBN;
  const dim3 grid((ldc + cols - 1) / cols, (M + 64 * kWG - 1) / (64 * kWG), split);
  kernel<<<grid, L::kThreads, L::kSmem, s>>>(
      ta, tb0, tb1, Args{M, K, ldc, split, out, part, a_out, b_out});
  e = cudaGetLastError();
  if (e != cudaSuccess || split == 1) return static_cast<int>(e);
  const int n = M * ldc;
  swiglu_splitk_sum_kernel<kGated><<<(n + 255) / 256, 256, 0, s>>>(
      part, static_cast<__nv_bfloat16*>(out), static_cast<__nv_bfloat16*>(a_out),
      static_cast<__nv_bfloat16*>(b_out), split, n);
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

// Tensor-core route, bf16 only.  x: (N, D); wg, wu: (D, F); wd: (F, D); h: (N,
// F) scratch; y: (N, D).  N >= 64 (training rows): 128-row tiles.  N < 64
// (decode rows, MIN_TILE_ROWS in kernels/swiglu.py): 64-row tiles.
// split_gate, split_down: blocks along the contraction of each product;
// where one is above 1, part holds max(2 split_gate N F, split_down N D)
// floats.  a_out, b_out: null, or (N, F) bf16 each for a = x Wg and b = x Wu
// as the gated product's fp32 sums hold them, cast once: what the backward
// (swiglu_bwd.cu) reads instead of computing them again.  Returns the first
// error (tensor map, attribute or launch), else 0.
extern "C" int rt_swiglu_tc(const void* x, const void* wg, const void* wu, const void* wd,
                            void* h, void* y, void* part, void* a_out, void* b_out, int N, int D,
                            int F, int split_gate, int split_down, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  const bool decode = N < 64;
  int err = decode ? product<true, 1>(x, wg, wu, N, D, F, split_gate, h, p, a_out, b_out, s)
                   : product<true, 2>(x, wg, wu, N, D, F, split_gate, h, p, a_out, b_out, s);
  if (err) return err;
  return decode ? product<false, 1>(h, wd, wd, N, F, D, split_down, y, p, nullptr, nullptr, s)
                : product<false, 2>(h, wd, wd, N, F, D, split_down, y, p, nullptr, nullptr, s);
}
