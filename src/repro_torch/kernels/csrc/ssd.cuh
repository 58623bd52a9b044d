// Building blocks of the SSD chunked-scan kernels (ssd_scan.cu, ssd_scan_bwd.cu).
//
// Tensors keep the model's layout: lf (B, S, H); b, c (B, S, H, N); x, dy, y
// (B, S, H, chd); element (b, s, h, f) of a (B, S, H, F) tensor sits at
// ((b * S + s) * H + h) * F + f.  A chunk entry z = bh * nc + k is chunk k of
// (b, h) = (bh / H, bh % H), rows s = k * L + t.  The fp32 side tensors are
// cum (BH, S), the inclusive sum of lf within each chunk, and the states
// (BH, nc, chd, N).  Three device functions serve both directions:
//
//   chunk_state: one chunk's own state, 64 columns of chd x N:
//                forward  S_k  = sum_t exp(cum_L - cum_t) x_t b_t^T,
//                backward U_k  = sum_t exp(cum_t) dy_t c_t^T;
//   state_scan:  per (b, h) and state element, over the chunks in order
//                (h_{k+1} = exp(cum_L) h_k + S_k) or in reverse (dH_{k-1} =
//                exp(cum_L) dH_k + U_k), overwriting each chunk's entry with
//                the carried value at its start (forward) or end (backward);
//   chunk_out:   a 64 x 64 tile of rows x columns of chd:
//                forward  y_t  = sum_{s<=t} (c_t . b_s) exp(cum_t - cum_s) x_s
//                                + exp(cum_t) H_k c_t,
//                backward dx_s = sum_{t>=s} (c_t . b_s) exp(cum_t - cum_s) dy_t
//                                + exp(cum_L - cum_s) dH_k b_s.
//
// The decay exp(cum_t - cum_s) is formed for s <= t only: with lf <= 0 every
// exponent taken is <= 0.  All sums are fp32, each in a fixed order, so a run
// gives the same bits every time.
//
// Two versions of chunk_state and chunk_out.  The functions above (the
// "simt" route: fp32, or any shape the other does not take) widen every
// tile to fp32 in shared memory and sum with FMAs on the CUDA cores; at
// hymba-1.5b's shape they ran 38x (forward) and 62x (backward) their byte
// bound, paced by those FMAs and by staging loops that fetch 32 to 128 bytes
// of a row 6400 bytes from the next.  Namespace tc below (the "wgmma" route:
// bf16, chunk 128) loads its tiles by TMA and runs every product on the
// tensor cores; state_scan serves both.
#pragma once

#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace ssd {

constexpr int kBlock = 256;   // threads per block
constexpr int kWarps = kBlock / 32;
constexpr int kTile = 64;     // output rows and columns of a chunk_out block
constexpr int kSlab = 16;     // reduction depth per shared-memory stage
constexpr int kMaxL = 128;    // longest chunk
constexpr int kMaxN = 64;     // largest state width

struct Dims {
  int B, S, H, N, chd, L, nc;
};

// Offset of (b, s0, h) in units of the last axis (multiply by F and add f),
// bh = b * H + h; row s0 + t of the same (b, h) sits t * H further on.  A
// block takes it once: 64-bit division is slow.
__device__ __forceinline__ long long row0(const Dims& d, long long bh, long long s0) {
  return ((bh / d.H) * d.S + s0) * d.H + bh % d.H;
}

__host__ __device__ __forceinline__ int round_up(int v, int m) { return (v + m - 1) / m * m; }

template <typename T>
__device__ __forceinline__ float ld(const void* p, long long i) {
  return rt::to_float(static_cast<const T*>(p)[i]);
}

__device__ __forceinline__ float dot(const float* a, const float* b, int n) {
  float s = 0.f;
  for (int i = 0; i < n; ++i) s = fmaf(a[i], b[i], s);
  return s;
}

// ----------------------------------------------------------------- chunk_state
struct StateArgs {
  const void* x;     // (B, S, H, chd): x (forward) or dy (backward)
  const void* v;     // (B, S, H, N): b (forward) or c (backward)
  const float* cum;  // (BH, S)
  float* out;        // (BH, nc, chd, N)
  Dims d;
  int bwd;
};

inline size_t state_smem(const Dims& d) {
  return sizeof(float) * (static_cast<size_t>(d.L) * d.N + kSlab * kTile);
}

// grid (ceil(chd / 64), BH * nc); out(col, n) = sum_t x_t[col] w_t v_t[n]
template <typename T>
__device__ __forceinline__ void chunk_state(const StateArgs& a) {
  extern __shared__ float sm[];
  const Dims& d = a.d;
  float* vw = sm;                  // [L][N]: w_t v_t
  float* xs = vw + d.L * d.N;      // [kSlab][kTile]
  const long long z = blockIdx.y;
  const long long bh = z / d.nc;
  const int k = static_cast<int>(z % d.nc);
  const int col0 = blockIdx.x * kTile;
  const float* cz = a.cum + bh * d.S + static_cast<long long>(k) * d.L;
  const float c_last = cz[d.L - 1];
  const long long r0 = row0(d, bh, static_cast<long long>(k) * d.L);
  for (int e = threadIdx.x; e < d.L * d.N; e += kBlock) {
    const int t = e / d.N;
    const float w = a.bwd ? expf(cz[t]) : expf(c_last - cz[t]);
    vw[e] = w * ld<T>(a.v, (r0 + static_cast<long long>(t) * d.H) * d.N + e % d.N);
  }
  constexpr int kPer = kTile * kMaxN / kBlock;
  float acc[kPer] = {};
  for (int t0 = 0; t0 < d.L; t0 += kSlab) {
    __syncthreads();
    for (int e = threadIdx.x; e < kSlab * kTile; e += kBlock) {
      const int t = t0 + e / kTile;
      const int col = col0 + e % kTile;
      const long long i = (r0 + static_cast<long long>(t) * d.H) * d.chd + col;
      xs[e] = (t < d.L && col < d.chd) ? ld<T>(a.x, i) : 0.f;
    }
    __syncthreads();
    const int depth = min(kSlab, d.L - t0);
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int o = threadIdx.x + q * kBlock;
      const int n = o / kTile;
      if (n < d.N) {
        const float* vcol = vw + t0 * d.N + n;
        const float* xcol = xs + o % kTile;
        for (int kk = 0; kk < depth; ++kk) acc[q] = fmaf(xcol[kk * kTile], vcol[kk * d.N], acc[q]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int o = threadIdx.x + q * kBlock;
    const int n = o / kTile;
    const int col = col0 + o % kTile;
    if (n < d.N && col < d.chd) a.out[(z * d.chd + col) * d.N + n] = acc[q];
  }
}

// ------------------------------------------------------------------ state_scan
struct ScanArgs {
  float* states;     // (BH, nc, chd, N), overwritten in place
  const float* cum;  // (BH, S)
  float* last;       // (BH, chd, N) or nullptr: the carried value after the last step
  Dims d;
  int reverse;
};

// grid (ceil(chd * N / 256), BH)
__device__ __forceinline__ void state_scan(const ScanArgs& a) {
  const Dims& d = a.d;
  const long long per = static_cast<long long>(d.chd) * d.N;
  const long long e = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (e >= per) return;
  const long long bh = blockIdx.y;
  float h = 0.f;
  for (int step = 0; step < d.nc; ++step) {
    const int k = a.reverse ? d.nc - 1 - step : step;
    const long long o = (bh * d.nc + k) * per + e;
    const float add = a.states[o];
    a.states[o] = h;
    const float decay = expf(a.cum[bh * d.S + static_cast<long long>(k) * d.L + d.L - 1]);
    h = decay * h + add;
  }
  if (a.last) a.last[bh * per + e] = h;
}

// ------------------------------------------------------------------- chunk_out
struct OutArgs {
  const void* src;      // (B, S, H, chd): x (forward) or dy (backward)
  const void* b;        // (B, S, H, N)
  const void* c;        // (B, S, H, N)
  const float* cum;     // (BH, S)
  const float* states;  // (BH, nc, chd, N): h at each chunk's start, or dH at its end
  void* out;            // (B, S, H, chd): y or dx
  Dims d;
  int bwd;
};

inline size_t out_smem(const Dims& d) {
  const size_t ldg = round_up(d.L, kSlab) + 1;
  return sizeof(float) * (d.L + 2 * static_cast<size_t>(d.L) * (d.N + 1) + kTile * ldg +
                          kSlab * kTile + kTile * (d.N + 1));
}

// grid (ceil(chd / 64), ceil(L / 64), BH * nc)
template <typename T>
__device__ __forceinline__ void chunk_out(const OutArgs& a) {
  extern __shared__ float sm[];
  const Dims& d = a.d;
  const int L = d.L;
  const int N = d.N;
  const int kp = round_up(L, kSlab);
  const int ldg = kp + 1;
  const int ldn = N + 1;           // odd row strides: a warp's reads across rows hit 32 banks
  float* cum = sm;                 // [L]
  float* bs = cum + L;             // [L][ldn]
  float* cs = bs + L * ldn;        // [L][ldn]
  float* G = cs + L * ldn;         // [kTile][ldg]: G(r, kk) for output row m0 + r
  float* xs = G + kTile * ldg;     // [kSlab][kTile]
  float* hs = xs + kSlab * kTile;  // [kTile][N + 1]
  const long long z = blockIdx.z;
  const long long bh = z / d.nc;
  const int k = static_cast<int>(z % d.nc);
  const int col0 = blockIdx.x * kTile;
  const int m0 = blockIdx.y * kTile;
  const long long s0 = static_cast<long long>(k) * L;
  const long long r0 = row0(d, bh, s0);
  for (int t = threadIdx.x; t < L; t += kBlock) cum[t] = a.cum[bh * d.S + s0 + t];
  for (int e = threadIdx.x; e < L * N; e += kBlock) {
    const long long i = (r0 + static_cast<long long>(e / N) * d.H) * N + e % N;
    bs[e / N * ldn + e % N] = ld<T>(a.b, i);
    cs[e / N * ldn + e % N] = ld<T>(a.c, i);
  }
  for (int e = threadIdx.x; e < kTile * N; e += kBlock) {
    const int col = e / N;
    hs[col * ldn + e % N] =
        col0 + col < d.chd ? a.states[(z * d.chd + col0 + col) * N + e % N] : 0.f;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kTile * kp; e += kBlock) {
    const int r = e / kp;
    const int kk = e % kp;
    const int m = m0 + r;
    float val = 0.f;
    if (m < L && kk < L) {
      if (!a.bwd && kk <= m) val = dot(cs + m * ldn, bs + kk * ldn, N) * expf(cum[m] - cum[kk]);
      if (a.bwd && kk >= m) val = dot(cs + kk * ldn, bs + m * ldn, N) * expf(cum[kk] - cum[m]);
    }
    G[r * ldg + kk] = val;
  }
  const int k_lo = a.bwd ? m0 : 0;
  const int k_hi = a.bwd ? L : min(L, m0 + kTile);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float acc[4][4] = {};
  for (int k0 = k_lo; k0 < k_hi; k0 += kSlab) {
    __syncthreads();
    for (int e = threadIdx.x; e < kSlab * kTile; e += kBlock) {
      const int t = k0 + e / kTile;
      const int col = col0 + e % kTile;
      const long long i = (r0 + static_cast<long long>(t) * d.H) * d.chd + col;
      xs[e] = (t < L && col < d.chd) ? ld<T>(a.src, i) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSlab; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = G[(ty + 16 * i) * ldg + k0 + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = xs[kk * kTile + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= L) continue;
    const float w = a.bwd ? expf(cum[L - 1] - cum[m]) : expf(cum[m]);
    const float* v = (a.bwd ? bs : cs) + m * ldn;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = tx + 16 * j;
      if (col0 + col >= d.chd) continue;
      const float val = acc[i][j] + w * dot(v, hs + col * ldn, N);
      const long long o = (r0 + static_cast<long long>(m) * d.H) * d.chd + col0 + col;
      static_cast<T*>(a.out)[o] = rt::from_float<T>(val);
    }
  }
}

// Launch kernel<<<grid, kBlock, smem, stream>>>(args...), raising the kernel's
// dynamic shared-memory limit first where it needs more than the default 48 KB.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream, const Args&... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, kBlock, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------- tensor-core route (bf16, L = 128)
// The "wgmma" route of the wrappers (kernels/ssd_scan.py, route()): bf16 b,
// x and c, chunks of 128, N a multiple of 16 up to 64, chd a multiple of 8
// up to 448, 16-byte aligned pointers.  Blocks of two warpgroups, each
// owning 64 of a chunk's 128 rows.  Tiles of x or dy come by TMA straight
// from the (B, S, H, chd) layout, 4-D maps (chd, H, S, B) with boxes of 64
// columns by 128 steps (128-byte swizzle: bf16 rows of 64); tiles of b and c
// the same way in boxes of 16 columns (32-byte swizzle).  Operands that are
// scaled or transposed first (w o b, b^T, the bf16 state) are written by
// threads in the layout TMA would write.  Every product is a wgmma with fp32
// accumulators; what is rounded to bf16 before a product is what
// ref.ssd_scan_ref / ssd_scan_bwd_ref round with bf16_products.
namespace tc {

constexpr int kL = 128;                 // chunk length of the route
constexpr int kBox = kL * 64 * 2;       // 128 steps x 64 columns of bf16: 16 KB
constexpr int kNBox = kL * 16 * 2;      // 128 steps x 16 columns of b or c: 4 KB
constexpr int kMaxBoxes = 7;            // chd <= 448
constexpr int kStateBoxes = 4;          // column boxes a chunk_state block takes

__device__ __forceinline__ float bf(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}

// Element (row, k) of a K-major tile of `rows` rows whose k runs over boxes
// of 64 (128-byte swizzle), the boxes rows * 128 bytes apart.
__device__ __forceinline__ int kmajor_offset(int rows, int row, int k) {
  return (k >> 6) * rows * 128 + hop::sw128_offset(row, k & 63);
}

__device__ __forceinline__ void store_bf16(uint8_t* tile, int off, float v) {
  *reinterpret_cast<__nv_bfloat16*>(tile + off) = __float2bfloat16(v);
}

// Rows row_a (entries 4 j, 4 j + 1) and row_a + 8 (4 j + 2, 4 j + 3) of a
// 64 x 8 kJ accumulator; columns 8 j + 2 (lane % 4) and the next.
__device__ __forceinline__ int acc_row(int row_a, int e) { return row_a + 8 * (e >> 1); }
__device__ __forceinline__ int acc_col(int j, int lane, int e) {
  return 8 * j + 2 * (lane % 4) + (e & 1);
}

// ------------------------------------------------------------- chunk_state
struct StateArgs {
  const float* lf;          // forward: (B, S, H), summed into cum here; backward: null
  float* cum;               // (BH, S): written (forward) or read (backward)
  const __nv_bfloat16* v;   // (B, S, H, N): b (forward) or c (backward)
  float* out;               // (BH, nc, chd, N): each chunk's own state
  Dims d;
};

inline size_t state_smem(const Dims& d) {
  return 1024 + kStateBoxes * kBox + static_cast<size_t>(d.N) * kL * 2 + kL * 4 + 8;
}

// grid (BH nc, ceil(boxes / 4)): out(col, n) = sum_t src_t[col] w_t v_t[n],
// w_t = exp(cum_L - cum_t) forward, exp(cum_t) backward; the product is
// src^T (w o v) with src^T read MN-major from the TMA tile and w o v written
// K-major by the threads (rounded to bf16).
template <int kN16>
__device__ __forceinline__ void chunk_state(const CUtensorMap* tsrc, const StateArgs& a) {
  constexpr int N = 16 * kN16;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hop::align_1024(smem_raw);
  uint8_t* xs = smem;                                  // kStateBoxes boxes of src
  uint8_t* vt = xs + kStateBoxes * kBox;               // (w o v)^T: N rows, K = t
  float* cum = reinterpret_cast<float*>(vt + N * kL * 2);
  uint64_t* bar = reinterpret_cast<uint64_t*>(cum + kL);
  const Dims& d = a.d;
  const long long z = blockIdx.x;
  const long long bh = z / d.nc;
  const int k = static_cast<int>(z % d.nc);
  const int s0 = k * kL;
  const long long r0 = row0(d, bh, s0);
  const int boxes = (d.chd + 63) / 64;
  const int box0 = blockIdx.y * kStateBoxes;
  const int nb = min(kStateBoxes, boxes - box0);
  const int tid = threadIdx.x;
  if (tid == 0) {
    hop::mbar_init(bar, 1);
    hop::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    hop::mbar_expect_tx(bar, nb * kBox);
    for (int i = 0; i < nb; ++i)
      hop::tma_load_4d(xs + i * kBox, tsrc, bar, 64 * (box0 + i), static_cast<int>(bh % d.H),
                       s0, static_cast<int>(bh / d.H));
  }
  float* gcum = a.cum + bh * d.S + s0;
  if (a.lf) {  // every block of the chunk sums lf in the same order
    if (tid < kL) cum[tid] = a.lf[r0 + static_cast<long long>(tid) * d.H];
    __syncthreads();
    if (tid == 0)
      for (int t = 1; t < kL; ++t) cum[t] += cum[t - 1];
    __syncthreads();
    if (blockIdx.y == 0 && tid < kL) gcum[tid] = cum[tid];
  } else {
    if (tid < kL) cum[tid] = gcum[tid];
    __syncthreads();
  }
  for (int e = tid; e < kL * N; e += kBlock) {
    const int t = e / N;
    const int n = e % N;
    const float w = a.lf ? expf(cum[kL - 1] - cum[t]) : expf(cum[t]);
    const long long i = (r0 + static_cast<long long>(t) * d.H) * N + n;
    store_bf16(vt, kmajor_offset(N, n, t), w * bf(a.v, i));
  }
  hop::fence_proxy_async();
  __syncthreads();
  hop::mbar_wait(bar, 0);
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  for (int i = wg; i < nb; i += 2) {
    float acc[kN16][8];
#pragma unroll
    for (int g = 0; g < kN16; ++g)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
#pragma unroll
    for (int g = 0; g < kN16; ++g) hop::fence_regs(acc[g]);
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kL / 16; ++kk) {
      const uint64_t da = hop::desc_sw128(xs + i * kBox + kk * 2048, kL * 128, 1024);
#pragma unroll
      for (int g = 0; g < kN16; ++g) {
        const uint64_t db =
            hop::desc_sw128(vt + (kk / 4) * N * 128 + g * 2048 + (kk % 4) * 32, 16, 1024);
        hop::wgmma_ss_n16<1, 0>(acc[g], da, db, 1);
      }
    }
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
#pragma unroll
    for (int g = 0; g < kN16; ++g) hop::fence_regs(acc[g]);
    const int row_a = 16 * warp + lane / 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = 64 * (box0 + i) + row_a + 8 * h;
      if (col >= d.chd) continue;
      float* o = a.out + (z * d.chd + col) * N;
#pragma unroll
      for (int g = 0; g < kN16; ++g)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          *reinterpret_cast<float2*>(o + 16 * g + acc_col(j, lane, 0)) =
              make_float2(acc[g][4 * j + 2 * h], acc[g][4 * j + 2 * h + 1]);
    }
  }
}

// --------------------------------------------------------------- chunk_out
struct OutArgs {
  const float* cum;          // (BH, S)
  const float* states;       // (BH, nc, chd, N): h at each chunk's start, or dH at its end
  __nv_bfloat16* out;        // (B, S, H, chd): y or dx
  Dims d;
};

inline size_t out_smem(const Dims& d) {
  return 1024 + 2 * kBox + 3 * static_cast<size_t>(d.N / 16) * kNBox + kL * 4 + 8;
}

// grid (BH nc, ceil(chd / 128)): a 128 x 128 tile of y (forward) or dx
// (backward) for rows r of the chunk and 128 columns:
//   forward  y_r  = sum_{j<=r} G(r, j) x_j  + exp(cum_r) H c_r,
//            G(r, j) = (c_r . b_j) exp(cum_r - cum_j);
//   backward dx_r = sum_{j>=r} G(r, j) dy_j + exp(cum_L - cum_r) dH b_r,
//            G(r, j) = (b_r . c_j) exp(cum_j - cum_r).
// tp: the tile whose rows are the output's (c forward, b backward); tq: the
// other; tsrc: x or dy.  The Gram P Q^T and the state term P St^T (St the
// state's 128 columns rounded to bf16, K-major over N) are wgmma from shared
// memory; G is masked and decayed in registers, rounded to bf16 and becomes
// the register A operand of G src, src read through transpose-B.  Only the
// 16-step slabs of src that the triangle reaches are multiplied.
template <int kN16, bool kBwd>
__device__ __forceinline__ void chunk_out(const CUtensorMap* tsrc, const CUtensorMap* tp,
                                          const CUtensorMap* tq, const OutArgs& a) {
  constexpr int N = 16 * kN16;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hop::align_1024(smem_raw);
  uint8_t* src = smem;                  // 2 boxes: 128 steps x 128 columns
  uint8_t* ps = src + 2 * kBox;         // kN16 boxes of 16 columns
  uint8_t* qs = ps + kN16 * kNBox;
  uint8_t* st = qs + kN16 * kNBox;      // 128 columns of the state, kN16 boxes of 16 of N
  float* cum = reinterpret_cast<float*>(st + kN16 * kNBox);
  uint64_t* bar = reinterpret_cast<uint64_t*>(cum + kL);
  const Dims& d = a.d;
  const long long z = blockIdx.x;
  const long long bh = z / d.nc;
  const int s0 = static_cast<int>(z % d.nc) * kL;
  const int col0 = blockIdx.y * 128;
  const int hh = static_cast<int>(bh % d.H);
  const int bb = static_cast<int>(bh / d.H);
  const int nb = min(2, (d.chd - col0 + 63) / 64);
  const int tid = threadIdx.x;
  if (tid == 0) {
    hop::mbar_init(bar, 1);
    hop::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    hop::mbar_expect_tx(bar, nb * kBox + 2 * kN16 * kNBox);
    for (int i = 0; i < nb; ++i)
      hop::tma_load_4d(src + i * kBox, tsrc, bar, col0 + 64 * i, hh, s0, bb);
    for (int g = 0; g < kN16; ++g) {
      hop::tma_load_4d(ps + g * kNBox, tp, bar, 16 * g, hh, s0, bb);
      hop::tma_load_4d(qs + g * kNBox, tq, bar, 16 * g, hh, s0, bb);
    }
  }
  if (tid < kL) cum[tid] = a.cum[bh * d.S + s0 + tid];
  for (int e = tid; e < 128 * N; e += kBlock) {
    const int r = e / N;
    const int n = e % N;
    const int col = col0 + r;
    const float v = col < d.chd ? a.states[(z * d.chd + col) * N + n] : 0.f;
    store_bf16(st + (n / 16) * kNBox, hop::sw32_offset(r, n % 16), v);
  }
  hop::fence_proxy_async();
  __syncthreads();
  hop::mbar_wait(bar, 0);

  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int row_a = 64 * wg + 16 * warp + lane / 4;

  // the Gram P Q^T of the warpgroup's 64 rows
  uint32_t pa[8][4];
  {
    float gm[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) gm[i] = 0.f;
    hop::fence_regs(gm);
    hop::wgmma_fence();
#pragma unroll
    for (int g = 0; g < kN16; ++g)
      hop::wgmma_ss_n128<0>(gm, hop::desc_sw32(ps + g * kNBox + wg * 64 * 32),
                            hop::desc_sw32(qs + g * kNBox), 1);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(gm);
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = acc_row(row_a, e);
        const int c = acc_col(j, lane, e);
        const bool ok = kBwd ? c >= r : c <= r;
        // the exponent is formed for the visible triangle only: it is <= 0 there
        gm[4 * j + e] = ok ? gm[4 * j + e] * expf(kBwd ? cum[c] - cum[r] : cum[r] - cum[c]) : 0.f;
      }
    hop::pack_a<128>(pa, gm);
  }

  // the state term P St^T, scaled by its row's decay
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  hop::fence_regs(acc);
  hop::wgmma_fence();
#pragma unroll
  for (int g = 0; g < kN16; ++g)
    hop::wgmma_ss_n128<0>(acc, hop::desc_sw32(ps + g * kNBox + wg * 64 * 32),
                          hop::desc_sw32(st + g * kNBox), 1);
  hop::wgmma_commit();
  hop::wgmma_wait<0>();
  hop::fence_regs(acc);
  float w[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row_a + 8 * h;
    w[h] = kBwd ? expf(cum[kL - 1] - cum[r]) : expf(cum[r]);
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] *= w[(i >> 1) & 1];

  // + G src over the slabs of 16 steps the triangle reaches
  const int kk_lo = kBwd ? 4 * wg : 0;
  const int kk_hi = kBwd ? 8 : 4 * (wg + 1);
  hop::fence_regs(acc);
  hop::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    if (kk >= kk_lo && kk < kk_hi)
      hop::wgmma_rs_n128(acc, pa[kk], hop::desc_sw128(src + kk * 2048, kL * 128, 1024), 1);
  hop::wgmma_commit();
  hop::wgmma_wait<0>();
  hop::fence_regs(acc);

  const long long r0 = row0(d, bh, s0);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row_a + 8 * h;
    __nv_bfloat16* o = a.out + (r0 + static_cast<long long>(r) * d.H) * d.chd + col0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = acc_col(j, lane, 0);
      if (col0 + c < d.chd)
        *reinterpret_cast<uint32_t*>(o + c) =
            hop::pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

}  // namespace tc

}  // namespace ssd
