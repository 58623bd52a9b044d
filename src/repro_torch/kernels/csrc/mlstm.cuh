// Building blocks of the chunked mLSTM kernels (mlstm_scan.cu, mlstm_scan_bwd.cu).
//
// Both passes are written as a few products over strided views plus small
// elementwise and per-row kernels.  Two device functions carry the products:
//
//   gemm_tile: one 64 x 64 tile of out[z] = row_scale[z] * alpha * A[z] B[z]
//              (+ bias[z]) for every batch entry z = (b * H + h) * nc + chunk,
//              fp32 sums over 16-deep slabs staged in shared memory, 256
//              threads of 4 x 4 outputs each (rows ty + 16 i, columns tx + 16 j,
//              so the shared-memory reads are broadcasts or consecutive);
//   scan_tile: one 64 x 64 tile of the carried chunk state X (Dm x N) of one
//              (b, h), walked over the chunks in order (or in reverse):
//              store X, then X = decay X + (a_row * A)^T B over the chunk's L
//              rows.  The forward carries C and n, the backward dC and dn.
//
// Views are (rows, columns) per batch entry: element (r, c) of entry z sits at
// p[z * bs + r * rs + c * cs], so a transpose is a swap of strides.  Loads
// walk the view's unit-stride axis across neighbouring threads.  Every sum is
// taken in a fixed order, so results are the same from run to run.
#pragma once

#include <math.h>

#include "common.cuh"

namespace mlstm {

constexpr int kTile = 64;                  // output rows and columns per block
constexpr int kSlab = 16;                  // reduction depth per shared-memory stage
constexpr int kBlock = 256;                // threads per block: 16 x 16, 4 x 4 outputs each
constexpr int kWarps = kBlock / 32;
constexpr int kLd = kTile + 4;             // padded shared-memory row

struct Mat {
  const void* p;
  long long bs, rs, cs;
};

template <typename T>
__device__ __forceinline__ float load(const Mat& a, long long z, long long r, long long c) {
  return rt::to_float(static_cast<const T*>(a.p)[z * a.bs + r * a.rs + c * a.cs]);
}

// Sum of v over the block, the same order every run; every thread gets it.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  v = rt::warp_sum(v);
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < static_cast<int>(blockDim.x) / 32; ++w) s += red[w];
  return s;
}

// out[z](m, n) = row_scale[z * rsc_bs + m] * alpha * sum_k A(m, k) B(k, n) + bias
struct Gemm {
  Mat a, b;
  void* out;
  long long o_bs, o_rs;     // out's strides (columns are unit-stride)
  const float* bias;        // nullable; fp32 with out's strides (may be out itself)
  const float* row_scale;   // nullable
  long long rsc_bs;
  float alpha;
  int M, N, K;
  int kmode;  // 0: every k; 1: A(m, k) = 0 for k > m; 2: A(m, k) = 0 for k < m
};

template <typename TA, typename TB>
__device__ __forceinline__ void stage(float (*As)[kLd], float (*Bs)[kLd], const Mat& a,
                                      const Mat& b, long long z, int m0, int n0, int k0, int M,
                                      int N, int K) {
  const bool a_k_fast = a.cs == 1;
  const bool b_k_fast = b.rs == 1 && b.cs != 1;
  for (int e = threadIdx.x; e < kTile * kSlab; e += kBlock) {
    const int m = a_k_fast ? e / kSlab : e % kTile;
    const int k = a_k_fast ? e % kSlab : e / kTile;
    As[k][m] = (m0 + m < M && k0 + k < K) ? load<TA>(a, z, m0 + m, k0 + k) : 0.f;
  }
  for (int e = threadIdx.x; e < kTile * kSlab; e += kBlock) {
    const int n = b_k_fast ? e / kSlab : e % kTile;
    const int k = b_k_fast ? e % kSlab : e / kTile;
    Bs[k][n] = (n0 + n < N && k0 + k < K) ? load<TB>(b, z, k0 + k, n0 + n) : 0.f;
  }
}

__device__ __forceinline__ void mma_slab(float (*As)[kLd], float (*Bs)[kLd], float (&acc)[4][4]) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int kk = 0; kk < kSlab; ++kk) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// grid (ceil(N / 64), ceil(M / 64), Z)
template <typename TA, typename TB, typename TO>
__device__ __forceinline__ void gemm_tile(const Gemm& g) {
  __shared__ float As[kSlab][kLd];
  __shared__ float Bs[kSlab][kLd];
  const long long z = blockIdx.z;
  const int m0 = blockIdx.y * kTile;
  const int n0 = blockIdx.x * kTile;
  int k_lo = 0;
  int k_hi = g.K;
  if (g.kmode == 1) k_hi = min(g.K, m0 + kTile);
  if (g.kmode == 2) k_lo = m0;  // a multiple of kSlab
  float acc[4][4] = {};
  for (int k0 = k_lo; k0 < k_hi; k0 += kSlab) {
    stage<TA, TB>(As, Bs, g.a, g.b, z, m0, n0, k0, g.M, g.N, g.K);
    __syncthreads();
    mma_slab(As, Bs, acc);
    __syncthreads();
  }
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= g.M) continue;
    const float rsc = g.row_scale ? g.row_scale[z * g.rsc_bs + m] : 1.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= g.N) continue;
      const long long o = z * g.o_bs + m * g.o_rs + n;
      float val = rsc * (g.alpha * acc[i][j]);
      if (g.bias) val += g.bias[o];
      static_cast<TO*>(g.out)[o] = rt::from_float<TO>(val);
    }
  }
}

// The carried state of one (b, h) over its chunks; entry z = bh * nc + c.
struct Scan {
  Mat a;                   // A (L x Dm) per entry
  float a_scale;
  const float* a_row;      // (BH * S): row l of entry z is scaled by a_row[z * L + l]
  Mat b;                   // B (L x N) per entry; b.p == nullptr reads as all ones
  const float* decay;      // (BH * nc)
  float* states;           // (BH * nc, Dm, N): X before chunk c's update
  const float* partner;    // nullable, like states: partial = sum of X * partner
  float* partial;          // partial[z * p_stride + p_offset + tile]
  int p_stride, p_offset;
  int nc, L, Dm, N, reverse;
};

// grid (ceil(Dm / 64) * ceil(N / 64), BH)
template <typename TA, typename TB>
__device__ __forceinline__ void scan_tile(const Scan& s) {
  __shared__ float As[kSlab][kLd];  // As[l][m]
  __shared__ float Bs[kSlab][kLd];  // Bs[l][n]
  __shared__ float red[kWarps];
  const int tiles_n = (s.N + kTile - 1) / kTile;
  const int tile = blockIdx.x;
  const int m0 = (tile / tiles_n) * kTile;
  const int n0 = (tile % tiles_n) * kTile;
  const long long bh = blockIdx.y;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const bool a_m_fast = s.a.cs == 1;
  const bool b_n_fast = s.b.p == nullptr || s.b.cs == 1;
  float acc[4][4] = {};
  for (int step = 0; step < s.nc; ++step) {
    const int c = s.reverse ? s.nc - 1 - step : step;
    const long long z = bh * s.nc + c;
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx + 16 * j;
        if (m < s.Dm && n < s.N) {
          const long long o = (z * s.Dm + m) * s.N + n;
          s.states[o] = acc[i][j];
          if (s.partner) dot += acc[i][j] * s.partner[o];
        }
      }
    }
    if (s.partner) {
      dot = block_sum(dot, red);
      if (threadIdx.x == 0) s.partial[z * s.p_stride + s.p_offset + tile] = dot;
    }
    const float d = s.decay[z];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= d;
    for (int l0 = 0; l0 < s.L; l0 += kSlab) {
      for (int e = threadIdx.x; e < kTile * kSlab; e += kBlock) {
        const int m = a_m_fast ? e % kTile : e / kSlab;
        const int l = a_m_fast ? e / kTile : e % kSlab;
        float val = 0.f;
        if (m0 + m < s.Dm && l0 + l < s.L) {
          val = (s.a_scale * load<TA>(s.a, z, l0 + l, m0 + m)) * s.a_row[z * s.L + l0 + l];
        }
        As[l][m] = val;
      }
      for (int e = threadIdx.x; e < kTile * kSlab; e += kBlock) {
        const int n = b_n_fast ? e % kTile : e / kSlab;
        const int l = b_n_fast ? e / kTile : e % kSlab;
        float val = 0.f;
        if (n0 + n < s.N && l0 + l < s.L) {
          val = s.b.p ? load<TB>(s.b, z, l0 + l, n0 + n) : 1.f;
        }
        Bs[l][n] = val;
      }
      __syncthreads();
      mma_slab(As, Bs, acc);
      __syncthreads();
    }
  }
}

}  // namespace mlstm

// Launch `kernel`<TA, TB, TO> for the storage codes (rt::DType) of A, B and
// out; a code outside {0, 1} returns cudaErrorInvalidValue from the caller.
#define MLSTM_DISPATCH3(kernel, ta, tb, to, grid, stream, arg)                                  \
  do {                                                                                          \
    if ((ta) > 1 || (tb) > 1 || (to) > 1) return static_cast<int>(cudaErrorInvalidValue);     \
    const int code_ = (ta) * 4 + (tb) * 2 + (to);                                               \
    using F_ = float;                                                                           \
    using H_ = __nv_bfloat16;                                                                   \
    switch (code_) {                                                                            \
      case 0: kernel<F_, F_, F_><<<grid, mlstm::kBlock, 0, stream>>>(arg); break;              \
      case 1: kernel<F_, F_, H_><<<grid, mlstm::kBlock, 0, stream>>>(arg); break;              \
      case 2: kernel<F_, H_, F_><<<grid, mlstm::kBlock, 0, stream>>>(arg); break;              \
      case 3: kernel<F_, H_, H_><<<grid, mlstm::kBlock, 0, stream>>>(arg); break;              \
      case 4: kernel<H_, F_, F_><<<grid, mlstm::kBlock, 0, stream>>>(arg); break;              \
      case 5: kernel<H_, F_, H_><<<grid, mlstm::kBlock, 0, stream>>>(arg); break;              \
      case 6: kernel<H_, H_, F_><<<grid, mlstm::kBlock, 0, stream>>>(arg); break;              \
      default: kernel<H_, H_, H_><<<grid, mlstm::kBlock, 0, stream>>>(arg); break;             \
    }                                                                                           \
  } while (0)
