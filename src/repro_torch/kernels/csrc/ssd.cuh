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
#pragma once

#include <math.h>

#include "common.cuh"

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

// Launch kernel<<<grid, kBlock, smem, stream>>>(arg), raising the kernel's
// dynamic shared-memory limit first where it needs more than the default 48 KB.
template <typename Kernel, typename Arg>
int launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream, const Arg& arg) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, kBlock, smem, stream>>>(arg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ssd
