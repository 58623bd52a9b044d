// SSD (Mamba-2) chunked scan backward: (dlf, db, dx, dc) from dy, fp32 inside.
//
// The Pallas ssd_scan kernel is forward only; the JAX package's training
// path differentiates src/repro/models/hymba.py ssd_scan with XLA.  This is
// the explicit backward of the port's forward (ssd_scan.cu), the arithmetic
// of ref.ssd_scan_bwd_ref.  Per chunk, with G(t, s) = (c_t . b_s)
// exp(cum_t - cum_s) for s <= t, w_s = exp(cum_L - cum_s), h the state at the
// chunk's start and dH the gradient of the state at its end:
//   dx_s   = sum_{t>=s} G(t, s) dy_t + w_s dH b_s
//   A(t,s) = exp(cum_t - cum_s) (dy_t . x_s),  s <= t
//   db_s   = sum_{t>=s} A(t, s) c_t + w_s dH^T x_s
//   dc_t   = sum_{s<=t} A(t, s) b_s + exp(cum_t) h^T dy_t
//   dcum_t = c_t . dc_t - b_t . db_t, and at t = L - 1 also
//            sum_s b_s . (w_s dH^T x_s) + exp(cum_L) sum(dH * h)
//   dlf    = the reverse cumulative sum of dcum within the chunk,
// and, over the chunks in reverse, dH_{k-1} = exp(cum_L) dH_k + sum_t
// exp(cum_t) dy_t c_t^T with dH = 0 after the last chunk.  Four launches:
//   1. ssd_bwd_state_kernel: each chunk's sum_t exp(cum_t) dy_t c_t^T;
//   2. ssd_bwd_scan_kernel: the reverse walk, leaving dH of each chunk's end;
//   3. ssd_bwd_dx_kernel: 64 x 64 tiles of dx (chunk_out of ssd.cuh, transposed);
//   4. ssd_bwd_dbc_kernel: one block per chunk: A over the whole chd, then
//      db, dc and dlf with every sum in the block, in a fixed order.
// No atomics: a run gives the same bits every time.  What bounds it on the
// H100: bytes (lf, b, x, c and dy read, dlf, db, dx and dc written once: 88
// MB a call at hymba-1.5b's training shape, 0.026 ms at 3.35 TB/s, against
// 5.4 GFLOP of products, twice the forward's).  fp32 FMAs on the CUDA cores.
#include "ssd.cuh"

namespace {

constexpr int kThreads = ssd::kBlock;
constexpr int kRows = ssd::kMaxL / 16;                      // rows and columns of A a thread holds
constexpr int kPer = ssd::kMaxL * ssd::kMaxN / ssd::kBlock;  // (t, n) outputs a thread holds

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_state_kernel(const ssd::StateArgs a) {
  ssd::chunk_state<T>(a);
}

__global__ void __launch_bounds__(kThreads) ssd_bwd_scan_kernel(const ssd::ScanArgs a) {
  ssd::state_scan(a);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_dx_kernel(const ssd::OutArgs a) {
  ssd::chunk_out<T>(a);
}

struct DbcArgs {
  const void* x;         // (B, S, H, chd)
  const void* dy;        // (B, S, H, chd)
  const void* b;         // (B, S, H, N)
  const void* c;         // (B, S, H, N)
  const float* cum;      // (BH, S)
  const float* states;   // (BH, nc, chd, N): h at each chunk's start
  const float* dhend;    // (BH, nc, chd, N): dH at each chunk's end
  void* db;              // (B, S, H, N)
  void* dc;              // (B, S, H, N)
  float* dlf;            // (B, S, H)
  ssd::Dims d;
};

size_t dbc_smem(const ssd::Dims& d) {
  const size_t L = d.L;
  const size_t N = d.N;
  const size_t ldm = L + 1;
  return sizeof(float) * (2 * L + 4 * L * N + L * ldm + 2 * ssd::kSlab * ldm +
                          2 * ssd::kSlab * N + ssd::kWarps);
}

// grid (BH * nc): one block per chunk.
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_dbc_kernel(const DbcArgs a) {
  extern __shared__ float sm[];
  const ssd::Dims& d = a.d;
  const int L = d.L;
  const int N = d.N;
  const int ldm = L + 1;
  float* cum = sm;                       // [L]
  float* dcum = cum + L;                 // [L]
  float* bs = dcum + L;                  // [L][N]
  float* cs = bs + L * N;                // [L][N]
  float* dcs = cs + L * N;               // [L][N]: dc
  float* dbs = dcs + L * N;              // [L][N]: db
  float* A = dbs + L * N;                // [L][ldm]
  float* dys = A + L * ldm;              // [kSlab][ldm]: dy columns, row t at [kk][t]
  float* xs = dys + ssd::kSlab * ldm;    // [kSlab][ldm]
  float* hs = xs + ssd::kSlab * ldm;     // [kSlab][N]
  float* dhs = hs + ssd::kSlab * N;      // [kSlab][N]
  float* red = dhs + ssd::kSlab * N;     // [kWarps]
  const long long z = blockIdx.x;
  const long long bh = z / d.nc;
  const long long s0 = (z % d.nc) * L;
  const long long r0 = ssd::row0(d, bh, s0);
  auto at = [&](int t) { return r0 + static_cast<long long>(t) * d.H; };  // row t's offset
  for (int t = threadIdx.x; t < L; t += kThreads) cum[t] = a.cum[bh * d.S + s0 + t];
  for (int e = threadIdx.x; e < L * N; e += kThreads) {
    const long long i = at(e / N) * N + e % N;
    bs[e] = ssd::ld<T>(a.b, i);
    cs[e] = ssd::ld<T>(a.c, i);
  }
  // Stage columns [col0, col0 + kSlab) of dy and x for all L rows.
  auto stage = [&](int col0) {
    for (int e = threadIdx.x; e < L * ssd::kSlab; e += kThreads) {
      const int t = e / ssd::kSlab;
      const int kk = e % ssd::kSlab;
      const int col = col0 + kk;
      const long long i = at(t) * d.chd + col;
      dys[kk * ldm + t] = col < d.chd ? ssd::ld<T>(a.dy, i) : 0.f;
      xs[kk * ldm + t] = col < d.chd ? ssd::ld<T>(a.x, i) : 0.f;
    }
  };

  // 1. A(t, s) = exp(cum_t - cum_s) (dy_t . x_s) for s <= t, over the whole chd.
  {
    const int tx = threadIdx.x % 16;
    const int ty = threadIdx.x / 16;
    float acc[kRows][kRows] = {};
    for (int col0 = 0; col0 < d.chd; col0 += ssd::kSlab) {
      __syncthreads();
      stage(col0);
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < ssd::kSlab; ++kk) {
        float av[kRows], bv[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) av[i] = dys[kk * ldm + min(ty + 16 * i, L - 1)];
#pragma unroll
        for (int j = 0; j < kRows; ++j) bv[j] = xs[kk * ldm + min(tx + 16 * j, L - 1)];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kRows; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int t = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int s = tx + 16 * j;
        if (t < L && s < L) A[t * ldm + s] = s <= t ? acc[i][j] * expf(cum[t] - cum[s]) : 0.f;
      }
    }
  }

  // 2. h^T dy_t and dH^T x_t (chd contractions) for every (t, n), and sum(dH * h).
  float hdy[kPer] = {};
  float dhx[kPer] = {};
  float dd = 0.f;
  const long long st = z * d.chd * N;
  for (int col0 = 0; col0 < d.chd; col0 += ssd::kSlab) {
    __syncthreads();
    stage(col0);
    for (int e = threadIdx.x; e < ssd::kSlab * N; e += kThreads) {
      const int col = col0 + e / N;
      hs[e] = col < d.chd ? a.states[st + static_cast<long long>(col) * N + e % N] : 0.f;
      dhs[e] = col < d.chd ? a.dhend[st + static_cast<long long>(col) * N + e % N] : 0.f;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < ssd::kSlab * N; e += kThreads) dd = fmaf(hs[e], dhs[e], dd);
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int o = threadIdx.x + q * kThreads;
      if (o < L * N) {
        const int t = o / N;
        const int n = o % N;
#pragma unroll 4
        for (int kk = 0; kk < ssd::kSlab; ++kk) {
          hdy[q] = fmaf(dys[kk * ldm + t], hs[kk * N + n], hdy[q]);
          dhx[q] = fmaf(xs[kk * ldm + t], dhs[kk * N + n], dhx[q]);
        }
      }
    }
  }
  const float ddecay = rt::block_sum(dd, red);

  // 3. db and dc; the state term's share of dcum at the chunk's end.
  float wsum = 0.f;
  const float c_last = cum[L - 1];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int o = threadIdx.x + q * kThreads;
    if (o < L * N) {
      const int t = o / N;
      const int n = o % N;
      float dci = 0.f;
      for (int s = 0; s <= t; ++s) dci = fmaf(A[t * ldm + s], bs[s * N + n], dci);
      float dbi = 0.f;
      for (int u = t; u < L; ++u) dbi = fmaf(A[u * ldm + t], cs[u * N + n], dbi);
      const float dbst = expf(c_last - cum[t]) * dhx[q];
      const float dcv = dci + expf(cum[t]) * hdy[q];
      const float dbv = dbi + dbst;
      dcs[o] = dcv;
      dbs[o] = dbv;
      wsum = fmaf(bs[o], dbst, wsum);
      const long long i = at(t) * N + n;
      static_cast<T*>(a.dc)[i] = rt::from_float<T>(dcv);
      static_cast<T*>(a.db)[i] = rt::from_float<T>(dbv);
    }
  }
  const float w_total = rt::block_sum(wsum, red);  // its barriers publish dcs and dbs

  // 4. dcum, then dlf as its reverse cumulative sum within the chunk.
  for (int t = threadIdx.x; t < L; t += kThreads) {
    float v = 0.f;
    for (int n = 0; n < N; ++n) {
      v = fmaf(cs[t * N + n], dcs[t * N + n], v);
      v = fmaf(-bs[t * N + n], dbs[t * N + n], v);
    }
    if (t == L - 1) v += w_total + expf(c_last) * ddecay;
    dcum[t] = v;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float run = 0.f;
    for (int t = L - 1; t >= 0; --t) {
      run += dcum[t];
      a.dlf[at(t)] = run;
    }
  }
}

template <typename T>
int backward(const void* b, const void* x, const void* c, const void* dy, const float* states,
             const float* cum, float* dlf, void* db, void* dx, void* dc, float* dhend,
             const ssd::Dims& d, cudaStream_t stream) {
  const long long Z = static_cast<long long>(d.B) * d.H * d.nc;
  const int BH = d.B * d.H;
  const unsigned col_tiles = (d.chd + ssd::kTile - 1) / ssd::kTile;

  const ssd::StateArgs sa{dy, c, cum, dhend, d, 1};
  int rc = ssd::launch(ssd_bwd_state_kernel<T>, dim3(col_tiles, static_cast<unsigned>(Z)),
                       ssd::state_smem(d), stream, sa);
  if (rc) return rc;

  const ssd::ScanArgs scan{dhend, cum, nullptr, d, 1};
  const long long per = static_cast<long long>(d.chd) * d.N;
  rc = ssd::launch(ssd_bwd_scan_kernel,
                   dim3(static_cast<unsigned>((per + ssd::kBlock - 1) / ssd::kBlock), BH), 0,
                   stream, scan);
  if (rc) return rc;

  const ssd::OutArgs oa{dy, b, c, cum, dhend, dx, d, 1};
  const unsigned row_tiles = (d.L + ssd::kTile - 1) / ssd::kTile;
  rc = ssd::launch(ssd_bwd_dx_kernel<T>, dim3(col_tiles, row_tiles, static_cast<unsigned>(Z)),
                   ssd::out_smem(d), stream, oa);
  if (rc) return rc;

  const DbcArgs ga{x, dy, b, c, cum, states, dhend, db, dc, dlf, d};
  return ssd::launch(ssd_bwd_dbc_kernel<T>, dim3(static_cast<unsigned>(Z)), dbc_smem(d), stream,
                     ga);
}

}  // namespace

// b, c, db, dc: (B, S, H, N); x, dy, dx: (B, S, H, chd), storage type `dtype`;
// states (B, H, nc, chd, N) and cum (B, H, S) as the forward wrote them; dlf
// (B, S, H) fp32; dhend (B, H, nc, chd, N) fp32 scratch.  All contiguous, S a
// multiple of L <= 128, N <= 64.  Returns cudaGetLastError() of the first
// launch that failed, else 0.
extern "C" int rt_ssd_scan_bwd(const void* b, const void* x, const void* c, const void* dy,
                               const void* states, const void* cum, void* dlf, void* db, void* dx,
                               void* dc, void* dhend, int B, int S, int H, int N, int chd, int L,
                               int dtype, void* stream) {
  if (L < 1 || L > ssd::kMaxL || N < 1 || N > ssd::kMaxN || S % L)
    return static_cast<int>(cudaErrorInvalidValue);
  const ssd::Dims d{B, S, H, N, chd, L, S / L};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* st = static_cast<const float*>(states);
  const float* cm = static_cast<const float*>(cum);
  float* dl = static_cast<float*>(dlf);
  float* dh = static_cast<float*>(dhend);
  if (dtype == rt::kFloat32)
    return backward<float>(b, x, c, dy, st, cm, dl, db, dx, dc, dh, d, s);
  if (dtype == rt::kBFloat16)
    return backward<__nv_bfloat16>(b, x, c, dy, st, cm, dl, db, dx, dc, dh, d, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
