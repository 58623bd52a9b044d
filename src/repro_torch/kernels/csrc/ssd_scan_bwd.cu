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
// exp(cum_t) dy_t c_t^T with dH = 0 after the last chunk.  What bounds it on
// the H100: bytes (lf, b, x, c and dy read, dlf, db, dx and dc written once:
// 88 MB a call at hymba-1.5b's training shape, 0.026 ms at 3.35 TB/s, against
// 5.4 GFLOP of products, twice the forward's).  No atomics: a run gives the
// same bits every time.  Two routes, the forward's (kernels/ssd_scan.py,
// route(), with dy among the tensors read by TMA), four launches each:
//
// Tensor cores (bf16, chunk 128):
//   1. ssd_tc_bwd_state_kernel: each chunk's sum_t dy_t (exp(cum_t) c_t)^T by
//      wgmma (tc::chunk_state);
//   2. ssd_bwd_scan_kernel: the reverse walk, leaving dH of each chunk's end;
//   3. ssd_tc_bwd_dx_kernel: the forward's out tile with b and c swapped and
//      the triangle transposed (tc::chunk_out);
//   4. ssd_tc_bwd_dbc_kernel: one block per chunk: A = dy x^T and A^T over
//      chd by wgmma, then dc = A b and db = A^T c with A rounded to bf16, and
//      dlf, every sum in the block in a fixed order (see the kernel).
//
// CUDA cores (fp32, other shapes), fp32 FMAs:
//   1. ssd_bwd_state_kernel: each chunk's sum_t exp(cum_t) dy_t c_t^T;
//   2. ssd_bwd_scan_kernel: as above;
//   3. ssd_bwd_dx_kernel: 64 x 64 tiles of dx (chunk_out of ssd.cuh, transposed);
//   4. ssd_bwd_dbc_kernel: one block per chunk: A over the whole chd, then
//      db, dc and dlf with every sum in the block, in a fixed order.
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

// ------------------------------------------------------------ tensor cores
template <int kN16>
__global__ void __launch_bounds__(kThreads)
    ssd_tc_bwd_state_kernel(const __grid_constant__ CUtensorMap tdy, const ssd::tc::StateArgs a) {
  ssd::tc::chunk_state<kN16>(&tdy, a);
}

template <int kN16>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_tc_bwd_dx_kernel(const __grid_constant__ CUtensorMap tdy,
                         const __grid_constant__ CUtensorMap tb,
                         const __grid_constant__ CUtensorMap tc, const ssd::tc::OutArgs a) {
  ssd::tc::chunk_out<kN16, true>(&tdy, &tb, &tc, a);
}

struct TcDbcArgs {
  const __nv_bfloat16* b;   // (B, S, H, N)
  const __nv_bfloat16* c;   // (B, S, H, N)
  const float* cum;         // (BH, S)
  const float* states;      // (BH, nc, chd, N): h at each chunk's start
  const float* dhend;       // (BH, nc, chd, N): dH at each chunk's end
  __nv_bfloat16* db;        // (B, S, H, N)
  __nv_bfloat16* dc;        // (B, S, H, N)
  float* dlf;               // (B, S, H)
  ssd::Dims d;
};

size_t tc_dbc_smem(const ssd::Dims& d) {
  const size_t boxes = (d.chd + 63) / 64;
  return 1024 + 4 * ssd::tc::kBox + 2 * static_cast<size_t>(d.N) * ssd::tc::kL * 2 +
         2 * boxes * d.N * 128 + 2 * ssd::tc::kL * 4 + 2 * 8;
}

// grid (BH nc): one block of two warpgroups a chunk, each owning 64 rows.
// It walks chd in boxes of 64 columns, dy and x by TMA into a two-stage ring,
// and sums in fp32 accumulators A = dy x^T (rows t) and A^T = x dy^T (rows s,
// computed as its own product: the transpose of a register tile would go
// through shared memory), h^T dy_t and dH^T x_s (h and dH rounded to bf16,
// K-major over chd, written by the threads).  Then A and A^T are masked and
// decayed in registers and rounded to bf16 as the A operands of dc = A b and
// db = A^T c (b^T and c^T K-major over the chunk, written by the threads),
// only over the 16-step slabs the triangle reaches.  dcum takes dc and db
// from the fp32 accumulators; dlf is its reverse cumulative sum, in order.
// Why one block a chunk and dx apart: A over chd = 400 is 25 slabs of 16,
// and splitting a chunk's columns over blocks would need a cross-block sum
// of A; fusing dx (ssd_tc_bwd_dx_kernel) would add its 64 accumulators to
// the 144 a thread holds here.  The accumulators keep one block (two
// warpgroups, 102 KB of shared memory at N = 16) on an SM, so hymba-1.5b's
// 272 chunks take two waves of 132 and a tail of 8.
template <int kN16>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_tc_bwd_dbc_kernel(const __grid_constant__ CUtensorMap tdy,
                          const __grid_constant__ CUtensorMap tx, const TcDbcArgs a) {
  using namespace ssd::tc;
  constexpr int N = 16 * kN16;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hop::align_1024(smem_raw);
  const ssd::Dims& d = a.d;
  const int boxes = (d.chd + 63) / 64;
  uint8_t* ring = smem;                         // stage s: dy box at 2 s kBox, x box after it
  uint8_t* bt = ring + 4 * kBox;                // b^T: N rows, K = the chunk's steps
  uint8_t* ct = bt + N * kL * 2;                // c^T
  uint8_t* ht = ct + N * kL * 2;                // h^T: N rows, K = chd, boxes of 64
  uint8_t* dht = ht + boxes * N * 128;          // dH^T
  float* cum = reinterpret_cast<float*>(dht + boxes * N * 128);
  float* dcum = cum + kL;
  uint64_t* full = reinterpret_cast<uint64_t*>(dcum + kL);
  __shared__ float red[ssd::kWarps];
  const long long z = blockIdx.x;
  const long long bh = z / d.nc;
  const int s0 = static_cast<int>(z % d.nc) * kL;
  const int hh = static_cast<int>(bh % d.H);
  const int bb = static_cast<int>(bh / d.H);
  const long long r0 = ssd::row0(d, bh, s0);
  const int tid = threadIdx.x;
  const CUtensorMap* mdy = &tdy;
  const CUtensorMap* mx = &tx;
  auto load = [=](int i) {
    uint8_t* stage = ring + (i % 2) * 2 * kBox;
    hop::mbar_expect_tx(&full[i % 2], 2 * kBox);
    hop::tma_load_4d(stage, mdy, &full[i % 2], 64 * i, hh, s0, bb);
    hop::tma_load_4d(stage + kBox, mx, &full[i % 2], 64 * i, hh, s0, bb);
  };
  if (tid == 0) {
    hop::mbar_init(&full[0], 1);
    hop::mbar_init(&full[1], 1);
    hop::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int i = 0; i < min(2, boxes); ++i) load(i);

  if (tid < kL) cum[tid] = a.cum[bh * d.S + s0 + tid];
  for (int e = tid; e < kL * N; e += kThreads) {
    const int t = e / N;
    const int n = e % N;
    const long long i = (r0 + static_cast<long long>(t) * d.H) * N + n;
    const int off = kmajor_offset(N, n, t);
    *reinterpret_cast<__nv_bfloat16*>(bt + off) = a.b[i];
    *reinterpret_cast<__nv_bfloat16*>(ct + off) = a.c[i];
  }
  float dd = 0.f;  // this thread's share of sum(dH * h), in fp32
  const long long st0 = z * d.chd * N;
  for (int e = tid; e < boxes * 64 * N; e += kThreads) {
    const int col = e / N;
    const int n = e % N;
    const float hv = col < d.chd ? a.states[st0 + static_cast<long long>(col) * N + n] : 0.f;
    const float dv = col < d.chd ? a.dhend[st0 + static_cast<long long>(col) * N + n] : 0.f;
    dd = fmaf(hv, dv, dd);
    const int off = kmajor_offset(N, n, col);
    store_bf16(ht, off, hv);
    store_bf16(dht, off, dv);
  }
  hop::fence_proxy_async();
  __syncthreads();

  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int row_a = 64 * wg + 16 * warp + lane / 4;
  float A[64], At[64], hdy[kN16][8], dhx[kN16][8];
#pragma unroll
  for (int i = 0; i < 64; ++i) A[i] = At[i] = 0.f;
#pragma unroll
  for (int g = 0; g < kN16; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) hdy[g][e] = dhx[g][e] = 0.f;

  for (int i = 0; i < boxes; ++i) {
    hop::mbar_wait(&full[i % 2], (i / 2) & 1);
    const uint8_t* dys = ring + (i % 2) * 2 * kBox;
    const uint8_t* xs = dys + kBox;
    const int slabs = min(4, (d.chd - 64 * i + 15) / 16);
    hop::fence_regs(A);
    hop::fence_regs(At);
#pragma unroll
    for (int g = 0; g < kN16; ++g) {
      hop::fence_regs(hdy[g]);
      hop::fence_regs(dhx[g]);
    }
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk >= slabs) continue;
      const uint64_t a_dy = hop::desc_sw128(dys + wg * 64 * 128 + kk * 32, 16, 1024);
      const uint64_t a_x = hop::desc_sw128(xs + wg * 64 * 128 + kk * 32, 16, 1024);
      hop::wgmma_ss_n128<0>(A, a_dy, hop::desc_sw128(xs + kk * 32, 16, 1024), 1);
      hop::wgmma_ss_n128<0>(At, a_x, hop::desc_sw128(dys + kk * 32, 16, 1024), 1);
#pragma unroll
      for (int g = 0; g < kN16; ++g) {
        const int off = i * N * 128 + g * 2048 + kk * 32;
        hop::wgmma_ss_n16<0, 0>(hdy[g], a_dy, hop::desc_sw128(ht + off, 16, 1024), 1);
        hop::wgmma_ss_n16<0, 0>(dhx[g], a_x, hop::desc_sw128(dht + off, 16, 1024), 1);
      }
    }
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(A);
    hop::fence_regs(At);
#pragma unroll
    for (int g = 0; g < kN16; ++g) {
      hop::fence_regs(hdy[g]);
      hop::fence_regs(dhx[g]);
    }
    __syncthreads();  // both warpgroups are done with this stage
    if (tid == 0 && i + 2 < boxes) load(i + 2);
  }

  // A(t, s) and A^T(s, t) for s <= t, times exp(cum_t - cum_s), as bf16 A operands
  uint32_t pa[8][4], pat[8][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = acc_row(row_a, e);
      const int c = acc_col(j, lane, e);
      A[4 * j + e] = c <= r ? A[4 * j + e] * expf(cum[r] - cum[c]) : 0.f;
      At[4 * j + e] = c >= r ? At[4 * j + e] * expf(cum[c] - cum[r]) : 0.f;
    }
  hop::pack_a<128>(pa, A);
  hop::pack_a<128>(pat, At);

  float dc[kN16][8], db[kN16][8];
#pragma unroll
  for (int g = 0; g < kN16; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) dc[g][e] = db[g][e] = 0.f;
#pragma unroll
  for (int g = 0; g < kN16; ++g) {
    hop::fence_regs(dc[g]);
    hop::fence_regs(db[g]);
  }
  hop::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const int off = (kk / 4) * N * 128 + (kk % 4) * 32;
#pragma unroll
    for (int g = 0; g < kN16; ++g) {
      if (kk < 4 * (wg + 1))  // dc_t sums s <= t
        hop::wgmma_rs_n16(dc[g], pa[kk], hop::desc_sw128(bt + off + g * 2048, 16, 1024), 1);
      if (kk >= 4 * wg)       // db_s sums t >= s
        hop::wgmma_rs_n16(db[g], pat[kk], hop::desc_sw128(ct + off + g * 2048, 16, 1024), 1);
    }
  }
  hop::wgmma_commit();
  hop::wgmma_wait<0>();
#pragma unroll
  for (int g = 0; g < kN16; ++g) {
    hop::fence_regs(dc[g]);
    hop::fence_regs(db[g]);
  }

  // dc = A b + exp(cum_t) h^T dy_t, db = A^T c + w_s dH^T x_s; dcum per row
  const float c_last = cum[kL - 1];
  float wsum = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = row_a + 8 * h;
    const float et = expf(cum[t]);
    const float ws = expf(c_last - cum[t]);
    const long long row = (r0 + static_cast<long long>(t) * d.H) * N;
    float part = 0.f;
#pragma unroll
    for (int g = 0; g < kN16; ++g)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = 16 * g + acc_col(j, lane, 0);
        const int e = 4 * j + 2 * h;
        const float dc0 = dc[g][e] + et * hdy[g][e];
        const float dc1 = dc[g][e + 1] + et * hdy[g][e + 1];
        const float st0v = ws * dhx[g][e];
        const float st1v = ws * dhx[g][e + 1];
        const float db0 = db[g][e] + st0v;
        const float db1 = db[g][e + 1] + st1v;
        const float2 bv =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.b + row + n));
        const float2 cv =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.c + row + n));
        part += cv.x * dc0 + cv.y * dc1 - bv.x * db0 - bv.y * db1;
        wsum += bv.x * st0v + bv.y * st1v;
        *reinterpret_cast<uint32_t*>(a.dc + row + n) = hop::pack_bf16(dc0, dc1);
        *reinterpret_cast<uint32_t*>(a.db + row + n) = hop::pack_bf16(db0, db1);
      }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    if (lane % 4 == 0) dcum[t] = part;
  }
  const float w_total = rt::block_sum(wsum, red);  // its barriers publish dcum
  const float ddecay = rt::block_sum(dd, red);
  if (tid == 0) {
    float run = 0.f;
    for (int t = kL - 1; t >= 0; --t) {
      run += t == kL - 1 ? dcum[t] + w_total + expf(c_last) * ddecay : dcum[t];
      a.dlf[r0 + static_cast<long long>(t) * d.H] = run;
    }
  }
}

template <int kN16>
int backward_tc(const void* b, const void* x, const void* c, const void* dy, const float* states,
                const float* cum, float* dlf, void* db, void* dx, void* dc, float* dhend,
                const ssd::Dims& d, cudaStream_t stream) {
  using ssd::tc::kL;
  CUtensorMap tdy, tx, tb, tc;
  int rc = hop::map_steps(&tdy, dy, d.B, d.S, d.H, d.chd, 64, kL);
  if (!rc) rc = hop::map_steps(&tx, x, d.B, d.S, d.H, d.chd, 64, kL);
  if (!rc) rc = hop::map_steps(&tb, b, d.B, d.S, d.H, d.N, 16, kL);
  if (!rc) rc = hop::map_steps(&tc, c, d.B, d.S, d.H, d.N, 16, kL);
  if (rc) return rc;
  const unsigned Z = static_cast<unsigned>(d.B * d.H * d.nc);
  const int boxes = (d.chd + 63) / 64;
  const auto* cb = static_cast<const __nv_bfloat16*>(c);
  const ssd::tc::StateArgs sa{nullptr, const_cast<float*>(cum), cb, dhend, d};
  rc = ssd::launch(ssd_tc_bwd_state_kernel<kN16>,
                   dim3(Z, (boxes + ssd::tc::kStateBoxes - 1) / ssd::tc::kStateBoxes),
                   ssd::tc::state_smem(d), stream, tdy, sa);
  if (rc) return rc;
  const ssd::ScanArgs scan{dhend, cum, nullptr, d, 1};
  const long long per = static_cast<long long>(d.chd) * d.N;
  rc = ssd::launch(ssd_bwd_scan_kernel,
                   dim3(static_cast<unsigned>((per + ssd::kBlock - 1) / ssd::kBlock), d.B * d.H),
                   0, stream, scan);
  if (rc) return rc;
  const ssd::tc::OutArgs oa{cum, dhend, static_cast<__nv_bfloat16*>(dx), d};
  rc = ssd::launch(ssd_tc_bwd_dx_kernel<kN16>, dim3(Z, (d.chd + 127) / 128),
                   ssd::tc::out_smem(d), stream, tdy, tb, tc, oa);
  if (rc) return rc;
  const TcDbcArgs ga{static_cast<const __nv_bfloat16*>(b), cb, cum, states, dhend,
                     static_cast<__nv_bfloat16*>(db), static_cast<__nv_bfloat16*>(dc), dlf, d};
  return ssd::launch(ssd_tc_bwd_dbc_kernel<kN16>, dim3(Z), tc_dbc_smem(d), stream, tdy, tx, ga);
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

// Tensor-core route: bf16 b, x, c and dy, L = 128, N a multiple of 16 up to
// 64, chd a multiple of 8 up to 448, 16-byte aligned pointers; the other
// arguments as rt_ssd_scan_bwd's.  Four launches: each chunk's
// sum_t exp(cum_t) dy_t c_t^T, the reverse walk, dx, then db, dc and dlf.
// Returns the first error (tensor map, attribute or launch), else 0.
extern "C" int rt_ssd_scan_bwd_tc(const void* b, const void* x, const void* c, const void* dy,
                                  const void* states, const void* cum, void* dlf, void* db,
                                  void* dx, void* dc, void* dhend, int B, int S, int H, int N,
                                  int chd, int L, void* stream) {
  if (L != ssd::tc::kL || S % L || N % 16 || N < 16 || N > ssd::kMaxN || chd % 8 ||
      chd > 64 * ssd::tc::kMaxBoxes)
    return static_cast<int>(cudaErrorInvalidValue);
  const ssd::Dims d{B, S, H, N, chd, L, S / L};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* st = static_cast<const float*>(states);
  const float* cm = static_cast<const float*>(cum);
  float* dl = static_cast<float*>(dlf);
  float* dh = static_cast<float*>(dhend);
  switch (N / 16) {
    case 1: return backward_tc<1>(b, x, c, dy, st, cm, dl, db, dx, dc, dh, d, s);
    case 2: return backward_tc<2>(b, x, c, dy, st, cm, dl, db, dx, dc, dh, d, s);
    case 3: return backward_tc<3>(b, x, c, dy, st, cm, dl, db, dx, dc, dh, d, s);
    default: return backward_tc<4>(b, x, c, dy, st, cm, dl, db, dx, dc, dh, d, s);
  }
}
