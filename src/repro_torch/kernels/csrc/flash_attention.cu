// Flash attention forward: blockwise online softmax in fp32, causal / sliding
// window / GQA, with the fp32 row log-sum-exp that the backward reads.
//
// Replaces the Pallas kernel _flash_kernel (src/repro/kernels/flash_attention.py).
// q: (B, Hq, Sq, hd); k, v: (B, Hkv, Skv, hd); out: (B, Hq, Sq, hd); lse: (B, Hq,
// Sq) fp32; all contiguous.  Query i sits at q_offset + i; key j is visible
// when j < Skv, j <= q_offset + i (causal) and j > q_offset + i - window
// (window > 0).  Scores are scaled after the dot; masked keys weigh exactly 0
// and a row with no visible key gives zeros and lse = -inf.
//
// The TPU kernel walks a (q block, kv block) grid whose kv axis runs in order
// on one core and carries (m, l, acc) in VMEM scratch.  Here a block owns one
// (b, query head) and a tile of query rows, and walks in a loop only the kv
// tiles that the causal / window band of its rows reaches; K/V of head
// h // G are read, so no head is repeated in memory.  Two routes, chosen by
// the wrapper (kernels/flash_attention.py, route()) from the dtype, hd and
// the pointers' alignment:
//
// Tensor cores (bf16, hd 64 or 128): flash_tc_kernel, after FlashAttention-3.
// Bound on the H100 by bytes at qwen's training shape (q, k, v, out once:
// 0.010 ms) and by the 4 hd operations of each visible pair at Hymba's
// (0.031 ms global, 0.022 window 1024).  A block of three warpgroups owns 128
// query rows: one producer warp TMA-loads Q once, then K and V tiles of 128
// keys into a two-stage mbarrier ring (K and V on barriers of their own, so
// that S = Q K^T starts before V lands).  Two consumer warpgroups of 64 rows
// run S = Q K^T by wgmma from shared memory (K is K-major as stored), the
// online softmax in fp32 registers (exp2 of scores prescaled by log2 e), and
// O += P V by wgmma with P rounded to bf16 in registers as the A operand and
// V read through transpose-B.  Only tiles that cross the diagonal, the
// window's edge or Skv apply the mask.  3-D tensor maps (hd, S, B * H) fill
// rows past Sq or Skv with zeros, so a tile never reads another head.  Blocks
// run the longest rows first.  Not yet: overlapping one warpgroup's softmax
// with the other's products (ping-pong).
//
// CUDA cores (fp32, other hd): flash_fwd_kernel, one block per (b, query
// head, 64 query rows).  Four threads share a query row: each holds a quarter
// of the row's q and acc in registers (dims part + 4 i), and a score is their
// partial dots summed by two shuffles.  K and V tiles of 64 rows are staged in
// shared memory as fp32 (dynamic: 64 KB at hd = 128).  Keys are taken in
// groups of kSub: the group's scores, one max, one rescale of acc, then p * V.
// It is bound by its own fp32 arithmetic, about 24 G pairs a second at hd 64.
#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kRows = 64;                     // query rows per block
constexpr int kParts = 4;                     // threads per query row
constexpr int kThreads = kRows * kParts;      // 256
constexpr int kTile = 64;                     // kv rows per shared-memory tile
constexpr int kSub = 16;                      // keys per online-softmax update

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// kDpt: dims per thread; the kernel takes any hd <= kParts * kDpt.
template <typename T, int kDpt>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse,
                     int Hq, int Hkv, int Sq, int Skv, int hd, int causal, int window,
                     int q_offset, float scale) {
  extern __shared__ float smem[];
  float* ks = smem;                 // [kTile][hd]
  float* vs = smem + kTile * hd;    // [kTile][hd]

  const int n_qt = (Sq + kRows - 1) / kRows;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x % n_qt);  // longest rows first
  const int bh = static_cast<int>(blockIdx.x / n_qt);             // b * Hq + h
  const int b = bh / Hq;
  const int bkv = b * Hkv + (bh % Hq) / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int row = tid / kParts;
  const int part = tid % kParts;
  const int qi = qt * kRows + row;
  const bool row_ok = qi < Sq;
  const int qp = q_offset + qi;

  float qr[kDpt];
  float acc[kDpt];
  const T* qrow = q + (static_cast<size_t>(bh) * Sq + (row_ok ? qi : 0)) * hd;
#pragma unroll
  for (int i = 0; i < kDpt; ++i) {
    const int d = part + kParts * i;
    qr[i] = (row_ok && d < hd) ? rt::to_float(qrow[d]) : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  // the kv range that some row of this block sees
  const int q_first = q_offset + qt * kRows;
  const int q_last = q_offset + min(qt * kRows + kRows, Sq) - 1;
  const int lo = window > 0 ? max(0, q_first - window + 1) : 0;
  const int hi = causal ? min(Skv, q_last + 1) : Skv;
  const T* kb = k + static_cast<size_t>(bkv) * Skv * hd;
  const T* vb = v + static_cast<size_t>(bkv) * Skv * hd;

  for (int t0 = lo; t0 < hi; t0 += kTile) {
    const int n = min(kTile, hi - t0);
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < n * hd; i += kThreads) {
      ks[i] = rt::to_float(kb[static_cast<size_t>(t0) * hd + i]);
      vs[i] = rt::to_float(vb[static_cast<size_t>(t0) * hd + i]);
    }
    __syncthreads();

    for (int j0 = 0; j0 < n; j0 += kSub) {
      float s[kSub];
      float gmax = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        const int j = j0 + jj;
        float dot = 0.f;
        if (j < n) {
          const float* kr = ks + j * hd;
#pragma unroll
          for (int i = 0; i < kDpt; ++i) {
            const int d = part + kParts * i;
            if (d < hd) dot += qr[i] * kr[d];
          }
        }
        dot = quad_sum(dot);  // every lane takes part: the loop is uniform
        const int kvp = t0 + j;
        const bool vis = row_ok && j < n && (!causal || kvp <= qp) &&
                         (window <= 0 || kvp > qp - window);
        s[jj] = vis ? dot * scale : -INFINITY;
        gmax = fmaxf(gmax, s[jj]);
      }
      if (gmax == -INFINITY) continue;  // no visible key in this group for this row
      const float m_new = fmaxf(m, gmax);
      const float corr = expf(m - m_new);  // 0 while m is still -inf
      l *= corr;
#pragma unroll
      for (int i = 0; i < kDpt; ++i) acc[i] *= corr;
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        if (s[jj] == -INFINITY) continue;
        const float p = expf(s[jj] - m_new);
        l += p;
        const float* vr = vs + (j0 + jj) * hd;
#pragma unroll
        for (int i = 0; i < kDpt; ++i) {
          const int d = part + kParts * i;
          if (d < hd) acc[i] += p * vr[d];
        }
      }
      m = m_new;
    }
  }

  if (!row_ok) return;
  T* orow = out + (static_cast<size_t>(bh) * Sq + qi) * hd;
  const float den = l == 0.f ? 1.f : l;
#pragma unroll
  for (int i = 0; i < kDpt; ++i) {
    const int d = part + kParts * i;
    if (d < hd) orow[d] = rt::from_float<T>(acc[i] / den);
  }
  if (part == 0) lse[static_cast<size_t>(bh) * Sq + qi] = l > 0.f ? m + logf(l) : -INFINITY;
}

template <typename T, int kDpt>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int B, int Hq,
           int Hkv, int Sq, int Skv, int hd, int causal, int window, int q_offset, float scale,
           cudaStream_t s) {
  const size_t smem = 2 * kTile * hd * sizeof(float);
  auto kernel = flash_fwd_kernel<T, kDpt>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((Sq + kRows - 1) / kRows) * B * Hq;
  kernel<<<grid, kThreads, smem, s>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                      static_cast<const T*>(v), static_cast<T*>(out), lse, Hq,
                                      Hkv, Sq, Skv, hd, causal, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* out, float* lse, int B, int Hq,
              int Hkv, int Sq, int Skv, int hd, int causal, int window, int q_offset,
              float scale, cudaStream_t s) {
  if (hd <= 16)
    return launch<T, 4>(q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, hd, causal, window, q_offset,
                        scale, s);
  if (hd <= 32)
    return launch<T, 8>(q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, hd, causal, window, q_offset,
                        scale, s);
  if (hd <= 64)
    return launch<T, 16>(q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, hd, causal, window, q_offset,
                         scale, s);
  if (hd <= 128)
    return launch<T, 32>(q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, hd, causal, window, q_offset,
                         scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// ------------------------------------------------------------ tensor cores
namespace {

constexpr int kTcRows = 128;    // query rows per block: two consumer warpgroups of 64
constexpr int kTcKeys = 128;    // keys per K / V tile
constexpr int kTcThreads = 384; // two consumer warpgroups, then the producer
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int kHd>
struct TcLayout {
  static constexpr int kTile = 128 * kHd * 2;  // 128 rows of Q, K or V: kHd / 64 boxes of 16 KB
  static constexpr int kQ = 0;
  static constexpr int kK = kTile;             // stage s: kK + s * kTile
  static constexpr int kV = 3 * kTile;         // stage s: kV + s * kTile
  static constexpr int kBars = 5 * kTile;      // q_full, k_full[2], v_full[2], empty[2]
  static constexpr int kSmem = 1024 + kBars + 7 * 8;
};

struct TcArgs {
  __nv_bfloat16* out;
  float* lse;
  int Hq, Hkv, Sq, Skv, n_bh;
  int causal, window, q_offset;
  float scale_log2;  // hd^-0.5 * log2(e)
};

__device__ __forceinline__ bool tc_visible(int key, int qp, int Skv, int causal, int window) {
  return key < Skv && (!causal || key <= qp) && (window <= 0 || key > qp - window);
}

// tq: (hd, Sq, B Hq), tk, tv: (hd, Skv, B Hkv), boxes (64, 128, 1).
template <int kHd>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, TcArgs a) {
  using L = TcLayout<kHd>;
  constexpr int kBoxes = kHd / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hop::align_1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 3;
  uint64_t* empty = bars + 5;

  // longest rows first: every (b, h)'s last query tile, then the one before, ...
  const int n_qt = (a.Sq + kTcRows - 1) / kTcRows;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / a.n_bh;
  const int bh = static_cast<int>(blockIdx.x) % a.n_bh;  // b * Hq + h
  const int bkv = (bh / a.Hq) * a.Hkv + (bh % a.Hq) / (a.Hq / a.Hkv);

  // the kv range that some row of this block sees, in tiles of 128 keys from lo
  const int q_first = a.q_offset + qt * kTcRows;
  const int q_last = a.q_offset + min(qt * kTcRows + kTcRows, a.Sq) - 1;
  const int lo = a.window > 0 ? max(0, q_first - a.window + 1) : 0;
  const int hi = a.causal ? min(a.Skv, q_last + 1) : a.Skv;
  const int n_t = hi > lo ? (hi - lo + kTcKeys - 1) / kTcKeys : 0;

  if (threadIdx.x == 0) {
    hop::mbar_init(q_full, 1);
    for (int s = 0; s < 2; ++s) {
      hop::mbar_init(&k_full[s], 1);
      hop::mbar_init(&v_full[s], 1);
      hop::mbar_init(&empty[s], 8);  // lane 0 of every consumer warp
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer warpgroup: one thread starts every load
    hop::regs_release<24>();
    if (threadIdx.x != 256) return;
    hop::mbar_expect_tx(q_full, L::kTile);
    for (int b = 0; b < kBoxes; ++b)
      hop::tma_load_3d(smem + L::kQ + b * 16384, &tq, q_full, 64 * b, qt * kTcRows, bh);
    for (int i = 0; i < n_t; ++i) {
      const int s = i % 2;
      if (i >= 2) hop::mbar_wait(&empty[s], ((i / 2) & 1) ^ 1);
      const int kv0 = lo + i * kTcKeys;
      hop::mbar_expect_tx(&k_full[s], L::kTile);
      for (int b = 0; b < kBoxes; ++b)
        hop::tma_load_3d(smem + L::kK + s * L::kTile + b * 16384, &tk, &k_full[s], 64 * b, kv0,
                         bkv);
      hop::mbar_expect_tx(&v_full[s], L::kTile);
      for (int b = 0; b < kBoxes; ++b)
        hop::tma_load_3d(smem + L::kV + s * L::kTile + b * 16384, &tv, &v_full[s], 64 * b, kv0,
                         bkv);
    }
    return;
  }

  // consumer warpgroup wg: query rows qt * 128 + 64 wg .. + 63
  hop::regs_claim<240>();
  const int lane = threadIdx.x % 32;
  const int warp = (threadIdx.x % 128) / 32;
  const int row_a = qt * kTcRows + wg * 64 + warp * 16 + lane / 4;  // and row_a + 8
  const int qp_a = a.q_offset + row_a;
  const int wg_first = a.q_offset + qt * kTcRows + wg * 64;  // the warpgroup's query positions
  const int wg_last = wg_first + 63;

  float o[kHd / 2];
#pragma unroll
  for (int i = 0; i < kHd / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max, log2 units
  float l[2] = {0.f, 0.f};              // this thread's share of the running sum
  hop::mbar_wait(q_full, 0);

  for (int i = 0; i < n_t; ++i) {
    const int s = i % 2;
    const int ph = (i / 2) & 1;
    const int kv0 = lo + i * kTcKeys;
    const uint8_t* ks = smem + L::kK + s * L::kTile;
    const uint8_t* vs = smem + L::kV + s * L::kTile;

    float sc[64];  // S = Q K^T for 64 rows x 128 keys
    hop::mbar_wait(&k_full[s], ph);
    hop::fence_regs(sc);
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kHd / 16; ++kk) {
      const int off = (kk / 4) * 16384 + (kk % 4) * 32;
      const uint64_t da = hop::desc_sw128(smem + L::kQ + off + wg * 64 * 128, 16, 1024);
      const uint64_t db = hop::desc_sw128(ks + off, 16, 1024);
      hop::wgmma_ss_n128<0>(sc, da, db, kk > 0);
    }
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(sc);

    // a mask only where the tile crosses Skv, the diagonal or the window's edge
    const int kv_last = kv0 + kTcKeys - 1;
    const bool masked = kv_last >= a.Skv || (a.causal && kv_last > wg_first) ||
                        (a.window > 0 && kv0 <= wg_last - a.window);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * j + e] * a.scale_log2;
        if (masked) {
          const int key = kv0 + 8 * j + 2 * (lane % 4) + (e & 1);
          if (!tc_visible(key, qp_a + 8 * (e >> 1), a.Skv, a.causal, a.window)) x = -INFINITY;
        }
        sc[4 * j + e] = x;
      }
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = m[h];
#pragma unroll
      for (int j = 0; j < 16; ++j) mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // a row that has seen no visible key keeps m = -inf: its p are 0, nothing to rescale
      corr[h] = mx == -INFINITY ? 1.f : exp2f(m[h] - mx);
      const float base = mx == -INFINITY ? 0.f : mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(sc[4 * j + 2 * h + e] - base);
          sc[4 * j + 2 * h + e] = p;
          sum += p;
        }
      }
      l[h] = l[h] * corr[h] + sum;
      m[h] = mx;
    }
#pragma unroll
    for (int j = 0; j < kHd / 8; ++j) {
      o[4 * j] *= corr[0];
      o[4 * j + 1] *= corr[0];
      o[4 * j + 2] *= corr[1];
      o[4 * j + 3] *= corr[1];
    }
    uint32_t pa[8][4];  // P in bf16, the A operand of each 16-key step
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      pa[kk][0] = hop::pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = hop::pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = hop::pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = hop::pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }

    hop::mbar_wait(&v_full[s], ph);
    hop::fence_regs(o);
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint64_t db = hop::desc_sw128(vs + kk * 2048, 16384, 1024);
      if constexpr (kHd == 64)
        hop::wgmma_rs_n64(o, pa[kk], db, 1);
      else
        hop::wgmma_rs_n128(o, pa[kk], db, 1);
    }
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(o);
    if (lane == 0) hop::mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  const size_t row0 = static_cast<size_t>(bh) * a.Sq;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_a + 8 * h;
    if (row >= a.Sq) continue;
    const float inv = l[h] == 0.f ? 1.f : 1.f / l[h];
    uint32_t* orow = reinterpret_cast<uint32_t*>(a.out + (row0 + row) * kHd);
#pragma unroll
    for (int j = 0; j < kHd / 8; ++j)
      orow[4 * j + lane % 4] = hop::pack_bf16(o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
    if (lane % 4 == 0)
      a.lse[row0 + row] = l[h] > 0.f ? (m[h] + log2f(l[h])) * kLn2 : -INFINITY;
  }
}

// (B H, S, hd) bf16 as a 3-D TMA map (hd, S, B H) with box (64, 128, 1).
int map_3d(CUtensorMap* m, const void* p, int bh, int S, int hd) {
  const uint64_t dims[3] = {static_cast<uint64_t>(hd), static_cast<uint64_t>(S),
                            static_cast<uint64_t>(bh)};
  const uint64_t strides[2] = {static_cast<uint64_t>(hd) * 2, static_cast<uint64_t>(S) * hd * 2};
  const uint32_t box[3] = {64, 128, 1};
  return hop::make_map(m, p, 3, dims, strides, box);
}

template <int kHd>
int launch_tc(const void* q, const void* k, const void* v, void* out, float* lse, int B, int Hq,
              int Hkv, int Sq, int Skv, int causal, int window, int q_offset, float scale,
              cudaStream_t s) {
  CUtensorMap tq, tk, tv;
  int err = map_3d(&tq, q, B * Hq, Sq, kHd);
  if (!err) err = map_3d(&tk, k, B * Hkv, Skv, kHd);
  if (!err) err = map_3d(&tv, v, B * Hkv, Skv, kHd);
  if (err) return err;
  auto kernel = flash_tc_kernel<kHd>;
  const int smem = TcLayout<kHd>::kSmem;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const TcArgs a{static_cast<__nv_bfloat16*>(out), lse, Hq, Hkv, Sq, Skv, B * Hq, causal,
                 window, q_offset, scale * kLog2e};
  const unsigned grid = static_cast<unsigned>((Sq + kTcRows - 1) / kTcRows) * B * Hq;
  kernel<<<grid, kTcThreads, smem, s>>>(tq, tk, tv, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch (or the attribute call's error).
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v, void* out,
                                  void* lse, int B, int Hq, int Hkv, int Sq, int Skv, int hd,
                                  int causal, int window, int q_offset, float scale, int dtype,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == rt::kFloat32)
    return launch_hd<float>(q, k, v, out, l, B, Hq, Hkv, Sq, Skv, hd, causal, window, q_offset,
                            scale, s);
  if (dtype == rt::kBFloat16)
    return launch_hd<__nv_bfloat16>(q, k, v, out, l, B, Hq, Hkv, Sq, Skv, hd, causal, window,
                                    q_offset, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Tensor-core route: bf16, hd 64 or 128, 16-byte aligned pointers.  Returns
// the first error (tensor map, attribute or launch), else 0.
extern "C" int rt_flash_attention_tc(const void* q, const void* k, const void* v, void* out,
                                     void* lse, int B, int Hq, int Hkv, int Sq, int Skv, int hd,
                                     int causal, int window, int q_offset, float scale,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (hd == 64)
    return launch_tc<64>(q, k, v, out, l, B, Hq, Hkv, Sq, Skv, causal, window, q_offset, scale,
                         s);
  if (hd == 128)
    return launch_tc<128>(q, k, v, out, l, B, Hq, Hkv, Sq, Skv, causal, window, q_offset,
                          scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
