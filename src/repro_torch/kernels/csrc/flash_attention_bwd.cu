// Flash attention backward, the FA2 scheme, in two launches and no atomics:
// each of dq, dk and dv is written by one block, so the gradients have the
// same bits from run to run.
//
// The Pallas flash kernel (src/repro/kernels/flash_attention.py) is forward
// only; in the JAX package XLA differentiates blockwise_attention
// (src/repro/models/layers.py).  This is the backward of the port's flash
// forward (csrc/flash_attention.cu), with its masks, GQA and layouts:
// q, dq: (B, Hq, Sq, hd); o, do: (B, Hq, Sq, hdv); k, dk: (B, Hkv, Skv, hd);
// v, dv: (B, Hkv, Skv, hdv); lse, dvec: (B, Hq, Sq) fp32; all contiguous; v
// may be narrower than q and k (MLA's 128 beside 192).  P = exp(q k^T * scale - lse) is recomputed
// for the visible pairs only (masked before the exponential), so a row with
// lse = -inf gives zero gradients.  D = rowsum(dO * O) in fp32, dS = P (dO v^T
// - D), dq = scale dS k, dk = scale dS^T q, dv = P^T dO.  Two routes, chosen by
// the wrapper (kernels/flash_attention_bwd.py, route()) from the dtype, the
// widths and the pointers' alignment:
//
// Tensor cores (bf16, (hd, hdv) of (64, 64), (128, 128) or (192, 128)):
// flash_bwd_dq_tc_kernel, then flash_bwd_dkv_tc_kernel, after
// FlashAttention-3's backward but without its atomics.  8 hd + 6 hdv
// operations a visible pair (S, dP and dQ on the q side, 4 hd + 2 hdv; S,
// dP, dV and dK on the kv side, 4 hd + 4 hdv) bound them by operations at the
// models' shapes.  Both are blocks of
// two consumer warpgroups and a producer warpgroup that TMA-loads tiles into
// mbarrier rings, with the products by wgmma and P and dS rounded to bf16 as
// the register A operand of the products that follow.
//   1. q side: a block owns (b, query head, 128 query rows), 64 a consumer
//      warpgroup.  Q and dO are loaded once; D and lse of its rows are
//      computed and read once (D written to dvec for launch 2).  It walks the
//      K/V tiles of its band (128 keys; 64 at (192, 128), where Q, dO and two
//      stages of 128-key K and V tiles would take 240 KB): S = Q K^T and
//      dP = dO V^T from shared memory (K, V K-major as stored), P and dS in
//      fp32 registers, dQ += dS K with K through transpose-B (one m64n192
//      instruction a 16-key step at hd 192); dQ is scaled once and stored.
//   2. kv side: a block owns (b, kv head, 64 kv rows) and walks the G query
//      heads of its kv head and, for each, the query tiles of its band (128
//      rows at hd 64, 64 at hd 128, where dK and dV take 128 registers a
//      thread, 32 at (192, 128), where they take 160).  It computes the
//      transposed products, S^T = K Q^T and dP^T = V dO^T (N = 32 at (192,
//      128)), so that P^T and dS^T are the A operands of
//      dV += P^T dO and dK += dS^T Q (dO, Q through transpose-B); lse and D of
//      a query tile's columns are staged in shared memory beside it.  The two
//      consumer warpgroups share the 64 kv rows and take alternate query
//      tiles, each with its own ring and producer warp; at the end each hands
//      one of its two partial sums to the other through shared memory (the
//      K/V tiles and the rings, idle by then), and dV = dV_0 + dV_1,
//      dK = dK_0 + dK_1 in that order.  64 rows a block and
//      the split of the walk keep the causal grid's longest block short (a
//      kv tile at the start of the sequence sees every query) and give 340
//      blocks at hymba-1.5b's shape (2 x 5 kv heads x 2176 keys) on 132 SMs;
//      blocks start with the lowest kv tiles, the longest walks.
//   3-D tensor maps (width, S, B * H) fill rows past Sq or Skv with zeros, so a
//   tile never reads another head.  Not yet: overlapping one tile's
//   elementwise work with the next tile's products.
//
// CUDA cores (fp32, other widths, hdv <= hd <= 192): flash_bwd_dq_kernel,
// then flash_bwd_dkv_kernel, four threads a row as in the forward, fp32 FMAs
// (6 hd + 4 hdv operations per visible pair), bound by that arithmetic and by
// shared-memory reads.
//   1. q side: one block per (b, query head, 64 query rows).  It takes D
//      (written to dvec for launch 2), walks the kv tiles of its band and sums
//      dq += P (dO v^T - D) k; dq is scaled once at the end.
//   2. kv side: one block per (b, kv head, 64 kv rows), each thread holding a
//      quarter of k, v, dk and dv.  It walks the G query heads of its kv head
//      and, for each, the query tiles of its band (q, dO, lse and D staged in
//      shared memory), summing dv += P^T dO and dk += (P (dO v^T - D))^T q.
#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kRows = 64;                 // rows (query or kv) per block
constexpr int kParts = 4;                 // threads per row
constexpr int kThreads = kRows * kParts;  // 256
constexpr int kTile = 64;                 // rows per shared-memory tile

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

__device__ __forceinline__ bool visible(int qp, int kvp, int causal, int window) {
  return (!causal || kvp <= qp) && (window <= 0 || kvp > qp - window);
}

// kDpt: dims per thread, as in the forward (hdv <= hd <= kParts * kDpt).
template <typename T, int kDpt>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ o,
                        const float* __restrict__ lse, const T* __restrict__ dout,
                        T* __restrict__ dq, float* __restrict__ dvec, int Hq, int Hkv, int Sq,
                        int Skv, int hd, int hdv, int causal, int window, int q_offset,
                        float scale) {
  extern __shared__ float smem[];
  float* ks = smem;                 // [kTile][hd]
  float* vs = smem + kTile * hd;    // [kTile][hdv]

  const int n_qt = (Sq + kRows - 1) / kRows;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x % n_qt);
  const int bh = static_cast<int>(blockIdx.x / n_qt);
  const int bkv = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int row = tid / kParts;
  const int part = tid % kParts;
  const int qi = qt * kRows + row;
  const bool row_ok = qi < Sq;
  const int qp = q_offset + qi;
  const size_t qrow = static_cast<size_t>(bh) * Sq + (row_ok ? qi : 0);
  const size_t roff = qrow * hd;    // q, dq
  const size_t voff = qrow * hdv;   // o, dout

  float qr[kDpt];
  float dor[kDpt];
  float acc[kDpt];
  float dpart = 0.f;
#pragma unroll
  for (int i = 0; i < kDpt; ++i) {
    const int d = part + kParts * i;
    const bool ok = row_ok && d < hdv;
    qr[i] = row_ok && d < hd ? rt::to_float(q[roff + d]) : 0.f;
    dor[i] = ok ? rt::to_float(dout[voff + d]) : 0.f;
    dpart += ok ? dor[i] * rt::to_float(o[voff + d]) : 0.f;
    acc[i] = 0.f;
  }
  const float drow = quad_sum(dpart);
  const size_t lrow = static_cast<size_t>(bh) * Sq + qi;
  const float lse_row = row_ok ? lse[lrow] : -INFINITY;
  if (row_ok && part == 0) dvec[lrow] = drow;

  const int q_first = q_offset + qt * kRows;
  const int q_last = q_offset + min(qt * kRows + kRows, Sq) - 1;
  const int lo = window > 0 ? max(0, q_first - window + 1) : 0;
  const int hi = causal ? min(Skv, q_last + 1) : Skv;
  const T* kb = k + static_cast<size_t>(bkv) * Skv * hd;
  const T* vb = v + static_cast<size_t>(bkv) * Skv * hdv;

  for (int t0 = lo; t0 < hi; t0 += kTile) {
    const int n = min(kTile, hi - t0);
    __syncthreads();
    for (int i = tid; i < n * hd; i += kThreads)
      ks[i] = rt::to_float(kb[static_cast<size_t>(t0) * hd + i]);
    for (int i = tid; i < n * hdv; i += kThreads)
      vs[i] = rt::to_float(vb[static_cast<size_t>(t0) * hdv + i]);
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float* kr = ks + j * hd;
      const float* vr = vs + j * hdv;
      float sdot = 0.f;
      float pdot = 0.f;
#pragma unroll
      for (int i = 0; i < kDpt; ++i) {
        const int d = part + kParts * i;
        if (d < hd) sdot += qr[i] * kr[d];
        if (d < hdv) pdot += dor[i] * vr[d];
      }
      sdot = quad_sum(sdot);
      pdot = quad_sum(pdot);
      if (!(row_ok && visible(qp, t0 + j, causal, window))) continue;
      const float p = expf(sdot * scale - lse_row);
      const float ds = p * (pdot - drow);
#pragma unroll
      for (int i = 0; i < kDpt; ++i) {
        const int d = part + kParts * i;
        if (d < hd) acc[i] += ds * kr[d];
      }
    }
  }
  if (!row_ok) return;
#pragma unroll
  for (int i = 0; i < kDpt; ++i) {
    const int d = part + kParts * i;
    if (d < hd) dq[roff + d] = rt::from_float<T>(acc[i] * scale);
  }
}

template <typename T, int kDpt>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const float* __restrict__ lse,
                         const T* __restrict__ dout, const float* __restrict__ dvec,
                         T* __restrict__ dk, T* __restrict__ dv, int Hq, int Hkv, int Sq,
                         int Skv, int hd, int hdv, int causal, int window, int q_offset,
                         float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                            // [kTile][hd]
  float* dos = smem + kTile * hd;              // [kTile][hdv]  dO
  float* ls = smem + kTile * (hd + hdv);       // [kTile]       lse
  float* dd = ls + kTile;                      // [kTile]       D

  const int n_kt = (Skv + kRows - 1) / kRows;
  const int kt = static_cast<int>(blockIdx.x % n_kt);  // low kv tiles see the most rows
  const int bkv = static_cast<int>(blockIdx.x / n_kt);  // b * Hkv + kv head
  const int G = Hq / Hkv;
  const int tid = threadIdx.x;
  const int row = tid / kParts;
  const int part = tid % kParts;
  const int kj = kt * kRows + row;
  const bool row_ok = kj < Skv;
  const size_t krow = static_cast<size_t>(bkv) * Skv + (row_ok ? kj : 0);
  const size_t roff = krow * hd;    // k, dk
  const size_t voff = krow * hdv;   // v, dv

  float kr[kDpt];
  float vr[kDpt];
  float dka[kDpt];
  float dva[kDpt];
#pragma unroll
  for (int i = 0; i < kDpt; ++i) {
    const int d = part + kParts * i;
    kr[i] = row_ok && d < hd ? rt::to_float(k[roff + d]) : 0.f;
    vr[i] = row_ok && d < hdv ? rt::to_float(v[voff + d]) : 0.f;
    dka[i] = 0.f;
    dva[i] = 0.f;
  }

  // the query rows that see some key of this tile
  const int k_first = kt * kRows;
  const int k_last = min(kt * kRows + kRows, Skv) - 1;
  const int lo = causal ? max(0, k_first - q_offset) : 0;
  const int hi = window > 0 ? min(Sq, k_last + window - q_offset) : Sq;

  for (int g = 0; g < G; ++g) {
    const int bh = bkv * G + g;  // = b * Hq + kv head * G + g
    const T* qb = q + static_cast<size_t>(bh) * Sq * hd;
    const T* db = dout + static_cast<size_t>(bh) * Sq * hdv;
    for (int t0 = lo; t0 < hi; t0 += kTile) {
      const int n = min(kTile, hi - t0);
      __syncthreads();
      for (int i = tid; i < n * hd; i += kThreads)
        qs[i] = rt::to_float(qb[static_cast<size_t>(t0) * hd + i]);
      for (int i = tid; i < n * hdv; i += kThreads)
        dos[i] = rt::to_float(db[static_cast<size_t>(t0) * hdv + i]);
      for (int i = tid; i < n; i += kThreads) {
        ls[i] = lse[static_cast<size_t>(bh) * Sq + t0 + i];
        dd[i] = dvec[static_cast<size_t>(bh) * Sq + t0 + i];
      }
      __syncthreads();
      for (int r = 0; r < n; ++r) {
        const float* qrow = qs + r * hd;
        const float* drow = dos + r * hdv;
        float sdot = 0.f;
        float pdot = 0.f;
#pragma unroll
        for (int i = 0; i < kDpt; ++i) {
          const int d = part + kParts * i;
          if (d < hd) sdot += kr[i] * qrow[d];
          if (d < hdv) pdot += vr[i] * drow[d];
        }
        sdot = quad_sum(sdot);
        pdot = quad_sum(pdot);
        if (!(row_ok && visible(q_offset + t0 + r, kj, causal, window))) continue;
        const float p = expf(sdot * scale - ls[r]);
        const float dsv = p * (pdot - dd[r]);
#pragma unroll
        for (int i = 0; i < kDpt; ++i) {
          const int d = part + kParts * i;
          if (d < hdv) dva[i] += p * drow[d];
          if (d < hd) dka[i] += dsv * qrow[d];
        }
      }
    }
  }
  if (!row_ok) return;
#pragma unroll
  for (int i = 0; i < kDpt; ++i) {
    const int d = part + kParts * i;
    if (d < hd) dk[roff + d] = rt::from_float<T>(dka[i] * scale);
    if (d < hdv) dv[voff + d] = rt::from_float<T>(dva[i]);
  }
}

struct Args {
  const void *q, *k, *v, *o, *lse, *dout;
  void *dq, *dk, *dv, *dvec;
  int B, Hq, Hkv, Sq, Skv, hd, hdv, causal, window, q_offset;
  float scale;
};

template <typename T, int kDpt>
int launch(const Args& a, cudaStream_t s) {
  const size_t smem_q = static_cast<size_t>(kTile) * (a.hd + a.hdv) * sizeof(float);
  const size_t smem_kv = smem_q + 2 * kTile * sizeof(float);
  auto dq_kernel = flash_bwd_dq_kernel<T, kDpt>;
  auto dkv_kernel = flash_bwd_dkv_kernel<T, kDpt>;
  cudaError_t err =
      cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (err != cudaSuccess) return static_cast<int>(err);

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  float* dvec = static_cast<float*>(a.dvec);
  const unsigned grid_q = static_cast<unsigned>((a.Sq + kRows - 1) / kRows) * a.B * a.Hq;
  dq_kernel<<<grid_q, kThreads, smem_q, s>>>(q, k, v, static_cast<const T*>(a.o), lse, dout,
                                             static_cast<T*>(a.dq), dvec, a.Hq, a.Hkv, a.Sq,
                                             a.Skv, a.hd, a.hdv, a.causal, a.window,
                                             a.q_offset, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid_kv = static_cast<unsigned>((a.Skv + kRows - 1) / kRows) * a.B * a.Hkv;
  dkv_kernel<<<grid_kv, kThreads, smem_kv, s>>>(q, k, v, lse, dout, dvec,
                                                static_cast<T*>(a.dk), static_cast<T*>(a.dv),
                                                a.Hq, a.Hkv, a.Sq, a.Skv, a.hd, a.hdv,
                                                a.causal, a.window, a.q_offset, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const Args& a, cudaStream_t s) {
  if (a.hd <= 16) return launch<T, 4>(a, s);
  if (a.hd <= 32) return launch<T, 8>(a, s);
  if (a.hd <= 64) return launch<T, 16>(a, s);
  if (a.hd <= 128) return launch<T, 32>(a, s);
  if (a.hd <= 192) return launch<T, 48>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dvec: (B, Hq, Sq) fp32 scratch for D.  Returns cudaGetLastError() of the
// first call that failed, else 0.
extern "C" int rt_flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                      const void* lse, const void* dout, void* dq, void* dk,
                                      void* dv, void* dvec, int B, int Hq, int Hkv, int Sq,
                                      int Skv, int hd, int hdv, int causal, int window,
                                      int q_offset, float scale, int dtype, void* stream) {
  const Args a{q, k, v, o, lse, dout, dq, dk, dv, dvec, B, Hq, Hkv, Sq, Skv, hd, hdv,
               causal, window, q_offset, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hdv > hd) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == rt::kFloat32) return launch_hd<float>(a, s);
  if (dtype == rt::kBFloat16) return launch_hd<__nv_bfloat16>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ------------------------------------------------------------ tensor cores
namespace {

constexpr int kTcThreads = 384;  // two consumer warpgroups, then the producer warpgroup
constexpr float kLog2e = 1.4426950408889634f;

struct TcArgs {
  const __nv_bfloat16* o;     // q side: D = rowsum(dO * O)
  const __nv_bfloat16* dout;
  const float* lse;
  float* dvec;                // written by the q side, read by the kv side
  __nv_bfloat16 *dq, *dk, *dv;
  int Hq, Hkv, Sq, Skv;
  int n_bh;                   // B * Hq (q side) or B * Hkv (kv side)
  int causal, window, q_offset;
  float scale, scale_log2;    // hd^-0.5 and hd^-0.5 * log2(e)
};

__device__ __forceinline__ bool tc_visible(int key, int qi, const TcArgs& a) {
  const int qp = a.q_offset + qi;
  return key < a.Skv && qi < a.Sq && (!a.causal || key <= qp) &&
         (a.window <= 0 || key > qp - a.window);
}

// lse in log2 units; a row with no visible key (lse = -inf) weighs nothing
// anyway, and 0 keeps its masked entries at exp2(-inf) = 0, not NaN.
__device__ __forceinline__ float lse_log2(float l) { return isfinite(l) ? l * kLog2e : 0.f; }

// Rows row_a and row_a + 8 (those below S) of a 64 x kHd fp32 accumulator,
// times scale, as bf16 into the (S, kHd) rows at base.
template <int kHd>
__device__ __forceinline__ void store_acc(__nv_bfloat16* base, const float (&acc)[kHd / 2],
                                          int row_a, int S, float scale, int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_a + 8 * h;
    if (row >= S) continue;
    uint32_t* r = reinterpret_cast<uint32_t*>(base + static_cast<size_t>(row) * kHd);
#pragma unroll
    for (int j = 0; j < kHd / 8; ++j)
      r[4 * j + lane % 4] =
          hop::pack_bf16(acc[4 * j + 2 * h] * scale, acc[4 * j + 2 * h + 1] * scale);
  }
}

template <int kHd, int kHdv>
struct DqLayout {
  // keys per K / V tile: 128, or 64 where two stages of 128 would not fit
  static constexpr int kKeys = kHd + kHdv > 256 ? 64 : 128;
  static constexpr int kQTile = 128 * kHd * 2;     // 128 rows: kHd / 64 boxes of 16 KB
  static constexpr int kDOTile = 128 * kHdv * 2;
  static constexpr int kKTile = kKeys * kHd * 2;
  static constexpr int kVTile = kKeys * kHdv * 2;
  static constexpr int kQ = 0;
  static constexpr int kDO = kQTile;
  static constexpr int kK = kDO + kDOTile;         // stage s: kK + s * kKTile
  static constexpr int kV = kK + 2 * kKTile;       // stage s: kV + s * kVTile
  static constexpr int kBars = kV + 2 * kVTile;    // qd_full, full[2], empty[2]
  static constexpr int kSmem = 1024 + kBars + 5 * 8;
  static_assert(kSmem <= 232448, "more shared memory than a block can take");
};

// tq: (hd, Sq, B Hq), tdo: (hdv, Sq, B Hq), boxes (64, 128, 1); tk: (hd, Skv,
// B Hkv), tv: (hdv, Skv, B Hkv), boxes (64, kKeys, 1).
template <int kHd, int kHdv>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tdo,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, TcArgs a) {
  using L = DqLayout<kHd, kHdv>;
  constexpr int kKeys = L::kKeys;
  constexpr int kBoxes = kHd / 64;
  constexpr int kVBoxes = kHdv / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hop::align_1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* qd_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 3;

  // longest rows first: every (b, h)'s last query tile, then the one before, ...
  const int n_qt = (a.Sq + 127) / 128;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / a.n_bh;
  const int bh = static_cast<int>(blockIdx.x) % a.n_bh;  // b * Hq + h
  const int bkv = (bh / a.Hq) * a.Hkv + (bh % a.Hq) / (a.Hq / a.Hkv);

  // the kv range that some row of this block sees, in tiles of kKeys keys from lo
  const int q_first = a.q_offset + qt * 128;
  const int q_last = a.q_offset + min(qt * 128 + 128, a.Sq) - 1;
  const int lo = a.window > 0 ? max(0, q_first - a.window + 1) : 0;
  const int hi = a.causal ? min(a.Skv, q_last + 1) : a.Skv;
  const int n_t = hi > lo ? (hi - lo + kKeys - 1) / kKeys : 0;

  if (threadIdx.x == 0) {
    hop::mbar_init(qd_full, 1);
    for (int s = 0; s < 2; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 8);  // lane 0 of every consumer warp
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer warpgroup: one thread starts every load
    hop::regs_release<24>();
    if (threadIdx.x != 256) return;
    hop::mbar_expect_tx(qd_full, L::kQTile + L::kDOTile);
    for (int b = 0; b < kBoxes; ++b)
      hop::tma_load_3d(smem + L::kQ + b * 16384, &tq, qd_full, 64 * b, qt * 128, bh);
    for (int b = 0; b < kVBoxes; ++b)
      hop::tma_load_3d(smem + L::kDO + b * 16384, &tdo, qd_full, 64 * b, qt * 128, bh);
    for (int i = 0; i < n_t; ++i) {
      const int s = i % 2;
      if (i >= 2) hop::mbar_wait(&empty[s], ((i / 2) & 1) ^ 1);
      const int kv0 = lo + i * kKeys;
      hop::mbar_expect_tx(&full[s], L::kKTile + L::kVTile);
      for (int b = 0; b < kBoxes; ++b)
        hop::tma_load_3d(smem + L::kK + s * L::kKTile + b * kKeys * 128, &tk, &full[s], 64 * b,
                         kv0, bkv);
      for (int b = 0; b < kVBoxes; ++b)
        hop::tma_load_3d(smem + L::kV + s * L::kVTile + b * kKeys * 128, &tv, &full[s], 64 * b,
                         kv0, bkv);
    }
    return;
  }

  // consumer warpgroup wg: query rows qt * 128 + 64 wg .. + 63
  hop::regs_claim<240>();
  const int lane = threadIdx.x % 32;
  const int warp = (threadIdx.x % 128) / 32;
  const int row_a = qt * 128 + wg * 64 + warp * 16 + lane / 4;  // and row_a + 8
  const int wg_first = a.q_offset + qt * 128 + wg * 64;         // the warpgroup's query positions
  const int wg_last = wg_first + 63;
  const size_t row0 = static_cast<size_t>(bh) * a.Sq;

  // D = rowsum(dO * O) in fp32 and lse of the thread's two rows; a quad of
  // threads shares a row, each reading a quarter of it
  float dd[2], l2[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_a + 8 * h;
    float part = 0.f;
    if (row < a.Sq) {
      const size_t off = (row0 + row) * kHdv + (lane % 4) * (kHdv / 4);
      const uint4* dov = reinterpret_cast<const uint4*>(a.dout + off);
      const uint4* ov = reinterpret_cast<const uint4*>(a.o + off);
#pragma unroll
      for (int c = 0; c < kHdv / 32; ++c) {
        const uint4 x = dov[c];
        const uint4 y = ov[c];
        const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
        const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 xf = __bfloat1622float2(xp[e]);
          const float2 yf = __bfloat1622float2(yp[e]);
          part += xf.x * yf.x + xf.y * yf.y;
        }
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    dd[h] = part;
    l2[h] = row < a.Sq ? lse_log2(a.lse[row0 + row]) : 0.f;
    if (row < a.Sq && lane % 4 == 0) a.dvec[row0 + row] = part;
  }

  float dq[kHd / 2];
#pragma unroll
  for (int i = 0; i < kHd / 2; ++i) dq[i] = 0.f;
  hop::mbar_wait(qd_full, 0);

  for (int i = 0; i < n_t; ++i) {
    const int s = i % 2;
    const int kv0 = lo + i * kKeys;
    const uint8_t* ks = smem + L::kK + s * L::kKTile;
    const uint8_t* vs = smem + L::kV + s * L::kVTile;

    float sc[kKeys / 2];  // S = Q K^T, then P
    float dp[kKeys / 2];  // dP = dO V^T, then dS
    hop::mbar_wait(&full[s], (i / 2) & 1);
    hop::fence_regs(sc);
    hop::fence_regs(dp);
    hop::wgmma_fence();
    hop::product_ss<kHd, kKeys>(sc, smem + L::kQ + wg * 64 * 128, 128, ks);
    hop::product_ss<kHdv, kKeys>(dp, smem + L::kDO + wg * 64 * 128, 128, vs);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(sc);
    hop::fence_regs(dp);

    // a mask only where the tile crosses Skv, the diagonal or the window's edge
    const int kv_last = kv0 + kKeys - 1;
    const bool masked = kv_last >= a.Skv || (a.causal && kv_last > wg_first) ||
                        (a.window > 0 && kv0 <= wg_last - a.window);
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * j + e] * a.scale_log2 - l2[e >> 1];
        if (masked) {
          const int key = kv0 + 8 * j + 2 * (lane % 4) + (e & 1);
          if (!tc_visible(key, row_a + 8 * (e >> 1), a)) x = -INFINITY;
        }
        const float p = exp2f(x);
        dp[4 * j + e] = p * (dp[4 * j + e] - dd[e >> 1]);
      }
    }
    uint32_t dsa[kKeys / 16][4];  // dS in bf16, the A operand of each 16-key step
    hop::pack_a<kKeys>(dsa, dp);

    hop::fence_regs(dq);
    hop::wgmma_fence();
    hop::product_rs<kHd, kKeys>(dq, dsa, ks);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(dq);
    if (lane == 0) hop::mbar_arrive(&empty[s]);
  }
  store_acc<kHd>(a.dq + row0 * kHd, dq, row_a, a.Sq, a.scale, lane);
}

template <int kHd, int kHdv>
struct DkvLayout {
  // query rows per tile: dK and dV take (kHd + kHdv) / 2 registers a thread
  static constexpr int kQT = kHd == 64 ? 128 : (kHd + kHdv > 256 ? 32 : 64);
  static constexpr int kKTile = 64 * kHd * 2;       // 64 kv rows: kHd / 64 boxes of 8 KB
  static constexpr int kVTile = 64 * kHdv * 2;
  static constexpr int kQTile = kQT * kHd * 2;
  static constexpr int kDOTile = kQT * kHdv * 2;
  static constexpr int kK = 0;
  static constexpr int kV = kKTile;
  // warpgroup w's ring: stage s holds Q at kRing + w * kRingBytes + s * kStage, dO after it
  static constexpr int kRing = kKTile + kVTile;
  static constexpr int kStage = kQTile + kDOTile;
  static constexpr int kRingBytes = 2 * kStage;
  // lse (log2 units) and D of the stage's query columns: [w][s][2][kQT] fp32
  static constexpr int kVec = kRing + 2 * kRingBytes;
  static constexpr int kBars = kVec + 8 * kQT * 4;  // kv_full, full[w][s], empty[w][s]
  static constexpr int kSmem = 1024 + kBars + 9 * 8;
  static_assert(kSmem <= 232448, "more shared memory than a block can take");
  // the partial sums handed over at the end, dK then dV, 128 threads' worth,
  // fit in the K/V tiles and the rings
  static_assert((kHd + kHdv) / 2 * 128 * 4 <= kVec, "no room to hand over dK and dV");
};

// tq: (hd, Sq, B Hq), tdo: (hdv, Sq, B Hq), boxes (64, kQT, 1); tk: (hd, Skv,
// B Hkv), tv: (hdv, Skv, B Hkv), boxes (64, 64, 1).
template <int kHd, int kHdv>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tdo,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv, TcArgs a) {
  using L = DkvLayout<kHd, kHdv>;
  constexpr int kQT = L::kQT;
  constexpr int kBoxes = kHd / 64;
  constexpr int kVBoxes = kHdv / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hop::align_1024(smem_raw);
  float* vec = reinterpret_cast<float*>(smem + L::kVec);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;   // [w * 2 + s]
  uint64_t* empty = bars + 5;  // [w * 2 + s]

  // lowest kv tiles first: under a causal mask they see the most queries
  const int kt = static_cast<int>(blockIdx.x) / a.n_bh;
  const int bkv = static_cast<int>(blockIdx.x) % a.n_bh;  // b * Hkv + kv head
  const int G = a.Hq / a.Hkv;
  const int kv0 = kt * 64;

  // the query rows that see some key of this tile, in tiles of kQT from lo;
  // item n = g * n_qt + t is query head g's tile t, taken by warpgroup n % 2
  const int k_last = min(kv0 + 64, a.Skv) - 1;
  const int lo = a.causal ? max(0, kv0 - a.q_offset) : 0;
  const int hi = a.window > 0 ? min(a.Sq, k_last + a.window - a.q_offset) : a.Sq;
  const int n_qt = hi > lo ? (hi - lo + kQT - 1) / kQT : 0;
  const int n_items = G * n_qt;

  if (threadIdx.x == 0) {
    hop::mbar_init(kv_full, 1);
    for (int i = 0; i < 4; ++i) {
      hop::mbar_init(&full[i], 32);  // the producer warp's lanes, one with the TMA bytes
      hop::mbar_init(&empty[i], 4);  // lane 0 of every warp of the consumer warpgroup
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  if (wg == 2) {  // producer warps 0 and 1 feed consumer warpgroups 0 and 1
    hop::regs_release<24>();
    const int w = (threadIdx.x - 256) / 32;
    if (w >= 2) return;
    if (w == 0 && lane == 0) {
      hop::mbar_expect_tx(kv_full, L::kKTile + L::kVTile);
      for (int b = 0; b < kBoxes; ++b)
        hop::tma_load_3d(smem + L::kK + b * 8192, &tk, kv_full, 64 * b, kv0, bkv);
      for (int b = 0; b < kVBoxes; ++b)
        hop::tma_load_3d(smem + L::kV + b * 8192, &tv, kv_full, 64 * b, kv0, bkv);
    }
    for (int i = 0, n = w; n < n_items; ++i, n += 2) {
      const int s = i % 2;
      if (i >= 2) hop::mbar_wait(&empty[w * 2 + s], ((i / 2) & 1) ^ 1);
      const int bh = bkv * G + n / n_qt;  // = b * Hq + kv head * G + g
      const int q0 = lo + (n % n_qt) * kQT;
      float* ls = vec + (w * 2 + s) * 2 * kQT;
      for (int c = lane; c < kQT; c += 32) {
        const int qi = q0 + c;
        const size_t idx = static_cast<size_t>(bh) * a.Sq + qi;
        ls[c] = qi < a.Sq ? lse_log2(a.lse[idx]) : 0.f;
        ls[kQT + c] = qi < a.Sq ? a.dvec[idx] : 0.f;
      }
      if (lane == 0) {
        uint8_t* qs = smem + L::kRing + w * L::kRingBytes + s * L::kStage;
        hop::mbar_expect_tx(&full[w * 2 + s], L::kStage);
        for (int b = 0; b < kBoxes; ++b)
          hop::tma_load_3d(qs + b * kQT * 128, &tq, &full[w * 2 + s], 64 * b, q0, bh);
        for (int b = 0; b < kVBoxes; ++b)
          hop::tma_load_3d(qs + L::kQTile + b * kQT * 128, &tdo, &full[w * 2 + s], 64 * b, q0,
                           bh);
      } else {
        hop::mbar_arrive(&full[w * 2 + s]);
      }
    }
    return;
  }

  // consumer warpgroup wg: kv rows kv0 .. kv0 + 63, query items wg, wg + 2, ...
  hop::regs_claim<240>();
  const int warp = (threadIdx.x % 128) / 32;
  const int kr_a = kv0 + warp * 16 + lane / 4;  // the thread's kv rows: kr_a and kr_a + 8
  float dk[kHd / 2], dv[kHdv / 2];
#pragma unroll
  for (int i = 0; i < kHd / 2; ++i) dk[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kHdv / 2; ++i) dv[i] = 0.f;
  hop::mbar_wait(kv_full, 0);

  for (int i = 0, n = wg; n < n_items; ++i, n += 2) {
    const int s = i % 2;
    const int q0 = lo + (n % n_qt) * kQT;
    const uint8_t* qs = smem + L::kRing + wg * L::kRingBytes + s * L::kStage;
    const uint8_t* dos = qs + L::kQTile;
    const float* ls = vec + (wg * 2 + s) * 2 * kQT;
    const float* ds = ls + kQT;

    float sc[kQT / 2];  // S^T = K Q^T, then P^T
    float dp[kQT / 2];  // dP^T = V dO^T, then dS^T
    hop::mbar_wait(&full[wg * 2 + s], (i / 2) & 1);
    hop::fence_regs(sc);
    hop::fence_regs(dp);
    hop::wgmma_fence();
    hop::product_ss<kHd, kQT>(sc, smem + L::kK, 64, qs);
    hop::product_ss<kHdv, kQT>(dp, smem + L::kV, 64, dos);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(sc);
    hop::fence_regs(dp);

    // a mask only where the tile crosses Sq, Skv, the diagonal or the window's edge
    const int qp_first = a.q_offset + q0;
    const bool masked = q0 + kQT > a.Sq || kv0 + 64 > a.Skv ||
                        (a.causal && kv0 + 63 > qp_first) ||
                        (a.window > 0 && kv0 <= qp_first + kQT - 1 - a.window);
#pragma unroll
    for (int j = 0; j < kQT / 8; ++j) {
      const int c = 8 * j + 2 * (lane % 4);
      const float2 lc = *reinterpret_cast<const float2*>(ls + c);
      const float2 dc = *reinterpret_cast<const float2*>(ds + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * j + e] * a.scale_log2 - ((e & 1) ? lc.y : lc.x);
        if (masked && !tc_visible(kr_a + 8 * (e >> 1), q0 + c + (e & 1), a)) x = -INFINITY;
        const float p = exp2f(x);
        sc[4 * j + e] = p;
        dp[4 * j + e] = p * (dp[4 * j + e] - ((e & 1) ? dc.y : dc.x));
      }
    }
    uint32_t pa[kQT / 16][4];   // P^T in bf16
    uint32_t dsa[kQT / 16][4];  // dS^T in bf16
    hop::pack_a<kQT>(pa, sc);
    hop::pack_a<kQT>(dsa, dp);

    hop::fence_regs(dv);
    hop::fence_regs(dk);
    hop::wgmma_fence();
    hop::product_rs<kHdv, kQT>(dv, pa, dos);
    hop::product_rs<kHd, kQT>(dk, dsa, qs);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(dv);
    hop::fence_regs(dk);
    if (lane == 0) hop::mbar_arrive(&empty[wg * 2 + s]);
  }

  // dV = dV_0 + dV_1 (stored by warpgroup 0), dK = dK_0 + dK_1 (warpgroup 1):
  // each hands the other its partial through the K/V tiles and the rings,
  // idle once both walks are done (warpgroup 0's dK first, then 1's dV)
  hop::named_sync<1, 256>();
  const int t = threadIdx.x % 128;
  float* dk_swap = reinterpret_cast<float*>(smem);
  float* dv_swap = dk_swap + kHd / 2 * 128;
  const size_t rows = static_cast<size_t>(bkv) * a.Skv;
  if (wg == 0) {
#pragma unroll
    for (int i = 0; i < kHd / 2; ++i) dk_swap[i * 128 + t] = dk[i];
    hop::named_sync<1, 256>();
#pragma unroll
    for (int i = 0; i < kHdv / 2; ++i) dv[i] = dv[i] + dv_swap[i * 128 + t];
    store_acc<kHdv>(a.dv + rows * kHdv, dv, kr_a, a.Skv, 1.f, lane);
  } else {
#pragma unroll
    for (int i = 0; i < kHdv / 2; ++i) dv_swap[i * 128 + t] = dv[i];
    hop::named_sync<1, 256>();
#pragma unroll
    for (int i = 0; i < kHd / 2; ++i) dk[i] = dk_swap[i * 128 + t] + dk[i];
    store_acc<kHd>(a.dk + rows * kHd, dk, kr_a, a.Skv, a.scale, lane);
  }
}

template <int kHd, int kHdv>
int launch_tc(const Args& a, cudaStream_t s) {
  constexpr int kQT = DkvLayout<kHd, kHdv>::kQT;
  constexpr int kKeys = DqLayout<kHd, kHdv>::kKeys;
  const int bq = a.B * a.Hq;
  const int bkv = a.B * a.Hkv;
  CUtensorMap tq, tdo, tk, tv, tq2, tdo2, tk2, tv2;
  int err = hop::map_heads(&tq, a.q, bq, a.Sq, kHd, 128);
  if (!err) err = hop::map_heads(&tdo, a.dout, bq, a.Sq, kHdv, 128);
  if (!err) err = hop::map_heads(&tk, a.k, bkv, a.Skv, kHd, kKeys);
  if (!err) err = hop::map_heads(&tv, a.v, bkv, a.Skv, kHdv, kKeys);
  if (!err) err = hop::map_heads(&tq2, a.q, bq, a.Sq, kHd, kQT);
  if (!err) err = hop::map_heads(&tdo2, a.dout, bq, a.Sq, kHdv, kQT);
  if (!err) err = hop::map_heads(&tk2, a.k, bkv, a.Skv, kHd, 64);
  if (!err) err = hop::map_heads(&tv2, a.v, bkv, a.Skv, kHdv, 64);
  if (err) return err;
  auto dq_kernel = flash_bwd_dq_tc_kernel<kHd, kHdv>;
  auto dkv_kernel = flash_bwd_dkv_tc_kernel<kHd, kHdv>;
  const int smem_q = DqLayout<kHd, kHdv>::kSmem;
  const int smem_kv = DkvLayout<kHd, kHdv>::kSmem;
  cudaError_t e =
      cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (e != cudaSuccess) return static_cast<int>(e);
  TcArgs t{static_cast<const __nv_bfloat16*>(a.o), static_cast<const __nv_bfloat16*>(a.dout),
           static_cast<const float*>(a.lse), static_cast<float*>(a.dvec),
           static_cast<__nv_bfloat16*>(a.dq), static_cast<__nv_bfloat16*>(a.dk),
           static_cast<__nv_bfloat16*>(a.dv), a.Hq, a.Hkv, a.Sq, a.Skv, bq, a.causal, a.window,
           a.q_offset, a.scale, a.scale * kLog2e};
  const unsigned grid_q = static_cast<unsigned>((a.Sq + 127) / 128) * bq;
  dq_kernel<<<grid_q, kTcThreads, smem_q, s>>>(tq, tdo, tk, tv, t);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  t.n_bh = bkv;
  const unsigned grid_kv = static_cast<unsigned>((a.Skv + 63) / 64) * bkv;
  dkv_kernel<<<grid_kv, kTcThreads, smem_kv, s>>>(tq2, tdo2, tk2, tv2, t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Tensor-core route: bf16, (hd, hdv) of (64, 64), (128, 128) or (192, 128),
// 16-byte aligned pointers.  dvec: (B, Hq, Sq) fp32 scratch for D.  Returns
// the first error (tensor map, attribute or launch), else 0.
extern "C" int rt_flash_attention_bwd_tc(const void* q, const void* k, const void* v,
                                         const void* o, const void* lse, const void* dout,
                                         void* dq, void* dk, void* dv, void* dvec, int B, int Hq,
                                         int Hkv, int Sq, int Skv, int hd, int hdv, int causal,
                                         int window, int q_offset, float scale, void* stream) {
  const Args a{q, k, v, o, lse, dout, dq, dk, dv, dvec, B, Hq, Hkv, Sq, Skv, hd, hdv,
               causal, window, q_offset, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64 && hdv == 64) return launch_tc<64, 64>(a, s);
  if (hd == 128 && hdv == 128) return launch_tc<128, 128>(a, s);
  if (hd == 192 && hdv == 128) return launch_tc<192, 128>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
