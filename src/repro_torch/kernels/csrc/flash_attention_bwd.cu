// Flash attention backward, the FA2 scheme, in two launches and no atomics,
// so the gradients are the same from run to run.
//
// The Pallas flash kernel (src/repro/kernels/flash_attention.py) is forward
// only; in the JAX package XLA differentiates blockwise_attention
// (src/repro/models/layers.py).  This is the backward of the port's flash
// forward (csrc/flash_attention.cu), with its masks, GQA and layouts:
// q, o, do, dq: (B, Hq, Sq, hd); k, v, dk, dv: (B, Hkv, Skv, hd); lse, dvec:
// (B, Hq, Sq) fp32; all contiguous.  P = exp(q k^T * scale - lse) is recomputed
// for the visible pairs only, so a row with lse = -inf gives zero gradients.
//
//   1. q side: one block per (b, query head, 64 query rows), four threads a
//      row as in the forward.  It takes D = rowsum(dO * O) in fp32 (written to
//      dvec for launch 2), walks the kv tiles of its band and sums
//      dq += P (dO v^T - D) k; dq is scaled once at the end.
//   2. kv side: one block per (b, kv head, 64 kv rows), four threads a row,
//      each holding a quarter of k, v, dk and dv.  It walks the G query heads
//      of its kv head and, for each, the query tiles of its band (q, dO, lse
//      and D staged in shared memory), summing dv += P^T dO and
//      dk += (P (dO v^T - D))^T q into one accumulator.
//
// What bounds it on the H100: with tensor cores, bytes at the training shape
// (q, k, v, o, dO read once, dq, dk, dv written once); this fp32 CUDA-core
// version is bound by its arithmetic (10 hd operations per visible pair)
// and shared-memory reads.
#include <math.h>

#include "common.cuh"

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

template <typename T, int kDpt>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ o,
                        const float* __restrict__ lse, const T* __restrict__ dout,
                        T* __restrict__ dq, float* __restrict__ dvec, int Hq, int Hkv, int Sq,
                        int Skv, int hd, int causal, int window, int q_offset, float scale) {
  extern __shared__ float smem[];
  float* ks = smem;                 // [kTile][hd]
  float* vs = smem + kTile * hd;    // [kTile][hd]

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
  const size_t roff = (static_cast<size_t>(bh) * Sq + (row_ok ? qi : 0)) * hd;

  float qr[kDpt];
  float dor[kDpt];
  float acc[kDpt];
  float dpart = 0.f;
#pragma unroll
  for (int i = 0; i < kDpt; ++i) {
    const int d = part + kParts * i;
    const bool ok = row_ok && d < hd;
    qr[i] = ok ? rt::to_float(q[roff + d]) : 0.f;
    dor[i] = ok ? rt::to_float(dout[roff + d]) : 0.f;
    dpart += ok ? dor[i] * rt::to_float(o[roff + d]) : 0.f;
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
  const T* vb = v + static_cast<size_t>(bkv) * Skv * hd;

  for (int t0 = lo; t0 < hi; t0 += kTile) {
    const int n = min(kTile, hi - t0);
    __syncthreads();
    for (int i = tid; i < n * hd; i += kThreads) {
      ks[i] = rt::to_float(kb[static_cast<size_t>(t0) * hd + i]);
      vs[i] = rt::to_float(vb[static_cast<size_t>(t0) * hd + i]);
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float* kr = ks + j * hd;
      const float* vr = vs + j * hd;
      float sdot = 0.f;
      float pdot = 0.f;
#pragma unroll
      for (int i = 0; i < kDpt; ++i) {
        const int d = part + kParts * i;
        if (d < hd) {
          sdot += qr[i] * kr[d];
          pdot += dor[i] * vr[d];
        }
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
                         int Skv, int hd, int causal, int window, int q_offset, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                      // [kTile][hd]
  float* dos = smem + kTile * hd;        // [kTile][hd]  dO
  float* ls = smem + 2 * kTile * hd;     // [kTile]      lse
  float* dd = ls + kTile;                // [kTile]      D

  const int n_kt = (Skv + kRows - 1) / kRows;
  const int kt = static_cast<int>(blockIdx.x % n_kt);  // low kv tiles see the most rows
  const int bkv = static_cast<int>(blockIdx.x / n_kt);  // b * Hkv + kv head
  const int G = Hq / Hkv;
  const int tid = threadIdx.x;
  const int row = tid / kParts;
  const int part = tid % kParts;
  const int kj = kt * kRows + row;
  const bool row_ok = kj < Skv;
  const size_t roff = (static_cast<size_t>(bkv) * Skv + (row_ok ? kj : 0)) * hd;

  float kr[kDpt];
  float vr[kDpt];
  float dka[kDpt];
  float dva[kDpt];
#pragma unroll
  for (int i = 0; i < kDpt; ++i) {
    const int d = part + kParts * i;
    const bool ok = row_ok && d < hd;
    kr[i] = ok ? rt::to_float(k[roff + d]) : 0.f;
    vr[i] = ok ? rt::to_float(v[roff + d]) : 0.f;
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
    const T* db = dout + static_cast<size_t>(bh) * Sq * hd;
    for (int t0 = lo; t0 < hi; t0 += kTile) {
      const int n = min(kTile, hi - t0);
      __syncthreads();
      for (int i = tid; i < n * hd; i += kThreads) {
        qs[i] = rt::to_float(qb[static_cast<size_t>(t0) * hd + i]);
        dos[i] = rt::to_float(db[static_cast<size_t>(t0) * hd + i]);
      }
      for (int i = tid; i < n; i += kThreads) {
        ls[i] = lse[static_cast<size_t>(bh) * Sq + t0 + i];
        dd[i] = dvec[static_cast<size_t>(bh) * Sq + t0 + i];
      }
      __syncthreads();
      for (int r = 0; r < n; ++r) {
        const float* qrow = qs + r * hd;
        const float* drow = dos + r * hd;
        float sdot = 0.f;
        float pdot = 0.f;
#pragma unroll
        for (int i = 0; i < kDpt; ++i) {
          const int d = part + kParts * i;
          if (d < hd) {
            sdot += kr[i] * qrow[d];
            pdot += vr[i] * drow[d];
          }
        }
        sdot = quad_sum(sdot);
        pdot = quad_sum(pdot);
        if (!(row_ok && visible(q_offset + t0 + r, kj, causal, window))) continue;
        const float p = expf(sdot * scale - ls[r]);
        const float dsv = p * (pdot - dd[r]);
#pragma unroll
        for (int i = 0; i < kDpt; ++i) {
          const int d = part + kParts * i;
          if (d < hd) {
            dva[i] += p * drow[d];
            dka[i] += dsv * qrow[d];
          }
        }
      }
    }
  }
  if (!row_ok) return;
#pragma unroll
  for (int i = 0; i < kDpt; ++i) {
    const int d = part + kParts * i;
    if (d < hd) {
      dk[roff + d] = rt::from_float<T>(dka[i] * scale);
      dv[roff + d] = rt::from_float<T>(dva[i]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *o, *lse, *dout;
  void *dq, *dk, *dv, *dvec;
  int B, Hq, Hkv, Sq, Skv, hd, causal, window, q_offset;
  float scale;
};

template <typename T, int kDpt>
int launch(const Args& a, cudaStream_t s) {
  const size_t smem_q = 2 * kTile * a.hd * sizeof(float);
  const size_t smem_kv = (2 * kTile * a.hd + 2 * kTile) * sizeof(float);
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
                                             a.Skv, a.hd, a.causal, a.window, a.q_offset,
                                             a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid_kv = static_cast<unsigned>((a.Skv + kRows - 1) / kRows) * a.B * a.Hkv;
  dkv_kernel<<<grid_kv, kThreads, smem_kv, s>>>(q, k, v, lse, dout, dvec,
                                                static_cast<T*>(a.dk), static_cast<T*>(a.dv),
                                                a.Hq, a.Hkv, a.Sq, a.Skv, a.hd, a.causal,
                                                a.window, a.q_offset, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const Args& a, cudaStream_t s) {
  if (a.hd <= 16) return launch<T, 4>(a, s);
  if (a.hd <= 32) return launch<T, 8>(a, s);
  if (a.hd <= 64) return launch<T, 16>(a, s);
  if (a.hd <= 128) return launch<T, 32>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dvec: (B, Hq, Sq) fp32 scratch for D.  Returns cudaGetLastError() of the
// first call that failed, else 0.
extern "C" int rt_flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                      const void* lse, const void* dout, void* dq, void* dk,
                                      void* dv, void* dvec, int B, int Hq, int Hkv, int Sq,
                                      int Skv, int hd, int causal, int window, int q_offset,
                                      float scale, int dtype, void* stream) {
  const Args a{q, k, v, o, lse, dout, dq, dk, dv, dvec, B, Hq, Hkv, Sq, Skv, hd,
               causal, window, q_offset, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kFloat32) return launch_hd<float>(a, s);
  if (dtype == rt::kBFloat16) return launch_hd<__nv_bfloat16>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
