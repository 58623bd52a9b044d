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
// on one core and carries (m, l, acc) in VMEM scratch.  Here one block owns
// (b, query head, 64 query rows) and walks, in a loop, only the kv tiles that
// the causal / window band of its rows reaches; K/V of head h // G are read,
// so no head is repeated in memory.  Four threads share a query row: each
// holds a quarter of the row's q and acc in registers (dims part + 4 i), and
// a score is their partial dots summed by two shuffles.  K and V tiles of 64
// rows are staged in shared memory as fp32 (dynamic: 64 KB at hd = 128).
// Keys are taken in groups of kSub: the group's scores, one max, one
// rescale of acc, then p * V.  What bounds it on the H100: at the training
// shape the tensor cores would make it bound by bytes (q, k, v, out read or
// written once); this fp32 CUDA-core version is bound by its own arithmetic
// and shared-memory reads, a first version to make fast later (wgmma).
#include <math.h>

#include "common.cuh"

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
