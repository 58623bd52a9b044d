// One-token GQA attention against a KV cache, online softmax in fp32.
//
// Replaces the Pallas kernel _decode_kernel (src/repro/kernels/decode_attention.py).
// q: (B, Hkv*G, 1, hd); k, v: (B, Hkv, S, hd); valid_len: (B,) int32.
// Position p of row b is visible when p < valid_len[b] and, with window > 0,
// p > valid_len[b] - 1 - window.
//
// One block per (b, kv head); its G query rows form the tile, so each K/V
// row is read once for all G heads that share it.  A loop over the cache in
// tiles of kTile positions takes the place of the TPU's sequential grid axis,
// and carries (m, l, acc) in shared memory.  The loop starts at the first
// visible position and stops at valid_len, so positions that are masked out
// are never read: the kernel is bound by reading the visible K and V rows
// once (2 * visible * hd * bytes per (b, kv head)).  Scores are scaled after
// the dot in fp32, as in the Pallas body, and l == 0 gives zeros.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;      // cache positions per tile: two per lane in the softmax step
constexpr int kMaxHd = 128;
constexpr int kMaxG = 16;
static_assert(kTile == 64, "the softmax step gives each lane two positions");

template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const int* __restrict__ valid_len,
                            T* __restrict__ out, int Hkv, int G, int S, int hd, int window,
                            float scale) {
  __shared__ float qs[kMaxG * kMaxHd];
  __shared__ float acc[kMaxG * kMaxHd];
  __shared__ float ps[kMaxG][kTile];
  __shared__ float m_s[kMaxG];
  __shared__ float l_s[kMaxG];
  __shared__ float corr_s[kMaxG];

  const int bh = blockIdx.x;  // b * Hkv + kv head
  const int b = bh / Hkv;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const size_t q_off = static_cast<size_t>(bh) * G * hd;
  const T* kb = k + static_cast<size_t>(bh) * S * hd;
  const T* vb = v + static_cast<size_t>(bh) * S * hd;

  for (int i = tid; i < G * hd; i += kThreads) {
    qs[i] = rt::to_float(q[q_off + i]);
    acc[i] = 0.f;
  }
  if (tid < G) {
    m_s[tid] = rt::kNegInf;
    l_s[tid] = 0.f;
  }
  // the window is anchored at valid_len - 1 as given; only the reads stop at S
  const int valid_raw = valid_len[b];
  const int valid = min(valid_raw, S);
  const int lo = window > 0 ? max(0, valid_raw - window) : 0;
  __syncthreads();

  for (int t0 = lo; t0 < valid; t0 += kTile) {
    // scores: warp w takes positions t0 + w, t0 + w + kWarps, ...
    for (int j = warp; j < kTile; j += kWarps) {
      const int pos = t0 + j;
      if (pos < valid) {
        const T* kr = kb + static_cast<size_t>(pos) * hd;
        float kreg[kMaxHd / 32];
#pragma unroll
        for (int i = 0; i < kMaxHd / 32; ++i) {
          const int d = lane + 32 * i;
          kreg[i] = d < hd ? rt::to_float(kr[d]) : 0.f;
        }
        for (int g = 0; g < G; ++g) {
          float dot = 0.f;
#pragma unroll
          for (int i = 0; i < kMaxHd / 32; ++i) {
            const int d = lane + 32 * i;
            if (d < hd) dot += qs[g * hd + d] * kreg[i];
          }
          dot = rt::warp_sum(dot);
          if (lane == 0) ps[g][j] = dot * scale;
        }
      } else {
        for (int g = lane; g < G; g += 32) ps[g][j] = rt::kNegInf;
      }
    }
    __syncthreads();

    // online softmax: warp w takes query rows w, w + kWarps, ...
    for (int g = warp; g < G; g += kWarps) {
      const bool vis0 = t0 + lane < valid;
      const bool vis1 = t0 + lane + 32 < valid;
      const float s0 = ps[g][lane];
      const float s1 = ps[g][lane + 32];
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, rt::warp_max(fmaxf(s0, s1)));
      const float p0 = vis0 ? expf(s0 - m_new) : 0.f;
      const float p1 = vis1 ? expf(s1 - m_new) : 0.f;
      ps[g][lane] = p0;
      ps[g][lane + 32] = p1;
      const float lt = rt::warp_sum(p0 + p1);
      if (lane == 0) {
        const float c = expf(m_old - m_new);
        corr_s[g] = c;
        l_s[g] = l_s[g] * c + lt;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc[g, d] = acc[g, d] * corr[g] + sum_j p[g, j] * v[t0 + j, d]
    const int n = min(kTile, valid - t0);
    for (int i = tid; i < G * hd; i += kThreads) {
      const int g = i / hd;
      const int d = i % hd;
      float a = acc[i] * corr_s[g];
      for (int j = 0; j < n; ++j) {
        a += ps[g][j] * rt::to_float(vb[static_cast<size_t>(t0 + j) * hd + d]);
      }
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < G * hd; i += kThreads) {
    const float l = l_s[i / hd];
    out[q_off + i] = rt::from_float<T>(acc[i] / (l == 0.f ? 1.f : l));
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch.
extern "C" int rt_decode_attention(const void* q, const void* k, const void* v,
                                   const void* valid_len, void* out, int B, int Hkv, int G,
                                   int S, int hd, int window, float scale, int dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* vl = static_cast<const int*>(valid_len);
  const int grid = B * Hkv;
  if (dtype == rt::kFloat32) {
    decode_attention_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), vl, static_cast<float*>(out), Hkv, G, S, hd, window,
        scale);
  } else if (dtype == rt::kBFloat16) {
    decode_attention_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), vl, static_cast<__nv_bfloat16*>(out), Hkv, G, S,
        hd, window, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
