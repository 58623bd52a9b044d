// One-token GQA attention against a KV cache, online softmax in fp32.
//
// Replaces the Pallas kernel _decode_kernel (src/repro/kernels/decode_attention.py).
// q: (B, Hkv*G, 1, hd); k, v: (B, Hkv, S, hd); valid_len: (B,) int32.
// Position p of row b is visible when p < valid_len[b] and, with window > 0,
// p > valid_len[b] - 1 - window.  Scores are scaled after the dot in fp32, as
// in the Pallas body, and a row with no visible position (l == 0) gives zeros.
//
// What bounds it on the H100: device memory.  Each visible K and V row is read
// once for the G query heads that share it, so the kernel does at most about
// 2 G operations a byte (G <= 16) where the card needs 295 in bf16 before its
// arithmetic is the limit.  The tensor cores would speed up what is not the
// limit, so neither route uses them; the split route's design is about bytes in
// flight and blocks enough to fill the card.
//
// Route "split" (hd a multiple of 8 up to 128, G up to 16, 16-byte aligned
// q, k, v): flash-decoding.  The grid is (B * Hkv * groups, n_split): the
// cache is cut into n_split spans of `span` positions, planned on the host
// from the shapes only (kernels/decode_attention.py plan_splits), so the grid
// never depends on valid_len and one CUDA graph replays at any fill level.  A
// block holds up to kMaxGB query rows of one kv head (G = 9..16 takes two
// blocks, each reading the same cache rows).  Inside a block:
//   - each warp owns every (kWarps)th step of the span's visible positions and
//     keeps its own (m, l, acc) for its query rows in fp32 registers; q sits in
//     registers too;
//   - a lane reads 16 bytes of a K or V row (L lanes a row, so a bf16 hd-64 row
//     is 8 lanes and one warp-wide load covers 4 rows); a row's dot is summed
//     over its L lanes by xor shuffles, so every lane of the row holds the score
//     and each lane updates its own 16 bytes of acc, with no other exchange;
//   - plain unrolled 16-byte loads (ld.global.nc) keep two steps in flight per
//     warp: the next step's K and V rows are issued before this step's are
//     used.  Registers, not shared memory, hold them: a cache row is used by
//     the lanes that loaded it and by no other, so staging it through shared
//     memory (cp.async or TMA) would buy nothing but barriers;
//   - the row groups of a warp merge by shuffles and the warps once, through
//     shared memory, at the end: one barrier a block.
// With n_split == 1 the block writes the output.  Otherwise it writes its
// (m, l, acc) into fp32 scratch (a split wholly outside the visible range
// writes an empty partial and reads no cache row) and a second kernel merges
// the splits in split order with the (m, l, acc) algebra of
// src/repro/serve/flash_decoding.py.  No atomics: two calls give the same bits.
//
// Route "simt" (any hd up to 128 and G up to 16; the first port of it): one block
// per (b, kv head) walks the visible positions in tiles of 64 with (m, l, acc)
// in shared memory and three barriers a tile.
#include "common.cuh"

#include <cstdint>

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

// ------------------------------------------------------------- route "split"
namespace split {

constexpr int kMaxGB = 8;  // query rows a block holds
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float fexp(float x) { return exp2f(x * kLog2e); }

// 16 bytes of storage as fp32 values
template <typename T>
struct Pack;
template <>
struct Pack<float> {
  static constexpr int kElems = 4;
  __device__ __forceinline__ static void unpack(const uint4& r, float (&f)[4]) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
};
template <>
struct Pack<__nv_bfloat16> {
  static constexpr int kElems = 8;
  // element 2i sits in the low half of word i: a bf16 is the top half of its fp32
  __device__ __forceinline__ static void unpack(const uint4& r, float (&f)[8]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ uint4 ldg16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// T: storage type; L: lanes a cache row (16 bytes each); GB: query rows a block
// holds, at least the rows it is given
template <typename T, int L, int GB>
__global__ void __launch_bounds__(kThreads)
    decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ valid_len,
                        T* __restrict__ out, float* __restrict__ part_m,
                        float* __restrict__ part_l, float* __restrict__ part_acc, int Hkv,
                        int G, int S, int hd, int window, int n_split, int span, float scale) {
  using P = Pack<T>;
  constexpr int E = P::kElems;       // elements a lane holds of a row
  constexpr int R = 32 / L;          // rows one warp-wide load covers
  constexpr int U = GB <= 4 ? 4 : 2;  // warp-wide loads of K (and of V) a step
  constexpr int kStep = R * U;       // positions a warp takes a step
  static_assert(L * R == 32 && L * E <= kMaxHd, "a row is at most one warp of 16-byte loads");

  __shared__ float sm_m[kWarps][GB];
  __shared__ float sm_l[kWarps][GB];
  __shared__ float sm_acc[kWarps][GB][L * E];

  const int groups = (G + kMaxGB - 1) / kMaxGB;
  const int per = (G + groups - 1) / groups;
  const int bh = blockIdx.x / groups;  // b * Hkv + kv head
  const int g0 = (blockIdx.x % groups) * per;
  const int gn = min(per, G - g0);
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int c = lane % L;  // this lane's 16 bytes of a row
  const int r = lane / L;  // this lane's row of a warp-wide load
  const bool has_c = c * E < hd;

  float qr[GB][E];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    if (g < gn && has_c) {
      P::unpack(ldg16(q + (static_cast<size_t>(bh) * G + g0 + g) * hd + c * E), qr[g]);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) qr[g][e] = 0.f;
    }
  }

  // this block's positions: its span cut to the visible range
  const int valid_raw = valid_len[bh / Hkv];
  const int lo = window > 0 ? max(0, valid_raw - window) : 0;
  const int s0 = blockIdx.y * span;
  const int first = max(lo, s0);
  const int last = min(min(valid_raw, S), s0 + span);

  float m[GB], l[GB], acc[GB][E];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = rt::kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  const size_t col = static_cast<size_t>(bh) * S * hd + c * E;
  const T* kb = k + col;
  const T* vb = v + col;
  constexpr int kStride = kWarps * kStep;
  uint4 kc[U], vc[U];
  int p0 = first + warp * kStep;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int p = p0 + u * R + r;
    const bool ld = has_c && p < last;
    kc[u] = ld ? ldg16(kb + static_cast<size_t>(p) * hd) : make_uint4(0, 0, 0, 0);
    vc[u] = ld ? ldg16(vb + static_cast<size_t>(p) * hd) : make_uint4(0, 0, 0, 0);
  }
  for (; p0 < last; p0 += kStride) {
    // the next step's rows, in flight while this step's are used
    uint4 kn[U], vn[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = p0 + kStride + u * R + r;
      const bool ld = has_c && p < last;
      kn[u] = ld ? ldg16(kb + static_cast<size_t>(p) * hd) : make_uint4(0, 0, 0, 0);
      vn[u] = ld ? ldg16(vb + static_cast<size_t>(p) * hd) : make_uint4(0, 0, 0, 0);
    }
    float s[U][GB];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[E];
      P::unpack(kc[u], kf);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d = fmaf(qr[g][e], kf[e], d);
#pragma unroll
        for (int o = 1; o < L; o <<= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
        s[u][g] = d * scale;
      }
    }
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (p0 + u * R + r < last) mx = fmaxf(mx, s[u][g]);
      }
      const float corr = fexp(m[g] - mx);
      m[g] = mx;
      l[g] *= corr;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= corr;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool vis = p0 + u * R + r < last;
      float vf[E];
      P::unpack(vc[u], vf);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        const float pg = vis ? fexp(s[u][g] - m[g]) : 0.f;
        l[g] += pg;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = fmaf(pg, vf[e], acc[g][e]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      kc[u] = kn[u];
      vc[u] = vn[u];
    }
  }

  // merge the warp's row groups, then the warps
#pragma unroll
  for (int o = L; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float mx = fmaxf(m[g], m_o);
      const float ca = fexp(m[g] - mx);
      const float cb = fexp(m_o - mx);
      l[g] = l[g] * ca + l_o * cb;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float a_o = __shfl_xor_sync(0xffffffffu, acc[g][e], o);
        acc[g][e] = acc[g][e] * ca + a_o * cb;
      }
      m[g] = mx;
    }
  }
  if (r == 0) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
#pragma unroll
      for (int e = 0; e < E; ++e) sm_acc[warp][g][c * E + e] = acc[g][e];
      if (c == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < gn * hd; i += kThreads) {
    const int g = i / hd;
    const int d = i % hd;
    float mx = sm_m[0][g];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lt = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float cw = fexp(sm_m[w][g] - mx);
      lt += cw * sm_l[w][g];
      a += cw * sm_acc[w][g][d];
    }
    const size_t row = static_cast<size_t>(bh) * G + g0 + g;
    if (part_acc == nullptr) {
      out[row * hd + d] = rt::from_float<T>(a / (lt == 0.f ? 1.f : lt));
    } else {
      const size_t prow = (static_cast<size_t>(bh) * n_split + blockIdx.y) * G + g0 + g;
      part_acc[prow * hd + d] = a;
      if (d == 0) {
        part_m[prow] = mx;
        part_l[prow] = lt;
      }
    }
  }
}

// Merge the n_split partials of each (b, kv head) in split order:
// out = sum_i e^(m_i - m*) acc_i / sum_i e^(m_i - m*) l_i, zeros where that sum is 0.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_combine_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                          const float* __restrict__ part_acc, T* __restrict__ out, int G,
                          int hd, int n_split) {
  const size_t bh = blockIdx.x;
  for (int i = threadIdx.x; i < G * hd; i += kThreads) {
    const int g = i / hd;
    const int d = i % hd;
    const size_t r0 = bh * n_split * G + g;  // split j's row: r0 + j * G
    float mx = rt::kNegInf;
    for (int j = 0; j < n_split; ++j) mx = fmaxf(mx, part_m[r0 + j * G]);
    float lt = 0.f, a = 0.f;
    for (int j = 0; j < n_split; ++j) {
      const size_t row = r0 + static_cast<size_t>(j) * G;
      const float cw = fexp(part_m[row] - mx);
      lt += cw * part_l[row];
      a += cw * part_acc[row * hd + d];
    }
    out[(bh * G + g) * hd + d] = rt::from_float<T>(a / (lt == 0.f ? 1.f : lt));
  }
}

struct Args {
  const void *q, *k, *v;
  const int* valid_len;
  void* out;
  float* part;  // m, l (B Hkv, n_split, G) then acc (B Hkv, n_split, G, hd); null at n_split 1
  int B, Hkv, G, S, hd, window, n_split, span;
  float scale;
  cudaStream_t stream;
};

template <typename T, int L, int GB>
void launch(const Args& a) {
  const int groups = (a.G + kMaxGB - 1) / kMaxGB;
  const size_t rows = static_cast<size_t>(a.B) * a.Hkv * a.n_split * a.G;
  float* pm = a.n_split > 1 ? a.part : nullptr;
  float* pl = pm ? pm + rows : nullptr;
  float* pa = pm ? pm + 2 * rows : nullptr;
  const dim3 grid(static_cast<unsigned>(a.B * a.Hkv * groups), static_cast<unsigned>(a.n_split));
  decode_split_kernel<T, L, GB><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      a.valid_len, static_cast<T*>(a.out), pm, pl, pa, a.Hkv, a.G, a.S, a.hd, a.window,
      a.n_split, a.span, a.scale);
  if (pm) {
    decode_combine_kernel<T><<<a.B * a.Hkv, kThreads, 0, a.stream>>>(
        pm, pl, pa, static_cast<T*>(a.out), a.G, a.hd, a.n_split);
  }
}

template <typename T, int L>
void launch_l(const Args& a) {
  const int groups = (a.G + kMaxGB - 1) / kMaxGB;
  const int per = (a.G + groups - 1) / groups;
  if (per <= 1) launch<T, L, 1>(a);
  else if (per <= 2) launch<T, L, 2>(a);
  else if (per <= 4) launch<T, L, 4>(a);
  else launch<T, L, 8>(a);
}

// lanes a row: the power of two that covers hd / (elements in 16 bytes)
template <typename T>
bool launch_t(const Args& a) {
  const int chunks = a.hd / Pack<T>::kElems;
  if (chunks <= 1) {
    if constexpr (Pack<T>::kElems == 8) launch_l<T, 1>(a);
    else return false;
  } else if (chunks <= 2) launch_l<T, 2>(a);
  else if (chunks <= 4) launch_l<T, 4>(a);
  else if (chunks <= 8) launch_l<T, 8>(a);
  else if (chunks <= 16) launch_l<T, 16>(a);
  else if constexpr (Pack<T>::kElems == 4) launch_l<T, 32>(a);
  else return false;
  return true;
}

}  // namespace split
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

// The split route: one launch at n_split 1, else the split kernel and the merge.
// part: fp32 scratch of B * Hkv * n_split * G * (hd + 2) values, null at n_split 1.
// Returns cudaGetLastError() after the launches.
extern "C" int rt_decode_attention_split(const void* q, const void* k, const void* v,
                                         const void* valid_len, void* out, void* part, int B,
                                         int Hkv, int G, int S, int hd, int window,
                                         int n_split, int span, float scale, int dtype,
                                         void* stream) {
  if (hd % 8 != 0 || hd > kMaxHd || G < 1 || G > kMaxG || n_split < 1 || span < 1 ||
      (n_split > 1 && part == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const split::Args a{q, k, v, static_cast<const int*>(valid_len), out,
                      static_cast<float*>(part), B, Hkv, G, S, hd, window, n_split, span,
                      scale, static_cast<cudaStream_t>(stream)};
  bool ok = false;
  if (dtype == rt::kFloat32) ok = split::launch_t<float>(a);
  else if (dtype == rt::kBFloat16) ok = split::launch_t<__nv_bfloat16>(a);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
