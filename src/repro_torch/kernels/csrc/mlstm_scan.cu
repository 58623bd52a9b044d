// Chunked mLSTM forward: the stabilized xLSTM matrix-memory recurrence, fp32 inside.
//
// Replaces the Pallas kernel _mlstm_kernel / mlstm_scan (src/repro/kernels/mlstm_scan.py).
// Per (b, h) and chunk of L steps, in the Pallas order: q scaled by dqk^-0.5;
// b = cumsum(log_f); r = cummax(i - b); m_t = b + max(m_prev, r); D_ts =
// exp(b_t - b_s + i_s - m_t) for s <= t; S = (q k^T) D; num = S v + inter (q
// C) with inter = exp(b + m_prev - m_t); den = rowsum(S) + inter (q . n); h =
// num / max(|den|, exp(-m_t)); then C = decay C + (w k)^T v, n = decay n +
// (w k)^T 1, m = m_next.  C, n start at 0 and m at -1e30, where inter and
// decay come out as exactly 0.
//
// The TPU kernel walks a (BH, chunk) grid whose chunk axis runs in order on
// one core and keeps C (dqk x dv) in VMEM.  At the training shape BH is 16,
// so one block per (b, h) would fill 16 of the H100's 132 SMs.  Here only the
// state recurrence is sequential; the rest runs over all (b, h, chunk) at
// once.  What bounds it on the H100: bytes (q, k, v, i, f read and h written
// once, 50 MB a call at xlstm-1.3b's training shape, 0.015 ms at 3.35 TB/s)
// and operations about as much (4 L dqk dv per chunk for q C and the state
// update, 2 L^2 (dqk + dv) within the chunk: 14.5 GFLOP, 0.0147 ms on the
// bf16 tensor cores).  Two routes, chosen by the wrapper
// (kernels/mlstm_scan.py, route()):
//
// Tensor cores (bf16, chunk 128, dqk and dv multiples of 64, rows TMA can
// read), three launches (mlstm_tc.cuh): mlstm_tc_gates_kernel (a warp per
// chunk, shuffles), mlstm_tc_state_kernel (a block per (b, h) and 128 x 128
// tile of C walks the chunks, C in fp32 registers, wgmma with K = 128; C
// saved in bf16 at chunk starts, 64 MB a call fewer than fp32 at the
// training shape), mlstm_tc_fwd_out_kernel (a block per (b, h, chunk, 128
// columns of v): q k^T and q C by wgmma over dqk in boxes of 64, the mask
// and the decay in registers, S v from registers).  q, k, v are read in the
// layout they come in (the model's transposed projections, no copy) and h is
// written (B, S, H, dv).  Nothing fp32 of size L dv or L^2 reaches memory.
//
// CUDA cores (fp32, other shapes; contiguous (BH, S, .) tensors), five steps:
//   1. mlstm_gates_kernel: per (b, h), one thread walks the gates of all
//      chunks: b, m_t, inter, w per step and decay per chunk (tiny);
//   2. S = q k^T (tiled product), then mlstm_decay_mask_kernel multiplies by D;
//   3. mlstm_state_scan_kernel: 64 x 64 tiles of C (and the one column of n),
//      each walking the chunks in order; it writes the state at every
//      chunk's start (the backward reads them: B H nc dqk dv fp32);
//   4. num = S v, then num += inter * (q C_start) (tiled products);
//   5. mlstm_fwd_out_kernel: per row, den and h (and the fp32 h and den that
//      the backward reads).
// Every sum is fp32 on the CUDA cores (67 TFLOP/s at best), from 64 x 64
// tiles in shared memory, each chunk's operands read once per tile.
#include "mlstm.cuh"
#include "mlstm_tc.cuh"

namespace {

constexpr int kThreads = mlstm::kBlock;
constexpr int kGateThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kGateThreads)
    mlstm_gates_kernel(const T* __restrict__ i_raw, const T* __restrict__ log_f,
                       float* __restrict__ gates, float* __restrict__ decay, int BH, int S,
                       int L) {
  const int bh = blockIdx.x * kGateThreads + threadIdx.x;
  if (bh >= BH) return;
  const long long BS = static_cast<long long>(BH) * S;
  float* gb = gates;
  float* gm = gates + BS;
  float* gi = gates + 2 * BS;
  float* gw = gates + 3 * BS;
  const int nc = S / L;
  float m_prev = rt::kNegInf;
  for (int c = 0; c < nc; ++c) {
    const long long base = static_cast<long long>(bh) * S + static_cast<long long>(c) * L;
    float bsum = 0.f;
    float r = -INFINITY;
    for (int t = 0; t < L; ++t) {
      const float ii = rt::to_float(i_raw[base + t]);
      bsum += rt::to_float(log_f[base + t]);
      r = fmaxf(r, ii - bsum);
      const float m_t = bsum + fmaxf(m_prev, r);
      gb[base + t] = bsum;
      gm[base + t] = m_t;
      gi[base + t] = expf(bsum + m_prev - m_t);
    }
    const float m_next = bsum + fmaxf(m_prev, r);
    for (int t = 0; t < L; ++t) {
      gw[base + t] = expf(bsum - gb[base + t] + rt::to_float(i_raw[base + t]) - m_next);
    }
    decay[static_cast<long long>(bh) * nc + c] = expf(bsum + m_prev - m_next);
    m_prev = m_next;
  }
}

// S[z] (L x L) *= D for s <= t, 0 above the diagonal; one block per entry z.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    mlstm_decay_mask_kernel(float* __restrict__ scores, const float* __restrict__ gates,
                            const T* __restrict__ i_raw, long long BS, int L) {
  const long long z = blockIdx.x;
  const float* gb = gates + z * L;
  const float* gm = gates + BS + z * L;
  const T* ii = i_raw + z * L;
  float* sz = scores + z * L * L;
  for (int e = threadIdx.x; e < L * L; e += kThreads) {
    const int t = e / L;
    const int s = e % L;
    sz[e] = s <= t ? sz[e] * expf(gb[t] - gb[s] + rt::to_float(ii[s]) - gm[t]) : 0.f;
  }
}

template <typename TA, typename TB, typename TO>
__global__ void __launch_bounds__(kThreads) mlstm_fwd_gemm_kernel(const mlstm::Gemm g) {
  mlstm::gemm_tile<TA, TB, TO>(g);
}

template <typename TA, typename TB>
__global__ void __launch_bounds__(kThreads) mlstm_state_scan_kernel(const mlstm::Scan s) {
  mlstm::scan_tile<TA, TB>(s);
}

// One block per row (b, h, t): den, g = max(|den|, exp(-m_t)), h = num / g.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    mlstm_fwd_out_kernel(const T* __restrict__ q, const float* __restrict__ scores,
                         const float* __restrict__ n, const float* __restrict__ gates,
                         const float* __restrict__ num, T* __restrict__ out,
                         float* __restrict__ hf, float* __restrict__ den_out, long long BS, int L,
                         int dqk, int dv, float scale) {
  __shared__ float red[mlstm::kWarps];
  const long long row = blockIdx.x;
  const long long z = row / L;
  const int t = static_cast<int>(row % L);
  const float* srow = scores + (z * L + t) * L;
  float ssum = 0.f;
  for (int s = threadIdx.x; s <= t; s += kThreads) ssum += srow[s];
  float qn = 0.f;
  for (int d = threadIdx.x; d < dqk; d += kThreads) {
    qn += (rt::to_float(q[row * dqk + d]) * scale) * n[z * dqk + d];
  }
  ssum = rt::block_sum(ssum, red);
  qn = rt::block_sum(qn, red);
  const float m_t = gates[BS + row];
  const float inter = gates[2 * BS + row];
  const float den = ssum + inter * qn;
  const float g = fmaxf(fabsf(den), expf(-m_t));
  for (int j = threadIdx.x; j < dv; j += kThreads) {
    const float h = num[row * dv + j] / g;
    out[row * dv + j] = rt::from_float<T>(h);
    if (hf) hf[row * dv + j] = h;
  }
  if (threadIdx.x == 0) den_out[row] = den;
}

int gemm(const mlstm::Gemm& g, int ta, int tb, int to, long long Z, cudaStream_t stream) {
  const dim3 grid((g.N + mlstm::kTile - 1) / mlstm::kTile, (g.M + mlstm::kTile - 1) / mlstm::kTile,
                  static_cast<unsigned>(Z));
  MLSTM_DISPATCH3(mlstm_fwd_gemm_kernel, ta, tb, to, grid, stream, g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int forward(const void* q, const void* k, const void* v, const void* i_raw, const void* log_f,
            void* out, float* hf, float* gates, float* decay, float* scores, float* C, float* n,
            float* num, float* den, int BH, int S, int L, int dqk, int dv, float scale, int dt,
            cudaStream_t stream) {
  const int nc = S / L;
  const long long Z = static_cast<long long>(BH) * nc;
  const long long BS = static_cast<long long>(BH) * S;
  constexpr int F32 = rt::kFloat32;
  cudaError_t err;

  mlstm_gates_kernel<T><<<(BH + kGateThreads - 1) / kGateThreads, kGateThreads, 0, stream>>>(
      static_cast<const T*>(i_raw), static_cast<const T*>(log_f), gates, decay, BH, S, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  // S = scale * q k^T
  mlstm::Gemm g{};
  g.a = {q, static_cast<long long>(L) * dqk, dqk, 1};
  g.b = {k, static_cast<long long>(L) * dqk, 1, dqk};
  g.out = scores;
  g.o_bs = static_cast<long long>(L) * L;
  g.o_rs = L;
  g.alpha = scale;
  g.M = L;
  g.N = L;
  g.K = dqk;
  int rc = gemm(g, dt, dt, F32, Z, stream);
  if (rc) return rc;
  mlstm_decay_mask_kernel<T><<<static_cast<unsigned>(Z), kThreads, 0, stream>>>(
      scores, gates, static_cast<const T*>(i_raw), BS, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  // chunk-start states: C (dqk x dv) and n (dqk x 1), X = decay X + (w k)^T B
  mlstm::Scan s{};
  s.a = {k, static_cast<long long>(L) * dqk, dqk, 1};
  s.a_scale = 1.f;
  s.a_row = gates + 3 * BS;
  s.b = {v, static_cast<long long>(L) * dv, dv, 1};
  s.decay = decay;
  s.states = C;
  s.nc = nc;
  s.L = L;
  s.Dm = dqk;
  s.N = dv;
  const int tiles_m = (dqk + mlstm::kTile - 1) / mlstm::kTile;
  mlstm_state_scan_kernel<T, T><<<dim3(tiles_m * ((dv + mlstm::kTile - 1) / mlstm::kTile), BH),
                                  kThreads, 0, stream>>>(s);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  s.b = {nullptr, 0, 0, 0};
  s.states = n;
  s.N = 1;
  mlstm_state_scan_kernel<T, T><<<dim3(tiles_m, BH), kThreads, 0, stream>>>(s);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  // num = S v, then num += inter * (scale * q C_start)
  g = mlstm::Gemm{};
  g.a = {scores, static_cast<long long>(L) * L, L, 1};
  g.b = {v, static_cast<long long>(L) * dv, dv, 1};
  g.out = num;
  g.o_bs = static_cast<long long>(L) * dv;
  g.o_rs = dv;
  g.alpha = 1.f;
  g.M = L;
  g.N = dv;
  g.K = L;
  g.kmode = 1;
  if ((rc = gemm(g, F32, dt, F32, Z, stream))) return rc;
  g.a = {q, static_cast<long long>(L) * dqk, dqk, 1};
  g.b = {C, static_cast<long long>(dqk) * dv, dv, 1};
  g.bias = num;
  g.row_scale = gates + 2 * BS;
  g.rsc_bs = L;
  g.alpha = scale;
  g.K = dqk;
  g.kmode = 0;
  if ((rc = gemm(g, dt, F32, F32, Z, stream))) return rc;

  mlstm_fwd_out_kernel<T><<<static_cast<unsigned>(BS), kThreads, 0, stream>>>(
      static_cast<const T*>(q), scores, n, gates, num, static_cast<T*>(out), hf, den, BS, L, dqk,
      dv, scale);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ tensor cores
__global__ void __launch_bounds__(mlstm::tc::kThreads)
    mlstm_tc_gates_kernel(const mlstm::tc::GatesArgs a) {
  mlstm::tc::gates(a);
}

__global__ void __launch_bounds__(mlstm::tc::kThreads, 1)
    mlstm_tc_state_kernel(const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, const mlstm::tc::StateArgs a) {
  mlstm::tc::state_walk<false>(&tk, &tv, a);
}

__global__ void __launch_bounds__(mlstm::tc::kThreads, 1)
    mlstm_tc_fwd_out_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tc, const mlstm::tc::OutArgs a) {
  mlstm::tc::fwd_out(&tq, &tk, &tv, &tc, a);
}

}  // namespace

// q, k: (BH, S, dqk); v, out: (BH, S, dv); i_raw, log_f: (BH, S), storage type
// `dtype`, contiguous, S a multiple of L.  fp32 outputs for the backward:
// hf (BH, S, dv) the unrounded h (nullptr when out is fp32), gates (4, BH, S)
// as b, m_t, inter, w; decay (BH, nc); scores (BH, nc, L, L) = S; C (BH, nc,
// dqk, dv) and n (BH, nc, dqk) at each chunk's start; den (BH, S).  num (BH,
// S, dv) is fp32 scratch.  Returns cudaGetLastError() of the first launch
// that failed, else 0.
extern "C" int rt_mlstm_scan(const void* q, const void* k, const void* v, const void* i_raw,
                             const void* log_f, void* out, void* hf, void* gates, void* decay,
                             void* scores, void* C, void* n, void* num, void* den, int BH, int S,
                             int L, int dqk, int dv, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](void* p) { return static_cast<float*>(p); };
  if (dtype == rt::kFloat32)
    return forward<float>(q, k, v, i_raw, log_f, out, f(hf), f(gates), f(decay), f(scores), f(C),
                          f(n), f(num), f(den), BH, S, L, dqk, dv, scale, dtype, s);
  if (dtype == rt::kBFloat16)
    return forward<__nv_bfloat16>(q, k, v, i_raw, log_f, out, f(hf), f(gates), f(decay),
                                  f(scores), f(C), f(n), f(num), f(den), BH, S, L, dqk, dv, scale,
                                  dtype, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Tensor-core route: q, k (B, H, S, dqk) and v (B, H, S, dv) bf16 views with
// contiguous rows, 16-byte aligned, their (b, h, s) strides multiples of 8;
// i_raw, log_f (B, H, S) bf16 views; `strides` holds the (b, h, s) strides
// (elements) of q, k, v, i_raw and log_f in that order.  S a multiple of 128,
// dqk and dv multiples of 64, dqk at most 1024.  Outputs: out (B, S, H, dv)
// bf16; gates (5, BH, S) fp32: b, m_t, inter, w, i - b; decay (BH, nc); C
// (BH, nc - 1, dqk, dv) bf16, C at the start of chunks 1 .. nc - 1; n (BH, nc,
// dqk) fp32 at each chunk's start; den and qn = scale (q . n) (BH, S) fp32.
// Three launches; returns the first error (tensor map, attribute or launch),
// else 0.
extern "C" int rt_mlstm_scan_tc(const void* q, const void* k, const void* v, const void* i_raw,
                                const void* log_f, void* out, void* gates, void* decay, void* C,
                                void* n, void* den, void* qn, const long long* strides, int B,
                                int H, int S, int dqk, int dv, float scale, void* stream) {
  namespace tc = mlstm::tc;
  if (S % tc::kL || dqk % 64 || dv % 64 || dqk < 64 || dv < 64 || dqk > tc::kMaxDqk)
    return static_cast<int>(cudaErrorInvalidValue);
  const tc::Dims d{B, H, S, dqk, dv, S / tc::kL};
  const int BH = B * H;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap tq, tk, tv, tcm;
  int pq, pk, pv;
  int rc = tc::map_view(&tq, &pq, q, B, H, S, dqk, strides);
  if (!rc) rc = tc::map_view(&tk, &pk, k, B, H, S, dqk, strides + 3);
  if (!rc) rc = tc::map_view(&tv, &pv, v, B, H, S, dv, strides + 6);
  // with one chunk there is no carried state: a map that is never read
  if (!rc)
    rc = d.nc > 1 ? hop::map_heads(&tcm, C, BH * (d.nc - 1), dqk, dv, 64)
                  : hop::map_heads(&tcm, q, 1, 64, 64, 64);
  if (rc) return rc;
  float* g = static_cast<float*>(gates);
  const long long BS = static_cast<long long>(BH) * S;
  const auto* ib = static_cast<const __nv_bfloat16*>(i_raw);
  const auto* fb = static_cast<const __nv_bfloat16*>(log_f);
  const tc::GatesArgs ga{ib, fb, {strides[9], strides[10], strides[11]},
                         {strides[12], strides[13], strides[14]}, g, static_cast<float*>(decay), d};
  rc = tc::launch(mlstm_tc_gates_kernel, dim3(BH), tc::gates_smem(d), st, ga);
  if (rc) return rc;
  const tc::StateArgs sa{g + 3 * BS, g + 3 * BS, static_cast<float*>(decay), nullptr, nullptr,
                         static_cast<__nv_bfloat16*>(C), static_cast<float*>(n), nullptr, pk, pv,
                         d};
  rc = tc::launch(mlstm_tc_state_kernel, dim3(tc::tiles(dqk) * tc::tiles(dv), BH),
                  tc::state_smem(), st, tk, tv, sa);
  if (rc) return rc;
  const tc::OutArgs oa{g, static_cast<float*>(n), static_cast<__nv_bfloat16*>(out),
                       static_cast<float*>(den), static_cast<float*>(qn), pq, pk, pv, d, scale};
  return tc::launch(mlstm_tc_fwd_out_kernel, dim3(BH * d.nc, tc::tiles(dv)), tc::out_smem(d), st,
                    tq, tk, tv, tcm, oa);
}
