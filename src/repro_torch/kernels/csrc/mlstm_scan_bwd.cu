// Chunked mLSTM backward: dq, dk, dv, di, df of the forward in mlstm_scan.cu.
//
// The Pallas kernel (src/repro/kernels/mlstm_scan.py) is forward only; in the
// JAX package XLA differentiates mlstm_chunked (src/repro/models/xlstm.py).
// h does not depend on the stabilizer m (num and den both carry exp(-m_t),
// and so does the floor of den), so every m is held constant and cummax has
// no derivative here.  With g = max(|den|, exp(-m_t)), per chunk (q scaled):
//   dnum = dh / g;  dden = -sign(den) rowsum(dh h) / g where |den| > exp(-m_t)
//   dS = dnum v^T + dden (s <= t);  dP = dS D;  dlogD = dS S
//   dq = scale (dP k + inter C dnum + inter dden n)
//   dk = dP^T q + w (dC_end v + dn_end);  dv = S^T dnum + w k dC_end
//   di = colsum(dlogD) + dlogw;  db = rowsum(dlogD) - colsum(dlogD) + dlog_inter - dlogw,
//   db_L += sum dlogw + decay ddecay;  df = reverse cumsum of db within the chunk,
// with dlog_inter = inter (q . C dnum + dden q . n), dlogw = w k . (dC_end v +
// dn_end), ddecay = sum(dC_end C_start) + dn_end . n_start, and the carried
// gradient of the state at a chunk's start dC = decay dC_end + (inter q)^T dnum
// (dn likewise with dden).  C and n at each chunk's start come from the
// forward, which saves them.
//
// Two routes, the forward's (kernels/mlstm_scan.py, route()).
//
// Tensor cores (bf16, chunk 128, dqk and dv multiples of 64), six launches
// (mlstm_tc.cuh): mlstm_tc_bwd_rows_kernel (g, dden and the state walk's row
// factors, a warp per row, from dh read in its own layout and the saved bf16
// h); mlstm_tc_bwd_state_kernel (dC = decay dC + (q o inter scale / g)^T dh
// in reverse, a block per 128 x 128 tile, wgmma with K = 128, dC written in
// bf16, the tiles' shares of ddecay); mlstm_tc_bwd_qside_kernel (per chunk:
// q k^T and dh v^T by wgmma, then S, dS, dP, dlogD in registers; scale dP and
// S / g out in bf16, 4 MB a call at the training shape); mlstm_tc_bwd_dq_kernel
// and mlstm_tc_bwd_dkv_kernel (per chunk and 128 output columns: dh C^T,
// (scale dP) k, v dC^T, (scale dP)^T q, k dC, (S / g)^T dh by wgmma); and
// mlstm_tc_bwd_gates_kernel (di, df).  dnum = dh / g never reaches memory:
// 1 / g rides on the rows of the products it enters.
//
// CUDA cores (fp32, other shapes): mlstm_bwd_prep_kernel (dnum, dden per row);
// mlstm_dstate_scan_kernel (dC and dn of each chunk's end, walking the chunks
// in reverse in 64 x 64 tiles, with each tile's share of ddecay); tiled
// products dnum v^T, dP k, dnum C^T, dP^T q, v dC^T, S^T dnum and k dC
// (mlstm_bwd_gemm_kernel); mlstm_bwd_ds_kernel (dP in place of dnum v^T, row
// and column sums of dlogD); mlstm_bwd_combine_kernel (dq, dk, dlog_inter,
// dlogw per row); mlstm_bwd_gates_kernel (di, df per chunk).  Tiles and the
// sums of ddecay's partials run in a fixed order: no atomics, the same bits
// every run (on both routes).  What bounds it on the H100: operations (8 L
// dqk dv per chunk and 2 L^2 (3 dqk + 2 dv): 29.0 GFLOP a call at xlstm-1.3b's
// training shape, 0.029 ms on the bf16 tensor cores).
#include "mlstm.cuh"
#include "mlstm_tc.cuh"

namespace {

constexpr int kThreads = mlstm::kBlock;
constexpr int kGateThreads = 128;

template <typename TA, typename TB, typename TO>
__global__ void __launch_bounds__(kThreads) mlstm_bwd_gemm_kernel(const mlstm::Gemm g) {
  mlstm::gemm_tile<TA, TB, TO>(g);
}

template <typename TA, typename TB>
__global__ void __launch_bounds__(kThreads) mlstm_dstate_scan_kernel(const mlstm::Scan s) {
  mlstm::scan_tile<TA, TB>(s);
}

// One block per row: dnum = dh / g and dden.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    mlstm_bwd_prep_kernel(const T* __restrict__ dh, const float* __restrict__ hf,
                          const float* __restrict__ den, const float* __restrict__ gates,
                          float* __restrict__ dnum, float* __restrict__ dden, long long BS,
                          int dv) {
  __shared__ float red[mlstm::kWarps];
  const long long row = blockIdx.x;
  const float d = den[row];
  const float floor_ = expf(-gates[BS + row]);
  const float g = fmaxf(fabsf(d), floor_);
  float delta = 0.f;
  for (int j = threadIdx.x; j < dv; j += kThreads) {
    const float x = rt::to_float(dh[row * dv + j]);
    delta += x * hf[row * dv + j];
    dnum[row * dv + j] = x / g;
  }
  delta = rt::block_sum(delta, red);
  if (threadIdx.x == 0) dden[row] = fabsf(d) > floor_ ? -(d > 0.f ? 1.f : -1.f) * delta / g : 0.f;
}

// One block per entry z: dlogD's row and column sums from dS = dnum v^T +
// dden, then dP = dS D written over dnum v^T.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    mlstm_bwd_ds_kernel(float* __restrict__ dp, const float* __restrict__ scores,
                        const float* __restrict__ gates, const T* __restrict__ i_raw,
                        const float* __restrict__ dden, float* __restrict__ rowsum,
                        float* __restrict__ colsum, long long BS, int L) {
  const long long z = blockIdx.x;
  float* pz = dp + z * L * L;
  const float* sz = scores + z * L * L;
  const float* dd = dden + z * L;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  for (int t = warp; t < L; t += mlstm::kWarps) {
    float acc = 0.f;
    for (int s = lane; s <= t; s += 32) acc += (pz[t * L + s] + dd[t]) * sz[t * L + s];
    acc = rt::warp_sum(acc);
    if (lane == 0) rowsum[z * L + t] = acc;
  }
  for (int s = threadIdx.x; s < L; s += kThreads) {
    float acc = 0.f;
    for (int t = s; t < L; ++t) acc += (pz[t * L + s] + dd[t]) * sz[t * L + s];
    colsum[z * L + s] = acc;
  }
  __syncthreads();
  const float* gb = gates + z * L;
  const float* gm = gates + BS + z * L;
  const T* ii = i_raw + z * L;
  for (int e = threadIdx.x; e < L * L; e += kThreads) {
    const int t = e / L;
    const int s = e % L;
    pz[e] = s <= t ? (pz[e] + dd[t]) * expf(gb[t] - gb[s] + rt::to_float(ii[s]) - gm[t]) : 0.f;
  }
}

// One block per row: dq, dk and the row's dlog_inter and dlogw.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    mlstm_bwd_combine_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const float* __restrict__ dpk, const float* __restrict__ gq,
                             const float* __restrict__ dptq, const float* __restrict__ hk,
                             const float* __restrict__ n, const float* __restrict__ dn_end,
                             const float* __restrict__ gates, const float* __restrict__ dden,
                             T* __restrict__ dq, T* __restrict__ dk,
                             float* __restrict__ dlog_inter, float* __restrict__ dlogw,
                             long long BS, int L, int dqk, float scale) {
  __shared__ float red[mlstm::kWarps];
  const long long row = blockIdx.x;
  const long long z = row / L;
  const float inter = gates[2 * BS + row];
  const float w = gates[3 * BS + row];
  const float dd = dden[row];
  float qg = 0.f, qn = 0.f, kh = 0.f, kn = 0.f;
  for (int d = threadIdx.x; d < dqk; d += kThreads) {
    const long long o = row * dqk + d;
    const float qs = rt::to_float(q[o]) * scale;
    const float kv = rt::to_float(k[o]);
    const float nd = n[z * dqk + d];
    const float dnd = dn_end[z * dqk + d];
    qg += qs * gq[o];
    qn += qs * nd;
    kh += kv * hk[o];
    kn += kv * dnd;
    dq[o] = rt::from_float<T>((dpk[o] + inter * gq[o] + (inter * dd) * nd) * scale);
    dk[o] = rt::from_float<T>(dptq[o] + w * hk[o] + w * dnd);
  }
  qg = rt::block_sum(qg, red);
  qn = rt::block_sum(qn, red);
  kh = rt::block_sum(kh, red);
  kn = rt::block_sum(kn, red);
  if (threadIdx.x == 0) {
    dlog_inter[row] = inter * (qg + dd * qn);
    dlogw[row] = w * (kh + kn);
  }
}

// One thread per entry z: di and df of the chunk.
template <typename T>
__global__ void __launch_bounds__(kGateThreads)
    mlstm_bwd_gates_kernel(const float* __restrict__ rowsum, const float* __restrict__ colsum,
                           const float* __restrict__ dlog_inter, const float* __restrict__ dlogw,
                           const float* __restrict__ partial, int n_partial,
                           const float* __restrict__ decay, T* __restrict__ di,
                           T* __restrict__ df, long long Z, int L) {
  const long long z = static_cast<long long>(blockIdx.x) * kGateThreads + threadIdx.x;
  if (z >= Z) return;
  float ddecay = 0.f;
  for (int p = 0; p < n_partial; ++p) ddecay += partial[z * n_partial + p];
  const long long base = z * L;
  float sw = 0.f;
  for (int s = 0; s < L; ++s) {
    sw += dlogw[base + s];
    di[base + s] = rt::from_float<T>(colsum[base + s] + dlogw[base + s]);
  }
  float run = 0.f;
  for (int j = L - 1; j >= 0; --j) {
    float db = rowsum[base + j] - colsum[base + j] + dlog_inter[base + j] - dlogw[base + j];
    if (j == L - 1) db += sw + ddecay * decay[z];
    run += db;
    df[base + j] = rt::from_float<T>(run);
  }
}

int gemm(const mlstm::Gemm& g, int ta, int tb, int to, long long Z, cudaStream_t stream) {
  const dim3 grid((g.N + mlstm::kTile - 1) / mlstm::kTile, (g.M + mlstm::kTile - 1) / mlstm::kTile,
                  static_cast<unsigned>(Z));
  MLSTM_DISPATCH3(mlstm_bwd_gemm_kernel, ta, tb, to, grid, stream, g);
  return static_cast<int>(cudaGetLastError());
}

// A product over entries z with M rows; a, b as (bs, rs, cs) views.
mlstm::Gemm product(mlstm::Mat a, mlstm::Mat b, void* out, int M, int N, int K, float alpha = 1.f,
                    int kmode = 0) {
  mlstm::Gemm g{};
  g.a = a;
  g.b = b;
  g.out = out;
  g.o_bs = static_cast<long long>(M) * N;
  g.o_rs = N;
  g.alpha = alpha;
  g.M = M;
  g.N = N;
  g.K = K;
  g.kmode = kmode;
  return g;
}

struct Buffers {
  const void *q, *k, *v, *i_raw, *dh;
  const float *hf, *gates, *decay, *scores, *C, *n, *den;
  void *dq, *dk, *dv, *di, *df;
  float *dnum, *dden, *dp, *rowsum, *colsum, *dC, *dn, *partial, *dpk, *gq, *dptq, *hk, *tv,
      *dlog_inter, *dlogw;
};

template <typename T>
int backward(const Buffers& p, int BH, int S, int L, int dqk, int dv, float scale, int dt,
             cudaStream_t stream) {
  const int nc = S / L;
  const long long Z = static_cast<long long>(BH) * nc;
  const long long BS = static_cast<long long>(BH) * S;
  const long long Lq = static_cast<long long>(L) * dqk;
  const long long Lv = static_cast<long long>(L) * dv;
  const long long LL = static_cast<long long>(L) * L;
  const long long Cv = static_cast<long long>(dqk) * dv;
  constexpr int F32 = rt::kFloat32;
  cudaError_t err;
  int rc;

  mlstm_bwd_prep_kernel<T><<<static_cast<unsigned>(BS), kThreads, 0, stream>>>(
      static_cast<const T*>(p.dh), p.hf, p.den, p.gates, p.dnum, p.dden, BS, dv);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  // dC, dn of each chunk's end, in reverse: X = decay X + (inter * scale q)^T B
  const int tiles_m = (dqk + mlstm::kTile - 1) / mlstm::kTile;
  const int tiles_c = tiles_m * ((dv + mlstm::kTile - 1) / mlstm::kTile);
  mlstm::Scan s{};
  s.a = {p.q, Lq, dqk, 1};
  s.a_scale = scale;
  s.a_row = p.gates + 2 * BS;
  s.b = {p.dnum, Lv, dv, 1};
  s.decay = p.decay;
  s.states = p.dC;
  s.partner = p.C;
  s.partial = p.partial;
  s.p_stride = tiles_c + tiles_m;
  s.nc = nc;
  s.L = L;
  s.Dm = dqk;
  s.N = dv;
  s.reverse = 1;
  mlstm_dstate_scan_kernel<T, float><<<dim3(tiles_c, BH), kThreads, 0, stream>>>(s);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  s.b = {p.dden, L, 1, 0};
  s.states = p.dn;
  s.partner = p.n;
  s.p_offset = tiles_c;
  s.N = 1;
  mlstm_dstate_scan_kernel<T, float><<<dim3(tiles_m, BH), kThreads, 0, stream>>>(s);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  // dP: dnum v^T, then the elementwise pass
  if ((rc = gemm(product({p.dnum, Lv, dv, 1}, {p.v, Lv, 1, dv}, p.dp, L, L, dv), F32, dt, F32, Z,
                 stream)))
    return rc;
  mlstm_bwd_ds_kernel<T><<<static_cast<unsigned>(Z), kThreads, 0, stream>>>(
      p.dp, p.scores, p.gates, static_cast<const T*>(p.i_raw), p.dden, p.rowsum, p.colsum, BS, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  // the (L x dqk) products: dP k, dnum C^T, scale dP^T q, v dC^T
  if ((rc = gemm(product({p.dp, LL, L, 1}, {p.k, Lq, dqk, 1}, p.dpk, L, dqk, L, 1.f, 1), F32, dt,
                 F32, Z, stream)))
    return rc;
  if ((rc = gemm(product({p.dnum, Lv, dv, 1}, {p.C, Cv, 1, dv}, p.gq, L, dqk, dv), F32, F32, F32,
                 Z, stream)))
    return rc;
  if ((rc = gemm(product({p.dp, LL, 1, L}, {p.q, Lq, dqk, 1}, p.dptq, L, dqk, L, scale, 2), F32,
                 dt, F32, Z, stream)))
    return rc;
  if ((rc = gemm(product({p.v, Lv, dv, 1}, {p.dC, Cv, 1, dv}, p.hk, L, dqk, dv), dt, F32, F32, Z,
                 stream)))
    return rc;

  // dv = S^T dnum + w (k dC)
  if ((rc = gemm(product({p.scores, LL, 1, L}, {p.dnum, Lv, dv, 1}, p.tv, L, dv, L, 1.f, 2), F32,
                 F32, F32, Z, stream)))
    return rc;
  mlstm::Gemm g = product({p.k, Lq, dqk, 1}, {p.dC, Cv, dv, 1}, p.dv, L, dv, dqk);
  g.bias = p.tv;
  g.row_scale = p.gates + 3 * BS;
  g.rsc_bs = L;
  if ((rc = gemm(g, dt, F32, dt, Z, stream))) return rc;

  mlstm_bwd_combine_kernel<T><<<static_cast<unsigned>(BS), kThreads, 0, stream>>>(
      static_cast<const T*>(p.q), static_cast<const T*>(p.k), p.dpk, p.gq, p.dptq, p.hk, p.n,
      p.dn, p.gates, p.dden, static_cast<T*>(p.dq), static_cast<T*>(p.dk), p.dlog_inter, p.dlogw,
      BS, L, dqk, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  mlstm_bwd_gates_kernel<T><<<static_cast<unsigned>((Z + kGateThreads - 1) / kGateThreads),
                              kGateThreads, 0, stream>>>(
      p.rowsum, p.colsum, p.dlog_inter, p.dlogw, p.partial, tiles_c + tiles_m, p.decay,
      static_cast<T*>(p.di), static_cast<T*>(p.df), Z, L);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ tensor cores
__global__ void __launch_bounds__(mlstm::tc::kThreads)
    mlstm_tc_bwd_rows_kernel(const mlstm::tc::RowsArgs a) {
  mlstm::tc::bwd_rows(a);
}

__global__ void __launch_bounds__(mlstm::tc::kThreads, 1)
    mlstm_tc_bwd_state_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tdh,
                              const mlstm::tc::StateArgs a) {
  mlstm::tc::state_walk<true>(&tq, &tdh, a);
}

__global__ void __launch_bounds__(mlstm::tc::kThreads, 1)
    mlstm_tc_bwd_qside_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdh,
                              const mlstm::tc::QsideArgs a) {
  mlstm::tc::bwd_qside(&tq, &tk, &tv, &tdh, a);
}

__global__ void __launch_bounds__(mlstm::tc::kThreads, 1)
    mlstm_tc_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tdh,
                           const __grid_constant__ CUtensorMap tc,
                           const __grid_constant__ CUtensorMap tps, const mlstm::tc::DqArgs a) {
  mlstm::tc::bwd_dq(&tq, &tk, &tdh, &tc, &tps, a);
}

__global__ void __launch_bounds__(mlstm::tc::kThreads, 1)
    mlstm_tc_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdh,
                            const __grid_constant__ CUtensorMap tdc,
                            const __grid_constant__ CUtensorMap tps,
                            const __grid_constant__ CUtensorMap tsg, const mlstm::tc::DkvArgs a) {
  mlstm::tc::bwd_dkv(&tq, &tk, &tv, &tdh, &tdc, &tps, &tsg, a);
}

__global__ void __launch_bounds__(mlstm::tc::kThreads)
    mlstm_tc_bwd_gates_kernel(const mlstm::tc::GatesBwdArgs a) {
  mlstm::tc::bwd_gates(a);
}

}  // namespace

// Inputs as rt_mlstm_scan takes them, with dh (BH, S, dv) in their storage
// type and the forward's fp32 outputs: hf (the unrounded h), gates, decay,
// scores, C, n, den.  Outputs dq, dk (BH, S, dqk), dv (BH, S, dv), di, df (BH,
// S) in the storage type.  fp32 scratch: dnum (BH, S, dv); dden, rowsum,
// colsum, dlog_inter, dlogw (BH, S); dp (BH, nc, L, L); dC (BH, nc, dqk, dv)
// and dn (BH, nc, dqk) at each chunk's end; partial (BH, nc, P) with P =
// ceil(dqk / 64) (ceil(dv / 64) + 1); dpk, gq, dptq, hk (BH, S, dqk); tv (BH,
// S, dv).  Returns cudaGetLastError() of the first launch that failed, else 0.
extern "C" int rt_mlstm_scan_bwd(const void* q, const void* k, const void* v, const void* i_raw,
                                 const void* dh, const void* hf, const void* gates,
                                 const void* decay, const void* scores, const void* C,
                                 const void* n, const void* den, void* dq, void* dk, void* dv_out,
                                 void* di, void* df, void* dnum, void* dden, void* dp,
                                 void* rowsum, void* colsum, void* dC, void* dn, void* partial,
                                 void* dpk, void* gq, void* dptq, void* hk, void* tv,
                                 void* dlog_inter, void* dlogw, int BH, int S, int L, int dqk,
                                 int dv, float scale, int dtype, void* stream) {
  auto cf = [](const void* x) { return static_cast<const float*>(x); };
  auto f = [](void* x) { return static_cast<float*>(x); };
  const Buffers p{q,        k,         v,        i_raw,          dh,        cf(hf),   cf(gates),
                  cf(decay), cf(scores), cf(C),   cf(n),          cf(den),   dq,       dk,
                  dv_out,   di,        df,       f(dnum),        f(dden),   f(dp),    f(rowsum),
                  f(colsum), f(dC),    f(dn),    f(partial),     f(dpk),    f(gq),    f(dptq),
                  f(hk),    f(tv),     f(dlog_inter), f(dlogw)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kFloat32) return backward<float>(p, BH, S, L, dqk, dv, scale, dtype, s);
  if (dtype == rt::kBFloat16)
    return backward<__nv_bfloat16>(p, BH, S, L, dqk, dv, scale, dtype, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Tensor-core route.  q, k, v and dh: bf16 views as rt_mlstm_scan_tc's q, k
// and v, `strides` their (b, h, s) strides in that order; h (B, S, H, dv)
// bf16, gates, decay, C, n, den and qn as that forward wrote them.  Outputs:
// dq, dk (B, S, H, dqk), dv (B, S, H, dv), di, df (B, S, H), all bf16.
// Scratch: rows (4, BH, S) and dn (BH, nc, dqk) fp32; dC (BH, nc - 1, dqk,
// dv) bf16; partial (BH, nc, tiles(dqk) tiles(dv)) fp32; dps, sg (BH, nc,
// 128, 128) bf16; rowd, cold (BH, S) and pinter, pw (BH, S, tiles(dqk))
// fp32.  Six launches; returns the first error (tensor map, attribute or
// launch), else 0.
extern "C" int rt_mlstm_scan_bwd_tc(const void* q, const void* k, const void* v, const void* dh,
                                    const void* h, const void* gates, const void* decay,
                                    const void* C, const void* n, const void* den, const void* qn,
                                    void* dq, void* dk, void* dv_out, void* di, void* df,
                                    void* rows, void* dC, void* dn, void* partial, void* dps,
                                    void* sg, void* rowd, void* cold, void* pinter, void* pw,
                                    const long long* strides, int B, int H, int S, int dqk,
                                    int dv, float scale, void* stream) {
  namespace tc = mlstm::tc;
  using bf16 = __nv_bfloat16;
  if (S % tc::kL || dqk % 64 || dv % 64 || dqk < 64 || dv < 64 || dqk > tc::kMaxDqk)
    return static_cast<int>(cudaErrorInvalidValue);
  const tc::Dims d{B, H, S, dqk, dv, S / tc::kL};
  const int BH = B * H;
  const int Z = BH * d.nc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap tq, tk, tv, tdh, tcm, tdc, tps, tsg;
  int pq, pk, pv, pdh;
  int rc = tc::map_view(&tq, &pq, q, B, H, S, dqk, strides);
  if (!rc) rc = tc::map_view(&tk, &pk, k, B, H, S, dqk, strides + 3);
  if (!rc) rc = tc::map_view(&tv, &pv, v, B, H, S, dv, strides + 6);
  if (!rc) rc = tc::map_view(&tdh, &pdh, dh, B, H, S, dv, strides + 9);
  // with one chunk there is no carried state: maps that are never read
  if (!rc)
    rc = d.nc > 1 ? hop::map_heads(&tcm, C, BH * (d.nc - 1), dqk, dv, 64)
                  : hop::map_heads(&tcm, q, 1, 64, 64, 64);
  if (!rc)
    rc = d.nc > 1 ? hop::map_heads(&tdc, dC, BH * (d.nc - 1), dqk, dv, 64)
                  : hop::map_heads(&tdc, q, 1, 64, 64, 64);
  if (!rc) rc = hop::map_heads(&tps, dps, Z, tc::kL, tc::kL, tc::kL);
  if (!rc) rc = hop::map_heads(&tsg, sg, Z, tc::kL, tc::kL, tc::kL);
  if (rc) return rc;
  const long long BS = static_cast<long long>(BH) * S;
  const float* g = static_cast<const float*>(gates);
  float* rw = static_cast<float*>(rows);
  const float* dec = static_cast<const float*>(decay);
  const tc::RowsArgs ra{static_cast<const bf16*>(dh), {strides[9], strides[10], strides[11]},
                        static_cast<const bf16*>(h), g, static_cast<const float*>(den), rw, d,
                        scale};
  rc = tc::launch(mlstm_tc_bwd_rows_kernel,
                  dim3(static_cast<unsigned>((BS + tc::kWarps - 1) / tc::kWarps)), 0, st, ra);
  if (rc) return rc;
  const tc::StateArgs sa{rw + 2 * BS, rw + 3 * BS, dec, static_cast<const bf16*>(C),
                         static_cast<const float*>(n), static_cast<bf16*>(dC),
                         static_cast<float*>(dn), static_cast<float*>(partial), pq, pdh, d};
  rc = tc::launch(mlstm_tc_bwd_state_kernel, dim3(tc::tiles(dqk) * tc::tiles(dv), BH),
                  tc::state_smem(), st, tq, tdh, sa);
  if (rc) return rc;
  const tc::QsideArgs qa{g, rw, static_cast<bf16*>(dps), static_cast<bf16*>(sg),
                         static_cast<float*>(rowd), static_cast<float*>(cold), pq, pk, pv, pdh,
                         d, scale};
  rc = tc::launch(mlstm_tc_bwd_qside_kernel, dim3(Z), tc::qside_smem(), st, tq, tk, tv, tdh, qa);
  if (rc) return rc;
  const tc::DqArgs da{g, rw, static_cast<const float*>(n), static_cast<bf16*>(dq),
                      static_cast<float*>(pinter), pq, pk, pdh, d, scale};
  rc = tc::launch(mlstm_tc_bwd_dq_kernel, dim3(Z, tc::tiles(dqk)), tc::grad_smem(), st, tq, tk,
                  tdh, tcm, tps, da);
  if (rc) return rc;
  const tc::DkvArgs ka{g, static_cast<const float*>(dn), static_cast<bf16*>(dk),
                       static_cast<bf16*>(dv_out), static_cast<float*>(pw), pq, pk, pv, pdh, d};
  rc = tc::launch(mlstm_tc_bwd_dkv_kernel, dim3(Z, tc::tiles(dqk) + tc::tiles(dv)),
                  tc::grad_smem(), st, tq, tk, tv, tdh, tdc, tps, tsg, ka);
  if (rc) return rc;
  const tc::GatesBwdArgs gb{g, rw, dec, static_cast<const float*>(qn),
                            static_cast<const float*>(rowd), static_cast<const float*>(cold),
                            static_cast<const float*>(pinter), static_cast<const float*>(pw),
                            static_cast<const float*>(partial), static_cast<bf16*>(di),
                            static_cast<bf16*>(df), d, tc::tiles(dqk) * tc::tiles(dv)};
  return tc::launch(mlstm_tc_bwd_gates_kernel, dim3((Z + tc::kWarps - 1) / tc::kWarps), 0, st,
                    gb);
}
