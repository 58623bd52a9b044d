// SSD (Mamba-2) chunked scan forward: y = scan(lf, b, x, c), fp32 inside.
//
// Replaces the Pallas kernel _ssd_kernel / ssd_scan_kernel
// (src/repro/kernels/ssd_scan.py).  lf: (B, S, H) fp32 per-step log-decay;
// b, c: (B, S, H, N); x, y: (B, S, H, chd), one storage type; S a multiple of
// the chunk L.  Per chunk of (b, h), with cum the inclusive sum of lf within
// the chunk:
//   y_t = sum_{s<=t} (c_t . b_s) exp(cum_t - cum_s) x_s + exp(cum_t) h c_t,
//   h  <- exp(cum_L) h + sum_s exp(cum_L - cum_s) x_s b_s^T,   h = 0 at first,
// the carried state h being chd x N.
//
// The TPU kernel walks a (BH, chunk) grid in order on one core, keeping h in
// VMEM.  At hymba-1.5b's training shape BH is 16, an eighth of the H100's 132
// SMs, so here only the recurrence is sequential (see ssd.cuh).  What bounds
// it on the H100: bytes (lf, b, x, c read and y, h_last written once: 58 MB a
// call at the training shape, 0.017 ms at 3.35 TB/s; its 2.7 GFLOP of causal
// and state products would take 0.003 ms on the bf16 tensor cores).  Two
// routes, chosen by the wrapper (kernels/ssd_scan.py, route()):
//
// Tensor cores (bf16, chunk 128, N a multiple of 16 up to 64, chd a multiple
// of 8 up to 448, 16-byte aligned), three launches:
//   1. ssd_tc_state_kernel: per chunk and up to four 64-column boxes of x,
//      cum (one thread sums lf in order) and the chunk's own state
//      x^T (w o b) by wgmma, x^T read MN-major from the TMA tile;
//   2. ssd_state_scan_kernel: as below;
//   3. ssd_tc_fwd_out_kernel: per chunk and 128 columns of y, the Gram C B^T
//      by wgmma, masked and decayed in registers, rounded to bf16 as the A
//      operand of G x (x through transpose-B, only the slabs the triangle
//      reaches), added to the read-out C H^T (H rounded to bf16) scaled by
//      exp(cum_t) (ssd.cuh, tc::chunk_out).
// The walk of the states (chd N threads a (b, h), in order over the chunks)
// is what no tile product shortens; it and the out kernel's short,
// serialised phases per block are what is left between this and the bound.
//
// CUDA cores (fp32, other shapes), four launches:
//   1. ssd_cumsum_kernel: one thread per (b, h, chunk) sums lf in order;
//   2. ssd_chunk_state_kernel: each chunk's own state, all chunks at once;
//   3. ssd_state_scan_kernel: one thread per (b, h, state element) walks the
//      chunks, leaving the state at every chunk's start (the backward reads
//      them: BH nc chd N fp32) and h_last;
//   4. ssd_fwd_out_kernel: 64 x 64 tiles of y, all chunks at once: the masked
//      (c b^T) decay Gram of the tile's rows times x, plus the state read-out,
//      fp32 FMAs from shared-memory tiles.
#include "ssd.cuh"

namespace {

constexpr int kThreads = ssd::kBlock;
constexpr int kCumThreads = 128;

__global__ void __launch_bounds__(kCumThreads)
    ssd_cumsum_kernel(const float* __restrict__ lf, float* __restrict__ cum, const ssd::Dims d) {
  const long long z = static_cast<long long>(blockIdx.x) * kCumThreads + threadIdx.x;
  if (z >= static_cast<long long>(d.B) * d.H * d.nc) return;
  const long long bh = z / d.nc;
  const long long s0 = (z % d.nc) * d.L;
  const long long r0 = ssd::row0(d, bh, s0);
  float acc = 0.f;
  for (int t = 0; t < d.L; ++t) {
    acc += lf[r0 + static_cast<long long>(t) * d.H];
    cum[bh * d.S + s0 + t] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_chunk_state_kernel(const ssd::StateArgs a) {
  ssd::chunk_state<T>(a);
}

__global__ void __launch_bounds__(kThreads) ssd_state_scan_kernel(const ssd::ScanArgs a) {
  ssd::state_scan(a);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_fwd_out_kernel(const ssd::OutArgs a) {
  ssd::chunk_out<T>(a);
}

template <typename T>
int forward(const float* lf, const void* b, const void* x, const void* c, void* y, float* h_last,
            float* states, float* cum, const ssd::Dims& d, cudaStream_t stream) {
  const long long Z = static_cast<long long>(d.B) * d.H * d.nc;
  const int BH = d.B * d.H;
  const unsigned col_tiles = (d.chd + ssd::kTile - 1) / ssd::kTile;
  ssd_cumsum_kernel<<<static_cast<unsigned>((Z + kCumThreads - 1) / kCumThreads), kCumThreads, 0,
                      stream>>>(lf, cum, d);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;

  const ssd::StateArgs sa{x, b, cum, states, d, 0};
  rc = ssd::launch(ssd_chunk_state_kernel<T>, dim3(col_tiles, static_cast<unsigned>(Z)),
                   ssd::state_smem(d), stream, sa);
  if (rc) return rc;

  const ssd::ScanArgs scan{states, cum, h_last, d, 0};
  const long long per = static_cast<long long>(d.chd) * d.N;
  rc = ssd::launch(ssd_state_scan_kernel,
                   dim3(static_cast<unsigned>((per + ssd::kBlock - 1) / ssd::kBlock), BH), 0,
                   stream, scan);
  if (rc) return rc;

  const ssd::OutArgs oa{x, b, c, cum, states, y, d, 0};
  const unsigned row_tiles = (d.L + ssd::kTile - 1) / ssd::kTile;
  return ssd::launch(ssd_fwd_out_kernel<T>, dim3(col_tiles, row_tiles, static_cast<unsigned>(Z)),
                     ssd::out_smem(d), stream, oa);
}

// ------------------------------------------------------------ tensor cores
template <int kN16>
__global__ void __launch_bounds__(kThreads)
    ssd_tc_state_kernel(const __grid_constant__ CUtensorMap tx, const ssd::tc::StateArgs a) {
  ssd::tc::chunk_state<kN16>(&tx, a);
}

template <int kN16>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_tc_fwd_out_kernel(const __grid_constant__ CUtensorMap tx,
                          const __grid_constant__ CUtensorMap tc,
                          const __grid_constant__ CUtensorMap tb, const ssd::tc::OutArgs a) {
  ssd::tc::chunk_out<kN16, false>(&tx, &tc, &tb, a);
}

template <int kN16>
int forward_tc(const float* lf, const void* b, const void* x, const void* c, void* y,
               float* h_last, float* states, float* cum, const ssd::Dims& d, cudaStream_t stream) {
  CUtensorMap tx, tb, tc;
  int rc = hop::map_steps(&tx, x, d.B, d.S, d.H, d.chd, 64, ssd::tc::kL);
  if (!rc) rc = hop::map_steps(&tb, b, d.B, d.S, d.H, d.N, 16, ssd::tc::kL);
  if (!rc) rc = hop::map_steps(&tc, c, d.B, d.S, d.H, d.N, 16, ssd::tc::kL);
  if (rc) return rc;
  const unsigned Z = static_cast<unsigned>(d.B * d.H * d.nc);
  const int boxes = (d.chd + 63) / 64;
  const ssd::tc::StateArgs sa{lf, cum, static_cast<const __nv_bfloat16*>(b), states, d};
  rc = ssd::launch(ssd_tc_state_kernel<kN16>,
                   dim3(Z, (boxes + ssd::tc::kStateBoxes - 1) / ssd::tc::kStateBoxes),
                   ssd::tc::state_smem(d), stream, tx, sa);
  if (rc) return rc;
  const ssd::ScanArgs scan{states, cum, h_last, d, 0};
  const long long per = static_cast<long long>(d.chd) * d.N;
  rc = ssd::launch(ssd_state_scan_kernel,
                   dim3(static_cast<unsigned>((per + ssd::kBlock - 1) / ssd::kBlock), d.B * d.H),
                   0, stream, scan);
  if (rc) return rc;
  const ssd::tc::OutArgs oa{cum, states, static_cast<__nv_bfloat16*>(y), d};
  return ssd::launch(ssd_tc_fwd_out_kernel<kN16>, dim3(Z, (d.chd + 127) / 128),
                     ssd::tc::out_smem(d), stream, tx, tc, tb, oa);
}

}  // namespace

// lf: (B, S, H) fp32; b, c: (B, S, H, N); x, y: (B, S, H, chd), storage type
// `dtype`; all contiguous, S a multiple of L <= 128, N <= 64.  fp32 outputs:
// h_last (B, H, chd, N); states (B, H, nc, chd, N), the state at each chunk's
// start; cum (B, H, S), the inclusive sum of lf within each chunk.  Returns
// cudaGetLastError() of the first launch that failed, else 0.
extern "C" int rt_ssd_scan(const void* lf, const void* b, const void* x, const void* c, void* y,
                           void* h_last, void* states, void* cum, int B, int S, int H, int N,
                           int chd, int L, int dtype, void* stream) {
  if (L < 1 || L > ssd::kMaxL || N < 1 || N > ssd::kMaxN || S % L)
    return static_cast<int>(cudaErrorInvalidValue);
  const ssd::Dims d{B, S, H, N, chd, L, S / L};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](void* p) { return static_cast<float*>(p); };
  const float* lff = static_cast<const float*>(lf);
  if (dtype == rt::kFloat32)
    return forward<float>(lff, b, x, c, y, f(h_last), f(states), f(cum), d, s);
  if (dtype == rt::kBFloat16)
    return forward<__nv_bfloat16>(lff, b, x, c, y, f(h_last), f(states), f(cum), d, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Tensor-core route: bf16 b, x, c and y, L = 128, N a multiple of 16 up to
// 64, chd a multiple of 8 up to 448, 16-byte aligned pointers; the other
// arguments as rt_ssd_scan's.  Three launches: each chunk's cum and own state,
// the state walk, y.  Returns the first error (tensor map, attribute or
// launch), else 0.
extern "C" int rt_ssd_scan_tc(const void* lf, const void* b, const void* x, const void* c,
                              void* y, void* h_last, void* states, void* cum, int B, int S, int H,
                              int N, int chd, int L, void* stream) {
  if (L != ssd::tc::kL || S % L || N % 16 || N < 16 || N > ssd::kMaxN || chd % 8 ||
      chd > 64 * ssd::tc::kMaxBoxes)
    return static_cast<int>(cudaErrorInvalidValue);
  const ssd::Dims d{B, S, H, N, chd, L, S / L};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lff = static_cast<const float*>(lf);
  float* hl = static_cast<float*>(h_last);
  float* st = static_cast<float*>(states);
  float* cm = static_cast<float*>(cum);
  switch (N / 16) {
    case 1: return forward_tc<1>(lff, b, x, c, y, hl, st, cm, d, s);
    case 2: return forward_tc<2>(lff, b, x, c, y, hl, st, cm, d, s);
    case 3: return forward_tc<3>(lff, b, x, c, y, hl, st, cm, d, s);
    default: return forward_tc<4>(lff, b, x, c, y, hl, st, cm, d, s);
  }
}
