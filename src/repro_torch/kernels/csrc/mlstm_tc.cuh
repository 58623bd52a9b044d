// Tensor-core building blocks of the chunked mLSTM (mlstm_scan.cu,
// mlstm_scan_bwd.cu): the "wgmma" route of kernels/mlstm_scan.py's route(),
// bf16 q, k, v (and dh), chunks of L = 128, dqk and dv multiples of 64.
//
// Layouts.  q, k, v and dh are (B, H, S, F) views whose rows (the last axis)
// are contiguous and whose other strides are multiples of 16 bytes: the
// model's transposed (B, S, H, F) projections as they are, or contiguous
// tensors.  Each is a 4-D TMA map over F and then s, h, b in order of
// stride (map_view); a box is 64 columns by the 128 steps of one chunk of
// one (b, h).  h, dq, dk and dv are written (B, S, H, F) contiguous, di and
// df (B, S, H).  The fp32 side tensors are rows (BH, S), bh = b H + h.  The
// carried states are bf16 slots (BH, nc - 1, dqk, dv): slot c holds C at the
// start of chunk c + 1 (forward) or dC at the end of chunk c (backward);
// n and dn are fp32 (BH, nc, dqk), entry c at chunk c's start (n) or end (dn).
//
// Forward, in the Pallas kernel's algebra (src/repro/kernels/mlstm_scan.py):
// h = num / max(|den|, exp(-m_t)), num = S v + inter (q C), den = rowsum(S) +
// inter (q . n), S = scale (q k^T) o D, D_ts = exp(b_t - b_s + i_s - m_t) on
// s <= t; C <- decay C + (w o k)^T v, n <- decay n + (w o k)^T 1.
//   gates:      one block per (b, h); a warp per chunk sums log_f and takes
//               the running max of i - b by shuffles, one thread carries m
//               over the chunks, then each row's m_t, inter, w and i - b;
//   state_walk: one block per (b, h, 128 rows of dqk, 128 columns of dv)
//               walks the chunks in order with C's tile in fp32 registers:
//               C = decay C + (w o k)^T v by wgmma, k^T the MN-major A
//               operand read from the TMA tile after its rows are scaled by
//               w (rounded to bf16); C goes out in bf16 at each chunk's
//               start, n (fp32, CUDA cores) beside it;
//   fwd_out:    one block per (b, h, chunk, 128 columns of v): P = q k^T and
//               Y = q C streamed over dqk in boxes of 64 (a three-stage TMA
//               ring), q . n on the CUDA cores from the same q boxes; then S
//               = scale P o D masked in registers, den, and h = (inter scale Y
//               + S v) / g with S as two bf16 register A operands (its
//               rounding and the rounding of the rest).
// Backward, ref.mlstm_scan_bwd_ref's factorisation with m held constant:
//   bwd_rows:   per row g = max(|den|, exp(-m_t)), dden = -sign(den)
//               rowsum(dh o h) / g (h the bf16 output), and the row factors
//               inter scale / g and inter dden scale of the state walk;
//   state_walk: in reverse, dC = decay dC + (q o inter scale / g)^T dh, dn
//               likewise, and each tile's share of ddecay = sum(dC_end o
//               C_start) + dn . n;
//   bwd_qside:  per (b, h, chunk): P = q k^T and R = dh v^T, then S, dS = R /
//               g + dden on s <= t, dP = dS o D and dlogD = dS o S with the
//               row and column sums of dlogD; scale dP and S / g go out in
//               bf16 (2 L^2 bytes each a chunk);
//   bwd_dq:     per (b, h, chunk, 128 columns of dqk): dq = (scale inter / g)
//               (dh C^T) + (scale dP) k + scale inter dden n, and the row sums
//               of q o (dh C^T) that feed d inter;
//   bwd_dkv:    per (b, h, chunk, 128 columns of dqk or of dv): dk = w o (v
//               dC^T + dn) + (scale dP)^T q, dv = w o (k dC) + (S / g)^T dh,
//               and the row sums of k o (v dC^T + dn) that feed dw;
//   bwd_gates:  a warp per (b, h, chunk): db, its reverse sum df, and di,
//               each tile's partial sums added in a fixed order.
// Every product with a contraction of 64 or more is a wgmma with fp32
// accumulators on 128-byte-swizzled tiles from TMA; what is rounded to bf16
// before a product is what ref.mlstm_scan_ref and mlstm_scan_bwd_ref round
// with bf16_products.  Every sum is fp32 in a fixed order, with no atomics:
// two runs on the same inputs give the same bits.
#pragma once

#include <limits.h>
#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace mlstm {
namespace tc {

constexpr int kL = 128;              // chunk length of the route
constexpr int kThreads = 256;        // two warpgroups, 64 rows of a tile each
constexpr int kWarps = kThreads / 32;
constexpr int kBox = kL * 128;       // 128 rows x 64 bf16: 16 KB
constexpr int kHalfBox = 64 * 128;   // 64 rows x 64 bf16: 8 KB
constexpr int kTile = 128;           // columns of dqk or dv a block owns
constexpr int kMaxDqk = 1024;        // n's row, held in shared memory by fwd_out

struct Dims {
  int B, H, S, dqk, dv, nc;
};

__host__ __device__ __forceinline__ int tiles(int cols) { return (cols + kTile - 1) / kTile; }

// ----------------------------------------------------------------- host side
// A (B, H, S, F) bf16 view with unit last stride and (b, h, s) strides `st`
// (elements) as a 4-D map: F, then s, h and b in order of stride (an axis of
// size 1 last), box (64, the 128 steps of a chunk, 1, 1).  *perm packs, two
// bits each, which of (s, h, b) is the map's axis 1, 2 and 3.
inline int map_view(CUtensorMap* map, int* perm, const void* base, int B, int H, int S, int F,
                    const long long* st) {
  const long long size[3] = {S, H, B};
  const long long stride[3] = {st[2], st[1], st[0]};
  auto key = [&](int i) { return size[i] == 1 ? LLONG_MAX : stride[i]; };
  int order[3] = {0, 1, 2};
  for (int i = 0; i < 3; ++i)
    for (int j = i + 1; j < 3; ++j)
      if (key(order[j]) < key(order[i])) {
        const int t = order[i];
        order[i] = order[j];
        order[j] = t;
      }
  long long span = F;  // elements the view reaches: the stride of an axis of size 1
  for (int i = 0; i < 3; ++i)
    if (size[i] > 1 && stride[i] * size[i] > span) span = stride[i] * size[i];
  span = (span + 7) / 8 * 8;
  uint64_t dims[4] = {static_cast<uint64_t>(F), 0, 0, 0};
  uint64_t strides[3];
  uint32_t box[4] = {64, 1, 1, 1};
  for (int i = 0; i < 3; ++i) {
    const int ax = order[i];
    dims[i + 1] = static_cast<uint64_t>(size[ax]);
    strides[i] = static_cast<uint64_t>(size[ax] == 1 ? span : stride[ax]) * 2;
    if (ax == 0) box[i + 1] = kL;
  }
  *perm = order[0] | (order[1] << 2) | (order[2] << 4);
  return hop::make_map(map, base, 4, dims, strides, box);
}

// Launch kernel<<<grid, kThreads, smem, stream>>>(args...), raising the
// kernel's dynamic shared-memory limit first where it needs more than 48 KB.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream, const Args&... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// --------------------------------------------------------------- device side
// One box of a map_view map: columns f.., the chunk's steps from s, (h, b).
__device__ __forceinline__ void load_rows(void* dst, const CUtensorMap* map, int perm,
                                          uint64_t* bar, int f, int s, int h, int b) {
  auto pick = [&](int i) { return i == 0 ? s : (i == 1 ? h : b); };
  hop::tma_load_4d(dst, map, bar, f, pick(perm & 3), pick((perm >> 2) & 3),
                   pick((perm >> 4) & 3));
}

// Entries 4 j + e of a thread's share of an m64nN accumulator: row row_a + 8
// (e / 2), column 8 j + 2 (lane % 4) + e % 2.
__device__ __forceinline__ int acc_col(int j, int lane, int e) {
  return 8 * j + 2 * (lane % 4) + (e & 1);
}

__device__ __forceinline__ float2 ld_bf2(const void* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Elements (row, col) and (row, col + 1), col even, of a tile of boxes of 128
// rows x 64 bf16 as TMA writes them.
__device__ __forceinline__ float2 tile_bf2(const uint8_t* tile, int row, int col) {
  return ld_bf2(tile + (col / 64) * kBox + hop::sw128_offset(row, col % 64));
}

// Row r of `boxes` boxes of 128 rows x 64 bf16 times f[r], rounded to bf16, in place.
__device__ __forceinline__ void scale_rows(uint8_t* tile, int boxes, const float* f) {
  for (int e = threadIdx.x; e < boxes * kL * 8; e += kThreads) {
    uint4* p = reinterpret_cast<uint4*>(tile + 16 * e);
    uint4 v = *p;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
    const float s = f[(e >> 3) & (kL - 1)];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(h[i]);
      h[i] = __floats2bfloat162_rn(x.x * s, x.y * s);
    }
    *p = v;
  }
}

// Rows row_a and row_a + 8 of a thread's share of a 64 x 128 fp32
// accumulator, rounded to bf16, 16 bytes a lane (hop::quad_transpose): p0 and
// p1 point at the two rows' column 0 (null: the row is not stored); columns
// at or past `cols` (a multiple of 8) are not stored.  Every lane calls it.
__device__ __forceinline__ void store_rows(const float (&acc)[64], __nv_bfloat16* p0,
                                           __nv_bfloat16* p1, int cols) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    __nv_bfloat16* p = h ? p1 : p0;
#pragma unroll
    for (int jb = 0; jb < 4; ++jb) {
      uint32_t v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int e = 4 * (4 * jb + k) + 2 * h;
        v[k] = hop::pack_bf16(acc[e], acc[e + 1]);
      }
      hop::quad_transpose(v);
      const int c = 8 * (4 * jb + t);
      if (p != nullptr && c < cols)
        *reinterpret_cast<uint4*>(p + c) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

// ---------------------------------------------------------------------- gates
struct GatesArgs {
  const __nv_bfloat16* i_raw;
  const __nv_bfloat16* log_f;
  long long si[3], sf[3];  // (b, h, s) strides of i_raw and log_f, elements
  float* gates;            // (5, BH, S): b, m_t, inter, w, i - b
  float* decay;            // (BH, nc)
  Dims d;
};

inline size_t gates_smem(const Dims& d) { return sizeof(float) * 4 * d.nc; }

// b (the inclusive sum of log_f within chunk c) and r (the running max of i
// - b) at steps 4 lane .. 4 lane + 3 of the chunk, and i there; every call
// gives the same bits.
__device__ __forceinline__ void chunk_gates(const GatesArgs& a, int bb, int hh, int c,
                                            float (&b)[4], float (&r)[4], float (&ii)[4]) {
  const int lane = threadIdx.x & 31;
  const long long s = static_cast<long long>(c) * kL + 4 * lane;
  const __nv_bfloat16* ip = a.i_raw + bb * a.si[0] + hh * a.si[1] + s * a.si[2];
  const __nv_bfloat16* fp = a.log_f + bb * a.sf[0] + hh * a.sf[1] + s * a.sf[2];
  float run = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    ii[j] = __bfloat162float(ip[j * a.si[2]]);
    run += __bfloat162float(fp[j * a.sf[2]]);
    b[j] = run;
  }
  float x = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  float before = __shfl_up_sync(0xffffffffu, x, 1);
  if (lane == 0) before = 0.f;
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    b[j] += before;
    mx = fmaxf(mx, ii[j] - b[j]);
    r[j] = mx;
  }
  float y = mx;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float z = __shfl_up_sync(0xffffffffu, y, o);
    if (lane >= o) y = fmaxf(y, z);
  }
  float mbefore = __shfl_up_sync(0xffffffffu, y, 1);
  if (lane == 0) mbefore = -INFINITY;
#pragma unroll
  for (int j = 0; j < 4; ++j) r[j] = fmaxf(mbefore, r[j]);
}

// grid (BH)
__device__ __forceinline__ void gates(const GatesArgs& a) {
  extern __shared__ float gsm[];
  const Dims& d = a.d;
  float* b_last = gsm;
  float* r_last = b_last + d.nc;
  float* m_prev = r_last + d.nc;
  float* m_next = m_prev + d.nc;
  const int bh = blockIdx.x;
  const int bb = bh / d.H;
  const int hh = bh % d.H;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int c = warp; c < d.nc; c += kWarps) {
    float b[4], r[4], ii[4];
    chunk_gates(a, bb, hh, c, b, r, ii);
    if (lane == 31) {
      b_last[c] = b[3];
      r_last[c] = r[3];
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = rt::kNegInf;
    for (int c = 0; c < d.nc; ++c) {
      const float mn = b_last[c] + fmaxf(m, r_last[c]);
      a.decay[static_cast<long long>(bh) * d.nc + c] = expf(b_last[c] + m - mn);
      m_prev[c] = m;
      m_next[c] = mn;
      m = mn;
    }
  }
  __syncthreads();
  const long long BS = static_cast<long long>(d.B) * d.H * d.S;
  for (int c = warp; c < d.nc; c += kWarps) {
    float b[4], r[4], ii[4];
    chunk_gates(a, bb, hh, c, b, r, ii);
    const float mp = m_prev[c];
    const float mn = m_next[c];
    const float bl = b_last[c];
    float out[5][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float mt = b[j] + fmaxf(mp, r[j]);
      out[0][j] = b[j];
      out[1][j] = mt;
      out[2][j] = expf(b[j] + mp - mt);
      out[3][j] = expf(bl - b[j] + ii[j] - mn);
      out[4][j] = ii[j] - b[j];
    }
    const long long o = static_cast<long long>(bh) * d.S + static_cast<long long>(c) * kL + 4 * lane;
#pragma unroll
    for (int g = 0; g < 5; ++g)
      *reinterpret_cast<float4*>(a.gates + g * BS + o) =
          make_float4(out[g][0], out[g][1], out[g][2], out[g][3]);
  }
}

// ----------------------------------------------------------------- state_walk
struct StateArgs {
  const float* fa;               // (BH, S): factor of row t of X in the product
  const float* fn;               // (BH, S): factor of row t of X in the vector's sum
  const float* decay;            // (BH, nc)
  const __nv_bfloat16* c_start;  // backward: C at chunk starts (slots); forward: null
  const float* n_start;          // backward: n (BH, nc, dqk); forward: null
  __nv_bfloat16* out;            // slots (BH, nc - 1, dqk, dv): C or dC
  float* nout;                   // (BH, nc, dqk): n or dn
  float* partial;                // backward: (BH, nc, tiles) shares of ddecay; forward: null
  int px, py;                    // the perms of X's and Y's maps
  Dims d;
};

constexpr int kStateStages = 2;
constexpr int kStateSlot = 4 * kBox;  // two boxes of X, two of Y

inline size_t state_smem() {
  return 1024 + kStateStages * kStateSlot + sizeof(float) * (4 * kL + kWarps) +
         sizeof(uint64_t) * kStateStages;
}

// grid (tiles(dqk) tiles(dv), BH).  The carried state's tile (rows of dqk,
// columns of dv) in fp32 registers: state = decay state + (fa o X)^T Y over
// each chunk's 128 steps, X the A operand (MN-major, its rows scaled by fa
// and rounded in shared memory), Y the B operand (MN-major); the vector
// (blocks of the first dv tile) vec = decay vec + sum_t fn_t X_t.  Forward
// (kRev false): X = k, Y = v, fa = fn = w, chunks 0 .. nc - 2, the state after
// chunk c into slot c and n entry c + 1 (entry 0 is 0).  Backward: X = q, Y =
// dh, fa = inter scale / g, fn = inter dden scale, chunks nc - 1 .. 1, the
// state after chunk c (dC at chunk c - 1's end) into slot c - 1 and dn entry
// c - 1 (entry nc - 1 is 0); before each update the tile's share of ddecay_c
// = sum(dC o C_c) + dn . n_c (chunks 0 and nc - 1 give 0).
template <bool kRev>
__device__ __forceinline__ void state_walk(const CUtensorMap* tx, const CUtensorMap* ty,
                                           const StateArgs& a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hop::align_1024(smem_raw);
  float* fa = reinterpret_cast<float*>(smem + kStateStages * kStateSlot);
  float* fn = fa + kL;
  float* npart = fn + kL;  // [2][kL]
  float* red = npart + 2 * kL;
  uint64_t* full = reinterpret_cast<uint64_t*>(red + kWarps);
  const Dims& d = a.d;
  const int tiles_n = tiles(d.dv);
  const int tile = blockIdx.x;
  const int dqk0 = (tile / tiles_n) * kTile;
  const int dv0 = (tile % tiles_n) * kTile;
  const int bh = blockIdx.y;
  const int bb = bh / d.H;
  const int hh = bh % d.H;
  const int nbx = min(2, (d.dqk - dqk0) / 64);
  const int nby = min(2, (d.dv - dv0) / 64);
  const int steps = d.nc - 1;
  const int tid = threadIdx.x;
  const bool vec = tile % tiles_n == 0;
  const long long zs = static_cast<long long>(bh) * (d.nc - 1);
  const long long zn = static_cast<long long>(bh) * d.nc;
  auto chunk_of = [&](int st) { return kRev ? d.nc - 1 - st : st; };
  if (tid == 0) {
    for (int i = 0; i < kStateStages; ++i) hop::mbar_init(&full[i], 1);
    hop::mbar_fence_init();
  }
  if (vec && tid < kL && dqk0 + tid < d.dqk)
    a.nout[(zn + (kRev ? d.nc - 1 : 0)) * d.dqk + dqk0 + tid] = 0.f;
  if (kRev && tid == 0) a.partial[zn * gridDim.x + tile] = 0.f;
  __syncthreads();
  auto issue = [&](int st) {
    const int c = chunk_of(st);
    uint8_t* slot = smem + (st % kStateStages) * kStateSlot;
    uint64_t* bar = &full[st % kStateStages];
    hop::mbar_expect_tx(bar, (nbx + nby) * kBox);
    for (int i = 0; i < nbx; ++i)
      load_rows(slot + i * kBox, tx, a.px, bar, dqk0 + 64 * i, c * kL, hh, bb);
    for (int i = 0; i < nby; ++i)
      load_rows(slot + (2 + i) * kBox, ty, a.py, bar, dv0 + 64 * i, c * kL, hh, bb);
  };
  if (tid == 0)
    for (int st = 0; st < min(kStateStages, steps); ++st) issue(st);
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int row_a = 64 * wg + 16 * warp + lane / 4;  // row of dqk within the tile
  float acc[64];
  zero(acc);
  float nval = 0.f;
  for (int st = 0; st < steps; ++st) {
    const int c = chunk_of(st);
    uint8_t* xs = smem + (st % kStateStages) * kStateSlot;
    uint8_t* ys = xs + 2 * kBox;
    const long long row0 = static_cast<long long>(bh) * d.S + static_cast<long long>(c) * kL;
    if (tid < kL)
      fa[tid] = a.fa[row0 + tid];
    else
      fn[tid - kL] = a.fn[row0 + tid - kL];
    const float dec = a.decay[zn + c];
    hop::mbar_wait(&full[st % kStateStages], (st / kStateStages) & 1);
    __syncthreads();
    if (vec) {  // the vector's sum over each half of the steps, X as loaded
      const int col = tid % kL;
      const int half = tid / kL;
      float p = 0.f;
      if (col < 64 * nbx) {
        const uint8_t* box = xs + (col / 64) * kBox;
        for (int t = 64 * half; t < 64 * half + 64; ++t)
          p += fn[t] * __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
                           box + hop::sw128_offset(t, col % 64)));
      }
      npart[half * kL + col] = p;
    }
    float part = 0.f;
    if (kRev && c < d.nc - 1) {  // acc is dC at chunk c's end; C_c sits in slot c - 1
      const __nv_bfloat16* cs = a.c_start + (zs + c - 1) * d.dqk * d.dv;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = dqk0 + row_a + 8 * h;
        if (row >= d.dqk) continue;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = dv0 + acc_col(j, lane, 0);
          if (col >= d.dv) continue;
          const float2 cv = ld_bf2(cs + static_cast<long long>(row) * d.dv + col);
          part += acc[4 * j + 2 * h] * cv.x + acc[4 * j + 2 * h + 1] * cv.y;
        }
      }
    }
    __syncthreads();  // the vector's sums have read X
    scale_rows(xs, nbx, fa);
    hop::fence_proxy_async();
    if (vec && tid < kL) {
      if (kRev && dqk0 + tid < d.dqk) part += nval * a.n_start[(zn + c) * d.dqk + dqk0 + tid];
      nval = dec * nval + (npart[tid] + npart[kL + tid]);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] *= dec;
    hop::fence_regs(acc);
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      hop::wgmma_ss_n128<1, 1>(acc, hop::desc_sw128(xs + wg * kBox + kk * 2048, kBox, 1024),
                               hop::desc_sw128(ys + kk * 2048, kBox, 1024), 1);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(acc);
    const int slot = kRev ? c - 1 : c;
    __nv_bfloat16* o = a.out + (zs + slot) * d.dqk * d.dv + dv0;
    const int r0 = dqk0 + row_a;
    store_rows(acc, r0 < d.dqk ? o + static_cast<long long>(r0) * d.dv : nullptr,
               r0 + 8 < d.dqk ? o + static_cast<long long>(r0 + 8) * d.dv : nullptr,
               d.dv - dv0);
    if (vec && tid < kL && dqk0 + tid < d.dqk)
      a.nout[(zn + (kRev ? c - 1 : c + 1)) * d.dqk + dqk0 + tid] = nval;
    if (kRev) {
      const float total = rt::block_sum(part, red);
      if (tid == 0) a.partial[(zn + c) * gridDim.x + tile] = total;
    }
    __syncthreads();  // the slot is free
    if (tid == 0 && st + kStateStages < steps) issue(st + kStateStages);
  }
}

// -------------------------------------------------------------------- fwd_out
struct OutArgs {
  const float* gates;   // (5, BH, S)
  const float* n;       // (BH, nc, dqk)
  __nv_bfloat16* out;   // (B, S, H, dv)
  float* den;           // (BH, S)
  float* qn;            // (BH, S): scale (q . n)
  int pq, pk, pv;
  Dims d;
  float scale;
};

constexpr int kOutStages = 3;
constexpr int kOutSlot = 3 * kBox;  // a box of q, one of k, two half boxes of C

inline size_t out_smem(const Dims& d) {
  return 1024 + 2 * kBox + kOutStages * kOutSlot + sizeof(float) * (5 * kL + d.dqk) +
         sizeof(uint64_t) * (kOutStages + 1);
}

// grid (BH nc, tiles(dv)); tc: the C slots in boxes of 64 rows (dqk) x 64
// columns (dv).
__device__ __forceinline__ void fwd_out(const CUtensorMap* tq, const CUtensorMap* tk,
                                        const CUtensorMap* tv, const CUtensorMap* tc,
                                        const OutArgs& a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hop::align_1024(smem_raw);
  const Dims& d = a.d;
  uint8_t* vt = smem;  // two boxes: v's 128 steps x 128 columns
  uint8_t* ring = vt + 2 * kBox;
  float* e_s = reinterpret_cast<float*>(ring + kOutStages * kOutSlot);  // i_s - b_s
  float* u_s = e_s + kL;    // b_t - m_t
  float* in_s = u_s + kL;   // inter
  float* fl_s = in_s + kL;  // exp(-m_t)
  float* qn_s = fl_s + kL;  // scale (q_t . n)
  float* n_s = qn_s + kL;   // [dqk]
  uint64_t* bars = reinterpret_cast<uint64_t*>(n_s + d.dqk);  // [0]: v; then the ring
  const long long z = blockIdx.x;
  const int bh = static_cast<int>(z / d.nc);
  const int c = static_cast<int>(z % d.nc);
  const int s0 = c * kL;
  const int bb = bh / d.H;
  const int hh = bh % d.H;
  const int dv0 = blockIdx.y * kTile;
  const int nbv = min(2, (d.dv - dv0) / 64);
  const int steps = d.dqk / 64;
  const bool has_c = c > 0;
  const int zc = bh * (d.nc - 1) + c - 1;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i <= kOutStages; ++i) hop::mbar_init(&bars[i], 1);
    hop::mbar_fence_init();
  }
  __syncthreads();
  auto issue = [&](int st) {
    uint8_t* slot = ring + (st % kOutStages) * kOutSlot;
    uint64_t* bar = &bars[1 + st % kOutStages];
    hop::mbar_expect_tx(bar, 2 * kBox + (has_c ? nbv * kHalfBox : 0));
    load_rows(slot, tq, a.pq, bar, 64 * st, s0, hh, bb);
    load_rows(slot + kBox, tk, a.pk, bar, 64 * st, s0, hh, bb);
    if (has_c)
      for (int i = 0; i < nbv; ++i)
        hop::tma_load_3d(slot + 2 * kBox + i * kHalfBox, tc, bar, dv0 + 64 * i, 64 * st, zc);
  };
  if (tid == 0) {
    hop::mbar_expect_tx(&bars[0], nbv * kBox);
    for (int i = 0; i < nbv; ++i) load_rows(vt + i * kBox, tv, a.pv, &bars[0], dv0 + 64 * i, s0, hh, bb);
    for (int st = 0; st < min(kOutStages, steps); ++st) issue(st);
  }
  const long long BS = static_cast<long long>(d.B) * d.H * d.S;
  const long long row0 = static_cast<long long>(bh) * d.S + s0;
  if (tid < kL) {
    const long long o = row0 + tid;
    const float m = a.gates[BS + o];
    e_s[tid] = a.gates[4 * BS + o];
    u_s[tid] = a.gates[o] - m;
    in_s[tid] = a.gates[2 * BS + o];
    fl_s[tid] = expf(-m);
  }
  for (int j = tid; j < d.dqk; j += kThreads) n_s[j] = a.n[(static_cast<long long>(bh) * d.nc + c) * d.dqk + j];
  __syncthreads();

  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  float P[64], Y[64];
  zero(P);
  zero(Y);
  const int q_row = tid >> 1;  // q . n: two threads a row, 32 columns of each box each
  const int q_half = tid & 1;
  float qpart = 0.f;
  for (int st = 0; st < steps; ++st) {
    uint8_t* slot = ring + (st % kOutStages) * kOutSlot;
    hop::mbar_wait(&bars[1 + st % kOutStages], (st / kOutStages) & 1);
    {
      const uint8_t* qrow = slot + q_row * 128;
#pragma unroll
      for (int pp = 0; pp < 4; ++pp) {
        const int p = 4 * q_half + pp;
        const uint4 v = *reinterpret_cast<const uint4*>(qrow + ((p ^ (q_row & 7)) << 4));
        const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&v);
        const float* nn = n_s + 64 * st + 8 * p;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 x = __bfloat1622float2(h2[i]);
          qpart += x.x * nn[2 * i] + x.y * nn[2 * i + 1];
        }
      }
    }
    hop::fence_regs(P);
    hop::fence_regs(Y);
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = hop::desc_sw128(slot + wg * 64 * 128 + kk * 32, 16, 1024);
      hop::wgmma_ss_n128<0>(P, da, hop::desc_sw128(slot + kBox + kk * 32, 16, 1024), 1);
      if (has_c)
        hop::wgmma_ss_n128<1>(Y, da, hop::desc_sw128(slot + 2 * kBox + kk * 2048, kHalfBox, 1024),
                              1);
    }
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(P);
    hop::fence_regs(Y);
    __syncthreads();  // the slot is free
    if (tid == 0 && st + kOutStages < steps) issue(st + kOutStages);
  }
  qpart += __shfl_xor_sync(0xffffffffu, qpart, 1);
  if (q_half == 0) qn_s[q_row] = a.scale * qpart;
  hop::mbar_wait(&bars[0], 0);
  __syncthreads();

  // S = scale P o D on s <= t, den and g per row
  const int row_a = 64 * wg + 16 * warp + lane / 4;
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row_a + 8 * (e >> 1);
      const int col = acc_col(j, lane, e);
      const float s = col <= r ? P[4 * j + e] * a.scale * expf(u_s[r] + e_s[col]) : 0.f;
      P[4 * j + e] = s;
      rs[e >> 1] += s;
    }
  float den[2], g[2], ysc[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row_a + 8 * h;
    den[h] = quad_sum(rs[h]) + in_s[r] * qn_s[r];
    g[h] = fmaxf(fabsf(den[h]), fl_s[r]);
    ysc[h] = in_s[r] * a.scale;
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) Y[i] *= ysc[(i >> 1) & 1];
  // + S v, S as two bf16 register A operands: its rounding and the rounding
  // of the rest (one rounding loses too much where the causal sum cancels)
  uint32_t pa[8][4], pb[8][4];
  hop::pack_a<128>(pa, P);
#pragma unroll
  for (int i = 0; i < 64; ++i) P[i] -= __bfloat162float(__float2bfloat16(P[i]));
  hop::pack_a<128>(pb, P);
  hop::fence_regs(Y);
  hop::wgmma_fence();
  hop::product_rs<128, 128>(Y, pa, vt);
  hop::product_rs<128, 128>(Y, pb, vt);
  hop::wgmma_commit();
  hop::wgmma_wait<0>();
  hop::fence_regs(Y);
#pragma unroll
  for (int i = 0; i < 64; ++i) Y[i] = Y[i] / g[(i >> 1) & 1];
  auto out_row = [&](int r) {
    return a.out + ((static_cast<long long>(bb) * d.S + s0 + r) * d.H + hh) * d.dv + dv0;
  };
  store_rows(Y, out_row(row_a), out_row(row_a + 8), d.dv - dv0);
  if (blockIdx.y == 0 && (lane & 3) == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row_a + 8 * h;
      a.den[row0 + r] = den[h];
      a.qn[row0 + r] = qn_s[r];
    }
}

// ------------------------------------------------------------------- bwd_rows
struct RowsArgs {
  const __nv_bfloat16* dh;
  long long sdh[3];           // (b, h, s) strides of dh, elements
  const __nv_bfloat16* h;     // (B, S, H, dv): the forward's output
  const float* gates;         // (5, BH, S)
  const float* den;           // (BH, S)
  float* rows;                // (4, BH, S): g, dden, inter scale / g, inter dden scale
  Dims d;
  float scale;
};

// grid (ceil(BH S / 8)): a warp per row
__device__ __forceinline__ void bwd_rows(const RowsArgs& a) {
  const Dims& d = a.d;
  const long long BS = static_cast<long long>(d.B) * d.H * d.S;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= BS) return;
  const long long bh = row / d.S;
  const long long s = row % d.S;
  const long long bb = bh / d.H;
  const long long hh = bh % d.H;
  const __nv_bfloat16* dp = a.dh + bb * a.sdh[0] + hh * a.sdh[1] + s * a.sdh[2];
  const __nv_bfloat16* hp = a.h + ((bb * d.S + s) * d.H + hh) * d.dv;
  float p = 0.f;
  for (int c8 = lane; c8 < d.dv / 8; c8 += 32) {
    const uint4 x = *reinterpret_cast<const uint4*>(dp + 8 * c8);
    const uint4 y = *reinterpret_cast<const uint4*>(hp + 8 * c8);
    const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162* y2 = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 u = __bfloat1622float2(x2[i]);
      const float2 v = __bfloat1622float2(y2[i]);
      p += u.x * v.x + u.y * v.y;
    }
  }
  p = rt::warp_sum(p);
  if (lane == 0) {
    const float m = a.gates[BS + row];
    const float inter = a.gates[2 * BS + row];
    const float den = a.den[row];
    const float floor = expf(-m);
    const float g = fmaxf(fabsf(den), floor);
    const float dden = fabsf(den) > floor ? -copysignf(1.f, den) * p / g : 0.f;
    a.rows[row] = g;
    a.rows[BS + row] = dden;
    a.rows[2 * BS + row] = inter * a.scale / g;
    a.rows[3 * BS + row] = inter * dden * a.scale;
  }
}

// ------------------------------------------------------------------ bwd_qside
struct QsideArgs {
  const float* gates;   // (5, BH, S)
  const float* rows;    // (4, BH, S)
  __nv_bfloat16* dps;   // (BH nc, L, L): scale dP
  __nv_bfloat16* sg;    // (BH nc, L, L): S / g
  float* rowd;          // (BH, S): row sums of dlogD
  float* cold;          // (BH, S): column sums of dlogD
  int pq, pk, pv, pdh;
  Dims d;
  float scale;
};

constexpr int kQsStages = 4;
constexpr int kQsSlot = 2 * kBox;

inline size_t qside_smem() {
  return 1024 + kQsStages * kQsSlot + sizeof(float) * (4 * kL + kWarps * kL) +
         sizeof(uint64_t) * kQsStages;
}

// grid (BH nc): P = q k^T over dqk, then R = dh v^T over dv, one ring.
__device__ __forceinline__ void bwd_qside(const CUtensorMap* tq, const CUtensorMap* tk,
                                          const CUtensorMap* tv, const CUtensorMap* tdh,
                                          const QsideArgs& a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hop::align_1024(smem_raw);
  const Dims& d = a.d;
  float* e_s = reinterpret_cast<float*>(smem + kQsStages * kQsSlot);
  float* u_s = e_s + kL;
  float* g_s = u_s + kL;
  float* dd_s = g_s + kL;
  float* colred = dd_s + kL;  // [kWarps][kL]
  uint64_t* full = reinterpret_cast<uint64_t*>(colred + kWarps * kL);
  const int z = blockIdx.x;
  const int bh = z / d.nc;
  const int c = z % d.nc;
  const int s0 = c * kL;
  const int bb = bh / d.H;
  const int hh = bh % d.H;
  const int nq = d.dqk / 64;
  const int steps = nq + d.dv / 64;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < kQsStages; ++i) hop::mbar_init(&full[i], 1);
    hop::mbar_fence_init();
  }
  __syncthreads();
  auto issue = [&](int st) {
    uint8_t* slot = smem + (st % kQsStages) * kQsSlot;
    uint64_t* bar = &full[st % kQsStages];
    hop::mbar_expect_tx(bar, 2 * kBox);
    if (st < nq) {
      load_rows(slot, tq, a.pq, bar, 64 * st, s0, hh, bb);
      load_rows(slot + kBox, tk, a.pk, bar, 64 * st, s0, hh, bb);
    } else {
      load_rows(slot, tdh, a.pdh, bar, 64 * (st - nq), s0, hh, bb);
      load_rows(slot + kBox, tv, a.pv, bar, 64 * (st - nq), s0, hh, bb);
    }
  };
  if (tid == 0)
    for (int st = 0; st < min(kQsStages, steps); ++st) issue(st);
  const long long BS = static_cast<long long>(d.B) * d.H * d.S;
  const long long row0 = static_cast<long long>(bh) * d.S + s0;
  if (tid < kL) {
    const long long o = row0 + tid;
    e_s[tid] = a.gates[4 * BS + o];
    u_s[tid] = a.gates[o] - a.gates[BS + o];
    g_s[tid] = a.rows[o];
    dd_s[tid] = a.rows[BS + o];
  }
  __syncthreads();
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  float P[64], R[64];
  zero(P);
  zero(R);
  for (int st = 0; st < steps; ++st) {
    uint8_t* slot = smem + (st % kQsStages) * kQsSlot;
    hop::mbar_wait(&full[st % kQsStages], (st / kQsStages) & 1);
    hop::fence_regs(P);
    hop::fence_regs(R);
    hop::wgmma_fence();
    if (st < nq) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hop::wgmma_ss_n128<0>(P, hop::desc_sw128(slot + wg * 64 * 128 + kk * 32, 16, 1024),
                              hop::desc_sw128(slot + kBox + kk * 32, 16, 1024), 1);
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hop::wgmma_ss_n128<0>(R, hop::desc_sw128(slot + wg * 64 * 128 + kk * 32, 16, 1024),
                              hop::desc_sw128(slot + kBox + kk * 32, 16, 1024), 1);
    }
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(P);
    hop::fence_regs(R);
    __syncthreads();
    if (tid == 0 && st + kQsStages < steps) issue(st + kQsStages);
  }

  const int row_a = 64 * wg + 16 * warp + lane / 4;
  float rs[2] = {0.f, 0.f};
  float cp[16][2];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    cp[j][0] = 0.f;
    cp[j][1] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row_a + 8 * (e >> 1);
      const int col = acc_col(j, lane, e);
      float dps = 0.f, sgv = 0.f, dl = 0.f;
      if (col <= r) {
        const float D = expf(u_s[r] + e_s[col]);
        const float S = P[4 * j + e] * a.scale * D;
        const float dS = R[4 * j + e] / g_s[r] + dd_s[r];
        dl = dS * S;
        dps = a.scale * (dS * D);
        sgv = S / g_s[r];
      }
      P[4 * j + e] = dps;
      R[4 * j + e] = sgv;
      rs[e >> 1] += dl;
      cp[j][e & 1] += dl;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float v = quad_sum(rs[h]);
    if ((lane & 3) == 0) a.rowd[row0 + row_a + 8 * h] = v;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      float v = cp[j][k];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < 4) colred[(4 * wg + warp) * kL + 8 * j + 2 * lane + k] = v;
    }
  const long long zt = static_cast<long long>(z) * kL;
  store_rows(P, a.dps + (zt + row_a) * kL, a.dps + (zt + row_a + 8) * kL, kL);
  store_rows(R, a.sg + (zt + row_a) * kL, a.sg + (zt + row_a + 8) * kL, kL);
  __syncthreads();
  if (tid < kL) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += colred[w * kL + tid];
    a.cold[row0 + tid] = s;
  }
}

// --------------------------------------------------------------------- bwd_dq
struct DqArgs {
  const float* gates;   // (5, BH, S)
  const float* rows;    // (4, BH, S)
  const float* n;       // (BH, nc, dqk)
  __nv_bfloat16* dq;    // (B, S, H, dqk)
  float* pinter;        // (BH, S, tiles(dqk)): sum_j q_tj (dh C^T)_tj scale / g_t
  int pq, pk, pdh;
  Dims d;
  float scale;
};

constexpr int kGradStages = 3;
constexpr int kGradSlot = 2 * kBox;

// bwd_dq and bwd_dkv: three fixed tiles of two boxes and a ring
inline size_t grad_smem() {
  return 1024 + 6 * kBox + kGradStages * kGradSlot + sizeof(float) * 4 * kL +
         sizeof(uint64_t) * (kGradStages + 1);
}

// grid (BH nc, tiles(dqk)); tc: the C slots in boxes of 64 rows x 64 columns;
// tps: scale dP in boxes of 128 rows x 64 columns.
__device__ __forceinline__ void bwd_dq(const CUtensorMap* tq, const CUtensorMap* tk,
                                       const CUtensorMap* tdh, const CUtensorMap* tc,
                                       const CUtensorMap* tps, const DqArgs& a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hop::align_1024(smem_raw);
  const Dims& d = a.d;
  uint8_t* qt = smem;           // q's 128 steps x 128 columns of the tile
  uint8_t* kt = qt + 2 * kBox;  // k's
  uint8_t* pt = kt + 2 * kBox;  // scale dP (t x s)
  uint8_t* ring = pt + 2 * kBox;
  float* in_s = reinterpret_cast<float*>(ring + kGradStages * kGradSlot);
  float* g_s = in_s + kL;
  float* dd_s = g_s + kL;
  float* n_s = dd_s + kL;  // [kTile]
  uint64_t* bars = reinterpret_cast<uint64_t*>(n_s + kTile);
  const int z = blockIdx.x;
  const int bh = z / d.nc;
  const int c = z % d.nc;
  const int s0 = c * kL;
  const int bb = bh / d.H;
  const int hh = bh % d.H;
  const int ti = blockIdx.y;
  const int nti = gridDim.y;
  const int dqk0 = ti * kTile;
  const int nbq = min(2, (d.dqk - dqk0) / 64);
  const bool has_c = c > 0;
  const int steps = has_c ? d.dv / 64 : 0;
  const int zc = bh * (d.nc - 1) + c - 1;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i <= kGradStages; ++i) hop::mbar_init(&bars[i], 1);
    hop::mbar_fence_init();
  }
  __syncthreads();
  auto issue = [&](int st) {
    uint8_t* slot = ring + (st % kGradStages) * kGradSlot;
    uint64_t* bar = &bars[1 + st % kGradStages];
    hop::mbar_expect_tx(bar, kBox + nbq * kHalfBox);
    load_rows(slot, tdh, a.pdh, bar, 64 * st, s0, hh, bb);
    for (int i = 0; i < nbq; ++i)
      hop::tma_load_3d(slot + kBox + i * kHalfBox, tc, bar, 64 * st, dqk0 + 64 * i, zc);
  };
  if (tid == 0) {
    hop::mbar_expect_tx(&bars[0], (2 * nbq + 2) * kBox);
    for (int i = 0; i < nbq; ++i) {
      load_rows(qt + i * kBox, tq, a.pq, &bars[0], dqk0 + 64 * i, s0, hh, bb);
      load_rows(kt + i * kBox, tk, a.pk, &bars[0], dqk0 + 64 * i, s0, hh, bb);
    }
    for (int i = 0; i < 2; ++i) hop::tma_load_3d(pt + i * kBox, tps, &bars[0], 64 * i, 0, z);
    for (int st = 0; st < min(kGradStages, steps); ++st) issue(st);
  }
  const long long BS = static_cast<long long>(d.B) * d.H * d.S;
  const long long row0 = static_cast<long long>(bh) * d.S + s0;
  if (tid < kL) {
    const long long o = row0 + tid;
    in_s[tid] = a.gates[2 * BS + o];
    g_s[tid] = a.rows[o];
    dd_s[tid] = a.rows[BS + o];
  } else {
    const int j = tid - kL;
    n_s[j] = dqk0 + j < d.dqk
                 ? a.n[(static_cast<long long>(bh) * d.nc + c) * d.dqk + dqk0 + j]
                 : 0.f;
  }
  __syncthreads();
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  float acc[64];
  zero(acc);
  for (int st = 0; st < steps; ++st) {  // acc = dh C^T over dv
    uint8_t* slot = ring + (st % kGradStages) * kGradSlot;
    hop::mbar_wait(&bars[1 + st % kGradStages], (st / kGradStages) & 1);
    hop::fence_regs(acc);
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hop::wgmma_ss_n128<0>(acc, hop::desc_sw128(slot + wg * 64 * 128 + kk * 32, 16, 1024),
                            hop::desc_sw128(slot + kBox + kk * 32, 16, 1024), 1);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(acc);
    __syncthreads();
    if (tid == 0 && st + kGradStages < steps) issue(st + kGradStages);
  }
  hop::mbar_wait(&bars[0], 0);
  const int row_a = 64 * wg + 16 * warp + lane / 4;
  float f[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // the row sums of q o (dh C^T), then its row factor
    const int r = row_a + 8 * h;
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = acc_col(j, lane, 0);
      if (col < 64 * nbq) {
        const float2 qv = tile_bf2(qt, r, col);
        part += qv.x * acc[4 * j + 2 * h] + qv.y * acc[4 * j + 2 * h + 1];
      }
    }
    part = quad_sum(part);
    if ((lane & 3) == 0) a.pinter[(row0 + r) * nti + ti] = part * a.scale / g_s[r];
    f[h] = a.scale * in_s[r] / g_s[r];
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] *= f[(i >> 1) & 1];
  // + (scale dP) k over the chunk's steps
  hop::fence_regs(acc);
  hop::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    hop::wgmma_ss_n128<1>(
        acc, hop::desc_sw128(pt + (kk / 4) * kBox + wg * 64 * 128 + (kk % 4) * 32, 16, 1024),
        hop::desc_sw128(kt + kk * 2048, kBox, 1024), 1);
  hop::wgmma_commit();
  hop::wgmma_wait<0>();
  hop::fence_regs(acc);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row_a + 8 * h;
    const float fn = a.scale * in_s[r] * dd_s[r];
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) acc[4 * j + 2 * h + e] += fn * n_s[acc_col(j, lane, e)];
  }
  auto out_row = [&](int r) {
    return a.dq + ((static_cast<long long>(bb) * d.S + s0 + r) * d.H + hh) * d.dqk + dqk0;
  };
  store_rows(acc, out_row(row_a), out_row(row_a + 8), d.dqk - dqk0);
}

// -------------------------------------------------------------------- bwd_dkv
struct DkvArgs {
  const float* gates;   // (5, BH, S)
  const float* dn;      // (BH, nc, dqk): dn at each chunk's end
  __nv_bfloat16* dk;    // (B, S, H, dqk)
  __nv_bfloat16* dv;    // (B, S, H, dv)
  float* pw;            // (BH, S, tiles(dqk)): sum_j k_sj (v dC^T + dn)_sj
  int pq, pk, pv, pdh;
  Dims d;
};

// grid (BH nc, tiles(dqk) + tiles(dv)): a dk tile, then the dv tiles.  tc:
// the dC slots in boxes of 64 rows x 64 columns; tps, tsg: scale dP and S / g
// in boxes of 128 rows x 64 columns.
__device__ __forceinline__ void bwd_dkv(const CUtensorMap* tq, const CUtensorMap* tk,
                                        const CUtensorMap* tv, const CUtensorMap* tdh,
                                        const CUtensorMap* tc, const CUtensorMap* tps,
                                        const CUtensorMap* tsg, const DkvArgs& a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hop::align_1024(smem_raw);
  const Dims& d = a.d;
  uint8_t* kt = smem;           // dk tiles: k's 128 steps x the tile's 128 columns
  uint8_t* bt = kt + 2 * kBox;  // the B operand of the last product: q (dk) or dh (dv)
  uint8_t* at = bt + 2 * kBox;  // its A operand, transposed: scale dP (dk) or S / g (dv)
  uint8_t* ring = at + 2 * kBox;
  float* w_s = reinterpret_cast<float*>(ring + kGradStages * kGradSlot);
  float* n_s = w_s + kL;  // [kTile]
  uint64_t* bars = reinterpret_cast<uint64_t*>(n_s + kTile);
  const int z = blockIdx.x;
  const int bh = z / d.nc;
  const int c = z % d.nc;
  const int s0 = c * kL;
  const int bb = bh / d.H;
  const int hh = bh % d.H;
  const int nti = tiles(d.dqk);
  const bool is_k = static_cast<int>(blockIdx.y) < nti;
  const int col0 = (is_k ? blockIdx.y : blockIdx.y - nti) * kTile;
  const int cols = is_k ? d.dqk : d.dv;
  const int nb = min(2, (cols - col0) / 64);
  const bool has_c = c < d.nc - 1;
  const int steps = has_c ? (is_k ? d.dv : d.dqk) / 64 : 0;
  const int zc = bh * (d.nc - 1) + c;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i <= kGradStages; ++i) hop::mbar_init(&bars[i], 1);
    hop::mbar_fence_init();
  }
  __syncthreads();
  auto issue = [&](int st) {
    uint8_t* slot = ring + (st % kGradStages) * kGradSlot;
    uint64_t* bar = &bars[1 + st % kGradStages];
    hop::mbar_expect_tx(bar, kBox + nb * kHalfBox);
    if (is_k) {  // v's box and dC's rows of the tile (K-major over dv)
      load_rows(slot, tv, a.pv, bar, 64 * st, s0, hh, bb);
      for (int i = 0; i < nb; ++i)
        hop::tma_load_3d(slot + kBox + i * kHalfBox, tc, bar, 64 * st, col0 + 64 * i, zc);
    } else {  // k's box and dC's 64 rows by the tile's columns
      load_rows(slot, tk, a.pk, bar, 64 * st, s0, hh, bb);
      for (int i = 0; i < nb; ++i)
        hop::tma_load_3d(slot + kBox + i * kHalfBox, tc, bar, col0 + 64 * i, 64 * st, zc);
    }
  };
  if (tid == 0) {
    hop::mbar_expect_tx(&bars[0], ((is_k ? 2 : 1) * nb + 2) * kBox);
    for (int i = 0; i < nb; ++i) {
      if (is_k) {
        load_rows(kt + i * kBox, tk, a.pk, &bars[0], col0 + 64 * i, s0, hh, bb);
        load_rows(bt + i * kBox, tq, a.pq, &bars[0], col0 + 64 * i, s0, hh, bb);
      } else {
        load_rows(bt + i * kBox, tdh, a.pdh, &bars[0], col0 + 64 * i, s0, hh, bb);
      }
    }
    for (int i = 0; i < 2; ++i)
      hop::tma_load_3d(at + i * kBox, is_k ? tps : tsg, &bars[0], 64 * i, 0, z);
    for (int st = 0; st < min(kGradStages, steps); ++st) issue(st);
  }
  const long long BS = static_cast<long long>(d.B) * d.H * d.S;
  const long long row0 = static_cast<long long>(bh) * d.S + s0;
  if (tid < kL) {
    w_s[tid] = a.gates[3 * BS + row0 + tid];
  } else if (is_k) {
    const int j = tid - kL;
    n_s[j] = col0 + j < d.dqk
                 ? a.dn[(static_cast<long long>(bh) * d.nc + c) * d.dqk + col0 + j]
                 : 0.f;
  }
  __syncthreads();
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  float acc[64];
  zero(acc);
  for (int st = 0; st < steps; ++st) {  // dk: v dC^T over dv; dv: k dC over dqk
    uint8_t* slot = ring + (st % kGradStages) * kGradSlot;
    hop::mbar_wait(&bars[1 + st % kGradStages], (st / kGradStages) & 1);
    hop::fence_regs(acc);
    hop::wgmma_fence();
    if (is_k) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hop::wgmma_ss_n128<0>(acc, hop::desc_sw128(slot + wg * 64 * 128 + kk * 32, 16, 1024),
                              hop::desc_sw128(slot + kBox + kk * 32, 16, 1024), 1);
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hop::wgmma_ss_n128<1>(acc, hop::desc_sw128(slot + wg * 64 * 128 + kk * 32, 16, 1024),
                              hop::desc_sw128(slot + kBox + kk * 2048, kHalfBox, 1024), 1);
    }
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(acc);
    __syncthreads();
    if (tid == 0 && st + kGradStages < steps) issue(st + kGradStages);
  }
  hop::mbar_wait(&bars[0], 0);
  const int row_a = 64 * wg + 16 * warp + lane / 4;
  if (is_k) {  // + dn, and the row sums of k o (v dC^T + dn)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row_a + 8 * h;
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = acc_col(j, lane, 0);
        acc[4 * j + 2 * h] += n_s[col];
        acc[4 * j + 2 * h + 1] += n_s[col + 1];
        if (col < 64 * nb) {
          const float2 kv = tile_bf2(kt, r, col);
          part += kv.x * acc[4 * j + 2 * h] + kv.y * acc[4 * j + 2 * h + 1];
        }
      }
      part = quad_sum(part);
      if ((lane & 3) == 0) a.pw[(row0 + r) * nti + blockIdx.y] = part;
    }
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] *= w_s[row_a + 8 * ((i >> 1) & 1)];
  // + (scale dP)^T q or (S / g)^T dh over the chunk's steps
  hop::fence_regs(acc);
  hop::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    hop::wgmma_ss_n128<1, 1>(acc, hop::desc_sw128(at + wg * kBox + kk * 2048, kBox, 1024),
                             hop::desc_sw128(bt + kk * 2048, kBox, 1024), 1);
  hop::wgmma_commit();
  hop::wgmma_wait<0>();
  hop::fence_regs(acc);
  __nv_bfloat16* base = is_k ? a.dk : a.dv;
  auto out_row = [&](int r) {
    return base + ((static_cast<long long>(bb) * d.S + s0 + r) * d.H + hh) * cols + col0;
  };
  store_rows(acc, out_row(row_a), out_row(row_a + 8), cols - col0);
}

// ------------------------------------------------------------------ bwd_gates
struct GatesBwdArgs {
  const float* gates;    // (5, BH, S)
  const float* rows;     // (4, BH, S)
  const float* decay;    // (BH, nc)
  const float* qn;       // (BH, S)
  const float* rowd;     // (BH, S)
  const float* cold;     // (BH, S)
  const float* pinter;   // (BH, S, tiles(dqk))
  const float* pw;       // (BH, S, tiles(dqk))
  const float* partial;  // (BH, nc, state tiles)
  __nv_bfloat16* di;     // (B, S, H)
  __nv_bfloat16* df;     // (B, S, H)
  Dims d;
  int state_tiles;
};

// grid (ceil(BH nc / 8)): a warp per (b, h, chunk), four steps a lane.
// dinter = inter (sum q o G + dden qn), dw = w sum k o (v dC^T + dn); db =
// rowsum(dlogD) - colsum(dlogD) + dinter - dw, at the last step also + sum
// dw + ddecay decay; df the reverse inclusive sum of db; di = colsum + dw.
__device__ __forceinline__ void bwd_gates(const GatesBwdArgs& a) {
  const Dims& d = a.d;
  const long long BH = static_cast<long long>(d.B) * d.H;
  const long long zz = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (zz >= BH * d.nc) return;
  const long long bh = zz / d.nc;
  const int c = static_cast<int>(zz % d.nc);
  const long long BS = BH * d.S;
  const int nti = tiles(d.dqk);
  float db[4], di[4];
  float wsum = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const long long o = bh * d.S + static_cast<long long>(c) * kL + 4 * lane + j;
    float pi = 0.f, pwv = 0.f;
    for (int t = 0; t < nti; ++t) {
      pi += a.pinter[o * nti + t];
      pwv += a.pw[o * nti + t];
    }
    const float dli = a.gates[2 * BS + o] * (pi + a.rows[BS + o] * a.qn[o]);
    const float dlw = a.gates[3 * BS + o] * pwv;
    const float col = a.cold[o];
    db[j] = a.rowd[o] - col + dli - dlw;
    di[j] = col + dlw;
    wsum += dlw;
  }
  wsum = rt::warp_sum(wsum);
  if (lane == 31) {
    float dd = 0.f;
    for (int t = 0; t < a.state_tiles; ++t) dd += a.partial[zz * a.state_tiles + t];
    db[3] += wsum + dd * a.decay[zz];
  }
  float suf[4];
  float run = 0.f;
#pragma unroll
  for (int j = 3; j >= 0; --j) {
    run += db[j];
    suf[j] = run;
  }
  float x = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_down_sync(0xffffffffu, x, o);
    if (lane + o < 32) x += y;
  }
  float after = __shfl_down_sync(0xffffffffu, x, 1);
  if (lane == 31) after = 0.f;
  const long long bb = bh / d.H;
  const long long hh = bh % d.H;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const long long s = static_cast<long long>(c) * kL + 4 * lane + j;
    const long long o = (bb * d.S + s) * d.H + hh;
    a.df[o] = __float2bfloat16(after + suf[j]);
    a.di[o] = __float2bfloat16(di[j]);
  }
}

}  // namespace tc
}  // namespace mlstm
