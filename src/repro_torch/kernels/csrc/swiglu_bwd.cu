// The SwiGLU backward's elementwise gate, alone or fused into dh = dy Wd^T.
//
// The Pallas swiglu kernel (src/repro/kernels/swiglu.py) is forward only; in
// the JAX package XLA differentiates swiglu (src/repro/models/layers.py).
// With a = x Wg and b = x Wu, the backward is
//   dh = dy Wd^T,
//   h = silu(a) b, da = dh b silu'(a), db = dh silu(a),
//   dWd = h^T dy, dWg = x^T da, dWu = x^T db, dx = da Wg^T + db Wu^T,
// with sig = 1 / (1 + exp(-a)), silu(a) = a sig and silu'(a) = sig (1 + a (1 - sig)),
// fp32 inside and one cast each of h, da and db.  The wrapper
// (kernels/swiglu_bwd.py) leaves the weight gradients and dx to torch.matmul,
// as the JAX package leaves them to XLA, dx as one addmm.  Two routes:
//
// Tensor cores (swiglu_bwd_tc_kernel; bf16, D and F multiples of 8, 16-byte
// aligned pointers, a and b saved by the forward's tensor-core kernel):
// dh = dy Wd^T by wgmma, and the gate in the epilogue, so dh never reaches
// memory and a, b are not computed again.  Wd is (F, D) row-major, so Wd^T is
// a K-major B operand: TMA boxes of Wd's rows, read with no transpose.  What
// bounds it on the H100: bytes, the five N x F arrays (a, b read; h, da, db
// written: 115 MB at qwen's 4096 x 2816, 0.034 ms) against 2 N D F
// operations (0.024 ms).  The epilogue's arithmetic and traffic are as long
// as the products, so they run beside them, the Hopper "ping-pong" way: the
// kernel is persistent, one block an SM walking tiles of dh of 128 rows x
// 128 columns; a producer warp loads a (128 x 64) dy tile and a (128 x 64) Wd
// tile a stage by TMA into a 6-stage mbarrier ring, in the order the two
// consumer warpgroups take them; warpgroup l % 2 takes the block's l-th tile
// (two m64n128k16 accumulators), and the two issue their products in turn
// (named barriers), so that one's epilogue runs while the other's products
// run.  The epilogue works one accumulator row at a time: it loads the row's
// a and b with 16-byte loads one row ahead (the first beside the last
// products), and stores h, da and db with 16-byte stores, a quad's 64 bytes
// of a row contiguous (hop::quad_transpose).  Loading a and b by TMA into
// shared memory instead leaves room for 3 ring stages, and ran slower at the
// qwen and Hymba shapes.
// Ragged edges: TMA fills out-of-bounds loads with zeros, and the epilogue
// masks the stores.
//
// CUDA cores (swiglu_gate_bwd_kernel; fp32, and bf16 that TMA cannot take):
// dh, a and b come from torch.matmul, and this kernel is the gate alone:
// one pass over six N x F arrays, a grid-stride loop with neighbouring
// threads on neighbouring elements.
#include "common.cuh"
#include "hopper.cuh"

namespace {

// The gate's arithmetic, shared by both routes.  1 + exp(-a) is at least 1
// (or inf, giving sig = 0), so __fdividef is within 2 ulp of the IEEE
// quotient and has none of its slow-path branch and call, which the
// tensor-core kernel's epilogue, beside the products, cannot hide.
__device__ __forceinline__ void gate_bwd(float a, float b, float g, float& h, float& da,
                                         float& db) {
  const float sig = __fdividef(1.f, 1.f + expf(-a));
  const float silu = a * sig;
  h = silu * b;
  da = g * b * (sig * (1.f + a * (1.f - sig)));
  db = g * silu;
}

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    swiglu_gate_bwd_kernel(const T* __restrict__ a, const T* __restrict__ b,
                           const T* __restrict__ dh, T* __restrict__ h, T* __restrict__ da,
                           T* __restrict__ db, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    float hv, dav, dbv;
    gate_bwd(rt::to_float(a[i]), rt::to_float(b[i]), rt::to_float(dh[i]), hv, dav, dbv);
    h[i] = rt::from_float<T>(hv);
    da[i] = rt::from_float<T>(dav);
    db[i] = rt::from_float<T>(dbv);
  }
}

template <typename T>
int launch(const void* a, const void* b, const void* dh, void* h, void* da, void* db,
           long long n, int max_blocks, cudaStream_t s) {
  const long long want = (n + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(want < max_blocks ? want : max_blocks);
  swiglu_gate_bwd_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const T*>(dh),
      static_cast<T*>(h), static_cast<T*>(da), static_cast<T*>(db), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ------------------------------------------------------------ tensor cores
namespace {

constexpr int kBK = 64;                  // contraction (D) per stage: one 128-byte bf16 row
constexpr int kTile = 128;               // rows and columns of a warpgroup's tile of dh
constexpr int kBox = 128 * 64 * 2;       // one (128 rows x 64) bf16 TMA box: 16 KB
constexpr int kStage = 2 * kBox;         // a dy tile and a Wd tile: 32 KB
constexpr int kTcThreads = 3 * 128;      // two consumer warpgroups, then the producer's
constexpr int kStages = 6;
constexpr int kTcSmem = 1024 + kStages * kStage + 2 * kStages * 8;

struct TcArgs {
  int N;                    // rows of dy, a, b, h, da and db
  int D;                    // contraction: columns of dy and of Wd
  int F;                    // columns of a, b, h, da and db; rows of Wd
  int col_tiles;            // tiles of dh along F; tile t is (t / col_tiles, t % col_tiles)
  int tiles;
  const __nv_bfloat16* a;   // (N, F)
  const __nv_bfloat16* b;
  __nv_bfloat16* h;         // (N, F) outputs
  __nv_bfloat16* da;
  __nv_bfloat16* db;
};

// The epilogue works on batches of one accumulator row: row r of dh (tile row
// tr or tr + 8 of an accumulator) and columns n0 .. n0 + 127, acc[4 j + 2 half
// + e] at column n0 + 8 j + 2 (lane % 4) + e.  Lane t of a quad loads (or
// stores) the 16 bytes of column groups 4 jb + t, jb = 0 .. 3, and
// hop::quad_transpose turns them into (or from) the accumulator's pairs.

// a and b of one batch, from device memory (zeros past the edges).
__device__ __forceinline__ void load_ab(uint4 (&la)[4], uint4 (&lb)[4], const TcArgs& args,
                                        int r, int n0) {
#pragma unroll
  for (int jb = 0; jb < 4; ++jb) {
    const int c = n0 + 8 * (4 * jb + threadIdx.x % 4);
    la[jb] = lb[jb] = make_uint4(0, 0, 0, 0);
    if (r < args.N && c < args.F) {
      const size_t at = static_cast<size_t>(r) * args.F + c;
      la[jb] = *reinterpret_cast<const uint4*>(args.a + at);
      lb[jb] = *reinterpret_cast<const uint4*>(args.b + at);
    }
  }
}

// The gate over one batch: h, da and db of row r by 16-byte stores; la, lb
// as load_ab gives them.
__device__ __forceinline__ void gate_row(const float (&acc)[64], int half, uint4 (&la)[4],
                                         uint4 (&lb)[4], const TcArgs& args, int r, int n0) {
#pragma unroll
  for (int jb = 0; jb < 4; ++jb) {
    uint32_t av[4] = {la[jb].x, la[jb].y, la[jb].z, la[jb].w};
    uint32_t bv[4] = {lb[jb].x, lb[jb].y, lb[jb].z, lb[jb].w};
    hop::quad_transpose(av);
    hop::quad_transpose(bv);
    uint32_t hv[4], dav[4], dbv[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 a2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&av[k]));
      const float2 b2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bv[k]));
      const int e = 4 * (4 * jb + k) + 2 * half;
      float h0, da0, db0, h1, da1, db1;
      gate_bwd(a2.x, b2.x, acc[e], h0, da0, db0);
      gate_bwd(a2.y, b2.y, acc[e + 1], h1, da1, db1);
      hv[k] = hop::pack_bf16(h0, h1);
      dav[k] = hop::pack_bf16(da0, da1);
      dbv[k] = hop::pack_bf16(db0, db1);
    }
    hop::quad_transpose(hv);
    hop::quad_transpose(dav);
    hop::quad_transpose(dbv);
    const int c = n0 + 8 * (4 * jb + threadIdx.x % 4);
    if (r < args.N && c < args.F) {  // F a multiple of 8: a group is all in or all out
      const size_t at = static_cast<size_t>(r) * args.F + c;
      *reinterpret_cast<uint4*>(args.h + at) = make_uint4(hv[0], hv[1], hv[2], hv[3]);
      *reinterpret_cast<uint4*>(args.da + at) = make_uint4(dav[0], dav[1], dav[2], dav[3]);
      *reinterpret_cast<uint4*>(args.db + at) = make_uint4(dbv[0], dbv[1], dbv[2], dbv[3]);
    }
  }
}

// Persistent: block c takes tiles c, c + gridDim.x, ... in turn; its l-th tile
// goes to consumer warpgroup l % 2.  tdy: dy (N, D), twd: Wd (F, D), both with
// box (64, 128).  The producer loads the tiles' stages in the order the
// warpgroups consume them.
__global__ void __launch_bounds__(kTcThreads, 1)
    swiglu_bwd_tc_kernel(const __grid_constant__ CUtensorMap tdy,
                         const __grid_constant__ CUtensorMap twd, TcArgs args) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hop::align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStage);
  uint64_t* empty = full + kStages;

  const int nk = (args.D + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 4);  // lane 0 of every warp of the consuming warpgroup
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer warpgroup: one thread starts every load
    hop::regs_release<40>();
    if (threadIdx.x != 256) return;
    int seq = 0;  // stages loaded so far
    for (int tile = blockIdx.x; tile < args.tiles; tile += gridDim.x) {
      const int m0 = tile / args.col_tiles * kTile;
      const int n0 = tile % args.col_tiles * kTile;
      for (int k = 0; k < nk; ++k, ++seq) {
        const int s = seq % kStages;
        if (seq >= kStages) hop::mbar_wait(&empty[s], ((seq / kStages) & 1) ^ 1);
        uint8_t* st = smem + s * kStage;
        hop::mbar_expect_tx(&full[s], kStage);
        hop::tma_load_2d(st, &tdy, &full[s], k * kBK, m0);
        hop::tma_load_2d(st + kBox, &twd, &full[s], k * kBK, n0);
      }
    }
    return;
  }

  // consumer warpgroup wg: rows m0 .. m0 + 127 of each of its tiles, acc0 the
  // first 64 and acc1 the next 64
  hop::regs_claim<232>();
  const int lane = threadIdx.x % 32;
  const int tr = (threadIdx.x % 128) / 32 * 16 + lane / 4;  // row of acc[4 j] in 64
  int seq = 0;  // stages consumed by both warpgroups so far
  int l = 0;
  for (int tile = blockIdx.x; tile < args.tiles; tile += gridDim.x, ++l, seq += nk) {
    if (l % 2 != wg) continue;  // the other warpgroup's tile
    const int m0 = tile / args.col_tiles * kTile;
    const int n0 = tile % args.col_tiles * kTile;
    // the products of tile l start once the other warpgroup has issued tile l - 1's
    if (l > 0) {
      if (wg == 0)
        hop::named_sync<1, 256>();
      else
        hop::named_sync<2, 256>();
    }
    float acc0[64];
    float acc1[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
    for (int k = 0; k < nk; ++k) {
      const int s = (seq + k) % kStages;
      hop::mbar_wait(&full[s], ((seq + k) / kStages) & 1);
      const uint8_t* st = smem + s * kStage;
      hop::fence_regs(acc0);
      hop::fence_regs(acc1);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t d_dy0 = hop::desc_sw128(st + kk * 32, 16, 1024);
        const uint64_t d_dy1 = hop::desc_sw128(st + 64 * 128 + kk * 32, 16, 1024);
        const uint64_t d_wd = hop::desc_sw128(st + kBox + kk * 32, 16, 1024);
        hop::wgmma_ss_n128<0>(acc0, d_dy0, d_wd, 1);
        hop::wgmma_ss_n128<0>(acc1, d_dy1, d_wd, 1);
      }
      hop::wgmma_commit();
      // keep this stage's products in flight; the previous stage is read
      hop::wgmma_wait<1>();
      hop::fence_regs(acc0);
      hop::fence_regs(acc1);
      if (k > 0 && lane == 0) hop::mbar_arrive(&empty[(seq + k - 1) % kStages]);
    }
    // every product of the tile issued: the other warpgroup's tile may start
    if (tile + static_cast<int>(gridDim.x) < args.tiles) {
      if (wg == 0)
        hop::named_arrive<2, 256>();
      else
        hop::named_arrive<1, 256>();
    }
    // the epilogue in four batches (acc0 rows tr, tr + 8, then acc1's), the
    // loads of a and b one batch ahead, the first beside the last products
    uint4 la0[4], lb0[4], la1[4], lb1[4];
    load_ab(la0, lb0, args, m0 + tr, n0);
    hop::wgmma_wait<0>();
    hop::fence_regs(acc0);
    hop::fence_regs(acc1);
    if (lane == 0) hop::mbar_arrive(&empty[(seq + nk - 1) % kStages]);
    load_ab(la1, lb1, args, m0 + tr + 8, n0);
    gate_row(acc0, 0, la0, lb0, args, m0 + tr, n0);
    load_ab(la0, lb0, args, m0 + 64 + tr, n0);
    gate_row(acc0, 1, la1, lb1, args, m0 + tr + 8, n0);
    load_ab(la1, lb1, args, m0 + 64 + tr + 8, n0);
    gate_row(acc1, 0, la0, lb0, args, m0 + 64 + tr, n0);
    gate_row(acc1, 1, la1, lb1, args, m0 + 64 + tr + 8, n0);
  }
}

// A row-major (rows, cols) bf16 matrix as a TMA map with box (64, 128).
int map_rows(CUtensorMap* m, const void* p, int rows, int cols) {
  const uint64_t dims[2] = {static_cast<uint64_t>(cols), static_cast<uint64_t>(rows)};
  const uint64_t strides[1] = {static_cast<uint64_t>(cols) * 2};
  const uint32_t box[2] = {64, 128};
  return hop::make_map(m, p, 2, dims, strides, box);
}

}  // namespace

// a, b, dh, h, da, db: n elements each, contiguous; at most max_blocks blocks
// (> 0).  Returns cudaGetLastError().
extern "C" int rt_swiglu_gate_bwd(const void* a, const void* b, const void* dh, void* h,
                                  void* da, void* db, long long n, int max_blocks, int dtype,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kFloat32) return launch<float>(a, b, dh, h, da, db, n, max_blocks, s);
  if (dtype == rt::kBFloat16)
    return launch<__nv_bfloat16>(a, b, dh, h, da, db, n, max_blocks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Tensor-core route, bf16 only: dy (N, D); wd (F, D); a, b, h, da, db (N, F);
// D and F multiples of 8, every pointer 16-byte aligned; at most `sms` blocks
// (the card's SMs).  Returns the first error (tensor map, attribute or
// launch), else 0.
extern "C" int rt_swiglu_bwd_tc(const void* dy, const void* wd, const void* a, const void* b,
                                void* h, void* da, void* db, int N, int D, int F, int sms,
                                void* stream) {
  CUtensorMap tdy, twd;
  int err = map_rows(&tdy, dy, N, D);
  if (!err) err = map_rows(&twd, wd, F, D);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(swiglu_bwd_tc_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int col_tiles = (F + kTile - 1) / kTile;
  const TcArgs args{N, D, F, col_tiles, (N + kTile - 1) / kTile * col_tiles,
                    static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
                    static_cast<__nv_bfloat16*>(h), static_cast<__nv_bfloat16*>(da),
                    static_cast<__nv_bfloat16*>(db)};
  swiglu_bwd_tc_kernel<<<args.tiles < sms ? args.tiles : sms, kTcThreads, kTcSmem,
                         static_cast<cudaStream_t>(stream)>>>(tdy, twd, args);
  return static_cast<int>(cudaGetLastError());
}
