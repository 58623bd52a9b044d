// Hopper building blocks shared by the tensor-core kernels (swiglu.cu,
// flash_attention.cu, flash_attention_bwd.cu and, through ssd.cuh, the SSD
// scan's): TMA tensor maps and loads,
// mbarrier rings, named barriers, wgmma shared-memory descriptors and
// instructions, register reallocation, and the attention kernels' tile
// products.
//
// Every operand tile lives in shared memory in the layout that a TMA load
// with 128-byte swizzle writes: rows of 64 bf16 (128 bytes), the 16-byte
// chunks of row r permuted by r % 8, eight rows (1024 bytes) to a swizzle
// atom.  wgmma reads such a tile through a descriptor:
//  - K-major (the contraction axis contiguous: x, h, Q, K): start address
//    plus 32 bytes per 16-deep step inside the 128-byte row; SBO 1024 bytes
//    from one group of 8 rows to the next; LBO unused.
//  - MN-major (the output axis contiguous: the row-major weights, V): the
//    instruction's transpose-B flag; SBO 1024 bytes from one group of 8
//    contraction rows to the next, LBO the bytes from one 64-column box to
//    the next; a 16-deep step is 2048 bytes.
// Tiles start on 1024-byte boundaries, so the descriptors' base offset is 0.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hop {

// ------------------------------------------------------------------ host side
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime, so that the library
// links without -lcuda; null where it is missing.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A bf16 tensor map, 128-byte swizzle unless `swizzle` says otherwise (box[0]
// at most as many bytes as the swizzle span).  dims[0] is the contiguous axis;
// strides[i] is the byte stride of dims[i + 1].  Loads outside dims are
// filled with zeros.  Returns a cudaError_t.
inline int make_map(CUtensorMap* map, const void* base, int rank, const uint64_t* dims,
                    const uint64_t* strides, const uint32_t* box,
                    CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, static_cast<cuuint32_t>(rank),
                        const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// (B H, S, hd) bf16 rows as a 3-D map (hd, S, B H) with box (64, rows, 1): a
// box never crosses a head, and rows past S read as zeros.
inline int map_heads(CUtensorMap* map, const void* base, int bh, int S, int hd, int rows) {
  const uint64_t dims[3] = {static_cast<uint64_t>(hd), static_cast<uint64_t>(S),
                            static_cast<uint64_t>(bh)};
  const uint64_t strides[2] = {static_cast<uint64_t>(hd) * 2, static_cast<uint64_t>(S) * hd * 2};
  const uint32_t box[3] = {64, static_cast<uint32_t>(rows), 1};
  return make_map(map, base, 3, dims, strides, box);
}

// A (B, S, H, F) bf16 tensor as a 4-D map (F, H, S, B) with box (cols, 1,
// rows, 1): a box holds `rows` consecutive steps of one (b, h), never another
// head's; columns past F and steps past S read as zeros.  cols 64 with
// 128-byte swizzle, or 16 (32 bytes) with 32-byte swizzle.
inline int map_steps(CUtensorMap* map, const void* base, int B, int S, int H, int F, int cols,
                     int rows) {
  const uint64_t dims[4] = {static_cast<uint64_t>(F), static_cast<uint64_t>(H),
                            static_cast<uint64_t>(S), static_cast<uint64_t>(B)};
  const uint64_t strides[3] = {static_cast<uint64_t>(F) * 2, static_cast<uint64_t>(H) * F * 2,
                               static_cast<uint64_t>(S) * H * F * 2};
  const uint32_t box[4] = {static_cast<uint32_t>(cols), 1, static_cast<uint32_t>(rows), 1};
  return make_map(map, base, 4, dims, strides, box,
                  cols == 16 ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_128B);
}

// ---------------------------------------------------------------- device side
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte boundary at or after p (the dynamic shared memory's
// start is only 16-byte aligned; the launch asks for 1024 bytes more).
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// After the barriers are initialised, before any thread (or TMA) uses them.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive once and expect `bytes` more from TMA before the phase completes.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.  A wait
// that outlasts any load by far (2^26 polls, each suspended for up to the
// hardware's time limit) traps, so that a fault shows as a launch error and
// not as a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

// One TMA box from the tensor map into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// `bytes` (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, by the TMA's bulk copy; completes on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// Make this thread's generic-proxy writes to shared memory visible to the
// async proxy (wgmma operands, TMA); a barrier after it publishes them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Wait at hardware barrier kId (1..15; 0 is __syncthreads) until kThreads
// threads, whole warps, have arrived.
template <int kId, int kThreads>
__device__ __forceinline__ void named_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(kId), "n"(kThreads) : "memory");
}

// Arrive at hardware barrier kId without waiting: kThreads counts these
// arrivals and a named_sync's threads together.
template <int kId, int kThreads>
__device__ __forceinline__ void named_arrive() {
  asm volatile("bar.arrive %0, %1;\n" ::"n"(kId), "n"(kThreads) : "memory");
}

// A wgmma descriptor of a 128-byte-swizzled tile (layout type 1).
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo, uint32_t sbo) {
  uint64_t d = (smem_u32(p) & 0x3FFFFu) >> 4;
  d |= static_cast<uint64_t>((lbo & 0x3FFFFu) >> 4) << 16;
  d |= static_cast<uint64_t>((sbo & 0x3FFFFu) >> 4) << 32;
  d |= 1ull << 62;
  return d;
}

// A wgmma descriptor of a 32-byte-swizzled K-major tile (layout type 3): rows
// of 16 bf16 (32 bytes), the two 16-byte halves of row r swapped when bit 2 of
// r is set, eight rows (256 bytes) to a swizzle atom; one 16-deep step.
__device__ __forceinline__ uint64_t desc_sw32(const void* p) {
  uint64_t d = (smem_u32(p) & 0x3FFFFu) >> 4;
  d |= static_cast<uint64_t>(1) << 16;    // LBO: unused for a swizzled K-major tile
  d |= static_cast<uint64_t>(256 >> 4) << 32;
  d |= 3ull << 62;
  return d;
}

// Byte offset of element (row, k) of a K-major bf16 tile written by threads
// in the layout TMA writes: 32-byte swizzle (rows of 16) or 128-byte
// swizzle (rows of 64).
__device__ __forceinline__ int sw32_offset(int row, int k) {
  return row * 32 + ((((k >> 3) & 1) ^ ((row >> 2) & 1)) << 4) + (k & 7) * 2;
}
__device__ __forceinline__ int sw128_offset(int row, int k) {
  return row * 128 + ((((k >> 3) & 7) ^ (row & 7)) << 4) + (k & 7) * 2;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Tie registers to this point of the instruction stream: the compiler may not
// move their reads or writes across it (the wgmma in flight writes them
// behind its back).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Give up / take registers for the rest of a warp-specialised kernel; all
// four warps of the warpgroup call it together.
template <int R>
__device__ __forceinline__ void regs_release() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_claim() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Transpose 4 x 4 32-bit values across a quad of lanes (lanes 4 q .. 4 q + 3
// of a warp): lane t ends with lane k's v[t] in v[k].  Two rounds of two
// shuffles: swap the off-diagonal 2 x 2 blocks between lanes t and t ^ 2,
// then transpose each 2 x 2 block between lanes t and t ^ 1.  Every lane of
// the warp calls it.
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const uint32_t got = __shfl_xor_sync(0xffffffffu, (t & 2) ? v[k] : v[k + 2], 2);
    if (t & 2)
      v[k] = got;
    else
      v[k + 2] = got;
  }
#pragma unroll
  for (int k = 0; k < 4; k += 2) {
    const uint32_t got = __shfl_xor_sync(0xffffffffu, (t & 1) ? v[k] : v[k + 1], 1);
    if (t & 1)
      v[k] = got;
    else
      v[k + 1] = got;
  }
}

// The fp32 accumulator of an m64nN wgmma: thread (warp w, lane) of the
// warpgroup holds rows 16 w + lane / 4 (entries 4 j, 4 j + 1) and that row
// + 8 (4 j + 2, 4 j + 3), columns 8 j + 2 (lane % 4) and the next.  The
// register A operand of an m64k16 step has the same rows; its four 32-bit
// registers hold columns (2 t, 2 t + 1) and (2 t + 8, 2 t + 9) of both rows,
// so the accumulator of a product is the A operand of the next.  The four
// lanes of a quad hold the 8 columns 8 j .. 8 j + 7 of a row in 2-column
// pairs; after quad_transpose over four pairs (j0 .. j0 + 3) lane t holds
// all 8 columns of group j0 + t, one 16-byte store, and a row's four lanes
// write 64 contiguous bytes.  Read the other way, 16-byte loads feed the
// accumulator's layout.

// D (64 x 128, fp32) += A (64 x 16, smem) * B (16 x 128, smem); kTnspB = 1: B is
// MN-major.  scale_d = 0: D = A B.
template <int kTnspB>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTnspB));
}

// D (64 x 64, fp32) += A (64 x 16, smem) * B (16 x 64, smem); kTnspB as above.
template <int kTnspB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTnspB));
}

// D (64 x 64, fp32) += A (64 x 16, registers) * B (16 x 64, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D (64 x 128, fp32) += A (64 x 16, registers) * B (16 x 128, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D (64 x 16, fp32) += A (64 x 16, smem) * B (16 x 16, smem); kTnspA = 1: A
// is MN-major (the output rows contiguous), kTnspB likewise for B.
template <int kTnspA, int kTnspB>
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[8], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %11, %12;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTnspA), "n"(kTnspB));
}

// D (64 x 16, fp32) += A (64 x 16, registers) * B (16 x 16, smem, K-major).
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// ------------------------------------- tiles of the attention kernels (kHd 64 or 128)

// The fp32 accumulator of a 64 x kN product as the bf16 A operands of the
// kN / 16 steps of the next product.
template <int kN>
__device__ __forceinline__ void pack_a(uint32_t (&pa)[kN / 16][4], const float (&d)[kN / 2]) {
#pragma unroll
  for (int kk = 0; kk < kN / 16; ++kk) {
    pa[kk][0] = pack_bf16(d[8 * kk], d[8 * kk + 1]);
    pa[kk][1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
    pa[kk][2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
    pa[kk][3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
  }
}

// D (64 x kN, kN 64 or 128) = A B over kHd, both from shared memory and
// K-major: A a 64-row slice of a tile of a_rows rows, B a tile of kN rows,
// each in boxes of 64 columns.
template <int kHd, int kN>
__device__ __forceinline__ void product_ss(float (&d)[kN / 2], const uint8_t* a, int a_rows,
                                           const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < kHd / 16; ++kk) {
    const uint64_t da = desc_sw128(a + (kk / 4) * a_rows * 128 + (kk % 4) * 32, 16, 1024);
    const uint64_t db = desc_sw128(b + (kk / 4) * kN * 128 + (kk % 4) * 32, 16, 1024);
    if constexpr (kN == 128)
      wgmma_ss_n128<0>(d, da, db, kk > 0);
    else
      wgmma_ss_n64<0>(d, da, db, kk > 0);
  }
}

// D (64 x kHd) += A B over kRows: A bf16 registers (pack_a), B a tile of kRows
// rows read through transpose-B (boxes of 64 columns kRows * 128 bytes apart).
template <int kHd, int kRows>
__device__ __forceinline__ void product_rs(float (&d)[kHd / 2],
                                           const uint32_t (&pa)[kRows / 16][4],
                                           const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < kRows / 16; ++kk) {
    const uint64_t db = desc_sw128(b + kk * 2048, kRows * 128, 1024);
    if constexpr (kHd == 64)
      wgmma_rs_n64(d, pa[kk], db, 1);
    else
      wgmma_rs_n128(d, pa[kk], db, 1);
  }
}

}  // namespace hop
