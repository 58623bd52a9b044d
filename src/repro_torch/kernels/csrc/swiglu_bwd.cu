// The gate of the SwiGLU backward: one elementwise pass in fp32, one cast.
//
// The Pallas swiglu kernel (src/repro/kernels/swiglu.py) is forward only; in
// the JAX package XLA differentiates swiglu (src/repro/models/layers.py).
// The port's backward (kernels/swiglu_bwd.py) leaves its eight products to
// torch.matmul, as the JAX package leaves them to XLA:
//   a = x Wg, b = x Wu, dh = dy Wd^T            (before this kernel)
//   dWd = h^T dy, dWg = x^T da, dWu = x^T db,
//   dx = da Wg^T + db Wu^T                       (after it)
// and this kernel fuses everything between them: from (a, b, dh) it writes
//   h = silu(a) b, da = dh b silu'(a), db = dh silu(a),
// with sig = 1 / (1 + exp(-a)), silu(a) = a sig and silu'(a) = sig (1 + a (1 - sig)).
// What bounds it on the H100: device memory, six N x F arrays read or written
// once; a grid-stride loop with neighbouring threads on neighbouring
// elements keeps the accesses coalesced.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    swiglu_gate_bwd_kernel(const T* __restrict__ a, const T* __restrict__ b,
                           const T* __restrict__ dh, T* __restrict__ h, T* __restrict__ da,
                           T* __restrict__ db, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    const float av = rt::to_float(a[i]);
    const float bv = rt::to_float(b[i]);
    const float g = rt::to_float(dh[i]);
    const float sig = 1.f / (1.f + expf(-av));
    const float silu = av * sig;
    h[i] = rt::from_float<T>(silu * bv);
    da[i] = rt::from_float<T>(g * bv * (sig * (1.f + av * (1.f - sig))));
    db[i] = rt::from_float<T>(g * silu);
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
