// L velocity-Verlet steps on the diagonal-quadratic potential
// U(q) = ½ Σ λ q² with a diagonal metric, for a batch of chains, on the
// NVIDIA H100 (sm_90a): kernel `batched_leapfrog`.
//
// Replaces the TPU kernel aehmc_tpu/ops/leapfrog.py:_leapfrog_kernel (:68),
// launched by batched_leapfrog_tpu (:89).  The plain PyTorch version is
// batched_leapfrog_reference in aehmc_tpu_torch/ops/leapfrog.py, and the
// kernel equals it bit for bit: each step is the reference's
//   p½ = p − (ε/2)(λ q);  q' = q + ε (M⁻¹ p½);  p' = p½ − (ε/2)(λ q'),
// every product and sum rounded on its own (no fmaf, built with
// -fmad=false), in the reference's order.
//
// What bounds it on the card: memory.  Every element is independent, so
// the work is 9 flops per element and step against 16 bytes in and out:
// at 10,240 × 100 and L 10, 16.4 MB over 3.35 TB/s, 4.9 µs.
//
// Design.  A 2-D block: x over the column groups of a row (float4 groups
// when dim % 4 == 0 and every pointer is 16-byte aligned, single floats
// otherwise), y over rows, one row a thread.  A thread's columns are
// fixed, so λ and M⁻¹ for them are read once into registers, and its index
// arithmetic is 32-bit (the launcher refuses C·dim ≥ 2^31).  At 10,240 ×
// 100 the grid is 1,024 blocks of 250 threads, every SM full, and one
// warp's L-step arithmetic overlaps another's loads; 2, 4 or 8 rows a
// thread put the same bytes in flight from fewer warps, which then load,
// compute and store in step, and were slower on the card (PERF.md §6).
// Loads and stores take the default cache policy: evict-first ones
// (__ldcs / __stcs), for data a launch touches once, were no faster with
// L2 cold and slower with it warm, where they drop inputs a caller's next
// launch would find in L2 (PERF.md §6).  The L-step recurrences of a
// thread's V elements (V = 4 or 1) are interleaved step by step; each
// element still sees the reference's operations in the reference's order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

// V consecutive floats moved by one load or store, both with the default
// cache policy (__ldg, __stwb)
template <int V>
struct Pack;

template <>
struct Pack<4> {
  float v[4];
  static __device__ __forceinline__ Pack load(const float* p) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    return {{x.x, x.y, x.z, x.w}};
  }
  __device__ __forceinline__ void store(float* p) const {
    __stwb(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
};

template <>
struct Pack<1> {
  float v[1];
  static __device__ __forceinline__ Pack load(const float* p) {
    return {{__ldg(p)}};
  }
  __device__ __forceinline__ void store(float* p) const { __stwb(p, v[0]); }
};

// Block (bx, by): thread (x, y) takes columns x, x + bx, ... (of V floats
// each) of row blockIdx.x · by + y.
template <int V>
__global__ void __launch_bounds__(aehmc::NT)
    batched_leapfrog_kernel(const float* __restrict__ q,
                            const float* __restrict__ p,
                            const float* __restrict__ lam,
                            const float* __restrict__ im, float eps, int L,
                            int dim, int C, float* __restrict__ q_out,
                            float* __restrict__ p_out) {
  const float half = 0.5f * eps;
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  if (row >= C) return;
  for (int col = V * threadIdx.x; col < dim; col += V * blockDim.x) {
    const Pack<V> lm = Pack<V>::load(lam + col);
    const Pack<V> iv = Pack<V>::load(im + col);
    Pack<V> a = Pack<V>::load(q + row * dim + col);
    Pack<V> b = Pack<V>::load(p + row * dim + col);
    for (int s = 0; s < L; ++s) {
#pragma unroll
      for (int c = 0; c < V; ++c) {
        const float ph = b.v[c] - half * (lm.v[c] * a.v[c]);
        a.v[c] = a.v[c] + eps * (iv.v[c] * ph);
        b.v[c] = ph - half * (lm.v[c] * a.v[c]);
      }
    }
    a.store(q_out + row * dim + col);
    b.store(p_out + row * dim + col);
  }
}

template <int V>
cudaError_t launch(const float* q, const float* p, const float* lam,
                   const float* im, float eps, int L, int dim, int C,
                   float* q_out, float* p_out, cudaStream_t stream) {
  const int groups = dim / V;
  const int bx = groups < aehmc::NT ? groups : aehmc::NT;
  const int by = aehmc::NT / bx;
  const dim3 block(bx, by);
  batched_leapfrog_kernel<V><<<(C + by - 1) / by, block, 0, stream>>>(
      q, p, lam, im, eps, L, dim, C, q_out, p_out);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// Kernel 9.  q, p: (C, dim); lam, im: (dim,).
int batched_leapfrog_launch(const float* q, const float* p, const float* lam,
                            const float* im, float eps, int L, int dim,
                            int C, float* q_out, float* p_out, void* stream) {
  if (dim < 1 || C < 1 || L < 0 || (long long)C * dim > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dim % 4 == 0 && aligned16(q) && aligned16(p) && aligned16(lam) &&
      aligned16(im) && aligned16(q_out) && aligned16(p_out))
    return (int)launch<4>(q, p, lam, im, eps, L, dim, C, q_out, p_out, s);
  return (int)launch<1>(q, p, lam, im, eps, L, dim, C, q_out, p_out, s);
}

}  // extern "C"
