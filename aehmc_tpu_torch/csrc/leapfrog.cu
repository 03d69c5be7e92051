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
// the work is 10 flops per element and step against 16 bytes in and out.
//
// Design.  One thread per (chain, dim) element runs the whole L-step
// recurrence in registers; λ and M⁻¹ are read once per element.  q and p
// are read and written once, coalesced, in the standard (chains, dim)
// layout.  A grid-stride loop covers any element count.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

__global__ void batched_leapfrog_kernel(const float* q, const float* p,
                                        const float* lam, const float* im,
                                        float eps, int L, int dim, long n,
                                        float* q_out, float* p_out) {
  const float half = 0.5f * eps;
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x) {
    const int d = (int)(i % dim);
    const float lam_d = __ldg(lam + d), im_d = __ldg(im + d);
    float qv = q[i], pv = p[i];
    for (int s = 0; s < L; ++s) {
      const float ph = pv - half * (lam_d * qv);
      qv = qv + eps * (im_d * ph);
      pv = ph - half * (lam_d * qv);
    }
    q_out[i] = qv;
    p_out[i] = pv;
  }
}

}  // namespace

extern "C" {

// Kernel 9.  q, p: (C, dim); lam, im: (dim,).
int batched_leapfrog_launch(const float* q, const float* p, const float* lam,
                            const float* im, float eps, int L, int dim,
                            int C, float* q_out, float* p_out, void* stream) {
  if (dim < 1 || C < 1 || L < 0) return (int)cudaErrorInvalidValue;
  const long n = (long)C * dim;
  const int threads = 256;
  const long blocks = (n + threads - 1) / threads;
  batched_leapfrog_kernel<<<(int)(blocks < 65535 * 32 ? blocks : 65535 * 32),
                            threads, 0, (cudaStream_t)stream>>>(
      q, p, lam, im, eps, L, dim, n, q_out, p_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
