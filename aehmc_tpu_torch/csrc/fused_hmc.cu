// L leapfrog steps on the Bayesian logistic regression potential for a
// batch of chains, no Metropolis-Hastings and no randomness, for the NVIDIA
// H100 (sm_90a): kernel `fused_logistic_hmc`.
//
// Replaces the TPU kernel aehmc_tpu/ops/fused_hmc.py:_kernel (:82),
// launched by fused_logistic_hmc_tpu (:109).  The plain PyTorch version is
// fused_logistic_hmc_reference in aehmc_tpu_torch/ops/fused_hmc.py.
//
// What bounds it on the card: L + 1 gradients (one at q0, one per step),
// each 2·N·dim float32 multiply-adds per chain; the state moves once in and
// once out.
//
// Design.  The gradient is the LogisticPG functor (logistic_pg.cuh) with
// the caller's prior precision, one warp per chain and CB = 8 chains per
// block, as in the NUTS and GHMC kernels.  q, p and ∇U stay in shared
// memory for all L steps; q and p are read and written in the standard
// (chains, dim) layout, a chain's row by its warp, coalesced.  The last
// block masks the chains past the end, so any chain count runs here.

#include "logistic_pg.cuh"

using namespace aehmc;

namespace {

__host__ __device__ inline size_t smem_floats(int ds) {
  const size_t V = (size_t)CB * ds;
  return 5 * V + (size_t)CB * NT + CB;  // q, p, g, gpart (2), rbuf, nu
}

__global__ void __launch_bounds__(NT)
    fused_hmc_kernel(LogisticPG pg_fn, const float* q, const float* p,
                     const float* im, float eps, int L, int dim, int C,
                     float* q_out, float* p_out) {
  extern __shared__ float4 smem_raw[];
  const int ds = (dim + 3) / 4 * 4;
  const size_t V = (size_t)CB * ds;
  float* const sq = reinterpret_cast<float*>(smem_raw);
  float* const sp = sq + V;
  float* const sg = sp + V;
  float* const gpart = sg + V;
  float* const rbuf = gpart + 2 * V;
  float* const nu = rbuf + (size_t)CB * NT;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chain = blockIdx.x * CB + w;
  const bool valid = chain < C;
  float* const qr = sq + w * ds;
  float* const pr = sp + w * ds;
  float* const gr = sg + w * ds;
  for (int d = lane; d < dim; d += 32) {
    qr[d] = valid ? q[(size_t)chain * dim + d] : 0.f;
    pr[d] = valid ? p[(size_t)chain * dim + d] : 0.f;
  }
  const float half = 0.5f * eps;
  __syncthreads();
  pg_fn(dim, ds, rbuf, gpart, sq, sg, nu);
  for (int s = 0; s < L; ++s) {
    for (int d = lane; d < dim; d += 32) {
      pr[d] = pr[d] - half * gr[d];
      qr[d] = qr[d] + eps * (__ldg(im + d) * pr[d]);
    }
    __syncthreads();
    pg_fn(dim, ds, rbuf, gpart, sq, sg, nu);
    for (int d = lane; d < dim; d += 32) pr[d] = pr[d] - half * gr[d];
  }
  if (valid) {
    for (int d = lane; d < dim; d += 32) {
      q_out[(size_t)chain * dim + d] = qr[d];
      p_out[(size_t)chain * dim + d] = pr[d];
    }
  }
}

}  // namespace

extern "C" {

// Kernel 8.  q, p: (C, dim); X: (N, dim); XT: (dim, N); y, im: (N,), (dim,).
int fused_hmc_launch(const float* q, const float* p, const float* X,
                     const float* XT, const float* y, const float* im,
                     float eps, int L, float prior_precision, int dim, int N,
                     int C, float* q_out, float* p_out, void* stream) {
  if (dim < 1 || N < 1 || C < 1 || L < 0) return (int)cudaErrorInvalidValue;
  const LogisticPG pg = {X, XT, y, N, prior_precision};
  const size_t smem = smem_floats((dim + 3) / 4 * 4) * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      fused_hmc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_hmc_kernel<<<(C + CB - 1) / CB, NT, smem, (cudaStream_t)stream>>>(
      pg, q, p, im, eps, L, dim, C, q_out, p_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
