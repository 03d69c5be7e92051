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
// Design.  The gradient is the logistic functor (logistic_pg.cuh) with the
// caller's prior precision and X through a shared tile, as in the GHMC
// kernels: one warp per chain, CB = 8 chains per block, two blocks per SM.
// q, p and ∇U stay in shared memory for all L steps; q and p are read and
// written in the standard (chains, dim) layout, a chain's row by its warp,
// coalesced.  The last block masks the chains past the end, so any chain
// count runs here.

#include "logistic_pg.cuh"

using namespace aehmc;

namespace {

__global__ void __launch_bounds__(NT, 2)
    fused_hmc_kernel(LogisticPG pg_fn, const float* q, const float* p,
                     const float* im, float eps, int L, int dim, int C,
                     float* q_out, float* p_out) {
  extern __shared__ float4 smem_raw[];
  const int ds = (dim + 3) / 4 * 4;
  const size_t V = (size_t)CB * ds;
  float* const sq = reinterpret_cast<float*>(smem_raw);
  float* const sp = sq + V;
  float* const sg = sp + V;
  zero_smem(sq, 3 * V);
  PGScratch pgs;
  pgs.carve(sg + V, 0);
  __syncthreads();
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
  pg_fn(pgs, dim, ds, sq, sg);
  for (int s = 0; s < L; ++s) {
    for (int d = lane; d < dim; d += 32) {
      pr[d] = pr[d] - half * gr[d];
      qr[d] = qr[d] + eps * (__ldg(im + d) * pr[d]);
    }
    __syncthreads();
    pg_fn(pgs, dim, ds, sq, sg);
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

// Kernel 8.  q, p: (C, dim); X: (N, row_stride); y, im: (N,), (dim,).
// blocks, points, row_stride and smem are the launch plan's
// (aehmc_tpu_torch/ops/launch_plan.py).
int fused_hmc_launch(const float* q, const float* p, const float* X,
                     const float* y, const float* im, float eps, int L,
                     float prior_precision, int dim, int N, int C,
                     float* q_out, float* p_out, int blocks, int points,
                     int row_stride, int smem, void* stream) {
  if (dim < 1 || N < 1 || C < 1 || L < 0 || (size_t)blocks * CB < (size_t)C)
    return (int)cudaErrorInvalidValue;
  const LogisticPG pg = {X, y, N, row_stride, points, prior_precision};
  const Geometry G = {blocks, points, row_stride, smem};
  return (int)launch_blocks(fused_hmc_kernel, G, (cudaStream_t)stream, pg,
                              q, p, im, eps, L, dim, C, q_out, p_out);
}

}  // extern "C"
