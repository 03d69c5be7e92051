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
// kernels: 8 warps a block and CB = 8 or 16 chains, which the launch plan
// picks from dim alone (16 wherever two blocks of 16 fit on an SM with a
// 128-point tile, ops/launch_plan.py), so a warp takes one or two chains
// (chain j of warp w is the block's chain w + 8·j) and loops over them in
// the updates; two blocks per SM.  q, p and ∇U stay in shared memory for
// all L steps, beside one shared row of M⁻¹; q and p are read and written
// in the standard (chains, dim) layout, a chain's row by its warp,
// coalesced.  X's first chunk is requested at block entry, before the
// state loads, and each gradient but the last requests the next one's
// first chunk as soon as its own tile is read.  The last block masks the
// chains past the end, so any chain count runs here.

#include "logistic_pg.cuh"

using namespace aehmc;

namespace {

template <class PG>
__global__ void __launch_bounds__(NT, 2)
    fused_hmc_kernel(PG pg_fn, const float* q, const float* p,
                     const float* im, float eps, int L, int dim, int C,
                     float* q_out, float* p_out) {
  constexpr int CB = PG::CB;
  extern __shared__ float4 smem_raw[];
  const int ds = (dim + 3) / 4 * 4;
  const size_t V = (size_t)CB * ds;
  float* const sq = reinterpret_cast<float*>(smem_raw);
  float* const sp = sq + V;
  float* const sg = sp + V;
  float* const sim = sg + V;  // M⁻¹, one row for the block
  zero_smem(sq, 3 * V);
  PGScratch pgs;
  pgs.carve<CB>(sim + ds, 0);
  pg_fn.request(pgs);
  for (int d = threadIdx.x; d < dim; d += NT) sim[d] = im[d];
  __syncthreads();
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < CB / NW; ++j) {
    const int c = w + NW * j, chain = blockIdx.x * CB + c;
    const bool valid = chain < C;
    for (int d = lane; d < dim; d += 32) {
      sq[c * ds + d] = valid ? q[(size_t)chain * dim + d] : 0.f;
      sp[c * ds + d] = valid ? p[(size_t)chain * dim + d] : 0.f;
    }
  }
  const float half = 0.5f * eps;
  __syncthreads();
  pg_fn(pgs, dim, ds, sq, sg, L > 0);
  for (int s = 0; s < L; ++s) {
#pragma unroll
    for (int j = 0; j < CB / NW; ++j) {
      float* const qr = sq + (w + NW * j) * ds;
      float* const pr = sp + (w + NW * j) * ds;
      const float* const gr = sg + (w + NW * j) * ds;
      for (int d = lane; d < dim; d += 32) {
        pr[d] = pr[d] - half * gr[d];
        qr[d] = qr[d] + eps * (sim[d] * pr[d]);
      }
    }
    __syncthreads();
    pg_fn(pgs, dim, ds, sq, sg, s + 1 < L);
#pragma unroll
    for (int j = 0; j < CB / NW; ++j) {
      float* const pr = sp + (w + NW * j) * ds;
      const float* const gr = sg + (w + NW * j) * ds;
      for (int d = lane; d < dim; d += 32) pr[d] = pr[d] - half * gr[d];
    }
  }
#pragma unroll
  for (int j = 0; j < CB / NW; ++j) {
    const int c = w + NW * j, chain = blockIdx.x * CB + c;
    if (chain >= C) continue;
    for (int d = lane; d < dim; d += 32) {
      q_out[(size_t)chain * dim + d] = sq[c * ds + d];
      p_out[(size_t)chain * dim + d] = sp[c * ds + d];
    }
  }
}

}  // namespace

extern "C" {

// Kernel 8.  q, p: (C, dim); X: (N, row_stride); y, im: (N,), (dim,).
// blocks, points, row_stride, smem and chains (8 or 16 a block) are the
// launch plan's (aehmc_tpu_torch/ops/launch_plan.py).
int fused_hmc_launch(const float* q, const float* p, const float* X,
                     const float* y, const float* im, float eps, int L,
                     float prior_precision, int dim, int N, int C,
                     float* q_out, float* p_out, int blocks, int points,
                     int row_stride, int smem, int chains,
                     void* stream) {
  const Geometry G = {blocks, points, row_stride, smem, chains};
  if (dim < 1 || N < 1 || C < 1 || L < 0 ||
      (size_t)blocks * chains < (size_t)C || !x_tile_ok(G))
    return (int)cudaErrorInvalidValue;
  return (int)with_functor<false, 8, 16>(
      X, 0, y, N, prior_precision, G, [&](auto pg) {
        return launch_blocks(fused_hmc_kernel<decltype(pg)>, G,
                             (cudaStream_t)stream, pg, q, p, im, eps, L, dim,
                             C, q_out, p_out);
      });
}

// Blocks one SM holds of kernel 8 at `chains` (8 or 16) a block with smem
// bytes of shared memory a block (the occupancy API), or -1 on an error.
int fused_hmc_blocks_per_sm(int chains, int smem) {
  return per_type<false, 8, 16>(0, chains, -1, [&](auto tag) {
    return blocks_per_sm(fused_hmc_kernel<decltype(tag)>, smem);
  });
}

}  // extern "C"
