// The potential and gradient of the Bayesian logistic regression posterior
// as a device functor, shared by the NUTS, GHMC and fused-HMC kernels:
//   U(q)  = -sum_n [y_n x_n·q - softplus(x_n·q)] + (λ/2) |q|^2,
//   ∇U(q) = Xᵀ(σ(X q) - y) + λ q,
// λ the prior precision (1 for the model of
// aehmc_tpu/models/regression.py:logistic_regression_pg_t, an argument of
// the fused leapfrog kernel).  λ q is a product rounded before the sum, so
// λ = 1 gives the bits of `grad + q`.
//
// The whole block calls pg(dim, ds, rbuf, gpart, q, grad, pot) with its CB
// rows of q (row stride ds floats, in shared memory) and gets CB gradient
// rows and CB potentials back.  rbuf (CB·NT floats) and gpart (2·CB·ds) are
// the functor's shared-memory scratch.
//
// What bounds it: X·q and Xᵀ·r are 2·N·dim fused multiply-adds per chain in
// float32 on the CUDA cores.  X and Xᵀ (400 KB each at 1,000 × 100) stream
// from L2 for every gradient of a block, so the bytes per chain fall as the
// chains per block grow.  Points go in chunks of NT, one thread per point
// for X·q (Xᵀ read coalesced, q as float4 broadcasts from shared memory),
// then one thread per (dimension, half-chunk) for Xᵀ·r.  Reductions run in
// a fixed order and products use explicit fmaf (the build passes
// -fmad=false), so a result does not depend on where the functor is
// inlined.
#pragma once

#include <cuda_bf16.h>

#include "common.cuh"

namespace aehmc {

// x rounded to the nearest bfloat16, back in float32
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// BF16 = true rounds the operands of the two data products to bfloat16, as
// aehmc_tpu/ops/nuts_fused.py:_logistic_pot_grad_builder (:878) does with
// matmul_dtype=bfloat16: q and Xᵀ for the logits, σ − y and X for the
// gradient.  A product of two bfloat16 values is exact in float32, the sums
// stay float32, and so do the prior terms (on the unrounded q).
template <bool BF16>
struct LogisticPGT {
  const float* X;   // (N, dim)
  const float* XT;  // (dim, N)
  const float* y;   // (N,)
  int N;
  float prior_precision;
  static __device__ __forceinline__ float op(float x) {
    if constexpr (BF16) {
      return bf16_round(x);
    } else {
      return x;
    }
  }
  __device__ void operator()(int dim, int ds, float* rbuf, float* gpart,
                             const float* q, float* grad, float* pot) const;
};

using LogisticPG = LogisticPGT<false>;

template <bool BF16>
__device__ void LogisticPGT<BF16>::operator()(int dim, int ds, float* rbuf,
                                             float* gpart, const float* q,
                                             float* grad,
                                             float* pot) const {
  const int t = threadIdx.x;
  float lik[CB];
#pragma unroll
  for (int c = 0; c < CB; ++c) lik[c] = 0.f;
  for (int e = t; e < 2 * CB * ds; e += NT) gpart[e] = 0.f;

  for (int n0 = 0; n0 < N; n0 += NT) {
    // X·q for point n0 + t, all CB chains; then σ − y into rbuf
    const int n = n0 + t;
    if (n < N) {
      float acc[CB];
#pragma unroll
      for (int c = 0; c < CB; ++c) acc[c] = 0.f;
      int d = 0;
      for (; d + 4 <= dim; d += 4) {
        const float x0 = op(__ldg(XT + (size_t)d * N + n));
        const float x1 = op(__ldg(XT + (size_t)(d + 1) * N + n));
        const float x2 = op(__ldg(XT + (size_t)(d + 2) * N + n));
        const float x3 = op(__ldg(XT + (size_t)(d + 3) * N + n));
#pragma unroll
        for (int c = 0; c < CB; ++c) {
          const float4 qv = *reinterpret_cast<const float4*>(q + c * ds + d);
          acc[c] = fmaf(x0, op(qv.x), acc[c]);
          acc[c] = fmaf(x1, op(qv.y), acc[c]);
          acc[c] = fmaf(x2, op(qv.z), acc[c]);
          acc[c] = fmaf(x3, op(qv.w), acc[c]);
        }
      }
      for (; d < dim; ++d) {
        const float x = op(__ldg(XT + (size_t)d * N + n));
#pragma unroll
        for (int c = 0; c < CB; ++c)
          acc[c] = fmaf(x, op(q[c * ds + d]), acc[c]);
      }
      const float yv = __ldg(y + n);
#pragma unroll
      for (int c = 0; c < CB; ++c) {
        const float lg = acc[c];
        const float sp = fmaxf(lg, 0.f) + log1pf(expf(-fabsf(lg)));
        lik[c] += yv * lg - sp;
        rbuf[c * NT + t] = op(1.f / (1.f + expf(-lg)) - yv);
      }
    } else {
#pragma unroll
      for (int c = 0; c < CB; ++c) rbuf[c * NT + t] = 0.f;
    }
    __syncthreads();

    // Xᵀ·r over this chunk: thread (half, dl) sums half the chunk's points
    const int half = t / HALF, dl = t % HALF;
    const int nb = n0 + half * HALF, ne = min(nb + HALF, N);
    for (int dd = dl; dd < dim; dd += HALF) {
      float acc[CB];
#pragma unroll
      for (int c = 0; c < CB; ++c) acc[c] = 0.f;
      int m = nb;
      for (; m + 4 <= ne; m += 4) {
        const float x0 = op(__ldg(X + (size_t)m * dim + dd));
        const float x1 = op(__ldg(X + (size_t)(m + 1) * dim + dd));
        const float x2 = op(__ldg(X + (size_t)(m + 2) * dim + dd));
        const float x3 = op(__ldg(X + (size_t)(m + 3) * dim + dd));
#pragma unroll
        for (int c = 0; c < CB; ++c) {
          const float4 rv =
              *reinterpret_cast<const float4*>(rbuf + c * NT + (m - n0));
          acc[c] = fmaf(x0, rv.x, acc[c]);
          acc[c] = fmaf(x1, rv.y, acc[c]);
          acc[c] = fmaf(x2, rv.z, acc[c]);
          acc[c] = fmaf(x3, rv.w, acc[c]);
        }
      }
      for (; m < ne; ++m) {
        const float x = op(__ldg(X + (size_t)m * dim + dd));
#pragma unroll
        for (int c = 0; c < CB; ++c)
          acc[c] = fmaf(x, rbuf[c * NT + (m - n0)], acc[c]);
      }
#pragma unroll
      for (int c = 0; c < CB; ++c) gpart[(half * CB + c) * ds + dd] += acc[c];
    }
    __syncthreads();
  }

  for (int e = t; e < CB * dim; e += NT) {
    const int c = e / dim, d = e - c * dim;
    grad[c * ds + d] = (gpart[c * ds + d] + gpart[(CB + c) * ds + d]) +
                       prior_precision * q[c * ds + d];
  }
#pragma unroll
  for (int c = 0; c < CB; ++c) rbuf[c * NT + t] = lik[c];
  __syncthreads();
  const int w = t / 32, lane = t % 32;
  float s = 0.f;
  for (int k = lane; k < NT; k += 32) s += rbuf[w * NT + k];
  s = warp_sum(s);
  float qq = 0.f;
  for (int d = lane; d < dim; d += 32) qq += q[w * ds + d] * q[w * ds + d];
  qq = warp_sum(qq);
  if (lane == 0) pot[w] = -s + 0.5f * (prior_precision * qq);
  __syncthreads();
}

}  // namespace aehmc
