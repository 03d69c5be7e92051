// The potentials and gradients of Neal's funnel and of non-centred eight
// schools as device functors, the template parameter of the NUTS kernels 1
// and 2 (nuts_core.cuh, nuts_fused_small.cu) beside LogisticPGT.
//
// They compute in float32 what the builders of
// aehmc_tpu/models/hierarchical.py compute (neals_funnel_pg_t, :114;
// eight_schools_pg_t, :151), with each product and sum in their order
// (the build passes -fmad=false), expf (not __expf), and sums over the
// chain's coordinates taken in a fixed order, a warp's lanes then a
// butterfly (warp_sum):
//
//   funnel, q = [v, x_1 .. x_{d-1}], d = dim, S = Σ x², e = exp(−v):
//     U     = ½ (v/3)² + (½ S) e + ((d−1)/2) v,
//     ∂U/∂v = v/9 − (½ S) e + (d−1)/2,   ∂U/∂x = x e;
//   eight schools, q = [μ, log τ, θ_raw(J)], J = dim − 2 (8 schools), data
//   y and σ² (J each), τ = exp(log τ), θ = μ + τ θ_raw, r = (θ − y)/σ²:
//     U = ½ (μ/5)² + ½ (log τ/5)² − log τ + Σ ½ θ_raw² + Σ ½ (y − θ)²/σ²,
//     ∂U/∂μ = μ/25 + Σ r,  ∂U/∂log τ = log τ/25 − 1 + τ Σ r θ_raw,
//     ∂U/∂θ_raw = θ_raw + τ r.
//
// What bounds them: nothing of their own.  A gradient is a few dozen
// flops per chain on operands in shared memory, against the NUTS core's
// tree walk around it; neither reads a data matrix, so neither has an X
// tile, a barrier or a bulk copy, and their scratch is the block's CB
// potentials.  The warp of a chain computes that chain (one warp a chain,
// as the core), so no block barrier is needed: a __syncwarp orders the
// chain's gradient row and potential before its warp reads them.  At the
// models' dim 10 that leaves 22 of 32 lanes idle in the elementwise parts.
#pragma once

#include "common.cuh"

namespace aehmc {

// The scratch of a functor with no data tile: the block's potentials.
struct PotScratch {
  float* nu;  // (CB,)
};

// What the two functors share: 8 chains a block (one a warp), the scratch,
// and no X tile in the launch plan's geometry.
struct NoTilePG {
  static constexpr int CB = 8;
  using Scratch = PotScratch;
  static __device__ PotScratch carve_scratch(float* base, int) {
    return PotScratch{base};
  }
  static bool no_tile(const Geometry& G) {
    return G.points == 0 && G.row_stride == 0;
  }
};

struct FunnelPG : NoTilePG {
  bool fits(int dim, const Geometry& G) const {
    return dim >= 1 && no_tile(G);
  }

  __device__ void operator()(const PotScratch& S, int dim, int ds,
                             const float* q, float* grad,
                             bool = false) const {
    const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int c = w; c < CB; c += NW) {
      const float* qc = q + c * ds;
      float* gc = grad + c * ds;
      const float v = qc[0];
      const float e = expf(-v);
      float ss = 0.f;
      for (int d = 1 + lane; d < dim; d += 32) ss += qc[d] * qc[d];
      const float half_se = (0.5f * warp_sum(ss)) * e;
      const float c1 = (float)(dim - 1) * 0.5f;
      if (lane == 0) {
        const float vt = v / 3.0f;
        S.nu[c] = (0.5f * (vt * vt) + half_se) + c1 * v;
        gc[0] = (v / 9.0f - half_se) + c1;
      }
      for (int d = 1 + lane; d < dim; d += 32) gc[d] = qc[d] * e;
    }
    __syncwarp();
  }
};

struct EightSchoolsPG : NoTilePG {
  const float* y;   // (J,): the schools' observed effects
  const float* s2;  // (J,): their variances σ²
  int J;

  bool fits(int dim, const Geometry& G) const {
    return y && s2 && J >= 1 && dim == J + 2 && no_tile(G);
  }

  __device__ void operator()(const PotScratch& S, int dim, int ds,
                             const float* q, float* grad,
                             bool = false) const {
    const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int c = w; c < CB; c += NW) {
      const float* qc = q + c * ds;
      float* gc = grad + c * ds;
      const float mu = qc[0], lt = qc[1];
      const float tau = expf(lt);
      float prior = 0.f, lik = 0.f, rs = 0.f, rts = 0.f;
      for (int j = lane; j < J; j += 32) {
        const float tr = qc[2 + j], yj = __ldg(y + j), sj = __ldg(s2 + j);
        const float theta = mu + tau * tr;
        const float r = (theta - yj) / sj;
        const float dy = yj - theta;
        prior += (0.5f * tr) * tr;
        lik += (0.5f * (dy * dy)) / sj;
        rs += r;
        rts += r * tr;
        gc[2 + j] = tr + tau * r;
      }
      prior = warp_sum(prior);
      lik = warp_sum(lik);
      rs = warp_sum(rs);
      rts = warp_sum(rts);
      if (lane == 0) {
        const float m5 = mu / 5.0f, l5 = lt / 5.0f;
        S.nu[c] =
            (((0.5f * (m5 * m5) + 0.5f * (l5 * l5)) - lt) + prior) + lik;
        gc[0] = mu / 25.0f + rs;
        gc[1] = (lt / 25.0f - 1.0f) + tau * rts;
      }
    }
    __syncwarp();
  }
};

}  // namespace aehmc
