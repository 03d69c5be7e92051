// The fused HMC transition shared by the GHMC kernels (ghmc_fused.cu:
// `ghmc_transition`, `ghmc_segment`) and the ChEES kernel (chees_fused.cu:
// `chees_transition`): a partial momentum refresh p0 = α p + √(1−α²) ξ with
// ξ ~ N(0, M), L velocity-Verlet steps on the potential functor, then
// Metropolis-Hastings on the energy error.  A rejection flips the momentum.
// ChEES is this transition at α 0, with no momentum carried between calls.
//
// Template parameters of the kernels:
//   STD: the global layout.  false: q, ∇U, p, ξ and a per-chain M⁻¹
//     (dim, C), stats (8, C) (GHMC); true: (C, dim) and (C, 8) (ChEES).  It
//     reaches only the global-memory accessors.
//   DENSE: M⁻¹ (dim, dim) read from global memory (L1/L2), and ξ = L⁻ᵀ z
//     under Philox; otherwise a diagonal M⁻¹ row per chain in shared memory,
//     and ξ = √(1/M⁻¹)·z.
//   PROPOSAL: also write the trajectory's endpoint q_L and velocity
//     M⁻¹ p_L of every chain, accepted or not, unflipped: the ChEES
//     criterion's cross-chain gradient reads them.
//
// What bounds it on the card: the L gradients, each 2·N·dim float32
// multiply-adds per chain (the momentum draw, the trajectory updates and the
// accept test are a few passes over dim floats), at the rate the functor's
// register tiles are fed from shared memory (logistic_pg.cuh).
//
// Design.  One warp per chain, CB = 8 chains per block, the potential
// computed by the whole block for its 8 chains at once.  Every chain of a
// call takes the same L, so no warp idles.  L is a host int (GHMC) or read
// from a device int32 (ChEES, whose driver computes clip(ceil(jitter·h/ε),
// 1, max) on the card, so nothing synchronises the stream).  A block keeps
// q, ∇U, p, the trajectory's q, p, ∇U, a scratch row and the diagonal M⁻¹
// of its chains in shared memory, 8 rows of dim floats per chain, then the
// functor's scratch and its tile of X (81 KB at dim 100 with a 128-point
// tile): two blocks per SM, built for 128 registers a thread, which hold
// the functor's register tiles.  The segment kernel keeps that state across
// its draws and writes each draw's positions (a chain's row contiguous, so
// the warp's store is coalesced) and stats.  The kinetic energy is a warp sum in a
// fixed order and products use explicit fmaf or none (-fmad=false), so a
// segment equals one transition launch per draw bit for bit, and the ChEES
// kernel equals the GHMC one at α 0.  A rejected proposal may hold inf
// positions: the state is kept by a true select.
//
// Randomness is external (ξ and the MH uniform as tensors) or Philox keyed
// by the call's (or draw's) seed on the global chain index: the MOMENTUM
// stream's normals z and the ACCEPT stream's uniform
// (ops/philox.py:ghmc_streams).
#pragma once

#include <utility>

#include "logistic_pg.cuh"

namespace aehmc {
namespace hmc {

struct Params {
  const float* eps;    // (C,)
  const float* alpha;  // (C,), or null for α 0
  const float* im;     // M⁻¹: (dim,), per chain (im_per_chain) or dense
  const float* ms;     // L⁻ᵀ (dim, dim): dense metric under Philox
  int im_per_chain;
  const int* Ld;       // the trip count as a device int32, or null for L
  int L;
  float thr;
  int dim, C;
  int ds;              // row stride in shared memory: dim rounded up to 4
};

// randomness of one transition: external tensors or a Philox key
struct Rand {
  const float* noise;  // ξ ~ N(0, M): (dim, C) or (C, dim)
  const float* ua;     // (C,)
  uint32_t seed;
  int seeded;
};

// Offset of element i of chain c's row of `rows` values in global memory.
template <bool STD>
__device__ __forceinline__ size_t gat(int i, int chain, int rows, int C) {
  return STD ? (size_t)chain * rows + i : (size_t)i * C + chain;
}

struct Smem {
  float *q, *g, *p, *tq, *tp, *tg, *tmp, *im;
  PGScratch pgs;  // the functor's scratch and X tile
};

constexpr int NUM_ROWS = 8;  // row arrays of Smem
constexpr int MIN_BLOCKS = 2;  // blocks per SM the registers must allow

// The rows, zeroed (the functor reads q's padding past dim), then the
// functor's scratch (qb floats of rounded q) and X tile.  Every thread of
// the block calls it.
__device__ inline Smem carve(float* base, int ds, int qb) {
  const size_t V = (size_t)CB * ds;
  zero_smem(base, NUM_ROWS * V);
  Smem s;
  s.pgs.carve(base + NUM_ROWS * V, qb);
  __syncthreads();
  s.q = base;
  s.g = s.q + V;
  s.p = s.g + V;
  s.tq = s.p + V;
  s.tp = s.tq + V;
  s.tg = s.tp + V;
  s.tmp = s.tg + V;
  s.im = s.tmp + V;
  return s;
}

// out = mat v for one chain's row; the warp's lanes own the output
// dimensions
__device__ void apply_dense(const float* mat, const float* v, float* out,
                            int dim, int lane) {
  __syncwarp();
  for (int d = lane; d < dim; d += 32) {
    float acc = 0.f;
    for (int j = 0; j < dim; ++j)
      acc = fmaf(__ldg(mat + (size_t)d * dim + j), v[j], acc);
    out[d] = acc;
  }
  __syncwarp();
}

// out = M⁻¹ p, im the chain's diagonal row
template <bool DENSE>
__device__ void apply_im(const Params& P, const float* im, const float* p,
                         float* out, int lane) {
  if constexpr (DENSE) {
    apply_dense(P.im, p, out, P.dim, lane);
  } else {
    for (int d = lane; d < P.dim; d += 32) out[d] = im[d] * p[d];
    __syncwarp();
  }
}

// 0.5 pᵀ M⁻¹ p, tmp a scratch row
template <bool DENSE>
__device__ float kinetic(const Params& P, const float* im, const float* p,
                         float* tmp, int lane) {
  float acc = 0.f;
  if constexpr (DENSE) {
    apply_dense(P.im, p, tmp, P.dim, lane);
    for (int d = lane; d < P.dim; d += 32) acc += p[d] * tmp[d];
  } else {
    for (int d = lane; d < P.dim; d += 32) acc += p[d] * (im[d] * p[d]);
  }
  return 0.5f * warp_sum(acc);
}

struct Stats {
  float energy, accept, div;
};

// One transition of the block's chains.  On entry q, g, p hold each warp's
// chain state and u its potential; on exit they hold the new state (p
// flipped on rejection), and tq, tp the trajectory's endpoint.
template <class PG, bool STD, bool DENSE>
__device__ Stats transition(const Params& P, const PG& pg_fn, const Smem& S,
                            const Rand& R, int L, int chain, bool valid,
                            float& u) {
  const int t = threadIdx.x, w = t / 32, lane = t % 32;
  const int dim = P.dim, ds = P.ds;
  float* const q = S.q + w * ds;
  float* const g = S.g + w * ds;
  float* const p = S.p + w * ds;
  float* const tq = S.tq + w * ds;
  float* const tp = S.tp + w * ds;
  float* const tg = S.tg + w * ds;
  float* const tmp = S.tmp + w * ds;
  const float* const im = S.im + w * ds;
  const float eps = valid ? P.eps[chain] : 0.f;
  const float alpha = valid && P.alpha ? P.alpha[chain] : 0.f;
  const float h = 0.5f * eps;
  float e0 = 0.f, un = u;

  if (valid) {  // the partial refresh into p; z in tmp, L⁻ᵀ z in tp
    if (R.seeded) {
      normal_row((uint32_t)chain, R.seed, dim, lane, tmp);
      __syncwarp();
      if constexpr (DENSE) apply_dense(P.ms, tmp, tp, dim, lane);
    }
    const float beta = sqrtf(1.0f - alpha * alpha);
    for (int d = lane; d < dim; d += 32) {
      float xi;
      if (!R.seeded)
        xi = R.noise[gat<STD>(d, chain, dim, P.C)];
      else if constexpr (DENSE)
        xi = tp[d];
      else
        xi = sqrtf(1.0f / im[d]) * tmp[d];
      p[d] = alpha * p[d] + beta * xi;
    }
    __syncwarp();
    e0 = u + kinetic<DENSE>(P, im, p, tmp, lane);
  }
  for (int d = lane; d < dim; d += 32) {  // the trajectory starts at (q, p)
    tq[d] = q[d];
    tp[d] = p[d];
    tg[d] = g[d];
  }
  for (int s = 0; s < L; ++s) {  // every chain of the block takes L steps
    if (valid) {
      for (int d = lane; d < dim; d += 32) {
        tp[d] = tp[d] - h * tg[d];
        if constexpr (!DENSE) tq[d] = tq[d] + eps * (im[d] * tp[d]);
      }
      if constexpr (DENSE) {
        apply_dense(P.im, tp, tmp, dim, lane);
        for (int d = lane; d < dim; d += 32) tq[d] = tq[d] + eps * tmp[d];
      }
    }
    __syncthreads();
    pg_fn(S.pgs, dim, ds, S.tq, S.tg);
    if (valid) {
      un = S.pgs.nu[w];
      un = un != un ? -NEG_INF : clip(un);
      for (int d = lane; d < dim; d += 32) {
        float gd = tg[d];
        gd = gd != gd ? 0.f : clip(gd);
        tg[d] = gd;
        tp[d] = tp[d] - h * gd;
      }
      __syncwarp();
    }
  }

  Stats st = {0.f, 0.f, 0.f};
  if (valid) {  // MH on the energy error; a divergence does not veto
    const float e1 = clip(un + kinetic<DENSE>(P, im, tp, tmp, lane));
    float delta = e0 - e1;
    delta = delta != delta ? NEG_INF : clip(delta);
    st.div = fabsf(delta) > P.thr ? 1.f : 0.f;
    st.accept = fminf(1.0f, expf(delta));
    const float ua = R.seeded ? u01(philox((uint32_t)chain, 0u, ACCEPT,
                                           R.seed).x)
                              : R.ua[chain];
    const bool acc = ua < st.accept;
    st.energy = acc ? e1 : e0;
    for (int d = lane; d < dim; d += 32) {
      if (acc) {
        q[d] = tq[d];
        g[d] = tg[d];
        p[d] = tp[d];
      } else {
        p[d] = -p[d];
      }
    }
    if (acc) u = un;
  }
  __syncthreads();
  return st;
}

// warp w's chain state into shared memory; the momentum is 0 without p
template <bool STD, bool DENSE>
__device__ void load_chain(const Params& P, const Smem& S, const float* q,
                           const float* g, const float* p, int w, int lane,
                           int chain, bool valid) {
  const size_t row = (size_t)w * P.ds;
  for (int d = lane; d < P.dim; d += 32) {
    const size_t at = gat<STD>(d, chain, P.dim, P.C);
    S.q[row + d] = valid ? q[at] : 0.f;
    S.g[row + d] = valid ? g[at] : 0.f;
    S.p[row + d] = valid && p ? p[at] : 0.f;
    if constexpr (!DENSE)
      S.im[row + d] = !valid             ? 1.f
                      : P.im_per_chain ? P.im[at]
                                       : P.im[d];
  }
}

template <bool STD>
__device__ void store_chain(const Params& P, const Smem& S, float* q_out,
                            float* u_out, float* g_out, float* p_out, int w,
                            int lane, int chain, float u) {
  const size_t row = (size_t)w * P.ds;
  for (int d = lane; d < P.dim; d += 32) {
    const size_t at = gat<STD>(d, chain, P.dim, P.C);
    q_out[at] = S.q[row + d];
    g_out[at] = S.g[row + d];
    if (p_out) p_out[at] = S.p[row + d];
  }
  if (lane == 0) u_out[chain] = u;
}

// stats [energy, accept_prob, 0, L, div, 0, 0, 0]: rows of (8, C), or the
// chain's row of (C, 8)
template <bool STD>
__device__ void store_stats(float* stats, int C, int L, int chain, int lane,
                            const Stats& st) {
  if (lane < 8) {
    const float v[8] = {st.energy, st.accept, 0.f, (float)L,
                        st.div,    0.f,       0.f, 0.f};
    stats[gat<STD>(lane, chain, 8, C)] = v[lane];
  }
}

// One transition.  p and p_out may be null (no momentum carried);
// qp_out and vp_out are written with PROPOSAL.
template <class PG, bool STD, bool DENSE, bool PROPOSAL>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
    transition_kernel(Params P, PG pg_fn, Rand R, const float* q,
                      const float* u, const float* g, const float* p,
                      float* q_out, float* u_out, float* g_out, float* p_out,
                      float* stats, float* qp_out, float* vp_out) {
  extern __shared__ float4 smem_raw[];
  const Smem S =
      carve(reinterpret_cast<float*>(smem_raw), P.ds, PG::qb_floats(P.ds));
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chain = blockIdx.x * CB + w;
  const bool valid = chain < P.C;
  const int L = P.Ld ? *P.Ld : P.L;
  load_chain<STD, DENSE>(P, S, q, g, p, w, lane, chain, valid);
  __syncwarp();
  float uc = valid ? u[chain] : 0.f;
  const Stats st =
      transition<PG, STD, DENSE>(P, pg_fn, S, R, L, chain, valid, uc);
  if (!valid) return;
  store_chain<STD>(P, S, q_out, u_out, g_out, p_out, w, lane, chain, uc);
  store_stats<STD>(stats, P.C, L, chain, lane, st);
  if constexpr (PROPOSAL) {
    const float* const tq = S.tq + w * P.ds;
    float* const tmp = S.tmp + w * P.ds;
    apply_im<DENSE>(P, S.im + w * P.ds, S.tp + w * P.ds, tmp, lane);
    for (int d = lane; d < P.dim; d += 32) {
      const size_t at = gat<STD>(d, chain, P.dim, P.C);
      qp_out[at] = tq[d];
      vp_out[at] = tmp[d];
    }
  }
}

// num_draws transitions.  Draw t takes the key seed + t*DRAW_SEED_STRIDE,
// or the t-th slices of the external noise (draws, ·) and uniforms
// (draws, C); its positions go to pos[t] (C, dim) when pos is given, its
// stats to the t-th stats slab.
template <class PG, bool STD, bool DENSE>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
    segment_kernel(Params P, PG pg_fn, Rand R, int num_draws, const float* q,
                   const float* u, const float* g, const float* p,
                   float* pos, float* stats, float* q_out, float* u_out,
                   float* g_out, float* p_out) {
  extern __shared__ float4 smem_raw[];
  const Smem S =
      carve(reinterpret_cast<float*>(smem_raw), P.ds, PG::qb_floats(P.ds));
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chain = blockIdx.x * CB + w;
  const bool valid = chain < P.C;
  const int L = P.Ld ? *P.Ld : P.L;
  load_chain<STD, DENSE>(P, S, q, g, p, w, lane, chain, valid);
  __syncwarp();
  float uc = valid ? u[chain] : 0.f;
  const uint32_t seed0 = R.seed;
  Rand Rt = R;
  for (int t = 0; t < num_draws; ++t) {
    if (R.seeded) {
      Rt.seed = seed0 + (uint32_t)t * DRAW_SEED_STRIDE;
    } else {
      Rt.noise = R.noise + (size_t)t * P.dim * P.C;
      Rt.ua = R.ua + (size_t)t * P.C;
    }
    const Stats st =
        transition<PG, STD, DENSE>(P, pg_fn, S, Rt, L, chain, valid, uc);
    if (valid) {
      if (pos) {
        float* row = pos + ((size_t)t * P.C + chain) * P.dim;
        for (int d = lane; d < P.dim; d += 32) row[d] = S.q[w * P.ds + d];
      }
      store_stats<STD>(stats + (size_t)t * 8 * P.C, P.C, L, chain, lane, st);
    }
  }
  if (valid)
    store_chain<STD>(P, S, q_out, u_out, g_out, p_out, w, lane, chain, uc);
}

// Checks a launch's sizes and launches `kernel` on the plan's blocks.
template <typename... KArgs, typename... Args>
cudaError_t launch(void (*kernel)(KArgs...), const Params& P, int N,
                   const Geometry& G, cudaStream_t stream, Args&&... args) {
  if (P.dim < 1 || N < 1 || P.C < 1 || (!P.Ld && P.L < 1) ||
      (size_t)G.blocks * CB < (size_t)P.C)
    return cudaErrorInvalidValue;
  return launch_blocks(kernel, G, stream, std::forward<Args>(args)...);
}

}  // namespace hmc
}  // namespace aehmc
