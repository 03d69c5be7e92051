// The fused HMC transition shared by the GHMC kernels (ghmc_fused.cu:
// `ghmc_transition`, `ghmc_segment`) and the ChEES kernel (chees_fused.cu:
// `chees_transition`): a partial momentum refresh p0 = α p + √(1−α²) ξ with
// ξ ~ N(0, M), L velocity-Verlet steps on the potential functor, then
// Metropolis-Hastings on the energy error.  A rejection flips the momentum.
// ChEES is this transition at α 0, with no momentum carried between calls.
//
// Template parameters of the kernels:
//   PG: the potential's device functor: LogisticPGT (logistic_pg.cuh;
//     ghmc_fused.cu, chees_fused.cu), or a GenericPG generated from any
//     other potential's traced gradient graph (generic_pg.cuh,
//     hmc_generic.cu).  The contract is the NUTS core's (nuts_core.cuh):
//     PG::Scratch with the block's potentials `nu`, PG::carve_scratch(base,
//     ds) after the core's rows, pg.fits(dim, geometry) for the launch
//     checks, and operator()(scratch, dim, ds, q, grad, more), which the
//     whole block calls and which leaves each chain's gradient row and
//     potential ordered before the chain's warp reads them (a block barrier
//     in the logistic functor, a __syncwarp in the generated one, whose
//     warp computes its own chain, its chunks of a streamed operand waited
//     for at block barriers of its own).  Two hooks besides:
//     pg.request(scratch) at block entry and pg.drain(scratch) before the
//     block exits, which LogisticPGT uses to start X's first chunk early
//     and to wait for a chunk requested and never used, and GenericPG to
//     copy its resident operands into shared memory (and to wait for
//     nothing: each of its calls consumes the chunks it requests).
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
// What bounds it on the card: the L gradients.  With the logistic functor
// each is 2·N·dim float32 multiply-adds per chain, at the rate the
// functor's register tiles are fed from shared memory (logistic_pg.cuh),
// and around them, in a launch of one gradient (kernel 5), the block's
// fixed work: its state in and out, the momentum draw, the accept test.
// A generated functor's gradients are its contractions, one warp a chain,
// on operands from L2 (generic_pg.py); at the hierarchical models' few
// dozen flops a chain the core's own work and the launch bound them.
//
// Design.  One warp per chain, CB = 8 chains per block (16 chains a block,
// two a warp, was measured slower at 10,240 chains: the grid's last round of
// blocks runs 42% full; PERF.md §6), the potential computed by the whole
// block for its 8 chains at once (the logistic functor) or by each chain's
// warp (the generated one).  Every chain of a call takes the same L, so no
// warp idles.  L is a host int (GHMC) or read from a device int32 (ChEES,
// whose driver computes clip(ceil(jitter·h/ε), 1, max) on the card, so
// nothing synchronises the stream).  ε and α are per chain, or host
// scalars passed with the launch (no fill on the card).  A block keeps q,
// ∇U, p, the trajectory's q, p, ∇U, a scratch row and the diagonal M⁻¹ of
// its chains in shared memory, 8 rows of dim floats per chain, then the
// functor's scratch: with the logistic functor its tile of X (81 KB at dim
// 100 with a 128-point tile): two blocks per SM, built for 128 registers a
// thread, which hold the functor's register tiles.  The block moves its
// state in and out together, consecutive threads on consecutive addresses
// in either layout (in the (dim, C) layout a warp takes 4 rows × the
// block's 8 chains), not a warp a chain: in the (dim, C) layout that read
// 32 rows apart at each load, and kernel 5 waited on it (PERF.md §6).  The
// tile of X is never idle while a request can be made: a kernel requests
// X's first chunk at block entry, before it loads its state and draws its
// momentum, and each gradient but a launch's last requests the next one's
// first chunk as soon as its own tile is read, so it arrives during the
// leapfrog update.  The
// segment kernel keeps the state across its draws and writes each draw's
// positions (a chain's row contiguous, so the warp's store is coalesced)
// and stats.  The kinetic energy is a warp sum in a fixed order and
// products use explicit fmaf or none (-fmad=false), so a segment equals one
// transition launch per draw bit for bit, and the ChEES kernel equals the
// GHMC one at α 0.  A rejected proposal may hold inf positions: the state
// is kept by a true select.
//
// Randomness is external (ξ and the MH uniform as tensors) or Philox keyed
// by the call's (or draw's) seed on the global chain index (chain0 + the
// launch's chain, chain0 a shard's offset, 0 unsharded; the segment kernel
// is never sharded and keys on the launch's chain): the MOMENTUM
// stream's normals z and the ACCEPT stream's uniform
// (ops/philox.py:ghmc_streams).
#pragma once

#include <utility>

#include "logistic_pg.cuh"

namespace aehmc {
namespace hmc {

struct Params {
  const float* eps;    // (C,), or null for eps0
  const float* alpha;  // (C,), or null for alpha0
  float eps0, alpha0;  // ε and α of every chain when their rows are null
  const float* im;     // M⁻¹: (dim,), per chain (im_per_chain) or dense
  const float* ms;     // L⁻ᵀ (dim, dim): dense metric under Philox
  int im_per_chain;
  const int* Ld;       // the trip count as a device int32, or null for L
  int L;
  float thr;
  int dim, C;
  int ds;              // row stride in shared memory: dim rounded up to 4
  uint32_t chain0;     // global index of chain 0: a shard's Philox offset
                       // (kernels 5 and 7; the segment kernel keys on 0)
};

// The parameters of a GHMC launch (kernels 5 and 6): ε and α as rows or,
// where a row is null, the host scalars eps0 and alpha0; a diagonal M⁻¹,
// shared or per chain; L a host int.
inline Params ghmc_params(const float* eps, const float* alpha, float eps0,
                          float alpha0, const float* im, int im_per_chain,
                          float thr, int dim, int C, int L) {
  Params P;
  P.eps = eps;
  P.alpha = alpha;
  P.eps0 = eps0;
  P.alpha0 = alpha0;
  P.im = im;
  P.ms = nullptr;
  P.im_per_chain = im_per_chain;
  P.Ld = nullptr;
  P.L = L;
  P.thr = thr;
  P.dim = dim;
  P.C = C;
  P.ds = (dim + 3) / 4 * 4;
  P.chain0 = 0;
  return P;
}

// ... and of a ChEES launch (kernel 7): α 0, ε a row, M⁻¹ diagonal or dense
// (ms its L⁻ᵀ), L a device int32.
inline Params chees_params(const float* eps, const float* im, const float* ms,
                           const int* L, float thr, int dim, int C) {
  Params P = ghmc_params(eps, nullptr, 0.f, 0.f, im, 0, thr, dim, C, 0);
  P.ms = ms;
  P.Ld = L;
  return P;
}

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

// The block's rows, then the potential's scratch (SC, the functor's
// Scratch: its potentials `nu` and, for the logistic functor, its X tile).
template <class SC>
struct Smem {
  float *q, *g, *p, *tq, *tp, *tg, *tmp, *im;
  SC pgs;
};

constexpr int CB = NW;  // chains a block: one warp each
constexpr int NUM_ROWS = 8;  // row arrays of Smem
constexpr int MIN_BLOCKS = 2;  // blocks per SM the registers must allow

// The rows, zeroed (the functor reads q's padding past dim), then the
// functor PG's scratch (PG::carve_scratch; ops/launch_plan.py sizes it).
// Every thread of the block calls it.
template <class PG>
__device__ inline Smem<typename PG::Scratch> carve(float* base, int ds) {
  static_assert(PG::CB == CB, "the HMC core takes 8 chains a block");
  const size_t V = (size_t)CB * ds;
  zero_smem(base, NUM_ROWS * V);
  Smem<typename PG::Scratch> s;
  s.pgs = PG::carve_scratch(base + NUM_ROWS * V, ds);
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
// flipped on rejection), and tq, tp the trajectory's endpoint.  `more`: the
// block takes another gradient after this transition's last (the functor
// then requests X's first chunk for it early).  Philox keys chain on the
// global index chain0 + chain.
template <class PG, bool STD, bool DENSE, class SC>
__device__ Stats transition(const Params& P, const PG& pg_fn,
                            const Smem<SC>& S,
                            const Rand& R, int L, bool more, int chain,
                            bool valid, float& u, uint32_t chain0) {
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
  const float eps = !valid ? 0.f : P.eps ? P.eps[chain] : P.eps0;
  const float alpha = !valid ? 0.f : P.alpha ? P.alpha[chain] : P.alpha0;
  const float h = 0.5f * eps;
  float e0 = 0.f, un = u;

  if (valid) {  // the partial refresh into p; z in tmp, L⁻ᵀ z in tp
    if (R.seeded) {
      normal_row(chain0 + (uint32_t)chain, R.seed, dim, lane, tmp);
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
    pg_fn(S.pgs, dim, ds, S.tq, S.tg, more || s + 1 < L);
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
    const float ua = R.seeded ? u01(philox(chain0 + (uint32_t)chain, 0u,
                                           ACCEPT, R.seed).x)
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

// Element e of the block's CB rows of n values in either global layout:
// its chain c (of the block), its value i, and its offset in the global
// array of rows of n values.  Consecutive e take consecutive addresses:
// a chain's row in (C, n) (the block's rows are contiguous there), or in
// (n, C) one value of the block's chains.
template <bool STD>
__device__ __forceinline__ void block_elem(int e, int n, int C, int& c,
                                           int& i, size_t& at) {
  if constexpr (STD) {
    c = e / n;
    i = e - c * n;
  } else {
    i = e / CB;
    c = e - i * CB;
  }
  at = gat<STD>(i, (int)blockIdx.x * CB + c, n, C);
}

// The block's chain state into shared memory (the momentum 0 without p);
// returns warp w's chain's potential.  A __syncthreads must follow.
template <bool STD, bool DENSE, class SC>
__device__ float load_state(const Params& P, const Smem<SC>& S,
                            const float* q, const float* u, const float* g,
                            const float* p) {
  const int n = P.dim;
  for (int e = threadIdx.x; e < CB * n; e += NT) {
    int c, d;
    size_t at;
    block_elem<STD>(e, n, P.C, c, d, at);
    const bool valid = (int)blockIdx.x * CB + c < P.C;
    const size_t row = (size_t)c * P.ds + d;
    S.q[row] = valid ? q[at] : 0.f;
    S.g[row] = valid ? g[at] : 0.f;
    S.p[row] = valid && p ? p[at] : 0.f;
    if constexpr (!DENSE)
      S.im[row] = !valid             ? 1.f
                  : P.im_per_chain ? P.im[at]
                                   : P.im[d];
  }
  const int chain = (int)(blockIdx.x * CB + threadIdx.x / 32);
  return chain < P.C ? u[chain] : 0.f;
}

// The block's chain state out of shared memory (p_out may be null); warp
// w's lane 0 writes its chain's potential u.
template <bool STD, class SC>
__device__ void store_state(const Params& P, const Smem<SC>& S,
                            float* q_out, float* u_out, float* g_out,
                            float* p_out, float u) {
  const int n = P.dim;
  for (int e = threadIdx.x; e < CB * n; e += NT) {
    int c, d;
    size_t at;
    block_elem<STD>(e, n, P.C, c, d, at);
    if ((int)blockIdx.x * CB + c >= P.C) continue;
    const size_t row = (size_t)c * P.ds + d;
    q_out[at] = S.q[row];
    g_out[at] = S.g[row];
    if (p_out) p_out[at] = S.p[row];
  }
  const int chain = (int)(blockIdx.x * CB + threadIdx.x / 32);
  if (threadIdx.x % 32 == 0 && chain < P.C) u_out[chain] = u;
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
// qp_out and vp_out are written with PROPOSAL.  OFFSET: Philox keys chain c
// on P.chain0 + c (a shard's launch); without it on c: a runtime chain0
// costs 1-3% (register allocation), so a launch at chain0 0 takes the
// compile-time zero (transition_kernel_for picks).
template <class PG, bool STD, bool DENSE, bool PROPOSAL, bool OFFSET = false>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
    transition_kernel(Params P, PG pg_fn, Rand R, const float* q,
                      const float* u, const float* g, const float* p,
                      float* q_out, float* u_out, float* g_out, float* p_out,
                      float* stats, float* qp_out, float* vp_out) {
  extern __shared__ float4 smem_raw[];
  const auto S = carve<PG>(reinterpret_cast<float*>(smem_raw), P.ds);
  pg_fn.request(S.pgs);
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chain = blockIdx.x * CB + w;
  const bool valid = chain < P.C;
  const int L = P.Ld ? *P.Ld : P.L;
  float uc = load_state<STD, DENSE>(P, S, q, u, g, p);
  __syncthreads();
  const Stats st =
      transition<PG, STD, DENSE>(P, pg_fn, S, R, L, false, chain, valid, uc,
                                 OFFSET ? P.chain0 : 0u);
  pg_fn.drain(S.pgs);  // L < 1 leaves the first chunk
  if (valid) store_stats<STD>(stats, P.C, L, chain, lane, st);
  store_state<STD>(P, S, q_out, u_out, g_out, p_out, uc);
  if constexpr (PROPOSAL) {  // M⁻¹ p_L of the warp's chain into tmp
    if (valid)
      apply_im<DENSE>(P, S.im + w * P.ds, S.tp + w * P.ds, S.tmp + w * P.ds,
                      lane);
    __syncthreads();
    for (int e = threadIdx.x; e < CB * P.dim; e += NT) {
      int c, d;
      size_t at;
      block_elem<STD>(e, P.dim, P.C, c, d, at);
      if ((int)blockIdx.x * CB + c >= P.C) continue;
      qp_out[at] = S.tq[(size_t)c * P.ds + d];
      vp_out[at] = S.tmp[(size_t)c * P.ds + d];
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
  const auto S = carve<PG>(reinterpret_cast<float*>(smem_raw), P.ds);
  pg_fn.request(S.pgs);
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chain = blockIdx.x * CB + w;
  const bool valid = chain < P.C;
  const int L = P.Ld ? *P.Ld : P.L;
  float uc = load_state<STD, DENSE>(P, S, q, u, g, p);
  __syncthreads();
  const uint32_t seed0 = R.seed;
  Rand Rt = R;
  for (int t = 0; t < num_draws; ++t) {
    if (R.seeded) {
      Rt.seed = seed0 + (uint32_t)t * DRAW_SEED_STRIDE;
    } else {
      Rt.noise = R.noise + (size_t)t * P.dim * P.C;
      Rt.ua = R.ua + (size_t)t * P.C;
    }
    const Stats st = transition<PG, STD, DENSE>(
        P, pg_fn, S, Rt, L, t + 1 < num_draws, chain, valid, uc, 0u);
    if (valid) {
      if (pos) {
        float* row = pos + ((size_t)t * P.C + chain) * P.dim;
        for (int d = lane; d < P.dim; d += 32) row[d] = S.q[w * P.ds + d];
      }
      store_stats<STD>(stats + (size_t)t * 8 * P.C, P.C, L, chain, lane, st);
    }
  }
  pg_fn.drain(S.pgs);
  store_state<STD>(P, S, q_out, u_out, g_out, p_out, uc);
}

// The kernel 5 / 7 instantiation for a launch of P: with the offset only
// where P.chain0 is not 0.
template <class PG, bool STD, bool DENSE, bool PROPOSAL>
auto transition_kernel_for(const Params& P) {
  return P.chain0 ? transition_kernel<PG, STD, DENSE, PROPOSAL, true>
                  : transition_kernel<PG, STD, DENSE, PROPOSAL, false>;
}

// Checks a launch's sizes, and with the functor pg its own operands and
// shared memory (pg.fits: the logistic functor's X and tile, nothing of X
// for the generated one), and launches `kernel` on the plan's blocks.
template <class PG, typename... KArgs, typename... Args>
cudaError_t launch(void (*kernel)(KArgs...), const Params& P, const PG& pg,
                   const Geometry& G, cudaStream_t stream, Args&&... args) {
  if (P.dim < 1 || P.C < 1 || (!P.Ld && P.L < 1) || G.chains != CB ||
      (size_t)G.blocks * CB < (size_t)P.C || !pg.fits(P.dim, G))
    return cudaErrorInvalidValue;
  return launch_blocks(kernel, G, stream, std::forward<Args>(args)...);
}

}  // namespace hmc
}  // namespace aehmc
