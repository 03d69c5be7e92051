// The fused NUTS core shared by the four NUTS kernels: one whole NUTS
// transition per chain, and the whole sampling run in one launch, in two
// global-memory layouts.
//
//   STD = false: chains in the last axis, q and ∇U (dim, C), the external
//     streams (rows, C), stats (8, C): kernels 1 and 2
//     (nuts_fused_small.cu), replacing aehmc_tpu/ops/nuts_fused_small.py.
//   STD = true: the standard layout, q and ∇U (C, dim), streams (C, rows),
//     stats (C, 8): kernels 3 and 4 (nuts_fused.cu), replacing
//     aehmc_tpu/ops/nuts_fused.py.
//
// The layout reaches only the global-memory accessors (load_chain,
// store_chain, draw_momentum, the rand_* readers and store_stats): the core
// keeps a chain's state in shared memory either way, so with the same
// Philox key a standard-layout transition of q equals the transposed one of
// qᵀ bit for bit.
//
// What bounds it on the card.  A gradient of the 100-d, 1,000-point
// logistic posterior is two data products, X·q and Xᵀ·(σ(X·q) − y): 2·10^5
// fused multiply-adds per chain, in float32 on the CUDA cores (TF32 is off:
// the tests hold the kernels to float32 results), at the rate the functor's
// register tiles feed them (logistic_pg.cuh).  X (400 KB, or 200 KB with
// bfloat16 operands) comes from the 50 MB L2 through a shared tile.  The
// NUTS state (edges, proposals, momentum sums and scratch: 17 rows of `dim`
// floats per chain) and the tile fill shared memory and cap the chains per
// block.  The 2·K U-turn checkpoint rows of a chain live in a global buffer
// (ck, (blocks, 2, K, CB, ds) floats): each leaf writes or reads them once,
// a warp's row is contiguous, and the resident blocks' slices (about 10 MB
// at 10,240 chains, dim 100, K 6) stay in L2.
//
// Design.  The potential and gradient are a device functor, a template
// parameter of the core and of the kernels: LogisticPGT (logistic_pg.cuh),
// and for kernels 1 and 2 also FunnelPG and EightSchoolsPG
// (hierarchical_pg.cuh).  A functor PG gives the core its Scratch type
// (with the block's potentials `nu`), PG::carve_scratch(base, ds) to carve
// it after the core's rows, PG::fits(dim, geometry) for the launch checks,
// and operator()(scratch, dim, ds, q, grad), which the whole block calls
// with its CB rows of q, a __syncthreads before each call, and which leaves
// CB gradient rows and potentials; a functor with PG::NUTS_HOOKS (the
// generated one) also gets request(scratch) after the carve and
// drain(scratch) before the block exits (its resident operands).  The
// launch plan (ops/launch_plan.py) sizes shared memory for the functor's
// scratch: an X tile for the logistic functor, the resident operands and a
// tile of its streamed ones for a generated functor, none for the
// others.  A block of CB = 8 warps owns 8 chains, one warp per chain, and
// keeps their NUTS state but the checkpoints in shared memory (112 KB with
// a 128-point float32 tile at dim 100, whatever K: two blocks per SM, 128
// registers a thread).  Every per-chain decision is warp-uniform, so the
// tree walk has no divergence inside a warp; a warp whose chain has stopped
// idles through the rest of the block's tree, the early exit being
// block-wide as on the TPU.  The logistic gradient is computed by the whole
// block for its 8 chains at once, the hierarchical ones by each chain's
// warp.  Reductions run in a fixed
// order and products use explicit fmaf with -fmad=false elsewhere, so a
// result does not depend on timing or on where the core is inlined: the
// whole-run kernel equals one launch per draw bit for bit.
//
// Randomness is external (tensors, for parity with the NumPy oracle) or
// Philox4x32-10 keyed by the draw's seed with counter (chain0 + chain, index,
// stream, 0), chain0 the launch's first global chain (a shard's offset, 0
// unsharded, where the kernels' instantiation without the offset runs); the
// plain version computes the same streams (ops/philox.py).
#pragma once

#include <cuda_bf16.h>

#include <utility>

#include "logistic_pg.cuh"

namespace aehmc {
namespace nuts {

constexpr int CB = NW;  // chains a block: one warp each

struct Params {
  const float* im;  // inverse mass: (dim,) or (dim, dim)
  const float* ms;  // mass sqrt L^{-T} (dim, dim), dense metric only
  int dense;
  float eps, thr;      // eps: every chain's ε when eps_row is null
  const float* eps_row;  // (C,): chain c's ε, or null
  int dim, C, K;
  int ds;           // row stride in shared memory: dim rounded up to 4
  uint32_t chain0;  // global index of chain 0: a shard's Philox offset
};

// randomness of one transition: external tensors or a Philox key
struct Rand {
  const float* p;     // (dim, C) or (C, dim)
  const float* dirs;  // (K, C) or (C, K)
  const float* ub;    // (K, C) or (C, K)
  const float* ul;    // (2^K, C) or (C, 2^K)
  uint32_t seed;
  int seeded;
};

// Offset of element i of chain c's row of `rows` values in global memory.
template <bool STD>
__device__ __forceinline__ size_t gat(int i, int chain, int rows, int C) {
  return STD ? (size_t)chain * rows + i : (size_t)i * C + chain;
}

// A block's rows in shared memory, its checkpoint slots in global memory
// (ck_p, ck_s: K slots of CB rows each), and the potential's scratch (SC,
// the functor's Scratch: its potentials `nu` and, for the logistic functor,
// its X tile).
template <class SC>
struct Smem {
  float *prop_q, *prop_g, *left_q, *left_p, *left_g, *right_q, *right_p,
      *right_g, *psum, *last_q, *last_p, *last_g, *sprop_q, *sprop_g,
      *s_psum, *ngrad, *tmp, *ck_p, *ck_s;
  SC pgs;
};

constexpr int NUM_ROWS = 17;  // row arrays of Smem in shared memory

// The rows, zeroed (the functor reads q's padding past dim), then the
// functor PG's scratch (PG::carve_scratch; ops/launch_plan.py sizes it);
// the block's slice of the checkpoint buffer ck.  Every thread of the block
// calls it.
template <class PG>
__device__ inline Smem<typename PG::Scratch> carve(float* base, int ds,
                                                   float* ck, int K) {
  const size_t V = (size_t)CB * ds;
  float* p = base;
  zero_smem(p, NUM_ROWS * V);
  auto take = [&p](size_t n) {
    float* r = p;
    p += n;
    return r;
  };
  Smem<typename PG::Scratch> s;
  s.prop_q = take(V);
  s.prop_g = take(V);
  s.left_q = take(V);
  s.left_p = take(V);
  s.left_g = take(V);
  s.right_q = take(V);
  s.right_p = take(V);
  s.right_g = take(V);
  s.psum = take(V);
  s.last_q = take(V);
  s.last_p = take(V);
  s.last_g = take(V);
  s.sprop_q = take(V);
  s.sprop_g = take(V);
  s.s_psum = take(V);
  s.ngrad = take(V);
  s.tmp = take(V);
  s.ck_p = ck + (size_t)blockIdx.x * 2 * K * V;
  s.ck_s = s.ck_p + K * V;
  s.pgs = PG::carve_scratch(p, ds);
  __syncthreads();
  return s;
}

__device__ __forceinline__ float logaddexp(float a, float b) {
  return fmaxf(a, b) + log1pf(expf(-fabsf(a - b)));
}

// out = M^{-1} v for one chain's row (dense metric); the warp's lanes own
// the output dimensions
__device__ void apply_dense(const Params& P, const float* mat, const float* v,
                            float* out, int lane) {
  __syncwarp();
  for (int d = lane; d < P.dim; d += 32) {
    float acc = 0.f;
    for (int j = 0; j < P.dim; ++j) acc = fmaf(mat[d * P.dim + j], v[j], acc);
    out[d] = acc;
  }
  __syncwarp();
}

// 0.5 pᵀ M^{-1} p
__device__ float kinetic(const Params& P, const float* p, float* tmp,
                         int lane) {
  float acc = 0.f;
  if (P.dense) {
    apply_dense(P, P.im, p, tmp, lane);
    for (int d = lane; d < P.dim; d += 32) acc += p[d] * tmp[d];
  } else {
    for (int d = lane; d < P.dim; d += 32) acc += p[d] * (P.im[d] * p[d]);
  }
  return 0.5f * warp_sum(acc);
}

// U-turn of the span (p_l, p_r) with momentum sum rho_sum = s - cs + cp
// (or rho_sum = s when cs is null): rho = rho_sum - (p_r + p_l)/2,
// v = M^{-1} rho, turning iff p_l·v <= 0 or p_r·v <= 0
__device__ bool turning(const Params& P, const float* p_l, const float* p_r,
                        const float* s, const float* cs, float* tmp,
                        float* tmp2, int lane) {
  float tl = 0.f, tr = 0.f;
  if (P.dense) {
    __syncwarp();
    for (int d = lane; d < P.dim; d += 32) {
      const float rs = cs ? (s[d] - cs[d]) + p_l[d] : s[d];
      tmp[d] = rs - (p_r[d] + p_l[d]) * 0.5f;
    }
    apply_dense(P, P.im, tmp, tmp2, lane);
    for (int d = lane; d < P.dim; d += 32) {
      tl += p_l[d] * tmp2[d];
      tr += p_r[d] * tmp2[d];
    }
  } else {
    for (int d = lane; d < P.dim; d += 32) {
      const float rs = cs ? (s[d] - cs[d]) + p_l[d] : s[d];
      const float v = P.im[d] * (rs - (p_r[d] + p_l[d]) * 0.5f);
      tl += p_l[d] * v;
      tr += p_r[d] * v;
    }
  }
  const float sl = warp_sum(tl), sr = warp_sum(tr);
  return sl <= 0.f || sr <= 0.f;
}

__device__ __forceinline__ void copy_row(float* dst, const float* src,
                                         int dim, int lane) {
  for (int d = lane; d < dim; d += 32) dst[d] = src[d];
}

// momentum of warp w's chain into row p: external, or Box-Muller from Philox
template <bool STD, class SC>
__device__ void draw_momentum(const Params& P, const Smem<SC>& S,
                              const Rand& R, int w, int lane, int chain,
                              uint32_t chain0, float* p) {
  const int dim = P.dim;
  if (!R.seeded) {
    for (int d = lane; d < dim; d += 32)
      p[d] = R.p[gat<STD>(d, chain, dim, P.C)];
    return;
  }
  float* z = S.tmp + w * P.ds;
  normal_row(chain0 + (uint32_t)chain, R.seed, dim, lane, z);
  __syncwarp();
  if (P.dense) {
    apply_dense(P, P.ms, z, p, lane);
  } else {
    for (int d = lane; d < dim; d += 32) p[d] = sqrtf(1.0f / P.im[d]) * z[d];
  }
  __syncwarp();
}

template <bool STD>
__device__ __forceinline__ float rand_dir(const Rand& R, const Params& P,
                                          int chain, uint32_t chain0, int d) {
  if (R.seeded) {
    const float u = u01(philox(chain0 + (uint32_t)chain, (uint32_t)d,
                               DIRECTION, R.seed).x);
    return u < 0.5f ? -1.f : 1.f;
  }
  return R.dirs[gat<STD>(d, chain, P.K, P.C)];
}

template <bool STD>
__device__ __forceinline__ float rand_bias(const Rand& R, const Params& P,
                                           int chain, uint32_t chain0,
                                           int d) {
  if (R.seeded)
    return u01(
        philox(chain0 + (uint32_t)chain, (uint32_t)d, BIAS, R.seed).x);
  return R.ub[gat<STD>(d, chain, P.K, P.C)];
}

template <bool STD>
__device__ __forceinline__ float rand_leaf(const Rand& R, const Params& P,
                                           int chain, uint32_t chain0,
                                           int idx) {
  if (R.seeded)
    return u01(
        philox(chain0 + (uint32_t)chain, (uint32_t)idx, LEAF, R.seed).x);
  return R.ul[gat<STD>(idx, chain, 1 << P.K, P.C)];
}

struct Stats {
  float u, energy, accept, doublings, leaves, div, turn;
};

// Chain `chain`'s ε: its entry of the per-chain row, or the scalar; the
// padded chains of the grid's tail read 0.
__device__ __forceinline__ float chain_eps(const Params& P, int chain,
                                           bool valid) {
  if (!P.eps_row) return P.eps;
  return valid ? P.eps_row[chain] : 0.f;
}

// One NUTS transition of the block's chains.  On entry prop_q / prop_g hold
// each chain's (q, ∇U) and u0 its potential; on exit they hold the proposal.
// eps is the chain's step size (chain_eps); Philox keys the chain on the
// global index chain0 + chain.
template <bool STD, class PG>
__device__ Stats nuts_core(const Params& P, const PG& pg_fn,
                           const Smem<typename PG::Scratch>& S, const Rand& R,
                           int chain, uint32_t chain0, bool valid, float u0,
                           float eps) {
  const int t = threadIdx.x, w = t / 32, lane = t % 32;
  const int dim = P.dim, ds = P.ds;
  float* const pq = S.prop_q + w * ds;
  float* const pg = S.prop_g + w * ds;
  float* const lq = S.left_q + w * ds;
  float* const lp = S.left_p + w * ds;
  float* const lg = S.left_g + w * ds;
  float* const rq = S.right_q + w * ds;
  float* const rp = S.right_p + w * ds;
  float* const rg = S.right_g + w * ds;
  float* const ps = S.psum + w * ds;
  float* const tq = S.last_q + w * ds;
  float* const tp = S.last_p + w * ds;
  float* const tg = S.last_g + w * ds;
  float* const sq = S.sprop_q + w * ds;
  float* const sg = S.sprop_g + w * ds;
  float* const ss = S.s_psum + w * ds;
  float* const ng = S.ngrad + w * ds;
  float* const tmp = S.tmp + w * ds;

  float e0 = 0.f;
  float prop_u = u0, prop_e = 0.f, prop_w = 0.f, prop_slpa = NEG_INF;
  float left_u = u0, right_u = u0;
  float active = valid ? 1.f : 0.f;
  Stats st = {u0, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (valid) {
    draw_momentum<STD>(P, S, R, w, lane, chain, chain0, lp);
    for (int d = lane; d < dim; d += 32) {
      lq[d] = rq[d] = pq[d];
      lg[d] = rg[d] = pg[d];
      rp[d] = ps[d] = lp[d];
    }
    e0 = u0 + kinetic(P, lp, tmp, lane);
    prop_e = e0;
  }

  for (int d = 0; d < P.K; ++d) {
    if (!__syncthreads_or(active > 0.5f)) break;
    const bool keep = active > 0.5f;
    float dir = 0.f, last_u = 0.f, s_u = 0.f, s_e = 0.f, s_w = 0.f;
    float s_slpa = NEG_INF, s_active = 0.f, s_div = 0.f, s_term = 0.f;
    float s_len = 0.f;
    if (keep) {
      dir = rand_dir<STD>(R, P, chain, chain0, d);
      const bool right = dir > 0.f;
      for (int k = lane; k < dim; k += 32) {
        tq[k] = sq[k] = right ? rq[k] : lq[k];
        tp[k] = right ? rp[k] : lp[k];
        tg[k] = sg[k] = right ? rg[k] : lg[k];
        ss[k] = 0.f;
      }
      last_u = s_u = right ? right_u : left_u;
      s_e = e0;
      s_active = 1.f;
    }
    const float d_eps = dir * eps;
    const float h = 0.5f * d_eps;
    const int nleaf = 1 << d;

    for (int i = 0; i < nleaf; ++i) {
      if (!__syncthreads_or(s_active > 0.5f)) break;
      const bool live = s_active > 0.5f;
      if (live) {  // half kick + drift, in place on the trajectory tip
        for (int k = lane; k < dim; k += 32) tp[k] = tp[k] - h * tg[k];
        if (P.dense) {
          apply_dense(P, P.im, tp, tmp, lane);
          for (int k = lane; k < dim; k += 32) tq[k] = tq[k] + d_eps * tmp[k];
        } else {
          for (int k = lane; k < dim; k += 32)
            tq[k] = tq[k] + d_eps * (P.im[k] * tp[k]);
        }
      }
      __syncthreads();
      pg_fn(S.pgs, P.dim, P.ds, S.last_q, S.ngrad);
      if (!live) continue;

      float un = S.pgs.nu[w];
      un = un != un ? -NEG_INF : clip(un);
      for (int k = lane; k < dim; k += 32) {
        float g = ng[k];
        g = g != g ? 0.f : clip(g);
        tg[k] = g;
        tp[k] = tp[k] - h * g;
      }
      const float energy = clip(un + kinetic(P, tp, tmp, lane));
      float delta = e0 - energy;
      delta = delta != delta ? NEG_INF : clip(delta);
      const float leaf_div = fabsf(delta) > P.thr ? 1.f : 0.f;
      const float slpa_leaf = fminf(delta, 0.f);
      bool take = true;
      float m_w = delta, m_slpa = slpa_leaf;
      if (i > 0) {
        const float u = rand_leaf<STD>(R, P, chain, chain0, nleaf - 1 + i);
        const float u_logit = logf(u) - log1pf(-u);
        take = u_logit < delta - s_w;
        m_w = logaddexp(s_w, delta);
        m_slpa = logaddexp(s_slpa, slpa_leaf);
      }
      if (take) {
        copy_row(sq, tq, dim, lane);
        copy_row(sg, tg, dim, lane);
        s_u = un;
        s_e = energy;
      }
      s_w = m_w;
      s_slpa = m_slpa;
      last_u = un;
      for (int k = lane; k < dim; k += 32) ss[k] = ss[k] + tp[k];
      s_len += 1.f;
      s_div += leaf_div;
      const int m_idx = __popc(i >> 1);
      float stop;
      if ((i & 1) == 0) {  // even leaf: write checkpoint slot m_idx
        copy_row(S.ck_p + ((size_t)m_idx * CB + w) * ds, tp, dim, lane);
        copy_row(S.ck_s + ((size_t)m_idx * CB + w) * ds, ss, dim, lane);
        __syncwarp();  // the warp's slot rows before any of its reads
        stop = leaf_div;
      } else {  // odd leaf: U-turn against the live checkpoint slots
        const int lo = m_idx - (__popc(i ^ (i + 1)) - 1) + 1;
        float term = 0.f;
        for (int j = lo; j <= m_idx; ++j) {
          const float* cp = S.ck_p + ((size_t)j * CB + w) * ds;
          const float* cs = S.ck_s + ((size_t)j * CB + w) * ds;
          if (turning(P, cp, tp, ss, cs, tmp, ng, lane)) term = 1.f;
        }
        s_term += term;
        stop = fminf(leaf_div + term, 1.f);
      }
      s_active = s_active * (1.f - stop);
    }

    if (keep) {  // doubling epilogue: move the edge, biased merge, U-turn
      if (dir > 0.f) {
        for (int k = lane; k < dim; k += 32) {
          rq[k] = tq[k];
          rp[k] = tp[k];
          rg[k] = tg[k];
        }
        right_u = last_u;
      } else {
        for (int k = lane; k < dim; k += 32) {
          lq[k] = tq[k];
          lp[k] = tp[k];
          lg[k] = tg[k];
        }
        left_u = last_u;
      }
      for (int k = lane; k < dim; k += 32) ps[k] = ps[k] + ss[k];
      const float new_accept = expf(s_slpa) / fmaxf(s_len, 1.f);
      const float merged_slpa = logaddexp(s_slpa, prop_slpa);
      const bool clean = (1.f - s_div) * (1.f - s_term) > 0.5f;
      const float p_acc = fminf(expf(s_w - prop_w), 1.f);
      if (clean && rand_bias<STD>(R, P, chain, chain0, d) < p_acc) {
        copy_row(pq, sq, dim, lane);
        copy_row(pg, sg, dim, lane);
        prop_u = s_u;
        prop_e = s_e;
      }
      if (clean) prop_w = logaddexp(prop_w, s_w);
      prop_slpa = merged_slpa;
      const float turn_f =
          turning(P, lp, rp, ps, nullptr, tmp, ng, lane) ? 1.f : 0.f;
      active = active * (1.f - fminf(s_div + turn_f + s_term, 1.f));
      st.div = s_div;
      st.turn = turn_f;
      st.accept = new_accept;
      st.leaves += s_len;
      st.doublings += 1.f;
    }
  }
  st.u = prop_u;
  st.energy = prop_e;
  __syncthreads();
  return st;
}

template <bool STD, class SC>
__device__ void load_chain(const Params& P, const Smem<SC>& S, const float* q,
                           const float* g, int w, int lane, int chain,
                           bool valid) {
  for (int d = lane; d < P.dim; d += 32) {
    const size_t at = gat<STD>(d, chain, P.dim, P.C);
    S.prop_q[w * P.ds + d] = valid ? q[at] : 0.f;
    S.prop_g[w * P.ds + d] = valid ? g[at] : 0.f;
  }
}

template <bool STD, class SC>
__device__ void store_chain(const Params& P, const Smem<SC>& S, float* q_out,
                            float* u_out, float* g_out, int w, int lane,
                            int chain, float u) {
  for (int d = lane; d < P.dim; d += 32) {
    const size_t at = gat<STD>(d, chain, P.dim, P.C);
    q_out[at] = S.prop_q[w * P.ds + d];
    g_out[at] = S.prop_g[w * P.ds + d];
  }
  if (lane == 0) u_out[chain] = u;
}

// stats [energy, accept, doublings, leaves, div, turn, 0, 0] of a chain:
// rows of (8, C), or the chain's row of (C, 8)
template <bool STD>
__device__ void store_stats(float* stats, int C, int chain, int lane,
                            const Stats& st) {
  if (lane < 8) {
    const float v[8] = {st.energy, st.accept, st.doublings, st.leaves,
                        st.div,    st.turn,   0.f,          0.f};
    stats[gat<STD>(lane, chain, 8, C)] = v[lane];
  }
}

// OFFSET: Philox keys chain c on P.chain0 + c (a shard's launch); without
// it on c: a runtime chain0 costs 1-3% (register allocation), so a launch
// at chain0 0 takes the compile-time zero (transition_kernel_for picks).
template <class PG, bool STD, bool OFFSET = false>
__global__ void __launch_bounds__(NT, 2)
    nuts_transition_kernel(Params P, PG pg_fn, Rand R, const float* q,
                           const float* u, const float* g, float* q_out,
                           float* u_out, float* g_out, float* stats,
                           float* ck) {
  extern __shared__ float4 smem_raw[];
  const auto S = carve<PG>(reinterpret_cast<float*>(smem_raw), P.ds, ck, P.K);
  if constexpr (nuts_hooks<PG>::value) pg_fn.request(S.pgs);
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chain = blockIdx.x * CB + w;
  const bool valid = chain < P.C;
  load_chain<STD>(P, S, q, g, w, lane, chain, valid);
  __syncwarp();
  const Stats st = nuts_core<STD>(P, pg_fn, S, R, chain,
                                  OFFSET ? P.chain0 : 0u, valid,
                                  valid ? u[chain] : 0.f,
                                  chain_eps(P, chain, valid));
  if constexpr (nuts_hooks<PG>::value) pg_fn.drain(S.pgs);
  if (valid) {
    store_chain<STD>(P, S, q_out, u_out, g_out, w, lane, chain, st.u);
    store_stats<STD>(stats, P.C, chain, lane, st);
  }
}

template <typename T>
__device__ __forceinline__ T to_collect(float x);
template <>
__device__ __forceinline__ float to_collect<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 to_collect<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Draw t is keyed by seed + t*DRAW_SEED_STRIDE; its positions go to
// pos[t] (C, dim) (a chain's row contiguous in both layouts) and its stats
// to the t-th (8, C) or (C, 8) slab.  OFFSET as the transition kernel's.
template <class PG, typename T, bool STD, bool OFFSET = false>
__global__ void __launch_bounds__(NT, 2)
    nuts_sampling_kernel(Params P, PG pg_fn, uint32_t seed, int num_draws,
                         const float* q, const float* u, const float* g,
                         T* pos, float* stats, float* q_out, float* u_out,
                         float* g_out, float* ck) {
  extern __shared__ float4 smem_raw[];
  const auto S = carve<PG>(reinterpret_cast<float*>(smem_raw), P.ds, ck, P.K);
  if constexpr (nuts_hooks<PG>::value) pg_fn.request(S.pgs);
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chain = blockIdx.x * CB + w;
  const bool valid = chain < P.C;
  load_chain<STD>(P, S, q, g, w, lane, chain, valid);
  __syncwarp();
  float uc = valid ? u[chain] : 0.f;
  const float eps = chain_eps(P, chain, valid);  // fixed across the draws
  Rand R = {nullptr, nullptr, nullptr, nullptr, 0u, 1};
  for (int t = 0; t < num_draws; ++t) {
    R.seed = seed + (uint32_t)t * DRAW_SEED_STRIDE;
    const Stats st = nuts_core<STD>(P, pg_fn, S, R, chain,
                                    OFFSET ? P.chain0 : 0u, valid, uc, eps);
    uc = st.u;
    if (valid) {
      if (pos) {
        T* row = pos + ((size_t)t * P.C + chain) * P.dim;
        for (int d = lane; d < P.dim; d += 32)
          row[d] = to_collect<T>(S.prop_q[w * P.ds + d]);
      }
      store_stats<STD>(stats + (size_t)t * 8 * P.C, P.C, chain, lane, st);
    }
  }
  if constexpr (nuts_hooks<PG>::value) pg_fn.drain(S.pgs);
  if (valid)
    store_chain<STD>(P, S, q_out, u_out, g_out, w, lane, chain, uc);
}

// The kernel 1 / 3 and kernel 2 / 4 instantiations for a launch of P: with
// the offset only where P.chain0 is not 0.
template <class PG, bool STD>
auto transition_kernel_for(const Params& P) {
  return P.chain0 ? nuts_transition_kernel<PG, STD, true>
                  : nuts_transition_kernel<PG, STD, false>;
}

template <class PG, typename T, bool STD>
auto sampling_kernel_for(const Params& P) {
  return P.chain0 ? nuts_sampling_kernel<PG, T, STD, true>
                  : nuts_sampling_kernel<PG, T, STD, false>;
}

inline Params make_params(const float* im, const float* ms, int dense,
                          float eps, const float* eps_row, float thr, int dim,
                          int C, int K, uint32_t chain0) {
  Params P;
  P.im = im;
  P.ms = ms;
  P.dense = dense;
  P.eps = eps;
  P.eps_row = eps_row;
  P.thr = thr;
  P.dim = dim;
  P.C = C;
  P.K = K;
  P.ds = (dim + 3) / 4 * 4;
  P.chain0 = chain0;
  return P;
}

// Checks a launch's sizes, and with the functor pg its own operands and
// shared memory (pg.fits: the logistic functor's X and tile, nothing of X
// for the others), and launches `kernel` on the plan's blocks; ck (the
// checkpoint buffer, G.blocks × 2K × CB × ds floats) must be given.
template <class PG, typename... KArgs, typename... Args>
cudaError_t launch(void (*kernel)(KArgs...), const Params& P, const PG& pg,
                   const float* ck, const Geometry& G, cudaStream_t stream,
                   Args&&... args) {
  if (P.dim < 1 || P.C < 1 || P.K < 1 || P.K > 14 || !ck ||
      G.chains != CB || (size_t)G.blocks * CB < (size_t)P.C ||
      !pg.fits(P.dim, G))
    return cudaErrorInvalidValue;
  return launch_blocks(kernel, G, stream, std::forward<Args>(args)...);
}

}  // namespace nuts
}  // namespace aehmc
