// Fused NUTS for the NVIDIA H100 (sm_90a): one whole NUTS transition per
// chain (kernel `nuts_transition`) and the whole sampling run, every draw in
// one launch (kernel `nuts_sampling`).  Both run the same __device__ core.
//
// Replaces the TPU kernels of aehmc_tpu/ops/nuts_fused_small.py:
//   _make_kernel_t (:459), launched by make_fused_nuts_transition_small,
//   _make_sampling_kernel_t (:545), launched by _fused_sampling_call_t,
// with their core _transition_core_t (:69) and momentum draw
// _gen_momentum_t (:434), and the potential and gradient of
// aehmc_tpu/models/regression.py:logistic_regression_pg_t (:112) that the
// TPU kernel traces into its body.  The plain PyTorch version of both
// kernels is aehmc_tpu_torch/ops/nuts_fused_small.py.
//
// What bounds it on the card.  A gradient of the 100-d, 1,000-point
// logistic posterior is two data products, X·q and Xᵀ·(σ(X·q) − y): 2·10^5
// fused multiply-adds per chain, in float32 on the CUDA cores (TF32 is off:
// the tests hold the kernels to float32 results).  X and Xᵀ are 400 KB
// each; they do not fit in shared memory (227 KB a block) but sit in the
// 50 MB L2, so every product streams them from L2 and the bytes per chain
// fall as the chains per block grow.  The NUTS state (edges, proposals,
// momentum sums and 2·K checkpoint rows of `dim` floats per chain) is the
// other consumer of shared memory, and it caps the chains per block.
//
// Design.  The potential and gradient are a device functor, a template
// parameter of the core and of both kernels; LogisticPG is the one
// instantiated.  A block of CB = 8 warps owns 8 chains, one warp per chain, and
// keeps all of their NUTS state in shared memory (107 KB at dim 100, K 6:
// two blocks per SM).  Every per-chain decision is warp-uniform, so the tree
// walk has no divergence inside a warp; a warp whose chain has stopped idles
// through the rest of the block's tree, the early exit being block-wide as
// on the TPU.  The gradient is computed by the whole block for its 8 chains
// at once: points in chunks of 256, one thread per point for X·q (Xᵀ read
// coalesced from L2, q from shared memory as float4 broadcasts), then one
// thread per (dimension, half-chunk) for Xᵀ·r.  Reductions run in a fixed
// order and products use explicit fmaf with -fmad=false elsewhere, so a
// result does not depend on timing or on where the core is inlined: the
// whole-run kernel equals one launch per draw bit for bit.
//
// Randomness is external (tensors, for parity with the NumPy oracle) or
// Philox4x32-10 keyed by the draw's seed with counter (chain, index, stream,
// 0); the plain version computes the same streams (ops/philox.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CB = 8;          // chains per block = warps per block
constexpr int NT = CB * 32;    // threads per block = points per chunk
constexpr int HALF = NT / 2;
constexpr float NEG_INF = -1e30f;
constexpr float TWO_PI = 6.283185307179586f;
constexpr uint32_t DRAW_SEED_STRIDE = 104729u;
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const float* im;  // inverse mass: (dim,) or (dim, dim)
  const float* ms;  // mass sqrt L^{-T} (dim, dim), dense metric only
  int dense;
  float eps, thr;
  int dim, C, K;
  int ds;           // row stride in shared memory: dim rounded up to 4
};

// randomness of one transition: external tensors or a Philox key
struct Rand {
  const float* p;     // (dim, C)
  const float* dirs;  // (K, C)
  const float* ub;    // (K, C)
  const float* ul;    // (2^K, C)
  uint32_t seed;
  int seeded;
};

// Shared memory of a block; rbuf and gpart are the potential's scratch.
struct Smem {
  float *prop_q, *prop_g, *left_q, *left_p, *left_g, *right_q, *right_p,
      *right_g, *psum, *last_q, *last_p, *last_g, *sprop_q, *sprop_g,
      *s_psum, *ngrad, *tmp, *ck_p, *ck_s, *rbuf, *gpart, *nu;
};

constexpr int NUM_ROWS = 17;  // row arrays of Smem before the checkpoints

__host__ __device__ inline size_t smem_floats(int ds, int K) {
  const size_t V = (size_t)CB * ds;
  return (NUM_ROWS + 2 * (size_t)K + 2) * V + (size_t)CB * NT + CB;
}

__device__ inline Smem carve(float* base, int ds, int K) {
  const size_t V = (size_t)CB * ds;
  float* p = base;
  auto take = [&p](size_t n) {
    float* r = p;
    p += n;
    return r;
  };
  Smem s;
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
  s.ck_p = take(K * V);
  s.ck_s = take(K * V);
  s.rbuf = take((size_t)CB * NT);
  s.gpart = take(2 * V);
  s.nu = take(CB);
  return s;
}

__device__ __forceinline__ uint4 philox(uint32_t c0, uint32_t c1, uint32_t c2,
                                        uint32_t key) {
  uint32_t c3 = 0, k0 = key, k1 = 0;
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

__device__ __forceinline__ float u01(uint32_t w) {
  return (float)((w >> 8) + 1u) * (1.0f / 16777216.0f);
}

// clip to +-1e30 that keeps NaN (jnp.clip / torch.clamp semantics)
__device__ __forceinline__ float clip(float x) {
  return x != x ? x : fminf(fmaxf(x, NEG_INF), -NEG_INF);
}

__device__ __forceinline__ float logaddexp(float a, float b) {
  return fmaxf(a, b) + log1pf(expf(-fabsf(a - b)));
}

// sum over the warp in a fixed order, the result broadcast from lane 0
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
  return __shfl_sync(FULL, v, 0);
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

// The potential and gradient are a device functor, a template parameter of
// the NUTS core: the whole block calls pg(P, S, q, grad, pot) with the
// block's CB rows of q and gets CB gradient rows and CB potentials back.
//
// LogisticPG: the Bayesian logistic regression posterior,
// U(q) = -sum_n [y_n x_n·q - softplus(x_n·q)] + |q|^2/2 and
// ∇U(q) = Xᵀ(σ(X q) - y) + q, both data products written out here.
struct LogisticPG {
  const float* X;   // (N, dim)
  const float* XT;  // (dim, N)
  const float* y;   // (N,)
  int N;
  __device__ void operator()(const Params& P, const Smem& S, const float* q,
                             float* grad, float* pot) const;
};

__device__ void LogisticPG::operator()(const Params& P, const Smem& S,
                                       const float* q, float* grad,
                                       float* pot) const {
  const int t = threadIdx.x;
  const int dim = P.dim, ds = P.ds;
  float lik[CB];
#pragma unroll
  for (int c = 0; c < CB; ++c) lik[c] = 0.f;
  for (int e = t; e < 2 * CB * ds; e += NT) S.gpart[e] = 0.f;

  for (int n0 = 0; n0 < N; n0 += NT) {
    // X·q for point n0 + t, all 8 chains; then σ − y into rbuf
    const int n = n0 + t;
    if (n < N) {
      float acc[CB];
#pragma unroll
      for (int c = 0; c < CB; ++c) acc[c] = 0.f;
      int d = 0;
      for (; d + 4 <= dim; d += 4) {
        const float x0 = __ldg(XT + (size_t)d * N + n);
        const float x1 = __ldg(XT + (size_t)(d + 1) * N + n);
        const float x2 = __ldg(XT + (size_t)(d + 2) * N + n);
        const float x3 = __ldg(XT + (size_t)(d + 3) * N + n);
#pragma unroll
        for (int c = 0; c < CB; ++c) {
          const float4 qv = *reinterpret_cast<const float4*>(q + c * ds + d);
          acc[c] = fmaf(x0, qv.x, acc[c]);
          acc[c] = fmaf(x1, qv.y, acc[c]);
          acc[c] = fmaf(x2, qv.z, acc[c]);
          acc[c] = fmaf(x3, qv.w, acc[c]);
        }
      }
      for (; d < dim; ++d) {
        const float x = __ldg(XT + (size_t)d * N + n);
#pragma unroll
        for (int c = 0; c < CB; ++c) acc[c] = fmaf(x, q[c * ds + d], acc[c]);
      }
      const float yv = __ldg(y + n);
#pragma unroll
      for (int c = 0; c < CB; ++c) {
        const float lg = acc[c];
        const float sp = fmaxf(lg, 0.f) + log1pf(expf(-fabsf(lg)));
        lik[c] += yv * lg - sp;
        S.rbuf[c * NT + t] = 1.f / (1.f + expf(-lg)) - yv;
      }
    } else {
#pragma unroll
      for (int c = 0; c < CB; ++c) S.rbuf[c * NT + t] = 0.f;
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
        const float x0 = __ldg(X + (size_t)m * dim + dd);
        const float x1 = __ldg(X + (size_t)(m + 1) * dim + dd);
        const float x2 = __ldg(X + (size_t)(m + 2) * dim + dd);
        const float x3 = __ldg(X + (size_t)(m + 3) * dim + dd);
#pragma unroll
        for (int c = 0; c < CB; ++c) {
          const float4 rv =
              *reinterpret_cast<const float4*>(S.rbuf + c * NT + (m - n0));
          acc[c] = fmaf(x0, rv.x, acc[c]);
          acc[c] = fmaf(x1, rv.y, acc[c]);
          acc[c] = fmaf(x2, rv.z, acc[c]);
          acc[c] = fmaf(x3, rv.w, acc[c]);
        }
      }
      for (; m < ne; ++m) {
        const float x = __ldg(X + (size_t)m * dim + dd);
#pragma unroll
        for (int c = 0; c < CB; ++c)
          acc[c] = fmaf(x, S.rbuf[c * NT + (m - n0)], acc[c]);
      }
#pragma unroll
      for (int c = 0; c < CB; ++c) S.gpart[(half * CB + c) * ds + dd] += acc[c];
    }
    __syncthreads();
  }

  for (int e = t; e < CB * dim; e += NT) {
    const int c = e / dim, d = e - c * dim;
    grad[c * ds + d] =
        (S.gpart[c * ds + d] + S.gpart[(CB + c) * ds + d]) + q[c * ds + d];
  }
#pragma unroll
  for (int c = 0; c < CB; ++c) S.rbuf[c * NT + t] = lik[c];
  __syncthreads();
  const int w = t / 32, lane = t % 32;
  float s = 0.f;
  for (int k = lane; k < NT; k += 32) s += S.rbuf[w * NT + k];
  s = warp_sum(s);
  float qq = 0.f;
  for (int d = lane; d < dim; d += 32) qq += q[w * ds + d] * q[w * ds + d];
  qq = warp_sum(qq);
  if (lane == 0) pot[w] = -s + 0.5f * qq;
  __syncthreads();
}

// momentum of warp w's chain into row p: external, or Box-Muller from Philox
__device__ void draw_momentum(const Params& P, const Smem& S, const Rand& R,
                              int w, int lane, int chain, float* p) {
  const int dim = P.dim;
  if (!R.seeded) {
    for (int d = lane; d < dim; d += 32) p[d] = R.p[(size_t)d * P.C + chain];
    return;
  }
  float* z = S.tmp + w * P.ds;
  for (int j = lane; j < (dim + 3) / 4; j += 32) {
    const uint4 b = philox((uint32_t)chain, (uint32_t)j, 0u, R.seed);
    const float r0 = sqrtf(-2.0f * logf(u01(b.x))), a0 = TWO_PI * u01(b.y);
    const float r1 = sqrtf(-2.0f * logf(u01(b.z))), a1 = TWO_PI * u01(b.w);
    const float v[4] = {r0 * cosf(a0), r0 * sinf(a0), r1 * cosf(a1),
                        r1 * sinf(a1)};
    for (int k = 0; k < 4; ++k)
      if (4 * j + k < dim) z[4 * j + k] = v[k];
  }
  __syncwarp();
  if (P.dense) {
    apply_dense(P, P.ms, z, p, lane);
  } else {
    for (int d = lane; d < dim; d += 32) p[d] = sqrtf(1.0f / P.im[d]) * z[d];
  }
  __syncwarp();
}

__device__ __forceinline__ float rand_dir(const Rand& R, int C, int chain,
                                          int d) {
  if (R.seeded)
    return u01(philox((uint32_t)chain, (uint32_t)d, 1u, R.seed).x) < 0.5f
               ? -1.f
               : 1.f;
  return R.dirs[(size_t)d * C + chain];
}

__device__ __forceinline__ float rand_bias(const Rand& R, int C, int chain,
                                           int d) {
  if (R.seeded) return u01(philox((uint32_t)chain, (uint32_t)d, 2u, R.seed).x);
  return R.ub[(size_t)d * C + chain];
}

__device__ __forceinline__ float rand_leaf(const Rand& R, int C, int chain,
                                           int idx) {
  if (R.seeded)
    return u01(philox((uint32_t)chain, (uint32_t)idx, 3u, R.seed).x);
  return R.ul[(size_t)idx * C + chain];
}

struct Stats {
  float u, energy, accept, doublings, leaves, div, turn;
};

// One NUTS transition of the block's chains.  On entry prop_q / prop_g hold
// each chain's (q, ∇U) and u0 its potential; on exit they hold the proposal.
template <class PG>
__device__ Stats nuts_core(const Params& P, const PG& pg_fn, const Smem& S,
                           const Rand& R, int chain, bool valid, float u0) {
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
    draw_momentum(P, S, R, w, lane, chain, lp);
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
      dir = rand_dir(R, P.C, chain, d);
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
    const float d_eps = dir * P.eps;
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
      pg_fn(P, S, S.last_q, S.ngrad, S.nu);
      if (!live) continue;

      float un = S.nu[w];
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
        const float u = rand_leaf(R, P.C, chain, nleaf - 1 + i);
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
      if (clean && rand_bias(R, P.C, chain, d) < p_acc) {
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

__device__ void load_chain(const Params& P, const Smem& S, const float* q,
                           const float* g, int w, int lane, int chain,
                           bool valid) {
  for (int d = lane; d < P.dim; d += 32) {
    S.prop_q[w * P.ds + d] = valid ? q[(size_t)d * P.C + chain] : 0.f;
    S.prop_g[w * P.ds + d] = valid ? g[(size_t)d * P.C + chain] : 0.f;
  }
}

__device__ void store_chain(const Params& P, const Smem& S, float* q_out,
                            float* u_out, float* g_out, int w, int lane,
                            int chain, float u) {
  for (int d = lane; d < P.dim; d += 32) {
    q_out[(size_t)d * P.C + chain] = S.prop_q[w * P.ds + d];
    g_out[(size_t)d * P.C + chain] = S.prop_g[w * P.ds + d];
  }
  if (lane == 0) u_out[chain] = u;
}

// stats rows [energy, accept, doublings, leaves, div, turn, 0, 0]
__device__ void store_stats(float* stats, int C, int chain, int lane,
                            const Stats& st) {
  if (lane < 8) {
    const float v[8] = {st.energy, st.accept, st.doublings, st.leaves,
                        st.div,    st.turn,   0.f,          0.f};
    stats[(size_t)lane * C + chain] = v[lane];
  }
}

template <class PG>
__global__ void __launch_bounds__(NT, 2)
    nuts_transition_kernel(Params P, PG pg_fn, Rand R, const float* q,
                           const float* u, const float* g, float* q_out,
                           float* u_out, float* g_out, float* stats) {
  extern __shared__ float4 smem_raw[];
  const Smem S = carve(reinterpret_cast<float*>(smem_raw), P.ds, P.K);
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chain = blockIdx.x * CB + w;
  const bool valid = chain < P.C;
  load_chain(P, S, q, g, w, lane, chain, valid);
  __syncwarp();
  const Stats st =
      nuts_core(P, pg_fn, S, R, chain, valid, valid ? u[chain] : 0.f);
  if (valid) {
    store_chain(P, S, q_out, u_out, g_out, w, lane, chain, st.u);
    store_stats(stats, P.C, chain, lane, st);
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

template <class PG, typename T>
__global__ void __launch_bounds__(NT, 2)
    nuts_sampling_kernel(Params P, PG pg_fn, uint32_t seed, int num_draws,
                         const float* q, const float* u, const float* g,
                         T* pos, float* stats, float* q_out, float* u_out,
                         float* g_out) {
  extern __shared__ float4 smem_raw[];
  const Smem S = carve(reinterpret_cast<float*>(smem_raw), P.ds, P.K);
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chain = blockIdx.x * CB + w;
  const bool valid = chain < P.C;
  load_chain(P, S, q, g, w, lane, chain, valid);
  __syncwarp();
  float uc = valid ? u[chain] : 0.f;
  Rand R = {nullptr, nullptr, nullptr, nullptr, 0u, 1};
  for (int t = 0; t < num_draws; ++t) {
    R.seed = seed + (uint32_t)t * DRAW_SEED_STRIDE;
    const Stats st = nuts_core(P, pg_fn, S, R, chain, valid, uc);
    uc = st.u;
    if (valid) {
      if (pos) {
        T* row = pos + ((size_t)t * P.C + chain) * P.dim;
        for (int d = lane; d < P.dim; d += 32)
          row[d] = to_collect<T>(S.prop_q[w * P.ds + d]);
      }
      store_stats(stats + (size_t)t * 8 * P.C, P.C, chain, lane, st);
    }
  }
  if (valid) store_chain(P, S, q_out, u_out, g_out, w, lane, chain, uc);
}

Params make_params(const float* im, const float* ms, int dense, float eps,
                   float thr, int dim, int C, int K) {
  Params P;
  P.im = im;
  P.ms = ms;
  P.dense = dense;
  P.eps = eps;
  P.thr = thr;
  P.dim = dim;
  P.C = C;
  P.K = K;
  P.ds = (dim + 3) / 4 * 4;
  return P;
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, const Params& P, int N, size_t* smem) {
  if (P.dim < 1 || N < 1 || P.C < 1 || P.K < 1 || P.K > 14)
    return cudaErrorInvalidValue;
  *smem = smem_floats(P.ds, P.K) * sizeof(float);
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Kernel 1: one transition.  q, g, p: (dim, C); u: (C,); dirs, ub: (K, C);
// ul: (2^K, C); stats: (8, C).  use_seed selects Philox randomness keyed by
// seed (p, dirs, ub and ul are then unused).
int nuts_transition_launch(const float* q, const float* u, const float* g,
                           const float* p, const float* dirs, const float* ub,
                           const float* ul, int use_seed, unsigned int seed,
                           const float* X, const float* XT, const float* y,
                           const float* im, const float* ms, int dense,
                           float eps, float thr, int dim, int N, int C, int K,
                           float* q_out, float* u_out, float* g_out,
                           float* stats, void* stream) {
  const Params P = make_params(im, ms, dense, eps, thr, dim, C, K);
  const LogisticPG pg = {X, XT, y, N};
  const Rand R = {p, dirs, ub, ul, seed, use_seed};
  size_t smem = 0;
  cudaError_t err = prepare(nuts_transition_kernel<LogisticPG>, P, N, &smem);
  if (err != cudaSuccess) return (int)err;
  nuts_transition_kernel<LogisticPG><<<(C + CB - 1) / CB, NT, smem,
                                       (cudaStream_t)stream>>>(
      P, pg, R, q, u, g, q_out, u_out, g_out, stats);
  return (int)cudaGetLastError();
}

// Kernel 2: num_draws transitions, draw t keyed by seed + t*DRAW_SEED_STRIDE.
// pos: (draws, C, dim) float32 or bfloat16 (pos_bf16), or null;
// stats: (draws, 8, C).
int nuts_sampling_launch(const float* q, const float* u, const float* g,
                         unsigned int seed, int num_draws, const float* X,
                         const float* XT, const float* y, const float* im,
                         const float* ms, int dense, float eps, float thr,
                         int dim, int N, int C, int K, void* pos, int pos_bf16,
                         float* stats, float* q_out, float* u_out,
                         float* g_out, void* stream) {
  const Params P = make_params(im, ms, dense, eps, thr, dim, C, K);
  const LogisticPG pg = {X, XT, y, N};
  size_t smem = 0;
  const int blocks = (C + CB - 1) / CB;
  cudaError_t err;
  if (pos_bf16) {
    err = prepare(nuts_sampling_kernel<LogisticPG, __nv_bfloat16>, P, N, &smem);
    if (err != cudaSuccess) return (int)err;
    nuts_sampling_kernel<LogisticPG, __nv_bfloat16>
        <<<blocks, NT, smem, (cudaStream_t)stream>>>(
            P, pg, seed, num_draws, q, u, g,
            static_cast<__nv_bfloat16*>(pos), stats, q_out, u_out, g_out);
  } else {
    err = prepare(nuts_sampling_kernel<LogisticPG, float>, P, N, &smem);
    if (err != cudaSuccess) return (int)err;
    nuts_sampling_kernel<LogisticPG, float>
        <<<blocks, NT, smem, (cudaStream_t)stream>>>(
            P, pg, seed, num_draws, q, u, g, static_cast<float*>(pos), stats,
            q_out, u_out, g_out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
