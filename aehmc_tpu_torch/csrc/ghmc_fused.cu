// Fused GHMC for the NVIDIA H100 (sm_90a): one whole GHMC transition per
// chain (kernel `ghmc_transition`) and a segment of `num_draws` transitions
// in one launch (kernel `ghmc_segment`).  Both run the same __device__ core.
//
// Replaces the TPU kernels of aehmc_tpu/ops/ghmc_fused.py:
//   _make_ghmc_kernel_t (:139), launched by make_fused_ghmc_transition,
//   _make_ghmc_sampling_kernel_t (:329), launched by fused_ghmc_segment,
// with their core _ghmc_core_t (:57) and in-kernel noise _ghmc_noise_t
// (:125).  The potential is the logistic regression posterior
// (logistic_pg.cuh), the model the TPU kernel traces into its body on the
// flagship.  The plain PyTorch version of both kernels is
// aehmc_tpu_torch/ops/ghmc_fused.py.
//
// A transition: partial momentum refresh p0 = α p + √(1−α²) ξ with
// ξ ~ N(0, M), L leapfrog steps, Metropolis-Hastings on the energy error
// with the momentum flipped on rejection (the accepted momentum is stored
// as it is, a rejection stores −p0).  ε, α and the diagonal M⁻¹ are per
// chain.
//
// What bounds it on the card: the L gradients, each 2·N·dim float32
// multiply-adds per chain (the fused leapfrog and MH around them are a few
// passes over dim floats).  X and Xᵀ stream from L2 for every gradient of a
// block, as in the NUTS kernels.
//
// Design.  The NUTS kernels' layout: one warp per chain, CB = 8 chains per
// block, the potential computed by the whole block for its 8 chains at
// once.  GHMC has no per-chain control flow (every chain takes L steps), so
// no warp idles.  A block keeps q, ∇U, p, the trajectory's q, p, ∇U and the
// M⁻¹ column of its chains in shared memory, 7 rows of dim floats per chain
// plus the functor's scratch (37 KB at dim 100), so several blocks fit on
// an SM; registers are the tighter limit, and the kernels are built for
// three blocks (24 warps) per SM.  The segment kernel keeps that state in shared memory across its
// draws and writes each draw's positions (a chain's row contiguous, so the
// warp's store is coalesced) and stats to global memory.  The kinetic
// energy is a warp sum in a fixed order and the products use explicit fmaf
// or none (-fmad=false), so the segment kernel equals one launch of the
// transition kernel per draw bit for bit.
//
// Randomness is external (ξ and the MH uniform as tensors) or Philox keyed
// by the draw's seed: ξ = √(1/M⁻¹)·z with z the MOMENTUM stream's normals,
// the uniform from the ACCEPT stream (ops/philox.py:ghmc_streams).

#include "logistic_pg.cuh"

using namespace aehmc;

namespace {

struct Params {
  const float* eps;    // (C,)
  const float* alpha;  // (C,)
  const float* im;     // diagonal M^{-1}: (dim,) shared or (dim, C)
  int im_per_chain;
  float thr;
  int dim, C, L;
  int ds;              // row stride in shared memory: dim rounded up to 4
};

// randomness of one transition: external tensors or a Philox key
struct Rand {
  const float* noise;  // (dim, C): ξ ~ N(0, M)
  const float* ua;     // (C,)
  uint32_t seed;
  int seeded;
};

struct Smem {
  float *q, *g, *p, *tq, *tp, *tg, *im, *rbuf, *gpart, *nu;
};

constexpr int NUM_ROWS = 7;  // row arrays of Smem
// blocks per SM the register allocation must allow (at most 85 registers a
// thread); shared memory would allow six
constexpr int MIN_BLOCKS = 3;

__host__ __device__ inline size_t smem_floats(int ds) {
  const size_t V = (size_t)CB * ds;
  return (NUM_ROWS + 2) * V + (size_t)CB * NT + CB;
}

__device__ inline Smem carve(float* base, int ds) {
  const size_t V = (size_t)CB * ds;
  Smem s;
  s.q = base;
  s.g = s.q + V;
  s.p = s.g + V;
  s.tq = s.p + V;
  s.tp = s.tq + V;
  s.tg = s.tp + V;
  s.im = s.tg + V;
  s.rbuf = s.im + V;
  s.gpart = s.rbuf + (size_t)CB * NT;
  s.nu = s.gpart + 2 * V;
  return s;
}

// 0.5 pᵀ M⁻¹ p for one chain (diagonal M⁻¹)
__device__ __forceinline__ float kinetic(const float* p, const float* im,
                                         int dim, int lane) {
  float acc = 0.f;
  for (int d = lane; d < dim; d += 32) acc += p[d] * (im[d] * p[d]);
  return 0.5f * warp_sum(acc);
}

struct Stats {
  float energy, accept, div;
};

// One GHMC transition of the block's chains.  On entry q, g, p hold each
// warp's chain state and u its potential; on exit they hold the new state.
template <class PG>
__device__ Stats ghmc_core(const Params& P, const PG& pg_fn, const Smem& S,
                           const Rand& R, int chain, bool valid, float& u) {
  const int t = threadIdx.x, w = t / 32, lane = t % 32;
  const int dim = P.dim, ds = P.ds;
  float* const q = S.q + w * ds;
  float* const g = S.g + w * ds;
  float* const p = S.p + w * ds;
  float* const tq = S.tq + w * ds;
  float* const tp = S.tp + w * ds;
  float* const tg = S.tg + w * ds;
  const float* const im = S.im + w * ds;
  const float eps = valid ? P.eps[chain] : 0.f;
  const float alpha = valid ? P.alpha[chain] : 0.f;
  const float h = 0.5f * eps;
  float e0 = 0.f, un = u;

  if (valid) {  // partial refresh into p, then the trajectory starts at q
    if (R.seeded) normal_row((uint32_t)chain, R.seed, dim, lane, tp);
    __syncwarp();
    const float beta = sqrtf(1.0f - alpha * alpha);
    for (int d = lane; d < dim; d += 32) {
      const float xi = R.seeded ? sqrtf(1.0f / im[d]) * tp[d]
                                : R.noise[(size_t)d * P.C + chain];
      p[d] = alpha * p[d] + beta * xi;
    }
    __syncwarp();
    e0 = u + kinetic(p, im, dim, lane);
    for (int d = lane; d < dim; d += 32) {
      tq[d] = q[d];
      tp[d] = p[d];
      tg[d] = g[d];
    }
  }
  for (int s = 0; s < P.L; ++s) {  // every chain of the block takes L steps
    if (valid) {
      for (int d = lane; d < dim; d += 32) {
        tp[d] = tp[d] - h * tg[d];
        tq[d] = tq[d] + eps * (im[d] * tp[d]);
      }
    }
    __syncthreads();
    pg_fn(dim, ds, S.rbuf, S.gpart, S.tq, S.tg, S.nu);
    if (valid) {
      un = S.nu[w];
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
  if (valid) {  // MH on the energy error, flip on reject
    const float e1 = clip(un + kinetic(tp, im, dim, lane));
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

__device__ void load_chain(const Params& P, const Smem& S, const float* q,
                           const float* g, const float* p, int w, int lane,
                           int chain, bool valid) {
  const size_t row = (size_t)w * P.ds;
  for (int d = lane; d < P.dim; d += 32) {
    const size_t at = (size_t)d * P.C + chain;
    S.q[row + d] = valid ? q[at] : 0.f;
    S.g[row + d] = valid ? g[at] : 0.f;
    S.p[row + d] = valid ? p[at] : 0.f;
    S.im[row + d] = !valid             ? 1.f
                    : P.im_per_chain ? P.im[at]
                                     : P.im[d];
  }
}

__device__ void store_chain(const Params& P, const Smem& S, float* q_out,
                            float* u_out, float* g_out, float* p_out, int w,
                            int lane, int chain, float u) {
  const size_t row = (size_t)w * P.ds;
  for (int d = lane; d < P.dim; d += 32) {
    const size_t at = (size_t)d * P.C + chain;
    q_out[at] = S.q[row + d];
    g_out[at] = S.g[row + d];
    p_out[at] = S.p[row + d];
  }
  if (lane == 0) u_out[chain] = u;
}

// stats rows [energy, accept_prob, 0, L, div, 0, 0, 0]
__device__ void store_stats(float* stats, int C, int L, int chain, int lane,
                            const Stats& st) {
  if (lane < 8) {
    const float v[8] = {st.energy, st.accept, 0.f, (float)L,
                        st.div,    0.f,       0.f, 0.f};
    stats[(size_t)lane * C + chain] = v[lane];
  }
}

template <class PG>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
    ghmc_transition_kernel(Params P, PG pg_fn, Rand R, const float* q,
                           const float* u, const float* g, const float* p,
                           float* q_out, float* u_out, float* g_out,
                           float* p_out, float* stats) {
  extern __shared__ float4 smem_raw[];
  const Smem S = carve(reinterpret_cast<float*>(smem_raw), P.ds);
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chain = blockIdx.x * CB + w;
  const bool valid = chain < P.C;
  load_chain(P, S, q, g, p, w, lane, chain, valid);
  __syncwarp();
  float uc = valid ? u[chain] : 0.f;
  const Stats st = ghmc_core(P, pg_fn, S, R, chain, valid, uc);
  if (valid) {
    store_chain(P, S, q_out, u_out, g_out, p_out, w, lane, chain, uc);
    store_stats(stats, P.C, P.L, chain, lane, st);
  }
}

// Draw t takes the key seed + t*DRAW_SEED_STRIDE, or the t-th slices of the
// external noise (draws, dim, C) and uniforms (draws, C).
template <class PG>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
    ghmc_segment_kernel(Params P, PG pg_fn, Rand R, int num_draws,
                        const float* q, const float* u, const float* g,
                        const float* p, float* pos, float* stats,
                        float* q_out, float* u_out, float* g_out,
                        float* p_out) {
  extern __shared__ float4 smem_raw[];
  const Smem S = carve(reinterpret_cast<float*>(smem_raw), P.ds);
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chain = blockIdx.x * CB + w;
  const bool valid = chain < P.C;
  load_chain(P, S, q, g, p, w, lane, chain, valid);
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
    const Stats st = ghmc_core(P, pg_fn, S, Rt, chain, valid, uc);
    if (valid) {
      if (pos) {
        float* row = pos + ((size_t)t * P.C + chain) * P.dim;
        for (int d = lane; d < P.dim; d += 32) row[d] = S.q[w * P.ds + d];
      }
      store_stats(stats + (size_t)t * 8 * P.C, P.C, P.L, chain, lane, st);
    }
  }
  if (valid) store_chain(P, S, q_out, u_out, g_out, p_out, w, lane, chain, uc);
}

Params make_params(const float* eps, const float* alpha, const float* im,
                   int im_per_chain, float thr, int dim, int C, int L) {
  Params P;
  P.eps = eps;
  P.alpha = alpha;
  P.im = im;
  P.im_per_chain = im_per_chain;
  P.thr = thr;
  P.dim = dim;
  P.C = C;
  P.L = L;
  P.ds = (dim + 3) / 4 * 4;
  return P;
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, const Params& P, int N, size_t* smem) {
  if (P.dim < 1 || N < 1 || P.C < 1 || P.L < 1) return cudaErrorInvalidValue;
  *smem = smem_floats(P.ds) * sizeof(float);
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

}  // namespace

extern "C" {

// Kernel 5: one transition.  q, g, p, noise: (dim, C); u, eps, alpha, ua:
// (C,); im: (dim,) or (dim, C) (im_per_chain); stats: (8, C).  use_seed
// selects Philox randomness keyed by seed (noise and ua are then unused).
int ghmc_transition_launch(const float* q, const float* u, const float* g,
                           const float* p, const float* noise,
                           const float* ua, int use_seed, unsigned int seed,
                           const float* X, const float* XT, const float* y,
                           const float* eps, const float* alpha,
                           const float* im, int im_per_chain, float thr,
                           int dim, int N, int C, int L, float* q_out,
                           float* u_out, float* g_out, float* p_out,
                           float* stats, void* stream) {
  const Params P =
      make_params(eps, alpha, im, im_per_chain, thr, dim, C, L);
  const LogisticPG pg = {X, XT, y, N, 1.0f};
  const Rand R = {noise, ua, seed, use_seed};
  size_t smem = 0;
  cudaError_t err =
      prepare(ghmc_transition_kernel<LogisticPG>, P, N, &smem);
  if (err != cudaSuccess) return (int)err;
  ghmc_transition_kernel<LogisticPG><<<(C + CB - 1) / CB, NT, smem,
                                       (cudaStream_t)stream>>>(
      P, pg, R, q, u, g, p, q_out, u_out, g_out, p_out, stats);
  return (int)cudaGetLastError();
}

// Kernel 6: num_draws transitions.  noise: (draws, dim, C), ua: (draws, C),
// or the Philox key seed + t*DRAW_SEED_STRIDE for draw t (use_seed).
// pos: (draws, C, dim) or null; stats: (draws, 8, C).
int ghmc_segment_launch(const float* q, const float* u, const float* g,
                        const float* p, const float* noise, const float* ua,
                        int use_seed, unsigned int seed, int num_draws,
                        const float* X, const float* XT, const float* y,
                        const float* eps, const float* alpha, const float* im,
                        int im_per_chain, float thr, int dim, int N, int C,
                        int L, float* pos, float* stats, float* q_out,
                        float* u_out, float* g_out, float* p_out,
                        void* stream) {
  const Params P =
      make_params(eps, alpha, im, im_per_chain, thr, dim, C, L);
  const LogisticPG pg = {X, XT, y, N, 1.0f};
  const Rand R = {noise, ua, seed, use_seed};
  size_t smem = 0;
  if (num_draws < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare(ghmc_segment_kernel<LogisticPG>, P, N, &smem);
  if (err != cudaSuccess) return (int)err;
  ghmc_segment_kernel<LogisticPG><<<(C + CB - 1) / CB, NT, smem,
                                    (cudaStream_t)stream>>>(
      P, pg, R, num_draws, q, u, g, p, pos, stats, q_out, u_out, g_out,
      p_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
