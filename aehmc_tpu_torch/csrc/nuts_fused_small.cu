// Fused NUTS for the NVIDIA H100 (sm_90a), chains in the last axis: one
// whole NUTS transition per chain (kernel `nuts_transition`) and the whole
// sampling run, every draw in one launch (kernel `nuts_sampling`).  Both
// run the core of nuts_core.cuh (its design notes and bounds) with the
// transposed global layout.
//
// Replaces the TPU kernels of aehmc_tpu/ops/nuts_fused_small.py:
//   _make_kernel_t (:459), launched by make_fused_nuts_transition_small,
//   _make_sampling_kernel_t (:545), launched by _fused_sampling_call_t,
// with their core _transition_core_t (:69) and momentum draw
// _gen_momentum_t (:434), and the potential and gradient of
// aehmc_tpu/models/regression.py:logistic_regression_pg_t (:112) that the
// TPU kernel traces into its body, with float32 or (the builder's default)
// bfloat16 data; or, through the entry points named *_pot_*, the potential
// and gradient of Neal's funnel or of eight schools
// (aehmc_tpu/models/hierarchical.py:neals_funnel_pg_t :114,
// eight_schools_pg_t :151; functors FunnelPG and EightSchoolsPG,
// hierarchical_pg.cuh), which need no data tile.  ε is one scalar or a
// per-chain row (the kernels' per_chain_eps variant, :462 and :548): each
// warp reads its chain's entry once.  The plain PyTorch version
// of both kernels is aehmc_tpu_torch/ops/nuts_fused_small.py.

#include "hierarchical_pg.cuh"
#include "nuts_core.cuh"

using namespace aehmc;
using namespace aehmc::nuts;

namespace {

template <class PG>
cudaError_t launch_transition(const Params& P, const PG& pg, const Rand& R,
                              float* ck, const Geometry& G, const float* q,
                              const float* u, const float* g, float* q_out,
                              float* u_out, float* g_out, float* stats,
                              cudaStream_t stream) {
  return launch(transition_kernel_for<PG, false>(P), P, pg, ck, G, stream, P,
                pg, R, q, u, g, q_out, u_out, g_out, stats, ck);
}

template <class PG, typename T>
cudaError_t launch_sampling(const Params& P, const PG& pg, uint32_t seed,
                            int num_draws, float* ck, const Geometry& G,
                            const float* q, const float* u, const float* g,
                            T* pos, float* stats, float* q_out, float* u_out,
                            float* g_out, cudaStream_t stream) {
  return launch(sampling_kernel_for<PG, T, false>(P), P, pg, ck, G, stream, P,
                pg, seed, num_draws, q, u, g, pos, stats, q_out, u_out, g_out,
                ck);
}

template <class PG>
cudaError_t sampling_any(const Params& P, const PG& pg,
                         uint32_t seed, int num_draws, float* ck,
                         const Geometry& G, const float* q, const float* u,
                         const float* g, void* pos, int pos_bf16,
                         float* stats, float* q_out, float* u_out,
                         float* g_out, cudaStream_t stream) {
  if (pos_bf16)
    return launch_sampling(P, pg, seed, num_draws, ck, G, q, u, g,
                           static_cast<__nv_bfloat16*>(pos), stats, q_out,
                           u_out, g_out, stream);
  return launch_sampling(P, pg, seed, num_draws, ck, G, q, u, g,
                         static_cast<float*>(pos), stats, q_out, u_out,
                         g_out, stream);
}

// Potentials with no data matrix, by number: 1 Neal's funnel, 2 eight
// schools (data y, σ² of J entries each; the funnel takes none).
enum Model { FUNNEL = 1, EIGHT_SCHOOLS = 2 };

// f(pg), pg the functor of `model`; an invalid value for another number.
template <class F>
cudaError_t with_model(int model, const float* y, const float* s2, int J,
                       F&& f) {
  if (model == FUNNEL) return f(FunnelPG{});
  if (model == EIGHT_SCHOOLS) return f(EightSchoolsPG{{}, y, s2, J});
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Kernel 1: one transition.  q, g, p: (dim, C); u: (C,); dirs, ub: (K, C);
// ul: (2^K, C); X: (N, row_stride) float32, or bfloat16 (x_bf16: the data
// products' operands in bfloat16); stats: (8, C); ck: the checkpoint
// buffer, blocks × 2K × 8 × ds floats (ds = dim rounded up to 4).
// use_seed selects Philox randomness keyed by seed (p, dirs, ub and ul are
// then unused) on the global chain index chain0 + c: chain0 is a shard's
// first chain, 0 unsharded.  eps_row: (C,), chain c's step size, or null
// for eps.
// blocks, points, row_stride, smem and chains (8) are the launch plan's
// (aehmc_tpu_torch/ops/launch_plan.py).
int nuts_transition_launch(const float* q, const float* u, const float* g,
                           const float* p, const float* dirs, const float* ub,
                           const float* ul, int use_seed, unsigned int seed,
                           unsigned int chain0, const void* X, int x_bf16,
                           const float* y,
                           const float* im, const float* ms, int dense,
                           float eps, const float* eps_row, float thr,
                           int dim, int N, int C, int K,
                           float* q_out, float* u_out, float* g_out,
                           float* stats, float* ck, int blocks, int points,
                           int row_stride, int smem, int chains,
                           void* stream) {
  const Params P = make_params(im, ms, dense, eps, eps_row, thr, dim, C, K,
                               chain0);
  const Rand R = {p, dirs, ub, ul, seed, use_seed};
  const Geometry G = {blocks, points, row_stride, smem, chains};
  const cudaStream_t s = (cudaStream_t)stream;
  if (x_bf16) {
    const LogisticPGB pg = {static_cast<const __nv_bfloat16*>(X), y, N,
                            row_stride, points, 1.0f};
    return (int)launch_transition(P, pg, R, ck, G, q, u, g, q_out, u_out,
                                  g_out, stats, s);
  }
  const LogisticPG pg = {static_cast<const float*>(X), y, N, row_stride,
                         points, 1.0f};
  return (int)launch_transition(P, pg, R, ck, G, q, u, g, q_out, u_out, g_out,
                                stats, s);
}

// Kernel 2: num_draws transitions, draw t keyed by seed + t*DRAW_SEED_STRIDE.
// eps_row as kernel 1's: a chain's ε is read once and fixed across its
// draws.  X and ck as kernel 1's; pos: (draws, C, dim) float32 or bfloat16
// (pos_bf16), or null; stats: (draws, 8, C).
int nuts_sampling_launch(const float* q, const float* u, const float* g,
                         unsigned int seed, unsigned int chain0,
                         int num_draws, const void* X,
                         int x_bf16, const float* y, const float* im,
                         const float* ms, int dense, float eps,
                         const float* eps_row, float thr, int dim, int N,
                         int C, int K, void* pos,
                         int pos_bf16, float* stats, float* q_out,
                         float* u_out, float* g_out, float* ck, int blocks,
                         int points, int row_stride, int smem, int chains,
                         void* stream) {
  const Params P = make_params(im, ms, dense, eps, eps_row, thr, dim, C, K,
                               chain0);
  const Geometry G = {blocks, points, row_stride, smem, chains};
  const cudaStream_t s = (cudaStream_t)stream;
  if (num_draws < 1) return (int)cudaErrorInvalidValue;
  if (x_bf16) {
    const LogisticPGB pg = {static_cast<const __nv_bfloat16*>(X), y, N,
                            row_stride, points, 1.0f};
    return (int)sampling_any(P, pg, seed, num_draws, ck, G, q, u, g, pos,
                             pos_bf16, stats, q_out, u_out, g_out, s);
  }
  const LogisticPG pg = {static_cast<const float*>(X), y, N, row_stride,
                         points, 1.0f};
  return (int)sampling_any(P, pg, seed, num_draws, ck, G, q, u, g, pos,
                           pos_bf16, stats, q_out, u_out, g_out, s);
}

// Blocks one SM holds of kernel 1 (sampling 0) or kernel 2 (sampling 1,
// the bfloat16 store) with X in bfloat16 (x_bf16) or float32, at smem
// bytes of shared memory a block.
int nuts_blocks_per_sm(int sampling, int x_bf16, int smem) {
  if (sampling)
    return x_bf16 ? blocks_per_sm(nuts_sampling_kernel<LogisticPGB,
                                                       __nv_bfloat16, false>,
                                  smem)
                  : blocks_per_sm(nuts_sampling_kernel<LogisticPG,
                                                       __nv_bfloat16, false>,
                                  smem);
  return x_bf16 ? blocks_per_sm(nuts_transition_kernel<LogisticPGB, false>,
                                smem)
                : blocks_per_sm(nuts_transition_kernel<LogisticPG, false>,
                                smem);
}

// Kernel 1 on a potential with no data matrix: `model` 1 (the funnel) or
// 2 (eight schools: y, s2 of J = dim − 2 entries each, on the card).  The
// other arguments as nuts_transition_launch's; the plan's points and
// row_stride are 0 (no tile).
int nuts_transition_pot_launch(const float* q, const float* u, const float* g,
                               const float* p, const float* dirs,
                               const float* ub, const float* ul, int use_seed,
                               unsigned int seed, unsigned int chain0,
                               int model, const float* y,
                               const float* s2, int J, const float* im,
                               const float* ms, int dense, float eps,
                               const float* eps_row, float thr, int dim,
                               int C, int K, float* q_out,
                               float* u_out, float* g_out, float* stats,
                               float* ck, int blocks, int points,
                               int row_stride, int smem, int chains,
                               void* stream) {
  const Params P = make_params(im, ms, dense, eps, eps_row, thr, dim, C, K,
                               chain0);
  const Rand R = {p, dirs, ub, ul, seed, use_seed};
  const Geometry G = {blocks, points, row_stride, smem, chains};
  return (int)with_model(model, y, s2, J, [&](auto pg) {
    return launch_transition(P, pg, R, ck, G, q, u, g, q_out, u_out, g_out,
                             stats, (cudaStream_t)stream);
  });
}

// Kernel 2 on a potential with no data matrix (`model`, y, s2, J as
// nuts_transition_pot_launch's; the others as nuts_sampling_launch's).
int nuts_sampling_pot_launch(const float* q, const float* u, const float* g,
                             unsigned int seed, unsigned int chain0,
                             int num_draws, int model,
                             const float* y, const float* s2, int J,
                             const float* im, const float* ms, int dense,
                             float eps, const float* eps_row, float thr,
                             int dim, int C, int K, void* pos, int pos_bf16,
                             float* stats, float* q_out, float* u_out,
                             float* g_out, float* ck, int blocks, int points,
                             int row_stride, int smem, int chains,
                             void* stream) {
  const Params P = make_params(im, ms, dense, eps, eps_row, thr, dim, C, K,
                               chain0);
  const Geometry G = {blocks, points, row_stride, smem, chains};
  if (num_draws < 1) return (int)cudaErrorInvalidValue;
  return (int)with_model(model, y, s2, J, [&](auto pg) {
    return sampling_any(P, pg, seed, num_draws, ck, G, q, u, g, pos,
                        pos_bf16, stats, q_out, u_out, g_out,
                        (cudaStream_t)stream);
  });
}

// Blocks one SM holds of kernel 1 (sampling 0) or kernel 2 (sampling 1,
// the bfloat16 store) with the functor of `model` at smem bytes of shared
// memory a block, or -1.
int nuts_pot_blocks_per_sm(int model, int sampling, int smem) {
  int n = -1;
  with_model(model, nullptr, nullptr, 0, [&](auto pg) {
    using PG = decltype(pg);
    n = sampling ? blocks_per_sm(nuts_sampling_kernel<PG, __nv_bfloat16,
                                                      false>, smem)
                 : blocks_per_sm(nuts_transition_kernel<PG, false>, smem);
    return cudaSuccess;
  });
  return n;
}

}  // extern "C"
