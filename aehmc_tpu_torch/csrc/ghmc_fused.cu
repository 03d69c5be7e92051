// Fused GHMC for the NVIDIA H100 (sm_90a): one whole GHMC transition per
// chain (kernel `ghmc_transition`) and a segment of `num_draws` transitions
// in one launch (kernel `ghmc_segment`).  Both instantiate the HMC core of
// hmc_core.cuh in the transposed layout with a diagonal M⁻¹.
//
// Replaces the TPU kernels of aehmc_tpu/ops/ghmc_fused.py:
//   _make_ghmc_kernel_t (:139), launched by make_fused_ghmc_transition,
//   _make_ghmc_sampling_kernel_t (:329), launched by fused_ghmc_segment,
// with their core _ghmc_core_t (:57) and in-kernel noise _ghmc_noise_t
// (:125).  The potential is the logistic regression posterior
// (logistic_pg.cuh), the model the TPU kernel traces into its body on the
// flagship, with float32 or (the model builder's default) bfloat16 data.
// Any other potential runs in hmc_generic.cu on a functor generated from
// its traced gradient graph.  The plain PyTorch version of both kernels is
// aehmc_tpu_torch/ops/ghmc_fused.py.
//
// A transition: partial momentum refresh p0 = α p + √(1−α²) ξ with
// ξ ~ N(0, M), L leapfrog steps, Metropolis-Hastings on the energy error
// with the momentum flipped on rejection (the accepted momentum is stored
// as it is, a rejection stores −p0).  ε, α and the diagonal M⁻¹ are per
// chain; ε and α given as host scalars are launch arguments, so a launch
// fills no row on the card.  The segment kernel equals one launch of the
// transition kernel per draw bit for bit.
//
// Layout and what bounds them (hmc_core.cuh): 8 chains a block, one warp
// each (16, two a warp, lost at 10,240 chains: the grid's last round of
// blocks runs 42% full), two blocks per SM; X's first chunk is requested at
// block entry and each gradient's next one as soon as the tile is read; the
// block moves its (dim, C) state in and out together, a warp taking 4 rows
// × 8 chains.  Kernel 5 (one gradient a launch) is bound by its gradient,
// 2·N·dim float32 multiply-adds per chain on the CUDA cores fed from shared
// memory, and by its fixed work per block (state in and out, the momentum
// draw, the accept test); kernel 6 by its gradients.  The chains a block
// are the launch plan's, a function of dim and X's type alone
// (aehmc_tpu_torch/ops/launch_plan.py), so a chain's bits do not depend on
// the chain count.

#include "hmc_core.cuh"

using namespace aehmc;
using namespace aehmc::hmc;

extern "C" {

// Kernel 5: one transition.  q, g, p, noise: (dim, C); u, ua: (C,); eps,
// alpha: (C,), or null for eps0, alpha0 (a host scalar, filled on the card
// by no launch); X: (N, row_stride) float32, or bfloat16 (x_bf16: the data
// products' operands in bfloat16); im: (dim,) or (dim, C) (im_per_chain);
// stats: (8, C).  use_seed selects Philox randomness keyed by seed (noise
// and ua are then unused) on the global chain index chain0 + c (chain0 a
// shard's first chain, 0 unsharded).  blocks, points, row_stride, smem and
// chains (8 or 16 a block) are the launch plan's
// (aehmc_tpu_torch/ops/launch_plan.py).
int ghmc_transition_launch(const float* q, const float* u, const float* g,
                           const float* p, const float* noise,
                           const float* ua, int use_seed, unsigned int seed,
                           unsigned int chain0, const void* X, int x_bf16,
                           const float* y,
                           const float* eps, const float* alpha, float eps0,
                           float alpha0, const float* im, int im_per_chain,
                           float thr, int dim, int N, int C, int L,
                           float* q_out,
                           float* u_out, float* g_out, float* p_out,
                           float* stats, int blocks, int points,
                           int row_stride, int smem, int chains,
                           void* stream) {
  Params P = ghmc_params(eps, alpha, eps0, alpha0, im, im_per_chain, thr,
                         dim, C, L);
  P.chain0 = chain0;
  const Rand R = {noise, ua, seed, use_seed};
  const Geometry G = {blocks, points, row_stride, smem, chains};
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)with_functor<true, CB>(X, x_bf16, y, N, 1.0f, G, [&](auto pg) {
    return launch(transition_kernel_for<decltype(pg), false, false, false>(P),
                  P, pg, G, s, P, pg, R, q, u, g, p, q_out, u_out, g_out,
                  p_out, stats, nullptr, nullptr);
  });
}

// Kernel 6: num_draws transitions.  noise: (draws, dim, C), ua: (draws, C),
// or the Philox key seed + t*DRAW_SEED_STRIDE for draw t (use_seed),
// on the launch's chain index (never sharded: no chain offset).  X and
// the plan as kernel 5's; pos: (draws, C, dim) or null; stats:
// (draws, 8, C).
int ghmc_segment_launch(const float* q, const float* u, const float* g,
                        const float* p, const float* noise, const float* ua,
                        int use_seed, unsigned int seed, int num_draws,
                        const void* X, int x_bf16, const float* y,
                        const float* eps, const float* alpha, float eps0,
                        float alpha0, const float* im, int im_per_chain,
                        float thr, int dim, int N, int C,
                        int L, float* pos, float* stats, float* q_out,
                        float* u_out, float* g_out, float* p_out, int blocks,
                        int points, int row_stride, int smem, int chains,
                        void* stream) {
  const Params P = ghmc_params(eps, alpha, eps0, alpha0, im, im_per_chain,
                               thr, dim, C, L);
  const Rand R = {noise, ua, seed, use_seed};
  const Geometry G = {blocks, points, row_stride, smem, chains};
  const cudaStream_t s = (cudaStream_t)stream;
  if (num_draws < 1) return (int)cudaErrorInvalidValue;
  return (int)with_functor<true, CB>(X, x_bf16, y, N, 1.0f, G, [&](auto pg) {
    return launch(segment_kernel<decltype(pg), false, false>, P, pg, G, s,
                  P, pg, R, num_draws, q, u, g, p, pos, stats, q_out, u_out,
                  g_out, p_out);
  });
}

// Blocks one SM holds of kernel 5 (segment 0) or kernel 6 (segment 1) with
// X in bfloat16 (x_bf16) or float32 at `chains` (8) a block, with smem
// bytes of shared memory a block (the occupancy API), or -1 on an error.
int ghmc_blocks_per_sm(int segment, int x_bf16, int chains, int smem) {
  return per_type<true, CB>(x_bf16, chains, -1, [&](auto tag) {
    using PG = decltype(tag);
    return segment
               ? blocks_per_sm(segment_kernel<PG, false, false>, smem)
               : blocks_per_sm(transition_kernel<PG, false, false, false>,
                               smem);
  });
}

}  // extern "C"
