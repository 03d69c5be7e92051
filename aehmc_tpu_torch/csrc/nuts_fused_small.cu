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
// TPU kernel traces into its body.  The plain PyTorch version of both
// kernels is aehmc_tpu_torch/ops/nuts_fused_small.py.

#include "nuts_core.cuh"

using namespace aehmc;
using namespace aehmc::nuts;

extern "C" {

// Kernel 1: one transition.  q, g, p: (dim, C); u: (C,); dirs, ub: (K, C);
// ul: (2^K, C); X: (N, row_stride); stats: (8, C).  use_seed selects Philox
// randomness keyed by seed (p, dirs, ub and ul are then unused).  blocks,
// points, row_stride and smem are the launch plan's
// (aehmc_tpu_torch/ops/launch_plan.py).
int nuts_transition_launch(const float* q, const float* u, const float* g,
                           const float* p, const float* dirs, const float* ub,
                           const float* ul, int use_seed, unsigned int seed,
                           const float* X, const float* y, const float* im,
                           const float* ms, int dense, float eps, float thr,
                           int dim, int N, int C, int K, float* q_out,
                           float* u_out, float* g_out, float* stats,
                           int blocks, int points, int row_stride, int smem,
                           void* stream) {
  const Params P = make_params(im, ms, dense, eps, thr, dim, C, K);
  const LogisticPG pg = {X, y, N, row_stride, points, 1.0f};
  const Rand R = {p, dirs, ub, ul, seed, use_seed};
  const Geometry G = {blocks, points, row_stride, smem};
  return (int)launch(nuts_transition_kernel<LogisticPG, false>, P, N, G,
                     (cudaStream_t)stream, P, pg, R, q, u, g, q_out, u_out,
                     g_out, stats);
}

// Kernel 2: num_draws transitions, draw t keyed by seed + t*DRAW_SEED_STRIDE.
// pos: (draws, C, dim) float32 or bfloat16 (pos_bf16), or null;
// stats: (draws, 8, C).
int nuts_sampling_launch(const float* q, const float* u, const float* g,
                         unsigned int seed, int num_draws, const float* X,
                         const float* y, const float* im, const float* ms,
                         int dense, float eps, float thr, int dim, int N,
                         int C, int K, void* pos, int pos_bf16, float* stats,
                         float* q_out, float* u_out, float* g_out, int blocks,
                         int points, int row_stride, int smem,
                         void* stream) {
  const Params P = make_params(im, ms, dense, eps, thr, dim, C, K);
  const LogisticPG pg = {X, y, N, row_stride, points, 1.0f};
  const Geometry G = {blocks, points, row_stride, smem};
  const cudaStream_t s = (cudaStream_t)stream;
  if (pos_bf16)
    return (int)launch(nuts_sampling_kernel<LogisticPG, __nv_bfloat16, false>,
                       P, N, G, s, P, pg, seed, num_draws, q, u, g,
                       static_cast<__nv_bfloat16*>(pos), stats, q_out, u_out,
                       g_out);
  return (int)launch(nuts_sampling_kernel<LogisticPG, float, false>, P, N, G,
                     s, P, pg, seed, num_draws, q, u, g,
                     static_cast<float*>(pos), stats, q_out, u_out, g_out);
}

}  // extern "C"
