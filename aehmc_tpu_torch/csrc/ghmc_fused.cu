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
// The plain PyTorch version of both kernels is
// aehmc_tpu_torch/ops/ghmc_fused.py.
//
// A transition: partial momentum refresh p0 = α p + √(1−α²) ξ with
// ξ ~ N(0, M), L leapfrog steps, Metropolis-Hastings on the energy error
// with the momentum flipped on rejection (the accepted momentum is stored
// as it is, a rejection stores −p0).  ε, α and the diagonal M⁻¹ are per
// chain.  The segment kernel equals one launch of the transition kernel
// per draw bit for bit.

#include "hmc_core.cuh"

using namespace aehmc;
using namespace aehmc::hmc;

namespace {

Params make_params(const float* eps, const float* alpha, const float* im,
                   int im_per_chain, float thr, int dim, int C, int L) {
  Params P;
  P.eps = eps;
  P.alpha = alpha;
  P.im = im;
  P.ms = nullptr;
  P.im_per_chain = im_per_chain;
  P.Ld = nullptr;
  P.L = L;
  P.thr = thr;
  P.dim = dim;
  P.C = C;
  P.ds = (dim + 3) / 4 * 4;
  return P;
}

template <typename XT>
cudaError_t launch_transition(const Params& P, const LogisticPGT<XT>& pg,
                              const Rand& R, const Geometry& G,
                              const float* q, const float* u, const float* g,
                              const float* p, float* q_out, float* u_out,
                              float* g_out, float* p_out, float* stats,
                              cudaStream_t stream) {
  return launch(transition_kernel<LogisticPGT<XT>, false, false, false>, P,
                pg.N, G, stream, P, pg, R, q, u, g, p, q_out, u_out, g_out,
                p_out, stats, nullptr, nullptr);
}

template <typename XT>
cudaError_t launch_segment(const Params& P, const LogisticPGT<XT>& pg,
                           const Rand& R, int num_draws, const Geometry& G,
                           const float* q, const float* u, const float* g,
                           const float* p, float* pos, float* stats,
                           float* q_out, float* u_out, float* g_out,
                           float* p_out, cudaStream_t stream) {
  return launch(segment_kernel<LogisticPGT<XT>, false, false>, P, pg.N, G,
                stream, P, pg, R, num_draws, q, u, g, p, pos, stats, q_out,
                u_out, g_out, p_out);
}

}  // namespace

extern "C" {

// Kernel 5: one transition.  q, g, p, noise: (dim, C); u, eps, alpha, ua:
// (C,); X: (N, row_stride) float32, or bfloat16 (x_bf16: the data
// products' operands in bfloat16); im: (dim,) or (dim, C) (im_per_chain);
// stats: (8, C).  use_seed selects Philox randomness keyed by seed (noise
// and ua are then unused).  blocks, points, row_stride and smem are the
// launch plan's (aehmc_tpu_torch/ops/launch_plan.py).
int ghmc_transition_launch(const float* q, const float* u, const float* g,
                           const float* p, const float* noise,
                           const float* ua, int use_seed, unsigned int seed,
                           const void* X, int x_bf16, const float* y,
                           const float* eps, const float* alpha,
                           const float* im, int im_per_chain, float thr,
                           int dim, int N, int C, int L, float* q_out,
                           float* u_out, float* g_out, float* p_out,
                           float* stats, int blocks, int points,
                           int row_stride, int smem, void* stream) {
  const Params P =
      make_params(eps, alpha, im, im_per_chain, thr, dim, C, L);
  const Rand R = {noise, ua, seed, use_seed};
  const Geometry G = {blocks, points, row_stride, smem};
  const cudaStream_t s = (cudaStream_t)stream;
  if (x_bf16) {
    const LogisticPGB pg = {static_cast<const __nv_bfloat16*>(X), y, N,
                            row_stride, points, 1.0f};
    return (int)launch_transition(P, pg, R, G, q, u, g, p, q_out, u_out,
                                  g_out, p_out, stats, s);
  }
  const LogisticPG pg = {static_cast<const float*>(X), y, N, row_stride,
                         points, 1.0f};
  return (int)launch_transition(P, pg, R, G, q, u, g, p, q_out, u_out, g_out,
                                p_out, stats, s);
}

// Kernel 6: num_draws transitions.  noise: (draws, dim, C), ua: (draws, C),
// or the Philox key seed + t*DRAW_SEED_STRIDE for draw t (use_seed).  X as
// kernel 5's; pos: (draws, C, dim) or null; stats: (draws, 8, C).
int ghmc_segment_launch(const float* q, const float* u, const float* g,
                        const float* p, const float* noise, const float* ua,
                        int use_seed, unsigned int seed, int num_draws,
                        const void* X, int x_bf16, const float* y,
                        const float* eps, const float* alpha, const float* im,
                        int im_per_chain, float thr, int dim, int N, int C,
                        int L, float* pos, float* stats, float* q_out,
                        float* u_out, float* g_out, float* p_out, int blocks,
                        int points, int row_stride, int smem, void* stream) {
  const Params P =
      make_params(eps, alpha, im, im_per_chain, thr, dim, C, L);
  const Rand R = {noise, ua, seed, use_seed};
  const Geometry G = {blocks, points, row_stride, smem};
  const cudaStream_t s = (cudaStream_t)stream;
  if (num_draws < 1) return (int)cudaErrorInvalidValue;
  if (x_bf16) {
    const LogisticPGB pg = {static_cast<const __nv_bfloat16*>(X), y, N,
                            row_stride, points, 1.0f};
    return (int)launch_segment(P, pg, R, num_draws, G, q, u, g, p, pos, stats,
                               q_out, u_out, g_out, p_out, s);
  }
  const LogisticPG pg = {static_cast<const float*>(X), y, N, row_stride,
                         points, 1.0f};
  return (int)launch_segment(P, pg, R, num_draws, G, q, u, g, p, pos, stats,
                             q_out, u_out, g_out, p_out, s);
}

}  // extern "C"
