// Fused NUTS for the NVIDIA H100 (sm_90a) in the standard layout: one whole
// NUTS transition per chain (kernel `nuts_transition_std`) and the whole
// sampling run in one launch (kernel `nuts_sampling_std`), chain state
// (C, dim), external streams (C, rows), stats (C, 8).  Both run the core of
// nuts_core.cuh (its design notes and bounds) with STD = true, so with the
// same Philox key kernel 3 on q equals kernel 1 on qᵀ bit for bit.
//
// Replaces the TPU kernels of aehmc_tpu/ops/nuts_fused.py:
//   _make_kernel (:452), launched by _fused_call for fused_nuts_transition
//     and make_fused_nuts_transition,
//   _make_sampling_kernel (:507), launched by _fused_sampling_call for
//     sample_fused and sample_fused_logistic(loop_in_kernel=True),
// with their core _transition_core (:117) and the logistic potential of
// _logistic_pot_grad_builder (:878), whose bfloat16 operands
// (matmul_dtype=bfloat16) are the functor's X element type.  The metric is a
// diagonal M⁻¹, as in the TPU kernels.  The plain PyTorch version of both
// kernels is aehmc_tpu_torch/ops/nuts_fused.py.
//
// What bounds it: as kernels 1 and 2, the two data products of every
// gradient (2·N·dim FMAs per chain).  Layout changes nothing in the core;
// a warp's loads and stores of a chain's row are contiguous here, where the
// transposed layout strides them by C.  The launch plan (blocks, points a
// tile, X's row stride, shared memory, the checkpoint buffer) comes from
// aehmc_tpu_torch/ops/launch_plan.py.

#include "nuts_core.cuh"

using namespace aehmc;
using namespace aehmc::nuts;

namespace {

template <typename XT>
cudaError_t launch_transition(const Params& P, const LogisticPGT<XT>& pg,
                              const Rand& R, float* ck, const Geometry& G,
                              const float* q, const float* u, const float* g,
                              float* q_out, float* u_out, float* g_out,
                              float* stats, cudaStream_t stream) {
  return launch(transition_kernel_for<LogisticPGT<XT>, true>(P), P, pg, ck, G,
                stream, P, pg, R, q, u, g, q_out, u_out, g_out, stats, ck);
}

template <typename XT>
cudaError_t launch_sampling(const Params& P, const LogisticPGT<XT>& pg,
                            uint32_t seed, int num_draws, float* ck,
                            const Geometry& G, const float* q, const float* u,
                            const float* g, float* pos, float* stats,
                            float* q_out, float* u_out, float* g_out,
                            cudaStream_t stream) {
  return launch(sampling_kernel_for<LogisticPGT<XT>, float, true>(P), P, pg,
                ck, G, stream, P, pg, seed, num_draws, q, u, g, pos, stats,
                q_out, u_out, g_out, ck);
}

}  // namespace

extern "C" {

// Kernel 3: one transition.  q, g, p: (C, dim); u: (C,); dirs, ub: (C, K);
// ul: (C, 2^K); X: (N, row_stride) float32, or bfloat16 (bf16: the data
// products' operands in bfloat16, X stored rounded); im: (dim,); stats:
// (C, 8); ck: the checkpoint buffer, blocks × 2K × 8 × ds floats (ds = dim
// rounded up to 4).  use_seed selects Philox randomness keyed by seed (p,
// dirs, ub and ul are then unused).  blocks, points, row_stride, smem
// and chains (8) are the launch plan's.
int nuts_transition_std_launch(const float* q, const float* u, const float* g,
                               const float* p, const float* dirs,
                               const float* ub, const float* ul, int use_seed,
                               unsigned int seed, unsigned int chain0,
                               const void* X,
                               const float* y, const float* im, float eps,
                               float thr, float prior_precision, int bf16,
                               int dim, int N, int C, int K, float* q_out,
                               float* u_out, float* g_out, float* stats,
                               float* ck, int blocks, int points,
                               int row_stride, int smem, int chains,
                           void* stream) {
  const Params P = make_params(im, nullptr, 0, eps, nullptr, thr, dim, C, K,
                               chain0);
  const Rand R = {p, dirs, ub, ul, seed, use_seed};
  const Geometry G = {blocks, points, row_stride, smem, chains};
  const cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    const LogisticPGB pg = {static_cast<const __nv_bfloat16*>(X), y, N,
                            row_stride, points, prior_precision};
    return (int)launch_transition(P, pg, R, ck, G, q, u, g, q_out, u_out,
                                  g_out, stats, s);
  }
  const LogisticPG pg = {static_cast<const float*>(X), y, N, row_stride,
                         points, prior_precision};
  return (int)launch_transition(P, pg, R, ck, G, q, u, g, q_out, u_out, g_out,
                                stats, s);
}

// Kernel 4: num_draws transitions, draw t keyed by seed + t*DRAW_SEED_STRIDE.
// X, bf16 and ck as kernel 3's; pos: (draws, C, dim) float32 or null;
// stats: (draws, C, 8).
int nuts_sampling_std_launch(const float* q, const float* u, const float* g,
                             unsigned int seed, unsigned int chain0,
                             int num_draws, const void* X,
                             const float* y, const float* im, float eps,
                             float thr, float prior_precision, int bf16,
                             int dim, int N, int C, int K, float* pos,
                             float* stats, float* q_out, float* u_out,
                             float* g_out, float* ck, int blocks, int points,
                             int row_stride, int smem, int chains,
                           void* stream) {
  const Params P = make_params(im, nullptr, 0, eps, nullptr, thr, dim, C, K,
                               chain0);
  const Geometry G = {blocks, points, row_stride, smem, chains};
  const cudaStream_t s = (cudaStream_t)stream;
  if (num_draws < 1) return (int)cudaErrorInvalidValue;
  if (bf16) {
    const LogisticPGB pg = {static_cast<const __nv_bfloat16*>(X), y, N,
                            row_stride, points, prior_precision};
    return (int)launch_sampling(P, pg, seed, num_draws, ck, G, q, u, g, pos,
                                stats, q_out, u_out, g_out, s);
  }
  const LogisticPG pg = {static_cast<const float*>(X), y, N, row_stride,
                         points, prior_precision};
  return (int)launch_sampling(P, pg, seed, num_draws, ck, G, q, u, g, pos,
                              stats, q_out, u_out, g_out, s);
}

// Blocks one SM holds of kernel 3 (sampling 0) or kernel 4 (sampling 1)
// with bfloat16 (bf16) or float32 operands, at smem bytes a block.
int nuts_std_blocks_per_sm(int sampling, int bf16, int smem) {
  if (sampling)
    return bf16 ? blocks_per_sm(nuts_sampling_kernel<LogisticPGB, float, true>,
                                smem)
                : blocks_per_sm(nuts_sampling_kernel<LogisticPG, float, true>,
                                smem);
  return bf16 ? blocks_per_sm(nuts_transition_kernel<LogisticPGB, true>, smem)
              : blocks_per_sm(nuts_transition_kernel<LogisticPG, true>, smem);
}

}  // extern "C"
