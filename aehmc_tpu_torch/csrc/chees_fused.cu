// Fused ChEES-HMC transition for the NVIDIA H100 (sm_90a): kernel
// `chees_transition`, one whole transition per chain (momentum draw, L
// velocity-Verlet steps, Metropolis-Hastings), returning besides the kept
// state the proposed endpoint position and velocity of every chain, which
// the ChEES criterion's cross-chain gradient reads.  It instantiates the HMC
// core of hmc_core.cuh (the GHMC kernels' core) at α 0, in the standard
// (C, dim) layout, with a diagonal or dense M⁻¹.
//
// Replaces the TPU kernel aehmc_tpu/ops/chees_fused.py:_make_chees_kernel_t
// (:61), launched by make_fused_chees_transition (:314), with the logistic
// regression potential (logistic_pg.cuh) that the TPU kernel traces into
// its body on the flagship, with float32 or (the model builder's default)
// bfloat16 data.  Any other potential runs in hmc_generic.cu on a
// generated functor.  The plain PyTorch version is
// aehmc_tpu_torch/ops/chees_fused.py:chees_transition_plain.
//
// The trip count L, shared by every chain, is read from a device int32: the
// driver computes it on the card, so nothing synchronises the stream.  The
// momentum is external (p ~ N(0, M)) or drawn from Philox with GHMC's
// streams, so at α 0 this kernel equals `ghmc_transition` bit for bit.

#include "hmc_core.cuh"

using namespace aehmc;
using namespace aehmc::hmc;

extern "C" {

// Kernel 7: one ChEES transition.  q, g, p, qp_out, vp_out: (C, dim); u, ua,
// eps: (C,); X: (N, row_stride) float32, or bfloat16 (x_bf16: the data
// products' operands in bfloat16); im: (dim,) or (dim, dim) (dense), ms:
// (dim, dim) with dense and use_seed; L: a device int32; stats: (C, 8).
// use_seed selects Philox randomness keyed by seed (p and ua are then
// unused) on the global chain index chain0 + c (chain0 a shard's first
// chain, 0 unsharded).  blocks, points, row_stride, smem and chains (8 or
// 16 a block) are the launch plan's (aehmc_tpu_torch/ops/launch_plan.py).
int chees_transition_launch(const float* q, const float* u, const float* g,
                            const float* p, const float* ua, int use_seed,
                            unsigned int seed, unsigned int chain0,
                            const void* X, int x_bf16,
                            const float* y, const float* eps, const float* im,
                            const float* ms, int dense, const int* L,
                            float thr, int dim, int N, int C, float* q_out,
                            float* u_out, float* g_out, float* stats,
                            float* qp_out, float* vp_out, int blocks,
                            int points, int row_stride, int smem,
                            int chains, void* stream) {
  if (!L || (dense && use_seed && !ms)) return (int)cudaErrorInvalidValue;
  Params P = chees_params(eps, im, ms, L, thr, dim, C);
  P.chain0 = chain0;
  const Rand R = {p, ua, seed, use_seed};
  const Geometry G = {blocks, points, row_stride, smem, chains};
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)with_functor<true, CB>(X, x_bf16, y, N, 1.0f, G, [&](auto pg) {
    using PG = decltype(pg);
    auto kernel = dense ? transition_kernel_for<PG, true, true, true>(P)
                        : transition_kernel_for<PG, true, false, true>(P);
    return launch(kernel, P, pg, G, s, P, pg, R, q, u, g, nullptr, q_out,
                  u_out, g_out, nullptr, stats, qp_out, vp_out);
  });
}

// Blocks one SM holds of kernel 7 with a dense (1) or diagonal M⁻¹, X in
// bfloat16 (x_bf16) or float32, at `chains` (8) a block, with smem bytes
// of shared memory a block (the occupancy API), or -1 on an error.
int chees_blocks_per_sm(int dense, int x_bf16, int chains, int smem) {
  return per_type<true, CB>(x_bf16, chains, -1, [&](auto tag) {
    using PG = decltype(tag);
    return dense ? blocks_per_sm(transition_kernel<PG, true, true, true>, smem)
                 : blocks_per_sm(transition_kernel<PG, true, false, true>,
                                 smem);
  });
}

}  // extern "C"
