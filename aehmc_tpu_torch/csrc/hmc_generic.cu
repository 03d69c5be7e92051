// Fused GHMC and ChEES for the NVIDIA H100 (sm_90a) on a generated
// potential functor: kernels 5 (`ghmc_transition`) and 6 (`ghmc_segment`),
// chains in the last axis, and kernel 7 (`chees_transition`, the standard
// layout, diagonal or dense M⁻¹), the core of hmc_core.cuh with its design
// notes and bounds, templated on struct GenericPG, which
// aehmc_tpu_torch/ops/generic_pg.py writes from the potential's traced
// gradient graph.
//
// Replaces, for any potential, the TPU kernels that trace a jnp potential
// into their body and differentiate it there (jax.vjp):
//   aehmc_tpu/ops/ghmc_fused.py: _make_ghmc_kernel_t (:139, its pot_grad
//     :165) and _make_ghmc_sampling_kernel_t (:329, :374), which the MEADS
//     adapters (:680, :792) launch too;
//   aehmc_tpu/ops/chees_fused.py: _make_chees_kernel_t (:61, :101).
//
// This file is a template with nuts_generic.cu's include slot: the build
// (ops/_build.py:load_generated) compiles both with AEHMC_GENERIC_PG naming
// the generated functor's file into one library per functor text, so a
// potential bound once serves kernels 1-7.  Its entry points mirror
// ghmc_transition_launch, ghmc_segment_launch (ghmc_fused.cu) and
// chees_transition_launch (chees_fused.cu), with the potential named by
// nuts_generic.cu's table of data pointers and lengths and its global
// workspace (generic_pg.cuh) instead of X and y.  The functor's workspace
// goes to shared memory or to the global buffer as the functor itself says
// (WS_SHARED, fixed when it was emitted); the launch plan sizes shared
// memory the same way (ops/launch_plan.py).  The plain PyTorch versions are
// ops/ghmc_fused.py and ops/chees_fused.py with ops/generic_pg.py:run_plain
// for the potential.

#include "generic_pg.cuh"
#include "hmc_core.cuh"

using namespace aehmc;
using namespace aehmc::hmc;

// the generated functor, which calls the helpers above unqualified
#ifndef AEHMC_GENERIC_PG
#error "AEHMC_GENERIC_PG names the generated functor's file (ops/_build.py)"
#endif
#define AEHMC_QUOTE2(x) #x
#define AEHMC_QUOTE(x) AEHMC_QUOTE2(x)
#include AEHMC_QUOTE(AEHMC_GENERIC_PG)

namespace {

GenericPG make_pg(const void* const* ptrs, const long long* lens, int ndata,
                  float* ws) {
  GenericPG pg = {};
  pg.data.n = ndata;
  for (int j = 0; j < ndata && j < generic::MAX_DATA; ++j) {
    pg.data.ptr[j] = static_cast<const float*>(ptrs[j]);
    pg.data.len[j] = lens[j];
  }
  pg.ws_global = ws;
  return pg;
}

}  // namespace

extern "C" {

// Kernel 5 on the generated functor: q, g, p, noise (dim, C); u, ua (C,);
// eps, alpha (C,) or null for eps0, alpha0; im (dim,) or (dim, C)
// (im_per_chain); stats (8, C).  ptrs, lens: the ndata data operands
// (device pointers, lengths in floats); ws: the global workspace (blocks ×
// 8 × W floats) or null when the functor keeps it in shared memory.  The
// other arguments (chain0 among them) as ghmc_transition_launch's; the
// plan's points and row_stride are 0 (no tile).
int ghmc_transition_generic_launch(
    const float* q, const float* u, const float* g, const float* p,
    const float* noise, const float* ua, int use_seed, unsigned int seed,
    unsigned int chain0, const void* const* ptrs, const long long* lens,
    int ndata, float* ws, const float* eps, const float* alpha, float eps0,
    float alpha0, const float* im, int im_per_chain, float thr, int dim,
    int C, int L, float* q_out, float* u_out, float* g_out, float* p_out,
    float* stats, int blocks, int points, int row_stride, int smem,
    int chains, void* stream) {
  Params P = ghmc_params(eps, alpha, eps0, alpha0, im, im_per_chain, thr,
                         dim, C, L);
  P.chain0 = chain0;
  const Rand R = {noise, ua, seed, use_seed};
  const Geometry G = {blocks, points, row_stride, smem, chains};
  const GenericPG pg = make_pg(ptrs, lens, ndata, ws);
  return (int)launch(transition_kernel_for<GenericPG, false, false, false>(P),
                     P, pg, G, (cudaStream_t)stream, P, pg, R, q, u, g, p,
                     q_out, u_out, g_out, p_out, stats, nullptr, nullptr);
}

// Kernel 6 on the generated functor: num_draws transitions, draw t keyed by
// seed + t*DRAW_SEED_STRIDE or reading the t-th slices of noise (draws,
// dim, C) and ua (draws, C); pos (draws, C, dim) or null; stats (draws, 8,
// C).  The potential's arguments as ghmc_transition_generic_launch's.
int ghmc_segment_generic_launch(
    const float* q, const float* u, const float* g, const float* p,
    const float* noise, const float* ua, int use_seed, unsigned int seed,
    int num_draws, const void* const* ptrs, const long long* lens, int ndata,
    float* ws, const float* eps, const float* alpha, float eps0,
    float alpha0, const float* im, int im_per_chain, float thr, int dim,
    int C, int L, float* pos, float* stats, float* q_out, float* u_out,
    float* g_out, float* p_out, int blocks, int points, int row_stride,
    int smem, int chains, void* stream) {
  if (num_draws < 1) return (int)cudaErrorInvalidValue;
  const Params P = ghmc_params(eps, alpha, eps0, alpha0, im, im_per_chain,
                               thr, dim, C, L);
  const Rand R = {noise, ua, seed, use_seed};
  const Geometry G = {blocks, points, row_stride, smem, chains};
  const GenericPG pg = make_pg(ptrs, lens, ndata, ws);
  return (int)launch(segment_kernel<GenericPG, false, false>, P, pg, G,
                     (cudaStream_t)stream, P, pg, R, num_draws, q, u, g, p,
                     pos, stats, q_out, u_out, g_out, p_out);
}

// Kernel 7 on the generated functor: q, g, p, qp_out, vp_out (C, dim); u,
// ua, eps (C,); im (dim,) or (dim, dim) (dense), ms (dim, dim) with dense
// and use_seed; L a device int32; stats (C, 8).  The potential's arguments
// as ghmc_transition_generic_launch's.
int chees_transition_generic_launch(
    const float* q, const float* u, const float* g, const float* p,
    const float* ua, int use_seed, unsigned int seed, unsigned int chain0,
    const void* const* ptrs, const long long* lens, int ndata, float* ws,
    const float* eps, const float* im, const float* ms, int dense,
    const int* L, float thr, int dim, int C, float* q_out, float* u_out,
    float* g_out, float* stats, float* qp_out, float* vp_out, int blocks,
    int points, int row_stride, int smem, int chains, void* stream) {
  if (!L || (dense && use_seed && !ms)) return (int)cudaErrorInvalidValue;
  Params P = chees_params(eps, im, ms, L, thr, dim, C);
  P.chain0 = chain0;
  const Rand R = {p, ua, seed, use_seed};
  const Geometry G = {blocks, points, row_stride, smem, chains};
  const GenericPG pg = make_pg(ptrs, lens, ndata, ws);
  auto kernel = dense ? transition_kernel_for<GenericPG, true, true, true>(P)
                      : transition_kernel_for<GenericPG, true, false, true>(P);
  return (int)launch(kernel, P, pg, G, (cudaStream_t)stream, P, pg, R, q, u,
                     g, nullptr, q_out, u_out, g_out, nullptr, stats, qp_out,
                     vp_out);
}

// Blocks one SM holds of kernel 5, 6 or 7 (`kernel`; 7 with a dense M⁻¹
// when `dense`) on the generated functor at smem bytes a block, or -1.
int hmc_generic_blocks_per_sm(int kernel, int dense, int smem) {
  switch (kernel) {
    case 5:
      return blocks_per_sm(transition_kernel<GenericPG, false, false, false>,
                           smem);
    case 6:
      return blocks_per_sm(segment_kernel<GenericPG, false, false>, smem);
    case 7:
      return dense ? blocks_per_sm(
                         transition_kernel<GenericPG, true, true, true>, smem)
                   : blocks_per_sm(
                         transition_kernel<GenericPG, true, false, true>,
                         smem);
    default:
      return -1;
  }
}

}  // extern "C"
