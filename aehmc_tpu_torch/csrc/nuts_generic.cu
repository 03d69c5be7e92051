// Fused NUTS for the NVIDIA H100 (sm_90a) on a generated potential functor:
// kernels 1 and 2 (chains in the last axis) and 3 and 4 (the standard
// layout), the core of nuts_core.cuh with its design notes and bounds,
// templated on struct GenericPG, which aehmc_tpu_torch/ops/generic_pg.py
// writes from the potential's traced gradient graph.
//
// Replaces, for any potential, the TPU kernels that trace a jnp potential
// into their body and differentiate it there (jax.vjp):
//   aehmc_tpu/ops/nuts_fused_small.py: _make_kernel_t (:459) and
//     _make_sampling_kernel_t (:545) with _pot_grad_builder_t (:409-430);
//   aehmc_tpu/ops/nuts_fused.py: _make_kernel (:452) and
//     _make_sampling_kernel (:507) with the vjp of :826-860 and :988-1000.
//
// This file is a template with one include slot: the build
// (ops/_build.py:load_generated) compiles it with AEHMC_GENERIC_PG naming
// the generated functor's file (found on the include path), one library
// per functor text.  Its entry points mirror nuts_*_pot_launch of nuts_fused_small.cu, with the
// potential named by a table of data pointers and lengths and the global
// workspace (generic_pg.cuh) instead of a model number; `std_layout`
// selects kernels 3 and 4 (diagonal M⁻¹, scalar ε, float32 positions, as
// nuts_fused.cu) over kernels 1 and 2.  The plain PyTorch versions are
// ops/nuts_fused_small.py and ops/nuts_fused.py with
// ops/generic_pg.py:run_plain for the potential.

#include "generic_pg.cuh"
#include "nuts_core.cuh"

using namespace aehmc;
using namespace aehmc::nuts;

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

template <bool STD>
cudaError_t transition(const Params& P, const GenericPG& pg, const Rand& R,
                       float* ck, const Geometry& G, const float* q,
                       const float* u, const float* g, float* q_out,
                       float* u_out, float* g_out, float* stats,
                       cudaStream_t stream) {
  return launch(transition_kernel_for<GenericPG, STD>(P), P, pg, ck, G, stream,
                P, pg, R, q, u, g, q_out, u_out, g_out, stats, ck);
}

template <bool STD, typename T>
cudaError_t sampling(const Params& P, const GenericPG& pg, uint32_t seed,
                     int num_draws, float* ck, const Geometry& G,
                     const float* q, const float* u, const float* g, T* pos,
                     float* stats, float* q_out, float* u_out, float* g_out,
                     cudaStream_t stream) {
  return launch(sampling_kernel_for<GenericPG, T, STD>(P), P, pg, ck, G, stream,
                P, pg, seed, num_draws, q, u, g, pos, stats, q_out, u_out,
                g_out, ck);
}

}  // namespace

extern "C" {

// Kernel 1 (std_layout 0: q, g, p (dim, C), dirs, ub (K, C), ul (2^K, C),
// stats (8, C)) or kernel 3 (std_layout 1: the transposes, diagonal im,
// no ms, no eps_row) on the generated functor.  ptrs, lens: the ndata data
// operands (device pointers, lengths in floats); ws: the global workspace
// (blocks × 8 × W floats) or null when the plan keeps it in shared memory.
// The other arguments as nuts_transition_pot_launch's; the plan's points
// and row_stride are 0 (no tile).
int generic_transition_launch(int std_layout, const float* q, const float* u,
                              const float* g, const float* p,
                              const float* dirs, const float* ub,
                              const float* ul, int use_seed,
                              unsigned int seed, unsigned int chain0,
                              const void* const* ptrs,
                              const long long* lens, int ndata, float* ws,
                              const float* im, const float* ms, int dense,
                              float eps, const float* eps_row, float thr,
                              int dim, int C, int K, float* q_out,
                              float* u_out, float* g_out, float* stats,
                              float* ck, int blocks, int points,
                              int row_stride, int smem, int chains,
                              void* stream) {
  if (std_layout && (dense || ms || eps_row))
    return (int)cudaErrorInvalidValue;
  const Params P = make_params(im, ms, dense, eps, eps_row, thr, dim, C, K,
                               chain0);
  const Rand R = {p, dirs, ub, ul, seed, use_seed};
  const Geometry G = {blocks, points, row_stride, smem, chains};
  const GenericPG pg = make_pg(ptrs, lens, ndata, ws);
  const cudaStream_t s = (cudaStream_t)stream;
  if (std_layout)
    return (int)transition<true>(P, pg, R, ck, G, q, u, g, q_out, u_out,
                                 g_out, stats, s);
  return (int)transition<false>(P, pg, R, ck, G, q, u, g, q_out, u_out, g_out,
                                stats, s);
}

// Kernel 2 (std_layout 0: pos (draws, C, dim) float32 or bfloat16
// (pos_bf16), stats (draws, 8, C)) or kernel 4 (std_layout 1: pos float32,
// stats (draws, C, 8)) on the generated functor: num_draws transitions,
// draw t keyed by seed + t*DRAW_SEED_STRIDE.  The potential's arguments as
// generic_transition_launch's.
int generic_sampling_launch(int std_layout, const float* q, const float* u,
                            const float* g, unsigned int seed,
                            unsigned int chain0, int num_draws,
                            const void* const* ptrs, const long long* lens,
                            int ndata, float* ws, const float* im,
                            const float* ms, int dense, float eps,
                            const float* eps_row, float thr, int dim, int C,
                            int K, void* pos, int pos_bf16, float* stats,
                            float* q_out, float* u_out, float* g_out,
                            float* ck, int blocks, int points, int row_stride,
                            int smem, int chains, void* stream) {
  if (num_draws < 1 || (std_layout && (dense || ms || eps_row || pos_bf16)))
    return (int)cudaErrorInvalidValue;
  const Params P = make_params(im, ms, dense, eps, eps_row, thr, dim, C, K,
                               chain0);
  const Geometry G = {blocks, points, row_stride, smem, chains};
  const GenericPG pg = make_pg(ptrs, lens, ndata, ws);
  const cudaStream_t s = (cudaStream_t)stream;
  if (std_layout)
    return (int)sampling<true>(P, pg, seed, num_draws, ck, G, q, u, g,
                               static_cast<float*>(pos), stats, q_out, u_out,
                               g_out, s);
  if (pos_bf16)
    return (int)sampling<false>(P, pg, seed, num_draws, ck, G, q, u, g,
                                static_cast<__nv_bfloat16*>(pos), stats,
                                q_out, u_out, g_out, s);
  return (int)sampling<false>(P, pg, seed, num_draws, ck, G, q, u, g,
                              static_cast<float*>(pos), stats, q_out, u_out,
                              g_out, s);
}

// Blocks one SM holds of kernel 1 or 3 (sampling 0) or kernel 2 or 4
// (sampling 1) on the generated functor, at smem bytes a block.
int generic_blocks_per_sm(int std_layout, int sampling, int smem) {
  if (sampling)
    return std_layout
               ? blocks_per_sm(nuts_sampling_kernel<GenericPG, float, true>,
                               smem)
               : blocks_per_sm(
                     nuts_sampling_kernel<GenericPG, __nv_bfloat16, false>,
                     smem);
  return std_layout ? blocks_per_sm(nuts_transition_kernel<GenericPG, true>,
                                    smem)
                    : blocks_per_sm(nuts_transition_kernel<GenericPG, false>,
                                    smem);
}

}  // extern "C"
