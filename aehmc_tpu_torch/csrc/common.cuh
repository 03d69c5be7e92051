// Pieces shared by the port's CUDA kernels: the block layout (8 warps a
// block, one or two chains a warp, two blocks per SM, so that one block's
// barriers overlap the other's arithmetic), the launch plan's geometry,
// Philox4x32-10, the uniform and normal draws built on it, and small numeric
// helpers.  The plain PyTorch versions of the random streams are in
// aehmc_tpu_torch/ops/philox.py.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace aehmc {

constexpr int NW = 8;          // warps a block
constexpr int NT = NW * 32;    // threads a block
constexpr float NEG_INF = -1e30f;
constexpr float TWO_PI = 6.283185307179586f;
constexpr uint32_t DRAW_SEED_STRIDE = 104729u;
constexpr unsigned FULL = 0xffffffffu;

// Whether functor PG asks the NUTS kernels for its block-entry and exit
// hooks (PG::NUTS_HOOKS: request(S) after the carve, drain(S) before the
// block exits); the HMC kernels call them for every functor
template <class PG, class = void>
struct nuts_hooks : std::false_type {};
template <class PG>
struct nuts_hooks<PG, std::void_t<decltype(PG::NUTS_HOOKS)>>
    : std::bool_constant<PG::NUTS_HOOKS> {};

// Philox stream numbers: the third counter word (ops/philox.py)
constexpr uint32_t MOMENTUM = 0u, DIRECTION = 1u, BIAS = 2u, LEAF = 3u,
                   ACCEPT = 4u;

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

// the four Box-Muller normals of group j of a chain's MOMENTUM stream
__device__ __forceinline__ void normal_group(uint32_t chain, uint32_t j,
                                             uint32_t seed, float v[4]) {
  const uint4 b = philox(chain, j, MOMENTUM, seed);
  const float r0 = sqrtf(-2.0f * logf(u01(b.x))), a0 = TWO_PI * u01(b.y);
  const float r1 = sqrtf(-2.0f * logf(u01(b.z))), a1 = TWO_PI * u01(b.w);
  v[0] = r0 * cosf(a0);
  v[1] = r0 * sinf(a0);
  v[2] = r1 * cosf(a1);
  v[3] = r1 * sinf(a1);
}

// standard normals of one chain into z[0, dim), the warp's lanes taking
// groups of four
__device__ __forceinline__ void normal_row(uint32_t chain, uint32_t seed,
                                           int dim, int lane, float* z) {
  for (int j = lane; j < (dim + 3) / 4; j += 32) {
    float v[4];
    normal_group(chain, (uint32_t)j, seed, v);
    for (int k = 0; k < 4; ++k)
      if (4 * j + k < dim) z[4 * j + k] = v[k];
  }
}

// clip to +-1e30 that keeps NaN (jnp.clip / torch.clamp semantics)
__device__ __forceinline__ float clip(float x) {
  return x != x ? x : fminf(fmaxf(x, NEG_INF), -NEG_INF);
}

// sum over the warp in a fixed order, the result broadcast from lane 0
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
  return __shfl_sync(FULL, v, 0);
}

// The launch plan's geometry, as the launchers receive it from
// aehmc_tpu_torch/ops/launch_plan.py: blocks, points a chunk of X, X's row
// stride in elements, the bytes of dynamic shared memory a block, and the
// chains a block (8 or 16; the launcher picks the kernel built for them).
// A potential with no data matrix has no tile: points and row_stride 0.
struct Geometry {
  int blocks, points, row_stride, smem, chains;
};

// Whether G's tile of X is one the logistic functor takes: points a power
// of 2 from 8 to NT / 2, rows a positive multiple of 4 elements.
inline bool x_tile_ok(const Geometry& G) {
  return G.points >= 8 && G.points <= NT / 2 &&
         !(G.points & (G.points - 1)) && G.row_stride >= 4 &&
         G.row_stride % 4 == 0;
}

// Launch `kernel` on G.blocks blocks of NT threads (the caller has checked
// the functor's part of G).
template <typename... KArgs, typename... Args>
cudaError_t launch_blocks(void (*kernel)(KArgs...), const Geometry& G,
                          cudaStream_t stream, Args&&... args) {
  if (G.blocks < 1 || G.smem < 1 || (G.chains != 8 && G.chains != 16))
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G.smem);
  if (err != cudaSuccess) return err;
  kernel<<<G.blocks, NT, G.smem, stream>>>(args...);
  return cudaGetLastError();
}

// Blocks of `kernel` one SM holds with `smem` bytes of dynamic shared
// memory each (the occupancy API, after the launch's shared-memory
// attribute), or -1 on an error.
template <typename... KArgs>
int blocks_per_sm(void (*kernel)(KArgs...), int smem) {
  int n = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, NT, smem) !=
          cudaSuccess)
    return -1;
  return n;
}

}  // namespace aehmc

// CUDA error text for the Python wrappers (each library exports its own;
// weak, so that a library linked from two sources, as one built on a
// generated functor, holds one)
extern "C" __attribute__((weak)) const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
