// The potential and gradient of the Bayesian logistic regression posterior
// as a device functor, shared by the NUTS, GHMC, ChEES and fused-HMC kernels:
//   U(q)  = -sum_n [y_n x_n·q - softplus(x_n·q)] + (λ/2) |q|^2,
//   ∇U(q) = Xᵀ(σ(X q) - y) + λ q,
// λ the prior precision (1 for the model of
// aehmc_tpu/models/regression.py:logistic_regression_pg_t, an argument of
// the fused leapfrog kernel).  λ q is a product rounded before the sum, so
// λ = 1 gives the bits of `grad + q`.
//
// The whole block calls pg(scratch, dim, ds, q, grad) with its CB rows of q
// (row stride ds floats, in shared memory, zero past dim) and gets CB
// gradient rows and CB potentials (scratch.nu) back.
//
// What bounds it: X·q and Xᵀ·r are 2·N·dim fused multiply-adds per chain in
// float32 on the CUDA cores, and the shared-memory loads that feed them
// their operands (L2 does not bind: PERF.md §6).  So each thread keeps a
// register tile of 4 × 8 products, and every load feeds 8 to 32 of them:
//   X·q: thread (point group of 4, slice s of 8) sums the float2 groups
//     s, s+8, ... of a row for 4 points × 8 chains (float2, not float4, so
//     that the 8 slices stay balanced at dim 100); the 8 slices of a point
//     group are 8 lanes of a warp, and a butterfly over them (xor 4, 2, 1)
//     leaves each lane one point's logits for 4 chains.  The block takes P
//     points at a time (128 fill its 256 threads).
//   Xᵀ·r: thread (dimension group of 4, residue s of NS) sums the points
//     n ≡ s (mod NS) for 4 dimensions × 8 chains in registers across the
//     whole of X; the NS residues are adjacent lanes, and a butterfly over
//     them writes the gradient rows.
// X (400 KB at 1,000 × 100) comes from L2: one thread bulk-copies each
// chunk of P rows into a shared tile that both products read (the cores
// carve it after their state; the NUTS core keeps its U-turn checkpoints in
// global memory to leave room for it).  The functor has two barriers per
// chunk, and two blocks per SM hide them; a larger staging ring, or one
// shared by a thread-block cluster, would leave one block per SM and was
// measured slower (PERF.md §6).
// With bfloat16 operands (XT = __nv_bfloat16) X is stored rounded, so a
// tile holds half the bytes and a load widens it to float32 exactly, and q
// is rounded once per gradient into a shared row that X·q reads; σ − y is
// rounded once per point.  Every product is then the float32 product of two
// bfloat16 values, exact, as with the operands rounded on every load.
// Every product is an explicit fmaf (the build passes -fmad=false) and every
// sum has a fixed order that depends on dim and P only, so a result does
// not depend on where the functor is inlined.
#pragma once

#include <cuda_bf16.h>

#include <type_traits>

#include "common.cuh"

namespace aehmc {

constexpr int PT = NT / 2;  // points a block takes at a time, at most
constexpr int RS = 12;      // row stride of the residual tile: 8 chains + 4
// the residual tile (PT rows), which also takes the likelihood sums
// (CB × PT) at the end
constexpr int RT_FLOATS = PT * RS;
// floats of the functor's shared scratch before the X tile: the residual
// tile, the potentials, the tile's mbarrier and its count of uses
constexpr int SCRATCH_FLOATS = RT_FLOATS + CB + 4;

// x rounded to the nearest bfloat16, back in float32
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// zero `n` floats of shared memory from `p` (a kernel's rows: their padding
// past dim is then 0 for the functor's vector loads of q)
__device__ __forceinline__ void zero_smem(float* p, size_t n) {
  for (size_t e = threadIdx.x; e < n; e += NT) p[e] = 0.f;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The functor's shared memory, carved by the kernel: SCRATCH_FLOATS, then
// with bfloat16 operands q's rounded rows (CB × ds floats), then the X tile
// of P·xs elements.
struct PGScratch {
  float* rt;       // (PT, RS): σ(X q) − y of the chunk
  float* nu;       // (CB,): the potentials
  uint64_t* bar;   // the X tile's mbarrier
  uint32_t* uses;  // chunks the tile has held so far (the barrier's phase)
  float* qb;       // (CB, ds): q rounded to bfloat16, or null
  void* tile;      // (P, xs) elements of X

  // carve at `base` (16-byte aligned) with `qb_floats` floats of rounded q
  // (a multiple of 4); thread 0 initialises the barrier and a
  // __syncthreads must follow
  __device__ void carve(float* base, int qb_floats) {
    rt = base;
    nu = rt + RT_FLOATS;
    bar = reinterpret_cast<uint64_t*>(nu + CB);
    uses = reinterpret_cast<uint32_t*>(bar + 1);
    qb = qb_floats ? base + SCRATCH_FLOATS : nullptr;
    tile = base + SCRATCH_FLOATS + qb_floats;
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      *uses = 0;
    }
  }

  // thread 0: copy `bytes` from X into the tile, completing on the barrier
  __device__ void load(const void* src, uint32_t bytes) const {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                     smem_u32(bar)),
                 "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(smem_u32(tile)),
        "l"(src), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
  }

  // every thread: wait until the tile holds its use number `use`
  __device__ void wait(uint32_t use) const {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "WAIT_X:\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
        "@!p bra WAIT_X;\n\t}" ::"r"(smem_u32(bar)),
        "r"(use & 1u)
        : "memory");
  }
};

// XT = __nv_bfloat16 gives the data products bfloat16 operands, as
// aehmc_tpu/ops/nuts_fused.py:_logistic_pot_grad_builder (:878) with
// matmul_dtype=bfloat16 and aehmc_tpu/models/regression.py:
// logistic_regression_pg_t (:112, bfloat16 by default): X stored rounded, q
// rounded for the logits, σ − y for the gradient.  A product of two
// bfloat16 values is exact in float32, the sums stay float32, and so do the
// prior terms (on the unrounded q).
template <typename XT>
struct LogisticPGT {
  static constexpr bool BF16 = std::is_same<XT, __nv_bfloat16>::value;
  const XT* X;     // (N, xs): rows padded with zeros to xs elements
  const float* y;  // (N,)
  int N;
  int xs;  // row stride of X in elements: 16 bytes' worth, a multiple of 4
           // (float) or 8 (bfloat16)
  int P;   // points a chunk, the tile's rows: a power of 2, 8 to PT
  float prior_precision;

  // floats of the rounded rows of q the functor needs in its scratch
  static __host__ __device__ int qb_floats(int ds) {
    return BF16 ? CB * ds : 0;
  }
  static __device__ __forceinline__ float op(float x) {
    if constexpr (BF16) {
      return bf16_round(x);
    } else {
      return x;
    }
  }
  // row m of the chunk in the shared tile
  __device__ const XT* row(const PGScratch& S, int m) const {
    return static_cast<const XT*>(S.tile) + (size_t)m * xs;
  }
  // 4 (ld_x4, 8-byte aligned) or 2 (ld_x2) elements of X widened to
  // float32; a bfloat16 value is the upper half of its float32
  static __device__ __forceinline__ float4 ld_x4(const XT* p) {
    if constexpr (BF16) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      return make_float4(__uint_as_float(v.x << 16),
                         __uint_as_float(v.x & 0xffff0000u),
                         __uint_as_float(v.y << 16),
                         __uint_as_float(v.y & 0xffff0000u));
    } else {
      return ld4(p);
    }
  }
  static __device__ __forceinline__ float2 ld_x2(const XT* p) {
    if constexpr (BF16) {
      const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
      return make_float2(__uint_as_float(v << 16),
                         __uint_as_float(v & 0xffff0000u));
    } else {
      return *reinterpret_cast<const float2*>(p);
    }
  }
  __device__ void operator()(const PGScratch& S, int dim, int ds,
                             const float* q, float* grad) const;
};

using LogisticPG = LogisticPGT<float>;
using LogisticPGB = LogisticPGT<__nv_bfloat16>;

// One level of a butterfly over lanes: v[0, W) holds this lane's partial
// sums; keep the upper half if `up`, the lower otherwise, each summed with
// the partner's (lane ^ bit) same half, into v[0, W/2).
template <int W>
__device__ __forceinline__ void halve(float (&v)[4 * CB], bool up, int bit) {
#pragma unroll
  for (int k = 0; k < W / 2; ++k) {
    const float mine = up ? v[W / 2 + k] : v[k];
    const float give = up ? v[k] : v[W / 2 + k];
    v[k] = mine + __shfl_xor_sync(FULL, give, bit);
  }
}

// Xᵀ·r's butterfly over NS residue lanes, then the thread's share of the
// gradient rows: v[k] is dimension 4·dg + k / CB, chain k % CB.
template <int NS>
__device__ __forceinline__ void grad_rows(float (&v)[4 * CB], int sb, int dg,
                                          bool on, int dim, int ds,
                                          float* grad) {
  int off = 0;
  if constexpr (NS >= 8) {
    halve<32>(v, sb & 4, 4);
    off += (sb & 4) ? 16 : 0;
  }
  if constexpr (NS >= 4) {
    halve<32 * 4 / NS>(v, sb & 2, 2);
    off += (sb & 2) ? 32 * 2 / NS : 0;
  }
  if constexpr (NS >= 2) {
    halve<32 * 2 / NS>(v, sb & 1, 1);
    off += (sb & 1) ? 32 / NS : 0;
  }
#pragma unroll
  for (int k = 0; k < 32 / NS; ++k) {
    const int i = (off + k) / CB, c = (off + k) % CB, d = 4 * dg + i;
    if (on && d < dim) grad[c * ds + d] = v[k];
  }
}

template <typename XT>
__device__ void LogisticPGT<XT>::operator()(const PGScratch& S, int dim,
                                            int ds, const float* q,
                                            float* grad) const {
  const int t = threadIdx.x, w = t / 32, lane = t % 32;
  float* const rt = S.rt;
  const int ng4 = (dim + 3) / 4;  // float4 groups of a row
  const int ng2 = (dim + 1) / 2;  // float2 groups
  // X·q roles: point group pg (points 4·pg .. 4·pg + 3 of a chunk), slice s
  const int s = lane & 7, pg = t / 8;
  const bool a_warp = 16 * w < P;  // the warp has points (warp-uniform)
  const int pa = 4 * pg + 2 * ((s >> 2) & 1) + ((s >> 1) & 1);
  const int ca = 4 * (s & 1);
  // Xᵀ·r roles: residue sb of NS (a power of 2, at most 8) in adjacent
  // lanes, dimension group dg; past 4·NT dimensions more than one pass
  const int ns = ng4 * 8 <= NT   ? 8
                 : ng4 * 4 <= NT ? 4
                 : ng4 * 2 <= NT ? 2
                                 : 1;
  const int passes = (ng4 * ns + NT - 1) / NT;

  // X·q's q: with bfloat16 operands the rows rounded once (zero past dim
  // as q's are)
  const float* qx = q;
  if constexpr (BF16) {
    for (int e = t; e < CB * ds; e += NT) S.qb[e] = bf16_round(q[e]);
    __syncthreads();
    qx = S.qb;
  }

  float lik[4] = {0.f, 0.f, 0.f, 0.f};
  uint32_t uses = *S.uses;
  for (int pass = 0; pass < passes; ++pass) {
    const int sb = t % ns, dg = (pass * NT + t) / ns;
    const bool b_on = dg < ng4;
    float acc[4 * CB];
#pragma unroll
    for (int k = 0; k < 4 * CB; ++k) acc[k] = 0.f;

    for (int n0 = 0; n0 < N; n0 += P) {
      const int rows = min(P, N - n0);
      // the previous chunk's reads are done: copy this one into the tile
      if (t == 0)
        S.load(X + (size_t)n0 * xs,
               (uint32_t)rows * (uint32_t)xs * (uint32_t)sizeof(XT));
      S.wait(uses++);
      if (a_warp) {  // logits of 4 points x 8 chains over this lane's slice
        float a[4 * CB];
#pragma unroll
        for (int k = 0; k < 4 * CB; ++k) a[k] = 0.f;
        const XT* xr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)  // points past the data repeat the last
          xr[i] = row(S, min(4 * pg + i, rows - 1));
        for (int g = s; g < ng2; g += 8) {
          const int d = 2 * g;
          float2 xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) xv[i] = ld_x2(xr[i] + d);
#pragma unroll
          for (int c = 0; c < CB; ++c) {
            const float2 qr = *reinterpret_cast<const float2*>(qx + c * ds + d);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              float& e = a[i * CB + c];
              e = fmaf(xv[i].x, qr.x, e);
              e = fmaf(xv[i].y, qr.y, e);
            }
          }
        }
        // the 8 slices' sums (xor 4, 2, 1): a[0, 4) is then point pa's
        // logits for chains ca .. ca + 3; σ − y and the likelihood
        halve<32>(a, s & 4, 4);
        halve<16>(a, s & 2, 2);
        halve<8>(a, s & 1, 1);
        float4 rv = make_float4(0.f, 0.f, 0.f, 0.f);
        if (4 * pg < P && pa < rows) {
          const float yv = __ldg(y + n0 + pa);
          float r[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float sp = fmaxf(a[j], 0.f) + log1pf(expf(-fabsf(a[j])));
            if (pass == 0) lik[j] += yv * a[j] - sp;
            r[j] = op(1.f / (1.f + expf(-a[j])) - yv);
          }
          rv = make_float4(r[0], r[1], r[2], r[3]);
        }
        if (4 * pg < P) *reinterpret_cast<float4*>(rt + pa * RS + ca) = rv;
      }
      __syncthreads();

      if (b_on) {  // Xᵀ r over this thread's residue class of the chunk
        for (int m = sb; m < rows; m += ns) {
          const float4 xv = ld_x4(row(S, m) + 4 * dg);
          const float4 r0 = ld4(rt + m * RS), r1 = ld4(rt + m * RS + 4);
          const float rr[CB] = {r0.x, r0.y, r0.z, r0.w,
                                r1.x, r1.y, r1.z, r1.w};
          const float xx[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < CB; ++c)
              acc[i * CB + c] = fmaf(xx[i], rr[c], acc[i * CB + c]);
        }
      }
      __syncthreads();
    }
    switch (ns) {  // the residues' sums into the gradient rows
      case 8: grad_rows<8>(acc, sb, dg, b_on, dim, ds, grad); break;
      case 4: grad_rows<4>(acc, sb, dg, b_on, dim, ds, grad); break;
      case 2: grad_rows<2>(acc, sb, dg, b_on, dim, ds, grad); break;
      default: grad_rows<1>(acc, sb, dg, b_on, dim, ds, grad); break;
    }
  }
  // the potential: each lane's likelihood sums into (CB, PT), then a warp
  // per chain
#pragma unroll
  for (int j = 0; j < 4; ++j) rt[(ca + j) * PT + pa] = pa < P ? lik[j] : 0.f;
  if (t == 0) *S.uses = uses;
  __syncthreads();
  for (int e = t; e < CB * dim; e += NT) {
    const int c = e / dim, d = e - c * dim;
    grad[c * ds + d] = grad[c * ds + d] + prior_precision * q[c * ds + d];
  }
  float sum = 0.f;
  for (int k = lane; k < PT; k += 32) sum += rt[w * PT + k];
  sum = warp_sum(sum);
  float qq = 0.f;
  for (int d = lane; d < dim; d += 32) qq += q[w * ds + d] * q[w * ds + d];
  qq = warp_sum(qq);
  if (lane == 0) S.nu[w] = -sum + 0.5f * (prior_precision * qq);
  __syncthreads();
}

}  // namespace aehmc
