// The potential and gradient of the Bayesian logistic regression posterior
// as a device functor, shared by the NUTS, GHMC, ChEES and fused-HMC kernels:
//   U(q)  = -sum_n [y_n x_n·q - softplus(x_n·q)] + (λ/2) |q|^2,
//   ∇U(q) = Xᵀ(σ(X q) - y) + λ q,
// λ the prior precision (1 for the model of
// aehmc_tpu/models/regression.py:logistic_regression_pg_t, an argument of
// the fused leapfrog kernel).  λ q is a product rounded before the sum, so
// λ = 1 gives the bits of `grad + q`.
//
// The whole block (NT = 256 threads) calls pg(scratch, dim, ds, q, grad,
// more) with its CB rows of q (row stride ds floats, in shared memory, zero
// past dim) and gets CB gradient rows and CB potentials (scratch.nu) back.
// CB, the chains a block, is a template parameter: 8 (the NUTS and HMC
// cores) or 16 (the fused leapfrog kernel where two such blocks fit on an
// SM with a 128-point tile; the launch plan picks it from the core, dim and
// X's type, ops/launch_plan.py).
//
// What bounds it: X·q and Xᵀ·r are 2·N·dim fused multiply-adds per chain in
// float32 on the CUDA cores, and the shared-memory loads that feed them
// their operands (L2 does not bind: PERF.md §6).  So each thread keeps a
// register tile of 4 × 8 products (4 points or dimensions × 8 chains, one
// "half" of the block's chains: one half at CB 8, two at CB 16), and every
// load feeds 8 to 32 of them:
//   X·q: thread (point group of 4, chain half, slice s of 8 / halves) sums
//     the float2 groups s, s + slices, ... of a row for 4 points × the 8
//     chains of its half (float2, not float4, so that the slices stay
//     balanced at dim 100); the slices of a point group are adjacent lanes
//     of a warp, and a butterfly over them (xor 4, 2, 1 at CB 8; xor 2, 1 at
//     CB 16) leaves each lane one point's logits for 4 (CB 8) or 8 (CB 16)
//     chains.  The block takes P points at a time (128 fill its 256
//     threads).
//   Xᵀ·r: thread (residue s of NS, chain half, dimension group of 4) sums
//     the points n ≡ s (mod NS) for 4 dimensions × the 8 chains of its half
//     in registers across the whole of X; the NS residues are adjacent
//     lanes, and a butterfly over them writes the gradient rows.  At CB 16
//     the halves' residual tiles sit HALF_OFF floats apart and a half's
//     chains are pairs interleaved with the other half's, so that neither
//     the residual loads nor X·q's loads of q conflict in the banks.
// X (400 KB at 1,000 × 100) comes from L2: one thread bulk-copies each
// chunk of P rows into a shared tile that both products read (the cores
// carve it after their state; the NUTS core keeps its U-turn checkpoints in
// global memory to leave room for it).  A block of 16 chains reads X once
// for twice the chains of a block of 8, and pays the tile's copies, the two
// barriers a chunk and the σ passes once for them.  The tile is never idle
// while a request can be made: a chunk is requested as soon as the previous
// one's Xᵀ·r reads are done, and when the caller says that another gradient
// follows (`more`), the next call's first chunk is requested right after
// this call's last, so it arrives while the caller updates its state; a
// kernel requests the first chunk at block entry (`request`), before it
// loads its state.  The scratch's count of requests against its count of
// uses carries "chunk 0 in flight" from one call to the next.  Two blocks
// per SM hide the barriers.  Measured slower and withdrawn (PERF.md §6): a
// larger staging ring, or one shared by a thread-block cluster (one block
// per SM); a tile in two stages, each with its barrier (a third barrier a
// chunk).
// With bfloat16 operands (XT = __nv_bfloat16) X is stored rounded, so a
// tile holds half the bytes and a load widens it to float32 exactly, and q
// is rounded once per gradient into CB shared rows that X·q reads; σ − y
// is rounded once per point.  Every product is then the float32 product of
// two bfloat16 values, exact, as with the operands rounded on every load.
// Every product is an explicit fmaf (the build passes -fmad=false) and every
// sum has a fixed order that depends on dim, P and CB only, so a result
// does not depend on where the functor is inlined, and at CB 8 it is what
// it was before CB became a parameter.
#pragma once

#include <cuda_bf16.h>

#include <type_traits>

#include "common.cuh"

namespace aehmc {

constexpr int PT = NT / 2;  // points a block takes at a time, at most
constexpr int RS = 12;      // row stride of a residual tile: 8 chains + 4
// with two chain halves, the second half's residual tile starts this many
// floats after the first's: 16 past a multiple of 32, so that the two
// halves' rows fall in other banks
constexpr int HALF_OFF = PT * RS + 16;

// floats of the residual tile at CB chains a block; it also takes the
// likelihood sums (CB × PT) at the end
template <int CB>
__host__ __device__ constexpr int rt_floats() {
  return CB == 8 ? PT * RS : HALF_OFF + PT * RS;
}
// floats of the functor's shared scratch before the X tile: the residual
// tile, the potentials, the tile's mbarrier, its count of uses and its
// count of requests
template <int CB>
__host__ __device__ constexpr int scratch_floats() {
  return rt_floats<CB>() + CB + 4;
}

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

// The functor's shared memory, carved by the kernel: scratch_floats<CB>(),
// then with bfloat16 operands q's rounded rows (CB × ds floats), then the X
// tile of P·xs elements.
struct PGScratch {
  float* rt;        // σ(X q) − y of the chunk: (PT, RS) per chain half
  float* nu;        // (CB,): the potentials
  uint64_t* bar;    // the X tile's mbarrier
  uint32_t* uses;   // chunks the tile has held so far (the barrier's phase)
  uint32_t* asked;  // chunks requested so far: uses + 1 while one is in flight
  float* qb;        // (CB, ds): q rounded to bfloat16, or null
  void* tile;       // (P, xs) elements of X

  // carve at `base` (16-byte aligned) for CB chains with `qb_floats`
  // floats of rounded q (a multiple of 4); thread 0 initialises the
  // barrier and a __syncthreads must follow
  template <int CB>
  __device__ void carve(float* base, int qb_floats) {
    rt = base;
    nu = rt + rt_floats<CB>();
    bar = reinterpret_cast<uint64_t*>(nu + CB);
    uses = reinterpret_cast<uint32_t*>(bar + 1);
    asked = uses + 1;
    qb = qb_floats ? base + scratch_floats<CB>() : nullptr;
    tile = base + scratch_floats<CB>() + qb_floats;
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      *uses = 0;
      *asked = 0;
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

  // thread 0, before its block exits: wait for a chunk requested and never
  // used, so that no copy into the tile outlives the block
  __device__ void drain() const {
    if (*asked != *uses) wait(*uses);
  }
};

// XT = __nv_bfloat16 gives the data products bfloat16 operands, as
// aehmc_tpu/ops/nuts_fused.py:_logistic_pot_grad_builder (:878) with
// matmul_dtype=bfloat16 and aehmc_tpu/models/regression.py:
// logistic_regression_pg_t (:112, bfloat16 by default): X stored rounded, q
// rounded for the logits, σ − y for the gradient.  A product of two
// bfloat16 values is exact in float32, the sums stay float32, and so do the
// prior terms (on the unrounded q).  NC is the block's chains, CB: 8 or 16.
template <typename XT, int NC = 8>
struct LogisticPGT {
  static_assert(NC == 8 || NC == 16, "8 or 16 chains a block");
  static constexpr bool BF16 = std::is_same<XT, __nv_bfloat16>::value;
  using Elem = XT;
  static constexpr int CB = NC;       // chains a block
  static constexpr int NH = CB / 8;   // chain halves: 8 chains a register tile
  static constexpr int NSL = 8 / NH;  // X·q's slices of a row
  static constexpr int NO = 32 / NSL; // X·q's outputs a lane: 1 point × NO
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
  // the block's chain (its row of q and ∇U) at place cc of half h's 8: with
  // two halves, pairs of chains alternate between them (half h takes
  // 4k + 2h and 4k + 2h + 1), so that a warp's loads of the two halves'
  // rows of q fall in other banks
  static __device__ __forceinline__ int chain_of(int h, int cc) {
    if constexpr (NH == 1) {
      return cc;
    } else {
      return (cc >> 1) * 4 + 2 * h + (cc & 1);
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
  // thread 0: copy the chunk of `rows` points from n0 into the tile
  __device__ void load_chunk(const PGScratch& S, int n0, int rows) const {
    S.load(X + (size_t)n0 * xs,
           (uint32_t)rows * (uint32_t)xs * (uint32_t)sizeof(XT));
  }
  // thread 0, at block entry after the carve: request the first chunk of X,
  // so that it arrives while the block loads its state
  __device__ void request(const PGScratch& S) const {
    if (threadIdx.x == 0 && *S.asked == *S.uses) {
      load_chunk(S, 0, min(P, N));
      *S.asked = *S.uses + 1;
    }
  }
  // before the block exits (every thread calls it; thread 0 waits): a chunk
  // requested and never used must not outlive the block
  __device__ void drain(const PGScratch& S) const {
    if (threadIdx.x == 0) S.drain();
  }
  // `more`: the block calls the functor again before it exits, so the next
  // call's first chunk is requested as soon as this call's tile is read
  __device__ void operator()(const PGScratch& S, int dim, int ds,
                             const float* q, float* grad,
                             bool more = false) const;

  // What the NUTS and HMC cores (nuts_core.cuh, hmc_core.cuh) ask of a
  // functor: its scratch type, carved at `base` after the core's rows
  // (every thread calls it, a __syncthreads follows), and whether a
  // launch's sizes and geometry fit it (X and its tile; the launch plan's
  // points and row stride).
  using Scratch = PGScratch;
  static __device__ PGScratch carve_scratch(float* base, int ds) {
    PGScratch s;
    s.carve<CB>(base, qb_floats(ds));
    return s;
  }
  bool fits(int dim, const Geometry& G) const {
    return X && y && N >= 1 && x_tile_ok(G) && G.points == P &&
           G.row_stride == xs && xs >= dim;
  }
};

using LogisticPG = LogisticPGT<float>;
using LogisticPGB = LogisticPGT<__nv_bfloat16>;

// One level of a butterfly over lanes: v[0, W) holds this lane's partial
// sums; keep the upper half if `up`, the lower otherwise, each summed with
// the partner's (lane ^ bit) same half, into v[0, W/2).
template <int W>
__device__ __forceinline__ void halve(float (&v)[32], bool up, int bit) {
#pragma unroll
  for (int k = 0; k < W / 2; ++k) {
    const float mine = up ? v[W / 2 + k] : v[k];
    const float give = up ? v[k] : v[W / 2 + k];
    v[k] = mine + __shfl_xor_sync(FULL, give, bit);
  }
}

// Xᵀ·r's butterfly over NS residue lanes, then the thread's share of the
// gradient rows: v[k] is dimension 4·dg + k / 8, place k % 8 of half h.
template <class PG, int NS>
__device__ __forceinline__ void grad_rows(float (&v)[32], int sb, int dg,
                                          int h, bool on, int dim, int ds,
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
    const int i = (off + k) / 8, c = PG::chain_of(h, (off + k) % 8),
              d = 4 * dg + i;
    if (on && d < dim) grad[c * ds + d] = v[k];
  }
}

template <typename XT, int NC>
__device__ void LogisticPGT<XT, NC>::operator()(const PGScratch& S, int dim,
                                                int ds, const float* q,
                                                float* grad,
                                                bool more) const {
  const int t = threadIdx.x, w = t / 32, lane = t % 32;
  float* const rt = S.rt;
  const int ng4 = (dim + 3) / 4;  // float4 groups of a row
  const int ng2 = (dim + 1) / 2;  // float2 groups
  // X·q roles: point group pg (points 4·pg .. 4·pg + 3 of a chunk), chain
  // half ha, slice s; after the butterfly the lane holds point pa's logits
  // for places ca .. ca + NO − 1 of its half
  const int s = lane % NSL, ha = (lane / NSL) % NH, pg = t / 8;
  const bool a_warp = 16 * w < P;  // the warp has points (warp-uniform)
  const int pa = NH == 1 ? 4 * pg + 2 * ((s >> 2) & 1) + ((s >> 1) & 1)
                         : 4 * pg + s;
  const int ca = NH == 1 ? 4 * (s & 1) : 0;
  // Xᵀ·r roles: residue sb of NS (a power of 2, at most 8) in adjacent
  // lanes, then chain half hb, then dimension group dg; past 4·NT / NH
  // dimensions more than one pass
  const int ns = ng4 * NH * 8 <= NT   ? 8
                 : ng4 * NH * 4 <= NT ? 4
                 : ng4 * NH * 2 <= NT ? 2
                                      : 1;
  const int passes = (ng4 * NH * ns + NT - 1) / NT;
  const int chunks = (N + P - 1) / P;

  // X·q's q: with bfloat16 operands the rows rounded once (zero past dim
  // as q's are)
  const float* qx = q;
  if constexpr (BF16) {
    for (int e = t; e < CB * ds; e += NT) S.qb[e] = bf16_round(q[e]);
    __syncthreads();
    qx = S.qb;
  }

  float lik[NO];
#pragma unroll
  for (int j = 0; j < NO; ++j) lik[j] = 0.f;
  uint32_t uses = *S.uses;
  // (thread 0) the first chunk is already requested, at block entry or by
  // the previous call
  const bool ahead = *S.asked != uses;
  for (int pass = 0; pass < passes; ++pass) {
    const int u = pass * NT + t;
    const int sb = u % ns, hb = (u / ns) % NH, dg = u / (ns * NH);
    const bool b_on = dg < ng4;
    float acc[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) acc[k] = 0.f;

    for (int chunk = 0; chunk < chunks; ++chunk) {
      const int n0 = chunk * P, rows = min(P, N - n0);
      // the previous chunk's reads are done: copy this one into the tile,
      // unless it is the first and already requested
      if (t == 0 && (chunk > 0 || pass > 0 || !ahead))
        load_chunk(S, n0, rows);
      S.wait(uses++);
      if (a_warp) {  // logits of 4 points x 8 chains over this lane's slice
        float a[32];
#pragma unroll
        for (int k = 0; k < 32; ++k) a[k] = 0.f;
        const XT* xr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)  // points past the data repeat the last
          xr[i] = row(S, min(4 * pg + i, rows - 1));
        for (int g = s; g < ng2; g += NSL) {
          const int d = 2 * g;
          float2 xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) xv[i] = ld_x2(xr[i] + d);
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const float2 qr = *reinterpret_cast<const float2*>(
                qx + chain_of(ha, c) * ds + d);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              float& e = a[i * 8 + c];
              e = fmaf(xv[i].x, qr.x, e);
              e = fmaf(xv[i].y, qr.y, e);
            }
          }
        }
        // the slices' sums: a[0, NO) is then point pa's logits for places
        // ca .. ca + NO − 1 of half ha; σ − y and the likelihood
        if constexpr (NH == 1) {  // xor 4, 2, 1
          halve<32>(a, s & 4, 4);
          halve<16>(a, s & 2, 2);
          halve<8>(a, s & 1, 1);
        } else {  // xor 2, 1
          halve<32>(a, s & 2, 2);
          halve<16>(a, s & 1, 1);
        }
        float r[NO];
#pragma unroll
        for (int j = 0; j < NO; ++j) r[j] = 0.f;
        if (4 * pg < P && pa < rows) {
          const float yv = __ldg(y + n0 + pa);
#pragma unroll
          for (int j = 0; j < NO; ++j) {
            const float sp = fmaxf(a[j], 0.f) + log1pf(expf(-fabsf(a[j])));
            if (pass == 0) lik[j] += yv * a[j] - sp;
            r[j] = op(1.f / (1.f + expf(-a[j])) - yv);
          }
        }
        if (4 * pg < P) {
          float* const rr = rt + ha * HALF_OFF + pa * RS + ca;
#pragma unroll
          for (int j = 0; j < NO; j += 4)
            *reinterpret_cast<float4*>(rr + j) =
                make_float4(r[j], r[j + 1], r[j + 2], r[j + 3]);
        }
      }
      __syncthreads();

      if (b_on) {  // Xᵀ r over this thread's residue class of the chunk
        const float* const rh = rt + hb * HALF_OFF;
        for (int m = sb; m < rows; m += ns) {
          const float4 xv = ld_x4(row(S, m) + 4 * dg);
          const float4 r0 = ld4(rh + m * RS), r1 = ld4(rh + m * RS + 4);
          const float rr[8] = {r0.x, r0.y, r0.z, r0.w,
                               r1.x, r1.y, r1.z, r1.w};
          const float xx[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < 8; ++c)
              acc[i * 8 + c] = fmaf(xx[i], rr[c], acc[i * 8 + c]);
        }
      }
      __syncthreads();
    }
    // the tile is read: request the next call's first chunk now
    if (more && t == 0 && pass + 1 == passes) load_chunk(S, 0, min(P, N));
    switch (ns) {  // the residues' sums into the gradient rows
      case 8:
        grad_rows<LogisticPGT, 8>(acc, sb, dg, hb, b_on, dim, ds, grad);
        break;
      case 4:
        grad_rows<LogisticPGT, 4>(acc, sb, dg, hb, b_on, dim, ds, grad);
        break;
      case 2:
        grad_rows<LogisticPGT, 2>(acc, sb, dg, hb, b_on, dim, ds, grad);
        break;
      default:
        grad_rows<LogisticPGT, 1>(acc, sb, dg, hb, b_on, dim, ds, grad);
        break;
    }
  }
  // the potential: each lane's likelihood sums into (CB, PT), then a warp
  // per chain
#pragma unroll
  for (int j = 0; j < NO; ++j)
    rt[chain_of(ha, ca + j) * PT + pa] = pa < P ? lik[j] : 0.f;
  if (t == 0) {
    *S.uses = uses;
    *S.asked = uses + (more ? 1u : 0u);
  }
  __syncthreads();
  for (int e = t; e < CB * dim; e += NT) {
    const int c = e / dim, d = e - c * dim;
    grad[c * ds + d] = grad[c * ds + d] + prior_precision * q[c * ds + d];
  }
  for (int c = w; c < CB; c += NW) {  // the warp's chains
    float sum = 0.f;
    for (int k = lane; k < PT; k += 32) sum += rt[c * PT + k];
    sum = warp_sum(sum);
    float qq = 0.f;
    for (int d = lane; d < dim; d += 32) qq += q[c * ds + d] * q[c * ds + d];
    qq = warp_sum(qq);
    if (lane == 0) S.nu[c] = -sum + 0.5f * (prior_precision * qq);
  }
  __syncthreads();
}

// f(tag), tag a default functor for X in bfloat16 (x_bf16; only with
// WITH_BF16) or float32, at `chains` a block, one of CBS; `invalid` for
// another choice.
template <bool WITH_BF16, int... CBS, class R, class F>
R per_type(int x_bf16, int chains, R invalid, F&& f) {
  auto at_chains = [&](auto elem) {
    using T = decltype(elem);
    R r = invalid;
    ((chains == CBS ? (r = f(LogisticPGT<T, CBS>{}), true) : false) || ...);
    return r;
  };
  if (!x_bf16) return at_chains(float{});
  if constexpr (WITH_BF16) return at_chains(__nv_bfloat16{});
  return invalid;
}

// f(pg), pg the functor over X in float32 or bfloat16 (x_bf16; only with
// WITH_BF16) at the launch plan's chains a block (G.chains, one of CBS), its
// tile G.points rows of G.row_stride elements; an invalid value for another
// plan.
template <bool WITH_BF16, int... CBS, class F>
cudaError_t with_functor(const void* X, int x_bf16, const float* y, int N,
                         float prior_precision, const Geometry& G, F&& f) {
  const int xs = G.row_stride, P = G.points;
  const float p = prior_precision;
  return per_type<WITH_BF16, CBS...>(
      x_bf16, G.chains, cudaError_t(cudaErrorInvalidValue), [&](auto tag) {
        using PG = decltype(tag);
        using T = typename PG::Elem;
        return f(PG{static_cast<const T*>(X), y, N, xs, P, p});
      });
}

}  // namespace aehmc
