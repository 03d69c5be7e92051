// What a generated potential functor (struct GenericPG, written by
// aehmc_tpu_torch/ops/generic_pg.py:emit_cuda) stands on: its data table,
// its scratch and per-chain workspace, and the scalar helpers its emitted
// expressions call.  The NUTS kernels 1-4 (nuts_generic.cu) and the HMC
// kernels 5-7 (hmc_generic.cu) take GenericPG as their functor, beside the
// hand-written LogisticPGT, FunnelPG and EightSchoolsPG.
//
// The contract is the NUTS core's (nuts_core.cuh), which the HMC core
// (hmc_core.cuh) shares: CB = 8 chains a block, one warp a chain; Scratch
// holds the block's potentials nu; carve_scratch(base, ds) carves it after
// the core's rows; fits(dim, G) checks a launch; operator()(S, dim, ds, q,
// grad, bool) leaves each chain's gradient row and potential, and a
// __syncwarp orders them before the warp reads them; request and drain,
// the HMC core's hooks at block entry and exit, do nothing (no X tile).
//
// The workspace holds the values a chain's potential materialises (the
// contractions' outputs and the elementwise values a product reads more
// than once), W floats a chain: in shared memory after the potentials when
// two blocks still fit an SM with it, else in a global buffer of blocks ×
// CB × W floats the wrapper allocates (launch_plan.generic_workspace_floats),
// indexed by block and warp, so a chain keeps its slot across the draws of
// kernels 2 and 4.
//
// The helpers keep torch's semantics on NaN: a clamp, a maximum or a
// minimum of NaN is NaN (fmaxf would drop it), a sort puts NaN last
// (first, descending).  digamma transcribes the
// formula torch's digamma runs on the card, log_ndtr ATen's float formula
// (calc_log_ndtr in ATen/native/Math.h); lgamma, erf, erfc and erfcx are
// CUDA's (lgammaf, erff, erfcf, erfcxf), as torch's lgamma, erf and erfc
// are on the card (its lgamma equals the functor's bit for bit there).
#pragma once

#include "hierarchical_pg.cuh"

namespace aehmc {
namespace generic {

constexpr int MAX_DATA = 16;  // data operands (ops/generic_pg.py MAX_DATA)

// the data operands: device pointers (contiguous float32, or int32 rows of
// index or count data, which travel in the same slot and which the
// functor reads through Base::int_row) and their lengths in elements
struct Data {
  const float* ptr[MAX_DATA];
  long long len[MAX_DATA];
  int n;
};

struct Scratch {
  float* nu;  // (CB,): the block's potentials
  float* ws;  // (CB, W) in shared memory, or null
};

struct Base {
  static constexpr int CB = 8;
  using Scratch = generic::Scratch;

  Data data;
  float* ws_global;  // the global workspace, (blocks, CB, W), or null

  static bool no_tile(const Geometry& G) {
    return G.points == 0 && G.row_stride == 0;
  }

  bool lengths_are(const long long* lengths, int n) const {
    if (data.n != n) return false;
    for (int j = 0; j < n; ++j)
      if (!data.ptr[j] || data.len[j] != lengths[j]) return false;
    return true;
  }

  // the potentials, then (shared workspace) CB rows of W floats
  template <bool SHARED>
  static __device__ Scratch carve(float* base) {
    return Scratch{base, SHARED ? base + CB : nullptr};
  }

  // integer data operand j (an int32 row in a float slot)
  __device__ const int* int_row(int j) const {
    return reinterpret_cast<const int*>(data.ptr[j]);
  }

  __device__ void request(const Scratch&) const {}
  __device__ void drain(const Scratch&) const {}

  // chain c's W floats of workspace
  template <bool SHARED, int W>
  __device__ float* chain_workspace(const Scratch& S, int c) const {
    if (SHARED) return S.ws + (size_t)c * W;
    return ws_global ? ws_global + ((size_t)blockIdx.x * CB + c) * W
                     : nullptr;
  }
};

}  // namespace generic

__device__ __forceinline__ float gpg_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float gpg_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float gpg_clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}
__device__ __forceinline__ float gpg_clamp_max(float x, float hi) {
  return x > hi ? hi : x;
}
__device__ __forceinline__ float gpg_relu(float x) {
  return x < 0.f ? 0.f : x;
}
__device__ __forceinline__ float gpg_sign(float x) {
  return x != x ? x : (x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f));
}
// torch.nn.functional.softplus and its backward (ATen's formulas)
__device__ __forceinline__ float gpg_softplus(float x, float beta,
                                              float threshold) {
  return x * beta > threshold ? x : log1pf(expf(x * beta)) / beta;
}
__device__ __forceinline__ float gpg_softplus_backward(float g, float x,
                                                       float beta,
                                                       float threshold) {
  const float z = expf(x * beta);
  return x * beta > threshold ? g : g * z / (z + 1.f);
}
__device__ __forceinline__ int gpg_imax(int a, int b) { return a > b ? a : b; }
// an index checked on the host to lie in [-n, n), wrapped as torch's
__device__ __forceinline__ int gpg_wrap(int k, int n) {
  return k < 0 ? k + n : k;
}
// the warp's maximum, butterfly as warp_sum's; NaN wins
__device__ __forceinline__ float gpg_warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = gpg_max(v, __shfl_down_sync(FULL, v, o));
  return __shfl_sync(FULL, v, 0);
}
// torch.logaddexp (ATen's CPU formula)
__device__ __forceinline__ float gpg_logaddexp(float a, float b) {
  if (fabsf(a) == __int_as_float(0x7f800000) && a == b) return a;
  const float m = a < b ? b : a;
  return m + log1pf(expf(-fabsf(a - b)));
}
// torch.digamma as torch computes it on the card: ATen's jiterator
// formula (digamma_string in ATen/native/cuda/Math.cuh) for float, which
// NVRTC compiles with its default FMA contraction (the series' multiply-add
// an fmaf here); on the CPU torch's float formula (calc_digamma in
// ATen/native/Math.h) sums the last line in another order, a few ulp away
__device__ inline float gpg_digamma(float x) {
  const double PI_f64 = 3.14159265358979323846;
  if (x == 0.f) return copysignf(__int_as_float(0x7f800000), -x);
  float result = 0.f;
  if (x < 0.f) {
    if (x == truncf(x)) return __int_as_float(0x7fc00000);
    double q;
    const double r = modf((double)x, &q);
    result = (float)(-PI_f64 / tan(PI_f64 * r));
    x = 1.f - x;
  }
  while (x < 10.f) {
    result -= 1.f / x;
    x += 1.f;
  }
  if (x == 10.f) return result + 2.25175258906672110764f;
  const float A[] = {8.33333333333333333333E-2f, -2.10927960927960927961E-2f,
                     7.57575757575757575758E-3f, -4.16666666666666666667E-3f,
                     3.96825396825396825397E-3f, -8.33333333333333333333E-3f,
                     8.33333333333333333333E-2f};
  float y = 0.f;
  if (x < 1.0e17f) {
    const float z = 1.f / (x * x);
    float p = 0.f;
    for (int i = 0; i <= 6; ++i) p = fmaf(p, z, A[i]);
    y = z * p;
  }
  return logf(x) - (0.5f / x) - y + result;
}
// torch.special.log_ndtr (ATen's calc_log_ndtr for float)
__device__ __forceinline__ float gpg_log_ndtr(float x) {
  const float t = x * 0.707106781186547524400844362104849f;
  if (x < -1.f) return logf(erfcxf(-t) / 2.f) - t * t;
  return log1pf(-erfcf(t) / 2.f);
}
__device__ __forceinline__ int gpg_imin(int a, int b) { return a < b ? a : b; }
// a per-chain index (computed on the card: max.dim's, a sort's, integer
// arithmetic on them) wrapped if negative and clamped into [0, n), as
// JAX's gather takes an index out of range (torch would raise)
__device__ __forceinline__ int gpg_index(int k, int n) {
  k = k < 0 ? k + n : k;
  return k < 0 ? 0 : (k >= n ? n - 1 : k);
}
// torch.remainder of integers held as floats: the sign of the divisor
__device__ __forceinline__ float gpg_remainder(float a, float b) {
  return a - b * floorf(a / b);
}
// the warp's product, butterfly as warp_sum's
__device__ __forceinline__ float gpg_warp_prod(float v) {
  for (int o = 16; o > 0; o >>= 1) v = v * __shfl_down_sync(FULL, v, o);
  return __shfl_sync(FULL, v, 0);
}
// whether element (a, ia) comes before (b, ib) in a sort of n elements:
// ascending (descending) value, a NaN the largest either way, ties in index
// order (torch's stable sort); an index of n or more (a bitonic network's
// padding) after every element
__device__ __forceinline__ bool gpg_sort_before(float a, int ia, float b,
                                                int ib, bool desc, int n) {
  if (ia >= n || ib >= n) return ib >= n && (ia < n || ia < ib);
  const bool na = a != a, nb = b != b;
  if (na || nb) return na && nb ? ia < ib : (desc ? na : nb);
  if (a != b) return desc ? a > b : a < b;
  return ia < ib;
}

}  // namespace aehmc
