// What a generated potential functor (struct GenericPG, written by
// aehmc_tpu_torch/ops/generic_pg.py:emit_cuda) stands on: its data table,
// its scratch (resident operands, a data tile, the per-chain workspace),
// and the scalar helpers its emitted expressions call.  The NUTS kernels
// 1-4 (nuts_generic.cu) and the HMC kernels 5-7 (hmc_generic.cu) take
// GenericPG as their functor, beside the hand-written LogisticPGT, FunnelPG
// and EightSchoolsPG.
//
// The contract is the NUTS core's (nuts_core.cuh), which the HMC core
// (hmc_core.cuh) shares: CB = 8 chains a block, one warp a chain; Scratch
// holds the block's potentials nu; carve_scratch(base, ds) carves it after
// the core's rows; fits(dim, G) checks a launch's points and row stride
// against the geometry the functor was emitted with; operator()(S, dim, ds,
// q, grad, bool) leaves each chain's gradient row and potential, and a
// __syncwarp orders them before the warp reads them.  The whole block calls
// it, a __syncthreads before every call (both cores), and it may hold block
// barriers of its own.  request(S), at block entry (every thread; a
// __syncthreads follows before the first call), copies the resident
// operands into shared memory; drain(S), before the block exits, waits for
// any copy still in flight (none: every call consumes what it requests).
//
// Data operands.  The geometry (ops/launch_plan.py:generic_geometry) makes
// the small operands resident: copied once at block entry and read from
// shared memory for the whole launch.  An operand too large for that, read
// by a top-level matrix product a whole row at a time, is streamed: the
// product runs chunk-major over TILE_ROWS rows a chunk (a multiple of 32),
// which the block's threads copy (cp.async, 4 bytes a thread at a time:
// the rows are padded to TILE_STRIDE words, an odd number, so that lanes
// reading neighbouring rows hit distinct banks) into one of two tile
// buffers while the block reads the other; a product whose lanes sum along
// the rows copies a window of its columns at a time (an odd stride too),
// its lanes' partial sums of the window's outputs held in registers across
// the chunks.  A chunk is waited for, then a __syncthreads makes it visible
// and frees the other buffer, into which the next chunk (of this product
// or of the next streamed one) is requested at once; the first is
// requested at the call's entry.  Every sum keeps the
// order of its terms: a lane's terms of a sum over rows are the same rows
// in the same order whether the rows come from the tile or from global
// memory, so the tiled functor computes the untiled one's bits.  Block
// barriers stand only at the functor's top level, never in a loop whose
// trip count depends on a chain's values; a product inside such a loop (a
// factorisation's) reads its operands from global memory (__ldg) or from a
// resident copy.  Every other operand is read from global memory.
//
// The workspace holds the values a chain's potential materialises (the
// contractions' outputs and the elementwise values a product reads more
// than once), W floats a chain: in shared memory after the tile when two
// blocks still fit an SM with it, else in a global buffer of blocks × CB ×
// W floats the wrapper allocates (launch_plan.generic_workspace_floats),
// indexed by block and warp, so a chain keeps its slot across the draws of
// kernels 2 and 4.  With a global workspace, a functor that factors or
// solves dense matrices (Cholesky, LU, a triangular solve of several right
// sides) may have a factor scratch of FS floats a chain in shared memory
// after it: each such node copies its matrix in, works there (a factor at
// an odd row stride, so lanes reading down a column hit distinct banks),
// and writes its result to its workspace slot; a warp's nodes take the
// scratch in turn, no block barrier.
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

// the scalar series' bodies (gpg_bessel, gpg_trigamma, gpg_zeta) are
// compiled once a source rather than inlined at every functor call of the
// seven kernels: a call of a scalar costs little beside its series, and
// nvcc's time on a functor that holds them falls to a fraction.  The dense
// nodes' bodies (gpg_mexp, gpg_qr, gpg_svd) are templates on their sizes,
// inlined: out of line, a body's sizes are runtime values (a division in
// every element loop, sums over k that do not unroll) and its workspace
// pointers generic: U3's kernel 1 took 47.2 ms so against 11.4 inlined on
// the H100 (PERF.md §6)
#ifdef __CUDACC__
#define GPG_NOINLINE __noinline__
#else
#define GPG_NOINLINE
#endif

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
  float* nu;    // (CB,): the block's potentials
  float* res;   // the resident operands, at 4-float offsets
  float* tile;  // two tile buffers of TILE_FLOATS each
  float* ws;    // (CB, W) in shared memory, or null
  float* fs;    // (CB, FS): the dense nodes' working matrices, or null
};

#ifdef __CUDACC__
// one 4-byte asynchronous copy from global into shared memory; the
// copies a thread has issued since its last commit form one group
__device__ __forceinline__ void gpg_copy4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void gpg_copy_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// wait until this thread's groups have landed
__device__ __forceinline__ void gpg_copy_wait() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}
#endif

struct Base {
  static constexpr int CB = 8;
  static constexpr bool NUTS_HOOKS = true;  // the resident operands
  using Scratch = generic::Scratch;

  Data data;
  float* ws_global;  // the global workspace, (blocks, CB, W), or null

  // whether a launch's geometry is the one the functor was emitted with
  static bool tile_is(const Geometry& G, int points, int row_stride) {
    return G.points == points && G.row_stride == row_stride;
  }

  bool lengths_are(const long long* lengths, int n) const {
    if (data.n != n) return false;
    for (int j = 0; j < n; ++j)
      if (!data.ptr[j] || data.len[j] != lengths[j]) return false;
    return true;
  }

  // the potentials, the RES floats of resident operands, two tile buffers
  // of TILE floats, then (shared workspace) CB rows of W floats, then CB
  // rows of FS floats of factor scratch
  template <bool SHARED, int RES, int TILE, int W = 0, int FS = 0>
  static __device__ Scratch carve(float* base) {
    float* res = base + CB;
    float* tile = res + RES;
    float* ws = tile + 2 * TILE;
    float* fs = ws + (SHARED ? CB * W : 0);
    return Scratch{base, res, tile, SHARED ? ws : nullptr,
                   FS ? fs : nullptr};
  }

  // integer data operand j (an int32 row in a float slot)
  __device__ const int* int_row(int j) const {
    return reinterpret_cast<const int*>(data.ptr[j]);
  }

  // every thread, at block entry: operand j's n words into the resident
  // area at `off` (a __syncthreads follows before any read)
  __device__ void make_resident(const Scratch& S, int j, int off,
                                int n) const {
    const float* src = data.ptr[j];
    for (int e = threadIdx.x; e < n; e += NT) S.res[off + e] = src[e];
  }

  // every thread: request rows [r0, r0 + rows) of operand `src` (R floats a
  // row), their columns [col, col + ncols) (NC at most: a window; the
  // whole row by default), into the tile buffer `dst`, RS words a row, as
  // one group of asynchronous copies
  template <int R, int RS, int NC = R>
  __device__ void fill(float* dst, const float* src, int r0, int rows,
                       int col = 0, int ncols = NC) const {
    const float* from = src + (size_t)r0 * R + col;
    for (int e = threadIdx.x; e < rows * NC; e += NT) {
      const int r = e / NC, k = e % NC;
      if (NC == R || k < ncols)
        gpg_copy4(dst + (RS == NC ? e : r * RS + k),
                  from + (NC == R ? e : (size_t)r * R + k));
    }
    gpg_copy_commit();
  }

  // every thread: wait for the chunk requested last, then the block
  // barrier that makes it visible to every warp and frees the other buffer
  __device__ void chunk_ready() const {
    gpg_copy_wait();
    __syncthreads();
  }

  // before the block exits: nothing a call requested outlives it
  __device__ void drain(const Scratch&) const { gpg_copy_wait(); }

  // chain c's FS floats of factor scratch (shared memory)
  template <int FS>
  __device__ float* chain_factor(const Scratch& S, int c) const {
    return S.fs + (size_t)c * FS;
  }

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
// warp_sum of N values a lane at once (N a power of 2, at most 32): at each
// level of warp_sum's butterfly a lane keeps half of the values it still
// holds and adds its partner's (lane xor the level) copy of that half, so
// value u's sum pairs its terms as warp_sum pairs them (the two of a pair
// added in either order: the same float), in N - 1 + 5 - log2(N) shuffles
// (31 for 32 values, against 192); value u ends in lanes (32/N) u to
// (32/N)(u + 1) - 1, which return it
template <int N>
__device__ __forceinline__ float gpg_warp_sums(float (&v)[N], int lane) {
  static_assert(N >= 1 && N <= 32 && (N & (N - 1)) == 0, "a power of 2");
  int m = N;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    if (m > 1) {
      const bool up = (lane & o) != 0;
#pragma unroll
      for (int t = 0; t < N / 2; ++t) {
        if (t < m / 2) {
          const float mine = up ? v[t + m / 2] : v[t];
          const float give = up ? v[t] : v[t + m / 2];
          v[t] = mine + __shfl_xor_sync(FULL, give, o);
        }
      }
      m >>= 1;
    } else {
      v[0] = v[0] + __shfl_xor_sync(FULL, v[0], o);
    }
  }
  return v[0];
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

// torch.xlogy and torch.special.xlog1py: NaN where y is, 0 where x is 0
__device__ __forceinline__ float gpg_xlogy(float x, float y) {
  if (y != y) return __int_as_float(0x7fc00000);
  if (x == 0.f) return 0.f;
  return x * logf(y);
}
__device__ __forceinline__ float gpg_xlog1py(float x, float y) {
  if (y != y) return __int_as_float(0x7fc00000);
  if (x == 0.f) return 0.f;
  return x * log1pf(y);
}
// F.logsigmoid and its backward (ATen's CUDA formulas; the backward
// recomputes exp(-|x|), the CPU's buffer)
__device__ __forceinline__ float gpg_log_sigmoid(float x) {
  const float m = x < 0.f ? x : 0.f;
  return m - log1pf(expf(-fabsf(x)));
}
__device__ __forceinline__ float gpg_log_sigmoid_backward(float g, float x) {
  const bool neg = x < 0.f;
  const float z = expf(-fabsf(x));
  return g * ((neg ? 1.f : 0.f) - (neg ? 1.f : -1.f) * (z / (1.f + z)));
}
// torch.logit (ATen's CUDA kernel): log(z / (1 - z)), z clamped into
// [lo, hi] when clamp (eps given)
__device__ __forceinline__ float gpg_logit(float x, float lo, float hi,
                                           bool clamp) {
  const float z = clamp ? (x < lo ? lo : (x > hi ? hi : x)) : x;
  return logf(z / (1.f - z));
}
__device__ __forceinline__ float gpg_logit_backward(float g, float x,
                                                    float lo, float hi,
                                                    bool clamp) {
  if (clamp) return (x < lo || x > hi) ? 0.f : g / (x * (1.f - x));
  return (x < 0.f || x > 1.f) ? __int_as_float(0x7fc00000)
                              : g / (x * (1.f - x));
}
// Cephes's Chebyshev series (chbevl), as ATen's i0/i0e/i1/i1e run it on
// the card: their jiterator strings, in their orders, which NVRTC compiles
// with its default FMA contraction (x * b1 - b2 an fmaf here)
__device__ inline float gpg_chbevl(float x, const float* a, int len) {
  float b0 = a[0], b1 = 0.f, b2 = 0.f;
  for (int i = 1; i < len; ++i) {
    b2 = b1;
    b1 = b0;
    b0 = fmaf(x, b1, -b2) + a[i];
  }
  return 0.5f * (b0 - b2);
}
__device__ GPG_NOINLINE inline float gpg_bessel(float x, bool one,
                                                bool scaled) {
  // Cephes's i0 (A 30, B 25 terms) and i1 (A 29, B 25) coefficients
  const float A0[] = {
      -4.41534164647933937950e-18f, 3.33079451882223809783e-17f,
      -2.43127984654795469359e-16f, 1.71539128555513303061e-15f,
      -1.16853328779934516808e-14f, 7.67618549860493561688e-14f,
      -4.85644678311192946090e-13f, 2.95505266312963983461e-12f,
      -1.72682629144155570723e-11f, 9.67580903537323691224e-11f,
      -5.18979560163526290666e-10f, 2.65982372468238665035e-09f,
      -1.30002500998624804212e-08f, 6.04699502254191894932e-08f,
      -2.67079385394061173391e-07f, 1.11738753912010371815e-06f,
      -4.41673835845875056359e-06f, 1.64484480707288970893e-05f,
      -5.75419501008210370398e-05f, 1.88502885095841655729e-04f,
      -5.76375574538582365885e-04f, 1.63947561694133579842e-03f,
      -4.32430999505057594430e-03f, 1.05464603945949983183e-02f,
      -2.37374148058994688156e-02f, 4.93052842396707084878e-02f,
      -9.49010970480476444210e-02f, 1.71620901522208775349e-01f,
      -3.04682672343198398683e-01f, 6.76795274409476084995e-01f};
  const float B0[] = {
      -7.23318048787475395456e-18f, -4.83050448594418207126e-18f,
      4.46562142029675999901e-17f,  3.46122286769746109310e-17f,
      -2.82762398051658348494e-16f, -3.42548561967721913462e-16f,
      1.77256013305652638360e-15f,  3.81168066935262242075e-15f,
      -9.55484669882830764870e-15f, -4.15056934728722208663e-14f,
      1.54008621752140982691e-14f,  3.85277838274214270114e-13f,
      7.18012445138366623367e-13f,  -1.79417853150680611778e-12f,
      -1.32158118404477131188e-11f, -3.14991652796324136454e-11f,
      1.18891471078464383424e-11f,  4.94060238822496958910e-10f,
      3.39623202570838634515e-09f,  2.26666899049817806459e-08f,
      2.04891858946906374183e-07f,  2.89137052083475648297e-06f,
      6.88975834691682398426e-05f,  3.36911647825569408990e-03f,
      8.04490411014108831608e-01f};
  const float A1[] = {
      2.77791411276104639959e-18f,  -2.11142121435816608115e-17f,
      1.55363195773620046921e-16f,  -1.10559694773538630805e-15f,
      7.60068429473540693410e-15f,  -5.04218550472791168711e-14f,
      3.22379336594557470981e-13f,  -1.98397439776494371520e-12f,
      1.17361862988909016308e-11f,  -6.66348972350202774223e-11f,
      3.62559028155211703701e-10f,  -1.88724975172282928790e-09f,
      9.38153738649577178388e-09f,  -4.44505912879632808065e-08f,
      2.00329475355213526229e-07f,  -8.56872026469545474066e-07f,
      3.47025130813767847674e-06f,  -1.32731636560394358279e-05f,
      4.78156510755005422638e-05f,  -1.61760815825896745588e-04f,
      5.12285956168575772895e-04f,  -1.51357245063125314899e-03f,
      4.15642294431288815669e-03f,  -1.05640848946261981558e-02f,
      2.47264490306265168283e-02f,  -5.29459812080949914269e-02f,
      1.02643658689847095384e-01f,  -1.76416518357834055153e-01f,
      2.52587186443633654823e-01f};
  const float B1[] = {
      7.51729631084210481353e-18f,  4.41434832307170791151e-18f,
      -4.65030536848935832153e-17f, -3.20952592199342395980e-17f,
      2.96262899764595013876e-16f,  3.30820231092092828324e-16f,
      -1.88035477551078244854e-15f, -3.81440307243700780478e-15f,
      1.04202769841288027642e-14f,  4.27244001671195135429e-14f,
      -2.10154184277266431302e-14f, -4.08355111109219731823e-13f,
      -7.19855177624590851209e-13f, 2.03562854414708950722e-12f,
      1.41258074366137813316e-11f,  3.25260358301548823856e-11f,
      -1.89749581235054123450e-11f, -5.58974346219658380687e-10f,
      -3.83538038596423702205e-09f, -2.63146884688951950684e-08f,
      -2.51223623787020892529e-07f, -3.88256480887769039346e-06f,
      -1.10588938762623716291e-04f, -9.76109749136146840777e-03f,
      7.78576235018280120474e-01f};
  const float z = fabsf(x);
  // i1e in float takes the last 17 and 7 terms (ATen's float i1e)
  const int a1 = scaled ? 17 : 29, b1 = scaled ? 7 : 25;
  float out;
  if (z <= 8.f) {
    const float y = z / 2.f - 2.f;
    if (one)
      out = scaled ? gpg_chbevl(y, A1 + 29 - a1, a1) * z
                   : expf(z) * z * gpg_chbevl(y, A1, a1);
    else
      out = scaled ? gpg_chbevl(y, A0, 30) : expf(z) * gpg_chbevl(y, A0, 30);
  } else {
    const float c = one ? gpg_chbevl(32.f / z - 2.f, B1 + 25 - b1, b1)
                        : gpg_chbevl(32.f / z - 2.f, B0, 25);
    out = scaled ? c / sqrtf(z) : expf(z) * c / sqrtf(z);
  }
  return one && x < 0.f ? -out : out;
}
__device__ __forceinline__ float gpg_i0e(float x) {
  return gpg_bessel(x, false, true);
}
__device__ __forceinline__ float gpg_i1e(float x) {
  return gpg_bessel(x, true, true);
}
__device__ __forceinline__ float gpg_i0(float x) {
  return gpg_bessel(x, false, false);
}
__device__ __forceinline__ float gpg_i1(float x) {
  return gpg_bessel(x, true, false);
}
// torch.polygamma(1, x): ATen's trigamma (its jiterator string, the
// series' multiply-adds fmaf as NVRTC contracts them)
__device__ GPG_NOINLINE inline float gpg_trigamma(float x) {
  const float PI = 3.14159265358979323846f;
  float sign = 1.f, result = 0.f;
  if (x < 0.5f) {
    sign = -1.f;
    const float s = sinf(PI * x);
    result -= (PI * PI) / (s * s);
    x = 1.f - x;
  }
  for (int i = 0; i < 6; ++i) {
    result += 1.f / (x * x);
    x += 1.f;
  }
  const float ixx = 1.f / (x * x);
  const float t = fmaf(-ixx, 1.f / 42.f, 1.f / 30.f);
  const float u = fmaf(-ixx, t, 1.f / 6.f);
  result += fmaf(ixx, u, 1.f + 1.f / (2.f * x)) / x;
  return sign * result;
}
// Cephes's Hurwitz zeta(x, q), ATen's zeta_string for float (NVRTC's
// contraction of s - 0.5 b an fmaf)
__device__ GPG_NOINLINE inline float gpg_zeta(float x, float q) {
  const float MACHEP = 1.11022302462515654042E-16f;
  const float A[] = {12.0f, -720.0f, 30240.0f, -1209600.0f, 47900160.0f,
                     -1.8924375803183791606e9f, 7.47242496e10f,
                     -2.950130727918164224e12f, 1.1646782814350067249e14f,
                     -4.5979787224074726105e15f, 1.8152105401943546773e17f,
                     -7.1661652561756670113e18f};
  if (x == 1.f) return __int_as_float(0x7f800000);
  if (x < 1.f) return __int_as_float(0x7fc00000);
  if (q <= 0.f) {
    if (q == floorf(q)) return __int_as_float(0x7f800000);
    if (x != floorf(x)) return __int_as_float(0x7fc00000);
  }
  float s = powf(q, -x), a = q, b = 0.f;
  int i = 0;
  while (i < 9 || a <= 9.f) {
    i += 1;
    a += 1.f;
    b = powf(a, -x);
    s += b;
    if (-MACHEP * s < b && b < MACHEP * s) return s;
  }
  const float w = a;
  s += b * w / (x - 1.f);
  s = fmaf(-0.5f, b, s);
  a = 1.f;
  float k = 0.f;
  for (int j = 0; j < 12; ++j) {
    a *= x + k;
    b /= w;
    float t = a * b / A[j];
    s = s + t;
    t = fabsf(t / s);
    if (t < MACHEP) return s;
    k += 1.f;
    a *= x + k;
    b /= w;
    k += 1.f;
  }
  return s;
}
// torch.polygamma(n, x), n >= 2: (-1)^(n+1) n! zeta(n + 1, x)
__device__ inline float gpg_polygamma(float x, int n) {
  return ((n % 2) ? 1.f : -1.f) * expf(lgammaf((float)n + 1.f)) *
         gpg_zeta((float)(n + 1), x);
}
// ATen's _log_add_exp_helper (logcumsumexp's step; mn - mn == 0: mn finite)
__device__ __forceinline__ float gpg_log_add_exp(float x, float y) {
  const float mn = y != y ? y : (y < x ? y : x);
  const float mx = y != y ? y : (x < y ? y : x);
  if (mn != mx || mn - mn == 0.f) return log1pf(expf(mn - mx)) + mx;
  return x;
}

// degree 8's coefficients as ATen's float constexprs round them
#define GPG_T8_X1 0x1.bbdc940000000p-4f
#define GPG_T8_X2 0x1.bbdc940000000p-6f
#define GPG_T8_X3 0x1.5555560000000p-1f
#define GPG_T8_X4 0x1.17f11c0000000p-1f
#define GPG_T8_X5 0x1.49fc340000000p-3f
#define GPG_T8_X6 0x1.cdbb2a0000000p-7f
#define GPG_T8_X7 0x1.711b820000000p-6f
#define GPG_T8_Y2 0x1.157d080000000p-3f
// ---- the out-of-line factorisations' dense nodes, their sizes compile-time
// constants (templates instantiated a size a functor uses) and inlined into
// the functor, so the element loops divide by constants, the sums over k
// unroll, and a pointer into the shared workspace keeps its address space.
// Every lane calls each; each ends in a __syncwarp.

// the elements a lane holds of G matrices of NN elements a warp pass: G ==
// 1 strides the lanes over one matrix (PER elements a lane), G NN <= 32
// gives a lane at most one element of one matrix
template <int NN, int G>
struct GpgLanes {
  static_assert(G == 1 || G * NN <= 32, "a lane's elements in one matrix");
  static constexpr int PER = G == 1 ? (NN + 31) / 32 : 1;
  int lane;
  bool mine;  // whether the lane's matrix is in the pass
  // element t's index in the lane's matrix, and whether the lane holds it
  __device__ __forceinline__ int e(int t) const {
    return G == 1 ? lane + 32 * t : lane % NN;
  }
  __device__ __forceinline__ bool on(int t) const {
    return mine && (G == 1 ? NN % 32 == 0 || lane + 32 * t < NN
                           : lane < G * NN);
  }
};
// C = X Y of N x N matrices at the lane's elements: fmaf along k in order
template <int N, int G>
__device__ __forceinline__ void gpg_mx_mul(float* __restrict__ C,
                                           const float* __restrict__ X,
                                           const float* __restrict__ Y,
                                           const GpgLanes<N * N, G>& L) {
#pragma unroll
  for (int t = 0; t < L.PER; ++t) {
    if (!L.on(t)) continue;
    const int i = L.e(t) / N, j = L.e(t) % N;
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < N; ++k) acc = fmaf(X[i * N + k], Y[k * N + j], acc);
    C[L.e(t)] = acc;
  }
}
// sum_i c[i] X_i[e] from i = 0 in order (ATen's
// _compute_linear_combination), X_i = X + i NN; with ID, X_0 is the
// identity and X_i = X + (i - 1) NN
template <int N, bool ID, int C>
__device__ __forceinline__ float gpg_mx_comb(const float (&c)[C],
                                             const float* X, int e) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const float x = ID && i == 0 ? (e / N == e % N ? 1.f : 0.f)
                                 : X[(i - (ID ? 1 : 0)) * N * N + e];
    acc = fmaf(c[i], x, acc);
  }
  return acc;
}
// ATen's mexp degree for a 1-norm (float thresholds): 0-5 for degree 1, 2,
// 4, 8, 12, 18; -1 for a NaN or infinite norm, which no degree or scale
// takes (ATen's gives NaN; its scale, an int64 of +inf, never ends its
// squarings on the card)
__device__ __forceinline__ int gpg_mexp_degree(float norm) {
  if (!(norm <= 3.4e38f)) return -1;
  if (norm <= 1.192092800768788e-07f) return 0;
  if (norm <= 5.978858893805233e-04f) return 1;
  if (norm <= 5.116619363445086e-02f) return 2;
  if (norm <= 5.800524627688768e-01f) return 3;
  if (norm < 1.461661507209034e+00f) return 4;
  return 5;
}
// torch.linalg.matrix_exp of `count` (at most G) N x N matrices a warp
// pass (ATen's mexp for float: the 1-norm picks Bader, Blanes and Casas's
// Taylor polynomial of degree 1, 2, 4, 8, 12 or 18; beyond the last, A /
// 2^s and s squarings), matrix g's argument at M + g 10 N^2 and its
// exponential into out + g N^2.  M's 10 matrices a matrix: A, A^2, A^3
// (A^4), A^6 (A^8), five combinations, a product's buffer; the identity is
// computed, not stored.  Each matrix keeps its own degree and every
// element's terms their order, so a pass computes the one-matrix body's
// bits.  The degrees' steps run as nine phases with a __syncwarp after
// each (then the squarings): in a phase each lane runs its matrix's step,
// so matrices of different degrees share a pass, and every lane meets
// every barrier
template <int N, int G>
__device__ __forceinline__ void gpg_mexp(float* out, float* M, int count,
                                         int lane) {
  constexpr int NN = N * N, S = 10 * NN;
  const int g = G == 1 ? 0 : lane / NN;
  const bool mine = g < count;
  const GpgLanes<NN, G> L{lane, mine};
  float* A = M + (mine ? g : 0) * S;
  float* A2 = A + NN;
  float* A3 = A + 2 * NN;
  float* A6 = A + 3 * NN;
  float* B = A + 4 * NN;
  float* T = A + 9 * NN;
  float* O = out + (mine ? g : 0) * NN;
  // the 1-norm: each column's sum in order of rows, their maximum
  float norm = 0.f;
  if (G == 1) {
    for (int j = lane; j < N; j += 32) {
      float col = 0.f;
#pragma unroll
      for (int i = 0; i < N; ++i) col = col + fabsf(A[i * N + j]);
      norm = gpg_max(norm, col);
    }
    norm = gpg_warp_max(norm);
  } else {  // lane h < G N sums column h % N of matrix h / N
    float col = 0.f;
    if (lane < G * N && lane / N < count) {
      const float* Ah = M + (lane / N) * S;
#pragma unroll
      for (int i = 0; i < N; ++i) col = col + fabsf(Ah[i * N + lane % N]);
    }
    const int from = (mine ? g : 0) * N;
#pragma unroll
    for (int j = 0; j < N; ++j)
      norm = gpg_max(norm, __shfl_sync(FULL, col, from + j));
  }
  const int deg = mine ? gpg_mexp_degree(norm) : -2;
  int s = 0;
  if (deg == 5) {  // s = max(0, ceil(log2(norm / theta_18)))
    const float sc = ceilf(log2f(norm / 3.010066362817634e+00f));
    s = sc > 0.f ? (int)sc : 0;
  }
  const int smax = (int)gpg_warp_max((float)s);
  // 1: degree 18 scales A by 2^-s
  if (s > 0) {
    const float div = ldexpf(1.f, s);
#pragma unroll
    for (int t = 0; t < L.PER; ++t)
      if (L.on(t)) A[L.e(t)] = A[L.e(t)] / div;
  }
  __syncwarp();
  // 2: A^2
  if (deg >= 1) gpg_mx_mul<N, G>(A2, A, A, L);
  __syncwarp();
  // 3: degrees 1 and 2 their result, 4 and 8 their first combination, 12
  // and 18 A^3
  if (deg >= 4) {
    gpg_mx_mul<N, G>(A3, A, A2, L);
  } else if (deg >= -1) {
#pragma unroll
    for (int t = 0; t < L.PER; ++t) {
      if (!L.on(t)) continue;
      const int e = L.e(t);
      if (deg == -1) {
        O[e] = __int_as_float(0x7fc00000);
      } else if (deg == 0) {
        const float c[] = {1.f, 1.f};
        O[e] = gpg_mx_comb<N, true>(c, A, e);
      } else if (deg == 1) {
        const float c[] = {1.f, 1.f, 0.5f};
        O[e] = gpg_mx_comb<N, true>(c, A, e);
      } else if (deg == 2) {
        const float c[] = {1.f / 2.f, 1.f / 6.f, 1.f / 24.f};
        B[e] = gpg_mx_comb<N, true>(c, A, e);
      } else {
        const float x[] = {GPG_T8_X1, GPG_T8_X2};
        B[e] = gpg_mx_comb<N, false>(x, A, e);
      }
    }
  }
  __syncwarp();
  // 4: degrees 4 and 8 A^3 (A^4), 12 its combinations, 18 A^6
  if (deg == 2 || deg == 3) {
    gpg_mx_mul<N, G>(A3, A2, B, L);
  } else if (deg == 4) {
    const float b[4][4] = {
        {9.0198e-16f, 0.46932117595418237389f, -0.20099424927047284052f,
         -0.04623946134063071740f},
        {5.31597895759871264183f, 1.19926790417132231573f,
         0.01179296240992997031f, 0.01108844528519167989f},
        {0.18188869982170434744f, 0.05502798439925399070f,
         0.09351590770535414968f, 0.00610700528898058230f},
        {-2.0861320e-13f, -0.13181061013830184015f,
         -0.02027855540589259079f, -0.00675951846863086359f}};
#pragma unroll
    for (int t = 0; t < L.PER; ++t) {
      if (!L.on(t)) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        B[i * NN + L.e(t)] = gpg_mx_comb<N, true>(b[i], A, L.e(t));
    }
  } else if (deg == 5) {
    gpg_mx_mul<N, G>(A6, A3, A3, L);
  }
  __syncwarp();
  // 5: degree 4 its result, 8 its two combinations, 12 a product, 18 its
  // combinations
  if (deg == 4) {
    gpg_mx_mul<N, G>(T, B + 3 * NN, B + 3 * NN, L);
  } else if (deg >= 2) {
#pragma unroll
    for (int t = 0; t < L.PER; ++t) {
      if (!L.on(t)) continue;
      const int e = L.e(t);
      if (deg == 2) {
        const float d[] = {1.f, 1.f, 0.f, 1.f};
        O[e] = gpg_mx_comb<N, true>(d, A, e);
      } else if (deg == 3) {  // A3 holds A^4
        const float u[] = {GPG_T8_X3, 1.f};
        const float v[] = {GPG_T8_X4, GPG_T8_X5, GPG_T8_X6, GPG_T8_X7};
        B[e] = gpg_mx_comb<N, false>(u, A2, e);
        B[NN + e] = gpg_mx_comb<N, true>(v, A, e);
      } else {
        const float b[5][5] = {
            {0.f, -1.00365581030144618291e-01f, -8.02924648241156932449e-03f,
             -8.92138498045658237863e-04f, 0.f},
            {0.f, 3.97849749499645077844e-01f, 1.36783778460411720168e+00f,
             4.98289622525382669416e-01f, -6.37898194594723280150e-04f},
            {-1.09676396052962061844e+01f, 1.68015813878906206114e+00f,
             5.71779846478865511061e-02f, -6.98210122488052056106e-03f,
             3.34975017086070470649e-05f},
            {-9.04316832390810593223e-02f, -6.76404519071381882256e-02f,
             6.75961301770459654925e-02f, 2.95552570429315521194e-02f,
             -1.39180257516060693404e-05f},
            {0.f, 0.f, -9.23364619367118555360e-02f,
             -1.69364939002081722752e-02f, -1.40086798182036094347e-05f}};
#pragma unroll
        for (int i = 0; i < 5; ++i)
          B[i * NN + e] = gpg_mx_comb<N, true>(b[i], A, e);
      }
    }
  }
  __syncwarp();
  // 6: degree 8 A^8 (in A6), 12 two sums, 18 a product
  if (deg == 3) {
    gpg_mx_mul<N, G>(A6, B, B + NN, L);
  } else if (deg == 4) {
#pragma unroll
    for (int t = 0; t < L.PER; ++t) {
      if (!L.on(t)) continue;
      const int e = L.e(t);
      B[2 * NN + e] = B[2 * NN + e] + T[e];
      B[NN + e] = B[NN + e] + B[2 * NN + e];
    }
  } else if (deg == 5) {
    gpg_mx_mul<N, G>(T, B, B + 4 * NN, L);
  }
  __syncwarp();
  // 7: degree 8 its result, 12 a product, 18 two sums
  if (deg == 3) {
    const float d[] = {1.f, 1.f, GPG_T8_Y2, 0.f, 1.f};
#pragma unroll
    for (int t = 0; t < L.PER; ++t)
      if (L.on(t)) O[L.e(t)] = gpg_mx_comb<N, true>(d, A, L.e(t));
  } else if (deg == 4) {
    gpg_mx_mul<N, G>(T, B + NN, B + 2 * NN, L);
  } else if (deg == 5) {
#pragma unroll
    for (int t = 0; t < L.PER; ++t) {
      if (!L.on(t)) continue;
      const int e = L.e(t);
      B[3 * NN + e] = B[3 * NN + e] + T[e];
      B[2 * NN + e] = B[2 * NN + e] + B[3 * NN + e];
    }
  }
  __syncwarp();
  // 8: degree 12 its result, 18 a product
  if (deg == 4) {
#pragma unroll
    for (int t = 0; t < L.PER; ++t)
      if (L.on(t)) O[L.e(t)] = B[L.e(t)] + T[L.e(t)];
  } else if (deg == 5) {
    gpg_mx_mul<N, G>(T, B + 2 * NN, B + 3 * NN, L);
  }
  __syncwarp();
  // 9: degree 18 its result, then its s squarings
  if (deg == 5) {
#pragma unroll
    for (int t = 0; t < L.PER; ++t)
      if (L.on(t)) O[L.e(t)] = B[NN + L.e(t)] + T[L.e(t)];
  }
  __syncwarp();
  for (int p = 0; p < smax; ++p) {
    const bool sq = deg == 5 && p < s;
    if (sq) gpg_mx_mul<N, G>(T, O, O, L);
    __syncwarp();
    if (sq) {
#pragma unroll
      for (int t = 0; t < L.PER; ++t)
        if (L.on(t)) O[L.e(t)] = T[L.e(t)];
    }
    __syncwarp();
  }
}
// the reduced QR of the M x N (M >= N) matrix in W: Householder
// reflections with LAPACK's geqrf convention (beta = -sign(alpha) ||x||,
// tau = (beta - alpha) / beta, none where x below the diagonal is 0), then
// Q as orgqr forms it (H_0 ... H_{N-1} applied to I's first N columns,
// the last first); out holds Q (M x N) over R (N x N); tau N floats
template <int M, int N>
__device__ __forceinline__ void gpg_qr(float* out, float* W, float* tau,
                                       int lane) {
  for (int k = 0; k < N; ++k) {
    float s = 0.f;
    for (int r = k + 1 + lane; r < M; r += 32)
      s = fmaf(W[r * N + k], W[r * N + k], s);
    s = warp_sum(s);
    const float alpha = W[k * N + k];
    float beta = alpha, tk = 0.f, scal = 1.f;
    if (s > 0.f) {
      beta = -copysignf(sqrtf(fmaf(alpha, alpha, s)), alpha);
      tk = (beta - alpha) / beta;
      scal = 1.f / (alpha - beta);
    }
    __syncwarp();  // every lane has read alpha
    for (int r = k + 1 + lane; r < M; r += 32) W[r * N + k] *= scal;
    if (lane == 0) {
      W[k * N + k] = beta;
      tau[k] = tk;
    }
    __syncwarp();
    for (int j = k + 1 + lane; j < N; j += 32) {
      float w = W[k * N + j];
      for (int r = k + 1; r < M; ++r) w = fmaf(W[r * N + k], W[r * N + j], w);
      w = w * tk;
      W[k * N + j] -= w;
      for (int r = k + 1; r < M; ++r)
        W[r * N + j] = fmaf(-w, W[r * N + k], W[r * N + j]);
    }
    __syncwarp();
  }
  for (int e = lane; e < N * N; e += 32) {
    const int i = e / N, j = e % N;
    out[(M + i) * N + j] = j >= i ? W[i * N + j] : 0.f;
  }
  for (int e = lane; e < M * N; e += 32) out[e] = e / N == e % N ? 1.f : 0.f;
  __syncwarp();
  for (int k = N - 1; k >= 0; --k) {
    for (int j = k + lane; j < N; j += 32) {
      float w = out[k * N + j];
      for (int r = k + 1; r < M; ++r) w = fmaf(W[r * N + k], out[r * N + j], w);
      w = w * tau[k];
      out[k * N + j] -= w;
      for (int r = k + 1; r < M; ++r)
        out[r * N + j] = fmaf(-w, W[r * N + k], out[r * N + j]);
    }
    __syncwarp();
  }
}
// lanes a group for P pairs: the largest power of 2 at most 32 / P (1
// from 17 pairs)
__device__ constexpr int gpg_pair_lanes(int P) {
  return P > 16 ? 1 : P > 8 ? 2 : P > 4 ? 4 : P > 2 ? 8 : P > 1 ? 16 : 32;
}
// the thin SVD of the M x N (M >= N) matrix in W by one-sided Jacobi in
// Brent and Luk's parallel order: a sweep is NP - 1 rounds of NP / 2
// disjoint column pairs (NP = N, or N + 1 with a column that pairs with
// nothing: the round-robin of a tournament, column 0 fixed), each pair on
// its own group of lanes, its norms and inner product summed over the
// group's rows and then by shuffles within the group; a pair whose cosine
// exceeds sqrt(M) eps rotates, until a sweep rotates none (or 30); then
// the columns' norms are the singular values, descending (ties by index),
// U's columns the normalised ones, V's the accumulated rotations, and each
// column of U (of V, FIX_V) has its largest component (the first of
// equals) positive, its partner flipped with it; out holds U (M x N), the
// singular values (N), V (N x N); V and sig (N) are workspace
template <int M, int N, bool FIX_V>
__device__ __forceinline__ void gpg_svd(float* out, float* W, float* V,
                                        float* sig, int lane) {
  constexpr int NP = N + (N & 1), PAIRS = NP / 2;
  constexpr int GL = gpg_pair_lanes(PAIRS), GROUPS = 32 / GL;
  for (int e = lane; e < N * N; e += 32) V[e] = e / N == e % N ? 1.f : 0.f;
  __syncwarp();
  const float tol = 1.1920929e-07f * sqrtf((float)M);
  const int grp = lane / GL, sub = lane % GL;
  for (int sweep = 0; sweep < 30; ++sweep) {
    bool rotated = false;
    for (int round = 0; round < NP - 1; ++round) {
      for (int c = 0; c < (PAIRS + GROUPS - 1) / GROUPS; ++c) {
        const int k = c * GROUPS + grp;  // every lane the same trips
        // the columns at places k and NP - 1 - k of the round's order
        const int x = k == 0 ? 0 : 1 + (k - 1 + round) % (NP - 1);
        const int y = 1 + (NP - 2 - k + round) % (NP - 1);
        const int p = x < y ? x : y, q = x < y ? y : x;
        const bool live = k < PAIRS && q < N;
        float a = 0.f, b = 0.f, g = 0.f;
        if (live) {
          for (int r = sub; r < M; r += GL) {
            const float wp = W[r * N + p], wq = W[r * N + q];
            a = fmaf(wp, wp, a);
            b = fmaf(wq, wq, b);
            g = fmaf(wp, wq, g);
          }
        }
#pragma unroll
        for (int o = GL / 2; o > 0; o >>= 1) {
          a += __shfl_xor_sync(FULL, a, o);
          b += __shfl_xor_sync(FULL, b, o);
          g += __shfl_xor_sync(FULL, g, o);
        }
        if (!live || !(fabsf(g) > tol * sqrtf(a * b))) continue;
        rotated = true;
        const float zeta = (b - a) / (2.f * g);
        const float t = copysignf(1.f, zeta) /
                        (fabsf(zeta) + sqrtf(fmaf(zeta, zeta, 1.f)));
        const float cs = 1.f / sqrtf(fmaf(t, t, 1.f));
        const float sn = cs * t;
        // each lane rotates the rows whose sums it took
        for (int r = sub; r < M; r += GL) {
          const float wp = W[r * N + p], wq = W[r * N + q];
          W[r * N + p] = fmaf(cs, wp, -(sn * wq));
          W[r * N + q] = fmaf(sn, wp, cs * wq);
        }
        for (int r = sub; r < N; r += GL) {
          const float vp = V[r * N + p], vq = V[r * N + q];
          V[r * N + p] = fmaf(cs, vp, -(sn * vq));
          V[r * N + q] = fmaf(sn, vp, cs * vq);
        }
      }
      __syncwarp();
    }
    if (gpg_warp_max(rotated ? 1.f : 0.f) == 0.f) break;
  }
  for (int j = lane; j < N; j += 32) {
    float s = 0.f;
    for (int r = 0; r < M; ++r) s = fmaf(W[r * N + j], W[r * N + j], s);
    sig[j] = sqrtf(s);
  }
  __syncwarp();
  for (int j = lane; j < N; j += 32) {
    const float sj = sig[j];
    int rank = 0;
    for (int i = 0; i < N; ++i)
      rank += gpg_sort_before(sig[i], i, sj, j, true, N) ? 1 : 0;
    const float inv = sj > 0.f ? 1.f / sj : 0.f;
    const float* F = FIX_V ? V : W;
    const int rows = FIX_V ? N : M;
    const float scale = FIX_V ? 1.f : inv;
    float big = -1.f, sg = 1.f;
    for (int r = 0; r < rows; ++r) {
      const float v = F[r * N + j] * scale;
      if (fabsf(v) > big) {
        big = fabsf(v);
        sg = v < 0.f ? -1.f : 1.f;
      }
    }
    for (int r = 0; r < M; ++r) out[r * N + rank] = sg * (W[r * N + j] * inv);
    out[M * N + rank] = sj;
    for (int r = 0; r < N; ++r)
      out[(M + 1 + r) * N + rank] = sg * V[r * N + j];
  }
  __syncwarp();
}

}  // namespace aehmc
