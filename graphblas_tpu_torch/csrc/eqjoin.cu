// eqjoin: the masked-SpGEMM dot-method inner loop, and the compare-rate probe
// that places it on a roofline.
//
// eqjoin replaces graphblas_tpu/ops/pallas_eqjoin.py:eqjoin (its _kernel).
// Task t intersects a row chunk of A (keys ak[k, t], k < Wa) with a column
// chunk of B (keys bk[l, t], l < Wb) under a semiring:
//   out[t] = ADD over (k, l) with ak[k, t] == bk[l, t] of MUL(av[k, t], bv[l, t])
//   nm[t]  = the number of such (k, l),
// and out[t] = 0 where nm[t] = 0.  Pad keys are -1 (A) and -2 (B), so pads
// never match.  The arrays are (W, T): tasks on the fast axis, as the TPU
// kernel lays them on lanes.
//
// Bound on the card: the key compares.  Each of the Wa * Wb compares of a
// task is one int32 instruction (64 a cycle per SM), so Wa * Wb * T over
// 132 * 64 * 1.98 GHz; the bytes ((Wa + Wb) * T keys and values, read once)
// are far less at these widths.
//
// Design: one thread per task, so the threads of a warp read neighbouring
// tasks and a (k, .) row of the (W, T) layout is one coalesced load.  A
// thread holds KB keys of A (and their values and KB accumulators) in
// registers and streams B's keys past them, so one load of B feeds KB
// compares; B's column chunk of the block is re-read Wa / KB times from L1 or
// L2.  The order of the arithmetic is the TPU kernel's: per k an accumulator
// over l in order, then a combine over k in order.  Float products and sums
// round once each (__fmul_rn, __fadd_rn: no FMA contraction); min and max
// propagate NaN as jnp.minimum / jnp.maximum do.  The all-pairs compare
// stays; a merge intersection (Wa + Wb compares a task) is later work.
//
// compare_probe replaces graphblas_tpu/tools/profile_spgemm_roofline.py:
// vpu_kernel: K = 64 fused compare-adds per element, acc += (a == b + i), on
// f32 arrays: a measured ceiling of the card's compare rate on this kind of
// work.  Bound: 3 f32 instructions per compare-add (add, compare, add) on
// the f32 pipe, or the 12 bytes an element moves, whichever is larger.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

// codes in the order of graphblas_tpu_torch/kernels/eqjoin.py ADDS and MULS;
// "any" runs as "max" (the TPU kernel's any)
enum { ADD_PLUS = 0, ADD_MIN, ADD_MAX, ADD_ANY, ADD_LOR, ADD_LAND, ADD_TIMES };
enum { MUL_PAIR = 0, MUL_TIMES, MUL_PLUS, MUL_FIRST, MUL_SECOND };

constexpr int kThreads = 128;

template <int ADD>
__device__ __forceinline__ float ident() {
  if (ADD == ADD_MIN) return INFINITY;
  if (ADD == ADD_MAX) return -INFINITY;
  if (ADD == ADD_TIMES || ADD == ADD_LAND) return 1.f;
  return 0.f;  // plus, lor
}

template <int MUL>
__device__ __forceinline__ float product(float a, float b) {
  if (MUL == MUL_PAIR) return 1.f;
  if (MUL == MUL_TIMES) return __fmul_rn(a, b);
  if (MUL == MUL_PLUS) return __fadd_rn(a, b);
  if (MUL == MUL_FIRST) return a;
  return b;  // second
}

// one (k, l) step of the per-k accumulator (pallas_eqjoin.py:91-102)
template <int ADD>
__device__ __forceinline__ float step(float acc, bool eq, float prod) {
  if (ADD == ADD_PLUS) return __fadd_rn(acc, eq ? prod : 0.f);
  if (ADD == ADD_MIN) return eq ? min_nan(acc, prod) : acc;
  if (ADD == ADD_MAX) return eq ? max_nan(acc, prod) : acc;
  if (ADD == ADD_TIMES) return eq ? __fmul_rn(acc, prod) : acc;
  if (ADD == ADD_LOR) return (eq && prod != 0.f) ? 1.f : acc;
  return eq ? __fmul_rn(acc, prod != 0.f ? 1.f : 0.f) : acc;  // land
}

// the combine over k (pallas_eqjoin.py:110-120).  A k without a match kept
// its accumulator at the identity, which the combine leaves unchanged, so
// the TPU kernel's per-k hit mask needs no counterpart here.
template <int ADD>
__device__ __forceinline__ float combine(float total, float acc) {
  if (ADD == ADD_PLUS) return __fadd_rn(total, acc);
  if (ADD == ADD_MIN) return min_nan(total, acc);
  if (ADD == ADD_MAX) return max_nan(total, acc);
  if (ADD == ADD_LOR) return fmaxf(total, acc);  // 0/1 values
  return __fmul_rn(total, acc);                  // times, land
}

template <int ADD, int MUL, int KB>
__global__ void __launch_bounds__(kThreads)
eqjoin_kernel(const int32_t* __restrict__ ak, const float* __restrict__ av, const int32_t* __restrict__ bk,
              const float* __restrict__ bv, float* __restrict__ out, int32_t* __restrict__ nm_out, int Wa,
              int Wb, int64_t T) {
  constexpr bool kUseAv = MUL == MUL_TIMES || MUL == MUL_PLUS || MUL == MUL_FIRST;
  constexpr bool kUseBv = MUL == MUL_TIMES || MUL == MUL_PLUS || MUL == MUL_SECOND;
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= T) return;
  float total = ident<ADD>();
  int nm = 0;
  for (int k0 = 0; k0 < Wa; k0 += KB) {
    int32_t a[KB];
    float va[KB], acc[KB];
#pragma unroll
    for (int i = 0; i < KB; ++i) {
      a[i] = __ldg(ak + (int64_t)(k0 + i) * T + t);
      va[i] = kUseAv ? __ldg(av + (int64_t)(k0 + i) * T + t) : 0.f;
      acc[i] = ident<ADD>();
    }
    for (int l = 0; l < Wb; ++l) {
      const int32_t b = __ldg(bk + (int64_t)l * T + t);
      const float vb = kUseBv ? __ldg(bv + (int64_t)l * T + t) : 0.f;
#pragma unroll
      for (int i = 0; i < KB; ++i) {
        const bool eq = a[i] == b;
        nm += eq;
        acc[i] = step<ADD>(acc[i], eq, product<MUL>(va[i], vb));
      }
    }
#pragma unroll
    for (int i = 0; i < KB; ++i) total = combine<ADD>(total, acc[i]);
  }
  out[t] = nm > 0 ? total : 0.f;
  nm_out[t] = nm;
}

template <int ADD, int MUL>
void launch_eqjoin(const void* ak, const void* av, const void* bk, const void* bv, void* out, void* nm, int Wa,
                   int Wb, int64_t T, cudaStream_t s) {
  const unsigned grid = (unsigned)((T + kThreads - 1) / kThreads);
  if (Wa % 16 == 0) {
    eqjoin_kernel<ADD, MUL, 16><<<grid, kThreads, 0, s>>>((const int32_t*)ak, (const float*)av,
                                                          (const int32_t*)bk, (const float*)bv, (float*)out,
                                                          (int32_t*)nm, Wa, Wb, T);
  } else {
    eqjoin_kernel<ADD, MUL, 4><<<grid, kThreads, 0, s>>>((const int32_t*)ak, (const float*)av,
                                                         (const int32_t*)bk, (const float*)bv, (float*)out,
                                                         (int32_t*)nm, Wa, Wb, T);
  }
}

template <int ADD>
int dispatch_mul(int mul, const void* ak, const void* av, const void* bk, const void* bv, void* out, void* nm,
                 int Wa, int Wb, int64_t T, cudaStream_t s) {
  switch (mul) {
    case MUL_PAIR: launch_eqjoin<ADD, MUL_PAIR>(ak, av, bk, bv, out, nm, Wa, Wb, T, s); break;
    case MUL_TIMES: launch_eqjoin<ADD, MUL_TIMES>(ak, av, bk, bv, out, nm, Wa, Wb, T, s); break;
    case MUL_PLUS: launch_eqjoin<ADD, MUL_PLUS>(ak, av, bk, bv, out, nm, Wa, Wb, T, s); break;
    case MUL_FIRST: launch_eqjoin<ADD, MUL_FIRST>(ak, av, bk, bv, out, nm, Wa, Wb, T, s); break;
    case MUL_SECOND: launch_eqjoin<ADD, MUL_SECOND>(ak, av, bk, bv, out, nm, Wa, Wb, T, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

constexpr int kProbeK = 64;

__global__ void compare_probe_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                     float* __restrict__ out, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; p < n; p += stride) {
    const float x = a[p], y = b[p];
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < kProbeK; ++i) acc = __fadd_rn(acc, x == __fadd_rn(y, (float)i) ? 1.f : 0.f);
    out[p] = acc;
  }
}

}  // namespace

// Wa must be a multiple of 4 (the analysis gives 4, 16, 64 or 256); av / bv
// may be null when the multiply ignores them.
extern "C" int gb_eqjoin(const void* ak, const void* av, const void* bk, const void* bv, void* out, void* nm,
                         int Wa, int Wb, int64_t T, int add, int mul, void* stream) {
  if (Wa % 4 != 0 || Wb < 1 || T < 0) return (int)cudaErrorInvalidValue;
  if (T == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  int rc;
  switch (add) {
    case ADD_PLUS: rc = dispatch_mul<ADD_PLUS>(mul, ak, av, bk, bv, out, nm, Wa, Wb, T, s); break;
    case ADD_MIN: rc = dispatch_mul<ADD_MIN>(mul, ak, av, bk, bv, out, nm, Wa, Wb, T, s); break;
    case ADD_MAX:
    case ADD_ANY: rc = dispatch_mul<ADD_MAX>(mul, ak, av, bk, bv, out, nm, Wa, Wb, T, s); break;
    case ADD_LOR: rc = dispatch_mul<ADD_LOR>(mul, ak, av, bk, bv, out, nm, Wa, Wb, T, s); break;
    case ADD_LAND: rc = dispatch_mul<ADD_LAND>(mul, ak, av, bk, bv, out, nm, Wa, Wb, T, s); break;
    case ADD_TIMES: rc = dispatch_mul<ADD_TIMES>(mul, ak, av, bk, bv, out, nm, Wa, Wb, T, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return rc != 0 ? rc : (int)cudaGetLastError();
}

extern "C" int gb_compare_probe(const void* a, const void* b, void* out, int64_t n, void* stream) {
  if (n > 0) {
    const int threads = 256;
    int64_t blocks = (n + threads - 1) / threads;
    if (blocks > (1 << 20)) blocks = 1 << 20;
    compare_probe_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>((const float*)a, (const float*)b,
                                                                                  (float*)out, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int gb_compare_probe_k() { return kProbeK; }
