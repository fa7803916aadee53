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
// are far less at these widths.  In practice a compare costs about four
// instructions (the compare, the select or min, the accumulate, the count).
//
// Design: the host picks one of two layouts per bucket from (Wa, Wb, T)
// alone (kernels/eqjoin.py:lanes_per_task); either is one launch.
// - One thread a task, for buckets with many tasks or little work a task
//   (the (64, 4) bucket of 1.3 M tasks).  The threads of a warp read
//   neighbouring tasks, so a (k, .) row of the (W, T) layout is one
//   coalesced load.  A thread holds KB keys of A (and their values and KB
//   accumulators) in registers and streams B's keys past them, so one load
//   of B feeds KB compares.
// - g lanes a task (g = 2 .. 32, a power of two, at most Wa, Wa / g <= 8),
//   where T threads would leave the card idle: a (256, 256) bucket of 512
//   tasks ran on 4 of 132 SMs at 0.41 ms.  Lane j owns A's keys k in
//   [j * Wa / g, (j + 1) * Wa / g) with their accumulators in registers; the
//   block stages B's keys (and values) for its tasks in shared memory by
//   cp.async, in the (l, task) order of the global arrays, and every lane of
//   a task reads B's key l by broadcast.  The combine over k passes the
//   running total from lane to lane by shuffles (Wa combine steps against
//   Wa * Wb / g compares a lane), or, where any order gives the same bits
//   (min, max, lor, land; counts of pair products), runs as a butterfly;
//   the match counts sum by shuffles in any order (integers).
// The host's choice weighs the two by a cost model fitted to a sweep of
// every bucket in every layout on the card (kernels/eqjoin.py).
// Both keep the order of the arithmetic of the TPU kernel: per k an
// accumulator over l in order, then a combine over k in order, so the two
// layouts agree bit for bit.  Float products and sums round once each
// (__fmul_rn, __fadd_rn: no FMA contraction); min and max propagate NaN as
// jnp.minimum / jnp.maximum do.  The all-pairs compare stays (it holds for
// any keys); a merge intersection needs sorted, duplicate-free chunks.
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

// ---- g lanes a task ---------------------------------------------------------

constexpr int kLaneThreads = 128;  // a block: 128 / g tasks
constexpr int kStageB = 2048;      // (l, task) slots of B a block stages at a time

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"((uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// Whether the combine over k gives the same bits in any order: min, max
// (NaN-propagating, -0.0 below +0.0), lor and land (0/1 values) always;
// plus and times of pair products too, whose accumulators are match counts
// (exact in float while Wa * Wb < 2^24) or ones.
template <int ADD, int MUL>
__device__ __forceinline__ bool any_order(int Wa, int Wb) {
  if (ADD == ADD_MIN || ADD == ADD_MAX || ADD == ADD_LOR || ADD == ADD_LAND) return true;
  return MUL == MUL_PAIR && (int64_t)Wa * Wb < (1 << 24);
}

// KPL = Wa / g keys of A a lane; lg = log2(g).
template <int ADD, int MUL, int KPL>
__global__ void __launch_bounds__(kLaneThreads)
eqjoin_lanes(const int32_t* __restrict__ ak, const float* __restrict__ av, const int32_t* __restrict__ bk,
             const float* __restrict__ bv, float* __restrict__ out, int32_t* __restrict__ nm_out, int Wb,
             int64_t T, int lg) {
  constexpr bool kUseAv = MUL == MUL_TIMES || MUL == MUL_PLUS || MUL == MUL_FIRST;
  constexpr bool kUseBv = MUL == MUL_TIMES || MUL == MUL_PLUS || MUL == MUL_SECOND;
  __shared__ int32_t s_bk[kStageB];
  __shared__ float s_bv[kUseBv ? kStageB : 1];
  const int g = 1 << lg;
  const int ltb = 7 - lg;                // log2 of the block's tasks (kLaneThreads = 2^7)
  const int j = threadIdx.x & (g - 1);  // the lane within its task
  const int tl = threadIdx.x >> lg;     // the task within the block
  const int64_t t0 = (int64_t)blockIdx.x << ltb;
  const int64_t t = t0 + tl;
  const bool live = t < T;
  int32_t a[KPL];
  float va[KPL], acc[KPL];
#pragma unroll
  for (int i = 0; i < KPL; ++i) {
    const int64_t k = j * KPL + i;
    a[i] = live ? __ldg(ak + k * T + t) : -1;
    va[i] = kUseAv && live ? __ldg(av + k * T + t) : 0.f;
    acc[i] = ident<ADD>();
  }
  int nm = 0;
  const int rows = kStageB >> ltb;  // B's keys a stage holds for each task
  for (int l0 = 0; l0 < Wb; l0 += rows) {
    const int nl = min(rows, Wb - l0);
    if (l0 > 0) __syncthreads();  // every lane is done with the last stage
    for (int e = threadIdx.x; e < (nl << ltb); e += kLaneThreads) {
      const int l = e >> ltb;
      const int64_t tt = t0 + (e & ((1 << ltb) - 1));
      if (tt < T) {
        const int64_t src = (int64_t)(l0 + l) * T + tt;
        cp_async4(&s_bk[e], bk + src);
        if (kUseBv) cp_async4(&s_bv[e], bv + src);
      } else {
        s_bk[e] = -2;
        if (kUseBv) s_bv[e] = 0.f;
      }
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
#pragma unroll 4
    for (int l = 0; l < nl; ++l) {
      const int32_t b = s_bk[(l << ltb) + tl];
      const float vb = kUseBv ? s_bv[(l << ltb) + tl] : 0.f;
#pragma unroll
      for (int i = 0; i < KPL; ++i) {
        const bool eq = a[i] == b;
        nm += eq;
        acc[i] = step<ADD>(acc[i], eq, product<MUL>(va[i], vb));
      }
    }
  }
  float total = ident<ADD>();
  if (any_order<ADD, MUL>(KPL << lg, Wb)) {
    // a combine that is exact in any order: each lane's keys, then a
    // butterfly over the task's lanes
#pragma unroll
    for (int i = 0; i < KPL; ++i) total = combine<ADD>(total, acc[i]);
    for (int off = g >> 1; off > 0; off >>= 1) total = combine<ADD>(total, __shfl_xor_sync(0xffffffffu, total, off));
  } else {
    // the combine over k in order: lane 0's keys, then lane 1's, ...; each
    // step hands the running total on to the whole group
    const int base = (threadIdx.x & 31) & ~(g - 1);  // the task's first lane in the warp
    for (int src = 0; src < g; ++src) {
      if (j == src) {
#pragma unroll
        for (int i = 0; i < KPL; ++i) total = combine<ADD>(total, acc[i]);
      }
      total = __shfl_sync(0xffffffffu, total, base + src);
    }
  }
  for (int off = g >> 1; off > 0; off >>= 1) nm += __shfl_xor_sync(0xffffffffu, nm, off);
  if (j == 0 && live) {
    out[t] = nm > 0 ? total : 0.f;
    nm_out[t] = nm;
  }
}

template <int ADD, int MUL, int KPL>
void launch_lanes(const void* ak, const void* av, const void* bk, const void* bv, void* out, void* nm, int Wb,
                  int64_t T, int lg, cudaStream_t s) {
  const unsigned grid = (unsigned)(((T << lg) + kLaneThreads - 1) / kLaneThreads);
  eqjoin_lanes<ADD, MUL, KPL><<<grid, kLaneThreads, 0, s>>>((const int32_t*)ak, (const float*)av,
                                                            (const int32_t*)bk, (const float*)bv, (float*)out,
                                                            (int32_t*)nm, Wb, T, lg);
}

// ---- the host side -----------------------------------------------------------

template <int ADD, int MUL>
void launch_eqjoin(const void* ak, const void* av, const void* bk, const void* bv, void* out, void* nm, int Wa,
                   int Wb, int64_t T, int lanes, cudaStream_t s) {
  if (lanes > 1) {
    const int lg = __builtin_ctz(lanes);
    switch (Wa / lanes) {
      case 1: launch_lanes<ADD, MUL, 1>(ak, av, bk, bv, out, nm, Wb, T, lg, s); break;
      case 2: launch_lanes<ADD, MUL, 2>(ak, av, bk, bv, out, nm, Wb, T, lg, s); break;
      case 4: launch_lanes<ADD, MUL, 4>(ak, av, bk, bv, out, nm, Wb, T, lg, s); break;
      default: launch_lanes<ADD, MUL, 8>(ak, av, bk, bv, out, nm, Wb, T, lg, s); break;
    }
    return;
  }
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
                 int Wa, int Wb, int64_t T, int lanes, cudaStream_t s) {
  switch (mul) {
    case MUL_PAIR: launch_eqjoin<ADD, MUL_PAIR>(ak, av, bk, bv, out, nm, Wa, Wb, T, lanes, s); break;
    case MUL_TIMES: launch_eqjoin<ADD, MUL_TIMES>(ak, av, bk, bv, out, nm, Wa, Wb, T, lanes, s); break;
    case MUL_PLUS: launch_eqjoin<ADD, MUL_PLUS>(ak, av, bk, bv, out, nm, Wa, Wb, T, lanes, s); break;
    case MUL_FIRST: launch_eqjoin<ADD, MUL_FIRST>(ak, av, bk, bv, out, nm, Wa, Wb, T, lanes, s); break;
    case MUL_SECOND: launch_eqjoin<ADD, MUL_SECOND>(ak, av, bk, bv, out, nm, Wa, Wb, T, lanes, s); break;
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
// may be null when the multiply ignores them.  lanes: 1 = one thread a
// task; else g lanes a task, a power of two up to 32 with Wa / g in
// {1, 2, 4, 8}.
extern "C" int gb_eqjoin(const void* ak, const void* av, const void* bk, const void* bv, void* out, void* nm,
                         int Wa, int Wb, int64_t T, int add, int mul, int lanes, void* stream) {
  if (Wa % 4 != 0 || Wb < 1 || T < 0) return (int)cudaErrorInvalidValue;
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0) return (int)cudaErrorInvalidValue;
  const int kpl = Wa / lanes;
  if (lanes > 1 && (Wa % lanes != 0 || kpl > 8 || (kpl & (kpl - 1)) != 0)) return (int)cudaErrorInvalidValue;
  if (T == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  int rc;
  switch (add) {
    case ADD_PLUS: rc = dispatch_mul<ADD_PLUS>(mul, ak, av, bk, bv, out, nm, Wa, Wb, T, lanes, s); break;
    case ADD_MIN: rc = dispatch_mul<ADD_MIN>(mul, ak, av, bk, bv, out, nm, Wa, Wb, T, lanes, s); break;
    case ADD_MAX:
    case ADD_ANY: rc = dispatch_mul<ADD_MAX>(mul, ak, av, bk, bv, out, nm, Wa, Wb, T, lanes, s); break;
    case ADD_LOR: rc = dispatch_mul<ADD_LOR>(mul, ak, av, bk, bv, out, nm, Wa, Wb, T, lanes, s); break;
    case ADD_LAND: rc = dispatch_mul<ADD_LAND>(mul, ak, av, bk, bv, out, nm, Wa, Wb, T, lanes, s); break;
    case ADD_TIMES: rc = dispatch_mul<ADD_TIMES>(mul, ak, av, bk, bv, out, nm, Wa, Wb, T, lanes, s); break;
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
