// Tropical matmul: C[i, j] = ADD over k of MUL(a[i, k], b[k, j]) on
// annihilator-filled float32 operands, for min_plus, max_plus, min_max and
// max_min.
//
// Replaces graphblas_tpu/ops/pallas_mxm.py:tropical_mxm_filled (its _kernel).
// Absence is encoded by value: the add's identity (+inf for min, -inf for
// max) annihilates the multiply, so no structure operand is needed.
//
// Bound on the card: the arithmetic.  One multiply (an f32 add, max or min)
// and one f32 min or max per (i, j, k) on the CUDA cores: 2 * M * N * K lane
// instructions over 132 SMs * 128 lanes * 1.98 GHz.  There is no
// tensor-core form for these semirings, and no FMA (the data sheet's
// 67 TFLOP/s counts an FMA as two).
//
// Design: a shared-memory tiled matmul.  A block of 256 threads computes a
// 64 x 64 output tile, each thread a 4 x 4 micro-tile held in registers;
// k advances in steps of 16, with a 64 x 16 tile of A (stored transposed)
// and a 16 x 64 tile of B staged in shared memory.  Any M, N, K: loads past
// the ragged edge read the fill value (which leaves the sum unchanged) and
// stores past it are dropped, so nothing is padded in device memory.  Each
// a + b rounds once (__fadd_rn) and min / max are exact and propagate NaN as
// jnp.minimum does, so the result is bit-exact whatever the order over k.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

// codes in the order of graphblas_tpu_torch/kernels/tropical.py ADDS / MULS
enum { ADD_MIN = 0, ADD_MAX };
enum { MUL_PLUS = 0, MUL_MAX, MUL_MIN };

constexpr int TM = 64, TN = 64, TK = 16, kThreads = 256, RM = 4, RN = 4;

template <int MUL>
__device__ __forceinline__ float mul(float a, float b) {
  if (MUL == MUL_PLUS) return __fadd_rn(a, b);
  if (MUL == MUL_MAX) return max_nan(a, b);
  return min_nan(a, b);
}

template <int ADD>
__device__ __forceinline__ float add(float a, float b) {
  return ADD == ADD_MIN ? min_nan(a, b) : max_nan(a, b);
}

template <int ADD, int MUL>
__global__ void __launch_bounds__(kThreads)
tropical_kernel(const float* __restrict__ A, const float* __restrict__ B, float* __restrict__ C, int M, int N,
                int K, float fill) {
  __shared__ float As[TK][TM];  // A's tile, transposed: As[k][i]
  __shared__ __align__(16) float Bs[TK][TN];
  const int tx = threadIdx.x % (TN / RN);  // 16 column groups
  const int ty = threadIdx.x / (TN / RN);  // 16 row groups
  const int row0 = blockIdx.y * TM, col0 = blockIdx.x * TN;
  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = fill;

  for (int k0 = 0; k0 < K; k0 += TK) {
    // A tile: consecutive threads read consecutive k of one row
#pragma unroll
    for (int e = threadIdx.x; e < TM * TK; e += kThreads) {
      const int i = e / TK, kk = e % TK;
      const int gi = row0 + i, gk = k0 + kk;
      As[kk][i] = (gi < M && gk < K) ? A[(int64_t)gi * K + gk] : fill;
    }
    // B tile: consecutive threads read consecutive columns of one k
#pragma unroll
    for (int e = threadIdx.x; e < TK * TN; e += kThreads) {
      const int kk = e / TN, j = e % TN;
      const int gk = k0 + kk, gj = col0 + j;
      Bs[kk][j] = (gk < K && gj < N) ? B[(int64_t)gk * N + gj] : fill;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      float a[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = As[kk][ty * RM + i];
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk][tx * RN]);
      const float b[RN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = add<ADD>(acc[i][j], mul<MUL>(a[i], b[j]));
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int gi = row0 + ty * RM + i;
    if (gi >= M) continue;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int gj = col0 + tx * RN + j;
      if (gj < N) C[(int64_t)gi * N + gj] = acc[i][j];
    }
  }
}

template <int ADD>
int dispatch_mul(int mul_code, const float* a, const float* b, float* c, int M, int N, int K, float fill,
                 cudaStream_t s) {
  const dim3 grid((unsigned)((N + TN - 1) / TN), (unsigned)((M + TM - 1) / TM));
  switch (mul_code) {
    case MUL_PLUS: tropical_kernel<ADD, MUL_PLUS><<<grid, kThreads, 0, s>>>(a, b, c, M, N, K, fill); break;
    case MUL_MAX: tropical_kernel<ADD, MUL_MAX><<<grid, kThreads, 0, s>>>(a, b, c, M, N, K, fill); break;
    case MUL_MIN: tropical_kernel<ADD, MUL_MIN><<<grid, kThreads, 0, s>>>(a, b, c, M, N, K, fill); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

// a: (M, K), b: (K, N), c: (M, N), all row-major float32; fill is the add's
// identity (+inf for min, -inf for max).
extern "C" int gb_tropical(const void* a, const void* b, void* c, int M, int N, int K, int add_code, int mul_code,
                           void* stream) {
  if (M < 0 || N < 0 || K < 0 || (M > 0 && (M + TM - 1) / TM > 65535)) return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const float* pa = (const float*)a;
  const float* pb = (const float*)b;
  float* pc = (float*)c;
  int rc;
  switch (add_code) {
    case ADD_MIN: rc = dispatch_mul<ADD_MIN>(mul_code, pa, pb, pc, M, N, K, INFINITY, s); break;
    case ADD_MAX: rc = dispatch_mul<ADD_MAX>(mul_code, pa, pb, pc, M, N, K, -INFINITY, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return rc != 0 ? rc : (int)cudaGetLastError();
}
