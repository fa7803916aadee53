// Rate probe of the f32 instructions the tropical matmul runs, and of the
// integer multiply-add of the integer matmul: each thread keeps 8
// independent chains and steps each `iters` times through one instruction
// (f32 add, min.NaN, max.NaN, plain min; int32 mad.lo.u32, int64
// mad.lo.u64), or a dependent pair (min_plus's add then min.NaN; min_max's
// max.NaN then min.NaN).
// Inline PTX keeps every instruction and its order; 8 chains and full
// occupancy hide each one's latency, so the time is the rate of the pipe
// that runs it.  Built and timed by probe_kernels.py; not part of the
// port's kernel library.

#include <cuda_runtime.h>

namespace {

enum { kAdd = 0, kMinNan, kMaxNan, kMin, kAddMinNan, kMaxMinNan, kMad32, kMad64 };

template <int OP>
__device__ __forceinline__ void step(float& x, float c) {
  if (OP == kAdd || OP == kAddMinNan) asm volatile("add.rn.f32 %0, %0, %1;" : "+f"(x) : "f"(c));
  if (OP == kMaxNan || OP == kMaxMinNan) asm volatile("max.NaN.f32 %0, %0, %1;" : "+f"(x) : "f"(c));
  if (OP == kMinNan || OP == kAddMinNan || OP == kMaxMinNan)
    asm volatile("min.NaN.f32 %0, %0, %1;" : "+f"(x) : "f"(c));
  if (OP == kMin) asm volatile("min.f32 %0, %0, %1;" : "+f"(x) : "f"(c));
}

template <int OP>
__global__ void chains(float* out, int iters, float c) {
  float x[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) x[k] = threadIdx.x * 1e-3f + k;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < 8; ++k) step<OP>(x[k], c);
  }
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) s += x[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// x = x * c + d in 32 or 64 bits (gb_imatmul's multiply-add)
template <typename T>
__device__ __forceinline__ void mad(T& x, T c, T d) {
  if constexpr (sizeof(T) == 4)
    asm volatile("mad.lo.u32 %0, %0, %1, %2;" : "+r"(x) : "r"(c), "r"(d));
  else
    asm volatile("mad.lo.u64 %0, %0, %1, %2;" : "+l"(x) : "l"(c), "l"(d));
}

template <typename T>
__global__ void int_chains(float* out, int iters, T c) {
  T x[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) x[k] = threadIdx.x + k;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < 8; ++k) mad<T>(x[k], c, (T)k);
  }
  T s = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) s += x[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = (float)(s & 0xFFFF);
}

}  // namespace

// op: 0 add, 1 min.NaN, 2 max.NaN, 3 min, 4 add + min.NaN, 5 max.NaN +
// min.NaN, 6 mad.lo.u32, 7 mad.lo.u64; out holds blocks * threads floats.
extern "C" int rate_probe(int op, float* out, int blocks, int threads, int iters, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float c = 0.25f;
  switch (op) {
    case kAdd: chains<kAdd><<<blocks, threads, 0, s>>>(out, iters, c); break;
    case kMinNan: chains<kMinNan><<<blocks, threads, 0, s>>>(out, iters, c); break;
    case kMaxNan: chains<kMaxNan><<<blocks, threads, 0, s>>>(out, iters, c); break;
    case kMin: chains<kMin><<<blocks, threads, 0, s>>>(out, iters, c); break;
    case kAddMinNan: chains<kAddMinNan><<<blocks, threads, 0, s>>>(out, iters, c); break;
    case kMaxMinNan: chains<kMaxMinNan><<<blocks, threads, 0, s>>>(out, iters, c); break;
    case kMad32: int_chains<unsigned><<<blocks, threads, 0, s>>>(out, iters, 2654435761u); break;
    case kMad64: int_chains<unsigned long long><<<blocks, threads, 0, s>>>(out, iters, 0x9E3779B97F4A7C15ull); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
