// Tropical matmul: C[i, j] = ADD over k of MUL(a[i, k], b[k, j]) on
// annihilator-filled float32 operands, for min_plus, max_plus, min_max and
// max_min.
//
// Replaces graphblas_tpu/ops/pallas_mxm.py:tropical_mxm_filled (its _kernel).
// Absence is encoded by value: the add's identity (+inf for min, -inf for
// max) annihilates the multiply, so no structure operand is needed.
//
// Bound on the card: the instruction rate.  One multiply (an f32 add, max
// or min) and one f32 min or max per (i, j, k) on the CUDA cores; there is
// no tensor-core form for these semirings, and no FMA.  An SM dispatches 128
// lane instructions a clock, so two instructions per (i, j, k) allow 64 of
// them a clock; an f32 add runs on the 128-lane FMA pipe but min and max
// (FMNMX) on the 64-lane ALU pipe, so min_plus and max_plus stay at 64 a
// clock and min_max and max_min, two FMNMX each, fall to 32
// (graphblas_tpu_torch/tools/probe_kernels.py measures both rates).
//
// Design (the SIMT GEMM pattern): a block of 256 threads computes a 128 x
// 128 output tile, each thread an 8 x 8 micro-tile of accumulators in
// registers, at rows ty * 4 + {0..3} and 64 + ty * 4 + {0..3} and the same
// columns of tx, so per k two 16-byte shared loads of A and two of B feed 64
// (i, j) pairs.  k advances in steps of 8 through two shared stages: while
// the block computes one, B's next 8 x 128 tile arrives in the other by
// 16-byte cp.async and A's next 128 x 8 tile by 16-byte global loads (a
// thread's 4 consecutive k of one row) into registers, stored transposed
// after the compute; one barrier per step.  A ragged or unaligned tile of B
// arrives by 4-byte cp.async an element, so its loads overlap the compute
// too without holding registers.  A's transposed rows are padded
// to 132 floats, so the 32 lanes of a warp (16 rows, 2 groups of 4 k) store
// to 32 distinct banks.  2048^2 outputs are 256 blocks; two fit an SM, so
// the grid is one wave on 132 SMs.
//
// That grid runs in whole waves of 2 blocks an SM, so a grid of few output
// tiles (1024^2 outputs are 64), or one just past a wave (a 2047 x 2049
// output is 272 tiles: two waves), leaves SMs idle; there the first port's
// 64 x 64 kernel, 4 blocks an SM, is faster, and the host picks the form by
// the waves each needs (kernels/tropical.py:tile_for; measured on an NVIDIA
// H100 80GB HBM3 at 700 W: 2048^3 min_plus 0.739 ms on 128 x 128 tiles,
// 1.182-1.191 on 64 x 64; 1024^3 0.197 against 0.175).
//
// Any M, N, K: a tile that reaches past M, N or K, or operands whose rows
// are not 16-byte aligned, takes scalar loads that read the fill value
// past the edge (which leaves the result unchanged), and stores past the
// edge are dropped; nothing is padded in device memory.  Each a + b rounds
// once (__fadd_rn) and min / max are exact and propagate NaN as
// jnp.minimum does, so the result is bit-exact whatever the order over k.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

// codes in the order of graphblas_tpu_torch/kernels/tropical.py ADDS / MULS
enum { ADD_MIN = 0, ADD_MAX };
enum { MUL_PLUS = 0, MUL_MAX, MUL_MIN };

constexpr int BM = 128, BN = 128, BK = 8, kThreads = 256;
constexpr int APAD = BM + 4;  // A's transposed row, padded against bank conflicts

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

// global -> shared without registers: 16 bytes (through L2 only) or 4
template <int BYTES>
__device__ __forceinline__ void cp_async_n(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
}

template <int ADD, int MUL>
__global__ void __launch_bounds__(kThreads, 2)
    tile128_kernel(const float* __restrict__ A, const float* __restrict__ B, float* __restrict__ C, int M, int N,
                    int K, float fill, int a_vec, int b_vec) {
  __shared__ __align__(16) float As[2][BK][APAD];  // A's tile, transposed: As[s][k][i]
  __shared__ __align__(16) float Bs[2][BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  // what this thread copies: A's row a_row, k a_k .. a_k + 3; B's row b_k,
  // columns b_col .. b_col + 3
  const int a_row = tid / 2, a_k = (tid % 2) * 4;
  const int b_k = tid / 32, b_col = (tid % 32) * 4;
  const bool rows_in = row0 + BM <= M, cols_in = col0 + BN <= N;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = fill;

  float4 a_next;
  auto load_a = [&](int k0) {
    const int gi = row0 + a_row, gk = k0 + a_k;
    if (a_vec && rows_in && k0 + BK <= K) {
      a_next = *reinterpret_cast<const float4*>(A + (int64_t)gi * K + gk);
    } else {
      float v[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) v[c] = (gi < M && gk + c < K) ? A[(int64_t)gi * K + gk + c] : fill;
      a_next = make_float4(v[0], v[1], v[2], v[3]);
    }
  };
  auto store_a = [&](int s) {
    As[s][a_k + 0][a_row] = a_next.x;
    As[s][a_k + 1][a_row] = a_next.y;
    As[s][a_k + 2][a_row] = a_next.z;
    As[s][a_k + 3][a_row] = a_next.w;
  };
  // B: straight into the stage by cp.async, 16 bytes, or (a ragged or
  // unaligned tile) 4 bytes an element in range and the fill past the edge
  auto load_b = [&](int s, int k0) {
    const int gk = k0 + b_k, gj = col0 + b_col;
    float* dst = &Bs[s][b_k][b_col];
    if (b_vec && cols_in && k0 + BK <= K) {
      cp_async_n<16>(dst, B + (int64_t)gk * N + gj);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (gk < K && gj + c < N) cp_async_n<4>(dst + c, B + (int64_t)gk * N + gj + c);
        else dst[c] = fill;
      }
    }
  };

  const int nk = (K + BK - 1) / BK;
  if (nk > 0) {
    load_a(0);
    load_b(0, 0);
    asm volatile("cp.async.commit_group;" ::: "memory");
    store_a(0);
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) {
      load_a((kt + 1) * BK);
      load_b(cur ^ 1, (kt + 1) * BK);
      asm volatile("cp.async.commit_group;" ::: "memory");
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[cur][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[cur][kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = add<ADD>(acc[i][j], mul<MUL>(a[i], b[j]));
    }
    if (more) {
      store_a(cur ^ 1);
      asm volatile("cp.async.wait_all;" ::: "memory");
    }
    __syncthreads();  // the next stage is in; this one is free
  }

  // C is a fresh allocation, so its rows are 16-byte aligned when N % 4 == 0
  const bool vec_out = rows_in && cols_in && (N % 4) == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gi = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gj = col0 + h * 64 + tx * 4;
      float* dst = C + (int64_t)gi * N + gj;
      if (vec_out) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[i][h * 4 + 0], acc[i][h * 4 + 1], acc[i][h * 4 + 2], acc[i][h * 4 + 3]);
      } else if (gi < M) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (gj + c < N) dst[c] = acc[i][h * 4 + c];
      }
    }
  }
}

// The 64 x 64 form (the first port's kernel, kept where it is faster: grids
// of few output tiles, or just past a whole wave of 128 x 128 tiles; the
// host picks, kernels/tropical.py:tile_for): 256 threads of 4 x 4
// accumulators, k in steps of 16 through one shared stage, A's tile stored
// transposed element by element, every load bounds-checked.  64 registers,
// so 4 blocks an SM.
constexpr int T64 = 64, TK64 = 16, R64 = 4;

template <int ADD, int MUL>
__global__ void __launch_bounds__(kThreads)
    tile64_kernel(const float* __restrict__ A, const float* __restrict__ B, float* __restrict__ C, int M, int N,
                  int K, float fill) {
  __shared__ float As[TK64][T64];  // A's tile, transposed: As[k][i]
  __shared__ __align__(16) float Bs[TK64][T64];
  const int tx = threadIdx.x % (T64 / R64);  // 16 column groups
  const int ty = threadIdx.x / (T64 / R64);  // 16 row groups
  const int row0 = blockIdx.y * T64, col0 = blockIdx.x * T64;
  float acc[R64][R64];
#pragma unroll
  for (int i = 0; i < R64; ++i)
#pragma unroll
    for (int j = 0; j < R64; ++j) acc[i][j] = fill;

  for (int k0 = 0; k0 < K; k0 += TK64) {
#pragma unroll
    for (int e = threadIdx.x; e < T64 * TK64; e += kThreads) {
      const int i = e / TK64, kk = e % TK64;
      const int gi = row0 + i, gk = k0 + kk;
      As[kk][i] = (gi < M && gk < K) ? A[(int64_t)gi * K + gk] : fill;
    }
#pragma unroll
    for (int e = threadIdx.x; e < TK64 * T64; e += kThreads) {
      const int kk = e / T64, j = e % T64;
      const int gk = k0 + kk, gj = col0 + j;
      Bs[kk][j] = (gk < K && gj < N) ? B[(int64_t)gk * N + gj] : fill;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK64; ++kk) {
      float a[R64];
#pragma unroll
      for (int i = 0; i < R64; ++i) a[i] = As[kk][ty * R64 + i];
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk][tx * R64]);
      const float b[R64] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < R64; ++i)
#pragma unroll
        for (int j = 0; j < R64; ++j) acc[i][j] = add<ADD>(acc[i][j], mul<MUL>(a[i], b[j]));
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < R64; ++i) {
    const int gi = row0 + ty * R64 + i;
    if (gi >= M) continue;
#pragma unroll
    for (int j = 0; j < R64; ++j) {
      const int gj = col0 + tx * R64 + j;
      if (gj < N) C[(int64_t)gi * N + gj] = acc[i][j];
    }
  }
}

template <int ADD, int MUL>
void launch(int tile, const float* a, const float* b, float* c, int M, int N, int K, float fill, cudaStream_t s) {
  const dim3 grid((unsigned)((N + tile - 1) / tile), (unsigned)((M + tile - 1) / tile));
  if (tile == T64) {
    tile64_kernel<ADD, MUL><<<grid, kThreads, 0, s>>>(a, b, c, M, N, K, fill);
    return;
  }
  // 16-byte loads need 16-byte aligned operands and rows of a multiple of 4 floats
  const int a_vec = ((uintptr_t)a % 16 == 0) && K % 4 == 0;
  const int b_vec = ((uintptr_t)b % 16 == 0) && N % 4 == 0;
  tile128_kernel<ADD, MUL><<<grid, kThreads, 0, s>>>(a, b, c, M, N, K, fill, a_vec, b_vec);
}

template <int ADD>
int dispatch_mul(int mul_code, int tile, const float* a, const float* b, float* c, int M, int N, int K, float fill,
                 cudaStream_t s) {
  switch (mul_code) {
    case MUL_PLUS: launch<ADD, MUL_PLUS>(tile, a, b, c, M, N, K, fill, s); break;
    case MUL_MAX: launch<ADD, MUL_MAX>(tile, a, b, c, M, N, K, fill, s); break;
    case MUL_MIN: launch<ADD, MUL_MIN>(tile, a, b, c, M, N, K, fill, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

// a: (M, K), b: (K, N), c: (M, N), all row-major float32; fill is the add's
// identity (+inf for min, -inf for max).  tile: the block tile, 128 or 64.
extern "C" int gb_tropical(const void* a, const void* b, void* c, int M, int N, int K, int add_code, int mul_code,
                           int tile, void* stream) {
  if (M < 0 || N < 0 || K < 0 || (tile != BM && tile != T64) || (M > 0 && (M + tile - 1) / tile > 65535))
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const float* pa = (const float*)a;
  const float* pb = (const float*)b;
  float* pc = (float*)c;
  int rc;
  switch (add_code) {
    case ADD_MIN: rc = dispatch_mul<ADD_MIN>(mul_code, tile, pa, pb, pc, M, N, K, INFINITY, s); break;
    case ADD_MAX: rc = dispatch_mul<ADD_MAX>(mul_code, tile, pa, pb, pc, M, N, K, -INFINITY, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return rc != 0 ? rc : (int)cudaGetLastError();
}
