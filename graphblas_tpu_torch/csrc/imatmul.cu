// Integer matmul: C = A @ B on row-major int32 or int64 operands, in that
// type.  Products and sums wrap (two's complement), as XLA's do, so the
// result is bit-exact whatever the order over k.
//
// The JAX package leaves this product to XLA: jnp.matmul with an integer
// preferred_element_type (graphblas_tpu/ops/densemasked.py:565, the dense
// engine's plus_times, plus_first and plus_second over integer types).  It
// replaces no Pallas kernel.  On the card torch.matmul raises on integer
// tensors and torch._int_mm takes int8 operands only, so integer values have
// no PyTorch GEMM there; the generic contraction that took them before ran
// 195-309 ms and about 6 GiB at 2048^2 (PERF.md section 6).
//
// Bound on the card: the instruction rate.  int32: one IMAD per (i, j, k),
// on the 64-lane integer pipe: 132 SMs x 64 lanes x 1.98 GHz = 16.7 x 10^12
// a second, 0.514 ms at 2048^3 (graphblas_tpu_torch/tools/probe_kernels.py
// measures the IMAD rate).  int64 has no 64-bit multiply-add instruction: the
// low words' product and the 64-bit sum are one IMAD.WIDE.U32 and the two
// cross products into the high word two more IMADs, so three integer
// instructions per (i, j, k) at the least, 1.54 ms at 2048^3 (probe_kernels.py
// counts the SASS: 3.2 IMADs and 1.3 IADD3s per (i, j, k) in the int64 form;
// 1.05 IMADs in the int32 128 x 128 one).  No tensor-core form: the tensor
// cores multiply int8 into int32 only.
//
// Design: the SIMT tile of csrc/tropical.cu with an integer multiply-add.  A
// block of 256 threads computes a BM x BM output tile, each thread a TM x TM
// micro-tile of accumulators in registers, in groups of 4 rows (columns) at
// ty * 4 (tx * 4) + g * 64, so a group is one 16-byte shared load for int32
// (two for int64).  k advances in steps of BK through two shared stages,
// with BK chosen so that each thread moves 16 bytes of A and 16 of B a step:
// B's tile by 16-byte cp.async straight into the next stage, A's by a
// 16-byte global load into registers, stored transposed after the compute;
// one barrier a step.  The forms (the host picks, kernels/imatmul.py):
//   int32, 128 x 128 tiles of 8 x 8 (BK 8), 2 blocks an SM: 2048^2 outputs
//     are 256 tiles, one wave on 132 SMs;
//   int32, 64 x 64 tiles of 4 x 4 (BK 16), 4 blocks an SM, where the waves
//     favour it (few output tiles, or just past a wave of 128-tiles);
//   int64, 64 x 64 tiles of 4 x 4 (BK 8): an int64 accumulator takes two
//     registers, so the 8 x 8 micro-tile would leave no room for operands.
// A tile that reaches past M, N or K, or operands whose rows are not 16-byte
// aligned, takes element loads that read 0 past the edge (0 annihilates the
// product and is the sum's identity), and stores past the edge are dropped;
// nothing is padded in device memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// global -> shared without registers: 16 bytes (through L2 only), or one
// element of 4 or 8 bytes
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
  else if (BYTES == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
}

// four consecutive elements of a 16-byte aligned shared row
__device__ __forceinline__ void lds4(const uint32_t* p, uint32_t* v) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

__device__ __forceinline__ void lds4(const unsigned long long* p, unsigned long long* v) {
  const ulonglong2 x = reinterpret_cast<const ulonglong2*>(p)[0];
  const ulonglong2 y = reinterpret_cast<const ulonglong2*>(p)[1];
  v[0] = x.x;
  v[1] = x.y;
  v[2] = y.x;
  v[3] = y.y;
}

// T: uint32_t or unsigned long long (unsigned, so the wrap is defined);
// BM x BM output tiles of TM x TM a thread; MINB blocks an SM
template <typename T, int BM, int TM, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
    imatmul_kernel(const T* __restrict__ A, const T* __restrict__ B, T* __restrict__ C, int M, int N, int K,
                   int a_vec, int b_vec) {
  constexpr int E = 16 / (int)sizeof(T);  // the elements of A and of B a thread copies a step
  constexpr int BK = kThreads * E / BM;   // k a step
  constexpr int APAD = BM + E;            // A's transposed row, padded, 16-byte aligned
  constexpr int G = TM / 4;               // groups of 4 rows (columns) of a micro-tile
  constexpr int SPAN = BM / G;            // rows (columns) between two groups
  static_assert(BK * BM == kThreads * E && (BM / TM) * (BM / TM) == kThreads && TM % 4 == 0, "tile shape");
  __shared__ __align__(16) T As[2][BK][APAD];  // A's tile, transposed: As[s][k][i]
  __shared__ __align__(16) T Bs[2][BK][BM];
  const int tid = threadIdx.x;
  const int tx = tid % (BM / TM), ty = tid / (BM / TM);
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BM;
  // what this thread copies: A's row a_row, k a_k .. a_k + E - 1; B's row
  // b_k, columns b_col .. b_col + E - 1
  const int a_row = tid / (BK / E), a_k = (tid % (BK / E)) * E;
  const int b_k = tid / (BM / E), b_col = (tid % (BM / E)) * E;
  const bool rows_in = row0 + BM <= M, cols_in = col0 + BM <= N;

  T acc[TM][TM];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = 0;

  union {
    uint4 v;
    T e[E];
  } a_next;
  auto load_a = [&](int k0) {
    const int gi = row0 + a_row, gk = k0 + a_k;
    if (a_vec && rows_in && k0 + BK <= K) {
      a_next.v = *reinterpret_cast<const uint4*>(A + (int64_t)gi * K + gk);
    } else {
#pragma unroll
      for (int c = 0; c < E; ++c) a_next.e[c] = (gi < M && gk + c < K) ? A[(int64_t)gi * K + gk + c] : T(0);
    }
  };
  auto store_a = [&](int s) {
#pragma unroll
    for (int c = 0; c < E; ++c) As[s][a_k + c][a_row] = a_next.e[c];
  };
  // B: straight into the stage by cp.async, 16 bytes, or (a ragged or
  // unaligned tile) an element at a time in range and 0 past the edge
  auto load_b = [&](int s, int k0) {
    const int gk = k0 + b_k, gj = col0 + b_col;
    T* dst = &Bs[s][b_k][b_col];
    if (b_vec && cols_in && k0 + BK <= K) {
      cp_async<16>(dst, B + (int64_t)gk * N + gj);
    } else {
#pragma unroll
      for (int c = 0; c < E; ++c) {
        if (gk < K && gj + c < N) cp_async<(int)sizeof(T)>(dst + c, B + (int64_t)gk * N + gj + c);
        else dst[c] = T(0);
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
      T a[TM], b[TM];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        lds4(&As[cur][kk][g * SPAN + ty * 4], a + 4 * g);
        lds4(&Bs[cur][kk][g * SPAN + tx * 4], b + 4 * g);
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] += a[i] * b[j];
    }
    if (more) {
      store_a(cur ^ 1);
      asm volatile("cp.async.wait_all;" ::: "memory");
    }
    __syncthreads();  // the next stage is in; this one is free
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gi = row0 + (i / 4) * SPAN + ty * 4 + i % 4;
    if (gi >= M) continue;
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const int gj = col0 + (j / 4) * SPAN + tx * 4 + j % 4;
      if (gj < N) C[(int64_t)gi * N + gj] = acc[i][j];
    }
  }
}

template <typename T, int BM, int TM, int MINB>
void launch(const void* a, const void* b, void* c, int M, int N, int K, cudaStream_t s) {
  constexpr int E = 16 / (int)sizeof(T);
  const dim3 grid((unsigned)((N + BM - 1) / BM), (unsigned)((M + BM - 1) / BM));
  // 16-byte loads need 16-byte aligned operands and rows of a multiple of 16 bytes
  const int a_vec = ((uintptr_t)a % 16 == 0) && K % E == 0;
  const int b_vec = ((uintptr_t)b % 16 == 0) && N % E == 0;
  imatmul_kernel<T, BM, TM, MINB><<<grid, kThreads, 0, s>>>((const T*)a, (const T*)b, (T*)c, M, N, K, a_vec, b_vec);
}

}  // namespace

// a: (M, K), b: (K, N), c: (M, N), all row-major, of elem_bytes 4 (int32) or
// 8 (int64).  tile: the block tile, 128 or 64 for int32, 64 for int64.
extern "C" int gb_imatmul(const void* a, const void* b, void* c, int M, int N, int K, int elem_bytes, int tile,
                          void* stream) {
  const bool form = (elem_bytes == 4 && (tile == 128 || tile == 64)) || (elem_bytes == 8 && tile == 64);
  if (M < 0 || N < 0 || K < 0 || !form || (M > 0 && (M + tile - 1) / tile > 65535))
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 8)
    launch<unsigned long long, 64, 4, 2>(a, b, c, M, N, K, s);
  else if (tile == 128)
    launch<uint32_t, 128, 8, 2>(a, b, c, M, N, K, s);
  else
    launch<uint32_t, 64, 4, 4>(a, b, c, M, N, K, s);
  return (int)cudaGetLastError();
}
