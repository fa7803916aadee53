// Kernel G: out[p] = x[idx[p]] over one composed int32 index array, with an
// optional fused elementwise epilogue.
//
// Replaces two TPU kernels of the JAX package:
//   - graphblas_tpu/ops/permute.py:_pallas_shuffle (the per-row 128-lane
//     shuffle stage that apply_plan chains into a permutation network, with
//     its fused `post` epilogue).  On Hopper a gather is the native
//     primitive, so the whole network is composed on the host into one index
//     array and applied in one pass.
//   - graphblas_tpu/ops/pallas_scan.py:segmented_fill_static (segmented
//     forward fill with static flags).  The flags never change, so the fill
//     is a gather through fill_src[p] = latest flagged slot <= p, and
//     fill_src[p] < 0 gives 0 (the reference's "0 before the first flag").
//
// Bound on the card: memory traffic.  Per output slot one streamed 4-byte
// index read, one random read of x, one streamed write (plus one streamed
// aux read for the PageRank epilogue): 12 bytes, 0.030 ms at 2^23 slots and
// 3.35 TB/s.  A random 4-byte read moves a whole 32-byte sector, from L2
// where x is resident, else from HBM.  Measured on an NVIDIA H100 80GB HBM3
// at 700 W (tools/probe_kernels.py, a route of 2^23 slots, random over x):
// x of 2^20 f32 slots (4 MB, resident) 0.075 ms, 2^23 (32 MB, the main
// path's) 0.105 ms, 2^24 (64 MB, more than the 50 MB L2) 0.193 ms.  So the
// random sector reads set the time even out of L2, and at 2^23 a third of
// it is x's lines that the streams evict.  An x larger than L2 stays
// sector-bound: only a bucketed multi-pass gather would help there, and none
// is attempted.
//
// Design:
//   - memory-level parallelism: a warp takes 8 x 32 consecutive slots a
//     step, lane l the slots l, l + 32, ..., l + 224.  A thread issues its 8
//     index loads, then all 8 random loads of x before it uses any, then its
//     8 stores: 8 loads in flight a thread where the first design had one.
//     Every index, aux and output access of a warp is one coalesced 128-byte
//     line (32 bytes for 1-byte words), at any alignment of the views, and a
//     fill (whose sources are near each slot) reads x coalesced too.  The
//     grid covers the slots in a few waves of the SMs.
//   - L2 residency: idx and aux are loaded evict-first (ld.global.cs), out is
//     stored streaming (st.global.cs), and x is read through the read-only
//     path with an L2::evict_last cache policy, so the streams evict
//     themselves and not x (without the hints the route at 2^23 takes
//     0.113 ms).  An L2 access-policy window marking x persisting was slower
//     (0.118 ms) and its carve-out slowed the kernels after it.
// No shared memory, no synchronisation, nothing allocated.  The PageRank
// division uses __fdiv_rn so it rounds exactly like the plain PyTorch
// version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;        // slots a thread keeps in flight
constexpr int kBlocksPerSm = 32;  // 4 waves of 8 resident 256-thread blocks

// The epilogues, per slot: y = x[j] (or 0 for j < 0), a = aux[p].  bind()
// runs once per thread and reads what the epilogue keeps in device memory.
template <typename W>
struct WordEpi {  // none / fill
  static constexpr bool kAux = false;
  __device__ __forceinline__ WordEpi bind() const { return *this; }
  __device__ __forceinline__ W operator()(W y, float) const { return y; }
};

// PageRank postlude of models/fast.py: a = aux[p] is the out-degree signed
// by "this start slot has a state slot"; c is the rank of stateless
// vertices, read from device memory so no host sync is needed.
struct PagerankEpi {
  static constexpr bool kAux = true;
  const float* c_ptr;
  float c;
  __device__ __forceinline__ PagerankEpi bind() const { return PagerankEpi{c_ptr, __ldg(c_ptr)}; }
  __device__ __forceinline__ uint32_t operator()(uint32_t y, float a) const {
    const float r = a > 0.f ? __fdiv_rn(__uint_as_float(y), a) : __fdiv_rn(c, -a);
    return __float_as_uint(r);
  }
};

// Slots base + 32 u + lane of each step, u < kUnroll.  idx[p] < 0 gives 0.
template <typename W, class Epi>
__global__ void __launch_bounds__(kThreads)
    gather_kernel(const W* __restrict__ x, const int32_t* __restrict__ idx,
                  const float* __restrict__ aux, W* __restrict__ out, int64_t n, Epi epi_arg) {
  const Epi epi = epi_arg.bind();
  const uint64_t pol = evict_last_policy();
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t step = ((int64_t)gridDim.x * blockDim.x >> 5) * kUnroll * 32;
  for (int64_t base = warp * kUnroll * 32 + lane; base < n; base += step) {
    int32_t j[kUnroll];
    float a[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t p = base + 32 * u;
      j[u] = p < n ? __ldcs(idx + p) : -1;
      a[u] = Epi::kAux && p < n ? __ldcs(aux + p) : 0.f;
    }
    W y[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) y[u] = j[u] >= 0 ? ld_keep(x + j[u], pol) : (W)0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t p = base + 32 * u;
      if (p < n) __stcs(out + p, epi(y[u], a[u]));
    }
  }
}

template <typename W, class Epi>
int launch(const void* x, const void* idx, const void* aux, void* out, int64_t n, const Epi& epi,
           cudaStream_t s) {
  if (n > 0) {
    int dev = 0, sms = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int64_t per_block = (int64_t)kThreads * kUnroll;
    int64_t blocks = (n + per_block - 1) / per_block;
    if (blocks > (int64_t)sms * kBlocksPerSm) blocks = (int64_t)sms * kBlocksPerSm;
    gather_kernel<W, Epi><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const W*)x, (const int32_t*)idx, (const float*)aux, (W*)out, n, epi);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// elem_bytes: 1, 2 or 4.
extern "C" int gb_gather(const void* x, const void* idx, void* out, int64_t n, int elem_bytes,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (elem_bytes) {
    case 1: return launch<uint8_t>(x, idx, nullptr, out, n, WordEpi<uint8_t>{}, s);
    case 2: return launch<uint16_t>(x, idx, nullptr, out, n, WordEpi<uint16_t>{}, s);
    case 4: return launch<uint32_t>(x, idx, nullptr, out, n, WordEpi<uint32_t>{}, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int gb_gather_pagerank(const void* x, const void* idx, const void* aux, const void* c,
                                  void* out, int64_t n, void* stream) {
  return launch<uint32_t>(x, idx, aux, out, n, PagerankEpi{(const float*)c, 0.f},
                          (cudaStream_t)stream);
}

extern "C" const char* gb_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
