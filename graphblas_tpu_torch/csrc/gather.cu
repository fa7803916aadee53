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
// index read, one random read of x, one streamed write (plus
// one streamed aux read for the PageRank epilogue).  At e_pad = 2^23, x is
// 32 MB and stays resident in the 50 MB L2, so the random reads mostly hit
// L2 instead of HBM.
//
// Design: one grid-stride loop, consecutive threads on consecutive output
// slots so the index, aux and output streams coalesce; x is read through the
// read-only path.  No shared memory, no synchronisation, nothing allocated.
// The PageRank division uses __fdiv_rn so it rounds exactly like the plain
// PyTorch version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

inline unsigned grid_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  const int64_t cap = 1 << 20;
  return (unsigned)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

// Words of 1, 2 or 4 bytes: one kernel serves every dtype of that width
// (the fill value 0 has the same bits in all of them), so 8- and 16-bit
// channels move at their own width.  idx[p] < 0 gives 0.
template <typename W>
__global__ void gather_words(const W* __restrict__ x, const int32_t* __restrict__ idx,
                             W* __restrict__ out, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; p < n; p += stride) {
    const int32_t j = idx[p];
    out[p] = j >= 0 ? __ldg(x + j) : (W)0;
  }
}

template <typename W>
void launch_gather(const void* x, const void* idx, void* out, int64_t n, cudaStream_t s) {
  gather_words<W><<<grid_for(n), kThreads, 0, s>>>((const W*)x, (const int32_t*)idx, (W*)out, n);
}

// PageRank postlude of models/fast.py: a = aux[p] is the out-degree signed
// by "this start slot has a state slot"; c is the rank of stateless
// vertices, read from device memory so no host sync is needed.
__global__ void gather_pagerank(const float* __restrict__ x, const int32_t* __restrict__ idx,
                                const float* __restrict__ aux, const float* __restrict__ c,
                                float* __restrict__ out, int64_t n) {
  const float cv = *c;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; p < n; p += stride) {
    const float y = __ldg(x + idx[p]);
    const float a = aux[p];
    out[p] = a > 0.f ? __fdiv_rn(y, a) : __fdiv_rn(cv, -a);
  }
}

}  // namespace

// elem_bytes: 1, 2 or 4.
extern "C" int gb_gather(const void* x, const void* idx, void* out, int64_t n, int elem_bytes,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    switch (elem_bytes) {
      case 1: launch_gather<uint8_t>(x, idx, out, n, s); break;
      case 2: launch_gather<uint16_t>(x, idx, out, n, s); break;
      case 4: launch_gather<uint32_t>(x, idx, out, n, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

extern "C" int gb_gather_pagerank(const void* x, const void* idx, const void* aux, const void* c,
                                  void* out, int64_t n, void* stream) {
  if (n > 0) {
    gather_pagerank<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const int32_t*)idx, (const float*)aux, (const float*)c, (float*)out, n);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* gb_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
