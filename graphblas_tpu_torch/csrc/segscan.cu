// Kernels C and S, and the generic scan: inclusive segmented scans with
// fused prologue/epilogue.
//
// Kernel C (segscan_contrib) replaces
//   graphblas_tpu/ops/pallas_scan.py:segmented_scan_contrib (_fused_kernel):
//   per edge a semiring multiply (times, plus, second, first, or x alone when
//   w is absent), an optional wrap to 8 or 16 bits, the monoid identity at
//   invalid slots, then a segmented add/min/max inclusive scan.
// Kernel S (segscan_state) replaces
//   graphblas_tpu/ops/pallas_scan.py:segmented_scan_state (_state_kernel):
//   kernel C's scan (BFS: max of x; SSSP: min of x + w) fused with the
//   per-round state update at dst-segment-last slots.  BFS writes new levels
//   and the frontier; SSSP writes min(dist, scan) at last slots and
//   STATE_BIG elsewhere (the donor invariant the loop route relies on), plus
//   per-slot changed flags or one device "any changed" flag.
// The generic scan (segscan) replaces
//   graphblas_tpu/ops/pallas_scan.py:segmented_scan (_kernel, _scan_tile):
//   an inclusive segmented fill/add/min/max scan of values alone.  8- and
//   16-bit integers widen to int32 on load and are truncated on store, as
//   the reference computes narrow channels in int32 (add wraps the same
//   modulo 2^k; fill, min and max are unaffected).
//
// Bound on the card: memory traffic.  One scan streams x, w (4 B each) and
// the valid/flag bytes in, and the result out; the state kernel adds the
// is_last byte and the state word in, and a second word out; the generic
// scan reads only the values and the flag bytes.  There is no arithmetic to
// speak of.
//
// Design: the TPU kernels carry the running (value, flag) pair from tile to
// tile through a sequential grid with an SMEM carry.  Hopper blocks run in
// no order, so this is reduce-then-scan in three launches:
//   1. every block reduces its tile of kTile slots to one (value, has-flag)
//      aggregate;
//   2. one block scans the aggregates into per-tile carries (4096 of them at
//      e_pad = 2^23);
//   3. every block rescans its tile with its carry and applies the epilogue.
// Phases 1 and 3 both read the inputs, so the input bytes cross memory
// twice; at e_pad = 2^23 the second read partly hits the 50 MB L2.  A tile is
// staged through shared memory (striped, coalesced global accesses; padded
// to avoid bank conflicts), each thread scans kItems consecutive slots,
// then warp shuffles and one warp-total pass combine the threads.  Float
// arithmetic uses the _rn intrinsics so no multiply is contracted into an
// FMA: products and sums round exactly as in the plain PyTorch version.
// Offsets are 64-bit.  Nothing is allocated and nothing synchronises the
// host: the wrapper passes the scratch arrays.

#include <cuda_runtime.h>
#include <limits.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr int kPadded = kTile + kTile / 32;
constexpr unsigned kFull = 0xffffffffu;
// np.float32(3.4e38) / 4, as graphblas_tpu/ops/pallas_scan.py:STATE_BIG
constexpr float kStateBig = 3.4e38f / 4.0f;

enum { kAdd = 0, kMin = 1, kMax = 2, kFill = 3 };
enum { kTimes = 0, kPlus = 1, kSecond = 2, kFirst = 3 };

__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

template <typename T, int OP>
struct Monoid;

// fill: a slot with no flag of its own takes the earlier value (apply returns
// a); combine keeps a flagged slot's own value.
template <int OP>
struct Monoid<float, OP> {
  static __device__ __forceinline__ float ident() {
    return (OP == kAdd || OP == kFill) ? 0.f : (OP == kMin ? CUDART_INF_F : -CUDART_INF_F);
  }
  static __device__ __forceinline__ float apply(float a, float b) {
    if (OP == kFill) return a;
    if (OP == kAdd) return __fadd_rn(a, b);
    if (OP == kMin) return b < a ? b : a;
    return b > a ? b : a;
  }
};

template <int OP>
struct Monoid<int32_t, OP> {
  static __device__ __forceinline__ int32_t ident() {
    return (OP == kAdd || OP == kFill) ? 0 : (OP == kMin ? INT_MAX : INT_MIN);
  }
  static __device__ __forceinline__ int32_t apply(int32_t a, int32_t b) {
    if (OP == kFill) return a;
    if (OP == kAdd) return (int32_t)((uint32_t)a + (uint32_t)b);  // wraps like XLA
    if (OP == kMin) return b < a ? b : a;
    return b > a ? b : a;
  }
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ int32_t mul_rn(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a * (uint32_t)b);
}
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ int32_t add_rn(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ float wrap_to(float c, int, int) { return c; }  // wrapper rejects
__device__ __forceinline__ int32_t wrap_to(int32_t c, int bits, int is_signed) {
  if (is_signed) {
    const int k = 32 - bits;
    return ((int32_t)((uint32_t)c << k)) >> k;
  }
  return (int32_t)((uint32_t)c & ((1u << bits) - 1u));
}

// b := a (+) b, where a is the earlier pair; a set flag in b starts a segment.
template <typename T, int OP>
__device__ __forceinline__ void combine(T av, int af, T& bv, int& bf) {
  if (!bf) bv = Monoid<T, OP>::apply(av, bv);
  bf |= af;
}

// ---- loaders: slot -> (contribution, segment-start flag) ------------------

template <typename T>
struct ContribLoad {
  const T* x;
  const T* w;  // nullptr: contribution is x alone
  const uint8_t* valid;
  const uint8_t* flags;
  int mul, wrap_bits, wrap_signed;
  T invalid;  // the monoid identity in the IO type's range (int8 IO computes in int32)
  __device__ __forceinline__ void operator()(int64_t i, T, T& v, int& f) const {
    T c = x[i];
    if (w != nullptr) {
      const T wv = w[i];
      if (mul == kTimes) c = mul_rn(c, wv);
      else if (mul == kPlus) c = add_rn(c, wv);
      else if (mul == kSecond) c = wv;
    }
    if (wrap_bits > 0 && (mul == kTimes || mul == kPlus)) c = wrap_to(c, wrap_bits, wrap_signed);
    v = valid[i] ? c : invalid;
    f = flags[i] != 0;
  }
};

struct StateLoad {
  const float* x;
  const float* w;  // nullptr for BFS
  const uint8_t* valid;
  const uint8_t* flags;
  __device__ __forceinline__ void operator()(int64_t i, float ident, float& v, int& f) const {
    float c = x[i];
    if (w != nullptr) c = __fadd_rn(c, w[i]);
    v = valid[i] ? c : ident;
    f = flags[i] != 0;
  }
};

// The generic scan: the value widened to the compute type, and its flag.
template <typename In, typename T>
struct ValueLoad {
  const In* v;
  const uint8_t* flags;
  __device__ __forceinline__ void operator()(int64_t i, T, T& ov, int& of) const {
    ov = (T)v[i];
    of = flags[i] != 0;
  }
};

template <typename T>
struct AggLoad {
  const T* v;
  const int32_t* f;
  __device__ __forceinline__ void operator()(int64_t i, T, T& ov, int& of) const {
    ov = v[i];
    of = f[i];
  }
};

// ---- stores: slot, scanned value -> outputs; return 1 if "changed" --------

// The scanned value in the IO type (narrow integers truncate modulo 2^k).
template <typename Out, typename T>
struct ValueStore {
  Out* out;
  __device__ __forceinline__ int operator()(int64_t i, T v) const {
    out[i] = (Out)v;
    return 0;
  }
  __device__ __forceinline__ void block_done(int) const {}
};

struct BfsStore {
  const uint8_t* is_last;
  const int32_t* levels;
  int depth;
  int32_t* out_levels;
  float* frontier;
  __device__ __forceinline__ int operator()(int64_t i, float v) const {
    const int32_t lv = levels[i];
    const bool nxt = is_last[i] && v > 0.f && lv < 0;
    out_levels[i] = nxt ? depth + 1 : lv;
    frontier[i] = nxt ? 1.f : 0.f;
    return 0;
  }
  __device__ __forceinline__ void block_done(int) const {}
};

struct SsspStore {
  const uint8_t* is_last;
  const float* dist;
  float* out_dist;
  float* changed;        // per-slot flags, or nullptr
  int32_t* any_changed;  // one device flag (fr_reduce), or nullptr
  __device__ __forceinline__ int operator()(int64_t i, float v) const {
    const float d = dist[i];
    const float nw = is_last[i] ? (v < d ? v : d) : kStateBig;
    out_dist[i] = nw;
    const int ch = nw < d;
    if (changed != nullptr) changed[i] = ch ? 1.f : 0.f;
    return ch;
  }
  __device__ __forceinline__ void block_done(int any) const {
    if (any_changed != nullptr && any) atomicMax(any_changed, 1);
  }
};

// ---- block building blocks ------------------------------------------------

template <typename T, int OP, class Load>
__device__ __forceinline__ void load_tile(const Load& ld, int64_t base, int64_t n, T* s_v,
                                          uint8_t* s_f) {
  const T ident = Monoid<T, OP>::ident();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = k * kThreads + threadIdx.x;
    const int64_t g = base + i;
    T v = ident;
    int f = 0;
    if (g < n) ld(g, ident, v, f);
    s_v[pad(i)] = v;
    s_f[pad(i)] = (uint8_t)f;
  }
  __syncthreads();
}

template <typename T, int OP>
__device__ __forceinline__ void thread_reduce(const T* s_v, const uint8_t* s_f, T& v, int& f) {
  v = Monoid<T, OP>::ident();
  f = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = pad(threadIdx.x * kItems + k);
    T bv = s_v[i];
    int bf = s_f[i];
    combine<T, OP>(v, f, bv, bf);
    v = bv;
    f = bf;
  }
}

// Exclusive scan of one (v, f) pair per thread across the block; also gives
// the block total.  Ends with a barrier, so the caller may reuse s_w*.
template <typename T, int OP>
__device__ __forceinline__ void block_exclusive(T v, int f, T& ex_v, int& ex_f, T& tot_v,
                                                int& tot_f, T* s_wv, int* s_wf) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T ov = __shfl_up_sync(kFull, v, d);
    const int of = __shfl_up_sync(kFull, f, d);
    if (lane >= d) combine<T, OP>(ov, of, v, f);
  }
  T xv = __shfl_up_sync(kFull, v, 1);
  int xf = __shfl_up_sync(kFull, f, 1);
  if (lane == 0) {
    xv = Monoid<T, OP>::ident();
    xf = 0;
  }
  if (lane == 31) {
    s_wv[wid] = v;
    s_wf[wid] = f;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    T rv = Monoid<T, OP>::ident();
    int rf = 0;
    for (int k = 0; k < kWarps; ++k) {
      T wv = s_wv[k];
      int wf = s_wf[k];
      s_wv[k] = rv;
      s_wf[k] = rf;
      combine<T, OP>(rv, rf, wv, wf);
      rv = wv;
      rf = wf;
    }
    s_wv[kWarps] = rv;
    s_wf[kWarps] = rf;
  }
  __syncthreads();
  combine<T, OP>(s_wv[wid], s_wf[wid], xv, xf);
  ex_v = xv;
  ex_f = xf;
  tot_v = s_wv[kWarps];
  tot_f = s_wf[kWarps];
  __syncthreads();
}

// ---- the three phases -----------------------------------------------------

template <typename T, int OP, class Load>
__global__ void __launch_bounds__(kThreads)
    scan_aggregates(Load ld, int64_t n, T* agg_v, int32_t* agg_f) {
  __shared__ T s_v[kPadded];
  __shared__ uint8_t s_f[kPadded];
  __shared__ T s_wv[kWarps + 1];
  __shared__ int s_wf[kWarps + 1];
  load_tile<T, OP>(ld, (int64_t)blockIdx.x * kTile, n, s_v, s_f);
  T v, ev, tv;
  int f, ef, tf;
  thread_reduce<T, OP>(s_v, s_f, v, f);
  block_exclusive<T, OP>(v, f, ev, ef, tv, tf, s_wv, s_wf);
  if (threadIdx.x == 0) {
    agg_v[blockIdx.x] = tv;
    agg_f[blockIdx.x] = tf;
  }
}

// One block: carry[b] = aggregates 0..b-1 combined (exclusive).
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
    scan_carries(const T* agg_v, const int32_t* agg_f, T* carry, int64_t nb) {
  __shared__ T s_v[kPadded];
  __shared__ uint8_t s_f[kPadded];
  __shared__ T s_wv[kWarps + 1];
  __shared__ int s_wf[kWarps + 1];
  const AggLoad<T> ld{agg_v, agg_f};
  T run_v = Monoid<T, OP>::ident();
  int run_f = 0;
  for (int64_t base = 0; base < nb; base += kTile) {
    load_tile<T, OP>(ld, base, nb, s_v, s_f);
    T v, ev, tv;
    int f, ef, tf;
    thread_reduce<T, OP>(s_v, s_f, v, f);
    block_exclusive<T, OP>(v, f, ev, ef, tv, tf, s_wv, s_wf);
    combine<T, OP>(run_v, run_f, ev, ef);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = threadIdx.x * kItems + k;
      if (base + i < nb) carry[base + i] = ev;
      T bv = s_v[pad(i)];
      int bf = s_f[pad(i)];
      combine<T, OP>(ev, ef, bv, bf);
      ev = bv;
      ef = bf;
    }
    combine<T, OP>(run_v, run_f, tv, tf);
    run_v = tv;
    run_f = tf;
    __syncthreads();
  }
}

template <typename T, int OP, class Load, class Store>
__global__ void __launch_bounds__(kThreads)
    scan_apply(Load ld, Store st, const T* carry, int64_t n) {
  __shared__ T s_v[kPadded];
  __shared__ uint8_t s_f[kPadded];
  __shared__ T s_wv[kWarps + 1];
  __shared__ int s_wf[kWarps + 1];
  const int64_t base = (int64_t)blockIdx.x * kTile;
  load_tile<T, OP>(ld, base, n, s_v, s_f);
  T v, ev, tv;
  int f, ef, tf;
  thread_reduce<T, OP>(s_v, s_f, v, f);
  block_exclusive<T, OP>(v, f, ev, ef, tv, tf, s_wv, s_wf);
  combine<T, OP>(carry[blockIdx.x], 0, ev, ef);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = pad(threadIdx.x * kItems + k);
    T bv = s_v[i];
    int bf = s_f[i];
    combine<T, OP>(ev, ef, bv, bf);
    ev = bv;
    ef = bf;
    s_v[i] = ev;
  }
  __syncthreads();
  int any = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = k * kThreads + threadIdx.x;
    if (base + i < n) any |= st(base + i, s_v[pad(i)]);
  }
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) st.block_done(any);
}

template <typename T, int OP, class Load, class Store>
int run_scan(const Load& ld, const Store& st, int64_t n, void* agg_v, void* agg_f, void* carry,
             cudaStream_t s) {
  if (n > 0) {
    const int64_t nb = (n + kTile - 1) / kTile;
    scan_aggregates<T, OP, Load><<<(unsigned)nb, kThreads, 0, s>>>(ld, n, (T*)agg_v,
                                                                   (int32_t*)agg_f);
    scan_carries<T, OP><<<1, kThreads, 0, s>>>((const T*)agg_v, (const int32_t*)agg_f, (T*)carry,
                                                nb);
    scan_apply<T, OP, Load, Store><<<(unsigned)nb, kThreads, 0, s>>>(ld, st, (const T*)carry, n);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int contrib_typed(const void* x, const void* w, const void* valid, const void* flags, void* out,
                  void* agg_v, void* agg_f, void* carry, int64_t n, int op, int mul, int wrap_bits,
                  int wrap_signed, double invalid, cudaStream_t s) {
  const ContribLoad<T> ld{(const T*)x, (const T*)w, (const uint8_t*)valid,
                          (const uint8_t*)flags, mul, wrap_bits, wrap_signed, (T)invalid};
  const ValueStore<T, T> st{(T*)out};
  switch (op) {
    case kAdd: return run_scan<T, kAdd>(ld, st, n, agg_v, agg_f, carry, s);
    case kMin: return run_scan<T, kMin>(ld, st, n, agg_v, agg_f, carry, s);
    case kMax: return run_scan<T, kMax>(ld, st, n, agg_v, agg_f, carry, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename In, typename T>
int scan_typed(const void* values, const void* flags, void* out, void* agg_v, void* agg_f,
               void* carry, int64_t n, int op, cudaStream_t s) {
  const ValueLoad<In, T> ld{(const In*)values, (const uint8_t*)flags};
  const ValueStore<In, T> st{(In*)out};
  switch (op) {
    case kAdd: return run_scan<T, kAdd>(ld, st, n, agg_v, agg_f, carry, s);
    case kMin: return run_scan<T, kMin>(ld, st, n, agg_v, agg_f, carry, s);
    case kMax: return run_scan<T, kMax>(ld, st, n, agg_v, agg_f, carry, s);
    case kFill: return run_scan<T, kFill>(ld, st, n, agg_v, agg_f, carry, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int gb_segscan_tile() { return kTile; }

// op: 0 add, 1 min, 2 max.  mul: 0 times, 1 plus, 2 second, 3 first
// (ignored when w is null).  wrap_bits 0 = no wrap.  invalid: the value
// written at invalid slots (the identity in the IO type's range).  Scratch: agg_v and carry
// hold ceil(n / tile) values of the IO type, agg_f as many int32.
extern "C" int gb_segscan_contrib(const void* x, const void* w, const void* valid,
                                  const void* flags, void* out, void* agg_v, void* agg_f,
                                  void* carry, int64_t n, int is_int, int op, int mul,
                                  int wrap_bits, int wrap_signed, double invalid, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_int)
    return contrib_typed<int32_t>(x, w, valid, flags, out, agg_v, agg_f, carry, n, op, mul,
                                  wrap_bits, wrap_signed, invalid, s);
  return contrib_typed<float>(x, w, valid, flags, out, agg_v, agg_f, carry, n, op, mul, wrap_bits,
                              wrap_signed, invalid, s);
}

// mode 0 = BFS (state int32 levels; out_fr = frontier f32),
// mode 1 = SSSP (state f32 dist; out_fr = changed f32, or null with
// any_changed pointing at one int32 that the kernel raises to 1).
extern "C" int gb_segscan_state(int mode, const void* x, const void* w, const void* valid,
                                const void* flags, const void* is_last, const void* state,
                                int depth, void* out_state, void* out_fr, void* any_changed,
                                void* agg_v, void* agg_f, void* carry, int64_t n, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const StateLoad ld{(const float*)x, (const float*)w, (const uint8_t*)valid,
                     (const uint8_t*)flags};
  if (mode == 0) {
    const BfsStore st{(const uint8_t*)is_last, (const int32_t*)state, depth, (int32_t*)out_state,
                      (float*)out_fr};
    return run_scan<float, kMax>(ld, st, n, agg_v, agg_f, carry, s);
  }
  const SsspStore st{(const uint8_t*)is_last, (const float*)state, (float*)out_state,
                     (float*)out_fr, (int32_t*)any_changed};
  return run_scan<float, kMin>(ld, st, n, agg_v, agg_f, carry, s);
}

// The generic scan.  op: 0 add, 1 min, 2 max, 3 fill.  dtype: 0 float32,
// 1 int32, 2 int16, 3 int8, 4 uint8 (the narrow integers compute in int32).
// Scratch: agg_v and carry hold ceil(n / tile) values of the compute type,
// agg_f as many int32.
extern "C" int gb_segscan(const void* values, const void* flags, void* out, void* agg_v,
                          void* agg_f, void* carry, int64_t n, int dtype, int op, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return scan_typed<float, float>(values, flags, out, agg_v, agg_f, carry, n, op, s);
    case 1: return scan_typed<int32_t, int32_t>(values, flags, out, agg_v, agg_f, carry, n, op, s);
    case 2: return scan_typed<int16_t, int32_t>(values, flags, out, agg_v, agg_f, carry, n, op, s);
    case 3: return scan_typed<int8_t, int32_t>(values, flags, out, agg_v, agg_f, carry, n, op, s);
    case 4: return scan_typed<uint8_t, int32_t>(values, flags, out, agg_v, agg_f, carry, n, op, s);
  }
  return (int)cudaErrorInvalidValue;
}
