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
// the valid/flag bytes in, and the result out (14 B a slot for C); the state
// kernel adds the is_last byte and the state word in, and a second word out;
// the generic scan reads only the values and the flag bytes.  There is no
// arithmetic to speak of.
//
// The TPU kernels carry the running (value, flag) pair from tile to tile
// through a sequential grid with an SMEM carry.  Hopper blocks run in no
// order, so the carry has to cross blocks.
//
// Kernel C and the generic scan are one launch each, a single pass with
// decoupled look-back (below, "the single pass"): each input byte crosses
// memory once.  Persistent blocks take 2048-slot tiles from a ticket
// counter; a full tile of aligned inputs arrives in shared memory by
// Hopper's bulk copy (cp.async.bulk, an mbarrier counting its bytes) while
// the block scans the tile before it; a
// ragged or unaligned tile is read with plain loads in the same kernel.  The
// carry goes through one 64-bit descriptor a tile.  Measured on an NVIDIA
// H100 80GB HBM3 at 700 W (chip_smoke.py phase 3, 2^23 slots, flags at
// 1/16): add/times 0.064 ms against the 0.035 ms bound, where the three
// launches took 0.097; with no flag at all, the longest look-back, 0.077-0.081
// ms.  A variant that read full tiles by 16-byte loads into registers in
// place of the bulk copies took 0.077-0.084 ms with flags.
//
// The generic scan rides the same single pass with its own tile: values
// (f32, int32, int16, int8 or uint8) and flag bytes by bulk copy, 9 B a slot
// in f32 or int32, 3 B in int8; narrow integers widen to int32 in
// registers and pack back into one vector store a thread.  Float add carries
// in double across tiles, as C's does.  Measured as C (2^23 slots, flags at
// 1/16): f32 add 0.047-0.050 ms against the 0.0225 ms bound, where the three
// launches took 0.060-0.068; int8 add 0.046-0.063 (bound 0.0075), held, like
// C, by each tile's latency rather than its bytes.
//
// Kernel S is still reduce-then-scan in three launches:
//   1. every block reduces its tile of kTile slots to one (value, has-flag)
//      aggregate;
//   2. one block scans the aggregates into per-tile carries (4096 of them at
//      e_pad = 2^23);
//   3. every block rescans its tile with its carry and applies the epilogue.
// Phases 1 and 3 both read the inputs, so the input bytes cross memory
// twice; their tiles are staged through shared memory (striped, coalesced
// global accesses, padded against bank conflicts).  The single pass takes a
// Tile (loads) and a Store (epilogue), so S can move onto it with its own.
//
// In both, each thread scans kItems consecutive slots, then warp shuffles
// and one warp-total pass combine the threads.  Float arithmetic uses the
// _rn intrinsics so no multiply is contracted into an FMA: products and sums
// round exactly as in the plain PyTorch version.  Offsets are 64-bit.
// Nothing is allocated and nothing synchronises the host: the wrapper
// passes the scratch arrays.

#include <cuda_runtime.h>
#include <limits.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

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
struct Monoid<double, OP> {  // the single pass's carry of float sums
  static __device__ __forceinline__ double ident() { return 0.0; }
  static __device__ __forceinline__ double apply(double a, double b) { return __dadd_rn(a, b); }
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

// the 32 bits of a 4-byte value (the single pass's vector loads and stores)
__device__ __forceinline__ uint32_t to_bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ uint32_t to_bits(int32_t v) { return (uint32_t)v; }
template <typename T>
__device__ __forceinline__ T from_bits(uint32_t b);
template <>
__device__ __forceinline__ float from_bits<float>(uint32_t b) { return __uint_as_float(b); }
template <>
__device__ __forceinline__ int32_t from_bits<int32_t>(uint32_t b) { return (int32_t)b; }

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
  // the prologue: multiply, wrap, the identity at invalid slots
  __device__ __forceinline__ T contrib(T c, T wv, int ok) const {
    if (w != nullptr) {
      if (mul == kTimes) c = mul_rn(c, wv);
      else if (mul == kPlus) c = add_rn(c, wv);
      else if (mul == kSecond) c = wv;
    }
    if (wrap_bits > 0 && (mul == kTimes || mul == kPlus)) c = wrap_to(c, wrap_bits, wrap_signed);
    return ok ? c : invalid;
  }
  __device__ __forceinline__ void operator()(int64_t i, T, T& v, int& f) const {
    v = contrib(x[i], w != nullptr ? w[i] : (T)0, valid[i]);
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
  // slots i0 .. i0 + kItems - 1 (i0 a multiple of kItems; out from the
  // caching allocator, so a full run of kItems values is 8 * sizeof(Out)
  // aligned): one or two vector stores
  __device__ __forceinline__ void items(int64_t i0, const T (&v)[kItems], int64_t n) const {
    if (i0 + kItems <= n) {
      if constexpr (sizeof(Out) == 4) {
        uint32_t u[kItems];
#pragma unroll
        for (int k = 0; k < kItems; ++k) u[k] = to_bits((Out)v[k]);
        uint4* p = reinterpret_cast<uint4*>(out + i0);
        p[0] = make_uint4(u[0], u[1], u[2], u[3]);
        p[1] = make_uint4(u[4], u[5], u[6], u[7]);
        return;
      } else {
        constexpr int kPer = 4 / sizeof(Out);  // values a 32-bit word packs
        uint32_t u[kItems / kPer] = {};
#pragma unroll
        for (int k = 0; k < kItems; ++k)
          u[k / kPer] |= (uint32_t)(std::make_unsigned_t<Out>)(Out)v[k] << (8 * sizeof(Out) * (k % kPer));
        if constexpr (sizeof(Out) == 2)
          *reinterpret_cast<uint4*>(out + i0) = make_uint4(u[0], u[1], u[2], u[3]);
        else
          *reinterpret_cast<uint2*>(out + i0) = make_uint2(u[0], u[1]);
        return;
      }
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      if (i0 + k < n) out[i0 + k] = (Out)v[k];
  }
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

// ---- the single pass (Kernel C) ------------------------------------------
//
// Decoupled look-back (Merrill & Garland, "Single-pass Parallel Prefix Scan
// with Decoupled Look-back", NVIDIA 2016) on (value, flag) pairs.  A block
// takes its tiles from a ticket counter in order, so a tile only ever waits
// on tiles that running blocks hold.  Each tile publishes one 64-bit
// descriptor: its aggregate first, its inclusive prefix once it knows it.
// One warp looks back over up to 32 predecessors at a time and stops at an
// inclusive prefix or at an aggregate with its flag set: a segment starts in
// that tile, so nothing earlier reaches this one.

// descriptor: bits 0-60 the value, bit 61 has-flag, bits 62-63 the status
enum : uint32_t { kNone = 0, kAggregate = 1, kPrefix = 2 };

// The type the look-back carries.  Float sums chain in double: a segment
// that spans k tiles would otherwise round its prefix k times in float (at
// 2^23 slots in one segment that is 1.6e-6 relative, past the 1e-6 the
// port holds float add scans to), so the descriptor keeps the double with
// its 3 lowest mantissa bits dropped (61 bits).  Everything else is exact
// in its own 32 bits.
template <typename T, int OP>
struct Carry { using type = T; };
template <>
struct Carry<float, kAdd> { using type = double; };

__device__ __forceinline__ uint64_t value_bits(double v) {
  return (uint64_t)__double_as_longlong(v) >> 3;
}
__device__ __forceinline__ uint64_t value_bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ uint64_t value_bits(int32_t v) { return (uint32_t)v; }
template <typename C>
__device__ __forceinline__ C value_of(uint64_t d);
template <>
__device__ __forceinline__ double value_of<double>(uint64_t d) {
  return __longlong_as_double((long long)(d << 3));
}
template <>
__device__ __forceinline__ float value_of<float>(uint64_t d) { return __uint_as_float((uint32_t)d); }
template <>
__device__ __forceinline__ int32_t value_of<int32_t>(uint64_t d) { return (int32_t)(uint32_t)d; }
constexpr int kStages = 2;  // the ring of tiles a block keeps in flight

template <typename C>
__device__ __forceinline__ uint64_t pack(C v, int f, uint32_t status) {
  return value_bits(v) | ((uint64_t)(f != 0) << 61) | ((uint64_t)status << 62);
}
__device__ __forceinline__ uint32_t status_of(uint64_t d) { return (uint32_t)(d >> 62); }
__device__ __forceinline__ int flag_of(uint64_t d) { return (int)((d >> 61) & 1); }
__device__ __forceinline__ uint64_t value_field(uint64_t d) { return d & ((1ull << 61) - 1); }
// A descriptor is one 64-bit word that carries its own value, so nothing
// else needs ordering around it: relaxed gpu-scope accesses suffice, and a
// publish does not wait for the thread's earlier stores as a release would.
__device__ __forceinline__ void st_desc(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}
__device__ __forceinline__ uint64_t ld_desc(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// Hopper's bulk copies: global -> shared, completion counted in bytes on an
// mbarrier.  Addresses and sizes are multiples of 16 bytes.
__device__ __forceinline__ uint32_t smem(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem(bar)),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem(dst)),
      "l"(src), "r"(bytes), "r"(smem(bar))
      : "memory");
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// kItems consecutive 4-byte words (32-byte aligned), or bytes (8-aligned),
// from a stage in shared memory.
template <typename T>
__device__ __forceinline__ void ld_items(T (&d)[kItems], const T* s) {
  const uint4 a = reinterpret_cast<const uint4*>(s)[0];
  const uint4 b = reinterpret_cast<const uint4*>(s)[1];
  const uint32_t u[kItems] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int k = 0; k < kItems; ++k) d[k] = from_bits<T>(u[k]);
}
__device__ __forceinline__ void ld_items(uint8_t (&d)[kItems], const uint8_t* s) {
  const uint2 a = *reinterpret_cast<const uint2*>(s);
#pragma unroll
  for (int k = 0; k < kItems; ++k) d[k] = (uint8_t)(((k < 4 ? a.x : a.y) >> (8 * (k & 3))) & 0xff);
}
__device__ __forceinline__ void ld_items(int8_t (&d)[kItems], const int8_t* s) {
  uint8_t u[kItems];
  ld_items(u, reinterpret_cast<const uint8_t*>(s));
#pragma unroll
  for (int k = 0; k < kItems; ++k) d[k] = (int8_t)u[k];
}
// kItems 2-byte halves (16-byte aligned): one 16-byte load
__device__ __forceinline__ void ld_items(int16_t (&d)[kItems], const int16_t* s) {
  const uint4 a = *reinterpret_cast<const uint4*>(s);
  const uint32_t u[kItems / 2] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int k = 0; k < kItems; ++k) d[k] = (int16_t)(uint16_t)(u[k / 2] >> (16 * (k & 1)));
}

// Kernel C's tile: x, w, valid and flags of kTile slots.  A full tile of
// 16-byte aligned arrays arrives by bulk copy into a stage of the ring; the
// ragged last tile and unaligned views are read with plain loads.
template <typename T>
struct ContribTile {
  struct Stage {
    T x[kTile];
    T w[kTile];
    uint8_t valid[kTile];
    uint8_t flags[kTile];
  };
  ContribLoad<T> ld;
  int bulk_ok;  // every input 16-byte aligned

  __device__ __forceinline__ bool staged(int64_t t, int64_t n) const {
    return bulk_ok && (t + 1) * kTile <= n;
  }
  // thread 0: start the copies of tile t into stage sg
  __device__ __forceinline__ void issue(Stage& sg, uint64_t* bar, int64_t t, int64_t n) const {
    if (!staged(t, n)) return;
    const int64_t base = t * kTile;
    const uint32_t words = kTile * sizeof(T);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    mbar_expect(bar, (ld.w != nullptr ? 2 * words : words) + 2 * kTile);
    bulk_load(sg.x, ld.x + base, words, bar);
    if (ld.w != nullptr) bulk_load(sg.w, ld.w + base, words, bar);
    bulk_load(sg.valid, ld.valid + base, kTile, bar);
    bulk_load(sg.flags, ld.flags + base, kTile, bar);
  }
  // the contributions and flags of slots i0 .. i0 + kItems - 1 of tile t
  __device__ __forceinline__ void items(const Stage& sg, int64_t t, int i0, int64_t n,
                                        T (&v)[kItems], int (&f)[kItems], T ident) const {
    const int64_t base = t * kTile;
    if (staged(t, n)) {
      T xs[kItems], ws[kItems];
      uint8_t vs[kItems], fs[kItems];
      ld_items(xs, sg.x + i0);
      if (ld.w != nullptr) ld_items(ws, sg.w + i0);
      ld_items(vs, sg.valid + i0);
      ld_items(fs, sg.flags + i0);
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        v[k] = ld.contrib(xs[k], ld.w != nullptr ? ws[k] : (T)0, vs[k]);
        f[k] = fs[k] != 0;
      }
      return;
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      v[k] = ident;
      f[k] = 0;
      if (base + i0 + k < n) ld(base + i0 + k, ident, v[k], f[k]);
    }
  }
};

// The generic scan's tile: values (widened to the compute type T) and flags
// of kTile slots, by bulk copy when the tile is full and both arrays are
// 16-byte aligned, else by plain loads.
template <typename In, typename T>
struct ValueTile {
  struct Stage {
    In v[kTile];
    uint8_t flags[kTile];
  };
  ValueLoad<In, T> ld;
  int bulk_ok;  // values and flags 16-byte aligned

  __device__ __forceinline__ bool staged(int64_t t, int64_t n) const {
    return bulk_ok && (t + 1) * kTile <= n;
  }
  __device__ __forceinline__ void issue(Stage& sg, uint64_t* bar, int64_t t, int64_t n) const {
    if (!staged(t, n)) return;
    const int64_t base = t * kTile;
    const uint32_t bytes = kTile * sizeof(In);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    mbar_expect(bar, bytes + kTile);
    bulk_load(sg.v, ld.v + base, bytes, bar);
    bulk_load(sg.flags, ld.flags + base, kTile, bar);
  }
  __device__ __forceinline__ void items(const Stage& sg, int64_t t, int i0, int64_t n,
                                        T (&v)[kItems], int (&f)[kItems], T ident) const {
    const int64_t base = t * kTile;
    if (staged(t, n)) {
      In xs[kItems];
      uint8_t fs[kItems];
      ld_items(xs, sg.v + i0);
      ld_items(fs, sg.flags + i0);
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        v[k] = (T)xs[k];
        f[k] = fs[k] != 0;
      }
      return;
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      v[k] = ident;
      f[k] = 0;
      if (base + i0 + k < n) ld(base + i0 + k, ident, v[k], f[k]);
    }
  }
};

// Exclusive prefix of tile t (warp 0, every lane gets it).  Publishes the
// tile's aggregate, looks back, then publishes its inclusive prefix.
template <typename T, int OP>
__device__ __forceinline__ T look_back(uint64_t* desc, int64_t t, T agg_v, int agg_f) {
  const int lane = threadIdx.x & 31;
  const T ident = Monoid<T, OP>::ident();
  if (t == 0) {
    if (lane == 0) st_desc(desc, pack(agg_v, agg_f, kPrefix));
    return ident;
  }
  if (lane == 0) st_desc(desc + t, pack(agg_v, agg_f, kAggregate));
  T run_v = ident;  // the predecessors combined so far, in array order
  int run_f = 0;
  for (int64_t end = t;; end -= 32) {
    const int64_t i = end - 1 - lane;  // lane 0 the nearest predecessor
    uint64_t d = i >= 0 ? ld_desc(desc + i) : pack(ident, 0, kPrefix);
    unsigned stops, need;
    for (;;) {
      const uint32_t status = status_of(d);
      const bool stop = status == kPrefix || (status == kAggregate && flag_of(d));
      stops = __ballot_sync(kFull, stop);
      const unsigned ready = __ballot_sync(kFull, status != kNone);
      // lanes up to the nearest stop, or all 32
      need = stops ? ((stops & (0u - stops)) << 1) - 1u : kFull;
      if ((ready & need) == need) break;
      if (status == kNone) d = ld_desc(desc + i);
    }
    T wv = ident;
    int wf = 0;
    if ((need >> lane) & 1) {
      wv = value_of<T>(value_field(d));
      wf = flag_of(d);
    }
    // combine the window, later lanes being earlier tiles
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const T ov = __shfl_down_sync(kFull, wv, off);
      const int of = __shfl_down_sync(kFull, wf, off);
      if (lane + off < 32) combine<T, OP>(ov, of, wv, wf);
    }
    wv = __shfl_sync(kFull, wv, 0);
    wf = __shfl_sync(kFull, wf, 0);
    combine<T, OP>(wv, wf, run_v, run_f);
    if (stops) break;
  }
  if (lane == 0) {
    T inc_v = agg_v;
    int inc_f = agg_f;
    combine<T, OP>(run_v, run_f, inc_v, inc_f);
    st_desc(desc + t, pack(inc_v, inc_f, kPrefix));
  }
  return run_v;
}

// Persistent blocks, each with a ring of kStages tiles: the next ticket's
// copy is in flight while this tile scans.
template <typename T, int OP, class Tile, class Store>
__global__ void __launch_bounds__(kThreads, 5)  // 5 blocks an SM, as the ring's shared memory allows
    scan_onepass(Tile tl, Store st, int64_t n, int64_t ntiles, uint64_t* desc,
                 unsigned* ticket) {
  __shared__ __align__(128) typename Tile::Stage s_stage[kStages];
  __shared__ uint64_t s_bar[kStages];
  __shared__ int64_t s_tile[kStages];
  using C = typename Carry<T, OP>::type;
  __shared__ T s_wv[kWarps + 1];
  __shared__ int s_wf[kWarps + 1];
  __shared__ C s_prefix;
  const T ident = Monoid<T, OP>::ident();
  if (threadIdx.x == 0) {
    for (int k = 0; k < kStages; ++k) mbar_init(&s_bar[k]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    s_tile[0] = atomicAdd(ticket, 1u);
    if (s_tile[0] < ntiles) tl.issue(s_stage[0], &s_bar[0], s_tile[0], n);
  }
  __syncthreads();
  uint32_t parity = 0;  // bit k: the phase stage k waits for next
  for (int sg = 0;; sg ^= 1) {
    const int64_t t = s_tile[sg];
    if (t >= ntiles) break;
    if (threadIdx.x == 0) {
      const int64_t nt = atomicAdd(ticket, 1u);
      s_tile[sg ^ 1] = nt;
      if (nt < ntiles) tl.issue(s_stage[sg ^ 1], &s_bar[sg ^ 1], nt, n);
    }
    if (tl.staged(t, n)) {
      mbar_wait(&s_bar[sg], (parity >> sg) & 1u);
      parity ^= 1u << sg;
    }
    T v[kItems];
    int f[kItems];
    const int i0 = threadIdx.x * kItems;
    tl.items(s_stage[sg], t, i0, n, v, f, ident);
    T rv = ident;
    int rf = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      T bv = v[k];
      int bf = f[k];
      combine<T, OP>(rv, rf, bv, bf);
      rv = bv;
      rf = bf;
    }
    T ev, tv;
    int ef, tf;
    block_exclusive<T, OP>(rv, rf, ev, ef, tv, tf, s_wv, s_wf);
    if (threadIdx.x < 32) {
      const C p = look_back<C, OP>(desc, t, (C)tv, tf);
      if (threadIdx.x == 0) s_prefix = p;
    }
    __syncthreads();
    C ec = (C)ev;
    combine<C, OP>(s_prefix, 0, ec, ef);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      C vc = (C)v[k];
      combine<C, OP>(ec, ef, vc, f[k]);
      ec = vc;
      ef = f[k];
      v[k] = (T)vc;
    }
    st.items(t * kTile + i0, v, n);
    __syncthreads();  // the stage and s_prefix are free again
  }
}

template <typename T, int OP, class Tile, class Store>
int run_onepass(const Tile& tl, const Store& st, int64_t n, void* tile_state, cudaStream_t s) {
  if (n > 0) {
    const int64_t ntiles = (n + kTile - 1) / kTile;
    auto kernel = scan_onepass<T, OP, Tile, Store>;
    static int per_sm = 0;  // resident blocks per SM, once per instantiation
    if (per_sm == 0) cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    int dev = 0, sms = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    int64_t grid = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
    if (grid > ntiles) grid = ntiles;
    uint64_t* desc = (uint64_t*)tile_state;
    kernel<<<(unsigned)grid, kThreads, 0, s>>>(tl, st, n, ntiles, desc, (unsigned*)(desc + ntiles));
  }
  return (int)cudaGetLastError();
}

template <typename T>
int contrib_typed(const void* x, const void* w, const void* valid, const void* flags, void* out,
                  void* tile_state, int64_t n, int op, int mul, int wrap_bits, int wrap_signed,
                  double invalid, cudaStream_t s) {
  const ContribLoad<T> ld{(const T*)x, (const T*)w, (const uint8_t*)valid,
                          (const uint8_t*)flags, mul, wrap_bits, wrap_signed, (T)invalid};
  const int bulk_ok = aligned16(x) && (w == nullptr || aligned16(w)) && aligned16(valid) &&
                      aligned16(flags);
  const ContribTile<T> tl{ld, bulk_ok};
  const ValueStore<T, T> st{(T*)out};
  switch (op) {
    case kAdd: return run_onepass<T, kAdd>(tl, st, n, tile_state, s);
    case kMin: return run_onepass<T, kMin>(tl, st, n, tile_state, s);
    case kMax: return run_onepass<T, kMax>(tl, st, n, tile_state, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename In, typename T>
int scan_typed(const void* values, const void* flags, void* out, void* tile_state, int64_t n, int op,
               cudaStream_t s) {
  const ValueLoad<In, T> ld{(const In*)values, (const uint8_t*)flags};
  const ValueTile<In, T> tl{ld, aligned16(values) && aligned16(flags)};
  const ValueStore<In, T> st{(In*)out};
  switch (op) {
    case kAdd: return run_onepass<T, kAdd>(tl, st, n, tile_state, s);
    case kMin: return run_onepass<T, kMin>(tl, st, n, tile_state, s);
    case kMax: return run_onepass<T, kMax>(tl, st, n, tile_state, s);
    case kFill: return run_onepass<T, kFill>(tl, st, n, tile_state, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int gb_segscan_tile() { return kTile; }

// op: 0 add, 1 min, 2 max.  mul: 0 times, 1 plus, 2 second, 3 first
// (ignored when w is null).  wrap_bits 0 = no wrap.  invalid: the value
// written at invalid slots (the identity in the IO type's range).
// tile_state: ceil(n / tile) + 1 zeroed 64-bit words (the tiles'
// descriptors, then the ticket counter).
extern "C" int gb_segscan_contrib(const void* x, const void* w, const void* valid,
                                  const void* flags, void* out, void* tile_state, int64_t n,
                                  int is_int, int op, int mul, int wrap_bits, int wrap_signed,
                                  double invalid, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_int)
    return contrib_typed<int32_t>(x, w, valid, flags, out, tile_state, n, op, mul, wrap_bits,
                                  wrap_signed, invalid, s);
  return contrib_typed<float>(x, w, valid, flags, out, tile_state, n, op, mul, wrap_bits,
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
// out: a fresh allocation (its runs of kItems values take vector stores).
// tile_state: ceil(n / tile) + 1 zeroed 64-bit words, as for
// gb_segscan_contrib.
extern "C" int gb_segscan(const void* values, const void* flags, void* out, void* tile_state,
                          int64_t n, int dtype, int op, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return scan_typed<float, float>(values, flags, out, tile_state, n, op, s);
    case 1: return scan_typed<int32_t, int32_t>(values, flags, out, tile_state, n, op, s);
    case 2: return scan_typed<int16_t, int32_t>(values, flags, out, tile_state, n, op, s);
    case 3: return scan_typed<int8_t, int32_t>(values, flags, out, tile_state, n, op, s);
    case 4: return scan_typed<uint8_t, int32_t>(values, flags, out, tile_state, n, op, s);
  }
  return (int)cudaErrorInvalidValue;
}
