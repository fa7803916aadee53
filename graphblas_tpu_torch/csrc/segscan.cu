// Kernels C and S, and the generic scan: inclusive segmented scans with
// fused prologue/epilogue.
//
// Kernel C (segscan_contrib) replaces
//   graphblas_tpu/ops/pallas_scan.py:segmented_scan_contrib (_fused_kernel):
//   per edge a semiring multiply (times, plus, second, first, or x alone when
//   w is absent), an optional wrap to 8 or 16 bits, the monoid identity at
//   invalid slots, then a segmented add/min/max inclusive scan.
// Kernel C with a fused gather (segscan_contrib_gather): Kernel C whose value
//   channel is x[idx[p]], read from the n-long x inside the tile, in place
//   of an e_pad-long xe that routes built beforehand.  The SpMV engine
//   passes the plan's src_dst_order as idx.  Everything else is C's.
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
// kernel adds the is_last byte and the state word in, and a second word out
// (19 B a slot for SSSP with its changed flags); the generic scan reads only
// the values and the flag bytes.  There is no arithmetic to speak of.  The
// fused gather streams the index in xe's place (C's 14 B a slot) and reads
// x's 4 B a vertex at the least: (14 e_pad + 4 n) B; its random reads of x
// move 32-byte sectors, from L2 where x fits there.
//
// The TPU kernels carry the running (value, flag) pair from tile to tile
// through a sequential grid with an SMEM carry.  Hopper blocks run in no
// order, so the carry has to cross blocks.
//
// All three are one launch each, a single pass with decoupled look-back
// (below, "the single pass"): each input byte crosses memory once.
// Persistent blocks take tiles (2048 slots; S's 1024) from a ticket
// counter; a full tile of aligned inputs arrives in shared memory by
// Hopper's bulk copy (cp.async.bulk, an mbarrier counting its bytes) while
// the block scans the tile before it; a ragged or unaligned tile is read
// with plain loads in the same kernel.  The carry goes through one 64-bit descriptor a tile.  Each
// kernel is a Tile (its loads and prologue; the ring of stages lives in
// dynamic shared memory, sized by the Tile) and a Store (its epilogue).
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 3, 2^23
// slots, flags at 1/16): C add/times 0.064 ms against the 0.035 ms bound,
// where three launches of reduce-then-scan took 0.097; with no flag at all,
// the longest look-back, 0.077-0.081 ms.  A variant that read full tiles by
// 16-byte loads into registers in place of the bulk copies took 0.077-0.084
// ms with flags.
//
// Kernel C with a fused gather: C's tile, 2048 slots of 256 threads, its
// ring and its order of combination, so its output equals C's on
// x[idx] bit for bit, float sums included.  The ring streams the int32
// index in place of xe (still 14 B a slot); each thread then reads its
// kItems values x[idx] from the n-long x in the manner of Kernel G: all its
// loads issued before any is used, through the read-only path under an
// L2::evict_last policy, so that an x smaller than L2 stays resident while
// the streams pass; a slot whose valid byte is 0 reads nothing (its
// contribution is the identity).  The gather's latency is hidden by the
// other resident blocks of the SM, not by software pipelining: holding the
// next tile's values across the scan's barriers would take 8 more
// registers a thread, and the ring already has the next tile's streams in
// flight while this one scans.  4 blocks an SM (64 registers a thread), not
// C's 5: capped at 48 registers the tile spilled 8-12 bytes a thread and
// took 0.724-0.751 ms at 2^26 slots over x of 2^21 (random idx), against
// 0.675-0.683 ms at 4 blocks without spills (NVIDIA H100 80GB HBM3, 700 W).
//
// The generic scan's tile: values (f32, int32, int16, int8 or uint8) and
// flag bytes by bulk copy, 9 B a slot in f32 or int32, 3 B in int8; narrow
// integers widen to int32 in registers and pack back into one vector store
// a thread.  Float add carries in double across tiles, as C's does.
// Measured as C: f32 add 0.047-0.050 ms against the 0.0225 ms bound; int8
// add 0.046-0.063 (bound 0.0075), held, like C, by each tile's latency
// rather than its bytes.
//
// Kernel S's tile stages x, w (SSSP), valid, flags, is_last and the state
// word: 11 B a slot for BFS, 15 B for SSSP.  Its blocks are 128 threads, so
// a tile is 1024 slots and SSSP's two stages take 30 KB of shared memory (7
// blocks an SM), BFS's 22 KB (9).  2048-slot tiles of 256 threads (60 KB, 3
// blocks an SM) ran 2.5-8% slower (tools/probe_kernels.py, 2^23 slots, on an
// NVIDIA H100 80GB HBM3 at 700 W: BFS 0.086 ms against 0.079, SSSP 0.078
// against 0.076, the bound 0.048).  The tile hands each thread's is_last
// bytes and state words to the store in registers beside the scanned
// values; the store writes the new state and the frontier or changed flags
// by vector stores, and with fr_reduce each thread ORs its tiles' changes
// and the block raises the one device flag once, at exit.
//
// Min and max propagate NaN and put -0.0 below +0.0 (PTX min.NaN / max.NaN),
// as jnp.minimum / jnp.maximum do in the reference.
//
// Each thread scans kItems consecutive slots, then warp shuffles and one
// warp-total pass combine the threads.  Float arithmetic uses the _rn
// intrinsics so no multiply is contracted into an FMA: products and sums
// round exactly as in the plain PyTorch version.  Offsets are 64-bit.
// Nothing is allocated and nothing synchronises the host: the wrapper
// passes the zeroed scratch.

#include <cuda_runtime.h>
#include <limits.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "onepass.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
// Kernel S's blocks: 128 threads, 1024-slot tiles (its stages are wider)
constexpr int kStateThreads = 128;
constexpr int kStateTile = kStateThreads * kItems;
constexpr unsigned kFull = 0xffffffffu;
// np.float32(3.4e38) / 4, as graphblas_tpu/ops/pallas_scan.py:STATE_BIG
constexpr float kStateBig = 3.4e38f / 4.0f;

enum { kAdd = 0, kMin = 1, kMax = 2, kFill = 3 };
enum { kTimes = 0, kPlus = 1, kSecond = 2, kFirst = 3 };

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
    if (OP == kMin) return min_nan(a, b);
    return max_nan(a, b);
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
template <>
__device__ __forceinline__ uint32_t from_bits<uint32_t>(uint32_t b) { return b; }

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
  __device__ __forceinline__ void operator()(int64_t i, T& v, int& f) const {
    v = contrib(x[i], w != nullptr ? w[i] : (T)0, valid[i]);
    f = flags[i] != 0;
  }
};

// The generic scan: the value widened to the compute type, and its flag.
template <typename In, typename T>
struct ValueLoad {
  const In* v;
  const uint8_t* flags;
  __device__ __forceinline__ void operator()(int64_t i, T& ov, int& of) const {
    ov = (T)v[i];
    of = flags[i] != 0;
  }
};

// ---- stores: a thread's kItems scanned values -> outputs ------------------
//
// items(i0, v, e, n) writes slots i0 .. i0 + kItems - 1 (i0 a multiple of
// kItems; the outputs are fresh allocations of the caching allocator, so a
// full run of kItems 4-byte values is 32-byte aligned) from the scanned
// values v and the tile's epilogue inputs e, and returns 1 if a slot
// "changed"; block_done(any) runs once a block, in thread 0, with the
// block's OR of those returns.

// The tile's epilogue inputs: nothing (C and the generic scan), or S's
// is_last bytes and state words of the thread's slots.
struct NoEpi {};
struct StateEpi {
  uint8_t last[kItems];
  uint32_t state[kItems];  // levels (int32) or dist (f32), as bits
};

// kItems 32-bit words to out + i0: two 16-byte stores, or the slots below n
__device__ __forceinline__ void st_items(uint32_t* out, const uint32_t (&u)[kItems], int64_t i0, int64_t n) {
  if (i0 + kItems <= n) {
    uint4* p = reinterpret_cast<uint4*>(out + i0);
    p[0] = make_uint4(u[0], u[1], u[2], u[3]);
    p[1] = make_uint4(u[4], u[5], u[6], u[7]);
    return;
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    if (i0 + k < n) out[i0 + k] = u[k];
}

// The scanned value in the IO type (narrow integers truncate modulo 2^k).
template <typename Out, typename T>
struct ValueStore {
  Out* out;
  __device__ __forceinline__ void block_done(int) const {}
  __device__ __forceinline__ int items(int64_t i0, const T (&v)[kItems], const NoEpi&, int64_t n) const {
    if constexpr (sizeof(Out) == 4) {
      uint32_t u[kItems];
#pragma unroll
      for (int k = 0; k < kItems; ++k) u[k] = to_bits((Out)v[k]);
      st_items(reinterpret_cast<uint32_t*>(out), u, i0, n);
    } else if (i0 + kItems <= n) {
      constexpr int kPer = 4 / sizeof(Out);  // values a 32-bit word packs
      uint32_t u[kItems / kPer] = {};
#pragma unroll
      for (int k = 0; k < kItems; ++k)
        u[k / kPer] |= (uint32_t)(std::make_unsigned_t<Out>)(Out)v[k] << (8 * sizeof(Out) * (k % kPer));
      if constexpr (sizeof(Out) == 2)
        *reinterpret_cast<uint4*>(out + i0) = make_uint4(u[0], u[1], u[2], u[3]);
      else
        *reinterpret_cast<uint2*>(out + i0) = make_uint2(u[0], u[1]);
    } else {
#pragma unroll
      for (int k = 0; k < kItems; ++k)
        if (i0 + k < n) out[i0 + k] = (Out)v[k];
    }
    return 0;
  }
};

// BFS: at a last slot whose max reaches above 0, an unreached vertex (level
// < 0) takes level depth + 1 and joins the frontier.
struct BfsStore {
  int depth;
  int32_t* out_levels;
  float* frontier;
  __device__ __forceinline__ void block_done(int) const {}
  __device__ __forceinline__ int items(int64_t i0, const float (&v)[kItems], const StateEpi& e, int64_t n) const {
    uint32_t lv[kItems], fr[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int32_t l = (int32_t)e.state[k];
      const bool nxt = e.last[k] && v[k] > 0.f && l < 0;
      lv[k] = (uint32_t)(nxt ? depth + 1 : l);
      fr[k] = nxt ? __float_as_uint(1.f) : 0u;
    }
    st_items(reinterpret_cast<uint32_t*>(out_levels), lv, i0, n);
    st_items(reinterpret_cast<uint32_t*>(frontier), fr, i0, n);
    return 0;
  }
};

// SSSP: min(dist, scan) at last slots, STATE_BIG elsewhere (the donor
// invariant the loop route relies on); changed = the new distance is below
// the old, per slot or ORed into one device flag.
struct SsspStore {
  float* out_dist;
  float* changed;        // per-slot flags, or nullptr
  int32_t* any_changed;  // one device flag (fr_reduce), or nullptr
  __device__ __forceinline__ void block_done(int any) const {
    if (any_changed != nullptr && any) atomicMax(any_changed, 1);
  }
  __device__ __forceinline__ int items(int64_t i0, const float (&v)[kItems], const StateEpi& e, int64_t n) const {
    uint32_t nd[kItems], ch[kItems];
    int any = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const float d = __uint_as_float(e.state[k]);
      const float nw = e.last[k] ? min_nan(d, v[k]) : kStateBig;
      const bool c = nw < d && i0 + k < n;
      nd[k] = __float_as_uint(nw);
      ch[k] = c ? __float_as_uint(1.f) : 0u;
      any |= c;
    }
    st_items(reinterpret_cast<uint32_t*>(out_dist), nd, i0, n);
    if (changed != nullptr) st_items(reinterpret_cast<uint32_t*>(changed), ch, i0, n);
    return any;
  }
};

// ---- block building blocks ------------------------------------------------

// Exclusive scan of one (v, f) pair per thread across a block of NW warps;
// also gives the block total.  Ends with a barrier, so the caller may reuse
// s_w*.
template <typename T, int OP, int NW>
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
    for (int k = 0; k < NW; ++k) {
      T wv = s_wv[k];
      int wf = s_wf[k];
      s_wv[k] = rv;
      s_wf[k] = rf;
      combine<T, OP>(rv, rf, wv, wf);
      rv = wv;
      rf = wf;
    }
    s_wv[NW] = rv;
    s_wf[NW] = rf;
  }
  __syncthreads();
  combine<T, OP>(s_wv[wid], s_wf[wid], xv, xf);
  ex_v = xv;
  ex_f = xf;
  tot_v = s_wv[NW];
  tot_f = s_wf[NW];
  __syncthreads();
}

// ---- the single pass --------------------------------------------------------
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
  using Epi = NoEpi;
  static constexpr int kBlock = kThreads, kSlots = kTile;
  static constexpr int kMinBlocks = 5;  // as the ring's 40 KB allow
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
                                        T (&v)[kItems], int (&f)[kItems], Epi&, T ident) const {
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
      if (base + i0 + k < n) ld(base + i0 + k, v[k], f[k]);
    }
  }
};

// Kernel C's tile with a fused gather: idx, w, valid and flags of kTile
// slots staged as ContribTile stages x; x[idx] read from global memory.
template <typename T>
struct GatherContribTile {
  struct Stage {
    int32_t idx[kTile];
    T w[kTile];
    uint8_t valid[kTile];
    uint8_t flags[kTile];
  };
  using Epi = NoEpi;
  static constexpr int kBlock = kThreads, kSlots = kTile;
  static constexpr int kMinBlocks = 4;  // 64 registers a thread: no spills
  ContribLoad<T> ld;   // ld.x: the gather's source, indexed by idx
  const int32_t* idx;  // idx[p] in [0, len(x)) wherever valid[p]
  int bulk_ok;         // idx, w, valid and flags 16-byte aligned

  __device__ __forceinline__ bool staged(int64_t t, int64_t n) const {
    return bulk_ok && (t + 1) * kTile <= n;
  }
  __device__ __forceinline__ void issue(Stage& sg, uint64_t* bar, int64_t t, int64_t n) const {
    if (!staged(t, n)) return;
    const int64_t base = t * kTile;
    const uint32_t words = kTile * 4;
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    mbar_expect(bar, (ld.w != nullptr ? 2 * words : words) + 2 * kTile);
    bulk_load(sg.idx, idx + base, words, bar);
    if (ld.w != nullptr) bulk_load(sg.w, ld.w + base, words, bar);
    bulk_load(sg.valid, ld.valid + base, kTile, bar);
    bulk_load(sg.flags, ld.flags + base, kTile, bar);
  }
  __device__ __forceinline__ T source(int32_t j, uint64_t pol) const {
    return from_bits<T>(ld_keep(reinterpret_cast<const uint32_t*>(ld.x) + j, pol));
  }
  __device__ __forceinline__ void items(const Stage& sg, int64_t t, int i0, int64_t n,
                                        T (&v)[kItems], int (&f)[kItems], Epi&, T ident) const {
    const uint64_t pol = evict_last_policy();
    const int64_t base = t * kTile;
    if (staged(t, n)) {
      int32_t js[kItems];
      uint8_t vs[kItems];
      ld_items(js, sg.idx + i0);
      ld_items(vs, sg.valid + i0);
      T xs[kItems];
#pragma unroll
      for (int k = 0; k < kItems; ++k) xs[k] = vs[k] ? source(js[k], pol) : (T)0;
      T ws[kItems];
      uint8_t fs[kItems];
      if (ld.w != nullptr) ld_items(ws, sg.w + i0);
      ld_items(fs, sg.flags + i0);
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        v[k] = ld.contrib(xs[k], ld.w != nullptr ? ws[k] : (T)0, vs[k]);
        f[k] = fs[k] != 0;
      }
      return;
    }
    int ok[kItems];
    T xs[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int64_t g = base + i0 + k;
      ok[k] = g < n ? ld.valid[g] : 0;
      xs[k] = ok[k] ? source(idx[g], pol) : (T)0;
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int64_t g = base + i0 + k;
      v[k] = ident;
      f[k] = 0;
      if (g < n) {
        v[k] = ld.contrib(xs[k], ld.w != nullptr ? ld.w[g] : (T)0, ok[k]);
        f[k] = ld.flags[g] != 0;
      }
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
  using Epi = NoEpi;
  static constexpr int kBlock = kThreads, kSlots = kTile;
  static constexpr int kMinBlocks = 5;
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
                                        T (&v)[kItems], int (&f)[kItems], Epi&, T ident) const {
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
      if (base + i0 + k < n) ld(base + i0 + k, v[k], f[k]);
    }
  }
};

// Kernel S's stage: the scan's inputs and the epilogue's, W: with w (SSSP's
// x + w).  Every array is a multiple of 16 bytes long, so each starts on a
// 16-byte boundary for the bulk copies.
template <bool W>
struct StateStage {
  float x[kStateTile];
  uint32_t state[kStateTile];
  uint8_t valid[kStateTile];
  uint8_t flags[kStateTile];
  uint8_t is_last[kStateTile];
};
template <>
struct StateStage<true> {
  float x[kStateTile];
  float w[kStateTile];
  uint32_t state[kStateTile];
  uint8_t valid[kStateTile];
  uint8_t flags[kStateTile];
  uint8_t is_last[kStateTile];
};

// Kernel S's tile: the prologue (x, or x + w rounded once, the identity at
// invalid slots) and the flags, with is_last and the state handed to the
// store; by bulk copy when the tile is full and every input is 16-byte
// aligned, else by plain loads.
template <bool W>
struct StateTile {
  static constexpr int kBlock = kStateThreads, kSlots = kStateTile;
  using Stage = StateStage<W>;
  using Epi = StateEpi;
  // resident blocks an SM that the ring allows (227 KB of shared memory an
  // SM; a block also takes 1 KB reserved and its static arrays): 7 with w,
  // 9 without
  static constexpr int kMinBlocks = (227 * 1024) / (kStages * (int)sizeof(Stage) + 1280);
  const float* x;
  const float* w;  // used only when W
  const uint8_t* valid;
  const uint8_t* flags;
  const uint8_t* is_last;
  const uint32_t* state;
  int bulk_ok;

  __device__ __forceinline__ bool staged(int64_t t, int64_t n) const {
    return bulk_ok && (t + 1) * kSlots <= n;
  }
  __device__ __forceinline__ void issue(Stage& sg, uint64_t* bar, int64_t t, int64_t n) const {
    if (!staged(t, n)) return;
    const int64_t base = t * kSlots;
    const uint32_t words = kSlots * 4;
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    mbar_expect(bar, (W ? 3 : 2) * words + 3 * kSlots);
    bulk_load(sg.x, x + base, words, bar);
    if constexpr (W) bulk_load(sg.w, w + base, words, bar);
    bulk_load(sg.state, state + base, words, bar);
    bulk_load(sg.valid, valid + base, kSlots, bar);
    bulk_load(sg.flags, flags + base, kSlots, bar);
    bulk_load(sg.is_last, is_last + base, kSlots, bar);
  }
  __device__ __forceinline__ static float contrib(float c, float wv, int ok, float ident) {
    if constexpr (W) c = __fadd_rn(c, wv);
    return ok ? c : ident;
  }
  __device__ __forceinline__ void items(const Stage& sg, int64_t t, int i0, int64_t n, float (&v)[kItems],
                                        int (&f)[kItems], Epi& e, float ident) const {
    const int64_t base = t * kSlots;
    if (staged(t, n)) {
      float xs[kItems], ws[kItems];
      uint8_t vs[kItems], fs[kItems];
      ld_items(xs, sg.x + i0);
      if constexpr (W) ld_items(ws, sg.w + i0);
      ld_items(vs, sg.valid + i0);
      ld_items(fs, sg.flags + i0);
      ld_items(e.last, sg.is_last + i0);
      ld_items(e.state, sg.state + i0);
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        v[k] = contrib(xs[k], W ? ws[k] : 0.f, vs[k], ident);
        f[k] = fs[k] != 0;
      }
      return;
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int64_t g = base + i0 + k;
      v[k] = ident;
      f[k] = 0;
      e.last[k] = 0;
      e.state[k] = 0;
      if (g < n) {
        v[k] = contrib(x[g], W ? w[g] : 0.f, valid[g], ident);
        f[k] = flags[g] != 0;
        e.last[k] = is_last[g];
        e.state[k] = state[g];
      }
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

// Persistent blocks, each with a ring of kStages tiles in dynamic shared
// memory: the next ticket's copy is in flight while this tile scans.
template <typename T, int OP, class Tile, class Store>
__global__ void __launch_bounds__(Tile::kBlock, Tile::kMinBlocks)
    scan_onepass(Tile tl, Store st, int64_t n, int64_t ntiles, uint64_t* desc,
                 unsigned* ticket) {
  extern __shared__ __align__(128) unsigned char s_ring[];
  typename Tile::Stage* s_stage = reinterpret_cast<typename Tile::Stage*>(s_ring);
  __shared__ uint64_t s_bar[kStages];
  __shared__ int64_t s_tile[kStages];
  using C = typename Carry<T, OP>::type;
  constexpr int kBlockWarps = Tile::kBlock / 32;
  __shared__ T s_wv[kBlockWarps + 1];
  __shared__ int s_wf[kBlockWarps + 1];
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
  int any = 0;          // the store's "changed", over this thread's tiles
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
    typename Tile::Epi e;
    const int i0 = threadIdx.x * kItems;
    tl.items(s_stage[sg], t, i0, n, v, f, e, ident);
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
    block_exclusive<T, OP, kBlockWarps>(rv, rf, ev, ef, tv, tf, s_wv, s_wf);
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
    any |= st.items(t * Tile::kSlots + i0, v, e, n);
    __syncthreads();  // the stage and s_prefix are free again
  }
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) st.block_done(any);
}

template <typename T, int OP, class Tile, class Store>
int run_onepass(const Tile& tl, const Store& st, int64_t n, void* tile_state, cudaStream_t s) {
  if (n > 0) {
    const int64_t ntiles = (n + Tile::kSlots - 1) / Tile::kSlots;
    auto kernel = scan_onepass<T, OP, Tile, Store>;
    constexpr int ring = kStages * sizeof(typename Tile::Stage);
    static int per_sm = 0;  // resident blocks per SM, once per instantiation
    if (per_sm == 0) {
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, ring);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, Tile::kBlock, ring);
    }
    int dev = 0, sms = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    int64_t grid = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
    if (grid > ntiles) grid = ntiles;
    uint64_t* desc = (uint64_t*)tile_state;
    kernel<<<(unsigned)grid, Tile::kBlock, ring, s>>>(tl, st, n, ntiles, desc, (unsigned*)(desc + ntiles));
  }
  return (int)cudaGetLastError();
}

template <typename T, class Tile>
int contrib_ops(const Tile& tl, void* out, void* tile_state, int64_t n, int op, cudaStream_t s) {
  const ValueStore<T, T> st{(T*)out};
  switch (op) {
    case kAdd: return run_onepass<T, kAdd>(tl, st, n, tile_state, s);
    case kMin: return run_onepass<T, kMin>(tl, st, n, tile_state, s);
    case kMax: return run_onepass<T, kMax>(tl, st, n, tile_state, s);
  }
  return (int)cudaErrorInvalidValue;
}

// idx == nullptr: Kernel C over xe = x; else the fused gather, xe = x[idx].
template <typename T>
int contrib_typed(const void* x, const void* idx, const void* w, const void* valid,
                  const void* flags, void* out, void* tile_state, int64_t n, int op, int mul,
                  int wrap_bits, int wrap_signed, double invalid, cudaStream_t s) {
  const ContribLoad<T> ld{(const T*)x, (const T*)w, (const uint8_t*)valid,
                          (const uint8_t*)flags, mul, wrap_bits, wrap_signed, (T)invalid};
  const int bulk_ok = (w == nullptr || aligned16(w)) && aligned16(valid) && aligned16(flags);
  if (idx == nullptr)
    return contrib_ops<T>(ContribTile<T>{ld, bulk_ok && aligned16(x)}, out, tile_state, n, op, s);
  return contrib_ops<T>(GatherContribTile<T>{ld, (const int32_t*)idx, bulk_ok && aligned16(idx)},
                        out, tile_state, n, op, s);
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
extern "C" int gb_segscan_state_tile() { return kStateTile; }

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
    return contrib_typed<int32_t>(x, nullptr, w, valid, flags, out, tile_state, n, op, mul,
                                  wrap_bits, wrap_signed, invalid, s);
  return contrib_typed<float>(x, nullptr, w, valid, flags, out, tile_state, n, op, mul, wrap_bits,
                              wrap_signed, invalid, s);
}

// Kernel C over xe[p] = x[idx[p]], p < n: x holds the gather's source (any
// length; idx[p] must index it wherever valid[p] is set), idx, w, valid,
// flags and out have n slots.  The other arguments as gb_segscan_contrib's.
extern "C" int gb_segscan_contrib_gather(const void* x, const void* idx, const void* w,
                                         const void* valid, const void* flags, void* out,
                                         void* tile_state, int64_t n, int is_int, int op, int mul,
                                         int wrap_bits, int wrap_signed, double invalid,
                                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_int)
    return contrib_typed<int32_t>(x, idx, w, valid, flags, out, tile_state, n, op, mul,
                                  wrap_bits, wrap_signed, invalid, s);
  return contrib_typed<float>(x, idx, w, valid, flags, out, tile_state, n, op, mul, wrap_bits,
                              wrap_signed, invalid, s);
}

// mode 0 = BFS (state int32 levels; out_fr = frontier f32),
// mode 1 = SSSP (state f32 dist; out_fr = changed f32, or null with
// any_changed pointing at one int32 that the kernel raises to 1).  w may be
// null (the contribution is x alone).  tile_state: ceil(n /
// gb_segscan_state_tile()) + 1 zeroed 64-bit words.  The outputs are fresh
// allocations.
extern "C" int gb_segscan_state(int mode, const void* x, const void* w, const void* valid,
                                const void* flags, const void* is_last, const void* state,
                                int depth, void* out_state, void* out_fr, void* any_changed,
                                void* tile_state, int64_t n, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int bulk_ok = aligned16(x) && (w == nullptr || aligned16(w)) && aligned16(valid) &&
                      aligned16(flags) && aligned16(is_last) && aligned16(state);
  const float* xf = (const float*)x;
  const float* wf = (const float*)w;
  const uint8_t* vb = (const uint8_t*)valid;
  const uint8_t* fb = (const uint8_t*)flags;
  const uint8_t* lb = (const uint8_t*)is_last;
  const uint32_t* sb = (const uint32_t*)state;
  if (mode == 0) {
    const BfsStore st{depth, (int32_t*)out_state, (float*)out_fr};
    if (w != nullptr)
      return run_onepass<float, kMax>(StateTile<true>{xf, wf, vb, fb, lb, sb, bulk_ok}, st, n, tile_state, s);
    return run_onepass<float, kMax>(StateTile<false>{xf, wf, vb, fb, lb, sb, bulk_ok}, st, n, tile_state, s);
  }
  const SsspStore st{(float*)out_state, (float*)out_fr, (int32_t*)any_changed};
  if (w != nullptr)
    return run_onepass<float, kMin>(StateTile<true>{xf, wf, vb, fb, lb, sb, bulk_ok}, st, n, tile_state, s);
  return run_onepass<float, kMin>(StateTile<false>{xf, wf, vb, fb, lb, sb, bulk_ok}, st, n, tile_state, s);
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
