// The SpMV engine's k-wide product: Y = A (.) X for a dense n x k X (k <= 8),
// in float or double, over an SpmvPlan's dst-order slots.
//
// Kernel C with a fused gather (csrc/segscan.cu) computes one column: it
// streams src_dst_order, the weights and the valid and flag bytes, reads
// x[idx] by index and scans.  Run k times, it would stream the plan k times
// and read x's rows one 4-byte word at a time.  This kernel streams the plan
// once for all k columns, reads a row's k values together (4 columns of
// double: one 32-byte sector), and writes only the segment totals: each dst
// segment's last slot writes its row of Y and of Y's structure, so the
// collect over n slots is fused in, and no e_pad x k scan exists.
//
// Work a block: 256 threads as (slot group, column) pairs, KP = k rounded up
// to a power of two columns, 256 / KP groups of 8 KP consecutive slots: a
// tile is 2048 slots at every k, as Kernel C's.  The tile's idx, w, valid
// and flag bytes arrive by bulk copy (a ring of two stages, as Kernel C's)
// and the KP lanes of a group read them from shared memory together.  A
// thread reads x's structure byte of a slot's row first and its value only
// where present (a frontier is mostly absent), 8 slots' loads in flight.
//
// Only segment ends are written, so a thread never holds its slots' values:
// one pass over its slots keeps the run since the last segment start, and
// writes each segment that starts and ends among them at its end.  Its
// first end, when the segment started before its slots, waits for the
// thread's exclusive prefix: the groups' runs combine by warp shuffles KP
// lanes apart and one pass over the warps' totals, and the tile's prefix
// comes by decoupled look-back.
//
// The scan element is (value, segment flag, presence): presence is "some
// valid slot with x present in this column", the structure of Y.  The carry
// crosses tiles by decoupled look-back (Merrill & Garland, as segscan.cu):
// a tile publishes one 64-bit status word (status, flag, KP presence bits)
// and its KP carried values in a separate array, written before the status
// with a fence between, read after it with a fence between (message passing
// by fences; the values' accesses are relaxed gpu-scope, so no stale L1 line
// is read).  Float sums carry in double across tiles, as Kernel C's.
//
// Rows: a segment-last slot writes row seg_vertex[o], o the number of flags
// up to it less one: tile_base[t] (the flags before tile t, computed once a
// plan by the caller) plus the flags before it in the tile (each group
// counts its flag bytes; one scan of the counts).  A chunk's rows are read
// with x's structure, before its values.  Rows whose dst segment is absent
// are left as the caller zeroed them.
//
// Bound: memory.  The plan's stream (idx 4 B, valid and flag bytes, w 4 B
// where the multiply reads it) once, x's rows and their structure bytes,
// and Y's values and structure written once.  x's random rows are 32-byte
// sectors from L2, or from memory where x outgrows L2 (n x 4 doubles at
// 2^21 rows: 64 MB against 50 MB).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "common.cuh"
#include "onepass.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8;   // slots a thread loads at once (KP chunks a group)
constexpr int kTile = 2048;  // slots a tile, whatever k
constexpr int kStages = 2;
constexpr unsigned kFull = 0xffffffffu;

enum { kAdd = 0, kMin = 1, kMax = 2 };
enum { kTimes = 0, kPlus = 1, kSecond = 2, kFirst = 3, kPair = 4 };
enum : uint32_t { kNone = 0, kAggregate = 1, kPrefix = 2 };

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

template <int OP, typename V>
__device__ __forceinline__ V ident() {
  return OP == kAdd ? (V)0 : (OP == kMin ? (V)CUDART_INF : (V)-CUDART_INF);
}
template <int OP, typename V>
__device__ __forceinline__ V apply(V a, V b) {
  if (OP == kAdd) return add_rn(a, b);
  if (OP == kMin) return min_nan(a, b);
  return max_nan(a, b);
}

// The type the look-back carries: float sums in double (Kernel C's rule).
template <typename T, int OP>
struct Carry { using type = T; };
template <>
struct Carry<float, kAdd> { using type = double; };

__device__ __forceinline__ uint64_t word_of(double v) { return (uint64_t)__double_as_longlong(v); }
__device__ __forceinline__ uint64_t word_of(float v) { return __float_as_uint(v); }
template <typename C>
__device__ __forceinline__ C from_word(uint64_t w);
template <>
__device__ __forceinline__ double from_word<double>(uint64_t w) { return __longlong_as_double((long long)w); }
template <>
__device__ __forceinline__ float from_word<float>(uint64_t w) { return __uint_as_float((uint32_t)w); }

// status word: bits 62-63 the status, bit 61 the flag, bits 0-7 presence
__device__ __forceinline__ uint64_t pack(uint32_t status, int f, unsigned pres) {
  return (uint64_t)pres | ((uint64_t)(f != 0) << 61) | ((uint64_t)status << 62);
}
__device__ __forceinline__ uint32_t status_of(uint64_t d) { return (uint32_t)(d >> 62); }
__device__ __forceinline__ int flag_of(uint64_t d) { return (int)((d >> 61) & 1); }
__device__ __forceinline__ unsigned pres_of(uint64_t d) { return (unsigned)(d & 0xff); }

template <typename T>
struct SpmmArgs {
  const T* x;              // n_src x k, row-major
  const uint8_t* xs;       // x's structure (n_src x k bytes), or nullptr: every x present
  const int32_t* idx;      // src of each dst-order slot
  const float* w;          // weights (nullptr where the multiply reads none)
  const uint8_t* valid;
  const uint8_t* flags;    // dst segment starts
  const int32_t* seg_vertex;  // the row of each dst segment, in slot order
  const int32_t* tile_base;   // flags before each tile
  T* out_v;                // n_out x k, zeroed
  uint8_t* out_s;          // n_out x k, zeroed
  uint64_t* status;        // ntiles status words and the ticket, zeroed
  uint64_t* vals;          // 2 x ntiles x KP carried values (aggregate, prefix)
  int64_t n;               // slots
  int64_t ntiles;
  int k, mul, bulk_ok;
};

template <typename T>
__device__ __forceinline__ T contrib(T x, float w, int mul) {
  if (mul == kTimes) return mul_rn(x, (T)w);
  if (mul == kPlus) return add_rn(x, (T)w);
  if (mul == kSecond) return (T)w;
  if (mul == kPair) return (T)1;
  return x;
}

// b := a (+) b in every column, a the earlier run; a set flag in b starts a
// segment, and presence ORs within a segment.
template <int OP, typename V, int KP>
__device__ __forceinline__ void combine_k(const V (&av)[KP], int af, unsigned ap, V (&bv)[KP], int& bf, unsigned& bp) {
  if (!bf) {
#pragma unroll
    for (int c = 0; c < KP; ++c) bv[c] = apply<OP>(av[c], bv[c]);
    bp |= ap;
  }
  bf |= af;
}

// Warp 0: the exclusive prefix of tile t in each column (pre, pre_p) from
// its aggregate (agg, agg_f, agg_p).  Publishes the aggregate, looks back
// over up to 32 predecessors at a time until an inclusive prefix or a
// flagged aggregate, then publishes the inclusive prefix.
template <typename C, int OP, int KP>
__device__ __forceinline__ void look_back(uint64_t* status, uint64_t* vals, int64_t t, const C (&agg)[KP],
                                          int agg_f, unsigned agg_p, C (&pre)[KP], unsigned& pre_p) {
  const int lane = threadIdx.x & 31;
  C run[KP];
#pragma unroll
  for (int c = 0; c < KP; ++c) run[c] = ident<OP, C>();
  int run_f = 0;
  unsigned run_p = 0;
  if (t > 0) {
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < KP; ++c) st_desc(vals + 2 * t * KP + c, word_of(agg[c]));
      __threadfence();
      st_desc(status + t, pack(kAggregate, agg_f, agg_p));
    }
    for (int64_t end = t;; end -= 32) {
      const int64_t i = end - 1 - lane;  // lane 0 the nearest predecessor
      uint64_t d = i >= 0 ? ld_desc(status + i) : pack(kPrefix, 0, 0);
      unsigned stops, need;
      for (;;) {
        const uint32_t st = status_of(d);
        const bool stop = st == kPrefix || (st == kAggregate && flag_of(d));
        stops = __ballot_sync(kFull, stop);
        const unsigned ready = __ballot_sync(kFull, st != kNone);
        need = stops ? ((stops & (0u - stops)) << 1) - 1u : kFull;
        if ((ready & need) == need) break;
        if (st == kNone) d = ld_desc(status + i);
      }
      C wv[KP];
#pragma unroll
      for (int c = 0; c < KP; ++c) wv[c] = ident<OP, C>();
      int wf = 0;
      unsigned wp = 0;
      if ((need >> lane) & 1) {
        wf = flag_of(d);
        wp = pres_of(d);
        if (i >= 0) {
          __threadfence();  // the values were published before the status
          const uint64_t* src = vals + (2 * i + (status_of(d) == kPrefix ? 1 : 0)) * KP;
#pragma unroll
          for (int c = 0; c < KP; ++c) wv[c] = from_word<C>(ld_desc(src + c));
        }
      }
      // combine the window, later lanes being earlier tiles
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        C ov[KP];
#pragma unroll
        for (int c = 0; c < KP; ++c) ov[c] = __shfl_down_sync(kFull, wv[c], off);
        const int of = __shfl_down_sync(kFull, wf, off);
        const unsigned op = __shfl_down_sync(kFull, wp, off);
        if (lane + off < 32) combine_k<OP>(ov, of, op, wv, wf, wp);
      }
#pragma unroll
      for (int c = 0; c < KP; ++c) wv[c] = __shfl_sync(kFull, wv[c], 0);
      wf = __shfl_sync(kFull, wf, 0);
      wp = __shfl_sync(kFull, wp, 0);
      combine_k<OP>(wv, wf, wp, run, run_f, run_p);
      if (stops) break;
    }
  }
  if (lane == 0) {
    C inc[KP];
#pragma unroll
    for (int c = 0; c < KP; ++c) inc[c] = agg[c];
    int inc_f = agg_f;
    unsigned inc_p = agg_p;
    combine_k<OP>(run, run_f, run_p, inc, inc_f, inc_p);
#pragma unroll
    for (int c = 0; c < KP; ++c) st_desc(vals + (2 * t + 1) * KP + c, word_of(inc[c]));
    __threadfence();
    st_desc(status + t, pack(kPrefix, inc_f, inc_p));
  }
#pragma unroll
  for (int c = 0; c < KP; ++c) pre[c] = run[c];
  pre_p = run_p;
}

template <int KP>
struct Geometry {
  static constexpr int kGroups = kThreads / KP;    // slot groups a block
  static constexpr int kItems = kChunk * KP;       // slots a thread scans (a group's)
  static constexpr int kWarpGroups = 32 / KP;      // slot groups a warp
  static_assert(kGroups * kItems == kTile, "a tile is kTile slots at every k");
};

struct Stage {
  int32_t idx[kTile];
  float w[kTile];
  uint8_t valid[kTile];
  uint8_t flags[kTile];
};

__device__ __forceinline__ void issue(Stage& sg, uint64_t* bar, int64_t t, const int32_t* idx, const float* w,
                                      const uint8_t* valid, const uint8_t* flags) {
  const int64_t base = t * kTile;
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  mbar_expect(bar, (w != nullptr ? 8 * kTile : 4 * kTile) + 2 * kTile);
  bulk_load(sg.idx, idx + base, 4 * kTile, bar);
  if (w != nullptr) bulk_load(sg.w, w + base, 4 * kTile, bar);
  bulk_load(sg.valid, valid + base, kTile, bar);
  bulk_load(sg.flags, flags + base, kTile, bar);
}

// 8 bytes of 0 or 1 (bool) as 8 bits
__device__ __forceinline__ unsigned byte_bits(uint2 b) {
  unsigned m = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) m |= (((k < 4 ? b.x : b.y) >> (8 * (k & 3))) & 1u) << k;
  return m;
}

// Warp-scan partner lanes KP apart; lanes of one group hold equal counts.
template <int KP>
__device__ __forceinline__ int warp_exclusive_count(int c, int gw, int& warp_total) {
  int inc = c;
#pragma unroll
  for (int d = 1; d < Geometry<KP>::kWarpGroups; d <<= 1) {
    const int o = __shfl_up_sync(kFull, inc, d * KP);
    if (gw >= d) inc += o;
  }
  warp_total = __shfl_sync(kFull, inc, 31);
  return inc - c;
}

template <typename T, int OP, int KP>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 8 ? 3 : 4) spmm_onepass(SpmmArgs<T> a) {
  using C = typename Carry<T, OP>::type;
  using G = Geometry<KP>;
  __shared__ __align__(128) Stage s_stage[kStages];
  __shared__ uint64_t s_bar[kStages];
  __shared__ int64_t s_tile[kStages];
  __shared__ T s_wv[kWarps + 1][KP];  // warps' runs, then their exclusive prefixes
  __shared__ unsigned s_wp[kWarps + 1][KP];
  __shared__ int s_wf[kWarps], s_wc[kWarps];          // warps' flags and flag counts
  __shared__ int s_ef[kWarps + 1];                    // the warps' exclusive flags, the tile's at kWarps
  __shared__ C s_pre[KP];
  __shared__ unsigned s_prep;

  const int tid = threadIdx.x;
  const int col = tid % KP;
  const int grp = tid / KP;
  const int gw = grp % G::kWarpGroups;
  const int wid = tid >> 5;
  const int i0 = grp * G::kItems;
  const bool in_col = col < a.k;
  const bool reads_x = a.mul != kSecond && a.mul != kPair;
  const T id = ident<OP, T>();
  unsigned* ticket = reinterpret_cast<unsigned*>(a.status + a.ntiles);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&s_bar[s]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    s_tile[0] = atomicAdd(ticket, 1u);
    if (s_tile[0] < a.ntiles && a.bulk_ok && (s_tile[0] + 1) * kTile <= a.n)
      issue(s_stage[0], &s_bar[0], s_tile[0], a.idx, a.w, a.valid, a.flags);
  }
  __syncthreads();
  uint32_t parity = 0;
  for (int sg = 0;; sg ^= 1) {
    const int64_t t = s_tile[sg];
    if (t >= a.ntiles) break;
    if (tid == 0) {
      const int64_t nt = atomicAdd(ticket, 1u);
      s_tile[sg ^ 1] = nt;
      if (nt < a.ntiles && a.bulk_ok && (nt + 1) * kTile <= a.n)
        issue(s_stage[sg ^ 1], &s_bar[sg ^ 1], nt, a.idx, a.w, a.valid, a.flags);
    }
    const int64_t base = t * kTile;
    const bool staged = a.bulk_ok && base + kTile <= a.n;
    if (staged) {
      mbar_wait(&s_bar[sg], (parity >> sg) & 1u);
      parity ^= 1u << sg;
    }
    const Stage& st = s_stage[sg];

    // -- the segment starts before each group: the rows of its segment ends --
    const int tile_base = a.tile_base[t];
    int cnt = 0;
    for (int j0 = 0; j0 < G::kItems; j0 += kChunk) {
      if (staged) {
        cnt += __popc(byte_bits(*reinterpret_cast<const uint2*>(st.flags + i0 + j0)));
      } else {
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          const int64_t g = base + i0 + j0 + k;
          cnt += g < a.n && a.flags[g] != 0;
        }
      }
    }
    int warp_cnt;
    const int ex_cnt = warp_exclusive_count<KP>(cnt, gw, warp_cnt);
    if ((tid & 31) == 0) s_wc[wid] = warp_cnt;
    __syncthreads();
    int seen = tile_base + ex_cnt;  // segment starts up to the slot
    for (int w8 = 0; w8 < wid; ++w8) seen += s_wc[w8];

    // -- one pass over the group's slots: a segment that starts and ends in
    // it is written at its end; the first end, if its segment started
    // earlier, waits for the prefix --------------------------------------
    T run = id;
    unsigned run_p = 0;
    int run_f = 0;
    T pend = id;
    unsigned pend_p = 0;
    int64_t pend_at = -1;
    for (int j0 = 0; j0 < G::kItems; j0 += kChunk) {
      int32_t js[kChunk];
      float ws[kChunk];
      unsigned vbits = 0, fbits = 0;
      int next_f;  // the flag of the slot after the chunk (1 past the end)
      const int64_t g0 = base + i0 + j0;
      if (staged) {
        const uint4 q0 = *reinterpret_cast<const uint4*>(st.idx + i0 + j0);
        const uint4 q1 = *reinterpret_cast<const uint4*>(st.idx + i0 + j0 + 4);
        js[0] = q0.x, js[1] = q0.y, js[2] = q0.z, js[3] = q0.w;
        js[4] = q1.x, js[5] = q1.y, js[6] = q1.z, js[7] = q1.w;
        vbits = byte_bits(*reinterpret_cast<const uint2*>(st.valid + i0 + j0));
        fbits = byte_bits(*reinterpret_cast<const uint2*>(st.flags + i0 + j0));
#pragma unroll
        for (int k = 0; k < kChunk; ++k) ws[k] = a.w != nullptr ? st.w[i0 + j0 + k] : 0.f;
        if (i0 + j0 + kChunk < kTile) next_f = st.flags[i0 + j0 + kChunk] != 0;
        else next_f = base + kTile < a.n ? a.flags[base + kTile] != 0 : 1;
      } else {
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          const int64_t g = g0 + k;
          js[k] = 0;
          ws[k] = 0.f;
          if (g < a.n) {
            js[k] = a.idx[g];
            vbits |= (unsigned)(a.valid[g] != 0) << k;
            fbits |= (unsigned)(a.flags[g] != 0) << k;
            if (a.w != nullptr) ws[k] = a.w[g];
          }
        }
        next_f = g0 + kChunk < a.n ? a.flags[g0 + kChunk] != 0 : 1;
      }
      // the rows of the chunk's segment ends (-1: no end) and x's structure
      // (n x k bytes, small) in flight together, then x's values where present
      const unsigned ebits = (fbits >> 1) | ((unsigned)next_f << (kChunk - 1));
      int32_t rows[kChunk];
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const int upto = seen + __popc(fbits & ((2u << k) - 1u));  // segment starts up to slot k
        const bool end = ((ebits >> k) & 1) || g0 + k + 1 == a.n;
        rows[k] = in_col && g0 + k < a.n && end && upto > 0 ? __ldg(a.seg_vertex + upto - 1) : -1;
      }
      unsigned pbits = 0;
#pragma unroll
      for (int k = 0; k < kChunk; ++k)
        if (in_col && ((vbits >> k) & 1))
          pbits |= (unsigned)(a.xs == nullptr || __ldg(a.xs + (int64_t)js[k] * a.k + col) != 0) << k;
      T xv[kChunk];
#pragma unroll
      for (int k = 0; k < kChunk; ++k)
        xv[k] = reads_x && ((pbits >> k) & 1) ? __ldg(a.x + (int64_t)js[k] * a.k + col) : (T)0;
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const unsigned p = (pbits >> k) & 1;
        const T c = p ? contrib(xv[k], ws[k], a.mul) : id;
        if ((fbits >> k) & 1) {
          run = c;
          run_p = p;
          run_f = 1;
        } else {
          run = apply<OP>(run, c);
          run_p |= p;
        }
        if (rows[k] >= 0) {
          const int64_t at = (int64_t)rows[k] * a.k + col;
          if (run_f) {
            a.out_v[at] = run_p ? run : (T)0;
            a.out_s[at] = (uint8_t)run_p;
          } else {
            pend = run;
            pend_p = run_p;
            pend_at = at;
          }
        }
      }
      seen += __popc(fbits);
    }

    // -- the groups' runs across the block, KP lanes apart ------------------
    T rv[1] = {run};
    int rf = run_f;
    unsigned rp = run_p;
#pragma unroll
    for (int d = 1; d < G::kWarpGroups; d <<= 1) {
      const T ov[1] = {__shfl_up_sync(kFull, rv[0], d * KP)};
      const int of = __shfl_up_sync(kFull, rf, d * KP);
      const unsigned op = __shfl_up_sync(kFull, rp, d * KP);
      if (gw >= d) combine_k<OP>(ov, of, op, rv, rf, rp);
    }
    T xw[1] = {__shfl_up_sync(kFull, rv[0], KP)};  // the group's exclusive prefix in the warp
    int xf = __shfl_up_sync(kFull, rf, KP);
    unsigned xp = __shfl_up_sync(kFull, rp, KP);
    if (gw == 0) {
      xw[0] = id;
      xf = 0;
      xp = 0;
    }
    if (gw == G::kWarpGroups - 1) {
      s_wv[wid][col] = rv[0];
      s_wp[wid][col] = rp;
      if (col == 0) s_wf[wid] = rf;
    }
    __syncthreads();
    if (tid < KP) {  // column tid across the warps (thread 0 also the flags)
      T run_w[1] = {id};
      int f_w = 0;
      unsigned p_w = 0;
      for (int w8 = 0; w8 < kWarps; ++w8) {
        T bv[1] = {s_wv[w8][tid]};
        int bf = s_wf[w8];
        unsigned bp = s_wp[w8][tid];
        s_wv[w8][tid] = run_w[0];
        s_wp[w8][tid] = p_w;
        if (tid == 0) s_ef[w8] = f_w;
        combine_k<OP>(run_w, f_w, p_w, bv, bf, bp);
        run_w[0] = bv[0];
        f_w = bf;
        p_w = bp;
      }
      s_wv[kWarps][tid] = run_w[0];
      s_wp[kWarps][tid] = p_w;
      if (tid == 0) s_ef[kWarps] = f_w;
    }
    __syncthreads();
    {
      const T pw[1] = {s_wv[wid][col]};
      combine_k<OP>(pw, s_ef[wid], s_wp[wid][col], xw, xf, xp);
    }
    if (tid < 32) {
      C agg[KP], pre[KP];
      unsigned agg_p = 0, pre_p = 0;
#pragma unroll
      for (int c = 0; c < KP; ++c) {
        agg[c] = (C)s_wv[kWarps][c];
        agg_p |= (s_wp[kWarps][c] & 1u) << c;
      }
      look_back<C, OP, KP>(a.status, a.vals, t, agg, s_ef[kWarps], agg_p, pre, pre_p);
      if (tid == 0) {
#pragma unroll
        for (int c = 0; c < KP; ++c) s_pre[c] = pre[c];
        s_prep = pre_p;
      }
    }
    __syncthreads();

    // -- the first end's segment: the group's prefix and its own run --------
    if (pend_at >= 0) {
      C cv[1] = {(C)xw[0]};
      int cf = xf;
      unsigned cp = xp;
      const C pc[1] = {s_pre[col]};
      combine_k<OP>(pc, 0, (s_prep >> col) & 1u, cv, cf, cp);
      C bv[1] = {(C)pend};
      int bf = 0;
      unsigned bp = pend_p;
      combine_k<OP>(cv, cf, cp, bv, bf, bp);
      a.out_v[pend_at] = bp ? (T)bv[0] : (T)0;
      a.out_s[pend_at] = (uint8_t)bp;
    }
    // the stage, the warps' sums and the prefix are read before the next
    // tile's writes reach them: the next tile's barriers order them
  }
}

template <typename T, int OP, int KP>
int launch(SpmmArgs<T> a, cudaStream_t s) {
  if (a.n <= 0) return (int)cudaGetLastError();
  a.ntiles = (a.n + kTile - 1) / kTile;
  auto kernel = spmm_onepass<T, OP, KP>;
  static int per_sm = 0;  // resident blocks an SM, once an instantiation
  if (per_sm == 0) cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int64_t grid = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  if (grid > a.ntiles) grid = a.ntiles;
  kernel<<<(unsigned)grid, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

int columns(int k) { return k <= 1 ? 1 : k <= 2 ? 2 : k <= 4 ? 4 : 8; }

template <typename T, int OP>
int by_columns(const SpmmArgs<T>& a, cudaStream_t s) {
  switch (columns(a.k)) {
    case 1: return launch<T, OP, 1>(a, s);
    case 2: return launch<T, OP, 2>(a, s);
    case 4: return launch<T, OP, 4>(a, s);
    case 8: return launch<T, OP, 8>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int typed(const void* x, const void* xs, const void* idx, const void* w, const void* valid, const void* flags,
          const void* seg_vertex, const void* tile_base, void* out_v, void* out_s, void* status, void* vals,
          int64_t n, int k, int op, int mul, cudaStream_t s) {
  const int bulk_ok = aligned16(idx) && aligned16(valid) && aligned16(flags) && (w == nullptr || aligned16(w));
  const SpmmArgs<T> a{(const T*)x, (const uint8_t*)xs, (const int32_t*)idx, (const float*)w,
                      (const uint8_t*)valid, (const uint8_t*)flags, (const int32_t*)seg_vertex,
                      (const int32_t*)tile_base, (T*)out_v, (uint8_t*)out_s, (uint64_t*)status,
                      (uint64_t*)vals, n, 0, k, mul, bulk_ok};
  switch (op) {
    case kAdd: return by_columns<T, kAdd>(a, s);
    case kMin: return by_columns<T, kMin>(a, s);
    case kMax: return by_columns<T, kMax>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Slots a tile of the k-column product holds (2048, whatever k).
extern "C" int gb_segscan_spmm_tile() { return kTile; }

// Y = A (.) X over n dst-order slots, k (1-8) columns.  x: n_src x k values
// (float, or double with is_double); xs: its structure bytes, or null for
// every x present; idx, w (float, or null), valid and flags: n slots;
// seg_vertex: the row of each dst segment; tile_base: ceil(n / tile) + 1
// counts of the flags before each tile; out_v (values) and out_s (structure
// bytes): n_out x k, zeroed; status: ceil(n / tile) + 1 zeroed 64-bit words;
// vals: 2 x ceil(n / tile) x 8 64-bit words.  op: 0 plus, 1 min, 2 max; mul:
// 0 times, 1 plus, 2 second (w alone), 3 first (x alone), 4 pair (1).
extern "C" int gb_segscan_spmm(const void* x, const void* xs, const void* idx, const void* w, const void* valid,
                               const void* flags, const void* seg_vertex, const void* tile_base, void* out_v,
                               void* out_s, void* status, void* vals, int64_t n, int k, int is_double, int op,
                               int mul, void* stream) {
  if (k < 1 || k > 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_double)
    return typed<double>(x, xs, idx, w, valid, flags, seg_vertex, tile_base, out_v, out_s, status, vals, n, k, op,
                         mul, s);
  return typed<float>(x, xs, idx, w, valid, flags, seg_vertex, tile_base, out_v, out_s, status, vals, n, k, op, mul,
                      s);
}
