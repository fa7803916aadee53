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
// A tile's work is two phases, and a block runs them a tile apart: while it
// scans tile t out of shared memory, tile t+1's gathers are in flight.
//
// Gather.  The tile's idx, w, valid and flag bytes arrive by bulk copy (two
// stages: the tile scanned, the tile gathered).  Then each thread takes
// whole slots and copies by cp.async, into shared memory and with no
// register waiting for the data: first x's structure of each valid slot's
// row (one 16-byte piece where rows of 4 or 8 bytes cannot cross one, else
// the 4-byte words the row spans); once it lands, the row's values where
// some column is present (4 doubles: two 16-byte copies; each warp lays its
// present rows' pieces on consecutive lanes, found by ballot, so a row is
// one request and an absent row costs nothing: a frontier is mostly
// absent), and the rows of the tile's segment ends (one run of
// seg_vertex).  Where x is full (xs null) the structure round is skipped.
// A thread waits for its copies twice a step, a barrier then shows them to
// the block: the structure's round trip runs under the scan of the tile
// before, the values' under the next step's first round.  The ragged last
// tile, and streams the bulk copy cannot take (unaligned views), are loaded
// into the same stage by the threads.
//
// Scan.  256 threads as (slot group, column) pairs, KP = k rounded up to a
// power of two columns, 256 / KP groups of kItems consecutive slots.  Each
// thread reads its slots' flag bytes, presence bits (valid and present in
// its column) and values from shared memory, 8 slots at a time.  A slot's
// value row sits at an index whose low bits are XORed with its group's, so
// the groups of a warp read other banks.  Where nothing is present in the
// warp's 8 slots, every contribution is the identity: only the end of the
// run carried into them is written (a sparse frontier's common case).
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
// with an acquire-release fence between, read after it with one between
// (message passing by fences; the values' accesses are relaxed gpu-scope,
// so no stale L1 line is read).  Float sums carry in double across tiles,
// as Kernel C's.  A ninth warp does the look-back: the scan's warps hand it
// each tile's aggregate by named barrier and go on to the next step; it
// publishes the aggregate, looks back, publishes the inclusive prefix and
// hands the exclusive prefix back, which the scan's warps take at the next
// step for the tile's first segment end.  A block takes its tiles' tickets
// a step ahead and waits only on tiles with earlier tickets: the earliest
// unfinished tile's predecessors are all finished, so its look-back ends.
//
// Tile: shared memory holds per slot 2 x 10 stream bytes, a value row (KP x
// sizeof(T) bytes), a structure cell (16 bytes from KP = 4), a presence
// byte and a segment row (4 bytes).  The tile is the largest multiple of
// 2048 / KP slots (8 a scan thread) up to 2048 that keeps this within 112
// KB, two blocks an SM: 1536 slots and 110 KB for double at k = 4.  It
// follows from T and KP, the template parameters.
//
// Rows: a segment-last slot writes row seg_vertex[o], o the number of flags
// up to it less one: tile_base (the flags before every 256-slot block,
// computed once a plan by the caller) at the tile's start plus the flags
// before it in the tile (each group counts its flag bytes; one scan of the
// counts).  Rows whose dst segment is absent are left as the caller zeroed
// them.
//
// Bound: memory.  The plan's stream (idx 4 B, valid and flag bytes, w 4 B
// where the multiply reads it) once, x's rows and their structure bytes,
// and Y's values and structure written once.  x's random rows are 32-byte
// sectors from L2, or from memory where x outgrows L2 (n x 4 doubles at
// 2^21 rows: 64 MB against 50 MB).
//
// The row-selected traversal.  A statement C(M) << A.mxm(X) can write only
// the rows where its mask allows some column; the others' totals would be
// discarded.  Given the mask, a first launch (spmm_keep, one pass over the
// segments with decoupled look-back) keeps the segments whose row the mask
// reaches, each trimmed of the slots from pad_from on (never valid), and
// lists them in slot order: their rows, first slots and the running count
// of their slots, the kept slot space.  It also enters, for every tile of
// that space, the kept segment that holds its first slot and whether one
// starts there (tile_info).  The product's blocks then take tiles of the
// kept space.  A tile's run of list entries (the running counts and first
// slots of its segments) arrives by cp.async a step ahead, into its stage's
// idx and w arrays; each thread finds its slots' segments by binary search
// in that run, loads idx, w and the valid byte of the plan slot behind each
// (one round trip: runs of consecutive slots, so a warp's loads coalesce
// within a segment), sets the flag where a segment starts, and the tile
// goes on as any other: structure, values, scan, look-back, with the
// segment rows read from the kept list.  Nothing kept: no tile, and Y
// stays zero.  It reads the kept slots' stream once, their rows of x, the
// list (12 B a kept segment) and writes the kept rows of Y; what bounds it
// is a step's extra round trip, the loads behind the search.  Where the
// kept slots reach kFullNum / kFullDen of the plan's, the whole plan is
// streamed as without a mask, and the rows outside the kept ones are not
// written (masked_rows reads -1 there): the per-slot loads would cost more
// than the slots they skip.  Every row outside the kept ones reads absent.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "common.cuh"
#include "onepass.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // the scan's warps
constexpr int kBlockThreads = kThreads + 32;  // and the look-back warp
constexpr int kChunk = 8;        // slots a scan thread takes at once
constexpr int kGranule = 256;    // slots a tile_base entry covers; every tile is a multiple
constexpr int kStages = 2;       // plan-stream stages: the tile scanned, the tile gathered
constexpr int kRowSpare = 8;     // words past a tile's segment rows: their run's alignment
constexpr int kSmemBudget = 112 * 1024;  // a block's dynamic shared memory, where the tile allows
constexpr int kSmemPerSM = 228 * 1024;
constexpr unsigned kFull = 0xffffffffu;
// the share of the plan's slots from which a masked product streams them all
constexpr int64_t kFullNum = 3, kFullDen = 4;

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
  const int32_t* tile_base;   // flags before each 256-slot block
  T* out_v;                // n_out x k, zeroed
  uint8_t* out_s;          // n_out x k, zeroed
  uint64_t* status;        // ntiles status words and the ticket, zeroed
  uint64_t* vals;          // 2 x ntiles x KP carried values (aggregate, prefix)
  int64_t n;               // slots
  int64_t ntiles;
  int k, mul, bulk_ok;
  int vcopy;               // bytes of one cp.async of a value row: 16, 8 or 4
  int scopy16;             // a row's structure by one 16-byte copy (KP >= 4, k 4 or 8, xs 16-byte aligned)
  // the rows a mask selects, as spmm_keep lists them (hdr null: every row)
  const int32_t* hdr;          // the kept segments and slots
  const int32_t* kept_row;     // a kept segment's row, first slot and the kept slots before it
  const int32_t* kept_start;
  const int32_t* kept_cum;
  const int32_t* tile_info;    // a kept tile's first segment, 2 o + 1 where it starts the tile, else 2 (o + 1)
  const int32_t* masked_rows;  // seg_vertex with -1 at the segments not kept
};

// spmm_keep's header words
enum { kHdrKept = 0, kHdrSlots = 1, kHdrTicket = 2, kHdrWords = 4 };

template <int MUL, typename T>
__device__ __forceinline__ T contrib(T x, float w) {
  if (MUL == kTimes) return mul_rn(x, (T)w);
  if (MUL == kPlus) return add_rn(x, (T)w);
  if (MUL == kSecond) return (T)w;
  if (MUL == kPair) return (T)1;
  return x;
}
// The position of the n-th (from 0) set bit of mask; n < popc(mask).
__device__ __forceinline__ int nth_set(unsigned mask, int n) {
  int pos = 0;
#pragma unroll
  for (int b = 16; b >= 1; b >>= 1) {
    const int c = __popc(mask & ((1u << b) - 1u));
    if (n >= c) {
      n -= c;
      mask >>= b;
      pos += b;
    }
  }
  return pos;
}

template <int MUL>
struct MulTag {
  static constexpr int value = MUL;
};

// Named barriers: the scan's warps among themselves, and their hand-offs
// to the look-back warp (bar.arrive: the producer does not wait).
constexpr int kBarWorkers = 1, kBarAggregate = 2, kBarPrefix = 3;
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
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

// Lane 0 of tile t's block: publishes the tile's aggregate (t > 0), as
// soon as the block has it, so that later tiles' look-backs need not wait
// for this tile's own.
template <typename C, int KP>
__device__ __forceinline__ void publish_aggregate(uint64_t* status, uint64_t* vals, int64_t t, const C (&agg)[KP],
                                                  int agg_f, unsigned agg_p) {
  if (t == 0) return;
#pragma unroll
  for (int c = 0; c < KP; ++c) st_desc(vals + 2 * t * KP + c, word_of(agg[c]));
  fence_acq_rel();
  st_desc(status + t, pack(kAggregate, agg_f, agg_p));
}

// Warp 0: the exclusive prefix of tile t in each column (pre, pre_p) from
// its aggregate (agg, agg_f, agg_p), published before.  Looks back over up
// to 32 predecessors at a time until an inclusive prefix or a flagged
// aggregate, then publishes the inclusive prefix.
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
          fence_acq_rel();  // the values were published before the status
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
    fence_acq_rel();
    st_desc(status + t, pack(kPrefix, inc_f, inc_p));
  }
#pragma unroll
  for (int c = 0; c < KP; ++c) pre[c] = run[c];
  pre_p = run_p;
}

// The tile for a footprint of slot_bytes a slot: the largest multiple of
// 2048 / kp slots (8 a scan thread) up to 2048 within the budget, at least
// 2048 / kp.
__host__ __device__ constexpr int tile_for(int slot_bytes, int kp) {
  const int step = 2048 / kp > kGranule ? 2048 / kp : kGranule;
  for (int t = 2048; t > step; t -= step)
    if (t * slot_bytes + 4 * kRowSpare <= kSmemBudget) return t;
  return step;
}

template <int TS>
struct Stream {
  int32_t idx[TS];
  float w[TS];
  uint8_t valid[TS];
  uint8_t flags[TS];
};

template <typename T, int KP>
struct Geometry {
  static constexpr int kRowBytes = KP * (int)sizeof(T);  // a value row in shared memory
  // a row's structure: one 16-byte piece (KP >= 4, rows that cannot cross
  // one), else the 4-byte words it spans
  static constexpr int kCellBytes = KP >= 4 ? 16 : 4 * ((KP + 6) / 4);
  static constexpr int kSlotBytes = kStages * 10 + kRowBytes + kCellBytes + 1 + 4;
  static constexpr int kTile = tile_for(kSlotBytes, KP);
  static constexpr int kSmem = kTile * kSlotBytes + 4 * kRowSpare;
  static constexpr int kFit = kSmemPerSM / (kSmem + 2048);  // blocks an SM by shared memory
  static constexpr int kMinBlocks = kFit < 1 ? 1 : kFit > 2 ? 2 : kFit;
  static constexpr int kGroups = kThreads / KP;        // slot groups a block
  static constexpr int kItems = kTile / kGroups;       // slots a scan thread takes (its group's)
  static constexpr int kWarpGroups = 32 / KP;          // slot groups a warp
  static constexpr int kPerThread = kTile / kThreads;  // slots a thread gathers
  static constexpr int kRowsPerLine = kRowBytes >= 128 ? 1 : 128 / kRowBytes;  // value rows a bank line
  static_assert(kItems % kChunk == 0 && kTile % kGranule == 0 && kTile % kThreads == 0, "tile geometry");
};

// Slot s's row in the value buffer: its low bits XORed with its scan
// group's, so the groups of a warp, kItems slots apart, read other banks.
template <typename G>
__device__ __forceinline__ int vpos(int s) {
  return s ^ ((s / G::kItems) & (G::kRowsPerLine - 1));
}

template <int TS>
__device__ __forceinline__ void issue(Stream<TS>& sg, uint64_t* bar, int64_t t, const int32_t* idx, const float* w,
                                      const uint8_t* valid, const uint8_t* flags) {
  const int64_t base = t * TS;
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  mbar_expect(bar, (w != nullptr ? 8 * TS : 4 * TS) + 2 * TS);
  bulk_load(sg.idx, idx + base, 4 * TS, bar);
  if (w != nullptr) bulk_load(sg.w, w + base, 4 * TS, bar);
  bulk_load(sg.valid, valid + base, TS, bar);
  bulk_load(sg.flags, flags + base, TS, bar);
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
  for (int d = 1; d < 32 / KP; d <<= 1) {
    const int o = __shfl_up_sync(kFull, inc, d * KP);
    if (gw >= d) inc += o;
  }
  warp_total = __shfl_sync(kFull, inc, 31);
  return inc - c;
}

template <typename T, int OP, int KP>
__global__ void __launch_bounds__(kBlockThreads, Geometry<T, KP>::kMinBlocks) spmm_onepass(SpmmArgs<T> a) {
  using C = typename Carry<T, OP>::type;
  using G = Geometry<T, KP>;
  constexpr int TS = G::kTile;
  constexpr int RB = G::kRowBytes;
  constexpr int CB = G::kCellBytes;
  using Stage = Stream<TS>;
  extern __shared__ __align__(128) unsigned char s_dyn[];
  Stage* const s_stream = reinterpret_cast<Stage*>(s_dyn);                  // kStages
  unsigned char* const s_vals = s_dyn + kStages * sizeof(Stage);              // TS value rows
  unsigned char* const s_cells = s_vals + TS * RB;                            // TS structure cells
  uint8_t* const s_mask = s_cells + TS * CB;                                  // TS presence bytes
  int32_t* const s_rows = reinterpret_cast<int32_t*>(s_mask + TS);           // TS + kRowSpare segment rows
  __shared__ uint64_t s_bar[kStages];
  __shared__ int64_t s_tile[kStages];
  __shared__ int32_t s_tb[kStages][2];  // flags before the stage's tile and before the next
  __shared__ uint32_t s_nf[kStages];    // the word that holds the flag after the tile
  __shared__ T s_wv[kWarps + 1][KP];  // warps' runs, then their exclusive prefixes
  __shared__ unsigned s_wp[kWarps + 1][KP];
  __shared__ int s_wf[kWarps], s_wc[kWarps];          // warps' flags and flag counts
  __shared__ int s_ef[kWarps + 1];                    // the warps' exclusive flags, the tile's at kWarps
  __shared__ C s_hand_v[2][KP];  // a scanned tile's aggregate, handed to the look-back warp
  __shared__ int s_hand_f[2];
  __shared__ unsigned s_hand_p[2];
  __shared__ int64_t s_hand_tile[2];  // the tile, or -1: no more
  __shared__ C s_pre[2][KP];  // and its exclusive prefix, handed back
  __shared__ unsigned s_prep[2];
  __shared__ int32_t s_ti[kStages][2];  // kept: a tile's tile_info entry and the next tile's (-1: no tile)

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
  const int64_t last_base = (a.n + kGranule - 1) / kGranule;  // tile_base's last entry
  const uint64_t keep = evict_last_policy();  // x's structure stays in L2 while the value rows pass
  const uintptr_t cell_mask = a.scopy16 ? 15 : 3;  // a row's first byte in its cell

  // The traversal: its slots and tiles and the segments' rows.  With a mask,
  // the kept slot space (kept), or the whole plan with the rows outside the
  // kept ones never written.  Thread 0 sets it before the block's first
  // barrier; it lives in shared memory, read where it is used, so that no
  // register holds it across a step.
  __shared__ struct {
    int64_t n, nt;
    const int32_t* rows;
    int kept;
  } s_tr;
  if (tid == 0) {
    s_tr.n = a.n;
    s_tr.nt = a.ntiles;
    s_tr.rows = a.seg_vertex;
    s_tr.kept = 0;
    if (a.hdr != nullptr) {
      const int64_t kept_slots = a.hdr[kHdrSlots];
      if (kept_slots * kFullDen >= a.n * kFullNum) {
        s_tr.rows = a.masked_rows;
      } else {
        s_tr.kept = 1;
        s_tr.n = kept_slots;
        s_tr.nt = (kept_slots + TS - 1) / TS;
        s_tr.rows = a.kept_row;
      }
    }
  }

  // Thread 0: tile t into stage stg.  Its stream by bulk copy where it can,
  // and by cp.async the flags before it and after it and the word holding
  // the flag after it (the caller commits them).  A s_tr.kept tile's stream is
  // gathered by the block when it starts (gather, first round).
  auto start_tile = [&](int stg, int64_t t) {
    s_tile[stg] = t;
    if (t >= s_tr.nt || s_tr.kept) return;
    if (a.bulk_ok && (t + 1) * TS <= a.n) issue(s_stream[stg], &s_bar[stg], t, a.idx, a.w, a.valid, a.flags);
    constexpr int R = TS / kGranule;
    const int64_t next = (t + 1) * R < last_base ? (t + 1) * R : last_base;
    cp_async<4>(&s_tb[stg][0], a.tile_base + t * R);
    cp_async<4>(&s_tb[stg][1], a.tile_base + next);
    const int64_t after = (t + 1) * TS;
    if (after < a.n) cp_async<4>(&s_nf[stg], reinterpret_cast<const void*>((uintptr_t)(a.flags + after) & ~(uintptr_t)3));
  };
  // Thread 0, s_tr.kept: s_tr.kept tile t's tile_info entries into s_ti[slot] by
  // cp.async (the caller commits them), or the mark of no tile.
  auto tile_entries = [&](int slot, int64_t t) {
    if (t < s_tr.nt) {
      cp_async<4>(&s_ti[slot][0], a.tile_info + t);
      cp_async<4>(&s_ti[slot][1], a.tile_info + t + 1);
    } else {
      s_ti[slot][0] = -1;
    }
  };
  // The scan's threads, s_tr.kept: the run of list entries of the tile that
  // s_ti[stg] describes (its segments' running counts and first slots) into
  // stage stg's idx and w arrays, by cp.async (the caller commits them).
  auto start_run = [&](int stg) {
    const int e0 = s_ti[stg][0];
    if (e0 < 0) return;
    const int j0 = (e0 & 1) ? e0 >> 1 : (e0 >> 1) - 1;  // the segment holding the tile's first slot
    const int segs = (s_ti[stg][1] >> 1) - j0;          // it and those that start in the tile
    int32_t* cum = s_stream[stg].idx;
    int32_t* first = reinterpret_cast<int32_t*>(s_stream[stg].w);
    for (int q = tid; q < segs; q += kThreads) {
      cp_async<4>(cum + q, a.kept_cum + j0 + q);
      cp_async<4>(first + q, a.kept_start + j0 + q);
    }
  };

  // Thread 0 takes each ticket a step before its tile starts, so no step
  // waits for the atomic's answer.
  int64_t pending = 0;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&s_bar[s]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    const int64_t first = atomicAdd(ticket, 1u);
    start_tile(0, first);
    pending = atomicAdd(ticket, 1u);
    if (s_tr.kept) {
      tile_entries(0, first);
      tile_entries(1, pending);
    }
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // The look-back warp: for each tile the scan hands over, publishes its
  // aggregate and finds its exclusive prefix by decoupled look-back, while
  // the scan's warps gather and scan on.
  if (wid == kWarps) {
    for (int j = 0;; ++j) {
      bar_sync(kBarAggregate, kBlockThreads);
      const int64_t lt = s_hand_tile[j & 1];
      if (lt < 0) break;
      C agg[KP], pre[KP];
      unsigned pre_p = 0;
#pragma unroll
      for (int c = 0; c < KP; ++c) agg[c] = s_hand_v[j & 1][c];
      if ((tid & 31) == 0) publish_aggregate<C, KP>(a.status, a.vals, lt, agg, s_hand_f[j & 1], s_hand_p[j & 1]);
      look_back<C, OP, KP>(a.status, a.vals, lt, agg, s_hand_f[j & 1], s_hand_p[j & 1], pre, pre_p);
      if ((tid & 31) == 0) {
#pragma unroll
        for (int c = 0; c < KP; ++c) s_pre[j & 1][c] = pre[c];
        s_prep[j & 1] = pre_p;
      }
      bar_arrive(kBarPrefix, kBlockThreads);
    }
    return;
  }
  if (s_tr.kept) {
    start_run(0);
    cp_async_commit();
  }

  // a scanned tile's first segment end, when its segment started before the
  // tile: written once the look-back warp hands the prefix back (a step later)
  T xw[1] = {id};  // the group's exclusive prefix in the block
  int xf = 0;
  unsigned xp = 0;
  T pend = id;
  unsigned pend_p = 0;
  int64_t pend_at = -1;
  int hj = 0;         // tiles handed to the look-back warp
  bool held = false;  // the last one's first end not yet written
  auto resolve = [&]() {
    bar_sync(kBarPrefix, kBlockThreads);
    if (pend_at >= 0) {
      const int b = (hj - 1) & 1;
      C cv[1] = {(C)xw[0]};
      int cf = xf;
      unsigned cp = xp;
      const C pc[1] = {s_pre[b][col]};
      combine_k<OP>(pc, 0, (s_prep[b] >> col) & 1u, cv, cf, cp);
      C bv[1] = {(C)pend};
      int bf = 0;
      unsigned bp = pend_p;
      combine_k<OP>(cv, cf, cp, bv, bf, bp);
      a.out_v[pend_at] = bp ? (T)bv[0] : (T)0;
      a.out_s[pend_at] = (uint8_t)bp;
    }
    held = false;
  };
  uint32_t parity = 0;
  // A step gathers tile nx and scans tile t, gathered in the last step.  A
  // thread's copies form two groups a step: nx's structure, then nx's
  // values and segment rows (and thread 0's start of the tile after nx).
  // t's values are awaited before its scan, nx's structure after the scan's
  // first half, and nx's values and the next stream go out before t's
  // look-back: the structure's round trip runs under the scan, the values'
  // and the stream's under the look-back.
  for (int it = 0;; ++it) {
    const int sn = it & 1;  // nx's stream stage; t's is sn ^ 1
    const int sc = sn ^ 1;
    const int64_t nx = s_tile[sn];
    const int64_t t = it > 0 ? s_tile[sc] : s_tr.nt;
    if (nx >= s_tr.nt && t >= s_tr.nt) break;
    const bool gathers = nx < s_tr.nt;
    const bool scans = t < s_tr.nt;
    Stage& sx = s_stream[sn];

    // -- gather, first round: nx's stream, then the structure of its valid
    // slots' rows ------------------------------------------------------------
    if (gathers) {
      const int64_t base = nx * TS;
      if (s_tr.kept) {
        // the run of nx's list entries landed (it went out a step ago):
        // each slot's segment by binary search in it, then the plan slot
        // behind it, whose idx, w and valid byte are loaded (one round trip)
        cp_async_wait_all();
        bar_sync(kBarWorkers, kThreads);
        const int e0 = s_ti[sn][0], e1 = s_ti[sn][1];
        const int j0 = (e0 & 1) ? e0 >> 1 : (e0 >> 1) - 1;
        const int segs = (e1 >> 1) - j0;
        const int32_t* cum = sx.idx;
        const int32_t* first = reinterpret_cast<const int32_t*>(sx.w);
        const int64_t kept_slots = s_tr.n;
        int lo[G::kPerThread];
        int32_t p[G::kPerThread];  // the slot in the kept space
#pragma unroll
        for (int i = 0; i < G::kPerThread; ++i) {
          lo[i] = 0;
          p[i] = (int32_t)(base + tid + i * kThreads);
        }
        for (int step = segs > 1 ? 1 << (31 - __clz(segs - 1)) : 0; step > 0; step >>= 1) {
#pragma unroll
          for (int i = 0; i < G::kPerThread; ++i) {
            const int c = lo[i] + step;
            if (c < segs && cum[c] <= p[i]) lo[i] = c;
          }
        }
        int64_t g[G::kPerThread];  // the plan slot, or -1 past the kept slots
        bool starts[G::kPerThread];
#pragma unroll
        for (int i = 0; i < G::kPerThread; ++i) {
          const bool in = p[i] < kept_slots;
          g[i] = in ? (int64_t)first[lo[i]] + (p[i] - cum[lo[i]]) : -1;
          starts[i] = !in || cum[lo[i]] == p[i];  // past the end: segments of one slot, never written
        }
        int32_t gi[G::kPerThread];
        float gwt[G::kPerThread];
        bool gv[G::kPerThread];
#pragma unroll
        for (int i = 0; i < G::kPerThread; ++i) {
          const bool in = g[i] >= 0;
          gi[i] = in ? a.idx[g[i]] : 0;
          gwt[i] = in && a.w != nullptr ? a.w[g[i]] : 0.f;
          gv[i] = in && a.valid[g[i]] != 0;
        }
        bar_sync(kBarWorkers, kThreads);  // the run is read
#pragma unroll
        for (int i = 0; i < G::kPerThread; ++i) {
          const int s = tid + i * kThreads;
          sx.idx[s] = gi[i];
          sx.w[s] = gwt[i];
          sx.valid[s] = gv[i];
          sx.flags[s] = starts[i];
        }
        if (tid == 0) {  // as the unmasked tile's: the kept segments before nx and before the next
          s_tb[sn][0] = e0 >> 1;
          s_tb[sn][1] = e1 >> 1;
          s_nf[sn] = e1 & 1;
        }
      } else if (a.bulk_ok && base + TS <= a.n) {
        mbar_wait(&s_bar[sn], (parity >> sn) & 1u);
        parity ^= 1u << sn;
      } else {
#pragma unroll
        for (int i = 0; i < G::kPerThread; ++i) {
          const int s = tid + i * kThreads;
          const int64_t g = base + s;
          const bool in = g < a.n;
          sx.idx[s] = in ? a.idx[g] : 0;
          sx.w[s] = in && a.w != nullptr ? a.w[g] : 0.f;
          sx.valid[s] = in && a.valid[g] != 0;
          sx.flags[s] = !in || a.flags[g] != 0;  // past the end: segments of one slot, never written
        }
      }
      if (a.xs != nullptr) {
        // this thread's slots' sources and valid bytes, all read before any
        // is used (shared reads queue behind the block's copies)
        int32_t js[G::kPerThread];
        bool ok[G::kPerThread];
#pragma unroll
        for (int i = 0; i < G::kPerThread; ++i) {
          js[i] = sx.idx[tid + i * kThreads];
          ok[i] = sx.valid[tid + i * kThreads] != 0;
        }
#pragma unroll
        for (int i = 0; i < G::kPerThread; ++i) {
          if (!ok[i]) continue;
          const uintptr_t at = (uintptr_t)(a.xs + (int64_t)js[i] * a.k);
          unsigned char* cell = s_cells + (tid + i * kThreads) * CB;
          if (CB == 16 && a.scopy16) {
            cp_async_stream<16>(cell, reinterpret_cast<const void*>(at & ~(uintptr_t)15));
          } else {
            const uint8_t* word = reinterpret_cast<const uint8_t*>(at & ~(uintptr_t)3);
            const int words = (int)(((at & 3) + a.k + 3) >> 2);
            for (int q = 0; q < words; ++q) cp_async_keep<4>(cell + 4 * q, word + 4 * q, keep);
          }
        }
      }
    }
    cp_async_commit();
    cp_async_wait_prior();  // t's values and rows, and nx's stream position, from the last step
    bar_sync(kBarWorkers, kThreads);
    if (held) resolve();

    // -- scan of tile t out of shared memory: each group's pass, the block's
    // combine, the aggregate handed to the look-back warp --------------------
    if (scans) {
      const Stage& st = s_stream[sc];
      const int64_t base = t * TS;
      const int tile_base = s_tb[sc][0];
      const int lo = tile_base > 0 ? tile_base - 1 : 0;
      const int rbase = lo - (int)(((uintptr_t)(s_tr.rows + lo) & 15) >> 2);  // the ordinal of s_rows[0]
      const int64_t after = base + TS;
      const int64_t slots = s_tr.n;
      const int flag_after = after >= slots ? 1
                             : s_tr.kept    ? (int)s_nf[sc]
                                            : ((s_nf[sc] >> (8 * ((uintptr_t)(a.flags + after) & 3))) & 0xffu) != 0;
      const int lim = slots - base < TS ? (int)(slots - base) : TS;  // the tile's slots

      // the segment starts before each group: the rows of its segment ends
      int cnt = 0;
#pragma unroll
      for (int j0 = 0; j0 < G::kItems; j0 += kChunk)
        cnt += __popc(byte_bits(*reinterpret_cast<const uint2*>(st.flags + i0 + j0)));
      int warp_cnt;
      const int ex_cnt = warp_exclusive_count<KP>(cnt, gw, warp_cnt);
      if ((tid & 31) == 0) s_wc[wid] = warp_cnt;
      bar_sync(kBarWorkers, kThreads);
      int seen = tile_base + ex_cnt;  // segment starts up to the slot
      for (int w8 = 0; w8 < wid; ++w8) seen += s_wc[w8];

      // one pass over the group's slots: a segment that starts and ends in
      // it is written at its end; the first end, if its segment started
      // earlier, waits for the prefix
      T run = id;
      unsigned run_p = 0;
      int run_f = 0;
      pend_at = -1;
      auto pass = [&](auto mul_tag) {
      constexpr int MUL = decltype(mul_tag)::value;
      constexpr bool kReadsX = MUL != kSecond && MUL != kPair;
      constexpr bool kReadsW = MUL == kTimes || MUL == kPlus || MUL == kSecond;
      for (int j0 = 0; j0 < G::kItems; j0 += kChunk) {
        const int i = i0 + j0;
        const unsigned fbits = byte_bits(*reinterpret_cast<const uint2*>(st.flags + i));
        const uint2 mb = *reinterpret_cast<const uint2*>(s_mask + i);
        const int next_f = i + kChunk < TS ? st.flags[i + kChunk] != 0 : flag_after;  // the flag after the chunk
        const unsigned ebits = (fbits >> 1) | ((unsigned)next_f << (kChunk - 1));
        // nothing present in the warp's chunk: the contributions are all the
        // identity, so only the end of the run carried into the chunk (the
        // slot before its first flag) is written; the segments the chunk's
        // flags start end empty, and their rows stay as the caller zeroed them
        if (!__any_sync(kFull, (mb.x | mb.y) != 0)) {
          const int first = fbits ? __ffs(fbits) - 1 : kChunk;  // the chunk's first flag
          const int k = first - 1;
          const int32_t row = k >= 0 && in_col && ((ebits >> k) & 1) && i + k < lim && seen > 0
                                  ? s_rows[seen - 1 - rbase]
                                  : -1;
          if (row >= 0) {
            const int64_t at = (int64_t)row * a.k + col;
            if (run_f) {
              a.out_v[at] = run_p ? run : (T)0;
              a.out_s[at] = (uint8_t)run_p;
            } else {
              pend = run;
              pend_p = run_p;
              pend_at = at;
            }
          }
          if (fbits) {
            run = id;
            run_p = 0;
            run_f = 1;
          }
          seen += __popc(fbits);
          continue;
        }
        T xv[kChunk];  // read whether present or not: absent rows hold stale bytes, never used
        float ws[kChunk];
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          xv[k] = kReadsX ? *reinterpret_cast<const T*>(s_vals + vpos<G>(i + k) * RB + col * (int)sizeof(T)) : (T)0;
          ws[k] = kReadsW ? st.w[i + k] : 0.f;
        }
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          const unsigned p = ((k < 4 ? mb.x : mb.y) >> (8 * (k & 3) + col)) & 1u;
          const T c = p ? contrib<MUL>(xv[k], ws[k]) : id;
          if ((fbits >> k) & 1) {
            run = c;
            run_p = p;
            run_f = 1;
          } else {
            run = apply<OP>(run, c);
            run_p |= p;
          }
          const int upto = seen + __popc(fbits & ((2u << k) - 1u));  // segment starts up to slot k
          const int32_t row =
              in_col && ((ebits >> k) & 1) && i + k < lim && upto > 0 ? s_rows[upto - 1 - rbase] : -1;
          if (row >= 0) {  // -1: a row the mask does not reach
            const int64_t at = (int64_t)row * a.k + col;
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
      };
      switch (a.mul) {
        case kTimes: pass(MulTag<kTimes>{}); break;
        case kPlus: pass(MulTag<kPlus>{}); break;
        case kSecond: pass(MulTag<kSecond>{}); break;
        case kPair: pass(MulTag<kPair>{}); break;
        default: pass(MulTag<kFirst>{}); break;
      }

      // the groups' runs across the block, KP lanes apart
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
      xw[0] = __shfl_up_sync(kFull, rv[0], KP);
      xf = __shfl_up_sync(kFull, rf, KP);
      xp = __shfl_up_sync(kFull, rp, KP);
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
      bar_sync(kBarWorkers, kThreads);
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
      bar_sync(kBarWorkers, kThreads);
      {
        const T pw[1] = {s_wv[wid][col]};
        combine_k<OP>(pw, s_ef[wid], s_wp[wid][col], xw, xf, xp);
      }
      if (tid == 0) {
        C agg[KP];
        unsigned agg_p = 0;
#pragma unroll
        for (int c = 0; c < KP; ++c) {
          agg[c] = (C)s_wv[kWarps][c];
          agg_p |= (s_wp[kWarps][c] & 1u) << c;
        }
#pragma unroll
        for (int c = 0; c < KP; ++c) s_hand_v[hj & 1][c] = agg[c];
        s_hand_f[hj & 1] = s_ef[kWarps];
        s_hand_p[hj & 1] = agg_p;
        s_hand_tile[hj & 1] = t;
      }
      bar_arrive(kBarAggregate, kBlockThreads);
      ++hj;
      held = true;
    }
    cp_async_wait_all();                // nx's structure
    bar_sync(kBarWorkers, kThreads);  // and t's stage, values, presence bytes and rows are read

    // -- gather, second round: each slot's presence bits (valid, and present
    // in the column), then the rows' values where some column is present,
    // the rows of nx's segment ends, and the stream of the tile after nx ----
    if (gathers) {
      const int lane = tid & 31;
      const int pieces = a.k * (int)sizeof(T) / a.vcopy;  // value copies a row
#pragma unroll
      for (int i = 0; i < G::kPerThread; ++i) {
        const int s = tid + i * kThreads;
        const int32_t j = sx.idx[s];
        unsigned m = 0;
        if (sx.valid[s]) {
          if (a.xs == nullptr) {
            m = (1u << a.k) - 1u;
          } else {
            uint32_t cw[CB / 4];
            if constexpr (CB == 16) {
              const uint4 q = *reinterpret_cast<const uint4*>(s_cells + s * CB);
              cw[0] = q.x, cw[1] = q.y, cw[2] = q.z, cw[3] = q.w;
            } else {
#pragma unroll
              for (int q = 0; q < CB / 4; ++q) cw[q] = reinterpret_cast<const uint32_t*>(s_cells + s * CB)[q];
            }
            const int off = (int)((uintptr_t)(a.xs + (int64_t)j * a.k) & cell_mask);  // the row's first byte
#pragma unroll
            for (int c = 0; c < KP; ++c) {
              const int b = off + c;
              uint32_t word = cw[0];
#pragma unroll
              for (int q = 1; q < CB / 4; ++q)
                if (b >= 4 * q) word = cw[q];
              if (c < a.k) m |= (unsigned)(((word >> (8 * (b & 3))) & 0xffu) != 0) << c;
            }
          }
        }
        s_mask[s] = (uint8_t)m;
        if (reads_x) {
          // the warp's present rows in pieces of vcopy bytes, consecutive
          // lanes on consecutive pieces: a row's pieces go out in one
          // instruction, one request; absent rows cost nothing
          const unsigned present = __ballot_sync(kFull, m != 0);
          const int total = __popc(present) * pieces;
          for (int q = lane; q - lane < total; q += 32) {
            const int owner = nth_set(present, q / pieces);
            const int jo = __shfl_sync(kFull, j, owner & 31);
            if (q >= total) continue;
            const int off = (q - q / pieces * pieces) * a.vcopy;
            const unsigned char* src = reinterpret_cast<const unsigned char*>(a.x + (int64_t)jo * a.k) + off;
            unsigned char* dst = s_vals + vpos<G>(s - lane + owner) * RB + off;
            if (a.vcopy == 16) cp_async_stream<16>(dst, src);
            else if (a.vcopy == 8) cp_async<8>(dst, src);
            else cp_async<4>(dst, src);
          }
        }
      }
      // the ordinals of nx's slots run from the flags before it less one to
      // the flags before the next tile less one: that run of the segments'
      // rows (seg_vertex; with a mask the s_tr.kept list or masked_rows) in
      // 16-byte pieces
      const int lo = s_tb[sn][0] > 0 ? s_tb[sn][0] - 1 : 0;
      const int hi = s_tb[sn][1] - 1;
      if (hi >= lo) {
        const uintptr_t from = (uintptr_t)(s_tr.rows + lo) & ~(uintptr_t)15;
        const int pieces = (int)(((uintptr_t)(s_tr.rows + hi) + 4 - from + 15) >> 4);
        for (int q = tid; q < pieces; q += kThreads)
          cp_async_stream<16>(s_rows + 4 * q, reinterpret_cast<const void*>(from + 16 * q));
      }
      // s_tr.kept: the run of list entries of the tile that starts after nx,
      // into t's stage, free since t's scan
      if (s_tr.kept) start_run(sc);
    }
    if (tid == 0) {
      // t's stage is free; a ticket past the last tile ends the block (every
      // later one is past it too)
      start_tile(sc, gathers ? pending : s_tr.nt);
      if (gathers && pending < s_tr.nt) {
        pending = atomicAdd(ticket, 1u);
        if (s_tr.kept) tile_entries(sn, pending);  // its run goes out in the next step's second round
      }
    }
    cp_async_commit();

    bar_sync(kBarWorkers, kThreads);  // the cells and s_tile are read before the next step writes them
  }
  if (held) resolve();
  if (tid == 0) s_hand_tile[hj & 1] = -1;
  bar_arrive(kBarAggregate, kBlockThreads);
}

// The rows a mask selects (spmm_keep): segment o of the plan is kept when
// the mask lets its row, seg_vertex[o], write some column and a slot of it
// lies before pad_from.  One pass over the segments in tiles of kKeepTile,
// taken by ticket.  A thread reads and writes segments kKeepThreads apart
// (a warp's accesses coalesce) and scans kKeepItems consecutive ones, the
// two orders exchanged through shared memory.  The kept segments and their
// slots are counted as one 64-bit word (segments in bits 31-61, slots in
// 0-30), scanned in the block and across tiles by decoupled look-back, the
// word carrying its own value in its status (as Kernel C's descriptors).
// Each kept segment then writes its list entry and the tile_info entries of
// the kept tiles that start in it; the last tile writes the totals.
constexpr int kKeepThreads = 256;
constexpr int kKeepItems = 8;
constexpr int kKeepTile = kKeepThreads * kKeepItems;  // segments a block takes
constexpr uint64_t kKeepValue = (1ull << 62) - 1;     // a status word's value bits
constexpr uint32_t kKeepSlots = (1u << 31) - 1;

struct KeepArgs {
  const uint8_t* bits;        // the mask's writable cells: rows of k bytes, 0 or 1
  const int32_t* seg_vertex;  // segment o's row
  const int32_t* row_first;   // row r's slots: [row_first[r], row_first[r + 1])
  int32_t* kept_row;          // the list, n_kept entries
  int32_t* kept_start;
  int32_t* kept_cum;          // n_kept + 1 entries, the last the kept slots
  int32_t* masked_rows;       // nseg entries
  int32_t* tile_info;         // ceil(kept slots / tile) + 1 entries
  int32_t* hdr;               // kHdrWords words, zeroed
  uint64_t* status;           // a word a keep tile, zeroed
  unsigned long long* tally;  // kept slots and plan slots, added to once a launch
  int64_t nseg, ntiles, n_slots;
  int32_t pad_from;
  int k, tile;
};

__device__ __forceinline__ uint64_t keep_word(uint32_t status, uint64_t v) { return ((uint64_t)status << 62) | v; }
// an item's place in the exchange: one word of padding every 8, so that the
// scan's threads (8 items apart) spread over the banks
__device__ __forceinline__ int keep_at(int e) { return e + (e >> 3); }

// any of the k mask bytes at b set (one word where k is 4 or 8 and the row aligned)
__device__ __forceinline__ bool any_cell(const uint8_t* b, int k) {
  if (k == 4 && ((uintptr_t)b & 3) == 0) return *reinterpret_cast<const uint32_t*>(b) != 0;
  if (k == 8 && ((uintptr_t)b & 7) == 0) return *reinterpret_cast<const uint64_t*>(b) != 0;
  bool any = false;
  for (int c = 0; c < k; ++c) any |= b[c] != 0;
  return any;
}

__global__ void __launch_bounds__(kKeepThreads) spmm_keep(KeepArgs a) {
  __shared__ int64_t s_t;
  __shared__ uint64_t s_items[kKeepTile + kKeepTile / 8];
  __shared__ uint64_t s_warp[kKeepThreads / 32];
  __shared__ uint64_t s_prefix;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  if (tid == 0) s_t = atomicAdd(reinterpret_cast<unsigned*>(a.hdr + kHdrTicket), 1u);
  __syncthreads();
  const int64_t t = s_t;
  const int64_t o0 = t * kKeepTile + tid;  // item i is segment o0 + i kKeepThreads
  int32_t row[kKeepItems], first[kKeepItems], len[kKeepItems];
#pragma unroll
  for (int i = 0; i < kKeepItems; ++i) row[i] = o0 + i * kKeepThreads < a.nseg ? a.seg_vertex[o0 + i * kKeepThreads] : -1;
#pragma unroll
  for (int i = 0; i < kKeepItems; ++i) {
    len[i] = 0;
    first[i] = 0;
    if (row[i] >= 0) {
      const int32_t r = row[i];
      first[i] = a.row_first[r];
      const int32_t e = min(a.row_first[r + 1], a.pad_from);
      len[i] = e > first[i] && any_cell(a.bits + (int64_t)r * a.k, a.k) ? e - first[i] : 0;
    }
    s_items[keep_at(i * kKeepThreads + tid)] = len[i] > 0 ? (1ull << 31) + (uint64_t)len[i] : 0;
  }
  __syncthreads();
  // the block's scan over consecutive items: each thread's 8, within each
  // warp, then over the warps' totals
  uint64_t mine = 0;
#pragma unroll
  for (int j = 0; j < kKeepItems; ++j) mine += s_items[keep_at(tid * kKeepItems + j)];
  uint64_t inc = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint64_t v = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc += v;
  }
  if (lane == 31) s_warp[wid] = inc;
  __syncthreads();
  uint64_t before = inc - mine, total = 0;
#pragma unroll
  for (int w = 0; w < kKeepThreads / 32; ++w) {
    if (w < wid) before += s_warp[w];
    total += s_warp[w];
  }
  // warp 0: the tile's exclusive prefix by decoupled look-back
  if (wid == 0) {
    uint64_t ex = 0;
    if (t > 0) {
      if (lane == 0) st_desc(a.status + t, keep_word(kAggregate, total));
      for (int64_t end = t;; end -= 32) {
        const int64_t i = end - 1 - lane;  // lane 0 the nearest predecessor
        uint64_t d = i >= 0 ? ld_desc(a.status + i) : keep_word(kPrefix, 0);
        unsigned stops, need;
        for (;;) {
          const uint32_t st = status_of(d);
          stops = __ballot_sync(kFull, st == kPrefix);
          const unsigned ready = __ballot_sync(kFull, st != kNone);
          need = stops ? ((stops & (0u - stops)) << 1) - 1u : kFull;
          if ((ready & need) == need) break;
          if (st == kNone) d = ld_desc(a.status + i);
        }
        uint64_t v = ((need >> lane) & 1) ? (d & kKeepValue) : 0;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
        ex += v;
        if (stops) break;
      }
    }
    if (lane == 0) {
      st_desc(a.status + t, keep_word(kPrefix, ex + total));
      s_prefix = ex;
    }
  }
  __syncthreads();
  // each item's exclusive prefix, in place
  uint64_t run = s_prefix + before;
#pragma unroll
  for (int j = 0; j < kKeepItems; ++j) {
    const int e = keep_at(tid * kKeepItems + j);
    const uint64_t v = s_items[e];
    s_items[e] = run;
    run += v;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kKeepItems; ++i) {
    const int64_t o = o0 + i * kKeepThreads;
    if (o >= a.nseg) break;
    a.masked_rows[o] = len[i] > 0 ? row[i] : -1;
    if (len[i] > 0) {
      const uint64_t at = s_items[keep_at(i * kKeepThreads + tid)];
      const int32_t pos = (int32_t)(at >> 31);
      const int32_t cum = (int32_t)(at & kKeepSlots);
      a.kept_row[pos] = row[i];
      a.kept_start[pos] = first[i];
      a.kept_cum[pos] = cum;
      // the kept tiles whose first slot lies in this segment
      for (int64_t tt = ((int64_t)cum + a.tile - 1) / a.tile; tt * a.tile < (int64_t)cum + len[i]; ++tt)
        a.tile_info[tt] = tt * a.tile == cum ? 2 * pos + 1 : 2 * (pos + 1);
    }
  }
  if (t == a.ntiles - 1 && tid == 0) {  // the totals
    const uint64_t all = s_prefix + total;
    const int32_t n_kept = (int32_t)(all >> 31);
    const int32_t kept_slots = (int32_t)(all & kKeepSlots);
    a.hdr[kHdrKept] = n_kept;
    a.hdr[kHdrSlots] = kept_slots;
    a.kept_cum[n_kept] = kept_slots;
    a.tile_info[((int64_t)kept_slots + a.tile - 1) / a.tile] = 2 * n_kept + 1;  // past the last kept tile
    atomicAdd(a.tally, (unsigned long long)kept_slots);
    atomicAdd(a.tally + 1, (unsigned long long)a.n_slots);
  }
}

// Resident blocks an SM of an instantiation.  Its first call lets the
// kernel take its dynamic shared memory and the SM's largest carve-out.
template <typename T, int OP, int KP>
int resident() {
  static int per_sm = 0;
  if (per_sm == 0) {
    auto kernel = spmm_onepass<T, OP, KP>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Geometry<T, KP>::kSmem);
    cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, (int)cudaSharedmemCarveoutMaxShared);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBlockThreads, Geometry<T, KP>::kSmem);
  }
  return per_sm;
}

template <typename T, int OP, int KP>
int launch(SpmmArgs<T> a, int tile, cudaStream_t s) {
  using G = Geometry<T, KP>;
  if (tile != G::kTile) return (int)cudaErrorInvalidValue;  // the caller sized its scratch for another tile
  if (a.n <= 0) return (int)cudaGetLastError();
  a.ntiles = (a.n + G::kTile - 1) / G::kTile;
  const int per_sm = resident<T, OP, KP>();
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int64_t grid = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  if (grid > a.ntiles) grid = a.ntiles;
  spmm_onepass<T, OP, KP><<<(unsigned)grid, kBlockThreads, G::kSmem, s>>>(a);
  return (int)cudaGetLastError();
}

int columns(int k) { return k <= 1 ? 1 : k <= 2 ? 2 : k <= 4 ? 4 : 8; }

template <typename T, int OP>
int by_columns(const SpmmArgs<T>& a, int tile, cudaStream_t s) {
  switch (columns(a.k)) {
    case 1: return launch<T, OP, 1>(a, tile, s);
    case 2: return launch<T, OP, 2>(a, tile, s);
    case 4: return launch<T, OP, 4>(a, tile, s);
    case 8: return launch<T, OP, 8>(a, tile, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The mask's list, or none (hdr null): spmm_keep's outputs.
struct Kept {
  const void *hdr, *kept_row, *kept_start, *kept_cum, *tile_info, *masked_rows;
};

template <typename T>
int typed(const void* x, const void* xs, const void* idx, const void* w, const void* valid, const void* flags,
          const void* seg_vertex, const void* tile_base, void* out_v, void* out_s, void* status, void* vals,
          int64_t n, int k, int op, int mul, int tile, const Kept& kp, cudaStream_t s) {
  const int bulk_ok = aligned16(idx) && aligned16(valid) && aligned16(flags) && (w == nullptr || aligned16(w));
  // the bytes of one value copy: the widest that divides a row and x's alignment
  const int rb = k * (int)sizeof(T);
  const uintptr_t xa = (uintptr_t)x;
  const int vcopy = rb % 16 == 0 && xa % 16 == 0 ? 16 : rb % 8 == 0 && xa % 8 == 0 ? 8 : 4;
  // rows of 4 or 8 structure bytes at aligned places never cross a 16-byte piece
  const int scopy16 = (k == 4 || k == 8) && xs != nullptr && aligned16(xs);
  const SpmmArgs<T> a{(const T*)x, (const uint8_t*)xs, (const int32_t*)idx, (const float*)w,
                      (const uint8_t*)valid, (const uint8_t*)flags, (const int32_t*)seg_vertex,
                      (const int32_t*)tile_base, (T*)out_v, (uint8_t*)out_s, (uint64_t*)status,
                      (uint64_t*)vals, n, 0, k, mul, bulk_ok, vcopy, scopy16,
                      (const int32_t*)kp.hdr, (const int32_t*)kp.kept_row, (const int32_t*)kp.kept_start,
                      (const int32_t*)kp.kept_cum, (const int32_t*)kp.tile_info, (const int32_t*)kp.masked_rows};
  switch (op) {
    case kAdd: return by_columns<T, kAdd>(a, tile, s);
    case kMin: return by_columns<T, kMin>(a, tile, s);
    case kMax: return by_columns<T, kMax>(a, tile, s);
  }
  return (int)cudaErrorInvalidValue;
}

// out: the tile, the dynamic shared memory, the resident blocks an SM, the
// registers and the local (spilled) bytes a thread of the plus instance.
template <typename T, int KP>
void describe(int* out) {
  using G = Geometry<T, KP>;
  cudaFuncAttributes fa{};
  out[2] = resident<T, kAdd, KP>();
  cudaFuncGetAttributes(&fa, spmm_onepass<T, kAdd, KP>);
  out[0] = G::kTile;
  out[1] = G::kSmem;
  out[3] = fa.numRegs;
  out[4] = (int)fa.localSizeBytes;
}

template <typename T>
void describe_columns(int k, int* out) {
  switch (columns(k)) {
    case 1: describe<T, 1>(out); break;
    case 2: describe<T, 2>(out); break;
    case 4: describe<T, 4>(out); break;
    case 8: describe<T, 8>(out); break;
  }
}

}  // namespace

// The k-column kernel's shape for k columns (1-8) of float or double, into
// out[5]: slots a tile, dynamic shared memory bytes, resident blocks an SM,
// registers and local bytes a thread.
extern "C" int gb_segscan_spmm_geometry(int k, int is_double, int* out) {
  if (k < 1 || k > 8) return (int)cudaErrorInvalidValue;
  if (is_double) describe_columns<double>(k, out);
  else describe_columns<float>(k, out);
  return (int)cudaGetLastError();
}

// Y = A (.) X over n dst-order slots, k (1-8) columns.  x: n_src x k values
// (float, or double with is_double); xs: its structure bytes, or null for
// every x present; idx, w (float, or null), valid and flags: n slots;
// seg_vertex: the row of each dst segment; tile_base: ceil(n / 256) + 1
// counts of the flags before each 256-slot block; out_v (values) and out_s
// (structure bytes): n_out x k, zeroed; status: ceil(n / tile) + 1 zeroed
// 64-bit words; vals: 2 x ceil(n / tile) x KP 64-bit words, KP = k rounded
// up to a power of two.  op: 0 plus, 1 min, 2 max; mul: 0 times, 1 plus, 2
// second (w alone), 3 first (x alone), 4 pair (1).  tile: the slots a tile
// that the caller sized status and vals for (gb_segscan_spmm_geometry's);
// another value is refused.  hdr, kept_row, kept_start, kept_cum, tile_info
// and masked_rows: gb_segscan_spmm_keep's outputs, launched before on the
// stream for this tile, or all null: every row.
extern "C" int gb_segscan_spmm(const void* x, const void* xs, const void* idx, const void* w, const void* valid,
                               const void* flags, const void* seg_vertex, const void* tile_base, void* out_v,
                               void* out_s, void* status, void* vals, int64_t n, int k, int is_double, int op,
                               int mul, int tile, void* stream, const void* hdr, const void* kept_row,
                               const void* kept_start, const void* kept_cum, const void* tile_info,
                               const void* masked_rows) {
  if (k < 1 || k > 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Kept kp{hdr, kept_row, kept_start, kept_cum, tile_info, masked_rows};
  if (is_double)
    return typed<double>(x, xs, idx, w, valid, flags, seg_vertex, tile_base, out_v, out_s, status, vals, n, k, op,
                         mul, tile, kp, s);
  return typed<float>(x, xs, idx, w, valid, flags, seg_vertex, tile_base, out_v, out_s, status, vals, n, k, op, mul,
                      tile, kp, s);
}

// The rows a mask selects, for gb_segscan_spmm over n_slots slots in tiles
// of tile slots: bits, n_rows x k bytes (0 or 1), the cells the mask lets
// the product write; segment o (nseg of them) is row seg_vertex[o], its
// slots [row_first[r], row_first[r + 1]) cut at pad_from.  Writes kept_row,
// kept_start (nseg entries), kept_cum (nseg + 1), masked_rows (nseg),
// tile_info (ceil(n_slots / tile) + 1) and the header ctl[0..1], the status
// words after it (ctl: 2 + ceil(nseg / 2048) 64-bit words, zeroed), and adds
// the kept slots and n_slots to tally[0] and tally[1].
extern "C" int gb_segscan_spmm_keep(const void* bits, int k, const void* seg_vertex, const void* row_first,
                                    int64_t nseg, int pad_from, void* kept_row, void* kept_start, void* kept_cum,
                                    void* masked_rows, void* tile_info, void* ctl, void* tally, int64_t n_slots,
                                    int tile, void* stream) {
  if (k < 1 || k > 8 || tile <= 0) return (int)cudaErrorInvalidValue;
  const int64_t ntiles = (nseg + kKeepTile - 1) / kKeepTile;
  if (ntiles == 0) return (int)cudaGetLastError();
  const KeepArgs a{(const uint8_t*)bits, (const int32_t*)seg_vertex, (const int32_t*)row_first, (int32_t*)kept_row,
                   (int32_t*)kept_start, (int32_t*)kept_cum, (int32_t*)masked_rows, (int32_t*)tile_info,
                   (int32_t*)ctl, (uint64_t*)ctl + kHdrWords / 2, (unsigned long long*)tally, nseg, ntiles, n_slots,
                   (int32_t)pad_from, k, tile};
  spmm_keep<<<(unsigned)ntiles, kKeepThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
