// Grouped aggregation over a dense group-id domain, for Hopper.
//
// Replaces the histogram probes of the JAX package
// (experiments/pallas_primitives2.py `t7`, experiments/pallas_primitives3.py
// `t7`: counts of int32 values over 256 bins, a one-hot compare + sum per
// grid step) and is the device form of the `span` masked passes of
// presto1_tpu/ops/hashagg.py `_dense_group_aggregate`, which reads every
// value column once per candidate group.
//
//   word[i] in [0, G) is row i's group; anything else marks a dead row.
//   Per group:  counts, first_row (least row index, n if the group is empty)
//   and one accumulator per recipe slot.  A slot names a value column (read in
//   the type it is stored in: int32, int64, float64 or one byte), an optional
//   validity column, what to take from the value (whole / low 32-bit limb /
//   arithmetic-shift high limb / 1 for a count) and how to reduce it (integer
//   add, float64 add, min, max).  Limbs are split in registers and never
//   stored.  With no slot this is the histogram.
//
// Bound: memory.  Each row is read once (word + every value and validity
// column), G * (K + 2) * 8 bytes are written per block.  Three paths, chosen
// by the caller from the recipe and the shared-memory budget:
//
// * kPathInt, a recipe of integers only (sum / low / high / count / min / max
//   over int32, int64 and one-byte columns; TPC-H Q1's).  Lanes own ROWS, a
//   pair of rows at a time.  Integer add, min and max are exact in any
//   order, so every thread keeps a private table of G x (K + 2) cells in
//   shared memory (cell-major, thread-minor: a warp's lanes touch
//   consecutive words whatever their groups) and folds with plain
//   read-modify-writes, no atomics; the block then reduces its threads'
//   tables.  What bounds it is the fold, not the loads: with a table a
//   thread only 4-5 warps fit an SM (Q1: 1,344 B of table a thread, 144
//   threads), so the design keeps each thread's instruction stream short
//   and independent:
//   - each column is copied once, a pair of rows ahead, into a ring in
//     shared memory by cp.async (no registers held, a thread waits only
//     for its own copies), one 4- or 8-byte copy an element into an 8-byte
//     plane a row, so that a warp reads a row of a column from consecutive
//     words;
//   - "plain" slots (add a column's value or limb, no validity) are decoded
//     once into registers, sorted by column, and folded for both rows of
//     the pair in one branch-free batch: every cell read before any is
//     written (a pair of one group stores its second row's cells last,
//     holding both rows' values); each column is read once a row however
//     many slots take from it; limbs are split in registers;
//   - the other slots (counts, min, max, validity) fold one at a time from
//     a scratch row of values.
//   The plain-slot count is a compile-time 4, 8, 12 or 16.  (One table a
//   warp updated by 64-bit shared atomics was measured against this and
//   lost at every step: compare-and-swap loops on this card.)
// * kPathHist, no slot: 32-bit counts a warp with shared atomics, first rows
//   by 32-bit atomicMin (a plain read first skips it once a first is set);
//   the word read 16 bytes a lane.
// * kPathGeneral, anything else (float64 slots): lanes own slots.  A warp
//   takes 32 consecutive rows a step: lane i reads row i's word.  Then lane
//   k owns slot k: the warp walks its 32 rows, broadcasts each row's group
//   by shuffle, and lane k folds slot k's value of that row into its own
//   cell of the warp's accumulators in shared memory.  A cell has one owner,
//   so there are no atomics and every cell sees its rows in row order:
//   float64 sums are the same from run to run.  With K <= 16 slots the warp
//   splits into 32 / K' sub-warps (K' the next power of two) that take
//   alternate rows into private copies.  Counts and first rows come from one
//   `match_any` over the group ids of a step.  Shared memory holds warps x
//   copies x G x (K + 2) x 8 bytes; the caller's plan lowers the warps a block
//   when G x K is large.
//
// Every path writes one partial a block; a second small kernel combines the
// partials in block order (float64 sums too, so they stay reproducible).
// The TPU kernel's sequential grid with a revisited accumulator tile becomes
// these per-block partials.  Integer sums wrap like int64 tensor arithmetic.
// Plain C interface for ctypes; launches on the caller's stream, does not
// synchronise, allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxCols = 32;
constexpr int kMaxSlots = 64;
constexpr int kMaxWarps = 8;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kSharedBudget = 200 * 1024;
constexpr int kBlockShared = 232448;  // dynamic shared memory a block may use
constexpr int kIntCols = 6;           // distinct columns the int path holds
constexpr int kStages = 2;            // int path: pairs a thread stages

constexpr int kMaxPlain = 16;         // int path: plain slots in registers
constexpr int kHistMaxThreads = 256;

// the caller's choice of path
enum Path { kPathGeneral = 0, kPathInt = 1, kPathHist = 2 };

// how a column is stored
enum ColType { kI32 = 0, kI64 = 1, kF64 = 2, kU8 = 3 };
// what a slot takes from its value
enum Take { kWhole = 0, kLow = 1, kHigh = 2, kOne = 3 };
// how a slot reduces
enum Red { kAddI = 0, kAddF = 1, kMinI = 2, kMaxI = 3, kMinF = 4, kMaxF = 5 };

struct Params {
  const void* col[kMaxCols];
  const uint8_t* valid[kMaxSlots];  // null: every row counts
  int col_type[kMaxCols];
  int slot_col[kMaxSlots];   // unused when slot_take is kOne
  int slot_take[kMaxSlots];
  int slot_red[kMaxSlots];
  int num_slots;
};

__device__ __forceinline__ int64_t identity_of(int red) {
  switch (red) {
    case kMinI: return INT64_MAX;
    case kMaxI: return INT64_MIN;
    case kMinF: return 0x7FF0000000000000ll;                         // +inf
    case kMaxF: return static_cast<int64_t>(0xFFF0000000000000ull);  // -inf
    default: return 0;  // integer 0 and +0.0
  }
}

// a op b on 8-byte accumulators; min/max of floats pass a NaN on
__device__ __forceinline__ int64_t combine(int64_t a, int64_t b, int red) {
  switch (red) {
    case kAddI:
      return static_cast<int64_t>(static_cast<uint64_t>(a) +
                                  static_cast<uint64_t>(b));
    case kAddF:
      return __double_as_longlong(__longlong_as_double(a) +
                                  __longlong_as_double(b));
    case kMinI: return b < a ? b : a;
    case kMaxI: return b > a ? b : a;
    case kMinF: {
      const double x = __longlong_as_double(a), y = __longlong_as_double(b);
      return (y < x || y != y) ? b : a;
    }
    default: {  // kMaxF
      const double x = __longlong_as_double(a), y = __longlong_as_double(b);
      return (y > x || y != y) ? b : a;
    }
  }
}

__device__ __forceinline__ int red_of(const Params& p, int s) {
  return s == 0 ? kAddI : (s == 1 ? kMinI : p.slot_red[s - 2]);
}

// What a lane needs to know of a slot, kept in shared memory.
struct SlotInfo {
  const void* col;
  const uint8_t* valid;
  int col_type, take, red;
};

__device__ __forceinline__ int64_t load_slot(const SlotInfo& si, int64_t row,
                                             int64_t ident) {
  if (si.valid != nullptr && si.valid[row] == 0) return ident;
  if (si.take == kOne) return 1;
  int64_t v;
  switch (si.col_type) {
    case kI32: v = static_cast<const int32_t*>(si.col)[row]; break;
    case kU8: v = static_cast<const uint8_t*>(si.col)[row]; break;
    default: v = static_cast<const int64_t*>(si.col)[row]; break;  // bits
  }
  if (si.take == kLow) return v & 0xFFFFFFFFll;
  if (si.take == kHigh) return v >> 32;  // arithmetic
  return v;
}

// partials: [gridDim.x][G * (K + 2)]; per group: count, first row, K slots.
// sub: lanes of a sub-warp, a power of two, >= K when K <= 32.
// Dynamic shared memory: K SlotInfo, then [warps][32 / sub][G * (K + 2)]
// accumulators.
template <typename W>
__global__ void __launch_bounds__(kMaxWarps * 32)
dense_group_agg_kernel(const W* __restrict__ word, int64_t n, int G,
                       const Params p, int64_t rows_per_block, int sub,
                       int64_t* __restrict__ partials) {
  extern __shared__ int64_t sm_raw[];
  const int K = p.num_slots;
  const int S = K + 2;
  const int GS = G * S;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int copies = 32 / sub;  // sub-warps of a warp, a private copy each

  SlotInfo* info = reinterpret_cast<SlotInfo*>(sm_raw);
  int64_t* sm = sm_raw + (static_cast<size_t>(K) * sizeof(SlotInfo) + 7) / 8;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    SlotInfo si;
    si.col = p.col[p.slot_col[k]];
    si.col_type = p.col_type[p.slot_col[k]];
    si.valid = p.valid[k];
    si.take = p.slot_take[k];
    si.red = p.slot_red[k];
    info[k] = si;
  }
  // the warp's copies; copy 0 also holds the counts and first rows
  int64_t* base_copy = sm + static_cast<int64_t>(warp) * copies * GS;
  for (int t = lane; t < copies * GS; t += 32) {
    const int s = (t % GS) % S;
    base_copy[t] = s == 0 ? 0 : (s == 1 ? n : identity_of(p.slot_red[s - 2]));
  }
  __syncthreads();

  const int my_copy = lane / sub;
  const int my_slot = lane % sub;
  int64_t* mine = base_copy + static_cast<int64_t>(my_copy) * GS;
  // a lane's first slot (its only one unless K > 32) stays in registers
  SlotInfo my_si = {};
  if (my_slot < K) my_si = info[my_slot];

  const int64_t begin = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  int64_t end = begin + rows_per_block;
  if (end > n) end = n;

  for (int64_t base = begin + warp * 32; base < end;
       base += static_cast<int64_t>(warps) * 32) {
    const int64_t row = base + lane;
    int g = G;
    if (row < end) {
      const W w = word[row];
      if (w >= 0 && w < static_cast<W>(G)) g = static_cast<int>(w);
    }
    const unsigned live = __ballot_sync(kFull, g < G);
    if (live == 0) continue;

    // counts and first rows: every lane learns which lanes share its group;
    // the lowest of them adds the group's rows of this step.  One writer a
    // group, so no atomics; the barrier orders this step's writes before
    // the next step's, whose writers may be other lanes.
    const unsigned peers = __match_any_sync(kFull, g);
    if (g < G && lane == __ffs(peers) - 1) {
      base_copy[g * S] += __popc(peers);
      if (row < base_copy[g * S + 1]) base_copy[g * S + 1] = row;
    }
    __syncwarp();

    // lanes own slots: sub-warp c takes rows c, c + copies, ... of the step
    for (int i = my_copy; i < 32; i += copies) {
      const int gi = __shfl_sync(kFull, g, i);
      if (gi >= G) continue;
      for (int k = my_slot; k < K; k += sub) {
        const SlotInfo& si = k == my_slot ? my_si : info[k];
        const int64_t x = load_slot(si, base + i, identity_of(si.red));
        int64_t* a = mine + gi * S + 2 + k;
        *a = combine(*a, x, si.red);
      }
    }
  }
  __syncthreads();

  int64_t* out = partials + static_cast<int64_t>(blockIdx.x) * GS;
  const int all = warps * copies;
  for (int t = threadIdx.x; t < GS; t += blockDim.x) {
    const int red = red_of(p, t % S);
    int64_t v = sm[t];
    for (int c = 1; c < all; ++c)
      v = combine(v, sm[static_cast<int64_t>(c) * GS + t], red);
    out[t] = v;
  }
}

// partials combined in a fixed order: one warp a (group, slot) cell, lane l
// folds blocks l, l + 32, ... and a shuffle tree folds the lanes
constexpr int kFinishWarps = 4;

__global__ void __launch_bounds__(kFinishWarps * 32)
dense_group_agg_finish(const int64_t* __restrict__ partials, int blocks,
                       int G, const Params p, int64_t* __restrict__ counts,
                       int64_t* __restrict__ first_row,
                       int64_t* __restrict__ table) {
  const int K = p.num_slots;
  const int S = K + 2;
  const int GS = G * S;
  const int t = blockIdx.x * kFinishWarps + (threadIdx.x >> 5);
  if (t >= GS) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int g = t / S;
  const int s = t % S;
  const int red = red_of(p, s);
  int64_t v = identity_of(red);
  for (int b = lane; b < blocks; b += 32)
    v = combine(v, partials[static_cast<int64_t>(b) * GS + t], red);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = combine(v, __shfl_down_sync(kFull, v, off), red);
  if (lane != 0) return;
  if (s == 0) counts[g] = v;
  else if (s == 1) first_row[g] = v;
  else table[static_cast<int64_t>(g) * K + (s - 2)] = v;
}

// ------------------------------------------------------- integer-only path

// A slot of the int path as it folds, packed in one word:
constexpr unsigned kCodeCol = 7u;         // bits 0-2: its value column
constexpr unsigned kCodeHigh = 1u << 3;   // take x >> 32 (arithmetic)
constexpr unsigned kCodeLow = 1u << 4;    // take x & 0xFFFFFFFF
constexpr unsigned kCodeOne = 1u << 5;    // take 1 (a count)
constexpr int kCodeOp = 6;                // bits 6-7: 0 add, 1 min, 2 max
constexpr int kCodeValid = 8;             // bits 8-15: validity columns

// The recipe as the int path reads it: the distinct columns (values and
// validity, at most kIntCols) and one code a slot.  The slots that add
// without a validity column come first (`num_plain` of them): they fold in
// a loop of their own, four at a time.
struct IntParams {
  const void* col[kIntCols];
  int col_type[kIntCols];     // kI32, kI64 or kU8
  int num_cols;
  int num_plain;
  unsigned code[kMaxSlots];   // in fold order
  int cell[kMaxSlots];        // the slot's cell in its group: 2 + slot
  int cell_op[kMaxSlots + 2];  // how each cell of a group folds
  int num_slots;
};

// Row `row` of every column, by scalar loads (the rows outside the pairs).
__device__ __forceinline__ void load_cols(const IntParams& q, int64_t row,
                                          int64_t (&v)[kIntCols]) {
#pragma unroll
  for (int c = 0; c < kIntCols; ++c) {
    if (c >= q.num_cols) continue;
    switch (q.col_type[c]) {
      case kI64: v[c] = __ldg(static_cast<const int64_t*>(q.col[c]) + row);
        break;
      case kI32: v[c] = __ldg(static_cast<const int32_t*>(q.col[c]) + row);
        break;
      default: v[c] = __ldg(static_cast<const uint8_t*>(q.col[c]) + row);
        break;
    }
  }
}

__device__ __forceinline__ int64_t int_identity(int op) {
  return op == 0 ? 0 : (op == 1 ? INT64_MAX : INT64_MIN);
}

__device__ __forceinline__ int64_t int_fold(int64_t a, int64_t x, int op) {
  if (op == 0)
    return static_cast<int64_t>(static_cast<uint64_t>(a) +
                                static_cast<uint64_t>(x));
  return op == 1 ? (x < a ? x : a) : (x > a ? x : a);
}

// What a slot takes from its column's value x under its code.
__device__ __forceinline__ int64_t take(int64_t x, unsigned code) {
  if (code & kCodeHigh) x >>= 32;  // arithmetic
  if (code & kCodeLow) x &= 0xFFFFFFFFll;
  return (code & kCodeOne) ? 1 : x;
}

// A staged value as an int64: 8 bytes, or 4 (sign-extended) in the low
// half of an 8-byte word.
__device__ __forceinline__ int64_t staged_value(const char* at, int bytes) {
  const int64_t v = *reinterpret_cast<const int64_t*>(at);
  return bytes == 8 ? v : static_cast<int64_t>(static_cast<int32_t>(v));
}

// The slots that are not plain, one at a time, for one row (its values in
// xs, its validity bits vb).
__device__ __forceinline__ void fold_rest(const IntParams& q, int64_t* cell,
                                          int step, const int64_t* xs,
                                          int xstep, unsigned vb) {
  for (int k = q.num_plain; k < q.num_slots; ++k) {
    const unsigned cd = q.code[k];
    const int op = (cd >> kCodeOp) & 3;
    const unsigned need = cd >> kCodeValid;
    const int64_t x = (vb & need) == need
                          ? take(xs[(cd & kCodeCol) * xstep], cd)
                          : int_identity(op);
    int64_t* a = cell + q.cell[k] * step;
    *a = int_fold(*a, x, op);
  }
}

// Both rows of a staged pair into their groups' cells (cell_a for the first
// row, cell_b for the second; for a dead row, the other's cells, with its
// values masked to nothing): count, first row and the plain slots.  Every
// cell of both rows is read before any is written, so a pair of two groups
// has twice the independent work of one row; a pair of one group stores
// its second row's cells last, with both rows' values in them.
template <int kPlain>
__device__ __forceinline__ void fold_pair(
    const IntParams& q, int64_t* cell_a, int64_t* cell_b, int step,
    bool live0, bool live1, int64_t row, const char* staged0,
    const char* staged1, const int (&pcol)[kPlain + 1],
    const int (&psz)[kPlain + 1], const int (&psh)[kPlain + 1],
    const int64_t (&pmask)[kPlain + 1], const int (&poff)[kPlain + 1],
    const bool (&pnew)[kPlain + 1]) {
  const bool same = cell_a == cell_b;
  const int64_t m0 = live0 ? -1 : 0, m1 = live1 ? -1 : 0;
  const int64_t na = cell_a[0], nb = cell_b[0];
  const int64_t fa = cell_a[step], fb = cell_b[step];
  int64_t x0[kPlain + 1], x1[kPlain + 1], oa[kPlain + 1], ob[kPlain + 1];
  int64_t v0 = 0, v1 = 0;  // the current column's values of both rows
#pragma unroll
  for (int u = 0; u < kPlain; ++u) {
    if (pnew[u]) {  // the slots are sorted by column: read each once
      v0 = staged_value(staged0 + pcol[u], psz[u]);
      v1 = staged_value(staged1 + pcol[u], psz[u]);
    }
    x0[u] = (v0 >> psh[u]) & pmask[u] & m0;
    x1[u] = (v1 >> psh[u]) & pmask[u] & m1;
    oa[u] = cell_a[poff[u]];
    ob[u] = cell_b[poff[u]];
  }
  const int64_t r0 = live0 ? row : INT64_MAX;
  const int64_t r1 = live1 ? row + 1 : INT64_MAX;
  cell_a[0] = na + (live0 ? 1 : 0);
  cell_a[step] = r0 < fa ? r0 : fa;
  const int64_t rb = same && r0 < r1 ? r0 : r1;
  cell_b[0] = nb + (live1 ? 1 : 0) + (same && live0 ? 1 : 0);
  cell_b[step] = rb < fb ? rb : fb;
#pragma unroll
  for (int u = 0; u < kPlain; ++u) {
    if (u >= q.num_plain) continue;  // a predicated store
    cell_a[poff[u]] = static_cast<int64_t>(static_cast<uint64_t>(oa[u]) +
                                           static_cast<uint64_t>(x0[u]));
  }
#pragma unroll
  for (int u = 0; u < kPlain; ++u) {
    if (u >= q.num_plain) continue;
    cell_b[poff[u]] = static_cast<int64_t>(
        static_cast<uint64_t>(ob[u]) + static_cast<uint64_t>(x1[u]) +
        static_cast<uint64_t>(same ? x0[u] : 0));
  }
}

// One live row into its group's cells, cell s at cell[s * step]: the count
// (s = 0), the first row (1), then the slots.  The row's column values are
// in xs[c * xstep] (shared memory), so a slot reads its column by index;
// vb: bit c set when column c of the row is not 0 (validity).  For the
// recipes that fold_pair does not take (the plain slots read at run time):
// the slots that add without validity four at a time, the four cells read
// before any is written; the others one at a time.
__device__ __forceinline__ void fold_row(const IntParams& q, int64_t* cell,
                                         int step, const int64_t* xs,
                                         int xstep, int64_t row,
                                         unsigned vb) {
  const int64_t n0 = cell[0], f0 = cell[step];
  cell[0] = n0 + 1;
  cell[step] = row < f0 ? row : f0;
  for (int k0 = 0; k0 < q.num_plain; k0 += 4) {
    int64_t x[4], old[4];
    int off[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (k0 + u >= q.num_plain) continue;
      const unsigned cd = q.code[k0 + u];
      off[u] = q.cell[k0 + u] * step;
      x[u] = take(xs[(cd & kCodeCol) * xstep], cd);
      old[u] = cell[off[u]];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (k0 + u >= q.num_plain) continue;
      cell[off[u]] = static_cast<int64_t>(static_cast<uint64_t>(old[u]) +
                                          static_cast<uint64_t>(x[u]));
    }
  }
  fold_rest(q, cell, step, xs, xstep, vb);
}

// An asynchronous copy of 4, 8 or 16 bytes from device to shared memory.
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__device__ __forceinline__ int col_bytes(int type) {
  return type == kI64 ? 8 : (type == kI32 ? 4 : 1);
}

// Copies of rows row and row + 1 of the word (column num_cols) and of
// every column wider than a byte into a thread's stage slot: value (c, r)
// at slot + c * cstride + r * rstride, 8 bytes a thread (a 4-byte value in
// the low half), so that a warp reads one row of a column from consecutive
// words.  Byte columns are read when the pair folds.  (A pair of an int64
// column is 16 contiguous bytes, but one 16-byte copy a pair, read back
// with one 16-byte shared load, ran slower at every shape measured: see
// PERF.md.)
template <typename W>
__device__ __forceinline__ void stage_pair(const IntParams& q, const W* word,
                                           int64_t row, char* slot,
                                           int cstride, int rstride) {
  char* wd = slot + q.num_cols * cstride;
  cp_async(wd, word + row, sizeof(W));
  cp_async(wd + rstride, word + row + 1, sizeof(W));
#pragma unroll
  for (int c = 0; c < kIntCols; ++c) {
    if (c >= q.num_cols || q.col_type[c] == kU8) continue;
    const int e = col_bytes(q.col_type[c]);
    const char* src = static_cast<const char*>(q.col[c]) + row * e;
    cp_async(slot + c * cstride, src, e);
    cp_async(slot + c * cstride + rstride, src + e, e);
  }
}

// Row row + r (r = 0, 1) of a staged pair: its values in xs (byte columns
// read here); returns its validity bits.
__device__ __forceinline__ unsigned staged_row(const IntParams& q,
                                               const char* slot, int cstride,
                                               int rstride, int64_t row,
                                               int r, int64_t* xs,
                                               int xstep) {
  unsigned vb = 0;
#pragma unroll
  for (int c = 0; c < kIntCols; ++c) {
    if (c >= q.num_cols) continue;
    const int64_t x =
        q.col_type[c] == kU8
            ? __ldg(static_cast<const uint8_t*>(q.col[c]) + row + r)
            : staged_value(slot + c * cstride + r * rstride,
                           col_bytes(q.col_type[c]));
    xs[c * xstep] = x;
    if (x != 0) vb |= 1u << c;
  }
  return vb;
}

// The row's values into its thread's scratch; its validity bits.
__device__ __forceinline__ unsigned stage_row(const IntParams& q,
                                              const int64_t (&v)[kIntCols],
                                              int64_t* xs, int xstep) {
  unsigned vb = 0;
#pragma unroll
  for (int c = 0; c < kIntCols; ++c) {
    if (c >= q.num_cols) continue;
    xs[c * xstep] = v[c];
    if (v[c] != 0) vb |= 1u << c;
  }
  return vb;
}

// partials: [gridDim.x][G * S], S = K + 2; per group: count, first, slots.
// Rows [0, 2 * pairs) are taken two at a time, block b owning pairs
// [b * pairs_per_block, ...); block 0 also takes the last row when n is
// odd.  A table a thread: cell (g, s) of thread t at
// [(g * S + s) * blockDim + t] (the lanes of a warp touch consecutive words
// whatever their groups: no bank conflict).
template <typename W, int kPlain>
__global__ void __launch_bounds__(256)
dense_int_kernel(const W* __restrict__ word, int64_t n, int G,
                 const IntParams q, int64_t pairs,
                 int64_t pairs_per_block, int64_t* __restrict__ partials) {
  extern __shared__ int64_t tab[];
  const int S = q.num_slots + 2;
  const int GS = G * S;
  const int T = blockDim.x;
  // cell s of group g: mine[(g * S + s) * T]
  int64_t* mine = tab + threadIdx.x;
  // the thread's scratch for one row's values, after the tables
  int64_t* xs = tab + static_cast<int64_t>(T) * GS + threadIdx.x;
  for (int t = threadIdx.x; t < T * GS; t += T) {
    const int s = (t / T) % S;
    tab[t] = s == 1 ? n : int_identity(q.cell_op[s]);
  }
  // A ring of kStages slots a thread in shared memory, after the scratch:
  // the pair k iterations ahead is being copied while this one folds.  A
  // thread reads only what it copied itself, so waiting for its own copies
  // is enough: no barrier.
  const int rstride = T * 8;                       // between a pair's rows
  const int cstride = 2 * rstride;                 // between two columns
  const int sstride = (q.num_cols + 1) * cstride;  // between two slots
  // the plain slots, decoded once: column offset in the stage, width,
  // shift, mask, cell offset (a padding slot adds 0 to the count cell)
  int pcol[kPlain + 1], psz[kPlain + 1], psh[kPlain + 1], poff[kPlain + 1];
  int64_t pmask[kPlain + 1];
  bool pnew[kPlain + 1];  // the slot reads another column than the last
#pragma unroll
  for (int u = 0; u < kPlain; ++u) {
    const bool real = u < q.num_plain;
    const unsigned cd = real ? q.code[u] : 0u;
    pcol[u] = static_cast<int>(cd & kCodeCol) * cstride;  // stage plane
    psz[u] = q.col_type[cd & kCodeCol] == kI64 ? 8 : 4;
    psh[u] = (cd & kCodeHigh) ? 32 : 0;
    pmask[u] = !real ? 0 : ((cd & kCodeLow) ? 0xFFFFFFFFll : -1ll);
    poff[u] = real ? q.cell[u] * T : 0;
    pnew[u] = u == 0 || pcol[u] != pcol[u - 1];
  }
  __syncthreads();

  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * pairs_per_block;
  int64_t p1 = p0 + pairs_per_block;
  if (p1 > pairs) p1 = pairs;
  const bool rest = kPlain == 0 || q.num_plain < q.num_slots;
  const int64_t words =
      static_cast<int64_t>(T) * GS + (rest ? T * kIntCols : 0);
  char* ring = reinterpret_cast<char*>(tab + (words + 1) / 2 * 2) +
               threadIdx.x * 8;
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    const int64_t pp = p0 + threadIdx.x + k * static_cast<int64_t>(T);
    if (pp < p1)
      stage_pair<W>(q, word, 2 * pp, ring + k * sstride, cstride, rstride);
    cp_async_commit();
  }
  const int word_at = q.num_cols * cstride;  // the word's pair in a slot
  int slot = 0;
  for (int64_t p = p0 + threadIdx.x; p < p1; p += T) {
    const int64_t ahead = p + (kStages - 1) * static_cast<int64_t>(T);
    if (ahead < p1)
      stage_pair<W>(q, word, 2 * ahead,
                    ring + ((slot + kStages - 1) % kStages) * sstride,
                    cstride, rstride);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // pair p's copies have landed
    const char* here = ring + slot * sstride;
    const int64_t row = 2 * p;
    const int64_t g0 = *reinterpret_cast<const W*>(here + word_at);
    const int64_t g1 = *reinterpret_cast<const W*>(here + word_at + rstride);
    if (kPlain > 0) {  // the pair together
      const bool live0 = g0 >= 0 && g0 < G, live1 = g1 >= 0 && g1 < G;
      if (live0 || live1) {
        int64_t* ca = mine + (live0 ? g0 : g1) * S * T;
        int64_t* cb = mine + (live1 ? g1 : g0) * S * T;
        fold_pair<kPlain>(q, ca, cb, T, live0, live1, row, here,
                          here + rstride, pcol, psz, psh, pmask, poff, pnew);
        if (q.num_plain < q.num_slots) {
          if (live0)
            fold_rest(q, ca, T, xs, T,
                      staged_row(q, here, cstride, rstride, row, 0, xs, T));
          if (live1)
            fold_rest(q, cb, T, xs, T,
                      staged_row(q, here, cstride, rstride, row, 1, xs, T));
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int64_t g = r == 0 ? g0 : g1;
        if (g < 0 || g >= G) continue;
        fold_row(q, mine + g * S * T, T, xs, T, row + r,
                 staged_row(q, here, cstride, rstride, row, r, xs, T));
      }
    }
    slot = slot + 1 == kStages ? 0 : slot + 1;
  }
  cp_async_wait<0>();
  // the last row when n is odd: thread 0 of block 0
  const int64_t row = 2 * pairs;
  if (blockIdx.x == 0 && threadIdx.x == 0 && row < n) {
    const int64_t g = word[row];
    if (g >= 0 && g < G) {
      int64_t v[kIntCols];
      load_cols(q, row, v);
      // staged as the pairs are, in the ring's (now idle) first slot
#pragma unroll
      for (int c = 0; c < kIntCols; ++c) {
        if (c >= q.num_cols) continue;
        if (q.col_type[c] == kI64)
          *reinterpret_cast<int64_t*>(ring + c * cstride) = v[c];
        else if (q.col_type[c] == kI32)
          *reinterpret_cast<int32_t*>(ring + c * cstride) =
              static_cast<int32_t>(v[c]);
      }
      int64_t* cell = mine + g * S * T;
      if (kPlain > 0) {  // as a pair whose second row is dead
        fold_pair<kPlain>(q, cell, cell, T, true, false, row, ring, ring,
                          pcol, psz, psh, pmask, poff, pnew);
        if (rest) fold_rest(q, cell, T, xs, T, stage_row(q, v, xs, T));
      } else {
        fold_row(q, cell, T, xs, T, row, stage_row(q, v, xs, T));
      }
    }
  }
  __syncthreads();
  // the block's partial: each cell over the block's tables, in any order
  int64_t* out = partials + static_cast<int64_t>(blockIdx.x) * GS;
  for (int t = threadIdx.x; t < GS; t += T) {
    const int op = q.cell_op[t % S];
    int64_t acc = int_identity(op);
    // each thread starts at another table: the lanes meet every bank
    for (int i = 0, at = t % T; i < T; ++i) {
      acc = int_fold(acc, tab[static_cast<int64_t>(t) * T + at], op);
      at = at + 1 == T ? 0 : at + 1;
    }
    out[t] = acc;
  }
}

// ------------------------------------------------------------ histogram path

// partials as above with S = 2.  The word is read as 16-byte vectors
// [vec0, vec0 + vecs) (rows head .. head + vecs * R), block b owning
// vectors [b * vecs_per_block, ...); block 0 also takes the rows outside.
// Rows are counted in 32 bits (n < 2^32).
template <typename W>
__global__ void __launch_bounds__(256)
dense_hist_kernel(const W* __restrict__ word, int64_t n, int G, int64_t head,
                  int64_t vecs, int64_t vecs_per_block,
                  int64_t* __restrict__ partials) {
  constexpr int R = 16 / sizeof(W);
  extern __shared__ unsigned hs[];
  const int warps = blockDim.x >> 5;
  unsigned* cnt = hs + (threadIdx.x >> 5) * G;
  unsigned* first = hs + warps * G;
  for (int t = threadIdx.x; t < (warps + 1) * G; t += blockDim.x)
    hs[t] = t < warps * G ? 0u : 0xFFFFFFFFu;
  __syncthreads();
  const int64_t v0 = static_cast<int64_t>(blockIdx.x) * vecs_per_block;
  int64_t v1 = v0 + vecs_per_block;
  if (v1 > vecs) v1 = vecs;
  const W* base = word + head;
  for (int64_t v = v0 + threadIdx.x; v < v1; v += blockDim.x) {
    const int4 q4 = __ldg(reinterpret_cast<const int4*>(base) + v);
    W x[R];
    if constexpr (R == 4) {
      x[0] = q4.x; x[1] = q4.y; x[2] = q4.z; x[3] = q4.w;
    } else {
      const uint64_t lo = static_cast<unsigned>(q4.x) |
                          static_cast<uint64_t>(static_cast<unsigned>(q4.y))
                              << 32;
      const uint64_t hi = static_cast<unsigned>(q4.z) |
                          static_cast<uint64_t>(static_cast<unsigned>(q4.w))
                              << 32;
      x[0] = static_cast<W>(lo);
      x[1] = static_cast<W>(hi);
    }
    const unsigned row0 = static_cast<unsigned>(head + v * R);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (x[j] < 0 || x[j] >= static_cast<W>(G)) continue;
      const int g = static_cast<int>(x[j]);
      atomicAdd(cnt + g, 1u);
      if (row0 + j < *static_cast<volatile unsigned*>(first + g))
        atomicMin(first + g, row0 + j);
    }
  }
  if (blockIdx.x == 0) {  // rows outside the vectors: fewer than 2R
    const int64_t tail = head + vecs * R;
    const int64_t outside = head + (n - tail);
    for (int64_t t = threadIdx.x; t < outside; t += blockDim.x) {
      const int64_t row = t < head ? t : tail + (t - head);
      const W x = word[row];
      if (x < 0 || x >= static_cast<W>(G)) continue;
      atomicAdd(cnt + x, 1u);
      atomicMin(first + x, static_cast<unsigned>(row));
    }
  }
  __syncthreads();
  int64_t* out = partials + static_cast<int64_t>(blockIdx.x) * G * 2;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    int64_t c = 0;
    for (int w = 0; w < warps; ++w) c += hs[w * G + g];
    out[2 * g] = c;
    out[2 * g + 1] = first[g] == 0xFFFFFFFFu ? n : first[g];
  }
}

// Each launcher takes the caller's threads a block and shared bytes a block
// (the launch plan is made by the caller) and checks them against the
// layout its kernel addresses: a plan that does not match is refused.

int set_shared(const void* kernel, size_t shared) {
  if (shared <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shared)));
}

// Shared bytes of the general path at `warps` warps a block: K SlotInfo,
// then [warps][copies][G * (K + 2)] accumulators.
size_t general_shared(int G, int K, int warps, int* sub_out) {
  int sub = 32;  // lanes of a sub-warp: the least power of two >= K
  if (K >= 1 && K <= 16) {
    sub = 1;
    while (sub < K) sub *= 2;
  }
  *sub_out = sub;
  const size_t info_bytes =
      (static_cast<size_t>(K) * sizeof(SlotInfo) + 7) / 8 * 8;
  return info_bytes + static_cast<size_t>(warps) * (32 / sub) * G * (K + 2) *
                          sizeof(int64_t);
}

template <typename W>
int run_general(const void* word, int64_t n, int G, const Params& p,
                int threads, size_t shared, int blocks, void* partials,
                cudaStream_t stream) {
  if (threads < 32 || threads > kMaxWarps * 32 || threads % 32 != 0)
    return -11;
  int sub = 32;
  if (general_shared(G, p.num_slots, threads / 32, &sub) != shared)
    return -18;
  if (shared > static_cast<size_t>(kSharedBudget)) return -9;
  const int e = set_shared(
      reinterpret_cast<const void*>(dense_group_agg_kernel<W>), shared);
  if (e != 0) return e;
  int64_t rows_per_block = (n + blocks - 1) / blocks;
  rows_per_block = (rows_per_block + 31) / 32 * 32;
  dense_group_agg_kernel<W><<<blocks, threads, shared, stream>>>(
      static_cast<const W*>(word), n, G, p, rows_per_block, sub,
      static_cast<int64_t*>(partials));
  return static_cast<int>(cudaGetLastError());
}

// Shared bytes of the int path at T threads a block: a table a thread, a
// row of values a thread (`scratch`: for the slots that are not plain, and
// for every slot when the plain ones fold at run time), then kStages slots
// of 16 bytes a column (and the word) a thread.
size_t int_shared(int G, int K, int T, int nc, bool scratch) {
  const size_t words = static_cast<size_t>(T) * G * (K + 2) +
                       (scratch ? static_cast<size_t>(T) * kIntCols : 0);
  return (words + 1) / 2 * 16 +
         static_cast<size_t>(T) * kStages * (nc + 1) * 16;
}

template <typename W, int kPlain>
int launch_int(const void* word, int64_t n, int G, const IntParams& q,
               int threads, size_t shared, int blocks, void* partials,
               cudaStream_t stream) {
  const bool scratch = kPlain == 0 || q.num_plain < q.num_slots;
  if (int_shared(G, q.num_slots, threads, q.num_cols, scratch) != shared)
    return -18;
  if (shared > static_cast<size_t>(kBlockShared)) return -12;
  const int e = set_shared(
      reinterpret_cast<const void*>(dense_int_kernel<W, kPlain>), shared);
  if (e != 0) return e;
  const int64_t pairs = n / 2;
  const int64_t per_block = (pairs + blocks - 1) / blocks;
  dense_int_kernel<W, kPlain><<<blocks, threads, shared, stream>>>(
      static_cast<const W*>(word), n, G, q, pairs, per_block,
      static_cast<int64_t*>(partials));
  return static_cast<int>(cudaGetLastError());
}

// The int path with the plain slots' count rounded up to 4, 8, 12 or 16 at
// compile time (their codes then stay in registers), or read at run time.
template <typename W>
int run_int(const void* word, int64_t n, int G, const IntParams& q,
            int threads, size_t shared, int blocks, void* partials,
            cudaStream_t stream) {
  if (threads < 32 || threads > 256 || threads % 16 != 0) return -11;
  const int np = q.num_plain;
  if (np == 0 || np > kMaxPlain)
    return launch_int<W, 0>(word, n, G, q, threads, shared, blocks, partials,
                            stream);
  if (np <= 4)
    return launch_int<W, 4>(word, n, G, q, threads, shared, blocks, partials,
                            stream);
  if (np <= 8)
    return launch_int<W, 8>(word, n, G, q, threads, shared, blocks, partials,
                            stream);
  if (np <= 12)
    return launch_int<W, 12>(word, n, G, q, threads, shared, blocks,
                             partials, stream);
  return launch_int<W, 16>(word, n, G, q, threads, shared, blocks, partials,
                           stream);
}

template <typename W>
int run_hist(const void* word, int64_t n, int G, int threads, size_t shared,
             int blocks, void* partials, cudaStream_t stream) {
  if (n >= 0xFFFFFFFFll) return -13;  // rows are counted in 32 bits
  if (threads < 32 || threads > kHistMaxThreads || threads % 32 != 0)
    return -11;
  if (shared != static_cast<size_t>(threads / 32 + 1) * G * sizeof(unsigned))
    return -18;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(word);
  if (addr % sizeof(W) != 0) return -14;
  constexpr int R = 16 / sizeof(W);
  int64_t head = static_cast<int64_t>((16 - addr % 16) % 16 / sizeof(W));
  if (head > n) head = n;
  const int64_t vecs = (n - head) / R;
  const int64_t per_block = (vecs + blocks - 1) / blocks;
  dense_hist_kernel<W><<<blocks, threads, shared, stream>>>(
      static_cast<const W*>(word), n, G, head, vecs, per_block,
      static_cast<int64_t*>(partials));
  return static_cast<int>(cudaGetLastError());
}

// The recipe as the int path reads it: every value column a slot reads,
// then every distinct validity column, each once; the slots' codes, those
// that add without validity first.
int int_params(int num_cols, const void* const* cols, const int* col_type,
               int num_slots, const int* slot_col, const int* slot_take,
               const int* slot_reduce, const void* const* slot_valid,
               IntParams* q) {
  *q = IntParams{};
  if (num_slots < 1) return -16;
  q->num_slots = num_slots;
  q->cell_op[0] = 0;  // counts add
  q->cell_op[1] = 1;  // first rows: least
  int map[kMaxCols];
  for (int c = 0; c < kMaxCols; ++c) map[c] = -1;
  for (int k = 0; k < num_slots; ++k) {
    q->cell_op[2 + k] = slot_reduce[k];
    if (slot_take[k] == kOne) continue;
    const int c = slot_col[k];
    if (col_type[c] == kF64) return -15;
    if (map[c] >= 0) continue;
    if (q->num_cols == kIntCols) return -16;
    map[c] = q->num_cols;
    q->col[q->num_cols] = cols[c];
    q->col_type[q->num_cols++] = col_type[c];
  }
  unsigned code[kMaxSlots];
  for (int k = 0; k < num_slots; ++k) {
    unsigned cd = static_cast<unsigned>(slot_reduce[k]) << kCodeOp;
    if (slot_take[k] == kOne) cd |= kCodeOne;
    else cd |= static_cast<unsigned>(map[slot_col[k]]);
    if (slot_take[k] == kHigh) cd |= kCodeHigh;
    if (slot_take[k] == kLow) cd |= kCodeLow;
    if (slot_valid[k] != nullptr) {
      int vc = -1;
      for (int c = 0; c < q->num_cols; ++c)
        if (q->col[c] == slot_valid[k] && q->col_type[c] == kU8) vc = c;
      if (vc < 0) {
        if (q->num_cols == kIntCols) return -16;
        vc = q->num_cols;
        q->col[q->num_cols] = slot_valid[k];
        q->col_type[q->num_cols++] = kU8;
      }
      cd |= 1u << (kCodeValid + vc);
    }
    code[k] = cd;
  }
  // plain slots by column (then by slot), so that a row reads each
  // column once; then the others
  int order[kMaxSlots];
  for (int k = 0; k < num_slots; ++k) order[k] = k;
  for (int i = 1; i < num_slots; ++i)
    for (int j = i; j > 0 && (code[order[j - 1]] & kCodeCol) >
                                 (code[order[j]] & kCodeCol); --j) {
      const int t = order[j];
      order[j] = order[j - 1];
      order[j - 1] = t;
    }
  for (int pass = 0, at = 0; pass < 2; ++pass)
    for (int i = 0; i < num_slots; ++i) {
      const int k = order[i];
      // add a staged column's value (not 1, not a byte) without validity
      const bool plain = (code[k] >> kCodeOp) == 0 &&
                         !(code[k] & kCodeOne) &&
                         q->col_type[code[k] & kCodeCol] != kU8;
      if (plain != (pass == 0)) continue;
      q->code[at] = code[k];
      q->cell[at++] = 2 + k;
      if (plain) q->num_plain = at;
    }
  return 0;
}

int finish(const void* partials, int blocks, int G, const Params& p,
           void* counts, void* first_row, void* table, cudaStream_t stream) {
  const int GS = G * (p.num_slots + 2);
  dense_group_agg_finish<<<(GS + kFinishWarps - 1) / kFinishWarps,
                           kFinishWarps * 32, 0, stream>>>(
      static_cast<const int64_t*>(partials), blocks, G, p,
      static_cast<int64_t*>(counts), static_cast<int64_t*>(first_row),
      static_cast<int64_t*>(table));
  return static_cast<int>(cudaGetLastError());
}

template <typename W>
int run(int path, const void* word, int64_t n, int G, const Params& p,
        const IntParams& q, int threads, size_t shared, int blocks,
        void* partials, cudaStream_t stream) {
  switch (path) {
    case kPathGeneral:
      return run_general<W>(word, n, G, p, threads, shared, blocks, partials,
                            stream);
    case kPathInt:
      return run_int<W>(word, n, G, q, threads, shared, blocks, partials,
                        stream);
    default:
      return run_hist<W>(word, n, G, threads, shared, blocks, partials,
                         stream);
  }
}

}  // namespace


// word: int32 (word_w 4) or int64 (word_w 8) [n] on the device.
// cols / col_type: num_cols device pointers and their ColType codes.
// slot_col / slot_take / slot_reduce / slot_valid: num_slots entries;
//   slot_reduce 0 = add, 1 = min, 2 = max (typed by the slot's column);
//   slot_valid[k] is a one-byte-per-row device pointer or null.
// path: kPathGeneral, kPathInt (integer recipe) or kPathHist (no slot);
//   threads, shared: the path's threads and dynamic shared bytes a block,
//   as the caller's plan gives them (checked against the path's layout).
// partials: int64 [blocks * G * (num_slots + 2)] scratch, every entry written.
// counts, first_row: int64 [G]; table: 8-byte [G * num_slots] (float64 slots
// hold the bits of a double).
// Returns cudaGetLastError() after the launches, or a negative code for an
// argument the kernel does not take.
extern "C" int p1_dense_group_agg(
    const void* word, int word_w, int64_t n, int G, int num_cols,
    const void* const* cols, const int* col_type, int num_slots,
    const int* slot_col, const int* slot_take, const int* slot_reduce,
    const void* const* slot_valid, int path, int threads, int64_t shared,
    int blocks, void* partials, void* counts, void* first_row, void* table,
    void* stream) {
  if (n <= 0 || blocks <= 0) return -1;
  if (G <= 0 || G > 256) return -2;
  if (num_cols < 0 || num_cols > kMaxCols || num_slots < 0 ||
      num_slots > kMaxSlots)
    return -3;
  if (word_w != 4 && word_w != 8) return -10;
  if (path < kPathGeneral || path > kPathHist) return -17;
  if (path == kPathHist && num_slots != 0) return -17;
  Params p = {};
  p.num_slots = num_slots;
  for (int c = 0; c < num_cols; ++c) {
    if (col_type[c] < kI32 || col_type[c] > kU8) return -4;
    p.col[c] = cols[c];
    p.col_type[c] = col_type[c];
  }
  for (int k = 0; k < num_slots; ++k) {
    const int take = slot_take[k];
    if (take < kWhole || take > kOne) return -5;
    bool is_float = false;
    if (take != kOne) {
      if (slot_col[k] < 0 || slot_col[k] >= num_cols) return -6;
      is_float = col_type[slot_col[k]] == kF64;
      if (is_float && take != kWhole) return -7;  // no limbs of a double
    }
    p.slot_col[k] = take == kOne ? 0 : slot_col[k];
    p.slot_take[k] = take;
    p.valid[k] = static_cast<const uint8_t*>(slot_valid[k]);
    switch (slot_reduce[k]) {
      case 0: p.slot_red[k] = is_float ? kAddF : kAddI; break;
      case 1: p.slot_red[k] = is_float ? kMinF : kMinI; break;
      case 2: p.slot_red[k] = is_float ? kMaxF : kMaxI; break;
      default: return -8;
    }
  }
  if (shared < 0) return -18;
  IntParams q = {};
  if (path == kPathInt) {
    const int e = int_params(num_cols, cols, col_type, num_slots, slot_col,
                             slot_take, slot_reduce, slot_valid, &q);
    if (e != 0) return e;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int e = word_w == 4
                    ? run<int32_t>(path, word, n, G, p, q, threads,
                                   static_cast<size_t>(shared), blocks,
                                   partials, s)
                    : run<int64_t>(path, word, n, G, p, q, threads,
                                   static_cast<size_t>(shared), blocks,
                                   partials, s);
  if (e != 0) return e;
  return finish(partials, blocks, G, p, counts, first_row, table, s);
}

// The layout constants a launch plan must agree with: dynamic shared bytes a
// block may use, the general path's budget and most threads, the int path's
// distinct columns, stages and compile-time plain slots, the histogram's
// most threads.
extern "C" void p1_dense_geometry(int* out) {
  out[0] = kBlockShared;
  out[1] = kSharedBudget;
  out[2] = kMaxWarps * 32;
  out[3] = kIntCols;
  out[4] = kStages;
  out[5] = kMaxPlain;
  out[6] = kHistMaxThreads;
}
