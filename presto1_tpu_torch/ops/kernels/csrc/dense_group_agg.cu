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
// column), G * (K + 2) * 8 bytes are written per block.  What the design has
// to do is keep the reduction off the memory pipe and make it reproducible:
//
// * a block owns a contiguous run of rows; each warp takes 32 consecutive rows
//   a step: lane i reads row i's word (coalesced, in the stored type, no
//   alignment assumed, so views work).  Then the lanes change roles: lane k
//   owns slot k.  The warp walks its 32 rows, broadcasts each row's group by
//   shuffle, and lane k reads slot k's value of that row and folds it into its
//   own cell of the accumulators in shared memory.  A cell has one owner, so
//   there are no atomics, no conflicts however few groups are live (4 in
//   TPC-H Q1), and every cell sees its rows in row order: float64 sums are
//   the same from run to run.  With K <= 16 slots the warp splits into
//   32 / K' sub-warps (K' the next power of two) that take alternate rows
//   into private copies (about 400 issue slots of a warp per 32 rows of Q1;
//   a shuffle-tree reduction of each group's members per slot costs 2,600);
// * counts and first rows come from one `match_any` over the group ids of a
//   step, whatever the number of distinct groups (32 of 256 bins a step in
//   the histogram); a warp step with no live row costs one ballot;
// * the slots' tables are copied to shared memory once a block: lanes index
//   them by their own slot, which kernel parameters cannot serve in parallel;
// * the sequential grid with a revisited accumulator tile of the TPU kernel
//   becomes: copies of a block combined in a fixed order, one partial a
//   block, and a second small kernel that combines the partials in block
//   order;
// * shared memory holds warps x copies x G x (K + 2) x 8 bytes; the launcher
//   lowers the warps per block when G x K is large (256 bins x many slots).
//
// Integer sums wrap like int64 tensor arithmetic.  Plain C interface for
// ctypes; launches on the caller's stream, does not synchronise, allocates
// nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxCols = 32;
constexpr int kMaxSlots = 64;
constexpr int kMaxWarps = 8;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kSharedBudget = 200 * 1024;

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

template <typename W>
int launch(const void* word, int64_t n, int G, const Params& p, int blocks,
           void* partials, void* counts, void* first_row, void* table,
           cudaStream_t stream) {
  const int K = p.num_slots;
  const int GS = G * (K + 2);
  int sub = 32;  // lanes of a sub-warp: the least power of two >= K
  if (K >= 1 && K <= 16) {
    sub = 1;
    while (sub < K) sub *= 2;
  }
  const int copies = 32 / sub;
  const size_t info_bytes = (static_cast<size_t>(K) * sizeof(SlotInfo) + 7) / 8 * 8;
  const size_t per_warp = static_cast<size_t>(copies) * GS * sizeof(int64_t);
  if (info_bytes + per_warp > static_cast<size_t>(kSharedBudget)) return -9;
  int warps = static_cast<int>((kSharedBudget - info_bytes) / per_warp);
  if (warps > kMaxWarps) warps = kMaxWarps;
  const size_t shared = info_bytes + warps * per_warp;
  if (shared > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dense_group_agg_kernel<W>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int64_t rows_per_block = (n + blocks - 1) / blocks;
  rows_per_block = (rows_per_block + 31) / 32 * 32;
  dense_group_agg_kernel<W><<<blocks, warps * 32, shared, stream>>>(
      static_cast<const W*>(word), n, G, p, rows_per_block, sub,
      static_cast<int64_t*>(partials));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  dense_group_agg_finish<<<(GS + kFinishWarps - 1) / kFinishWarps,
                           kFinishWarps * 32, 0, stream>>>(
      static_cast<const int64_t*>(partials), blocks, G, p,
      static_cast<int64_t*>(counts), static_cast<int64_t*>(first_row),
      static_cast<int64_t*>(table));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// word: int32 (word_w 4) or int64 (word_w 8) [n] on the device.
// cols / col_type: num_cols device pointers and their ColType codes.
// slot_col / slot_take / slot_reduce / slot_valid: num_slots entries;
//   slot_reduce 0 = add, 1 = min, 2 = max (typed by the slot's column);
//   slot_valid[k] is a one-byte-per-row device pointer or null.
// partials: int64 [blocks * G * (num_slots + 2)] scratch, every entry written.
// counts, first_row: int64 [G]; table: 8-byte [G * num_slots] (float64 slots
// hold the bits of a double).
// Returns cudaGetLastError() after the launches, or a negative code for an
// argument the kernel does not take.
extern "C" int p1_dense_group_agg(
    const void* word, int word_w, int64_t n, int G, int num_cols,
    const void* const* cols, const int* col_type, int num_slots,
    const int* slot_col, const int* slot_take, const int* slot_reduce,
    const void* const* slot_valid, int blocks, void* partials, void* counts,
    void* first_row, void* table, void* stream) {
  if (n <= 0 || blocks <= 0) return -1;
  if (G <= 0 || G > 256) return -2;
  if (num_cols < 0 || num_cols > kMaxCols || num_slots < 0 ||
      num_slots > kMaxSlots)
    return -3;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (word_w == 4)
    return launch<int32_t>(word, n, G, p, blocks, partials, counts, first_row,
                           table, s);
  if (word_w == 8)
    return launch<int64_t>(word, n, G, p, blocks, partials, counts, first_row,
                           table, s);
  return -10;
}
