// Scatter to distinct targets, and stable compaction of a mask, for Hopper.
//
// Replaces the scatter probes of the JAX package
// (experiments/pallas_primitives.py `t2`: `zeros.at[idx].set(x)` in fast
// memory, and `t8`: a per-row scalar store loop), and is the device form of
// presto1_tpu/ops/segments.py `compact_indices` (stable indices of the true
// rows of a mask, padded with 0, and their count).
//
// p1_scatter, for every i < n with mask[i] (every i when there is no mask),
// for each of up to kMaxCols value columns c sharing idx and mask:
//     t = idx[i];  if 0 <= t < m:  out_c[t] = x_c[i]
// over outputs zeroed first (one memset of the outputs' one buffer).
// Targets are distinct by contract, so no two threads write one address and
// the result does not depend on the order; out-of-range targets are dropped.
//
// p1_compact: out[r] = the r-th true row of the mask for r < min(count,
// capacity), out[r] = 0 for count <= r < capacity, *count_out = count.
//
// Bound: memory.  The scatter needs the mask once, idx and x only at kept
// rows (the 32-byte sectors holding them), and the outputs once; the
// compaction needs the mask once and capacity words written.  The design:
//
// * the mask is read 16 bytes a lane (one uint4), from a 16-byte-aligned
//   base below the view's start: a view that starts off a 16-byte boundary
//   only shifts row numbers by the `head` bytes below it, which, like bytes
//   past the end, are cleared after the load.  A lane's 16 bytes become a
//   16-bit set of kept rows (`__vcmpne4`);
// * scatter: a ballot skips a warp's 512 rows when none is kept.  Otherwise
//   the warp ranks its kept rows by a shuffle scan of the lanes' popcounts
//   and lists them in shared memory, so lanes take kept rows, not rows: a
//   4 % mask keeps 20 of 512 rows, and 20 lanes work instead of one lane in
//   25.  Each lane then issues the idx loads of kKeep kept rows, and for each
//   column the kKeep value loads before their stores;
// * compaction: presto1_tpu/ops/segments.py `compact_indices` (a sort on
//   the TPU, jnp.nonzero elsewhere; the Pallas masked compaction that
//   presto1_tpu/ops/filter.py:13 foresees was never written), here ONE
//   launch a call (p1_compact_one; below).  What bounds a sparse one on
//   this card is not the 6 MB read of a 6M-row mask but latency: the
//   launch floor (a one-element fill in a graph: 0.0014-0.0017 ms) and the
//   global order every rank depends on.  The earlier body (p1_compact)
//   paid that order with two dependent launches: a count pass
//   (0.0033-0.0037 ms against its 0.0018 ms bound), a 0.0021 ms gap, and a
//   write pass that read the mask again and ranked it by a block scan with
//   one barrier a tile (0.0064 ms), 0.0105-0.0118 ms a call at the view's
//   boundaries and the 3.6 % mask, 17-21 % of the bound (chip_smoke.py,
//   NVIDIA H100 80GB HBM3, 700 W, before the one-launch body); its lanes
//   also stored their kept rows one scattered word at a time, so a dense
//   mask took 0.07-0.17 ms.  The one-launch body (compact_lookback) keeps a
//   lane's mask words in registers from the load to the writes (the mask
//   is read once), ranks by warp scans and one barrier a tile, stages a
//   warp step's kept rows in shared memory and stores them coalesced, and
//   resolves the global order inside the launch by a decoupled look-back
//   over tile flags.  It keeps its state between launches in a buffer the
//   wrapper zeroes outside any CUDA graph capture, and leaves it zero, so
//   that a graph may replay it.  The two-pass body stays only as the
//   yardstick chip_smoke.py times the look-back against.
//
// Plain C interface for ctypes; launches on the caller's stream, does not
// synchronise, allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLaneRows = 16;                 // mask bytes a lane loads
constexpr int kWarpRows = 32 * kLaneRows;     // rows a warp step covers
constexpr int kTileRows = kThreads * kLaneRows;
constexpr int kMaxCols = 8;
constexpr int kKeep = 4;                      // kept rows a lane has in flight
constexpr unsigned kFull = 0xFFFFFFFFu;
// a warp's stage of the one-launch compaction: a step's 512 rows, padded
constexpr int kStage = 32 * kLaneRows + 32 * kLaneRows / 16;
// windows of 32 earlier tiles whose flags a look-back round of the
// one-launch compaction reads at once
constexpr int kLookWindows = 4;
// 16-byte mask words a lane of the one-launch compaction holds (4 measured
// fastest, or within 2 % of 8 and 16, at the 6,002,010-row shapes of
// chip_smoke.py compact_times; PERF_APPENDIX.md)
constexpr int kSpanWords = 4;
// the one-launch compaction's state, int64 words ahead of the tile flags:
// [0] the tile counter, [1] the blocks that have left, [2] the count (a
// flag)
constexpr int kStateWords = 3;

struct Cols {
  const void* x[kMaxCols];
  void* out[kMaxCols];
  int width[kMaxCols];      // 4 or 8
  int num;
};

// Bit j set when byte 16 * w + j (counted from the aligned base) lies in
// [head, end).
__device__ __forceinline__ unsigned range_bits(int64_t w, int64_t head,
                                               int64_t end) {
  const int64_t v0 = w * kLaneRows;
  unsigned range = 0xFFFFu;
  if (v0 < head) range &= (0xFFFFu << (head - v0)) & 0xFFFFu;
  if (v0 + kLaneRows > end)
    range &= end > v0 ? 0xFFFFu >> (v0 + kLaneRows - end) : 0u;
  return range;
}

// Bit j set when byte j of the loaded 16-byte word `m` is not 0.
__device__ __forceinline__ unsigned nonzero_bits(const uint4 m) {
  const unsigned words[4] = {m.x, m.y, m.z, m.w};
  unsigned bits = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    // 0xFF in every byte that is not 0; then one bit per byte
    const unsigned ne = __vcmpne4(words[q], 0u);
    const unsigned b = (ne & 1u) | ((ne >> 7) & 2u) | ((ne >> 14) & 4u) |
                       ((ne >> 21) & 8u);
    bits |= b << (4 * q);
  }
  return bits;
}

// Bit j set when mask byte 16 * w + j (counted from the aligned base) is
// not 0 and lies in [head, head + n).  `mask` null: every byte in range.
__device__ __forceinline__ unsigned kept_bits(const uint4* __restrict__ mask,
                                              int64_t w, int64_t head,
                                              int64_t end) {
  const unsigned range = range_bits(w, head, end);
  if (mask == nullptr || range == 0) return range;
  return nonzero_bits(__ldg(mask + w)) & range;
}

__device__ __forceinline__ uint64_t load_word(const void* p, int width,
                                              int64_t i) {
  return width == 8 ? __ldg(static_cast<const unsigned long long*>(p) + i)
                    : __ldg(static_cast<const unsigned*>(p) + i);
}

template <typename I>
__global__ void __launch_bounds__(kThreads)
scatter_kernel(const I* __restrict__ idx, const uint4* __restrict__ mask,
               int64_t head, int64_t n, int64_t m, const Cols cols) {
  __shared__ uint16_t list_all[kWarps][kWarpRows];
  uint16_t* list = list_all[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  const int64_t end = head + n;  // virtual rows [head, end) are rows
  const int64_t steps = (end + kWarpRows - 1) / kWarpRows;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  int64_t s = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  // the warp's next step's mask is in flight while this step scatters
  unsigned next = s < steps ? kept_bits(mask, s * 32 + lane, head, end) : 0u;
  for (; s < steps; s += warps) {
    const unsigned bits = next;
    next = s + warps < steps
               ? kept_bits(mask, (s + warps) * 32 + lane, head, end)
               : 0u;
    if (__ballot_sync(kFull, bits != 0) == 0) continue;
    // exclusive rank of the lane's first kept row within the warp step
    const int c = __popc(bits);
    int pre = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, pre, d);
      if (lane >= d) pre += y;
    }
    const int total = __shfl_sync(kFull, pre, 31);
    pre -= c;
    for (unsigned b = bits; b != 0; b &= b - 1)
      list[pre++] = static_cast<uint16_t>(lane * kLaneRows + __ffs(b) - 1);
    __syncwarp();
    const int64_t row0 = s * kWarpRows - head;
    for (int e0 = 0; e0 < total; e0 += 32 * kKeep) {
      int64_t row[kKeep];
      int64_t t[kKeep];
#pragma unroll
      for (int u = 0; u < kKeep; ++u) {
        const int e = e0 + u * 32 + lane;
        row[u] = e < total ? row0 + list[e] : -1;
        t[u] = row[u] >= 0 ? static_cast<int64_t>(__ldg(idx + row[u])) : -1;
      }
      // one column at a time: its kKeep loads, then its kKeep stores (a
      // store does not hold up the next column's loads)
#pragma unroll 1
      for (int c2 = 0; c2 < cols.num; ++c2) {
        const void* x = cols.x[c2];
        const int width = cols.width[c2];
        uint64_t v[kKeep];
#pragma unroll
        for (int u = 0; u < kKeep; ++u)
          v[u] = row[u] >= 0 ? load_word(x, width, row[u]) : 0;
#pragma unroll
        for (int u = 0; u < kKeep; ++u) {
          if (t[u] < 0 || t[u] >= m) continue;
          if (width == 8)
            static_cast<uint64_t*>(cols.out[c2])[t[u]] = v[u];
          else
            static_cast<uint32_t*>(cols.out[c2])[t[u]] =
                static_cast<uint32_t>(v[u]);
        }
      }
    }
    __syncwarp();  // the list is rewritten by the next step
  }
}

// ---------------------------------------------------------------- compaction

// block-wide sum of one value a thread (every thread gets it)
__device__ __forceinline__ int64_t block_sum(int64_t v, int64_t* red) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(kFull, v, d);
  __syncthreads();  // red may still be read by a previous call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int64_t s = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[w];
  return s;
}

// pass 1: counts[b] = true rows in block b's chunk of words
__global__ void __launch_bounds__(kThreads)
compact_count(const uint4* __restrict__ mask, int64_t head, int64_t n,
              int64_t chunk_words, int64_t* __restrict__ counts) {
  __shared__ int64_t red[kWarps];
  const int64_t end = head + n;
  const int64_t words = (end + kLaneRows - 1) / kLaneRows;
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * chunk_words;
  int64_t w1 = w0 + chunk_words;
  if (w1 > words) w1 = words;
  int64_t c = 0;
  for (int64_t w = w0 + threadIdx.x; w < w1; w += 4 * kThreads) {
    unsigned bits[4];  // four loads in flight
#pragma unroll
    for (int u = 0; u < 4; ++u)
      bits[u] = w + u * kThreads < w1
                    ? kept_bits(mask, w + u * kThreads, head, end)
                    : 0u;
#pragma unroll
    for (int u = 0; u < 4; ++u) c += __popc(bits[u]);
  }
  c = block_sum(c, red);
  if (threadIdx.x == 0) counts[blockIdx.x] = c;
}

// pass 2: ranks and writes; see the file's head
__global__ void __launch_bounds__(kThreads)
compact_write(const uint4* __restrict__ mask, int64_t head, int64_t n,
              int64_t chunk_words, const int64_t* __restrict__ counts,
              int64_t* __restrict__ out, int64_t capacity,
              int64_t* __restrict__ count_out) {
  __shared__ int64_t red[2 * kWarps];
  __shared__ int warp_pre[2][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x;
  const int64_t end = head + n;
  const int64_t words = (end + kLaneRows - 1) / kLaneRows;
  const int64_t w0 = static_cast<int64_t>(b) * chunk_words;
  int64_t w1 = w0 + chunk_words;
  if (w1 > words) w1 = words;
  // the first tile's mask is in flight while the offsets are summed
  unsigned next = w0 + threadIdx.x < w1
                      ? kept_bits(mask, w0 + threadIdx.x, head, end)
                      : 0u;
  int64_t before = 0, all = 0;
  for (int j0 = threadIdx.x; j0 < static_cast<int>(gridDim.x);
       j0 += 4 * kThreads) {
    int64_t c[4];  // four loads in flight
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + u * kThreads;
      c[u] = j < static_cast<int>(gridDim.x) ? counts[j] : 0;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      all += c[u];
      if (j0 + u * kThreads < b) before += c[u];
    }
  }
  // both sums in one block reduction
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    before += __shfl_down_sync(kFull, before, d);
    all += __shfl_down_sync(kFull, all, d);
  }
  if (lane == 0) {
    red[warp] = before;
    red[kWarps + warp] = all;
  }
  __syncthreads();
  before = all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    before += red[w];
    all += red[kWarps + w];
  }

  int64_t offset = before;  // rank of the tile's first true row
  int buf = 0;
  for (int64_t t0 = w0; t0 < w1 && offset < capacity; t0 += kThreads) {
    const unsigned bits = next;
    const int64_t w = t0 + kThreads + threadIdx.x;  // the next tile's
    next = w < w1 ? kept_bits(mask, w, head, end) : 0u;
    const int c = __popc(bits);
    int pre = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, pre, d);
      if (lane >= d) pre += y;
    }
    // warp totals, in one of two buffers so that one barrier a tile does
    if (lane == 31) warp_pre[buf][warp] = pre;
    __syncthreads();
    int tile = 0, below = 0;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) {
      const int t = warp_pre[buf][q];
      if (q < warp) below += t;
      tile += t;
    }
    // each kept row straight to its rank
    int64_t r = offset + below + pre - c;
    const int64_t row0 = (t0 + threadIdx.x) * kLaneRows - head;
    for (unsigned bb = bits; bb != 0 && r < capacity; bb &= bb - 1, ++r)
      out[r] = row0 + __ffs(bb) - 1;
    offset += tile;
    buf ^= 1;
  }
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t r = all + static_cast<int64_t>(b) * kThreads + threadIdx.x;
       r < capacity; r += stride)
    out[r] = 0;
  if (b == 0 && threadIdx.x == 0) *count_out = all;
}


// ------------------------------------------------- one-launch compaction
//
// A tile is kThreads * kSpanWords 16-byte words of the mask.  Warp w of a
// tile holds its words [w, w + 1) * 32 kSpanWords, lane l of it the words
// 32 k + l of those (k < kSpanWords), so that each load instruction of a
// warp reads 512 consecutive bytes, and the rows keep their order as
// (warp, k, lane).  A lane's words stay in registers from
// the load to the writes: the mask is read once.

// the lane's words of a warp span starting at word w0, none at or past
// `limit` (zeros there): every load issued before any is used
__device__ __forceinline__ void load_span(const uint4* __restrict__ mask,
                                          int64_t w0, int64_t limit,
                                          int64_t head, int64_t end,
                                          unsigned (&bits)[kSpanWords]) {
  const int lane = threadIdx.x & 31;
  uint4 m[kSpanWords];
#pragma unroll
  for (int k = 0; k < kSpanWords; ++k) {
    const int64_t w = w0 + 32 * k + lane;
    m[k] = w < limit ? __ldg(mask + w) : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int k = 0; k < kSpanWords; ++k)
    bits[k] = nonzero_bits(m[k]) & range_bits(w0 + 32 * k + lane, head, end);
}

// The exclusive rank of each of the lane's words within its tile (`pre`),
// and the tile's count.  `warp_total` is shared memory of kWarps ints that
// no thread reads until the next barrier after this call's.
__device__ __forceinline__ int tile_ranks(const unsigned (&bits)[kSpanWords],
                                          int (&pre)[kSpanWords],
                                          int* warp_total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x[kSpanWords];
#pragma unroll
  for (int k = 0; k < kSpanWords; ++k) x[k] = __popc(bits[k]);
  // the kSpanWords warp scans side by side, so that their shuffles overlap
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
    for (int k = 0; k < kSpanWords; ++k) {
      const int y = __shfl_up_sync(kFull, x[k], d);
      if (lane >= d) x[k] += y;
    }
  }
  int run = 0;
#pragma unroll
  for (int k = 0; k < kSpanWords; ++k) {
    pre[k] = run + x[k] - __popc(bits[k]);
    run += __shfl_sync(kFull, x[k], 31);
  }
  if (lane == 0) warp_total[warp] = run;
  __syncthreads();
  int below = 0, total = 0;
#pragma unroll
  for (int q = 0; q < kWarps; ++q) {
    const int t = warp_total[q];
    if (q < warp) below += t;
    total += t;
  }
#pragma unroll
  for (int k = 0; k < kSpanWords; ++k) pre[k] += below;
  return total;
}

// The kept rows of the lane's words to their ranks, below capacity.  The
// warp's rows of its k-th words have consecutive ranks: each lane lists its
// rows in the warp's stage in shared memory, and the warp then stores the
// list coalesced (32 consecutive ranks an instruction), so that a dense
// mask's 512 rows a step are 16 full-line stores, not 16 stores of 32
// scattered words.
__device__ __forceinline__ void write_span(const unsigned (&bits)[kSpanWords],
                                           const int (&pre)[kSpanWords],
                                           int64_t offset, int64_t w0,
                                           int64_t head,
                                           int64_t* __restrict__ out,
                                           int64_t capacity,
                                           int64_t* stage) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < kSpanWords; ++k) {
    const int c = __popc(bits[k]);
    const int first = __shfl_sync(kFull, pre[k], 0);
    const int count = __shfl_sync(kFull, pre[k] + c, 31) - first;
    const int64_t base = offset + first;
    if (count == 0 || base >= capacity) continue;  // warp-uniform
    const int64_t row0 = (w0 + 32 * k + lane) * kLaneRows - head;
    // entry i at i + i / 16: a dense mask's lanes start 16 entries apart,
    // and would otherwise all meet in one bank
    int at = pre[k] - first;
    for (unsigned b = bits[k]; b != 0; b &= b - 1, ++at)
      stage[at + (at >> 4)] = row0 + __ffs(b) - 1;
    __syncwarp();
    const int live = base + count <= capacity
                         ? count
                         : static_cast<int>(capacity - base);
    for (int i = lane; i < live; i += 32) __stcs(
        reinterpret_cast<long long*>(out + base + i),
        static_cast<long long>(stage[i + (i >> 4)]));
    __syncwarp();
  }
}

// zeros of [total, capacity), grid-stride over every thread of the launch
__device__ __forceinline__ void zero_tail(int64_t total, int64_t capacity,
                                          int64_t* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t r = total + static_cast<int64_t>(blockIdx.x) * kThreads +
                   threadIdx.x;
       r < capacity; r += stride)
    out[r] = 0;
}

// Tile flags of the look-back: the status in the top two bits, the value
// (a count) below.
constexpr uint64_t kAggregate = 1ull << 62;
constexpr uint64_t kInclusive = 2ull << 62;
constexpr uint64_t kValue = (1ull << 62) - 1;

__device__ __forceinline__ uint64_t load_flag(const uint64_t* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void store_flag(uint64_t* p, uint64_t v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

// One pass with a decoupled look-back (Merrill and Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back").  A block
// takes tiles in order from the ticket counter state[0] until none is
// left.  For a tile it loads its words, ranks them within the tile, and
// publishes the tile's count (tile 0: its inclusive prefix) in its flag;
// warp 0 then reads the flags of the kLookWindows * 32 tiles before it at
// once, waiting until each holds something, sums counts back to the
// nearest inclusive prefix (as many tiles further back again until one
// holds it), and publishes the tile's inclusive prefix.  The tile's kept
// rows go to their ranks (`write_span`).  The last tile's prefix is the
// count: written to count_out and to state[2].  A block that finds no
// tile left knows every tile is held by a block that is running, so it
// waits for state[2] and zeroes its share of
// [count, capacity); every wait is on a tile taken earlier, never on a
// block that may not be resident.  The last block to leave (state[1])
// resets the ticket, the count and the flags it used, so that the next
// launch -- a CUDA graph's replay included -- finds them zero: the state
// lives in a buffer the wrapper zeroes before the first launch that uses
// it, outside any graph capture.
__global__ void __launch_bounds__(kThreads)
compact_lookback(const uint4* __restrict__ mask, int64_t head, int64_t n,
                 int64_t tiles, int64_t* __restrict__ out, int64_t capacity,
                 int64_t* __restrict__ count_out, uint64_t* state) {
  __shared__ int warp_total[kWarps];
  __shared__ int64_t shared_ticket, shared_prefix;
  __shared__ int shared_last;
  __shared__ int64_t stage[kWarps][kStage];
  uint64_t* flags = state + kStateWords;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t end = head + n;
  const int64_t words = (end + kLaneRows - 1) / kLaneRows;
  for (;;) {
    if (threadIdx.x == 0)
      shared_ticket = static_cast<int64_t>(
          atomicAdd(reinterpret_cast<unsigned long long*>(state), 1ull));
    __syncthreads();
    const int64_t t = shared_ticket;
    if (t >= tiles) break;
    const int64_t w0 = t * kThreads * kSpanWords + warp * 32 * kSpanWords;
    unsigned bits[kSpanWords];
    int pre[kSpanWords];
    load_span(mask, w0, words, head, end, bits);
    const int count = tile_ranks(bits, pre, warp_total);
    if (warp == 0) {
      int64_t prefix = 0;
      if (t == 0) {
        if (lane == 0) store_flag(flags, kInclusive | count);
      } else {
        if (lane == 0) store_flag(flags + t, kAggregate | count);
        // rounds of kLookWindows windows of 32 earlier tiles, their flags
        // read at once: a round waits for the tiles' counts (published as
        // soon as each tile is loaded), not for a chain of prefixes
        for (int64_t k = t - 1;; k -= 32 * kLookWindows) {
          uint64_t f[kLookWindows];
          bool pending;
          do {
            pending = false;
#pragma unroll
            for (int w = 0; w < kLookWindows; ++w) {
              const int64_t j = k - 32 * w - lane;  // nearest first
              f[w] = j >= 0 ? load_flag(flags + j) : kInclusive;
              pending |= (f[w] >> 62) == 0;
            }
          } while (__any_sync(kFull, pending));
          // counts back to the nearest inclusive prefix
          int64_t v = 0;
          bool found = false;
#pragma unroll
          for (int w = 0; w < kLookWindows; ++w) {
            if (found) break;  // warp-uniform
            const unsigned inclusive =
                __ballot_sync(kFull, (f[w] >> 62) == 2);
            const int stop = inclusive ? __ffs(inclusive) - 1 : 31;
            if (lane <= stop) v += static_cast<int64_t>(f[w] & kValue);
            found = inclusive != 0;
          }
#pragma unroll
          for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
          prefix += v;
          if (found) break;
        }
        if (lane == 0)
          store_flag(flags + t,
                     kInclusive | static_cast<uint64_t>(prefix + count));
      }
      if (lane == 0) shared_prefix = prefix;
    }
    __syncthreads();
    const int64_t prefix = shared_prefix;
    if (t == tiles - 1 && threadIdx.x == 0) {
      *count_out = prefix + count;
      store_flag(state + 2, kInclusive | static_cast<uint64_t>(prefix + count));
    }
    if (prefix < capacity)
      write_span(bits, pre, prefix, w0, head, out, capacity, stage[warp]);
    __syncthreads();  // shared_ticket and warp_total are written again
  }
  // every tile is taken, the last one by a block that is running: wait for
  // the count it publishes and zero a share of the tail
  if (threadIdx.x == 0) {
    uint64_t f;
    while (((f = load_flag(state + 2)) >> 62) == 0) __nanosleep(64);
    shared_prefix = static_cast<int64_t>(f & kValue);
  }
  __syncthreads();
  zero_tail(shared_prefix, capacity, out);
  if (threadIdx.x == 0) {
    __threadfence();
    shared_last = atomicAdd(reinterpret_cast<unsigned long long*>(state + 1),
                            1ull) == gridDim.x - 1;
  }
  __syncthreads();
  if (shared_last) {  // every other block has left: reset for the next launch
    for (int64_t j = threadIdx.x; j < tiles; j += kThreads) flags[j] = 0;
    if (threadIdx.x == 0) {
      state[0] = 0;
      state[1] = 0;
      state[2] = 0;
    }
  }
}

}  // namespace

extern "C" int p1_scatter_threads() { return kThreads; }
extern "C" int p1_scatter_max_columns() { return kMaxCols; }

// idx: int32 (idx_w 4) or int64 (idx_w 8) [n].  mask: the 16-byte-aligned
// base of a one-byte-per-row mask whose row 0 is byte `head` (0..15), or
// null.  xs / widths / outs: num_cols columns: [n] words of widths[c] bytes
// (4 or 8); outputs of m words.
// The outputs lie in one buffer of `out_bytes` bytes at `out_base`, zeroed
// here before the scatter.  Returns cudaGetLastError() after the launch, or
// a negative code for an argument it does not take.
extern "C" int p1_scatter(const void* idx, int idx_w, const void* mask,
                          int64_t head, int64_t n, int64_t m, int num_cols,
                          const void* const* xs, const int* widths,
                          void* const* outs, void* out_base,
                          int64_t out_bytes, int blocks, void* stream) {
  if (num_cols < 1 || num_cols > kMaxCols) return -1;
  if (head < 0 || head >= kLaneRows || (mask == nullptr && head != 0))
    return -2;
  if (blocks < 1) return -3;
  Cols cols = {};
  cols.num = num_cols;
  for (int c = 0; c < num_cols; ++c) {
    if (widths[c] != 4 && widths[c] != 8) return -4;
    if (xs[c] == nullptr) return -4;
    cols.x[c] = xs[c];
    cols.out[c] = outs[c];
    cols.width[c] = widths[c];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(out_base, 0, out_bytes, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const uint4* mk = static_cast<const uint4*>(mask);
  if (idx_w == 4)
    scatter_kernel<int32_t><<<blocks, kThreads, 0, s>>>(
        static_cast<const int32_t*>(idx), mk, head, n, m, cols);
  else if (idx_w == 8)
    scatter_kernel<int64_t><<<blocks, kThreads, 0, s>>>(
        static_cast<const int64_t*>(idx), mk, head, n, m, cols);
  else
    return -5;
  return static_cast<int>(cudaGetLastError());
}

extern "C" int p1_compact_tile_rows() { return kTileRows; }

// mask: the 16-byte-aligned base of a one-byte-per-row mask of n rows
// starting at byte `head` (0..15).  blocks chunks of chunk_words 16-byte
// words (a multiple of kThreads) cover the mask.  counts: int64 [blocks]
// scratch.  out: int64 [capacity]; count_out: one int64.  Returns
// cudaGetLastError() after the two launches, or a negative code.
extern "C" int p1_compact(const void* mask, int64_t head, int64_t n,
                          int64_t chunk_words, int blocks, void* counts,
                          void* out, int64_t capacity, void* count_out,
                          void* stream) {
  if (mask == nullptr || head < 0 || head >= kLaneRows) return -1;
  if (blocks < 1 || chunk_words < 1 || chunk_words % kThreads != 0) return -2;
  if (static_cast<int64_t>(blocks) * chunk_words * kLaneRows < head + n)
    return -3;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint4* mk = static_cast<const uint4*>(mask);
  compact_count<<<blocks, kThreads, 0, s>>>(mk, head, n, chunk_words,
                                            static_cast<int64_t*>(counts));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  compact_write<<<blocks, kThreads, 0, s>>>(
      mk, head, n, chunk_words, static_cast<const int64_t*>(counts),
      static_cast<int64_t*>(out), capacity, static_cast<int64_t*>(count_out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int p1_compact_state_words() { return kStateWords; }
extern "C" int p1_compact_span_words() { return kSpanWords; }

// Blocks an SM that the occupancy calculator gives the one-launch
// compaction, or a negative code.
extern "C" int p1_compact_blocks_per_sm() {
  int blocks = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, compact_lookback, kThreads, 0);
  return e == cudaSuccess ? blocks : -static_cast<int>(e);
}

// The one-launch compaction.  mask, head, n, out, capacity, count_out as
// for p1_compact; `blocks` blocks take `tiles` tiles of kThreads *
// kSpanWords words; `state`: the int64 words of the caller's state
// (kStateWords, then a flag for each of at least `tiles` tiles), all zero
// before the launch and left zero by it.  Returns cudaGetLastError() after
// the launch, or a negative code.
extern "C" int p1_compact_one(const void* mask, int64_t head, int64_t n,
                              int64_t tiles, int blocks, void* out,
                              int64_t capacity, void* count_out, void* state,
                              void* stream) {
  if (mask == nullptr || state == nullptr || head < 0 || head >= kLaneRows)
    return -1;
  if (blocks < 1 || n < 1) return -2;
  const int64_t words = (head + n + kLaneRows - 1) / kLaneRows;
  if (tiles * kThreads * kSpanWords < words || blocks > tiles) return -3;
  compact_lookback<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(mask), head, n, tiles,
      static_cast<int64_t*>(out), capacity, static_cast<int64_t*>(count_out),
      static_cast<uint64_t*>(state));
  return static_cast<int>(cudaGetLastError());
}
