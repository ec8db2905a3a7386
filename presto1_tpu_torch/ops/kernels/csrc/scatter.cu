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
// * compaction, two launches over one partition of the mask into block
//   chunks of whole tiles (kThreads x 16 rows).  Pass 1 counts each chunk.
//   Pass 2: every block sums the chunk counts before its own (its offset)
//   and all of them (the count; at most a thousand), then walks its
//   tiles: a block scan of the lanes' popcounts (one barrier a tile) ranks
//   every kept row, and each lane writes its kept rows' numbers to their
//   ranks.  The same blocks write the zeros of
//   [count, capacity) and block 0 the count.  Nothing is sorted, no rank
//   array is stored, nothing reaches the host.  Two passes rather than one
//   with a decoupled look-back: no block waits on another, and pass 2 reads
//   the mask from L2 (6 MB at TPC-H SF1, under the 50 MB L2).
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

struct Cols {
  const void* x[kMaxCols];
  void* out[kMaxCols];
  int width[kMaxCols];      // 4 or 8
  int num;
};

// Bit j set when mask byte 16 * w + j (counted from the aligned base) is
// not 0 and lies in [head, head + n).  `mask` null: every byte in range.
__device__ __forceinline__ unsigned kept_bits(const uint4* __restrict__ mask,
                                              int64_t w, int64_t head,
                                              int64_t end) {
  const int64_t v0 = w * kLaneRows;
  unsigned range = 0xFFFFu;
  if (v0 < head) range &= (0xFFFFu << (head - v0)) & 0xFFFFu;
  if (v0 + kLaneRows > end)
    range &= end > v0 ? 0xFFFFu >> (v0 + kLaneRows - end) : 0u;
  if (mask == nullptr || range == 0) return range;
  const uint4 m = __ldg(mask + w);
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
  return bits & range;
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
