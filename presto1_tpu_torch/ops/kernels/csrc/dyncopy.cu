// Dynamic copy: the live prefix of each of k parts, to offsets that are the
// running sum of their lengths, for Hopper.
//
// Replaces the dynamic-copy probes of the JAX package
// (experiments/pallas_primitives.py `t3`: a copy of a dynamic size, `t4`: to
// a dynamic offset, `t5`: device memory to device memory at dynamic offsets
// on both sides, `t6`: a loop of small copies at dynamic offsets;
// experiments/pallas_primitives2.py `t4a`: 2-D rows to a dynamic row offset,
// `t4b/c`: 1-D at aligned and unaligned offsets, `t5b`: 2-D with a dynamic
// row count, `t6x` / `t6p`: many copies, serial and pipelined over 8
// semaphores).  What they compute together is what the engine needs for
// UNION ALL and FULL OUTER JOIN (`concat_batches`, `Executor._x_Union`):
//
//   off[p]    = sum over q < p of min(max(counts[q], 0), cap[q])
//   out[r]    = part p's row r - off[p]     where off[p] <= r < off[p + 1]
//   out[r]    = 0                           where r >= off[k]
//
// with the counts on the device: no part length ever reaches the host.
//
// A launch takes a table of up to 32 (source, capacity) pairs of one output
// row width in bytes: `cols` output columns times `k` parts, entry c * k + p.
// A source row may be narrower than the output row (nested [n, W] columns of
// different widths): its tail is written as zeros.  A null source stands for
// rows whose every byte is `fill` (a validity mask that a part does not
// carry, i.e. all rows valid).  Columns and their validity masks are separate
// entries; the engine makes one launch per row width.
//
// Body: each block loads the k counts, clamps them and forms the exclusive
// prefix in shared memory, then walks its output words under a grid-stride
// loop: find the part of the word's row (a scan over at most 32 offsets in
// shared memory), copy the word of every column.  Words are 1, 2, 4, 8 or 16
// bytes, the widest that divides every row width and every address of the
// launch.
//
// Bound: memory.  The live bytes are read once and `capacity` rows are
// written once, both coalesced; nothing is staged (cp.async / TMA staging is
// left for a later change).
//
// Plain C interface for ctypes; launches on the caller's stream, does not
// synchronise, allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPairs = 32;

struct Table {
  const void* src[kMaxPairs];    // entry c * k + p; nullptr: rows of `fill`
  int64_t src_words[kMaxPairs];  // words in a row of that source
  void* dst[kMaxPairs];          // one per column
  int64_t cap[kMaxPairs];        // rows of part p
  int k;
  int cols;
};

template <typename T, bool kFlat>
__global__ void __launch_bounds__(kThreads)
dyncopy_kernel(const Table tab, const int64_t* __restrict__ counts,
               int64_t capacity, int64_t words, const T fill) {
  __shared__ int64_t off[kMaxPairs + 1];
  if (threadIdx.x == 0) {
    int64_t run = 0;
    for (int p = 0; p < tab.k; ++p) {
      off[p] = run;
      int64_t c = counts[p];
      c = c < 0 ? 0 : (c > tab.cap[p] ? tab.cap[p] : c);
      run += c;
    }
    off[tab.k] = run;
  }
  __syncthreads();
  const int64_t live_rows = off[tab.k];
  const int64_t total = capacity * words;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       e < total; e += stride) {
    int64_t r = e, j = 0;
    if (!kFlat) {
      r = e / words;
      j = e - r * words;
    }
    if (r >= live_rows) {
      for (int c = 0; c < tab.cols; ++c) static_cast<T*>(tab.dst[c])[e] = T{};
      continue;
    }
    int p = 0;
    while (p + 1 < tab.k && off[p + 1] <= r) ++p;
    const int64_t local = r - off[p];
    for (int c = 0; c < tab.cols; ++c) {
      const int i = c * tab.k + p;
      const T* s = static_cast<const T*>(tab.src[i]);
      const int64_t sw = tab.src_words[i];
      T v{};
      if (s == nullptr)
        v = fill;
      else if (kFlat || j < sw)
        v = s[local * sw + j];
      static_cast<T*>(tab.dst[c])[e] = v;
    }
  }
}

template <typename T>
int launch(const Table& tab, const int64_t* counts, int64_t capacity,
           int64_t words, const T fill, int blocks, cudaStream_t stream) {
  bool flat = words == 1;
  for (int i = 0; i < tab.k * tab.cols; ++i)
    flat = flat && (tab.src[i] == nullptr || tab.src_words[i] == 1);
  if (flat)
    dyncopy_kernel<T, true><<<blocks, kThreads, 0, stream>>>(
        tab, counts, capacity, words, fill);
  else
    dyncopy_kernel<T, false><<<blocks, kThreads, 0, stream>>>(
        tab, counts, capacity, words, fill);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int p1_dyncopy_threads() { return kThreads; }
extern "C" int p1_dyncopy_max_pairs() { return kMaxPairs; }

// srcs / src_words: k * cols entries (host arrays), entry c * k + p, each a
// device pointer (or null for rows of `fill`) and its row length in words of
// word_bytes (1, 2, 4, 8 or 16).  caps: k part capacities in rows.  dsts:
// cols device pointers of capacity * words words each.  counts: a device
// int64[k].  Returns cudaGetLastError() after the launch, or a negative
// code for an argument the kernel does not take.
extern "C" int p1_dyncopy(const void* const* srcs, const int64_t* src_words,
                          const int64_t* caps, int k, int cols,
                          void* const* dsts, const void* counts,
                          int64_t capacity, int64_t words, int word_bytes,
                          int fill, int blocks, void* stream) {
  if (k < 1 || cols < 1 || k * cols > kMaxPairs) return -2;
  if (capacity < 1 || words < 1 || blocks < 1) return -3;
  Table tab = {};
  tab.k = k;
  tab.cols = cols;
  for (int i = 0; i < k * cols; ++i) {
    if (src_words[i] < 0 || src_words[i] > words) return -4;
    tab.src[i] = srcs[i];
    tab.src_words[i] = src_words[i];
  }
  for (int p = 0; p < k; ++p) tab.cap[p] = caps[p] < 0 ? 0 : caps[p];
  for (int c = 0; c < cols; ++c) tab.dst[c] = dsts[c];
  const int64_t* cnt = static_cast<const int64_t*>(counts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t b = static_cast<uint32_t>(fill) & 0xffu;
  const uint32_t b4 = b * 0x01010101u;
  switch (word_bytes) {
    case 1:
      return launch<uint8_t>(tab, cnt, capacity, words,
                             static_cast<uint8_t>(b), blocks, s);
    case 2:
      return launch<uint16_t>(tab, cnt, capacity, words,
                              static_cast<uint16_t>(b * 0x0101u), blocks, s);
    case 4:
      return launch<uint32_t>(tab, cnt, capacity, words, b4, blocks, s);
    case 8:
      return launch<uint64_t>(
          tab, cnt, capacity, words,
          (static_cast<uint64_t>(b4) << 32) | static_cast<uint64_t>(b4),
          blocks, s);
    case 16:
      return launch<uint4>(tab, cnt, capacity, words,
                           make_uint4(b4, b4, b4, b4), blocks, s);
    default:
      return -1;
  }
}
