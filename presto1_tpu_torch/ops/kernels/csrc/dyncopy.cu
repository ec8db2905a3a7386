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
// ONE launch moves every column of a call, whatever its element width,
// nesting or validity: one __grid_constant__ parameter struct (`Params`)
// holds a descriptor per column (destination, row bytes, its first tile, its
// first pair) and a (source, source row bytes) pair per column and part.  A
// null source stands for rows whose every byte is `fill` (a validity mask
// that a part does not carry, i.e. all rows valid); a source row narrower
// than the column's (nested [n, W] parts of different widths) is padded
// with zeros.
//
// The kernel moves bytes.  Column c's output is capacity * row_bytes bytes,
// cut into tiles of kTileWords aligned 16-byte words; a block takes a tile,
// and finds the part of the tile's first byte once, in the shared-memory
// prefix of the clamped counts.  A word inside one part whose source rows
// are as wide as the column's is one or two aligned 16-byte loads of the
// source, shifted into place with `__funnelshift_r` where the part's byte
// offset is not a multiple of 16; a word past the live bytes is a store of
// zeros, a word of a `fill` part a store of the fill pattern.  Only words
// that straddle two parts or the end of the live bytes, and parts of
// narrower rows, go byte by byte.  A bool mask thus moves 16 bytes a lane,
// and so does every other width.
//
// Bound: memory.  The live bytes are read once and `capacity` rows of every
// column are written once; a thread keeps kWords words (two loads each where
// shifted) in flight before it stores.
//
// Plain C interface for ctypes; launches on the caller's stream, does not
// synchronise, allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWords = 8;                      // words a thread moves a tile
constexpr int kTileWords = kThreads * kWords;  // 32 KiB of one column
constexpr int kMaxParts = 32;
constexpr int kMaxCols = 48;
constexpr int kMaxPairs = 128;

struct Pair {
  const void* src;    // the part's rows; nullptr: rows of `fill` bytes
  int64_t row_bytes;  // bytes of one of its rows (<= the column's)
};

struct Col {
  void* dst;          // capacity rows of row_bytes, 16-byte aligned
  int64_t row_bytes;
  int64_t tile0;      // tiles of the columns before this one
  int32_t pair0;      // the pair of part 0; part p's is pair0 + p
  int32_t unused;
};

struct Params {
  const int64_t* counts;  // device int64[k]
  int64_t capacity;       // output rows
  int64_t tiles;          // tiles of every column
  int32_t k;              // parts
  int32_t cols;
  int32_t fill;           // the byte a null source's rows hold
  int32_t unused;
  int64_t cap[kMaxParts];  // rows of each part
  Col col[kMaxCols];
  Pair pair[kMaxPairs];
};

enum Kind { kSkip, kZero, kFill, kCopy, kBytes };

// bytes delta .. delta + 15 of the 32 bytes a:b (0 <= delta < 16)
__device__ __forceinline__ uint4 funnel16(uint4 a, uint4 b, int delta) {
  const uint32_t l[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  const int q = delta >> 2;
  const uint32_t s = (delta & 3) * 8;
  uint32_t h[6], m[5];
#pragma unroll
  for (int i = 0; i < 6; ++i) h[i] = (q & 2) ? l[i + 2] : l[i];
#pragma unroll
  for (int i = 0; i < 5; ++i) m[i] = (q & 1) ? h[i + 1] : h[i];
  return make_uint4(__funnelshift_r(m[0], m[1], s),
                    __funnelshift_r(m[1], m[2], s),
                    __funnelshift_r(m[2], m[3], s),
                    __funnelshift_r(m[3], m[4], s));
}

// the 16 bytes of output bytes lo .. lo + 15, one at a time, from part p on
__device__ uint4 bytes_word(const Params& P, const Col& col,
                            const int64_t* off, int p, int64_t lo,
                            int64_t live_bytes) {
  const int64_t rb = col.row_bytes;
  uint32_t lane[4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int64_t b = lo + j;
    if (b >= live_bytes) break;
    while (p + 1 < P.k && off[p + 1] * rb <= b) ++p;
    const Pair& pr = P.pair[col.pair0 + p];
    const int64_t local = b - off[p] * rb;
    const unsigned char* s = static_cast<const unsigned char*>(pr.src);
    uint32_t x = 0;
    if (s == nullptr) {
      x = static_cast<uint32_t>(P.fill) & 0xffu;
    } else if (pr.row_bytes == rb) {
      x = __ldg(s + local);
    } else {
      const int64_t r = local / rb;
      const int64_t cb = local - r * rb;
      if (cb < pr.row_bytes) x = __ldg(s + r * pr.row_bytes + cb);
    }
    lane[j >> 2] |= x << (8 * (j & 3));
  }
  return make_uint4(lane[0], lane[1], lane[2], lane[3]);
}

// the clamped counts' exclusive prefix: off[p] the first output row of part
// p, off[k] the live rows
__device__ __forceinline__ void prefix(const Params& P, int64_t* off) {
  int64_t run = 0;
  for (int p = 0; p < P.k; ++p) {
    off[p] = run;
    int64_t c = P.counts[p];
    c = c < 0 ? 0 : (c > P.cap[p] ? P.cap[p] : c);
    run += c;
  }
  off[P.k] = run;
}

// the column of tile t: the last whose first tile is at or before t
__device__ __forceinline__ int column_of(const Params& P, int64_t t) {
  int c = 0;
  while (c + 1 < P.cols && P.col[c + 1].tile0 <= t) ++c;
  return c;
}

// tile t: every load of the thread's words before any store
__device__ __forceinline__ void copy_tile(const Params& P, const int64_t* off,
                                          int64_t live_rows, uint4 fill,
                                          int64_t t) {
  const int k = P.k;
  const Col& col = P.col[column_of(P, t)];
  const int64_t rb = col.row_bytes;
  const int64_t out_bytes = P.capacity * rb;
  const int64_t live_bytes = live_rows * rb;
  const int64_t w0 = (t - col.tile0) * kTileWords;
  // the part of the tile's first byte, found once for the tile
  int p0 = 0;
  while (p0 + 1 < k && off[p0 + 1] * rb <= w0 * 16) ++p0;
  char* dst = static_cast<char*>(col.dst);
  uint4 a[kWords], b[kWords];
  int kind[kWords], delta[kWords];
  int p = p0;
#pragma unroll
  for (int v = 0; v < kWords; ++v) {
    const int64_t lo = (w0 + v * kThreads + threadIdx.x) * 16;
    kind[v] = kSkip;
    delta[v] = 0;
    if (lo >= out_bytes) continue;
    if (lo >= live_bytes) {
      kind[v] = kZero;
      continue;
    }
    while (p + 1 < k && off[p + 1] * rb <= lo) ++p;
    const int64_t start = off[p] * rb;
    const int64_t end = off[p + 1] * rb < live_bytes ? off[p + 1] * rb
                                                     : live_bytes;
    const Pair& pr = P.pair[col.pair0 + p];
    if (lo + 16 > end || lo + 16 > out_bytes ||
        (pr.src != nullptr && pr.row_bytes != rb)) {
      kind[v] = kBytes;
      continue;
    }
    if (pr.src == nullptr) {
      kind[v] = kFill;
      continue;
    }
    const char* s = static_cast<const char*>(pr.src) + (lo - start);
    const int d = static_cast<int>(reinterpret_cast<uintptr_t>(s) & 15);
    const uint4* q = reinterpret_cast<const uint4*>(s - d);
    a[v] = __ldg(q);
    if (d) b[v] = __ldg(q + 1);
    kind[v] = kCopy;
    delta[v] = d;
  }
#pragma unroll
  for (int v = 0; v < kWords; ++v) {
    const int64_t lo = (w0 + v * kThreads + threadIdx.x) * 16;
    uint4 word;
    switch (kind[v]) {
      case kSkip: continue;
      case kZero: word = make_uint4(0, 0, 0, 0); break;
      case kFill: word = fill; break;
      case kCopy: word = delta[v] ? funnel16(a[v], b[v], delta[v]) : a[v];
                  break;
      default: word = bytes_word(P, col, off, p0, lo, live_bytes); break;
    }
    if (lo + 16 <= out_bytes) {
      *reinterpret_cast<uint4*>(dst + lo) = word;
    } else {  // the column's last, partial word
      const uint32_t lane[4] = {word.x, word.y, word.z, word.w};
      for (int j = 0; lo + j < out_bytes; ++j)
        dst[lo + j] = static_cast<char>((lane[j >> 2] >> (8 * (j & 3))) &
                                        0xffu);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
dyncopy_kernel(const __grid_constant__ Params P) {
  __shared__ int64_t off[kMaxParts + 1];
  if (threadIdx.x == 0) prefix(P, off);
  __syncthreads();
  const int64_t live_rows = off[P.k] < P.capacity ? off[P.k] : P.capacity;
  const uint32_t f = (static_cast<uint32_t>(P.fill) & 0xffu) * 0x01010101u;
  const uint4 fill = make_uint4(f, f, f, f);
  for (int64_t t = blockIdx.x; t < P.tiles; t += gridDim.x)
    copy_tile(P, off, live_rows, fill, t);
}

}  // namespace

// The layout and geometry this library was built with, for the wrapper to
// check against its own before any launch: {kThreads, kWords, kMaxParts,
// kMaxCols, kMaxPairs, sizeof(Pair), sizeof(Col), sizeof(Params)}.
extern "C" void p1_dyncopy_geometry(int64_t* out) {
  out[0] = kThreads;
  out[1] = kWords;
  out[2] = kMaxParts;
  out[3] = kMaxCols;
  out[4] = kMaxPairs;
  out[5] = sizeof(Pair);
  out[6] = sizeof(Col);
  out[7] = sizeof(Params);
}

// `p` describes the call (see Params; the columns' tile0 the running sum of
// their tiles, p->tiles the total), `blocks` the grid (a grid-stride loop
// over the tiles).  Returns cudaGetLastError() after the launch, or a
// negative code for an argument the kernel does not take.
extern "C" int p1_dyncopy(const void* params, int blocks, void* stream) {
  const Params* p = static_cast<const Params*>(params);
  if (p->k < 1 || p->k > kMaxParts || p->cols < 1 || p->cols > kMaxCols)
    return -2;
  if (p->capacity < 1 || p->tiles < 1 || blocks < 1) return -3;
  int64_t tiles = 0;
  for (int c = 0; c < p->cols; ++c) {
    const Col& col = p->col[c];
    if (col.row_bytes < 1 || col.tile0 != tiles || col.pair0 < 0 ||
        col.pair0 + p->k > kMaxPairs ||
        reinterpret_cast<uintptr_t>(col.dst) % 16 != 0)
      return -4;
    for (int q = col.pair0; q < col.pair0 + p->k; ++q)
      if (p->pair[q].row_bytes < 0 || p->pair[q].row_bytes > col.row_bytes)
        return -4;
    const int64_t words = (p->capacity * col.row_bytes + 15) / 16;
    tiles += (words + kTileWords - 1) / kTileWords;
  }
  if (tiles != p->tiles) return -4;
  dyncopy_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      *p);
  return static_cast<int>(cudaGetLastError());
}
