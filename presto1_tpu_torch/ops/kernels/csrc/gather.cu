// Clamped gather of rows, columns and along an axis, for Hopper.
//
// Replaces the gather probes of the JAX package
// (experiments/pallas_primitives.py `t1`: `take(x, idx)` of 2048 int32 in fast
// memory, `t1b`: rows of a [1024, 128] matrix; experiments/
// pallas_primitives2.py and pallas_primitives3.py `t1c` / `t1d`:
// `take_along_axis` on axis 0 / axis 1), the primitive under every payload
// move of the engine: rows after a sort, representatives of groups, the
// survivors of a compaction.
//
// Two bodies.
//
// `gather_rows_kernel` moves every column of a call through one index in
// ONE launch, whatever the element widths.  The wrapper describes each
// column as word columns ("units"): a 1-D column is one unit of its element
// width, an [n, W] matrix is one unit per word of its row, each with the row
// stride in words.  The units travel in one __grid_constant__ parameter
// struct (`Params`, at most kMaxUnits; the wrapper splits a call beyond it).
// For output rows i and units u:
//
//   g         = clamp(idx[i], 0, n - 1)
//   u.dst[i * u.stride] = u.src[g * u.stride]          (words of 2^u.lw bytes)
//
// A thread takes R output rows of a tile, warp-interleaved (lane l of a warp
// the rows 32 r + l of the warp's 32 R), so that each load and store
// instruction of a warp covers 32 consecutive rows: it reads its R indices
// as streaming loads and clamps them, then issues the source loads of up to
// kLoads / R units before it stores anything (read-only loads through
// `__restrict__` locals, so the compiler keeps them all in flight), and
// writes them with streaming stores.  R = kRows = 4 at every element width
// (8 and 16 measured slower at every width timed).  Offsets are 32-bit
// where every byte offset of the call fits (`Off`).  (R consecutive rows a
// thread, each unit's R words one vector store, measured slower at every
// shape timed: on a sequential index a warp's load then spans 32 sectors
// for 8 bytes each.)
//
// What bounds it on this card: a random index makes every source word a
// 32-byte sector read, so a random gather is bound by the rate at which
// the card serves random sectors (a microbenchmark of sector reads alone
// reaches it with one load in flight a thread at full occupancy), not by
// the stream rate.  L2 residency decides that rate:
// the index and the output are streams (read and written with evict-first
// hints), the sources are read with an evict-last policy where the sources
// of a group fit the L2 budget, so that they are read from device memory
// about once.  When the sources of one call exceed the L2 budget the
// wrapper puts groups of units on blockIdx.y: the blocks of one group run
// together while its sources stay resident.  Only scattered tiles need
// that: a tile whose indices stay local reads its sources as streams, and
// is moved whole by one group, the groups taking such tiles in turn, so a
// sequential index costs one pass.
//
// `take_along_axis_kernel` is numpy's take_along_axis on a 2-D x with an
// index per output element (the probes `t1c` / `t1d`), for idx [rows,
// width] and e = i * width + j:
//
//   axis 0:  out[e] = x[clamp(idx[e], 0, n - 1) * wx + j]     (wx == width)
//   axis 1:  out[e] = x[i * wx + clamp(idx[e], 0, n - 1)]     (rows of x)
//
// The engine's two calls are width 1: the window's doubling-table lookup
// (x [24 n, 1] int64, 12M frame ends, axis 0) and element_at's lane of an
// [n, 2] int64 matrix (axis 1).  What bounds it: bytes -- the index read
// and the output written once, and the sectors of x the index names.
// element_at reads its own row, so every sector of x moves; the window's
// ends name 1.5M sectors spread over a table 23 times the L2, so there the
// card's random sector rate limits it.  The body of the earlier design
// (a strided gather, since deleted) took ONE element a thread a grid-stride
// step, so its index load and the dependent source load were the only
// loads it had in flight; it divided the element number by the width in 64
// bits (an emulated division) on every element although the width was 1;
// it gave no cache hints; and its grid was capped at 16 blocks an SM.  It
// took 0.1071 ms at the window's call and 0.0671 ms at element_at's, where
// torch.gather took 0.1049 and 0.0661 (chip_smoke.py, NVIDIA H100 80GB
// HBM3, 700 W, before this body existed).  This body: a thread takes
// kTakeLoads elements a step, loaded as 16-byte index vectors issued
// together (streaming loads, from a 16-byte boundary at or below the
// index's first element: a view's `head` elements below it are skipped),
// then every source load of the step
// before any store, then the outputs as streaming stores (one vector of
// the step's elements where the output is aligned); (i, j) from a
// multiply-high by the width's magic number (Granlund and Montgomery),
// never a division, and nothing at all where the width is 1; 32-bit
// offsets where x and the element numbers fit 2^31; the source loads under
// the row body's L2 policy (evict-last only where x fits half the L2); and
// a grid of the occupancy the kernel reaches (cudaOccupancy...), every SM
// full, grid-stride beyond.
//
// Plain C interface for ctypes; launches on the caller's stream, does not
// synchronise, allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxUnits = 64;  // units one launch of the row body takes
constexpr int kLoads = 16;     // source words a thread keeps in flight
constexpr int kRows = 4;       // output rows a thread takes (R)
constexpr int kTakeLoads = 8;  // elements a thread of take_along_axis takes

// ------------------------------------------------------------ the row body

struct Unit {
  const void* src;  // word 0 of row 0
  void* dst;
  int32_t lw;       // log2 of the word's bytes: 0..3
  int32_t stride;   // words from one row to the next (1: a 1-D column)
};

struct Params {
  const void* idx;    // int32 or int64 [rows]
  int64_t rows;       // output rows
  int64_t n;          // source rows, >= 1
  int32_t count;      // units
  int32_t per_group;  // units a blockIdx.y group takes
  int32_t keep;       // a group's sources fit the L2 budget: evict-last
  int32_t unused;
  Unit unit[kMaxUnits];
};

// the L2 policy of the source loads: evict-last where a group's sources
// fit the budget (they stay resident while the group's blocks run), else
// evict-normal (marking more than the L2 holds evict-last measured slower
// than no hint)
__device__ __forceinline__ uint64_t source_policy(bool keep) {
  uint64_t policy;
  if (keep)
    asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
        : "=l"(policy));
  else
    asm("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;"
        : "=l"(policy));
  return policy;
}

// one read-only source word, loaded under the L2 policy `pol`
template <int LW>
__device__ __forceinline__ uint64_t load_word(const char* p, uint64_t pol) {
  if constexpr (LW == 0) {
    uint32_t v;
    asm("ld.global.nc.L2::cache_hint.u8 %0, [%1], %2;"
        : "=r"(v) : "l"(p), "l"(pol));
    return v;
  } else if constexpr (LW == 1) {
    uint32_t v;
    asm("ld.global.nc.L2::cache_hint.u16 %0, [%1], %2;"
        : "=r"(v) : "l"(p), "l"(pol));
    return v;
  } else if constexpr (LW == 2) {
    uint32_t v;
    asm("ld.global.nc.L2::cache_hint.u32 %0, [%1], %2;"
        : "=r"(v) : "l"(p), "l"(pol));
    return v;
  } else {
    uint64_t v;
    asm("ld.global.nc.L2::cache_hint.u64 %0, [%1], %2;"
        : "=l"(v) : "l"(p), "l"(pol));
    return v;
  }
}

template <int LW, typename Off>
__device__ __forceinline__ void load_unit(const Unit& u,
                                          const Off (&g)[kRows], uint64_t pol,
                                          uint64_t (&v)[kRows]) {
  const char* __restrict__ src = static_cast<const char*>(u.src);
  const Off stride = static_cast<Off>(u.stride);
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    v[r] = load_word<LW>(src + ((g[r] * stride) << LW), pol);
}

template <int LW>
__device__ __forceinline__ void store_word(char* d, uint64_t v) {
  if constexpr (LW == 0)
    __stcs(reinterpret_cast<unsigned char*>(d), static_cast<unsigned char>(v));
  else if constexpr (LW == 1)
    __stcs(reinterpret_cast<unsigned short*>(d),
           static_cast<unsigned short>(v));
  else if constexpr (LW == 2)
    __stcs(reinterpret_cast<unsigned int*>(d), static_cast<unsigned int>(v));
  else
    __stcs(reinterpret_cast<unsigned long long*>(d),
           static_cast<unsigned long long>(v));
}

// a unit's words of the thread's rows (row0 + 32 r, those below `rows`)
template <int LW>
__device__ __forceinline__ void store_unit(const Unit& u, int64_t row0,
                                           int64_t rows,
                                           const uint64_t (&v)[kRows]) {
  char* __restrict__ dst = static_cast<char*>(u.dst);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int64_t row = row0 + 32 * r;
    if (row < rows) store_word<LW>(dst + ((row * u.stride) << LW), v[r]);
  }
}

__device__ __forceinline__ int32_t load_index(const int32_t* p) {
  return __ldcs(reinterpret_cast<const int*>(p));
}

__device__ __forceinline__ int64_t load_index(const int64_t* p) {
  return __ldcs(reinterpret_cast<const long long*>(p));
}

// whether a tile's indices stay local: its first and last within a few
// tiles' rows of each other (a sequential run, a compaction), so that its
// sources are read as streams
template <typename I>
__device__ __forceinline__ bool local_tile(const I* idx, int64_t tile,
                                           int64_t rows) {
  constexpr int64_t kTileRows = static_cast<int64_t>(kThreads) * kRows;
  const int64_t b0 = tile * kTileRows;
  const int64_t end = (b0 + kTileRows < rows ? b0 + kTileRows : rows) - 1;
  const int64_t a = load_index(idx + b0), z = load_index(idx + end);
  return (z > a ? z - a : a - z) <= 4 * kTileRows;
}

// A block takes tiles of kThreads * R output rows, grid-stride; warp w of a
// tile takes its rows [w * 32 R, (w + 1) * 32 R), and lane l of it the
// rows 32 r + l, so that each load and store instruction of a warp covers
// 32 consecutive rows.  With groups (gridDim.y > 1) a block first finds,
// one thread a tile, which of its next kThreads tiles are local: a local
// tile is moved whole (every unit) by one group, the groups taking such
// tiles in turn; a scattered tile is moved by every group, each its own
// units, so that the sources of one group stay in L2 while its blocks run.
template <typename I, typename Off>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const __grid_constant__ Params p) {
  // units whose loads fly together
  constexpr int kChunk = kLoads / kRows;
  constexpr int64_t kTileRows = static_cast<int64_t>(kThreads) * kRows;
  __shared__ bool local[kThreads];
  const uint64_t pol = source_policy(p.keep != 0);
  const I* __restrict__ idx = static_cast<const I*>(p.idx);
  const int64_t imax = sizeof(I) == 4 ? INT32_MAX : INT64_MAX;
  const I hi = static_cast<I>(p.n - 1 < imax ? p.n - 1 : imax);
  const int groups = static_cast<int>(gridDim.y);
  const int group = static_cast<int>(blockIdx.y);
  const int first = group * p.per_group;
  const int last = min(p.count, first + p.per_group);
  const int64_t tiles = (p.rows + kTileRows - 1) / kTileRows;
  const int64_t step = gridDim.x;
  for (int64_t t0 = blockIdx.x; t0 < tiles; t0 += step * kThreads) {
    if (groups > 1) {
      const int64_t t = t0 + threadIdx.x * step;
      local[threadIdx.x] = t < tiles && local_tile<I>(idx, t, p.rows);
      __syncthreads();
    }
    for (int j = 0; j < kThreads; ++j) {
      const int64_t t = t0 + j * step;
      if (t >= tiles) break;
      int u_first = first, u_last = last;
      if (groups > 1 && local[j]) {
        u_first = 0;
        u_last = t % groups == group ? p.count : 0;
      }
      if (u_first >= u_last) continue;
      const int64_t row0 = t * kTileRows + (threadIdx.x / 32) * 32 * kRows +
                           threadIdx.x % 32;
      if (row0 >= p.rows) continue;
      Off g[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int64_t row = row0 + 32 * r;
        const I x = row < p.rows ? load_index(idx + row) : I{0};
        g[r] = static_cast<Off>(x < 0 ? 0 : (x > hi ? hi : x));
      }
      for (int u0 = u_first; u0 < u_last; u0 += kChunk) {
        uint64_t v[kChunk][kRows];
        // every load of the chunk before any store
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          if (u0 + c >= u_last) break;
          const Unit& u = p.unit[u0 + c];
          switch (u.lw) {
            case 0: load_unit<0, Off>(u, g, pol, v[c]); break;
            case 1: load_unit<1, Off>(u, g, pol, v[c]); break;
            case 2: load_unit<2, Off>(u, g, pol, v[c]); break;
            default: load_unit<3, Off>(u, g, pol, v[c]); break;
          }
        }
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          if (u0 + c >= u_last) break;
          const Unit& u = p.unit[u0 + c];
          switch (u.lw) {
            case 0: store_unit<0>(u, row0, p.rows, v[c]); break;
            case 1: store_unit<1>(u, row0, p.rows, v[c]); break;
            case 2: store_unit<2>(u, row0, p.rows, v[c]); break;
            default: store_unit<3>(u, row0, p.rows, v[c]); break;
          }
        }
      }
    }
    if (groups > 1) __syncthreads();  // local[] is read before it is reset
  }
}

template <typename I>
int launch_rows(const Params& p, bool wide, dim3 grid, cudaStream_t s) {
  if (wide)
    gather_rows_kernel<I, uint64_t><<<grid, kThreads, 0, s>>>(p);
  else
    gather_rows_kernel<I, uint32_t><<<grid, kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------- the take_along_axis body

struct TakeParams {
  const void* x;    // [rows of x, wx] elements of 2^lt bytes
  const void* idx;  // the 16-byte boundary at or below idx's element 0
  void* out;        // [total] elements of 2^lt bytes
  int64_t total;    // index elements: rows * width
  int64_t n;        // length of the gathered axis, >= 1
  int64_t wx;       // x's row in elements
  int64_t width;    // idx's row in elements
  int64_t magic;    // e / width = (t + ((e - t) >> 1)) >> shift,
                    // t = mulhi(e, magic) in the offsets' bits (width >= 2)
  int32_t shift;
  int32_t head;     // index elements between `idx` and element 0
  int32_t keep;     // x fits the L2 budget: evict-last source loads
  int32_t vec_out;  // head 0 and out 16-byte aligned: a vector store a step
};

// e / width for width >= 2, by the magic number (no division)
__device__ __forceinline__ uint32_t div_width(uint32_t e, const TakeParams& p) {
  const uint32_t t = __umulhi(e, static_cast<uint32_t>(p.magic));
  return (t + ((e - t) >> 1)) >> p.shift;
}

__device__ __forceinline__ uint64_t div_width(uint64_t e, const TakeParams& p) {
  const uint64_t t = __umul64hi(e, static_cast<uint64_t>(p.magic));
  return (t + ((e - t) >> 1)) >> p.shift;
}

// one 16-byte index vector, streaming (evict-first)
template <typename I>
__device__ __forceinline__ void load_index_vector(const uint4* p,
                                                  I (&ix)[16 / sizeof(I)]) {
  uint32_t a, b, c, d;
  asm("ld.global.cs.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(a), "=r"(b), "=r"(c), "=r"(d) : "l"(p));
  if constexpr (sizeof(I) == 4) {
    ix[0] = static_cast<I>(a);
    ix[1] = static_cast<I>(b);
    ix[2] = static_cast<I>(c);
    ix[3] = static_cast<I>(d);
  } else {
    ix[0] = static_cast<I>((static_cast<uint64_t>(b) << 32) | a);
    ix[1] = static_cast<I>((static_cast<uint64_t>(d) << 32) | c);
  }
}

// V consecutive output elements of 2^LT bytes as one streaming store (two
// for 32 bytes); `d` is aligned to their bytes
template <int LT, int V>
__device__ __forceinline__ void store_vector(char* d,
                                             const uint64_t (&v)[V]) {
  constexpr int kBytes = V << LT;
  if constexpr (kBytes == 32 || (kBytes == 16 && LT == 3)) {
#pragma unroll
    for (int h = 0; h < kBytes / 16; ++h)
      asm volatile("st.global.cs.v2.u64 [%0], {%1, %2};"
                   :: "l"(d + 16 * h), "l"(v[2 * h]), "l"(v[2 * h + 1])
                   : "memory");
  } else if constexpr (kBytes == 16) {  // four 4-byte elements
    asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};"
                 :: "l"(d), "r"(static_cast<uint32_t>(v[0])),
                    "r"(static_cast<uint32_t>(v[1])),
                    "r"(static_cast<uint32_t>(v[2])),
                    "r"(static_cast<uint32_t>(v[3]))
                 : "memory");
  } else {  // 2, 4 or 8 bytes: the elements packed into one word
    constexpr int kBits = 8 << LT;
    uint64_t w = 0;
#pragma unroll
    for (int k = 0; k < V; ++k)
      w |= (v[k] & ((1ull << kBits) - 1)) << (k * kBits);
    if constexpr (kBytes == 8)
      __stcs(reinterpret_cast<unsigned long long*>(d),
             static_cast<unsigned long long>(w));
    else if constexpr (kBytes == 4)
      __stcs(reinterpret_cast<unsigned int*>(d), static_cast<unsigned int>(w));
    else
      __stcs(reinterpret_cast<unsigned short*>(d),
             static_cast<unsigned short>(w));
  }
}

// A thread takes U = kTakeLoads / V index vectors of V elements a step
// (vector k of the block's step at k * kThreads + threadIdx.x, so that each
// load instruction of a warp reads 512 consecutive bytes), grid-stride.
// Vector q holds the elements q * V - head + [0, V); those outside
// [0, total) are neither loaded from x nor stored.
template <int LT, typename I, typename Off, int kAxis>
__global__ void __launch_bounds__(kThreads)
take_along_axis_kernel(const __grid_constant__ TakeParams p) {
  constexpr int V = 16 / static_cast<int>(sizeof(I));
  constexpr int U = kTakeLoads / V;
  const uint64_t pol = source_policy(p.keep != 0);
  const char* __restrict__ x = static_cast<const char*>(p.x);
  char* __restrict__ out = static_cast<char*>(p.out);
  const uint4* __restrict__ iv = static_cast<const uint4*>(p.idx);
  const int64_t imax = sizeof(I) == 4 ? INT32_MAX : INT64_MAX;
  const I hi = static_cast<I>(p.n - 1 < imax ? p.n - 1 : imax);
  const bool one = p.width == 1;
  const Off wx = static_cast<Off>(p.wx);
  const Off width = static_cast<Off>(p.width);
  const int64_t vectors = (p.head + p.total + V - 1) / V;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads * U;
  for (int64_t q0 = static_cast<int64_t>(blockIdx.x) * kThreads * U +
                    threadIdx.x;
       q0 < vectors; q0 += step) {
    I ix[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t q = q0 + static_cast<int64_t>(u) * kThreads;
      if (q < vectors) {
        load_index_vector<I>(iv + q, ix[u]);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) ix[u][v] = I{0};
      }
    }
    // every source load of the step before any store
    uint64_t val[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int64_t e = (q0 + static_cast<int64_t>(u) * kThreads) * V + v -
                          p.head;
        val[u][v] = 0;
        if (e < 0 || e >= p.total) continue;
        const I y = ix[u][v];
        const Off g = static_cast<Off>(y < 0 ? I{0} : (y > hi ? hi : y));
        const Off oe = static_cast<Off>(e);
        Off off;
        if constexpr (kAxis == 0) {
          off = one ? g : g * wx + (oe - div_width(oe, p) * width);
        } else {
          off = (one ? oe : div_width(oe, p)) * wx + g;
        }
        // the element offset fits Off; its byte offset may not
        val[u][v] = load_word<LT>(x + (static_cast<uint64_t>(off) << LT),
                                  pol);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t q = q0 + static_cast<int64_t>(u) * kThreads;
      const int64_t e0 = q * V - p.head;
      if (p.vec_out && e0 >= 0 && e0 + V <= p.total) {
        store_vector<LT, V>(out + (e0 << LT), val[u]);
        continue;
      }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int64_t e = e0 + v;
        if (e >= 0 && e < p.total) store_word<LT>(out + (e << LT), val[u][v]);
      }
    }
  }
}

template <int LT, typename I, typename Off, int kAxis>
int take_variant(const TakeParams* p, int blocks, cudaStream_t s,
                 int* blocks_per_sm) {
  auto kernel = take_along_axis_kernel<LT, I, Off, kAxis>;
  if (blocks_per_sm != nullptr)
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, kernel, kThreads, 0));
  kernel<<<blocks, kThreads, 0, s>>>(*p);
  return static_cast<int>(cudaGetLastError());
}

template <int LT, typename I>
int take_by_offsets(const TakeParams* p, int wide, int axis, int blocks,
                    cudaStream_t s, int* bps) {
  if (wide)
    return axis == 0 ? take_variant<LT, I, uint64_t, 0>(p, blocks, s, bps)
                     : take_variant<LT, I, uint64_t, 1>(p, blocks, s, bps);
  return axis == 0 ? take_variant<LT, I, uint32_t, 0>(p, blocks, s, bps)
                   : take_variant<LT, I, uint32_t, 1>(p, blocks, s, bps);
}

template <int LT>
int take_by_index(const TakeParams* p, int idx_w, int wide, int axis,
                  int blocks, cudaStream_t s, int* bps) {
  if (idx_w == 4)
    return take_by_offsets<LT, int32_t>(p, wide, axis, blocks, s, bps);
  if (idx_w == 8)
    return take_by_offsets<LT, int64_t>(p, wide, axis, blocks, s, bps);
  return -1;
}

// the variant's launch (bps null) or its occupancy in blocks an SM
int take_dispatch(const TakeParams* p, int lt, int idx_w, int wide, int axis,
                  int blocks, cudaStream_t s, int* bps) {
  if (axis != 0 && axis != 1) return -2;
  switch (lt) {
    case 0: return take_by_index<0>(p, idx_w, wide, axis, blocks, s, bps);
    case 1: return take_by_index<1>(p, idx_w, wide, axis, blocks, s, bps);
    case 2: return take_by_index<2>(p, idx_w, wide, axis, blocks, s, bps);
    case 3: return take_by_index<3>(p, idx_w, wide, axis, blocks, s, bps);
    default: return -1;
  }
}

}  // namespace

// The layout and geometry this library was built with, for the wrapper to
// check against its ctypes mirror before any launch: {kThreads, kMaxUnits,
// kLoads, sizeof(Unit), sizeof(Params), kRows, kTakeLoads,
// sizeof(TakeParams)}.
extern "C" void p1_gather_geometry(int64_t* out) {
  out[0] = kThreads;
  out[1] = kMaxUnits;
  out[2] = kLoads;
  out[3] = sizeof(Unit);
  out[4] = sizeof(Params);
  out[5] = kRows;
  out[6] = kTakeLoads;
  out[7] = sizeof(TakeParams);
}

// take_along_axis: `params` a TakeParams, `lt` log2 of x's element bytes
// (0..3), `idx_w` the index width (4 or 8), `wide` 64-bit offsets, `axis`
// 0 or 1, `blocks` the grid.  Returns cudaGetLastError() after the launch,
// or a negative code for an argument the kernel does not take.
extern "C" int p1_take_along_axis(const void* params, int lt, int idx_w,
                                  int wide, int axis, int blocks,
                                  void* stream) {
  const TakeParams* p = static_cast<const TakeParams*>(params);
  if (p->n < 1 || p->total < 1 || p->width < 1 || p->wx < 1 || blocks < 1)
    return -3;
  if (p->head < 0 || p->head * idx_w >= 16 ||
      reinterpret_cast<uintptr_t>(p->idx) % 16 != 0)
    return -4;
  if (p->width > 1 && (p->shift < 0 || p->shift > 63)) return -5;
  return take_dispatch(p, lt, idx_w, wide, axis, blocks,
                       static_cast<cudaStream_t>(stream), nullptr);
}

// Blocks an SM that the occupancy calculator gives the take_along_axis
// variant (`lt`, `idx_w`, `wide`, `axis`), or a negative code.
extern "C" int p1_take_blocks_per_sm(int lt, int idx_w, int wide, int axis) {
  int blocks = 0;
  const int err = take_dispatch(nullptr, lt, idx_w, wide, axis, 1, nullptr,
                                &blocks);
  return err == 0 ? blocks : (err > 0 ? -err : err);
}

// The row body: `p` describes the call (units, index, rows, n), `idx_w` the
// index width (4 or 8), `wide` 64-bit offsets, `blocks` x `groups` the grid
// (groups * p->per_group >= count).
// Returns cudaGetLastError() after the launch, or a negative code for an
// argument the kernel does not take.
extern "C" int p1_gather_rows(const void* params, int idx_w, int wide,
                              int blocks, int groups, void* stream) {
  const Params* p = static_cast<const Params*>(params);
  if (p->count < 1 || p->count > kMaxUnits || p->per_group < 1 ||
      groups < 1 || static_cast<int64_t>(groups) * p->per_group < p->count)
    return -2;
  if (p->n < 1 || p->rows < 1 || blocks < 1) return -3;
  for (int u = 0; u < p->count; ++u)
    if (p->unit[u].lw < 0 || p->unit[u].lw > 3 || p->unit[u].stride < 1)
      return -4;
  const dim3 grid(blocks, groups);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idx_w == 4)
    return launch_rows<int32_t>(*p, wide != 0, grid, s);
  if (idx_w == 8)
    return launch_rows<int64_t>(*p, wide != 0, grid, s);
  return -1;
}
