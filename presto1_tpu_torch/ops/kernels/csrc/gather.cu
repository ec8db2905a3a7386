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
// One body serves all four.  For an output element (i, j) of a [rows, width]
// result:
//
//   g      = clamp(idx[i * irs + j * ics], 0, n - 1)
//   out[e] = src[g * sgs + i * sis + j * sjs]        e = i * width + j
//
//   columns  (1-D, width 1):      irs 1, ics 0, sgs 1,     sis 0,  sjs 0
//   rows of [n, W]:               irs 1, ics 0, sgs W,     sis 0,  sjs 1
//   take_along_axis, axis 0:      irs W, ics 1, sgs W_src, sis 0,  sjs 1
//   take_along_axis, axis 1:      irs W, ics 1, sgs 1,     sis W_src, sjs 0
//
// and a table of up to 32 (source, destination) pairs of one element width
// shares the index: a batch's columns move in one launch per width, the index
// read once per row.  Clamping is in the kernel (`jnp.take(mode="clip")`;
// CUDA indexing does not clamp).
//
// Bound: memory.  idx is read once and the output written once, coalesced;
// the source reads land wherever idx says, so a random permutation pays a
// 32-byte sector for each 1 / 4 / 8-byte element.  Nothing here is staged in
// shared memory: the TPU kernels held the table in fast memory because their
// device memory has no fine-grained reads, the card's L2 does that job.
// Elements move as 1-, 2-, 4- or 8-byte words, whatever type they hold.
//
// Plain C interface for ctypes; launches on the caller's stream, does not
// synchronise, allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPairs = 32;

struct Table {
  const void* src[kMaxPairs];
  void* dst[kMaxPairs];
  int count;
};

struct Strides {
  int64_t irs, ics, sgs, sis, sjs;
};

template <typename T, typename I, bool kFlat>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const Table tab, const I* __restrict__ idx, int64_t rows,
              int64_t width, int64_t n, const Strides st) {
  const int64_t total = rows * width;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       e < total; e += stride) {
    int64_t i = e, j = 0;
    if (!kFlat) {
      i = e / width;
      j = e - i * width;
    }
    int64_t g = static_cast<int64_t>(idx[i * st.irs + j * st.ics]);
    g = g < 0 ? 0 : (g > n - 1 ? n - 1 : g);
    const int64_t off = g * st.sgs + i * st.sis + j * st.sjs;
    for (int c = 0; c < tab.count; ++c)
      static_cast<T*>(tab.dst[c])[e] = static_cast<const T*>(tab.src[c])[off];
  }
}

template <typename T, typename I>
int launch(const Table& tab, const void* idx, int64_t rows, int64_t width,
           int64_t n, const Strides& st, int blocks, cudaStream_t stream) {
  const I* ix = static_cast<const I*>(idx);
  if (width == 1 && st.ics == 0 && st.sjs == 0 && st.sis == 0)
    gather_kernel<T, I, true><<<blocks, kThreads, 0, stream>>>(
        tab, ix, rows, width, n, st);
  else
    gather_kernel<T, I, false><<<blocks, kThreads, 0, stream>>>(
        tab, ix, rows, width, n, st);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_idx(const Table& tab, const void* idx, int idx_w, int64_t rows,
               int64_t width, int64_t n, const Strides& st, int blocks,
               cudaStream_t stream) {
  if (idx_w == 4)
    return launch<T, int32_t>(tab, idx, rows, width, n, st, blocks, stream);
  if (idx_w == 8)
    return launch<T, int64_t>(tab, idx, rows, width, n, st, blocks, stream);
  return -1;
}

}  // namespace

extern "C" int p1_gather_threads() { return kThreads; }
extern "C" int p1_gather_max_pairs() { return kMaxPairs; }

// srcs / dsts: `count` device pointers each (host arrays), elements of
// elem_w bytes (1, 2, 4 or 8).  idx: int32 (idx_w 4) or int64 (idx_w 8).
// Every destination holds rows * width elements; n >= 1 is the length of the
// gathered axis.  strides: {irs, ics, sgs, sis, sjs} as above, in elements.
// Returns cudaGetLastError() after the launch, or a negative code for an
// argument the kernel does not take.
extern "C" int p1_gather(const void* const* srcs, void* const* dsts, int count,
                         int elem_w, const void* idx, int idx_w, int64_t rows,
                         int64_t width, int64_t n, const int64_t* strides,
                         int blocks, void* stream) {
  if (count < 1 || count > kMaxPairs) return -2;
  if (n < 1 || rows < 1 || width < 1 || blocks < 1) return -3;
  Table tab = {};
  tab.count = count;
  for (int c = 0; c < count; ++c) {
    tab.src[c] = srcs[c];
    tab.dst[c] = dsts[c];
  }
  const Strides st = {strides[0], strides[1], strides[2], strides[3],
                      strides[4]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_w) {
    case 1:
      return launch_idx<uint8_t>(tab, idx, idx_w, rows, width, n, st, blocks, s);
    case 2:
      return launch_idx<uint16_t>(tab, idx, idx_w, rows, width, n, st, blocks, s);
    case 4:
      return launch_idx<uint32_t>(tab, idx, idx_w, rows, width, n, st, blocks, s);
    case 8:
      return launch_idx<uint64_t>(tab, idx, idx_w, rows, width, n, st, blocks, s);
    default:
      return -1;
  }
}
