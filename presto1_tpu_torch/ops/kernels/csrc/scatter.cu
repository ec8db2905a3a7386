// Scatter to distinct targets, for Hopper.
//
// Replaces the scatter probes of the JAX package
// (experiments/pallas_primitives.py `t2`: `zeros.at[idx].set(x)` in fast
// memory, and `t8`: a per-row scalar store loop), the primitive under the
// engine's stable compaction (prefix sum of a mask, then every kept row's
// index written to its rank).
//
//   for every i < n with mask[i] (or every i when there is no mask):
//     t = idx[i];  if 0 <= t < m:  out[t] = x[i]   (x absent: out[t] = i)
//
// Targets are distinct by contract, so no two threads write one address and
// the result does not depend on the order.  Out-of-range targets are dropped:
// the compaction sends rows it does not keep past the end.
//
// Bound: memory.  idx, mask and x are read once, coalesced; the writes land
// wherever idx says, 4 or 8 bytes each, so a random permutation pays a 32-byte
// sector per element while a compaction's targets ascend and coalesce.  The
// TPU kernel's serial store loop becomes one thread per row under a
// grid-stride loop.  Values are moved as 4- or 8-byte words, whatever type
// they hold.
//
// Plain C interface for ctypes; launches on the caller's stream, does not
// synchronise, allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
scatter_kernel(const I* __restrict__ idx, const T* __restrict__ x,
               const uint8_t* __restrict__ mask, T* __restrict__ out,
               int64_t n, int64_t m) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    if (mask != nullptr && mask[i] == 0) continue;
    const int64_t t = static_cast<int64_t>(idx[i]);
    if (t < 0 || t >= m) continue;
    out[t] = x != nullptr ? x[i] : static_cast<T>(i);
  }
}

template <typename T, typename I>
int launch(const void* idx, const void* x, const void* mask, void* out,
           int64_t n, int64_t m, int blocks, cudaStream_t stream) {
  scatter_kernel<T, I><<<blocks, kThreads, 0, stream>>>(
      static_cast<const I*>(idx), static_cast<const T*>(x),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), n, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int p1_scatter_threads() { return kThreads; }

// idx: int32 (idx_w 4) or int64 (idx_w 8) [n].  x: [n] words of out_w bytes,
// or null for x[i] = i.  mask: one byte per row, or null.  out: [m] words of
// out_w bytes (4 or 8), written only at the targets.  Returns
// cudaGetLastError() after the launch, or -1 for a width it does not take.
extern "C" int p1_scatter(const void* idx, int idx_w, const void* x,
                          const void* mask, void* out, int out_w, int64_t n,
                          int64_t m, int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_w == 4 && idx_w == 4)
    return launch<uint32_t, int32_t>(idx, x, mask, out, n, m, blocks, s);
  if (out_w == 4 && idx_w == 8)
    return launch<uint32_t, int64_t>(idx, x, mask, out, n, m, blocks, s);
  if (out_w == 8 && idx_w == 4)
    return launch<uint64_t, int32_t>(idx, x, mask, out, n, m, blocks, s);
  if (out_w == 8 && idx_w == 8)
    return launch<uint64_t, int64_t>(idx, x, mask, out, n, m, blocks, s);
  return -1;
}
