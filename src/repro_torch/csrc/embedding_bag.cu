// EmbeddingBag: out[i, :] = sum_j w[i, j] * table[idx[i, j], :] in fp32, for
// a (V, D) fp32 table and (n_bags, bag) int32 indices; an index of -1 is
// padding and weighs 0 (w = None weighs every valid slot 1).
//
// Replaces the Pallas kernel `embedding_bag` (src/repro/kernels/
// embedding_bag/embedding_bag.py, body `_bag_kernel`). That kernel
// scalar-prefetches the indices so that its table BlockSpec can fetch one
// (1, D) row per grid step (i, j) and adds it into the output block across
// the sequential j axis. Here a warp owns one bag and gathers its rows
// directly: lanes stride over D (coalesced row reads), j is summed in index
// order, the index is clamped to >= 0 and its weight multiplied by
// valid = (idx >= 0), as the reference does. An index >= V is the caller's
// error (the plain version raises on it); the kernel clamps it to V - 1 so
// that it never reads outside the table.
//
// What bounds it on the H100: every gathered row is read once (bag * D * 4
// bytes per bag) and the output written once; 2 flops per element read, so
// bytes bound it. The j loop is unrolled so that several rows are in flight
// per lane.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kBagsPerBlock = kThreads / 32;  // one warp per bag
constexpr int kCols = 4;                      // columns per lane per pass

__global__ void __launch_bounds__(kThreads)
    embedding_bag_kernel(const float* __restrict__ table,
                         const int* __restrict__ idx,
                         const float* __restrict__ w, float* __restrict__ out,
                         int n_bags, int bag, int V, int D) {
  const int i = blockIdx.x * kBagsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (i >= n_bags) return;
  const int* ib = idx + static_cast<size_t>(i) * bag;
  const float* wb = w ? w + static_cast<size_t>(i) * bag : nullptr;
  float* ob = out + static_cast<size_t>(i) * D;
  for (int d0 = 0; d0 < D; d0 += 32 * kCols) {
    float acc[kCols];
#pragma unroll
    for (int u = 0; u < kCols; ++u) acc[u] = 0.f;
#pragma unroll 8
    for (int j = 0; j < bag; ++j) {
      const int id = ib[j];
      const float valid = id >= 0 ? 1.f : 0.f;
      const float wt = wb ? wb[j] * valid : valid;
      const float* row =
          table + static_cast<size_t>(min(max(id, 0), V - 1)) * D;
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        const int d = d0 + lane + 32 * u;
        if (d < D) acc[u] += wt * row[d];
      }
    }
#pragma unroll
    for (int u = 0; u < kCols; ++u) {
      const int d = d0 + lane + 32 * u;
      if (d < D) ob[d] = acc[u];
    }
  }
}

}  // namespace

extern "C" {

// table (V, D) fp32, idx (n_bags, bag) int32, w (n_bags, bag) fp32 or null,
// out (n_bags, D) fp32; all contiguous.
int gredo_embedding_bag_f32(const void* table, const void* idx, const void* w,
                            void* out, int n_bags, int bag, int V, int D,
                            void* stream) {
  const int blocks = (n_bags + kBagsPerBlock - 1) / kBagsPerBlock;
  embedding_bag_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int*>(idx),
      static_cast<const float*>(w), static_cast<float*>(out), n_bags, bag, V,
      D);
  return cudaGetLastError();
}

}  // extern "C"
