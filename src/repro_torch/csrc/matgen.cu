// Random-access matrix generation (the RandomAccessMatrix GCDA operator):
// from (row, value) pairs, whose rows the host has ranked (np.unique: one
// row per distinct group id, in ascending order), the (N, d) float32 matrix
// in which each pair with 0 <= value < d sets its column to 1 (multi-hot)
// or adds 1 to it (count).
//
// Replaces no Pallas kernel: it replaces the reference's host function
// `random_access_matrix` (src/repro/core/analytics.py:98), which fills a
// dense host matrix with np.add.at and copies the whole matrix to the
// device. Here only the pairs cross the bus (16 bytes a pair) and the matrix
// is made where it is used.
//
// Bound: bytes. The output is written once (4 N d) and the pairs read once
// (16 P): at M2Bench SF 40 (P = 128K pairs, N = 63,897, d = 200) 51.1 MB and
// 2.0 MB, about 16 us at 3.35 TB/s. The zeroing is a memset at the copy
// engine's rate; the scatter writes P words at random.
//
// gredo_matgen_scatter: zero the output, then one thread per pair stores 1.0
// (multi-hot: duplicate pairs store the same word, so no atomics) or adds
// 1.0 atomically (count: integer sums below 2^24 are exact in any order).
// No library call, no state between calls.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxStrideBlocks = 4096;      // grid of the per-pair loop

template <bool kCount>
__global__ void __launch_bounds__(kThreads)
    scatter_kernel(const int64_t* __restrict__ rows,
                   const int64_t* __restrict__ vals, int64_t n,
                   float* __restrict__ out, int d) {
  for (int64_t i = blockIdx.x * (int64_t)kThreads + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * kThreads) {
    const int64_t v = vals[i];
    if (v < 0 || v >= d) continue;
    float* p = out + rows[i] * d + v;
    if (kCount)
      atomicAdd(p, 1.f);
    else
      *p = 1.f;
  }
}

}  // namespace

// rows, vals: n >= 1 pairs, each row in [0, out_rows); out: out_rows x d
// floats, d >= 1.
extern "C" int gredo_matgen_scatter(const void* rows, const void* vals,
                                    int64_t n, void* out, int64_t out_rows,
                                    int d, int count, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* O = static_cast<float*>(out);
  cudaError_t err =
      cudaMemsetAsync(O, 0, (size_t)out_rows * d * sizeof(float), s);
  if (err != cudaSuccess) return err;
  const int64_t b = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(b < kMaxStrideBlocks ? b
                                                           : kMaxStrideBlocks);
  const auto* R = static_cast<const int64_t*>(rows);
  const auto* V = static_cast<const int64_t*>(vals);
  if (count)
    scatter_kernel<true><<<blocks, kThreads, 0, s>>>(R, V, n, O, d);
  else
    scatter_kernel<false><<<blocks, kThreads, 0, s>>>(R, V, n, O, d);
  return cudaGetLastError();
}
