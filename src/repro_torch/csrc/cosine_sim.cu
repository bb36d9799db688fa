// SIMILARITY: S[i, j] = <x_i, y_j> * rsqrt(|x_i|^2 + eps) * rsqrt(|y_j|^2 + eps).
//
// Replaces the Pallas kernel `cosine_sim` (src/repro/kernels/cosine_sim/
// cosine_sim.py, body `_cosine_kernel`). As there, the inverse row norms are
// computed once in a prelude and fused into the product's epilogue, so the
// (m, n) score matrix is written once and never normalised in a second pass.
//
// Prelude: one warp per row sums the squares with coalesced loads and a
// shuffle reduction (O(md + nd) bytes, negligible next to the output).
// Product: the shared tiled GEMM of gemm.cuh with the RowColScale epilogue.
// y is (n, d) row-major, so both operands are K-contiguous and y is read in
// place as the transposed B operand; the transposed copy the Pallas wrapper
// makes is not needed. Bounded, like MULTIPLY, by the fp32 FFMA rate.
#include "gemm.cuh"

namespace {

constexpr int kNormThreads = 256;

__global__ void __launch_bounds__(kNormThreads)
    row_inv_norm_kernel(const float* __restrict__ x, float* __restrict__ out,
                        int rows, int d, float eps) {
  const int row = (blockIdx.x * kNormThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // uniform per warp
  const float* r = x + (size_t)row * d;
  float s = 0.f;
  for (int j = lane; j < d; j += 32) s = fmaf(r[j], r[j], s);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) out[row] = rsqrtf(s + eps);
}

cudaError_t launch_norms(const float* x, float* out, int rows, int d,
                         float eps, cudaStream_t s) {
  if (rows == 0) return cudaSuccess;
  const int warps_per_block = kNormThreads / 32;
  const int blocks = (rows + warps_per_block - 1) / warps_per_block;
  row_inv_norm_kernel<<<blocks, kNormThreads, 0, s>>>(x, out, rows, d, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gredo_cosine_f32(const void* x, const void* y, void* inv_x,
                                void* inv_y, void* out, int M, int N, int K,
                                float eps, void* stream) {
  const auto* X = static_cast<const float*>(x);
  const auto* Y = static_cast<const float*>(y);
  auto* ix = static_cast<float*>(inv_x);
  auto* iy = static_cast<float*>(inv_y);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_norms(X, ix, M, K, eps, s);
  if (err != cudaSuccess) return err;
  err = launch_norms(Y, iy, N, K, eps, s);
  if (err != cudaSuccess) return err;
  return gredo::launch_gemm<float, true>(X, Y, static_cast<float*>(out), M, N,
                                         K, K, K, N, gredo::RowColScale{ix, iy},
                                         s);
}
