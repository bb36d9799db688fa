// REGRESSION inner loop: grad = X^T (sigmoid(X w) - y) / n and the mean
// logistic loss softplus(z) - y z, for X (n, d) fp32 row-major.
//
// Replaces the Pallas kernel `logreg_grad` (src/repro/kernels/logreg/
// logreg.py, body `_logreg_kernel`). That kernel carries the (d,) gradient
// and the loss in scratch memory across a sequential grid of row blocks.
// GPU blocks run in no fixed order, so the sum is split into two passes and
// stays deterministic without fp32 atomics:
//   pass 1 -- each block takes kRows rows: one warp per row computes
//             z = <x_r, w> (coalesced loads, shuffle reduction), the error
//             sigmoid(z) - y and the stable softplus max(z,0)+log1p(e^-|z|);
//             then the block's threads stride over the d columns and write
//             the block's partial gradient sum_r err_r x_r and its partial
//             loss to a (blocks, d+1) scratch;
//   pass 2 -- one block sums the partials in block order and divides by n.
// No row is padded, so no softplus(0) correction is needed.
//
// What bounds it on the H100: each iteration must read X once (n*d*4 bytes:
// 12.7 MB for A1's 15910 x 200, 0.9 MB for the 58k x 4 shard regression),
// a few microseconds at 3.35 TB/s; at those sizes the two launches per
// iteration cost as much as the bytes, so the regression loop is bound by
// launch latency. Pass 1 re-reads its rows for the gradient, from L1/L2.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 256;  // rows per pass-1 block

__global__ void __launch_bounds__(kThreads)
    logreg_partial_kernel(const float* __restrict__ X,
                          const float* __restrict__ y,
                          const float* __restrict__ w,
                          float* __restrict__ part, int n, int d) {
  __shared__ float s_err[kRows];
  __shared__ float s_loss[kWarps];
  const int r0 = blockIdx.x * kRows;
  const int rows = min(kRows, n - r0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  float loss = 0.f;
  for (int r = warp; r < rows; r += kWarps) {
    const float* xr = X + (size_t)(r0 + r) * d;
    float z = 0.f;
    for (int j = lane; j < d; j += 32) z = fmaf(xr[j], w[j], z);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) z += __shfl_xor_sync(0xffffffffu, z, o);
    if (lane == 0) {
      const float yv = y[r0 + r];
      s_err[r] = 1.f / (1.f + expf(-z)) - yv;
      loss += fmaxf(z, 0.f) + log1pf(expf(-fabsf(z))) - yv * z;
    }
  }
  if (lane == 0) s_loss[warp] = loss;
  __syncthreads();

  float* out = part + (size_t)blockIdx.x * (d + 1);
  for (int j = threadIdx.x; j < d; j += kThreads) {
    float g = 0.f;
    for (int r = 0; r < rows; ++r)
      g = fmaf(s_err[r], X[(size_t)(r0 + r) * d + j], g);
    out[j] = g;
  }
  if (threadIdx.x == 0) {
    float l = 0.f;
    for (int k = 0; k < kWarps; ++k) l += s_loss[k];
    out[d] = l;
  }
}

__global__ void __launch_bounds__(kThreads)
    logreg_reduce_kernel(const float* __restrict__ part,
                         float* __restrict__ out, int blocks, int d, int n) {
  for (int j = threadIdx.x; j <= d; j += kThreads) {
    float s = 0.f;
    for (int b = 0; b < blocks; ++b) s += part[(size_t)b * (d + 1) + j];
    out[j] = s / static_cast<float>(n);
  }
}

}  // namespace

extern "C" {

// Number of pass-1 blocks (and rows of the scratch) for n rows.
int gredo_logreg_blocks(int n) { return (n + kRows - 1) / kRows; }

// out: (d + 1,) -- the mean gradient in out[0:d], the mean loss in out[d].
// part: (gredo_logreg_blocks(n), d + 1) scratch.
int gredo_logreg_f32(const void* x, const void* y, const void* w, void* part,
                     void* out, int n, int d, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int blocks = gredo_logreg_blocks(n);
  logreg_partial_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(w), static_cast<float*>(part), n, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  logreg_reduce_kernel<<<1, kThreads, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(out), blocks, d, n);
  return cudaGetLastError();
}

}  // extern "C"
