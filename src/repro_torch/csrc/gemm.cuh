// Shared-memory-tiled FFMA GEMM shared by the MULTIPLY (matmul.cu) and
// SIMILARITY (cosine_sim.cu) kernels.
//
// C[i, j] = epi(sum_k A[i, k] * B[k, j], i, j) with fp32 accumulation.
// A is (M, K) row-major with leading dimension lda. B is either (K, N)
// row-major (B_T = false) or handed over as its transpose Bt, an (N, K)
// row-major matrix (B_T = true) -- the layout of `x.T` for the Gram product
// and of the second operand of cosine similarity, so neither needs a copy.
//
// Each 256-thread block owns a 64x64 output tile and walks K in steps of 16:
// both operand tiles are staged in shared memory as fp32 (bf16 inputs are
// widened with __bfloat162float), then every thread accumulates a 4x4
// register micro-tile. The ragged edges of M, N and K are masked in the
// loads (zero fill) and in the store, so no operand is padded.
//
// What bounds it on the H100: at the A2/A3 shapes (15910 x 200 x 15910) the
// product is 1.0e11 flop against ~1 GB of output, so the fp32 FFMA rate
// (67 TFLOP/s) bounds it, not memory. This first version does no tensor-core
// (TF32 would break the fp32 tolerance), no cp.async/TMA pipelining and no
// persistent scheduling; those are later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace gredo {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

constexpr int kBM = 64, kBN = 64, kBK = 16, kTM = 4, kTN = 4;
constexpr int kGemmThreads = (kBM / kTM) * (kBN / kTN);  // 256
constexpr int kPad = 4;  // breaks the bank conflicts of the transposing stores

struct NoScale {
  __device__ __forceinline__ float operator()(float acc, int, int) const {
    return acc;
  }
};

// Cosine epilogue: acc * inv_norm_x[i] * inv_norm_y[j].
struct RowColScale {
  const float* ix;
  const float* iy;
  __device__ __forceinline__ float operator()(float acc, int i, int j) const {
    return acc * ix[i] * iy[j];
  }
};

template <typename T, bool B_T, typename Epi>
__global__ void __launch_bounds__(kGemmThreads)
    gemm_kernel(const T* __restrict__ A, const T* __restrict__ B,
                T* __restrict__ C, int M, int N, int K, int lda, int ldb,
                int ldc, Epi epi) {
  __shared__ float As[kBK][kBM + kPad];
  __shared__ float Bs[kBK][kBN + kPad];
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);
  const int ty = tid / (kBN / kTN);
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int t = 0; t < (kBM * kBK) / kGemmThreads; ++t) {
      const int idx = tid + t * kGemmThreads;
      const int r = idx / kBK, c = idx % kBK;
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? to_f32(A[(size_t)gm * lda + gk]) : 0.f;
    }
#pragma unroll
    for (int t = 0; t < (kBN * kBK) / kGemmThreads; ++t) {
      const int idx = tid + t * kGemmThreads;
      if (B_T) {
        const int r = idx / kBK, c = idx % kBK;  // r along N, c along K
        const int gn = n0 + r, gk = k0 + c;
        Bs[c][r] =
            (gn < N && gk < K) ? to_f32(B[(size_t)gn * ldb + gk]) : 0.f;
      } else {
        const int r = idx / kBN, c = idx % kBN;  // r along K, c along N
        const int gk = k0 + r, gn = n0 + c;
        Bs[r][c] =
            (gk < K && gn < N) ? to_f32(B[(size_t)gk * ldb + gn]) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = As[kk][ty + i * (kBM / kTM)];
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = Bs[kk][tx + j * (kBN / kTN)];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gm = m0 + ty + i * (kBM / kTM);
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gn = n0 + tx + j * (kBN / kTN);
      if (gn < N) C[(size_t)gm * ldc + gn] = from_f32<T>(epi(acc[i][j], gm, gn));
    }
  }
}

template <typename T, bool B_T, typename Epi>
cudaError_t launch_gemm(const T* A, const T* B, T* C, int M, int N, int K,
                        int lda, int ldb, int ldc, Epi epi,
                        cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  gemm_kernel<T, B_T, Epi>
      <<<grid, kGemmThreads, 0, stream>>>(A, B, C, M, N, K, lda, ldb, ldc, epi);
  return cudaGetLastError();
}

}  // namespace gredo
