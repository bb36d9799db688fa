// Register-blocked FFMA SGEMM shared by the MULTIPLY (matmul.cu) and
// SIMILARITY (cosine_sim.cu) kernels.
//
// C[i, j] = epi(sum_k A[i, k] * B[k, j], i, j) with fp32 accumulation.
// A is (M, K) row-major with leading dimension lda. B is either (K, N)
// row-major (B_T = false) or handed over as its transpose Bt, an (N, K)
// row-major matrix (B_T = true) -- the layout of `x.T` for the Gram product
// and of the second operand of cosine similarity, so neither needs a copy.
//
// What bounds it on the H100: at the A2/A3 shapes (15910 x 200 x 15910) the
// product is 1.0e11 flop against ~1 GB of output, so the fp32 FFMA rate
// (67 TFLOP/s, 1.5 ms) bounds it; writing the output alone takes >= 0.30 ms.
// Tensor cores are not an option: TF32 would break the fp32 tolerance.
//
// Design: each 256-thread block owns a 128x128 output tile and every thread
// an 8x8 register micro-tile (64 FFMA per 16 bytes read from shared memory
// per operand pair), so shared-memory bandwidth stays below the FFMA rate.
//   * K advances in steps of 8. Both operand tiles are staged K-major,
//     As[k][m] and Bs[k][n], in two shared-memory buffers: the global loads
//     of step k+1 go into registers before step k is computed, and are
//     stored into the other buffer after it, so one barrier per step
//     suffices and the loads' latency hides behind 512 FFMA per thread.
//   * A thread's micro-tile is rows {4ty..4ty+3, 64+4ty..} and columns
//     {4tx..4tx+3, 64+4tx..}: each operand is read as two float4s per k, and
//     the 8 threads of a quarter-warp read 8 consecutive float4s (or one,
//     broadcast), free of bank conflicts. The row pitch of 132 floats makes
//     the transposing stores of A (and of Bt) conflict-free too.
//   * Global loads are 4 elements wide (16 bytes in fp32) when the leading
//     dimensions, the pointers and K (and N, for a row-major B) allow it --
//     a kernel instantiated for that case (A3's K = 200 rows of 800 bytes
//     are); otherwise masked scalar loads. Either way the ragged edges of M,
//     N and K read as zero, so no operand is padded. bf16 inputs are
//     widened to fp32 as they are loaded.
//   * The epilogue stores float4s where N, ldc and the pointer allow it,
//     with the streaming (evict-first) hint: the kernel never reads its
//     output back, and at A2/A3 the 1 GB output would otherwise churn L2
//     (chip_smoke.py on an H100: A3's kernel 3.08 -> 2.61 ms).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

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

constexpr int kBM = 128, kBN = 128, kBK = 8, kTM = 8, kTN = 8;
constexpr int kGemmThreads = (kBM / kTM) * (kBN / kTN);  // 256
constexpr int kPitch = kBM + 4;  // conflict-free transposing stores

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

// Four consecutive elements, widened to fp32 (p aligned to 4 elements).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const auto* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 lo = __bfloat1622float2(h[0]);
  const float2 hi = __bfloat1622float2(h[1]);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Elements p[0..3] of a row, zero unless `ok`: one 4-wide load when VEC
// (the caller guarantees that n, the elements left in the row, is then a
// multiple of 4), else the first n of them by masked scalar loads.
template <bool VEC, typename T>
__device__ __forceinline__ float4 load_row4(const T* p, bool ok, int n) {
  float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
  if (VEC) {
    if (ok && n > 0) r = load4(p);
  } else if (ok) {
    if (n > 0) r.x = to_f32(p[0]);
    if (n > 1) r.y = to_f32(p[1]);
    if (n > 2) r.z = to_f32(p[2]);
    if (n > 3) r.w = to_f32(p[3]);
  }
  return r;
}

__device__ __forceinline__ void fma_row(float (&acc)[kTN], float a,
                                        const float (&b)[kTN]) {
#pragma unroll
  for (int j = 0; j < kTN; ++j) acc[j] = fmaf(a, b[j], acc[j]);
}

template <typename T, bool B_T, bool VEC, typename Epi>
__global__ void __launch_bounds__(kGemmThreads, 2)
    gemm_kernel(const T* __restrict__ A, const T* __restrict__ B,
                T* __restrict__ C, int M, int N, int K, int lda, int ldb,
                int ldc, int c_vec, Epi epi) {
  __shared__ __align__(16) float As[2][kBK][kPitch];
  __shared__ __align__(16) float Bs[2][kBK][kPitch];
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);   // 0..15
  const int ty = tid / (kBN / kTN);   // 0..15
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  // This thread's share of each K step's loads: four consecutive elements
  // along K of one row of A (row tid / 2), and of B either four along N of
  // one K row (B row-major) or four along K of one row of Bt. The pointers
  // advance by one K step per load; *_rem count what is left along K.
  const int la_r = tid / 2, la_k = (tid % 2) * 4;
  const bool a_ok = m0 + la_r < M;
  const T* a_ptr = A + (size_t)min(m0 + la_r, M - 1) * lda + la_k;
  int a_rem = K - la_k;
  int lb_k, lb_n;
  if (B_T) {
    lb_n = tid / 2;
    lb_k = (tid % 2) * 4;
  } else {
    lb_k = tid / (kBN / 4);
    lb_n = (tid % (kBN / 4)) * 4;
  }
  const int gn = n0 + lb_n;
  const bool b_ok = gn < N;
  const T* b_ptr = B_T ? B + (size_t)min(gn, N - 1) * ldb + lb_k
                       : B + (size_t)lb_k * ldb + gn;
  const size_t b_step = B_T ? kBK : (size_t)kBK * ldb;
  int b_rem = K - lb_k;

  auto load = [&](float4& a, float4& b) {
    a = load_row4<VEC>(a_ptr, a_ok, a_rem);
    b = B_T ? load_row4<VEC>(b_ptr, b_ok, b_rem)
            : load_row4<VEC>(b_ptr, b_ok && b_rem > 0, N - gn);
    a_ptr += kBK;
    a_rem -= kBK;
    b_ptr += b_step;
    b_rem -= kBK;
  };
  auto store = [&](int buf, const float4& a, const float4& b) {
    As[buf][la_k + 0][la_r] = a.x;
    As[buf][la_k + 1][la_r] = a.y;
    As[buf][la_k + 2][la_r] = a.z;
    As[buf][la_k + 3][la_r] = a.w;
    if (B_T) {
      Bs[buf][lb_k + 0][lb_n] = b.x;
      Bs[buf][lb_k + 1][lb_n] = b.y;
      Bs[buf][lb_k + 2][lb_n] = b.z;
      Bs[buf][lb_k + 3][lb_n] = b.w;
    } else {
      *reinterpret_cast<float4*>(&Bs[buf][lb_k][lb_n]) = b;
    }
  };

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  float4 na, nb;
  load(na, nb);
  store(0, na, nb);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < K; k0 += kBK) {
    const bool more = k0 + kBK < K;
    if (more) load(na, nb);  // step k+1's loads in flight during step k
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kTM], b[kTN];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][4 * ty]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[buf][kk][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][4 * tx]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + 4 * tx]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < kTM; ++i) fma_row(acc[i], a[i], b);
    }
    if (more) store(buf ^ 1, na, nb);
    __syncthreads();
    buf ^= 1;
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (r >= M) continue;
    T* crow = C + (size_t)r * ldc;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = n0 + 64 * h + 4 * tx;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)   // the epilogue reads per-column data
        v[e] = c + e < N ? epi(acc[i][4 * h + e], r, c + e) : 0.f;
      if constexpr (sizeof(T) == 4) {
        if (c_vec && c + 3 < N) {
          __stcs(reinterpret_cast<float4*>(crow + c),
                 make_float4(v[0], v[1], v[2], v[3]));
          continue;
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + e < N) crow[c + e] = from_f32<T>(v[e]);
    }
  }
}

template <typename T>
bool aligned4(const T* p, int ld) {
  return ld % 4 == 0 &&
         reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T)) == 0;
}

template <typename T, bool B_T, typename Epi>
cudaError_t launch_gemm(const T* A, const T* B, T* C, int M, int N, int K,
                        int lda, int ldb, int ldc, Epi epi,
                        cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  // 4-wide loads when every 4-element group a thread loads is aligned and
  // either wholly inside the matrix or wholly past its edge
  const bool vec = aligned4(A, lda) && aligned4(B, ldb) && K % 4 == 0 &&
                   (B_T || N % 4 == 0);
  // float4 stores only for fp32 output (bf16 output stores elementwise)
  const int c_vec = sizeof(T) == 4 && aligned4(C, ldc);
  if (vec)
    gemm_kernel<T, B_T, true, Epi><<<grid, kGemmThreads, 0, stream>>>(
        A, B, C, M, N, K, lda, ldb, ldc, c_vec, epi);
  else
    gemm_kernel<T, B_T, false, Epi><<<grid, kGemmThreads, 0, stream>>>(
        A, B, C, M, N, K, lda, ldb, ldc, c_vec, epi);
  return cudaGetLastError();
}

}  // namespace gredo
