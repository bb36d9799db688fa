// MULTIPLY: C = x @ y with fp32 accumulation, output in the input dtype.
//
// Replaces the Pallas kernel `matmul` (src/repro/kernels/matmul/matmul.py,
// body `_matmul_kernel`). The Pallas version zero-pads both operands to its
// block sizes and carries the accumulator across a sequential K grid axis;
// here each block loops over K itself and masks the ragged edges, so nothing
// is padded (see gemm.cuh for the tile design and what bounds it).
//
// `MatMul[gram]` passes `x.T`, a transposed view of a contiguous matrix. The
// wrapper hands that buffer over unchanged with b_trans = 1 (the kernel reads
// B as (N, K) row-major), so the Gram product makes no transposed copy.
#include "gemm.cuh"

extern "C" {

const char* gredo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int gredo_matmul_f32(const void* a, const void* b, void* c, int M, int N,
                     int K, int lda, int ldb, int ldc, int b_trans,
                     void* stream) {
  const auto* A = static_cast<const float*>(a);
  const auto* B = static_cast<const float*>(b);
  auto* C = static_cast<float*>(c);
  auto s = static_cast<cudaStream_t>(stream);
  if (b_trans)
    return gredo::launch_gemm<float, true>(A, B, C, M, N, K, lda, ldb, ldc,
                                           gredo::NoScale{}, s);
  return gredo::launch_gemm<float, false>(A, B, C, M, N, K, lda, ldb, ldc,
                                          gredo::NoScale{}, s);
}

int gredo_matmul_bf16(const void* a, const void* b, void* c, int M, int N,
                      int K, int lda, int ldb, int ldc, int b_trans,
                      void* stream) {
  const auto* A = static_cast<const __nv_bfloat16*>(a);
  const auto* B = static_cast<const __nv_bfloat16*>(b);
  auto* C = static_cast<__nv_bfloat16*>(c);
  auto s = static_cast<cudaStream_t>(stream);
  if (b_trans)
    return gredo::launch_gemm<__nv_bfloat16, true>(A, B, C, M, N, K, lda, ldb,
                                                   ldc, gredo::NoScale{}, s);
  return gredo::launch_gemm<__nv_bfloat16, false>(A, B, C, M, N, K, lda, ldb,
                                                  ldc, gredo::NoScale{}, s);
}

}  // extern "C"
