// Causal / non-causal attention with an online softmax, GQA and a per-row KV
// length: o[b, h, i] = softmax(q[b, h, i] . k[b, h / G]^T * dh^-0.5) v[b, h / G]
// over the keys kpos < length[b] (and kpos <= qpos when causal), where the
// sq queries sit at positions qpos = length[b] - sq + i. A row with no key
// left outputs 0.
//
// Replaces the Pallas kernel `flash_attention` (src/repro/kernels/
// flash_attention/flash_attention.py, body `_flash_kernel`) and computes
// what it computes: masked scores are -1e30, p = exp(s - m_new) * mask (a
// masked key contributes exactly 0), the running max starts at -1e30, and
// the output is acc / (l == 0 ? 1 : l) in q's dtype. That kernel walks the
// KV axis as a sequential grid dimension with the running max, sum and
// accumulator in scratch memory; here one block loops over the KV tiles
// itself and keeps them in registers.
//
// Design (a first version: no tensor cores, no cp.async/TMA pipeline):
//   * one 128-thread block per (row tile, KV head, batch row). The rows of a
//     KV head are its G query heads times sq positions, ordered
//     r = i * G + g, so one K/V tile read from memory serves all G heads
//     (GQA: six for Qwen2) -- in decode (sq = 1) a block serves the whole
//     group and every KV byte is read once;
//   * the 64-row Q tile is staged once, transposed, as fp32 in shared memory;
//     each 64-key K/V tile is loaded with 16-byte vector loads and widened
//     to fp32 in shared memory (bf16 or fp32 inputs, fp32 arithmetic);
//   * warp w owns rows 16w..16w+15 and lane j keys j and j+32 of the tile:
//     scores by FFMA, each row's max by warp shuffles, the row sum kept as
//     a per-lane partial (every lane rescales it by the same alpha) and
//     summed once at the end; P goes through shared memory and each lane
//     accumulates P.V for the head dims lane + 32t, t < DT = ceil(dh / 32);
//   * KV tiles at or past min(skv, length, the tile's last query position
//     + 1) are skipped: the reference computes them fully masked, which
//     changes neither m, l nor acc.
//
// What bounds it on the H100: decode (sq = 1) must read the cache once,
// B * Hk * length * dh * 2 (K and V) elements, and does 4 flops per element
// and query head, so bytes bound it; with one block per (KV head, batch row)
// only B * Hk blocks run, too few to pull the card's bandwidth (splitting
// the KV axis over blocks is later work). Causal prefill at Qwen2's 8 x 512
// does ~6.5 GFLOP per layer against ~34 MB, so at the bf16 tensor-core rate
// bytes still bound it, narrowly; this FFMA kernel runs at the fp32 rate,
// where the operations take ~15 times the bytes' time.
#include "gemm.cuh"

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 64;             // query rows per block
constexpr int kRW = kBQ / kWarps;   // rows per warp (16)
constexpr int kBK = 64;             // keys per KV tile (two per lane)
constexpr int kQP = kBQ + 4;        // row pitch of Qt / Pt: float4-aligned
constexpr int kLoadUnroll = 8;      // 16-byte loads in flight per thread
constexpr float kNegInf = -1e30f;

// Row pitch of the K tile: odd, so the 32 lanes reading one column of 32
// keys hit 32 banks.
__host__ __device__ __forceinline__ int k_pitch(int dh) { return dh | 1; }

// Widen the VEC elements of one 16-byte vector to fp32.
__device__ __forceinline__ void widen(const uint4& raw, float* out,
                                      float) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void widen(const uint4& raw, float* out,
                                      __nv_bfloat16) {
  const auto* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int e = 0; e < 8; ++e) out[e] = __bfloat162float(h[e]);
}

template <typename T, int DT>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ Q, const T* __restrict__ K,
                 const T* __restrict__ V, const int* __restrict__ lengths,
                 T* __restrict__ O, int h, int hk, int sq, int skv, int dh,
                 int causal, float scale, int64_t qsb, int64_t qsh,
                 int64_t qss, int64_t ksb, int64_t ksh, int64_t kss,
                 int64_t vsb, int64_t vsh, int64_t vss, int64_t osb,
                 int64_t osh, int64_t oss) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VP = DT * 32;  // V tile pitch: the head dims a lane covers
  extern __shared__ __align__(16) float smem[];
  const int KP = k_pitch(dh);
  float* Qt = smem;                   // [dh][kQP]
  float* Ks = Qt + dh * kQP;          // [kBK][KP]
  float* Vs = Ks + kBK * KP;          // [kBK][VP]
  float* Pt = Vs + kBK * VP;          // [kBK][kQP]

  const int G = h / hk;
  const int rows = G * sq;
  const int r0 = blockIdx.x * kBQ;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int len = lengths[b];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // Q tile, transposed: Qt[d][r] for the block's rows (zero past `rows`).
  for (int idx = threadIdx.x; idx < kBQ * dh; idx += kThreads) {
    const int r = idx / dh, d = idx - r * dh;
    const int gr = r0 + r;
    float val = 0.f;
    if (gr < rows) {
      const int i = gr / G, g = gr - i * G;
      val = gredo::to_f32(Q[b * qsb + (kh * G + g) * qsh + i * qss + d]);
    }
    Qt[d * kQP + r] = val;
  }
  // The V tile's columns past dh are read by the P.V loop and never written.
  for (int idx = threadIdx.x; idx < kBK * (VP - dh); idx += kThreads) {
    const int j = idx / (VP - dh);
    Vs[j * VP + dh + idx - j * (VP - dh)] = 0.f;
  }

  const int last_r = min(r0 + kBQ, rows) - 1;
  int kv_end = min(skv, len);
  if (causal) kv_end = min(kv_end, len - sq + last_r / G + 1);

  // Per-row state of this warp's rows (row rr is r0 + 16 * warp + rr).
  float m[kRW], l[kRW], acc[kRW][DT];
#pragma unroll
  for (int rr = 0; rr < kRW; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int t = 0; t < DT; ++t) acc[rr][t] = 0.f;
  }

  const T* Kb = K + b * ksb + kh * ksh;
  const T* Vb = V + b * vsb + kh * vsh;
  const int vpr = dh / VEC;  // 16-byte vectors per row
  const int nvec = kBK * vpr;

  for (int kt = 0; kt < kv_end; kt += kBK) {
    __syncthreads();  // Q staged / the previous tile fully consumed
    for (int base = 0; base < nvec; base += kThreads * kLoadUnroll) {
      uint4 kr[kLoadUnroll], vr[kLoadUnroll];
#pragma unroll
      for (int u = 0; u < kLoadUnroll; ++u) {
        const int idx = base + u * kThreads + threadIdx.x;
        kr[u] = vr[u] = make_uint4(0, 0, 0, 0);
        if (idx < nvec) {
          const int j = idx / vpr, c = idx - j * vpr;
          const int key = kt + j;
          if (key < kv_end) {
            kr[u] = *reinterpret_cast<const uint4*>(Kb + key * kss + c * VEC);
            vr[u] = *reinterpret_cast<const uint4*>(Vb + key * vss + c * VEC);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kLoadUnroll; ++u) {
        const int idx = base + u * kThreads + threadIdx.x;
        if (idx < nvec) {
          const int j = idx / vpr, c = idx - j * vpr;
          float kf[VEC], vf[VEC];
          widen(kr[u], kf, T{});
          widen(vr[u], vf, T{});
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            Ks[j * KP + c * VEC + e] = kf[e];
            Vs[j * VP + c * VEC + e] = vf[e];
          }
        }
      }
    }
    __syncthreads();

    // Scores of this warp's rows against keys kt + lane and kt + lane + 32.
    float s[kRW][2];
#pragma unroll
    for (int rr = 0; rr < kRW; ++rr) s[rr][0] = s[rr][1] = 0.f;
    const float* k0p = Ks + lane * KP;
    const float* k1p = Ks + (lane + 32) * KP;
    for (int d = 0; d < dh; ++d) {
      const float k0 = k0p[d], k1 = k1p[d];
      const float4* qp =
          reinterpret_cast<const float4*>(Qt + d * kQP + warp * kRW);
#pragma unroll
      for (int c = 0; c < kRW / 4; ++c) {
        const float4 qv = qp[c];
        s[4 * c + 0][0] = fmaf(qv.x, k0, s[4 * c + 0][0]);
        s[4 * c + 0][1] = fmaf(qv.x, k1, s[4 * c + 0][1]);
        s[4 * c + 1][0] = fmaf(qv.y, k0, s[4 * c + 1][0]);
        s[4 * c + 1][1] = fmaf(qv.y, k1, s[4 * c + 1][1]);
        s[4 * c + 2][0] = fmaf(qv.z, k0, s[4 * c + 2][0]);
        s[4 * c + 2][1] = fmaf(qv.z, k1, s[4 * c + 2][1]);
        s[4 * c + 3][0] = fmaf(qv.w, k0, s[4 * c + 3][0]);
        s[4 * c + 3][1] = fmaf(qv.w, k1, s[4 * c + 3][1]);
      }
    }

    // Online softmax: s becomes p; m, l and acc are rescaled.
#pragma unroll
    for (int rr = 0; rr < kRW; ++rr) {
      const int gr = r0 + warp * kRW + rr;
      const int qpos = len - sq + gr / G;
      bool ok[2];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = kt + lane + 32 * c;
        ok[c] = gr < rows && key < kv_end && (!causal || qpos >= key);
        s[rr][c] = ok[c] ? s[rr][c] * scale : kNegInf;
        mx = fmaxf(mx, s[rr][c]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[rr], mx);
      const float alpha = expf(m[rr] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        s[rr][c] = ok[c] ? expf(s[rr][c] - m_new) : 0.f;
        psum += s[rr][c];
      }
      l[rr] = alpha * l[rr] + psum;
      m[rr] = m_new;
#pragma unroll
      for (int t = 0; t < DT; ++t) acc[rr][t] *= alpha;
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float4* pp = reinterpret_cast<float4*>(Pt + (lane + 32 * c) * kQP +
                                             warp * kRW);
#pragma unroll
      for (int q4 = 0; q4 < kRW / 4; ++q4)
        pp[q4] = make_float4(s[4 * q4][c], s[4 * q4 + 1][c],
                             s[4 * q4 + 2][c], s[4 * q4 + 3][c]);
    }
    __syncwarp();

    // acc += P . V over the tile's live keys (a warp reads only its rows).
    const int jmax = min(kBK, kv_end - kt);
    for (int j = 0; j < jmax; ++j) {
      float vv[DT];
#pragma unroll
      for (int t = 0; t < DT; ++t) vv[t] = Vs[j * VP + lane + 32 * t];
      const float4* pp =
          reinterpret_cast<const float4*>(Pt + j * kQP + warp * kRW);
#pragma unroll
      for (int q4 = 0; q4 < kRW / 4; ++q4) {
        const float4 pv = pp[q4];
#pragma unroll
        for (int t = 0; t < DT; ++t) {
          acc[4 * q4 + 0][t] = fmaf(pv.x, vv[t], acc[4 * q4 + 0][t]);
          acc[4 * q4 + 1][t] = fmaf(pv.y, vv[t], acc[4 * q4 + 1][t]);
          acc[4 * q4 + 2][t] = fmaf(pv.z, vv[t], acc[4 * q4 + 2][t]);
          acc[4 * q4 + 3][t] = fmaf(pv.w, vv[t], acc[4 * q4 + 3][t]);
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRW; ++rr) {
    float lt = l[rr];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, o);
    const int gr = r0 + warp * kRW + rr;
    if (gr >= rows) continue;
    const int i = gr / G, g = gr - i * G;
    const float denom = lt == 0.f ? 1.f : lt;
    T* orow = O + b * osb + (kh * G + g) * osh + i * oss;
#pragma unroll
    for (int t = 0; t < DT; ++t) {
      const int d = lane + 32 * t;
      if (d < dh) orow[d] = gredo::from_f32<T>(acc[rr][t] / denom);
    }
  }
}

template <typename T, int DT>
int launch_flash(const void* q, const void* k, const void* v,
                 const void* lengths, void* o, int b, int h, int hk, int sq,
                 int skv, int dh, int causal, float scale,
                 const int64_t (&st)[12], cudaStream_t stream) {
  const int rows = (h / hk) * sq;
  const dim3 grid((rows + kBQ - 1) / kBQ, hk, b);
  const size_t smem =
      sizeof(float) * (dh * kQP + kBK * k_pitch(dh) + kBK * DT * 32 +
                       kBK * kQP);
  auto kernel = flash_kernel<T, DT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lengths),
      static_cast<T*>(o), h, hk, sq, skv, dh, causal, scale, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11]);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (b, h, sq, dh), k/v (b, hk, skv, dh), o like q, each addressed by its
// (batch, head, position) strides in elements with a contiguous last dim;
// lengths (b,) int32. dh <= 128 and a multiple of 16 / sizeof(element), and
// k/v rows 16-byte aligned (the wrapper checks).
#define GREDO_FLASH_ENTRY(NAME, T)                                            \
  int NAME(const void* q, const void* k, const void* v, const void* lengths, \
           void* o, int b, int h, int hk, int sq, int skv, int dh,           \
           int causal, float scale, int64_t qsb, int64_t qsh, int64_t qss,   \
           int64_t ksb, int64_t ksh, int64_t kss, int64_t vsb, int64_t vsh,  \
           int64_t vss, int64_t osb, int64_t osh, int64_t oss,               \
           void* stream) {                                                   \
    const int64_t st[12] = {qsb, qsh, qss, ksb, ksh, kss,                    \
                            vsb, vsh, vss, osb, osh, oss};                   \
    auto s = static_cast<cudaStream_t>(stream);                              \
    if (dh <= 32)                                                            \
      return launch_flash<T, 1>(q, k, v, lengths, o, b, h, hk, sq, skv, dh,  \
                                causal, scale, st, s);                       \
    if (dh <= 64)                                                            \
      return launch_flash<T, 2>(q, k, v, lengths, o, b, h, hk, sq, skv, dh,  \
                                causal, scale, st, s);                       \
    if (dh <= 96)                                                            \
      return launch_flash<T, 3>(q, k, v, lengths, o, b, h, hk, sq, skv, dh,  \
                                causal, scale, st, s);                       \
    return launch_flash<T, 4>(q, k, v, lengths, o, b, h, hk, sq, skv, dh,    \
                              causal, scale, st, s);                         \
  }

GREDO_FLASH_ENTRY(gredo_flash_f32, float)
GREDO_FLASH_ENTRY(gredo_flash_bf16, __nv_bfloat16)

#undef GREDO_FLASH_ENTRY

}  // extern "C"
