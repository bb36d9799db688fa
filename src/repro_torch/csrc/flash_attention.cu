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
// accumulator in scratch memory; here one block loops over its KV tiles
// itself and keeps them in registers.
//
// Common to both kernels below:
//   * one 128-thread block per (row tile, KV head, batch row, KV split). The
//     rows of a KV head are its G query heads times sq positions, ordered
//     r = i * G + g, so one K/V tile read from memory serves all G heads
//     (GQA: six for Qwen2). Warp w owns the 16 rows 16w..16w+15 of the
//     block's 64;
//   * KV tiles at or past min(skv, length, the tile's last query position
//     + 1) are skipped: the reference computes them fully masked,
//     which changes neither m, l nor acc. Row tiles are issued last first,
//     so the causal tiles with the most keys start first;
//   * split-KV (flash-decoding): with S > 1 splits, block s walks only keys
//     [s * kv_split, (s + 1) * kv_split) and writes its unnormalised
//     partial (m, l, acc) in fp32 to a scratch tensor (a split wholly past
//     the length writes m = -1e30, l = 0, acc = 0); flash_combine_kernel
//     then merges the S partials of each row by the log-sum-exp rule. The
//     wrapper picks S from the shapes alone.
//
// What bounds each on the H100:
//   * prefill (Qwen2's 8 x 512 over 544 positions): ~7.3 GFLOP against
//     ~34 MB, so at the tensor cores' bf16 rate bytes bound it, narrowly
//     (8.8 us against 7.4 us of dense wgmma work, ~11 us of mma.sync
//     work). This kernel is held back by latency before either: each
//     warp's chain of ldmatrix, MMA, quad shuffles and MMA per tile is
//     hidden only by the other warps on its SM, so the blocks resident per
//     SM set its time (chip_smoke.py's prefill row on an H100: a first
//     layout, Q in registers and 64-key tiles, 174 registers and 2 blocks
//     per SM, took 0.0985 ms; the layout below fits 4). It runs Q.K^T and
//     P.V on the tensor cores with mma.sync m16n8k16 (bf16 in, fp32
//     accumulate), operands from ldmatrix, and streams K/V through a
//     two-stage cp.async ring so tile t+1 arrives while tile t is
//     computed. It uses mma.sync, not wgmma: wgmma wants 64-row warpgroup
//     tiles with shared-memory descriptors, and at these shapes the
//     pipeline and the occupancy limit the kernel long before the
//     instruction's rate does; wgmma is the step after this kernel reaches
//     its operation bound;
//   * decode (sq = 1): it must read the cache once, B * Hk * length * dh * 2
//     elements, so bytes bound it; with one block per (KV head, batch row)
//     only B * Hk = 16 blocks would run, too few to pull the card's
//     bandwidth. Splitting the KV axis gives >= 132 blocks when skv allows.
//
// bf16 kernel (flash_mma_kernel), per KV tile of 32 keys and warp:
//   * the Q tile stays in shared memory (copied by cp.async with the first
//     K/V tile) and its A fragments are read by ldmatrix per k-chunk:
//     registers, not the 52 KB of shared memory, limit the blocks per SM;
//   * S = Q K^T: K's B fragments come from the shared tile by ldmatrix
//     (row pitch dh + 8 elements, so the 8 rows of each 8x8 matrix hit
//     distinct banks);
//   * the online softmax runs on the accumulator fragments: each thread
//     holds 2 rows x 8 keys, row max and sum by quad shuffles (the sum as a
//     per-thread partial, reduced once at the end), exp2 with log2(e) folded
//     into the scale. Tiles wholly inside every row's causal limit and the
//     key range skip the mask;
//   * P goes from registers straight into the A fragments of P.V, with no
//     trip through shared memory. _flash_kernel keeps P in fp32; one bf16
//     rounding of P costs the flash-vs-dense logit check its headroom, so P
//     is split as P_hi = bf16(P), P_lo = bf16(P - P_hi) and both go through
//     the MMA into the same fp32 accumulator (about 16 bits of P); V comes
//     from ldmatrix.trans. Q.K^T needs no such care: bf16 x bf16 products
//     are exact in fp32;
//   * the head dim is zero-padded in shared memory to the instantiated
//     width (64, 96 or 128), so multiples of 8 that are not multiples of
//     16 are taken too.
// fp32 kernel (flash_kernel): FFMA at the fp32 rate (TF32 would break the
// 3e-4 / 3e-5 tolerance): the Q tile transposed and the K/V tile widened in
// shared memory, lane j owning keys j and j + 32 of a tile, P through
// shared memory, each lane accumulating P.V for head dims lane + 32t.
#include "gemm.cuh"

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 64;             // query rows per block
constexpr int kRW = kBQ / kWarps;   // rows per warp (16)
constexpr int kBK = 64;             // keys per KV tile (fp32 kernel)
constexpr int kNK = 32;             // keys per KV tile (bf16 kernel)
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  void* o;
  float* part;  // S partials (m, l, acc) when splits > 1
  int b, h, hk, sq, skv, dh, causal, splits, kv_split, q_vec;
  float scale;
  int64_t qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss;
};

// The block's place: first packed row, KV head, batch row, split, and the
// keys [lo, hi) it walks.
struct Block {
  int r0, kh, b, split, len, lo, hi;
};

__device__ __forceinline__ Block block_of(const FlashArgs& a, int rows,
                                          int G) {
  const int n_rt = (rows + kBQ - 1) / kBQ;
  const int split = blockIdx.x / n_rt;
  const int rt = n_rt - 1 - (blockIdx.x - split * n_rt);
  Block blk;
  blk.r0 = rt * kBQ;
  blk.kh = blockIdx.y;
  blk.b = blockIdx.z;
  blk.split = split;
  blk.len = a.lengths[blk.b];
  int hi = min(a.skv, blk.len);
  if (a.causal)
    hi = min(hi, blk.len - a.sq + (min(blk.r0 + kBQ, rows) - 1) / G + 1);
  blk.lo = split * a.kv_split;
  blk.hi = min(hi, blk.lo + a.kv_split);
  return blk;
}

// Scratch layout for NR = b * hk * rows packed rows and S splits: m[S][NR],
// l[S][NR], acc[S][NR][dh]; packed row R = (b * hk + kh) * rows + r.
__device__ __forceinline__ int64_t part_row(const FlashArgs& a, int rows,
                                            const Block& blk, int r) {
  const int64_t nr = (int64_t)a.b * a.hk * rows;
  return blk.split * nr + ((int64_t)blk.b * a.hk + blk.kh) * rows + r;
}

template <typename T>
__device__ __forceinline__ T* out_row(const FlashArgs& a, int G, int b,
                                      int kh, int r) {
  const int i = r / G, g = r - i * G;
  return static_cast<T*>(a.o) + b * a.osb + (kh * G + g) * a.osh +
         i * a.oss;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16), cp.async K/V ring
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !ok (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ldmatrix from a shared-memory byte address (32-bit, so a thread's
// fragment addresses cost one register each).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16x16, row) . b (16x8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) as two bf16 pairs whose sum keeps ~16 bits: hi = bf16(x, y),
// lo = bf16(x - hi, y - hi).
__device__ __forceinline__ void split_pack(uint32_t& hi, uint32_t& lo, float x,
                                           float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// DHP: the head dim padded to a multiple of 16 (the MMA's k and 2 n-tiles).
// Four blocks per SM at dh 128 (128 registers): occupancy is what this
// kernel's time follows. The narrower widths reach four blocks without
// the cap (at 96 the cap makes ptxas spill).
template <int DHP>
__global__ void __launch_bounds__(kThreads, DHP == 128 ? 4 : 1)
    flash_mma_kernel(const FlashArgs a) {
  constexpr int P = DHP + 8;    // shared row pitch in elements
  constexpr int CPR = DHP / 8;  // 16-byte chunks per row
  constexpr int KC = DHP / 16;  // k-chunks of Q.K^T
  constexpr int NT = DHP / 8;   // 8-wide n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [kBQ][P]
  bf16* Ks = Qs + kBQ * P;                       // [2][kNK][P]
  bf16* Vs = Ks + 2 * kNK * P;                   // [2][kNK][P]

  const int G = a.h / a.hk;
  const int rows = G * a.sq;
  const Block blk = block_of(a, rows, G);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bf16* Kb = static_cast<const bf16*>(a.k) + blk.b * a.ksb +
                   blk.kh * a.ksh;
  const bf16* Vb = static_cast<const bf16*>(a.v) + blk.b * a.vsb +
                   blk.kh * a.vsh;
  const int n_tiles = blk.hi > blk.lo ? (blk.hi - blk.lo + kNK - 1) / kNK : 0;

  auto load_kv = [&](int stage, int kt) {
    bf16* ks = Ks + stage * kNK * P;
    bf16* vs = Vs + stage * kNK * P;
    for (int idx = threadIdx.x; idx < kNK * CPR; idx += kThreads) {
      const int j = idx / CPR, c = idx - j * CPR;
      const int key = kt + j;
      const bool ok = key < blk.hi && c * 8 < a.dh;
      cp_async16(ks + j * P + c * 8, ok ? Kb + key * a.kss + c * 8 : Kb, ok);
      cp_async16(vs + j * P + c * 8, ok ? Vb + key * a.vss + c * 8 : Vb, ok);
    }
    cp_async_commit();
  };
  // The Q tile is copied with tile 0, in the same cp.async group, when
  // q's rows are 16-byte aligned (else by plain loads); a block with no
  // tile copies nothing.
  if (n_tiles > 0) {
    const bf16* Q = static_cast<const bf16*>(a.q);
    for (int idx = threadIdx.x; idx < kBQ * CPR; idx += kThreads) {
      const int r = idx / CPR, c = idx - r * CPR;
      const int gr = blk.r0 + r;
      const bool ok = gr < rows && c * 8 < a.dh;
      const bf16* src = Q;
      if (ok) {
        const int i = gr / G, g = gr - i * G;
        src = Q + blk.b * a.qsb + (blk.kh * G + g) * a.qsh + i * a.qss +
              c * 8;
      }
      if (a.q_vec) {
        cp_async16(Qs + r * P + c * 8, src, ok);
      } else {
        uint4 val = make_uint4(0, 0, 0, 0);
        if (ok) {
          const auto* e = reinterpret_cast<const unsigned short*>(src);
          val.x = e[0] | (unsigned)e[1] << 16;
          val.y = e[2] | (unsigned)e[3] << 16;
          val.z = e[4] | (unsigned)e[5] << 16;
          val.w = e[6] | (unsigned)e[7] << 16;
        }
        *reinterpret_cast<uint4*>(Qs + r * P + c * 8) = val;
      }
    }
    load_kv(0, blk.lo);   // commits Q's copies with tile 0's
  }
  // byte addresses of this lane's ldmatrix rows: Q (A operand), K (B,
  // rows are keys) and V (B through .trans, rows are keys)
  constexpr int kStage = kNK * P * 2;  // bytes per K or V stage
  const uint32_t q_addr =
      smem_addr(Qs) + ((warp * kRW + lane % 16) * P + (lane / 16) * 8) * 2;
  const uint32_t k_addr =
      smem_addr(Ks) +
      ((lane % 8 + (lane / 16) * 8) * P + ((lane / 8) % 2) * 8) * 2;
  const uint32_t v_addr =
      smem_addr(Vs) +
      ((lane % 8 + ((lane / 8) % 2) * 8) * P + (lane / 16) * 8) * 2;

  // This thread's rows (g8 and g8 + 8 of its warp's 16) and their state.
  const int g8 = lane / 4, t4 = lane % 4;
  const int row0 = blk.r0 + warp * kRW + g8;
  const int qpos0 = blk.len - a.sq + row0 / G;
  const int qpos1 = blk.len - a.sq + (row0 + 8) / G;
  const bool warp_live = blk.r0 + warp * kRW < rows;
  // keys below full_end are visible to every row of the block
  const int full_end =
      a.causal ? min(blk.hi, blk.len - a.sq + blk.r0 / G + 1) : blk.hi;
  const float sl2 = a.scale * kLog2e;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int kt = blk.lo + t * kNK;
    if (t + 1 < n_tiles) {
      load_kv((t + 1) & 1, kt + kNK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (warp_live) {
      const uint32_t ks = k_addr + (t & 1) * kStage;
      const uint32_t vs = v_addr + (t & 1) * kStage;
      // S = Q K^T: kNK / 8 n-tiles of 8 keys, 2 per ldmatrix.x4
      float s[kNK / 8][4];
#pragma unroll
      for (int nt = 0; nt < kNK / 8; ++nt)
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t qf[4];
        ldsm_x4(qf, q_addr + kc * 32);
#pragma unroll
        for (int np = 0; np < kNK / 16; ++np) {
          uint32_t kb[4];
          ldsm_x4(kb, ks + (np * 16 * P + kc * 16) * 2);
          mma_bf16(s[2 * np], qf, kb[0], kb[1]);
          mma_bf16(s[2 * np + 1], qf, kb[2], kb[3]);
        }
      }
      // scale (log2 domain), mask, row max over the quad
      const bool full = kt + kNK <= full_end;
      uint32_t ok = 0xffffffffu;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int nt = 0; nt < kNK / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[nt][e] * sl2;
          if (!full) {
            const int key = kt + nt * 8 + 2 * t4 + (e & 1);
            if (key >= blk.hi ||
                (a.causal && key > ((e >> 1) ? qpos1 : qpos0))) {
              x = kNegInf;
              ok &= ~(1u << (nt * 4 + e));
            }
          }
          s[nt][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float alpha[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
        const float m_new = fmaxf(m[hh], mx[hh]);
        alpha[hh] = exp2f(m[hh] - m_new);
        m[hh] = m_new;
      }
      float ps[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < kNK / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p =
              (ok >> (nt * 4 + e)) & 1u ? exp2f(s[nt][e] - m[e >> 1]) : 0.f;
          s[nt][e] = p;
          ps[e >> 1] += p;
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) l[hh] = alpha[hh] * l[hh] + ps[hh];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        acc[nt][0] *= alpha[0];
        acc[nt][1] *= alpha[0];
        acc[nt][2] *= alpha[1];
        acc[nt][3] *= alpha[1];
      }
      // acc += P . V: 4 k-chunks of 16 keys, P_hi and P_lo
#pragma unroll
      for (int kc = 0; kc < kNK / 16; ++kc) {
        uint32_t ph[4], pl[4];
        split_pack(ph[0], pl[0], s[2 * kc][0], s[2 * kc][1]);
        split_pack(ph[1], pl[1], s[2 * kc][2], s[2 * kc][3]);
        split_pack(ph[2], pl[2], s[2 * kc + 1][0], s[2 * kc + 1][1]);
        split_pack(ph[3], pl[3], s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
        for (int dp = 0; dp < NT / 2; ++dp) {
          uint32_t vb[4];
          ldsm_x4_t(vb, vs + (kc * 16 * P + dp * 16) * 2);
          mma_bf16(acc[2 * dp], ph, vb[0], vb[1]);
          mma_bf16(acc[2 * dp], pl, vb[0], vb[1]);
          mma_bf16(acc[2 * dp + 1], ph, vb[2], vb[3]);
          mma_bf16(acc[2 * dp + 1], pl, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();  // this stage is free for tile t + 2
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + 8 * hh;
    if (r >= rows) continue;
    if (a.splits == 1) {
      const float inv = 1.f / (l[hh] == 0.f ? 1.f : l[hh]);
      bf16* orow = out_row<bf16>(a, G, blk.b, blk.kh, r);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int d = nt * 8 + 2 * t4;
        if (d < a.dh)
          *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(
              acc[nt][2 * hh] * inv, acc[nt][2 * hh + 1] * inv);
      }
    } else {
      const int64_t pr = part_row(a, rows, blk, r);
      const int64_t nrs = (int64_t)a.splits * a.b * a.hk * rows;
      if (t4 == 0) {
        a.part[pr] = m[hh] * kLn2;        // natural-log units
        a.part[nrs + pr] = l[hh];
      }
      float* prow = a.part + 2 * nrs + pr * a.dh;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int d = nt * 8 + 2 * t4;
        if (d < a.dh)
          *reinterpret_cast<float2*>(prow + d) =
              make_float2(acc[nt][2 * hh], acc[nt][2 * hh + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: FFMA
// ---------------------------------------------------------------------------

constexpr int kQP = kBQ + 4;        // row pitch of Qt / Pt: float4-aligned
constexpr int kLoadUnroll = 8;      // 16-byte loads in flight per thread

// Row pitch of the K tile: odd, so the 32 lanes reading one column of 32
// keys hit 32 banks.
__host__ __device__ __forceinline__ int k_pitch(int dh) { return dh | 1; }

template <int DT>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const FlashArgs a) {
  constexpr int VEC = 4;
  constexpr int VP = DT * 32;  // V tile pitch: the head dims a lane covers
  extern __shared__ __align__(16) float smem[];
  const int dh = a.dh;
  const int KP = k_pitch(dh);
  float* Qt = smem;                   // [dh][kQP]
  float* Ks = Qt + dh * kQP;          // [kBK][KP]
  float* Vs = Ks + kBK * KP;          // [kBK][VP]
  float* Pt = Vs + kBK * VP;          // [kBK][kQP]

  const int G = a.h / a.hk;
  const int rows = G * a.sq;
  const Block blk = block_of(a, rows, G);
  const int r0 = blk.r0, kh = blk.kh, b = blk.b, len = blk.len;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* Q = static_cast<const float*>(a.q);

  // Q tile, transposed: Qt[d][r] for the block's rows (zero past `rows`).
  for (int idx = threadIdx.x; idx < kBQ * dh; idx += kThreads) {
    const int r = idx / dh, d = idx - r * dh;
    const int gr = r0 + r;
    float val = 0.f;
    if (gr < rows) {
      const int i = gr / G, g = gr - i * G;
      val = Q[b * a.qsb + (kh * G + g) * a.qsh + i * a.qss + d];
    }
    Qt[d * kQP + r] = val;
  }
  // The V tile's columns past dh are read by the P.V loop and never written.
  for (int idx = threadIdx.x; idx < kBK * (VP - dh); idx += kThreads) {
    const int j = idx / (VP - dh);
    Vs[j * VP + dh + idx - j * (VP - dh)] = 0.f;
  }

  // Per-row state of this warp's rows (row rr is r0 + 16 * warp + rr).
  float m[kRW], l[kRW], acc[kRW][DT];
#pragma unroll
  for (int rr = 0; rr < kRW; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int t = 0; t < DT; ++t) acc[rr][t] = 0.f;
  }

  const float* Kb = static_cast<const float*>(a.k) + b * a.ksb + kh * a.ksh;
  const float* Vb = static_cast<const float*>(a.v) + b * a.vsb + kh * a.vsh;
  const int vpr = dh / VEC;  // 16-byte vectors per row
  const int nvec = kBK * vpr;

  for (int kt = blk.lo; kt < blk.hi; kt += kBK) {
    __syncthreads();  // Q staged / the previous tile fully consumed
    for (int base = 0; base < nvec; base += kThreads * kLoadUnroll) {
      float4 kr[kLoadUnroll], vr[kLoadUnroll];
#pragma unroll
      for (int u = 0; u < kLoadUnroll; ++u) {
        const int idx = base + u * kThreads + threadIdx.x;
        kr[u] = vr[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (idx < nvec) {
          const int j = idx / vpr, c = idx - j * vpr;
          const int key = kt + j;
          if (key < blk.hi) {
            kr[u] = *reinterpret_cast<const float4*>(Kb + key * a.kss + c * VEC);
            vr[u] = *reinterpret_cast<const float4*>(Vb + key * a.vss + c * VEC);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kLoadUnroll; ++u) {
        const int idx = base + u * kThreads + threadIdx.x;
        if (idx < nvec) {
          const int j = idx / vpr, c = idx - j * vpr;
          float* kd = Ks + j * KP + c * VEC;
          float* vd = Vs + j * VP + c * VEC;
          kd[0] = kr[u].x; kd[1] = kr[u].y; kd[2] = kr[u].z; kd[3] = kr[u].w;
          vd[0] = vr[u].x; vd[1] = vr[u].y; vd[2] = vr[u].z; vd[3] = vr[u].w;
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
      const int qpos = len - a.sq + gr / G;
      bool ok[2];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = kt + lane + 32 * c;
        ok[c] = gr < rows && key < blk.hi && (!a.causal || qpos >= key);
        s[rr][c] = ok[c] ? s[rr][c] * a.scale : kNegInf;
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
    const int jmax = min(kBK, blk.hi - kt);
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
    if (a.splits == 1) {
      const float denom = lt == 0.f ? 1.f : lt;
      float* orow = out_row<float>(a, G, b, kh, gr);
#pragma unroll
      for (int t = 0; t < DT; ++t) {
        const int d = lane + 32 * t;
        if (d < dh) orow[d] = acc[rr][t] / denom;
      }
    } else {
      const int64_t pr = part_row(a, rows, blk, gr);
      const int64_t nrs = (int64_t)a.splits * a.b * a.hk * rows;
      if (lane == 0) {
        a.part[pr] = m[rr];
        a.part[nrs + pr] = lt;
      }
      float* prow = a.part + 2 * nrs + pr * dh;
#pragma unroll
      for (int t = 0; t < DT; ++t) {
        const int d = lane + 32 * t;
        if (d < dh) prow[d] = acc[rr][t];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The combine of split partials (both dtypes): one warp per packed row
// ---------------------------------------------------------------------------

constexpr int kCombineThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
    flash_combine_kernel(const FlashArgs a) {
  const int G = a.h / a.hk;
  const int rows = G * a.sq;
  const int64_t nr = (int64_t)a.b * a.hk * rows;
  const int64_t R = (int64_t)blockIdx.x * (kCombineThreads / 32) +
                    threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (R >= nr) return;  // uniform per warp
  const int64_t nrs = a.splits * nr;
  const float* pm = a.part;
  const float* pl = a.part + nrs;
  const float* pa = a.part + 2 * nrs;
  float mx = kNegInf;
  for (int s = 0; s < a.splits; ++s) mx = fmaxf(mx, pm[s * nr + R]);
  float l = 0.f, o[4] = {0.f, 0.f, 0.f, 0.f};
  for (int s = 0; s < a.splits; ++s) {
    const int64_t sr = s * nr + R;
    const float w = expf(pm[sr] - mx);
    l += w * pl[sr];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int d = lane + 32 * t;
      if (d < a.dh) o[t] += w * pa[sr * a.dh + d];
    }
  }
  const float inv = 1.f / (l == 0.f ? 1.f : l);
  const int r = static_cast<int>(R % rows);
  const int64_t bh = R / rows;
  T* orow = out_row<T>(a, G, static_cast<int>(bh / a.hk),
                       static_cast<int>(bh % a.hk), r);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int d = lane + 32 * t;
    if (d < a.dh) orow[d] = gredo::from_f32<T>(o[t] * inv);
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t launch_main(Kernel kernel, const FlashArgs& a, size_t smem,
                        cudaStream_t stream) {
  const int rows = (a.h / a.hk) * a.sq;
  const dim3 grid(((rows + kBQ - 1) / kBQ) * a.splits, a.hk, a.b);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int DHP>
cudaError_t launch_mma(const FlashArgs& a, cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * (kBQ + 4 * kNK) * (DHP + 8);
  return launch_main(flash_mma_kernel<DHP>, a, smem, stream);
}

template <int DT>
cudaError_t launch_ffma(const FlashArgs& a, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (a.dh * kQP + kBK * k_pitch(a.dh) + kBK * DT * 32 +
                       kBK * kQP);
  return launch_main(flash_kernel<DT>, a, smem, stream);
}

template <typename T>
cudaError_t launch_combine(const FlashArgs& a, cudaStream_t stream) {
  const int64_t nr = (int64_t)a.b * a.hk * (a.h / a.hk) * a.sq;
  const int per_block = kCombineThreads / 32;
  const unsigned blocks = static_cast<unsigned>((nr + per_block - 1) /
                                                per_block);
  flash_combine_kernel<T><<<blocks, kCombineThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const FlashArgs& a, cudaStream_t s) {
  if (a.dh <= 64) return launch_mma<64>(a, s);
  if (a.dh <= 96) return launch_mma<96>(a, s);
  return launch_mma<128>(a, s);
}

cudaError_t launch_f32(const FlashArgs& a, cudaStream_t s) {
  if (a.dh <= 32) return launch_ffma<1>(a, s);
  if (a.dh <= 64) return launch_ffma<2>(a, s);
  if (a.dh <= 96) return launch_ffma<3>(a, s);
  return launch_ffma<4>(a, s);
}

}  // namespace

extern "C" {

// q (b, h, sq, dh), k/v (b, hk, skv, dh), o like q, each addressed by its
// (batch, head, position) strides in elements with a contiguous last dim;
// lengths (b,) int32. dh <= 128 and a multiple of 16 / sizeof(element), and
// k/v rows 16-byte aligned (the wrapper checks). With splits > 1, part is
// fp32 scratch of splits * b * h * sq * (dh + 2) elements and blocks walk
// kv_split keys each; a second kernel combines the partials into o.
#define GREDO_FLASH_ENTRY(NAME, T, LAUNCH)                                    \
  int NAME(const void* q, const void* k, const void* v, const void* lengths, \
           void* o, void* part, int b, int h, int hk, int sq, int skv,       \
           int dh, int causal, int splits, int kv_split, float scale,        \
           int64_t qsb, int64_t qsh, int64_t qss, int64_t ksb, int64_t ksh,  \
           int64_t kss, int64_t vsb, int64_t vsh, int64_t vss, int64_t osb,  \
           int64_t osh, int64_t oss, void* stream) {                         \
    FlashArgs a{q, k, v, static_cast<const int*>(lengths), o,                 \
                static_cast<float*>(part), b, h, hk, sq, skv, dh, causal,     \
                splits, kv_split, 0, scale, qsb, qsh, qss, ksb, ksh, kss,     \
                vsb, vsh, vss, osb, osh, oss};                                \
    a.q_vec = reinterpret_cast<uintptr_t>(q) % 16 == 0 &&                     \
              (qsb * sizeof(T)) % 16 == 0 && (qsh * sizeof(T)) % 16 == 0 &&   \
              (qss * sizeof(T)) % 16 == 0;                                    \
    auto s = static_cast<cudaStream_t>(stream);                               \
    cudaError_t err = LAUNCH(a, s);                                           \
    if (err != cudaSuccess || splits == 1) return err;                        \
    return launch_combine<T>(a, s);                                           \
  }

GREDO_FLASH_ENTRY(gredo_flash_f32, float, launch_f32)
GREDO_FLASH_ENTRY(gredo_flash_bf16, __nv_bfloat16, launch_bf16)

#undef GREDO_FLASH_ENTRY

}  // extern "C"
