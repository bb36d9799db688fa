// EmbeddingBag: out[i, :] = sum_j w[i, j] * table[idx[i, j], :] in fp32, for
// a (V, D) table in fp32, bf16 or fp16 and (n_bags, bag) int32 indices; the
// weights are fp32 or of the table's type (w = null weighs every valid slot
// 1); the output is fp32.
//
// Replaces the Pallas kernel `embedding_bag` (src/repro/kernels/
// embedding_bag/embedding_bag.py, body `_bag_kernel`). That kernel
// scalar-prefetches the indices so that its table BlockSpec can fetch one
// (1, D) row per grid step (i, j), casts the row to fp32 and adds w * row
// into the output block across the sequential j axis. The semantics kept
// here: each row is converted to fp32 in registers and summed in fp32; a
// weight keeps its own rounding (a bf16 weight is read as bf16, widened and
// multiplied in fp32, as JAX promotes it); an index of -1 is padding, and
// the padded slot still reads row 0 and multiplies it by weight w * 0 (0
// when unweighted), so a NaN or inf in row 0, or in a padded slot's weight,
// gives NaN as the reference does. The row is one row, hot in L2, so the
// read costs nothing that matters. An index >= V is the caller's error (the
// plain version raises on it); the kernel clamps it to V - 1 so that it
// never reads outside the table.
//
// What bounds it on the H100: bytes. A bag is a gather and a sum, 2 flops
// per element read (about 0.25 flop per byte, far below the ~295 where the
// tensor cores would start to matter; wgmma has nothing to multiply, and
// Hopper's TMA has no row gather). The least time is the distinct rows
// read once, the indices, weights and output once, at 3.35 TB/s. What
// reaches it is memory parallelism: about 0.7 us of latency at 3.35 TB/s
// asks for ~2.3 MB of reads in flight on the card, ~18 KB per SM.
//
// Design (the launch plan comes from the wrapper, `embedding_bag.plan`):
//   * 16-byte read-only loads (4 fp32 or 8 bf16/fp16 values a lane) when
//     D * sizeof(T) is a multiple of 16 and the table is 16-byte aligned,
//     else a scalar path (VEC = 1: 4 single values a lane, `lanes` apart);
//   * `lanes` lanes per bag, a power of two covering D / kCols (VEC, or
//     4), at most 32, so narrow rows share a warp (fp32: 8 lanes and 4
//     bags a warp at D = 32, 16 and 2 at D = 64, one bag a warp at
//     D = 128); a wider row loops over column chunks of 32 * kCols;
//   * ids and weights: each lane of a bag loads one slot (a coalesced load
//     of `lanes` slots per round, issued a round ahead), clamps the id and
//     forms its weight, and the bag's lanes take them from each other by
//     __shfl_sync, so a row load waits on no index load of its own;
//   * 4 row loads a lane issued before any is summed, read-only (__ldg):
//     a warp holds 4 * 32 * 16 = 2 KB in flight on the 16-byte path. The
//     fp32 16-byte path fits 64 registers, so an SM holds 4 blocks of 256
//     threads (32 warps); the others take 80, so 3. On the H100 occupancy
//     beat depth: 8 or 16 loads a lane at 2 or 3 blocks an SM, and 4 at 5
//     or more blocks (spilling), were slower at both timed shapes;
//   * a block per group of 8 warps' worth of bags (up to 64 blocks per
//     SM, then a grid-stride loop), so the block scheduler balances bags
//     of uneven latency: one persistent wave was slower;
//   * few long bags (8 x 4096) split j over `splits` warps of a block;
//     their partials meet in shared memory and are summed in split order;
//   * the output goes out by streaming stores (__stcs): nothing reads it
//     again here.
// The order of every sum is fixed by the plan (j in order within a warp,
// splits in order), so a call gives the same bits every time; no atomics.
//
// Replaced: the port's first version, a warp per bag with 4-byte loads
// and lanes striding over 128 columns (half the lanes idle at D = 64),
// each lane loading every index and weight itself, n_bags / 8 blocks. At
// D = 128 it kept every lane busy and as many bytes in flight, and this
// design gains little there; its gains are narrow rows, few bags, 2-byte
// tables and misaligned or odd-width tables (PERF.md).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

// Element types by their raw bits: widen to fp32 in registers, one value
// or the two halves of a 32-bit word.
struct F32 {
  using raw = float;
  __device__ static float widen(raw x) { return x; }
};
struct BF16 {
  using raw = unsigned short;
  __device__ static float widen(raw x) {
    return __uint_as_float(static_cast<unsigned>(x) << 16);
  }
  __device__ static float2 widen2(unsigned x) {
    return make_float2(__uint_as_float(x << 16),
                       __uint_as_float(x & 0xffff0000u));
  }
};
struct F16 {
  using raw = unsigned short;
  __device__ static float widen(raw x) {
    return __half2float(__ushort_as_half(x));
  }
  __device__ static float2 widen2(unsigned x) {
    return make_float2(
        __half2float(__ushort_as_half(static_cast<unsigned short>(x))),
        __half2float(__ushort_as_half(static_cast<unsigned short>(x >> 16))));
  }
};

// The columns a lane sums (kCols) and how it reads them: VEC > 1, one
// 16-byte load of VEC adjacent values; VEC == 1 (a row that is not whole
// 16-byte chunks, or a misaligned table), 4 single values `lanes` apart,
// so that neighbouring lanes still read neighbouring addresses.
template <class T, int VEC>
struct Row {
  using raw = typename T::raw;
  static constexpr bool kVector = VEC > 1;
  static constexpr int kCols = kVector ? VEC : 4;
  // Row loads in flight per lane; and the blocks an SM must hold, which
  // caps the registers (64 a thread at 4 blocks, 85 at 3: the fp32
  // 16-byte path fits 64, the others spill there).
  static constexpr int kUnroll = 4;
  static constexpr int kMinBlocks = kVector && VEC == 4 ? 4 : 3;
  struct Scalars {
    raw v[4];
  };
  using chunk = typename std::conditional<kVector, uint4, Scalars>::type;
  // The lane's columns inside the row from column `col` on: a whole chunk
  // or none on the vector path.
  __device__ static int columns(int D, int col, int lanes) {
    if constexpr (kVector) {
      return col < D ? kCols : 0;
    } else {
      return col < D ? min(kCols, (D - col + lanes - 1) / lanes) : 0;
    }
  }
  // n: columns(...) (the scalar path reads only those).
  __device__ static chunk load(const raw* p, int lanes, int n) {
    if constexpr (kVector) {
      return __ldg(reinterpret_cast<const uint4*>(p));
    } else {
      Scalars c;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        c.v[k] = k < n ? __ldg(p + k * lanes) : raw(0);
      return c;
    }
  }
  __device__ static void fma(const chunk& c, float wt,
                             float (&acc)[kCols]) {
    if constexpr (!kVector) {
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[k] = fmaf(wt, T::widen(c.v[k]), acc[k]);
    } else if constexpr (VEC == 4) {
      acc[0] = fmaf(wt, __uint_as_float(c.x), acc[0]);
      acc[1] = fmaf(wt, __uint_as_float(c.y), acc[1]);
      acc[2] = fmaf(wt, __uint_as_float(c.z), acc[2]);
      acc[3] = fmaf(wt, __uint_as_float(c.w), acc[3]);
    } else {
      const unsigned words[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 v = T::widen2(words[k]);
        acc[2 * k] = fmaf(wt, v.x, acc[2 * k]);
        acc[2 * k + 1] = fmaf(wt, v.y, acc[2 * k + 1]);
      }
    }
  }
  __device__ static void store(float* o, const float (&acc)[kCols],
                               int lanes, int n) {
    if constexpr (!kVector) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (k < n) __stcs(o + k * lanes, acc[k]);
    } else {
#pragma unroll
      for (int k = 0; k < VEC; k += 4)
        __stcs(reinterpret_cast<float4*>(o + k),
               make_float4(acc[k], acc[k + 1], acc[k + 2], acc[k + 3]));
    }
  }
};

// T: the table's element type; W: the weights' (F32 or T); VEC: values a
// lane reads per row load (Row). lanes (a power of two) lanes per bag,
// 32 / lanes bags per warp; splits (1, 2, 4 or 8) warps per group of bags,
// each over a slice of j.
template <class T, class W, int VEC>
__global__ void __launch_bounds__(kThreads, (Row<T, VEC>::kMinBlocks))
    embedding_bag_kernel(const typename T::raw* __restrict__ table,
                         const int* __restrict__ idx,
                         const typename W::raw* __restrict__ w,
                         float* __restrict__ out, int n_bags, int bag, int V,
                         int D, int lanes, int splits) {
  using R = Row<T, VEC>;
  constexpr int U = R::kUnroll;
  constexpr int C = R::kCols;
  __shared__ float part[kWarps][32][C];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int l = lane & (lanes - 1);           // lane within its bag
  const int per_warp = 32 / lanes;            // bags per warp
  const int slots = kWarps / splits;          // groups of bags per block
  const int slot = warp / splits;
  const int s = warp % splits;                // this warp's slice of j
  const int slice = (bag + splits - 1) / splits;
  const int jlo = min(bag, s * slice);
  const int jhi = min(bag, jlo + slice);
  const int n_groups = (n_bags + per_warp - 1) / per_warp;
  const int width = lanes * C;                // columns of one chunk
  for (int g0 = blockIdx.x * slots; g0 < n_groups; g0 += gridDim.x * slots) {
    const int i = (g0 + slot) * per_warp + lane / lanes;
    const bool live = i < n_bags;
    const int* ib = idx + static_cast<size_t>(live ? i : 0) * bag;
    const typename W::raw* wb =
        w ? w + static_cast<size_t>(live ? i : 0) * bag : nullptr;
    for (int c0 = 0; c0 < D; c0 += width) {
      const int col = c0 + (R::kVector ? l * VEC : l);
      const int ncols = live ? R::columns(D, col, lanes) : 0;
      const bool on = ncols > 0;
      const typename T::raw* tcol = table + (on ? col : 0);
      float acc[C];
#pragma unroll
      for (int k = 0; k < C; ++k) acc[k] = 0.f;
      // this lane's slot of the next round, loaded a round ahead
      int next_id = 0;
      float next_w = 0.f;
      if (live && l < jhi - jlo) {
        next_id = __ldg(ib + jlo + l);
        next_w = wb ? W::widen(__ldg(wb + jlo + l)) : 1.f;
      }
      for (int j0 = jlo; j0 < jhi; j0 += lanes) {
        const int n = min(lanes, jhi - j0);   // the same in every bag
        const int row = min(max(next_id, 0), V - 1);
        const float wt = l < n ? next_w * (next_id >= 0 ? 1.f : 0.f) : 0.f;
        if (live && l < jhi - j0 - lanes) {
          next_id = __ldg(ib + j0 + lanes + l);
          next_w = wb ? W::widen(__ldg(wb + j0 + lanes + l)) : 1.f;
        }
        for (int u0 = 0; u0 < n; u0 += U) {
          typename R::chunk c[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int r = __shfl_sync(kFull, row, (u0 + u) & (lanes - 1),
                                      lanes);
            if (on && u0 + u < n)
              c[u] = R::load(tcol + static_cast<size_t>(r) * D, lanes,
                             ncols);
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const float wu = __shfl_sync(kFull, wt, (u0 + u) & (lanes - 1),
                                         lanes);
            if (on && u0 + u < n) R::fma(c[u], wu, acc);
          }
        }
      }
      if (splits > 1) {                       // block-uniform
#pragma unroll
        for (int k = 0; k < C; ++k) part[warp][lane][k] = acc[k];
        __syncthreads();
        if (s == 0) {
#pragma unroll
          for (int k = 0; k < C; ++k) acc[k] = part[warp][lane][k];
          for (int t = 1; t < splits; ++t) {
#pragma unroll
            for (int k = 0; k < C; ++k) acc[k] += part[warp + t][lane][k];
          }
        }
        __syncthreads();
      }
      if (on && s == 0)
        R::store(out + static_cast<size_t>(i) * D + col, acc, lanes, ncols);
    }
  }
}

template <class T, class W, int VEC>
int launch(const void* table, const void* idx, const void* w, void* out,
           int n_bags, int bag, int V, int D, int lanes, int splits,
           int blocks, cudaStream_t stream) {
  embedding_bag_kernel<T, W, VEC><<<blocks, kThreads, 0, stream>>>(
      static_cast<const typename T::raw*>(table),
      static_cast<const int*>(idx), static_cast<const typename W::raw*>(w),
      static_cast<float*>(out), n_bags, bag, V, D, lanes, splits);
  return cudaGetLastError();
}

template <class T, class W>
int launch_vec(int vec, const void* table, const void* idx, const void* w,
               void* out, int n_bags, int bag, int V, int D, int lanes,
               int splits, int blocks, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(typename T::raw);
  if (vec == kVec)
    return launch<T, W, kVec>(table, idx, w, out, n_bags, bag, V, D, lanes,
                              splits, blocks, stream);
  if (vec == 1)
    return launch<T, W, 1>(table, idx, w, out, n_bags, bag, V, D, lanes,
                           splits, blocks, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// table (V, D) of table_type (0 fp32, 1 bf16, 2 fp16), idx (n_bags, bag)
// int32, w (n_bags, bag) fp32 or of the table's type (weight_type 0 or
// table_type) or null, out (n_bags, D) fp32; all contiguous. vec, lanes,
// splits and blocks are the wrapper's plan; vec > 1 needs a 16-byte aligned
// table and D * element size a multiple of 16.
int gredo_embedding_bag(const void* table, const void* idx, const void* w,
                        void* out, int n_bags, int bag, int V, int D,
                        int table_type, int weight_type, int vec, int lanes,
                        int splits, int blocks, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool w_f32 = w == nullptr || weight_type == kF32;
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) ||
      splits < 1 || splits > kWarps || (splits & (splits - 1)) ||
      (!w_f32 && weight_type != table_type))
    return cudaErrorInvalidValue;
  switch (table_type) {
    case kF32:
      return launch_vec<F32, F32>(vec, table, idx, w, out, n_bags, bag, V, D,
                                  lanes, splits, blocks, st);
    case kBF16:
      return w_f32 ? launch_vec<BF16, F32>(vec, table, idx, w, out, n_bags,
                                           bag, V, D, lanes, splits, blocks,
                                           st)
                   : launch_vec<BF16, BF16>(vec, table, idx, w, out, n_bags,
                                            bag, V, D, lanes, splits, blocks,
                                            st);
    case kF16:
      return w_f32 ? launch_vec<F16, F32>(vec, table, idx, w, out, n_bags,
                                          bag, V, D, lanes, splits, blocks,
                                          st)
                   : launch_vec<F16, F16>(vec, table, idx, w, out, n_bags,
                                          bag, V, D, lanes, splits, blocks,
                                          st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
