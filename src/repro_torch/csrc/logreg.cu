// REGRESSION inner loop: grad = X^T (sigmoid(X w) - y) / n and the mean
// logistic loss softplus(z) - y z, for X (n, d) fp32 row-major.
//
// Replaces the Pallas kernel `logreg_grad` (src/repro/kernels/logreg/
// logreg.py, body `_logreg_kernel`). That kernel carries the (d,) gradient
// and the loss in scratch memory across a sequential grid of row blocks.
// GPU blocks run in no fixed order, so here each block writes a (d + 1)
// partial and takes a ticket of an integer counter: the last block of each
// group of blocks sums its group's partials in block order, and the last
// group sums the group partials in group order (one group where all the
// partials are few). One launch, no fp32 atomics, the same bits on every
// call.
//
// What bounds it on the H100: latency, not bytes. One call must read X
// once (n*d*4 bytes: 12.7 MB for A1's 15910 x 200, 0.9 MB for the 58k x 4
// shard regression), about 4 us at 3.35 TB/s from device memory and less
// from the 50 MB L2, where X stays across the iterations of a regression
// loop. But the cross-block sum is a chain of memory round trips (a fence,
// a ticket, the group's partials, again for the groups), each near a
// microsecond, on top of the launch.
//
// Design:
//   * the wrapper picks the row tile from the shape (`rows`): at least two
//     blocks per SM, fewer rows where a tile of d-wide rows would not fit
//     the shared-memory budget;
//   * each block copies its tile (one contiguous span of rows*d floats), w
//     and its rows of y into shared memory with cp.async: 16-byte copies
//     when the tile's global address is 16-byte aligned (the wrapper cannot
//     assume it: a contiguous view may start anywhere), 4-byte copies
//     otherwise. X is read from device memory once; the gradient re-reads
//     shared memory;
//   * z = <x_r, w> runs on `lanes` lanes per row (a power of two chosen so
//     the tile's rows take one or two passes: 1 at d = 4, 4 at A1), with
//     a shuffle tree across them; then a thread per row computes
//     sigmoid(z) - y and the stable softplus max(z,0) + log1p(exp(-|z|))
//     - y z, so no lane waits on another row's exp and log;
//   * the column partials sum_r err_r x_r are spread over S row slices x
//     the columns, 16 loads in flight per thread and round, then a
//     fixed-order tree over the slices in shared memory; the loss is
//     summed apart by one warp; the reduction levels across blocks use the
//     same routine, so no thread waits on a long chain of dependent loads;
//   * a row wider than the shared-memory budget (d above ~50k) is read
//     from global memory in place (the unstaged instance).
//
// Tried on the card and dropped: the port's first version launched a
// partial pass with a warp per row (28 of 32 lanes idle at d = 4) and a
// 256-long dependent FMA chain per column, 63 blocks at A1, then a
// one-block reduce pass: two launches per call. In this design's
// bring-up: a single level (the last of 266 blocks summing all partials,
// a long chain of dependent loads per column), a warp per row whose first
// lane ran the exp and log of each row in turn, the loss as a column of the
// partial (a select per term), and 32 rows a round (no gain).
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 200 * 1024;  // bytes a staged block may use

__host__ __device__ constexpr int round4(int v) { return (v + 3) & ~3; }

// Shared floats of one block: [tile][w][y] (staged only), err, loss, a
// reduction buffer of kThreads, and the last-block flag.
__host__ __device__ constexpr int smem_floats(int rows, int d, bool staged) {
  return (staged ? round4(rows * d) + round4(d) + round4(rows) : 0) +
         2 * round4(rows) + kThreads + 4;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// Copy len floats to 16-byte aligned shared memory (not yet waited for).
__device__ __forceinline__ void stage(float* dst, const float* src, int len) {
  int i0 = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n4 = len >> 2;
    for (int i = threadIdx.x; i < n4; i += kThreads)
      cp_async16(dst + 4 * i, src + 4 * i);
    i0 = 4 * n4;
  }
  for (int i = i0 + threadIdx.x; i < len; i += kThreads)
    cp_async4(dst + i, src + i);
}

// dst(c, sum_r term(r, c)) for c in [0, ncols), r in [0, nrows), in an
// order that depends on ncols and nrows alone: thread t takes column
// t % cpp of each pass and row slice t / cpp; a slice reads its rows s,
// s + S, ... kChunk at a time (all loads of a round in flight together)
// into eight accumulators; a tree over the S slices in shared memory
// (`red`, kThreads floats) adds them up. Called by the whole block.
constexpr int kChunk = 16;

template <class Term, class Store>
__device__ __forceinline__ void column_sums(int ncols, int nrows, Term term,
                                            Store dst, float* red) {
  const int cpp = min(ncols, kThreads);
  int S = 1;
  while (2 * S * cpp <= kThreads) S *= 2;
  const int cl = threadIdx.x % cpp, s = threadIdx.x / cpp;
  for (int c0 = 0; c0 < ncols; c0 += cpp) {
    const int c = c0 + cl;
    const bool live = s < S && c < ncols;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (live) {
      for (int r = s; r < nrows; r += kChunk * S) {
        float v[kChunk];
#pragma unroll
        for (int k = 0; k < kChunk; ++k)
          v[k] = r + k * S < nrows ? term(r + k * S, c) : 0.f;
#pragma unroll
        for (int k = 0; k < kChunk; ++k) acc[k & 7] += v[k];
      }
    }
    red[threadIdx.x] = ((acc[0] + acc[1]) + (acc[2] + acc[3])) +
                       ((acc[4] + acc[5]) + (acc[6] + acc[7]));
    __syncthreads();
    for (int st = S / 2; st > 0; st /= 2) {
      if (live && s < st) red[threadIdx.x] += red[threadIdx.x + st * cpp];
      __syncthreads();
    }
    if (live && s == 0) dst(c, red[cl]);
    __syncthreads();
  }
}

// The workspace of one call (see gredo_logreg_f32).
struct Workspace {
  unsigned* ticket;         // last-group ticket
  unsigned* group_ticket;   // (groups,) tickets inside each group
  float* part;              // (blocks, d + 1) block partials
  float* group_part;        // (groups, d + 1) group partials
};

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
    logreg_kernel(const float* __restrict__ X, const float* __restrict__ y,
                  const float* __restrict__ w, Workspace ws,
                  float* __restrict__ out, int n, int d, int rows, int lanes,
                  int group_blocks) {
  extern __shared__ __align__(16) float smem[];
  const int r0 = blockIdx.x * rows;
  const int R = min(rows, n - r0);
  float* s_tile = smem;
  float* s_w = smem + round4(rows * d);
  float* s_y = s_w + round4(d);
  float* s_err = kStaged ? s_y + round4(rows) : smem;
  float* s_loss = s_err + round4(rows);
  float* s_red = s_loss + round4(rows);
  int* s_last = reinterpret_cast<int*>(s_red + kThreads);

  const float* xt = X + (size_t)r0 * d;
  const float* wv = w;
  const float* yv = y + r0;
  if (kStaged) {
    stage(s_tile, xt, R * d);
    stage(s_w, w, d);
    stage(s_y, yv, R);
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                     : "memory");
    __syncthreads();
    xt = s_tile;
    wv = s_w;
    yv = s_y;
  }

  // z = <x_r, w> on `lanes` lanes per row (all rows of the tile in one or
  // two passes), then the error and the loss term, a row per thread
  const int gl = threadIdx.x & (lanes - 1);
  const int per_pass = kThreads / lanes;
  for (int rb = 0; rb < R; rb += per_pass) {
    const int r = rb + threadIdx.x / lanes;
    float z0 = 0.f, z1 = 0.f;
    if (r < R) {
      const float* xr = xt + (size_t)r * d;
      int j = gl;
      for (; j + lanes < d; j += 2 * lanes) {
        z0 = fmaf(xr[j], wv[j], z0);
        z1 = fmaf(xr[j + lanes], wv[j + lanes], z1);
      }
      if (j < d) z0 = fmaf(xr[j], wv[j], z0);
    }
    float z = z0 + z1;
    for (int o = lanes / 2; o > 0; o /= 2)
      z += __shfl_xor_sync(0xffffffffu, z, o, lanes);
    if (r < R && gl == 0) s_err[r] = z;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < R; r += kThreads) {
    const float z = s_err[r], yr = yv[r];
    s_err[r] = 1.f / (1.f + expf(-z)) - yr;
    s_loss[r] = fmaxf(z, 0.f) + log1pf(expf(-fabsf(z))) - yr * z;
  }
  __syncthreads();

  // the block's partial: sum_r err_r x_r in columns [0, d), the loss sum
  // (rows in a fixed order: lane l takes rows l, l + 32, ..., then a
  // shuffle tree) in column d
  const int cols = d + 1;
  float* my_part = ws.part + (size_t)blockIdx.x * cols;
  column_sums(
      d, R, [&](int r, int c) { return s_err[r] * xt[(size_t)r * d + c]; },
      [&](int c, float v) { my_part[c] = v; }, s_red);
  if (threadIdx.x < 32) {
    float l = 0.f;
    for (int r = threadIdx.x; r < R; r += 32) l += s_loss[r];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (threadIdx.x == 0) my_part[d] = l;
  }

  // The last block of each group of `group_blocks` consecutive blocks sums
  // the group's partials in block order; the last group to finish sums the
  // group partials in group order (with one group, the first level is the
  // sum). The order is the shape's alone.
  const int blocks = gridDim.x;
  const int groups = (blocks + group_blocks - 1) / group_blocks;
  const int g = blockIdx.x / group_blocks, b0 = g * group_blocks;
  const int members = min(group_blocks, blocks - b0);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    *s_last = atomicAdd(ws.group_ticket + g, 1u) == members - 1;
  __syncthreads();
  if (!*s_last) return;
  __threadfence();
  const float fn = static_cast<float>(n);
  column_sums(
      cols, members,
      [&](int b, int c) {
        return __ldcg(ws.part + (size_t)(b0 + b) * cols + c);
      },
      [&](int c, float v) {
        if (groups == 1)  // one level: this is the sum
          out[c] = v / fn;
        else
          ws.group_part[(size_t)g * cols + c] = v;
      },
      s_red);
  if (groups == 1) {
    if (threadIdx.x == 0) ws.group_ticket[0] = 0u;
    return;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    ws.group_ticket[g] = 0u;  // ready for the next call
    *s_last = atomicAdd(ws.ticket, 1u) == groups - 1;
  }
  __syncthreads();
  if (!*s_last) return;
  __threadfence();
  column_sums(
      cols, groups,
      [&](int b, int c) { return __ldcg(ws.group_part + (size_t)b * cols + c); },
      [&](int c, float v) { out[c] = v / fn; }, s_red);
  if (threadIdx.x == 0) *ws.ticket = 0u;
}

template <bool kStaged>
cudaError_t launch(const float* x, const float* y, const float* w,
                   Workspace ws, float* out, int n, int d, int rows,
                   int lanes, int group_blocks, cudaStream_t s) {
  const int bytes = smem_floats(rows, d, kStaged) * 4;
  static int configured[64] = {};  // opted-in shared bytes per device
  int dev = 0;
  cudaGetDevice(&dev);
  if (bytes > 48 * 1024 && dev < 64 && configured[dev] < bytes) {
    const cudaError_t e = cudaFuncSetAttribute(
        logreg_kernel<kStaged>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem + 1024);
    if (e != cudaSuccess) return e;
    configured[dev] = kMaxSmem + 1024;
  }
  const int blocks = (n + rows - 1) / rows;
  logreg_kernel<kStaged><<<blocks, kThreads, bytes, s>>>(
      x, y, w, ws, out, n, d, rows, lanes, group_blocks);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out: (d + 1,) -- the mean gradient in out[0:d], the mean loss in out[d].
// rows: rows per block; lanes: lanes per row (a power of two, at most 32);
// group_blocks: blocks per reduction group. With blocks = ceil(n / rows)
// and groups = ceil(blocks / group_blocks): tickets holds 1 + groups
// unsigned ints, zeroed once when it is allocated and written by nothing
// else (the kernel leaves every ticket at 0); part holds
// (blocks + groups) * (d + 1) floats, the block partials and then the group
// partials.
int gredo_logreg_f32(const void* x, const void* y, const void* w,
                     void* tickets, void* part, void* out, int n, int d,
                     int rows, int lanes, int group_blocks, void* stream) {
  if (n <= 0 || d <= 0 || rows <= 0 || lanes <= 0 || lanes > 32 ||
      (lanes & (lanes - 1)) || group_blocks <= 0)
    return cudaErrorInvalidValue;
  const int blocks = (n + rows - 1) / rows;
  auto* t = static_cast<unsigned*>(tickets);
  auto* p = static_cast<float*>(part);
  const Workspace work{t, t + 1, p, p + (size_t)blocks * (d + 1)};
  const auto* xf = static_cast<const float*>(x);
  const auto* yf = static_cast<const float*>(y);
  const auto* wf = static_cast<const float*>(w);
  auto* of = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (smem_floats(rows, d, true) * 4 <= kMaxSmem)
    return launch<true>(xf, yf, wf, work, of, n, d, rows, lanes,
                        group_blocks, s);
  return launch<false>(xf, yf, wf, work, of, n, d, rows, lanes, group_blocks,
                       s);
}

}  // extern "C"
