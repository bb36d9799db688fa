// One fused traversal hop for B padded frontiers (the device GCDI hot path):
// CSR gather + neighbour expansion + member / zone-chunk / edge-predicate
// filter + order-preserving compaction.
//
// Replaces the Pallas kernel `batched_hop` (src/repro/kernels/traversal/
// traversal.py, body `_hop_kernel`; `fused_hop` is its B = 1 case). The
// Pallas kernel finds each slot's frontier entry with a broadcast compare
// against all C offsets, O(blk * C) per block, and compacts by carrying a
// running offset in scalar memory across sequential grid steps. Neither
// carries over: the compare is quadratic in the capacity on a GPU, and GPU
// blocks run in no order. So the hop is split in two launches with a small
// exclusive scan of per-block counts between them (done by the caller):
//   kernel A (hop_count)   -- one thread per output slot: binary search of
//                             the slot's frontier entry in out_off (upper
//                             bound - 1, clamped to [0, C-1]), the CSR
//                             gather, the filters; each block counts its
//                             survivors with __syncthreads_count;
//   kernel B (hop_scatter) -- recomputes the same candidate, ranks survivors
//                             inside the block with warp ballots, writes
//                             them to block offset + rank (slot order is
//                             kept) and fills the slots past `count` with
//                             src = 0, dst = -1, eid = -1.
// Every gather index is clamped, as in the plain version.
//
// What bounds it on the H100: memory. Per slot and hop the work is three
// int32 outputs plus the gathers (33 bytes in the traffic model of
// core/pattern_jit.py); at the main path's 524288 slots that is ~17 MB,
// ~5 us at 3.35 TB/s. Only the slots below min(total, capacity) search and
// gather; the rest (most of them: the capacity is an estimate's upper
// bound) return at once and cost their output writes. The gathers are data
// dependent (random rows of the CSR and of the predicate tables) and
// kernel B repeats kernel A's reads, which this first version accepts in
// exchange for writing no per-slot scratch.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;

struct HopArgs {
  const int* out_off;      // (B, C) exclusive prefix sum of the degrees
  const int* frontier;     // (B, C) nids
  const int* total;        // (B,) candidate totals
  const int* row_ptr;      // (n_rp,)
  const int* col_idx;      // (m,)
  const int* edge_id;      // (m,)
  const bool* member;      // (n_mem,)
  const bool* edge_pred;   // (n_ep,)
  const bool* chunk_alive; // (n_ch,)
  int C, capacity, chunk, n_rp, m, n_mem, n_ep, n_ch;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// Whether output slot `slot` of query q holds a surviving candidate, and
// which. A slot at or past min(total, capacity) holds none: it returns at
// once, without the search or the gathers. At the main path's capacities
// most slots are such (the capacity is an estimate's upper bound), so this
// test is what keeps their cost to one load of total[q].
__device__ __forceinline__ bool candidate(const HopArgs& a, int q, int slot,
                                          int& src, int& dst, int& eid) {
  if (slot >= min(a.total[q], a.capacity)) return false;
  const int* oo = a.out_off + (size_t)q * a.C;
  int lo = 0, hi = a.C;  // upper bound: first offset > slot
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (oo[mid] <= slot)
      lo = mid + 1;
    else
      hi = mid;
  }
  src = clampi(lo - 1, 0, a.C - 1);
  const int within = slot - oo[src];
  const int f = clampi(a.frontier[(size_t)q * a.C + src], 0, a.n_rp - 1);
  const int pos = clampi(a.row_ptr[f] + within, 0, a.m - 1);
  dst = a.col_idx[pos];
  eid = a.edge_id[pos];
  return a.member[clampi(dst, 0, a.n_mem - 1)] &&
         a.chunk_alive[clampi(eid / a.chunk, 0, a.n_ch - 1)] &&
         a.edge_pred[clampi(eid, 0, a.n_ep - 1)];
}

__global__ void __launch_bounds__(kThreads)
    hop_count_kernel(HopArgs a, int* __restrict__ block_counts, int nblk) {
  const int q = blockIdx.y;
  const int slot = blockIdx.x * kThreads + threadIdx.x;
  int src, dst, eid;
  const bool ok = candidate(a, q, slot, src, dst, eid);
  const int c = __syncthreads_count(ok);
  if (threadIdx.x == 0) block_counts[(size_t)q * nblk + blockIdx.x] = c;
}

__global__ void __launch_bounds__(kThreads)
    hop_scatter_kernel(HopArgs a, const int* __restrict__ block_off,
                       const int* __restrict__ count, int* __restrict__ src_out,
                       int* __restrict__ dst_out, int* __restrict__ eid_out,
                       int nblk) {
  __shared__ int warp_total[kThreads / 32];
  const int q = blockIdx.y;
  const int slot = blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int src = 0, dst = 0, eid = 0;
  const bool ok = candidate(a, q, slot, src, dst, eid);
  const unsigned ballot = __ballot_sync(0xffffffffu, ok);
  if (lane == 0) warp_total[warp] = __popc(ballot);
  __syncthreads();
  int rank = block_off[(size_t)q * nblk + blockIdx.x];
  for (int k = 0; k < warp; ++k) rank += warp_total[k];
  rank += __popc(ballot & ((1u << lane) - 1u));
  const size_t row = (size_t)q * a.capacity;
  if (ok) {
    src_out[row + rank] = src;
    dst_out[row + rank] = dst;
    eid_out[row + rank] = eid;
  }
  if (slot < a.capacity && slot >= count[q]) {
    src_out[row + slot] = 0;
    dst_out[row + slot] = -1;
    eid_out[row + slot] = -1;
  }
}

HopArgs make_args(const void* out_off, const void* frontier, const void* total,
                  const void* row_ptr, const void* col_idx,
                  const void* edge_id, const void* member,
                  const void* edge_pred, const void* chunk_alive, int C,
                  int capacity, int chunk, int n_rp, int m, int n_mem,
                  int n_ep, int n_ch) {
  return HopArgs{static_cast<const int*>(out_off),
                 static_cast<const int*>(frontier),
                 static_cast<const int*>(total),
                 static_cast<const int*>(row_ptr),
                 static_cast<const int*>(col_idx),
                 static_cast<const int*>(edge_id),
                 static_cast<const bool*>(member),
                 static_cast<const bool*>(edge_pred),
                 static_cast<const bool*>(chunk_alive),
                 C, capacity, chunk, n_rp, m, n_mem, n_ep, n_ch};
}

}  // namespace

extern "C" {

// Slot blocks per query (columns of the block-count array).
int gredo_hop_blocks(int capacity) { return (capacity + kThreads - 1) / kThreads; }

int gredo_hop_count(const void* out_off, const void* frontier,
                    const void* total, const void* row_ptr,
                    const void* col_idx, const void* edge_id,
                    const void* member, const void* edge_pred,
                    const void* chunk_alive, void* block_counts, int B, int C,
                    int capacity, int chunk, int n_rp, int m, int n_mem,
                    int n_ep, int n_ch, void* stream) {
  const HopArgs a = make_args(out_off, frontier, total, row_ptr, col_idx,
                              edge_id, member, edge_pred, chunk_alive, C,
                              capacity, chunk, n_rp, m, n_mem, n_ep, n_ch);
  const int nblk = gredo_hop_blocks(capacity);
  hop_count_kernel<<<dim3(nblk, B), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<int*>(block_counts), nblk);
  return cudaGetLastError();
}

int gredo_hop_scatter(const void* out_off, const void* frontier,
                      const void* total, const void* row_ptr,
                      const void* col_idx, const void* edge_id,
                      const void* member, const void* edge_pred,
                      const void* chunk_alive, const void* block_off,
                      const void* count, void* src, void* dst, void* eid,
                      int B, int C, int capacity, int chunk, int n_rp, int m,
                      int n_mem, int n_ep, int n_ch, void* stream) {
  const HopArgs a = make_args(out_off, frontier, total, row_ptr, col_idx,
                              edge_id, member, edge_pred, chunk_alive, C,
                              capacity, chunk, n_rp, m, n_mem, n_ep, n_ch);
  const int nblk = gredo_hop_blocks(capacity);
  hop_scatter_kernel<<<dim3(nblk, B), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const int*>(block_off), static_cast<const int*>(count),
      static_cast<int*>(src), static_cast<int*>(dst), static_cast<int*>(eid),
      nblk);
  return cudaGetLastError();
}

}  // extern "C"
