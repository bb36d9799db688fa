// One fused traversal hop for B padded frontiers (the device GCDI hot path):
// CSR gather + neighbour expansion + member / zone-chunk / edge-predicate
// filter + order-preserving compaction.
//
// Replaces the Pallas kernel `batched_hop` (src/repro/kernels/traversal/
// traversal.py, body `_hop_kernel`, with its jnp prelude; `fused_hop` is
// its B = 1 case). The Pallas kernel finds each slot's frontier entry with a
// broadcast compare against all C offsets and compacts by carrying a running
// offset in scalar memory across sequential grid steps. GPU blocks run in no
// order, so one call (`gredo_hop`) launches two kernels back to back:
//   hop_scan_kernel   -- over (B, C) frontier entries, 2048 per tile:
//                        deg = fmask ? row_ptr[f+1] - row_ptr[f] : 0 (the
//                        CSR is read only for live entries) and its
//                        exclusive prefix out_off, by a single-pass scan
//                        with decoupled look-back (Merrill & Garland) across
//                        a query's tiles; the query's last tile writes
//                        total[q] and overflowed[q] = total > capacity, and
//                        each live entry names itself the owner of the
//                        expand tiles whose first slot it covers;
//   hop_expand_kernel -- over (B, capacity) slots, 512 per tile, 2
//                        consecutive ones per thread: the tile reads the
//                        owner of its first slot and stages out_off from
//                        there on in shared memory; a thread's first slot
//                        searches there and its next one steps along the
//                        row; then the CSR gather and the three filters
//                        (every index clamped as in the plain version),
//                        stage by stage for both slots; survivors ranked in
//                        slot order by warp ballots and decoupled look-back.
// Every output position is written exactly once: survivor k of a query at
// k; the i-th dropped candidate before the query's live limit
// L = min(total, capacity) at L - 1 - i (padding: src 0, dst -1, eid -1);
// slot p >= L at p. So [0, count) holds the survivors in slot order and
// [count, capacity) the padding, with no fill pass and no race.
// Tile ids come from an atomicAdd on a counter, so a tile's predecessors
// have started before it waits on them. Each kernel clears the other's tile
// counter and look-back status words (stream order keeps the other kernel
// from running meanwhile), so no memset is launched, and the device holds
// all the state a call needs: a call replayed from a CUDA graph finds its
// words cleared as a fresh launch does.
//
// What bounds it on the H100: dependent memory round trips, not bytes. The
// bytes are those of the outputs (12 per slot), the frontier masks, out_off
// and the gathers of the live candidates: about 11 MB at the main path's
// G5 hop (capacity 524288, 200k candidates), ~3.3 us at 3.35 TB/s. But a
// live expand tile waits on a chain of rounds (its tile id, its first
// slot's owner, the staged offsets, the frontier entry, row_ptr, the CSR
// row, the three predicate tables, then the look-back), each near a
// microsecond on a loaded card, and a scan tile on its look-back. So the
// design cuts rounds: the owner map replaces a search of out_off, a
// thread's gathers go out together, the look-back reads 128 tiles a round
// and spins on one word with a backoff.
//
// Tried on the card and dropped: the port's first version computed the
// degrees, out_off, total and the overflow flag with ~9 torch ops over all
// C entries (an int64 copy of the frontier among them), ran a 19-step
// binary search of the whole out_off per slot in two kernels (count, then
// scatter, repeating every gather), and scanned the block counts with torch
// ops between them: ~14 device operations per hop, the host's issue of them
// most of its time. In this design's bring-up: 256-slot tiles with a
// 19-step search per tile, release/acquire status accesses, a 32-tile
// look-back window spun on by the whole warp, 4 slots per thread, and
// read-only-cache loads of the CSR and the tables (no gain).
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScanItems = 8;  // a multiple of 8
constexpr int kScanTile = kThreads * kScanItems;  // entries per scan tile
constexpr int kSlotItems = 2;  // consecutive slots per expand thread
constexpr int kSlotTile = kThreads * kSlotItems;  // slots per expand tile
constexpr int kStage = 2048;  // out_off entries an expand tile may stage
constexpr unsigned kFull = 0xffffffffu;

// Look-back status word: flag (0: not published) << 32 | value (32 bits).
constexpr unsigned long long kAggregate = 1, kInclusive = 2;

__device__ __forceinline__ unsigned long long pack(unsigned long long flag,
                                                   unsigned value) {
  return (flag << 32) | value;
}

// Zeroes the other kernel's words [0, n), spread over this kernel's grid.
__device__ __forceinline__ void clear_words(unsigned long long* w, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    w[i] = 0ull;
}

// A status word holds its own value, and no reader needs any other write
// of the publishing tile, so relaxed (not release/acquire) accesses do.
__device__ __forceinline__ void publish(unsigned long long* p,
                                        unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long peek(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

constexpr int kLookItems = 4;                 // words per lane and round
constexpr int kLookWindow = 32 * kLookItems;  // tiles per look-back round

// Exclusive prefix of tile t among the tiles whose words start at `status`
// (one query's). Called by a whole warp; lane 0 has published tile t's
// aggregate already. A round reads the 128 tiles before `pred` (lane l the
// ones 4l..4l+3 back); once all are published, it adds them up to the
// nearest inclusive prefix, or all of them and goes on.
__device__ unsigned look_back(const unsigned long long* status, int t) {
  const int lane = threadIdx.x & 31;
  // first wait, on one word and with a backoff, for the predecessor: a
  // spinning warp must not crowd out the gathers of tiles on its SM
  if (lane == 0) {
    unsigned ns = 32;
    while ((peek(status + t - 1) >> 32) == 0) {
      __nanosleep(ns);
      ns = min(2 * ns, 512u);
    }
  }
  __syncwarp();
  unsigned excl = 0;
  int pred = t - 1;
  while (true) {
    unsigned long long v[kLookItems];
    unsigned flag[kLookItems];
    bool unready = false;
#pragma unroll
    for (int k = 0; k < kLookItems; ++k) {
      const int i = pred - kLookItems * lane - k;
      v[k] = i >= 0 ? peek(status + i) : pack(kInclusive, 0u);
    }
#pragma unroll
    for (int k = 0; k < kLookItems; ++k) {
      flag[k] = static_cast<unsigned>(v[k] >> 32);
      unready |= flag[k] == 0u;
    }
    if (__any_sync(kFull, unready)) {  // not all published yet
      __nanosleep(64);
      continue;
    }
    int stop = kLookWindow;  // distance back of the nearest inclusive word
#pragma unroll
    for (int k = kLookItems - 1; k >= 0; --k)
      if (flag[k] == kInclusive) stop = kLookItems * lane + k;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      stop = min(stop, __shfl_xor_sync(kFull, stop, o));
    unsigned val = 0;
#pragma unroll
    for (int k = 0; k < kLookItems; ++k)
      if (kLookItems * lane + k <= stop) val += static_cast<unsigned>(v[k]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) val += __shfl_xor_sync(kFull, val, o);
    excl += val;
    if (stop < kLookWindow) return excl;
    pred -= kLookWindow;
  }
}

// Publishes tile t's aggregate, looks back, publishes its inclusive prefix;
// returns the exclusive prefix to every lane. Called by warp 0.
__device__ unsigned chain(unsigned long long* status, int t, unsigned agg) {
  const int lane = threadIdx.x & 31;
  if (t == 0) {
    if (lane == 0) publish(status, pack(kInclusive, agg));
    return 0u;
  }
  if (lane == 0) publish(status + t, pack(kAggregate, agg));
  const unsigned excl = look_back(status, t);
  if (lane == 0) publish(status + t, pack(kInclusive, excl + agg));
  return excl;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

struct HopArgs {
  const int* row_ptr;      // (n_rp,)
  const int* col_idx;      // (m,)
  const int* edge_id;      // (m,)
  const int* frontier;     // (B, C) nids
  const bool* fmask;       // (B, C)
  const bool* member;      // (n_mem,)
  const bool* edge_pred;   // (n_ep,)
  const bool* chunk_alive; // (n_ch,)
  int* out_off;            // (B, C) exclusive prefix of the degrees
  int* total;              // (B,) candidate totals
  int* tile_owner;         // (B, expand tiles) entry owning a tile's 1st slot
  unsigned long long* scan_ctr;    // tile counter of hop_scan_kernel
  unsigned long long* expand_ctr;  // tile counter of hop_expand_kernel
  unsigned long long* scan_status;    // (B, scan tiles)
  unsigned long long* expand_status;  // (B, expand tiles)
  int* src;                // (B, capacity)
  int* dst;
  int* eid;
  int* count;              // (B,)
  bool* overflowed;        // (B,)
  int B, C, capacity, chunk, n_rp, m, n_mem, n_ep, n_ch;
  int scan_tiles, expand_tiles;
};

__global__ void __launch_bounds__(kThreads) hop_scan_kernel(HopArgs a) {
  __shared__ unsigned s_warp[kWarps];
  __shared__ unsigned s_excl;
  __shared__ int s_tile;
  if (threadIdx.x == 0) {
    s_tile = static_cast<int>(atomicAdd(a.scan_ctr, 1ull));
    if (blockIdx.x == 0) *a.expand_ctr = 0ull;  // the expand kernel's turn
  }
  clear_words(a.expand_status, a.B * a.expand_tiles);
  __syncthreads();
  const int q = s_tile / a.scan_tiles, t = s_tile % a.scan_tiles;
  const size_t row = (size_t)q * a.C;
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const int e0 = t * kScanTile + threadIdx.x * kScanItems;
  const bool whole = e0 + kScanItems <= a.C;

  bool live[kScanItems];
  const bool* fm = a.fmask + row + e0;
  if (whole && (reinterpret_cast<uintptr_t>(fm) & 7) == 0) {
#pragma unroll
    for (int h = 0; h < kScanItems / 8; ++h) {  // 8 flags a load
      const uint2 v = reinterpret_cast<const uint2*>(fm)[h];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        live[8 * h + k] = ((k < 4 ? v.x : v.y) >> (8 * (k & 3))) & 0xffu;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) live[k] = e0 + k < a.C && fm[k];
  }
  int f[kScanItems];
#pragma unroll
  for (int k = 0; k < kScanItems; ++k)
    if (live[k]) f[k] = a.frontier[row + e0 + k];
  unsigned deg[kScanItems];
  unsigned sum = 0;
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    deg[k] = 0;
    if (live[k]) {
      const int i0 = clampi(f[k], 0, a.n_rp - 1);
      const int i1 = f[k] >= a.n_rp - 1 ? a.n_rp - 1 : max(f[k] + 1, 0);
      deg[k] = static_cast<unsigned>(a.row_ptr[i1] - a.row_ptr[i0]);
    }
    sum += deg[k];
  }
  // block-wide exclusive scan of the threads' sums
  unsigned inc = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned v = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += v;
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  unsigned before = 0, agg = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    before += k < warp ? s_warp[k] : 0u;
    agg += s_warp[k];
  }
  if (warp == 0) {
    const unsigned excl =
        chain(a.scan_status + (size_t)q * a.scan_tiles, t, agg);
    if (lane == 0) s_excl = excl;
  }
  __syncthreads();
  unsigned off = s_excl + before + inc - sum;
  int vals[kScanItems];
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    vals[k] = static_cast<int>(off);
    off += deg[k];
  }
  // each live entry names itself the owner of the expand tiles whose first
  // slot it covers (slots [off, off + deg) below the capacity)
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    if (deg[k] == 0) continue;
    const unsigned lo = static_cast<unsigned>(vals[k]);
    const unsigned hi = min(lo + deg[k], static_cast<unsigned>(a.capacity));
    for (unsigned b = (lo + kSlotTile - 1) / kSlotTile; b * kSlotTile < hi;
         ++b)
      a.tile_owner[(size_t)q * a.expand_tiles + b] = e0 + k;
  }
  int* oo = a.out_off + row + e0;
  if (whole && (reinterpret_cast<uintptr_t>(oo) & 15) == 0) {
#pragma unroll
    for (int h = 0; h < kScanItems / 4; ++h)
      reinterpret_cast<int4*>(oo)[h] =
          make_int4(vals[4 * h], vals[4 * h + 1], vals[4 * h + 2],
                    vals[4 * h + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < kScanItems; ++k)
      if (e0 + k < a.C) oo[k] = vals[k];
  }
  if (t == a.scan_tiles - 1 && threadIdx.x == 0) {
    const int total = static_cast<int>(s_excl + agg);
    a.total[q] = total;
    a.overflowed[q] = total > a.capacity;
  }
}

__device__ __forceinline__ void pad(const HopArgs& a, size_t p) {
  a.src[p] = 0;
  a.dst[p] = -1;
  a.eid[p] = -1;
}

__global__ void __launch_bounds__(kThreads) hop_expand_kernel(HopArgs a) {
  __shared__ int s_oo[kStage];
  __shared__ int s_total[kThreads];
  __shared__ unsigned s_warp[kWarps];
  __shared__ int s_tile, s_e0;
  __shared__ unsigned s_excl;
  const int B = a.B;
  clear_words(a.scan_status, B * a.scan_tiles);  // the next call's scan
  if (threadIdx.x == 0) {
    s_tile = static_cast<int>(atomicAdd(a.expand_ctr, 1ull));
    if (blockIdx.x == 0) *a.scan_ctr = 0ull;  // the next call's scan
  } else if (B < kThreads && threadIdx.x <= B) {
    s_total[threadIdx.x - 1] = a.total[threadIdx.x - 1];  // meanwhile
  }
  __syncthreads();
  const int q = s_tile / a.expand_tiles, b = s_tile % a.expand_tiles;
  const size_t orow = (size_t)q * a.capacity;
  const int s0 = b * kSlotTile;
  const int first = s0 + threadIdx.x * kSlotItems;  // this thread's slots
  const int total = B < kThreads ? s_total[q] : a.total[q];
  const int limit = max(min(total, a.capacity), 0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  if (s0 >= limit) {  // no live slot in this tile: padding only
    const size_t p = orow + first;
    if (kSlotItems % 4 == 0 && first + kSlotItems <= a.capacity &&
        ((reinterpret_cast<uintptr_t>(a.src + p) |
          reinterpret_cast<uintptr_t>(a.dst + p) |
          reinterpret_cast<uintptr_t>(a.eid + p)) & 15) == 0) {
#pragma unroll
      for (int h = 0; h < kSlotItems / 4; ++h) {
        reinterpret_cast<int4*>(a.src + p)[h] = make_int4(0, 0, 0, 0);
        reinterpret_cast<int4*>(a.dst + p)[h] = make_int4(-1, -1, -1, -1);
        reinterpret_cast<int4*>(a.eid + p)[h] = make_int4(-1, -1, -1, -1);
      }
    } else {
      for (int k = 0; k < kSlotItems; ++k)
        if (first + k < a.capacity) pad(a, p + k);
    }
    if (b == 0 && threadIdx.x == 0) a.count[q] = 0;
    return;
  }
  // out_off from the owner of the tile's first slot on, staged (the
  // owners of the tile's slots are almost always among the next kStage
  // entries; a slot whose owner lies past them searches out_off itself)
  const int* oo = a.out_off + (size_t)q * a.C;
  if (threadIdx.x == 0) s_e0 = a.tile_owner[(size_t)q * a.expand_tiles + b];
  __syncthreads();
  const int e0 = s_e0;
  const int e_end = min(e0 + kStage, a.C);  // staged: [e0, e_end)
  for (int i = e0 + threadIdx.x; i < e_end; i += kThreads) s_oo[i - e0] = oo[i];
  __syncthreads();
  auto off_at = [&](int i) { return i < e_end ? s_oo[i - e0] : oo[i]; };
  // the first index in [lo, C) whose offset is > slot (oo[lo - 1] <= slot):
  // in the staged window, or past it in out_off
  auto owner_end = [&](int lo, int slot) {
    int hi = e_end;
    if (lo < e_end && s_oo[e_end - 1 - e0] <= slot) lo = e_end;
    if (lo >= e_end) hi = a.C;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (off_at(mid) <= slot)
        lo = mid + 1;
      else
        hi = mid;
    }
    return lo;
  };

  // this thread's slots: the owner of the first live one by a search, each
  // next one's by a step when the owner's row still holds it; then the
  // gathers of its slots stage by stage, so a thread waits on four rounds
  // of memory, not four per slot
  bool ok[kSlotItems];
  int src[kSlotItems], dst[kSlotItems], eid[kSlotItems], idx[kSlotItems];
  int e = -1;
#pragma unroll
  for (int k = 0; k < kSlotItems; ++k) {
    const int slot = first + k;
    src[k] = -1;
    if (slot >= limit) continue;
    if (e < 0)
      e = owner_end(e0 + 1, slot) - 1;
    else if (e + 1 < a.C && off_at(e + 1) <= slot)
      e = owner_end(e + 2, slot) - 1;
    src[k] = e;
    idx[k] = slot - off_at(e);  // within the row
  }
  const int* frontier = a.frontier + (size_t)q * a.C;
#pragma unroll
  for (int k = 0; k < kSlotItems; ++k)
    if (src[k] >= 0) dst[k] = clampi(frontier[src[k]], 0, a.n_rp - 1);
#pragma unroll
  for (int k = 0; k < kSlotItems; ++k)
    if (src[k] >= 0) idx[k] = clampi(a.row_ptr[dst[k]] + idx[k], 0, a.m - 1);
#pragma unroll
  for (int k = 0; k < kSlotItems; ++k) {
    if (src[k] < 0) continue;
    dst[k] = a.col_idx[idx[k]];
    eid[k] = a.edge_id[idx[k]];
  }
  unsigned n_ok = 0, n_drop = 0;
#pragma unroll
  for (int k = 0; k < kSlotItems; ++k) {
    ok[k] = false;
    if (src[k] < 0) continue;
    int ch = eid[k] / a.chunk;  // floor division, as the plain version's
    if (eid[k] % a.chunk != 0 && eid[k] < 0) --ch;
    // all three tables gathered (no short circuit): one round, not three
    ok[k] = a.member[clampi(dst[k], 0, a.n_mem - 1)] &
            a.chunk_alive[clampi(ch, 0, a.n_ch - 1)] &
            a.edge_pred[clampi(eid[k], 0, a.n_ep - 1)];
    n_ok += ok[k];
    n_drop += !ok[k];
  }
  // block-wide exclusive scan of (survivors, drops), packed 16:16 (a tile
  // has at most kSlotTile of each)
  const unsigned packed = (n_ok << 16) | n_drop;
  unsigned inc = packed;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned v = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += v;
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  unsigned before = inc - packed, tile_sum = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    before += k < warp ? s_warp[k] : 0u;
    tile_sum += s_warp[k];
  }
  const unsigned agg = tile_sum >> 16;
  if (warp == 0) {
    const unsigned excl = chain(a.expand_status + (size_t)q * a.expand_tiles,
                                b, agg);
    if (lane == 0) s_excl = excl;
  }
  __syncthreads();
  const unsigned excl = s_excl;
  unsigned r_ok = excl + (before >> 16);
  // a dropped candidate pads from the live limit down (the drops before
  // this tile: s0 - excl); a slot past the limit pads itself
  unsigned r_drop = limit - 1 - ((s0 - excl) + (before & 0xffffu));
#pragma unroll
  for (int k = 0; k < kSlotItems; ++k) {
    const int slot = first + k;
    if (ok[k]) {
      const size_t p = orow + r_ok++;
      a.src[p] = src[k];
      a.dst[p] = dst[k];
      a.eid[p] = eid[k];
    } else if (slot < limit) {
      pad(a, orow + r_drop--);
    } else if (slot < a.capacity) {
      pad(a, orow + slot);
    }
  }
  if (threadIdx.x == 0 && s0 + kSlotTile >= limit)  // the last live tile
    a.count[q] = static_cast<int>(excl + agg);
}

int tiles(int n, int per) { return (n + per - 1) / per; }

}  // namespace

extern "C" {

// Workspace of a (B, C, capacity) hop, part by part: 0, the scan's 64-bit
// words (the two tile counters, then its look-back words); 1, the expand
// kernel's look-back words; 2, the int32 data (out_off (B, C), total (B,),
// the owner of each expand tile's first slot (B, expand tiles)), written
// before it is read in every call. Parts 0 and 1 are zeroed once when they
// are allocated, each kernel leaves the other's at 0, and they stay apart so
// that a call of another shape also finds its words at 0.
long long gredo_hop_workspace(int part, int B, int C, int capacity) {
  if (part == 0) return 2 + (long long)B * tiles(C, kScanTile);
  if (part == 1) return (long long)B * tiles(capacity, kSlotTile);
  return (long long)B * (C + 1 + tiles(capacity, kSlotTile));
}

// One hop of B queries: the scan kernel, then the expand kernel, on
// `stream`. scan_words, expand_words, data: the parts of
// gredo_hop_workspace(part, B, C, capacity).
int gredo_hop(const void* row_ptr, const void* col_idx, const void* edge_id,
              const void* frontier, const void* fmask, const void* member,
              const void* edge_pred, const void* chunk_alive,
              void* scan_words, void* expand_words, void* data, void* src,
              void* dst, void* eid, void* count, void* overflowed, int B,
              int C, int capacity, int chunk, int n_rp, int m, int n_mem,
              int n_ep, int n_ch, void* stream) {
  if (B <= 0 || C <= 0 || capacity <= 0 || chunk <= 0 || n_rp <= 0 ||
      m <= 0 || n_mem <= 0 || n_ep <= 0 || n_ch <= 0)
    return cudaErrorInvalidValue;
  auto* words = static_cast<unsigned long long*>(scan_words);
  auto* ints = static_cast<int*>(data);
  HopArgs a{};
  a.row_ptr = static_cast<const int*>(row_ptr);
  a.col_idx = static_cast<const int*>(col_idx);
  a.edge_id = static_cast<const int*>(edge_id);
  a.frontier = static_cast<const int*>(frontier);
  a.fmask = static_cast<const bool*>(fmask);
  a.member = static_cast<const bool*>(member);
  a.edge_pred = static_cast<const bool*>(edge_pred);
  a.chunk_alive = static_cast<const bool*>(chunk_alive);
  a.scan_tiles = tiles(C, kScanTile);
  a.expand_tiles = tiles(capacity, kSlotTile);
  a.out_off = ints;  // first: a row's int4 stores need 16-byte alignment
  a.total = ints + (size_t)B * C;
  a.tile_owner = a.total + B;
  a.scan_ctr = words;
  a.expand_ctr = words + 1;
  a.scan_status = words + 2;
  a.expand_status = static_cast<unsigned long long*>(expand_words);
  a.src = static_cast<int*>(src);
  a.dst = static_cast<int*>(dst);
  a.eid = static_cast<int*>(eid);
  a.count = static_cast<int*>(count);
  a.overflowed = static_cast<bool*>(overflowed);
  a.B = B;
  a.C = C;
  a.capacity = capacity;
  a.chunk = chunk;
  a.n_rp = n_rp;
  a.m = m;
  a.n_mem = n_mem;
  a.n_ep = n_ep;
  a.n_ch = n_ch;
  auto s = static_cast<cudaStream_t>(stream);
  hop_scan_kernel<<<B * a.scan_tiles, kThreads, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  hop_expand_kernel<<<B * a.expand_tiles, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
