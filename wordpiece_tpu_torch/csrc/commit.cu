// The greedy commit, for Hopper (sm_90a): per-position matches to the
// compacted id stream.
//
// These kernels replace the XLA program
// wordpiece_tpu/ops/commit.py::commit_with_positions (its loop to the fixed
// point :82-99, the segment kill :105-112 and the output :118-126).
// Together they compute the same function as that loop, and as the plain
// PyTorch version commit_with_positions_plain in ops/commit.py, which
// loops to the fixed point as well: whole outputs with the padding, ids
// int32[n] (-2 past count), positions int32[n] (-1 past count) and count,
// from best_id/best_len and the text features, for every input.
//
// The walk is the orbit of F(i) = ss[i + best_len[i]] on a match, else
// ss[wnext[min(i + window[i], n)]], from every unit start (a non-space
// after a space or at 0, below n_valid).  F strictly increases, and the
// orbit leaves a unit only for the next unit's start or for n, so the
// visited positions of a tile of T positions are the orbits, inside the
// tile, of the tile's own unit starts and of one integer carried in: c_t,
// the first visited position at or after the tile's start.  Segments start
// at visited word-prefix positions; a segment with a failed visited
// position emits one UNK at its start and nothing else.
//
// What bounds it on this card: device memory.  The compulsory traffic is
// best_id and best_len (8 bytes a position), ss, wnext and window (12),
// space and wp (2) read, ids and positions (8) written: 30 bytes a
// position, 377 MB at the 10 MB en bucket, 0.113 ms at 3.35 TB/s.  Past
// that the design moves two bits a position and one byte a tile between
// its kernels.  What it does:
//  - commit_walk_kernel, one block a tile of kTile positions, by ticket:
//    F of each position from coalesced loads (ss and wnext read near i
//    through the cache) into shared memory; pointer doubling inside the
//    tile (at most log2(kTile) + 1 rounds, each between two barriers,
//    stopped when a round adds nothing) marks the orbits of the tile's
//    unit starts and, for a tile with none, gives each position its last
//    position inside the tile.  Through the carry chain of csrc/scan.cuh:
//    a tile with a unit start publishes c_{t+1} (F of its last visited
//    position) at once, a reset; a tile with no non-space position passes
//    the carry on, which the look-back skips 32 tiles a step (the padding
//    of a bucket); a tile inside a unit longer than a tile waits for c_t
//    and publishes the exit of c_t's orbit.  Where non-space positions
//    come before the tile's first unit start, the orbit from c_t is then
//    marked there, by doubling again.  Only a run of tiles inside one
//    unit longer than a tile is serial, one look-back a tile.  It writes
//    visited and failed-and-visited bits (1 bit a position) and one byte
//    a tile: whether the tile holds a segment start, and whether a
//    failure comes before its first one or at or after its last one;
//  - commit_emit_kernel, one block two walk tiles, by ticket: each
//    segment's kill, inside the block's tile from the bits, across tiles
//    from the walk tiles' bytes (a warp each way reads 32 tiles a step
//    until a tile with a segment start); a forward sum scan with decoupled
//    look-back gives each emitting position its slot, where it writes its
//    id (read before the look-back) and position; the last tile writes
//    count;
//  - commit_fill_kernel: -2 / -1 into the slots past count.
// Launches a call: 3, after one memset of the carry chain's and the scan's
// status words, whatever the longest unit; nothing reads the card back.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

#include "scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
static_assert(kItems == 8, "the emit reads a thread's bits as one byte");
constexpr int kWords = kTile / 32;  // bit-mask words a tile
// The emit takes two walk tiles a block: half as many look-backs.
constexpr int kEmitThreads = 512;
constexpr int kEmitTile = kEmitThreads * kItems;
static_assert(kEmitTile % kTile == 0, "an emit tile is whole walk tiles");
constexpr int kFlatThreads = 256;
using Scan = wp::TileScan<kEmitThreads, 1, wp::SumOp, /*kReverse=*/false>;

// A tile's byte for the kill: a visited word-prefix position (a segment
// start) lies in it; a failed visited position lies before its first
// segment start (or anywhere, when it has none); one lies at or after its
// last segment start (or anywhere, when it has none).
enum : uint8_t { kHasStart = 1, kFailHead = 2, kFailTail = 4 };

long long tiles_of(long long n, int tile = kTile) { return n > 0 ? (n + tile - 1) / tile : 1; }
size_t round16(size_t b) { return (b + 15) & ~(size_t)15; }

// The scratch, in order: visited and failed bits, 1 a position over the
// emit tiles, the walk tiles' kill bytes, then the part zeroed before the
// launches: the walk's carry chain and the emit scan's status words.
struct Layout {
  size_t visited, failed, record, chain, scan, zeroed, total;
  explicit Layout(long long n) {
    const long long tiles = tiles_of(n);
    const size_t bits = round16((size_t)tiles_of(n, kEmitTile) * kEmitTile / 8);
    visited = 0;
    failed = bits;
    record = failed + bits;
    chain = record + round16((size_t)tiles);
    scan = chain + round16(wp::carry_scratch_bytes(tiles));
    total = scan + round16(wp::scan_scratch_bytes(1, tiles_of(n, kEmitTile)));
    zeroed = total - chain;
  }
};

struct WalkShared {
  int f[kTile];  // F of the tile's positions (n for spaces and past n)
  // Tile-relative jumps; a position whose jump leaves its range points to
  // itself.
  int jump[kTile];
  uint8_t mark[kTile];  // visited
  int first_seed, first_live, last_mark, first_start, last_start, carry, ticket;
};

// Doubling rounds over the tile: a marked position marks its jump's
// target, then every jump is squared.  Stops after the first round that
// marks nothing new (every seed's orbit is then whole: the first missing
// member of an orbit would be the target of a marked one), or, with
// `until_jumps`, that changes no jump (each jump then points to the last
// position of its orbit inside its range).
__device__ void double_rounds(WalkShared& sh, bool until_jumps) {
  for (;;) {
    int next[kItems];
    bool marked = false, moved = false;
#pragma unroll
    for (int e = 0; e < kItems; ++e) {
      const int l = e * kThreads + threadIdx.x;
      const int j = sh.jump[l];
      next[e] = sh.jump[j];
      moved |= next[e] != j;
      // Only marks are written in this half, always 1: a plain store.
      if (sh.mark[l] && !sh.mark[j]) {
        sh.mark[j] = 1;
        marked = true;
      }
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kItems; ++e) sh.jump[e * kThreads + threadIdx.x] = next[e];
    if (!__syncthreads_or(until_jumps ? moved : marked)) break;
  }
}

// One shared atomic a warp, after the warp's own minimum or maximum: a
// shared atomic a thread on one word would be serialised 32 ways.
__device__ __forceinline__ void block_min(int* at, int v) {
  v = __reduce_min_sync(~0u, v);
  if ((threadIdx.x & 31) == 0) atomicMin(at, v);
}
__device__ __forceinline__ void block_max(int* at, int v) {
  v = __reduce_max_sync(~0u, v);
  if ((threadIdx.x & 31) == 0) atomicMax(at, v);
}

// Jumps inside [0, hi) from F, the rest pointing to themselves (hi at
// most the tile's positions below n).
__device__ __forceinline__ void init_jumps(WalkShared& sh, long long t0, int hi) {
#pragma unroll
  for (int e = 0; e < kItems; ++e) {
    const int l = e * kThreads + threadIdx.x;
    const long long j = sh.f[l] - t0;
    sh.jump[l] = l < hi && j < hi ? (int)j : l;
  }
}

// Item e of a thread is position t0 + e * kThreads + threadIdx.x: every
// global load and shared access of a warp is unit-stride.
__global__ void __launch_bounds__(kThreads)
    commit_walk_kernel(const int* __restrict__ best_len, const int* __restrict__ window,
                       const int* __restrict__ ss, const int* __restrict__ wnext,
                       const uint8_t* __restrict__ space, const uint8_t* __restrict__ wp, int n,
                       int n_valid, void* chain, uint32_t* __restrict__ visited_bits,
                       uint32_t* __restrict__ failed_bits, uint8_t* __restrict__ record) {
  __shared__ WalkShared sh;
  if (threadIdx.x == 0) {
    sh.ticket = wp::CarryChain::ticket(chain);
    sh.first_seed = sh.first_live = sh.first_start = kTile;
    sh.last_mark = sh.last_start = -1;
  }
  __syncthreads();
  const int q = sh.ticket;
  const long long t0 = (long long)q * kTile;
  // F in three waves of loads, each independent across the items: the
  // position's own words, then a failure's next word prefix, then ss.
  uint32_t matched = 0, prefix = 0, nonspace = 0, seeds = 0;
  int at[kItems];
#pragma unroll
  for (int e = 0; e < kItems; ++e) {
    const long long p = t0 + e * kThreads + threadIdx.x;
    at[e] = n;
    if (p < n) {
      const bool sp = __ldg(space + p);
      const int len = __ldg(best_len + p);
      const int win = __ldg(window + p);
      const bool after_space = p == 0 || __ldg(space + p - 1);
      prefix |= (uint32_t)(__ldg(wp + p) != 0) << e;
      nonspace |= (uint32_t)!sp << e;
      seeds |= (uint32_t)(!sp && p < n_valid && after_space) << e;
      matched |= (uint32_t)(len > 0) << e;
      // On failure: past the probe window, to the next word prefix, then
      // past spaces (src/fast.cpp:84-95).
      at[e] = (int)min(p + (len > 0 ? len : win), (long long)n);
    }
  }
#pragma unroll
  for (int e = 0; e < kItems; ++e)
    if ((nonspace & ~matched) >> e & 1u) at[e] = __ldg(wnext + at[e]);
  int first_seed = kTile, first_live = kTile;
#pragma unroll
  for (int e = 0; e < kItems; ++e) {
    const int l = e * kThreads + threadIdx.x;
    const bool live_here = (nonspace >> e) & 1u;
    sh.f[l] = live_here ? __ldg(ss + at[e]) : n;
    sh.mark[l] = (seeds >> e) & 1u;
    if (live_here) first_live = min(first_live, l);
    if ((seeds >> e) & 1u) first_seed = min(first_seed, l);
  }
  block_min(&sh.first_seed, first_seed);
  block_min(&sh.first_live, first_live);
  __syncthreads();
  const int u0 = sh.first_seed;  // the tile's first unit start, kTile if none
  const int u_live = sh.first_live;  // its first non-space position, kTile if none
  const int live = (int)min((long long)kTile, n - t0);  // positions below n
  // One set of rounds: the marks of the unit starts' orbits, in
  // [u0, kTile); the jumps of [0, u0) to their last position there.
  if (u_live < kTile) {
    init_jumps(sh, t0, live);
#pragma unroll
    for (int e = 0; e < kItems; ++e) {
      const int l = e * kThreads + threadIdx.x;
      if (l < u0 && sh.jump[l] >= u0) sh.jump[l] = l;
    }
    __syncthreads();
    double_rounds(sh, u0 == kTile);
  }

  if (u0 < kTile) {
    int last = -1;
#pragma unroll
    for (int e = 0; e < kItems; ++e) {
      const int l = e * kThreads + threadIdx.x;
      if (sh.mark[l]) last = l;
    }
    block_max(&sh.last_mark, last);
    __syncthreads();
    if (threadIdx.x == 0) wp::CarryChain::publish(chain, q, sh.f[sh.last_mark]);
  } else if (u_live == kTile && threadIdx.x == 0) {
    wp::CarryChain::pass(chain, q);  // nothing here can be visited
  }
  // The carry in, needed only where non-space positions come before u0.
  if (u_live < u0) {
    if (threadIdx.x < 32) {
      const int c = wp::CarryChain::wait(chain, q, n);
      const long long l = c - t0;
      if (threadIdx.x == 0) {
        if (u0 == kTile)
          wp::CarryChain::publish(chain, q, c < n && l < kTile ? sh.f[sh.jump[l]] : c);
        sh.carry = c;
      }
    }
  } else if (threadIdx.x == 0) {
    sh.carry = n;
  }
  __syncthreads();
  // The orbit of the carry, over the positions before u0.
  const long long lc = sh.carry - t0;
  if (sh.carry < n && lc >= 0 && lc < u0) {
    init_jumps(sh, t0, min(u0, live));
    if (threadIdx.x == 0) sh.mark[lc] = 1;
    __syncthreads();
    double_rounds(sh, false);
  }

  // The bits, and the tile's byte for the kill.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bool fails[kItems];
  int first_start = kTile, last_start = -1;
#pragma unroll
  for (int e = 0; e < kItems; ++e) {
    const int l = e * kThreads + threadIdx.x;
    const bool v = sh.mark[l];
    fails[e] = v && !((matched >> e) & 1u);
    const uint32_t vw = __ballot_sync(~0u, v);
    const uint32_t fw = __ballot_sync(~0u, fails[e]);
    if (lane == 0) {
      visited_bits[(size_t)q * kWords + e * (kThreads / 32) + warp] = vw;
      failed_bits[(size_t)q * kWords + e * (kThreads / 32) + warp] = fw;
    }
    if (v && ((prefix >> e) & 1u)) {
      first_start = min(first_start, l);
      last_start = l;
    }
  }
  block_min(&sh.first_start, first_start);
  block_max(&sh.last_start, last_start);
  __syncthreads();
  const int fs = sh.first_start, ls = sh.last_start;
  bool head = false, tail = false;
#pragma unroll
  for (int e = 0; e < kItems; ++e) {
    const int l = e * kThreads + threadIdx.x;
    head |= fails[e] && l < fs;
    tail |= fails[e] && l >= ls;
  }
  head = __syncthreads_or(head);
  tail = __syncthreads_or(tail);
  if (threadIdx.x == 0)
    record[q] = (uint8_t)((fs < kTile ? kHasStart : 0) | (head ? kFailHead : 0) |
                          (tail ? kFailTail : 0));
}

// Loads 8 flags (bool or uint8 bytes) at p as bit e for p[e].
__device__ __forceinline__ uint32_t load_bits(const uint8_t* p, bool whole, long long left) {
  uint32_t bits = 0;
  if (whole) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      bits |= (uint32_t)(((v.x >> (8 * e)) & 0xFFu) != 0) << e;
      bits |= (uint32_t)(((v.y >> (8 * e)) & 0xFFu) != 0) << (e + 4);
    }
  } else {
#pragma unroll
    for (int e = 0; e < kItems; ++e)
      if (e < left) bits |= (uint32_t)(__ldg(p + e) != 0) << e;
  }
  return bits;
}

// Whether failures of a segment reach it from the walk tiles on one side
// (kStep -1: `from` and the tiles before it, +1: `from` and after), read
// 32 tiles a step by one warp, up to the nearest tile with a segment
// start.
template <int kStep>
__device__ bool kill_across(const uint8_t* __restrict__ record, long long from, int tiles,
                            int lane) {
  // Before the first tile and past the last: a segment start, no failure.
  for (long long at = from;; at += 32 * kStep) {
    const long long j = at + (long long)kStep * lane;
    const uint8_t r = j >= 0 && j < tiles ? __ldg(record + j) : (uint8_t)kHasStart;
    const unsigned starts = __ballot_sync(~0u, r & kHasStart);
    const int first = starts ? __ffs(starts) - 1 : 32;
    // The near side of a tile faces the segment: its failures after its
    // last start when it lies before q, before its first start after q.
    const uint8_t near = kStep < 0 ? kFailTail : kFailHead;
    const bool hit = lane < first ? (r & kFailHead) != 0 : lane == first && (r & near) != 0;
    if (__any_sync(~0u, hit)) return true;
    if (starts) return false;
  }
}

// Item e of a thread is position t0 + threadIdx.x * kItems + e: the
// slots follow the positions.  `tiles` counts the walk tiles, whose kill
// bytes are `record`.
__global__ void __launch_bounds__(kEmitThreads)
    commit_emit_kernel(const int* __restrict__ best_id, const uint8_t* __restrict__ wp,
                       const uint32_t* __restrict__ visited_bits,
                       const uint32_t* __restrict__ failed_bits,
                       const uint8_t* __restrict__ record, int n, int unk_id, int tiles,
                       int emit_tiles, void* scan, int* __restrict__ ids, int* __restrict__ positions,
                       int* __restrict__ count) {
  __shared__ Scan::Storage storage;
  __shared__ uint8_t killed[kEmitTile + 1];  // by segment inside the tile
  __shared__ bool across[2];             // failures reaching the first / last segment
  const int q = Scan::ticket(scan, storage);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long base = (long long)q * kEmitTile + (long long)threadIdx.x * kItems;
  const long long left = n - base;
  // A thread's 8 positions are byte base / 8 of the masks; past the last
  // walk tile the masks are not written.
  const uint32_t in_range = left >= kItems ? 0xFFu : left > 0 ? (1u << left) - 1 : 0u;
  const uint32_t visited = in_range & reinterpret_cast<const uint8_t*>(visited_bits)[base / 8];
  const uint32_t failed = in_range & reinterpret_cast<const uint8_t*>(failed_bits)[base / 8];
  const uint32_t starts = left > 0 ? visited & load_bits(wp + base, left >= kItems, left) : 0u;
  // Warp 0 looks back, warp 1 ahead.
  if (warp < 2) {
    const long long first = (long long)q * (kEmitTile / kTile);
    const bool hit = warp == 0 ? kill_across<-1>(record, first - 1, tiles, lane)
                               : kill_across<1>(record, first + kEmitTile / kTile, tiles, lane);
    if (lane == 0) across[warp] = hit;
  }
  for (int k = threadIdx.x; k <= kEmitTile; k += kEmitThreads) killed[k] = 0;
  int mine[1] = {__popc(starts)}, excl[1], agg[1];
  Scan::block_scan(mine, excl, agg, storage);  // its barrier also orders the zeroing
  int seg[kItems];
  int run = excl[0];
#pragma unroll
  for (int e = 0; e < kItems; ++e) {
    run += (starts >> e) & 1u;
    seg[e] = run;
    // Only failed visited positions write, and every writer writes 1.
    if ((failed >> e) & 1u) killed[run] = 1;
  }
  __syncthreads();
  uint32_t emit = 0, kills = 0;
#pragma unroll
  for (int e = 0; e < kItems; ++e) {
    if (!((visited >> e) & 1u)) continue;
    const bool kill =
        killed[seg[e]] || (seg[e] == 0 && across[0]) || (seg[e] == agg[0] && across[1]);
    const bool matched = !((failed >> e) & 1u);
    if ((matched && !kill) || (((starts >> e) & 1u) && kill)) emit |= 1u << e;
    kills |= (uint32_t)kill << e;
  }
  // The ids are read before the look-back, so that their latency hides
  // behind it.
  int val[kItems];
#pragma unroll
  for (int e = 0; e < kItems; ++e)
    val[e] = ((emit & ~kills) >> e) & 1u ? __ldg(best_id + base + e) : unk_id;
  mine[0] = __popc(emit);
  int before[1];
  Scan::block_scan(mine, excl, agg, storage);
  Scan::look_back(scan, emit_tiles, q, agg, before, storage);
  int slot = before[0] + excl[0];
#pragma unroll
  for (int e = 0; e < kItems; ++e) {
    if ((emit >> e) & 1u) {
      ids[slot] = val[e];
      positions[slot] = (int)(base + e);
      ++slot;
    }
  }
  if (q == emit_tiles - 1 && threadIdx.x == 0) *count = before[0] + agg[0];
}

__global__ void __launch_bounds__(kFlatThreads)
    commit_fill_kernel(const int* __restrict__ count, int n, int* __restrict__ ids,
                       int* __restrict__ positions) {
  const long long i = (long long)blockIdx.x * kFlatThreads + threadIdx.x;
  if (i < n && i >= __ldg(count)) {
    ids[i] = -2;
    positions[i] = -1;
  }
}

}  // namespace

// Bytes of scratch wp_commit needs for n positions.
extern "C" long long wp_commit_scratch_bytes(long long n) {
  return n < 0 ? -1 : (long long)Layout(n).total;
}

// Zeroes the status part of `scratch` (16-byte aligned) and launches the
// commit on `stream`: 3 kernels over n positions (n + 4096 < INT_MAX).
// best_id, best_len, window int32[n], ss, wnext int32[n + 1], space, wp
// bool[n], every one 16-byte aligned; ids and positions int32[n], count
// int32[1].  Returns a cudaError_t.
extern "C" int wp_commit(const void* best_id, const void* best_len, const void* window,
                         const void* ss, const void* wnext, const void* space, const void* wp,
                         long long n, long long n_valid, int unk_id, void* scratch, void* ids,
                         void* positions, void* count, void* stream) {
  if (n < 0 || n + kEmitTile >= INT_MAX || n_valid < 0) return cudaErrorInvalidValue;
  const Layout lay(n);
  const long long tiles = tiles_of(n);
  auto s = static_cast<cudaStream_t>(stream);
  auto* base = static_cast<uint8_t*>(scratch);
  auto* visited = reinterpret_cast<uint32_t*>(base + lay.visited);
  auto* failed = reinterpret_cast<uint32_t*>(base + lay.failed);
  auto* record = base + lay.record;
  const auto* kind = static_cast<const uint8_t*>(wp);
  auto* out_ids = static_cast<int*>(ids);
  auto* out_pos = static_cast<int*>(positions);
  auto* out_count = static_cast<int*>(count);
  const int nv = (int)(n_valid < n ? n_valid : n);  // seeds lie below both
  const unsigned flat = (unsigned)(n > 0 ? (n + kFlatThreads - 1) / kFlatThreads : 1);

  int rc = cudaMemsetAsync(base + lay.chain, 0, lay.zeroed, s);
  if (rc != cudaSuccess) return rc;
  commit_walk_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(
      static_cast<const int*>(best_len), static_cast<const int*>(window),
      static_cast<const int*>(ss), static_cast<const int*>(wnext),
      static_cast<const uint8_t*>(space), kind, (int)n, nv, base + lay.chain, visited, failed,
      record);
  if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
  const long long emit_tiles = tiles_of(n, kEmitTile);
  commit_emit_kernel<<<(unsigned)emit_tiles, kEmitThreads, 0, s>>>(
      static_cast<const int*>(best_id), kind, visited, failed, record, (int)n, unk_id,
      (int)tiles, (int)emit_tiles, base + lay.scan, out_ids, out_pos, out_count);
  if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
  commit_fill_kernel<<<flat, kFlatThreads, 0, s>>>(out_count, (int)n, out_ids, out_pos);
  return (int)cudaGetLastError();
}
