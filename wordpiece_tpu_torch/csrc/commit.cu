// The greedy commit, for Hopper (sm_90a): per-position matches to the
// compacted id stream.
//
// These kernels replace the XLA program
// wordpiece_tpu/ops/commit.py::commit_with_positions (its doubling rounds
// :82-99, the segment kill :105-112 and the output :118-126).  Together they
// compute the same function as the plain PyTorch version
// commit_with_positions_plain in ops/commit.py, whole outputs with the
// padding: ids int32[n] (-2 past count), positions int32[n] (-1 past
// count) and count, from best_id/best_len and the text features.
//
// The walk is the orbit of F(i) = ss[i + best_len[i]] on a match, else
// ss[wnext[min(i + window[i], n)]], from every unit start, found by
// pointer doubling in a round count fixed on the host
// (ops/commit.doubling_rounds); segments start at visited word-prefix
// positions, and a segment with a failed visited position emits one UNK
// at its start and nothing else.
//
// What bounds it on this card: device memory.  The compulsory traffic is
// best_id and best_len (8 bytes a position), ss, wnext and window (12),
// space and wp (2) read, ids and positions (8) written: 30 bytes a
// position, 377 MB at the 10 MB en bucket, 0.113 ms at 3.35 TB/s.  Each
// doubling round moves ~13 bytes a position more.  The plain version's
// scatter_reduce_(amax) sends every unvisited position into one dropped
// slot (and every matched one into another in the kill), contended
// atomics that took 52 ms at that bucket.  What this design does:
//  - commit_init_kernel: F and the seeds, one thread a position;
//  - commit_round_kernel, once a round: a visited position marks its jump
//    target with a plain byte store, nobody else writes, and no slot is
//    dropped; jump_next[i] = jump[jump[i]] through two buffers, with
//    jump[n] = n.  A mark is a round stamp (0 unvisited, r + 1 marked
//    before round r), so a position marked during round r does not mark in
//    round r itself and every round equals the plain version's: the
//    result is exact also when max_chain is below the longest chain;
//  - commit_segments_kernel: seg_id by a forward sum scan with decoupled
//    look-back (csrc/scan.cuh) of the visited word-prefix flags; a failed
//    visited position stores 1 into killed[seg_id];
//  - commit_emit_kernel: the emit flags from the kill table, a second
//    forward sum scan gives each emitting position its slot, where it
//    writes its id and position; the last tile writes count;
//  - commit_fill_kernel: -2 / -1 into the slots past count.
// Launches a call: rounds + 4, after one memset of the scans' status words
// and the kill table; nothing reads the card back.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

#include "scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr int kFlatThreads = 256;
using Scan = wp::TileScan<kThreads, 1, wp::SumOp, /*kReverse=*/false>;

long long tiles_of(long long n) { return n > 0 ? (n + kTile - 1) / kTile : 1; }
size_t round16(size_t b) { return (b + 15) & ~(size_t)15; }

// The scratch, in order: the round stamps uint8[n], two jump buffers
// int32[n + 1] (the first holds seg_id after the rounds), then the part
// zeroed before the launches: the two scans' words and killed uint8[n + 2].
struct Layout {
  size_t stamp, jump_a, jump_b, scan_a, scan_b, killed, zeroed, total;
  explicit Layout(long long n) {
    const long long tiles = tiles_of(n);
    stamp = 0;
    jump_a = round16((size_t)n);
    jump_b = jump_a + round16(4 * ((size_t)n + 1));
    scan_a = jump_b + round16(4 * ((size_t)n + 1));
    scan_b = scan_a + round16(wp::scan_scratch_bytes(1, tiles));
    killed = scan_b + round16(wp::scan_scratch_bytes(1, tiles));
    total = killed + round16((size_t)n + 2);
    zeroed = total - scan_a;
  }
};

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

__device__ __forceinline__ void load8(const int* p, bool whole, long long left, int (&v)[kItems]) {
  if (whole) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(p));
    const int4 b = __ldg(reinterpret_cast<const int4*>(p) + 1);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < kItems; ++e) v[e] = e < left ? __ldg(p + e) : 0;
  }
}

__global__ void __launch_bounds__(kFlatThreads)
    commit_init_kernel(const int* __restrict__ best_len, const int* __restrict__ window,
                       const int* __restrict__ ss, const int* __restrict__ wnext,
                       const uint8_t* __restrict__ space, int n, int n_valid,
                       uint8_t* __restrict__ stamp, int* __restrict__ jump_a,
                       int* __restrict__ jump_b) {
  const long long i = (long long)blockIdx.x * kFlatThreads + threadIdx.x;
  if (i == 0) {
    jump_a[n] = n;
    jump_b[n] = n;
  }
  if (i >= n) return;
  const int len = __ldg(best_len + i);
  int step;
  if (len > 0) {
    step = __ldg(ss + min(i + len, (long long)n));
  } else {
    // On failure: past the probe window, to the next word prefix, then
    // past spaces (src/fast.cpp:84-95).
    step = __ldg(ss + __ldg(wnext + min(i + __ldg(window + i), (long long)n)));
  }
  jump_a[i] = step;
  // Seeds: every unit start (a non-space after a space or at 0).
  const bool seed = i < n_valid && !__ldg(space + i) && (i == 0 || __ldg(space + i - 1));
  stamp[i] = seed ? 1 : 0;
}

// Round r: positions with 0 < stamp <= r + 1 were visited before it.
__global__ void __launch_bounds__(kFlatThreads)
    commit_round_kernel(const int* __restrict__ jump, int* __restrict__ jump_next,
                        uint8_t* stamp, int n, int r, int last) {
  const long long i = (long long)blockIdx.x * kFlatThreads + threadIdx.x;
  if (i >= n) return;
  const int j = jump[i];
  const uint8_t s = stamp[i];
  // Only visited positions write, and every writer of stamp[j] in this
  // round writes the same r + 2: a plain store, no atomic.  A stamp set
  // in an earlier round is never overwritten.
  if (s != 0 && s <= r + 1 && j < n && stamp[j] == 0) stamp[j] = (uint8_t)(r + 2);
  if (!last) jump_next[i] = jump[j];  // jump[n] = n
}

__global__ void __launch_bounds__(kThreads)
    commit_segments_kernel(const int* __restrict__ best_len, const uint8_t* __restrict__ wp,
                           const uint8_t* __restrict__ stamp, int n, int tiles, void* scan,
                           int* __restrict__ seg_id, uint8_t* __restrict__ killed) {
  __shared__ Scan::Storage storage;
  const int q = Scan::ticket(scan, storage);
  const long long base = (long long)q * kTile + (long long)threadIdx.x * kItems;
  const long long left = n - base;
  const bool whole = left >= kItems;
  const uint32_t visited = left > 0 ? load_bits(stamp + base, whole, left) : 0u;
  const uint32_t prefix = left > 0 ? load_bits(wp + base, whole, left) : 0u;
  int len[kItems];
  if (left > 0) load8(best_len + base, whole, left, len);
  const uint32_t starts = visited & prefix;
  const int mine[1] = {__popc(starts)};
  int excl[1], agg[1], before[1];
  Scan::block_scan(mine, excl, agg, storage);
  Scan::look_back(scan, tiles, q, agg, before, storage);
  if (left <= 0) return;
  int run = before[0] + excl[0], seg[kItems];
#pragma unroll
  for (int e = 0; e < kItems; ++e) {
    run += (starts >> e) & 1u;
    seg[e] = run;
    // Only failed visited positions write: every writer of a segment's
    // slot writes 1.
    if (((visited >> e) & 1u) && len[e] <= 0) killed[run] = 1;
  }
  if (whole) {
    int4* out = reinterpret_cast<int4*>(seg_id + base);
    out[0] = make_int4(seg[0], seg[1], seg[2], seg[3]);
    out[1] = make_int4(seg[4], seg[5], seg[6], seg[7]);
  } else {
#pragma unroll
    for (int e = 0; e < kItems; ++e)
      if (e < left) seg_id[base + e] = seg[e];
  }
}

__global__ void __launch_bounds__(kThreads)
    commit_emit_kernel(const int* __restrict__ best_id, const int* __restrict__ best_len,
                       const uint8_t* __restrict__ wp, const uint8_t* __restrict__ stamp,
                       const int* __restrict__ seg_id, const uint8_t* __restrict__ killed,
                       int n, int unk_id, int tiles, void* scan, int* __restrict__ ids,
                       int* __restrict__ positions, int* __restrict__ count) {
  __shared__ Scan::Storage storage;
  const int q = Scan::ticket(scan, storage);
  const long long base = (long long)q * kTile + (long long)threadIdx.x * kItems;
  const long long left = n - base;
  const bool whole = left >= kItems;
  uint32_t emit = 0;
  int val[kItems];
  if (left > 0) {
    const uint32_t visited = load_bits(stamp + base, whole, left);
    const uint32_t starts = visited & load_bits(wp + base, whole, left);
    int len[kItems], seg[kItems];
    load8(best_len + base, whole, left, len);
    load8(best_id + base, whole, left, val);
    load8(seg_id + base, whole, left, seg);
#pragma unroll
    for (int e = 0; e < kItems; ++e) {
      if (!((visited >> e) & 1u)) continue;
      const bool kill = __ldg(killed + seg[e]) != 0;
      const bool matched = len[e] > 0;
      if ((matched && !kill) || (((starts >> e) & 1u) && kill)) emit |= 1u << e;
      if (kill) val[e] = unk_id;
    }
  }
  const int mine[1] = {__popc(emit)};
  int excl[1], agg[1], before[1];
  Scan::block_scan(mine, excl, agg, storage);
  Scan::look_back(scan, tiles, q, agg, before, storage);
  int slot = before[0] + excl[0];
#pragma unroll
  for (int e = 0; e < kItems; ++e) {
    if ((emit >> e) & 1u) {
      ids[slot] = val[e];
      positions[slot] = (int)(base + e);
      ++slot;
    }
  }
  if (q == tiles - 1 && threadIdx.x == 0) *count = before[0] + agg[0];
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

// Zeroes the scan and kill part of `scratch` (16-byte aligned) and
// launches the commit on `stream`: rounds + 4 kernels over n positions
// (n + 2048 < INT_MAX).  best_id, best_len, window int32[n], ss, wnext
// int32[n + 1], space, wp bool[n], every one 16-byte aligned; ids and
// positions int32[n], count int32[1].  Returns a cudaError_t.
extern "C" int wp_commit(const void* best_id, const void* best_len, const void* window,
                         const void* ss, const void* wnext, const void* space, const void* wp,
                         long long n, long long n_valid, int unk_id, int rounds, void* scratch,
                         void* ids, void* positions, void* count, void* stream) {
  if (n < 0 || n + kTile >= INT_MAX || n_valid < 0 || rounds < 0 || rounds > 32)
    return cudaErrorInvalidValue;
  const Layout lay(n);
  const long long tiles = tiles_of(n);
  auto s = static_cast<cudaStream_t>(stream);
  auto* base = static_cast<uint8_t*>(scratch);
  auto* stamp = base + lay.stamp;
  auto* jump_a = reinterpret_cast<int*>(base + lay.jump_a);
  auto* jump_b = reinterpret_cast<int*>(base + lay.jump_b);
  void* scan_a = base + lay.scan_a;
  void* scan_b = base + lay.scan_b;
  auto* killed = base + lay.killed;
  const auto* bid = static_cast<const int*>(best_id);
  const auto* blen = static_cast<const int*>(best_len);
  const auto* kind = static_cast<const uint8_t*>(wp);
  auto* out_ids = static_cast<int*>(ids);
  auto* out_pos = static_cast<int*>(positions);
  auto* out_count = static_cast<int*>(count);
  const int nv = (int)(n_valid < n ? n_valid : n);  // seeds lie below both
  const unsigned flat = (unsigned)(n > 0 ? (n + kFlatThreads - 1) / kFlatThreads : 1);

  int rc = cudaMemsetAsync(base + lay.scan_a, 0, lay.zeroed, s);
  if (rc != cudaSuccess) return rc;
  commit_init_kernel<<<flat, kFlatThreads, 0, s>>>(
      blen, static_cast<const int*>(window), static_cast<const int*>(ss),
      static_cast<const int*>(wnext), static_cast<const uint8_t*>(space), (int)n, nv, stamp,
      jump_a, jump_b);
  if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
  int* cur = jump_a;
  int* next = jump_b;
  for (int r = 0; r < rounds; ++r) {
    commit_round_kernel<<<flat, kFlatThreads, 0, s>>>(cur, next, stamp, (int)n, r,
                                                      r + 1 == rounds);
    if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
    int* t = cur;
    cur = next;
    next = t;
  }
  // The jumps are spent: jump_a holds seg_id from here on.
  commit_segments_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(blen, kind, stamp, (int)n,
                                                              (int)tiles, scan_a, jump_a, killed);
  if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
  commit_emit_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(bid, blen, kind, stamp, jump_a, killed,
                                                          (int)n, unk_id, (int)tiles, scan_b,
                                                          out_ids, out_pos, out_count);
  if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
  commit_fill_kernel<<<flat, kFlatThreads, 0, s>>>(out_count, (int)n, out_ids, out_pos);
  return (int)cudaGetLastError();
}
