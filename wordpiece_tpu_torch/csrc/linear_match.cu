// The linear engine's match over the suffix array, for Hopper (sm_90a).
//
// These kernels replace the XLA program
// wordpiece_tpu/ops/linear_match.py::match_from_sa (:87): its four cummax
// sweeps (surviving_push :40, _lastkill :75) over [max_len, n] slot
// matrices, and the window-capped merge (:117-145).  They compute the same
// function as that program and as match_from_sa_plain in
// ops/linear_match.py, whole outputs, and write no [max_len, n] buffer to
// global memory.
//
// What they compute.
// Inputs: rank int32[n_s]; lcp int32[n_s], the LCP between ranks r and
// r+1; who_len, who_id, who_kind int32[n_s]; window int32[n_text] and wp
// bool[n_text].
// Per rank and length: take each direction d (left: ascending ranks, the
// edge entering r is lcp[r-1], with 1<<30 at r=0; right: descending ranks,
// the edge entering r is lcp[r], with 1<<30 at the last rank), each kind k
// (1 = prefix, 0 = suffix) and each length l = 1..max_len.  Then
//  - lastpush is the latest rank q at or before r, in the sweep's
//    direction, that pushes a token of kind k and length l; -1 if none;
//  - lastkill is the latest rank at or before r whose entering edge is
//    less than l; 0 if none, in the sweep's own coordinates (the right
//    sweep's coordinate of rank r is last - r, last = n_s - 1);
//  - the slot is lastpush if lastpush >= 0 && lastpush >= lastkill, and
//    -1 otherwise.
// Per text position t: r = rank[min(t, n_s-1)] and k = wp[t] ? 1 : 0.
//  - L_d is the largest l <= window[t] whose slot is >= 0 in direction d,
//    or 0 if none;
//  - best_len = max(L_left, L_right);
//  - q is the right sweep's slot, converted back to a true rank, when
//    L_right == best_len > 0; otherwise q is the left sweep's slot;
//  - best_id = who_id[q], or -1 when best_len == 0.
// Every one of the n_text positions is written.  This cap-then-merge form
// equals the JAX merge: a right slot exists at the best length exactly
// when L_right is that length, and there the right slot wins.
// Preconditions (every caller's inputs meet them): n_text <= n_s, rank a
// permutation of 0..n_s-1, 1 <= max_len <= kMaxLen = 96, the engine's
// MAX_SLOT_LEN (it routes vocabularies with longer tokens to the host).
//
// What bounds it on this card: latency, not bytes.  The function must read
// lcp, who_len and who_kind at every rank (12 bytes a rank), rank, window
// and wp at the text positions (9 bytes a text position) and who_id only
// at the slots it picks, and write the two outputs (8 bytes a text
// position): at the linear en first batch's shapes about 2.3 MB, under a
// microsecond at 3.35 TB/s.
// The work is a scan of 2 * max_len running maxima (push positions by
// kind, kill positions) along each direction, each carried across the
// whole rank order.  The design keeps every length's state in registers
// and shared memory and moves only 6 * max_len int32 a tile between its
// kernels:
//  - sa_match_tiles_kernel, one block a tile of kTile ranks: the inverse
//    map text_at[rank[t]] = t, and the tile's aggregates, for each
//    direction and length the latest push position of each kind and the
//    latest kill position in the tile (-1 if none): pushes by shared
//    atomics, kills by one shared atomic for each rank whose edge is below
//    every later edge of its warp, then a prefix max over edge values;
//  - sa_match_carry_kernel: each column of those aggregates (direction,
//    part, length) scanned over the tiles in its sweep's order into the
//    exclusive carry that enters each tile (pushes seeded -1, kills 0); a
//    block takes 32 columns and splits the tiles into 32 segments;
//  - sa_match_walk_kernel, one block a tile: each rank's edges, push and
//    text position (window, kind) packed into one word in shared memory;
//    each warp takes (direction, length) tasks: its 32 lanes walk 16
//    ranks each in the sweep's order, a warp max scan between the lanes,
//    seeded with the tile's carry, and every text rank whose window
//    reaches the length keeps the largest (length, direction, slot) by a
//    64-bit shared atomic max, so the longest length wins and, at equal
//    length, the right sweep.  A length no rank of the tile reaches, or
//    with no push in the tile and no carried push alive, is skipped.  Then
//    each text rank writes (who_id[q], best_len) at its text position.
// Launches a call: 3, after one memset (text_at); nothing reads the card
// back.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kChunk = 16;          // ranks a lane walks in a task
constexpr int kTile = 32 * kChunk;  // ranks a block: one warp covers a tile
constexpr int kThreads = kTile;     // one rank a thread outside the walk
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLen = 96;         // MAX_SLOT_LEN; a length fits 7 bits of the rank word
constexpr int kEdgeNone = 255;      // a clamped edge: kills no length
constexpr int kParts = 3;           // push of kind 0, push of kind 1, kill
constexpr int kCarryCols = 32;      // carry columns a block, one a lane
constexpr int kCarrySegs = 32;      // tile segments a carry block

// The rank word: bits 0-7 the left edge, 8-15 the right edge (both clamped
// to 0..kEdgeNone), 16-22 the pushed length (0 none), 23 its kind, 24-30
// the text position's window clamped to 0..max_len (0 for a rank with no
// text position), 31 its kind.
__device__ __forceinline__ int clamp_edge(int e) {
  return e < 0 ? 0 : (e > kEdgeNone ? kEdgeNone : e);
}

struct RankIn {
  int left, right, len, kind;
};

// Rank r's edges in both sweeps and its push (len 0: none); a rank past
// n_s has neither.
__device__ __forceinline__ RankIn rank_in(const int* __restrict__ lcp,
                                          const int* __restrict__ who_len,
                                          const int* __restrict__ who_kind, int r, int n_s,
                                          int ml) {
  RankIn in{kEdgeNone, kEdgeNone, 0, 0};
  if (r >= n_s) return in;
  in.left = r == 0 ? kEdgeNone : clamp_edge(lcp[r - 1]);
  in.right = r == n_s - 1 ? kEdgeNone : clamp_edge(lcp[r]);
  const int k = who_kind[r], len = who_len[r];
  if ((k == 0 || k == 1) && len >= 1 && len <= ml) {
    in.len = len;
    in.kind = k;
  }
  return in;
}

__global__ void __launch_bounds__(kThreads)
    sa_match_tiles_kernel(const int* __restrict__ rank, const int* __restrict__ lcp,
                          const int* __restrict__ who_len, const int* __restrict__ who_kind,
                          int n_s, int n_text, int ml, int* __restrict__ text_at,
                          int* __restrict__ agg) {
  __shared__ int s_push[2][2][kMaxLen];  // [direction][kind][l - 1]
  __shared__ int s_kill_at[2][kMaxLen];  // [direction][edge], edges below ml
  const int tid = threadIdx.x, lane = tid & 31;
  for (int i = tid; i < 2 * 2 * kMaxLen; i += kThreads) (&s_push[0][0][0])[i] = -1;
  for (int i = tid; i < 2 * kMaxLen; i += kThreads) (&s_kill_at[0][0])[i] = -1;
  const long long t = (long long)blockIdx.x * kTile + tid;  // n_text <= n_s: tiles cover it
  if (t < n_text) {
    const int r = rank[t];
    if (r >= 0 && r < n_s) text_at[r] = (int)t;
  }
  __syncthreads();

  const int last = n_s - 1;
  const int r = blockIdx.x * kTile + tid;
  const RankIn in = rank_in(lcp, who_len, who_kind, r, n_s, ml);
  if (in.len) {
    atomicMax(&s_push[0][in.kind][in.len - 1], r);
    atomicMax(&s_push[1][in.kind][in.len - 1], last - r);
  }
  // A rank is the latest kill of some length in its tile only if its edge
  // is below every edge after it in its sweep's order; within the warp,
  // only such ranks post.  Left: later ranks are higher lanes.
  int after = in.left;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_down_sync(~0u, after, d);
    if (lane + d < 32) after = min(after, o);
  }
  after = __shfl_down_sync(~0u, after, 1);
  if (lane == 31) after = kEdgeNone + 1;
  if (in.left < ml && in.left < after) atomicMax(&s_kill_at[0][in.left], r);
  // Right: the sweep descends, so later ranks are lower lanes.
  int before = in.right;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(~0u, before, d);
    if (lane >= d) before = min(before, o);
  }
  before = __shfl_up_sync(~0u, before, 1);
  if (lane == 0) before = kEdgeNone + 1;
  if (in.right < ml && in.right < before) atomicMax(&s_kill_at[1][in.right], last - r);
  __syncthreads();

  // The tile's aggregates, [direction][part][l - 1]: the kill of length l
  // is the latest position whose edge is below l.
  int* out = agg + (long long)blockIdx.x * 2 * kParts * ml;
  for (int i = tid; i < 2 * ml; i += kThreads) {
    const int dir = i / ml, l = i - dir * ml + 1;
    int kill = -1;
    for (int e = 0; e < l; ++e) kill = max(kill, s_kill_at[dir][e]);
    int* o = out + dir * kParts * ml;
    o[l - 1] = s_push[dir][0][l - 1];
    o[ml + l - 1] = s_push[dir][1][l - 1];
    o[2 * ml + l - 1] = kill;
  }
}

// Column c of the aggregates (c = direction * 3 ml + part * ml + l - 1),
// scanned over the tiles in its sweep's order (the right sweep takes the
// tiles last to first): carry[tile][c] is the max of the aggregates of
// the tiles before, seeded -1 for pushes and 0 for kills.
__global__ void __launch_bounds__(kCarryCols* kCarrySegs)
    sa_match_carry_kernel(const int* __restrict__ agg, int* __restrict__ carry, int tiles,
                          int ml) {
  __shared__ int s_seg[kCarrySegs][kCarryCols + 1];
  const int lane = threadIdx.x % kCarryCols, seg = threadIdx.x / kCarryCols;
  const int cols = 2 * kParts * ml;
  const int c = blockIdx.x * kCarryCols + lane;
  const bool live = c < cols;
  const int dir = live ? c / (kParts * ml) : 0;
  const int seed = c - dir * kParts * ml < 2 * ml ? -1 : 0;
  const int per = (tiles + kCarrySegs - 1) / kCarrySegs;
  const int a = min(seg * per, tiles), b = min(a + per, tiles);
  int m = -1;
  if (live) {
#pragma unroll 4
    for (int i = a; i < b; ++i) {
      const int tile = dir == 0 ? i : tiles - 1 - i;
      m = max(m, agg[(long long)tile * cols + c]);
    }
  }
  s_seg[seg][lane] = m;
  __syncthreads();
  int run = seed;
  for (int s = 0; s < seg; ++s) run = max(run, s_seg[s][lane]);
  if (!live) return;
#pragma unroll 4
  for (int i = a; i < b; ++i) {
    const long long at = (long long)(dir == 0 ? i : tiles - 1 - i) * cols + c;
    const int v = agg[at];
    carry[at] = run;
    run = max(run, v);
  }
}

// One (direction, length) task of a warp over the block's tile: lane i
// walks chunk i (left) or 31 - i (right), kChunk ranks in the sweep's
// order, twice: once for its chunk's latest pushes and kill, then, after
// a warp max scan seeded with the tile's carry, for each rank's slot.
__device__ __forceinline__ void walk_length(const uint32_t* __restrict__ s_word,
                                            unsigned long long* __restrict__ s_best, int lane,
                                            int dir, int l, int tile0, int last, int c0, int c1,
                                            int ck) {
  const int chunk = dir ? 31 - lane : lane;
  const uint32_t* words = s_word + chunk * (kChunk + 1);
  const int first = tile0 + chunk * kChunk;
  const int shift = dir ? 8 : 0;
  int p0 = -1, p1 = -1, k = -1;
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    const int i = dir ? kChunk - 1 - j : j;
    const uint32_t w = words[i];
    const int pos = dir ? last - (first + i) : first + i;
    if ((int)((w >> 16) & 127) == l) {
      if ((w >> 23) & 1)
        p1 = pos;
      else
        p0 = pos;
    }
    if ((int)((w >> shift) & 255) < l) k = pos;
  }
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int a0 = __shfl_up_sync(~0u, p0, d), a1 = __shfl_up_sync(~0u, p1, d);
    const int ak = __shfl_up_sync(~0u, k, d);
    if (lane >= d) {
      p0 = max(p0, a0);
      p1 = max(p1, a1);
      k = max(k, ak);
    }
  }
  int x0 = __shfl_up_sync(~0u, p0, 1), x1 = __shfl_up_sync(~0u, p1, 1);
  int xk = __shfl_up_sync(~0u, k, 1);
  if (lane == 0) x0 = x1 = xk = -1;
  p0 = max(c0, x0);
  p1 = max(c1, x1);
  k = max(ck, xk);
  const unsigned long long tag = (unsigned long long)l << 33 | (unsigned long long)dir << 32;
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    const int i = dir ? kChunk - 1 - j : j;
    const uint32_t w = words[i];
    const int pos = dir ? last - (first + i) : first + i;
    if ((int)((w >> 16) & 127) == l) {
      if ((w >> 23) & 1)
        p1 = pos;
      else
        p0 = pos;
    }
    if ((int)((w >> shift) & 255) < l) k = pos;
    if ((int)((w >> 24) & 127) >= l) {
      const int q = (w >> 31) ? p1 : p0;
      unsigned long long* best = s_best + chunk * (kChunk + 1) + i;
      const unsigned long long key = tag | (unsigned)q;
      // The plain read races with other warps' atomics, harmlessly: a key
      // only grows, so a stale read costs at most one atomicMax that
      // changes nothing.
      if (q >= 0 && q >= k && key > *best) atomicMax(best, key);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    sa_match_walk_kernel(const int* __restrict__ lcp, const int* __restrict__ who_len,
                         const int* __restrict__ who_id, const int* __restrict__ who_kind,
                         const int* __restrict__ window, const uint8_t* __restrict__ wp,
                         const int* __restrict__ text_at, const int* __restrict__ carry, int n_s,
                         int ml, int* __restrict__ best_id, int* __restrict__ best_len) {
  // Lane i's chunk of words starts at (kChunk + 1) * i: no bank conflict.
  __shared__ uint32_t s_word[kTile + 32];
  // (length, direction, slot) of each rank, padded as s_word.
  __shared__ unsigned long long s_best[kTile + 32];
  __shared__ int s_carry[2 * kParts * kMaxLen];
  __shared__ uint32_t s_pushed[(kMaxLen + 31) / 32];  // bit l - 1: a push of length l
  __shared__ int s_maxwin;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile0 = blockIdx.x * kTile;
  const int last = n_s - 1;
  const int cols = 2 * kParts * ml;
  if (tid < (kMaxLen + 31) / 32) s_pushed[tid] = 0;
  if (tid == 0) s_maxwin = 0;
  for (int i = tid; i < cols; i += kThreads) s_carry[i] = carry[(long long)blockIdx.x * cols + i];

  const int r = tile0 + tid;
  const RankIn in = rank_in(lcp, who_len, who_kind, r, n_s, ml);
  const int t = r < n_s ? text_at[r] : -1;
  int win = 0, tkind = 0;
  if (t >= 0) {
    const int w = window[t];
    win = w < 0 ? 0 : (w > ml ? ml : w);
    tkind = wp[t] != 0;
  }
  s_word[tid + tid / kChunk] = (uint32_t)in.left | (uint32_t)in.right << 8 |
                               (uint32_t)in.len << 16 | (uint32_t)in.kind << 23 |
                               (uint32_t)win << 24 | (uint32_t)tkind << 31;
  s_best[tid + tid / kChunk] = 0;
  __syncthreads();  // the flags are zero
  const int wmax = __reduce_max_sync(~0u, win);
  if (lane == 0 && wmax) atomicMax(&s_maxwin, wmax);
#pragma unroll
  for (int b = 0; b < (kMaxLen + 31) / 32; ++b) {
    const bool mine = in.len && (in.len - 1) >> 5 == b;
    const uint32_t any = __reduce_or_sync(~0u, mine ? 1u << ((in.len - 1) & 31) : 0u);
    if (lane == 0 && any) atomicOr(&s_pushed[b], any);
  }
  __syncthreads();

  const int maxwin = s_maxwin;
  for (int task = warp; task < 2 * ml; task += kWarps) {
    const int dir = task & 1, l = (task >> 1) + 1;
    if (l > maxwin) break;  // a warp's lengths ascend
    const int* cr = s_carry + dir * kParts * ml;
    const int c0 = cr[l - 1], c1 = cr[ml + l - 1], ck = cr[2 * ml + l - 1];
    const bool pushed = (s_pushed[(l - 1) >> 5] >> ((l - 1) & 31)) & 1u;
    if (!pushed && !(c0 >= 0 && c0 >= ck) && !(c1 >= 0 && c1 >= ck)) continue;
    walk_length(s_word, s_best, lane, dir, l, tile0, last, c0, c1, ck);
  }
  __syncthreads();

  if (t >= 0) {
    const unsigned long long key = s_best[tid + tid / kChunk];
    const int len = (int)(key >> 33);
    int id = -1;
    if (len) {
      const int q = (int)(key & 0xffffffffu);
      id = who_id[(key >> 32) & 1 ? last - q : q];
    }
    best_len[t] = len;
    best_id[t] = id;
  }
}

long long tiles_of(long long n_s) { return (n_s + kTile - 1) / kTile; }

size_t align16(size_t b) { return (b + 15) & ~size_t(15); }

// Scratch: text_at int32[n_s], then the aggregates and the carries, each
// int32[tiles * 6 * max_len].
struct Layout {
  size_t text_at = 0, agg = 0, carry = 0, total = 0;
  Layout(long long n_s, int ml) {
    const size_t cols = (size_t)tiles_of(n_s) * 2 * kParts * ml * sizeof(int);
    agg = align16((size_t)n_s * sizeof(int));
    carry = agg + align16(cols);
    total = carry + align16(cols);
  }
};

}  // namespace

extern "C" long long wp_linear_match_scratch_bytes(long long n_s, int max_len) {
  return n_s < 1 || max_len < 1 || max_len > kMaxLen ? -1 : (long long)Layout(n_s, max_len).total;
}

// Fills text_at with -1 and launches the match on `stream`: 3 kernels.
// rank, lcp, who_len, who_id, who_kind int32[n_s]; window int32[n_text];
// wp bool[n_text]; best_id, best_len int32[n_text]; scratch of
// wp_linear_match_scratch_bytes(n_s, max_len) bytes, 16-byte aligned.
// Needs 1 <= n_s, n_s + kTile < INT_MAX, 0 <= n_text <= n_s and
// 1 <= max_len <= kMaxLen.  Returns a cudaError_t.
extern "C" int wp_linear_match(const void* rank, const void* lcp, const void* who_len,
                               const void* who_id, const void* who_kind, const void* window,
                               const void* wp, long long n_s, long long n_text, int max_len,
                               void* scratch, void* best_id, void* best_len, void* stream) {
  if (n_s < 1 || n_s + kTile >= INT_MAX || n_text < 0 || n_text > n_s || max_len < 1 ||
      max_len > kMaxLen)
    return cudaErrorInvalidValue;
  const Layout lay(n_s, max_len);
  const long long tiles = tiles_of(n_s);
  auto s = static_cast<cudaStream_t>(stream);
  auto* base = static_cast<uint8_t*>(scratch);
  auto* text_at = reinterpret_cast<int*>(base + lay.text_at);
  auto* agg = reinterpret_cast<int*>(base + lay.agg);
  auto* carry = reinterpret_cast<int*>(base + lay.carry);
  const auto* i_lcp = static_cast<const int*>(lcp);
  const auto* i_len = static_cast<const int*>(who_len);
  const auto* i_kind = static_cast<const int*>(who_kind);

  int rc = cudaMemsetAsync(text_at, 0xff, (size_t)n_s * sizeof(int), s);
  if (rc != cudaSuccess) return rc;
  sa_match_tiles_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(
      static_cast<const int*>(rank), i_lcp, i_len, i_kind, (int)n_s, (int)n_text, max_len,
      text_at, agg);
  if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
  const int cols = 2 * kParts * max_len;
  sa_match_carry_kernel<<<(unsigned)((cols + kCarryCols - 1) / kCarryCols),
                          kCarryCols * kCarrySegs, 0, s>>>(agg, carry, (int)tiles, max_len);
  if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
  sa_match_walk_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(
      i_lcp, i_len, static_cast<const int*>(who_id), i_kind, static_cast<const int*>(window),
      static_cast<const uint8_t*>(wp), text_at, carry, (int)n_s, max_len,
      static_cast<int*>(best_id), static_cast<int*>(best_len));
  return (int)cudaGetLastError();
}
