// The linear engine's match over the suffix array, for Hopper (sm_90a).
//
// These kernels replace the XLA program
// wordpiece_tpu/ops/linear_match.py::match_from_sa (:87): its four cummax
// sweeps (surviving_push :40, _lastkill :75) over [max_len, n] slot
// matrices, and the window-capped merge (:117-145).  They compute the same
// function as that program and as match_from_sa_plain in
// ops/linear_match.py, whole outputs, and write no [max_len, n] buffer.
//
// What they compute.
// Inputs: rank int32[n_s]; lcp int32[n_s], the LCP between ranks r and
// r+1; who_len, who_id, who_kind int32[n_s]; window int32[n_text] and wp
// bool[n_text].  Two sweeps over the ranks: left ascending, where the edge
// entering r is lcp[r-1] (none at r = 0), and right descending, where it
// is lcp[r] (none at the last rank).  A rank pushes (kind, length) when
// who_kind is 0 (suffix) or 1 (prefix) and 1 <= who_len <= max_len.
// In JAX terms, for each sweep, kind k and length l, the slot at a rank is
// lastpush (the latest rank at or before it, in the sweep's order, that
// pushed (k, l)) when lastpush >= lastkill (the latest rank whose entering
// edge is below l), and empty otherwise.  Per text position t, with
// r = rank[t] and k = wp[t]:
//  - L_d is the largest l <= window[t] whose slot at r is not empty in
//    sweep d, or 0;
//  - best_len = max(L_left, L_right);
//  - q is the right sweep's slot when L_right == best_len > 0 (the right
//    sweep wins ties), else the left sweep's;
//  - best_id = who_id[q], or -1 when best_len == 0.
// Every one of the n_text positions is written.  Preconditions (every
// caller's inputs meet them): n_text <= n_s, rank a permutation of
// 0..n_s-1, 1 <= max_len <= kMaxLen = 96, the engine's MAX_SLOT_LEN (it
// routes vocabularies with longer tokens to the host).
//
// The bitset form.  The lengths whose slot is not empty at a rank are the
// reference's get_closest stack (src/linear.cpp:161-213): surviving
// tokens are nested prefixes of the current suffix, so the stack is a set
// of lengths, at most 96: W = ceil(max_len / 32) 32-bit words a kind
// (bit l - 1 for length l).  One rank step, with entering edge e, is
//     S_k = (S_k & low(e)) | push_k,    low(e) = the lengths 1..e,
// the kill before the push, so a push survives its own edge: lastpush >=
// lastkill holds with equality when both are this rank.  A length l stays
// in S_k exactly while no edge below l has entered since its latest push,
// which is JAX's condition.  A text rank reads L_d = the highest bit of
// S_k & low(window), and q = the latest push of (k, L_d), which survives
// because any push of that length does (surviving_push's docstring).
//
// The summary operator.  A run of ranks acts on S as S -> (S & low(E)) |
// M: E the least entering edge of the run, M_0, M_1 its sets at its end
// starting from none.  A then B is (min(E_A, E_B), (M_A & low(E_B)) | M_B),
// associative, with identity (kEdgeNone, 0, 0).  It combines ranks across
// a warp by a 5-step shuffle scan, warps across a tile in shared memory,
// and tiles by the carry: 1 + 2W words a direction.
//
// The kernels, one rank a thread, kTile ranks a block:
//  - sa_match_tiles_kernel: the inverse map text[rank[t]] = (t, window,
//    kind) for every t < n_s (-1 past n_text: no memset), and each tile's
//    summary in both sweeps and its latest push of each (kind, length) in
//    each sweep (its highest and its lowest pushing rank);
//  - sa_match_carry_kernel: those scanned over the tiles in each sweep's
//    order (the summaries by the operator, the pushes by max) into the
//    exclusive carry that enters each tile;
//  - sa_match_walk_kernel: each rank's set after its own step in both
//    sweeps (the tile's carry, the earlier warps, the warp scan), the
//    text rank's L_left and L_right from those registers, and q for the
//    winning sweep only: from a bit row of the tile's pushes of (k, L)
//    (one bit a rank, one word a warp, a word of non-empty words a row)
//    or, where the tile has none on that side, from the carry.  No
//    atomics, no loop over lengths: a rank's work is O(W).
// Launches a call: 3, no memset; nothing reads the card back.
//
// What bounds it on this card: latency, not bytes.  The function must read
// lcp, who_len and who_kind at every rank, rank, window and wp at the
// text positions and who_id at the slots it picks, and write the two
// outputs: at the linear en first batch's shapes about 2.3 MB, under a
// microsecond at 3.35 TB/s.  The call is three dependent launches of a
// few hundred blocks each, each a chain of global loads, block barriers
// and shuffles; the tiles' summaries and push tables (7 + 2 max_len int32
// a tile and direction, written, scanned and read once) are the only
// state between them.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kTile = 512;          // ranks a block, one a thread
constexpr int kThreads = kTile;
constexpr int kWarps = kThreads / 32;
constexpr int kRowWords = kTile / 32;  // words of a push bit row: one a warp
constexpr int kMaxLen = 96;         // MAX_SLOT_LEN: three 32-bit words a kind
constexpr int kEdgeNone = 255;      // a clamped edge: kills no length
constexpr int kSumWords = 7;        // a summary in global memory: E, 3 words a kind
constexpr int kCarryCols = 32;      // push columns a carry block, one a lane
constexpr int kCarrySegs = 32;      // tile segments a carry block, one a warp
constexpr int kCarryThreads = kCarryCols * kCarrySegs;
constexpr int kCarryCache = 8;      // a segment's first pushes kept in registers

__device__ __forceinline__ int clamp_edge(int e) {
  return e < 0 ? 0 : (e > kEdgeNone ? kEdgeNone : e);
}

// Word i of low(e): the lengths 32i + 1 .. min(e, 32i + 32), the low
// min(e - 32i, 32) bits (the funnel shift clamps at 32).
__device__ __forceinline__ uint32_t low_word(int e, int i) {
  return __funnelshift_lc(~0u, 0u, max(e - 32 * i, 0));
}

// A run of ranks: its least entering edge and its sets of surviving
// lengths by kind, starting from none.
template <int W>
struct Sum {
  int e;
  uint32_t m[2][W];
};

template <int W>
__device__ __forceinline__ Sum<W> identity() {
  Sum<W> s;
  s.e = kEdgeNone;
#pragma unroll
  for (int i = 0; i < W; ++i) s.m[0][i] = s.m[1][i] = 0;
  return s;
}

// a then b.
template <int W>
__device__ __forceinline__ Sum<W> combine(const Sum<W>& a, const Sum<W>& b) {
  Sum<W> c;
  c.e = min(a.e, b.e);
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const uint32_t keep = low_word(b.e, i);
    c.m[0][i] = (a.m[0][i] & keep) | b.m[0][i];
    c.m[1][i] = (a.m[1][i] & keep) | b.m[1][i];
  }
  return c;
}

// The sets S after the run s.
template <int W>
__device__ __forceinline__ void apply(uint32_t (&S)[2][W], const Sum<W>& s) {
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const uint32_t keep = low_word(s.e, i);
    S[0][i] = (S[0][i] & keep) | s.m[0][i];
    S[1][i] = (S[1][i] & keep) | s.m[1][i];
  }
}

template <int W, bool kUp>
__device__ __forceinline__ Sum<W> shfl(const Sum<W>& s, int d) {
  Sum<W> o;
  o.e = kUp ? __shfl_up_sync(~0u, s.e, d) : __shfl_down_sync(~0u, s.e, d);
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int i = 0; i < W; ++i)
      o.m[k][i] = kUp ? __shfl_up_sync(~0u, s.m[k][i], d) : __shfl_down_sync(~0u, s.m[k][i], d);
  return o;
}

// Inclusive scan over the warp in the left sweep's order (lane 0 first):
// lane 31 ends with the warp's summary.
template <int W>
__device__ __forceinline__ Sum<W> scan_left(Sum<W> s, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Sum<W> o = shfl<W, true>(s, d);
    if (lane >= d) s = combine(o, s);
  }
  return s;
}

// The same in the right sweep's order (lane 31 first): lane 0 ends with it.
template <int W>
__device__ __forceinline__ Sum<W> scan_right(Sum<W> s, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Sum<W> o = shfl<W, false>(s, d);
    if (lane + d < 32) s = combine(o, s);
  }
  return s;
}

// Lane j < n holding item j of a run of n summaries (the other lanes any
// value): lane j gets the items before j composed, in the left order
// (item 0 first) or the right one (item n - 1 first).
template <int W>
__device__ __forceinline__ Sum<W> exclusive(Sum<W> s, int lane, int n, bool right) {
  if (lane >= n) s = identity<W>();
  if (right) {
    s = scan_right(s, lane);
    s = shfl<W, false>(s, 1);  // lane n - 1 gets lane n's identity
  } else {
    s = scan_left(s, lane);
    s = shfl<W, true>(s, 1);
    if (lane == 0) s = identity<W>();
  }
  return s;
}

template <int W>
__device__ __forceinline__ Sum<W> load_sum(const int* __restrict__ p) {
  Sum<W> s;
  s.e = p[0];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    s.m[0][i] = (uint32_t)p[1 + i];
    s.m[1][i] = (uint32_t)p[4 + i];
  }
  return s;
}

template <int W>
__device__ __forceinline__ void store_sum(int* __restrict__ p, const Sum<W>& s) {
  p[0] = s.e;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    p[1 + i] = i < W ? (int)s.m[0][i] : 0;
    p[4 + i] = i < W ? (int)s.m[1][i] : 0;
  }
}

// A rank's entering edges in both sweeps (clamped to 0..kEdgeNone) and its
// push (len 0: none); a rank past n_s has neither.
struct Rank {
  int left, right, len, kind;
};

__device__ __forceinline__ Rank rank_in(const int* __restrict__ lcp,
                                        const int* __restrict__ who_len,
                                        const int* __restrict__ who_kind, int r, int n_s, int ml) {
  Rank in{kEdgeNone, kEdgeNone, 0, 0};
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

// The one-rank run of `in` in a sweep with entering edge e.
template <int W>
__device__ __forceinline__ Sum<W> rank_sum(const Rank& in, int e) {
  Sum<W> s = identity<W>();
  s.e = e;
  const int b = in.len - 1;  // kind selected without indexing: no local memory
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const uint32_t bit = in.len && b >> 5 == i ? 1u << (b & 31) : 0u;
    s.m[0][i] = in.kind ? 0u : bit;
    s.m[1][i] = in.kind ? bit : 0u;
  }
  return s;
}

// The tile's push bit rows, word-major: s_bits[w * rows + row], row =
// kind * ml + len - 1, bit j of word w set when rank 32w + j of the tile
// pushes (kind, len).  The lowest lane of each warp's group of equal
// pushes writes the group's lanes; the caller has zeroed the rows.
__device__ __forceinline__ void post_push_bits(uint32_t* __restrict__ s_bits, const Rank& in,
                                               int ml, int rows, int lane, int warp) {
  const int key = in.len ? in.kind * kMaxLen + in.len : -1;
  const uint32_t same = __match_any_sync(~0u, key);
  if (in.len && __ffs(same) - 1 == lane) s_bits[warp * rows + in.kind * ml + in.len - 1] = same;
}

template <int W>
__global__ void __launch_bounds__(kThreads)
    sa_match_tiles_kernel(const int* __restrict__ rank, const int* __restrict__ window,
                          const uint8_t* __restrict__ wp, const int* __restrict__ lcp,
                          const int* __restrict__ who_len, const int* __restrict__ who_kind,
                          int n_s, int n_text, int ml, int2* __restrict__ text,
                          int* __restrict__ agg) {
  __shared__ uint32_t s_bits[kRowWords * 2 * kMaxLen];
  __shared__ Sum<W> s_warp[2][kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile0 = blockIdx.x * kTile, rows = 2 * ml, last = n_s - 1;
  for (int i = tid; i < kRowWords * rows; i += kThreads) s_bits[i] = 0;

  // The inverse map: position t names rank[t]; every rank is named once,
  // so positions past n_text write the ranks that have no text position.
  const int t = tile0 + tid;
  if (t < n_s) {
    const int q = rank[t];
    int2 v = make_int2(-1, 0);
    if (t < n_text) {
      const int w = window[t];
      v = make_int2(t, (w < 0 ? 0 : (w > ml ? ml : w)) | (wp[t] ? 128 : 0));
    }
    if (q >= 0 && q < n_s) text[q] = v;
  }
  const Rank in = rank_in(lcp, who_len, who_kind, tile0 + tid, n_s, ml);
  __syncthreads();  // the rows are zero

  post_push_bits(s_bits, in, ml, rows, lane, warp);
  const Sum<W> sl = scan_left(rank_sum<W>(in, in.left), lane);
  const Sum<W> sr = scan_right(rank_sum<W>(in, in.right), lane);
  if (lane == 31) s_warp[0][warp] = sl;
  if (lane == 0) s_warp[1][warp] = sr;
  __syncthreads();

  const int cols = kSumWords + rows;
  int* out = agg + (long long)blockIdx.x * 2 * cols;
  if (tid < rows) {
    // The row's latest push in each sweep: its highest and lowest rank.
    int hi = -1, lo = -1;
#pragma unroll
    for (int w = 0; w < kRowWords; ++w) {
      const uint32_t b = s_bits[w * rows + tid];
      if (b) {
        hi = 32 * w + 31 - __clz(b);
        if (lo < 0) lo = 32 * w + __ffs(b) - 1;
      }
    }
    out[kSumWords + tid] = hi < 0 ? -1 : tile0 + hi;
    out[cols + kSumWords + tid] = lo < 0 ? -1 : last - (tile0 + lo);
  }
  if (warp == 0) {  // the tile's summaries: its warps composed in each sweep
    const Sum<W> l = scan_left(lane < kWarps ? s_warp[0][lane] : identity<W>(), lane);
    const Sum<W> r = scan_right(lane < kWarps ? s_warp[1][lane] : identity<W>(), lane);
    if (lane == 31) store_sum(out, l);
    if (lane == 0) store_sum(out + cols, r);
  }
}

// The tiles' aggregates scanned over the tiles in each sweep's order (the
// right sweep takes them last to first) into exclusive carries, same
// layout: [tile][direction][kSumWords + 2 ml].  Blocks 0 and 1 scan the
// summaries of the left and the right sweep by the operator: a segment of
// tiles a thread, then the warp scan and the warps' summaries scanned by
// warp 0.  Each later block scans 32 push columns by max, seeded -1: a
// segment of tiles a warp, its first kCarryCache values kept in registers.
template <int W>
__global__ void __launch_bounds__(kCarryThreads)
    sa_match_carry_kernel(const int* __restrict__ agg, int* __restrict__ carry, int tiles,
                          int ml) {
  __shared__ int s_seg[kCarrySegs][kCarryCols + 1];
  __shared__ Sum<W> s_warp[kCarryThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cols = kSumWords + 2 * ml;

  if (blockIdx.x < 2) {
    const int dir = blockIdx.x;
    const int per = (tiles + kCarryThreads - 1) / kCarryThreads;
    const int a = min(tid * per, tiles), b = min(a + per, tiles);
    Sum<W> s = identity<W>();
    for (int i = a; i < b; ++i) {
      const int tile = dir ? tiles - 1 - i : i;
      s = combine(s, load_sum<W>(agg + ((long long)tile * 2 + dir) * cols));
    }
    const Sum<W> before = exclusive(s, lane, 32, false);  // this warp's earlier threads
    const Sum<W> incl = combine(before, s);
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const Sum<W> w = exclusive(s_warp[lane], lane, kCarryThreads / 32, false);
      __syncwarp();
      s_warp[lane] = w;
    }
    __syncthreads();
    Sum<W> run = combine(s_warp[warp], before);
    for (int i = a; i < b; ++i) {
      const long long at = ((long long)(dir ? tiles - 1 - i : i) * 2 + dir) * cols;
      const Sum<W> v = load_sum<W>(agg + at);
      store_sum(carry + at, run);
      run = combine(run, v);
    }
    return;
  }

  const int per = (tiles + kCarrySegs - 1) / kCarrySegs;
  const int a = min(warp * per, tiles), b = min(a + per, tiles);
  const int c = (blockIdx.x - 2) * kCarryCols + lane;  // dir * 2 ml + row
  const bool live = c < 4 * ml;
  const int dir = live ? c / (2 * ml) : 0;
  const int col = kSumWords + (c - dir * 2 * ml);
  auto at = [&](int i) { return ((long long)(dir ? tiles - 1 - i : i) * 2 + dir) * cols + col; };
  int cache[kCarryCache];
  int m = -1;
#pragma unroll
  for (int j = 0; j < kCarryCache; ++j) {
    cache[j] = live && a + j < b ? agg[at(a + j)] : -1;
    m = max(m, cache[j]);
  }
  if (live)
    for (int i = a + kCarryCache; i < b; ++i) m = max(m, agg[at(i)]);
  s_seg[warp][lane] = m;
  __syncthreads();
  int run = -1;
  for (int g = 0; g < warp; ++g) run = max(run, s_seg[g][lane]);
  if (!live) return;
#pragma unroll
  for (int j = 0; j < kCarryCache; ++j)
    if (a + j < b) {
      carry[at(a + j)] = run;
      run = max(run, cache[j]);
    }
  for (int i = a + kCarryCache; i < b; ++i) {
    const int v = agg[at(i)];
    carry[at(i)] = run;
    run = max(run, v);
  }
}

// The highest length of S & low(win), or 0.
template <int W>
__device__ __forceinline__ int longest(const uint32_t (&S)[W], int win) {
  int L = 0;
#pragma unroll
  for (int i = W - 1; i >= 0; --i) {
    const uint32_t a = S[i] & low_word(win, i);
    if (a && !L) L = 32 * i + 32 - __clz(a);
  }
  return L;
}

template <int W>
__global__ void __launch_bounds__(kThreads, 2)
    sa_match_walk_kernel(const int* __restrict__ lcp, const int* __restrict__ who_len,
                         const int* __restrict__ who_id, const int* __restrict__ who_kind,
                         const int2* __restrict__ text, const int* __restrict__ carry, int n_s,
                         int ml, int* __restrict__ best_id, int* __restrict__ best_len) {
  __shared__ uint32_t s_bits[kRowWords * 2 * kMaxLen];
  __shared__ uint32_t s_rows[2 * kMaxLen];  // bit w: word w of the row is not empty
  __shared__ Sum<W> s_warp[2][kWarps];
  __shared__ uint32_t s_in[2][kWarps][2][W];  // the sets entering each warp, by sweep
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile0 = blockIdx.x * kTile, rows = 2 * ml, last = n_s - 1;
  const int cols = kSumWords + rows;
  const int* cl = carry + (long long)blockIdx.x * 2 * cols;  // left; right at cl + cols
  for (int i = tid; i < kRowWords * rows; i += kThreads) s_bits[i] = 0;

  const int r = tile0 + tid;
  const Rank in = rank_in(lcp, who_len, who_kind, r, n_s, ml);
  const int2 tx = r < n_s ? text[r] : make_int2(-1, 0);
  uint32_t S[2][2][W];  // [sweep][kind]: warp 0's carried sets
  if (warp == 0) {
#pragma unroll
    for (int d = 0; d < 2; ++d)
#pragma unroll
      for (int i = 0; i < W; ++i) {
        S[d][0][i] = (uint32_t)cl[d * cols + 1 + i];
        S[d][1][i] = (uint32_t)cl[d * cols + 4 + i];
      }
  }
  __syncthreads();  // the rows are zero

  post_push_bits(s_bits, in, ml, rows, lane, warp);
  const Sum<W> sl = scan_left(rank_sum<W>(in, in.left), lane);
  const Sum<W> sr = scan_right(rank_sum<W>(in, in.right), lane);
  if (lane == 31) s_warp[0][warp] = sl;
  if (lane == 0) s_warp[1][warp] = sr;
  __syncthreads();

  if (warp == 0) {  // the carry, then the warps before each warp
    const Sum<W> l = exclusive(s_warp[0][lane & (kWarps - 1)], lane, kWarps, false);
    const Sum<W> rr = exclusive(s_warp[1][lane & (kWarps - 1)], lane, kWarps, true);
    apply(S[0], l);
    apply(S[1], rr);
    if (lane < kWarps)
#pragma unroll
      for (int i = 0; i < W; ++i)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          s_in[0][lane][k][i] = S[0][k][i];
          s_in[1][lane][k][i] = S[1][k][i];
        }
  }
  const int row_t = tid - (kThreads - 2 * kMaxLen);  // the rows' words, by the last warps
  if (row_t >= 0 && row_t < rows) {
    uint32_t any = 0;
#pragma unroll
    for (int w = 0; w < kRowWords; ++w) any |= (s_bits[w * rows + row_t] != 0u) << w;
    s_rows[row_t] = any;
  }
  __syncthreads();  // s_in, s_rows
  // The sets after this rank: those entering its warp, then the warp scan.
#pragma unroll
  for (int d = 0; d < 2; ++d)
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int i = 0; i < W; ++i) S[d][k][i] = s_in[d][warp][k][i];
  apply(S[0], sl);
  apply(S[1], sr);

  if (tx.x < 0) return;
  const int win = tx.y & 127, k = tx.y >> 7;
  uint32_t left[W], right[W];  // the text kind's sets, selected without indexing
#pragma unroll
  for (int i = 0; i < W; ++i) {
    left[i] = k ? S[0][1][i] : S[0][0][i];
    right[i] = k ? S[1][1][i] : S[1][0][i];
  }
  const int Ll = longest(left, win), Lr = longest(right, win);
  const int len = max(Ll, Lr);
  int id = -1;
  if (len) {
    const int row = k * ml + len - 1, w0 = tid >> 5, b = tid & 31;
    int q;
    if (Lr == len) {  // the right sweep: the lowest pushing rank at or after r
      const uint32_t here = s_bits[w0 * rows + row] & (~0u << b);
      const uint32_t words = s_rows[row] & (~0u << (w0 + 1));
      if (here) {
        q = tile0 + 32 * w0 + __ffs(here) - 1;
      } else if (words) {
        const int w = __ffs(words) - 1;
        q = tile0 + 32 * w + __ffs(s_bits[w * rows + row]) - 1;
      } else {
        const int p = cl[cols + kSumWords + row];
        q = p < 0 ? -1 : last - p;
      }
    } else {  // the left sweep: the highest pushing rank at or before r
      const uint32_t here = s_bits[w0 * rows + row] & ((2u << b) - 1u);
      const uint32_t words = s_rows[row] & ((1u << w0) - 1u);
      if (here) {
        q = tile0 + 32 * w0 + 31 - __clz(here);
      } else if (words) {
        const int w = 31 - __clz(words);
        q = tile0 + 32 * w + 31 - __clz(s_bits[w * rows + row]);
      } else {
        q = cl[kSumWords + row];
      }
    }
    if (q >= 0) id = who_id[q];
  }
  best_len[tx.x] = len;
  best_id[tx.x] = id;
}

long long tiles_of(long long n_s) { return (n_s + kTile - 1) / kTile; }

size_t align16(size_t b) { return (b + 15) & ~size_t(15); }

// Scratch: text int2[n_s], then the aggregates and the carries, each
// int32[tiles * 2 * (kSumWords + 2 max_len)].
struct Layout {
  size_t text = 0, agg = 0, carry = 0, total = 0;
  Layout(long long n_s, int ml) {
    const size_t cols = (size_t)tiles_of(n_s) * 2 * (kSumWords + 2 * ml) * sizeof(int);
    agg = align16((size_t)n_s * sizeof(int2));
    carry = agg + align16(cols);
    total = carry + align16(cols);
  }
};

template <int W>
int launch(const int* rank, const int* lcp, const int* who_len, const int* who_id,
           const int* who_kind, const int* window, const uint8_t* wp, int n_s, int n_text, int ml,
           uint8_t* base, const Layout& lay, int* best_id, int* best_len, cudaStream_t s) {
  const int tiles = (int)tiles_of(n_s);
  auto* text = reinterpret_cast<int2*>(base + lay.text);
  auto* agg = reinterpret_cast<int*>(base + lay.agg);
  auto* carry = reinterpret_cast<int*>(base + lay.carry);
  sa_match_tiles_kernel<W><<<tiles, kThreads, 0, s>>>(rank, window, wp, lcp, who_len, who_kind,
                                                      n_s, n_text, ml, text, agg);
  int rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  sa_match_carry_kernel<W><<<2 + (4 * ml + kCarryCols - 1) / kCarryCols, kCarryThreads, 0,
                             s>>>(agg, carry, tiles, ml);
  if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
  sa_match_walk_kernel<W><<<tiles, kThreads, 0, s>>>(lcp, who_len, who_id, who_kind, text, carry,
                                                     n_s, ml, best_id, best_len);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" long long wp_linear_match_scratch_bytes(long long n_s, int max_len) {
  return n_s < 1 || max_len < 1 || max_len > kMaxLen ? -1 : (long long)Layout(n_s, max_len).total;
}

// Launches the match on `stream`: 3 kernels, no memset.  rank, lcp,
// who_len, who_id, who_kind int32[n_s]; window int32[n_text]; wp
// bool[n_text]; best_id, best_len int32[n_text]; scratch of
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
  const auto* i_rank = static_cast<const int*>(rank);
  const auto* i_lcp = static_cast<const int*>(lcp);
  const auto* i_len = static_cast<const int*>(who_len);
  const auto* i_id = static_cast<const int*>(who_id);
  const auto* i_kind = static_cast<const int*>(who_kind);
  const auto* i_win = static_cast<const int*>(window);
  const auto* u_wp = static_cast<const uint8_t*>(wp);
  auto* base = static_cast<uint8_t*>(scratch);
  auto* o_id = static_cast<int*>(best_id);
  auto* o_len = static_cast<int*>(best_len);
  auto s = static_cast<cudaStream_t>(stream);
  const int words = (max_len + 31) / 32;  // of the bitset, a kind
  if (words == 1)
    return launch<1>(i_rank, i_lcp, i_len, i_id, i_kind, i_win, u_wp, (int)n_s, (int)n_text,
                     max_len, base, lay, o_id, o_len, s);
  if (words == 2)
    return launch<2>(i_rank, i_lcp, i_len, i_id, i_kind, i_win, u_wp, (int)n_s, (int)n_text,
                     max_len, base, lay, o_id, o_len, s);
  return launch<3>(i_rank, i_lcp, i_len, i_id, i_kind, i_win, u_wp, (int)n_s, (int)n_text,
                   max_len, base, lay, o_id, o_len, s);
}
