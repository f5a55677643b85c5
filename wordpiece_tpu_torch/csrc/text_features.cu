// Per-position text features in one pass, for Hopper (sm_90a).
//
// text_features_kernel replaces the XLA program
// wordpiece_tpu/ops/text_features.py::compute_features (with its
// _next_at_or_after).  It computes the same function as the plain PyTorch
// version compute_features_plain in ops/text_features.py, whole outputs
// with the padding, for cp int32[n] (garbage at i >= n_valid):
//  - space, punct, spacing, wp: bool[n]; padding positions are space and
//    spacing, never punct; wp[i] = i == 0 | spacing[i] | spacing[i - 1];
//  - window int32[n]: 1 for punctuation, else max(1, min(max_len,
//    n_valid - i, nsp - i)), nsp the first spacing position > i (n if
//    none);
//  - ss, wnext int32[n + 1]: the first non-space / word-prefix position
//    >= i, n if none, and n at index n.
//
// What bounds it on this card: device memory.  It reads cp once (4 bytes
// a position) and writes 20 bytes a position (four flags, window, ss,
// wnext): 252 MB at the 10 MB en bucket, 0.075 ms at 3.35 TB/s.  The plain
// version runs three flipped 1-D cummins, which PyTorch runs in one
// thread block each (99 ms at that bucket).  What this design does:
//  - one reverse scan with decoupled look-back (csrc/scan.cuh) carries the
//    three "first set position at or after" minima (spacing, non-space,
//    word prefix) together, one status word each a tile; tiles start from
//    the right end, by ticket, so a tile's right neighbour has always
//    started.  A tile is 4,096 positions (16 a thread), so a 10 MB text
//    takes 3,072 look-backs; below 2^19 positions it is 2,048 (8 a
//    thread), since there a block's latency, not the card's bandwidth, is
//    the launch's time;
//  - the tile's codepoints come into shared memory as 16-byte loads at
//    unit stride across the warp, and each thread classifies its
//    consecutive positions from there and keeps its flags as bit masks;
//    the one codepoint left of the tile (for wp's spacing[i - 1]) is read
//    once;
//  - window needs nsp strictly after i: the spacing minimum carried into
//    position i before position i itself is added;
//  - each thread's flags go out as one 16- or 8-byte store an output
//    (unit stride across the warp); window, ss and wnext go through the same
//    shared buffer, one after the other, and out as 16-byte stores at unit
//    stride.  The buffer is padded by 4 words every 32, so neither access
//    pattern meets itself in a bank.
// One launch after one memset of the scan's status words, no host
// synchronisation: the linear engine's batch is captured in a CUDA graph.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "classify.cuh"
#include "scan.cuh"

namespace {

constexpr int kThreads = 256;
// Positions a thread: 16 (4,096-position tiles, half of PR 9's
// look-backs) from kSmallN positions on, 8 below, where a launch has
// fewer 4,096-position tiles than the card has SMs and a block's latency
// is the launch's time (the linear engine's ~64k-position batches).
constexpr long long kSmallN = 1 << 19;
constexpr int kChannels = 3;  // spacing, non-space, word prefix
using Scan = wp::TileScan<kThreads, kChannels, wp::MinOp, /*kReverse=*/true>;

// Index of tile position p in the staging buffer: 4 words of padding
// after every 32, so that neither a thread's own 16-byte accesses (at a
// 32- or 64-byte stride across the warp) nor the unit-stride ones meet in
// a bank.
__device__ __forceinline__ int padded(int p) { return p + ((p >> 5) << 2); }

__device__ __forceinline__ bool spacing_at(int c, long long pos, int n_valid) {
  const uint32_t u = (uint32_t)c;
  return pos >= n_valid || wp::is_space(u) || wp::is_punct(u) || wp::is_chinese(u);
}

// A thread's flags as bytes (byte e = bit e of `bits`) at `out`: one
// 8- or 16-byte store.
template <int kItems>
__device__ __forceinline__ void store_flags(uint8_t* out, uint32_t bits) {
  static_assert(kItems == 8 || kItems == 16, "one 8- or 16-byte store");
  uint32_t w[kItems / 4] = {};
#pragma unroll
  for (int e = 0; e < kItems; ++e) w[e >> 2] |= ((bits >> e) & 1u) << (8 * (e & 3));
  if constexpr (kItems == 16)
    *reinterpret_cast<uint4*>(out) = make_uint4(w[0], w[1], w[2], w[3]);
  else
    *reinterpret_cast<uint2*>(out) = make_uint2(w[0], w[1]);
}

// The tile's positions [t0, t0 + left) of `out` from `buf`, as 16-byte
// stores at unit stride (the last chunk below n element by element).
template <int kItems>
__device__ __forceinline__ void store_tile(const int* buf, int* __restrict__ out, long long t0,
                                           long long left) {
#pragma unroll
  for (int k = 0; k < kItems / 4; ++k) {
    const int p = 4 * (k * kThreads + (int)threadIdx.x);
    const int4 v = *reinterpret_cast<const int4*>(buf + padded(p));
    if (p + 4 <= left) {
      *reinterpret_cast<int4*>(out + t0 + p) = v;
    } else {
      const int a[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (p + i < left) out[t0 + p + i] = a[i];
    }
  }
}

// One output: a thread's values into the staging buffer, from the right,
// four at a time (`at(e, run)` gives item e's value and moves the running
// minimum `run` past it), then the tile out.
template <int kItems, class At>
__device__ __forceinline__ void stage_and_store(int* buf, int run, At at, int* __restrict__ out,
                                                long long t0, long long left) {
#pragma unroll
  for (int k = kItems / 4 - 1; k >= 0; --k) {
    int v[4];
#pragma unroll
    for (int i = 3; i >= 0; --i) v[i] = at(4 * k + i, run);
    *reinterpret_cast<int4*>(buf + padded((int)threadIdx.x * kItems + 4 * k)) =
        make_int4(v[0], v[1], v[2], v[3]);
  }
  __syncthreads();
  store_tile<kItems>(buf, out, t0, left);
  __syncthreads();
}

template <int kItems>
__global__ void __launch_bounds__(kThreads)
    text_features_kernel(const int* __restrict__ cp, int n, int n_valid, int max_len,
                         int tiles, void* scratch, uint8_t* __restrict__ space,
                         uint8_t* __restrict__ punct, uint8_t* __restrict__ spacing,
                         uint8_t* __restrict__ wp_out, int* __restrict__ window,
                         int* __restrict__ ss, int* __restrict__ wnext) {
  constexpr int kTile = kThreads * kItems;
  __shared__ Scan::Storage storage;
  __shared__ __align__(16) int buf[kTile + kTile / 8];
  __shared__ int before_tile;  // the codepoint left of the tile
  const int q = Scan::ticket(scratch, storage);
  const int tile = tiles - 1 - q;  // from the right end first
  const long long t0 = (long long)tile * kTile;
  const long long left = n - t0;  // positions of the tile below n, if under kTile

  // The tile's codepoints into shared memory, 16 bytes a thread at unit
  // stride; past n, zeros.
#pragma unroll
  for (int k = 0; k < kItems / 4; ++k) {
    const int p = 4 * (k * kThreads + (int)threadIdx.x);
    int4 v = make_int4(0, 0, 0, 0);
    if (p + 4 <= left) {
      v = __ldg(reinterpret_cast<const int4*>(cp + t0 + p));
    } else {
      int a[4] = {0, 0, 0, 0};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (p + i < left) a[i] = __ldg(cp + t0 + p + i);
      v = make_int4(a[0], a[1], a[2], a[3]);
    }
    *reinterpret_cast<int4*>(buf + padded(p)) = v;
  }
  if (threadIdx.x == 0) before_tile = t0 > 0 ? __ldg(cp + t0 - 1) : 0;
  __syncthreads();

  // A thread's kItems consecutive positions, classified from shared memory;
  // flags as bit masks, bit e for position base + e; positions >= n set
  // no flag.
  const int first = (int)threadIdx.x * kItems;
  const long long base = t0 + first;
  int c[kItems];
#pragma unroll
  for (int k = 0; k < kItems / 4; ++k) {
    const int4 v = *reinterpret_cast<const int4*>(buf + padded(first + 4 * k));
    c[4 * k] = v.x, c[4 * k + 1] = v.y, c[4 * k + 2] = v.z, c[4 * k + 3] = v.w;
  }
  uint32_t live = 0, sp = 0, pu = 0, sg = 0;
#pragma unroll
  for (int e = 0; e < kItems; ++e) {
    const long long pos = base + e;
    const uint32_t u = (uint32_t)c[e];
    const bool pad = pos >= n_valid;
    const bool s = pad || wp::is_space(u);
    const bool p = !pad && wp::is_punct(u);
    const bool g = s || p || wp::is_chinese(u);
    if (pos < n) {
      live |= 1u << e;
      sp |= (uint32_t)s << e;
      pu |= (uint32_t)p << e;
      sg |= (uint32_t)g << e;
    }
  }
  const int left_cp = threadIdx.x == 0 ? before_tile : buf[padded(first - 1)];
  const bool prev = base > 0 && base - 1 < n && spacing_at(left_cp, base - 1, n_valid);
  const uint32_t wpb = (sg | (sg << 1) | (uint32_t)(prev || base == 0)) & live;
  const uint32_t ns = ~sp & live;

  // Each channel's first set position among this thread's items.  The
  // block scan's barrier also frees the staging buffer.
  const uint32_t masks[kChannels] = {sg, ns, wpb};
  int firsts[kChannels], excl[kChannels], agg[kChannels], prefix[kChannels];
#pragma unroll
  for (int k = 0; k < kChannels; ++k)
    firsts[k] = masks[k] ? (int)base + __ffs(masks[k]) - 1 : INT_MAX;
  Scan::block_scan(firsts, excl, agg, storage);
  Scan::look_back(scratch, tiles, q, agg, prefix, storage);

  // The flags: kItems bytes a thread, unit stride across the warp.
  if (base + kItems <= n) {
    store_flags<kItems>(space + base, sp);
    store_flags<kItems>(punct + base, pu);
    store_flags<kItems>(spacing + base, sg);
    store_flags<kItems>(wp_out + base, wpb);
  } else {
#pragma unroll
    for (int e = 0; e < kItems; ++e) {
      if (base + e < n) {
        space[base + e] = (sp >> e) & 1u;
        punct[base + e] = (pu >> e) & 1u;
        spacing[base + e] = (sg >> e) & 1u;
        wp_out[base + e] = (wpb >> e) & 1u;
      }
    }
  }
  // The three int32 outputs through the staging buffer, one at a time, so
  // that no thread holds more than four values of them.  From the right,
  // `run` holds the first spacing, non-space or word-prefix position after
  // the item at hand; window needs the spacing strictly after it.
  const int b0 = (int)base;
  stage_and_store<kItems>(buf, min(excl[0], prefix[0]), [&](int e, int& run) {
    const int pos = b0 + e;
    int w = min(max_len, n_valid - pos);
    w = min(w, min(run, n) - pos);
    if ((pu >> e) & 1u) w = 1;
    if ((sg >> e) & 1u) run = pos;
    return max(w, 1);
  }, window, t0, left);
  stage_and_store<kItems>(buf, min(excl[1], prefix[1]), [&](int e, int& run) {
    if ((ns >> e) & 1u) run = b0 + e;
    return min(run, n);
  }, ss, t0, left);
  stage_and_store<kItems>(buf, min(excl[2], prefix[2]), [&](int e, int& run) {
    if ((wpb >> e) & 1u) run = b0 + e;
    return min(run, n);
  }, wnext, t0, left);
  // The sentinels at index n, from the last tile (the first to start).
  if (q == 0 && threadIdx.x == 0) {
    ss[n] = n;
    wnext[n] = n;
  }
}

int items_of(long long n) { return n < kSmallN ? 8 : 16; }

long long tiles_of(long long n) {
  const int tile = kThreads * items_of(n);
  return n > 0 ? (n + tile - 1) / tile : 1;
}

}  // namespace

// Bytes of scratch wp_text_features needs for n positions.
extern "C" long long wp_text_features_scratch_bytes(long long n) {
  return (long long)wp::scan_scratch_bytes(kChannels, tiles_of(n));
}

// Zeroes `scratch` and launches the kernel on `stream`, over n positions
// (n + max_len and n + 4096 below INT_MAX); 8 positions a thread below
// kSmallN, 16 from there.  cp is int32[n] (16-byte aligned); the flags
// are bool[n], window int32[n], ss and wnext int32[n + 1], every output
// 16-byte aligned.  Returns a cudaError_t.
extern "C" int wp_text_features(const void* cp, long long n, long long n_valid, int max_len,
                                void* scratch, void* space, void* punct, void* spacing,
                                void* wp, void* window, void* ss, void* wnext, void* stream) {
  if (n < 0 || n_valid < 0 || max_len < 0 || n + (long long)max_len >= INT_MAX ||
      n + 16 * kThreads >= INT_MAX)
    return cudaErrorInvalidValue;
  // Past n + max_len, n_valid changes no output: every window is max_len
  // and no position is padding.
  const int nv = (int)(n_valid < n + max_len ? n_valid : n + max_len);
  const long long tiles = tiles_of(n);
  auto s = static_cast<cudaStream_t>(stream);
  int rc = cudaMemsetAsync(scratch, 0, wp::scan_scratch_bytes(kChannels, tiles), s);
  if (rc != cudaSuccess) return rc;
  auto* kernel = items_of(n) == 8 ? text_features_kernel<8> : text_features_kernel<16>;
  kernel<<<(unsigned)tiles, kThreads, 0, s>>>(
      static_cast<const int*>(cp), (int)n, nv, max_len, (int)tiles, scratch,
      static_cast<uint8_t*>(space), static_cast<uint8_t*>(punct), static_cast<uint8_t*>(spacing),
      static_cast<uint8_t*>(wp), static_cast<int*>(window), static_cast<int*>(ss),
      static_cast<int*>(wnext));
  return (int)cudaGetLastError();
}
