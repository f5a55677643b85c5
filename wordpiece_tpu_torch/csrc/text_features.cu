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
//    started;
//  - a thread classifies 8 consecutive codepoints from two 16-byte loads
//    and keeps its flags as bit masks; the one codepoint left of its
//    items (for wp's spacing[i - 1]) is read again from the cache;
//  - window needs nsp strictly after i: the spacing minimum carried into
//    position i before position i itself is added;
//  - each output goes out as one 8-byte (flags) or two 16-byte (int32)
//    stores a thread.
// One launch after one memset of the scan's status words, no host
// synchronisation: the linear engine's batch is captured in a CUDA graph.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "classify.cuh"
#include "scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr int kChannels = 3;  // spacing, non-space, word prefix
using Scan = wp::TileScan<kThreads, kChannels, wp::MinOp, /*kReverse=*/true>;

__device__ __forceinline__ bool spacing_at(int c, long long pos, int n_valid) {
  const uint32_t u = (uint32_t)c;
  return pos >= n_valid || wp::is_space(u) || wp::is_punct(u) || wp::is_chinese(u);
}

// Byte e of the result = bit e of `bits`, for an 8-flag store.
__device__ __forceinline__ unsigned long long spread_bits(uint32_t bits) {
  unsigned long long out = 0;
#pragma unroll
  for (int e = 0; e < kItems; ++e) out |= (unsigned long long)((bits >> e) & 1u) << (8 * e);
  return out;
}

__global__ void __launch_bounds__(kThreads)
    text_features_kernel(const int* __restrict__ cp, int n, int n_valid, int max_len,
                         int tiles, void* scratch, uint8_t* __restrict__ space,
                         uint8_t* __restrict__ punct, uint8_t* __restrict__ spacing,
                         uint8_t* __restrict__ wp_out, int* __restrict__ window,
                         int* __restrict__ ss, int* __restrict__ wnext) {
  __shared__ Scan::Storage storage;
  const int q = Scan::ticket(scratch, storage);
  const int tile = tiles - 1 - q;  // from the right end first
  const long long base = (long long)tile * kTile + (long long)threadIdx.x * kItems;
  const bool whole = base + kItems <= n;

  int c[kItems];
  if (whole) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(cp + base));
    const int4 b = __ldg(reinterpret_cast<const int4*>(cp + base) + 1);
    c[0] = a.x, c[1] = a.y, c[2] = a.z, c[3] = a.w;
    c[4] = b.x, c[5] = b.y, c[6] = b.z, c[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < kItems; ++e) c[e] = base + e < n ? __ldg(cp + base + e) : 0;
  }
  // Flags as bit masks, bit e for position base + e; positions >= n set
  // no flag.
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
  const bool prev =
      base > 0 && base - 1 < n && spacing_at(__ldg(cp + base - 1), base - 1, n_valid);
  const uint32_t wpb = (sg | (sg << 1) | (uint32_t)(prev || base == 0)) & live;
  const uint32_t ns = ~sp & live;

  // Each channel's first set position among this thread's items.
  const uint32_t masks[kChannels] = {sg, ns, wpb};
  int first[kChannels], excl[kChannels], agg[kChannels], prefix[kChannels];
#pragma unroll
  for (int k = 0; k < kChannels; ++k)
    first[k] = masks[k] ? (int)base + __ffs(masks[k]) - 1 : INT_MAX;
  Scan::block_scan(first, excl, agg, storage);
  Scan::look_back(scratch, tiles, q, agg, prefix, storage);

  // From the right: nsp, nns and nwp hold the first spacing, non-space and
  // word-prefix positions after the item at hand.
  int nsp = min(excl[0], prefix[0]);
  int nns = min(excl[1], prefix[1]);
  int nwp = min(excl[2], prefix[2]);
  int win[kItems], ssv[kItems], wnv[kItems];
#pragma unroll
  for (int e = kItems - 1; e >= 0; --e) {
    const int pos = (int)base + e;
    int w = min(max_len, n_valid - pos);
    w = min(w, min(nsp, n) - pos);
    if ((pu >> e) & 1u) w = 1;
    win[e] = max(w, 1);
    if ((sg >> e) & 1u) nsp = pos;
    if ((ns >> e) & 1u) nns = pos;
    if ((wpb >> e) & 1u) nwp = pos;
    ssv[e] = min(nns, n);
    wnv[e] = min(nwp, n);
  }

  if (whole) {
    *reinterpret_cast<unsigned long long*>(space + base) = spread_bits(sp);
    *reinterpret_cast<unsigned long long*>(punct + base) = spread_bits(pu);
    *reinterpret_cast<unsigned long long*>(spacing + base) = spread_bits(sg);
    *reinterpret_cast<unsigned long long*>(wp_out + base) = spread_bits(wpb);
    int4* w4 = reinterpret_cast<int4*>(window + base);
    int4* s4 = reinterpret_cast<int4*>(ss + base);
    int4* n4 = reinterpret_cast<int4*>(wnext + base);
    w4[0] = make_int4(win[0], win[1], win[2], win[3]);
    w4[1] = make_int4(win[4], win[5], win[6], win[7]);
    s4[0] = make_int4(ssv[0], ssv[1], ssv[2], ssv[3]);
    s4[1] = make_int4(ssv[4], ssv[5], ssv[6], ssv[7]);
    n4[0] = make_int4(wnv[0], wnv[1], wnv[2], wnv[3]);
    n4[1] = make_int4(wnv[4], wnv[5], wnv[6], wnv[7]);
  } else {
#pragma unroll
    for (int e = 0; e < kItems; ++e) {
      if (base + e < n) {
        const long long i = base + e;
        space[i] = (sp >> e) & 1u;
        punct[i] = (pu >> e) & 1u;
        spacing[i] = (sg >> e) & 1u;
        wp_out[i] = (wpb >> e) & 1u;
        window[i] = win[e];
        ss[i] = ssv[e];
        wnext[i] = wnv[e];
      }
    }
  }
  // The sentinels at index n, from the last tile (the first to start).
  if (q == 0 && threadIdx.x == 0) {
    ss[n] = n;
    wnext[n] = n;
  }
}

long long tiles_of(long long n) { return n > 0 ? (n + kTile - 1) / kTile : 1; }

}  // namespace

// Bytes of scratch wp_text_features needs for n positions.
extern "C" long long wp_text_features_scratch_bytes(long long n) {
  return (long long)wp::scan_scratch_bytes(kChannels, tiles_of(n));
}

// Zeroes `scratch` and launches the kernel on `stream`, over n positions
// (n + max_len and n + 2048 below INT_MAX).  cp is int32[n] (16-byte aligned); the flags
// are bool[n], window int32[n], ss and wnext int32[n + 1], every output
// 16-byte aligned.  Returns a cudaError_t.
extern "C" int wp_text_features(const void* cp, long long n, long long n_valid, int max_len,
                                void* scratch, void* space, void* punct, void* spacing,
                                void* wp, void* window, void* ss, void* wnext, void* stream) {
  if (n < 0 || n_valid < 0 || max_len < 0 || n + (long long)max_len >= INT_MAX ||
      n + kTile >= INT_MAX)
    return cudaErrorInvalidValue;
  // Past n + max_len, n_valid changes no output: every window is max_len
  // and no position is padding.
  const int nv = (int)(n_valid < n + max_len ? n_valid : n + max_len);
  const long long tiles = tiles_of(n);
  auto s = static_cast<cudaStream_t>(stream);
  int rc = cudaMemsetAsync(scratch, 0, wp::scan_scratch_bytes(kChannels, tiles), s);
  if (rc != cudaSuccess) return rc;
  text_features_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(
      static_cast<const int*>(cp), (int)n, nv, max_len, (int)tiles, scratch,
      static_cast<uint8_t*>(space), static_cast<uint8_t*>(punct), static_cast<uint8_t*>(spacing),
      static_cast<uint8_t*>(wp), static_cast<int*>(window), static_cast<int*>(ss),
      static_cast<int*>(wnext));
  return (int)cudaGetLastError();
}
