// Per-position longest vocabulary match by rolling-hash probes, for Hopper
// (sm_90a): the fast-stream engine's matcher.
//
// match_positions_kernel replaces the XLA program
// wordpiece_tpu/ops/match_fast.py::match_positions.  It computes the same
// function as the plain PyTorch version match_positions_plain in
// ops/match_fast.py: for every position i of the padded text, the longest
// length l <= min(max_len, window[i]) whose two 32-bit rolling hashes of
// cp_pad[i .. i + l), with l and the probe kind wp[i], hit a vocabulary
// entry of the open-addressing table whose first codepoint is cp_pad[i];
// best_id = that entry's id (-1 if none), best_len = l (0 if none).
//
// Table: S = 2^log2_size slots of {k1, k2, meta = (len << 1) | kind, id,
// first codepoint}, empty slots have id -1.  The home slot of a key is
// ((h1 ^ h2 << 1 ^ l * 0x9E3779B1 ^ kind * 0x85EBCA77) * 0x9E3779B1) >>
// (32 - log2_size), all on 32 bits; a chain goes on at the next slots,
// modulo S.  The kernel reads two arrays built from it once, when the
// table is loaded (ops/match_fast.load_table):
//  - tags uint8[S]: 0 for an empty slot, else tag_of(k1), never 0;
//  - slots int32[S, 8]: {k1, k2, meta, id, first, 0, 0, 0}, one 32-byte
//    L2 sector per slot.
//
// The plain version (and the JAX one) probes every length and all
// max_probe slots of every chain.  This kernel stops earlier, with the
// same result:
//  - lengths past window[i] are never accepted, so the loop ends there;
//  - the table is built by linear probing without deletions
//    (core/vocab.py build_index), so an entry lies before any empty slot
//    of its chain: a chain walk ends at the first tag 0;
//  - (k1, k2, len, kind) is unique in the table, so at most one slot
//    matches a probe;
//  - a tag differs from tag_of(h1) only where k1 differs from h1, so the
//    tags reject slots that cannot match and never a true match.
//
// What bounds it on this card.  The function needs the text, the window,
// the kind and the two outputs once (17 bytes per position) and the table
// once: a 10 MB bucket is ~216 MB of device memory traffic.  The first
// design read up to five dependent 4-byte words of a 20-byte row (one or
// two L2 sectors) for every slot of every chain of every length: ~50 M
// probes, ~2.4 GB of L2 traffic per 10 MB call.  What this design does
// about it:
//  - tags in shared memory: one persistent 1,024-thread block per SM
//    stages the 2^17-byte tag array of a bert-sized table with one bulk
//    async copy (cp.async.bulk + mbarrier) that overlaps its first tile's
//    loads, then walks tiles of positions.  The chain walks read tags
//    only.  A table whose tags do not fit (S >= 2^18) reads them from
//    global memory (kSharedTags = false), a layout chosen by size on the
//    host or forced by the caller;
//  - longest match first: pass 1 walks the lengths and records which had
//    a tag hit (a bit mask, max_len <= 32) and the slot where the longest
//    one's tag matched; pass 2 confirms that slot's 32-byte row (its two
//    halves loaded together) and, only after a tag collision, walks the
//    chains again from the longest length down.  A position that matches
//    at all reads one row.  Where max_len exceeds the mask (kLongestFirst
//    = false) each tag hit is confirmed as it is found, in ascending
//    order, and the last true match wins: also exact;
//  - each tile's inputs are loaded one tile ahead;
//  - the length loop is kept short: the loop's invariants (the tags'
//    shared address, the shift, the mask, the multipliers, the kind's
//    mix) are pinned in registers, which the compiler otherwise rebuilt
//    on every pass, l * kLenMix and the text pointer advance with l, and
//    a tag is read by its 32-bit shared address.
// What bounds it now (PERF.md §6): the length loop, not device memory.  A
// warp runs as long as its longest window (7.3 lengths at the 10 MB en
// bucket against a mean of 3.4), and each length is a chain of dependent
// integer, shared-memory and branch steps (hash, home slot, tag walk)
// that the 32 warps of one 1,024-thread block per SM (the tags take the
// shared memory) hide only in part.  Designs that did not pay here:
// sorting each warp's positions by window, reading 4-8 tags per shared
// load with byte arithmetic, and two positions per thread.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaskBits = 32;
constexpr uint32_t kLenMix = 0x9E3779B1u;
constexpr uint32_t kKindMix = 0x85EBCA77u;
constexpr uint32_t kTagMix = 0x7FEB352Du;  // ops/match_fast.TAG_MIX

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Waits until the barrier's phase `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// One bulk async copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from global to shared memory, completing on `bar`.  Called by
// one thread; the block synchronises before any thread waits on `bar`.
__device__ __forceinline__ void stage_async(void* dst, const void* src,
                                            uint32_t bytes, uint64_t* bar) {
  const uint32_t b = smem_addr(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(b), "r"(1u) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(b)
      : "memory");
}

// The 8-bit tag of a k1 key (ops/match_fast.tag_of): never 0.
__device__ __forceinline__ uint32_t tag_of(uint32_t k1) {
  const uint32_t t = (k1 * kTagMix) >> 24;
  return t ? t : 1u;
}

__device__ __forceinline__ uint32_t home_slot(uint32_t h1, uint32_t h2, int l,
                                              uint32_t kind_mix, int log2_size) {
  const uint32_t mixed = h1 ^ (h2 << 1) ^ ((uint32_t)l * kLenMix) ^ kind_mix;
  return (mixed * kLenMix) >> (32 - log2_size);
}

// x, which the compiler may not recompute from what it was made of: a
// loop's invariants stay in registers instead of being rebuilt each pass.
__device__ __forceinline__ uint32_t pinned(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// Reads one tag: from shared memory by its 32-bit shared address, or
// from global memory.
template <bool kShared>
struct TagReader;

template <>
struct TagReader<true> {
  uint32_t base;  // shared address of tag 0
  __device__ __forceinline__ uint32_t operator()(uint32_t s) const {
    uint32_t t;
    asm volatile("ld.shared.u8 %0, [%1];" : "=r"(t) : "r"(base + s));
    return t;
  }
};

template <>
struct TagReader<false> {
  const uint8_t* __restrict__ p;
  __device__ __forceinline__ uint32_t operator()(uint32_t s) const { return __ldg(p + s); }
};

// The slot of the first tag match of a chain, before its first empty slot
// and within max_probe (>= 1) slots, or -1.
template <class Tags>
__device__ __forceinline__ int tag_find(const Tags& tags, uint32_t home, uint32_t mask,
                                        uint32_t tag, int max_probe) {
  uint32_t t = tags(home);
  if (t == tag) return (int)home;
  for (int p = 1; t != 0u && p < max_probe; ++p) {  // an empty slot ends the chain
    const uint32_t s = (home + (uint32_t)p) & mask;
    t = tags(s);
    if (t == tag) return (int)s;
  }
  return -1;
}

// Whether the slot's row holds the probe's entry.  Both halves of the
// 32-byte row are loaded at once (one sector).
__device__ __forceinline__ bool row_matches(const int4* __restrict__ slots, int s, uint32_t h1,
                                            uint32_t h2, int meta, int first, int* id) {
  const int4 a = __ldg(slots + 2 * (size_t)s);  // {k1, k2, meta, id}
  const int f = __ldg(&slots[2 * (size_t)s + 1].x);
  *id = a.w;
  return (uint32_t)a.x == h1 && (uint32_t)a.y == h2 && a.z == meta && f == first;
}

// The id of the entry that a probe matches, or -1: every slot of the chain
// that passes the tag filter is confirmed against its row.
template <class Tags>
__device__ __forceinline__ int confirm(const Tags& tags, const int4* __restrict__ slots,
                                       uint32_t home, uint32_t mask, uint32_t h1, uint32_t h2,
                                       int meta, int first, int max_probe) {
  const uint32_t tag = tag_of(h1);
  for (int p = 0; p < max_probe; ++p) {
    const uint32_t s = (home + (uint32_t)p) & mask;
    const uint32_t t = tags(s);
    if (t == 0u) break;
    int id;
    if (t == tag && row_matches(slots, (int)s, h1, h2, meta, first, &id)) return id;
  }
  return -1;
}

template <bool kSharedTags, bool kLongestFirst>
__global__ void __launch_bounds__(kThreads, 1)
    match_positions_kernel(const int* __restrict__ cp_pad, const int* __restrict__ window,
                           const uint8_t* __restrict__ wp, const uint8_t* __restrict__ tags_g,
                           const int4* __restrict__ slots, long long n, int max_len,
                           int max_probe, int log2_size, uint32_t mult1, uint32_t mult2,
                           int* __restrict__ best_id, int* __restrict__ best_len) {
  extern __shared__ __align__(128) uint8_t s_tags[];
  __shared__ __align__(8) uint64_t s_bar;
  if (kSharedTags) {
    if (threadIdx.x == 0) stage_async(s_tags, tags_g, 1u << log2_size, &s_bar);
    __syncthreads();  // the barrier is initialised before anyone waits on it
  }
  TagReader<kSharedTags> tags;
  if constexpr (kSharedTags) {
    tags.base = pinned(smem_addr(s_tags));
  } else {
    tags.p = tags_g;
  }
  bool staged = !kSharedTags;
  const uint32_t mask = pinned((1u << log2_size) - 1u);
  const uint32_t shift = pinned(32 - log2_size);
  mult1 = pinned(mult1);
  mult2 = pinned(mult2);
  if (max_probe < 1) max_len = 0;  // no slot is probed: nothing matches

  // Each tile's inputs are loaded one tile ahead, so their latency
  // overlaps the tile before.
  const long long stride = (long long)gridDim.x * kThreads;
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  int next_cp = 0, next_win = 0;
  uint32_t next_wp = 0u;
  if (i < n) {
    next_wp = wp[i];
    next_cp = __ldg(cp_pad + i);
    next_win = __ldg(window + i);
  }
  for (; i - threadIdx.x < n; i += stride) {  // uniform over the block
    const int first = next_cp;
    const int last = i < n ? min(max_len, next_win) : 0;
    const uint32_t kind = next_wp ? 1u : 0u;
    if (i + stride < n) {
      next_wp = wp[i + stride];
      next_cp = __ldg(cp_pad + i + stride);
      next_win = __ldg(window + i + stride);
    }
    if (!staged) {
      mbar_wait(&s_bar, 0);
      staged = true;
    }
    const int* cp = cp_pad + i;
    const uint32_t kind_mix = pinned(kind * kKindMix);
    int bid = -1, blen = 0;
    uint32_t h1 = 0u, h2 = 0u;
    if (kLongestFirst) {
      // Pass 1: which lengths have a tag hit; the longest one's hashes
      // and the slot where its tag matched.  l * kLenMix and the text
      // pointer advance with l.
      uint32_t hits = 0u, bh1 = 0u, bh2 = 0u, bit = 1u, len_mix = 0u;
      int bslot = -1;
      const int* q = cp;
      for (int l = 1; l <= last; ++l, ++q, bit <<= 1) {
        const uint32_t c = (uint32_t)__ldg(q);
        h1 = h1 * mult1 + c;
        h2 = h2 * mult2 + c;
        len_mix += kLenMix;
        const uint32_t home = ((h1 ^ (h2 << 1) ^ len_mix ^ kind_mix) * kLenMix) >> shift;
        const int s = tag_find(tags, home, mask, max((h1 * kTagMix) >> 24, 1u), max_probe);
        if (s >= 0) {
          hits |= bit;
          bh1 = h1;
          bh2 = h2;
          bslot = s;
        }
      }
      // Pass 2: confirm from the longest down; the first true match wins.
      // The longest hit's slot is tried first: it holds the entry unless
      // a tag collided there.
      if (hits) {
        int l = 32 - __clz(hits), id;
        if (row_matches(slots, bslot, bh1, bh2, (l << 1) | (int)kind, first, &id)) {
          bid = id;
          blen = l;
          hits = 0u;
        }
        h1 = bh1;
        h2 = bh2;
        while (hits) {
          id = confirm(tags, slots, home_slot(h1, h2, l, kind_mix, log2_size), mask, h1, h2,
                       (l << 1) | (int)kind, first, max_probe);
          if (id >= 0) {
            bid = id;
            blen = l;
            break;
          }
          hits &= ~(1u << (l - 1));  // a tag collision: look below it
          l = 32 - __clz(hits);
          h1 = h2 = 0u;
          for (int k = 0; k < l; ++k) {
            const uint32_t c = (uint32_t)__ldg(cp + k);
            h1 = h1 * mult1 + c;
            h2 = h2 * mult2 + c;
          }
        }
      }
    } else {
      // Each length confirmed as its tags hit; the longest true match wins.
      for (int l = 1; l <= last; ++l) {
        const uint32_t c = (uint32_t)__ldg(cp + l - 1);
        h1 = h1 * mult1 + c;
        h2 = h2 * mult2 + c;
        const int id = confirm(tags, slots, home_slot(h1, h2, l, kind_mix, log2_size), mask, h1,
                               h2, (l << 1) | (int)kind, first, max_probe);
        if (id >= 0) {
          bid = id;
          blen = l;
        }
      }
    }
    if (i < n) {
      best_id[i] = bid;
      best_len[i] = blen;
    }
  }
  // A block never exits with its bulk copy still in flight.
  if (!staged) mbar_wait(&s_bar, 0);
}

template <bool kSharedTags, bool kLongestFirst>
int launch(const int* cp_pad, const int* window, const uint8_t* wp, const uint8_t* tags,
           const int4* slots, long long n, int max_len, int max_probe, int log2_size,
           uint32_t mult1, uint32_t mult2, int* best_id, int* best_len, int sms,
           cudaStream_t stream) {
  auto kernel = match_positions_kernel<kSharedTags, kLongestFirst>;
  const size_t smem = kSharedTags ? (size_t)1 << log2_size : 0;
  int rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return rc;
  int per_sm = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (rc != cudaSuccess) return rc;
  if (per_sm < 1) per_sm = 1;  // the launch itself then reports the failure
  // As many blocks as fit, but no block without a tile.
  long long blocks = (long long)sms * per_sm;
  const long long n_tiles = (n + kThreads - 1) / kThreads;
  if (blocks > n_tiles) blocks = n_tiles;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(cp_pad, window, wp, tags, slots, n,
                                                       max_len, max_probe, log2_size, mult1,
                                                       mult2, best_id, best_len);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the kernel on `stream` over n positions.  `tags` is uint8[S],
// `slots` int32[S, 8] (32-byte aligned), S = 2^log2_size.  The tags are
// staged in shared memory when they fit beside the kernel's static shared
// memory, unless force_global != 0.  *mode_out is 0 (shared tags), 1
// (global tags) or -1 (n == 0: nothing launched).  Returns a cudaError_t.
extern "C" int wp_match_positions(const void* cp_pad, const void* window, const void* wp,
                                  const void* tags, const void* slots, long long n, int max_len,
                                  int max_probe, int log2_size, unsigned int mult1,
                                  unsigned int mult2, void* best_id, void* best_len,
                                  int force_global, int* mode_out, void* stream) {
  *mode_out = -1;
  if (n < 0 || max_len < 0 || max_probe < 0 || log2_size < 4 || log2_size > 30)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  if ((n + kThreads - 1) / kThreads > INT_MAX) return cudaErrorInvalidValue;
  int dev = 0, sms = 0, optin = 0;
  int rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if ((rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return rc;
  if ((rc = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return rc;
  cudaFuncAttributes fa;
  if ((rc = cudaFuncGetAttributes(&fa, match_positions_kernel<true, true>)) != cudaSuccess)
    return rc;
  // The layout is chosen by size: shared tags when they fit beside the
  // kernel's static shared memory.
  const bool shared =
      !force_global && (1LL << log2_size) + (long long)fa.sharedSizeBytes <= (long long)optin;
  const bool longest_first = max_len <= kMaskBits;
  const auto* cp = static_cast<const int*>(cp_pad);
  const auto* win = static_cast<const int*>(window);
  const auto* kind = static_cast<const uint8_t*>(wp);
  const auto* tg = static_cast<const uint8_t*>(tags);
  const auto* sl = static_cast<const int4*>(slots);
  auto* bid = static_cast<int*>(best_id);
  auto* blen = static_cast<int*>(best_len);
  auto s = static_cast<cudaStream_t>(stream);
  if (shared && longest_first)
    rc = launch<true, true>(cp, win, kind, tg, sl, n, max_len, max_probe, log2_size, mult1,
                            mult2, bid, blen, sms, s);
  else if (shared)
    rc = launch<true, false>(cp, win, kind, tg, sl, n, max_len, max_probe, log2_size, mult1,
                             mult2, bid, blen, sms, s);
  else if (longest_first)
    rc = launch<false, true>(cp, win, kind, tg, sl, n, max_len, max_probe, log2_size, mult1,
                             mult2, bid, blen, sms, s);
  else
    rc = launch<false, false>(cp, win, kind, tg, sl, n, max_len, max_probe, log2_size, mult1,
                              mult2, bid, blen, sms, s);
  if (rc == cudaSuccess) *mode_out = shared ? 0 : 1;
  return rc;
}
