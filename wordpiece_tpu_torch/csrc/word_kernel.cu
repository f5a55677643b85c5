// Word match+commit and emit compaction kernels for Hopper (sm_90a).
//
// word_match_commit_kernel replaces wordpiece_tpu/ops/word_kernel_pallas.py
// ::_kernel, the TPU kernel behind word_match_commit_pallas / _multi /
// _compact.  It computes the same function as the plain PyTorch version in
// ops/word_kernel.py: for every unit (one row of up to W codepoints,
// columns >= W read as space) the greedy walk from position 0 over the
// longest in-window vocabulary hits, the whole-word UNK rollback, and an
// emit row of token ids (-2 where nothing is emitted).  It looks up the
// longest hit only at the positions the walk visits, which are all the
// commit reads.  It also writes each unit's emit count.
//
// compact_kernel replaces the XLA epilogue of word_match_commit_compact
// (word_kernel_pallas.py:349-358): from the per-unit counts it writes
// (tid + 2) * 128 + position of every emit in (bucket, unit, position)
// order, capped, and the total.  The scan of the counts lives in the same
// launch (the design notes at the kernel).
//
// What bounds the match kernel on this card: the SM's instruction issue
// and the latency of dependent shared- and global-memory reads, not device
// memory bytes (a dispatch moves ~1 MB).  The TPU kernel probes every
// position at every length over B_l rows per lane; on this card that work
// and its divergence were the cost.  What the design does about it:
//  - the walk drives the probe: only the positions the greedy walk visits
//    are probed (about 1.3 per unit of en text instead of W), and the
//    lengths of a visited position are probed in parallel, one lane each;
//  - only occupied slots are probed: the tables are packed per (length,
//    lane), in row order, with empty slots dropped (slot_off gives each
//    list's range), so a lane's scan ends at its own last token and not at
//    the longest lane's;
//  - the list offsets and a 16-bit fingerprint of every slot's k1 key (~66
//    KB for a bert-sized vocabulary) are staged into shared memory once
//    per block by one bulk async copy (cp.async.bulk + mbarrier) that
//    overlaps the first tile's staging; a list is scanned 8 slots per
//    16-byte load, and only the longest length whose list holds the
//    fingerprint is confirmed against the full {k1, k2, tid} in global
//    memory, so a visited position pays one global load.  A fingerprint
//    collision falls back to the next longest length, so the result is
//    exact.  When the image does not fit, the same kernel reads it from
//    global memory (kSharedKeys = false), a layout chosen by size on the
//    host, or forced by the caller;
//  - the window, word-prefix and space structure of a unit are bit masks
//    (ballots), so the walk's steps and the rollback, which runs over the
//    visited positions only, are a few bit operations each;
//  - one launch per dispatch: blocks are persistent (one per SM in the
//    shared-key layout at bert scale) and each of their four 256-thread
//    groups walks over unit tiles of every bucket, the widest first and
//    spread over the SMs, so a 2-unit bucket runs beside the large ones
//    and not after them.
//
// Layout of a tile: 256 / S units, S = the power of two >= W + 1; thread
// (g, j) of a group owns position j of unit slot g.  Units are staged in
// shared memory with a space in every column >= W (the sentinel column
// included), so the narrow [U, W] matrix of any element size (1, 2 or 4
// bytes, per bucket) is read once.  The TPU kernel's 128-lane packing and
// its crossbar / roll tricks are TPU layout and are dropped.
//
// Phases of a tile, each closed by the group's own named barrier: (1)
// stage the units and their char classes; (2) the unit's position masks;
// (3) the walk with its probes, then the rollback and the unit's emit
// count, one thread per unit over its visited positions; (4) every
// position writes its emit value.
//
// word_match_kernel and word_commit_kernel are the same function split in
// two, for a vocabulary partitioned over ranks (parallel/word_sharding.py
// ::word_encode_2d_parallel): there the walk needs the matches of every
// partition, which exist only after they are max-combined, so a probe
// driven by the walk cannot serve.  They replace the XLA programs
// wordpiece_tpu/ops/word_kernel.py::word_match and ::word_commit, have
// bodies of their own (the notes at each), and share with the fused
// kernel only the probe's device functions (list_probe, list_fp_hits,
// confirm_list, window_at, the char-class tests), so the probe cannot
// drift.  Between them travels one packed int32 match per position:
// (best_len << 24) | best_id for a hit, 0 for none, so the max over vocab
// partitions is the longest length, then the largest id (one all_reduce).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;  // threads of one tile group
constexpr int kGroups = 4;     // tile groups of one block
constexpr int kBlock = kThreads * kGroups;
constexpr int kLanes = 128;
constexpr int kMaxBuckets = 8;
constexpr int kCompactThreads = 256;
constexpr int kCompactWarps = kCompactThreads / 32;
constexpr int kChunkUnits = 64;  // units of one chunk of the compaction: 8 a warp
constexpr int kPrefetch = 16;  // emit cells a lane loads before the compaction's barrier
constexpr int kCommitTile = 128;  // positions of one commit block (256 is slower, PERF.md)
constexpr uint32_t kLenMix = 0x9E3779B1u;
constexpr uint32_t kKindMix = 0x85EBCA77u;
constexpr uint32_t kSpaceToken = 9601u;  // U+2581

constexpr uint8_t kSpace = 1;
constexpr uint8_t kPunct = 2;
constexpr uint8_t kSpacing = 4;

// The buckets of one dispatch, in tile order (widest first).
struct Buckets {
  const void* cp[kMaxBuckets];    // unit matrix [units, width]
  int* out[kMaxBuckets];          // emit matrix int32[units, width] (the match kernel: its
                                  // packed matches)
  const int* match[kMaxBuckets];  // the commit kernel's packed matches int32[units, width]
  long long units[kMaxBuckets];
  long long unit_base[kMaxBuckets];  // first unit's index in the counts
  long long tile_end[kMaxBuckets];   // running sum of tiles, in tile order
  int width[kMaxBuckets];
  int stride[kMaxBuckets];  // S (W in the match kernel's dense tiles)
  int elem[kMaxBuckets];    // bytes per codepoint: 1, 2 or 4
  int n;
};

__device__ __forceinline__ bool is_space(uint32_t c) {
  return c == 32u || (c >= 9u && c <= 13u) || c == kSpaceToken;
}

__device__ __forceinline__ bool is_punct(uint32_t c) {
  return (c >= 33u && c <= 47u) || (c >= 58u && c <= 64u) ||
         (c >= 91u && c <= 96u) || (c >= 123u && c <= 126u) || c == 183u ||
         c == 171u || c == 187u || c == 8249u || c == 8250u ||
         (c >= 8208u && c <= 8248u);
}

__device__ __forceinline__ bool is_chinese(uint32_t c) {
  return (c >= 0x4E00u && c <= 0x9FFFu) || (c >= 0x3400u && c <= 0x4DBFu) ||
         (c >= 0x20000u && c <= 0x2A6DFu) || (c >= 0x2A700u && c <= 0x2B73Fu) ||
         (c >= 0x2B740u && c <= 0x2B81Fu) || (c >= 0x2B820u && c <= 0x2CEAFu) ||
         (c >= 0xF900u && c <= 0xFAFFu) || (c >= 0x2F800u && c <= 0x2FA1Fu);
}

__device__ __forceinline__ uint32_t load_cp(const void* base, int elem,
                                            long long i) {
  if (elem == 1) return static_cast<const uint8_t*>(base)[i];
  if (elem == 2) return static_cast<const uint16_t*>(base)[i];
  return (uint32_t)static_cast<const int32_t*>(base)[i];
}

// The 16-bit fingerprint of a k1 key (core/length_tables.py:fingerprint).
__device__ __forceinline__ uint32_t fingerprint(uint32_t k1) {
  return (k1 ^ (k1 >> 16)) & 0xFFFFu;
}

// Whether either 16-bit half of x is zero (exact for the pair).
__device__ __forceinline__ bool has_zero_half(uint32_t x) {
  return ((x - 0x00010001u) & ~x & 0x80008000u) != 0u;
}

// Which 16-bit halves of x are zero, as bits 0 (low) and 1 (high).
__device__ __forceinline__ uint32_t half_eq(uint32_t x) {
  return (uint32_t)((x & 0xFFFFu) == 0u) | ((uint32_t)(x < 0x10000u) << 1);
}

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

// Named barrier of one 256-thread group (barrier 0 is __syncthreads').
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "r"(kThreads) : "memory");
}

// The probe of one length: its keys, its fingerprint and its (length,
// lane) list of slots [s0, s1).
struct ListProbe {
  int key1, key2, s0, s1;
  uint32_t fp;
};

__device__ __forceinline__ ListProbe list_probe(uint32_t h1, uint32_t h2, int l,
                                                uint32_t kind_mix, const uint32_t* salts,
                                                const int* offs) {
  const uint32_t len_mix = (uint32_t)l * kLenMix;
  const uint32_t salt = salts[l];
  const int lane = (int)(((h1 ^ (h2 << 1) ^ len_mix ^ kind_mix) * salt) >> (32 - 7));
  ListProbe p;
  p.key1 = (int)h1;
  p.key2 = (int)(h2 ^ len_mix ^ kind_mix);
  p.s0 = offs[l * kLanes + lane];
  p.s1 = offs[l * kLanes + lane + 1];
  p.fp = fingerprint(h1);
  return p;
}

// The list's slots that hold the fingerprint: how many, and the last one.
// 8 slots per 16-byte load; only a chunk that holds the fingerprint in some
// 16-bit half is resolved into per-slot bits.
struct FpHits {
  int n, last;
};

__device__ __forceinline__ FpHits list_fp_hits(const uint4* fps, const ListProbe& p) {
  const uint32_t fp2 = p.fp | (p.fp << 16);
  FpHits h = {0, -1};
  const int c_end = p.s1 > p.s0 ? (p.s1 + 7) >> 3 : 0;
  for (int c = p.s0 >> 3; c < c_end; ++c) {
    const uint4 v = fps[c];
    if (has_zero_half(v.x ^ fp2) | has_zero_half(v.y ^ fp2) | has_zero_half(v.z ^ fp2) |
        has_zero_half(v.w ^ fp2)) {
      // The chunk's matching slots as 8 bits, cut to [s0, s1): a chunk may
      // start before s0 or end past s1.
      uint32_t m = half_eq(v.x ^ fp2) | (half_eq(v.y ^ fp2) << 2) |
                   (half_eq(v.z ^ fp2) << 4) | (half_eq(v.w ^ fp2) << 6);
      const int lo = p.s0 - c * 8, hi = p.s1 - c * 8;
      if (lo > 0) m &= 0xFFu << lo;
      if (hi < 8) m &= (1u << hi) - 1u;
      if (m) {
        h.n += __popc(m);
        h.last = c * 8 + 31 - __clz(m);
      }
    }
  }
  return h;
}

// The tid of the list's last slot whose full keys match (row order, as the
// row scan's last hit wins), or -1.
__device__ __forceinline__ int confirm_list(const uint4* fps,
                                            const int4* __restrict__ slot_keys,
                                            const ListProbe& p) {
  const uint16_t* fp16 = reinterpret_cast<const uint16_t*>(fps);
  int tid = -1;
  for (int s = p.s0; s < p.s1; ++s) {
    if (fp16[s] == p.fp) {
      const int4 e = __ldg(slot_keys + s);
      if (e.x == p.key1 && e.y == p.key2) tid = e.z;
    }
  }
  return tid;
}

// The tid a length's fingerprint hits confirm, or -1: a single hit is
// read directly, several are resolved by confirm_list.
__device__ __forceinline__ int confirm_hits(const uint4* fps, const int4* __restrict__ slot_keys,
                                            const ListProbe& p, const FpHits& hits) {
  if (hits.n == 1) {
    const int4 e = __ldg(slot_keys + hits.last);
    return e.x == p.key1 && e.y == p.key2 ? e.z : -1;
  }
  return confirm_list(fps, slot_keys, p);
}

// A unit's bit masks over its positions: S <= 32 positions fit one word
// (bits >= S are 0), a wider unit takes S / 32 words.  Bits >= W are
// the pad columns, which read as space.
struct UnitBits {
  const uint32_t* words;
  int n;  // words
};

__device__ __forceinline__ bool bit_at(UnitBits m, int k) {
  return (m.words[k >> 5] >> (k & 31)) & 1u;
}

// The first set bit at or after k, or n * 32 when there is none.
__device__ __forceinline__ int next_set(UnitBits m, int k) {
  int w = k >> 5;
  if (w >= m.n) return m.n * 32;
  uint32_t v = m.words[w] & (0xFFFFFFFFu << (k & 31));
  while (!v) {
    if (++w >= m.n) return m.n * 32;
    v = m.words[w];
  }
  return (w << 5) + __ffs(v) - 1;
}

// The probe window at p (src/fast.cpp:53-60): up to the first spacing char
// strictly after p, capped at max_len and the unit end; 1 for punct.
__device__ __forceinline__ int window_at(UnitBits m_spacing, UnitBits m_punct, int p, int W,
                                         int max_len) {
  if (bit_at(m_punct, p)) return 1;
  return max(min(min(next_set(m_spacing, p + 1), W), p + max_len) - p, 1);
}

// The fused kernel's tile loop (the notes at the top of this file).
template <bool kSharedKeys>
__device__ __forceinline__ void run_tiles(const Buckets& d, const int* __restrict__ image,
                                          int off_words, int image_bytes,
                                          const int4* __restrict__ slot_keys,
                                          const uint32_t* __restrict__ lane_salts, int max_len,
                                          uint32_t mult1, uint32_t mult2, int unk_id,
                                          int* __restrict__ counts) {
  // Dynamic: the slot image (offsets, then fingerprints), in the shared
  // layout.
  extern __shared__ __align__(128) int s_image[];
  __shared__ uint32_t s_cp[kBlock];   // the units, pad columns as space
  __shared__ int s_out[kBlock];       // the emit rows
  __shared__ uint8_t s_cls[kBlock];   // char classes
  __shared__ uint8_t s_vpos[kBlock];  // a unit's visited positions, in order
  __shared__ uint8_t s_vlen[kBlock];  // and their match lengths (0: a fail)
  __shared__ int s_vid[kBlock];       // and their token ids
  // Per group and unit: the position masks (kMaskWords words per group).
  constexpr int kMaskWords = kThreads / 2;
  __shared__ uint32_t s_space[kGroups * kMaskWords];
  __shared__ uint32_t s_spacing[kGroups * kMaskWords];
  __shared__ uint32_t s_punct[kGroups * kMaskWords];
  __shared__ uint32_t s_prefix[kGroups * kMaskWords];
  __shared__ uint32_t s_salt[kThreads];  // lane salts | 1; lengths are <= W < 256
  __shared__ __align__(8) uint64_t s_bar;

  if ((int)threadIdx.x < kThreads && (int)threadIdx.x <= max_len)
    s_salt[threadIdx.x] = __ldg(lane_salts + threadIdx.x) | 1u;
  if (kSharedKeys) {
    if (threadIdx.x == 0) stage_async(s_image, image, (uint32_t)image_bytes, &s_bar);
  }
  __syncthreads();  // the salts are in place, the barrier is initialised
  const int* offs = kSharedKeys ? s_image : image;
  const uint4* fps = reinterpret_cast<const uint4*>(offs + off_words);
  bool staged = !kSharedKeys;

  const int g = threadIdx.x / kThreads;
  const int t = threadIdx.x - g * kThreads;
  const int base = g * kThreads;  // the group's scratch
  const int lane = threadIdx.x & 31;
  const long long n_tiles = d.tile_end[d.n - 1];
  // Tile t goes to block t % gridDim.x, so the widest tiles (first) and
  // any tiles past one round spread over the SMs.
  for (long long tile = (long long)g * gridDim.x + blockIdx.x; tile < n_tiles;
       tile += (long long)gridDim.x * kGroups) {
    int b = 0;
    while (tile >= d.tile_end[b]) ++b;
    const long long tile0 = b ? d.tile_end[b - 1] : 0;
    const int W = d.width[b];
    const int S = d.stride[b];
    const int slot = t / S;
    const int j = t - slot * S;
    const int gbase = base + slot * S;
    const long long u = (tile - tile0) * (kThreads / S) + slot;
    const bool valid = u < d.units[b];
    const bool live = valid && j < W;
    const int me = base + t;
    // The unit's mask words: one word for S <= 32, else S / 32.
    const int n_words = S > 32 ? S >> 5 : 1;
    const int mbase = g * kMaskWords + slot * n_words;

    // ---- stage the units; every column >= W reads as space -------------
    uint32_t c = 32u;
    if (live) c = load_cp(d.cp[b], d.elem[b], u * W + j);
    s_cp[me] = c;
    uint8_t cls = 0;
    if (is_space(c)) cls |= kSpace | kSpacing;
    if (is_punct(c)) cls |= kPunct | kSpacing;
    if (is_chinese(c)) cls |= kSpacing;
    s_cls[me] = cls;
    s_out[me] = -2;
    group_sync(g);

    // ---- position masks (src/fast.cpp:38-60) ----------------------------
    // Word prefix: the unit start, a spacing char, or right after one.
    const bool prefix = j == 0 || (cls & kSpacing) || (s_cls[me - 1] & kSpacing);
    {
      const uint32_t sp = __ballot_sync(0xFFFFFFFFu, cls & kSpace);
      const uint32_t sg = __ballot_sync(0xFFFFFFFFu, cls & kSpacing);
      const uint32_t pu = __ballot_sync(0xFFFFFFFFu, cls & kPunct);
      const uint32_t pr = __ballot_sync(0xFFFFFFFFu, prefix);
      if ((j & 31) == 0) {  // the first lane of each unit word writes it
        const int sh = S < 32 ? lane : 0;
        const uint32_t keep = S < 32 ? (1u << S) - 1u : 0xFFFFFFFFu;
        const int w = mbase + (j >> 5);
        s_space[w] = (sp >> sh) & keep;
        s_spacing[w] = (sg >> sh) & keep;
        s_punct[w] = (pu >> sh) & keep;
        s_prefix[w] = (pr >> sh) & keep;
      }
    }
    group_sync(g);

    if (!staged) {
      mbar_wait(&s_bar, 0);
      staged = true;
    }
    const UnitBits m_space = {s_space + mbase, n_words};
    const UnitBits m_spacing = {s_spacing + mbase, n_words};
    const UnitBits m_punct = {s_punct + mbase, n_words};
    const UnitBits m_prefix = {s_prefix + mbase, n_words};

    // ---- the greedy walk, probing only the positions it visits --------
    // (ops/word_kernel.py:86-141 for the probe, :144-183 for the walk.)
    // The G = min(S, 32) lanes of a unit walk it together: at each
    // visited position lane q scans the lists of lengths q + 1, q + 1 +
    // G, ... within the window, the unit takes the longest length whose
    // list holds the fingerprint, and its lane confirms the full keys in
    // global memory; on a miss (a fingerprint collision) the next longest
    // is tried, so the result is exact.  Positions the walk skips are
    // never probed: the commit reads nothing of them.
    // The statements keep their shape (umask, ch and pre computed at the
    // top of a step, the confirm written out below): moved into the
    // probe's branch, with confirm_hits, they cost the kernel 2 registers
    // and 1-8% of its time at chip_smoke.py's first dispatches on an H100.
    const int G = min(S, 32);
    const unsigned umask =
        G == 32 ? 0xFFFFFFFFu : ((1u << G) - 1u) << (lane & ~(G - 1));
    int n_vis = 0;
    int p = 0;
    bool walking = valid && j < G;
    while (__any_sync(0xFFFFFFFFu, walking)) {
      const uint32_t* ch = s_cp + gbase + p;
      int window = 1;
      bool pre = false;
      if (walking) {
        pre = bit_at(m_prefix, p);
        window = window_at(m_spacing, m_punct, p, W, max_len);
      }
      int hit_l = 0, hit_tid = -1;
      const int lmax = walking ? min(window, max_len) : 0;
      const uint32_t kind_mix = pre ? kKindMix : 0u;
      bool resolving = walking;  // uniform over a unit's lanes
      int below = lmax + 1;  // this lane rescans its lengths below this
      int my_l = 0;          // this lane's longest fingerprint hit
      ListProbe mine;
      FpHits mine_hits;
      while (__any_sync(0xFFFFFFFFu, resolving)) {
        if (resolving && below > 0) {
          my_l = 0;
          uint32_t h1 = 0u, h2 = 0u;
          int k = 0;
          for (int l = j + 1; l < below; l += G) {
            for (; k < l; ++k) {
              h1 = h1 * mult1 + ch[k];
              h2 = h2 * mult2 + ch[k];
            }
            const ListProbe pr = list_probe(h1, h2, l, kind_mix, s_salt, offs);
            const FpHits hits = list_fp_hits(fps, pr);
            if (hits.n) {
              my_l = l;
              mine = pr;
              mine_hits = hits;
            }
          }
          below = 0;
        }
        // The unit's longest candidate length; its lane confirms it.
        int best_l = resolving ? my_l : 0;
        for (int o = G >> 1; o > 0; o >>= 1)
          best_l = max(best_l, __shfl_xor_sync(0xFFFFFFFFu, best_l, o));
        const bool owner = resolving && best_l > 0 && my_l == best_l;
        const unsigned owners = __ballot_sync(0xFFFFFFFFu, owner) & umask;
        int tid = -1;
        if (owner) {
          if (mine_hits.n == 1) {
            const int4 e = __ldg(slot_keys + mine_hits.last);
            if (e.x == mine.key1 && e.y == mine.key2) tid = e.z;
          } else {
            tid = confirm_list(fps, slot_keys, mine);
          }
        }
        tid = __shfl_sync(0xFFFFFFFFu, tid, owners ? __ffs(owners) - 1 : lane);
        if (resolving) {
          if (best_l == 0) {
            resolving = false;  // no list holds the fingerprint: no hit
          } else if (tid >= 0) {
            hit_l = best_l;
            hit_tid = tid;
            resolving = false;
          } else if (owner) {
            below = my_l;  // a fingerprint collision: look below it
          }
        }
      }
      if (walking) {
        if (j == 0) {
          s_vpos[gbase + n_vis] = (uint8_t)p;
          s_vlen[gbase + n_vis] = (uint8_t)hit_l;
          s_vid[gbase + n_vis] = hit_tid;
        }
        ++n_vis;
        // The next non-space at or after the landing (ops/word_kernel.py:
        // 164-174); a fail lands on the next word prefix after its
        // window.  Every step advances >= 1 position, so the walk ends at
        // W.
        const int land = hit_l > 0 ? min(p + hit_l, W)
                                   : min(next_set(m_prefix, min(p + window, W)), W);
        int q = land;
        while (q < W && bit_at(m_space, q)) ++q;
        p = q;
        walking = p < W;
      }
    }

    // ---- rollback + count over the visited positions, in reverse ------
    // A visited fail kills every emission back to its segment start; the
    // strict < keeps a fail that IS the next segment start in that later
    // segment.  Empty (all-space) rows emit nothing.
    if (valid && j == 0) {
      const bool empty_row = bit_at(m_space, 0);
      int n_emit = 0;
      int next_fail = W + 1;  // first visited fail at or after k
      int next_seg = W + 1;   // first segment start strictly after k
      for (int i = n_vis - 1; i >= 0; --i) {
        const int k = s_vpos[gbase + i];
        const int ln = s_vlen[gbase + i];
        if (ln == 0) next_fail = k;
        const bool killed = next_fail < next_seg;
        const bool seg_start = bit_at(m_prefix, k);
        if (seg_start) next_seg = k;
        if (!empty_row && ((ln > 0 && !killed) || (seg_start && killed))) {
          s_out[gbase + k] = killed ? unk_id : s_vid[gbase + i];
          ++n_emit;
        }
      }
      counts[d.unit_base[b] + u] = n_emit;
    }
    group_sync(g);

    // ---- emit ---------------------------------------------------------
    if (live) d.out[b][u * W + j] = s_out[me];
    group_sync(g);  // the next tile reuses the group's scratch
  }
  // A block never exits with its bulk copy still in flight.
  if (!staged) mbar_wait(&s_bar, 0);
}

template <bool kSharedKeys>
__global__ void __launch_bounds__(kBlock, 1)
word_match_commit_kernel(const Buckets d, const int* __restrict__ image, int off_words,
                         int image_bytes, const int4* __restrict__ slot_keys,
                         const uint32_t* __restrict__ lane_salts, int max_len, uint32_t mult1,
                         uint32_t mult2, int unk_id, int* __restrict__ counts) {
  run_tiles<kSharedKeys>(d, image, off_words, image_bytes, slot_keys, lane_salts, max_len, mult1,
                         mult2, unk_id, counts);
}

// ---- the split kernels (B9) ----------------------------------------------
// Both take buckets of width <= kMaxSplitWidth, so a match length fits the
// packed word's top byte and keeps it positive: the max of packed words is
// the longest length, then the largest id.
constexpr int kMaxSplitWidth = 127;
constexpr int kLenShift = 24;
constexpr uint32_t kIdMask = (1u << kLenShift) - 1u;
constexpr int kPowers = kMaxSplitWidth + 1;  // m^0 .. m^127

__device__ __forceinline__ uint8_t char_class(uint32_t c) {
  uint8_t cls = 0;
  if (is_space(c)) cls |= kSpace | kSpacing;
  if (is_punct(c)) cls |= kPunct | kSpacing;
  if (is_chinese(c)) cls |= kSpacing;
  return cls;
}

// The commit kernel's unit masks (run_tiles' layout and masks): the
// calling warp's ballots of the four classes, written by the first lane of
// each 32-lane unit word to word mbase + j / 32 of each array.
__device__ __forceinline__ void write_masks(uint8_t cls, bool prefix, int j, int S, int mbase,
                                            uint32_t* space, uint32_t* spacing, uint32_t* punct,
                                            uint32_t* prefixes) {
  const uint32_t sp = __ballot_sync(0xFFFFFFFFu, cls & kSpace);
  const uint32_t sg = __ballot_sync(0xFFFFFFFFu, cls & kSpacing);
  const uint32_t pu = __ballot_sync(0xFFFFFFFFu, cls & kPunct);
  const uint32_t pr = __ballot_sync(0xFFFFFFFFu, prefix);
  if ((j & 31) == 0) {
    const int sh = S < 32 ? (int)(threadIdx.x & 31) : 0;
    const uint32_t keep = S < 32 ? (1u << S) - 1u : 0xFFFFFFFFu;
    const int w = mbase + (j >> 5);
    space[w] = (sp >> sh) & keep;
    spacing[w] = (sg >> sh) & keep;
    punct[w] = (pu >> sh) & keep;
    prefixes[w] = (pr >> sh) & keep;
  }
}

// m^e mod 2^32.
__device__ __forceinline__ uint32_t pow32(uint32_t m, int e) {
  uint32_t r = 1u;
  for (; e; e >>= 1, m *= m)
    if (e & 1) r *= m;
  return r;
}

// The slot tables the match kernel probes, and its hash statics in shared
// memory.
struct Probe {
  const int* offs;
  const uint4* fps;
  const int4* slot_keys;
  const uint32_t* salt;  // lane salts | 1, lengths 0 .. kMaxSplitWidth
  const uint32_t* pw1;   // mult1^l
  const uint32_t* pw2;
};

// The probe of length l at a position, whose keys come from the unit's
// inclusive prefix hashes: h(p, l) = P(p + l) - P(p) m^l, with P(p + l) =
// i1[l - 1] and P(p) = b1.
__device__ __forceinline__ ListProbe probe_at(int l, const uint32_t* i1, const uint32_t* i2,
                                              uint32_t b1, uint32_t b2, uint32_t kind_mix,
                                              const Probe& t) {
  return list_probe(i1[l - 1] - b1 * t.pw1[l], i2[l - 1] - b2 * t.pw2[l], l, kind_mix, t.salt,
                    t.offs);
}

// The longest length at or below l whose (length, lane) list holds the
// key's fingerprint, with its probe and hits; 0 when there is none.  Reads
// shared memory only (in the shared-key layout).
__device__ __forceinline__ int longest_fp_hit(int l, const uint32_t* i1, const uint32_t* i2,
                                              uint32_t b1, uint32_t b2, uint32_t kind_mix,
                                              const Probe& t, ListProbe* pr, FpHits* hits) {
  for (; l > 0; --l) {
    *pr = probe_at(l, i1, i2, b1, b2, kind_mix, t);
    *hits = list_fp_hits(t.fps, *pr);
    if (hits->n) break;
  }
  return l;
}

// The longest hit at a position at or below length l, lengths tried
// longest first, each fingerprint hit confirmed against the full keys in
// global memory as it is met; a collision goes on below.  Returns the
// packed match, 0 for none.
__device__ __forceinline__ int longest_hit(int l, const uint32_t* i1, const uint32_t* i2,
                                           uint32_t b1, uint32_t b2, uint32_t kind_mix,
                                           const Probe& t) {
  for (ListProbe pr; l > 0; --l) {
    FpHits hits;
    l = longest_fp_hit(l, i1, i2, b1, b2, kind_mix, t, &pr, &hits);
    if (l == 0) break;
    const int tid = confirm_hits(t.fps, t.slot_keys, pr, hits);
    if (tid >= 0) return (l << kLenShift) | tid;
  }
  return 0;
}

// The match kernel: every position's longest in-window hit against the
// given table or partition, written as one packed int32 (0: none).  It
// replaces wordpiece_tpu/ops/word_kernel.py::word_match (:77-145) and
// computes what ops/word_kernel.py::word_match computes, id for id.
//
// What bounds it on this card: the fingerprint scans of every position's
// lengths, random shared-memory reads across all 32 warps of an SM, and
// the rounds of tiles (a dispatch moves ~1 MB; its bytes bound is ~0.3
// us).  What the design does about it:
//  - the probe tables are the fused kernel's: the slot image (list offsets
//    and 16-bit fingerprints) staged once per persistent block by one bulk
//    async copy, or read from global memory where it does not fit;
//  - longest first, one confirmation: a position's lengths are scanned
//    from its window's longest down to the first whose list holds the
//    fingerprint, in shared memory only, and only that one is confirmed
//    against the full keys in global memory, the warp's lanes together:
//    one round trip a warp, not one for each length at which some lane
//    hits.  A collision falls back to the next longest, as the fused
//    kernel's walk does, so the result is exact;
//  - the keys of any (position, length) pair cost O(1): the unit's prefix
//    hashes and m^l from a table in shared memory, so the lengths need not
//    be walked in order;
//  - units are packed densely, 256 / W a tile, unit slot g at lanes [g W,
//    g W + W): no lane is a pad column (run_tiles pads each unit to a power
//    of two), so a dispatch needs fewer tiles, one round of them at the en
//    first dispatch; each lane finds its own prefix hashes, window and
//    kind from the unit's codepoints and classes in shared memory.
template <bool kSharedKeys>
__global__ void __launch_bounds__(kBlock, 1)
word_match_kernel(const Buckets d, const int* __restrict__ image, int off_words, int image_bytes,
                  const int4* __restrict__ slot_keys, const uint32_t* __restrict__ lane_salts,
                  int max_len, uint32_t mult1, uint32_t mult2) {
  extern __shared__ __align__(128) int s_image[];
  __shared__ uint32_t s_cp[kBlock];                // the units, packed
  __shared__ uint32_t s_i1[kBlock], s_i2[kBlock];  // their inclusive prefix hashes
  __shared__ uint8_t s_cls[kBlock];
  __shared__ uint32_t s_pw1[kPowers], s_pw2[kPowers], s_salt[kPowers];
  __shared__ __align__(8) uint64_t s_bar;

  if ((int)threadIdx.x < kPowers) {
    s_pw1[threadIdx.x] = pow32(mult1, threadIdx.x);
    s_pw2[threadIdx.x] = pow32(mult2, threadIdx.x);
    if ((int)threadIdx.x <= max_len) s_salt[threadIdx.x] = __ldg(lane_salts + threadIdx.x) | 1u;
  }
  if (kSharedKeys && threadIdx.x == 0) stage_async(s_image, image, (uint32_t)image_bytes, &s_bar);
  __syncthreads();  // the tables are in place, the barrier is initialised
  const int* offs = kSharedKeys ? s_image : image;
  const Probe probe = {offs, reinterpret_cast<const uint4*>(offs + off_words), slot_keys, s_salt,
                       s_pw1, s_pw2};
  bool staged = !kSharedKeys;

  const int g = threadIdx.x / kThreads;
  const int t = threadIdx.x - g * kThreads;
  const int base = g * kThreads;
  const long long n_tiles = d.tile_end[d.n - 1];
  for (long long tile = (long long)g * gridDim.x + blockIdx.x; tile < n_tiles;
       tile += (long long)gridDim.x * kGroups) {
    int b = 0;
    while (tile >= d.tile_end[b]) ++b;
    const long long tile0 = b ? d.tile_end[b - 1] : 0;
    const int W = d.width[b];
    const int per = kThreads / W;  // units a tile
    const int slot = t / W;
    const int j = t - slot * W;
    const long long u = (tile - tile0) * per + slot;
    const bool live = slot < per && u < d.units[b];
    const int me = base + t;
    const uint32_t* unit_cp = s_cp + (me - j);

    // ---- stage the units ---------------------------------------------------
    const uint32_t c = live ? load_cp(d.cp[b], d.elem[b], u * W + j) : 32u;
    const uint8_t cls = char_class(c);
    s_cp[me] = c;
    s_cls[me] = cls;
    group_sync(g);

    // ---- the position's prefix hashes, window and kind ----------------------
    // (src/fast.cpp:38-60: the window runs to the first spacing char
    // strictly after j, capped at max_len and the unit end; 1 for punct.)
    uint32_t i1 = 0u, i2 = 0u, kind_mix = 0u;
    int lmax = 0;
    if (live) {
      for (int k = 0; k <= j; ++k) {
        const uint32_t ck = unit_cp[k];
        i1 = i1 * mult1 + ck;
        i2 = i2 * mult2 + ck;
      }
      int k = j + 1;
      if (!(cls & kPunct)) {
        const int end = min(W, j + max_len);
        while (k < end && !(s_cls[me - j + k] & kSpacing)) ++k;
      }
      lmax = min(max(k - j, 1), max_len);
      if (j == 0 || (cls & kSpacing) || (s_cls[me - 1] & kSpacing)) kind_mix = kKindMix;
    }
    s_i1[me] = i1;
    s_i2[me] = i2;
    group_sync(g);

    if (!staged) {
      mbar_wait(&s_bar, 0);
      staged = true;
    }
    // ---- longest first: the fingerprint scans of every lane in shared
    // memory, then, the warp together, one confirmation in global memory
    // (one round trip a warp, not one for each length some lane hits at);
    // a fingerprint collision goes on below it, lane by lane.
    const uint32_t b1 = j ? s_i1[me - 1] : 0u, b2 = j ? s_i2[me - 1] : 0u;
    ListProbe pr;
    FpHits hits;
    const int l = longest_fp_hit(lmax, s_i1 + me, s_i2 + me, b1, b2, kind_mix, probe, &pr, &hits);
    __syncwarp();
    if (live) {
      int packed = 0;
      if (l > 0) {
        const int tid = confirm_hits(probe.fps, slot_keys, pr, hits);
        packed = tid >= 0 ? (l << kLenShift) | tid
                          : longest_hit(l - 1, s_i1 + me, s_i2 + me, b1, b2, kind_mix, probe);
      }
      d.out[b][u * W + j] = packed;
    }
    group_sync(g);  // the next tile reuses the group's scratch
  }
  // A block never exits with its bulk copy still in flight.
  if (!staged) mbar_wait(&s_bar, 0);
}

// The commit kernel: the greedy walk over given (combined) packed matches,
// the whole-word UNK rollback and the emit, writing the emit matrices and
// each unit's emit count.  It replaces wordpiece_tpu/ops/word_kernel.py::
// word_commit (:148-215) and computes what ops/word_kernel.py::word_commit
// computes.
//
// What bounds it: the launch and the latency of the tile's one load and of
// the walk's dependent steps (a dispatch moves ~0.9 MB).  The design:
//  - one tile of kCommitTile positions a block, and as many blocks as
//    tiles: there is no table to stage, so nothing asks for persistent
//    blocks;
//  - each position loads its packed match beside its codepoint, one
//    coalesced load each, into shared memory; the walk's steps, the
//    rollback and the emit then read only shared memory;
//  - one lane per unit walks it, marking the visited positions in a bit
//    mask that the rollback reads back in reverse.
__global__ void __launch_bounds__(kCommitTile)
word_commit_kernel(const Buckets d, int max_len, int unk_id, int* __restrict__ counts) {
  constexpr int kT = kCommitTile;
  __shared__ int s_m[kT];  // the tile's packed matches
  __shared__ int s_out[kT];
  __shared__ uint8_t s_cls[kT];
  constexpr int kWords = kT / 2;
  __shared__ uint32_t s_space[kWords], s_spacing[kWords], s_punct[kWords], s_prefix[kWords];
  __shared__ uint32_t s_vis[kWords];  // the walk's visited positions

  const int t = threadIdx.x;
  const long long tile = blockIdx.x;
  int b = 0;
  while (tile >= d.tile_end[b]) ++b;
  const long long tile0 = b ? d.tile_end[b - 1] : 0;
  const int W = d.width[b];
  const int S = d.stride[b];
  const int slot = t / S;
  const int j = t - slot * S;
  const int gbase = slot * S;
  const long long u = (tile - tile0) * (kT / S) + slot;
  const bool valid = u < d.units[b];
  const bool live = valid && j < W;
  const long long at = u * W + j;
  const int n_words = S > 32 ? S >> 5 : 1;
  const int mbase = slot * n_words;

  uint32_t c = 32u;
  int m = 0;
  if (live) {
    c = load_cp(d.cp[b], d.elem[b], at);
    m = __ldg(d.match[b] + at);
  }
  const uint8_t cls = char_class(c);
  s_cls[t] = cls;
  s_m[t] = m;
  s_out[t] = -2;
  __syncthreads();
  write_masks(cls, j == 0 || (cls & kSpacing) || (s_cls[t - 1] & kSpacing), j, S, mbase, s_space,
              s_spacing, s_punct, s_prefix);
  __syncthreads();

  if (valid && j == 0) {
    const UnitBits m_space = {s_space + mbase, n_words};
    const UnitBits m_spacing = {s_spacing + mbase, n_words};
    const UnitBits m_punct = {s_punct + mbase, n_words};
    const UnitBits m_prefix = {s_prefix + mbase, n_words};
    uint32_t* vis = s_vis + mbase;
    for (int w = 0; w < n_words; ++w) vis[w] = 0u;
    const int* mrow = s_m + gbase;
    // ---- the greedy walk (ops/word_kernel.py::walk_visited): matched iff
    // the length is > 0, landing at most at the unit end, then the next
    // non-space; a fail lands on the next word prefix after its window.
    for (int p = 0; p < W;) {
      vis[p >> 5] |= 1u << (p & 31);
      const int hit = min((int)((uint32_t)mrow[p] >> kLenShift), W);
      int q = hit > 0 ? min(p + hit, W)
                      : min(next_set(m_prefix, min(p + window_at(m_spacing, m_punct, p, W, max_len),
                                                   W)),
                            W);
      while (q < W && bit_at(m_space, q)) ++q;
      p = q;
    }
    // ---- rollback + count over the visited positions, in reverse (the
    // fused kernel's, run_tiles).
    const bool empty_row = bit_at(m_space, 0);
    int n_emit = 0;
    int next_fail = W + 1;  // first visited fail at or after k
    int next_seg = W + 1;   // first segment start strictly after k
    for (int w = n_words - 1; w >= 0; --w) {
      for (uint32_t v = vis[w]; v;) {
        const int bit = 31 - __clz(v);
        v &= ~(1u << bit);
        const int k = (w << 5) + bit;
        const uint32_t mk = (uint32_t)mrow[k];
        const bool hit = (mk >> kLenShift) > 0u;
        if (!hit) next_fail = k;
        const bool killed = next_fail < next_seg;
        const bool seg_start = bit_at(m_prefix, k);
        if (seg_start) next_seg = k;
        if (!empty_row && ((hit && !killed) || (seg_start && killed))) {
          s_out[gbase + k] = killed ? unk_id : (int)(mk & kIdMask);
          ++n_emit;
        }
      }
    }
    counts[d.unit_base[b] + u] = n_emit;
  }
  __syncthreads();
  if (live) d.out[b][at] = s_out[t];
}

// Block-wide exclusive scan of v over kCompactThreads threads, and the
// block's sums of v and of u, in one pass: returns this thread's exclusive
// prefix of v.  Every thread of the block calls it.
__device__ __forceinline__ int block_scan(int v, int u, int2* s_warp, int* total_v,
                                          int* total_u) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int x = v, y = u;
  for (int o = 1; o < 32; o <<= 1) {
    const int xv = __shfl_up_sync(0xFFFFFFFFu, x, o), yv = __shfl_up_sync(0xFFFFFFFFu, y, o);
    if (lane >= o) {
      x += xv;
      y += yv;
    }
  }
  if (lane == 31) s_warp[w] = make_int2(x, y);
  __syncthreads();
  if (w == 0) {
    int2 t = lane < kCompactWarps ? s_warp[lane] : make_int2(0, 0);
    for (int o = 1; o < kCompactWarps; o <<= 1) {
      const int tx = __shfl_up_sync(0xFFFFFFFFu, t.x, o), ty = __shfl_up_sync(0xFFFFFFFFu, t.y, o);
      if (lane >= o) {
        t.x += tx;
        t.y += ty;
      }
    }
    if (lane < kCompactWarps) s_warp[lane] = t;  // inclusive sums of the warps
  }
  __syncthreads();
  const int before = (w ? s_warp[w - 1].x : 0) + x - v;
  *total_v = s_warp[kCompactWarps - 1].x;
  *total_u = s_warp[kCompactWarps - 1].y;
  __syncthreads();  // s_warp is reused by the next call
  return before;
}

// A chunk of the compaction: up to kChunkUnits units of one bucket.
// Chunks are numbered bucket by bucket, in caller order.
struct Chunk {
  int b;        // the bucket
  long long u;  // its first unit, within the bucket
  int len;      // units; 0 past the last chunk
};

__device__ __forceinline__ Chunk chunk_at(const Buckets& d, long long c) {
  for (int b = 0; b < d.n; ++b) {
    const long long in_bucket = (d.units[b] + kChunkUnits - 1) / kChunkUnits;
    if (c < in_bucket) {
      const long long u = c * kChunkUnits;
      return {b, u, (int)min((long long)kChunkUnits, d.units[b] - u)};
    }
    c -= in_bucket;
  }
  return {0, 0, 0};
}

// Warp w's run of a chunk: units [ua, ub) of the chunk, whose emit rows
// are `cells` consecutive ints of the bucket's emit matrix from `row`.
struct Run {
  int ua, ub, cells;
  const int* row;
};

__device__ __forceinline__ Run run_of(const Buckets& d, const Chunk& k, int w) {
  const int per = (k.len + kCompactWarps - 1) / kCompactWarps;
  const int ua = min(w * per, k.len), ub = min(ua + per, k.len);
  const int W = d.width[k.b];
  return {ua, ub, (ub - ua) * W, d.out[k.b] + (k.u + ua) * W};
}

// The first kPrefetch * 32 cells of a run, one per lane and round.
__device__ __forceinline__ void prefetch_run(const Run& r, int lane, int (&pre)[kPrefetch]) {
#pragma unroll
  for (int q = 0; q < kPrefetch; ++q) {
    const int c = lane + 32 * q;
    pre[q] = c < r.cells ? __ldg(r.row + c) : -2;
  }
}

// Places a run's emits from `at` on: a ballot and a popcount give each
// emit its place, so a warp's stores go out in order.  The first cells
// come from `pre`, the rest from the emit matrix.  A run starts at a
// unit's first column, so cell c is at position c % W, kept by steps.
__device__ __forceinline__ void place_run(int W, const Run& r, int at,
                                          const int (&pre)[kPrefetch], int cap,
                                          int* __restrict__ dst, int lane) {
  const unsigned below = (1u << lane) - 1u;
  const int step = 32 % W;
  int j = lane % W;
  int c = lane;
#pragma unroll
  for (int q = 0; q < kPrefetch; ++q, c += 32) {
    if (c - lane >= r.cells) return;
    const int e = pre[q];
    const unsigned m = __ballot_sync(0xFFFFFFFFu, e != -2);
    const int to = at + __popc(m & below);
    if (e != -2 && to < cap) dst[to] = (e + 2) * 128 + j;
    at += __popc(m);
    j += step;
    if (j >= W) j -= W;
  }
  for (; c - lane < r.cells; c += 32) {
    const int e = c < r.cells ? r.row[c] : -2;
    const unsigned m = __ballot_sync(0xFFFFFFFFu, e != -2);
    const int to = at + __popc(m & below);
    if (e != -2 && to < cap) dst[to] = (e + 2) * 128 + j;
    at += __popc(m);
    j += step;
    if (j >= W) j -= W;
  }
}

// The compaction, in one cooperative launch of at most the co-resident
// blocks.  Block k owns chunks k, k + grid, ...  What bounds it: a
// dispatch's ~0.5 MB of emits and counts is nothing to the card's memory,
// so the launch, the scan across blocks and the latency of dependent
// reads are the cost.  The design:
//  - the scan lives in the launch: phase 1 sums each chunk's counts into
//    chunk_sums (scratch the caller allocates for each call, so two calls
//    on two streams share nothing and nothing needs zeroing); one
//    grid-wide barrier; phase 2 takes each chunk's offset from the sums
//    of the chunks before it.  The last chunk's block writes the total,
//    fused[0];
//  - a chunk lies in one bucket, resolved once per chunk for the block;
//  - a block scans its first chunk's counts and loads that chunk's emit
//    cells into registers (kPrefetch a lane) before the barrier;
//  - each warp places a run of whole units: their emit rows are one
//    contiguous run of cells, read with consecutive lanes on consecutive
//    ints.  Entries at or past `cap` are dropped.
__global__ void __launch_bounds__(kCompactThreads)
compact_kernel(const Buckets d, long long n, long long chunk_count, int cap,
               int* __restrict__ fused, int* __restrict__ chunk_sums) {
  __shared__ int2 s_warp[kCompactWarps];
  __shared__ int s_off[kChunkUnits];  // a chunk's exclusive scan
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int* counts = fused + 1;
  int* __restrict__ dst = fused + 1 + n;
  const long long grid = gridDim.x;
  int total, none;

  // The block's first chunk: its counts scanned and its emit cells loaded.
  const long long c0 = blockIdx.x;
  const Chunk k0 = chunk_at(d, c0);
  const long long first0 = d.unit_base[k0.b] + k0.u;
  int sum0, base0;
  const int off = block_scan(t < k0.len ? counts[first0 + t] : 0, 0, s_warp, &sum0, &none);
  if (t < kChunkUnits) s_off[t] = off;
  const Run r0 = run_of(d, k0, w);
  int pre[kPrefetch];
  prefetch_run(r0, lane, pre);
  // ---- phase 1: the chunk sums -------------------------------------------
  if (t == 0 && k0.len) chunk_sums[c0] = sum0;
  for (long long c = c0 + grid; c < chunk_count; c += grid) {
    const Chunk k = chunk_at(d, c);
    const long long first = d.unit_base[k.b] + k.u;
    block_scan(t < k.len ? counts[first + t] : 0, 0, s_warp, &total, &none);
    if (t == 0) chunk_sums[c] = total;
  }
  cooperative_groups::this_grid().sync();
  if (chunk_count == 0) {
    if (t == 0) fused[0] = 0;
    return;
  }
  // ---- phase 2: the first chunk's offset, then its entries ---------------
  int part = 0;
  for (long long j = t; j < c0; j += kCompactThreads) part += __ldcg(chunk_sums + j);
  block_scan(0, part, s_warp, &none, &base0);
  long long base = base0;
  if (c0 == chunk_count - 1 && t == 0) fused[0] = (int)(base + sum0);
  if (r0.ua < r0.ub)
    place_run(d.width[k0.b], r0, (int)(base + s_off[r0.ua]), pre, cap, dst, lane);
  long long sum = sum0;
  for (long long c = c0 + grid; c < chunk_count; c += grid) {
    part = 0;  // the chunks from the previous one of this block to this one
    for (long long j = c - grid + 1 + t; j < c; j += kCompactThreads)
      part += __ldcg(chunk_sums + j);
    const Chunk k = chunk_at(d, c);
    const long long first = d.unit_base[k.b] + k.u;
    int between;
    const int o = block_scan(t < k.len ? counts[first + t] : 0, part, s_warp, &total, &between);
    if (t < kChunkUnits) s_off[t] = o;
    base += sum + between;
    sum = total;
    if (c == chunk_count - 1 && t == 0) fused[0] = (int)(base + sum);
    __syncthreads();
    const Run r = run_of(d, k, w);
    prefetch_run(r, lane, pre);
    if (r.ua < r.ub) place_run(d.width[k.b], r, (int)(base + s_off[r.ua]), pre, cap, dst, lane);
  }
}

// Fills `d` from the caller's bucket arrays (caller order); entries are
// stored widest first if `widest_first`, else in caller order.  A tile
// holds `tile_threads` / S units, S the power of two >= W + 1, or S = W if
// `dense` (the match kernel); widths must be < tile_threads and <=
// max_width.  `cps`/`elem` may be null (the compaction); `match` (the
// packed matches) is null but for the commit kernel.
int fill_buckets(Buckets* d, int n, const void* const* cps, const int* elem,
                 const long long* units, const int* widths, void* const* outs,
                 bool widest_first, long long* total_units, const void* const* match = nullptr,
                 int tile_threads = kThreads, int max_width = kThreads - 1, bool dense = false) {
  if (n < 1 || n > kMaxBuckets) return cudaErrorInvalidValue;
  long long unit_base[kMaxBuckets];
  int order[kMaxBuckets];
  long long acc = 0;
  for (int i = 0; i < n; ++i) {
    if (widths[i] < 1 || widths[i] >= tile_threads || widths[i] > max_width || units[i] < 0)
      return cudaErrorInvalidValue;
    if (elem && elem[i] != 1 && elem[i] != 2 && elem[i] != 4)
      return cudaErrorInvalidValue;
    unit_base[i] = acc;
    acc += units[i];
    int k = i;  // stable insertion, widest first
    while (widest_first && k > 0 && widths[order[k - 1]] < widths[i]) {
      order[k] = order[k - 1];
      --k;
    }
    order[k] = i;
  }
  long long tiles = 0;
  for (int k = 0; k < n; ++k) {
    const int i = order[k];
    int S = dense ? widths[i] : 1;
    while (S < widths[i] + 1 && !dense) S <<= 1;
    const int per_tile = tile_threads / S;
    tiles += (units[i] + per_tile - 1) / per_tile;
    d->cp[k] = cps ? cps[i] : nullptr;
    d->out[k] = static_cast<int*>(outs[i]);
    d->match[k] = match ? static_cast<const int*>(match[i]) : nullptr;
    d->units[k] = units[i];
    d->unit_base[k] = unit_base[i];
    d->tile_end[k] = tiles;
    d->width[k] = widths[i];
    d->stride[k] = S;
    d->elem[k] = elem ? elem[i] : 4;
  }
  d->n = n;
  *total_units = acc;
  return cudaSuccess;
}

// The layout and grid of a kernel that probes the slot image (the fused
// and the match kernel, k_shared / k_global its two layouts): the image in
// shared memory when it fits beside the kernel's static shared memory and
// one block still fits on an SM, unless force_global; persistent blocks,
// as many as fit and none without a tile.
int plan_probe(const void* k_shared, const void* k_global, long long n_tiles,
               long long image_bytes, bool force_global, bool* shared, unsigned* blocks) {
  int rc, dev = 0, sms = 0, optin = 0, per_sm = 0;
  if ((rc = cudaGetDevice(&dev)) != cudaSuccess) return rc;
  if ((rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return rc;
  if ((rc = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return rc;
  *shared = false;
  if (!force_global) {
    cudaFuncAttributes fa;
    if ((rc = cudaFuncGetAttributes(&fa, k_shared)) != cudaSuccess) return rc;
    *shared = image_bytes + (long long)fa.sharedSizeBytes <= optin;
    if (*shared) {
      rc = cudaFuncSetAttribute(k_shared, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)image_bytes);
      if (rc != cudaSuccess) return rc;
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k_shared, kBlock,
                                                         (size_t)image_bytes);
      if (rc != cudaSuccess) return rc;
      *shared = per_sm > 0;
    }
  }
  if (!*shared) {
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k_global, kBlock, 0);
    if (rc != cudaSuccess) return rc;
  }
  if (per_sm < 1) per_sm = 1;  // the launch itself then reports the failure
  *blocks = (unsigned)std::min((long long)sms * per_sm, n_tiles);
  return cudaSuccess;
}

int check_image(int off_words, int image_words, int max_len) {
  return max_len < 0 || off_words % 4 || image_words % 4 || image_words < off_words
             ? cudaErrorInvalidValue
             : cudaSuccess;
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each returns
// cudaGetLastError() after its launch, or cudaErrorInvalidValue for
// arguments the kernel does not take.  Launches on `stream`, never
// synchronises, allocates nothing.  *mode_out is 0 (the slot image in
// shared memory), 1 (in global memory, or no table) or -1 (no tiles:
// nothing launched).
//
// The table: `image` is int32[image_words]: the (max_len + 1) * 128 + 1
// slot offsets, padded to off_words, then the slots' 16-bit k1
// fingerprints, padded to 8-slot chunks; `slot_keys` is int4[slots] {k1,
// k2, tid, 0}.  force_global != 0 reads the image from global memory even
// when it fits in shared memory.

// Match+commit of every bucket in one launch.  `counts` receives each
// unit's emit count (caller order).
extern "C" int wp_word_match_commit(
    int n_buckets, const void* const* cps, const int* elem_bytes,
    const long long* n_units, const int* widths, void* const* outs,
    const void* image, int off_words, int image_words, const void* slot_keys,
    const void* lane_salts, int max_len, unsigned int mult1, unsigned int mult2,
    int unk_id, void* counts, int force_global, int* mode_out, void* stream) {
  *mode_out = -1;
  Buckets d;
  long long total = 0;
  int rc = fill_buckets(&d, n_buckets, cps, elem_bytes, n_units, widths, outs, true, &total);
  if (rc == cudaSuccess) rc = check_image(off_words, image_words, max_len);
  if (rc != cudaSuccess) return rc;
  const long long n_tiles = d.tile_end[d.n - 1];
  if (n_tiles == 0) return cudaSuccess;
  const long long image_bytes = (long long)image_words * 4;
  bool shared;
  unsigned blocks;
  rc = plan_probe((const void*)word_match_commit_kernel<true>,
                  (const void*)word_match_commit_kernel<false>, n_tiles, image_bytes,
                  force_global, &shared, &blocks);
  if (rc != cudaSuccess) return rc;
  auto k = shared ? word_match_commit_kernel<true> : word_match_commit_kernel<false>;
  k<<<blocks, kBlock, shared ? (size_t)image_bytes : 0, static_cast<cudaStream_t>(stream)>>>(
      d, static_cast<const int*>(image), off_words, (int)image_bytes,
      static_cast<const int4*>(slot_keys), static_cast<const uint32_t*>(lane_salts), max_len,
      mult1, mult2, unk_id, static_cast<int*>(counts));
  *mode_out = shared ? 0 : 1;
  return (int)cudaGetLastError();
}

// Every position's longest in-window hit, every bucket in one launch:
// `packed` are int32[units, width] per bucket, (best_len << 24) | best_id
// for a hit and 0 for none; widths <= 127.
extern "C" int wp_word_match(
    int n_buckets, const void* const* cps, const int* elem_bytes,
    const long long* n_units, const int* widths, void* const* packed,
    const void* image, int off_words, int image_words, const void* slot_keys,
    const void* lane_salts, int max_len, unsigned int mult1, unsigned int mult2,
    int force_global, int* mode_out, void* stream) {
  *mode_out = -1;
  Buckets d;
  long long total = 0;
  int rc = fill_buckets(&d, n_buckets, cps, elem_bytes, n_units, widths, packed, true, &total,
                        nullptr, kThreads, kMaxSplitWidth, true);
  if (rc == cudaSuccess) rc = check_image(off_words, image_words, max_len);
  if (rc != cudaSuccess) return rc;
  const long long n_tiles = d.tile_end[d.n - 1];
  if (n_tiles == 0) return cudaSuccess;
  const long long image_bytes = (long long)image_words * 4;
  bool shared;
  unsigned blocks;
  rc = plan_probe((const void*)word_match_kernel<true>, (const void*)word_match_kernel<false>,
                  n_tiles, image_bytes, force_global, &shared, &blocks);
  if (rc != cudaSuccess) return rc;
  auto k = shared ? word_match_kernel<true> : word_match_kernel<false>;
  k<<<blocks, kBlock, shared ? (size_t)image_bytes : 0, static_cast<cudaStream_t>(stream)>>>(
      d, static_cast<const int*>(image), off_words, (int)image_bytes,
      static_cast<const int4*>(slot_keys), static_cast<const uint32_t*>(lane_salts), max_len,
      mult1, mult2);
  *mode_out = shared ? 0 : 1;
  return (int)cudaGetLastError();
}

// The walk, rollback and emit of every bucket in one launch, from the
// given (combined) packed matches int32[units, width] (wp_word_match's
// layout; widths <= 127): writes the emit matrices `outs` and each unit's
// emit count to `counts` (caller order); one block per tile of
// kCommitTile positions.
extern "C" int wp_word_commit(
    int n_buckets, const void* const* cps, const int* elem_bytes,
    const long long* n_units, const int* widths, const void* const* packed, void* const* outs,
    int max_len, int unk_id, void* counts, int* mode_out, void* stream) {
  *mode_out = -1;
  Buckets d;
  long long total = 0;
  int rc = fill_buckets(&d, n_buckets, cps, elem_bytes, n_units, widths, outs, true, &total,
                        packed, kCommitTile, kMaxSplitWidth);
  if (rc == cudaSuccess && max_len < 0) rc = cudaErrorInvalidValue;
  if (rc != cudaSuccess) return rc;
  const long long n_tiles = d.tile_end[d.n - 1];
  if (n_tiles == 0) return cudaSuccess;
  word_commit_kernel<<<(unsigned)n_tiles, kCommitTile, 0, static_cast<cudaStream_t>(stream)>>>(
      d, max_len, unk_id, static_cast<int*>(counts));
  *mode_out = 1;
  return (int)cudaGetLastError();
}

// The compact vector int32[1 + n + cap] from the emit matrices: `fused[1 :
// 1 + n]` already holds the per-unit counts (caller order); writes
// fused[0] = total and the first `cap` entries, in one cooperative launch.
// `chunk_sums` is int32[scratch] for this call alone, one entry per chunk
// of kChunkUnits units of a bucket.  fused is 16-byte aligned.
extern "C" int wp_compact_emits(int n_buckets, void* const* emits, const long long* n_units,
                                const int* widths, void* fused, int cap, void* chunk_sums,
                                int scratch, void* stream) {
  Buckets d;
  long long n = 0;
  int rc = fill_buckets(&d, n_buckets, nullptr, nullptr, n_units, widths, emits, false, &n);
  if (rc != cudaSuccess) return rc;
  long long chunk_count = 0;
  for (int b = 0; b < d.n; ++b) chunk_count += (d.units[b] + kChunkUnits - 1) / kChunkUnits;
  if (cap < 0 || scratch < chunk_count || reinterpret_cast<uintptr_t>(fused) % 16)
    return cudaErrorInvalidValue;
  int* out = static_cast<int*>(fused);
  int* sums = static_cast<int*>(chunk_sums);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0, per_sm = 0;
  if ((rc = cudaGetDevice(&dev)) != cudaSuccess) return rc;
  if ((rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return rc;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, compact_kernel, kCompactThreads,
                                                     0);
  if (rc != cudaSuccess) return rc;
  // Co-resident blocks only (a cooperative launch needs them), at most one
  // per chunk.
  long long blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  blocks = std::max(1LL, std::min(blocks, chunk_count));
  void* args[] = {&d, &n, &chunk_count, &cap, &out, &sums};
  rc = cudaLaunchCooperativeKernel((const void*)compact_kernel, dim3((unsigned)blocks),
                                   dim3(kCompactThreads), args, 0, s);
  if (rc != cudaSuccess) return rc;
  return (int)cudaGetLastError();
}
