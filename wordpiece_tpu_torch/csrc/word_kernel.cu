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
// wordpiece_tpu/ops/word_kernel.py::word_match and ::word_commit, and run
// the tile loop below in two more modes:
//  - match: phases (1) and (2), then every position (not only the visited
//    ones) probes every length of its window against the given table or
//    partition, one thread per position, and writes its longest hit
//    (best_id, best_len), -1 and 0 where nothing hits;
//  - commit: phases (1)-(4), with each visited position's probe replaced
//    by a load of the combined (best_id, best_len); it writes the emit
//    matrices and the counts, as the fused kernel does.
// What bounds the match mode on this card: the same issue and dependent
// reads as the fused kernel, times the positions the walk would have
// skipped (the match probes W positions of a unit, the walk ~1.3); the
// commit mode reads 8 bytes per visited position and probes nothing.

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
constexpr uint32_t kLenMix = 0x9E3779B1u;
constexpr uint32_t kKindMix = 0x85EBCA77u;
constexpr uint32_t kSpaceToken = 9601u;  // U+2581

constexpr uint8_t kSpace = 1;
constexpr uint8_t kPunct = 2;
constexpr uint8_t kSpacing = 4;

// What a launch of the tile loop computes.
constexpr int kFused = 0;   // match+commit: emits and counts
constexpr int kMatch = 1;   // every position's longest hit
constexpr int kCommit = 2;  // emits and counts from given matches

// The buckets of one dispatch, in tile order (widest first).
struct Buckets {
  const void* cp[kMaxBuckets];    // unit matrix [units, width]
  int* out[kMaxBuckets];          // emit matrix int32[units, width]
  int* ids[kMaxBuckets];          // best_id int32[units, width]: match writes, commit reads
  int* lens[kMaxBuckets];         // best_len int32[units, width]: the same
  long long units[kMaxBuckets];
  long long unit_base[kMaxBuckets];  // first unit's index in the counts
  long long tile_end[kMaxBuckets];   // running sum of tiles, in tile order
  int width[kMaxBuckets];
  int stride[kMaxBuckets];  // S
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

// The tile loop of all three kernels; kMode is kFused, kMatch or kCommit
// (the notes at the top of this file).
template <bool kSharedKeys, int kMode>
__device__ __forceinline__ void run_tiles(const Buckets& d, const int* __restrict__ image,
                                          int off_words, int image_bytes,
                                          const int4* __restrict__ slot_keys,
                                          const uint32_t* __restrict__ lane_salts, int max_len,
                                          uint32_t mult1, uint32_t mult2, int unk_id,
                                          int* __restrict__ counts) {
  constexpr bool kProbes = kMode != kCommit;  // reads the length tables
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

  if (kProbes && (int)threadIdx.x < kThreads && (int)threadIdx.x <= max_len)
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

    if constexpr (kMode == kMatch) {
      // ---- every position's longest in-window hit (ops/word_kernel.py:
      // 121-168): one thread per position, its lengths in order, each
      // length's fingerprint hits confirmed against the full keys; the
      // longest confirmed length wins.
      if (live) {
        const uint32_t* ch = s_cp + me;
        const int lmax = min(window_at(m_spacing, m_punct, j, W, max_len), max_len);
        const uint32_t kind_mix = bit_at(m_prefix, j) ? kKindMix : 0u;
        uint32_t h1 = 0u, h2 = 0u;
        int best_l = 0, best_id = -1;
        for (int l = 1; l <= lmax; ++l) {
          h1 = h1 * mult1 + ch[l - 1];
          h2 = h2 * mult2 + ch[l - 1];
          const ListProbe pr = list_probe(h1, h2, l, kind_mix, s_salt, offs);
          const FpHits hits = list_fp_hits(fps, pr);
          if (hits.n) {
            const int tid = confirm_hits(fps, slot_keys, pr, hits);
            if (tid >= 0) {
              best_l = l;
              best_id = tid;
            }
          }
        }
        d.ids[b][u * W + j] = best_id;
        d.lens[b][u * W + j] = best_l;
      }
    } else {
      // ---- the greedy walk, probing only the positions it visits --------
      // (ops/word_kernel.py:86-141 for the probe, :144-183 for the walk.)
      // The G = min(S, 32) lanes of a unit walk it together: at each
      // visited position lane q scans the lists of lengths q + 1, q + 1 +
      // G, ... within the window, the unit takes the longest length whose
      // list holds the fingerprint, and its lane confirms the full keys in
      // global memory; on a miss (a fingerprint collision) the next longest
      // is tried, so the result is exact.  Positions the walk skips are
      // never probed: the commit reads nothing of them.  The commit mode
      // loads the given match of each visited position instead.
      // The fused mode's statements keep the shape they had before the
      // modes were added (umask, ch and pre computed here, the confirm
      // written out below): hoisted into the probe branch, with
      // confirm_hits, they cost the fused kernel 2 registers and 1-8% of
      // its time at chip_smoke.py's first dispatches on an H100.
      const int G = min(S, 32);
      [[maybe_unused]] const unsigned umask =
          G == 32 ? 0xFFFFFFFFu : ((1u << G) - 1u) << (lane & ~(G - 1));
      int n_vis = 0;
      int p = 0;
      bool walking = valid && j < G;
      while (__any_sync(0xFFFFFFFFu, walking)) {
        [[maybe_unused]] const uint32_t* ch = s_cp + gbase + p;
        int window = 1;
        [[maybe_unused]] bool pre = false;
        if (walking) {
          pre = bit_at(m_prefix, p);
          window = window_at(m_spacing, m_punct, p, W, max_len);
        }
        int hit_l = 0, hit_tid = -1;
        if constexpr (kMode == kCommit) {
          if (walking) {
            // ops/word_kernel.py::word_commit: matched iff best_len > 0,
            // landing at most at the unit end.
            const long long at = u * W + p;
            hit_l = min(max(__ldg(d.lens[b] + at), 0), W);
            hit_tid = __ldg(d.ids[b] + at);
          }
        } else {
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
    }
    group_sync(g);  // the next tile reuses the group's scratch
  }
  // A block never exits with its bulk copy still in flight.
  if (!staged) mbar_wait(&s_bar, 0);
}

#define WORD_KERNEL_PARAMS                                                                   \
  const Buckets d, const int* __restrict__ image, int off_words, int image_bytes,           \
      const int4* __restrict__ slot_keys, const uint32_t* __restrict__ lane_salts,           \
      int max_len, uint32_t mult1, uint32_t mult2, int unk_id, int* __restrict__ counts
#define WORD_KERNEL_ARGS \
  d, image, off_words, image_bytes, slot_keys, lane_salts, max_len, mult1, mult2, unk_id, counts

template <bool kSharedKeys>
__global__ void __launch_bounds__(kBlock, 1) word_match_commit_kernel(WORD_KERNEL_PARAMS) {
  run_tiles<kSharedKeys, kFused>(WORD_KERNEL_ARGS);
}

template <bool kSharedKeys>
__global__ void __launch_bounds__(kBlock, 1) word_match_kernel(WORD_KERNEL_PARAMS) {
  run_tiles<kSharedKeys, kMatch>(WORD_KERNEL_ARGS);
}

__global__ void __launch_bounds__(kBlock, 1) word_commit_kernel(WORD_KERNEL_PARAMS) {
  run_tiles<false, kCommit>(WORD_KERNEL_ARGS);
}

using WordKernel = void (*)(WORD_KERNEL_PARAMS);

WordKernel word_kernel(int mode, bool shared_keys) {
  if (mode == kMatch) return shared_keys ? word_match_kernel<true> : word_match_kernel<false>;
  if (mode == kCommit) return word_commit_kernel;
  return shared_keys ? word_match_commit_kernel<true> : word_match_commit_kernel<false>;
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
compact_kernel(const Buckets d, long long n, long long n_chunks, int cap,
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
  for (long long c = c0 + grid; c < n_chunks; c += grid) {
    const Chunk k = chunk_at(d, c);
    const long long first = d.unit_base[k.b] + k.u;
    block_scan(t < k.len ? counts[first + t] : 0, 0, s_warp, &total, &none);
    if (t == 0) chunk_sums[c] = total;
  }
  cooperative_groups::this_grid().sync();
  if (n_chunks == 0) {
    if (t == 0) fused[0] = 0;
    return;
  }
  // ---- phase 2: the first chunk's offset, then its entries ---------------
  int part = 0;
  for (long long j = t; j < c0; j += kCompactThreads) part += __ldcg(chunk_sums + j);
  block_scan(0, part, s_warp, &none, &base0);
  long long base = base0;
  if (c0 == n_chunks - 1 && t == 0) fused[0] = (int)(base + sum0);
  if (r0.ua < r0.ub)
    place_run(d.width[k0.b], r0, (int)(base + s_off[r0.ua]), pre, cap, dst, lane);
  long long sum = sum0;
  for (long long c = c0 + grid; c < n_chunks; c += grid) {
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
    if (c == n_chunks - 1 && t == 0) fused[0] = (int)(base + sum);
    __syncthreads();
    const Run r = run_of(d, k, w);
    prefetch_run(r, lane, pre);
    if (r.ua < r.ub) place_run(d.width[k.b], r, (int)(base + s_off[r.ua]), pre, cap, dst, lane);
  }
}

// Fills `d` from the caller's bucket arrays (caller order); entries are
// stored widest first if `widest_first`, else in caller order.
// `cps`/`elem` may be null (the compaction), `ids`/`lens` (the match
// matrices) are null but for the match and commit kernels.
int fill_buckets(Buckets* d, int n, const void* const* cps, const int* elem,
                 const long long* units, const int* widths, void* const* outs,
                 bool widest_first, long long* total_units, void* const* ids = nullptr,
                 void* const* lens = nullptr) {
  if (n < 1 || n > kMaxBuckets) return cudaErrorInvalidValue;
  long long unit_base[kMaxBuckets];
  int order[kMaxBuckets];
  long long acc = 0;
  for (int i = 0; i < n; ++i) {
    if (widths[i] < 1 || widths[i] >= kThreads || units[i] < 0)
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
    int S = 1;
    while (S < widths[i] + 1) S <<= 1;
    const int per_tile = kThreads / S;
    tiles += (units[i] + per_tile - 1) / per_tile;
    d->cp[k] = cps ? cps[i] : nullptr;
    d->out[k] = static_cast<int*>(outs[i]);
    d->ids[k] = ids ? static_cast<int*>(ids[i]) : nullptr;
    d->lens[k] = lens ? static_cast<int*>(lens[i]) : nullptr;
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

// Launches the tile loop in `mode` over the tiles of `d`, as many
// persistent blocks as fit and no block without a tile.  The match modes
// take the slot image in shared memory when it fits beside the kernel's
// static shared memory and one block still fits on an SM, unless
// force_global; the commit reads no table.  *mode_out is 0 (shared keys),
// 1 (global keys or no keys) or -1 (no tiles: nothing launched).
int launch_tiles(int mode, const Buckets& d, const void* image, int off_words, int image_words,
                 const void* slot_keys, const void* lane_salts, int max_len, unsigned int mult1,
                 unsigned int mult2, int unk_id, void* counts, int force_global, int* mode_out,
                 void* stream) {
  *mode_out = -1;
  if (max_len < 0) return cudaErrorInvalidValue;
  const bool probes = mode != kCommit;
  if (probes && (off_words % 4 || image_words % 4 || image_words < off_words))
    return cudaErrorInvalidValue;
  const long long n_tiles = d.tile_end[d.n - 1];
  if (n_tiles == 0) return cudaSuccess;

  int rc, dev = 0, sms = 0, optin = 0;
  if ((rc = cudaGetDevice(&dev)) != cudaSuccess) return rc;
  if ((rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return rc;
  if ((rc = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return rc;
  const long long image_bytes = probes ? (long long)image_words * 4 : 0;
  bool shared = false;
  int per_sm = 0;
  if (probes && !force_global) {
    const WordKernel k = word_kernel(mode, true);
    cudaFuncAttributes fa;
    if ((rc = cudaFuncGetAttributes(&fa, k)) != cudaSuccess) return rc;
    shared = image_bytes + (long long)fa.sharedSizeBytes <= optin;
    if (shared) {
      rc = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)image_bytes);
      if (rc != cudaSuccess) return rc;
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, kBlock, (size_t)image_bytes);
      if (rc != cudaSuccess) return rc;
      shared = per_sm > 0;
    }
  }
  const WordKernel k = word_kernel(mode, shared);
  if (!shared) {
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, kBlock, 0);
    if (rc != cudaSuccess) return rc;
  }
  if (per_sm < 1) per_sm = 1;  // the launch itself then reports the failure
  long long blocks = (long long)sms * per_sm;
  if (blocks > n_tiles) blocks = n_tiles;

  k<<<(unsigned)blocks, kBlock, shared ? (size_t)image_bytes : 0,
      static_cast<cudaStream_t>(stream)>>>(
      d, static_cast<const int*>(image), off_words, (int)image_bytes,
      static_cast<const int4*>(slot_keys), static_cast<const uint32_t*>(lane_salts), max_len,
      mult1, mult2, unk_id, static_cast<int*>(counts));
  *mode_out = shared ? 0 : 1;
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each returns
// cudaGetLastError() after its launch, or cudaErrorInvalidValue for
// arguments the kernel does not take.  Launches on `stream`, never
// synchronises, allocates nothing.  *mode_out as launch_tiles sets it.
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
  if (rc != cudaSuccess) return rc;
  return launch_tiles(kFused, d, image, off_words, image_words, slot_keys, lane_salts, max_len,
                      mult1, mult2, unk_id, counts, force_global, mode_out, stream);
}

// Every position's longest in-window hit, every bucket in one launch:
// best_ids / best_lens are int32[units, width] per bucket (-1 / 0 where
// nothing hits).
extern "C" int wp_word_match(
    int n_buckets, const void* const* cps, const int* elem_bytes,
    const long long* n_units, const int* widths, void* const* best_ids, void* const* best_lens,
    const void* image, int off_words, int image_words, const void* slot_keys,
    const void* lane_salts, int max_len, unsigned int mult1, unsigned int mult2,
    int force_global, int* mode_out, void* stream) {
  *mode_out = -1;
  Buckets d;
  long long total = 0;
  int rc = fill_buckets(&d, n_buckets, cps, elem_bytes, n_units, widths, best_ids, true, &total,
                        best_ids, best_lens);
  if (rc != cudaSuccess) return rc;
  return launch_tiles(kMatch, d, image, off_words, image_words, slot_keys, lane_salts, max_len,
                      mult1, mult2, -1, nullptr, force_global, mode_out, stream);
}

// The walk, rollback and emit of every bucket in one launch, from the
// given (combined) matches best_ids / best_lens int32[units, width]:
// writes the emit matrices `outs` and each unit's emit count to `counts`
// (caller order).
extern "C" int wp_word_commit(
    int n_buckets, const void* const* cps, const int* elem_bytes,
    const long long* n_units, const int* widths, void* const* best_ids, void* const* best_lens,
    void* const* outs, int max_len, int unk_id, void* counts, int* mode_out, void* stream) {
  *mode_out = -1;
  Buckets d;
  long long total = 0;
  int rc = fill_buckets(&d, n_buckets, cps, elem_bytes, n_units, widths, outs, true, &total,
                        best_ids, best_lens);
  if (rc != cudaSuccess) return rc;
  return launch_tiles(kCommit, d, nullptr, 0, 0, nullptr, nullptr, max_len, 0u, 0u, unk_id,
                      counts, 1, mode_out, stream);
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
  long long n_chunks = 0;
  for (int b = 0; b < d.n; ++b) n_chunks += (d.units[b] + kChunkUnits - 1) / kChunkUnits;
  if (cap < 0 || scratch < n_chunks || reinterpret_cast<uintptr_t>(fused) % 16)
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
  blocks = std::max(1LL, std::min(blocks, n_chunks));
  void* args[] = {&d, &n, &n_chunks, &cap, &out, &sums};
  rc = cudaLaunchCooperativeKernel((const void*)compact_kernel, dim3((unsigned)blocks),
                                   dim3(kCompactThreads), args, 0, s);
  if (rc != cudaSuccess) return rc;
  return (int)cudaGetLastError();
}
