// A single-pass tile scan with decoupled look-back (Merrill and Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back"), forward or
// reverse, with a min or a sum operator, over a few channels at once (one
// look-back warp each), and a carry chain with the reset op.  The kernels
// of csrc/text_features.cu (a reverse min over three flags) and
// csrc/commit.cu (a forward sum, and the walk's carry chain) use them.
//
// How a kernel uses it:
//  - every block takes a ticket from an atomic counter (TileScan::ticket):
//    the q-th block to start handles the q-th tile in scan order (from
//    the left for a forward scan, from the right for a reverse one), so
//    the tiles a block waits for have all started, and no cooperative
//    launch or grid barrier is needed;
//  - each thread scans its own items, then TileScan::block_scan gives
//    every thread the scan of the threads before it in scan order and the
//    tile's aggregate;
//  - TileScan::look_back publishes the aggregate, then one warp a channel
//    reads the status words of the 32 tiles before it at a time, until one
//    of them holds an inclusive prefix, and publishes the tile's own
//    inclusive prefix.  A run of tiles that add nothing (a text with no
//    spacing over many tiles) is passed 32 tiles a step.
//
// A status word is 64 bits, the state in the high half and the value in
// the low half, written and read whole (relaxed, at gpu scope), so no fence
// orders a value against its flag.  The scratch is a 64-bit ticket, then
// one status word a tile and channel: the caller zeroes it on the stream
// before the launch (scan_scratch_bytes).
//
// The reset op (CarryChain): a carry that a tile either sets from its own
// items, whatever came before it (a reset), passes on unchanged (the
// identity), or computes from its predecessor's carry by a function that
// is not known until then (the commit walk's exit from a tile inside a
// unit longer than a tile).  A reset is published at once as an inclusive
// prefix, the identity at once as an aggregate; a tile of the third kind
// publishes its prefix once it has the carry in.  The carry into a tile
// is found by a look-back of one warp that passes 32 identity tiles a
// step and stops at the nearest prefix, so only runs of the third kind
// are serial, one look-back a tile.  The scratch is a 64-bit ticket, then
// one status word a tile (carry_scratch_bytes), zeroed by the caller.

#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace wp {

struct MinOp {
  static constexpr int kIdentity = INT_MAX;
  static __device__ __forceinline__ int apply(int a, int b) { return min(a, b); }
};

struct SumOp {
  static constexpr int kIdentity = 0;
  static __device__ __forceinline__ int apply(int a, int b) { return a + b; }
};

enum : uint32_t { kStatusInvalid = 0u, kStatusAggregate = 1u, kStatusPrefix = 2u };

// Bytes of scratch a scan of `tiles` tiles over `channels` channels needs.
inline size_t scan_scratch_bytes(int channels, long long tiles) {
  return sizeof(unsigned long long) * (1 + (size_t)channels * (size_t)tiles);
}

__device__ __forceinline__ unsigned long long status_word(uint32_t state, int value) {
  return ((unsigned long long)state << 32) | (uint32_t)value;
}

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(w) : "l"(p) : "memory");
  return w;
}

__device__ __forceinline__ void store_status(unsigned long long* p, unsigned long long w) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(w) : "memory");
}

// Bytes of scratch a carry chain over `tiles` tiles needs.
inline size_t carry_scratch_bytes(long long tiles) {
  return sizeof(unsigned long long) * (1 + (size_t)tiles);
}

struct CarryChain {
  // This block's tile, in the order the blocks started (0 first); one
  // thread calls it and shares the result.
  static __device__ __forceinline__ int ticket(void* scratch) {
    return (int)atomicAdd(static_cast<unsigned int*>(scratch), 1u);
  }
  static __device__ __forceinline__ unsigned long long* status(void* scratch) {
    return static_cast<unsigned long long*>(scratch) + 1;
  }
  // Publishes tile q's carry out as an inclusive prefix (one thread).
  static __device__ __forceinline__ void publish(void* scratch, int q, int carry) {
    store_status(status(scratch) + q, status_word(kStatusPrefix, carry));
  }
  // Publishes that tile q passes its carry on unchanged (one thread).
  static __device__ __forceinline__ void pass(void* scratch, int q) {
    store_status(status(scratch) + q, status_word(kStatusAggregate, 0));
  }
  // The carry into tile q, in every lane of one whole warp: the nearest
  // prefix before q past the tiles that pass theirs on, or `first` when
  // every tile before q passes.
  static __device__ int wait(void* scratch, int q, int first) {
    const int lane = threadIdx.x & 31;
    const unsigned long long* st = status(scratch);
    for (long long base = (long long)q - 1;; base -= 32) {
      const long long idx = base - lane;
      // Read again until the nearest tile that does not pass is a prefix,
      // or every one of the 32 passes.
      for (;;) {
        const unsigned long long w =
            idx >= 0 ? load_status(st + idx) : status_word(kStatusPrefix, first);
        const uint32_t state = (uint32_t)(w >> 32);
        const unsigned stops = __ballot_sync(~0u, state != kStatusAggregate);
        if (!stops) break;
        const int near = __ffs(stops) - 1;
        if (__shfl_sync(~0u, state, near) == kStatusPrefix)
          return __shfl_sync(~0u, (int)(uint32_t)w, near);
      }
    }
  }
};

template <int kThreads, int kChannels, class Op, bool kReverse>
struct TileScan {
  static_assert(kThreads % 32 == 0 && kThreads <= 1024, "whole warps");
  static_assert(kChannels >= 1 && kChannels <= kThreads / 32, "one look-back warp a channel");
  static constexpr int kWarps = kThreads / 32;

  struct Storage {
    int warp_total[kChannels][kWarps];
    int tile_prefix[kChannels];
    int ticket;
  };

  // The scratch's ticket counter, then the status words of channel c at
  // status(scratch) + c * tiles.
  static __device__ __forceinline__ unsigned int* counter(void* scratch) {
    return static_cast<unsigned int*>(scratch);
  }
  static __device__ __forceinline__ unsigned long long* status(void* scratch) {
    return static_cast<unsigned long long*>(scratch) + 1;
  }

  // This block's place in scan order: 0 for the first block to start.
  static __device__ int ticket(void* scratch, Storage& s) {
    if (threadIdx.x == 0) s.ticket = (int)atomicAdd(counter(scratch), 1u);
    __syncthreads();
    return s.ticket;
  }

  // Exclusive scan of the threads' values in scan order (thread 0 first
  // for a forward scan, the last thread first for a reverse one): excl[c]
  // combines the values of the threads before this one; agg[c] is the
  // tile's aggregate, the same in every thread.
  static __device__ void block_scan(const int (&v)[kChannels], int (&excl)[kChannels],
                                    int (&agg)[kChannels], Storage& s) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int in_warp[kChannels];
#pragma unroll
    for (int c = 0; c < kChannels; ++c) {
      int x = v[c];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int o = kReverse ? __shfl_down_sync(~0u, x, d) : __shfl_up_sync(~0u, x, d);
        if (kReverse ? lane + d < 32 : lane >= d) x = Op::apply(x, o);
      }
      const int e = kReverse ? __shfl_down_sync(~0u, x, 1) : __shfl_up_sync(~0u, x, 1);
      in_warp[c] = (kReverse ? lane == 31 : lane == 0) ? Op::kIdentity : e;
      if (lane == (kReverse ? 0 : 31)) s.warp_total[c][warp] = x;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kChannels; ++c) {
      int before = Op::kIdentity, all = Op::kIdentity;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int t = s.warp_total[c][w];
        all = Op::apply(all, t);
        if (kReverse ? w > warp : w < warp) before = Op::apply(before, t);
      }
      excl[c] = Op::apply(before, in_warp[c]);
      agg[c] = all;
    }
  }

  // Publishes the tile's aggregates and returns in prefix[c] the
  // combination of every tile before it in scan order (the identity for
  // the first).  `tiles` is the number of tiles, q this block's ticket.
  static __device__ void look_back(void* scratch, long long tiles, int q,
                                   const int (&agg)[kChannels], int (&prefix)[kChannels],
                                   Storage& s) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (warp < kChannels) {
      const int c = warp;
      unsigned long long* st = status(scratch) + (size_t)c * (size_t)tiles;
      const int a = agg[c];
      int excl = Op::kIdentity;
      if (q == 0) {
        if (lane == 0) store_status(st, status_word(kStatusPrefix, a));
      } else {
        if (lane == 0) store_status(st + q, status_word(kStatusAggregate, a));
        for (long long base = (long long)q - 1;; base -= 32) {
          const long long idx = base - lane;
          unsigned long long w;
          // Tiles before the first count as prefixes holding the identity.
          do {
            w = idx >= 0 ? load_status(st + idx) : status_word(kStatusPrefix, Op::kIdentity);
          } while (__any_sync(~0u, (uint32_t)(w >> 32) == kStatusInvalid));
          const unsigned prefixes = __ballot_sync(~0u, (uint32_t)(w >> 32) == kStatusPrefix);
          int x = (int)(uint32_t)w;
          // The nearest prefix ends the walk: the tiles past it are in it.
          if (prefixes && lane > __ffs(prefixes) - 1) x = Op::kIdentity;
#pragma unroll
          for (int d = 16; d; d >>= 1) x = Op::apply(x, __shfl_xor_sync(~0u, x, d));
          excl = Op::apply(excl, x);
          if (prefixes) break;
        }
        if (lane == 0) store_status(st + q, status_word(kStatusPrefix, Op::apply(excl, a)));
      }
      if (lane == 0) s.tile_prefix[c] = excl;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kChannels; ++c) prefix[c] = s.tile_prefix[c];
  }
};

}  // namespace wp
