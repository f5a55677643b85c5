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
// Table: int32[S, 5] rows {k1, k2, meta = (len << 1) | kind, id, first
// codepoint}, S = 2^log2_size, empty slots have id -1.  The home slot of a
// key is ((h1 ^ h2 << 1 ^ l * 0x9E3779B1 ^ kind * 0x85EBCA77) *
// 0x9E3779B1) >> (32 - log2_size), all on 32 bits; a chain goes on at
// the next slots, modulo S.
//
// The plain version (and the JAX one) probes every length and all
// max_probe slots of every chain.  This kernel stops earlier, with the
// same result:
//  - lengths past window[i] are never accepted, so the loop ends there;
//  - the table is built by linear probing without deletions
//    (core/vocab.py build_index), so an entry lies before any empty slot
//    of its chain: the probe ends at the first empty slot;
//  - (k1, k2, len, kind) is unique in the table, so at most one slot
//    matches: the probe ends at the first match.
//
// What bounds it on this card: one thread per position reads its window of
// codepoints (neighbouring threads, neighbouring addresses) and makes one
// dependent 20-byte table read per probe.  A bert-sized table (2^17 rows,
// 2.6 MB) stays in the 50 MB L2, so the probes are L2 latency, spread over
// all positions of the text; device memory sees the text, the window, the
// kind and the two outputs once (17 bytes per position).  A simple design:
// no shared-memory staging of the table and no warp per word.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kLenMix = 0x9E3779B1u;
constexpr uint32_t kKindMix = 0x85EBCA77u;

__global__ void __launch_bounds__(kThreads)
    match_positions_kernel(const int* __restrict__ cp_pad, const int* __restrict__ window,
                           const uint8_t* __restrict__ wp, const int* __restrict__ table,
                           long long n, int max_len, int max_probe, int log2_size,
                           uint32_t mult1, uint32_t mult2, int* __restrict__ best_id,
                           int* __restrict__ best_len) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint32_t mask = (1u << log2_size) - 1u;
  const uint32_t kind = wp[i] ? 1u : 0u;
  const int first = __ldg(cp_pad + i);
  const int last = min(max_len, __ldg(window + i));
  uint32_t h1 = 0, h2 = 0;
  int bid = -1, blen = 0;
  for (int l = 1; l <= last; ++l) {
    const uint32_t c = (uint32_t)__ldg(cp_pad + i + l - 1);
    h1 = h1 * mult1 + c;
    h2 = h2 * mult2 + c;
    const uint32_t mixed = h1 ^ (h2 << 1) ^ ((uint32_t)l * kLenMix) ^ (kind * kKindMix);
    const uint32_t home = (mixed * kLenMix) >> (32 - log2_size);
    const int meta = (l << 1) | (int)kind;
    for (int p = 0; p < max_probe; ++p) {
      const int* row = table + 5 * (size_t)((home + (uint32_t)p) & mask);
      const int id = __ldg(row + 3);
      if (id < 0) break;  // an empty slot ends the chain
      if ((uint32_t)__ldg(row) == h1 && (uint32_t)__ldg(row + 1) == h2 &&
          __ldg(row + 2) == meta && __ldg(row + 4) == first) {
        bid = id;
        blen = l;
        break;
      }
    }
  }
  best_id[i] = bid;
  best_len[i] = blen;
}

}  // namespace

// Launches the kernel on `stream` over n positions.  Returns a cudaError_t
// (0 on success, including n == 0, which launches nothing).
extern "C" int wp_match_positions(const void* cp_pad, const void* window, const void* wp,
                                  const void* table, long long n, int max_len, int max_probe,
                                  int log2_size, unsigned int mult1, unsigned int mult2,
                                  void* best_id, void* best_len, void* stream) {
  if (n < 0 || max_len < 0 || max_probe < 0 || log2_size < 1 || log2_size > 31)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  match_positions_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cp_pad), static_cast<const int*>(window),
      static_cast<const uint8_t*>(wp), static_cast<const int*>(table), n, max_len, max_probe,
      log2_size, mult1, mult2, static_cast<int*>(best_id), static_cast<int*>(best_len));
  return (int)cudaGetLastError();
}
