// Word match+commit kernel for Hopper (sm_90a).
//
// Replaces wordpiece_tpu/ops/word_kernel_pallas.py::_kernel, the TPU
// kernel behind word_match_commit_pallas / _multi / _compact.  It computes
// the same function as the plain PyTorch version in ops/word_kernel.py:
// for every unit (one row of up to W codepoints, columns >= W read as
// space) the longest in-window vocabulary hit per position, the greedy
// walk from position 0, the whole-word UNK rollback, and an emit row of
// token ids (-2 where nothing is emitted).
//
// What bounds it on this card: dependent probe latency into L2, not
// device-memory bytes.  A position probes, for each length l in its
// window, the B_l candidate rows of the length tables at one hashed lane
// (up to ~250 scattered 16-byte reads per width-7 position for a
// bert-sized vocabulary).  The tables are one interleaved int4[R, 128]
// {k1, k2, tid, 0} array (~0.5 MB at bert scale), so a probe is one
// 16-byte __ldg and the whole table stays L2-resident; nothing else is
// done about the latency yet.
//
// Layout: a block of 256 threads holds 256 / S units, S = the power of
// two >= W + 1; thread (g, j) owns position j of unit slot g.  Units are
// staged in shared memory with a space in every column >= W (the
// sentinel column included), so the narrow [U, W] matrix is read once
// and no pad columns cross the bus.  The TPU kernel's 128-lane group
// packing and its crossbar / roll tricks are TPU layout and are dropped.
//
// Phases: (1) char classes; (2) per-position window and probe; (3) one
// thread per unit walks the <= W positions serially over shared memory
// and applies the rollback; (4) every position writes its emit value.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 128;
constexpr uint32_t kLenMix = 0x9E3779B1u;
constexpr uint32_t kKindMix = 0x85EBCA77u;
constexpr uint32_t kSpaceToken = 9601u;  // U+2581

constexpr uint8_t kSpace = 1;
constexpr uint8_t kPunct = 2;
constexpr uint8_t kSpacing = 4;
constexpr uint8_t kWordPrefix = 8;

constexpr uint8_t kVisited = 1;
constexpr uint8_t kKilled = 2;
constexpr uint8_t kSegStart = 4;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
word_match_commit_kernel(const T* __restrict__ cp, long long n_units, int W,
                         int S, const int4* __restrict__ tab,
                         const int* __restrict__ rows_off,
                         const uint32_t* __restrict__ lane_salts, int max_len,
                         uint32_t mult1, uint32_t mult2, int unk_id,
                         int* __restrict__ out) {
  __shared__ uint32_t s_cp[kThreads];
  __shared__ uint8_t s_cls[kThreads];  // classes, read by the window scan
  __shared__ uint8_t s_fl[kThreads];   // classes + word prefix, for the walk
  __shared__ int s_len[kThreads];
  __shared__ int s_id[kThreads];
  __shared__ int s_win[kThreads];
  __shared__ int s_ss[kThreads];
  __shared__ int s_wn[kThreads];
  __shared__ uint8_t s_st[kThreads];

  const int t = threadIdx.x;
  const int units_per_block = kThreads / S;
  const int g = t / S;
  const int j = t - g * S;
  const int gbase = g * S;
  const long long u = (long long)blockIdx.x * units_per_block + g;
  const bool valid = g < units_per_block && u < n_units;
  const bool live = valid && j < W;

  // ---- stage the units; every column >= W reads as space ---------------
  uint32_t c = 32u;
  if (live) c = (uint32_t)cp[u * W + j];
  s_cp[t] = c;
  uint8_t cls = 0;
  if (is_space(c)) cls |= kSpace | kSpacing;
  if (is_punct(c)) cls |= kPunct | kSpacing;
  if (is_chinese(c)) cls |= kSpacing;
  s_cls[t] = cls;
  __syncthreads();

  // ---- word prefix and probe window (src/fast.cpp:38-60) ---------------
  int window = 1;
  if (live) {
    if (j == 0 || (s_cls[t - 1] & kSpacing)) cls |= kWordPrefix;
    if (cls & kSpacing) cls |= kWordPrefix;
    if (!(cls & kPunct)) {
      // Distance to the first spacing char strictly after j, capped at
      // max_len and at the unit end (column W reads as space).
      const int lim = min(W, j + max_len);
      int k = j + 1;
      while (k < lim && !(s_cls[gbase + k] & kSpacing)) ++k;
      window = max(k - j, 1);
    }
  }

  // ---- longest in-window hit (word_kernel.py:99-145) -------------------
  int best_id = -1;
  int best_len = 0;
  if (live) {
    const uint32_t kind = (cls & kWordPrefix) ? 1u : 0u;
    const uint32_t kind_mix = kind * kKindMix;
    uint32_t h1 = 0u, h2 = 0u;
    const int lmax = min(window, max_len);
    for (int l = 1; l <= lmax; ++l) {
      const uint32_t ch = s_cp[gbase + j + l - 1];
      h1 = h1 * mult1 + ch;
      h2 = h2 * mult2 + ch;
      const int r0 = __ldg(rows_off + l);
      const int r1 = __ldg(rows_off + l + 1);
      if (r1 == r0) continue;
      const uint32_t len_mix = (uint32_t)l * kLenMix;
      const int key1 = (int)h1;
      const int key2 = (int)(h2 ^ len_mix ^ kind_mix);
      const uint32_t salt = __ldg(lane_salts + l) | 1u;
      const int lane =
          (int)(((h1 ^ (h2 << 1) ^ len_mix ^ kind_mix) * salt) >> (32 - 7));
      const int4* row = tab + (long long)r0 * kLanes + lane;
      // Rows in order, last hit wins (as the sequential row scan does).
#pragma unroll 4
      for (int r = r0; r < r1; ++r, row += kLanes) {
        const int4 e = __ldg(row);
        if (e.x == key1 && e.y == key2 && e.z >= 0) {
          best_id = e.z;
          best_len = l;
        }
      }
    }
  }
  s_fl[t] = cls;
  s_len[t] = best_len;
  s_id[t] = best_id;
  s_win[t] = window;
  s_st[t] = 0;
  __syncthreads();

  // ---- walk + rollback, one thread per unit (word_kernel.py:148-215) ---
  if (valid && j == 0) {
    int* ss = s_ss + gbase;  // next non-space at or after k; sentinel W
    int* wn = s_wn + gbase;  // next word prefix at or after k; sentinel W
    const uint8_t* cl = s_fl + gbase;
    const int* ln = s_len + gbase;
    const int* wi = s_win + gbase;
    uint8_t* st = s_st + gbase;
    ss[W] = W;
    wn[W] = W;
    for (int k = W - 1; k >= 0; --k) {
      ss[k] = (cl[k] & kSpace) ? ss[k + 1] : k;
      wn[k] = (cl[k] & kWordPrefix) ? k : wn[k + 1];
    }
    // Every step advances >= 1 position, so the walk ends at W.
    int p = 0;
    while (p < W) {
      st[p] = kVisited;
      p = ln[p] > 0 ? ss[min(p + ln[p], W)] : ss[wn[min(p + wi[p], W)]];
    }
    // A visited fail kills every emission back to its segment start; the
    // strict < keeps a fail that IS the next segment start in that later
    // segment.
    int next_fail = W + 1;  // first visited fail at or after k
    int next_seg = W + 1;   // first segment start strictly after k
    for (int k = W - 1; k >= 0; --k) {
      if (!(st[k] & kVisited)) continue;
      if (ln[k] == 0) next_fail = k;
      uint8_t s = kVisited;
      if (next_fail < next_seg) s |= kKilled;
      if (cl[k] & kWordPrefix) {
        s |= kSegStart;
        next_seg = k;
      }
      st[k] = s;
    }
  }
  __syncthreads();

  // ---- emit -------------------------------------------------------------
  if (live) {
    const uint8_t s = s_st[t];
    const bool killed = s & kKilled;
    const bool matched = s_len[t] > 0;
    // Empty (all-space) rows emit nothing.
    const bool empty_row = s_fl[gbase] & kSpace;
    const bool emit = (s & kVisited) && !empty_row &&
                      ((matched && !killed) || ((s & kSegStart) && killed));
    out[u * W + j] = emit ? (killed ? unk_id : s_id[t]) : -2;
  }
}

template <typename T>
void launch(const void* cp, long long n_units, int W, int S, const int4* tab,
            const int* rows_off, const uint32_t* lane_salts, int max_len,
            uint32_t mult1, uint32_t mult2, int unk_id, int* out,
            cudaStream_t stream) {
  const int units_per_block = kThreads / S;
  const long long blocks = (n_units + units_per_block - 1) / units_per_block;
  word_match_commit_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(cp), n_units, W, S, tab, rows_off, lane_salts,
      max_len, mult1, mult2, unk_id, out);
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for arguments the kernel
// does not take.  Launches on `stream`, never synchronises.
extern "C" int wp_word_match_commit(const void* cp, int cp_bytes,
                                    long long n_units, int width,
                                    const void* tab, const void* rows_off,
                                    const void* lane_salts, int max_len,
                                    unsigned int mult1, unsigned int mult2,
                                    int unk_id, void* out, void* stream) {
  if (width < 1 || width >= kThreads || n_units < 0) return cudaErrorInvalidValue;
  if (n_units == 0) return cudaSuccess;
  int S = 1;
  while (S < width + 1) S <<= 1;
  const int4* tb = static_cast<const int4*>(tab);
  const int* ro = static_cast<const int*>(rows_off);
  const uint32_t* ls = static_cast<const uint32_t*>(lane_salts);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cp_bytes) {
    case 1:
      launch<uint8_t>(cp, n_units, width, S, tb, ro, ls, max_len, mult1, mult2,
                      unk_id, o, s);
      break;
    case 2:
      launch<uint16_t>(cp, n_units, width, S, tb, ro, ls, max_len, mult1, mult2,
                       unk_id, o, s);
      break;
    case 4:
      launch<int32_t>(cp, n_units, width, S, tb, ro, ls, max_len, mult1, mult2,
                      unk_id, o, s);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
