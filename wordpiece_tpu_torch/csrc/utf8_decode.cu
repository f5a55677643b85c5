// UTF-8 bytes to the whole-text engine's padded codepoint bucket, for
// Hopper (sm_90a).
//
// It replaces no TPU kernel: the JAX engine (wordpiece_tpu/engine.py)
// decodes on the host (core/unicode.py::decode_utf8) and copies the padded
// codepoints.  It was added because on the H100 the host's decode and the
// padding of the bucket were 86% of a fast-stream call on a 10 MB en file
// (45.9 and 36.0 of 93.3 ms), and the pageable copy of the 50 MB bucket
// another 11%.  With it the host copies the bytes, not the bucket.
//
// The rule.  Under decode_utf8's semantics (an invalid byte is dropped and
// consumes one byte) a continuation byte never emits, and no valid sequence
// covers a non-continuation byte.  So byte i emits exactly when it leads a
// valid sequence: its length from the lead, the continuation bytes after
// it inside the buffer, the shortest encoding (>= 0x80, 0x800, 0x10000)
// and no surrogate or value past U+10FFFF.  That reads bytes i..i+3 alone,
// which makes the decode a stream compaction.  The plain version
// decode_plain in ops/utf8_decode.py computes the same rule with whole-array
// ops; the CPU tests hold it to decode_utf8.
//
// Two kernels over 4,096-byte tiles (16 bytes a thread, one 16-byte load,
// and the 3 bytes after the tile; bytes at and past n read as 0, which
// continues nothing, so a sequence cut off by the end is invalid):
//  - utf8_count_kernel: each thread counts the bytes that emit; a forward
//    sum scan with decoupled look-back (csrc/scan.cuh) over the tiles, by
//    ticket, leaves every tile's inclusive prefix in the scratch's status
//    words and the total in the scratch.  The total goes to a pinned host
//    word: the host reads it to size the bucket (bucket_size(n) + max_len,
//    the shapes of the JAX engine);
//  - utf8_write_kernel: each tile decodes its bytes again, places its
//    codepoints in shared memory by a block scan, and writes them out at
//    unit stride from the prefix of the tile before it; the blocks past
//    the last tile write zeros over [n_out, size), as 16-byte stores (the
//    features and commit kernels read that padding as 0).
//
// What bounds it on this card: device memory.  It reads the bytes twice
// and writes the bucket once, 2 len + 4 size bytes: ~70 MB for a 10 MB en
// file (the 12,582,912-position bucket), 0.021 ms at 3.35 TB/s.  The
// decode is ~30 integer operations a byte, far under the card's rate.
// Launches a decode: one memset of the scan's status words, the count
// kernel, a 4-byte copy to the host (and, for a document the engine cuts
// into pieces, a copy of the tiles' prefixes); then the write kernel.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;                // bytes a thread
constexpr int kTile = kThreads * kItems;  // 4,096 bytes a tile
constexpr int kZeroChunk = kThreads * 16;  // ints a zeroing block: four 16-byte stores a thread
using Scan = wp::TileScan<kThreads, 1, wp::SumOp, /*kReverse=*/false>;

// The tile's bytes [t0, t0 + kTile) and the 4 after it into buf, as one
// 16-byte load a thread at unit stride; bytes at and past n are 0.
__device__ __forceinline__ void load_tile(const uint8_t* __restrict__ bytes, long long n,
                                          long long t0, uint8_t* buf) {
  const int p = kItems * (int)threadIdx.x;
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (t0 + p + kItems <= n) {
    v = __ldg(reinterpret_cast<const uint4*>(bytes + t0 + p));
  } else {
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < kItems; ++i)
      if (t0 + p + i < n) w[i >> 2] |= (uint32_t)__ldg(bytes + t0 + p + i) << (8 * (i & 3));
    v = make_uint4(w[0], w[1], w[2], w[3]);
  }
  *reinterpret_cast<uint4*>(buf + p) = v;
  if (threadIdx.x < 4) {
    const long long at = t0 + kTile + threadIdx.x;
    buf[kTile + threadIdx.x] = at < n ? __ldg(bytes + at) : 0;
  }
  __syncthreads();
}

__device__ __forceinline__ uint32_t byte_of(const uint32_t (&w)[5], int k) {
  return (w[k >> 2] >> (8 * (k & 3))) & 0xFFu;
}

__device__ __forceinline__ bool continues(uint32_t b) { return (b & 0xC0u) == 0x80u; }

// A thread's kItems bytes, from base: bit e of the result is set where
// byte e lies below n and leads a valid sequence, and cp[e] is then its
// codepoint.
__device__ __forceinline__ uint32_t decode_items(const uint8_t* buf, long long base, long long n,
                                                 int (&cp)[kItems]) {
  const int p = kItems * (int)threadIdx.x;
  const uint4 v = *reinterpret_cast<const uint4*>(buf + p);
  // The next thread's first bytes, or the tile's halo.
  const uint32_t next = *reinterpret_cast<const uint32_t*>(buf + p + kItems);
  const uint32_t w[5] = {v.x, v.y, v.z, v.w, next};
  uint32_t ok = 0u;
#pragma unroll
  for (int e = 0; e < kItems; ++e) {
    const uint32_t b0 = byte_of(w, e), b1 = byte_of(w, e + 1), b2 = byte_of(w, e + 2),
                   b3 = byte_of(w, e + 3);
    uint32_t c = b0;
    bool good = b0 < 0x80u;
    if ((b0 & 0xE0u) == 0xC0u) {
      c = ((b0 & 0x1Fu) << 6) | (b1 & 0x3Fu);
      good = continues(b1) && c >= 0x80u;
    } else if ((b0 & 0xF0u) == 0xE0u) {
      c = ((b0 & 0x0Fu) << 12) | ((b1 & 0x3Fu) << 6) | (b2 & 0x3Fu);
      good = continues(b1) && continues(b2) && c >= 0x800u && (c < 0xD800u || c > 0xDFFFu);
    } else if ((b0 & 0xF8u) == 0xF0u) {
      c = ((b0 & 0x07u) << 18) | ((b1 & 0x3Fu) << 12) | ((b2 & 0x3Fu) << 6) | (b3 & 0x3Fu);
      good = continues(b1) && continues(b2) && continues(b3) && c >= 0x10000u && c < 0x110000u;
    }
    cp[e] = (int)c;
    ok |= (uint32_t)(good && base + e < n) << e;
  }
  return ok;
}

__global__ void __launch_bounds__(kThreads)
    utf8_count_kernel(const uint8_t* __restrict__ bytes, long long n, int tiles, void* scratch,
                      int* __restrict__ total) {
  __shared__ Scan::Storage storage;
  __shared__ __align__(16) uint8_t buf[kTile + 16];
  const int q = Scan::ticket(scratch, storage);
  const long long t0 = (long long)q * kTile;
  load_tile(bytes, n, t0, buf);
  int cp[kItems];
  const int mine[1] = {__popc(decode_items(buf, t0 + kItems * (int)threadIdx.x, n, cp))};
  int excl[1], agg[1], prefix[1];
  Scan::block_scan(mine, excl, agg, storage);
  Scan::look_back(scratch, tiles, q, agg, prefix, storage);
  if (q == tiles - 1 && threadIdx.x == 0) *total = prefix[0] + agg[0];
}

__global__ void __launch_bounds__(kThreads)
    utf8_write_kernel(const uint8_t* __restrict__ bytes, long long n, int tiles,
                      void* scratch, long long n_out, long long size, int* __restrict__ out) {
  if ((int)blockIdx.x >= tiles) {
    // Zeros over [n_out, size): the ints up to the first 16-byte boundary
    // at or after n_out from the first such block, then kZeroChunk ints a
    // block from that boundary.
    const long long a = (n_out + 3) & ~3LL;
    const long long z = (long long)(blockIdx.x - tiles) * kZeroChunk;
    const long long head = n_out + threadIdx.x;
    if (z == 0 && head < a && head < size) out[head] = 0;
#pragma unroll
    for (int k = 0; k < kZeroChunk / (4 * kThreads); ++k) {
      const long long p = a + z + 4 * (k * kThreads + (int)threadIdx.x);
      if (p + 4 <= size) {
        *reinterpret_cast<int4*>(out + p) = make_int4(0, 0, 0, 0);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (p + i < size) out[p + i] = 0;
      }
    }
    return;
  }
  __shared__ Scan::Storage storage;
  __shared__ __align__(16) uint8_t buf[kTile + 16];
  __shared__ int staged[kTile];
  const int q = (int)blockIdx.x;
  const long long t0 = (long long)q * kTile;
  load_tile(bytes, n, t0, buf);
  int cp[kItems];
  const uint32_t ok = decode_items(buf, t0 + kItems * (int)threadIdx.x, n, cp);
  const int mine[1] = {__popc(ok)};
  int excl[1], agg[1];
  Scan::block_scan(mine, excl, agg, storage);
  int at = excl[0];
#pragma unroll
  for (int e = 0; e < kItems; ++e)
    if ((ok >> e) & 1u) staged[at++] = cp[e];
  __syncthreads();
  // The count kernel left every tile's inclusive prefix in its status word.
  const long long start = q == 0 ? 0 : (long long)(uint32_t)Scan::status(scratch)[q - 1];
  for (int j = (int)threadIdx.x; j < agg[0]; j += kThreads) out[start + j] = staged[j];
}

long long tiles_of(long long n) { return (n + kTile - 1) / kTile; }

size_t round16(size_t b) { return (b + 15) & ~(size_t)15; }

// The scratch: the scan's ticket and status words, then the total.
size_t total_at(long long tiles) { return round16(wp::scan_scratch_bytes(1, tiles)); }

bool bytes_ok(long long n) { return n >= 0 && n < (long long)INT_MAX - kTile; }

}  // namespace

// Bytes of scratch a decode of n bytes needs.
extern "C" long long wp_utf8_scratch_bytes(long long n) {
  return (long long)total_at(tiles_of(n)) + 16;
}

// Zeroes the scan's part of `scratch`, launches the count kernel on
// `stream` over the n bytes at `bytes` (16-byte aligned, 0 < n <
// INT_MAX - 4096), and copies the number of codepoints they hold to the
// pinned host int at `total_host`, on the stream.  Returns a cudaError_t.
extern "C" int wp_utf8_count(const void* bytes, long long n, void* scratch, void* total_host,
                             void* stream) {
  if (n <= 0 || !bytes_ok(n)) return cudaErrorInvalidValue;
  const long long tiles = tiles_of(n);
  auto s = static_cast<cudaStream_t>(stream);
  int rc = cudaMemsetAsync(scratch, 0, wp::scan_scratch_bytes(1, tiles), s);
  if (rc != cudaSuccess) return rc;
  int* total = reinterpret_cast<int*>(static_cast<char*>(scratch) + total_at(tiles));
  utf8_count_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(static_cast<const uint8_t*>(bytes), n,
                                                         (int)tiles, scratch, total);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  return (int)cudaMemcpyAsync(total_host, total, sizeof(int), cudaMemcpyDeviceToHost, s);
}

// Copies the count's inclusive prefix of every tile of the n bytes counted
// into `scratch` (the scan's status words, 64 bits each: the state in the
// high half, the codepoints up to and including the tile in the low half)
// to the host at `host` (tiles_of(n) words), on `stream`, after the count
// kernel.  The whole-text engine reads them to cut a long document into
// pieces.  Returns a cudaError_t.
extern "C" int wp_utf8_prefixes(const void* scratch, long long n, void* host, void* stream) {
  if (n <= 0 || !bytes_ok(n)) return cudaErrorInvalidValue;
  // Scan::status(scratch): the status words after the 64-bit ticket.
  const auto* status = static_cast<const unsigned long long*>(scratch) + 1;
  return (int)cudaMemcpyAsync(host, status, tiles_of(n) * sizeof(unsigned long long),
                              cudaMemcpyDeviceToHost, static_cast<cudaStream_t>(stream));
}

// Bytes a tile of the count: the prefixes' stride.
extern "C" long long wp_utf8_tile_bytes() { return kTile; }

// Launches the write kernel on `stream`: the n_out codepoints of the n
// bytes at `bytes`, counted by wp_utf8_count into `scratch`, into
// out int32[size] (16-byte aligned), then zeros up to size.  Returns a
// cudaError_t.
extern "C" int wp_utf8_write(const void* bytes, long long n, void* scratch, long long n_out,
                             long long size, void* out, void* stream) {
  if (!bytes_ok(n) || n_out < 0 || n_out > n || size < n_out || size >= INT_MAX)
    return cudaErrorInvalidValue;
  const long long tiles = n > 0 ? tiles_of(n) : 0;
  const long long zeroing = (size - n_out + kZeroChunk - 1) / kZeroChunk;
  if (tiles + zeroing == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  utf8_write_kernel<<<(unsigned)(tiles + zeroing), kThreads, 0, s>>>(
      static_cast<const uint8_t*>(bytes), n, (int)tiles, scratch, n_out, size,
      static_cast<int*>(out));
  return (int)cudaGetLastError();
}
