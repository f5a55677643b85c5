// Native host runtime of wordpiece_tpu_torch (the PyTorch/CUDA port).
//
// The host passes of the fast word engine (engine_word.py) and the linear
// engine (engine_linear.py) that run on the CPU at memory bandwidth:
//   - UTF-8 decode (wp_decode_utf8);
//   - unit segmentation and cross-chunk dedupe (wp_dedupe_session_*);
//   - filling unique units into width buckets (wp_bucket_fill) and the
//     linear engine's space-joined batches (wp_join_units_cps);
//   - expansion of per-unit token lists to the occurrence stream
//     (wp_expand_total, wp_expand, wp_expand_mt);
//   - the emitted-token check against the vocabulary (wp_verify_emit);
//   - the scalar MaxMatch encoder behind a prebuilt vocabulary handle
//     (wp_vocab_new/free, wp_encode_with, wp_encode_units_with): the host
//     route for small batches and the oracle the engines are held to.
// Counterpart of the reference's src/third_party/utf8.cpp + src/utils.cpp
// roles, written from the semantics (see SURVEY.md §2 C4/C6), not
// translated.
//
// Exposed as a C ABI for ctypes (runtime/loader.py; no pybind11).
//
// Build: make -C wordpiece_tpu_torch/runtime/native (the loader runs it
// when the library is missing or older than this file or the Makefile).
// Forced-scalar A/B and ASan+UBSan runs: tests/test_torch_native_sanitize.py.

#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <vector>

#if defined(__x86_64__)
#include <immintrin.h>
#endif

namespace {

constexpr uint32_t kInvalid = 0x110000;
constexpr uint32_t kSpaceToken = 9601;

inline bool is_cont(uint8_t b) { return (b & 0xC0u) == 0x80u; }

inline bool ok_cp(uint32_t x) { return x < 0xD800u || (0xDFFFu < x && x < 0x110000u); }

// Decode one codepoint; returns consumed bytes (>=1), INVALID on error.
inline uint32_t decode_one(const uint8_t* p, int64_t size, int64_t* consumed) {
  *consumed = 1;
  uint8_t b0 = p[0];
  if (b0 < 0x80u) return b0;
  if ((b0 & 0xE0u) == 0xC0u) {
    if (size >= 2 && is_cont(p[1])) {
      uint32_t cp = ((b0 & 0x1Fu) << 6) | (p[1] & 0x3Fu);
      if (cp >= 0x80u && ok_cp(cp)) { *consumed = 2; return cp; }
    }
  } else if ((b0 & 0xF0u) == 0xE0u) {
    if (size >= 3 && is_cont(p[1]) && is_cont(p[2])) {
      uint32_t cp = ((b0 & 0x0Fu) << 12) | ((p[1] & 0x3Fu) << 6) | (p[2] & 0x3Fu);
      if (cp >= 0x800u && ok_cp(cp)) { *consumed = 3; return cp; }
    }
  } else if ((b0 & 0xF8u) == 0xF0u) {
    if (size >= 4 && is_cont(p[1]) && is_cont(p[2]) && is_cont(p[3])) {
      uint32_t cp = ((b0 & 0x07u) << 18) | ((p[1] & 0x3Fu) << 12) |
                    ((p[2] & 0x3Fu) << 6) | (p[3] & 0x3Fu);
      if (cp >= 0x10000u && ok_cp(cp)) { *consumed = 4; return cp; }
    }
  }
  return kInvalid;
}

inline bool is_space_cp(uint32_t c) {
  return c == ' ' || (c >= 9 && c <= 13) || c == kSpaceToken;
}

inline bool is_punct_cp(uint32_t c) {
  // NB: 183/171/187 are < 256 but NOT C-locale ispunct; the reference
  // includes them via explicit extra terms (utf8.cpp:14-17), so they must
  // be checked outside the ASCII branch.
  if (c < 256) {
    return (c >= 33 && c <= 47) || (c >= 58 && c <= 64) || (c >= 91 && c <= 96) ||
           (c >= 123 && c <= 126) || c == 183 || c == 171 || c == 187;
  }
  return c == 8249 || c == 8250 || (c >= 8208 && c <= 8248);
}

inline bool is_chinese_cp(uint32_t c) {
  return (c >= 0x4E00 && c <= 0x9FFF) || (c >= 0x3400 && c <= 0x4DBF) ||
         (c >= 0x20000 && c <= 0x2A6DF) || (c >= 0x2A700 && c <= 0x2B73F) ||
         (c >= 0x2B740 && c <= 0x2B81F) || (c >= 0x2B820 && c <= 0x2CEAF) ||
         (c >= 0xF900 && c <= 0xFAFF) || (c >= 0x2F800 && c <= 0x2FA1F);
}

inline bool is_spacing_cp(uint32_t c) {
  return is_space_cp(c) || is_punct_cp(c) || is_chinese_cp(c);
}

// BMP codepoint-class LUT: bit0 space, bit1 punct, bit2 chinese.  One
// 64KB table load replaces the ~20-compare chain above in the multibyte
// scan path — kana/kanji-dense corpora classify every char.  Supplement
// (not ground truth): built FROM the is_*_cp predicates, so the A/B
// conformance tests on those predicates cover it.
inline const uint8_t* cp_class_table() {
  static uint8_t t[0x10000];
  static const bool init = [] {
    for (uint32_t c = 0; c < 0x10000; c++) {
      uint8_t v = 0;
      if (is_space_cp(c)) v |= 1;
      if (is_punct_cp(c)) v |= 2;
      if (is_chinese_cp(c)) v |= 4;
      t[c] = v;
    }
    return true;
  }();
  (void)init;
  return t;
}

// Class bits for any codepoint (above the BMP only the CJK extension
// ranges classify; space/punct are all < 0x10000).
inline uint8_t cp_class(uint32_t c) {
  return c < 0x10000 ? cp_class_table()[c] : (is_chinese_cp(c) ? 4 : 0);
}

// First-two-bytes classifier for the scan hot loop: most multibyte
// chars' class is decided by (lead, cont1) alone.  Entry layout:
// (consumed << 3) | class bits; 0 = take the full decode_one path.
//  - 2-byte sequences: the pair IS the codepoint (entry present iff the
//    pair is valid UTF-8, cp >= 0x80).
//  - 3-byte sequences: the pair fixes cp >> 6; an entry is present iff
//    the 64-cp block has ONE class for all members and contains no
//    surrogate/overlong encodings.  Boundary blocks (0x2040s punct end,
//    0x4DC0/0x9FC0 CJK edges, U+2581's block, ...) stay 0 -> slow path.
//    The caller must still verify byte 3 is a continuation byte.
//  - 4-byte leads: always 0 (rare; full decode).
// Built FROM decode_one's validity rules + cp_class, so the scalar A/B
// suite (WP_FORCE_SCALAR) and the random-bytes fuzz cover it.
inline const uint8_t* pair_class_table() {
  static uint8_t t[1 << 16];
  static const bool init = [] {
    std::memset(t, 0, sizeof(t));
    for (uint32_t b0 = 0xC2; b0 <= 0xDF; b0++) {
      for (uint32_t b1 = 0x80; b1 <= 0xBF; b1++) {
        const uint32_t cp = ((b0 & 0x1Fu) << 6) | (b1 & 0x3Fu);
        t[(b0 << 8) | b1] = static_cast<uint8_t>((2u << 3) | cp_class(cp));
      }
    }
    for (uint32_t b0 = 0xE0; b0 <= 0xEF; b0++) {
      for (uint32_t b1 = 0x80; b1 <= 0xBF; b1++) {
        if (b0 == 0xE0 && b1 < 0xA0) continue;  // overlong
        const uint32_t base = ((b0 & 0x0Fu) << 12) | ((b1 & 0x3Fu) << 6);
        if (base >= 0xD800 && base < 0xE000) continue;  // surrogate block
        const uint8_t cls = cp_class(base);
        bool uniform = true;
        for (uint32_t k = 1; k < 64; k++) {
          if (cp_class(base + k) != cls) {
            uniform = false;
            break;
          }
        }
        if (uniform) t[(b0 << 8) | b1] = static_cast<uint8_t>((3u << 3) | cls);
      }
    }
    return true;
  }();
  (void)init;
  return t;
}

struct Key {
  const uint32_t* data;
  int32_t len;
  bool operator==(const Key& o) const {
    return len == o.len && std::memcmp(data, o.data, sizeof(uint32_t) * len) == 0;
  }
};

struct KeyHash {
  size_t operator()(const Key& k) const {
    uint64_t h = 1469598103934665603ull;
    for (int32_t i = 0; i < k.len; i++) {
      h ^= k.data[i];
      h *= 1099511628211ull;
    }
    return static_cast<size_t>(h);
  }
};

}  // namespace

extern "C" {

// bytes -> codepoints; returns count written to out (cap must be >= size).
int64_t wp_decode_utf8(const uint8_t* data, int64_t size, uint32_t* out) {
  int64_t n = 0;
  int64_t i = 0;
  while (i < size) {
    int64_t consumed;
    uint32_t cp = decode_one(data + i, size - i, &consumed);
    if (cp != kInvalid) out[n++] = cp;
    i += consumed;
  }
  return n;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Unit segmentation + dedupe (the word-centric fast path's host side).
//
// A "unit" is an independently tokenizable span (proof in SURVEY-cited
// semantics; see engine_word.py's module docstring):
//   - spaces are skipped and never emitted;
//   - a punctuation char is a unit by itself (probe window 1);
//   - a CJK char merges with the following run of non-spacing chars
//     (the reference's probe window at a CJK char extends into them,
//     src/fast.cpp:54-60);
//   - otherwise a maximal run of non-spacing chars is a unit.
// Units with equal bytes tokenize identically, so the corpus is deduped
// at unit granularity (Zipf => ~10x less device work).
// ---------------------------------------------------------------------------

namespace {

// Byte classifier for the ASCII fast path: 0 = plain word byte (or UTF-8
// lead/cont of a non-spacing char, resolved by the slow path), 1 = ASCII
// space, 2 = ASCII punct, 3 = multi-byte or invalid (slow path).
inline const uint8_t* byte_class_table() {
  static uint8_t t[256];
  static bool init = [] {
    for (int b = 0; b < 256; b++) {
      if (b < 0x80) {
        uint32_t c = static_cast<uint32_t>(b);
        if (is_space_cp(c))
          t[b] = 1;
        else if (is_punct_cp(c))
          t[b] = 2;
        else
          t[b] = 0;
      } else {
        t[b] = 3;
      }
    }
    return true;
  }();
  (void)init;
  return t;
}

}  // namespace

namespace {

// Open-addressing dedupe table: far faster than unordered_map (no
// allocation, 64-bit hash compare before memcmp).
// Open-addressing (hash, uid) table, AoS so a probe touches ONE cache
// line (separate hash[]/uid[] arrays cost two).  memset 0xFF marks every
// slot empty: uid == -1, hash == ~0 (a hash value never dereferenced).
struct DedupeTable {
  struct Slot {
    uint64_t hash;
    int32_t uid;
    int32_t pad_;
  };
  std::vector<Slot> t;
  size_t mask;
  explicit DedupeTable(size_t cap_pow2) : t(cap_pow2), mask(cap_pow2 - 1) {
    std::memset(t.data(), 0xFF, t.size() * sizeof(Slot));
  }
  void reset(size_t cap_pow2) {
    if (t.size() < cap_pow2) {
      t.resize(cap_pow2);
      mask = cap_pow2 - 1;
    } else {
      mask = t.size() - 1;  // keep the grown capacity
    }
    std::memset(t.data(), 0xFF, t.size() * sizeof(Slot));
  }
  void grow() {
    DedupeTable bigger(2 * (mask + 1));
    for (size_t s = 0; s <= mask; s++) {
      if (t[s].uid >= 0) {
        size_t b = static_cast<size_t>(t[s].hash) & bigger.mask;
        while (bigger.t[b].uid >= 0) b = (b + 1) & bigger.mask;
        bigger.t[b] = t[s];
      }
    }
    *this = std::move(bigger);
  }
};

inline uint64_t mix64(uint64_t x) {
  x ^= x >> 33;
  x *= 0xff51afd7ed558ccdull;
  x ^= x >> 33;
  x *= 0xc4ceb9fe1a85ec53ull;
  x ^= x >> 33;
  return x;
}

inline uint64_t load64(const uint8_t* p) {
  uint64_t w;
  std::memcpy(&w, p, 8);
  return w;
}

// Word-at-a-time equality of two len-byte regions; never reads past
// [x, x+len) (overlapped 8-byte tail for len >= 8, byte loop below).
// Beats a memcmp PLT call for the short unit lengths that dominate.
inline bool unit_eq(const uint8_t* a, const uint8_t* b, int32_t len) {
  if (len >= 8) {
    int32_t i = 0;
    for (; i + 8 <= len; i += 8) {
      if (load64(a + i) != load64(b + i)) return false;
    }
    return load64(a + len - 8) == load64(b + len - 8);
  }
  for (int32_t i = 0; i < len; i++) {
    if (a[i] != b[i]) return false;
  }
  return true;
}

// Hash the unit bytes at data[start .. start+len).  Word-at-a-time (the
// scalar FNV chain was the old hot spot); `size` bounds a full-width load
// near the buffer end.  Collisions are harmless: the dedupe table always
// memcmp-verifies before reuse.
inline uint64_t hash_unit(const uint8_t* data, int64_t start, int64_t len,
                          int64_t size) {
  const uint8_t* p = data + start;
  const uint64_t salt = static_cast<uint64_t>(len) * 0x9E3779B97F4A7C15ull;
  uint64_t h;
  if (len <= 8) {
    uint64_t w;
    if (start + 8 <= size) {
      w = load64(p);
      if (len < 8) w &= (~0ull >> ((8 - len) * 8));
    } else {
      w = 0;
      std::memcpy(&w, p, static_cast<size_t>(len));
    }
    h = mix64(w + salt);
  } else if (len <= 16) {
    h = mix64(load64(p) * 0x9DDFEA08EB382D69ull ^ (load64(p + len - 8) + salt));
  } else {
    h = salt;
    int64_t i = 0;
    for (; i + 8 <= len; i += 8) h = mix64(h ^ load64(p + i));
    if (i < len) h = mix64(h ^ load64(p + len - 8));
  }
  return h | 1;  // nonzero marker
}

// ---- byte-class bitmasks (1 bit per corpus byte) --------------------------
//
// space: ASCII space class (9..13, 32).  delim: space | ASCII punct |
// non-ASCII lead/cont byte — i.e. every byte at which a plain ASCII word
// run must stop.  nonascii: byte >= 0x80.  Bits at/after `size` are set in
// delim and clear in space/nonascii, so next_set_bit/skip loops terminate
// without per-iteration bounds checks.
struct ClassMasks {
  std::vector<uint64_t> buf;  // reused across calls (thread_local owner)
  uint64_t* delim;
  uint64_t* space;
  uint64_t* nonascii;
  int64_t nwords;
};

inline void build_class_masks(const uint8_t* data, int64_t size, ClassMasks* m) {
  const int64_t nwords = (size >> 6) + 2;
  m->nwords = nwords;
  if (m->buf.size() < static_cast<size_t>(3 * nwords))
    m->buf.resize(static_cast<size_t>(3 * nwords));
  m->delim = m->buf.data();
  m->space = m->buf.data() + nwords;
  m->nonascii = m->buf.data() + 2 * nwords;
  int64_t w = 0;
// WP_FORCE_SCALAR (make scalar): disable the vector fast path so tests can
// A/B the scalar class builder against the AVX-512 one byte-for-byte.
#if defined(__AVX512BW__) && !defined(WP_FORCE_SCALAR)
  const __m512i v9 = _mm512_set1_epi8(9), v13 = _mm512_set1_epi8(13);
  const __m512i v32 = _mm512_set1_epi8(32);
  const __m512i v33 = _mm512_set1_epi8(33), v47 = _mm512_set1_epi8(47);
  const __m512i v58 = _mm512_set1_epi8(58), v64 = _mm512_set1_epi8(64);
  const __m512i v91 = _mm512_set1_epi8(91), v96 = _mm512_set1_epi8(96);
  const __m512i v123 = _mm512_set1_epi8(123), v126 = _mm512_set1_epi8(126);
  for (; (w << 6) + 64 <= size; w++) {
    const __m512i v = _mm512_loadu_si512(data + (w << 6));
    const __mmask64 sp = _mm512_cmpeq_epu8_mask(v, v32) |
                         (_mm512_cmp_epu8_mask(v9, v, _MM_CMPINT_LE) &
                          _mm512_cmp_epu8_mask(v, v13, _MM_CMPINT_LE));
    const __mmask64 pu =
        (_mm512_cmp_epu8_mask(v33, v, _MM_CMPINT_LE) &
         _mm512_cmp_epu8_mask(v, v47, _MM_CMPINT_LE)) |
        (_mm512_cmp_epu8_mask(v58, v, _MM_CMPINT_LE) &
         _mm512_cmp_epu8_mask(v, v64, _MM_CMPINT_LE)) |
        (_mm512_cmp_epu8_mask(v91, v, _MM_CMPINT_LE) &
         _mm512_cmp_epu8_mask(v, v96, _MM_CMPINT_LE)) |
        (_mm512_cmp_epu8_mask(v123, v, _MM_CMPINT_LE) &
         _mm512_cmp_epu8_mask(v, v126, _MM_CMPINT_LE));
    const __mmask64 na = _mm512_movepi8_mask(v);
    m->space[w] = sp;
    m->nonascii[w] = na;
    m->delim[w] = sp | pu | na;
  }
#endif
  // Scalar tail (and full fallback without AVX-512).
  const uint8_t* cls = byte_class_table();
  for (; (w << 6) < size; w++) {
    uint64_t sp = 0, na = 0, de = 0;
    const int64_t base = w << 6;
    const int64_t hi = std::min<int64_t>(64, size - base);
    for (int64_t k = 0; k < hi; k++) {
      const uint8_t c = cls[data[base + k]];
      if (c == 1) sp |= 1ull << k;
      if (c == 3) na |= 1ull << k;
      if (c != 0) de |= 1ull << k;
    }
    m->space[w] = sp;
    m->nonascii[w] = na;
    m->delim[w] = de;
  }
  for (; w < nwords; w++) {
    m->space[w] = 0;
    m->nonascii[w] = 0;
    m->delim[w] = ~0ull;
  }
  // Pad the partial final word: bits >= size are delim-only.
  const int64_t bit = size & 63;
  const int64_t fw = size >> 6;
  if (fw < nwords) {
    const uint64_t in = bit ? ((1ull << bit) - 1) : 0ull;
    m->space[fw] &= in;
    m->nonascii[fw] &= in;
    m->delim[fw] |= ~in;
  }
}

inline int64_t next_set_bit(const uint64_t* m, int64_t i) {
  int64_t w = i >> 6;
  uint64_t cur = m[w] & (~0ull << (i & 63));
  while (cur == 0) cur = m[++w];
  return (w << 6) + __builtin_ctzll(cur);
}

inline int64_t next_clear_bit(const uint64_t* m, int64_t i) {
  int64_t w = i >> 6;
  uint64_t cur = ~m[w] & (~0ull << (i & 63));
  while (cur == 0) cur = ~m[++w];
  return (w << 6) + __builtin_ctzll(cur);
}

// Persistent second-half worker: a fresh std::thread per call would tear
// down and rebuild the thread_local scratch (masks + half buffers) every
// pipeline chunk.
class HalfWorker {
 public:
  HalfWorker() : th_([this] { loop(); }) {}
  ~HalfWorker() {
    {
      std::lock_guard<std::mutex> g(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    th_.join();
  }
  void run(std::function<void()> job) {
    {
      std::lock_guard<std::mutex> g(mu_);
      job_ = std::move(job);
      has_job_ = true;
      done_ = false;
    }
    cv_.notify_all();
  }
  void wait() {
    std::unique_lock<std::mutex> lk(mu_);
    cv_.wait(lk, [&] { return done_; });
  }

 private:
  void loop() {
    for (;;) {
      std::function<void()> job;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [&] { return has_job_ || stop_; });
        if (stop_) return;
        job = std::move(job_);
        has_job_ = false;
      }
      job();
      {
        std::lock_guard<std::mutex> g(mu_);
        done_ = true;
      }
      cv_.notify_all();
    }
  }
  std::mutex mu_;
  std::condition_variable cv_;
  std::function<void()> job_;
  bool has_job_ = false, done_ = false, stop_ = false;
  std::thread th_;
};

}  // namespace

namespace {

// Scan cursor: position plus a one-codepoint carry.  When a unit ends
// because the next char decodes to a spacing codepoint, that decode is
// NOT thrown away — it is carried into the next scan_unit call, which
// would otherwise re-decode the same bytes (every char of a dense CJK
// run was decoded twice before this).
struct ScanCur {
  int64_t i = 0;
  int64_t carry_len = 0;  // 0 = no carry; else bytes of the cp at `i`
  uint8_t carry_cls = 0;  // its cp_class bits (always nonzero if carried)
};

// Scan the next unit at or after cur->i.  On success advances the cursor
// past the unit and fills (start, klen, cplen); returns false at end.
inline bool scan_unit(const uint8_t* data, int64_t size, const ClassMasks& cm,
                      ScanCur* cur, int64_t* out_start, int32_t* out_klen,
                      int32_t* out_cplen) {
  int64_t i = cur->i;
  int64_t clen = cur->carry_len;
  const uint8_t ccls = cur->carry_cls;
  cur->carry_len = 0;
  int64_t start;
  int32_t cplen;

  // Shared continuation: extend a unit over ASCII word bytes (bit-skip)
  // and non-spacing multibyte chars; invalid bytes vanish; a spacing
  // char ends the unit and is carried to the next call.
  const uint8_t* const pair_cls = pair_class_table();
  const auto run_continuation = [&](int64_t j, int32_t* pcpl) {
    int32_t cpl = *pcpl;
    while (j < size) {
      const uint64_t b = 1ull << (j & 63);
      if (!(cm.delim[j >> 6] & b)) {  // ASCII word bytes: bit-skip
        const int64_t e = next_set_bit(cm.delim, j);
        cpl += static_cast<int32_t>(e - j);
        j = e;
        continue;
      }
      if (!(cm.nonascii[j >> 6] & b)) break;  // ASCII space/punct delimits
      int64_t c2;
      uint8_t cls2;
      // Pair-LUT fast path: one table load classifies the char (the
      // dominant cost of CJK-dense scans was decode_one per char).
      if (j + 1 < size) {
        const uint8_t v =
            pair_cls[(static_cast<uint32_t>(data[j]) << 8) | data[j + 1]];
        if (v >= (3u << 3)) {  // uniform 3-byte block
          if (j + 2 < size && is_cont(data[j + 2])) {
            cls2 = v & 7u;
            c2 = 3;
            goto classified;
          }
        } else if (v) {  // valid 2-byte char
          cls2 = v & 7u;
          c2 = 2;
          goto classified;
        }
      }
      {
        const uint32_t cp2 = decode_one(data + j, size - j, &c2);
        if (cp2 == kInvalid) {
          j += c2;  // invalid bytes vanish; they do not delimit units
          continue;
        }
        cls2 = cp_class(cp2);
      }
    classified:
      if (cls2) {  // spacing char ends the unit; carry its decode
        cur->carry_len = c2;
        cur->carry_cls = cls2;
        break;
      }
      j += c2;
      cpl++;
    }
    *pcpl = cpl;
    return j;
  };

  while (i < size) {
    if (clen) {
      // Carried spacing char at i (space, punct, or CJK).
      const uint8_t cls = ccls;
      const int64_t consumed = clen;
      clen = 0;
      if (cls & 1) {  // space (U+2581): skip
        i += consumed;
        continue;
      }
      start = i;
      i += consumed;
      cplen = 1;
      if (cls & 4) i = run_continuation(i, &cplen);  // CJK glues forward
      // punct: a unit by itself
    } else {
      const int64_t w0 = i >> 6;
      const uint64_t bit0 = 1ull << (i & 63);
      if (cm.space[w0] & bit0) {  // ASCII space run: bit-skip
        i = next_clear_bit(cm.space, i);
        continue;
      }
      if (!(cm.delim[w0] & bit0)) {
        // ASCII word start: the run ends at the next delim bit.
        start = i;
        i = next_set_bit(cm.delim, i);
        cplen = static_cast<int32_t>(i - start);
        if (i < size && ((cm.nonascii[i >> 6] >> (i & 63)) & 1)) {
          i = run_continuation(i, &cplen);  // mixed multi-byte run
        }
      } else if (!((cm.nonascii[w0] >> (i & 63)) & 1)) {
        // ASCII punct: a unit by itself.
        start = i;
        cplen = 1;
        i++;
      } else {
        // Multi-byte (or invalid) first char: pair-LUT, else full decode.
        int64_t consumed;
        uint8_t cls;
        if (i + 1 < size) {
          const uint8_t v =
              pair_cls[(static_cast<uint32_t>(data[i]) << 8) | data[i + 1]];
          if (v >= (3u << 3)) {
            if (i + 2 < size && is_cont(data[i + 2])) {
              cls = v & 7u;
              consumed = 3;
              goto first_classified;
            }
          } else if (v) {
            cls = v & 7u;
            consumed = 2;
            goto first_classified;
          }
        }
        {
          const uint32_t cp = decode_one(data + i, size - i, &consumed);
          if (cp == kInvalid) {
            i += consumed;
            continue;
          }
          cls = cp_class(cp);
        }
      first_classified:
        if (cls & 1) {  // space: skip
          i += consumed;
          continue;
        }
        start = i;
        i += consumed;
        cplen = 1;
        if (!(cls & 2)) {
          // CJK or plain multibyte letter: extend over the following run.
          i = run_continuation(i, &cplen);
        }
        // punct: a unit by itself
      }
    }
    cur->i = i;
    *out_start = start;
    *out_klen = static_cast<int32_t>(i - start);
    *out_cplen = cplen;
    return true;
  }
  cur->i = i;
  return false;
}

}  // namespace

// --- Persistent dedupe session (cross-chunk pipelining) -------------------
//
// The windowed encode pipeline segments the corpus in ~MB chunks so host
// phases overlap device dispatch; with per-chunk dedupe every chunk would
// re-dispatch the (Zipf-saturated) unique set.  A session keeps one global
// unit table across chunks: occurrence ids are global, and each chunk
// returns only its first-seen units (whose bytes are copied into a
// session-owned arena so lookups survive the chunk buffer's lifetime).
// Analogous role to the reference's process-lifetime hashmaps built once
// per encode call (src/fast.cpp:21-36) — here amortized across the
// streaming chunk loop instead.

// Session dedupe table with 16-byte slots (first8, uid, len) — 4 slots
// per cache line.  The per-occurrence probe is the hottest loop in the
// framework, and with the original slim (hash, uid) slot every hit
// chased 2-3 DEPENDENT cache misses (alen[uid] -> astart[uid] -> arena
// bytes).  Here (len, first8) is the in-slot quick reject, so any unit
// of <= 8 bytes resolves from the ONE prefetched cache line; only
// longer units touch the arena (tail compare past byte 8).  No hash or
// arena offset is stored: grow() rehashes each unit from its (padded)
// arena bytes instead.  Measured: 1-thread session segmentation
// 93 -> ~180 MB/s on the en bench corpus.
struct SessionTable {
  struct Slot {  // 16 bytes -> 4 slots per cache line
    uint64_t first8;  // first min(len, 8) unit bytes, zero-padded
    int32_t uid;
    int32_t len;  // unit byte length
  };
  std::vector<Slot> t;
  size_t mask;
  explicit SessionTable(size_t cap_pow2) : t(cap_pow2), mask(cap_pow2 - 1) {
    std::memset(t.data(), 0xFF, t.size() * sizeof(Slot));  // uid == -1
  }
  // No stored hash: (len, first8) is the quick reject, and a full key
  // compare needs the arena only for len > 8 tails.  Rehashing on grow
  // recomputes each unit's hash from its (padded) arena bytes.
  void grow(const uint8_t* arena, const int64_t* astart, int64_t arena_size) {
    SessionTable bigger(2 * (mask + 1));
    for (size_t s = 0; s <= mask; s++) {
      if (t[s].uid >= 0) {
        const uint64_t h =
            hash_unit(arena, astart[t[s].uid], t[s].len, arena_size);
        size_t b = static_cast<size_t>(h) & bigger.mask;
        while (bigger.t[b].uid >= 0) b = (b + 1) & bigger.mask;
        bigger.t[b] = t[s];
      }
    }
    *this = std::move(bigger);
  }
};

// First min(len, 8) bytes of data[start ..] zero-padded to a word — the
// slot-compare key.  `size` bounds the full-width load near buffer end.
inline uint64_t first8_key(const uint8_t* data, int64_t start, int32_t len,
                           int64_t size) {
  if (len >= 8) return load64(data + start);
  if (start + 8 <= size)
    return load64(data + start) & (~0ull >> ((8 - len) * 8));
  uint64_t w = 0;
  std::memcpy(&w, data + start, static_cast<size_t>(len));
  return w;
}

struct WpDedupeSession {
  SessionTable table{1 << 16};
  std::vector<uint8_t> arena;   // unique-unit bytes, append-only
  std::vector<int64_t> astart;  // per-uid arena offset
  std::vector<int32_t> alen;    // per-uid byte length
  int64_t n_uniq = 0;
  // Direct cp -> uid map for SINGLE-codepoint BMP units (every glued
  // kana/kanji, ASCII punct, 1-letter words): one indexed load replaces
  // hash + probe + compare for the unit class that dominates CJK text.
  // Singles live ONLY here (never in `table`); a unit's routing is a
  // pure function of its bytes, so the two tiers can never alias.
  std::vector<int32_t> single_uid = std::vector<int32_t>(1 << 16, -1);
};

namespace {

// Per-thread pending state of a session scan: units not (yet) in the
// session table, deduped thread-locally, plus the occ positions holding
// -(pending_idx)-1 placeholders to fix up after the serial merge.
struct PendScan {
  DedupeTable pend{1 << 12};
  std::vector<int64_t> pstart;  // absolute byte offsets into data
  std::vector<int32_t> plen, pcplen;
  std::vector<uint64_t> phash;
  std::vector<int32_t> pcp;  // BMP cp for single-cp pendings, else -1
  std::vector<int64_t> fix_pos;  // half-relative occ indices
  // Pending-tier singles map (cp -> pending idx), dirty-list reset.
  std::vector<int32_t> single_pend = std::vector<int32_t>(1 << 16, -1);
  std::vector<int32_t> single_dirty;
  int64_t n_occ = 0;
  void reset() {
    pend.reset(1 << 12);
    pstart.clear();
    plen.clear();
    pcplen.clear();
    phash.clear();
    pcp.clear();
    fix_pos.clear();
    for (const int32_t cp : single_dirty) single_pend[static_cast<size_t>(cp)] = -1;
    single_dirty.clear();
    n_occ = 0;
  }
};

// cp of a unit that is EXACTLY one valid BMP codepoint (an invalid-byte-
// containing or supplementary unit returns -1 and takes the byte-keyed
// path; byte-identical units always route the same way).
inline int32_t single_cp(const uint8_t* p, int32_t klen) {
  if (klen == 1) return p[0] < 0x80u ? static_cast<int32_t>(p[0]) : -1;
  if (klen == 2) {
    if ((p[0] & 0xE0u) == 0xC0u && is_cont(p[1])) {
      const uint32_t cp = ((p[0] & 0x1Fu) << 6) | (p[1] & 0x3Fu);
      if (cp >= 0x80u) return static_cast<int32_t>(cp);
    }
    return -1;
  }
  if ((p[0] & 0xF0u) == 0xE0u && is_cont(p[1]) && is_cont(p[2])) {
    const uint32_t cp =
        ((p[0] & 0x0Fu) << 12) | ((p[1] & 0x3Fu) << 6) | (p[2] & 0x3Fu);
    if (cp >= 0x800u && ok_cp(cp)) return static_cast<int32_t>(cp);
  }
  return -1;
}

// Scan data[off, off+len) writing SESSION uids into occ; unknown units
// become -(pending_idx)-1 placeholders collected in `ps`.  Strictly
// read-only on the session table, so two halves run concurrently.  This
// is the session fast path: for steady-state pipeline chunks (Zipf: new
// units are rare) occurrence ids are final immediately — no chunk-local
// table, no re-hash, no full-occurrence remap pass (a per-chunk scan
// followed by a merge into the session would pay all three).
void session_scan_half(const WpDedupeSession* s, const uint8_t* data,
                       int64_t total_size, int64_t off, int64_t len,
                       int32_t* occ, PendScan* ps) {
  thread_local ClassMasks cm;
  build_class_masks(data + off, len, &cm);
  ps->reset();
  const SessionTable::Slot* slots = s->table.t.data();
  const size_t smask = s->table.mask;
  const uint8_t* arena = s->arena.data();
  const int64_t* astart = s->astart.data();  // len > 8 tail compares only

  const int32_t* s_single = s->single_uid.data();

  int64_t n = 0;
  // Batched software pipeline: scan+hash a block of units, prefetching
  // each unit's session slot as its hash lands, then probe the block — a
  // whole block of scan work hides each probe's cache miss.  Single-codepoint units resolve IN the scan
  // phase through the direct cp maps (no hash, no probe); their final
  // occ value is carried in bres[] past the probe phase.
  constexpr int B = 64;
  constexpr int32_t kUnresolved = INT32_MIN;
  int64_t bs[B];
  int32_t bl[B], bcp[B], bres[B], bcp1[B];
  uint64_t bh[B];
  ScanCur cur;
  bool done = false;
  while (!done) {
    int nb = 0;
    while (nb < B) {
      int64_t start;
      int32_t klen, cplen;
      if (!scan_unit(data + off, len, cm, &cur, &start, &klen, &cplen)) {
        done = true;
        break;
      }
      start += off;
      if (cplen == 1 && klen <= 3) {
        const int32_t cp1 = single_cp(data + start, klen);
        if (cp1 >= 0) {
          const int32_t v = s_single[static_cast<size_t>(cp1)];
          bs[nb] = start;
          bl[nb] = klen;
          bcp[nb] = 1;
          // Session map hit resolves here; a miss defers its PENDING
          // creation to the probe phase so pending (and hence uid)
          // numbering stays in first-seen unit order across the batch.
          bres[nb] = v >= 0 ? v : kUnresolved;
          bcp1[nb] = cp1;
          nb++;
          continue;
        }
      }
      const uint64_t h = hash_unit(data, start, klen, total_size);
      __builtin_prefetch(&slots[static_cast<size_t>(h) & smask]);
      bs[nb] = start;
      bl[nb] = klen;
      bcp[nb] = cplen;
      bh[nb] = h;
      bres[nb] = kUnresolved;
      bcp1[nb] = -1;
      nb++;
    }
    for (int k = 0; k < nb; k++) {
      // Near-distance prefetch: the scan-phase prefetches (up to 64
      // outstanding) overrun the line-fill buffers and are partially
      // dropped; re-issuing a few slots ahead keeps the next probes'
      // lines in flight within LFB capacity.
      if (k + 6 < nb && bres[k + 6] == kUnresolved && bcp1[k + 6] < 0)
        __builtin_prefetch(&slots[static_cast<size_t>(bh[k + 6]) & smask]);
      if (bres[k] != kUnresolved) {
        occ[n++] = bres[k];
        continue;
      }
      if (bcp1[k] >= 0) {  // first-seen single: pending via the cp map
        const int32_t cp1 = bcp1[k];
        int32_t pid = ps->single_pend[static_cast<size_t>(cp1)];
        if (pid < 0) {
          pid = static_cast<int32_t>(ps->pstart.size());
          ps->pstart.push_back(bs[k]);
          ps->plen.push_back(bl[k]);
          ps->pcplen.push_back(1);
          ps->phash.push_back(0);
          ps->pcp.push_back(cp1);
          ps->single_pend[static_cast<size_t>(cp1)] = pid;
          ps->single_dirty.push_back(cp1);
        }
        occ[n] = -pid - 1;
        ps->fix_pos.push_back(n);
        n++;
        continue;
      }
      const uint64_t h = bh[k];
      const int64_t start = bs[k];
      const int32_t klen = bl[k];
      const uint64_t w8 = first8_key(data, start, klen, total_size);
      // Session probe (read-only): units of <= 8 bytes resolve entirely
      // from the slot; longer ones tail-compare against the arena
      // (whose 8-byte pad after every unit keeps unit_eq in bounds).
      size_t b = static_cast<size_t>(h) & smask;
      int32_t uid = -1;
      while (slots[b].uid >= 0) {
        if (slots[b].len == klen && slots[b].first8 == w8 &&
            (klen <= 8 ||
             unit_eq(arena + astart[static_cast<size_t>(slots[b].uid)] + 8,
                     data + start + 8, klen - 8))) {
          uid = slots[b].uid;
          break;
        }
        b = (b + 1) & smask;
      }
      if (uid >= 0) {
        occ[n] = uid;
      } else {
        // Pending-local dedupe.
        size_t pb = static_cast<size_t>(h) & ps->pend.mask;
        int32_t pid = -1;
        while (ps->pend.t[pb].uid >= 0) {
          const int32_t cand = ps->pend.t[pb].uid;
          if (ps->pend.t[pb].hash == h &&
              ps->plen[static_cast<size_t>(cand)] == klen &&
              first8_key(data, ps->pstart[static_cast<size_t>(cand)], klen,
                         total_size) == w8 &&
              (klen <= 8 ||
               unit_eq(data + ps->pstart[static_cast<size_t>(cand)] + 8,
                       data + start + 8, klen - 8))) {
            pid = cand;
            break;
          }
          pb = (pb + 1) & ps->pend.mask;
        }
        if (pid < 0) {
          pid = static_cast<int32_t>(ps->pstart.size());
          ps->pstart.push_back(start);
          ps->plen.push_back(klen);
          ps->pcplen.push_back(bcp[k]);
          ps->phash.push_back(h);
          ps->pcp.push_back(-1);
          ps->pend.t[pb].hash = h;
          ps->pend.t[pb].uid = pid;
          if (ps->pstart.size() * 2 > ps->pend.mask) ps->pend.grow();
        }
        occ[n] = -pid - 1;
        ps->fix_pos.push_back(n);
      }
      n++;
    }
  }
  ps->n_occ = n;
}

}  // namespace

extern "C" {

void* wp_dedupe_session_new() { return new WpDedupeSession(); }

void wp_dedupe_session_free(void* h) { delete static_cast<WpDedupeSession*>(h); }

// Segment one chunk; occurrence ids are global across the session.
// Outputs: occ_unique (global uids), new_{start,len,cplen} describe only
// this chunk's first-seen units as offsets into `data`, in uid order
// (uids n_before .. n_before+n_new-1).  Returns n_occ; *n_new_out and
// *n_total_out report the new and cumulative unique counts.
int64_t wp_dedupe_session_segment(void* handle, const uint8_t* data,
                                  int64_t size, int32_t* occ_unique,
                                  int64_t* new_start, int32_t* new_len,
                                  int32_t* new_cplen, int64_t* n_new_out,
                                  int64_t* n_total_out, int32_t n_threads) {
  WpDedupeSession* s = static_cast<WpDedupeSession*>(handle);
  // Parallel phase: halves probe the session table READ-ONLY and write
  // final global uids directly; only first-seen units become pendings.
  // Serial phase is then O(new units + placeholder occurrences) — for
  // steady-state pipeline chunks that is the Zipf tail, not the chunk.
  // Scratch is thread_local, NOT per-session: sessions are created per
  // encode call and fresh zero-init would page-fault every call.  Safe
  // because a session is documented single-threaded per segment call.
  static thread_local PendScan ps1, ps2;
  static thread_local std::vector<int32_t> occ2_v;

  int64_t mid = -1;
  if (n_threads >= 2 && size >= (1 << 20)) {
    // First space-class cut at-or-after the middle (any ASCII whitespace
    // byte, or U+2581's 3-byte sequence; a continuation byte can match
    // neither, so scanning from an arbitrary offset is safe).
    const auto is_space_cut = [&](int64_t i) {
      const uint8_t c = data[i];
      if (c == 0x20 || (c >= 9 && c <= 13)) return true;
      return c == 0xE2 && i + 2 < size && data[i + 1] == 0x96 &&
             data[i + 2] == 0x81;
    };
    int64_t m = size / 2;
    while (m < size && !is_space_cut(m)) m++;
    if (m < size) mid = m;
  }

  int64_t n_occ1 = 0, n_occ2 = 0;
  if (mid >= 0) {
    const size_t cap2 = static_cast<size_t>(size - mid);
    if (occ2_v.size() < cap2) occ2_v.resize(cap2);
    static thread_local HalfWorker worker;
    // Bind the thread_locals on THIS thread before handing them to the
    // worker: a lambda body names a thread_local directly (no capture),
    // which inside the worker would resolve to the worker's own empty
    // instances — null occ buffer, pendings written to the wrong state.
    PendScan* const ps2p = &ps2;
    int32_t* const occ2p = occ2_v.data();
    worker.run([=] {
      session_scan_half(s, data, size, mid, size - mid, occ2p, ps2p);
    });
    session_scan_half(s, data, size, 0, mid, occ_unique, &ps1);
    worker.wait();
    n_occ1 = ps1.n_occ;
    n_occ2 = ps2.n_occ;
    std::memcpy(occ_unique + n_occ1, occ2_v.data(),
                static_cast<size_t>(n_occ2) * sizeof(int32_t));
  } else {
    session_scan_half(s, data, size, 0, size, occ_unique, &ps1);
    n_occ1 = ps1.n_occ;
    ps2.reset();
  }

  // Serial merge: insert pendings into the session (in uid order:
  // half 1's first), then patch only the placeholder occurrences.
  int64_t n_new = 0;
  static thread_local std::vector<int32_t> remap1, remap2;
  const auto merge_pend = [&](PendScan& ps, std::vector<int32_t>& remap) {
    const size_t np = ps.pstart.size();
    if (remap.size() < np) remap.resize(np);
    for (size_t p = 0; p < np; p++) {
      const int64_t start = ps.pstart[p];
      const int32_t len = ps.plen[p];
      int32_t found = -1;
      const int32_t cp1 = ps.pcp[p];
      size_t b = 0;
      uint64_t w8 = 0;
      if (cp1 >= 0) {
        // Single-cp pending: dedupe (across halves) via the direct map.
        found = s->single_uid[static_cast<size_t>(cp1)];
      } else {
        const uint64_t h = ps.phash[p];
        w8 = first8_key(data, start, len, size);
        b = static_cast<size_t>(h) & s->table.mask;
        while (s->table.t[b].uid >= 0) {
          const int32_t cand = s->table.t[b].uid;
          if (s->table.t[b].len == len && s->table.t[b].first8 == w8 &&
              (len <= 8 ||
               unit_eq(s->arena.data() +
                           s->astart[static_cast<size_t>(cand)] + 8,
                       data + start + 8, len - 8))) {
            found = cand;
            break;
          }
          b = (b + 1) & s->table.mask;
        }
      }
      if (found < 0) {
        found = static_cast<int32_t>(s->n_uniq++);
        const int64_t aoff = static_cast<int64_t>(s->arena.size());
        s->astart.push_back(aoff);
        s->alen.push_back(len);
        s->arena.insert(s->arena.end(), data + start, data + start + len);
        // 8-byte pad after every unit: probes may use word compares on
        // the arena side without a bounds check.
        s->arena.insert(s->arena.end(), 8, 0);
        if (cp1 >= 0) {
          s->single_uid[static_cast<size_t>(cp1)] = found;
        } else {
          s->table.t[b].uid = found;
          s->table.t[b].len = len;
          s->table.t[b].first8 = w8;
          if (static_cast<size_t>(s->n_uniq) * 2 > s->table.mask)
            s->table.grow(s->arena.data(), s->astart.data(),
                          static_cast<int64_t>(s->arena.size()));
        }
        new_start[n_new] = start;
        new_len[n_new] = len;
        new_cplen[n_new] = ps.pcplen[p];
        n_new++;
      }
      remap[p] = found;
    }
  };
  merge_pend(ps1, remap1);
  merge_pend(ps2, remap2);
  for (const int64_t pos : ps1.fix_pos) {
    occ_unique[pos] = remap1[static_cast<size_t>(-occ_unique[pos] - 1)];
  }
  for (const int64_t pos : ps2.fix_pos) {
    occ_unique[n_occ1 + pos] =
        remap2[static_cast<size_t>(-occ_unique[n_occ1 + pos] - 1)];
  }
  *n_new_out = n_new;
  *n_total_out = s->n_uniq;
  return n_occ1 + n_occ2;
}

// Fill width-bucketed codepoint matrices with the unique units.
// widths[n_buckets] ascending; a unit goes to the smallest width >= cplen,
// or to the overflow list if cplen > widths[n_buckets-1].
// matrices[b] is an int32 (counts[b], widths[b]) row-major buffer,
// pre-filled by the caller with the pad value (32 = space).
// Outputs per unique: bucket_of (n_buckets = overflow), row_of.
void wp_bucket_fill(const uint8_t* data, const int64_t* uniq_start,
                    const int32_t* uniq_len, const int32_t* uniq_cplen,
                    int64_t n_uniq, const int32_t* widths, int32_t n_buckets,
                    int32_t** matrices, int32_t* bucket_of, int32_t* row_of) {
  std::vector<int64_t> next_row(static_cast<size_t>(n_buckets), 0);
  int64_t overflow_row = 0;
  for (int64_t u = 0; u < n_uniq; u++) {
    int32_t cplen = uniq_cplen[u];
    int32_t b = -1;
    for (int32_t j = 0; j < n_buckets; j++) {
      if (cplen <= widths[j]) {
        b = j;
        break;
      }
    }
    if (b < 0) {
      bucket_of[u] = n_buckets;
      row_of[u] = static_cast<int32_t>(overflow_row++);
      continue;
    }
    bucket_of[u] = b;
    int64_t row = next_row[static_cast<size_t>(b)]++;
    row_of[u] = static_cast<int32_t>(row);
    int32_t* dst = matrices[b] + row * widths[b];
    const uint8_t* p = data + uniq_start[u];
    int64_t remaining = uniq_len[u];
    int32_t k = 0;
    while (remaining > 0 && k < widths[b]) {
      int64_t consumed;
      uint32_t cp = decode_one(p, remaining, &consumed);
      if (cp != kInvalid) dst[k++] = static_cast<int32_t>(cp);
      p += consumed;
      remaining -= consumed;
    }
  }
}

// Decode units [u_begin, u_end) of `data` into `out` as int32 codepoints
// with a single space (32) between consecutive units — the linear
// engine's joined-batch layout (engine_linear.py) built in one native
// pass instead of a Python per-unit join + a separate utf8 decode.
// Caller sizes `out` as sum(uniq_cplen[u_begin:u_end]) + (u_end -
// u_begin - 1).  Returns the count written.
int64_t wp_join_units_cps(const uint8_t* data, const int64_t* uniq_start,
                          const int32_t* uniq_len, int64_t u_begin,
                          int64_t u_end, int32_t* out) {
  int64_t n = 0;
  for (int64_t u = u_begin; u < u_end; u++) {
    if (u > u_begin) out[n++] = 32;
    const uint8_t* p = data + uniq_start[u];
    int64_t remaining = uniq_len[u];
    while (remaining > 0) {
      int64_t consumed;
      uint32_t cp = decode_one(p, remaining, &consumed);
      if (cp != kInvalid) out[n++] = static_cast<int32_t>(cp);
      p += consumed;
      remaining -= consumed;
    }
  }
  return n;
}

// Total id count of the per-occurrence expansion (so the caller can
// allocate the exact output buffer without a numpy gather).
int64_t wp_expand_total(const int32_t* occ_unique, int64_t n_occ,
                        const int64_t* tok_offsets) {
  int64_t n = 0;
  for (int64_t i = 0; i < n_occ; i++) {
    const int32_t u = occ_unique[i];
    n += tok_offsets[u + 1] - tok_offsets[u];
  }
  return n;
}

// Expand per-unique token lists to the per-occurrence id stream.
// tok_offsets[u]..tok_offsets[u+1] delimit unique u's ids in tok_flat.
// Zipf: most units emit 1-2 ids, so copy two ids unconditionally (the
// buffer has >= 2 ids of slack per occurrence) and loop only for long
// tails.  The caller must size `out` with 2 spare entries.
int64_t wp_expand(const int32_t* occ_unique, int64_t n_occ,
                  const int32_t* tok_flat, const int64_t* tok_offsets,
                  int32_t* out) {
  int64_t n = 0;
  for (int64_t i = 0; i < n_occ; i++) {
    const int32_t u = occ_unique[i];
    const int64_t b = tok_offsets[u];
    const int64_t c = tok_offsets[u + 1] - b;
    std::memcpy(out + n, tok_flat + b, 8);  // ids 0..1 (over-copy is safe)
    if (c > 2) {
      for (int64_t j = 2; j < c; j++) out[n + j] = tok_flat[b + j];
    }
    n += c;
  }
  return n;
}

// Two-thread expand.  Half 1 must not over-copy into half 2's first
// slots (half 2 writes them concurrently), so its final occurrence is
// copied exactly; half 2 keeps the over-copy (the caller's +2 spare
// output slots absorb it, as in wp_expand).
int64_t wp_expand_mt(const int32_t* occ_unique, int64_t n_occ,
                     const int32_t* tok_flat, const int64_t* tok_offsets,
                     int32_t* out, int32_t n_threads) {
  if (n_threads < 2 || n_occ < (1 << 18)) {
    return wp_expand(occ_unique, n_occ, tok_flat, tok_offsets, out);
  }
  const int64_t mid = n_occ / 2;
  const int64_t total1 = wp_expand_total(occ_unique, mid, tok_offsets);
  static thread_local HalfWorker worker;
  int64_t n2 = 0;
  worker.run([&] {
    n2 = wp_expand(occ_unique + mid, n_occ - mid, tok_flat, tok_offsets,
                   out + total1);
  });
  int64_t n1 = 0;
  if (mid > 0) {
    for (int64_t i = 0; i < mid - 1; i++) {
      const int32_t u = occ_unique[i];
      const int64_t b = tok_offsets[u];
      const int64_t c = tok_offsets[u + 1] - b;
      std::memcpy(out + n1, tok_flat + b, 8);
      if (c > 2) {
        for (int64_t j = 2; j < c; j++) out[n1 + j] = tok_flat[b + j];
      }
      n1 += c;
    }
    const int32_t u = occ_unique[mid - 1];
    const int64_t b = tok_offsets[u];
    const int64_t c = tok_offsets[u + 1] - b;
    for (int64_t j = 0; j < c; j++) out[n1 + j] = tok_flat[b + j];
    n1 += c;
  }
  worker.wait();
  return n1 + n2;
}

// Verify emitted tokens against the vocabulary strings (hash-collision
// guard).  mat: int32 (U, W) unit codepoints (pad 32); emit: int32 (U, W)
// token ids (-2 = no emission).  vocab_cp/vocab_off give token codepoints.
// Writes rows with any mismatching emission to bad_rows; returns count.
int64_t wp_verify_emit(const int32_t* mat, const int32_t* emit, int64_t n_rows,
                       int64_t width, const uint32_t* vocab_cp,
                       const int64_t* vocab_off, int64_t vocab_size,
                       int32_t unk_id, int32_t* bad_rows) {
  int64_t n_bad = 0;
  for (int64_t r = 0; r < n_rows; r++) {
    const int32_t* mrow = mat + r * width;
    const int32_t* erow = emit + r * width;
    bool bad = false;
    for (int64_t j = 0; j < width && !bad; j++) {
      const int32_t tid = erow[j];
      if (tid == -2 || tid == unk_id) continue;
      if (tid < 0 || tid >= vocab_size) {
        bad = true;
        break;
      }
      const int64_t b = vocab_off[tid];
      const int64_t len = vocab_off[tid + 1] - b;
      if (j + len > width) {
        bad = true;
        break;
      }
      for (int64_t k = 0; k < len; k++) {
        if (static_cast<uint32_t>(mrow[j + k]) != vocab_cp[b + k]) {
          bad = true;
          break;
        }
      }
    }
    if (bad) bad_rows[n_bad++] = static_cast<int32_t>(r);
  }
  return n_bad;
}

// --- Reusable scalar-encoder handle (vocab maps built once) --------------
// Vocab passed as packed arrays: words = concatenated codepoints, offsets
// int64[v+1], flags a per-token bitmask 1=is_prefix 2=skip
// (special|malformed).

struct WpVocabHandle {
  std::vector<uint32_t> words;
  std::vector<int64_t> offsets;
  std::unordered_map<Key, int32_t, KeyHash> prefix_map, suffix_map;
  int64_t max_len = 0;
  int32_t unk_id = -1;
};

void* wp_vocab_new(const uint32_t* words, const int64_t* offsets,
                   const uint8_t* flags, int64_t vocab_size, int32_t unk_id) {
  auto* h = new WpVocabHandle();
  h->words.assign(words, words + offsets[vocab_size]);
  h->offsets.assign(offsets, offsets + vocab_size + 1);
  h->unk_id = unk_id;
  for (int64_t i = 0; i < vocab_size; i++) {
    if (flags[i] & 2) continue;
    Key k{h->words.data() + h->offsets[i],
          static_cast<int32_t>(h->offsets[i + 1] - h->offsets[i])};
    if (k.len > h->max_len) h->max_len = k.len;
    if (flags[i] & 1)
      h->prefix_map[k] = static_cast<int32_t>(i);
    else
      h->suffix_map[k] = static_cast<int32_t>(i);
  }
  return h;
}

void wp_vocab_free(void* handle) { delete static_cast<WpVocabHandle*>(handle); }

// Scalar greedy MaxMatch (reference worker semantics, src/fast.cpp:43-99)
// over the handle's maps; returns the number of ids written to out
// (capacity >= n + 1).
int64_t wp_encode_with(void* handle, const uint32_t* text, int64_t n,
                       int32_t* out) {
  auto* h = static_cast<WpVocabHandle*>(handle);
  int64_t max_len = std::min<int64_t>(h->max_len, n);

  auto is_word_prefix = [&](int64_t i) {
    return i == 0 || is_spacing_cp(text[i]) || is_spacing_cp(text[i - 1]);
  };

  int64_t count = 0;
  int64_t begin = 0;
  const int64_t end = n;
  while (begin != end && is_space_cp(text[begin])) begin++;

  int64_t tokens_since_prefix = 0;
  while (begin != end) {
    int64_t word_len = 1;
    if (!is_punct_cp(text[begin])) {
      int64_t cap = std::min(max_len, end - begin);
      while (word_len < cap && !is_spacing_cp(text[begin + word_len])) word_len++;
    }
    auto& map = is_word_prefix(begin) ? h->prefix_map : h->suffix_map;
    int64_t matched = 0;
    for (int64_t len = word_len; len >= 1; len--) {
      Key k{text + begin, static_cast<int32_t>(len)};
      auto it = map.find(k);
      if (it != map.end()) {
        tokens_since_prefix++;
        out[count++] = it->second;
        begin += len;
        matched = len;
        break;
      }
    }
    if (matched == 0) {
      count -= tokens_since_prefix;
      tokens_since_prefix = 0;
      out[count++] = h->unk_id;
      begin += word_len;
      while (begin != end && !is_word_prefix(begin)) begin++;
    } else if (begin != end && is_word_prefix(begin)) {
      tokens_since_prefix = 0;
    }
    while (begin != end && is_space_cp(text[begin])) begin++;
  }
  return count;
}

// Batched unit encoder: UTF-8-decode and MaxMatch-encode n_units byte
// spans of `data` in one call (the pipeline's host path for small
// first-seen batches, where a device round trip costs more than the
// units).  out_flat needs capacity >= sum of unit codepoint lengths.
int64_t wp_encode_units_with(void* handle, const uint8_t* data,
                             const int64_t* starts, const int32_t* lens,
                             int64_t n_units, int32_t* out_flat,
                             int32_t* out_counts) {
  thread_local std::vector<uint32_t> cps;
  int64_t n = 0;
  for (int64_t u = 0; u < n_units; u++) {
    const uint8_t* p = data + starts[u];
    int64_t remaining = lens[u];
    cps.clear();
    while (remaining > 0) {
      int64_t consumed;
      const uint32_t cp = decode_one(p, remaining, &consumed);
      if (cp != kInvalid) cps.push_back(cp);
      p += consumed;
      remaining -= consumed;
    }
    const int64_t c = wp_encode_with(
        handle, cps.data(), static_cast<int64_t>(cps.size()), out_flat + n);
    out_counts[u] = static_cast<int32_t>(c);
    n += c;
  }
  return n;
}

}  // extern "C"
