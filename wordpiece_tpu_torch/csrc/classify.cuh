// Character classes of the reference (utf8.cpp:10-29), on the card.
//
// The same definitions as the plain PyTorch classifiers in
// ops/text_features.py (is_space, is_punct, is_chinese).  The Chinese
// ranges are core/unicode._CHINESE_RANGES, in its order; the CPU tests
// parse them from is_chinese below and hold them to that tuple.
// csrc/word_kernel.cu keeps its own copy of these three functions.

#pragma once

#include <cstdint>

namespace wp {

constexpr uint32_t kSpaceToken = 9601u;  // U+2581, a space to the reference

__device__ __forceinline__ bool is_space(uint32_t c) {
  return c == 32u || (c >= 9u && c <= 13u) || c == kSpaceToken;
}

__device__ __forceinline__ bool is_punct(uint32_t c) {
  return (c >= 33u && c <= 47u) || (c >= 58u && c <= 64u) || (c >= 91u && c <= 96u) ||
         (c >= 123u && c <= 126u) || c == 183u || c == 171u || c == 187u || c == 8249u ||
         c == 8250u || (c >= 8208u && c <= 8248u);
}

// One comparison pair a range of core/unicode._CHINESE_RANGES, in its order.
__device__ __forceinline__ bool is_chinese(uint32_t c) {
  return (c >= 0x4E00u && c <= 0x9FFFu) || (c >= 0x3400u && c <= 0x4DBFu) ||
         (c >= 0x20000u && c <= 0x2A6DFu) || (c >= 0x2A700u && c <= 0x2B73Fu) ||
         (c >= 0x2B740u && c <= 0x2B81Fu) || (c >= 0x2B820u && c <= 0x2CEAFu) ||
         (c >= 0xF900u && c <= 0xFAFFu) || (c >= 0x2F800u && c <= 0x2FA1Fu);
}

}  // namespace wp
