// The CABAC arithmetic decoding engine of the port's H.264 decoder
// (csrc/h264_video.cpp): ITU-T H.264 9.3.1.2 (initialisation) and 9.3.3.2
// (DecodeDecision, DecodeBypass, DecodeTerminate), over the bytes of a
// slice's RBSP from its byte-aligned slice data. Past the RBSP's end it
// reads zero bits and counts them in `overread`: the caller fails a slice
// that reads far past its end (every macroblock reads a bounded number of
// bins, so a check after each one bounds a truncated stream's work).
#pragma once

#include <cstddef>
#include <cstdint>

#include "h264_tables.h"

namespace h264 {

struct Cabac {
  const uint8_t* data = nullptr;
  size_t bits = 0;      // bits of the RBSP
  size_t pos = 0;       // next bit
  size_t overread = 0;  // bits read past the end
  uint32_t range = 510, offset = 0;
  uint8_t state[kCabacContexts];  // pStateIdx << 1 | valMPS

  int bit() {
    size_t p = pos++;
    if (p < bits) return (data[p >> 3] >> (7 - (p & 7))) & 1;
    overread++;
    return 0;
  }

  // The contexts of a slice of SliceQPY `qp`: `table` 0 for I slices, else
  // 1 + cabac_init_idc (9.3.1.1).
  void init_contexts(int table, int qp) {
    int q = qp < 0 ? 0 : qp > 51 ? 51 : qp;
    for (int i = 0; i < kCabacContexts; i++) {
      int m = kCabacInit[table][i][0], n = kCabacInit[table][i][1];
      int pre = ((m * q) >> 4) + n;
      pre = pre < 1 ? 1 : pre > 126 ? 126 : pre;
      state[i] = pre <= 63 ? (uint8_t)((63 - pre) << 1) : (uint8_t)(((pre - 64) << 1) | 1);
    }
  }

  // The engine from the bit at `start` (byte-aligned); false when
  // codIOffset reads 510 or 511, which a stream may not hold.
  bool init_engine(const uint8_t* d, size_t nbits, size_t start) {
    data = d;
    bits = nbits;
    pos = start;
    overread = 0;
    range = 510;
    offset = 0;
    for (int i = 0; i < 9; i++) offset = (offset << 1) | (uint32_t)bit();
    return offset < 510;
  }

  int decision(int ctx) {
    uint8_t& s = state[ctx];
    int p = s >> 1, mps = s & 1;
    uint32_t lps = kRangeLps[p][(range >> 6) & 3];
    range -= lps;
    int bin;
    if (offset >= range) {
      bin = !mps;
      offset -= range;
      range = lps;
      if (p == 0) mps = 1 - mps;
      p = kTransLps[p];
    } else {
      bin = mps;
      if (p < 62) p++;
    }
    s = (uint8_t)(p << 1 | mps);
    while (range < 256) {
      range <<= 1;
      offset = (offset << 1) | (uint32_t)bit();
    }
    return bin;
  }

  int bypass() {
    offset = (offset << 1) | (uint32_t)bit();
    if (offset >= range) {
      offset -= range;
      return 1;
    }
    return 0;
  }

  int terminate() {
    range -= 2;
    if (offset >= range) return 1;
    while (range < 256) {
      range <<= 1;
      offset = (offset << 1) | (uint32_t)bit();
    }
    return 0;
  }
};

}  // namespace h264
