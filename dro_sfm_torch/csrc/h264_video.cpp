// Host H.264 (ITU-T H.264 | ISO/IEC 14496-10) video decoder of the port, in
// plain C++ with a C interface (loaded with ctypes, which releases the
// interpreter lock around each call). It decodes the Constrained Baseline
// streams that phones, webcams and libx264 write, as FFmpeg's h264 decoder
// decodes them (the standard's decoding is exact, so its output is too):
//   * NAL units length-prefixed (an MP4's avcC: 1, 2 or 4 bytes) or in
//     Annex B, emulation-prevention bytes removed; SPS (POC types 0 and 2,
//     frame cropping, the VUI), PPS, SEI user data (the encoder's name);
//   * CAVLC I and P slices, several a picture; I_NxN with the nine 4x4
//     modes, I_16x16 with its four modes and the luma DC Hadamard, the four
//     chroma modes with the 2x2 chroma DC; P 16x16, 16x8, 8x16, 8x8 with
//     sub-partitions 8x8, 8x4, 4x8, 4x4, P_8x8ref0, P_Skip, intra
//     macroblocks in P slices, constrained intra prediction;
//   * median and directional motion-vector prediction, several reference
//     frames under the sliding window, the initial P list in descending
//     PicNum; quarter-sample luma (the 6-tap filter) and eighth-sample
//     chroma prediction from a reference read clamped to its edges;
//   * the 4x4 inverse transform with flat scaling, mb_qp_delta, the chroma
//     QP table; the in-loop deblocking filter (bS 0-4, the slice's alpha and
//     beta offsets, disable_deblocking_filter_idc 0 and 1), run on the whole
//     picture once its macroblocks are reconstructed;
//   * output in decode order, cropped by the SPS; RGB as OpenCV converts it:
//     swscale's yuv420p to bgr24 (yuv_rgb.h) with the table of the VUI's
//     matrix (BT.601, BT.709, FCC, SMPTE 240M, BT.2020), limited range.
// Refused with a message (-2) that names the tool: CABAC, B slices, SP/SI
// slices, the 8x8 transform, scaling matrices, weighted prediction, field
// and MBAFF coding, slice groups (FMO), arbitrary slice order, redundant
// pictures, data partitioning, chroma other than 4:2:0, bit depth above 8,
// lossless, I_PCM, POC type 1, memory management operations and long-term
// references, reference list modification, gaps in frame_num,
// disable_deblocking_filter_idc 2, cropping from the left, a VUI matrix
// OpenCV does not convert by (RGB, YCgCo, reserved), a POC order that
// is not the decode order, a size change within the stream, a stream that
// does not start with an IDR picture, several pictures in one packet. A
// truncated or corrupt stream fails (-1): every bit read and every table
// index is bounds-checked, and a picture whose slices do not cover it is
// not output.
//
// Every entry point returns 0 on success (h264_decode: 0 a frame, 1 none:
// parameter sets or SEI only), else -1 (a broken stream) or -2 (a valid one
// that is not supported) with a message in err. The decoder keeps its
// reference frames between calls.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <string>
#include <vector>

#include "yuv_rgb.h"

namespace {

struct CodecError {
  std::string msg;
  bool unsupported;
};

[[noreturn]] void fail(const std::string& msg) { throw CodecError{msg, false}; }
[[noreturn]] void unsupported(const std::string& msg) {
  throw CodecError{msg + " is not supported by the port's H.264 decoder (ROADMAP A22)", true};
}

inline int clip3(int lo, int hi, int v) { return v < lo ? lo : v > hi ? hi : v; }
inline uint8_t clip1(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

// ---------------------------------------------------------------- bit reader

// An RBSP (emulation prevention removed), read up to `bits`.
struct Bits {
  const uint8_t* data;
  size_t size;     // bytes
  size_t bits;     // bits that may be read
  size_t pos = 0;  // next bit

  Bits(const uint8_t* d, size_t n) : data(d), size(n), bits(n * 8) {}

  uint64_t peek64() const {
    size_t byte = pos >> 3;
    uint64_t v = 0;
    for (int i = 0; i < 8; i++) v = (v << 8) | (byte + i < size ? data[byte + i] : 0);
    return v << (pos & 7);
  }
  // The next k (<= 32) bits, zeros past the end.
  uint32_t peek(int k) const { return k ? (uint32_t)(peek64() >> (64 - k)) : 0; }
  void skip(int k) {
    if (pos + k > bits) fail("truncated H.264 slice or parameter set");
    pos += k;
  }
  uint32_t get(int k) {
    uint32_t v = peek(k);
    skip(k);
    return v;
  }
  int get1() { return (int)get(1); }
  uint32_t ue() {
    uint64_t v = peek64();
    int zeros = v ? __builtin_clzll(v) : 64;
    if (zeros > 31) fail("an Exp-Golomb code longer than 63 bits");
    skip(zeros);
    return get(zeros + 1) - 1;
  }
  int se() {
    uint32_t k = ue();
    return (k & 1) ? (int)((k >> 1) + 1) : -(int)(k >> 1);
  }
  // ue(v) no larger than `max`, else a broken stream naming `what`
  int ue_max(uint32_t max, const char* what) {
    uint32_t v = ue();
    if (v > max) fail(std::string(what) + " " + std::to_string(v) + " out of range");
    return (int)v;
  }
  int se_range(int lo, int hi, const char* what) {
    int v = se();
    if (v < lo || v > hi) fail(std::string(what) + " " + std::to_string(v) + " out of range");
    return v;
  }
  // Whether data comes before the RBSP's stop bit (`bits` ends at it).
  bool more_data() const { return pos < bits; }
};

// The RBSP of a NAL unit's payload: emulation-prevention bytes (00 00 03)
// removed.
std::vector<uint8_t> unescape(const uint8_t* p, size_t n) {
  std::vector<uint8_t> out;
  out.reserve(n);
  int zeros = 0;
  for (size_t i = 0; i < n; i++) {
    if (zeros >= 2 && p[i] == 3) {
      zeros = 0;
      continue;
    }
    out.push_back(p[i]);
    zeros = p[i] == 0 ? zeros + 1 : 0;
  }
  return out;
}

// A reader of an RBSP that stops at its rbsp_stop_one_bit.
Bits rbsp_reader(const std::vector<uint8_t>& r) {
  Bits b(r.data(), r.size());
  size_t last = r.size();
  while (last > 0 && r[last - 1] == 0) last--;
  if (last == 0) fail("a NAL unit without its stop bit");
  b.bits = (last - 1) * 8 + (7 - __builtin_ctz(r[last - 1]));
  return b;
}

// ------------------------------------------------------------------- VLCs

// A code table of symbols (length, code), decoded by one lookup of the
// longest code's width; a collision of two codes is a bug in the tables.
struct Vlc {
  int width = 0;
  std::vector<int16_t> sym;
  std::vector<uint8_t> len;

  void add_all(const uint8_t* lens, const uint8_t* codes, const int16_t* syms, int n) {
    width = 0;
    for (int i = 0; i < n; i++) width = std::max(width, (int)lens[i]);
    sym.assign((size_t)1 << width, -1);
    len.assign((size_t)1 << width, 0);
    for (int i = 0; i < n; i++) {
      int l = lens[i];
      if (l == 0) continue;
      uint32_t first = (uint32_t)codes[i] << (width - l);
      for (uint32_t j = 0; j < (1u << (width - l)); j++) {
        if (sym[first + j] >= 0) fail("internal error: colliding VLC codes");
        sym[first + j] = syms[i];
        len[first + j] = (uint8_t)l;
      }
    }
  }
  int read(Bits& b, const char* what) const {
    uint32_t v = b.peek(width);
    if (sym[v] < 0) fail(std::string("invalid ") + what + " code");
    b.skip(len[v]);
    return sym[v];
  }
};

// coeff_token (Table 9-5) by nC class, index 4 * TotalCoeff + TrailingOnes.
const uint8_t kTokenLen[4][4 * 17] = {
    {1,  0,  0,  0,  6,  2,  0,  0,  8,  6,  3,  0,  9,  8,  7,  5,  10, 9,  8,  6,  11, 10, 9,
     7,  13, 11, 10, 8,  13, 13, 11, 9,  13, 13, 13, 10, 14, 14, 13, 11, 14, 14, 14, 13, 15, 15,
     14, 14, 15, 15, 15, 14, 16, 15, 15, 15, 16, 16, 16, 15, 16, 16, 16, 16, 16, 16, 16, 16},
    {2,  0,  0,  0,  6,  2,  0,  0,  6,  5,  3,  0,  7,  6,  6,  4,  8,  6,  6,  4,  8,  7,  7,
     5,  9,  8,  8,  6,  11, 9,  9,  6,  11, 11, 11, 7,  12, 11, 11, 9,  12, 12, 12, 11, 12, 12,
     12, 11, 13, 13, 13, 12, 13, 13, 13, 13, 13, 14, 13, 13, 14, 14, 14, 13, 14, 14, 14, 14},
    {4,  0,  0,  0, 6, 4, 0, 0, 6, 5, 4, 0, 6, 5, 5, 4, 7, 5, 5, 4, 7, 5, 5, 4, 7, 6, 6, 4,
     7,  6,  6,  4, 8, 7, 7, 5, 8, 8, 7, 6, 9, 8, 8, 7, 9, 9, 8, 8, 9, 9, 9, 8, 10, 9, 9,
     9,  10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10},
    {6, 0, 0, 0, 6, 6, 0, 0, 6, 6, 6, 0, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6,
     6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6,
     6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6}};
const uint8_t kTokenCode[4][4 * 17] = {
    {1,  0,  0, 0, 5,  1,  0,  0,  7,  4,  1,  0,  7,  6,  5,  3,  7,  6,  5, 3, 7, 6, 5,
     4,  15, 6, 5, 4,  11, 14, 5,  4,  8,  10, 13, 4,  15, 14, 9,  4,  11, 10, 13, 12, 15, 14,
     9,  12, 11, 10, 13, 8,  15, 1,  9,  12, 11, 14, 13, 8,  7,  10, 9,  12, 4,  6,  5,  8},
    {3,  0,  0,  0,  11, 2,  0,  0,  7,  7,  3,  0,  7,  10, 9,  5,  7,  6,  5,  4,  4,  6,  5,
     6,  7,  6,  5,  8,  15, 6,  5,  4,  11, 14, 13, 4,  15, 10, 9,  4,  11, 14, 13, 12, 8,  10,
     9,  8,  15, 14, 13, 12, 11, 10, 9,  12, 7,  11, 6,  8,  9,  8,  10, 1,  7,  6,  5,  4},
    {15, 0,  0,  0,  15, 14, 0,  0,  11, 15, 13, 0,  8,  12, 14, 12, 15, 10, 11, 11, 11, 8,  9,
     10, 9,  14, 13, 9,  8,  10, 9,  8,  15, 14, 13, 13, 11, 14, 10, 12, 15, 10, 13, 12, 11, 14,
     9,  12, 8,  10, 13, 8,  13, 7,  9,  12, 9,  12, 11, 10, 5,  8,  7,  6,  1,  4,  3,  2},
    {3,  0,  0,  0,  0,  1,  0,  0,  4,  5,  6,  0,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18,
     19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41,
     42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63}};
// coeff_token of the chroma DC (nC = -1), index 4 * TotalCoeff + TrailingOnes
const uint8_t kChromaDcTokenLen[4 * 5] = {2, 0, 0, 0, 6, 1, 0, 0, 6, 6, 3, 0, 6, 7, 7, 6, 6, 8, 8, 7};
const uint8_t kChromaDcTokenCode[4 * 5] = {1, 0, 0, 0, 7, 1, 0, 0, 4, 6, 1, 0, 3, 3, 2, 5, 2, 3, 2, 0};
// total_zeros of 4x4 blocks (Tables 9-7, 9-8) by TotalCoeff 1-15
const uint8_t kZerosLen[15][16] = {
    {1, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 9}, {3, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 6, 6, 6, 6},
    {4, 3, 3, 3, 4, 4, 3, 3, 4, 5, 5, 6, 5, 6},       {5, 3, 4, 4, 3, 3, 3, 4, 3, 4, 5, 5, 5},
    {4, 4, 4, 3, 3, 3, 3, 3, 4, 5, 4, 5},             {6, 5, 3, 3, 3, 3, 3, 3, 4, 3, 6},
    {6, 5, 3, 3, 3, 2, 3, 4, 3, 6},                   {6, 4, 5, 3, 2, 2, 3, 3, 6},
    {6, 6, 4, 2, 2, 3, 2, 5},                         {5, 5, 3, 2, 2, 2, 4},
    {4, 4, 3, 3, 1, 3},                               {4, 4, 2, 1, 3},
    {3, 3, 1, 2},                                     {2, 2, 1},
    {1, 1}};
const uint8_t kZerosCode[15][16] = {
    {1, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 1}, {7, 6, 5, 4, 3, 5, 4, 3, 2, 3, 2, 3, 2, 1, 0},
    {5, 7, 6, 5, 4, 3, 4, 3, 2, 3, 2, 1, 1, 0},       {3, 7, 5, 4, 6, 5, 4, 3, 3, 2, 2, 1, 0},
    {5, 4, 3, 7, 6, 5, 4, 3, 2, 1, 1, 0},             {1, 1, 7, 6, 5, 4, 3, 2, 1, 1, 0},
    {1, 1, 5, 4, 3, 3, 2, 1, 1, 0},                   {1, 1, 1, 3, 3, 2, 2, 1, 0},
    {1, 0, 1, 3, 2, 1, 1, 1},                         {1, 0, 1, 3, 2, 1, 1},
    {0, 1, 1, 2, 1, 3},                               {0, 1, 1, 1, 1},
    {0, 1, 1, 1},                                     {0, 1, 1},
    {0, 1}};
// total_zeros of the 2x2 chroma DC (Table 9-9a) by TotalCoeff 1-3
const uint8_t kChromaDcZerosLen[3][4] = {{1, 2, 3, 3}, {1, 2, 2}, {1, 1}};
const uint8_t kChromaDcZerosCode[3][4] = {{1, 1, 1, 0}, {1, 1, 0}, {1, 0}};
// run_before (Table 9-10) by zerosLeft 1-6 and above 6
const uint8_t kRunLen[7][16] = {{1, 1},          {1, 2, 2},          {2, 2, 2, 2},
                                {2, 2, 2, 3, 3}, {2, 2, 3, 3, 3, 3}, {2, 3, 3, 3, 3, 3, 3},
                                {3, 3, 3, 3, 3, 3, 3, 4, 5, 6, 7, 8, 9, 10, 11}};
const uint8_t kRunCode[7][16] = {{1, 0},          {1, 1, 0},          {3, 2, 1, 0},
                                 {3, 2, 1, 1, 0}, {3, 2, 3, 2, 1, 0}, {3, 0, 1, 3, 2, 5, 4},
                                 {7, 6, 5, 4, 3, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1}};

// coded_block_pattern by me(v) codeNum (Table 9-4), chroma in bits 4-5
const uint8_t kIntraCbp[48] = {47, 31, 15, 0,  23, 27, 29, 30, 7,  11, 13, 14, 39, 43, 45, 46,
                               16, 3,  5,  10, 12, 19, 21, 26, 28, 35, 37, 42, 44, 1,  2,  4,
                               8,  17, 18, 20, 24, 6,  9,  22, 25, 32, 33, 34, 36, 40, 38, 41};
const uint8_t kInterCbp[48] = {0,  16, 1,  2,  4,  8,  32, 3,  5,  10, 12, 15, 47, 7,  11, 13,
                               14, 6,  9,  31, 35, 37, 42, 44, 33, 34, 36, 40, 39, 43, 45, 46,
                               17, 18, 20, 24, 19, 21, 26, 28, 23, 27, 29, 30, 22, 25, 38, 41};

// the 4x4 zigzag scan as raster positions
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
// normAdjust4x4 (8-315) by QP % 6 and position class
const int kDequant[6][3] = {{10, 16, 13}, {11, 18, 14}, {13, 20, 16},
                            {14, 23, 18}, {16, 25, 20}, {18, 29, 23}};
// QPc by qPI 30-51 (Table 8-15)
const uint8_t kChromaQp[22] = {29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36,
                               36, 37, 37, 37, 38, 38, 38, 39, 39, 39, 39};
// deblocking: alpha' and beta' by indexA / indexB (Table 8-16), tC0 by
// indexA and bS 1-3 (Table 8-17)
const uint8_t kAlpha[52] = {0,  0,  0,  0,  0,  0,  0,  0,  0,   0,   0,   0,   0,
                            0,  0,  0,  4,  4,  5,  6,  7,  8,   9,   10,  12,  13,
                            15, 17, 20, 22, 25, 28, 32, 36, 40,  45,  50,  56,  63,
                            71, 80, 90, 101, 113, 127, 144, 162, 182, 203, 226, 255, 255};
const uint8_t kBeta[52] = {0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  2, 2,
                           2, 3, 3, 3, 3, 4, 4,  4,  6,  6,  7,  7,  8,  8,  9,  9,  10, 10,
                           11, 11, 12, 12, 13, 13, 14, 14, 15, 15, 16, 16, 17, 17, 18, 18};
const uint8_t kTc0[52][3] = {
    {0, 0, 0},   {0, 0, 0},   {0, 0, 0},   {0, 0, 0},    {0, 0, 0},    {0, 0, 0},   {0, 0, 0},
    {0, 0, 0},   {0, 0, 0},   {0, 0, 0},   {0, 0, 0},    {0, 0, 0},    {0, 0, 0},   {0, 0, 0},
    {0, 0, 0},   {0, 0, 0},   {0, 0, 0},   {0, 0, 1},    {0, 0, 1},    {0, 0, 1},   {0, 0, 1},
    {0, 1, 1},   {0, 1, 1},   {1, 1, 1},   {1, 1, 1},    {1, 1, 1},    {1, 1, 1},   {1, 1, 2},
    {1, 1, 2},   {1, 1, 2},   {1, 1, 2},   {1, 2, 3},    {1, 2, 3},    {2, 2, 3},   {2, 2, 4},
    {2, 3, 4},   {2, 3, 4},   {3, 3, 5},   {3, 4, 6},    {3, 4, 6},    {4, 5, 7},   {4, 5, 8},
    {4, 6, 9},   {5, 7, 10},  {6, 8, 11},  {6, 8, 13},   {7, 10, 14},  {8, 11, 16}, {9, 12, 18},
    {10, 13, 20}, {11, 15, 23}, {13, 17, 25}};

struct Tables {
  Vlc token[4], chroma_dc_token, zeros[15], chroma_dc_zeros[3], run[7];
  Tables() {
    int16_t syms[68];
    for (int i = 0; i < 68; i++) syms[i] = (int16_t)i;
    for (int k = 0; k < 4; k++) token[k].add_all(kTokenLen[k], kTokenCode[k], syms, 68);
    chroma_dc_token.add_all(kChromaDcTokenLen, kChromaDcTokenCode, syms, 20);
    for (int k = 0; k < 15; k++) zeros[k].add_all(kZerosLen[k], kZerosCode[k], syms, 16 - k);
    for (int k = 0; k < 3; k++)
      chroma_dc_zeros[k].add_all(kChromaDcZerosLen[k], kChromaDcZerosCode[k], syms, 4 - k);
    for (int k = 0; k < 7; k++) run[k].add_all(kRunLen[k], kRunCode[k], syms, k < 6 ? k + 2 : 15);
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

int chroma_qp(int qp, int offset) {
  int q = clip3(0, 51, qp + offset);
  return q < 30 ? q : kChromaQp[q - 30];
}

// The 4x4 inverse transform (8.5.12) of coefficients d (raster), added to
// the 4x4 block at dst.
void idct4_add(int* d, uint8_t* dst, int stride) {
  int t[16];
  for (int i = 0; i < 4; i++) {  // rows
    const int* r = d + 4 * i;
    int e = r[0] + r[2], f = r[0] - r[2], g = (r[1] >> 1) - r[3], h = r[1] + (r[3] >> 1);
    t[4 * i] = e + h;
    t[4 * i + 1] = f + g;
    t[4 * i + 2] = f - g;
    t[4 * i + 3] = e - h;
  }
  for (int j = 0; j < 4; j++) {  // columns
    int e = t[j] + t[8 + j], f = t[j] - t[8 + j];
    int g = (t[4 + j] >> 1) - t[12 + j], h = t[4 + j] + (t[12 + j] >> 1);
    int out[4] = {e + h, f + g, f - g, e - h};
    for (int i = 0; i < 4; i++) {
      uint8_t* p = dst + (size_t)i * stride + j;
      *p = clip1(*p + ((out[i] + 32) >> 6));
    }
  }
}

// ------------------------------------------------------------ parameter sets

struct Sps {
  bool valid = false;
  std::string refuse;  // a tool the decoder does not take, named
  int log2_max_frame_num = 4, poc_type = 0, log2_max_poc_lsb = 4, max_refs = 0;
  int mb_w = 0, mb_h = 0;
  int crop_left = 0, crop_right = 0, crop_top = 0, crop_bottom = 0;  // luma samples
  bool colour_description = false;
  int matrix = 2;  // the VUI's matrix_coefficients
  bool same_geometry(const Sps& o) const {
    return mb_w == o.mb_w && mb_h == o.mb_h && crop_left == o.crop_left &&
           crop_right == o.crop_right && crop_top == o.crop_top && crop_bottom == o.crop_bottom;
  }
};

struct Pps {
  bool valid = false;
  std::string refuse;
  int sps_id = 0;
  bool bottom_field_poc = false;
  int num_ref_default = 1;
  int init_qp = 26;
  int cqp_offset[2] = {0, 0};
  bool deblock_control = false, constrained_intra = false;
};

// ---------------------------------------------------------------- pictures

struct Picture {
  std::vector<uint8_t> plane[3];
  int frame_num = 0;
  int id = 0;  // unique: the deblocking filter tells references apart by it
};

enum MbKind : int8_t { MB_I4, MB_I16, MB_P, MB_SKIP };

struct MbInfo {
  int8_t kind = MB_SKIP;
  int8_t qp = 0;
  int16_t slice = -1;   // the slice of the picture that holds it, -1 not yet decoded
  uint8_t nz[16];       // TotalCoeff of each luma 4x4 block, raster (I_16x16: AC)
  uint8_t nzc[2][4];    // TotalCoeff of each chroma AC block, raster
  int8_t mode[16];      // Intra4x4PredMode, raster
  int8_t ref[16];       // ref_idx_l0, -1 intra
  int16_t mv[16][2];
  int32_t pic[16];      // Picture::id of the reference, -1 intra
};

struct SliceInfo {
  int deblock_idc = 0, alpha_offset = 0, beta_offset = 0;
  int cqp_offset[2] = {0, 0};
};

inline bool is_intra(const MbInfo& m) { return m.kind == MB_I4 || m.kind == MB_I16; }

// Decode-order index of the luma 4x4 block at (x, y) of a macroblock.
inline int blk_index(int x, int y) { return (y >> 1) * 8 + (x >> 1) * 4 + (y & 1) * 2 + (x & 1); }

// ---------------------------------------------------------------- decoder

struct Decoder {
  // what the decoded pictures held (h264_stats): IDR pictures, pictures
  // with P slices, slices, pictures of several slices, I_NxN, I_16x16,
  // intra macroblocks of P slices, inter and skipped macroblocks, P_8x8
  // macroblocks, sub-macroblock partitions smaller than 8x8, partitions
  // with ref_idx above 0, macroblocks with a nonzero mb_qp_delta, level
  // codes with level_prefix 14 or more, luma predictions at a fractional
  // position, predictions read partly outside the picture, luma edge
  // segments filtered with bS 4 and with bS 1-3, slices with deblocking
  // offsets, slices with the filter off, pictures with constrained intra
  // prediction, cropped pictures
  enum { IDR, P_PICTURES, SLICES, MULTI_SLICE, I4X4, I16X16, P_INTRA, INTER, SKIPPED, P8X8,
         SMALL_PARTS, REF_ABOVE_0, QP_DELTA, LEVEL_ESCAPES, FRACTIONAL, OUTSIDE, BS4, BS_LT4,
         DEBLOCK_OFFSETS, DEBLOCK_OFF, CONSTRAINED_INTRA, CROPPED, N_STATS };
  int64_t stats[N_STATS] = {};

  int nal_length = 0;  // bytes of the NAL length prefix (avcC), 0 for Annex B
  Sps sps[32];
  Pps pps[256];
  std::string encoder;

  // the stream's geometry and colour matrix, fixed by its first picture
  Sps active;
  const yuv::Coeffs* coeffs = &yuv::kBt601;
  bool started = false;
  int mb_w = 0, mb_h = 0, width = 0, height = 0;  // width, height: the decoded (MB) size
  int stride[3] = {0, 0, 0}, ph[3] = {0, 0, 0};

  // references (short-term, in the order they were marked) and the output
  std::vector<std::shared_ptr<Picture>> refs;
  std::shared_ptr<Picture> out;
  int next_id = 0;
  int prev_ref_frame_num = 0;
  // what picture order counts carry from picture to picture: of the last
  // picture (its POC, frame_num, FrameNumOffset) and of the last reference
  // picture (pic_order_cnt_lsb and PicOrderCntMsb)
  struct Order {
    int poc = 0, frame_num = 0, frame_num_offset = 0, poc_msb = 0, poc_lsb = 0;
  } order, next_order;

  // the picture being decoded
  std::shared_ptr<Picture> cur;
  std::vector<MbInfo> mbs;
  std::vector<SliceInfo> slices;
  int cur_frame_num = 0, cur_nal_ref = 0, next_mb = 0;
  bool cur_idr = false;

  // the slice being decoded
  int slice_num = 0, slice_type = 0, qp = 0, num_ref = 1;
  bool constrained_intra = false;
  int cqp_offset[2] = {0, 0};
  std::vector<std::shared_ptr<Picture>> list0;

  // ---------------------------------------------------------- headers

  void parse_sps(const std::vector<uint8_t>& r) {
    // profile_idc, the constraint flags and level_idc do not gate: the
    // tools the stream uses do
    Bits b = rbsp_reader(r);
    Sps s;
    int profile = (int)b.get(8);
    b.get(16);
    int id = b.ue_max(31, "seq_parameter_set_id");
    s.valid = true;
    auto refuse = [&](const std::string& what) {
      s.refuse = what;
      sps[id] = s;
    };
    static const int kHigh[] = {100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139, 134, 135};
    if (std::find(std::begin(kHigh), std::end(kHigh), profile) != std::end(kHigh)) {
      int chroma = b.ue_max(3, "chroma_format_idc");
      if (chroma == 3 && b.get1()) return refuse("separate colour planes (4:4:4)");
      if (chroma != 1) return refuse("chroma format " + std::to_string(chroma) + " (not 4:2:0)");
      int luma_bits = b.ue_max(6, "bit_depth_luma_minus8") + 8;
      int chroma_bits = b.ue_max(6, "bit_depth_chroma_minus8") + 8;
      if (luma_bits != 8 || chroma_bits != 8)
        return refuse("bit depth " + std::to_string(std::max(luma_bits, chroma_bits)) +
                      " (above 8)");
      if (b.get1()) return refuse("lossless coding (qpprime_y_zero_transform_bypass)");
      if (b.get1()) return refuse("scaling matrices");
    }
    s.log2_max_frame_num = b.ue_max(12, "log2_max_frame_num_minus4") + 4;
    s.poc_type = b.ue_max(2, "pic_order_cnt_type");
    if (s.poc_type == 1) return refuse("pic_order_cnt_type 1");
    if (s.poc_type == 0) s.log2_max_poc_lsb = b.ue_max(12, "log2_max_pic_order_cnt_lsb_minus4") + 4;
    s.max_refs = b.ue_max(16, "max_num_ref_frames");
    b.get(1);  // gaps_in_frame_num_value_allowed_flag: gaps are refused where met
    s.mb_w = b.ue_max(1023, "pic_width_in_mbs_minus1") + 1;
    s.mb_h = b.ue_max(1023, "pic_height_in_map_units_minus1") + 1;
    if (!b.get1()) return refuse("field and MBAFF coding (frame_mbs_only_flag 0: interlaced video)");
    b.get(1);  // direct_8x8_inference_flag
    if (b.get1()) {
      int l = b.ue_max(8192, "frame_crop_left_offset"), r = b.ue_max(8192, "frame_crop_right_offset");
      int t = b.ue_max(8192, "frame_crop_top_offset"), d = b.ue_max(8192, "frame_crop_bottom_offset");
      s.crop_left = 2 * l;
      s.crop_right = 2 * r;
      s.crop_top = 2 * t;
      s.crop_bottom = 2 * d;
      if (s.crop_left + s.crop_right >= 16 * s.mb_w || s.crop_top + s.crop_bottom >= 16 * s.mb_h)
        fail("a frame cropped to nothing");
    }
    if (b.get1()) {  // VUI
      if (b.get1() && b.get(8) == 255) b.get(32);  // aspect ratio, extended SAR
      if (b.get1()) b.get(1);                      // overscan
      if (b.get1()) {                              // video_signal_type
        b.get(4);  // video_format, video_full_range_flag (OpenCV's conversion ignores it)
        if (b.get1()) {                            // colour description
          s.colour_description = true;
          b.get(16);                               // primaries, transfer
          s.matrix = (int)b.get(8);
        }
      }
      // chroma location, timing, HRD and bitstream restriction: nothing the
      // decoder needs
    }
    sps[id] = s;
  }

  void parse_pps(const std::vector<uint8_t>& r) {
    Bits b = rbsp_reader(r);
    Pps p;
    int id = b.ue_max(255, "pic_parameter_set_id");
    p.sps_id = b.ue_max(31, "seq_parameter_set_id");
    auto refuse = [&](const std::string& what) {
      p.refuse = what;
      p.valid = true;
      pps[id] = p;
    };
    if (b.get1()) return refuse("CABAC (entropy_coding_mode_flag 1)");
    p.bottom_field_poc = b.get1();
    if (b.ue_max(7, "num_slice_groups_minus1") > 0) return refuse("slice groups (FMO)");
    p.num_ref_default = b.ue_max(31, "num_ref_idx_l0_default_active_minus1") + 1;
    b.ue_max(31, "num_ref_idx_l1_default_active_minus1");
    if (b.get1()) return refuse("weighted prediction (weighted_pred_flag 1)");
    b.get(2);  // weighted_bipred_idc: B slices are refused
    p.init_qp = 26 + b.se_range(-26, 25, "pic_init_qp_minus26");
    b.se_range(-26, 25, "pic_init_qs_minus26");
    p.cqp_offset[0] = p.cqp_offset[1] = b.se_range(-12, 12, "chroma_qp_index_offset");
    p.deblock_control = b.get1();
    p.constrained_intra = b.get1();
    if (b.get1()) return refuse("redundant pictures (redundant_pic_cnt_present_flag 1)");
    if (b.more_data()) {
      if (b.get1()) return refuse("the 8x8 transform (transform_8x8_mode_flag 1)");
      if (b.get1()) return refuse("scaling matrices");
      p.cqp_offset[1] = b.se_range(-12, 12, "second_chroma_qp_index_offset");
    }
    p.valid = true;
    pps[id] = p;
  }

  void parse_sei(const std::vector<uint8_t>& r) {
    // Lenient as FFmpeg: a broken SEI is ignored; the user data of the
    // first unregistered payload that reads as text names the encoder.
    size_t i = 0, n = r.size();
    while (i + 2 <= n && r[i] != 0x80) {
      int type = 0, size = 0;
      while (i < n && r[i] == 0xff) type += r[i++];
      if (i >= n) return;
      type += r[i++];
      while (i < n && r[i] == 0xff) size += r[i++];
      if (i >= n) return;
      size += r[i++];
      if (i + size > n) return;
      if (type == 5 && size > 16 && encoder.empty()) {
        std::string s((const char*)&r[i + 16], size - 16);
        s = s.substr(0, s.find('\0'));
        size_t cut = s.find(" - H.264");
        if (cut != std::string::npos) s = s.substr(0, cut);
        bool text = !s.empty();
        for (char c : s) text = text && c >= 32 && c < 127;
        if (text) encoder = s.substr(0, 63);
      }
      i += size;
    }
  }

  // The RGB conversion OpenCV applies to the stream: swscale's table of its
  // VUI matrix_coefficients, in limited range whatever video_full_range_flag
  // says (cv2.VideoCapture of OpenCV 5.0.0 ignores the flag).
  static const yuv::Coeffs* colour_matrix(const Sps& s) {
    if (!s.colour_description) return &yuv::kBt601;
    switch (s.matrix) {
      case 1: return &yuv::kBt709;
      case 2: case 5: case 6: return &yuv::kBt601;
      case 4: return &yuv::kFcc;
      case 7: return &yuv::kSmpte240m;
      case 9: case 10: return &yuv::kBt2020;
      default:
        unsupported("the VUI matrix_coefficients " + std::to_string(s.matrix) +
                    " (RGB, YCgCo or a matrix OpenCV's conversion does not name)");
    }
  }

  // ---------------------------------------------------------- neighbours

  MbInfo* mb_at(int mx, int my) {
    if (mx < 0 || my < 0 || mx >= mb_w || my >= mb_h) return nullptr;
    return &mbs[(size_t)my * mb_w + mx];
  }
  // the macroblock at (mx, my) when it is available: decoded in this slice
  MbInfo* avail(int mx, int my) {
    MbInfo* m = mb_at(mx, my);
    return m && m->slice == slice_num ? m : nullptr;
  }
  // ... and usable for intra prediction
  bool intra_avail(int mx, int my) {
    MbInfo* m = avail(mx, my);
    return m && !(constrained_intra && !is_intra(*m));
  }

  // ---------------------------------------------------------- CAVLC

  // residual_block_cavlc into coeff[0..max_coeff-1] (scan order); returns
  // TotalCoeff.
  int residual_block(Bits& b, int nc, int max_coeff, int* coeff) {
    const Tables& T = tables();
    std::fill(coeff, coeff + max_coeff, 0);
    const Vlc& vlc = nc < 0 ? T.chroma_dc_token
                            : T.token[nc < 2 ? 0 : nc < 4 ? 1 : nc < 8 ? 2 : 3];
    int sym = vlc.read(b, "coeff_token");
    int total = sym >> 2, ones = sym & 3;
    if (total > max_coeff) fail("coeff_token past the block's coefficients");
    if (total == 0) return 0;
    int level[16];
    int suffix_len = total > 10 && ones < 3 ? 1 : 0;
    for (int i = 0; i < total; i++) {
      if (i < ones) {
        level[i] = b.get1() ? -1 : 1;
        continue;
      }
      uint64_t v = b.peek64();
      int prefix = v ? __builtin_clzll(v) : 64;
      if (prefix > 28) fail("a level_prefix past 28");
      b.skip(prefix + 1);
      stats[LEVEL_ESCAPES] += prefix >= 14;
      int code = std::min(15, prefix) << suffix_len;
      if (suffix_len > 0 || prefix >= 14) {
        int size = prefix == 14 && suffix_len == 0 ? 4 : prefix >= 15 ? prefix - 3 : suffix_len;
        code += (int)b.get(size);
      }
      if (prefix >= 15 && suffix_len == 0) code += 15;
      if (prefix >= 16) code += (1 << (prefix - 3)) - 4096;
      if (i == ones && ones < 3) code += 2;
      level[i] = code % 2 == 0 ? (code + 2) >> 1 : (-code - 1) >> 1;
      if (level[i] > 32767 || level[i] < -32768) fail("a coefficient level out of range");
      if (suffix_len == 0) suffix_len = 1;
      if (std::abs(level[i]) > (3 << (suffix_len - 1)) && suffix_len < 6) suffix_len++;
    }
    int zeros = 0;
    if (total < max_coeff)
      zeros = (max_coeff == 4 ? T.chroma_dc_zeros : T.zeros)[total - 1].read(b, "total_zeros");
    if (total + zeros > max_coeff) fail("total_zeros past the block's coefficients");
    int pos = total + zeros - 1;
    for (int i = 0; i < total; i++) {
      coeff[pos] = level[i];
      if (i == total - 1) break;
      int run = 0;
      if (zeros > 0) {
        run = T.run[std::min(zeros, 7) - 1].read(b, "run_before");
        if (run > zeros) fail("run_before past total_zeros");
        zeros -= run;
      }
      pos -= run + 1;
    }
    return total;
  }

  // dequantised coefficient of level c at raster position `pos` and QP q
  static int dequant(int c, int pos, int q) {
    int i = pos >> 2, j = pos & 3;
    int cls = (i & 1) == 0 && (j & 1) == 0 ? 0 : (i & 1) && (j & 1) ? 1 : 2;
    int64_t d = (int64_t)c * kDequant[q % 6][cls] * (1 << (q / 6));
    if (d > 32767 || d < -32768) fail("a dequantised coefficient out of range");
    return (int)d;
  }

  // ---------------------------------------------------------- intra

  uint8_t* luma_at(int x, int y) { return cur->plane[0].data() + (size_t)y * stride[0] + x; }

  // Intra 4x4 prediction of the block at luma (x, y), block (bx, by) of
  // macroblock (mx, my), written to the picture.
  void intra4x4(int mode, int mx, int my, int bx, int by) {
    int x = 16 * mx + 4 * bx, y = 16 * my + 4 * by;
    bool has_left = bx > 0 || intra_avail(mx - 1, my);
    bool has_top = by > 0 || intra_avail(mx, my - 1);
    bool has_tl = bx > 0 && by > 0 ? true
                  : bx > 0         ? intra_avail(mx, my - 1)
                  : by > 0         ? intra_avail(mx - 1, my)
                                   : intra_avail(mx - 1, my - 1);
    bool has_tr;
    if (by == 0)
      has_tr = bx < 3 ? intra_avail(mx, my - 1) : intra_avail(mx + 1, my - 1);
    else
      has_tr = bx < 3 && blk_index(bx + 1, by - 1) < blk_index(bx, by);
    int T[8], L[4], TL = 0;
    if (has_top) {
      const uint8_t* t = luma_at(x, y - 1);
      for (int i = 0; i < 4; i++) T[i] = t[i];
      for (int i = 4; i < 8; i++) T[i] = has_tr ? t[i] : t[3];
    }
    if (has_left)
      for (int i = 0; i < 4; i++) L[i] = *luma_at(x - 1, y + i);
    if (has_tl) TL = *luma_at(x - 1, y - 1);
    static const uint8_t kNeeds[9] = {1, 2, 0, 1, 7, 7, 7, 1, 2};  // top 1, left 2, corner 4
    int needs = kNeeds[mode];
    if (((needs & 1) && !has_top) || ((needs & 2) && !has_left) || ((needs & 4) && !has_tl))
      fail("an intra 4x4 mode that reads unavailable samples");
    auto t = [&](int i) { return i < 0 ? TL : T[i]; };
    auto l = [&](int i) { return i < 0 ? TL : L[i]; };
    uint8_t* dst = luma_at(x, y);
    for (int yy = 0; yy < 4; yy++) {
      for (int xx = 0; xx < 4; xx++) {
        int v = 0;
        switch (mode) {
          case 0: v = T[xx]; break;
          case 1: v = L[yy]; break;
          case 2:
            if (has_top && has_left) v = (T[0] + T[1] + T[2] + T[3] + L[0] + L[1] + L[2] + L[3] + 4) >> 3;
            else if (has_left) v = (L[0] + L[1] + L[2] + L[3] + 2) >> 2;
            else if (has_top) v = (T[0] + T[1] + T[2] + T[3] + 2) >> 2;
            else v = 128;
            break;
          case 3:
            v = xx == 3 && yy == 3 ? (T[6] + 3 * T[7] + 2) >> 2
                                   : (T[xx + yy] + 2 * T[xx + yy + 1] + T[xx + yy + 2] + 2) >> 2;
            break;
          case 4:
            if (xx > yy) v = (t(xx - yy - 2) + 2 * t(xx - yy - 1) + t(xx - yy) + 2) >> 2;
            else if (xx < yy) v = (l(yy - xx - 2) + 2 * l(yy - xx - 1) + l(yy - xx) + 2) >> 2;
            else v = (t(0) + 2 * TL + l(0) + 2) >> 2;
            break;
          case 5: {
            int z = 2 * xx - yy, k = xx - (yy >> 1);
            if (z >= 0 && !(z & 1)) v = (t(k - 1) + t(k) + 1) >> 1;
            else if (z >= 0) v = (t(k - 2) + 2 * t(k - 1) + t(k) + 2) >> 2;
            else if (z == -1) v = (l(0) + 2 * TL + t(0) + 2) >> 2;
            else v = (l(yy - 1) + 2 * l(yy - 2) + l(yy - 3) + 2) >> 2;
            break;
          }
          case 6: {
            int z = 2 * yy - xx, k = yy - (xx >> 1);
            if (z >= 0 && !(z & 1)) v = (l(k - 1) + l(k) + 1) >> 1;
            else if (z >= 0) v = (l(k - 2) + 2 * l(k - 1) + l(k) + 2) >> 2;
            else if (z == -1) v = (l(0) + 2 * TL + t(0) + 2) >> 2;
            else v = (t(xx - 1) + 2 * t(xx - 2) + t(xx - 3) + 2) >> 2;
            break;
          }
          case 7: {
            int k = xx + (yy >> 1);
            v = (yy & 1) ? (T[k] + 2 * T[k + 1] + T[k + 2] + 2) >> 2 : (T[k] + T[k + 1] + 1) >> 1;
            break;
          }
          case 8: {
            int z = xx + 2 * yy, k = yy + (xx >> 1);
            if (z > 5) v = L[3];
            else if (z == 5) v = (L[2] + 3 * L[3] + 2) >> 2;
            else if (z & 1) v = (L[k] + 2 * L[k + 1] + L[k + 2] + 2) >> 2;
            else v = (L[k] + L[k + 1] + 1) >> 1;
            break;
          }
        }
        dst[(size_t)yy * stride[0] + xx] = (uint8_t)v;
      }
    }
  }

  // Intra 16x16 (p = 0, n = 16) or chroma (p = 1, 2, n = 8) prediction of
  // macroblock (mx, my); `mode` in the luma numbering (0 vertical, 1
  // horizontal, 2 DC, 3 plane).
  void intra_block(int p, int n, int mode, int mx, int my) {
    int s = stride[p];
    uint8_t* dst = cur->plane[p].data() + (size_t)n * my * s + n * mx;
    bool has_left = intra_avail(mx - 1, my), has_top = intra_avail(mx, my - 1);
    bool has_tl = intra_avail(mx - 1, my - 1);
    int T[16], L[16], TL = has_tl ? dst[-s - 1] : 0;
    for (int i = 0; i < n; i++) {
      T[i] = has_top ? dst[i - s] : 0;
      L[i] = has_left ? dst[(size_t)i * s - 1] : 0;
    }
    if ((mode == 0 && !has_top) || (mode == 1 && !has_left) ||
        (mode == 3 && !(has_top && has_left && has_tl)))
      fail("an intra 16x16 or chroma mode that reads unavailable samples");
    if (mode == 0 || mode == 1) {
      for (int y = 0; y < n; y++)
        for (int x = 0; x < n; x++) dst[(size_t)y * s + x] = (uint8_t)(mode == 0 ? T[x] : L[y]);
    } else if (mode == 3) {
      int half = n / 2, H = 0, V = 0;
      for (int i = 0; i < half; i++) {
        H += (i + 1) * (T[half + i] - (half - 2 - i < 0 ? TL : T[half - 2 - i]));
        V += (i + 1) * (L[half + i] - (half - 2 - i < 0 ? TL : L[half - 2 - i]));
      }
      int a = 16 * (L[n - 1] + T[n - 1]);
      int b = n == 16 ? (5 * H + 32) >> 6 : (34 * H + 32) >> 6;
      int c = n == 16 ? (5 * V + 32) >> 6 : (34 * V + 32) >> 6;
      for (int y = 0; y < n; y++)
        for (int x = 0; x < n; x++)
          dst[(size_t)y * s + x] = clip1((a + b * (x - (half - 1)) + c * (y - (half - 1)) + 16) >> 5);
    } else if (n == 16) {
      int sum = 0;
      for (int i = 0; i < 16; i++) sum += (has_top ? T[i] : 0) + (has_left ? L[i] : 0);
      int v = has_top && has_left ? (sum + 16) >> 5 : has_top || has_left ? (sum + 8) >> 4 : 128;
      for (int y = 0; y < 16; y++) memset(dst + (size_t)y * s, v, 16);
    } else {  // chroma DC, by 4x4 block
      for (int by = 0; by < 2; by++) {
        for (int bx = 0; bx < 2; bx++) {
          int st = 0, sl = 0;
          for (int i = 0; i < 4; i++) {
            st += T[4 * bx + i];
            sl += L[4 * by + i];
          }
          int v;
          if (bx == by) {
            v = has_top && has_left ? (st + sl + 4) >> 3 : has_left ? (sl + 2) >> 2
                : has_top ? (st + 2) >> 2 : 128;
          } else if (bx) {
            v = has_top ? (st + 2) >> 2 : has_left ? (sl + 2) >> 2 : 128;
          } else {
            v = has_left ? (sl + 2) >> 2 : has_top ? (st + 2) >> 2 : 128;
          }
          for (int y = 0; y < 4; y++) memset(dst + (size_t)(4 * by + y) * s + 4 * bx, v, 4);
        }
      }
    }
  }

  // ---------------------------------------------------------- inter

  // Quarter-sample luma prediction of a bw x bh block at (x, y) moved by
  // (mvx, mvy) in ref, into the picture.
  void mc_luma(const Picture& ref, int x, int y, int bw, int bh, int mvx, int mvy) {
    int xi = x + (mvx >> 2), yi = y + (mvy >> 2), fx = mvx & 3, fy = mvy & 3;
    const int W = width, H = height, S = stride[0];
    uint8_t win[21 * 21];
    const uint8_t* w;
    int ws;
    if (xi - 2 >= 0 && yi - 2 >= 0 && xi + bw + 3 <= W && yi + bh + 3 <= H) {
      w = ref.plane[0].data() + (size_t)(yi - 2) * S + (xi - 2);
      ws = S;
    } else {
      stats[OUTSIDE]++;
      for (int r = 0; r < bh + 5; r++) {
        int yy = clip3(0, H - 1, yi - 2 + r);
        for (int c = 0; c < bw + 5; c++)
          win[r * 21 + c] = ref.plane[0][(size_t)yy * S + clip3(0, W - 1, xi - 2 + c)];
      }
      w = win;
      ws = 21;
    }
    stats[FRACTIONAL] += (fx | fy) != 0;
    auto G = [&](int c, int r) { return (int)w[(size_t)(r + 2) * ws + c + 2]; };
    auto b1 = [&](int c, int r) {
      return G(c - 2, r) - 5 * G(c - 1, r) + 20 * G(c, r) + 20 * G(c + 1, r) - 5 * G(c + 2, r) +
             G(c + 3, r);
    };
    auto h1 = [&](int c, int r) {
      return G(c, r - 2) - 5 * G(c, r - 1) + 20 * G(c, r) + 20 * G(c, r + 1) - 5 * G(c, r + 2) +
             G(c, r + 3);
    };
    auto B = [&](int c, int r) { return (int)clip1((b1(c, r) + 16) >> 5); };
    auto Hh = [&](int c, int r) { return (int)clip1((h1(c, r) + 16) >> 5); };
    auto J = [&](int c, int r) {
      int j1 = b1(c, r - 2) - 5 * b1(c, r - 1) + 20 * b1(c, r) + 20 * b1(c, r + 1) -
               5 * b1(c, r + 2) + b1(c, r + 3);
      return (int)clip1((j1 + 512) >> 10);
    };
    uint8_t* dst = luma_at(x, y);
    for (int r = 0; r < bh; r++) {
      uint8_t* o = dst + (size_t)r * S;
      for (int c = 0; c < bw; c++) {
        int v;
        switch (fy * 4 + fx) {
          case 0: v = G(c, r); break;
          case 1: v = (G(c, r) + B(c, r) + 1) >> 1; break;
          case 2: v = B(c, r); break;
          case 3: v = (G(c + 1, r) + B(c, r) + 1) >> 1; break;
          case 4: v = (G(c, r) + Hh(c, r) + 1) >> 1; break;
          case 5: v = (B(c, r) + Hh(c, r) + 1) >> 1; break;
          case 6: v = (B(c, r) + J(c, r) + 1) >> 1; break;
          case 7: v = (B(c, r) + Hh(c + 1, r) + 1) >> 1; break;
          case 8: v = Hh(c, r); break;
          case 9: v = (Hh(c, r) + J(c, r) + 1) >> 1; break;
          case 10: v = J(c, r); break;
          case 11: v = (J(c, r) + Hh(c + 1, r) + 1) >> 1; break;
          case 12: v = (G(c, r + 1) + Hh(c, r) + 1) >> 1; break;
          case 13: v = (Hh(c, r) + B(c, r + 1) + 1) >> 1; break;
          case 14: v = (J(c, r) + B(c, r + 1) + 1) >> 1; break;
          default: v = (Hh(c + 1, r) + B(c, r + 1) + 1) >> 1; break;
        }
        o[c] = (uint8_t)v;
      }
    }
  }

  // Eighth-sample chroma prediction of a bw x bh block at chroma (x, y).
  void mc_chroma(const Picture& ref, int p, int x, int y, int bw, int bh, int mvx, int mvy) {
    int xi = x + (mvx >> 3), yi = y + (mvy >> 3), fx = mvx & 7, fy = mvy & 7;
    const int W = width / 2, H = height / 2, S = stride[p];
    const uint8_t* src = ref.plane[p].data();
    uint8_t* dst = cur->plane[p].data() + (size_t)y * S + x;
    bool inside = xi >= 0 && yi >= 0 && xi + bw + 1 <= W && yi + bh + 1 <= H;
    for (int r = 0; r < bh; r++) {
      int y0 = inside ? yi + r : clip3(0, H - 1, yi + r);
      int y1 = inside ? yi + r + 1 : clip3(0, H - 1, yi + r + 1);
      for (int c = 0; c < bw; c++) {
        int x0 = inside ? xi + c : clip3(0, W - 1, xi + c);
        int x1 = inside ? xi + c + 1 : clip3(0, W - 1, xi + c + 1);
        int A = src[(size_t)y0 * S + x0], Bv = src[(size_t)y0 * S + x1];
        int C = src[(size_t)y1 * S + x0], D = src[(size_t)y1 * S + x1];
        dst[(size_t)r * S + c] =
            (uint8_t)(((8 - fx) * (8 - fy) * A + fx * (8 - fy) * Bv + (8 - fx) * fy * C +
                       fx * fy * D + 32) >> 6);
      }
    }
  }

  struct Nb {
    bool avail;
    int ref;
    int mv[2];
  };

  // The motion of the 4x4 block at (x4, y4) in 4x4 units from the current
  // macroblock's corner (-1..4, -1..3); `done` marks the current
  // macroblock's blocks already predicted.
  Nb neighbour(int mx, int my, const MbInfo& m, const bool* done, int x4, int y4) {
    const MbInfo* n = nullptr;
    int bx = x4 & 3, by = y4 & 3;
    if (y4 < 0) {
      n = avail(x4 < 0 ? mx - 1 : x4 > 3 ? mx + 1 : mx, my - 1);
    } else if (x4 < 0) {
      n = avail(mx - 1, my);
    } else if (x4 > 3) {
      n = nullptr;
    } else {
      if (!done[y4 * 4 + x4]) return {false, -1, {0, 0}};
      n = &m;
    }
    if (!n) return {false, -1, {0, 0}};
    if (is_intra(*n)) return {true, -1, {0, 0}};
    int k = by * 4 + bx;
    return {true, n->ref[k], {n->mv[k][0], n->mv[k][1]}};
  }

  // shape: 0 other, 1 16x8, 2 8x16
  void mv_pred(int mx, int my, const MbInfo& m, const bool* done, int x4, int y4, int w4,
               int ref, int shape, int* mvp) {
    Nb A = neighbour(mx, my, m, done, x4 - 1, y4);
    Nb B = neighbour(mx, my, m, done, x4, y4 - 1);
    Nb C = neighbour(mx, my, m, done, x4 + w4, y4 - 1);
    if (!C.avail) C = neighbour(mx, my, m, done, x4 - 1, y4 - 1);
    const Nb* pick = nullptr;
    if (shape == 1) pick = y4 == 0 ? (B.ref == ref ? &B : nullptr) : (A.ref == ref ? &A : nullptr);
    if (shape == 2) pick = x4 == 0 ? (A.ref == ref ? &A : nullptr) : (C.ref == ref ? &C : nullptr);
    if (pick) {
      mvp[0] = pick->mv[0];
      mvp[1] = pick->mv[1];
      return;
    }
    if (!B.avail && !C.avail && A.avail) B = C = A;
    int match = (A.ref == ref) + (B.ref == ref) + (C.ref == ref);
    if (match == 1) {
      const Nb& one = A.ref == ref ? A : B.ref == ref ? B : C;
      mvp[0] = one.mv[0];
      mvp[1] = one.mv[1];
      return;
    }
    for (int k = 0; k < 2; k++)
      mvp[k] = std::max(std::min(A.mv[k], B.mv[k]), std::min(std::max(A.mv[k], B.mv[k]), C.mv[k]));
  }

  // Store the motion of a w4 x h4 partition at (x4, y4), predict it.
  void set_motion(int mx, int my, MbInfo& m, bool* done, int x4, int y4, int w4, int h4, int ref,
                  int mvx, int mvy) {
    if (mvx < -32768 || mvx > 32767 || mvy < -32768 || mvy > 32767)
      fail("a motion vector out of range");
    if (ref >= (int)list0.size() || !list0[ref]) fail("a reference index past the reference list");
    for (int y = y4; y < y4 + h4; y++)
      for (int x = x4; x < x4 + w4; x++) {
        int k = y * 4 + x;
        m.ref[k] = (int8_t)ref;
        m.mv[k][0] = (int16_t)mvx;
        m.mv[k][1] = (int16_t)mvy;
        m.pic[k] = list0[ref]->id;
        done[k] = true;
      }
    const Picture& r = *list0[ref];
    mc_luma(r, 16 * mx + 4 * x4, 16 * my + 4 * y4, 4 * w4, 4 * h4, mvx, mvy);
    for (int p = 1; p < 3; p++)
      mc_chroma(r, p, 8 * mx + 2 * x4, 8 * my + 2 * y4, 2 * w4, 2 * h4, mvx, mvy);
  }

  // ---------------------------------------------------------- macroblocks

  int luma_nc(int mx, int my, const MbInfo& m, int bx, int by) {
    int na = 0, nb = 0;
    bool a = true, b = true;
    if (bx > 0) {
      na = m.nz[by * 4 + bx - 1];
    } else if (const MbInfo* n = avail(mx - 1, my)) {
      na = n->nz[by * 4 + 3];
    } else {
      a = false;
    }
    if (by > 0) {
      nb = m.nz[(by - 1) * 4 + bx];
    } else if (const MbInfo* n = avail(mx, my - 1)) {
      nb = n->nz[12 + bx];
    } else {
      b = false;
    }
    return a && b ? (na + nb + 1) >> 1 : a ? na : b ? nb : 0;
  }

  int chroma_nc(int mx, int my, const MbInfo& m, int c, int bx, int by) {
    int na = 0, nb = 0;
    bool a = true, b = true;
    if (bx > 0) {
      na = m.nzc[c][by * 2];
    } else if (const MbInfo* n = avail(mx - 1, my)) {
      na = n->nzc[c][by * 2 + 1];
    } else {
      a = false;
    }
    if (by > 0) {
      nb = m.nzc[c][bx];
    } else if (const MbInfo* n = avail(mx, my - 1)) {
      nb = n->nzc[c][2 + bx];
    } else {
      b = false;
    }
    return a && b ? (na + nb + 1) >> 1 : a ? na : b ? nb : 0;
  }

  void skip_mb(int mx, int my) {
    MbInfo& m = mbs[(size_t)my * mb_w + mx];
    m.kind = MB_SKIP;
    m.slice = (int16_t)slice_num;
    m.qp = (int8_t)qp;
    memset(m.nz, 0, sizeof m.nz);
    memset(m.nzc, 0, sizeof m.nzc);
    memset(m.mode, 2, sizeof m.mode);
    stats[SKIPPED]++;
    bool done[16] = {};
    Nb A = neighbour(mx, my, m, done, -1, 0), B = neighbour(mx, my, m, done, 0, -1);
    int mv[2] = {0, 0};
    if (A.avail && B.avail && !(A.ref == 0 && !A.mv[0] && !A.mv[1]) &&
        !(B.ref == 0 && !B.mv[0] && !B.mv[1]))
      mv_pred(mx, my, m, done, 0, 0, 4, 0, 0, mv);
    set_motion(mx, my, m, done, 0, 0, 4, 4, 0, mv[0], mv[1]);
  }

  int read_ref(Bits& b) {
    if (num_ref == 1) return 0;
    int r = num_ref == 2 ? !b.get1() : b.ue_max(num_ref - 1, "ref_idx_l0");
    stats[REF_ABOVE_0] += r > 0;
    return r;
  }

  void macroblock(Bits& b, int mx, int my) {
    MbInfo& m = mbs[(size_t)my * mb_w + mx];
    m.slice = (int16_t)slice_num;
    memset(m.nz, 0, sizeof m.nz);
    memset(m.nzc, 0, sizeof m.nzc);
    memset(m.mode, 2, sizeof m.mode);
    int type = b.ue_max(slice_type == 0 ? 30 : 25, "mb_type");
    bool intra = true;
    if (slice_type == 0) {
      if (type < 5) intra = false;
      else type -= 5;
    }
    int cbp = 0, i16_mode = 0, chroma_mode = 0;
    if (intra) {
      if (type == 25) unsupported("I_PCM macroblocks");
      for (int k = 0; k < 16; k++) {
        m.ref[k] = -1;
        m.pic[k] = -1;
        m.mv[k][0] = m.mv[k][1] = 0;
      }
      stats[P_INTRA] += slice_type == 0;
      if (type == 0) {
        m.kind = MB_I4;
        stats[I4X4]++;
        for (int k = 0; k < 16; k++) {
          int bx = (k & 1) + ((k >> 2) & 1) * 2, by = ((k >> 1) & 1) + (k >> 3) * 2;
          int pa, pb;  // the neighbours' modes, -1 when dcPredModePredictedFlag
          auto mode_of = [&](int dx, int dy) {
            int x = bx + dx, y = by + dy;
            if (x >= 0 && y >= 0) return (int)m.mode[y * 4 + x];
            int nx = x < 0 ? mx - 1 : mx, ny = y < 0 ? my - 1 : my;
            MbInfo* n = avail(nx, ny);
            if (!n || (constrained_intra && !is_intra(*n))) return -1;
            return n->kind == MB_I4 ? (int)n->mode[(y & 3) * 4 + (x & 3)] : 2;
          };
          pa = mode_of(-1, 0);
          pb = mode_of(0, -1);
          int pred = pa < 0 || pb < 0 ? 2 : std::min(pa, pb);
          int mode = pred;
          if (!b.get1()) {
            int rem = (int)b.get(3);
            mode = rem < pred ? rem : rem + 1;
          }
          m.mode[by * 4 + bx] = (int8_t)mode;
        }
      } else {
        m.kind = MB_I16;
        stats[I16X16]++;
        i16_mode = (type - 1) % 4;
        cbp = (((type - 1) / 4) % 3) << 4 | (type >= 13 ? 15 : 0);
      }
      chroma_mode = b.ue_max(3, "intra_chroma_pred_mode");
      if (m.kind == MB_I4) cbp = kIntraCbp[b.ue_max(47, "coded_block_pattern")];
    } else {
      m.kind = MB_P;
      stats[INTER]++;
      bool done[16] = {};
      if (type < 3) {
        int parts = type == 0 ? 1 : 2;
        int refs[2] = {0, 0}, mvd[2][2];
        for (int i = 0; i < parts; i++) refs[i] = read_ref(b);
        for (int i = 0; i < parts; i++) {
          mvd[i][0] = b.se();
          mvd[i][1] = b.se();
        }
        for (int i = 0; i < parts; i++) {
          int x4 = type == 2 ? 2 * i : 0, y4 = type == 1 ? 2 * i : 0;
          int w4 = type == 2 ? 2 : 4, h4 = type == 1 ? 2 : 4;
          int mvp[2];
          mv_pred(mx, my, m, done, x4, y4, w4, refs[i], type, mvp);
          set_motion(mx, my, m, done, x4, y4, w4, h4, refs[i], mvp[0] + mvd[i][0],
                     mvp[1] + mvd[i][1]);
        }
      } else {
        stats[P8X8]++;
        int sub[4], refs[4] = {0, 0, 0, 0};
        for (int i = 0; i < 4; i++) {
          sub[i] = b.ue_max(3, "sub_mb_type");
          stats[SMALL_PARTS] += sub[i] > 0;
        }
        if (type == 3)
          for (int i = 0; i < 4; i++) refs[i] = read_ref(b);
        int mvd[4][4][2];
        for (int i = 0; i < 4; i++) {
          int n = sub[i] == 0 ? 1 : sub[i] == 3 ? 4 : 2;
          for (int j = 0; j < n; j++) {
            mvd[i][j][0] = b.se();
            mvd[i][j][1] = b.se();
          }
        }
        for (int i = 0; i < 4; i++) {
          int n = sub[i] == 0 ? 1 : sub[i] == 3 ? 4 : 2;
          int w4 = sub[i] == 0 || sub[i] == 1 ? 2 : 1, h4 = sub[i] == 0 || sub[i] == 2 ? 2 : 1;
          for (int j = 0; j < n; j++) {
            int x4 = 2 * (i & 1) + (w4 == 1 ? (j & 1) : 0);
            int y4 = 2 * (i >> 1) + (h4 == 1 ? (sub[i] == 1 ? j : j >> 1) : 0);
            int mvp[2];
            mv_pred(mx, my, m, done, x4, y4, w4, refs[i], 0, mvp);
            set_motion(mx, my, m, done, x4, y4, w4, h4, refs[i], mvp[0] + mvd[i][j][0],
                       mvp[1] + mvd[i][j][1]);
          }
        }
      }
      cbp = kInterCbp[b.ue_max(47, "coded_block_pattern")];
    }
    int cbp_luma = cbp & 15, cbp_chroma = cbp >> 4;
    if (cbp_chroma > 2) fail("a coded_block_pattern past 47");
    if (cbp || m.kind == MB_I16) {
      int delta = b.se_range(-26, 25, "mb_qp_delta");
      stats[QP_DELTA] += delta != 0;
      qp = (qp + delta + 52) % 52;
    }
    m.qp = (int8_t)qp;

    // residual
    int coef[16][16] = {};  // luma by raster block, raster positions
    int buf[16];
    bool has_coef[16] = {};
    if (m.kind == MB_I16) {
      int n = residual_block(b, luma_nc(mx, my, m, 0, 0), 16, buf);
      int c[16] = {};
      for (int k = 0; k < 16; k++) c[kZigzag[k]] = buf[k];
      if (n) {
        // inverse Hadamard, then scaling with LevelScale(QP % 6, 0, 0)
        int t[16], f[16];
        for (int i = 0; i < 4; i++) {
          const int* r = c + 4 * i;
          t[4 * i] = r[0] + r[1] + r[2] + r[3];
          t[4 * i + 1] = r[0] + r[1] - r[2] - r[3];
          t[4 * i + 2] = r[0] - r[1] - r[2] + r[3];
          t[4 * i + 3] = r[0] - r[1] + r[2] - r[3];
        }
        for (int j = 0; j < 4; j++) {
          f[j] = t[j] + t[4 + j] + t[8 + j] + t[12 + j];
          f[4 + j] = t[j] + t[4 + j] - t[8 + j] - t[12 + j];
          f[8 + j] = t[j] - t[4 + j] - t[8 + j] + t[12 + j];
          f[12 + j] = t[j] - t[4 + j] + t[8 + j] - t[12 + j];
        }
        int scale = 16 * kDequant[qp % 6][0];
        for (int k = 0; k < 16; k++) {
          int64_t v = qp >= 36 ? (int64_t)f[k] * scale * (1 << (qp / 6 - 6))
                               : ((int64_t)f[k] * scale + (1 << (5 - qp / 6))) >> (6 - qp / 6);
          if (v > 32767 || v < -32768) fail("a luma DC coefficient out of range");
          coef[k][0] = (int)v;
          has_coef[k] = v != 0;
        }
      }
    }
    for (int k = 0; k < 16; k++) {
      int bx = (k & 1) + ((k >> 2) & 1) * 2, by = ((k >> 1) & 1) + (k >> 3) * 2;
      int r = by * 4 + bx;
      if (!(cbp_luma >> (k >> 2) & 1)) continue;
      int nc = luma_nc(mx, my, m, bx, by);
      if (m.kind == MB_I16) {
        m.nz[r] = (uint8_t)residual_block(b, nc, 15, buf);
        for (int i = 0; i < 15; i++)
          if (buf[i]) coef[r][kZigzag[i + 1]] = dequant(buf[i], kZigzag[i + 1], qp);
      } else {
        m.nz[r] = (uint8_t)residual_block(b, nc, 16, buf);
        for (int i = 0; i < 16; i++)
          if (buf[i]) coef[r][kZigzag[i]] = dequant(buf[i], kZigzag[i], qp);
      }
      has_coef[r] = has_coef[r] || m.nz[r];
    }
    int ccoef[2][4][16] = {};
    bool chas[2][4] = {};
    int qpc[2] = {chroma_qp(qp, cqp_offset[0]), chroma_qp(qp, cqp_offset[1])};
    if (cbp_chroma) {
      for (int c = 0; c < 2; c++) {
        int dc[4];
        if (!residual_block(b, -1, 4, dc)) continue;
        int f0 = dc[0] + dc[1] + dc[2] + dc[3], f1 = dc[0] - dc[1] + dc[2] - dc[3];
        int f2 = dc[0] + dc[1] - dc[2] - dc[3], f3 = dc[0] - dc[1] - dc[2] + dc[3];
        int f[4] = {f0, f1, f2, f3};
        int scale = 16 * kDequant[qpc[c] % 6][0];
        for (int k = 0; k < 4; k++) {
          int64_t v = ((int64_t)f[k] * scale * (1 << (qpc[c] / 6))) >> 5;
          if (v > 32767 || v < -32768) fail("a chroma DC coefficient out of range");
          ccoef[c][k][0] = (int)v;
          chas[c][k] = v != 0;
        }
      }
    }
    if (cbp_chroma & 2) {
      for (int c = 0; c < 2; c++) {
        for (int k = 0; k < 4; k++) {
          int bx = k & 1, by = k >> 1;
          m.nzc[c][k] = (uint8_t)residual_block(b, chroma_nc(mx, my, m, c, bx, by), 15, buf);
          for (int i = 0; i < 15; i++)
            if (buf[i]) ccoef[c][k][kZigzag[i + 1]] = dequant(buf[i], kZigzag[i + 1], qpc[c]);
          chas[c][k] = chas[c][k] || m.nzc[c][k];
        }
      }
    }

    // reconstruction
    if (m.kind == MB_I4) {
      for (int k = 0; k < 16; k++) {
        int bx = (k & 1) + ((k >> 2) & 1) * 2, by = ((k >> 1) & 1) + (k >> 3) * 2;
        int r = by * 4 + bx;
        intra4x4(m.mode[r], mx, my, bx, by);
        if (has_coef[r]) idct4_add(coef[r], luma_at(16 * mx + 4 * bx, 16 * my + 4 * by), stride[0]);
      }
    } else {
      if (m.kind == MB_I16) intra_block(0, 16, i16_mode, mx, my);
      for (int r = 0; r < 16; r++)
        if (has_coef[r])
          idct4_add(coef[r], luma_at(16 * mx + 4 * (r & 3), 16 * my + 4 * (r >> 2)), stride[0]);
    }
    for (int c = 0; c < 2; c++) {
      int p = c + 1;
      if (intra) intra_block(p, 8, chroma_mode == 0 ? 2 : chroma_mode == 1 ? 1 : chroma_mode == 2 ? 0 : 3, mx, my);
      for (int k = 0; k < 4; k++)
        if (chas[c][k])
          idct4_add(ccoef[c][k],
                    cur->plane[p].data() + (size_t)(8 * my + 4 * (k >> 1)) * stride[p] + 8 * mx + 4 * (k & 1),
                    stride[p]);
    }
  }

  // ---------------------------------------------------------- deblocking

  int strength(const MbInfo& p, int pb, const MbInfo& q, int qb, bool mb_edge) {
    if (is_intra(p) || is_intra(q)) return mb_edge ? 4 : 3;
    if (p.nz[pb] || q.nz[qb]) return 2;
    if (p.pic[pb] != q.pic[qb]) return 1;
    if (std::abs(p.mv[pb][0] - q.mv[qb][0]) >= 4 || std::abs(p.mv[pb][1] - q.mv[qb][1]) >= 4) return 1;
    return 0;
  }

  // Filter `n` samples of one edge; `pix` is the first q0, `step` crosses
  // the edge, `along` runs along it; bs[i / per] is each sample's strength.
  static void filter_edge(uint8_t* pix, int step, int along, int n, int per, const int* bs, int qpav,
                          int alpha_off, int beta_off, bool chroma) {
    int ia = clip3(0, 51, qpav + alpha_off), ib = clip3(0, 51, qpav + beta_off);
    int alpha = kAlpha[ia], beta = kBeta[ib];
    for (int k = 0; k < n; k++) {
      int s = bs[k / per];
      if (!s) continue;
      uint8_t* q = pix + (ptrdiff_t)k * along;
      int p0 = q[-step], p1 = q[-2 * step], q0 = q[0], q1 = q[step];
      if (!(std::abs(p0 - q0) < alpha && std::abs(p1 - p0) < beta && std::abs(q1 - q0) < beta))
        continue;
      if (chroma) {
        if (s < 4) {
          int tc = kTc0[ia][s - 1] + 1;
          int d = clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
          q[-step] = clip1(p0 + d);
          q[0] = clip1(q0 - d);
        } else {
          q[-step] = (uint8_t)((2 * p1 + p0 + q1 + 2) >> 2);
          q[0] = (uint8_t)((2 * q1 + q0 + p1 + 2) >> 2);
        }
        continue;
      }
      int p2 = q[-3 * step], q2 = q[2 * step];
      int ap = std::abs(p2 - p0), aq = std::abs(q2 - q0);
      if (s < 4) {
        int tc0 = kTc0[ia][s - 1];
        int tc = tc0 + (ap < beta) + (aq < beta);
        int d = clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
        q[-step] = clip1(p0 + d);
        q[0] = clip1(q0 - d);
        if (ap < beta) q[-2 * step] = (uint8_t)(p1 + clip3(-tc0, tc0, (p2 + ((p0 + q0 + 1) >> 1) - (p1 << 1)) >> 1));
        if (aq < beta) q[step] = (uint8_t)(q1 + clip3(-tc0, tc0, (q2 + ((p0 + q0 + 1) >> 1) - (q1 << 1)) >> 1));
      } else {
        int p3 = q[-4 * step], q3 = q[3 * step];
        bool strong = std::abs(p0 - q0) < ((alpha >> 2) + 2);
        if (ap < beta && strong) {
          q[-step] = (uint8_t)((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3);
          q[-2 * step] = (uint8_t)((p2 + p1 + p0 + q0 + 2) >> 2);
          q[-3 * step] = (uint8_t)((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3);
        } else {
          q[-step] = (uint8_t)((2 * p1 + p0 + q1 + 2) >> 2);
        }
        if (aq < beta && strong) {
          q[0] = (uint8_t)((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3);
          q[step] = (uint8_t)((p0 + q0 + q1 + q2 + 2) >> 2);
          q[2 * step] = (uint8_t)((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3);
        } else {
          q[0] = (uint8_t)((2 * q1 + q0 + p1 + 2) >> 2);
        }
      }
    }
  }

  void deblock_mb(int mx, int my) {
    const MbInfo& q = mbs[(size_t)my * mb_w + mx];
    const SliceInfo& s = slices[q.slice];
    if (s.deblock_idc == 1) return;
    for (int dir = 0; dir < 2; dir++) {  // vertical edges, then horizontal
      for (int e = 0; e < 4; e++) {
        if (e == 0 && (dir ? my : mx) == 0) continue;
        const MbInfo& p = e > 0 ? q : dir ? mbs[(size_t)(my - 1) * mb_w + mx] : mbs[(size_t)my * mb_w + mx - 1];
        int bs[4];
        for (int i = 0; i < 4; i++) {
          int qb = dir ? e * 4 + i : i * 4 + e;
          int pb = dir ? ((e + 3) & 3) * 4 + i : i * 4 + ((e + 3) & 3);
          bs[i] = strength(p, pb, q, qb, e == 0);
          stats[bs[i] == 4 ? BS4 : BS_LT4] += bs[i] != 0;
        }
        int luma_step = dir ? stride[0] : 1, luma_along = dir ? 1 : stride[0];
        uint8_t* pix = cur->plane[0].data() + (size_t)(16 * my + (dir ? 4 * e : 0)) * stride[0] +
                       16 * mx + (dir ? 0 : 4 * e);
        filter_edge(pix, luma_step, luma_along, 16, 4, bs, (p.qp + q.qp + 1) >> 1, s.alpha_offset,
                    s.beta_offset, false);
        if (e & 1) continue;
        for (int c = 0; c < 2; c++) {
          int pl = c + 1, S = stride[pl];
          uint8_t* cp = cur->plane[pl].data() + (size_t)(8 * my + (dir ? 2 * e : 0)) * S + 8 * mx +
                        (dir ? 0 : 2 * e);
          int qpav = (chroma_qp(p.qp, s.cqp_offset[c]) + chroma_qp(q.qp, s.cqp_offset[c]) + 1) >> 1;
          filter_edge(cp, dir ? S : 1, dir ? 1 : S, 8, 2, bs, qpav, s.alpha_offset, s.beta_offset,
                      true);
        }
      }
    }
  }

  // ---------------------------------------------------------- slices

  void start_picture(const Sps& s, int frame_num, bool idr, int nal_ref, int poc_lsb) {
    if (!started) {
      if (!idr) unsupported("a stream that does not start with an IDR picture");
      if (s.crop_left) unsupported("frame cropping from the left");
      coeffs = colour_matrix(s);
      active = s;
      started = true;
      mb_w = s.mb_w;
      mb_h = s.mb_h;
      width = 16 * mb_w;
      height = 16 * mb_h;
      stride[0] = width;
      stride[1] = stride[2] = width / 2;
      ph[0] = height;
      ph[1] = ph[2] = height / 2;
      mbs.assign((size_t)mb_w * mb_h, MbInfo());
    } else if (!s.same_geometry(active)) {
      unsupported("a size change within the stream");
    }
    int max_frame_num = 1 << s.log2_max_frame_num;
    if (idr && frame_num != 0) fail("an IDR picture of frame_num " + std::to_string(frame_num));
    if (!idr && frame_num != prev_ref_frame_num &&
        frame_num != (prev_ref_frame_num + 1) % max_frame_num)
      unsupported("gaps in frame_num");
    // picture order count: it must rise in decode order, as FFmpeg then
    // outputs the pictures in that order. The state it carries is kept by
    // finish_picture, so that a picture that fails leaves none of it.
    Order o = order;
    if (idr) o = Order();
    int poc;
    if (s.poc_type == 0) {
      int max_lsb = 1 << s.log2_max_poc_lsb, msb;
      if (poc_lsb < o.poc_lsb && o.poc_lsb - poc_lsb >= max_lsb / 2) msb = o.poc_msb + max_lsb;
      else if (poc_lsb > o.poc_lsb && poc_lsb - o.poc_lsb > max_lsb / 2) msb = o.poc_msb - max_lsb;
      else msb = o.poc_msb;
      poc = msb + poc_lsb;
      if (nal_ref) {
        o.poc_msb = msb;
        o.poc_lsb = poc_lsb;
      }
    } else {
      int offset = idr ? 0 : o.frame_num > frame_num ? o.frame_num_offset + max_frame_num
                                                     : o.frame_num_offset;
      poc = idr ? 0 : 2 * (offset + frame_num) - (nal_ref ? 0 : 1);
      o.frame_num_offset = offset;
    }
    if (!idr && poc <= o.poc) unsupported("a picture order count out of decode order (reordered output)");
    o.poc = poc;
    o.frame_num = frame_num;
    next_order = o;
    cur = std::make_shared<Picture>();
    for (int p = 0; p < 3; p++) cur->plane[p].assign((size_t)stride[p] * ph[p], 0);
    cur->frame_num = frame_num;
    cur->id = next_id++;
    cur_frame_num = frame_num;
    cur_idr = idr;
    cur_nal_ref = nal_ref;
    next_mb = 0;
    slices.clear();
    for (MbInfo& m : mbs) m.slice = -1;
    stats[IDR] += idr;
  }

  void slice(const std::vector<uint8_t>& r, int nal_type, int nal_ref) {
    Bits b = rbsp_reader(r);
    int first_mb = (int)b.ue();
    int type = b.ue_max(9, "slice_type") % 5;
    if (type == 1) unsupported("B slices");
    if (type == 3 || type == 4) unsupported("SP and SI slices");
    int pps_id = b.ue_max(255, "pic_parameter_set_id");
    const Pps& p = pps[pps_id];
    if (!p.valid) fail("a slice of a missing PPS " + std::to_string(pps_id));
    const Sps& s = sps[p.sps_id];
    if (!s.valid) fail("a slice of a missing SPS " + std::to_string(p.sps_id));
    if (!s.refuse.empty()) unsupported(s.refuse);
    if (!p.refuse.empty()) unsupported(p.refuse);
    bool idr = nal_type == 5;
    if (idr && type != 2) fail("an IDR picture with a P slice");
    int frame_num = (int)b.get(s.log2_max_frame_num);
    if (idr) b.ue_max(65535, "idr_pic_id");
    int poc_lsb = 0;
    if (s.poc_type == 0) {
      poc_lsb = (int)b.get(s.log2_max_poc_lsb);
      if (p.bottom_field_poc) b.se();
    }
    int nref = p.num_ref_default;
    if (type == 0) {
      if (b.get1()) nref = b.ue_max(31, "num_ref_idx_l0_active_minus1") + 1;
      if (nref > 16) fail("num_ref_idx_l0_active above 16 in a frame");
      if (b.get1()) unsupported("reference picture list modification");
    }
    if (nal_ref) {
      if (idr) {
        b.get(1);  // no_output_of_prior_pics_flag
        if (b.get1()) unsupported("long-term reference pictures");
      } else if (b.get1()) {
        unsupported("memory management control operations (MMCO)");
      }
    }
    int qp0 = p.init_qp + b.se_range(-51, 51, "slice_qp_delta");
    if (qp0 < 0 || qp0 > 51) fail("a slice QP out of range");
    SliceInfo info;
    if (p.deblock_control) {
      info.deblock_idc = b.ue_max(2, "disable_deblocking_filter_idc");
      if (info.deblock_idc == 2) unsupported("disable_deblocking_filter_idc 2 (no filtering across slice edges)");
      if (info.deblock_idc != 1) {
        info.alpha_offset = 2 * b.se_range(-6, 6, "slice_alpha_c0_offset_div2");
        info.beta_offset = 2 * b.se_range(-6, 6, "slice_beta_offset_div2");
      }
    }
    info.cqp_offset[0] = p.cqp_offset[0];
    info.cqp_offset[1] = p.cqp_offset[1];

    if (cur && first_mb == 0) unsupported("several pictures in one packet");
    if (!cur) {
      if (first_mb != 0) unsupported("arbitrary slice order (ASO): a picture's first slice past its first macroblock");
      if (!started && !idr) unsupported("a stream that does not start with an IDR picture");
      start_picture(s, frame_num, idr, nal_ref, poc_lsb);
      stats[CONSTRAINED_INTRA] += p.constrained_intra;
      stats[CROPPED] += s.crop_right || s.crop_bottom || s.crop_top;
    } else {
      if (frame_num != cur_frame_num || idr != cur_idr || (nal_ref != 0) != (cur_nal_ref != 0))
        fail("slices of different pictures in one packet");
      if (first_mb != next_mb) unsupported("arbitrary slice order (ASO)");
      if (!s.same_geometry(active)) unsupported("a size change within the stream");
    }
    if (first_mb >= mb_w * mb_h) fail("first_mb_in_slice past the picture");
    stats[SLICES]++;
    stats[P_PICTURES] += type == 0 && slices.empty();
    stats[MULTI_SLICE] += slices.size() == 1;
    stats[DEBLOCK_OFFSETS] += info.deblock_idc == 0 && (info.alpha_offset || info.beta_offset);
    stats[DEBLOCK_OFF] += info.deblock_idc == 1;
    slice_num = (int)slices.size();
    slices.push_back(info);
    slice_type = type;
    qp = qp0;
    num_ref = nref;
    constrained_intra = p.constrained_intra;
    cqp_offset[0] = p.cqp_offset[0];
    cqp_offset[1] = p.cqp_offset[1];
    list0.clear();
    if (type == 0) {
      if (refs.empty()) fail("a P slice without a reference picture");
      // short-term references by descending PicNum (FrameNumWrap)
      int max_frame_num = 1 << s.log2_max_frame_num;
      std::vector<std::pair<int, std::shared_ptr<Picture>>> order;
      for (auto& pic : refs) {
        int wrap = pic->frame_num > frame_num ? pic->frame_num - max_frame_num : pic->frame_num;
        order.emplace_back(wrap, pic);
      }
      std::stable_sort(order.begin(), order.end(),
                       [](const auto& a, const auto& c) { return a.first > c.first; });
      for (int i = 0; i < nref; i++) list0.push_back(i < (int)order.size() ? order[i].second : nullptr);
    }

    // slice data
    int mb = first_mb, total = mb_w * mb_h;
    bool more = true;
    while (more) {
      if (type == 0) {
        int run = b.ue_max((uint32_t)(total - mb), "mb_skip_run");
        for (int i = 0; i < run; i++, mb++) skip_mb(mb % mb_w, mb / mb_w);
        if (run > 0) more = b.more_data();
      }
      if (more) {
        if (mb >= total) fail("slice data past the picture's last macroblock");
        macroblock(b, mb % mb_w, mb / mb_w);
        mb++;
        more = b.more_data();
      }
    }
    next_mb = mb;
  }

  // The picture's end: every macroblock decoded, filtered, marked.
  void finish_picture() {
    if (next_mb != mb_w * mb_h)
      fail("a picture of " + std::to_string(next_mb) + " of " + std::to_string(mb_w * mb_h) +
           " macroblocks");
    for (int my = 0; my < mb_h; my++)
      for (int mx = 0; mx < mb_w; mx++) deblock_mb(mx, my);
    order = next_order;
    if (cur_idr) {
      refs.clear();
      prev_ref_frame_num = 0;
    }
    if (cur_nal_ref) {
      if (!cur_idr && (int)refs.size() >= std::max(active.max_refs, 1)) {
        // sliding window: the short-term reference of the smallest FrameNumWrap goes
        int max_frame_num = 1 << active.log2_max_frame_num;
        auto wrap = [&](const Picture& p) {
          return p.frame_num > cur_frame_num ? p.frame_num - max_frame_num : p.frame_num;
        };
        auto oldest = std::min_element(refs.begin(), refs.end(), [&](const auto& a, const auto& c) {
          return wrap(*a) < wrap(*c);
        });
        refs.erase(oldest);
      }
      refs.push_back(cur);
      prev_ref_frame_num = cur_frame_num;
    }
    out = cur;
    cur.reset();
  }

  // One access unit. 0: a frame, 1: parameter sets or SEI only.
  int decode(const uint8_t* data, size_t n) {
    std::vector<std::pair<const uint8_t*, size_t>> nals;
    if (nal_length) {
      size_t i = 0;
      while (i < n) {
        if (i + nal_length > n) fail("a truncated NAL length");
        size_t len = 0;
        for (int k = 0; k < nal_length; k++) len = (len << 8) | data[i + k];
        i += nal_length;
        if (len > n - i) fail("a NAL unit past the end of its packet");
        if (len) nals.emplace_back(data + i, len);
        i += len;
      }
    } else {
      size_t i = 0, start = SIZE_MAX;
      while (i + 3 <= n) {
        if (data[i] == 0 && data[i + 1] == 0 && data[i + 2] == 1) {
          if (start != SIZE_MAX) nals.emplace_back(data + start, i - start);
          i += 3;
          start = i;
        } else {
          i++;
        }
      }
      if (start == SIZE_MAX) fail("a packet without an Annex B start code");
      nals.emplace_back(data + start, n - start);
      for (auto& nal : nals)  // trailing zeros belong to the next start code
        while (nal.second > 0 && nal.first[nal.second - 1] == 0) nal.second--;
    }
    cur.reset();
    bool frame = false;
    for (auto& nal : nals) {
      if (nal.second == 0) continue;
      uint8_t head = nal.first[0];
      if (head & 0x80) fail("a NAL unit with forbidden_zero_bit set");
      int ref_idc = head >> 5 & 3, type = head & 31;
      if (type == 2 || type == 3 || type == 4) unsupported("data partitioning");
      if (type != 1 && type != 5 && type != 6 && type != 7 && type != 8) continue;
      std::vector<uint8_t> r = unescape(nal.first + 1, nal.second - 1);
      if (type == 7) {
        parse_sps(r);
      } else if (type == 8) {
        parse_pps(r);
      } else if (type == 6) {
        parse_sei(r);
      } else {
        slice(r, type, ref_idc);
        frame = true;
      }
    }
    if (!frame) return 1;
    finish_picture();
    return 0;
  }

  // avcC: its NAL length size and parameter sets.
  void config(const uint8_t* d, size_t n) {
    if (n < 7 || d[0] != 1) fail("an avcC box that is not version 1");
    int len = (d[4] & 3) + 1;
    if (len == 3) fail("an avcC NAL length size of 3");
    size_t i = 6;
    int count = d[5] & 31;
    for (int pass = 0; pass < 2; pass++) {
      for (int k = 0; k < count; k++) {
        if (i + 2 > n) fail("a truncated avcC box");
        size_t sz = (size_t)d[i] << 8 | d[i + 1];
        i += 2;
        if (sz == 0 || i + sz > n) fail("a truncated avcC box");
        int type = d[i] & 31;
        if (d[i] & 0x80) fail("an avcC parameter set with forbidden_zero_bit set");
        std::vector<uint8_t> r = unescape(d + i + 1, sz - 1);
        if (pass == 0 && type == 7) parse_sps(r);
        else if (pass == 1 && type == 8) parse_pps(r);
        else fail("an avcC parameter set of NAL type " + std::to_string(type));
        i += sz;
      }
      if (pass == 0) {
        if (i >= n) fail("a truncated avcC box");
        count = d[i++];
      }
    }
    nal_length = len;
  }

  // The last frame cropped: RGB and luma, either may be null.
  void output(uint8_t* rgb, uint8_t* luma) const {
    int w = width - active.crop_left - active.crop_right;
    int h = height - active.crop_top - active.crop_bottom;
    const uint8_t* Y = out->plane[0].data() + (size_t)active.crop_top * stride[0];
    const uint8_t* U = out->plane[1].data() + (size_t)(active.crop_top / 2) * stride[1];
    const uint8_t* V = out->plane[2].data() + (size_t)(active.crop_top / 2) * stride[2];
    if (luma)
      for (int r = 0; r < h; r++) memcpy(luma + (size_t)r * w, Y + (size_t)r * stride[0], w);
    if (rgb) yuv::yuv420_to_rgb(Y, stride[0], U, V, stride[1], w, h, rgb, *coeffs);
  }

  void planes(uint8_t* y, uint8_t* u, uint8_t* v) const {
    int w = width - active.crop_left - active.crop_right;
    int h = height - active.crop_top - active.crop_bottom;
    int cw = (w + 1) / 2, ch = (h + 1) / 2;
    for (int r = 0; r < h; r++)
      memcpy(y + (size_t)r * w, out->plane[0].data() + (size_t)(active.crop_top + r) * stride[0], w);
    for (int r = 0; r < ch; r++) {
      memcpy(u + (size_t)r * cw, out->plane[1].data() + (size_t)(active.crop_top / 2 + r) * stride[1], cw);
      memcpy(v + (size_t)r * cw, out->plane[2].data() + (size_t)(active.crop_top / 2 + r) * stride[2], cw);
    }
  }
};

int report(const CodecError& e, char* err, size_t err_len) {
  if (err && err_len) snprintf(err, err_len, "%s", e.msg.c_str());
  return e.unsupported ? -2 : -1;
}

}  // namespace

extern "C" {

void* h264_new() { return new Decoder(); }

void h264_free(void* h) { delete static_cast<Decoder*>(h); }

// An MP4's avcC: the NAL length size of the packets to come, and the SPS and
// PPS it holds. Without it, packets are Annex B.
int h264_config(void* h, const uint8_t* data, size_t size, char* err, size_t err_len) {
  try {
    static_cast<Decoder*>(h)->config(data, size);
    return 0;
  } catch (const CodecError& e) {
    return report(e, err, err_len);
  } catch (const std::bad_alloc&) {
    return report(CodecError{"out of memory", false}, err, err_len);
  }
}

// Decode one access unit: 0 when it gave a frame, 1 when it held parameter
// sets or SEI only.
int h264_decode(void* h, const uint8_t* data, size_t size, char* err, size_t err_len) {
  try {
    return static_cast<Decoder*>(h)->decode(data, size);
  } catch (const CodecError& e) {
    static_cast<Decoder*>(h)->cur.reset();
    return report(e, err, err_len);
  } catch (const std::bad_alloc&) {
    static_cast<Decoder*>(h)->cur.reset();
    return report(CodecError{"out of memory", false}, err, err_len);
  }
}

// The output size (cropped), 0 x 0 before the first picture; the encoder's
// SEI user data, if any.
int h264_info(void* h, int* height, int* width, char* encoder, size_t encoder_len) {
  const Decoder* d = static_cast<Decoder*>(h);
  *height = d->started ? d->height - d->active.crop_top - d->active.crop_bottom : 0;
  *width = d->started ? d->width - d->active.crop_left - d->active.crop_right : 0;
  if (encoder && encoder_len) snprintf(encoder, encoder_len, "%s", d->encoder.c_str());
  return 0;
}

// The counts of Decoder::stats, at most n of them; returns how many there are.
int h264_stats(void* h, int64_t* out, int n) {
  const Decoder* d = static_cast<Decoder*>(h);
  for (int i = 0; i < std::min(n, (int)Decoder::N_STATS); i++) out[i] = d->stats[i];
  return Decoder::N_STATS;
}

// The last decoded frame: uint8 RGB [H, W, 3] and luma [H, W] (either may
// be null); -1 before the first frame.
int h264_frame(void* h, uint8_t* rgb, uint8_t* luma, char* err, size_t err_len) {
  const Decoder* d = static_cast<Decoder*>(h);
  if (!d->out) return report(CodecError{"no decoded frame", false}, err, err_len);
  d->output(rgb, luma);
  return 0;
}

// The last decoded frame's planes: Y [H, W], U and V [(H + 1) / 2, (W + 1) / 2];
// -1 before the first frame.
int h264_planes(void* h, uint8_t* y, uint8_t* u, uint8_t* v, char* err, size_t err_len) {
  const Decoder* d = static_cast<Decoder*>(h);
  if (!d->out) return report(CodecError{"no decoded frame", false}, err, err_len);
  d->planes(y, u, v);
  return 0;
}

}  // extern "C"
