// Host H.264 (ITU-T H.264 | ISO/IEC 14496-10) video decoder of the port, in
// plain C++ with a C interface (loaded with ctypes, which releases the
// interpreter lock around each call). It decodes the 8-bit 4:2:0
// progressive streams of the Constrained Baseline, Main and High profiles
// that phones, webcams and libx264 at its defaults write, as FFmpeg's h264
// decoder decodes them (the standard's decoding is exact, so its output is
// too):
//   * NAL units length-prefixed (an MP4's avcC: 1, 2 or 4 bytes) or in
//     Annex B, emulation-prevention bytes removed; SPS (POC types 0 and 2,
//     frame cropping, scaling lists, the VUI's colour matrix and bitstream
//     restriction), PPS, SEI user data (the encoder's name);
//   * CAVLC and CABAC (h264_cabac.h: every cabac_init_idc) I, P and B
//     slices, several a picture; I_NxN with the nine 4x4 or 8x8 modes (the
//     8x8 reference samples filtered), I_16x16 with its four modes and the
//     luma DC Hadamard, the four chroma modes with the 2x2 chroma DC; P and
//     B partitions down to 8x8, P sub-partitions down to 4x4, P_8x8ref0,
//     P_Skip, B_Skip, B_Direct_16x16 and B_Direct_8x8 (spatial and temporal
//     direct prediction, direct_8x8_inference), intra macroblocks in P and
//     B slices, constrained intra prediction;
//   * median and directional motion-vector prediction by list; the initial
//     P list by descending PicNum and the B lists by POC, list modification
//     of short-term pictures, the sliding window and MMCO op 1; quarter-
//     sample luma (the 6-tap filter) and eighth-sample chroma prediction
//     from a reference read clamped to its edges; bi-prediction with the
//     default, implicit (weighted_bipred_idc 2) and explicit P weights;
//   * the 4x4 and 8x8 inverse transforms with the scaling lists (Flat_16,
//     the defaults, sent lists under fall-back rules A and B), mb_qp_delta,
//     the chroma QP table and second_chroma_qp_index_offset; the in-loop
//     deblocking filter (bS 0-4 with both lists' motion, no inner 4x4 edges
//     under the 8x8 transform, the slice's alpha and beta offsets,
//     disable_deblocking_filter_idc 0 and 1), run on the whole picture once
//     its macroblocks are reconstructed;
//   * output in POC order as FFmpeg gives it: a picture waits until more
//     than the VUI's max_num_reorder_frames wait (none without the
//     restriction), every waiting picture goes at an IDR picture and at
//     h264_flush; cropped by the SPS; RGB as OpenCV converts it: swscale's
//     yuv420p to bgr24 (yuv_rgb.h) with the table of the VUI's matrix
//     (BT.601, BT.709, FCC, SMPTE 240M, BT.2020), limited range.
// Refused with a message (-2) that names the tool: SP/SI slices, field and
// MBAFF coding, slice groups (FMO), arbitrary slice order, redundant
// pictures, data partitioning, chroma other than 4:2:0, bit depth above 8,
// lossless, I_PCM, POC type 1, long-term references (and MMCO 2-4, 6,
// modification_of_pic_nums_idc 2), MMCO 5, explicit weighted
// bi-prediction, B partitions below 8x8, direct_8x8_inference_flag 0 in B
// slices, gaps in frame_num, disable_deblocking_filter_idc 2, cropping
// from the left, a VUI matrix OpenCV does not convert by (RGB, YCgCo,
// reserved), a POC out of decode order without the VUI's bitstream
// restriction (FFmpeg guesses the reorder depth of such a stream), a size
// change within the stream, a stream that does not start with an IDR
// picture, several pictures in one packet. A truncated or corrupt stream
// fails (-1): every bit read, every CABAC context index and every table
// index is bounds-checked, and a picture whose slices do not cover it is
// not output.
//
// Every entry point returns 0 on success (h264_decode and h264_flush: the
// number of frames made ready), else -1 (a broken stream) or -2 (a valid
// one that is not supported) with a message in err. The decoder keeps its
// reference frames between calls.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <memory>
#include <string>
#include <vector>

#include "h264_cabac.h"
#include "yuv_rgb.h"

namespace {

using h264::kDefault4x4;
using h264::kDefault8x8;

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

// The 8x8 inverse transform (8.5.13) of coefficients d (raster), added to
// the 8x8 block at dst.
void idct8_add(const int* d, uint8_t* dst, int stride) {
  auto pass = [](const int* in, int step, int* o, int ostep) {
    int d0 = in[0], d1 = in[step], d2 = in[2 * step], d3 = in[3 * step];
    int d4 = in[4 * step], d5 = in[5 * step], d6 = in[6 * step], d7 = in[7 * step];
    int a0 = d0 + d4, a4 = d0 - d4, a2 = (d2 >> 1) - d6, a6 = d2 + (d6 >> 1);
    int b0 = a0 + a6, b2 = a4 + a2, b4 = a4 - a2, b6 = a0 - a6;
    int a1 = -d3 + d5 - d7 - (d7 >> 1), a3 = d1 + d7 - d3 - (d3 >> 1);
    int a5 = -d1 + d7 + d5 + (d5 >> 1), a7 = d3 + d5 + d1 + (d1 >> 1);
    int b1 = a1 + (a7 >> 2), b7 = a7 - (a1 >> 2), b3 = a3 + (a5 >> 2), b5 = (a3 >> 2) - a5;
    o[0] = b0 + b7;
    o[ostep] = b2 + b5;
    o[2 * ostep] = b4 + b3;
    o[3 * ostep] = b6 + b1;
    o[4 * ostep] = b6 - b1;
    o[5 * ostep] = b4 - b3;
    o[6 * ostep] = b2 - b5;
    o[7 * ostep] = b0 - b7;
  };
  int t[64], out[64];
  for (int i = 0; i < 8; i++) pass(d + 8 * i, 1, t + 8 * i, 1);  // rows
  for (int j = 0; j < 8; j++) pass(t + j, 8, out + j, 8);        // columns
  for (int i = 0; i < 8; i++)
    for (int j = 0; j < 8; j++) {
      uint8_t* p = dst + (size_t)i * stride + j;
      *p = clip1(*p + ((out[8 * i + j] + 32) >> 6));
    }
}

// normAdjust8x8 (8-318) by QP % 6 and position class
const int kDequant8[6][6] = {{20, 18, 32, 19, 25, 24}, {22, 19, 35, 21, 28, 26},
                             {26, 23, 42, 24, 33, 31}, {28, 25, 45, 26, 35, 33},
                             {32, 28, 51, 30, 40, 38}, {36, 32, 58, 34, 46, 43}};

int norm8_class(int i, int j) {
  if (i % 4 == 0 && j % 4 == 0) return 0;
  if (i % 2 == 1 && j % 2 == 1) return 1;
  if (i % 4 == 2 && j % 4 == 2) return 2;
  if ((i % 4 == 0 && j % 2 == 1) || (i % 2 == 1 && j % 4 == 0)) return 3;
  if ((i % 4 == 0 && j % 4 == 2) || (i % 4 == 2 && j % 4 == 0)) return 4;
  return 5;
}

// ------------------------------------------------------------ parameter sets

// Scaling lists in zig-zag order: six 4x4 (Intra Y, Cb, Cr, Inter Y, Cb,
// Cr) and two 8x8 (Intra Y, Inter Y), as a parameter set sends them.
struct ScalingLists {
  bool present = false;  // seq_ or pic_scaling_matrix_present_flag
  bool sent[8] = {};     // ..._scaling_list_present_flag
  bool use_default[8] = {};
  uint8_t list4[6][16];
  uint8_t list8[2][64];
};

// scaling_list() (7.3.2.1.1.1): true when it asks for the default list
bool read_scaling_list(Bits& b, uint8_t* list, int n) {
  int last = 8, next = 8;
  for (int j = 0; j < n; j++) {
    if (next != 0) {
      int delta = b.se_range(-128, 127, "delta_scale");
      next = (last + delta + 256) % 256;
      if (j == 0 && next == 0) return true;
    }
    list[j] = (uint8_t)(next == 0 ? last : next);
    last = list[j];
  }
  return false;
}

void read_scaling_lists(Bits& b, ScalingLists& s, int count) {
  s.present = true;
  for (int i = 0; i < count; i++) {
    s.sent[i] = b.get1();
    if (s.sent[i])
      s.use_default[i] = i < 6 ? read_scaling_list(b, s.list4[i], 16)
                               : read_scaling_list(b, s.list8[i - 6], 64);
  }
}

// The lists in force (zig-zag order): Flat_16 without lists, else the sent
// ones with fall-back rule A (the defaults; `seq` null) or B (a picture's
// lists: the sequence's lists `seq`), Table 7-2.
void resolve_scaling(const ScalingLists& s, const ScalingLists* seq, uint8_t list4[6][16],
                     uint8_t list8[2][64]) {
  if (!s.present) {
    memset(list4, 16, 6 * 16);
    memset(list8, 16, 2 * 64);
    return;
  }
  for (int i = 0; i < 6; i++) {
    const uint8_t* src;
    if (!s.sent[i]) {
      if (i == 0 || i == 3) src = seq ? seq->list4[i] : kDefault4x4[i / 3];
      else src = list4[i - 1];
    } else {
      src = s.use_default[i] ? kDefault4x4[i / 3] : s.list4[i];
    }
    memmove(list4[i], src, 16);
  }
  for (int i = 0; i < 2; i++) {
    const uint8_t* src;
    if (!s.sent[6 + i]) src = seq ? seq->list8[i] : kDefault8x8[i];
    else src = s.use_default[6 + i] ? kDefault8x8[i] : s.list8[i];
    memmove(list8[i], src, 64);
  }
}

struct Sps {
  bool valid = false;
  std::string refuse;  // a tool the decoder does not take, named
  int log2_max_frame_num = 4, poc_type = 0, log2_max_poc_lsb = 4, max_refs = 0;
  int mb_w = 0, mb_h = 0;
  int crop_left = 0, crop_right = 0, crop_top = 0, crop_bottom = 0;  // luma samples
  bool direct_8x8_inference = true;
  bool colour_description = false;
  int matrix = 2;            // the VUI's matrix_coefficients
  bool restriction = false;  // the VUI's bitstream_restriction_flag
  int reorder = 0;           // its max_num_reorder_frames
  ScalingLists scaling;      // as sent
  ScalingLists lists;        // in force: the fall-back of a picture's lists
  bool same_geometry(const Sps& o) const {
    return mb_w == o.mb_w && mb_h == o.mb_h && crop_left == o.crop_left &&
           crop_right == o.crop_right && crop_top == o.crop_top && crop_bottom == o.crop_bottom;
  }
};

struct Pps {
  bool valid = false;
  std::string refuse;
  int sps_id = 0;
  bool cabac = false, bottom_field_poc = false;
  int num_ref_default[2] = {1, 1};
  bool weighted_pred = false;
  int bipred_idc = 0;
  int init_qp = 26;
  int cqp_offset[2] = {0, 0};
  bool deblock_control = false, constrained_intra = false, transform_8x8 = false;
  ScalingLists scaling;
};

// ---------------------------------------------------------------- pictures

// The motion of a macroblock that direct prediction reads from the
// co-located picture: the corner 4x4 block of each 8x8 block
// (direct_8x8_inference_flag 1), by list.
struct ColMb {
  bool intra = true;
  int8_t ref[2][4];
  int16_t mv[2][4][2];
  int32_t pic[2][4];
};

struct Picture {
  std::vector<uint8_t> plane[3];
  int frame_num = 0, poc = 0;
  int id = 0;          // unique: references are told apart by it
  int64_t seq = 0;     // decode order
  int64_t packet = 0;  // the h264_decode call that gave it
  std::vector<ColMb> col;
};

enum MbKind : int8_t { MB_I4, MB_I16, MB_P, MB_SKIP, MB_I8 };

struct MbInfo {
  int8_t kind = MB_SKIP;  // MB_P: every inter macroblock but P_Skip and B_Skip
  int8_t qp = 0;
  int16_t slice = -1;     // the slice of the picture that holds it, -1 not yet decoded
  bool t8 = false;        // transform_size_8x8_flag
  bool direct16 = false;  // B_Skip or B_Direct_16x16
  uint8_t cbp = 0;        // coded_block_pattern: luma bits 0-3, chroma in bits 4-5
  int8_t chroma_mode = 0; // intra_chroma_pred_mode
  uint16_t cbf = 0;       // CABAC's coded_block_flag of each luma 4x4 block, raster
  uint8_t cbf_dc = 0;     // ... of the luma DC (bit 0), the Cb and Cr DC (bits 1, 2)
  uint8_t cbf_ac[2] = {0, 0};  // ... of each chroma AC block, raster
  uint16_t direct = 0;    // luma 4x4 blocks of direct prediction, raster
  uint16_t nonzero = 0;   // luma 4x4 blocks with coefficients (by 8x8 block
                          // under the 8x8 transform): the deblocking filter's bS 2
  uint8_t nz[16];         // TotalCoeff of each luma 4x4 block, raster (I_16x16: AC)
  uint8_t nzc[2][4];      // TotalCoeff of each chroma AC block, raster
  int8_t mode[16];        // Intra4x4PredMode / Intra8x8PredMode, raster
  int8_t ref[2][16];      // ref_idx by list, -1 unused or intra
  int16_t mv[2][16][2];
  uint8_t mvd[2][16][2];  // |mvd|, at most 64: CABAC's contexts
  int32_t pic[2][16];     // Picture::id of the reference, -1 unused or intra
};

struct SliceInfo {
  int deblock_idc = 0, alpha_offset = 0, beta_offset = 0;
  int cqp_offset[2] = {0, 0};
  bool b = false;  // a B slice: the filter compares motion of both lists
};

inline bool is_intra(const MbInfo& m) {
  return m.kind == MB_I4 || m.kind == MB_I16 || m.kind == MB_I8;
}

// Decode-order index of the luma 4x4 block at (x, y) of a macroblock.
inline int blk_index(int x, int y) { return (y >> 1) * 8 + (x >> 1) * 4 + (y & 1) * 2 + (x & 1); }
// ... and the raster position of decode-order block k
inline int blk_x(int k) { return (k & 1) + ((k >> 2) & 1) * 2; }
inline int blk_y(int k) { return ((k >> 1) & 1) + (k >> 3) * 2; }

// The corner 4x4 block (raster) of each 8x8 block: direct_8x8_inference.
const int kCorner[4] = {0, 3, 12, 15};

// B macroblock types 1-21 (Table 7-14): shape (0 16x16, 1 16x8, 2 8x16)
// and each partition's prediction (1 L0, 2 L1, 3 both)
const uint8_t kBType[22][3] = {
    {0, 0, 0}, {0, 1, 0}, {0, 2, 0}, {0, 3, 0}, {1, 1, 1}, {2, 1, 1}, {1, 2, 2}, {2, 2, 2},
    {1, 1, 2}, {2, 1, 2}, {1, 2, 1}, {2, 2, 1}, {1, 1, 3}, {2, 1, 3}, {1, 2, 3}, {2, 2, 3},
    {1, 3, 1}, {2, 3, 1}, {1, 3, 2}, {2, 3, 2}, {1, 3, 3}, {2, 3, 3}};

inline int min_positive(int a, int b) { return a >= 0 && b >= 0 ? std::min(a, b) : std::max(a, b); }

// ---------------------------------------------------------------- decoder

struct Decoder {
  // what the decoded pictures held (h264_stats): IDR pictures, pictures
  // with P slices, slices, pictures of several slices, I_NxN (4x4),
  // I_16x16, intra macroblocks of P slices, inter and skipped macroblocks,
  // P_8x8 macroblocks, sub-macroblock partitions smaller than 8x8,
  // partitions with ref_idx above 0, macroblocks with a nonzero
  // mb_qp_delta, level codes with level_prefix 14 or more, luma predictions
  // at a fractional position, predictions read partly outside the picture,
  // luma edge segments filtered with bS 4 and with bS 1-3, slices with
  // deblocking offsets, slices with the filter off, pictures with
  // constrained intra prediction, cropped pictures; then pictures with B
  // slices, CABAC slices (I slices, P and B slices by cabac_init_idc 0-2),
  // macroblocks with spatial and temporal direct prediction, bi-predicted
  // partitions, macroblocks of the 8x8 transform, I_NxN of intra 8x8,
  // partitions predicted with explicit weights and with implicit weights
  // other than 32/32, reference list modifications, MMCO operations,
  // pictures under scaling lists other than Flat_16, frames output after a
  // frame decoded later (reordered output)
  enum { IDR, P_PICTURES, SLICES, MULTI_SLICE, I4X4, I16X16, P_INTRA, INTER, SKIPPED, P8X8,
         SMALL_PARTS, REF_ABOVE_0, QP_DELTA, LEVEL_ESCAPES, FRACTIONAL, OUTSIDE, BS4, BS_LT4,
         DEBLOCK_OFFSETS, DEBLOCK_OFF, CONSTRAINED_INTRA, CROPPED, B_PICTURES, CABAC_I,
         CABAC_IDC0, CABAC_IDC1, CABAC_IDC2, SPATIAL_DIRECT, TEMPORAL_DIRECT, BIPRED, T8X8, I8X8,
         EXPLICIT_WEIGHTED, IMPLICIT_WEIGHTED, LIST_MODIFICATIONS, MMCO_OPS, SCALING_PICTURES,
         REORDERED, N_STATS };
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

  // short-term references; decoded pictures waiting for output (decode
  // order); frames ready for output (output order) and the one taken last
  std::vector<std::shared_ptr<Picture>> refs, waiting;
  std::deque<std::shared_ptr<Picture>> ready;
  std::shared_ptr<Picture> out;
  int64_t packets = 0, next_seq = 0, max_seq_out = -1;
  bool have_out_poc = false;
  int last_out_poc = 0;
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
  bool marking_adaptive = false;  // its dec_ref_pic_marking: MMCO op 1's picNumX
  std::vector<int> unmark;

  // the slice being decoded
  int slice_num = 0, slice_type = 0, qp = 0;
  int num_ref[2] = {1, 1};
  bool cabac = false, constrained_intra = false, transform_8x8 = false, direct_spatial = true;
  int cqp_offset[2] = {0, 0};
  std::vector<std::shared_ptr<Picture>> list[2];
  int weight_mode = 0;  // 0 none, 1 explicit (P), 2 implicit (B)
  int luma_denom = 0, chroma_denom = 0;
  int lw[32][2], cw[32][2][2];  // explicit (weight, offset): luma, Cb and Cr by ref_idx
  bool wflag[32];               // a ref_idx with a luma or chroma weight sent
  int iw[32][32];               // implicit w1 by (ref_idx_l0, ref_idx_l1); w0 = 64 - w1
  int dsf[32];                  // temporal direct's DistScaleFactor by ref_idx_l0, 256: mvCol
  int ls4[6][6][16], ls8[2][6][64];  // LevelScale by list, QP % 6, raster position
  h264::Cabac cab;
  int last_dqp = 0;  // mb_qp_delta of the last macroblock (CABAC's context)

  // ---------------------------------------------------------- headers

  static void skip_hrd(Bits& b) {
    int count = b.ue_max(31, "cpb_cnt_minus1") + 1;
    b.get(8);  // bit_rate_scale, cpb_size_scale
    for (int i = 0; i < count; i++) {
      b.ue();
      b.ue();
      b.get(1);
    }
    b.get(20);  // the four delay and offset lengths
  }

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
      if (b.get1()) read_scaling_lists(b, s.scaling, 8);
    }
    resolve_scaling(s.scaling, nullptr, s.lists.list4, s.lists.list8);
    s.log2_max_frame_num = b.ue_max(12, "log2_max_frame_num_minus4") + 4;
    s.poc_type = b.ue_max(2, "pic_order_cnt_type");
    if (s.poc_type == 1) return refuse("pic_order_cnt_type 1");
    if (s.poc_type == 0) s.log2_max_poc_lsb = b.ue_max(12, "log2_max_pic_order_cnt_lsb_minus4") + 4;
    s.max_refs = b.ue_max(16, "max_num_ref_frames");
    b.get(1);  // gaps_in_frame_num_value_allowed_flag: gaps are refused where met
    s.mb_w = b.ue_max(1023, "pic_width_in_mbs_minus1") + 1;
    s.mb_h = b.ue_max(1023, "pic_height_in_map_units_minus1") + 1;
    if (!b.get1()) return refuse("field and MBAFF coding (frame_mbs_only_flag 0: interlaced video)");
    s.direct_8x8_inference = b.get1();
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
      // What follows matters for the output order only: a VUI cut short
      // there (FFmpeg reads on as far as it goes) leaves the stream
      // without a bitstream restriction.
      try {
        if (b.get1()) {  // chroma location
          b.ue();
          b.ue();
        }
        if (b.get1()) b.get(32), b.get(32), b.get(1);  // timing
        bool nal_hrd = b.get1();
        if (nal_hrd) skip_hrd(b);
        bool vcl_hrd = b.get1();
        if (vcl_hrd) skip_hrd(b);
        if (nal_hrd || vcl_hrd) b.get(1);  // low_delay_hrd_flag
        b.get(1);                          // pic_struct_present_flag
        if (b.get1()) {                    // bitstream_restriction_flag
          b.get(1);
          b.ue();
          b.ue();
          b.ue();
          b.ue();
          int reorder = (int)b.ue(), buffering = (int)b.ue();
          if (reorder > 16 || reorder > std::max(buffering, 1))
            fail("a max_num_reorder_frames of " + std::to_string(reorder) + " past the DPB");
          s.restriction = true;
          s.reorder = reorder;
        }
      } catch (const CodecError& e) {
        if (e.unsupported || e.msg.find("truncated") == std::string::npos) throw;
        s.restriction = false;
        s.reorder = 0;
      }
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
    p.cabac = b.get1();
    p.bottom_field_poc = b.get1();
    if (b.ue_max(7, "num_slice_groups_minus1") > 0) return refuse("slice groups (FMO)");
    p.num_ref_default[0] = b.ue_max(31, "num_ref_idx_l0_default_active_minus1") + 1;
    p.num_ref_default[1] = b.ue_max(31, "num_ref_idx_l1_default_active_minus1") + 1;
    p.weighted_pred = b.get1();
    p.bipred_idc = (int)b.get(2);
    if (p.bipred_idc == 3) fail("weighted_bipred_idc 3");
    p.init_qp = 26 + b.se_range(-26, 25, "pic_init_qp_minus26");
    b.se_range(-26, 25, "pic_init_qs_minus26");
    p.cqp_offset[0] = p.cqp_offset[1] = b.se_range(-12, 12, "chroma_qp_index_offset");
    p.deblock_control = b.get1();
    p.constrained_intra = b.get1();
    if (b.get1()) return refuse("redundant pictures (redundant_pic_cnt_present_flag 1)");
    if (b.more_data()) {
      p.transform_8x8 = b.get1();
      if (b.get1()) read_scaling_lists(b, p.scaling, 6 + 2 * p.transform_8x8);
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

  // LevelScale4x4 and LevelScale8x8 (8.5.9) of the slice's scaling lists.
  // A picture's lists fall back (rule B) to the sequence's where the SPS
  // sends lists, else to the default lists as FFmpeg does (the standard's
  // Flat_16; libx264 sends its lists in the PPS alone, meaning the
  // defaults).
  void level_scales(const Sps& s, const Pps& p) {
    uint8_t list4[6][16], list8[2][64];
    if (p.scaling.present) resolve_scaling(p.scaling, s.scaling.present ? &s.lists : nullptr, list4, list8);
    else {
      memcpy(list4, s.lists.list4, sizeof list4);
      memcpy(list8, s.lists.list8, sizeof list8);
    }
    for (int l = 0; l < 6; l++)
      for (int q = 0; q < 6; q++)
        for (int k = 0; k < 16; k++) {
          int pos = kZigzag[k], i = pos >> 2, j = pos & 3;
          int cls = (i & 1) == 0 && (j & 1) == 0 ? 0 : (i & 1) && (j & 1) ? 1 : 2;
          ls4[l][q][pos] = list4[l][k] * kDequant[q][cls];
        }
    for (int l = 0; l < 2; l++)
      for (int q = 0; q < 6; q++)
        for (int k = 0; k < 64; k++) {
          int pos = h264::kZigzag8x8[k];
          ls8[l][q][pos] = list8[l][k] * kDequant8[q][norm8_class(pos >> 3, pos & 7)];
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
  // The macroblock holding the 4x4 block (x4, y4) (-1..3 from the current
  // macroblock's corner, left or above only) and the block's raster index;
  // null when it is not available.
  const MbInfo* block_at(int mx, int my, const MbInfo& m, int x4, int y4, int& k) {
    if (x4 >= 0 && y4 >= 0) {
      k = y4 * 4 + x4;
      return &m;
    }
    k = (y4 & 3) * 4 + (x4 & 3);
    return x4 < 0 ? avail(mx - 1, my) : avail(mx, my - 1);
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

  static int checked(int64_t d) {
    if (d > 32767 || d < -32768) fail("a dequantised coefficient out of range");
    return (int)d;
  }
  // dequantised 4x4 coefficient of level c at raster position `pos`, QP q,
  // scaling list `l` (8.5.12.1)
  int dequant(int c, int pos, int q, int l) const {
    int64_t v = (int64_t)c * ls4[l][q % 6][pos];
    return checked(q >= 24 ? v * (1 << (q / 6 - 4)) : (v + (1 << (3 - q / 6))) >> (4 - q / 6));
  }
  // ... of an 8x8 block (8.5.13.1)
  int dequant8(int c, int pos, int q, int l) const {
    int64_t v = (int64_t)c * ls8[l][q % 6][pos];
    return checked(q >= 36 ? v * (1 << (q / 6 - 6)) : (v + (1 << (5 - q / 6))) >> (6 - q / 6));
  }

  // ---------------------------------------------------------- CABAC

  int ctx_skip(int mx, int my) {
    const MbInfo *a = avail(mx - 1, my), *b = avail(mx, my - 1);
    return (a && a->kind != MB_SKIP) + (b && b->kind != MB_SKIP);
  }

  // mb_type of an I macroblock (0 I_NxN, 1-24 I_16x16, 25 I_PCM): the
  // prefix of I slices at ctxIdx 3, else the suffix at `base`
  int cabac_mb_type_i(int mx, int my, int base, bool islice) {
    if (islice) {
      const MbInfo *a = avail(mx - 1, my), *b = avail(mx, my - 1);
      int inc = (a && a->kind == MB_I16) + (b && b->kind == MB_I16);
      if (!cab.decision(3 + inc)) return 0;
      if (cab.terminate()) return 25;
      int t = 1 + 12 * cab.decision(6);
      if (cab.decision(7)) t += 4 + 4 * cab.decision(8);
      t += 2 * cab.decision(9);
      return t + cab.decision(10);
    }
    if (!cab.decision(base)) return 0;
    if (cab.terminate()) return 25;
    int t = 1 + 12 * cab.decision(base + 1);
    if (cab.decision(base + 2)) t += 4 + 4 * cab.decision(base + 2);
    t += 2 * cab.decision(base + 3);
    return t + cab.decision(base + 3);
  }

  int cabac_mb_type_p(int mx, int my) {
    if (!cab.decision(14)) {
      if (!cab.decision(15)) return 3 * cab.decision(16);
      return 2 - cab.decision(17);
    }
    return 5 + cabac_mb_type_i(mx, my, 17, false);
  }

  int cabac_mb_type_b(int mx, int my) {
    const MbInfo *a = avail(mx - 1, my), *b = avail(mx, my - 1);
    int inc = (a && !a->direct16) + (b && !b->direct16);
    if (!cab.decision(27 + inc)) return 0;
    if (!cab.decision(30)) return 1 + cab.decision(32);
    int bits = cab.decision(31) << 3;
    bits |= cab.decision(32) << 2;
    bits |= cab.decision(32) << 1;
    bits |= cab.decision(32);
    if (bits < 8) return bits + 3;
    if (bits == 13) return 23 + cabac_mb_type_i(mx, my, 32, false);
    if (bits == 14) return 11;
    if (bits == 15) return 22;
    bits = (bits << 1) | cab.decision(32);
    return bits - 4;
  }

  int cabac_sub_p() {
    if (cab.decision(21)) return 0;
    if (!cab.decision(22)) return 1;
    if (cab.decision(23)) return 2;
    return 3;
  }

  int cabac_sub_b() {
    if (!cab.decision(36)) return 0;
    if (!cab.decision(37)) return 1 + cab.decision(39);
    int type = 3;
    if (cab.decision(38)) {
      if (cab.decision(39)) return 11 + cab.decision(39);
      type += 4;
    }
    type += 2 * cab.decision(39);
    return type + cab.decision(39);
  }

  int cabac_ref(int mx, int my, const MbInfo& m, int l, int x4, int y4) {
    int inc = 0;
    for (int n = 0; n < 2; n++) {
      int k;
      const MbInfo* q = block_at(mx, my, m, n ? x4 : x4 - 1, n ? y4 - 1 : y4, k);
      // skipped and direct blocks count as ref_idx 0 (P_Skip's is; B's are direct)
      if (q && !((q->direct >> k) & 1) && q->ref[l][k] > 0) inc += n ? 2 : 1;
    }
    int ref = 0, ctx = 54 + inc;
    while (cab.decision(ctx)) {
      ref++;
      ctx = ref == 1 ? 58 : 59;
      if (ref >= num_ref[l]) fail("a ref_idx past the reference list");
    }
    return ref;
  }

  int cabac_mvd(int mx, int my, const MbInfo& m, int l, int comp, int x4, int y4) {
    int sum = 0;
    for (int n = 0; n < 2; n++) {
      int k;
      const MbInfo* q = block_at(mx, my, m, n ? x4 : x4 - 1, n ? y4 - 1 : y4, k);
      if (q) sum += q->mvd[l][k][comp];
    }
    int base = comp ? 47 : 40;
    if (!cab.decision(base + (sum < 3 ? 0 : sum <= 32 ? 1 : 2))) return 0;
    int v = 1, ctx = base + 3;
    while (v < 9 && cab.decision(ctx)) {
      if (v < 4) ctx++;
      v++;
    }
    if (v >= 9) {
      int k = 3;
      while (cab.bypass()) {
        v += 1 << k;
        if (++k > 24) fail("an mvd escape past 24 bits");
      }
      while (k--) v += cab.bypass() << k;
    }
    return cab.bypass() ? -v : v;
  }

  int cabac_qp_delta() {
    if (!cab.decision(60 + (last_dqp != 0))) return 0;
    int v = 1, ctx = 62;
    while (cab.decision(ctx)) {
      ctx = 63;
      if (++v > 104) fail("an mb_qp_delta out of range");
    }
    return (v & 1) ? (v + 1) >> 1 : -(v >> 1);
  }

  int cabac_chroma_mode(int mx, int my) {
    const MbInfo *a = avail(mx - 1, my), *b = avail(mx, my - 1);
    int inc = (a && is_intra(*a) && a->chroma_mode) + (b && is_intra(*b) && b->chroma_mode);
    if (!cab.decision(64 + inc)) return 0;
    if (!cab.decision(67)) return 1;
    return cab.decision(67) ? 3 : 2;
  }

  int cabac_cbp(int mx, int my) {
    const MbInfo *a = avail(mx - 1, my), *b = avail(mx, my - 1);
    // condTermFlagN of a luma 8x8 block of a neighbouring macroblock
    auto luma = [](const MbInfo* q, int b8) {
      return q && !(q->kind != MB_SKIP && ((q->cbp >> b8) & 1)) ? 1 : 0;
    };
    int cbp = 0;
    for (int b8 = 0; b8 < 4; b8++) {
      int ca = b8 & 1 ? !((cbp >> (b8 - 1)) & 1) : luma(a, b8 + 1);
      int cb = b8 & 2 ? !((cbp >> (b8 - 2)) & 1) : luma(b, b8 + 2);
      cbp |= cab.decision(73 + ca + 2 * cb) << b8;
    }
    auto chroma = [](const MbInfo* q, int least) {
      return q && q->kind != MB_SKIP && (q->cbp >> 4) >= least ? 1 : 0;
    };
    if (!cab.decision(77 + chroma(a, 1) + 2 * chroma(b, 1))) return cbp;
    return cbp | (1 + cab.decision(81 + chroma(a, 2) + 2 * chroma(b, 2))) << 4;
  }

  int cabac_t8(int mx, int my) {
    const MbInfo *a = avail(mx - 1, my), *b = avail(mx, my - 1);
    return cab.decision(399 + (a && a->t8) + (b && b->t8));
  }

  // coded_block_flag's ctxIdxInc of a luma 4x4 block (categories 1, 2),
  // a chroma AC block (4) of component c
  int cbf_luma_inc(int mx, int my, const MbInfo& m, int bx, int by, bool intra) {
    int inc = 0;
    for (int n = 0; n < 2; n++) {
      int k;
      const MbInfo* q = block_at(mx, my, m, n ? bx : bx - 1, n ? by - 1 : by, k);
      inc += (q ? (q->cbf >> k) & 1 : intra) << n;
    }
    return inc;
  }
  int cbf_ac_inc(int mx, int my, const MbInfo& m, int c, int bx, int by, bool intra) {
    int inc = 0;
    for (int n = 0; n < 2; n++) {
      int x = n ? bx : bx - 1, y = n ? by - 1 : by, f;
      if (x >= 0 && y >= 0) {
        f = (m.cbf_ac[c] >> (y * 2 + x)) & 1;
      } else {
        const MbInfo* q = x < 0 ? avail(mx - 1, my) : avail(mx, my - 1);
        f = q ? (q->cbf_ac[c] >> ((y & 1) * 2 + (x & 1))) & 1 : intra;
      }
      inc += f << n;
    }
    return inc;
  }
  // ... of the luma DC (bit 0) or a chroma DC (bits 1, 2)
  int cbf_dc_inc(int mx, int my, int bit, bool intra) {
    int inc = 0;
    for (int n = 0; n < 2; n++) {
      const MbInfo* q = n ? avail(mx, my - 1) : avail(mx - 1, my);
      inc += (q ? (q->cbf_dc >> bit) & 1 : intra) << n;
    }
    return inc;
  }

  // residual_block_cabac of category `cat` into coeff[0..max-1] (scan
  // order); coded_block_flag at ctxIdxInc `inc` (category 5 has none);
  // returns the number of nonzero coefficients.
  int cabac_block(int cat, int inc, int max, int* coeff) {
    static const int kCbf[5] = {85, 89, 93, 97, 101};
    static const int kSig[6] = {105, 120, 134, 149, 152, 402};
    static const int kLast[6] = {166, 181, 195, 210, 213, 417};
    static const int kAbs[6] = {227, 237, 247, 257, 266, 426};
    std::fill(coeff, coeff + max, 0);
    if (cat != 5 && !cab.decision(kCbf[cat] + inc)) return 0;
    int idx[64], n = 0;
    bool ended = false;
    for (int i = 0; i < max - 1; i++) {
      if (cab.decision(kSig[cat] + (cat == 5 ? h264::kSig8x8[i] : i))) {
        idx[n++] = i;
        if (cab.decision(kLast[cat] + (cat == 5 ? h264::kLast8x8[i] : i))) {
          ended = true;
          break;
        }
      }
    }
    if (!ended) idx[n++] = max - 1;
    int eq1 = 0, gt1 = 0;
    for (int j = n - 1; j >= 0; j--) {
      int abs;
      if (!cab.decision(kAbs[cat] + (gt1 ? 0 : std::min(4, 1 + eq1)))) {
        abs = 1;
        eq1++;
      } else {
        int ctx = kAbs[cat] + 5 + std::min(gt1, cat == 3 ? 3 : 4);
        abs = 2;
        while (abs < 15 && cab.decision(ctx)) abs++;
        if (abs >= 15) {
          int k = 0;
          while (cab.bypass())
            if (++k > 22) fail("a coeff_abs_level_minus1 escape past 22 bits");
          int suffix = 1;
          while (k--) suffix = 2 * suffix + cab.bypass();
          abs = suffix + 14;
        }
        gt1++;
      }
      coeff[idx[j]] = cab.bypass() ? -abs : abs;
    }
    return n;
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

  // Intra 8x8 prediction (8.3.2) of 8x8 block b8 of macroblock (mx, my),
  // from the filtered reference samples, written to the picture.
  void intra8x8(int mode, int mx, int my, int b8) {
    int bx = b8 & 1, by = b8 >> 1;
    int x = 16 * mx + 8 * bx, y = 16 * my + 8 * by;
    bool has_left = bx > 0 || intra_avail(mx - 1, my);
    bool has_top = by > 0 || intra_avail(mx, my - 1);
    bool has_tl = bx > 0 && by > 0 ? true
                  : bx > 0         ? intra_avail(mx, my - 1)
                  : by > 0         ? intra_avail(mx - 1, my)
                                   : intra_avail(mx - 1, my - 1);
    bool has_tr = b8 == 0 ? intra_avail(mx, my - 1) : b8 == 1 ? intra_avail(mx + 1, my - 1) : b8 == 2;
    static const uint8_t kNeeds[9] = {1, 2, 0, 1, 7, 7, 7, 1, 2};  // top 1, left 2, corner 4
    int needs = kNeeds[mode];
    if (((needs & 1) && !has_top) || ((needs & 2) && !has_left) || ((needs & 4) && !has_tl))
      fail("an intra 8x8 mode that reads unavailable samples");
    int T[16] = {}, L[8] = {}, TL = 0, t[16] = {}, l[8] = {}, tl = 0;
    if (has_top) {
      const uint8_t* s = luma_at(x, y - 1);
      for (int i = 0; i < 8; i++) T[i] = s[i];
      for (int i = 8; i < 16; i++) T[i] = has_tr ? s[i] : s[7];
    }
    if (has_left)
      for (int i = 0; i < 8; i++) L[i] = *luma_at(x - 1, y + i);
    if (has_tl) TL = *luma_at(x - 1, y - 1);
    if (has_top) {
      t[0] = has_tl ? (TL + 2 * T[0] + T[1] + 2) >> 2 : (3 * T[0] + T[1] + 2) >> 2;
      for (int i = 1; i < 15; i++) t[i] = (T[i - 1] + 2 * T[i] + T[i + 1] + 2) >> 2;
      t[15] = (T[14] + 3 * T[15] + 2) >> 2;
    }
    if (has_tl) {
      if (has_top && has_left) tl = (T[0] + 2 * TL + L[0] + 2) >> 2;
      else if (has_top) tl = (3 * TL + T[0] + 2) >> 2;
      else if (has_left) tl = (3 * TL + L[0] + 2) >> 2;
      else tl = TL;
    }
    if (has_left) {
      l[0] = has_tl ? (TL + 2 * L[0] + L[1] + 2) >> 2 : (3 * L[0] + L[1] + 2) >> 2;
      for (int i = 1; i < 7; i++) l[i] = (L[i - 1] + 2 * L[i] + L[i + 1] + 2) >> 2;
      l[7] = (L[6] + 3 * L[7] + 2) >> 2;
    }
    auto T_ = [&](int i) { return i < 0 ? tl : t[i]; };
    auto L_ = [&](int i) { return i < 0 ? tl : l[i]; };
    int dc = 128;
    if (mode == 2) {
      int st = 0, sl = 0;
      for (int i = 0; i < 8; i++) {
        st += has_top ? t[i] : 0;
        sl += has_left ? l[i] : 0;
      }
      dc = has_top && has_left ? (st + sl + 8) >> 4 : has_top ? (st + 4) >> 3
           : has_left ? (sl + 4) >> 3 : 128;
    }
    uint8_t* dst = luma_at(x, y);
    for (int yy = 0; yy < 8; yy++) {
      for (int xx = 0; xx < 8; xx++) {
        int v = 0;
        switch (mode) {
          case 0: v = t[xx]; break;
          case 1: v = l[yy]; break;
          case 2: v = dc; break;
          case 3:
            v = xx == 7 && yy == 7 ? (t[14] + 3 * t[15] + 2) >> 2
                                   : (t[xx + yy] + 2 * t[xx + yy + 1] + t[xx + yy + 2] + 2) >> 2;
            break;
          case 4:
            if (xx > yy) v = (T_(xx - yy - 2) + 2 * T_(xx - yy - 1) + T_(xx - yy) + 2) >> 2;
            else if (xx < yy) v = (L_(yy - xx - 2) + 2 * L_(yy - xx - 1) + L_(yy - xx) + 2) >> 2;
            else v = (T_(0) + 2 * tl + L_(0) + 2) >> 2;
            break;
          case 5: {
            int z = 2 * xx - yy, k = xx - (yy >> 1);
            if (z >= 0 && !(z & 1)) v = (T_(k - 1) + T_(k) + 1) >> 1;
            else if (z >= 0) v = (T_(k - 2) + 2 * T_(k - 1) + T_(k) + 2) >> 2;
            else if (z == -1) v = (L_(0) + 2 * tl + T_(0) + 2) >> 2;
            else v = (L_(yy - 2 * xx - 1) + 2 * L_(yy - 2 * xx - 2) + L_(yy - 2 * xx - 3) + 2) >> 2;
            break;
          }
          case 6: {
            int z = 2 * yy - xx, k = yy - (xx >> 1);
            if (z >= 0 && !(z & 1)) v = (L_(k - 1) + L_(k) + 1) >> 1;
            else if (z >= 0) v = (L_(k - 2) + 2 * L_(k - 1) + L_(k) + 2) >> 2;
            else if (z == -1) v = (L_(0) + 2 * tl + T_(0) + 2) >> 2;
            else v = (T_(xx - 2 * yy - 1) + 2 * T_(xx - 2 * yy - 2) + T_(xx - 2 * yy - 3) + 2) >> 2;
            break;
          }
          case 7: {
            int k = xx + (yy >> 1);
            v = (yy & 1) ? (t[k] + 2 * t[k + 1] + t[k + 2] + 2) >> 2 : (t[k] + t[k + 1] + 1) >> 1;
            break;
          }
          case 8: {
            int z = xx + 2 * yy, k = yy + (xx >> 1);
            if (z > 13) v = l[7];
            else if (z == 13) v = (l[6] + 3 * l[7] + 2) >> 2;
            else if (z & 1) v = (l[k] + 2 * l[k + 1] + l[k + 2] + 2) >> 2;
            else v = (l[k] + l[k + 1] + 1) >> 1;
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
  // (mvx, mvy) in ref, into dst.
  void mc_luma(const Picture& ref, int x, int y, int bw, int bh, int mvx, int mvy, uint8_t* dst,
               int ds) {
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
    if ((fx | fy) == 0) {
      for (int r = 0; r < bh; r++) memcpy(dst + (size_t)r * ds, &w[(size_t)(r + 2) * ws + 2], bw);
      return;
    }
    // The half-sample planes this position reads (8.4.2.2.1), each filtered
    // once: b (horizontal, rows 0..bh), h (vertical, columns 0..bw) and j
    // (the centre, from the unclipped horizontal sums of rows -2..bh+2).
    bool need_b = fx && fy != 2, need_h = fy && fx != 2;
    bool need_j = (fx == 2 && fy) || (fy == 2 && fx);
    int b1[21][16];
    uint8_t hb[17][16], hh[16][17], hj[16][16];
    if (need_b || need_j) {
      for (int r = need_j ? -2 : 0; r < bh + (need_j ? 3 : 1); r++)
        for (int c = 0; c < bw; c++)
          b1[r + 2][c] = G(c - 2, r) - 5 * G(c - 1, r) + 20 * G(c, r) + 20 * G(c + 1, r) -
                         5 * G(c + 2, r) + G(c + 3, r);
      for (int r = 0; r <= bh; r++)
        for (int c = 0; c < bw; c++) hb[r][c] = clip1((b1[r + 2][c] + 16) >> 5);
    }
    if (need_h)
      for (int r = 0; r < bh; r++)
        for (int c = 0; c <= bw; c++)
          hh[r][c] = clip1((G(c, r - 2) - 5 * G(c, r - 1) + 20 * G(c, r) + 20 * G(c, r + 1) -
                           5 * G(c, r + 2) + G(c, r + 3) + 16) >> 5);
    if (need_j)
      for (int r = 0; r < bh; r++)
        for (int c = 0; c < bw; c++)
          hj[r][c] = clip1((b1[r][c] - 5 * b1[r + 1][c] + 20 * b1[r + 2][c] + 20 * b1[r + 3][c] -
                           5 * b1[r + 4][c] + b1[r + 5][c] + 512) >> 10);
    for (int r = 0; r < bh; r++) {
      uint8_t* o = dst + (size_t)r * ds;
      for (int c = 0; c < bw; c++) {
        int v;
        switch (fy * 4 + fx) {
          case 1: v = (G(c, r) + hb[r][c] + 1) >> 1; break;
          case 2: v = hb[r][c]; break;
          case 3: v = (G(c + 1, r) + hb[r][c] + 1) >> 1; break;
          case 4: v = (G(c, r) + hh[r][c] + 1) >> 1; break;
          case 5: v = (hb[r][c] + hh[r][c] + 1) >> 1; break;
          case 6: v = (hb[r][c] + hj[r][c] + 1) >> 1; break;
          case 7: v = (hb[r][c] + hh[r][c + 1] + 1) >> 1; break;
          case 8: v = hh[r][c]; break;
          case 9: v = (hh[r][c] + hj[r][c] + 1) >> 1; break;
          case 10: v = hj[r][c]; break;
          case 11: v = (hj[r][c] + hh[r][c + 1] + 1) >> 1; break;
          case 12: v = (G(c, r + 1) + hh[r][c] + 1) >> 1; break;
          case 13: v = (hh[r][c] + hb[r + 1][c] + 1) >> 1; break;
          case 14: v = (hj[r][c] + hb[r + 1][c] + 1) >> 1; break;
          default: v = (hh[r][c + 1] + hb[r + 1][c] + 1) >> 1; break;
        }
        o[c] = (uint8_t)v;
      }
    }
  }

  // Eighth-sample chroma prediction of a bw x bh block at chroma (x, y),
  // into dst.
  void mc_chroma(const Picture& ref, int p, int x, int y, int bw, int bh, int mvx, int mvy,
                 uint8_t* dst, int ds) {
    int xi = x + (mvx >> 3), yi = y + (mvy >> 3), fx = mvx & 7, fy = mvy & 7;
    const int W = width / 2, H = height / 2, S = stride[p];
    const uint8_t* src = ref.plane[p].data();
    bool inside = xi >= 0 && yi >= 0 && xi + bw + 1 <= W && yi + bh + 1 <= H;
    for (int r = 0; r < bh; r++) {
      int y0 = inside ? yi + r : clip3(0, H - 1, yi + r);
      int y1 = inside ? yi + r + 1 : clip3(0, H - 1, yi + r + 1);
      for (int c = 0; c < bw; c++) {
        int x0 = inside ? xi + c : clip3(0, W - 1, xi + c);
        int x1 = inside ? xi + c + 1 : clip3(0, W - 1, xi + c + 1);
        int A = src[(size_t)y0 * S + x0], Bv = src[(size_t)y0 * S + x1];
        int C = src[(size_t)y1 * S + x0], D = src[(size_t)y1 * S + x1];
        dst[(size_t)r * ds + c] =
            (uint8_t)(((8 - fx) * (8 - fy) * A + fx * (8 - fy) * Bv + (8 - fx) * fy * C +
                       fx * fy * D + 32) >> 6);
      }
    }
  }

  // The prediction of the w4 x h4 partition at (x4, y4) of macroblock (mx,
  // my) from its motion in m (8.4.2): each list's samples, then the
  // default, explicit or implicit weighting, into the picture.
  void predict(int mx, int my, const MbInfo& m, int x4, int y4, int w4, int h4) {
    int k = y4 * 4 + x4, r[2] = {m.ref[0][k], m.ref[1][k]};
    int bw = 4 * w4, bh = 4 * h4;
    uint8_t luma[2][256], chroma[2][2][64];
    for (int l = 0; l < 2; l++) {
      if (r[l] < 0) continue;
      const Picture& ref = *list[l][r[l]];
      mc_luma(ref, 16 * mx + 4 * x4, 16 * my + 4 * y4, bw, bh, m.mv[l][k][0], m.mv[l][k][1],
              luma[l], 16);
      for (int c = 0; c < 2; c++)
        mc_chroma(ref, c + 1, 8 * mx + 2 * x4, 8 * my + 2 * y4, bw / 2, bh / 2, m.mv[l][k][0],
                  m.mv[l][k][1], chroma[l][c], 8);
    }
    bool bi = r[0] >= 0 && r[1] >= 0;
    stats[BIPRED] += bi;
    int single = r[0] >= 0 ? 0 : 1;
    bool explicit_w = weight_mode == 1 && wflag[r[0]];
    bool implicit_w = weight_mode == 2 && bi && iw[r[0]][r[1]] != 32;
    stats[EXPLICIT_WEIGHTED] += explicit_w;
    stats[IMPLICIT_WEIGHTED] += implicit_w;
    for (int p = 0; p < 3; p++) {
      int n = p ? bw / 2 : bw, rows = p ? bh / 2 : bh, ss = p ? 8 : 16, S = stride[p];
      const uint8_t* a = p ? chroma[0][p - 1] : luma[0];
      const uint8_t* b = p ? chroma[1][p - 1] : luma[1];
      uint8_t* dst = cur->plane[p].data() + (size_t)(p ? 8 * my + 2 * y4 : 16 * my + 4 * y4) * S +
                     (p ? 8 * mx + 2 * x4 : 16 * mx + 4 * x4);
      for (int y = 0; y < rows; y++) {
        uint8_t* o = dst + (size_t)y * S;
        const uint8_t* pa = a + y * ss;
        const uint8_t* pb = b + y * ss;
        if (bi && weight_mode == 2) {
          int w1 = iw[r[0]][r[1]], w0 = 64 - w1;
          for (int x = 0; x < n; x++) o[x] = clip1((pa[x] * w0 + pb[x] * w1 + 32) >> 6);
        } else if (bi) {
          for (int x = 0; x < n; x++) o[x] = (uint8_t)((pa[x] + pb[x] + 1) >> 1);
        } else if (explicit_w) {
          int w = p ? cw[r[0]][p - 1][0] : lw[r[0]][0], off = p ? cw[r[0]][p - 1][1] : lw[r[0]][1];
          int d = p ? chroma_denom : luma_denom;
          if (d >= 1)
            for (int x = 0; x < n; x++) o[x] = clip1(((pa[x] * w + (1 << (d - 1))) >> d) + off);
          else
            for (int x = 0; x < n; x++) o[x] = clip1(pa[x] * w + off);
        } else {
          memcpy(o, single ? pb : pa, n);
        }
      }
    }
  }

  struct Nb {
    bool avail;
    int ref;
    int mv[2];
  };

  // The motion in list l of the 4x4 block at (x4, y4) in 4x4 units from
  // the current macroblock's corner (-1..4, -1..3); `done` marks the
  // current macroblock's blocks already predicted.
  Nb neighbour(int mx, int my, const MbInfo& m, const bool* done, int x4, int y4, int l) {
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
    return {true, n->ref[l][k], {n->mv[l][k][0], n->mv[l][k][1]}};
  }

  // shape: 0 other, 1 16x8, 2 8x16
  void mv_pred(int mx, int my, const MbInfo& m, const bool* done, int x4, int y4, int w4,
               int ref, int shape, int l, int* mvp) {
    Nb A = neighbour(mx, my, m, done, x4 - 1, y4, l);
    Nb B = neighbour(mx, my, m, done, x4, y4 - 1, l);
    Nb C = neighbour(mx, my, m, done, x4 + w4, y4 - 1, l);
    if (!C.avail) C = neighbour(mx, my, m, done, x4 - 1, y4 - 1, l);
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

  // Store list l's motion of a w4 x h4 partition at (x4, y4): ref -1 for
  // a list it does not use.
  void set_motion(MbInfo& m, int x4, int y4, int w4, int h4, int l, int ref, int mvx, int mvy) {
    if (mvx < -32768 || mvx > 32767 || mvy < -32768 || mvy > 32767)
      fail("a motion vector out of range");
    int32_t id = -1;
    if (ref >= 0) {
      if (ref >= (int)list[l].size() || !list[l][ref]) fail("a reference index past the reference list");
      id = list[l][ref]->id;
    } else {
      mvx = mvy = 0;
    }
    for (int y = y4; y < y4 + h4; y++)
      for (int x = x4; x < x4 + w4; x++) {
        int k = y * 4 + x;
        m.ref[l][k] = (int8_t)ref;
        m.mv[l][k][0] = (int16_t)mvx;
        m.mv[l][k][1] = (int16_t)mvy;
        m.pic[l][k] = id;
      }
  }

  // Direct prediction (8.4.1.2) of the macroblock's 8x8 blocks: each one's
  // ref_idx and motion vector by list.
  struct Direct {
    int ref[4][2];
    int mv[4][2][2];
  };

  void direct_motion(int mx, int my, const MbInfo& m, Direct& d) {
    const Picture& colpic = *list[1][0];
    if (colpic.col.size() != mbs.size()) fail("a co-located picture without its motion");
    const ColMb& col = colpic.col[(size_t)my * mb_w + mx];
    if (direct_spatial) {
      bool done[16] = {};
      int ref[2], mvp[2][2] = {{0, 0}, {0, 0}};
      for (int l = 0; l < 2; l++) {
        Nb A = neighbour(mx, my, m, done, -1, 0, l), B = neighbour(mx, my, m, done, 0, -1, l);
        Nb C = neighbour(mx, my, m, done, 4, -1, l);
        if (!C.avail) C = neighbour(mx, my, m, done, -1, -1, l);
        ref[l] = min_positive(A.ref, min_positive(B.ref, C.ref));
      }
      bool zero = ref[0] < 0 && ref[1] < 0;
      if (zero) ref[0] = ref[1] = 0;
      for (int l = 0; l < 2; l++)
        if (!zero && ref[l] >= 0) mv_pred(mx, my, m, done, 0, 0, 4, ref[l], 0, l, mvp[l]);
      for (int i = 0; i < 4; i++) {
        int small = 0;
        if (!col.intra) {
          int l = col.ref[0][i] >= 0 ? 0 : 1;
          small = col.ref[l][i] == 0 && std::abs(col.mv[l][i][0]) <= 1 &&
                  std::abs(col.mv[l][i][1]) <= 1;
        }
        for (int l = 0; l < 2; l++) {
          d.ref[i][l] = ref[l];
          bool still = zero || ref[l] < 0 || (ref[l] == 0 && small);
          d.mv[i][l][0] = still ? 0 : mvp[l][0];
          d.mv[i][l][1] = still ? 0 : mvp[l][1];
        }
      }
      stats[SPATIAL_DIRECT]++;
      return;
    }
    for (int i = 0; i < 4; i++) {
      int ref0 = 0, mvc[2] = {0, 0};
      if (!col.intra) {
        int l = col.ref[0][i] >= 0 ? 0 : 1;
        mvc[0] = col.mv[l][i][0];
        mvc[1] = col.mv[l][i][1];
        ref0 = -1;
        for (int r = 0; r < num_ref[0] && ref0 < 0; r++)
          if (list[0][r] && list[0][r]->id == col.pic[l][i]) ref0 = r;
        if (ref0 < 0) fail("a temporal direct reference that is not in list 0");
      }
      d.ref[i][0] = ref0;
      d.ref[i][1] = 0;
      for (int c = 0; c < 2; c++) {
        d.mv[i][0][c] = (dsf[ref0] * mvc[c] + 128) >> 8;
        d.mv[i][1][c] = d.mv[i][0][c] - mvc[c];
      }
    }
    stats[TEMPORAL_DIRECT]++;
  }

  // Store the direct motion of 8x8 block i and predict it.
  void direct_block(int mx, int my, MbInfo& m, const Direct& d, int i, bool* done) {
    int x4 = 2 * (i & 1), y4 = 2 * (i >> 1);
    for (int l = 0; l < 2; l++) set_motion(m, x4, y4, 2, 2, l, d.ref[i][l], d.mv[i][l][0], d.mv[i][l][1]);
    for (int y = y4; y < y4 + 2; y++)
      for (int x = x4; x < x4 + 2; x++) {
        done[y * 4 + x] = true;
        m.direct |= (uint16_t)(1 << (y * 4 + x));
      }
    predict(mx, my, m, x4, y4, 2, 2);
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

  // A macroblock's state before it is decoded: no coefficients, no motion.
  MbInfo& begin_mb(int mx, int my) {
    MbInfo& m = mbs[(size_t)my * mb_w + mx];
    m.slice = (int16_t)slice_num;
    m.t8 = m.direct16 = false;
    m.cbp = 0;
    m.chroma_mode = 0;
    m.cbf = m.direct = m.nonzero = 0;
    m.cbf_dc = m.cbf_ac[0] = m.cbf_ac[1] = 0;
    memset(m.nz, 0, sizeof m.nz);
    memset(m.nzc, 0, sizeof m.nzc);
    memset(m.mode, 2, sizeof m.mode);
    memset(m.ref, -1, sizeof m.ref);
    memset(m.mv, 0, sizeof m.mv);
    memset(m.mvd, 0, sizeof m.mvd);
    for (int l = 0; l < 2; l++)
      for (int k = 0; k < 16; k++) m.pic[l][k] = -1;
    return m;
  }

  // P_Skip or B_Skip
  void skip_mb(int mx, int my) {
    MbInfo& m = begin_mb(mx, my);
    m.kind = MB_SKIP;
    m.qp = (int8_t)qp;
    last_dqp = 0;
    stats[SKIPPED]++;
    bool done[16] = {};
    if (slice_type == 1) {
      m.direct16 = true;
      Direct d;
      direct_motion(mx, my, m, d);
      for (int i = 0; i < 4; i++) direct_block(mx, my, m, d, i, done);
      return;
    }
    Nb A = neighbour(mx, my, m, done, -1, 0, 0), B = neighbour(mx, my, m, done, 0, -1, 0);
    int mv[2] = {0, 0};
    if (A.avail && B.avail && !(A.ref == 0 && !A.mv[0] && !A.mv[1]) &&
        !(B.ref == 0 && !B.mv[0] && !B.mv[1]))
      mv_pred(mx, my, m, done, 0, 0, 4, 0, 0, 0, mv);
    set_motion(m, 0, 0, 4, 4, 0, 0, mv[0], mv[1]);
    predict(mx, my, m, 0, 0, 4, 4);
  }

  int read_ref(Bits& b, int mx, int my, const MbInfo& m, int l, int x4, int y4) {
    if (num_ref[l] == 1) return 0;
    if (cabac) return cabac_ref(mx, my, m, l, x4, y4);
    return num_ref[l] == 2 ? !b.get1() : b.ue_max(num_ref[l] - 1, "ref_idx");
  }

  int read_mvd(Bits& b, int mx, int my, const MbInfo& m, int l, int comp, int x4, int y4) {
    return cabac ? cabac_mvd(mx, my, m, l, comp, x4, y4) : b.se();
  }

  // An intra 4x4 or 8x8 prediction mode: the predicted one, or rem.
  int read_intra_mode(Bits& b, int pred) {
    if (cabac) {
      if (cab.decision(68)) return pred;
      int rem = cab.decision(69);
      rem |= cab.decision(69) << 1;
      rem |= cab.decision(69) << 2;
      return rem < pred ? rem : rem + 1;
    }
    if (b.get1()) return pred;
    int rem = (int)b.get(3);
    return rem < pred ? rem : rem + 1;
  }

  // The inter prediction of a P or B macroblock of mb_type `type` (P 0-4,
  // B 0-22): its ref_idx and mvd, then each partition's motion and samples.
  // Returns whether a transform_size_8x8_flag may follow (no partition
  // below 8x8).
  bool inter_mb(Bits& b, int mx, int my, MbInfo& m, int type) {
    m.kind = MB_P;
    stats[INTER]++;
    bool done[16] = {};
    bool b_slice = slice_type == 1;
    int parts, pred[4] = {1, 1, 1, 1}, sub[4] = {0, 0, 0, 0};
    int px[4], py[4], pw[4], ph4[4];
    bool direct_sub[4] = {false, false, false, false};
    if (b_slice && type == 0) {  // B_Direct_16x16
      m.direct16 = true;
      Direct d;
      direct_motion(mx, my, m, d);
      for (int i = 0; i < 4; i++) direct_block(mx, my, m, d, i, done);
      return active.direct_8x8_inference;
    }
    int shape;  // 0 16x16, 1 16x8, 2 8x16, 3 8x8
    if (!b_slice) {
      shape = type == 0 ? 0 : type == 1 ? 1 : type == 2 ? 2 : 3;
    } else if (type < 22) {
      shape = kBType[type][0];
      pred[0] = kBType[type][1];
      pred[1] = kBType[type][2];
    } else {
      shape = 3;
    }
    if (shape < 3) {
      parts = shape == 0 ? 1 : 2;
      for (int i = 0; i < parts; i++) {
        px[i] = shape == 2 ? 2 * i : 0;
        py[i] = shape == 1 ? 2 * i : 0;
        pw[i] = shape == 2 ? 2 : 4;
        ph4[i] = shape == 1 ? 2 : 4;
      }
    } else {
      parts = 4;
      if (!b_slice) stats[P8X8]++;
      for (int i = 0; i < 4; i++) {
        if (cabac) sub[i] = b_slice ? cabac_sub_b() : cabac_sub_p();
        else sub[i] = b.ue_max(b_slice ? 12 : 3, "sub_mb_type");
        if (b_slice) {
          if (sub[i] > 3)
            unsupported("B sub-macroblock partitions smaller than 8x8 (sub_mb_type " +
                        std::to_string(sub[i]) + ")");
          direct_sub[i] = sub[i] == 0;
          pred[i] = sub[i];
          sub[i] = 0;
        }
        stats[SMALL_PARTS] += sub[i] > 0;
        px[i] = 2 * (i & 1);
        py[i] = 2 * (i >> 1);
        pw[i] = ph4[i] = 2;
      }
    }
    bool any_direct = direct_sub[0] || direct_sub[1] || direct_sub[2] || direct_sub[3];
    if (any_direct) {
      for (int i = 0; i < 4; i++)
        if (direct_sub[i])
          for (int y = py[i]; y < py[i] + 2; y++)
            for (int x = px[i]; x < px[i] + 2; x++) m.direct |= (uint16_t)(1 << (y * 4 + x));
    }
    // ref_idx of each list, in partition order
    int refs[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
    for (int l = 0; l < (b_slice ? 2 : 1); l++)
      for (int i = 0; i < parts; i++) {
        if (direct_sub[i] || !((pred[i] >> l) & 1)) {
          refs[l][i] = -1;
          continue;
        }
        refs[l][i] = (!b_slice && type == 4) ? 0 : read_ref(b, mx, my, m, l, px[i], py[i]);
        stats[REF_ABOVE_0] += refs[l][i] > 0;
        for (int y = py[i]; y < py[i] + ph4[i]; y++)
          for (int x = px[i]; x < px[i] + pw[i]; x++) m.ref[l][y * 4 + x] = (int8_t)refs[l][i];
      }
    if (!b_slice) refs[1][0] = refs[1][1] = refs[1][2] = refs[1][3] = -1;
    // mvd of each list, by partition and sub-partition
    int mvd[2][4][4][2] = {};
    for (int l = 0; l < (b_slice ? 2 : 1); l++)
      for (int i = 0; i < parts; i++) {
        if (refs[l][i] < 0) continue;
        int n = sub[i] == 0 ? 1 : sub[i] == 3 ? 4 : 2;
        int w4 = sub[i] == 0 || sub[i] == 1 ? pw[i] : 1, h4 = sub[i] == 0 || sub[i] == 2 ? ph4[i] : 1;
        for (int j = 0; j < n; j++) {
          int x4 = px[i] + (w4 == 1 ? (j & 1) : 0);
          int y4 = py[i] + (h4 == 1 ? (sub[i] == 1 ? j : j >> 1) : 0);
          for (int c = 0; c < 2; c++) {
            int v = read_mvd(b, mx, my, m, l, c, x4, y4);
            mvd[l][i][j][c] = v;
            uint8_t a = (uint8_t)std::min(std::abs(v), 64);
            for (int y = y4; y < y4 + h4; y++)
              for (int x = x4; x < x4 + w4; x++) m.mvd[l][y * 4 + x][c] = a;
          }
        }
      }
    // motion and prediction, partition by partition
    Direct d;
    if (any_direct) direct_motion(mx, my, m, d);
    for (int i = 0; i < parts; i++) {
      if (direct_sub[i]) {
        direct_block(mx, my, m, d, i, done);
        continue;
      }
      int n = sub[i] == 0 ? 1 : sub[i] == 3 ? 4 : 2;
      int w4 = sub[i] == 0 || sub[i] == 1 ? pw[i] : 1, h4 = sub[i] == 0 || sub[i] == 2 ? ph4[i] : 1;
      for (int j = 0; j < n; j++) {
        int x4 = px[i] + (w4 == 1 ? (j & 1) : 0);
        int y4 = py[i] + (h4 == 1 ? (sub[i] == 1 ? j : j >> 1) : 0);
        for (int l = 0; l < 2; l++) {
          if (refs[l][i] < 0) {
            set_motion(m, x4, y4, w4, h4, l, -1, 0, 0);
            continue;
          }
          int mvp[2];
          mv_pred(mx, my, m, done, x4, y4, w4, refs[l][i], shape == 3 ? 0 : shape, l, mvp);
          set_motion(m, x4, y4, w4, h4, l, refs[l][i], mvp[0] + mvd[l][i][j][0],
                     mvp[1] + mvd[l][i][j][1]);
        }
        for (int y = y4; y < y4 + h4; y++)
          for (int x = x4; x < x4 + w4; x++) done[y * 4 + x] = true;
        predict(mx, my, m, x4, y4, w4, h4);
      }
    }
    if (sub[0] | sub[1] | sub[2] | sub[3]) return false;
    return !any_direct || active.direct_8x8_inference;
  }

  void macroblock(Bits& b, int mx, int my) {
    MbInfo& m = begin_mb(mx, my);
    int type;
    if (cabac) {
      type = slice_type == 2 ? cabac_mb_type_i(mx, my, 3, true)
             : slice_type == 0 ? cabac_mb_type_p(mx, my) : cabac_mb_type_b(mx, my);
    } else {
      type = b.ue_max(slice_type == 0 ? 30 : slice_type == 1 ? 48 : 25, "mb_type");
    }
    bool intra = true;
    if (slice_type == 0) {
      if (type < 5) intra = false;
      else type -= 5;
    } else if (slice_type == 1) {
      if (type < 23) intra = false;
      else type -= 23;
    }
    int cbp = 0, i16_mode = 0;
    bool t8_allowed = false;
    if (intra) {
      if (type == 25) unsupported("I_PCM macroblocks");
      stats[P_INTRA] += slice_type == 0;
      if (type == 0) {
        m.t8 = transform_8x8 && (cabac ? cabac_t8(mx, my) : b.get1());
        m.kind = m.t8 ? MB_I8 : MB_I4;
        stats[m.t8 ? I8X8 : I4X4]++;
        auto mode_of = [&](int x, int y) {
          if (x >= 0 && y >= 0) return (int)m.mode[y * 4 + x];
          int nx = x < 0 ? mx - 1 : mx, ny = y < 0 ? my - 1 : my;
          MbInfo* n = avail(nx, ny);
          if (!n || (constrained_intra && !is_intra(*n))) return -1;
          return n->kind == MB_I4 || n->kind == MB_I8 ? (int)n->mode[(y & 3) * 4 + (x & 3)] : 2;
        };
        for (int k = 0; k < (m.t8 ? 4 : 16); k++) {
          int bx = m.t8 ? 2 * (k & 1) : blk_x(k), by = m.t8 ? 2 * (k >> 1) : blk_y(k);
          int pa = mode_of(bx - 1, by), pb = mode_of(bx, by - 1);
          int mode = read_intra_mode(b, pa < 0 || pb < 0 ? 2 : std::min(pa, pb));
          for (int y = by; y < by + (m.t8 ? 2 : 1); y++)
            for (int x = bx; x < bx + (m.t8 ? 2 : 1); x++) m.mode[y * 4 + x] = (int8_t)mode;
        }
      } else {
        m.kind = MB_I16;
        stats[I16X16]++;
        i16_mode = (type - 1) % 4;
        cbp = (((type - 1) / 4) % 3) << 4 | (type >= 13 ? 15 : 0);
      }
      m.chroma_mode = (int8_t)(cabac ? cabac_chroma_mode(mx, my)
                                     : b.ue_max(3, "intra_chroma_pred_mode"));
      if (m.kind != MB_I16)
        cbp = cabac ? cabac_cbp(mx, my) : kIntraCbp[b.ue_max(47, "coded_block_pattern")];
    } else {
      t8_allowed = inter_mb(b, mx, my, m, type);
      cbp = cabac ? cabac_cbp(mx, my) : kInterCbp[b.ue_max(47, "coded_block_pattern")];
    }
    int cbp_luma = cbp & 15, cbp_chroma = cbp >> 4;
    if (cbp_chroma > 2) fail("a coded_block_pattern past 47");
    m.cbp = (uint8_t)cbp;
    if (!intra && cbp_luma && transform_8x8 && t8_allowed)
      m.t8 = cabac ? cabac_t8(mx, my) : b.get1();
    stats[T8X8] += m.t8;
    if (cbp || m.kind == MB_I16) {
      int delta = cabac ? cabac_qp_delta() : b.se();
      if (delta < -26 || delta > 25) fail("mb_qp_delta " + std::to_string(delta) + " out of range");
      stats[QP_DELTA] += delta != 0;
      qp = (qp + delta + 52) % 52;
      last_dqp = delta;
    } else {
      last_dqp = 0;
    }
    m.qp = (int8_t)qp;

    // residual
    int lists = intra ? 0 : 3;  // the scaling lists: Intra Y, Cb, Cr or Inter Y, Cb, Cr
    int coef[16][16] = {};      // luma by raster block, raster positions
    int coef8[4][64];
    int buf[64];
    bool has_coef[16] = {};
    if (m.kind == MB_I16) {
      int n = cabac ? cabac_block(0, cbf_dc_inc(mx, my, 0, true), 16, buf)
                    : residual_block(b, luma_nc(mx, my, m, 0, 0), 16, buf);
      m.cbf_dc |= n > 0;
      int c[16] = {};
      for (int k = 0; k < 16; k++) c[kZigzag[k]] = buf[k];
      if (n) {
        // inverse Hadamard, then scaling with LevelScale4x4(QP % 6, 0, 0)
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
        int scale = ls4[0][qp % 6][0];
        for (int k = 0; k < 16; k++) {
          int64_t v = qp >= 36 ? (int64_t)f[k] * scale * (1 << (qp / 6 - 6))
                               : ((int64_t)f[k] * scale + (1 << (5 - qp / 6))) >> (6 - qp / 6);
          if (v > 32767 || v < -32768) fail("a luma DC coefficient out of range");
          coef[k][0] = (int)v;
          has_coef[k] = v != 0;
        }
      }
    }
    bool has8[4] = {};
    for (int b8 = 0; b8 < 4 && m.t8; b8++) {
      if (!(cbp_luma >> b8 & 1)) continue;
      std::fill(coef8[b8], coef8[b8] + 64, 0);
      int total = 0;
      if (cabac) {
        total = cabac_block(5, 0, 64, buf);
        for (int k = 0; k < 64; k++)
          if (buf[k]) coef8[b8][h264::kZigzag8x8[k]] = buf[k];
      } else {
        for (int i4 = 0; i4 < 4; i4++) {
          int k = 4 * b8 + i4, r = blk_y(k) * 4 + blk_x(k);
          m.nz[r] = (uint8_t)residual_block(b, luma_nc(mx, my, m, blk_x(k), blk_y(k)), 16, buf);
          total += m.nz[r];
          for (int i = 0; i < 16; i++)
            if (buf[i]) coef8[b8][h264::kZigzag8x8[4 * i + i4]] = buf[i];
        }
      }
      for (int pos = 0; pos < 64; pos++)
        if (coef8[b8][pos]) coef8[b8][pos] = dequant8(coef8[b8][pos], pos, qp, lists ? 1 : 0);
      has8[b8] = total > 0;
      for (int i4 = 0; i4 < 4; i4++) {
        int k = 4 * b8 + i4, r = blk_y(k) * 4 + blk_x(k);
        m.cbf |= (uint16_t)((total > 0) << r);
        m.nonzero |= (uint16_t)((total > 0) << r);
      }
    }
    for (int k = 0; k < 16 && !m.t8; k++) {
      int bx = blk_x(k), by = blk_y(k);
      int r = by * 4 + bx;
      if (!(cbp_luma >> (k >> 2) & 1)) continue;
      bool ac = m.kind == MB_I16;
      int n;
      if (cabac) n = cabac_block(ac ? 1 : 2, cbf_luma_inc(mx, my, m, bx, by, intra), ac ? 15 : 16, buf);
      else n = residual_block(b, luma_nc(mx, my, m, bx, by), ac ? 15 : 16, buf);
      m.nz[r] = (uint8_t)n;
      m.cbf |= (uint16_t)((n > 0) << r);
      m.nonzero |= (uint16_t)((n > 0) << r);
      for (int i = 0; i < (ac ? 15 : 16); i++)
        if (buf[i]) {
          int pos = kZigzag[i + ac];
          coef[r][pos] = dequant(buf[i], pos, qp, lists);
        }
      has_coef[r] = has_coef[r] || n;
    }
    int ccoef[2][4][16] = {};
    bool chas[2][4] = {};
    int qpc[2] = {chroma_qp(qp, cqp_offset[0]), chroma_qp(qp, cqp_offset[1])};
    if (cbp_chroma) {
      for (int c = 0; c < 2; c++) {
        int dc[4];
        int n = cabac ? cabac_block(3, cbf_dc_inc(mx, my, 1 + c, intra), 4, dc)
                      : residual_block(b, -1, 4, dc);
        if (!n) continue;
        m.cbf_dc |= (uint8_t)(2 << c);
        int f0 = dc[0] + dc[1] + dc[2] + dc[3], f1 = dc[0] - dc[1] + dc[2] - dc[3];
        int f2 = dc[0] + dc[1] - dc[2] - dc[3], f3 = dc[0] - dc[1] - dc[2] + dc[3];
        int f[4] = {f0, f1, f2, f3};
        int scale = ls4[lists + 1 + c][qpc[c] % 6][0];
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
          int n = cabac ? cabac_block(4, cbf_ac_inc(mx, my, m, c, bx, by, intra), 15, buf)
                        : residual_block(b, chroma_nc(mx, my, m, c, bx, by), 15, buf);
          m.nzc[c][k] = (uint8_t)n;
          m.cbf_ac[c] |= (uint8_t)((n > 0) << k);
          for (int i = 0; i < 15; i++)
            if (buf[i])
              ccoef[c][k][kZigzag[i + 1]] = dequant(buf[i], kZigzag[i + 1], qpc[c], lists + 1 + c);
          chas[c][k] = chas[c][k] || n;
        }
      }
    }
    if (cabac && cab.overread > 64) fail("truncated H.264 slice data");

    // reconstruction
    if (m.kind == MB_I4) {
      for (int k = 0; k < 16; k++) {
        int bx = blk_x(k), by = blk_y(k);
        int r = by * 4 + bx;
        intra4x4(m.mode[r], mx, my, bx, by);
        if (has_coef[r]) idct4_add(coef[r], luma_at(16 * mx + 4 * bx, 16 * my + 4 * by), stride[0]);
      }
    } else if (m.kind == MB_I8) {
      for (int b8 = 0; b8 < 4; b8++) {
        int bx = 2 * (b8 & 1), by = 2 * (b8 >> 1);
        intra8x8(m.mode[by * 4 + bx], mx, my, b8);
        if (has8[b8]) idct8_add(coef8[b8], luma_at(16 * mx + 4 * bx, 16 * my + 4 * by), stride[0]);
      }
    } else {
      if (m.kind == MB_I16) intra_block(0, 16, i16_mode, mx, my);
      if (m.t8) {
        for (int b8 = 0; b8 < 4; b8++)
          if (has8[b8])
            idct8_add(coef8[b8], luma_at(16 * mx + 8 * (b8 & 1), 16 * my + 8 * (b8 >> 1)), stride[0]);
      } else {
        for (int r = 0; r < 16; r++)
          if (has_coef[r])
            idct4_add(coef[r], luma_at(16 * mx + 4 * (r & 3), 16 * my + 4 * (r >> 2)), stride[0]);
      }
    }
    int chroma_mode = m.chroma_mode;
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

  // bS of an edge segment (8.7.2.1); the motion test compares reference
  // pictures as pictures, and a B slice's pairs of vectors either way round
  // (FFmpeg's check_mv)
  int strength(const MbInfo& p, int pb, const MbInfo& q, int qb, bool mb_edge, bool b_slice) {
    if (is_intra(p) || is_intra(q)) return mb_edge ? 4 : 3;
    if (((p.nonzero >> pb) & 1) || ((q.nonzero >> qb) & 1)) return 2;
    auto far = [](const int16_t* a, const int16_t* b) {
      return std::abs(a[0] - b[0]) >= 4 || std::abs(a[1] - b[1]) >= 4;
    };
    bool v = p.pic[0][pb] != q.pic[0][qb] || (p.pic[0][pb] != -1 && far(p.mv[0][pb], q.mv[0][qb]));
    if (!b_slice) return v;
    if (!v) v = p.pic[1][pb] != q.pic[1][qb] || far(p.mv[1][pb], q.mv[1][qb]);
    if (!v) return 0;
    if (p.pic[0][pb] != q.pic[1][qb] || p.pic[1][pb] != q.pic[0][qb]) return 1;
    return far(p.mv[0][pb], q.mv[1][qb]) || far(p.mv[1][pb], q.mv[0][qb]);
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
        if ((e & 1) && q.t8) continue;  // no 4x4 edges inside an 8x8 transform block
        const MbInfo& p = e > 0 ? q : dir ? mbs[(size_t)(my - 1) * mb_w + mx] : mbs[(size_t)my * mb_w + mx - 1];
        int bs[4];
        for (int i = 0; i < 4; i++) {
          int qb = dir ? e * 4 + i : i * 4 + e;
          int pb = dir ? ((e + 3) & 3) * 4 + i : i * 4 + ((e + 3) & 3);
          bs[i] = strength(p, pb, q, qb, e == 0, s.b);
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

  void start_picture(const Sps& s, int frame_num, bool idr, int nal_ref, int poc_lsb,
                     int delta_bottom) {
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
    // picture order count (8.2.1); the state it carries is kept by
    // finish_picture, so that a picture that fails leaves none of it
    Order o = order;
    if (idr) o = Order();
    int poc;
    if (s.poc_type == 0) {
      int max_lsb = 1 << s.log2_max_poc_lsb, msb;
      if (poc_lsb < o.poc_lsb && o.poc_lsb - poc_lsb >= max_lsb / 2) msb = o.poc_msb + max_lsb;
      else if (poc_lsb > o.poc_lsb && poc_lsb - o.poc_lsb > max_lsb / 2) msb = o.poc_msb - max_lsb;
      else msb = o.poc_msb;
      poc = msb + poc_lsb + std::min(delta_bottom, 0);
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
    o.poc = poc;
    o.frame_num = frame_num;
    next_order = o;
    cur = std::make_shared<Picture>();
    for (int p = 0; p < 3; p++) cur->plane[p].assign((size_t)stride[p] * ph[p], 0);
    cur->frame_num = frame_num;
    cur->poc = poc;
    cur->id = next_id++;
    cur_frame_num = frame_num;
    cur_idr = idr;
    cur_nal_ref = nal_ref;
    next_mb = 0;
    slices.clear();
    for (MbInfo& m : mbs) m.slice = -1;
    stats[IDR] += idr;
  }

  void pred_weight_table(Bits& b) {
    luma_denom = b.ue_max(7, "luma_log2_weight_denom");
    chroma_denom = b.ue_max(7, "chroma_log2_weight_denom");
    for (int i = 0; i < num_ref[0]; i++) {
      wflag[i] = false;
      lw[i][0] = 1 << luma_denom;
      lw[i][1] = 0;
      if (b.get1()) {
        lw[i][0] = b.se_range(-128, 127, "luma_weight_l0");
        lw[i][1] = b.se_range(-128, 127, "luma_offset_l0");
        wflag[i] = true;
      }
      for (int c = 0; c < 2; c++) {
        cw[i][c][0] = 1 << chroma_denom;
        cw[i][c][1] = 0;
      }
      if (b.get1()) {
        for (int c = 0; c < 2; c++) {
          cw[i][c][0] = b.se_range(-128, 127, "chroma_weight_l0");
          cw[i][c][1] = b.se_range(-128, 127, "chroma_offset_l0");
        }
        wflag[i] = true;
      }
    }
  }

  // The initial reference lists (8.2.4.2), their modification (8.2.4.3)
  // by `mods` ((modification_of_pic_nums_idc, abs_diff_pic_num_minus1)),
  // each cut to num_ref_idx_lX_active.
  void build_lists(const Sps& s, int frame_num, const std::vector<std::pair<int, int>>* mods) {
    int max_frame_num = 1 << s.log2_max_frame_num;
    auto picnum = [&](const Picture& p) {
      return p.frame_num > frame_num ? p.frame_num - max_frame_num : p.frame_num;
    };
    list[0].clear();
    list[1].clear();
    if (slice_type == 2) return;
    if (refs.empty()) fail(std::string("a ") + (slice_type ? "B" : "P") + " slice without a reference picture");
    if (slice_type == 0) {  // descending PicNum
      list[0] = refs;
      std::stable_sort(list[0].begin(), list[0].end(),
                       [&](const auto& a, const auto& c) { return picnum(*a) > picnum(*c); });
    } else {  // by POC: below the current one descending, above it ascending
      std::vector<std::shared_ptr<Picture>> before, after;
      for (auto& p : refs) {
        if (p->poc == cur->poc) fail("a reference picture of the current picture's POC");
        (p->poc < cur->poc ? before : after).push_back(p);
      }
      std::sort(before.begin(), before.end(), [](const auto& a, const auto& c) { return a->poc > c->poc; });
      std::sort(after.begin(), after.end(), [](const auto& a, const auto& c) { return a->poc < c->poc; });
      list[0] = before;
      list[0].insert(list[0].end(), after.begin(), after.end());
      list[1] = after;
      list[1].insert(list[1].end(), before.begin(), before.end());
      if (list[1].size() > 1 && list[1] == list[0]) std::swap(list[1][0], list[1][1]);
    }
    for (int l = 0; l < (slice_type == 1 ? 2 : 1); l++) {
      std::vector<std::shared_ptr<Picture>>& L = list[l];
      int n = num_ref[l];
      L.resize(n);
      int pred = frame_num, idx = 0;
      for (auto& mod : mods[l]) {
        int no_wrap;
        if (mod.first == 0) {
          no_wrap = pred - (mod.second + 1);
          if (no_wrap < 0) no_wrap += max_frame_num;
        } else {
          no_wrap = pred + (mod.second + 1);
          if (no_wrap >= max_frame_num) no_wrap -= max_frame_num;
        }
        pred = no_wrap;
        int num = no_wrap > frame_num ? no_wrap - max_frame_num : no_wrap;
        std::shared_ptr<Picture> pic;
        for (auto& p : refs)
          if (picnum(*p) == num) pic = p;
        if (!pic) fail("a reference list modification of a picture that is not a reference");
        L.insert(L.begin() + idx, pic);
        int k = idx + 1;
        for (int c = idx + 1; c < (int)L.size(); c++)
          if (!(L[c] && picnum(*L[c]) == num)) L[k++] = L[c];
        L.resize(n);
        idx++;
      }
      stats[LIST_MODIFICATIONS] += (int64_t)mods[l].size();
    }
  }

  void slice(const std::vector<uint8_t>& r, int nal_type, int nal_ref) {
    Bits b = rbsp_reader(r);
    int first_mb = (int)b.ue();
    int type = b.ue_max(9, "slice_type") % 5;
    if (type == 3 || type == 4) unsupported("SP and SI slices");
    int pps_id = b.ue_max(255, "pic_parameter_set_id");
    const Pps& p = pps[pps_id];
    if (!p.valid) fail("a slice of a missing PPS " + std::to_string(pps_id));
    const Sps& s = sps[p.sps_id];
    if (!s.valid) fail("a slice of a missing SPS " + std::to_string(p.sps_id));
    if (!s.refuse.empty()) unsupported(s.refuse);
    if (!p.refuse.empty()) unsupported(p.refuse);
    bool idr = nal_type == 5;
    if (idr && type != 2) fail("an IDR picture with a P or B slice");
    int frame_num = (int)b.get(s.log2_max_frame_num);
    if (idr) b.ue_max(65535, "idr_pic_id");
    int poc_lsb = 0, delta_bottom = 0;
    if (s.poc_type == 0) {
      poc_lsb = (int)b.get(s.log2_max_poc_lsb);
      if (p.bottom_field_poc) delta_bottom = b.se();
    }
    bool spatial = type == 1 ? b.get1() : true;
    int nref[2] = {p.num_ref_default[0], p.num_ref_default[1]};
    if (type != 2 && b.get1()) {
      nref[0] = b.ue_max(31, "num_ref_idx_l0_active_minus1") + 1;
      if (type == 1) nref[1] = b.ue_max(31, "num_ref_idx_l1_active_minus1") + 1;
    }
    if (nref[0] > 16 || nref[1] > 16) fail("num_ref_idx_active above 16 in a frame");
    std::vector<std::pair<int, int>> mods[2];
    for (int l = 0; l < (type == 1 ? 2 : type == 0 ? 1 : 0); l++) {
      if (!b.get1()) continue;
      for (;;) {
        int idc = b.ue_max(5, "modification_of_pic_nums_idc");
        if (idc == 3) break;
        if (idc == 2) unsupported("long-term reference pictures (modification_of_pic_nums_idc 2)");
        if (idc > 3) fail("modification_of_pic_nums_idc " + std::to_string(idc) + " outside MVC");
        int diff = b.ue_max((1u << s.log2_max_frame_num) - 1, "abs_diff_pic_num_minus1");
        if ((int)mods[l].size() >= nref[l]) fail("more reference list modifications than entries");
        mods[l].emplace_back(idc, diff);
      }
    }
    int wmode = 0;
    if (p.weighted_pred && type == 0) wmode = 1;
    if (p.bipred_idc == 1 && type == 1)
      unsupported("explicit weighted bi-prediction (weighted_bipred_idc 1)");
    if (p.bipred_idc == 2 && type == 1) wmode = 2;
    num_ref[0] = nref[0];
    num_ref[1] = nref[1];
    if (wmode == 1) pred_weight_table(b);
    bool adaptive = false;
    std::vector<int> ops;
    if (nal_ref) {
      if (idr) {
        b.get(1);  // no_output_of_prior_pics_flag
        if (b.get1()) unsupported("long-term reference pictures (long_term_reference_flag)");
      } else if ((adaptive = b.get1())) {
        for (int n = 0;; n++) {
          int op = b.ue_max(6, "memory_management_control_operation");
          if (op == 0) break;
          if (op == 5) unsupported("memory management control operation 5");
          if (op != 1)
            unsupported("long-term reference pictures (memory management control operation " +
                        std::to_string(op) + ")");
          if (n >= 64) fail("too many memory management control operations");
          ops.push_back(b.ue_max((1u << s.log2_max_frame_num) - 1, "difference_of_pic_nums_minus1"));
        }
      }
    }
    int init_idc = 0;
    if (p.cabac && type != 2) init_idc = b.ue_max(2, "cabac_init_idc");
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
    info.b = type == 1;
    if (type == 1 && !s.direct_8x8_inference)
      unsupported("B slices of direct_8x8_inference_flag 0");

    if (cur && first_mb == 0) unsupported("several pictures in one packet");
    if (!cur) {
      if (first_mb != 0) unsupported("arbitrary slice order (ASO): a picture's first slice past its first macroblock");
      if (!started && !idr) unsupported("a stream that does not start with an IDR picture");
      start_picture(s, frame_num, idr, nal_ref, poc_lsb, delta_bottom);
      stats[CONSTRAINED_INTRA] += p.constrained_intra;
      stats[CROPPED] += s.crop_right || s.crop_bottom || s.crop_top;
      stats[SCALING_PICTURES] += s.scaling.present || p.scaling.present;
      marking_adaptive = adaptive;
      unmark = ops;
    } else {
      if (frame_num != cur_frame_num || idr != cur_idr || (nal_ref != 0) != (cur_nal_ref != 0))
        fail("slices of different pictures in one packet");
      if (first_mb != next_mb) unsupported("arbitrary slice order (ASO)");
      if (!s.same_geometry(active)) unsupported("a size change within the stream");
    }
    if (first_mb >= mb_w * mb_h) fail("first_mb_in_slice past the picture");
    stats[SLICES]++;
    stats[P_PICTURES] += type == 0 && slices.empty();
    stats[B_PICTURES] += type == 1 && slices.empty();
    stats[MULTI_SLICE] += slices.size() == 1;
    stats[DEBLOCK_OFFSETS] += info.deblock_idc == 0 && (info.alpha_offset || info.beta_offset);
    stats[DEBLOCK_OFF] += info.deblock_idc == 1;
    stats[MMCO_OPS] += slices.empty() ? (int64_t)ops.size() : 0;
    slice_num = (int)slices.size();
    slices.push_back(info);
    slice_type = type;
    qp = qp0;
    cabac = p.cabac;
    constrained_intra = p.constrained_intra;
    transform_8x8 = p.transform_8x8;
    direct_spatial = spatial;
    weight_mode = wmode;
    cqp_offset[0] = p.cqp_offset[0];
    cqp_offset[1] = p.cqp_offset[1];
    level_scales(s, p);
    build_lists(s, frame_num, mods);
    if (type == 1) {
      if (!list[1][0]) fail("a B slice without RefPicList1[0]");
      int poc1 = list[1][0]->poc;
      for (int i = 0; i < num_ref[0]; i++) {  // temporal direct's DistScaleFactor
        dsf[i] = 256;
        if (!list[0][i]) continue;
        int td = clip3(-128, 127, poc1 - list[0][i]->poc);
        if (td == 0) continue;
        int tb = clip3(-128, 127, cur->poc - list[0][i]->poc);
        int tx = (16384 + std::abs(td / 2)) / td;
        dsf[i] = clip3(-1024, 1023, (tb * tx + 32) >> 6);
      }
      for (int i = 0; i < num_ref[0]; i++)  // implicit weights (8.4.2.3.1)
        for (int j = 0; j < num_ref[1]; j++) {
          iw[i][j] = 32;
          if (!list[0][i] || !list[1][j]) continue;
          int td = clip3(-128, 127, list[1][j]->poc - list[0][i]->poc);
          if (td == 0) continue;
          int tb = clip3(-128, 127, cur->poc - list[0][i]->poc);
          int tx = (16384 + std::abs(td / 2)) / td;
          int w = clip3(-1024, 1023, (tb * tx + 32) >> 6) >> 2;
          if (w >= -64 && w <= 128) iw[i][j] = w;
        }
    }

    // slice data
    int mb = first_mb, total = mb_w * mb_h;
    last_dqp = 0;
    if (cabac) {
      while (b.pos & 7)
        if (!b.get1()) fail("a cabac_alignment_one_bit of 0");
      stats[type == 2 ? CABAC_I : CABAC_IDC0 + init_idc]++;
      cab.init_contexts(type == 2 ? 0 : 1 + init_idc, qp0);
      if (!cab.init_engine(r.data(), r.size() * 8, b.pos)) fail("CABAC slice data of codIOffset 510 or 511");
      for (;;) {
        if (mb >= total) fail("slice data past the picture's last macroblock");
        int mx = mb % mb_w, my = mb / mb_w;
        if (type != 2 && cab.decision((type == 0 ? 11 : 24) + ctx_skip(mx, my))) skip_mb(mx, my);
        else macroblock(b, mx, my);
        mb++;
        if (cab.overread > 64) fail("truncated H.264 slice data");
        if (cab.terminate()) break;
      }
    } else {
      bool more = true;
      while (more) {
        if (type != 2) {
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
    }
    next_mb = mb;
  }

  // Output (C.4.5.3 as FFmpeg orders it): the waiting picture of the
  // smallest POC, while more wait than `keep`.
  void bump(size_t keep) {
    while (waiting.size() > keep) {
      auto it = std::min_element(waiting.begin(), waiting.end(),
                                 [](const auto& a, const auto& c) { return a->poc < c->poc; });
      std::shared_ptr<Picture> pic = *it;
      if (have_out_poc && pic->poc < last_out_poc) {
        if (!active.restriction)
          unsupported("a picture order count out of decode order (reordered output) in a stream "
                      "whose SPS has no bitstream restriction (FFmpeg guesses its reorder depth)");
        unsupported("a picture order count below one already output (reordering deeper than "
                    "max_num_reorder_frames)");
      }
      waiting.erase(it);
      have_out_poc = true;
      last_out_poc = pic->poc;
      stats[REORDERED] += pic->seq < max_seq_out;
      max_seq_out = std::max(max_seq_out, pic->seq);
      ready.push_back(pic);
    }
  }

  // The picture's end: every macroblock decoded, filtered, marked, queued
  // for output.
  void finish_picture() {
    if (next_mb != mb_w * mb_h)
      fail("a picture of " + std::to_string(next_mb) + " of " + std::to_string(mb_w * mb_h) +
           " macroblocks");
    for (int my = 0; my < mb_h; my++)
      for (int mx = 0; mx < mb_w; mx++) deblock_mb(mx, my);
    if (cur_nal_ref) {  // the motion direct prediction reads of a co-located picture
      cur->col.resize(mbs.size());
      for (size_t i = 0; i < mbs.size(); i++) {
        const MbInfo& m = mbs[i];
        ColMb& c = cur->col[i];
        c.intra = is_intra(m);
        for (int l = 0; l < 2; l++)
          for (int j = 0; j < 4; j++) {
            int k = kCorner[j];
            c.ref[l][j] = m.ref[l][k];
            c.mv[l][j][0] = m.mv[l][k][0];
            c.mv[l][j][1] = m.mv[l][k][1];
            c.pic[l][j] = m.pic[l][k];
          }
      }
    }
    int max_frame_num = 1 << active.log2_max_frame_num;
    auto wrap = [&](const Picture& p) {
      return p.frame_num > cur_frame_num ? p.frame_num - max_frame_num : p.frame_num;
    };
    order = next_order;
    if (cur_idr) {
      refs.clear();
      prev_ref_frame_num = 0;
      bump(0);
      have_out_poc = false;
    }
    if (cur_nal_ref) {
      if (marking_adaptive) {  // MMCO op 1: picNumX = CurrPicNum - (difference_of_pic_nums_minus1 + 1)
        for (int diff : unmark) {
          int x = cur_frame_num - (diff + 1);
          auto it = std::find_if(refs.begin(), refs.end(), [&](const auto& p) { return wrap(*p) == x; });
          if (it == refs.end()) fail("a memory management control operation on a picture that is not a reference");
          refs.erase(it);
        }
      } else if (!cur_idr && (int)refs.size() >= std::max(active.max_refs, 1)) {
        // sliding window: the short-term reference of the smallest FrameNumWrap goes
        auto oldest = std::min_element(refs.begin(), refs.end(), [&](const auto& a, const auto& c) {
          return wrap(*a) < wrap(*c);
        });
        refs.erase(oldest);
      }
      if ((int)refs.size() >= std::max(active.max_refs, 1))
        fail("more reference frames than max_num_ref_frames");
      refs.push_back(cur);
      prev_ref_frame_num = cur_frame_num;
    }
    cur->seq = next_seq++;
    cur->packet = packets - 1;
    waiting.push_back(cur);
    bump(active.restriction ? (size_t)active.reorder : 0);
    cur.reset();
  }

  // One access unit; the frames it made ready for output.
  int decode(const uint8_t* data, size_t n) {
    packets++;
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
    size_t before = ready.size();
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
    if (frame) finish_picture();
    return (int)(ready.size() - before);
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

  // The frame taken last, cropped: RGB and luma, either may be null.
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

// Decode one access unit: the number of frames it made ready for output (0,
// 1 or more: output is in POC order), each taken by h264_next.
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

// The end of the stream: every picture still waiting is made ready; returns
// how many.
int h264_flush(void* h, char* err, size_t err_len) {
  Decoder* d = static_cast<Decoder*>(h);
  try {
    size_t before = d->ready.size();
    d->bump(0);
    return (int)(d->ready.size() - before);
  } catch (const CodecError& e) {
    return report(e, err, err_len);
  }
}

// Take the next frame ready for output (h264_frame and h264_planes read it);
// *packet is the h264_decode call (0, 1, ...) whose access unit it is.
// Returns 1 when none is ready.
int h264_next(void* h, int64_t* packet) {
  Decoder* d = static_cast<Decoder*>(h);
  if (d->ready.empty()) return 1;
  d->out = d->ready.front();
  d->ready.pop_front();
  *packet = d->out->packet;
  return 0;
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

// The frame taken last: uint8 RGB [H, W, 3] and luma [H, W] (either may be
// null); -1 before the first one.
int h264_frame(void* h, uint8_t* rgb, uint8_t* luma, char* err, size_t err_len) {
  const Decoder* d = static_cast<Decoder*>(h);
  if (!d->out) return report(CodecError{"no decoded frame", false}, err, err_len);
  d->output(rgb, luma);
  return 0;
}

// The planes of the frame taken last: Y [H, W], U and V [(H + 1) / 2,
// (W + 1) / 2]; -1 before the first one.
int h264_planes(void* h, uint8_t* y, uint8_t* u, uint8_t* v, char* err, size_t err_len) {
  const Decoder* d = static_cast<Decoder*>(h);
  if (!d->out) return report(CodecError{"no decoded frame", false}, err, err_len);
  d->planes(y, u, v);
  return 0;
}

}  // extern "C"
