// What the port's MPEG-4 Part 2 decoder (mpeg4_video.cpp) and encoder
// (mpeg4_encode.cpp) share, so that the encoder rebuilds each VOP with the
// decoder's own arithmetic: the VLC tables as (code, length) pairs, the
// scans and the DC scalers; the integer "simple" IDCT; the half-pel
// prediction from a reference read clamped to its whole macroblocks; and,
// from yuv_rgb.h, the YUV 4:2:0 to RGB conversion of swscale. Plain C++17,
// header only.

#pragma once

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstring>

#include "yuv_rgb.h"

namespace mpeg4 {

// ------------------------------------------------------------------- tables

// MCBPC of I-VOPs: cbpc 0-3, with DQUANT 4-7, stuffing 8.
const uint16_t kIntraMcbpc[9][2] = {{1, 1}, {1, 3}, {2, 3}, {3, 3}, {1, 4},
                                    {1, 6}, {2, 6}, {3, 6}, {1, 9}};
// MCBPC of P-VOPs: inter 0-3, intra 4-7, inter+Q 8-11, intra+Q 12-15,
// inter4v 16-19, stuffing 20, inter4v+Q 24-27 (H.263's).
const uint16_t kInterMcbpc[28][2] = {
    {1, 1}, {3, 4}, {2, 4}, {5, 6}, {3, 5}, {4, 8}, {3, 8}, {3, 7}, {3, 3}, {7, 7},
    {6, 7}, {5, 9}, {4, 6}, {4, 9}, {3, 9}, {2, 9}, {2, 3}, {5, 7}, {4, 7}, {5, 8},
    {1, 9}, {0, 0}, {0, 0}, {0, 0}, {2, 11}, {12, 13}, {14, 13}, {15, 13}};
// CBPY, as coded for intra macroblocks (inverted for inter).
const uint16_t kCbpy[16][2] = {{3, 4}, {5, 5}, {4, 5}, {9, 4}, {3, 5}, {7, 4},
                               {2, 6}, {11, 4}, {2, 5}, {3, 6}, {5, 4}, {10, 4},
                               {4, 4}, {8, 4}, {6, 4}, {3, 2}};
// Motion vector difference magnitudes 0-32 (a sign bit follows all but 0).
const uint16_t kMv[33][2] = {
    {1, 1}, {1, 2}, {1, 3}, {1, 4}, {3, 6}, {5, 7}, {4, 7}, {3, 7}, {11, 9},
    {10, 9}, {9, 9}, {17, 10}, {16, 10}, {15, 10}, {14, 10}, {13, 10}, {12, 10},
    {11, 10}, {10, 10}, {9, 10}, {8, 10}, {7, 10}, {6, 10}, {5, 10}, {4, 10},
    {7, 11}, {6, 11}, {5, 11}, {4, 11}, {3, 11}, {2, 11}, {3, 12}, {2, 12}};
// dct_dc_size_luminance and _chrominance, sizes 0-12.
const uint16_t kDcLum[13][2] = {{3, 3}, {3, 2}, {2, 2}, {2, 3}, {1, 3}, {1, 4}, {1, 5},
                                {1, 6}, {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}};
const uint16_t kDcChrom[13][2] = {{3, 2}, {2, 2}, {1, 2}, {1, 3}, {1, 4}, {1, 5}, {1, 6},
                                  {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}, {1, 12}};

// TCOEF of intra blocks (MPEG-4's table) and of inter blocks (H.263's): 102
// (last, run, level) codes and the escape; the codes from index `last` on
// end the block.
const uint16_t kIntraVlc[103][2] = {
    {0x2, 2},   {0x6, 3},   {0xf, 4},   {0xd, 5},   {0xc, 5},   {0x15, 6},  {0x13, 6},
    {0x12, 6},  {0x17, 7},  {0x1f, 8},  {0x1e, 8},  {0x1d, 8},  {0x25, 9},  {0x24, 9},
    {0x23, 9},  {0x21, 9},  {0x21, 10}, {0x20, 10}, {0xf, 10},  {0xe, 10},  {0x7, 11},
    {0x6, 11},  {0x20, 11}, {0x21, 11}, {0x50, 12}, {0x51, 12}, {0x52, 12}, {0xe, 4},
    {0x14, 6},  {0x16, 7},  {0x1c, 8},  {0x20, 9},  {0x1f, 9},  {0xd, 10},  {0x22, 11},
    {0x53, 12}, {0x55, 12}, {0xb, 5},   {0x15, 7},  {0x1e, 9},  {0xc, 10},  {0x56, 12},
    {0x11, 6},  {0x1b, 8},  {0x1d, 9},  {0xb, 10},  {0x10, 6},  {0x22, 9},  {0xa, 10},
    {0xd, 6},   {0x1c, 9},  {0x8, 10},  {0x12, 7},  {0x1b, 9},  {0x54, 12}, {0x14, 7},
    {0x1a, 9},  {0x57, 12}, {0x19, 8},  {0x9, 10},  {0x18, 8},  {0x23, 11}, {0x17, 8},
    {0x19, 9},  {0x18, 9},  {0x7, 10},  {0x58, 12}, {0x7, 4},   {0xc, 6},   {0x16, 8},
    {0x17, 9},  {0x6, 10},  {0x5, 11},  {0x4, 11},  {0x59, 12}, {0xf, 6},   {0x16, 9},
    {0x5, 10},  {0xe, 6},   {0x4, 10},  {0x11, 7},  {0x24, 11}, {0x10, 7},  {0x25, 11},
    {0x13, 7},  {0x5a, 12}, {0x15, 8},  {0x5b, 12}, {0x14, 8},  {0x13, 8},  {0x1a, 8},
    {0x15, 9},  {0x14, 9},  {0x13, 9},  {0x12, 9},  {0x11, 9},  {0x26, 11}, {0x27, 11},
    {0x5c, 12}, {0x5d, 12}, {0x5e, 12}, {0x5f, 12}, {0x3, 7}};
const int8_t kIntraRun[102] = {
    0,  0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0, 0, 0,
    0,  1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 4,  4,  4,  5, 5, 5,
    6,  6, 6, 7, 7, 7, 8, 8, 9, 9, 10, 11, 12, 13, 14, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1,
    2,  2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20};
const int8_t kIntraLevel[102] = {
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26,
    27, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 1, 2, 3, 4, 5, 1, 2, 3, 4, 1, 2, 3, 1, 2, 3,
    1, 2, 3, 1, 2, 3, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 2, 3, 4, 5, 6, 7, 8, 1, 2, 3,
    1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};
const int kIntraLast = 67;

const uint16_t kInterVlc[103][2] = {
    {0x2, 2},   {0xf, 4},   {0x15, 6},  {0x17, 7},  {0x1f, 8},  {0x25, 9},  {0x24, 9},
    {0x21, 10}, {0x20, 10}, {0x7, 11},  {0x6, 11},  {0x20, 11}, {0x6, 3},   {0x14, 6},
    {0x1e, 8},  {0xf, 10},  {0x21, 11}, {0x50, 12}, {0xe, 4},   {0x1d, 8},  {0xe, 10},
    {0x51, 12}, {0xd, 5},   {0x23, 9},  {0xd, 10},  {0xc, 5},   {0x22, 9},  {0x52, 12},
    {0xb, 5},   {0xc, 10},  {0x53, 12}, {0x13, 6},  {0xb, 10},  {0x54, 12}, {0x12, 6},
    {0xa, 10},  {0x11, 6},  {0x9, 10},  {0x10, 6},  {0x8, 10},  {0x16, 7},  {0x55, 12},
    {0x15, 7},  {0x14, 7},  {0x1c, 8},  {0x1b, 8},  {0x21, 9},  {0x20, 9},  {0x1f, 9},
    {0x1e, 9},  {0x1d, 9},  {0x1c, 9},  {0x1b, 9},  {0x1a, 9},  {0x22, 11}, {0x23, 11},
    {0x56, 12}, {0x57, 12}, {0x7, 4},   {0x19, 9},  {0x5, 11},  {0xf, 6},   {0x4, 11},
    {0xe, 6},   {0xd, 6},   {0xc, 6},   {0x13, 7},  {0x12, 7},  {0x11, 7},  {0x10, 7},
    {0x1a, 8},  {0x19, 8},  {0x18, 8},  {0x17, 8},  {0x16, 8},  {0x15, 8},  {0x14, 8},
    {0x13, 8},  {0x18, 9},  {0x17, 9},  {0x16, 9},  {0x15, 9},  {0x14, 9},  {0x13, 9},
    {0x12, 9},  {0x11, 9},  {0x7, 10},  {0x6, 10},  {0x5, 10},  {0x4, 10},  {0x24, 11},
    {0x25, 11}, {0x26, 11}, {0x27, 11}, {0x58, 12}, {0x59, 12}, {0x5a, 12}, {0x5b, 12},
    {0x5c, 12}, {0x5d, 12}, {0x5e, 12}, {0x5f, 12}, {0x3, 7}};
const int8_t kInterRun[102] = {
    0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  1,  1,  1,  1,  1,  1,  2,  2,  2,
    2,  3,  3,  3,  4,  4,  4,  5,  5,  5,  6,  6,  6,  7,  7,  8,  8,  9,  9,  10, 10,
    11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 0,  0,  0,  1,  1,
    2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22,
    23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40};
const int8_t kInterLevel[102] = {
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 1, 2, 3, 4, 5, 6, 1, 2, 3, 4, 1, 2, 3, 1,
    2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 2, 3, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};
const int kInterLast = 58;

const uint8_t kZigzag[64] = {0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
                             12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
                             35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
                             58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
const uint8_t kAltHorizontal[64] = {
    0,  1,  2,  3,  8,  9,  16, 17, 10, 11, 4,  5,  6,  7,  15, 14, 13, 12, 19, 18, 24, 25,
    32, 33, 26, 27, 20, 21, 22, 23, 28, 29, 30, 31, 34, 35, 40, 41, 48, 49, 42, 43, 36, 37,
    38, 39, 44, 45, 46, 47, 50, 51, 56, 57, 58, 59, 52, 53, 54, 55, 60, 61, 62, 63};
const uint8_t kAltVertical[64] = {
    0,  8,  16, 24, 1,  9,  2,  10, 17, 25, 32, 40, 48, 56, 57, 49, 41, 33, 26, 18, 3,  11,
    4,  12, 19, 27, 34, 42, 50, 58, 35, 43, 51, 59, 20, 28, 5,  13, 6,  14, 21, 29, 36, 44,
    52, 60, 37, 45, 53, 61, 22, 30, 7,  15, 23, 31, 38, 46, 54, 62, 39, 47, 55, 63};

// intra_dc_vlc_thr -> the QP from which intra DC is coded as an AC coefficient
const int kDcThreshold[8] = {99, 13, 15, 17, 19, 21, 23, 0};

inline int luma_dc_scale(int q) { return q < 5 ? 8 : q < 9 ? 2 * q : q < 25 ? q + 8 : 2 * q - 16; }
inline int chroma_dc_scale(int q) { return q < 5 ? 8 : q < 25 ? (q + 13) / 2 : q - 6; }

// ------------------------------------------------------------------- IDCT

// FFmpeg's simple IDCT for 8-bit samples (simple_idct_template.c): rows with
// only a DC take the shortcut of their own rounding, and the products sum
// in 32 bits, as there.
constexpr int W1 = 22725, W2 = 21407, W3 = 19266, W4 = 16383, W5 = 12873, W6 = 8867, W7 = 4520;
constexpr int ROW_SHIFT = 11, COL_SHIFT = 20, DC_SHIFT = 3;

inline void idct_row(int16_t* row) {
  bool ac = false;
  for (int i = 1; i < 8; i++) ac |= row[i] != 0;
  if (!ac) {
    int16_t t = (int16_t)(uint16_t)((row[0] * (1 << DC_SHIFT)) & 0xffff);
    for (int i = 0; i < 8; i++) row[i] = t;
    return;
  }
  uint32_t a0 = (uint32_t)W4 * row[0] + (1u << (ROW_SHIFT - 1));
  uint32_t a1 = a0, a2 = a0, a3 = a0;
  a0 += (uint32_t)W2 * row[2];
  a1 += (uint32_t)W6 * row[2];
  a2 -= (uint32_t)W6 * row[2];
  a3 -= (uint32_t)W2 * row[2];
  uint32_t b0 = (uint32_t)W1 * row[1] + (uint32_t)W3 * row[3];
  uint32_t b1 = (uint32_t)W3 * row[1] - (uint32_t)W7 * row[3];
  uint32_t b2 = (uint32_t)W5 * row[1] - (uint32_t)W1 * row[3];
  uint32_t b3 = (uint32_t)W7 * row[1] - (uint32_t)W5 * row[3];
  a0 += (uint32_t)W4 * row[4] + (uint32_t)W6 * row[6];
  a1 += -(uint32_t)W4 * row[4] - (uint32_t)W2 * row[6];
  a2 += -(uint32_t)W4 * row[4] + (uint32_t)W2 * row[6];
  a3 += (uint32_t)W4 * row[4] - (uint32_t)W6 * row[6];
  b0 += (uint32_t)W5 * row[5] + (uint32_t)W7 * row[7];
  b1 += -(uint32_t)W1 * row[5] - (uint32_t)W5 * row[7];
  b2 += (uint32_t)W7 * row[5] + (uint32_t)W3 * row[7];
  b3 += (uint32_t)W3 * row[5] - (uint32_t)W1 * row[7];
  row[0] = (int16_t)((int32_t)(a0 + b0) >> ROW_SHIFT);
  row[7] = (int16_t)((int32_t)(a0 - b0) >> ROW_SHIFT);
  row[1] = (int16_t)((int32_t)(a1 + b1) >> ROW_SHIFT);
  row[6] = (int16_t)((int32_t)(a1 - b1) >> ROW_SHIFT);
  row[2] = (int16_t)((int32_t)(a2 + b2) >> ROW_SHIFT);
  row[5] = (int16_t)((int32_t)(a2 - b2) >> ROW_SHIFT);
  row[3] = (int16_t)((int32_t)(a3 + b3) >> ROW_SHIFT);
  row[4] = (int16_t)((int32_t)(a3 - b3) >> ROW_SHIFT);
}

inline uint8_t clip8(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

// The 8 outputs of column `c` of `blk` (after the row pass).
inline void idct_col(const int16_t* col, int out[8]) {
  uint32_t a0 = (uint32_t)W4 * (uint32_t)(col[0] + ((1 << (COL_SHIFT - 1)) / W4));
  uint32_t a1 = a0, a2 = a0, a3 = a0;
  a0 += (uint32_t)W2 * col[16];
  a1 += (uint32_t)W6 * col[16];
  a2 += -(uint32_t)W6 * col[16];
  a3 += -(uint32_t)W2 * col[16];
  uint32_t b0 = (uint32_t)W1 * col[8] + (uint32_t)W3 * col[24];
  uint32_t b1 = (uint32_t)W3 * col[8] - (uint32_t)W7 * col[24];
  uint32_t b2 = (uint32_t)W5 * col[8] - (uint32_t)W1 * col[24];
  uint32_t b3 = (uint32_t)W7 * col[8] - (uint32_t)W5 * col[24];
  a0 += (uint32_t)W4 * col[32];
  a1 += -(uint32_t)W4 * col[32];
  a2 += -(uint32_t)W4 * col[32];
  a3 += (uint32_t)W4 * col[32];
  b0 += (uint32_t)W5 * col[40];
  b1 += -(uint32_t)W1 * col[40];
  b2 += (uint32_t)W7 * col[40];
  b3 += (uint32_t)W3 * col[40];
  a0 += (uint32_t)W6 * col[48];
  a1 += -(uint32_t)W2 * col[48];
  a2 += (uint32_t)W2 * col[48];
  a3 += -(uint32_t)W6 * col[48];
  b0 += (uint32_t)W7 * col[56];
  b1 += -(uint32_t)W5 * col[56];
  b2 += (uint32_t)W3 * col[56];
  b3 += -(uint32_t)W1 * col[56];
  out[0] = (int32_t)(a0 + b0) >> COL_SHIFT;
  out[1] = (int32_t)(a1 + b1) >> COL_SHIFT;
  out[2] = (int32_t)(a2 + b2) >> COL_SHIFT;
  out[3] = (int32_t)(a3 + b3) >> COL_SHIFT;
  out[4] = (int32_t)(a3 - b3) >> COL_SHIFT;
  out[5] = (int32_t)(a2 - b2) >> COL_SHIFT;
  out[6] = (int32_t)(a1 - b1) >> COL_SHIFT;
  out[7] = (int32_t)(a0 - b0) >> COL_SHIFT;
}

// IDCT of `blk` (raster order) written (add = false) or added with clamping
// (add = true) to the 8x8 block at `dst`.
inline void idct(int16_t* blk, uint8_t* dst, int stride, bool add) {
  for (int i = 0; i < 8; i++) idct_row(blk + 8 * i);
  for (int c = 0; c < 8; c++) {
    int out[8];
    idct_col(blk + c, out);
    for (int r = 0; r < 8; r++) {
      uint8_t* p = dst + r * stride + c;
      *p = clip8(add ? *p + out[r] : out[r]);
    }
  }
}

// ------------------------------------------------------------ prediction

// The chroma vector of a luma vector (half-pel units): (mv >> 1) | (mv & 1).
inline int chroma_mv(int mv) { return (mv >> 1) | (mv & 1); }

// Half-pel prediction of the w x w block (w <= 16) at (x + mvx/2, y + mvy/2)
// of a plane `src` of ew x eh samples (its whole macroblocks), coordinates
// clamped to it; rnd is the VOP's rounding_type. Written to dst. Returns
// whether the block read outside the plane.
inline bool predict_block(const uint8_t* src, int stride, int ew, int eh, int x, int y, int mvx,
                          int mvy, int w, int rnd, uint8_t* dst, int dstride) {
  int sx = x + (mvx >> 1), sy = y + (mvy >> 1), fx = mvx & 1, fy = mvy & 1;
  uint8_t tmp[17 * 17];
  const uint8_t* q;
  int qs;
  bool outside = !(sx >= 0 && sy >= 0 && sx + w + fx <= ew && sy + w + fy <= eh);
  if (!outside) {
    q = src + (size_t)sy * stride + sx;
    qs = stride;
  } else {
    for (int r = 0; r <= w; r++) {
      int yy = std::min(std::max(sy + r, 0), eh - 1);
      for (int c = 0; c <= w; c++) {
        int xx = std::min(std::max(sx + c, 0), ew - 1);
        tmp[r * 17 + c] = src[(size_t)yy * stride + xx];
      }
    }
    q = tmp;
    qs = 17;
  }
  for (int r = 0; r < w; r++) {
    const uint8_t* a = q + r * qs;
    const uint8_t* c = a + qs;
    uint8_t* o = dst + (size_t)r * dstride;
    if (!fx && !fy) {
      memcpy(o, a, w);
    } else if (fx && !fy) {
      for (int k = 0; k < w; k++) o[k] = (uint8_t)((a[k] + a[k + 1] + 1 - rnd) >> 1);
    } else if (!fx && fy) {
      for (int k = 0; k < w; k++) o[k] = (uint8_t)((a[k] + c[k] + 1 - rnd) >> 1);
    } else {
      for (int k = 0; k < w; k++)
        o[k] = (uint8_t)((a[k] + a[k + 1] + c[k] + c[k + 1] + 2 - rnd) >> 2);
    }
  }
  return outside;
}

using yuv::yuv420_to_rgb;

}  // namespace mpeg4
