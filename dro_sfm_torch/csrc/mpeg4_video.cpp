// Host MPEG-4 Part 2 (ISO/IEC 14496-2) video decoder of the port, in plain
// C++ with a C interface (loaded with ctypes, which releases the interpreter
// lock around each call). It decodes the Simple and Advanced Simple Profile
// streams that FFmpeg's "mpeg4" encoder and XviD (libxvidcore) write (fourcc
// mp4v, FMP4, XVID, DIVX, DX50), as FFmpeg's decoder decodes them with its
// defaults, frame for frame:
//   * I-, P- and B-VOPs, rectangular 8-bit 4:2:0 progressive video;
//   * intra DC by its size VLCs, gradient-selected DC prediction and the
//     dc_scaler of the QP; AC prediction of the first row or column,
//     rescaled where the neighbour's QP differs; the three TCOEF escapes;
//     the zigzag and alternate scans;
//   * H.263 quantisation, and MPEG quantisation (quant_type 1) with the
//     default or the VOL's matrices, dequantised as FFmpeg's
//     dct_unquantize_mpeg2_intra (no mismatch control) and _inter (the
//     mismatch control of the last coefficient) at MPEG-2's quantiser_scale
//     of twice the QP;
//   * one or four motion vectors a macroblock, their median prediction with
//     f_code range wrapping; half-sample motion compensation with
//     rounding_type, or quarter sample (MPEG-4's 8-tap filter with its
//     mirrored block edges); the chroma vector of four vectors from their
//     sum by H.263's rounding table; unrestricted vectors read from the
//     reference with coordinates clamped to its whole macroblocks (FFmpeg's
//     h_edge_pos and v_edge_pos), an 8x8 block's first clipped to the VOL
//     size as FFmpeg clips it;
//   * B-VOPs: MODB, MBTYPE and DBQUANT, forward, backward and interpolated
//     prediction, direct mode from the co-located macroblock's one or four
//     vectors scaled by TRB/TRD from the VOP times, the macroblocks whose
//     co-located one was skipped; frames out in display order, one behind;
//   * video packets (resync markers, macroblock_number, quant_scale, the
//     header extension), prediction held inside its packet as FFmpeg holds
//     it, and data partitioning (without RVLC);
//   * DivX/XviD packed B-frames (user data "DivX...p"): the VOP after the
//     first in a packet is kept and decoded with the next packet, as
//     FFmpeg's decoder does; a VOP not coded (N-VOP) gives no frame;
//   * the encoder's identity from its user data (Lavc, XviD, DivX, FFmpeg):
//     an XviD stream runs FFmpeg's XviD IDCT (ff_xvid_idct), the others the
//     integer "simple" IDCT (simple_idct_template.c, 8 bits);
//   * output cropped to the VOL size; RGB as swscale converts yuv420p to
//     bgr24 at the same size (BT.601, limited range, its SSSE3 path: each
//     term 16-bit fixed point, the chroma of each 2x2 luma block shared).
//   * GMC S-VOPs (sprite_enable 2) of three warping points, as XviD writes
//     them: the affine warp of the sprite trajectory, bilinear (ff_gmc_c),
//     the macroblocks it predicts (mcsel, and the skipped ones) with their
//     mean vector for their neighbours;
// Refused with a message (-2): static sprites, GMC of another number of
// warping points, of a warp FFmpeg reduces to a translation (gmc1) or with
// brightness change, interlace,
// RVLC, OBMC, the short video header (H.263), not_8_bit, a non-rectangular
// shape, scalability, newpred, reduced resolution, complexity estimation,
// chroma other than 4:2:0, and the builds for which FFmpeg turns on a bug
// workaround (old XviD, DivX and libavcodec builds, and the fourccs that
// imply one). A truncated or corrupt stream fails (-1): every bit read and
// every motion vector is bounds-checked.
//
// Every entry point returns 0 on success (m4v_decode and m4v_flush: the
// number of frames made ready, 0 or 1), else -1 (a broken stream) or -2 (a
// valid one that is not supported) with a message in err. The decoder keeps
// its reference frames between calls; the frame a call made ready is taken
// (m4v_next) before the next call, which drops it otherwise.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <string>
#include <vector>

#include "mpeg4_tables.h"

namespace {

using namespace mpeg4;

struct CodecError {
  std::string msg;
  bool unsupported;
};

[[noreturn]] void fail(const std::string& msg) { throw CodecError{msg, false}; }
[[noreturn]] void unsupported(const std::string& msg) {
  throw CodecError{msg + " is not supported by the port's MPEG-4 decoder (ROADMAP A22)", true};
}

// ---------------------------------------------------------------- bit reader

struct Bits {
  const uint8_t* data;
  size_t bits;     // bits in the buffer
  size_t pos = 0;  // next bit

  Bits(const uint8_t* d, size_t n) : data(d), bits(n * 8) {}

  // The next k (<= 25) bits, zeros past the end.
  uint32_t peek(int k) const {
    uint32_t v = 0;
    size_t byte = pos >> 3;
    for (int i = 0; i < 4; i++) v = (v << 8) | (byte + i < bits / 8 ? data[byte + i] : 0);
    return (v << (pos & 7)) >> (32 - k);
  }
  void skip(int k) {
    if (pos + k > bits) fail("truncated MPEG-4 stream");
    pos += k;
  }
  uint32_t get(int k) {
    if (k == 0) return 0;
    uint32_t v = peek(k);
    skip(k);
    return v;
  }
  int get1() { return (int)get(1); }
  // get_xbits: k bits, read as negative when the first is 0
  int xbits(int k) {
    int v = (int)get(k);
    return (v >> (k - 1)) ? v : v - (1 << k) + 1;
  }
  void align() { pos = (pos + 7) & ~(size_t)7; }
  size_t left() const { return bits - pos; }
};

// ------------------------------------------------------------------- VLCs

// A code table (code, length) of n symbols, decoded by one lookup of the
// longest code's width.
struct Vlc {
  int width = 0;
  std::vector<int16_t> sym, len;

  void init(const uint16_t (*codes)[2], int n) {
    width = 0;
    for (int i = 0; i < n; i++) width = std::max(width, (int)codes[i][1]);
    sym.assign((size_t)1 << width, -1);
    len.assign((size_t)1 << width, 0);
    for (int i = 0; i < n; i++) {
      int l = codes[i][1];
      if (l == 0) continue;
      uint32_t first = (uint32_t)codes[i][0] << (width - l);
      for (uint32_t j = 0; j < (1u << (width - l)); j++) {
        sym[first + j] = (int16_t)i;
        len[first + j] = (int16_t)l;
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

// One TCOEF table with its escape limits: LMAX by (last, run) and RMAX by
// (last, level).
struct Tcoef {
  Vlc vlc;
  const int8_t* run;
  const int8_t* level;
  int last;
  int max_level[2][64];
  int max_run[2][65];

  void init(const uint16_t (*codes)[2], const int8_t* r, const int8_t* l, int lst) {
    vlc.init(codes, 103);
    run = r;
    level = l;
    last = lst;
    memset(max_level, 0, sizeof max_level);
    memset(max_run, 0, sizeof max_run);
    for (int i = 0; i < 102; i++) {
      int k = i >= lst;
      max_level[k][run[i]] = std::max(max_level[k][run[i]], (int)level[i]);
      max_run[k][level[i]] = std::max(max_run[k][level[i]], (int)run[i]);
    }
  }
};

// MBTYPE of B-VOPs: direct, interpolated, backward, forward.
const uint16_t kBType[4][2] = {{1, 1}, {1, 2}, {1, 3}, {1, 4}};
// dmv_length of a sprite trajectory point, 0-14.
const uint16_t kSpriteTrajectory[15][2] = {{0, 2},    {2, 3},    {3, 3},     {4, 3},    {5, 3},
                                           {6, 3},    {14, 4},   {30, 5},    {62, 6},   {126, 7},
                                           {254, 8},  {510, 9},  {1022, 10}, {2046, 11}, {4094, 12}};

struct Tables {
  Vlc intra_mcbpc, inter_mcbpc, cbpy, mv, dc_lum, dc_chrom, b_type, sprite;
  Tcoef intra, inter;
  Tables() {
    intra_mcbpc.init(kIntraMcbpc, 9);
    inter_mcbpc.init(kInterMcbpc, 28);
    cbpy.init(kCbpy, 16);
    mv.init(kMv, 33);
    dc_lum.init(kDcLum, 13);
    dc_chrom.init(kDcChrom, 13);
    b_type.init(kBType, 4);
    sprite.init(kSpriteTrajectory, 15);
    intra.init(kIntraVlc, kIntraRun, kIntraLevel, kIntraLast);
    inter.init(kInterVlc, kInterRun, kInterLevel, kInterLast);
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

// The default matrices of MPEG quantisation (raster order).
const uint8_t kDefaultIntraMatrix[64] = {
    8,  17, 18, 19, 21, 23, 25, 27, 17, 18, 19, 21, 23, 25, 27, 28, 20, 21, 22, 23, 24, 26,
    28, 30, 21, 22, 23, 24, 26, 28, 30, 32, 22, 23, 24, 26, 28, 30, 32, 35, 23, 24, 26, 28,
    30, 32, 35, 38, 25, 26, 28, 30, 32, 35, 38, 41, 27, 28, 30, 32, 35, 38, 41, 45};
const uint8_t kDefaultInterMatrix[64] = {
    16, 17, 18, 19, 20, 21, 22, 23, 17, 18, 19, 20, 21, 22, 23, 24, 18, 19, 20, 21, 22, 23,
    24, 25, 19, 20, 21, 22, 23, 24, 26, 27, 20, 21, 22, 23, 25, 26, 27, 28, 21, 22, 23, 24,
    26, 27, 28, 30, 22, 23, 24, 26, 27, 28, 30, 31, 23, 24, 25, 27, 28, 30, 31, 33};

// ------------------------------------------------------------- XviD IDCT

// FFmpeg's ff_xvid_idct (xvididct.c), which its decoder runs for a stream
// whose user data names an XviD build: rows by the four cosine tables with
// their own rounders, columns by the tangent butterflies in 16.16 fixed
// point (the precision of the SSE2 version's pmulhw).
const int kXvidTab04[7] = {22725, 21407, 19266, 16384, 12873, 8867, 4520};
const int kXvidTab17[7] = {31521, 29692, 26722, 22725, 17855, 12299, 6270};
const int kXvidTab26[7] = {29692, 27969, 25172, 21407, 16819, 11585, 5906};
const int kXvidTab35[7] = {26722, 25172, 22654, 19266, 15137, 10426, 5315};

inline void xvid_row(int16_t* in, const int* tab, int rnd) {
  const int c1 = tab[0], c2 = tab[1], c3 = tab[2], c4 = tab[3], c5 = tab[4], c6 = tab[5],
            c7 = tab[6];
  const int k = c4 * in[0] + rnd;
  const int a0 = k + c2 * in[2] + c4 * in[4] + c6 * in[6];
  const int a1 = k + c6 * in[2] - c4 * in[4] - c2 * in[6];
  const int a2 = k - c6 * in[2] - c4 * in[4] + c2 * in[6];
  const int a3 = k - c2 * in[2] + c4 * in[4] - c6 * in[6];
  const int b0 = c1 * in[1] + c3 * in[3] + c5 * in[5] + c7 * in[7];
  const int b1 = c3 * in[1] - c7 * in[3] - c1 * in[5] - c5 * in[7];
  const int b2 = c5 * in[1] - c1 * in[3] + c7 * in[5] + c3 * in[7];
  const int b3 = c7 * in[1] - c5 * in[3] + c3 * in[5] - c1 * in[7];
  in[0] = (int16_t)((a0 + b0) >> 11);
  in[1] = (int16_t)((a1 + b1) >> 11);
  in[2] = (int16_t)((a2 + b2) >> 11);
  in[3] = (int16_t)((a3 + b3) >> 11);
  in[4] = (int16_t)((a3 - b3) >> 11);
  in[5] = (int16_t)((a2 - b2) >> 11);
  in[6] = (int16_t)((a1 - b1) >> 11);
  in[7] = (int16_t)((a0 - b0) >> 11);
}

inline int xmul(int c, int x) { return (c * x) >> 16; }

inline void xvid_col(int16_t* in) {
  const int kTan1 = 0x32EC, kTan2 = 0x6A0A, kTan3 = 0xAB0E, kSqrt2 = 0x5A82;
  int mm4 = in[7 * 8], mm5 = in[5 * 8], mm6 = in[3 * 8], mm7 = in[1 * 8];
  int mm0 = xmul(kTan1, mm4) + mm7;
  int mm1 = xmul(kTan1, mm7) - mm4;
  int mm2 = xmul(kTan3, mm5) + mm6;
  int mm3 = xmul(kTan3, mm6) - mm5;
  mm7 = mm0 + mm2;
  mm4 = mm1 - mm3;
  mm0 = mm0 - mm2;
  mm1 = mm1 + mm3;
  mm6 = mm0 + mm1;
  mm5 = mm0 - mm1;
  mm5 = 2 * xmul(kSqrt2, mm5);
  mm6 = 2 * xmul(kSqrt2, mm6);
  mm1 = in[2 * 8];
  mm2 = in[6 * 8];
  mm3 = xmul(kTan2, mm2) + mm1;
  mm2 = xmul(kTan2, mm1) - mm2;
  mm0 = in[0] + in[4 * 8];
  mm1 = in[0] - in[4 * 8];
  int t = mm0 + mm3;
  mm3 = mm0 - mm3;
  mm0 = t;
  t = mm0 + mm7;
  mm7 = mm0 - mm7;
  mm0 = t;
  in[0] = (int16_t)(mm0 >> 6);
  in[7 * 8] = (int16_t)(mm7 >> 6);
  t = mm3 + mm4;
  mm4 = mm3 - mm4;
  mm3 = t;
  in[3 * 8] = (int16_t)(mm3 >> 6);
  in[4 * 8] = (int16_t)(mm4 >> 6);
  t = mm1 + mm2;
  mm2 = mm1 - mm2;
  mm1 = t;
  t = mm1 + mm6;
  mm6 = mm1 - mm6;
  mm1 = t;
  in[1 * 8] = (int16_t)(mm1 >> 6);
  in[6 * 8] = (int16_t)(mm6 >> 6);
  t = mm2 + mm5;
  mm5 = mm2 - mm5;
  mm2 = t;
  in[2 * 8] = (int16_t)(mm2 >> 6);
  in[5 * 8] = (int16_t)(mm5 >> 6);
}

// The XviD IDCT of `blk` written (add = false) or added with clamping to
// the 8x8 block at `dst`.
inline void xvid_idct_8x8(int16_t* blk, uint8_t* dst, int stride, bool add) {
  static const int* const kTabs[8] = {kXvidTab04, kXvidTab17, kXvidTab26, kXvidTab35,
                                      kXvidTab04, kXvidTab35, kXvidTab26, kXvidTab17};
  static const int kRnd[8] = {65536, 3597, 2260, 1203, 0, 120, 512, 512};
  for (int r = 0; r < 8; r++) xvid_row(blk + 8 * r, kTabs[r], kRnd[r]);
  for (int c = 0; c < 8; c++) xvid_col(blk + c);
  for (int r = 0; r < 8; r++)
    for (int c = 0; c < 8; c++) {
      uint8_t* p = dst + r * stride + c;
      *p = clip8(add ? *p + blk[8 * r + c] : blk[8 * r + c]);
    }
}

// ------------------------------------------------------- motion compensation

// The w x h samples at (x, y) of a plane of ew x eh samples (its whole
// macroblocks), read with coordinates clamped to it (FFmpeg's
// emulated_edge_mc) into buf (stride 24) where they reach outside; returns
// the block to read and its stride.
inline const uint8_t* fetch(const uint8_t* src, int stride, int ew, int eh, int x, int y, int w,
                            int h, uint8_t* buf, int& out_stride) {
  if (x >= 0 && y >= 0 && x + w <= ew && y + h <= eh) {
    out_stride = stride;
    return src + (size_t)y * stride + x;
  }
  for (int r = 0; r < h; r++) {
    int yy = std::min(std::max(y + r, 0), eh - 1);
    for (int c = 0; c < w; c++) {
      int xx = std::min(std::max(x + c, 0), ew - 1);
      buf[r * 24 + c] = src[(size_t)yy * stride + xx];
    }
  }
  out_stride = 24;
  return buf;
}

// Write (avg = false) or average with rounding up (avg = true) the w x h
// block `p` into dst.
inline void store(uint8_t* dst, int ds, const uint8_t* p, int ps, int w, int h, bool avg) {
  for (int r = 0; r < h; r++)
    for (int c = 0; c < w; c++) {
      uint8_t v = p[r * ps + c];
      uint8_t& o = dst[(size_t)r * ds + c];
      o = avg ? (uint8_t)((o + v + 1) >> 1) : v;
    }
}

// Half-sample prediction of a w x h block from q (its (w + 1) x (h + 1)
// samples), dxy = x half | y half << 1; rnd 0 rounds up (rounding_type 0).
inline void hpel(uint8_t* dst, int ds, const uint8_t* q, int qs, int w, int h, int dxy, int rnd,
                 bool avg) {
  uint8_t tmp[16 * 16];
  uint8_t* out = avg ? tmp : dst;
  const int os = avg ? 16 : ds;
  for (int r = 0; r < h; r++) {
    const uint8_t* a = q + r * qs;
    const uint8_t* c = a + qs;
    uint8_t* o = out + (size_t)os * r;
    if (dxy == 0)
      memcpy(o, a, w);
    else if (dxy == 1)
      for (int k = 0; k < w; k++) o[k] = (uint8_t)((a[k] + a[k + 1] + 1 - rnd) >> 1);
    else if (dxy == 2)
      for (int k = 0; k < w; k++) o[k] = (uint8_t)((a[k] + c[k] + 1 - rnd) >> 1);
    else
      for (int k = 0; k < w; k++)
        o[k] = (uint8_t)((a[k] + a[k + 1] + c[k] + c[k + 1] + 2 - rnd) >> 2);
  }
  if (avg) store(dst, ds, tmp, 16, w, h, true);
}

// MPEG-4's quarter-sample filter (FFmpeg's qpeldsp): the half-sample value
// between samples k and k + 1 of a row of n + 1 samples, mirrored at its
// ends, over 32.
inline int qtap(const uint8_t* s, int step, int n, int k) {
  auto at = [&](int i) { return (int)s[(i < 0 ? -1 - i : i > n ? 2 * n + 1 - i : i) * step]; };
  return (at(k) + at(k + 1)) * 20 - (at(k - 1) + at(k + 2)) * 6 + (at(k - 2) + at(k + 3)) * 3 -
         (at(k - 3) + at(k + 4));
}

// The horizontal half-sample filter of w columns over h rows of src.
inline void qh(uint8_t* dst, int ds, const uint8_t* src, int ss, int w, int h, int rnd) {
  for (int r = 0; r < h; r++)
    for (int k = 0; k < w; k++) dst[r * ds + k] = clip8((qtap(src + r * ss, 1, w, k) + 16 - rnd) >> 5);
}

// The vertical half-sample filter of w columns over w rows of src.
inline void qv(uint8_t* dst, int ds, const uint8_t* src, int ss, int w, int rnd) {
  for (int c = 0; c < w; c++)
    for (int k = 0; k < w; k++) dst[k * ds + c] = clip8((qtap(src + c, ss, w, k) + 16 - rnd) >> 5);
}

// The average of two blocks, rounding up unless rnd.
inline void l2(uint8_t* dst, int ds, const uint8_t* a, int as, const uint8_t* b, int bs, int w,
               int h, int rnd) {
  for (int r = 0; r < h; r++)
    for (int c = 0; c < w; c++)
      dst[r * ds + c] = (uint8_t)((a[r * as + c] + b[r * bs + c] + 1 - rnd) >> 1);
}

// Quarter-sample prediction of a w x w block (w 8 or 16) from q (its
// (w + 1) x (w + 1) samples), dxy = x quarter | y quarter << 2, as FFmpeg's
// qpel{8,16}_mc{x}{y}: rnd 0 for put and avg, 1 for put_no_rnd.
inline void qpel(uint8_t* dst, int ds, const uint8_t* q, int qs, int w, int dxy, int rnd,
                 bool avg) {
  const int x = dxy & 3, y = dxy >> 2;
  uint8_t half[17 * 17], hv[16 * 16], out[16 * 16];
  const int S = 17;
  if (x == 0 && y == 0) {
    store(dst, ds, q, qs, w, w, avg);
    return;
  }
  if (y == 0) {  // horizontal only
    qh(half, S, q, qs, w, w, rnd);
    if (x == 2)
      store(dst, ds, half, S, w, w, avg);
    else {
      l2(out, 16, q + (x == 3), qs, half, S, w, w, rnd);
      store(dst, ds, out, 16, w, w, avg);
    }
    return;
  }
  if (x == 0) {  // vertical only
    qv(half, S, q, qs, w, rnd);
    if (y == 2)
      store(dst, ds, half, S, w, w, avg);
    else {
      l2(out, 16, q + (y == 3) * qs, qs, half, S, w, w, rnd);
      store(dst, ds, out, 16, w, w, avg);
    }
    return;
  }
  // both: w + 1 rows filtered horizontally (averaged with the full samples
  // at a quarter position), then vertically
  qh(half, S, q, qs, w, w + 1, rnd);
  if (x != 2) l2(half, S, half, S, q + (x == 3), qs, w, w + 1, rnd);
  qv(hv, 16, half, S, w, rnd);
  if (y == 2) {
    store(dst, ds, hv, 16, w, w, avg);
  } else {
    l2(out, 16, half + (y == 3) * S, S, hv, 16, w, w, rnd);
    store(dst, ds, out, 16, w, w, avg);
  }
}

// H.263's chroma vector of the sum of four luma vectors (half-sample
// units): a sixteenth-sample position rounded by its table.
inline int round_chroma(int x) {
  static const uint8_t kTab[16] = {0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2};
  return kTab[x & 15] + ((x >> 3) & ~1);
}

// FFmpeg's ff_gmc_c: the 8 x h block of an affine warp, position (ox, oy)
// and steps in 16.16 fixed point of 1 / 2^shift samples, bilinear, read from
// the w x h plane `src` with coordinates clamped to it.
inline void gmc(uint8_t* dst, int ds, const uint8_t* src, int stride, int h, int ox, int oy,
                int dxx, int dxy, int dyx, int dyy, int shift, int r, int width, int height) {
  const int s = 1 << shift;
  auto at = [&](int x, int y) {
    return (int)src[(size_t)std::min(std::max(y, 0), height - 1) * stride +
                    std::min(std::max(x, 0), width - 1)];
  };
  for (int y = 0; y < h; y++) {
    int vx = ox, vy = oy;
    for (int x = 0; x < 8; x++) {
      int sx = vx >> 16, sy = vy >> 16;
      int fx = sx & (s - 1), fy = sy & (s - 1);
      sx >>= shift;
      sy >>= shift;
      dst[(size_t)y * ds + x] =
          (uint8_t)(((at(sx, sy) * (s - fx) + at(sx + 1, sy) * fx) * (s - fy) +
                     (at(sx, sy + 1) * (s - fx) + at(sx + 1, sy + 1) * fx) * fy + r) >>
                    (2 * shift));
      vx += dxx;
      vy += dyx;
    }
    ox += dxy;
    oy += dyy;
  }
}

inline int64_t rounded_div(int64_t a, int64_t b) { return (a >= 0 ? a + (b >> 1) : a - (b >> 1)) / b; }
inline int rshift(int a, int b) {
  return a > 0 ? (a + ((1 << b) >> 1)) >> b : (a + ((1 << b) >> 1) - 1) >> b;
}

// ---------------------------------------------------------------- decoder

inline int median3(int a, int b, int c) {
  return std::max(std::min(a, b), std::min(std::max(a, b), c));
}

// A decoded picture: its planes at whole macroblocks, and for direct mode
// the vectors of its 8x8 blocks and the kind of each macroblock.
struct Picture {
  std::vector<uint8_t> plane[3];
  std::vector<int16_t> mv;    // 2 a block, (2 mb_w) x (2 mb_h) blocks
  std::vector<uint8_t> kind;  // a macroblock: MB_INTRA, MB_4MV, MB_SKIP bits
  int64_t packet = 0;
};

enum { MB_INTRA = 1, MB_4MV = 2, MB_SKIP = 4 };
enum { VOP_I = 0, VOP_P = 1, VOP_B = 2, VOP_S = 3 };

// A frame made ready for output: its planes (cropped later) and packet.
struct Ready {
  std::vector<uint8_t> plane[3];
  int64_t packet;
};

struct Decoder {
  // VOL
  bool have_vol = false;
  int width = 0, height = 0, mb_w = 0, mb_h = 0, mb_num = 0;
  int time_bits = 1, resolution = 1;
  int vo_type = 0;
  bool vol_control = false, low_delay = false;
  bool quarter_sample = false, mpeg_quant = false, partitioning = false, resync_marker = false;
  bool gmc_vol = false;  // sprite_enable GMC
  int sprite_points = 0, sprite_accuracy = 0;
  // the S-VOP's warp (FFmpeg's sprite_offset, sprite_delta, sprite_shift)
  int sprite_offset[2][2] = {{0, 0}, {0, 0}}, sprite_delta[2][2] = {{0, 0}, {0, 0}};
  int sprite_shift[2] = {0, 0};
  uint8_t intra_matrix[64], inter_matrix[64];
  // the encoder, from the user data and the container's fourcc
  std::string encoder;
  int xvid_build = -1, divx_version = -1, divx_build = -1, lavc_build = -1;
  bool divx_packed = false, xvid_idct = false;
  uint32_t tag = 0;
  // pictures: the forward (last) and backward (next) references, the one
  // being decoded
  Picture pics[3];
  int last = -1, next = -1, cur = -1;
  int stride[3] = {0, 0, 0};
  int64_t picture_number = 0;
  bool skipped_last_frame = false;
  // VOP times (FFmpeg's time_base, last_time_base, time, last_non_b_time,
  // pp_time, pb_time)
  int64_t time_base = 0, last_time_base = 0, time = 0, last_non_b_time = 0;
  int pp_time = 0, pb_time = 0;
  int direct_scale[2][64];
  // the rest of a packed packet, decoded with the next packet
  std::vector<uint8_t> stored;
  // output
  std::deque<Ready> ready;
  Ready shown, spare;
  bool have_shown = false;
  int64_t packets = 0;
  // what the decoded VOPs held (m4v_stats): I-VOPs, P-VOPs, intra, inter
  // and skipped macroblocks, intra macroblocks of P-VOPs, AC-predicted and
  // DQUANT macroblocks, TCOEF escapes of types 1, 2 and 3, predictions read
  // partly outside the VOP, half-pel predictions, VOPs with rounding_type 1,
  // AC predictions rescaled to another QP; B-VOPs, B macroblocks by mode
  // (direct, interpolated, backward, forward, skipped with their co-located
  // one), DBQUANT macroblocks, four-vector macroblocks, quarter-sample
  // predictions, VOPs under MPEG quantisation, video packets after the
  // first, data-partitioned VOPs, VOPs decoded from a packed packet's rest,
  // VOPs not coded, VOPs through the XviD IDCT; S-VOPs (GMC), macroblocks
  // predicted by the global motion
  enum { I_VOPS, P_VOPS, INTRA, INTER, SKIPPED, P_INTRA, AC_PRED, DQUANT, ESC1, ESC2, ESC3,
         OUTSIDE, HALF_PEL, ROUNDING, AC_RESCALE, B_VOPS, B_DIRECT, B_INTERP, B_BACKWARD,
         B_FORWARD, B_SKIPPED, DBQUANT, MV4, QUARTER, MPEG_QUANT, PACKETS, PARTITIONED,
         PACKED, NOT_CODED, XVID_IDCT, S_VOPS, GMC_MBS, N_STATS };
  int64_t stats[N_STATS] = {};
  // per VOP
  int vop_type = 0, qscale = 1, rounding = 0, fcode = 1, bcode = 1, dc_threshold = 99;
  int resync_x = 0, resync_y = 0;
  bool first_line = true;
  // per macroblock and block of the VOP being decoded
  std::vector<int8_t> qs;       // QP a macroblock
  std::vector<int16_t> dcs[3];  // the dequantised DC of each intra block, else 1024
  std::vector<int16_t> acs[3];  // 16 a block: first column at 1-7, first row at 9-15
  std::vector<uint8_t> pred_dir, cbps;  // data partitioning: DC directions, cbp
  int bw[3] = {0, 0, 0};                // blocks a row: luma 2 mb_w, chroma mb_w
  int last_mv[2][2] = {{0, 0}, {0, 0}};  // B-VOPs: the forward and backward predictors

  void setup(int w, int h) {
    width = w;
    height = h;
    mb_w = (w + 15) / 16;
    mb_h = (h + 15) / 16;
    mb_num = mb_w * mb_h;
    stride[0] = 16 * mb_w;
    stride[1] = stride[2] = 8 * mb_w;
    for (Picture& pic : pics) {
      for (int p = 0; p < 3; p++) pic.plane[p].assign((size_t)stride[p] * (p ? 8 : 16) * mb_h, 0);
      pic.mv.assign((size_t)8 * mb_num, 0);
      pic.kind.assign(mb_num, 0);
    }
    bw[0] = 2 * mb_w;
    bw[1] = bw[2] = mb_w;
    qs.assign(mb_num, 0);
    pred_dir.assign(mb_num, 0);
    cbps.assign(mb_num, 0);
    for (int p = 0; p < 3; p++) {
      size_t n = (size_t)bw[p] * (p ? mb_h : 2 * mb_h);
      dcs[p].assign(n, 1024);
      acs[p].assign(16 * n, 0);
    }
    last = next = cur = -1;
    stored.clear();
  }

  // ---------------------------------------------------------- headers

  void visual_object(Bits& b) {
    if (b.get1()) b.get(7);  // is_visual_object_identifier: verid, priority
    int type = (int)b.get(4);
    if (type != 1) unsupported("visual object type " + std::to_string(type) + " (not video)");
  }

  void load_matrix(Bits& b, uint8_t* m) {
    int last_v = 0, i = 0;
    for (; i < 64; i++) {
      int v = (int)b.get(8);
      if (v == 0) break;
      last_v = v;
      m[kZigzag[i]] = (uint8_t)v;
    }
    for (; i < 64; i++) m[kZigzag[i]] = (uint8_t)last_v;
  }

  void vol(Bits& b) {
    b.get(1);  // random_accessible_vol
    vo_type = (int)b.get(8);
    int verid = 1;
    if (b.get1()) {
      verid = (int)b.get(4);
      b.get(3);
    }
    if ((int)b.get(4) == 15) b.get(16);  // extended PAR
    vol_control = b.get1();
    if (vol_control) {
      int chroma = (int)b.get(2);
      if (chroma != 1) unsupported("chroma format " + std::to_string(chroma) + " (not 4:2:0)");
      low_delay = b.get1();
      if (b.get1()) b.skip(15 + 1 + 15 + 1 + 15 + 1 + 3 + 11 + 1 + 15 + 1);  // vbv
    } else if (picture_number == 0) {
      low_delay = vo_type == 1 || vo_type == 17;  // Simple and Advanced Simple
    }
    int shape = (int)b.get(2);
    if (shape != 0) unsupported("a non-rectangular VOL shape");
    b.get(1);
    resolution = (int)b.get(16);
    if (resolution == 0) fail("vop_time_increment_resolution 0");
    time_bits = 1;
    while ((1 << time_bits) < resolution) time_bits++;  // av_log2(res - 1) + 1
    b.get(1);
    if (b.get1()) b.get(time_bits);  // fixed_vop_rate
    b.get(1);
    int w = (int)b.get(13);
    b.get(1);
    int h = (int)b.get(13);
    b.get(1);
    if (w == 0 || h == 0) fail("a VOL of size 0");
    if (b.get1()) unsupported("interlaced video");
    if (!b.get1()) unsupported("OBMC (obmc_disable 0)");
    int sprite = (int)b.get(verid == 1 ? 1 : 2);
    if (sprite == 1) unsupported("static sprites (S-VOPs)");
    if (sprite == 3) fail("sprite_enable 3");
    gmc_vol = sprite == 2;
    if (gmc_vol) {
      sprite_points = (int)b.get(6);
      if (sprite_points > 3) fail(std::to_string(sprite_points) + " sprite warping points");
      if (sprite_points != 3)
        unsupported("GMC with " + std::to_string(sprite_points) + " warping points");
      sprite_accuracy = (int)b.get(2);
      if (b.get1()) unsupported("GMC with sprite_brightness_change");
    }
    if (b.get1()) unsupported("not_8_bit");
    mpeg_quant = b.get1();
    if (mpeg_quant) {
      memcpy(intra_matrix, kDefaultIntraMatrix, 64);
      memcpy(inter_matrix, kDefaultInterMatrix, 64);
      if (b.get1()) load_matrix(b, intra_matrix);
      if (b.get1()) load_matrix(b, inter_matrix);
    }
    quarter_sample = verid != 1 && b.get1();
    if (!b.get1()) unsupported("complexity estimation");
    resync_marker = !b.get1();
    partitioning = b.get1();
    if (partitioning && b.get1()) unsupported("RVLC (reversible VLCs)");
    if (verid != 1) {
      if (b.get1()) unsupported("newpred");
      if (b.get1()) unsupported("reduced resolution VOPs");
    }
    if (b.get1()) unsupported("scalability");
    if (!have_vol || w != width || h != height) setup(w, h);
    have_vol = true;
  }

  // FFmpeg's decode_user_data: the encoder's name and build.
  void user_data(Bits& b) {
    char buf[256];
    int i = 0;
    for (; i < 255 && b.left() >= 8; i++) {
      if (b.left() >= 23 && b.peek(23) == 0) break;
      buf[i] = (char)b.get(8);
    }
    buf[i] = 0;
    int ver = 0, ver2 = 0, ver3 = 0, build = 0;
    char last_c = 0;
    int e = sscanf(buf, "DivX%dBuild%d%c", &ver, &build, &last_c);
    if (e < 2) e = sscanf(buf, "DivX%db%d%c", &ver, &build, &last_c);
    if (e >= 2) {
      divx_version = ver;
      divx_build = build;
      divx_packed = e == 3 && last_c == 'p';
    }
    e = sscanf(buf, "FFmpe%*[^b]b%d", &build) + 3;
    if (e != 4) e = sscanf(buf, "FFmpeg v%d.%d.%d / libavcodec build: %d", &ver, &ver2, &ver3,
                           &build);
    if (e != 4) {
      e = sscanf(buf, "Lavc%d.%d.%d", &ver, &ver2, &ver3) + 1;
      if (e > 1) build = ((ver & 0xFF) << 16) + ((ver2 & 0xFF) << 8) + (ver3 & 0xFF);
    }
    if (e != 4 && strcmp(buf, "ffmpeg") == 0) lavc_build = 4600;
    if (e == 4) lavc_build = build;
    if (sscanf(buf, "XviD%d", &build) == 1) xvid_build = build;
    for (const char* tag_s : {"Lavc", "XviD", "DivX", "FFmpe", "ffmpeg"})
      if (strncmp(buf, tag_s, strlen(tag_s)) == 0) encoder = buf;
  }

  static uint32_t fourcc(const char* s) {
    return (uint32_t)(uint8_t)s[0] | (uint32_t)(uint8_t)s[1] << 8 |
           (uint32_t)(uint8_t)s[2] << 16 | (uint32_t)(uint8_t)s[3] << 24;
  }

  // FFmpeg's ff_mpeg4_workaround_bugs with its defaults: the IDCT it picks,
  // and a refusal where it turns on a workaround the port does not have.
  void workarounds() {
    if (xvid_build == -1 && divx_version == -1 && lavc_build == -1)
      for (const char* t : {"XVID", "XVIX", "RMP4", "ZMP4", "SIPP"})
        if (tag == fourcc(t)) xvid_build = 0;
    if (xvid_build == -1 && divx_version == -1 && lavc_build == -1 && tag == fourcc("DIVX") &&
        vo_type == 0 && !vol_control)
      divx_version = 400;
    if (xvid_build >= 0 && divx_version >= 0) divx_version = divx_build = -1;
    std::string who;
    if (tag == fourcc("XVIX") || tag == fourcc("UMP4"))
      who = std::string("the fourcc ") + std::string((const char*)&tag, 4);
    else if (xvid_build >= 0 && xvid_build <= 32)
      who = "XviD build " + std::to_string(xvid_build);
    else if (divx_version >= 0)
      who = "DivX " + std::to_string(divx_version) + " build " + std::to_string(divx_build);
    else if (lavc_build >= 0 && (lavc_build <= 4712 || ((lavc_build & 0xFF) >= 100 &&
                                                        lavc_build > 3621476 &&
                                                        lavc_build < 3752552 &&
                                                        (lavc_build < 3752037 ||
                                                         lavc_build > 3752191))))
      who = "libavcodec build " + std::to_string(lavc_build);
    if (!who.empty())
      unsupported("a stream of " + who + " (FFmpeg decodes it with old-build workarounds)");
    xvid_idct = xvid_build >= 0;
  }

  // ---------------------------------------------------------- blocks

  int mb_index(int mx, int my) const { return my * mb_w + mx; }

  // Block n (0-3 luma, 4 Cb, 5 Cr) of macroblock (mx, my): its plane and
  // block coordinates.
  static void block_pos(int n, int mx, int my, int& p, int& bx, int& by) {
    if (n < 4) {
      p = 0;
      bx = 2 * mx + (n & 1);
      by = 2 * my + (n >> 1);
    } else {
      p = n - 3;
      bx = mx;
      by = my;
    }
  }

  int dc_at(int p, int bx, int by) const {
    if (bx < 0 || by < 0) return 1024;
    return dcs[p][(size_t)by * bw[p] + bx];
  }

  int dc_scale(int n) const { return n < 4 ? luma_dc_scale(qscale) : chroma_dc_scale(qscale); }

  // DC prediction (ff_mpeg4_pred_dc): the quantised DC of the block from
  // its coded difference, its direction (0 left, 1 top); stores its
  // dequantised DC for its neighbours. Neighbours in an earlier video
  // packet count as absent, as FFmpeg tells them.
  int pred_dc(int n, int mx, int my, int level, int& dir) {
    int p, bx, by;
    block_pos(n, mx, my, p, bx, by);
    int scale = dc_scale(n);
    int a = dc_at(p, bx - 1, by), b = dc_at(p, bx - 1, by - 1), c = dc_at(p, bx, by - 1);
    if (first_line && n != 3) {
      if (n != 2) b = c = 1024;
      if (n != 1 && mx == resync_x) b = a = 1024;
    }
    if (mx == resync_x && my == resync_y + 1 && (n == 0 || n == 4 || n == 5)) b = 1024;
    int pred;
    if (std::abs(a - b) < std::abs(b - c)) {
      pred = c;
      dir = 1;
    } else {
      pred = a;
      dir = 0;
    }
    pred = (pred + (scale >> 1)) / scale;
    level += pred;
    int v = level * scale;
    if (v & ~2047) v = v < 0 ? 0 : 2047;
    dcs[p][(size_t)by * bw[p] + bx] = (int16_t)v;
    return level;
  }

  // AC prediction (ff_mpeg4_pred_ac) and the copy of the block's first row
  // and column for its neighbours.
  void pred_ac(int16_t* blk, int n, int mx, int my, int dir, bool ac_pred) {
    int p, bx, by;
    block_pos(n, mx, my, p, bx, by);
    int16_t* own = &acs[p][16 * ((size_t)by * bw[p] + bx)];
    if (ac_pred) {
      if (dir == 0) {
        if (bx > 0) {
          const int16_t* left = own - 16;
          int q = mx > 0 ? qs[mb_index(mx - 1, my)] : qscale;
          bool same = mx == 0 || q == qscale || n == 1 || n == 3;
          stats[AC_RESCALE] += !same;
          for (int i = 1; i < 8; i++) {
            int v = left[i];
            if (!same) v = (v * q >= 0 ? v * q + (qscale >> 1) : v * q - (qscale >> 1)) / qscale;
            blk[i << 3] = (int16_t)(blk[i << 3] + v);
          }
        }
      } else if (by > 0) {
        const int16_t* top = own - 16 * (size_t)bw[p];
        int q = my > 0 ? qs[mb_index(mx, my - 1)] : qscale;
        bool same = my == 0 || q == qscale || n == 2 || n == 3;
        stats[AC_RESCALE] += !same;
        for (int i = 1; i < 8; i++) {
          int v = top[i + 8];
          if (!same) v = (v * q >= 0 ? v * q + (qscale >> 1) : v * q - (qscale >> 1)) / qscale;
          blk[i] = (int16_t)(blk[i] + v);
        }
      }
    }
    for (int i = 1; i < 8; i++) {
      own[i] = blk[i << 3];
      own[8 + i] = blk[i];
    }
  }

  // ff_mpeg4_clean_buffers at a video packet's first macroblock: the AC
  // predictors of the blocks before it on its rows are cleared.
  void clean_buffers(int mx, int my) {
    for (int p = 0; p < 3; p++) {
      int wrap = bw[p] + 1;  // FFmpeg's rows of blocks carry one more column, the last
      int rows = p ? mb_h : 2 * mb_h;
      int start = p ? (my - 1) * wrap + mx - 1 : (2 * my - 1) * wrap + 2 * mx - 1;
      for (int idx = start; idx < start + (p ? wrap + 1 : 2 * wrap + 1); idx++) {
        int r = idx >= 0 ? idx / wrap : -1 - (-1 - idx) / wrap, c = idx - r * wrap;
        if (r < 0 || r >= rows || c == wrap - 1) continue;
        std::fill_n(&acs[p][16 * ((size_t)r * bw[p] + c)], 16, (int16_t)0);
      }
    }
    last_mv[0][0] = last_mv[0][1] = last_mv[1][0] = last_mv[1][1] = 0;
  }

  // The TCOEF run of a block from scan position `i` + 1 on, into `blk` at
  // `scan`; levels dequantised as level * qmul +- qadd (qmul 1 and qadd 0
  // for intra blocks and MPEG quantisation, dequantised later).
  void tcoef(Bits& b, const Tcoef& t, int16_t* blk, const uint8_t* scan, int i, int qmul,
             int qadd) {
    for (;;) {
      int code = t.vlc.read(b, "TCOEF");
      int last, run, level;
      if (code == 102) {  // escape
        if (b.get1()) {
          if (b.get1()) {  // type 3: fixed length
            stats[ESC3]++;
            last = b.get1();
            run = (int)b.get(6);
            b.get(1);
            level = (int)b.get(12);
            if (level & 2048) level -= 4096;
            b.get(1);
            level = level > 0 ? level * qmul + qadd : level * qmul - qadd;
            if ((unsigned)(level + 2048) > 4095) level = level < 0 ? -2048 : 2047;
            i += run + 1;
          } else {  // type 2: run + RMAX + 1
            stats[ESC2]++;
            int c = t.vlc.read(b, "TCOEF");
            if (c == 102) fail("an escape inside a TCOEF escape");
            last = c >= t.last;
            run = t.run[c];
            int mag = t.level[c];
            i += run + t.max_run[last][mag] + 1 + 1;
            level = mag * qmul + qadd;
            if (b.get1()) level = -level;
          }
        } else {  // type 1: level + LMAX
          stats[ESC1]++;
          int c = t.vlc.read(b, "TCOEF");
          if (c == 102) fail("an escape inside a TCOEF escape");
          last = c >= t.last;
          run = t.run[c];
          int mag = t.level[c] + t.max_level[last][run];
          i += run + 1;
          level = mag * qmul + qadd;
          if (b.get1()) level = -level;
        }
      } else {
        last = code >= t.last;
        run = t.run[code];
        level = t.level[code] * qmul + qadd;
        if (b.get1()) level = -level;
        i += run + 1;
      }
      if (last ? i > 63 : i > 62) fail("TCOEF past the end of a block");
      blk[scan[i]] = (int16_t)level;
      if (last) return;
    }
  }

  int read_dc(Bits& b, int n) {
    int size = (n < 4 ? tables().dc_lum : tables().dc_chrom).read(b, "DC size");
    if (size > 9) fail("intra DC size past 9");
    int diff = 0;
    if (size) {
      diff = b.xbits(size);
      if (size > 8) b.get(1);  // marker
    }
    return diff;
  }

  // The coefficients of one intra block, predicted (not yet dequantised).
  // With `dc` >= 0 its DC came from the first partition.
  void intra_coefs(Bits& b, int16_t* blk, int n, int mx, int my, bool coded, bool ac_pred,
                   bool dc_vlc, int dir_in = -1) {
    int dir = 0, i;
    if (dir_in >= 0) {  // data partitioning: the DC decoded in the first partition
      int p, bx, by;
      block_pos(n, mx, my, p, bx, by);
      int scale = dc_scale(n);
      blk[0] = (int16_t)((dcs[p][(size_t)by * bw[p] + bx] + (scale >> 1)) / scale);
      dir = dir_in;
      i = 0;
    } else if (dc_vlc) {
      blk[0] = (int16_t)pred_dc(n, mx, my, read_dc(b, n), dir);
      i = 0;
    } else {
      pred_dc(n, mx, my, 0, dir);
      i = -1;
    }
    if (coded) {
      const uint8_t* scan = ac_pred ? (dir == 0 ? kAltVertical : kAltHorizontal) : kZigzag;
      tcoef(b, tables().intra, blk, scan, i, 1, 0);
    }
    if (!dc_vlc) blk[0] = (int16_t)pred_dc(n, mx, my, blk[0], dir);
    pred_ac(blk, n, mx, my, dir, ac_pred);
  }

  void idct(int16_t* blk, uint8_t* dst, int s, bool add) const {
    if (xvid_idct)
      xvid_idct_8x8(blk, dst, s, add);
    else
      mpeg4::idct(blk, dst, s, add);
  }

  uint8_t* block_dst(int n, int mx, int my, int& s) {
    Picture& pic = pics[cur];
    int p = n < 4 ? 0 : n - 3;
    s = stride[p];
    return n < 4 ? pic.plane[0].data() + (size_t)(16 * my + 8 * (n >> 1)) * s + 16 * mx +
                       8 * (n & 1)
                 : pic.plane[p].data() + (size_t)8 * my * s + 8 * mx;
  }

  // Dequantise and write an intra block (dct_unquantize_h263_intra or
  // _mpeg2_intra, then the IDCT).
  void put_intra(int16_t* blk, int n, int mx, int my) {
    blk[0] = (int16_t)(blk[0] * dc_scale(n));
    if (mpeg_quant) {
      for (int k = 1; k < 64; k++) {
        int v = blk[k];
        if (!v) continue;
        int m = ((v < 0 ? -v : v) * 2 * qscale * intra_matrix[k]) >> 4;
        blk[k] = (int16_t)(v < 0 ? -m : m);
      }
    } else {
      int qmul = 2 * qscale, qadd = (qscale - 1) | 1;
      for (int k = 1; k < 64; k++) {
        int v = blk[k];
        if (v) blk[k] = (int16_t)(v < 0 ? v * qmul - qadd : v * qmul + qadd);
      }
    }
    int s;
    uint8_t* dst = block_dst(n, mx, my, s);
    idct(blk, dst, s, false);
  }

  // Add a coded inter block (MPEG quantisation dequantised here with
  // dct_unquantize_mpeg2_inter's mismatch control).
  void add_inter(int16_t* blk, int n, int mx, int my) {
    if (mpeg_quant) {
      int sum = -1;
      for (int k = 0; k < 64; k++) {
        int v = blk[k];
        if (!v) continue;
        int m = ((((v < 0 ? -v : v) << 1) + 1) * 2 * qscale * inter_matrix[k]) >> 5;
        m = v < 0 ? -m : m;
        blk[k] = (int16_t)m;
        sum += m;
      }
      blk[63] ^= (int16_t)(sum & 1);
    }
    int s;
    uint8_t* dst = block_dst(n, mx, my, s);
    idct(blk, dst, s, true);
  }

  // The coefficients of the coded inter blocks of `cbp`.
  void inter_coefs(Bits& b, int16_t (*blk)[64], int cbp) {
    int qmul = mpeg_quant ? 1 : 2 * qscale, qadd = mpeg_quant ? 0 : (qscale - 1) | 1;
    for (int n = 0; n < 6; n++)
      if ((cbp >> (5 - n)) & 1) tcoef(b, tables().inter, blk[n], kZigzag, -1, qmul, qadd);
  }

  // ---------------------------------------------------------- motion

  // The luma prediction of block (bx, by) (w x w at luma (x, y)) from the
  // reference `ref` with vector (vx, vy) in half or quarter samples;
  // `clip` clips the position to the VOL first, as FFmpeg's 8x8 paths do.
  void predict_luma(const Picture& ref, uint8_t* dst, int x, int y, int vx, int vy, int w,
                    bool clip, int rnd, bool avg) {
    int ew = 16 * mb_w, eh = 16 * mb_h;
    uint8_t buf[24 * 24];
    int qs_, dxy, sx, sy, fx, fy;
    if (quarter_sample) {
      dxy = ((vy & 3) << 2) | (vx & 3);
      sx = x + (vx >> 2);
      sy = y + (vy >> 2);
      if (clip) {
        sx = std::min(std::max(sx, -16), width);
        if (sx == width) dxy &= ~3;
        sy = std::min(std::max(sy, -16), height);
        if (sy == height) dxy &= ~12;
      }
      const uint8_t* q = fetch(ref.plane[0].data(), stride[0], ew, eh, sx, sy, w + 1, w + 1, buf,
                               qs_);
      qpel(dst, stride[0], q, qs_, w, dxy, rnd, avg);
      stats[QUARTER]++;
      fx = (dxy & 3) != 0;
      fy = (dxy >> 2) != 0;
    } else {
      sx = x + (vx >> 1);
      sy = y + (vy >> 1);
      dxy = 0;
      if (clip) {
        sx = std::min(std::max(sx, -16), width);
        if (sx != width) dxy |= vx & 1;
        sy = std::min(std::max(sy, -16), height);
        if (sy != height) dxy |= (vy & 1) << 1;
      } else {
        dxy = (vx & 1) | ((vy & 1) << 1);
      }
      const uint8_t* q = fetch(ref.plane[0].data(), stride[0], ew, eh, sx, sy, w + 1, w + 1, buf,
                               qs_);
      hpel(dst, stride[0], q, qs_, w, w, dxy, rnd, avg);
      stats[HALF_PEL] += (vx & 1) | (vy & 1);
      fx = dxy & 1;
      fy = dxy >> 1;
    }
    stats[OUTSIDE] += !(sx >= 0 && sy >= 0 && sx + w + fx <= ew && sy + w + fy <= eh);
  }

  // The chroma prediction of the macroblock from a chroma vector in half
  // samples; `clip` as for luma (four vectors).
  void predict_chroma(const Picture& ref, int mx, int my, int cx, int cy, bool clip, int rnd,
                      bool avg) {
    int ew = 8 * mb_w, eh = 8 * mb_h;
    int dxy = (cx & 1) | ((cy & 1) << 1);
    int sx = 8 * mx + (cx >> 1), sy = 8 * my + (cy >> 1);
    if (clip) {
      sx = std::min(std::max(sx, -8), width >> 1);
      if (sx == (width >> 1)) dxy &= ~1;
      sy = std::min(std::max(sy, -8), height >> 1);
      if (sy == (height >> 1)) dxy &= ~2;
    }
    for (int p = 1; p < 3; p++) {
      uint8_t buf[24 * 24];
      int qs_;
      const uint8_t* q =
          fetch(ref.plane[p].data(), stride[p], ew, eh, sx, sy, 9, 9, buf, qs_);
      stats[HALF_PEL] += dxy != 0;
      stats[OUTSIDE] += !(sx >= 0 && sy >= 0 && sx + 8 + (dxy & 1) <= ew &&
                          sy + 8 + (dxy >> 1) <= eh);
      hpel(pics[cur].plane[p].data() + (size_t)8 * my * stride[p] + 8 * mx, stride[p], q, qs_, 8,
           8, dxy, rnd, avg);
    }
  }

  // ff_mpv_motion: the prediction of macroblock (mx, my) from one reference
  // with one vector (four = false) or four.
  void motion(const Picture& ref, int mx, int my, const int (*v)[2], bool four, int rnd,
              bool avg) {
    uint8_t* y = pics[cur].plane[0].data() + (size_t)16 * my * stride[0] + 16 * mx;
    if (!four) {
      predict_luma(ref, y, 16 * mx, 16 * my, v[0][0], v[0][1], 16, false, rnd, avg);
      int cx, cy;
      if (quarter_sample) {
        cx = v[0][0] / 2;
        cy = v[0][1] / 2;
        cx = (cx >> 1) | (cx & 1);
        cy = (cy >> 1) | (cy & 1);
      } else {
        cx = chroma_mv(v[0][0]);
        cy = chroma_mv(v[0][1]);
      }
      predict_chroma(ref, mx, my, cx, cy, false, rnd, avg);
      return;
    }
    int sx = 0, sy = 0;
    for (int i = 0; i < 4; i++) {
      predict_luma(ref, y + (size_t)8 * (i >> 1) * stride[0] + 8 * (i & 1),
                   16 * mx + 8 * (i & 1), 16 * my + 8 * (i >> 1), v[i][0], v[i][1], 8, true,
                   rnd, avg);
      sx += quarter_sample ? v[i][0] / 2 : v[i][0];
      sy += quarter_sample ? v[i][1] / 2 : v[i][1];
    }
    predict_chroma(ref, mx, my, round_chroma(sx), round_chroma(sy), true, rnd, avg);
  }

  // The vector of 8x8 block (bx, by) of a picture.
  int16_t* mv_of(Picture& pic, int bx, int by) {
    return &pic.mv[2 * ((size_t)by * 2 * mb_w + bx)];
  }
  int mv_at(Picture& pic, int bx, int by, int k) {
    if (bx < 0 || bx >= 2 * mb_w || by < 0) return 0;
    return mv_of(pic, bx, by)[k];
  }

  // ff_h263_pred_motion: the predictor of block `block` (0-3) of macroblock
  // (mx, my), candidates in earlier video packets left out as FFmpeg leaves
  // them out.
  void pred_motion(int block, int mx, int my, int& px, int& py) {
    Picture& pic = pics[cur];
    static const int off[4] = {2, 1, 1, -1};
    int bx = 2 * mx + (block & 1), by = 2 * my + (block >> 1);
    int a[2] = {mv_at(pic, bx - 1, by, 0), mv_at(pic, bx - 1, by, 1)};
    // FFmpeg's B = mot_val[-wrap] and C = mot_val[off[block] - wrap]
    auto cand_c = [&](int k) { return mv_at(pic, bx + off[block], by - 1, k); };
    auto cand_b = [&](int k) { return mv_at(pic, bx, by - 1, k); };
    if (first_line && block < 3) {
      if (block == 0) {
        if (mx == resync_x) {
          px = py = 0;
        } else if (mx + 1 == resync_x) {
          if (mx == 0) {
            px = cand_c(0);
            py = cand_c(1);
          } else {
            px = median3(a[0], 0, cand_c(0));
            py = median3(a[1], 0, cand_c(1));
          }
        } else {
          px = a[0];
          py = a[1];
        }
      } else if (block == 1) {
        if (mx + 1 == resync_x) {
          px = median3(a[0], 0, cand_c(0));
          py = median3(a[1], 0, cand_c(1));
        } else {
          px = a[0];
          py = a[1];
        }
      } else {  // block 2
        if (mx == resync_x) {
          a[0] = a[1] = 0;
          if (bx > 0) {
            int16_t* left = mv_of(pic, bx - 1, by);
            left[0] = left[1] = 0;
          }
        }
        px = median3(a[0], cand_b(0), cand_c(0));
        py = median3(a[1], cand_b(1), cand_c(1));
      }
    } else {
      px = median3(a[0], cand_b(0), cand_c(0));
      py = median3(a[1], cand_b(1), cand_c(1));
    }
  }

  int decode_mv(Bits& b, int pred, int f) {
    int code = tables().mv.read(b, "motion vector");
    if (code == 0) return pred;
    int sign = b.get1();
    int shift = f - 1;
    int val = code;
    if (shift) {
      val = (val - 1) << shift;
      val |= (int)b.get(shift);
      val++;
    }
    if (sign) val = -val;
    val += pred;
    int bits = 5 + f;
    return (int)((uint32_t)val << (32 - bits)) >> (32 - bits);
  }

  void set_mb_mv(int mx, int my, int vx, int vy) {
    Picture& pic = pics[cur];
    for (int k = 0; k < 4; k++) {
      int16_t* m = mv_of(pic, 2 * mx + (k & 1), 2 * my + (k >> 1));
      m[0] = (int16_t)vx;
      m[1] = (int16_t)vy;
    }
  }

  // ---------------------------------------------------------- GMC

  // mpeg4_decode_sprite_trajectory: the three warping points and the affine
  // warp they make (its offsets and steps in 16.16 fixed point).
  void sprite_trajectory(Bits& b) {
    const int a = 2 << sprite_accuracy, rho = 3 - sprite_accuracy, r = 16 / a;
    const int w = width, h = height;
    int d[4][2] = {{0, 0}, {0, 0}, {0, 0}, {0, 0}};
    for (int i = 0; i < sprite_points; i++) {
      for (int k = 0; k < 2; k++) {
        int len = tables().sprite.read(b, "sprite trajectory");
        d[i][k] = len ? b.xbits(len) : 0;
        b.get(1);  // marker
      }
    }
    int alpha = 1, beta = 0;
    while ((1 << alpha) < w) alpha++;
    while ((1 << beta) < h) beta++;
    const int w2 = 1 << alpha, h2 = 1 << beta;
    const int vop_ref[3][2] = {{0, 0}, {w, 0}, {0, h}};
    int sprite_ref[3][2];
    for (int k = 0; k < 2; k++) {
      sprite_ref[0][k] = (a >> 1) * (2 * vop_ref[0][k] + d[0][k]);
      sprite_ref[1][k] = (a >> 1) * (2 * vop_ref[1][k] + d[0][k] + d[1][k]);
      sprite_ref[2][k] = (a >> 1) * (2 * vop_ref[2][k] + d[0][k] + d[2][k]);
    }
    int vr[2][2];
    vr[0][0] = 16 * (vop_ref[0][0] + w2) +
               (int)rounded_div((w - w2) * (r * sprite_ref[0][0] - 16LL * vop_ref[0][0]) +
                                    w2 * (r * sprite_ref[1][0] - 16LL * vop_ref[1][0]),
                                w);
    vr[0][1] = 16 * vop_ref[0][1] +
               (int)rounded_div((w - w2) * (r * sprite_ref[0][1] - 16LL * vop_ref[0][1]) +
                                    w2 * (r * sprite_ref[1][1] - 16LL * vop_ref[1][1]),
                                w);
    vr[1][0] = 16 * vop_ref[0][0] +
               (int)rounded_div((h - h2) * (r * sprite_ref[0][0] - 16LL * vop_ref[0][0]) +
                                    h2 * (r * sprite_ref[2][0] - 16LL * vop_ref[2][0]),
                                h);
    vr[1][1] = 16 * (vop_ref[0][1] + h2) +
               (int)rounded_div((h - h2) * (r * sprite_ref[0][1] - 16LL * vop_ref[0][1]) +
                                    h2 * (r * sprite_ref[2][1] - 16LL * vop_ref[2][1]),
                                h);
    // three points: an affine warp
    int64_t off[2][2], del[2][2];
    const int64_t sr00 = sprite_ref[0][0], sr01 = sprite_ref[0][1];
    const int min_ab = std::min(alpha, beta);
    const int64_t w3 = w2 >> min_ab, h3 = h2 >> min_ab;
    const int sh = alpha + beta + rho - min_ab;
    off[0][0] = sr00 * (1LL << sh) + (-r * sr00 + vr[0][0]) * h3 * (-vop_ref[0][0]) +
                (-r * sr00 + vr[1][0]) * w3 * (-vop_ref[0][1]) + (1LL << (sh - 1));
    off[0][1] = sr01 * (1LL << sh) + (-r * sr01 + vr[0][1]) * h3 * (-vop_ref[0][0]) +
                (-r * sr01 + vr[1][1]) * w3 * (-vop_ref[0][1]) + (1LL << (sh - 1));
    off[1][0] = (-r * sr00 + vr[0][0]) * h3 * (-2LL * vop_ref[0][0] + 1) +
                (-r * sr00 + vr[1][0]) * w3 * (-2LL * vop_ref[0][1] + 1) +
                2LL * w2 * h3 * r * sr00 - 16LL * w2 * h3 + (1LL << (sh + 1));
    off[1][1] = (-r * sr01 + vr[0][1]) * h3 * (-2LL * vop_ref[0][0] + 1) +
                (-r * sr01 + vr[1][1]) * w3 * (-2LL * vop_ref[0][1] + 1) +
                2LL * w2 * h3 * r * sr01 - 16LL * w2 * h3 + (1LL << (sh + 1));
    del[0][0] = (-r * sr00 + vr[0][0]) * h3;
    del[0][1] = (-r * sr00 + vr[1][0]) * w3;
    del[1][0] = (-r * sr01 + vr[0][1]) * h3;
    del[1][1] = (-r * sr01 + vr[1][1]) * w3;
    sprite_shift[0] = sh;
    sprite_shift[1] = sh + 2;
    if (del[0][0] == ((int64_t)a << sh) && del[0][1] == 0 && del[1][0] == 0 &&
        del[1][1] == ((int64_t)a << sh))
      unsupported("a GMC warp that is a translation (FFmpeg's gmc1)");
    {
      const int shift_y = 16 - sprite_shift[0], shift_c = 16 - sprite_shift[1];
      const int64_t kMax = 0x7fffffff;
      for (int i = 0; i < 2; i++)
        if (shift_c < 0 || shift_y < 0 || std::llabs(off[0][i]) >= kMax >> shift_y ||
            std::llabs(off[1][i]) >= kMax >> shift_c || std::llabs(del[0][i]) >= kMax >> shift_y ||
            std::llabs(del[1][i]) >= kMax >> shift_y)
          unsupported("a GMC warp too large for FFmpeg's fixed point");
      for (int i = 0; i < 2; i++) {
        off[0][i] *= 1LL << shift_y;
        off[1][i] *= 1LL << shift_c;
        del[0][i] *= 1LL << shift_y;
        del[1][i] *= 1LL << shift_y;
        sprite_shift[i] = 16;
      }
      for (int i = 0; i < 2; i++) {
        int64_t sd0 = del[i][0] - a * (1LL << 16), sd1 = del[i][1] - a * (1LL << 16);
        int64_t W = w + 16LL, H = h + 16LL;
        if (std::llabs(off[0][i] + del[i][0] * W) >= kMax ||
            std::llabs(off[0][i] + del[i][1] * H) >= kMax ||
            std::llabs(off[0][i] + del[i][0] * W + del[i][1] * H) >= kMax ||
            std::llabs(del[i][0] * W) >= kMax || std::llabs(del[i][1] * H) >= kMax ||
            std::llabs(sd0) >= kMax || std::llabs(sd1) >= kMax ||
            std::llabs(off[0][i] + sd0 * W) >= kMax || std::llabs(off[0][i] + sd1 * H) >= kMax ||
            std::llabs(off[0][i] + sd0 * W + sd1 * H) >= kMax)
          unsupported("a GMC warp too large for FFmpeg's fixed point");
      }
    }
    for (int i = 0; i < 2; i++)
      for (int k = 0; k < 2; k++) {
        sprite_offset[i][k] = (int)off[i][k];
        sprite_delta[i][k] = (int)del[i][k];
      }
  }

  // get_amv: the vector component n of a macroblock predicted by the global
  // motion, its mean over the macroblock, for its neighbours' prediction.
  int amv(int n, int mx, int my) const {
    const int a = sprite_accuracy, len = 1 << (fcode + 4);
    int dx = sprite_delta[n][0], dy = sprite_delta[n][1];
    const int shift = sprite_shift[0];
    if (n)
      dy -= 1 << (shift + a + 1);
    else
      dx -= 1 << (shift + a + 1);
    int mb_v =
        (int)((uint32_t)sprite_offset[0][n] + (uint32_t)dx * mx * 16u + (uint32_t)dy * my * 16u);
    int sum = 0;
    for (int y = 0; y < 16; y++) {
      int v = (int)((uint32_t)mb_v + (uint32_t)dy * y);
      for (int x = 0; x < 16; x++) {
        sum += v >> shift;
        v = (int)((uint32_t)v + (uint32_t)dx);
      }
    }
    sum = rshift(sum, a + 8 - quarter_sample);
    return sum < -len ? -len : sum >= len ? len - 1 : sum;
  }

  // gmc_motion: macroblock (mx, my) predicted by the warp.
  void gmc_motion(int mx, int my) {
    const Picture& ref = pics[last];
    Picture& pic = pics[cur];
    const int a = sprite_accuracy;
    uint8_t* y = pic.plane[0].data() + (size_t)16 * my * stride[0] + 16 * mx;
    const int r = (1 << (2 * a + 1)) - rounding;
    int ox = sprite_offset[0][0] + sprite_delta[0][0] * mx * 16 + sprite_delta[0][1] * my * 16;
    int oy = sprite_offset[0][1] + sprite_delta[1][0] * mx * 16 + sprite_delta[1][1] * my * 16;
    for (int half = 0; half < 2; half++)
      gmc(y + 8 * half, stride[0], ref.plane[0].data(), stride[0], 16,
          ox + sprite_delta[0][0] * 8 * half, oy + sprite_delta[1][0] * 8 * half,
          sprite_delta[0][0], sprite_delta[0][1], sprite_delta[1][0], sprite_delta[1][1], a + 1,
          r, 16 * mb_w, 16 * mb_h);
    ox = sprite_offset[1][0] + sprite_delta[0][0] * mx * 8 + sprite_delta[0][1] * my * 8;
    oy = sprite_offset[1][1] + sprite_delta[1][0] * mx * 8 + sprite_delta[1][1] * my * 8;
    for (int p = 1; p < 3; p++)
      gmc(pic.plane[p].data() + (size_t)8 * my * stride[p] + 8 * mx, stride[p],
          ref.plane[p].data(), stride[p], 8, ox, oy, sprite_delta[0][0], sprite_delta[0][1],
          sprite_delta[1][0], sprite_delta[1][1], a + 1, r, 8 * mb_w, 8 * mb_h);
  }

  // ---------------------------------------------------------- video packets

  int prefix_length() const {
    switch (vop_type) {
      case VOP_I: return 16;
      case VOP_B: return std::max(std::max(fcode, bcode), 2) + 15;
      default: return fcode + 15;
    }
  }

  int mb_num_bits() const {
    int n = 0;
    while ((1 << n) < mb_num) n++;  // av_log2(mb_num - 1) + 1
    return std::max(n, 1);
  }

  // mpeg4_is_resync: after a macroblock, the number of the macroblock the
  // next video packet starts at (mb_num at the VOP's end, -1 for a marker
  // with a bad number), or 0. Skips the MCBPC stuffing before a marker.
  int is_resync(Bits& b, bool partitioned) {
    size_t count = b.pos;
    uint32_t v = b.peek(16);
    const int t = vop_type + 1;  // FFmpeg's AV_PICTURE_TYPE_I ... _S
    while (v <= 0xFF) {
      if (vop_type == VOP_B || (v >> (8 - t)) != 1 || partitioned) break;
      b.skip(8 + t);
      count += 8 + t;
      v = b.peek(16);
    }
    if (count + 8 >= b.bits) {
      v >>= 8;
      v |= 0x7F >> (7 - (count & 7));
      if (v == 0x7F) return mb_num;
    } else {
      static const uint16_t kPrefix[8] = {0x7F00, 0x7E00, 0x7C00, 0x7800,
                                          0x7000, 0x6000, 0x4000, 0x0000};
      if (v == kPrefix[count & 7]) {
        Bits g = b;  // read on past the end as zeros, as FFmpeg's reader does
        g.pos = (g.pos + 1 + 7) & ~(size_t)7;
        int len = 0;
        for (; len < 32; len++, g.pos++)
          if (g.peek(1)) break;
        g.pos++;
        int bits = mb_num_bits();
        int n = (int)g.peek(bits);
        g.pos += bits;
        if (!n || n > mb_num || g.pos + 6 > g.bits) n = -1;
        if (len >= prefix_length()) return n;
      }
    }
    return 0;
  }

  // ff_h263_resync and ff_mpeg4_decode_video_packet_header: the next video
  // packet's header after the stuffing; returns its first macroblock.
  int video_packet(Bits& b) {
    b.skip(1);
    b.align();
    if (b.left() < 20 || b.peek(16) != 0) fail("a video packet without its resync marker");
    int len = 0;
    for (; len < 32; len++)
      if (b.get1()) break;
    if (len != prefix_length()) fail("a resync marker that does not match f_code");
    int n = (int)b.get(mb_num_bits());
    if (n >= mb_num || n == 0) fail("a video packet's macroblock_number past the VOP");
    int q = (int)b.get(5);
    if (q) qscale = q;
    if (b.get1()) {  // header_extension_code
      if (vop_type == VOP_S) unsupported("a video packet header extension in an S-VOP (GMC)");
      while (b.get1()) {
      }
      b.get(1);
      b.get(time_bits);
      b.get(1);
      b.get(2);  // vop_coding_type
      b.get(3);  // intra_dc_vlc_thr
      if (vop_type != VOP_I) b.get(3);
      if (vop_type == VOP_B) b.get(3);
    }
    stats[PACKETS]++;
    return n;
  }

  // ---------------------------------------------------------- macroblocks

  static constexpr int kSliceOk = 0, kSliceEnd = 1;

  // After a macroblock: the end of its video packet (where the VOL enables
  // resync markers; FFmpeg looks for none in a stream without them).
  int slice_check(Bits& b, int mx, int my) {
    if (!resync_marker) return kSliceOk;
    int n = is_resync(b, false);
    if (n) {
      int here = mx + my * mb_w + 1;
      if (here >= n) return kSliceEnd;
      if (vop_type == VOP_B) {
        int xy = mb_index(mx, my);
        int delta = mx + 1 == mb_w ? 2 : 1;
        if (xy + delta < mb_num && (pics[next].kind[xy + delta] & MB_SKIP)) return kSliceOk;
      }
      return kSliceEnd;
    }
    return kSliceOk;
  }

  static const int8_t* dquant_tab() {
    static const int8_t kDquant[4] = {-1, -2, 1, 2};
    return kDquant;
  }
  void set_qscale(int q) { qscale = std::min(std::max(q, 1), 31); }

  // One macroblock of an I- or P-VOP (mpeg4_decode_mb), decoded and
  // reconstructed.
  void mb_ip(Bits& b, int mx, int my) {
    const Tables& T = tables();
    Picture& pic = pics[cur];
    int xy = mb_index(mx, my);
    int cbpc;
    bool intra;
    if (vop_type != VOP_I) {
      bool skipped = false;
      do {
        if (b.get1()) {
          skipped = true;
          break;
        }
        cbpc = T.inter_mcbpc.read(b, "P MCBPC");
      } while (cbpc == 20);
      if (skipped) {
        stats[SKIPPED]++;
        qs[xy] = (int8_t)qscale;
        if (vop_type == VOP_S) {  // predicted by the global motion, not skipped for B-VOPs
          stats[GMC_MBS]++;
          pic.kind[xy] = 0;
          set_mb_mv(mx, my, amv(0, mx, my), amv(1, mx, my));
          gmc_motion(mx, my);
          return;
        }
        pic.kind[xy] = MB_SKIP;
        set_mb_mv(mx, my, 0, 0);
        const int zero[1][2] = {{0, 0}};
        motion(pics[last], mx, my, zero, false, rounding, false);
        return;
      }
      intra = (cbpc & 4) != 0;
    } else {
      do cbpc = T.intra_mcbpc.read(b, "I MCBPC");
      while (cbpc == 8);
      intra = true;
    }
    bool dquant = vop_type != VOP_I ? (cbpc & 8) != 0 : (cbpc & 4) != 0;
    stats[DQUANT] += dquant;
    stats[intra ? INTRA : INTER]++;
    stats[P_INTRA] += intra && vop_type != VOP_I;
    int16_t blk[6][64];
    memset(blk, 0, sizeof blk);
    if (intra) {
      bool ac_pred = b.get1();
      stats[AC_PRED] += ac_pred;
      int cbpy = T.cbpy.read(b, "CBPY");
      int cbp = (cbpc & 3) | (cbpy << 2);
      bool dc_vlc = qscale < dc_threshold;
      if (dquant) set_qscale(qscale + dquant_tab()[b.get(2)]);
      qs[xy] = (int8_t)qscale;
      pic.kind[xy] = MB_INTRA;
      set_mb_mv(mx, my, 0, 0);
      for (int n = 0; n < 6; n++)
        intra_coefs(b, blk[n], n, mx, my, (cbp >> (5 - n)) & 1, ac_pred, dc_vlc);
      for (int n = 0; n < 6; n++) put_intra(blk[n], n, mx, my);
      return;
    }
    bool mcsel = vop_type == VOP_S && !(cbpc & 16) && b.get1();
    int cbpy = T.cbpy.read(b, "CBPY") ^ 15;
    int cbp = (cbpc & 3) | (cbpy << 2);
    if (dquant) set_qscale(qscale + dquant_tab()[b.get(2)]);
    qs[xy] = (int8_t)qscale;
    int v[4][2];
    bool four = (cbpc & 16) != 0;
    if (mcsel) {
      stats[GMC_MBS]++;
      set_mb_mv(mx, my, amv(0, mx, my), amv(1, mx, my));
      pic.kind[xy] = 0;
      inter_coefs(b, blk, cbp);
      gmc_motion(mx, my);
      for (int n = 0; n < 6; n++)
        if ((cbp >> (5 - n)) & 1) add_inter(blk[n], n, mx, my);
      return;
    }
    if (!four) {
      int px, py;
      pred_motion(0, mx, my, px, py);
      v[0][0] = decode_mv(b, px, fcode);
      v[0][1] = decode_mv(b, py, fcode);
      set_mb_mv(mx, my, v[0][0], v[0][1]);
      pic.kind[xy] = 0;
    } else {
      stats[MV4]++;
      for (int i = 0; i < 4; i++) {
        int px, py;
        pred_motion(i, mx, my, px, py);
        v[i][0] = decode_mv(b, px, fcode);
        v[i][1] = decode_mv(b, py, fcode);
        int16_t* m = mv_of(pic, 2 * mx + (i & 1), 2 * my + (i >> 1));
        m[0] = (int16_t)v[i][0];
        m[1] = (int16_t)v[i][1];
      }
      pic.kind[xy] = MB_4MV;
    }
    inter_coefs(b, blk, cbp);
    motion(pics[last], mx, my, v, four, rounding, false);
    for (int n = 0; n < 6; n++)
      if ((cbp >> (5 - n)) & 1) add_inter(blk[n], n, mx, my);
  }

  // ff_mpeg4_set_direct_mv: the forward and backward vectors of a direct
  // macroblock from its co-located one and the delta (dx, dy); four: the
  // vectors are per block.
  bool direct_mv(int mx, int my, int dx, int dy, int (*f)[2], int (*bk)[2]) {
    Picture& nx = pics[next];
    int xy = mb_index(mx, my);
    bool four = (nx.kind[xy] & MB_4MV) != 0;
    int blocks = four ? 4 : 1;
    for (int i = 0; i < blocks; i++) {
      const int16_t* p = mv_of(nx, 2 * mx + (i & 1), 2 * my + (i >> 1));
      for (int k = 0; k < 2; k++) {
        int pm = p[k], d = k ? dy : dx;
        int fw, bw_;
        if ((unsigned)(pm + 32) < 64) {
          fw = direct_scale[0][pm + 32] + d;
          bw_ = d ? fw - pm : direct_scale[1][pm + 32];
        } else {
          fw = pm * pb_time / pp_time + d;
          bw_ = d ? fw - pm : pm * (pb_time - pp_time) / pp_time;
        }
        f[i][k] = fw;
        bk[i][k] = bw_;
      }
    }
    if (!four) {
      for (int i = 1; i < 4; i++)
        for (int k = 0; k < 2; k++) {
          f[i][k] = f[0][k];
          bk[i][k] = bk[0][k];
        }
      return quarter_sample;  // FFmpeg predicts 16x16 direct by 8x8 blocks under quarter sample
    }
    return true;
  }

  // One macroblock of a B-VOP, decoded and reconstructed.
  void mb_b(Bits& b, int mx, int my) {
    const Tables& T = tables();
    int xy = mb_index(mx, my);
    if (mx == 0) last_mv[0][0] = last_mv[0][1] = last_mv[1][0] = last_mv[1][1] = 0;
    qs[xy] = (int8_t)qscale;
    const Picture& fw_ref = pics[last];
    const Picture& bw_ref = pics[next];
    if (pics[next].kind[xy] & MB_SKIP) {  // skipped in the future P-VOP: skipped here
      stats[B_SKIPPED]++;
      const int zero[1][2] = {{0, 0}};
      motion(fw_ref, mx, my, zero, false, 0, false);
      return;
    }
    int type, cbp = 0;
    if (b.get1()) {  // MODB 1: direct, no vectors or coefficients
      type = -1;
    } else {
      int modb2 = b.get1();
      type = T.b_type.read(b, "B MBTYPE");
      if (!modb2) cbp = (int)b.get(6);
      if (type != 0 && cbp && b.get1()) {
        set_qscale(qscale + b.get1() * 4 - 2);
        stats[DBQUANT]++;
      }
      qs[xy] = (int8_t)qscale;
    }
    int16_t blk[6][64];
    memset(blk, 0, sizeof blk);
    int f[4][2], bk[4][2];
    if (type == 0 || type == -1) {
      int dx = 0, dy = 0;
      if (type == 0) {
        dx = decode_mv(b, 0, 1);
        dy = decode_mv(b, 0, 1);
      }
      stats[B_DIRECT]++;
      bool four = direct_mv(mx, my, dx, dy, f, bk);
      inter_coefs(b, blk, cbp);
      motion(fw_ref, mx, my, f, four, 0, false);
      motion(bw_ref, mx, my, bk, four, 0, true);
    } else {
      bool fwd = type == 1 || type == 3, bwd = type == 1 || type == 2;
      stats[type == 1 ? B_INTERP : type == 2 ? B_BACKWARD : B_FORWARD]++;
      if (fwd) {
        f[0][0] = last_mv[0][0] = decode_mv(b, last_mv[0][0], fcode);
        f[0][1] = last_mv[0][1] = decode_mv(b, last_mv[0][1], fcode);
      }
      if (bwd) {
        bk[0][0] = last_mv[1][0] = decode_mv(b, last_mv[1][0], bcode);
        bk[0][1] = last_mv[1][1] = decode_mv(b, last_mv[1][1], bcode);
      }
      inter_coefs(b, blk, cbp);
      if (fwd) motion(fw_ref, mx, my, f, false, 0, false);
      if (bwd) motion(bw_ref, mx, my, bk, false, 0, fwd);
    }
    stats[INTER]++;
    for (int n = 0; n < 6; n++)
      if ((cbp >> (5 - n)) & 1) add_inter(blk[n], n, mx, my);
  }

  // Data partitioning: the first and second partitions of a video packet
  // from (mx0, my0) (mpeg4_decode_partition_a and _b), then the
  // macroblocks' coefficients (mpeg4_decode_partitioned_mb). Returns the
  // number of macroblocks.
  int partitioned_packet(Bits& b, int mx0, int my0) {
    const Tables& T = tables();
    Picture& pic = pics[cur];
    const int q0 = qscale;
    std::vector<int> mbs;
    // partition A: macroblock types, DQUANT and vectors (P), or DCs (I)
    first_line = true;
    for (int k = mx0 + my0 * mb_w; k < mb_num; k++) {
      int mx = k % mb_w, my = k / mb_w;
      if (mx == resync_x && my == resync_y + 1) first_line = false;
      int xy = k;
      if (vop_type == VOP_I) {
        if (b.peek(19) == 0x6B001) break;  // DC_MARKER
        int cbpc;
        do cbpc = T.intra_mcbpc.read(b, "I MCBPC");
        while (cbpc == 8);
        cbps[xy] = (uint8_t)(cbpc & 3);
        pic.kind[xy] = MB_INTRA;
        if (cbpc & 4) {
          set_qscale(qscale + dquant_tab()[b.get(2)]);
          stats[DQUANT]++;
        }
        qs[xy] = (int8_t)qscale;
        int dir = 0;
        for (int n = 0; n < 6; n++) {
          int d;
          int dc = pred_dc(n, mx, my, read_dc(b, n), d);
          if (dc < 0) fail("a negative intra DC");
          dir = (dir << 1) | d;
        }
        pred_dir[xy] = (uint8_t)dir;
      } else {
        for (;;) {
          if (b.peek(17) == 0x1F001) goto part_a_done;  // MOTION_MARKER
          if (b.get1()) {  // skipped
            pic.kind[xy] = MB_SKIP;
            set_mb_mv(mx, my, 0, 0);
            cbps[xy] = 0;
            break;
          }
          int cbpc = T.inter_mcbpc.read(b, "P MCBPC");
          if (cbpc == 20) continue;
          cbps[xy] = (uint8_t)(cbpc & (8 + 3));
          if (cbpc & 4) {
            pic.kind[xy] = MB_INTRA;
            set_mb_mv(mx, my, 0, 0);
          } else {
            if (!(cbpc & 16)) {
              int px, py;
              pred_motion(0, mx, my, px, py);
              int vx = decode_mv(b, px, fcode), vy = decode_mv(b, py, fcode);
              set_mb_mv(mx, my, vx, vy);
              pic.kind[xy] = 0;
            } else {
              for (int i = 0; i < 4; i++) {
                int px, py;
                pred_motion(i, mx, my, px, py);
                int vx = decode_mv(b, px, fcode), vy = decode_mv(b, py, fcode);
                int16_t* m = mv_of(pic, 2 * mx + (i & 1), 2 * my + (i >> 1));
                m[0] = (int16_t)vx;
                m[1] = (int16_t)vy;
              }
              pic.kind[xy] = MB_4MV;
            }
          }
          break;
        }
      }
      mbs.push_back(k);
    }
  part_a_done:
    if (mbs.empty()) fail("an empty first partition");
    if (vop_type == VOP_I) {
      while (b.peek(9) == 1) b.skip(9);
      if (b.get(19) != 0x6B001) fail("no DC marker after a first partition");
    } else {
      while (b.peek(10) == 1) b.skip(10);
      if (b.get(17) != 0x1F001) fail("no motion marker after a first partition");
    }
    // partition B: ac_pred, CBPY and DQUANT, and the DCs of P-VOPs' intra
    // macroblocks
    first_line = true;
    for (int xy : mbs) {
      int mx = xy % mb_w, my = xy / mb_w;
      if (mx == resync_x && my == resync_y + 1) first_line = false;
      if (vop_type == VOP_I) {
        int ac_pred = b.get1();
        int cbpy = T.cbpy.read(b, "CBPY");
        cbps[xy] |= (uint8_t)(cbpy << 2);
        pic.kind[xy] |= ac_pred ? 8 : 0;
      } else if (pic.kind[xy] & MB_INTRA) {
        int ac_pred = b.get1();
        int cbpy = T.cbpy.read(b, "CBPY");
        if (cbps[xy] & 8) {
          set_qscale(qscale + dquant_tab()[b.get(2)]);
          stats[DQUANT]++;
        }
        qs[xy] = (int8_t)qscale;
        int dir = 0;
        for (int n = 0; n < 6; n++) {
          int d;
          int dc = pred_dc(n, mx, my, read_dc(b, n), d);
          if (dc < 0) fail("a negative intra DC");
          dir = (dir << 1) | d;
        }
        cbps[xy] = (uint8_t)((cbps[xy] & 3) | (cbpy << 2));
        pic.kind[xy] |= ac_pred ? 8 : 0;
        pred_dir[xy] = (uint8_t)dir;
      } else if (pic.kind[xy] & MB_SKIP) {
        qs[xy] = (int8_t)qscale;
        cbps[xy] = 0;
      } else {
        int cbpy = T.cbpy.read(b, "CBPY");
        if (cbps[xy] & 8) {
          set_qscale(qscale + dquant_tab()[b.get(2)]);
          stats[DQUANT]++;
        }
        qs[xy] = (int8_t)qscale;
        cbps[xy] = (uint8_t)((cbps[xy] & 3) | ((cbpy ^ 15) << 2));
      }
    }
    // partition C: the coefficients, and the reconstruction
    first_line = true;
    qscale = q0;
    for (int xy : mbs) {
      int mx = xy % mb_w, my = xy / mb_w;
      if (mx == resync_x && my == resync_y + 1) first_line = false;
      bool dc_vlc = qscale < dc_threshold;
      qscale = qs[xy];
      int kind = pic.kind[xy];
      int cbp = cbps[xy];
      int16_t blk[6][64];
      memset(blk, 0, sizeof blk);
      if (kind & MB_SKIP) {
        stats[SKIPPED]++;
        int v[1][2] = {{0, 0}};
        motion(pics[last], mx, my, v, false, rounding, false);
      } else if (kind & MB_INTRA) {
        if (!dc_vlc) fail("data partitioning with intra_dc_vlc_thr other than 0");
        bool ac_pred = (kind & 8) != 0;
        stats[INTRA]++;
        stats[P_INTRA] += vop_type == VOP_P;
        stats[AC_PRED] += ac_pred;
        for (int n = 0; n < 6; n++)
          intra_coefs(b, blk[n], n, mx, my, (cbp >> (5 - n)) & 1, ac_pred, true,
                      (pred_dir[xy] << n) & 32 ? 1 : 0);
        for (int n = 0; n < 6; n++) put_intra(blk[n], n, mx, my);
        pic.kind[xy] = MB_INTRA;
        set_mb_mv(mx, my, 0, 0);
      } else {
        stats[INTER]++;
        bool four = (kind & MB_4MV) != 0;
        stats[MV4] += four;
        int v[4][2];
        for (int i = 0; i < 4; i++) {
          const int16_t* m = mv_of(pic, 2 * mx + (i & 1), 2 * my + (i >> 1));
          v[i][0] = m[0];
          v[i][1] = m[1];
        }
        inter_coefs(b, blk, cbp);
        motion(pics[last], mx, my, v, four, rounding, false);
        for (int n = 0; n < 6; n++)
          if ((cbp >> (5 - n)) & 1) add_inter(blk[n], n, mx, my);
      }
    }
    return (int)mbs.size();
  }

  // ---------------------------------------------------------- VOP

  // decode_vop_header up to the macroblocks; false when FFmpeg skips the
  // VOP (not coded, or a B-VOP whose times do not fit).
  bool vop_header(Bits& b) {
    if (!have_vol) fail("a VOP before any VOL header");
    int type = (int)b.get(2);
    if (type == VOP_S && !gmc_vol) unsupported("S-VOPs without GMC (sprites)");
    if (type == VOP_B && low_delay && !vol_control) low_delay = false;
    int incr = 0;
    while (b.get1()) incr++;  // modulo_time_base
    b.get(1);
    if (b.left() < (size_t)time_bits + 1 || !(b.peek(time_bits + 1) & 1))
      fail("a VOP's time_increment that does not fit the VOL's resolution");
    int increment = (int)b.get(time_bits);
    if (type != VOP_B) {
      last_time_base = time_base;
      time_base += incr;
      time = time_base * resolution + increment;
      pp_time = (int)(time - last_non_b_time);
      last_non_b_time = time;
    } else {
      time = (last_time_base + incr) * resolution + increment;
      pb_time = pp_time - (int)(last_non_b_time - time);
      if (pp_time <= pb_time || pp_time <= pp_time - pb_time || pp_time <= 0) return false;
      for (int i = 0; i < 64; i++) {
        direct_scale[0][i] = (i - 32) * pb_time / pp_time;
        direct_scale[1][i] = (i - 32) * (pb_time - pp_time) / pp_time;
      }
    }
    b.get(1);
    if (!b.get1()) {  // vop_coded 0: no frame, the references kept (as FFmpeg)
      stats[NOT_CODED]++;
      skipped_last_frame = true;
      return false;
    }
    skipped_last_frame = false;
    vop_type = type;
    rounding = type == VOP_P || type == VOP_S ? b.get1() : 0;
    if (b.left() < 3) fail("truncated VOP header");
    dc_threshold = kDcThreshold[b.get(3)];
    if (type == VOP_S) sprite_trajectory(b);
    qscale = (int)b.get(5);
    if (qscale == 0) fail("vop_quant 0");
    fcode = bcode = 1;
    if (type != VOP_I) {
      fcode = (int)b.get(3);
      if (fcode == 0) fail("vop_fcode_forward 0");
    }
    if (type == VOP_B) {
      bcode = (int)b.get(3);
      if (bcode == 0) fail("vop_fcode_backward 0");
    }
    if (vo_type == 0 && !vol_control && divx_version == -1 && picture_number == 0)
      low_delay = true;
    picture_number++;
    return true;
  }

  // The VOP's macroblocks, video packet by video packet (decode_slice).
  void vop_mbs(Bits& b) {
    bool partitioned = partitioning && vop_type != VOP_B;
    if (partitioned && vop_type == VOP_S) unsupported("data partitioning in S-VOPs (GMC)");
    stats[PARTITIONED] += partitioned;
    stats[vop_type == VOP_I ? I_VOPS : vop_type == VOP_P ? P_VOPS : vop_type == VOP_B ? B_VOPS
                                                                                      : S_VOPS]++;
    stats[ROUNDING] += rounding;
    stats[MPEG_QUANT] += mpeg_quant;
    stats[XVID_IDCT] += xvid_idct;
    for (int p = 0; p < 3; p++) {
      std::fill(dcs[p].begin(), dcs[p].end(), 1024);
      std::fill(acs[p].begin(), acs[p].end(), 0);
    }
    int k = 0;  // the next macroblock
    bool first = true;
    while (k < mb_num) {
      if (!first) {
        int n = video_packet(b);
        if (n != k) fail("a video packet that does not start at the next macroblock");
        clean_buffers(k % mb_w, k / mb_w);
      }
      first = false;
      resync_x = k % mb_w;
      resync_y = k / mb_w;
      first_line = true;
      if (partitioned) {
        k += partitioned_packet(b, resync_x, resync_y);
        if (k < mb_num && !is_resync(b, true)) fail("a partitioned video packet without an end");
        continue;
      }
      for (;;) {
        int mx = k % mb_w, my = k / mb_w;
        if (mx == resync_x && my == resync_y + 1) first_line = false;
        if (vop_type == VOP_B)
          mb_b(b, mx, my);
        else
          mb_ip(b, mx, my);
        k++;
        if (k == mb_num) break;
        if (slice_check(b, mx, my) == kSliceEnd) break;
      }
    }
  }

  // Make a copy of picture `p` ready for output (in the buffers of a frame
  // taken before, so that no call allocates them anew).
  void emit(int p) {
    Ready r = std::move(spare);
    for (int k = 0; k < 3; k++) r.plane[k].assign(pics[p].plane[k].begin(), pics[p].plane[k].end());
    r.packet = pics[p].packet;
    ready.push_back(std::move(r));
  }

  int free_slot() const {
    for (int s = 0; s < 3; s++)
      if (s != last && s != next) return s;
    return 0;
  }

  // The first VOP of `src` and the headers before it (ff_h263_decode_frame
  // to the end of the frame); the number of frames it made ready. `vop_end`
  // is where the VOP's data ended.
  int decode_one(const uint8_t* src, size_t n, bool from_stored, size_t& vop_end) {
    vop_end = 0;
    size_t i = 0;
    bool vol_seen = false, any = false;
    for (;;) {
      // the next start code
      while (i + 3 < n && !(src[i] == 0 && src[i + 1] == 0 && src[i + 2] == 1)) i++;
      if (i + 3 >= n) {
        if (any) return -1;  // headers only
        if (n == 1 && (divx_version >= 0 || xvid_build >= 0)) return 0;  // a drop frame
        if (n >= 3 && src[0] == 0 && src[1] == 0 && (src[2] & 0xfc) == 0x80)
          unsupported("the short video header (H.263)");
        fail("a packet without an MPEG-4 start code");
      }
      any = true;
      uint8_t code = src[i + 3];
      size_t s = i + 4;
      size_t e = s;
      while (e + 2 < n && !(src[e] == 0 && src[e + 1] == 0 && src[e + 2] == 1)) e++;
      if (e + 2 >= n) e = n;
      Bits b(src + s, e - s);
      if (code <= 0x1f) {
        if (e - s >= 3 && src[s] == 0 && src[s + 1] == 0 && (src[s + 2] & 0xfc) == 0x80)
          unsupported("the short video header (H.263)");
      } else if (code <= 0x2f) {
        if (!vol_seen) vol(b);
        vol_seen = true;
      } else if (code == 0xb2) {
        user_data(b);
      } else if (code == 0xb5) {
        visual_object(b);
      } else if (code == 0xb6) {
        // the VOP's data runs to the packet's end (FFmpeg reads past it only
        // to look for a resync marker)
        Bits v(src + s, n - s);
        workarounds();
        if (!vop_header(v)) return 0;
        if ((vop_type == VOP_P || vop_type == VOP_S) && next < 0)
          fail("a P-VOP before any I-VOP");
        if (vop_type == VOP_B && (last < 0 || next < 0)) return 0;  // no references yet
        cur = free_slot();
        if (vop_type != VOP_B) {
          last = next;
          next = cur;
        }
        pics[cur].packet = packets - 1;
        stats[PACKED] += from_stored;
        vop_mbs(v);
        vop_end = s + v.pos / 8;
        if (vop_type == VOP_B || low_delay) {
          emit(cur);
          return 1;
        }
        if (last >= 0) {
          emit(last);
          return 1;
        }
        return 0;
      } else if (code == 0xb3) {
        // group of VOPs: its time code sets the time base (mpeg4_decode_gop_header)
        if (b.peek(23)) {
          int hours = (int)b.get(5), minutes = (int)b.get(6);
          b.get(1);
          time_base = (int)b.get(6) + 60 * (minutes + 60 * hours);
        }
      } else if (code == 0xb0 || code == 0xb1) {
        // visual object sequence start and end: nothing to keep
      } else if (code >= 0xb7 && code <= 0xb9) {
        fail("reserved start code");
      } else {
        char name[8];
        snprintf(name, sizeof name, "%02x", code);
        unsupported(std::string("start code 0x") + name);
      }
      i = e;
    }
  }

  // One packet: the frames it made ready (0 or 1), or -1 for headers only.
  int decode(const uint8_t* data, size_t n) {
    if (divx_packed && !stored.empty()) {
      for (size_t i = 0; i + 3 < n; i++)
        if (data[i] == 0 && data[i + 1] == 0 && data[i + 2] == 1) {
          if (data[i + 3] == 0xb0) stored.clear();  // excessive bitstream in packed xvid
          break;
        }
    }
    std::vector<uint8_t> src;
    bool from_stored = !stored.empty() && (divx_packed || n <= 19);
    if (from_stored) src.swap(stored);
    stored.clear();
    size_t end = 0;
    int got = from_stored ? decode_one(src.data(), src.size(), true, end)
                          : decode_one(data, n, false, end);
    if (end && divx_packed) {
      // ff_mpeg4_frame_end: keep the packet's rest when it holds an I- or
      // B-VOP, for the next packet
      size_t pos = from_stored ? 0 : end;
      if (n > pos + 7) {
        for (size_t i = pos; i + 4 < n; i++)
          if (data[i] == 0 && data[i + 1] == 0 && data[i + 2] == 1 && data[i + 3] == 0xb6) {
            if (!(data[i + 4] & 0x40)) stored.assign(data + pos, data + n);
            break;
          }
      }
    }
    return got;
  }

  int flush() {
    if ((!low_delay || skipped_last_frame) && next >= 0) {
      emit(next);
      next = -1;
      return 1;
    }
    return 0;
  }

  // A call to m4v_decode or m4v_flush: a frame the last one made ready and
  // nobody took is dropped (it still counts as the frame read last).
  void begin_call() {
    while (!ready.empty()) take();
  }
  void take() {
    spare = std::move(shown);
    shown = std::move(ready.front());
    ready.pop_front();
    have_shown = true;
  }
  bool have_frame() const { return have_shown || !ready.empty(); }
  // The frame read by m4v_frame and m4v_planes: the one taken last, or the
  // one made ready by the last call before it is taken.
  const Ready& current() const { return ready.empty() ? shown : ready.front(); }

  // The current frame cropped to the VOL size: RGB (swscale's yuv420p ->
  // bgr24 SSSE3 path, in RGB order) and luma, either may be null.
  void output(uint8_t* rgb, uint8_t* luma) const {
    const Ready& f = current();
    const uint8_t* Y = f.plane[0].data();
    const uint8_t* U = f.plane[1].data();
    const uint8_t* V = f.plane[2].data();
    if (luma)
      for (int r = 0; r < height; r++)
        memcpy(luma + (size_t)r * width, Y + (size_t)r * stride[0], width);
    if (rgb) yuv420_to_rgb(Y, stride[0], U, V, stride[1], width, height, rgb);
  }

  // The current frame's planes cropped to the VOL size: luma [H, W],
  // chroma [(H + 1) / 2, (W + 1) / 2].
  void planes(uint8_t* y, uint8_t* u, uint8_t* v) const {
    const Ready& f = current();
    int cw = (width + 1) / 2, ch = (height + 1) / 2;
    for (int r = 0; r < height; r++)
      memcpy(y + (size_t)r * width, f.plane[0].data() + (size_t)r * stride[0], width);
    for (int r = 0; r < ch; r++) {
      memcpy(u + (size_t)r * cw, f.plane[1].data() + (size_t)r * stride[1], cw);
      memcpy(v + (size_t)r * cw, f.plane[2].data() + (size_t)r * stride[2], cw);
    }
  }
};

int report(const CodecError& e, char* err, size_t err_len) {
  if (err && err_len) snprintf(err, err_len, "%s", e.msg.c_str());
  return e.unsupported ? -2 : -1;
}

}  // namespace

extern "C" {

void* m4v_new() { return new Decoder(); }

void m4v_free(void* h) { delete static_cast<Decoder*>(h); }

// The container's fourcc (AVI's biCompression), which FFmpeg reads as a
// hint of the encoder where the stream's user data names none.
void m4v_tag(void* h, const char* fourcc) {
  static_cast<Decoder*>(h)->tag = Decoder::fourcc(fourcc);
}

// Decode one packet: the number of frames it made ready (0 or 1: the frame
// it completed in display order; none for headers only, a VOP not coded,
// or the first I- or P-VOP of a stream with B-VOPs).
int m4v_decode(void* h, const uint8_t* data, size_t size, char* err, size_t err_len) {
  Decoder* d = static_cast<Decoder*>(h);
  try {
    d->begin_call();
    d->packets++;
    return std::max(d->decode(data, size), 0);
  } catch (const CodecError& e) {
    return report(e, err, err_len);
  } catch (const std::bad_alloc&) {
    return report(CodecError{"out of memory", false}, err, err_len);
  }
}

// Headers to read before the packets (an MP4's VOL): not a packet, and
// without a VOP.
int m4v_config(void* h, const uint8_t* data, size_t size, char* err, size_t err_len) {
  try {
    size_t end;
    if (static_cast<Decoder*>(h)->decode_one(data, size, false, end) != -1)
      return report(CodecError{"a decoder configuration holding a VOP", false}, err, err_len);
    return 0;
  } catch (const CodecError& e) {
    return report(e, err, err_len);
  } catch (const std::bad_alloc&) {
    return report(CodecError{"out of memory", false}, err, err_len);
  }
}

// The end of the stream: the frame that waits for output (the last I- or
// P-VOP of a stream with B-VOPs), 1 if there is one.
int m4v_flush(void* h, char* err, size_t err_len) {
  try {
    static_cast<Decoder*>(h)->begin_call();
    return static_cast<Decoder*>(h)->flush();
  } catch (const std::bad_alloc&) {
    return report(CodecError{"out of memory", false}, err, err_len);
  }
}

// Take the next ready frame (m4v_frame and m4v_planes read it); *packet is
// the m4v_decode call (0, 1, ...) that decoded it. Returns 1 when none is
// ready.
int m4v_next(void* h, int64_t* packet) {
  Decoder* d = static_cast<Decoder*>(h);
  if (d->ready.empty()) return 1;
  d->take();
  *packet = d->shown.packet;
  return 0;
}

// The VOL's size, 0 x 0 before one; the encoder's user data, if any.
int m4v_info(void* h, int* height, int* width, char* encoder, size_t encoder_len) {
  const Decoder* d = static_cast<Decoder*>(h);
  *height = d->height;
  *width = d->width;
  if (encoder && encoder_len) snprintf(encoder, encoder_len, "%s", d->encoder.c_str());
  return 0;
}

// The counts of Decoder::stats, at most n of them; returns how many there are.
int m4v_stats(void* h, int64_t* out, int n) {
  const Decoder* d = static_cast<Decoder*>(h);
  for (int i = 0; i < std::min(n, (int)Decoder::N_STATS); i++) out[i] = d->stats[i];
  return Decoder::N_STATS;
}

// The frame taken last (or made ready by the last call and not yet taken):
// uint8 RGB [H, W, 3] and luma [H, W] (either may be null); -1 before the
// first frame.
int m4v_frame(void* h, uint8_t* rgb, uint8_t* luma, char* err, size_t err_len) {
  const Decoder* d = static_cast<Decoder*>(h);
  if (!d->have_frame()) return report(CodecError{"no decoded frame", false}, err, err_len);
  d->output(rgb, luma);
  return 0;
}

// The planes of the frame m4v_frame reads: Y [H, W], U and V [(H + 1) / 2,
// (W + 1) / 2]; -1 before the first frame.
int m4v_planes(void* h, uint8_t* y, uint8_t* u, uint8_t* v, char* err, size_t err_len) {
  const Decoder* d = static_cast<Decoder*>(h);
  if (!d->have_frame()) return report(CodecError{"no decoded frame", false}, err, err_len);
  d->planes(y, u, v);
  return 0;
}

}  // extern "C"
