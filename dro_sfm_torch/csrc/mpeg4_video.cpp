// Host MPEG-4 Part 2 (ISO/IEC 14496-2) video decoder of the port, in plain
// C++ with a C interface (loaded with ctypes, which releases the interpreter
// lock around each call). It decodes the streams that FFmpeg's "mpeg4"
// encoder writes (fourcc mp4v, FMP4, XVID, DIVX, DX50), as FFmpeg's decoder
// decodes them with its defaults:
//   * Simple Profile tools: I- and P-VOPs, rectangular 8-bit 4:2:0,
//     H.263 quantisation, one motion vector a macroblock;
//   * intra DC by its size VLCs, gradient-selected DC prediction and the
//     dc_scaler of the QP; AC prediction of the first row or column,
//     rescaled where the neighbour's QP differs; the three TCOEF escapes;
//     the zigzag and alternate scans;
//   * median motion-vector prediction with f_code range wrapping, half-pel
//     motion compensation with rounding_type, the chroma vector rounded as
//     (mv >> 1) | (mv & 1), unrestricted vectors read from the reference
//     with coordinates clamped to its whole macroblocks (FFmpeg's
//     h_edge_pos and v_edge_pos: a VOP of 200x136 is read as 208x144);
//   * the integer "simple" IDCT (simple_idct_template.c, 8 bits) that
//     FFmpeg runs for a stream whose user data names Lavc;
//   * output cropped to the VOL size; RGB as swscale converts yuv420p to
//     bgr24 at the same size (BT.601, limited range, its SSSE3 path: each
//     term 16-bit fixed point, the chroma of each 2x2 luma block shared).
// Refused with a message (-2): B- and S-VOPs, sprites, interlace, quarter
// sample, data partitioning and RVLC, a resync marker met, the short video
// header (H.263), quant_type 1, not_8_bit, a non-rectangular shape, four
// motion vectors, OBMC, scalability, newpred, reduced resolution, complexity
// estimation, chroma other than 4:2:0, several VOPs in one packet. A
// truncated or corrupt stream fails (-1): every bit read and every motion
// vector is bounds-checked.
//
// Every entry point returns 0 on success (m4v_decode: the number of frames
// the packet made ready, 1, or 0 for headers only or a VOP not coded, which
// FFmpeg drops too; m4v_flush: 0, as no VOP waits), else -1 (a broken
// stream) or -2 (a valid one that is not supported) with a message in err.
// The decoder keeps the reference frame between calls; the frame a packet
// made ready is taken (m4v_next) before the next packet.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
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
  throw CodecError{msg + " is not supported by the port's MPEG-4 decoder (ROADMAP C)", true};
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

struct Tables {
  Vlc intra_mcbpc, inter_mcbpc, cbpy, mv, dc_lum, dc_chrom;
  Tcoef intra, inter;
  Tables() {
    intra_mcbpc.init(kIntraMcbpc, 9);
    inter_mcbpc.init(kInterMcbpc, 28);
    cbpy.init(kCbpy, 16);
    mv.init(kMv, 33);
    dc_lum.init(kDcLum, 13);
    dc_chrom.init(kDcChrom, 13);
    intra.init(kIntraVlc, kIntraRun, kIntraLevel, kIntraLast);
    inter.init(kInterVlc, kInterRun, kInterLevel, kInterLast);
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

// ---------------------------------------------------------------- decoder

inline int median3(int a, int b, int c) {
  return std::max(std::min(a, b), std::min(std::max(a, b), c));
}

struct Decoder {
  // VOL
  bool have_vol = false;
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  int time_bits = 1;
  std::string encoder;  // the user data that names the encoder, if any
  // planes at whole macroblocks: Y (16 mb_w x 16 mb_h), Cb, Cr (8 mb_w x 8 mb_h)
  std::vector<uint8_t> cur[3], ref[3];
  int stride[3] = {0, 0, 0};
  bool have_ref = false, have_frame = false;
  int64_t packets = 0, ready_packet = 0;  // m4v_decode calls; the ready frame's
  bool ready = false;
  // what the decoded VOPs held (m4v_stats): I-VOPs, P-VOPs, intra, inter
  // and skipped macroblocks, intra macroblocks of P-VOPs, AC-predicted and
  // DQUANT macroblocks, TCOEF escapes of types 1, 2 and 3, predictions read
  // partly outside the VOP, half-pel predictions, VOPs with rounding_type 1,
  // AC predictions rescaled to another QP
  enum { I_VOPS, P_VOPS, INTRA, INTER, SKIPPED, P_INTRA, AC_PRED, DQUANT, ESC1, ESC2, ESC3,
         OUTSIDE, HALF_PEL, ROUNDING, AC_RESCALE, N_STATS };
  int64_t stats[N_STATS] = {};
  // per VOP
  int vop_type = 0, qscale = 1, rounding = 0, fcode = 1, dc_threshold = 99;
  // per macroblock and block of the VOP being decoded
  std::vector<int16_t> mvs;     // 2 a macroblock
  std::vector<int8_t> qs;       // QP a macroblock
  std::vector<int16_t> dcs[3];  // the dequantised DC of each intra block, else 1024
  std::vector<int16_t> acs[3];  // 16 a block: first column at 1-7, first row at 9-15
  int bw[3] = {0, 0, 0};        // blocks a row: luma 2 mb_w, chroma mb_w

  void setup(int w, int h) {
    width = w;
    height = h;
    mb_w = (w + 15) / 16;
    mb_h = (h + 15) / 16;
    stride[0] = 16 * mb_w;
    stride[1] = stride[2] = 8 * mb_w;
    for (int p = 0; p < 3; p++) {
      size_t n = (size_t)stride[p] * (p ? 8 : 16) * mb_h;
      cur[p].assign(n, 0);
      ref[p].assign(n, 0);
    }
    bw[0] = 2 * mb_w;
    bw[1] = bw[2] = mb_w;
    mvs.assign(2 * (size_t)mb_w * mb_h, 0);
    qs.assign((size_t)mb_w * mb_h, 0);
    for (int p = 0; p < 3; p++) {
      size_t n = (size_t)bw[p] * (p ? mb_h : 2 * mb_h);
      dcs[p].assign(n, 1024);
      acs[p].assign(16 * n, 0);
    }
    have_ref = have_frame = false;
  }

  // ---------------------------------------------------------- headers

  void visual_object(Bits& b) {
    if (b.get1()) b.get(7);  // is_visual_object_identifier: verid, priority
    int type = (int)b.get(4);
    if (type != 1) unsupported("visual object type " + std::to_string(type) + " (not video)");
  }

  void vol(Bits& b) {
    b.get(1 + 8);  // random_accessible_vol, video_object_type_indication
    int verid = 1;
    if (b.get1()) {
      verid = (int)b.get(4);
      b.get(3);
    }
    if ((int)b.get(4) == 15) b.get(16);  // extended PAR
    if (b.get1()) {                        // vol_control_parameters
      int chroma = (int)b.get(2);
      if (chroma != 1) unsupported("chroma format " + std::to_string(chroma) + " (not 4:2:0)");
      b.get(1);  // low_delay: the B-VOPs it allows are refused where met
      if (b.get1()) b.skip(15 + 1 + 15 + 1 + 15 + 1 + 3 + 11 + 1 + 15 + 1);  // vbv
    }
    int shape = (int)b.get(2);
    if (shape != 0) unsupported("a non-rectangular VOL shape");
    b.get(1);
    int resolution = (int)b.get(16);
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
    if (sprite) unsupported("sprites or GMC (S-VOPs)");
    if (b.get1()) unsupported("not_8_bit");
    if (b.get1()) unsupported("quant_type 1 (MPEG quantisation)");
    if (verid != 1 && b.get1()) unsupported("quarter_sample");
    if (!b.get1()) unsupported("complexity estimation");
    b.get(1);  // resync_marker_disable: a marker is refused where met
    if (b.get1()) unsupported("data partitioning (and RVLC)");
    if (verid != 1) {
      if (b.get1()) unsupported("newpred");
      if (b.get1()) unsupported("reduced resolution VOPs");
    }
    if (b.get1()) unsupported("scalability");
    if (!have_vol || w != width || h != height) setup(w, h);
    have_vol = true;
  }

  void user_data(const uint8_t* p, size_t n) {
    std::string s((const char*)p, std::min<size_t>(n, 64));
    for (const char* tag : {"Lavc", "XviD", "DivX", "FFmpe"})
      if (s.compare(0, strlen(tag), tag) == 0) encoder = s.substr(0, s.find('\0'));
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

  // DC prediction (ff_mpeg4_pred_dc): the quantised DC of the block from
  // its coded difference, its direction (0 left, 1 top); stores its
  // dequantised DC for its neighbours.
  int pred_dc(int n, int mx, int my, int level, int& dir) {
    int p, bx, by;
    block_pos(n, mx, my, p, bx, by);
    int scale = n < 4 ? luma_dc_scale(qscale) : chroma_dc_scale(qscale);
    int a = dc_at(p, bx - 1, by), b = dc_at(p, bx - 1, by - 1), c = dc_at(p, bx, by - 1);
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

  // The TCOEF run of a block from scan position `i` + 1 on, into `blk` at
  // `scan`; levels dequantised as level * qmul +- qadd (qmul 1 and qadd 0
  // for intra blocks, which are dequantised later).
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

  // One intra block: decoded, predicted, dequantised and written.
  void intra_block(Bits& b, int n, int mx, int my, bool coded, bool ac_pred, bool dc_vlc,
                   uint8_t* dst, int dstride) {
    const Tables& T = tables();
    int16_t blk[64] = {0};
    int dir = 0, i;
    if (dc_vlc) {
      int size = (n < 4 ? T.dc_lum : T.dc_chrom).read(b, "DC size");
      if (size > 9) fail("intra DC size past 9");
      int diff = 0;
      if (size) {
        diff = b.xbits(size);
        if (size > 8) b.get(1);  // marker
      }
      blk[0] = (int16_t)pred_dc(n, mx, my, diff, dir);
      i = 0;
    } else {
      pred_dc(n, mx, my, 0, dir);
      i = -1;
    }
    if (coded) {
      const uint8_t* scan = ac_pred ? (dir == 0 ? kAltVertical : kAltHorizontal) : kZigzag;
      tcoef(b, T.intra, blk, scan, i, 1, 0);
    }
    if (!dc_vlc) blk[0] = (int16_t)pred_dc(n, mx, my, blk[0], dir);
    pred_ac(blk, n, mx, my, dir, ac_pred);
    int scale = n < 4 ? luma_dc_scale(qscale) : chroma_dc_scale(qscale);
    int qmul = 2 * qscale, qadd = (qscale - 1) | 1;
    blk[0] = (int16_t)(blk[0] * scale);
    for (int k = 1; k < 64; k++) {
      int v = blk[k];
      if (v) blk[k] = (int16_t)(v < 0 ? v * qmul - qadd : v * qmul + qadd);
    }
    idct(blk, dst, dstride, false);
  }

  // ---------------------------------------------------------- motion

  // Half-pel prediction of a w x w block at (x + mvx/2, y + mvy/2) of
  // plane p of the reference, coordinates clamped to its whole macroblocks.
  void predict(int p, int x, int y, int mvx, int mvy, int w, uint8_t* dst) {
    int ew = p ? 8 * mb_w : 16 * mb_w, eh = p ? 8 * mb_h : 16 * mb_h;
    stats[HALF_PEL] += (mvx & 1) | (mvy & 1);
    stats[OUTSIDE] += predict_block(ref[p].data(), stride[p], ew, eh, x, y, mvx, mvy, w, rounding,
                                    dst, stride[p]);
  }

  void motion(int mx, int my, int mvx, int mvy) {
    uint8_t* y = cur[0].data() + (size_t)16 * my * stride[0] + 16 * mx;
    predict(0, 16 * mx, 16 * my, mvx, mvy, 16, y);
    int cx = chroma_mv(mvx), cy = chroma_mv(mvy);
    for (int p = 1; p < 3; p++)
      predict(p, 8 * mx, 8 * my, cx, cy, 8, cur[p].data() + (size_t)8 * my * stride[p] + 8 * mx);
  }

  int mv_at(int mx, int my, int k) const {
    if (mx < 0 || mx >= mb_w || my < 0) return 0;
    return mvs[2 * (size_t)mb_index(mx, my) + k];
  }

  int decode_mv(Bits& b, int pred) {
    int code = tables().mv.read(b, "motion vector");
    if (code == 0) return pred;
    int sign = b.get1();
    int shift = fcode - 1;
    int val = code;
    if (shift) {
      val = (val - 1) << shift;
      val |= (int)b.get(shift);
      val++;
    }
    if (sign) val = -val;
    val += pred;
    int bits = 5 + fcode;
    return (int)((uint32_t)val << (32 - bits)) >> (32 - bits);
  }

  // A resync marker at the next byte boundary after the macroblock stuffing
  // (0 then ones), as mpeg4_is_resync looks for it.
  bool at_resync(const Bits& b) const {
    int k = 8 - (int)(b.pos & 7);
    Bits t = b;
    if (t.left() < (size_t)k + 17 || t.peek(k) != ((1u << (k - 1)) - 1)) return false;
    t.pos += k;
    int zeros = 0;
    while (zeros < 32 && t.left() > 0 && t.peek(1) == 0) {
      zeros++;
      t.pos++;
    }
    return t.left() > 0 && zeros >= (vop_type == 0 ? 16 : 15 + fcode);
  }

  // ---------------------------------------------------------- VOP

  void vop(Bits& b) {
    if (!have_vol) fail("a VOP before any VOL header");
    int type = (int)b.get(2);
    if (type == 2) unsupported("B-VOPs");
    if (type == 3) unsupported("S-VOPs (sprites or GMC)");
    while (b.get1()) {
    }  // modulo_time_base
    b.get(1);
    b.get(time_bits);
    b.get(1);
    if (!b.get1()) return;  // vop_coded 0: no frame, the reference kept (as FFmpeg)
    if (type == 1 && !have_ref) fail("a P-VOP before any I-VOP");
    vop_type = type;
    rounding = type == 1 ? b.get1() : 0;
    stats[type == 1 ? P_VOPS : I_VOPS]++;
    stats[ROUNDING] += rounding;
    dc_threshold = kDcThreshold[b.get(3)];
    qscale = (int)b.get(5);
    if (qscale == 0) fail("vop_quant 0");
    fcode = 1;
    if (type == 1) {
      fcode = (int)b.get(3);
      if (fcode == 0) fail("vop_fcode_forward 0");
    }
    for (int p = 0; p < 3; p++) {
      std::fill(dcs[p].begin(), dcs[p].end(), 1024);
      std::fill(acs[p].begin(), acs[p].end(), 0);
    }
    std::fill(mvs.begin(), mvs.end(), 0);
    const Tables& T = tables();
    static const int kDquant[4] = {-1, -2, 1, 2};
    for (int my = 0; my < mb_h; my++) {
      for (int mx = 0; mx < mb_w; mx++) {
        if ((mx || my) && at_resync(b)) unsupported("resync markers (video packets)");
        int cbpc;
        bool intra;
        int xy = mb_index(mx, my);
        if (type == 1) {
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
            motion(mx, my, 0, 0);
            continue;
          }
          if (cbpc & 16) unsupported("four motion vectors a macroblock (inter4v)");
          intra = (cbpc & 4) != 0;
        } else {
          do cbpc = T.intra_mcbpc.read(b, "I MCBPC");
          while (cbpc == 8);
          intra = true;
        }
        bool dquant = type == 1 ? (cbpc & 8) != 0 : (cbpc & 4) != 0;
        stats[DQUANT] += dquant;
        stats[intra ? INTRA : INTER]++;
        stats[P_INTRA] += intra && type == 1;
        if (intra) {
          bool ac_pred = b.get1();
          stats[AC_PRED] += ac_pred;
          int cbpy = T.cbpy.read(b, "CBPY");
          int cbp = (cbpc & 3) | (cbpy << 2);
          bool dc_vlc = qscale < dc_threshold;
          if (dquant) qscale = std::min(std::max(qscale + kDquant[b.get(2)], 1), 31);
          qs[xy] = (int8_t)qscale;
          for (int n = 0; n < 6; n++) {
            int p = n < 4 ? 0 : n - 3;
            int s = stride[p];
            uint8_t* dst = n < 4 ? cur[0].data() + (size_t)(16 * my + 8 * (n >> 1)) * s +
                                       16 * mx + 8 * (n & 1)
                                 : cur[p].data() + (size_t)8 * my * s + 8 * mx;
            intra_block(b, n, mx, my, (cbp >> (5 - n)) & 1, ac_pred, dc_vlc, dst, s);
          }
        } else {
          int cbpy = T.cbpy.read(b, "CBPY") ^ 15;
          int cbp = (cbpc & 3) | (cbpy << 2);
          if (dquant) qscale = std::min(std::max(qscale + kDquant[b.get(2)], 1), 31);
          qs[xy] = (int8_t)qscale;
          int px = median3(mv_at(mx - 1, my, 0), mv_at(mx, my - 1, 0), mv_at(mx + 1, my - 1, 0));
          int py = median3(mv_at(mx - 1, my, 1), mv_at(mx, my - 1, 1), mv_at(mx + 1, my - 1, 1));
          if (my == 0) {  // the first row: the left vector, or 0
            px = mv_at(mx - 1, my, 0);
            py = mv_at(mx - 1, my, 1);
          }
          int mvx = decode_mv(b, px), mvy = decode_mv(b, py);
          mvs[2 * (size_t)xy] = (int16_t)mvx;
          mvs[2 * (size_t)xy + 1] = (int16_t)mvy;
          motion(mx, my, mvx, mvy);
          int qmul = 2 * qscale, qadd = (qscale - 1) | 1;
          for (int n = 0; n < 6; n++) {
            if (!((cbp >> (5 - n)) & 1)) continue;
            int16_t blk[64] = {0};
            tcoef(b, T.inter, blk, kZigzag, -1, qmul, qadd);
            int p = n < 4 ? 0 : n - 3;
            int s = stride[p];
            uint8_t* dst = n < 4 ? cur[0].data() + (size_t)(16 * my + 8 * (n >> 1)) * s +
                                       16 * mx + 8 * (n & 1)
                                 : cur[p].data() + (size_t)8 * my * s + 8 * mx;
            idct(blk, dst, s, true);
          }
        }
      }
    }
    for (int p = 0; p < 3; p++) std::swap(cur[p], ref[p]);  // the new reference
    have_ref = have_frame = true;
  }

  // One packet: its headers, and the VOP it holds, if any. 0: a frame, 1:
  // headers only.
  int decode(const uint8_t* data, size_t n) {
    std::vector<size_t> starts;
    for (size_t i = 0; i + 3 < n; i++)
      if (data[i] == 0 && data[i + 1] == 0 && data[i + 2] == 1) {
        starts.push_back(i);
        i += 2;
      }
    if (starts.empty()) {
      if (n >= 3 && data[0] == 0 && data[1] == 0 && (data[2] & 0xfc) == 0x80)
        unsupported("the short video header (H.263)");
      fail("a packet without an MPEG-4 start code");
    }
    int vops = 0;
    have_frame = false;
    for (size_t k = 0; k < starts.size(); k++) {
      size_t s = starts[k] + 4, e = k + 1 < starts.size() ? starts[k + 1] : n;
      uint8_t code = data[starts[k] + 3];
      Bits b(data + s, e - s);
      if (code <= 0x1f) {
        if (e - s >= 3 && data[s] == 0 && data[s + 1] == 0 && (data[s + 2] & 0xfc) == 0x80)
          unsupported("the short video header (H.263)");
      } else if (code <= 0x2f) {
        vol(b);
      } else if (code == 0xb2) {
        user_data(data + s, e - s);
      } else if (code == 0xb5) {
        visual_object(b);
      } else if (code == 0xb6) {
        if (++vops > 1) unsupported("several VOPs in one packet (packed bitstream)");
        // the VOP's macroblocks may hold bytes that look like a start code
        // only where the stream is broken; it runs to the packet's end
        Bits v(data + s, n - s);
        vop(v);
        break;
      } else if (code == 0xb0 || code == 0xb1 || code == 0xb3) {
        // visual object sequence start and end, group of VOPs: nothing to keep
      } else if (code >= 0xb7 && code <= 0xb9) {
        fail("reserved start code");
      } else {
        char name[8];
        snprintf(name, sizeof name, "%02x", code);
        unsupported(std::string("start code 0x") + name);
      }
    }
    return have_frame ? 0 : 1;
  }

  // The last frame cropped to the VOL size: RGB (swscale's yuv420p ->
  // bgr24 SSSE3 path, in RGB order) and luma, either may be null.
  void output(uint8_t* rgb, uint8_t* luma) const {
    const uint8_t* Y = ref[0].data();
    const uint8_t* U = ref[1].data();
    const uint8_t* V = ref[2].data();
    if (luma)
      for (int r = 0; r < height; r++)
        memcpy(luma + (size_t)r * width, Y + (size_t)r * stride[0], width);
    if (rgb) yuv420_to_rgb(Y, stride[0], U, V, stride[1], width, height, rgb);
  }

  // The last frame's planes cropped to the VOL size: luma [H, W], chroma
  // [(H + 1) / 2, (W + 1) / 2].
  void planes(uint8_t* y, uint8_t* u, uint8_t* v) const {
    int cw = (width + 1) / 2, ch = (height + 1) / 2;
    for (int r = 0; r < height; r++)
      memcpy(y + (size_t)r * width, ref[0].data() + (size_t)r * stride[0], width);
    for (int r = 0; r < ch; r++) {
      memcpy(u + (size_t)r * cw, ref[1].data() + (size_t)r * stride[1], cw);
      memcpy(v + (size_t)r * cw, ref[2].data() + (size_t)r * stride[2], cw);
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

// Decode one packet (headers and at most one VOP): the number of frames it
// made ready, 1 when it gave a frame, 0 when it held headers only or a VOP
// not coded.
int m4v_decode(void* h, const uint8_t* data, size_t size, char* err, size_t err_len) {
  Decoder* d = static_cast<Decoder*>(h);
  try {
    int64_t packet = d->packets++;
    d->ready = false;
    if (d->decode(data, size) != 0) return 0;
    d->ready = true;
    d->ready_packet = packet;
    return 1;
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
    if (static_cast<Decoder*>(h)->decode(data, size) == 0)
      return report(CodecError{"a decoder configuration holding a VOP", false}, err, err_len);
    return 0;
  } catch (const CodecError& e) {
    return report(e, err, err_len);
  } catch (const std::bad_alloc&) {
    return report(CodecError{"out of memory", false}, err, err_len);
  }
}

// The end of the stream: no VOP waits for output (no B-VOPs), so none.
int m4v_flush(void*, char*, size_t) { return 0; }

// Take the frame the last packet made ready (m4v_frame and m4v_planes read
// it); *packet is the m4v_decode call (0, 1, ...) that gave it. Returns 1
// when none is ready.
int m4v_next(void* h, int64_t* packet) {
  Decoder* d = static_cast<Decoder*>(h);
  if (!d->ready) return 1;
  d->ready = false;
  *packet = d->ready_packet;
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

// The frame taken last (the last decoded one): uint8 RGB [H, W, 3] and luma
// [H, W] (either may be null); -1 before the first frame.
int m4v_frame(void* h, uint8_t* rgb, uint8_t* luma, char* err, size_t err_len) {
  const Decoder* d = static_cast<Decoder*>(h);
  if (!d->have_ref) return report(CodecError{"no decoded frame", false}, err, err_len);
  d->output(rgb, luma);
  return 0;
}

// The planes of the frame taken last: Y [H, W], U and V [(H + 1) / 2,
// (W + 1) / 2]; -1 before the first frame.
int m4v_planes(void* h, uint8_t* y, uint8_t* u, uint8_t* v, char* err, size_t err_len) {
  const Decoder* d = static_cast<Decoder*>(h);
  if (!d->have_ref) return report(CodecError{"no decoded frame", false}, err, err_len);
  d->planes(y, u, v);
  return 0;
}

}  // extern "C"
