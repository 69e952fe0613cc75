// Host MPEG-4 Part 2 (ISO/IEC 14496-2) Simple Profile video encoder of the
// port, in plain C++ with a C interface (loaded with ctypes, which releases
// the interpreter lock around each call). It writes what the port's decoder
// (mpeg4_video.cpp) and FFmpeg's read, with the tools FFmpeg's "mpeg4"
// encoder uses under OpenCV's mp4v writer:
//   * VOS, VO and VOL headers: rectangular, 8-bit 4:2:0, H.263 quantisation
//     (quant_type 0), no interlace, no quarter sample, no resync markers, no
//     data partitioning; vop_time_increment_resolution the rate's;
//   * an I-VOP every `gop` frames and P-VOPs between them, no B-VOPs;
//   * RGB to YUV 4:2:0 with BT.601's limited-range integer rule, chroma the
//     mean of each 2x2 block; edge macroblocks padded by replication;
//   * a float forward DCT and H.263 quantisation at one QP (intra AC
//     truncated, inter with a quarter-step dead zone), intra DC by its size
//     VLCs against the decoder's gradient DC prediction, ac_pred_flag 0, no
//     DQUANT, the three TCOEF escapes where the tables end;
//   * one half-pel motion vector a macroblock from a predictor-seeded search
//     (the median predictor, zero, the co-located vector, the neighbours'),
//     a small diamond at whole pels and a half-pel refinement, coded
//     against the median predictor with the smallest f_code that holds the
//     VOP's vectors; a macroblock goes intra where its deviation from its
//     mean beats the best prediction, and a zero vector with no coded block
//     is not coded;
//   * rounding_type alternating over the P-VOPs of a GOP.
// Each VOP is rebuilt as the decoder rebuilds it (mpeg4_tables.h: the same
// simple IDCT, dequantisation, half-pel averaging and reference read clamped
// to whole macroblocks), so that the reconstruction it keeps (m4e_recon) is
// the decoder's output bit for bit and P-VOPs do not drift.
//
// Every entry point returns 0 on success, else -1 with a message in err.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <string>
#include <vector>

#include "mpeg4_tables.h"

namespace {

using namespace mpeg4;

struct EncodeError {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw EncodeError{msg}; }

// ---------------------------------------------------------------- bit writer

struct BitWriter {
  std::vector<uint8_t> out;
  uint64_t acc = 0;
  int n = 0;  // bits in acc not yet written, < 8 between calls

  void put(uint32_t v, int k) {
    if (k == 0) return;
    acc = (acc << k) | (v & (k == 32 ? 0xffffffffu : (1u << k) - 1));
    n += k;
    while (n >= 8) {
      n -= 8;
      out.push_back((uint8_t)(acc >> n));
    }
    acc &= (1ull << n) - 1;
  }
  // next_start_code(): a 0, then 1s to the byte boundary
  void stuffing() {
    put(0, 1);
    put(0xff, (8 - n) & 7);
  }
  void start_code(int code) {
    put(0x000001, 24);
    put((uint32_t)code, 8);
  }
};

// ---------------------------------------------------------------- tables

// A TCOEF table read backwards: the code of (last, run, level) and the
// escape limits LMAX by (last, run) and RMAX by (last, level).
struct TcoefCodes {
  const uint16_t (*codes)[2];
  int16_t index[2][64][28];
  int max_level[2][64];
  int max_run[2][28];

  void init(const uint16_t (*c)[2], const int8_t* run, const int8_t* level, int last) {
    codes = c;
    memset(index, 0xff, sizeof index);
    memset(max_level, 0, sizeof max_level);
    memset(max_run, 0, sizeof max_run);
    for (int i = 0; i < 102; i++) {
      int k = i >= last;
      index[k][run[i]][level[i]] = (int16_t)i;
      max_level[k][run[i]] = std::max(max_level[k][run[i]], (int)level[i]);
      max_run[k][level[i]] = std::max(max_run[k][level[i]], (int)run[i]);
    }
  }
  int code(int last, int run, int level) const {
    return run >= 0 && run < 64 && level > 0 && level < 28 ? index[last][run][level] : -1;
  }

  // One (last, run, level) event: its VLC and sign, else escape 1 (level
  // less LMAX), escape 2 (run less RMAX + 1), or escape 3 (fixed length).
  void put(BitWriter& b, int last, int run, int level) const {
    int mag = std::abs(level), sign = level < 0;
    int c = code(last, run, mag);
    if (c >= 0) {
      b.put(codes[c][0], codes[c][1]);
      b.put(sign, 1);
      return;
    }
    const uint16_t* esc = codes[102];
    if ((c = code(last, run, mag - max_level[last][run])) >= 0) {
      b.put(esc[0], esc[1]);
      b.put(0, 1);
      b.put(codes[c][0], codes[c][1]);
      b.put(sign, 1);
      return;
    }
    if (mag < 28 && (c = code(last, run - max_run[last][mag] - 1, mag)) >= 0) {
      b.put(esc[0], esc[1]);
      b.put(2, 2);
      b.put(codes[c][0], codes[c][1]);
      b.put(sign, 1);
      return;
    }
    b.put(esc[0], esc[1]);
    b.put(3, 2);
    b.put(last, 1);
    b.put(run, 6);
    b.put(1, 1);
    b.put((uint32_t)level & 0xfff, 12);
    b.put(1, 1);
  }
};

struct Tables {
  TcoefCodes intra, inter;
  float cosine[8][8];  // the orthonormal DCT-II basis: cosine[u][x]
  Tables() {
    intra.init(kIntraVlc, kIntraRun, kIntraLevel, kIntraLast);
    inter.init(kInterVlc, kInterRun, kInterLevel, kInterLast);
    for (int u = 0; u < 8; u++)
      for (int x = 0; x < 8; x++)
        cosine[u][x] = (float)((u ? std::sqrt(0.25) : std::sqrt(0.125)) *
                               std::cos((2 * x + 1) * u * 3.14159265358979323846 / 16));
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

// Forward DCT of an 8x8 block of samples or residuals (raster order), in
// the scale the IDCT takes: the DC is 8 times the mean.
void fdct(const int* in, float* out) {
  const Tables& T = tables();
  float tmp[64];
  for (int r = 0; r < 8; r++)
    for (int u = 0; u < 8; u++) {
      float s = 0;
      for (int x = 0; x < 8; x++) s += T.cosine[u][x] * (float)in[8 * r + x];
      tmp[8 * r + u] = s;
    }
  for (int u = 0; u < 8; u++)
    for (int v = 0; v < 8; v++) {
      float s = 0;
      for (int y = 0; y < 8; y++) s += T.cosine[v][y] * tmp[8 * y + u];
      out[8 * v + u] = s;
    }
}

inline int median3(int a, int b, int c) {
  return std::max(std::min(a, b), std::min(std::max(a, b), c));
}

// Bits of one coded motion vector difference (half-pel), at f_code 1 and
// past its range roughly.
inline int mv_bits(int d) {
  int a = std::abs(d);
  return a == 0 ? 1 : a <= 32 ? kMv[a][1] + 1 : 14 + (a >> 5);
}

// ------------------------------------------------------------------ encoder

struct Encoder {
  enum { INTER = 0, INTRA = 1, SKIPPED = 2 };
  static constexpr int kSearch = 127;  // the largest vector component, half-pel (f_code 3)
  static constexpr int kDiamondSteps = 32;

  struct Mb {
    uint8_t type = INTRA, cbp = 0;
    int16_t mvx = 0, mvy = 0;
    int16_t level[6][64];  // quantised coefficients, raster order
  };

  int width, height, mb_w, mb_h, res, inc, time_bits, gop, qp;
  int64_t frames = 0, last_second = 0;
  int rounding = 0, fcode = 1;
  bool key = false;
  std::vector<uint8_t> src[3], cur[3], ref[3];
  int stride[3], ew[3], eh[3];
  std::vector<Mb> mbs;
  std::vector<int16_t> mvs, prev_mvs;  // 2 a macroblock
  std::vector<int16_t> dcs[3];         // the dequantised DC of each intra block, else 1024
  int bw[3];
  std::vector<uint8_t> config, packet;

  Encoder(int w, int h, int r, int i, int g, int q)
      : width(w), height(h), res(r), inc(i), gop(g), qp(q) {
    if (w < 2 || h < 2 || w > 8190 || h > 8190 || (w & 1) || (h & 1))
      fail("an MPEG-4 video of " + std::to_string(w) + "x" + std::to_string(h) +
           " (the sides are even, 2 to 8190)");
    if (r < 1 || r > 65535 || i < 1) fail("a time base outside vop_time_increment_resolution");
    if (g < 1) fail("a GOP of fewer than 1 frame");
    if (q < 1 || q > 31) fail("a QP outside 1-31");
    mb_w = (w + 15) / 16;
    mb_h = (h + 15) / 16;
    time_bits = 1;
    while ((1 << time_bits) < res) time_bits++;
    for (int p = 0; p < 3; p++) {
      stride[p] = ew[p] = (p ? 8 : 16) * mb_w;
      eh[p] = (p ? 8 : 16) * mb_h;
      src[p].assign((size_t)ew[p] * eh[p], 0);
      cur[p].assign((size_t)ew[p] * eh[p], 0);
      ref[p].assign((size_t)ew[p] * eh[p], 0);
    }
    bw[0] = 2 * mb_w;
    bw[1] = bw[2] = mb_w;
    for (int p = 0; p < 3; p++) dcs[p].assign((size_t)bw[p] * (p ? mb_h : 2 * mb_h), 1024);
    mbs.resize((size_t)mb_w * mb_h);
    mvs.assign(2 * mbs.size(), 0);
    prev_mvs.assign(2 * mbs.size(), 0);
    write_config();
  }

  // ---------------------------------------------------------- headers

  void write_config() {
    BitWriter b;
    int mbs_n = mb_w * mb_h;  // Simple Profile's level by macroblocks a VOP
    int level = mbs_n <= 99 ? 1 : mbs_n <= 396 ? 3 : mbs_n <= 1200 ? 4 : mbs_n <= 1620 ? 5 : 6;
    b.start_code(0xb0);  // visual object sequence
    b.put(level, 8);
    b.start_code(0xb5);  // visual object: identified, verid 1, priority 1, video
    b.put(1, 1), b.put(1, 4), b.put(1, 3), b.put(1, 4);
    b.put(0, 1);  // video_signal_type
    b.stuffing();
    b.start_code(0x00);  // video object 0
    b.start_code(0x20);  // video object layer 0
    b.put(0, 1);         // random_accessible_vol
    b.put(1, 8);         // simple object type
    b.put(1, 1), b.put(1, 4), b.put(1, 3);  // is_object_layer_identifier, verid 1, priority 1
    b.put(1, 4);                            // square pixels
    b.put(1, 1), b.put(1, 2), b.put(1, 1), b.put(0, 1);  // control: 4:2:0, low_delay, no vbv
    b.put(0, 2);                                         // rectangular
    b.put(1, 1), b.put(res, 16), b.put(1, 1);
    b.put(0, 1);  // fixed_vop_rate
    b.put(1, 1), b.put(width, 13), b.put(1, 1), b.put(height, 13), b.put(1, 1);
    b.put(0, 1);  // interlaced
    b.put(1, 1);  // obmc_disable
    b.put(0, 1);  // sprite_enable
    b.put(0, 1);  // not_8_bit
    b.put(0, 1);  // quant_type: H.263
    b.put(1, 1);  // complexity_estimation_disable
    b.put(1, 1);  // resync_marker_disable
    b.put(0, 1);  // data_partitioned
    b.put(0, 1);  // scalability
    b.stuffing();
    config = b.out;
  }

  // ---------------------------------------------------------- input

  // uint8 RGB [height, width, 3] rows `row` bytes apart into the padded
  // planes of src: BT.601 limited range, chroma from each 2x2 block's sums.
  void load(const uint8_t* rgb, size_t row) {
    int cw = width / 2, ch = height / 2;
    for (int r = 0; r < height; r++) {
      const uint8_t* s = rgb + (size_t)r * row;
      uint8_t* y = &src[0][(size_t)r * stride[0]];
      for (int c = 0; c < width; c++)
        y[c] = (uint8_t)(((66 * s[3 * c] + 129 * s[3 * c + 1] + 25 * s[3 * c + 2] + 128) >> 8) + 16);
    }
    for (int r = 0; r < ch; r++) {
      const uint8_t* s0 = rgb + (size_t)(2 * r) * row;
      const uint8_t* s1 = s0 + row;
      uint8_t* u = &src[1][(size_t)r * stride[1]];
      uint8_t* v = &src[2][(size_t)r * stride[2]];
      for (int c = 0; c < cw; c++) {
        int k = 6 * c;
        int R = s0[k] + s0[k + 3] + s1[k] + s1[k + 3];
        int G = s0[k + 1] + s0[k + 4] + s1[k + 1] + s1[k + 4];
        int B = s0[k + 2] + s0[k + 5] + s1[k + 2] + s1[k + 5];
        u[c] = clip8(((-38 * R - 74 * G + 112 * B + 512) >> 10) + 128);
        v[c] = clip8(((112 * R - 94 * G - 18 * B + 512) >> 10) + 128);
      }
    }
    int vw[3] = {width, cw, cw}, vh[3] = {height, ch, ch};
    for (int p = 0; p < 3; p++) {  // replicate the last column and row into the padding
      uint8_t* d = src[p].data();
      for (int r = 0; r < vh[p]; r++)
        memset(d + (size_t)r * stride[p] + vw[p], d[(size_t)r * stride[p] + vw[p] - 1],
               ew[p] - vw[p]);
      for (int r = vh[p]; r < eh[p]; r++)
        memcpy(d + (size_t)r * stride[p], d + (size_t)(vh[p] - 1) * stride[p], ew[p]);
    }
  }

  // ---------------------------------------------------------- blocks

  // Block n (0-3 luma, 4 Cb, 5 Cr) of macroblock (mx, my): its plane, and
  // its top-left sample's offset there.
  void block_at(int n, int mx, int my, int& p, size_t& off) const {
    p = n < 4 ? 0 : n - 3;
    off = n < 4 ? (size_t)(16 * my + 8 * (n >> 1)) * stride[0] + 16 * mx + 8 * (n & 1)
                : (size_t)8 * my * stride[p] + 8 * mx;
  }

  // Quantise the DCT of an intra block: the DC to its dc_scaler, the AC
  // truncated to steps of 2 QP. Returns whether an AC level is not 0.
  bool quant_intra(const float* c, int16_t* lv, int scale) const {
    int qadd = (qp - 1) | 1, top = (2047 - qadd) / (2 * qp);
    lv[0] = (int16_t)std::min(std::max((int)std::floor(c[0] / scale + 0.5f), 0), 2047 / scale);
    bool any = false;
    for (int k = 1; k < 64; k++) {
      int l = std::min((int)(std::fabs(c[k]) / (2 * qp)), top);
      lv[k] = (int16_t)(c[k] < 0 ? -l : l);
      any |= l != 0;
    }
    return any;
  }

  // Quantise the DCT of a residual: steps of 2 QP with a dead zone a
  // quarter step wide. Returns whether a level is not 0.
  bool quant_inter(const float* c, int16_t* lv) const {
    int qadd = (qp - 1) | 1, top = (2047 - qadd) / (2 * qp);
    bool any = false;
    for (int k = 0; k < 64; k++) {
      float a = (std::fabs(c[k]) - 0.5f * qp) / (2 * qp);
      int l = a > 0 ? std::min((int)a, top) : 0;
      lv[k] = (int16_t)(c[k] < 0 ? -l : l);
      any |= l != 0;
    }
    return any;
  }

  // Dequantise as the decoder does and write (intra) or add (inter) the IDCT.
  void rebuild(const int16_t* lv, bool intra, int dc_scale, uint8_t* dst, int s) const {
    int16_t blk[64];
    int qmul = 2 * qp, qadd = (qp - 1) | 1;
    for (int k = 0; k < 64; k++) {
      int v = lv[k];
      blk[k] = (int16_t)(v == 0 ? 0 : v < 0 ? v * qmul - qadd : v * qmul + qadd);
    }
    if (intra) blk[0] = (int16_t)(lv[0] * dc_scale);
    idct(blk, dst, s, !intra);
  }

  void code_intra(int mx, int my, Mb& mb) {
    mb.type = INTRA;
    mb.cbp = 0;
    for (int n = 0; n < 6; n++) {
      int p;
      size_t off;
      block_at(n, mx, my, p, off);
      int s = stride[p], in[64];
      for (int r = 0; r < 8; r++)
        for (int c = 0; c < 8; c++) in[8 * r + c] = src[p][off + (size_t)r * s + c];
      float co[64];
      fdct(in, co);
      int scale = n < 4 ? luma_dc_scale(qp) : chroma_dc_scale(qp);
      if (quant_intra(co, mb.level[n], scale)) mb.cbp |= 32 >> n;
      rebuild(mb.level[n], true, scale, &cur[p][off], s);
    }
  }

  // Predict the macroblock at vector (mvx, mvy) into cur and code its
  // residual; not coded where the vector is 0 and no block has a level.
  void code_inter(int mx, int my, int mvx, int mvy, Mb& mb) {
    mb.type = INTER;
    mb.mvx = (int16_t)mvx;
    mb.mvy = (int16_t)mvy;
    mb.cbp = 0;
    predict_block(ref[0].data(), stride[0], ew[0], eh[0], 16 * mx, 16 * my, mvx, mvy, 16,
                  rounding, &cur[0][(size_t)16 * my * stride[0] + 16 * mx], stride[0]);
    for (int p = 1; p < 3; p++)
      predict_block(ref[p].data(), stride[p], ew[p], eh[p], 8 * mx, 8 * my, chroma_mv(mvx),
                    chroma_mv(mvy), 8, rounding, &cur[p][(size_t)8 * my * stride[p] + 8 * mx],
                    stride[p]);
    for (int n = 0; n < 6; n++) {
      int p;
      size_t off;
      block_at(n, mx, my, p, off);
      int s = stride[p], in[64];
      for (int r = 0; r < 8; r++)
        for (int c = 0; c < 8; c++)
          in[8 * r + c] = (int)src[p][off + (size_t)r * s + c] - cur[p][off + (size_t)r * s + c];
      float co[64];
      fdct(in, co);
      if (quant_inter(co, mb.level[n])) mb.cbp |= 32 >> n;
    }
    if (mb.cbp == 0 && mvx == 0 && mvy == 0) {
      mb.type = SKIPPED;
      return;
    }
    for (int n = 0; n < 6; n++) {
      if (!(mb.cbp & (32 >> n))) continue;
      int p;
      size_t off;
      block_at(n, mx, my, p, off);
      rebuild(mb.level[n], false, 0, &cur[p][off], stride[p]);
    }
  }

  // ---------------------------------------------------------- motion

  int mv_at(const std::vector<int16_t>& v, int mx, int my, int k) const {
    if (mx < 0 || mx >= mb_w || my < 0) return 0;
    return v[2 * ((size_t)my * mb_w + mx) + k];
  }

  // The median predictor of the decoder (the left vector on the first row).
  void predictor(int mx, int my, int& px, int& py) const {
    if (my == 0) {
      px = mv_at(mvs, mx - 1, my, 0);
      py = mv_at(mvs, mx - 1, my, 1);
      return;
    }
    px = median3(mv_at(mvs, mx - 1, my, 0), mv_at(mvs, mx, my - 1, 0), mv_at(mvs, mx + 1, my - 1, 0));
    py = median3(mv_at(mvs, mx - 1, my, 1), mv_at(mvs, mx, my - 1, 1), mv_at(mvs, mx + 1, my - 1, 1));
  }

  // SAD of the macroblock's luma against its prediction at (mvx, mvy),
  // given up once past `limit`.
  int sad(int mx, int my, int mvx, int mvy, int limit) const {
    const uint8_t* s = &src[0][(size_t)16 * my * stride[0] + 16 * mx];
    int x = 16 * mx + (mvx >> 1), y = 16 * my + (mvy >> 1), ps = stride[0];
    const uint8_t* q;
    uint8_t tmp[256];
    if (!((mvx | mvy) & 1) && x >= 0 && y >= 0 && x + 16 <= ew[0] && y + 16 <= eh[0]) {
      q = &ref[0][(size_t)y * stride[0] + x];
    } else {
      predict_block(ref[0].data(), stride[0], ew[0], eh[0], 16 * mx, 16 * my, mvx, mvy, 16,
                    rounding, tmp, 16);
      q = tmp;
      ps = 16;
    }
    int total = 0;
    for (int r = 0; r < 16 && total <= limit; r++) {
      const uint8_t* a = s + (size_t)r * stride[0];
      const uint8_t* b = q + (size_t)r * ps;
      for (int c = 0; c < 16; c++) total += std::abs(a[c] - b[c]);
    }
    return total;
  }

  // Sum of absolute deviations of the macroblock's luma from its mean.
  int deviation(int mx, int my) const {
    const uint8_t* s = &src[0][(size_t)16 * my * stride[0] + 16 * mx];
    int sum = 0;
    for (int r = 0; r < 16; r++)
      for (int c = 0; c < 16; c++) sum += s[(size_t)r * stride[0] + c];
    int mean = (sum + 128) >> 8, dev = 0;
    for (int r = 0; r < 16; r++)
      for (int c = 0; c < 16; c++) dev += std::abs(s[(size_t)r * stride[0] + c] - mean);
    return dev;
  }

  // The vector of least SAD plus QP times its bits: the candidates, a
  // diamond of whole-pel steps from the best, then its 8 half-pel
  // neighbours. Returns that cost.
  int search(int mx, int my, int px, int py, int& bx, int& by) const {
    int best = std::numeric_limits<int>::max();
    auto eval = [&](int vx, int vy) {
      if (std::abs(vx) > kSearch || std::abs(vy) > kSearch) return false;
      int bits = mv_bits(vx - px) + mv_bits(vy - py);
      int c = sad(mx, my, vx, vy, best) + qp * bits;
      if (c >= best) return false;
      best = c;
      bx = vx;
      by = vy;
      return true;
    };
    eval(px, py);
    eval(0, 0);
    eval(mv_at(prev_mvs, mx, my, 0), mv_at(prev_mvs, mx, my, 1));
    eval(mv_at(mvs, mx - 1, my, 0), mv_at(mvs, mx - 1, my, 1));
    eval(mv_at(mvs, mx, my - 1, 0), mv_at(mvs, mx, my - 1, 1));
    int cx = bx & ~1, cy = by & ~1;
    eval(cx, cy);
    for (int step = 0; step < kDiamondSteps; step++) {
      cx = bx & ~1;
      cy = by & ~1;
      bool moved = eval(cx - 2, cy) | eval(cx + 2, cy) | eval(cx, cy - 2) | eval(cx, cy + 2);
      if (!moved) break;
    }
    cx = bx;
    cy = by;
    for (int dy = -1; dy <= 1; dy++)
      for (int dx = -1; dx <= 1; dx++)
        if (dx || dy) eval(cx + dx, cy + dy);
    return best;
  }

  // ---------------------------------------------------------- bitstream

  // The coded DC difference of intra block n against the decoder's gradient
  // prediction (ff_mpeg4_pred_dc); stores its dequantised DC for its
  // neighbours.
  int dc_diff(int n, int mx, int my, int level) {
    int p = n < 4 ? 0 : n - 3;
    int bx = n < 4 ? 2 * mx + (n & 1) : mx, by = n < 4 ? 2 * my + (n >> 1) : my;
    auto at = [&](int x, int y) { return x < 0 || y < 0 ? 1024 : dcs[p][(size_t)y * bw[p] + x]; };
    int scale = n < 4 ? luma_dc_scale(qp) : chroma_dc_scale(qp);
    int a = at(bx - 1, by), b = at(bx - 1, by - 1), c = at(bx, by - 1);
    int pred = std::abs(a - b) < std::abs(b - c) ? c : a;
    pred = (pred + (scale >> 1)) / scale;
    int v = level * scale;
    if (v & ~2047) v = v < 0 ? 0 : 2047;
    dcs[p][(size_t)by * bw[p] + bx] = (int16_t)v;
    return level - pred;
  }

  // The levels of a block from zigzag position `start` on as TCOEF events.
  static void put_block(BitWriter& b, const TcoefCodes& t, const int16_t* lv, int start) {
    int end = -1;
    for (int i = 63; i >= start && end < 0; i--)
      if (lv[kZigzag[i]]) end = i;
    int run = 0;
    for (int i = start; i <= end; i++) {
      int v = lv[kZigzag[i]];
      if (!v) {
        run++;
        continue;
      }
      t.put(b, i == end, run, v);
      run = 0;
    }
  }

  void put_intra_blocks(BitWriter& b, int mx, int my, const Mb& mb) {
    const Tables& T = tables();
    for (int n = 0; n < 6; n++) {
      int diff = dc_diff(n, mx, my, mb.level[n][0]);
      int size = 0;
      while ((1 << size) <= std::abs(diff)) size++;
      const uint16_t* dc = n < 4 ? kDcLum[size] : kDcChrom[size];
      b.put(dc[0], dc[1]);
      if (size) {
        b.put((uint32_t)(diff > 0 ? diff : diff + (1 << size) - 1), size);
        if (size > 8) b.put(1, 1);
      }
      if (mb.cbp & (32 >> n)) put_block(b, T.intra, mb.level[n], 1);
    }
  }

  void put_mv(BitWriter& b, int v, int pred) {
    int bits = 5 + fcode, shift = fcode - 1;
    int d = (int)((uint32_t)(v - pred) << (32 - bits)) >> (32 - bits);
    if (d == 0) {
      b.put(kMv[0][0], kMv[0][1]);
      return;
    }
    int a = std::abs(d) - 1, code = (a >> shift) + 1;
    b.put(kMv[code][0], kMv[code][1]);
    b.put(d < 0, 1);
    b.put((uint32_t)a & ((1u << shift) - 1), shift);
  }

  void write_vop(BitWriter& b) {
    int64_t t = frames * inc, second = t / res;
    b.start_code(0xb6);
    b.put(key ? 0 : 1, 2);
    for (int64_t s = last_second; s < second; s++) b.put(1, 1);  // modulo_time_base
    last_second = second;
    b.put(0, 1);
    b.put(1, 1);
    b.put((uint32_t)(t % res), time_bits);
    b.put(1, 1);
    b.put(1, 1);  // vop_coded
    if (!key) b.put(rounding, 1);
    b.put(0, 3);  // intra_dc_vlc_thr 0: DC by its VLCs at every QP
    b.put(qp, 5);
    if (!key) b.put(fcode, 3);
    for (int p = 0; p < 3; p++) std::fill(dcs[p].begin(), dcs[p].end(), 1024);
    const Tables& T = tables();
    for (int my = 0; my < mb_h; my++)
      for (int mx = 0; mx < mb_w; mx++) {
        const Mb& mb = mbs[(size_t)my * mb_w + mx];
        int cbpc = mb.cbp & 3, cbpy = mb.cbp >> 2;
        if (key) {
          b.put(kIntraMcbpc[cbpc][0], kIntraMcbpc[cbpc][1]);
          b.put(0, 1);  // ac_pred_flag
          b.put(kCbpy[cbpy][0], kCbpy[cbpy][1]);
          put_intra_blocks(b, mx, my, mb);
          continue;
        }
        if (mb.type == SKIPPED) {
          b.put(1, 1);  // not_coded
          continue;
        }
        b.put(0, 1);
        if (mb.type == INTRA) {
          b.put(kInterMcbpc[4 + cbpc][0], kInterMcbpc[4 + cbpc][1]);
          b.put(0, 1);
          b.put(kCbpy[cbpy][0], kCbpy[cbpy][1]);
          put_intra_blocks(b, mx, my, mb);
          continue;
        }
        b.put(kInterMcbpc[cbpc][0], kInterMcbpc[cbpc][1]);
        b.put(kCbpy[cbpy ^ 15][0], kCbpy[cbpy ^ 15][1]);
        int px, py;
        predictor(mx, my, px, py);
        put_mv(b, mb.mvx, px);
        put_mv(b, mb.mvy, py);
        for (int n = 0; n < 6; n++)
          if (mb.cbp & (32 >> n)) put_block(b, T.inter, mb.level[n], 0);
      }
    b.stuffing();
  }

  // ---------------------------------------------------------- VOP

  void encode(const uint8_t* rgb, size_t row) {
    load(rgb, row);
    key = frames % gop == 0;
    rounding = key ? 0 : rounding ^ 1;
    std::fill(mvs.begin(), mvs.end(), 0);
    int lo = 0, hi = 0;
    for (int my = 0; my < mb_h; my++)
      for (int mx = 0; mx < mb_w; mx++) {
        size_t i = (size_t)my * mb_w + mx;
        Mb& mb = mbs[i];
        if (key) {
          code_intra(mx, my, mb);
          continue;
        }
        int px, py, vx = 0, vy = 0;
        predictor(mx, my, px, py);
        int inter = search(mx, my, px, py, vx, vy);
        if (deviation(mx, my) + 16 * qp < inter) {
          code_intra(mx, my, mb);
          continue;
        }
        code_inter(mx, my, vx, vy, mb);
        if (mb.type == INTER) {
          mvs[2 * i] = (int16_t)vx;
          mvs[2 * i + 1] = (int16_t)vy;
          lo = std::min(lo, std::min(vx, vy));
          hi = std::max(hi, std::max(vx, vy));
        }
      }
    fcode = 1;  // the smallest f_code whose range [-16 << f, (16 << f) - 1] holds every vector
    while (lo < -(16 << fcode) || hi > (16 << fcode) - 1) fcode++;
    BitWriter b;
    write_vop(b);
    packet.swap(b.out);
    for (int p = 0; p < 3; p++) std::swap(cur[p], ref[p]);
    prev_mvs.swap(mvs);
    frames++;
  }

  // The reconstruction of the last VOP cropped to the VOL size: RGB as the
  // decoder gives it and the planes Y [H, W], U and V [H / 2, W / 2]; any
  // may be null.
  void recon(uint8_t* rgb, uint8_t* y, uint8_t* u, uint8_t* v) const {
    if (rgb) yuv420_to_rgb(ref[0].data(), stride[0], ref[1].data(), ref[2].data(), stride[1], width,
                           height, rgb);
    uint8_t* out[3] = {y, u, v};
    for (int p = 0; p < 3; p++) {
      if (!out[p]) continue;
      int w = p ? width / 2 : width, h = p ? height / 2 : height;
      for (int r = 0; r < h; r++) memcpy(out[p] + (size_t)r * w, &ref[p][(size_t)r * stride[p]], w);
    }
  }
};

int report(const std::string& msg, char* err, size_t err_len) {
  if (err && err_len) snprintf(err, err_len, "%s", msg.c_str());
  return -1;
}

}  // namespace

extern "C" {

// A new encoder of width x height (both even) at `res` / `inc` frames a
// second (vop_time_increment_resolution `res`, `inc` ticks a frame), an
// I-VOP every `gop` frames, at quantiser `qp`; null with a message in err.
void* m4e_new(int width, int height, int res, int inc, int gop, int qp, char* err,
              size_t err_len) {
  try {
    return new Encoder(width, height, res, inc, gop, qp);
  } catch (const EncodeError& e) {
    report(e.msg, err, err_len);
  } catch (const std::bad_alloc&) {
    report("out of memory", err, err_len);
  }
  return nullptr;
}

void m4e_free(void* h) { delete static_cast<Encoder*>(h); }

// The VOS, VO and VOL headers (an MP4's decoder configuration): their size,
// copied to out when it is not null.
size_t m4e_config(void* h, uint8_t* out) {
  const Encoder* e = static_cast<Encoder*>(h);
  if (out) memcpy(out, e->config.data(), e->config.size());
  return e->config.size();
}

// Encode one uint8 RGB frame [height, width, 3] (rows `row` bytes apart) to
// one VOP: its size in *size, whether it is an I-VOP in *key; m4e_packet
// copies it.
int m4e_encode(void* h, const uint8_t* rgb, size_t row, size_t* size, int* key, char* err,
               size_t err_len) {
  Encoder* e = static_cast<Encoder*>(h);
  try {
    e->encode(rgb, row);
  } catch (const EncodeError& x) {
    return report(x.msg, err, err_len);
  } catch (const std::bad_alloc&) {
    return report("out of memory", err, err_len);
  }
  *size = e->packet.size();
  *key = e->key;
  return 0;
}

void m4e_packet(void* h, uint8_t* out) {
  const Encoder* e = static_cast<Encoder*>(h);
  memcpy(out, e->packet.data(), e->packet.size());
}

// The last VOP as the decoder rebuilds it: uint8 RGB [H, W, 3] and the
// planes Y [H, W], U and V [H / 2, W / 2] (any may be null); -1 before the
// first frame.
int m4e_recon(void* h, uint8_t* rgb, uint8_t* y, uint8_t* u, uint8_t* v) {
  const Encoder* e = static_cast<Encoder*>(h);
  if (e->frames == 0) return -1;
  e->recon(rgb, y, u, v);
  return 0;
}

}  // extern "C"
