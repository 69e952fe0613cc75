// Host HEVC (ITU-T H.265 | ISO/IEC 23008-2) video decoder of the port, in
// plain C++ with a C interface (loaded with ctypes, which releases the
// interpreter lock around each call). It decodes the Main profile, 8-bit
// 4:2:0 progressive single-layer streams that phones, cameras and libx265
// write, as FFmpeg's hevc decoder decodes them (the standard's decoding is
// exact, so its output is too):
//   * NAL units length-prefixed (an MP4's hvcC: 1, 2 or 4 bytes) or in
//     Annex B, emulation-prevention bytes removed; the VPS (checked), SPS
//     (profile_tier_level, the conformance window, the short-term RPS sets
//     with inter-RPS prediction, scaling lists, the VUI's colour fields and
//     HRD), PPS, SEI user data (the encoder's name);
//   * slice segment headers: the POC (prevTid0Pic), the RPS of the SPS or
//     coded in the slice, num_ref_idx, list modification, the collocated
//     picture, the pred weight table, the QP deltas and offsets, the
//     deblocking override, the entry points; several slices a picture;
//   * CABAC (the engine of h264_cabac.h, the contexts of hevc_tables.h by
//     initType) with wavefronts (entropy_coding_sync: the contexts stored
//     after a row's second CTU and restored at the next row's start);
//   * the coding quadtree: SAO syntax, CU split, cu_transquant_bypass, skip,
//     part_mode with AMP, the transform tree, cu_qp_delta by quantization
//     group with its predictor, residual coding (sign data hiding, the Rice
//     parameter), transform skip, the flat scale and scaling lists;
//   * the 4x4 DST and the DCT at 4 to 32 points; intra prediction (the 35
//     modes, reference substitution, the [1 2 1] and strong filters, the
//     edge filters of DC and modes 10 and 26, constrained intra); inter
//     prediction: merge (spatial, temporal with its scaling, combined
//     bi-predictive and zero candidates under the parallel merge level),
//     AMVP, 8-tap luma and 4-tap chroma interpolation at 14 bits, default
//     and explicit weighted prediction, the 8x4/4x8 bi restriction;
//   * deblocking (bS from TU and PU edges, luma strong and weak, chroma at
//     bS 2, the PPS chroma offsets, the slice's beta and tc offsets, edges
//     across slices) over the whole picture, then SAO (band and edge,
//     merge left and up, picture and slice boundaries, none on
//     transquant-bypass samples);
//   * the RPS marking, IDR, CRA and RASL pictures (those after a first CRA
//     skipped, as FFmpeg does), RADL pictures, pic_output_flag; output in
//     POC order as FFmpeg 8 gives it (a picture waits while no more than
//     sps_max_num_reorder_pics wait and the buffer holds no more than
//     sps_max_dec_pic_buffering; every waiting picture goes at an IRAP
//     picture with NoRaslOutputFlag and at hevc_flush), cropped by the
//     conformance window; RGB as OpenCV converts it: swscale's yuv420p to
//     bgr24 (yuv_rgb.h) with the table of the VUI's matrix, in limited or
//     full range as video_full_range_flag says.
// Refused with a message (-2) that names the tool: a nuh_layer_id above 0,
// profiles beyond Main (a bit depth above 8, chroma other than 4:2:0, the
// range extensions), field coding (field_seq_flag), PCM, tiles, long-term
// reference pictures, dependent slice segments, a size change within the
// stream, a VUI matrix OpenCV does not convert by, several pictures in one
// packet. A truncated or corrupt stream fails (-1): every bit read, every
// index and every range is checked, and a picture whose slices do not
// cover it is not output.
//
// Every entry point returns 0 on success (hevc_decode and hevc_flush: the
// number of frames made ready), else -1 (a broken stream) or -2 (a valid
// one that is not supported) with a message in err.

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
#include "hevc_tables.h"
#include "yuv_rgb.h"

namespace {

using namespace hevc;

static_assert(kCtxInit[0][N_CTX - 1] == 152 && kCtxInit[1][N_CTX - 1] == 167 &&
                  kCtxInit[2][N_CTX - 1] == 167, "context table length");
static_assert(kCtxInit[0][C_LAST_X] == 110 && kCtxInit[1][C_LAST_X] == 125 &&
                  kCtxInit[2][C_LAST_X] == 125 && kCtxInit[0][C_SIG] == 111 &&
                  kCtxInit[1][C_SIG] == 155 && kCtxInit[2][C_SIG] == 170 &&
                  kCtxInit[0][C_G1] == 140 && kCtxInit[1][C_G1] == 154 &&
                  kCtxInit[0][C_G2] == 138 && kCtxInit[2][C_CSBF] == 121,
              "context table layout");

struct CodecError {
  std::string msg;
  bool unsupported;
};

[[noreturn]] void fail(const std::string& msg) { throw CodecError{msg, false}; }
[[noreturn]] void unsupported(const std::string& msg) {
  throw CodecError{msg + " is not supported by the port's HEVC decoder (ROADMAP A22d)", true};
}

inline int clip3(int lo, int hi, int v) { return v < lo ? lo : v > hi ? hi : v; }
inline uint8_t clip1(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }
inline int ceil_log2(int v) {
  int n = 0;
  while ((1 << n) < v) n++;
  return n;
}

// ---------------------------------------------------------------- bit reader

struct Bits {
  const uint8_t* data;
  size_t size;
  size_t bits;
  size_t pos = 0;

  Bits(const uint8_t* d, size_t n) : data(d), size(n), bits(n * 8) {}

  uint64_t peek64() const {
    size_t byte = pos >> 3;
    uint64_t v = 0;
    for (int i = 0; i < 8; i++) v = (v << 8) | (byte + i < size ? data[byte + i] : 0);
    return v << (pos & 7);
  }
  uint32_t peek(int k) const { return k ? (uint32_t)(peek64() >> (64 - k)) : 0; }
  void skip(size_t k) {
    if (pos + k > bits) fail("truncated HEVC slice header or parameter set");
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
    return (uint32_t)(((uint64_t)get(zeros + 1)) - 1);
  }
  int se() {
    uint32_t k = ue();
    return (k & 1) ? (int)((k >> 1) + 1) : -(int)(k >> 1);
  }
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
};

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
  if (last == 0) fail("an HEVC NAL unit without its stop bit");
  b.bits = (last - 1) * 8 + (7 - __builtin_ctz(r[last - 1]));
  return b;
}

// ------------------------------------------------------------------ tables

struct Tables {
  uint8_t diag[4][64][2];  // up-right diagonal scans of 1x1, 2x2, 4x4, 8x8
  uint8_t horiz[4][64][2];
  uint8_t vert[4][64][2];
  uint8_t inv4[16], inv8[64];  // the diagonal scan position of (x, y) in 4x4 and 8x8
  int16_t dct[32][32];     // transMatrix of the 32-point DCT
  Tables() {
    for (int l = 0; l < 4; l++) {
      int size = 1 << l, i = 0, x = 0, y = 0;
      while (i < size * size) {
        while (y >= 0) {
          if (x < size && y < size) {
            diag[l][i][0] = (uint8_t)x;
            diag[l][i][1] = (uint8_t)y;
            i++;
          }
          y--;
          x++;
        }
        y = x;
        x = 0;
      }
      for (int k = 0; k < size * size; k++) {
        horiz[l][k][0] = (uint8_t)(k % size);
        horiz[l][k][1] = (uint8_t)(k / size);
        vert[l][k][0] = (uint8_t)(k / size);
        vert[l][k][1] = (uint8_t)(k % size);
      }
    }
    for (int i = 0; i < 16; i++) inv4[diag[2][i][1] * 4 + diag[2][i][0]] = (uint8_t)i;
    for (int i = 0; i < 64; i++) inv8[diag[3][i][1] * 8 + diag[3][i][0]] = (uint8_t)i;
    for (int k = 0; k < 32; k++)
      for (int n = 0; n < 32; n++) {
        if (k == 0) {
          dct[k][n] = 64;
          continue;
        }
        int j = ((2 * n + 1) * k) % 128, sign = 1;
        if (j > 64) j = 128 - j;
        if (j > 32) {
          j = 64 - j;
          sign = -1;
        }
        dct[k][n] = (int16_t)(sign * kDctCos[j]);
      }
  }
  using Scan = const uint8_t (*)[2];
  Scan scan(int scan_idx, int log2) const {
    return scan_idx == 0 ? diag[log2] : scan_idx == 1 ? horiz[log2] : vert[log2];
  }
};
const Tables kTables;

// ---------------------------------------------------------- parameter sets

struct StRps {
  int num_neg = 0, num_pos = 0;
  int delta[32];  // the negative ones first (closest first), then the positive
  bool used[32];
  int num() const { return num_neg + num_pos; }
};

// ScalingFactor m[x][y] of each size (4, 8, 16, 32) and matrixId (0..5),
// stored [sizeId][matrixId][y * n + x]
struct ScalingLists {
  uint8_t list[4][6][64];  // ScalingList in diagonal order (16 for sizeId 0)
  uint8_t dc[4][6];        // the DC of 16x16 and 32x32
  void set_default() {
    for (int m = 0; m < 6; m++) {
      for (int i = 0; i < 16; i++) list[0][m][i] = 16;
      for (int s = 1; s < 4; s++) {
        memcpy(list[s][m], m < 3 ? kDefaultIntra8x8 : kDefaultInter8x8, 64);
        dc[s][m] = 16;
      }
    }
  }
  void parse(Bits& b) {
    for (int s = 0; s < 4; s++)
      for (int m = 0; m < 6; m += (s == 3) ? 3 : 1) {
        int coef = std::min(64, 1 << (4 + (s << 1)));
        if (!b.get1()) {  // scaling_list_pred_mode_flag
          int delta = b.ue_max(s == 3 ? m / 3 : m, "scaling_list_pred_matrix_id_delta");
          if (delta == 0) {
            if (s == 0) for (int i = 0; i < 16; i++) list[0][m][i] = 16;
            else memcpy(list[s][m], m < 3 ? kDefaultIntra8x8 : kDefaultInter8x8, 64);
            dc[s][m] = 16;
          } else {
            int ref = m - delta * (s == 3 ? 3 : 1);
            memcpy(list[s][m], list[s][ref], coef);
            dc[s][m] = dc[s][ref];
          }
        } else {
          int next = 8;
          if (s > 1) {
            next = b.se_range(-7, 247, "scaling_list_dc_coef_minus8") + 8;
            dc[s][m] = (uint8_t)next;
          }
          for (int i = 0; i < coef; i++) {
            int delta = b.se_range(-128, 127, "scaling_list_delta_coef");
            next = (next + delta + 256) % 256;
            if (next == 0) fail("a scaling list entry of 0");
            list[s][m][i] = (uint8_t)next;
          }
          if (s <= 1) dc[s][m] = list[s][m][0];
        }
      }
    // 32x32 chroma (4:4:4 only) is never used under 4:2:0
    for (int m : {1, 2, 4, 5}) {
      memcpy(list[3][m], list[2][m], 64);
      dc[3][m] = dc[2][m];
    }
  }
  // m[x][y] of an n = 4 << s block, matrixId m, at (x, y) (7.4.5)
  int factor(int s, int m, int x, int y) const {
    if (s == 0) return list[0][m][kTables.inv4[y * 4 + x]];
    if (s >= 2 && x == 0 && y == 0) return dc[s][m];
    int sh = s - 1;
    return list[s][m][kTables.inv8[(y >> sh) * 8 + (x >> sh)]];
  }
};

struct Sps {
  bool valid = false;
  int chroma_format = 1, width = 0, height = 0;
  int crop_left = 0, crop_right = 0, crop_top = 0, crop_bottom = 0;
  int log2_max_poc_lsb = 4;
  int max_dec_pic_buffering = 1, num_reorder = 0;
  int log2_min_cb = 3, log2_ctb = 4, log2_min_tb = 2, log2_max_tb = 4;
  int max_th_depth_inter = 0, max_th_depth_intra = 0;
  bool scaling_list_enabled = false;
  ScalingLists scaling;
  bool amp = false, sao = false;
  std::vector<StRps> rps;
  bool long_term_present = false;
  int num_lt_sps = 0;
  bool temporal_mvp = false, strong_intra_smoothing = false;
  bool colour_description = false, full_range = false;
  int matrix = 2;
};

struct Pps {
  bool valid = false;
  int sps_id = 0;
  bool dependent_slices = false, output_flag_present = false;
  int num_extra_bits = 0;
  bool sign_hiding = false, cabac_init_present = false;
  int num_ref_idx_default[2] = {1, 1};
  int init_qp = 26;
  bool constrained_intra = false, transform_skip = false;
  bool cu_qp_delta = false;
  int diff_cu_qp_delta_depth = 0;
  int cb_qp_offset = 0, cr_qp_offset = 0;
  bool slice_chroma_qp_offsets = false;
  bool weighted_pred = false, weighted_bipred = false;
  bool transquant_bypass = false;
  bool entropy_sync = false;
  bool loop_filter_across_slices = false;
  bool deblocking_override_enabled = false, deblocking_disabled = false;
  int beta_offset = 0, tc_offset = 0;  // the _div2 values times 2
  bool scaling_present = false;
  ScalingLists scaling;
  bool lists_modification = false;
  int log2_par_mrg_level = 2;
  bool slice_header_extension = false;
};

// NAL unit types (Table 7-1)
enum {
  TRAIL_N = 0, TRAIL_R = 1, TSA_N = 2, STSA_R = 5, RADL_N = 6, RADL_R = 7, RASL_N = 8,
  RASL_R = 9, BLA_W_LP = 16, BLA_N_LP = 18, IDR_W_RADL = 19, IDR_N_LP = 20, CRA_NUT = 21,
  VPS_NUT = 32, SPS_NUT = 33, PPS_NUT = 34, AUD_NUT = 35, EOS_NUT = 36, EOB_NUT = 37,
  FD_NUT = 38, SEI_PREFIX = 39, SEI_SUFFIX = 40
};

enum SliceType { B_SLICE = 0, P_SLICE = 1, I_SLICE = 2 };

struct SliceHeader {
  bool first_in_pic = false, no_output_of_prior_pics = false;
  int pps_id = 0, address = 0;
  int type = I_SLICE;
  bool pic_output = true;
  int poc_lsb = 0;
  StRps rps;
  bool temporal_mvp = false;
  bool sao_luma = false, sao_chroma = false;
  int num_ref_idx[2] = {0, 0};
  bool mod_flag[2] = {false, false};
  int list_entry[2][16];
  bool mvd_l1_zero = false, cabac_init = false;
  bool collocated_from_l0 = true;
  int collocated_ref_idx = 0;
  // explicit weights: [list][ref][component] weight and offset; denominators
  int luma_denom = 0, chroma_denom = 0;
  int weight[2][16][3], offset[2][16][3];
  bool weighted = false;
  int max_merge = 5;
  int qp = 26, cb_qp_offset = 0, cr_qp_offset = 0;
  bool deblocking_disabled = false;
  int beta_offset = 0, tc_offset = 0;
  bool lf_across_slices = false;
  int num_entry_points = 0;
};

// ------------------------------------------------------------ pictures

struct Mv {
  int16_t x = 0, y = 0;
  bool operator==(const Mv& o) const { return x == o.x && y == o.y; }
  bool operator!=(const Mv& o) const { return !(*this == o); }
};

// The motion of a 4x4 block: pred bit 0 for list 0, bit 1 for list 1 (0:
// intra); poc the POC of the picture each used list refers to.
struct MvField {
  Mv mv[2];
  int8_t ref[2] = {-1, -1};
  uint8_t pred = 0;
  int32_t poc[2] = {0, 0};
};

inline bool same_motion(const MvField& a, const MvField& b) {
  if (a.pred != b.pred) return false;
  for (int l = 0; l < 2; l++)
    if ((a.pred >> l & 1) && (a.ref[l] != b.ref[l] || a.mv[l] != b.mv[l])) return false;
  return true;
}

struct Picture {
  std::vector<uint8_t> plane[3];
  std::vector<MvField> motion;  // 4x4 blocks, for TMVP
  int poc = 0;
  bool output = false;     // waiting for output
  bool reference = false;  // marked as a (short-term) reference
  int64_t packet = 0;
};

struct SaoParams {
  int type[3] = {0, 0, 0};  // 0 none, 1 band, 2 edge
  int offset[3][5] = {};    // SaoOffsetVal 0..4
  int band[3] = {0, 0, 0};
  int eo_class[3] = {0, 0, 0};
};

// ------------------------------------------------------------ the decoder

struct Decoder {
  Sps sps_list[16];
  Pps pps_list[64];
  bool vps_seen[16] = {};
  Sps active;
  const Pps* pps = nullptr;
  int nal_length = 0;
  std::string encoder;
  bool started = false;
  const yuv::Coeffs* coeffs = &yuv::kBt601;

  // the stream's state
  int prev_tid0_poc = 0;
  int max_ra = 0x7fffffff;  // FFmpeg's RASL rule: POC of the first CRA
  bool first_picture = true;
  bool after_eos = false;
  std::vector<std::shared_ptr<Picture>> dpb;  // referenced or waiting pictures
  std::deque<std::shared_ptr<Picture>> ready;
  std::shared_ptr<Picture> out;
  int64_t packets = 0;

  // the picture being decoded
  std::shared_ptr<Picture> cur;
  int cur_nal_type = 0;
  bool cur_irap = false;
  bool cur_skipped = false;  // a RASL picture not decoded
  int width = 0, height = 0, cw = 0, ch = 0;
  int ctb_w = 0, ctb_h = 0, log2_ctb = 0, ctb_size = 0;
  int w4 = 0, h4 = 0;
  std::vector<int> ctb_slice;      // SliceAddrRs of the slice of each CTB, -1 before it
  std::vector<int> ctb_header;     // index into slices
  std::vector<SliceHeader> slices;
  std::vector<SaoParams> sao;
  std::vector<uint8_t> pred_mode;  // 4x4: 0 not yet, 1 intra, 2 inter
  std::vector<uint8_t> skip_map, depth_map, ipm, bypass_map, cbf_map;
  std::vector<int8_t> qp_map;
  std::vector<uint8_t> bs_v, bs_h;
  std::vector<uint16_t> zorder;    // z-order of a 4x4 block within its CTB
  int ctbs_decoded = 0;
  std::vector<uint8_t> scratch[3];

  // the slice being decoded
  SliceHeader sh;
  std::vector<std::shared_ptr<Picture>> rpl[2];
  int rpl_poc[2][16];
  std::shared_ptr<Picture> col_pic;
  bool no_backward_pred = false;
  h264::Cabac cabac;
  uint8_t wpp_state[N_CTX];
  int slice_addr = 0;
  int ctb_addr = 0, ctb_x0 = 0, ctb_y0 = 0;
  // quantization
  int qp_y = 26, qp_y_pred = 26, last_qp_y = 26;
  bool first_qg = true, qp_delta_coded = false;
  int qp_delta = 0;
  // the coding unit
  bool cu_bypass = false;
  bool cu_intra = false;
  int cu_part = 0;
  int cu_ipm_c = 0;
  int cu_x = 0, cu_y = 0, cu_log2 = 3;

  enum Stat {
    IDR, CRA, RADL, RASL, RASL_SKIPPED, P_PICTURES, B_PICTURES, SLICES, MULTI_SLICE, WPP,
    CTUS, INTRA_CUS, INTRA_NXN, SKIP_CUS, MERGE_PUS, AMVP_PUS, AMP_PUS, BI_PUS, TMVP_CANDS,
    COMBINED_CANDS, ZERO_CANDS, BYPASS_CUS, TS_BLOCKS, SIGN_HIDDEN, QP_DELTA_CUS, LONG_LEVELS,
    PLANAR, DC, ANGULAR, STRONG_SMOOTHING, CONSTRAINED_INTRA, SAO_BAND, SAO_EDGE, SAO_MERGE,
    BS2_EDGES, BS1_EDGES, DEBLOCK_OFF_SLICES, DEBLOCK_OFFSET_SLICES, CHROMA_QP_OFFSETS,
    EXPLICIT_WEIGHTED, SCALING_LIST_PICTURES, LIST_MODIFICATIONS, TU_SPLITS, DST_BLOCKS,
    DCT32_BLOCKS, CROPPED, NOT_OUTPUT, REORDERED, N_STATS
  };
  int64_t stats[N_STATS] = {};
  int last_output_poc = 0;
  bool have_output = false;

  // ------------------------------------------------ parameter sets

  void profile_tier_level(Bits& b, int max_sub_layers_minus1) {
    b.get(2);
    b.get1();
    int profile = (int)b.get(5);
    uint32_t compat = b.get(32);
    b.get(4);     // progressive, interlaced, non-packed, frame-only
    b.skip(43);
    b.skip(1);
    b.get(8);     // general_level_idc
    (void)profile;
    (void)compat;
    int sub_profile[8] = {}, sub_level[8] = {};
    for (int i = 0; i < max_sub_layers_minus1; i++) {
      sub_profile[i] = b.get1();
      sub_level[i] = b.get1();
    }
    if (max_sub_layers_minus1 > 0)
      for (int i = max_sub_layers_minus1; i < 8; i++) b.get(2);
    for (int i = 0; i < max_sub_layers_minus1; i++) {
      if (sub_profile[i]) b.skip(88);
      if (sub_level[i]) b.skip(8);
    }
  }

  void parse_vps(const std::vector<uint8_t>& r) {
    Bits b = rbsp_reader(r);
    int id = (int)b.get(4);
    b.get(2);  // base layer internal and available
    int max_layers = (int)b.get(6) + 1;
    int sub_layers = (int)b.get(3) + 1;
    if (sub_layers > 7) fail("vps_max_sub_layers_minus1 out of range");
    b.get1();
    if (b.get(16) != 0xffff) fail("a VPS without its reserved 0xffff bits");
    profile_tier_level(b, sub_layers - 1);
    if (max_layers > 1) unsupported("a VPS of " + std::to_string(max_layers) + " layers (several layers)");
    vps_seen[id] = true;
  }

  void st_ref_pic_set(Bits& b, int idx, int num_sets, const std::vector<StRps>& sets, StRps& out) {
    bool inter = idx != 0 && b.get1();
    if (inter) {
      int delta_idx = 1;
      if (idx == num_sets) delta_idx = b.ue_max(idx - 1, "delta_idx_minus1") + 1;
      int ref_idx = idx - delta_idx;
      if (ref_idx < 0 || ref_idx >= (int)sets.size()) fail("an inter RPS of a missing set");
      const StRps& ref = sets[ref_idx];
      int sign = b.get1();
      int abs_delta = b.ue_max(32767, "abs_delta_rps_minus1") + 1;
      int delta_rps = (1 - 2 * sign) * abs_delta;
      bool used[33], use_delta[33];
      for (int j = 0; j <= ref.num(); j++) {
        used[j] = b.get1();
        use_delta[j] = used[j] ? true : b.get1();
      }
      // ref.delta: S0 at 0..num_neg-1, S1 at num_neg..num-1
      int i = 0;
      int s0[33], s1[33];
      bool u0[33], u1[33];
      for (int j = ref.num_pos - 1; j >= 0; j--) {
        int d = ref.delta[ref.num_neg + j] + delta_rps;
        if (d < 0 && use_delta[ref.num_neg + j]) { s0[i] = d; u0[i++] = used[ref.num_neg + j]; }
      }
      if (delta_rps < 0 && use_delta[ref.num()]) { s0[i] = delta_rps; u0[i++] = used[ref.num()]; }
      for (int j = 0; j < ref.num_neg; j++) {
        int d = ref.delta[j] + delta_rps;
        if (d < 0 && use_delta[j]) { s0[i] = d; u0[i++] = used[j]; }
      }
      int n0 = i;
      i = 0;
      for (int j = ref.num_neg - 1; j >= 0; j--) {
        int d = ref.delta[j] + delta_rps;
        if (d > 0 && use_delta[j]) { s1[i] = d; u1[i++] = used[j]; }
      }
      if (delta_rps > 0 && use_delta[ref.num()]) { s1[i] = delta_rps; u1[i++] = used[ref.num()]; }
      for (int j = 0; j < ref.num_pos; j++) {
        int d = ref.delta[ref.num_neg + j] + delta_rps;
        if (d > 0 && use_delta[ref.num_neg + j]) { s1[i] = d; u1[i++] = used[ref.num_neg + j]; }
      }
      if (n0 + i > 16) fail("a short-term RPS of more than 16 pictures");
      out.num_neg = n0;
      out.num_pos = i;
      for (int k = 0; k < n0; k++) { out.delta[k] = s0[k]; out.used[k] = u0[k]; }
      for (int k = 0; k < i; k++) { out.delta[n0 + k] = s1[k]; out.used[n0 + k] = u1[k]; }
    } else {
      out.num_neg = b.ue_max(16, "num_negative_pics");
      out.num_pos = b.ue_max(16 - out.num_neg, "num_positive_pics");
      int poc = 0;
      for (int i = 0; i < out.num_neg; i++) {
        poc -= b.ue_max(32767, "delta_poc_s0_minus1") + 1;
        out.delta[i] = poc;
        out.used[i] = b.get1();
      }
      poc = 0;
      for (int i = 0; i < out.num_pos; i++) {
        poc += b.ue_max(32767, "delta_poc_s1_minus1") + 1;
        out.delta[out.num_neg + i] = poc;
        out.used[out.num_neg + i] = b.get1();
      }
    }
  }

  void hrd_parameters(Bits& b, bool common, int max_sub_layers_minus1) {
    bool nal = false, vcl = false, sub_pic = false;
    if (common) {
      nal = b.get1();
      vcl = b.get1();
      if (nal || vcl) {
        sub_pic = b.get1();
        if (sub_pic) b.skip(8 + 5 + 1 + 5);
        b.skip(4 + 4);
        if (sub_pic) b.skip(4);
        b.skip(5 + 5 + 5);
      }
    }
    for (int i = 0; i <= max_sub_layers_minus1; i++) {
      bool fixed_general = b.get1();
      bool fixed_within = fixed_general ? true : b.get1();
      bool low_delay = false;
      if (fixed_within) b.ue();
      else low_delay = b.get1();
      int cpb = 1;
      if (!low_delay) cpb = b.ue_max(31, "cpb_cnt_minus1") + 1;
      for (int k = 0; k < (int)nal + (int)vcl; k++)
        for (int j = 0; j < cpb; j++) {
          b.ue();
          b.ue();
          if (sub_pic) {
            b.ue();
            b.ue();
          }
          b.get1();
        }
    }
  }

  void parse_sps(const std::vector<uint8_t>& r) {
    Bits b = rbsp_reader(r);
    Sps s;
    b.get(4);  // sps_video_parameter_set_id
    int sub_minus1 = (int)b.get(3);
    if (sub_minus1 > 6) fail("sps_max_sub_layers_minus1 out of range");
    b.get1();
    profile_tier_level(b, sub_minus1);
    int id = b.ue_max(15, "sps_seq_parameter_set_id");
    s.chroma_format = b.ue_max(3, "chroma_format_idc");
    if (s.chroma_format == 3 && b.get1()) unsupported("separate colour planes");
    if (s.chroma_format != 1)
      unsupported("chroma format " + std::to_string(s.chroma_format) + " (" +
                  (s.chroma_format == 0 ? "4:0:0" : s.chroma_format == 2 ? "4:2:2" : "4:4:4") +
                  "; the Main profile is 4:2:0)");
    s.width = b.ue_max(16888, "pic_width_in_luma_samples");
    s.height = b.ue_max(16888, "pic_height_in_luma_samples");
    if (b.get1()) {
      s.crop_left = 2 * b.ue_max(8444, "conf_win_left_offset");
      s.crop_right = 2 * b.ue_max(8444, "conf_win_right_offset");
      s.crop_top = 2 * b.ue_max(8444, "conf_win_top_offset");
      s.crop_bottom = 2 * b.ue_max(8444, "conf_win_bottom_offset");
    }
    int depth_y = b.ue_max(8, "bit_depth_luma_minus8") + 8;
    int depth_c = b.ue_max(8, "bit_depth_chroma_minus8") + 8;
    if (depth_y != 8 || depth_c != 8)
      unsupported("bit depth " + std::to_string(std::max(depth_y, depth_c)) +
                  " (Main 10 and beyond; the Main profile is 8-bit)");
    s.log2_max_poc_lsb = b.ue_max(12, "log2_max_pic_order_cnt_lsb_minus4") + 4;
    bool ordering = b.get1();
    for (int i = ordering ? 0 : sub_minus1; i <= sub_minus1; i++) {
      s.max_dec_pic_buffering = b.ue_max(15, "sps_max_dec_pic_buffering_minus1") + 1;
      s.num_reorder = b.ue_max(s.max_dec_pic_buffering - 1, "sps_max_num_reorder_pics");
      b.ue();  // sps_max_latency_increase_plus1
    }
    s.log2_min_cb = b.ue_max(3, "log2_min_luma_coding_block_size_minus3") + 3;
    s.log2_ctb = s.log2_min_cb + b.ue_max(3, "log2_diff_max_min_luma_coding_block_size");
    s.log2_min_tb = b.ue_max(3, "log2_min_luma_transform_block_size_minus2") + 2;
    s.log2_max_tb = s.log2_min_tb + b.ue_max(3, "log2_diff_max_min_luma_transform_block_size");
    if (s.log2_ctb < 4 || s.log2_ctb > 6 || s.log2_min_tb >= s.log2_min_cb ||
        s.log2_max_tb > std::min(s.log2_ctb, 5))
      fail("CTB or transform block sizes out of range");
    if (s.width == 0 || s.height == 0 || s.width % (1 << s.log2_min_cb) ||
        s.height % (1 << s.log2_min_cb))
      fail("a picture size that is not a multiple of the minimum coding block");
    if (s.crop_left + s.crop_right >= s.width || s.crop_top + s.crop_bottom >= s.height)
      fail("a conformance window larger than the picture");
    s.max_th_depth_inter = b.ue_max(s.log2_ctb - s.log2_min_tb, "max_transform_hierarchy_depth_inter");
    s.max_th_depth_intra = b.ue_max(s.log2_ctb - s.log2_min_tb, "max_transform_hierarchy_depth_intra");
    s.scaling_list_enabled = b.get1();
    s.scaling.set_default();
    if (s.scaling_list_enabled && b.get1()) s.scaling.parse(b);
    s.amp = b.get1();
    s.sao = b.get1();
    if (b.get1()) unsupported("PCM (pcm_enabled_flag)");
    int num_sets = b.ue_max(64, "num_short_term_ref_pic_sets");
    s.rps.resize(num_sets);
    for (int i = 0; i < num_sets; i++) st_ref_pic_set(b, i, num_sets, s.rps, s.rps[i]);
    s.long_term_present = b.get1();
    if (s.long_term_present) {
      s.num_lt_sps = b.ue_max(32, "num_long_term_ref_pics_sps");
      if (s.num_lt_sps) unsupported("long-term reference pictures");
    }
    s.temporal_mvp = b.get1();
    s.strong_intra_smoothing = b.get1();
    if (b.get1()) {  // vui_parameters_present_flag
      if (b.get1() && b.get(8) == 255) b.skip(32);  // aspect ratio
      if (b.get1()) b.get1();                        // overscan
      if (b.get1()) {                                // video_signal_type_present_flag
        b.get(3);
        s.full_range = b.get1();
        if (b.get1()) {
          s.colour_description = true;
          b.get(8);
          b.get(8);
          s.matrix = (int)b.get(8);
        }
      }
      if (b.get1()) {  // chroma_loc_info_present_flag
        b.ue();
        b.ue();
      }
      b.get1();  // neutral_chroma_indication_flag
      if (b.get1()) unsupported("field coding (field_seq_flag)");
      b.get1();  // frame_field_info_present_flag
      if (b.get1()) {
        b.ue();
        b.ue();
        b.ue();
        b.ue();
      }
      if (b.get1()) {  // vui_timing_info_present_flag
        b.skip(64);
        if (b.get1()) b.ue();
        if (b.get1()) hrd_parameters(b, true, sub_minus1);
      }
      if (b.get1()) {  // bitstream_restriction_flag
        b.get(3);
        for (int i = 0; i < 5; i++) b.ue();
      }
    }
    if (b.get1()) {  // sps_extension_present_flag
      if (b.get1()) unsupported("the range extensions (sps_range_extension_flag)");
      if (b.get1()) unsupported("several layers (sps_multilayer_extension_flag)");
      if (b.get1()) unsupported("3D HEVC (sps_3d_extension_flag)");
      if (b.get1()) unsupported("screen content coding (sps_scc_extension_flag)");
    }
    s.valid = true;
    sps_list[id] = s;
  }

  void parse_pps(const std::vector<uint8_t>& r) {
    Bits b = rbsp_reader(r);
    Pps p;
    int id = b.ue_max(63, "pps_pic_parameter_set_id");
    p.sps_id = b.ue_max(15, "pps_seq_parameter_set_id");
    p.dependent_slices = b.get1();
    p.output_flag_present = b.get1();
    p.num_extra_bits = (int)b.get(3);
    p.sign_hiding = b.get1();
    p.cabac_init_present = b.get1();
    p.num_ref_idx_default[0] = b.ue_max(14, "num_ref_idx_l0_default_active_minus1") + 1;
    p.num_ref_idx_default[1] = b.ue_max(14, "num_ref_idx_l1_default_active_minus1") + 1;
    p.init_qp = 26 + b.se_range(-26, 25, "init_qp_minus26");
    p.constrained_intra = b.get1();
    p.transform_skip = b.get1();
    p.cu_qp_delta = b.get1();
    if (p.cu_qp_delta) p.diff_cu_qp_delta_depth = b.ue_max(3, "diff_cu_qp_delta_depth");
    p.cb_qp_offset = b.se_range(-12, 12, "pps_cb_qp_offset");
    p.cr_qp_offset = b.se_range(-12, 12, "pps_cr_qp_offset");
    p.slice_chroma_qp_offsets = b.get1();
    p.weighted_pred = b.get1();
    p.weighted_bipred = b.get1();
    p.transquant_bypass = b.get1();
    if (b.get1()) unsupported("tiles (tiles_enabled_flag)");
    p.entropy_sync = b.get1();
    p.loop_filter_across_slices = b.get1();
    if (b.get1()) {  // deblocking_filter_control_present_flag
      p.deblocking_override_enabled = b.get1();
      p.deblocking_disabled = b.get1();
      if (!p.deblocking_disabled) {
        p.beta_offset = 2 * b.se_range(-6, 6, "pps_beta_offset_div2");
        p.tc_offset = 2 * b.se_range(-6, 6, "pps_tc_offset_div2");
      }
    }
    p.scaling_present = b.get1();
    if (p.scaling_present) {
      p.scaling.set_default();
      p.scaling.parse(b);
    }
    p.lists_modification = b.get1();
    p.log2_par_mrg_level = b.ue_max(4, "log2_parallel_merge_level_minus2") + 2;
    p.slice_header_extension = b.get1();
    if (b.get1()) {  // pps_extension_present_flag
      if (b.get1()) unsupported("the range extensions (pps_range_extension_flag)");
      if (b.get1()) unsupported("several layers (pps_multilayer_extension_flag)");
      if (b.get1()) unsupported("3D HEVC (pps_3d_extension_flag)");
      if (b.get1()) unsupported("screen content coding (pps_scc_extension_flag)");
    }
    p.valid = true;
    pps_list[id] = p;
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
        size_t cut = s.find(" - H.265");
        if (cut != std::string::npos) s = s.substr(0, cut);
        bool text = !s.empty();
        for (char c : s) text = text && c >= 32 && c < 127;
        if (text) encoder = s.substr(0, 63);
      }
      i += size;
    }
  }

  // The RGB conversion OpenCV applies to the stream: swscale's table of its
  // VUI matrix_coeffs, in full range where video_full_range_flag says so.
  static const yuv::Coeffs* colour_matrix(const Sps& s) {
    bool f = s.full_range;
    switch (s.colour_description ? s.matrix : 2) {
      case 1: return f ? &yuv::kBt709Full : &yuv::kBt709;
      case 2: case 5: case 6: return f ? &yuv::kBt601Full : &yuv::kBt601;
      case 4: return f ? &yuv::kFccFull : &yuv::kFcc;
      case 7: return f ? &yuv::kSmpte240mFull : &yuv::kSmpte240m;
      case 9: case 10: return f ? &yuv::kBt2020Full : &yuv::kBt2020;
      default:
        unsupported("the VUI matrix_coeffs " + std::to_string(s.matrix) +
                    " (RGB, YCgCo or a matrix OpenCV's conversion does not name)");
    }
  }

  // ------------------------------------------------ slice headers

  void pred_weight_table(Bits& b, SliceHeader& s) {
    s.luma_denom = b.ue_max(7, "luma_log2_weight_denom");
    s.chroma_denom = s.luma_denom + b.se_range(-s.luma_denom, 7 - s.luma_denom,
                                               "delta_chroma_log2_weight_denom");
    for (int l = 0; l < (s.type == B_SLICE ? 2 : 1); l++) {
      bool lf[16], cf[16];
      // a reference picture never has the current picture's POC in one layer
      for (int i = 0; i < s.num_ref_idx[l]; i++) lf[i] = b.get1();
      for (int i = 0; i < s.num_ref_idx[l]; i++) cf[i] = b.get1();
      for (int i = 0; i < s.num_ref_idx[l]; i++) {
        s.weight[l][i][0] = 1 << s.luma_denom;
        s.offset[l][i][0] = 0;
        if (lf[i]) {
          s.weight[l][i][0] += b.se_range(-128, 127, "delta_luma_weight");
          s.offset[l][i][0] = b.se_range(-128, 127, "luma_offset");
        }
        for (int c = 1; c < 3; c++) {
          s.weight[l][i][c] = 1 << s.chroma_denom;
          s.offset[l][i][c] = 0;
          if (cf[i]) {
            int w = (1 << s.chroma_denom) + b.se_range(-128, 127, "delta_chroma_weight");
            int d = b.se_range(-512, 511, "delta_chroma_offset");
            s.weight[l][i][c] = w;
            s.offset[l][i][c] = clip3(-128, 127, (128 - ((128 * w) >> s.chroma_denom)) + d);
          }
        }
      }
    }
  }

  void parse_slice_header(Bits& b, int nal_type, SliceHeader& s) {
    s.first_in_pic = b.get1();
    if (nal_type >= BLA_W_LP && nal_type <= 23) s.no_output_of_prior_pics = b.get1();
    s.pps_id = b.ue_max(63, "slice_pic_parameter_set_id");
    const Pps& p = pps_list[s.pps_id];
    if (!p.valid) fail("a slice of a missing PPS");
    const Sps& sp = sps_list[p.sps_id];
    if (!sp.valid) fail("a slice of a missing SPS");
    int log2c = sp.log2_ctb, cw_ = (sp.width + (1 << log2c) - 1) >> log2c;
    int ctbs = cw_ * ((sp.height + (1 << log2c) - 1) >> log2c);
    if (!s.first_in_pic) {
      if (p.dependent_slices && b.get1()) unsupported("dependent slice segments");
      s.address = (int)b.get(ceil_log2(ctbs));
      if (s.address >= ctbs) fail("slice_segment_address out of range");
    }
    for (int i = 0; i < p.num_extra_bits; i++) b.get1();
    s.type = b.ue_max(2, "slice_type");
    if (p.output_flag_present) s.pic_output = b.get1();
    int total_curr = 0;
    if (nal_type != IDR_W_RADL && nal_type != IDR_N_LP) {
      s.poc_lsb = (int)b.get(sp.log2_max_poc_lsb);
      int num_sets = (int)sp.rps.size();
      if (!b.get1()) {
        st_ref_pic_set(b, num_sets, num_sets, sp.rps, s.rps);
      } else {
        if (num_sets == 0) fail("a slice that names an RPS of an SPS without one");
        int idx = num_sets > 1 ? (int)b.get(ceil_log2(num_sets)) : 0;
        if (idx >= num_sets) fail("short_term_ref_pic_set_idx out of range");
        s.rps = sp.rps[idx];
      }
      if (sp.long_term_present && b.ue_max(32, "num_long_term_pics"))
        unsupported("long-term reference pictures");
      if (sp.temporal_mvp) s.temporal_mvp = b.get1();
      for (int i = 0; i < s.rps.num(); i++) total_curr += s.rps.used[i];
    }
    if (sp.sao) {
      s.sao_luma = b.get1();
      s.sao_chroma = b.get1();
    }
    if (s.type != I_SLICE) {
      s.num_ref_idx[0] = p.num_ref_idx_default[0];
      s.num_ref_idx[1] = s.type == B_SLICE ? p.num_ref_idx_default[1] : 0;
      if (b.get1()) {
        s.num_ref_idx[0] = b.ue_max(14, "num_ref_idx_l0_active_minus1") + 1;
        if (s.type == B_SLICE) s.num_ref_idx[1] = b.ue_max(14, "num_ref_idx_l1_active_minus1") + 1;
      }
      if (total_curr == 0) fail("a P or B slice without reference pictures");
      if (p.lists_modification && total_curr > 1) {
        for (int l = 0; l < (s.type == B_SLICE ? 2 : 1); l++) {
          s.mod_flag[l] = b.get1();
          if (s.mod_flag[l])
            for (int i = 0; i < s.num_ref_idx[l]; i++) {
              s.list_entry[l][i] = (int)b.get(ceil_log2(total_curr));
              if (s.list_entry[l][i] >= total_curr) fail("list_entry out of range");
            }
        }
      }
      if (s.type == B_SLICE) s.mvd_l1_zero = b.get1();
      if (p.cabac_init_present) s.cabac_init = b.get1();
      if (s.temporal_mvp) {
        if (s.type == B_SLICE) s.collocated_from_l0 = b.get1();
        int l = s.collocated_from_l0 ? 0 : 1;
        if (s.num_ref_idx[l] > 1)
          s.collocated_ref_idx = b.ue_max(s.num_ref_idx[l] - 1, "collocated_ref_idx");
      }
      if ((p.weighted_pred && s.type == P_SLICE) || (p.weighted_bipred && s.type == B_SLICE)) {
        pred_weight_table(b, s);
        s.weighted = true;
      }
      s.max_merge = 5 - b.ue_max(4, "five_minus_max_num_merge_cand");
    }
    s.qp = p.init_qp + b.se_range(-p.init_qp, 51 - p.init_qp, "slice_qp_delta");
    if (p.slice_chroma_qp_offsets) {
      s.cb_qp_offset = b.se_range(-12, 12, "slice_cb_qp_offset");
      s.cr_qp_offset = b.se_range(-12, 12, "slice_cr_qp_offset");
      if (std::abs(p.cb_qp_offset + s.cb_qp_offset) > 12 ||
          std::abs(p.cr_qp_offset + s.cr_qp_offset) > 12)
        fail("chroma QP offsets out of range");
    }
    s.deblocking_disabled = p.deblocking_disabled;
    s.beta_offset = p.beta_offset;
    s.tc_offset = p.tc_offset;
    if (p.deblocking_override_enabled && b.get1()) {
      s.deblocking_disabled = b.get1();
      if (!s.deblocking_disabled) {
        s.beta_offset = 2 * b.se_range(-6, 6, "slice_beta_offset_div2");
        s.tc_offset = 2 * b.se_range(-6, 6, "slice_tc_offset_div2");
      }
    }
    s.lf_across_slices = p.loop_filter_across_slices;
    if (p.loop_filter_across_slices && (s.sao_luma || s.sao_chroma || !s.deblocking_disabled))
      s.lf_across_slices = b.get1();
    if (p.entropy_sync) {
      s.num_entry_points = b.ue_max(ctbs, "num_entry_point_offsets");
      if (s.num_entry_points) {
        int len = b.ue_max(31, "offset_len_minus1") + 1;
        for (int i = 0; i < s.num_entry_points; i++) b.get(len);
      }
    }
    if (p.slice_header_extension) b.skip(8 * (size_t)b.ue_max(256, "slice_segment_header_extension_length"));
    if (!b.get1()) fail("a slice header without its alignment bit");
    while (b.pos & 7)
      if (b.get1()) fail("a slice header's alignment bits not zero");
  }

  // ------------------------------------------------ pictures

  void start_picture(const SliceHeader& s, int nal_type, int tid) {
    const Pps& p = pps_list[s.pps_id];
    const Sps& sp = sps_list[p.sps_id];
    bool irap = nal_type >= BLA_W_LP && nal_type <= 23;
    bool idr = nal_type == IDR_W_RADL || nal_type == IDR_N_LP;
    bool bla = nal_type >= BLA_W_LP && nal_type <= BLA_N_LP;
    if (!started) {
      if (!irap) unsupported("a stream that does not start with an IRAP picture");
      coeffs = colour_matrix(sp);
      started = true;
      active = sp;
      setup_geometry();
    } else if (sp.width != active.width || sp.height != active.height ||
               sp.log2_ctb != active.log2_ctb || sp.log2_min_cb != active.log2_min_cb ||
               sp.crop_left != active.crop_left || sp.crop_right != active.crop_right ||
               sp.crop_top != active.crop_top || sp.crop_bottom != active.crop_bottom ||
               colour_matrix(sp) != coeffs) {
      unsupported("a size or colour change within the stream");
    } else {
      active = sp;
    }
    pps = &p;
    bool no_rasl_output = irap && (idr || bla || first_picture || after_eos);
    // the POC (8.3.1), as FFmpeg computes it
    int poc = 0;
    if (!idr) {
      int max = 1 << active.log2_max_poc_lsb;
      int prev_lsb = prev_tid0_poc % max, prev_msb = prev_tid0_poc - prev_lsb;
      int msb = prev_msb;
      if (s.poc_lsb < prev_lsb && prev_lsb - s.poc_lsb >= max / 2) msb = prev_msb + max;
      else if (s.poc_lsb > prev_lsb && s.poc_lsb - prev_lsb > max / 2) msb = prev_msb - max;
      if (bla) msb = 0;
      poc = msb + s.poc_lsb;
    }
    if (tid == 0 && nal_type != TRAIL_N && nal_type != TSA_N && nal_type != 4 &&
        nal_type != RADL_N && nal_type != RADL_R && nal_type != RASL_N && nal_type != RASL_R)
      prev_tid0_poc = poc;
    // RASL pictures of the first CRA picture are not decoded (FFmpeg's max_ra)
    if (max_ra == 0x7fffffff) {
      if (nal_type == CRA_NUT || bla) max_ra = poc;
      else if (idr) max_ra = -0x7fffffff - 1;
    }
    if ((nal_type == RASL_N || nal_type == RASL_R) && poc <= max_ra) {
      cur_skipped = true;
      stats[RASL_SKIPPED]++;
      return;
    }
    if (nal_type == RASL_R && poc > max_ra) max_ra = -0x7fffffff - 1;
    first_picture = false;
    after_eos = false;
    if (no_rasl_output) {  // C.5.2.2: every waiting picture goes first
      for (auto& q : dpb) q->reference = false;
      if (s.no_output_of_prior_pics)
        for (auto& q : dpb) q->output = false;
      bump(0, 0);
    }
    // the RPS marking (8.3.2)
    for (auto& q : dpb) {
      bool keep = false;
      for (int i = 0; i < s.rps.num() && !keep; i++) keep = q->poc == poc + s.rps.delta[i];
      q->reference = keep && !idr;
    }
    for (int i = 0; i < s.rps.num(); i++) {
      if (!s.rps.used[i]) continue;
      bool found = false;
      for (auto& q : dpb) found = found || (q->reference && q->poc == poc + s.rps.delta[i]);
      if (!found) fail("a reference picture (POC " + std::to_string(poc + s.rps.delta[i]) +
                       ") missing from the decoded picture buffer");
    }
    dpb.erase(std::remove_if(dpb.begin(), dpb.end(),
                             [](const std::shared_ptr<Picture>& q) { return !q->reference && !q->output; }),
              dpb.end());
    cur = std::make_shared<Picture>();
    cur->poc = poc;
    cur->output = s.pic_output;
    cur->plane[0].assign((size_t)width * height, 0);
    cur->plane[1].assign((size_t)cw * ch, 0);
    cur->plane[2].assign((size_t)cw * ch, 0);
    cur->motion.assign((size_t)w4 * h4, MvField());
    cur_nal_type = nal_type;
    cur_irap = irap;
    std::fill(ctb_slice.begin(), ctb_slice.end(), -1);
    std::fill(pred_mode.begin(), pred_mode.end(), 0);
    std::fill(bs_v.begin(), bs_v.end(), 0);
    std::fill(bs_h.begin(), bs_h.end(), 0);
    std::fill(cbf_map.begin(), cbf_map.end(), 0);
    std::fill(bypass_map.begin(), bypass_map.end(), 0);
    slices.clear();
    ctbs_decoded = 0;
    stats[IDR] += idr;
    stats[CRA] += nal_type == CRA_NUT;
    stats[RADL] += nal_type == RADL_N || nal_type == RADL_R;
    stats[RASL] += nal_type == RASL_N || nal_type == RASL_R;
    stats[NOT_OUTPUT] += !s.pic_output;
    stats[SCALING_LIST_PICTURES] += active.scaling_list_enabled;
    stats[CONSTRAINED_INTRA] += p.constrained_intra;
    stats[WPP] += p.entropy_sync;
    stats[CROPPED] += (active.crop_left | active.crop_right | active.crop_top | active.crop_bottom) != 0;
  }

  void setup_geometry() {
    width = active.width;
    height = active.height;
    cw = width / 2;
    ch = height / 2;
    log2_ctb = active.log2_ctb;
    ctb_size = 1 << log2_ctb;
    ctb_w = (width + ctb_size - 1) >> log2_ctb;
    ctb_h = (height + ctb_size - 1) >> log2_ctb;
    w4 = width / 4;
    h4 = height / 4;
    size_t n4 = (size_t)w4 * h4, nctb = (size_t)ctb_w * ctb_h;
    ctb_slice.assign(nctb, -1);
    ctb_header.assign(nctb, 0);
    sao.assign(nctb, SaoParams());
    for (auto* m : {&pred_mode, &skip_map, &depth_map, &ipm, &bypass_map, &cbf_map, &bs_v, &bs_h})
      m->assign(n4, 0);
    qp_map.assign(n4, 0);
    int n = ctb_size >> 2;
    zorder.assign((size_t)n * n, 0);
    for (int y = 0; y < n; y++)
      for (int x = 0; x < n; x++) {
        int z = 0;
        for (int bit = 0; bit < 5; bit++) z |= ((x >> bit) & 1) << (2 * bit) | ((y >> bit) & 1) << (2 * bit + 1);
        zorder[(size_t)y * n + x] = (uint16_t)z;
      }
  }

  // FFmpeg 8's output rule: the waiting picture of the smallest POC goes
  // while more than max_output wait or more than max_dpb are held
  void bump(size_t max_output, size_t max_dpb) {
    while (true) {
      size_t waiting = 0;
      std::shared_ptr<Picture> first;
      for (auto& q : dpb)
        if (q->output) {
          waiting++;
          if (!first || q->poc < first->poc) first = q;
        }
      if (!(waiting > max_output || (waiting && dpb.size() > max_dpb))) break;
      first->output = false;
      if (have_output && first->packet < last_output_packet) stats[REORDERED]++;
      last_output_packet = std::max(last_output_packet, first->packet);
      have_output = true;
      ready.push_back(first);
      if (!first->reference) dpb.erase(std::find(dpb.begin(), dpb.end(), first));
    }
  }
  int64_t last_output_packet = 0;

  void build_lists() {
    int poc = cur->poc;
    std::vector<std::shared_ptr<Picture>> before, after;
    auto find = [&](int want) {
      for (auto& q : dpb)
        if (q->reference && q->poc == want) return q;
      fail("a reference picture missing from the decoded picture buffer");
    };
    for (int i = 0; i < sh.rps.num_neg; i++)
      if (sh.rps.used[i]) before.push_back(find(poc + sh.rps.delta[i]));
    for (int i = sh.rps.num_neg; i < sh.rps.num(); i++)
      if (sh.rps.used[i]) after.push_back(find(poc + sh.rps.delta[i]));
    int total = (int)(before.size() + after.size());
    for (int l = 0; l < 2; l++) {
      rpl[l].clear();
      if (l >= (sh.type == B_SLICE ? 2 : sh.type == P_SLICE ? 1 : 0)) continue;
      std::vector<std::shared_ptr<Picture>> temp;
      int n = std::max(sh.num_ref_idx[l], total);
      while ((int)temp.size() < n) {
        for (auto& q : (l == 0 ? before : after))
          if ((int)temp.size() < n) temp.push_back(q);
        for (auto& q : (l == 0 ? after : before))
          if ((int)temp.size() < n) temp.push_back(q);
      }
      for (int i = 0; i < sh.num_ref_idx[l]; i++) {
        rpl[l].push_back(sh.mod_flag[l] ? temp[sh.list_entry[l][i]] : temp[i]);
        rpl_poc[l][i] = rpl[l].back()->poc;
      }
      stats[LIST_MODIFICATIONS] += sh.mod_flag[l];
    }
    col_pic.reset();
    if (sh.temporal_mvp && sh.type != I_SLICE)
      col_pic = rpl[sh.collocated_from_l0 ? 0 : 1][sh.collocated_ref_idx];
    no_backward_pred = true;
    for (int l = 0; l < 2; l++)
      for (auto& q : rpl[l]) no_backward_pred = no_backward_pred && q->poc <= poc;
  }

  void slice(const std::vector<uint8_t>& r, int nal_type, int tid) {
    Bits b(r.data(), r.size());
    SliceHeader s;
    parse_slice_header(b, nal_type, s);
    if (s.first_in_pic) {
      if (cur || cur_skipped || pictures_in_packet) unsupported("several pictures in one packet");
      pictures_in_packet++;
      start_picture(s, nal_type, tid);
    } else if (!cur && !cur_skipped) {
      fail("a slice segment without the first of its picture");
    }
    if (cur_skipped) return;
    if (nal_type != cur_nal_type) fail("slices of one picture of different NAL unit types");
    if (s.pps_id != (int)(pps - pps_list) && pps_list[s.pps_id].sps_id != pps->sps_id)
      fail("slices of one picture of different SPSs");
    pps = &pps_list[s.pps_id];
    sh = s;
    slices.push_back(sh);
    build_lists();
    stats[SLICES]++;
    stats[MULTI_SLICE] += slices.size() == 2;
    stats[P_PICTURES] += sh.type == P_SLICE && sh.first_in_pic;
    stats[B_PICTURES] += sh.type == B_SLICE && sh.first_in_pic;
    stats[DEBLOCK_OFF_SLICES] += sh.deblocking_disabled;
    stats[DEBLOCK_OFFSET_SLICES] += !sh.deblocking_disabled && (sh.beta_offset || sh.tc_offset);
    stats[CHROMA_QP_OFFSETS] += (pps->cb_qp_offset | pps->cr_qp_offset | sh.cb_qp_offset |
                                 sh.cr_qp_offset) != 0;
    slice_data(r, b.pos);
  }
  int pictures_in_packet = 0;

  // ------------------------------------------------ CABAC

  int dec(int ctx) { return cabac.decision(ctx); }
  int byp() { return cabac.bypass(); }
  int bypass_bits(int n) {
    int v = 0;
    while (n--) v = (v << 1) | cabac.bypass();
    return v;
  }

  void init_contexts() {
    int t = sh.type == I_SLICE ? 0 : sh.type == P_SLICE ? (sh.cabac_init ? 2 : 1)
                                                        : (sh.cabac_init ? 1 : 2);
    int q = clip3(0, 51, sh.qp);
    for (int i = 0; i < N_CTX; i++) {
      int v = kCtxInit[t][i];
      int m = (v >> 4) * 5 - 45, n = ((v & 15) << 3) - 16;
      int pre = clip3(1, 126, ((m * q) >> 4) + n);
      cabac.state[i] = pre <= 63 ? (uint8_t)((63 - pre) << 1) : (uint8_t)(((pre - 64) << 1) | 1);
    }
  }

  void slice_data(const std::vector<uint8_t>& r, size_t start) {
    slice_addr = sh.address;
    int ctbs = ctb_w * ctb_h;
    ctb_addr = sh.address;
    init_contexts();
    if (!cabac.init_engine(r.data(), r.size() * 8, start)) fail("a CABAC offset of 510 or 511");
    first_qg = true;
    last_qp_y = sh.qp;
    qp_y = sh.qp;
    int header = (int)slices.size() - 1;
    if (ctb_addr >= ctbs) fail("slice_segment_address out of range");
    while (true) {
      if (ctb_slice[ctb_addr] != -1) fail("a slice over CTBs already decoded");
      int cx = ctb_addr % ctb_w, cy = ctb_addr / ctb_w;
      ctb_slice[ctb_addr] = slice_addr;
      ctb_header[ctb_addr] = header;
      ctb_x0 = cx << log2_ctb;
      ctb_y0 = cy << log2_ctb;
      if (pps->entropy_sync && cx == 0) first_qg = true;
      sao[ctb_addr] = SaoParams();
      if (sh.sao_luma || sh.sao_chroma) sao_syntax(cx, cy);
      coding_quadtree(ctb_x0, ctb_y0, log2_ctb, 0);
      ctbs_decoded++;
      stats[CTUS]++;
      if (cabac.overread > 64) fail("a truncated slice");
      if (pps->entropy_sync && cx == 1) memcpy(wpp_state, cabac.state, N_CTX);
      bool end = cabac.terminate();  // end_of_slice_segment_flag
      ctb_addr++;
      if (end) break;
      if (ctb_addr >= ctbs) fail("a slice past the picture's last CTB");
      if (pps->entropy_sync && ctb_addr % ctb_w == 0) {
        if (!cabac.terminate()) fail("end_of_subset_one_bit equal to 0");
        size_t next = (cabac.pos + 7) & ~(size_t)7;
        if (next >= r.size() * 8 || !cabac.init_engine(r.data(), r.size() * 8, next))
          fail("a truncated wavefront substream");
        int up_right = ctb_addr - ctb_w + 1;
        if (ctb_w > 1 && ctb_slice[up_right] == slice_addr) memcpy(cabac.state, wpp_state, N_CTX);
        else init_contexts();
      }
    }
    if (cabac.overread > 16) fail("a truncated slice");
  }

  // ------------------------------------------------ coding tree

  int idx4(int x, int y) const { return (y >> 2) * w4 + (x >> 2); }

  // z-scan availability (6.4.1) of (xn, yn) from (xc, yc)
  bool avail(int xc, int yc, int xn, int yn) const {
    if (xn < 0 || yn < 0 || xn >= width || yn >= height) return false;
    int cn = (yn >> log2_ctb) * ctb_w + (xn >> log2_ctb);
    if (ctb_slice[cn] != slice_addr) return false;
    int cc = (yc >> log2_ctb) * ctb_w + (xc >> log2_ctb);
    if (cn != cc) return cn < cc;
    int m = ctb_size - 1, n4 = ctb_size >> 2;
    return zorder[((yn & m) >> 2) * n4 + ((xn & m) >> 2)] < zorder[((yc & m) >> 2) * n4 + ((xc & m) >> 2)];
  }

  void sao_syntax(int rx, int ry) {
    SaoParams& sp = sao[ctb_addr];
    bool left = false, up = false;
    if (rx > 0 && ctb_addr - 1 >= slice_addr) left = dec(C_SAO_MERGE);
    if (ry > 0 && !left && ctb_addr - ctb_w >= slice_addr) up = dec(C_SAO_MERGE);
    if (left || up) {
      sp = sao[left ? ctb_addr - 1 : ctb_addr - ctb_w];
      stats[SAO_MERGE]++;
      return;
    }
    for (int c = 0; c < 3; c++) {
      if ((c == 0 && !sh.sao_luma) || (c > 0 && !sh.sao_chroma)) continue;
      if (c == 2) {
        sp.type[2] = sp.type[1];
        sp.eo_class[2] = sp.eo_class[1];
      } else {
        sp.type[c] = !dec(C_SAO_TYPE) ? 0 : byp() ? 2 : 1;
      }
      if (!sp.type[c]) continue;
      int abs[4];
      for (int i = 0; i < 4; i++) {
        abs[i] = 0;
        while (abs[i] < 7 && byp()) abs[i]++;
      }
      if (sp.type[c] == 1) {
        for (int i = 0; i < 4; i++)
          if (abs[i] && byp()) abs[i] = -abs[i];
        sp.band[c] = bypass_bits(5);
        for (int i = 0; i < 4; i++) sp.offset[c][i + 1] = abs[i];
        stats[SAO_BAND]++;
      } else {
        sp.offset[c][1] = abs[0];
        sp.offset[c][2] = abs[1];
        sp.offset[c][3] = -abs[2];
        sp.offset[c][4] = -abs[3];
        if (c < 2) sp.eo_class[c] = bypass_bits(2);
        stats[SAO_EDGE]++;
      }
    }
  }

  int qg_x = 0, qg_y = 0;
  bool need_qp_pred = true;

  void coding_quadtree(int x0, int y0, int log2, int depth) {
    int n = 1 << log2;
    bool split;
    if (x0 + n <= width && y0 + n <= height && log2 > active.log2_min_cb) {
      int inc = (avail(x0, y0, x0 - 1, y0) && depth_map[idx4(x0 - 1, y0)] > depth) +
                (avail(x0, y0, x0, y0 - 1) && depth_map[idx4(x0, y0 - 1)] > depth);
      split = dec(C_SPLIT_CU + inc);
    } else {
      split = log2 > active.log2_min_cb;
    }
    if (log2 >= log2_ctb - pps->diff_cu_qp_delta_depth) {  // a quantization group
      qp_delta_coded = false;
      qp_delta = 0;
      qg_x = x0;
      qg_y = y0;
      need_qp_pred = true;
    }
    if (split) {
      int h = n >> 1;
      coding_quadtree(x0, y0, log2 - 1, depth + 1);
      if (x0 + h < width) coding_quadtree(x0 + h, y0, log2 - 1, depth + 1);
      if (y0 + h < height) coding_quadtree(x0, y0 + h, log2 - 1, depth + 1);
      if (x0 + h < width && y0 + h < height) coding_quadtree(x0 + h, y0 + h, log2 - 1, depth + 1);
    } else {
      coding_unit(x0, y0, log2, depth);
    }
  }

  template <typename T>
  void fill4(std::vector<T>& m, int x0, int y0, int w, int h, T v) {
    for (int y = y0 >> 2; y < (y0 + h) >> 2; y++)
      for (int x = x0 >> 2; x < (x0 + w) >> 2; x++) m[(size_t)y * w4 + x] = v;
  }

  enum Part { PART_2Nx2N, PART_2NxN, PART_Nx2N, PART_NxN, PART_2NxnU, PART_2NxnD, PART_nLx2N, PART_nRx2N };

  int part_mode(bool intra, int log2) {
    if (dec(C_PART_MODE)) return PART_2Nx2N;
    if (intra) return PART_NxN;
    if (log2 == active.log2_min_cb) {
      if (dec(C_PART_MODE + 1)) return PART_2NxN;
      if (log2 == 3) return PART_Nx2N;
      if (dec(C_PART_MODE + 2)) return PART_Nx2N;
      return PART_NxN;
    }
    if (!active.amp) return dec(C_PART_MODE + 1) ? PART_2NxN : PART_Nx2N;
    if (dec(C_PART_MODE + 1)) {
      if (dec(C_PART_MODE + 3)) return PART_2NxN;
      return byp() ? PART_2NxnD : PART_2NxnU;
    }
    if (dec(C_PART_MODE + 3)) return PART_Nx2N;
    return byp() ? PART_nRx2N : PART_nLx2N;
  }

  void coding_unit(int x0, int y0, int log2, int depth) {
    int n = 1 << log2;
    cu_x = x0;
    cu_y = y0;
    cu_log2 = log2;
    if (need_qp_pred) {  // qPY_PRED of the quantization group (8.6.1)
      int prev = first_qg ? sh.qp : last_qp_y;
      first_qg = false;
      int m = ctb_size - 1;
      int a = (qg_x & m) ? qp_map[idx4(qg_x - 1, qg_y)] : prev;
      int b = (qg_y & m) ? qp_map[idx4(qg_x, qg_y - 1)] : prev;
      qp_y_pred = (a + b + 1) >> 1;
      need_qp_pred = false;
    }
    qp_y = (qp_y_pred + qp_delta + 52) % 52;
    cu_bypass = pps->transquant_bypass && dec(C_TQ_BYPASS);
    stats[BYPASS_CUS] += cu_bypass;
    bool skip = false;
    if (sh.type != I_SLICE) {
      int inc = (avail(x0, y0, x0 - 1, y0) && skip_map[idx4(x0 - 1, y0)]) +
                (avail(x0, y0, x0, y0 - 1) && skip_map[idx4(x0, y0 - 1)]);
      skip = dec(C_SKIP + inc);
    }
    fill4<uint8_t>(depth_map, x0, y0, n, n, (uint8_t)depth);
    fill4<uint8_t>(skip_map, x0, y0, n, n, skip);
    fill4<uint8_t>(bypass_map, x0, y0, n, n, cu_bypass);
    fill4<uint8_t>(cbf_map, x0, y0, n, n, 0);
    cu_depth = depth;
    if (skip) {
      stats[SKIP_CUS]++;
      cu_intra = false;
      cu_part = PART_2Nx2N;
      fill4<uint8_t>(pred_mode, x0, y0, n, n, 2);
      fill4<uint8_t>(ipm, x0, y0, n, n, 1);
      prediction_unit(x0, y0, n, x0, y0, n, n, 0, true);
      if (!sh.deblocking_disabled) edges(x0, y0, log2);
    } else {
      cu_intra = sh.type == I_SLICE || dec(C_PRED_MODE);
      cu_part = PART_2Nx2N;
      if (!cu_intra || log2 == active.log2_min_cb) cu_part = part_mode(cu_intra, log2);
      fill4<uint8_t>(pred_mode, x0, y0, n, n, cu_intra ? 1 : 2);
      bool merge0 = false;
      if (cu_intra) {
        fill4<MvField>(cur->motion, x0, y0, n, n, MvField());
        intra_modes(x0, y0, n);
        stats[cu_part == PART_NxN ? INTRA_NXN : INTRA_CUS]++;
      } else {
        fill4<uint8_t>(ipm, x0, y0, n, n, 1);
        int h = n / 2, q = n / 4;
        switch (cu_part) {
          case PART_2Nx2N: merge0 = prediction_unit(x0, y0, n, x0, y0, n, n, 0, false); break;
          case PART_2NxN:
            prediction_unit(x0, y0, n, x0, y0, n, h, 0, false);
            prediction_unit(x0, y0, n, x0, y0 + h, n, h, 1, false);
            break;
          case PART_Nx2N:
            prediction_unit(x0, y0, n, x0, y0, h, n, 0, false);
            prediction_unit(x0, y0, n, x0 + h, y0, h, n, 1, false);
            break;
          case PART_2NxnU:
            prediction_unit(x0, y0, n, x0, y0, n, q, 0, false);
            prediction_unit(x0, y0, n, x0, y0 + q, n, n - q, 1, false);
            break;
          case PART_2NxnD:
            prediction_unit(x0, y0, n, x0, y0, n, n - q, 0, false);
            prediction_unit(x0, y0, n, x0, y0 + n - q, n, q, 1, false);
            break;
          case PART_nLx2N:
            prediction_unit(x0, y0, n, x0, y0, q, n, 0, false);
            prediction_unit(x0, y0, n, x0 + q, y0, n - q, n, 1, false);
            break;
          case PART_nRx2N:
            prediction_unit(x0, y0, n, x0, y0, n - q, n, 0, false);
            prediction_unit(x0, y0, n, x0 + n - q, y0, q, n, 1, false);
            break;
          default:
            prediction_unit(x0, y0, n, x0, y0, h, h, 0, false);
            prediction_unit(x0, y0, n, x0 + h, y0, h, h, 1, false);
            prediction_unit(x0, y0, n, x0, y0 + h, h, h, 2, false);
            prediction_unit(x0, y0, n, x0 + h, y0 + h, h, h, 3, false);
        }
        stats[AMP_PUS] += cu_part >= PART_2NxnU;
      }
      bool rqt = true;
      if (!cu_intra && !(cu_part == PART_2Nx2N && merge0)) rqt = dec(C_RQT_ROOT_CBF);
      if (rqt) {
        int max_depth = cu_intra ? active.max_th_depth_intra + (cu_part == PART_NxN)
                                 : active.max_th_depth_inter;
        transform_tree(x0, y0, x0, y0, log2, 0, 0, true, true, max_depth);
      } else if (!sh.deblocking_disabled) {
        edges(x0, y0, log2);
      }
    }
    fill4<int8_t>(qp_map, x0, y0, n, n, (int8_t)qp_y);
    last_qp_y = qp_y;
  }
  int cu_depth = 0;

  void intra_modes(int x0, int y0, int n) {
    int parts = cu_part == PART_NxN ? 4 : 1, pb = cu_part == PART_NxN ? n / 2 : n;
    int prev[4];
    for (int i = 0; i < parts; i++) prev[i] = dec(C_PREV_INTRA);
    int first = 0;
    for (int i = 0; i < parts; i++) {
      int x = x0 + pb * (i & 1), y = y0 + pb * (i >> 1);
      int a = avail(x, y, x - 1, y) && pred_mode[idx4(x - 1, y)] == 1 ? ipm[idx4(x - 1, y)] : 1;
      int b = y - 1 >= ((y >> log2_ctb) << log2_ctb) && avail(x, y, x, y - 1) &&
                      pred_mode[idx4(x, y - 1)] == 1
                  ? ipm[idx4(x, y - 1)]
                  : 1;
      int cand[3];
      if (a == b) {
        if (a < 2) {
          cand[0] = 0;
          cand[1] = 1;
          cand[2] = 26;
        } else {
          cand[0] = a;
          cand[1] = 2 + ((a + 29) % 32);
          cand[2] = 2 + ((a - 2 + 1) % 32);
        }
      } else {
        cand[0] = a;
        cand[1] = b;
        cand[2] = (a != 0 && b != 0) ? 0 : (a != 1 && b != 1) ? 1 : 26;
      }
      int mode;
      if (prev[i]) {
        int k = 0;
        while (k < 2 && byp()) k++;
        mode = cand[k];
      } else {
        mode = bypass_bits(5);
        std::sort(cand, cand + 3);
        for (int k = 0; k < 3; k++)
          if (mode >= cand[k]) mode++;
      }
      fill4<uint8_t>(ipm, x, y, pb, pb, (uint8_t)mode);
      if (i == 0) first = mode;
    }
    int c = dec(C_CHROMA_MODE) ? bypass_bits(2) : 4;
    if (c == 4) {
      cu_ipm_c = first;
    } else {
      static const int kModes[4] = {0, 26, 10, 1};
      cu_ipm_c = kModes[c] == first ? 34 : kModes[c];
    }
  }

  // ------------------------------------------------ transform tree

  void transform_tree(int x0, int y0, int xb, int yb, int log2, int depth, int blk, bool pcb,
                      bool pcr, int max_depth) {
    bool intra_split = cu_intra && cu_part == PART_NxN;
    bool inter_split = active.max_th_depth_inter == 0 && !cu_intra && cu_part != PART_2Nx2N;
    bool split;
    if (log2 <= active.log2_max_tb && log2 > active.log2_min_tb && depth < max_depth &&
        !(intra_split && depth == 0))
      split = dec(C_SPLIT_TU + 5 - log2);
    else
      split = log2 > active.log2_max_tb || ((intra_split || inter_split) && depth == 0);
    bool cb = pcb, cr = pcr;
    if (log2 > 2) {
      cb = (depth == 0 || pcb) && dec(C_CBF_CHROMA + depth);
      cr = (depth == 0 || pcr) && dec(C_CBF_CHROMA + depth);
    }
    if (split) {
      stats[TU_SPLITS]++;
      int h = 1 << (log2 - 1);
      transform_tree(x0, y0, x0, y0, log2 - 1, depth + 1, 0, cb, cr, max_depth);
      transform_tree(x0 + h, y0, x0, y0, log2 - 1, depth + 1, 1, cb, cr, max_depth);
      transform_tree(x0, y0 + h, x0, y0, log2 - 1, depth + 1, 2, cb, cr, max_depth);
      transform_tree(x0 + h, y0 + h, x0, y0, log2 - 1, depth + 1, 3, cb, cr, max_depth);
      return;
    }
    bool luma = true;
    if (cu_intra || depth != 0 || cb || cr) luma = dec(C_CBF_LUMA + (depth == 0 ? 1 : 0));
    int n = 1 << log2;
    if (cu_intra) intra_predict(0, x0, y0, log2, ipm[idx4(x0, y0)]);
    if (luma || cb || cr) {
      if (pps->cu_qp_delta && !qp_delta_coded) {
        int v = 0;
        while (v < 5 && dec(C_QP_DELTA + (v ? 1 : 0))) v++;
        if (v == 5) {
          int k = 0;
          while (k < 7 && byp()) {
            v += 1 << k;
            k++;
          }
          if (k == 7) fail("a cu_qp_delta_abs out of range");
          v += bypass_bits(k);
        }
        if (v && byp()) v = -v;
        if (v < -26 || v > 25) fail("a CuQpDeltaVal out of range");
        qp_delta = v;
        qp_delta_coded = true;
        qp_y = (qp_y_pred + qp_delta + 52) % 52;
        stats[QP_DELTA_CUS] += v != 0;
      }
      if (luma) residual(x0, y0, log2, 0);
    }
    fill4<uint8_t>(cbf_map, x0, y0, n, n, luma);
    if (log2 > 2) {
      for (int c = 1; c < 3; c++) {
        if (cu_intra) intra_predict(c, x0 / 2, y0 / 2, log2 - 1, cu_ipm_c);
        if (c == 1 ? cb : cr) residual(x0 / 2, y0 / 2, log2 - 1, c);
      }
    } else if (blk == 3) {
      for (int c = 1; c < 3; c++) {
        if (cu_intra) intra_predict(c, xb / 2, yb / 2, 2, cu_ipm_c);
        if (c == 1 ? cb : cr) residual(xb / 2, yb / 2, 2, c);
      }
    }
    if (!sh.deblocking_disabled) edges(x0, y0, log2);
  }

  int chroma_qp(int c) const {
    int off = c == 1 ? pps->cb_qp_offset + sh.cb_qp_offset : pps->cr_qp_offset + sh.cr_qp_offset;
    int q = clip3(0, 57, qp_y + off);
    return q < 30 ? q : q > 43 ? q - 6 : kQpC[q - 30];
  }

  int coeff_abs_level_remaining(int rice) {
    int prefix = 0;
    while (prefix < 32 && byp()) prefix++;
    if (prefix <= 3) return (prefix << rice) + bypass_bits(rice);
    int k = prefix - 3;
    if (k + rice > 24) fail("a coeff_abs_level_remaining out of range");
    stats[LONG_LEVELS] += prefix >= 8;
    return (((1 << k) + 2) << rice) + bypass_bits(k + rice);
  }

  // residual_coding (7.3.8.11) of a block at (xT, yT) of component c, then
  // its scaling, transform and reconstruction
  void residual(int xT, int yT, int log2, int c) {
    int n = 1 << log2;
    int32_t coeff[32 * 32];
    memset(coeff, 0, sizeof(int32_t) * n * n);
    bool ts = false;
    if (pps->transform_skip && !cu_bypass && log2 == 2) ts = dec(C_TS + (c ? 1 : 0));
    stats[TS_BLOCKS] += ts;
    int off, shift;
    if (c == 0) {
      off = 3 * (log2 - 2) + ((log2 - 1) >> 2);
      shift = (log2 + 1) >> 2;
    } else {
      off = 15;
      shift = log2 - 2;
    }
    int max = (log2 << 1) - 1;
    int px = 0, py = 0;
    while (px < max && dec(C_LAST_X + off + (px >> shift))) px++;
    while (py < max && dec(C_LAST_Y + off + (py >> shift))) py++;
    int lx = px, ly = py;
    if (px > 3) {
      int k = (px >> 1) - 1;
      lx = (1 << k) * (2 + (px & 1)) + bypass_bits(k);
    }
    if (py > 3) {
      int k = (py >> 1) - 1;
      ly = (1 << k) * (2 + (py & 1)) + bypass_bits(k);
    }
    int scan = 0;
    if (cu_intra && (log2 == 2 || (log2 == 3 && c == 0))) {
      int m = c ? cu_ipm_c : ipm[idx4(xT, yT)];
      scan = (m >= 6 && m <= 14) ? 2 : (m >= 22 && m <= 30) ? 1 : 0;
    }
    if (scan == 2) std::swap(lx, ly);
    const uint8_t(*sub)[2] = kTables.scan(scan, log2 - 2);
    const uint8_t(*pos)[2] = kTables.scan(scan, 2);
    int nsb = 1 << (log2 - 2);
    int last_s = 0, last_p = 0;
    for (int i = 0; i < nsb * nsb; i++)
      if (sub[i][0] == (lx >> 2) && sub[i][1] == (ly >> 2)) last_s = i;
    for (int p = 0; p < 16; p++)
      if (pos[p][0] == (lx & 3) && pos[p][1] == (ly & 3)) last_p = p;
    uint8_t csbf[8][8];
    memset(csbf, 0, sizeof(csbf));
    int greater1_ctx = 1;
    bool hiding = pps->sign_hiding && !cu_bypass;
    for (int i = last_s; i >= 0; i--) {
      int xS = sub[i][0], yS = sub[i][1];
      bool infer_dc = false;
      if (i < last_s && i > 0) {
        int right = xS + 1 < nsb ? csbf[yS][xS + 1] : 0, below = yS + 1 < nsb ? csbf[yS + 1][xS] : 0;
        csbf[yS][xS] = (uint8_t)dec(C_CSBF + std::min(right + below, 1) + (c ? 2 : 0));
        infer_dc = true;
      } else {
        csbf[yS][xS] = 1;
      }
      int sig[16], nsig = 0;
      if (i == last_s) sig[nsig++] = last_p;
      if (!csbf[yS][xS]) continue;
      int prev = (xS + 1 < nsb ? csbf[yS][xS + 1] : 0) | (yS + 1 < nsb ? csbf[yS + 1][xS] : 0) << 1;
      for (int p = i == last_s ? last_p - 1 : 15; p >= 0; p--) {
        int xP = pos[p][0], yP = pos[p][1];
        int xC = (xS << 2) + xP, yC = (yS << 2) + yP;
        if (p == 0 && infer_dc) {
          sig[nsig++] = 0;
          break;
        }
        int s;
        if (log2 == 2) {
          s = kSigCtx4x4[(yC << 2) + xC];
        } else if (xC + yC == 0) {
          s = 0;
        } else {
          if (prev == 0) s = (xP + yP == 0) ? 2 : (xP + yP < 3) ? 1 : 0;
          else if (prev == 1) s = yP == 0 ? 2 : yP == 1 ? 1 : 0;
          else if (prev == 2) s = xP == 0 ? 2 : xP == 1 ? 1 : 0;
          else s = 2;
          if (c == 0) {
            if (xS > 0 || yS > 0) s += 3;
            s += log2 == 3 ? (scan == 0 ? 9 : 15) : 21;
          } else {
            s += log2 == 3 ? 9 : 12;
          }
        }
        if (dec(C_SIG + (c ? 27 : 0) + s)) {
          sig[nsig++] = p;
          infer_dc = false;
        }
      }
      if (!nsig) continue;
      int ctx_set = (i == 0 || c > 0) ? 0 : 2;
      if (i != last_s && greater1_ctx == 0) ctx_set++;
      greater1_ctx = 1;
      int g1[16] = {}, first_g1 = -1;
      for (int m = 0; m < std::min(nsig, 8); m++) {
        g1[m] = dec(C_G1 + (c ? 16 : 0) + ctx_set * 4 + greater1_ctx);
        if (g1[m]) {
          greater1_ctx = 0;
          if (first_g1 < 0) first_g1 = m;
        } else if (greater1_ctx > 0 && greater1_ctx < 3) {
          greater1_ctx++;
        }
      }
      int g2 = first_g1 >= 0 ? dec(C_G2 + (c ? 4 : 0) + ctx_set) : 0;
      bool hidden = hiding && sig[0] - sig[nsig - 1] > 3;
      stats[SIGN_HIDDEN] += hidden;
      int signs = bypass_bits(hidden ? nsig - 1 : nsig) << (hidden ? 1 : 0);
      int rice = 0, sum = 0;
      for (int m = 0; m < nsig; m++) {
        int base = 1 + g1[m] + (m == first_g1 ? g2 : 0);
        int level = base;
        if (base == (m < 8 ? (m == first_g1 ? 3 : 2) : 1)) {
          level += coeff_abs_level_remaining(rice);
          if (level > 3 * (1 << rice)) rice = std::min(rice + 1, 4);
        }
        if (level > 32768) fail("a coefficient level out of range");
        int v = level;
        if (hidden) {
          sum += level;
          if (m == nsig - 1 && (sum & 1)) v = -v;
        }
        if ((signs >> (nsig - 1 - m)) & 1) v = -v;
        if (v > 32767) fail("a coefficient level out of range");
        int p = sig[m];
        coeff[((yS << 2) + pos[p][1]) * n + (xS << 2) + pos[p][0]] = v;
      }
    }
    reconstruct(xT, yT, log2, c, coeff, ts);
  }

  void reconstruct(int xT, int yT, int log2, int c, int32_t* coeff, bool ts) {
    int n = 1 << log2;
    int32_t res[32 * 32];
    if (cu_bypass) {
      memcpy(res, coeff, sizeof(int32_t) * n * n);
    } else {
      int qp = c == 0 ? qp_y : chroma_qp(c);
      int bd_shift = log2 + 3;
      int64_t add = (int64_t)1 << (bd_shift - 1);
      int64_t scale = (int64_t)kLevelScale[qp % 6] << (qp / 6);
      bool lists = active.scaling_list_enabled && !(ts && n > 4);
      const ScalingLists& sl = pps->scaling_present ? pps->scaling : active.scaling;
      int matrix = (cu_intra ? 0 : 3) + c;
      int max_row = 0, max_col = 0;
      for (int y = 0; y < n; y++)
        for (int x = 0; x < n; x++) {
          int32_t& v = coeff[y * n + x];
          if (!v) continue;
          int m = lists ? sl.factor(log2 - 2, matrix, x, y) : 16;
          int64_t d = (v * (int64_t)m * scale + add) >> bd_shift;
          v = (int32_t)(d < -32768 ? -32768 : d > 32767 ? 32767 : d);
          max_row = std::max(max_row, y);
          max_col = std::max(max_col, x);
        }
      if (ts) {
        for (int i = 0; i < n * n; i++) res[i] = (coeff[i] * 128 + 2048) >> 12;
      } else {
        bool dst = c == 0 && cu_intra && log2 == 2;
        stats[DST_BLOCKS] += dst;
        stats[DCT32_BLOCKS] += log2 == 5;
        inverse_transform(coeff, log2, dst, max_row, max_col, res);
      }
    }
    uint8_t* plane = cur->plane[c].data();
    int stride = c ? cw : width;
    for (int y = 0; y < n; y++) {
      uint8_t* row = plane + (size_t)(yT + y) * stride + xT;
      for (int x = 0; x < n; x++) row[x] = clip1(row[x] + res[y * n + x]);
    }
  }

  // the two stages of 8.6.4.2: columns, clipped to 16 bits after >> 7,
  // then rows, >> 12
  static void inverse_transform(const int32_t* d, int log2, bool dst, int max_row, int max_col,
                                int32_t* res) {
    int n = 1 << log2, step = 32 >> log2;
    auto m = [&](int k, int i) -> int { return dst ? kDst4[k][i] : kTables.dct[k * step][i]; };
    int32_t tmp[32 * 32];
    for (int x = 0; x < n; x++)
      for (int y = 0; y < n; y++) {
        int64_t s = 0;
        if (x <= max_col)
          for (int j = 0; j <= max_row; j++) s += m(j, y) * (int64_t)d[j * n + x];
        int64_t v = (s + 64) >> 7;
        tmp[y * n + x] = (int32_t)(v < -32768 ? -32768 : v > 32767 ? 32767 : v);
      }
    for (int y = 0; y < n; y++)
      for (int x = 0; x < n; x++) {
        int64_t s = 0;
        for (int j = 0; j <= max_col; j++) s += m(j, x) * (int64_t)tmp[y * n + j];
        res[y * n + x] = (int32_t)((s + 2048) >> 12);
      }
  }

  // ------------------------------------------------ intra prediction

  void intra_predict(int c, int xT, int yT, int log2, int mode) {
    int n = 1 << log2, s = c ? 1 : 0;
    uint8_t* plane = cur->plane[c].data();
    int stride = c ? cw : width;
    int xY = xT << s, yY = yT << s;
    bool constrained = pps->constrained_intra;
    auto ok = [&](int xn, int yn) {
      if (!avail(xY, yY, xn, yn)) return false;
      return !constrained || pred_mode[idx4(xn, yn)] == 1;
    };
    // ref: p[-1][2n-1] .. p[-1][0], p[-1][-1], p[0][-1] .. p[2n-1][-1]
    int ref[129], fil[129];
    bool av[129];
    int total = 4 * n + 1, any = 0;
    for (int k = 0; k < 2 * n; k++) av[k] = ok(xY - 1, (yT + 2 * n - 1 - k) << s);
    av[2 * n] = ok(xY - 1, yY - 1);
    for (int x = 0; x < 2 * n; x++) av[2 * n + 1 + x] = ok((xT + x) << s, yY - 1);
    for (int k = 0; k < total; k++) {
      if (!av[k]) continue;
      any++;
      int x, y;
      if (k < 2 * n) { x = -1; y = 2 * n - 1 - k; }
      else if (k == 2 * n) { x = -1; y = -1; }
      else { x = k - 2 * n - 1; y = -1; }
      ref[k] = plane[(size_t)(yT + y) * stride + xT + x];
    }
    if (!any) {
      for (int k = 0; k < total; k++) ref[k] = 128;
    } else {
      if (!av[0]) {
        int k = 1;
        while (!av[k]) k++;
        ref[0] = ref[k];
      }
      for (int k = 1; k < total; k++)
        if (!av[k]) ref[k] = ref[k - 1];
    }
    // filtering (8.4.4.2.3), luma only under 4:2:0
    const int* p = ref;
    if (c == 0 && mode != 1 && n != 4) {
      int dist = std::min(std::abs(mode - 26), std::abs(mode - 10));
      int thres = n == 8 ? 7 : n == 16 ? 1 : 0;
      if (dist > thres) {
        int corner = ref[2 * n], bottom = ref[0], right = ref[4 * n];
        if (active.strong_intra_smoothing && n == 32 &&
            std::abs(corner + right - 2 * ref[2 * n + 1 + 31]) < 8 &&
            std::abs(corner + bottom - 2 * ref[2 * n - 1 - 31]) < 8) {
          // bilinear over p[-1][-1] .. p[-1][63] and p[-1][-1] .. p[63][-1]
          fil[2 * n] = corner;
          for (int y = 0; y < 63; y++) fil[2 * n - 1 - y] = ((63 - y) * corner + (y + 1) * bottom + 32) >> 6;
          fil[0] = bottom;
          for (int x = 0; x < 63; x++) fil[2 * n + 1 + x] = ((63 - x) * corner + (x + 1) * right + 32) >> 6;
          fil[4 * n] = right;
          stats[STRONG_SMOOTHING]++;
        } else {
          fil[0] = ref[0];
          fil[total - 1] = ref[total - 1];
          for (int k = 1; k < total - 1; k++) fil[k] = (ref[k - 1] + 2 * ref[k] + ref[k + 1] + 2) >> 2;
        }
        p = fil;
      }
    }
    // left(y) = p[-1][y], top(x) = p[x][-1], for -1 <= x, y < 2n
    auto left = [&](int y) { return p[2 * n - 1 - y]; };
    auto top = [&](int x) { return p[2 * n + 1 + x]; };
    uint8_t* dst = plane + (size_t)yT * stride + xT;
    if (c == 0) stats[mode == 0 ? PLANAR : mode == 1 ? DC : ANGULAR]++;
    if (mode == 0) {
      for (int y = 0; y < n; y++)
        for (int x = 0; x < n; x++)
          dst[y * stride + x] = (uint8_t)(((n - 1 - x) * left(y) + (x + 1) * top(n) +
                                           (n - 1 - y) * top(x) + (y + 1) * left(n) + n) >> (log2 + 1));
    } else if (mode == 1) {
      int sum = n;
      for (int k = 0; k < n; k++) sum += top(k) + left(k);
      int dc = sum >> (log2 + 1);
      for (int y = 0; y < n; y++)
        for (int x = 0; x < n; x++) dst[y * stride + x] = (uint8_t)dc;
      if (c == 0 && n < 32) {
        dst[0] = (uint8_t)((left(0) + 2 * dc + top(0) + 2) >> 2);
        for (int x = 1; x < n; x++) dst[x] = (uint8_t)((top(x) + 3 * dc + 2) >> 2);
        for (int y = 1; y < n; y++) dst[y * stride] = (uint8_t)((left(y) + 3 * dc + 2) >> 2);
      }
    } else {
      int angle = kIntraAngle[mode];
      int buf[3 * 64 + 1];
      int* r = buf + 64;  // r[-n .. 2n]
      bool vertical = mode >= 18;
      auto main_ = [&](int k) { return vertical ? (k == 0 ? p[2 * n] : top(k - 1)) : (k == 0 ? p[2 * n] : left(k - 1)); };
      auto side = [&](int k) { return vertical ? (k == 0 ? p[2 * n] : left(k - 1)) : (k == 0 ? p[2 * n] : top(k - 1)); };
      for (int x = 0; x <= n; x++) r[x] = main_(x);
      if (angle < 0) {
        int inv = kInvAngle[mode - 11];
        if (((n * angle) >> 5) < -1)
          for (int x = (n * angle) >> 5; x <= -1; x++) r[x] = side((x * inv + 128) >> 8);
      } else {
        for (int x = n + 1; x <= 2 * n; x++) r[x] = main_(x);
      }
      for (int y = 0; y < n; y++) {
        int idx = ((y + 1) * angle) >> 5, fact = ((y + 1) * angle) & 31;
        for (int x = 0; x < n; x++) {
          int v = fact ? ((32 - fact) * r[x + idx + 1] + fact * r[x + idx + 2] + 16) >> 5
                       : r[x + idx + 1];
          if (vertical) dst[y * stride + x] = (uint8_t)v;
          else dst[x * stride + y] = (uint8_t)v;
        }
      }
      if (c == 0 && n < 32) {
        if (mode == 26)
          for (int y = 0; y < n; y++) dst[y * stride] = clip1(top(0) + ((left(y) - p[2 * n]) >> 1));
        else if (mode == 10)
          for (int x = 0; x < n; x++) dst[x] = clip1(left(0) + ((top(x) - p[2 * n]) >> 1));
      }
    }
  }

  // ------------------------------------------------ inter prediction

  const MvField& mvf(int x, int y) const { return cur->motion[(size_t)(y >> 2) * w4 + (x >> 2)]; }

  // prediction block availability (6.4.2)
  bool pu_avail(int xCb, int yCb, int nCbS, int xPb, int yPb, int w, int h, int part_idx, int xN,
                int yN) const {
    bool same_cb = xCb <= xN && yCb <= yN && xCb + nCbS > xN && yCb + nCbS > yN;
    bool a;
    if (!same_cb)
      a = avail(xPb, yPb, xN, yN);
    else
      a = !((w << 1) == nCbS && (h << 1) == nCbS && part_idx == 1 && yCb + h <= yN && xCb + w > xN);
    return a && pred_mode[idx4(xN, yN)] == 2;
  }

  static Mv scale_mv(Mv mv, int td, int tb) {
    td = clip3(-128, 127, td);
    tb = clip3(-128, 127, tb);
    if (td == 0) return mv;
    int tx = (16384 + (std::abs(td) >> 1)) / td;
    int dsf = clip3(-4096, 4095, (tb * tx + 32) >> 6);
    auto s = [&](int v) {
      int p = dsf * v;
      return (int16_t)clip3(-32768, 32767, (p >= 0 ? 1 : -1) * ((std::abs(p) + 127) >> 8));
    };
    Mv out;
    out.x = s(mv.x);
    out.y = s(mv.y);
    return out;
  }

  // the collocated motion vector (8.5.3.2.9) at (x, y), rounded to 16
  bool col_mv(int x, int y, int X, int ref_idx, Mv& out) const {
    const MvField& c = col_pic->motion[(size_t)(y >> 2) * w4 + (x >> 2)];
    if (!c.pred) return false;
    int l = !(c.pred & 1) ? 1 : c.pred == 1 ? 0 : no_backward_pred ? X : sh.collocated_from_l0;
    int col_diff = col_pic->poc - c.poc[l], cur_diff = cur->poc - rpl_poc[X][ref_idx];
    out = col_diff == cur_diff ? c.mv[l] : scale_mv(c.mv[l], col_diff, cur_diff);
    return true;
  }

  bool temporal(int xPb, int yPb, int w, int h, int X, int ref_idx, Mv& out) {
    if (!col_pic) return false;
    int xBr = xPb + w, yBr = yPb + h;
    if ((yPb >> log2_ctb) == (yBr >> log2_ctb) && yBr < height && xBr < width &&
        col_mv((xBr >> 4) << 4, (yBr >> 4) << 4, X, ref_idx, out))
      return true;
    int xC = xPb + (w >> 1), yC = yPb + (h >> 1);
    return col_mv((xC >> 4) << 4, (yC >> 4) << 4, X, ref_idx, out);
  }

  MvField merge_candidate(int xCb, int yCb, int nCbS, int xPb, int yPb, int w, int h, int part_idx,
                          int merge_idx) {
    int orig = w + h;
    if (pps->log2_par_mrg_level > 2 && nCbS == 8) {
      xPb = xCb;
      yPb = yCb;
      w = h = nCbS;
      part_idx = 0;
    }
    int lv = pps->log2_par_mrg_level, part = cu_part;
    auto par = [&](int xN, int yN) { return (xPb >> lv) == (xN >> lv) && (yPb >> lv) == (yN >> lv); };
    auto av = [&](int xN, int yN) {
      return !par(xN, yN) && pu_avail(xCb, yCb, nCbS, xPb, yPb, w, h, part_idx, xN, yN);
    };
    MvField cand[6];
    int count = 0;
    int xA1 = xPb - 1, yA1 = yPb + h - 1, xB1 = xPb + w - 1, yB1 = yPb - 1;
    bool a1 = av(xA1, yA1) &&
              !(part_idx == 1 && (part == PART_Nx2N || part == PART_nLx2N || part == PART_nRx2N));
    if (a1) cand[count++] = mvf(xA1, yA1);
    bool b1 = av(xB1, yB1) &&
              !(part_idx == 1 && (part == PART_2NxN || part == PART_2NxnU || part == PART_2NxnD));
    if (b1 && !(a1 && same_motion(mvf(xA1, yA1), mvf(xB1, yB1)))) cand[count++] = mvf(xB1, yB1);
    bool b0 = av(xPb + w, yPb - 1);
    if (b0 && !(b1 && same_motion(mvf(xB1, yB1), mvf(xPb + w, yPb - 1))))
      cand[count++] = mvf(xPb + w, yPb - 1);
    bool a0 = av(xPb - 1, yPb + h);
    if (a0 && !(a1 && same_motion(mvf(xA1, yA1), mvf(xPb - 1, yPb + h))))
      cand[count++] = mvf(xPb - 1, yPb + h);
    bool b2 = av(xPb - 1, yPb - 1);
    if (b2 && !(a1 && same_motion(mvf(xA1, yA1), mvf(xPb - 1, yPb - 1))) &&
        !(b1 && same_motion(mvf(xB1, yB1), mvf(xPb - 1, yPb - 1))) && count != 4)
      cand[count++] = mvf(xPb - 1, yPb - 1);
    if (sh.temporal_mvp && count < sh.max_merge) {
      MvField t;
      Mv m0, m1;
      bool t0 = temporal(xPb, yPb, w, h, 0, 0, m0);
      bool t1 = sh.type == B_SLICE && temporal(xPb, yPb, w, h, 1, 0, m1);
      if (t0 || t1) {
        t.pred = (uint8_t)(t0 | t1 << 1);
        if (t0) { t.mv[0] = m0; t.ref[0] = 0; }
        if (t1) { t.mv[1] = m1; t.ref[1] = 0; }
        cand[count++] = t;
        stats[TMVP_CANDS] += merge_idx == count - 1;
      }
    }
    int orig_count = count;
    if (sh.type == B_SLICE && orig_count > 1 && orig_count < sh.max_merge) {
      static const int kL0[12] = {0, 1, 0, 2, 1, 2, 0, 3, 1, 3, 2, 3};
      static const int kL1[12] = {1, 0, 2, 0, 2, 1, 3, 0, 3, 1, 3, 2};
      for (int k = 0; k < orig_count * (orig_count - 1) && count < sh.max_merge; k++) {
        const MvField &l0 = cand[kL0[k]], &l1 = cand[kL1[k]];
        if ((l0.pred & 1) && (l1.pred & 2) &&
            (rpl_poc[0][l0.ref[0]] != rpl_poc[1][l1.ref[1]] || l0.mv[0] != l1.mv[1])) {
          MvField c;
          c.pred = 3;
          c.ref[0] = l0.ref[0];
          c.mv[0] = l0.mv[0];
          c.ref[1] = l1.ref[1];
          c.mv[1] = l1.mv[1];
          stats[COMBINED_CANDS] += merge_idx == count;
          cand[count++] = c;
        }
      }
    }
    int num_ref = sh.type == P_SLICE ? sh.num_ref_idx[0] : std::min(sh.num_ref_idx[0], sh.num_ref_idx[1]);
    for (int zero = 0; count < sh.max_merge; zero++) {
      MvField z;
      int r = zero < num_ref ? zero : 0;
      z.pred = sh.type == P_SLICE ? 1 : 3;
      z.ref[0] = (int8_t)r;
      if (sh.type == B_SLICE) z.ref[1] = (int8_t)r;
      stats[ZERO_CANDS] += merge_idx == count;
      cand[count++] = z;
    }
    MvField f = cand[merge_idx];
    if (f.pred == 3 && orig == 12) {
      f.pred = 1;
      f.ref[1] = -1;
      f.mv[1] = Mv();
    }
    return f;
  }

  Mv amvp(int xCb, int yCb, int nCbS, int xPb, int yPb, int w, int h, int part_idx, int X,
          int ref_idx, int flag) {
    int Y = 1 - X, target = rpl_poc[X][ref_idx], poc = cur->poc;
    auto av = [&](int xN, int yN) { return pu_avail(xCb, yCb, nCbS, xPb, yPb, w, h, part_idx, xN, yN); };
    // the first pass: a neighbour of the target picture in either list
    auto same = [&](const MvField& f, Mv& out) {
      if ((f.pred >> X & 1) && rpl_poc[X][f.ref[X]] == target) { out = f.mv[X]; return true; }
      if ((f.pred >> Y & 1) && rpl_poc[Y][f.ref[Y]] == target) { out = f.mv[Y]; return true; }
      return false;
    };
    // the second: any neighbour, scaled by its POC distance
    auto scaled = [&](const MvField& f, Mv& out) {
      int l = (f.pred >> X & 1) ? X : (f.pred >> Y & 1) ? Y : -1;
      if (l < 0) return false;
      int ref = rpl_poc[l][f.ref[l]];
      out = ref == target ? f.mv[l] : scale_mv(f.mv[l], poc - ref, poc - target);
      return true;
    };
    int ax[2] = {xPb - 1, xPb - 1}, ay[2] = {yPb + h, yPb + h - 1};
    bool aa[2] = {av(ax[0], ay[0]), av(ax[1], ay[1])};
    bool is_scaled = aa[0] || aa[1];
    bool have_a = false, have_b = false;
    Mv a, b;
    for (int k = 0; k < 2 && !have_a; k++) have_a = aa[k] && same(mvf(ax[k], ay[k]), a);
    for (int k = 0; k < 2 && !have_a; k++) have_a = aa[k] && scaled(mvf(ax[k], ay[k]), a);
    int bx[3] = {xPb + w, xPb + w - 1, xPb - 1}, by[3] = {yPb - 1, yPb - 1, yPb - 1};
    bool ab[3] = {av(bx[0], by[0]), av(bx[1], by[1]), av(bx[2], by[2])};
    for (int k = 0; k < 3 && !have_b; k++) have_b = ab[k] && same(mvf(bx[k], by[k]), b);
    if (!is_scaled && have_b) {
      have_a = true;
      a = b;
    }
    if (!is_scaled) {
      have_b = false;
      for (int k = 0; k < 3 && !have_b; k++) have_b = ab[k] && scaled(mvf(bx[k], by[k]), b);
    }
    Mv list[2];
    int n = 0;
    if (have_a) list[n++] = a;
    if (have_b && !(have_a && a == b)) list[n++] = b;
    if (n < 2 && sh.temporal_mvp) {
      Mv t;
      if (temporal(xPb, yPb, w, h, X, ref_idx, t)) list[n++] = t;
    }
    while (n < 2) list[n++] = Mv();
    return list[flag];
  }

  int ref_idx(int l) {
    int max = sh.num_ref_idx[l] - 1;
    if (max <= 0) return 0;
    int i = 0;
    while (i < std::min(max, 2) && dec(C_REF_IDX + i)) i++;
    if (i == 2)
      while (i < max && byp()) i++;
    return i;
  }

  int eg1() {
    int k = 1, v = 0;
    while (byp()) {
      v += 1 << k;
      if (++k > 15) fail("an abs_mvd_minus2 out of range");
    }
    return v + bypass_bits(k);
  }

  Mv mvd_coding() {
    int g0x = dec(C_MVD_G0), g0y = dec(C_MVD_G0);
    int g1x = g0x ? dec(C_MVD_G1) : 0, g1y = g0y ? dec(C_MVD_G1) : 0;
    int x = 0, y = 0;
    if (g0x) {
      x = g1x ? 2 + eg1() : 1;
      if (byp()) x = -x;
    }
    if (g0y) {
      y = g1y ? 2 + eg1() : 1;
      if (byp()) y = -y;
    }
    if (x > 32767 || x < -32768 || y > 32767 || y < -32768) fail("an mvd out of range");
    Mv m;
    m.x = (int16_t)x;
    m.y = (int16_t)y;
    return m;
  }

  // prediction_unit (7.3.8.6) and its motion; whether it merged
  bool prediction_unit(int xCb, int yCb, int nCbS, int xPb, int yPb, int w, int h, int part_idx,
                       bool skip) {
    MvField f;
    bool merge = skip || dec(C_MERGE_FLAG);
    if (merge) {
      int idx = 0;
      if (sh.max_merge > 1 && dec(C_MERGE_IDX)) {
        idx = 1;
        while (idx < sh.max_merge - 1 && byp()) idx++;
      }
      f = merge_candidate(xCb, yCb, nCbS, xPb, yPb, w, h, part_idx, idx);
      stats[MERGE_PUS]++;
    } else {
      int ipi = 0;  // 0: L0, 1: L1, 2: bi
      if (sh.type == B_SLICE) {
        if (w + h != 12 && dec(C_INTER_PRED + cu_depth)) ipi = 2;
        else ipi = dec(C_INTER_PRED + 4);
      }
      int ref[2] = {-1, -1}, flag[2] = {0, 0};
      Mv mvd[2];
      if (ipi != 1) {
        ref[0] = ref_idx(0);
        mvd[0] = mvd_coding();
        flag[0] = dec(C_MVP_FLAG);
      }
      if (ipi != 0) {
        ref[1] = ref_idx(1);
        if (!(sh.mvd_l1_zero && ipi == 2)) mvd[1] = mvd_coding();
        flag[1] = dec(C_MVP_FLAG);
      }
      for (int X = 0; X < 2; X++) {
        if (ref[X] < 0) continue;
        Mv p = amvp(xCb, yCb, nCbS, xPb, yPb, w, h, part_idx, X, ref[X], flag[X]);
        f.mv[X].x = (int16_t)(uint16_t)(p.x + mvd[X].x);
        f.mv[X].y = (int16_t)(uint16_t)(p.y + mvd[X].y);
        f.ref[X] = (int8_t)ref[X];
        f.pred |= (uint8_t)(1 << X);
      }
      stats[AMVP_PUS]++;
    }
    for (int l = 0; l < 2; l++) {
      if (!(f.pred >> l & 1)) continue;
      if (f.ref[l] < 0 || f.ref[l] >= sh.num_ref_idx[l]) fail("a reference index out of range");
      f.poc[l] = rpl_poc[l][f.ref[l]];
    }
    stats[BI_PUS] += f.pred == 3;
    fill4<MvField>(cur->motion, xPb, yPb, w, h, f);
    motion_compensate(f, xPb, yPb, w, h);
    return merge;
  }

  // 8-tap luma and 4-tap chroma interpolation (8.5.3.3.3) of a w x h block
  // at (x, y) moved by mv (in 1/(1 << frac_bits) samples), to 14 bits
  static void interpolate(const uint8_t* plane, int pw, int ph, int x, int y, int w, int h, int mvx,
                          int mvy, int taps, int frac_bits, int16_t* dst) {
    int fx = mvx & ((1 << frac_bits) - 1), fy = mvy & ((1 << frac_bits) - 1);
    int half = taps / 2 - 1;
    int x0 = x + (mvx >> frac_bits) - half, y0 = y + (mvy >> frac_bits) - half;
    int sw = w + taps - 1, shh = h + taps - 1;
    uint8_t buf[(64 + 7) * (64 + 7)];
    const uint8_t* src;
    int ss;
    if (x0 >= 0 && y0 >= 0 && x0 + sw <= pw && y0 + shh <= ph) {
      src = plane + (size_t)y0 * pw + x0;
      ss = pw;
    } else {
      for (int r = 0; r < shh; r++) {
        const uint8_t* row = plane + (size_t)clip3(0, ph - 1, y0 + r) * pw;
        for (int c = 0; c < sw; c++) buf[r * sw + c] = row[clip3(0, pw - 1, x0 + c)];
      }
      src = buf;
      ss = sw;
    }
    const int8_t* hf = taps == 8 ? kLumaFilter[fx] : kChromaFilter[fx];
    const int8_t* vf = taps == 8 ? kLumaFilter[fy] : kChromaFilter[fy];
    if (!fx && !fy) {
      for (int r = 0; r < h; r++)
        for (int c = 0; c < w; c++) dst[r * w + c] = (int16_t)(src[(r + half) * ss + c + half] << 6);
    } else if (!fy) {
      for (int r = 0; r < h; r++)
        for (int c = 0; c < w; c++) {
          const uint8_t* s = src + (r + half) * ss + c;
          int v = 0;
          for (int i = 0; i < taps; i++) v += hf[i] * s[i];
          dst[r * w + c] = (int16_t)v;
        }
    } else if (!fx) {
      for (int r = 0; r < h; r++)
        for (int c = 0; c < w; c++) {
          const uint8_t* s = src + r * ss + c + half;
          int v = 0;
          for (int i = 0; i < taps; i++) v += vf[i] * s[i * ss];
          dst[r * w + c] = (int16_t)v;
        }
    } else {
      int16_t tmp[(64 + 7) * 64];
      for (int r = 0; r < shh; r++)
        for (int c = 0; c < w; c++) {
          const uint8_t* s = src + r * ss + c;
          int v = 0;
          for (int i = 0; i < taps; i++) v += hf[i] * s[i];
          tmp[r * w + c] = (int16_t)v;
        }
      for (int r = 0; r < h; r++)
        for (int c = 0; c < w; c++) {
          int v = 0;
          for (int i = 0; i < taps; i++) v += vf[i] * tmp[(r + i) * w + c];
          dst[r * w + c] = (int16_t)(v >> 6);
        }
    }
  }

  int16_t pred_buf[2][64 * 64];

  void motion_compensate(const MvField& f, int xPb, int yPb, int w, int h) {
    bool explicit_w = sh.weighted;
    stats[EXPLICIT_WEIGHTED] += explicit_w;
    for (int c = 0; c < 3; c++) {
      int s = c ? 1 : 0, pw = c ? cw : width, ph = c ? ch : height;
      int bw = w >> s, bh = h >> s, x = xPb >> s, y = yPb >> s;
      for (int l = 0; l < 2; l++) {
        if (!(f.pred >> l & 1)) continue;
        const Picture& ref = *rpl[l][f.ref[l]];
        interpolate(ref.plane[c].data(), pw, ph, x, y, bw, bh, f.mv[l].x, f.mv[l].y, c ? 4 : 8,
                    c ? 3 : 2, pred_buf[l]);
      }
      uint8_t* dst = cur->plane[c].data() + (size_t)y * pw + x;
      if (f.pred == 3) {
        const int16_t *p0 = pred_buf[0], *p1 = pred_buf[1];
        if (!explicit_w) {
          for (int r = 0; r < bh; r++)
            for (int k = 0; k < bw; k++) dst[r * pw + k] = clip1((p0[r * bw + k] + p1[r * bw + k] + 64) >> 7);
        } else {
          int denom = (c ? sh.chroma_denom : sh.luma_denom) + 6;
          int w0 = sh.weight[0][f.ref[0]][c], w1 = sh.weight[1][f.ref[1]][c];
          int o = (sh.offset[0][f.ref[0]][c] + sh.offset[1][f.ref[1]][c] + 1) * (1 << denom);
          for (int r = 0; r < bh; r++)
            for (int k = 0; k < bw; k++)
              dst[r * pw + k] = clip1((p0[r * bw + k] * w0 + p1[r * bw + k] * w1 + o) >> (denom + 1));
        }
      } else {
        int l = f.pred == 1 ? 0 : 1;
        const int16_t* p = pred_buf[l];
        if (!explicit_w) {
          for (int r = 0; r < bh; r++)
            for (int k = 0; k < bw; k++) dst[r * pw + k] = clip1((p[r * bw + k] + 32) >> 6);
        } else {
          int denom = (c ? sh.chroma_denom : sh.luma_denom) + 6;
          int wt = sh.weight[l][f.ref[l]][c], o = sh.offset[l][f.ref[l]][c];
          int round = 1 << (denom - 1);
          for (int r = 0; r < bh; r++)
            for (int k = 0; k < bw; k++)
              dst[r * pw + k] = clip1(((p[r * bw + k] * wt + round) >> denom) + o);
        }
      }
    }
  }

  // ------------------------------------------------ in-loop filters

  // bS of an edge between two inter blocks by their motion (8.7.2.4)
  static int bs_motion(const MvField& p, const MvField& q) {
    auto far = [](Mv a, Mv b) { return std::abs(a.x - b.x) >= 4 || std::abs(a.y - b.y) >= 4; };
    if (p.pred == 3 && q.pred == 3) {
      int p0 = p.poc[0], p1 = p.poc[1], q0 = q.poc[0], q1 = q.poc[1];
      if (q0 == p0 && q0 == q1 && p0 == p1)
        return (far(p.mv[0], q.mv[0]) || far(p.mv[1], q.mv[1])) &&
               (far(p.mv[1], q.mv[0]) || far(p.mv[0], q.mv[1]));
      if (p0 == q0 && p1 == q1) return far(p.mv[0], q.mv[0]) || far(p.mv[1], q.mv[1]);
      if (p1 == q0 && p0 == q1) return far(p.mv[1], q.mv[0]) || far(p.mv[0], q.mv[1]);
      return 1;
    }
    if (p.pred != 3 && q.pred != 3) {
      int lp = p.pred & 1 ? 0 : 1, lq = q.pred & 1 ? 0 : 1;
      if (p.poc[lp] != q.poc[lq]) return 1;
      return far(p.mv[lp], q.mv[lq]);
    }
    return 1;
  }

  int bs_of(int xp, int yp, int xq, int yq) const {
    int ip = idx4(xp, yp), iq = idx4(xq, yq);
    if (pred_mode[ip] == 1 || pred_mode[iq] == 1) return 2;
    if (cbf_map[ip] || cbf_map[iq]) return 1;
    return bs_motion(mvf(xp, yp), mvf(xq, yq));
  }

  // the bS of a transform (or coding) block's top and left edges and of the
  // prediction block edges inside it, as FFmpeg derives them
  void edges(int x0, int y0, int log2) {
    int n = 1 << log2, m = ctb_size - 1;
    if (y0 > 0 && (y0 & 7) == 0) {
      bool skip = (y0 & m) == 0 && !sh.lf_across_slices &&
                  ctb_slice[((y0 - 1) >> log2_ctb) * ctb_w + (x0 >> log2_ctb)] != slice_addr;
      if (!skip)
        for (int i = 0; i < n; i += 4) bs_h[idx4(x0 + i, y0)] = (uint8_t)bs_of(x0 + i, y0 - 1, x0 + i, y0);
    }
    if (x0 > 0 && (x0 & 7) == 0) {
      bool skip = (x0 & m) == 0 && !sh.lf_across_slices &&
                  ctb_slice[(y0 >> log2_ctb) * ctb_w + ((x0 - 1) >> log2_ctb)] != slice_addr;
      if (!skip)
        for (int j = 0; j < n; j += 4) bs_v[idx4(x0, y0 + j)] = (uint8_t)bs_of(x0 - 1, y0 + j, x0, y0 + j);
    }
    if (!cu_intra && log2 > 3) {
      for (int j = 8; j < n; j += 8)
        for (int i = 0; i < n; i += 4)
          bs_h[idx4(x0 + i, y0 + j)] = (uint8_t)bs_motion(mvf(x0 + i, y0 + j - 1), mvf(x0 + i, y0 + j));
      for (int i = 8; i < n; i += 8)
        for (int j = 0; j < n; j += 4)
          bs_v[idx4(x0 + i, y0 + j)] = (uint8_t)bs_motion(mvf(x0 + i - 1, y0 + j), mvf(x0 + i, y0 + j));
    }
  }

  const SliceHeader& slice_at(int x, int y) const {
    return slices[ctb_header[(y >> log2_ctb) * ctb_w + (x >> log2_ctb)]];
  }

  // one luma edge segment of 4 lines: pix points at q0 of the first line,
  // xs steps across the edge, ls along it
  void filter_luma(uint8_t* pix, int xs, int ls, int bs, int qp, const SliceHeader& s, bool no_p,
                   bool no_q) {
    int beta = kBeta[clip3(0, 51, qp + s.beta_offset)];
    int tc = kTc[clip3(0, 53, qp + 2 * (bs - 1) + s.tc_offset)];
    auto P = [&](int line, int i) -> int { return pix[line * ls - (i + 1) * xs]; };
    auto Q = [&](int line, int i) -> int { return pix[line * ls + i * xs]; };
    int dp0 = std::abs(P(0, 2) - 2 * P(0, 1) + P(0, 0)), dp3 = std::abs(P(3, 2) - 2 * P(3, 1) + P(3, 0));
    int dq0 = std::abs(Q(0, 2) - 2 * Q(0, 1) + Q(0, 0)), dq3 = std::abs(Q(3, 2) - 2 * Q(3, 1) + Q(3, 0));
    int dpq0 = dp0 + dq0, dpq3 = dp3 + dq3, dp = dp0 + dp3, dq = dq0 + dq3;
    if (dpq0 + dpq3 >= beta) return;
    auto sam = [&](int line, int dpq) {
      return 2 * dpq < (beta >> 2) &&
             std::abs(P(line, 3) - P(line, 0)) + std::abs(Q(line, 0) - Q(line, 3)) < (beta >> 3) &&
             std::abs(P(line, 0) - Q(line, 0)) < ((5 * tc + 1) >> 1);
    };
    bool strong = sam(0, dpq0) && sam(3, dpq3);
    bool dEp = dp < ((beta + (beta >> 1)) >> 3), dEq = dq < ((beta + (beta >> 1)) >> 3);
    for (int k = 0; k < 4; k++) {
      uint8_t* q = pix + k * ls;
      int p0 = q[-xs], p1 = q[-2 * xs], p2 = q[-3 * xs], p3 = q[-4 * xs];
      int q0 = q[0], q1 = q[xs], q2 = q[2 * xs], q3 = q[3 * xs];
      if (strong) {
        int t = 2 * tc;
        if (!no_p) {
          q[-xs] = (uint8_t)clip3(p0 - t, p0 + t, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3);
          q[-2 * xs] = (uint8_t)clip3(p1 - t, p1 + t, (p2 + p1 + p0 + q0 + 2) >> 2);
          q[-3 * xs] = (uint8_t)clip3(p2 - t, p2 + t, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3);
        }
        if (!no_q) {
          q[0] = (uint8_t)clip3(q0 - t, q0 + t, (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3);
          q[xs] = (uint8_t)clip3(q1 - t, q1 + t, (p0 + q0 + q1 + q2 + 2) >> 2);
          q[2 * xs] = (uint8_t)clip3(q2 - t, q2 + t, (p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3);
        }
      } else {
        int delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4;
        if (std::abs(delta) >= tc * 10) continue;
        delta = clip3(-tc, tc, delta);
        if (!no_p) {
          q[-xs] = clip1(p0 + delta);
          if (dEp) q[-2 * xs] = clip1(p1 + clip3(-(tc >> 1), tc >> 1, (((p2 + p0 + 1) >> 1) - p1 + delta) >> 1));
        }
        if (!no_q) {
          q[0] = clip1(q0 - delta);
          if (dEq) q[xs] = clip1(q1 + clip3(-(tc >> 1), tc >> 1, (((q2 + q0 + 1) >> 1) - q1 - delta) >> 1));
        }
      }
    }
  }

  void filter_chroma(uint8_t* pix, int xs, int ls, int qp, int c, const SliceHeader& s, bool no_p,
                     bool no_q) {
    int qpi = clip3(0, 57, qp + (c == 1 ? pps->cb_qp_offset : pps->cr_qp_offset));
    int qpc = qpi < 30 ? qpi : qpi > 43 ? qpi - 6 : kQpC[qpi - 30];
    int tc = kTc[clip3(0, 53, qpc + 2 + s.tc_offset)];
    if (!tc) return;
    for (int k = 0; k < 4; k++) {
      uint8_t* q = pix + k * ls;
      int p0 = q[-xs], p1 = q[-2 * xs], q0 = q[0], q1 = q[xs];
      int delta = clip3(-tc, tc, (((q0 - p0) * 4 + p1 - q1 + 4) >> 3));
      if (!no_p) q[-xs] = clip1(p0 + delta);
      if (!no_q) q[0] = clip1(q0 - delta);
    }
  }

  // 8.7.2: every vertical edge of the picture, then every horizontal one
  void deblock() {
    uint8_t* Y = cur->plane[0].data();
    for (int dir = 0; dir < 2; dir++) {
      const std::vector<uint8_t>& bs = dir == 0 ? bs_v : bs_h;
      for (int y = dir ? 8 : 0; y < height; y += dir ? 8 : 4)
        for (int x = dir ? 0 : 8; x < width; x += dir ? 4 : 8) {
          int b = bs[idx4(x, y)];
          if (!b) continue;
          stats[b == 2 ? BS2_EDGES : BS1_EDGES]++;
          int xp = dir ? x : x - 1, yp = dir ? y - 1 : y;
          int qp = (qp_map[idx4(xp, yp)] + qp_map[idx4(x, y)] + 1) >> 1;
          filter_luma(Y + (size_t)y * width + x, dir ? width : 1, dir ? 1 : width, b, qp, slice_at(x, y),
                      bypass_map[idx4(xp, yp)], bypass_map[idx4(x, y)]);
        }
      // chroma: edges on the 8x8 chroma grid, bS 2, 4 lines of 8 luma ones
      for (int y = dir ? 16 : 0; y < height; y += dir ? 16 : 8)
        for (int x = dir ? 0 : 16; x < width; x += dir ? 8 : 16) {
          if (bs[idx4(x, y)] != 2) continue;
          int xp = dir ? x : x - 1, yp = dir ? y - 1 : y;
          int qp = (qp_map[idx4(xp, yp)] + qp_map[idx4(x, y)] + 1) >> 1;
          for (int c = 1; c < 3; c++)
            filter_chroma(cur->plane[c].data() + (size_t)(y / 2) * cw + x / 2, dir ? cw : 1, dir ? 1 : cw,
                          qp, c, slice_at(x, y), bypass_map[idx4(xp, yp)], bypass_map[idx4(x, y)]);
        }
    }
  }

  // 8.7.3: SAO of every CTB from the deblocked picture
  void apply_sao() {
    bool any = false;
    for (auto& s : sao) any = any || s.type[0] || s.type[1] || s.type[2];
    if (!any) return;
    static const int kEo[4][2][2] = {{{-1, 0}, {1, 0}}, {{0, -1}, {0, 1}}, {{-1, -1}, {1, 1}}, {{1, -1}, {-1, 1}}};
    for (int c = 0; c < 3; c++) {
      int sft = c ? 1 : 0, pw = c ? cw : width, ph = c ? ch : height;
      scratch[c] = cur->plane[c];
      const uint8_t* src = scratch[c].data();
      uint8_t* dst = cur->plane[c].data();
      int size = ctb_size >> sft;
      for (int ctb = 0; ctb < ctb_w * ctb_h; ctb++) {
        const SaoParams& s = sao[ctb];
        int type = s.type[c];
        if (!type) continue;
        int x0 = (ctb % ctb_w) * size, y0 = (ctb / ctb_w) * size;
        int x1 = std::min(x0 + size, pw), y1 = std::min(y0 + size, ph);
        const SliceHeader& cur_slice = slices[ctb_header[ctb]];
        int band_table[32] = {};
        for (int k = 0; k < 4; k++) band_table[(k + s.band[c]) & 31] = k + 1;
        for (int y = y0; y < y1; y++)
          for (int x = x0; x < x1; x++) {
            if (bypass_map[idx4(x << sft, y << sft)]) continue;
            int v = src[(size_t)y * pw + x], k;
            if (type == 1) {
              k = band_table[v >> 3];
            } else {
              const int(*e)[2] = kEo[s.eo_class[c]];
              int xa = x + e[0][0], ya = y + e[0][1], xb = x + e[1][0], yb = y + e[1][1];
              if (xa < 0 || ya < 0 || xb < 0 || yb < 0 || xa >= pw || xb >= pw || ya >= ph || yb >= ph)
                continue;
              if ((x == x0 || x == x1 - 1 || y == y0 || y == y1 - 1) &&
                  (!sao_across(ctb, cur_slice, xa << sft, ya << sft) || !sao_across(ctb, cur_slice, xb << sft, yb << sft)))
                continue;
              int a = src[(size_t)ya * pw + xa], b = src[(size_t)yb * pw + xb];
              int edge = 2 + (v > a) - (v < a) + (v > b) - (v < b);
              k = edge == 2 ? 0 : edge < 2 ? edge + 1 : edge;
            }
            if (k) dst[(size_t)y * pw + x] = clip1(v + s.offset[c][k]);
          }
      }
    }
  }

  // whether SAO at a sample of CTB ctb may read the sample at luma (x, y)
  // of another slice: the flag of whichever slice comes later decides
  bool sao_across(int ctb, const SliceHeader& cur_slice, int x, int y) const {
    int other = (y >> log2_ctb) * ctb_w + (x >> log2_ctb);
    if (other == ctb || ctb_slice[other] == ctb_slice[ctb]) return true;
    if (ctb_slice[other] < ctb_slice[ctb]) return cur_slice.lf_across_slices;
    return slices[ctb_header[other]].lf_across_slices;
  }

  void finish_picture() {
    if (ctbs_decoded != ctb_w * ctb_h)
      fail("a picture of " + std::to_string(ctbs_decoded) + " of " + std::to_string(ctb_w * ctb_h) + " CTBs");
    deblock();
    apply_sao();
    cur->reference = true;
    cur->packet = packets - 1;
    dpb.push_back(cur);
    bump((size_t)active.num_reorder, (size_t)active.max_dec_pic_buffering);
    cur.reset();
  }

  // ------------------------------------------------ NAL units

  void nal(const uint8_t* d, size_t n, bool in_config) {
    if (n < 2) fail("an HEVC NAL unit shorter than its header");
    if (d[0] & 0x80) fail("a NAL unit with forbidden_zero_bit set");
    int type = d[0] >> 1 & 63, layer = (d[0] & 1) << 5 | d[1] >> 3, tid = (d[1] & 7) - 1;
    if (tid < 0) fail("a NAL unit of nuh_temporal_id_plus1 0");
    if (layer > 0) unsupported("a NAL unit of nuh_layer_id " + std::to_string(layer) + " (a layer above 0)");
    bool vcl = type <= RASL_R || (type >= BLA_W_LP && type <= CRA_NUT);
    if (in_config && vcl) fail("a slice in the hvcC box");
    if (type == AUD_NUT || type == FD_NUT || (type > CRA_NUT && type < VPS_NUT) || type > SEI_SUFFIX ||
        (type > RASL_R && type < BLA_W_LP))
      return;
    if (type == EOS_NUT || type == EOB_NUT) {
      after_eos = true;
      max_ra = 0x7fffffff;
      return;
    }
    std::vector<uint8_t> r = unescape(d + 2, n - 2);
    switch (type) {
      case VPS_NUT: parse_vps(r); break;
      case SPS_NUT: parse_sps(r); break;
      case PPS_NUT: parse_pps(r); break;
      case SEI_PREFIX: case SEI_SUFFIX: parse_sei(r); break;
      default: slice(r, type, tid);
    }
  }

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
      for (auto& x : nals)
        while (x.second > 0 && x.first[x.second - 1] == 0) x.second--;
    }
    cur.reset();
    cur_skipped = false;
    pictures_in_packet = 0;
    size_t before = ready.size();
    for (auto& x : nals)
      if (x.second) nal(x.first, x.second, false);
    if (cur) finish_picture();
    return (int)(ready.size() - before);
  }

  // hvcC: its NAL length size and the parameter sets and SEI it holds
  void config(const uint8_t* d, size_t n) {
    if (n < 23 || d[0] != 1) fail("an hvcC box that is not version 1");
    int len = (d[21] & 3) + 1;
    if (len == 3) fail("an hvcC NAL length size of 3");
    int arrays = d[22];
    size_t i = 23;
    for (int a = 0; a < arrays; a++) {
      if (i + 3 > n) fail("a truncated hvcC box");
      int count = d[i + 1] << 8 | d[i + 2];
      i += 3;
      for (int k = 0; k < count; k++) {
        if (i + 2 > n) fail("a truncated hvcC box");
        size_t sz = (size_t)d[i] << 8 | d[i + 1];
        i += 2;
        if (sz == 0 || i + sz > n) fail("a truncated hvcC box");
        nal(d + i, sz, true);
        i += sz;
      }
    }
    nal_length = len;
  }

  int crop_w() const { return width - active.crop_left - active.crop_right; }
  int crop_h() const { return height - active.crop_top - active.crop_bottom; }

  void output(uint8_t* rgb, uint8_t* luma) const {
    int w = crop_w(), h = crop_h();
    const uint8_t* Y = out->plane[0].data() + (size_t)active.crop_top * width + active.crop_left;
    size_t coff = (size_t)(active.crop_top / 2) * cw + active.crop_left / 2;
    if (luma)
      for (int r = 0; r < h; r++) memcpy(luma + (size_t)r * w, Y + (size_t)r * width, w);
    if (rgb) yuv::yuv420_to_rgb(Y, width, out->plane[1].data() + coff, out->plane[2].data() + coff, cw, w, h, rgb, *coeffs);
  }

  void planes(uint8_t* y, uint8_t* u, uint8_t* v) const {
    int w = crop_w(), h = crop_h(), cw2 = (w + 1) / 2, ch2 = (h + 1) / 2;
    for (int r = 0; r < h; r++)
      memcpy(y + (size_t)r * w, out->plane[0].data() + (size_t)(active.crop_top + r) * width + active.crop_left, w);
    for (int r = 0; r < ch2; r++) {
      size_t off = (size_t)(active.crop_top / 2 + r) * cw + active.crop_left / 2;
      memcpy(u + (size_t)r * cw2, out->plane[1].data() + off, cw2);
      memcpy(v + (size_t)r * cw2, out->plane[2].data() + off, cw2);
    }
  }
};

int report(const CodecError& e, char* err, size_t err_len) {
  if (err && err_len) snprintf(err, err_len, "%s", e.msg.c_str());
  return e.unsupported ? -2 : -1;
}

}  // namespace

extern "C" {

void* hevc_new() { return new Decoder(); }

void hevc_free(void* h) { delete static_cast<Decoder*>(h); }

// An MP4's hvcC: the NAL length size of the packets to come, and the
// parameter sets and SEI it holds. Without it, packets are Annex B.
int hevc_config(void* h, const uint8_t* data, size_t size, char* err, size_t err_len) {
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
// 1 or more: output is in POC order), each taken by hevc_next.
int hevc_decode(void* h, const uint8_t* data, size_t size, char* err, size_t err_len) {
  Decoder* d = static_cast<Decoder*>(h);
  try {
    return d->decode(data, size);
  } catch (const CodecError& e) {
    d->cur.reset();
    return report(e, err, err_len);
  } catch (const std::bad_alloc&) {
    d->cur.reset();
    return report(CodecError{"out of memory", false}, err, err_len);
  }
}

// The end of the stream: every picture still waiting is made ready; returns
// how many.
int hevc_flush(void* h, char* err, size_t err_len) {
  Decoder* d = static_cast<Decoder*>(h);
  try {
    size_t before = d->ready.size();
    d->bump(0, 0);
    return (int)(d->ready.size() - before);
  } catch (const CodecError& e) {
    return report(e, err, err_len);
  }
}

// Take the next frame ready for output (hevc_frame and hevc_planes read it);
// *packet is the hevc_decode call (0, 1, ...) whose access unit it is.
// Returns 1 when none is ready.
int hevc_next(void* h, int64_t* packet) {
  Decoder* d = static_cast<Decoder*>(h);
  if (d->ready.empty()) return 1;
  d->out = d->ready.front();
  d->ready.pop_front();
  *packet = d->out->packet;
  return 0;
}

// The output size (cropped), 0 x 0 before the first picture; the encoder's
// SEI user data, if any.
int hevc_info(void* h, int* height, int* width, char* encoder, size_t encoder_len) {
  const Decoder* d = static_cast<Decoder*>(h);
  *height = d->started ? d->crop_h() : 0;
  *width = d->started ? d->crop_w() : 0;
  if (encoder && encoder_len) snprintf(encoder, encoder_len, "%s", d->encoder.c_str());
  return 0;
}

// The counts of Decoder::stats, at most n of them; returns how many there are.
int hevc_stats(void* h, int64_t* out, int n) {
  const Decoder* d = static_cast<Decoder*>(h);
  for (int i = 0; i < std::min(n, (int)Decoder::N_STATS); i++) out[i] = d->stats[i];
  return Decoder::N_STATS;
}

// The frame taken last: uint8 RGB [H, W, 3] and luma [H, W] (either may be
// null); -1 before the first one.
int hevc_frame(void* h, uint8_t* rgb, uint8_t* luma, char* err, size_t err_len) {
  const Decoder* d = static_cast<Decoder*>(h);
  if (!d->out) return report(CodecError{"no decoded frame", false}, err, err_len);
  d->output(rgb, luma);
  return 0;
}

// The planes of the frame taken last: Y [H, W], U and V [(H + 1) / 2,
// (W + 1) / 2]; -1 before the first one.
int hevc_planes(void* h, uint8_t* y, uint8_t* u, uint8_t* v, char* err, size_t err_len) {
  const Decoder* d = static_cast<Decoder*>(h);
  if (!d->out) return report(CodecError{"no decoded frame", false}, err, err_len);
  d->planes(y, u, v);
  return 0;
}

}  // extern "C"
