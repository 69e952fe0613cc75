// The tables of the port's HEVC decoder (csrc/hevc_video.cpp), from ITU-T
// H.265: the CABAC context initValues by initType (9.3.2.2, tables 9-5 to
// 9-37), the intra prediction angles (8.4.4.2.6), the interpolation
// filters (8.5.3.3.3), the deblocking tables (8.7.2.5.3), the chroma QP
// table of 4:2:0 (8.6.1) and the default scaling lists (7.4.5). The
// transform matrices and the scans are derived from their definitions in
// the decoder.
#pragma once

#include <cstdint>

namespace hevc {

// the first context of each syntax element in the decoder's context array
enum Ctx {
  C_SAO_MERGE = 0,        // sao_merge_left_flag, sao_merge_up_flag
  C_SAO_TYPE = 1,         // sao_type_idx_luma, sao_type_idx_chroma
  C_SPLIT_CU = 2,         // 3
  C_TQ_BYPASS = 5,
  C_SKIP = 6,             // 3
  C_QP_DELTA = 9,         // 2
  C_PRED_MODE = 11,
  C_PART_MODE = 12,       // 4
  C_PREV_INTRA = 16,
  C_CHROMA_MODE = 17,
  C_MERGE_FLAG = 18,
  C_MERGE_IDX = 19,
  C_INTER_PRED = 20,      // 5
  C_REF_IDX = 25,         // 2, both lists
  C_MVP_FLAG = 27,
  C_RQT_ROOT_CBF = 28,
  C_SPLIT_TU = 29,        // 3
  C_CBF_LUMA = 32,        // 2
  C_CBF_CHROMA = 34,      // 5
  C_MVD_G0 = 39,
  C_MVD_G1 = 40,
  C_TS = 41,              // 2: luma, chroma
  C_LAST_X = 43,          // 18
  C_LAST_Y = 61,          // 18
  C_CSBF = 79,            // 4
  C_SIG = 83,             // 42
  C_G1 = 125,             // 24
  C_G2 = 149,             // 6
  N_CTX = 155
};

// initValue of every context, by initType (0: I, 1 and 2: P and B as
// cabac_init_flag picks them)
constexpr uint8_t kCtxInit[3][N_CTX] = {
    {
        153,                                   // sao_merge
        200,                                   // sao_type_idx
        139, 141, 157,                         // split_cu_flag
        154,                                   // cu_transquant_bypass_flag
        154, 154, 154,                         // cu_skip_flag (not in I slices)
        154, 154,                              // cu_qp_delta_abs
        154,                                   // pred_mode_flag
        184, 154, 154, 154,                    // part_mode
        184,                                   // prev_intra_luma_pred_flag
        63,                                    // intra_chroma_pred_mode
        154, 154,                              // merge_flag, merge_idx
        154, 154, 154, 154, 154,               // inter_pred_idc
        154, 154,                              // ref_idx
        154, 154,                              // mvp_flag, rqt_root_cbf
        153, 138, 138,                         // split_transform_flag
        111, 141,                              // cbf_luma
        94, 138, 182, 154, 154,                // cbf_cb, cbf_cr
        154, 154,                              // abs_mvd_greater0/1_flag
        139, 139,                              // transform_skip_flag
        110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143, 127, 111, 79, 108, 123, 63,
        110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143, 127, 111, 79, 108, 123, 63,
        91, 171, 134, 141,                     // coded_sub_block_flag
        111, 111, 125, 110, 110, 94, 124, 108, 124, 107, 125, 141, 179, 153, 125, 107, 125, 141,
        179, 153, 125, 107, 125, 141, 179, 153, 125, 140, 139, 182, 182, 152, 136, 152, 136, 153,
        136, 139, 111, 136, 139, 111,          // sig_coeff_flag
        140, 92, 137, 138, 140, 152, 138, 139, 153, 74, 149, 92, 139, 107, 122, 152, 140, 179,
        166, 182, 140, 227, 122, 197,          // coeff_abs_level_greater1_flag
        138, 153, 136, 167, 152, 152,          // coeff_abs_level_greater2_flag
    },
    {
        153, 185, 107, 139, 126, 154, 197, 185, 201, 154, 154, 149, 154, 139, 154, 154, 154, 152,
        110, 122, 95, 79, 63, 31, 31, 153, 153, 168, 79, 124, 138, 94, 153, 111, 149, 107, 167,
        154, 154, 140, 198, 139, 139,
        125, 110, 94, 110, 95, 79, 125, 111, 110, 78, 110, 111, 111, 95, 94, 108, 123, 108,
        125, 110, 94, 110, 95, 79, 125, 111, 110, 78, 110, 111, 111, 95, 94, 108, 123, 108,
        121, 140, 61, 154,
        155, 154, 139, 153, 139, 123, 123, 63, 153, 166, 183, 140, 136, 153, 154, 166, 183, 140,
        136, 153, 154, 166, 183, 140, 136, 153, 154, 170, 153, 123, 123, 107, 121, 107, 121, 167,
        151, 183, 140, 151, 183, 140,
        154, 196, 196, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153, 121, 136, 137, 169, 194,
        166, 167, 154, 167, 137, 182,
        107, 167, 91, 122, 107, 167,
    },
    {
        153, 160, 107, 139, 126, 154, 197, 185, 201, 154, 154, 134, 154, 139, 154, 154, 183, 152,
        154, 137, 95, 79, 63, 31, 31, 153, 153, 168, 79, 224, 167, 122, 153, 111, 149, 92, 167,
        154, 154, 169, 198, 139, 139,
        125, 110, 124, 110, 95, 94, 125, 111, 111, 79, 125, 126, 111, 111, 79, 108, 123, 93,
        125, 110, 124, 110, 95, 94, 125, 111, 111, 79, 125, 126, 111, 111, 79, 108, 123, 93,
        121, 140, 61, 154,
        170, 154, 139, 153, 139, 123, 123, 63, 124, 166, 183, 140, 136, 153, 154, 166, 183, 140,
        136, 153, 154, 166, 183, 140, 136, 153, 154, 170, 153, 138, 138, 122, 121, 122, 121, 167,
        151, 183, 140, 151, 183, 140,
        154, 196, 167, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153, 121, 136, 122, 169, 208,
        166, 167, 154, 152, 167, 182,
        107, 167, 91, 107, 107, 167,
    },
};

// sigCtx of a 4x4 block by position (yC << 2) + xC (9.3.4.2.5)
constexpr uint8_t kSigCtx4x4[16] = {0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8};

// intraPredAngle by mode (2..34) and invAngle by mode (11..25)
constexpr int8_t kIntraAngle[35] = {0,   0,   32,  26,  21,  17,  13,  9,  5,  2,  0,  -2,
                                    -5,  -9,  -13, -17, -21, -26, -32, -26, -21, -17, -13, -9,
                                    -5,  -2,  0,   2,   5,   9,   13,  17,  21,  26,  32};
constexpr int16_t kInvAngle[15] = {-4096, -1638, -910, -630, -482, -390, -315, -256,
                                   -315,  -390,  -482, -630, -910, -1638, -4096};

// the luma (8-tap, by quarter) and chroma (4-tap, by eighth) filters
constexpr int8_t kLumaFilter[4][8] = {{0, 0, 0, 64, 0, 0, 0, 0},
                                      {-1, 4, -10, 58, 17, -5, 1, 0},
                                      {-1, 4, -11, 40, 40, -11, 4, -1},
                                      {0, 1, -5, 17, 58, -10, 4, -1}};
constexpr int8_t kChromaFilter[8][4] = {{0, 64, 0, 0},    {-2, 58, 10, -2}, {-4, 54, 16, -2},
                                        {-6, 46, 28, -4}, {-4, 36, 36, -4}, {-4, 28, 46, -6},
                                        {-2, 16, 54, -4}, {-2, 10, 58, -2}};

// beta' by Q (0..51) and tC' by Q (0..53)
constexpr uint8_t kBeta[52] = {0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,
                               0,  0,  0,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15,
                               16, 17, 18, 20, 22, 24, 26, 28, 30, 32, 34, 36, 38,
                               40, 42, 44, 46, 48, 50, 52, 54, 56, 58, 60, 62, 64};
constexpr uint8_t kTc[54] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2,  3,  3,  3,  3,  4,
                             4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 22, 24};

// QpC by qPi 30..43 under 4:2:0 (below, qPi; above, qPi - 6)
constexpr uint8_t kQpC[14] = {29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37};

constexpr uint8_t kLevelScale[6] = {40, 45, 51, 57, 64, 72};

// the default 8x8 scaling lists (Table 7-6), intra and inter, in the
// up-right diagonal scan of an 8x8 block
constexpr uint8_t kDefaultIntra8x8[64] = {
    16, 16, 16, 16, 16, 16, 16, 16, 16, 16, 17, 16, 17, 16, 17, 18, 17, 18, 18, 17, 18, 21,
    19, 20, 21, 20, 19, 21, 24, 22, 22, 24, 24, 22, 22, 24, 25, 25, 27, 30, 27, 25, 25, 29,
    31, 35, 35, 31, 29, 36, 41, 44, 41, 36, 47, 54, 54, 47, 65, 70, 65, 88, 88, 115};
constexpr uint8_t kDefaultInter8x8[64] = {
    16, 16, 16, 16, 16, 16, 16, 16, 16, 16, 17, 17, 17, 17, 17, 18, 18, 18, 18, 18, 18, 20,
    20, 20, 20, 20, 20, 20, 24, 24, 24, 24, 24, 24, 24, 24, 25, 25, 25, 25, 25, 25, 25, 28,
    28, 28, 28, 28, 28, 33, 33, 33, 33, 33, 41, 41, 41, 41, 54, 54, 54, 71, 71, 91};

// the magnitudes of the DCT's integer matrix (8.6.4.2) by angle j, in
// units of pi / 64: transMatrix[k][n] is +-kDctCos[j] for j the fold of
// (2n + 1) k mod 128 into 0..32 (row 0 is 64 throughout)
constexpr uint8_t kDctCos[33] = {64, 90, 90, 90, 89, 88, 87, 85, 83, 82, 80, 78, 75, 73, 70, 67, 64,
                                 61, 57, 54, 50, 46, 43, 38, 36, 31, 25, 22, 18, 13, 9,  4,  0};

constexpr int8_t kDst4[4][4] = {{29, 55, 74, 84}, {74, 74, 0, -74}, {84, -29, -74, 55},
                                {55, -84, 74, -29}};

}  // namespace hevc
