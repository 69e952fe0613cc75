// The YUV 4:2:0 to RGB conversion that OpenCV's cv2.VideoCapture applies to
// a decoded frame (swscale's yuv420p -> bgr24 at the same size), shared by
// the port's video decoders (mpeg4_video.cpp, h264_video.cpp,
// hevc_video.cpp) and the MPEG-4 encoder's reconstruction. Plain C++17,
// header only.

#pragma once

#include <cstddef>
#include <cstdint>

namespace yuv {

// swscale's 16-bit fixed-point coefficients (its x86 tables) of a YUV
// matrix in limited range: luma, V to red, U to blue, U and V to green, and
// the luma offset (16 << 3).
struct Coeffs {
  int y, vr, ub, ug, vg;
  int yoff = 128;
};
constexpr Coeffs kBt601 = {9539, 13075, 16525, -3209, -6660};  // also unspecified
constexpr Coeffs kBt709 = {9539, 14686, 17305, -1747, -4366};
constexpr Coeffs kFcc = {9539, 13056, 16600, -3095, -6639};
constexpr Coeffs kSmpte240m = {9539, 14697, 17029, -2113, -4445};
constexpr Coeffs kBt2020 = {9539, 13752, 17545, -1535, -5328};
// the same matrices in full range (swscale scales the chroma terms by
// 224 / 255, leaves luma at unity and drops its offset), as OpenCV converts
// an HEVC frame whose VUI sets video_full_range_flag
constexpr Coeffs kBt601Full = {8192, 11485, 14516, -2819, -5850, 0};
constexpr Coeffs kBt709Full = {8192, 12901, 15201, -1534, -3835, 0};
constexpr Coeffs kFccFull = {8192, 11469, 14582, -2719, -5831, 0};
constexpr Coeffs kSmpte240mFull = {8192, 12911, 14959, -1856, -3904, 0};
constexpr Coeffs kBt2020Full = {8192, 12080, 15412, -1348, -4680, 0};

// Planes Y (stride ys) and U, V (stride cs, one sample a 2x2 luma block) to
// RGB [height, width, 3] as swscale converts yuv420p to bgr24 at the same
// size (its SSSE3 path: each term 16-bit fixed point), in RGB order; BT.601
// in limited range unless other coefficients are given.
inline void yuv420_to_rgb(const uint8_t* Y, int ys, const uint8_t* U, const uint8_t* V, int cs,
                          int width, int height, uint8_t* rgb, const Coeffs& k = kBt601) {
  auto clip8 = [](int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); };
  for (int r = 0; r < height; r++) {
    const uint8_t* y = Y + (size_t)r * ys;
    const uint8_t* u = U + (size_t)(r >> 1) * cs;
    const uint8_t* v = V + (size_t)(r >> 1) * cs;
    uint8_t* o = rgb + (size_t)r * width * 3;
    for (int c = 0; c < width; c++) {
      int cu = 8 * u[c >> 1] - 1024, cv = 8 * v[c >> 1] - 1024;
      int yy = ((8 * y[c] - k.yoff) * k.y) >> 16;
      int rr = (cv * k.vr) >> 16;
      int gg = ((cu * k.ug) >> 16) + ((cv * k.vg) >> 16);
      int bb = (cu * k.ub) >> 16;
      o[3 * c] = clip8(yy + rr);
      o[3 * c + 1] = clip8(yy + gg);
      o[3 * c + 2] = clip8(yy + bb);
    }
  }
}

}  // namespace yuv
