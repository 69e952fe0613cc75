// Shared by the warp-cost kernels (tent_warp_fwd.cu, tent_warp_bwd.cu): the
// 16-byte channel loads and stores, the one-element path, and the four
// bilinear taps of a pixel. The forward and both backward halves compute the
// taps with this one function, so they agree on which taps a coordinate
// touches and with what weights.
//
// Layout: features [B*n_views, h, w, C] channel minor, coords [B*n_views, P, 2]
// fp32 (x, y) pixel coordinates, grid_sample semantics (bilinear, zeros
// padding, align_corners=True).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace tent_warp {

constexpr int kGroup = 16;            // threads per pixel
constexpr int kBlock = 256;           // threads per block

template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float* v) {
    float4 r = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
    uint4 r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = r;
  }
};

// One element at a time: the path for channel counts or pointers that do
// not allow 16-byte accesses.
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void put_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T> struct Scalar {
  static constexpr int N = 1;
  static __device__ __forceinline__ void load(const T* p, float* v) { v[0] = to_f32(p[0]); }
  static __device__ __forceinline__ void store(T* p, const float* v) { put_f32(p, v[0]); }
};

// The four taps of one pixel, in the plain version's order:
// t = 0..3 is (dy, dx) = (0,0), (0,1), (1,0), (1,1).
struct Taps {
  bool ok[4];       // tap inside the map
  float wt[4];      // fp32 bilinear weight
  int64_t off[4];   // element offset of the tap's feature row
  float wx, wy;     // fractional position inside the cell
};

// Coordinates are unbounded (the projection divides by z >= 1e-5), and
// converting a float beyond the int range is undefined in C++, so x and y
// are clamped to [-2, w + 1] and [-2, h + 1] before the floor. Every tap of
// a clamped coordinate lies outside the map, so no result changes: an
// out-of-view pixel samples 0 and gets a zero gradient. NaN coordinates
// clamp to the bound too. Weights are explicitly rounded fp32 products (no
// fused multiply-add), as the plain version computes them.
__device__ __forceinline__ Taps make_taps(float2 c, int64_t bn, int h, int w, int C) {
  Taps tp;
  const float x = fminf(fmaxf(c.x, -2.0f), (float)(w + 1));
  const float y = fminf(fmaxf(c.y, -2.0f), (float)(h + 1));
  const float x0f = floorf(x), y0f = floorf(y);
  tp.wx = __fsub_rn(x, x0f);
  tp.wy = __fsub_rn(y, y0f);
  const float ux = __fsub_rn(1.0f, tp.wx), uy = __fsub_rn(1.0f, tp.wy);
  const int x0 = (int)x0f, y0 = (int)y0f;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int dy = t >> 1, dx = t & 1;
    const int xi = x0 + dx, yi = y0 + dy;
    tp.ok[t] = xi >= 0 && xi <= w - 1 && yi >= 0 && yi <= h - 1;
    tp.wt[t] = __fmul_rn(dx ? tp.wx : ux, dy ? tp.wy : uy);
    tp.off[t] = ((bn * h + yi) * w + xi) * (int64_t)C;
  }
  return tp;
}

}  // namespace tent_warp
