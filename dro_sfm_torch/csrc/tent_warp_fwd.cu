// Fused warp-subtract for the DRO feature-metric cost (kernel K1):
//
//   out[b, p, :] = f1[b / n_views, p, :] - bilinear(features[b], coords[b, p])
//
// with grid_sample semantics (bilinear, zeros padding, align_corners=True,
// pixel coordinates). f1 [B, P, C], features [B*n_views, h, w, C] (channel
// minor), coords [B*n_views, P, 2] fp32 (x, y), out [B*n_views, P, C] in the
// dtype of f1 and features (fp32 or bf16).
//
// Replaces the TPU kernel dro_sfm_tpu/ops/pallas/tent_warp.py:_fwd_diff_kernel
// (launched by _run_fwd_diff). That kernel built the [P, h*w] tent-weight
// matrix strip by strip in VMEM and multiplied it on the MXU, a workaround
// for the TPU's lack of a fast gather. On Hopper the natural form is the
// 4-tap gather itself: one group of 16 threads per output pixel reads the
// pixel's coordinates, computes the four bilinear weights in fp32, and walks
// the channels with 16-byte loads (8 bf16 or 4 fp32 values a thread), so a
// group reads each tap's 256-byte (bf16, C = 128) feature row contiguously.
//
// Bound: memory. Per output element it does 4 multiplies and 4 adds but
// moves at least one element of out and of f1, so it sits far below the
// card's ridge point. The least bytes are f1 + the feature rows referenced
// + coords + out; at the flagship serving shape (B = 1, N = 2, 24 x 80 x 128
// bf16) that is 0.49 + 0.98 + 0.03 + 0.98 MB, about 0.74 us at 3.35 TB/s, so
// at B = 1 the launch, not the bytes, sets the time.
//
// Arithmetic: the taps are weighted and summed with explicitly rounded fp32
// operations (no fused multiply-add) in the order of the plain PyTorch
// version (dro_sfm_torch/ops/resample.py:bilinear_sample), so on finite
// inputs the kernel reproduces the plain version bit for bit before the
// final rounding to the output dtype. Unlike the TPU kernel, the tent
// weights stay in fp32 in bf16 mode.
//
// Coordinates are unbounded (the projection divides by z >= 1e-5), and
// converting a float beyond the int range is undefined in C++, so x and y
// are clamped to [-2, w + 1] and [-2, h + 1] before the floor. Every tap of
// a clamped coordinate lies outside the map, so the result is unchanged: an
// out-of-view pixel gives f1 - 0. NaN coordinates clamp to the bound too.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 16;            // threads per output pixel
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

template <typename T, typename V>
__global__ void __launch_bounds__(kBlock)
tent_warp_fwd_diff_kernel(const T* __restrict__ f1, const T* __restrict__ feat,
                          const float* __restrict__ coords, T* __restrict__ out,
                          int64_t n_pix, int n_views, int P, int h, int w, int C) {
  const int64_t pix = (int64_t)blockIdx.x * (kBlock / kGroup) + threadIdx.x / kGroup;
  const int lane = threadIdx.x % kGroup;
  if (pix >= n_pix) return;
  const int64_t bn = pix / P;                  // image of features / coords
  const int64_t p = pix - bn * P;              // pixel within the image
  const int64_t bt = bn / n_views;             // target of f1

  const float2 c = __ldg(reinterpret_cast<const float2*>(coords) + pix);
  const float x = fminf(fmaxf(c.x, -2.0f), (float)(w + 1));
  const float y = fminf(fmaxf(c.y, -2.0f), (float)(h + 1));
  const float x0f = floorf(x), y0f = floorf(y);
  const float wx = __fsub_rn(x, x0f), wy = __fsub_rn(y, y0f);
  const float ux = __fsub_rn(1.0f, wx), uy = __fsub_rn(1.0f, wy);
  const int x0 = (int)x0f, y0 = (int)y0f;

  // Taps in the plain version's order: (dy, dx) = (0,0), (0,1), (1,0), (1,1).
  bool ok[4];
  float wt[4];
  int64_t off[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int dy = t >> 1, dx = t & 1;
    const int xi = x0 + dx, yi = y0 + dy;
    ok[t] = xi >= 0 && xi <= w - 1 && yi >= 0 && yi <= h - 1;
    wt[t] = __fmul_rn(dx ? wx : ux, dy ? wy : uy);
    off[t] = ((bn * h + yi) * w + xi) * (int64_t)C;
  }

  const T* f1_row = f1 + (bt * P + p) * (int64_t)C;
  T* out_row = out + pix * (int64_t)C;
  for (int ch = lane * V::N; ch < C; ch += kGroup * V::N) {
    float acc[V::N], tap[V::N], base[V::N];
#pragma unroll
    for (int i = 0; i < V::N; ++i) acc[i] = 0.0f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (!ok[t]) continue;
      V::load(feat + off[t] + ch, tap);
#pragma unroll
      for (int i = 0; i < V::N; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(tap[i], wt[t]));
    }
    V::load(f1_row + ch, base);
#pragma unroll
    for (int i = 0; i < V::N; ++i) acc[i] = __fsub_rn(base[i], acc[i]);
    V::store(out_row + ch, acc);
  }
}

template <typename T>
cudaError_t launch(const void* f1, const void* feat, const float* coords, void* out,
                   int64_t n_pix, int n_views, int P, int h, int w, int C,
                   bool vectorized, cudaStream_t stream) {
  const int64_t pix_per_block = kBlock / kGroup;
  const unsigned grid = (unsigned)((n_pix + pix_per_block - 1) / pix_per_block);
  if (vectorized) {
    tent_warp_fwd_diff_kernel<T, Vec<T>><<<grid, kBlock, 0, stream>>>(
        (const T*)f1, (const T*)feat, coords, (T*)out, n_pix, n_views, P, h, w, C);
  } else {
    tent_warp_fwd_diff_kernel<T, Scalar<T>><<<grid, kBlock, 0, stream>>>(
        (const T*)f1, (const T*)feat, coords, (T*)out, n_pix, n_views, P, h, w, C);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16. vectorized: nonzero when C * sizeof(element) is
// a multiple of 16 and every pointer is 16-byte aligned. Returns the CUDA
// error of the launch (0 on success); the kernel runs on `stream`.
extern "C" int tent_warp_fwd_diff(const void* f1, const void* feat, const void* coords,
                                  void* out, long long bn, int n_views, int P, int h,
                                  int w, int C, int dtype, int vectorized, void* stream) {
  const int64_t n_pix = (int64_t)bn * P;
  if (n_pix == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch<float>(f1, feat, (const float*)coords, out, n_pix, n_views, P, h,
                              w, C, vectorized != 0, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(f1, feat, (const float*)coords, out, n_pix, n_views,
                                      P, h, w, C, vectorized != 0, s);
  return (int)cudaErrorInvalidValue;
}
