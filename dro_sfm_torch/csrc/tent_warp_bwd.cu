// Backward of the fused warp-subtract (kernel K1, tent_warp_fwd.cu):
//
//   out[b, p, :] = f1[b / n_views, p, :] - bilinear(features[b], coords[b, p])
//
// Given the cotangent g [B*n_views, P, C] of `out`, the two halves below
// compute the gradients of the features and of the coordinates. The gradient
// of f1 (the sum of g over the views) is plain PyTorch in the wrapper. Both
// take a `sign`: -1 for the warp-subtract, +1 for the bare warp (K4,
// tent_warp_fwd.cu:tent_warp_fwd, whose fp32 cotangent K3 reads beside bf16
// features). Below, "-" stands for that sign.
//
// K2, tent_warp_bwd_feat (replaces dro_sfm_tpu/ops/pallas/tent_warp.py:
// _bwd_feat_kernel, launched by _run_bwd_feat):
//
//   d_features[b, q, :] = -sum_p W[p, q] g[b, p, :]
//
// the transpose of the sampling: each pixel scatters -w_t * g into the
// feature rows of its four taps. The TPU kernel built the [P, h*w]
// tent-weight strip in VMEM and contracted it on the MXU, revisiting one
// output block across the grid; Hopper's blocks run in no order, so the
// scatter is fp32 atomicAdd into a [B*n_views, h, w, C] buffer the wrapper
// zeroes: on the 16-byte path one float4 atomic (sm_90) per four channels,
// else one per channel. In fp32 mode the buffer is the output; in bf16 mode
// the wrapper casts it once. Atomics make the order of the adds, and so the
// last bits of the sums, vary from run to run.
//
// K3, tent_warp_bwd_coords (replaces tent_warp.py:_bwd_coords_kernel,
// launched by _run_bwd_coords):
//
//   d_x[b, p] = -<g[b, p, :], (1 - wy) (F[y0, x0+1] - F[y0, x0])
//                               + wy (F[y0+1, x0+1] - F[y0+1, x0])>
//   d_y[b, p] = -<g[b, p, :], (1 - wx) (F[y0+1, x0] - F[y0, x0])
//                               + wx (F[y0+1, x0+1] - F[y0, x0+1])>
//
// with out-of-view taps counted as zero. Since x0 = floor(x), a coordinate
// on an integer k takes the taps k and k + 1 and so gets the right-sided
// subgradient F[k+1] - F[k], not zero: the JAX package insists on it
// (tent_warp.py:60-72), and missing it once made self-supervised training
// diverge. The 16 lanes of a pixel's group each reduce their channels, then
// combine by warp shuffles; lane 0 writes (d_x, d_y) as one float2.
//
// One 16-thread group per (view, pixel), as in K1, with the taps from
// tent_warp_common.cuh:make_taps (the same clamp before the floor, fp32
// weights; the TPU kernel rounds its weights to bf16 in bf16 mode) and
// 16-byte loads of g and of the tap rows (8 bf16 or 4 fp32 a thread), or
// one element at a time where C * sizeof(element) is not a multiple of 16.
//
// Bound: memory. At the training shape (B*n_views = 16, 24 x 80 x 128 bf16)
// K2 reads g (7.86 MB) and coords (0.25 MB) and writes d_features (7.86 MB
// bf16): about 16 MB, 4.8 us at 3.35 TB/s; the fp32 scratch (15.7 MB) and
// its zeroing and cast come on top and stay in the 50 MB L2. K3 reads g, the
// feature rows the taps reference (up to 7.86 MB) and coords, and writes
// 0.25 MB: also about 16 MB.
#include "tent_warp_common.cuh"

#include <type_traits>

namespace {

using namespace tent_warp;

// dst[i] += sw * g[i] (sw = sign * weight, so -w * g rounds as -(w * g))
// for the N channels of one thread, in float4 atomics where N is a multiple
// of 4 (dst then 16-byte aligned), else one by one.
template <int N>
__device__ __forceinline__ void scatter_add(float* dst, float sw, const float* g) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      atomicAdd(reinterpret_cast<float4*>(dst + i),
                make_float4(__fmul_rn(sw, g[i]), __fmul_rn(sw, g[i + 1]),
                            __fmul_rn(sw, g[i + 2]), __fmul_rn(sw, g[i + 3])));
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) atomicAdd(dst + i, __fmul_rn(sw, g[i]));
  }
}

template <typename T, typename V>
__global__ void __launch_bounds__(kBlock)
tent_warp_bwd_feat_kernel(const float* __restrict__ coords, const T* __restrict__ g,
                          float* __restrict__ d_feat, int64_t n_pix, int P, int h, int w,
                          int C, float sign) {
  const int64_t pix = (int64_t)blockIdx.x * (kBlock / kGroup) + threadIdx.x / kGroup;
  const int lane = threadIdx.x % kGroup;
  if (pix >= n_pix) return;
  const int64_t bn = pix / P;
  const Taps tp = make_taps(__ldg(reinterpret_cast<const float2*>(coords) + pix),
                            bn, h, w, C);
  if (!(tp.ok[0] || tp.ok[1] || tp.ok[2] || tp.ok[3])) return;
  const T* g_row = g + pix * (int64_t)C;
  for (int ch = lane * V::N; ch < C; ch += kGroup * V::N) {
    float gv[V::N];
    V::load(g_row + ch, gv);
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (tp.ok[t]) scatter_add<V::N>(d_feat + tp.off[t] + ch, sign * tp.wt[t], gv);
  }
}

// g in TG, features in TF: the same type, or fp32 g beside bf16 features.
// kVec: 16-byte loads, Vec<TF>::N channels a step (g in as many 16-byte
// loads as that takes); else one channel a step.
template <typename TF, typename TG, bool kVec>
__global__ void __launch_bounds__(kBlock)
tent_warp_bwd_coords_kernel(const TF* __restrict__ feat, const float* __restrict__ coords,
                            const TG* __restrict__ g, float2* __restrict__ d_coords,
                            int64_t n_pix, int P, int h, int w, int C, float sign) {
  using VF = typename std::conditional<kVec, Vec<TF>, Scalar<TF>>::type;
  using VG = typename std::conditional<kVec, Vec<TG>, Scalar<TG>>::type;
  constexpr int N = VF::N;
  static_assert(N % VG::N == 0, "g loads must tile the feature loads");
  const int64_t pix = (int64_t)blockIdx.x * (kBlock / kGroup) + threadIdx.x / kGroup;
  const int lane = threadIdx.x % kGroup;
  // No early return: every lane of the warp takes part in the shuffles.
  const bool active = pix < n_pix;
  float dx = 0.0f, dy = 0.0f;
  if (active) {
    const int64_t bn = pix / P;
    const Taps tp = make_taps(__ldg(reinterpret_cast<const float2*>(coords) + pix),
                              bn, h, w, C);
    const float ux = 1.0f - tp.wx, uy = 1.0f - tp.wy;
    const TG* g_row = g + pix * (int64_t)C;
    if (tp.ok[0] || tp.ok[1] || tp.ok[2] || tp.ok[3]) {
      for (int ch = lane * N; ch < C; ch += kGroup * N) {
        float gv[N], f[4][N];
#pragma unroll
        for (int i = 0; i < N; i += VG::N) VG::load(g_row + ch + i, gv + i);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          if (tp.ok[t]) {
            VF::load(feat + tp.off[t] + ch, f[t]);
          } else {
#pragma unroll
            for (int i = 0; i < N; ++i) f[t][i] = 0.0f;
          }
        }
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float ex = uy * (f[1][i] - f[0][i]) + tp.wy * (f[3][i] - f[2][i]);
          const float ey = ux * (f[2][i] - f[0][i]) + tp.wx * (f[3][i] - f[1][i]);
          dx += gv[i] * ex;
          dy += gv[i] * ey;
        }
      }
    }
  }
#pragma unroll
  for (int o = kGroup / 2; o > 0; o >>= 1) {
    dx += __shfl_xor_sync(0xffffffffu, dx, o, kGroup);
    dy += __shfl_xor_sync(0xffffffffu, dy, o, kGroup);
  }
  if (active && lane == 0) d_coords[pix] = make_float2(sign * dx, sign * dy);
}

unsigned grid_for(int64_t n_pix) {
  const int64_t pix_per_block = kBlock / kGroup;
  return (unsigned)((n_pix + pix_per_block - 1) / pix_per_block);
}

template <typename T>
cudaError_t launch_feat(const float* coords, const void* g, float* d_feat, int64_t n_pix,
                        int P, int h, int w, int C, bool vectorized, float sign,
                        cudaStream_t s) {
  if (vectorized) {
    tent_warp_bwd_feat_kernel<T, Vec<T>><<<grid_for(n_pix), kBlock, 0, s>>>(
        coords, (const T*)g, d_feat, n_pix, P, h, w, C, sign);
  } else {
    tent_warp_bwd_feat_kernel<T, Scalar<T>><<<grid_for(n_pix), kBlock, 0, s>>>(
        coords, (const T*)g, d_feat, n_pix, P, h, w, C, sign);
  }
  return cudaGetLastError();
}

template <typename TF, typename TG>
cudaError_t launch_coords(const void* feat, const float* coords, const void* g,
                          float2* d_coords, int64_t n_pix, int P, int h, int w, int C,
                          bool vectorized, float sign, cudaStream_t s) {
  if (vectorized) {
    tent_warp_bwd_coords_kernel<TF, TG, true><<<grid_for(n_pix), kBlock, 0, s>>>(
        (const TF*)feat, coords, (const TG*)g, d_coords, n_pix, P, h, w, C, sign);
  } else {
    tent_warp_bwd_coords_kernel<TF, TG, false><<<grid_for(n_pix), kBlock, 0, s>>>(
        (const TF*)feat, coords, (const TG*)g, d_coords, n_pix, P, h, w, C, sign);
  }
  return cudaGetLastError();
}

}  // namespace

// K2. coords [bn, P, 2] fp32, g [bn, P, C] (dtype: 0 = fp32, 1 = bf16),
// d_feat [bn, h, w, C] fp32, zeroed by the caller; adds sign * W^T g into it.
// vectorized: nonzero when C * sizeof(element of g) is a multiple of 16 and
// g and d_feat are 16-byte aligned. Returns the CUDA error of the launch (0 on success);
// the kernel runs on `stream`.
extern "C" int tent_warp_bwd_feat(const void* coords, const void* g, void* d_feat,
                                  long long bn, int P, int h, int w, int C, int dtype,
                                  int vectorized, float sign, void* stream) {
  const int64_t n_pix = (int64_t)bn * P;
  if (n_pix == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_feat<float>((const float*)coords, g, (float*)d_feat, n_pix, P, h,
                                   w, C, vectorized != 0, sign, s);
  if (dtype == 1)
    return (int)launch_feat<__nv_bfloat16>((const float*)coords, g, (float*)d_feat, n_pix,
                                           P, h, w, C, vectorized != 0, sign, s);
  return (int)cudaErrorInvalidValue;
}

// K3. feat [bn, h, w, C] (feat_dtype: 0 = fp32, 1 = bf16), g [bn, P, C] in
// the same dtype or fp32 (g_dtype), coords [bn, P, 2] fp32 -> d_coords
// [bn, P, 2] fp32, every element written, times sign. vectorized: nonzero
// when C * sizeof(element) is a multiple of 16 for both and feat and g are
// 16-byte aligned.
extern "C" int tent_warp_bwd_coords(const void* feat, const void* coords, const void* g,
                                    void* d_coords, long long bn, int P, int h, int w,
                                    int C, int feat_dtype, int g_dtype, int vectorized,
                                    float sign, void* stream) {
  const int64_t n_pix = (int64_t)bn * P;
  if (n_pix == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const bool v = vectorized != 0;
  const float* co = (const float*)coords;
  float2* out = (float2*)d_coords;
  if (feat_dtype == 0 && g_dtype == 0)
    return (int)launch_coords<float, float>(feat, co, g, out, n_pix, P, h, w, C, v, sign, s);
  if (feat_dtype == 1 && g_dtype == 1)
    return (int)launch_coords<__nv_bfloat16, __nv_bfloat16>(feat, co, g, out, n_pix, P, h,
                                                             w, C, v, sign, s);
  if (feat_dtype == 1 && g_dtype == 0)
    return (int)launch_coords<__nv_bfloat16, float>(feat, co, g, out, n_pix, P, h, w, C, v,
                                                     sign, s);
  return (int)cudaErrorInvalidValue;
}
