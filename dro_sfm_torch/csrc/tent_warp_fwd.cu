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
// Coordinates are clamped before the floor and the taps computed as
// tent_warp_common.cuh:make_taps says; the backward kernels
// (tent_warp_bwd.cu) share that function.
//
// K4, tent_warp_fwd below, is the bare warp of the same file without f1:
//
//   out[b, p, :] = bilinear(features[b], coords[b, p])      (fp32 out)
//
// replacing dro_sfm_tpu/ops/pallas/tent_warp.py:_fwd_kernel (launched by
// _run_fwd, the entry tent_warp). The same 16-thread groups, taps and fp32
// sum as K1; the output is fp32 whatever the features' dtype, as the TPU
// kernel's. Bound: memory, the feature rows referenced + coords + the fp32
// output (at 24 x 80 x 128, B*N = 16, bf16: 7.9 + 0.25 + 15.7 MB, 7.1 us at
// 3.35 TB/s). Its gradient is tent_warp_bwd.cu's K2 and K3 with sign +1.
#include "tent_warp_common.cuh"

namespace {

using namespace tent_warp;

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

  const Taps tp = make_taps(__ldg(reinterpret_cast<const float2*>(coords) + pix),
                            bn, h, w, C);
  const T* f1_row = f1 + (bt * P + p) * (int64_t)C;
  T* out_row = out + pix * (int64_t)C;
  for (int ch = lane * V::N; ch < C; ch += kGroup * V::N) {
    float acc[V::N], tap[V::N], base[V::N];
#pragma unroll
    for (int i = 0; i < V::N; ++i) acc[i] = 0.0f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (!tp.ok[t]) continue;
      V::load(feat + tp.off[t] + ch, tap);
#pragma unroll
      for (int i = 0; i < V::N; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(tap[i], tp.wt[t]));
    }
    V::load(f1_row + ch, base);
#pragma unroll
    for (int i = 0; i < V::N; ++i) acc[i] = __fsub_rn(base[i], acc[i]);
    V::store(out_row + ch, acc);
  }
}

// K4: the warp alone, fp32 out (V loads the features; stores are per
// element).
template <typename T, typename V>
__global__ void __launch_bounds__(kBlock)
tent_warp_fwd_kernel(const T* __restrict__ feat, const float* __restrict__ coords,
                     float* __restrict__ out, int64_t n_pix, int P, int h, int w, int C) {
  const int64_t pix = (int64_t)blockIdx.x * (kBlock / kGroup) + threadIdx.x / kGroup;
  const int lane = threadIdx.x % kGroup;
  if (pix >= n_pix) return;
  const int64_t bn = pix / P;
  const Taps tp = make_taps(__ldg(reinterpret_cast<const float2*>(coords) + pix),
                            bn, h, w, C);
  float* out_row = out + pix * (int64_t)C;
  for (int ch = lane * V::N; ch < C; ch += kGroup * V::N) {
    float acc[V::N], tap[V::N];
#pragma unroll
    for (int i = 0; i < V::N; ++i) acc[i] = 0.0f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (!tp.ok[t]) continue;
      V::load(feat + tp.off[t] + ch, tap);
#pragma unroll
      for (int i = 0; i < V::N; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(tap[i], tp.wt[t]));
    }
#pragma unroll
    for (int i = 0; i < V::N; ++i) out_row[ch + i] = acc[i];
  }
}

template <typename T>
cudaError_t launch_warp(const void* feat, const float* coords, float* out, int64_t n_pix,
                        int P, int h, int w, int C, bool vectorized, cudaStream_t stream) {
  const int64_t pix_per_block = kBlock / kGroup;
  const unsigned grid = (unsigned)((n_pix + pix_per_block - 1) / pix_per_block);
  if (vectorized) {
    tent_warp_fwd_kernel<T, Vec<T>><<<grid, kBlock, 0, stream>>>(
        (const T*)feat, coords, out, n_pix, P, h, w, C);
  } else {
    tent_warp_fwd_kernel<T, Scalar<T>><<<grid, kBlock, 0, stream>>>(
        (const T*)feat, coords, out, n_pix, P, h, w, C);
  }
  return cudaGetLastError();
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

// K4. feat [bn, h, w, C] (dtype: 0 = fp32, 1 = bf16), coords [bn, P, 2] fp32
// -> out [bn, P, C] fp32. vectorized: nonzero when C * sizeof(element) and
// C * 4 are multiples of 16 and feat and out are 16-byte aligned.
extern "C" int tent_warp_fwd(const void* feat, const void* coords, void* out, long long bn,
                             int P, int h, int w, int C, int dtype, int vectorized,
                             void* stream) {
  const int64_t n_pix = (int64_t)bn * P;
  if (n_pix == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_warp<float>(feat, (const float*)coords, (float*)out, n_pix, P, h, w,
                                   C, vectorized != 0, s);
  if (dtype == 1)
    return (int)launch_warp<__nv_bfloat16>(feat, (const float*)coords, (float*)out, n_pix,
                                           P, h, w, C, vectorized != 0, s);
  return (int)cudaErrorInvalidValue;
}
