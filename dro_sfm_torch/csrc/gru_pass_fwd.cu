// One directional pass of the separable ConvGRU of the DRO refinement
// (kernel K5):
//
//   zr  = sigmoid(conv5([h, x], Wzr) + bzr)        z | r, fp32 accumulators
//   q   = tanh(conv5([r*h, x], Wq) + bq)
//   h'  = (1 - z) h + z q                           in the compute type T
//
// with the 5-tap conv along W (axis 2) or H (axis 1), zero padded. Replaces
// the TPU kernel dro_sfm_tpu/ops/pallas/gru_pass.py:_fwd_kernel (launched by
// _run_fwd; arithmetic of _recompute). Rounding follows it point by point:
// products of T operands summed in fp32, the bias added in fp32, sigmoid and
// tanh on the fp32 sums then rounded to T, r*h rounded to T, and the update
// one T rounding per operation (explicit _rn intrinsics, no contraction):
// a = T(T(1 - z) h), b = T(z q), h' = T(a + b).
//
// Design. The TPU kernel held whole maps in VMEM and ran each tap as one MXU
// product over the folded batch. Here the pass is two chained implicit GEMMs
// on the tile engine (gru_gemm.cuh) over the line segments of gru_conv.cuh,
// two launches on the stream, each a grid of 128-pixel x 64-column tiles
// with 4 blocks an SM; r*h goes through device memory, where it stays in the
// 50 MB L2:
//   gru_pass_fwd_zr   azr = conv5([h, x], Wzr); z and T(r h) to scratch
//                     (the epilogue K6-input's first stage uses; r itself
//                     is not kept);
//   gru_pass_fwd_q    aq = conv5([r h, x], Wq); h' straight from the
//                     accumulators' registers, columns below D only.
// A staged tile of a segment with two positions either side serves all five
// taps, so no halo is recomputed: the second launch reads the first's r*h
// at the neighbouring positions. Products: bf16 on the tensor cores through
// ldmatrix and mma.sync (fp32 accumulators), fp32 in FMA (never TF32: the
// TPU kernel runs Precision.HIGHEST there).
//
// Bound: operations. Per pixel 2 * 5 * C1 * 3D multiply-adds (C1 = D + Cx):
// at the depth pass of it12-h-out training (B = 8, 24 x 80, D = 128,
// Cx = 160) 17.0 GFLOP, 17 us at 989 TFLOP/s bf16, against 12.8 MB of h, x
// and h' (3.8 us at 3.35 TB/s). The tiles pad the segments to whole row
// tiles and the columns to 64.
#include "gru_conv.cuh"

using namespace gru_gemm;
using namespace gru_pass;

namespace {

// What K5's launches read and write: h [N, D], x [N, Cx]; scratch z and r h
// [N, Dp] in T; out [N, D].
template <typename T> struct FwdArgs {
  const T *h, *x, *wzr, *wq;
  const float *bzr, *bq;
  T *z, *rh, *out;
  Geo geo;
};

}  // namespace

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks) gru_pass_fwd_zr(FwdArgs<T> a) {
  const Geo& geo = a.geo;
  const int tile = blockIdx.x, n0 = blockIdx.y * kBN;
  Acc acc;
  conv_product<T, false>(acc, zr_op(a.h, a.x, a.wzr, geo), geo, tile, n0);
  zr_epilogue(acc, geo, tile, n0, a.bzr, a.h, a.z, geo.Dp, a.rh);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks) gru_pass_fwd_q(FwdArgs<T> a) {
  const Geo& geo = a.geo;
  const int D = geo.D, tile = blockIdx.x, n0 = blockIdx.y * kBN;
  Acc acc;
  conv_product<T, false>(acc, q_op(a.rh, a.x, a.wq, geo), geo, tile, n0);
  for_each_pair(acc, [&](int, int row, int col, float v0, float v1) {
    const int m = geo.tile_pixel(tile, row), o = n0 + col;
    if (m < 0 || o >= D) return;                   // D is even: o + 1 < D too
    const float2 z = load2(a.z + (int64_t)m * geo.Dp + o);
    const float2 hv = load2(a.h + (int64_t)m * D + o);
    const float zs[2] = {z.x, z.y}, hs[2] = {hv.x, hv.y}, v[2] = {v0, v1};
    float out[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float q = rnd<T>(tanhf(__fadd_rn(v[e], a.bq[o + e])));
      const float keep = rnd<T>(__fmul_rn(rnd<T>(__fsub_rn(1.0f, zs[e])), hs[e]));
      out[e] = __fadd_rn(keep, rnd<T>(__fmul_rn(zs[e], q)));
    }
    store2(a.out + (int64_t)m * D + o, out[0], out[1]);
  });
}

namespace {

template <typename T>
cudaError_t run_fwd(const FwdArgs<T>& a, int tiles, cudaStream_t s) {
  const unsigned dt = (a.geo.Dp + kBN - 1) / kBN;
  const int bytes = Layout<T, false>::bytes(a.geo.seg_shift);
  cudaError_t err = launch(gru_pass_fwd_zr<T>, kThreads, bytes, dim3(tiles, 2 * dt), a, s);
  if (err) return err;
  return launch(gru_pass_fwd_q<T>, kThreads, bytes, dim3(tiles, dt), a, s);
}

}  // namespace

// K5. h [N, D], x [N, Cx] in dtype (0 = fp32, 1 = bf16; N = B H W, channel
// minor, D and Cx multiples of 16 bytes, 16-byte aligned); wzr [5, Dp + Cxp,
// 2 Dp] and wq [5, Dp + Cxp, Dp] in that dtype, bzr [2 Dp] and bq [Dp] fp32,
// padded as gru_conv.cuh says; out [N, D] in dtype; scratch z_s and rh_s
// [N, Dp] in dtype. axis: 2 for the (1,5) pass along W, 1 for the (5,1)
// pass along H. The pixels are walked line by line in segments of
// 2^seg_shift positions (seg_shift 3 to 5), `tiles` row tiles of kBM pixels
// of whole segments (the wrapper's plan, which must be the kernel's).
// Returns the CUDA error of the launches (0 on success); both run on
// `stream`.
extern "C" int gru_pass_fwd(const void* h, const void* x, const void* wzr, const void* bzr,
                            const void* wq, const void* bq, void* out, void* z_s, void* rh_s,
                            int tiles, int B, int H, int W, int D, int Cx, int Dp, int Cxp,
                            int axis, int seg_shift, int dtype, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const Geo geo = make_geo(B, H, W, D, Cx, Dp, Cxp, axis, seg_shift);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (!geo_ok(geo, dtype == 1 ? 2 : 4, axis) || tiles != row_tiles(geo))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    using T = float;
    return (int)run_fwd<T>(FwdArgs<T>{(const T*)h, (const T*)x, (const T*)wzr, (const T*)wq,
                                      (const float*)bzr, (const float*)bq, (T*)z_s, (T*)rh_s,
                                      (T*)out, geo},
                           tiles, s);
  }
  using T = __nv_bfloat16;
  return (int)run_fwd<T>(FwdArgs<T>{(const T*)h, (const T*)x, (const T*)wzr, (const T*)wq,
                                    (const float*)bzr, (const float*)bq, (T*)z_s, (T*)rh_s,
                                    (T*)out, geo},
                         tiles, s);
}
