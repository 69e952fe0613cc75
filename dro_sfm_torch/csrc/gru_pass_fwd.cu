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
// one T rounding per operation (explicit _rn intrinsics, no contraction).
//
// Design. The TPU kernel held whole maps in VMEM and ran each tap as one MXU
// product over the folded batch. Here a block owns windows of lines along
// the shift axis (gru_pass_common.cuh:Windows): the candidate conv at
// position s reads r at s-2..s+2, so a window carries a 4-row halo of [h, x]
// on each side and computes zr on 2 rows beyond its outputs. Shared memory
// holds [h | x] of the window (the concat is never written: the loader puts
// h's channels in columns [0, Dp) and x's in [Dp, Dp + Cxp)), then z and r*h
// in T; each product tile goes through a per-warp 16x16 fp32 scratch for its
// epilogue (bias, sigmoid or tanh, update). A warp owns a 16-column tile of
// a conv's output over all the block's rows, so each weight tile is read
// once per block for up to 8 row tiles, staged through shared memory while
// the previous one is multiplied (gru_pass_common.cuh:conv_block). The
// vertical pass reads its
// lines with a stride of W pixels, so no transpose is made. Products: bf16
// on the tensor cores (nvcuda::wmma 16x16x16, fp32 accumulators, channels
// zero padded to 16 by the wrapper), fp32 in FMA (never TF32: the TPU kernel
// runs Precision.HIGHEST there). Every block reads all the weights (from
// L2).
//
// Bound: operations. Per pixel 2 * 5 * C1 * 3D multiply-adds (C1 = D + Cx):
// at the depth pass of it12-h-out training (B = 8, 24 x 80, D = 128,
// Cx = 160) 17.0 GFLOP, 17 us at 989 TFLOP/s bf16, against 12.8 MB of h, x
// and h' (3.8 us at 3.35 TB/s). The halo rows add (Sw + 4)/Sw to the zr
// conv, and the M rounding to 16 rows some more.
#include "gru_pass_common.cuh"

namespace {

using namespace gru_pass;

constexpr int kMaxMT = 8;          // row tiles of a block: at most 128 rows

template <typename T>
__global__ void __launch_bounds__(kThreads)
gru_pass_fwd_kernel(const T* __restrict__ h, const T* __restrict__ x,
                    const T* __restrict__ wzr, const float* __restrict__ bzr,
                    const T* __restrict__ wq, const float* __restrict__ bq,
                    T* __restrict__ out, Lines ln, Windows wi, int D, int Cx, int Dp, int Cxp,
                    bool vec) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int C1p = Dp + Cxp, M = wi.M, rows = M + 4;
  const int lhx = C1p + kPad<T>, ld = Dp + kPad<T>;        // buffer row strides
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  T* base = reinterpret_cast<T*>(smem_raw);
  const int64_t n_elems = (int64_t)rows * (lhx + 2 * ld);
  T* hx = base + 2 * lhx;                                   // [h | x], rows -2..M+1
  T* zb = base + (int64_t)rows * lhx + 2 * ld;              // z
  T* rh = zb + (int64_t)rows * ld;                          // r*h
  float* scratch = reinterpret_cast<float*>(base + n_elems) + warp * kTile * kTile;
  T* slab = reinterpret_cast<T*>(reinterpret_cast<float*>(base + n_elems) +
                                 kWarps * kTile * kTile);

  for (int64_t i = threadIdx.x; i < n_elems * (int64_t)sizeof(T) / 16; i += kThreads)
    reinterpret_cast<uint4*>(base)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  for (int R = warp; R < M; R += kWarps) {
    const RowPos rp = row_pos(ln, wi, R);
    if (!rp.in_line) continue;
    const int64_t pix = ln.pixel(rp.line, rp.s);
    copy_row(hx + (int64_t)R * lhx, h + pix * D, D, vec, lane);
    copy_row(hx + (int64_t)R * lhx + Dp, x + pix * Cx, Cx, vec, lane);
  }
  __syncthreads();

  // zr = sigmoid(conv([h, x], Wzr) + bzr) on the outputs and 2 rows beyond.
  // A warp owns a column tile over all row tiles (kMaxMT accumulators);
  // the block walks the column tiles in rounds of kWarps.
  const unsigned need_zr = tiles_needed(ln, wi, 2), need_q = tiles_needed(ln, wi, 0);
  for (int nt0 = 0; nt0 < 2 * Dp / kTile; nt0 += kWarps) {
    const int nt = nt0 + warp;
    Tile<T> acc[kMaxMT];
#pragma unroll
    for (int mt = 0; mt < kMaxMT; ++mt) acc[mt].zero();
    conv_block<T, false>(acc, need_zr, nt < 2 * Dp / kTile, hx, lhx, 0, C1p / kTile, wzr,
                         (int64_t)C1p * 2 * Dp, 2 * Dp, 0, nt0 * kTile,
                         min(kSlabCols, 2 * Dp - nt0 * kTile), slab);
    if (nt >= 2 * Dp / kTile) continue;
#pragma unroll
    for (int mt = 0; mt < kMaxMT; ++mt) {
      if (!(need_zr >> mt & 1u)) continue;
      acc[mt].store(scratch, kTile);
      __syncwarp();
      for (int e = lane; e < kTile * kTile; e += 32) {
        const int R = mt * kTile + e / kTile, o = nt * kTile + e % kTile;
        const float v = rnd<T>(sigmoidf(__fadd_rn(scratch[e], bzr[o])));
        if (o < Dp) {
          zb[(int64_t)R * ld + o] = from_f32<T>(v);
        } else {
          const int c = o - Dp;
          rh[(int64_t)R * ld + c] = from_f32<T>(__fmul_rn(v, to_f32(hx[(int64_t)R * lhx + c])));
        }
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // q = tanh(conv([r*h, x], Wq) + bq); h' = (1 - z) h + z q on the outputs.
  for (int nt0 = 0; nt0 < Dp / kTile; nt0 += kWarps) {
    const int nt = nt0 + warp;
    const bool active = nt < Dp / kTile;
    const int n_cols = min(kSlabCols, Dp - nt0 * kTile);
    Tile<T> acc[kMaxMT];
#pragma unroll
    for (int mt = 0; mt < kMaxMT; ++mt) acc[mt].zero();
    conv_block<T, false>(acc, need_q, active, rh, ld, 0, Dp / kTile, wq, (int64_t)C1p * Dp,
                         Dp, 0, nt0 * kTile, n_cols, slab);
    conv_block<T, false>(acc, need_q, active, hx, lhx, Dp, Cxp / kTile, wq,
                         (int64_t)C1p * Dp, Dp, Dp, nt0 * kTile, n_cols, slab);
    if (!active) continue;
#pragma unroll
    for (int mt = 0; mt < kMaxMT; ++mt) {
      if (!(need_q >> mt & 1u)) continue;
      acc[mt].store(scratch, kTile);
      __syncwarp();
      for (int e = lane; e < kTile * kTile; e += 32) {
        const int R = mt * kTile + e / kTile, o = nt * kTile + e % kTile;
        if (o >= D) continue;
        const RowPos rp = row_pos(ln, wi, R);
        if (!rp.own) continue;
        const float q = rnd<T>(tanhf(__fadd_rn(scratch[e], bq[o])));
        const float z = to_f32(zb[(int64_t)R * ld + o]);
        const float hv = to_f32(hx[(int64_t)R * lhx + o]);
        const float a = rnd<T>(__fmul_rn(rnd<T>(__fsub_rn(1.0f, z)), hv));
        const float b = rnd<T>(__fmul_rn(z, q));
        out[ln.pixel(rp.line, rp.s) * D + o] = from_f32<T>(__fadd_rn(a, b));
      }
      __syncwarp();
    }
  }
}

template <typename T>
cudaError_t launch(const void* h, const void* x, const void* wzr, const float* bzr,
                   const void* wq, const float* bq, void* out, int B, int H, int W, int D,
                   int Cx, int Dp, int Cxp, int axis, bool vec, cudaStream_t s) {
  const Lines ln = make_lines(B, H, W, axis);
  if (ln.n_lines == 0 || ln.S == 0) return cudaSuccess;
  const int64_t row_bytes = (int64_t)(Dp + Cxp + 3 * kPad<T> + 2 * Dp) * sizeof(T);
  const int64_t fixed = kWarps * kTile * kTile * sizeof(float) + slab_bytes<T>();
  const int max_rows = max_rows_for(row_bytes, fixed, kMaxMT * kTile);
  if (max_rows < 16) return cudaErrorInvalidValue;
  const Windows wi = make_windows(ln, 4, max_rows);
  const size_t smem = (size_t)(wi.M + 4) * row_bytes + fixed;
  cudaError_t err = cudaFuncSetAttribute(gru_pass_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)((wi.count + wi.nl - 1) / wi.nl);
  gru_pass_fwd_kernel<T><<<grid, kThreads, smem, s>>>(
      (const T*)h, (const T*)x, (const T*)wzr, bzr, (const T*)wq, bq, (T*)out, ln, wi, D,
      Cx, Dp, Cxp, vec);
  return cudaGetLastError();
}

}  // namespace

// K5. h [B, H, W, D], x [B, H, W, Cx] contiguous in dtype (0 = fp32,
// 1 = bf16); wzr [5, Dp + Cxp, 2 Dp] and wq [5, Dp + Cxp, Dp] in that dtype,
// bzr [2 Dp] and bq [Dp] fp32, padded as gru_pass_common.cuh says (Dp, Cxp
// multiples of 16, weight pointers 32-byte aligned); out [B, H, W, D] in
// dtype. axis: 2 for the (1,5) pass along W, 1 for the (5,1) pass along H.
// vec: nonzero when D and Cx are multiples of 16 / sizeof(element) and h and
// x are 16-byte aligned. Returns the CUDA error of the launch (0 on
// success); the kernel runs on `stream`.
extern "C" int gru_pass_fwd(const void* h, const void* x, const void* wzr, const void* bzr,
                            const void* wq, const void* bq, void* out, int B, int H, int W,
                            int D, int Cx, int Dp, int Cxp, int axis, int dtype, int vec,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if ((axis != 1 && axis != 2) || Dp % kTile || Cxp % kTile) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch<float>(h, x, wzr, (const float*)bzr, wq, (const float*)bq, out, B, H,
                              W, D, Cx, Dp, Cxp, axis, vec != 0, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(h, x, wzr, (const float*)bzr, wq, (const float*)bq,
                                      out, B, H, W, D, Cx, Dp, Cxp, axis, vec != 0, s);
  return (int)cudaErrorInvalidValue;
}
