// Backward of one separable-GRU pass (kernel K5, gru_pass_fwd.cu): K6-input
// and K6-weight. Given the cotangent g of h', with z, r, q, r*h recomputed
// as the forward computes them (fp32 sums, T roundings):
//
//   dz   = g (q - h)                      daq  = (g z)(1 - q^2)   [fp32]
//   drhx = conv5^T(T(daq), Wq)            drh, dxq = drhx[:D], drhx[D:]
//   dazr = [dz z (1 - z), (drh h) r (1 - r)]                      [fp32]
//   dhx  = conv5^T(T(dazr), Wzr)
//   dh   = g (1 - z) + drh r + dhx[:D]    dx = dxq + dhx[D:]
//   dWzr[k] = sum_p [h, x](p + k - 2)^T T(dazr)(p)   dbzr = sum_p dazr
//   dWq[k]  = sum_p [r h, x](p + k - 2)^T T(daq)(p)  dbq  = sum_p daq
//
// K6-input replaces the TPU kernel dro_sfm_tpu/ops/pallas/gru_pass.py:
// _bwd_input_kernel, K6-weight its _bwd_weight_kernel; the arithmetic is
// _grad_intermediates', rounding point by rounding point: daq and dazr are
// rounded to T before the transposed convs and the weight products, the
// bias gradients sum the unrounded fp32 values, dh = (g (1 - z) + drh r) +
// dhx[:D] in fp32 with one rounding.
//
// Every product is an implicit GEMM on the tile engine of gru_gemm.cuh over
// the line segments of gru_conv.cuh, whose staged tile serves all five taps
// with no padded copy; the vertical pass reads with the W-pixel stride, no
// transpose. The first two stages are K5's two launches with other
// epilogues. The intermediates go through device memory, where at these
// sizes they stay in the 50 MB L2.
//
// K6-input, four launches on the stream, each a grid of 128 x 64 tiles (128
// pixels of whole segments), a K step a tap of a chunk of channels:
//   gru_pass_bwd_input_zr   azr = conv5([h, x], Wzr); z, r, r*h in T;
//   gru_pass_bwd_input_q    aq = conv5([r h, x], Wq); q, T(daq), the z half
//                           of T(dazr), per-block bias sums of both;
//   gru_pass_bwd_input_drh  drh = conv5^T(T(daq), Wq)[:, :D]; the r half of
//                           T(dazr) and its bias sums; g (1 - z) + drh r in
//                           fp32;
//   gru_pass_bwd_input_dhx  dh: conv5^T(T(dazr), Wzr)[:, :D] added to it;
//                           dx: conv5^T([T(daq), T(dazr)], [Wq, Wzr])[:, D:]
//                           as one sum over both.
// The products are the 2 * 5 * C1 * 6D a pixel of the bound plus the drh
// stage's 2 * 5 * D^2 (7%), and what the tiles pad at their edges (dx's 160
// columns take three 64-column tiles).
//
// K6-weight, two launches: gru_pass_bwd_weight_gemm computes dWzr and dWq
// as products over the pixels, a block 64 channels x 64 outputs of one
// weight for all five taps (one warp a tap, all reading one staged tile of
// [h | x] or [r h | x]; `TapLoader`), the segments split into n_split ranges
// (split-K) so that the grid fills the card once; each split writes its fp32
// partial. Then gru_pass_bwd_weight_reduce sums the partials in split order
// and the bias sums of K6-input's tiles in a fixed order. No atomics: the
// same inputs give the same bits.
//
// Transposed taps read the weights as they are ([n][k], k contiguous), so
// no transposed copy exists. Products: bf16 on the tensor cores through
// mma.sync (fp32 accumulators), fp32 in FMA, never TF32.
//
// Bound: operations. K6-input makes 2 * 5 * C1 * 6D operations a pixel,
// K6-weight 2 * 5 * C1 * 3D: at the depth pass of it12-h-out training
// (B = 8, 24 x 80, D = 128, Cx = 160) 34.0 and 17.0 GFLOP, 34 and 17 us at
// 989 TFLOP/s bf16.
#include "gru_conv.cuh"

using namespace gru_gemm;
using namespace gru_pass;

namespace {

// Everything the K6-input stages read and write. Scratch, in T unless
// said: zr [N, 2 Dp] (z, then r), rh [N, Dp], daq [N, Dp], dazr [N, 2 Dp],
// dhp [N, Dp] fp32 (g (1 - z) + drh r), bias_part [row tiles, 3 Dp] fp32
// (dbzr's z and r halves, then dbq, summed over each row tile).
template <typename T> struct InputArgs {
  const T *h, *x, *g, *wzr, *wq;
  const float *bzr, *bq;
  T *zr, *rh, *daq, *dazr, *dh, *dx;
  float *dhp, *bias_part;
  Geo geo;
};

__device__ __forceinline__ float* reduce_smem() {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  return reinterpret_cast<float*>(smem_raw);
}

}  // namespace

// Stage 1: z, r, r*h.
template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks) gru_pass_bwd_input_zr(InputArgs<T> a) {
  const Geo& geo = a.geo;
  const int tile = blockIdx.x, n0 = blockIdx.y * kBN;
  Acc acc;
  conv_product<T, false>(acc, zr_op(a.h, a.x, a.wzr, geo), geo, tile, n0);
  zr_epilogue(acc, geo, tile, n0, a.bzr, a.h, a.zr, 2 * geo.Dp, a.rh);
}

// Stage 2: q, T(daq), the z half of T(dazr), their bias sums.
template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks) gru_pass_bwd_input_q(InputArgs<T> a) {
  const Geo& geo = a.geo;
  const int Dp = geo.Dp, D = geo.D, tile = blockIdx.x, n0 = blockIdx.y * kBN;
  Acc acc;
  conv_product<T, false>(acc, q_op(a.rh, a.x, a.wq, geo), geo, tile, n0);
  float sq[4][2] = {}, sz[4][2] = {};
  for_each_pair(acc, [&](int j, int row, int col, float v0, float v1) {
    const int m = geo.tile_pixel(tile, row), o = n0 + col;
    if (m < 0 || o >= Dp) return;
    float dq[2], dzr[2];
    const float v[2] = {v0, v1};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int oe = o + e;
      const float q = rnd<T>(tanhf(__fadd_rn(v[e], a.bq[oe])));
      const float gv = oe < D ? to_f32(a.g[(int64_t)m * D + oe]) : 0.0f;
      const float hv = oe < D ? to_f32(a.h[(int64_t)m * D + oe]) : 0.0f;
      const float z = to_f32(a.zr[(int64_t)m * 2 * Dp + oe]);
      const float dz = __fmul_rn(gv, __fsub_rn(q, hv));
      dq[e] = __fmul_rn(__fmul_rn(gv, z), __fsub_rn(1.0f, __fmul_rn(q, q)));
      dzr[e] = __fmul_rn(__fmul_rn(dz, z), __fsub_rn(1.0f, z));
      sq[j][e] += dq[e];
      sz[j][e] += dzr[e];
    }
    store2(a.daq + (int64_t)m * Dp + o, dq[0], dq[1]);
    store2(a.dazr + (int64_t)m * 2 * Dp + o, dzr[0], dzr[1]);
  });
  float* part = a.bias_part + (int64_t)tile * 3 * Dp;
  block_column_sums(sz, reduce_smem(), part, n0, Dp);
  block_column_sums(sq, reduce_smem(), part + 2 * Dp, n0, Dp);
}

// Stage 3: drh, the r half of T(dazr) and its bias sums, g (1 - z) + drh r.
template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks) gru_pass_bwd_input_drh(InputArgs<T> a) {
  const Geo& geo = a.geo;
  const int Dp = geo.Dp, D = geo.D, tile = blockIdx.x, n0 = blockIdx.y * kBN;
  ConvOp<T> op{{a.daq, a.daq}, {Dp, 0}, {Dp, 0}, Dp, Dp,
               {a.wq, a.wq}, {(int64_t)(Dp + geo.Cxp) * Dp, 0}, {Dp, 0}, 0, Dp};
  Acc acc;
  conv_product<T, true>(acc, op, geo, tile, n0);
  float sr[4][2] = {};
  for_each_pair(acc, [&](int j, int row, int col, float v0, float v1) {
    const int m = geo.tile_pixel(tile, row), c = n0 + col;
    if (m < 0 || c >= Dp) return;
    float dr_[2], dhp[2];
    const float v[2] = {v0, v1};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int ce = c + e;
      const float gv = ce < D ? to_f32(a.g[(int64_t)m * D + ce]) : 0.0f;
      const float hv = ce < D ? to_f32(a.h[(int64_t)m * D + ce]) : 0.0f;
      const float z = to_f32(a.zr[(int64_t)m * 2 * Dp + ce]);
      const float r = to_f32(a.zr[(int64_t)m * 2 * Dp + Dp + ce]);
      const float dr = __fmul_rn(v[e], hv);
      dr_[e] = __fmul_rn(__fmul_rn(dr, r), __fsub_rn(1.0f, r));
      dhp[e] = __fadd_rn(__fmul_rn(gv, __fsub_rn(1.0f, z)), __fmul_rn(v[e], r));
      sr[j][e] += dr_[e];
    }
    store2(a.dazr + (int64_t)m * 2 * Dp + Dp + c, dr_[0], dr_[1]);
    store2(a.dhp + (int64_t)m * Dp + c, dhp[0], dhp[1]);
  });
  block_column_sums(sr, reduce_smem(), a.bias_part + (int64_t)tile * 3 * Dp + Dp,
                    n0, Dp);
}

// Stage 4: dx (column tiles [0, n_xt)) and dh (the rest).
template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks) gru_pass_bwd_input_dhx(InputArgs<T> a) {
  const Geo& geo = a.geo;
  const int Dp = geo.Dp, C1p = Dp + geo.Cxp, tile = blockIdx.x;
  const int n_xt = (geo.Cxp + kBN - 1) / kBN;
  const bool is_x = (int)blockIdx.y < n_xt;
  const int n0 = (is_x ? blockIdx.y : blockIdx.y - n_xt) * kBN;
  const int64_t ts_q = (int64_t)C1p * Dp, ts_zr = (int64_t)C1p * 2 * Dp;
  const ConvOp<T> op =
      is_x ? ConvOp<T>{{a.daq, a.dazr}, {Dp, 2 * Dp}, {Dp, 2 * Dp}, Dp, 3 * Dp,
                       {a.wq, a.wzr}, {ts_q, ts_zr}, {Dp, 2 * Dp}, Dp, geo.Cxp}
           : ConvOp<T>{{a.dazr, a.dazr}, {2 * Dp, 0}, {2 * Dp, 0}, 2 * Dp, 2 * Dp,
                       {a.wzr, a.wzr}, {ts_zr, 0}, {2 * Dp, 0}, 0, Dp};
  Acc acc;
  conv_product<T, true>(acc, op, geo, tile, n0);
  for_each_pair(acc, [&](int, int row, int col, float v0, float v1) {
    const int m = geo.tile_pixel(tile, row), c = n0 + col;
    if (m < 0) return;
    if (is_x) {
      if (c < geo.Cx) store2(a.dx + (int64_t)m * geo.Cx + c, v0, v1);
    } else if (c < geo.D) {
      const float2 p = *reinterpret_cast<const float2*>(a.dhp + (int64_t)m * Dp + c);
      store2(a.dh + (int64_t)m * geo.D + c, __fadd_rn(p.x, v0), __fadd_rn(p.y, v1));
    }
  });
}

namespace {

// K6-weight's tiles: a block owns kTapCh channel rows and kTapOut output
// columns of one weight gradient for all five taps, one warp a tap. A stage
// holds kTapPix pixels as segments of L = 2^seg_shift positions of one line
// (8, 16 or 32): B (T(dazr) or T(daq)) their L rows, A ([h | x] or [r h |
// x]) L + 4 rows, from two positions before the segment to two after, zero
// past the line's ends. Tap k of the stage's pixel j reads A row tap_row(j)
// + k, so the five taps multiply one staged A.
constexpr int kTapCh = 64, kTapOut = 64, kTapPix = 32, kTapThreads = 32 * kTaps;

template <typename T> struct TapLayout {
  static constexpr int V = 16 / (int)sizeof(T);
  static constexpr int LDA = kTapCh + V, LDB = kTapOut + V;
  static constexpr int A_ROWS = kTapPix + 4 * (kTapPix / 8);   // the most: segments of 8
  static constexpr int A_ELEMS = A_ROWS * LDA, STAGE = A_ELEMS + kTapPix * LDB;
  static constexpr int BYTES = kTapStages * STAGE * (int)sizeof(T);
};

// K6-weight's operands: [h | x] against T(dazr) for dWzr, [r h | x] against
// T(daq) for dWq; fp32 partials [n_split, 5 C1p (2 Dp + Dp)] (dWzr's, then
// dWq's), split s summing the segments of its steps_per stages.
template <typename T> struct WeightArgs {
  const T *h, *x, *rh, *daq, *dazr;
  float* part;
  int steps_per;
  Geo geo;
};

// The cp.async copies of one stage of a five-tap weight product. Each
// thread copies for one segment of the stage (tps threads a segment).
template <typename T>
struct TapLoader {
  using TL = TapLayout<T>;
  const T *a0, *a1, *grad;      // A's channels below `split` from a0, the rest from a1
  int lda0, lda1, real0, real1, split, c0, n0, n_out;
  int g_base, g_end, my_seg, lt, tps;
  Geo geo;

  __device__ __forceinline__ void operator()(int step, T* As, T* Bs) const {
    constexpr int V = TL::V, CPR = kTapCh / V, CPRB = kTapOut / V;
    const int L = 1 << geo.seg_shift, S = geo.S, ss = geo.ss;
    const int g = g_base + step * (kTapPix >> geo.seg_shift) + my_seg;
    const bool seg_ok = g < g_end;
    const int line = seg_ok ? g / geo.spl : 0;
    const int s0 = (g - line * geo.spl) << geo.seg_shift;
    const int64_t pix0 = geo.line_pixel(line);
    for (int idx = lt; idx < (L + 4) * CPR; idx += tps) {
      const int u = idx / CPR, c = idx % CPR, s = s0 + u - 2, ch = c0 + c * V;
      const bool src = ch >= split;
      const int chan = src ? ch - split : ch;
      const bool ok = seg_ok && s >= 0 && s < S && chan < (src ? real1 : real0);
      const T* p = ok ? (src ? a1 : a0) + (pix0 + (int64_t)s * ss) * (src ? lda1 : lda0) + chan
                      : grad;
      cp_async16(As + (my_seg * (L + 4) + u) * TL::LDA + c * V, p, ok);
    }
    for (int idx = lt; idx < L * CPRB; idx += tps) {
      const int u = idx / CPRB, c = idx % CPRB, s = s0 + u, n = n0 + c * V;
      const bool ok = seg_ok && s < S && n < n_out;
      const T* p = ok ? grad + (pix0 + (int64_t)s * ss) * n_out + n : grad;
      cp_async16(Bs + (my_seg * L + u) * TL::LDB + c * V, p, ok);
    }
  }
};

}  // namespace

template <typename T>
__global__ void __launch_bounds__(kTapThreads, 2) gru_pass_bwd_weight_gemm(WeightArgs<T> a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  using TL = TapLayout<T>;
  const Geo& geo = a.geo;
  const int Dp = geo.Dp, C1p = Dp + geo.Cxp;
  const int n_ct = (C1p + kTapCh - 1) / kTapCh, n_zr = (2 * Dp + kTapOut - 1) / kTapOut;
  int b = blockIdx.x;
  const bool is_q = b >= n_ct * n_zr;
  if (is_q) b -= n_ct * n_zr;
  const int n_nt = is_q ? (Dp + kTapOut - 1) / kTapOut : n_zr;
  const int c0 = b / n_nt * kTapCh, n0 = b % n_nt * kTapOut, n_out = is_q ? Dp : 2 * Dp;

  TapLoader<T> load;
  load.a0 = is_q ? a.rh : a.h;
  load.lda0 = load.real0 = is_q ? Dp : geo.D;
  load.a1 = a.x;
  load.lda1 = load.real1 = geo.Cx;
  load.split = Dp;
  load.c0 = c0;
  load.grad = is_q ? a.daq : a.dazr;
  load.n0 = n0;
  load.n_out = n_out;
  const int nseg = kTapPix >> geo.seg_shift;                 // segments a stage
  load.g_base = blockIdx.y * a.steps_per * nseg;
  load.g_end = min(load.g_base + a.steps_per * nseg, geo.n_segs);
  load.tps = kTapThreads / nseg;
  load.my_seg = threadIdx.x / load.tps;
  load.lt = threadIdx.x % load.tps;
  load.geo = geo;
  const int steps = max(0, (load.g_end - load.g_base + nseg - 1) / nseg);

  const int tap = threadIdx.x >> 5, seg_shift = geo.seg_shift;
  AccN<8> acc;
  acc.zero();
  T* const smem = reinterpret_cast<T*>(smem_raw);
  ring<kTapStages>(
      steps,
      [&](int step) {
        T* st = smem + (step % kTapStages) * TL::STAGE;
        load(step, st, st + TL::A_ELEMS);
      },
      [&](int step) {
        const T* st = smem + (step % kTapStages) * TL::STAGE;
        tap_product<kTapPix>(acc, st, st + TL::A_ELEMS, TL::LDA, TL::LDB, tap, seg_shift);
      });
  const int M = kTaps * C1p;
  float* out = a.part + (int64_t)blockIdx.y * M * 3 * Dp + (is_q ? (int64_t)M * 2 * Dp : 0) +
               (int64_t)tap * C1p * n_out;
  for_each_pair(acc, 0, 0, [&](int, int row, int col, float v0, float v1) {
    const int c = c0 + row, n = n0 + col;
    if (c < C1p && n < n_out)
      *reinterpret_cast<float2*>(out + (int64_t)c * n_out + n) = make_float2(v0, v1);
  });
}

// out[e] = sum over splits of part[s][e] for the n_w weight elements, in
// split order, 4 elements a thread (the first n_w / 4 threads); then the
// 3 Dp bias sums over the n_rows rows of bias_part, 4 columns a warp (the
// warps from w0 on): lane l sums rows l, l + 32, ... in order, then the
// lanes are summed by a butterfly. A fixed order either way.
__global__ void __launch_bounds__(256) gru_pass_bwd_weight_reduce(
    const float* __restrict__ part, int n_split, int n_w, const float* __restrict__ bias_part,
    int n_rows, int nb, int w0, float* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n_w / 4) {
    const float* src = part + 4 * t;
    float4 s = *reinterpret_cast<const float4*>(src);
#pragma unroll 4
    for (int k = 1; k < n_split; ++k) {
      const float4 v = *reinterpret_cast<const float4*>(src + (int64_t)k * n_w);
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    *reinterpret_cast<float4*>(out + 4 * t) = s;
    return;
  }
  const int warp = t / 32 - w0, lane = t & 31;
  if (warp < 0 || warp >= nb / 4) return;           // whole warps
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r = lane; r < n_rows; r += 32) {
    const float4 v = *reinterpret_cast<const float4*>(bias_part + (int64_t)r * nb + 4 * warp);
    s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s.x += __shfl_xor_sync(0xffffffffu, s.x, o);
    s.y += __shfl_xor_sync(0xffffffffu, s.y, o);
    s.z += __shfl_xor_sync(0xffffffffu, s.z, o);
    s.w += __shfl_xor_sync(0xffffffffu, s.w, o);
  }
  if (lane == 0) *reinterpret_cast<float4*>(out + n_w + 4 * warp) = s;
}

namespace {

template <typename T>
cudaError_t run_input(InputArgs<T> a, cudaStream_t s) {
  const Geo& g = a.geo;
  const unsigned mt = row_tiles(g);
  const unsigned dt = (g.Dp + kBN - 1) / kBN, xt = (g.Cxp + kBN - 1) / kBN;
  const int fwd = Layout<T, false>::bytes(g.seg_shift), tr = Layout<T, true>::bytes(g.seg_shift);
  cudaError_t err;
  if ((err = launch(gru_pass_bwd_input_zr<T>, kThreads, fwd, dim3(mt, 2 * dt), a, s))) return err;
  if ((err = launch(gru_pass_bwd_input_q<T>, kThreads, fwd, dim3(mt, dt), a, s))) return err;
  if ((err = launch(gru_pass_bwd_input_drh<T>, kThreads, tr, dim3(mt, dt), a, s))) return err;
  return launch(gru_pass_bwd_input_dhx<T>, kThreads, tr, dim3(mt, xt + dt), a, s);
}

template <typename T>
cudaError_t run_weight(WeightArgs<T> a, int n_split, const float* bias_part, int n_rows,
                       float* out, cudaStream_t s) {
  const Geo& g = a.geo;
  const int C1p = g.Dp + g.Cxp, M = kTaps * C1p;
  const unsigned tiles = ((C1p + kTapCh - 1) / kTapCh) *
                         ((2 * g.Dp + kTapOut - 1) / kTapOut + (g.Dp + kTapOut - 1) / kTapOut);
  cudaError_t err = launch(gru_pass_bwd_weight_gemm<T>, kTapThreads, TapLayout<T>::BYTES,
                           dim3(tiles, n_split), a, s);
  if (err) return err;
  const int n_w = M * 3 * g.Dp, nb = 3 * g.Dp;
  const int w0 = (n_w / 4 + 31) / 32, threads = 32 * (w0 + nb / 4);
  gru_pass_bwd_weight_reduce<<<(threads + 255) / 256, 256, 0, s>>>(
      a.part, n_split, n_w, bias_part, n_rows, nb, w0, out);
  return cudaGetLastError();
}

}  // namespace

// The tiles the wrapper plans with: K6-input's kBM pixels (bias_part has a
// row per kBM pixels) and kBN columns; K6-weight's kTapCh channels, kTapOut
// outputs and kTapPix pixels a stage.
extern "C" int gru_pass_bwd_tile(int which) {
  const int tiles[] = {kBM, kBN, kTapCh, kTapOut, kTapPix};
  return which >= 0 && which < 5 ? tiles[which] : -1;
}

// K6-input. h [N, D], x [N, Cx], g [N, D] in dtype (N = B H W, channel
// minor, D and Cx multiples of 16 bytes, 16-byte aligned); wzr, bzr, wq, bq
// padded as for gru_pass_fwd. The pixels are walked line by line in
// segments of 2^seg_shift positions (seg_shift 3 to 5), kBM / 2^seg_shift
// segments a row tile. Writes dh [N, D] and dx [N, Cx] in dtype, and the
// scratch of InputArgs: zr_s, rh_s, daq_s, dazr_s in dtype, dhp_s and
// bias_part [row tiles, 3 Dp] fp32. K6-weight reads rh_s, daq_s, dazr_s and
// bias_part.
extern "C" int gru_pass_bwd_input(const void* h, const void* x, const void* wzr,
                                  const void* bzr, const void* wq, const void* bq,
                                  const void* g, void* dh, void* dx, void* zr_s, void* rh_s,
                                  void* daq_s, void* dazr_s, void* dhp_s, void* bias_part,
                                  int B, int H, int W, int D, int Cx, int Dp, int Cxp, int axis,
                                  int seg_shift, int dtype, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const Geo geo = make_geo(B, H, W, D, Cx, Dp, Cxp, axis, seg_shift);
  if (dtype == 0) {
    if (!geo_ok(geo, 4, axis)) return (int)cudaErrorInvalidValue;
    using T = float;
    return (int)run_input<T>(
        InputArgs<T>{(const T*)h, (const T*)x, (const T*)g, (const T*)wzr, (const T*)wq,
                     (const float*)bzr, (const float*)bq, (T*)zr_s, (T*)rh_s, (T*)daq_s,
                     (T*)dazr_s, (T*)dh, (T*)dx, (float*)dhp_s, (float*)bias_part, geo},
        s);
  }
  if (dtype == 1) {
    if (!geo_ok(geo, 2, axis)) return (int)cudaErrorInvalidValue;
    using T = __nv_bfloat16;
    return (int)run_input<T>(
        InputArgs<T>{(const T*)h, (const T*)x, (const T*)g, (const T*)wzr, (const T*)wq,
                     (const float*)bzr, (const float*)bq, (T*)zr_s, (T*)rh_s, (T*)daq_s,
                     (T*)dazr_s, (T*)dh, (T*)dx, (float*)dhp_s, (float*)bias_part, geo},
        s);
  }
  return (int)cudaErrorInvalidValue;
}

// K6-weight. Reads h, x and K6-input's rh_s, daq_s, dazr_s and its n_rows
// rows of bias_part; part is fp32 scratch [n_split, 5 (Dp + Cxp) 3 Dp]. The
// segments are K6-input's, kTapPix / 2^seg_shift a stage; split s sums
// stages [s steps_per, (s + 1) steps_per), and the splits must cover every
// segment. Writes out, fp32: dwzr [5, Dp + Cxp, 2 Dp], dwq [5, Dp + Cxp,
// Dp], dbzr [2 Dp], dbq [Dp], one after the other, every element.
extern "C" int gru_pass_bwd_weight(const void* h, const void* x, const void* rh_s,
                                   const void* daq_s, const void* dazr_s,
                                   const void* bias_part, int n_rows, void* part, void* out,
                                   int n_split, int steps_per, int B, int H, int W, int D,
                                   int Cx, int Dp, int Cxp, int axis, int seg_shift, int dtype,
                                   void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const Geo geo = make_geo(B, H, W, D, Cx, Dp, Cxp, axis, seg_shift);
  if (!geo_ok(geo, dtype == 1 ? 2 : 4, axis) || n_split < 1 || steps_per < 1 ||
      (int64_t)n_split * steps_per * (kTapPix >> seg_shift) < geo.n_segs)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    using T = float;
    return (int)run_weight<T>(WeightArgs<T>{(const T*)h, (const T*)x, (const T*)rh_s,
                                            (const T*)daq_s, (const T*)dazr_s, (float*)part,
                                            steps_per, geo},
                              n_split, (const float*)bias_part, n_rows, (float*)out, s);
  }
  if (dtype == 1) {
    using T = __nv_bfloat16;
    return (int)run_weight<T>(WeightArgs<T>{(const T*)h, (const T*)x, (const T*)rh_s,
                                            (const T*)daq_s, (const T*)dazr_s, (float*)part,
                                            steps_per, geo},
                              n_split, (const float*)bias_part, n_rows, (float*)out, s);
  }
  return (int)cudaErrorInvalidValue;
}
