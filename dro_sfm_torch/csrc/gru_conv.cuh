// The five-tap convolutions of the separable-GRU pass kernels (K5,
// gru_pass_fwd.cu; K6-input, gru_pass_bwd.cu) as implicit GEMMs on the tile
// engine of gru_gemm.cuh, and what both libraries share: the element
// helpers, the geometry of the line segments, the copies of a conv's
// operands, the two forward convs and the epilogue of the gate conv.
//
// Layout: h [B, H, W, D], x [B, H, W, Cx] channel minor in the compute type
// T (fp32 or bf16). The pass shifts along W (axis 2, the (1,5) conv) or H
// (axis 1, the (5,1) conv): a line is the S pixels along the shift axis at
// one (b, other index), read with the shift stride (1 pixel or W pixels), so
// the vertical pass needs no transpose. Weights come padded by the wrapper:
// channels [0, Dp) are h's (D real), [Dp, Dp + Cxp) x's (Cx real), Dp and
// Cxp multiples of 16; wzr [5, Dp + Cxp, 2 Dp] (z columns first, then r), wq
// [5, Dp + Cxp, Dp], biases fp32 [2 Dp] and [Dp]; zero where padded.
//
// The pixels are walked line by line along the shift axis in segments of 8,
// 16 or 32 positions (`Geo`); a staged tile holds each segment with two more
// positions either side, zero-filled by cp.async past the line's ends, so
// one staged tile serves all five taps with no padded copy. A row tile is
// kBM pixels of whole segments, a block 128 pixels x 64 output columns.
#pragma once

#include "gru_gemm.cuh"

namespace gru_pass {

using namespace gru_gemm;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// v rounded to T and back: one rounding of the compute type.
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f32(from_f32<T>(v));
}
__device__ __forceinline__ float sigmoidf(float a) { return 1.0f / (1.0f + expf(-a)); }

template <typename T> __device__ __forceinline__ void store2(T* p, float a, float b);
template <> __device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <> __device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float a,
                                                                   float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
template <typename T> __device__ __forceinline__ float2 load2(const T* p) {
  return make_float2(to_f32(p[0]), to_f32(p[1]));
}

// The pixels (m = b H W + i W + j), walked line by line along the shift
// axis (position s of a line at stride ss) in segments of 2^seg_shift
// positions: spl segments a line, n_segs in all; segment g covers positions
// [(g % spl) 2^seg_shift, + 2^seg_shift) of line g / spl.
struct Geo {
  int N, S, ss, D, Cx, Dp, Cxp, seg_shift, spl, n_segs;
  // Position 0 of a line.
  __device__ __forceinline__ int64_t line_pixel(int line) const {
    return (int64_t)(line / ss) * S * ss + line % ss;
  }
  // The pixel u positions after segment g's first, or -1 past the line's
  // ends or past the last segment.
  __device__ __forceinline__ int seg_pixel(int g, int u) const {
    const int line = g / spl, s = ((g - line * spl) << seg_shift) + u;
    if (g >= n_segs || s < 0 || s >= S) return -1;
    return (int)(line_pixel(line) + (int64_t)s * ss);
  }
  // The pixel of row `row` of row tile `tile` (kBM rows, whole segments),
  // or -1.
  __device__ __forceinline__ int tile_pixel(int tile, int row) const {
    return seg_pixel(tile * (kBM >> seg_shift) + (row >> seg_shift),
                     row & ((1 << seg_shift) - 1));
  }
};

inline Geo make_geo(int B, int H, int W, int D, int Cx, int Dp, int Cxp, int axis,
                    int seg_shift) {
  Geo g;
  g.N = B * H * W;
  g.S = axis == 2 ? W : H;
  g.ss = axis == 2 ? 1 : W;
  g.D = D; g.Cx = Cx; g.Dp = Dp; g.Cxp = Cxp;
  g.seg_shift = seg_shift;
  const int L = seg_shift >= 3 && seg_shift <= 5 ? 1 << seg_shift : 8;   // else refused
  g.spl = (g.S + L - 1) / L;
  g.n_segs = g.S > 0 ? g.N / g.S * g.spl : 0;
  return g;
}

// The shapes the kernels take: segments of 8 to 32, whole 16-byte chunks of
// a pixel's channels (D, Cx multiples of 16 / elem) within the padded widths.
inline bool geo_ok(const Geo& g, int elem, int axis) {
  const int V = 16 / elem;
  return g.N > 0 && g.seg_shift >= 3 && g.seg_shift <= 5 && (axis == 1 || axis == 2) &&
         g.Dp % 16 == 0 && g.Cxp % 16 == 0 && g.D % V == 0 && g.Cx % V == 0 && g.D <= g.Dp &&
         g.Cx <= g.Cxp;
}

// Row tiles: kBM rows of whole segments.
inline int row_tiles(const Geo& g) {
  return (g.n_segs + (kBM >> g.seg_shift) - 1) / (kBM >> g.seg_shift);
}

// One conv as a GEMM: A = [a0 | a1] along K (a1's channels from K index
// `split`; a chunk is valid below its source's `real` channels), B the
// weight taps. Forward taps: B(k, n) = w0[tap][k][n]. Transposed taps:
// B(k, n) = w_s[4 - tap][n_off + n][k'] with source s = k >= split and k'
// its channel.
template <typename T> struct ConvOp {
  const T* a[2];
  int lda[2], real[2];
  int split, K;
  const T* w[2];
  int64_t ts[2];
  int ldw[2];
  int n_off, n_out;
};

// The gate conv conv5([h, x], Wzr) and the candidate conv conv5([r h, x],
// Wq) (r h [N, Dp]), forward taps.
template <typename T>
__device__ __forceinline__ ConvOp<T> zr_op(const T* h, const T* x, const T* wzr, const Geo& g) {
  return {{h, x}, {g.D, g.Cx}, {g.D, g.Cx}, g.Dp, g.Dp + g.Cxp,
          {wzr, wzr}, {(int64_t)(g.Dp + g.Cxp) * 2 * g.Dp, 0}, {2 * g.Dp, 0}, 0, 2 * g.Dp};
}
template <typename T>
__device__ __forceinline__ ConvOp<T> q_op(const T* rh, const T* x, const T* wq, const Geo& g) {
  return {{rh, x}, {g.Dp, g.Cx}, {g.Dp, g.Cx}, g.Dp, g.Dp + g.Cxp,
          {wq, wq}, {(int64_t)(g.Dp + g.Cxp) * g.Dp, 0}, {g.Dp, 0}, 0, g.Dp};
}

// The cp.async copies of a conv's K loop (`mainloop`): A, a chunk of BK
// channels of the tile's segments with two more positions either side (row
// major, CPR chunks of V channels a row); B, one tap's weights for the
// chunk, row major for forward taps, column major for transposed ones.
template <typename T, bool kTransposed>
struct ConvLoader {
  using L = Layout<T, kTransposed>;
  static constexpr int CPR = L::CPR, RPP = kThreads / CPR;
  static constexpr int A_PER = (L::MAX_A_ROWS + RPP - 1) / RPP;
  ConvOp<T> op;
  int n0, a_rows;
  int am[A_PER];                  // this thread's A rows' pixels (-1: zero)

  __device__ ConvLoader(const ConvOp<T>& o, const Geo& g, int tile, int n0_)
      : op(o), n0(n0_), a_rows(L::a_rows(g.seg_shift)) {
    const int span = (1 << g.seg_shift) + 4;
#pragma unroll
    for (int j = 0; j < A_PER; ++j) {
      const int r = threadIdx.x / CPR + RPP * j;
      am[j] = g.seg_pixel(tile * (kBM >> g.seg_shift) + r / span, r % span - 2);
    }
  }

  __device__ __forceinline__ void load_a(int chunk, T* As) const {
    constexpr int V = L::V;
    const int ac = threadIdx.x % CPR, k = chunk * L::BK + ac * V;
    // selects, not indexing: an indexed member array would live on the stack
    const bool src = k >= op.split;
    const int chan = src ? k - op.split : k, lda = src ? op.lda[1] : op.lda[0];
    const T* a = src ? op.a[1] : op.a[0];
    const bool chan_ok = k < op.K && chan < (src ? op.real[1] : op.real[0]);
#pragma unroll
    for (int j = 0; j < A_PER; ++j) {
      const int r = threadIdx.x / CPR + RPP * j;
      if (r < a_rows) {
        const bool ok = chan_ok && am[j] >= 0;
        const T* p = ok ? a + (int64_t)am[j] * lda + chan : op.a[0];
        cp_async16(As + r * L::LDA + ac * V, p, ok);
      }
    }
  }

  __device__ __forceinline__ void load_b(int chunk, int tap, T* Bs) const {
    constexpr int V = L::V, kPer = kBN / V;         // kPer: chunks of a staged k row
    constexpr int B_PER = (kTransposed ? kBN * CPR : L::BK * kPer) / kThreads;
    const int k0 = chunk * L::BK;
#pragma unroll
    for (int j = 0; j < B_PER; ++j) {
      const int idx = threadIdx.x + kThreads * j;
      if (!kTransposed) {
        const int kr = idx / kPer, n = n0 + idx % kPer * V, k = k0 + kr;
        const bool ok = k < op.K && n < op.n_out;
        const T* p = ok ? op.w[0] + tap * op.ts[0] + (int64_t)k * op.ldw[0] + n : op.w[0];
        cp_async16(Bs + L::b_off(kr, idx % kPer * V), p, ok);
      } else {
        const int nr = idx / CPR, k = k0 + idx % CPR * V, n = n0 + nr;
        const bool src = k >= op.split;
        const bool ok = k < op.K && n < op.n_out;
        const T* p = ok ? (src ? op.w[1] : op.w[0]) +
                              (kTaps - 1 - tap) * (src ? op.ts[1] : op.ts[0]) +
                              (int64_t)(op.n_off + n) * (src ? op.ldw[1] : op.ldw[0]) +
                              (src ? k - op.split : k)
                        : op.w[0];
        cp_async16(Bs + L::b_off(idx % CPR * V, nr), p, ok);
      }
    }
  }
};

// acc = the conv's products for row tile `tile`, columns [n0, n0 + kBN).
template <typename T, bool kTransposed>
__device__ __forceinline__ void conv_product(Acc& acc, const ConvOp<T>& op, const Geo& geo,
                                             int tile, int n0) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  using L = Layout<T, kTransposed>;
  const ConvLoader<T, kTransposed> load(op, geo, tile, n0);
  acc.zero();
  mainloop<T, kTransposed>(
      acc, reinterpret_cast<T*>(smem_raw), (op.K + L::BK - 1) / L::BK, geo.seg_shift,
      [&](int c, T* As) { load.load_a(c, As); },
      [&](int c, int tap, T* Bs) { load.load_b(c, tap, Bs); });
}

// The gate conv's epilogue, from the registers: z | r = T(sigmoid(acc +
// bzr)) over columns [n0, n0 + kBN) of 2 Dp; z into zr (row stride ld_zr),
// and r beside it where ld_zr is 2 Dp (K6 reads r; K5 passes Dp and keeps z
// only); T(r h) into rh [N, Dp].
template <typename T>
__device__ __forceinline__ void zr_epilogue(const Acc& acc, const Geo& geo, int tile, int n0,
                                            const float* bzr, const T* h, T* zr, int ld_zr,
                                            T* rh) {
  const int Dp = geo.Dp;
  for_each_pair(acc, [&](int, int row, int col, float v0, float v1) {
    const int m = geo.tile_pixel(tile, row), n = n0 + col;
    if (m < 0 || n >= 2 * Dp) return;
    const float s0 = rnd<T>(sigmoidf(__fadd_rn(v0, bzr[n])));
    const float s1 = rnd<T>(sigmoidf(__fadd_rn(v1, bzr[n + 1])));
    if (n < ld_zr) store2(zr + (int64_t)m * ld_zr + n, s0, s1);
    if (n >= Dp) {
      const int c = n - Dp;
      const float2 hv = c < geo.D ? load2(h + (int64_t)m * geo.D + c) : make_float2(0.f, 0.f);
      store2(rh + (int64_t)m * Dp + c, __fmul_rn(s0, hv.x), __fmul_rn(s1, hv.y));
    }
  });
}

template <class Kernel, class Args>
cudaError_t launch(Kernel kernel, int threads, int bytes, dim3 grid, const Args& args,
                   cudaStream_t s) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, bytes, s>>>(args);
  return cudaGetLastError();
}

}  // namespace gru_pass
