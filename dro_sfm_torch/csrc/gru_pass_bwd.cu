// Backward of one separable-GRU pass (kernel K5, gru_pass_fwd.cu), in two
// launches: K6-input and K6-weight. Given the cotangent g of h', with
// z, r, q, r*h recomputed as the forward computes them (fp32 sums, T
// roundings):
//
//   dz   = g (q - h)                      daq  = (g z)(1 - q^2)   [fp32]
//   drhx = conv5^T(T(daq), Wq)            drh, dxq = drhx[:D], drhx[D:]
//   dazr = [dz z (1 - z), (drh h) r (1 - r)]                      [fp32]
//   dhx  = conv5^T(T(dazr), Wzr)
//   dh   = g (1 - z) + drh r + dhx[:D]    dx = dxq + dhx[D:]
//   dWzr[k] = sum_p [h, x](p + k - 2)^T T(dazr)(p)   dbzr = sum_p dazr
//   dWq[k]  = sum_p [r h, x](p + k - 2)^T T(daq)(p)  dbq  = sum_p daq
//
// K6-input (gru_pass_bwd_input) replaces the TPU kernel
// dro_sfm_tpu/ops/pallas/gru_pass.py:_bwd_input_kernel, K6-weight
// (gru_pass_bwd_weight) its _bwd_weight_kernel; the arithmetic is
// _grad_intermediates', rounding point by rounding point: daq and dazr are
// rounded to T before the transposed convs and the weight products, the
// bias gradients sum the unrounded fp32 values.
//
// K6-input. A block owns windows of lines as K5 does, with an 8-row halo:
// dh at s needs dazr at s +- 2, which needs daq at s +- 4, which needs q at
// s +- 4 and so r at s +- 6 and [h, x] at s +- 8. It recomputes zr (outputs
// +- 6 rows) and q (+- 4), forms daq and dazr's z half in q's epilogue,
// runs the h columns of the daq transposed conv on +- 2 rows for dazr's r
// half, then for the output rows both transposed convs (the daq one again
// for all columns: the h columns are recomputed, 7% more products at D = 128
// than keeping fp32 partials in shared memory). Transposed taps read the
// weights column major, so no transposed copy exists. It writes dh and dx,
// and for K6-weight r*h, T(daq) and T(dazr) of its own rows (in T, padded
// widths) and its per-block fp32 bias sums. Unlike the TPU pair, K6-weight
// recomputes nothing.
//
// K6-weight. Hopper's blocks run in no order, so the TPU kernel's sum over
// its sequential grid becomes an output-stationary product: each block owns
// a 64 x 64 tile of one tap of dWzr or dWq and walks all pixels of the batch
// in fixed order, 128 at a time, staging [h, x] or [r h, x] shifted by the tap
// (zero where the shift leaves the line) and T(dazr) or T(daq) in shared
// memory. One more block sums the bias partials in block order. No atomics:
// the result is the same from run to run.
//
// Products: bf16 on the tensor cores (nvcuda::wmma, fp32 accumulators), fp32
// in FMA (never TF32), as gru_pass_common.cuh:Tile says.
//
// Bound: operations. Per pixel K6-input makes 2 * 5 * C1 * 6D multiply-adds
// (the forward's 3D and the two transposed convs' 3D), K6-weight
// 2 * 5 * C1 * 3D: at the depth pass of it12-h-out training (B = 8,
// 24 x 80, D = 128, Cx = 160) 34.0 and 17.0 GFLOP, 34 and 17 us at 989
// TFLOP/s bf16.
#include "gru_pass_common.cuh"

namespace {

using namespace gru_pass;

constexpr int kMaxMT6 = 5;         // K6-input row tiles of a block: at most 80 rows

// Sum a tile column's 16 values: lane l holds rows l/16 + 2i of column
// l % 16 in `v`; lanes l and l + 16 add in fixed order. Returns the sum in
// lanes 0..15.
__device__ __forceinline__ float column_sum(float v) {
  return v + __shfl_down_sync(0xffffffffu, v, 16);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gru_pass_bwd_input_kernel(const T* __restrict__ h, const T* __restrict__ x,
                          const T* __restrict__ wzr, const float* __restrict__ bzr,
                          const T* __restrict__ wq, const float* __restrict__ bq,
                          const T* __restrict__ g, T* __restrict__ dh, T* __restrict__ dx,
                          T* __restrict__ rh_out, T* __restrict__ daq_out,
                          T* __restrict__ dazr_out, float* __restrict__ bias_part,
                          Lines ln, Windows wi, int D, int Cx, int Dp, int Cxp, bool vec) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int C1p = Dp + Cxp, M = wi.M, rows = M + 4;
  // buffer row strides: [h | x], the D-wide buffers, dazr
  const int lhx = C1p + kPad<T>, ld = Dp + kPad<T>, ld2 = 2 * Dp + kPad<T>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  T* base = reinterpret_cast<T*>(smem_raw);
  const int64_t n_elems = (int64_t)rows * (lhx + 4 * ld + ld2);
  T* hx = base + 2 * lhx;                                  // [h | x]
  T* zb = base + (int64_t)rows * lhx + 2 * ld;             // z
  T* rb = zb + (int64_t)rows * ld;                         // r
  T* rh = rb + (int64_t)rows * ld;                         // r*h
  T* daq = rh + (int64_t)rows * ld;                        // T(daq)
  T* dazr = daq + (int64_t)rows * ld - 2 * ld + 2 * ld2;   // T(dazr), 2 Dp wide
  float* scratch = reinterpret_cast<float*>(base + n_elems) + warp * 2 * kTile * kTile;
  float* bias = reinterpret_cast<float*>(base + n_elems) + kWarps * 2 * kTile * kTile;
  T* slab = reinterpret_cast<T*>(bias + 3 * Dp);

  for (int64_t i = threadIdx.x; i < n_elems * (int64_t)sizeof(T) / 16; i += kThreads)
    reinterpret_cast<uint4*>(base)[i] = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < 3 * Dp; i += kThreads) bias[i] = 0.0f;
  __syncthreads();
  for (int R = warp; R < M; R += kWarps) {
    const RowPos rp = row_pos(ln, wi, R);
    if (!rp.in_line) continue;
    const int64_t pix = ln.pixel(rp.line, rp.s);
    copy_row(hx + (int64_t)R * lhx, h + pix * D, D, vec, lane);
    copy_row(hx + (int64_t)R * lhx + Dp, x + pix * Cx, Cx, vec, lane);
  }
  __syncthreads();

  // A warp owns a column tile of each product over all the block's row
  // tiles (kMaxMT6 accumulators), so each weight tile is read once per warp.
  // 1. zr on the outputs +- 6 rows: z, r, r*h in T.
  {
    const unsigned need = tiles_needed(ln, wi, 6);
    for (int nt0 = 0; nt0 < 2 * Dp / kTile; nt0 += kWarps) {
      const int nt = nt0 + warp;
      Tile<T> acc[kMaxMT6];
#pragma unroll
      for (int mt = 0; mt < kMaxMT6; ++mt) acc[mt].zero();
      conv_block<T, false>(acc, need, nt < 2 * Dp / kTile, hx, lhx, 0, C1p / kTile, wzr,
                           (int64_t)C1p * 2 * Dp, 2 * Dp, 0, nt0 * kTile,
                           min(kSlabCols, 2 * Dp - nt0 * kTile), slab);
      if (nt >= 2 * Dp / kTile) continue;
#pragma unroll
      for (int mt = 0; mt < kMaxMT6; ++mt) {
        if (!(need >> mt & 1u)) continue;
        acc[mt].store(scratch, kTile);
        __syncwarp();
        for (int e = lane; e < kTile * kTile; e += 32) {
          const int R = mt * kTile + e / kTile, o = nt * kTile + e % kTile;
          const float v = rnd<T>(sigmoidf(__fadd_rn(scratch[e], bzr[o])));
          if (o < Dp) {
            zb[(int64_t)R * ld + o] = from_f32<T>(v);
          } else {
            const int c = o - Dp;
            const T rhv = from_f32<T>(__fmul_rn(v, to_f32(hx[(int64_t)R * lhx + c])));
            rb[(int64_t)R * ld + c] = from_f32<T>(v);
            rh[(int64_t)R * ld + c] = rhv;
            const RowPos rp = row_pos(ln, wi, R);
            if (rp.own) rh_out[ln.pixel(rp.line, rp.s) * Dp + c] = rhv;
          }
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();

  // 2. q on the outputs +- 4 rows, then daq and dazr's z half, and their
  //    bias sums over the own rows (lane l: column l % 16, in row order).
  {
    const unsigned need = tiles_needed(ln, wi, 4);
    for (int nt0 = 0; nt0 < Dp / kTile; nt0 += kWarps) {
      const int nt = nt0 + warp;
      const bool active = nt < Dp / kTile;
      const int n_cols = min(kSlabCols, Dp - nt0 * kTile);
      Tile<T> acc[kMaxMT6];
#pragma unroll
      for (int mt = 0; mt < kMaxMT6; ++mt) acc[mt].zero();
      conv_block<T, false>(acc, need, active, rh, ld, 0, Dp / kTile, wq, (int64_t)C1p * Dp,
                           Dp, 0, nt0 * kTile, n_cols, slab);
      conv_block<T, false>(acc, need, active, hx, lhx, Dp, Cxp / kTile, wq,
                           (int64_t)C1p * Dp, Dp, Dp, nt0 * kTile, n_cols, slab);
      if (!active) continue;
      float sum_q = 0.0f, sum_z = 0.0f;
#pragma unroll
      for (int mt = 0; mt < kMaxMT6; ++mt) {
        if (!(need >> mt & 1u)) continue;
        acc[mt].store(scratch, kTile);
        __syncwarp();
        for (int e = lane; e < kTile * kTile; e += 32) {
          const int R = mt * kTile + e / kTile, o = nt * kTile + e % kTile;
          const RowPos rp = row_pos(ln, wi, R);
          const int64_t pix = rp.in_line ? ln.pixel(rp.line, rp.s) : 0;
          const float gv = (rp.in_line && o < D) ? to_f32(g[pix * D + o]) : 0.0f;
          const float q = rnd<T>(tanhf(__fadd_rn(scratch[e], bq[o])));
          const float z = to_f32(zb[(int64_t)R * ld + o]);
          const float hv = to_f32(hx[(int64_t)R * lhx + o]);
          const float dz = __fmul_rn(gv, __fsub_rn(q, hv));
          const float daq_f = __fmul_rn(__fmul_rn(gv, z), __fsub_rn(1.0f, __fmul_rn(q, q)));
          const float dazr_f = __fmul_rn(__fmul_rn(dz, z), __fsub_rn(1.0f, z));
          const T daq_t = from_f32<T>(daq_f), dazr_t = from_f32<T>(dazr_f);
          daq[(int64_t)R * ld + o] = daq_t;
          dazr[(int64_t)R * ld2 + o] = dazr_t;
          if (rp.own) {
            sum_q += daq_f;
            sum_z += dazr_f;
            daq_out[pix * Dp + o] = daq_t;
            dazr_out[pix * 2 * Dp + o] = dazr_t;
          }
        }
        __syncwarp();
      }
      sum_q = column_sum(sum_q);
      sum_z = column_sum(sum_z);
      if (lane < kTile) {
        bias[nt * kTile + lane] = sum_z;
        bias[2 * Dp + nt * kTile + lane] = sum_q;
      }
    }
  }
  __syncthreads();

  // 3. drh = conv^T(daq, Wq)[:, :Dp] on the outputs +- 2 rows, then dazr's
  //    r half: (drh h) r (1 - r).
  {
    const unsigned need = tiles_needed(ln, wi, 2);
    for (int nt0 = 0; nt0 < Dp / kTile; nt0 += kWarps) {
      const int nt = nt0 + warp;
      Tile<T> acc[kMaxMT6];
#pragma unroll
      for (int mt = 0; mt < kMaxMT6; ++mt) acc[mt].zero();
      conv_block<T, true>(acc, need, nt < Dp / kTile, daq, ld, 0, Dp / kTile, wq,
                          (int64_t)C1p * Dp, Dp, 0, nt0 * kTile,
                          min(kSlabCols, Dp - nt0 * kTile), slab);
      if (nt >= Dp / kTile) continue;
      float sum_r = 0.0f;
#pragma unroll
      for (int mt = 0; mt < kMaxMT6; ++mt) {
        if (!(need >> mt & 1u)) continue;
        acc[mt].store(scratch, kTile);
        __syncwarp();
        for (int e = lane; e < kTile * kTile; e += 32) {
          const int R = mt * kTile + e / kTile, c = nt * kTile + e % kTile;
          const float r = to_f32(rb[(int64_t)R * ld + c]);
          const float dr = __fmul_rn(scratch[e], to_f32(hx[(int64_t)R * lhx + c]));
          const float dazr_f = __fmul_rn(__fmul_rn(dr, r), __fsub_rn(1.0f, r));
          const T dazr_t = from_f32<T>(dazr_f);
          dazr[(int64_t)R * ld2 + Dp + c] = dazr_t;
          const RowPos rp = row_pos(ln, wi, R);
          if (rp.own) {
            sum_r += dazr_f;
            dazr_out[ln.pixel(rp.line, rp.s) * 2 * Dp + Dp + c] = dazr_t;
          }
        }
        __syncwarp();
      }
      sum_r = column_sum(sum_r);
      if (lane < kTile) bias[Dp + nt * kTile + lane] = sum_r;
    }
  }
  __syncthreads();

  // 4. The outputs: drhx = conv^T(daq, Wq), dhx = conv^T(dazr, Wzr);
  //    dh = (g (1 - z) + drh r) + dhx[:D], dx = dxq + dhx[D:].
  {
    const unsigned need = tiles_needed(ln, wi, 0);
    float* s1 = scratch;
    float* s2 = scratch + kTile * kTile;
    for (int nt0 = 0; nt0 < C1p / kTile; nt0 += kWarps) {
      const int nt = nt0 + warp;
      const bool active = nt < C1p / kTile;
      const int n_cols = min(kSlabCols, C1p - nt0 * kTile);
      Tile<T> a1[kMaxMT6], a2[kMaxMT6];
#pragma unroll
      for (int mt = 0; mt < kMaxMT6; ++mt) {
        a1[mt].zero();
        a2[mt].zero();
      }
      conv_block<T, true>(a1, need, active, daq, ld, 0, Dp / kTile, wq, (int64_t)C1p * Dp,
                          Dp, 0, nt0 * kTile, n_cols, slab);
      conv_block<T, true>(a2, need, active, dazr, ld2, 0, 2 * Dp / kTile, wzr,
                          (int64_t)C1p * 2 * Dp, 2 * Dp, 0, nt0 * kTile, n_cols, slab);
      if (!active) continue;
#pragma unroll
      for (int mt = 0; mt < kMaxMT6; ++mt) {
        if (!(need >> mt & 1u)) continue;
        a1[mt].store(s1, kTile);
        a2[mt].store(s2, kTile);
        __syncwarp();
        for (int e = lane; e < kTile * kTile; e += 32) {
          const int R = mt * kTile + e / kTile, c = nt * kTile + e % kTile;
          const RowPos rp = row_pos(ln, wi, R);
          if (!rp.own) continue;
          const int64_t pix = ln.pixel(rp.line, rp.s);
          if (c < Dp) {
            if (c >= D) continue;
            const float z = to_f32(zb[(int64_t)R * ld + c]);
            const float r = to_f32(rb[(int64_t)R * ld + c]);
            const float dh0 = __fmul_rn(to_f32(g[pix * D + c]), __fsub_rn(1.0f, z));
            const float v = __fadd_rn(__fadd_rn(dh0, __fmul_rn(s1[e], r)), s2[e]);
            dh[pix * D + c] = from_f32<T>(v);
          } else {
            const int cx = c - Dp;
            if (cx >= Cx) continue;
            dx[pix * Cx + cx] = from_f32<T>(__fadd_rn(s1[e], s2[e]));
          }
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 3 * Dp; i += kThreads)
    bias_part[(int64_t)blockIdx.x * 3 * Dp + i] = bias[i];
}

constexpr int kWT = 64;                 // K6-weight output tile (channels x outputs)
constexpr int kWP = 128;                // pixels staged a step
constexpr int kWLd = kWT + 8;           // staged row stride

// K6-weight. Blocks [0, n_zr) own tiles of dWzr, [n_zr, n_zr + n_q) tiles
// of dWq (tap, channel tile, output tile), the last one the bias sums. Each
// step stages kWP pixels: the [h, x] or [r h, x] rows the tap reads and the
// T(dazr) or T(daq) rows, every thread first issuing all its loads (16 bytes
// each when kVec), then storing them.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
gru_pass_bwd_weight_kernel(const T* __restrict__ h, const T* __restrict__ x,
                           const T* __restrict__ rh_s, const T* __restrict__ daq_s,
                           const T* __restrict__ dazr_s, const float* __restrict__ bias_part,
                           int n_part, float* __restrict__ dwzr, float* __restrict__ dbzr,
                           float* __restrict__ dwq, float* __restrict__ dbq, Lines ln, int D,
                           int Cx, int Dp, int Cxp) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);
  T* Bs = As + kWP * kWLd;
  const int C1p = Dp + Cxp;
  const int ct_n = (C1p + kWT - 1) / kWT;
  const int n_zr = kTaps * ct_n * ((2 * Dp + kWT - 1) / kWT);
  const int n_q = kTaps * ct_n * ((Dp + kWT - 1) / kWT);
  int b = blockIdx.x;
  if (b >= n_zr + n_q) {               // the bias sums, in block order
    for (int i = threadIdx.x; i < 3 * Dp; i += kThreads) {
      float s = 0.0f;
      for (int p = 0; p < n_part; ++p) s += bias_part[(int64_t)p * 3 * Dp + i];
      if (i < 2 * Dp) dbzr[i] = s; else dbq[i - 2 * Dp] = s;
    }
    return;
  }
  const bool is_q = b >= n_zr;
  if (is_q) b -= n_zr;
  const int n_out = is_q ? Dp : 2 * Dp;
  const int ot_n = (n_out + kWT - 1) / kWT;
  const int k = b / (ct_n * ot_n), c0 = (b / ot_n) % ct_n * kWT, o0 = b % ot_n * kWT;
  const T* grad = is_q ? daq_s : dazr_s;
  const int warp = threadIdx.x >> 5;
  const int n_pix = ln.n_lines * ln.S;
  using Chunk = typename std::conditional<kVec, uint4, T>::type;
  constexpr int kStep = sizeof(Chunk) / sizeof(T);
  constexpr int kPerRow = kWT / kStep;
  constexpr int kPerThread = 2 * kWP * kPerRow / kThreads;

  // The source of staged item idx (A rows first, then B rows), or null
  // where it is zero, and where it goes.
  auto item = [&](int p0, int idx, T** dst) -> const T* {
    const bool is_a = idx < kWP * kPerRow;
    const int rem = is_a ? idx : idx - kWP * kPerRow;
    const int pl = rem / kPerRow, col = rem % kPerRow * kStep;
    *dst = (is_a ? As : Bs) + pl * kWLd + col;
    const int p = p0 + pl;
    if (p >= n_pix) return nullptr;
    const int line = p / ln.S, s = p - line * ln.S;
    if (!is_a) return o0 + col < n_out ? grad + ln.pixel(line, s) * n_out + o0 + col : nullptr;
    const int sk = s + k - 2, c = c0 + col;            // the tap's shifted pixel
    if (sk < 0 || sk >= ln.S || c >= C1p) return nullptr;
    const int64_t pix = ln.pixel(line, sk);
    if (c < Dp) {
      if (is_q) return rh_s + pix * Dp + c;
      return c < D ? h + pix * D + c : nullptr;
    }
    return c - Dp < Cx ? x + pix * Cx + (c - Dp) : nullptr;
  };

  Tile<T> acc[2];
  acc[0].zero();
  acc[1].zero();
  constexpr int kBatch = kPerThread < 8 ? kPerThread : 8;   // loads in flight
  for (int p0 = 0; p0 < n_pix; p0 += kWP) {
    for (int i0 = 0; i0 < kPerThread; i0 += kBatch) {
      Chunk buf[kBatch];
      T* dst[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const T* src = item(p0, threadIdx.x + (i0 + i) * kThreads, &dst[i]);
        if constexpr (kVec)
          buf[i] = src ? __ldg(reinterpret_cast<const uint4*>(src)) : make_uint4(0, 0, 0, 0);
        else
          buf[i] = src ? *src : from_f32<T>(0.0f);
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) *reinterpret_cast<Chunk*>(dst[i]) = buf[i];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int f = warp + i * kWarps, fc = f / 4 * kTile, fo = f % 4 * kTile;
      if (c0 + fc >= C1p || o0 + fo >= n_out) continue;
#pragma unroll
      for (int kk = 0; kk < kWP; kk += kTile)
        acc[i].template mma<ColMajor, RowMajor>(As + kk * kWLd + fc, kWLd,
                                                Bs + kk * kWLd + fo, kWLd);
    }
    __syncthreads();
  }
  float* dw = is_q ? dwq : dwzr;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int f = warp + i * kWarps, fc = f / 4 * kTile, fo = f % 4 * kTile;
    if (c0 + fc >= C1p || o0 + fo >= n_out) continue;
    acc[i].store(dw + ((int64_t)k * C1p + c0 + fc) * n_out + o0 + fo, n_out);
  }
}

// The K6-input windows and shared-memory bytes (0: channels too wide).
template <typename T>
Windows input_windows(const Lines& ln, int Dp, int Cxp, size_t* smem) {
  const int64_t row_bytes = (int64_t)(Dp + Cxp + 6 * Dp + 6 * kPad<T>) * sizeof(T);
  const int64_t fixed = kWarps * 2 * kTile * kTile * sizeof(float) + 3 * Dp * sizeof(float) +
                        slab_bytes<T>() + 32;
  const int max_rows = max_rows_for(row_bytes, fixed, kMaxMT6 * kTile);
  if (max_rows < 32) {                          // too wide for shared memory
    *smem = 0;
    return Windows{};
  }
  const Windows wi = make_windows(ln, 8, max_rows);
  *smem = (size_t)(wi.M + 4) * row_bytes + fixed;
  return wi;
}

template <typename T>
long long input_blocks(int B, int H, int W, int Dp, int Cxp, int axis) {
  const Lines ln = make_lines(B, H, W, axis);
  size_t smem;
  const Windows wi = input_windows<T>(ln, Dp, Cxp, &smem);
  if (smem == 0) return -1;
  return (wi.count + wi.nl - 1) / wi.nl;
}

template <typename T>
cudaError_t launch_input(const void* h, const void* x, const void* wzr, const float* bzr,
                         const void* wq, const float* bq, const void* g, void* dh, void* dx,
                         void* rh_s, void* daq_s, void* dazr_s, float* bias_part, int B,
                         int H, int W, int D, int Cx, int Dp, int Cxp, int axis, bool vec,
                         cudaStream_t s) {
  const Lines ln = make_lines(B, H, W, axis);
  if (ln.n_lines == 0 || ln.S == 0) return cudaSuccess;
  size_t smem;
  const Windows wi = input_windows<T>(ln, Dp, Cxp, &smem);
  if (smem == 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(gru_pass_bwd_input_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)((wi.count + wi.nl - 1) / wi.nl);
  gru_pass_bwd_input_kernel<T><<<grid, kThreads, smem, s>>>(
      (const T*)h, (const T*)x, (const T*)wzr, bzr, (const T*)wq, bq, (const T*)g, (T*)dh,
      (T*)dx, (T*)rh_s, (T*)daq_s, (T*)dazr_s, bias_part, ln, wi, D, Cx, Dp, Cxp, vec);
  return cudaGetLastError();
}

template <typename T, bool kVec>
cudaError_t launch_weight_as(const void* h, const void* x, const void* rh_s,
                             const void* daq_s, const void* dazr_s, const float* bias_part,
                             int n_part, float* dwzr, float* dbzr, float* dwq, float* dbq,
                             const Lines& ln, int D, int Cx, int Dp, int Cxp, cudaStream_t s) {
  const int ct_n = (Dp + Cxp + kWT - 1) / kWT;
  const int blocks = kTaps * ct_n * ((2 * Dp + kWT - 1) / kWT + (Dp + kWT - 1) / kWT) + 1;
  const size_t smem = 2 * kWP * kWLd * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(gru_pass_bwd_weight_kernel<T, kVec>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  gru_pass_bwd_weight_kernel<T, kVec><<<blocks, kThreads, smem, s>>>(
      (const T*)h, (const T*)x, (const T*)rh_s, (const T*)daq_s, (const T*)dazr_s, bias_part,
      n_part, dwzr, dbzr, dwq, dbq, ln, D, Cx, Dp, Cxp);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_weight(const void* h, const void* x, const void* rh_s, const void* daq_s,
                          const void* dazr_s, const float* bias_part, int n_part, float* dwzr,
                          float* dbzr, float* dwq, float* dbq, int B, int H, int W, int D,
                          int Cx, int Dp, int Cxp, int axis, bool vec, cudaStream_t s) {
  const Lines ln = make_lines(B, H, W, axis);
  if (vec)
    return launch_weight_as<T, true>(h, x, rh_s, daq_s, dazr_s, bias_part, n_part, dwzr,
                                     dbzr, dwq, dbq, ln, D, Cx, Dp, Cxp, s);
  return launch_weight_as<T, false>(h, x, rh_s, daq_s, dazr_s, bias_part, n_part, dwzr,
                                    dbzr, dwq, dbq, ln, D, Cx, Dp, Cxp, s);
}

}  // namespace

// The number of K6-input blocks (rows of the bias partials that the caller
// allocates, [blocks, 3 Dp] fp32), or -1 when the channels are too wide for
// shared memory.
extern "C" long long gru_pass_bwd_blocks(int B, int H, int W, int Dp, int Cxp, int axis,
                                         int dtype) {
  if (dtype == 0) return input_blocks<float>(B, H, W, Dp, Cxp, axis);
  if (dtype == 1) return input_blocks<__nv_bfloat16>(B, H, W, Dp, Cxp, axis);
  return -1;
}

// K6-input. h, x, weights, biases as for gru_pass_fwd; g [B, H, W, D] in
// dtype. Writes dh [B, H, W, D] and dx [B, H, W, Cx] in dtype, and for
// K6-weight rh_s [B, H, W, Dp], daq_s [B, H, W, Dp], dazr_s [B, H, W, 2 Dp]
// in dtype and bias_part [blocks, 3 Dp] fp32 (dbzr's z and r halves, then
// dbq, summed over each block's pixels). vec: as for gru_pass_fwd.
extern "C" int gru_pass_bwd_input(const void* h, const void* x, const void* wzr,
                                  const void* bzr, const void* wq, const void* bq,
                                  const void* g, void* dh, void* dx, void* rh_s, void* daq_s,
                                  void* dazr_s, void* bias_part, int B, int H, int W, int D,
                                  int Cx, int Dp, int Cxp, int axis, int dtype, int vec,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if ((axis != 1 && axis != 2) || Dp % kTile || Cxp % kTile) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch_input<float>(h, x, wzr, (const float*)bzr, wq, (const float*)bq, g,
                                    dh, dx, rh_s, daq_s, dazr_s, (float*)bias_part, B, H, W,
                                    D, Cx, Dp, Cxp, axis, vec != 0, s);
  if (dtype == 1)
    return (int)launch_input<__nv_bfloat16>(h, x, wzr, (const float*)bzr, wq,
                                            (const float*)bq, g, dh, dx, rh_s, daq_s, dazr_s,
                                            (float*)bias_part, B, H, W, D, Cx, Dp, Cxp, axis,
                                            vec != 0, s);
  return (int)cudaErrorInvalidValue;
}

// K6-weight. Reads h, x and K6-input's rh_s, daq_s, dazr_s and n_part rows
// of bias_part; writes dwzr [5, Dp + Cxp, 2 Dp], dbzr [2 Dp], dwq
// [5, Dp + Cxp, Dp], dbq [Dp], all fp32, every element. vec: as for
// gru_pass_fwd.
extern "C" int gru_pass_bwd_weight(const void* h, const void* x, const void* rh_s,
                                   const void* daq_s, const void* dazr_s,
                                   const void* bias_part, int n_part, void* dwzr, void* dbzr,
                                   void* dwq, void* dbq, int B, int H, int W, int D, int Cx,
                                   int Dp, int Cxp, int axis, int dtype, int vec,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if ((axis != 1 && axis != 2) || Dp % kTile || Cxp % kTile) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch_weight<float>(h, x, rh_s, daq_s, dazr_s, (const float*)bias_part,
                                     n_part, (float*)dwzr, (float*)dbzr, (float*)dwq,
                                     (float*)dbq, B, H, W, D, Cx, Dp, Cxp, axis, vec != 0, s);
  if (dtype == 1)
    return (int)launch_weight<__nv_bfloat16>(h, x, rh_s, daq_s, dazr_s,
                                             (const float*)bias_part, n_part, (float*)dwzr,
                                             (float*)dbzr, (float*)dwq, (float*)dbq, B, H, W,
                                             D, Cx, Dp, Cxp, axis, vec != 0, s);
  return (int)cudaErrorInvalidValue;
}
