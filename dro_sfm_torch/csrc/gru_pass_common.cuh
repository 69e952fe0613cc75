// Shared by the separable-GRU pass kernels (gru_pass_fwd.cu: K5,
// gru_pass_bwd.cu: K6-input and K6-weight): the geometry of the lines along
// the shift axis, the windows a block owns, the 16x16 warp tile product (bf16
// tensor cores through nvcuda::wmma, or fp32 FMA), and the element helpers.
//
// Layout: h [B, H, W, D], x [B, H, W, Cx] channel minor in the compute type
// T (fp32 or bf16). The pass shifts along W (axis 2, the (1,5) conv) or H
// (axis 1, the (5,1) conv): a "line" is the S pixels along the shift axis at
// one (b, other index), read with the shift stride (1 pixel or W pixels), so
// the vertical pass needs no transpose. Weights come padded by the wrapper:
// channels [0, Dp) are h's (D real), [Dp, Dp + Cxp) x's (Cx real), Dp and Cxp
// multiples of 16; wzr [5, Dp + Cxp, 2 Dp] (z columns first, then r), wq
// [5, Dp + Cxp, Dp], biases fp32 [2 Dp] and [Dp]; zero where padded.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace gru_pass {

constexpr int kTaps = 5;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16;                  // warp tile edge (wmma 16x16x16)

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

// Copy n elements of one pixel's channels from global to shared memory, one
// warp: 16-byte accesses when vec, else one element per lane.
template <typename T>
__device__ __forceinline__ void copy_row(T* dst, const T* src, int n, bool vec, int lane) {
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    for (int c = lane * V; c < n; c += 32 * V)
      *reinterpret_cast<uint4*>(dst + c) = __ldg(reinterpret_cast<const uint4*>(src + c));
  } else {
    for (int c = lane; c < n; c += 32) dst[c] = src[c];
  }
}

// The lines along the shift axis. Line l = (b, i): b = l / n_inner, i the
// other spatial index; pixel (l, s) = b*H*W + i*inner_stride + s*shift_stride.
struct Lines {
  int S;                       // pixels along the shift axis
  int n_inner;                 // lines per image
  int n_lines;
  int hw, inner_stride, shift_stride;
  __device__ __forceinline__ int64_t pixel(int line, int s) const {
    const int b = line / n_inner, i = line - b * n_inner;
    return (int64_t)b * hw + (int64_t)i * inner_stride + (int64_t)s * shift_stride;
  }
};

inline Lines make_lines(int B, int H, int W, int axis) {
  Lines ln;
  ln.hw = H * W;
  if (axis == 2) {             // (1,5): shift along W
    ln.S = W; ln.n_inner = H; ln.inner_stride = W; ln.shift_stride = 1;
  } else {                     // (5,1): shift along H
    ln.S = H; ln.n_inner = W; ln.inner_stride = 1; ln.shift_stride = W;
  }
  ln.n_lines = B * ln.n_inner;
  return ln;
}

// The windows of the lines. A window is Sw consecutive output positions of
// one line (the last window of a line may be shorter); a block owns nl
// windows, stacked in shared memory as segments of L = Sw + 2*halo rows. Row
// u of a segment holds position s0 + u - halo (zero outside the line), so a
// 5-tap conv output at row R reads rows R-2..R+2 of its input, and the halo
// rows carry the neighbours that the chained convs need. M = the rows a block
// computes, nl*L rounded up to the 16-row tile; buffers hold 2 more rows above
// and below, zero.
struct Windows {
  int Sw, per_line, nl, L, M, halo, count;
};

// The largest window that keeps a block within max_rows rows.
inline Windows make_windows(const Lines& ln, int halo, int max_rows) {
  Windows wi;
  wi.halo = halo;
  const int sw_max = max_rows - 2 * halo;
  wi.per_line = (ln.S + sw_max - 1) / sw_max;
  wi.Sw = (ln.S + wi.per_line - 1) / wi.per_line;
  wi.L = wi.Sw + 2 * halo;
  wi.count = ln.n_lines * wi.per_line;
  wi.nl = max_rows / wi.L;
  if (wi.nl > wi.count) wi.nl = wi.count;
  if (wi.nl < 1) wi.nl = 1;
  wi.M = (wi.nl * wi.L + kTile - 1) / kTile * kTile;
  return wi;
}

// Where row R of a block's buffers lies: window j of the block (valid when
// j < nl and the window exists), position s in its line, whether s is in the
// line, and whether R is one of the window's own output rows.
struct RowPos {
  int line, s;
  bool in_line, own;
};

__device__ __forceinline__ RowPos row_pos(const Lines& ln, const Windows& wi, int R) {
  RowPos rp;
  const int j = R / wi.L, u = R - j * wi.L;
  const int w = blockIdx.x * wi.nl + j;
  const bool exists = j < wi.nl && w < wi.count;
  rp.line = exists ? w / wi.per_line : 0;
  const int s0 = exists ? (w - rp.line * wi.per_line) * wi.Sw : 0;
  const int sw = min(wi.Sw, ln.S - s0);
  rp.s = s0 + u - wi.halo;
  rp.in_line = exists && rp.s >= 0 && rp.s < ln.S;
  rp.own = exists && u >= wi.halo && u < wi.halo + sw;
  return rp;
}

// Whether any row of 16-row tile mt lies within `ext` rows of a window's own
// rows: the rows a step of the chain must compute (ext 0 for the outputs).
__device__ __forceinline__ bool tile_needed(const Lines& ln, const Windows& wi, int mt,
                                            int ext) {
  for (int R = mt * kTile; R < mt * kTile + kTile; ++R) {
    const int j = R / wi.L, u = R - j * wi.L;
    const int w = blockIdx.x * wi.nl + j;
    if (j >= wi.nl || w >= wi.count) continue;
    const int s0 = w % wi.per_line * wi.Sw;
    const int sw = min(wi.Sw, ln.S - s0);
    if (u >= wi.halo - ext && u < wi.halo + sw + ext) return true;
  }
  return false;
}

// Matrix layouts of a tile operand: element (i, j) of a row-major matrix is
// p[i*ld + j], of a column-major one p[i + j*ld].
struct RowMajor {
  using wmma_layout = nvcuda::wmma::row_major;
  template <typename T> static __device__ __forceinline__ T at(const T* p, int ld, int i, int j) {
    return p[(int64_t)i * ld + j];
  }
};
struct ColMajor {
  using wmma_layout = nvcuda::wmma::col_major;
  template <typename T> static __device__ __forceinline__ T at(const T* p, int ld, int i, int j) {
    return p[i + (int64_t)j * ld];
  }
};

// One warp's 16x16 fp32 accumulator tile: acc += A B, A 16x16 (layout LA),
// B 16x16 (layout LB). bf16: a wmma 16x16x16 product on the tensor cores
// (operand pointers 32-byte aligned, ld a multiple of 8). fp32: plain FMA in
// fp32 (never TF32); lane l owns row l/2, columns (l%2)*8 .. +8.
template <typename T> struct Tile;

template <> struct Tile<__nv_bfloat16> {
  using T = __nv_bfloat16;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> acc;
  __device__ __forceinline__ void zero() { nvcuda::wmma::fill_fragment(acc, 0.0f); }
  template <typename LA, typename LB>
  __device__ __forceinline__ void mma(const T* a, int lda, const T* b, int ldb) {
    using namespace nvcuda;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, T, typename LA::wmma_layout> fa;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, T, typename LB::wmma_layout> fb;
    wmma::load_matrix_sync(fa, a, lda);
    wmma::load_matrix_sync(fb, b, ldb);
    wmma::mma_sync(acc, fa, fb, acc);
  }
  // A B operand loaded once and used against several A tiles.
  template <typename LB>
  using Bfrag = nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16, T,
                                       typename LB::wmma_layout>;
  template <typename LB>
  static __device__ __forceinline__ void load_b(Bfrag<LB>& f, const T* b, int ldb) {
    nvcuda::wmma::load_matrix_sync(f, b, ldb);
  }
  template <typename LA, typename LB>
  __device__ __forceinline__ void mma_b(const T* a, int lda, const Bfrag<LB>& fb) {
    nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16, T, typename LA::wmma_layout> fa;
    nvcuda::wmma::load_matrix_sync(fa, a, lda);
    nvcuda::wmma::mma_sync(acc, fa, fb, acc);
  }
  // Store as a row-major 16x16 fp32 tile with leading dimension ld.
  __device__ __forceinline__ void store(float* p, int ld) {
    nvcuda::wmma::store_matrix_sync(p, acc, ld, nvcuda::wmma::mem_row_major);
  }
};

template <> struct Tile<float> {
  using T = float;
  float acc[8];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.0f;
  }
  template <typename LA, typename LB>
  __device__ __forceinline__ void mma(const T* a, int lda, const T* b, int ldb) {
    const int lane = threadIdx.x & 31, row = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float av = LA::at(a, lda, row, k);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = fmaf(av, LB::at(b, ldb, k, c0 + j), acc[j]);
    }
  }
  // fp32 "fragments" are the operand's address: each lane reads what it
  // needs in mma.
  template <typename LB> struct Bfrag {
    const T* p;
    int ld;
  };
  template <typename LB>
  static __device__ __forceinline__ void load_b(Bfrag<LB>& f, const T* b, int ldb) {
    f.p = b;
    f.ld = ldb;
  }
  template <typename LA, typename LB>
  __device__ __forceinline__ void mma_b(const T* a, int lda, const Bfrag<LB>& fb) {
    mma<LA, LB>(a, lda, fb.p, fb.ld);
  }
  __device__ __forceinline__ void store(float* p, int ld) {
    const int lane = threadIdx.x & 31, row = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) p[(int64_t)row * ld + c0 + j] = acc[j];
  }
};

// Shared-memory rows of the activation buffers are padded by kPad elements
// in bf16, which spreads a fragment's rows over the banks (a 256-byte row
// stride puts all eight on the same bank) and keeps every row 32-byte
// aligned, as wmma wants.
template <typename T> constexpr int kPad = sizeof(T) == 2 ? 16 : 0;

// Weight slabs for `conv_block`: a ring of kStages<T> stages, each holding
// kSlabTiles 16-row weight tiles of kWarps column tiles, row major
// [16 kSlabTiles][kSlabCols + 8] for forward taps or column major
// [kSlabCols][16 kSlabTiles + 8] for transposed taps.
constexpr int kSlabTiles = 2;
constexpr int kSlabCols = kWarps * kTile;
constexpr int kSlabRows = kSlabTiles * kTile;
constexpr int kSlabLdRow = kSlabCols + 8, kSlabLdCol = kSlabRows + 8;
constexpr int kSlabElems = kSlabCols * kSlabLdCol;    // >= kSlabRows * kSlabLdRow
template <typename T> constexpr int kStages = sizeof(T) == 2 ? 3 : 2;
template <typename T> constexpr int slab_bytes() { return kStages<T> * kSlabElems * sizeof(T); }

// The 5-tap conv of one round of column tiles over the row tiles in `need`
// (bit mt: rows 16 mt .. 16 mt + 15), as products, by the whole block: warp
// w owns output columns n0 + 16 w .. + 15 when `active` (n0 + 16 w below
// n0 + n_cols), and acc[mt] += sum_k sum_kc A[rows 16 mt - 2 + k, cols a_col
// + 16 kc] W_k[...], with A in shared memory (row major, lda) and weight tap
// k at w + k*w_tap_stride in global memory. The block copies the weight
// tiles of its columns into `slab` with cp.async, kSlabTiles 16-row tiles a
// step and kStages - 1 steps ahead of the step the warps multiply; one
// barrier a step. Forward taps (kTranspose false): W_k row major [K x N],
// element (c, o) at w_k[c*ldw + o], rows w_k0 + 16 kc + (0..15). Transposed
// taps (the input gradient): tap k pairs with W_{4-k} read column major,
// element (o, c) at w_{4-k}[c*ldw + o], so acc gets
// sum_o da[R + k - 2, o] W[4-k][c, o]. Every thread of the block calls it
// with the same arguments but acc and active; the caller's barrier has made
// A ready.
template <typename T, bool kTranspose, int kMaxMT>
__device__ __forceinline__ void conv_block(Tile<T> (&acc)[kMaxMT], unsigned need, bool active,
                                           const T* a, int lda, int a_col, int k_tiles,
                                           const T* w, int64_t w_tap_stride, int ldw, int w_k0,
                                           int n0, int n_cols, T* slab) {
  using LB = typename std::conditional<kTranspose, ColMajor, RowMajor>::type;
  constexpr int V = 16 / sizeof(T);                       // elements a 16-byte copy
  constexpr int kItems = kSlabRows * kSlabCols / V / kThreads;
  constexpr int S = kStages<T>;
  static_assert(kItems * V * kThreads == kSlabRows * kSlabCols, "slab items");
  const int groups = (k_tiles + kSlabTiles - 1) / kSlabTiles;
  const int steps = kTaps * groups;
  const int warp = threadIdx.x >> 5;
  auto issue = [&](int step) {
    if (step < steps) {
      const int k = step / groups, kc0 = (step - k * groups) * kSlabTiles;
      const int rows = min(kSlabTiles, k_tiles - kc0) * kTile;
      T* dst = slab + (step % S) * kSlabElems;
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int i = threadIdx.x + j * kThreads;
        int r, c;
        if constexpr (kTranspose) {
          c = i / (kSlabRows / V);
          r = i % (kSlabRows / V) * V;
        } else {
          r = i / (kSlabCols / V);
          c = i % (kSlabCols / V) * V;
        }
        if (c >= n_cols || r >= rows) continue;
        const T* src;
        if constexpr (kTranspose)
          src = w + (kTaps - 1 - k) * w_tap_stride + (int64_t)(n0 + c) * ldw + w_k0 +
                kc0 * kTile + r;
        else
          src = w + k * w_tap_stride + (int64_t)(w_k0 + kc0 * kTile + r) * ldw + n0 + c;
        __pipeline_memcpy_async(dst + (kTranspose ? c * kSlabLdCol + r : r * kSlabLdRow + c),
                                src, 16);
      }
    }
    __pipeline_commit();          // one group a step, empty past the end
  };
  for (int i = 0; i < S - 1; ++i) issue(i);
  for (int step = 0; step < steps; ++step) {
    __pipeline_wait_prior(S - 2);  // this thread's copies for `step` are done
    __syncthreads();               // everyone's are, and step - 1 is multiplied
    issue(step + S - 1);           // into the stage step - 1 used
    if (!active) continue;
    const int k = step / groups, kc0 = (step - k * groups) * kSlabTiles;
    const T* stage = slab + (step % S) * kSlabElems;
    for (int t = 0; t < kSlabTiles && kc0 + t < k_tiles; ++t) {
      const T* bs = kTranspose ? stage + warp * kTile * kSlabLdCol + t * kTile
                               : stage + t * kTile * kSlabLdRow + warp * kTile;
      typename Tile<T>::template Bfrag<LB> fb;
      Tile<T>::template load_b<LB>(fb, bs, kTranspose ? kSlabLdCol : kSlabLdRow);
      const T* ak = a + (int64_t)(k - 2) * lda + a_col + (kc0 + t) * kTile;
#pragma unroll
      for (int mt = 0; mt < kMaxMT; ++mt)
        if (need >> mt & 1u)
          acc[mt].template mma_b<RowMajor, LB>(ak + (int64_t)mt * kTile * lda, lda, fb);
    }
  }
  __pipeline_wait_prior(0);
  __syncthreads();                 // the slab is free for the next call
}

// The row tiles of a block that lie within `ext` rows of a window's own rows.
__device__ __forceinline__ unsigned tiles_needed(const Lines& ln, const Windows& wi,
                                                 int ext) {
  unsigned need = 0;
  for (int mt = 0; mt < wi.M / kTile; ++mt)
    if (tile_needed(ln, wi, mt, ext)) need |= 1u << mt;
  return need;
}

// Shared-memory budget a block asks for (dynamic, above the 48 KB default).
constexpr int kSmemBudget = 220 * 1024;

// Rows a block may hold for `row_bytes` per row and `fixed` bytes besides,
// rounded down to the 16-row tile and capped at `cap`.
inline int max_rows_for(int64_t row_bytes, int64_t fixed, int cap) {
  int64_t rows = (kSmemBudget - fixed) / row_bytes - 4;
  rows = rows / kTile * kTile;
  return (int)(rows < cap ? rows : cap);
}

}  // namespace gru_pass
