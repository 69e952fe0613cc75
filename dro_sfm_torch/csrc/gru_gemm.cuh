// The tile engine of the GRU backward kernels (gru_pass_bwd.cu): a block
// computes fp32 tiles of five-tap products, C = sum over taps k and K of
// A(k) B(k), where A(k) is a staged A shifted by k rows, as a chain of K
// steps. A ring of shared-memory stages is filled by cp.async (16 bytes a
// copy, zero-filled where the caller marks a chunk invalid, so an implicit
// GEMM needs no padded copy of its operands) while the warps multiply the
// stage before; one barrier a step.
//
// The rows of a tile are pixels taken as segments of 2^seg_shift positions
// of a line (8, 16 or 32). A stage holds A with two more rows either side
// of each segment (zero past the line's ends), so that tap k of the tile's
// row j reads A row tap_row(j) + k, and one staged A serves all five taps.
// Two tile shapes:
// - `stage_product`: a 128 x 64 block tile of pixels x outputs over four
//   warps, 2 x 2, each owning a 64 x 32 warp tile; A row major [row][k]
//   (k contiguous), five B taps, each row major [k][n] or column major
//   [n][k]; K steps of 64 bytes.
// - `tap_product`: one warp a tap of a weight product, whose K runs over the
//   pixels; each warp owns 64 x 64 outputs. A column major [row][m] (m
//   contiguous), B row major [k][n].
// bf16: ldmatrix and mma.sync m16n8k16 with fp32 accumulators, each A
// fragment used against four or eight B fragments and each B fragment
// against four A fragments. fp32: FMA in fp32 (never TF32) over the same
// elements, so the epilogues are shared: accumulator element e of tile
// (i, j) lies at row wm0 + 16 i + g + 8 (e / 2) and column wn0 + 8 j + 2 t +
// (e % 2) of the block tile, g = lane / 4, t = lane % 4. Every staged row is
// padded by 16 bytes, which puts ldmatrix's eight row addresses on distinct
// banks.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace gru_gemm {

constexpr int kTaps = 5;
constexpr int kThreads = 128;              // 4 warps
constexpr int kBM = 128, kBN = 64;         // block tile
constexpr int kWM = 64, kWN = 32;          // warp tile
constexpr int kStages = 4;                 // `stage_product`'s ring of B stages
constexpr int kTapStages = 4;              // `tap_product`'s ring
constexpr int kKStepBytes = 64;            // `stage_product`'s K step: 32 bf16 or 16 fp32
// The blocks an SM that `stage_product`'s kernels cut their register budget
// for. GRU_GEMM_SKIP_COPIES / GRU_GEMM_SKIP_PRODUCTS leave the main loop's
// copies after the first stages, or its products, out: wrong results, for
// timing the two apart only. tools/torch_gru_k6_tiles.py builds with these.
#ifndef GRU_GEMM_MIN_BLOCKS
#define GRU_GEMM_MIN_BLOCKS 4
#endif
constexpr int kMinBlocks = GRU_GEMM_MIN_BLOCKS;

// The stage row of a tile's row j (`tap_product`: K index j) for tap 0.
__device__ __forceinline__ int tap_row(int j, int seg_shift) {
  return (j >> seg_shift) * ((1 << seg_shift) + 4) + (j & ((1 << seg_shift) - 1));
}

// `stage_product`'s operands: an A slot [a_rows][LDA] holds a chunk of BK
// channels of the tile's rows, a B stage (B_TAP elements) one tap's weights.
template <typename T, bool kBCol>
struct Layout {
  static constexpr int V = 16 / (int)sizeof(T);   // elements of a 16-byte chunk
  static constexpr int BK = kKStepBytes / (int)sizeof(T);
  static constexpr int CPR = BK / V;               // chunks of a K row
  static constexpr int LDA = BK + V;
  static constexpr int LDB = kBCol ? BK + V : kBN + V;
  static constexpr int B_TAP = kBCol ? kBN * LDB : BK * LDB;
  static constexpr int MAX_A_ROWS = kBM + 4 * (kBM / 8);     // segments of 8
  static __host__ __device__ int a_rows(int seg_shift) { return kBM + 4 * (kBM >> seg_shift); }
  static __host__ __device__ int a_elems(int seg_shift) { return a_rows(seg_shift) * LDA; }
  static __host__ __device__ int bytes(int seg_shift) {
    return (2 * a_elems(seg_shift) + kStages * B_TAP) * (int)sizeof(T);
  }
  static __device__ __forceinline__ int b_off(int k, int n) {
    return kBCol ? n * LDB + k : k * LDB + n;
  }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A thread's accumulators of a 64 x 8 kNT warp tile: [m16 tile][n8 tile][element].
template <int kNT>
struct AccN {
  float v[4][kNT][4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) v[i][j][e] = 0.0f;
  }
};
using Acc = AccN<4>;

struct WarpPos {
  int wm0, wn0, g, t;
};
__device__ __forceinline__ WarpPos warp_pos() {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return {(w >> 1) * kWM, (w & 1) * kWN, lane >> 2, lane & 3};
}

// Eight B fragments' worth of a row-major [k][n] B at (k0, n): b[2 jp + h]
// for n8 tiles n + 16 jp + 8 h.
template <int kNT>
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[kNT][2], const __nv_bfloat16* Bs,
                                            int ldb, int k0, int n) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int jp = 0; jp < kNT / 2; ++jp) {
    uint32_t r[4];
    ldsm_x4_t(r, Bs + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ldb + n + 16 * jp +
                     (lane >> 4) * 8);
    b[2 * jp][0] = r[0];
    b[2 * jp][1] = r[1];
    b[2 * jp + 1][0] = r[2];
    b[2 * jp + 1][1] = r[3];
  }
}

// This thread's A offsets in a `stage_product` stage for tap 0 (the tap's
// row shift is the caller's): bf16, off[i] for ldmatrix of m16 tile i; fp32,
// off[2 i + hh] for rows g + 8 hh of m16 tile i.
template <typename T, bool kBCol>
__device__ __forceinline__ void stage_offsets(int (&off)[8], int seg_shift) {
  using L = Layout<T, kBCol>;
  const WarpPos w = warp_pos();
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      off[2 * i + hh] =
          sizeof(T) == 2
              ? tap_row(w.wm0 + 16 * i + (lane & 15), seg_shift) * L::LDA + (lane >> 4) * 8
              : tap_row(w.wm0 + 16 * i + w.g + 8 * hh, seg_shift) * L::LDA;
}

// acc += one tap of a stage: A row major [row][k], already shifted by the
// tap's rows (`stage_offsets`), B row major [k][n] or column major [n][k].
template <bool kBCol>
__device__ __forceinline__ void stage_product(Acc& acc, const __nv_bfloat16* As,
                                              const __nv_bfloat16* Bs, const int (&off)[8]) {
  using L = Layout<__nv_bfloat16, kBCol>;
  const WarpPos w = warp_pos();
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k0 = 0; k0 < L::BK; k0 += 16) {
    uint32_t a[4][4], b[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) ldsm_x4(a[i], As + off[2 * i] + k0);
    if (kBCol) {
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t r[4];
        ldsm_x4(r, Bs + L::b_off(k0 + ((lane >> 3) & 1) * 8,
                                 w.wn0 + 16 * jp + (lane & 7) + (lane >> 4) * 8));
        b[2 * jp][0] = r[0];
        b[2 * jp][1] = r[1];
        b[2 * jp + 1][0] = r[2];
        b[2 * jp + 1][1] = r[3];
      }
    } else {
      load_b_rows<4>(b, Bs, L::LDB, k0, w.wn0);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_bf16(acc.v[i][j], a[i], b[j][0], b[j][1]);
  }
}

template <bool kBCol>
__device__ __forceinline__ void stage_product(Acc& acc, const float* As, const float* Bs,
                                              const int (&off)[8]) {
  using L = Layout<float, kBCol>;
  const WarpPos w = warp_pos();
#pragma unroll 4
  for (int k = 0; k < L::BK; ++k) {
    float a[4][2], b[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) a[i][hh] = As[off[2 * i + hh] + k];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) b[j][e] = Bs[L::b_off(k, w.wn0 + 8 * j + 2 * w.t + e)];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc.v[i][j][e] = fmaf(a[i][e >> 1], b[j][e & 1], acc.v[i][j][e]);
  }
}

// acc += this warp's tap of a staged five-tap tile: A column major [row][m]
// (64 m, lda), B row major [k][n] (64 n, ldb), kBK K rows.
template <int kBK>
__device__ __forceinline__ void tap_product(AccN<8>& acc, const __nv_bfloat16* As,
                                            const __nv_bfloat16* Bs, int lda, int ldb, int tap,
                                            int seg_shift) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k0 = 0; k0 < kBK; k0 += 16) {
    uint32_t a[4][4], b[8][2];
    const __nv_bfloat16* ar =
        As + (tap_row(k0 + (lane & 7) + (lane >> 4) * 8, seg_shift) + tap) * lda +
        ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int i = 0; i < 4; ++i) ldsm_x4_t(a[i], ar + 16 * i);
    load_b_rows<8>(b, Bs, ldb, k0, 0);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) mma_bf16(acc.v[i][j], a[i], b[j][0], b[j][1]);
  }
}

template <int kBK>
__device__ __forceinline__ void tap_product(AccN<8>& acc, const float* As, const float* Bs,
                                            int lda, int ldb, int tap, int seg_shift) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int k = 0; k < kBK; ++k) {
    const float* ar = As + (tap_row(k, seg_shift) + tap) * lda;
    float a[4][2], b[8][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) a[i][hh] = ar[16 * i + g + 8 * hh];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) b[j][e] = Bs[k * ldb + 8 * j + 2 * t + e];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc.v[i][j][e] = fmaf(a[i][e >> 1], b[j][e & 1], acc.v[i][j][e]);
  }
}

// The ring of kS stages: `load(step)` starts this thread's cp.async copies of
// step `step`, `product(step)` multiplies a landed one; kS - 1 steps are in
// flight ahead of the one being multiplied. Ends with every copy landed and
// a barrier, so the caller may reuse the shared memory.
template <int kS, class Load, class Product>
__device__ __forceinline__ void ring(int steps, const Load& load, const Product& product) {
#pragma unroll
  for (int s = 0; s < kS - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kS - 2>();   // this thread's copies of `step` landed
    __syncthreads();           // everyone's did, and step - 1 is multiplied
#ifndef GRU_GEMM_SKIP_COPIES
    if (step + kS - 1 < steps) load(step + kS - 1);
#endif
    cp_async_commit();
#ifndef GRU_GEMM_SKIP_PRODUCTS
    product(step);
#endif
  }
  cp_async_wait<0>();
  __syncthreads();
}

// The K loop of a conv (`stage_product`) over `chunks` channel chunks, tap
// by tap: step = 5 chunk + tap. Shared memory holds two A slots (chunk c in
// slot c % 2, copied with its tap 0) and a ring of kStages B stages (one
// tap's each); load_a(chunk, As) and load_b(chunk, tap, Bs) start the
// copies. A slot is copied again only after the five steps that read it
// (kStages - 1 <= kTaps).
template <typename T, bool kBCol, class LoadA, class LoadB>
__device__ __forceinline__ void mainloop(Acc& acc, T* smem, int chunks, int seg_shift,
                                         const LoadA& load_a, const LoadB& load_b) {
  using L = Layout<T, kBCol>;
  static_assert(kStages - 1 <= kTaps, "an A slot would be copied while in use");
  const int a_elems = L::a_elems(seg_shift);
  T* const Bs = smem + 2 * a_elems;
  int off[8];
  stage_offsets<T, kBCol>(off, seg_shift);
  ring<kStages>(
      kTaps * chunks,
      [&](int step) {
        const int c = step / kTaps, tap = step - c * kTaps;
        if (tap == 0) load_a(c, smem + (c & 1) * a_elems);
        load_b(c, tap, Bs + (step % kStages) * L::B_TAP);
      },
      [&](int step) {
        const int c = step / kTaps, tap = step - c * kTaps;
        stage_product<kBCol>(acc, smem + (c & 1) * a_elems + tap * L::LDA,
                             Bs + (step % kStages) * L::B_TAP, off);
      });
}

// f(j, row, col, v0, v1) for each pair of this thread's accumulators
// (columns col and col + 1 of n8 tile j) of a warp tile at (wm0, wn0), rows
// in a fixed order.
template <int kNT, class F>
__device__ __forceinline__ void for_each_pair(const AccN<kNT>& acc, int wm0, int wn0, F f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
        f(j, wm0 + 16 * i + g + 8 * hh, wn0 + 8 * j + 2 * t, acc.v[i][j][2 * hh],
          acc.v[i][j][2 * hh + 1]);
}

template <class F>
__device__ __forceinline__ void for_each_pair(const Acc& acc, F f) {
  const WarpPos w = warp_pos();
  for_each_pair(acc, w.wm0, w.wn0, f);
}

// Column sums over the block's rows of values a thread has summed over its
// own rows, cs[j][e] for column wn0 + 8 j + 2 t + e, in a fixed order (lanes
// of one column by a butterfly, then the two warps of a column through
// `red`, 2 kBN floats of shared memory): out[c] for block columns c with
// n0 + c < n_valid. Every thread calls it.
__device__ __forceinline__ void block_column_sums(float (&cs)[4][2], float* red, float* out,
                                                  int n0, int n_valid) {
  const WarpPos w = warp_pos();
  const int wm = (threadIdx.x >> 5) >> 1;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = cs[j][e];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (w.g == 0) red[wm * kBN + w.wn0 + 8 * j + 2 * w.t + e] = v;
    }
  __syncthreads();
  for (int c = threadIdx.x; c < kBN; c += kThreads)
    if (n0 + c < n_valid) out[n0 + c] = red[c] + red[kBN + c];
  __syncthreads();
}

}  // namespace gru_gemm
