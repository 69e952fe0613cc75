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
// the transpose of the sampling. The TPU kernel built the [P, h*w]
// tent-weight strip in VMEM and contracted it on the MXU, revisiting one
// output block across the grid in sequence. Hopper's blocks run in no
// order, so a scatter would need atomics and their order changes from run
// to run; here each output pixel gathers its contributors in a fixed order,
// two launches:
//   tent_warp_bwd_feat_plan    one block a view buckets its pixels by the
//                              cell of their top-left tap (y0, x0), y0 in
//                              [-1, h-1], x0 in [-1, w-1], ascending p in a
//                              bucket: integer counts (atomics on ints in
//                              shared memory, the same counts in any order),
//                              their exclusive scan, then a stable fill,
//                              1024 pixels at a time sorted by (cell, p);
//                              each slot gets the pixel and its four tap
//                              weights (make_taps, times sign);
//   tent_warp_bwd_feat_gather  one 16-lane group an output pixel q = (y, x)
//                              walks the four cells that have q as a tap, in
//                              the plain version's order: (y, x) as tap 0,
//                              (y, x-1) as tap 1, (y-1, x) as tap 2,
//                              (y-1, x-1) as tap 3, each bucket in ascending
//                              p, sums sign (w g) in fp32 registers and
//                              writes every output element once, in the
//                              output's dtype.
// The same inputs give the same bits, and the fp32 sums of lists of up to
// kLong entries repeat the plain version's order on the CPU (index_add_ tap
// by tap, ascending p). g and the output have dtypes of their own (the bare
// warp's cotangent is fp32 beside bf16 features). The gather takes its four
// buckets as one list, 16 entries at a time one a lane, and keeps the g rows
// of 4 entries in flight. A warp that collapses into one cell puts all P
// pixels of a view into one bucket; a list longer than kLong is split into
// equal ranges across the block's groups, whose partial sums its owner adds
// in group order.
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
// bf16): about 16 MB, 4.8 us at 3.35 TB/s; its plan (0.7 MB) and the
// gather's four reads of each g row (one a tap) stay in the 50 MB L2. K3
// reads g, the feature rows the taps reference (up to 7.86 MB) and coords,
// and writes 0.25 MB: also about 16 MB.
#include "tent_warp_common.cuh"

#include <type_traits>

namespace {

using namespace tent_warp;

constexpr int kPlanThreads = 1024;            // 32 warps: `block_scan` wants them all
constexpr unsigned kNoCell = 0xffffffffu;      // the key of a pixel with no tap in view

// The bucket of a pixel with taps tp: the cell of its top-left tap,
// (y0 + 1)(w + 1) + x0 + 1, or kNoCell when none of its four taps is in view.
__device__ __forceinline__ unsigned cell_key(const Taps& tp, int w) {
  if (!(tp.ok[0] || tp.ok[1] || tp.ok[2] || tp.ok[3])) return kNoCell;
  return (unsigned)((tp.y0 + 1) * (w + 1) + tp.x0 + 1);
}

// Inclusive prefix sum of v over the block's kPlanThreads threads; total:
// the sum over all. Every thread calls it.
__device__ __forceinline__ int block_scan(int v, int* warp_sums, int& total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += y;
  }
  if (lane == 31) warp_sums[wid] = v;
  __syncthreads();
  if (wid == 0) {
    int s = warp_sums[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    warp_sums[lane] = s;
  }
  __syncthreads();
  v += wid ? warp_sums[wid - 1] : 0;
  total = warp_sums[31];
  __syncthreads();                       // warp_sums is free again
  return v;
}

// Sorts the block's kPlanThreads keys, one a thread, ascending (bitonic):
// thread t ends with the key of rank t. Exchanges within a warp go by
// shuffles, across warps through `buf` (two buffers, one barrier a step).
__device__ __forceinline__ unsigned long long block_sort(unsigned long long key,
                                                         unsigned long long (*buf)[kPlanThreads]) {
  const int t = threadIdx.x;
  int b = 0;
  for (int kk = 2; kk <= kPlanThreads; kk <<= 1) {
    for (int j = kk >> 1; j > 0; j >>= 1) {
      unsigned long long other;
      if (j >= 32) {
        buf[b][t] = key;
        __syncthreads();
        other = buf[b][t ^ j];
        b ^= 1;
      } else {
        other = __shfl_xor_sync(0xffffffffu, key, j);
      }
      const bool lower = key < other;
      key = (((t & kk) == 0) == ((t & j) == 0)) == lower ? key : other;
    }
  }
  return key;
}

// K2's plan of view blockIdx.x (kPlanThreads threads): idx [P] its in-view
// pixels bucket by bucket, ascending p in a bucket, and wts [P] each one's
// four tap weights times sign; starts [ncells + 1] the buckets' bounds.
// `cursor` holds the counts, then the next free slot of each bucket: the
// block's dynamic shared memory where ncells ints fit there, else the
// view's [ncells] of cursor_all.
__global__ void __launch_bounds__(kPlanThreads)
tent_warp_bwd_feat_plan(const float* __restrict__ coords, int P, int h, int w, float sign,
                        bool cursor_in_smem, float4* __restrict__ wts_all,
                        int* __restrict__ idx_all, int* __restrict__ starts_all,
                        int* __restrict__ cursor_all) {
  extern __shared__ int smem_cursor[];
  __shared__ unsigned long long buf[2][kPlanThreads], sorted[kPlanThreads];
  __shared__ float4 chunk_wts[kPlanThreads];
  __shared__ int warp_sums[32];
  const int t = threadIdx.x, ncells = (h + 1) * (w + 1);
  const float2* co = reinterpret_cast<const float2*>(coords) + (int64_t)blockIdx.x * P;
  float4* wts = wts_all + (int64_t)blockIdx.x * P;
  int* idx = idx_all + (int64_t)blockIdx.x * P;
  int* starts = starts_all + (int64_t)blockIdx.x * (ncells + 1);
  int* cursor = cursor_in_smem ? smem_cursor : cursor_all + (int64_t)blockIdx.x * ncells;

  for (int i = t; i < ncells; i += kPlanThreads) cursor[i] = 0;
  __syncthreads();
  for (int p = t; p < P; p += kPlanThreads) {
    const unsigned k = cell_key(make_taps(__ldg(co + p), 0, h, w, 0), w);
    if (k != kNoCell) atomicAdd(cursor + k, 1);
  }
  __syncthreads();
  int run = 0;                           // the counts of the cells before i0
  for (int i0 = 0; i0 <= ncells; i0 += kPlanThreads) {
    const int i = i0 + t;
    const int v = i < ncells ? cursor[i] : 0;
    int total;
    const int start = run + block_scan(v, warp_sums, total) - v;
    if (i <= ncells) starts[i] = start;
    if (i < ncells) cursor[i] = start;
    run += total;
  }
  __syncthreads();
  for (int p0 = 0; p0 < P; p0 += kPlanThreads) {
    unsigned k = kNoCell;
    if (p0 + t < P) {
      const Taps tp = make_taps(__ldg(co + p0 + t), 0, h, w, 0);
      k = cell_key(tp, w);
      chunk_wts[t] = make_float4(sign * tp.wt[0], sign * tp.wt[1], sign * tp.wt[2],
                                 sign * tp.wt[3]);
    }
    const unsigned long long key = block_sort((unsigned long long)k << 32 | (unsigned)t, buf);
    sorted[t] = key;
    __syncthreads();
    const unsigned cell = (unsigned)(key >> 32);
    int first = t;                       // the cell's first position in the sorted chunk
    if (cell != kNoCell) {
      int lo = 0;
      while (lo < first) {
        const int mid = (lo + first) >> 1;
        if ((unsigned)(sorted[mid] >> 32) < cell) lo = mid + 1; else first = mid;
      }
      const int u = (int)(key & 0xffffffffu), slot = cursor[cell] + t - first;
      idx[slot] = p0 + u;
      wts[slot] = chunk_wts[u];
    }
    __syncthreads();                     // every slot of this chunk taken
    if (cell != kNoCell && (t == kPlanThreads - 1 || (unsigned)(sorted[t + 1] >> 32) != cell))
      cursor[cell] += t - first + 1;
    __syncthreads();
  }
}

// K2's gather (see the top of the file). An output pixel's list: its four
// buckets as one list, tap 0's entries first.
constexpr int kAhead = 4;                      // g rows in flight a group
constexpr int kGroups = kBlock / kGroup;       // output pixels a block
constexpr int kLong = 64;                      // longer lists are split

struct List {
  int s[4], n[4], total;                       // the buckets' first slots and lengths
  int64_t view;
  // Entry j: (pixel, sign * its weight at the output's tap), or (0, 0) past
  // the end.
  __device__ __forceinline__ void entry(int j, const int* idx_all, const float* wts_all, int P,
                                        int& p, float& wt) const {
    p = 0;
    wt = 0.0f;
    if (j >= total) return;
    int tap = 0, slot = s[0] + j;
    if (j >= n[0]) { j -= n[0]; tap = 1; slot = s[1] + j; }
    if (tap == 1 && j >= n[1]) { j -= n[1]; tap = 2; slot = s[2] + j; }
    if (tap == 2 && j >= n[2]) { j -= n[2]; tap = 3; slot = s[3] + j; }
    const int64_t at = view * P + slot;
    p = __ldg(idx_all + at);
    wt = __ldg(wts_all + 4 * at + tap);
  }
};

// acc[0, N) = the sum, in list order, of sign * w g over entries [lo, hi)
// of L at this lane's channels [ch, ch + N) (a lane with active false only
// takes part in the shuffles). kGroup entries at a time are loaded one a
// lane, then taken kAhead at a time, the g rows of those in flight together;
// (p_lo, w_lo): this lane's entry of the first kGroup, loaded by the caller
// once for all channels.
template <typename VG, int N, typename TG>
__device__ __forceinline__ void walk(const List& L, int lo, int hi, int p_lo, float w_lo,
                                     const TG* g, int P, int C, int ch, bool active,
                                     const int* idx_all, const float* wts_all, float* acc) {
  const int lane = threadIdx.x % kGroup;
  const unsigned group = 0xffffu << (threadIdx.x & kGroup);
  const TG* gb = g + L.view * P * (int64_t)C;
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.0f;
  for (int j0 = lo; j0 < hi; j0 += kGroup) {
    int pj = p_lo;
    float wj = w_lo;
    if (j0 != lo) L.entry(j0 + lane < hi ? j0 + lane : L.total, idx_all, wts_all, P, pj, wj);
    const int m = min(kGroup, hi - j0);
    for (int u0 = 0; u0 < m; u0 += kAhead) {       // u0 + kAhead <= kGroup
      int pu[kAhead];
      float wu[kAhead], gv[kAhead][N];
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        pu[k] = __shfl_sync(group, pj, u0 + k, kGroup);
        wu[k] = __shfl_sync(group, wj, u0 + k, kGroup);
      }
      if (!active) continue;
#pragma unroll
      for (int k = 0; k < kAhead; ++k)
        if (u0 + k < m) {
#pragma unroll
          for (int i = 0; i < N; i += VG::N)
            VG::load(gb + (int64_t)pu[k] * C + ch + i, gv[k] + i);
        }
#pragma unroll
      for (int k = 0; k < kAhead; ++k)
        if (u0 + k < m) {
#pragma unroll
          for (int i = 0; i < N; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(wu[k], gv[k][i]));
        }
    }
  }
}

// TG: g's type, TO: the output's; kVec: 16-byte loads and stores, N
// channels a lane a step. A block's kGroups groups each own one output
// pixel; a list of up to kLong entries its group sums alone. A longer one
// (a warp that crowds many pixels into a cell) the whole block sums after
// its short lists, one at a time: group i takes the i-th of kGroups equal
// ranges of entries, then the owner adds the kGroups partial sums in group
// order. The order depends on the list alone, so the bits do too. At least
// 3 blocks an SM (80 registers a thread): the gather is latency-bound, and
// the long path's registers would otherwise cost the short lists a block.
template <typename TG, typename TO, bool kVec>
__global__ void __launch_bounds__(kBlock, 3)
tent_warp_bwd_feat_gather(const TG* __restrict__ g, TO* __restrict__ out,
                          const float* __restrict__ wts_all, const int* __restrict__ idx_all,
                          const int* __restrict__ starts_all, int64_t n_out, int P, int h,
                          int w, int C) {
  using VG = typename std::conditional<kVec, Vec<TG>, Scalar<TG>>::type;
  using VO = typename std::conditional<kVec, Vec<TO>, Scalar<TO>>::type;
  constexpr int N = VG::N > VO::N ? VG::N : VO::N;
  __shared__ List lists[kGroups];
  __shared__ float part[kGroups][kGroup * N];
  const int grp = threadIdx.x / kGroup, lane = threadIdx.x % kGroup;
  const int64_t q = (int64_t)blockIdx.x * kGroups + grp;
  List L = {};                           // empty past the last output pixel
  if (q < n_out) {
    L.view = q / ((int64_t)h * w);
    const int yx = (int)(q - L.view * h * w), y = yx / w, x = yx - y * w;
    const int* starts = starts_all + L.view * ((h + 1) * (w + 1) + 1);
    const int c0 = (y + 1) * (w + 1) + x + 1;          // cell (y, x): q is its tap 0
#pragma unroll
    for (int tap = 0; tap < 4; ++tap) {
      const int c = tap == 0 ? c0 : tap == 1 ? c0 - 1 : tap == 2 ? c0 - (w + 1) : c0 - (w + 2);
      L.s[tap] = __ldg(starts + c);
      L.n[tap] = __ldg(starts + c + 1) - L.s[tap];
    }
    L.total = L.n[0] + L.n[1] + L.n[2] + L.n[3];
  }
  float acc[N];
  int p_lo;
  float w_lo;
  if (q < n_out && L.total <= kLong) {
    L.entry(lane, idx_all, wts_all, P, p_lo, w_lo);
    for (int ch0 = 0; ch0 < C; ch0 += kGroup * N) {
      const int ch = ch0 + lane * N;
      walk<VG, N>(L, 0, L.total, p_lo, w_lo, g, P, C, ch, ch < C, idx_all, wts_all, acc);
      if (ch < C) {
#pragma unroll
        for (int i = 0; i < N; i += VO::N) VO::store(out + q * C + ch + i, acc + i);
      }
    }
  }
  if (!__syncthreads_or(L.total > kLong)) return;      // the whole block
  if (lane == 0) lists[grp] = L;
  __syncthreads();
  for (int owner = 0; owner < kGroups; ++owner) {
    const List& LL = lists[owner];
    if (LL.total <= kLong) continue;                   // the whole block
    const int lo = grp * LL.total / kGroups, hi = (grp + 1) * LL.total / kGroups;
    LL.entry(lo + lane < hi ? lo + lane : LL.total, idx_all, wts_all, P, p_lo, w_lo);
    for (int ch0 = 0; ch0 < C; ch0 += kGroup * N) {
      const int ch = ch0 + lane * N;
      walk<VG, N>(LL, lo, hi, p_lo, w_lo, g, P, C, ch, ch < C, idx_all, wts_all, acc);
#pragma unroll
      for (int i = 0; i < N; ++i) part[grp][lane * N + i] = acc[i];
      __syncthreads();
      if (grp == owner && ch < C) {
#pragma unroll
        for (int i = 0; i < N; ++i) {
          acc[i] = part[0][lane * N + i];
#pragma unroll
          for (int k = 1; k < kGroups; ++k) acc[i] = __fadd_rn(acc[i], part[k][lane * N + i]);
        }
#pragma unroll
        for (int i = 0; i < N; i += VO::N)
          VO::store(out + ((int64_t)blockIdx.x * kGroups + owner) * C + ch + i, acc + i);
      }
      __syncthreads();                                 // part is free again
    }
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

template <typename TG, typename TO>
cudaError_t launch_gather(const void* g, void* out, const float* wts, const int* idx,
                          const int* starts, int64_t n_out, int P, int h, int w, int C,
                          bool vectorized, cudaStream_t s) {
  if (vectorized) {
    tent_warp_bwd_feat_gather<TG, TO, true><<<grid_for(n_out), kBlock, 0, s>>>(
        (const TG*)g, (TO*)out, wts, idx, starts, n_out, P, h, w, C);
  } else {
    tent_warp_bwd_feat_gather<TG, TO, false><<<grid_for(n_out), kBlock, 0, s>>>(
        (const TG*)g, (TO*)out, wts, idx, starts, n_out, P, h, w, C);
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

// K2. coords [bn, P, 2] fp32, g [bn, P, C] (g_dtype: 0 = fp32, 1 = bf16) ->
// d_feat [bn, h, w, C] (out_dtype likewise) = sign * W^T g, every element
// written. plan: 16-byte aligned int32 scratch of bn (5 P + 2 (h + 1)(w + 1)
// + 1) elements (K2's plan: tap weights [bn, P, 4] fp32, pixels [bn, P],
// bucket starts, cursors). vectorized: nonzero when C * sizeof(element) is a
// multiple of 16 for both g and d_feat and both are 16-byte aligned. Returns
// the CUDA error of the launches (0 on success); both run on `stream`.
extern "C" int tent_warp_bwd_feat(const void* coords, const void* g, void* d_feat, void* plan,
                                  long long bn, int P, int h, int w, int C, int g_dtype,
                                  int out_dtype, int vectorized, float sign, void* stream) {
  const int64_t n_out = (int64_t)bn * h * w;
  if (n_out == 0) return 0;
  if (g_dtype < 0 || g_dtype > 1 || out_dtype < 0 || out_dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int ncells = (h + 1) * (w + 1);
  float4* wts = (float4*)plan;
  int* idx = (int*)(wts + (int64_t)bn * P);
  int* starts = idx + (int64_t)bn * P;
  int* cursor = starts + (int64_t)bn * (ncells + 1);
  // the cursors in shared memory beside the static 40 KB, where they fit
  const bool in_smem = ncells <= (180 << 10) / 4;
  const int smem = in_smem ? ncells * 4 : 0;
  cudaError_t err = cudaFuncSetAttribute(tent_warp_bwd_feat_plan,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  tent_warp_bwd_feat_plan<<<(unsigned)bn, kPlanThreads, smem, s>>>(
      (const float*)coords, P, h, w, sign, in_smem, wts, idx, starts, cursor);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const float* wf = (const float*)wts;
  const bool v = vectorized != 0;
  if (g_dtype == 0 && out_dtype == 0)
    return (int)launch_gather<float, float>(g, d_feat, wf, idx, starts, n_out, P, h, w, C, v, s);
  if (g_dtype == 1 && out_dtype == 1)
    return (int)launch_gather<__nv_bfloat16, __nv_bfloat16>(g, d_feat, wf, idx, starts, n_out,
                                                            P, h, w, C, v, s);
  if (g_dtype == 0)
    return (int)launch_gather<float, __nv_bfloat16>(g, d_feat, wf, idx, starts, n_out, P, h, w,
                                                    C, v, s);
  return (int)launch_gather<__nv_bfloat16, float>(g, d_feat, wf, idx, starts, n_out, P, h, w,
                                                  C, v, s);
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
