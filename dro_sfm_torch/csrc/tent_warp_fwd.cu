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
// _run_fwd, the entry tent_warp). The output is fp32 whatever the features'
// dtype, as the TPU kernel's. Its gradient is tent_warp_bwd.cu's K2 and K3
// with sign +1.
//
// Bound: memory, the feature rows referenced + coords + the fp32 output (at
// 24 x 80 x 128, B*N = 16, bf16: 7.9 + 0.25 + 15.7 MB, 7.1 us at 3.35 TB/s).
// Two thirds of the bytes are the output, so K4 is built around its stores:
//
// - Tiles. The pixels are cut into tiles of tile_pix consecutive pixels, whose
//   output rows are one contiguous run of tile_pix * C fp32 values. Each block
//   walks a contiguous range of tiles (a grid of a few blocks an SM, planned
//   by ops/tent_warp.py:k4_plan).
// - Taps once a pixel. One thread a pixel computes the taps (make_taps, as
//   K1-K3) into shared memory; the next tile's coordinates are loaded before
//   the current tile is gathered.
// - Gather. One warp a pixel, 4 channels a lane: a tap's feature row is read
//   as one contiguous run across the warp (8 bytes a lane in bf16, 16 in
//   fp32), the four taps' loads all in flight before the sums.
// - Stores, variant "direct": each lane stores its 4 sums as 16 bytes, so a
//   warp writes the pixel's 512-byte output row in one instruction and every
//   32-byte sector whole (lanes storing single elements 32 bytes apart make
//   8x the write transactions). Needs C % 4 == 0, features aligned to 4
//   elements and the output to 16 bytes.
// - Variant "unaligned": any C and any element alignment (C = 6, a view at an
//   odd offset): one channel a lane, each lane storing its fp32 sum directly;
//   consecutive lanes still read and write consecutive addresses.
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

// --- K4 ---------------------------------------------------------------------

namespace k4 {

constexpr int kThreads = 256;                 // threads a block
constexpr int kWarps = kThreads / 32;

// A pixel's taps: the feature row of each tap (-1 outside the map) and its
// fp32 weight.
struct __align__(16) PixTaps {
  int row[4];
  float wt[4];
};

// 4 channels a lane: 16-byte fp32 loads (Vec<float>), 8-byte bf16 loads.
template <typename T> struct Quad;
template <> struct Quad<float> : Vec<float> {};
template <> struct Quad<__nv_bfloat16> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  }
};

__device__ __forceinline__ void store_taps(PixTaps* s, float2 c, int64_t pix, int P, int h,
                                           int w) {
  const Taps tp = make_taps(c, pix / P, h, w, 1);   // C = 1: off is the row
  PixTaps r;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    r.row[t] = tp.ok[t] ? (int)tp.off[t] : -1;
    r.wt[t] = tp.wt[t];
  }
  *s = r;
}

// Block b gathers tiles [b * tiles_per_block, (b + 1) * tiles_per_block) of
// tile_pix pixels each (the last tile ragged). V loads the channels, O
// stores the fp32 sums: Quad<T> and Vec<float> ("direct") or Scalar<T> and
// Scalar<float> ("unaligned").
template <typename T, typename V, typename O>
__global__ void __launch_bounds__(kThreads)
tent_warp_fwd_kernel(const T* __restrict__ feat, const float* __restrict__ coords,
                     float* __restrict__ out, int64_t n_pix, int P, int h, int w, int C,
                     int tile_pix, int tiles_per_block) {
  static_assert(V::N == O::N, "loads and stores cover the same channels");
  __shared__ PixTaps taps[kThreads];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t n_tiles = (n_pix + tile_pix - 1) / tile_pix;
  const int64_t first = (int64_t)blockIdx.x * tiles_per_block;
  const int64_t last = first + tiles_per_block < n_tiles ? first + tiles_per_block : n_tiles;
  const float2* co = reinterpret_cast<const float2*>(coords);

  float2 c_next = make_float2(0.0f, 0.0f);
  if (first < last && tid < tile_pix && first * tile_pix + tid < n_pix)
    c_next = __ldg(co + first * tile_pix + tid);
  for (int64_t tile = first; tile < last; ++tile) {
    const int64_t start = tile * tile_pix;
    const int n = n_pix - start < tile_pix ? (int)(n_pix - start) : tile_pix;
    if (tid < n) store_taps(taps + tid, c_next, start + tid, P, h, w);
    if (tile + 1 < last && tid < tile_pix && start + tile_pix + tid < n_pix)
      c_next = __ldg(co + start + tile_pix + tid);       // the next tile's, ahead
    __syncthreads();

    for (int q = warp; q < n; q += kWarps) {
      const PixTaps tp = taps[q];
      float* dst = out + (start + q) * C;
      for (int ch = lane * V::N; ch < C; ch += 32 * V::N) {
        float v[4][V::N];
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (tp.row[t] >= 0) V::load(feat + (int64_t)tp.row[t] * C + ch, v[t]);
        float acc[V::N];
#pragma unroll
        for (int i = 0; i < V::N; ++i) acc[i] = 0.0f;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          if (tp.row[t] < 0) continue;
#pragma unroll
          for (int i = 0; i < V::N; ++i)
            acc[i] = __fadd_rn(acc[i], __fmul_rn(v[t][i], tp.wt[t]));
        }
        O::store(dst + ch, acc);
      }
    }
    __syncthreads();                          // the tile is written; taps are free
  }
}

template <typename T>
cudaError_t launch(const void* feat, const float* coords, float* out, int64_t n_pix, int P,
                   int h, int w, int C, bool direct, int tile_pix, int tiles_per_block,
                   cudaStream_t stream) {
  const int64_t n_tiles = (n_pix + tile_pix - 1) / tile_pix;
  const int64_t grid = (n_tiles + tiles_per_block - 1) / tiles_per_block;
  if (grid > 0x7fffffff) return cudaErrorInvalidValue;
  if (direct)
    tent_warp_fwd_kernel<T, Quad<T>, Vec<float>><<<(unsigned)grid, kThreads, 0, stream>>>(
        (const T*)feat, coords, out, n_pix, P, h, w, C, tile_pix, tiles_per_block);
  else
    tent_warp_fwd_kernel<T, Scalar<T>, Scalar<float>><<<(unsigned)grid, kThreads, 0, stream>>>(
        (const T*)feat, coords, out, n_pix, P, h, w, C, tile_pix, tiles_per_block);
  return cudaGetLastError();
}

}  // namespace k4

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
// -> out [bn, P, C] fp32, as planned by ops/tent_warp.py:k4_plan: direct
// (nonzero: the "direct" variant, which needs C % 4 == 0, feat aligned to 4
// elements and out to 16 bytes; zero: "unaligned"), tile_pix pixels a tile
// (1 to 256: one thread computes a pixel's taps), tiles_per_block
// consecutive tiles a block; bn * h * w must fit in an int. Returns
// cudaErrorInvalidValue for a plan it does not take, else the CUDA error of
// the launch (0 on success); the kernel runs on `stream`.
extern "C" int tent_warp_fwd(const void* feat, const void* coords, void* out, long long bn,
                             int P, int h, int w, int C, int dtype, int direct, int tile_pix,
                             int tiles_per_block, void* stream) {
  const int64_t n_pix = (int64_t)bn * P;
  if (n_pix == 0) return 0;
  const size_t elem = dtype == 0 ? 4 : 2;
  if (tile_pix < 1 || tile_pix > k4::kThreads || tiles_per_block < 1 ||
      (int64_t)bn * h * w > 0x7fffffff ||
      (direct && (C % 4 || (uintptr_t)feat % (4 * elem) || (uintptr_t)out % 16)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)k4::launch<float>(feat, (const float*)coords, (float*)out, n_pix, P, h, w, C,
                                  direct != 0, tile_pix, tiles_per_block, s);
  if (dtype == 1)
    return (int)k4::launch<__nv_bfloat16>(feat, (const float*)coords, (float*)out, n_pix, P,
                                          h, w, C, direct != 0, tile_pix, tiles_per_block, s);
  return (int)cudaErrorInvalidValue;
}
