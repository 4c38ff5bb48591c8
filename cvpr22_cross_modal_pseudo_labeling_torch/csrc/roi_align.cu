// RoIAlign forward over channels-last features, for Hopper (sm_90a).
//
// Replaces: tools/proto_pallas_roialign.py (at the root of the repository)
// ::run_fused / fwd_kernel / fwd_kernel_sloop and ::run_fused_bigdot /
// fwd_kernel_bigdot, the Pallas TPU kernels of the contraction
// out[b,s,p,q,c] = sum_h,w Ay[b,s,p,h] F[b,h,w,c] Ax[b,s,q,w] that the main
// path's pooler computes through cvpr22_cross_modal_pseudo_labeling_tpu/
// ops/roi_align_mxu.py::roi_align_mxu.  The numerics are those of the JAX
// ops/roi_align.py::
// roi_align and _bilinear_weights (roi size max(.,1), no half-pixel shift,
// adaptive grid ceil(roi/bins) clipped to [1, min(max_samples,
// ceil(size/bins))], samples outside [-1, size] dropped, edge clamp), and
// bin_stride emits every bin_stride-th bin of the output_size grid.
//
// What bounds it on the H100: bytes.  The function must read the feature
// map once and write R x P' x Q' x C values: on the main path 8 x 1000
// rois x 7 x 7 x 1024 in bfloat16, 803 MB, plus the 69 MB bfloat16 C4
// map, about 0.26 ms at 3.35 TB/s.  It does a few multiply-adds per tap.
// A TPU has no gather unit, so the JAX package turned the op into dense
// matmuls against interpolation matrices; on the H100 a direct gather
// from L2 is the natural form, and the matmul form would multiply by
// millions of zeros.  The gather reads every tap of every bin from L2
// (about 240 taps of a 2 KB bfloat16 row per roi on the main path, 4 GB
// per call), so the L2 read rate, not DRAM, is what the kernel meets
// first.
//
// Design: one CTA per roi, the grid image-major, so that the rois of one
// image run together while its map (50 x 84 x 1024 bfloat16, 8.6 MB) sits
// in the 50 MB L2.  With fewer than kSplitBelow rois there are too few
// CTAs to keep the card's loads in flight, and each CTA takes one row of
// the roi's bins instead (the detections' 8 x 100 rois: 5600 CTAs rather
// than 800).
//  * Prologue: one thread per emitted row and one per emitted column
//    (7 + 7 on the main path, all in parallel) builds that bin's compact
//    tap list in shared memory: at most 2 x grid (index, weight) pairs in
//    ascending index order, with the JAX arithmetic rounded op by op (no
//    FMA contraction), so the weights equal the plain version's; taps of
//    weight zero are dropped.
//  * Body: each thread owns 16 bytes of channels (8 bfloat16 or 4
//    float32).  For each of the roi's bins it walks the bin's taps, the
//    product of its row and column lists, a few taps at a time: their
//    independent 16-byte loads are in flight before the multiply-adds,
//    accumulated in float32 registers, and one store per bin in the
//    output type.  A bin has about 5 taps on the main path; 2 taps at a
//    time for bfloat16 and 4 for float32 were the fastest on an H100
//    (fewer registers, more resident warps, fewer predicated-off slots
//    than 8).
// Features and output are both float32 or both bfloat16, with float32
// arithmetic throughout: bfloat16 to float32 is exact, so bfloat16
// features in and a bfloat16 store give what the JAX bundle computes
// (pool in float32, then cast), up to the summation order.
//
// The backward, roi_align_backward, writes the gradient of the features:
// dF[b,h,w,c] = sum_s sum_p,q Ay[b,s,p,h] Ax[b,s,q,w] g[b,s,p,q,c].
// Replaces: no Pallas kernel.  The JAX package gets this gradient from
// XLA's autodiff of roi_align_mxu (ops/roi_align_mxu.py:91), the
// transposed contraction, summed in float32 because the bundle pools
// f.astype(float32) (models/detector/generalized_rcnn.py:197-205), then
// cast back to the features' dtype.
//
// What bounds the backward on the H100: bytes, on paper.  It must read
// the cotangent once and write dF once: on the teacher's train step 8 x
// 512 rois x 7 x 7 x 1024 bfloat16 in (411 MB) and the 69 MB bfloat16
// map out, 0.143 ms at 3.35 TB/s.  Its adds are 1.0 G float32
// multiply-adds (one per tap and channel).  The first version scattered
// them with float4 atomics into a zeroed float32 scratch map [B, H, W, C]
// and cast that to bfloat16: 3.31 ms, the atomics' L2 traffic and the
// scratch's 345 MB of zeroing and casting setting the pace.  Here every
// add lands in shared memory, and what bounds the kernel in practice is
// the instructions and latency of walking each tile's work items (see
// PERF.md section 6).
//
// Design: owner computes, in two kernels.
//  * Plan (roi_align_bwd_plan_kernel): one CTA per roi builds its tap
//    lists with the forward's prologue (the same rounded arithmetic, so
//    the weights are the plain version's) and writes them to a workspace
//    the caller allocates (5.3 MB on the main path): per emitted row and
//    column, (index, weight) pairs in ascending index order, their count
//    and their first and last index, and the first and last column of
//    each run of kQ emitted columns.
//  * Tiles (roi_align_bwd_kernel): one CTA per (tile of tile_h rows by
//    tile_w columns of one image, slabs_per_cta slabs of slab channels).
//    It holds the tile's float32 sums [tile_h, tile_w, slab] in dynamic
//    shared memory; a group of whole warps owns each row of the tile and
//    each thread four channels of every position of its row, so no two
//    threads ever add to one word: no atomics, and every sum is taken in
//    one fixed order, so the result is bit-identical from run to run.
//    The CTA stages, in order, each row's work items (roi, emitted row,
//    run of kQ emitted columns with taps on that row and in the tile:
//    one ballot compaction per row into shared memory), then each row's
//    warps walk their list, two items in flight: the next item's
//    cotangent bins (8 or 16 bytes a thread) and column taps are loaded
//    while this one is summed.  A warp turns an item's column taps into
//    runs of (offset in its sums, weight) inside the tile in a buffer of
//    its own (kept for the next item of the same roi), then adds
//    w_y * w_x * g for a few column taps at a time (all loads, then the
//    multiply-adds, then the stores: the positions are distinct).  At the
//    end it writes its row once, in the features' dtype (round to nearest
//    even for bfloat16), and starts on the next slab, on the same lists
//    when one round held them all.  Every position of dF belongs to one
//    tile, so nothing is zeroed first and no float32 map is written.
//    The caller picks the tile (ops/roi_align.py::backward_tiling).
//
// Tiling, sized on an H100 80GB HBM3 at 700 W by chip_smoke.py's
// roi_align_backward phase: 4 rows x 21 columns x 256 channels, two slabs
// a CTA (256 threads; 86 KB of sums, 16 KB of lists, 6 KB of tap
// buffers: two CTAs an SM).  8 x 512 rois, bfloat16, bin_stride 2: 1.01
// ms, where 2 x 21 took 1.05, 2 x 28 1.07, 4 x 14 1.16, 4 x 28 1.31, and
// one slab a CTA 1.13.  ptxas: the tile kernel 128 registers (float32: 8
// bytes of spill stores, 20 of loads; bfloat16: none), the plan kernel
// 50, no spills.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kSplitBelow = 4096;  // rois

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int n = 4;
  static constexpr int taps = 4;  // taps in flight per thread
  using raw = float4;
  __device__ static raw zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static void unpack(const raw& r, float* v) {
    v[0] = r.x;
    v[1] = r.y;
    v[2] = r.z;
    v[3] = r.w;
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
  static constexpr int taps = 2;
  using raw = uint4;
  __device__ static raw zero() { return make_uint4(0u, 0u, 0u, 0u); }
  // bfloat16 is the high half of a float32: the conversion is a shift
  __device__ static void unpack(const raw& r, float* v) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ void store(float* o, const float (&a)[4]) {
  *reinterpret_cast<float4*>(o) = make_float4(a[0], a[1], a[2], a[3]);
}

// round to nearest even, as torch's .to(torch.bfloat16)
__device__ __forceinline__ void store(__nv_bfloat16* o, const float (&a)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h = __floats2bfloat162_rn(a[2 * i], a[2 * i + 1]);
    w[i] = *reinterpret_cast<uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(o) = make_uint4(w[0], w[1], w[2], w[3]);
}

// Adds w to the entry of index j of a list kept in ascending index order.
__device__ __forceinline__ void add_tap(int* idx, float* wgt, int& n, int j,
                                        float w) {
  int k = n - 1;
  while (k >= 0 && idx[k] > j) --k;
  if (k >= 0 && idx[k] == j) {
    wgt[k] = __fadd_rn(wgt[k], w);
    return;
  }
  for (int m = n; m > k + 1; --m) {
    idx[m] = idx[m - 1];
    wgt[m] = wgt[m - 1];
  }
  idx[k + 1] = j;
  wgt[k + 1] = w;
  ++n;
}

// One axis of one emitted bin: the bilinear tap weights of the bin's
// samples, summed per input position in sample order and divided by the
// grid, as ops/roi_align.py::_axis_interp_matrix sums them.  Writes at
// most 2 * s_cap (index, weight) pairs, drops zero weights, returns the
// count.
__device__ int axis_taps(float c0, float c1, float scale, int bins, int size,
                         int p, int sampling_ratio, int s_cap, int* idx,
                         float* wgt) {
  const float start = __fmul_rn(c0, scale);
  const float end = __fmul_rn(c1, scale);
  const float roi = fmaxf(__fsub_rn(end, start), 1.0f);
  const float bin = __fdiv_rn(roi, (float)bins);
  int grid = sampling_ratio;
  if (sampling_ratio <= 0) {
    grid = (int)ceilf(bin);
    grid = min(max(grid, 1), s_cap);
  }
  const float g = (float)grid;
  const float base = __fadd_rn(start, __fmul_rn((float)p, bin));
  int n = 0;
  for (int i = 0; i < grid; ++i) {
    const float coord =
        __fadd_rn(base, __fdiv_rn(__fmul_rn((float)i + 0.5f, bin), g));
    if (!(coord >= -1.0f && coord <= (float)size)) continue;
    float c = fmaxf(coord, 0.0f);
    int lo = (int)floorf(c);
    int hi;
    if (lo >= size - 1) {
      lo = size - 1;
      hi = size - 1;
      c = (float)lo;
    } else {
      hi = lo + 1;
    }
    const float l = __fsub_rn(c, (float)lo);
    add_tap(idx, wgt, n, lo, __fsub_rn(1.0f, l));
    add_tap(idx, wgt, n, hi, l);
  }
  int m = 0;
  for (int k = 0; k < n; ++k) {
    const float w = __fdiv_rn(wgt[k], g);
    if (w != 0.0f) {
      idx[m] = idx[k];
      wgt[m] = w;
      ++m;
    }
  }
  return m;
}

// One roi's bins in shared memory: per emitted row, at most ly (row
// offset h * W, weight) pairs; per emitted column, at most lx (w, weight)
// pairs; then the counts.
struct TapLists {
  int ly, lx;
  int* yoff;
  float* yw;
  int* xoff;
  float* xw;
  int* ny;
  int* nx;
};

// The prologue of both kernels: one thread per emitted row in [p0, p1)
// and one per emitted column builds that bin's tap list; ends with a
// barrier, so every thread of the CTA must call it.
__device__ __forceinline__ TapLists build_tap_lists(
    int* smem, const float* roi, int H, int W, int P, int Q, float scale,
    int sampling_ratio, int cap_h, int cap_w, int bin_stride, int out_p,
    int out_q, int p0, int p1) {
  TapLists t;
  t.ly = 2 * cap_h;
  t.lx = 2 * cap_w;
  t.yoff = smem;
  t.yw = reinterpret_cast<float*>(t.yoff + out_p * t.ly);
  t.xoff = reinterpret_cast<int*>(t.yw + out_p * t.ly);
  t.xw = reinterpret_cast<float*>(t.xoff + out_q * t.lx);
  t.ny = reinterpret_cast<int*>(t.xw + out_q * t.lx);
  t.nx = t.ny + out_p;
  for (int j = threadIdx.x; j < p1 - p0 + out_q; j += blockDim.x) {
    if (j < p1 - p0) {
      const int p = p0 + j;
      int* ji = t.yoff + p * t.ly;
      const int n = axis_taps(roi[1], roi[3], scale, P, H, p * bin_stride,
                              sampling_ratio, cap_h, ji, t.yw + p * t.ly);
      for (int k = 0; k < n; ++k) ji[k] *= W;
      t.ny[p] = n;
    } else {
      const int q = j - (p1 - p0);
      t.nx[q] = axis_taps(roi[0], roi[2], scale, Q, W, q * bin_stride,
                          sampling_ratio, cap_w, t.xoff + q * t.lx,
                          t.xw + q * t.lx);
    }
  }
  __syncthreads();
  return t;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    roi_align_fwd_kernel(const T* __restrict__ feat,
                         const float* __restrict__ rois,
                         T* __restrict__ out, int H, int W, int C, int S,
                         int P, int Q, float scale, int sampling_ratio,
                         int cap_h, int cap_w, int bin_stride, int out_p,
                         int out_q, int rows) {
  using V = Vec<T>;
  constexpr int kVec = V::n;
  constexpr int kUnroll = V::taps;
  extern __shared__ int smem[];
  const int roi_id = blockIdx.x;  // b * S + s
  const int b = roi_id / S;
  const int p0 = blockIdx.y * rows;  // this CTA's rows of bins
  const int p1 = min(out_p, p0 + rows);
  const TapLists t = build_tap_lists(
      smem, rois + (size_t)roi_id * 4, H, W, P, Q, scale, sampling_ratio,
      cap_h, cap_w, bin_stride, out_p, out_q, p0, p1);

  const T* fb = feat + (size_t)b * H * W * C;
  T* ob = out + (size_t)roi_id * out_p * out_q * C;
  for (int cv = threadIdx.x * kVec; cv < C; cv += blockDim.x * kVec) {
    const T* f = fb + cv;
    for (int p = p0; p < p1; ++p) {
      const int* yo = t.yoff + p * t.ly;
      const float* ywp = t.yw + p * t.ly;
      const int nyp = t.ny[p];
      for (int q = 0; q < out_q; ++q) {
        const int* xo = t.xoff + q * t.lx;
        const float* xwq = t.xw + q * t.lx;
        const int nxq = t.nx[q];
        const int total = nyp * nxq;
        float acc[kVec];
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[e] = 0.0f;
        int iy = 0, ix = 0;
        for (int t0 = 0; t0 < total; t0 += kUnroll) {
          typename V::raw r[kUnroll];
          float w[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            if (t0 + u < total) {
              w[u] = ywp[iy] * xwq[ix];
              r[u] = __ldg(reinterpret_cast<const typename V::raw*>(
                  f + (size_t)(yo[iy] + xo[ix]) * C));
              if (++ix == nxq) {
                ix = 0;
                ++iy;
              }
            } else {
              w[u] = 0.0f;
              r[u] = V::zero();
            }
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            float v[kVec];
            V::unpack(r[u], v);
#pragma unroll
            for (int e = 0; e < kVec; ++e) acc[e] = fmaf(w[u], v[e], acc[e]);
          }
        }
        store(ob + ((size_t)p * out_q + q) * C + cv, acc);
      }
    }
  }
}

// The backward's workspace, filled by the plan kernel: NR = B * S rois,
// each with out_p emitted rows and out_q emitted columns.  A tap is
// (index, weight bits); an empty range is (1 << 30, -1).
struct Plan {
  int2* ytaps;  // [NR, out_p, ly] (row h, weight)
  int2* xtaps;  // [NR, out_q, lx] (column w, weight)
  int* ny;      // [NR, out_p]
  int* nx;      // [NR, out_q]
  int2* yr;     // [NR, out_p] first and last row tapped
  int2* xr;     // [NR, out_q] first and last column tapped
  int2* xc;     // [NR, nqc] the same over each run of kQ emitted columns
};

constexpr int kQ = 7;             // emitted columns per work item
constexpr int kMaxTileRows = 4;   // rows of a tile
constexpr int kXPre = 3;          // column taps per lane loaded ahead
constexpr int kYPre = 8;          // row taps loaded at once when staging
constexpr int kListCap = 512;     // work items staged per tile row and round
constexpr int kBwdMaxThreads = 256;
constexpr int kPlanThreads = 32;
constexpr int kEmpty = 1 << 30;
constexpr int kMaxRoisPerImage = 65535;  // what a staged record holds

__global__ void __launch_bounds__(kPlanThreads)
    roi_align_bwd_plan_kernel(const float* __restrict__ rois, Plan plan,
                              int H, int W, int P, int Q, float scale,
                              int sampling_ratio, int cap_h, int cap_w,
                              int bin_stride, int out_p, int out_q,
                              int nqc) {
  extern __shared__ int smem[];
  const size_t roi = blockIdx.x;
  const TapLists t = build_tap_lists(
      smem, rois + roi * 4, H, W, P, Q, scale, sampling_ratio, cap_h, cap_w,
      bin_stride, out_p, out_q, 0, out_p);
  for (int j = threadIdx.x; j < out_p * t.ly; j += blockDim.x) {
    const int p = j / t.ly;
    plan.ytaps[roi * out_p * t.ly + j] =
        j - p * t.ly < t.ny[p]
            ? make_int2(t.yoff[j] / W, __float_as_int(t.yw[j]))
            : make_int2(0, 0);
  }
  for (int j = threadIdx.x; j < out_q * t.lx; j += blockDim.x) {
    const int q = j / t.lx;
    plan.xtaps[roi * out_q * t.lx + j] =
        j - q * t.lx < t.nx[q]
            ? make_int2(t.xoff[j], __float_as_int(t.xw[j]))
            : make_int2(0, 0);
  }
  for (int p = threadIdx.x; p < out_p; p += blockDim.x) {
    const int n = t.ny[p];
    const int* idx = t.yoff + p * t.ly;
    plan.ny[roi * out_p + p] = n;
    plan.yr[roi * out_p + p] =
        n ? make_int2(idx[0] / W, idx[n - 1] / W) : make_int2(kEmpty, -1);
  }
  for (int q = threadIdx.x; q < out_q; q += blockDim.x) {
    const int n = t.nx[q];
    const int* idx = t.xoff + q * t.lx;
    plan.nx[roi * out_q + q] = n;
    plan.xr[roi * out_q + q] =
        n ? make_int2(idx[0], idx[n - 1]) : make_int2(kEmpty, -1);
  }
  for (int qc = threadIdx.x; qc < nqc; qc += blockDim.x) {
    int lo = kEmpty, hi = -1;
    for (int q = qc * kQ; q < min(out_q, qc * kQ + kQ); ++q) {
      const int n = t.nx[q];
      if (n) {
        lo = min(lo, t.xoff[q * t.lx]);
        hi = max(hi, t.xoff[q * t.lx + n - 1]);
      }
    }
    plan.xc[roi * nqc + qc] = make_int2(lo, hi);
  }
}

// Four channels of the cotangent and of dF.
template <typename T>
struct Lanes;

template <>
struct Lanes<float> {
  using raw = float4;
  // column taps summed together (more would spill the float32 kernel's
  // registers)
  static constexpr int taps = 2;
  __device__ static raw zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ static float4 unpack(const raw& r) { return r; }
  __device__ static void store(float* o, const float4& a) {
    *reinterpret_cast<float4*>(o) = a;
  }
};

template <>
struct Lanes<__nv_bfloat16> {
  using raw = uint2;
  static constexpr int taps = 4;
  __device__ static raw zero() { return make_uint2(0u, 0u); }
  __device__ static raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ static float4 unpack(const raw& r) {
    return make_float4(__uint_as_float(r.x << 16),
                       __uint_as_float(r.x & 0xffff0000u),
                       __uint_as_float(r.y << 16),
                       __uint_as_float(r.y & 0xffff0000u));
  }
  // round to nearest even, as torch's .to(torch.bfloat16)
  __device__ static void store(__nv_bfloat16* o, const float4& a) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(a.x, a.y);
    __nv_bfloat162 hi = __floats2bfloat162_rn(a.z, a.w);
    *reinterpret_cast<uint2*>(o) = make_uint2(
        *reinterpret_cast<uint32_t*>(&lo), *reinterpret_cast<uint32_t*>(&hi));
  }
};

// What one thread of the accumulate kernel works on.
struct Tile {
  int b, h0, h1, w0, w1;  // image, first and last row and column
  int c;                  // this thread's first channel
  bool active;            // c < C
  int S, out_p, out_q, nqc, C, ly, lx, stride;
};

struct Item {
  size_t roi;
  int p, qc;
};

__device__ __forceinline__ Item decode(const Tile& k, int e) {
  const int per_roi = k.out_p * k.nqc;
  const int s = e / per_roi;
  const int r = e - s * per_roi;
  Item it;
  it.roi = (size_t)k.b * k.S + s;
  it.p = r / k.nqc;
  it.qc = r - it.p * k.nqc;
  return it;
}

// A staged record's first word: roi s << 16 | emitted row p << 10 | run
// of emitted columns qc << 7 | the columns of the run that meet the tile.
__device__ __forceinline__ unsigned pack(int s, int p, int qc, unsigned qm) {
  return (unsigned)s << 16 | (unsigned)p << 10 | (unsigned)qc << 7 | qm;
}

__device__ __forceinline__ Item unpack(const Tile& k, int word) {
  const unsigned w = (unsigned)word;
  Item it;
  it.roi = (size_t)k.b * k.S + (w >> 16);
  it.p = w >> 10 & 63;
  it.qc = w >> 7 & 7;
  return it;
}

// Items with the same roi and run of columns share their column taps.
__device__ __forceinline__ unsigned x_key(int word) {
  return (unsigned)word >> 16 << 3 | ((unsigned)word >> 7 & 7);
}

__device__ __forceinline__ bool meets(int2 range, int lo, int hi) {
  return range.x <= hi && range.y >= lo;
}

// Entry e's emitted columns whose taps meet the tile (bits of qm) and the
// weight of its row tap on each row of the tile (0: none).  Its loads are
// issued together, the first kYPre row taps included.
__device__ __forceinline__ void stage(const Plan& plan, const Tile& k, int e,
                                      unsigned& qm,
                                      float (&w)[kMaxTileRows]) {
  const Item it = decode(k, e);
  const size_t row = it.roi * k.out_p + it.p;
  const int2 yr = __ldg(plan.yr + row);
  const int2 xc = __ldg(plan.xc + it.roi * k.nqc + it.qc);
  const int ny = __ldg(plan.ny + row);
  int2 xr[kQ];
#pragma unroll
  for (int u = 0; u < kQ; ++u)
    xr[u] = it.qc * kQ + u < k.out_q
                ? __ldg(plan.xr + it.roi * k.out_q + it.qc * kQ + u)
                : make_int2(kEmpty, -1);
  const int2* yt = plan.ytaps + row * k.ly;
  int2 t[kYPre];
#pragma unroll
  for (int j = 0; j < kYPre; ++j)
    t[j] = j < k.ly ? __ldg(yt + j) : make_int2(kEmpty, 0);
  qm = 0;
#pragma unroll
  for (int r = 0; r < kMaxTileRows; ++r) w[r] = 0.0f;
  if (!meets(yr, k.h0, k.h1) || !meets(xc, k.w0, k.w1)) return;
#pragma unroll
  for (int u = 0; u < kQ; ++u)
    if (meets(xr[u], k.w0, k.w1)) qm |= 1u << u;
#pragma unroll
  for (int j = 0; j < kYPre; ++j)
#pragma unroll
    for (int r = 0; r < kMaxTileRows; ++r)
      if (j < ny && t[j].x - k.h0 == r && t[j].x <= k.h1)
        w[r] = __int_as_float(t[j].y);
  for (int j = kYPre; j < ny; ++j) {
    const int2 tj = __ldg(yt + j);
#pragma unroll
    for (int r = 0; r < kMaxTileRows; ++r)
      if (tj.x - k.h0 == r && tj.x <= k.h1) w[r] = __int_as_float(tj.y);
  }
}

// Loads this thread's four channels of the item's cotangent bins that
// meet the tile.
template <typename T>
__device__ __forceinline__ void fetch(const T* __restrict__ grad,
                                      const Tile& k, int2 rec,
                                      typename Lanes<T>::raw (&g)[kQ]) {
  const Item it = unpack(k, rec.x);
  const T* gp = grad + ((it.roi * k.out_p + it.p) * k.out_q +
                        (size_t)it.qc * kQ) * k.C + k.c;
#pragma unroll
  for (int u = 0; u < kQ; ++u) {
    g[u] = Lanes<T>::zero();
    if (k.active && (rec.x >> u & 1)) g[u] = Lanes<T>::load(gp + (size_t)u * k.C);
  }
}

// The column taps of one item's kQ emitted columns, as a warp holds them
// between their loads and their copy into its buffer in shared memory
// ([kQ][lx] taps, then kQ runs): slot lane + 32 * j, j < kXPre, of the
// taps, and the count of column lane for lane < kQ.
struct XTaps {
  int2 t[kXPre];
  int n;
};

__device__ __forceinline__ XTaps load_x(const Plan& plan, const Tile& k,
                                        int2 rec) {
  const Item it = unpack(k, rec.x);
  const int q0 = it.qc * kQ;
  const int slots = min(kQ, k.out_q - q0) * k.lx;
  const int2* src = plan.xtaps + (it.roi * k.out_q + q0) * k.lx;
  const int lane = threadIdx.x & 31;
  XTaps x;
#pragma unroll
  for (int j = 0; j < kXPre; ++j)
    x.t[j] = lane + 32 * j < slots ? __ldg(src + lane + 32 * j)
                                   : make_int2(0, 0);
  x.n = lane < kQ && q0 + lane < k.out_q
            ? __ldg(plan.nx + it.roi * k.out_q + q0 + lane)
            : 0;
  return x;
}

// One chunk of 32 slots of an item's column taps into the warp's buffer:
// each tap inside the tile as (offset of its column in the thread's sums,
// weight); lanes u < kQ count, for emitted column u, the taps before the
// tile (first) and inside it (count): they form one run, since the taps
// ascend.
__device__ __forceinline__ void store_chunk(const Tile& k, int j, int slots,
                                            int2 t, int nx_lane, int2* xbuf,
                                            int& first, int& count) {
  const int lane = threadIdx.x & 31;
  const int s = 32 * j + lane;
  const int u = min(s / k.lx, kQ - 1);
  const int nx = __shfl_sync(0xffffffffu, nx_lane, u);
  const bool tap = s < slots && s - u * k.lx < nx;
  const bool before = tap && t.x < k.w0;
  const bool in = tap && t.x >= k.w0 && t.x <= k.w1;
  if (in) xbuf[s] = make_int2((t.x - k.w0) * k.stride, t.y);
  const unsigned b_before = __ballot_sync(0xffffffffu, before);
  const unsigned b_in = __ballot_sync(0xffffffffu, in);
  if (lane < kQ) {
    const int lo = max(lane * k.lx - 32 * j, 0);
    const int hi = min(lane * k.lx + k.lx - 32 * j, 32);
    if (hi > lo) {
      const unsigned m = (hi == 32 ? 0xffffffffu : (1u << hi) - 1u) &
                         ~((1u << lo) - 1u);
      first += __popc(b_before & m);
      count += __popc(b_in & m);
    }
  }
}

// Copies an item's column taps into the warp's buffer ([kQ][lx] taps, then
// each emitted column's run (first, count)), the slots past 32 * kXPre
// straight from device memory; the warp syncs around it.
__device__ __forceinline__ void store_x(const Plan& plan, const Tile& k,
                                        int2 rec, const XTaps& x,
                                        int2* xbuf) {
  const Item it = unpack(k, rec.x);
  const int q0 = it.qc * kQ;
  const int slots = min(kQ, k.out_q - q0) * k.lx;
  const int lane = threadIdx.x & 31;
  int first = 0, count = 0;
#pragma unroll
  for (int j = 0; j < kXPre; ++j)
    store_chunk(k, j, slots, x.t[j], x.n, xbuf, first, count);
  const int2* src = plan.xtaps + (it.roi * k.out_q + q0) * k.lx;
  for (int j = kXPre; 32 * j < slots; ++j) {
    const int s = 32 * j + lane;
    store_chunk(k, j, slots, s < slots ? __ldg(src + s) : make_int2(0, 0),
                x.n, xbuf, first, count);
  }
  if (lane < kQ) xbuf[kQ * k.lx + lane] = make_int2(first, count);
}

// Adds the item's taps on this thread's row of the tile into its sums;
// the column taps come from the warp's buffer.
template <typename T>
__device__ __forceinline__ void accumulate(const Tile& k, int2 rec,
                                           const typename Lanes<T>::raw (&g)[kQ],
                                           const int2* xbuf, float4* mine) {
  constexpr int kB = Lanes<T>::taps;
  const float wy = __int_as_float(rec.y);
#pragma unroll
  for (int u = 0; u < kQ; ++u) {
    if (!(rec.x >> u & 1)) continue;
    const float4 gv = Lanes<T>::unpack(g[u]);
    const int2 run = xbuf[kQ * k.lx + u];
    const int2* xt = xbuf + u * k.lx + run.x;
    // kB column taps at a time, at distinct positions: all loads,
    // then the multiply-adds, then the stores
    for (int i0 = 0; i0 < run.y; i0 += kB) {
      int2 t[kB];
      float4 v[kB];
#pragma unroll
      for (int i = 0; i < kB; ++i) {
        t[i] = i0 + i < run.y ? xt[i0 + i] : make_int2(0, 0);
        if (i0 + i < run.y) v[i] = mine[t[i].x];
      }
#pragma unroll
      for (int i = 0; i < kB; ++i) {
        if (i0 + i < run.y) {
          const float w = wy * __int_as_float(t[i].y);
          v[i].x = fmaf(w, gv.x, v[i].x);
          v[i].y = fmaf(w, gv.y, v[i].y);
          v[i].z = fmaf(w, gv.z, v[i].z);
          v[i].w = fmaf(w, gv.w, v[i].w);
        }
      }
#pragma unroll
      for (int i = 0; i < kB; ++i)
        if (i0 + i < run.y) mine[t[i].x] = v[i];
    }
  }
}

// One staged item as a thread holds it between its loads and its sums.
template <typename T>
struct Work {
  typename Lanes<T>::raw g[kQ];
  XTaps x;
  int2 rec;
  bool same_x;  // the column taps of the item before it: already buffered
};

// Item i of the list: its loads.
template <typename T>
__device__ __forceinline__ void prefetch(const T* __restrict__ grad,
                                         const Plan& plan, const Tile& k,
                                         const int2* list, int i,
                                         Work<T>& w) {
  w.rec = list[i];
  w.same_x = i > 0 && x_key(list[i - 1].x) == x_key(w.rec.x);
  fetch<T>(grad, k, w.rec, w.g);
  if (!w.same_x) w.x = load_x(plan, k, w.rec);
}

// Sums one item: its column taps into the warp's buffer (unless they are
// there), then its taps into this thread's sums.
template <typename T>
__device__ __forceinline__ void step(const Plan& plan, const Tile& k,
                                     const Work<T>& w, int2* xbuf,
                                     float4* mine) {
  if (!w.same_x) {
    __syncwarp();
    store_x(plan, k, w.rec, w.x, xbuf);
    __syncwarp();
  }
  accumulate<T>(k, w.rec, w.g, xbuf, mine);
}

template <typename T>
__global__ void __launch_bounds__(kBwdMaxThreads, 2)
    roi_align_bwd_kernel(const T* __restrict__ grad, Plan plan,
                         T* __restrict__ out, int H, int W, int C, int S,
                         int out_p, int out_q, int nqc, int ly, int lx,
                         int tile_h, int tile_w, int slab, int tiles_w,
                         int slabs_per_cta) {
  extern __shared__ float4 smem4[];
  float* acc = reinterpret_cast<float*>(smem4);
  int2* lists = reinterpret_cast<int2*>(acc + (size_t)tile_h * tile_w * slab);
  int* warp_cnt = reinterpret_cast<int*>(lists + tile_h * kListCap);
  // each warp's buffer of one item's column taps: kQ * lx taps, kQ runs
  int2* xbuf = reinterpret_cast<int2*>(warp_cnt + kMaxTileRows * 32) +
               (threadIdx.x >> 5) * (kQ * lx + kQ);

  // tile_h groups of slab / 4 threads (whole warps): group r owns row
  // h0 + r of the tile, each thread four channels of it
  const int per_row = slab / 4;
  const int gr = threadIdx.x / per_row;
  const int cs = 4 * (threadIdx.x - gr * per_row);
  Tile k;
  k.b = blockIdx.z;
  k.h0 = blockIdx.x / tiles_w * tile_h;
  k.w0 = blockIdx.x % tiles_w * tile_w;
  k.h1 = min(H, k.h0 + tile_h) - 1;
  k.w1 = min(W, k.w0 + tile_w) - 1;
  k.S = S;
  k.out_p = out_p;
  k.out_q = out_q;
  k.nqc = nqc;
  k.C = C;
  k.ly = ly;
  k.lx = lx;
  k.stride = slab / 4;
  // column x of this thread's row: mine[(x - w0) * stride]
  float4* mine =
      reinterpret_cast<float4*>(acc + (size_t)gr * tile_w * slab + cs);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int n_entries = S * out_p * nqc;
  const int2* mylist = lists + gr * kListCap;
  // this CTA's slabs of channels, one after the other: when the first
  // staged every item in one round, the others sum the same lists
  const int first_slab = blockIdx.y * slabs_per_cta;
  const int end_slab = min((C + slab - 1) / slab, first_slab + slabs_per_cta);
  bool reuse = false;
  int count[kMaxTileRows] = {};
  for (int sl = first_slab; sl < end_slab; ++sl) {
    k.c = sl * slab + cs;
    k.active = k.c < C;
    for (int x = 0; x < tile_w; ++x)
      mine[x * k.stride] = make_float4(0.f, 0.f, 0.f, 0.f);
    int e0 = 0, rounds = 0;
    do {
      if (!reuse) {
        // stage, in order, the next work items of each row of the tile:
        // (roi, emitted row and columns, the columns meeting the tile;
        // the row weight)
#pragma unroll
        for (int r = 0; r < kMaxTileRows; ++r) count[r] = 0;
        int most = 0;
        while (e0 < n_entries && most + (int)blockDim.x <= kListCap) {
          const int e = e0 + threadIdx.x;
          unsigned qm = 0;
          float w[kMaxTileRows];
#pragma unroll
          for (int r = 0; r < kMaxTileRows; ++r) w[r] = 0.0f;
          if (e < n_entries) stage(plan, k, e, qm, w);
          unsigned m[kMaxTileRows];
#pragma unroll
          for (int r = 0; r < kMaxTileRows; ++r) {
            m[r] = __ballot_sync(0xffffffffu, qm != 0 && w[r] != 0.0f);
            if (lane == 0 && r < tile_h) warp_cnt[r * 32 + warp] = __popc(m[r]);
          }
          __syncthreads();
#pragma unroll
          for (int r = 0; r < kMaxTileRows; ++r) {
            if (r >= tile_h) break;
            int off = count[r], total = 0;
            for (int v = 0; v < nwarps; ++v) {
              const int n = warp_cnt[r * 32 + v];
              off += v < warp ? n : 0;
              total += n;
            }
            if (m[r] >> lane & 1)
              lists[r * kListCap + off + __popc(m[r] & ((1u << lane) - 1u))] =
                  make_int2((int)pack(e / (out_p * nqc), e / nqc % out_p,
                                      e % nqc, qm),
                            __float_as_int(w[r]));
            count[r] += total;
            most = max(most, count[r]);
          }
          __syncthreads();
          e0 += blockDim.x;
        }
      }
      // sum this row's items, two in flight: one's loads are issued while
      // the other is summed, in registers that alternate without copies
      int n = 0;
#pragma unroll
      for (int r = 0; r < kMaxTileRows; ++r) n = r == gr ? count[r] : n;
      Work<T> wa = {}, wb = {};
      if (n > 0) prefetch(grad, plan, k, mylist, 0, wa);
      if (n > 1) prefetch(grad, plan, k, mylist, 1, wb);
      for (int i = 0; i < n; i += 2) {
        step(plan, k, wa, xbuf, mine);
        if (i + 2 < n) prefetch(grad, plan, k, mylist, i + 2, wa);
        if (i + 1 < n) {
          step(plan, k, wb, xbuf, mine);
          if (i + 3 < n) prefetch(grad, plan, k, mylist, i + 3, wb);
        }
      }
      __syncwarp();
      __syncthreads();  // the lists are rewritten in the next round
      ++rounds;
    } while (!reuse && e0 < n_entries);
    reuse = reuse || rounds == 1;

    const int y = k.h0 + gr;
    if (k.active && y <= k.h1) {
      for (int x = k.w0; x <= k.w1; ++x)
        Lanes<T>::store(out + ((size_t)(k.b * H + y) * W + x) * C + k.c,
                        mine[(x - k.w0) * k.stride]);
    }
  }
}

// The launch shape both directions share.
struct Geometry {
  int out_p, out_q, rows;
  size_t smem;
  dim3 grid;
  int threads;
};

template <typename T>
Geometry geometry(int B, int C, int S, int P, int Q, int cap_h, int cap_w,
                  int bin_stride) {
  Geometry g;
  g.out_p = (P + bin_stride - 1) / bin_stride;
  g.out_q = (Q + bin_stride - 1) / bin_stride;
  g.smem = (size_t)(g.out_p * 2 * cap_h + g.out_q * 2 * cap_w) * 8 +
           (g.out_p + g.out_q) * 4;
  g.threads = min(C / Vec<T>::n, kMaxThreads);
  g.threads = max(32, (g.threads + 31) / 32 * 32);
  g.rows = B * S < kSplitBelow ? 1 : g.out_p;
  g.grid = dim3(B * S, (g.out_p + g.rows - 1) / g.rows);
  return g;
}

template <typename T>
cudaError_t launch(const void* features, const void* rois, void* out, int B,
                   int H, int W, int C, int S, int P, int Q, float scale,
                   int sampling_ratio, int cap_h, int cap_w, int bin_stride,
                   cudaStream_t st) {
  const Geometry g = geometry<T>(B, C, S, P, Q, cap_h, cap_w, bin_stride);
  if (g.smem > 48 * 1024) return cudaErrorInvalidValue;
  roi_align_fwd_kernel<T><<<g.grid, g.threads, g.smem, st>>>(
      static_cast<const T*>(features), static_cast<const float*>(rois),
      static_cast<T*>(out), H, W, C, S, P, Q, scale, sampling_ratio, cap_h,
      cap_w, bin_stride, g.out_p, g.out_q, g.rows);
  return cudaGetLastError();
}

// Where each array of the plan lies in the workspace, 256-byte aligned;
// returns the bytes it needs (ops/roi_align.py::_plan_bytes computes the
// same).
size_t plan_layout(char* base, size_t nr, int out_p, int out_q, int ly,
                   int lx, int nqc, Plan* plan) {
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base + off;
    off += (bytes + 255) / 256 * 256;
    return p;
  };
  plan->ytaps = reinterpret_cast<int2*>(take(nr * out_p * ly * 8));
  plan->xtaps = reinterpret_cast<int2*>(take(nr * out_q * lx * 8));
  plan->ny = reinterpret_cast<int*>(take(nr * out_p * 4));
  plan->nx = reinterpret_cast<int*>(take(nr * out_q * 4));
  plan->yr = reinterpret_cast<int2*>(take(nr * out_p * 8));
  plan->xr = reinterpret_cast<int2*>(take(nr * out_q * 8));
  plan->xc = reinterpret_cast<int2*>(take(nr * nqc * 8));
  return off;
}

template <typename T>
cudaError_t launch_backward(const void* grad, const void* rois,
                            void* workspace, long long workspace_bytes,
                            void* out, int B, int H, int W, int C, int S,
                            int P, int Q, float scale, int sampling_ratio,
                            int cap_h, int cap_w, int bin_stride, int tile_h,
                            int tile_w, int slab, int slabs_per_cta,
                            cudaStream_t st) {
  const Geometry g = geometry<T>(B, C, S, P, Q, cap_h, cap_w, bin_stride);
  const int ly = 2 * cap_h, lx = 2 * cap_w;
  const int nqc = (g.out_q + kQ - 1) / kQ;
  const size_t nr = (size_t)B * S;
  Plan plan;
  const size_t need = plan_layout(static_cast<char*>(workspace), nr, g.out_p,
                                  g.out_q, ly, lx, nqc, &plan);
  const int threads = tile_h * slab / 4;
  const size_t smem = (size_t)tile_h * tile_w * slab * 4 +
                      (size_t)tile_h * kListCap * 8 + kMaxTileRows * 32 * 4 +
                      (size_t)threads / 32 * (kQ * lx + kQ) * 8;
  if (g.smem > 48 * 1024 || need > (size_t)workspace_bytes || tile_h < 1 ||
      tile_h > kMaxTileRows || tile_w < 1 || slab % 128 != 0 ||
      threads > kBwdMaxThreads || smem > 232448 || slabs_per_cta < 1 ||
      S > kMaxRoisPerImage ||
      g.out_p > 64 || nqc > 8)
    return cudaErrorInvalidValue;
  roi_align_bwd_plan_kernel<<<(unsigned)nr, kPlanThreads, g.smem, st>>>(
      static_cast<const float*>(rois), plan, H, W, P, Q, scale,
      sampling_ratio, cap_h, cap_w, bin_stride, g.out_p, g.out_q, nqc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the opt-in above 48 KB holds per device: made on every call
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(roi_align_bwd_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int tiles_w = (W + tile_w - 1) / tile_w;
  const int slabs = (C + slab - 1) / slab;
  const dim3 grid(tiles_w * ((H + tile_h - 1) / tile_h),
                  (slabs + slabs_per_cta - 1) / slabs_per_cta, B);
  roi_align_bwd_kernel<T><<<grid, threads, smem, st>>>(
      static_cast<const T*>(grad), plan, static_cast<T*>(out), H, W, C, S,
      g.out_p, g.out_q, nqc, ly, lx, tile_h, tile_w, slab, tiles_w,
      slabs_per_cta);
  return cudaGetLastError();
}

void sample_caps(int H, int W, int P, int Q, int sampling_ratio,
                 int max_samples, int* cap_h, int* cap_w) {
  *cap_h = *cap_w = sampling_ratio;
  if (sampling_ratio <= 0) {
    *cap_h = min(max_samples, (H + P - 1) / P);
    *cap_w = min(max_samples, (W + Q - 1) / Q);
  }
}

}  // namespace

// features [B, H, W, C] float32 (C % 4 == 0) or bfloat16 (C % 8 == 0),
// 16-byte aligned; rois [B, S, 4] float32 xyxy in image pixels; out
// [B, S, ceil(P/bin_stride), ceil(Q/bin_stride), C] in the features' type.
// bf16 selects the type.
extern "C" int roi_align_forward(const void* features, const void* rois,
                                 void* out, int B, int H, int W, int C, int S,
                                 int P, int Q, float spatial_scale,
                                 int sampling_ratio, int max_samples,
                                 int bin_stride, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int cap_h, cap_w;
  sample_caps(H, W, P, Q, sampling_ratio, max_samples, &cap_h, &cap_w);
  const cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(features, rois, out, B, H, W, C, S, P, Q,
                                   spatial_scale, sampling_ratio, cap_h, cap_w,
                                   bin_stride, st)
           : launch<float>(features, rois, out, B, H, W, C, S, P, Q,
                           spatial_scale, sampling_ratio, cap_h, cap_w,
                           bin_stride, st);
  return static_cast<int>(err);
}

// grad [B, S, ceil(P/bin_stride), ceil(Q/bin_stride), C] in the features'
// type (float32 with C % 4 == 0, or bfloat16 with C % 8 == 0), 16-byte
// aligned; rois as for the forward; workspace of workspace_bytes (the
// plan, at least what ops/roi_align.py::_plan_bytes gives); out [B, H, W,
// C] in the features' type (bf16 = 1 selects bfloat16) receives dF, every
// element written.  The tile: tile_h (1 to 4) rows by tile_w columns by
// slab channels (a multiple of 128, tile_h * slab / 4 threads at most
// 256), slabs_per_cta slabs a CTA; a CTA's shared memory at most 227 KB;
// at most 65535 rois an image and 64 x 56 emitted bins.
extern "C" int roi_align_backward(const void* grad, const void* rois,
                                  void* workspace, long long workspace_bytes,
                                  void* out, int B, int H, int W, int C,
                                  int S, int P, int Q, float spatial_scale,
                                  int sampling_ratio, int max_samples,
                                  int bin_stride, int tile_h, int tile_w,
                                  int slab, int slabs_per_cta, int bf16,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int cap_h, cap_w;
  sample_caps(H, W, P, Q, sampling_ratio, max_samples, &cap_h, &cap_w);
  const cudaError_t err =
      bf16 ? launch_backward<__nv_bfloat16>(
                 grad, rois, workspace, workspace_bytes, out, B, H, W, C, S,
                 P, Q, spatial_scale, sampling_ratio, cap_h, cap_w,
                 bin_stride, tile_h, tile_w, slab, slabs_per_cta, st)
           : launch_backward<float>(
                 grad, rois, workspace, workspace_bytes, out, B, H, W, C, S,
                 P, Q, spatial_scale, sampling_ratio, cap_h, cap_w,
                 bin_stride, tile_h, tile_w, slab, slabs_per_cta, st);
  return static_cast<int>(err);
}
