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
// map out, about 0.14 ms at 3.35 TB/s.  In practice the scatter's
// float32 atomics into L2 set the pace: one vector add per (bin, tap,
// 4 channels), about 1 G scalar adds on that shape.
//
// Design: the forward's grid and prologue (one CTA per roi, image-major,
// the roi's tap lists in shared memory).  Each thread owns 16 bytes of
// channels of the cotangent; for every bin it reads them once and, for
// each of the bin's taps, adds w_y * w_x * g into a float32 scratch map
// [B, H, W, C] that the caller zeroed, with sm_90's float4 atomicAdd
// (red.global.add.v4.f32).  The rois of one image run together, so their
// adds meet in that image's 17 MB slab of the scratch, which L2 holds.
// A second kernel casts the scratch to bfloat16 for bfloat16 features
// (the JAX float32 sum, then the astype); for float32 features the
// scratch is the result.  The atomics' order changes from run to run, so
// float32 results agree with the plain version up to the summation order.

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

// Adds w * g[0..n) to the n float32 channels at dst (16-byte aligned).
template <int n>
__device__ __forceinline__ void scatter_add(float* dst, float w,
                                            const float (&g)[n]) {
#pragma unroll
  for (int i = 0; i < n; i += 4) {
    atomicAdd(reinterpret_cast<float4*>(dst + i),
              make_float4(w * g[i], w * g[i + 1], w * g[i + 2], w * g[i + 3]));
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    roi_align_bwd_kernel(const T* __restrict__ grad,
                         const float* __restrict__ rois,
                         float* __restrict__ dfeat, int H, int W, int C,
                         int S, int P, int Q, float scale, int sampling_ratio,
                         int cap_h, int cap_w, int bin_stride, int out_p,
                         int out_q, int rows) {
  using V = Vec<T>;
  constexpr int kVec = V::n;
  extern __shared__ int smem[];
  const int roi_id = blockIdx.x;  // b * S + s
  const int b = roi_id / S;
  const int p0 = blockIdx.y * rows;
  const int p1 = min(out_p, p0 + rows);
  const TapLists t = build_tap_lists(
      smem, rois + (size_t)roi_id * 4, H, W, P, Q, scale, sampling_ratio,
      cap_h, cap_w, bin_stride, out_p, out_q, p0, p1);

  float* fb = dfeat + (size_t)b * H * W * C;
  const T* gb = grad + (size_t)roi_id * out_p * out_q * C;
  for (int cv = threadIdx.x * kVec; cv < C; cv += blockDim.x * kVec) {
    float* f = fb + cv;
    for (int p = p0; p < p1; ++p) {
      const int* yo = t.yoff + p * t.ly;
      const float* ywp = t.yw + p * t.ly;
      const int nyp = t.ny[p];
      for (int q = 0; q < out_q; ++q) {
        const int* xo = t.xoff + q * t.lx;
        const float* xwq = t.xw + q * t.lx;
        const int nxq = t.nx[q];
        float g[kVec];
        V::unpack(__ldg(reinterpret_cast<const typename V::raw*>(
                      gb + ((size_t)p * out_q + q) * C + cv)),
                  g);
        for (int iy = 0; iy < nyp; ++iy) {
          const float wy = ywp[iy];
          for (int ix = 0; ix < nxq; ++ix) {
            scatter_add(f + (size_t)(yo[iy] + xo[ix]) * C, wy * xwq[ix], g);
          }
        }
      }
    }
  }
}

// n4 groups of 4 float32 values to bfloat16, round to nearest even.
__global__ void cast_to_bf16_kernel(const float4* __restrict__ in,
                                    uint2* __restrict__ out, size_t n4) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    const float4 v = in[i];
    __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    out[i] = make_uint2(*reinterpret_cast<uint32_t*>(&lo),
                        *reinterpret_cast<uint32_t*>(&hi));
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

template <typename T>
cudaError_t launch_backward(const void* grad, const void* rois,
                            void* scratch, int B, int H, int W, int C, int S,
                            int P, int Q, float scale, int sampling_ratio,
                            int cap_h, int cap_w, int bin_stride,
                            cudaStream_t st) {
  const Geometry g = geometry<T>(B, C, S, P, Q, cap_h, cap_w, bin_stride);
  if (g.smem > 48 * 1024) return cudaErrorInvalidValue;
  roi_align_bwd_kernel<T><<<g.grid, g.threads, g.smem, st>>>(
      static_cast<const T*>(grad), static_cast<const float*>(rois),
      static_cast<float*>(scratch), H, W, C, S, P, Q, scale, sampling_ratio,
      cap_h, cap_w, bin_stride, g.out_p, g.out_q, g.rows);
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
// aligned; rois as for the forward; scratch [B, H, W, C] float32, zeroed
// by the caller, receives the float32 sums.  For bfloat16 (bf16 = 1) the
// result is then cast into out [B, H, W, C] bfloat16; for float32 the
// scratch is the result and out is not touched.
extern "C" int roi_align_backward(const void* grad, const void* rois,
                                  void* scratch, void* out, int B, int H,
                                  int W, int C, int S, int P, int Q,
                                  float spatial_scale, int sampling_ratio,
                                  int max_samples, int bin_stride, int bf16,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int cap_h, cap_w;
  sample_caps(H, W, P, Q, sampling_ratio, max_samples, &cap_h, &cap_w);
  cudaError_t err =
      bf16 ? launch_backward<__nv_bfloat16>(grad, rois, scratch, B, H, W, C,
                                            S, P, Q, spatial_scale,
                                            sampling_ratio, cap_h, cap_w,
                                            bin_stride, st)
           : launch_backward<float>(grad, rois, scratch, B, H, W, C, S, P, Q,
                                    spatial_scale, sampling_ratio, cap_h,
                                    cap_w, bin_stride, st);
  if (err != cudaSuccess || !bf16) return static_cast<int>(err);
  const size_t n4 = (size_t)B * H * W * C / 4;
  const int threads = 256;
  const size_t want = (n4 + threads - 1) / threads;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  cast_to_bf16_kernel<<<blocks, threads, 0, st>>>(
      static_cast<const float4*>(scratch), static_cast<uint2*>(out), n4);
  return static_cast<int>(cudaGetLastError());
}
