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
  // per emitted row: <= ly (row offset h * W, weight); per column: <= lx
  // (w, weight); then the counts
  extern __shared__ int smem[];
  const int ly = 2 * cap_h, lx = 2 * cap_w;
  int* yoff = smem;
  float* yw = reinterpret_cast<float*>(yoff + out_p * ly);
  int* xoff = reinterpret_cast<int*>(yw + out_p * ly);
  float* xw = reinterpret_cast<float*>(xoff + out_q * lx);
  int* ny = reinterpret_cast<int*>(xw + out_q * lx);
  int* nx = ny + out_p;

  const int roi_id = blockIdx.x;  // b * S + s
  const int b = roi_id / S;
  const int p0 = blockIdx.y * rows;  // this CTA's rows of bins
  const int p1 = min(out_p, p0 + rows);
  const float* roi = rois + (size_t)roi_id * 4;
  for (int j = threadIdx.x; j < p1 - p0 + out_q; j += blockDim.x) {
    if (j < p1 - p0) {
      const int p = p0 + j;
      int* ji = yoff + p * ly;
      const int n = axis_taps(roi[1], roi[3], scale, P, H, p * bin_stride,
                              sampling_ratio, cap_h, ji, yw + p * ly);
      for (int k = 0; k < n; ++k) ji[k] *= W;
      ny[p] = n;
    } else {
      const int q = j - (p1 - p0);
      nx[q] = axis_taps(roi[0], roi[2], scale, Q, W, q * bin_stride,
                        sampling_ratio, cap_w, xoff + q * lx, xw + q * lx);
    }
  }
  __syncthreads();

  const T* fb = feat + (size_t)b * H * W * C;
  T* ob = out + (size_t)roi_id * out_p * out_q * C;
  for (int cv = threadIdx.x * kVec; cv < C; cv += blockDim.x * kVec) {
    const T* f = fb + cv;
    for (int p = p0; p < p1; ++p) {
      const int* yo = yoff + p * ly;
      const float* ywp = yw + p * ly;
      const int nyp = ny[p];
      for (int q = 0; q < out_q; ++q) {
        const int* xo = xoff + q * lx;
        const float* xwq = xw + q * lx;
        const int nxq = nx[q];
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

template <typename T>
cudaError_t launch(const void* features, const void* rois, void* out, int B,
                   int H, int W, int C, int S, int P, int Q, float scale,
                   int sampling_ratio, int cap_h, int cap_w, int bin_stride,
                   cudaStream_t st) {
  const int out_p = (P + bin_stride - 1) / bin_stride;
  const int out_q = (Q + bin_stride - 1) / bin_stride;
  const size_t smem =
      (size_t)(out_p * 2 * cap_h + out_q * 2 * cap_w) * 8 + (out_p + out_q) * 4;
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  int threads = min(C / Vec<T>::n, kMaxThreads);
  threads = max(32, (threads + 31) / 32 * 32);
  const int rows = B * S < kSplitBelow ? 1 : out_p;
  const dim3 grid(B * S, (out_p + rows - 1) / rows);
  roi_align_fwd_kernel<T><<<grid, threads, smem, st>>>(
      static_cast<const T*>(features), static_cast<const float*>(rois),
      static_cast<T*>(out), H, W, C, S, P, Q, scale, sampling_ratio, cap_h,
      cap_w, bin_stride, out_p, out_q, rows);
  return cudaGetLastError();
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
  int cap_h = sampling_ratio, cap_w = sampling_ratio;
  if (sampling_ratio <= 0) {
    cap_h = min(max_samples, (H + P - 1) / P);
    cap_w = min(max_samples, (W + Q - 1) / Q);
  }
  const cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(features, rois, out, B, H, W, C, S, P, Q,
                                   spatial_scale, sampling_ratio, cap_h, cap_w,
                                   bin_stride, st)
           : launch<float>(features, rois, out, B, H, W, C, S, P, Q,
                           spatial_scale, sampling_ratio, cap_h, cap_w,
                           bin_stride, st);
  return static_cast<int>(err);
}
