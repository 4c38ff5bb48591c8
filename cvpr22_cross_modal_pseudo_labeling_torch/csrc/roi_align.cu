// RoIAlign forward over channels-last float32 features, for Hopper (sm_90a).
//
// Replaces: cvpr22_cross_modal_pseudo_labeling_tpu/tools/
// proto_pallas_roialign.py::run_fused / fwd_kernel / fwd_kernel_sloop and
// ::run_fused_bigdot / fwd_kernel_bigdot, the Pallas TPU kernels of the
// contraction out[b,s,p,q,c] = sum_h,w Ay[b,s,p,h] F[b,h,w,c] Ax[b,s,q,w]
// that the main path's pooler computes through ops/roi_align_mxu.py::
// roi_align_mxu.  The numerics are those of the JAX ops/roi_align.py::
// roi_align and _bilinear_weights (roi size max(.,1), no half-pixel shift,
// adaptive grid ceil(roi/bins) clipped to [1, min(max_samples,
// ceil(size/bins))], samples outside [-1, size] dropped, edge clamp), and
// bin_stride emits every bin_stride-th bin of the output_size grid.
//
// What bounds it on the H100: bytes.  The function must read the feature
// map once and write R x P' x Q' x C floats (8 x 1000 rois x 7 x 7 x 1024
// f32 is 1.6 GB on the main path, about 0.5 ms at 3.35 TB/s), and it does
// a few multiply-adds per tap.  A TPU has no gather unit, so the JAX
// package turned the op into dense matmuls against interpolation
// matrices; on the H100 a direct gather from L2 is the natural form, and
// the matmul form would multiply by millions of zeros.
//
// Design: one CTA per (output bin, roi, image) and one thread per group of
// four channels (float4; C = 1024 gives 256 threads, neighbouring threads
// on neighbouring 16-byte words, so every tap is one coalesced 4 KB row
// read).  Two threads of the CTA first build the bin's rows of A_y and
// A_x in shared memory with the JAX arithmetic, rounded op by op (no FMA
// contraction), so the weights equal the plain version's; the CTA then
// walks only the nonzero rows and columns of that support, which merges
// the taps that neighbouring samples share (about (g_h+1)(g_w+1) loads
// instead of 4 g_h g_w).  One image's C4 map (50 x 84 x 1024 f32, 17 MB)
// fits in the 50 MB L2, and the grid runs image by image, so the repeated
// tap reads are served from L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// One axis of one bin: accumulates the bilinear tap weights of the bin's
// samples into a[0:size) (zeroed by the caller) and returns the touched
// range in [*lo_out, *hi_out] (empty when *lo_out > *hi_out).
__device__ void axis_weights(float c0, float c1, float scale, int bins,
                             int size, int p, int sampling_ratio, int s_cap,
                             float* a, int* lo_out, int* hi_out) {
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
  int first = size, last = -1;
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
    a[lo] = __fadd_rn(a[lo], __fsub_rn(1.0f, l));
    a[hi] = __fadd_rn(a[hi], l);
    first = min(first, lo);
    last = max(last, hi);
  }
  for (int k = first; k <= last; ++k) a[k] = __fdiv_rn(a[k], g);
  *lo_out = first;
  *hi_out = last;
}

__global__ void roi_align_fwd_kernel(const float* __restrict__ feat,
                                     const float* __restrict__ rois,
                                     float* __restrict__ out, int H, int W,
                                     int C, int S, int P, int Q, float scale,
                                     int sampling_ratio, int s_cap_h,
                                     int s_cap_w, int bin_stride, int out_q) {
  extern __shared__ float smem[];  // A_y row [H], A_x row [W]
  float* ay = smem;
  float* ax = smem + H;
  __shared__ int range[4];
  const int bin = blockIdx.x;
  const int s = blockIdx.y;
  const int b = blockIdx.z;
  const int t = threadIdx.x;
  const int out_p = gridDim.x / out_q;
  const float* roi = rois + ((size_t)b * S + s) * 4;

  for (int k = t; k < H + W; k += blockDim.x) smem[k] = 0.0f;
  __syncthreads();
  // the two axes on two different warps
  if (t == 0) {
    axis_weights(roi[1], roi[3], scale, P, H, (bin / out_q) * bin_stride,
                 sampling_ratio, s_cap_h, ay, &range[0], &range[1]);
  } else if (t == 32 || (t == 1 && blockDim.x <= 32)) {
    axis_weights(roi[0], roi[2], scale, Q, W, (bin % out_q) * bin_stride,
                 sampling_ratio, s_cap_w, ax, &range[2], &range[3]);
  }
  __syncthreads();
  const int y0 = range[0], y1 = range[1], x0 = range[2], x1 = range[3];

  const int C4 = C / 4;
  const float4* f = reinterpret_cast<const float4*>(feat) + (size_t)b * H * W * C4;
  float4* o = reinterpret_cast<float4*>(out) +
              (((size_t)b * S + s) * out_p * out_q + bin) * C4;
  for (int c4 = t; c4 < C4; c4 += blockDim.x) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int h = y0; h <= y1; ++h) {
      const float wy = ay[h];
      if (wy == 0.0f) continue;
      float4 row = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4* fr = f + (size_t)h * W * C4 + c4;
      for (int w = x0; w <= x1; ++w) {
        const float wx = ax[w];
        if (wx == 0.0f) continue;
        const float4 v = __ldg(fr + (size_t)w * C4);
        row.x += wx * v.x;
        row.y += wx * v.y;
        row.z += wx * v.z;
        row.w += wx * v.w;
      }
      acc.x += wy * row.x;
      acc.y += wy * row.y;
      acc.z += wy * row.z;
      acc.w += wy * row.w;
    }
    o[c4] = acc;
  }
}

}  // namespace

// features [B, H, W, C] float32 (C % 4 == 0, 16-byte aligned), rois
// [B, S, 4] float32 xyxy in image pixels, out [B, S, ceil(P/bin_stride),
// ceil(Q/bin_stride), C] float32.
extern "C" int roi_align_forward(const void* features, const void* rois,
                                 void* out, int B, int H, int W, int C, int S,
                                 int P, int Q, float spatial_scale,
                                 int sampling_ratio, int max_samples,
                                 int bin_stride, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int s_cap_h = sampling_ratio, s_cap_w = sampling_ratio;
  if (sampling_ratio <= 0) {
    s_cap_h = min(max_samples, (H + P - 1) / P);
    s_cap_w = min(max_samples, (W + Q - 1) / Q);
  }
  const int out_p = (P + bin_stride - 1) / bin_stride;
  const int out_q = (Q + bin_stride - 1) / bin_stride;
  int threads = min(C / 4, 256);
  threads = max(32, (threads + 31) / 32 * 32);
  dim3 grid(out_p * out_q, S, B);
  roi_align_fwd_kernel<<<grid, threads, (H + W) * sizeof(float), st>>>(
      static_cast<const float*>(features), static_cast<const float*>(rois),
      static_cast<float*>(out), H, W, C, S, P, Q, spatial_scale,
      sampling_ratio, s_cap_h, s_cap_w, bin_stride, out_q);
  return static_cast<int>(cudaGetLastError());
}
