// Exact greedy NMS for Hopper (sm_90a).
//
// Replaces: cvpr22_cross_modal_pseudo_labeling_tpu/ops/nms_pallas.py::
// nms_pallas / _nms_kernel (the Pallas TPU kernel) behind the contract of
// ops/nms.py::nms and ::batched_nms.  The caller (ops/nms.py) sorts the
// boxes by where(valid, score, -inf), descending and stable, and gathers
// indices afterwards; this file turns the sorted boxes into the kept
// positions.
//
// What bounds it on the H100: not bytes (a 6000-box problem reads 150 KB)
// and not arithmetic (the N(N-1)/2 IoU tests of eight RPN images are
// about 2 GFLOP of float32, tens of microseconds at the card's rate) but
// the greedy recurrence, which is sequential in score order.
//
// Design: two kernels on the caller's stream, images batched.
//  1. nms_mask_kernel, grid (col_blocks, col_blocks, B), 64 threads:
//     thread i of row block r tests box i against the 64 boxes of column
//     block c >= r (staged in shared memory) and writes one 64-bit word,
//     bit k set when box c*64+k comes later in score order, both boxes
//     are valid, their labels agree and IoU > threshold.  All pair tests
//     run in parallel over the whole card.
//  2. nms_scan_kernel, one CTA per image, no host round trip: for each
//     64-box block, one warp loads the block's diagonal words into shared
//     memory, one thread resolves the 64 boxes in order against them
//     (the only serial part: 64 shared-memory steps per block), and then
//     all threads OR the rows of the boxes just kept into the removed
//     words of the later blocks.  The scan stops once max_outputs boxes
//     are kept, so an RPN pass that keeps 1000 of 6000 boxes never
//     visits the tail.
// The IoU is computed with explicitly rounded intrinsics (no FMA
// contraction) in the JAX operand order, so each comparison equals the
// float32 elementwise result of torch and of the JAX reference bit for
// bit and the kept set is exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;
constexpr int kScanThreads = 256;

__device__ __forceinline__ float area(const float* b) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b[2], b[0]), 1.0f),
                   __fadd_rn(__fsub_rn(b[3], b[1]), 1.0f));
}

// legacy +1 IoU, union floored at 1e-10, strict '>' (ops/nms.py contract)
__device__ __forceinline__ bool iou_above(const float* a, float area_a,
                                          const float* b, float area_b,
                                          float thr) {
  float w = fmaxf(__fadd_rn(__fsub_rn(fminf(a[2], b[2]), fmaxf(a[0], b[0])), 1.0f), 0.0f);
  float h = fmaxf(__fadd_rn(__fsub_rn(fminf(a[3], b[3]), fmaxf(a[1], b[1])), 1.0f), 0.0f);
  float inter = __fmul_rn(w, h);
  float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return __fdiv_rn(inter, fmaxf(uni, 1e-10f)) > thr;
}

__global__ void nms_mask_kernel(const float* __restrict__ boxes,
                                const uint8_t* __restrict__ valid,
                                const int* __restrict__ labels,
                                unsigned long long* __restrict__ mask,
                                int n, int col_blocks, float thr) {
  const int row_block = blockIdx.y;
  const int col_block = blockIdx.x;
  // the scan reads only words at or right of the diagonal
  if (col_block < row_block) return;
  const int b = blockIdx.z;
  boxes += (size_t)b * n * 4;
  valid += (size_t)b * n;
  labels += (size_t)b * n;
  mask += (size_t)b * n * col_blocks;

  const int row_size = min(n - row_block * kBlock, kBlock);
  const int col_size = min(n - col_block * kBlock, kBlock);
  __shared__ float cbox[kBlock * 4];
  __shared__ float carea[kBlock];
  __shared__ int clabel[kBlock];
  __shared__ uint8_t cvalid[kBlock];
  const int t = threadIdx.x;
  if (t < col_size) {
    const int j = col_block * kBlock + t;
#pragma unroll
    for (int k = 0; k < 4; ++k) cbox[t * 4 + k] = boxes[j * 4 + k];
    carea[t] = area(&cbox[t * 4]);
    clabel[t] = labels[j];
    cvalid[t] = valid[j];
  }
  __syncthreads();
  if (t >= row_size) return;
  const int i = row_block * kBlock + t;
  unsigned long long bits = 0;
  if (valid[i]) {
    float a[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) a[k] = boxes[i * 4 + k];
    const float area_a = area(a);
    const int label = labels[i];
    const int start = (row_block == col_block) ? t + 1 : 0;
    for (int k = start; k < col_size; ++k) {
      if (cvalid[k] && clabel[k] == label &&
          iou_above(a, area_a, &cbox[k * 4], carea[k], thr)) {
        bits |= 1ULL << k;
      }
    }
  }
  mask[(size_t)i * col_blocks + col_block] = bits;
}

__global__ void nms_scan_kernel(const unsigned long long* __restrict__ mask,
                                const uint8_t* __restrict__ valid,
                                int n, int col_blocks, int max_outputs,
                                int* __restrict__ keep_pos,
                                int* __restrict__ keep_count) {
  extern __shared__ unsigned long long removed[];  // [col_blocks]
  __shared__ unsigned long long diag[kBlock];
  __shared__ uint8_t dvalid[kBlock];
  __shared__ unsigned long long kept_word;
  __shared__ int count;
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  mask += (size_t)b * n * col_blocks;
  valid += (size_t)b * n;
  keep_pos += (size_t)b * max_outputs;

  for (int w = t; w < col_blocks; w += blockDim.x) removed[w] = 0ULL;
  if (t == 0) count = 0;
  __syncthreads();

  for (int r = 0; r < col_blocks; ++r) {
    const int size = min(n - r * kBlock, kBlock);
    if (t < kBlock) {
      const int i = r * kBlock + t;
      diag[t] = t < size ? mask[(size_t)i * col_blocks + r] : 0ULL;
      dvalid[t] = t < size ? valid[i] : 0;
    }
    __syncthreads();
    if (t == 0) {
      unsigned long long rem = removed[r];
      unsigned long long kw = 0ULL;
      int c = count;
      for (int k = 0; k < size && c < max_outputs; ++k) {
        if (!dvalid[k] || ((rem >> k) & 1ULL)) continue;
        kw |= 1ULL << k;
        keep_pos[c++] = r * kBlock + k;
        rem |= diag[k];
      }
      kept_word = kw;
      count = c;
    }
    __syncthreads();
    if (count >= max_outputs) break;  // uniform: every thread reads the same count
    const unsigned long long kw = kept_word;
    if (kw != 0ULL) {
      for (int w = r + 1 + t; w < col_blocks; w += blockDim.x) {
        unsigned long long acc = removed[w];
        const unsigned long long* col = mask + (size_t)r * kBlock * col_blocks + w;
#pragma unroll 8
        for (int k = 0; k < kBlock; ++k) {
          if ((kw >> k) & 1ULL) acc |= col[(size_t)k * col_blocks];
        }
        removed[w] = acc;
      }
    }
    __syncthreads();
  }
  const int c = count;
  for (int k = c + t; k < max_outputs; k += blockDim.x) keep_pos[k] = -1;
  if (t == 0) keep_count[b] = c;
}

}  // namespace

// boxes [B, N, 4] float32, valid [B, N] uint8 and labels [B, N] int32, all
// in descending score order; mask [B, N, ceil(N/64)] uint64 scratch.
// Writes keep_pos [B, max_outputs] int32 (sorted positions of the kept
// boxes in order, -1 after the last) and keep_count [B] int32.
extern "C" int nms_forward(const void* boxes, const void* valid,
                           const void* labels, void* keep_pos,
                           void* keep_count, void* mask, int B, int N,
                           int max_outputs, float iou_threshold,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int col_blocks = (N + kBlock - 1) / kBlock;
  dim3 grid(col_blocks, col_blocks, B);
  nms_mask_kernel<<<grid, kBlock, 0, s>>>(
      static_cast<const float*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<const int*>(labels),
      static_cast<unsigned long long*>(mask), N, col_blocks, iou_threshold);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_scan_kernel<<<B, kScanThreads, col_blocks * sizeof(unsigned long long), s>>>(
      static_cast<const unsigned long long*>(mask),
      static_cast<const uint8_t*>(valid), N, col_blocks, max_outputs,
      static_cast<int*>(keep_pos), static_cast<int*>(keep_count));
  return static_cast<int>(cudaGetLastError());
}
