// Exact greedy NMS for Hopper (sm_90a).
//
// Replaces: cvpr22_cross_modal_pseudo_labeling_tpu/ops/nms_pallas.py::
// nms_pallas / _nms_kernel (the Pallas TPU kernel) behind the contract of
// ops/nms.py::nms and ::batched_nms.  The caller (ops/nms.py) sorts the
// keys where(valid, score, -inf), descending and stable, and passes the
// sort's int64 indices (`order`); this file reads boxes, labels and
// validity through them and writes the final [B, max_outputs] int32
// indices (order[pos] of each kept position, 0 in padded slots) and the
// valid mask.
//
// What bounds it on the H100: not bytes (a 6000-box problem reads 150 KB)
// and not arithmetic (the IoU tests that the greedy scan needs are a few
// million float32 divides, about a microsecond at the card's rate) but
// the greedy recurrence, which is sequential in score order.
//
// Design: two kernels on the caller's stream, images batched.  Boxes are
// taken in blocks of 64 in score order; "box i suppresses box j" means
// i < j, both valid, same label and IoU > threshold.
//  1. nms_mask_kernel, CTAs of 64 threads over the (row block r, column
//     block c >= r) tiles of each image.  For c > r, thread i tests box
//     r*64+i against the 64 boxes of block c (staged in shared memory) and
//     writes one 64-bit word of the boxes it suppresses.  For c == r,
//     thread j writes the word of the boxes of its own block that suppress
//     box r*64+j, and the CTA writes the block's validity word.  Pairs
//     whose intersection is empty skip the divide: their IoU is 0 whatever
//     the union.
//  2. nms_scan_kernel, one CTA of 16 warps per image, no host round trip,
//     one step per block.  Warp 0 resolves block r: its kept set is the
//     fixpoint of keep = alive & ~(boxes suppressed by a kept box of the
//     block), one ballot per lane half per round, which is the greedy
//     result (the fixpoint is unique) in as many rounds as the longest
//     chain of suppressions, with no serial walk over the boxes.  It writes
//     the kept boxes' indices.  Meanwhile the other 15 warps load word r+1
//     of every box kept so far (the next block's removed word is computed
//     lazily, from these words only), word r+1 of block r's rows, and
//     block r+1's own words and indices; after the step, warp-wide ORs
//     give block r+1's removed word.  The scan stops once max_outputs boxes
//     are kept.
// The scan reads column c of the mask only once it reaches block c, so
// the columns are computed in bands, a mask launch and a scan launch each:
// the first band holds enough blocks for max_outputs boxes (at least 16)
// and at least as many as the last finished call of the same shape
// needed (the caller's stop hint, which the call updates), each next band
// doubles the columns covered, and a band's mask CTAs exit at once when
// the scan has already stopped.  An RPN pass that keeps 1000 of 6000 boxes stops near
// block 25 of 94 and computes the tiles of about 26 columns, a thirteenth
// of the triangle; a pass that never stops early takes one band.
// The IoU is computed with explicitly rounded intrinsics (no FMA
// contraction) in the JAX operand order, so each comparison equals the
// float32 elementwise result of torch and of the JAX reference bit for
// bit and the kept set is exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kBlock = 64;
constexpr int kDiagWords = kBlock + 1;  // 64 column words, then validity
constexpr int kScanThreads = 512;
constexpr int kMaxKept = 49152;  // kept positions the scan lists in shared memory
constexpr int kMaskCtas = 1024;  // per image and band: enough to fill the card
constexpr int kFirstBand = 16;  // blocks: a smaller problem takes one band
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float area(float4 b) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), 1.0f),
                   __fadd_rn(__fsub_rn(b.w, b.y), 1.0f));
}

// legacy +1 IoU, union floored at 1e-10, strict '>' (ops/nms.py contract)
__device__ __forceinline__ bool iou_above(float4 a, float area_a, float4 b,
                                          float area_b, float thr) {
  const float w =
      fmaxf(__fadd_rn(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 1.0f), 0.0f);
  const float h =
      fmaxf(__fadd_rn(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 1.0f), 0.0f);
  const float inter = __fmul_rn(w, h);
  if (inter == 0.0f) return 0.0f > thr;  // 0 / max(union, 1e-10) is 0
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return __fdiv_rn(inter, fmaxf(uni, 1e-10f)) > thr;
}

// kLabelBytes: 0 (no labels: one class), 4 (int32) or 8 (int64)
template <int kLabelBytes>
__device__ __forceinline__ long long label_at(const void* labels, size_t j) {
  if constexpr (kLabelBytes == 8) return static_cast<const long long*>(labels)[j];
  if constexpr (kLabelBytes == 4) return static_cast<const int*>(labels)[j];
  return 0;
}

// column c of the upper block triangle holds the tiles (0..c, c); they
// start at tile index c (c + 1) / 2
__device__ __forceinline__ long long col_offset(long long c) {
  return c * (c + 1) / 2;
}

__device__ __forceinline__ u64 warp_or(u64 v) {
  const unsigned lo = __reduce_or_sync(kFull, (unsigned)v);
  const unsigned hi = __reduce_or_sync(kFull, (unsigned)(v >> 32));
  return ((u64)hi << 32) | lo;
}

// Per image, between the launches of one call: the next block to resolve,
// the count of kept boxes and whether the scan has finished.  One more
// entry after the images' gathers, in `next`, the most columns a scan of
// the call needed.
struct ScanState {
  int next;
  int count;
  int done;
  int pad;
};

template <int kLabelBytes>
__global__ void __launch_bounds__(kBlock)
    nms_mask_kernel(const float4* __restrict__ boxes,
                    const uint8_t* __restrict__ valid,
                    const void* __restrict__ labels,
                    const long long* __restrict__ order,
                    const ScanState* __restrict__ state,
                    u64* __restrict__ mask, u64* __restrict__ diag, int n,
                    int col_blocks, int c0, int c1, float thr) {
  const int b = blockIdx.y;
  if (state[b].done) return;  // the scan stopped before this band
  const size_t base = (size_t)b * n;
  order += base;
  __shared__ float4 cbox[kBlock];
  __shared__ float carea[kBlock];
  __shared__ long long clabel[kBlock];
  __shared__ bool cvalid[kBlock];
  __shared__ unsigned vhalf[2];
  const int t = threadIdx.x;
  const long long last = col_offset(c1);
  for (long long k = col_offset(c0) + blockIdx.x; k < last; k += gridDim.x) {
    int c = (int)((sqrt(8.0 * (double)k + 1.0) - 1.0) * 0.5);
    while (c > 0 && col_offset(c) > k) --c;
    while (col_offset(c + 1) <= k) ++c;
    const int r = (int)(k - col_offset(c));
    const int col_size = min(n - c * kBlock, kBlock);
    __syncthreads();  // the previous tile is done with the staged boxes
    if (t < col_size) {
      const size_t j = base + (size_t)order[c * kBlock + t];
      cbox[t] = boxes[j];
      carea[t] = area(cbox[t]);
      clabel[t] = label_at<kLabelBytes>(labels, j);
      cvalid[t] = valid[j] != 0;
    } else {
      cvalid[t] = false;
    }
    __syncthreads();

    if (r == c) {
      // the boxes of this block that suppress box t, and the validity word
      u64 bits = 0ULL;
      if (cvalid[t]) {
        const float4 a = cbox[t];
        const float area_a = carea[t];
        const long long label = clabel[t];
        for (int j = 0; j < t; ++j) {
          if (cvalid[j] && clabel[j] == label &&
              iou_above(a, area_a, cbox[j], carea[j], thr)) {
            bits |= 1ULL << j;
          }
        }
      }
      u64* d = diag + ((size_t)b * col_blocks + r) * kDiagWords;
      d[t] = bits;
      const unsigned bal = __ballot_sync(kFull, cvalid[t]);
      if ((t & 31) == 0) vhalf[t >> 5] = bal;
      __syncthreads();
      if (t == 0) d[kBlock] = (u64)vhalf[0] | ((u64)vhalf[1] << 32);
      continue;
    }

    // the boxes of block c that box r*64+t suppresses
    if (t >= min(n - r * kBlock, kBlock)) continue;
    const size_t i = base + (size_t)order[r * kBlock + t];
    u64 bits = 0ULL;
    if (valid[i]) {
      const float4 a = boxes[i];
      const float area_a = area(a);
      const long long label = label_at<kLabelBytes>(labels, i);
#pragma unroll 8
      for (int j = 0; j < kBlock; ++j) {
        if (j < col_size && cvalid[j] && (kLabelBytes == 0 || clabel[j] == label) &&
            iou_above(a, area_a, cbox[j], carea[j], thr)) {
          bits |= 1ULL << j;
        }
      }
    }
    mask[((size_t)b * col_blocks * kBlock + r * kBlock + t) * col_blocks + c] = bits;
  }
}

// Resolves blocks state.next .. c1 - 1 of one image per CTA.
__global__ void __launch_bounds__(kScanThreads)
    nms_scan_kernel(const u64* __restrict__ mask, const u64* __restrict__ diag,
                    const long long* __restrict__ order,
                    ScanState* __restrict__ state, int* __restrict__ kept_all,
                    int n, int col_blocks, int c1, int kept_cap,
                    int max_outputs, int* __restrict__ out_idx,
                    uint8_t* __restrict__ out_valid) {
  extern __shared__ int kept_pos[];  // sorted positions of the kept boxes
  __shared__ u64 dwords[2][kDiagWords];  // block r's column words, validity
  __shared__ long long sorder[2][kBlock];  // block r's input indices
  __shared__ u64 rowcol[kBlock];  // word r+1 of block r's rows
  __shared__ u64 partial[kScanThreads / 32];
  __shared__ u64 removed_s;
  __shared__ u64 kept_s;
  __shared__ int count_s;

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int warps = blockDim.x >> 5;
  const int cb = col_blocks;
  ScanState* st = state + b;
  if (st->done) return;
  const int r0 = st->next;
  const int count0 = st->count;
  mask += (size_t)b * cb * kBlock * cb;
  diag += (size_t)b * cb * kDiagWords;
  order += (size_t)b * n;
  kept_all += (size_t)b * kept_cap;
  out_idx += (size_t)b * max_outputs;
  out_valid += (size_t)b * max_outputs;

  // resume: the kept list, block r0's removed word (word r0 of every kept
  // box), its own words and indices
  u64 acc = 0ULL;
  for (int i = t; i < count0; i += blockDim.x) {
    const int p = kept_all[i];
    kept_pos[i] = p;
    acc |= mask[(size_t)p * cb + r0];
  }
  acc = warp_or(acc);
  if (lane == 0) partial[warp] = acc;
  if (t < kDiagWords) dwords[r0 & 1][t] = diag[(size_t)r0 * kDiagWords + t];
  if (t >= 96 && t - 96 < min(n - r0 * kBlock, kBlock)) {
    sorder[r0 & 1][t - 96] = order[r0 * kBlock + t - 96];
  }
  __syncthreads();
  if (warp == 0) {
    acc = lane < warps ? partial[lane] : 0ULL;
    acc = warp_or(acc);
    if (lane == 0) removed_s = acc;
  }
  __syncthreads();

  int count = count0;
  bool done = false;
  int r = r0;
  for (; r < c1; ++r) {
    const int buf = r & 1;
    const int prev = count;
    const bool next_in_band = r + 1 < c1;
    if (warp == 0) {
      const u64 alive = dwords[buf][kBlock] & ~removed_s;
      const u64 w0 = dwords[buf][lane];
      const u64 w1 = dwords[buf][lane + 32];
      u64 keep = alive;
      while (true) {
        const u64 sup = (u64)__ballot_sync(kFull, (w0 & keep) != 0ULL) |
                        ((u64)__ballot_sync(kFull, (w1 & keep) != 0ULL) << 32);
        const u64 next = alive & ~sup;
        if (next == keep) break;
        keep = next;
      }
      // stop at max_outputs: the block's first boxes fill the room left
      const int room = max_outputs - count;
      while (__popcll(keep) > room) keep &= ~(1ULL << (63 - __clzll(keep)));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = lane + 32 * h;
        if ((keep >> k) & 1ULL) {
          const int pos = count + __popcll(keep & ((1ULL << k) - 1ULL));
          out_idx[pos] = (int)sorder[buf][k];
          out_valid[pos] = 1;
          kept_pos[pos] = r * kBlock + k;
        }
      }
      if (lane == 0) {
        kept_s = keep;
        count_s = count + __popcll(keep);
      }
    } else if (next_in_band) {
      // word r+1 of every box kept before this block
      const int u = t - 32;
      u64 a = 0ULL;
#pragma unroll 4
      for (int i = u; i < prev; i += blockDim.x - 32) {
        a |= mask[(size_t)kept_pos[i] * cb + r + 1];
      }
      // block r's rows (masked by its kept set after the step), block r+1
      if (u < kBlock) {
        rowcol[u] = mask[(size_t)(r * kBlock + u) * cb + r + 1];
      } else if (u - kBlock < kDiagWords) {
        dwords[buf ^ 1][u - kBlock] = diag[(size_t)(r + 1) * kDiagWords + u - kBlock];
      } else if (u - kBlock - kDiagWords < min(n - (r + 1) * kBlock, kBlock)) {
        const int j = u - kBlock - kDiagWords;
        sorder[buf ^ 1][j] = order[(r + 1) * kBlock + j];
      }
      a = warp_or(a);
      if (lane == 0) partial[warp] = a;
    }
    __syncthreads();
    count = count_s;
    if (count >= max_outputs || r + 1 == cb) {  // uniform
      done = true;
      break;
    }
    if (!next_in_band) break;  // the next launch computes block c1's removed word
    if (warp == 0) {
      const u64 keep = kept_s;
      u64 a = 0ULL;
      if ((keep >> lane) & 1ULL) a |= rowcol[lane];
      if ((keep >> (lane + 32)) & 1ULL) a |= rowcol[lane + 32];
      if (lane > 0 && lane < warps) a |= partial[lane];
      a = warp_or(a);
      if (lane == 0) removed_s = a;
    }
    __syncthreads();
  }
  for (int i = count0 + t; i < count; i += blockDim.x) kept_all[i] = kept_pos[i];
  if (done) {
    for (int k = count + t; k < max_outputs; k += blockDim.x) {
      out_idx[k] = 0;
      out_valid[k] = 0;
    }
  }
  if (t == 0) {
    st->next = r + 1;
    st->count = count;
    st->done = done;
    if (done) atomicMax(&state[gridDim.x].next, r + 1);
  }
}

template <int kLabelBytes>
cudaError_t launch_mask(dim3 grid, cudaStream_t s, const void* boxes,
                        const void* valid, const void* labels,
                        const void* order, const ScanState* state, u64* mask,
                        u64* diag, int N, int col_blocks, int c0, int c1,
                        float thr) {
  nms_mask_kernel<kLabelBytes><<<grid, kBlock, 0, s>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid),
      labels, static_cast<const long long*>(order), state, mask, diag, N,
      col_blocks, c0, c1, thr);
  return cudaGetLastError();
}

}  // namespace

// boxes [B, N, 4] float32 (16-byte aligned), valid [B, N] uint8 (torch
// bool), labels [B, N] int32 or int64 (label_bytes 4 or 8) or null
// (label_bytes 0), order [B, N] int64: the descending stable sort of
// where(valid, score, -inf).  Scratch: scratch_words uint64 words, at
// least B * cb * (64 * cb + 65) + 2 * (B + 1) + ceil(B * min(N,
// max_outputs) / 2) with cb = ceil(N / 64): the mask words [B, cb * 64,
// cb], each block's 64 column words and its validity word [B, cb, 65],
// the scan's state [B + 1] and its kept positions [B, min(N,
// max_outputs)] int32.  stop_hint: one int32 of pinned host memory, the
// columns the last finished call of this shape needed (0 if none): the
// call reads it when it is enqueued, to size its first band, and copies
// its own count there once its kernels are done.  It sets the band
// schedule only, never the result.
// Writes out_idx [B, max_outputs] int32 (input indices of the kept boxes
// in score order, 0 after the last) and out_valid [B, max_outputs] uint8.
extern "C" int nms_forward(const void* boxes, const void* valid,
                           const void* labels, int label_bytes,
                           const void* order, void* scratch,
                           long long scratch_words, int* stop_hint,
                           void* out_idx, void* out_valid, int B, int N,
                           int max_outputs, float iou_threshold, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cb = (N + kBlock - 1) / kBlock;
  const int kept_cap = max_outputs < N ? max_outputs : N;
  const long long needed = (long long)B * cb * (kBlock * cb + kDiagWords) +
                           2LL * (B + 1) + ((long long)B * kept_cap + 1) / 2;
  if (kept_cap > kMaxKept || scratch_words < needed) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = (size_t)kept_cap * sizeof(int);
  // the opt-in holds per device: made on every call that needs it
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        nms_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  u64* mask = static_cast<u64*>(scratch);
  u64* diag = mask + (size_t)B * cb * kBlock * cb;
  ScanState* state = reinterpret_cast<ScanState*>(diag + (size_t)B * cb * kDiagWords);
  int* kept_all = reinterpret_cast<int*>(state + B + 1);
  cudaError_t err = cudaMemsetAsync(state, 0, sizeof(ScanState) * (B + 1), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  int first = (max_outputs + kBlock - 1) / kBlock + 1;
  if (first < kFirstBand) first = kFirstBand;
  const int hint = *static_cast<volatile int*>(stop_hint);
  if (first < hint) first = hint;
  for (int c0 = 0, c1 = first; c0 < cb; c0 = c1, c1 *= 2) {
    if (c1 > cb) c1 = cb;
    const long long tiles = (long long)c1 * (c1 + 1) / 2 - (long long)c0 * (c0 + 1) / 2;
    dim3 grid((unsigned)(tiles < kMaskCtas ? tiles : kMaskCtas), B);
    if (label_bytes == 8) {
      err = launch_mask<8>(grid, s, boxes, valid, labels, order, state, mask, diag,
                           N, cb, c0, c1, iou_threshold);
    } else if (label_bytes == 4) {
      err = launch_mask<4>(grid, s, boxes, valid, labels, order, state, mask, diag,
                           N, cb, c0, c1, iou_threshold);
    } else {
      err = launch_mask<0>(grid, s, boxes, valid, labels, order, state, mask, diag,
                           N, cb, c0, c1, iou_threshold);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    nms_scan_kernel<<<B, kScanThreads, smem, s>>>(
        mask, diag, static_cast<const long long*>(order), state, kept_all, N,
        cb, c1, kept_cap, max_outputs, static_cast<int*>(out_idx),
        static_cast<uint8_t*>(out_valid));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaMemcpyAsync(stop_hint, &state[B].next, sizeof(int),
                                          cudaMemcpyDeviceToHost, s));
}
