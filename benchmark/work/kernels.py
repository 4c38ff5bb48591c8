"""The work of one launch of the port's kernels, from its inputs: bytes
and operations, and the least time the card could take.

Frozen copies of the bound functions the port's smoke test used when the
benchmark was defined (its ``nms_bound``, ``roi_taps``, ``roi_bound`` and
``roi_bwd_bound``), with their own RoIAlign geometry: each input byte the
launch needs is read once (of RoIAlign's features, the pixels its rois
tap) and each output byte written once, and the operations are
those these inputs need (the IoU tests of this run's greedy scan, two
flops per bilinear tap and channel of each emitted bin), so the count
stays the same whatever implements the op.  They must not follow later
changes to the program.  The bound is the larger of bytes over the HBM
rate and operations over the float32 rate of one H100 SXM.
"""

from typing import Tuple

import torch

from reference import ops

BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_OPS_PER_S = 67e12  # H100 SXM float32, outside the tensor cores
IOU_OPS = 16  # min/max, sub/add, mul, div and compare of one +1 IoU test


def bound_s(byts: float, operations: float) -> float:
    return max(byts / BYTES_PER_S, operations / F32_OPS_PER_S)


def nms_work(scores, valid, labels, idx, keep, k) -> Tuple[float, float]:
    """Bytes: boxes, scores, valid (and labels) read once, indices and the
    mask written once.  Operations: the IoU tests this run's greedy scan
    needs at the least: each kept box against every earlier kept box of
    its label, and each other valid box up to where the scan stops (the
    last kept box, once ``k`` are kept) against one kept box."""
    b, n = scores.shape
    key = torch.where(valid, scores.float(), torch.full_like(scores.float(), -float("inf")))
    order = torch.sort(key, dim=1, descending=True, stable=True).indices
    rank = torch.empty_like(order).scatter_(1, order, torch.arange(n, device=order.device).expand(b, n).contiguous())
    tests = 0
    for i in range(b):
        kept = idx[i][keep[i]].to(torch.int64)
        c = kept.numel()
        stop = int(rank[i, kept[-1]]) if c == k else n - 1
        tests += int((valid[i] & (rank[i] <= stop)).sum()) - c
        per_label = torch.bincount(labels[i][kept].to(torch.int64)) if labels is not None else torch.tensor([c])
        tests += int((per_label * (per_label - 1) // 2).sum())
    byts = b * (n * (16 + 4 + 1 + (4 if labels is not None else 0)) + k * (4 + 1))
    return float(byts), float(IOU_OPS * tests)


def _geometry(rois, scale, P, Q, H, W, sampling_ratio, max_samples):
    r = rois.to(torch.float32)
    sw, sh = r[..., 0] * scale, r[..., 1] * scale
    rw = (r[..., 2] * scale - sw).clamp(min=1.0)
    rh = (r[..., 3] * scale - sh).clamp(min=1.0)
    bh, bw = rh / torch.full_like(rh, P), rw / torch.full_like(rw, Q)
    if sampling_ratio > 0:
        cap_h = cap_w = sampling_ratio
        gh = gw = torch.full(rh.shape, sampling_ratio, dtype=torch.int32, device=rois.device)
    else:
        cap_h, cap_w = min(max_samples, -(-H // P)), min(max_samples, -(-W // Q))
        gh = torch.ceil(bh).to(torch.int32).clamp(1, cap_h)
        gw = torch.ceil(bw).to(torch.int32).clamp(1, cap_w)
    return (sh, bh, gh, cap_h), (sw, bw, gw, cap_w)


def roi_taps(feature_shape, rois, output_size, scale, sampling_ratio, max_samples, bin_stride) -> Tuple[float, int, float]:
    """(taps, emitted bins per roi, feature pixels read): a tap is a
    (nonzero A_y entry, nonzero A_x entry) pair of an emitted bin; a pixel
    is read when some roi of its image taps its row and its column."""
    B, H, W, _ = feature_shape
    P, Q = output_size
    (sh, bh, gh, ch), (sw, bw, gw, cw) = _geometry(rois, scale, P, Q, H, W, sampling_ratio, max_samples)
    taps, pixels = 0.0, 0.0
    for b in range(B):
        ay = ops._axis_matrix(sh[b], bh[b], gh[b], H, P, ch, bin_stride) != 0
        ax = ops._axis_matrix(sw[b], bw[b], gw[b], W, Q, cw, bin_stride) != 0
        ny = ay.sum(-1).to(torch.float64)
        nx = ax.sum(-1).to(torch.float64)
        taps += float((ny.sum(-1) * nx.sum(-1)).sum())
        rows, cols = ay.any(1).to(torch.float32), ax.any(1).to(torch.float32)  # [S, H], [S, W]
        pixels += float(((rows.T @ cols) > 0).sum())
    return taps, -(-P // bin_stride) * -(-Q // bin_stride), pixels


def roi_align_work(features_shape, element_size, rois, output_size, scale, sampling_ratio, max_samples,
                   bin_stride) -> Tuple[float, float]:
    """Bytes: the feature pixels these rois tap and the rois read once,
    the output (in the features' dtype) written once.  Operations: two
    flops per tap and channel."""
    B, H, W, C = features_shape
    S = rois.shape[1]
    taps, bins, pixels = roi_taps(features_shape, rois, output_size, scale, sampling_ratio, max_samples, bin_stride)
    byts = (pixels * C + B * S * bins * C) * element_size + rois.numel() * 4
    return float(byts), 2.0 * taps * C


def roi_align_backward_work(grad_shape, element_size, rois, feature_shape, output_size, scale, sampling_ratio,
                            max_samples, bin_stride) -> Tuple[float, float]:
    """Bytes: the cotangent and rois read once, dF (in the features'
    dtype) written once.  Operations: two flops per tap and channel."""
    C = feature_shape[3]
    taps, _, _ = roi_taps(feature_shape, rois, output_size, scale, sampling_ratio, max_samples, bin_stride)
    n_grad = 1
    for d in grad_shape:
        n_grad *= d
    n_feat = 1
    for d in feature_shape:
        n_feat *= d
    byts = (n_grad + n_feat) * element_size + rois.numel() * 4
    return float(byts), 2.0 * taps * C
