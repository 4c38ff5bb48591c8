"""Plain float32 box arithmetic, NMS and RoIAlign for the reference.

Frozen copies of the plain versions of the detector's operations, as the
benchmark was defined: the reference holds what the timed path produces
against these and must not follow later changes to the program.  Every
function is plain PyTorch and runs on any device.  Boxes are ``x1, y1,
x2, y2`` in pixels with the ``+ 1`` width convention of
maskrcnn_benchmark.
"""

import math
import torch
import torch.nn.functional as F

TO_REMOVE = 1.0
BBOX_XFORM_CLIP = math.log(1000.0 / 16)
NMS_TILE = 256
ROI_CHUNK = 128


def box_area(boxes):
    return (boxes[..., 2] - boxes[..., 0] + TO_REMOVE) * (boxes[..., 3] - boxes[..., 1] + TO_REMOVE)


def box_iou(a, b):
    """``[..., N, 4]`` x ``[..., M, 4]`` -> ``[..., N, M]``."""
    x1 = torch.maximum(a[..., :, None, 0], b[..., None, :, 0])
    y1 = torch.maximum(a[..., :, None, 1], b[..., None, :, 1])
    x2 = torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
    y2 = torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
    inter = (x2 - x1 + TO_REMOVE).clamp(min=0.0) * (y2 - y1 + TO_REMOVE).clamp(min=0.0)
    union = box_area(a)[..., :, None] + box_area(b)[..., None, :] - inter
    return inter / union.clamp(min=1e-10)


def clip_to_image(boxes, image_size):
    h = image_size[..., 0].to(boxes.dtype)[..., None]
    w = image_size[..., 1].to(boxes.dtype)[..., None]
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    return torch.stack([
        torch.clamp(boxes[..., 0], zero, w - TO_REMOVE),
        torch.clamp(boxes[..., 1], zero, h - TO_REMOVE),
        torch.clamp(boxes[..., 2], zero, w - TO_REMOVE),
        torch.clamp(boxes[..., 3], zero, h - TO_REMOVE),
    ], dim=-1)


def encode_boxes(targets, proposals, weights):
    wx, wy, ww, wh = weights
    ex_w = (proposals[..., 2] - proposals[..., 0] + 1.0).clamp(min=1e-8)
    ex_h = (proposals[..., 3] - proposals[..., 1] + 1.0).clamp(min=1e-8)
    ex_cx = proposals[..., 0] + 0.5 * ex_w
    ex_cy = proposals[..., 1] + 0.5 * ex_h
    gt_w = (targets[..., 2] - targets[..., 0] + 1.0).clamp(min=1e-8)
    gt_h = (targets[..., 3] - targets[..., 1] + 1.0).clamp(min=1e-8)
    gt_cx = targets[..., 0] + 0.5 * gt_w
    gt_cy = targets[..., 1] + 0.5 * gt_h
    return torch.stack([
        wx * (gt_cx - ex_cx) / ex_w, wy * (gt_cy - ex_cy) / ex_h,
        ww * torch.log(gt_w / ex_w), wh * torch.log(gt_h / ex_h),
    ], dim=-1)


def decode_boxes(codes, boxes, weights):
    """``codes [..., 4k]`` relative to ``boxes [..., 4]``."""
    boxes = boxes.to(codes.dtype)
    widths = boxes[..., 2] - boxes[..., 0] + 1.0
    heights = boxes[..., 3] - boxes[..., 1] + 1.0
    ctr_x = boxes[..., 0] + 0.5 * widths
    ctr_y = boxes[..., 1] + 0.5 * heights
    c = codes.reshape(codes.shape[:-1] + (-1, 4)) / torch.tensor(weights, dtype=codes.dtype, device=codes.device)
    pred_cx = c[..., 0] * widths[..., None] + ctr_x[..., None]
    pred_cy = c[..., 1] * heights[..., None] + ctr_y[..., None]
    pred_w = torch.exp(c[..., 2].clamp(max=BBOX_XFORM_CLIP)) * widths[..., None]
    pred_h = torch.exp(c[..., 3].clamp(max=BBOX_XFORM_CLIP)) * heights[..., None]
    out = torch.stack([pred_cx - 0.5 * pred_w, pred_cy - 0.5 * pred_h,
                       pred_cx + 0.5 * pred_w - 1.0, pred_cy + 0.5 * pred_h - 1.0], dim=-1)
    return out.reshape(codes.shape)


def smooth_l1(pred, target, beta):
    n = torch.abs(pred - target)
    return torch.where(n < beta, 0.5 * n ** 2 / beta, n - 0.5 * beta)


def bce_with_logits(logits, targets):
    return -(targets * F.logsigmoid(logits) + (1.0 - targets) * F.logsigmoid(-logits))


def sorted_top_k(x, k):
    """The ``k`` largest of the last axis, ties to the lower index."""
    idx = torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]
    return torch.gather(x, -1, idx), idx


def nms(boxes, scores, valid, iou_threshold, max_outputs, labels=None):
    """Exact greedy NMS over ``[B, N, 4]``, highest score first (stable),
    only boxes of one label suppressing each other.  Returns the kept
    indices ``[B, max_outputs]`` in score order and their valid mask."""
    boxes, scores = boxes.to(torch.float32), scores.to(torch.float32)
    b, n = scores.shape
    if labels is None:
        labels = torch.zeros((b, n), dtype=torch.int64, device=boxes.device)
    key = torch.where(valid, scores, torch.full_like(scores, -float("inf")))
    order = torch.sort(key, dim=1, descending=True, stable=True).indices
    sboxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    svalid = torch.gather(valid, 1, order)
    slabels = torch.gather(labels, 1, order)
    kept = torch.zeros((b, n), dtype=torch.bool, device=boxes.device)
    for start in range(0, n, NMS_TILE):
        end = min(start + NMS_TILE, n)
        tb, tl = sboxes[:, start:end], slabels[:, start:end]
        alive = svalid[:, start:end]
        if start > 0:
            over = (box_iou(sboxes[:, :start], tb) > iou_threshold) & (slabels[:, :start, None] == tl[:, None, :])
            alive = alive & ~(kept[:, :start, None] & over).any(dim=1)
        t = end - start
        over = (box_iou(tb, tb) > iou_threshold) & (tl[:, :, None] == tl[:, None, :])
        over &= torch.ones((t, t), dtype=torch.bool, device=boxes.device).triu(1)
        keep = alive
        while True:
            new = alive & ~(keep[:, :, None] & over).any(dim=1)
            if torch.equal(new, keep):
                break
            keep = new
        kept[:, start:end] = keep
    pos = torch.where(kept, torch.arange(n, device=boxes.device), n)
    k = min(max_outputs, n)
    first = torch.sort(pos, dim=1).values[:, :k]
    count = kept.sum(dim=1).clamp(max=max_outputs)
    out_valid = torch.arange(max_outputs, device=boxes.device)[None, :] < count[:, None]
    idx = torch.zeros((b, max_outputs), dtype=torch.int64, device=boxes.device)
    idx[:, :k] = torch.gather(order, 1, first.clamp(max=n - 1))
    return torch.where(out_valid, idx, 0), out_valid


def _bilinear(coord, size):
    in_range = (coord >= -1.0) & (coord <= size)
    c = coord.clamp(min=0.0)
    lo = torch.floor(c).to(torch.int64)
    at_edge = lo >= size - 1
    lo = torch.where(at_edge, size - 1, lo)
    hi = torch.where(at_edge, size - 1, lo + 1)
    c = torch.where(at_edge, lo.to(c.dtype), c)
    frac = c - lo.to(c.dtype)
    return lo, hi, 1.0 - frac, frac, in_range


def _axis_matrix(start, bin_size, grid, size, bins, cap, bin_stride):
    """Each emitted bin's bilinear tap weights over one axis, averaged over
    the roi's sampling grid: ``[R, ceil(bins / bin_stride), size]``."""
    p = torch.arange(0, bins, bin_stride, dtype=start.dtype, device=start.device)[None, :]
    pos = torch.arange(size, device=start.device)[None, None, :]
    a = torch.zeros((start.shape[0], p.shape[1], size), dtype=start.dtype, device=start.device)
    g = grid[:, None].to(start.dtype)
    for i in range(cap):
        coord = start[:, None] + p * bin_size[:, None] + (i + 0.5) * bin_size[:, None] / g
        lo, hi, w_lo, w_hi, in_range = _bilinear(coord, size)
        ok = (in_range & (i < grid[:, None])).to(start.dtype)
        a = a + (w_lo * ok)[:, :, None] * (pos == lo[:, :, None]) + (w_hi * ok)[:, :, None] * (pos == hi[:, :, None])
    return a / g[:, :, None]


def roi_align(features, rois, output_size, spatial_scale, sampling_ratio=0, max_samples=8, bin_stride=1):
    """RoIAlign (``aligned=False``, adaptive grid capped at ``max_samples``)
    of ``features [B, H, W, C]`` at ``rois [B, S, 4]``: ``[B, S, P', Q',
    C]`` with every ``bin_stride``-th bin, as a differentiable einsum."""
    P, Q = output_size
    B, H, W, C = features.shape
    S = rois.shape[1]
    r = rois.to(torch.float32)
    sw, sh = r[..., 0] * spatial_scale, r[..., 1] * spatial_scale
    rw = (r[..., 2] * spatial_scale - sw).clamp(min=1.0)
    rh = (r[..., 3] * spatial_scale - sh).clamp(min=1.0)
    bh, bw = rh / torch.full_like(rh, P), rw / torch.full_like(rw, Q)
    if sampling_ratio > 0:
        cap_h = cap_w = sampling_ratio
        gh = gw = torch.full(rh.shape, sampling_ratio, dtype=torch.int32, device=rois.device)
    else:
        cap_h, cap_w = min(max_samples, -(-H // P)), min(max_samples, -(-W // Q))
        gh = torch.ceil(bh).to(torch.int32).clamp(1, cap_h)
        gw = torch.ceil(bw).to(torch.int32).clamp(1, cap_w)
    rows = []
    for b in range(B):
        for s0 in range(0, S, ROI_CHUNK):
            s = slice(s0, min(s0 + ROI_CHUNK, S))
            a_y = _axis_matrix(sh[b, s], bh[b, s], gh[b, s], H, P, cap_h, bin_stride)
            a_x = _axis_matrix(sw[b, s], bw[b, s], gw[b, s], W, Q, cap_w, bin_stride)
            tmp = torch.einsum("sph,hwc->spwc", a_y, features[b])
            rows.append(torch.einsum("spwc,sqw->spqc", tmp, a_x))
    out = torch.cat(rows, dim=0)
    return out.reshape(B, S, *out.shape[1:])


def crop_resize_from_box_frame(src_mask, src_box, dst_box, size):
    """Masks ``[R, m, m]`` drawn in ``src_box`` resampled bilinearly onto a
    ``size x size`` grid over ``dst_box``."""
    m = src_mask.shape[-1]

    def taps(coords):
        i0 = torch.floor(coords).to(torch.int64)
        frac = coords - i0.to(coords.dtype)
        zero = torch.zeros((), dtype=coords.dtype, device=coords.device)
        w0 = torch.where((i0 >= 0) & (i0 <= m - 1), 1.0 - frac, zero)
        w1 = torch.where((i0 + 1 >= 0) & (i0 + 1 <= m - 1), frac, zero)
        pos = torch.arange(m, device=coords.device)
        return (w0[..., None] * (pos == i0.clamp(0, m - 1)[..., None])
                + w1[..., None] * (pos == (i0 + 1).clamp(0, m - 1)[..., None]))

    def centers(start, extent):
        grid = torch.arange(size, device=extent.device, dtype=extent.dtype) + 0.5
        return start[:, None] + grid[None, :] * extent[:, None] / float(size)

    src_w = src_box[:, 2] - src_box[:, 0] + 1.0
    src_h = src_box[:, 3] - src_box[:, 1] + 1.0
    ys = (centers(dst_box[:, 1], dst_box[:, 3] - dst_box[:, 1] + 1.0) - src_box[:, 1, None]) / src_h[:, None] * m - 0.5
    xs = (centers(dst_box[:, 0], dst_box[:, 2] - dst_box[:, 0] + 1.0) - src_box[:, 0, None]) / src_w[:, None] * m - 0.5
    return taps(ys) @ src_mask.to(torch.float32) @ taps(xs).transpose(1, 2)


def _through(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """``x`` through ``dtype`` with one scale per tensor (its largest
    magnitude mapped to ``top``), back in ``x``'s dtype."""
    scale = top / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


class _Float8(torch.autograd.Function):
    """Forward through float8 e4m3, backward through e5m2: the formats a
    float8 training path computes its activations and its gradients in."""

    @staticmethod
    def forward(ctx, x):
        return _through(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _through(g, torch.float8_e5m2, 57344.0)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded as a float8 path would hold it: e4m3 in the forward,
    and the gradient that flows back through it e5m2."""
    return _Float8.apply(x)


def rounding(precision: str):
    """The rounding of every conv and matmul's inputs, weights and outputs:
    none for ``float32``, float8 for the control."""
    if precision == "float32":
        return lambda x: x
    if precision == "float8":
        return round_fp8
    raise ValueError(f"unknown reference precision {precision!r}")
