"""Plain float32 R-50-C4 Mask R-CNN with an embedding classifier: the
teacher of ``zeroshot_mask.yaml`` and the student-teacher model of
``student_teacher_mask_rcnn_uncertainty.yaml``, for the benchmark's
comparison.

The architecture follows the paper's code (maskrcnn_benchmark's R-50-C4
Mask R-CNN; OVR-CNN's embedding head; the student-teacher model's caption
pseudo-labels and uncertainty-weighted mask distillation), as the
benchmark was defined; it must not follow later changes to the program.
Parameter and buffer names are the program's state-dict names, so that
one drawn state dict loads into both.  Every conv and linear runs in
float32 (TF32 off, which the caller sets), or with its inputs, weights and
outputs rounded by ``set_precision`` for the control (float8: e4m3 in
the forward, the gradients e5m2).  Tensors are NCHW inside the trunk
and heads; pooling reads ``[B, H, W, C]``.

The random draws of a training forward (the samplers' priorities, the
mask uncertainty's normal samples) are given, as the program's
``TrainDraws`` carries them: ``pseudo_sampler [B, 2, P_test]``,
``gt_sampler [B, 2, P_train + G]``, ``rpn_sampler [B, 2, anchors]`` and
``mask_eps [1, B * cap, M, M, 2]``.
"""

from typing import Dict, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import ops

STAGES = (3, 4, 6)  # R-50's res2-res4 blocks; res5 (3 blocks) is the RoI head
RES5_OUT = 2048  # the res5 head's width, whatever the trunk's


class Conv(nn.Conv2d):
    rnd = staticmethod(lambda x: x)

    def forward(self, x):
        return self.rnd(self._conv_forward(self.rnd(x), self.rnd(self.weight), self.bias))


class ConvT(nn.ConvTranspose2d):
    rnd = staticmethod(lambda x: x)

    def forward(self, x):
        return self.rnd(F.conv_transpose2d(self.rnd(x), self.rnd(self.weight), self.bias, self.stride))


class Lin(nn.Linear):
    rnd = staticmethod(lambda x: x)

    def forward(self, x):
        return self.rnd(F.linear(self.rnd(x), self.rnd(self.weight), self.bias))


class FrozenBN(nn.Module):
    def __init__(self, n):
        super().__init__()
        for name, v in (("weight", 1.0), ("bias", 0.0), ("running_mean", 0.0), ("running_var", 1.0)):
            self.register_buffer(name, torch.full((n,), v))

    def forward(self, x):
        scale = self.weight / torch.sqrt(self.running_var)
        return x * scale[:, None, None] + (self.bias - self.running_mean * scale)[:, None, None]


class Bottleneck(nn.Module):
    def __init__(self, cin, mid, cout, stride):
        super().__init__()
        if cin != cout or stride != 1:
            self.downsample_conv = Conv(cin, cout, 1, stride, bias=False)
            self.downsample_bn = FrozenBN(cout)
        self.conv1 = Conv(cin, mid, 1, stride, bias=False)  # STRIDE_IN_1X1
        self.bn1 = FrozenBN(mid)
        self.conv2 = Conv(mid, mid, 3, 1, 1, bias=False)
        self.bn2 = FrozenBN(mid)
        self.conv3 = Conv(mid, cout, 1, bias=False)
        self.bn3 = FrozenBN(cout)

    def forward(self, x):
        identity = self.downsample_bn(self.downsample_conv(x)) if hasattr(self, "downsample_conv") else x
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        return F.relu(self.bn3(self.conv3(out)) + identity)


def stage(blocks, cin, mid, cout, stride):
    seq = nn.Sequential()
    for i in range(blocks):
        seq.add_module(f"block{i}", Bottleneck(cin if i == 0 else cout, mid, cout, stride if i == 0 else 1))
    return seq


class Stem(nn.Module):
    def __init__(self, cout):
        super().__init__()
        self.conv1 = Conv(3, cout, 7, 2, 3, bias=False)
        self.bn1 = FrozenBN(cout)

    def forward(self, x):
        return F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)


class Body(nn.Module):
    """Stem, res2, res3, res4 (stride 16)."""

    def __init__(self, m):
        super().__init__()
        stem, res2, width = m["stem_out_channels"], m["res2_out_channels"], m["width_per_group"]
        self.stem = Stem(stem)
        cin = stem
        for i, blocks in enumerate(STAGES):
            cout, mid = res2 * 2 ** i, width * 2 ** i
            setattr(self, f"layer{i + 1}", stage(blocks, cin, mid, cout, 1 if i == 0 else 2))
            cin = cout

    def forward(self, x):
        x = self.stem(x)
        for i in range(len(STAGES)):
            x = getattr(self, f"layer{i + 1}")(x)
        return x


class Backbone(nn.Module):
    def __init__(self, m):
        super().__init__()
        self.body = Body(m)


class RPNHead(nn.Module):
    def __init__(self, c, anchors):
        super().__init__()
        self.conv = Conv(c, c, 3, 1, 1)
        self.cls_logits = Conv(c, anchors, 1)
        self.bbox_pred = Conv(c, anchors * 4, 1)

    def forward(self, x):
        t = F.relu(self.conv(x))
        b = x.shape[0]
        obj = self.cls_logits(t).permute(0, 2, 3, 1).reshape(b, -1)
        reg = self.bbox_pred(t).permute(0, 2, 3, 1).reshape(b, -1, 4)
        return obj, reg


class Res5Head(nn.Module):
    def __init__(self, m):
        super().__init__()
        c4 = m["res2_out_channels"] * 4
        # pooled at every other bin (7 x 7 of 14 x 14), so res5 strides 1
        self.layer4 = stage(3, c4, m["width_per_group"] * 8, RES5_OUT, 1)


class BoxPredictor(nn.Module):
    def __init__(self, c, emb_dim):
        super().__init__()
        self.emb_pred = Lin(c, emb_dim)
        self.bbox_pred = Lin(c, 8)


class MaskPredictor(nn.Module):
    def __init__(self, c, dim, uncertainty):
        super().__init__()
        self.conv5_mask = ConvT(c, dim, 2, 2)
        self.mask_fcn_logits = Conv(dim, 2, 1)
        if uncertainty:
            self.uncertain_pred = Conv(dim, 1, 1)


class Heads(nn.Module):
    """The res5 RoI head, the embedding box predictor and the class-agnostic
    mask predictor."""

    def __init__(self, m, uncertainty=False):
        super().__init__()
        self.m = m
        c5 = RES5_OUT
        self.roi_extractor = Res5Head(m)
        self.box_predictor = BoxPredictor(c5, m["emb_dim"])
        self.mask_predictor = MaskPredictor(c5, m["mask_dim_reduced"], uncertainty)

    def extract(self, feats, boxes):
        """res5 on the 7 x 7 of 14 x 14 bins of each box: ``[N, C5, 7, 7]``."""
        m = self.m
        r = m["pooler_resolution"]
        pooled = ops.roi_align(feats.permute(0, 2, 3, 1), boxes, (r, r), m["pooler_scale"],
                               m["pooler_sampling_ratio"], bin_stride=2)
        x = pooled.reshape(-1, *pooled.shape[2:]).permute(0, 3, 1, 2)
        return self.roi_extractor.layer4(x)

    def box_outputs(self, x, table):
        vec = x.mean(dim=(2, 3))
        emb = self.box_predictor.emb_pred(vec)
        rnd = self.box_predictor.emb_pred.rnd
        logits = rnd(F.linear(rnd(emb), rnd(table)))
        return logits, self.box_predictor.bbox_pred(vec), emb

    def mask_logits(self, x):
        up = F.relu(self.mask_predictor.conv5_mask(x))
        return self.mask_predictor.mask_fcn_logits(up), up


class Sampled(NamedTuple):
    boxes: torch.Tensor
    labels: torch.Tensor
    reg_targets: torch.Tensor
    valid: torch.Tensor
    is_pos: torch.Tensor
    matched: torch.Tensor

    def head(self, cap):
        return Sampled(*(a[:, :cap] for a in self))


def _select(mask, rand, count, k_cap):
    k = min(k_cap, mask.shape[1])
    keyed = torch.where(mask, rand, torch.full((), -float("inf"), device=rand.device))
    idx = torch.sort(keyed, dim=1, descending=True, stable=True).indices[:, :k]
    take = torch.arange(k, device=mask.device)[None, :] < count[:, None]
    return torch.zeros_like(mask).scatter_(1, idx, take) & mask


def balanced_masks(pos, neg, rand, batch, fraction):
    """``min(#pos, batch * fraction)`` positives and ``min(#neg, batch -
    #pos)`` negatives, those of the highest priorities."""
    cap = int(batch * fraction)
    num_pos = pos.sum(1).clamp(max=cap)
    num_neg = torch.minimum(neg.sum(1), batch - num_pos)
    return _select(pos, rand[:, 0], num_pos, max(cap, 1)), _select(neg, rand[:, 1], num_neg, batch)


def match(quality, gt_valid, high, low, low_quality=False):
    q = torch.where(gt_valid[..., :, None], quality, torch.full((), -1.0, device=quality.device))
    vals, idx = q.max(dim=-2)
    out = torch.where(vals < low, -1, torch.where(vals < high, -2, idx))
    if low_quality:
        best = (q == q.max(dim=-1, keepdim=True).values) & gt_valid[..., :, None]
        out = torch.where(best.any(dim=-2), idx, out)
    return out


def sample_rois(cands, cand_valid, gt_boxes, gt_labels, gt_valid, rand, m):
    """maskrcnn_benchmark's RoI sampling with static shapes: positives
    first, then negatives, then padding, in candidate order."""
    matched = match(ops.box_iou(gt_boxes, cands), gt_valid, m["roi_fg_iou"], m["roi_bg_iou"])
    pos = (matched >= 0) & cand_valid
    neg = (matched == -1) & cand_valid
    spos, sneg = balanced_masks(pos, neg, rand, m["roi_batch_per_image"], m["roi_positive_fraction"])
    tier = torch.where(spos, 0, torch.where(sneg, 1, 2))
    idx = torch.sort(tier, dim=1, stable=True).indices[:, :m["roi_batch_per_image"]]
    num_pos = spos.sum(1, keepdim=True)
    slots = torch.arange(idx.shape[1], device=idx.device)[None, :]
    is_pos = slots < num_pos
    valid = slots < num_pos + sneg.sum(1, keepdim=True)
    boxes = torch.gather(cands, 1, idx[..., None].expand(-1, -1, 4))
    mg = torch.gather(matched, 1, idx).clamp(min=0)
    labels = torch.where(is_pos, torch.gather(gt_labels.to(torch.int64), 1, mg), 0)
    targets = ops.encode_boxes(torch.gather(gt_boxes, 1, mg[..., None].expand(-1, -1, 4)), boxes, m["reg_weights"])
    return Sampled(boxes, labels, targets, valid, is_pos, mg)


def box_loss(logits, deltas, s, bg_weight):
    labels, valid, is_pos = s.labels.reshape(-1), s.valid.reshape(-1), s.is_pos.reshape(-1)
    n = valid.to(torch.float32).sum().clamp(min=1.0)
    ce = -torch.gather(F.log_softmax(logits, -1), 1, labels[:, None])[:, 0]
    w = torch.where(labels == 0, bg_weight, 1.0) * valid
    reg = ops.smooth_l1(deltas[:, 4:8], s.reg_targets.reshape(-1, 4), 1.0)
    return (ce * w).sum() / n, (reg * is_pos[:, None]).sum() / n


def mask_loss(logits, s, gt_masks, gt_boxes, size):
    """Per-pixel BCE of channel 1 against the gt mask projected on each
    positive roi; ``logits [n_s, N, 2, M, M]``."""
    b, k = s.matched.shape
    mm = gt_masks.shape[-1]
    src = torch.gather(gt_masks, 1, s.matched[:, :, None, None].expand(b, k, mm, mm)).reshape(b * k, mm, mm)
    src_box = torch.gather(gt_boxes, 1, s.matched[..., None].expand(b, k, 4)).reshape(-1, 4)
    tgt = ops.crop_resize_from_box_frame(src, src_box, s.boxes.reshape(-1, 4), size)
    tgt = (tgt >= 0.5).to(torch.float32)
    pos = (s.is_pos & s.valid).reshape(-1).to(torch.float32)
    per = ops.bce_with_logits(logits[:, :, 1], tgt[None])
    return (per * pos[None, :, None, None]).sum() / (pos.sum() * logits.shape[0] * size * size).clamp(min=1.0)


def cell_anchors(stride, sizes, ratios):
    def whctr(a):
        w, h = a[2] - a[0] + 1, a[3] - a[1] + 1
        return w, h, a[0] + 0.5 * (w - 1), a[1] + 0.5 * (h - 1)

    def mk(ws, hs, x, y):
        ws, hs = ws[:, None], hs[:, None]
        return np.hstack((x - 0.5 * (ws - 1), y - 0.5 * (hs - 1), x + 0.5 * (ws - 1), y + 0.5 * (hs - 1)))

    w, h, x, y = whctr(np.array([0, 0, stride - 1, stride - 1], np.float64))
    ws = np.round(np.sqrt(w * h / np.array(ratios, np.float64)))
    base = mk(ws, np.round(ws * np.array(ratios)), x, y)
    scales = np.array(sizes, np.float64) / stride
    out = []
    for a in base:
        w, h, x, y = whctr(a)
        out.append(mk(w * scales, h * scales, x, y))
    return np.vstack(out).astype(np.float32)


def anchors_for(feat, m):
    h, w = feat.shape[2:]
    s = m["anchor_stride"]
    cells = cell_anchors(s, m["anchor_sizes"], m["aspect_ratios"])
    sx, sy = np.meshgrid(np.arange(0, w * s, s, np.float32), np.arange(0, h * s, s, np.float32))
    shifts = np.stack([sx, sy, sx, sy], -1).reshape(-1, 1, 4)
    return torch.from_numpy((shifts + cells[None]).reshape(-1, 4)).to(feat.device)


def selection(anchors, obj, reg, sizes, m, train) -> Dict[str, torch.Tensor]:
    """Top-N objectness, decoded, clipped: the NMS's inputs (``boxes``,
    ``scores``, ``valid``) and its outputs (``idx``, ``keep``) at 0.7,
    top-N kept; and every anchor's box, decoded and clipped (``every``)."""
    pre = m["rpn_pre_nms_train" if train else "rpn_pre_nms_test"]
    post = m["rpn_post_nms_train" if train else "rpn_post_nms_test"]
    topv, topi = ops.sorted_top_k(obj.detach(), min(pre, anchors.shape[0]))
    sel_reg = torch.gather(reg.detach(), 1, topi[..., None].expand(-1, -1, 4))
    boxes = ops.clip_to_image(ops.decode_boxes(sel_reg, anchors[topi], (1.0, 1.0, 1.0, 1.0)), sizes)
    valid = ((boxes[..., 2] - boxes[..., 0] + 1 >= m["rpn_min_size"])
             & (boxes[..., 3] - boxes[..., 1] + 1 >= m["rpn_min_size"]))
    scores = torch.sigmoid(topv)
    idx, keep = ops.nms(boxes, scores, valid, m["rpn_nms_thresh"], post)
    every = ops.clip_to_image(ops.decode_boxes(reg.detach(), anchors[None], (1.0, 1.0, 1.0, 1.0)), sizes)
    return dict(boxes=boxes, scores=scores, valid=valid, idx=idx.to(torch.int64), keep=keep, every=every)


def chosen(sel):
    """The proposals a selection keeps: boxes, scores, valid."""
    idx = sel["idx"]
    return torch.gather(sel["boxes"], 1, idx[..., None].expand(-1, -1, 4)), torch.gather(sel["scores"], 1, idx), sel["keep"]


def proposals(anchors, obj, reg, sizes, m, train):
    return chosen(selection(anchors, obj, reg, sizes, m, train))


def followed(own, given):
    """``given``'s entries for the images it holds (its first rows), ``own``'s
    for the rest: a candidate that left images out is followed where it
    has them."""
    if given is None:
        return own
    out = {}
    for k, v in own.items():
        if k not in given:
            continue
        g = given[k].to(v.device)
        out[k] = torch.cat([g.to(v.dtype), v[g.shape[0]:]], 0) if g.shape[0] < v.shape[0] else g.to(v.dtype)
    return out


def nms_mismatch(given, iou_threshold) -> float:
    """The share of output slots where the plain NMS on a candidate's own
    inputs (``boxes``, ``scores``, ``valid``, ``labels`` or None) keeps
    another box than the candidate kept (``idx``, ``keep``)."""
    idx, keep = ops.nms(given["boxes"], given["scores"], given["valid"], iou_threshold, given["idx"].shape[1],
                        given.get("labels"))
    g_idx, g_keep = given["idx"].to(idx.device).to(torch.int64), given["keep"].to(keep.device)
    return float(((keep != g_keep) | (keep & (idx != g_idx))).float().mean())


def box_match_gap(boxes, valid, other, other_valid, rows=512):
    """Per image, the median over ``boxes`` (where ``valid``) of one less
    the best IoU with ``other`` (where ``other_valid``); ``[B]``, 1 for an
    image with no boxes on either side."""
    out = []
    for i in range(boxes.shape[0]):
        a, b = boxes[i][valid[i]], other[i][other_valid[i]]
        if not len(a) or not len(b):
            out.append(1.0)
            continue
        best = torch.cat([ops.box_iou(a[j:j + rows][None], b[None])[0].max(dim=1).values
                          for j in range(0, len(a), rows)])
        out.append(float((1.0 - best).median()))
    return torch.tensor(out)


def selection_gaps(own, given, m) -> Dict[str, float]:
    """The selection stage, held by itself: ``rpn_score_gap``, the largest
    gap between the candidate's NMS input scores and the reference's top-N
    scores, each image's in descending order (ties and their order do not
    count); ``rpn_box_gap``, over the images, the largest median of one
    less each candidate input box's best IoU with the reference's boxes
    of all anchors (a wrong decode moves it; which anchors made the
    top-N cut, which bf16 reorders among near ties, does not);
    ``nms_mismatch``, the share of output slots where the plain NMS on
    the candidate's own inputs keeps another box."""
    b = given["scores"].shape[0]
    dev = own["scores"].device
    gs = torch.sort(given["scores"].to(dev).float(), dim=1, descending=True).values
    os_ = torch.sort(own["scores"][:b], dim=1, descending=True).values
    every = own["every"][:b]
    box_gap = box_match_gap(given["boxes"].to(dev).float(), given["valid"].to(dev), every,
                            torch.ones(every.shape[:2], dtype=torch.bool, device=dev))
    return {"rpn_score_gap": float((gs - os_).abs().max()), "rpn_box_gap": float(box_gap.max()),
            "nms_mismatch": nms_mismatch(given, m["rpn_nms_thresh"])}


def normalize(images, sizes, m):
    """uint8 RGB ``[B, H, W, 3]`` -> BGR255 minus the pixel mean, zero
    outside each image, NCHW float32."""
    x = ((images.to(torch.float32).flip(-1) - torch.tensor(m["pixel_mean"], device=images.device))
         / torch.tensor(m["pixel_std"], device=images.device))
    h = torch.arange(images.shape[1], device=x.device)[None, :, None, None]
    w = torch.arange(images.shape[2], device=x.device)[None, None, :, None]
    inside = (h < sizes[:, 0, None, None, None]) & (w < sizes[:, 1, None, None, None])
    return torch.where(inside, x, 0.0).permute(0, 3, 1, 2)


def normalize_rows(x, eps=1e-12):
    return x * torch.rsqrt(torch.sum(x * x, -1, keepdim=True).clamp(min=eps * eps))


class Detections(NamedTuple):
    boxes: torch.Tensor
    scores: torch.Tensor
    labels: torch.Tensor
    valid: torch.Tensor
    masks: torch.Tensor
    cand_boxes: torch.Tensor  # [B, P, 4] every proposal's regressed box
    cand_probs: torch.Tensor  # [B, P, C] its class probabilities
    cand_valid: torch.Tensor  # [B, P]


class Teacher(Heads):
    """``GeneralizedRCNN`` of ``zeroshot_mask.yaml``: trunk, RPN and the
    heads, which sit at the top level as in the program."""

    def __init__(self, m):
        super().__init__(m)
        self.backbone = Backbone(m)
        c4 = m["res2_out_channels"] * 4
        self.rpn_head = RPNHead(c4, len(m["anchor_sizes"]) * len(m["aspect_ratios"]))

    def losses(self, batch, table, draws) -> Dict[str, torch.Tensor]:
        m = self.m
        sizes = batch["image_sizes"]
        feats = self.backbone.body(normalize(batch["images"], sizes, m))
        obj, reg = self.rpn_head(feats)
        anchors = anchors_for(feats, m)
        gt_boxes, gt_valid = batch["gt_boxes"].float(), batch["gt_valid"].bool()
        # the RPN loss over the visible anchors
        visible = ((anchors[:, 0] >= 0) & (anchors[:, 1] >= 0)
                   & (anchors[None, :, 2] < sizes[:, 1, None]) & (anchors[None, :, 3] < sizes[:, 0, None]))
        matched = match(ops.box_iou(gt_boxes, anchors), gt_valid, m["rpn_fg_iou"], m["rpn_bg_iou"], True)
        pos, neg = (matched >= 0) & visible, (matched == -1) & visible
        spos, sneg = balanced_masks(pos, neg, draws["rpn_sampler"], m["rpn_batch_per_image"],
                                    m["rpn_positive_fraction"])
        sampled = (spos | sneg).float()
        tgt = ops.encode_boxes(torch.gather(gt_boxes, 1, matched.clamp(min=0)[..., None].expand(-1, -1, 4)),
                               anchors, (1.0, 1.0, 1.0, 1.0))
        total = sampled.sum().clamp(min=1.0)
        out = {
            "loss_objectness": (ops.bce_with_logits(obj, pos.float()) * sampled).sum() / total,
            "loss_rpn_box_reg": (ops.smooth_l1(reg, tgt, 1.0 / 9) * spos[..., None]).sum() / total,
        }
        boxes, _, valid = proposals(anchors, obj, reg, sizes, m, True)
        s = sample_rois(torch.cat([boxes, gt_boxes], 1), torch.cat([valid, gt_valid], 1), gt_boxes,
                        batch["gt_labels"], gt_valid, draws["gt_sampler"], m)
        x = self.extract(feats, s.boxes)
        logits, deltas, _ = self.box_outputs(x, table)
        out["loss_classifier"], out["loss_box_reg"] = box_loss(logits, deltas, s, m["bg_weight"])
        cap = min(m["mask_pos_cap"], m["roi_batch_per_image"])
        b = feats.shape[0]
        xm = x.reshape(b, -1, *x.shape[1:])[:, :cap].reshape(-1, *x.shape[1:])
        mlog, _ = self.mask_logits(xm)
        out["loss_mask"] = mask_loss(mlog[None], s.head(cap), batch["gt_masks"].float(), gt_boxes,
                                     mlog.shape[-1])
        return out


def detect(heads, feats, boxes, valid, sizes, table, m):
    """The eval box head, per-class NMS over the top candidates, then the
    masks of the detections; and the NMS's inputs and outputs."""
    b, p = boxes.shape[:2]
    logits, deltas, _ = heads.box_outputs(heads.extract(feats, boxes), table)
    probs = torch.softmax(logits, -1).reshape(b, p, -1)
    c = probs.shape[-1]
    dec = ops.clip_to_image(ops.decode_boxes(deltas.reshape(b, p, -1)[..., -4:], boxes, m["reg_weights"]), sizes)
    cand = probs[..., 1:]
    ok = (cand > m["score_thresh"]) & valid[..., None]
    flat = torch.where(ok, cand, torch.full((), -1.0, device=cand.device)).reshape(b, -1)
    top_s, top_i = ops.sorted_top_k(flat, min(10 * m["detections_per_img"], p * (c - 1)))
    roi, cls = top_i // (c - 1), top_i % (c - 1) + 1
    bi = torch.arange(b, device=boxes.device)[:, None]
    top_b = dec[bi, roi]
    top_v = top_s > m["score_thresh"]
    keep, kv = ops.nms(top_b, top_s, top_v, m["nms_thresh"], m["detections_per_img"], cls)
    det_boxes = top_b[bi, keep]
    mlog, _ = heads.mask_logits(heads.extract(feats, det_boxes))
    masks = torch.sigmoid(mlog[:, 1]).reshape(b, -1, *mlog.shape[-2:])
    return (Detections(det_boxes, torch.gather(top_s, 1, keep), torch.gather(cls, 1, keep), kv, masks,
                       dec, probs, valid),
            dict(boxes=top_b, scores=top_s, valid=top_v, labels=cls, idx=keep, keep=kv))


class StudentTeacher(nn.Module):
    """``STGeneralizedRCNN``: frozen trunk, RPN and teacher heads, frozen
    word table; the student's heads train on the detection annotations
    and on the teacher's caption pseudo-labels."""

    def __init__(self, m):
        super().__init__()
        self.m = m
        self.backbone = Backbone(m)
        c4 = m["res2_out_channels"] * 4
        self.rpn_head = RPNHead(c4, len(m["anchor_sizes"]) * len(m["aspect_ratios"]))
        self.teacher = Heads(m)
        self.student = Heads(m, uncertainty=True)
        self.bert = nn.Module()
        self.bert.word_embeddings = nn.Parameter(torch.zeros(m["vocab_size"], m["emb_dim"]))
        self.lambda_exemplar = nn.Parameter(torch.zeros(1))

    def trunk(self, batch):
        m = self.m
        sizes = batch["image_sizes"]
        with torch.no_grad():
            feats = self.backbone.body(normalize(batch["images"], sizes, m))
            obj, reg = self.rpn_head(feats)
        return feats, obj, reg, anchors_for(feats, m)

    def serve(self, images, sizes, table, given=None):
        """The student's detections against the row-normalized class
        table, and the trunk's features.  ``given`` (a candidate's
        ``self.chosen`` for this batch) supplies the proposals to follow:
        the RPN NMS's inputs and outputs (``rpn``).  ``self.gaps`` then
        holds that stage by itself (:func:`selection_gaps`) and
        ``nms_mismatch.det``, the plain NMS on the candidate's own
        detection NMS inputs (``det``) against what it kept;
        ``self.chosen`` keeps this forward's own."""
        m = self.m
        feats, obj, reg, anchors = self.trunk({"images": images, "image_sizes": sizes})
        own = selection(anchors, obj, reg, sizes, m, False)
        self.gaps = {}
        if given is not None:
            self.gaps = {k if k.startswith("rpn_") else f"{k}.rpn": v
                         for k, v in selection_gaps(own, given["rpn"], m).items()}
            self.gaps["nms_mismatch.det"] = nms_mismatch(given["det"], m["nms_thresh"])
        sel = followed(own, given and given["rpn"])
        boxes, _, valid = chosen(sel)
        det, nms_io = detect(self.student, feats, boxes, valid, sizes, normalize_rows(table), m)
        self.chosen = dict(rpn=sel, det=nms_io)
        return det, feats

    def noun_embeddings(self, ids, mask):
        emb = self.bert.word_embeddings[ids.long()]
        w = mask.float()[..., None]
        return normalize_rows((emb * w).sum(-2) / w.sum(-2).clamp(min=1e-6))

    @torch.no_grad()
    def pseudo_labels(self, feats, boxes, valid, sizes, batch, given=None):
        """Per caption noun, the teacher-regressed proposal of the highest
        region-noun similarity, its sigmoid score and the teacher's mask on
        it, binarized at 0.5.  ``given`` pseudo boxes (a candidate's, for
        the images it holds) replace the argmax's; ``self.gaps`` then holds
        ``pseudo_score_gap``, the largest shortfall of the similarity at the
        proposal whose regressed box is nearest each given box below the
        noun's best, over the similarities' spread, and ``pseudo_box_gap``,
        that box's largest distance in pixels."""
        m = self.m
        b, p = boxes.shape[:2]
        x = self.teacher.extract(feats, boxes)
        _, deltas, emb = self.teacher.box_outputs(x, torch.zeros((1, m["emb_dim"]), device=x.device))
        reg_boxes = ops.clip_to_image(
            ops.decode_boxes(deltas.reshape(b, p, -1)[..., -4:], boxes, m["reg_weights"]), sizes)
        nouns = self.noun_embeddings(batch["cap_tok_ids"], batch["cap_tok_mask"])
        scores = torch.einsum("bpd,bwd->bpw", emb.reshape(b, p, -1), nouns)
        scores = torch.where(valid[:, :, None], scores, torch.full((), -float("inf"), device=x.device))
        best, idx = scores.max(dim=1)
        pboxes = torch.gather(reg_boxes, 1, idx[..., None].expand(-1, -1, 4))
        if given is not None:
            g = given.to(pboxes.device, pboxes.dtype)
            n = g.shape[0]
            dist = (reg_boxes[:n, :, None] - g[:, None]).abs().amax(-1)  # [n, P, W]
            dist = torch.where(valid[:n, :, None], dist, torch.full((), float("inf"), device=x.device))
            near_d, near = dist.min(dim=1)
            at = torch.gather(scores[:n], 1, near[:, None]).squeeze(1)
            ok = batch["cap_word_valid"][:n].bool() & torch.isfinite(best[:n])
            finite = torch.where(torch.isfinite(scores[:n]), scores[:n], best[:n, None])
            spread = (best[:n] - finite.min(dim=1).values).clamp(min=1e-12)
            self.gaps = {
                "pseudo_score_gap": float(torch.where(ok, (best[:n] - at) / spread, 0.0).max()),
                "pseudo_box_gap": float(torch.where(ok, near_d, 0.0).max()),
            }
            pboxes = torch.cat([g, pboxes[n:]], 0)
        mlog, _ = self.teacher.mask_logits(self.teacher.extract(feats, pboxes))
        masks = (torch.sigmoid(mlog[:, 1]) >= 0.5).float().reshape(b, -1, *mlog.shape[-2:])
        return pboxes, torch.sigmoid(best), batch["cap_word_valid"].bool() & torch.isfinite(best), masks

    def branch(self, feats, boxes, valid, gt_boxes, gt_labels, gt_valid, gt_masks, table, image_mask,
               append_gt, rand, eps, uncertain):
        m = self.m
        pvalid = valid & image_mask[:, None]
        gvalid = gt_valid & image_mask[:, None]
        if append_gt:
            boxes, pvalid = torch.cat([boxes, gt_boxes], 1), torch.cat([pvalid, gvalid], 1)
        s = sample_rois(boxes, pvalid, gt_boxes, gt_labels, gvalid, rand, m)
        s = s._replace(valid=s.valid & image_mask[:, None], is_pos=s.is_pos & image_mask[:, None])
        x = self.student.extract(feats, s.boxes)
        logits, deltas, _ = self.student.box_outputs(x, table)
        cls_l, box_l = box_loss(logits, deltas, s, m["bg_weight"])
        cap = min(m["mask_pos_cap"], m["roi_batch_per_image"])
        b = feats.shape[0]
        xm = x.reshape(b, -1, *x.shape[1:])[:, :cap].reshape(-1, *x.shape[1:])
        sm = s.head(cap)
        mlog, up = self.student.mask_logits(xm)
        avg = torch.ones((), device=x.device)
        if uncertain:
            slog = self.student.mask_predictor.uncertain_pred(up.detach())
            scale = torch.exp(0.5 * slog.clamp(min=-30.0, max=30.0))  # [N, 1, M, M]
            mlog = mlog[None] + eps.permute(0, 1, 4, 2, 3) * scale[None]
            pos = (sm.is_pos & sm.valid).reshape(-1).float()
            avg = (scale[:, 0].mean(dim=(1, 2)) * pos).sum() / pos.sum().clamp(min=1.0)
        else:
            mlog = mlog[None]
        return cls_l, box_l, mask_loss(mlog, sm, gt_masks, gt_boxes, mlog.shape[-1]), avg

    def losses(self, batch, tables, draws, given=None) -> Dict[str, torch.Tensor]:
        """The step's losses.  ``given`` (a candidate's ``self.chosen``)
        supplies the discrete choices to follow: the NMS inputs and outputs
        of both proposal selections and the pseudo boxes.  The reference
        then computes everything else again, and ``self.gaps`` holds the
        selection stage held by itself (:func:`selection_gaps`, the
        argmax's :meth:`pseudo_labels`).  ``self.chosen`` keeps what this
        forward chose."""
        m = self.m
        sizes = batch["image_sizes"]
        feats, obj, reg, anchors = self.trunk(batch)
        cap_mask, det_mask = batch["cap_mask"].bool(), batch["det_mask"].bool()
        given = given or {}
        gaps = {}
        own = {t: selection(anchors, obj, reg, sizes, m, t == "train") for t in ("eval", "train")}
        for t in ("eval", "train"):
            if t in given:
                gaps.update({f"{k}.{t}": v for k, v in selection_gaps(own[t], given[t], m).items()})
        sel = {t: followed(own[t], given.get(t)) for t in ("eval", "train")}
        eb, _, ev = chosen(sel["eval"])
        self.gaps = {}
        pboxes, _, pvalid, pmasks = self.pseudo_labels(feats, eb, ev, sizes, batch, given.get("pseudo"))
        self.gaps.update(gaps)
        self.chosen = dict(sel, pseudo=pboxes)
        cls_p, box_p, mask_p, avg = self.branch(
            feats, eb, ev, pboxes, batch["cap_labels"], pvalid, pmasks, normalize_rows(tables["lvis"]),
            cap_mask, False, draws["pseudo_sampler"], draws["mask_eps"], True)
        lam = torch.where(avg > 0, 0.01 / avg.clamp(min=1e-20), torch.zeros_like(avg)).detach()
        tb, _, tv = chosen(sel["train"])
        gt_boxes = batch["gt_boxes"].float()
        cls_g, box_g, mask_g, _ = self.branch(
            feats, tb, tv, gt_boxes, batch["gt_labels"], batch["gt_valid"].bool(), batch["gt_masks"].float(),
            normalize_rows(tables["classes"]), det_mask, True, draws["gt_sampler"], None, False)
        return {
            "loss_classifier_pseudo": cls_p * lam, "loss_box_reg_pseudo": box_p * lam,
            "loss_mask_pseudo": mask_p, "loss_classifier": cls_g, "loss_box_reg": box_g, "loss_mask": mask_g,
        }


def set_precision(model: nn.Module, precision: str) -> None:
    """Rounds the inputs, weights and outputs of every conv, linear and
    class-table product of ``model`` as ``precision`` says (``float32``:
    none), and the gradients that flow back through them."""
    rnd = ops.rounding(precision)
    for layer in model.modules():
        if isinstance(layer, (Conv, ConvT, Lin)):
            layer.rnd = rnd


def build(kind: str, m) -> nn.Module:
    return {"teacher": Teacher, "student_teacher": StudentTeacher}[kind](m)
