"""The numbers that decide ``correct``: what the timed path produced (or
the control put in its place) against the float32 reference.

Training: each compared step's loss, the first gradient as the optimizer
got it and the parameters' change over the compared steps, by the worst
leaf: the gap between the two norms, over the reference's norm of that
leaf or of the median leaf, whichever is larger.  Leaves whose reference
gradient is under a thousandth of the median leaf's move by round-off
alone and are left out.  Besides, the first step's loss of each head,
and where the reference followed the candidate's discrete choices, that
selection stage held by itself.  Serving, where the reference follows
the program's proposals: the proposal selection and the detection NMS
held by themselves, the detections' scores in rank order, the served
boxes against the reference's detections and back, each detection's
score against the reference's probability of its label at the proposal
that overlaps it most, and the masks, which the reference computes again
on the served boxes.  Per-image numbers are medians over the image's
detections, and the worst image counts, so that one wrong image fails.
"""

from typing import Dict, List

import numpy as np
import torch

LEAF_FLOOR = 1e-3  # of the median leaf's reference gradient norm
LOSS_GROUPS = {
    "rpn": ("loss_objectness", "loss_rpn_box_reg"),
    "det": ("loss_classifier", "loss_box_reg", "loss_mask"),
    "pseudo": ("loss_classifier_pseudo", "loss_box_reg_pseudo", "loss_mask_pseudo"),
}


def _leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], names: List[str]) -> Dict[str, float]:
    pn = {n: float(prog[n].double().norm()) for n in names}
    rn = {n: float(ref[n].double().norm()) for n in names}
    med = float(np.median([rn[n] for n in names]))
    return {n: abs(pn[n] - rn[n]) / max(rn[n], med) for n in names}


def counted_leaves(ref_grad: Dict[str, torch.Tensor]) -> List[str]:
    norms = {n: float(g.double().norm()) for n, g in ref_grad.items()}
    med = float(np.median(list(norms.values())))
    return sorted(n for n, v in norms.items() if v >= LEAF_FLOOR * med)


def train_numbers(prog, ref) -> Dict[str, float]:
    """``prog`` and ``ref``: ``losses`` (a dict a step), ``grad1`` and
    ``delta`` (by parameter name)."""
    names = counted_leaves(ref["grad1"])
    out = {}
    total_gaps, term_gaps = [], []
    for lp, lr in zip(prog["losses"], ref["losses"]):
        tp, tr = sum(lp.values()), sum(lr.values())
        total_gaps.append(abs(tp - tr) / abs(tr))
        scale = float(np.median([abs(v) for v in lr.values()]))
        term_gaps += [abs(lp[k] - lr[k]) / max(abs(lr[k]), scale) for k in lr]
    out["loss_gap"] = max(total_gaps)
    out["loss_gap_step1"] = total_gaps[0]
    # the first step's losses of each branch, each against its own value
    lp, lr = prog["losses"][0], ref["losses"][0]
    term = {k: abs(lp[k] - lr[k]) / abs(lr[k]) for k in lr if lr[k] != 0}
    for group, keys in LOSS_GROUPS.items():
        present = [term[k] for k in keys if k in term]
        if present:
            out[f"{group}_loss_gap_step1"] = max(present)
    out["head_loss_gap"] = max(term_gaps)
    g = _leaf_gaps(prog["grad1"], ref["grad1"], names)
    d = _leaf_gaps(prog["delta"], ref["delta"], names)
    out["grad_gap"] = max(g.values())
    out["update_gap"] = max(d.values())
    out["grad_gap_median_leaf"] = float(np.median(list(g.values())))
    out["update_gap_median_leaf"] = float(np.median(list(d.values())))
    out["grad_gap_p90_leaf"] = float(np.percentile(list(g.values()), 90))
    out["update_gap_p90_leaf"] = float(np.percentile(list(d.values()), 90))
    for k in term:
        out[f"step1.{k}"] = term[k]
    # the heads whose targets the reference works out exactly: all but the
    # pseudo masks, the teacher's masks binarized at 0.5, where a pixel
    # near 0.5 falls on either side in bf16 and in float32
    exact = [v for k, v in term.items() if k != "loss_mask_pseudo"]
    if exact:
        out["head_loss_gap_step1"] = max(exact)
    groups: Dict[str, List[str]] = {}
    for n in names:
        parts = n.split(".")
        groups.setdefault(".".join(parts[:3] if parts[0] in ("backbone", "student") else parts[:2]), []).append(n)
    for group, members in sorted(groups.items()):
        out[f"grad_median.{group}"] = float(np.median([g[n] for n in members]))
        out[f"update_median.{group}"] = float(np.median([d[n] for n in members]))
    # the selection stage held by itself, where the reference followed it
    for gaps in ref.get("gaps") or []:
        for k, v in gaps.items():
            out[k] = max(out.get(k, 0.0), v)
    rpn = [n for n in names if n.startswith("rpn_head.")]
    if rpn:
        out["rpn_grad_gap"] = max(g[n] for n in rpn)
    out["worst_grad_leaf"] = max(g, key=g.get)
    out["worst_update_leaf"] = max(d, key=d.get)
    return out


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(x2 - x1 + 1, 0, None) * np.clip(y2 - y1 + 1, 0, None)
    area = lambda x: (x[:, 2] - x[:, 0] + 1) * (x[:, 3] - x[:, 1] + 1)
    return inter / np.maximum(area(a)[:, None] + area(b)[None, :] - inter, 1e-10)


def _label_match_gap(a, a_labels, b, b_labels) -> np.ndarray:
    """For each box of ``a``, one less its best IoU with a box of ``b``
    of the same label (1 where ``b`` has none)."""
    if not len(a):
        return np.zeros(0)
    if not len(b):
        return np.ones(len(a))
    iou = np.where(a_labels[:, None] == b_labels[None, :], _iou(a, b), 0.0)
    return 1.0 - iou.max(axis=1)


def serve_numbers(prog: List[Dict[str, np.ndarray]], ref: List[Dict]) -> Dict[str, float]:
    """Each item one batch: ``boxes [B, D, 4]``, ``scores``, ``labels``,
    ``valid [B, D]`` and ``masks [B, D, M, M]``.  The reference's items
    hold its own detections on the proposals it followed, every proposal's
    regressed box and class probabilities (``cand_*``), its masks on the
    served boxes (``masks_on_served``) and the selection stage's ``gaps``.

    ``score_gap``: the largest gap between the served scores and the
    reference's, each image's in rank order.  ``det_box_gap`` (served
    against the reference's) and ``det_recall_gap`` (the reference's
    against the served): one less each detection's best IoU with a
    detection of its label on the other side, the median over an image,
    the worst image.  ``det_score_gap``: each served score against the
    reference's probability of its label at the proposal whose regressed
    box overlaps it most, the median over an image, the worst image.
    ``mask_gap``: the largest gap of a served mask pixel;
    ``mask_gap_p99`` its 99th percentile."""
    score_gaps, box_gaps, recall_gaps, det_score, mask_gaps, mask_pixels = [], [], [], [], [], []
    out: Dict[str, float] = {}
    for p, r in zip(prog, ref):
        for k, v in (r.get("gaps") or {}).items():
            out[k] = max(out.get(k, 0.0), v)
        for i in range(p["valid"].shape[0]):
            pv, rv = p["valid"][i].astype(bool), r["valid"][i].astype(bool)
            ps, rs = np.sort(p["scores"][i][pv])[::-1], np.sort(r["scores"][i][rv])[::-1]
            n = min(len(ps), len(rs))
            score_gaps.append(float(np.abs(ps[:n] - rs[:n]).max()) if n else float(len(ps) != len(rs)))
            if not pv.any() or not rv.any():
                box_gaps.append(float(pv.any() != rv.any()))
                continue
            pb, pl = p["boxes"][i][pv], p["labels"][i][pv].astype(np.int64)
            rb, rl = r["boxes"][i][rv], r["labels"][i][rv].astype(np.int64)
            forward = _label_match_gap(pb, pl, rb, rl)
            box_gaps.append(float(np.median(forward)))
            recall_gaps.append(float(np.median(_label_match_gap(rb, rl, pb, pl))))
            cv = r["cand_valid"][i].astype(bool)
            cb, cp = r["cand_boxes"][i][cv], r["cand_probs"][i][cv]
            j = _iou(pb, cb).argmax(axis=1)
            det_score.append(float(np.median(np.abs(p["scores"][i][pv] - cp[j, pl]))))
            gap = np.abs(p["masks"][i][pv] - r["masks_on_served"][i][pv])
            mask_gaps.append(float(gap.max()))
            mask_pixels.append(gap.reshape(-1))
    out.update(
        score_gap=max(score_gaps),
        det_box_gap=max(box_gaps),
        det_recall_gap=max(recall_gaps) if recall_gaps else 1.0,
        det_score_gap=max(det_score) if det_score else 1.0,
        mask_gap=max(mask_gaps) if mask_gaps else 1.0,
        mask_gap_p99=float(np.percentile(np.concatenate(mask_pixels), 99)) if mask_pixels else 1.0,
        mask_gap_mean=float(np.concatenate(mask_pixels).mean()) if mask_pixels else 1.0,
    )
    return out
