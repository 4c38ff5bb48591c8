"""Model FLOPs of one step, counted from the configuration's shapes.

The convolutions and matrix products of the R-50-C4 detectors as the
paper's code defines them, at the padded bucket of a batch: the trunk
(stem to res4), the RPN head, the res5 RoI head with the embedding box
predictor and the mask head on the rois each branch pools, and the
region-noun similarity of the student-teacher model's pseudo-labels; the
word table is a lookup and counts nothing.  A trained layer adds its
weight gradient, and its input gradient wherever its input carries one.
Two flops a multiply-add.  The count follows the configuration, not the
implementation, so it stays the same whatever a later change runs; it
must not follow later changes to the program.
"""

from typing import Dict, List, Tuple

STAGES = (3, 4, 6)
RES5_OUT = 2048

Conv = Tuple[str, int, int, int, int, int]  # (name, cin, cout, k, h_out, w_out)


def _ceil_half(x: int) -> int:
    return -(-x // 2)


def trunk_convs(m, h: int, w: int) -> List[Conv]:
    """Stem to res4 at an ``h x w`` input."""
    out = []
    h2, w2 = _ceil_half(h), _ceil_half(w)
    out.append(("backbone.body.stem.conv1", 3, m["stem_out_channels"], 7, h2, w2))
    h, w = _ceil_half(h2), _ceil_half(w2)
    cin = m["stem_out_channels"]
    for i, blocks in enumerate(STAGES):
        cout, mid = m["res2_out_channels"] * 2 ** i, m["width_per_group"] * 2 ** i
        if i > 0:
            h, w = _ceil_half(h), _ceil_half(w)
        for j in range(blocks):
            p = f"backbone.body.layer{i + 1}.block{j}"
            c = cin if j == 0 else cout
            if j == 0:
                out.append((p + ".downsample_conv", c, cout, 1, h, w))
            out += [(p + ".conv1", c, mid, 1, h, w), (p + ".conv2", mid, mid, 3, h, w),
                    (p + ".conv3", mid, cout, 1, h, w)]
        cin = cout
    return out


def feature_hw(h: int, w: int) -> Tuple[int, int]:
    return -(-h // 16), -(-w // 16)


def rpn_convs(m, h: int, w: int) -> List[Conv]:
    fh, fw = feature_hw(h, w)
    c = m["res2_out_channels"] * 4
    a = len(m["anchor_sizes"]) * len(m["aspect_ratios"])
    return [("rpn_head.conv", c, c, 3, fh, fw), ("rpn_head.cls_logits", c, a, 1, fh, fw),
            ("rpn_head.bbox_pred", c, 4 * a, 1, fh, fw)]


def res5_convs(m, prefix: str) -> List[Conv]:
    """res5 on one roi's 7 x 7 pooled bins (stride 1)."""
    c4, mid = m["res2_out_channels"] * 4, m["width_per_group"] * 8
    out = [(prefix + ".block0.downsample_conv", c4, RES5_OUT, 1, 7, 7)]
    for j in range(3):
        c = c4 if j == 0 else RES5_OUT
        p = f"{prefix}.block{j}"
        out += [(p + ".conv1", c, mid, 1, 7, 7), (p + ".conv2", mid, mid, 3, 7, 7), (p + ".conv3", mid, RES5_OUT, 1, 7, 7)]
    return out


def conv_flops(c: Conv) -> float:
    _, cin, cout, k, h, w = c
    return 2.0 * cin * cout * k * k * h * w


def box_head_flops(m, classes: int) -> float:
    """One roi: the res5 head, the embedding and box projections and the
    logits against the class table."""
    return (sum(conv_flops(c) for c in res5_convs(m, "res5"))
            + 2.0 * RES5_OUT * (m["emb_dim"] + 8) + 2.0 * m["emb_dim"] * classes)


def mask_head_flops(m, uncertainty: bool) -> float:
    """One roi's mask predictor on res5's 7 x 7 output: the 2 x 2 stride-2
    transposed conv to 14 x 14, then the 1 x 1 logits (and the
    uncertainty's)."""
    d = m["mask_dim_reduced"]
    return 2.0 * RES5_OUT * d * 4 * 49 + 2.0 * d * (2 + (1 if uncertainty else 0)) * 196


def step_flops(config, hw: Tuple[int, int], train: bool) -> Dict[str, float]:
    """FLOPs of one step of ``config`` on a batch padded to ``hw``, by
    part; ``train`` False is the serving forward."""
    m = config["model"]
    b = config["solver"]["ims_per_batch"]
    h, w = hw
    cap = min(m["mask_pos_cap"], m["roi_batch_per_image"])
    rois = m["roi_batch_per_image"]
    trunk = sum(conv_flops(c) for c in trunk_convs(m, h, w))
    rpn = sum(conv_flops(c) for c in rpn_convs(m, h, w))
    classes = config["class_rows"]
    out = {"trunk": b * trunk, "rpn": b * rpn}
    if not train:
        dets = m["detections_per_img"]
        out["box_head"] = b * m["rpn_post_nms_test"] * box_head_flops(m, classes)
        out["mask_head"] = b * dets * (sum(conv_flops(c) for c in res5_convs(m, "res5"))
                                       + mask_head_flops(m, False))
        return out
    if config["kind"] == "teacher":
        # res3 and res4 train: weight gradients of theirs, input gradients
        # but into res3's first block, whose input (res2) carries none
        trained = [c for c in trunk_convs(m, h, w) if c[0].startswith(("backbone.body.layer2", "backbone.body.layer3"))]
        no_dx = ("backbone.body.layer2.block0.conv1", "backbone.body.layer2.block0.downsample_conv")
        out["trunk_backward"] = b * sum(conv_flops(c) * (1 if c[0] in no_dx else 2) for c in trained)
        out["rpn_backward"] = 2.0 * b * rpn
        # res5, the box regression and the mask head take both gradients
        # (res5's input, through RoIAlign, needs one); the frozen
        # embedding projection and the class logits the input's only
        res5 = sum(conv_flops(c) for c in res5_convs(m, "res5"))
        head = 3.0 * (res5 + 2.0 * RES5_OUT * 8) + 2.0 * (2.0 * RES5_OUT * m["emb_dim"] + 2.0 * m["emb_dim"] * classes)
        out["box_head"] = b * rois * head
        out["mask_head"] = 3.0 * b * cap * mask_head_flops(m, False)
        return out
    # the student-teacher model: frozen trunk, RPN and teacher; the
    # student's heads train on two branches of ``rois`` sampled rois
    nouns = m["max_cap_nouns"]
    teacher_box = m["rpn_post_nms_test"] * (box_head_flops(m, 1) - 2.0 * m["emb_dim"])
    teacher_mask = nouns * (sum(conv_flops(c) for c in res5_convs(m, "res5")) + mask_head_flops(m, False))
    out["teacher"] = b * (teacher_box + teacher_mask
                          + 2.0 * m["rpn_post_nms_test"] * nouns * m["emb_dim"])
    # res5's first block reads the pooled trunk features, which carry no
    # gradient: its conv1 and shortcut take weight gradients only
    res5 = res5_convs(m, "res5")
    first = sum(conv_flops(c) for c in res5 if c[0] in ("res5.block0.conv1", "res5.block0.downsample_conv"))
    res5_train = 3.0 * sum(conv_flops(c) for c in res5) - first
    preds = 3.0 * (2.0 * RES5_OUT * (m["emb_dim"] + 8))
    # the logits against a table that takes no gradient: the input's only
    logits_cap = 2.0 * 2.0 * m["emb_dim"] * config["lvis_rows"]
    logits_det = 2.0 * 2.0 * m["emb_dim"] * classes
    mask = 3.0 * mask_head_flops(m, True)
    out["student_caption"] = b * (rois * (res5_train + preds + logits_cap) + cap * mask)
    out["student_detection"] = b * (rois * (res5_train + preds + logits_det) + cap * 3.0 * mask_head_flops(m, False))
    return out
