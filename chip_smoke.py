#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure raises and exits non-zero):

1. build     -- compile every CUDA kernel from ``csrc/`` (one nvcc per source).
2. nms       -- the NMS kernel against its plain PyTorch version at the main
                path's shapes (RPN: 8 x 6000 -> 1000 at IoU 0.7; detections:
                8 x 1000, 65 labels -> 100 at IoU 0.5), with overlapping boxes,
                tied scores and invalid slots.  Indices and masks must be equal.
3. roi_align -- the RoIAlign kernel against its plain version on [8, 50, 84,
                1024] float32 features with 1000 rois per image, bin_stride 1
                and 2.  Max abs diff <= 1e-5 * max|F| (only the summation order
                differs).
4. small     -- a narrow float32 student-teacher model on 2 x 64 x 64 images:
                the CUDA run against the CPU run (the plain versions, which the
                CPU tests hold against the JAX package).
5. serving   -- a Predictor on configs/coco_cap_det/
                student_teacher_mask_rcnn_uncertainty.yaml at full width in
                bfloat16, seeded weights loaded through bridge.py, a 66 x 768
                class table, 3 batches of 8 uint8 images at 800 x 1333.  Every
                kernel launch of the first batch is held against the plain
                version on the same inputs; launch counts are read over the 3
                batches.
6. profile   -- one more serving batch under torch.profiler: device time by
                kernel and the device's busy share.

Then the card's name and power limit, the per-kernel JSON line, and the last
line ``{"ok": true, "device": {...}}``.  Exits non-zero without a result when
no CUDA device is present or when run outside a checkout of the repository.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
CONFIG = "configs/coco_cap_det/student_teacher_mask_rcnn_uncertainty.yaml"
EMB_PRED_STD = 0.01
# the main path's shapes at the (800, 1333) bucket with TEST.IMS_PER_BATCH 8
NMS_CASES = (  # name, boxes per image, max_outputs, IoU, labels (0 = none)
    ("rpn", 6000, 1000, 0.7, 0),
    ("detections", 1000, 100, 0.5, 65),
)
ROI_FEATURES = (8, 50, 84, 1024)
ROI_CASES = ((1000, 1), (1000, 2), (100, 2))  # rois per image, bin_stride
ROI_MAIN = (1000, 2)  # the proposals' pooling on the main path
SERVING = dict(batches=3, batch=8, hw=(800, 1333), opts=())
H100_BYTES_PER_S = 3.35e12
H100_F32_OPS_PER_S = 67e12
IOU_OPS = 16  # min/max, sub/add, mul, div and compare of one +1 IoU test


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def nms_inputs(rng, b, n, num_labels, img_hw, dev):
    """Clustered boxes (real overlap), scores on a coarse grid (ties) and
    about 5% invalid slots."""
    h, w = img_hw
    centers = rng.uniform([0, 0], [w, h], (b, 40, 2))
    pick = rng.integers(0, 40, (b, n))
    ctr = np.take_along_axis(centers, pick[..., None], axis=1) + rng.normal(0, 12, (b, n, 2))
    wh = rng.uniform(16, 300, (b, n, 2))
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1)
    boxes = np.clip(boxes, 0, [w - 1, h - 1, w - 1, h - 1]).astype(np.float32)
    scores = (np.round(rng.uniform(0, 1, (b, n)) * 256) / 256).astype(np.float32)
    valid = rng.uniform(0, 1, (b, n)) > 0.05
    labels = rng.integers(1, num_labels + 1, (b, n)).astype(np.int32)
    t = lambda a: torch.from_numpy(a).to(dev)
    return t(boxes), t(scores), t(valid), t(labels)


def roi_inputs(rng, b, s, img_hw, dev):
    """Rois inside the image, plus a few that straddle or leave it."""
    h, w = img_hw
    x1 = rng.uniform(-40, w, (b, s))
    y1 = rng.uniform(-40, h, (b, s))
    bw = rng.uniform(8, 600, (b, s))
    bh = rng.uniform(8, 500, (b, s))
    rois = np.stack([x1, y1, x1 + bw, y1 + bh], -1).astype(np.float32)
    return torch.from_numpy(rois).to(dev)


# ---------------------------------------------------------------------------
# bounds
# ---------------------------------------------------------------------------

def nms_bound(scores, valid, labels, idx, keep, k):
    """Bytes: boxes, scores, valid (and labels) read once, indices and
    mask written once.  Operations: the IoU tests this run's greedy scan
    needs at the least: each kept box against every earlier kept box of
    its label, and each other valid box up to where the scan stops (the
    last kept box, once k are kept) against one kept box."""
    b, n = scores.shape
    key = torch.where(valid, scores, torch.full_like(scores, -float("inf")))
    order = torch.sort(key, dim=1, descending=True, stable=True).indices
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(n, device=order.device).expand(b, n).contiguous()
    )
    tests = 0
    for i in range(b):
        kept = idx[i][keep[i]].to(torch.int64)
        c = kept.numel()
        stop = int(rank[i, kept[-1]]) if c == k else n - 1
        tests += int((valid[i] & (rank[i] <= stop)).sum()) - c
        per_label = torch.bincount(labels[i][kept]) if labels is not None else torch.tensor([c])
        tests += int((per_label * (per_label - 1) // 2).sum())
    byts = b * (n * (16 + 4 + 1 + (4 if labels is not None else 0)) + k * (4 + 1))
    t_bytes, t_ops = byts / H100_BYTES_PER_S, IOU_OPS * tests / H100_F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def roi_bound(features, rois, output_size, bin_stride):
    """Bytes: features and rois read once, output written once.
    Operations: two flops per (nonzero A_y entry, nonzero A_x entry,
    channel) of each emitted bin, counted from this run's rois."""
    from cvpr22_cross_modal_pseudo_labeling_torch.ops import roi_align as ra

    B, H, W, C = features.shape
    S = rois.shape[1]
    P, Q = output_size
    (sh, bh, gh, ch), (sw, bw, gw, cw) = ra._roi_geometry(rois, 1.0 / 16, P, Q, H, W, 0, 8)
    taps = 0
    for bi in range(B):
        ay = ra._axis_interp_matrix(sh[bi], bh[bi], gh[bi], H, P, ch, bin_stride)
        ax = ra._axis_interp_matrix(sw[bi], bw[bi], gw[bi], W, Q, cw, bin_stride)
        ny = (ay != 0).sum(-1).to(torch.float64)  # [S, P']
        nx = (ax != 0).sum(-1).to(torch.float64)  # [S, Q']
        taps += float((ny.sum(-1) * nx.sum(-1)).sum())
    out_el = B * S * ay.shape[1] * ax.shape[1] * C
    byts = features.numel() * 4 + rois.numel() * 4 + out_el * 4
    ops = 2.0 * taps * C
    t_bytes, t_ops = byts / H100_BYTES_PER_S, ops / H100_F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_nms(dev, results):
    from cvpr22_cross_modal_pseudo_labeling_torch.ops import nms as nm

    rng = np.random.default_rng(SEED)
    b = SERVING["batch"]
    for name, n, k, thr, num_labels in NMS_CASES:
        boxes, scores, valid, labels = nms_inputs(rng, b, n, max(num_labels, 1), SERVING["hw"], dev)
        lab = labels if num_labels else None
        idx, keep = nm.nms(boxes, scores, valid, thr, k, labels=lab)
        ref_idx, ref_keep = nm.nms_plain(boxes, scores, valid, thr, k, labels=lab)
        torch.cuda.synchronize()
        mism = int((idx != ref_idx).sum() + (keep != ref_keep).sum())
        check(mism == 0, f"nms {name}: {mism} entries differ from the plain version")
        ms = cuda_ms(lambda: nm.nms(boxes, scores, valid, thr, k, labels=lab), 20)
        plain_ms = cuda_ms(lambda: nm.nms_plain(boxes, scores, valid, thr, k, labels=lab), 3)
        bound_ms, bound_by = nms_bound(scores, valid, lab, idx, keep, k)
        rec = dict(phase="nms", case=name, batch=b, n=n, max_outputs=k, iou=thr,
                   kept_per_image=keep.sum(1).tolist(), mismatches=mism,
                   ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        emit(rec)
        results[f"nms_{name}"] = rec


def phase_roi_align(dev, results):
    from cvpr22_cross_modal_pseudo_labeling_torch.ops import roi_align as ra

    rng = np.random.default_rng(SEED + 1)
    feats = torch.from_numpy(rng.standard_normal(ROI_FEATURES, np.float32)).to(dev)
    fmax = float(feats.abs().max())
    for s, bin_stride in ROI_CASES:
        rois = roi_inputs(rng, ROI_FEATURES[0], s, SERVING["hw"], dev)
        args = (feats, rois, (14, 14), 1.0 / 16, 0, 8, bin_stride)
        out = ra.roi_align(*args)
        ref = ra.roi_align_plain(*args)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        check(err <= 1e-5 * fmax, f"roi_align S={s} bin_stride={bin_stride}: max abs diff {err} > 1e-5 * {fmax}")
        del ref
        ms = cuda_ms(lambda: ra.roi_align(*args), 10)
        plain_ms = cuda_ms(lambda: ra.roi_align_plain(*args), 2)
        bound_ms, bound_by = roi_bound(feats, rois, (14, 14), bin_stride)
        rec = dict(phase="roi_align", rois_per_image=s, bin_stride=bin_stride,
                   features=list(feats.shape), max_abs_err=err, tol=1e-5 * fmax,
                   ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        emit(rec)
        results[("roi_align", s, bin_stride)] = rec
        del out
        torch.cuda.empty_cache()


def small_model(device):
    from cvpr22_cross_modal_pseudo_labeling_torch import bridge
    from cvpr22_cross_modal_pseudo_labeling_torch.engine.inference import Predictor

    opts = [
        "MODEL.RESNETS.STEM_OUT_CHANNELS", 8, "MODEL.RESNETS.RES2_OUT_CHANNELS", 16,
        "MODEL.RESNETS.WIDTH_PER_GROUP", 4, "MODEL.ROI_BOX_HEAD.EMB_DIM", 16,
        "MODEL.RPN.PRE_NMS_TOP_N_TEST", 128, "MODEL.RPN.POST_NMS_TOP_N_TEST", 32,
        "MODEL.ROI_MASK_HEAD.CONV_LAYERS", (8,), "TPU.COMPUTE_DTYPE", "float32",
    ]
    pred = Predictor(CONFIG, opts, device=device)
    pred.load_flax_params(bridge.seeded_flax_params(pred.model, SEED, 0.01))
    return pred


def phase_small():
    rng = np.random.default_rng(SEED + 2)
    images = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    sizes = np.array([[64, 64], [48, 64]], np.int32)
    table = rng.standard_normal((6, 16)).astype(np.float32)
    table[0] = 0
    gpu, gmask = small_model("cuda")(images, sizes, table)
    cpu, cmask = small_model("cpu")(images, sizes, table)
    check((gpu.valid == cpu.valid).all() and (gpu.labels == cpu.labels).all(),
          "small model: labels/valid differ between CUDA and CPU")
    box_err = float(abs(gpu.boxes - cpu.boxes).max())
    score_err = float(abs(gpu.scores - cpu.scores).max())
    mask_err = float(abs(gmask - cmask).max())
    check(box_err <= 1e-3 and score_err <= 1e-5 and mask_err <= 1e-4,
          f"small model: box {box_err} score {score_err} mask {mask_err} over tolerance")
    check(bool(gpu.valid.any(1).all()), "small model: an image without detections")
    emit(dict(phase="small", valid_per_image=gpu.valid.sum(1).tolist(),
              box_err=box_err, score_err=score_err, mask_err=mask_err))


def phase_serving(dev, results):
    from cvpr22_cross_modal_pseudo_labeling_torch import bridge
    from cvpr22_cross_modal_pseudo_labeling_torch.engine.inference import Predictor
    from cvpr22_cross_modal_pseudo_labeling_torch.ops import kernels
    from cvpr22_cross_modal_pseudo_labeling_torch.ops import nms as nm
    from cvpr22_cross_modal_pseudo_labeling_torch.ops import roi_align as ra

    t0 = time.perf_counter()
    pred = Predictor(CONFIG, SERVING["opts"], device=dev)
    pred.load_flax_params(bridge.seeded_flax_params(pred.model, SEED, EMB_PRED_STD))
    check(pred.cfg.TPU.COMPUTE_DTYPE == "bfloat16", "the serving config must run in bfloat16")
    setup_s = time.perf_counter() - t0

    rng = np.random.default_rng(SEED + 3)
    table = rng.standard_normal((66, 768)).astype(np.float32)
    table[0] = 0.0
    b, (h, w) = SERVING["batch"], SERVING["hw"]
    batches = []
    for _ in range(SERVING["batches"]):
        images = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
        sizes = np.stack(
            [rng.integers(3 * h // 4, h + 1, b), rng.integers(2 * w // 3, w + 1, b)], 1
        ).astype(np.int32)
        sizes[0] = (h, w)
        batches.append((images, sizes))

    checks = {"nms": [], "roi_align": []}

    def check_nms(inputs, out):
        ref = nm.nms_plain(*inputs)
        checks["nms"].append(int((out[0] != ref[0]).sum() + (out[1] != ref[1]).sum()))

    def check_roi(inputs, out):
        ref = ra.roi_align_plain(*inputs)
        checks["roi_align"].append(
            (float((out - ref).abs().max()), float(inputs[0].abs().max()))
        )

    kernels.reset_launches()
    lat, counts = [], []
    torch.cuda.reset_peak_memory_stats()
    for i, (images, sizes) in enumerate(batches):
        first = i == 0
        kernels.NMS.on_launch = check_nms if first else None
        kernels.ROI_ALIGN.on_launch = check_roi if first else None
        torch.cuda.synchronize()
        t = time.perf_counter()
        dets, masks = pred(images, sizes, table)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t)
        counts.append(dets.valid.sum(1).tolist())
        check(dets.boxes.shape == (b, 100, 4) and masks.shape == (b, 100, 14, 14),
              f"serving: unexpected shapes {dets.boxes.shape} {masks.shape}")
        check(np.isfinite(dets.boxes).all() and np.isfinite(dets.scores).all()
              and np.isfinite(masks).all(), "serving: non-finite output")
        check(bool(dets.valid.any(1).all()), f"serving: batch {i} has an image without detections")
    kernels.NMS.on_launch = kernels.ROI_ALIGN.on_launch = None
    launches = {k.name: k.launches for k in kernels.ALL}
    peak = torch.cuda.max_memory_allocated()

    check(len(checks["nms"]) == 2 and all(m == 0 for m in checks["nms"]),
          f"serving: NMS launches differ from the plain version: {checks['nms']}")
    check(len(checks["roi_align"]) == 2
          and all(e <= 1e-5 * f for e, f in checks["roi_align"]),
          f"serving: RoIAlign launches over tolerance: {checks['roi_align']}")
    check(all(v > 0 for v in launches.values()), f"serving: a kernel never launched: {launches}")
    steady = lat[1:]
    rec = dict(
        phase="serving", config=CONFIG, dtype="bfloat16", batch=b, image_hw=[h, w],
        emb_pred_std=EMB_PRED_STD, setup_s=setup_s, batch_latency_s=lat,
        steady_images_per_s=b * len(steady) / sum(steady),
        peak_memory_gb=peak / 1e9, valid_detections=counts, launches=launches,
        first_batch_checks={"nms_mismatches": checks["nms"],
                            "roi_align_max_abs_err": [e for e, _ in checks["roi_align"]]},
    )
    emit(rec)
    results["serving"] = rec
    return pred, batches[-1], table


KERNEL_GROUPS = (  # (group, substrings of device kernel names), first match wins
    ("port: nms", ("nms_mask_kernel", "nms_scan_kernel")),
    ("port: roi_align", ("roi_align_fwd_kernel",)),
    ("conv / matmul", ("xmma", "nvjet", "cutlass", "gemm", "conv", "implicit")),
    ("sort / select", ("sort", "radix", "scan", "topk", "index", "gather")),
    ("copy / cast", ("copy", "Memcpy", "Memset")),
    ("elementwise", ("elementwise",)),
    ("reduce", ("reduce",)),
)


def phase_profile(pred, batch, table):
    """One more serving batch under torch.profiler: device time by kernel
    group and the device's busy share of the batch's wall time.  Only
    device-side events count (the aten ops that launched them would
    count the same time twice)."""
    from torch.profiler import ProfilerActivity, profile

    images, sizes = batch
    pred(images, sizes, table)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        pred(images, sizes, table)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    groups, top = {}, []
    for ev in prof.key_averages():
        if "CUDA" not in str(ev.device_type) or ev.key.startswith("Activity Buffer"):
            continue
        ms = getattr(ev, "self_device_time_total", 0.0) / 1e3
        group = next((g for g, keys in KERNEL_GROUPS if any(k in ev.key for k in keys)), "other")
        groups[group] = groups.get(group, 0.0) + ms
        top.append((ms, ev.count, ev.key[:90]))
    top.sort(reverse=True)
    device_ms = sum(groups.values())
    emit(dict(phase="profile", wall_ms=wall_ms, device_ms=device_ms,
              device_busy_share=device_ms / wall_ms,
              groups_ms=dict(sorted(groups.items(), key=lambda kv: -kv[1])),
              top=[dict(ms=ms, calls=n, name=name) for ms, n, name in top[:15]]))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "cvpr22_cross_modal_pseudo_labeling_torch")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 1
    os.chdir(here)
    sys.path.insert(0, here)
    from cvpr22_cross_modal_pseudo_labeling_torch.ops import kernels

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    t = time.perf_counter()
    kernels.build_all()
    emit(dict(phase="build", seconds=time.perf_counter() - t,
              libraries=[str(k.library_path().name) for k in kernels.ALL]))

    results = {}
    phase_nms(dev, results)
    phase_roi_align(dev, results)
    phase_small()
    pred, batch, table = phase_serving(dev, results)
    phase_profile(pred, batch, table)
    del pred

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    serving = results["serving"]
    nms_rpn, roi_main = results["nms_rpn"], results[("roi_align",) + ROI_MAIN]
    emit({"kernels": [
        dict(name="nms", route="cuda",
             source="cvpr22_cross_modal_pseudo_labeling_torch/csrc/nms.cu",
             replaces="cvpr22_cross_modal_pseudo_labeling_tpu/ops/nms_pallas.py:47",
             launches=serving["launches"]["nms"],
             max_abs_err=float(max(serving["first_batch_checks"]["nms_mismatches"]
                                   + [results["nms_rpn"]["mismatches"],
                                      results["nms_detections"]["mismatches"]])),
             ms=nms_rpn["ms"], plain_ms=nms_rpn["plain_ms"],
             bound_ms=nms_rpn["bound_ms"], bound_by=nms_rpn["bound_by"],
             library_ms=None),
        dict(name="roi_align", route="cuda",
             source="cvpr22_cross_modal_pseudo_labeling_torch/csrc/roi_align.cu",
             replaces="tools/proto_pallas_roialign.py:146",
             launches=serving["launches"]["roi_align"],
             max_abs_err=max(serving["first_batch_checks"]["roi_align_max_abs_err"]
                             + [results[("roi_align",) + c]["max_abs_err"] for c in ROI_CASES]),
             ms=roi_main["ms"], plain_ms=roi_main["plain_ms"],
             bound_ms=roi_main["bound_ms"], bound_by=roi_main["bound_by"],
             library_ms=None),
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
