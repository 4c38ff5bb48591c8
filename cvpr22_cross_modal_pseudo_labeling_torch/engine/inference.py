"""Serving and evaluation entry points: a config file in, detections,
masks and COCO metrics out.

``Predictor`` is the counterpart of the ``forward`` that
``cvpr22_cross_modal_pseudo_labeling_tpu/engine/inference.py::
compute_on_dataset`` runs per batch (:49-59, :149-159): the eval forward
on a padded uint8 batch with the dataset's class table (none for a
class-specific detector), brought back to the host as numpy, for the
model the config's ``MODEL.META_ARCHITECTURE`` names (a member of the
``GeneralizedRCNN`` or ``STGeneralizedRCNN`` family).  ``compute_on_dataset`` and ``inference`` port
the JAX package's ``compute_on_dataset`` and ``inference`` (:25-211,
:389-442) over a ``Predictor``: the port's
loader feeds it, a thread pool converts each batch to COCO results while
the card computes the next, and the port's evaluator scores them.
``compute_on_dataset_bbox_aug`` ports JAX's test-time augmentation
(:214-318, ``TEST.BBOX_AUG``) over the same ``Predictor``, and
``evaluate_proposals`` its proposal evaluation (:321-389), which
``inference`` runs for an RPN-only model.  One process.
"""

import concurrent.futures as cf
import logging
import os
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..bridge import load_flax_params
from ..config import get_default_cfg
from ..data.evaluation import evaluate
from ..data.evaluation.prepare import detections_to_coco_results
from ..models.detector import RCNN_FAMILY, build_detection_model


class NumpyDetections(NamedTuple):
    boxes: np.ndarray  # [B, D, 4] float32 xyxy
    scores: np.ndarray  # [B, D] float32
    labels: np.ndarray  # [B, D] int32 (row of the class table)
    valid: np.ndarray  # [B, D] bool
    # MODEL.KEYPOINT_ON: [B, D, K, 3] float32 (x, y, score), else None
    keypoints: Optional[np.ndarray] = None


def load_cfg(config_file: str, opts: Sequence = ()):
    """The defaults, ``config_file`` (none when empty) and ``opts``,
    frozen."""
    cfg = get_default_cfg()
    if config_file:
        cfg.merge_from_file(config_file)
    cfg.merge_from_list(list(opts))
    cfg.freeze()
    return cfg


class Predictor:
    """Builds the model a config names and answers eval batches.

    ``device`` defaults to ``"cuda"`` and raises when no card is
    present; pass ``device="cpu"`` to run the plain versions of the
    kernels on the CPU.  The weights stay at their construction values
    until :meth:`load_flax_params` loads a flax param tree of the JAX
    package (see ``bridge.py``).
    """

    def __init__(self, config_file: str, opts: Sequence = (), device: str = "cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Predictor: no CUDA device is available; pass device='cpu' "
                "to run on the CPU"
            )
        self.cfg = load_cfg(config_file, opts)
        self.device = device
        self.model = build_detection_model(self.cfg).eval().to(device)

    @classmethod
    def from_model(cls, cfg, model) -> "Predictor":
        """A ``Predictor`` that serves ``model`` (built from ``cfg``) on
        the model's device, in eval mode; the weights are shared, not
        copied (the in-training evaluation serves the trainer's model)."""
        self = cls.__new__(cls)
        self.cfg = cfg
        self.model = model.eval()
        self.device = next(model.parameters()).device
        return self

    def load_flax_params(self, params) -> None:
        load_flax_params(self.model, params)

    @torch.inference_mode()
    def __call__(
        self,
        images: np.ndarray,
        image_sizes: np.ndarray,
        class_embeddings: Optional[np.ndarray] = None,
        gt_eval: Optional[Dict[str, np.ndarray]] = None,
    ):
        """images ``[B, H, W, 3]`` padded batch, uint8 (normalized on the
        device) or float32 already normalized on the host; image_sizes
        ``[B, 2]`` (h, w); class_embeddings ``[C, emb_dim]`` (row 0 is
        the background), passed to the model as it is: the
        student-teacher model normalizes its rows, the teacher scores
        against them unnormalized, as their JAX counterparts do; a
        class-specific detector takes none.  ``gt_eval``
        (``MODEL.GT_BOX_EVAL``): ``boxes`` ``[B, G, 4]``, ``labels`` and
        ``valid`` ``[B, G]`` in the input frame, scored in place of the
        proposals (``GeneralizedRCNN`` only).  Returns
        ``(NumpyDetections, mask_probs [B, D, M, M] float32 or None)``;
        the detections carry the keypoints of a ``KEYPOINT_ON`` model."""
        dev = self.device
        table = None
        if class_embeddings is not None:
            table = torch.as_tensor(class_embeddings, dtype=torch.float32).to(dev)
        kw = {}
        if gt_eval is not None:
            kw["gt_eval"] = {k: torch.as_tensor(np.asarray(v)).to(dev) for k, v in gt_eval.items()}
        out = self.model(
            torch.as_tensor(images).to(dev),
            torch.as_tensor(image_sizes).to(dev),
            table,
            **kw,
        )
        d = out.detections
        dets = NumpyDetections(
            boxes=d.boxes.cpu().numpy(),
            scores=d.scores.cpu().numpy(),
            labels=d.labels.cpu().numpy(),
            valid=d.valid.cpu().numpy(),
            keypoints=None if getattr(out, "keypoints", None) is None else out.keypoints.cpu().numpy(),
        )
        masks = None if out.mask_probs is None else out.mask_probs.cpu().numpy()
        return dets, masks


def _convert_batch(dataset, dets, mask_probs, indices, image_sizes) -> List[dict]:
    """One batch's detections -> COCO results (numpy only: it runs on
    the conversion pool's threads)."""
    out: List[dict] = []
    for bi, ds_index in enumerate(indices):
        info = dataset.get_img_info(ds_index)
        out.extend(
            detections_to_coco_results(
                dets.boxes[bi],
                dets.scores[bi],
                dets.labels[bi],
                dets.valid[bi],
                mask_probs[bi] if mask_probs is not None else None,
                image_id=dataset.id_to_img_map[ds_index],
                input_hw=image_sizes[bi],
                original_hw=(info["height"], info["width"]),
                contiguous_to_json=getattr(dataset, "contiguous_category_id_to_json_id", {}),
                keypoints=None if dets.keypoints is None else dets.keypoints[bi],
            )
        )
    return out


def compute_on_dataset(
    predictor: Predictor,
    loader,
    dataset,
    class_embeddings: Optional[np.ndarray],
    gt_box_eval: bool = False,
) -> Tuple[List[dict], Dict[str, float]]:
    """Runs the eval forward over the loader; returns the COCO-format
    results and the pass's timing.  With ``gt_box_eval``
    (``MODEL.GT_BOX_EVAL``) each batch's gt boxes are scored in place of
    the proposals.

    The device figures time ``predictor`` (the forward and the copy of
    its outputs to the host); the end-to-end ones add the loader's
    decode and collate and the conversion that overlaps them.  The
    ``steady`` figures drop the first batch, which carries the first
    launches' setup.  Keys: ``images``, ``device_s_per_img``,
    ``steady_device_s_per_img``, ``first_batch_s``, ``e2e_s_per_img``,
    ``e2e_images_per_s``, ``steady_images_per_s``,
    ``device_busy_share`` (the ``predictor`` calls' wall time over the
    pass's wall time, as JAX's log line computes it: the forward, the
    copy to the host and any wait on the host threads beside them, not
    the device's occupancy) and
    ``conversion_wait_s`` (wall time spent waiting on the conversion
    pool)."""
    logger = logging.getLogger(__name__)
    # host COCO conversion (mask paste + RLE encode) runs in a thread
    # pool so the card computes batch N+1 while batch N converts
    futures: List[cf.Future] = []
    results: List[dict] = []
    batch_times: List[Tuple[float, int]] = []  # (seconds, images)
    wait_s = 0.0
    wall_start = time.perf_counter()
    workers = min(8, os.cpu_count() or 1)
    # backpressure: each pending future holds its batch's mask_probs;
    # drain oldest-first beyond 2x the pool so host conversion slower
    # than the forward cannot accumulate every mask tensor in memory.
    # Order is preserved: futures are drained and extended FIFO.
    max_inflight = 2 * workers
    with cf.ThreadPoolExecutor(max_workers=workers) as pool:
        for batch, indices in loader:
            t = time.perf_counter()
            kw = {}
            if gt_box_eval:
                kw["gt_eval"] = {"boxes": batch["gt_boxes"], "labels": batch["gt_labels"],
                                 "valid": batch["gt_valid"]}
            dets, mask_probs = predictor(
                batch["images"], batch["image_sizes"], class_embeddings, **kw
            )
            batch_times.append((time.perf_counter() - t, len(indices)))
            futures.append(
                pool.submit(
                    _convert_batch,
                    dataset,
                    dets,
                    mask_probs,
                    list(indices),
                    np.asarray(batch["image_sizes"]),
                )
            )
            t = time.perf_counter()
            while len(futures) > max_inflight:
                results.extend(futures.pop(0).result())
            wait_s += time.perf_counter() - t
        t = time.perf_counter()
        for f in futures:
            results.extend(f.result())
        wait_s += time.perf_counter() - t
    wall = time.perf_counter() - wall_start
    n_images = sum(n for _, n in batch_times)
    if not n_images:
        return results, {"images": 0}
    device_s = sum(t for t, _ in batch_times)
    first_s, first_n = batch_times[0]
    steady_n = n_images - first_n
    steady_wall = max(wall - first_s, 1e-9)
    stats = {
        "images": n_images,
        "device_s_per_img": device_s / n_images,
        "steady_device_s_per_img": (device_s - first_s) / max(steady_n, 1),
        "first_batch_s": first_s,
        "e2e_s_per_img": wall / n_images,
        "e2e_images_per_s": n_images / wall,
        "steady_images_per_s": steady_n / steady_wall,
        "device_busy_share": device_s / wall,
        "conversion_wait_s": wait_s,
    }
    logger.info(
        "inference: %d images, %.4f s/img device "
        "(steady %.4f excl. first-batch %.1f s), %.4f s/img e2e "
        "(%.2f imgs/s e2e; steady %.2f imgs/s; device busy %.0f%%)",
        n_images,
        stats["device_s_per_img"],
        stats["steady_device_s_per_img"],
        first_s,
        stats["e2e_s_per_img"],
        stats["e2e_images_per_s"],
        stats["steady_images_per_s"],
        100.0 * stats["device_busy_share"],
    )
    return results, stats


def iou_types(cfg) -> Tuple[str, ...]:
    """The evaluator's iou types of a config, as both JAX entry points
    list them: boxes, masks under ``MASK_ON``, keypoints under
    ``KEYPOINT_ON``."""
    return (("bbox",) + (("segm",) if cfg.MODEL.MASK_ON else ())
            + (("keypoints",) if cfg.MODEL.KEYPOINT_ON else ()))


def check_eval_options(cfg) -> None:
    """Refuses the eval options that the model cannot serve."""
    if cfg.MODEL.GT_BOX_EVAL and (cfg.MODEL.META_ARCHITECTURE not in RCNN_FAMILY or cfg.MODEL.RETINANET_ON):
        raise ValueError(
            f"MODEL.GT_BOX_EVAL: {cfg.MODEL.META_ARCHITECTURE}"
            f"{' with MODEL.RETINANET_ON' if cfg.MODEL.RETINANET_ON else ''} scores no given boxes; "
            "the GeneralizedRCNN family's two-stage detectors do"
        )


def bbox_aug_options(cfg) -> Optional[dict]:
    """The ``bbox_aug`` dict of ``tools/test_net.py:128-163`` when
    ``TEST.BBOX_AUG.ENABLED``, else None."""
    if not cfg.TEST.BBOX_AUG.ENABLED:
        return None
    return {
        "scales": cfg.TEST.BBOX_AUG.SCALES,
        "max_size": cfg.TEST.BBOX_AUG.MAX_SIZE,
        "h_flip": cfg.TEST.BBOX_AUG.H_FLIP,
        "scale_h_flip": cfg.TEST.BBOX_AUG.SCALE_H_FLIP,
        "base_scale": cfg.INPUT.MIN_SIZE_TEST,
        "pixel_mean": cfg.INPUT.PIXEL_MEAN,
        "pixel_std": cfg.INPUT.PIXEL_STD,
        "to_bgr255": cfg.INPUT.TO_BGR255,
        "buckets": cfg.TPU.IMAGE_BUCKETS,
        "size_divisible": cfg.DATALOADER.SIZE_DIVISIBILITY,
        "nms_thresh": cfg.MODEL.ROI_HEADS.NMS,
        "detections_per_img": cfg.MODEL.ROI_HEADS.DETECTIONS_PER_IMG,
    }


def compute_on_dataset_bbox_aug(
    predictor: Predictor,
    dataset,
    class_embeddings: Optional[np.ndarray],
    bbox_aug: dict,
) -> Tuple[List[dict], Dict[str, float]]:
    """Multi-scale + flip test-time augmentation (JAX's
    ``compute_on_dataset_bbox_aug``, ``tpu/engine/inference.py:214``):
    for each image of ``dataset`` (its untransformed ``raw_sample``),
    one ``predictor`` call per (scale, flip) variant at batch 1, the
    image resized, flipped and normalized on the host as JAX's
    ``run_variant`` does (:244-262) and padded to the bucket
    ``select_bucket`` gives it; the variants' detections merge through
    ``engine/bbox_aug.py`` with the NMS on the predictor's device.
    Box-only, as in JAX (:228).  ``bbox_aug`` holds the keys of
    :func:`bbox_aug_options`.  Returns the COCO-format results and the
    pass's timing: ``images``, ``variants_per_img``,
    ``device_s_per_img`` (the ``predictor`` calls), ``host_s_per_img``
    (the rest of each image's variants and merge: resize,
    normalization, padding, the merge), ``e2e_s_per_img`` and
    ``e2e_images_per_s``."""
    from ..data.collate import select_bucket
    from ..data.transforms import Normalize, resize_image
    from .bbox_aug import im_detect_bbox_aug

    normalize = Normalize(
        bbox_aug["pixel_mean"],
        bbox_aug["pixel_std"],
        bbox_aug.get("to_bgr255", True),
    )
    calls: List[float] = []

    def run_variant(image, hw, flipped):
        h, w = image.shape[:2]
        nh, nw = hw
        img = image
        if (nh, nw) != (h, w):
            img = resize_image(img, nh, nw)
        if flipped:
            img = img[:, ::-1]
        img = normalize({"image": img}, None)["image"]
        hb, wb = select_bucket(
            nh, nw, bbox_aug["buckets"],
            bbox_aug.get("size_divisible", 32),
        )
        padded = np.zeros((1, hb, wb, 3), np.float32)
        padded[0, :nh, :nw] = img
        t = time.perf_counter()
        dets, _ = predictor(padded, np.asarray([[nh, nw]], np.int32), class_embeddings)
        calls.append(time.perf_counter() - t)
        keep = dets.valid[0]
        # input frame -> original frame (a flip stays; im_detect_bbox_aug
        # unflips in the original frame)
        boxes = dets.boxes[0][keep] * np.array(
            [w / nw, h / nh, w / nw, h / nh], np.float32
        )
        return boxes, dets.scores[0][keep], dets.labels[0][keep]

    results: List[dict] = []
    contig_to_json = getattr(dataset, "contiguous_category_id_to_json_id", {})
    wall_start = time.perf_counter()
    host_s = 0.0
    for index in range(len(dataset)):
        raw = dataset.raw_sample(index)
        n_calls = len(calls)
        t = time.perf_counter()
        boxes, scores, labels = im_detect_bbox_aug(
            run_variant,
            raw["image"],
            scales=bbox_aug["scales"],
            max_size=bbox_aug["max_size"],
            h_flip=bbox_aug["h_flip"],
            scale_h_flip=bbox_aug["scale_h_flip"],
            base_scale=bbox_aug["base_scale"],
            nms_thresh=bbox_aug.get("nms_thresh", 0.5),
            detections_per_img=bbox_aug.get("detections_per_img", 100),
            device=predictor.device,
        )
        host_s += time.perf_counter() - t - sum(calls[n_calls:])
        img_id = raw.get(
            "image_id",
            dataset.id_to_img_map[index]
            if hasattr(dataset, "id_to_img_map")
            else index,
        )
        for b, s, lbl in zip(boxes, scores, labels):
            x1, y1, x2, y2 = [float(v) for v in b]
            results.append(
                {
                    "image_id": int(img_id),
                    "category_id": int(contig_to_json.get(int(lbl), int(lbl))),
                    "bbox": [x1, y1, x2 - x1 + 1.0, y2 - y1 + 1.0],
                    "score": float(s),
                }
            )
    wall = time.perf_counter() - wall_start
    n = len(dataset)
    if not n:
        return results, {"images": 0}
    return results, {
        "images": n,
        "variants_per_img": len(calls) / n,
        "device_s_per_img": sum(calls) / n,
        "host_s_per_img": host_s / n,
        "e2e_s_per_img": wall / n,
        "e2e_images_per_s": n / wall,
    }


def evaluate_proposals(
    predictor: Predictor, loader, dataset, limit: int = 1000, output_file: Optional[str] = None,
) -> Dict[str, float]:
    """The RPN-only model's evaluation (JAX's ``evaluate_proposals``,
    ``tpu/engine/inference.py:321``): each image's valid proposals,
    scaled from the input frame back to the original image, then
    ``box_proposal/AR_{all,small,medium,large}@limit`` from
    ``data/evaluation/box_proposals.py``.  ``output_file`` receives the
    proposals, ``{image_id: [[x1, y1, x2, y2, score], ...]}``.  Besides
    the recalls the dict holds ``total_eval_seconds`` and the pass's
    ``time/`` figures (``images``, ``device_s_per_img``,
    ``e2e_images_per_s``)."""
    from ..data.evaluation.box_proposals import evaluate_box_proposals

    start = time.time()
    proposals_by_image: Dict[int, np.ndarray] = {}
    device_s = 0.0
    for batch, indices in loader:
        t = time.perf_counter()
        dets, _ = predictor(batch["images"], batch["image_sizes"], None)
        device_s += time.perf_counter() - t
        for bi, ds_index in enumerate(indices):
            info = dataset.get_img_info(ds_index)
            ih, iw = batch["image_sizes"][bi]
            sx, sy = info["width"] / iw, info["height"] / ih
            keep = dets.valid[bi]
            boxes = dets.boxes[bi][keep] * np.array([sx, sy, sx, sy], np.float32)
            img_id = (
                dataset.id_to_img_map[ds_index]
                if hasattr(dataset, "id_to_img_map")
                else info.get("id", ds_index)
            )
            proposals_by_image[img_id] = np.concatenate(
                [boxes, dets.scores[bi][keep][:, None]], axis=1
            ).astype(np.float64)
    if output_file:
        import json

        with open(output_file, "w") as f:
            json.dump({int(k): v.tolist() for k, v in proposals_by_image.items()}, f)
    out = {}
    for area in ("all", "small", "medium", "large"):
        res = evaluate_box_proposals(proposals_by_image, dataset.coco, area=area, limit=limit)
        out[f"box_proposal/AR_{area}@{limit}"] = res["ar"]
    n = len(proposals_by_image)
    wall = time.time() - start
    out.update({"time/images": float(n), "time/device_s_per_img": device_s / max(n, 1),
                "time/e2e_images_per_s": n / wall, "total_eval_seconds": wall})
    return out


def inference(
    predictor: Predictor,
    loader,
    dataset,
    iou_types=("bbox",),
    expected_results=(),
    expected_results_sigma_tol: float = 4.0,
    output_file: Optional[str] = None,
    bbox_aug: Optional[dict] = None,
) -> Dict[str, float]:
    """Full eval pass over one dataset: the forward, the COCO results
    (written to ``output_file``) and the metrics dict.  Besides the
    metrics it holds ``total_eval_seconds``, as the JAX ``inference`` does,
    and the pass's timing under ``time/`` (``compute_on_dataset``'s
    keys, and ``time/evaluate_s``, the evaluator's seconds).  The
    dataset's class table goes to the model raw: the student-teacher
    model normalizes its rows, the teacher does not.  ``bbox_aug``
    (:func:`bbox_aug_options`) switches to the test-time augmentation
    path, which is box-only and reads the dataset, not ``loader``.  A
    dataset without class embeddings (VOC, Cityscapes) serves a
    class-specific detector only.  An RPN-only model (its statics'
    ``rpn_only``, as JAX dispatches: not RetinaNet's, which have none)
    goes to :func:`evaluate_proposals`."""
    check_eval_options(predictor.cfg)
    if getattr(getattr(predictor.model, "statics", None), "rpn_only", False):
        return evaluate_proposals(predictor, loader, dataset, output_file=output_file)
    start = time.time()
    table = getattr(dataset, "class_emb_mtx", None)
    if bbox_aug:
        results, stats = compute_on_dataset_bbox_aug(predictor, dataset, table, bbox_aug)
        iou_types = tuple(t for t in iou_types if t == "bbox")
    else:
        results, stats = compute_on_dataset(
            predictor, loader, dataset, table, gt_box_eval=predictor.cfg.MODEL.GT_BOX_EVAL
        )
    if output_file:
        import json

        with open(output_file, "w") as f:
            json.dump(results, f)
    t = time.perf_counter()
    metrics = evaluate(
        dataset,
        results,
        iou_types=iou_types,
        expected_results=expected_results,
        expected_results_sigma_tol=expected_results_sigma_tol,
    )
    stats["evaluate_s"] = time.perf_counter() - t
    metrics.update({f"time/{k}": float(v) for k, v in stats.items()})
    metrics["total_eval_seconds"] = time.time() - start
    return metrics
