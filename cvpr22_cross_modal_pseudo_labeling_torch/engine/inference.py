"""Serving and evaluation entry points: a config file in, detections,
masks and COCO metrics out.

``Predictor`` is the counterpart of the ``forward`` that
``cvpr22_cross_modal_pseudo_labeling_tpu/engine/inference.py::
compute_on_dataset`` runs per batch (:49-59, :149-159): the eval forward
on a padded uint8 batch with the dataset's class table, brought back to
the host as numpy, for the model the config's
``MODEL.META_ARCHITECTURE`` names (``GeneralizedRCNN``, the teacher, or
``STGeneralizedRCNN``).  ``compute_on_dataset`` and ``inference`` port
the JAX package's ``compute_on_dataset`` and ``inference`` (:25-211,
:389-442) over a ``Predictor``: the port's
loader feeds it, a thread pool converts each batch to COCO results while
the card computes the next, and the port's evaluator scores them.  One
process; test-time augmentation and proposal evaluation are not ported
yet (ROADMAP.md queue A item 2).
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
from ..models.detector import build_detection_model


class NumpyDetections(NamedTuple):
    boxes: np.ndarray  # [B, D, 4] float32 xyxy
    scores: np.ndarray  # [B, D] float32
    labels: np.ndarray  # [B, D] int32 (row of the class table)
    valid: np.ndarray  # [B, D] bool


def load_cfg(config_file: str, opts: Sequence = ()):
    cfg = get_default_cfg()
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

    def load_flax_params(self, params) -> None:
        load_flax_params(self.model, params)

    @torch.inference_mode()
    def __call__(
        self,
        images: np.ndarray,
        image_sizes: np.ndarray,
        class_embeddings: np.ndarray,
    ):
        """images ``[B, H, W, 3]`` uint8 padded batch; image_sizes
        ``[B, 2]`` (h, w); class_embeddings ``[C, emb_dim]`` (row 0 is
        the background), passed to the model as it is: the
        student-teacher model normalizes its rows, the teacher scores
        against them unnormalized, as their JAX counterparts do.
        Returns ``(NumpyDetections, mask_probs [B, D, M, M] float32 or
        None)``."""
        dev = self.device
        out = self.model(
            torch.as_tensor(images).to(dev),
            torch.as_tensor(image_sizes).to(dev),
            torch.as_tensor(class_embeddings, dtype=torch.float32).to(dev),
        )
        d = out.detections
        dets = NumpyDetections(
            boxes=d.boxes.cpu().numpy(),
            scores=d.scores.cpu().numpy(),
            labels=d.labels.cpu().numpy(),
            valid=d.valid.cpu().numpy(),
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
                contiguous_to_json=dataset.contiguous_category_id_to_json_id,
            )
        )
    return out


def compute_on_dataset(
    predictor: Predictor,
    loader,
    dataset,
    class_embeddings: np.ndarray,
) -> Tuple[List[dict], Dict[str, float]]:
    """Runs the eval forward over the loader; returns the COCO-format
    results and the pass's timing.

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
            dets, mask_probs = predictor(
                batch["images"], batch["image_sizes"], class_embeddings
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


def check_eval_options(cfg) -> None:
    """Refuses the eval options the port does not run yet."""
    if cfg.TEST.BBOX_AUG.ENABLED:
        raise NotImplementedError(
            "TEST.BBOX_AUG: test-time augmentation is not ported yet "
            "(ROADMAP.md queue A item 2)"
        )
    if cfg.MODEL.RPN_ONLY:
        raise NotImplementedError(
            "MODEL.RPN_ONLY: proposal evaluation is not ported yet "
            "(ROADMAP.md queue A item 2)"
        )


def inference(
    predictor: Predictor,
    loader,
    dataset,
    iou_types=("bbox",),
    expected_results=(),
    expected_results_sigma_tol: float = 4.0,
    output_file: Optional[str] = None,
) -> Dict[str, float]:
    """Full eval pass over one dataset: the forward, the COCO results
    (written to ``output_file``) and the metrics dict.  Besides the
    metrics it holds ``total_eval_seconds``, as the JAX ``inference`` does,
    and the pass's timing under ``time/`` (``compute_on_dataset``'s
    keys, and ``time/evaluate_s``, the evaluator's seconds).  The
    dataset's class table goes to the model raw: the student-teacher
    model normalizes its rows, the teacher does not."""
    check_eval_options(predictor.cfg)
    start = time.time()
    results, stats = compute_on_dataset(predictor, loader, dataset, dataset.class_emb_mtx)
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
