"""COCO detection dataset (host-side).

The port's copy of ``cvpr22_cross_modal_pseudo_labeling_tpu/data/
datasets/coco.py``.

Re-design of reference data/datasets/coco.py:42-140: contiguous category
ids, optional class-embedding matrix loaded from the preprocessed
annotation JSON (``categories[i].embedding[EMB_KEY]`` -> [C+1, emb_dim]
with a zero background row 0), per-split category lists
(``categories[i].split``), and normalized class names with 'bg' at 0.

Samples are numpy dicts (see transforms.py); crowd annotations are
filtered (coco.py:107-109); xywh -> xyxy with the legacy +1.
"""

import os
from typing import Dict, List, Optional

import numpy as np

from ...core.boxes import TO_REMOVE
from ...utils.rle import coco_segmentation_to_mask, polygons_to_mask
from ..coco_index import CocoIndex
from ..parser import normalize_class_names

from ..rng import visit_rng


def rasterize_instance_mask(
    seg, box_xyxy: np.ndarray, image_hw, out_size: int = 28
) -> np.ndarray:
    """Rasterizes one COCO segmentation into an ``out_size`` box-local
    grid over ``box_xyxy`` (original-image frame).

    Box-local masks are the TPU-side GT mask representation: they are
    invariant under image resize (box-relative coordinates don't change)
    and flip by mirroring, so geometric transforms never re-rasterize.
    The device later crop-resizes them onto sampled proposals
    (ops/masks.project_masks_on_boxes), replacing the reference's
    per-box CPU projection (mask_head/loss.py:11-42).
    """
    if seg is None:
        return np.zeros((out_size, out_size), np.float32)
    x1, y1, x2, y2 = [float(v) for v in box_xyxy]
    w = max(x2 - x1 + TO_REMOVE, 1.0)
    h = max(y2 - y1 + TO_REMOVE, 1.0)
    if isinstance(seg, list):
        # polygons: map into box-local out_size grid and rasterize there
        scaled = [
            [
                (c - x1) / w * out_size if i % 2 == 0 else
                (c - y1) / h * out_size
                for i, c in enumerate(part)
            ]
            for part in seg
        ]
        return polygons_to_mask(scaled, out_size, out_size).astype(
            np.float32
        )
    # RLE: decode full, crop the box, resize
    import cv2

    full = coco_segmentation_to_mask(seg, *[int(v) for v in image_hw])
    xi1, yi1 = max(int(x1), 0), max(int(y1), 0)
    xi2 = min(int(np.ceil(x2)) + 1, full.shape[1])
    yi2 = min(int(np.ceil(y2)) + 1, full.shape[0])
    crop = full[yi1:yi2, xi1:xi2]
    if crop.size == 0:
        return np.zeros((out_size, out_size), np.float32)
    return (
        cv2.resize(
            crop.astype(np.float32), (out_size, out_size),
            interpolation=cv2.INTER_LINEAR,
        )
        >= 0.5
    ).astype(np.float32)


def _has_valid_annotation(anns) -> bool:
    # mirrors coco.py has_valid_annotation: some non-crowd box with area
    anns = [a for a in anns if not a.get("iscrowd", 0)]
    if not anns:
        return False
    return any(
        all(c > 1 for c in a["bbox"][2:]) for a in anns
    )


class COCODataset:
    def __init__(
        self,
        ann_file: str,
        root: str,
        remove_images_without_annotations: bool,
        transforms=None,
        extra_args: Optional[dict] = None,
    ):
        self.coco = CocoIndex(ann_file)
        self.root = root
        self._transforms = transforms
        extra_args = extra_args or {}
        self.gt_mask_size = int(extra_args.get("GT_MASK_SIZE", 28))

        self.ids = self.coco.get_img_ids()
        if remove_images_without_annotations:
            self.ids = [
                i
                for i in self.ids
                if _has_valid_annotation(self.coco.load_anns_for_image(i))
            ]

        cat_ids = self.coco.get_cat_ids()
        self.json_category_id_to_contiguous_id = {
            v: i + 1 for i, v in enumerate(cat_ids)
        }
        self.contiguous_category_id_to_json_id = {
            v: k for k, v in self.json_category_id_to_contiguous_id.items()
        }
        self.id_to_img_map = dict(enumerate(self.ids))
        self.categories = {
            cid: c["name"] for cid, c in self.coco.cats.items()
        }

        self.class_splits: Dict[str, List[int]] = {}
        self.class_emb_mtx = None
        if extra_args.get("LOAD_EMBEDDINGS"):
            emb_key = extra_args.get("EMB_KEY", "BertEmb")
            emb_dim = extra_args.get("EMB_DIM", 768)
            embs = {}
            for cid, cat in self.coco.cats.items():
                embs[cid] = np.asarray(
                    cat["embedding"][emb_key], np.float32
                )
                if "split" in cat:
                    self.class_splits.setdefault(cat["split"], []).append(
                        cid
                    )
            self.class_emb_mtx = np.zeros(
                (len(cat_ids) + 1, emb_dim), np.float32
            )
            for cont, cid in self.contiguous_category_id_to_json_id.items():
                self.class_emb_mtx[cont] = embs[cid]

        names = [""] * (len(cat_ids) + 1)
        for cid, name in self.categories.items():
            names[self.json_category_id_to_contiguous_id[cid]] = name
        names[0] = "bg"
        self.class_names = normalize_class_names(names)

    def __len__(self):
        return len(self.ids)

    def get_img_info(self, index: int) -> dict:
        return self.coco.imgs[self.id_to_img_map[index]]

    def _segmentation_for_ann(self, ann: dict):
        """Hook for subclasses with external mask storage (OpenImages)."""
        return ann.get("segmentation")

    def _load_image(self, img_id: int) -> np.ndarray:
        from ...utils.native_image import load_image_rgb

        info = self.coco.imgs[img_id]
        return load_image_rgb(os.path.join(self.root, info["file_name"]))

    def raw_sample(self, index: int) -> Dict:
        img_id = self.id_to_img_map[index]
        image = self._load_image(img_id)
        anns = [
            a
            for a in self.coco.load_anns_for_image(img_id)
            if not a.get("iscrowd", 0)
        ]
        boxes_xywh = np.asarray(
            [a["bbox"] for a in anns], np.float32
        ).reshape(-1, 4)
        boxes = np.concatenate(
            [
                boxes_xywh[:, :2],
                boxes_xywh[:, :2] + boxes_xywh[:, 2:] - TO_REMOVE,
            ],
            axis=1,
        )
        labels = np.asarray(
            [
                self.json_category_id_to_contiguous_id[a["category_id"]]
                for a in anns
            ],
            np.int64,
        )
        segs = [self._segmentation_for_ann(a) for a in anns]
        sample_kps = None
        if anns and any(a.get("keypoints") for a in anns):
            nk = max(
                len(a.get("keypoints") or []) // 3 for a in anns
            ) or 17
            rows = []
            for a in anns:
                kp = np.asarray(
                    a.get("keypoints") or [], np.float32
                ).reshape(-1, 3)
                if kp.shape[0] < nk:  # empty or shorter skeleton
                    kp = np.concatenate(
                        [kp, np.zeros((nk - kp.shape[0], 3), np.float32)]
                    )
                rows.append(kp[:nk])
            sample_kps = np.stack(rows)
        # clip to image (clip_to_image(remove_empty=True), coco.py:131)
        h, w = image.shape[:2]
        if len(boxes):
            boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, w - TO_REMOVE)
            boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, h - TO_REMOVE)
            keep = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
            boxes, labels = boxes[keep], labels[keep]
            segs = [s for s, k in zip(segs, keep) if k]
            if sample_kps is not None:
                sample_kps = sample_kps[keep]
        gt_masks = np.stack(
            [
                rasterize_instance_mask(
                    s, b, (h, w), self.gt_mask_size
                )
                for s, b in zip(segs, boxes)
            ]
        ) if len(boxes) else np.zeros(
            (0, self.gt_mask_size, self.gt_mask_size), np.float32
        )
        out_sample = {
            "image": image,
            "boxes": boxes.astype(np.float32),
            "labels": labels,
            "gt_masks": gt_masks,
            "image_id": img_id,
            "is_det": "Yes",
            "caption": "",
            "nn_caption": "",
            "ids_cap": [],
        }
        if sample_kps is not None:
            out_sample["keypoints"] = sample_kps
        return out_sample

    def __getitem__(self, index: int) -> Dict:
        sample = self.raw_sample(index)
        if self._transforms is not None:
            rng = visit_rng(index)
            sample = self._transforms(sample, rng)
        return sample
