"""Dataset catalog: names -> factory + constructor args.

The port's copy of ``cvpr22_cross_modal_pseudo_labeling_tpu/data/
paths_catalog.py``; one ``CMPL_TPU_DATA_DIR`` tree serves both packages.
The port reads the variable when a name is looked up, not when the
module is imported.

Re-design of reference config/paths_catalog.py:7-340 (DatasetCatalog /
ModelCatalog).  The data root can be overridden with the
CMPL_TPU_DATA_DIR environment variable; like the reference, deployments
may also point cfg.PATHS_CATALOG at their own module.
"""

import os


def data_dir() -> str:
    return os.environ.get("CMPL_TPU_DATA_DIR", "datasets")


class DatasetCatalog:
    DATASETS = {
        # --- zero-shot COCO splits (preprocess/coco outputs) ---
        "coco_zeroshot_train": {
            "factory": "COCODataset",
            "args": dict(
                ann_file="coco/zero-shot/instances_train2017_seen_2.json",
                root="coco/train2017",
            ),
        },
        "coco_zeroshot_val": {
            "factory": "COCODataset",
            "args": dict(
                ann_file="coco/zero-shot/instances_val2017_unseen_2.json",
                root="coco/val2017",
            ),
        },
        "coco_not_zeroshot_val": {
            "factory": "COCODataset",
            "args": dict(
                ann_file="coco/zero-shot/instances_val2017_seen_2.json",
                root="coco/val2017",
            ),
        },
        "coco_generalized_zeroshot_val": {
            "factory": "COCODataset",
            "args": dict(
                ann_file="coco/zero-shot/instances_val2017_all_2.json",
                root="coco/val2017",
            ),
        },
        "coco_cap_det_train": {
            "factory": "COCOCapDetDataset",
            "args": dict(
                ann_file="coco/zero-shot/instances_train2017_seen_2.json",
                root="coco/train2017",
                cap_ann_file="coco/annotations/captions_train2017.json",
            ),
        },
        "coco_captions_train": {
            "factory": "COCOCaptionsDataset",
            "args": dict(
                ann_file="coco/annotations/captions_train2017.json",
                root="coco/train2017",
            ),
        },
        "coco_captions_val": {
            "factory": "COCOCaptionsDataset",
            "args": dict(
                ann_file="coco/annotations/captions_val2017.json",
                root="coco/val2017",
            ),
        },
        # --- OpenImages + Conceptual Captions ---
        "openimages_zeroshot_train": {
            "factory": "OpenImagesDataset",
            "args": dict(
                ann_file="openimages/zero-shot/instances_train_seen.json",
                root="openimages/train",
            ),
        },
        "openimages_zeroshot_val": {
            "factory": "OpenImagesDataset",
            "args": dict(
                ann_file="openimages/zero-shot/instances_val_all.json",
                root="openimages/val",
                imagelevel_csv="openimages/annotations/"
                "validation-annotations-human-imagelabels-boxable.csv",
            ),
        },
        "conceptual_cap_train": {
            "factory": "ConCapDetDataset",
            "args": dict(
                index_file="conceptual/index_train.json",
                root="conceptual/images",
            ),
        },
        # --- Pascal VOC / Cityscapes (reference paths_catalog.py:95-149) ---
        "voc_2007_train": {
            "factory": "PascalVOCDataset",
            "args": dict(data_dir="voc/VOC2007", split="train"),
        },
        "voc_2007_val": {
            "factory": "PascalVOCDataset",
            "args": dict(data_dir="voc/VOC2007", split="val"),
        },
        "voc_2007_test": {
            "factory": "PascalVOCDataset",
            "args": dict(data_dir="voc/VOC2007", split="test"),
        },
        "voc_2007_train_cocostyle": {
            "factory": "COCODataset",
            "args": dict(
                ann_file="voc/VOC2007/Annotations/pascal_train2007.json",
                root="voc/VOC2007/JPEGImages",
            ),
        },
        "voc_2007_val_cocostyle": {
            "factory": "COCODataset",
            "args": dict(
                ann_file="voc/VOC2007/Annotations/pascal_val2007.json",
                root="voc/VOC2007/JPEGImages",
            ),
        },
        "cityscapes_fine_instanceonly_seg_train_cocostyle": {
            "factory": "COCODataset",
            "args": dict(
                ann_file="cityscapes/annotations/"
                "instancesonly_filtered_gtFine_train.json",
                root="cityscapes/images",
            ),
        },
        "cityscapes_fine_instanceonly_seg_val_cocostyle": {
            "factory": "COCODataset",
            "args": dict(
                ann_file="cityscapes/annotations/"
                "instancesonly_filtered_gtFine_val.json",
                root="cityscapes/images",
            ),
        },
        # mixture dataset built from two catalog entries
        "conceptual_openimages_train": {
            "factory": "ConceptualOpenImagesDetDataset",
            "args": dict(
                det_name="openimages_zeroshot_train",
                cap_name="conceptual_cap_train",
            ),
        },
    }

    @staticmethod
    def get(name: str) -> dict:
        if name not in DatasetCatalog.DATASETS:
            raise KeyError(f"Unknown dataset {name}")
        entry = DatasetCatalog.DATASETS[name]
        args = dict(entry["args"])
        for key in ("ann_file", "root", "cap_ann_file", "index_file",
                    "imagelevel_csv", "data_dir"):
            if key in args and not os.path.isabs(args[key]):
                args[key] = os.path.join(data_dir(), args[key])
        return {"factory": entry["factory"], "args": args}


class ModelCatalog:
    """catalog:// URL resolution (paths_catalog.py:340+): Caffe2
    ImageNet weights.  Zero-egress environments must pre-download and
    set CMPL_TPU_MODEL_DIR."""

    MODEL_DIR = os.environ.get("CMPL_TPU_MODEL_DIR", "models")
    C2_IMAGENET = {
        "MSRA/R-50": "R-50.pkl",
        "MSRA/R-101": "R-101.pkl",
    }

    @staticmethod
    def get(url: str) -> str:
        assert url.startswith("catalog://")
        name = url[len("catalog://") :]
        if name.startswith("ImageNetPretrained/"):
            key = name[len("ImageNetPretrained/") :]
            return os.path.join(
                ModelCatalog.MODEL_DIR, ModelCatalog.C2_IMAGENET[key]
            )
        raise KeyError(name)
