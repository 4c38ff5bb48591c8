"""Abstract dataset interface (reference data/datasets/abstract.py).

The port's copy of ``cvpr22_cross_modal_pseudo_labeling_tpu/data/
datasets/abstract.py``.

Defines the contract every dataset in this framework satisfies; concrete
datasets duck-type it (no inheritance requirement), and
``validate_dataset`` asserts conformance — useful when adding new
sources.
"""

from typing import Dict, Protocol, runtime_checkable

import numpy as np

SAMPLE_KEYS = {
    "image": "float32 [H, W, 3]",
    "boxes": "float32 [N, 4] xyxy (+1 convention)",
    "labels": "int64 [N] contiguous category ids (0 = background)",
    "gt_masks": "float32 [N, M, M] box-local instance masks",
    "image_id": "int",
    "is_det": "'Yes' | 'No'",
    "caption": "str",
    "nn_caption": "str ('/'-joined noun phrases)",
    "ids_cap": "list[int] 0-based LVIS ids",
}


@runtime_checkable
class DetectionDataset(Protocol):
    def __len__(self) -> int: ...

    def __getitem__(self, index: int) -> Dict: ...

    def get_img_info(self, index: int) -> Dict: ...


def validate_dataset(dataset, check_samples: int = 1) -> None:
    """Asserts the dataset satisfies the sample contract."""
    assert isinstance(dataset, DetectionDataset), (
        "dataset must implement __len__/__getitem__/get_img_info"
    )
    for i in range(min(check_samples, len(dataset))):
        s = dataset[i]
        missing = set(SAMPLE_KEYS) - set(s)
        assert not missing, f"sample missing keys: {missing}"
        assert s["image"].ndim == 3 and s["image"].shape[2] == 3
        assert s["boxes"].ndim == 2 and s["boxes"].shape[1] == 4
        assert len(s["labels"]) == len(s["boxes"])
        assert len(s["gt_masks"]) == len(s["boxes"])
        info = dataset.get_img_info(i)
        assert "height" in info and "width" in info
