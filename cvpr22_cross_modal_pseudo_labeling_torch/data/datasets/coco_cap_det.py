"""COCO detection + captions dataset for student-teacher training.

The port's copy of ``cvpr22_cross_modal_pseudo_labeling_tpu/data/
datasets/coco_cap_det.py``.

Re-design of reference data/datasets/coco_cap_det.py:55-188: each
detection sample additionally carries its image's caption, the parsed
LVIS noun phrases joined by '/' (``nn_caption``), the 0-based LVIS
category ids (``ids_cap``) and ``is_det='Yes'``.

Noun parsing is precomputed at construction (one pass over the caption
JSON) rather than per-__getitem__ — the reference parses in the data
worker with spaCy (SURVEY.md flags this as a throughput hazard).
"""

from typing import Dict, Optional

from ..coco_index import CocoIndex
from ..parser import get_parser
from .coco import COCODataset


class COCOCapDetDataset(COCODataset):
    def __init__(
        self,
        ann_file: str,
        root: str,
        remove_images_without_annotations: bool,
        transforms=None,
        extra_args: Optional[dict] = None,
        cap_ann_file: Optional[str] = None,
    ):
        super().__init__(
            ann_file,
            root,
            remove_images_without_annotations,
            transforms,
            extra_args,
        )
        self.captions: Dict[int, str] = {}
        self.parsed: Dict[int, tuple] = {}
        if cap_ann_file:
            caps = CocoIndex(cap_ann_file)
            parser = get_parser()
            for img_id in self.ids:
                anns = caps.load_anns_for_image(img_id)
                text = anns[0]["caption"] if anns else ""
                self.captions[img_id] = text
                nns, ids = parser.parse(text) if text else ([], [])
                self.parsed[img_id] = (nns, ids)

    def raw_sample(self, index: int) -> Dict:
        sample = super().raw_sample(index)
        img_id = sample["image_id"]
        caption = self.captions.get(img_id, "")
        nns, ids = self.parsed.get(img_id, ([], []))
        sample["caption"] = caption
        sample["nn_caption"] = "/".join(nns)
        sample["ids_cap"] = list(ids)
        sample["is_det"] = "Yes"
        return sample
