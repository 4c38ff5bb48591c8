"""Concatenation of datasets (reference data/datasets/concat_dataset.py).

The port's copy of ``cvpr22_cross_modal_pseudo_labeling_tpu/data/
datasets/concat.py``."""

import bisect
from typing import Sequence


class ConcatDataset:
    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self.cumulative = []
        total = 0
        for d in self.datasets:
            total += len(d)
            self.cumulative.append(total)
        # expose first dataset's class metadata
        for attr in ("class_emb_mtx", "class_names", "class_splits"):
            if self.datasets and hasattr(self.datasets[0], attr):
                setattr(self, attr, getattr(self.datasets[0], attr))

    def __len__(self):
        return self.cumulative[-1] if self.cumulative else 0

    def _locate(self, idx: int):
        ds = bisect.bisect_right(self.cumulative, idx)
        prev = self.cumulative[ds - 1] if ds > 0 else 0
        return ds, idx - prev

    def __getitem__(self, idx: int):
        ds, local = self._locate(idx)
        return self.datasets[ds][local]

    def get_img_info(self, idx: int):
        ds, local = self._locate(idx)
        return self.datasets[ds].get_img_info(local)

    def get_idxs(self, idx: int):
        return self._locate(idx)
