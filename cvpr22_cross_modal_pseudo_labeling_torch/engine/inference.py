"""Serving entry point: a config file in, detections and masks out.

Counterpart of the ``forward`` that ``cvpr22_cross_modal_pseudo_labeling_
tpu/engine/inference.py::compute_on_dataset`` runs per batch (:49-59,
:149-159): the eval forward on a padded uint8 batch with the dataset's
class table, brought back to the host as numpy, for the model the
config's ``MODEL.META_ARCHITECTURE`` names (``GeneralizedRCNN``, the
teacher, or ``STGeneralizedRCNN``).  The data loader and the COCO
evaluator come with a later slice.
"""

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..bridge import load_flax_params
from ..config import get_default_cfg
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
