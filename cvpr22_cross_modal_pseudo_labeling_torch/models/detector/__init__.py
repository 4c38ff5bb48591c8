"""Detector registry.

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/models/detector/
__init__.py`` (``RCNN_FAMILY``, ``ST_FAMILY``, ``build_detection_model``
:11-74): the model a config's ``MODEL.META_ARCHITECTURE`` names, every
member of both families (``GeneralizedRCNN`` and its three baseline
skeletons, ``STGeneralizedRCNN`` and its two top-k teachers) and
``MMSS-GCNN`` (``MMSSGridModel``), and ``GeneralizedRCNN`` with
``MODEL.RETINANET_ON``: ``RetinaNetDetector`` over the depth of
``CONV_BODY`` (:23-41; its suffix stripped).  Unknown names raise.  The
detector modules are imported when a model is built, since the RoI-head
modules import this package's ``statics``.
"""

import torch

# meta-architecture families: the training step's shape follows the
# family, not the exact class
RCNN_FAMILY = ("GeneralizedRCNN", "SBBaseline", "OMP", "BA_RPN")
ST_FAMILY = ("STGeneralizedRCNN", "SoftTeacher", "UnbiasedTeacher")


def build_detection_model(cfg):
    """The module of ``cfg.MODEL.META_ARCHITECTURE``."""
    arch = cfg.MODEL.META_ARCHITECTURE
    if arch == "GeneralizedRCNN" and cfg.MODEL.RETINANET_ON:
        # the reference swaps the RPN inside GeneralizedRCNN (rpn.py:204-205);
        # JAX selects the standalone detector, and so does the port
        from ..rpn.retinanet import retinanet_statics_from_cfg
        from .retinanet import RetinaNetDetector

        depth = cfg.MODEL.BACKBONE.CONV_BODY
        for suffix in ("-FPN-RETINANET", "-FPN", "-C5", "-C4"):
            if depth.endswith(suffix):
                depth = depth[: -len(suffix)]
                break
        dtype = torch.bfloat16 if cfg.TPU.COMPUTE_DTYPE == "bfloat16" else torch.float32
        return RetinaNetDetector(retinanet_statics_from_cfg(cfg), backbone_depth=depth, dtype=dtype)
    if arch in RCNN_FAMILY:
        from . import baselines
        from .generalized_rcnn import GeneralizedRCNN
        from .statics import statics_from_cfg

        cls = {"GeneralizedRCNN": GeneralizedRCNN, "SBBaseline": baselines.SBBaseline,
               "OMP": baselines.OMPBaseline, "BA_RPN": baselines.BARPNBaseline}[arch]
        return cls(statics_from_cfg(cfg))
    if arch in ST_FAMILY:
        from . import baselines
        from .st_generalized_rcnn import STGeneralizedRCNN, st_statics_from_cfg

        cls = {"STGeneralizedRCNN": STGeneralizedRCNN, "SoftTeacher": baselines.SoftTeacherRCNN,
               "UnbiasedTeacher": baselines.UnbiasedTeacherRCNN}[arch]
        return cls(st_statics_from_cfg(cfg))
    if arch == "MMSS-GCNN":
        from .mmss_gcnn import MMSSGridModel, mmss_statics_from_cfg

        return MMSSGridModel(mmss_statics_from_cfg(cfg))
    raise ValueError(f"Unknown META_ARCHITECTURE {arch}")
