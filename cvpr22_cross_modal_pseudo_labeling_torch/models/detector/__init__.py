"""Detector registry.

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/models/detector/
__init__.py`` (``RCNN_FAMILY``, ``ST_FAMILY``, ``build_detection_model``
:11-15): the model a config's ``MODEL.META_ARCHITECTURE`` names.  The
port builds ``GeneralizedRCNN`` and ``STGeneralizedRCNN``; the other
members of both families, RetinaNet and MMSS raise.  The detector
modules are imported when a model is built, since the RoI-head modules
import this package's ``statics``.
"""

# meta-architecture families: the training step's shape follows the
# family, not the exact class
RCNN_FAMILY = ("GeneralizedRCNN", "SBBaseline", "OMP", "BA_RPN")
ST_FAMILY = ("STGeneralizedRCNN", "SoftTeacher", "UnbiasedTeacher")


def build_detection_model(cfg):
    """``GeneralizedRCNN`` or ``STGeneralizedRCNN`` for ``cfg``."""
    arch = cfg.MODEL.META_ARCHITECTURE
    if arch == "GeneralizedRCNN" and not cfg.MODEL.RETINANET_ON:
        from .generalized_rcnn import GeneralizedRCNN
        from .statics import statics_from_cfg

        return GeneralizedRCNN(statics_from_cfg(cfg))
    if arch == "STGeneralizedRCNN":
        from .st_generalized_rcnn import STGeneralizedRCNN, st_statics_from_cfg

        return STGeneralizedRCNN(st_statics_from_cfg(cfg))
    if arch in RCNN_FAMILY + ST_FAMILY + ("MMSS-GCNN",):
        what = "MODEL.RETINANET_ON" if arch == "GeneralizedRCNN" else f"META_ARCHITECTURE {arch}"
        raise NotImplementedError(f"{what} is not ported yet")
    raise ValueError(f"Unknown META_ARCHITECTURE {arch}")
