"""Detector registry.

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/models/detector/
__init__.py`` (``RCNN_FAMILY``, ``ST_FAMILY``, ``build_detection_model``
:11-74): the model a config's ``MODEL.META_ARCHITECTURE`` names, every
member of both families (``GeneralizedRCNN`` and its three baseline
skeletons, ``STGeneralizedRCNN`` and its two top-k teachers) and
``MMSS-GCNN`` (``MMSSGridModel``).  ``GeneralizedRCNN`` with
``MODEL.RETINANET_ON`` and unknown names raise.  The detector modules
are imported when a model is built, since the RoI-head modules import
this package's ``statics``.
"""

# meta-architecture families: the training step's shape follows the
# family, not the exact class
RCNN_FAMILY = ("GeneralizedRCNN", "SBBaseline", "OMP", "BA_RPN")
ST_FAMILY = ("STGeneralizedRCNN", "SoftTeacher", "UnbiasedTeacher")


def build_detection_model(cfg):
    """The module of ``cfg.MODEL.META_ARCHITECTURE``."""
    arch = cfg.MODEL.META_ARCHITECTURE
    if arch in RCNN_FAMILY:
        if arch == "GeneralizedRCNN" and cfg.MODEL.RETINANET_ON:
            raise NotImplementedError("MODEL.RETINANET_ON is not ported yet")
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
