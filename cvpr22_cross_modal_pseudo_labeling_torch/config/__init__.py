from .cfg_node import CfgNode
from .defaults import get_default_cfg

# The R-50-FPN body over a shipped detector config (no config file ships
# one): the opts of the JAX package's own FPN tests
# (tests/test_fpn_path.py:61-70, tests/test_st_model.py:422-429).  Every
# other key keeps the config's value.
R50_FPN_OPTS = [
    "MODEL.BACKBONE.CONV_BODY", "R-50-FPN",
    "MODEL.RESNETS.BACKBONE_OUT_CHANNELS", 256,
    "MODEL.RPN.USE_FPN", True,
    "MODEL.RPN.ANCHOR_STRIDE", (4, 8, 16, 32, 64),
    "MODEL.RPN.ANCHOR_SIZES", (32, 64, 128, 256, 512),
    "MODEL.ROI_HEADS.USE_FPN", True,
    "MODEL.ROI_BOX_HEAD.POOLER_SCALES", (0.25, 0.125, 0.0625, 0.03125),
    "MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO", 2,
]

# maskrcnn_benchmark's configs/retinanet/retinanet_R-50-FPN_1x.yaml over a
# detector config: the RetinaNet detector (RETINANET_ON; the reference sets
# RPN_ONLY beside it, and JAX still runs the box evaluation), no masks,
# 256 FPN channels.  The MODEL.RETINANET keys keep the defaults, which are
# that config's.
RETINANET_OPTS = [
    "MODEL.RETINANET_ON", True,
    "MODEL.BACKBONE.CONV_BODY", "R-50-FPN-RETINANET",
    "MODEL.RESNETS.BACKBONE_OUT_CHANNELS", 256,
    "MODEL.MASK_ON", False,
    "MODEL.RPN_ONLY", True,
]

__all__ = ["CfgNode", "R50_FPN_OPTS", "RETINANET_OPTS", "get_default_cfg"]
