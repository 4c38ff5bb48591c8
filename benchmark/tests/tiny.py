"""A cell's configuration and mix cut to a size the CPU runs in seconds,
for the benchmark's CPU tests: narrow trunk and heads (stem 8, res2 16,
width 4, masks of 8 channels), a few proposals and rois, images of about
64 x 90 in batches of 2.  The same keys as the cells' files, so the harness runs
them unchanged."""

import json
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parents[1]

PORT_OPTS = [
    "MODEL.RESNETS.STEM_OUT_CHANNELS", 8, "MODEL.RESNETS.RES2_OUT_CHANNELS", 16,
    "MODEL.RESNETS.WIDTH_PER_GROUP", 4, "MODEL.RPN.PRE_NMS_TOP_N_TRAIN", 128,
    "MODEL.RPN.POST_NMS_TOP_N_TRAIN", 32, "MODEL.RPN.PRE_NMS_TOP_N_TEST", 128,
    "MODEL.RPN.POST_NMS_TOP_N_TEST", 32, "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 16,
    "TPU.MASK_POS_CAP", 8, "TPU.MAX_GT", 4, "TPU.MAX_CAP_NOUNS", 3,
    "MODEL.ROI_MASK_HEAD.CONV_LAYERS", (8,), "TPU.COMPUTE_DTYPE", "float32",
    "SOLVER.IMS_PER_BATCH", 2, "TEST.IMS_PER_BATCH", 2, "SOLVER.LOG_PERIOD", 2,
    "MODEL.ROI_HEADS.SCORE_THRESH", 0.0,
]
MODEL = dict(stem_out_channels=8, res2_out_channels=16, width_per_group=4, rpn_pre_nms_train=128,
             rpn_post_nms_train=32, rpn_pre_nms_test=128, rpn_post_nms_test=32, roi_batch_per_image=16,
             mask_pos_cap=8, max_gt=4, max_cap_nouns=3, mask_dim_reduced=8, compute_dtype="float32",
             score_thresh=0.0)
MIX = dict(batch=2, max_gt=4, max_nouns=3, image_sizes=[[90, 64, 3], [96, 72, 1], [64, 88, 2]], resize=[64, 96],
           buckets=[[64, 96], [96, 64]], trace_seconds=2)


def config(name: str):
    c = json.loads((HERE / "configs" / f"{name}.json").read_text())
    c["model"].update(MODEL)
    c["solver"]["ims_per_batch"] = MIX["batch"]
    c["opts"] = list(PORT_OPTS)
    return c


def mix(name: str):
    return dict(json.loads((HERE / "traffic" / f"{name}.json").read_text()), **MIX)


def context(config_name: str, mix_name: str, seed: int = 3, seconds: float = 1.0, device: str = "cpu"):
    return SimpleNamespace(config=config(config_name), mix=mix(mix_name), seed=seed, seconds=seconds,
                           trace=False, device=device)
