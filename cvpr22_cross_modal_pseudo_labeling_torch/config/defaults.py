"""Default configuration tree.

The port's own copy of ``cvpr22_cross_modal_pseudo_labeling_tpu/config/
defaults.py``, kept identical so every shipped YAML loads the same way.
TPU-only keys (``TPU.NMS_TILE``, ``TPU.MESH_*``, ``TPU.S2D_STEM``,
``TPU.IMAGE_BUCKETS``) are accepted and ignored by the port.

Key names mirror the reference config surface
(reference: maskrcnn_benchmark/config/defaults.py:21-581) so that the five
shipped experiment YAMLs (configs/coco_cap_det/*.yaml,
configs/conceptual_openimages_det/*.yaml) load unchanged.  A new ``TPU``
section holds the static-shape caps and mesh parameters that a
fixed-shape XLA program needs (the reference's dynamic BoxList shapes have
no equivalent).
"""

import os

from .cfg_node import CfgNode as CN

_C = CN()

# ---------------------------------------------------------------------------
# MODEL
# ---------------------------------------------------------------------------
_C.MODEL = CN()
_C.MODEL.RPN_ONLY = False
_C.MODEL.MASK_ON = False
_C.MODEL.RETINANET_ON = False
_C.MODEL.KEYPOINT_ON = False
_C.MODEL.DEVICE = "tpu"
_C.MODEL.META_ARCHITECTURE = "GeneralizedRCNN"
_C.MODEL.CLS_AGNOSTIC_BBOX_REG = False
_C.MODEL.CLS_AGNOSTIC_MASK = False
_C.MODEL.GT_BOX_EVAL = False

_C.MODEL.WEIGHT = ""
# TPU-framework extension: a checkpoint (orbax dir or torch .pth) whose
# language-backbone params fill the model's frozen BERT table after
# MODEL.WEIGHT is applied.  Closes the all-native pipeline when
# MODEL.WEIGHT is a stage-2 teacher orbax checkpoint (which carries no
# BERT); the reference instead downloads pretrained bert-base-uncased at
# construction (transformers.py:16-24).
_C.MODEL.LANGUAGE_WEIGHT = ""
_C.MODEL.BACKBONE_PREFIX = ""
_C.MODEL.LOAD_TRAINER_STATE = True
_C.MODEL.LOAD_EMB_PRED_FROM_MMSS_HEAD = False
_C.MODEL.LOAD_CLASSIFIER = True
_C.MODEL.LAMBDA_PSEUDO_LABEL = 0.0
_C.MODEL.UNCERTAINTY = False
_C.MODEL.RESUME = False
_C.MODEL.UNCERTAINTY_TRAIN_ITER = 10000
_C.MODEL.NO_PSEUDO_MASK = False
_C.MODEL.REWEIGHT = True
# Enable the exemplar-memory pathway updates (off at reference HEAD:
# the update call is commented out, st_generalized_rcnn.py:325-326)
_C.MODEL.EXEMPLARS_ENABLED = False

# ---------------------------------------------------------------------------
# INPUT
# ---------------------------------------------------------------------------
_C.INPUT = CN()
_C.INPUT.MIN_SIZE_TRAIN = (800,)
_C.INPUT.MAX_SIZE_TRAIN = 1333
_C.INPUT.MIN_SIZE_TEST = 800
_C.INPUT.MAX_SIZE_TEST = 1333
# Caffe2/Detectron convention: BGR, 0-255 range, mean-only normalization.
_C.INPUT.PIXEL_MEAN = (102.9801, 115.9465, 122.7717)
_C.INPUT.PIXEL_STD = (1.0, 1.0, 1.0)
_C.INPUT.TO_BGR255 = True
# Defer normalization to the device when the decoded image is uint8:
# the batch ships to HBM as uint8 (4x smaller transfer) and the
# BGR/mean/std math fuses into the stem conv's input
# (models/backbone.py:device_normalize).  Numerically identical to the
# host path; set False to normalize on the host like the reference
# (transforms.py:110-120).
_C.INPUT.DEVICE_NORMALIZE = True
_C.INPUT.BRIGHTNESS = 0.0
_C.INPUT.CONTRAST = 0.0
_C.INPUT.SATURATION = 0.0
_C.INPUT.HUE = 0.0
_C.INPUT.HORIZONTAL_FLIP_PROB_TRAIN = 0.5
_C.INPUT.VERTICAL_FLIP_PROB_TRAIN = 0.0

# ---------------------------------------------------------------------------
# DATASETS
# ---------------------------------------------------------------------------
_C.DATASETS = CN()
_C.DATASETS.TRAIN = ()
_C.DATASETS.TEST = ()
_C.DATASETS.DATASET_CLASS = ""
_C.DATASETS.DATASET_ARGS = CN()
_C.DATASETS.DATASET_ARGS.LOAD_EMBEDDINGS = False
_C.DATASETS.DATASET_ARGS.EMB_KEY = "GloVE"
_C.DATASETS.DATASET_ARGS.EMB_DIM = 300
_C.DATASETS.DATASET_ARGS.MULTI_LABEL_MODE = False

# ---------------------------------------------------------------------------
# DATALOADER
# ---------------------------------------------------------------------------
_C.DATALOADER = CN()
_C.DATALOADER.NUM_WORKERS = 4
_C.DATALOADER.SIZE_DIVISIBILITY = 0
_C.DATALOADER.ASPECT_RATIO_GROUPING = True
# Group train batches by TARGET IMAGE BUCKET (finer than the
# reference's binary portrait/landscape _quantize([1]) grouping,
# data/build.py:71-113): batches become bucket-homogeneous so per-batch
# padding is the image's own bucket, not the widest member's.  Falls
# back to binary aspect grouping when off or when TPU.IMAGE_BUCKETS is
# empty.  (TPU-added key.)
_C.DATALOADER.GROUP_BY_BUCKET = True
_C.DATALOADER.DROP_LAST = False
# grain-based pipeline (deterministic shuffle/shard + checkpointable
# iterator state); False = thread-pool PrefetchingLoader.  The threaded
# loader is the production default: it resumes via the reference's own
# start_iter semantics with no per-record pipeline overhead; flip to
# True for bitwise-reproducible, mid-epoch-resumable input streams
# (docs/design.md section 9 has the full trade-off; both paths are
# CLI-resume-tested in tests/test_cli_resume.py)
_C.DATALOADER.USE_GRAIN = False
_C.DATALOADER.GRAIN_SEED = 0

# ---------------------------------------------------------------------------
# BACKBONE
# ---------------------------------------------------------------------------
_C.MODEL.BACKBONE = CN()
_C.MODEL.BACKBONE.CONV_BODY = "R-50-C4"
_C.MODEL.BACKBONE.FREEZE_CONV_BODY_AT = 2

_C.MODEL.LANGUAGE_BACKBONE = CN()
_C.MODEL.LANGUAGE_BACKBONE.TYPE = "BERT-Base"
_C.MODEL.LANGUAGE_BACKBONE.FREEZE = True
_C.MODEL.LANGUAGE_BACKBONE.EMBEDDING_PATH = ""
_C.MODEL.LANGUAGE_BACKBONE.ADD_POSITION_EMBEDDING = False
_C.MODEL.LANGUAGE_BACKBONE.FT_EMB = False

# ---------------------------------------------------------------------------
# MMSS (multimedia self-supervised grounding) heads
# ---------------------------------------------------------------------------
_C.MODEL.MMSS_HEAD = CN()
_C.MODEL.MMSS_HEAD.TYPES = ("GroundingHead",)
_C.MODEL.MMSS_HEAD.DEFAULT_HEAD = "GroundingHead"
_C.MODEL.MMSS_HEAD.TIE_VL_PROJECTION_WEIGHTS = False
_C.MODEL.MMSS_HEAD.SPATIAL_DROPOUT = -1

_C.MODEL.MMSS_HEAD.GROUNDING = CN()
_C.MODEL.MMSS_HEAD.GROUNDING.LOCAL_METRIC = "dot"
_C.MODEL.MMSS_HEAD.GROUNDING.GLOBAL_METRIC = "aligned_local"
_C.MODEL.MMSS_HEAD.GROUNDING.ALIGNMENT = "hardmax"
_C.MODEL.MMSS_HEAD.GROUNDING.ALIGNMENT_TEMPERATURE = 1.0
_C.MODEL.MMSS_HEAD.GROUNDING.LOSS = "matching"
_C.MODEL.MMSS_HEAD.GROUNDING.NEGATIVE_MINING = "random"
_C.MODEL.MMSS_HEAD.GROUNDING.TRIPLET_MARGIN = 1.0
_C.MODEL.MMSS_HEAD.GROUNDING.ALIGN_WORDS_TO_REGIONS = True
_C.MODEL.MMSS_HEAD.GROUNDING.ALIGN_REGIONS_TO_WORDS = True

_C.MODEL.MMSS_HEAD.TRANSFORMER = CN()
_C.MODEL.MMSS_HEAD.TRANSFORMER.MASKED_LANGUAGE_MODELING = False
_C.MODEL.MMSS_HEAD.TRANSFORMER.MASKED_LANGUAGE_MODELING_PROB = 0.15
_C.MODEL.MMSS_HEAD.TRANSFORMER.MASKED_LANGUAGE_MODELING_PROB_MASK = 0.9
_C.MODEL.MMSS_HEAD.TRANSFORMER.MASKED_LANGUAGE_MODELING_PROB_NOISE = 0.0
_C.MODEL.MMSS_HEAD.TRANSFORMER.MASKED_LANGUAGE_MODELING_VALIDATION = True
_C.MODEL.MMSS_HEAD.TRANSFORMER.MASKED_VISUAL_MODELING = False
_C.MODEL.MMSS_HEAD.TRANSFORMER.MVM_LOSS = ""
_C.MODEL.MMSS_HEAD.TRANSFORMER.MVM_LOSS_NUM_NEGATIVE = 128
_C.MODEL.MMSS_HEAD.TRANSFORMER.MMM_LOSS = ""
_C.MODEL.MMSS_HEAD.TRANSFORMER.BERT_CONFIG = CN()
_C.MODEL.MMSS_HEAD.TRANSFORMER.BERT_CONFIG.vocab_size = 30522
_C.MODEL.MMSS_HEAD.TRANSFORMER.BERT_CONFIG.hidden_size = 768
_C.MODEL.MMSS_HEAD.TRANSFORMER.BERT_CONFIG.num_hidden_layers = 12
_C.MODEL.MMSS_HEAD.TRANSFORMER.BERT_CONFIG.num_attention_heads = 12
_C.MODEL.MMSS_HEAD.TRANSFORMER.BERT_CONFIG.intermediate_size = 3072
_C.MODEL.MMSS_HEAD.TRANSFORMER.BERT_CONFIG.hidden_act = "gelu"
_C.MODEL.MMSS_HEAD.TRANSFORMER.BERT_CONFIG.hidden_dropout_prob = 0.1
_C.MODEL.MMSS_HEAD.TRANSFORMER.BERT_CONFIG.attention_probs_dropout_prob = 0.1
_C.MODEL.MMSS_HEAD.TRANSFORMER.BERT_CONFIG.max_position_embeddings = 512
_C.MODEL.MMSS_HEAD.TRANSFORMER.BERT_CONFIG.type_vocab_size = 2
_C.MODEL.MMSS_HEAD.TRANSFORMER.BERT_CONFIG.initializer_range = 0.02
_C.MODEL.MMSS_HEAD.TRANSFORMER.BERT_CONFIG.layer_norm_eps = 1e-12
_C.MODEL.MMSS_HEAD.TRANSFORMER.BERT_CONFIG.pad_token_id = 0
_C.MODEL.MMSS_HEAD.TRANSFORMER.BERT_CONFIG.gradient_checkpointing = False

# ---------------------------------------------------------------------------
# FPN / GroupNorm
# ---------------------------------------------------------------------------
# FBNet mobile backbone (reference defaults.py MODEL.FBNET)
_C.MODEL.FBNET = CN()
_C.MODEL.FBNET.ARCH = "default"
_C.MODEL.FBNET.SCALE_FACTOR = 1.0
_C.MODEL.FBNET.WIDTH_DIVISOR = 1
_C.MODEL.FBNET.BN_TYPE = "bn"
_C.MODEL.FBNET.DW_CONV_SKIP_BN = True
_C.MODEL.FBNET.DW_CONV_SKIP_RELU = True
_C.MODEL.FBNET.ARCH_DEF = ""
# FBNet det/kpts/mask head stages + RPN head blocks: accepted for YAML
# compatibility but inert — dead in every reference config (COVERAGE.md
# "deliberately not rebuilt"; reference defaults.py:110-128)
_C.MODEL.FBNET.RPN_HEAD_BLOCKS = 0
_C.MODEL.FBNET.RPN_BN_TYPE = ""
_C.MODEL.FBNET.DET_HEAD_BLOCKS = []
_C.MODEL.FBNET.DET_HEAD_STRIDE = 0
_C.MODEL.FBNET.DET_HEAD_LAST_SCALE = 1.0
_C.MODEL.FBNET.KPTS_HEAD_BLOCKS = []
_C.MODEL.FBNET.KPTS_HEAD_STRIDE = 0
_C.MODEL.FBNET.KPTS_HEAD_LAST_SCALE = 0.0
_C.MODEL.FBNET.MASK_HEAD_BLOCKS = []
_C.MODEL.FBNET.MASK_HEAD_STRIDE = 0
_C.MODEL.FBNET.MASK_HEAD_LAST_SCALE = 0.0

_C.MODEL.FPN = CN()
_C.MODEL.FPN.USE_GN = False
_C.MODEL.FPN.USE_RELU = False

_C.MODEL.GROUP_NORM = CN()
_C.MODEL.GROUP_NORM.DIM_PER_GP = -1
_C.MODEL.GROUP_NORM.NUM_GROUPS = 32
_C.MODEL.GROUP_NORM.EPSILON = 1e-5

# ---------------------------------------------------------------------------
# RPN
# ---------------------------------------------------------------------------
_C.MODEL.RPN = CN()
_C.MODEL.RPN.USE_FPN = False
_C.MODEL.RPN.ANCHOR_SIZES = (32, 64, 128, 256, 512)
_C.MODEL.RPN.ANCHOR_STRIDE = (16,)
_C.MODEL.RPN.ASPECT_RATIOS = (0.5, 1.0, 2.0)
_C.MODEL.RPN.STRADDLE_THRESH = 0
_C.MODEL.RPN.FG_IOU_THRESHOLD = 0.7
_C.MODEL.RPN.BG_IOU_THRESHOLD = 0.3
_C.MODEL.RPN.BATCH_SIZE_PER_IMAGE = 256
_C.MODEL.RPN.POSITIVE_FRACTION = 0.5
_C.MODEL.RPN.PRE_NMS_TOP_N_TRAIN = 12000
_C.MODEL.RPN.PRE_NMS_TOP_N_TEST = 6000
_C.MODEL.RPN.POST_NMS_TOP_N_TRAIN = 2000
_C.MODEL.RPN.POST_NMS_TOP_N_TEST = 1000
_C.MODEL.RPN.NMS_THRESH = 0.7
_C.MODEL.RPN.MIN_SIZE = 0
_C.MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN = 2000
_C.MODEL.RPN.FPN_POST_NMS_TOP_N_TEST = 2000
_C.MODEL.RPN.FPN_POST_NMS_PER_BATCH = True
_C.MODEL.RPN.RPN_HEAD = "SingleConvRPNHead"
_C.MODEL.RPN.DONT_TRAIN = False

# ---------------------------------------------------------------------------
# ROI heads
# ---------------------------------------------------------------------------
_C.MODEL.ROI_HEADS = CN()
_C.MODEL.ROI_HEADS.USE_FPN = False
_C.MODEL.ROI_HEADS.FG_IOU_THRESHOLD = 0.5
_C.MODEL.ROI_HEADS.BG_IOU_THRESHOLD = 0.5
_C.MODEL.ROI_HEADS.BBOX_REG_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
_C.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 512
_C.MODEL.ROI_HEADS.POSITIVE_FRACTION = 0.25
_C.MODEL.ROI_HEADS.SCORE_THRESH = 0.05
_C.MODEL.ROI_HEADS.NMS = 0.5
_C.MODEL.ROI_HEADS.DETECTIONS_PER_IMG = 100

_C.MODEL.ROI_BOX_HEAD = CN()
_C.MODEL.ROI_BOX_HEAD.FEATURE_EXTRACTOR = "ResNet50Conv5ROIFeatureExtractor"
_C.MODEL.ROI_BOX_HEAD.PREDICTOR = "FastRCNNPredictor"
_C.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION = 14
_C.MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO = 0
_C.MODEL.ROI_BOX_HEAD.POOLER_SCALES = (1.0 / 16,)
_C.MODEL.ROI_BOX_HEAD.NUM_CLASSES = 81
_C.MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM = 1024
_C.MODEL.ROI_BOX_HEAD.USE_GN = False
_C.MODEL.ROI_BOX_HEAD.DILATION = 1
_C.MODEL.ROI_BOX_HEAD.CONV_HEAD_DIM = 256
_C.MODEL.ROI_BOX_HEAD.NUM_STACKED_CONVS = 4
_C.MODEL.ROI_BOX_HEAD.EMB_DIM = 300
_C.MODEL.ROI_BOX_HEAD.EMBEDDING_BASED = False
_C.MODEL.ROI_BOX_HEAD.LOSS_WEIGHT_BACKGROUND = 1.0
_C.MODEL.ROI_BOX_HEAD.FREEZE_EMB_PRED = False
_C.MODEL.ROI_BOX_HEAD.FREEZE_FEATURE_EXTRACTOR = False
_C.MODEL.ROI_BOX_HEAD.WSDDN = False

_C.MODEL.ROI_MASK_HEAD = CN()
_C.MODEL.ROI_MASK_HEAD.FEATURE_EXTRACTOR = "ResNet50Conv5ROIFeatureExtractor"
_C.MODEL.ROI_MASK_HEAD.PREDICTOR = "MaskRCNNC4Predictor"
_C.MODEL.ROI_MASK_HEAD.POOLER_RESOLUTION = 14
_C.MODEL.ROI_MASK_HEAD.POOLER_SAMPLING_RATIO = 0
_C.MODEL.ROI_MASK_HEAD.POOLER_SCALES = (1.0 / 16,)
_C.MODEL.ROI_MASK_HEAD.MLP_HEAD_DIM = 1024
_C.MODEL.ROI_MASK_HEAD.CONV_LAYERS = (256, 256, 256, 256)
_C.MODEL.ROI_MASK_HEAD.RESOLUTION = 14
_C.MODEL.ROI_MASK_HEAD.SHARE_BOX_FEATURE_EXTRACTOR = True
_C.MODEL.ROI_MASK_HEAD.POSTPROCESS_MASKS = False
_C.MODEL.ROI_MASK_HEAD.POSTPROCESS_MASKS_THRESHOLD = 0.5
_C.MODEL.ROI_MASK_HEAD.DILATION = 1
_C.MODEL.ROI_MASK_HEAD.USE_GN = False
# Uncertainty estimator for the reparameterized mask loss (TPU-added
# keys; the reference hardcodes n_samples=1 sampled-BCE,
# roi_mask_predictors.py:47, mask_head/loss.py:117-123):
#   "sampled_bce" — mean BCE over sampled logits mu + eps*sigma
#     (reference parity).  By Jensen this penalizes sigma everywhere
#     (E[BCE(mu+eps*sigma)] >= BCE(mu)), so the learned sigma SHRINKS
#     fastest at ambiguous/noisy pixels — measured in
#     tools/ablate_st.py; the adaptive weight 0.01/avg_uncertain then
#     behaves as a rising anneal, not per-batch noise discrimination.
#   "logmeanexp" — Kendall & Gal loss attenuation,
#     -log((1/T) sum_t exp(-BCE_t)): lucky samples dominate the inner
#     mean, so sigma GROWS at confidently-contradicted (noisy-label)
#     pixels, realizing the paper's described behavior.  Identical to
#     "sampled_bce" at UNCERTAINTY_SAMPLES=1.
_C.MODEL.ROI_MASK_HEAD.UNCERTAINTY_ESTIMATOR = "sampled_bce"
_C.MODEL.ROI_MASK_HEAD.UNCERTAINTY_SAMPLES = 1
# Upper bound on the predicted noise sigma (0.0 = unbounded, reference
# parity).  Under "sampled_bce" Jensen pressure keeps sigma small and no
# bound is needed; under "logmeanexp" sigma is REWARDED at contradicted
# pixels and, with a 50% label-noise rate, runs away until the mask head
# stops learning (measured e2e in tools/ablate_st_e2e.py: unbounded
# logmeanexp diverges, sigma_max=4 realizes the claimed robustness).
_C.MODEL.ROI_MASK_HEAD.UNCERTAINTY_SIGMA_MAX = 0.0

_C.MODEL.ROI_KEYPOINT_HEAD = CN()
_C.MODEL.ROI_KEYPOINT_HEAD.FEATURE_EXTRACTOR = "KeypointRCNNFeatureExtractor"
_C.MODEL.ROI_KEYPOINT_HEAD.PREDICTOR = "KeypointRCNNPredictor"
_C.MODEL.ROI_KEYPOINT_HEAD.POOLER_RESOLUTION = 14
_C.MODEL.ROI_KEYPOINT_HEAD.POOLER_SAMPLING_RATIO = 0
_C.MODEL.ROI_KEYPOINT_HEAD.POOLER_SCALES = (1.0 / 16,)
_C.MODEL.ROI_KEYPOINT_HEAD.MLP_HEAD_DIM = 1024
_C.MODEL.ROI_KEYPOINT_HEAD.CONV_LAYERS = tuple(512 for _ in range(8))
_C.MODEL.ROI_KEYPOINT_HEAD.RESOLUTION = 14
_C.MODEL.ROI_KEYPOINT_HEAD.NUM_CLASSES = 17
_C.MODEL.ROI_KEYPOINT_HEAD.SHARE_BOX_FEATURE_EXTRACTOR = True

# ---------------------------------------------------------------------------
# ResNets
# ---------------------------------------------------------------------------
_C.MODEL.RESNETS = CN()
_C.MODEL.RESNETS.NUM_GROUPS = 1
_C.MODEL.RESNETS.WIDTH_PER_GROUP = 64
_C.MODEL.RESNETS.STRIDE_IN_1X1 = True
_C.MODEL.RESNETS.TRANS_FUNC = "BottleneckWithFixedBatchNorm"
_C.MODEL.RESNETS.STEM_FUNC = "StemWithFixedBatchNorm"
_C.MODEL.RESNETS.RES5_DILATION = 1
_C.MODEL.RESNETS.BACKBONE_OUT_CHANNELS = 256 * 4
_C.MODEL.RESNETS.RES2_OUT_CHANNELS = 256
_C.MODEL.RESNETS.STEM_OUT_CHANNELS = 64
_C.MODEL.RESNETS.STAGE_WITH_DCN = (False, False, False, False)
_C.MODEL.RESNETS.WITH_MODULATED_DCN = False
_C.MODEL.RESNETS.DEFORMABLE_GROUPS = 1
# Declared by the reference but never read anywhere in its code
# (reference defaults.py:380) — accepted for YAML compatibility, inert.
_C.MODEL.RESNETS.DAT_TESTING = -1

# ---------------------------------------------------------------------------
# RetinaNet (parity; not used by shipped configs)
# ---------------------------------------------------------------------------
_C.MODEL.RETINANET = CN()
_C.MODEL.RETINANET.NUM_CLASSES = 81
_C.MODEL.RETINANET.ANCHOR_SIZES = (32, 64, 128, 256, 512)
_C.MODEL.RETINANET.ASPECT_RATIOS = (0.5, 1.0, 2.0)
_C.MODEL.RETINANET.ANCHOR_STRIDES = (8, 16, 32, 64, 128)
_C.MODEL.RETINANET.STRADDLE_THRESH = 0
_C.MODEL.RETINANET.OCTAVE = 2.0
_C.MODEL.RETINANET.SCALES_PER_OCTAVE = 3
_C.MODEL.RETINANET.USE_C5 = True
_C.MODEL.RETINANET.NUM_CONVS = 4
_C.MODEL.RETINANET.BBOX_REG_WEIGHT = 4.0
_C.MODEL.RETINANET.BBOX_REG_BETA = 0.11
_C.MODEL.RETINANET.PRE_NMS_TOP_N = 1000
_C.MODEL.RETINANET.FG_IOU_THRESHOLD = 0.5
_C.MODEL.RETINANET.BG_IOU_THRESHOLD = 0.4
_C.MODEL.RETINANET.LOSS_ALPHA = 0.25
_C.MODEL.RETINANET.LOSS_GAMMA = 2.0
_C.MODEL.RETINANET.PRIOR_PROB = 0.01
_C.MODEL.RETINANET.INFERENCE_TH = 0.05
_C.MODEL.RETINANET.NMS_TH = 0.4

# ---------------------------------------------------------------------------
# SOLVER
# ---------------------------------------------------------------------------
_C.SOLVER = CN()
_C.SOLVER.MAX_ITER = 40000
_C.SOLVER.BASE_LR = 0.001
_C.SOLVER.BIAS_LR_FACTOR = 2
_C.SOLVER.MOMENTUM = 0.9
_C.SOLVER.WEIGHT_DECAY = 0.0005
_C.SOLVER.WEIGHT_DECAY_BIAS = 0
_C.SOLVER.GAMMA = 0.1
_C.SOLVER.STEPS = (30000,)
_C.SOLVER.WARMUP_FACTOR = 1.0 / 3
_C.SOLVER.WARMUP_ITERS = 500
_C.SOLVER.WARMUP_METHOD = "linear"
_C.SOLVER.CHECKPOINT_PERIOD = 10000
_C.SOLVER.TEST_PERIOD = 10000
_C.SOLVER.LOG_PERIOD = 20
_C.SOLVER.IMS_PER_BATCH = 16
_C.SOLVER.CLIP_GRAD_NORM_AT = -1.0
_C.SOLVER.GRADIENT_ACCUMULATION_STEPS = 1
_C.SOLVER.USE_TRAIN_MODE_FOR_VALIDATION_LOSS = True
_C.SOLVER.SKIP_VAL_LOSS = False
_C.SOLVER.UNCERTAINTY_LR_FACTOR = 1.0
# Abort training when the logged total loss goes non-finite (TPU-native
# extension of the reference's MMSS NaN raise, mmss_gcnn.py:116-120 —
# there, only the MMSS forward raises; here every architecture trips,
# at the LOG_PERIOD metric fetch so no per-step device sync is added).
_C.SOLVER.ABORT_ON_NON_FINITE = True

# ---------------------------------------------------------------------------
# TEST
# ---------------------------------------------------------------------------
_C.TEST = CN()
_C.TEST.EXPECTED_RESULTS = ()
_C.TEST.EXPECTED_RESULTS_SIGMA_TOL = 4
_C.TEST.IMS_PER_BATCH = 8
_C.TEST.DETECTIONS_PER_IMG = 100
_C.TEST.BBOX_AUG = CN()
_C.TEST.BBOX_AUG.ENABLED = False
_C.TEST.BBOX_AUG.H_FLIP = False
_C.TEST.BBOX_AUG.SCALES = ()
_C.TEST.BBOX_AUG.MAX_SIZE = 4000
_C.TEST.BBOX_AUG.SCALE_H_FLIP = False
_C.TEST.DO_EVAL = True

# ---------------------------------------------------------------------------
# Misc
# ---------------------------------------------------------------------------
_C.OUTPUT_DIR = "."
_C.PATHS_CATALOG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "data",
    "paths_catalog.py",
)
_C.DTYPE = "float32"
_C.AMP_VERBOSE = False

# ---------------------------------------------------------------------------
# TPU: static shape caps + mesh (new in this framework)
# ---------------------------------------------------------------------------
# XLA compiles one program per distinct shape; these caps make every
# intermediate statically shaped.  Invalid slots are tracked by boolean
# masks end-to-end (see core/boxes.py).
_C.TPU = CN()
# Maximum padded ground-truth instances per image.
_C.TPU.MAX_GT = 100
# Maximum caption tokens (BERT wordpieces) per image.
_C.TPU.MAX_CAP_TOKENS = 128
# Maximum caption noun phrases (pseudo-label words) per image.
_C.TPU.MAX_CAP_NOUNS = 32
# Compute dtype for conv/matmul heavy paths ("bfloat16" or "float32").
_C.TPU.COMPUTE_DTYPE = "float32"
# Image padding buckets (H, W) used by the host pipeline; every batch is
# padded to one of these so at most len(buckets) programs are compiled.
# Static padded batch shapes.  A LADDER of rungs per orientation:
# 4:3-class images (the bulk of COCO) land on the 1088 rungs, 3:2/16:9
# on 1216, panoramic on 1333 — with DATALOADER.GROUP_BY_BUCKET batches
# are bucket-homogeneous, so the measured 15.2% padding tax of the
# 3-bucket set (BENCH_NOTES round4_bucket_mix) collapses to ~2-4%.
# Unused rungs never compile (XLA compiles per encountered shape);
# each used rung costs one compile, cached persistently.
_C.TPU.IMAGE_BUCKETS = (
    (800, 1088),
    (800, 1216),
    (800, 1333),
    (1088, 800),
    (1216, 800),
    (1333, 800),
    (1024, 1024),
)
# Device mesh axis names/sizes; data parallel by default ("-1" = all devices).
_C.TPU.MESH_AXES = ("data",)
_C.TPU.MESH_SHAPE = (-1,)
# NMS tile size for the tiled exact-greedy TPU NMS kernel.
_C.TPU.NMS_TILE = 512
# Mask head trains on at most this many sampled rois per image
# (positives come first in the sampled layout, so this covers all
# positives whenever #pos <= cap; mirrors keep_only_positive_boxes).
_C.TPU.MASK_POS_CAP = 256
# pool only the bins a stride_in_1x1 stride-2 C5 head actually reads
# (even 7x7 of the 14x14 grid) — bit-identical, 4x less pooling work
_C.TPU.POOL_PRESTRIDE = True
# exact space-to-depth stem rewrite (7x7/s2 conv -> 4x4/s1 on a 2x2
# space-to-depth input, models/resnet.py:s2d_stem_kernel): same
# function and param tree, better MXU utilization when FREEZE_AT=0
# puts the stem backward on the clock (MMSS)
_C.TPU.S2D_STEM = False


def get_default_cfg() -> CN:
    return _C.clone()
