#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure raises and exits non-zero):

1. build     -- compile every CUDA kernel from ``csrc/`` (one nvcc per source,
                all started together) and print what ``ptxas -v`` says of each
                kernel: registers, shared memory, spills.
2. nms       -- the NMS kernels against their plain PyTorch version at the main
                path's shapes (RPN: 8 x 6000 -> 1000 at IoU 0.7; the training
                RPN selector: 8 x 12000 -> 2000 at IoU 0.7; detections: 8 x
                1000, 65 labels -> 100 at IoU 0.5), with overlapping boxes,
                tied scores and invalid slots.  Indices and masks must be equal.
                The whole function is timed with CUDA events, its enqueue time
                with the host clock, and the mask and scan kernels' own device
                times come from the profiler.  A third case, rpn_dense, has
                boxes so tightly clustered that fewer than 1000 survive: the
                scan runs through every block.  It is also timed with
                max_outputs = N on the same inputs, which keeps the same boxes
                in one column band, and alternating with the rpn inputs, so
                that each call's band schedule is sized from the other
                traffic's stop point.
3. roi_align -- the RoIAlign kernel against its plain version on [8, 50, 84,
                1024] features with 1000, 512 (a training branch's sampled
                rois), 100 or 32 (the teacher's pseudo boxes) rois per image, in bfloat16
                (the main path's dtype) and float32, bin_stride 1 and 2; the
                result has the features' dtype.  Max abs diff <= 1e-5 * max|F|
                for float32 (only the summation order differs), plus one
                bfloat16 ulp of the result for bfloat16 (the two sums may round
                to neighbouring bfloat16 values).
4. small     -- a narrow float32 student-teacher model on 2 x 64 x 64 images:
                the CUDA run against the CPU run (the plain versions, which the
                CPU tests hold against the JAX package).
5. serving   -- a Predictor on configs/coco_cap_det/
                student_teacher_mask_rcnn_uncertainty.yaml at full width in
                bfloat16, seeded weights loaded through bridge.py, a 66 x 768
                class table, 3 batches of 8 uint8 images at 800 x 1333.  Every
                kernel launch of the first batch is held against the plain
                version on the same inputs; launch counts are read over the 3
                batches.
6. profile   -- one more serving batch under torch.profiler: device time by
                kernel group, the largest kernels, each copy and cast, and the
                device's busy share.
7. small_train -- a narrow float32 student-teacher Trainer on 2 x 64 x 64
                images: one CUDA step against one CPU step on the same weights,
                batch and draws (losses and the updated student parameters).
8. train     -- a Trainer on the same config at full width in bfloat16, the
                serving weights, 3 SGD steps on batches of 8 at 800 x 1333 in
                the collate format: up to 100 gt boxes with 28 x 28 masks per
                image, 32 caption nouns, the 66 x 768 class table and a 1203 x
                768 LVIS table; both branches on every image.  Every kernel
                launch of the first step is held against the plain version;
                launch counts are read over the 3 steps.  Every loss and the
                gradient norm must be finite, the student's parameters must
                change and the frozen ones (backbone, rpn_head, teacher, bert)
                must not.  Step latency, images/s, steady peak memory and the
                host syncs of a step, then one more step under
                torch.profiler, grouped as in phase 6.
9. roi_align_backward -- the RoIAlign backward kernels (a plan of each
                roi's tap lists, then tiles of dF summed in shared memory)
                against the plain version's autograd gradient on the same [8,
                50, 84, 1024] map shape, rois and a seeded cotangent: bfloat16
                with 512 (the teacher's sampled rois, the main case) and 1000
                rois per image at bin_stride 2, float32 with 512 at bin_stride 1
                and 2.  Max abs diff <= 1e-5 * max|dF_plain| for float32 (the
                kernel sums in another order than the plain contraction), plus
                one bfloat16 ulp of the result for bfloat16.  Time, bound, plain
                time, the plan and tile kernels' device times, the rate of the
                float32 adds, and the main case timed at a few other tiles of
                dF.  After phase 12, one more case: the first teacher step's
                own cotangent and sampled rois (which overlap far more than the
                uniform rois), checked and timed the same way.
10. small_teacher_train -- a narrow float32 teacher (GeneralizedRCNN on
                configs/coco_cap_det/zeroshot_mask.yaml) Trainer on 2 x 64 x 64
                images: one CUDA step against one CPU step on the same weights,
                batch and draws (losses, and the update of every trainable
                parameter, layer2 and layer3 included).
11. teacher_serving -- a Predictor on zeroshot_mask.yaml at full width in
                bfloat16, seeded weights through bridge.py, a 49 x 768 class
                table (passed raw, as the teacher takes it), 3 batches of 8
                uint8 images at 800 x 1333; every launch of the first batch
                held against the plain version.
12. teacher_train -- a Trainer on zeroshot_mask.yaml at full width in
                bfloat16, 3 SGD steps of 8 at 800 x 1333 with up to 100 gt boxes
                and 28 x 28 masks per image.  Every launch of the first step is
                held against the plain version: the NMS (12000 -> 2000), the
                RoIAlign forward (8 x 512) and the RoIAlign backward.  Losses
                and the gradient norm finite; layer2, layer3, rpn_head,
                roi_extractor, bbox_pred and mask_predictor change, the stem,
                layer1 and emb_pred do not.  Step latency, images/s, steady
                peak memory, host syncs of a step and one profiled step.  Then
                the backward on that step's rois (phase 9).
13. small_mmss_train -- a narrow float32 MMSS-GCNN Trainer (configs/coco_cap_det/
                mmss.yaml's optimizer; R-50-C5 at stem 8, res2 16; a 2-layer
                BERT of width 64; a 2-layer transformer head) on 3 x 128 x 128
                images with 12-token captions: one CUDA step against one CPU
                step on the same weights, batch and draws (losses, gradient
                norm, every trainable parameter's update; the frozen BERT bit
                for bit).
14. mmss_train -- a Trainer on mmss.yaml at full width in bfloat16 (R-50-C5
                with the stem training, the frozen 12-layer BERT-Base over
                30522 tokens, the tied v2l projection, the grounding head and
                the 6-layer transformer head with MLM and the B^2 matching
                loss; SPATIAL_DROPOUT 100), seeded weights, 3 SGD steps on
                batches of 8 at 800 x 1333 with captions padded to 128
                tokens (SOLVER.IMS_PER_BATCH 8, the per-device share of the
                config's 64; MODEL.WEIGHT "": no ImageNet weights ship).
                Losses and the gradient norm finite; the trunk, v2l and the
                transformer head change, the BERT and every buffer do not; no
                NMS or RoIAlign launch.  Step latency, images/s, steady peak
                memory, host syncs of a step, one profiled step grouped as
                conv, matmul, softmax, layer norm, elementwise ..., and the
                device time of the step's attention blocks (fwd + bwd), each
                profiled alone at its shapes.
15. eval     -- the port's evaluation entry point, ``tools/test_net.main``, on
                student_teacher_mask_rcnn_uncertainty.yaml at full width in
                bfloat16 (seeded weights) over the config's three test datasets
                of a synthetic COCO zero-shot tree written under
                ``build/synth_coco`` by ``tools/synth_coco.py`` (JPEG, polygons):
                48 seen and 17 unseen classes with 768-d embeddings, COCO's
                image sizes, 1-8 instances an image, 20 val images and 8 train
                images.  Its seed is chosen so that each dataset's three
                batches are a full batch on a ladder rung (800 x 1088), a full
                mixed batch on the ceil-to-64 fallback (1088 x 1216) and a
                ragged batch of 4 on a rung (800 x 1216).  The ``host_libs``
                line prints what the host code finds (PIL, cv2, libjpeg, g++).
                Every kernel launch of each dataset's first batch and of every
                batch shape's first batch is held against the plain version,
                and the run must have checked a ragged batch and a batch on a
                rung; each batch must have the bucket ``select_bucket`` gives
                its images, every image a result, and every metric must be
                finite (a class without ground truth has a NaN AP50, as in the
                JAX evaluator).  Prints throughput end to end and steady, the
                Predictor calls' seconds an image and their share of the wall
                time, the evaluator's seconds and the launches per batch; then one batch
                of the train loader (COCOCapDetDataset), checked for shape and
                dtype.
16. train_net -- the port's training entry point, ``tools/train_net.main``, in
                process at full width in bfloat16 with batches of 8 on the eval
                phase's tree (its 8 train JPEGs; aspect-ratio grouping off, since
                no orientation group of the 8 fills a batch), through the
                paper's three stages: MMSS pretraining (mmss.yaml, 3 steps,
                checkpoints at 2 and 3, the validation-loss pass at 2 over
                coco_captions_val, whose captions file the phase writes into
                the tree; no kernel launch); the teacher from the MMSS
                OUTPUT_DIR with LOAD_EMB_PRED_FROM_MMSS_HEAD (zeroshot_mask.yaml,
                3 steps, a checkpoint every 2: the imported leaf count, and the
                trunk, the C5 layer4 on the RoI extractor and v2l on emb_pred
                equal to the MMSS checkpoint's bit for bit), every
                kernel launch of its first step held against the plain version
                and the launches of every step counted; a relaunch with
                ``MODEL.LOAD_TRAINER_STATE`` that resumes at 3 and adds step 4
                only; a relaunch that trains nothing and writes nothing; then
                the student-teacher model from the teacher's OUTPUT_DIR
                (``MODEL.WEIGHT``) with its BERT table from the MMSS OUTPUT_DIR
                (``MODEL.LANGUAGE_WEIGHT``), 2 steps with the in-training evaluation and
                the final test on coco_generalized_zeroshot_val: its teacher
                bundle equal to the teacher checkpoint's, bit for bit, and every
                metric finite; then ``tools/test_net.main --ckpt`` on the
                student's checkpoint, whose metrics must equal the final test's.
                Prints each run's sustained s/it and data-wait share beside the
                ``Trainer.step`` latency of the train phases, the checkpoints'
                bytes and save, stall and load seconds, the LVIS table's seconds
                and each run's peak memory; deletes ``build/train_out``.
17. openimages -- the Conceptual Captions -> OpenImages pair
                (configs/conceptual_openimages_det/) through the port's entry
                points at full width in bfloat16 with batches of 8, on a tree
                that ``tools/synth_openimages.py`` writes under
                ``build/synth_openimages``: 16 OpenImages train and 16 val
                JPEGs at 1024 x 768 and 768 x 1024, 200 seen and 300 unseen
                classes with 768-d embeddings, long-tailed boxes, PNG and
                inline masks, an image-level CSV that leaves a class of each
                image out, and 32 Conceptual JPEGs at 640 x 480 and 480 x 640
                whose captions hold LVIS nouns.  ``train_net`` trains the
                teacher (zeroshot_mask.yaml, 201 classes) 3 steps through the
                repeat-factor sampler, its first step's launches checked, then
                the student (NUM_CLASSES -1) from the teacher's OUTPUT_DIR 3
                steps on the mixture, every launch checked: a uint8 batch of
                detection and caption images, finite losses,
                loss_classifier_pseudo above 0 on each batch with caption
                images, the teacher bundle equal to the teacher checkpoint's.
                Then ``test_net`` on openimages_zeroshot_val (501 classes) with
                the student's checkpoint, plain (first batch checked, the
                labelled detection NMS among its launches) and with
                TEST.BBOX_AUG at scales 800, 600 and 1000, each flipped (six
                batch-1 calls an image; each new shape's first launches and
                every merge's NMS checked): every image a result, at most 100,
                every metric finite, the image-level filter dropping
                detections.  The new launch shapes (the detection NMS over 500
                labels, the merge's NMS, the pseudo boxes' pooling on caption
                images) are timed on their captured inputs.
18. supervised -- the class-specific R-50-C4 detectors over the default
                config (no YAML; ``cls_score`` over the classes, a box and a mask
                channel per class, no class table) and the top-k teachers, at full
                width in bfloat16: (a) maskrcnn_benchmark's COCO Mask R-CNN (81
                classes, ``MODEL.MASK_ON``) through ``train_net``, 3 steps of 8 on
                the eval tree's 8 seen-split train JPEGs (aspect-ratio grouping
                off), every launch of the first step checked, then ``test_net
                --ckpt`` on coco_not_zeroshot_val (20 images; each batch shape's
                first batch checked): every image a result, every metric finite
                (NaN AP50 only without ground truth), a checked detection NMS
                with one roi's candidates under two labels on different boxes;
                (b) the VOC Faster R-CNN (21 classes, RPN 6000 -> 300 at test,
                anchors 128-512) at batch 1 on a ``tools/synth_voc.py`` tree under
                ``build/synth_voc`` (8 train and 8 test JPEGs at 500 x 375, 375 x
                500 and 500 x 333, some objects difficult): 3 steps, the first
                checked, then ``test_net`` at batch 1, each shape's first call
                checked, both VOC metrics finite; (c) SoftTeacher and
                UnbiasedTeacher (the ST config), 2 ``Trainer`` steps each on phase
                8's batches from the same weights, the first step's launches
                checked: finite losses, and their ``loss_classifier_pseudo``
                differ.  Random weights put every class's probability near 1/C,
                under the 0.05 threshold: the runs set ``ROI_HEADS.SCORE_THRESH``
                0.0.  Each path's launches are counted from 0; the new launch
                shapes (the 81-class detection NMS, VOC's batch-1 NMS, RoIAlign
                and backward, the top-2 pseudo boxes' pooling) are timed on their
                captured inputs.  Deletes its outputs and the VOC tree.
19. fpn      -- the R-50-FPN body (config.R50_FPN_OPTS) over the teacher and
                student-teacher configs: serving, train steps, train_net
                (the teacher, then the student from it) and test_net, every
                first launch checked; the level-filtered RoIAlign launches
                and the per-level NMS shapes timed.
20. retinanet -- RetinaNet (config.RETINANET_OPTS over the supervised COCO
                setup, 81 classes, INFERENCE_TH 0 for the seeded weights) at
                full width in bfloat16: 3 serving batches of 8 at 800 x 1333
                (the detection NMS over 5 levels x 1000 candidates, 80
                labels, IoU 0.4 -> 100, checked on its first launch; what
                reaches it printed per image, label and level), the
                stable-sort top-k of P3's 8 x 12.0 M scores timed beside a
                keyed selection of the same order and torch.topk, 3
                Trainer steps (finite losses, the trunk from layer2 on, the
                FPN and the head change, the stem and layer1 do not; no
                kernel launch), the loss and the focal loss timed alone;
                train_net 3 steps, a resume to 4, test_net --ckpt on the
                eval tree's coco_not_zeroshot_val (box metrics only); then
                the RPN-only teacher (zeroshot_mask.yaml, MODEL.RPN_ONLY) on
                the C4 and the FPN body, 2 train_net steps each (the RPN
                losses alone) and test_net's box_proposal/AR_*@1000.
21. options  -- three detector options at full width in bfloat16: (a) the
                R-50-C5 teacher (zeroshot_mask.yaml, RES5_DILATION 2, the
                pooler at 1/16 emitting every bin from the 2048-channel
                map; the RPN conv 2048 -> 1024 and the RoI head's block-0
                downsample as JAX builds them), 3 serving batches of 8 at
                800 x 1333 (28 x 28 masks) and 3 Trainer steps (res3 to res5
                train: the backward runs into the C5 map); (b) the
                student-teacher model on the same body (its trunk undilated,
                as JAX's), 3 serving batches and 3 steps; (c) the keypoint
                R-CNN (config.R50_FPN_OPTS, KEYPOINT_ON, person and
                background, 17 keypoints, no masks) through train_net, 3
                steps of 8 on a tools/synth_coco_keypoints.py tree of 8
                train and 8 val JPEGs under build/synth_kp, then test_net
                --ckpt: every image a result with 17 keypoints, every metric
                finite, keypoints/AP among them; (d) WSDDN over
                zeroshot_mask.yaml without masks, 3 steps (every one of the
                8 x 2000 training proposals pooled, through the res5 head
                and the backward kernel) and 3 serving batches.  Every
                launch of each path's first batch or step is held against
                the plain version, each path's launches are counted from 0,
                losses are finite, trained parameters change and frozen ones
                stay bit-identical.  The new launch shapes (the WSDDN and
                keypoint detections' NMS, the forward and backward on the C5
                map and on WSDDN's proposals) are checked again and timed on
                their captured inputs.
22. st_options -- the student-teacher options and the teacher's pseudo-label
                methods at full width in bfloat16: (a) MODEL.EXEMPLARS_ENABLED,
                3 Trainer steps of 8 at 800 x 1333 on phase 8's batch shape
                (the table's valid slots and lambda_exemplar after each step;
                the first step's table update redone on the CPU: valid and
                quality equal, embeddings within 1e-6); (b)
                MODEL.LANGUAGE_BACKBONE.FT_EMB, 3 steps with the tokenized
                LVIS names in place of the table (the word table's gradient
                norm after each step, the step time beside phase 8's, the word
                table changed and finite); (c) both through train_net on the
                eval tree (2 steps, a save, a resume to 3 whose restored table
                equals the saved one bit for bit) and test_net --ckpt, every
                metric finite; (d) the teacher's run_teacher_pseudo_branch and
                predict_masks_for_boxes on a serving batch of 8 (the masks of
                the 32 best regressed boxes an image); (e) build_backbone's
                plain R-50-C4, R-50-C4 with GroupNorm, R-50-C4 with modulated
                DCN in res4 and FBNet, forward on 8 x 800 x 1333 in bfloat16
                (ms and peak memory), one res4 block's deformable 3x3 conv
                beside cuDNN's, and deform_conv2d on the card against the CPU
                at 2 x 64 x 64 x 64 in float32, within 1e-5 of max|out|.  Every launch
                of each path's first step or batch held against its plain
                version; each path's launches counted from 0.
One line gives the seconds each phase from 7 on took.  The per-kernel line
gives, beside each kernel's launches on the earlier paths, its launches on
the MMSS paths (phase 14 and the MMSS stage of phase 16): 0, on the
OpenImages paths of phase 17, on the supervised paths of phase 18, on the
FPN, RetinaNet and RPN-only paths of phases 19 and 20, on the options'
paths of phase 21 and on the student-teacher options' paths of phase 22.

Then the card's name and power limit, the per-kernel JSON line, and the last
line ``{"ok": true, "device": {...}}``.  Exits non-zero without a result when
no CUDA device is present or when run outside a checkout of the repository.
"""

import functools
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
CONFIG = "configs/coco_cap_det/student_teacher_mask_rcnn_uncertainty.yaml"
EMB_PRED_STD = 0.01
# the main path's shapes at the (800, 1333) bucket with TEST.IMS_PER_BATCH 8
NMS_CASES = (  # name, boxes per image, max_outputs, IoU, labels (0 = none), boxes
    ("rpn", 6000, 1000, 0.7, 0, "spread"),
    ("detections", 1000, 100, 0.5, 65, "spread"),
    ("rpn_dense", 6000, 1000, 0.7, 0, "dense"),
    ("rpn_train", 12000, 2000, 0.7, 0, "spread"),
)
ROI_FEATURES = (8, 50, 84, 1024)
F32, BF16 = torch.float32, torch.bfloat16
ROI_CASES = (  # rois per image, bin_stride, feature (and result) dtype
    (1000, 2, BF16), (512, 2, BF16), (100, 2, BF16), (32, 2, BF16),
    (1000, 1, F32), (1000, 2, F32), (100, 2, F32),
)
ROI_MAIN = (1000, 2, BF16)  # the proposals' pooling on the main path
ROI_TRAIN = ((512, 2, BF16), (32, 2, BF16))  # the training-only shapes
SERVING = dict(batches=3, batch=8, hw=(800, 1333), opts=())
TEACHER = "configs/coco_cap_det/zeroshot_mask.yaml"
TEACHER_CLASSES = 49  # the config's NUM_CLASSES: 48 seen COCO classes and the background
ROI_BWD_CASES = (  # rois per image, bin_stride, feature (and gradient) dtype
    (512, 2, BF16), (1000, 2, BF16), (512, 1, F32), (512, 2, F32),
)
ROI_BWD_MAIN = (512, 2, BF16)  # the teacher step's sampled rois
# tiles of dF (rows, columns, channels, slabs per CTA) the main case is
# also timed at, beside the default ops.roi_align.BACKWARD_TILE
ROI_BWD_TILES = ((4, 21, 256, 1), (4, 21, 256, 4), (2, 21, 256, 2), (2, 28, 256, 2), (4, 14, 256, 2),
                 (4, 28, 256, 2))
# the train step at the serving bucket with SOLVER.IMS_PER_BATCH 8
TRAIN = dict(steps=3, batch=8, hw=(800, 1333), max_gt=100, nouns=32, noun_tokens=8,
             lvis=1203, classes=66, opts=())
# the eval phase's synthetic tree and run; tools/synth_coco.py's seed 2
# with 20 val images gives batches at 800 x 1088 (8 images), 1088 x 1216
# (8, mixed orientations) and 800 x 1216 (4, ragged)
EVAL = dict(train=8, val=20, seed=2, opts=(), tree="build/synth_coco", out="build/eval_out",
            train_batch=2)
# the train_net phase: the eval phase's tree, batches of 8, outputs under
# build/train_out (deleted at the end of the phase; checkpoints are
# hundreds of MB)
TRAIN_NET = dict(out="build/train_out", dataset="coco_generalized_zeroshot_val",
                 opts=("SOLVER.IMS_PER_BATCH", 8, "DATALOADER.ASPECT_RATIO_GROUPING", False,
                       "SOLVER.LOG_PERIOD", 1))
# MMSS pretraining: configs/coco_cap_det/mmss.yaml at full width in
# bfloat16, the per-device share (8) of its 64-image batch, captions
# padded to TPU.MAX_CAP_TOKENS 128; no ImageNet weights ship
# the Conceptual Captions -> OpenImages pair on a tree written by
# tools/synth_openimages.py: 16 OpenImages train and 16 val JPEGs at 1024 x
# 768 and 768 x 1024, 32 Conceptual JPEGs at 640 x 480 and 480 x 640, 200
# seen and 300 unseen classes; batches of 8; test-time augmentation at the
# base scale and two more, each also flipped.  Outputs (checkpoints of
# hundreds of MB) and the tree are deleted at the end of the phase.
OI_TEACHER = "configs/conceptual_openimages_det/zeroshot_mask.yaml"
OI_STUDENT = "configs/conceptual_openimages_det/student_teacher_mask_rcnn_uncertainty.yaml"
OI_CLASSES = 501  # the val set's 200 seen and 300 unseen classes and the background
OPENIMAGES = dict(tree="build/synth_openimages", out="build/oi_out", train=16, val=16, captions=32, seed=0,
                  student_steps=3, scales=(600, 1000), opts=("SOLVER.IMS_PER_BATCH", 8, "SOLVER.LOG_PERIOD", 1))
# the class-specific R-50-C4 detectors over the defaults (no YAML) at
# full width in bfloat16: maskrcnn_benchmark's e2e_mask_rcnn_R_50_C4_1x
# (81 classes) on the eval tree's seen split, batches of 8, and
# pascal_voc/e2e_faster_rcnn_R_50_C4_1x_1_gpu_voc (21 classes) at batch 1
# on a tools/synth_voc.py tree of 8 train and 8 test JPEGs; random
# weights put every class's probability near 1/C, under the 0.05 score
# threshold, so the runs set it to 0.0 (a trained model fills the 1000
# candidates as this does).  Then SoftTeacher and UnbiasedTeacher steps on
# phase 8's batches.  Outputs and the VOC tree are deleted at the end.
SUPERVISED = dict(
    out="build/supervised_out", voc_tree="build/synth_voc", voc_train=8, voc_test=8, steps=3,
    baseline_steps=2,
    common=("TPU.COMPUTE_DTYPE", "bfloat16", "MODEL.ROI_HEADS.SCORE_THRESH", 0.0, "SOLVER.LOG_PERIOD", 1,
            "SOLVER.TEST_PERIOD", 0),
    coco_opts=("MODEL.MASK_ON", True, "DATASETS.TRAIN", ("coco_zeroshot_train",),
               "DATASETS.TEST", ("coco_not_zeroshot_val",), "SOLVER.IMS_PER_BATCH", 8,
               "TEST.IMS_PER_BATCH", 8, "SOLVER.BASE_LR", 0.01, "DATALOADER.ASPECT_RATIO_GROUPING", False),
    voc_opts=("MODEL.ROI_BOX_HEAD.NUM_CLASSES", 21, "MODEL.RPN.PRE_NMS_TOP_N_TEST", 6000,
              "MODEL.RPN.POST_NMS_TOP_N_TEST", 300, "MODEL.RPN.ANCHOR_SIZES", (128, 256, 512),
              "DATASETS.TRAIN", ("voc_2007_train",), "DATASETS.TEST", ("voc_2007_test",),
              "SOLVER.IMS_PER_BATCH", 1, "TEST.IMS_PER_BATCH", 1, "SOLVER.BASE_LR", 0.001),
)
MMSS_CONFIG = "configs/coco_cap_det/mmss.yaml"
MMSS = dict(steps=3, batch=8, hw=(800, 1333), tokens=128, opts=())
# what an MMSS step must change, and the frozen BERT it must not
MMSS_TRAINED = ("backbone.body.stem.", "backbone.body.layer1.", "backbone.body.layer4.", "v2l_projection.",
                "transformer_head.")
MMSS_FROZEN = ("language_backbone.",)
# trained, but its gradient is 0 (it shifts every pair's matching score
# alike, which the softmax ignores) and biases have no weight decay
MMSS_STILL = ("transformer_head.seq_relationship.bias",)
H100_BYTES_PER_S = 3.35e12
H100_F32_OPS_PER_S = 67e12
IOU_OPS = 16  # min/max, sub/add, mul, div and compare of one +1 IoU test


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def roi_err(out, ref, fmax, rows=1 << 14):
    """(max abs diff, largest excess of an element's diff over its limit:
    the check passes when it is <= 0).  The limit is 1e-5 * max|F| for a
    float32 result, plus one bfloat16 ulp of the larger of the two values
    for a bfloat16 one.  Computed ``rows`` rows of the last axis at a
    time, so that a result of gigabytes needs little more memory."""
    if out.numel() == 0:  # a level-filtered launch whose level has no roi
        return 0.0, 0.0
    o, r = out.reshape(-1, out.shape[-1]), ref.reshape(-1, ref.shape[-1])
    err = excess = -float("inf")
    for i in range(0, o.shape[0], rows):
        a, b = o[i:i + rows].float(), r[i:i + rows].float()
        diff = (a - b).abs()
        limit = torch.full_like(diff, 1e-5 * fmax)
        if out.dtype == torch.bfloat16:
            mag = torch.maximum(a.abs(), b.abs())
            limit += torch.ldexp(torch.ones_like(mag), torch.frexp(mag).exponent - 8)
        err, excess = max(err, float(diff.max())), max(excess, float((diff - limit).max()))
    return err, excess


def forward_err(out, inputs, fmax, chunk=128):
    """``roi_err`` of a forward launch's ``out`` against the plain version
    on its ``inputs``, computed ``chunk`` rois an image at a time (each
    roi's bins depend on that roi alone); a level-filtered launch is held
    on its level's rows only."""
    from cvpr22_cross_modal_pseudo_labeling_torch.ops import roi_align as ra

    feats, rois, output_size, scale, sr, ms, bin_stride, *lv = inputs
    err = excess = None
    for s0 in range(0, rois.shape[1], chunk):
        sl = slice(s0, s0 + chunk)
        part_lv = (lv[0][:, sl], lv[1]) if lv else ()
        ref = ra.roi_align_plain(feats, rois[:, sl], output_size, scale, sr, ms, bin_stride, *part_lv)
        got = out[:, sl]
        if lv:
            mine = part_lv[0] == lv[1]
            got, ref = got[mine], ref[mine]
        if got.numel():
            e, x = roi_err(got, ref, fmax)
            err, excess = (e, x) if err is None else (max(err, e), max(excess, x))
    return (0.0, 0.0) if err is None else (err, excess)


def backward_plain(args, chunk=64):
    """``roi_align_backward_plain`` on ``args`` over ``chunk`` rois an
    image at a time, each chunk's dF in float32, summed in float32 and
    cast to the features' dtype once: the plain version's function with
    the autograd graph of one chunk alive at a time."""
    from cvpr22_cross_modal_pseudo_labeling_torch.ops import roi_align as ra

    grad, rois, shape, dtype, output_size, scale, sr, ms, bin_stride, *lv = args
    total = None
    for s0 in range(0, rois.shape[1], chunk):
        sl = slice(s0, s0 + chunk)
        part = ra.roi_align_backward_plain(grad[:, sl], rois[:, sl], shape, torch.float32, output_size, scale,
                                           sr, ms, bin_stride, *((lv[0][:, sl], lv[1]) if lv else ()))
        total = part if total is None else total.add_(part)
    return total.to(dtype)


def cuda_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def nms_inputs(rng, b, n, num_labels, img_hw, dev, dense=False):
    """Clustered boxes (real overlap), scores on a coarse grid (ties) and
    about 5% invalid slots.  ``dense``: 800 clusters of near-copies of one
    box each (2 px jitter), so that about 740 boxes of 6000 survive and
    the scan reaches the last block."""
    h, w = img_hw
    if dense:
        base = np.concatenate([rng.uniform([0, 0], [w, h], (b, 800, 2)),
                               rng.uniform(48, 300, (b, 800, 2))], -1)
        pick = rng.integers(0, 800, (b, n))
        cw = np.take_along_axis(base, pick[..., None], axis=1)
        boxes = np.concatenate([cw[..., :2] - cw[..., 2:] / 2, cw[..., :2] + cw[..., 2:] / 2], -1)
        boxes = boxes + rng.normal(0, 2, (b, n, 4))
    else:
        centers = rng.uniform([0, 0], [w, h], (b, 40, 2))
        pick = rng.integers(0, 40, (b, n))
        ctr = np.take_along_axis(centers, pick[..., None], axis=1) + rng.normal(0, 12, (b, n, 2))
        wh = rng.uniform(16, 300, (b, n, 2))
        boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1)
    boxes = np.clip(boxes, 0, [w - 1, h - 1, w - 1, h - 1]).astype(np.float32)
    scores = (np.round(rng.uniform(0, 1, (b, n)) * 256) / 256).astype(np.float32)
    valid = rng.uniform(0, 1, (b, n)) > 0.05
    labels = rng.integers(1, num_labels + 1, (b, n)).astype(np.int32)
    t = lambda a: torch.from_numpy(a).to(dev)
    return t(boxes), t(scores), t(valid), t(labels)


def roi_inputs(rng, b, s, img_hw, dev):
    """Rois inside the image, plus a few that straddle or leave it."""
    h, w = img_hw
    x1 = rng.uniform(-40, w, (b, s))
    y1 = rng.uniform(-40, h, (b, s))
    bw = rng.uniform(8, 600, (b, s))
    bh = rng.uniform(8, 500, (b, s))
    rois = np.stack([x1, y1, x1 + bw, y1 + bh], -1).astype(np.float32)
    return torch.from_numpy(rois).to(dev)


# ---------------------------------------------------------------------------
# bounds
# ---------------------------------------------------------------------------

def nms_bound(scores, valid, labels, idx, keep, k):
    """Bytes: boxes, scores, valid (and labels) read once, indices and
    mask written once.  Operations: the IoU tests this run's greedy scan
    needs at the least: each kept box against every earlier kept box of
    its label, and each other valid box up to where the scan stops (the
    last kept box, once k are kept) against one kept box.  Also returns
    the 64-box block where each image's scan stops."""
    b, n = scores.shape
    key = torch.where(valid, scores, torch.full_like(scores, -float("inf")))
    order = torch.sort(key, dim=1, descending=True, stable=True).indices
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(n, device=order.device).expand(b, n).contiguous()
    )
    tests, stop_blocks = 0, []
    for i in range(b):
        kept = idx[i][keep[i]].to(torch.int64)
        c = kept.numel()
        stop = int(rank[i, kept[-1]]) if c == k else n - 1
        stop_blocks.append(stop // 64)
        tests += int((valid[i] & (rank[i] <= stop)).sum()) - c
        per_label = torch.bincount(labels[i][kept]) if labels is not None else torch.tensor([c])
        tests += int((per_label * (per_label - 1) // 2).sum())
    byts = b * (n * (16 + 4 + 1 + (4 if labels is not None else 0)) + k * (4 + 1))
    t_bytes, t_ops = byts / H100_BYTES_PER_S, IOU_OPS * tests / H100_F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            stop_blocks)


def roi_taps(feature_shape, rois, output_size, bin_stride):
    """(taps, distinct taps, emitted bins per roi) of this run's rois: a
    tap is a (nonzero A_y entry, nonzero A_x entry) pair of an emitted
    bin; the distinct taps are the feature positions each roi touches."""
    from cvpr22_cross_modal_pseudo_labeling_torch.ops import roi_align as ra

    B, H, W, _ = feature_shape
    P, Q = output_size
    (sh, bh, gh, ch), (sw, bw, gw, cw) = ra._roi_geometry(rois, 1.0 / 16, P, Q, H, W, 0, 8)
    taps = distinct = 0
    for bi in range(B):
        ay = ra._axis_interp_matrix(sh[bi], bh[bi], gh[bi], H, P, ch, bin_stride)
        ax = ra._axis_interp_matrix(sw[bi], bw[bi], gw[bi], W, Q, cw, bin_stride)
        ny = (ay != 0).sum(-1).to(torch.float64)  # [S, P']
        nx = (ax != 0).sum(-1).to(torch.float64)  # [S, Q']
        taps += float((ny.sum(-1) * nx.sum(-1)).sum())
        uy = (ay != 0).any(1).sum(-1).to(torch.float64)  # [S]
        ux = (ax != 0).any(1).sum(-1).to(torch.float64)
        distinct += float((uy * ux).sum())
    return taps, distinct, ay.shape[1] * ax.shape[1]


def roi_bound(features, rois, output_size, bin_stride):
    """Bytes: features and rois read once, output (in the features'
    dtype) written once, each at its element size.  Operations: two flops per (nonzero A_y entry,
    nonzero A_x entry, channel) of each emitted bin, counted from this
    run's rois.  Also returns the bytes the gather reads from L2 (one row
    of C channels per tap of each bin) and the bytes of the distinct taps
    of each roi (what staging the roi's window would read instead)."""
    B, H, W, C = features.shape
    S = rois.shape[1]
    taps, distinct, bins = roi_taps(features.shape, rois, output_size, bin_stride)
    out_el = B * S * bins * C
    byts = (features.numel() + out_el) * features.element_size() + rois.numel() * 4
    ops = 2.0 * taps * C
    t_bytes, t_ops = byts / H100_BYTES_PER_S, ops / H100_F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            taps * C * features.element_size(), distinct * C * features.element_size())


def device_ms(fn, names, iters):
    """Device time per call of each kernel whose name contains one of
    ``names``, from torch.profiler over ``iters`` calls (None when the
    profiler shows no device time)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(names, 0.0)
    for ev in prof.key_averages():
        if "CUDA" not in str(ev.device_type):
            continue
        for n in names:
            if n in ev.key:
                out[n] += getattr(ev, "self_device_time_total", 0.0) / 1e3 / iters
    return {n: (v if v > 0 else None) for n, v in out.items()}


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def time_nms(run):
    """(whole-function ms from CUDA events, enqueue ms on the host clock,
    {kernel: device ms per call} from the profiler)."""
    ms = cuda_ms(run, 20)
    split = device_ms(run, ("nms_mask_kernel", "nms_scan_kernel"), 10)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(20):
        run()
    host_ms = (time.perf_counter() - t) / 20 * 1e3
    torch.cuda.synchronize()
    return ms, host_ms, split


def phase_nms(dev, results):
    from cvpr22_cross_modal_pseudo_labeling_torch.ops import nms as nm

    rng = np.random.default_rng(SEED)
    b = SERVING["batch"]
    calls = {}
    for name, n, k, thr, num_labels, kind in NMS_CASES:
        boxes, scores, valid, labels = nms_inputs(
            rng, b, n, max(num_labels, 1), SERVING["hw"], dev, dense=kind == "dense")
        lab = labels if num_labels else None
        idx, keep = nm.nms(boxes, scores, valid, thr, k, labels=lab)
        ref_idx, ref_keep = nm.nms_plain(boxes, scores, valid, thr, k, labels=lab)
        torch.cuda.synchronize()
        mism = int((idx != ref_idx).sum() + (keep != ref_keep).sum())
        check(mism == 0, f"nms {name}: {mism} entries differ from the plain version")
        run = functools.partial(nm.nms, boxes, scores, valid, thr, k, labels=lab)
        ms, host_ms, split = time_nms(run)
        plain_ms = cuda_ms(lambda: nm.nms_plain(boxes, scores, valid, thr, k, labels=lab), 3)
        bound_ms, bound_by, stop_blocks = nms_bound(scores, valid, lab, idx, keep, k)
        hint = int(nm._stop_hint(boxes.device, n, k))
        calls[name] = (run, idx, keep)
        rec = dict(phase="nms", case=name, batch=b, n=n, max_outputs=k, iou=thr,
                   kept_per_image=keep.sum(1).tolist(), mismatches=mism,
                   scan_stop_block=stop_blocks, blocks=-(-n // 64), stop_hint_columns=hint,
                   ms=ms, host_ms=host_ms, mask_kernel_ms=split["nms_mask_kernel"],
                   scan_kernel_ms=split["nms_scan_kernel"], plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=bound_by)
        if kind == "dense":
            # max_outputs = N keeps the same boxes in one column band
            check(bool((keep.sum(1) < k).all()), f"nms {name}: the scan stopped early")
            one_idx, one_keep = nm.nms(boxes, scores, valid, thr, n, labels=lab)
            ref_idx, ref_keep = nm.nms_plain(boxes, scores, valid, thr, n, labels=lab)
            mism = int((one_idx != ref_idx).sum() + (one_keep != ref_keep).sum())
            check(mism == 0 and torch.equal(one_idx[:, :k], idx),
                  f"nms {name}, one band: {mism} entries differ from the plain version")
            ms1, host1, split1 = time_nms(
                lambda: nm.nms(boxes, scores, valid, thr, n, labels=lab))
            rec.update(one_band_ms=ms1, one_band_host_ms=host1,
                       one_band_mask_kernel_ms=split1["nms_mask_kernel"],
                       one_band_scan_kernel_ms=split1["nms_scan_kernel"],
                       one_band_mismatches=mism)
            # alternating traffic: each call's first band is sized from the
            # other inputs' stop point; the results must not change
            alt = lambda: (calls["rpn"][0](), run())  # noqa: E731
            (r_idx, r_keep), (d_idx, d_keep) = alt()
            check(torch.equal(r_idx, calls["rpn"][1]) and torch.equal(r_keep, calls["rpn"][2])
                  and torch.equal(d_idx, idx) and torch.equal(d_keep, keep),
                  f"nms {name}: alternating calls changed a result")
            rec.update(alternating_pair_ms=cuda_ms(alt, 20),
                       steady_pair_ms=results["nms_rpn"]["ms"] + ms)
        emit(rec)
        results[f"nms_{name}"] = rec


def phase_roi_align(dev, results):
    from cvpr22_cross_modal_pseudo_labeling_torch.ops import roi_align as ra

    rng = np.random.default_rng(SEED + 1)
    feats32 = torch.from_numpy(rng.standard_normal(ROI_FEATURES, np.float32)).to(dev)
    feats_by_dtype = {F32: feats32, BF16: feats32.to(BF16)}
    for s, bin_stride, dtype in ROI_CASES:
        feats = feats_by_dtype[dtype]
        fmax = float(feats.float().abs().max())
        rois = roi_inputs(rng, ROI_FEATURES[0], s, SERVING["hw"], dev)
        args = (feats, rois, (14, 14), 1.0 / 16, 0, 8, bin_stride)
        out = ra.roi_align(*args)
        ref = ra.roi_align_plain(*args)
        torch.cuda.synchronize()
        check(out.dtype == dtype and out.shape == ref.shape, f"roi_align: {out.dtype} {out.shape}")
        err, excess = roi_err(out, ref, fmax)
        name = f"S={s} bin_stride={bin_stride} {dtype}"
        check(excess <= 0, f"roi_align {name}: max abs diff {err}, {excess} over the limit")
        del ref
        ms = cuda_ms(lambda: ra.roi_align(*args), 10)
        plain_ms = cuda_ms(lambda: ra.roi_align_plain(*args), 2)
        bound_ms, bound_by, tap_bytes, distinct_bytes = roi_bound(
            feats, rois, (14, 14), bin_stride)
        rec = dict(phase="roi_align", rois_per_image=s, bin_stride=bin_stride,
                   features=list(feats.shape), dtype=str(dtype),
                   max_abs_err=err, excess_over_limit=excess, f32_tol=1e-5 * fmax, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, tap_read_gb=tap_bytes / 1e9,
                   distinct_tap_gb=distinct_bytes / 1e9,
                   tap_read_tb_per_s=tap_bytes / (ms * 1e-3) / 1e12)
        emit(rec)
        results[("roi_align", s, bin_stride, dtype)] = rec
        del out
        torch.cuda.empty_cache()


def roi_bwd_bound(grad, rois, feature_shape, output_size, bin_stride):
    """Bytes: the cotangent and rois read once, dF (in the features'
    dtype) written once.  Operations: two flops per (tap, channel), counted
    from this run's rois.  Also returns the float32 adds (one per tap and
    channel)."""
    C = feature_shape[3]
    taps, _, _ = roi_taps(feature_shape, rois, output_size, bin_stride)
    byts = (grad.numel() + int(np.prod(feature_shape))) * grad.element_size() + rois.numel() * 4
    t_bytes, t_ops = byts / H100_BYTES_PER_S, 2.0 * taps * C / H100_F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations", taps * C)


def roi_bwd_case(name, args, tiles=()):
    """One backward case on ``roi_align_backward``'s arguments ``args``
    (on the [8, 50, 84, 1024] map, 14 x 14 bins, scale 1/16, adaptive
    grid of at most 8): the kernel against the plain version, its time,
    bound and plain time, the plan and tile kernels' device times, and its
    time at each of ``tiles``."""
    from cvpr22_cross_modal_pseudo_labeling_torch.ops import roi_align as ra

    grad, rois, shape, dtype, output_size, scale, sampling_ratio, max_samples, bin_stride = args
    check((tuple(shape), output_size, scale, sampling_ratio, max_samples)
          == (ROI_FEATURES, (14, 14), 1.0 / 16, 0, 8),
          f"roi_align_backward {name}: unexpected arguments {shape} {output_size} {scale}")
    out = ra.roi_align_backward(*args)
    ref = ra.roi_align_backward_plain(*args)
    torch.cuda.synchronize()
    check(out.dtype == dtype and out.shape == ref.shape, f"roi_align_backward: {out.dtype} {out.shape}")
    fmax = float(ref.float().abs().max())
    err, excess = roi_err(out, ref, fmax)
    check(fmax > 0 and excess <= 0,
          f"roi_align_backward {name}: max abs diff {err}, {excess} over the limit")
    again = ra.roi_align_backward(*args)
    identical = bool(torch.equal(out, again))
    del out, ref, again
    ms = cuda_ms(lambda: ra.roi_align_backward(*args), 10)
    plain_ms = cuda_ms(lambda: ra.roi_align_backward_plain(*args), 2)
    split = device_ms(lambda: ra.roi_align_backward(*args),
                      ("roi_align_bwd_plan_kernel", "roi_align_bwd_kernel"), 5)
    bound_ms, bound_by, adds = roi_bwd_bound(grad, rois, ROI_FEATURES, (14, 14), bin_stride)
    B, H, W, C = ROI_FEATURES
    rec = dict(phase="roi_align_backward", case=name, rois_per_image=rois.shape[1],
               bin_stride=bin_stride, features=list(ROI_FEATURES), dtype=str(dtype),
               max_abs_err=err, excess_over_limit=excess, f32_tol=1e-5 * fmax,
               bit_identical_rerun=identical, ms=ms, plain_ms=plain_ms,
               plan_kernel_ms=split["roi_align_bwd_plan_kernel"],
               tile_kernel_ms=split["roi_align_bwd_kernel"],
               tile=list(ra.backward_tiling(H, W, C, 2 * ra._sample_caps(H, W, 14, 14, 0, 8)[1])),
               bound_ms=bound_ms, bound_by=bound_by, adds_g=adds / 1e9,
               shared_g_adds_per_s=adds / (ms * 1e-3) / 1e9)
    if tiles:
        rec["ms_by_tile"] = {
            "x".join(map(str, t)): cuda_ms(lambda: ra._backward_cuda(*args, tile=t), 10) for t in tiles}
    emit(rec)
    torch.cuda.empty_cache()
    return rec


def phase_roi_align_backward(dev, results):
    rng = np.random.default_rng(SEED + 6)
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    for s, bin_stride, dtype in ROI_BWD_CASES:
        rois = roi_inputs(rng, ROI_FEATURES[0], s, SERVING["hw"], dev)
        p = -(-14 // bin_stride)
        grad = torch.randn((ROI_FEATURES[0], s, p, p, ROI_FEATURES[3]), generator=gen,
                           device=dev).to(dtype)
        main = (s, bin_stride, dtype) == ROI_BWD_MAIN
        args = (grad, rois, ROI_FEATURES, dtype, (14, 14), 1.0 / 16, 0, 8, bin_stride)
        rec = roi_bwd_case(f"S={s} bin_stride={bin_stride} {dtype}", args,
                           ROI_BWD_TILES if main else ())
        results[("roi_align_backward", s, bin_stride, dtype)] = rec


def phase_roi_align_backward_teacher_rois(dev, results):
    """The backward on the first teacher step's own cotangent and rois
    (captured by the launch hook in phase 12)."""
    args = tuple(x.to(dev) if torch.is_tensor(x) else x for x in results.pop("teacher_bwd_inputs"))
    results["roi_align_backward_teacher_rois"] = roi_bwd_case("teacher step rois", args)


def small_model(device):
    from cvpr22_cross_modal_pseudo_labeling_torch import bridge
    from cvpr22_cross_modal_pseudo_labeling_torch.engine.inference import Predictor

    opts = [
        "MODEL.RESNETS.STEM_OUT_CHANNELS", 8, "MODEL.RESNETS.RES2_OUT_CHANNELS", 16,
        "MODEL.RESNETS.WIDTH_PER_GROUP", 4, "MODEL.ROI_BOX_HEAD.EMB_DIM", 16,
        "MODEL.RPN.PRE_NMS_TOP_N_TEST", 128, "MODEL.RPN.POST_NMS_TOP_N_TEST", 32,
        "MODEL.ROI_MASK_HEAD.CONV_LAYERS", (8,), "TPU.COMPUTE_DTYPE", "float32",
    ]
    pred = Predictor(CONFIG, opts, device=device)
    pred.load_flax_params(bridge.seeded_flax_params(pred.model, SEED, 0.01))
    return pred


def phase_small():
    rng = np.random.default_rng(SEED + 2)
    images = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    sizes = np.array([[64, 64], [48, 64]], np.int32)
    table = rng.standard_normal((6, 16)).astype(np.float32)
    table[0] = 0
    gpu, gmask = small_model("cuda")(images, sizes, table)
    cpu, cmask = small_model("cpu")(images, sizes, table)
    check((gpu.valid == cpu.valid).all() and (gpu.labels == cpu.labels).all(),
          "small model: labels/valid differ between CUDA and CPU")
    box_err = float(abs(gpu.boxes - cpu.boxes).max())
    score_err = float(abs(gpu.scores - cpu.scores).max())
    mask_err = float(abs(gmask - cmask).max())
    check(box_err <= 1e-3 and score_err <= 1e-5 and mask_err <= 1e-4,
          f"small model: box {box_err} score {score_err} mask {mask_err} over tolerance")
    check(bool(gpu.valid.any(1).all()), "small model: an image without detections")
    emit(dict(phase="small", valid_per_image=gpu.valid.sum(1).tolist(),
              box_err=box_err, score_err=score_err, mask_err=mask_err))


def phase_serving(dev, results):
    from cvpr22_cross_modal_pseudo_labeling_torch import bridge
    from cvpr22_cross_modal_pseudo_labeling_torch.engine.inference import Predictor
    from cvpr22_cross_modal_pseudo_labeling_torch.ops import kernels

    t0 = time.perf_counter()
    pred = Predictor(CONFIG, SERVING["opts"], device=dev)
    pred.load_flax_params(bridge.seeded_flax_params(pred.model, SEED, EMB_PRED_STD))
    check(pred.cfg.TPU.COMPUTE_DTYPE == "bfloat16", "the serving config must run in bfloat16")
    setup_s = time.perf_counter() - t0

    rng = np.random.default_rng(SEED + 3)
    table = rng.standard_normal((66, 768)).astype(np.float32)
    table[0] = 0.0
    b, (h, w) = SERVING["batch"], SERVING["hw"]
    batches = []
    for _ in range(SERVING["batches"]):
        images = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
        sizes = np.stack(
            [rng.integers(3 * h // 4, h + 1, b), rng.integers(2 * w // 3, w + 1, b)], 1
        ).astype(np.int32)
        sizes[0] = (h, w)
        batches.append((images, sizes))

    checks, check_nms, check_roi, _ = launch_checks()
    kernels.reset_launches()
    lat, counts = [], []
    for i, (images, sizes) in enumerate(batches):
        first = i == 0
        kernels.NMS.on_launch = check_nms if first else None
        kernels.ROI_ALIGN.on_launch = check_roi if first else None
        torch.cuda.synchronize()
        if i == 1:  # the peak of serving, not of the first batch's checks
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        dets, masks = pred(images, sizes, table)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t)
        counts.append(dets.valid.sum(1).tolist())
        check(dets.boxes.shape == (b, 100, 4) and masks.shape == (b, 100, 14, 14),
              f"serving: unexpected shapes {dets.boxes.shape} {masks.shape}")
        check(np.isfinite(dets.boxes).all() and np.isfinite(dets.scores).all()
              and np.isfinite(masks).all(), "serving: non-finite output")
        check(bool(dets.valid.any(1).all()), f"serving: batch {i} has an image without detections")
    kernels.NMS.on_launch = kernels.ROI_ALIGN.on_launch = None
    launches = {k.name: k.launches for k in kernels.ALL}
    peak = torch.cuda.max_memory_allocated()

    check(len(checks["nms"]) == 2 and all(m == 0 for m, _ in checks["nms"]),
          f"serving: NMS launches differ from the plain version: {checks['nms']}")
    check(len(checks["roi_align"]) == 2
          and all(excess <= 0 for _, excess, _, _ in checks["roi_align"]),
          f"serving: RoIAlign launches over tolerance: {checks['roi_align']}")
    check(launches["nms"] > 0 and launches["roi_align"] > 0 and launches["roi_align_backward"] == 0,
          f"serving: a kernel of the path never launched, or the backward did: {launches}")
    steady = lat[1:]
    rec = dict(
        phase="serving", config=CONFIG, dtype="bfloat16", batch=b, image_hw=[h, w],
        emb_pred_std=EMB_PRED_STD, setup_s=setup_s, batch_latency_s=lat,
        steady_images_per_s=b * len(steady) / sum(steady),
        steady_peak_memory_gb=peak / 1e9, valid_detections=counts, launches=launches,
        first_batch_checks={"nms_mismatches": [m for m, _ in checks["nms"]],
                            "roi_align_max_abs_err": [e for e, _, _, _ in checks["roi_align"]],
                            "roi_align_excess_over_limit": [x for _, x, _, _ in checks["roi_align"]],
                            "roi_align_dtype": [d for _, _, d, _ in checks["roi_align"]]},
    )
    emit(rec)
    results["serving"] = rec
    return pred, batches[-1], table


KERNEL_GROUPS = (  # (group, substrings of device kernel names), first match wins
    ("port: nms", ("nms_mask_kernel", "nms_scan_kernel")),
    ("port: roi_align", ("roi_align_fwd_kernel",)),
    ("port: roi_align backward", ("roi_align_bwd",)),
    ("conv / matmul", ("xmma", "nvjet", "cutlass", "gemm", "conv", "implicit")),
    ("sort / select", ("sort", "radix", "scan", "topk", "index", "gather")),
    ("copy / cast", ("copy", "Memcpy", "Memset")),
    ("elementwise", ("elementwise",)),
    ("reduce", ("reduce",)),
)


def profile_groups(run, kernel_groups=KERNEL_GROUPS):
    """One call of ``run`` under torch.profiler: device time by kernel
    group, the largest kernels, each copy and cast, and the device's busy
    share of the call's wall time.  Only device-side events count (the
    aten ops that launched them would count the same time twice)."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    groups, top, copies = {}, [], []
    for ev in prof.key_averages():
        if "CUDA" not in str(ev.device_type) or ev.key.startswith("Activity Buffer"):
            continue
        ms = getattr(ev, "self_device_time_total", 0.0) / 1e3
        group = next((g for g, keys in kernel_groups if any(k in ev.key for k in keys)), "other")
        groups[group] = groups.get(group, 0.0) + ms
        top.append((ms, ev.count, ev.key[:90]))
        if group == "copy / cast":
            copies.append((ms, ev.count, ev.key[:90]))
    top.sort(reverse=True)
    copies.sort(reverse=True)
    device_ms = sum(groups.values())
    return dict(wall_ms=wall_ms, device_ms=device_ms, device_busy_share=device_ms / wall_ms,
                groups_ms=dict(sorted(groups.items(), key=lambda kv: -kv[1])),
                top=[dict(ms=ms, calls=n, name=name) for ms, n, name in top[:15]],
                copy_cast=[dict(ms=ms, calls=n, name=name) for ms, n, name in copies])


def phase_profile(pred, batch, table):
    """One more serving batch under torch.profiler."""
    images, sizes = batch
    emit(dict(phase="profile", **profile_groups(lambda: pred(images, sizes, table))))


def launch_checks():
    """Hooks that hold each kernel launch against the plain version:
    (checks, NMS hook, RoIAlign hook, RoIAlign backward hook).  NMS must
    be exact; RoIAlign within ``roi_err``'s limit at the launch's own
    dtype (of max|F| forward, of max|dF| backward)."""
    from cvpr22_cross_modal_pseudo_labeling_torch.ops import nms as nm

    checks = {"nms": [], "roi_align": [], "roi_align_backward": []}

    def check_nms(inputs, out):
        ref = nm.nms_plain(*inputs)
        n = inputs[0].shape[-2]
        checks["nms"].append((int((out[0] != ref[0]).sum() + (out[1] != ref[1]).sum()),
                              f"{inputs[0].shape[0]} x {n} -> {inputs[4]}"))

    def check_roi(inputs, out):
        # at the launch's own dtype; a level-filtered launch (the FPN
        # pooler) writes its level's rows of an output the other levels'
        # launches share, and is held on those rows
        rois = f"{inputs[1].shape[0]} x {inputs[1].shape[1]}"
        if len(inputs) > 7:
            rois += f", level {inputs[8]}: {int((inputs[7] == inputs[8]).sum())}"
        checks["roi_align"].append(
            forward_err(out, inputs, float(inputs[0].float().abs().max())) + (str(out.dtype), rois)
        )

    def check_roi_bwd(inputs, out):
        # kept on the host, out of the steady steps' peak memory
        if "roi_align_backward_inputs" not in checks:
            checks["roi_align_backward_inputs"] = tuple(x.cpu() if torch.is_tensor(x) else x for x in inputs)
        ref = backward_plain(inputs)
        rois = f"{inputs[1].shape[0]} x {inputs[1].shape[1]}"
        if len(inputs) > 9:
            rois += f", level {inputs[10]}: {int((inputs[9] == inputs[10]).sum())}"
        checks["roi_align_backward"].append(
            roi_err(out, ref, float(ref.float().abs().max())) + (str(out.dtype), rois)
        )

    return checks, check_nms, check_roi, check_roi_bwd


def small_train_setup(device, rng_seed):
    from cvpr22_cross_modal_pseudo_labeling_torch import bridge
    from cvpr22_cross_modal_pseudo_labeling_torch.engine.train_step import Trainer

    opts = [
        "MODEL.RESNETS.STEM_OUT_CHANNELS", 8, "MODEL.RESNETS.RES2_OUT_CHANNELS", 16,
        "MODEL.RESNETS.WIDTH_PER_GROUP", 4, "MODEL.ROI_BOX_HEAD.EMB_DIM", 16,
        "MODEL.RPN.PRE_NMS_TOP_N_TEST", 128, "MODEL.RPN.POST_NMS_TOP_N_TEST", 32,
        "MODEL.RPN.PRE_NMS_TOP_N_TRAIN", 128, "MODEL.RPN.POST_NMS_TOP_N_TRAIN", 32,
        "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 16, "TPU.MASK_POS_CAP", 8,
        "TPU.MAX_GT", 4, "TPU.MAX_CAP_NOUNS", 3,
        "MODEL.ROI_MASK_HEAD.CONV_LAYERS", (8,), "TPU.COMPUTE_DTYPE", "float32",
    ]
    trainer = Trainer(CONFIG, opts, device=device, seed=rng_seed)
    trainer.load_flax_params(bridge.seeded_flax_params(trainer.model, SEED, 0.01))
    return trainer


def phase_small_train(devices=("cuda", "cpu")):
    """The CUDA Trainer against the CPU Trainer (whose plain versions the
    CPU tests hold against the JAX train step) on one tiny step with the
    same draws: losses within 1e-4 relative, updated student parameters
    within 1e-3 of each update's norm (the C5 head's gradient is
    sensitive to rounding at ReLU boundaries)."""
    from cvpr22_cross_modal_pseudo_labeling_torch.models.detector.st_generalized_rcnn import (
        TrainDraws,
    )

    rng = np.random.default_rng(SEED + 5)
    batch = train_batch(rng, 2, (64, 64), max_gt=4, nouns=3, noun_tokens=4, lvis=20,
                        classes=6, emb_dim=16)
    # gt masks whose resampled targets do not sit on the 0.5 threshold
    batch["gt_masks"] = rng.choice(np.float32([0.2, 0.9]), batch["gt_masks"].shape)
    draws = TrainDraws(
        torch.from_numpy(rng.uniform(size=(2, 2, 32)).astype(np.float32)),
        torch.from_numpy(rng.uniform(size=(2, 2, 36)).astype(np.float32)),
        torch.from_numpy(rng.standard_normal((1, 16, 14, 14, 2)).astype(np.float32)),
    )
    out = []
    for device in devices:
        trainer = small_train_setup(device, SEED)
        before = {n: p.detach().cpu().clone() for n, p in trainer.model.student.named_parameters()}
        metrics = trainer.step(batch, TrainDraws(*(None if d is None else d.to(device) for d in draws)))
        after = {n: p.detach().cpu() for n, p in trainer.model.student.named_parameters()}
        out.append(({k: float(v) for k, v in metrics.items()},
                    {n: after[n] - before[n] for n in after}))
    (gm, gu), (cm, cu) = out
    loss_err = max(abs(gm[k] - cm[k]) / max(abs(cm[k]), 1e-6) for k in cm)
    update_err = max(float((gu[n] - cu[n]).norm() / cu[n].norm().clamp(min=1e-30)) for n in cu)
    check(all(np.isfinite(v) for v in gm.values()), f"small train: non-finite metrics {gm}")
    check(loss_err <= 1e-4 and update_err <= 1e-3,
          f"small train: CUDA vs CPU loss {loss_err}, update {update_err} over tolerance")
    emit(dict(phase="small_train", loss_rel_err=loss_err, update_rel_err=update_err,
              losses_cuda={k: gm[k] for k in sorted(gm)}))


def train_batch(rng, b, hw, max_gt, nouns, noun_tokens, lvis, classes, emb_dim=768):
    """A collated training batch (``data/collate.py`` keys) plus the class
    table (row 0 the background) and the LVIS table: uint8 images with
    sizes 3/4 to 1 of the bucket, half to all of ``max_gt`` gt boxes per
    image with elliptic 28 x 28 masks in their box frames, and ``nouns``
    caption nouns of 1 to 3 wordpieces between CLS and SEP."""
    h, w = hw
    sizes = np.stack([rng.integers(3 * h // 4, h + 1, b), rng.integers(2 * w // 3, w + 1, b)],
                     1).astype(np.int32)
    sizes[0] = (h, w)
    count = rng.integers(max_gt // 2, max_gt + 1, b)
    valid = np.arange(max_gt)[None, :] < count[:, None]
    bw = rng.uniform(8, 0.5 * w, (b, max_gt))
    bh = rng.uniform(8, 0.5 * h, (b, max_gt))
    x1 = rng.uniform(0, 1, (b, max_gt)) * (sizes[:, 1:2] - bw)
    y1 = rng.uniform(0, 1, (b, max_gt)) * (sizes[:, 0:1] - bh)
    boxes = np.stack([x1, y1, x1 + bw, y1 + bh], -1).astype(np.float32) * valid[..., None]
    grid = (np.arange(28) + 0.5) / 28 - 0.5
    rx = rng.uniform(0.2, 0.5, (b, max_gt, 1, 1))
    ry = rng.uniform(0.2, 0.5, (b, max_gt, 1, 1))
    masks = ((grid[None, None, None, :] / rx) ** 2 + (grid[None, None, :, None] / ry) ** 2 <= 1)
    tokens = rng.integers(1, 4, (b, nouns))
    pos = np.arange(noun_tokens)[None, None, :]
    tok_mask = (pos >= 1) & (pos <= tokens[..., None])
    table = rng.standard_normal((classes, emb_dim)).astype(np.float32)
    table[0] = 0.0
    return dict(
        images=rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8),
        image_sizes=sizes,
        gt_boxes=boxes,
        gt_labels=(rng.integers(1, classes, (b, max_gt)) * valid).astype(np.int32),
        gt_valid=valid,
        gt_masks=(masks & valid[..., None, None]).astype(np.float32),
        cap_mask=np.ones((b,), bool),
        det_mask=np.ones((b,), bool),
        cap_tok_ids=np.where(tok_mask, rng.integers(1000, 30522, (b, nouns, noun_tokens)), 0)
        .astype(np.int32),
        cap_tok_mask=tok_mask.astype(np.int32),
        cap_word_valid=np.ones((b, nouns), bool),
        cap_labels=rng.integers(0, lvis, (b, nouns)).astype(np.int32),
        class_embeddings=table,
        lvis_class_embeddings=rng.standard_normal((lvis, emb_dim)).astype(np.float32),
    )


FROZEN_MODULES = ("backbone", "rpn_head", "teacher", "bert")


def phase_train(dev, results):
    from cvpr22_cross_modal_pseudo_labeling_torch import bridge
    from cvpr22_cross_modal_pseudo_labeling_torch.engine.train_step import Trainer
    from cvpr22_cross_modal_pseudo_labeling_torch.ops import kernels

    t0 = time.perf_counter()
    trainer = Trainer(CONFIG, TRAIN["opts"], device=dev, seed=SEED)
    trainer.load_flax_params(bridge.seeded_flax_params(trainer.model, SEED, EMB_PRED_STD))
    check(trainer.cfg.TPU.COMPUTE_DTYPE == "bfloat16", "the training config must run in bfloat16")
    setup_s = time.perf_counter() - t0
    model = trainer.model
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if n.split(".")[0] in FROZEN_MODULES}
    check(all(not model.get_parameter(n).requires_grad for n in frozen),
          "train: a parameter of a frozen module requires grad")
    student = {n: p.detach().clone() for n, p in model.student.named_parameters()}

    rng = np.random.default_rng(SEED + 4)
    emb_dim = model.statics.base.emb_dim
    batches = [train_batch(rng, TRAIN["batch"], TRAIN["hw"], TRAIN["max_gt"], TRAIN["nouns"],
                           TRAIN["noun_tokens"], TRAIN["lvis"], TRAIN["classes"], emb_dim)
               for _ in range(TRAIN["steps"] + 1)]
    checks, check_nms, check_roi, _ = launch_checks()
    kernels.reset_launches()
    lat, metrics = [], []
    for i, batch in enumerate(batches[:TRAIN["steps"]]):
        first = i == 0
        kernels.NMS.on_launch = check_nms if first else None
        kernels.ROI_ALIGN.on_launch = check_roi if first else None
        torch.cuda.synchronize()
        if i == 1:  # the peak of training, not of the first step's checks
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        m = trainer.step(batch)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t)
        metrics.append({k: float(v) for k, v in m.items()})
        check(all(np.isfinite(v) for v in metrics[-1].values()),
              f"train: step {i} has a non-finite metric: {metrics[-1]}")
    kernels.NMS.on_launch = kernels.ROI_ALIGN.on_launch = None
    launches = {k.name: k.launches for k in kernels.ALL}
    peak = torch.cuda.max_memory_allocated()

    unchanged = [n for n, p in model.student.named_parameters() if torch.equal(p, student[n])]
    moved = [n for n, p in model.named_parameters() if n in frozen and not torch.equal(p, frozen[n])]
    check(not unchanged, f"train: student parameters did not change: {unchanged[:5]}")
    check(not moved, f"train: frozen parameters changed: {moved[:5]}")
    nms_sizes = sorted({shape for _, shape in checks["nms"]})
    check(len(checks["nms"]) == 2 and all(m == 0 for m, _ in checks["nms"]),
          f"train: NMS launches differ from the plain version: {checks['nms']}")
    check(len(checks["roi_align"]) == 4
          and all(excess <= 0 for _, excess, _, _ in checks["roi_align"]),
          f"train: RoIAlign launches over tolerance: {checks['roi_align']}")
    # the ST step pools features that carry no gradient: no backward
    check(launches["nms"] > 0 and launches["roi_align"] > 0 and launches["roi_align_backward"] == 0,
          f"train: a kernel of the path never launched, or the backward did: {launches}")
    steady = lat[1:]
    rec = dict(
        phase="train", config=CONFIG, dtype="bfloat16", batch=TRAIN["batch"],
        image_hw=list(TRAIN["hw"]), setup_s=setup_s, step_latency_s=lat,
        steady_step_s=sum(steady) / len(steady),
        steady_images_per_s=TRAIN["batch"] * len(steady) / sum(steady),
        steady_peak_memory_gb=peak / 1e9, launches=launches, metrics=metrics,
        gt_per_image=[int(v.sum()) for v in batches[0]["gt_valid"]],
        first_step_checks={
            "nms_mismatches": [m for m, _ in checks["nms"]], "nms_shapes": nms_sizes,
            "roi_align_max_abs_err": [e for e, _, _, _ in checks["roi_align"]],
            "roi_align_excess_over_limit": [x for _, x, _, _ in checks["roi_align"]],
            "roi_align_rois": [r for _, _, _, r in checks["roi_align"]],
            "roi_align_dtype": [d for _, _, d, _ in checks["roi_align"]]},
    )
    rec["host_syncs_per_step"] = count_syncs(lambda: trainer.step(batches[-1]))
    emit(rec)
    results["train"] = rec
    emit(dict(phase="train_profile", **profile_groups(lambda: trainer.step(batches[-1]))))


TINY_TEACHER_OPTS = [
    "MODEL.RESNETS.STEM_OUT_CHANNELS", 8, "MODEL.RESNETS.RES2_OUT_CHANNELS", 16,
    "MODEL.RESNETS.WIDTH_PER_GROUP", 4, "MODEL.ROI_BOX_HEAD.EMB_DIM", 16,
    "MODEL.RPN.PRE_NMS_TOP_N_TRAIN", 128, "MODEL.RPN.POST_NMS_TOP_N_TRAIN", 32,
    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 16, "TPU.MASK_POS_CAP", 8, "TPU.MAX_GT", 4,
    "MODEL.ROI_MASK_HEAD.CONV_LAYERS", (8,), "TPU.COMPUTE_DTYPE", "float32",
]
# the teacher's parameter groups: what an SGD step must change, and what
# FREEZE_CONV_BODY_AT 2 and FREEZE_EMB_PRED keep bit-identical
TEACHER_TRAINED = ("backbone.body.layer2.", "backbone.body.layer3.", "rpn_head.", "roi_extractor.",
                   "box_predictor.bbox_pred.", "mask_predictor.")
TEACHER_FROZEN = ("backbone.body.stem.", "backbone.body.layer1.", "box_predictor.emb_pred.")


def rcnn_batch(batch):
    """The keys of a teacher training batch."""
    from cvpr22_cross_modal_pseudo_labeling_torch.engine.train_step import RCNN_BATCH_DTYPES

    return {k: batch[k] for k in RCNN_BATCH_DTYPES if k in batch}


def phase_small_teacher_train(devices=("cuda", "cpu")):
    """The CUDA teacher Trainer against the CPU one (whose plain versions
    the CPU tests hold against the JAX train step) on one tiny step with
    the same draws: losses within 1e-4 relative, every trainable
    parameter's update (layer2 and layer3 included) within 1e-3 of its
    norm.  The step goes through the RoIAlign backward kernel on CUDA."""
    from cvpr22_cross_modal_pseudo_labeling_torch import bridge
    from cvpr22_cross_modal_pseudo_labeling_torch.engine.train_step import Trainer
    from cvpr22_cross_modal_pseudo_labeling_torch.models.detector.generalized_rcnn import TrainDraws
    from cvpr22_cross_modal_pseudo_labeling_torch.ops import kernels

    rng = np.random.default_rng(SEED + 7)
    batch = rcnn_batch(train_batch(rng, 2, (64, 64), max_gt=4, nouns=3, noun_tokens=4, lvis=20,
                                   classes=6, emb_dim=16))
    batch["gt_masks"] = rng.choice(np.float32([0.2, 0.9]), batch["gt_masks"].shape)
    anchors = 4 * 4 * 15  # the 64 x 64 images' C4 grid, 15 anchors a cell
    draws = TrainDraws(
        gt_sampler=torch.from_numpy(rng.uniform(size=(2, 2, 32 + 4)).astype(np.float32)),
        rpn_sampler=torch.from_numpy(rng.uniform(size=(2, 2, anchors)).astype(np.float32)),
    )
    out = []
    for device in devices:
        trainer = Trainer(TEACHER, TINY_TEACHER_OPTS, device=device, seed=SEED)
        trainer.load_flax_params(bridge.seeded_flax_params(trainer.model, SEED, 0.01))
        before = {n: p.detach().cpu().clone() for n, p in trainer.model.named_parameters()
                  if p.requires_grad}
        bwd = kernels.ROI_ALIGN_BACKWARD.launches
        metrics = trainer.step(batch, TrainDraws(*(None if d is None else d.to(device) for d in draws)))
        bwd = kernels.ROI_ALIGN_BACKWARD.launches - bwd
        after = {n: p.detach().cpu() for n, p in trainer.model.named_parameters() if n in before}
        out.append(({k: float(v) for k, v in metrics.items()},
                    {n: after[n] - before[n] for n in after}, bwd))
    (gm, gu, g_bwd), (cm, cu, _) = out
    loss_err = max(abs(gm[k] - cm[k]) / max(abs(cm[k]), 1e-6) for k in cm)
    update_err = {n: float((gu[n] - cu[n]).norm() / cu[n].norm().clamp(min=1e-30)) for n in cu}
    worst = max(update_err, key=update_err.get)
    trunk = [n for n in cu if n.startswith(("backbone.body.layer2.", "backbone.body.layer3."))]
    check(all(np.isfinite(v) for v in gm.values()), f"small teacher train: non-finite metrics {gm}")
    check(trunk and all(cu[n].abs().max() > 0 for n in trunk), "small teacher train: the trunk did not train")
    check(devices[0] == "cpu" or g_bwd == 1, f"small teacher train: {g_bwd} backward launches, not 1")
    check(loss_err <= 1e-4 and update_err[worst] <= 1e-3,
          f"small teacher train: CUDA vs CPU loss {loss_err}, update {update_err[worst]} "
          f"({worst}) over tolerance")
    emit(dict(phase="small_teacher_train", loss_rel_err=loss_err, update_rel_err=update_err[worst],
              worst_update=worst, trunk_update_rel_err=max(update_err[n] for n in trunk),
              backward_launches=g_bwd, losses_cuda={k: gm[k] for k in sorted(gm)}))


def phase_teacher_serving(dev, results):
    from cvpr22_cross_modal_pseudo_labeling_torch import bridge
    from cvpr22_cross_modal_pseudo_labeling_torch.engine.inference import Predictor
    from cvpr22_cross_modal_pseudo_labeling_torch.models.detector.generalized_rcnn import (
        GeneralizedRCNN,
    )
    from cvpr22_cross_modal_pseudo_labeling_torch.ops import kernels

    t0 = time.perf_counter()
    pred = Predictor(TEACHER, SERVING["opts"], device=dev)
    pred.load_flax_params(bridge.seeded_flax_params(pred.model, SEED, EMB_PRED_STD))
    check(isinstance(pred.model, GeneralizedRCNN), f"teacher serving: built {type(pred.model)}")
    check(pred.cfg.TPU.COMPUTE_DTYPE == "bfloat16", "the teacher config must run in bfloat16")
    setup_s = time.perf_counter() - t0

    rng = np.random.default_rng(SEED + 8)
    table = rng.standard_normal((TEACHER_CLASSES, pred.model.statics.emb_dim)).astype(np.float32)
    table[0] = 0.0
    b, (h, w) = SERVING["batch"], SERVING["hw"]
    batches = []
    for _ in range(SERVING["batches"]):
        images = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
        sizes = np.stack(
            [rng.integers(3 * h // 4, h + 1, b), rng.integers(2 * w // 3, w + 1, b)], 1
        ).astype(np.int32)
        sizes[0] = (h, w)
        batches.append((images, sizes))

    checks, check_nms, check_roi, _ = launch_checks()
    kernels.reset_launches()
    lat, counts = [], []
    for i, (images, sizes) in enumerate(batches):
        first = i == 0
        kernels.NMS.on_launch = check_nms if first else None
        kernels.ROI_ALIGN.on_launch = check_roi if first else None
        torch.cuda.synchronize()
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        dets, masks = pred(images, sizes, table)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t)
        counts.append(dets.valid.sum(1).tolist())
        check(dets.boxes.shape == (b, 100, 4) and masks.shape == (b, 100, 14, 14),
              f"teacher serving: unexpected shapes {dets.boxes.shape} {masks.shape}")
        check(np.isfinite(dets.boxes).all() and np.isfinite(dets.scores).all()
              and np.isfinite(masks).all(), "teacher serving: non-finite output")
        check(bool(dets.valid.any(1).all()), f"teacher serving: batch {i} has an image without detections")
        check(int(dets.labels[dets.valid].max()) < TEACHER_CLASSES, "teacher serving: a label off the table")
    kernels.NMS.on_launch = kernels.ROI_ALIGN.on_launch = None
    launches = {k.name: k.launches for k in kernels.ALL}
    peak = torch.cuda.max_memory_allocated()

    check(len(checks["nms"]) == 2 and all(m == 0 for m, _ in checks["nms"]),
          f"teacher serving: NMS launches differ from the plain version: {checks['nms']}")
    check(len(checks["roi_align"]) == 2
          and all(excess <= 0 for _, excess, _, _ in checks["roi_align"]),
          f"teacher serving: RoIAlign launches over tolerance: {checks['roi_align']}")
    check(launches["nms"] > 0 and launches["roi_align"] > 0 and launches["roi_align_backward"] == 0,
          f"teacher serving: a kernel of the path never launched, or the backward did: {launches}")
    steady = lat[1:]
    rec = dict(
        phase="teacher_serving", config=TEACHER, dtype="bfloat16", batch=b, image_hw=[h, w],
        classes=TEACHER_CLASSES, emb_pred_std=EMB_PRED_STD, setup_s=setup_s, batch_latency_s=lat,
        steady_images_per_s=b * len(steady) / sum(steady),
        steady_peak_memory_gb=peak / 1e9, valid_detections=counts, launches=launches,
        first_batch_checks={"nms_mismatches": [m for m, _ in checks["nms"]],
                            "nms_shapes": [n for _, n in checks["nms"]],
                            "roi_align_max_abs_err": [e for e, _, _, _ in checks["roi_align"]],
                            "roi_align_excess_over_limit": [x for _, x, _, _ in checks["roi_align"]],
                            "roi_align_rois": [r for _, _, _, r in checks["roi_align"]]},
    )
    emit(rec)
    results["teacher_serving"] = rec
    emit(dict(phase="teacher_serving_profile",
              **profile_groups(lambda: pred(*batches[-1], table))))


def phase_teacher_train(dev, results):
    from cvpr22_cross_modal_pseudo_labeling_torch import bridge
    from cvpr22_cross_modal_pseudo_labeling_torch.engine.train_step import Trainer
    from cvpr22_cross_modal_pseudo_labeling_torch.ops import kernels

    t0 = time.perf_counter()
    trainer = Trainer(TEACHER, TRAIN["opts"], device=dev, seed=SEED)
    trainer.load_flax_params(bridge.seeded_flax_params(trainer.model, SEED, EMB_PRED_STD))
    check(trainer.cfg.TPU.COMPUTE_DTYPE == "bfloat16", "the teacher config must run in bfloat16")
    setup_s = time.perf_counter() - t0
    model = trainer.model
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    frozen = [n for n, p in model.named_parameters() if not p.requires_grad]
    check(sorted(frozen) == sorted(n for n in start if n.startswith(TEACHER_FROZEN)),
          f"teacher train: the frozen parameters are not the stem, layer1 and emb_pred: {frozen[:5]}")
    buffers = {n: b.clone() for n, b in model.named_buffers()}

    rng = np.random.default_rng(SEED + 9)
    batches = [rcnn_batch(train_batch(rng, TRAIN["batch"], TRAIN["hw"], TRAIN["max_gt"], 1, 4, 1,
                                      TEACHER_CLASSES, model.statics.emb_dim))
               for _ in range(TRAIN["steps"] + 1)]
    checks, check_nms, check_roi, check_roi_bwd = launch_checks()
    kernels.reset_launches()
    lat, metrics = [], []
    for i, batch in enumerate(batches[:TRAIN["steps"]]):
        first = i == 0
        kernels.NMS.on_launch = check_nms if first else None
        kernels.ROI_ALIGN.on_launch = check_roi if first else None
        kernels.ROI_ALIGN_BACKWARD.on_launch = check_roi_bwd if first else None
        torch.cuda.synchronize()
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        m = trainer.step(batch)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t)
        metrics.append({k: float(v) for k, v in m.items()})
        check(all(np.isfinite(v) for v in metrics[-1].values()),
              f"teacher train: step {i} has a non-finite metric: {metrics[-1]}")
    kernels.NMS.on_launch = kernels.ROI_ALIGN.on_launch = kernels.ROI_ALIGN_BACKWARD.on_launch = None
    launches = {k.name: k.launches for k in kernels.ALL}
    peak = torch.cuda.max_memory_allocated()

    params = dict(model.named_parameters())
    unchanged = [n for n in start if n.startswith(TEACHER_TRAINED) and torch.equal(params[n], start[n])]
    moved = [n for n in frozen if not torch.equal(params[n], start[n])]
    moved += [n for n, b in model.named_buffers() if not torch.equal(b, buffers[n])]
    check(not unchanged, f"teacher train: trained parameters did not change: {unchanged[:5]}")
    check(not moved, f"teacher train: frozen parameters or buffers changed: {moved[:5]}")
    check(all(any(n.startswith(g) for n in start) for g in TEACHER_TRAINED + TEACHER_FROZEN),
          "teacher train: a parameter group is missing")
    check(len(checks["nms"]) == 1 and all(m == 0 for m, _ in checks["nms"]),
          f"teacher train: NMS launches differ from the plain version: {checks['nms']}")
    for key in ("roi_align", "roi_align_backward"):
        check(len(checks[key]) == 1 and all(excess <= 0 for _, excess, _, _ in checks[key]),
              f"teacher train: {key} launches over tolerance: {checks[key]}")
    check(all(v > 0 for v in launches.values()), f"teacher train: a kernel never launched: {launches}")
    steady = lat[1:]
    rec = dict(
        phase="teacher_train", config=TEACHER, dtype="bfloat16", batch=TRAIN["batch"],
        image_hw=list(TRAIN["hw"]), setup_s=setup_s, step_latency_s=lat,
        steady_step_s=sum(steady) / len(steady),
        steady_images_per_s=TRAIN["batch"] * len(steady) / sum(steady),
        steady_peak_memory_gb=peak / 1e9, launches=launches, metrics=metrics,
        gt_per_image=[int(v.sum()) for v in batches[0]["gt_valid"]],
        first_step_checks={
            "nms_mismatches": [m for m, _ in checks["nms"]],
            "nms_shapes": [n for _, n in checks["nms"]],
            **{f"{key}_{field}": [c[i] for c in checks[key]]
               for key in ("roi_align", "roi_align_backward")
               for i, field in enumerate(("max_abs_err", "excess_over_limit", "dtype", "rois"))}},
    )
    rec["host_syncs_per_step"] = count_syncs(lambda: trainer.step(batches[-1]))
    emit(rec)
    results["teacher_train"] = rec
    results["teacher_bwd_inputs"] = checks["roi_align_backward_inputs"]
    emit(dict(phase="teacher_train_profile", **profile_groups(lambda: trainer.step(batches[-1]))))


MMSS_KERNEL_GROUPS = (  # the MMSS step's device time: convs apart from the matmuls
    ("port: nms", ("nms_mask_kernel", "nms_scan_kernel")),
    ("port: roi_align", ("roi_align_fwd_kernel", "roi_align_bwd")),
    ("conv", ("implicit", "fprop", "dgrad", "wgrad", "conv", "winograd", "cudnn")),
    ("matmul", ("nvjet", "gemm", "cutlass", "xmma", "splitK")),
    ("softmax", ("softmax", "SoftMax")),
    ("layer norm", ("layer_norm", "LayerNorm")),
    ("sort / select", ("sort", "radix", "scan", "topk", "index", "gather", "scatter")),
    ("copy / cast", ("copy", "Memcpy", "Memset")),
    ("elementwise", ("elementwise",)),
    ("reduce", ("reduce",)),
)


def mmss_batch(rng, b, hw, tokens, vocab=30522):
    """A collated MMSS batch (``data/collate.py``'s caption keys): uint8
    images with sizes 3/4 to 1 of the bucket and captions of 8 to 40
    hashed word ids between the tokenizer's CLS (2) and SEP (3), padded
    to ``tokens``."""
    h, w = hw
    sizes = np.stack([rng.integers(3 * h // 4, h + 1, b), rng.integers(2 * w // 3, w + 1, b)],
                     1).astype(np.int32)
    sizes[0] = (h, w)
    lengths = rng.integers(min(8, tokens - 2), min(40, tokens - 2) + 1, b) + 2
    pos = np.arange(tokens)[None, :]
    att = (pos < lengths[:, None]).astype(np.int32)
    ids = np.where(att > 0, rng.integers(5, vocab, (b, tokens)), 0)
    ids[:, 0] = 2
    ids[np.arange(b), lengths - 1] = 3
    special = 1 - att + (pos == 0) + (pos == lengths[:, None] - 1)
    return dict(images=rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8), image_sizes=sizes,
                input_ids=ids.astype(np.int32), attention_mask=att,
                special_tokens_mask=special.astype(np.int32))


def small_mmss_trainer(device):
    """An MMSS Trainer on mmss.yaml's optimizer with a narrow float32
    model: the R-50-C5 body at stem 8, res2 16, width 4; a 2-layer BERT of
    width 64 over a vocabulary of 128; a 2-layer transformer head."""
    from cvpr22_cross_modal_pseudo_labeling_torch import bridge
    from cvpr22_cross_modal_pseudo_labeling_torch.engine.inference import load_cfg
    from cvpr22_cross_modal_pseudo_labeling_torch.engine.train_step import Trainer
    from cvpr22_cross_modal_pseudo_labeling_torch.models.detector.mmss_gcnn import (
        MMSSGridModel,
        mmss_statics_from_cfg,
    )

    opts = ["MODEL.RESNETS.STEM_OUT_CHANNELS", 8, "MODEL.RESNETS.RES2_OUT_CHANNELS", 16,
            "MODEL.RESNETS.WIDTH_PER_GROUP", 4, "TPU.COMPUTE_DTYPE", "float32", "MODEL.WEIGHT", ""]
    s = mmss_statics_from_cfg(load_cfg(MMSS_CONFIG, opts))
    s = s._replace(l_dim=64, spatial_dropout=14, vocab_size=128, bert_layers=2, bert_heads=4,
                   bert_intermediate=128,
                   transformer=s.transformer._replace(num_layers=2, num_heads=4, intermediate_size=64,
                                                      hidden_size=64, vocab_size=128))
    trainer = Trainer(MMSS_CONFIG, opts, device=device, seed=SEED, model=MMSSGridModel(s))
    tree = bridge.seeded_flax_params(trainer.model, SEED)
    tree["language_backbone"]["word_embeddings"] *= np.float32(30.0)  # O(1) grounding similarities
    trainer.load_flax_params(tree)
    return trainer


def phase_small_mmss_train(devices=("cuda", "cpu")):
    """The CUDA MMSS Trainer against the CPU one (whose plain PyTorch the
    CPU tests hold against the JAX train step) on one narrow float32 step
    with the same draws: losses and the gradient norm within 1e-4
    relative, every trainable parameter's update within 1e-3 of its norm
    plus an ulp of the weight per element, the frozen BERT bit for bit.
    No NMS or RoIAlign kernel launches."""
    from cvpr22_cross_modal_pseudo_labeling_torch.models.detector.mmss_gcnn import MMSSDraws
    from cvpr22_cross_modal_pseudo_labeling_torch.ops import kernels

    rng = np.random.default_rng(SEED + 11)
    batch = mmss_batch(rng, 3, (128, 128), 12, vocab=128)
    batch["image_sizes"][1:] = ((80, 100), (128, 96))
    draws = MMSSDraws(
        dropout=torch.from_numpy(rng.uniform(size=(3, 16)).astype(np.float32)),
        mlm_select=torch.from_numpy(rng.uniform(size=(3, 12)).astype(np.float32)),
        mlm_mask=torch.from_numpy(rng.uniform(size=(3, 12)).astype(np.float32)),
        mlm_ids=torch.from_numpy(rng.integers(0, 128, (3, 12))),
    )
    out = []
    kernels.reset_launches()
    for device in devices:
        trainer = small_mmss_trainer(device)
        before = {n: p.detach().cpu().clone() for n, p in trainer.model.named_parameters()}
        metrics = trainer.step(batch, draws._replace(**{k: getattr(draws, k).to(device) for k in (
            "dropout", "mlm_select", "mlm_mask", "mlm_ids")}))
        after = {n: p.detach().cpu() for n, p in trainer.model.named_parameters()}
        out.append(({k: float(v) for k, v in metrics.items()}, before, after))
    launches = {k.name: k.launches for k in kernels.ALL}
    (gm, gb, ga), (cm, cb, ca) = out
    loss_err = max(abs(gm[k] - cm[k]) / max(abs(cm[k]), 1e-6) for k in cm)
    excess = {}
    for n in ca:
        if n.startswith(MMSS_FROZEN):
            continue
        gu, cu = ga[n] - gb[n], ca[n] - cb[n]
        limit = 1e-3 * float(cu.norm()) + float(torch.from_numpy(np.spacing(cb[n].numpy())).norm())
        excess[n] = float((gu - cu).norm()) - limit
    worst = max(excess, key=excess.get)
    moved = [n for n in ga if n.startswith(MMSS_FROZEN) and not torch.equal(ga[n], gb[n])]
    check(all(np.isfinite(v) for v in gm.values()), f"small mmss train: non-finite metrics {gm}")
    check(not moved, f"small mmss train: the frozen BERT moved: {moved[:5]}")
    check(loss_err <= 1e-4 and excess[worst] <= 0,
          f"small mmss train: CUDA vs CPU loss {loss_err}, update excess {excess[worst]} ({worst})")
    check(all(v == 0 for v in launches.values()), f"small mmss train: a kernel launched: {launches}")
    emit(dict(phase="small_mmss_train", loss_rel_err=loss_err, worst_update=worst,
              worst_update_excess_over_limit=excess[worst], grad_norm_cuda=gm["grad_norm"],
              grad_norm_cpu=cm["grad_norm"], losses_cuda={k: gm[k] for k in sorted(gm)}))


def attention_ms(dev, statics, regions):
    """The device time of one step's attention blocks (fwd + bwd), each
    block run alone under the profiler at the step's shapes in bfloat16:
    the BERT's layers over [B, W] tokens, the transformer head's over the
    B matched pairs and, with its matching loss, over the B^2 pairs of
    [W + R] tokens.  Device time, not wall: a block alone is host-bound."""
    from cvpr22_cross_modal_pseudo_labeling_torch.models.language.bert import BertSelfAttention

    b, w = MMSS["batch"], MMSS["tokens"]
    s, t = statics, statics.transformer
    cases = [(s.bert_layers, s.bert_heads, b, w)]
    cases.append((t.num_layers, t.num_heads, b, w + regions))
    if t.mmm_loss == "cross_entropy":
        cases.append((t.num_layers, t.num_heads, b * b, w + regions))
    torch.manual_seed(SEED)
    total, parts = 0.0, []
    for layers, heads, n, tokens in cases:
        attn = BertSelfAttention(s.l_dim, heads, torch.bfloat16).to(dev)
        x = torch.randn(n, tokens, s.l_dim, device=dev, requires_grad=True)
        mask = torch.rand(n, tokens, device=dev) < 0.8
        cot = torch.randn(n, tokens, s.l_dim, device=dev, dtype=torch.bfloat16)
        prof = profile_groups(lambda: attn(x, mask).backward(cot), MMSS_KERNEL_GROUPS)
        parts.append(dict(layers=layers, heads=heads, sequences=n, tokens=tokens,
                          device_ms_per_layer=prof["device_ms"], groups_ms=prof["groups_ms"]))
        total += layers * prof["device_ms"]
    return total, parts


def phase_mmss_train(dev, results):
    """MMSS pretraining at full width in bfloat16: 3 SGD steps of 8 images
    at 800 x 1333 with 128-token captions."""
    from cvpr22_cross_modal_pseudo_labeling_torch import bridge
    from cvpr22_cross_modal_pseudo_labeling_torch.engine.train_step import Trainer
    from cvpr22_cross_modal_pseudo_labeling_torch.ops import kernels

    t0 = time.perf_counter()
    trainer = Trainer(MMSS_CONFIG, ["SOLVER.IMS_PER_BATCH", MMSS["batch"], "MODEL.WEIGHT", "", *MMSS["opts"]],
                      device=dev, seed=SEED)
    trainer.load_flax_params(bridge.seeded_flax_params(trainer.model, SEED))
    model = trainer.model
    s = model.statics
    check(trainer.cfg.TPU.COMPUTE_DTYPE == "bfloat16", "mmss train: the config must run in bfloat16")
    check(s.backbone.conv_body == "R-50-C5" and s.bert_layers == 12 and s.l_dim == 768
          and s.vocab_size == 30522 and s.transformer.num_layers == 6 and s.tie_vl,
          f"mmss train: not mmss.yaml's model: {s}")
    setup_s = time.perf_counter() - t0
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    buffers = {n: b.clone() for n, b in model.named_buffers()}
    check(sorted(n for n, lab in trainer.optimizer.labels.items() if lab == "frozen")
          == sorted(n for n in start if n.startswith(MMSS_FROZEN)),
          "mmss train: the frozen parameters are not the language backbone")

    rng = np.random.default_rng(SEED + 13)
    batches = [mmss_batch(rng, MMSS["batch"], MMSS["hw"], MMSS["tokens"]) for _ in range(MMSS["steps"] + 1)]
    kernels.reset_launches()
    lat, metrics = [], []
    for i, batch in enumerate(batches[:MMSS["steps"]]):
        torch.cuda.synchronize()
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        m = trainer.step(batch)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t)
        metrics.append({k: float(v) for k, v in m.items()})
        check(all(np.isfinite(v) for v in metrics[-1].values()),
              f"mmss train: step {i} has a non-finite metric: {metrics[-1]}")
    launches = {k.name: k.launches for k in kernels.ALL}
    peak = torch.cuda.max_memory_allocated()
    params = dict(model.named_parameters())
    unchanged = [n for n in start if n.startswith(MMSS_TRAINED) and n not in MMSS_STILL
                 and torch.equal(params[n], start[n])]
    moved = [n for n in start if n.startswith(MMSS_FROZEN) and not torch.equal(params[n], start[n])]
    moved += [n for n, b in model.named_buffers() if not torch.equal(b, buffers[n])]
    check(not unchanged, f"mmss train: trained parameters did not change: {unchanged[:5]}")
    check(not moved, f"mmss train: the frozen BERT or a buffer changed: {moved[:5]}")
    check(all(v == 0 for v in launches.values()), f"mmss train: a detector kernel launched: {launches}")
    steady = lat[1:]
    regions = min(s.spatial_dropout, -(-MMSS["hw"][0] // 32) * -(-MMSS["hw"][1] // 32))
    attn_ms, attn_parts = attention_ms(dev, s, regions)
    rec = dict(
        phase="mmss_train", config=MMSS_CONFIG, dtype="bfloat16", batch=MMSS["batch"],
        image_hw=list(MMSS["hw"]), caption_tokens=MMSS["tokens"], regions=regions, setup_s=setup_s,
        params_m=sum(p.numel() for p in model.parameters()) / 1e6, step_latency_s=lat,
        steady_step_s=sum(steady) / len(steady),
        steady_images_per_s=MMSS["batch"] * len(steady) / sum(steady),
        steady_peak_memory_gb=peak / 1e9, launches=launches, metrics=metrics,
        caption_lengths=batches[0]["attention_mask"].sum(1).tolist(),
        attention_device_ms=attn_ms, attention_parts=attn_parts,
    )
    rec["host_syncs_per_step"] = count_syncs(lambda: trainer.step(batches[-1]))
    emit(rec)
    results["mmss_train"] = rec
    emit(dict(phase="mmss_train_profile",
              **profile_groups(lambda: trainer.step(batches[-1]), MMSS_KERNEL_GROUPS)))


def host_libs():
    """What the eval path's host code finds on this machine: PIL, cv2, the
    libjpeg header and library the native decoder links, and g++."""
    import ctypes.util
    import importlib.util
    import shutil

    return {"PIL": importlib.util.find_spec("PIL") is not None,
            "cv2": importlib.util.find_spec("cv2") is not None,
            "jpeglib_h": os.path.exists("/usr/include/jpeglib.h"),
            "libjpeg": ctypes.util.find_library("jpeg"),
            "gxx": shutil.which("g++")}


def make_eval_tree():
    """The eval phase's tree, written by ``tools/synth_coco.py``."""
    import shutil

    shutil.rmtree(EVAL["tree"], ignore_errors=True)
    subprocess.run([sys.executable, "tools/synth_coco.py", "--out", EVAL["tree"],
                    "--train", str(EVAL["train"]), "--val", str(EVAL["val"]),
                    "--seed", str(EVAL["seed"])],
                   check=True, timeout=600)


def metrics_finite(metrics, dataset):
    """Every metric finite, except the AP50 of a class with no ground
    truth in the dataset, which must be the evaluator's NaN.  For the segm
    metrics a ground truth needs an inline segmentation: the evaluator
    drops the others (an OpenImages instance whose mask is a PNG)."""
    anns = list(dataset.coco.anns.values())
    names = {c: dataset.categories[c] for c in dataset.coco.get_cat_ids()}
    no_gt = {n for c, n in names.items() if not any(a["category_id"] == c for a in anns)}
    no_segm_gt = {n for c, n in names.items()
                  if not any(a["category_id"] == c and a.get("segmentation") for a in anns)}

    def allowed(k):
        return "AP50_class_" in k and k.split("AP50_class_")[-1] in (no_segm_gt if k.startswith("segm/") else no_gt)

    bad = [k for k, v in metrics.items() if not (np.isfinite(v) or (np.isnan(v) and allowed(k)))]
    return bad, len(no_gt)


def host_breakdown(pred, dataset, cfg):
    """The eval path's layers one at a time, on the first batch of
    ``dataset``: the loader's decode, resize and collate of 8 images on
    one thread, the forward alone (no host work beside it), and the COCO
    conversion (mask paste and RLE) of its detections on one thread and
    split by image over ``compute_on_dataset``'s thread pool, with the mean pasted
    box area."""
    import concurrent.futures as cf

    from cvpr22_cross_modal_pseudo_labeling_torch.data.collate import BatchCollator
    from cvpr22_cross_modal_pseudo_labeling_torch.engine import inference as inf

    b = cfg.TEST.IMS_PER_BATCH
    idx = list(range(b))
    t = time.perf_counter()
    batch = BatchCollator.from_cfg(cfg)([dataset[i] for i in idx])
    load_s = time.perf_counter() - t
    run = lambda: pred(batch["images"], batch["image_sizes"], dataset.class_emb_mtx)  # noqa: E731
    run()
    t = time.perf_counter()
    dets, masks = run()
    forward_s = time.perf_counter() - t
    t = time.perf_counter()
    out = inf._convert_batch(dataset, dets, masks, idx, batch["image_sizes"])
    convert_s = time.perf_counter() - t
    workers = min(8, os.cpu_count() or 1)  # compute_on_dataset's pool
    with cf.ThreadPoolExecutor(workers) as pool:
        t = time.perf_counter()
        split = list(pool.map(lambda i: inf._convert_batch(
            dataset, type(dets)(*(None if a is None else a[i:i + 1] for a in dets)), masks[i:i + 1], [i],
            batch["image_sizes"][i:i + 1]), idx))
        pool_s = time.perf_counter() - t
    check(sum(split, []) == out, "host breakdown: the pooled conversion differs from the serial one")
    return dict(images=b, cpus=os.cpu_count(), load_s_per_img=load_s / b,
                forward_alone_s_per_img=forward_s / b,
                convert_s_per_img=convert_s / b, convert_pool_workers=workers,
                convert_pool_s_per_img=pool_s / b, results=len(out),
                mean_box_area_px=float(np.mean([r["bbox"][2] * r["bbox"][3] for r in out])),
                mean_image_area_px=float(np.mean([dataset.get_img_info(i)["height"]
                                                  * dataset.get_img_info(i)["width"] for i in idx])))


def phase_eval(dev, results):
    """The port's test_net over the config's three test datasets of the
    synthetic tree, then one batch of the train loader."""
    import shutil

    from cvpr22_cross_modal_pseudo_labeling_torch.data import make_data_loader
    from cvpr22_cross_modal_pseudo_labeling_torch.data.collate import select_bucket
    from cvpr22_cross_modal_pseudo_labeling_torch.engine import inference as inf
    from cvpr22_cross_modal_pseudo_labeling_torch.ops import kernels
    from cvpr22_cross_modal_pseudo_labeling_torch.tools import test_net

    emit(dict(phase="host_libs", **host_libs()))
    t = time.perf_counter()
    make_eval_tree()
    tree_s = time.perf_counter() - t
    os.environ["CMPL_TPU_DATA_DIR"] = EVAL["tree"]
    shutil.rmtree(EVAL["out"], ignore_errors=True)
    cfg = inf.load_cfg(CONFIG, EVAL["opts"])
    check(cfg.TPU.COMPUTE_DTYPE == "bfloat16", "the eval config must run in bfloat16")
    divisible = max(cfg.DATALOADER.SIZE_DIVISIBILITY, 64)
    rungs = {tuple(hw) for hw in cfg.TPU.IMAGE_BUCKETS}

    checks, check_nms, check_roi, _ = launch_checks()
    batches, state = [], {}
    call, run_dataset = inf.Predictor.__call__, inf.compute_on_dataset

    def checked_call(self, images, image_sizes, class_embeddings):
        # each dataset's first batch (a new class table) and the first
        # batch of every launch shape are held against the plain version
        state["predictor"] = self
        first = state.pop("first", False)
        shapes = state.setdefault("shapes", set())
        checked = first or tuple(images.shape) not in shapes
        shapes.add(tuple(images.shape))
        kernels.NMS.on_launch = check_nms if checked else None
        kernels.ROI_ALIGN.on_launch = check_roi if checked else None
        out = call(self, images, image_sizes, class_embeddings)
        kernels.NMS.on_launch = kernels.ROI_ALIGN.on_launch = None
        sizes = np.asarray(image_sizes)
        batches.append(dict(shape=list(images.shape), dtype=str(images.dtype),
                            classes=int(class_embeddings.shape[0]), first=first, checked=checked,
                            bucket=list(select_bucket(int(sizes[:, 0].max()), int(sizes[:, 1].max()),
                                                      cfg.TPU.IMAGE_BUCKETS, divisible))))
        return out

    def marked_run(*args, **kw):
        state["first"] = True
        return run_dataset(*args, **kw)

    inf.Predictor.__call__, inf.compute_on_dataset = checked_call, marked_run
    kernels.reset_launches()
    t = time.perf_counter()
    try:
        metrics = test_net.main(["--config-file", CONFIG, "--device", dev.type, "--seed", str(SEED),
                                 *map(str, EVAL["opts"]), "OUTPUT_DIR", EVAL["out"]])
    finally:
        inf.Predictor.__call__, inf.compute_on_dataset = call, run_dataset
        kernels.NMS.on_launch = kernels.ROI_ALIGN.on_launch = None
    test_net_s = time.perf_counter() - t
    launches = {k.name: k.launches for k in kernels.ALL}

    n_sets = len(cfg.DATASETS.TEST)
    check(len(metrics) == n_sets == 3, f"eval: metrics for {list(metrics)}")
    check(sum(b["first"] for b in batches) == n_sets, f"eval: {len(batches)} batches, first flags wrong")
    checked = [b for b in batches if b["checked"]]
    check(len(checks["nms"]) == 2 * len(checked) and all(m == 0 for m, _ in checks["nms"]),
          f"eval: NMS launches differ from the plain version: {checks['nms']}")
    check(len(checks["roi_align"]) == 2 * len(checked)
          and all(excess <= 0 for _, excess, _, _ in checks["roi_align"]),
          f"eval: RoIAlign launches over tolerance: {checks['roi_align']}")
    check(any(b["shape"][0] < cfg.TEST.IMS_PER_BATCH for b in checked)
          and any(tuple(b["shape"][1:3]) in rungs for b in checked)
          and any(tuple(b["shape"][1:3]) not in rungs for b in checked),
          f"eval: no checked batch that is ragged, on a rung or on the fallback: {checked}")
    off = [b for b in batches if b["shape"][1:3] != b["bucket"] or b["dtype"] != "uint8"]
    check(not off, f"eval: batches off their bucket: {off}")
    check(launches["nms"] > 0 and launches["roi_align"] > 0 and launches["roi_align_backward"] == 0,
          f"eval: a kernel of the path never launched, or the backward did: {launches}")
    _, datasets = make_data_loader(cfg, is_train=False)
    per_set = {}
    for name, ds in zip(cfg.DATASETS.TEST, datasets):
        with open(os.path.join(EVAL["out"], f"predictions_{name}.json")) as f:
            preds = json.load(f)
        with open(os.path.join(EVAL["out"], f"metrics_{name}.json")) as f:
            saved = json.load(f)
        ids = set(ds.id_to_img_map.values())
        covered = {p["image_id"] for p in preds}
        check(covered == ids, f"eval {name}: {len(ids - covered)} images without a result")
        check(all("segmentation" in p for p in preds), f"eval {name}: a result without a mask")
        m = metrics[name]
        check("bbox/AP" in saved and "segm/AP" in saved, f"eval {name}: no bbox/AP or segm/AP")
        bad, no_gt = metrics_finite(saved, ds)
        check(not bad, f"eval {name}: non-finite metrics {bad[:5]}")
        per_set[name] = dict(
            results=len(preds), classes=len(ds.class_emb_mtx),
            classes_without_gt=no_gt, bbox_AP=m["bbox/AP"], segm_AP=m["segm/AP"],
            bbox_AP50=m["bbox/AP50"], segm_AP50=m["segm/AP50"],
            **{k[5:]: m[k] for k in m if k.startswith("time/")})
    n_batches = len(batches)
    rec = dict(phase="eval", config=CONFIG, dtype="bfloat16", tree_s=tree_s,
               test_net_s=test_net_s, batches=n_batches,
               shapes=sorted({tuple(b["shape"]) for b in batches}),
               checked_shapes=[b["shape"] for b in checked],
               on_rung=[tuple(b["shape"][1:3]) in rungs for b in batches],
               launches=launches,
               launches_per_batch={k: v / n_batches for k, v in launches.items()},
               datasets=per_set,
               evaluate_s=sum(d["evaluate_s"] for d in per_set.values()),
               launch_checks={
                   "nms_mismatches": [m for m, _ in checks["nms"]],
                   "nms_shapes": [n for _, n in checks["nms"]],
                   "roi_align_max_abs_err": [e for e, _, _, _ in checks["roi_align"]],
                   "roi_align_excess_over_limit": [x for _, x, _, _ in checks["roi_align"]],
                   "roi_align_rois": [r for _, _, _, r in checks["roi_align"]]})
    rec["host_breakdown"] = host_breakdown(state["predictor"], datasets[0], cfg)
    emit(rec)
    results["eval"] = rec

    tcfg = inf.load_cfg(CONFIG, [*EVAL["opts"], "SOLVER.IMS_PER_BATCH", EVAL["train_batch"],
                                 "SOLVER.MAX_ITER", 1])
    loader, ds = make_data_loader(tcfg, is_train=True)
    it = iter(loader)
    batch, idx = next(it)
    it.close()
    b = EVAL["train_batch"]
    shapes = {k: (list(v.shape), str(v.dtype)) for k, v in batch.items()}
    sizes = batch["image_sizes"]
    bucket = select_bucket(int(sizes[:, 0].max()), int(sizes[:, 1].max()), tcfg.TPU.IMAGE_BUCKETS, divisible)
    check(batch["images"].dtype == np.uint8 and batch["images"].shape == (b, *bucket, 3),
          f"train loader: images {shapes['images']}, bucket {bucket}")
    check(batch["gt_masks"].shape == (b, tcfg.TPU.MAX_GT, 28, 28) and batch["gt_masks"].dtype == np.float32
          and batch["gt_valid"].any(1).all() and batch["cap_mask"].all(),
          f"train loader: {shapes}")
    emit(dict(phase="eval_train_loader", dataset=type(ds).__name__, indices=list(idx),
              keys=shapes, gt_per_image=batch["gt_valid"].sum(1).tolist(),
              nouns_per_image=batch["cap_word_valid"].sum(1).tolist()))


SUSTAINED = re.compile(r"sustained: (\d+) steps, ([\d.]+) s wall, ([\d.]+) s/it, ([\d.]+) imgs/s/host, "
                       r"data-wait ([\d.]+)%")


def train_net_run(argv, out_dir):
    """One in-process ``train_net.main`` run: its record, the seconds it
    took, its peak memory and what its log and metrics file say."""
    from cvpr22_cross_modal_pseudo_labeling_torch.tools import train_net

    log_path = os.path.join(out_dir, "log.txt.rank0")
    offset = os.path.getsize(log_path) if os.path.exists(log_path) else 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    rec = train_net.main(argv + ["OUTPUT_DIR", out_dir])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    with open(log_path) as f:
        f.seek(offset)
        log = f.read()  # this run's lines
    with open(os.path.join(out_dir, "tb", "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f if line.strip()]
    summary = dict(seconds=seconds, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                   start_iter=rec["start_iter"], **rec["timing"])
    sustained = SUSTAINED.findall(log)
    if sustained:
        steps, wall, s_it, imgs, wait = sustained[-1]
        summary.update(steps=int(steps), wall_s=float(wall), s_per_it=float(s_it),
                       images_per_s=float(imgs), data_wait_pct=float(wait))
    return rec, summary, log, logged


def saved(out_dir):
    return {n: os.stat(os.path.join(out_dir, n)).st_mtime_ns
            for n in sorted(os.listdir(out_dir)) if n.startswith("model_")}


def checkpoint_costs(trainer, out_dir, iteration):
    """Bytes of one save of ``trainer``, the seconds a pipelined save
    stalls the loop (the copy to the host), the seconds its write takes,
    and the seconds a load and restore take."""
    from cvpr22_cross_modal_pseudo_labeling_torch.engine import checkpoint as ck

    torch.cuda.synchronize()
    t = time.perf_counter()
    path = ck.save_checkpoint(out_dir, ck.checkpoint_state(trainer, iteration), iteration, block=False)
    stall_s = time.perf_counter() - t
    ck.flush_pending_checkpoint()
    write_s = time.perf_counter() - t - stall_s
    t = time.perf_counter()
    ck.restore_trainer(trainer, ck.load_checkpoint(path), path)
    torch.cuda.synchronize()
    return dict(bytes=os.path.getsize(path), stall_s=stall_s, write_s=write_s,
                load_s=time.perf_counter() - t)


def same_metrics(a, b):
    keys = [k for k in a if not k.startswith("time/") and k != "total_eval_seconds"]
    return sorted(keys) == sorted(k for k in b if not k.startswith("time/") and k != "total_eval_seconds") and all(
        a[k] == b[k] or (np.isnan(a[k]) and np.isnan(b[k])) for k in keys)


def write_val_captions(tree):
    """``coco/annotations/captions_val2017.json`` over the tree's val
    images, two captions of its class names each (``tools/synth_coco.py``
    writes the train captions only); MMSS's validation-loss pass reads
    them."""
    coco = os.path.join(tree, "coco")
    with open(os.path.join(coco, "zero-shot/instances_val2017_all_2.json")) as f:
        blob = json.load(f)
    names = [c["name"] for c in blob["categories"]]
    anns = [{"id": 20_000_000 + 2 * i + k, "image_id": im["id"],
             "caption": f"a {names[(i + k) % len(names)]} next to a {names[(i + 2 * k + 1) % len(names)]}"}
            for i, im in enumerate(blob["images"]) for k in range(2)]
    with open(os.path.join(coco, "annotations/captions_val2017.json"), "w") as f:
        json.dump({"images": blob["images"], "annotations": anns}, f)


def phase_train_net(dev, results):
    """The port's train_net through the paper's three stages: MMSS
    pretraining (a checkpoint and the validation-loss pass), the teacher
    from the MMSS OUTPUT_DIR (first step checked, a resume, a finished
    relaunch), the student from the teacher's checkpoint with its BERT
    table from the MMSS OUTPUT_DIR, the in-training eval and the final
    test, and test_net on the student's checkpoint.  Runs on the eval
    phase's tree."""
    import shutil

    from cvpr22_cross_modal_pseudo_labeling_torch.data import make_data_loader
    from cvpr22_cross_modal_pseudo_labeling_torch.engine import checkpoint as ck
    from cvpr22_cross_modal_pseudo_labeling_torch.engine import inference as inf
    from cvpr22_cross_modal_pseudo_labeling_torch.engine.train_step import Trainer
    from cvpr22_cross_modal_pseudo_labeling_torch.ops import kernels
    from cvpr22_cross_modal_pseudo_labeling_torch.tools import test_net

    check(os.path.isdir(EVAL["tree"]), f"train_net: no tree at {EVAL['tree']} (the eval phase writes it)")
    os.environ["CMPL_TPU_DATA_DIR"] = EVAL["tree"]
    write_val_captions(EVAL["tree"])
    out = TRAIN_NET["out"]
    m_dir, t_dir, s_dir, e_dir = (os.path.join(out, d) for d in ("mmss", "teacher", "st", "test_net"))
    shutil.rmtree(out, ignore_errors=True)
    common = ["--device", dev.type, "--seed", str(SEED), *map(str, TRAIN_NET["opts"])]
    teacher_args = ["--config-file", TEACHER, "--skip-test", *common, "SOLVER.CHECKPOINT_PERIOD", "2",
                    "SOLVER.TEST_PERIOD", "0", "MODEL.WEIGHT", m_dir, "MODEL.LOAD_EMB_PRED_FROM_MMSS_HEAD", "True"]
    name = TRAIN_NET["dataset"]

    # the first teacher step's launches against the plain versions, and
    # the weights it starts from; every step's launches and batch shape
    # recorded, with its model
    checks, check_nms, check_roi, check_roi_bwd = launch_checks()
    step, per_step, imported = Trainer.train_step, [], {}

    def counted_step(self, b, draws=None):
        first = self.meta_arch == "GeneralizedRCNN" and not imported
        if first:
            imported.update({k: v.detach().cpu().clone() for k, v in self.model.state_dict().items()})
        kernels.NMS.on_launch = check_nms if first else None
        kernels.ROI_ALIGN.on_launch = check_roi if first else None
        kernels.ROI_ALIGN_BACKWARD.on_launch = check_roi_bwd if first else None
        before = {k.name: k.launches for k in kernels.ALL}
        try:
            return step(self, b, draws)
        finally:
            kernels.NMS.on_launch = kernels.ROI_ALIGN.on_launch = kernels.ROI_ALIGN_BACKWARD.on_launch = None
            per_step.append({"arch": self.meta_arch, "images": list(b["images"].shape),
                             **{k.name: k.launches - before[k.name] for k in kernels.ALL}})

    def steps_of(arch):
        return [p for p in per_step if p["arch"] == arch]

    kernels.reset_launches()
    runs = {}
    Trainer.train_step = counted_step
    try:
        # MMSS pretraining: 3 steps, a checkpoint at 2 and 3, the
        # validation-loss pass at 2 over coco_captions_val
        mmss_args = ["--config-file", MMSS_CONFIG, "--skip-test", *common, "MODEL.WEIGHT", "",
                     "SOLVER.MAX_ITER", "3", "SOLVER.CHECKPOINT_PERIOD", "2", "SOLVER.TEST_PERIOD", "2",
                     "TEST.IMS_PER_BATCH", "8"]
        rec, runs["mmss"], log, logged = train_net_run(mmss_args, m_dir)
        check([r["step"] for r in logged] == [1, 2, 3] and all(np.isfinite(v) for r in logged for v in r.values()),
              f"train_net mmss: logged {logged}")
        check(list(rec["val_losses"]) == [2] and np.isfinite(rec["val_losses"][2]) and "iter 2 val_loss" in log,
              f"train_net mmss: validation losses {rec['val_losses']}")
        check(list(saved(m_dir)) == ["model_0000002.pth", "model_0000003.pth"],
              f"train_net mmss: saves {list(saved(m_dir))}")
        mmss_steps = steps_of("MMSS-GCNN")
        check(len(mmss_steps) == 3 and all(p[k.name] == 0 for p in mmss_steps for k in kernels.ALL),
              f"train_net mmss: steps {mmss_steps}")
        runs["mmss"]["val_losses"] = rec["val_losses"]
        runs["mmss"]["checkpoint"] = checkpoint_costs(rec["trainer"], os.path.join(out, "costs_m"), 3)
        mmss_launches = {k.name: k.launches for k in kernels.ALL}
        del rec
        torch.cuda.empty_cache()
        mmss_ck = ck.load_checkpoint(os.path.join(m_dir, "model_0000003.pth"))["trainer"]["model"]

        rec, runs["teacher"], log, logged = train_net_run(teacher_args + ["SOLVER.MAX_ITER", "3"], t_dir)
        # the import: the trunk through layer3, the C5 layer4 onto the RoI
        # extractor and v2l onto emb_pred, bit for bit
        n_imported = re.search(r"imported (\d+) leaves from checkpoint \S+model_0000003.pth", log)
        trunk = [k for k in mmss_ck if k.startswith("backbone.body.") and not k.startswith("backbone.body.layer4.")
                 and k in imported]
        layer4 = {k.replace("backbone.body.", "roi_extractor."): v for k, v in mmss_ck.items()
                  if k.startswith("backbone.body.layer4.")}
        pairs = [(k, mmss_ck[k]) for k in trunk] + list(layer4.items()) + [
            ("box_predictor.emb_pred.weight", mmss_ck["v2l_projection.weight"]),
            ("box_predictor.emb_pred.bias", mmss_ck["v2l_projection.bias"])]
        landed = [k for k, v in pairs if torch.equal(imported[k], v)]
        check(n_imported and int(n_imported.group(1)) == len(pairs) == len(landed) and len(layer4) == 50,
              f"train_net teacher: imported {n_imported and n_imported.group(1)} leaves, expected {len(pairs)}, "
              f"{len(landed)} equal to the MMSS checkpoint's")
        runs["teacher"]["imported_leaves"] = len(pairs)
        teacher_steps = steps_of("GeneralizedRCNN")
        check([r["step"] for r in logged] == [1, 2, 3] and all(np.isfinite(r["total_loss"]) for r in logged),
              f"train_net teacher: logged {logged}")
        check(list(saved(t_dir)) == ["model_0000002.pth", "model_0000003.pth"]
              and ck.latest_checkpoint(t_dir).endswith("model_0000003.pth"),
              f"train_net teacher: saves {list(saved(t_dir))}, tag {ck.latest_checkpoint(t_dir)}")
        check(len(checks["nms"]) == 1 and all(m == 0 for m, _ in checks["nms"]),
              f"train_net teacher: NMS launches differ from the plain version: {checks['nms']}")
        for key in ("roi_align", "roi_align_backward"):
            check(len(checks[key]) == 1 and all(excess <= 0 for _, excess, _, _ in checks[key]),
                  f"train_net teacher: {key} launches over tolerance: {checks[key]}")
        want = {k: v / TRAIN["steps"] for k, v in results["teacher_train"]["launches"].items()}
        launched = [{k: p[k] for k in want} for p in teacher_steps]
        check(len(teacher_steps) == 3 and all(p == want for p in launched),
              f"train_net teacher: launches per step {launched}, teacher_train {want}")
        teacher_trainer = rec["trainer"]
        runs["teacher"]["checkpoint"] = checkpoint_costs(teacher_trainer, os.path.join(out, "costs_t"), 3)
        del rec, teacher_trainer

        # a resume adds the missing step only
        resume_args = teacher_args + ["SOLVER.MAX_ITER", "4", "MODEL.LOAD_TRAINER_STATE", "True"]
        rec, runs["resume"], log, logged = train_net_run(resume_args, t_dir)
        teacher_steps = steps_of("GeneralizedRCNN")
        check("resumed from " in log and f"{t_dir}/model_0000003.pth at iteration 3" in log
              and rec["start_iter"] == 3 and [r["step"] for r in logged] == [1, 2, 3, 4]
              and len(teacher_steps) == 4 and {k: teacher_steps[3][k] for k in want} == want,
              f"train_net resume: start {rec['start_iter']}, logged {[r['step'] for r in logged]}, "
              f"steps {teacher_steps[3:]}")
        before = saved(t_dir)
        del rec
        # a finished run relaunched trains nothing and writes nothing
        rec, runs["finished"], log, logged = train_net_run(resume_args, t_dir)
        check("training already complete" in log and rec["trainer"].optimizer.updates == 4
              and [r["step"] for r in logged] == [1, 2, 3, 4] and saved(t_dir) == before,
              f"train_net relaunch: updates {rec['trainer'].optimizer.updates}, saves {saved(t_dir)}")
        del rec
        torch.cuda.empty_cache()

        # the student from the teacher's OUTPUT_DIR, with the in-training
        # eval and the final test
        st_args = ["--config-file", CONFIG, *common, "MODEL.WEIGHT", t_dir, "MODEL.LANGUAGE_WEIGHT", m_dir,
                   "SOLVER.MAX_ITER", "2", "SOLVER.CHECKPOINT_PERIOD", "2", "SOLVER.TEST_PERIOD", "2",
                   "DATASETS.TEST", f"('{name}',)"]
        rec, runs["student"], log, logged = train_net_run(st_args, s_dir)
        st_import = re.search(r"imported (\d+) leaves from checkpoint \S+model_0000004.pth \((\d+) source", log)
        copied = re.search(r"prepare_model: copied (\d+) teacher leaves", log)
        check(st_import and int(st_import.group(2)) == 0 and copied and int(copied.group(1)) > 0,
              "train_net student: the teacher's checkpoint was not imported whole, or no leaf was copied")
        check("language table: imported 1 leaves" in log,
              "train_net student: the BERT table was not imported from the MMSS checkpoint")
        check([r["step"] for r in logged] == [1, 2] and all(np.isfinite(v) for r in logged for v in r.values()),
              f"train_net student: logged {logged}")
        teacher_ck = ck.load_checkpoint(os.path.join(t_dir, "model_0000004.pth"))["trainer"]["model"]
        st_ck = ck.load_checkpoint(os.path.join(s_dir, "model_0000002.pth"))["trainer"]["model"]
        bundle = [k for k in teacher_ck if k.startswith(("roi_extractor.", "box_predictor.", "mask_predictor."))]
        check(bundle and all(torch.equal(st_ck["teacher." + k], teacher_ck[k]) for k in bundle),
              "train_net student: its teacher bundle differs from the teacher checkpoint")
        check(torch.equal(st_ck["bert.word_embeddings"], mmss_ck["language_backbone.word_embeddings"]),
              "train_net student: its BERT table differs from the MMSS checkpoint's")
        del mmss_ck
        _, (val,) = make_data_loader(inf.load_cfg(CONFIG, ["DATASETS.TEST", f"('{name}',)"]), is_train=False)
        for label, metrics in (("in-training eval", rec["evals"].get(2, {}).get(name)),
                               ("run_test", rec["test"].get(name))):
            check(metrics is not None, f"train_net student: no {label} metrics")
            bad, _ = metrics_finite(metrics, val)
            check(not bad, f"train_net student: {label} has non-finite metrics {bad[:5]}")
        st_trainer, test_metrics = rec["trainer"], rec["test"][name]
        eval_s = {k: v["time/e2e_images_per_s"] for k, v in (("in_training", rec["evals"][2][name]),
                                                             ("run_test", test_metrics))}
        del rec
        runs["student"]["checkpoint"] = checkpoint_costs(st_trainer, os.path.join(out, "costs_s"), 2)
        del st_trainer
        torch.cuda.empty_cache()

        # test_net on the student's checkpoint: the same weights, data and
        # kernels as run_test
        t = time.perf_counter()
        got = test_net.main(["--config-file", CONFIG, "--device", dev.type, "--ckpt",
                             os.path.join(s_dir, "model_0000002.pth"), *map(str, TRAIN_NET["opts"]),
                             "DATASETS.TEST", f"('{name}',)", "OUTPUT_DIR", e_dir])
        test_net_s = time.perf_counter() - t
        check(same_metrics(got[name], test_metrics),
              "train_net: test_net --ckpt metrics differ from run_test's: "
              + str({k: (got[name][k], test_metrics.get(k)) for k in got[name]
                     if not k.startswith("time/") and got[name][k] != test_metrics.get(k)}))
    finally:
        Trainer.train_step = step
        shutil.rmtree(out, ignore_errors=True)
    launches = {k.name: k.launches for k in kernels.ALL}
    check(all(v > 0 for v in launches.values()), f"train_net: a kernel never launched: {launches}")
    step_s = {"teacher_train": results["teacher_train"]["steady_step_s"], "train": results["train"]["steady_step_s"],
              "mmss_train": results["mmss_train"]["steady_step_s"]}
    rec = dict(phase="train_net", dtype="bfloat16", batch=8, runs=runs, launches=launches,
               mmss_launches=mmss_launches,
               steps=per_step, trainer_step_alone_s=step_s,
               eval_images_per_s=eval_s, test_net_s=test_net_s,
               first_step_checks={
                   "nms_mismatches": [m for m, _ in checks["nms"]],
                   "nms_shapes": [n for _, n in checks["nms"]],
                   **{f"{key}_{field}": [c[i] for c in checks[key]]
                      for key in ("roi_align", "roi_align_backward")
                      for i, field in enumerate(("max_abs_err", "excess_over_limit", "dtype", "rois"))}})
    emit(rec)
    results["train_net"] = rec


def sampler_of(loader):
    """The ``DistributedSampler`` under a loader's batch samplers."""
    obj = loader.batch_sampler
    while not hasattr(obj, "repeat_factors"):
        obj = getattr(obj, "batch_sampler", None) or obj.sampler
    return obj


def phase_openimages(dev, results):
    """The Conceptual Captions -> OpenImages config pair through the port's
    entry points on a synthetic tree: the teacher (first step checked, the
    repeat-factor sampler), the student from the teacher's OUTPUT_DIR on
    the caption/detection mixture (every step checked), then test_net on
    openimages_zeroshot_val with the image-level filter, plain and with
    TEST.BBOX_AUG (each new bucket's first launches and each merge's NMS
    checked)."""
    import shutil

    from cvpr22_cross_modal_pseudo_labeling_torch.data import make_data_loader
    from cvpr22_cross_modal_pseudo_labeling_torch.data.evaluation import filter_predictions_imagelevel
    from cvpr22_cross_modal_pseudo_labeling_torch.engine import bbox_aug
    from cvpr22_cross_modal_pseudo_labeling_torch.engine import checkpoint as ck
    from cvpr22_cross_modal_pseudo_labeling_torch.engine import inference as inf
    from cvpr22_cross_modal_pseudo_labeling_torch.engine.train_step import Trainer
    from cvpr22_cross_modal_pseudo_labeling_torch.ops import kernels
    from cvpr22_cross_modal_pseudo_labeling_torch.ops import nms as nm
    from cvpr22_cross_modal_pseudo_labeling_torch.ops import roi_align as ra
    from cvpr22_cross_modal_pseudo_labeling_torch.tools import synth_openimages, test_net

    O = OPENIMAGES
    tree, out = O["tree"], O["out"]
    for d in (tree, out):
        shutil.rmtree(d, ignore_errors=True)
    t = time.perf_counter()
    wrote = synth_openimages.write_tree(tree, train=O["train"], val=O["val"], captions=O["captions"],
                                        seed=O["seed"])
    tree_s = time.perf_counter() - t
    os.environ["CMPL_TPU_DATA_DIR"] = tree
    t_dir, s_dir, e_dir, a_dir = (os.path.join(out, d) for d in ("teacher", "st", "test_net", "test_net_aug"))
    common = ["--device", dev.type, "--seed", str(SEED), *map(str, O["opts"]), "SOLVER.TEST_PERIOD", "0"]
    name = "openimages_zeroshot_val"

    tcfg = inf.load_cfg(OI_TEACHER, [*map(str, O["opts"]), "SOLVER.MAX_ITER", "3"])
    loader, t_ds = make_data_loader(tcfg, is_train=True)
    rf = sampler_of(loader).repeat_factors
    check(rf is not None and type(t_ds).__name__ == "OpenImagesDataset" and float(rf.max()) > 1,
          f"openimages: the teacher's sampler has no repeat factors above 1: {rf}")
    sampling = dict(images=len(t_ds), repeat_factor_max=float(rf.max()),
                    images_repeated=int((rf > 1).sum()), expected_draws_per_epoch=float(rf.sum()))
    del loader

    checks, check_nms, check_roi, check_roi_bwd = launch_checks()
    captured = {}
    step, per_step = Trainer.train_step, []
    nouns = tcfg.TPU.MAX_CAP_NOUNS

    def capture_roi(inputs, out_):
        # the pseudo boxes' pooling on a batch with caption images
        if inputs[1].shape[1] == nouns and captured.get("caption_step") and "pseudo_roi" not in captured:
            captured["pseudo_roi"] = inputs
        check_roi(inputs, out_)

    def counted_step(self, b, draws=None):
        arch = self.meta_arch
        det = b.get("det_mask")
        caption_rows = 0 if det is None else int((~det).sum())
        checked = arch == "STGeneralizedRCNN" or not any(p["arch"] == arch for p in per_step)
        captured["caption_step"] = caption_rows > 0
        kernels.NMS.on_launch = check_nms if checked else None
        kernels.ROI_ALIGN.on_launch = capture_roi if checked else None
        kernels.ROI_ALIGN_BACKWARD.on_launch = check_roi_bwd if checked else None
        before = {k.name: k.launches for k in kernels.ALL}
        try:
            return step(self, b, draws)
        finally:
            kernels.NMS.on_launch = kernels.ROI_ALIGN.on_launch = kernels.ROI_ALIGN_BACKWARD.on_launch = None
            per_step.append({"arch": arch, "images": list(b["images"].shape), "dtype": str(b["images"].dtype),
                             "caption_rows": caption_rows, "checked": checked,
                             **{k.name: k.launches - before[k.name] for k in kernels.ALL}})

    def steps_of(arch):
        return [p for p in per_step if p["arch"] == arch]

    def launches_of(rows):
        return {k.name: sum(p[k.name] for p in rows) for k in kernels.ALL}

    runs = {}
    Trainer.train_step = counted_step
    call, merge = inf.Predictor.__call__, bbox_aug.merge_and_filter
    try:
        # the teacher on the 200 seen classes: 3 steps of 8, first checked
        teacher_args = ["--config-file", OI_TEACHER, "--skip-test", *common, "SOLVER.MAX_ITER", "3",
                        "SOLVER.CHECKPOINT_PERIOD", "3"]
        rec, runs["teacher"], log, logged = train_net_run(teacher_args, t_dir)
        teacher_steps = steps_of("GeneralizedRCNN")
        check([r["step"] for r in logged] == [1, 2, 3] and all(np.isfinite(r["total_loss"]) for r in logged),
              f"openimages teacher: logged {logged}")
        check(rec["trainer"].class_tables["class_embeddings"].shape[0] == 201,
              "openimages teacher: the class table is not the 200 seen classes and the background")
        want = {k: v / TRAIN["steps"] for k, v in results["teacher_train"]["launches"].items()}
        check(len(teacher_steps) == 3 and all({k: p[k] for k in want} == want for p in teacher_steps)
              and all(p["images"][0] == 8 and p["dtype"] == "torch.uint8" for p in teacher_steps),
              f"openimages teacher: steps {teacher_steps}, teacher_train {want}")
        n_checked = dict(nms=len(checks["nms"]), roi_align=len(checks["roi_align"]),
                         roi_align_backward=len(checks["roi_align_backward"]))
        check(n_checked == {k: int(v) for k, v in want.items()},
              f"openimages teacher: first step's checked launches {n_checked}")
        runs["teacher"]["checkpoint"] = checkpoint_costs(rec["trainer"], os.path.join(out, "costs_t"), 3)
        runs["teacher"]["loss"] = [r["total_loss"] for r in logged]
        del rec
        torch.cuda.empty_cache()

        # the student from the teacher's OUTPUT_DIR on the mixture, every step checked
        st_args = ["--config-file", OI_STUDENT, "--skip-test", *common, "MODEL.WEIGHT", t_dir,
                   "SOLVER.MAX_ITER", str(O["student_steps"]), "SOLVER.CHECKPOINT_PERIOD", str(O["student_steps"])]
        rec, runs["student"], log, logged = train_net_run(st_args, s_dir)
        st_import = re.search(r"imported (\d+) leaves from checkpoint \S+model_0000003.pth \((\d+) source", log)
        check(st_import and int(st_import.group(2)) == 0 and "prepare_model: copied " in log,
              "openimages student: the teacher's checkpoint was not imported whole")
        st_steps = steps_of("STGeneralizedRCNN")
        check([r["step"] for r in logged] == list(range(1, O["student_steps"] + 1))
              and all(np.isfinite(v) for r in logged for v in r.values()),
              f"openimages student: logged {logged}")
        check(all(p["images"][0] == 8 and p["dtype"] == "torch.uint8" for p in st_steps)
              and any(0 < p["caption_rows"] < 8 for p in st_steps),
              f"openimages student: no uint8 batch of detection and caption images: {st_steps}")
        pseudo = [r["loss_classifier_pseudo"] for r, p in zip(logged, st_steps) if p["caption_rows"]]
        check(pseudo and all(v > 0 for v in pseudo),
              f"openimages student: loss_classifier_pseudo {pseudo} on the batches with caption images")
        check(rec["trainer"].class_tables["class_embeddings"].shape[0] == 201,
              "openimages student: the mixture's class table is not the detection set's")
        teacher_ck = ck.load_checkpoint(os.path.join(t_dir, "model_0000003.pth"))["trainer"]["model"]
        s_ckpt = os.path.join(s_dir, f"model_{O['student_steps']:07d}.pth")
        st_ck = ck.load_checkpoint(s_ckpt)["trainer"]["model"]
        bundle = [k for k in teacher_ck if k.startswith(("roi_extractor.", "box_predictor.", "mask_predictor."))]
        check(bundle and all(torch.equal(st_ck["teacher." + k], teacher_ck[k]) for k in bundle),
              "openimages student: its teacher bundle differs from the teacher checkpoint")
        del teacher_ck, st_ck
        runs["student"]["checkpoint"] = checkpoint_costs(rec["trainer"], os.path.join(out, "costs_s"), 3)
        runs["student"]["imported_leaves"] = int(st_import.group(1))
        runs["student"]["loss_classifier_pseudo"] = [r["loss_classifier_pseudo"] for r in logged]
        runs["student"]["total_loss"] = [r["total_loss"] for r in logged]
        del rec
        torch.cuda.empty_cache()
        train_checked = launches_of([p for p in per_step if p["checked"]])
        check(len(checks["nms"]) == train_checked["nms"] and all(m == 0 for m, _ in checks["nms"]),
              f"openimages train: NMS launches differ from the plain version: {checks['nms']}")
        for key in ("roi_align", "roi_align_backward"):
            check(len(checks[key]) == train_checked[key] and all(x <= 0 for _, x, _, _ in checks[key]),
                  f"openimages train: {key} launches over tolerance: {checks[key]}")
        check("pseudo_roi" in captured, "openimages student: no pseudo-box pooling on a batch with captions")
        train_checks = checks

        # test_net on the val set: the first batch and each new shape checked
        evals = {}
        for label, extra in (("plain", []), ("bbox_aug", [
                "TEST.BBOX_AUG.ENABLED", "True", "TEST.BBOX_AUG.H_FLIP", "True",
                "TEST.BBOX_AUG.SCALE_H_FLIP", "True", "TEST.BBOX_AUG.SCALES", str(O["scales"])])):
            checks, check_nms, check_roi, _ = launch_checks()
            merge_checks, check_merge, _, _ = launch_checks()
            batches, state, merges = [], {"shapes": set()}, []

            def checked_call(self, images, image_sizes, class_embeddings):
                first = not batches
                checked = first or tuple(images.shape) not in state["shapes"]
                state["shapes"].add(tuple(images.shape))

                def nms_hook(inputs, out_):
                    if inputs[5] is not None and "det_nms" not in captured and first and label == "plain":
                        captured["det_nms"] = inputs
                    check_nms(inputs, out_)

                kernels.NMS.on_launch = nms_hook if checked else None
                kernels.ROI_ALIGN.on_launch = check_roi if checked else None
                try:
                    r = call(self, images, image_sizes, class_embeddings)
                finally:
                    kernels.NMS.on_launch = kernels.ROI_ALIGN.on_launch = None
                batches.append(dict(shape=list(images.shape), dtype=str(images.dtype), checked=checked,
                                    classes=int(class_embeddings.shape[0])))
                return r

            def checked_merge(*args, **kw):
                def hook(inputs, out_):
                    if "merge_nms" not in captured or inputs[0].shape[0] > captured["merge_nms"][0].shape[0]:
                        captured["merge_nms"] = inputs
                    check_merge(inputs, out_)

                kernels.NMS.on_launch = hook
                before = kernels.NMS.launches
                try:
                    r = merge(*args, **kw)
                finally:
                    kernels.NMS.on_launch = None
                merges.append(dict(launches=kernels.NMS.launches - before, kept=len(r[0]),
                                   merged=sum(len(x) for x in args[1])))
                return r

            inf.Predictor.__call__, bbox_aug.merge_and_filter = checked_call, checked_merge
            before = {k.name: k.launches for k in kernels.ALL}
            out_dir = e_dir if label == "plain" else a_dir
            t = time.perf_counter()
            got = test_net.main(["--config-file", OI_STUDENT, "--device", dev.type, "--ckpt", s_ckpt,
                                 *map(str, O["opts"]), *extra, "OUTPUT_DIR", out_dir])
            test_s = time.perf_counter() - t
            inf.Predictor.__call__, bbox_aug.merge_and_filter = call, merge
            launches = {k.name: k.launches - before[k.name] for k in kernels.ALL}
            m = got[name]
            _, (ds,) = make_data_loader(inf.load_cfg(OI_STUDENT, []), is_train=False)
            with open(os.path.join(out_dir, f"predictions_{name}.json")) as f:
                preds = json.load(f)
            with open(os.path.join(out_dir, f"metrics_{name}.json")) as f:
                saved_m = json.load(f)
            per_image = {}
            for pr in preds:
                per_image[pr["image_id"]] = per_image.get(pr["image_id"], 0) + 1
            ids = set(ds.id_to_img_map.values())
            check(set(per_image) == ids and max(per_image.values()) <= 100,
                  f"openimages {label}: {len(ids - set(per_image))} images without a result, "
                  f"{max(per_image.values(), default=0)} results on one")
            bad, no_gt = metrics_finite(saved_m, ds)
            check(not bad, f"openimages {label}: non-finite metrics {bad[:5]}")
            kept = filter_predictions_imagelevel(preds, ds.imagelevel)
            dropped = len(preds) - len(kept)
            check(dropped > 0, f"openimages {label}: the image-level filter dropped no detection")
            checked = [b for b in batches if b["checked"]]
            check(all(b["classes"] == OI_CLASSES for b in batches),
                  f"openimages {label}: class tables {sorted({b['classes'] for b in batches})}")
            check(len(checks["nms"]) == 2 * len(checked) and all(x == 0 for x, _ in checks["nms"]),
                  f"openimages {label}: NMS launches differ from the plain version: {checks['nms']}")
            check(len(checks["roi_align"]) == 2 * len(checked)
                  and all(x <= 0 for _, x, _, _ in checks["roi_align"]),
                  f"openimages {label}: RoIAlign launches over tolerance: {checks['roi_align']}")
            rec_e = dict(test_net_s=test_s, batches=len(batches),
                         shapes=sorted({tuple(b["shape"]) for b in batches}),
                         checked_shapes=[b["shape"] for b in checked], launches=launches,
                         results=len(preds), categories=len({pr["category_id"] for pr in preds}),
                         results_per_image_min=min(per_image.values()),
                         results_per_image_max=max(per_image.values()),
                         imagelevel_dropped=dropped, imagelevel_kept=len(kept), classes_without_gt=no_gt,
                         bbox_AP=m["bbox/AP"], bbox_AP50=m["bbox/AP50"],
                         bbox_AP50_seen=m.get("bbox/AP50_split_seen"),
                         bbox_AP50_unseen=m.get("bbox/AP50_split_unseen"),
                         **{k[5:]: m[k] for k in m if k.startswith("time/")},
                         launch_checks={
                             "nms_mismatches": [x for x, _ in checks["nms"]],
                             "nms_shapes": [n for _, n in checks["nms"]],
                             "roi_align_max_abs_err": [e for e, _, _, _ in checks["roi_align"]],
                             "roi_align_excess_over_limit": [x for _, x, _, _ in checks["roi_align"]],
                             "roi_align_rois": [r for _, _, _, r in checks["roi_align"]]})
            if label == "plain":
                check("segm/AP" in m and "det_nms" in captured,
                      "openimages plain: no segm metrics, or no labelled detection NMS checked")
            else:
                check(not any(k.startswith("segm/") for k in m) and len(merges) == len(ids)
                      and all(x["launches"] == (1 if x["merged"] else 0) for x in merges)
                      and all(x == 0 for x, _ in merge_checks["nms"])
                      and len(merge_checks["nms"]) == sum(x["launches"] for x in merges)
                      and len(batches) == 6 * len(ids) and all(b["shape"][0] == 1 for b in batches),
                      f"openimages bbox_aug: merges {merges}, merge checks {merge_checks['nms']}, "
                      f"{len(batches)} calls")
                check(any(tuple(b["shape"][1:3]) not in {tuple(hw) for hw in tcfg.TPU.IMAGE_BUCKETS}
                          for b in checked), "openimages bbox_aug: no checked call on the fallback bucket")
                rec_e.update(merges=len(merges), merge_launches=sum(x["launches"] for x in merges),
                             merged_per_image=[x["merged"] for x in merges],
                             merge_nms_mismatches=[x for x, _ in merge_checks["nms"]])
            evals[label] = rec_e
            torch.cuda.empty_cache()
    finally:
        Trainer.train_step = step
        inf.Predictor.__call__, bbox_aug.merge_and_filter = call, merge
        kernels.NMS.on_launch = kernels.ROI_ALIGN.on_launch = kernels.ROI_ALIGN_BACKWARD.on_launch = None
        shutil.rmtree(out, ignore_errors=True)
    launches = {"teacher_train": launches_of(steps_of("GeneralizedRCNN")),
                "student_train": launches_of(steps_of("STGeneralizedRCNN")),
                "test_net": evals["plain"]["launches"], "test_net_bbox_aug": evals["bbox_aug"]["launches"]}
    check(all(launches["teacher_train"][k] > 0 for k in launches["teacher_train"])
          and launches["student_train"]["nms"] > 0 and launches["student_train"]["roi_align"] > 0
          and all(v["nms"] > 0 and v["roi_align"] > 0 for k, v in launches.items() if k.startswith("test_net")),
          f"openimages: a kernel of a path never launched: {launches}")

    # the new launch shapes, timed on their captured inputs
    shapes = {}
    for key, inputs in (("nms_detections_501_labels", captured["det_nms"]),
                        ("nms_bbox_aug_merge", captured["merge_nms"])):
        boxes, scores, valid, thr, k, labels = inputs
        idx, keep = nm.nms(*inputs)
        bound_ms, bound_by, _ = nms_bound(scores if scores.dim() == 2 else scores[None],
                                          valid if valid.dim() == 2 else valid[None],
                                          labels if labels.dim() == 2 else labels[None],
                                          idx if idx.dim() == 2 else idx[None],
                                          keep if keep.dim() == 2 else keep[None], k)
        shapes[key] = dict(shape=f"{'x'.join(map(str, boxes.shape[:-1]))} -> {k}, labels up to "
                                 f"{int(labels.max())}", kept=int(keep.sum()),
                           ms=cuda_ms(lambda: nm.nms(*inputs), 20),
                           plain_ms=cuda_ms(lambda: nm.nms_plain(*inputs), 3),
                           bound_ms=bound_ms, bound_by=bound_by)
    feats, rois, output_size, _, _, _, bin_stride = captured["pseudo_roi"]
    bound_ms, bound_by, _, _ = roi_bound(feats, rois, output_size, bin_stride)
    shapes["roi_align_pseudo_boxes"] = dict(
        shape=f"{rois.shape[0]} x {rois.shape[1]} on {list(feats.shape)} {feats.dtype}",
        ms=cuda_ms(lambda: ra.roi_align(*captured["pseudo_roi"]), 20),
        plain_ms=cuda_ms(lambda: ra.roi_align_plain(*captured["pseudo_roi"]), 3),
        bound_ms=bound_ms, bound_by=bound_by)
    captured.clear()
    rec = dict(phase="openimages", teacher=OI_TEACHER, student=OI_STUDENT, dtype="bfloat16", batch=8,
               tree=wrote, tree_s=tree_s, sampling=sampling, runs=runs, steps=per_step, evals=evals,
               launches=launches, new_shapes=shapes,
               train_checks={
                   "nms_mismatches": [x for x, _ in train_checks["nms"]],
                   "nms_shapes": [n for _, n in train_checks["nms"]],
                   **{f"{key}_{field}": [c[i] for c in train_checks[key]]
                      for key in ("roi_align", "roi_align_backward")
                      for i, field in enumerate(("max_abs_err", "excess_over_limit", "dtype", "rois"))}})
    emit(rec)
    results["openimages"] = rec
    shutil.rmtree(tree, ignore_errors=True)


def supervised_test(label, argv, out_dir, name, captured, per_batch=None):
    """One in-process ``test_net.main`` run with the first batch of each
    batch shape's launches held against the plain versions, the launch
    counts set to 0 just before and read just after, and the first
    checked detection NMS's inputs (and its candidates' rois, from the
    postprocessing's top-k) captured under ``captured[label]``.
    ``per_batch``: each kernel's launches a batch (default: a two-stage
    detector's).  Returns (metrics, launches, batches, checks,
    predictions, the metrics file)."""
    from cvpr22_cross_modal_pseudo_labeling_torch.engine import inference as inf
    from cvpr22_cross_modal_pseudo_labeling_torch.models.roi_heads import box_head
    from cvpr22_cross_modal_pseudo_labeling_torch.ops import kernels
    from cvpr22_cross_modal_pseudo_labeling_torch.tools import test_net

    checks, check_nms, check_roi, _ = launch_checks()
    batches, shapes = [], set()
    call, top_k = inf.Predictor.__call__, box_head.top_k
    state = {}

    def stable_top_k(x, k):
        # the detection candidates' order: roi = index // (C - 1)
        out = top_k(x, k)
        state["top_idx"] = out[1]
        return out

    def checked_call(self, images, image_sizes, class_embeddings=None, **kw):
        checked = tuple(images.shape) not in shapes
        shapes.add(tuple(images.shape))

        def nms_hook(inputs, out_):
            if inputs[5] is not None and label not in captured:
                captured[label] = (inputs, state.get("top_idx"), self.model.statics.num_classes)
            elif inputs[5] is None and f"{label}_rpn" not in captured:
                captured[f"{label}_rpn"] = inputs
            check_nms(inputs, out_)

        def roi_hook(inputs, out_):
            captured.setdefault(f"{label}_roi", inputs)
            check_roi(inputs, out_)

        kernels.NMS.on_launch = nms_hook if checked else None
        kernels.ROI_ALIGN.on_launch = roi_hook if checked else None
        try:
            r = call(self, images, image_sizes, class_embeddings, **kw)
        finally:
            kernels.NMS.on_launch = kernels.ROI_ALIGN.on_launch = None
        batches.append(dict(shape=list(images.shape), dtype=str(images.dtype), checked=checked,
                            classes=None if class_embeddings is None else int(class_embeddings.shape[0])))
        return r

    inf.Predictor.__call__, box_head.top_k = checked_call, stable_top_k
    kernels.reset_launches()
    t = time.perf_counter()
    try:
        got = test_net.main(argv + ["OUTPUT_DIR", out_dir])
    finally:
        inf.Predictor.__call__, box_head.top_k = call, top_k
    seconds = time.perf_counter() - t
    launches = {k.name: k.launches for k in kernels.ALL}
    with open(os.path.join(out_dir, f"predictions_{name}.json")) as f:
        preds = json.load(f)
    with open(os.path.join(out_dir, f"metrics_{name}.json")) as f:
        saved_m = json.load(f)
    # per batch (unless ``per_batch`` says otherwise): the RPN's and the
    # detections' NMS; the proposals' pooling and, with masks, the
    # detections'
    n_checked = sum(b["checked"] for b in batches)
    if per_batch is None:
        per_batch = {"nms": 2, "roi_align": 2 if "segm/AP" in got[name] else 1, "roi_align_backward": 0}
    check(launches == {k: v * len(batches) for k, v in per_batch.items()},
          f"supervised {label}: launches {launches} over {len(batches)} batches")
    check(len(checks["nms"]) == per_batch["nms"] * n_checked and all(x == 0 for x, _ in checks["nms"]),
          f"supervised {label}: NMS launches differ from the plain version: {checks['nms']}")
    check(len(checks["roi_align"]) == per_batch["roi_align"] * n_checked
          and all(x <= 0 for _, x, _, _ in checks["roi_align"]),
          f"supervised {label}: RoIAlign launches over tolerance: {checks['roi_align']}")
    return got[name], launches, batches, checks, preds, saved_m, seconds


def two_labels_one_roi(captured):
    """(candidate pairs, pairs with different boxes): the checked
    detection NMS's candidates that share a roi under two labels, whose
    class-specific boxes differ."""
    inputs, top_idx, num_classes = captured
    boxes, _, valid, _, _, labels = (x.cpu() if torch.is_tensor(x) else x for x in inputs)
    roi = (top_idx.cpu() // (num_classes - 1))
    pairs = differ = 0
    for b in range(boxes.shape[0]):
        for r in torch.unique(roi[b][valid[b]]):
            sel = (roi[b] == r) & valid[b]
            if int(sel.sum()) < 2 or len(torch.unique(labels[b][sel])) < 2:
                continue
            pairs += 1
            bx = boxes[b][sel]
            differ += int(not bool((bx == bx[:1]).all()))
    return pairs, differ


def phase_supervised(dev, results):
    """The class-specific R-50-C4 detectors and the top-k teachers:
    (a) the COCO Mask R-CNN through train_net and test_net on the eval
    phase's tree, (b) the VOC Faster R-CNN at batch 1 on a synth_voc
    tree, (c) SoftTeacher and UnbiasedTeacher Trainer steps on phase 8's
    batches; each path's launches counted from 0, the first step's or
    batch's (and each new batch shape's) held against the plain
    versions, and the new launch shapes timed on their captured inputs."""
    import shutil

    from cvpr22_cross_modal_pseudo_labeling_torch import bridge
    from cvpr22_cross_modal_pseudo_labeling_torch.data import make_data_loader
    from cvpr22_cross_modal_pseudo_labeling_torch.engine import inference as inf
    from cvpr22_cross_modal_pseudo_labeling_torch.engine.train_step import Trainer
    from cvpr22_cross_modal_pseudo_labeling_torch.ops import kernels
    from cvpr22_cross_modal_pseudo_labeling_torch.ops import nms as nm
    from cvpr22_cross_modal_pseudo_labeling_torch.ops import roi_align as ra
    from cvpr22_cross_modal_pseudo_labeling_torch.tools import synth_voc

    S = SUPERVISED
    out, voc_tree = S["out"], S["voc_tree"]
    for d in (out, voc_tree):
        shutil.rmtree(d, ignore_errors=True)
    check(os.path.isdir(EVAL["tree"]), f"supervised: no tree at {EVAL['tree']} (the eval phase writes it)")
    common = ["--device", dev.type, "--seed", str(SEED), *map(str, S["common"])]
    coco = [*common, *map(str, S["coco_opts"])]
    voc = [*common, *map(str, S["voc_opts"])]
    steps = str(S["steps"])
    captured, runs, launches, evals, all_checks = {}, {}, {}, {}, {}

    # every launch of the first training step checked, each step's counted
    step = Trainer.train_step
    per_step = []
    state = {"checks": None}

    def counted_step(self, b, draws=None):
        first = not per_step
        checks = state["checks"]
        kernels.NMS.on_launch = checks[1] if first else None
        kernels.ROI_ALIGN.on_launch = checks[2] if first else None
        kernels.ROI_ALIGN_BACKWARD.on_launch = checks[3] if first else None
        before = {k.name: k.launches for k in kernels.ALL}
        try:
            return step(self, b, draws)
        finally:
            kernels.NMS.on_launch = kernels.ROI_ALIGN.on_launch = kernels.ROI_ALIGN_BACKWARD.on_launch = None
            per_step.append({"images": list(b["images"].shape), "dtype": str(b["images"].dtype),
                             **{k.name: k.launches - before[k.name] for k in kernels.ALL}})

    def train(label, argv, out_dir, classes):
        per_step.clear()
        state["checks"] = launch_checks()
        kernels.reset_launches()
        rec, summary, _, logged = train_net_run(argv + ["SOLVER.MAX_ITER", steps], out_dir)
        path = {k.name: k.launches for k in kernels.ALL}
        trainer = rec["trainer"]
        checks = state["checks"][0]
        check(trainer.class_tables == {} and trainer.model.box_predictor.cls_score.weight.shape[0] == classes,
              f"supervised {label}: not a class-specific {classes}-class model without a class table")
        check([r["step"] for r in logged] == list(range(1, S["steps"] + 1))
              and all(np.isfinite(v) for r in logged for v in r.values()),
              f"supervised {label}: logged {logged}")
        check(len(per_step) == S["steps"] and all(p["dtype"] == "torch.uint8" for p in per_step)
              and all(path[k] == sum(p[k] for p in per_step) > 0 for k in path),
              f"supervised {label}: steps {per_step}, launches {path}")
        first = per_step[0]
        check(len(checks["nms"]) == first["nms"] and all(x == 0 for x, _ in checks["nms"]),
              f"supervised {label}: NMS launches differ from the plain version: {checks['nms']}")
        for key in ("roi_align", "roi_align_backward"):
            check(len(checks[key]) == first[key] and all(x <= 0 for _, x, _, _ in checks[key]),
                  f"supervised {label}: {key} launches over tolerance: {checks[key]}")
        summary.update(loss=[r["total_loss"] for r in logged], steps=list(per_step),
                       class_specific={k: list(v.shape) for k, v in trainer.model.state_dict().items()
                                       if k.startswith(("box_predictor.", "mask_predictor.mask_fcn_logits"))})
        runs[label], launches[f"{label}_train"], all_checks[f"{label}_train"] = summary, path, checks
        del rec, trainer
        torch.cuda.empty_cache()

    Trainer.train_step = counted_step
    try:
        # (a) COCO Mask R-CNN, 81 classes, on the eval tree's seen split
        os.environ["CMPL_TPU_DATA_DIR"] = EVAL["tree"]
        c_dir = os.path.join(out, "coco")
        train("coco", ["--skip-test", *coco], c_dir, 81)
        del all_checks["coco_train"]["roi_align_backward_inputs"]
        c_ckpt = os.path.join(c_dir, f"model_{S['steps']:07d}.pth")
        name = "coco_not_zeroshot_val"
        m, launches["coco_test"], batches, checks, preds, saved_m, test_s = supervised_test(
            "coco", ["--ckpt", c_ckpt, *coco], os.path.join(out, "coco_test"), name, captured)
        _, (ds,) = make_data_loader(inf.load_cfg("", [*map(str, S["coco_opts"])]), is_train=False)
        per_image = {}
        for pr in preds:
            per_image[pr["image_id"]] = per_image.get(pr["image_id"], 0) + 1
        ids = set(ds.id_to_img_map.values())
        check(set(per_image) == ids and max(per_image.values()) <= 100 and all("segmentation" in p for p in preds),
              f"supervised coco: {len(ids - set(per_image))} images without a result")
        bad, no_gt = metrics_finite(saved_m, ds)
        check(not bad and "segm/AP" in saved_m, f"supervised coco: non-finite metrics {bad[:5]}")
        check(batches[0]["classes"] is None and all(b["dtype"] == "uint8" for b in batches),
              f"supervised coco: batches {batches}")
        pairs, differ = two_labels_one_roi(captured["coco"])
        check(differ > 0, f"supervised coco: no checked detection NMS has one roi under two labels with "
                          f"different boxes ({pairs} shared rois)")
        evals["coco"] = dict(test_net_s=test_s, batches=len(batches), shapes=sorted({tuple(b["shape"]) for b in batches}),
                             results=len(preds), categories=len({p["category_id"] for p in preds}),
                             classes_without_gt=no_gt, rois_under_two_labels=pairs,
                             rois_under_two_labels_with_different_boxes=differ,
                             bbox_AP=m["bbox/AP"], bbox_AP50=m["bbox/AP50"], segm_AP=m["segm/AP"],
                             **{k[5:]: m[k] for k in m if k.startswith("time/")})
        all_checks["coco_test"] = checks

        # (b) VOC Faster R-CNN, 21 classes, batch 1, on a synth_voc tree
        t = time.perf_counter()
        wrote = synth_voc.write_tree(voc_tree, train=S["voc_train"], test=S["voc_test"], seed=SEED)
        tree_s = time.perf_counter() - t
        os.environ["CMPL_TPU_DATA_DIR"] = voc_tree
        v_dir = os.path.join(out, "voc")
        train("voc", ["--skip-test", *voc], v_dir, 21)
        captured["voc_backward"] = all_checks["voc_train"].pop("roi_align_backward_inputs")
        name = "voc_2007_test"
        m, launches["voc_test"], batches, checks, preds, saved_m, test_s = supervised_test(
            "voc", ["--ckpt", os.path.join(v_dir, f"model_{S['steps']:07d}.pth"), *voc], os.path.join(out, "voc_test"),
            name, captured)
        check(len(batches) == S["voc_test"] and all(b["shape"][0] == 1 for b in batches)
              and len({tuple(b["shape"]) for b in batches}) == sum(b["checked"] for b in batches) > 1,
              f"supervised voc: batches {batches}")
        check(all(np.isfinite(saved_m[k]) and saved_m[k] == m[k] for k in ("bbox/mAP", "bbox/mAP_07metric")),
              f"supervised voc: VOC metrics {saved_m.get('bbox/mAP')} {saved_m.get('bbox/mAP_07metric')}")
        evals["voc"] = dict(test_net_s=test_s, tree=wrote, tree_s=tree_s, batches=len(batches),
                            shapes=sorted({tuple(b["shape"]) for b in batches}), results=len(preds),
                            mAP=m["bbox/mAP"], mAP_07metric=m["bbox/mAP_07metric"],
                            **{k[5:]: m[k] for k in m if k.startswith("time/")})
        all_checks["voc_test"] = checks
    finally:
        Trainer.train_step = step
        kernels.NMS.on_launch = kernels.ROI_ALIGN.on_launch = kernels.ROI_ALIGN_BACKWARD.on_launch = None
        shutil.rmtree(out, ignore_errors=True)
        shutil.rmtree(voc_tree, ignore_errors=True)

    # (c) the top-k teachers on phase 8's batches, the same weights
    rng = np.random.default_rng(SEED + 4)
    emb_dim = inf.load_cfg(CONFIG, TRAIN["opts"]).MODEL.ROI_BOX_HEAD.EMB_DIM
    batches = [train_batch(rng, TRAIN["batch"], TRAIN["hw"], TRAIN["max_gt"], TRAIN["nouns"], TRAIN["noun_tokens"],
                           TRAIN["lvis"], TRAIN["classes"], emb_dim) for _ in range(S["baseline_steps"])]
    first_losses = {}
    for arch in ("SoftTeacher", "UnbiasedTeacher"):
        trainer = Trainer(CONFIG, [*TRAIN["opts"], "MODEL.META_ARCHITECTURE", arch], device=dev, seed=SEED)
        trainer.load_flax_params(bridge.seeded_flax_params(trainer.model, SEED, EMB_PRED_STD))
        check(type(trainer.model).__name__ == f"{arch}RCNN" and trainer.cfg.TPU.COMPUTE_DTYPE == "bfloat16",
              f"supervised {arch}: built {type(trainer.model).__name__}")
        checks, check_nms, check_roi, _ = launch_checks()
        key = "pseudo_roi"

        def roi_hook(inputs, out_):
            # the teacher masks' pooling of the 2 pseudo boxes an image
            if inputs[1].shape[1] == 2 and key not in captured:
                captured[key] = inputs
            check_roi(inputs, out_)

        kernels.reset_launches()
        lat, metrics = [], []
        torch.cuda.reset_peak_memory_stats()
        for i, batch in enumerate(batches):
            kernels.NMS.on_launch = check_nms if i == 0 else None
            kernels.ROI_ALIGN.on_launch = roi_hook if i == 0 else None
            torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                m = trainer.step(batch)
                torch.cuda.synchronize()
            finally:
                kernels.NMS.on_launch = kernels.ROI_ALIGN.on_launch = None
            lat.append(time.perf_counter() - t)
            metrics.append({k: float(v) for k, v in m.items()})
            if i == 0:
                first = {k.name: k.launches for k in kernels.ALL}
        path = {k.name: k.launches for k in kernels.ALL}
        check(all(np.isfinite(v) for r in metrics for v in r.values()),
              f"supervised {arch}: a non-finite metric {metrics}")
        check(len(checks["nms"]) == first["nms"] > 0 and all(x == 0 for x, _ in checks["nms"]),
              f"supervised {arch}: NMS launches differ from the plain version: {checks['nms']}")
        check(len(checks["roi_align"]) == first["roi_align"] > 0 and all(x <= 0 for _, x, _, _ in checks["roi_align"]),
              f"supervised {arch}: RoIAlign launches over tolerance: {checks['roi_align']}")
        check(path["roi_align_backward"] == 0 and key in captured,
              f"supervised {arch}: launches {path}, pseudo boxes pooled: {key in captured}")
        first_losses[arch] = metrics[0]
        label = {"SoftTeacher": "soft_teacher", "UnbiasedTeacher": "unbiased_teacher"}[arch]
        runs[label] = dict(step_latency_s=lat, steady_step_s=lat[-1], peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                           metrics=metrics)
        launches[f"{label}_train"], all_checks[f"{label}_train"] = path, checks
        del trainer
        torch.cuda.empty_cache()
    soft, unbiased = (first_losses[a]["loss_classifier_pseudo"] for a in ("SoftTeacher", "UnbiasedTeacher"))
    check(soft != unbiased, f"supervised: loss_classifier_pseudo {soft} equal for both teachers")

    # the new launch shapes, timed on their captured inputs
    shapes = {}
    for key, inputs in (("nms_detections_81_classes", captured["coco"][0]), ("nms_voc_rpn_test", captured["voc_rpn"]),
                        ("nms_voc_detections", captured["voc"][0])):
        inputs = tuple(x.to(dev) if torch.is_tensor(x) else x for x in inputs)
        boxes, scores, valid, thr, k, labels = inputs
        idx, keep = nm.nms(*inputs)
        bound_ms, bound_by, _ = nms_bound(scores, valid, labels, idx, keep, k)
        shapes[key] = dict(shape=f"{'x'.join(map(str, boxes.shape[:-1]))} -> {k}"
                                 + (f", labels up to {int(labels.max())}" if labels is not None else ""),
                           kept=int(keep.sum()), ms=cuda_ms(lambda: nm.nms(*inputs), 20),
                           plain_ms=cuda_ms(lambda: nm.nms_plain(*inputs), 3), bound_ms=bound_ms, bound_by=bound_by)
    for key, inputs in (("roi_align_voc_test", captured["voc_roi"]), ("roi_align_pseudo_boxes_top2", captured["pseudo_roi"])):
        inputs = tuple(x.to(dev) if torch.is_tensor(x) else x for x in inputs)
        feats, rois, output_size, _, _, _, bin_stride = inputs
        bound_ms, bound_by, _, _ = roi_bound(feats, rois, output_size, bin_stride)
        shapes[key] = dict(shape=f"{rois.shape[0]} x {rois.shape[1]} on {list(feats.shape)} {feats.dtype}",
                           ms=cuda_ms(lambda: ra.roi_align(*inputs), 20),
                           plain_ms=cuda_ms(lambda: ra.roi_align_plain(*inputs), 3),
                           bound_ms=bound_ms, bound_by=bound_by)
    args = tuple(x.to(dev) if torch.is_tensor(x) else x for x in captured["voc_backward"])
    grad, rois, shape, _, output_size, _, _, _, bin_stride = args
    bound_ms, bound_by, _ = roi_bwd_bound(grad, rois, shape, output_size, bin_stride)
    shapes["roi_align_backward_voc_train"] = dict(
        shape=f"{rois.shape[0]} x {rois.shape[1]} on {list(shape)} {grad.dtype}",
        ms=cuda_ms(lambda: ra.roi_align_backward(*args), 20),
        plain_ms=cuda_ms(lambda: ra.roi_align_backward_plain(*args), 3), bound_ms=bound_ms, bound_by=bound_by)
    captured.clear()

    rec = dict(phase="supervised", dtype="bfloat16", coco_batch=8, voc_batch=1, runs=runs, evals=evals,
               launches=launches, new_shapes=shapes, checks={k: check_lists(v) for k, v in all_checks.items()},
               loss_classifier_pseudo={"SoftTeacher": soft, "UnbiasedTeacher": unbiased})
    emit(rec)
    results["supervised"] = rec


# the R-50-FPN body over the shipped teacher and student-teacher configs
# (the port's config.R50_FPN_OPTS) at full width in bfloat16, batches of 8
# at 800 x 1333; train_net and test_net on the eval phase's tree, outputs
# under build/fpn_out (deleted at the end of the phase)
FPN_PHASE = dict(batches=3, steps=3, student_steps=2, out="build/fpn_out", timing_iters=10)
FPN_SCALES = (0.25, 0.125, 0.0625, 0.03125)
FPN_TRAINED = ("backbone.fpn.", "backbone.body.layer2.", "backbone.body.layer3.", "backbone.body.layer4.",
               "rpn_head.", "roi_extractor.", "box_predictor.bbox_pred.", "mask_predictor.")


def roi_level_taps(feature_shapes, rois, levels, output_size, scales, sampling_ratio):
    """Per level, (taps, distinct positions) of the rois on that level: a
    tap is a (nonzero A_y entry, nonzero A_x entry) pair of a bin (as
    ``roi_taps``); the distinct positions are the union, over the level's
    rois of each image, of the feature cells they read (all a pooling of
    those rois needs of the map)."""
    from cvpr22_cross_modal_pseudo_labeling_torch.ops import roi_align as ra

    P, Q = output_size
    out = []
    for lvl, ((B, H, W, _), scale) in enumerate(zip(feature_shapes, scales)):
        (sh, bh, gh, ch), (sw, bw, gw, cw) = ra._roi_geometry(rois, scale, P, Q, H, W, sampling_ratio, 8)
        taps = cells = 0.0
        for bi in range(B):
            r = torch.nonzero(levels[bi] == lvl).flatten()
            if r.numel() == 0:
                continue
            ay = ra._axis_interp_matrix(sh[bi, r], bh[bi, r], gh[bi, r], H, P, ch, 1) != 0  # [S, P, H]
            ax = ra._axis_interp_matrix(sw[bi, r], bw[bi, r], gw[bi, r], W, Q, cw, 1) != 0  # [S, Q, W]
            taps += float((ay.sum((1, 2)).double() * ax.sum((1, 2)).double()).sum())
            # a roi reads the cells (y, x) of every row y and column x it taps
            rows, cols = ay.any(1).float(), ax.any(1).float()  # [S, H], [S, W]
            cells += float(((rows.T @ cols) > 0).sum())
        out.append((taps, cells))
    return out


def bound_of(byts, ops):
    """(ms, bound_by): the larger of bytes over the memory rate and
    float32 operations over the peak rate."""
    t_bytes, t_ops = byts / H100_BYTES_PER_S, ops / H100_F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def roi_levels_bound(features, rois, levels, output_size, scales, sampling_ratio):
    """The multi-level forward's bound: of each level's map the cells its
    rois read (the union over each image's rois on that level, once each),
    the rois and levels read once, the one output written once; two flops
    per (tap, channel) of each roi on its own level."""
    C, es = features[0].shape[3], features[0].element_size()
    per_level = roi_level_taps([f.shape for f in features], rois, levels, output_size, scales, sampling_ratio)
    taps = sum(t for t, _ in per_level)
    cells = sum(c for _, c in per_level)
    out_el = rois.shape[0] * rois.shape[1] * output_size[0] * output_size[1] * C
    byts = (cells * C + out_el) * es + rois.numel() * 4 + levels.numel() * 4
    return bound_of(byts, 2.0 * taps * C)


def roi_level_bwd_work(grad, rois, levels, level, feature_shape, output_size, scale, sampling_ratio):
    """One level's backward (bytes, operations): the cotangent rows of its
    rois, its rois and levels read once, its dF (the whole map) written
    once; two flops per (tap, channel)."""
    C, es = feature_shape[3], grad.element_size()
    mine = int((levels == level).sum())
    per_row = output_size[0] * output_size[1] * C
    ((taps, _),) = roi_level_taps([feature_shape], rois, torch.where(levels == level, 0, -1), output_size,
                                  (scale,), sampling_ratio)
    byts = (mine * per_row + int(np.prod(feature_shape))) * es + rois.numel() * 4 + levels.numel() * 4
    return byts, 2.0 * taps * C


def fpn_capture(checks, check_nms, check_roi, check_roi_bwd, captured, tag):
    """Launch hooks that check every launch against its plain version and
    keep, under ``captured[tag]``, the inputs of each NMS shape and of
    each level-filtered RoIAlign launch (forward by roi count, backward
    by level)."""
    def nms(inputs, out):
        key = (inputs[0].shape[0], inputs[0].shape[1], inputs[4])
        captured.setdefault(tag, {}).setdefault(("nms",) + key, inputs)
        check_nms(inputs, out)

    def roi(inputs, out):
        if len(inputs) > 7:
            group = captured.setdefault(tag, {}).setdefault(("roi_align", inputs[1].shape[1]), {})
            group.setdefault(inputs[8], inputs)
        check_roi(inputs, out)

    def bwd(inputs, out):
        if len(inputs) > 9:
            captured.setdefault(tag, {}).setdefault(("roi_align_backward", inputs[10]), inputs)
        check_roi_bwd(inputs, out)

    return nms, roi, bwd


def fpn_steps(run, batches, checked, hooks):
    """Runs ``run`` over ``batches`` with the launch hooks on for the
    first ``checked``; returns (latencies, outputs, launches of the first
    call, peak memory of the steady calls)."""
    from cvpr22_cross_modal_pseudo_labeling_torch.ops import kernels

    lat, outs, first = [], [], None
    kernels.reset_launches()
    for i, batch in enumerate(batches):
        on = i < checked
        kernels.NMS.on_launch, kernels.ROI_ALIGN.on_launch, kernels.ROI_ALIGN_BACKWARD.on_launch = (
            hooks if on else (None, None, None))
        torch.cuda.synchronize()
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        try:
            outs.append(run(batch))
            torch.cuda.synchronize()
        finally:
            kernels.NMS.on_launch = kernels.ROI_ALIGN.on_launch = kernels.ROI_ALIGN_BACKWARD.on_launch = None
        lat.append(time.perf_counter() - t)
        if i == 0:
            first = {k.name: k.launches for k in kernels.ALL}
    launches = {k.name: k.launches for k in kernels.ALL}
    return lat, outs, first, launches, torch.cuda.max_memory_allocated() / 1e9


def check_lists(checks):
    return {"nms_mismatches": [x for x, _ in checks["nms"]], "nms_shapes": [n for _, n in checks["nms"]],
            **{f"{key}_{field}": [c[i] for c in checks[key]]
               for key in ("roi_align", "roi_align_backward")
               for i, field in enumerate(("max_abs_err", "excess_over_limit", "dtype", "rois"))}}


def check_all_passed(label, checks, first, nms, roi, bwd):
    check(len(checks["nms"]) == first["nms"] == nms and all(x == 0 for x, _ in checks["nms"]),
          f"fpn {label}: NMS launches {first['nms']} (want {nms}) or mismatches {checks['nms']}")
    check(len(checks["roi_align"]) == first["roi_align"] == roi
          and all(x <= 0 for _, x, _, _ in checks["roi_align"]),
          f"fpn {label}: RoIAlign launches {first['roi_align']} (want {roi}) or errors {checks['roi_align']}")
    check(len(checks["roi_align_backward"]) == first["roi_align_backward"] == bwd
          and all(x <= 0 for _, x, _, _ in checks["roi_align_backward"]),
          f"fpn {label}: backward launches {first['roi_align_backward']} (want {bwd}) "
          f"or errors {checks['roi_align_backward']}")


def checked_serving(dev, phase, config, opts, classes, seed, label, per_batch, mask_size, n, capture, rec):
    """A ``Predictor`` on ``config`` with ``opts`` (and ``SERVING``'s) and
    seeded weights serves ``n`` uint8 batches of ``SERVING``'s shape with a
    random class table of ``classes`` rows.  Every launch of the first
    batch is held against its plain version through the hooks
    ``capture(checks, hooks, label)`` gives; the first batch must launch
    ``per_batch`` (NMS, RoIAlign, backward) and every batch as many. Each
    image gets detections, every box, score and mask is finite, masks are
    ``mask_size`` square (None: no masks).  Records the run, launches and
    checks under ``rec`` and emits ``{phase}_{label}``.  Returns (the
    predictor, its last batch, the table)."""
    from cvpr22_cross_modal_pseudo_labeling_torch import bridge
    from cvpr22_cross_modal_pseudo_labeling_torch.engine.inference import Predictor

    b, (h, w) = SERVING["batch"], SERVING["hw"]
    pred = Predictor(config, list(opts) + list(SERVING["opts"]), device=dev)
    pred.load_flax_params(bridge.seeded_flax_params(pred.model, SEED, EMB_PRED_STD))
    check(pred.cfg.TPU.COMPUTE_DTYPE == "bfloat16", f"{phase} {label}: {pred.cfg.TPU.COMPUTE_DTYPE}")
    rng = np.random.default_rng(seed)
    emb_dim = getattr(pred.model.statics, "base", pred.model.statics).emb_dim
    table = rng.standard_normal((classes, emb_dim)).astype(np.float32)
    table[0] = 0.0
    batches = []
    for _ in range(n):
        sizes = np.stack([rng.integers(3 * h // 4, h + 1, b), rng.integers(2 * w // 3, w + 1, b)], 1)
        sizes[0] = (h, w)
        batches.append((rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8), sizes.astype(np.int32)))
    checks, *hooks = launch_checks()
    lat, outs, first, path, peak = fpn_steps(lambda x: pred(x[0], x[1], table), batches, 1,
                                             capture(checks, hooks, label))
    d = pred.cfg.MODEL.ROI_HEADS.DETECTIONS_PER_IMG
    for i, (dets, masks) in enumerate(outs):
        check(dets.boxes.shape == (b, d, 4) and (masks is None if mask_size is None
                                                 else masks.shape == (b, d, mask_size, mask_size)),
              f"{phase} {label}: shapes {dets.boxes.shape} {None if masks is None else masks.shape}")
        check(np.isfinite(dets.boxes).all() and np.isfinite(dets.scores).all()
              and (masks is None or np.isfinite(masks).all()), f"{phase} {label}: non-finite output")
        check(bool(dets.valid.any(1).all()), f"{phase} {label}: batch {i} has an image without detections")
    check_all_passed(label, checks, first, *per_batch)
    check(path == {k: v * n for k, v in first.items()},
          f"{phase} {label}: launches {path} over {n} batches, first {first}")
    steady = lat[1:]
    rec["runs"][label] = dict(batch_latency_s=lat, steady_images_per_s=b * len(steady) / sum(steady),
                              steady_peak_memory_gb=peak, valid_detections=[x.valid.sum(1).tolist() for x, _ in outs])
    rec["launches"][label], rec["checks"][label] = path, checks
    emit(dict(phase=f"{phase}_{label}", launches=path, first_launches=first, **rec["runs"][label]))
    return pred, batches[-1], table


def checked_training(dev, phase, config, opts, classes, seed, label, per_step, trained, frozen_ok, n, capture, rec,
                     rcnn=True, still=()):
    """A ``Trainer`` on ``config`` with ``opts`` (and ``TRAIN``'s) and
    seeded weights takes ``n`` steps on ``TRAIN``-shaped batches (the
    ``GeneralizedRCNN`` keys alone when ``rcnn``).  Every launch of the
    first step is held against its plain version through ``capture``'s
    hooks; the first step launches ``per_step`` and every step as many.
    Metrics finite, every parameter under the prefixes ``trained`` changes
    (but those in ``still``), the frozen ones (``frozen_ok(frozen,
    names)`` says which) and the buffers stay bit-identical.  Records
    under ``rec`` and emits ``{phase}_{label}``.  Returns (the trainer,
    its last batch)."""
    from cvpr22_cross_modal_pseudo_labeling_torch import bridge
    from cvpr22_cross_modal_pseudo_labeling_torch.engine.train_step import Trainer

    trainer = Trainer(config, list(opts) + list(TRAIN["opts"]), device=dev, seed=SEED)
    trainer.load_flax_params(bridge.seeded_flax_params(trainer.model, SEED, EMB_PRED_STD))
    model = trainer.model
    start = {k: p.detach().clone() for k, p in model.named_parameters()}
    frozen = [k for k, p in model.named_parameters() if not p.requires_grad]
    check(frozen_ok(frozen, list(start)), f"{phase} {label}: unexpected frozen parameters {frozen[:5]}")
    buffers = {k: x.clone() for k, x in model.named_buffers()}
    rng = np.random.default_rng(seed)
    batches = [train_batch(rng, TRAIN["batch"], TRAIN["hw"], TRAIN["max_gt"], TRAIN["nouns"],
                           TRAIN["noun_tokens"], TRAIN["lvis"], classes,
                           getattr(model.statics, "base", model.statics).emb_dim)
               for _ in range(n)]
    if rcnn:
        batches = [rcnn_batch(x) for x in batches]
    checks, *hooks = launch_checks()
    lat, outs, first, path, peak = fpn_steps(trainer.step, batches, 1, capture(checks, hooks, label))
    metrics = [{k: float(v) for k, v in m.items()} for m in outs]
    check(all(np.isfinite(v) for m in metrics for v in m.values()),
          f"{phase} {label}: non-finite metrics {metrics}, step latency {lat}, peak {peak} GB")
    params = dict(model.named_parameters())
    unchanged = [k for k in start if k.startswith(trained) and k not in still and torch.equal(params[k], start[k])]
    moved = [k for k in frozen if not torch.equal(params[k], start[k])]
    moved += [k for k, x in model.named_buffers() if not torch.equal(x, buffers[k])]
    check(not unchanged, f"{phase} {label}: trained parameters did not change: {unchanged[:5]}")
    check(not moved, f"{phase} {label}: frozen parameters or buffers changed: {moved[:5]}")
    check_all_passed(label, checks, first, *per_step)
    check(path == {k: v * n for k, v in first.items()}, f"{phase} {label}: launches {path} over {n} steps, first {first}")
    steady = lat[1:]
    rec["runs"][label] = dict(step_latency_s=lat, steady_step_s=sum(steady) / len(steady),
                              steady_images_per_s=TRAIN["batch"] * len(steady) / sum(steady),
                              steady_peak_memory_gb=peak, metrics=metrics,
                              gt_per_image=[int(v.sum()) for v in batches[0]["gt_valid"]])
    rec["launches"][label], rec["checks"][label] = path, checks
    emit(dict(phase=f"{phase}_{label}", launches=path, first_launches=first, **rec["runs"][label]))
    return trainer, batches[-1]


def plain_levels(feats, rois, levels, output_size, sampling_ratio, max_samples):
    """The multi-level pooling's plain version on the card: each level's
    rows from the level-filtered plain version, summed."""
    from cvpr22_cross_modal_pseudo_labeling_torch.ops import roi_align as ra

    out = None
    for lvl, (f, scale) in enumerate(zip(feats, FPN_SCALES)):
        part = ra.roi_align_plain(f, rois, output_size, scale, sampling_ratio, max_samples, 1, levels, lvl)
        out = part if out is None else out + part
    return out


def phase_fpn(dev, results):
    """(a) FPN teacher serving, (b) FPN teacher train, (c) FPN
    student-teacher serving and train, (d) train_net (teacher, then the
    student from its checkpoint) and test_net; then the new launch shapes
    timed on their captured inputs."""
    import shutil

    from cvpr22_cross_modal_pseudo_labeling_torch import bridge
    from cvpr22_cross_modal_pseudo_labeling_torch.config import R50_FPN_OPTS
    from cvpr22_cross_modal_pseudo_labeling_torch.data import make_data_loader
    from cvpr22_cross_modal_pseudo_labeling_torch.engine import checkpoint as ck
    from cvpr22_cross_modal_pseudo_labeling_torch.engine import inference as inf
    from cvpr22_cross_modal_pseudo_labeling_torch.models.backbone import ResNetFPNBackbone
    from cvpr22_cross_modal_pseudo_labeling_torch.ops import kernels
    from cvpr22_cross_modal_pseudo_labeling_torch.tools import test_net

    fpn = [str(x) for x in R50_FPN_OPTS]
    captured, runs, launches, all_checks = {}, {}, {}, {}
    records = dict(runs=runs, launches=launches, checks=all_checks)
    b, (h, w) = SERVING["batch"], SERVING["hw"]

    def capture(checks, hooks, label):
        return fpn_capture(checks, *hooks, captured, label)

    def serving(config, classes, seed, label):
        pred, batch, table = checked_serving(dev, "fpn", config, fpn, classes, seed, label, (6, 8, 0), 28,
                                             FPN_PHASE["batches"], capture, records)
        # 5 RPN levels and the detections; 4 levels for the proposals and
        # 4 for the detections' masks
        check(isinstance(pred.model.backbone, ResNetFPNBackbone),
              f"fpn {label}: built {type(pred.model.backbone).__name__}")
        return pred, batch, table

    def training(config, classes, seed, label, nms_per_step, roi_per_step, bwd_per_step, trained, frozen_ok):
        return checked_training(dev, "fpn", config, fpn, classes, seed, label,
                                (nms_per_step, roi_per_step, bwd_per_step), trained, frozen_ok,
                                FPN_PHASE["steps"], capture, records, rcnn=label == "teacher_train")

    profiles = {}
    # (a) the FPN teacher's serving
    pred, batch, table = serving(TEACHER, TEACHER_CLASSES, SEED + 8, "teacher_serving")
    profiles["teacher_serving"] = profile_groups(lambda: pred(*batch, table))
    del pred
    torch.cuda.empty_cache()
    # (b) the FPN teacher's training: the RPN loss over the five levels,
    # the backward over P2..P5; its FPN trains
    trainer, batch = training(
        TEACHER, TEACHER_CLASSES, SEED + 9, "teacher_train", 5, 4, 4, FPN_TRAINED,
        lambda fr, names: sorted(fr) == sorted(n for n in names if n.startswith(TEACHER_FROZEN)))
    profiles["teacher_train"] = profile_groups(lambda: trainer.step(batch))
    del trainer
    torch.cuda.empty_cache()
    # (c) the FPN student-teacher model: serving, then training with its
    # backbone (FPN included), RPN, teacher and BERT frozen
    pred, _, _ = serving(CONFIG, TRAIN["classes"], SEED + 3, "st_serving")
    del pred
    torch.cuda.empty_cache()
    trainer, batch = training(
        CONFIG, TRAIN["classes"], SEED + 4, "st_train", 10, 16, 0, ("student.",),
        lambda fr, names: any(n.startswith("backbone.fpn.") for n in fr)
        and set(fr) >= {n for n in names if n.split(".")[0] in FROZEN_MODULES})
    profiles["st_train"] = profile_groups(lambda: trainer.step(batch))
    del trainer
    torch.cuda.empty_cache()

    # (d) train_net: the teacher 3 steps (its first step checked), the
    # student 2 steps from its OUTPUT_DIR, test_net on the student
    check(os.path.isdir(EVAL["tree"]), f"fpn: no tree at {EVAL['tree']} (the eval phase writes it)")
    os.environ["CMPL_TPU_DATA_DIR"] = EVAL["tree"]
    out = FPN_PHASE["out"]
    t_dir, s_dir, e_dir = (os.path.join(out, d) for d in ("teacher", "st", "test_net"))
    shutil.rmtree(out, ignore_errors=True)
    name = TRAIN_NET["dataset"]
    common = ["--device", dev.type, "--seed", str(SEED), *map(str, TRAIN_NET["opts"]), *fpn]
    try:
        checks, check_nms, check_roi, check_roi_bwd = launch_checks()

        def first_step_bwd(inputs, out_):
            check_roi_bwd(inputs, out_)
            if len(checks["roi_align_backward"]) == 4:  # the first step's last launch
                kernels.NMS.on_launch = kernels.ROI_ALIGN.on_launch = kernels.ROI_ALIGN_BACKWARD.on_launch = None

        kernels.reset_launches()
        kernels.NMS.on_launch, kernels.ROI_ALIGN.on_launch = check_nms, check_roi
        kernels.ROI_ALIGN_BACKWARD.on_launch = first_step_bwd
        try:
            rec, runs["train_net_teacher"], log, logged = train_net_run(
                ["--config-file", TEACHER, "--skip-test", *common, "SOLVER.MAX_ITER", str(FPN_PHASE["steps"]),
                 "SOLVER.CHECKPOINT_PERIOD", str(FPN_PHASE["steps"]), "SOLVER.TEST_PERIOD", "0"], t_dir)
        finally:
            kernels.NMS.on_launch = kernels.ROI_ALIGN.on_launch = kernels.ROI_ALIGN_BACKWARD.on_launch = None
        launches["train_net_teacher"] = {k.name: k.launches for k in kernels.ALL}
        all_checks["train_net_teacher"] = checks
        check_all_passed("train_net teacher", checks, {"nms": 5, "roi_align": 4, "roi_align_backward": 4}, 5, 4, 4)
        check([r["step"] for r in logged] == list(range(1, FPN_PHASE["steps"] + 1))
              and all(np.isfinite(v) for r in logged for v in r.values()),
              f"fpn train_net teacher: logged {logged}")
        del rec
        torch.cuda.empty_cache()
        t_ckpt = os.path.join(t_dir, f"model_{FPN_PHASE['steps']:07d}.pth")
        teacher_ck = ck.load_checkpoint(t_ckpt)
        leaves = bridge._flatten(bridge.flax_tree_from_checkpoint(teacher_ck))
        fpn_leaves = sum(p[:2] == ("backbone", "fpn") for p in leaves)

        kernels.reset_launches()
        rec, runs["train_net_student"], log, logged = train_net_run(
            ["--config-file", CONFIG, "--skip-test", *common, "MODEL.WEIGHT", t_dir,
             "SOLVER.MAX_ITER", str(FPN_PHASE["student_steps"]),
             "SOLVER.CHECKPOINT_PERIOD", str(FPN_PHASE["student_steps"]), "SOLVER.TEST_PERIOD", "0"], s_dir)
        launches["train_net_student"] = {k.name: k.launches for k in kernels.ALL}
        imported = re.search(r"imported (\d+) leaves from checkpoint \S+ \((\d+) source", log)
        copied = re.search(r"prepare_model: copied (\d+) teacher leaves", log)
        check(imported and int(imported.group(1)) == len(leaves) and int(imported.group(2)) == 0,
              f"fpn train_net student: imported {imported and imported.groups()} of {len(leaves)} leaves")
        check(copied and int(copied.group(1)) == sum(p[0] in ("roi_extractor", "box_predictor", "mask_predictor")
                                                     for p in leaves),
              f"fpn train_net student: copied {copied and copied.group(1)} teacher leaves")
        check([r["step"] for r in logged] == list(range(1, FPN_PHASE["student_steps"] + 1))
              and all(np.isfinite(v) for r in logged for v in r.values()),
              f"fpn train_net student: logged {logged}")
        s_ckpt = os.path.join(s_dir, f"model_{FPN_PHASE['student_steps']:07d}.pth")
        st_ck = ck.load_checkpoint(s_ckpt)["trainer"]["model"]
        t_model = teacher_ck["trainer"]["model"]
        same = [k for k in t_model if k.startswith(("backbone.", "rpn_head."))]
        heads = [k for k in t_model if k.startswith(("roi_extractor.", "box_predictor.", "mask_predictor."))]
        check(same and all(torch.equal(st_ck[k], t_model[k]) for k in same)
              and heads and all(torch.equal(st_ck["teacher." + k], t_model[k]) for k in heads),
              "fpn train_net student: its backbone, FPN, RPN or teacher bundle differs from the teacher's")
        del rec, st_ck, teacher_ck, t_model
        torch.cuda.empty_cache()

        kernels.reset_launches()
        t = time.perf_counter()
        got = test_net.main(["--config-file", CONFIG, "--device", dev.type, "--ckpt", s_ckpt,
                             *map(str, TRAIN_NET["opts"]), *fpn, "DATASETS.TEST", f"('{name}',)",
                             "OUTPUT_DIR", e_dir])
        test_s = time.perf_counter() - t
        launches["test_net"] = {k.name: k.launches for k in kernels.ALL}
        _, (val,) = make_data_loader(inf.load_cfg(CONFIG, fpn + ["DATASETS.TEST", f"('{name}',)"]), is_train=False)
        with open(os.path.join(e_dir, f"predictions_{name}.json")) as f:
            preds = json.load(f)
        covered = {p["image_id"] for p in preds}
        check(covered == set(val.id_to_img_map.values()),
              f"fpn test_net: {len(set(val.id_to_img_map.values()) - covered)} images without a result")
        bad, _ = metrics_finite(got[name], val)
        check(not bad and "segm/AP" in got[name], f"fpn test_net: non-finite metrics {bad[:5]}")
        runs["test_net"] = dict(seconds=test_s, images=len(val), results=len(preds),
                                images_per_s=len(val) / test_s, bbox_AP=got[name]["bbox/AP"],
                                segm_AP=got[name]["segm/AP"], fpn_leaves_imported=fpn_leaves)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    check(all(v["nms"] > 0 and v["roi_align"] > 0 for v in launches.values())
          and launches["teacher_train"]["roi_align_backward"] > 0
          and launches["train_net_teacher"]["roi_align_backward"] > 0,
          f"fpn: a kernel of a path never launched: {launches}")

    # the new launch shapes, timed on the inputs their first launch had
    with torch.no_grad():
        shapes = fpn_shapes_timed(dev, captured)
    captured.clear()
    rec = dict(phase="fpn", opts=fpn, dtype="bfloat16", batch=b, image_hw=[h, w], runs=runs,
               launches=launches, new_shapes=shapes, profiles=profiles,
               checks={k: check_lists(v) for k, v in all_checks.items()})
    emit(rec)
    results["fpn"] = rec


def fpn_shapes_timed(dev, captured):
    """The fpn phase's new launch shapes on their captured inputs: each
    NMS shape, the multi-level forward on the proposals, sampled rois,
    detections and pseudo boxes (run once into an output of NaN, which
    every row must overwrite), and the backward on each level."""
    from cvpr22_cross_modal_pseudo_labeling_torch.ops import nms as nm
    from cvpr22_cross_modal_pseudo_labeling_torch.ops import roi_align as ra

    iters = FPN_PHASE["timing_iters"]
    shapes = {}
    nms_seen = {}
    for tag in ("teacher_serving", "teacher_train"):
        for key, inputs in captured[tag].items():
            if key[0] == "nms" and key[1:] not in nms_seen:
                nms_seen[key[1:]] = inputs
    for (bb, n, k), inputs in sorted(nms_seen.items()):
        boxes, scores, valid, thr, _, labels = inputs
        idx, keep = nm.nms(*inputs)
        bound_ms, bound_by, _ = nms_bound(scores, valid, labels, idx, keep, k)
        shapes[f"nms {bb} x {n} -> {k}"] = dict(
            kept=int(keep.sum()), ms=cuda_ms(lambda: nm.nms(*inputs), 2 * iters),
            plain_ms=cuda_ms(lambda: nm.nms_plain(*inputs), 2), bound_ms=bound_ms, bound_by=bound_by)
    def roi_counts(tag):
        # in the order of their first launch: serving pools the proposals,
        # then the detections; the student-teacher step the teacher's
        # proposals, then the pseudo boxes, then each branch's samples
        return [k[1] for k in captured[tag] if k[0] == "roi_align"]

    for tag, count, what in (("teacher_serving", roi_counts("teacher_serving")[0], "proposals"),
                             ("teacher_train", roi_counts("teacher_train")[0], "sampled rois"),
                             ("teacher_serving", roi_counts("teacher_serving")[-1], "detections"),
                             ("st_train", roi_counts("st_train")[1], "pseudo boxes")):
        group = captured[tag][("roi_align", count)]
        check(sorted(group) == [0, 1, 2, 3], f"fpn: {what} pooled on levels {sorted(group)}")
        feats = [group[lvl][0].detach() for lvl in range(4)]
        _, rois, output_size, _, sr, ms_, _, levels, _ = group[0]
        fmax = max(float(f.float().abs().max()) for f in feats)
        # every row written: one launch a level into an output of NaN
        nan_out = torch.full((rois.shape[0], rois.shape[1], 14, 14, feats[0].shape[3]), float("nan"),
                             dtype=feats[0].dtype, device=dev)
        ra._forward_levels_cuda(feats, rois, levels, output_size, FPN_SCALES, sr, ms_, out=nan_out)
        plain = functools.partial(plain_levels, feats, rois, levels, output_size, sr, ms_)
        ref = plain()
        err, excess = roi_err(nan_out, ref, fmax)
        check(not torch.isnan(nan_out).any() and excess <= 0,
              f"fpn roi_align {what}: NaN left {bool(torch.isnan(nan_out).any())}, error {err} ({excess} over)")
        del nan_out, ref
        bound_ms, bound_by = roi_levels_bound(feats, rois, levels, output_size, FPN_SCALES, sr)
        run = functools.partial(ra._forward_levels_cuda, feats, rois, levels, output_size, FPN_SCALES, sr, ms_)
        shapes[f"roi_align {what} {rois.shape[0]} x {rois.shape[1]}, P2..P5 C {feats[0].shape[3]} "
               f"{feats[0].dtype}"] = dict(
            rois_per_level=[int((levels == lvl).sum()) for lvl in range(4)],
            maps=[list(f.shape) for f in feats], max_abs_err=err, every_row_written=True,
            ms=cuda_ms(run, iters), plain_ms=cuda_ms(plain, 1), bound_ms=bound_ms, bound_by=bound_by,
            level_ms=[cuda_ms(functools.partial(ra._forward_cuda, *group[lvl][:7], levels, lvl), iters)
                      for lvl in range(4)])
        torch.cuda.empty_cache()
    # the backward as the autograd route runs it: one launch a level
    bwd_args = [captured["teacher_train"][("roi_align_backward", lvl)] for lvl in range(4)]
    total_bytes = total_ops = 0.0
    for lvl, args in enumerate(bwd_args):
        grad, rois, shape, dtype, output_size, scale, sr, _, _, levels, _ = args
        byts, ops = roi_level_bwd_work(grad, rois, levels, lvl, shape, output_size, scale, sr)
        total_bytes, total_ops = total_bytes + byts, total_ops + ops
        bound_ms, bound_by = bound_of(byts, ops)
        shapes[f"roi_align_backward P{lvl + 2} {list(shape)} from {rois.shape[0]} x {rois.shape[1]} {dtype}"] = dict(
            rois=int((levels == lvl).sum()), ms=cuda_ms(lambda: ra.roi_align_backward(*args), iters),
            plain_ms=cuda_ms(lambda: ra.roi_align_backward_plain(*args), 1), bound_ms=bound_ms,
            bound_by=bound_by)
        torch.cuda.empty_cache()
    # together: each level's cotangent rows and dF as above, the rois and
    # levels read once rather than once a launch
    total_bytes -= 3 * (bwd_args[0][1].numel() + bwd_args[0][9].numel()) * 4
    bound_ms, bound_by = bound_of(total_bytes, total_ops)
    shapes["roi_align_backward P2..P5, the four launches"] = dict(
        ms=cuda_ms(lambda: [ra.roi_align_backward(*a) for a in bwd_args], iters),
        plain_ms=cuda_ms(lambda: [ra.roi_align_backward_plain(*a) for a in bwd_args], 1),
        bound_ms=bound_ms, bound_by=bound_by)
    return shapes


# RetinaNet (config.RETINANET_OPTS: maskrcnn_benchmark's retinanet_R-50-FPN_1x,
# 81 classes, over the supervised phase's COCO setup; INFERENCE_TH 0 for the
# seeded weights, whose scores spread around the 0.01 prior) and the RPN-only
# teacher (zeroshot_mask.yaml with MODEL.RPN_ONLY) on the C4 and FPN bodies,
# at full width in bfloat16; outputs under build/retina_out (deleted at the
# end of the phase)
RETINA = dict(batches=3, steps=3, rpn_only_steps=2, out="build/retina_out", timing_iters=10, classes=81)
RETINA_TRAINED = ("net.backbone.body.layer2.", "net.backbone.body.layer3.", "net.backbone.body.layer4.",
                  "net.backbone.fpn.", "net.head.")
RETINA_FROZEN = ("net.backbone.body.stem.", "net.backbone.body.layer1.")


def retina_opts():
    from cvpr22_cross_modal_pseudo_labeling_torch.config import RETINANET_OPTS

    # the seeded weights diverge within 3 steps at the supervised setup's
    # BASE_LR 0.01 (the gradient norm grows 1.5e3 -> 1.7e5 -> inf on the
    # CPU rehearsal); the default 0.001 trains them
    return [*map(str, SUPERVISED["common"]), *map(str, SUPERVISED["coco_opts"]), *map(str, RETINANET_OPTS),
            "MODEL.RETINANET.INFERENCE_TH", "0.0", "SOLVER.BASE_LR", "0.001"]


def keyed_top_k(x, k):
    """The stable-sort ``top_k``'s order from ``torch.topk`` over unique
    int64 keys (a float's order-preserving bits high, the inverted index
    low): a selection in place of a sort of the whole row, timed beside
    the sort that RetinaNet's inference runs."""
    bits = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    n = x.shape[-1]
    keys = ordered * (1 << 32) + torch.arange(n - 1, -1, -1, device=x.device, dtype=torch.int64)
    idx = torch.topk(keys, k, dim=-1, largest=True, sorted=True).indices
    return torch.gather(x, -1, idx), idx


def retina_candidates(model, inputs):
    """What reaches the detection NMS of a RetinaNet batch: valid
    candidates per image, distinct labels among them and valid candidates
    per level (each level gives its top ``PRE_NMS_TOP_N`` in order)."""
    _, _, valid, _, _, labels = inputs
    s = model.statics
    anchors = list(model.net._anchors.values())[-1]  # the one batch shape served
    per_level = [min(s.pre_nms_top_n, a.shape[0] * (s.num_classes - 1)) for a in anchors]
    bounds = np.cumsum([0] + per_level)
    v = valid.cpu()
    return dict(candidates_per_level=per_level, valid_per_image=v.sum(1).tolist(),
                distinct_labels=len(torch.unique(labels.cpu()[v])),
                valid_per_level=[int(v[:, a:b].sum()) for a, b in zip(bounds[:-1], bounds[1:])])


def phase_retinanet(dev, results):
    """(a) RetinaNet serving, (b) RetinaNet train steps, (c) train_net, a
    resume and test_net --ckpt, (d) the RPN-only teacher on the C4 and
    FPN bodies through train_net and test_net; then the detection NMS at
    RetinaNet's shape, the top-k and the focal loss timed."""
    import shutil

    from cvpr22_cross_modal_pseudo_labeling_torch import bridge
    from cvpr22_cross_modal_pseudo_labeling_torch.config import R50_FPN_OPTS
    from cvpr22_cross_modal_pseudo_labeling_torch.data import make_data_loader
    from cvpr22_cross_modal_pseudo_labeling_torch.engine import inference as inf
    from cvpr22_cross_modal_pseudo_labeling_torch.engine.inference import Predictor
    from cvpr22_cross_modal_pseudo_labeling_torch.engine.train_step import Trainer
    from cvpr22_cross_modal_pseudo_labeling_torch.models.backbone import device_normalize
    from cvpr22_cross_modal_pseudo_labeling_torch.models.detector.retinanet import RetinaNetDetector
    from cvpr22_cross_modal_pseudo_labeling_torch.models.rpn import retinanet as rt
    from cvpr22_cross_modal_pseudo_labeling_torch.models.rpn.rpn import top_k
    from cvpr22_cross_modal_pseudo_labeling_torch.ops import kernels
    from cvpr22_cross_modal_pseudo_labeling_torch.ops import nms as nm
    from cvpr22_cross_modal_pseudo_labeling_torch.ops.sigmoid_focal_loss import sigmoid_focal_loss

    opts = retina_opts()
    captured, runs, launches, all_checks, profiles, timed_ = {}, {}, {}, {}, {}, {}
    b, (h, w) = SERVING["batch"], SERVING["hw"]
    iters = RETINA["timing_iters"]

    # (a) serving: 3 batches of 8, the first batch's NMS checked and kept
    pred = Predictor("", opts, device=dev)
    pred.load_flax_params(bridge.seeded_flax_params(pred.model, SEED))
    check(isinstance(pred.model, RetinaNetDetector) and pred.cfg.TPU.COMPUTE_DTYPE == "bfloat16"
          and pred.cfg.MODEL.RPN_ONLY and pred.model.statics.num_classes == RETINA["classes"],
          f"retinanet: built {type(pred.model).__name__} in {pred.cfg.TPU.COMPUTE_DTYPE}")
    rng = np.random.default_rng(SEED + 10)
    batches = []
    for _ in range(RETINA["batches"]):
        sizes = np.stack([rng.integers(3 * h // 4, h + 1, b), rng.integers(2 * w // 3, w + 1, b)], 1)
        sizes[0] = (h, w)
        batches.append((rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8), sizes.astype(np.int32)))
    checks, check_nms, _, _ = launch_checks()

    def serving_nms(inputs, out):
        captured.setdefault("serving_nms", inputs)
        check_nms(inputs, out)

    lat, outs, first, path, peak = fpn_steps(lambda x: pred(x[0], x[1]), batches, 1, (serving_nms, None, None))
    for i, (dets, masks) in enumerate(outs):
        check(dets.boxes.shape == (b, 100, 4) and masks is None, f"retinanet serving: shapes {dets.boxes.shape}")
        check(np.isfinite(dets.boxes).all() and np.isfinite(dets.scores).all(), "retinanet serving: non-finite")
        check(bool(dets.valid.any(1).all()), f"retinanet serving: batch {i} has an image without detections")
        labels = dets.labels[dets.valid]
        check(labels.min() >= 1 and labels.max() < RETINA["classes"], "retinanet serving: a label off the classes")
    check(first == {"nms": 1, "roi_align": 0, "roi_align_backward": 0} and len(checks["nms"]) == 1
          and checks["nms"][0][0] == 0 and path["nms"] == RETINA["batches"],
          f"retinanet serving: launches {first} / {path}, checks {checks['nms']}")
    candidates = retina_candidates(pred.model, captured["serving_nms"])
    check(min(candidates["valid_per_image"]) > 0 and min(candidates["valid_per_level"]) > 0
          and candidates["distinct_labels"] > 1, f"retinanet serving: a degenerate NMS input {candidates}")
    steady = lat[1:]
    runs["serving"] = dict(batch_latency_s=lat, steady_images_per_s=b * len(steady) / sum(steady),
                           steady_peak_memory_gb=peak, valid_detections=[d.valid.sum(1).tolist() for d, _ in outs],
                           labels_detected=len(np.unique(np.concatenate([d.labels[d.valid] for d, _ in outs]))),
                           nms_input=candidates)
    launches["serving"], all_checks["serving"] = path, checks
    emit(dict(phase="retinanet_serving", launches=path, **runs["serving"]))
    profiles["serving"] = profile_groups(lambda: pred(*batches[-1]))

    # the top-k of the largest level (P3: 8 x 12.0 M scores): the stable
    # sort the path runs, a keyed selection of the same order, and
    # torch.topk, whose order among ties is not lax.top_k's
    with torch.no_grad():
        images, sizes = (torch.as_tensor(x).to(dev) for x in batches[0])
        s = pred.model.statics
        feats = pred.model.net.backbone(device_normalize(images, sizes, s.pixel_mean, s.pixel_std, s.to_bgr255))
        p3 = torch.sigmoid(pred.model.net.head(feats[:1])[0][0].reshape(b, -1).to(torch.float32))
        del feats
        k = s.pre_nms_top_n
        keyed, ref = keyed_top_k(p3, k), top_k(p3, k)
        check(torch.equal(keyed[0], ref[0]) and torch.equal(keyed[1], ref[1]),
              "retinanet: the keyed top-k differs from the stable sort")
        timed_["top_k"] = dict(
            shape=list(p3.shape), k=k, distinct_in_top_k=[len(torch.unique(v)) for v in ref[0]],
            sort_ms=cuda_ms(lambda: top_k(p3, k), iters), keyed_ms=cuda_ms(lambda: keyed_top_k(p3, k), iters),
            # the float sort top_k ran before it sorted the floats' bits
            float_sort_ms=cuda_ms(lambda: torch.sort(p3, dim=-1, descending=True, stable=True), iters),
            torch_topk_ms=cuda_ms(lambda: torch.topk(p3, k), iters))
        del p3, keyed, ref
    del pred
    torch.cuda.empty_cache()

    # (b) 3 Trainer steps of 8: no kernel of the port on this path
    trainer = Trainer("", opts, device=dev, seed=SEED)
    trainer.load_flax_params(bridge.seeded_flax_params(trainer.model, SEED))
    model = trainer.model
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    frozen = [n for n, p in model.named_parameters() if not p.requires_grad]
    check(sorted(frozen) == sorted(n for n in start if n.startswith(RETINA_FROZEN)),
          f"retinanet train: frozen {frozen[:5]}")
    buffers = {n: x.clone() for n, x in model.named_buffers()}
    rng = np.random.default_rng(SEED + 11)
    tb = [rcnn_batch(train_batch(rng, TRAIN["batch"], TRAIN["hw"], TRAIN["max_gt"], TRAIN["nouns"],
                                 TRAIN["noun_tokens"], TRAIN["lvis"], RETINA["classes"]))
          for _ in range(RETINA["steps"])]
    lat, outs, first, path, peak = fpn_steps(trainer.step, tb, 0, (None, None, None))
    metrics = [{k: float(v) for k, v in m.items()} for m in outs]
    check(all(np.isfinite(v) for m in metrics for v in m.values()) and set(metrics[0]) ==
          {"loss_retina_cls", "loss_retina_reg", "total_loss", "grad_norm"}, f"retinanet train: metrics {metrics}")
    params = dict(model.named_parameters())
    unchanged = [n for n in start if n.startswith(RETINA_TRAINED) and torch.equal(params[n], start[n])]
    # a bias (no weight decay) whose gradient is 0 or under an ulp of its
    # value per update (behind ReLUs nearly all off on P7) may stay put
    still = [n for n in unchanged if n.endswith(".bias")]
    moved = [n for n in frozen if not torch.equal(params[n], start[n])]
    moved += [n for n, x in model.named_buffers() if not torch.equal(x, buffers[n])]
    check(unchanged == still and len(still) < 4 and not moved,
          f"retinanet train: unchanged {unchanged[:5]}, frozen moved {moved[:5]}")
    check(not any(path.values()), f"retinanet train: a kernel launched in training: {path}")
    steady = lat[1:]
    runs["train"] = dict(step_latency_s=lat, steady_step_s=sum(steady) / len(steady),
                         steady_images_per_s=TRAIN["batch"] * len(steady) / sum(steady),
                         steady_peak_memory_gb=peak, metrics=metrics, unchanged_biases=still)
    launches["train"] = path
    emit(dict(phase="retinanet_train", launches=path, **runs["train"]))
    profiles["train"] = profile_groups(lambda: trainer.step(tb[-1]))
    # the loss alone at the step's shapes: the focal loss, then the whole
    # loss (matching, focal, smooth-L1), forward and backward, float32
    anchors = torch.cat(list(model.net._anchors.values())[-1])
    n_anchors, num_fg = anchors.shape[0], RETINA["classes"] - 1
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    logits = (torch.randn((TRAIN["batch"], n_anchors, num_fg), device=dev, generator=g) - 4.6).requires_grad_(True)
    reg = torch.randn((TRAIN["batch"], n_anchors, 4), device=dev, generator=g).mul_(0.1).requires_grad_(True)
    targets = torch.randint(-1, num_fg + 1, (TRAIN["batch"], n_anchors), device=dev, generator=g)
    batch_t = {k: torch.as_tensor(v).to(dev) for k, v in tb[0].items()}

    def focal():
        sigmoid_focal_loss(logits, targets, 2.0, 0.25).sum().backward()

    def loss():
        cls, box = rt.retinanet_loss(anchors, logits, reg, batch_t["gt_boxes"], batch_t["gt_labels"],
                                     batch_t["gt_valid"], model.statics)
        (cls + box).backward()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    loss()
    torch.cuda.synchronize()
    timed_["loss"] = dict(anchors=n_anchors, logits_shape=list(logits.shape),
                          focal_ms=cuda_ms(focal, 3), loss_ms=cuda_ms(loss, 3),
                          loss_peak_gb=(torch.cuda.max_memory_allocated() - base) / 1e9,
                          step_device_ms=profiles["train"]["device_ms"])
    del logits, reg, targets, batch_t, trainer, model, start, buffers, outs
    torch.cuda.empty_cache()
    emit(dict(phase="retinanet_timing", **timed_))

    # (c) train_net 3 steps, a resume to 4, test_net --ckpt on the eval tree
    check(os.path.isdir(EVAL["tree"]), f"retinanet: no tree at {EVAL['tree']} (the eval phase writes it)")
    os.environ["CMPL_TPU_DATA_DIR"] = EVAL["tree"]
    out = RETINA["out"]
    shutil.rmtree(out, ignore_errors=True)
    common = ["--device", dev.type, "--seed", str(SEED)]
    steps = RETINA["steps"]
    try:
        r_dir = os.path.join(out, "retina")
        kernels.reset_launches()
        rec, runs["train_net"], _, logged = train_net_run(
            ["--skip-test", *common, *opts, "SOLVER.MAX_ITER", str(steps), "SOLVER.CHECKPOINT_PERIOD", str(steps)],
            r_dir)
        check(isinstance(rec["trainer"].model, RetinaNetDetector) and rec["start_iter"] == 0,
              f"retinanet train_net: {type(rec['trainer'].model).__name__} from {rec['start_iter']}")
        del rec
        rec, runs["train_net_resume"], log, logged = train_net_run(
            ["--skip-test", *common, *opts, "SOLVER.MAX_ITER", str(steps + 1), "SOLVER.CHECKPOINT_PERIOD",
             str(steps + 1), "MODEL.LOAD_TRAINER_STATE", "True"], r_dir)
        launches["train_net"] = {k.name: k.launches for k in kernels.ALL}
        check(rec["start_iter"] == steps and "resumed from" in log
              and [r["step"] for r in logged] == list(range(1, steps + 2))
              and all(np.isfinite(v) for r in logged for v in r.values()),
              f"retinanet train_net: start {rec['start_iter']}, logged {logged}")
        check(not any(launches["train_net"].values()), f"retinanet train_net: launches {launches['train_net']}")
        del rec
        torch.cuda.empty_cache()
        name = "coco_not_zeroshot_val"
        m, launches["test_net"], tbatches, checks, preds, saved_m, test_s = supervised_test(
            "retinanet", ["--ckpt", os.path.join(r_dir, f"model_{steps + 1:07d}.pth"), *common, *opts],
            os.path.join(out, "test"), name, captured, per_batch={"nms": 1, "roi_align": 0, "roi_align_backward": 0})
        _, (ds,) = make_data_loader(inf.load_cfg("", opts), is_train=False)
        per_image = {}
        for pr in preds:
            per_image[pr["image_id"]] = per_image.get(pr["image_id"], 0) + 1
        check(set(per_image) == set(ds.id_to_img_map.values()) and max(per_image.values()) <= 100,
              f"retinanet test_net: {len(set(ds.id_to_img_map.values()) - set(per_image))} images without a result")
        bad, _ = metrics_finite(saved_m, ds)
        check(not bad and "bbox/AP" in saved_m and "segm/AP" not in saved_m
              and not any(k.startswith("box_proposal") for k in saved_m),
              f"retinanet test_net: metrics {bad[:5]} {sorted(saved_m)[:5]}")
        runs["test_net"] = dict(seconds=test_s, batches=len(tbatches), results=len(preds),
                                images_per_s=len(ds) / test_s, bbox_AP=m["bbox/AP"],
                                **{k[5:]: m[k] for k in m if k.startswith("time/")})
        all_checks["test_net"] = checks

        # (d) the RPN-only teacher, C4 and FPN: train_net, then test_net's
        # proposal recall (an RPN NMS a level a batch)
        for body, extra, per_level in (("c4", [], 1), ("fpn", [str(x) for x in R50_FPN_OPTS], 5)):
            d = os.path.join(out, f"rpn_only_{body}")
            argv = ["--config-file", TEACHER, *common, *map(str, TRAIN_NET["opts"]), *extra,
                    "MODEL.RPN_ONLY", "True", "DATASETS.TEST", "('coco_generalized_zeroshot_val',)"]
            n = RETINA["rpn_only_steps"]
            kernels.reset_launches()
            rec, runs[f"rpn_only_{body}_train_net"], _, logged = train_net_run(
                ["--skip-test", *argv, "SOLVER.MAX_ITER", str(n), "SOLVER.CHECKPOINT_PERIOD", str(n),
                 "SOLVER.TEST_PERIOD", "0"], d)
            launches[f"rpn_only_{body}_train_net"] = {k.name: k.launches for k in kernels.ALL}
            check(rec["trainer"].model.statics.rpn_only and [r["step"] for r in logged] == list(range(1, n + 1))
                  and all(np.isfinite(v) for r in logged for v in r.values())
                  and all("loss_objectness" in r and "loss_classifier" not in r for r in logged)
                  and not any(launches[f"rpn_only_{body}_train_net"].values()),
                  f"rpn_only {body} train_net: logged {logged}, launches {launches[f'rpn_only_{body}_train_net']}")
            del rec
            torch.cuda.empty_cache()
            name = "coco_generalized_zeroshot_val"
            m, launches[f"rpn_only_{body}_test_net"], tbatches, checks, props, saved_m, test_s = supervised_test(
                f"rpn_only_{body}", ["--ckpt", os.path.join(d, f"model_{n:07d}.pth"), *argv],
                os.path.join(out, f"rpn_only_{body}_test"), name, captured,
                per_batch={"nms": per_level, "roi_align": 0, "roi_align_backward": 0})
            ar = {k: v for k, v in saved_m.items() if k.startswith("box_proposal/")}
            check(sorted(ar) == sorted(f"box_proposal/AR_{a}@1000" for a in ("all", "large", "medium", "small"))
                  and np.isfinite(ar["box_proposal/AR_all@1000"]) and "bbox/AP" not in saved_m
                  and len(props) == EVAL["val"], f"rpn_only {body} test_net: {saved_m}, {len(props)} images")
            runs[f"rpn_only_{body}_test_net"] = dict(seconds=test_s, batches=len(tbatches), images_per_s=EVAL["val"] / test_s,
                                                     proposals=sum(len(v) for v in props.values()), **ar)
            all_checks[f"rpn_only_{body}_test_net"] = checks
    finally:
        shutil.rmtree(out, ignore_errors=True)
    check(all(launches[p]["nms"] > 0 for p in ("serving", "test_net", "rpn_only_c4_test_net", "rpn_only_fpn_test_net")),
          f"retinanet: a path's NMS never launched: {launches}")

    # the detection NMS at RetinaNet's shape, on the first serving batch's
    # inputs (5 levels x 1000 candidates, 80 labels, IoU 0.4 -> 100)
    inputs = captured.pop("serving_nms")
    boxes, scores, valid, thr, k, labels = inputs
    idx, keep = nm.nms(*inputs)
    bound_ms, bound_by, _ = nms_bound(scores, valid, labels, idx, keep, k)
    shapes = {f"nms {boxes.shape[0]} x {boxes.shape[1]} -> {k}, {int(labels.max())} labels, IoU {thr}": dict(
        kept=int(keep.sum()), ms=cuda_ms(lambda: nm.nms(*inputs), 2 * iters),
        plain_ms=cuda_ms(lambda: nm.nms_plain(*inputs), 2), bound_ms=bound_ms, bound_by=bound_by)}
    captured.clear()
    rec = dict(phase="retinanet", opts=opts, dtype="bfloat16", batch=b, image_hw=[h, w], runs=runs,
               launches=launches, new_shapes=shapes, timing=timed_, profiles=profiles,
               checks={k: check_lists(v) for k, v in all_checks.items()})
    emit(rec)
    results["retinanet"] = rec



# The detector options of the options phase, at full width in bfloat16:
# the R-50-C5 body with res5 dilated (stride 16, so the pooler keeps
# zeroshot_mask.yaml's 1/16 and emits every bin), the keypoint R-CNN
# (maskrcnn_benchmark's e2e_keypoint_rcnn_R_50_FPN_1x as the port reads it:
# config.R50_FPN_OPTS, person and background, 17 keypoints, no masks) on a
# tools/synth_coco_keypoints.py tree under build/synth_kp, and the WSDDN box
# head over zeroshot_mask.yaml (SCORE_THRESH 0.0: with seeded weights each
# (proposal, class) score is about 1 / (1000 proposals x 49 classes), under
# the config's threshold).  Outputs and the tree are deleted at the end.
# The keypoint run trains at BASE_LR 1e-5: the seeded weights' RoI vectors
# are long, so each step at 1e-3 moves the person logit by tens against
# the background, and after 3 steps every person score underflows to 0
# on the card (test_net then gives no image a result).
C5_OPTS = ("MODEL.BACKBONE.CONV_BODY", "R-50-C5", "MODEL.RESNETS.RES5_DILATION", 2,
           "MODEL.ROI_BOX_HEAD.POOLER_SCALES", (0.0625,))
WSDDN_OPTS = ("MODEL.ROI_BOX_HEAD.WSDDN", True, "MODEL.MASK_ON", False, "MODEL.ROI_HEADS.SCORE_THRESH", 0.0)
KEYPOINT_OPTS = ("MODEL.KEYPOINT_ON", True, "MODEL.MASK_ON", False, "MODEL.ROI_BOX_HEAD.NUM_CLASSES", 2,
                 "MODEL.ROI_KEYPOINT_HEAD.NUM_CLASSES", 17, "DATASETS.TRAIN", ("coco_zeroshot_train",),
                 "DATASETS.TEST", ("coco_not_zeroshot_val",), "SOLVER.IMS_PER_BATCH", 8, "TEST.IMS_PER_BATCH", 8,
                 "DATALOADER.ASPECT_RATIO_GROUPING", False, "SOLVER.BASE_LR", 1e-5)
OPTIONS = dict(batches=3, steps=3, tree="build/synth_kp", out="build/options_out", train=8, val=8, seed=0,
               timing_iters=10)
C5_TRAINED = TEACHER_TRAINED + ("backbone.body.layer4.",)
WSDDN_TRAINED = ("backbone.body.layer2.", "backbone.body.layer3.", "rpn_head.", "roi_extractor.", "wsddn_head.")
# the detection stream's bias: a shift of a class's logits over the
# proposals leaves their softmax alone, so its gradient is zero but for
# rounding and it may stay put (it has no weight decay)
WSDDN_STILL = ("wsddn_head.det_score.bias",)


def options_capture(checks, check_nms, check_roi, check_roi_bwd, captured, tag):
    """Launch hooks that check every launch against its plain version and
    keep, under ``captured[tag]``, the inputs of the first launch of each
    kind and shape."""
    def nms(inputs, out):
        key = ("nms", inputs[0].shape[0], inputs[0].shape[1], inputs[4], inputs[5] is not None)
        captured.setdefault(tag, {}).setdefault(key, inputs)
        check_nms(inputs, out)

    def roi(inputs, out):
        key = ("roi_align", inputs[1].shape[1], inputs[0].shape[3], inputs[6])
        captured.setdefault(tag, {}).setdefault(key, inputs)
        check_roi(inputs, out)

    def bwd(inputs, out):
        key = ("roi_align_backward", inputs[1].shape[1], inputs[2][3], inputs[8])
        group = captured.setdefault(tag, {})
        if key not in group:  # on the host, out of the steady steps' peak memory
            group[key] = tuple(x.cpu() if torch.is_tensor(x) else x for x in inputs)
        check_roi_bwd(inputs, out)

    return nms, roi, bwd


def phase_options(dev, results):
    """(a) the dilated R-50-C5 teacher: 3 serving batches and 3 steps; (b)
    the student-teacher model on the same body: 3 serving batches and 3
    steps; (c) the keypoint R-CNN through train_net (3 steps) and
    test_net on a synthetic person-keypoint tree; (d) the WSDDN teacher: 3
    steps (every proposal pooled) and 3 serving batches; then the new
    launch shapes timed on their captured inputs."""
    import shutil

    from cvpr22_cross_modal_pseudo_labeling_torch.config import R50_FPN_OPTS
    from cvpr22_cross_modal_pseudo_labeling_torch.data import make_data_loader
    from cvpr22_cross_modal_pseudo_labeling_torch.engine import inference as inf
    from cvpr22_cross_modal_pseudo_labeling_torch.models.backbone import ResNetBackbone, ResNetFPNBackbone
    from cvpr22_cross_modal_pseudo_labeling_torch.ops import kernels
    from cvpr22_cross_modal_pseudo_labeling_torch.tools import synth_coco_keypoints

    captured, runs, launches, all_checks, profiles = {}, {}, {}, {}, {}
    b, (h, w) = SERVING["batch"], SERVING["hw"]
    c5, wsddn = [str(x) for x in C5_OPTS], [str(x) for x in WSDDN_OPTS]
    records = dict(runs=runs, launches=launches, checks=all_checks)

    def capture(checks, hooks, label):
        return options_capture(checks, *hooks, captured, label)

    def serving(config, opts, classes, seed, label, per_batch, mask_size):
        return checked_serving(dev, "options", config, opts, classes, seed, label, per_batch, mask_size,
                               OPTIONS["batches"], capture, records)

    def training(config, opts, classes, seed, label, per_step, trained, frozen_ok, rcnn=True, still=()):
        return checked_training(dev, "options", config, opts, classes, seed, label, per_step, trained, frozen_ok,
                                OPTIONS["steps"], capture, records, rcnn, still)

    def teacher_frozen(fr, names):
        return sorted(fr) == sorted(n for n in names if n.startswith(TEACHER_FROZEN))

    # (a) the C5 teacher: the RPN and the detections' NMS, the proposals'
    # and the detections' pooling from the 2048-channel C5 map at every
    # bin (28 x 28 masks); training pools its sampled rois and runs the
    # backward into the C5 map (res5 trains with res3 and res4)
    pred, batch, table = serving(TEACHER, c5, TEACHER_CLASSES, SEED + 20, "c5_teacher_serving", (2, 2, 0), 28)
    # the trunk's 8 x res2 channels (2048) into an RPN conv of
    # BACKBONE_OUT_CHANNELS (1024) and into the RoI head's block 0
    trunk, out_ch = 8 * pred.cfg.MODEL.RESNETS.RES2_OUT_CHANNELS, pred.cfg.MODEL.RESNETS.BACKBONE_OUT_CHANNELS
    check(isinstance(pred.model.backbone, ResNetBackbone)
          and pred.model.backbone.body.layer4.block1.conv2.dilation == (2, 2)
          and (pred.model.rpn_head.conv.in_channels, pred.model.rpn_head.conv.out_channels) == (trunk, out_ch)
          and pred.model.roi_extractor.layer4.block0.downsample_conv.in_channels == trunk and trunk != out_ch,
          "options: the C5 teacher's trunk, RPN conv or RoI head has other widths than JAX's")
    profiles["c5_teacher_serving"] = profile_groups(lambda: pred(*batch, table))
    del pred
    torch.cuda.empty_cache()
    trainer, batch = training(TEACHER, c5, TEACHER_CLASSES, SEED + 21, "c5_teacher_train", (1, 1, 1), C5_TRAINED,
                              teacher_frozen)
    profiles["c5_teacher_train"] = profile_groups(lambda: trainer.step(batch))
    del trainer
    torch.cuda.empty_cache()
    # (b) the student-teacher model on the same body: JAX's builds the
    # trunk undilated (stride 32) under heads that dilate res5
    pred, _, _ = serving(CONFIG, c5, TRAIN["classes"], SEED + 22, "c5_st_serving", (2, 2, 0), 28)
    check(pred.model.backbone.body.layer4.block1.conv2.dilation == (1, 1)
          and pred.model.student.roi_extractor.layer4.block1.conv2.dilation == (2, 2),
          "options: the C5 student-teacher model's dilations differ from JAX's")
    del pred
    torch.cuda.empty_cache()
    trainer, batch = training(
        CONFIG, c5, TRAIN["classes"], SEED + 23, "c5_st_train", (2, 4, 0), ("student.",),
        lambda fr, names: set(fr) >= {n for n in names if n.split(".")[0] in FROZEN_MODULES}, rcnn=False)
    del trainer, batch
    torch.cuda.empty_cache()

    # (c) the keypoint R-CNN through train_net and test_net
    out = OPTIONS["out"]
    tree = OPTIONS["tree"]
    shutil.rmtree(out, ignore_errors=True)
    shutil.rmtree(tree, ignore_errors=True)
    kp_opts = [*map(str, SUPERVISED["common"]), *map(str, R50_FPN_OPTS), *map(str, KEYPOINT_OPTS)]
    common = ["--device", dev.type, "--seed", str(SEED)]
    try:
        people = synth_coco_keypoints.write_tree(tree, OPTIONS["train"], OPTIONS["val"], seed=OPTIONS["seed"])
        os.environ["CMPL_TPU_DATA_DIR"] = tree
        k_dir = os.path.join(out, "keypoint")
        checks, check_nms, check_roi, check_roi_bwd = launch_checks()
        hooks = options_capture(checks, check_nms, check_roi, check_roi_bwd, captured, "keypoint_train_net")

        def first_step_bwd(inputs, out_):
            hooks[2](inputs, out_)
            if len(checks["roi_align_backward"]) == 4:  # the first step's last launch
                kernels.NMS.on_launch = kernels.ROI_ALIGN.on_launch = kernels.ROI_ALIGN_BACKWARD.on_launch = None

        kernels.reset_launches()
        kernels.NMS.on_launch, kernels.ROI_ALIGN.on_launch, kernels.ROI_ALIGN_BACKWARD.on_launch = (
            hooks[0], hooks[1], first_step_bwd)
        steps = OPTIONS["steps"]
        try:
            rec, runs["keypoint_train_net"], _, logged = train_net_run(
                ["--skip-test", *common, *kp_opts, "SOLVER.MAX_ITER", str(steps),
                 "SOLVER.CHECKPOINT_PERIOD", str(steps)], k_dir)
        finally:
            kernels.NMS.on_launch = kernels.ROI_ALIGN.on_launch = kernels.ROI_ALIGN_BACKWARD.on_launch = None
        launches["keypoint_train_net"] = {k.name: k.launches for k in kernels.ALL}
        all_checks["keypoint_train_net"] = checks
        model = rec["trainer"].model
        check(isinstance(model.backbone, ResNetFPNBackbone) and hasattr(model, "keypoint_predictor")
              and not hasattr(model, "mask_predictor"), "options keypoint train_net: another model was built")
        check_all_passed("keypoint train_net", checks, {"nms": 5, "roi_align": 4, "roi_align_backward": 4}, 5, 4, 4)
        check(launches["keypoint_train_net"] == {"nms": 5 * steps, "roi_align": 4 * steps,
                                                 "roi_align_backward": 4 * steps},
              f"options keypoint train_net: launches {launches['keypoint_train_net']}")
        check([r["step"] for r in logged] == list(range(1, steps + 1))
              and all(np.isfinite(v) for r in logged for v in r.values())
              and all(r["loss_kp"] > 0 for r in logged), f"options keypoint train_net: logged {logged}")
        runs["keypoint_train_net"]["loss_kp"] = [r["loss_kp"] for r in logged]
        del rec, model
        torch.cuda.empty_cache()
        name = "coco_not_zeroshot_val"
        m, launches["keypoint_test_net"], tbatches, checks, preds, saved_m, test_s = supervised_test(
            "keypoint", ["--ckpt", os.path.join(k_dir, f"model_{steps:07d}.pth"), *common, *kp_opts],
            os.path.join(out, "keypoint_test"), name, captured,
            per_batch={"nms": 6, "roi_align": 8, "roi_align_backward": 0})
        ds_cfg = inf.load_cfg("", kp_opts)
        _, (ds,) = make_data_loader(ds_cfg, is_train=False)
        per_image = {}
        for pr in preds:
            per_image[pr["image_id"]] = per_image.get(pr["image_id"], 0) + 1
        check(set(per_image) == set(ds.id_to_img_map.values())
              and max(per_image.values()) <= ds_cfg.MODEL.ROI_HEADS.DETECTIONS_PER_IMG
              and all(len(pr.get("keypoints", ())) == 3 * 17 for pr in preds),
              f"options keypoint test_net: images without a result or keypoints missing ({len(preds)} results)")
        bad, _ = metrics_finite(saved_m, ds)
        check(not bad and "keypoints/AP" in saved_m and np.isfinite(saved_m["keypoints/AP"])
              and "segm/AP" not in saved_m, f"options keypoint test_net: metrics {bad[:5]} {sorted(saved_m)[:8]}")
        runs["keypoint_test_net"] = dict(seconds=test_s, batches=len(tbatches), results=len(preds),
                                         images_per_s=len(ds) / test_s, bbox_AP=m["bbox/AP"],
                                         keypoints_AP=m["keypoints/AP"], tree=people)
        all_checks["keypoint_test_net"] = checks
        emit(dict(phase="options_keypoint", launches={k: launches[k] for k in ("keypoint_train_net",
                                                                             "keypoint_test_net")},
                  train_net=runs["keypoint_train_net"], test_net=runs["keypoint_test_net"]))
    finally:
        shutil.rmtree(out, ignore_errors=True)
        shutil.rmtree(tree, ignore_errors=True)
    torch.cuda.empty_cache()

    # (d) WSDDN: every training proposal (8 x 2000) pooled and
    # backpropagated into the C4 map; serving's NMS over the (proposal,
    # class) candidates
    trainer, batch = training(TEACHER, wsddn, TEACHER_CLASSES, SEED + 24, "wsddn_train", (1, 1, 1), WSDDN_TRAINED,
                              lambda fr, names: sorted(fr) == sorted(
                                  n for n in names if n.startswith(("backbone.body.stem.", "backbone.body.layer1."))),
                              still=WSDDN_STILL)
    check(not hasattr(trainer.model, "box_predictor") and set(runs["wsddn_train"]["metrics"][0]) ==
          {"loss_objectness", "loss_rpn_box_reg", "loss_classifier", "total_loss", "grad_norm"},
          f"options wsddn train: metrics {sorted(runs['wsddn_train']['metrics'][0])}")
    profiles["wsddn_train"] = profile_groups(lambda: trainer.step(batch))
    del trainer, batch
    torch.cuda.empty_cache()
    pred, _, _ = serving(TEACHER, wsddn, TEACHER_CLASSES, SEED + 25, "wsddn_serving", (2, 1, 0), None)
    del pred
    torch.cuda.empty_cache()
    check(all(v["nms"] > 0 and v["roi_align"] > 0 for v in launches.values())
          and all(launches[p]["roi_align_backward"] > 0
                  for p in ("c5_teacher_train", "keypoint_train_net", "wsddn_train")),
          f"options: a kernel of a path never launched: {launches}")

    with torch.no_grad():
        shapes = options_shapes_timed(dev, captured)
    captured.clear()
    rec = dict(phase="options", c5_opts=c5, wsddn_opts=wsddn, keypoint_opts=kp_opts, dtype="bfloat16", batch=b,
               image_hw=[h, w], runs=runs, launches=launches, new_shapes=shapes, profiles=profiles,
               checks={k: check_lists(v) for k, v in all_checks.items()})
    emit(rec)
    results["options"] = rec


def options_shapes_timed(dev, captured):
    """The options phase's new launch shapes on the inputs of their first
    launch, each held against its plain version again: the WSDDN and the
    keypoint detections' NMS, the forward on the C5 map (8 x 1000
    proposals and 8 x 512 sampled rois, C 2048, every bin) and on WSDDN's
    8 x 2000 proposals (C4, C 1024, even bins), the backward into the C5
    map and from WSDDN's proposals."""
    from cvpr22_cross_modal_pseudo_labeling_torch.ops import nms as nm
    from cvpr22_cross_modal_pseudo_labeling_torch.ops import roi_align as ra

    iters = OPTIONS["timing_iters"]
    shapes = {}
    # the WSDDN detections' NMS: the best 10 x 100 (proposal, class)
    # candidates of each image, label-gated
    wsddn_nms = [v for k, v in captured["wsddn_serving"].items() if k[0] == "nms" and k[4]]
    check(len(wsddn_nms) == 1, f"options: {len(wsddn_nms)} labelled NMS shapes in WSDDN serving")
    nms_cases = (("wsddn detections", wsddn_nms[0]), ("keypoint detections", captured["keypoint"][0]))
    for what, inputs in nms_cases:
        boxes, scores, valid, thr, k, labels = inputs
        idx, keep = nm.nms(*inputs)
        ref = nm.nms_plain(*inputs)
        mism = int((idx != ref[0]).sum() + (keep != ref[1]).sum())
        check(mism == 0, f"options nms {what}: {mism} mismatches")
        bound_ms, bound_by, _ = nms_bound(scores, valid, labels, idx, keep, k)
        shapes[f"nms {what} {boxes.shape[0]} x {boxes.shape[1]} -> {k}, {len(torch.unique(labels))} labels, "
               f"IoU {thr}"] = dict(
            kept=int(keep.sum()), mismatches=mism, ms=cuda_ms(lambda: nm.nms(*inputs), 2 * iters),
            plain_ms=cuda_ms(lambda: nm.nms_plain(*inputs), 2), bound_ms=bound_ms, bound_by=bound_by)
    # each path's first pooling: serving's proposals, the steps' rois
    for what, tag in (("C5 proposals", "c5_teacher_serving"), ("C5 sampled rois", "c5_teacher_train"),
                      ("WSDDN proposals", "wsddn_train")):
        args = next(v for k, v in captured[tag].items() if k[0] == "roi_align")
        feats, rois, output_size, scale, sr, ms_, bin_stride = args
        check((scale, sr, ms_) == (1.0 / 16, 0, 8), f"options roi_align {what}: pooler {scale} {sr} {ms_}")
        out = ra.roi_align(*args)
        err, excess = forward_err(out, args, float(feats.float().abs().max()))
        check(excess <= 0, f"options roi_align {what}: max abs diff {err}, {excess} over the limit")
        del out
        bound_ms, bound_by, _, _ = roi_bound(feats, rois, output_size, bin_stride)
        shapes[f"roi_align {what} {rois.shape[0]} x {rois.shape[1]}, {list(feats.shape)} {feats.dtype}, "
               f"bin_stride {bin_stride}"] = dict(
            max_abs_err=err, ms=cuda_ms(lambda: ra.roi_align(*args), iters),
            plain_ms=cuda_ms(lambda: ra.roi_align_plain(*args), 1), bound_ms=bound_ms, bound_by=bound_by)
        torch.cuda.empty_cache()
    for what, tag in (("C5 sampled rois", "c5_teacher_train"), ("WSDDN proposals", "wsddn_train")):
        (key,) = [k for k in captured[tag] if k[0] == "roi_align_backward"]
        args = tuple(x.to(dev) if torch.is_tensor(x) else x for x in captured[tag].pop(key))
        grad, rois, shape, dtype, output_size, scale, sr, ms_, bin_stride = args
        check((scale, sr, ms_) == (1.0 / 16, 0, 8), f"options roi_align_backward {what}: {scale} {sr} {ms_}")
        out = ra.roi_align_backward(*args)
        ref = backward_plain(args)
        fmax = float(ref.float().abs().max())
        err, excess = roi_err(out, ref, fmax)
        check(fmax > 0 and excess <= 0, f"options roi_align_backward {what}: max abs diff {err}, {excess} over")
        del out, ref
        bound_ms, bound_by, _ = roi_bwd_bound(grad, rois, shape, output_size, bin_stride)
        H, W, C = shape[1:]
        shapes[f"roi_align_backward {what} {list(shape)} from {rois.shape[0]} x {rois.shape[1]} {dtype}, "
               f"bin_stride {bin_stride}"] = dict(
            max_abs_err=err, tile=list(ra.backward_tiling(H, W, C, 2 * ra._sample_caps(H, W, 14, 14, sr, ms_)[1])),
            ms=cuda_ms(lambda: ra.roi_align_backward(*args), iters),
            plain_ms=cuda_ms(lambda: ra.roi_align_backward_plain(*args), 1), bound_ms=bound_ms, bound_by=bound_by)
        torch.cuda.empty_cache()
    return shapes


ST_OPTIONS = dict(steps=3, out="build/st_options_out", timing_iters=3, dcn_check=(2, 64, 64, 64))
EXEMPLAR_OPTS = ("MODEL.EXEMPLARS_ENABLED", True)
FT_EMB_OPTS = ("MODEL.LANGUAGE_BACKBONE.FT_EMB", True)
# build_backbone's trunks (phase 22 (e)): the detectors ignore these options
TRUNK_OPTS = {
    "r50_c4": ("MODEL.BACKBONE.CONV_BODY", "R-50-C4"),  # the plain trunk, for comparison
    "r50_c4_gn": ("MODEL.BACKBONE.CONV_BODY", "R-50-C4", "MODEL.RESNETS.TRANS_FUNC", "BottleneckWithGN"),
    "r50_c4_modulated_dcn_res4": ("MODEL.BACKBONE.CONV_BODY", "R-50-C4", "MODEL.RESNETS.STAGE_WITH_DCN",
                                  (False, False, True, False), "MODEL.RESNETS.WITH_MODULATED_DCN", True),
    "fbnet": ("MODEL.BACKBONE.CONV_BODY", "FBNet"),
}
DCN_TOL = 1e-5  # of max|out|: float32 sums in another order (TF32 off)


def st_options_steps(dev, label, opts, seed, tables, trained, rec, capture, per_step_info):
    """``ST_OPTIONS["steps"]`` Trainer steps of ``TRAIN``'s shape on the
    student-teacher config with ``opts``, seeded weights and, for FT_EMB,
    ``tables`` in place of each batch's LVIS table; every launch of the
    first step held against its plain version, every parameter under the
    prefixes ``trained`` changed, the frozen ones bit-identical;
    ``per_step_info(trainer)`` is recorded after each step.  Returns (the
    trainer, its record)."""
    from cvpr22_cross_modal_pseudo_labeling_torch import bridge
    from cvpr22_cross_modal_pseudo_labeling_torch.engine.train_step import Trainer

    trainer = Trainer(CONFIG, [str(x) for x in opts] + list(TRAIN["opts"]), device=dev, seed=SEED)
    trainer.load_flax_params(bridge.seeded_flax_params(trainer.model, SEED, EMB_PRED_STD))
    check(trainer.cfg.TPU.COMPUTE_DTYPE == "bfloat16", f"st_options {label}: {trainer.cfg.TPU.COMPUTE_DTYPE}")
    rng = np.random.default_rng(seed)
    batches = [train_batch(rng, TRAIN["batch"], TRAIN["hw"], TRAIN["max_gt"], TRAIN["nouns"], TRAIN["noun_tokens"],
                           TRAIN["lvis"], TRAIN["classes"], trainer.model.statics.base.emb_dim)
               for _ in range(ST_OPTIONS["steps"])]
    if tables:
        trainer.set_class_tables(**tables)
        for b in batches:
            b.pop("lvis_class_embeddings")
    frozen = {n: p.detach().clone() for n, p in trainer.model.named_parameters() if not p.requires_grad}
    start = {n: p.detach().clone() for n, p in trainer.model.named_parameters() if n.startswith(trained)}
    infos = []
    checks, *hooks = launch_checks()

    def step(batch):
        metrics = trainer.step(batch)
        infos.append(per_step_info(trainer))
        return metrics

    lat, outs, first, path, peak = fpn_steps(step, batches, 1, capture(checks, hooks, label))
    metrics = [{k: float(v) for k, v in m.items()} for m in outs]
    check(all(np.isfinite(v) for m in metrics for v in m.values()), f"st_options {label}: non-finite {metrics}")
    params = dict(trainer.model.named_parameters())
    check(not [n for n in frozen if not torch.equal(params[n], frozen[n])],
          f"st_options {label}: a frozen parameter changed")
    unchanged = [n for n in start if torch.equal(params[n], start[n])]
    check(start and not unchanged, f"st_options {label}: trained parameters did not change: {unchanged[:5]}")
    check_all_passed(label, checks, first, 2, 4, 0)
    check(path == {k: v * len(batches) for k, v in first.items()}, f"st_options {label}: launches {path}")
    steady = lat[1:]
    rec["runs"][label] = dict(step_latency_s=lat, steady_step_s=sum(steady) / len(steady),
                              steady_images_per_s=TRAIN["batch"] * len(steady) / sum(steady),
                              steady_peak_memory_gb=peak, metrics=metrics,
                              per_step=[{k: float(v) for k, v in i.items()} for i in infos])
    rec["launches"][label], rec["checks"][label] = path, checks
    emit(dict(phase=f"st_options_{label}", launches=path, first_launches=first, **rec["runs"][label]))
    return trainer, rec["runs"][label]


def phase_st_options(dev, results):
    """The student-teacher options and the pieces only tests reached
    before: (a) the exemplar table, 3 Trainer steps, its update held
    against the same update on the CPU; (b) FT_EMB, 3 steps; (c) both
    through train_net (2 steps, a save, a resume that restores the table
    bit for bit, 1 more step) and test_net --ckpt; (d) the teacher's
    run_teacher_pseudo_branch and predict_masks_for_boxes on a serving
    batch; (e) build_backbone's plain, GN, modulated-DCN and FBNet
    trunks, forward on 8 x 800 x 1333, one res4 deformable conv beside
    cuDNN's, and deform_conv2d on the card against the CPU."""
    import shutil

    from cvpr22_cross_modal_pseudo_labeling_torch import bridge
    from cvpr22_cross_modal_pseudo_labeling_torch.config import get_default_cfg
    from cvpr22_cross_modal_pseudo_labeling_torch.data import make_data_loader
    from cvpr22_cross_modal_pseudo_labeling_torch.data.collate import build_tokenizer
    from cvpr22_cross_modal_pseudo_labeling_torch.data.parser import load_lvis_categories, normalize_class_names
    from cvpr22_cross_modal_pseudo_labeling_torch.engine import checkpoint as ck
    from cvpr22_cross_modal_pseudo_labeling_torch.engine import inference as inf
    from cvpr22_cross_modal_pseudo_labeling_torch.engine.inference import Predictor
    from cvpr22_cross_modal_pseudo_labeling_torch.engine.train_step import Trainer
    from cvpr22_cross_modal_pseudo_labeling_torch.engine.trainer import tokenize_class_names
    from cvpr22_cross_modal_pseudo_labeling_torch.models.backbone import build_backbone, device_normalize
    from cvpr22_cross_modal_pseudo_labeling_torch.models.detector import st_generalized_rcnn as st_mod
    from cvpr22_cross_modal_pseudo_labeling_torch.ops import kernels
    from cvpr22_cross_modal_pseudo_labeling_torch.ops.deform_conv import deform_conv2d
    from cvpr22_cross_modal_pseudo_labeling_torch.tools import test_net

    captured, runs, launches, all_checks = {}, {}, {}, {}
    rec = dict(runs=runs, launches=launches, checks=all_checks)

    def capture(checks, hooks, label):
        return options_capture(checks, *hooks, captured, label)

    # (a) the exemplar table: the first step's update captured and redone
    # on the CPU
    updates = []
    plain_update = st_mod.update_exemplar_table

    def recording_update(table, *cands):
        out = plain_update(table, *cands)
        if not updates:
            updates.append(([x.detach().cpu().clone() for x in cands], {k: v.cpu() for k, v in table.items()},
                            {k: v.cpu() for k, v in out.items()}))
        return out

    st_mod.update_exemplar_table = recording_update
    try:
        trainer, run = st_options_steps(
            dev, "exemplars", EXEMPLAR_OPTS, SEED + 30, None, ("student.", "lambda_exemplar"), rec, capture,
            lambda t: dict(valid_slots=t.exemplars["valid"].sum(),
                           lambda_exemplar=t.model.lambda_exemplar[0].detach().clone()))
    finally:
        st_mod.update_exemplar_table = plain_update
    cands, before, got = updates[0]
    ref = plain_update(before, *cands)
    check(torch.equal(ref["valid"], got["valid"]) and torch.equal(ref["quality"], got["quality"]),
          "st_options exemplars: the card's table update differs from the CPU's on valid or quality")
    emb_err = float((ref["embs"] - got["embs"]).abs().max())
    check(emb_err <= 1e-6, f"st_options exemplars: the updated embeddings differ from the CPU's by {emb_err}")
    valid = [int(i["valid_slots"]) for i in run["per_step"]]
    check(0 < valid[0] <= valid[-1] <= TRAIN["lvis"] and trainer.exemplars["valid"].dtype == torch.bool,
          f"st_options exemplars: valid slots {valid}")
    check(run["per_step"][-1]["lambda_exemplar"] != 0.0, "st_options exemplars: lambda_exemplar never moved")
    run.update(valid_slots=valid, lambda_exemplar=[i["lambda_exemplar"] for i in run["per_step"]],
               candidates_per_step=int(cands[0].numel()), update_vs_cpu_embs_max_abs_err=emb_err,
               table_bytes=sum(v.numel() * v.element_size() for v in trainer.exemplars.values()))
    del trainer
    torch.cuda.empty_cache()

    # (b) FT_EMB: the LVIS table rebuilt from the live word table each step
    cfg = get_default_cfg()
    cfg.merge_from_file(CONFIG)
    names = normalize_class_names([c["name"] for c in load_lvis_categories()])
    ids, mask = tokenize_class_names(names, build_tokenizer(cfg))
    trainer, run = st_options_steps(
        dev, "ft_emb", FT_EMB_OPTS, SEED + 31, dict(lvis_name_ids=ids, lvis_name_mask=mask), ("student.", "bert."),
        rec, capture, lambda t: dict(word_table_grad_norm=t.model.bert.word_embeddings.grad.norm()))
    check(bool(torch.isfinite(trainer.model.bert.word_embeddings).all()), "st_options ft_emb: a non-finite word table")
    check(trainer.class_tables["lvis_name_ids"].dtype == torch.int64, "st_options ft_emb: the ids are not int64")
    run.update(word_table_grad_norm=[i["word_table_grad_norm"] for i in run["per_step"]],
               plain_st_steady_step_s=results["train"]["steady_step_s"],
               plain_st_steady_peak_memory_gb=results["train"]["steady_peak_memory_gb"],
               step_vs_plain=run["steady_step_s"] / results["train"]["steady_step_s"])
    check(all(g > 0 and np.isfinite(g) for g in run["word_table_grad_norm"]),
          f"st_options ft_emb: word table gradient norms {run['word_table_grad_norm']}")
    del trainer
    torch.cuda.empty_cache()

    # (c) both options through train_net (2 steps, a save, a resume to 3)
    # and test_net --ckpt
    check(os.path.isdir(EVAL["tree"]), f"st_options: no tree at {EVAL['tree']} (the eval phase writes it)")
    os.environ["CMPL_TPU_DATA_DIR"] = EVAL["tree"]
    out = ST_OPTIONS["out"]
    shutil.rmtree(out, ignore_errors=True)
    s_dir, e_dir = os.path.join(out, "st"), os.path.join(out, "test_net")
    name = TRAIN_NET["dataset"]
    both = [*map(str, EXEMPLAR_OPTS), *map(str, FT_EMB_OPTS)]
    common = ["--config-file", CONFIG, "--skip-test", "--device", dev.type, "--seed", str(SEED),
              *map(str, TRAIN_NET["opts"]), *both, "MODEL.LOAD_TRAINER_STATE", "True", "SOLVER.TEST_PERIOD", "0",
              "SOLVER.CHECKPOINT_PERIOD", "2"]
    restored = {}
    load_state = Trainer.load_state_dict

    def recording_load(self, state):
        load_state(self, state)
        restored.update({k: v.cpu() for k, v in self.exemplars.items()})

    try:
        checks, check_nms, check_roi, check_roi_bwd = launch_checks()

        def first_step_roi(inputs, out_):
            check_roi(inputs, out_)
            if len(checks["roi_align"]) == 4:  # the first step's last launch
                kernels.NMS.on_launch = kernels.ROI_ALIGN.on_launch = None

        kernels.reset_launches()
        kernels.NMS.on_launch, kernels.ROI_ALIGN.on_launch = check_nms, first_step_roi
        try:
            _, runs["train_net"], log, logged = train_net_run([*common, "SOLVER.MAX_ITER", "2"], s_dir)
        finally:
            kernels.NMS.on_launch = kernels.ROI_ALIGN.on_launch = None
        launches["train_net"] = {k.name: k.launches for k in kernels.ALL}
        all_checks["train_net"] = checks
        check_all_passed("st_options train_net", checks, {"nms": 2, "roi_align": 4, "roi_align_backward": 0}, 2, 4, 0)
        check("exemplar table initialized: 1203 slots x 768 dims" in log and "LVIS class names tokenized" in log
              and "LVIS class-name table" not in log, "st_options train_net: the log lacks the options' lines")
        check([r["step"] for r in logged] == [1, 2] and all(np.isfinite(v) for r in logged for v in r.values()),
              f"st_options train_net: logged {logged}")
        saved_table = ck.load_checkpoint(os.path.join(s_dir, "model_0000002.pth"))["trainer"]["exemplars"]
        torch.cuda.empty_cache()
        kernels.reset_launches()
        Trainer.load_state_dict = recording_load
        try:
            resumed, runs["train_net_resume"], log, logged = train_net_run([*common, "SOLVER.MAX_ITER", "3"], s_dir)
        finally:
            Trainer.load_state_dict = load_state
        launches["train_net_resume"] = {k.name: k.launches for k in kernels.ALL}
        check(resumed["start_iter"] == 2 and "resumed from" in log and [r["step"] for r in logged] == [1, 2, 3],
              f"st_options train_net resume: start {resumed['start_iter']}, logged {logged}")
        check(set(restored) == set(saved_table) and all(torch.equal(restored[k], saved_table[k]) for k in restored),
              "st_options train_net resume: the restored exemplar table differs from the saved one")
        check(launches["train_net_resume"] == {"nms": 2, "roi_align": 4, "roi_align_backward": 0},
              f"st_options train_net resume: launches {launches['train_net_resume']}")
        runs["train_net_resume"]["restored_valid_slots"] = int(restored["valid"].sum())
        del resumed
        torch.cuda.empty_cache()
        kernels.reset_launches()
        t = time.perf_counter()
        got = test_net.main(["--config-file", CONFIG, "--device", dev.type, "--ckpt",
                             os.path.join(s_dir, "model_0000003.pth"), *map(str, TRAIN_NET["opts"]), *both,
                             "DATASETS.TEST", f"('{name}',)", "OUTPUT_DIR", e_dir])
        test_s = time.perf_counter() - t
        launches["test_net"] = {k.name: k.launches for k in kernels.ALL}
        _, (val,) = make_data_loader(inf.load_cfg(CONFIG, ["DATASETS.TEST", f"('{name}',)"]), is_train=False)
        bad, _ = metrics_finite(got[name], val)
        check(not bad and "segm/AP" in got[name], f"st_options test_net: non-finite metrics {bad[:5]}")
        runs["test_net"] = dict(seconds=test_s, images=len(val), images_per_s=len(val) / test_s,
                                bbox_AP=got[name]["bbox/AP"], segm_AP=got[name]["segm/AP"])
        emit(dict(phase="st_options_train_net", launches={k: launches[k] for k in ("train_net", "train_net_resume",
                                                                                 "test_net")},
                  train_net=runs["train_net"], resume=runs["train_net_resume"], test_net=runs["test_net"]))
    finally:
        shutil.rmtree(out, ignore_errors=True)
    torch.cuda.empty_cache()

    # (d) the teacher's pseudo-label methods on one serving batch of 8
    pred = Predictor(TEACHER, SERVING["opts"], device=dev)
    pred.load_flax_params(bridge.seeded_flax_params(pred.model, SEED, EMB_PRED_STD))
    model, s = pred.model, pred.model.statics
    rng = np.random.default_rng(SEED + 8)  # the teacher serving phase's inputs
    table = torch.from_numpy(rng.standard_normal((TEACHER_CLASSES, s.emb_dim)).astype(np.float32)).to(dev)
    b, (h, w) = SERVING["batch"], SERVING["hw"]
    images = torch.from_numpy(rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)).to(dev)
    sizes = np.stack([rng.integers(3 * h // 4, h + 1, b), rng.integers(2 * w // 3, w + 1, b)], 1).astype(np.int32)
    sizes[0] = (h, w)
    sizes = torch.from_numpy(sizes).to(dev)
    n_boxes = TRAIN["nouns"]

    def pseudo(_):
        with torch.no_grad():
            x = device_normalize(images, sizes, s.pixel_mean, s.pixel_std, s.to_bgr255)
            branch = model.run_teacher_pseudo_branch(x, sizes, table)
            # the reference's pseudo-mask route: the masks of the chosen boxes
            best = branch.class_logits.amax(-1).masked_fill(~branch.proposals.valid, -float("inf"))
            idx = best.topk(n_boxes, dim=1).indices
            boxes = torch.gather(branch.boxes, 1, idx[..., None].expand(-1, -1, 4))
            return branch, boxes, model.predict_masks_for_boxes(images, sizes, boxes)

    checks, *hooks = launch_checks()
    lat, outs, first, path, peak = fpn_steps(pseudo, [0, 1], 1, capture(checks, hooks, "teacher_pseudo"))
    check_all_passed("teacher_pseudo", checks, first, 1, 2, 0)
    branch, boxes, masks = outs[0]
    p = s.rpn_post_nms_test
    check(branch.embeddings.shape == (b, p, s.emb_dim) and branch.class_logits.shape == (b, p, TEACHER_CLASSES)
          and branch.boxes.shape == (b, p, 4) and masks.shape == (b, n_boxes, 14, 14),
          f"st_options teacher_pseudo: shapes {branch.embeddings.shape} {branch.class_logits.shape} {masks.shape}")
    check(all(bool(torch.isfinite(t).all()) for t in (branch.embeddings, branch.class_logits, branch.boxes, masks))
          and bool(((masks >= 0) & (masks <= 1)).all()), "st_options teacher_pseudo: non-finite or off-range output")
    inside = (branch.boxes[..., 2] <= sizes[:, None, 1] - 1) & (branch.boxes[..., 3] <= sizes[:, None, 0] - 1)
    check(bool(inside.all()), "st_options teacher_pseudo: a regressed box outside its image")
    check(path == {k: v * 2 for k, v in first.items()}, f"st_options teacher_pseudo: launches {path}")
    runs["teacher_pseudo"] = dict(latency_s=lat, peak_memory_gb=peak, proposals=p, chosen_boxes=n_boxes,
                                  valid_proposals=branch.proposals.valid.sum(1).tolist())
    launches["teacher_pseudo"], all_checks["teacher_pseudo"] = path, checks
    emit(dict(phase="st_options_teacher_pseudo", launches=path, first_launches=first, **runs["teacher_pseudo"]))
    del pred, model, outs, branch, boxes, masks
    torch.cuda.empty_cache()

    # (e) build_backbone's trunks at full width in bfloat16, and
    # deform_conv2d on the card against the CPU
    trunks = {}
    x = device_normalize(images, sizes)
    for label, opts in TRUNK_OPTS.items():
        cfg = get_default_cfg()
        cfg.merge_from_list([str(v) for v in opts])
        module, meta = build_backbone(cfg, torch.bfloat16)
        bridge.load_flax_params(module, bridge.seeded_flax_params(module, SEED))
        module = module.to(dev).eval()
        with torch.no_grad():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            feats = module(x)
            ms = cuda_ms(lambda: module(x), ST_OPTIONS["timing_iters"])
        finite = all(bool(torch.isfinite(f).all()) for f in feats)
        check(finite and [f.shape[-1] for f in feats] == [meta["out_channels"]] * len(feats)
              and feats[0].shape[1] == -(-h // meta["strides"][0]),
              f"st_options trunk {label}: shapes {[tuple(f.shape) for f in feats]} or non-finite")
        trunks[label] = dict(ms=ms, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, meta=meta,
                             out_shape=list(feats[0].shape), out_dtype=str(feats[0].dtype))
        del module, feats
        torch.cuda.empty_cache()
    rng = np.random.default_rng(SEED + 32)
    bb, hh, ww, cc = ST_OPTIONS["dcn_check"]
    args = [rng.standard_normal((bb, hh, ww, cc)).astype(np.float32),
            (rng.standard_normal((bb, hh, ww, 18)) * 2).astype(np.float32),
            (rng.standard_normal((3, 3, cc, cc)) / np.sqrt(9 * cc)).astype(np.float32)]
    mask = rng.uniform(0, 1, (bb, hh, ww, 9)).astype(np.float32)
    with torch.no_grad():
        on_card = deform_conv2d(*(torch.from_numpy(a).to(dev) for a in args), mask=torch.from_numpy(mask).to(dev))
        on_cpu = deform_conv2d(*(torch.from_numpy(a) for a in args), mask=torch.from_numpy(mask))
    dcn_err = float((on_card.cpu() - on_cpu).abs().max())
    check(dcn_err <= DCN_TOL * float(on_cpu.abs().max()),
          f"st_options deform_conv2d: card vs CPU {dcn_err} over {DCN_TOL} x {float(on_cpu.abs().max())}")
    # one res4 block's 3x3 conv (8 x 50 x 84, 256 -> 256): deformable in
    # float32, as the DCN trunk runs it, beside cuDNN's in bfloat16 and
    # float32
    xr = torch.randn(b, -(-h // 16), -(-w // 16), 256, device=dev)
    off = torch.randn(*xr.shape[:3], 18, device=dev) * 2
    dmask = torch.rand(*xr.shape[:3], 9, device=dev)
    kern = torch.randn(3, 3, 256, 256, device=dev) / 48
    xc, kc = xr.permute(0, 3, 1, 2), kern.permute(3, 2, 0, 1).contiguous()
    with torch.no_grad():
        res4 = dict(shape=list(xr.shape), deform_f32_ms=cuda_ms(
            lambda: deform_conv2d(xr, off, kern, mask=dmask), ST_OPTIONS["timing_iters"]),
            cudnn_bf16_ms=cuda_ms(lambda: torch.nn.functional.conv2d(
                xc.to(torch.bfloat16), kc.to(torch.bfloat16), padding=1), ST_OPTIONS["timing_iters"]),
            cudnn_f32_ms=cuda_ms(lambda: torch.nn.functional.conv2d(xc, kc, padding=1), ST_OPTIONS["timing_iters"]))
    del xr, off, dmask, kern, xc, kc
    runs["trunks"] = trunks
    runs["res4_conv"] = res4
    runs["deform_conv2d_vs_cpu"] = dict(shape=[bb, hh, ww, cc], max_abs_err=dcn_err,
                                        max_abs_out=float(on_cpu.abs().max()), tol_of_max=DCN_TOL)
    emit(dict(phase="st_options_trunks", trunks=trunks, res4_conv=res4,
              deform_conv2d_vs_cpu=runs["deform_conv2d_vs_cpu"]))
    check(all(v["nms"] > 0 and v["roi_align"] > 0 for v in launches.values()),
          f"st_options: a kernel of a path never launched: {launches}")
    captured.clear()
    out_rec = dict(phase="st_options", dtype="bfloat16", batch=b, image_hw=[h, w], runs=runs, launches=launches,
                   checks={k: check_lists(v) for k, v in all_checks.items()})
    emit(out_rec)
    results["st_options"] = out_rec


def count_syncs(run):
    """The synchronizing CUDA calls one call of ``run`` makes (blocking
    copies, ``.item()``, ...), as ``torch.cuda.set_sync_debug_mode``
    reports them."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchronizing CUDA operation" in str(w.message) for w in caught)


def kernels_line(results):
    """The per-kernel JSON line from the phases' records."""
    serving, train = results["serving"], results["train"]
    t_serving, t_train = results["teacher_serving"], results["teacher_train"]
    nms_rpn, roi_main = results["nms_rpn"], results[("roi_align",) + ROI_MAIN]
    bwd_main = results[("roi_align_backward",) + ROI_BWD_MAIN]
    bwd_teacher = results["roi_align_backward_teacher_rois"]
    ev, tn = results["eval"], results["train_net"]
    mmss = results["mmss_train"]
    oi = results["openimages"]
    oi_evals = oi["evals"].values()
    sup = results["supervised"]
    fp = results["fpn"]
    rn = results["retinanet"]
    op = results["options"]
    so = results["st_options"]

    def st_options_launches(kernel):
        # the exemplar table's and FT_EMB's steps, train_net and test_net
        # with both, the teacher's pseudo-label methods (phase 22)
        return {f"st_options_{path}_launches": n[kernel] for path, n in so["launches"].items()}

    def st_options_errs(field):
        return [x for c in so["checks"].values() for x in c[field]]

    def options_launches(kernel):
        # the C5, keypoint and WSDDN paths (phase 21)
        return {f"options_{path}_launches": n[kernel] for path, n in op["launches"].items()}

    def options_errs(field, prefix, key):
        # the paths' launch checks, and each timed shape's own check
        return [x for c in op["checks"].values() for x in c[field]] + [
            v[key] for k, v in op["new_shapes"].items() if k.split(" ")[0] == prefix]

    def options_shapes(prefix):
        return {k[len(prefix) + 1:]: shape_rec(v) for k, v in op["new_shapes"].items()
                if k.split(" ")[0] == prefix}

    def retina_launches(kernel):
        # RetinaNet's and the RPN-only teacher's paths (phase 20)
        return {f"retinanet_{path}_launches": n[kernel] for path, n in rn["launches"].items()}

    def fpn_launches(kernel):
        # the R-50-FPN models' paths (phase 19)
        return {f"fpn_{path}_launches": n[kernel] for path, n in fp["launches"].items()}

    def fpn_errs(field):
        return [x for c in fp["checks"].values() for x in c[field]]

    def fpn_shapes(prefix):
        return {k[len(prefix) + 1:]: shape_rec(v) for k, v in fp["new_shapes"].items()
                if k.split(" ")[0] == prefix}

    def sup_launches(kernel):
        # the class-specific detectors' and the top-k teachers' paths (phase 18)
        return {f"supervised_{path}_launches": n[kernel] for path, n in sup["launches"].items()}

    def sup_errs(field):
        return [x for c in sup["checks"].values() for x in c[field]]

    def sup_shapes(prefix):
        return {v["shape"]: shape_rec(v) for k, v in sup["new_shapes"].items() if k.startswith(prefix)}

    def oi_launches(kernel):
        # the Conceptual/OpenImages pair's paths (phase 17)
        return {f"openimages_{path}_launches": n[kernel] for path, n in oi["launches"].items()}

    def mmss_launches(kernel):
        # the MMSS path runs none of the detector kernels
        return dict(mmss_train_launches=mmss["launches"][kernel],
                    train_net_mmss_launches=tn["mmss_launches"][kernel])

    def shape_rec(rec):
        return {k: rec[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}

    return {"kernels": [
        dict(name="nms", route="cuda",
             source="cvpr22_cross_modal_pseudo_labeling_torch/csrc/nms.cu",
             replaces="cvpr22_cross_modal_pseudo_labeling_tpu/ops/nms_pallas.py:47",
             launches=serving["launches"]["nms"],
             train_launches=train["launches"]["nms"],
             teacher_serving_launches=t_serving["launches"]["nms"],
             teacher_train_launches=t_train["launches"]["nms"],
             eval_launches=ev["launches"]["nms"],
             eval_launches_per_batch=ev["launches_per_batch"]["nms"],
             train_net_launches=tn["launches"]["nms"],
             **mmss_launches("nms"),
             **oi_launches("nms"),
             openimages_bbox_aug_merge_launches=oi["evals"]["bbox_aug"]["merge_launches"],
             **sup_launches("nms"),
             **fpn_launches("nms"),
             **retina_launches("nms"),
             **options_launches("nms"),
             **st_options_launches("nms"),
             launch_unit="one nms_forward call: a memset, then a mask and a scan "
                         "kernel per column band",
             max_abs_err=float(max(serving["first_batch_checks"]["nms_mismatches"]
                                   + train["first_step_checks"]["nms_mismatches"]
                                   + t_serving["first_batch_checks"]["nms_mismatches"]
                                   + t_train["first_step_checks"]["nms_mismatches"]
                                   + ev["launch_checks"]["nms_mismatches"]
                                   + tn["first_step_checks"]["nms_mismatches"]
                                   + oi["train_checks"]["nms_mismatches"]
                                   + [x for e in oi_evals for x in e["launch_checks"]["nms_mismatches"]]
                                   + oi["evals"]["bbox_aug"]["merge_nms_mismatches"]
                                   + sup_errs("nms_mismatches")
                                   + fpn_errs("nms_mismatches")
                                   + [x for c in rn["checks"].values() for x in c["nms_mismatches"]]
                                   + options_errs("nms_mismatches", "nms", "mismatches")
                                   + st_options_errs("nms_mismatches")
                                   + [results[f"nms_{c[0]}"]["mismatches"] for c in NMS_CASES]
                                   + [results["nms_rpn_dense"]["one_band_mismatches"]])),
             ms=nms_rpn["ms"], plain_ms=nms_rpn["plain_ms"],
             bound_ms=nms_rpn["bound_ms"], bound_by=nms_rpn["bound_by"],
             library_ms=None,
             train_shapes={"8 x 12000 -> 2000": shape_rec(results["nms_rpn_train"])},
             openimages_shapes={v["shape"]: shape_rec(v) for k, v in oi["new_shapes"].items()
                                if k.startswith("nms_")},
             supervised_shapes=sup_shapes("nms_"),
             fpn_shapes=fpn_shapes("nms"),
             retinanet_shapes={k[4:]: shape_rec(v) for k, v in rn["new_shapes"].items()},
             options_shapes=options_shapes("nms")),
        dict(name="roi_align", route="cuda",
             source="cvpr22_cross_modal_pseudo_labeling_torch/csrc/roi_align.cu",
             replaces="tools/proto_pallas_roialign.py:146",
             launches=serving["launches"]["roi_align"],
             train_launches=train["launches"]["roi_align"],
             teacher_serving_launches=t_serving["launches"]["roi_align"],
             teacher_train_launches=t_train["launches"]["roi_align"],
             eval_launches=ev["launches"]["roi_align"],
             eval_launches_per_batch=ev["launches_per_batch"]["roi_align"],
             train_net_launches=tn["launches"]["roi_align"],
             **mmss_launches("roi_align"),
             **oi_launches("roi_align"),
             **sup_launches("roi_align"),
             **fpn_launches("roi_align"),
             **retina_launches("roi_align"),
             **options_launches("roi_align"),
             **st_options_launches("roi_align"),
             fpn_launch_unit="the FPN pooler launches the kernel once a level (P2..P5) into one output; "
                             "each launch counts one",
             max_abs_err=max(serving["first_batch_checks"]["roi_align_max_abs_err"]
                             + train["first_step_checks"]["roi_align_max_abs_err"]
                             + t_serving["first_batch_checks"]["roi_align_max_abs_err"]
                             + t_train["first_step_checks"]["roi_align_max_abs_err"]
                             + ev["launch_checks"]["roi_align_max_abs_err"]
                             + tn["first_step_checks"]["roi_align_max_abs_err"]
                             + oi["train_checks"]["roi_align_max_abs_err"]
                             + [x for e in oi_evals for x in e["launch_checks"]["roi_align_max_abs_err"]]
                             + sup_errs("roi_align_max_abs_err")
                             + fpn_errs("roi_align_max_abs_err")
                             + [v["max_abs_err"] for k, v in fp["new_shapes"].items() if k.startswith("roi_align ")]
                             + options_errs("roi_align_max_abs_err", "roi_align", "max_abs_err")
                             + st_options_errs("roi_align_max_abs_err")
                             + [results[("roi_align",) + c]["max_abs_err"] for c in ROI_CASES]),
             dtypes="bfloat16 features -> bfloat16 output",
             ms=roi_main["ms"], plain_ms=roi_main["plain_ms"],
             bound_ms=roi_main["bound_ms"], bound_by=roi_main["bound_by"],
             library_ms=None,
             train_shapes={f"8 x {c[0]} bf16": shape_rec(results[("roi_align",) + c])
                           for c in ROI_TRAIN},
             openimages_shapes={"pseudo boxes, " + oi["new_shapes"]["roi_align_pseudo_boxes"]["shape"]:
                                shape_rec(oi["new_shapes"]["roi_align_pseudo_boxes"])},
             supervised_shapes=sup_shapes("roi_align_voc") | {
                 "top-2 pseudo boxes, " + sup["new_shapes"]["roi_align_pseudo_boxes_top2"]["shape"]:
                 shape_rec(sup["new_shapes"]["roi_align_pseudo_boxes_top2"])},
             fpn_shapes=fpn_shapes("roi_align"),
             options_shapes=options_shapes("roi_align")),
        dict(name="roi_align_backward", route="cuda",
             source="cvpr22_cross_modal_pseudo_labeling_torch/csrc/roi_align.cu",
             replaces="cvpr22_cross_modal_pseudo_labeling_tpu/ops/roi_align_mxu.py:91 "
                      "(its XLA-derived gradient; no Pallas kernel)",
             launches=t_train["launches"]["roi_align_backward"],
             launches_per_teacher_step=t_train["launches"]["roi_align_backward"] / TRAIN["steps"],
             train_net_launches=tn["launches"]["roi_align_backward"],
             **mmss_launches("roi_align_backward"),
             **oi_launches("roi_align_backward"),
             **sup_launches("roi_align_backward"),
             **fpn_launches("roi_align_backward"),
             **retina_launches("roi_align_backward"),
             **options_launches("roi_align_backward"),
             **st_options_launches("roi_align_backward"),
             launch_unit="one roi_align_backward call: the plan kernel (each roi's tap "
                         "lists), then the tile kernel (each tile of dF summed in shared "
                         "memory, written once in bfloat16)",
             max_abs_err=max(t_train["first_step_checks"]["roi_align_backward_max_abs_err"]
                             + tn["first_step_checks"]["roi_align_backward_max_abs_err"]
                             + oi["train_checks"]["roi_align_backward_max_abs_err"]
                             + sup_errs("roi_align_backward_max_abs_err")
                             + fpn_errs("roi_align_backward_max_abs_err")
                             + options_errs("roi_align_backward_max_abs_err", "roi_align_backward", "max_abs_err")
                             + [results[("roi_align_backward",) + c]["max_abs_err"]
                                for c in ROI_BWD_CASES]
                             + [bwd_teacher["max_abs_err"]]),
             dtypes="bfloat16 cotangent -> bfloat16 dF, float32 sums",
             ms=bwd_main["ms"], plain_ms=bwd_main["plain_ms"],
             bound_ms=bwd_main["bound_ms"], bound_by=bwd_main["bound_by"],
             library_ms=None,
             shared_g_adds_per_s=bwd_main["shared_g_adds_per_s"],
             teacher_step_rois=shape_rec(bwd_teacher),
             supervised_shapes=sup_shapes("roi_align_backward"),
             fpn_shapes=fpn_shapes("roi_align_backward"),
             options_shapes=options_shapes("roi_align_backward")),
    ]}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "cvpr22_cross_modal_pseudo_labeling_torch")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 1
    os.chdir(here)
    sys.path.insert(0, here)
    from cvpr22_cross_modal_pseudo_labeling_torch.ops import kernels

    # the entry points' INFO logs go to their OUTPUT_DIR's log file; only
    # warnings and errors reach this script's output
    import logging

    from cvpr22_cross_modal_pseudo_labeling_torch.utils.logger import setup_logger

    for handler in setup_logger().handlers:
        handler.setLevel(logging.WARNING)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    t = time.perf_counter()
    kernels.build_all()
    by_source = {k.source.name: k for k in kernels.ALL}
    emit(dict(phase="build", seconds=time.perf_counter() - t,
              libraries=[str(k.library_path().name) for k in by_source.values()],
              ptxas={name: k.resource_usage() for name, k in by_source.items()}))

    results = {}
    phase_nms(dev, results)
    phase_roi_align(dev, results)
    phase_small()
    pred, batch, table = phase_serving(dev, results)
    phase_profile(pred, batch, table)
    del pred
    torch.cuda.empty_cache()
    seconds = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[f"{name}_s"] = time.perf_counter() - t
        return out

    timed("small_train", phase_small_train)
    timed("train", phase_train, dev, results)
    torch.cuda.empty_cache()
    timed("roi_align_backward", phase_roi_align_backward, dev, results)
    timed("small_teacher_train", phase_small_teacher_train)
    timed("teacher_serving", phase_teacher_serving, dev, results)
    torch.cuda.empty_cache()
    timed("teacher_train", phase_teacher_train, dev, results)
    torch.cuda.empty_cache()
    timed("roi_align_backward_teacher_rois", phase_roi_align_backward_teacher_rois, dev, results)
    torch.cuda.empty_cache()
    timed("small_mmss_train", phase_small_mmss_train)
    timed("mmss_train", phase_mmss_train, dev, results)
    torch.cuda.empty_cache()
    timed("eval", phase_eval, dev, results)
    torch.cuda.empty_cache()
    timed("train_net", phase_train_net, dev, results)
    torch.cuda.empty_cache()
    timed("openimages", phase_openimages, dev, results)
    torch.cuda.empty_cache()
    timed("supervised", phase_supervised, dev, results)
    torch.cuda.empty_cache()
    timed("fpn", phase_fpn, dev, results)
    torch.cuda.empty_cache()
    timed("retinanet", phase_retinanet, dev, results)
    torch.cuda.empty_cache()
    timed("options", phase_options, dev, results)
    torch.cuda.empty_cache()
    timed("st_options", phase_st_options, dev, results)
    emit(dict(phase="timing", **seconds))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    emit(kernels_line(results))
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
