"""The port's student-teacher eval forward against the JAX package.

The same flax-layout weights (numpy draws, loaded into the port through
``bridge.py``) and the same uint8 batch go through the JAX
``STGeneralizedRCNN.apply(train=False)`` and the port's
``STGeneralizedRCNN`` on the CPU, at a narrow width (stem 8, res2 16,
width 4, EMB_DIM 16, RPN 128 -> 32, 64 x 64 images).

Tolerances (float32): boxes 1e-3 px, scores 1e-5, mask probabilities
1e-4 -- only the convolutions' summation order differs; labels and
valid masks are equal.  The bfloat16 backbone comparison allows 2% of
the feature range: both sides round every conv and frozen-BN output to
bfloat16 (8 bits of mantissa), at different places inside fused ops.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr22_cross_modal_pseudo_labeling_tpu.config import get_default_cfg as jax_cfg
from cvpr22_cross_modal_pseudo_labeling_tpu.models import backbone as jax_backbone
from cvpr22_cross_modal_pseudo_labeling_tpu.models.detector import (
    st_generalized_rcnn as jax_st,
)
from cvpr22_cross_modal_pseudo_labeling_torch import bridge
from cvpr22_cross_modal_pseudo_labeling_torch.config import get_default_cfg as torch_cfg
from cvpr22_cross_modal_pseudo_labeling_torch.engine.inference import Predictor
from cvpr22_cross_modal_pseudo_labeling_torch.models import backbone as torch_backbone
from cvpr22_cross_modal_pseudo_labeling_torch.models.detector import (
    st_generalized_rcnn as torch_st,
)

CONFIG = "configs/coco_cap_det/student_teacher_mask_rcnn_uncertainty.yaml"
TINY_OPTS = [
    "MODEL.RESNETS.STEM_OUT_CHANNELS", 8,
    "MODEL.RESNETS.RES2_OUT_CHANNELS", 16,
    "MODEL.RESNETS.WIDTH_PER_GROUP", 4,
    "MODEL.ROI_BOX_HEAD.EMB_DIM", 16,
    "MODEL.RPN.PRE_NMS_TOP_N_TEST", 128,
    "MODEL.RPN.POST_NMS_TOP_N_TEST", 32,
    "MODEL.ROI_MASK_HEAD.CONV_LAYERS", (8,),
    "TPU.COMPUTE_DTYPE", "float32",
    "TPU.NMS_TILE", 64,
]


def tiny_statics(dtype="float32"):
    """(JAX statics, port statics) of the tiny ST config."""
    out = []
    for get, mod in ((jax_cfg, jax_st), (torch_cfg, torch_st)):
        cfg = get()
        cfg.merge_from_file(CONFIG)
        cfg.merge_from_list(TINY_OPTS + ["TPU.COMPUTE_DTYPE", dtype])
        out.append(mod.st_statics_from_cfg(cfg)._replace(vocab_size=64))
    return tuple(out)


def tiny_inputs(seed=1):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    sizes = np.array([[64, 64], [48, 64]], np.int32)
    table = rng.standard_normal((6, 16)).astype(np.float32)
    table[0] = 0.0
    return images, sizes, table


@pytest.fixture(scope="module")
def tiny_f32():
    js, ts = tiny_statics()
    model = torch_st.STGeneralizedRCNN(ts).eval()
    tree = bridge.seeded_flax_params(model, seed=0, emb_pred_std=0.01)
    bridge.load_flax_params(model, tree)
    return js, model, tree


def _jax_eval(statics, tree, images, sizes, table):
    m = jax_st.STGeneralizedRCNN(statics)
    fn = jax.jit(
        lambda p, i, s, c: m.apply({"params": p}, i, s, class_embeddings=c, train=False)
    )
    return fn(jax.tree_util.tree_map(jnp.asarray, tree), images, sizes, table)


def test_st_eval_matches_jax(tiny_f32):
    js, model, tree = tiny_f32
    images, sizes, table = tiny_inputs()
    ref = _jax_eval(js, tree, images, sizes, table)
    with torch.no_grad():
        out = model(torch.from_numpy(images), torch.from_numpy(sizes), torch.from_numpy(table))
    rd, od = ref.detections, out.detections
    valid = np.asarray(rd.valid)
    assert valid.sum(axis=1).min() > 0, "the tiny model should detect something per image"
    np.testing.assert_array_equal(od.valid.numpy(), valid)
    np.testing.assert_array_equal(od.labels.numpy(), np.asarray(rd.labels))
    np.testing.assert_allclose(od.boxes.numpy(), np.asarray(rd.boxes), rtol=0, atol=1e-3)
    np.testing.assert_allclose(od.scores.numpy(), np.asarray(rd.scores), rtol=0, atol=1e-5)
    assert out.mask_probs.shape == (2, 100, 14, 14)
    np.testing.assert_allclose(
        out.mask_probs.numpy(), np.asarray(ref.mask_probs), rtol=0, atol=1e-4
    )


def test_predictor_on_cpu_matches_model(tiny_f32):
    """The entry point returns numpy detections equal to the module's."""
    _, model, tree = tiny_f32
    pred = Predictor(CONFIG, TINY_OPTS, device="cpu")
    pred.model = torch_st.STGeneralizedRCNN(model.statics).eval()
    pred.load_flax_params(tree)
    images, sizes, table = tiny_inputs()
    dets, masks = pred(images, sizes, table)
    with torch.no_grad():
        out = model(torch.from_numpy(images), torch.from_numpy(sizes), torch.from_numpy(table))
    assert isinstance(dets.boxes, np.ndarray) and isinstance(masks, np.ndarray)
    np.testing.assert_array_equal(dets.boxes, out.detections.boxes.numpy())
    np.testing.assert_array_equal(dets.valid, out.detections.valid.numpy())
    np.testing.assert_array_equal(masks, out.mask_probs.numpy())


def test_bf16_backbone_features_match_jax():
    js, ts = tiny_statics("bfloat16")
    sb = ts.base
    jm = jax_backbone.ResNetBackbone(
        depth="R-50", num_stages=3, stem_out_channels=sb.stem_out_channels,
        res2_out_channels=sb.res2_out_channels, width_per_group=sb.width_per_group,
        dtype=jnp.bfloat16,
    )
    tm = torch_backbone.ResNetBackbone(
        depth="R-50", stem_out_channels=sb.stem_out_channels,
        res2_out_channels=sb.res2_out_channels, width_per_group=sb.width_per_group,
        dtype=torch.bfloat16,
    ).eval()
    tree = bridge.seeded_flax_params(tm, seed=3)
    bridge.load_flax_params(tm, tree)
    images, sizes, _ = tiny_inputs(seed=4)
    x = np.array(jax_backbone.device_normalize(jnp.asarray(images), jnp.asarray(sizes)))
    ref = jm.apply({"params": jax.tree_util.tree_map(jnp.asarray, tree)}, jnp.asarray(x))[0]
    with torch.no_grad():
        out = tm(torch.from_numpy(x))[0]
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    ref = np.asarray(ref.astype(jnp.float32))
    diff = np.abs(out.float().numpy() - ref).max()
    assert diff <= 0.02 * np.abs(ref).max(), (diff, np.abs(ref).max())


def test_training_forward_is_not_ported(tiny_f32):
    _, model, _ = tiny_f32
    images, sizes, table = tiny_inputs()
    with pytest.raises(NotImplementedError, match="training slice"):
        model(torch.from_numpy(images), torch.from_numpy(sizes), torch.from_numpy(table), train=True)


def test_predictor_needs_a_card_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(CONFIG, TINY_OPTS)
    pred = Predictor(CONFIG, TINY_OPTS, device="cpu")
    assert next(pred.model.parameters()).device.type == "cpu"
