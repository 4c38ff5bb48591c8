"""The weight bridge: a JAX-initialized student-teacher param tree maps
leaf for leaf onto the port's state_dict and back, bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr22_cross_modal_pseudo_labeling_tpu.models.detector import (
    st_generalized_rcnn as jax_st,
)
from cvpr22_cross_modal_pseudo_labeling_tpu.models.roi_heads.mask_head import (
    MaskPredictor as JaxMaskPredictor,
)
from cvpr22_cross_modal_pseudo_labeling_torch import bridge
from cvpr22_cross_modal_pseudo_labeling_torch.models.detector import (
    st_generalized_rcnn as torch_st,
)
from cvpr22_cross_modal_pseudo_labeling_torch.models.roi_heads.mask_head import MaskPredictor
from tests.test_torch_st_eval import tiny_statics


def _numpy_tree(tree):
    return {k: _numpy_tree(v) if hasattr(v, "items") else np.asarray(v) for k, v in tree.items()}


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


@pytest.fixture(scope="module")
def jax_tree():
    """A train-mode JAX init of the tiny model: the call that creates
    every leaf (teacher, word table, the student's uncertain_pred)."""
    js, _ = tiny_statics()
    # training-only caps, small enough for 32 eval proposals; they shape
    # no parameter
    js = js._replace(lvis_vocab=4, base=js.base._replace(
        roi_batch_per_image=16, rpn_pre_nms_train=64, rpn_post_nms_train=16, max_gt=1,
    ))
    m = jax_st.STGeneralizedRCNN(js)
    b, nw, t = 1, 2, 3
    rng = np.random.RandomState(0)
    batch = {
        "cap_mask": jnp.array([True]),
        "det_mask": jnp.array([True]),
        "cap_tok_ids": jnp.asarray(rng.randint(5, 64, (b, nw, t)), jnp.int32),
        "cap_tok_mask": jnp.ones((b, nw, t), jnp.int32),
        "cap_word_valid": jnp.array([[True, False]]),
        "cap_labels": jnp.zeros((b, nw), jnp.int32),
        "gt_boxes": jnp.array([[[4.0, 4.0, 30.0, 30.0]]]),
        "gt_labels": jnp.ones((b, 1), jnp.int32),
        "gt_valid": jnp.array([[True]]),
        "gt_masks": jnp.ones((b, 1, 28, 28)),
    }
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(("params", "sampler", "uncertainty"))}
    images = jnp.zeros((b, 32, 32, 3), jnp.uint8)
    sizes = jnp.array([[32, 32]], jnp.int32)
    params = jax.jit(
        lambda r: m.init(r, images, sizes, batch, jnp.ones((3, 16)), jnp.ones((4, 16)), train=True)
    )(rngs)["params"]
    return _numpy_tree(params)


def test_every_leaf_maps_exactly_once_and_inverts_bit_for_bit(jax_tree):
    _, ts = tiny_statics()
    model = torch_st.STGeneralizedRCNN(ts)
    sd = bridge.state_dict_from_flax(model, {"params": jax_tree})
    leaves = dict(_leaves(jax_tree))
    assert len(sd) == len(leaves) == len(model.state_dict())
    model.load_state_dict(sd, strict=True)
    back = dict(_leaves(bridge.flax_from_state_dict(model)))
    assert back.keys() == leaves.keys()
    for path, value in leaves.items():
        assert back[path].dtype == np.float32
        np.testing.assert_array_equal(back[path], value, err_msg="/".join(path))
    # layouts: conv HWIO -> OIHW, dense [in, out] -> [out, in], the
    # transposed conv (in, out) with both spatial axes flipped
    k = jax_tree["backbone"]["body"]["stem"]["conv1"]["kernel"]
    np.testing.assert_array_equal(sd["backbone.body.stem.conv1.weight"].numpy(), k.transpose(3, 2, 0, 1))
    k = jax_tree["student"]["box_predictor"]["emb_pred"]["kernel"]
    np.testing.assert_array_equal(sd["student.box_predictor.emb_pred.weight"].numpy(), k.T)
    k = jax_tree["student"]["mask_predictor"]["conv5_mask"]["kernel"]
    np.testing.assert_array_equal(
        sd["student.mask_predictor.conv5_mask.weight"].numpy(),
        k.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1],
    )
    bn = jax_tree["backbone"]["body"]["stem"]["bn1"]
    np.testing.assert_array_equal(sd["backbone.body.stem.bn1.running_var"].numpy(), bn["frozen_bn_var"])


def test_conv_transpose_layout_computes_the_flax_function():
    rng = np.random.RandomState(0)
    x = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    jm = JaxMaskPredictor(num_classes=2, dim_reduced=6)
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"]
    tm = MaskPredictor(in_channels=16, num_classes=2, dim_reduced=6).eval()
    bridge.load_flax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x))[0])
    with torch.no_grad():
        out = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_unmatched_missing_or_misshapen_leaves_raise(jax_tree):
    _, ts = tiny_statics()
    model = torch_st.STGeneralizedRCNN(ts)
    extra = dict(jax_tree, rogue={"kernel": np.zeros((1, 1), np.float32)})
    with pytest.raises(KeyError, match="rogue"):
        bridge.state_dict_from_flax(model, extra)
    partial = {k: v for k, v in jax_tree.items() if k != "rpn_head"}
    with pytest.raises(KeyError, match="unset"):
        bridge.state_dict_from_flax(model, partial)
    bad = dict(jax_tree, lambda_exemplar=np.zeros((2,), np.float32))
    with pytest.raises(ValueError, match="lambda_exemplar"):
        bridge.state_dict_from_flax(model, bad)
