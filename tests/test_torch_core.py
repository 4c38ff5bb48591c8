"""The port's box geometry, box decoding, anchors, top-k, row
normalization and device-side image normalization against the JAX
package.  Exact, except where an exp or rsqrt is involved (1e-6
relative: the two libraries' transcendental functions may differ in the
last bit)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr22_cross_modal_pseudo_labeling_tpu.core import box_coder as jax_coder
from cvpr22_cross_modal_pseudo_labeling_tpu.core import boxes as jax_boxes
from cvpr22_cross_modal_pseudo_labeling_tpu.models import backbone as jax_backbone
from cvpr22_cross_modal_pseudo_labeling_tpu.models.detector import st_generalized_rcnn as jax_st
from cvpr22_cross_modal_pseudo_labeling_tpu.models.rpn import anchors as jax_anchors
from cvpr22_cross_modal_pseudo_labeling_tpu.models.rpn import rpn as jax_rpn
from cvpr22_cross_modal_pseudo_labeling_torch.core import box_coder as torch_coder
from cvpr22_cross_modal_pseudo_labeling_torch.core import boxes as torch_boxes
from cvpr22_cross_modal_pseudo_labeling_torch.models import backbone as torch_backbone
from cvpr22_cross_modal_pseudo_labeling_torch.models.detector import st_generalized_rcnn as torch_st
from cvpr22_cross_modal_pseudo_labeling_torch.models.rpn import anchors as torch_anchors
from cvpr22_cross_modal_pseudo_labeling_torch.models.rpn import rpn as torch_rpn
from tests.test_nms import random_boxes

T = torch.from_numpy


def test_box_iou_clip_and_nonempty_are_exact():
    rng = np.random.RandomState(0)
    a, b = random_boxes(rng, 40), random_boxes(rng, 30)
    b[:5] = a[:5]  # identical pairs
    b[5:10, 2:] = b[5:10, :2] - 1.5  # degenerate boxes
    np.testing.assert_array_equal(
        torch_boxes.box_iou(T(a), T(b)).numpy(), np.asarray(jax_boxes.box_iou(a, b))
    )
    size = np.array([[150, 120], [90, 200]], np.int32)
    batched = np.stack([a[:20], a[20:]]) * 1.3 - 20
    np.testing.assert_array_equal(
        torch_boxes.clip_to_image(T(batched), T(size)).numpy(),
        np.asarray(jax_boxes.clip_to_image(jnp.asarray(batched), jnp.asarray(size))),
    )
    for min_size in (0.0, 20.0):
        np.testing.assert_array_equal(
            torch_boxes.nonempty_mask(T(b), min_size).numpy(),
            np.asarray(jax_boxes.nonempty_mask(b, min_size)),
        )


@pytest.mark.parametrize("weights", [(1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)])
def test_decode_boxes_matches_jax_including_the_clip(weights):
    rng = np.random.RandomState(1)
    boxes = random_boxes(rng, 64)
    codes = rng.normal(0, 2, (64, 8)).astype(np.float32)
    codes[:8, 2:4] = 40.0  # far above log(1000/16) * weight: clipped
    ref = np.asarray(jax_coder.decode_boxes(jnp.asarray(codes), jnp.asarray(boxes), weights))
    out = torch_coder.decode_boxes(T(codes), T(boxes), weights).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("shape,stride,sizes", [
    ((5, 7), 16, (32, 64, 128, 256, 512)),
    ((50, 84), 16, (32, 64, 128, 256, 512)),
    ((3, 4), 8, (16, 48)),
])
def test_anchors_are_exact_and_in_flatten_order(shape, stride, sizes):
    ratios = (0.5, 1.0, 2.0)
    np.testing.assert_array_equal(
        torch_anchors.generate_cell_anchors(stride, sizes, ratios),
        jax_anchors.generate_cell_anchors(stride, sizes, ratios),
    )
    (ours,) = torch_anchors.build_anchors_for_levels([shape], [stride], sizes, ratios, "cpu")
    (ref,) = jax_anchors.build_anchors_for_levels([shape], [stride], sizes, ratios)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    # (y, x, a) order: the NHWC head output flattens onto the same rows
    a = len(sizes) * len(ratios)
    obj = np.arange(2 * shape[0] * shape[1] * a, dtype=np.float32).reshape(2, *shape, a)
    reg = np.arange(obj.size * 4, dtype=np.float32).reshape(2, *shape, 4 * a)
    t_obj, t_reg = torch_rpn.flatten_rpn_outputs([T(obj)], [T(reg)])
    j_obj, j_reg = jax_rpn.flatten_rpn_outputs([obj], [reg])
    np.testing.assert_array_equal(t_obj.numpy(), np.asarray(j_obj))
    np.testing.assert_array_equal(t_reg.numpy(), np.asarray(j_reg))
    assert t_obj.shape[1] == ours.shape[0]


def test_top_k_breaks_ties_like_jax():
    rng = np.random.RandomState(2)
    x = rng.randint(0, 5, (3, 200)).astype(np.float32)
    x[:, ::7] = -1.0
    v, i = torch_rpn.top_k(T(x), 50)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 50)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


def test_normalize_rows_matches_jax():
    rng = np.random.RandomState(3)
    x = rng.normal(0, 3, (7, 16)).astype(np.float32)
    x[0] = 0.0  # the zero background row stays zero
    out = torch_st.normalize_rows(T(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(jax_st.normalize_rows(jnp.asarray(x))), rtol=1e-6, atol=1e-7)
    assert not out[0].any()


def test_device_normalize_is_exact():
    rng = np.random.RandomState(4)
    images = rng.randint(0, 256, (3, 20, 24, 3)).astype(np.uint8)
    sizes = np.array([[20, 24], [13, 24], [20, 9]], np.int32)
    for to_bgr in (True, False):
        kw = dict(pixel_mean=(102.9801, 115.9465, 122.7717), pixel_std=(57.0, 58.0, 59.0),
                  to_bgr255=to_bgr)
        out = torch_backbone.device_normalize(T(images), T(sizes), **kw).numpy()
        ref = np.asarray(jax_backbone.device_normalize(jnp.asarray(images), jnp.asarray(sizes), **kw))
        np.testing.assert_array_equal(out, ref)
    assert not out[1, 13:].any() and not out[2, :, 9:].any()
    f = T(images.astype(np.float32))
    assert torch_backbone.device_normalize(f, T(sizes)) is f
