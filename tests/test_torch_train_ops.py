"""The port's training pieces against the JAX package, one function at
a time: box encoding, the matcher, the sampler, the three losses, the
box-frame mask resampling, RoI subsampling, the box and mask losses and
the mask predictor's uncertainty branch.

The JAX sampler draws its priorities from a key (``jax.random.uniform``
at ``core/sampler.py:58-59``, per image under ``vmap`` after
``jax.random.split(key, b)``); :func:`sampler_draws` computes the same
draws from the same key, and the port takes them as its ``rand``
tensor.  Index, mask and label results are exact; float results carry
the tolerance stated at each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr22_cross_modal_pseudo_labeling_tpu.core import box_coder as jax_coder
from cvpr22_cross_modal_pseudo_labeling_tpu.core import boxes as jax_boxes
from cvpr22_cross_modal_pseudo_labeling_tpu.core import matcher as jax_matcher
from cvpr22_cross_modal_pseudo_labeling_tpu.core import sampler as jax_sampler
from cvpr22_cross_modal_pseudo_labeling_tpu.models.roi_heads import box_head as jax_box
from cvpr22_cross_modal_pseudo_labeling_tpu.models.roi_heads import mask_head as jax_mask
from cvpr22_cross_modal_pseudo_labeling_tpu.ops import losses as jax_losses
from cvpr22_cross_modal_pseudo_labeling_tpu.ops import masks as jax_masks
from cvpr22_cross_modal_pseudo_labeling_torch import bridge
from cvpr22_cross_modal_pseudo_labeling_torch.core import box_coder as torch_coder
from cvpr22_cross_modal_pseudo_labeling_torch.core import matcher as torch_matcher
from cvpr22_cross_modal_pseudo_labeling_torch.core import sampler as torch_sampler
from cvpr22_cross_modal_pseudo_labeling_torch.models.roi_heads import box_head as torch_box
from cvpr22_cross_modal_pseudo_labeling_torch.models.roi_heads import mask_head as torch_mask
from cvpr22_cross_modal_pseudo_labeling_torch.ops import losses as torch_losses
from cvpr22_cross_modal_pseudo_labeling_torch.ops import masks as torch_masks
from tests.test_nms import random_boxes


def T(a):
    return torch.from_numpy(np.array(a))


def pair_draws(key, n):
    """``[2, N]``: the positive and negative priorities the JAX
    ``balanced_sample_masks`` draws from ``key``."""
    kp, kn = jax.random.split(key)
    return np.stack([np.asarray(jax.random.uniform(kp, (n,))), np.asarray(jax.random.uniform(kn, (n,)))])


def sampler_draws(key, b, n):
    """``[B, 2, N]``: the priorities of the JAX ``subsample_rois`` with
    ``key`` over B images of N candidates."""
    return np.stack([pair_draws(k, n) for k in jax.random.split(key, b)])


def _image_boxes(rng, b, n, hw=(96, 128)):
    h, w = hw
    x1 = rng.uniform(-10, w - 8, (b, n))
    y1 = rng.uniform(-10, h - 8, (b, n))
    return np.stack([x1, y1, x1 + rng.uniform(4, 60, (b, n)), y1 + rng.uniform(4, 50, (b, n))],
                    -1).astype(np.float32)


@pytest.mark.parametrize("weights", [(1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)])
def test_encode_boxes_matches_jax(weights):
    """1e-6 relative (a log is involved), 1e-5 absolute on O(1) codes."""
    rng = np.random.RandomState(2)
    gt, props = random_boxes(rng, 80), random_boxes(rng, 80)
    props[:4] = 0.0  # zero-size padded slots: the 1e-8 floor
    props[4:8] = gt[4:8]  # identical pairs encode to zero
    ref = np.asarray(jax_coder.encode_boxes(jnp.asarray(gt), jnp.asarray(props), weights))
    out = torch_coder.encode_boxes(T(gt), T(props), weights).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-5)
    assert not out[4:8].any()
    # decoding the codes gives the gt back
    back = torch_coder.decode_boxes(T(out[8:]), T(props[8:]), weights).numpy()
    np.testing.assert_allclose(back, gt[8:], rtol=0, atol=1e-3)


@pytest.mark.parametrize("allow_low_quality", [False, True])
def test_match_boxes_matches_jax_with_ties(allow_low_quality):
    """Exact codes, for both settings: duplicated gt rows and predictions
    tie on their best IoU, a padded gt row is ignored, and some
    predictions overlap no gt at all."""
    rng = np.random.RandomState(3)
    b, g, n = 3, 6, 70
    gt = _image_boxes(rng, b, g)
    gt[:, 1] = gt[:, 0]  # two identical gt boxes: ties along the gt axis
    props = _image_boxes(rng, b, n)
    props[:, :6] = gt  # each gt's best IoU (1.0) is tied by a duplicate
    props[:, 6] = gt[:, 2]
    props[:, -3:] = [[2000, 2000, 2010, 2010]]  # overlaps nothing
    gvalid = np.ones((b, g), bool)
    gvalid[:, -1] = False
    iou = np.asarray(jax.vmap(jax_boxes.box_iou)(jnp.asarray(gt), jnp.asarray(props)))
    ref = np.asarray(jax.vmap(
        lambda q, v: jax_matcher.match_boxes(q, v, 0.5, 0.3, allow_low_quality)
    )(jnp.asarray(iou), jnp.asarray(gvalid)))
    out = torch_matcher.match_boxes(T(iou), T(gvalid), 0.5, 0.3, allow_low_quality).numpy()
    np.testing.assert_array_equal(out, ref)
    assert {-1, -2} <= set(np.unique(out)) and (out >= 0).any()


@pytest.mark.parametrize("batch_size,fraction,p_pos", [(16, 0.25, 0.3), (16, 1.0, 0.1), (8, 0.5, 0.0)])
def test_sampler_matches_jax(batch_size, fraction, p_pos):
    """The sampled masks and the compacted indices, valid and positive
    slots are exact: the same priorities, top-k with the lower index
    first among ties, positives first."""
    rng = np.random.RandomState(int(p_pos * 10) + batch_size)
    b, n = 3, 50
    pos = rng.uniform(size=(b, n)) < p_pos
    neg = ~pos & (rng.uniform(size=(b, n)) < 0.6)
    neg[2] = False  # an image with no negatives
    key = jax.random.PRNGKey(batch_size)
    keys = jax.random.split(key, b)
    ref_masks = [jax_sampler.balanced_sample_masks(jnp.asarray(pos[i]), jnp.asarray(neg[i]), keys[i],
                                                   batch_size, fraction) for i in range(b)]
    ref_idx = [jax_sampler.balanced_sample_indices(jnp.asarray(pos[i]), jnp.asarray(neg[i]), keys[i],
                                                   batch_size, fraction) for i in range(b)]
    rand = T(np.stack([pair_draws(k, n) for k in keys]))
    sp, sn = torch_sampler.balanced_sample_masks(T(pos), T(neg), rand, batch_size, fraction)
    idx, valid, is_pos = torch_sampler.balanced_sample_indices(T(pos), T(neg), rand, batch_size, fraction)
    for i in range(b):
        np.testing.assert_array_equal(sp[i].numpy(), np.asarray(ref_masks[i][0]))
        np.testing.assert_array_equal(sn[i].numpy(), np.asarray(ref_masks[i][1]))
        for got, want in zip((idx[i], valid[i], is_pos[i]), ref_idx[i]):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(sp.sum()) <= b * int(batch_size * fraction)


def test_sampler_without_draws_uses_the_generator():
    pos = torch.zeros((2, 40), dtype=torch.bool)
    pos[:, :10] = True
    draws = [torch_sampler.draw_priorities(2, 40, "cpu", torch.Generator().manual_seed(5)) for _ in range(2)]
    assert torch.equal(draws[0], draws[1]) and draws[0].shape == (2, 2, 40)
    idx, valid, is_pos = torch_sampler.balanced_sample_indices(pos, ~pos, draws[0], 16, 0.25)
    assert valid.all() and int(is_pos.sum()) == 8 and bool((idx[is_pos] < 10).all())


@pytest.mark.parametrize("beta", [1.0, 1.0 / 9])
def test_losses_match_jax(beta):
    """Elementwise smooth-L1, softmax CE and BCE-with-logits, 1e-6
    relative (log and exp may differ in the last bit)."""
    rng = np.random.RandomState(4)
    pred, target = rng.normal(0, 1, (2, 64, 4)).astype(np.float32), rng.normal(0, 1, (2, 64, 4)).astype(np.float32)
    np.testing.assert_allclose(
        torch_losses.smooth_l1_loss(T(pred), T(target), beta).numpy(),
        np.asarray(jax_losses.smooth_l1_loss(jnp.asarray(pred), jnp.asarray(target), beta)),
        rtol=1e-6, atol=1e-7,
    )
    logits = rng.normal(0, 4, (64, 7)).astype(np.float32)
    labels = rng.randint(-1, 9, 64).astype(np.int32)  # out of range: clipped
    np.testing.assert_allclose(
        torch_losses.softmax_cross_entropy(T(logits), T(labels)).numpy(),
        np.asarray(jax_losses.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels))),
        rtol=1e-6, atol=1e-6,
    )
    x = rng.normal(0, 8, (3, 14, 14)).astype(np.float32)
    t = (rng.uniform(size=x.shape) > 0.5).astype(np.float32)
    np.testing.assert_allclose(
        torch_losses.binary_cross_entropy_with_logits(T(x), T(t)).numpy(),
        np.asarray(jax_losses.binary_cross_entropy_with_logits(jnp.asarray(x), jnp.asarray(t))),
        rtol=1e-6, atol=1e-6,
    )


def test_crop_resize_from_box_frame_matches_jax():
    """Values within 1e-6; the targets binarized at 0.5 are exact
    wherever |t - 0.5| > 1e-5.  Destination boxes straddle, contain and
    equal their source boxes."""
    rng = np.random.RandomState(5)
    r, m = 64, 28
    src_mask = rng.uniform(size=(r, m, m)).astype(np.float32)
    src = _image_boxes(rng, 1, r)[0]
    dst = src + rng.normal(0, 8, (r, 4)).astype(np.float32)
    dst[:8] = src[:8]  # the same frame: samples at pixel centers
    dst[8:16] = src[8:16] + np.float32([-40, -40, 40, 40])  # taps outside the source
    ref = np.asarray(jax_masks.crop_resize_from_box_frame_batch(
        jnp.asarray(src_mask), jnp.asarray(src), jnp.asarray(dst), (14, 14)))
    out = torch_masks.crop_resize_from_box_frame(T(src_mask), T(src), T(dst), (14, 14)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    far = np.abs(ref - 0.5) > 1e-5
    np.testing.assert_array_equal((out >= 0.5)[far], (ref >= 0.5)[far])
    assert not out[8:16, 0, 0].any()  # a corner outside the source is zero


def test_project_masks_on_boxes_matches_jax():
    rng = np.random.RandomState(6)
    b, g, s = 2, 4, 12
    gt_masks = rng.uniform(size=(b, g, 28, 28)).astype(np.float32)
    gt_boxes = _image_boxes(rng, b, g)
    props = _image_boxes(rng, b, s)
    matched = rng.randint(0, g, (b, s))
    ref = np.asarray(jax.vmap(lambda gm, gb, pb, mi: jax_masks.project_masks_on_boxes(gm, gb, pb, mi, 14))(
        jnp.asarray(gt_masks), jnp.asarray(gt_boxes), jnp.asarray(props), jnp.asarray(matched)))
    out = torch_masks.project_masks_on_boxes(T(gt_masks), T(gt_boxes), T(props), T(matched), 14).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


def _sampling_case(seed, b=2, n=60, g=5):
    rng = np.random.RandomState(seed)
    gt = _image_boxes(rng, b, g)
    props = _image_boxes(rng, b, n)
    props[:, :g] = gt + rng.normal(0, 2, gt.shape).astype(np.float32)  # positives
    pvalid = rng.uniform(size=(b, n)) > 0.1
    gvalid = np.ones((b, g), bool)
    gvalid[1, -2:] = False
    labels = rng.randint(1, 9, (b, g)).astype(np.int32)
    return props, pvalid, gt, labels, gvalid


@pytest.mark.parametrize("fraction", [0.25, 1.0])
def test_subsample_rois_matches_jax(fraction):
    """Sampled boxes, labels, valid and positive slots and matched gt are
    exact; the regression targets 1e-5 (they go through a log)."""
    props, pvalid, gt, labels, gvalid = _sampling_case(7)
    key = jax.random.PRNGKey(11)
    ref = jax_box.subsample_rois(
        jnp.asarray(props), jnp.asarray(pvalid), jnp.asarray(gt), jnp.asarray(labels),
        jnp.asarray(gvalid), key, 32, fraction, 0.5, 0.5, (10.0, 10.0, 5.0, 5.0),
    )
    out = torch_box.subsample_rois(
        T(props), T(pvalid), T(gt), T(labels), T(gvalid), T(sampler_draws(key, 2, props.shape[1])),
        batch_size_per_image=32, positive_fraction=fraction,
    )
    for name in ("boxes", "labels", "valid", "is_pos", "matched_gt"):
        np.testing.assert_array_equal(getattr(out, name).numpy(), np.asarray(getattr(ref, name)), err_msg=name)
    np.testing.assert_allclose(out.reg_targets.numpy(), np.asarray(ref.reg_targets), rtol=1e-6, atol=1e-5)
    assert out.is_pos.any() and (out.valid & ~out.is_pos).any()
    head = out.head(8)
    assert head.boxes.shape == (2, 8, 4) and torch.equal(head.is_pos, out.is_pos[:, :8])


def _sampled(seed, s=32, fraction=0.5):
    props, pvalid, gt, labels, gvalid = _sampling_case(seed)
    key = jax.random.PRNGKey(seed)
    ref = jax_box.subsample_rois(
        jnp.asarray(props), jnp.asarray(pvalid), jnp.asarray(gt), jnp.asarray(labels),
        jnp.asarray(gvalid), key, s, fraction, 0.5, 0.5, (10.0, 10.0, 5.0, 5.0),
    )
    out = torch_box.SampledRoIs(*(T(np.asarray(a)).to(torch.int64) if np.asarray(a).dtype == np.int32
                                  else T(np.asarray(a)) for a in ref))
    return ref, out, gt


def test_box_head_loss_matches_jax():
    """Background-weighted CE and the positives' smooth-L1, each over the
    valid slots: 1e-6 relative."""
    ref_s, s, _ = _sampled(8)
    rng = np.random.RandomState(8)
    logits = rng.normal(0, 3, (64, 9)).astype(np.float32)
    deltas = rng.normal(0, 1, (64, 8)).astype(np.float32)
    ref = jax_box.box_head_loss(jnp.asarray(logits), jnp.asarray(deltas), ref_s, bg_weight=0.2)
    out = torch_box.box_head_loss(T(logits), T(deltas), s, bg_weight=0.2)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6)


@pytest.mark.parametrize("num_samples", [1, 3])
@pytest.mark.parametrize("estimator", ["sampled_bce", "logmeanexp"])
def test_mask_head_loss_matches_jax(estimator, num_samples):
    """Targets projected from the matched gt masks and binarized, then
    the mean BCE of the positives' pixels, the sample axis collapsed per
    estimator: 1e-5 relative (a sum over 10^4 pixels in another order).
    The gt masks take values whose 0.5 crossings are not ties."""
    ref_s, s, gt = _sampled(9)
    rng = np.random.RandomState(9)
    gt_masks = rng.choice(np.float32([0.2, 0.9]), (2, 5, 28, 28))
    logits = rng.normal(0, 2, (num_samples, 64, 14, 14, 2)).astype(np.float32)
    ref = jax_mask.mask_head_loss(jnp.asarray(logits), ref_s, jnp.asarray(gt_masks), jnp.asarray(gt),
                                  estimator=estimator)
    out = torch_mask.mask_head_loss(T(logits), s, T(gt_masks), T(gt), estimator=estimator)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5)
    if num_samples == 1:
        plain = torch_mask.mask_head_loss(T(logits[0]), s, T(gt_masks), T(gt), estimator=estimator)
        np.testing.assert_allclose(plain.numpy(), out.numpy(), rtol=1e-7)
    with pytest.raises(ValueError, match="estimator"):
        torch_mask.mask_head_loss(T(logits), s, T(gt_masks), T(gt), estimator="mean")


@pytest.mark.parametrize("sigma_max", [0.0, 0.8])
def test_mask_predictor_uncertainty_matches_jax(sigma_max):
    """Logits, sigma and the reparameterized samples on the same eps
    (1e-5 absolute on O(1) logits); sigma reads the upsampled features
    detached, so it sends no gradient into ``conv5_mask``."""
    tm = torch_mask.MaskPredictor(in_channels=16, num_classes=2, dim_reduced=8, uncertainty=True,
                                  sigma_max=sigma_max)
    tree = bridge.seeded_flax_params(tm, seed=12)
    # a He-scale log-variance kernel (the seeded tree draws its 0.001
    # init), so that sigma spreads to both sides of the cap
    kernel = tree["uncertain_pred"]["kernel"]
    tree["uncertain_pred"]["kernel"] = (np.random.default_rng(12).standard_normal(kernel.shape)
                                        * np.sqrt(2.0 / 8)).astype(np.float32)
    tree["uncertain_pred"]["bias"] = np.full((1,), 0.4, np.float32) if sigma_max else tree["uncertain_pred"]["bias"]
    bridge.load_flax_params(tm, tree)
    rng = np.random.RandomState(12)
    x = rng.normal(0, 1, (6, 7, 7, 16)).astype(np.float32)
    eps = rng.normal(0, 1, (3, 6, 14, 14, 2)).astype(np.float32)
    jm = jax_mask.MaskPredictor(num_classes=2, dim_reduced=8, uncertainty=True, sigma_max=sigma_max)
    orig = jax.random.normal
    jax.random.normal = lambda key, shape, dtype=jnp.float32: jnp.asarray(eps, dtype)
    try:
        ref_logits, ref_scale = jm.apply({"params": jax.tree_util.tree_map(jnp.asarray, tree)}, jnp.asarray(x),
                                         compute_uncertain=True, train=True, num_samples=3,
                                         rngs={"uncertainty": jax.random.PRNGKey(0)})
    finally:
        jax.random.normal = orig
    xt = T(x)
    logits, scale = tm(xt, compute_uncertain=True, train=True, num_samples=3, eps=T(eps))
    np.testing.assert_allclose(scale.detach().numpy(), np.asarray(ref_scale), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref_logits), rtol=0, atol=1e-5)
    if sigma_max:
        assert float(scale.max()) <= sigma_max * (1 + 1e-6)
    scale.sum().backward()
    assert tm.conv5_mask.weight.grad is None and tm.uncertain_pred.weight.grad.abs().sum() > 0
    plain, no_scale = tm(xt)
    assert no_scale is None and plain.shape == (6, 14, 14, 2)


def test_mask_predictor_initializers_and_sigma_floor():
    """New student weights start from the JAX initializers: uncertain_pred
    normal(0.001) with bias 1.  A sigma cap under exp(-15) would invert
    the log-variance clip and is refused."""
    torch.manual_seed(0)
    tm = torch_mask.MaskPredictor(in_channels=16, dim_reduced=256, uncertainty=True)
    w = tm.uncertain_pred.weight
    assert torch.equal(tm.uncertain_pred.bias, torch.ones(1))
    assert 0.0007 < float(w.std()) < 0.0013
    with pytest.raises(ValueError, match="SIGMA_MAX"):
        torch_mask.MaskPredictor(uncertainty=True, sigma_max=1e-7)
    torch_mask.MaskPredictor(uncertainty=True, sigma_max=1e-6)
