"""The port's RPN training pieces against the JAX package: anchor
visibility, the RPN loss on the JAX program's own sampler draws, and the
proposal selector's cut of the gradient.

``rpn_loss`` runs on 300 random anchors against 5 padded gt boxes per
image: the port takes the per-image priorities that the JAX function
draws from its key (``jax.random.split`` per image, then one uniform
draw for the positives and one for the negatives), so both sample the
same anchors.  Tolerance: 1e-5 relative on both losses (float32; the
IoU, matching and sampling agree exactly, only the order of the sums
differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr22_cross_modal_pseudo_labeling_tpu.models.rpn import anchors as jax_anchors
from cvpr22_cross_modal_pseudo_labeling_tpu.models.rpn import rpn as jax_rpn
from cvpr22_cross_modal_pseudo_labeling_torch.models.rpn import anchors as torch_anchors
from cvpr22_cross_modal_pseudo_labeling_torch.models.rpn import rpn as torch_rpn


def jax_priorities(key, b, n):
    """``[B, 2, N]``: the uniforms the JAX balanced sampler draws per
    image from ``key``."""
    draws = []
    for k in jax.random.split(key, b):
        kp, kn = jax.random.split(k)
        draws.append(np.stack([np.asarray(jax.random.uniform(kp, (n,))),
                               np.asarray(jax.random.uniform(kn, (n,)))]))
    return torch.from_numpy(np.stack(draws).astype(np.float32))


def _anchors():
    cell = jax_anchors.generate_cell_anchors(16, (32, 64, 128), (0.5, 1.0, 2.0))
    return np.asarray(jax_anchors.grid_anchors((5, 7), 16, cell))  # [315, 4]


@pytest.mark.parametrize("straddle", [0.0, 12.0, -1.0])
def test_anchor_visibility_matches_jax(straddle):
    anchors = _anchors()
    sizes = np.array([[80, 112], [57, 90], [20, 20]], np.int32)
    out = torch_anchors.anchor_visibility(torch.from_numpy(anchors), torch.from_numpy(sizes), straddle)
    ref = jax.vmap(lambda sz: jax_anchors.anchor_visibility(jnp.asarray(anchors), sz, straddle))(
        jnp.asarray(sizes))
    assert out.dtype == torch.bool and out.shape == (3, anchors.shape[0])
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    one = torch_anchors.anchor_visibility(torch.from_numpy(anchors), torch.from_numpy(sizes[1]), straddle)
    np.testing.assert_array_equal(one.numpy(), np.asarray(ref)[1])
    if straddle >= 0:
        assert 0 < int(out[0].sum()) < anchors.shape[0]


def _loss_inputs(seed, valid_rows):
    rng = np.random.default_rng(seed)
    anchors = _anchors()
    b, n, g = 2, anchors.shape[0], 5
    sizes = np.array([[80, 112], [64, 96]], np.int32)
    x1 = rng.uniform(0, 70, (b, g))
    y1 = rng.uniform(0, 50, (b, g))
    gt = np.stack([x1, y1, x1 + rng.uniform(10, 60, (b, g)), y1 + rng.uniform(10, 40, (b, g))], -1)
    gt_valid = np.arange(g)[None, :] < np.array(valid_rows)[:, None]
    gt = (gt * gt_valid[..., None]).astype(np.float32)
    obj = rng.standard_normal((b, n)).astype(np.float32)
    reg = (0.3 * rng.standard_normal((b, n, 4))).astype(np.float32)
    return anchors, sizes, obj, reg, gt, gt_valid


@pytest.mark.parametrize("valid_rows,batch_per_image", [((5, 3), 256), ((2, 0), 64), ((5, 5), 16)])
def test_rpn_loss_matches_jax_on_its_draws(valid_rows, batch_per_image):
    """Some gt rows padded (an image with none: every visible anchor is
    a negative); a small sampler batch, where positives crowd out
    negatives."""
    anchors, sizes, obj, reg, gt, gt_valid = _loss_inputs(sum(valid_rows) + batch_per_image, valid_rows)
    key = jax.random.PRNGKey(batch_per_image)
    vis = jax.vmap(lambda sz: jax_anchors.anchor_visibility(jnp.asarray(anchors), sz, 0.0))(jnp.asarray(sizes))
    ref = jax.jit(lambda *a: jax_rpn.rpn_loss(*a, 0.7, 0.3, batch_per_image, 0.5))(
        jnp.asarray(anchors), vis, jnp.asarray(obj), jnp.asarray(reg), jnp.asarray(gt),
        jnp.asarray(gt_valid), key)
    t = torch.from_numpy
    out = torch_rpn.rpn_loss(
        t(anchors), torch_anchors.anchor_visibility(t(anchors), t(sizes), 0.0), t(obj), t(reg),
        t(gt), t(gt_valid), jax_priorities(key, 2, anchors.shape[0]),
        batch_size_per_image=batch_per_image,
    )
    for got, want in zip(out, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-8)
    assert float(out[0]) > 0 and (float(out[1]) > 0) == any(v > 0 for v in valid_rows)


def test_rpn_loss_gradients_match_jax():
    """Gradients of the two losses' sum with respect to the objectness
    and the box regression (1e-5 of the JAX gradient's norm)."""
    anchors, sizes, obj, reg, gt, gt_valid = _loss_inputs(7, (5, 4))
    key = jax.random.PRNGKey(3)
    vis = jax.vmap(lambda sz: jax_anchors.anchor_visibility(jnp.asarray(anchors), sz, 0.0))(jnp.asarray(sizes))

    def total(o, r):
        a, b = jax_rpn.rpn_loss(jnp.asarray(anchors), vis, o, r, jnp.asarray(gt), jnp.asarray(gt_valid), key)
        return a + b

    ref = jax.grad(total, argnums=(0, 1))(jnp.asarray(obj), jnp.asarray(reg))
    t = torch.from_numpy
    o, r = t(obj).requires_grad_(), t(reg).requires_grad_()
    loss = torch_rpn.rpn_loss(
        t(anchors), torch_anchors.anchor_visibility(t(anchors), t(sizes), 0.0), o, r, t(gt),
        t(gt_valid), jax_priorities(key, 2, anchors.shape[0]))
    sum(loss).backward()
    for got, want in zip((o.grad, r.grad), ref):
        want = np.asarray(want)
        assert np.linalg.norm(got.numpy() - want) <= 1e-5 * np.linalg.norm(want)


def test_rpn_loss_draws_from_its_generator_reproducibly():
    anchors, sizes, obj, reg, gt, gt_valid = _loss_inputs(9, (4, 2))
    t = torch.from_numpy
    vis = torch_anchors.anchor_visibility(t(anchors), t(sizes), 0.0)
    runs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(5)
        runs.append(torch_rpn.rpn_loss(t(anchors), vis, t(obj), t(reg), t(gt), t(gt_valid), generator=gen))
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert all(torch.isfinite(v) and v > 0 for v in runs[0])


def test_rpn_selector_cuts_the_gradient():
    """The JAX selector stops the gradient of its outputs (rpn.py:113);
    so does the port's: proposals from an objectness and a regression
    that require grad carry no autograd history (the CUDA RoIAlign
    raises on rois that require grad)."""
    anchors = torch.from_numpy(_anchors())
    rng = np.random.default_rng(2)
    obj = torch.from_numpy(rng.standard_normal((2, anchors.shape[0])).astype(np.float32)).requires_grad_()
    reg = torch.from_numpy((0.1 * rng.standard_normal((2, anchors.shape[0], 4))).astype(np.float32))
    reg.requires_grad_()
    props = torch_rpn.select_proposals_single_level(
        anchors, obj * 2.0, reg * 1.0, torch.tensor([[80, 112], [64, 96]]), 100, 20, 0.7, 0.0
    )
    for t in props:
        assert t.grad_fn is None and not t.requires_grad
    assert props.valid.any()
