"""The port's FPN-family extractors and predictors, the mask-predictor
variants, ``roi_pool`` and ``deform_psroi_pool`` against the JAX
package's, on the CPU, in float32.

The JAX modules are initialized from a seed and their flax trees carried
into the port's modules through ``bridge.load_flax_params`` (the flax
scope names are the port's module names).  Outputs, and the gradients
with respect to the inputs (and the offsets) where JAX differentiates,
agree within float32 rounding: 1e-5 of the largest magnitude (sums in
another order).  ``DropoutMaskPredictor`` takes JAX's dropout masks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr22_cross_modal_pseudo_labeling_tpu.models.roi_heads import extractors as jax_ex
from cvpr22_cross_modal_pseudo_labeling_tpu.ops import deform_conv as jax_dc
from cvpr22_cross_modal_pseudo_labeling_tpu.ops.roi_pool import roi_pool as jax_roi_pool
from cvpr22_cross_modal_pseudo_labeling_torch import bridge
from cvpr22_cross_modal_pseudo_labeling_torch.models.roi_heads import extractors as ex
from cvpr22_cross_modal_pseudo_labeling_torch.ops.deform_conv import deform_psroi_pool
from cvpr22_cross_modal_pseudo_labeling_torch.ops.roi_pool import roi_pool

RTOL = 1e-5  # of the largest magnitude: float32 sums in another order


def close(got, ref, err_msg=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, err_msg
    np.testing.assert_allclose(got, ref, rtol=0, atol=RTOL * max(np.abs(ref).max(), 1e-30), err_msg=err_msg)


def t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def jax_vs_port(jax_module, port_module, x, *args):
    """Outputs and input gradients (of a seeded cotangent) of both."""
    params = jax_module.init(jax.random.PRNGKey(0), jnp.asarray(x), *args)
    bridge.load_flax_params(port_module, jax.tree_util.tree_map(np.asarray, params))
    ref = jax.jit(lambda p, xx: jax_module.apply(p, xx, *args))(params, jnp.asarray(x))
    ref_tuple = ref if isinstance(ref, tuple) else (ref,)
    rng = np.random.default_rng(1)
    cots = [rng.standard_normal(np.shape(r)).astype(np.float32) for r in ref_tuple]

    def scalar(xx):
        out = jax_module.apply(params, xx, *args)
        out = out if isinstance(out, tuple) else (out,)
        return sum(jnp.sum(o * c) for o, c in zip(out, cots))

    ref_grad = jax.jit(jax.grad(scalar))(jnp.asarray(x))
    xt = t(x).requires_grad_(True)
    got = port_module(xt)
    got_tuple = got if isinstance(got, tuple) else (got,)
    sum((g * t(c)).sum() for g, c in zip(got_tuple, cots)).backward()
    for g, r in zip(got_tuple, ref_tuple):
        close(g.detach().numpy(), r)
    close(xt.grad.numpy(), ref_grad, "input gradient")


@pytest.mark.parametrize("use_gn,dilation", [(False, 1), (True, 2)])
def test_xconv1fc_extractor(use_gn, dilation):
    x = np.random.default_rng(0).standard_normal((3, 7, 7, 64)).astype(np.float32)
    jm = jax_ex.FPNXconv1fcFeatureExtractor(conv_head_dim=32, num_stacked_convs=2, mlp_head_dim=48,
                                            dilation=dilation, use_gn=use_gn)
    pm = ex.FPNXconv1fcFeatureExtractor(64, 7, conv_head_dim=32, num_stacked_convs=2, mlp_head_dim=48,
                                        dilation=dilation, use_gn=use_gn)
    jax_vs_port(jm, pm, x)


def test_2mlp_extractor_and_fpn_predictor():
    x = np.random.default_rng(2).standard_normal((4, 7, 7, 16)).astype(np.float32)
    jax_vs_port(jax_ex.FPN2MLPFeatureExtractor(mlp_head_dim=40), ex.FPN2MLPFeatureExtractor(7 * 7 * 16, 40), x)
    feats = np.random.default_rng(3).standard_normal((5, 40)).astype(np.float32)
    for agnostic in (False, True):
        jax_vs_port(jax_ex.FPNPredictor(num_classes=6, cls_agnostic_bbox_reg=agnostic),
                    ex.FPNPredictor(40, 6, cls_agnostic_bbox_reg=agnostic), feats)


def test_conv1x1_mask_predictor_and_pixel_score():
    x = np.random.default_rng(4).standard_normal((2, 14, 14, 24)).astype(np.float32)
    jax_vs_port(jax_ex.MaskRCNNConv1x1Predictor(num_classes=3), ex.MaskRCNNConv1x1Predictor(24, 3), x)
    close(ex.pixel_score_uncertainty(t(x)).numpy(), jax_ex.pixel_score_uncertainty(jnp.asarray(x)))


def test_dropout_mask_predictor_with_jaxs_masks():
    x = np.random.default_rng(5).standard_normal((2, 7, 7, 24)).astype(np.float32)
    jm = jax_ex.DropoutMaskPredictor(num_classes=2, dim_reduced=16, drop_rate=0.5, num_samples=3)
    key = jax.random.PRNGKey(7)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), key)
    pm = ex.DropoutMaskPredictor(24, 2, dim_reduced=16, drop_rate=0.5, num_samples=3)
    bridge.load_flax_params(pm, jax.tree_util.tree_map(np.asarray, params))
    keep = np.stack([np.asarray(jax.random.bernoulli(k, 0.5, (2, 14, 14, 16))) for k in jax.random.split(key, 3)])
    ref_mean, ref_entropy = jm.apply(params, jnp.asarray(x), key)
    got_mean, got_entropy = pm(t(x), keep=torch.from_numpy(keep))
    close(got_mean.detach().numpy(), ref_mean)
    close(got_entropy.detach().numpy(), ref_entropy)
    drawn, _ = pm(t(x), generator=torch.Generator().manual_seed(0))
    assert drawn.shape == got_mean.shape and torch.isfinite(drawn).all()


def rois_on(rng, b, h, w, n, scale):
    xy = rng.uniform(-4, [w / scale, h / scale], (n, 2))
    wh = rng.uniform(0, [w / scale / 2, h / scale / 2], (n, 2))
    rois = np.concatenate([rng.integers(0, b, (n, 1)), xy, xy + wh], 1).astype(np.float32)
    rois[0, 1:] = [8.0, 8.0, 24.0, 40.0]  # exact .5 products at scale 1/16
    return rois


@pytest.mark.parametrize("max_bin", [None, 2])
def test_roi_pool_and_its_gradient(max_bin):
    rng = np.random.default_rng(6)
    feats = rng.standard_normal((2, 12, 15, 8)).astype(np.float32)
    rois = rois_on(rng, 2, 12, 15, 9, 1 / 16)
    rois[1, 1:] = [300.0, 300.0, 330.0, 330.0]  # off the map: empty bins
    kw = dict(output_size=(3, 4), spatial_scale=1 / 16, max_bin=max_bin)
    ref = jax_roi_pool(jnp.asarray(feats), jnp.asarray(rois), **kw)
    ft = t(feats).requires_grad_(True)
    got = roi_pool(ft, t(rois), **kw)
    close(got.detach().numpy(), ref)
    cot = rng.standard_normal(np.shape(ref)).astype(np.float32)
    ref_grad = jax.grad(lambda f: jnp.sum(jax_roi_pool(f, jnp.asarray(rois), **kw) * cot))(jnp.asarray(feats))
    (got * t(cot)).sum().backward()
    close(ft.grad.numpy(), ref_grad, "feature gradient")


@pytest.mark.parametrize("group_size,with_offsets", [(1, False), (2, True)])
def test_deform_psroi_pool_and_its_gradients(group_size, with_offsets):
    rng = np.random.default_rng(8 + group_size)
    c = 2 * group_size * group_size
    feats = rng.standard_normal((2, 10, 13, c)).astype(np.float32)
    rois = rois_on(rng, 2, 10, 13, 7, 1 / 8)
    offsets = rng.standard_normal((7, 3, 3, 2)).astype(np.float32) if with_offsets else None
    kw = dict(output_size=3, spatial_scale=1 / 8, sampling_ratio=2, trans_std=0.1, group_size=group_size)
    cot = rng.standard_normal((7, 3, 3, 2)).astype(np.float32)

    pool = jax.jit(lambda f, off: jax_dc.deform_psroi_pool(f, jnp.asarray(rois), off, **kw))

    def jax_loss(f, off):
        return jnp.sum(pool(f, off) * cot)

    ref = pool(jnp.asarray(feats), None if offsets is None else jnp.asarray(offsets))
    ft = t(feats).requires_grad_(True)
    ot = t(offsets).requires_grad_(True) if with_offsets else None
    got = deform_psroi_pool(ft, t(rois), ot, **kw)
    close(got.detach().numpy(), ref)
    (got * t(cot)).sum().backward()
    if with_offsets:
        gf, go = jax.jit(jax.grad(jax_loss, argnums=(0, 1)))(jnp.asarray(feats), jnp.asarray(offsets))
        close(ot.grad.numpy(), go, "offset gradient")
    else:
        gf = jax.jit(jax.grad(lambda f: jax_loss(f, None)))(jnp.asarray(feats))
    close(ft.grad.numpy(), gf, "feature gradient")


def test_deform_psroi_pool_refuses_indivisible_channels():
    with pytest.raises(ValueError, match="not divisible"):
        deform_psroi_pool(torch.zeros(1, 4, 4, 6), torch.zeros(1, 5), None, 2, 1.0, group_size=2)
