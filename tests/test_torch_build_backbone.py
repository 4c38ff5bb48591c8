"""The port's ``build_backbone`` and the trunk options that only it
reaches, against the JAX package on the CPU.

- ``ops/deform_conv.py::deform_conv2d`` against JAX's: v1, modulated
  v2, channel groups 2, stride 2 and dilation 2, on offsets that put
  taps outside the image; the forward within 1e-5 of its largest value,
  the gradients with respect to the input, the offsets, the mask and
  the kernel within 1e-5 of each JAX gradient's norm;
- the cases of ``tests/test_deform_conv.py`` on the port's function;
- ``build_backbone`` for R-50-C4 with GroupNorm, R-50-C4 with DCN in
  res4 (v1 and modulated), R-50-FPN with the FPN's ``USE_GN`` and
  ``USE_RELU``, and FBNet, at narrow widths (GroupNorm needs multiples
  of 32 channels: stem 32, res2 64, width 32): ``meta`` equal to JAX's,
  the flax trees leaf for leaf, and the forward on the same seeded
  weights within 1e-5 of each level's largest value (5e-5 with
  GroupNorm, whose statistics flax computes as E[x^2] - E[x]^2: 1.0e-5
  at this seed);
- the detectors of both families build the same tree with these options
  as without them (JAX's ignore them too;
  ``tests/test_torch_fpn.py`` holds that against JAX's trees), while
  ``build_backbone``'s tree grows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cvpr22_cross_modal_pseudo_labeling_tpu.config import get_default_cfg as jax_cfg
from cvpr22_cross_modal_pseudo_labeling_tpu.models import backbone as jax_backbone
from cvpr22_cross_modal_pseudo_labeling_tpu.ops import deform_conv as jax_dcn
from cvpr22_cross_modal_pseudo_labeling_torch import bridge
from cvpr22_cross_modal_pseudo_labeling_torch.config import get_default_cfg as torch_cfg
from cvpr22_cross_modal_pseudo_labeling_torch.models import backbone as torch_backbone
from cvpr22_cross_modal_pseudo_labeling_torch.models.detector import build_detection_model
from cvpr22_cross_modal_pseudo_labeling_torch.ops.deform_conv import deform_conv2d
from tests.test_torch_st_train import CONFIG as STUDENT
from tests.test_torch_st_train import TRAIN_OPTS
from tests.test_torch_teacher import TEACHER


def _rel_norm(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# name: (x shape, weight shape, kwargs, modulated)
DCN_CASES = {
    "v1": ((2, 9, 11, 6), (3, 3, 6, 5), dict(), False),
    "v2": ((2, 9, 11, 6), (3, 3, 6, 5), dict(), True),
    "groups2": ((2, 9, 11, 6), (3, 3, 3, 4), dict(groups=2), True),
    "stride2": ((1, 10, 9, 4), (3, 3, 4, 6), dict(stride=2), False),
    "dilation2": ((1, 10, 9, 4), (3, 3, 4, 6), dict(padding=2, dilation=2), True),
}


@pytest.mark.parametrize("case", list(DCN_CASES))
def test_deform_conv2d_forward_and_gradients_match_jax(case):
    xs, ws, kw, modulated = DCN_CASES[case]
    stride, pad, dil = kw.get("stride", 1), kw.get("padding", 1), kw.get("dilation", 1)
    ho = (xs[1] + 2 * pad - dil * 2 - 1) // stride + 1
    wo = (xs[2] + 2 * pad - dil * 2 - 1) // stride + 1
    rng = np.random.default_rng(len(case))
    x = rng.standard_normal(xs).astype(np.float32)
    w = rng.standard_normal(ws).astype(np.float32)
    off = (rng.standard_normal((xs[0], ho, wo, 18)) * 1.5).astype(np.float32)
    mask = rng.uniform(0, 1, (xs[0], ho, wo, 9)).astype(np.float32) if modulated else None
    bias = rng.standard_normal(ws[3]).astype(np.float32)
    cot = rng.standard_normal((xs[0], ho, wo, ws[3])).astype(np.float32)

    def jf(x_, off_, w_, m_):
        out = jax_dcn.deform_conv2d(x_, off_, w_, jnp.asarray(bias), mask=m_, **kw)
        return jnp.sum(out * cot), out

    argnums = (0, 1, 2, 3) if modulated else (0, 1, 2)
    jm = None if mask is None else jnp.asarray(mask)
    (_, ref), grads = jax.value_and_grad(jf, argnums=argnums, has_aux=True)(
        jnp.asarray(x), jnp.asarray(off), jnp.asarray(w), jm)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, off, w)]
    tm = None if mask is None else torch.from_numpy(mask).requires_grad_(True)
    out = deform_conv2d(*ts, torch.from_numpy(bias), mask=tm, **kw)
    (out * torch.from_numpy(cot)).sum().backward()
    ref = np.asarray(ref)
    assert out.shape == ref.shape == (xs[0], ho, wo, ws[3])
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    got = [t.grad.numpy() for t in ts] + ([tm.grad.numpy()] if modulated else [])
    for name, g, r in zip(("x", "offsets", "weight", "mask"), got, grads):
        assert _rel_norm(g, np.asarray(r)) <= 1e-5, (name, _rel_norm(g, np.asarray(r)))
    # some taps fell outside the image (zero padding exercised)
    assert np.abs(off).max() > pad


def test_zero_offset_equals_regular_conv():
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(1, 8, 8, 3).astype(np.float32))
    w = torch.from_numpy(rng.randn(3, 3, 3, 5).astype(np.float32))
    out = deform_conv2d(x, torch.zeros(1, 8, 8, 18), w, stride=1, padding=1)
    ref = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-4)


def test_integer_offset_shifts_sampling():
    rng = np.random.RandomState(1)
    x = np.zeros((1, 6, 6, 1), np.float32)
    x[0, :, :, 0] = rng.randn(6, 6)
    offsets = np.zeros((1, 6, 6, 2), np.float32)
    offsets[..., 1] = 1.0  # dx = +1
    out = deform_conv2d(torch.from_numpy(x), torch.from_numpy(offsets), torch.ones(1, 1, 1, 1), stride=1,
                        padding=0).numpy()
    np.testing.assert_allclose(out[0, :, :-1, 0], x[0, :, 1:, 0], atol=1e-5)
    np.testing.assert_allclose(out[0, :, -1, 0], 0.0)


def test_modulated_mask_scales():
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(1, 4, 4, 2).astype(np.float32))
    w = torch.from_numpy(rng.randn(3, 3, 2, 2).astype(np.float32))
    offsets = torch.zeros(1, 4, 4, 18)
    full = deform_conv2d(x, offsets, w, mask=torch.ones(1, 4, 4, 9))
    half = deform_conv2d(x, offsets, w, mask=torch.full((1, 4, 4, 9), 0.5))
    np.testing.assert_allclose(half.numpy(), full.numpy() * 0.5, atol=1e-5)


def test_deform_conv_groups_matches_grouped_conv():
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(1, 8, 8, 6).astype(np.float32))
    w = torch.from_numpy(rng.randn(3, 3, 3, 4).astype(np.float32))  # cin/g=3, cout=4
    out = deform_conv2d(x, torch.zeros(1, 8, 8, 18), w, stride=1, padding=1, groups=2)
    ref = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1, groups=2).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-4)


def test_deform_conv_group_mismatch_raises():
    with pytest.raises(ValueError, match="grouped deform conv"):
        deform_conv2d(torch.zeros(1, 4, 4, 6), torch.zeros(1, 4, 4, 18), torch.zeros(3, 3, 4, 4), groups=2)


WIDTHS = ["MODEL.RESNETS.STEM_OUT_CHANNELS", 32, "MODEL.RESNETS.RES2_OUT_CHANNELS", 64,
          "MODEL.RESNETS.WIDTH_PER_GROUP", 32, "MODEL.RESNETS.BACKBONE_OUT_CHANNELS", 32]
RES4_DCN = ["MODEL.RESNETS.STAGE_WITH_DCN", (False, False, True, False)]
TRUNKS = {
    "r50_c4_gn": ["MODEL.BACKBONE.CONV_BODY", "R-50-C4", "MODEL.RESNETS.TRANS_FUNC", "BottleneckWithGN"],
    "r50_c4_dcn": ["MODEL.BACKBONE.CONV_BODY", "R-50-C4", *RES4_DCN],
    "r50_c4_modulated_dcn": ["MODEL.BACKBONE.CONV_BODY", "R-50-C4", *RES4_DCN, "MODEL.RESNETS.WITH_MODULATED_DCN",
                             True],
    "r50_fpn_gn_relu": ["MODEL.BACKBONE.CONV_BODY", "R-50-FPN", "MODEL.FPN.USE_GN", True, "MODEL.FPN.USE_RELU", True],
    "fbnet": ["MODEL.BACKBONE.CONV_BODY", "FBNet"],
}


def _both(opts):
    out = []
    for get in (jax_cfg, torch_cfg):
        cfg = get()
        cfg.merge_from_list(opts)
        out.append(cfg)
    return out


def _leaves(tree):
    return {"/".join(p): tuple(np.shape(v)) for p, v in bridge._flatten(tree).items()}


@pytest.mark.parametrize("trunk", list(TRUNKS))
def test_build_backbone_matches_jax(trunk):
    jc, tc = _both(WIDTHS + TRUNKS[trunk])
    jm, jmeta = jax_backbone.build_backbone(jc)
    tm, tmeta = torch_backbone.build_backbone(tc)
    assert tmeta == jmeta
    x = np.random.default_rng(0).standard_normal((2, 64, 64, 3)).astype(np.float32)
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x)))["params"]
    tree = bridge.seeded_flax_params(tm, 0)
    assert _leaves(tree) == {"/".join(k.key for k in p): tuple(v.shape)
                             for p, v in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    bridge.load_flax_params(tm, tree)
    ref = jax.jit(jm.apply)({"params": jax.tree_util.tree_map(jnp.asarray, tree)}, jnp.asarray(x))
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    tol = 5e-5 if "gn" in trunk else 1e-5
    assert len(out) == len(ref) == len(jmeta["strides"])
    for level, (a, r) in enumerate(zip(out, ref)):
        r = np.asarray(r)
        assert a.shape == r.shape and a.shape[1] == 64 // jmeta["strides"][level] and a.shape[-1] == jmeta[
            "out_channels"]
        np.testing.assert_allclose(a.numpy(), r, rtol=0, atol=tol * np.abs(r).max(), err_msg=str(level))
    if "dcn" in trunk:
        block = tm.body.layer3.block0
        assert block.with_dcn and not hasattr(block, "conv2")
        assert tuple(block.conv2_kernel.shape) == (3, 3, 128, 128)
        assert block.conv2_offset.out_channels == (27 if "modulated" in trunk else 18)


IGNORED = ["MODEL.RESNETS.TRANS_FUNC", "BottleneckWithGN", *RES4_DCN, "MODEL.RESNETS.WITH_MODULATED_DCN", True,
           "MODEL.FPN.USE_GN", True, "MODEL.FPN.USE_RELU", True]


@pytest.mark.parametrize("config", [TEACHER, STUDENT])
def test_detectors_ignore_the_trunk_options_build_backbone_reads(config):
    keys = []
    for opts in ([], IGNORED):
        cfg = torch_cfg()
        cfg.merge_from_file(config)
        cfg.merge_from_list(TRAIN_OPTS + opts)
        keys.append({k: tuple(v.shape) for k, v in build_detection_model(cfg).state_dict().items()})
    assert keys[0] == keys[1]
    _, plain = _both(WIDTHS + ["MODEL.BACKBONE.CONV_BODY", "R-50-C4"])
    _, opted = _both(WIDTHS + ["MODEL.BACKBONE.CONV_BODY", "R-50-C4"] + IGNORED)
    grown = set(torch_backbone.build_backbone(opted)[0].state_dict()) - set(
        torch_backbone.build_backbone(plain)[0].state_dict())
    assert any(k.endswith("conv2_kernel") for k in grown) and any(k.endswith("conv2_offset.bias") for k in grown)
