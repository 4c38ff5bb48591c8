"""The port's RoIAlign (its plain version, which CPU tensors run) against
the JAX package's ``roi_align_mxu`` (the main path's pooler) and the
golden gather ``roi_align``, for bin_stride 1 and 2 and sampling_ratio 0
and 2, with rois that straddle or leave the feature map.  float32,
absolute tolerance 1e-5 on O(1) features: the A-matrix weights are
computed with the same float32 operations and only the summation order
of the contraction differs.  bfloat16 features give a bfloat16 result,
held against the JAX bundle's recipe (pool ``f.astype(float32)``, then
``.astype(bfloat16)``) within one bfloat16 ulp of the larger value plus
1e-5: the two float32 sums may round to neighbouring bfloat16 values."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr22_cross_modal_pseudo_labeling_tpu.ops.roi_align import roi_align as jax_golden
from cvpr22_cross_modal_pseudo_labeling_tpu.ops.roi_align_mxu import roi_align_mxu
from cvpr22_cross_modal_pseudo_labeling_torch.ops import kernels
from cvpr22_cross_modal_pseudo_labeling_torch.ops import roi_align as torch_ra

SCALE = 1.0 / 8


def _inputs(seed, s=24):
    rng = np.random.RandomState(seed)
    feats = rng.standard_normal((2, 10, 13, 8)).astype(np.float32)
    # image frame 80 x 104 at stride 8; some rois straddle the border,
    # some lie outside it, some are smaller than one feature pixel
    x1 = rng.uniform(-30, 110, (2, s))
    y1 = rng.uniform(-30, 90, (2, s))
    w = rng.uniform(2, 70, (2, s))
    h = rng.uniform(2, 60, (2, s))
    rois = np.stack([x1, y1, x1 + w, y1 + h], -1).astype(np.float32)
    rois[0, 0] = [-50, -50, -20, -20]
    rois[1, 0] = [120, 100, 160, 140]
    rois[1, 1] = [10, 10, 10.5, 10.2]
    return feats, rois


@pytest.mark.parametrize("sampling_ratio", [0, 2])
@pytest.mark.parametrize("bin_stride", [1, 2])
def test_roi_align_matches_jax(bin_stride, sampling_ratio):
    feats, rois = _inputs(seed=bin_stride * 10 + sampling_ratio)
    out = torch_ra.roi_align(
        torch.from_numpy(feats), torch.from_numpy(rois), (7, 7), SCALE,
        sampling_ratio, bin_stride=bin_stride,
    ).numpy()
    p = -(-7 // bin_stride)
    assert out.shape == (2, rois.shape[1], p, p, 8)
    mxu = np.asarray(roi_align_mxu(
        jnp.asarray(feats), jnp.asarray(rois), (7, 7), SCALE, sampling_ratio,
        bin_stride=bin_stride,
    ))
    np.testing.assert_allclose(out, mxu, rtol=0, atol=1e-5)
    flat = np.concatenate(
        [np.repeat(np.arange(2, dtype=np.float32), rois.shape[1])[:, None],
         rois.reshape(-1, 4)], axis=1,
    )
    golden = np.asarray(jax_golden(
        jnp.asarray(feats), jnp.asarray(flat), (7, 7), SCALE, sampling_ratio
    ))[:, ::bin_stride, ::bin_stride]
    np.testing.assert_allclose(out.reshape(golden.shape), golden, rtol=0, atol=1e-5)
    assert np.abs(out[0, 0]).max() == 0.0  # a roi fully outside the map pools zeros


def test_roi_align_caps_the_adaptive_grid():
    """A roi larger than the map: the grid is clipped to ceil(H/P), the
    cap the reference CUDA kernel does not have; the JAX numerics are
    the target."""
    feats, _ = _inputs(seed=5)
    rois = np.array([[[0, 0, 400, 300]], [[-100, -100, 500, 500]]], np.float32)
    out = torch_ra.roi_align(torch.from_numpy(feats), torch.from_numpy(rois), (3, 3), SCALE)
    ref = roi_align_mxu(jnp.asarray(feats), jnp.asarray(rois), (3, 3), SCALE, 0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_roi_align_cpu_tensors_take_the_plain_version_and_other_devices_raise():
    feats, rois = _inputs(seed=0)
    before = kernels.ROI_ALIGN.launches
    torch_ra.roi_align(torch.from_numpy(feats), torch.from_numpy(rois), (7, 7), SCALE)
    assert kernels.ROI_ALIGN.launches == before
    with pytest.raises(ValueError, match="cpu or cuda"):
        torch_ra.roi_align(
            torch.empty((1, 4, 4, 8), device="meta"),
            torch.empty((1, 2, 4), device="meta"), (2, 2), 1.0,
        )


def _bf16_ulp(x):
    """One bfloat16 ulp at |x| (8 significant bits)."""
    _, e = np.frexp(np.abs(x).astype(np.float64))
    return np.ldexp(1.0, e - 8)


@pytest.mark.parametrize("sampling_ratio", [0, 2])
@pytest.mark.parametrize("bin_stride", [1, 2])
def test_roi_align_bf16_matches_jax_pool_then_cast(bin_stride, sampling_ratio):
    feats, rois = _inputs(seed=40 + bin_stride * 10 + sampling_ratio)
    fb = jnp.asarray(feats).astype(jnp.bfloat16)
    out = torch_ra.roi_align(
        torch.from_numpy(feats).to(torch.bfloat16), torch.from_numpy(rois), (7, 7), SCALE,
        sampling_ratio, bin_stride=bin_stride,
    )
    assert out.dtype == torch.bfloat16
    ref = roi_align_mxu(
        fb.astype(jnp.float32), jnp.asarray(rois), (7, 7), SCALE, sampling_ratio,
        bin_stride=bin_stride,
    ).astype(jnp.bfloat16)
    ref = np.asarray(ref.astype(jnp.float32))
    got = out.float().numpy()
    assert got.shape == ref.shape
    limit = _bf16_ulp(np.maximum(np.abs(got), np.abs(ref))) + 1e-5
    assert (np.abs(got - ref) <= limit).all(), np.abs(got - ref).max()


@pytest.mark.parametrize("bin_stride", [1, 2])
def test_roi_align_bf16_is_float32_pooling_then_cast(bin_stride):
    """bfloat16 features widen exactly: the bfloat16 result is, bit for
    bit, the float32 pooling of the widened features cast to bfloat16,
    and that float32 pooling keeps the float32 tolerance against JAX."""
    feats, rois = _inputs(seed=60 + bin_stride)
    fb = torch.from_numpy(feats).to(torch.bfloat16)
    args = (torch.from_numpy(rois), (7, 7), SCALE, 0, 8, bin_stride)
    out = torch_ra.roi_align(fb, *args)
    wide = torch_ra.roi_align(fb.float(), *args)
    assert out.dtype == torch.bfloat16 and wide.dtype == torch.float32
    assert torch.equal(out, wide.to(torch.bfloat16))
    ref = roi_align_mxu(
        jnp.asarray(fb.float().numpy()), jnp.asarray(rois), (7, 7), SCALE, 0, bin_stride=bin_stride,
    )
    np.testing.assert_allclose(wide.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


@pytest.mark.parametrize("bin_stride", [1, 2])
def test_roi_align_plain_version_is_differentiable(bin_stride):
    """CPU tensors keep autograd: the gradient of the pooled sum with
    respect to the features equals JAX's gradient of ``roi_align_mxu``
    (on CUDA the backward kernel computes it, held against this plain
    version by ``tests/test_torch_cuda_kernels.py``).  Same 1e-5
    tolerance: the backward is the transposed contraction of the same A
    matrices."""
    import jax

    feats, rois = _inputs(seed=80 + bin_stride)
    weight = np.random.RandomState(7).standard_normal((2, rois.shape[1], 4 if bin_stride == 2 else 7,
                                                       4 if bin_stride == 2 else 7, 8)).astype(np.float32)
    f = torch.from_numpy(feats).requires_grad_()
    out = torch_ra.roi_align(f, torch.from_numpy(rois), (7, 7), SCALE, 0, bin_stride=bin_stride)
    (out * torch.from_numpy(weight)).sum().backward()
    ref = jax.grad(lambda x: jnp.sum(
        roi_align_mxu(x, jnp.asarray(rois), (7, 7), SCALE, 0, bin_stride=bin_stride) * weight
    ))(jnp.asarray(feats))
    assert f.grad is not None and np.abs(f.grad.numpy()).max() > 0
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bin_stride", [1, 2])
def test_roi_align_backward_plain_matches_jax_grad(dtype, bin_stride):
    """The backward kernel's plain version (autograd of the plain
    forward, on zeros of the features' shape and dtype) against
    ``jax.grad`` of the JAX bundle's recipe: pool ``f.astype(float32)``
    with ``roi_align_mxu``, cast to the features' dtype.  float32: 1e-5;
    bfloat16: one bfloat16 ulp of the larger value plus 1e-5 (the float32
    sums may round to neighbouring bfloat16 values)."""
    import jax

    feats, rois = _inputs(seed=90 + bin_stride)
    p = -(-7 // bin_stride)
    g = np.random.RandomState(8).standard_normal((2, rois.shape[1], p, p, 8)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    grad = torch.from_numpy(g).to(dtype)
    out = torch_ra.roi_align_backward_plain(
        grad, torch.from_numpy(rois), feats.shape, dtype, (7, 7), SCALE, 0, 8, bin_stride)
    assert out.dtype == dtype and out.shape == feats.shape

    def pooled(x):
        y = roi_align_mxu(x.astype(jnp.float32), jnp.asarray(rois), (7, 7), SCALE, 0, bin_stride=bin_stride)
        return jnp.sum(y.astype(jdt).astype(jnp.float32) * jnp.asarray(grad.float().numpy()))

    ref = np.asarray(jax.grad(pooled)(jnp.asarray(feats).astype(jdt)).astype(jnp.float32))
    got = out.float().numpy()
    limit = 1e-5 + (_bf16_ulp(np.maximum(np.abs(got), np.abs(ref))) if dtype == torch.bfloat16 else 0)
    assert (np.abs(got - ref) <= limit).all(), np.abs(got - ref).max()
    assert np.abs(got).max() > 0


def test_roi_align_backward_shares_the_forward_library_and_counts_apart():
    """The backward entry lives in ``csrc/roi_align.cu`` beside the
    forward: one library, built once, with a launch count and hook of its
    own."""
    fwd, bwd = kernels.ROI_ALIGN, kernels.ROI_ALIGN_BACKWARD
    assert fwd.library_path() == bwd.library_path()
    assert "roi_align_backward" in bwd.entry_points and "roi_align_backward" not in fwd.entry_points
    assert fwd is not bwd and bwd in kernels.ALL
    before = (fwd.launches, bwd.launches)
    feats, rois = _inputs(seed=3)
    f = torch.from_numpy(feats).requires_grad_()
    torch_ra.roi_align(f, torch.from_numpy(rois), (7, 7), SCALE).sum().backward()
    assert (fwd.launches, bwd.launches) == before  # CPU tensors take the plain versions


def _overlap_rois(kind):
    """Roi sets that stress the backward kernel's tiles: 24 copies of one
    roi (every roi adds into the same positions), one roi over the whole
    map among rois that reach past it, and rois on the last row and
    column or wholly outside the map."""
    if kind == "stacked":
        one = np.array([[12.0, 9.0, 71.0, 58.0]], np.float32)
        return np.broadcast_to(one, (2, 24, 4)).copy()
    if kind == "whole_map":
        rois = np.array([[0, 0, 104, 80], [-40, -40, 150, 130], [0, 0, 103.9, 79.9],
                         [52, 40, 104, 80]], np.float32)
        return np.stack([rois, rois[::-1]])
    return np.array([[[96, 72, 104, 80], [100, 0, 130, 80], [0, 76, 104, 90],
                      [-30, -30, -5, -5], [110, 85, 140, 120], [103.5, 79.5, 104, 80]],
                     [[0, 0, 8, 8], [-10, 70, 20, 85], [95, -10, 110, 10],
                      [40, 30, 40.2, 30.2], [200, 200, 220, 230], [0, 0, 104, 80]]], np.float32)


@pytest.mark.parametrize("kind", ["stacked", "whole_map", "edges"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_backward_plain_matches_jax_grad_on_overlap_and_edges(kind, dtype):
    """The distributions the card tests give the backward kernel, on the
    CPU: ``roi_align_backward_plain`` against ``jax.grad`` of the JAX
    bundle's recipe (pool ``f.astype(float32)`` with ``roi_align_mxu``, cast
    to the features' dtype), bin_stride 2.  float32: 1e-5 * max|dF| (sums
    of up to 24 overlapping rois, taken in another order); bfloat16: that
    plus one bfloat16 ulp of the larger value."""
    import jax

    feats, _ = _inputs(seed=7)
    rois = _overlap_rois(kind)
    g = np.random.RandomState(11).standard_normal((2, rois.shape[1], 4, 4, 8)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    grad = torch.from_numpy(g).to(dtype)
    out = torch_ra.roi_align_backward_plain(
        grad, torch.from_numpy(rois), feats.shape, dtype, (7, 7), SCALE, 0, 8, 2)
    assert out.dtype == dtype and out.shape == feats.shape

    def pooled(x):
        y = roi_align_mxu(x.astype(jnp.float32), jnp.asarray(rois), (7, 7), SCALE, 0, bin_stride=2)
        return jnp.sum(y.astype(jdt).astype(jnp.float32) * jnp.asarray(grad.float().numpy()))

    ref = np.asarray(jax.grad(pooled)(jnp.asarray(feats).astype(jdt)).astype(jnp.float32))
    got = out.float().numpy()
    limit = 1e-5 * np.abs(ref).max()
    if dtype == torch.bfloat16:
        limit = limit + _bf16_ulp(np.maximum(np.abs(got), np.abs(ref)))
    assert np.abs(ref).max() > 0
    assert (np.abs(got - ref) <= limit).all(), np.abs(got - ref).max()
    if kind == "edges":
        assert np.abs(got[:, -1]).max() > 0 and np.abs(got[:, :, -1]).max() > 0  # last row, column


@pytest.mark.parametrize("shape", [(50, 84, 1024), (17, 23, 40), (1, 1, 8), (100, 168, 2048),
                                   (7, 300, 264)])
@pytest.mark.parametrize("column_taps", [2, 12, 128])
@pytest.mark.parametrize("tile", [torch_ra.BACKWARD_TILE, (4, 84, 512, 8)])
def test_backward_tiling_fits_a_cta_and_covers_the_map(shape, column_taps, tile):
    """The backward kernel's tile: at most 4 rows and 256 threads (four
    channels each, whole warps per row), its shared memory within the
    227 KB a CTA may use whenever the narrowest slab of channels fits,
    its tiles and slabs covering every row, column and channel, and no
    more slabs a CTA than C has."""
    H, W, C = shape
    rows, cols, slab, per_cta = torch_ra.backward_tiling(H, W, C, column_taps, tile)
    assert 1 <= rows <= min(4, H) and 1 <= cols <= W
    assert slab % 128 == 0 and rows * slab // 4 <= 256
    slabs = -(-C // slab)
    assert slabs * slab >= C and (slabs - 1) * slab < C
    assert 1 <= per_cta <= slabs
    assert -(-H // rows) * rows >= H and -(-W // cols) * cols >= W
    # the columns spread evenly: no tile of a row is much narrower
    assert W - (-(-W // cols) - 1) * cols >= cols - -(-W // cols)
    fits = torch_ra.backward_shared_bytes(rows, cols, 128, column_taps) <= torch_ra.SHARED_MEMORY_PER_BLOCK
    if fits:
        assert torch_ra.backward_shared_bytes(rows, cols, slab, column_taps) <= 232448


def test_backward_plan_bytes_hold_every_array():
    """The plan of 8 x 512 rois at 7 x 7 emitted bins with 4 x 6 samples a
    bin at most: tap lists, counts and ranges, each array 256-byte aligned,
    about 5.3 MB (the float32 scratch of the first version was 138 MB)."""
    nbytes = torch_ra._plan_bytes(8, 512, 7, 7, 4, 6)
    nr = 8 * 512
    raw = nr * (7 * 8 * 8 + 7 * 12 * 8 + 7 * 4 + 7 * 4 + 7 * 8 + 7 * 8 + 1 * 8)
    assert raw <= nbytes < raw + 7 * 256
    assert nbytes < 6e6
    assert torch_ra._sample_caps(50, 84, 14, 14, 0, 8) == (4, 6)
    assert torch_ra._sample_caps(50, 84, 14, 14, 2, 8) == (2, 2)
