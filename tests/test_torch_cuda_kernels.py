"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``; every test skips without a CUDA device.  This
file imports torch and the port only, so it runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py

NMS must agree exactly (RetinaNet's 8 x 5000 over 80 labels among the
shapes); RoIAlign within 1e-5 * max|F| for a float32
result (only the summation order differs), plus one bfloat16 ulp of the
result for a bfloat16 one (the two float32 sums may round to neighbouring
bfloat16 values).  The RoIAlign backward within 1e-5 * max|dF| of the
plain version's autograd gradient (the kernel sums each tile's taps in
another order than the plain contraction), plus one bfloat16 ulp for
bfloat16 features.  The level filter of both (the FPN pooler's, at C
256): each level's forward launch writes only its rows of one output,
the four together every row; each level's backward gives the dF of that
level's rois; a null filter is the unfiltered launch, bit for bit.
"""

import numpy as np
import pytest
import torch

from cvpr22_cross_modal_pseudo_labeling_torch.ops import kernels
from cvpr22_cross_modal_pseudo_labeling_torch.ops import nms as nm
from cvpr22_cross_modal_pseudo_labeling_torch.ops import roi_align as ra

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _boxes(rng, b, n, size=300.0):
    ctr = rng.uniform(0, size, (b, n, 2))
    wh = rng.uniform(4, 80, (b, n, 2))
    return np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)


@pytest.mark.parametrize("b,n,k,thr,labels,ties,invalid", [
    (1, 1, 5, 0.5, False, False, False),
    (2, 64, 64, 0.5, False, False, False),
    (2, 65, 10, 0.3, True, True, True),
    (3, 700, 100, 0.7, False, True, True),
    (2, 1000, 100, 0.5, True, False, True),
    (1, 129, 200, 0.5, True, True, False),
])
def test_nms_kernel_equals_plain(card, b, n, k, thr, labels, ties, invalid):
    """The kernel reads the inputs through the sort's indices and writes
    the final indices and mask itself."""
    rng = np.random.default_rng(n + k)
    boxes = torch.from_numpy(_boxes(rng, b, n)).to(card)
    s = rng.uniform(0, 1, (b, n))
    if ties:
        s = np.round(s * 4) / 4
    scores = torch.from_numpy(s.astype(np.float32)).to(card)
    valid = torch.from_numpy(rng.uniform(0, 1, (b, n)) > (0.3 if invalid else -1)).to(card)
    lab = torch.from_numpy(rng.integers(0, 4, (b, n)).astype(np.int32)).to(card) if labels else None
    before = kernels.NMS.launches
    idx, keep = nm.nms(boxes, scores, valid, thr, k, labels=lab)
    assert kernels.NMS.launches == before + 1
    ref_idx, ref_keep = nm.nms_plain(boxes, scores, valid, thr, k, labels=lab)
    assert torch.equal(idx, ref_idx) and torch.equal(keep, ref_keep)


@pytest.mark.parametrize("n,k,label_dtype", [
    (300, 50, torch.int64),  # int64 labels, as the box head passes them
    (20000, 6000, None),  # more mask words than the scan stages in shared memory
])
def test_nms_kernel_wide_labels_and_long_scans(card, n, k, label_dtype):
    rng = np.random.default_rng(n)
    boxes = torch.from_numpy(_boxes(rng, 1, n, size=2000.0)).to(card)
    scores = torch.from_numpy(rng.uniform(0, 1, (1, n)).astype(np.float32)).to(card)
    valid = torch.from_numpy(rng.uniform(0, 1, (1, n)) > 0.1).to(card)
    lab = None
    if label_dtype is not None:
        lab = torch.from_numpy(rng.integers(0, 5, (1, n))).to(card, label_dtype)
    idx, keep = nm.nms(boxes[0], scores[0], valid[0], 0.5, k, labels=None if lab is None else lab[0])
    ref_idx, ref_keep = nm.nms_plain(boxes, scores, valid, 0.5, k, labels=lab)
    assert idx.shape == (k,) and idx.dtype == torch.int32 and keep.dtype == torch.bool
    assert torch.equal(idx, ref_idx[0]) and torch.equal(keep, ref_keep[0])


def test_nms_kernel_at_retinanet_shape(card):
    """RetinaNet's detection NMS: 8 x 5000 candidates (5 levels x 1000),
    80 labels, IoU 0.4, down to 100; the scores the float32 sigmoid of
    bfloat16 logits around the 0.01 prior (ties in bulk), valid above
    the 0.05 threshold, as ``models/rpn/retinanet.py`` gives them."""
    rng = np.random.default_rng(12)
    b, n, k = 8, 5000, 100
    boxes = torch.from_numpy(_boxes(rng, b, n, size=600.0)).to(card)
    logits = torch.from_numpy(rng.normal(-4.6, 1.0, (b, n)).astype(np.float32)).to(card, torch.bfloat16)
    scores = torch.sigmoid(logits.float())
    valid = scores > 0.05
    labels = torch.from_numpy(rng.integers(1, 81, (b, n)).astype(np.int32)).to(card)
    assert len(torch.unique(scores[valid])) < valid.sum() // 4
    before = kernels.NMS.launches
    idx, keep = nm.batched_nms(boxes, scores, labels, valid, 0.4, k)
    assert kernels.NMS.launches == before + 1
    ref_idx, ref_keep = nm.nms_plain(boxes, scores, valid, 0.4, k, labels=labels)
    assert torch.equal(idx, ref_idx) and torch.equal(keep, ref_keep)
    assert int(keep.sum(1).min()) == k


@pytest.mark.parametrize("hint", [0, 1, 17, 40, 94, 10**6])
def test_nms_kernel_exact_whatever_the_stop_hint(card, hint):
    """The last call's stop point sizes the first column band only: any
    hint, and the hint the call then leaves, keep the result exact."""
    n, k = 6000, 1000
    rng = np.random.default_rng(hint)
    boxes = torch.from_numpy(_boxes(rng, 2, n, size=1200.0)).to(card)
    scores = torch.from_numpy(rng.uniform(0, 1, (2, n)).astype(np.float32)).to(card)
    valid = torch.ones((2, n), dtype=torch.bool, device=card)
    ref_idx, ref_keep = nm.nms_plain(boxes, scores, valid, 0.7, k)
    word = nm._stop_hint(boxes.device, n, k)
    for _ in range(2):
        torch.cuda.synchronize()
        word[0] = hint
        idx, keep = nm.nms(boxes, scores, valid, 0.7, k)
        assert torch.equal(idx, ref_idx) and torch.equal(keep, ref_keep)
        torch.cuda.synchronize()
        hint = int(word)
        assert 0 < hint <= 94


def _roi_inputs(rng, c, dtype, card):
    feats = torch.from_numpy(rng.standard_normal((2, 17, 23, c), np.float32)).to(card, dtype)
    x1 = rng.uniform(-60, 380, (2, 50))
    y1 = rng.uniform(-60, 280, (2, 50))
    rois = np.stack([x1, y1, x1 + rng.uniform(1, 300, (2, 50)),
                     y1 + rng.uniform(1, 200, (2, 50))], -1).astype(np.float32)
    rois[0, 0] = [-100, -100, -40, -40]  # outside the map: zeros
    return feats, torch.from_numpy(rois).to(card)


def _within_tolerance(out, ref, fmax):
    diff = (out.float() - ref.float()).abs()
    limit = torch.full_like(diff, 1e-5 * fmax)
    if out.dtype == torch.bfloat16:
        mag = torch.maximum(out.float().abs(), ref.float().abs())
        limit += torch.ldexp(torch.ones_like(mag), torch.frexp(mag).exponent - 8)
    return bool((diff <= limit).all())


@pytest.mark.parametrize("c", [8, 40, 1024])
@pytest.mark.parametrize("bin_stride,sampling_ratio", [(1, 0), (2, 0), (2, 2)])
def test_roi_align_kernel_bf16_equals_plain(card, c, bin_stride, sampling_ratio):
    rng = np.random.default_rng(c + bin_stride + 7)
    feats, rois = _roi_inputs(rng, c, torch.bfloat16, card)
    args = (feats, rois, (14, 14), 1.0 / 16, sampling_ratio, 8, bin_stride)
    before = kernels.ROI_ALIGN.launches
    out = ra.roi_align(*args)
    assert kernels.ROI_ALIGN.launches == before + 1
    ref = ra.roi_align_plain(*args)
    assert out.dtype == ref.dtype == torch.bfloat16 and out.shape == ref.shape
    assert _within_tolerance(out, ref, float(feats.float().abs().max()))
    assert not out[0, 0].any()


@pytest.mark.parametrize("c", [4, 36, 1024])
@pytest.mark.parametrize("bin_stride,sampling_ratio", [(1, 0), (2, 0), (1, 2), (2, 2)])
def test_roi_align_kernel_equals_plain(card, c, bin_stride, sampling_ratio):
    rng = np.random.default_rng(c + bin_stride)
    feats = torch.from_numpy(rng.standard_normal((2, 17, 23, c), np.float32)).to(card)
    x1 = rng.uniform(-60, 380, (2, 50))
    y1 = rng.uniform(-60, 280, (2, 50))
    rois = np.stack([x1, y1, x1 + rng.uniform(1, 300, (2, 50)),
                     y1 + rng.uniform(1, 200, (2, 50))], -1).astype(np.float32)
    rois[0, 0] = [-100, -100, -40, -40]  # outside the map: zeros
    rois = torch.from_numpy(rois).to(card)
    args = (feats, rois, (14, 14), 1.0 / 16, sampling_ratio, 8, bin_stride)
    before = kernels.ROI_ALIGN.launches
    out = ra.roi_align(*args)
    assert kernels.ROI_ALIGN.launches == before + 1
    ref = ra.roi_align_plain(*args)
    assert out.shape == ref.shape
    assert float((out - ref).abs().max()) <= 1e-5 * float(feats.abs().max())
    assert not out[0, 0].any()


def test_roi_align_kernel_rejects_what_it_cannot_take(card):
    rois = torch.zeros((1, 2, 4), device=card)
    with pytest.raises(ValueError, match="C % 4"):
        ra.roi_align(torch.zeros((1, 4, 4, 6), device=card), rois, (2, 2), 1.0)
    with pytest.raises(ValueError, match="C % 8"):
        ra.roi_align(torch.zeros((1, 4, 4, 12), device=card, dtype=torch.bfloat16), rois, (2, 2), 1.0)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ra.roi_align(torch.zeros((1, 4, 4, 8), device=card, dtype=torch.float16), rois, (2, 2), 1.0)


def test_roi_align_kernel_refuses_inputs_that_need_a_gradient(card):
    """The kernels differentiate with respect to the features only: with
    grad mode on, rois that require grad raise instead of returning a
    result without their gradient; features that require grad get one;
    with grad mode off, rois that require grad launch as usual."""
    feats = torch.randn((1, 4, 4, 8), device=card, requires_grad=True)
    rois = torch.tensor([[[0.0, 0.0, 30.0, 30.0]]], device=card)
    with pytest.raises(RuntimeError, match="rois must not require grad"):
        ra.roi_align(feats.detach(), rois.clone().requires_grad_(), (2, 2), 1.0 / 8)
    with pytest.raises(RuntimeError, match="rois must not require grad"):
        ra.roi_align(feats, rois.clone().requires_grad_(), (2, 2), 1.0 / 8)
    assert ra.roi_align(feats, rois, (2, 2), 1.0 / 8).grad_fn is not None
    with torch.no_grad():
        out = ra.roi_align(feats, rois.clone().requires_grad_(), (2, 2), 1.0 / 8)
    assert out.grad_fn is None
    assert torch.equal(out, ra.roi_align(feats.detach(), rois, (2, 2), 1.0 / 8))


def _grad_check(card, feats_shape, dtype, rois, bin_stride, sampling_ratio=0, seed=0, tile=None):
    """(kernel dF, plain dF) for a seeded cotangent; one launch (with the
    default tile, or ``tile``)."""
    p = -(-14 // bin_stride)
    gen = torch.Generator(device=card).manual_seed(seed)
    grad = torch.randn((feats_shape[0], rois.shape[1], p, p, feats_shape[3]), generator=gen,
                       device=card).to(dtype)
    args = (rois, tuple(feats_shape), dtype, (14, 14), 1.0 / 16, sampling_ratio, 8, bin_stride)
    before = kernels.ROI_ALIGN_BACKWARD.launches
    if tile is None:
        out = ra.roi_align_backward(grad, *args)
    else:
        out = ra._backward_cuda(grad, *args, tile=tile)
    torch.cuda.synchronize()
    assert kernels.ROI_ALIGN_BACKWARD.launches == before + 1
    ref = ra.roi_align_backward_plain(grad, *args)
    assert out.dtype == ref.dtype == dtype and out.shape == ref.shape
    return out, ref


@pytest.mark.parametrize("dtype,c", [(torch.float32, 4), (torch.float32, 1024),
                                     (torch.bfloat16, 8), (torch.bfloat16, 1024)])
@pytest.mark.parametrize("bin_stride,sampling_ratio", [(1, 0), (2, 0), (2, 2)])
def test_roi_align_backward_kernel_equals_plain(card, dtype, c, bin_stride, sampling_ratio):
    rng = np.random.default_rng(c + bin_stride + 11)
    _, rois = _roi_inputs(rng, 8, torch.float32, card)
    out, ref = _grad_check(card, (2, 17, 23, c), dtype, rois, bin_stride, sampling_ratio)
    assert _within_tolerance(out, ref, float(ref.float().abs().max()))
    assert ref.float().abs().max() > 0


def test_roi_align_backward_kernel_at_the_edges(card):
    """Rois on and beyond the map's edges, of zero size, and one that
    covers the whole map (its grid capped at ceil(size / bins))."""
    rois = torch.tensor([[
        [0.0, 0.0, 0.0, 0.0],          # zero size at the corner
        [100.0, 60.0, 100.0, 60.0],    # zero size inside
        [-80.0, -80.0, 0.0, 0.0],      # ends on the top-left edge
        [352.0, 256.0, 500.0, 400.0],  # starts on the bottom-right edge
        [340.0, -50.0, 420.0, 300.0],  # straddles the right edge
        [0.0, 0.0, 367.0, 271.0],      # the whole map
        [-300.0, -300.0, 700.0, 600.0],  # beyond it on every side
        [600.0, 500.0, 700.0, 650.0],  # outside: no gradient
    ]], device=card)
    for dtype, c in ((torch.float32, 36), (torch.bfloat16, 40)):
        for bin_stride in (1, 2):
            out, ref = _grad_check(card, (1, 17, 23, c), dtype, rois, bin_stride, seed=bin_stride)
            assert _within_tolerance(out, ref, float(ref.float().abs().max()))
    only_outside = rois[:, -1:].contiguous()
    out, ref = _grad_check(card, (1, 17, 23, 8), torch.float32, only_outside, 2)
    assert not out.any() and not ref.any()


def test_roi_align_backward_of_a_zero_cotangent_is_exactly_zero(card):
    rng = np.random.default_rng(5)
    _, rois = _roi_inputs(rng, 8, torch.float32, card)
    for dtype in (torch.float32, torch.bfloat16):
        grad = torch.zeros((2, 50, 7, 7, 1024), device=card, dtype=dtype)
        out = ra.roi_align_backward(grad, rois, (2, 17, 23, 1024), dtype, (14, 14), 1.0 / 16, 0, 8, 2)
        assert out.dtype == dtype and not out.any()


def test_roi_align_autograd_route_launches_the_backward_once(card):
    """A CUDA ``roi_align`` on features that require grad has a
    ``grad_fn``; ``.backward()`` launches the backward kernel once and
    gives the plain version's gradient."""
    rng = np.random.default_rng(9)
    for dtype, c in ((torch.float32, 1024), (torch.bfloat16, 1024)):
        feats, rois = _roi_inputs(rng, c, dtype, card)
        feats.requires_grad_()
        fwd, bwd = kernels.ROI_ALIGN.launches, kernels.ROI_ALIGN_BACKWARD.launches
        out = ra.roi_align(feats, rois, (14, 14), 1.0 / 16, 0, 8, 2)
        assert out.grad_fn is not None and kernels.ROI_ALIGN.launches == fwd + 1
        grad = torch.randn(out.shape, device=card).to(dtype)
        out.backward(grad)
        torch.cuda.synchronize()
        assert kernels.ROI_ALIGN_BACKWARD.launches == bwd + 1
        assert kernels.ROI_ALIGN.launches == fwd + 1
        ref = ra.roi_align_backward_plain(grad, rois, tuple(feats.shape), dtype, (14, 14), 1.0 / 16, 0, 8, 2)
        assert feats.grad.dtype == dtype
        assert _within_tolerance(feats.grad, ref, float(ref.float().abs().max()))


def _backward_equals_plain(card, feats_shape, rois, tile=None):
    for dtype in (torch.float32, torch.bfloat16):
        for bin_stride in (1, 2):
            for sampling_ratio in (0, 2):
                out, ref = _grad_check(card, feats_shape, dtype, rois, bin_stride, sampling_ratio,
                                       seed=bin_stride + sampling_ratio, tile=tile)
                assert _within_tolerance(out, ref, float(ref.float().abs().max())), (
                    dtype, bin_stride, sampling_ratio, float((out.float() - ref.float()).abs().max()))


@pytest.mark.parametrize("c", [8, 40, 1024])
def test_roi_align_backward_kernel_64_copies_of_one_roi(card, c):
    """The worst overlap: every roi of the image adds into the same
    positions; C below, off and at a multiple of the channel slab."""
    rois = torch.tensor([[[60.0, 40.0, 250.0, 200.0]] * 64], device=card)
    _backward_equals_plain(card, (1, 17, 23, c), rois)


@pytest.mark.parametrize("c", [40, 520])
@pytest.mark.parametrize("tile", [None, (1, 5, 128, 1), (3, 7, 128, 2), (8, 23, 128, 4), (4, 21, 512, 1)])
def test_roi_align_backward_kernel_across_tile_boundaries(card, tile, c):
    """Rois whose taps straddle the boundaries between tiles of rows and
    of columns, rois on the last row and column, a roi over the whole map
    and rois wholly outside it, for several tiles (one row at a time, a
    tile wider than the map, a slab wider than C, one or more slabs a
    CTA)."""
    rng = np.random.default_rng(21)
    edges = [[0.0, 0.0, 367.0, 271.0],      # the whole map
             [330.0, 240.0, 367.0, 271.0],  # the last row and column
             [360.0, 0.0, 400.0, 300.0],    # the last column, beyond the edge
             [0.0, 264.0, 367.0, 290.0],    # the last row
             [-300.0, -300.0, 700.0, 600.0],  # beyond the map on every side
             [500.0, 400.0, 600.0, 500.0],  # outside: no gradient
             [-90.0, -90.0, -20.0, -30.0]]  # outside: no gradient
    # rois that start and end near multiples of 16 pixels (row and
    # column boundaries of the tiles at scale 1/16)
    starts = rng.integers(0, 20, (2, 40, 2)) * 16.0 + rng.uniform(-3, 3, (2, 40, 2))
    sizes = rng.uniform(8, 200, (2, 40, 2))
    grid = np.concatenate([starts, starts + sizes], -1)
    rois = np.concatenate([np.broadcast_to(np.float32(edges), (2, 7, 4)), grid], 1)
    rois = torch.from_numpy(rois.astype(np.float32)).to(card)
    _backward_equals_plain(card, (2, 17, 23, c), rois, tile)


@pytest.mark.parametrize("b,s", [(1, 1), (3, 1), (2, 2049), (1, 4100)])
def test_roi_align_backward_kernel_few_and_many_rois(card, b, s):
    """One roi per image, and B x S below and above the forward's
    kSplitBelow (4096): more work items than one round of the kernel's
    lists holds, over several slabs of channels."""
    rng = np.random.default_rng(b * s)
    x1 = rng.uniform(-40, 360, (b, s))
    y1 = rng.uniform(-40, 260, (b, s))
    rois = np.stack([x1, y1, x1 + rng.uniform(1, 300, (b, s)), y1 + rng.uniform(1, 200, (b, s))], -1)
    rois = torch.from_numpy(rois.astype(np.float32)).to(card)
    for dtype, c in ((torch.float32, 264), (torch.bfloat16, 520)):
        out, ref = _grad_check(card, (b, 17, 23, c), dtype, rois, 2)
        assert _within_tolerance(out, ref, float(ref.float().abs().max()))
        assert ref.float().abs().max() > 0


def test_roi_align_backward_kernel_is_bit_identical_from_run_to_run(card):
    """Each position's sum is taken by one thread in one fixed order."""
    rng = np.random.default_rng(13)
    _, rois = _roi_inputs(rng, 8, torch.float32, card)
    for dtype in (torch.float32, torch.bfloat16):
        grad = torch.randn((2, 50, 7, 7, 1024), device=card).to(dtype)
        args = (grad, rois, (2, 17, 23, 1024), dtype, (14, 14), 1.0 / 16, 0, 8, 2)
        assert torch.equal(ra.roi_align_backward(*args), ra.roi_align_backward(*args))


def test_roi_align_backward_kernel_refuses_a_tile_too_large(card):
    """A tile whose float32 sums alone pass 227 KB, even at the narrowest
    slab of channels, raises before any launch."""
    rois = torch.zeros((1, 2, 4), device=card)
    grad = torch.zeros((1, 2, 7, 7, 64), device=card)
    before = kernels.ROI_ALIGN_BACKWARD.launches
    with pytest.raises(ValueError, match="does not fit"):
        ra._backward_cuda(grad, rois, (1, 50, 300, 64), torch.float32, (14, 14), 1.0 / 16, 0, 8, 2,
                          tile=(4, 300, 64, 1))
    assert kernels.ROI_ALIGN_BACKWARD.launches == before


# ---------------------------------------------------------------------------
# the level filter of the FPN pooler, at C 256


def _pyramid(card, dtype, b=2, s=300, seed=21):
    """P2..P5 of a 320 x 480 image at C 256, rois over every level (their
    LevelMapper levels, as the pooler assigns them)."""
    from cvpr22_cross_modal_pseudo_labeling_torch.models.roi_heads.pooler import assign_fpn_levels

    rng = np.random.default_rng(seed)
    feats = [torch.from_numpy(rng.standard_normal((b, 320 // st, 480 // st, 256), np.float32)).to(card, dtype)
             for st in (4, 8, 16, 32)]
    xy = rng.uniform(-20, 460, (b, s, 2))
    wh = np.exp(rng.uniform(np.log(8), np.log(600), (b, s, 2)))
    rois = torch.from_numpy(np.concatenate([xy, xy + wh], -1).astype(np.float32)).to(card)
    levels = assign_fpn_levels(rois, 2, 5)
    assert set(levels.flatten().tolist()) == {0, 1, 2, 3}
    return feats, rois, levels


SCALES = (0.25, 0.125, 0.0625, 0.03125)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_level_filtered_forward_writes_every_row_once_and_equals_plain(card, dtype):
    """One launch a level into one output pre-filled with NaN: every row
    is written, each by its level's launch, within the tolerance of the
    plain version of that level."""
    feats, rois, levels = _pyramid(card, dtype)
    out = torch.full((2, 300, 14, 14, 256), float("nan"), device=card, dtype=dtype)
    before = kernels.ROI_ALIGN.launches
    ra._forward_levels_cuda(feats, rois, levels, (14, 14), SCALES, 2, 8, out=out)
    torch.cuda.synchronize()
    assert kernels.ROI_ALIGN.launches == before + 4
    assert not torch.isnan(out).any()
    for lvl in range(4):
        mine = levels == lvl
        ref = ra.roi_align_plain(feats[lvl], rois, (14, 14), SCALES[lvl], 2, 8, 1, levels, lvl)
        assert _within_tolerance(out[mine], ref[mine], float(feats[lvl].float().abs().max()))
    assert torch.equal(ra.roi_align_levels(feats, rois, levels, (14, 14), SCALES, 2), out)


def test_level_filtered_forward_leaves_other_rows_untouched(card):
    feats, rois, levels = _pyramid(card, torch.bfloat16, seed=22)
    out = torch.full((2, 300, 14, 14, 256), 7.0, device=card, dtype=torch.bfloat16)
    ra._forward_cuda(feats[1], rois, (14, 14), SCALES[1], 2, 8, 1, levels, 1, out)
    assert bool((out[levels != 1] == 7.0).all()) and not bool((out[levels == 1] == 7.0).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_level_filtered_backward_equals_plain_per_level(card, dtype):
    """Each level's dF from its rois only, against the plain version's
    autograd gradient of that level; the autograd route launches the
    forward and the backward once a level."""
    feats, rois, levels = _pyramid(card, dtype, seed=23)
    gen = torch.Generator(device=card).manual_seed(24)
    grad = torch.randn((2, 300, 14, 14, 256), generator=gen, device=card).to(dtype)
    for lvl in range(4):
        args = (grad, rois, tuple(feats[lvl].shape), dtype, (14, 14), SCALES[lvl], 2, 8, 1, levels, lvl)
        out = ra.roi_align_backward(*args)
        ref = ra.roi_align_backward_plain(*args)
        assert ref.float().abs().max() > 0
        assert _within_tolerance(out, ref, float(ref.float().abs().max())), lvl
    leaves = [f.clone().requires_grad_() for f in feats]
    fwd, bwd = kernels.ROI_ALIGN.launches, kernels.ROI_ALIGN_BACKWARD.launches
    pooled = ra.roi_align_levels(leaves, rois, levels, (14, 14), SCALES, 2)
    pooled.backward(grad)
    assert kernels.ROI_ALIGN.launches == fwd + 4 and kernels.ROI_ALIGN_BACKWARD.launches == bwd + 4
    for lvl, leaf in enumerate(leaves):
        ref = ra.roi_align_backward_plain(grad, rois, tuple(feats[lvl].shape), dtype, (14, 14), SCALES[lvl], 2,
                                          8, 1, levels, lvl)
        assert _within_tolerance(leaf.grad, ref, float(ref.float().abs().max())), lvl


def test_a_null_level_filter_is_the_unfiltered_launch(card):
    """Without levels both kernels give what they gave before the filter,
    bit for bit: the filter with every roi on level 0 changes nothing."""
    feats, rois, _ = _pyramid(card, torch.bfloat16, seed=25)
    zeros = torch.zeros(rois.shape[:2], dtype=torch.int32, device=card)
    plain = ra.roi_align(feats[2], rois, (14, 14), SCALES[2], 2)
    assert torch.equal(plain, ra._forward_cuda(feats[2], rois, (14, 14), SCALES[2], 2, 8, 1, zeros, 0))
    grad = torch.randn(plain.shape, device=card).to(torch.bfloat16)
    args = (grad, rois, tuple(feats[2].shape), torch.bfloat16, (14, 14), SCALES[2], 2, 8, 1)
    assert torch.equal(ra.roi_align_backward(*args), ra.roi_align_backward(*args, zeros, 0))
    # a level no roi is on: zero dF, every element written
    assert not ra.roi_align_backward(*args, zeros, 3).any()
