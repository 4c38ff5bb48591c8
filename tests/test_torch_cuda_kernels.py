"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``; every test skips without a CUDA device.  This
file imports torch and the port only, so it runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py

NMS must agree exactly; RoIAlign within 1e-5 * max|F| for a float32
result (only the summation order differs), plus one bfloat16 ulp of the
result for a bfloat16 one (the two float32 sums may round to neighbouring
bfloat16 values).
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
    """The kernel has no backward: with grad mode on, features or rois
    that require grad raise instead of returning a result without a
    gradient; detached inputs, or grad mode off, launch as usual."""
    feats = torch.randn((1, 4, 4, 8), device=card, requires_grad=True)
    rois = torch.tensor([[[0.0, 0.0, 30.0, 30.0]]], device=card)
    with pytest.raises(RuntimeError, match="no backward"):
        ra.roi_align(feats, rois, (2, 2), 1.0 / 8)
    with pytest.raises(RuntimeError, match="no backward"):
        ra.roi_align(feats.detach(), rois.clone().requires_grad_(), (2, 2), 1.0 / 8)
    with torch.no_grad():
        out = ra.roi_align(feats, rois, (2, 2), 1.0 / 8)
    assert torch.equal(out, ra.roi_align(feats.detach(), rois, (2, 2), 1.0 / 8))
