"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``; every test skips without a CUDA device.  This
file imports torch and the port only, so it runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py

NMS must agree exactly; RoIAlign within 1e-5 * max|F| (float32, only the
summation order differs).
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
    with pytest.raises(ValueError, match="float32"):
        ra.roi_align(torch.zeros((1, 4, 4, 8), device=card, dtype=torch.bfloat16), rois, (2, 2), 1.0)
