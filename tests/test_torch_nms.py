"""The port's NMS (its plain version, which CPU tensors run) against the
JAX package's ``ops.nms.nms`` / ``batched_nms`` and the Pallas kernel
``nms_pallas`` in interpret mode.  Exact: indices and valid masks must
be equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr22_cross_modal_pseudo_labeling_tpu.ops.nms import batched_nms as jax_batched_nms
from cvpr22_cross_modal_pseudo_labeling_tpu.ops.nms import nms as jax_nms
from cvpr22_cross_modal_pseudo_labeling_tpu.ops.nms_pallas import nms_pallas
from cvpr22_cross_modal_pseudo_labeling_torch.ops import kernels
from cvpr22_cross_modal_pseudo_labeling_torch.ops import nms as torch_nms
from tests.test_nms import random_boxes


def _case(name, seed):
    """boxes, scores, valid, labels (or None), threshold, max_outputs."""
    rng = np.random.RandomState(seed)
    n = 300
    boxes = random_boxes(rng, n)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    valid = np.ones(n, bool)
    labels = None
    thr, k = 0.5, 100
    if name == "labeled":
        labels = rng.randint(1, 5, n).astype(np.int32)
    elif name == "ties":
        scores = (rng.randint(0, 6, n) / 8.0).astype(np.float32)
        boxes[::3] = boxes[0]  # identical boxes with tied scores
    elif name == "invalid":
        valid = rng.uniform(0, 1, n) > 0.3
        scores[~valid] = 2.0  # invalid slots must lose even with top scores
    elif name == "ragged":
        n = 77  # not a multiple of any tile
        boxes, scores, valid = boxes[:n], scores[:n], valid[:n]
        thr, k = 0.3, 50
    elif name == "over_capacity":
        n = 40
        boxes, scores, valid = boxes[:n], scores[:n], valid[:n]
        valid[::4] = False
        k = 64  # more slots than boxes: padded slots hold index 0
    elif name == "labeled_ties_invalid":
        labels = rng.randint(0, 3, n).astype(np.int32)
        scores = (rng.randint(0, 4, n) / 4.0).astype(np.float32)
        valid = rng.uniform(0, 1, n) > 0.2
        thr = 0.4
    return boxes, scores, valid, labels, thr, k


CASES = ["plain", "labeled", "ties", "invalid", "ragged", "over_capacity",
         "labeled_ties_invalid"]


@pytest.mark.parametrize("name", CASES)
def test_nms_matches_jax_and_pallas(name):
    boxes, scores, valid, labels, thr, k = _case(name, seed=CASES.index(name))
    jl = None if labels is None else jnp.asarray(labels)
    ref_idx, ref_valid = jax_nms(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), thr, k,
        tile=64, labels=jl,
    )
    pal_idx, pal_valid = nms_pallas(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), thr, k,
        tile=64, interpret=True, labels=jl,
    )
    tl = None if labels is None else torch.from_numpy(labels)
    idx, keep = torch_nms.nms(
        torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(valid),
        thr, k, labels=tl,
    )
    assert idx.dtype == torch.int32 and idx.shape == (k,) and keep.shape == (k,)
    for r_idx, r_valid in ((ref_idx, ref_valid), (pal_idx, pal_valid)):
        np.testing.assert_array_equal(idx.numpy(), np.asarray(r_idx))
        np.testing.assert_array_equal(keep.numpy(), np.asarray(r_valid))
    assert 0 < keep.sum() < valid.sum() or name == "over_capacity"


def test_batched_nms_matches_jax_per_image():
    """A leading batch axis runs independent problems; ``batched_nms``
    keeps the JAX argument order (boxes, scores, labels, valid)."""
    rng = np.random.RandomState(7)
    b, n = 3, 200
    boxes = np.stack([random_boxes(rng, n) for _ in range(b)])
    scores = rng.uniform(0, 1, (b, n)).astype(np.float32)
    labels = rng.randint(1, 6, (b, n)).astype(np.int32)
    valid = rng.uniform(0, 1, (b, n)) > 0.1
    idx, keep = torch_nms.batched_nms(
        torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(labels),
        torch.from_numpy(valid), 0.5, 60,
    )
    for i in range(b):
        r_idx, r_valid = jax_batched_nms(
            jnp.asarray(boxes[i]), jnp.asarray(scores[i]), jnp.asarray(labels[i]),
            jnp.asarray(valid[i]), 0.5, 60, tile=64,
        )
        np.testing.assert_array_equal(idx[i].numpy(), np.asarray(r_idx))
        np.testing.assert_array_equal(keep[i].numpy(), np.asarray(r_valid))


def test_nms_cpu_tensors_take_the_plain_version_and_other_devices_raise():
    boxes, scores, valid, labels, thr, k = _case("plain", 0)
    before = kernels.NMS.launches
    torch_nms.nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                  torch.from_numpy(valid), thr, k)
    assert kernels.NMS.launches == before
    meta = torch.empty((10, 4), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        torch_nms.nms(meta, meta[:, 0], meta[:, 0] > 0, 0.5, 5)
